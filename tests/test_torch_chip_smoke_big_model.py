"""chip_smoke.py's phase 21 (big-model inference) rehearsed on the CPU:
(a) a 4-layer model of Llama-2-7B's shape at narrow widths, streamed over
the "device" (the host standing in for the card), the pinned-host tier and
the disk, against the same checkpoint resident; (b) int8 and NF4 on it;
(c) the seven families' tiny models; (d) a Megatron TP 2 x PP 2
checkpoint of the narrow model.

The script is loaded by its path; the CUDA calls of the phase are no-ops
here. No kernel runs on the CPU, so the two launch-count checks fail and
every other check passes; a failing check fails the phase.
"""

import importlib.util
from pathlib import Path

import pytest
import torch

_PATH = Path(__file__).resolve().parent.parent / "chip_smoke.py"


@pytest.fixture(scope="module")
def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", _PATH)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _stub_cuda(monkeypatch):
    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    for name in ("max_memory_allocated", "memory_allocated"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: 0)


def _narrow(chip_smoke):
    """Llama-2-7B's shape at 4 layers of width 128 (32-wide heads) and a
    vocabulary of 256; budgets that put the embedding, the head and about
    one and a half layers on the "device", one and a half on the host and
    the rest on disk."""
    width = dict(chip_smoke.LLAMA2_7B, vocab_size=256, hidden_size=128, intermediate_size=384,
                 num_hidden_layers=4, num_attention_heads=4, num_key_value_heads=4,
                 max_position_embeddings=512)
    layer = chip_smoke.layer_bytes(chip_smoke.big_model_config(width))
    spec = dict(chip_smoke.BIG_MODEL, prompt=(1, 64), gpu_budget=2 * 256 * 128 * 2 + 3 * layer // 2,
                cpu_budget=3 * layer // 2, shard_bytes=300_000)
    return width, spec


def test_published_widths(chip_smoke):
    """Llama-2-7B: 6,738,415,616 parameters; a block's bf16 bytes."""
    from accelerate_tpu_torch.models import LlamaForCausalLM

    cfg = chip_smoke.big_model_config(chip_smoke.LLAMA2_7B)
    module = LlamaForCausalLM(cfg, device="meta")
    n = sum(p.numel() for p in module.parameters())
    assert n == chip_smoke.llama_n_params(chip_smoke.LLAMA2_7B) == 6_738_415_616
    assert chip_smoke.layer_bytes(cfg) == 2 * sum(
        p.numel() for p in module.model.layers[0].parameters())


def test_big_model_phase_rehearsed_on_the_cpu(chip_smoke, monkeypatch):
    """Every check but the two launch counts passes; the printed keys are
    there; the logits are bit-equal; three tiers hold bytes; (b)'s
    quantized forwards equal their dequantized weights' and the JAX
    package's tiny gates pass; (c)'s families and (d)'s import pass."""
    from accelerate_tpu_torch.ops import hopper_flash as hf

    _stub_cuda(monkeypatch)
    width, spec = _narrow(chip_smoke)
    res = chip_smoke.big_model_phase(hf, device="cpu", width=width, spec=spec)
    failed = sorted(k for k, v in res["checks"].items() if not v)
    assert failed == ["resident_launches", "stream_launches"], failed
    assert not res["ok"]
    stream = res["stream"]
    for key in ("tier_bytes", "forward_s", "h2d_bytes", "h2d_gb_s", "max_memory_allocated",
                "last_stream_peak_bytes", "launches", "variant_launches"):
        assert key in stream, key
    assert set(stream["tier_bytes"]) == {"cpu:0", "cpu", "disk"}
    assert sum(stream["tier_bytes"].values()) == res["params_bf16_bytes"]
    assert res["logits_bit_equal"] and res["room"]["mem_available_bytes"] > 0
    assert set(res["quantized"]) == set(res["tiny_quantized"]) == {"int8", "nf4"}
    assert all(q["checks"]["mechanism_bit_equal"] for q in res["quantized"].values())
    assert set(res["quantized"]["int8"]["by_depth"]) == {2}
    assert set(res["tiny"]) == set(chip_smoke.STREAM_FAMILIES)
    assert res["megatron"]["bit_equal"] and res["megatron"]["tp"] == 2


def test_a_failing_check_fails_the_phase(chip_smoke, monkeypatch):
    """Gates that no quantized model can meet fail (b), and the phase."""
    from accelerate_tpu_torch.ops import hopper_flash as hf

    _stub_cuda(monkeypatch)
    width, spec = _narrow(chip_smoke)
    monkeypatch.setitem(chip_smoke.QUANT_GATES, 8, dict(cosine=1.5, agreement=1.5,
                                                        bytes_share=0.0))
    res = chip_smoke.big_model_phase(hf, device="cpu", width=width, spec=spec,
                                     families=("llama",))
    failed = {k for k, v in res["checks"].items() if not v}
    assert {"tiny_int8_cosine", "tiny_int8_agreement", "tiny_int8_bytes", "int8_bytes"} <= failed
    assert not res["ok"]
