"""chip_smoke.py's phase 17 (the Llama decoder chassis) rehearsed on the CPU:
(a) and (e) as the card runs them, with the CPU standing in for the card,
and (b)-(d) on a 2-layer, narrow Gemma with Gemma-2B's knobs (GeGLU,
w + 1 norms, scaled embeddings, tied head, GQA onto one KV head).

The script is loaded by its path; the CUDA calls of the phase are no-ops
here. No flash kernel launches on the CPU (the wrappers run their plain
versions), so the launch-count check is the one that fails.
"""

import importlib.util
import math
from pathlib import Path

import pytest

_PATH = Path(__file__).resolve().parent.parent / "chip_smoke.py"


@pytest.fixture(scope="module")
def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", _PATH)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _stub_cuda(chip_smoke, monkeypatch):
    import torch

    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a, **k: 0)


def test_gemma_2b_config_has_the_published_shape(chip_smoke):
    """google/gemma-2b through gemma_config_from_hf: 2,506,172,416
    parameters (embedding 524.3M, 110.1M a layer), 5.01 GB of bf16 weights
    read per decode token, 1.50 ms at 3.35 TB/s."""
    import torch

    from accelerate_tpu_torch.models import LlamaForCausalLM
    from accelerate_tpu_torch.models.hub import gemma_config_from_hf

    cfg = gemma_config_from_hf(chip_smoke.GEMMA_2B)
    assert (cfg.head_dim, cfg.hidden_act, cfg.rms_norm_plus_one, cfg.scale_embeddings,
            cfg.tie_word_embeddings) == (256, "gelu_tanh", True, True, True)
    module = LlamaForCausalLM(cfg, device="meta")
    assert sum(p.numel() for p in module.parameters()) == 2_506_172_416
    assert module.model.embed_tokens.weight.numel() == 524_288_000
    ms, nbytes = chip_smoke.decode_bound(chip_smoke.GEMMA_2B, 2)
    assert nbytes / 1e9 == pytest.approx(5.01, abs=0.005) and ms == pytest.approx(1.50, abs=0.01)
    assert torch.get_default_dtype() == torch.float32


def test_chassis_phase_rehearsed_on_the_cpu(chip_smoke, monkeypatch):
    """The whole phase at a small width on one intra-op thread: every check
    passes but the flash launch counts."""
    import torch

    from accelerate_tpu_torch.ops import hopper_flash as hf

    _stub_cuda(chip_smoke, monkeypatch)
    width = dict(chip_smoke.GEMMA_2B, vocab_size=512, hidden_size=64, intermediate_size=128,
                 num_hidden_layers=2, num_attention_heads=2, num_key_value_heads=1,
                 head_dim=32, max_position_embeddings=256)
    row = dict(chip_smoke.GEMMA_ROW, seq=64, warmup=1, timed=2, chunk_size=16, requests=4)
    serving_row = dict(chip_smoke.SERVING_ROW, qps=64.0, new_tokens=16)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        res = chip_smoke.chassis_phase(hf, device="cpu", width=width, row=row,
                                       serving_row=serving_row)
    finally:
        torch.set_num_threads(threads)
    assert sorted(k for k, v in res["checks"].items() if not v) == ["train_flash_launches"]
    assert set(res["tiny"]) == set(chip_smoke.CHASSIS_KNOBS)
    train = res["gemma_2b_train"]
    assert train["launches"] == dict.fromkeys(chip_smoke.KERNELS, 0)
    assert train["steps"] == 3 and len(train["losses"]) == 3
    assert abs(train["losses"][0] - math.log(512)) < 1.0
    assert max(train["fused_naive_rel"].values()) <= chip_smoke.FUSED_LOSS_REL
    assert res["gemma_2b_serving"]["stats"]["requests_completed"] == 4
    assert res["hub_round_trip"]["bit_equal"]


def test_kernel_summary_reports_the_error_at_the_gemma_2b_shape(chip_smoke):
    """The kernels line's max_abs_err for the bf16 head-dim-256 variant is
    the phase-2 case at the Gemma-2B step's shape, not the first case that
    ran the variant."""
    import torch

    from accelerate_tpu_torch.ops import hopper_flash as hf

    shape = chip_smoke.GEMMA_LIKE
    variants = {k: hf.variant(k, torch.bfloat16, 256) for k in chip_smoke.KERNELS}
    timed = [{"name": None, "paths": ("gemma_2b_step",), "dtype": "bfloat16", "shape": shape,
              "padded_to": None, "variants": variants,
              "ms": dict.fromkeys(chip_smoke.KERNELS, 2.0),
              "plain_ms": dict.fromkeys(chip_smoke.KERNELS, 9.0),
              "bound": chip_smoke.bounds(*shape.values(), "bfloat16"), "library_ms": {}}]
    case = dict(variants=variants, padded_to=None, dtype="bfloat16", causal=True)
    cases = [dict(case, shape=[2, 300, 8, 1, 256], max_abs=dict.fromkeys(variants, 1e-3)),
             dict(case, shape=list(shape.values()), max_abs=dict.fromkeys(variants, 2e-2))]
    main_path = {"variant_launches": {}}
    lines = chip_smoke.kernel_summary(timed, cases, main_path)
    assert [line["max_abs_err"] for line in lines] == [2e-2] * 3
    assert [line["max_abs_err"] for line in chip_smoke.kernel_summary(
        timed, cases[:1], main_path)] == [1e-3] * 3
