"""chip_smoke.py's phase 19 (GPT-2, GPT-NeoX, OPT, T5 and Whisper) rehearsed
on the CPU: (a) and (e) as the card runs them, with the CPU standing in for
the card, and (b)-(d) on 2-layer models of each family's preset with
narrow widths, short sequences and a shrunk trace.

The script is loaded by its path; the CUDA calls of the phase are no-ops
here. Only the CUDA timings mean nothing on the CPU; every check passes.
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


def _stub_cuda(monkeypatch):
    import torch

    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a, **k: 0)


def test_full_width_rows_have_the_published_shapes(chip_smoke):
    """The presets' parameter counts: GPT-2 XL 1.558B, Pythia-1B 1.012B
    (head dim 256), OPT-1.3B 1.316B, T5-base 0.223B, Whisper-large 1.543B;
    each decoder's bf16 decode bytes are dominated by its weights."""
    import torch

    counts = {}
    for name, row in chip_smoke.FAMILY_ROWS.items():
        cfg_cls, mod_cls = chip_smoke.family_classes(row["family"])
        cfg = getattr(cfg_cls, row["preset"])(dtype=torch.bfloat16)
        module = mod_cls(cfg, device="meta")
        counts[name] = sum(p.numel() for p in module.parameters())
        if name == "pythia_1b":
            assert cfg.head_dim == 256
    assert counts == {"gpt2_xl": 1_557_611_200, "pythia_1b": 1_011_781_632,
                      "opt_1b3": 1_315_758_080, "t5_base": 222_903_552,
                      "whisper_large": 1_543_304_960}
    cfg_cls, mod_cls = chip_smoke.family_classes("opt")
    cfg = cfg_cls.opt_1b3(dtype=torch.bfloat16)
    ms, nbytes = chip_smoke.family_decode_bound(cfg, mod_cls(cfg, device="meta"), ctx=80)
    assert nbytes == pytest.approx(2 * (1_315_758_080 - 2050 * 2048) + 4 * 24 * 2048 * 81)
    assert ms == pytest.approx(nbytes / chip_smoke.PEAK_HBM_BYTES * 1e3)


def test_hf_layout_is_transformers_own(chip_smoke, monkeypatch):
    """The tiny checkpoints (e) writes carry exactly the names and shapes
    of transformers' own models of those configs (their tied heads and
    buffers aside)."""
    monkeypatch.setenv("USE_TF", "0")
    transformers = pytest.importorskip("transformers")
    from accelerate_tpu_torch.models.hub import _FAMILIES

    classes = {"gpt2": "GPT2LMHeadModel", "opt": "OPTForCausalLM",
               "neox": "GPTNeoXForCausalLM", "t5": "T5ForConditionalGeneration",
               "whisper": "WhisperForConditionalGeneration"}
    for family, cls_name in classes.items():
        hf_cfg = dict(chip_smoke.HF_TINY_CONFIGS[family])
        model_type = hf_cfg.pop("model_type")
        config = transformers.AutoConfig.for_model(model_type, **hf_cfg)
        want = {k: tuple(v.shape) for k, v in getattr(transformers, cls_name)(config)
                .state_dict().items()}
        mod_cls, config_from_hf, _, _ = _FAMILIES[model_type]
        module = mod_cls(config_from_hf(chip_smoke.HF_TINY_CONFIGS[family]))
        got = {k: tuple(v.shape) for k, v in chip_smoke.hf_layout_state_dict(
            family, module).items()}
        tied = {"lm_head.weight", "proj_out.weight", "encoder.embed_tokens.weight",
                "decoder.embed_tokens.weight"}
        assert set(got) <= set(want), (family, sorted(set(got) - set(want)))
        assert sorted(set(want) - set(got) - tied) == [], family
        assert all(got[k] == want[k] for k in got), family


def test_families_phase_rehearsed_on_the_cpu(chip_smoke, monkeypatch):
    """The whole phase on one intra-op thread: every check passes."""
    import torch

    from accelerate_tpu_torch.ops import hopper_flash as hf

    _stub_cuda(monkeypatch)
    narrow = {"gpt2": dict(n_layer=2, n_embd=64, n_head=4, vocab_size=512),
              "neox": dict(num_hidden_layers=2, hidden_size=64, num_attention_heads=2,
                           intermediate_size=128, vocab_size=512),
              "opt": dict(num_hidden_layers=2, hidden_size=64, ffn_dim=128,
                          num_attention_heads=4, vocab_size=512),
              "t5": dict(num_layers=2, d_model=64, d_ff=128, num_heads=4, d_kv=16,
                         vocab_size=512),
              "whisper": dict(encoder_layers=2, decoder_layers=2, d_model=64,
                              encoder_attention_heads=4, decoder_attention_heads=4,
                              encoder_ffn_dim=128, decoder_ffn_dim=128, vocab_size=512)}
    shape = {"gpt2": dict(batch=2, seq=32), "neox": dict(batch=2, seq=32),
             "opt": dict(batch=2, seq=32), "t5": dict(batch=2, seq=24, dec_seq=8),
             "whisper": dict(batch=2, frames=40, dec_seq=8)}
    rows = {name: {**row, **shape[row["family"]], "width": narrow[row["family"]]}
            for name, row in chip_smoke.FAMILY_ROWS.items()}
    decode = dict(chip_smoke.ENCDEC_DECODE, t5_input=24, whisper_frames=40, new_tokens=8,
                  whisper_prompt=(1,), whisper_forced=((1, 7), (2, 11), (3, 13)))
    serving_row = dict(chip_smoke.SERVING_ROW, qps=64.0, new_tokens=16)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.setattr(chip_smoke, "GEN_NEW_TOKENS", 8)
    try:
        res = chip_smoke.families_phase(
            hf, device="cpu", rows=rows,
            steps=dict(warmup=1, timed=2, profiled=1, profiled_decode=2),
            serving_row=serving_row, decode=decode)
    finally:
        torch.set_num_threads(threads)
    assert sorted(k for k, v in res["checks"].items() if not v) == []
    assert len(res["checks"]) == 5 + 5 * 4 + 5 + 2 + 2 + 5
    for name, train in res["train"].items():
        assert train["steps"] == 3 and len(train["losses"]) == 3 and train["halved_from"] == []
        assert abs(train["losses"][0] - math.log(512)) < 1.0
        assert train["flops_per_step"] > 0 and train["flops_formula"].startswith("B")
    assert res["opt_1b3_serving"]["stats"]["requests_completed"] == 16
    assert res["opt_1b3_serving"]["parity"]["equal_rows"] == 16
    assert "_rows" not in res["opt_1b3_serving"]
    whisper = res["decode"]["whisper_large"]
    assert whisper["forced_tokens"] and whisper["cross_positions"] == 20
    assert all(t["beam_equal"] for f, t in res["tiny"].items() if f in ("t5", "whisper"))
