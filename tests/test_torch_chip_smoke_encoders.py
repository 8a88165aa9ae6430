"""chip_smoke.py's phase 20 (BERT, ViT, CLIP and ResNet) rehearsed on the
CPU: (a), (c) and (d) as the card runs them, with the CPU standing in for
the card (gloo for NCCL in (d)), and (b) on 2-layer models of each
family's preset with narrow widths, small images and short sequences.

The script is loaded by its path; the CUDA calls of the phase are no-ops
here. Only the CUDA timings and the profile's device times mean nothing on
the CPU (no kernel runs there); every check passes.
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
    """The presets' parameter counts: BERT-large's masked LM 335.2M,
    ViT-B/16 86.6M, CLIP ViT-B/32 151.3M, ResNet-50 25.6M; each row's FLOP
    count from its shapes."""
    import torch

    counts, flops = {}, {}
    for name, row in chip_smoke.ENCODER_ROWS.items():
        cfg = chip_smoke.family_config(row, torch.bfloat16)
        module = chip_smoke.family_classes(row["family"])[1](cfg, device="meta")
        counts[name] = sum(p.numel() for p in module.parameters())
        if row["family"] != "resnet":
            shape = {k: row[k] for k in ("seq",) if k in row}
            flops[name] = chip_smoke.encoder_flops(row["family"], cfg, module, row["batch"],
                                                   "meta", **shape)[0]
    assert counts == {"bert_large": 335_174_458, "vit_b16": 86_567_656,
                      "clip_b32": 151_277_313, "resnet50": 25_557_032}
    # BERT-large: 6 * N * T + 12 * L * H * S * T, T = 16 * 512; N leaves out
    # the position and token-type tables and the embeddings' norm.
    n = 335_174_458 - (512 + 2) * 1024 - 2 * 1024
    assert flops["bert_large"] == 16 * 512 * (6 * n + 12 * 24 * 1024 * 512)
    assert 6.5e12 < flops["vit_b16"] < 7.0e12 and 5.0e12 < flops["clip_b32"] < 6.5e12


def test_resnet50_macs_are_the_published_count(chip_smoke):
    """ResNet-50's 4.1 G multiply-accumulates an image at 224^2, counted by
    the hooks (bench.py's analog for a CNN)."""
    import torch

    from accelerate_tpu_torch.models import ResNet, ResNetConfig

    module = ResNet(ResNetConfig.resnet50(dtype=torch.float32))
    macs = chip_smoke.conv_macs(module, 224, "cpu")
    assert 4.0e9 < macs < 4.2e9


def test_hf_layout_is_transformers_own(chip_smoke, monkeypatch):
    """The tiny BERT, ViT and CLIP checkpoints (c) writes carry exactly the
    names and shapes of transformers' own models of those configs."""
    monkeypatch.setenv("USE_TF", "0")
    transformers = pytest.importorskip("transformers")
    from accelerate_tpu_torch.models.hub import _FAMILIES

    classes = {"bert": ("BertConfig", "BertForSequenceClassification"),
               "vit": ("ViTConfig", "ViTForImageClassification"),
               "clip": ("CLIPConfig", "CLIPModel")}
    for family, (cfg_name, cls_name) in classes.items():
        hf_cfg = dict(chip_smoke.HF_TINY_CONFIGS[family])
        hf_cfg.pop("model_type")
        want = {k: tuple(v.shape) for k, v in getattr(transformers, cls_name)(
            getattr(transformers, cfg_name)(**hf_cfg)).state_dict().items()}
        mod_cls, config_from_hf, _, _ = _FAMILIES[family]
        module = mod_cls(config_from_hf(chip_smoke.HF_TINY_CONFIGS[family]))
        got = {k: tuple(v.shape) for k, v in chip_smoke.hf_layout_state_dict(
            family, module).items()}
        buffers = {"text_model.embeddings.position_ids", "vision_model.embeddings.position_ids"}
        assert set(got) == set(want) - buffers, (family, sorted(set(got) ^ set(want)))
        assert all(got[k] == want[k] for k in got), family


def test_encoders_phase_rehearsed_on_the_cpu(chip_smoke, monkeypatch):
    """The whole phase on one intra-op thread: every check passes; the
    losses fall, ResNet's statistics move and its eval reads them; FSDP2
    puts one unit on every block of the eleven families."""
    import torch

    from accelerate_tpu_torch.ops import hopper_flash as hf

    _stub_cuda(monkeypatch)
    narrow = {"bert": dict(num_hidden_layers=2, hidden_size=64, num_attention_heads=4,
                           intermediate_size=128, vocab_size=512),
              "vit": dict(num_hidden_layers=2, hidden_size=64, num_attention_heads=4,
                          intermediate_size=128, image_size=32, patch_size=8, num_labels=10),
              "clip": dict(text_num_layers=2, text_hidden_size=32, text_num_heads=2,
                           text_intermediate_size=64, vision_num_layers=2,
                           vision_hidden_size=48, vision_num_heads=2,
                           vision_intermediate_size=96, image_size=32, patch_size=8,
                           projection_dim=24, vocab_size=512, eos_token_id=511,
                           max_position_embeddings=16),
              "resnet": dict(width=8, stage_sizes=(1, 1), num_classes=10)}
    shape = {"bert": dict(batch=4, seq=32), "vit": dict(batch=4),
             "clip": dict(batch=4, seq=12), "resnet": dict(batch=4, image_size=32)}
    rows = {name: {**row, **shape[row["family"]], "width": narrow[row["family"]]}
            for name, row in chip_smoke.ENCODER_ROWS.items()}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        res = chip_smoke.encoders_phase(hf, device="cpu", rows=rows,
                                        steps=dict(warmup=1, timed=2, profiled=1))
    finally:
        torch.set_num_threads(threads)
    assert sorted(k for k, v in res["checks"].items() if not v) == []
    assert len(res["checks"]) == 4 + 4 * 3 + 3 + 3 + 1
    for name, train in res["train"].items():
        assert train["steps"] == 3 and len(train["losses"]) == 3
        assert all(math.isfinite(x) for x in train["losses"])
        assert train["flops_per_step"] > 0 and train["flops_formula"][0] in "B6"
        assert set(train["profile"]["ms_per_step_by_category"]) == {
            "matmul_conv", "elementwise_softmax", "batch_norm", "adamw", "copy_memset"}
    assert res["train"]["resnet50"]["stats_max_move"] > 1e-3
    assert res["train"]["bert_large"]["tok_s"] > 0 and res["train"]["clip_b32"]["pairs_s"] > 0
    units = res["fsdp_units"]["families"]
    assert len(units) == 11 and all(r["backend"] == "gloo" for r in units.values())
