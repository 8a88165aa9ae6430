"""chip_smoke.py's phase 18 (the Mixtral family and cp_generate) rehearsed
on the CPU: (a) and (f) as the card runs them, with the CPU standing in for
the card, (b)-(d) on a narrow 2-layer Mixtral with Mixtral-8x7B's knobs (8
experts, top 2, GQA 4:1), and (e) on a narrow Llama with a 256-token
prompt.

The script is loaded by its path; the CUDA calls of the phase are no-ops
here. No flash kernel launches on the CPU (the wrappers run their plain
versions), so the launch-count checks are the ones that fail.
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


def test_mixtral_8x7b_config_has_the_published_shape(chip_smoke):
    """mistralai/Mixtral-8x7B-v0.1 through mixtral_config_from_hf:
    1,451.3M parameters a layer and 262.1M for the embedding and head;
    the 2-layer train step holds 3.165B, the 8-layer decode model 11.87B
    (23.7 GB in bf16); a decode token reads the routed experts' 6.6 GB at
    least, all experts' 23.5 GB with a dense expert layer."""
    from accelerate_tpu_torch.models import MixtralForCausalLM
    from accelerate_tpu_torch.models.hub import mixtral_config_from_hf

    cfg = mixtral_config_from_hf(chip_smoke.MIXTRAL_8X7B)
    assert (cfg.head_dim, cfg.num_local_experts, cfg.num_experts_per_tok,
            cfg.capacity_factor) == (128, 8, 2, 2.0)
    layer = MixtralForCausalLM(cfg, device="meta").model.layers[0]
    assert sum(p.numel() for p in layer.parameters()) == 1_451_270_144
    for layers, total in ((2, 3_164_688_384), (8, 11_872_309_248)):
        cfg.num_hidden_layers = layers
        module = MixtralForCausalLM(cfg, device="meta")
        assert sum(p.numel() for p in module.parameters()) == total
    active = chip_smoke.mixtral_active_params(cfg)
    assert active["embedding_and_head"] == 262_144_000
    assert active["per_layer"] == 41_943_040 + 32_768 + 352_321_536 + 8_192
    bound = chip_smoke.moe_decode_bound(cfg)
    assert bound["routed_bytes"] / 1e9 == pytest.approx(6.57, abs=0.01)
    assert bound["all_experts_bytes"] / 1e9 == pytest.approx(23.48, abs=0.01)


def test_moe_phase_rehearsed_on_the_cpu(chip_smoke, monkeypatch):
    """The whole phase at a small width on one intra-op thread: every check
    passes but the flash launch counts."""
    import torch

    from accelerate_tpu_torch.ops import hopper_flash as hf

    _stub_cuda(monkeypatch)
    width = dict(chip_smoke.MIXTRAL_8X7B, vocab_size=512, hidden_size=64, intermediate_size=96,
                 num_attention_heads=4, num_key_value_heads=1, max_position_embeddings=256)
    row = dict(chip_smoke.MIXTRAL_ROW, seq=64, warmup=1, timed=2, decode_layers=2, requests=4)
    serving_row = dict(chip_smoke.SERVING_ROW, qps=64.0, new_tokens=16)
    llama = dict(chip_smoke.FULL_WIDTH, vocab_size=512, hidden_size=64, intermediate_size=128,
                 num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=4)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        res = chip_smoke.moe_phase(hf, device="cpu", width=width, row=row,
                                   serving_row=serving_row, llama_width=llama,
                                   cp_row=dict(prompt_len=256, new_tokens=8))
    finally:
        torch.set_num_threads(threads)
    assert sorted(k for k, v in res["checks"].items() if not v) == [
        "cp_flash_launches", "train_flash_launches"]
    tiny = res["tiny"]
    assert tiny["cpu"]["dropped"] > 0 and tiny["rel"]["loss"] == 0.0
    train = res["mixtral_8x7b_train"]
    assert train["launches"] == dict.fromkeys(chip_smoke.KERNELS, 0)
    assert train["steps"] == 3 and len(train["losses"]) == 3 and train["batch"] == 2
    assert abs(train["losses"][0] - math.log(512)) < 1.0
    assert 0.0 <= min(train["dropped_share"]) and max(train["dropped_share"]) < 1.0
    assert set(train["profile"]["moe_ms_per_step"]) == {
        "moe_combine", "moe_dispatch", "moe_expert_products", "moe_router"}
    serving = res["mixtral_8x7b_serving"]
    assert serving["stats"]["requests_completed"] == 4
    assert serving["fp32_parity"]["equal_rows"] == 4
    for agreement in (tiny["routing"], tiny["same_input_routing"]):
        assert [(a["differ"], a["first_differing"]) for a in agreement] == [(0, None)] * 2
    assert tiny["router_inputs_rel"] == [0.0, 0.0]
    assert [a["tie_gap"] for a in tiny["routing"]] == [chip_smoke.TIE_GAP] * 2
    cp = res["cp_generate"]
    assert cp["first_logits_delta"] <= chip_smoke.CP_LOGITS_DELTA
    assert 0.0 < cp["plain_bf16_fp32_delta"] and cp["tie_gap"] == 4 * cp["plain_bf16_fp32_delta"]
    assert res["cp_generate"]["divergence"] == [None]
    assert res["hub_round_trip"]["bit_equal"]


def test_kernel_summary_names_the_mixtral_shape_apart(chip_smoke):
    """The bf16 head-dim-128 variant timed at the Mixtral-8x7B step's shape
    and at cp_generate's seq 8192 has an entry each, with its own path's
    launches and the error of the phase-2 case at its shape; the
    training-shape entry keeps the paths it lists."""
    import torch

    from accelerate_tpu_torch.ops import hopper_flash as hf

    variants = {k: hf.variant(k, torch.bfloat16, 128) for k in chip_smoke.KERNELS}
    entries = [e for e in chip_smoke.TIMED
               if e[1] == "bfloat16" and e[2]["d"] == 128 and e[2]["hq"] >= 16]
    assert [e[0] for e in entries] == [None, "mixtral_8x7b", "cp_generate_8192",
                                       "llama2_7b_stream", "pp_microbatch", "ep_row",
                                       "sp_ep_ulysses"]
    assert entries[1][2:] == (chip_smoke.MIXTRAL_LIKE, ("mixtral_8x7b_step",))
    assert entries[2][2:] == (chip_smoke.CP_GEN_LIKE, ("cp_generate",))
    entries = entries[:3]
    timed = [{"name": name, "paths": paths, "dtype": "bfloat16", "shape": shape,
              "padded_to": None, "variants": variants,
              "ms": dict.fromkeys(chip_smoke.KERNELS, 2.0),
              "plain_ms": dict.fromkeys(chip_smoke.KERNELS, 9.0),
              "bound": chip_smoke.bounds(*shape.values(), "bfloat16"), "library_ms": {}}
             for name, _, shape, paths in entries]
    case = dict(variants=variants, padded_to=None, dtype="bfloat16", causal=True)
    cases = [dict(case, shape=list(t["shape"].values()), max_abs=dict.fromkeys(variants, err))
             for t, err in zip(timed, (1e-3, 2e-3, 3e-3))]
    counts = dict.fromkeys(variants.values(), 14)
    lines = chip_smoke.kernel_summary(
        timed, cases, {"variant_launches": dict.fromkeys(variants.values(), 126)},
        {"mixtral_8x7b_step": counts, "cp_generate": {variants["flash_fwd"]: 18},
         "serving_rest": {variants["flash_fwd"]: 5}})
    names = [line["name"] for line in lines]
    assert names[:3] == list(variants.values())
    assert names[3:6] == [f"{v}.mixtral_8x7b" for v in variants.values()]
    assert names[6:] == [f"{v}.cp_generate_8192" for v in variants.values()]
    assert [line["launches"] for line in lines] == [126, 126, 126, 14, 14, 14, 18, 0, 0]
    assert [line["max_abs_err"] for line in lines] == [1e-3] * 3 + [2e-3] * 3 + [3e-3] * 3
    assert lines[0]["launches_by_path"] == {"train_step": 126, "serving_rest": 5}
    assert lines[6]["launches_by_path"] == {"cp_generate": 18}


def test_routing_agreement_gates_chosen_experts_above_the_tie_gap(chip_smoke):
    """Two runs' chosen experts compared as sets, above each layer's tie
    gap: a swap of a token's two choices is no difference, a moved kept
    mask is counted apart, and a changed choice counts against the gap
    with its token and gap reported."""
    import torch

    probs = torch.tensor([[0.5, 0.3, 0.2, 0.0], [0.4, 0.3, 0.29, 0.01], [0.6, 0.3, 0.1, 0.0]])
    ref = {"probs": probs, "experts": torch.tensor([[0, 1], [0, 1], [0, 1]]),
           "kept": torch.tensor([[True, True], [True, False], [True, True]])}
    got = {"probs": probs, "experts": torch.tensor([[1, 0], [0, 2], [0, 1]]),
           "kept": torch.tensor([[True, True], [True, True], [True, True]])}
    loose, tight = (chip_smoke.routing_agreement([ref], [got], 2, [gap], chosen_only=True)[0]
                    for gap in (0.05, 1e-3))
    assert (loose["differ"], loose["differ_above_gap"], loose["kept_differ"]) == (1, 0, 1)
    assert loose["first_differing"]["token"] == 1
    assert loose["first_differing"]["gap"] == pytest.approx(0.01, abs=1e-6)
    assert tight["differ_above_gap"] == 1
    ordered = chip_smoke.routing_agreement([ref], [got], 2)[0]
    assert ordered["differ"] == 2 and ordered["tie_gap"] == chip_smoke.TIE_GAP


def test_router_input_tie_gaps(chip_smoke):
    """Equal router inputs allow only TIE_GAP; inputs further apart allow
    twice their largest probability difference more."""
    import torch

    from accelerate_tpu_torch.models.moe import router_probs

    g = torch.Generator().manual_seed(0)
    x, w = torch.randn(2, 8, 16, generator=g), torch.randn(16, 4, generator=g)
    x2 = x + 1e-2 * torch.randn(x.shape, generator=g)
    gaps, rel = chip_smoke.router_input_tie_gaps([{"inputs": (x, w)}] * 2,
                                                 [{"inputs": (x, w)}, {"inputs": (x2, w)}])
    assert gaps[0] == chip_smoke.TIE_GAP and rel[0] == 0.0
    moved = (router_probs(x2.reshape(16, 16), w) - router_probs(x.reshape(16, 16), w)).abs()
    assert gaps[1] == pytest.approx(2 * float(moved.max()) + chip_smoke.TIE_GAP)
    assert rel[1] == pytest.approx(float((x2 - x).norm() / x.norm()))
