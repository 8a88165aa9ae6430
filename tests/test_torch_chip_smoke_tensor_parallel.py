"""chip_smoke.py's phase 22 (tensor parallelism at tp=2) rehearsed on the
CPU: the parent starts ``chip_smoke.py --tp-child`` twice, the two ranks
join a gloo group themselves and run (a) phase 5's step at a narrow width
of the 1.06B Llama's shape (3 steps against the parent's one-process steps)
and (b) phase 7's greedy generate at tp=2 against the parent's tp=1 row.

The script is loaded by its path; the CUDA calls of the phase are no-ops
here. No kernel runs on the CPU, so only the launch-count check fails; a
failing check fails the phase.
"""

import importlib.util
from pathlib import Path

import pytest
import torch

_PATH = Path(__file__).resolve().parent.parent / "chip_smoke.py"
# The 1.06B Llama's shape at 2 layers of width 128 (4 heads of 32, kv heads
# split over tp) and a vocabulary of 256.
NARROW = dict(vocab_size=256, hidden_size=128, intermediate_size=384, num_hidden_layers=2,
              num_attention_heads=4, num_key_value_heads=4)
STEP = dict(seq=32, batch_size=2)


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


def _reset():
    from accelerate_tpu_torch.state import AcceleratorState, GradientState, PartialState

    for cls in (AcceleratorState, GradientState, PartialState):
        cls._reset_state()


@pytest.fixture(scope="module")
def rehearsal(chip_smoke, tmp_path_factory):
    """The references at tp=1 in this process (phase 5's steps, phase 7's
    row, its teacher-forced logits and their difference from fp32's), then
    the phase."""
    from accelerate_tpu_torch import Model, generate
    from accelerate_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from accelerate_tpu_torch.ops import hopper_flash as hf

    mp = pytest.MonkeyPatch()
    _stub_cuda(mp)
    mp.setenv("OMP_NUM_THREADS", "1")  # the children's intra-op threads
    try:
        _reset()
        phase5 = chip_smoke.full_width_steps(hf, device="cpu", width=NARROW, timed=1, **STEP)
        _reset()
        cfg = LlamaConfig(**NARROW, max_position_embeddings=2048, dtype=torch.bfloat16)
        module = LlamaForCausalLM(cfg)
        module.init_weights(torch.Generator().manual_seed(0))
        module.to(torch.bfloat16)
        prompt = chip_smoke.decode_prompt(cfg, "cpu")
        row = generate(Model(module), prompt, max_new_tokens=chip_smoke.GEN_NEW_TOKENS)
        phase7 = chip_smoke.tp_reference(cfg, module, row[0].tolist(), device="cpu")
        res = chip_smoke.tensor_parallel_phase(
            hf, phase5, phase7, device="cpu", timeout=300,
            kw={"step": dict(width=NARROW, profile=False, **STEP),
                "generate": dict(width=NARROW)})
    finally:
        mp.undo()
        _reset()
    return phase5, phase7, res


def test_tensor_parallel_phase_rehearsed_on_the_cpu(chip_smoke, rehearsal):
    """Every check passes but the launch counts (no kernel on the CPU): the
    children ran over gloo, the tp=2 steps' metrics are phase 5's, the
    ranks agree, the greedy rows and logits are phase 7's."""
    _, phase7, res = rehearsal
    failed = sorted(k for k, v in res["checks"].items() if not v)
    assert failed == ["launches_per_layer"], (failed, res.get("child_stderr"))
    assert res["backend"] == "gloo" and res["devices"] == ["cpu", "cpu"]
    a = res["a_step"]
    assert a["max_rel"] <= 1e-2 and len(a["rank_metrics"]) == 2
    assert a["split_params"] == 2 * 7 + 2  # 7 projections a layer, the embedding and head
    # A step's all-reduces: the embedding and the 2 row-parallel products a
    # layer forward, the loss's 3, one row product a layer again in the
    # remat recompute (it stops at what the backward needs), one a layer
    # for q/k/v's shared input and one for gate/up's backward plus the
    # head's, and the grad norm's two layouts: 5·L + 7.
    layers = NARROW["num_hidden_layers"]
    assert a["all_reduces_per_step"]["all_reduce"]["count"] == 5 * layers + 7
    assert all(d is None for d in res["b_generate"]["first_divergence"])
    assert res["b_generate"]["logit_delta"] < 0.1
    # The tie gap comes from phase 7's bf16 and fp32 logits alone.
    assert res["b_generate"]["tie_gap"] == max(
        chip_smoke.TIE_GAP, chip_smoke.TP_PLAIN_FACTOR * phase7["plain_delta"])
    # The timed generate's launches are counted (none: no kernel on the CPU).
    assert not any(res["generate_variant_launches"].values())


def test_a_failing_check_fails_the_phase(chip_smoke, rehearsal):
    """The gate on the same children's lines with phase 5's first loss off
    by 5 % and another phase 7 row (phase 7's tokens shifted by one id at
    a position whose top-2 gap is large) fails on those checks."""
    import numpy as np

    phase5, phase7, res = rehearsal
    worse = dict(phase5, first_metrics=[(l * 1.05, g) for l, g in phase5["first_metrics"]])
    gate = chip_smoke.tp_gate(res["_children"], worse, phase7, res["_logits"])
    assert not gate["ok"] and not gate["checks"]["metrics_vs_phase5"]
    logits = phase7["logits"]
    top2 = np.sort(logits, axis=-1)[:, -2:]
    pos = int(np.argmax(top2[:, 1] - top2[:, 0]))
    row = list(phase7["row"])
    row[chip_smoke.GEN_PROMPT + pos] = (row[chip_smoke.GEN_PROMPT + pos] + 1) % 256
    gate = chip_smoke.tp_gate(res["_children"], phase5, dict(phase7, row=row), res["_logits"])
    assert not gate["checks"]["tokens_vs_phase7"]
    broken = [(1, lines, err) for _, lines, err in res["_children"]]
    assert not chip_smoke.tp_gate(broken, phase5, phase7, res["_logits"])["ok"]


def test_wrong_tp_logits_fail_the_phase(chip_smoke, rehearsal):
    """The children's tp=2 logits with one rank's half of the vocabulary
    lost (what a vocab gather that drops a shard gives) fail the logits
    check, and the tie gap does not grow with them: a row that parts from
    phase 7's where the top-2 gap is large still fails the tokens check."""
    import numpy as np

    phase5, phase7, res = rehearsal
    wrong = res["_logits"].copy()
    wrong[:, wrong.shape[1] // 2:] = 0.0
    gate = chip_smoke.tp_gate(res["_children"], phase5, phase7, wrong)
    assert not gate["ok"] and not gate["checks"]["logits_vs_phase7"]
    assert gate["b_generate"]["tie_gap"] == res["b_generate"]["tie_gap"]
    top2 = np.sort(phase7["logits"], axis=-1)[:, -2:]
    pos = int(np.argmax(top2[:, 1] - top2[:, 0]))
    row = list(phase7["row"])
    row[chip_smoke.GEN_PROMPT + pos] = (row[chip_smoke.GEN_PROMPT + pos] + 1) % 256
    gate = chip_smoke.tp_gate(res["_children"], phase5, dict(phase7, row=row), wrong)
    assert not gate["checks"]["tokens_vs_phase7"]
    assert not gate["checks"]["logits_vs_phase7"]
