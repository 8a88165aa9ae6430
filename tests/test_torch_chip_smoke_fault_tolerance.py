"""chip_smoke.py's phase 26 (fault tolerance, chaos and SDC) rehearsed on the
CPU at narrow widths: (a) the rollback run (a torn save retried, a slow
step, nonfinite metrics rolled back to the step-4 checkpoint) against the
fault-free run, the saves' and the verification's seconds, a truncated
newest checkpoint skipped; (b) ``chip_smoke.py --ft-child`` twice, the
first preempted by its own SIGTERM (exit 75), the second resuming with
``ACCELERATE_RESTART_ATTEMPT=1``; (d) the engine's poison, canary and
drain; then ``chip_smoke.py --tp-child`` twice (phase 22 at a narrow
width, then phase 26's (e) BERT and T5 at pp=2 against the parent's
one-process steps, and (c) the SDC votes at dp_replicate=2: the golden
step twice, a transient flip repaired, a sticky one convicting rank 1,
which exits 79 for real). The script is loaded by its path; the CUDA
calls of the phases are no-ops here, so only the flash launch counts
fail, and a gate on edited lines fails each part.
"""

import copy
import importlib.util
from pathlib import Path

import pytest
import torch

_PATH = Path(__file__).resolve().parent.parent / "chip_smoke.py"
NARROW_LLAMA = dict(vocab_size=256, hidden_size=128, intermediate_size=384, num_hidden_layers=1,
                    num_attention_heads=4, num_key_value_heads=4)
STEP = dict(seq=32, batch_size=2)
FT_ROW = dict(layers=2, batch=2, seq=32)
SDC_ROW = dict(layers=1, seq=32)
ENGINE = dict(requests=4, prompt_len=8, new_tokens=6, slots=4, poison_tick=3,
              canary_every=4, canary_ticks=12, drain_after=2)
# Phase 19 (b)'s T5-base and phase 20 (b)'s BERT-large rows at narrow widths
# (T5 with its 11-block rest whole at pp=2, as T5-base's). BERT without
# dropout here: under pp its masks are drawn per microbatch and stage, so
# with dropout a pp step and a one-process step differ by their masks, which
# over this row's 10 labelled positions is more than the card's 2e-2 (its
# row averages about 1,200); the card runs phase 20's dropout.
PP_ROWS = {
    "bert_large": dict(family="bert", preset="bert_large", batch=4, seq=16, masked=0.15,
                       remat=False, numpy_weights=True,
                       width=dict(vocab_size=512, hidden_size=64, intermediate_size=128,
                                  num_hidden_layers=4, num_attention_heads=4,
                                  max_position_embeddings=64, hidden_dropout_prob=0.0)),
    "t5_base": dict(family="t5", preset="t5_base", batch=4, seq=16, dec_seq=8,
                    width=dict(vocab_size=256, d_model=64, d_kv=16, d_ff=128, num_heads=4,
                               relative_attention_num_buckets=8,
                               relative_attention_max_distance=32)),
}
NO_KERNELS = {"a_flash_launched"}


def _load():
    spec = importlib.util.spec_from_file_location("chip_smoke", _PATH)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def chip_smoke():
    return _load()


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
    """The one-process references of (e), the two children's lines with
    their exit codes, then phase 26 in this process (``ft_phase``: (a),
    (b), (d) and the gate)."""
    from accelerate_tpu_torch.ops import hopper_flash as hf

    tmp = tmp_path_factory.mktemp("ft")
    mp_ = pytest.MonkeyPatch()
    _stub_cuda(mp_)
    mp_.setenv("OMP_NUM_THREADS", "1")
    row = {**chip_smoke.FT_ROW, **FT_ROW}
    width = dict(NARROW_LLAMA)
    try:
        refs = {}
        for name, prow in PP_ROWS.items():
            _reset()
            refs[name] = chip_smoke.family_train_steps(
                hf, name, "cpu", prow, dict(warmup=1, timed=1, profiled=1))[0]["losses"]
        _reset()
        kw = {"step": dict(width=NARROW_LLAMA, profile=False, **STEP),
              "generate": dict(width=NARROW_LLAMA),
              "ft": {"rows": PP_ROWS, "sdc": {"row": SDC_ROW, "width": NARROW_LLAMA}}}
        sdc_dir = tmp / "sdc"
        sdc_dir.mkdir()
        children = chip_smoke.run_tp_children(
            {"device": "cpu", "row": None, "logits": str(tmp / "logits.npy"), "kw": kw,
             "ckpt": str(tmp), "sdc_project": str(sdc_dir)}, timeout=300)
        children, sdc_exit = chip_smoke.sticky_exits(children, str(sdc_dir))
        phase19 = {"train": {"t5_base": {"losses": refs["t5_base"]}}}
        phase20 = {"train": {"bert_large": {"losses": refs["bert_large"]}}}
        _reset()
        res = chip_smoke.ft_phase(hf, children, phase19, phase20, sdc_exit, device="cpu",
                                  width=width, row=row,
                                  engine=dict(chip_smoke.FT_ENGINE, **ENGINE))
    finally:
        mp_.undo()
        _reset()
    return res, phase19, phase20, children, sdc_exit


def test_fault_tolerance_phase_rehearsed_on_the_cpu(chip_smoke, rehearsal):
    """Every check of phase 26 passes but the flash launch count (no kernel
    on the CPU)."""
    gate, phase19, phase20, children, sdc_exit = rehearsal
    parts = gate["parts"]
    assert sdc_exit["exit_codes"] == [0, 79], [err for _, _, err in children]
    assert all(rc == 0 for rc, _, _ in children)  # rank 1's 79 read as its conviction
    failed = {k for k, v in gate["checks"].items() if not v}
    assert failed == NO_KERNELS, (failed, gate.get("child_stderr"))
    a = parts["a"]
    assert a["rollbacks"] == 1 and a["save_retries"] == 1
    assert a["save"]["sha256"]["commit_s"] > 0 and a["verify_on_load_s"] > 0
    assert [x["exit"] for x in parts["b"]["children"]] == [75, 0]
    assert parts["d"]["poisoned"]["failed_requests"] == [0]
    for rank in gate["sdc"]:
        assert rank["summary"]["repairs"] == 1 and rank["summary"]["probes_failed"] == 0


def test_a_failing_metric_fails_each_part(chip_smoke, rehearsal):
    """The gate fails each part: (a) and (b) on a failed check of the
    parent's part (a replayed loss one ulp off would fail (a)'s), (c) on a
    replayed digest moved and on the sticky exit code, (d) on the canary's
    check, (e) on the one-process reference of BERT moved by 3 %."""
    import math

    gate, phase19, phase20, children, sdc_exit = rehearsal
    parts = gate["parts"]

    def failed(p=parts, ch=children, p19=phase19, p20=phase20, ex=sdc_exit):
        return {k for k, v in chip_smoke.ft_gate(ch, copy.deepcopy(p), p19, p20,
                                                 ex)["checks"].items() if not v}

    s, loss = parts["a"]["run"][-1]
    clean = dict(parts["a"]["fault_free"])
    assert clean[s] == loss and clean[s] != math.nextafter(loss, math.inf)
    for part, check in (("a", "replay_bit_equal"), ("b", "resumed_exit_0")):
        p = copy.deepcopy(parts)
        p[part]["checks"][check] = False
        assert f"{part}_{check}" in failed(p=p)
    edited = []
    for rc, lines, err in children:
        lines = [dict(line, sdc=dict(line["sdc"], run=line["sdc"]["run"][:-1] + [
            (line["sdc"]["run"][-1][0], line["sdc"]["run"][-1][1],
             line["sdc"]["run"][-1][2] + 1.0)])) if "sdc" in line else line for line in lines]
        edited.append((rc, lines, err))
    got = failed(ch=edited)
    assert {"c_replay_bit_equal_0", "c_replay_bit_equal_1"} <= got
    assert "c_sticky_exit_79" in failed(ex=dict(sdc_exit, exit_codes=[0, 0]))
    p = copy.deepcopy(parts)
    p["d"]["checks"]["canary_sees_bit_flip"] = False
    assert "d_canary_sees_bit_flip" in failed(p=p)
    moved = {"train": {"bert_large": {"losses": [x * 1.03 for x in
                                                 phase20["train"]["bert_large"]["losses"]]}}}
    assert "e_bert_large_step1_within_tol" in failed(p20=moved)
