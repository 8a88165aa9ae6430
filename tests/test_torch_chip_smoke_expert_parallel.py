"""chip_smoke.py's phase 24 (expert parallelism) rehearsed on the CPU: the
parent runs phase 18 (b)'s step at a narrow width of Mixtral-8x7B's shape
(2 layers, 8 experts, top 2, GQA 4:1) for the reference, then starts
``chip_smoke.py --tp-child`` twice; the two ranks join a gloo group
themselves, run phase 22 at a narrow Llama width and then phase 24 at the
narrow Mixtral width: (a) ep=2 over dp_shard=2 and (b) sp=2 with ep=2
(Ulysses), each followed by greedy decoding with the experts split.
A second gang decodes with a fault in the ep decode and watches the gate
fail; ``drop_shift_witness`` is rehearsed in this process.

The script is loaded by its path; the CUDA calls of the phases are no-ops
here. No kernel runs on the CPU, so only the launch-count checks fail.
"""

import importlib.util
import pickle
from pathlib import Path

import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

_PATH = Path(__file__).resolve().parent.parent / "chip_smoke.py"
NARROW_LLAMA = dict(vocab_size=256, hidden_size=128, intermediate_size=384, num_hidden_layers=1,
                    num_attention_heads=4, num_key_value_heads=4)
STEP = dict(seq=32, batch_size=2)


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


def _narrow(chip_smoke):
    """The narrow Mixtral width and phase 18 (b)'s row at it."""
    width = dict(chip_smoke.MIXTRAL_8X7B, vocab_size=512, hidden_size=64, intermediate_size=96,
                 num_attention_heads=4, num_key_value_heads=1, max_position_embeddings=256)
    return width, dict(chip_smoke.MIXTRAL_ROW, seq=64, warmup=1, timed=2)


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
    """Phase 18 (b)'s first steps in this process, then phases 22 and 24 in
    the two children."""
    from accelerate_tpu_torch.ops import hopper_flash as hf

    width, row = _narrow(chip_smoke)
    mp_ = pytest.MonkeyPatch()
    _stub_cuda(mp_)
    mp_.setenv("OMP_NUM_THREADS", "1")  # the children's intra-op threads
    try:
        _reset()
        phase18 = chip_smoke.mixtral_train_steps(hf, device="cpu", width=width, row=row)
        _reset()
        kw = {"step": dict(width=NARROW_LLAMA, profile=False, **STEP),
              "generate": dict(width=NARROW_LLAMA), "ep": {"step": dict(width=width, row=row)}}
        logits = str(tmp_path_factory.mktemp("ep") / "logits.npy")
        children = chip_smoke.run_tp_children({"device": "cpu", "row": None, "logits": logits,
                                               "kw": kw}, timeout=300)
    finally:
        mp_.undo()
        _reset()
    return phase18, children


def test_expert_parallel_phase_rehearsed_on_the_cpu(chip_smoke, rehearsal):
    """Every check of phase 24 passes but the launch counts (no kernel on
    the CPU) and the memory estimate against the peak (no peak counter on
    the CPU: the stubbed one reads 0): (a)'s and (b)'s losses and grad norms are phase 18 (b)'s and
    equal on both ranks, the dropped choices phase 18's, the decoded
    tokens equal on both ranks and to the plain dropless decode of the
    same weights gathered whole, whose logits they match. Each rank holds 4 of the 8 experts; (a)
    gets one row, (b) both rows and half the sequence; each step runs 12
    exchanges (2 a layer in the forward, the remat recompute and the
    backward) and stages nothing on the CPU."""
    phase18, children = rehearsal
    assert all(rc == 0 for rc, _, _ in children), [err for _, _, err in children]
    gate = chip_smoke.ep_gate(children, phase18)
    failed = sorted(k for k, v in gate["checks"].items() if not v)
    assert failed == ["ep_step_estimate", "ep_step_launches", "sp_ep_step_estimate",
                      "sp_ep_step_launches"], (failed, gate.get("child_stderr"))
    a, b = gate["ep_step"], gate["sp_ep_step"]
    assert a["max_rel"] <= 1e-3 and b["max_rel"] <= 1e-3
    assert a["local_experts"] == b["local_experts"] == [4, 4]
    assert a["local_batch"] == [[1, 64]] * 2 and b["local_batch"] == [[2, 32]] * 2
    assert a["ep_axes"] == ["dp_shard"] and b["ep_axes"] == ["sp"]
    for part in (a, b):
        for ex in part["exchange_per_step"]:
            assert ex["calls"] == 12 and ex["bytes"] > 0 and ex["staged_bytes"] == 0
        assert len(part["decode"]["row"]) == chip_smoke.EP_DECODE_TOKENS
        assert part["decode"]["plain_rows"] == [part["decode"]["row"]] * 2
        assert all(d <= g for d, g in zip(part["decode"]["logit_delta"],
                                          part["decode"]["tie_gap"]))
        for loss, norm in part["step1_rel"]:
            assert loss <= chip_smoke.EP_STEP1_LOSS_TOL and norm <= chip_smoke.EP_STEP1_NORM_TOL
        assert all(g >= 0 for g in part["decode"]["min_top2_gap"])
        assert all(e > 0 for e in part["estimate_gib"])
    assert set(gate["variant_launches"]) == {"ep_step", "sp_ep_step", "ep_generate"}


def test_a_failing_metric_fails_the_phase(chip_smoke, rehearsal):
    """The gate on the same lines with phase 18's first loss off by 5 %, or
    its drops off by 1 % of the routed choices, fails; step 1's loss off
    by 1e-4 or its grad norm by 1e-3 fails the step-1 check alone, and one choice dropped more
    at step 1 the drop check; a child that exited nonzero fails the
    phase."""
    phase18, children = rehearsal
    worse = dict(phase18, first_metrics=[(l * 1.05, g) for l, g in phase18["first_metrics"]])
    gate = chip_smoke.ep_gate(children, worse)
    assert not gate["ok"] and not gate["checks"]["ep_step_vs_phase18"]
    (l1, g1), *rest = phase18["first_metrics"]
    for first in ((l1 * (1 + 1e-4), g1), (l1, g1 * (1 + 1e-3))):
        gate = chip_smoke.ep_gate(children, dict(phase18, first_metrics=[first, *rest]))
        failed = {k for k, v in gate["checks"].items() if not v}
        assert {"ep_step_step1_vs_phase18", "sp_ep_step_step1_vs_phase18"} <= failed
        assert gate["checks"]["ep_step_vs_phase18"] and gate["checks"]["sp_ep_step_vs_phase18"]
    one_more = dict(phase18, dropped=[phase18["dropped"][0] + 1, *phase18["dropped"][1:]])
    gate = chip_smoke.ep_gate(children, one_more)
    assert not gate["checks"]["ep_step_dropped"] and not gate["checks"]["sp_ep_step_dropped"]
    moved = dict(phase18, dropped=[d + phase18["routed"] // 100 + 1 for d in phase18["dropped"]])
    gate = chip_smoke.ep_gate(children, moved)
    assert not gate["checks"]["ep_step_dropped"] and not gate["checks"]["sp_ep_step_dropped"]
    broken = [(1, lines, err) for _, lines, err in children]
    assert not chip_smoke.ep_gate(broken, phase18)["ok"]


def _wrong_experts_worker(rank, init_file, out_path):
    """Phase 24 (a) on one rank of a gloo pair with a fault in the ep
    decode: each rank's expert stacks taken in reverse order, as a wrong
    offset into them would take the wrong experts."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank, world_size=2)
    cs = _load()
    cs._stub_cuda_for_cpu()
    from torch.distributed.tensor import DTensor

    from accelerate_tpu_torch import generation as gen
    from accelerate_tpu_torch.ops import hopper_flash as hf
    from accelerate_tpu_torch.parallel import tp

    dropless = gen._moe_dropless

    def reversed_experts(cfg, p, pre, x):
        w = p[pre + "moe.w_gate"]
        if tp.is_expert_split(w):
            p = {**p, **{pre + "moe." + n: DTensor.from_local(
                p[pre + "moe." + n].to_local().flip(0), w.device_mesh, w.placements)
                for n in ("w_gate", "w_up", "w_down")}}
        return dropless(cfg, p, pre, x)

    gen._moe_dropless = reversed_experts
    width, row = _narrow(cs)
    res = cs.ep_step_rank(hf, "ep_step", device="cpu", width=width, row=row, steps=2,
                          profile=False)
    cs._reset_port_state()
    from accelerate_tpu_torch.state import PartialState

    PartialState._reset_state()
    gathered = [None] * 2
    dist.all_gather_object(gathered, res["decode"])
    if rank == 0:
        with open(out_path, "wb") as f:
            pickle.dump(gathered, f)
    dist.destroy_process_group()


def test_a_wrong_expert_in_the_ep_decode_fails_the_phase(chip_smoke, rehearsal, tmp_path):
    """The faulty decode's lines in place of (a)'s sound ones: both ranks
    still agree, but the logits part from the plain decode's and the
    check fails; the sound lines pass it."""
    phase18, children = rehearsal
    assert chip_smoke.ep_gate(children, phase18)["checks"]["ep_step_decode_logits_vs_plain"]
    out = str(tmp_path / "out.pkl")
    mp.start_processes(_wrong_experts_worker, args=(str(tmp_path / "rendezvous"), out),
                       nprocs=2, join=True, start_method="spawn")
    with open(out, "rb") as f:
        faulty = pickle.load(f)
    swapped = []
    for (rc, lines, err), decode in zip(children, faulty):
        new = [dict(line, ep={**line["ep"], "ep_step": {**line["ep"]["ep_step"],
                                                          "decode": decode}})
               if "ep" in line else line for line in lines]
        swapped.append((rc, new, err))
    gate = chip_smoke.ep_gate(swapped, phase18)
    assert gate["checks"]["ep_step_decode_ranks_agree"]
    assert not gate["ok"] and not gate["checks"]["ep_step_decode_logits_vs_plain"]


def test_drop_shift_witness_rehearsed_on_the_cpu(chip_smoke, rehearsal, monkeypatch):
    """``drop_shift_witness`` at the narrow width: its plain run is phase
    18 (b)'s first three steps bit for bit, the perturbed run's step 1 is
    the plain one's (the noise enters after the step's metrics) and its
    later steps and routers differ."""
    from accelerate_tpu_torch.ops import hopper_flash as hf

    phase18, _ = rehearsal
    _stub_cuda(monkeypatch)
    width, row = _narrow(chip_smoke)
    try:
        res = chip_smoke.drop_shift_witness(hf, device="cpu", width=width, row=row,
                                            noise=(("norm", 1e-2), ("entry", 1e-2)),
                                            seeds=(0,))
    finally:
        _reset()
    assert res["ok"], res["checks"]
    plain = res["runs"]["plain"]
    assert [list(m) for m in plain["metrics"]] == [list(m) for m in phase18["first_metrics"]]
    assert plain["dropped"] == phase18["dropped"][:3]
    assert set(res["shifts"]) == {"norm:0.01:0", "entry:0.01:0"}
    for shift in res["shifts"].values():
        assert shift["max_rel"][0] == 0 and max(shift["max_rel"][1:]) > 0
        assert shift["router_max_abs_after_step1"] > 0 and shift["norm_change"] > 0
