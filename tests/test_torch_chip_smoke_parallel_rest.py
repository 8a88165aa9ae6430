"""chip_smoke.py's phase 25 (the rest of item 6) rehearsed on the CPU: the
parent runs phase 14 (b)'s fp8 step, (b)'s one-process fp8 reference and
phase 18 (b)'s Mixtral step at narrow widths, then starts ``chip_smoke.py
--tp-child`` twice; the two ranks join a gloo group themselves, run phase
22 at a narrow Llama width and then phase 25: (a) the fp8 step at tp=2, (b)
fp8 over the batch at dp_replicate=2 and under the "fp16" hook, (c)
generate over tp=2 of a narrow GPT-2 (heads and vocab that do not divide,
as GPT-2 XL's) and T5, (d) Mixtral at pp=2 over two microbatches, (e) the
DCP round trip at pp=2 and FSDP2's whole-tensor save, which the parent
resumes on one process. A second gang runs (b) with each process's own
amax (the fault before the repair) and watches the gate fail.

The script is loaded by its path; the CUDA calls of the phases are no-ops
here. No kernel runs on the CPU, so only the launch-count checks and the
fp8 products' path (the plain version, not ``_scaled_mm``) fail.
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
FP8 = dict(width=dict(NARROW_LLAMA, num_hidden_layers=2), seq=32, batch_size=4)
# GPT-2 with 5 heads and an odd vocab (GPT-2 XL's 25 heads and 50,257 ids
# do not divide by tp=2 either), T5 at tiny widths.
DECODE_ROWS = {
    "gpt2_xl": dict(family="gpt2", preset="gpt2_xl", batch=1, seq=64,
                    width=dict(n_embd=80, n_layer=2, n_head=5, vocab_size=257, n_positions=128)),
    "t5_base": dict(family="t5", preset="t5_base", batch=1, seq=64,
                    width=dict(vocab_size=256, d_model=64, d_kv=16, d_ff=128, num_layers=2,
                               num_heads=4, relative_attention_num_buckets=8,
                               relative_attention_max_distance=32)),
}


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


def _narrow_mixtral(chip_smoke):
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


def _rest_kw(chip_smoke):
    width, row = _narrow_mixtral(chip_smoke)
    return {"fp8_tp": dict(width=NARROW_LLAMA, profile=False, **STEP),
            "fp8_batch": FP8, "decode": dict(rows=DECODE_ROWS),
            "pp_mixtral": dict(width=width, row=row),
            "checkpoints": dict(width=NARROW_LLAMA, seq=32, batch_size=4)}


@pytest.fixture(scope="module")
def rehearsal(chip_smoke, tmp_path_factory):
    """The parent's references, the two children's lines, and the parent's
    one-process resume of their sharded save."""
    from accelerate_tpu_torch.ops import fp8 as fp8_ops
    from accelerate_tpu_torch.ops import hopper_flash as hf

    width, row = _narrow_mixtral(chip_smoke)
    tmp = tmp_path_factory.mktemp("rest")
    mp_ = pytest.MonkeyPatch()
    _stub_cuda(mp_)
    mp_.setenv("OMP_NUM_THREADS", "1")  # the children's intra-op threads
    try:
        _reset()
        fp8_first = chip_smoke.fp8_steps(hf, fp8_ops, device="cpu", width=NARROW_LLAMA,
                                         warmup=2, timed=1, profile=False, **STEP)["first_metrics"]
        _reset()
        fp8_ref = chip_smoke.fp8_batch_steps(hf, device="cpu", **FP8)
        _reset()
        phase18 = chip_smoke.mixtral_train_steps(hf, device="cpu", width=width, row=row)
        _reset()
        kw = {"step": dict(width=NARROW_LLAMA, profile=False, **STEP),
              "generate": dict(width=NARROW_LLAMA), "rest": _rest_kw(chip_smoke)}
        children = chip_smoke.run_tp_children(
            {"device": "cpu", "row": None, "logits": str(tmp / "logits.npy"), "kw": kw,
             "ckpt": str(tmp)}, timeout=300)
        resume = chip_smoke.sharded_resume(str(tmp), device="cpu", width=NARROW_LLAMA, seq=32)
    finally:
        mp_.undo()
        _reset()
    return fp8_first, fp8_ref, phase18, children, resume


def test_parallel_rest_phase_rehearsed_on_the_cpu(chip_smoke, rehearsal):
    """Every check of phase 25 passes but the launch counts and the fp8
    products' path (no kernel and no ``_scaled_mm`` on the CPU): (a)'s
    metrics are phase 14 (b)'s, equal on both ranks, with amax all-reduces
    over tp; (b)'s step-1 scales equal on both ranks and the one-process
    step's (its cotangents' twice theirs: each rank's loss is its share of
    the mean times 2), its step-1 loss the one-process step's and its grad
    norm within 1e-4 (DDP's mean of the halves' bf16 gradients); the hook's
    scales its own; (c) the tokens and logits of the whole weights, GPT-2's
    MLP split but its 5 heads and odd vocab whole, T5's heads split; (d)
    phase 18 (b)'s metrics and drops; (e) bit-equal round trips."""
    fp8_first, fp8_ref, phase18, children, resume = rehearsal
    assert all(rc == 0 for rc, _, _ in children), [err for _, _, err in children]
    gate = chip_smoke.rest_gate(children, fp8_first, fp8_ref, phase18, resume)
    failed = sorted(k for k, v in gate["checks"].items() if not v)
    assert failed == ["fp8_tp_launches", "fp8_tp_scaled_mm", "pp_mixtral_launches"], (
        failed, gate.get("child_stderr"))
    a, b = gate["fp8_tp"], gate["fp8_batch"]
    assert a["max_rel"] <= 1e-3 and all(n > 0 for n in a["amax_all_reduces_per_step"])
    assert b["scale_rel_to_one_process"] == 0.0
    for rank in b["rank_metrics"]:  # step 1 from the same weights; then bf16's sums differ
        assert rank[0][0] == b["one_process_metrics"][0][0]
        assert abs(rank[0][1] / b["one_process_metrics"][0][1] - 1) <= 1e-4
    assert all(n > 0 for n in b["amax_all_reduces_per_step"])
    assert b["hook_scales_differing"] > 0
    split = gate["decode"]["gpt2_xl"]["split_params"]
    assert split == [4, 4]  # c_fc and the MLP's c_proj of 2 layers
    assert all(n > 4 for n in gate["decode"]["t5_base"]["split_params"])
    for part in gate["decode"].values():
        assert part["first_divergence"] == [None, None]
        assert len(part["row"]) == chip_smoke.REST_DECODE_TOKENS
    d = gate["pp_mixtral"]
    assert d["max_rel"] <= 1e-3 and d["dropped"][0] == d["phase18_dropped"]
    for loss, norm in d["step1_rel"]:
        assert loss <= chip_smoke.EP_STEP1_LOSS_TOL and norm <= chip_smoke.EP_STEP1_NORM_TOL
    assert all(p["sends"] > 0 for p in d["p2p_per_step"])
    assert all(len(x) == chip_smoke.EP_STEPS for x in d["aux"])
    assert set(gate["variant_launches"]) == {"fp8_tp_step", "pp_mixtral_step", "pp_dcp_step"}


def test_a_failing_metric_fails_each_part(chip_smoke, rehearsal):
    """The gate on the same lines fails each part when its reference is
    moved: phase 14 (b)'s losses by 5 % (a), the one-process fp8 losses by
    5 % and one rank's step-1 scale by a bit (b), a reference token (c),
    phase 18's step-1 loss by 1e-4 (d), the resume's fingerprint (e)."""
    fp8_first, fp8_ref, phase18, children, resume = rehearsal

    def failed(*args):
        gate = chip_smoke.rest_gate(*args)
        assert not gate["ok"]
        return {k for k, v in gate["checks"].items() if not v}

    worse = [(l * 1.05, g) for l, g in fp8_first]
    assert "fp8_tp_vs_phase14" in failed(children, worse, fp8_ref, phase18, resume)
    ref = dict(fp8_ref, metrics=[(l * 1.05, g) for l, g in fp8_ref["metrics"]])
    assert "fp8_batch_vs_one_process" in failed(children, fp8_first, ref, phase18, resume)
    (l1, g1), *rest = phase18["first_metrics"]
    moved = dict(phase18, first_metrics=[(l1 * (1 + 1e-4), g1), *rest])
    assert "pp_mixtral_step1" in failed(children, fp8_first, fp8_ref, moved, resume)
    wrong = dict(resume, fingerprint=[resume["fingerprint"][0] + 1, resume["fingerprint"][1]])
    assert "sharded_resume_bit_equal" in failed(children, fp8_first, fp8_ref, phase18, wrong)

    def edited(fn):
        out = []
        for rank, (rc, lines, err) in enumerate(children):
            out.append((rc, [dict(line, rest=fn(rank, line["rest"])) if "rest" in line else line
                             for line in lines], err))
        return out

    def one_scale(rank, rest):
        if rank:
            return rest
        dp = rest["fp8_batch"]["dp"]
        scales = [(s * (1 + 2**-20), b) if i == 0 else (s, b)
                  for i, (s, b) in enumerate(dp["scales"])]
        return {**rest, "fp8_batch": {**rest["fp8_batch"], "dp": {**dp, "scales": scales}}}

    assert "fp8_batch_scales_agree" in failed(edited(one_scale), fp8_first, fp8_ref, phase18,
                                              resume)

    def other_token(rank, rest):
        dec = rest["decode"]["t5_base"]
        plain = [(t + 1) % 256 for t in dec["plain_row"]]
        gaps = [1.0] * len(plain)
        return {**rest, "decode": {**rest["decode"], "t5_base": {
            **dec, "plain_row": plain, "plain_gaps": gaps}}}

    assert "decode_t5_base_tokens" in failed(edited(other_token), fp8_first, fp8_ref, phase18,
                                             resume)

    def other_step(rank, rest):
        ck = rest["checkpoints"]
        trip = ck["dcp"]["round_trip"]
        m = [list(x) for x in trip["metrics"]]
        m[1][0] += 1e-6
        return {**rest, "checkpoints": {**ck, "dcp": {**ck["dcp"],
                                                      "round_trip": {**trip, "metrics": m}}}}

    assert "dcp_round_trip_bit_equal" in failed(edited(other_step), fp8_first, fp8_ref, phase18,
                                                resume)
    broken = [(1, lines, err) for _, lines, err in children]
    assert not chip_smoke.rest_gate(broken, fp8_first, fp8_ref, phase18, resume)["ok"]


def _local_amax_worker(rank, init_file, out_path):
    """(b) on one rank of a gloo pair with each process's own amax (no
    reduction over the batch: the fault the port had before the repair)."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank, world_size=2)
    cs = _load()
    cs._stub_cuda_for_cpu()
    from accelerate_tpu_torch.ops import fp8 as fp8_ops
    from accelerate_tpu_torch.ops import hopper_flash as hf

    fp8_ops.batch_groups = lambda: ()
    res = cs.fp8_batch_rank(hf, device="cpu", **FP8)
    cs._reset_port_state()
    from accelerate_tpu_torch.state import PartialState

    PartialState._reset_state()
    gathered = [None] * 2
    dist.all_gather_object(gathered, res)
    if rank == 0:
        with open(out_path, "wb") as f:
            pickle.dump(gathered, f)
    dist.destroy_process_group()


def test_each_process_amax_fails_phase_25b(chip_smoke, rehearsal, tmp_path):
    """(b)'s lines from ranks that scale their halves of the batch by their
    own amax in place of the sound ones: the scale check and the metrics
    against the one-process steps fail."""
    fp8_first, fp8_ref, phase18, children, resume = rehearsal
    out = str(tmp_path / "out.pkl")
    mp.start_processes(_local_amax_worker, args=(str(tmp_path / "rendezvous"), out),
                       nprocs=2, join=True, start_method="spawn")
    with open(out, "rb") as f:
        faulty = pickle.load(f)
    swapped = [(rc, [dict(line, rest={**line["rest"], "fp8_batch": res}) if "rest" in line
                     else line for line in lines], err)
               for (rc, lines, err), res in zip(children, faulty)]
    gate = chip_smoke.rest_gate(swapped, fp8_first, fp8_ref, phase18, resume)
    assert not gate["checks"]["fp8_batch_scales_agree"]
    assert gate["fp8_batch"]["max_rel"] > 1e-4
