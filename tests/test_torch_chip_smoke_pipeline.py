"""chip_smoke.py's phase 23 (pipeline parallelism, the comm hooks and
``LocalSGD``) rehearsed on the CPU: the parent starts ``chip_smoke.py
--tp-child`` twice, the two ranks join a gloo group themselves, run phase
22 at a narrow width and then phase 23 at a narrow width of the 1.06B
Llama's shape (6 layers, so that ``pp_virtual_stages=3`` has a chunk a
round), against the parent's one-process phase 5 steps at that width.

The script is loaded by its path; the CUDA calls of the phases are no-ops
here. No kernel runs on the CPU, so only the two launch-count checks fail.
A second gang runs phase 23's parts with a fault put into the code under
test (the pipelined logits shifted on the last stage, one PowerSGD leaf
scaled on one rank, LocalSGD's average left out): each makes its check,
and so the phase, fail.
"""

import importlib.util
import pickle
from pathlib import Path

import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

_PATH = Path(__file__).resolve().parent.parent / "chip_smoke.py"
# The 1.06B Llama's shape at width 128 (4 heads of 32): 1 layer for phase
# 22 (tests/test_torch_chip_smoke_tensor_parallel.py rehearses it), 6 for
# phase 23; a vocabulary of 256.
NARROW = dict(vocab_size=256, hidden_size=128, intermediate_size=384, num_hidden_layers=1,
              num_attention_heads=4, num_key_value_heads=4)
NARROW6 = dict(NARROW, num_hidden_layers=6)
STEP = dict(seq=32, batch_size=2)
PP = {"step": dict(width=NARROW6, seq=32, batch_size=4, profile=False),
      "pippy": dict(width=NARROW6, seq=32, batch_size=4),
      "hooks": dict(width=NARROW6, seq=32, batch_size=4),
      "local_sgd": dict(width=NARROW6, seq=32)}


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
def rehearsal(chip_smoke):
    """The references at pp=1 in this process (phase 5's steps at both
    widths, phase 7's row and its logits), then phases 22 and 23 in the two
    children."""
    from accelerate_tpu_torch import Model, generate
    from accelerate_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from accelerate_tpu_torch.ops import hopper_flash as hf

    mp_ = pytest.MonkeyPatch()
    _stub_cuda(mp_)
    mp_.setenv("OMP_NUM_THREADS", "1")  # the children's intra-op threads
    try:
        _reset()
        phase5_tp = chip_smoke.full_width_steps(hf, device="cpu", width=NARROW, timed=1, **STEP)
        _reset()
        phase5 = chip_smoke.full_width_steps(hf, device="cpu", width=NARROW6, timed=1, seq=32,
                                             batch_size=4)
        _reset()
        cfg = LlamaConfig(**NARROW, max_position_embeddings=2048, dtype=torch.bfloat16)
        module = LlamaForCausalLM(cfg)
        module.init_weights(torch.Generator().manual_seed(0))
        module.to(torch.bfloat16)
        prompt = chip_smoke.decode_prompt(cfg, "cpu")
        row = generate(Model(module), prompt, max_new_tokens=chip_smoke.GEN_NEW_TOKENS)
        phase7 = chip_smoke.tp_reference(cfg, module, row[0].tolist(), device="cpu")
        res = chip_smoke.tensor_parallel_phase(
            hf, phase5_tp, phase7, device="cpu", timeout=300,
            kw={"step": dict(width=NARROW, profile=False, **STEP),
                "generate": dict(width=NARROW), "pp": PP})
    finally:
        mp_.undo()
        _reset()
    return phase5, res


def test_pipeline_phase_rehearsed_on_the_cpu(chip_smoke, rehearsal):
    """Phase 22 passes as before, and phase 23's checks all pass but the
    launch counts (no kernel on the CPU): the GPipe and interleaved steps'
    metrics are phase 5's and equal on both ranks, each holds 3 of the 6
    layers, the sends are those of the schedules, the pipelined logits are
    the resident ones, the hooks and LocalSGD pass."""
    phase5, res = rehearsal
    failed = sorted(k for k, v in res["checks"].items() if not v)
    assert failed == ["launches_per_layer"], (failed, res.get("child_stderr"))
    pipe = chip_smoke.pp_gate(res["_children"], phase5)
    failed = sorted(k for k, v in pipe["checks"].items() if not v)
    assert failed == ["gpipe_launches", "interleaved_launches"], failed
    g, i = pipe["gpipe"], pipe["interleaved"]
    assert g["max_rel"] <= 1e-2 and i["max_rel"] <= 1e-2
    assert g["local_layers"] == i["local_layers"] == [3, 3]
    assert g["launches_wanted"] == [12, 12] and i["launches_wanted"] == [6, 6]
    # GPipe: each rank sends one tensor a microbatch (forward or backward);
    # interleaved: a microbatch crosses the ring 2V-1 = 5 times each way.
    mb = 32 * 128 * 2  # (1, 32, 128) bf16 activations
    assert g["p2p_per_step"] == [{"sends": 4.0, "bytes": 4.0 * mb, "staged_bytes": 0.0}] * 2
    assert i["p2p_per_step"] == [{"sends": 10.0, "bytes": 20.0 * mb, "staged_bytes": 0.0}] * 2
    assert pipe["pippy"]["rel_l2"] == 0.0 and pipe["pippy"]["returned"] == [4, 32, 256]
    hooks = pipe["hooks"]
    assert hooks["powersgd_plain_rel_max"] <= 1e-5
    # The wire: bf16 half of the plain gradients' bytes.
    no, half = hooks["no"]["wire_bytes_per_step"][0], hooks["bf16"]["wire_bytes_per_step"][0]
    assert half < 0.6 * no
    assert pipe["local_sgd"]["differ_before"] == [True] * 4
    assert pipe["local_sgd"]["equal_after"] == [False, True, False, True]
    assert pipe["reduced"].startswith("(d) and (e) at 2 of phase 5's 18 layers")


def test_a_failing_metric_fails_the_phase(chip_smoke, rehearsal):
    """The gate on the same children's lines with phase 5's first loss off
    by 5 % fails the GPipe and interleaved checks; a child that exited
    nonzero fails the phase."""
    phase5, res = rehearsal
    worse = dict(phase5, first_metrics=[(l * 1.05, g) for l, g in phase5["first_metrics"]])
    gate = chip_smoke.pp_gate(res["_children"], worse)
    assert not gate["ok"] and not gate["checks"]["gpipe_vs_phase5"]
    assert not gate["checks"]["interleaved_vs_phase5"]
    broken = [(1, lines, err) for _, lines, err in res["_children"]]
    assert not chip_smoke.pp_gate(broken, phase5)["ok"]


# ---------------------------------------------------------------------------
# Faults in the code under test
# ---------------------------------------------------------------------------


def _faulty_worker(rank, init_file, out_path):
    """Phase 23's (c), (d)'s PowerSGD run and (e) with a fault in the port:
    the last stage's pipelined output shifted, one PowerSGD leaf scaled on
    rank 0, LocalSGD's average left out."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank, world_size=2)
    cs = _load()
    cs._stub_cuda_for_cpu()
    from accelerate_tpu_torch import local_sgd
    from accelerate_tpu_torch.ops import hopper_flash as hf
    from accelerate_tpu_torch.parallel import comm_hooks, pp

    forward = pp._Schedule.forward

    def shifted(self, x, record):
        out = forward(self, x, record)
        return out if out is None else out + 0.1

    pp._Schedule.forward = shifted
    pippy = cs.pippy_rank(hf, device="cpu", **PP["pippy"])
    pp._Schedule.forward = forward
    cs._reset_port_state()
    make = comm_hooks.make_comm_hook_reducer

    def scaled(*args, **kw):
        reducer = make(*args, **kw)

        def faulty(grads, state):
            out, new = reducer(grads, state)
            if dist.get_rank() == 0:
                out = {n: g * 1.01 if n == "lm_head/kernel" else g for n, g in out.items()}
            return out, new

        return faulty

    comm_hooks.make_comm_hook_reducer = scaled
    hooks = cs.hooks_rank(hf, device="cpu", hooks=("powersgd",), **PP["hooks"])
    comm_hooks.make_comm_hook_reducer = make
    local_sgd.LocalSGD._sync_params = lambda self: None
    lsgd = cs.local_sgd_rank(hf, device="cpu", **PP["local_sgd"])
    cs._reset_port_state()
    from accelerate_tpu_torch.state import PartialState

    PartialState._reset_state()
    gathered = [None] * 2
    dist.all_gather_object(gathered, {"pippy": pippy, "hooks": hooks, "local_sgd": lsgd})
    if rank == 0:
        with open(out_path, "wb") as f:
            pickle.dump(gathered, f)
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def faulty(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pp_faults")
    out = str(tmp / "out.pkl")
    mp.start_processes(_faulty_worker, args=(str(tmp / "rendezvous"), out), nprocs=2,
                       join=True, start_method="spawn")
    with open(out, "rb") as f:
        return pickle.load(f)


def _with(children, parts):
    """The children's lines with each rank's phase-23 parts (or hooks)
    replaced."""
    out = []
    for (rc, lines, err), rank_parts in zip(children, parts):
        new = []
        for line in lines:
            if "pp" in line:
                pp = dict(line["pp"])
                for name, part in rank_parts.items():
                    pp[name] = {**pp[name], **part} if name == "hooks" else part
                line = dict(line, pp=pp)
            new.append(line)
        out.append((rc, new, err))
    return out


@pytest.mark.parametrize("part,check", [("pippy", "pippy_vs_resident"),
                                        ("hooks", "powersgd_vs_plain"),
                                        ("local_sgd", "local_sgd_equal_after_boundary")])
def test_a_fault_in_the_port_fails_the_phase(chip_smoke, rehearsal, faulty, part, check):
    """Each fault, put into the rehearsal's lines in place of that part's
    sound run, fails its check and the phase; the sound lines pass it."""
    phase5, res = rehearsal
    assert chip_smoke.pp_gate(res["_children"], phase5)["checks"][check]
    gate = chip_smoke.pp_gate(_with(res["_children"], [{part: r[part]} for r in faulty]),
                              phase5)
    assert not gate["ok"] and not gate["checks"][check]
