"""The port's fault tolerance (accelerate_tpu_torch.fault_tolerance) against
the JAX package's, on the CPU.

- manifests: a checkpoint directory each package commits verifies in the
  other's ``verify_checkpoint``, and a torn file (truncated, or one byte
  changed) is refused by both with the same reason;
- ``DivergenceSentinel``: equal verdict sequences over one stream of
  samples;
- the tiny fp32 Llama (2 layers, hidden 64) under one chaos schedule (a
  torn first attempt of the second save, a ``nonfinite_grad`` at step tick
  5, sentinel ``rollback`` with a window of 1), saving after steps 2 and 4:
  the port's losses within 1e-5 relative of the JAX step's, the same
  rollback count and restored step, the replayed losses bit-equal to the
  port's fault-free ones, no ``.tmp`` left;
- the save retry falling through to ``fallback_dir``; ``total_limit``
  pruning after the commit; the verified resolver skipping a torn newest
  checkpoint; an explicit torn path refused; a manifest of another world
  size refused naming ROADMAP item 12.3;
- a ``save_state(block=False)`` under ``DISTRIBUTED_STATE_DICT`` committed
  by ``wait_for_checkpoint``, and a failed background write raised there as
  ``CheckpointSaveError`` with nothing committed;
- ``automatic_resume`` and preemption in spawned children: the first sends
  itself SIGTERM after step 3, saves and exits 75; the second, relaunched
  with ``ACCELERATE_RESTART_ATTEMPT=1``, resumes and takes steps 4-6 equal
  to an uninterrupted run's;
- the watchdog warning under a chaos ``slow_step``; the handler's fields
  and checks equal the JAX handler's.

JAX is imported only inside the functions that need it: the spawned
children import this module.
"""

import dataclasses
import json
import multiprocessing
import os
import pickle

import numpy as np
import pytest
import torch

from accelerate_tpu_torch import (
    Accelerator,
    CheckpointSaveError,
    FaultToleranceKwargs,
    FullyShardedDataParallelPlugin,
    Model,
    ProjectConfiguration,
    adamw,
)
from accelerate_tpu_torch import fault_tolerance as ft
from accelerate_tpu_torch.models import LlamaConfig, LlamaForCausalLM, cross_entropy_loss
from accelerate_tpu_torch.state import AcceleratorState, GradientState, PartialState

RTOL, LR = 1e-5, 1e-3
WIDTH = dict(num_hidden_layers=2, hidden_size=64)
SAVE_AFTER = (2, 4)
SCHEDULE = [{"point": "checkpoint_save", "kind": "torn_write", "tick": 1, "unit": 0},
            {"point": "train_step", "kind": "nonfinite_grad", "tick": 5}]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the suite runs several test processes at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _reset_port():
    for cls in (AcceleratorState, GradientState, PartialState):
        cls._reset_state()


@pytest.fixture(autouse=True)
def reset_port_state():
    _reset_port()
    yield
    _reset_port()


def _batches(n=10) -> list:
    rng = np.random.default_rng(0)
    return [{"ids": rng.integers(0, 256, (4, 17))} for _ in range(n)]


def _weights() -> dict:
    module = LlamaForCausalLM(LlamaConfig.tiny(dtype=torch.float32, **WIDTH))
    module.init_weights(torch.Generator().manual_seed(0))
    return {k: v.clone() for k, v in module.state_dict().items()}


def _loss(m, b):
    ids = b["ids"]
    return cross_entropy_loss(m(ids[:, :-1]), ids[:, 1:])


def _port(tmp, handler=None, plugin=None, **pc_kw):
    acc = Accelerator(cpu=True, fsdp_plugin=plugin,
                      project_config=ProjectConfiguration(
                          project_dir=str(tmp), automatic_checkpoint_naming=True, **pc_kw),
                      kwargs_handlers=[handler] if handler is not None else None)
    module = LlamaForCausalLM(LlamaConfig.tiny(dtype=torch.float32, **WIDTH))
    module.load_state_dict(_weights())
    acc.prepare(Model(module), adamw(LR))
    return acc, acc.prepare_train_step(_loss, max_grad_norm=1.0)


def _loop(acc, step, ticks, saves=SAVE_AFTER):
    """``ticks`` steps, each on the batch of the state's step (a rollback
    replays from the restored step); saves after the steps in ``saves``.
    Returns [(step before, loss)]."""
    batches, saved, out = _batches(), set(), []
    state = acc.train_state
    for _ in range(ticks):
        s0 = int(state.step)
        state, m = step(state, {"ids": torch.from_numpy(batches[s0]["ids"])})
        out.append((s0, float(m["loss"])))
        s = int(state.step)
        if s in saves and s not in saved:
            saved.add(s)
            acc.save_state()
    return out


# ---------------------------------------------------------------------------
# Manifests across the packages
# ---------------------------------------------------------------------------


def _fill(d):
    os.makedirs(os.path.join(d, "sub"), exist_ok=True)
    rng = np.random.default_rng(3)
    for name in ("model.safetensors", "optimizer.bin", "sub/random_states_0.pkl"):
        with open(os.path.join(d, name), "wb") as f:
            f.write(rng.bytes(1000))


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("checksum", ["sha256", "size"])
def test_manifests_verify_across_the_packages(tmp_path, writer, checksum):
    from accelerate_tpu import fault_tolerance as jft

    d = str(tmp_path / "checkpoint_0")
    _fill(d)
    (ft if writer == "port" else jft).write_manifest(d, 7, 1, checksum=checksum)
    for mod in (ft, jft):
        assert mod.verify_checkpoint(d) == (True, "ok")
    manifest = json.load(open(os.path.join(d, "manifest.json")))
    assert manifest["step"] == manifest["weights_version"] == 7
    assert sorted(manifest["files"]) == ["model.safetensors", "optimizer.bin",
                                         "sub/random_states_0.pkl"]
    with open(os.path.join(d, "optimizer.bin"), "r+b") as f:
        f.seek(10)
        f.write(b"\x00" if f.read(1) != b"\x00" else b"\x01")
    got, want = ft.verify_checkpoint(d), jft.verify_checkpoint(d)
    assert got == want
    assert got == ((False, "checksum mismatch for optimizer.bin") if checksum == "sha256"
                   else (True, "ok"))
    with open(os.path.join(d, "model.safetensors"), "r+b") as f:
        f.truncate(500)
    got = ft.verify_checkpoint(d)
    assert got == jft.verify_checkpoint(d) == (
        False, "size mismatch for model.safetensors (500 != 1000)")
    os.remove(os.path.join(d, "manifest.json"))
    assert ft.verify_checkpoint(d) == jft.verify_checkpoint(d) == (False, "no-manifest")


def test_sentinel_verdicts_equal_the_jax_sentinels():
    from accelerate_tpu import fault_tolerance as jft

    rng = np.random.default_rng(1)
    samples = [(float(rng.uniform(1, 3)), float(rng.uniform(0, 2))) for _ in range(40)]
    for i in (5, 6, 7, 15, 22, 23):
        samples[i] = (float("nan"), samples[i][1])
    samples[30] = (100.0, 1.0)
    samples[33] = (1.0, float("inf"))
    samples[35] = (None, None)
    for window in (1, 2, 3):
        a = ft.DivergenceSentinel(window, 10.0, 0.1)
        b = jft.DivergenceSentinel(window, 10.0, 0.1)
        got = [a.observe(*s) for s in samples]
        want = [b.observe(*s) for s in samples]
        assert got == want and any(v == "trip" for v, _ in got)


# ---------------------------------------------------------------------------
# The rollback trajectory against the JAX step
# ---------------------------------------------------------------------------


def _jax_rollback_run(tmp, ticks):
    import jax
    import jax.numpy as jnp
    import optax

    from accelerate_tpu import Accelerator as JaxAccelerator
    from accelerate_tpu import Model as JaxModel
    from accelerate_tpu.models import LlamaConfig as JaxLlamaConfig
    from accelerate_tpu.models import LlamaForCausalLM as JaxLlama
    from accelerate_tpu.models import cross_entropy_loss as jax_ce
    from accelerate_tpu.state import AcceleratorState as JS
    from accelerate_tpu.state import GradientState as JG
    from accelerate_tpu.utils import FaultToleranceKwargs as JaxFT
    from accelerate_tpu.utils import ProjectConfiguration as JaxPC
    from accelerate_tpu_torch.models import llama_params_to_flax

    JS._reset_state()
    JG._reset_state()
    cfg = LlamaConfig.tiny(dtype=torch.float32, **WIDTH)
    jmodule = JaxLlama(JaxLlamaConfig.tiny(dtype=jnp.float32, **WIDTH))
    tree = llama_params_to_flax(cfg, _weights())
    acc = JaxAccelerator(
        project_config=JaxPC(project_dir=str(tmp), automatic_checkpoint_naming=True),
        kwargs_handlers=[JaxFT(sentinel="rollback", sentinel_window=1, retry_backoff_s=0.0,
                               chaos=dict(seed=0, schedule=[dict(e) for e in SCHEDULE]))])
    acc.prepare(JaxModel(module=jmodule, params=jax.tree.map(
        lambda t: jnp.asarray(t.numpy()), tree)), optax.adamw(LR))

    def loss_fn(p, b):
        return jax_ce(jmodule.apply({"params": p}, b["ids"][:, :-1]), b["ids"][:, 1:])

    step = acc.prepare_train_step(loss_fn, max_grad_norm=1.0)
    batches, saved, out = _batches(), set(), []
    state = acc.train_state
    for _ in range(ticks):
        s0 = int(state.step)
        state, m = step(state, {"ids": jnp.asarray(batches[s0]["ids"])})
        out.append((s0, float(m["loss"])))
        s = int(state.step)
        if s in SAVE_AFTER and s not in saved:
            saved.add(s)
            acc.save_state()
    f = acc.fault_tolerance
    result = out, f.rollbacks_done, f.save_retries_total, list(f.chaos.injected)
    JS._reset_state()
    JG._reset_state()
    return result


def test_rollback_under_chaos_matches_the_jax_step(tmp_path):
    ticks = 10
    handler = FaultToleranceKwargs(sentinel="rollback", sentinel_window=1, retry_backoff_s=0.0,
                                   chaos=dict(seed=0, schedule=[dict(e) for e in SCHEDULE]))
    acc, step = _port(tmp_path / "port", handler)
    got = _loop(acc, step, ticks)
    f = acc.fault_tolerance
    # One torn attempt retried clean; one rollback, to the save after step 4.
    assert (f.rollbacks_done, f.save_retries_total) == (1, 1)
    assert [s for s, _ in got] == [0, 1, 2, 3, 4, 5, 6, 4, 5, 6]
    base = tmp_path / "port" / "checkpoints"
    assert sorted(os.listdir(base)) == ["checkpoint_0", "checkpoint_1"]
    assert ft.verify_checkpoint(str(base / "checkpoint_1")) == (True, "ok")
    acc.end_training()
    # The replay is the fault-free run's, bit for bit.
    _reset_port()
    clean, clean_step = _port(tmp_path / "clean")
    want = dict(_loop(clean, clean_step, 7))
    assert all(loss == want[s] for s, loss in got)
    jax_out, rollbacks, retries, injected = _jax_rollback_run(tmp_path / "jax", ticks)
    assert (rollbacks, retries) == (1, 1) and injected == f.chaos.injected
    assert [s for s, _ in jax_out] == [s for s, _ in got]
    np.testing.assert_allclose([x for _, x in got], [x for _, x in jax_out], rtol=RTOL)


# ---------------------------------------------------------------------------
# Saves: retries, fallback, pruning, the verified resolver
# ---------------------------------------------------------------------------


def test_retry_falls_through_to_fallback_dir(tmp_path):
    fallback = tmp_path / "fallback"
    handler = FaultToleranceKwargs(
        sentinel="off", save_retries=2, retry_backoff_s=0.0, fallback_dir=str(fallback),
        chaos=dict(seed=0, schedule=[{"point": "checkpoint_save", "kind": "torn_write",
                                      "tick": 0, "count": 3}]))
    acc, step = _port(tmp_path / "run", handler)
    _loop(acc, step, 1, saves=())
    out = acc.save_state()
    assert out == str(fallback / "checkpoint_0")
    assert acc.fault_tolerance.save_retries_total == 2
    assert ft.verify_checkpoint(out) == (True, "ok")
    assert not os.path.exists(tmp_path / "run" / "checkpoints" / "checkpoint_0.tmp")
    # Every attempt torn, the fallback too: CheckpointSaveError.
    acc.fault_tolerance.chaos = __import__("accelerate_tpu_torch").FaultInjector(
        schedule=[{"point": "checkpoint_save", "kind": "torn_write", "count": 9}])
    acc.fault_tolerance.handler = dataclasses.replace(handler, fallback_dir=None)
    with pytest.raises(CheckpointSaveError, match="after 3 attempt"):
        acc.save_state()


def test_atomic_saves_prune_after_commit_and_skip_torn(tmp_path, caplog):
    acc, step = _port(tmp_path, FaultToleranceKwargs(sentinel="off"), total_limit=2)
    base = tmp_path / "checkpoints"
    for _ in range(3):
        _loop(acc, step, 1, saves=())
        acc.save_state()
    assert sorted(os.listdir(base)) == ["checkpoint_1", "checkpoint_2"]
    manifest = json.load(open(base / "checkpoint_2" / "manifest.json"))
    assert manifest["step"] == 3 and manifest["world_size"] == 1
    with open(base / "checkpoint_2" / "model.safetensors", "r+b") as f:
        f.truncate(100)
    assert acc.load_state() == str(base / "checkpoint_1")
    assert int(acc.train_state.step) == 2
    assert acc.project_configuration.iteration == 3  # past the torn one too
    with pytest.raises(RuntimeError, match="Refusing to restore torn checkpoint"):
        acc.load_state(str(base / "checkpoint_2"))
    # Another world size in the manifest: elastic resume waits for item 12.3.
    mpath = base / "checkpoint_1" / "manifest.json"
    manifest = json.load(open(mpath))
    manifest["world_size"] = 8
    json.dump(manifest, open(mpath, "w"))
    with pytest.raises(NotImplementedError, match="item 12.3"):
        acc.load_state(str(base / "checkpoint_1"))


def test_background_save_commits_after_its_write(tmp_path, monkeypatch):
    plugin = FullyShardedDataParallelPlugin(state_dict_type="DISTRIBUTED_STATE_DICT")
    acc, step = _port(tmp_path, FaultToleranceKwargs(sentinel="off"), plugin=plugin)
    _loop(acc, step, 1, saves=())
    out = acc.save_state(block=False)
    base = tmp_path / "checkpoints"
    assert out == str(base / "checkpoint_0")
    acc.wait_for_checkpoint()
    assert sorted(os.listdir(base)) == ["checkpoint_0"]
    assert ft.verify_checkpoint(out) == (True, "ok")
    # A failed background write: nothing committed, the staging dir removed.
    import torch.distributed.checkpoint as dcp
    from concurrent.futures import Future

    def failing(*args, **kwargs):
        fut = Future()
        fut.set_exception(OSError("disk gone"))
        return fut

    monkeypatch.setattr(dcp, "async_save", failing)
    acc.save_state(block=False)
    with pytest.raises(CheckpointSaveError, match="disk gone"):
        acc.wait_for_checkpoint()
    assert sorted(os.listdir(base)) == ["checkpoint_0"]


# ---------------------------------------------------------------------------
# Preemption and automatic_resume in spawned children
# ---------------------------------------------------------------------------


def _child(project_dir, attempt, preempt_after, steps, out_path):
    """A training process: with ``preempt_after`` it sends itself SIGTERM
    after that step, saves and exits ``preemption_exit_code``."""
    import signal
    import sys

    torch.set_num_threads(1)
    os.environ["ACCELERATE_RESTART_ATTEMPT"] = str(attempt)
    acc, step = _port(project_dir, FaultToleranceKwargs(sentinel="off"), automatic_resume=True)
    batches, state, losses = _batches(), acc.train_state, {}
    while int(state.step) < steps:
        s0 = int(state.step)
        state, m = step(state, {"ids": torch.from_numpy(batches[s0]["ids"])})
        losses[s0 + 1] = float(m["loss"])
        if int(state.step) == preempt_after:
            os.kill(os.getpid(), signal.SIGTERM)
        if acc.check_preemption():
            acc.save_state()
            with open(out_path, "wb") as f:
                pickle.dump(losses, f)
            acc.end_training()
            sys.exit(acc.preemption_exit_code)
    with open(out_path, "wb") as f:
        pickle.dump(losses, f)
    acc.end_training()


def _spawn(*args) -> int:
    proc = multiprocessing.get_context("spawn").Process(target=_child, args=args)
    proc.start()
    proc.join(300)
    return proc.exitcode


def test_preemption_exits_75_and_automatic_resume_continues(tmp_path):
    run = str(tmp_path / "run")
    assert _spawn(run, 0, 3, 6, str(tmp_path / "first")) == 75
    assert sorted(os.listdir(os.path.join(run, "checkpoints"))) == ["checkpoint_0"]
    assert _spawn(run, 1, None, 6, str(tmp_path / "second")) == 0
    first = pickle.load(open(tmp_path / "first", "rb"))
    second = pickle.load(open(tmp_path / "second", "rb"))
    assert sorted(first) == [1, 2, 3] and sorted(second) == [4, 5, 6]
    # The uninterrupted run, here: steps 4-6 bit-equal.
    os.environ.pop("ACCELERATE_RESTART_ATTEMPT", None)
    acc, step = _port(tmp_path / "whole")
    want = dict(_loop(acc, step, 6, saves=()))
    assert all(second[s] == want[s - 1] for s in (4, 5, 6))
    # A restart whose only checkpoint is an interrupted staging dir starts fresh.
    _reset_port()
    fresh = tmp_path / "fresh"
    os.makedirs(fresh / "checkpoints" / "checkpoint_0.tmp")
    os.environ["ACCELERATE_RESTART_ATTEMPT"] = "1"
    try:
        acc, _ = _port(fresh, FaultToleranceKwargs(sentinel="off"), automatic_resume=True)
        assert int(acc.train_state.step) == 0
    finally:
        os.environ.pop("ACCELERATE_RESTART_ATTEMPT", None)
    acc.end_training()


def test_signal_flags_and_handlers_are_restored(tmp_path):
    import signal

    before = signal.getsignal(signal.SIGUSR1)
    acc, _ = _port(tmp_path, FaultToleranceKwargs(sentinel="off"))
    assert not acc.should_checkpoint() and not acc.check_preemption()
    os.kill(os.getpid(), signal.SIGUSR1)
    assert acc.should_checkpoint() and acc.check_preemption()
    assert acc.fault_tolerance.preemption_signal == "SIGUSR1"
    assert acc.preemption_exit_code == 75
    acc.end_training()
    assert signal.getsignal(signal.SIGUSR1) == before
    no_ft = Accelerator(cpu=True)
    assert no_ft.fault_tolerance is None and not no_ft.should_checkpoint()


# ---------------------------------------------------------------------------
# The watchdog and the handler
# ---------------------------------------------------------------------------


def test_watchdog_warns_under_slow_step(tmp_path, caplog):
    handler = FaultToleranceKwargs(
        sentinel="off", watchdog="warn", watchdog_warn_s=0.05, watchdog_stall_s=30.0,
        watchdog_poll_s=0.01,
        chaos=dict(seed=0, schedule=[{"point": "train_step", "kind": "slow_step", "tick": 1,
                                      "seconds": 0.3}]))
    acc, step = _port(tmp_path, handler)
    _loop(acc, step, 3, saves=())
    wd = acc.fault_tolerance.watchdog
    assert wd.warnings >= 1 and wd.summary()["policy"] == "warn"
    assert any("training stalled" in r.getMessage() for r in caplog.records)
    acc.end_training()
    assert acc.fault_tolerance.watchdog._thread is None


def test_handler_fields_and_checks_equal_the_jax_handlers():
    from accelerate_tpu.utils import FaultToleranceKwargs as JaxFT

    assert [(f.name, f.default) for f in dataclasses.fields(FaultToleranceKwargs)] == \
        [(f.name, f.default) for f in dataclasses.fields(JaxFT)]
    for bad in (dict(checksum="md5"), dict(sentinel="panic"), dict(sentinel_window=0),
                dict(watchdog="loud"), dict(watchdog_warn_s=0), dict(watchdog_stall_s=1.0),
                dict(watchdog_poll_s=0), dict(watchdog_heartbeat_every=-1), dict(sdc=3)):
        with pytest.raises(ValueError) as got:
            FaultToleranceKwargs(**bad)
        with pytest.raises(ValueError) as want:
            JaxFT(**bad)
        assert str(got.value)[:12] == str(want.value)[:12]
    assert ft.CheckpointSaveError is CheckpointSaveError
