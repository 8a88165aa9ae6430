"""The port's step telemetry (accelerate_tpu_torch/telemetry.py) and its
hooks in the Accelerator, the prepared loaders, checkpoints and the serving
engine, against the JAX package's (tests/test_telemetry.py drives those).

The tiny Llama (2 layers, hidden 64, fp32) runs in both packages from the
same flax-initialised weights and the same numpy-seeded batches of 4, 4, 2
and 4 rows: the step records must agree in their keys, ``step``,
``samples``, the loss (rtol 1e-4), the collective counts and the
recompiles. The JAX package also counts the one recompile its jitted step
makes on the second call to specialise the donated buffers' layout (a
``recompile`` record with that reason); the port's eager step has no
executable cache and counts only the batch's shape change, so the port's
count is the JAX count less that one. Data-wait accounting (the calls of
the loaders' hook, step by step), checkpoint events, tracker forwarding,
the imperative loop's records and the serving engine's records agree as
well.
"""

import json
import logging
import os
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from accelerate_tpu import Accelerator as JaxAccelerator
from accelerate_tpu import Model as JaxModel
from accelerate_tpu import ServingConfig as JaxServingConfig
from accelerate_tpu import ServingEngine as JaxServingEngine
from accelerate_tpu.models import LlamaConfig as JaxLlamaConfig
from accelerate_tpu.models import LlamaForCausalLM as JaxLlama
from accelerate_tpu.models import cross_entropy_loss as jax_cross_entropy
from accelerate_tpu.utils import TelemetryKwargs as JaxTelemetryKwargs
from accelerate_tpu.utils import broadcast as jax_broadcast
from accelerate_tpu_torch import Accelerator, Model, ServingConfig, ServingEngine, adamw
from accelerate_tpu_torch.models import (
    LlamaConfig,
    LlamaForCausalLM,
    cross_entropy_loss,
    llama_params_from_flax,
)
from accelerate_tpu_torch.state import AcceleratorState, GradientState, PartialState
from accelerate_tpu_torch.telemetry import STEP_RECORD_KEYS
from accelerate_tpu_torch.utils import TelemetryKwargs
from accelerate_tpu_torch.utils.operations import broadcast
from accelerate_tpu_torch.utils import memory as port_memory
from accelerate_tpu_torch.utils.operations import collective_counters


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the driver runs several test processes at once,
    and torch's spinning thread pools would contend for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


WIDTH = dict(num_hidden_layers=2, hidden_size=64)
SHAPES = (4, 4, 2, 4)  # rows of each step's batch, 16 tokens each
LAYOUT = "donated-buffer layout (expected once)"


def _reset():
    from accelerate_tpu.state import AcceleratorState as JS
    from accelerate_tpu.state import GradientState as JG
    from accelerate_tpu.state import PartialState as JP

    for cls in (AcceleratorState, GradientState, PartialState, JS, JG, JP):
        cls._reset_state()


@pytest.fixture(autouse=True)
def reset_state():
    yield
    for cls in (AcceleratorState, GradientState, PartialState):
        cls._reset_state()
    collective_counters.enabled = False
    collective_counters.reset()


@pytest.fixture(scope="module")
def flax_params():
    module = JaxLlama(JaxLlamaConfig.tiny(dtype=jnp.float32, **WIDTH))
    probe = np.zeros((2, 16), np.int32)
    params = JaxModel.from_flax(module, jax.random.key(0), probe).params
    return jax.tree.map(np.asarray, params)


def _batches(shapes=SHAPES):
    rng = np.random.default_rng(0)
    out = []
    for n in shapes:
        ids = rng.integers(0, 256, (n, 17), dtype=np.int32)
        out.append({"x": ids[:, :-1], "y": ids[:, 1:]})
    return out


def _records(path, rank=0):
    with open(os.path.join(str(path), "telemetry", f"rank_{rank}.jsonl")) as fh:
        return [json.loads(line) for line in fh]


class _Sink:
    """A tracker that keeps what it is given."""

    name = "sink"
    requires_logging_directory = False

    def __init__(self):
        self.logged = []

    def store_init_configuration(self, values):
        pass

    def log(self, values, step=None, **kwargs):
        self.logged.append((step, values))

    def finish(self):
        pass


PAYLOAD = np.ones((4, 2), dtype=np.float32)
HANDLER = dict(sync_timing=True, log_every=2, straggler_probe_every=2, profile=True)


def _jax_run(flax_params, tmp_path, batches, **kw):
    module = JaxLlama(JaxLlamaConfig.tiny(dtype=jnp.float32, **WIDTH))
    acc = JaxAccelerator(project_dir=str(tmp_path),
                         kwargs_handlers=[JaxTelemetryKwargs(**{**HANDLER, **kw})])
    acc.prepare(JaxModel(module=module, params=jax.tree.map(jnp.asarray, flax_params)),
                optax.adamw(1e-3))
    sink = _Sink()
    acc.trackers = [sink]
    acc.gather(PAYLOAD)
    acc.reduce(PAYLOAD)
    acc.pad_across_processes(PAYLOAD)
    jax_broadcast(PAYLOAD)

    def loss_fn(p, b):
        return jax_cross_entropy(module.apply({"params": p}, b["x"]), b["y"])

    step = acc.prepare_train_step(loss_fn, max_grad_norm=1.0)
    state = acc.train_state
    for b in batches:
        state, _ = step(state, b)
    acc.save_state(str(tmp_path / "ckpt"))
    acc.load_state(str(tmp_path / "ckpt"))
    acc.end_training()
    return _records(tmp_path), sink


def _port_accelerator(flax_params, tmp_path, **kw):
    cfg = LlamaConfig.tiny(dtype=torch.float32, **WIDTH)
    module = LlamaForCausalLM(cfg)
    module.load_state_dict(llama_params_from_flax(cfg, flax_params))
    acc = Accelerator(cpu=True, project_dir=str(tmp_path),
                      kwargs_handlers=[TelemetryKwargs(**{**HANDLER, **kw})])
    model, opt = acc.prepare(Model(module), adamw(1e-3))

    def loss_fn(m, b):
        return cross_entropy_loss(m(b["x"].long()), b["y"].long())

    return acc, model, opt, loss_fn


def _port_run(flax_params, tmp_path, batches, **kw):
    acc, _, _, loss_fn = _port_accelerator(flax_params, tmp_path, **kw)
    sink = _Sink()
    acc.trackers = [sink]
    acc.gather(PAYLOAD)
    acc.reduce(PAYLOAD)
    acc.pad_across_processes(PAYLOAD)
    broadcast(PAYLOAD)
    step = acc.prepare_train_step(loss_fn, max_grad_norm=1.0)
    state = acc.train_state
    for b in batches:
        state, _ = step(state, b)
    acc.save_state(str(tmp_path / "ckpt"))
    acc.load_state(str(tmp_path / "ckpt"))
    acc.end_training()
    assert not collective_counters.enabled
    return _records(tmp_path), sink, acc


@pytest.fixture(scope="module")
def both_runs(flax_params, tmp_path_factory):
    batches = _batches()
    _reset()
    ref = _jax_run(flax_params, tmp_path_factory.mktemp("jax"), batches)
    _reset()
    port = _port_run(flax_params, tmp_path_factory.mktemp("port"), batches)
    _reset()
    return port, ref


def _events(records, event):
    return [r for r in records if r["event"] == event]


def test_step_records_agree_with_jax(both_runs):
    (port, _, _), (ref, _) = both_runs
    ps, rs = _events(port, "step"), _events(ref, "step")
    assert len(ps) == len(rs) == len(SHAPES)
    for p, r in zip(ps, rs):
        assert set(p) == set(r) == set(STEP_RECORD_KEYS) | {"loss", "t_mono"}
        assert (p["step"], p["samples"]) == (r["step"], r["samples"])
        assert p["collectives"] == r["collectives"]
        assert p["wall_s"] > 0 and p["hbm_peak_bytes"] > 0
    assert [p["samples"] for p in ps] == list(SHAPES)
    np.testing.assert_allclose([p["loss"] for p in ps], [r["loss"] for r in rs], rtol=1e-4)
    assert ps[0]["collectives"] == {op: {"count": 1, "bytes": PAYLOAD.nbytes} for op in (
        "broadcast", "gather", "pad_across_processes", "reduce")}


def test_recompiles_agree_with_jax_less_its_layout_recompile(both_runs):
    (port, _, _), (ref, _) = both_runs
    layout_steps = [r["step"] for r in _events(ref, "recompile") if r["reason"] == LAYOUT]
    assert len(layout_steps) == 1
    expected = [r["recompiles"] - sum(s <= r["step"] for s in layout_steps)
                for r in _events(ref, "step")]
    assert [p["recompiles"] for p in _events(port, "step")] == expected == [0, 0, 1, 1]
    shape = [{k: r[k] for k in ("reason", "batch_digest")} for r in _events(ref, "recompile")
             if r["reason"] != LAYOUT]
    assert [{k: r[k] for k in ("reason", "batch_digest")} for r in _events(port, "recompile")
            ] == shape == [{"reason": "batch shape/dtype change",
                            "batch_digest": "['x']:int32[2, 16]|['y']:int32[2, 16]"}]


def test_probe_checkpoint_and_summary_records_agree_with_jax(both_runs):
    (port, _, _), (ref, _) = both_runs
    for event in ("straggler_probe", "checkpoint_save", "checkpoint_load"):
        ps, rs = _events(port, event), _events(ref, event)
        assert [p["step"] for p in ps] == [r["step"] for r in rs], event
        assert {"step", "time", "t_mono"} < set(ps[0]) and set(rs[0]) - {"verify_s"} <= set(
            ps[0]) | {"blocking"}, event
    for p in _events(port, "straggler_probe"):
        assert p["rank_times_s"] == [p["step_time_max_s"]] and p["skew"] == 0.0
    save, load = _events(port, "checkpoint_save")[0], _events(port, "checkpoint_load")[0]
    assert save["seconds"] > 0 and save["format"] == "safetensors" and load["seconds"] > 0
    (psum,), (rsum,) = _events(port, "summary"), _events(ref, "summary")
    # The JAX summary also counts its jitted step's executables.
    assert set(psum) == set(rsum) - {"executables"}
    for key in ("steps", "recompiles", "checkpoint_events", "collectives"):
        assert psum[key] == (rsum[key] - 1 if key == "recompiles" else rsum[key]), key
    for key in ("saves", "loads", "retries"):
        assert psum["checkpoint"][key] == rsum["checkpoint"][key]
    assert psum["checkpoint"]["save_s"] > 0
    assert set(psum["profile"]) == set(rsum["profile"])


def test_profiler_records_of_the_loop(both_runs):
    (port, _, acc), (ref, _) = both_runs
    prof = acc.telemetry.profiler
    recs = prof.records()
    assert [r["step"] for r in recs] == [1, 2, 3, 4]
    walls = [p["wall_s"] + p["data_wait_s"] for p in _events(port, "step")]
    for rec, wall in zip(recs, walls):
        assert rec["wall_s"] == round(wall, 9)
        assert abs(sum(rec["terms"].values()) - rec["wall_s"]) <= 1e-9 * wall + 3e-9
    summary = _events(port, "summary")[0]["profile"]
    assert summary["steps"] == 4 and summary["cost_captured"] is True
    assert prof._cost["flops"] > 0 and prof._cost["bytes_accessed"] is None


def test_tracker_forwarding_agrees_with_jax(both_runs):
    (_, port_sink, _), (_, ref_sink) = both_runs
    assert [s for s, _ in port_sink.logged] == [s for s, _ in ref_sink.logged] == [2, 4]
    for (_, p), (_, r) in zip(port_sink.logged, ref_sink.logged):
        assert set(p) == set(r)
        assert p["telemetry/recompiles"] in (0, 1)


# ---------------------------------------------------------------------------
# The loaders' wait
# ---------------------------------------------------------------------------


class _SlowDataset:
    def __init__(self, x, delay_s):
        self.x, self.delay_s = x, delay_s

    def __len__(self):
        return len(self.x)

    def __getitem__(self, i):
        time.sleep(self.delay_s)
        return {"x": self.x[i][:-1], "y": self.x[i][1:]}


class _Spec:
    def __init__(self, dataset, batch_size):
        self.dataset, self.batch_size, self.sampler, self.drop_last = dataset, batch_size, None, True


def _count_waits(tel):
    """Wrap the hook: (step it lands on, seconds) of each call."""
    calls = []
    inner = tel.add_data_wait

    def add(seconds):
        calls.append((tel.step + 1, seconds))
        inner(seconds)

    tel.add_data_wait = add
    return calls


def test_data_wait_accounting_agrees_with_jax(flax_params, tmp_path):
    from accelerate_tpu.utils import DataLoaderConfiguration as JaxDLC

    from accelerate_tpu_torch import DataLoaderConfiguration

    # Batches of 8: one row per virtual device of the JAX package's mesh.
    tokens = np.random.default_rng(1).integers(0, 256, (40, 17), dtype=np.int32)
    runs = {}
    for name in ("jax", "port"):
        _reset()
        if name == "jax":
            module = JaxLlama(JaxLlamaConfig.tiny(dtype=jnp.float32, **WIDTH))
            acc = JaxAccelerator(project_dir=str(tmp_path / name),
                                 dataloader_config=JaxDLC(prefetch_size=0),
                                 kwargs_handlers=[JaxTelemetryKwargs(**HANDLER)])
            _, _, dl = acc.prepare(
                JaxModel(module=module, params=jax.tree.map(jnp.asarray, flax_params)),
                optax.adamw(1e-3), _Spec(_SlowDataset(tokens, 0.002), 8))

            def loss_fn(p, b, module=module):
                return jax_cross_entropy(module.apply({"params": p}, b["x"]), b["y"])
        else:
            cfg = LlamaConfig.tiny(dtype=torch.float32, **WIDTH)
            module = LlamaForCausalLM(cfg)
            module.load_state_dict(llama_params_from_flax(cfg, flax_params))
            acc = Accelerator(cpu=True, project_dir=str(tmp_path / name),
                              dataloader_config=DataLoaderConfiguration(prefetch_size=0),
                              kwargs_handlers=[TelemetryKwargs(**HANDLER)])
            _, _, dl = acc.prepare(Model(module), adamw(1e-3),
                                   _Spec(_SlowDataset(tokens, 0.002), 8))
            assert dl._telemetry is acc.telemetry

            def loss_fn(m, b):
                return cross_entropy_loss(m(b["x"].long()), b["y"].long())
        calls = _count_waits(acc.telemetry)
        step = acc.prepare_train_step(loss_fn)
        state = acc.train_state
        for i, batch in enumerate(dl):
            state, _ = step(state, batch)
            if i == 3:
                break
        acc.end_training()
        runs[name] = (calls, _records(tmp_path / name))
    (pc, precs), (jc, jrecs) = runs["port"], runs["jax"]
    # The same calls of the hook, landing on the same steps: the first step
    # waits for two batches (the loader looks one ahead), the others for one.
    assert [s for s, _ in pc] == [s for s, _ in jc] == [1, 1, 2, 3, 4]
    for calls, recs in ((pc, precs), (jc, jrecs)):
        steps = _events(recs, "step")
        assert sum(r["data_wait_s"] for r in steps) == pytest.approx(sum(s for _, s in calls),
                                                                     rel=1e-12)
        # Eight items at 2 ms each are collated inside next() without prefetch.
        assert min(r["data_wait_s"] for r in steps) > 0.012
        assert _events(recs, "summary")[0]["data_wait_mean_s"] > 0.012


# ---------------------------------------------------------------------------
# The imperative loop
# ---------------------------------------------------------------------------


def test_imperative_loop_records_optimizer_steps_as_jax(flax_params, tmp_path):
    batches = _batches((4, 4, 4))
    _reset()
    module = JaxLlama(JaxLlamaConfig.tiny(dtype=jnp.float32, **WIDTH))
    jacc = JaxAccelerator(project_dir=str(tmp_path / "jax"),
                          kwargs_handlers=[JaxTelemetryKwargs(**HANDLER)])
    _, jopt = jacc.prepare(JaxModel(module=module, params=jax.tree.map(jnp.asarray, flax_params)),
                           optax.adamw(1e-3))

    def jax_loss(p, b):
        return jax_cross_entropy(module.apply({"params": p}, b["x"]), b["y"])

    for b in batches:
        with jacc.accumulate():
            jacc.backward(jax_loss, b)
            jopt.step()
            jopt.zero_grad()
    jacc.end_training()
    _reset()
    acc, model, opt, loss_fn = _port_accelerator(flax_params, tmp_path / "port")
    for b in batches:
        with acc.accumulate(model):
            acc.backward(loss_fn, b)
            opt.step()
            opt.zero_grad()
    acc.end_training()
    ps = _events(_records(tmp_path / "port"), "optimizer_step")
    rs = _events(_records(tmp_path / "jax"), "optimizer_step")
    assert len(ps) == len(rs) == 3
    for p, r in zip(ps, rs):
        assert set(p) == set(r) and p["step"] == r["step"]
        assert p["backward_s"] > 0 and p["apply_s"] > 0
        assert p["wall_s"] == p["backward_s"] + p["apply_s"]
        assert p["recompiles"] == 0 and p["collectives"] == r["collectives"] == {}


# ---------------------------------------------------------------------------
# The port's own contracts
# ---------------------------------------------------------------------------


def _port_steps(flax_params, tmp_path, batches, **kw):
    acc, _, _, loss_fn = _port_accelerator(flax_params, tmp_path, **kw)
    step = acc.prepare_train_step(loss_fn)
    state = acc.train_state
    for b in batches:
        state, _ = step(state, b)
    return acc, step, state


def test_recompile_watchdog_warns_once_with_the_digest(flax_params, tmp_path, caplog):
    acc, step, state = _port_steps(flax_params, tmp_path, _batches((4, 4)), profile=False)
    with caplog.at_level(logging.WARNING):
        for b in _batches((2, 2)):
            state, _ = step(state, b)
    acc.end_training()
    warned = [r.getMessage() for r in caplog.records if "shape/dtype changed" in r.getMessage()]
    assert len(warned) == 1 and "['x']:int32[2, 16]" in warned[0]
    assert acc.telemetry.recompiles == 1


def test_a_repeated_digest_never_counts(flax_params, tmp_path, caplog):
    """The port's twin of the JAX package's donated-layout test: the same
    batch shape, step after step, is no recompile and no warning."""
    with caplog.at_level(logging.WARNING):
        acc, _, _ = _port_steps(flax_params, tmp_path, _batches((4,) * 6), profile=False)
    acc.end_training()
    assert not any("recompile" in r.getMessage() for r in caplog.records)
    recs = _records(tmp_path)
    assert not _events(recs, "recompile")
    assert all(r["recompiles"] == 0 for r in _events(recs, "step"))


def test_no_sync_without_sync_timing(flax_params, tmp_path, monkeypatch):
    """sync_timing=False: the wrappers never synchronise and the loss is
    not read."""
    acc, _, _, loss_fn = _port_accelerator(flax_params, tmp_path, sync_timing=False)
    monkeypatch.setattr(acc, "_synchronize", lambda: pytest.fail("synchronised"))
    step = acc.prepare_train_step(loss_fn)
    state = acc.train_state
    for b in _batches((4, 4)):
        state, _ = step(state, b)
    acc.end_training()
    assert all("loss" not in r for r in _events(_records(tmp_path), "step"))


def test_collective_counters_disabled_without_telemetry():
    from accelerate_tpu_torch.utils.operations import gather

    Accelerator(cpu=True)
    collective_counters.enabled = False
    collective_counters.reset()
    gather(np.ones((2,), dtype=np.float32))
    assert collective_counters.snapshot() == {}


def test_disabled_by_default_no_files_no_recorder(flax_params, tmp_path):
    cfg = LlamaConfig.tiny(dtype=torch.float32, **WIDTH)
    acc = Accelerator(cpu=True, project_dir=str(tmp_path))
    assert acc.telemetry is None
    model, _, dl = acc.prepare(Model(LlamaForCausalLM(cfg)), adamw(1e-3),
                               _Spec(_SlowDataset(np.zeros((8, 17), np.int32), 0.0), 4))
    assert dl._telemetry is None
    step = acc.prepare_train_step(lambda m, b: cross_entropy_loss(m(b["x"].long()),
                                                                  b["y"].long()))
    for b in dl:
        step(acc.train_state, b)
    acc.end_training()
    assert not os.path.exists(tmp_path / "telemetry")


def test_jsonl_rotates_at_max_log_bytes(flax_params, tmp_path, caplog):
    with caplog.at_level(logging.WARNING):
        acc, _, _ = _port_steps(flax_params, tmp_path, _batches((4,) * 6), profile=False,
                                max_log_bytes=1500)
    acc.end_training()
    path = tmp_path / "telemetry" / "rank_0.jsonl"
    assert (tmp_path / "telemetry" / "rank_0.jsonl.1").exists() and path.exists()
    assert sum("was rotated" in r.getMessage() for r in caplog.records) == 1


def test_end_training_closes_telemetry_before_trackers(flax_params, tmp_path):
    acc, _, _ = _port_steps(flax_params, tmp_path, _batches((4,)), profile=False)
    seen = []

    class _Reader(_Sink):
        def finish(self):
            seen.append([r["event"] for r in _records(tmp_path)][-1])

    acc.trackers = [_Reader()]
    acc.end_training()
    assert seen == ["summary"]


def test_memory_gauges_on_the_cpu_and_from_cuda_counters(monkeypatch):
    assert port_memory.get_device_memory_stats("cpu") == {}
    assert dict(jax.devices("cpu")[0].memory_stats() or {}) == {}  # the JAX CPU device's
    before = port_memory.live_bytes_on_device("cpu")
    keep = torch.empty(1 << 18, dtype=torch.float32)  # 1 MiB
    assert port_memory.live_bytes_on_device("cpu") - before >= keep.nbytes

    class _Props:
        total_memory = 80 * 2**30

    raw = {"allocated_bytes.all.current": 5, "allocated_bytes.all.peak": 9,
           "reserved_bytes.all.current": 16}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "memory_stats", lambda device=None: raw)
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda device=None: _Props)
    assert port_memory.get_device_memory_stats() == {
        "bytes_in_use": 5, "peak_bytes_in_use": 9, "bytes_limit": 80 * 2**30}


def test_telemetry_kwargs_match_jax_and_tracing_raises():
    import dataclasses

    port = [(f.name, f.default) for f in dataclasses.fields(TelemetryKwargs)]
    ref = [(f.name, f.default) for f in dataclasses.fields(JaxTelemetryKwargs)]
    assert port == ref
    assert TelemetryKwargs(log_every=2).to_kwargs() == JaxTelemetryKwargs(log_every=2).to_kwargs()
    # tracing takes what TraceConfig.from_value takes; anything else raises
    # at construction.
    for value in (True, False, None, {"max_spans": 8}):
        assert TelemetryKwargs(tracing=value).to_kwargs() == \
            JaxTelemetryKwargs(tracing=value).to_kwargs()
    with pytest.raises(TypeError, match="tracing must be bool, dict, or TraceConfig"):
        TelemetryKwargs(tracing=3)
    with pytest.raises(TypeError):
        TelemetryKwargs(tracing={"no_such_field": 1})

    from accelerate_tpu_torch.utils import KwargsHandler

    class _Other(KwargsHandler):
        pass

    with pytest.raises(NotImplementedError, match="_Other is not ported"):
        Accelerator(cpu=True, kwargs_handlers=[_Other()])


def test_warning_once_dedups_and_handles_unhashable(caplog):
    from accelerate_tpu_torch.logging import get_logger

    PartialState(cpu=True)
    logger = get_logger("test_torch_warning_once_dedup")
    with caplog.at_level(logging.WARNING, logger="test_torch_warning_once_dedup"):
        logger.warning_once("dup message %s", 1)
        logger.warning_once("dup message %s", 1)
        logger.warning_once("dup message %s", 2)
        logger.warning_once("unhashable %s", {"a": [1, 2]})
        logger.warning_once("unhashable %s", {"a": [1, 2]})
    messages = [r.getMessage() for r in caplog.records]
    assert messages.count("dup message 1") == 1 and messages.count("dup message 2") == 1
    assert messages.count("unhashable {'a': [1, 2]}") == 1


def test_warning_once_shared_across_adapters(caplog):
    from accelerate_tpu_torch.logging import _warning_once_key, get_logger

    PartialState(cpu=True)
    a, b = get_logger("test_torch_warning_once_shared"), get_logger("test_torch_warning_once_shared")
    assert a is not b
    with caplog.at_level(logging.WARNING, logger="test_torch_warning_once_shared"):
        a.warning_once("shared-once")
        b.warning_once("shared-once")
    assert sum(r.getMessage() == "shared-once" for r in caplog.records) == 1

    class _BadRepr:
        def __repr__(self):
            raise RuntimeError("no repr")

    assert _warning_once_key("msg", (_BadRepr(),), {}) == "msg"


# ---------------------------------------------------------------------------
# The serving engine
# ---------------------------------------------------------------------------

PROMPT_LENGTHS = [3, 7, 12, 20, 3, 7]
BUDGETS = [6, 4, 8, 3, 6, 4]


def test_engine_telemetry_and_ticks_agree_with_jax(flax_params, tmp_path):
    prompts = [np.random.default_rng(3).integers(1, 256, (n,), dtype=np.int32)
               for n in PROMPT_LENGTHS]
    kw = dict(n_slots=3, max_len=64, prefill_chunks=[4, 8])
    _reset()
    jacc = JaxAccelerator(project_dir=str(tmp_path / "jax"),
                          kwargs_handlers=[JaxTelemetryKwargs(profile=True)])
    jmodel = JaxModel(module=JaxLlama(JaxLlamaConfig.tiny(dtype=jnp.float32, **WIDTH)),
                      params=jax.tree.map(jnp.asarray, flax_params))
    jengine = JaxServingEngine(jmodel, JaxServingConfig(**kw), telemetry=jacc.telemetry)
    want = jengine.run(prompts, max_new_tokens=BUDGETS)
    jticks = jacc.telemetry.profiler.records()
    jacc.end_training()
    _reset()
    acc = Accelerator(cpu=True, project_dir=str(tmp_path / "port"),
                      kwargs_handlers=[TelemetryKwargs(profile=True)])
    cfg = LlamaConfig.tiny(dtype=torch.float32, **WIDTH)
    module = LlamaForCausalLM(cfg)
    module.load_state_dict(llama_params_from_flax(cfg, flax_params))
    engine = ServingEngine(Model(module), ServingConfig(**kw), telemetry=acc.telemetry)
    assert engine._profiler is acc.telemetry.profiler
    got = engine.run(prompts, max_new_tokens=BUDGETS)
    stats = engine.stats()
    ticks = acc.telemetry.profiler.records()
    text = acc.telemetry.hub.render()
    acc.end_training()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
    # The lagged tick records: every tick but the last, then the last at close.
    assert len(ticks) == stats["ticks"] - 1 == len(jticks)
    ticks = acc.telemetry.profiler.records()
    assert len(ticks) == stats["ticks"]
    for rec in ticks:
        assert set(rec["terms"]) == set(jticks[0]["terms"])
        assert abs(sum(rec["terms"].values()) - rec["wall_s"]) <= 1e-9 * rec["wall_s"] + 3e-9
    precs, jrecs = _records(tmp_path / "port"), _records(tmp_path / "jax")
    pdone, jdone = _events(precs, "serving_request_done"), _events(jrecs, "serving_request_done")
    keys = ("request_id", "status", "new_tokens", "prompt_tokens")
    assert [{k: r[k] for k in keys} for r in pdone] == [{k: r[k] for k in keys} for r in jdone]
    assert set(pdone[0]) <= set(jdone[0])
    (block,) = _events(precs, "serving_summary")
    assert len(_events(jrecs, "serving_summary")) == 1
    assert (block["ttft_p50_s"], block["ttft_p95_s"]) == (stats["ttft_p50_s"],
                                                           stats["ttft_p95_s"])
    assert _events(precs, "summary")[0]["serving"]["requests_completed"] == len(prompts)
    assert "accelerate_tpu_slo_serving_availability_burn_rate 0.0" in text
    assert "accelerate_tpu_serving_requests_completed 6" in text
