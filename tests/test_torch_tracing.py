"""The port's request tracing (accelerate_tpu_torch/tracing.py) against the
JAX package's.

- Both recorders driven by one script of hook calls on one fake clock give
  equal ``tick_trace()``, ``chrome_trace()``, ``explain()`` for every
  request, ``metrics_text()`` and ``stats()``, with and without a span cap
  (the same spans dropped).
- The port's engine and the JAX engine on the tiny Llama (weights carried
  by ``llama_params_from_flax``), the same prompts, chunked prefill, a
  prefill failure that retries, a poisoned slot quarantined and a seeded
  chaos schedule: equal tick-domain traces; ``explain()``'s terms sum to
  each request's TTFT.
- ``TelemetryKwargs(tracing=True)``: the recorder on the telemetry hub, the
  engine reporting to it, checkpoint saves and loads as spans of the
  events' seconds, the ``tracing`` summary block, the flight bundle's
  ``recent_spans``. The fault-tolerance events of a rollback run carry
  their durations under the field the tracer reads, so the JAX recorder
  gives their spans the same lengths.
"""

import json
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from accelerate_tpu import FaultInjector as JaxInjector
from accelerate_tpu import Model as JaxModel
from accelerate_tpu import ServingConfig as JaxServingConfig
from accelerate_tpu import ServingEngine as JaxServingEngine
from accelerate_tpu import tracing as jax_tracing
from accelerate_tpu.models import LlamaConfig as JaxLlamaConfig
from accelerate_tpu.models import LlamaForCausalLM as JaxLlama
from accelerate_tpu_torch import (
    Accelerator,
    FaultInjector,
    FaultToleranceKwargs,
    Model,
    ProjectConfiguration,
    ServingConfig,
    ServingEngine,
    TelemetryKwargs,
    adamw,
)
from accelerate_tpu_torch import tracing
from accelerate_tpu_torch.models import (
    LlamaConfig,
    LlamaForCausalLM,
    cross_entropy_loss,
    llama_params_from_flax,
)
from accelerate_tpu_torch.state import AcceleratorState, GradientState, PartialState

EXPLAIN_TOL = 1e-6  # seconds: explain()'s terms against the measured TTFT


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the suite runs several test processes at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def pair():
    """(JAX Model, port module) with one set of weights."""
    jcfg = JaxLlamaConfig.tiny(dtype=jnp.float32, attention_impl="native")
    probe = np.random.default_rng(0).integers(0, jcfg.vocab_size, (1, 8), dtype=np.int32)
    jmodel = JaxModel.from_flax(JaxLlama(jcfg), jax.random.key(0), probe)
    cfg = LlamaConfig.tiny(dtype=torch.float32)
    module = LlamaForCausalLM(cfg)
    module.load_state_dict(llama_params_from_flax(cfg, jax.tree.map(np.asarray, jmodel.params)))
    return jmodel, module


class _Clock:
    """A perf_counter that moves 0.25 ms a read, from 100 s."""

    def __init__(self):
        self.now = 100.0

    def __call__(self):
        self.now += 2.5e-4
        return self.now


class _Injector:
    """The ``on_inject`` contract of a FaultInjector, without draws."""

    seed = 7
    on_inject = None


def _script(rec):
    """Every hook of the recorder once or more, with fixed walls."""
    rec.attach_chaos(_Injector)
    rec.request_submitted(0, 0, 1.0, prompt_tokens=12, budget=6, deadline_s=2.0)
    rec.request_submitted(1, 0, 1.1, prompt_tokens=5, budget=4)
    rec.request_submitted(2, 1, 1.2, prompt_tokens=9, budget=3)
    rec.request_granted(0, 1, 1.3, slot=1, lane=None, weights_version=0, canary=False)
    rec.prefill_chunk(0, 1, 1.31, 1.35, size=8, valid=8, lane=None, slot=1, index=0,
                      final=False)
    rec.request_granted(1, 1, 1.36, slot=0, lane=2, weights_version=1, canary=True)
    _Injector.on_inject({"tick": 1, "point": "prefill_dispatch", "kind": "transfer_error",
                         "unit": 1})
    rec.request_retry(1, 1, reason="injected transfer_error", attempt=1, t=1.4)
    handle = rec.begin("publish", "swap", 2, version=1)
    _Injector.on_inject({"tick": 2, "point": "decode_tick", "kind": "poison"})
    rec.instant("serving", "marker", 2, tid="x", note="inside")
    rec.end(handle, 3, ok=True)
    rec.prefill_chunk(0, 2, 1.5, 1.56, size=4, valid=4, lane=None, slot=1, index=1, final=True)
    rec.first_token(0, 2, 1.57)
    rec.decode_tick(2, 1.58, 1.6, weights_version=0, occupancy=1, n_slots=2,
                    request_ids=[0])
    rec.decode_tick(3, 1.61, 1.64, weights_version=0, occupancy=1, n_slots=2,
                    request_ids=[0], drafted=4, accepted=2)
    rec.quarantine("slot", 0, 3, request_id=1, reason="nan")
    flow = rec.handoff(2, 3, 1.65, 1.7, lane=3, slot=0, nbytes=4096, final=True)
    rec.handoff_retry(2, 3, attempt=1, backoff_s=0.0123456789, lane=3, measured_s=0.01)
    rec.handoff_flush(2, 4, 1.71, 1.74)
    rec.handoff_insert(4, slot=0, flow=flow, request_id=2, armed=True)
    rec.request_finished(0, 4, 1.8, status="ok", new_tokens=6, weights_version=0, drafted=4,
                         accepted=2)
    rec.request_finished(1, 4, 1.81, status="shed", new_tokens=0, weights_version=None)
    rec.on_event("checkpoint_save", {"seconds": 0.5, "dir": "/c", "bytes": 10, "nested": [1]},
                 tick=5)
    rec.on_event("rollback", {"step": 6, "reason": "nonfinite"}, tick=6)
    rec.on_event("not_a_traced_event", {"seconds": 1.0})
    rec.register_gauges("serving", lambda: {"ticks": 5, "nested": {"a": 1.5}})


@pytest.mark.parametrize("max_spans", [200_000, 9])
def test_recorders_agree_on_one_script(monkeypatch, max_spans):
    out = []
    for mod in (tracing, jax_tracing):
        monkeypatch.setattr(time, "perf_counter", _Clock())
        rec = mod.TraceRecorder(mod.TraceConfig(max_spans=max_spans))
        _script(rec)
        out.append({
            "tick": rec.tick_trace(), "chrome": rec.chrome_trace(),
            "explain": {rid: rec.explain(rid) for rid in rec.request_ids()},
            "metrics": rec.metrics_text(), "stats": rec.stats()})
    got, want = out
    for key in got:
        assert got[key] == want[key], key
    assert json.dumps(got["tick"]) == json.dumps(want["tick"])
    if max_spans == 9:
        assert got["stats"]["dropped_spans"] > 0 and got["stats"]["spans"] == 9
    terms = got["explain"][0]["terms"]
    assert abs(sum(terms.values()) - got["explain"][0]["ttft_s"]) <= EXPLAIN_TOL
    with pytest.raises(KeyError):
        tracing.TraceRecorder().explain(99)


def test_trace_config_from_value_matches_jax():
    for value in (None, False, True, {"max_spans": 3}, {"enabled": False},
                  tracing.TraceConfig(wall_clock=False)):
        got = tracing.TraceConfig.from_value(value)
        want = jax_tracing.TraceConfig.from_value(
            jax_tracing.TraceConfig(wall_clock=False)
            if isinstance(value, tracing.TraceConfig) else value)
        assert (got is None) == (want is None)
        if got is not None:
            assert vars(got) == vars(want)
    with pytest.raises(TypeError):
        tracing.TraceConfig.from_value(3)


def test_reset_and_chrome_export(tmp_path):
    rec = tracing.TraceRecorder(tracing.TraceConfig(wall_clock=False))
    _script(rec)
    path = rec.export_chrome_trace(str(tmp_path / "trace.json"))
    with open(path) as f:
        doc = json.load(f)
    assert doc == json.loads(json.dumps(rec.chrome_trace()))
    # A span without walls falls back to the tick clock at 1 ms a tick.
    ev = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    assert len(ev) == rec.stats()["spans"]
    assert [e["ts"] for e in ev if e["name"] == "marker"] == [2000.0]
    pids = {e["args"]["name"]: e["pid"] for e in doc["traceEvents"] if e["ph"] == "M"
            and e["name"] == "process_name"}
    assert all(pids[e["cat"]] == e["pid"] for e in ev)
    rec.reset()
    assert rec.stats() == {"spans": 0, "dropped_spans": 0, "by_kind": {}, "requests": 0,
                           "open_spans": 0, "flows": 0}


# ---------------------------------------------------------------------------
# The engines' traces
# ---------------------------------------------------------------------------

CHAOS = dict(seed=5, rates={"prefill_dispatch": 0.1},
             schedule=[{"point": "prefill_dispatch", "kind": "transfer_error", "tick": 1,
                        "unit": 0},
                       {"point": "decode_tick", "kind": "poison", "tick": 6}])


def _engine_trace(engine, prompts, budgets):
    ids = [engine.submit(p, max_new_tokens=b) for p, b in zip(prompts, budgets)]
    rows = {}
    for _ in range(500):
        if not engine.pending:
            break
        engine.tick()
        rows.update((r["id"], r) for r in engine.poll())
    return [rows[i] for i in ids]


def test_engine_tick_traces_equal_the_jax_engines(pair):
    jmodel, module = pair
    rng = np.random.default_rng(12)
    prompts = [rng.integers(1, 256, (n,)) for n in (3, 13, 6, 21, 9, 4)]
    budgets = [5, 3, 6, 4, 7, 2]
    kw = dict(n_slots=3, max_len=64, prefill_chunks=[4, 8], max_retries=2)
    port_tr, jax_tr = tracing.TraceRecorder(), jax_tracing.TraceRecorder()
    port = ServingEngine(Model(module), ServingConfig(**kw), tracing=port_tr,
                         chaos=FaultInjector(**CHAOS))
    jeng = JaxServingEngine(jmodel, JaxServingConfig(**kw), tracing=jax_tr,
                            chaos=JaxInjector(**CHAOS))
    got = _engine_trace(port, prompts, budgets)
    want = _engine_trace(jeng, [p.astype(np.int32) for p in prompts], budgets)
    assert [r["status"] for r in got] == [r["status"] for r in want]
    assert port.fault_stats()["retries"] >= 2 and port.fault_stats()["slot_quarantines"] == 1
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["tokens"], np.asarray(w["tokens"]))
    kinds = {s["kind"] for s in port_tr.tick_trace()}
    assert {"queued", "prefill_chunk", "decode_tick", "finish", "instant"} <= kinds
    assert port_tr.tick_trace() == jax_tr.tick_trace()
    assert port_tr.stats() == jax_tr.stats()
    for rid in port_tr.request_ids():
        ex = port_tr.explain(rid)
        if ex["terms"] is not None:
            assert abs(sum(ex["terms"].values()) - ex["ttft_s"]) <= EXPLAIN_TOL
        assert {k: v for k, v in ex.items() if not k.endswith("_s") and k != "terms"
                and k != "dominant"} == {
            k: v for k, v in jax_tr.explain(rid).items()
            if not k.endswith("_s") and k != "terms" and k != "dominant"}
    # The engine's stats() is the hub's serving provider.
    assert "accelerate_tpu_serving_ticks" in port_tr.metrics_text()


def test_tracing_adds_no_host_read(pair):
    """The tick's host reads (one a decode pass) and the rows are the same
    with the recorder on and off."""
    _, module = pair
    rng = np.random.default_rng(13)
    prompts = [rng.integers(1, 256, (n,)) for n in (5, 9, 7)]
    out = []
    for tr in (None, tracing.TraceRecorder()):
        engine = ServingEngine(module, ServingConfig(n_slots=2, max_len=32,
                                                     prefill_chunks=[4, 8]), tracing=tr)
        rows = engine.run(prompts, max_new_tokens=5)
        out.append((rows, engine._stats["host_reads"], engine._stats["decode_steps"]))
    (rows0, reads0, steps0), (rows1, reads1, steps1) = out
    assert reads0 == reads1 == steps0 == steps1
    for a, b in zip(rows0, rows1):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# TelemetryKwargs(tracing=...) and the fault-tolerance events
# ---------------------------------------------------------------------------


def _reset_port():
    for cls in (AcceleratorState, GradientState, PartialState):
        cls._reset_state()


@pytest.fixture
def fresh_state():
    _reset_port()
    yield
    _reset_port()


def _loss(m, b):
    ids = b["ids"]
    return cross_entropy_loss(m(ids[:, :-1]), ids[:, 1:])


def _tiny_llama():
    module = LlamaForCausalLM(LlamaConfig.tiny(dtype=torch.float32, num_hidden_layers=2,
                                               hidden_size=64))
    module.init_weights(torch.Generator().manual_seed(0))
    return module


def _events(acc):
    with open(acc.telemetry.path) as f:
        return [json.loads(line) for line in f]


def test_telemetry_tracing_spans_checkpoints_and_the_engine(tmp_path, fresh_state):
    from accelerate_tpu_torch.profiler import dump_flight

    acc = Accelerator(cpu=True, project_dir=str(tmp_path), kwargs_handlers=[
        TelemetryKwargs(tracing=True, profile=True)])
    tr = acc.telemetry.tracing
    assert isinstance(tr, tracing.TraceRecorder) and tr.hub is acc.telemetry.hub
    module = _tiny_llama()
    acc.prepare(Model(module), adamw(1e-3))
    step = acc.prepare_train_step(_loss)
    batch = {"ids": torch.from_numpy(np.random.default_rng(0).integers(0, 256, (2, 9)))}
    step(acc.train_state, batch)
    out = acc.save_state(str(tmp_path / "ck"))
    acc.load_state(out)
    events = {e["event"]: e for e in _events(acc) if e["event"].startswith("checkpoint_")}
    spans = {s.name: s for s in tr.spans() if s.subsystem == "checkpoint"}
    assert set(spans) == {"checkpoint_save", "checkpoint_load"}
    for name, span in spans.items():
        assert span.kind == "phase"
        assert span.t1 - span.t0 == pytest.approx(events[name]["seconds"], abs=1e-9)
    # An engine built with the telemetry reports to its recorder.
    engine = ServingEngine(module, ServingConfig(n_slots=1, max_len=16),
                           telemetry=acc.telemetry)
    assert engine.tracing is tr
    engine.run([np.arange(1, 5)], max_new_tokens=3)
    assert {s.kind for s in tr.spans()} >= {"queued", "prefill_chunk", "decode_tick", "finish"}
    assert acc.telemetry.summary()["tracing"] == tr.stats()
    assert tr.metrics_text() == acc.telemetry.hub.render()
    path = dump_flight(acc.telemetry, 78, reason="test")
    with open(path) as f:
        bundle = json.load(f)
    assert bundle["recent_spans"] == json.loads(json.dumps(
        [s.tick_view() for s in tr.spans()[-50:]]))
    acc.end_training()


def test_fault_tolerance_events_carry_their_durations(tmp_path, fresh_state):
    """A rollback run under chaos with tracing: each save, verification
    and load span lasts its event's ``seconds``, the rollback is an
    instant, and the JAX recorder fed the same events gives the same
    tick-domain spans and lengths."""
    schedule = [{"point": "checkpoint_save", "kind": "torn_write", "tick": 1, "unit": 0},
                {"point": "train_step", "kind": "nonfinite_grad", "tick": 3}]
    acc = Accelerator(
        cpu=True, project_config=ProjectConfiguration(project_dir=str(tmp_path),
                                                      automatic_checkpoint_naming=True),
        kwargs_handlers=[TelemetryKwargs(tracing=True), FaultToleranceKwargs(
            sentinel="rollback", sentinel_window=1, retry_backoff_s=0.0,
            chaos=dict(seed=0, schedule=schedule))])
    acc.prepare(Model(_tiny_llama()), adamw(1e-3))
    step = acc.prepare_train_step(_loss, max_grad_norm=1.0)
    rng = np.random.default_rng(1)
    batches = [torch.from_numpy(rng.integers(0, 256, (2, 9))) for _ in range(6)]
    state, saved = acc.train_state, set()
    for _ in range(6):
        state, _ = step(state, {"ids": batches[int(state.step)]})
        s = int(state.step)
        if s in (1, 2) and s not in saved:
            saved.add(s)
            acc.save_state()
    assert acc.fault_tolerance.rollbacks_done == 1
    tr = acc.telemetry.tracing
    spans = [s for s in tr.spans() if s.subsystem == "checkpoint"]
    names = [s.name for s in spans]
    assert {"checkpoint_save", "checkpoint_verify", "checkpoint_save_retry", "rollback",
            "checkpoint_load"} <= set(names)
    events = [e for e in _events(acc) if e["event"] in tracing.TraceRecorder._EVENT_SUBSYSTEM]
    assert [e["event"] for e in events] == names
    jrec = jax_tracing.TraceRecorder(jax_tracing.TraceConfig(wall_clock=False))
    prec = tracing.TraceRecorder(tracing.TraceConfig(wall_clock=False))
    for span, e in zip(spans, events):
        fields = {k: v for k, v in e.items() if k not in ("event", "step", "t_mono")}
        if span.name == "rollback":
            assert span.kind == "event" and "seconds" not in fields
        elif "seconds" in fields:
            assert span.kind == "phase"
            assert span.t1 - span.t0 == pytest.approx(fields["seconds"], abs=1e-9)
        jrec.on_event(e["event"], fields, e["step"])
        prec.on_event(e["event"], fields, e["step"])
    assert prec.tick_trace() == jrec.tick_trace()
    acc.end_training()
