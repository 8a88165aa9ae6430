"""The port's device-time profiler, metrics hub and flight recorder
(accelerate_tpu_torch/profiler.py) against the JAX package's
(accelerate_tpu/profiler.py), as tests/test_profiler.py drives those.

Both packages get the same walls, data waits, straggler skews, tick
sections and plan dict (numpy-seeded), and must emit the same records
exactly (``t_mono``, the host clock at emission, aside), the same summary,
the same Prometheus text, and one flight bundle per exit class. The port's
records are rounded to the nanosecond as the JAX package's are, so a
record's terms sum to its ``wall_s`` within 1e-9 relative plus half a
nanosecond for each number rounded.
"""

import json
import os

import numpy as np
import pytest

from accelerate_tpu import profiler as jax_profiler
from accelerate_tpu.utils import constants as jax_constants
from accelerate_tpu_torch import profiler
from accelerate_tpu_torch.profiler import (
    COMM_AXES,
    STEP_TERMS,
    TICK_TERMS,
    DeviceTimeProfiler,
    FlightRecorder,
    MetricsHub,
    ProfilerConfig,
    dump_flight,
    exit_class_name,
    find_flight_bundles,
)
from accelerate_tpu_torch.utils import constants
from accelerate_tpu_torch.utils.constants import (
    EXIT_CODE_TABLE,
    FLIGHT_DIR_ENV,
    SDC_EXIT_CODE,
    SERVING_CRASH_EXIT_CODE,
)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the driver runs several test processes at once,
    and torch's spinning thread pools would contend for the cores."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# A plan shaped like the JAX planner's plan dict: enough for note_plan to
# price comm terms and bandwidth residuals.
PLAN = {
    "layout": {"dp_shard": 8},
    "n_devices": 8,
    "predicted_step_s": 0.010,
    "breakdown": {
        "compute_s": 0.006, "fsdp_comm_s": 0.003, "dp_comm_s": 0.0, "tp_comm_s": 0.0,
        "cp_comm_s": 0.0, "pp_comm_s": 0.0, "fsdp_bytes": 1 << 20, "step_s": 0.010,
    },
    "bandwidths": {
        "ici_gbps": 100.0, "dcn_gbps": 25.0, "flops_per_chip": 1e12, "mfu": 0.4,
        "collective_efficiency": 0.8, "ici_domain": 64, "dp_overlap": 0.8,
    },
}
# The same plan with a tensor-parallel axis and more devices than one fast
# domain holds, so that the dp/fsdp axes take the slow link.
PLAN_TP = {**PLAN, "n_devices": 128,
           "breakdown": {**PLAN["breakdown"], "tp_comm_s": 0.002, "dp_comm_s": 0.001,
                         "tp_bytes": 1 << 18, "dp_bytes": 1 << 16}}


def _pair(**cfg):
    cfg.setdefault("capture_cost", False)
    return (DeviceTimeProfiler(ProfilerConfig(**cfg)),
            jax_profiler.DeviceTimeProfiler(jax_profiler.ProfilerConfig(**cfg)))


def _strip(records):
    return [{k: v for k, v in r.items() if k != "t_mono"} for r in records]


def _sums_to_wall(rec) -> bool:
    """The identity, to the rounding of the record's numbers."""
    terms = rec["terms"]
    slack = 1e-9 * rec["wall_s"] + 0.5e-9 * (len(terms) + 1)
    return abs(sum(terms.values()) - rec["wall_s"]) <= slack


def _feed(prof, walls, waits, skews, plan=None):
    if plan is not None:
        prof.note_plan(plan)
    for i, (w, d, s) in enumerate(zip(walls, waits, skews)):
        if s is not None:
            prof.note_straggler(s)
        prof.on_step(i + 1, wall_s=w, data_wait_s=d)
    prof.flush()


def _inputs(seed, n=12):
    rng = np.random.default_rng(seed)
    walls = rng.uniform(0.005, 0.4, n).tolist()
    waits = (rng.uniform(0, 0.01, n) * (rng.random(n) < 0.7)).tolist()
    skews = [float(x) if rng.random() < 0.4 else None for x in rng.uniform(0, 0.05, n)]
    return walls, waits, skews


# ---------------------------------------------------------------------------
# The records, against the JAX package's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("plan", [None, PLAN, PLAN_TP], ids=["no_plan", "fsdp", "tp_dcn"])
@pytest.mark.parametrize("seed", [0, 1])
def test_step_records_equal_jax(plan, seed):
    port, ref = _pair()
    walls, waits, skews = _inputs(seed)
    _feed(port, walls, waits, skews, plan)
    _feed(ref, walls, waits, skews, plan)
    assert _strip(port.records()) == _strip(ref.records())
    assert port.summary() == ref.summary()
    for rec in port.records():
        assert set(rec["terms"]) == set(STEP_TERMS)
        assert _sums_to_wall(rec), rec


@pytest.mark.parametrize("seed", [0, 1])
def test_tick_records_equal_jax(seed):
    port, ref = _pair()
    rng = np.random.default_rng(seed)
    for i in range(10):
        parts = rng.uniform(0, 0.004, 5)
        sections = dict(zip(TICK_TERMS, parts.tolist()))
        if i % 3 == 0:
            sections.pop("bookkeeping_s")
        wall = float(parts.sum() + rng.uniform(0, 0.003))
        gauges = {"occupancy": int(rng.integers(0, 8))}
        port.on_tick(i, wall, sections=sections, gauges=gauges)
        ref.on_tick(i, wall, sections=sections, gauges=gauges)
    port.flush()
    ref.flush()
    assert _strip(port.records()) == _strip(ref.records())
    assert port.summary() == ref.summary()
    assert port.flight.snapshot()["gauges"] == ref.flight.snapshot()["gauges"]
    for rec in port.records():
        assert set(rec["terms"]) == set(TICK_TERMS) and _sums_to_wall(rec)


def test_step_terms_without_plan_degrade_to_residual():
    prof, _ = _pair()
    prof.on_step(0, wall_s=0.02, data_wait_s=0.0)
    prof.flush()
    (rec,) = prof.records()
    assert _sums_to_wall(rec)
    assert rec["terms"]["device_compute_s"] == 0.0 and rec["terms"]["comm_exposed_s"] == 0.0
    assert rec["overlap_ratio"] is None and rec["bandwidth"] is None
    assert prof.summary()["overlap_ratio_mean"] is None


def test_straggler_skew_capped_to_budget_fraction():
    port, ref = _pair(max_skew_fraction=0.5)
    for prof in (port, ref):
        prof.note_straggler(10.0)
        prof.on_step(0, wall_s=0.02, data_wait_s=0.0)
        prof.flush()
    assert port.records()[0]["terms"]["straggler_skew_s"] == pytest.approx(0.01)
    assert _strip(port.records()) == _strip(ref.records())


def test_lagged_one_step_behind():
    prof, _ = _pair()
    prof.on_step(0, wall_s=0.01, data_wait_s=0.0)
    assert prof.records() == []
    prof.on_step(1, wall_s=0.01, data_wait_s=0.0)
    assert [r["step"] for r in prof.records()] == [0]
    prof.flush()
    prof.flush()
    assert [r["step"] for r in prof.records()] == [0, 1]


def test_reset_keeps_pricing_drops_records():
    port, ref = _pair()
    for prof in (port, ref):
        prof.note_plan(PLAN)
        prof.on_step(0, wall_s=0.02, data_wait_s=0.0)
        prof.flush()
        prof.reset()
        assert prof.records() == [] and prof.summary()["steps"] == 0
        prof.on_step(1, wall_s=0.02, data_wait_s=0.0)
        prof.flush()
    assert port.records()[0]["comm_axes_s"]
    assert _strip(port.records()) == _strip(ref.records())


def test_ring_eviction_keeps_newest():
    port, ref = _pair(ring_size=4)
    for prof in (port, ref):
        for i in range(10):
            prof.on_step(i, wall_s=0.01, data_wait_s=0.0)
        prof.flush()
    assert [r["step"] for r in port.records()] == [6, 7, 8, 9]
    assert port.summary() == ref.summary()
    assert port.summary()["ring"] == {"capacity": 4, "len": 4}


def test_capture_cost_counts_once_and_prices_compute():
    """The FLOP count of the first block, then the compute term priced at
    the plan's rate, as the JAX package prices its cost_analysis()."""
    import torch

    prof = DeviceTimeProfiler(ProfilerConfig())
    a, b = torch.ones(8, 16), torch.ones(16, 4)
    with prof.capture_cost():
        a @ b
    with prof.capture_cost():  # counted once
        a @ b @ torch.ones(4, 4)
    assert prof._cost == {"flops": 2.0 * 8 * 16 * 4, "bytes_accessed": None}
    assert prof.summary()["cost_captured"] is True
    prof.note_plan(PLAN)
    prof.on_step(1, wall_s=0.5, data_wait_s=0.0)
    prof.flush()
    expected = 1024 / (PLAN["bandwidths"]["flops_per_chip"] * PLAN["bandwidths"]["mfu"])
    assert prof.records()[0]["terms"]["device_compute_s"] == round(expected, 9)
    off = DeviceTimeProfiler(ProfilerConfig(capture_cost=False))
    with off.capture_cost():
        a @ b
    assert off._cost is None


# ---------------------------------------------------------------------------
# Flight recorder and the exit-code table
# ---------------------------------------------------------------------------


def test_exit_code_table_is_the_jax_packages():
    assert EXIT_CODE_TABLE == jax_constants.EXIT_CODE_TABLE
    assert constants.FLIGHT_RECORD_PATTERN == jax_constants.FLIGHT_RECORD_PATTERN
    assert FLIGHT_DIR_ENV == jax_constants.FLIGHT_DIR_ENV
    for row in EXIT_CODE_TABLE:
        assert exit_class_name(row["code"]) == jax_profiler.exit_class_name(row["code"])
        assert exit_class_name(row["code"]) == row["classification"]
    assert exit_class_name(1) == "1"


@pytest.mark.parametrize("code", [row["code"] for row in EXIT_CODE_TABLE])
def test_flight_dump_one_class_per_exit_code(tmp_path, monkeypatch, code):
    monkeypatch.delenv(FLIGHT_DIR_ENV, raising=False)
    paths = []
    for mod, sub in ((profiler, "port"), (jax_profiler, "jax")):
        prof = mod.DeviceTimeProfiler(mod.ProfilerConfig(capture_cost=False),
                                      out_dir=str(tmp_path / sub))
        prof.on_step(7, wall_s=0.01, data_wait_s=0.0)
        prof.note_gauge("hbm_peak_bytes", 42)
        paths.append(mod.dump_flight(prof, code, reason="test"))
    klass = exit_class_name(code)
    assert [os.path.basename(p) for p in paths] == [f"flight_{klass}.json"] * 2
    docs = [json.load(open(p)) for p in paths]
    for doc in docs:
        assert doc["exit_class"] == klass and doc["reason"] == "test"
        assert doc["gauges"]["hbm_peak_bytes"] == 42
        assert doc["entries"][-1]["step"] == 7  # the lagged record was flushed
    assert sorted(docs[0]) == sorted(docs[1])


def test_flight_dir_env_overrides_out_dir(tmp_path, monkeypatch):
    env_dir = tmp_path / "supervisor"
    monkeypatch.setenv(FLIGHT_DIR_ENV, str(env_dir))
    fr = FlightRecorder(out_dir=str(tmp_path / "out"))
    fr.record("step", step=1)
    path = fr.dump("oom")
    assert path == str(env_dir / "flight_oom.json")
    assert find_flight_bundles()[0] == os.path.abspath(path)


def test_dump_flight_respects_flight_off():
    prof = DeviceTimeProfiler(ProfilerConfig(capture_cost=False, flight=False))
    prof.on_step(0, wall_s=0.01, data_wait_s=0.0)
    assert dump_flight(prof, SERVING_CRASH_EXIT_CODE) is None
    assert dump_flight(None, SDC_EXIT_CODE) is None


# ---------------------------------------------------------------------------
# MetricsHub
# ---------------------------------------------------------------------------


def _instrumented(mod):
    hub = mod.MetricsHub()
    hub.counter("serving_requests_total").inc(3)
    hub.gauge("serving_queue_depth").set(2.5)
    h = hub.histogram("serving_ttft_s", window=8)
    for v in np.random.default_rng(4).uniform(0, 1, 20):
        h.observe(float(v))
    hub.register_provider("telemetry", lambda: {
        "steps": 4, "peak_hbm_bytes": 1 << 20, "dir": "/x", "nested": {"ok": True, "n": None},
        "ratio": float("nan")})
    hub.register_text(lambda: ['accelerate_tpu_spans_total{kind="tick"} 7'])
    hub.register_slo("serving_availability", 0.9, window=100)
    for ok in [True] * 18 + [False] * 3:
        hub.observe_slo("serving_availability", ok)
    hub.alias("accelerate_tpu_trace_steps", "accelerate_tpu_telemetry_steps")
    return hub


def test_hub_render_equals_jax():
    port, ref = _instrumented(profiler), _instrumented(jax_profiler)
    assert port.render() == ref.render()
    assert port.metric_names() == ref.metric_names()
    assert port.burn_rates() == ref.burn_rates()
    assert port.burn_rates()["serving_availability"]["alert"] is True


def test_hub_collisions_and_malformed_names():
    hub = MetricsHub()
    hub.counter("serving_requests_total")
    with pytest.raises(ValueError, match="cross-kind"):
        hub.gauge("serving_requests_total")
    for bad in ("Caps", "1leading", "dash-ed", ""):
        with pytest.raises(ValueError):
            hub.counter(bad)
    a, b = (lambda: {"x": 1}), (lambda: {"x": 2})
    hub.register_provider("sub", a)
    hub.register_provider("sub", a)
    with pytest.raises(ValueError, match="replace=True"):
        hub.register_provider("sub", b)
    hub.register_provider("sub", b, replace=True)
    assert "accelerate_tpu_sub_x 2" in hub.render()
    with pytest.raises(ValueError):
        hub.register_slo("bad", 1.5)


def test_profiler_summary_renders_under_profile_subsystem():
    port, ref = _pair()
    hubs = []
    for prof, mod in ((port, profiler), (ref, jax_profiler)):
        hub = mod.MetricsHub()
        hub.register_provider("profile", prof.summary)
        prof.on_step(0, wall_s=0.01, data_wait_s=0.0)
        prof.flush()
        hubs.append(hub)
    assert hubs[0].render() == hubs[1].render()
    assert "accelerate_tpu_profile_steps" in hubs[0].metric_names()


def test_names_are_the_jax_packages():
    assert (COMM_AXES, STEP_TERMS, TICK_TERMS) == (
        jax_profiler.COMM_AXES, jax_profiler.STEP_TERMS, jax_profiler.TICK_TERMS)
    import dataclasses

    port = [(f.name, f.default) for f in dataclasses.fields(ProfilerConfig)]
    ref = [(f.name, f.default) for f in dataclasses.fields(jax_profiler.ProfilerConfig)]
    assert port == ref
    for value in (True, {"ring_size": 8}, ProfilerConfig(flight=False)):
        assert ProfilerConfig.from_value(value).enabled
    assert ProfilerConfig.from_value(False) is None
    assert ProfilerConfig.from_value({"enabled": False}) is None
    with pytest.raises(TypeError):
        ProfilerConfig.from_value("yes")
