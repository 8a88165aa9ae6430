"""The port's trackers (accelerate_tpu_torch/tracking.py), its
``Accelerator`` tracker surface and ``Accelerator.profile``
(utils/profiling.py) against the JAX package's, as tests/test_tracking.py
and the profile-schedule tests of tests/test_telemetry.py drive those.

The guarded trackers are driven through mock SDK modules (none of those
packages is installed), the same calls in both packages, and must make the
same SDK calls. The JSON tracker's files must be equal apart from the time
fields; TensorBoard's scalars are read back with tensorboard's
``EventAccumulator``. The profile session traces each window with
``torch.profiler`` on the CPU; the steps inside each ``trace.json`` must be
the steps the JAX session's start/stop bracket, for every schedule of
those tests.
"""

import json
import logging
import os
import sys
import types
from unittest import mock

import numpy as np
import pytest
import torch

from accelerate_tpu import PartialState as JaxPartialState
from accelerate_tpu import tracking as jax_tracking
from accelerate_tpu.utils import ProfileKwargs as JaxProfileKwargs
from accelerate_tpu.utils import ProjectConfiguration as JaxProjectConfiguration
from accelerate_tpu_torch import Accelerator, tracking
from accelerate_tpu_torch.state import AcceleratorState, GradientState, PartialState
from accelerate_tpu_torch.utils import ProfileKwargs, ProjectConfiguration
from accelerate_tpu_torch.utils import imports
from accelerate_tpu_torch.utils.profiling import TRACE_FILE, ProfileSession


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the driver runs several test processes at once,
    and torch's spinning thread pools would contend for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def states():
    PartialState(cpu=True)
    JaxPartialState()
    yield
    for cls in (AcceleratorState, GradientState, PartialState):
        cls._reset_state()


def _mock_module(name, **attrs):
    m = types.ModuleType(name)
    for k, v in attrs.items():
        setattr(m, k, v)
    return m


# ---------------------------------------------------------------------------
# Registry and probes
# ---------------------------------------------------------------------------


def test_registry_matches_jax():
    port, ref = tracking.LOGGER_TYPE_TO_CLASS, jax_tracking.LOGGER_TYPE_TO_CLASS
    assert list(port) == list(ref)
    for name in port:
        assert port[name].__name__ == ref[name].__name__
        assert port[name].name == ref[name].name == name
        assert port[name].requires_logging_directory == ref[name].requires_logging_directory
    assert set(port) <= set(tracking._AVAILABILITY)


def test_availability_probes_match_jax():
    from accelerate_tpu.utils import imports as jax_imports

    for name, probe in tracking._AVAILABILITY.items():
        assert probe() == jax_tracking._AVAILABILITY[name](), name
    assert tracking.get_available_trackers() == jax_tracking.get_available_trackers()
    for fn in dir(imports):
        if fn.startswith("is_"):
            assert getattr(imports, fn)() == getattr(jax_imports, fn)(), fn


# ---------------------------------------------------------------------------
# The guarded trackers, through mocks: the same SDK calls in both packages
# ---------------------------------------------------------------------------


def _drive_trackio(mod, tmp_path):
    run = mock.MagicMock()
    sdk = _mock_module("trackio", init=mock.MagicMock(return_value=run),
                       config=mock.MagicMock(), finish=mock.MagicMock())
    with mock.patch.dict(sys.modules, {"trackio": sdk}):
        t = mod.TrackioTracker("proj")
        t.store_init_configuration({"lr": 0.1})
        t.log({"loss": 1.0}, step=3)
        t.finish()
    return [sdk.init.mock_calls, run.mock_calls, sdk.config.mock_calls, sdk.finish.mock_calls]


def _drive_wandb(mod, tmp_path):
    run = mock.MagicMock()
    sdk = _mock_module("wandb", init=mock.MagicMock(return_value=run), config=mock.MagicMock())
    with mock.patch.dict(sys.modules, {"wandb": sdk}):
        t = mod.WandBTracker("proj", entity="team")
        t.store_init_configuration({"lr": 0.1})
        t.log({"loss": 1.0}, step=3)
        t.finish()
    return [sdk.init.mock_calls, run.mock_calls, sdk.config.mock_calls]


def _drive_mlflow(mod, tmp_path):
    sdk = _mock_module("mlflow", start_run=mock.MagicMock(), log_param=mock.MagicMock(),
                       log_metrics=mock.MagicMock(), end_run=mock.MagicMock())
    with mock.patch.dict(sys.modules, {"mlflow": sdk}):
        t = mod.MLflowTracker("run")
        t.store_init_configuration({"lr": 0.1, "bs": 4})
        t.log({"loss": 2.0, "acc": np.float32(0.5), "note": "x"}, step=4)
        t.finish()
    return [getattr(sdk, n).mock_calls for n in ("start_run", "log_param", "log_metrics",
                                                   "end_run")]


def _drive_comet_ml(mod, tmp_path):
    exp = mock.MagicMock()
    sdk = _mock_module("comet_ml", start=mock.MagicMock(return_value=exp))
    with mock.patch.dict(sys.modules, {"comet_ml": sdk}):
        t = mod.CometMLTracker("proj")
        t.store_init_configuration({"lr": 0.1})
        t.log({"loss": 2.0, "note": "hi", "nested": {"a": 1.0}}, step=5)
        t.finish()
    return [sdk.start.mock_calls, exp.mock_calls]


def _drive_aim(mod, tmp_path):
    run = mock.MagicMock()
    sdk = _mock_module("aim", Run=mock.MagicMock(return_value=run))
    with mock.patch.dict(sys.modules, {"aim": sdk}):
        t = mod.AimTracker("run1", logging_dir=str(tmp_path))
        t.store_init_configuration({"lr": 0.1})
        t.log({"loss": 1.5}, step=2)
        t.finish()
    return [sdk.Run.mock_calls, run.mock_calls, run.name]


def _drive_clearml(mod, tmp_path):
    task = mock.MagicMock()
    task_cls = mock.MagicMock()
    task_cls.current_task.return_value = None
    task_cls.init.return_value = task
    sdk = _mock_module("clearml", Task=task_cls)
    with mock.patch.dict(sys.modules, {"clearml": sdk}):
        t = mod.ClearMLTracker("proj")
        t.store_init_configuration({"lr": 0.1})
        t.log({"train/loss": 0.5, "acc": 0.9}, step=7)
        t.log({"final": 0.1})
        t.finish()
    return [task_cls.mock_calls, task.mock_calls]


def _drive_clearml_external(mod, tmp_path):
    task = mock.MagicMock()
    task_cls = mock.MagicMock()
    task_cls.current_task.return_value = task  # a task that already exists
    sdk = _mock_module("clearml", Task=task_cls)
    with mock.patch.dict(sys.modules, {"clearml": sdk}):
        t = mod.ClearMLTracker("proj")
        t.finish()
    task_cls.init.assert_not_called()
    task.close.assert_not_called()
    return [task_cls.mock_calls, task.mock_calls]


def _drive_dvclive(mod, tmp_path):
    live = mock.MagicMock()
    sdk = _mock_module("dvclive", Live=mock.MagicMock(return_value=live))
    with mock.patch.dict(sys.modules, {"dvclive": sdk}):
        t = mod.DVCLiveTracker("run")
        t.store_init_configuration({"lr": 0.1})
        t.log({"loss": 0.25, "stage": "eval"}, step=4)
        t.finish()
    return [sdk.Live.mock_calls, live.mock_calls, live.step]


def _drive_swanlab(mod, tmp_path):
    run = mock.MagicMock()
    sdk = _mock_module("swanlab", init=mock.MagicMock(return_value=run),
                       config=mock.MagicMock(), finish=mock.MagicMock())
    with mock.patch.dict(sys.modules, {"swanlab": sdk}):
        t = mod.SwanLabTracker("proj")
        t.store_init_configuration({"lr": 0.1})
        t.log({"loss": 0.1}, step=1)
        t.finish()
    return [sdk.init.mock_calls, run.mock_calls, sdk.config.mock_calls, sdk.finish.mock_calls]


_SDK_RUNS = {"trackio": _drive_trackio, "wandb": _drive_wandb, "mlflow": _drive_mlflow,
            "comet_ml": _drive_comet_ml, "aim": _drive_aim, "clearml": _drive_clearml,
            "clearml_external_task": _drive_clearml_external, "dvclive": _drive_dvclive,
            "swanlab": _drive_swanlab}


@pytest.mark.parametrize("name", sorted(_SDK_RUNS))
def test_guarded_tracker_makes_the_jax_packages_calls(tmp_path, name):
    port = _SDK_RUNS[name](tracking, tmp_path)
    ref = _SDK_RUNS[name](jax_tracking, tmp_path)
    assert port == ref
    assert any(port)


def test_a_guarded_tracker_imports_its_package_when_built():
    with mock.patch.dict(sys.modules, {"wandb": None}):
        with pytest.raises(ImportError):
            tracking.WandBTracker("proj")


def test_clearml_warns_on_non_scalar(caplog):
    task = mock.MagicMock()
    task_cls = mock.MagicMock()
    task_cls.current_task.return_value = None
    task_cls.init.return_value = task
    with mock.patch.dict(sys.modules, {"clearml": _mock_module("clearml", Task=task_cls)}):
        t = tracking.ClearMLTracker("proj")
        with caplog.at_level(logging.WARNING):
            t.log({"stage": "eval", "loss": 0.5}, step=1)
    assert any("stage" in r.getMessage() for r in caplog.records)


# ---------------------------------------------------------------------------
# filter_trackers and the Accelerator's tracker surface
# ---------------------------------------------------------------------------


def _warnings(caplog, fn):
    caplog.clear()
    with caplog.at_level(logging.WARNING):
        out = fn()
    return out, [r.getMessage() for r in caplog.records]


@pytest.mark.parametrize("log_with", [["json", "comet_ml", "nope"], "all", "json", None,
                                      ["tensorboard", "wandb"]])
def test_filter_trackers_matches_jax(caplog, tmp_path, log_with):
    port, port_warn = _warnings(caplog, lambda: tracking.filter_trackers(log_with, str(tmp_path)))
    ref, ref_warn = _warnings(caplog, lambda: jax_tracking.filter_trackers(log_with,
                                                                           str(tmp_path)))
    assert port == ref and port_warn == ref_warn


def test_filter_trackers_drops_a_missing_tensorboard_with_the_jax_warning(caplog, tmp_path):
    """The card's machine has no tensorboard: the name drops with a warning."""
    with mock.patch.object(tracking, "_AVAILABILITY", {**tracking._AVAILABILITY,
                                                       "tensorboard": lambda: False}), \
         mock.patch.object(jax_tracking, "_AVAILABILITY", {**jax_tracking._AVAILABILITY,
                                                           "tensorboard": lambda: False}):
        port, port_warn = _warnings(caplog, lambda: tracking.filter_trackers(
            ["json", "tensorboard"], str(tmp_path)))
        ref, ref_warn = _warnings(caplog, lambda: jax_tracking.filter_trackers(
            ["json", "tensorboard"], str(tmp_path)))
    assert port == ref == ["json"]
    assert port_warn == ref_warn == [
        "Tried adding logger tensorboard, but that package is not installed."]


def test_filter_trackers_needs_a_logging_dir():
    for mod in (tracking, jax_tracking):
        with pytest.raises(ValueError, match="requires a `logging_dir`"):
            mod.filter_trackers(["json"], None)


def test_logging_dir_defaults_to_project_dir_as_in_jax(tmp_path):
    for kw in (dict(project_dir=str(tmp_path)),
               dict(project_dir=str(tmp_path), logging_dir=str(tmp_path / "logs")), {}):
        port, ref = ProjectConfiguration(**kw), JaxProjectConfiguration(**kw)
        assert (port.project_dir, port.logging_dir) == (ref.project_dir, ref.logging_dir)
        port.set_directories(str(tmp_path / "other"))
        ref.set_directories(str(tmp_path / "other"))
        assert (port.project_dir, port.logging_dir) == (ref.project_dir, ref.logging_dir)
    acc = Accelerator(cpu=True, project_dir=str(tmp_path), log_with="json")
    assert acc.logging_dir == str(tmp_path) and acc.log_with == ["json"]


def _json_lines(path):
    with open(path) as f:
        return [{k: v for k, v in json.loads(line).items() if k != "time"} for line in f]


def _tracker_run(acc_cls, tmp_path, **kw):
    acc = acc_cls(project_dir=str(tmp_path), log_with=["json"], **kw)
    acc.init_trackers("run", config={"lr": 0.1, "layers": [2, 4], "tensor": torch.tensor(3)})
    acc.log({"loss": 1.5, "t": np.float32(0.25)}, step=1)
    acc.log({"loss": torch.tensor(0.5), "stage": "eval"}, step=2)
    tracker = acc.get_tracker("json")
    fh = acc.get_tracker("json", unwrap=True)
    with pytest.raises(ValueError, match="not an available tracker"):
        acc.get_tracker("wandb")
    acc.end_training()
    assert fh.closed and tracker.path == str(tmp_path / "run.metrics.jsonl")
    return _json_lines(tracker.path)


def test_accelerator_json_tracker_files_equal_jax(tmp_path):
    from accelerate_tpu import Accelerator as JaxAccelerator

    port = _tracker_run(Accelerator, tmp_path / "port", cpu=True)
    ref = _tracker_run(JaxAccelerator, tmp_path / "jax")
    assert port == ref
    assert [r["event"] for r in port] == ["config", "log", "log"]


def test_json_tracker_flushes_each_record(tmp_path):
    t = tracking.JSONTracker("run", logging_dir=str(tmp_path))
    t.store_init_configuration({"lr": 0.1})
    t.log({"loss": 1.0}, step=1)
    assert [r["event"] for r in _json_lines(t.path)] == ["config", "log"]  # before finish()
    t.finish()


def test_tensorboard_scalars_read_back(tmp_path):
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    acc = Accelerator(cpu=True, project_dir=str(tmp_path), log_with="tensorboard")
    acc.init_trackers("tb_run", config={"lr": 0.1, "opt": "adamw"})
    losses = [2.5, 2.25, 1.75]
    for i, loss in enumerate(losses):
        acc.log({"loss": loss, "lr": torch.tensor(0.1 * i), "note": "x"}, step=i)
    writer = acc.get_tracker("tensorboard", unwrap=True)
    acc.end_training()
    ea = EventAccumulator(writer.log_dir)
    ea.Reload()
    assert [(e.step, e.value) for e in ea.Scalars("loss")] == list(enumerate(losses))
    assert [round(e.value, 6) for e in ea.Scalars("lr")] == [0.0, 0.1, 0.2]
    assert writer.log_dir == str(tmp_path / "tb_run")


def test_log_runs_on_the_main_process_only(tmp_path):
    acc = Accelerator(cpu=True, project_dir=str(tmp_path))
    sink = mock.MagicMock(name="sink")
    acc.trackers = [sink]
    with mock.patch.object(type(acc), "is_main_process", property(lambda self: False)):
        acc.log({"loss": 1.0}, step=1)
    sink.log.assert_not_called()
    acc.log({"loss": 1.0}, step=1, log_kwargs={sink.name: {"commit": True}})
    sink.log.assert_called_once_with({"loss": 1.0}, step=1, commit=True)


# ---------------------------------------------------------------------------
# Accelerator.profile: the JAX session's windows, traced by torch.profiler
# ---------------------------------------------------------------------------

# The schedules of the JAX package's profile tests, with their step counts.
SCHEDULES = {
    "skip_first": ({"skip_first": 3, "wait": 1, "warmup": 1, "active": 2, "repeat": 1}, 11),
    "repeat_limit": ({"wait": 0, "warmup": 1, "active": 1, "repeat": 2}, 20),
    "skip_first_zero_wait": ({"skip_first": 2, "active": 2, "repeat": 1}, 7),
    "window_covers_active_steps": ({"wait": 1, "warmup": 1, "active": 2, "repeat": 2}, 10),
    "active_one": ({"wait": 1, "warmup": 1, "active": 1, "repeat": 2}, 8),
    "unlimited_repeat": ({"wait": 2, "warmup": 0, "active": 1}, 9),
    "first_window_at_enter": ({"active": 3, "repeat": 1}, 5),
}


def _jax_windows(tmp_path, schedule, steps):
    """{window dir: steps inside it} of the JAX session, start/stop stubbed
    as tests/test_telemetry.py stubs them."""
    import accelerate_tpu.utils.profiling as P

    events = []
    handler = JaxProfileKwargs(schedule_option=schedule, output_trace_dir=str(tmp_path))
    with mock.patch.object(P.jax.profiler, "start_trace", lambda d: events.append(("start", d))), \
         mock.patch.object(P.jax.profiler, "stop_trace", lambda: events.append(("stop",))):
        s = P.ProfileSession(handler, str(tmp_path))
        s.enter()
        for i in range(1, steps + 1):
            events.append(("work", i))
            s.step()
        s.exit()
    windows, current = {}, None
    for e in events:
        if e[0] == "start":
            current = e[1]
            windows[current] = []
        elif e[0] == "stop":
            current = None
        elif current is not None:
            windows[current].append(e[1])
    return windows, s.trace_dirs, s.cycles_done


def _traced_steps(trace_dir):
    with open(os.path.join(trace_dir, TRACE_FILE)) as f:
        names = [e.get("name", "") for e in json.load(f)["traceEvents"]]
    return sorted(int(n.split("_")[1]) for n in names if n.startswith("work_"))


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_profile_windows_trace_the_jax_sessions_steps(tmp_path, name):
    schedule, steps = SCHEDULES[name]
    ready = []
    acc = Accelerator(cpu=True)
    handler = ProfileKwargs(schedule_option=schedule, output_trace_dir=str(tmp_path / "port"),
                            on_trace_ready=lambda sess: ready.append(sess.trace_dirs[-1]))
    x = torch.ones(8, 8)
    with acc.profile(handler) as prof:
        for i in range(1, steps + 1):
            with torch.profiler.record_function(f"work_{i}"):
                x = x @ torch.ones(8, 8) / 8
            prof.step()
    windows, jax_dirs, jax_cycles = _jax_windows(tmp_path / "jax", schedule, steps)
    rel = [os.path.relpath(d, tmp_path / "port") for d in prof.trace_dirs]
    assert rel == [os.path.relpath(d, tmp_path / "jax") for d in jax_dirs]
    assert ready == prof.trace_dirs and prof.cycles_done == jax_cycles
    for port_dir, jax_dir in zip(prof.trace_dirs, jax_dirs):
        assert _traced_steps(port_dir) == windows[jax_dir], port_dir


def test_profile_unscheduled_traces_the_whole_block(tmp_path):
    acc = Accelerator(cpu=True, project_dir=str(tmp_path))
    with acc.profile() as prof:
        with torch.profiler.record_function("work_1"):
            torch.ones(4, 4) * 2
    assert prof.trace_dirs == [str(tmp_path)]
    assert _traced_steps(str(tmp_path)) == [1]
    with Accelerator(cpu=True).profile() as none:  # no project dir, no output dir
        assert none is None


def test_profile_session_options(tmp_path):
    from torch.profiler import ProfilerActivity

    s = ProfileSession(ProfileKwargs(activities=["cpu"]), str(tmp_path))
    assert s.activities == [ProfilerActivity.CPU]
    s = ProfileSession(ProfileKwargs(), str(tmp_path), device="cuda")
    assert s.activities == [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with pytest.raises(ValueError, match="active"):
        ProfileSession(ProfileKwargs(schedule_option={"active": 0}), str(tmp_path))
    import dataclasses

    port = [(f.name, f.default) for f in dataclasses.fields(ProfileKwargs)]
    ref = [(f.name, f.default) for f in dataclasses.fields(JaxProfileKwargs)]
    assert port == ref
