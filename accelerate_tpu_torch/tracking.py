"""Experiment trackers: the port of ``accelerate_tpu/tracking.py``.

An abstract :class:`GeneralTracker`, a registry by name
(``LOGGER_TYPE_TO_CLASS``), availability probes (``utils/imports.py``) and
main-process gating, with the JAX package's classes, names and record
formats: ``Accelerator(log_with=...)`` resolves the names through
:func:`filter_trackers` (an unknown or missing package is dropped with a
warning), ``init_trackers`` builds them (:func:`resolve_trackers`) and
``log`` forwards to each. :class:`JSONTracker` needs no package; the
others import theirs when they are built, :class:`TensorBoardTracker`
``torch.utils.tensorboard`` (which needs the ``tensorboard`` package, and
pulls in TensorFlow where that is installed) or ``tensorboardX``.
"""

from __future__ import annotations

import json
import os
import time
from functools import wraps
from typing import Optional

from .logging import get_logger
from .state import PartialState
from .utils.imports import (
    is_aim_available,
    is_clearml_available,
    is_comet_ml_available,
    is_dvclive_available,
    is_mlflow_available,
    is_swanlab_available,
    is_tensorboard_available,
    is_trackio_available,
    is_wandb_available,
)

logger = get_logger(__name__)


def on_main_process(function):
    """Run a tracker method only on the main process."""

    @wraps(function)
    def execute_on_main_process(self, *args, **kwargs):
        if getattr(self, "main_process_only", True) and not PartialState().is_main_process:
            return None
        return function(self, *args, **kwargs)

    return execute_on_main_process


class GeneralTracker:
    """Abstract tracker. Subclasses set
    ``name``, ``requires_logging_directory`` and implement ``tracker``,
    ``store_init_configuration`` and ``log``."""

    main_process_only = True
    name: str = "general"
    requires_logging_directory: bool = False

    def __init__(self, _blank: bool = False):
        self._started = not _blank

    @property
    def tracker(self):
        raise NotImplementedError

    def start(self):
        pass

    def store_init_configuration(self, values: dict):
        raise NotImplementedError

    def log(self, values: dict, step: Optional[int] = None, **kwargs):
        raise NotImplementedError

    def log_images(self, values: dict, step: Optional[int] = None, **kwargs):
        pass

    def finish(self):
        pass


class JSONTracker(GeneralTracker):
    """Dependency-free tracker: one JSONL file of metric records
    (``<logging_dir>/<run_name>.metrics.jsonl``), always available."""

    name = "json"
    requires_logging_directory = True

    @on_main_process
    def __init__(self, run_name: str, logging_dir: str = ".", **kwargs):
        super().__init__()
        self.run_name = run_name
        os.makedirs(logging_dir, exist_ok=True)
        self.path = os.path.join(logging_dir, f"{run_name}.metrics.jsonl")
        # Line-buffered + per-record flush: a crashed or preempted run keeps
        # every record already appended.
        self._fh = open(self.path, "a", buffering=1)

    @property
    def tracker(self):
        return self._fh

    @on_main_process
    def store_init_configuration(self, values: dict):
        self._write({"event": "config", "values": _jsonable(values)})

    @on_main_process
    def log(self, values: dict, step: Optional[int] = None, **kwargs):
        self._write({"event": "log", "step": step, "time": time.time(), "values": _jsonable(values)})

    def _write(self, record: dict):
        self._fh.write(json.dumps(record) + "\n")
        self._fh.flush()

    @on_main_process
    def finish(self):
        self._fh.close()


class TensorBoardTracker(GeneralTracker):
    """TensorBoard event files under ``<logging_dir>/<run_name>``."""

    name = "tensorboard"
    requires_logging_directory = True

    @on_main_process
    def __init__(self, run_name: str, logging_dir: str, **kwargs):
        super().__init__()
        try:
            from torch.utils import tensorboard
        except ImportError:
            import tensorboardX as tensorboard
        self.run_name = run_name
        self.logging_dir = os.path.join(logging_dir, run_name)
        self.writer = tensorboard.SummaryWriter(self.logging_dir, **kwargs)

    @property
    def tracker(self):
        return self.writer

    @on_main_process
    def store_init_configuration(self, values: dict):
        self.writer.add_hparams(_flatten_for_hparams(values), metric_dict={})
        self.writer.flush()

    @on_main_process
    def log(self, values: dict, step: Optional[int] = None, **kwargs):
        for k, v in values.items():
            if isinstance(v, (int, float)) or hasattr(v, "item"):
                self.writer.add_scalar(k, float(v), global_step=step, **kwargs)
            elif isinstance(v, str):
                self.writer.add_text(k, v, global_step=step, **kwargs)
            elif isinstance(v, dict):
                self.writer.add_scalars(k, {kk: float(vv) for kk, vv in v.items()}, global_step=step)
        self.writer.flush()

    @on_main_process
    def finish(self):
        self.writer.close()


class WandBTracker(GeneralTracker):
    """Weights & Biases (``wandb``)."""

    name = "wandb"
    requires_logging_directory = False
    main_process_only = True

    @on_main_process
    def __init__(self, run_name: str, **kwargs):
        super().__init__()
        import wandb

        self.run = wandb.init(project=run_name, **kwargs)

    @property
    def tracker(self):
        return self.run

    @on_main_process
    def store_init_configuration(self, values: dict):
        import wandb

        wandb.config.update(values, allow_val_change=True)

    @on_main_process
    def log(self, values: dict, step: Optional[int] = None, **kwargs):
        self.run.log(values, step=step, **kwargs)

    @on_main_process
    def finish(self):
        self.run.finish()


class MLflowTracker(GeneralTracker):
    """MLflow: parameters and numeric metrics."""

    name = "mlflow"
    requires_logging_directory = False

    @on_main_process
    def __init__(self, run_name: str, logging_dir: Optional[str] = None, **kwargs):
        super().__init__()
        import mlflow

        self.active_run = mlflow.start_run(run_name=run_name, **kwargs)

    @property
    def tracker(self):
        return self.active_run

    @on_main_process
    def store_init_configuration(self, values: dict):
        import mlflow

        for name, value in values.items():
            mlflow.log_param(name, value)

    @on_main_process
    def log(self, values: dict, step: Optional[int] = None, **kwargs):
        import mlflow

        metrics = {k: float(v) for k, v in values.items() if isinstance(v, (int, float)) or hasattr(v, "item")}
        mlflow.log_metrics(metrics, step=step)

    @on_main_process
    def finish(self):
        import mlflow

        mlflow.end_run()


class TrackioTracker(GeneralTracker):
    """Trackio."""

    name = "trackio"
    requires_logging_directory = False
    main_process_only = True

    @on_main_process
    def __init__(self, run_name: str, **kwargs):
        super().__init__()
        import trackio

        self.run = trackio.init(project=run_name, **kwargs)

    @property
    def tracker(self):
        return self.run

    @on_main_process
    def store_init_configuration(self, values: dict):
        import trackio

        trackio.config.update(_jsonable(values))

    @on_main_process
    def log(self, values: dict, step: Optional[int] = None, **kwargs):
        self.run.log(values, step=step, **kwargs)

    @on_main_process
    def finish(self):
        import trackio

        trackio.finish()


class CometMLTracker(GeneralTracker):
    """Comet (``comet_ml``)."""

    name = "comet_ml"
    requires_logging_directory = False
    main_process_only = True

    @on_main_process
    def __init__(self, run_name: str, **kwargs):
        super().__init__()
        import comet_ml

        self.experiment = comet_ml.start(project_name=run_name, **kwargs)

    @property
    def tracker(self):
        return self.experiment

    @on_main_process
    def store_init_configuration(self, values: dict):
        self.experiment.log_parameters(values)

    @on_main_process
    def log(self, values: dict, step: Optional[int] = None, **kwargs):
        if step is not None:
            self.experiment.set_step(step)
        for k, v in values.items():
            if isinstance(v, str):
                self.experiment.log_other(k, v)
            elif isinstance(v, dict):
                self.experiment.log_metrics(v, step=step, **kwargs)
            else:
                self.experiment.log_metric(k, v, step=step, **kwargs)

    @on_main_process
    def finish(self):
        self.experiment.end()


class AimTracker(GeneralTracker):
    """Aim: a ``Run`` in the ``logging_dir`` repository."""

    name = "aim"
    requires_logging_directory = True
    main_process_only = True

    @on_main_process
    def __init__(self, run_name: str, logging_dir: Optional[str] = None, **kwargs):
        super().__init__()
        from aim import Run

        self.writer = Run(repo=logging_dir, **kwargs)
        self.writer.name = run_name

    @property
    def tracker(self):
        return self.writer

    @on_main_process
    def store_init_configuration(self, values: dict):
        self.writer["hparams"] = _jsonable(values)

    @on_main_process
    def log(self, values: dict, step: Optional[int] = None, **kwargs):
        for k, v in values.items():
            self.writer.track(v, name=k, step=step, **kwargs)

    @on_main_process
    def finish(self):
        self.writer.close()


class ClearMLTracker(GeneralTracker):
    """ClearML: a task's scalars; a task that already exists is used and
    left open."""

    name = "clearml"
    requires_logging_directory = False
    main_process_only = True

    @on_main_process
    def __init__(self, run_name: str, **kwargs):
        super().__init__()
        from clearml import Task

        existing = Task.current_task()  # capture BEFORE init creates one
        self.task = existing or Task.init(project_name=run_name, **kwargs)
        self._initialized_externally = existing is not None

    @property
    def tracker(self):
        return self.task

    @on_main_process
    def store_init_configuration(self, values: dict):
        self.task.connect_configuration(_jsonable(values))

    @on_main_process
    def log(self, values: dict, step: Optional[int] = None, **kwargs):
        logger_ = self.task.get_logger()
        for k, v in values.items():
            if isinstance(v, (int, float)) or hasattr(v, "item"):
                if step is None:
                    logger_.report_single_value(name=k, value=float(v))
                else:
                    # "title/series" keys split into ClearML's title and series.
                    title, _, series = k.partition("/")
                    logger_.report_scalar(
                        title=title, series=series or title, value=float(v),
                        iteration=step, **kwargs,
                    )
            else:
                logger.warning(
                    f"ClearMLTracker.log dropped non-scalar value {k!r} "
                    f"({type(v).__name__}) — only int/float metrics are reported."
                )

    @on_main_process
    def finish(self):
        if not self._initialized_externally:
            self.task.close()


class DVCLiveTracker(GeneralTracker):
    """DVCLive: numbers as metrics, the rest as parameters."""

    name = "dvclive"
    requires_logging_directory = False
    main_process_only = True

    @on_main_process
    def __init__(self, run_name: Optional[str] = None, live=None, **kwargs):
        super().__init__()
        from dvclive import Live

        self.live = live if live is not None else Live(**kwargs)

    @property
    def tracker(self):
        return self.live

    @on_main_process
    def store_init_configuration(self, values: dict):
        self.live.log_params(_jsonable(values))

    @on_main_process
    def log(self, values: dict, step: Optional[int] = None, **kwargs):
        if step is not None:
            self.live.step = step
        for k, v in values.items():
            if isinstance(v, (int, float)) or hasattr(v, "item"):
                self.live.log_metric(k, float(v), **kwargs)
            else:  # strings etc. ride as params
                self.live.log_param(k, v)
        self.live.next_step()

    @on_main_process
    def finish(self):
        self.live.end()


class SwanLabTracker(GeneralTracker):
    """SwanLab."""

    name = "swanlab"
    requires_logging_directory = False
    main_process_only = True

    @on_main_process
    def __init__(self, run_name: str, **kwargs):
        super().__init__()
        import swanlab

        self.run = swanlab.init(project=run_name, **kwargs)

    @property
    def tracker(self):
        return self.run

    @on_main_process
    def store_init_configuration(self, values: dict):
        import swanlab

        swanlab.config.update(_jsonable(values))

    @on_main_process
    def log(self, values: dict, step: Optional[int] = None, **kwargs):
        self.run.log(values, step=step, **kwargs)

    @on_main_process
    def finish(self):
        import swanlab

        swanlab.finish()


LOGGER_TYPE_TO_CLASS = {
    "json": JSONTracker,
    "tensorboard": TensorBoardTracker,
    "wandb": WandBTracker,
    "mlflow": MLflowTracker,
    "trackio": TrackioTracker,
    "comet_ml": CometMLTracker,
    "aim": AimTracker,
    "clearml": ClearMLTracker,
    "dvclive": DVCLiveTracker,
    "swanlab": SwanLabTracker,
}

_AVAILABILITY = {
    "json": lambda: True,
    "tensorboard": is_tensorboard_available,
    "wandb": is_wandb_available,
    "mlflow": is_mlflow_available,
    "comet_ml": is_comet_ml_available,
    "aim": is_aim_available,
    "clearml": is_clearml_available,
    "dvclive": is_dvclive_available,
    "swanlab": is_swanlab_available,
    "trackio": is_trackio_available,
}


def get_available_trackers() -> list[str]:
    return [name for name, probe in _AVAILABILITY.items() if name in LOGGER_TYPE_TO_CLASS and probe()]


def filter_trackers(log_with, logging_dir: Optional[str] = None) -> list:
    """Resolve the user's ``log_with`` request against the available
    integrations: ``"all"`` selects everything available; unknown or
    unavailable names warn and drop."""
    if log_with is None:
        return []
    if not isinstance(log_with, (list, tuple)):
        log_with = [log_with]
    loggers = []
    if "all" in [str(l) for l in log_with]:
        return get_available_trackers()
    for log_type in log_with:
        if isinstance(log_type, GeneralTracker):
            loggers.append(log_type)
            continue
        name = str(log_type)
        if name not in LOGGER_TYPE_TO_CLASS:
            logger.warning(f"Tried adding logger {name}, but no tracker with that name exists here.")
            continue
        if not _AVAILABILITY[name]():
            logger.warning(f"Tried adding logger {name}, but that package is not installed.")
            continue
        if LOGGER_TYPE_TO_CLASS[name].requires_logging_directory and logging_dir is None:
            raise ValueError(f"Logging with `{name}` requires a `logging_dir` to be passed in.")
        loggers.append(name)
    return loggers


def resolve_trackers(log_with: list, project_name: str, logging_dir: Optional[str], init_kwargs: dict) -> list:
    trackers = []
    for entry in log_with or []:
        if isinstance(entry, GeneralTracker):
            trackers.append(entry)
            continue
        cls = LOGGER_TYPE_TO_CLASS[entry]
        kwargs = init_kwargs.get(entry, {})
        if cls.requires_logging_directory:
            trackers.append(cls(project_name, logging_dir or ".", **kwargs))
        else:
            trackers.append(cls(project_name, **kwargs))
    return trackers


def _jsonable(values):
    def conv(v):
        if hasattr(v, "item"):
            try:
                return v.item()
            except Exception:
                return str(v)
        if isinstance(v, dict):
            return {k: conv(x) for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            return [conv(x) for x in v]
        if isinstance(v, (int, float, str, bool)) or v is None:
            return v
        return str(v)

    return conv(values)


def _flatten_for_hparams(values: dict) -> dict:
    out = {}
    for k, v in values.items():
        if isinstance(v, (int, float, str, bool)):
            out[k] = v
        else:
            out[k] = str(v)
    return out
