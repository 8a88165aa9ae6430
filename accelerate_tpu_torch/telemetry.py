"""Step telemetry: the port of ``accelerate_tpu/telemetry.py``, with its
record schema (``STEP_RECORD_KEYS``) and file layout, so that one reader
parses both packages' files.

:class:`TelemetryRecorder` rides in the prepared train step, ``backward``,
the optimizer step, the prepared loaders, ``save_state``/``load_state`` and
the serving engine, and records:

- each step's wall time (the host's dispatch time by default; the device's
  with ``sync_timing=True``, which synchronises the card first), the time
  the loop waited for its loader, samples/s and tokens/s with EMAs, of
  the global batch as the JAX package counts it (a process's batch times
  the data-parallel processes, and its tokens also times the ``cp × sp``
  processes that split the sequence; no collective);
- a **recompile watchdog**. The JAX package reads the jitted step's
  executable-cache size; the port's step runs eagerly and has no such
  cache. It counts each new shape/dtype digest of the batch after the
  first (the event that makes the JAX step recompile, and that changes
  every kernel's shapes here), warns with the digest (of the global
  shapes), and writes a ``recompile`` record. A digest seen before never
  counts;
- device-memory gauges from the CUDA allocator's counters
  (``utils/memory.py``; a census of live tensors on the CPU), read on the
  host;
- the collective counters of ``utils/operations.py``;
- every ``straggler_probe_every`` steps, the step times of every process
  (``gather``) and their skew;
- checkpoint and other events (``record_event``), the serving engine's
  summary (``record_serving``), and a ``summary`` record on ``close``.

Records go to ``<project_dir>/telemetry/rank_<i>.jsonl`` (one JSON object a
line, line-buffered, rotated at ``max_log_bytes``); every ``log_every``
steps a summary goes to the trackers through ``Accelerator.log``. With
``TelemetryKwargs(profile=...)`` the recorder also drives the device-time
profiler (``profiler.py``) and owns the metrics hub.

With ``sync_timing=False`` nothing here waits for the card: the loss is
not read, the memory gauges are host counters, and the probe's gather is
an identity in one process. Off (no ``TelemetryKwargs``), every hook in the
package is one ``is None`` check. Request tracing, the fault-tolerance
events and the planner's plan are not ported (ROADMAP.md Queue A item 12);
a plan dict can be given to ``profiler.note_plan`` directly.
"""

from __future__ import annotations

import json
import os
import time
from collections.abc import Mapping
from typing import Optional

import numpy as np

from .logging import get_logger
from .profiler import DeviceTimeProfiler, MetricsHub, ProfilerConfig
from .utils.memory import get_device_memory_stats, live_bytes_on_device
from .utils.operations import _gather, collective_counters

logger = get_logger(__name__)

# JSONL record schema, by "event" field:
#   step            — one prepared-train-step record (the common row)
#   optimizer_step  — imperative path: backward()-accumulated + apply timing
#   straggler_probe — cross-rank step-time skew sample
#   checkpoint_save / checkpoint_load — duration of a (re)store
#   summary         — final aggregate written by close()
STEP_RECORD_KEYS = (
    "event",
    "step",
    "time",
    "wall_s",
    "data_wait_s",
    "samples",
    "samples_per_s",
    "tokens_per_s",
    "ema_samples_per_s",
    "ema_tokens_per_s",
    "collectives",
    "hbm_bytes_in_use",
    "hbm_peak_bytes",
    "recompiles",
)


def _leaves_with_path(tree, path=""):
    """(path, leaf) pairs in the JAX package's order and key format: dict
    keys sorted, ``['key']`` and ``[i]`` steps."""
    if isinstance(tree, Mapping):
        for k in sorted(tree):
            yield from _leaves_with_path(tree[k], f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves_with_path(v, f"{path}[{i}]")
    elif tree is not None:
        yield path, tree


def _dtype_name(dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _batch_digest(batch) -> str:
    """Shape/dtype fingerprint of a batch, in the JAX package's format
    (``['x']:int64[4, 16]|...``): the watchdog's evidence of what changed."""
    parts = []
    for path, leaf in _leaves_with_path(batch):
        name = path or "leaf"
        shape = getattr(leaf, "shape", None)
        if shape is None:
            parts.append(f"{name}:{type(leaf).__name__}")
        else:
            parts.append(f"{name}:{_dtype_name(leaf.dtype)}{list(shape)}")
    return "|".join(parts) or "<empty>"


def _batch_counts(batch) -> tuple[Optional[int], Optional[int]]:
    """(samples, tokens) of a batch: samples = leading dim of the first
    array leaf; tokens = B*S of the first leaf of rank >= 2."""
    samples = tokens = None
    for _, leaf in _leaves_with_path(batch):
        shape = getattr(leaf, "shape", None)
        if not shape:
            continue
        if samples is None:
            samples = int(shape[0])
        if tokens is None and len(shape) >= 2:
            tokens = int(shape[0]) * int(shape[1])
        if samples is not None and tokens is not None:
            break
    return samples, tokens


class _GlobalShape:
    """A leaf's shape and dtype in the global batch: dim 0 times the
    data-parallel processes and, for a leaf of rank >= 2, dim 1 times the
    ``cp × sp`` processes that each hold a slice of it
    (``parallel/sharding.py``)."""

    def __init__(self, leaf, dp: int, seq: int):
        shape = list(leaf.shape)
        if shape:
            shape[0] *= dp
        if len(shape) >= 2:
            shape[1] *= seq
        self.shape, self.dtype = tuple(shape), leaf.dtype


def _global_batch(batch, dp: int, seq: int):
    """``batch`` with each array leaf replaced by its global shape, as the
    JAX package's step sees the batch: one global array per leaf. The
    counts and the recompile digest read it without a collective."""
    if dp == seq == 1:
        return batch
    if isinstance(batch, Mapping):
        return {k: _global_batch(v, dp, seq) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return [_global_batch(v, dp, seq) for v in batch]
    return _GlobalShape(batch, dp, seq) if getattr(batch, "shape", None) is not None else batch


class TelemetryRecorder:
    """Per-process observer of the training loop. One per Accelerator,
    made when a ``TelemetryKwargs`` handler is passed."""

    def __init__(self, accelerator, handler):
        self.accelerator = accelerator
        self.handler = handler
        self.process_index = accelerator.process_index
        self.num_processes = accelerator.num_processes
        # The processes that read distinct rows, and those that split one
        # row's sequence: a local batch times these is the global one.
        self._dp = accelerator.state.data_parallel_size
        self._seq = accelerator.state.sequence_shard[0]
        self.device = accelerator.device
        self.output_dir = handler.output_dir or os.path.join(
            accelerator.project_dir or ".", "telemetry")
        self.path = os.path.join(self.output_dir, f"rank_{self.process_index}.jsonl")
        self._fh = None  # opened lazily: a run that never steps writes nothing
        self.step = 0
        self._ema_samples = None
        self._ema_tokens = None
        self._peak_hbm: Optional[int] = None
        self._step_times: list[float] = []
        self._data_waits: list[float] = []
        self._pending_data_wait = 0.0
        self._pending_backward = 0.0
        # The recompile watchdog's digests, by watched callable.
        self._watch: dict = {}
        self.recompiles = 0
        self._checkpoint_events = 0
        # The checkpoint tally (record_event), the summary's "checkpoint"
        # block, with the JAX package's keys (its fault-tolerance layer
        # feeds the others; the port's does not exist yet).
        self._ckpt = {
            "saves": 0, "loads": 0, "save_s": 0.0, "load_s": 0.0, "verify_s": 0.0,
            "retries": 0, "torn_skipped": 0, "preemption_saves": 0, "rollbacks": 0,
            "fallback_saves": 0, "async_errors": 0,
        }
        # The serving engine's last summary (record_serving).
        self._serving_summary: Optional[dict] = None
        # The metrics hub: this recorder, the profiler and the serving
        # engine register their providers here.
        self.hub = MetricsHub()
        self.hub.register_provider("telemetry", self._hub_stats)
        self.profiler = None
        pf_cfg = ProfilerConfig.from_value(getattr(handler, "profile", None))
        if pf_cfg is not None:
            self.profiler = DeviceTimeProfiler(pf_cfg, out_dir=accelerator.project_dir or ".")
            self.hub.register_provider("profile", self.profiler.summary)
        self._rotated_once = False
        # The counters are process-wide; a new recorder starts a new tally.
        collective_counters.reset()
        collective_counters.enabled = True

    # -- hot-path hooks ----------------------------------------------------

    def on_train_step(self, step_fn, batch, wall_s: float, metrics=None):
        """Called by the prepared step's wrapper after every step."""
        self.step += 1
        self._step_times.append(wall_s)
        data_wait, self._pending_data_wait = self._pending_data_wait, 0.0
        self._data_waits.append(data_wait)
        batch = _global_batch(batch, self._dp, self._seq)
        self._watch_recompiles(step_fn, batch)
        samples, tokens = _batch_counts(batch)
        samples_per_s = samples / wall_s if samples and wall_s > 0 else None
        tokens_per_s = tokens / wall_s if tokens and wall_s > 0 else None
        alpha = self.handler.ema_alpha
        if samples_per_s is not None:
            self._ema_samples = (samples_per_s if self._ema_samples is None
                                 else alpha * samples_per_s + (1 - alpha) * self._ema_samples)
        if tokens_per_s is not None:
            self._ema_tokens = (tokens_per_s if self._ema_tokens is None
                                else alpha * tokens_per_s + (1 - alpha) * self._ema_tokens)
        record = {
            "event": "step",
            "step": self.step,
            "time": time.time(),
            "wall_s": wall_s,
            "data_wait_s": data_wait,
            "samples": samples,
            "samples_per_s": samples_per_s,
            "tokens_per_s": tokens_per_s,
            "ema_samples_per_s": self._ema_samples,
            "ema_tokens_per_s": self._ema_tokens,
            "collectives": collective_counters.snapshot(),
            "recompiles": self.recompiles,
        }
        record.update(self._memory_gauges())
        if self.profiler is not None:
            # Lagged attribution: finalizes step N-1, stashes step N.
            self.profiler.on_step(self.step, wall_s, data_wait)
            self.profiler.note_gauge("hbm_peak_bytes", self._peak_hbm)
            self.profiler.note_gauge("recompiles", self.recompiles)
        if metrics is not None and self.handler.sync_timing:
            # Only in sync mode: reading the loss waits for the card.
            loss = metrics.get("loss") if isinstance(metrics, dict) else None
            if loss is not None:
                record["loss"] = float(loss)
        self._write(record)
        every = self.handler.straggler_probe_every
        if every and self.step % every == 0:
            self._straggler_probe(wall_s)
        self._forward_to_trackers(record)

    def on_backward(self, loss_fn, batch, wall_s: float):
        """Imperative path: accumulate backward wall time; the record is
        emitted at the apply boundary (on_apply_gradients)."""
        self._pending_backward += wall_s
        self._watch_recompiles(loss_fn, _global_batch(batch, self._dp, self._seq))

    def on_apply_gradients(self, wall_s: float):
        self.step += 1
        backward_s, self._pending_backward = self._pending_backward, 0.0
        data_wait, self._pending_data_wait = self._pending_data_wait, 0.0
        total = backward_s + wall_s
        self._step_times.append(total)
        self._data_waits.append(data_wait)
        record = {
            "event": "optimizer_step",
            "step": self.step,
            "time": time.time(),
            "wall_s": total,
            "backward_s": backward_s,
            "apply_s": wall_s,
            "data_wait_s": data_wait,
            "collectives": collective_counters.snapshot(),
            "recompiles": self.recompiles,
        }
        record.update(self._memory_gauges())
        self._write(record)
        every = self.handler.straggler_probe_every
        if every and self.step % every == 0:
            self._straggler_probe(total)
        self._forward_to_trackers(record)

    def add_data_wait(self, seconds: float):
        """Fed by the prepared loaders: the host time ``next()`` blocked on
        the next batch (what the prefetch thread did not hide)."""
        self._pending_data_wait += seconds

    # -- recompile watchdog ------------------------------------------------

    def _watch_recompiles(self, fn, batch):
        digests = self._watch.setdefault(id(fn), (fn, set()))[1]
        digest = _batch_digest(batch)
        if digest in digests:
            return
        first = not digests
        digests.add(digest)
        if first:
            return
        self.recompiles += 1
        logger.warning(
            "telemetry: batch shape/dtype changed (recompile likely, %d total) — digest: %s",
            self.recompiles, digest, main_process_only=False)
        self._write({"event": "recompile", "step": self.step, "time": time.time(),
                     "recompiles": self.recompiles, "reason": "batch shape/dtype change",
                     "batch_digest": digest})

    # -- probes & gauges ---------------------------------------------------

    def _memory_gauges(self) -> dict:
        every = max(1, self.handler.memory_every)
        if self.step % every != 0:
            return {"hbm_bytes_in_use": None, "hbm_peak_bytes": self._peak_hbm}
        stats = get_device_memory_stats(self.device)
        in_use = stats.get("bytes_in_use")
        if in_use is None:
            # The CPU reports no allocator counters: count the live tensors.
            in_use = live_bytes_on_device(self.device)
        peak = stats.get("peak_bytes_in_use", in_use)
        if peak is not None:
            peak = int(peak)
            self._peak_hbm = peak if self._peak_hbm is None else max(self._peak_hbm, peak)
        return {
            "hbm_bytes_in_use": int(in_use) if in_use is not None else None,
            "hbm_peak_bytes": self._peak_hbm,
        }

    def _straggler_probe(self, wall_s: float):
        """Gather the last step time of every process and record the skew.
        The probe's own collective does not count in the counters."""
        was_enabled, collective_counters.enabled = collective_counters.enabled, False
        try:
            # Every process's time, the sequence groups' members included.
            times = np.asarray(_gather(np.asarray([wall_s], np.float64), seq_size=1),
                               np.float64)
        except Exception as e:  # a failed probe must never kill training
            logger.warning_once(f"telemetry: straggler probe failed: {e}")
            return
        finally:
            collective_counters.enabled = was_enabled
        t_max, t_min = float(times.max()), float(times.min())
        mean = float(times.mean()) or 1e-12
        skew = (t_max - t_min) / mean
        if self.profiler is not None:
            # The skew lands on the next finalized step's record.
            self.profiler.note_straggler(t_max - t_min)
        self._write({
            "event": "straggler_probe",
            "step": self.step,
            "time": time.time(),
            "step_time_max_s": t_max,
            "step_time_min_s": t_min,
            "skew": skew,
            "rank_times_s": [float(t) for t in times.ravel()],
        })
        if skew > self.handler.straggler_warn_skew and self.num_processes > 1:
            slowest = int(np.argmax(times.ravel()))
            logger.warning(
                "telemetry: straggler skew %.1f%% at step %d (max %.4fs rank %d, min %.4fs) — "
                "one rank is consistently behind; check its input pipeline and host load.",
                100 * skew, self.step, t_max, slowest, t_min)

    def record_event(self, event: str, **fields):
        """Out-of-band durations and events (checkpoint save/load, a
        finished serving request, user phases)."""
        if event in ("checkpoint_save", "checkpoint_load"):
            kind = event.removeprefix("checkpoint_")
            self._checkpoint_events += 1
            self._ckpt[f"{kind}s"] += 1
            self._ckpt[f"{kind}_s"] += float(fields.get("seconds") or 0.0)
        elif event == "checkpoint_async_error":
            self._ckpt["async_errors"] += 1
        record = {"event": event, "step": self.step, "time": time.time()}
        record.update(fields)
        self._write(record)

    def record_serving(self, block: dict) -> None:
        """The serving engine's ``stats()``: written as a
        ``serving_summary`` record and kept as the summary's ``serving``
        block (TTFT percentiles, occupancy, tokens/s). Last push wins."""
        self._serving_summary = dict(block)
        self._write({"event": "serving_summary", "step": self.step, "time": time.time(),
                     **self._serving_summary})

    # -- output ------------------------------------------------------------

    def _write(self, record: dict):
        if self._fh is None:
            os.makedirs(self.output_dir, exist_ok=True)
            # Line-buffered: each record is durable on its newline.
            self._fh = open(self.path, "a", buffering=1)
        # Durations come from perf_counter deltas; t_mono lets a reader
        # order records when the wall clock steps.
        record.setdefault("t_mono", time.perf_counter())
        self._fh.write(json.dumps(record) + "\n")
        self._maybe_rotate()

    def _maybe_rotate(self):
        """Keep one rotated generation (``rank_N.jsonl.1``) once the live
        file crosses ``max_log_bytes``."""
        limit = getattr(self.handler, "max_log_bytes", None)
        if not limit or self._fh is None:
            return
        try:
            if self._fh.tell() < int(limit):
                return
            self._fh.close()
            os.replace(self.path, self.path + ".1")
            self._fh = open(self.path, "a", buffering=1)
            if not self._rotated_once:
                self._rotated_once = True
                logger.warning_once(
                    f"telemetry: {self.path} crossed max_log_bytes={int(limit)} and was "
                    f"rotated to {self.path}.1 — raise TelemetryKwargs.max_log_bytes to keep "
                    "more.")
        except OSError as e:
            logger.warning_once(f"telemetry: log rotation failed: {e}")

    def _forward_to_trackers(self, record: dict):
        every = self.handler.log_every
        if not every or self.step % every != 0:
            return
        acc = self.accelerator
        if not getattr(acc, "trackers", None):
            return
        values = {
            "telemetry/step_time_s": record.get("wall_s"),
            "telemetry/data_wait_s": record.get("data_wait_s"),
            "telemetry/recompiles": record.get("recompiles"),
        }
        if record.get("ema_samples_per_s") is not None:
            values["telemetry/samples_per_s"] = record["ema_samples_per_s"]
        if record.get("ema_tokens_per_s") is not None:
            values["telemetry/tokens_per_s"] = record["ema_tokens_per_s"]
        if record.get("hbm_peak_bytes") is not None:
            values["telemetry/hbm_peak_bytes"] = record["hbm_peak_bytes"]
        acc.log({k: v for k, v in values.items() if v is not None}, step=self.step)

    def summary(self) -> dict:
        """Everything recorded so far; the last record ``close`` writes."""
        times = np.asarray(self._step_times, np.float64)
        waits = np.asarray(self._data_waits, np.float64)
        out = {
            "steps": int(times.size),
            "recompiles": self.recompiles,
            "peak_hbm_bytes": self._peak_hbm,
            "collectives": collective_counters.snapshot(),
            "checkpoint_events": self._checkpoint_events,
            "checkpoint": {k: (round(v, 6) if isinstance(v, float) else v)
                           for k, v in self._ckpt.items()},
        }
        if self._serving_summary is not None:
            out["serving"] = dict(self._serving_summary)
        if self.profiler is not None:
            out["profile"] = self.profiler.summary()
        if times.size:
            out.update(
                step_time_mean_s=float(times.mean()),
                step_time_p50_s=float(np.percentile(times, 50)),
                step_time_p90_s=float(np.percentile(times, 90)),
                data_wait_mean_s=float(waits.mean()) if waits.size else 0.0,
                ema_samples_per_s=self._ema_samples,
                ema_tokens_per_s=self._ema_tokens,
            )
        return out

    def _hub_stats(self) -> dict:
        """The recorder's scalars for the hub (``accelerate_tpu_telemetry_*``)."""
        return {
            "steps": self.step,
            "recompiles": self.recompiles,
            "peak_hbm_bytes": self._peak_hbm or 0,
            "checkpoint_events": self._checkpoint_events,
        }

    def close(self):
        if self.profiler is not None:
            # Finalize the lagged records so the summary covers the last step.
            self.profiler.flush()
        if self._fh is not None:
            self._write({"event": "summary", "time": time.time(), **self.summary()})
            self._fh.close()
            self._fh = None
        collective_counters.enabled = False
