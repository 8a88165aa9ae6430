"""Device-time attribution, the metrics hub and the crash flight recorder:
the port of ``accelerate_tpu/profiler.py``, with its names, record schemas
and Prometheus names (``accelerate_tpu_<subsystem>_<name>``), so that one
reader parses both packages' output.

- :class:`DeviceTimeProfiler` splits each train step's and each serving
  tick's wall time into named terms that sum to the record's ``wall_s``
  (the closing term, ``dispatch_s`` or ``bookkeeping_s``, takes the rest).
  The records lag one step: step N's is finalized when step N+1 arrives,
  from host ``perf_counter`` times, so the profiler adds no host-device
  synchronisation. The compute term needs a FLOP count
  (:meth:`DeviceTimeProfiler.capture_cost`: ``FlopCounterMode`` over the
  first profiled step, where the JAX package reads the compiled step's
  ``cost_analysis()``) and a plan's rates (:meth:`note_plan`); without a
  plan it is 0 and the terms are the measured ones (data wait, straggler
  skew) and the residual, in both packages.
- :class:`MetricsHub` is the one registry of counters, gauges, histograms
  and ``stats()`` providers, with one Prometheus text renderer, name
  aliases and SLO burn rates.
- :class:`FlightRecorder` keeps the newest attribution records and gauges
  in a ring and dumps them as ``flight_<exit class>.json`` for an exit code
  of ``EXIT_CODE_TABLE`` (``dump_flight``).

On through ``TelemetryKwargs(profile=True)`` (or a dict of
:class:`ProfilerConfig` fields); off, each hook is one ``is None`` check.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import re
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

from .logging import get_logger
from .utils.constants import EXIT_CODE_TABLE, FLIGHT_DIR_ENV, FLIGHT_RECORD_PATTERN


class _BestEffortLogger:
    """The logger raises until the process state exists, and the flight
    recorder runs in dying processes: every call is best effort."""

    def __init__(self, inner):
        self._inner = inner

    def __getattr__(self, name):
        fn = getattr(self._inner, name)

        def call(*args, **kwargs):
            try:
                return fn(*args, **kwargs)
            except Exception:
                return None

        return call


logger = _BestEffortLogger(get_logger(__name__))

# The comm axes a plan's breakdown prices: one exposed-comm term per
# active axis.
COMM_AXES = ("fsdp", "dp", "tp", "cp", "pp")

# Train-step terms, in emission order; they sum to the record's wall_s
# (dispatch_s closes the identity).
STEP_TERMS = (
    "device_compute_s",  # the compute estimate charged to the wall
    "comm_exposed_s",    # collective time not hidden behind compute
    "data_wait_s",       # host blocked on the input pipeline
    "straggler_skew_s",  # cross-process skew (latest probe sample)
    "dispatch_s",        # host dispatch and the untracked rest (closing term)
)

# Serving-tick terms, timed on the host by the engine's tick;
# bookkeeping_s closes the identity.
TICK_TERMS = (
    "admit_s",        # admission into free slots
    "prefill_s",      # prompt chunks this tick
    "decode_s",       # the decode step (the host read excluded)
    "host_fetch_s",   # the tick's one read of tokens and done flags
    "bookkeeping_s",  # retirement and the rest (closing term)
)

# The fields of a plan's "bandwidths" dict the comm pricing reads (the JAX
# package's BandwidthTable fields).
_BANDWIDTH_FIELDS = ("ici_gbps", "dcn_gbps", "flops_per_chip", "mfu",
                     "collective_efficiency", "ici_domain", "microbatch_overhead_s",
                     "dp_overlap")


def _axis_gbps(bandwidths: dict, axis: str, n_devices: int) -> float:
    """The link an axis's collectives use, as the JAX planner prices it:
    the inner axes (tp, sp, cp) on the fast fabric, the data-parallel ones
    on the slow one once the devices outgrow one fast domain."""
    unknown = set(bandwidths) - set(_BANDWIDTH_FIELDS)
    if unknown:
        raise ValueError(f"unknown bandwidth field(s) {sorted(unknown)}; "
                         f"valid: {sorted(_BANDWIDTH_FIELDS)}")
    fast = float(bandwidths["ici_gbps"])
    if axis in ("tp", "sp", "cp") or n_devices <= int(bandwidths["ici_domain"]):
        return fast
    return float(bandwidths["dcn_gbps"])


def exit_class_name(code: int) -> str:
    """The classification of an exit code in ``EXIT_CODE_TABLE``; an
    unknown code as its number."""
    for row in EXIT_CODE_TABLE:
        if row["code"] == code:
            return row["classification"]
    return str(int(code))


# ----------------------------------------------------------------------
# MetricsHub — the one metrics registry and the one Prometheus renderer
# ----------------------------------------------------------------------

_NAME_RE = re.compile(r"^[a-z][a-z0-9_]*$")


class _Counter:
    """Monotone counter. Rendered as ``accelerate_tpu_<name>`` (name the
    ``<subsystem>_<metric>_total`` convention by hand)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        self.value += n


class _Gauge:
    """Last-set scalar."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class _Histogram:
    """Bounded-window histogram: keeps the last ``window`` observations and
    renders count/sum plus p50/p95 gauges (full native-histogram exposition
    is out of scope — percentile gauges are what the dashboards read)."""

    __slots__ = ("name", "count", "total", "_window")

    def __init__(self, name: str, window: int = 1024):
        self.name = name
        self.count = 0
        self.total = 0.0
        self._window: deque = deque(maxlen=max(1, int(window)))

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.total += v
        self._window.append(v)

    def snapshot(self) -> Dict[str, float]:
        out = {"count": float(self.count), "sum": self.total}
        if self._window:
            xs = sorted(self._window)
            out["p50"] = xs[len(xs) // 2]
            out["p95"] = xs[min(len(xs) - 1, (len(xs) * 95) // 100)]
        return out


class MetricsHub:
    """The single metrics registry + Prometheus text renderer.

    Naming scheme (the JAX package's): every exposed series is
    ``accelerate_tpu_<subsystem>_<name>``. Three registration surfaces:

    - **instruments** — :meth:`counter` / :meth:`gauge` /
      :meth:`histogram` create-or-get an owned instrument; registering an
      existing name as a *different* kind is rejected (``ValueError``) so
      two subsystems cannot silently fight over one series.
    - **providers** — :meth:`register_provider` maps a subsystem to a
      zero-arg ``stats()``-style callable whose numeric leaves render as
      ``accelerate_tpu_<subsystem>_<path>`` gauges.
    - **text providers** — pre-formatted exposition lines for labeled
      series; still rendered by THIS renderer so the name set stays
      auditable in one place.

    Old metric names live on as aliases for one release
    (:meth:`alias`): the renderer duplicates the new series under the old
    name and fires a single ``warning_once`` naming the replacement.

    SLO burn rate: :meth:`register_slo` + :meth:`observe_slo` feed bounded
    rolling windows; :meth:`burn_rates` turns them into
    error-rate-over-budget records, rendered as
    ``accelerate_tpu_slo_<name>_burn_rate`` gauges and surfaced to any
    watcher (serving wires its per-request outcomes in).
    """

    def __init__(self):
        self._instruments: Dict[str, Any] = {}
        self._providers: Dict[str, Callable[[], Dict[str, Any]]] = {}
        self._text_providers: List[Callable[[], List[str]]] = []
        self._aliases: Dict[str, str] = {}  # old full name -> new full name
        self._slos: Dict[str, dict] = {}
        self._alias_warned = False

    # -- instruments -----------------------------------------------------

    def _instrument(self, kind, name: str, *args):
        if not _NAME_RE.match(name):
            raise ValueError(
                f"metric name {name!r} violates the pinned scheme "
                "(lowercase [a-z0-9_], leading letter)")
        existing = self._instruments.get(name)
        if existing is not None:
            if type(existing) is not kind:
                raise ValueError(
                    f"metric {name!r} already registered as "
                    f"{type(existing).__name__}, not {kind.__name__} — "
                    "the hub rejects cross-kind collisions")
            return existing
        inst = kind(name, *args)
        self._instruments[name] = inst
        return inst

    def counter(self, name: str) -> _Counter:
        return self._instrument(_Counter, name)

    def gauge(self, name: str) -> _Gauge:
        return self._instrument(_Gauge, name)

    def histogram(self, name: str, window: int = 1024) -> _Histogram:
        return self._instrument(_Histogram, name, window)

    # -- providers -------------------------------------------------------

    def register_provider(self, subsystem: str,
                          provider: Callable[[], Dict[str, Any]],
                          *, replace: bool = False) -> None:
        """Register a live ``stats()`` provider under ``subsystem``. A
        second registration for the same subsystem is rejected unless
        ``replace=True`` (engines replacing a predecessor in the same
        process pass it; accidental double-wiring should fail loudly)."""
        if not _NAME_RE.match(subsystem):
            raise ValueError(f"subsystem {subsystem!r} violates the pinned "
                             "naming scheme")
        prev = self._providers.get(subsystem)
        if prev is not None and prev is not provider and not replace:
            raise ValueError(
                f"provider for subsystem {subsystem!r} already registered; "
                "pass replace=True to take it over")
        self._providers[subsystem] = provider

    def register_text(self, fn: Callable[[], List[str]]) -> None:
        """Register a pre-formatted exposition-line provider (for labeled
        series the instrument surface can't express)."""
        if fn not in self._text_providers:
            self._text_providers.append(fn)

    def alias(self, old_name: str, new_name: str) -> None:
        """Keep ``old_name`` rendering (duplicating ``new_name``'s series)
        for one release; the renderer warns once that it is deprecated."""
        self._aliases[old_name] = new_name

    # -- SLO rolling windows + burn rate ---------------------------------

    def register_slo(self, name: str, objective: float,
                     window: int = 256) -> None:
        """Track an availability-style SLO: ``objective`` is the target
        good fraction (e.g. 0.99); the burn rate is the observed error
        rate over the rolling window divided by the error budget
        (1 - objective). Burn rate 1.0 = exactly consuming budget."""
        if not 0.0 < objective < 1.0:
            raise ValueError(f"objective must be in (0, 1), got {objective}")
        if name not in self._slos:
            self._slos[name] = {
                "objective": float(objective),
                "window": deque(maxlen=max(1, int(window))),
            }

    def observe_slo(self, name: str, ok: bool) -> None:
        slo = self._slos.get(name)
        if slo is not None:
            slo["window"].append(0 if ok else 1)

    def burn_rates(self) -> Dict[str, dict]:
        out = {}
        for name, slo in self._slos.items():
            win = slo["window"]
            budget = 1.0 - slo["objective"]
            err = (sum(win) / len(win)) if win else 0.0
            rate = err / budget if budget > 0 else 0.0
            out[name] = {
                "objective": slo["objective"],
                "events": len(win),
                "error_rate": round(err, 6),
                "burn_rate": round(rate, 6),
                "alert": rate > 1.0 + 1e-9 and len(win) >= 10,
            }
        return out

    # -- the ONE renderer ------------------------------------------------

    @staticmethod
    def _sanitize(name: str) -> str:
        return "".join(c if c.isalnum() or c == "_" else "_" for c in name)

    def render(self) -> str:
        """Prometheus text exposition of everything registered — the only
        renderer in the package, so names cannot drift between exporters."""
        lines: List[str] = []

        def emit(name: str, value: Any) -> None:
            if isinstance(value, bool):
                value = int(value)
            if isinstance(value, (int, float)) and value == value:  # no NaN
                lines.append(f"{name} {value}")

        def walk(prefix: str, obj: Any) -> None:
            if isinstance(obj, dict):
                for key in sorted(obj):
                    walk(f"{prefix}_{self._sanitize(str(key))}", obj[key])
            elif isinstance(obj, (int, float, bool)):
                emit(prefix, obj)

        for name in sorted(self._instruments):
            inst = self._instruments[name]
            full = f"accelerate_tpu_{name}"
            if isinstance(inst, _Counter):
                lines.append(f"# TYPE {full} counter")
                emit(full, inst.value)
            elif isinstance(inst, _Gauge):
                lines.append(f"# TYPE {full} gauge")
                emit(full, inst.value)
            else:
                walk(full, inst.snapshot())
        for subsystem in sorted(self._providers):
            try:
                snapshot = self._providers[subsystem]()
            except Exception:
                logger.exception("metrics provider %r failed", subsystem)
                continue
            lines.append(f"# HELP accelerate_tpu_{subsystem} live gauges "
                         f"from {subsystem}.stats()")
            lines.append(f"# TYPE accelerate_tpu_{subsystem} gauge")
            walk(f"accelerate_tpu_{self._sanitize(subsystem)}", snapshot)
        for name, rec in sorted(self.burn_rates().items()):
            base = f"accelerate_tpu_slo_{self._sanitize(name)}"
            emit(f"{base}_error_rate", rec["error_rate"])
            emit(f"{base}_burn_rate", rec["burn_rate"])
        for fn in self._text_providers:
            try:
                lines.extend(fn())
            except Exception:
                logger.exception("metrics text provider failed")
        if self._aliases:
            if not self._alias_warned:
                self._alias_warned = True
                logger.warning_once(
                    "metrics: deprecated metric-name aliases are still "
                    "exported (%s) — they render for one release; scrape "
                    "the accelerate_tpu_<subsystem>_<name> replacements."
                    % ", ".join(f"{o}->{n}"
                                for o, n in sorted(self._aliases.items())))
            rendered = {}
            for ln in lines:
                if ln and not ln.startswith("#"):
                    rendered[ln.split("{")[0].split(" ")[0]] = ln
            for old, new in sorted(self._aliases.items()):
                src = rendered.get(new)
                if src is not None:
                    lines.append(old + src[len(new):])
        return "\n".join(lines) + "\n"

    def metric_names(self) -> set:
        """The set of series names currently rendered."""
        names = set()
        for ln in self.render().splitlines():
            if ln and not ln.startswith("#"):
                names.add(ln.split("{")[0].split(" ")[0])
        return names


# ----------------------------------------------------------------------
# FlightRecorder — the crash ring buffer
# ----------------------------------------------------------------------


class FlightRecorder:
    """Bounded ring of the most recent observability state, dumped on
    abnormal exit.

    Entries are the profiler's step/tick attribution records plus any
    event a subsystem pushes via :meth:`record`; :meth:`note` maintains
    "last known" gauges (peak memory, recompiles, slot occupancy) outside
    the ring. :meth:`dump` writes ``flight_<exit_class>.json`` into
    ``$ACCELERATE_FLIGHT_DIR`` (if set), else ``out_dir``, else the cwd.
    Every edge is best-effort: a dying process must still die.
    """

    def __init__(self, capacity: int = 256, out_dir: Optional[str] = None):
        self.capacity = max(1, int(capacity))
        self.out_dir = out_dir
        self._ring: deque = deque(maxlen=self.capacity)
        self._gauges: Dict[str, Any] = {}
        self._tracing = None
        self.dumps = 0
        self.last_dump_path: Optional[str] = None

    def __len__(self) -> int:
        return len(self._ring)

    def record(self, kind: str, **fields) -> None:
        entry = {"kind": kind, "t_mono": time.perf_counter()}
        entry.update(fields)
        self._ring.append(entry)

    def note(self, key: str, value: Any) -> None:
        self._gauges[key] = value

    def attach_tracing(self, recorder) -> None:
        """Let dumps include the newest spans of a ``TraceRecorder``."""
        self._tracing = recorder

    def entries(self) -> List[dict]:
        return list(self._ring)

    def snapshot(self) -> dict:
        snap = {
            "capacity": self.capacity,
            "entries": self.entries(),
            "gauges": dict(self._gauges),
        }
        tr = self._tracing
        if tr is not None:
            try:
                snap["recent_spans"] = [s.tick_view() for s in tr.spans()[-50:]]
            except Exception:  # a dump must not fail on its way out
                snap["recent_spans"] = None
        return snap

    def resolve_dir(self) -> str:
        return os.environ.get(FLIGHT_DIR_ENV) or self.out_dir or "."

    def dump(self, exit_class, *, reason: Optional[str] = None,
             extra: Optional[dict] = None) -> Optional[str]:
        """Write the flight bundle for ``exit_class`` (a classification
        string, or an exit code resolved through EXIT_CODE_TABLE).
        Returns the path, or None if the write failed (best effort)."""
        if isinstance(exit_class, int):
            exit_class = exit_class_name(exit_class)
        try:
            out_dir = self.resolve_dir()
            os.makedirs(out_dir, exist_ok=True)
            path = os.path.join(
                out_dir, FLIGHT_RECORD_PATTERN.format(exit_class=exit_class))
            doc = {
                "exit_class": exit_class,
                "reason": reason,
                "time": time.time(),
                "t_mono": time.perf_counter(),
                "pid": os.getpid(),
                **self.snapshot(),
            }
            if extra:
                doc["extra"] = extra
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "w") as fh:
                json.dump(doc, fh, default=str)
            os.replace(tmp, path)  # readable-or-absent, even mid-crash
            self.dumps += 1
            self.last_dump_path = path
            logger.error("flight recorder: dumped %d ring entr%s to %s",
                         len(self._ring),
                         "y" if len(self._ring) == 1 else "ies", path,
                         main_process_only=False)
            return path
        except Exception:  # pragma: no cover - dying anyway
            logger.exception("flight recorder: dump failed")
            return None


def dump_flight(source, exit_code: int, *,
                reason: Optional[str] = None) -> Optional[str]:
    """Best-effort flight dump before a deliberate abnormal exit with
    ``exit_code`` (a code of ``EXIT_CODE_TABLE``).

    ``source`` may be a TelemetryRecorder, a DeviceTimeProfiler, or a
    FlightRecorder — whatever the dying subsystem has at hand. The
    profiler's lagged records are flushed first. No-op when nothing
    resolves to a flight ring."""
    fr = source
    if fr is not None and not isinstance(fr, FlightRecorder):
        prof = getattr(fr, "profiler", fr)
        if prof is None or isinstance(prof, FlightRecorder):
            fr = prof
        else:
            cfg = getattr(prof, "config", None)
            if cfg is not None and not getattr(cfg, "flight", True):
                return None
            try:
                prof.flush()
            except Exception:  # pragma: no cover - dying anyway
                pass
            fr = getattr(prof, "flight", None)
    if fr is None:
        return None
    try:
        return fr.dump(exit_code, reason=reason)
    except Exception:  # pragma: no cover - dying anyway
        return None


def find_flight_bundles(extra_dirs: Optional[List[str]] = None) -> List[str]:
    """Flight bundles visible to a supervisor: ``$ACCELERATE_FLIGHT_DIR``
    plus the cwd (children inherit both), newest first."""
    dirs = []
    env_dir = os.environ.get(FLIGHT_DIR_ENV)
    if env_dir:
        dirs.append(env_dir)
    dirs.append(".")
    dirs.extend(extra_dirs or [])
    prefix, suffix = FLIGHT_RECORD_PATTERN.split("{exit_class}")
    found = {}
    for d in dirs:
        try:
            names = os.listdir(d)
        except OSError:
            continue
        for name in names:
            if name.startswith(prefix) and name.endswith(suffix):
                path = os.path.join(d, name)
                try:
                    found[os.path.abspath(path)] = os.path.getmtime(path)
                except OSError:
                    continue
    return [p for p, _ in sorted(found.items(), key=lambda kv: -kv[1])]


# ----------------------------------------------------------------------
# DeviceTimeProfiler — lagged wall-time attribution
# ----------------------------------------------------------------------


@dataclasses.dataclass
class ProfilerConfig:
    """Knobs for :class:`DeviceTimeProfiler`, set through
    ``TelemetryKwargs(profile=...)`` — ``True`` for defaults, a dict of
    overrides, or an instance. The JAX package's fields and defaults."""

    enabled: bool = True
    # Flight-ring capacity: the last N step/tick attribution records a
    # crash dump carries.
    ring_size: int = 256
    # Relative tolerance a check may hold the term-sum identity to (the
    # identity is exact by construction; the bar catches emission bugs).
    tolerance: float = 0.05
    # Count the first profiled step's FLOPs (capture_cost). That step runs
    # under FlopCounterMode, which slows its host side. Disable to rely on
    # the plan breakdown alone.
    capture_cost: bool = True
    # Cap on the straggler-skew share of one step's wall (the probe lags
    # several steps; a stale spike must not swallow the whole step).
    max_skew_fraction: float = 0.5
    # Arm the FlightRecorder + crash dumps.
    flight: bool = True

    @classmethod
    def from_value(cls, value: Any) -> Optional["ProfilerConfig"]:
        """Coerce a ``TelemetryKwargs.profile`` value into a config.

        Accepts ``True`` (defaults), a dict of field overrides, an
        existing ``ProfilerConfig``, or falsy (disabled -> ``None``).
        """
        if not value:
            return None
        if isinstance(value, cls):
            return value if value.enabled else None
        if isinstance(value, dict):
            cfg = cls(**value)
            return cfg if cfg.enabled else None
        if value is True:
            return cls()
        raise TypeError(
            f"profile must be bool, dict, or ProfilerConfig, "
            f"got {type(value).__name__}")


class DeviceTimeProfiler:
    """Wall-time attribution for train steps and decode ticks.

    **The identity.** Every emitted record's terms sum to its ``wall_s``
    EXACTLY: estimates (compute, exposed comm, skew) are clipped into the
    measured budget in a fixed priority order and the dispatch/bookkeeping
    residual closes whatever is left. Each number is rounded to the
    nanosecond as the JAX package rounds it, so a record's sum may stand a
    nanosecond or two from its ``wall_s``. The estimates come from the
    counted FLOPs (:meth:`capture_cost`) and the active plan's breakdown
    (:meth:`note_plan`); with neither, the decomposition degrades to
    measured-only terms (data wait, skew, residual) and the overlap ratio
    is withheld rather than invented.

    **The lag.** ``on_step``/``on_tick`` finalize the PREVIOUS record and
    stash the current one, so late-arriving host-side signals (the
    straggler probe that runs after the step) land on the right step and
    the hot path never gains a device sync. ``flush()`` (close/crash
    path) finalizes the stashed record.

    **Overlap + bandwidth residuals.** For each finalized step with a
    plan: ``overlap_ratio = 1 - exposed_comm / predicted_comm`` (clipped
    to [0, 1]), against the plan's ``dp_overlap`` assumption; each active
    axis gets an achieved-bandwidth sample ``predicted_gbps *
    predicted_step_s / measured_wall`` recorded as a residual ratio against
    the plan's bandwidths (a step-level lower bound, not a per-collective
    measurement: that needs a device trace).
    """

    def __init__(self, config: Optional[ProfilerConfig] = None,
                 out_dir: Optional[str] = None):
        self.config = config or ProfilerConfig()
        # The ring always exists (it holds the attribution records);
        # config.flight only gates crash DUMPS (dump_flight checks it).
        self.flight = FlightRecorder(self.config.ring_size, out_dir)
        # Plan-derived pricing (note_plan): per-axis comm seconds/bytes,
        # predicted step seconds, and the plan's bandwidths dict.
        self._breakdown: Optional[dict] = None
        self._predicted_step_s: Optional[float] = None
        self._bandwidths: Optional[dict] = None
        self._axis_gbps: Dict[str, float] = {}
        # The counted FLOPs (capture_cost, once).
        self._cost: Optional[dict] = None
        self._cost_tried = False
        # Lag buffers: the not-yet-finalized step/tick record inputs.
        self._pending_step: Optional[dict] = None
        self._pending_tick: Optional[dict] = None
        self._last_skew_s = 0.0
        # Running aggregates (summary() reads these; the ring only keeps
        # the newest records).
        self._agg_steps = 0
        self._agg_ticks = 0
        self._term_sums: Dict[str, float] = {}
        self._tick_term_sums: Dict[str, float] = {}
        self._overlap_sum = 0.0
        self._overlap_n = 0
        self._bw_res: Dict[str, dict] = {}

    # -- pricing inputs --------------------------------------------------

    def note_plan(self, plan: Optional[dict]) -> None:
        """Install a parallelism plan (the JAX planner's plan dict, which
        telemetry receives through ``note_plan``; the port has no planner
        yet): its ``breakdown`` prices per-axis comm and its ``bandwidths``
        is the table residuals grade against."""
        if not plan:
            return
        bd = plan.get("breakdown")
        if isinstance(bd, dict):
            self._breakdown = dict(bd)
        ps = plan.get("predicted_step_s")
        if ps:
            self._predicted_step_s = float(ps)
        bw = plan.get("bandwidths")
        if isinstance(bw, dict):
            self._bandwidths = dict(bw)
        self._axis_gbps = {}
        if self._breakdown and self._bandwidths:
            try:
                n = int(plan.get("n_devices") or 1)
                eff = float(self._bandwidths["collective_efficiency"])
                for axis in COMM_AXES:
                    if float(self._breakdown.get(f"{axis}_comm_s") or 0) > 0:
                        self._axis_gbps[axis] = _axis_gbps(self._bandwidths, axis, n) * eff
            except Exception as e:  # pricing must never kill training
                logger.warning_once(f"profiler: bandwidth pricing failed: {e}")

    @contextlib.contextmanager
    def capture_cost(self):
        """Count the FLOPs of what runs inside the block, once per profiler
        (the step wrapper puts the first profiled step in it):
        ``torch.utils.flop_counter.FlopCounterMode`` over the step's
        forward and backward, the flash ops by their registered formulas
        (``ops/hopper_flash.py``). The JAX package reads the compiled
        step's ``cost_analysis()`` instead; the port's step is eager and
        has none, so ``bytes_accessed`` is None. The mode counts on the
        host and adds no synchronisation; it slows the step it counts.
        Skipped with ``capture_cost=False``."""
        if self._cost_tried or not self.config.capture_cost:
            yield
            return
        self._cost_tried = True
        from torch.utils.flop_counter import FlopCounterMode

        counter = FlopCounterMode(display=False)
        with counter:
            yield
        self._cost = {"flops": float(counter.get_total_flops()), "bytes_accessed": None}
        self.flight.note("cost_analysis", self._cost)

    def note_straggler(self, skew_s: float) -> None:
        """Latest cross-rank skew sample (telemetry's straggler probe):
        ``max - min`` rank step seconds. Lands on the next finalized
        step — the probe itself already runs off the hot path."""
        self._last_skew_s = max(0.0, float(skew_s))

    def note_gauge(self, key: str, value: Any) -> None:
        """Last-known gauge for the flight bundle (peak memory, recompiles,
        occupancy) — not part of the attribution identity."""
        self.flight.note(key, value)

    # -- pricing helpers -------------------------------------------------

    def _compute_estimate(self) -> Optional[float]:
        """Predicted device-compute seconds per step: the counted FLOPs at
        the plan's rate (``flops_per_chip × mfu``), else the plan
        breakdown's compute term; None without a plan."""
        if self._cost and self._cost["flops"] > 0 and self._bandwidths:
            flops_per_chip = float(
                self._bandwidths.get("flops_per_chip") or 0.0)
            mfu = float(self._bandwidths.get("mfu") or 0.0)
            if flops_per_chip > 0 and mfu > 0:
                return self._cost["flops"] / (flops_per_chip * mfu)
        if self._breakdown:
            c = float(self._breakdown.get("compute_s") or 0.0)
            return c if c > 0 else None
        return None

    def _axis_comm(self) -> Dict[str, float]:
        if not self._breakdown:
            return {}
        return {
            axis: float(self._breakdown.get(f"{axis}_comm_s") or 0.0)
            for axis in COMM_AXES
            if float(self._breakdown.get(f"{axis}_comm_s") or 0.0) > 0
        }

    # -- train-step attribution (lagged) ---------------------------------

    def on_step(self, step: int, wall_s: float, data_wait_s: float) -> None:
        """Feed step N's measured walls; finalizes and emits step N-1's
        attribution record. Host arithmetic only — zero device syncs."""
        prev, self._pending_step = self._pending_step, {
            "step": int(step),
            "wall_s": float(wall_s),
            "data_wait_s": max(0.0, float(data_wait_s)),
        }
        if prev is not None:
            self._finalize_step(prev)

    def _finalize_step(self, rec: dict) -> None:
        wall = rec["wall_s"] + rec["data_wait_s"]
        budget = rec["wall_s"]  # in-step budget; data wait is its own term
        skew = min(self._last_skew_s, self.config.max_skew_fraction * budget)
        budget -= skew
        compute_est = self._compute_estimate()
        axis_comm = self._axis_comm()
        comm_total = sum(axis_comm.values())
        device_compute = (min(compute_est, budget)
                          if compute_est is not None else 0.0)
        # Exposed comm: step time beyond compute and skew, attributable to
        # collectives up to the model's total comm prediction. What the
        # latency-hiding scheduler actually hid is (comm_total - exposed).
        exposed = (min(max(0.0, budget - device_compute), comm_total)
                   if comm_total > 0 else 0.0)
        terms = {
            "device_compute_s": device_compute,
            "comm_exposed_s": exposed,
            "data_wait_s": rec["data_wait_s"],
            "straggler_skew_s": skew,
            # The closing term: the identity sum(terms) == wall is exact.
            "dispatch_s": wall - device_compute - exposed
            - rec["data_wait_s"] - skew,
        }
        comm_axes = ({axis: exposed * (s / comm_total)
                      for axis, s in axis_comm.items()}
                     if comm_total > 0 else {})
        overlap = None
        if comm_total > 0 and compute_est is not None:
            overlap = min(1.0, max(0.0, 1.0 - exposed / comm_total))
            self._overlap_sum += overlap
            self._overlap_n += 1
        bandwidth = self._bandwidth_samples(rec["wall_s"])
        out = {
            "step": rec["step"],
            "wall_s": round(wall, 9),
            "terms": {k: round(v, 9) for k, v in terms.items()},
            "comm_axes_s": {k: round(v, 9) for k, v in comm_axes.items()},
            "overlap_ratio": None if overlap is None else round(overlap, 6),
            "bandwidth": bandwidth,
        }
        self._agg_steps += 1
        for k, v in terms.items():
            self._term_sums[k] = self._term_sums.get(k, 0.0) + v
        self.flight.record("step", **out)

    def _bandwidth_samples(self, wall_s: float) -> Optional[dict]:
        """Per-axis achieved-bandwidth samples as residuals against the
        plan's bandwidths: each active axis's effective bandwidth this step,
        assuming its comm phase stretched with the whole step
        (``residual = achieved / predicted``, < 1 = link slower than the
        table claims)."""
        if (not self._axis_gbps or not self._predicted_step_s
                or wall_s <= 0):
            return None
        stretch = self._predicted_step_s / wall_s
        samples = {}
        for axis, predicted_gbps in self._axis_gbps.items():
            achieved = predicted_gbps * stretch
            samples[axis] = {
                "bytes": int(self._breakdown.get(f"{axis}_bytes") or 0),
                "predicted_gbps": round(predicted_gbps, 6),
                "achieved_gbps": round(achieved, 6),
                "residual": round(stretch, 6),
            }
            agg = self._bw_res.setdefault(axis, {
                "predicted_gbps": round(predicted_gbps, 6),
                "residual_sum": 0.0, "achieved_sum": 0.0, "samples": 0,
            })
            agg["residual_sum"] += stretch
            agg["achieved_sum"] += achieved
            agg["samples"] += 1
        return samples

    # -- decode-tick attribution (lagged) --------------------------------

    def on_tick(self, tick: int, wall_s: float,
                sections: Optional[Dict[str, float]] = None,
                gauges: Optional[Dict[str, Any]] = None) -> None:
        """Feed tick N's measured wall + host section timers (the engine's
        ``perf_counter`` deltas around admit/prefill/decode/fetch);
        finalizes and emits tick N-1's record. The residual
        ``bookkeeping_s`` closes the identity exactly."""
        prev, self._pending_tick = self._pending_tick, {
            "tick": int(tick),
            "wall_s": float(wall_s),
            "sections": dict(sections or {}),
        }
        if gauges:
            for k, v in gauges.items():
                self.flight.note(k, v)
        if prev is not None:
            self._finalize_tick(prev)

    def _finalize_tick(self, rec: dict) -> None:
        wall = rec["wall_s"]
        terms = {t: 0.0 for t in TICK_TERMS}
        for name, v in rec["sections"].items():
            if name in terms:
                terms[name] = max(0.0, float(v))
        # The closing term: whatever the section timers did not cover lands
        # on bookkeeping (a measured bookkeeping section is kept and the
        # residual stacks on top — counting it once keeps the identity).
        terms["bookkeeping_s"] += wall - sum(terms.values())
        out = {
            "tick": rec["tick"],
            "wall_s": round(wall, 9),
            "terms": {k: round(v, 9) for k, v in terms.items()},
        }
        self._agg_ticks += 1
        for k, v in terms.items():
            self._tick_term_sums[k] = self._tick_term_sums.get(k, 0.0) + v
        self.flight.record("tick", **out)

    # -- lifecycle -------------------------------------------------------

    def flush(self) -> None:
        """Finalize the lagged records (close/crash path): the stashed
        step/tick becomes the newest ring entry, so a flight bundle's last
        entries identify the step/tick that was in flight."""
        prev, self._pending_step = self._pending_step, None
        if prev is not None:
            self._finalize_step(prev)
        prev, self._pending_tick = self._pending_tick, None
        if prev is not None:
            self._finalize_tick(prev)

    def reset(self) -> None:
        """Warmup boundary (the engines' ``reset_metrics``): drop ring
        entries and aggregates; keep the captured cost/plan pricing (they
        fingerprint the program, not the run)."""
        self._pending_step = None
        self._pending_tick = None
        self._last_skew_s = 0.0
        self._agg_steps = 0
        self._agg_ticks = 0
        self._term_sums.clear()
        self._tick_term_sums.clear()
        self._overlap_sum = 0.0
        self._overlap_n = 0
        self._bw_res.clear()
        self.flight._ring.clear()

    def records(self) -> List[dict]:
        """The ring's attribution records (newest last)."""
        return [e for e in self.flight.entries()
                if e.get("kind") in ("step", "tick")]

    def summary(self) -> dict:
        """The ``summary()["profile"]`` block (the JAX package's schema)."""
        def _means(sums: Dict[str, float], n: int) -> dict:
            return {k: round(v / n, 9) for k, v in sorted(sums.items())} \
                if n else {}

        bw = {}
        for axis, agg in sorted(self._bw_res.items()):
            n = agg["samples"]
            bw[axis] = {
                "predicted_gbps": agg["predicted_gbps"],
                "achieved_gbps_mean": round(agg["achieved_sum"] / n, 6),
                "residual_mean": round(agg["residual_sum"] / n, 6),
                "samples": n,
            }
        return {
            "steps": self._agg_steps,
            "ticks": self._agg_ticks,
            "cost_captured": self._cost is not None,
            "overlap_ratio_mean": (
                round(self._overlap_sum / self._overlap_n, 6)
                if self._overlap_n else None),
            "terms_mean_s": _means(self._term_sums, self._agg_steps),
            "tick_terms_mean_s": _means(self._tick_term_sums,
                                        self._agg_ticks),
            "bandwidth_residuals": bw,
            "ring": {"capacity": self.flight.capacity,
                     "len": len(self.flight)},
            "flight_dumps": self.flight.dumps,
        }
