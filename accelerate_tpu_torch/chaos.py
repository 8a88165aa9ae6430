"""Deterministic fault injection for the training loop and the serving
engine.

Counterpart of ``accelerate_tpu/chaos.py``, kept as the port's own copy: a
seed-driven :class:`FaultInjector` whose schedule is a pure function of
``(seed, injection_point, tick, unit)`` (a counter-based splitmix64 hash
keyed by the point's name: no wall clock, no global RNG), so a chaos run
replays exactly, and the same ``(seed, rates, schedule)`` gives the same
``injected`` log in both packages, bit for bit.

Training injection points, drawn by the fault-tolerance manager when
``FaultToleranceKwargs(chaos=...)`` arms it (``fault_tolerance.py``):

- ``train_step``: after each prepared step (``tick`` the manager's
  monotonic observe count, ``unit`` the process index):
  ``nonfinite_grad`` (the metrics the divergence sentinel sees turn NaN;
  the model is untouched, so a rollback replays bit-equal), ``slow_step``
  (a host-side sleep the watchdog must name) and ``bit_flip`` (the
  observed integrity digest goes wrong but finite, ``sdc.py``);
- ``collective_op``: before the watchdog's gang heartbeat (``slow_step``);
- ``checkpoint_save``: inside the save-retry loop (``tick`` the save
  index, ``unit`` the attempt; ``torn_write`` raises, so a torn first
  attempt retries clean);
- ``dataloader_batch``: at the loader's device boundary
  (``corrupt_batch`` NaN-poisons the batch's floating tensors);
- ``host_heartbeat``: ``dead_host`` exits the process with the entry's
  ``exit_code`` (default :data:`DEAD_HOST_DEFAULT_EXIT_CODE`).

Serving injection points, drawn by ``ServingEngine(chaos=...)``:
``prefill_dispatch`` (``transfer_error``: the chunk's dispatch raises),
``decode_tick`` (``poison``: a live slot's KV rows turn NaN for the decode
sentinel; ``bit_flip``: one emitted token is XOR'd with 1 after the host
read, which only the decode canary sees) and ``draft_mismatch``
(``poison``: one slot's n-gram history is blanked; output stays equal).
The other points and kinds of the JAX package (disaggregated serving,
publication, autoscaling, the journal, the fleet) are validated here so
that one schedule is accepted by both packages; the port's modules that
draw them come with ROADMAP.md Queue A item 12's later sub-items.

Off by default: no injector exists unless one is constructed and passed,
and every hook is one ``is None`` check.
"""

from __future__ import annotations

import logging
import zlib
from typing import Callable, NamedTuple, Optional

logger = logging.getLogger(__name__)

__all__ = [
    "Fault",
    "FaultInjector",
    "InjectedFaultError",
    "INJECTION_POINTS",
    "FAULT_KINDS",
    "DEAD_HOST_DEFAULT_EXIT_CODE",
    "deterministic_jitter",
    "flush_injected_log",
]

INJECTION_POINTS = (
    # serving
    "prefill_dispatch",
    "decode_tick",
    "handoff_device_put",
    "lane_health",
    # training (fault_tolerance.py hooks)
    "train_step",
    "collective_op",
    "checkpoint_save",
    "dataloader_batch",
    "host_heartbeat",
    # weight publication (publish.py)
    "publish_manifest",
    "publish_transfer",
    "canary_window",
    # autoscaling (autoscale.py + the disagg live resize)
    "autoscale_decide",
    "resize_transfer",
    "load_spike",
    # crash-durable serving (journal.py + the engines' hard-crash path)
    "journal_append",
    "journal_compact",
    "engine_crash",
    # fleet routing (fleet.py): whole-cell death, partition, heartbeat loss
    "cell_crash",
    "cell_partition",
    "router_heartbeat",
    # speculative decoding + quantized KV pages (serving.py / disagg.py)
    "draft_mismatch",
    "page_dequant",
)

FAULT_KINDS = (
    "transfer_error", "delay", "dead_lane", "poison",
    "nonfinite_grad", "slow_step", "torn_write", "corrupt_batch", "dead_host",
    "slo_regression", "version_mismatch", "flap", "spike", "crash",
    "bit_flip",
)

# An injected dead host exits 139 (128 + SIGSEGV) unless the schedule entry
# picks another code: the supervisor's classifier reads 128+signal codes as
# hardware-ish death, distinct from a clean deterministic crash.
DEAD_HOST_DEFAULT_EXIT_CODE = 139

# Which kinds make sense where — rates naming other combos are rejected at
# construction so a typo'd chaos spec fails loudly, not silently-never-fires.
_POINT_KINDS = {
    "prefill_dispatch": ("transfer_error",),
    # decode_tick bit_flip (sdc.py): the emitted token for one live slot is
    # XOR'd with 1 after the host fetch — wrong-but-finite output the decode
    # canary must catch bit-wise (NaN sentinels never see it).
    "decode_tick": ("poison", "bit_flip"),
    "handoff_device_put": ("transfer_error", "delay", "poison"),
    "lane_health": ("dead_lane",),
    # train_step bit_flip (sdc.py): the host-observed integrity digest on the
    # targeted rank is corrupted — finite, so only cross-replica voting sees
    # it. ``Fault.extra`` carries ``mode`` ("transient"|"sticky") and
    # optionally ``rank``/``leaf``; sticky also trips the redundant-compute
    # probe, convicting the silicon (SDC_EXIT_CODE).
    "train_step": ("nonfinite_grad", "slow_step", "bit_flip"),
    "collective_op": ("slow_step",),
    "checkpoint_save": ("torn_write",),
    "dataloader_batch": ("corrupt_batch",),
    "host_heartbeat": ("dead_host",),
    # Weight publication (publish.py): a torn/mismatched manifest skips the
    # checkpoint (old version keeps serving), a transfer error drives the
    # retry/backoff -> abort-publish path, and an injected SLO regression
    # forces the canary decision to roll back.
    "publish_manifest": ("torn_write", "version_mismatch"),
    "publish_transfer": ("transfer_error",),
    "canary_window": ("slo_regression",),
    # Autoscaling (autoscale.py): a flap inverts one sample's band reading
    # (the consecutive-breach damper must absorb it), a spike inflates one
    # sample's load signals, and a resize transfer_error/delay drives the
    # live resize's retry/backoff -> clean-abort path.
    "autoscale_decide": ("flap",),
    "resize_transfer": ("transfer_error", "delay"),
    "load_spike": ("spike",),
    # Crash-durable serving (journal.py): a torn journal append is re-written
    # whole after the detected short write (the replay-side checksum-skip path
    # gets coverage), a torn compaction aborts cleanly with the sealed
    # segments untouched, and an engine_crash hard-exits the serving process
    # (SERVING_CRASH_EXIT_CODE, or the entry's ``exit_code``) after flushing
    # telemetry + this injector's log — the supervisor relaunch + journal
    # recovery path.
    "journal_append": ("torn_write",),
    "journal_compact": ("torn_write",),
    "engine_crash": ("crash",),
    # Fleet routing (fleet.py): a cell_crash hard-kills an entire cell
    # mid-trace (its engine is abandoned, journal unsealed — the router's
    # exactly-once cross-cell drain path), a cell_partition makes a cell
    # unreachable from the router for ``Fault.extra["delay_ticks"]`` ticks
    # (degraded: it keeps ticking, takes no new admissions, its finished
    # rows surface when the partition heals), and a router_heartbeat delay
    # skips one health-reclassification pass (stale states for a tick).
    "cell_crash": ("crash",),
    "cell_partition": ("delay",),
    "router_heartbeat": ("delay",),
    # Speculative decoding (serving.py): a draft_mismatch poison wipes one
    # decoding slot's n-gram history (-1 fill), collapsing its acceptance
    # rate to the floor — output must stay bit-equal, only throughput and
    # the acceptance telemetry move (the verifiable property).
    "draft_mismatch": ("poison",),
    # Quantized KV pages (disagg.py): a page_dequant poison NaNs the
    # handed-off page's dequant scales, so the decode side's in-kernel
    # dequantize propagates NaN into attention — the existing poison-slot
    # quarantine/retry machinery must catch it.
    "page_dequant": ("poison",),
}

_MASK = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    """The splitmix64 finalizer — the counter-based PRNG core that makes a
    draw a pure function of its inputs."""
    x = (x + 0x9E3779B97F4A7C15) & _MASK
    z = x
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK
    return (z ^ (z >> 31)) & _MASK


def _u01(*parts) -> float:
    """Uniform in [0, 1) from an arbitrary (seed, str/int, ...) tuple —
    deterministic across processes and platforms (no hash randomization:
    strings go through crc32)."""
    h = 0
    for p in parts:
        if isinstance(p, str):
            p = zlib.crc32(p.encode("utf-8"))
        h = _splitmix64((h ^ (int(p) & _MASK)) & _MASK)
    return h / float(1 << 64)


def deterministic_jitter(seed: int, tick: int, attempt: int) -> float:
    """Jitter factor in [0.5, 1.0) for retry backoff — deterministic in its
    inputs so a chaos replay backs off identically."""
    return 0.5 + 0.5 * _u01(seed, "backoff", tick, attempt)


def flush_injected_log(injector, telemetry) -> None:
    """Hard-exit hygiene, shared by every injected process death (serving's
    ``engine_crash`` and training's ``dead_host``): push the injector's full
    ``injected`` log through the telemetry recorder AND close it before
    ``os._exit``, so the post-mortem fault schedule is never torn. Best
    effort on every edge — a dying process must still die."""
    if telemetry is not None:
        if injector is not None:
            try:
                telemetry.record_event(
                    "chaos_injected_log", seed=injector.seed,
                    injected=list(injector.injected),
                    summary=injector.summary(),
                )
            except Exception:  # pragma: no cover - dying anyway
                logger.exception("chaos: injected-log flush failed")
            prof = getattr(telemetry, "profiler", None)
            if prof is not None:
                # The flight bundle (profiler.py) carries the fault
                # schedule that killed the run next to the last attribution
                # records — the dump itself happens at the exit site.
                try:
                    prof.note_gauge("chaos", {
                        "seed": injector.seed,
                        "injected": injector.summary().get("injected"),
                        "last": (list(injector.injected)[-3:]
                                 if injector.injected else []),
                    })
                except Exception:  # pragma: no cover - dying anyway
                    pass
        try:
            telemetry.close()
        except Exception:  # pragma: no cover - dying anyway
            pass


class Fault(NamedTuple):
    """One drawn fault. ``u`` is the residual uniform the engine uses for
    deterministic sub-decisions (e.g. transient vs persistent transfer
    errors) without another RNG. ``extra`` carries a schedule entry's
    pass-through fields (``seconds`` for ``slow_step``, ``exit_code`` for
    ``dead_host``); rate-driven faults leave it None."""

    point: str
    kind: str
    tick: int
    unit: int
    u: float
    extra: Optional[dict] = None


class InjectedFaultError(RuntimeError):
    """Raised at an injection site to model a transfer/dispatch failure.
    Subclasses RuntimeError so the engines' recovery paths treat injected
    and real (CUDA runtime) failures identically."""

    def __init__(self, fault: Fault):
        super().__init__(
            f"injected {fault.kind} at {fault.point} "
            f"(tick {fault.tick}, unit {fault.unit})"
        )
        self.fault = fault


class FaultInjector:
    """Seed-driven deterministic fault schedule.

    - ``rates``: ``{point: {kind: probability}}`` (or ``{point: prob}``,
      which takes the point's first legal kind). Each ``draw(point, tick,
      unit)`` maps ``(seed, point, tick, unit)`` through a counter-based
      hash to one uniform — no draw ever observes another draw, so the
      schedule is independent of call order and replays exactly.
    - ``schedule``: explicit one-shot faults —
      ``{"point", "kind", "tick"?, "unit"?, "count"?}``. Omitted ``tick`` /
      ``unit`` match the first opportunity; ``count`` (default 1) fires the
      entry that many times. The smoke uses this for "one dead prefill
      lane".
    - ``delay_ticks``: how many ticks a ``delay`` fault defers a handoff's
      background insert.
    - ``slow_step_s``: seconds a rate-driven ``slow_step`` fault sleeps
      (schedule entries override per-fault via ``{"seconds": ...}``).

    Schedule entries may carry pass-through fields beyond the matchers —
    ``seconds`` (slow_step) and ``exit_code`` (dead_host) ride on
    :attr:`Fault.extra`.

    ``injected`` logs every fault actually drawn, in draw order — two runs
    with the same seed, config, and trace produce identical logs (pinned by
    tests/test_torch_chaos.py against the JAX package's injector).
    """

    def __init__(self, seed: int = 0, rates: Optional[dict] = None,
                 schedule: Optional[list] = None, delay_ticks: int = 3,
                 slow_step_s: float = 0.1):
        self.seed = int(seed)
        self.delay_ticks = int(delay_ticks)
        if self.delay_ticks < 1:
            raise ValueError(f"delay_ticks must be >= 1, got {delay_ticks}")
        self.slow_step_s = float(slow_step_s)
        if self.slow_step_s < 0:
            raise ValueError(f"slow_step_s must be >= 0, got {slow_step_s}")
        self.rates: dict[str, dict[str, float]] = {}
        for point, spec in (rates or {}).items():
            if point not in INJECTION_POINTS:
                raise ValueError(
                    f"unknown injection point {point!r}; known: "
                    f"{INJECTION_POINTS}"
                )
            legal = _POINT_KINDS[point]
            if not isinstance(spec, dict):
                spec = {legal[0]: float(spec)}
            for kind, prob in spec.items():
                if kind not in legal:
                    raise ValueError(
                        f"fault kind {kind!r} is not injectable at {point!r}; "
                        f"legal: {legal}"
                    )
                if not 0.0 <= float(prob) <= 1.0:
                    raise ValueError(
                        f"probability for {point}/{kind} must be in [0, 1], "
                        f"got {prob}"
                    )
            total = sum(float(p) for p in spec.values())
            if total > 1.0:
                raise ValueError(
                    f"probabilities at {point!r} sum to {total} > 1"
                )
            self.rates[point] = {k: float(v) for k, v in spec.items()}
        self._schedule: list[dict] = []
        for entry in (schedule or []):
            e = dict(entry)
            point, kind = e.get("point"), e.get("kind")
            if point not in INJECTION_POINTS:
                raise ValueError(f"schedule entry has unknown point {point!r}")
            if kind not in _POINT_KINDS[point]:
                raise ValueError(
                    f"schedule entry {kind!r} not injectable at {point!r}; "
                    f"legal: {_POINT_KINDS[point]}"
                )
            e.setdefault("count", 1)
            # Anything beyond the matcher keys rides on Fault.extra (e.g.
            # seconds= for slow_step, exit_code= for dead_host).
            e["extra"] = {
                k: v for k, v in e.items()
                if k not in ("point", "kind", "tick", "unit", "count", "extra")
            } or None
            self._schedule.append(e)
        self.injected: list[dict] = []
        # Optional annotation callback (tracing.py attaches here): called
        # with each injected fault's log record so the trace can mark the
        # span the fault hit. Never allowed to break an injection site.
        self.on_inject: Optional[Callable[[dict], None]] = None

    # -- the draw ----------------------------------------------------------

    def draw(self, point: str, tick: int, unit: int = 0) -> Optional[Fault]:
        """One fault decision at ``point`` on scheduler ``tick`` for ``unit``
        (a lane index / request id — disambiguates multiple same-point draws
        within one tick). Returns the :class:`Fault` or None."""
        tick, unit = int(tick), int(unit)
        u = _u01(self.seed, point, tick, unit)
        # Explicit schedule first: the one-shot faults a test pins exactly.
        for entry in self._schedule:
            if entry["count"] <= 0 or entry["point"] != point:
                continue
            if entry.get("tick") is not None and int(entry["tick"]) != tick:
                continue
            if entry.get("unit") is not None and int(entry["unit"]) != unit:
                continue
            entry["count"] -= 1
            return self._log(
                Fault(point, entry["kind"], tick, unit, u, entry["extra"])
            )
        # Rate-driven: walk the point's kinds in declaration order against
        # the single uniform — cumulative, so at most one kind fires.
        acc = 0.0
        for kind, prob in self.rates.get(point, {}).items():
            acc += prob
            if u < acc:
                return self._log(Fault(point, kind, tick, unit, u))
        return None

    def _log(self, fault: Fault) -> Fault:
        rec = {
            "tick": fault.tick, "point": fault.point, "kind": fault.kind,
            "unit": fault.unit,
        }
        self.injected.append(rec)
        if self.on_inject is not None:
            try:
                self.on_inject(rec)
            except Exception:
                logger.exception("chaos on_inject callback failed")
        return fault

    # -- reporting ---------------------------------------------------------

    def summary(self) -> dict:
        """Counts by (point, kind) plus the full ordered log length — the
        chaos side of the telemetry ``faults`` block."""
        by: dict[str, int] = {}
        for f in self.injected:
            key = f"{f['point']}:{f['kind']}"
            by[key] = by.get(key, 0) + 1
        return {"injected": len(self.injected), "by_site": dict(sorted(by.items()))}
