"""Request-scoped tracing with critical-path SLO attribution (counterpart
of ``accelerate_tpu/tracing.py``, with its span schema, hooks, Chrome-trace
layout and metric names, so one reader parses both packages' traces).

``TraceRecorder`` records spans keyed by request id across a request's
life in the serving engine (queued, each prefill chunk, each decode tick
tagged with its ``weights_version``, retries, quarantines, the finish) and
engine-level spans: checkpoint saves, loads and verifications, rollbacks,
watchdog stalls (forwarded from ``TelemetryRecorder.record_event``),
recovery from the journal, and chaos injections annotated onto the span
they hit. The handoff hooks serve the disaggregated router, which the
port does not have yet (ROADMAP.md Queue A item 12.6).

Three consumers:

- ``explain(request_id)``: the request's measured TTFT split into queue
  wait, prefill compute, handoff, retry backoff and the stall remainder;
  the terms are disjoint sub-intervals, so they sum to the TTFT by
  construction, and the largest is named.
- ``export_chrome_trace(path)``: Chrome trace JSON (Perfetto), one pid per
  subsystem, one tid per lane or slot, flow events from a KV handoff to
  its insert.
- ``metrics_text()``: the metrics hub's Prometheus text (``profiler.py``).

Two clocks: each span carries the engine's tick counter and, unless
``TraceConfig(wall_clock=False)``, ``time.perf_counter`` walls. The
tick-domain projection ``tick_trace()`` holds only deterministic fields,
so a seeded run gives the same trace twice. Every hook is host Python on
host clocks: tracing reads nothing from the device, and without a
recorder each site is one ``is None`` check.
"""

from __future__ import annotations

import json
import logging
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

logger = logging.getLogger(__name__)

__all__ = ["TraceConfig", "TraceRecorder", "Span"]

# Subsystem -> Chrome trace pid. Stable small integers so two runs of the
# same workload produce identical metadata, and so Perfetto groups tracks
# the same way every time.
_PIDS = {
    "serving": 1,
    "prefill": 2,
    "handoff": 3,
    "decode": 4,
    "resize": 5,
    "publish": 6,
    "autoscale": 7,
    "checkpoint": 8,
    "chaos": 9,
    "watchdog": 10,
}


def _lane_id(lane: Any) -> Any:
    """Normalize a lane argument to its integer id: callers may pass the
    engine's internal lane object (disagg ``_Lane``) — spans must only carry
    JSON-serializable attrs."""
    if lane is None or isinstance(lane, (int, str)):
        return lane
    idx = getattr(lane, "index", None)
    return idx if idx is not None else str(lane)


@dataclass
class TraceConfig:
    """Config for :class:`TraceRecorder`.

    Attributes:
        enabled: master switch; a falsy config means no recorder is built.
        max_spans: hard cap on retained spans. Past it new spans are
            counted in ``dropped_spans`` (deterministically — the cap is
            hit at the same span index on a seeded replay) and a single
            warning is logged.
        wall_clock: record ``time.perf_counter()`` walls alongside the
            tick clock. Disable for strictly tick-domain traces;
            ``explain()`` then has no wall terms to attribute.
        max_requests: cap on per-request accounting entries retained for
            ``explain()``; oldest finished requests are evicted first.
    """

    enabled: bool = True
    max_spans: int = 200_000
    wall_clock: bool = True
    max_requests: int = 10_000

    @classmethod
    def from_value(cls, value: Any) -> Optional["TraceConfig"]:
        """Coerce a ``TelemetryKwargs.tracing`` value into a config.

        Accepts ``True`` (defaults), a dict of field overrides, an
        existing ``TraceConfig``, or falsy (disabled -> ``None``).
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
            f"tracing must be bool, dict, or TraceConfig, got {type(value).__name__}"
        )


class Span:
    """One span. ``seq`` is a monotone id assigned at creation, which makes

    span ordering deterministic in the tick domain (creation order follows
    engine execution order, which is deterministic for tick-driven
    workloads). Wall fields (``t0``/``t1``) live outside the deterministic
    projection returned by ``tick_trace()``.
    """

    __slots__ = (
        "seq", "subsystem", "name", "kind", "tid", "request_id",
        "start_tick", "end_tick", "t0", "t1", "attrs", "flow",
    )

    def __init__(self, seq, subsystem, name, kind, tid, request_id,
                 start_tick, t0, attrs):
        self.seq = seq
        self.subsystem = subsystem
        self.name = name
        self.kind = kind
        self.tid = tid
        self.request_id = request_id
        self.start_tick = start_tick
        self.end_tick = start_tick
        self.t0 = t0
        self.t1 = t0
        self.attrs = attrs
        self.flow = None  # flow id for Chrome "s"/"f" stitching

    def tick_view(self) -> Dict[str, Any]:
        """Deterministic projection: no wall clocks, sorted attrs."""
        return {
            "seq": self.seq,
            "subsystem": self.subsystem,
            "name": self.name,
            "kind": self.kind,
            "tid": self.tid,
            "request_id": self.request_id,
            "start_tick": self.start_tick,
            "end_tick": self.end_tick,
            "attrs": dict(sorted(self.attrs.items())) if self.attrs else {},
        }


class _ReqTrace:
    """Per-request critical-path accumulator.

    Wall durations are accumulated *directly by the hooks* rather than
    re-derived from the span tree — backoff sleeps happen inside prefill
    dispatch walls, so deriving from spans would double count. The terms
    are disjoint measured sub-intervals of ``[submit_t, first_token_t]``;
    the stall term is the telescoping remainder, which makes the
    decomposition sum to the measured TTFT exactly.
    """

    __slots__ = (
        "id", "submit_t", "enqueue_t", "admit_t", "first_token_t", "done_t",
        "submit_tick", "done_tick", "status", "deadline_s",
        "queue_wait_s", "prefill_active_s", "handoff_s", "backoff_s",
        "decode_ticks", "retries", "prompt_tokens", "new_tokens",
        "weights_version", "canary", "lanes", "slot", "ttft_s",
        "drafted", "accepted",
    )

    def __init__(self, rid, tick, t, prompt_tokens, deadline_s):
        self.id = rid
        self.submit_t = t
        self.enqueue_t = t
        self.admit_t = None
        self.first_token_t = None
        self.done_t = None
        self.submit_tick = tick
        self.done_tick = None
        self.status = "queued"
        self.deadline_s = deadline_s
        self.queue_wait_s = 0.0
        self.prefill_active_s = 0.0
        self.handoff_s = 0.0
        self.backoff_s = 0.0
        self.decode_ticks = 0
        self.retries = 0
        self.prompt_tokens = prompt_tokens
        self.new_tokens = 0
        self.weights_version = 0
        self.canary = False
        self.lanes = []
        self.slot = None
        self.ttft_s = None
        self.drafted = 0
        self.accepted = 0


class TraceRecorder:
    """Records request-scoped and engine-level spans; see module docstring.

    Hooks are grouped by caller:

    - serving.py: ``request_submitted`` / ``request_granted`` /
      ``prefill_chunk`` / ``first_token`` / ``decode_tick`` /
      ``request_retry`` / ``quarantine`` / ``request_finished``, and
      ``begin``/``end`` around ``recover()``
    - the disaggregated router (not ported yet): ``handoff`` /
      ``handoff_retry`` / ``handoff_flush`` / ``handoff_insert``
    - telemetry.py: ``on_event``; any caller: ``begin``/``end`` /
      ``instant``
    - chaos.py: ``attach_chaos`` wires ``FaultInjector.on_inject`` to
      ``on_fault`` so injections annotate the span they hit.
    """

    def __init__(self, config: Optional[TraceConfig] = None, *, hub=None):
        self.config = config or TraceConfig()
        self._spans: List[Span] = []
        self._seq = 0
        self._dropped = 0
        self._warned_drop = False
        # Per-request accounting for explain(); insertion-ordered so
        # eviction drops the oldest finished request first.
        self._requests: Dict[int, _ReqTrace] = {}
        # Open queued-span per request id (closed at grant/finish).
        self._open_req: Dict[int, Span] = {}
        # Stack of open engine-level spans (begin/end discipline) plus a
        # detached set for spans that outlive their begin scope (layout
        # drains, canary windows).
        self._stack: List[Span] = []
        self._open: Dict[int, Span] = {}
        self._flow_seq = 0
        # Pending chaos annotation: a fault drawn with no open engine
        # span annotates the *next* span recorded for its unit (the retry
        # or decode-tick span the fault manifests as).
        self._pending_fault: Optional[Dict[str, Any]] = None
        self._chaos_seed: Optional[int] = None
        self._counts: Dict[str, int] = {}
        # Prometheus exposition lives on the metrics hub (profiler.py): the
        # recorder registers its stats as the "tracing" provider, its span
        # counters as a text block, and the JAX package's older
        # accelerate_tpu_trace_* names as aliases.
        from .profiler import MetricsHub

        self.hub = hub if hub is not None else MetricsHub()
        self.hub.register_provider("tracing", self.stats, replace=True)
        self.hub.register_text(self._span_metric_lines)
        self.hub.alias("accelerate_tpu_trace_dropped_spans_total",
                       "accelerate_tpu_tracing_dropped_spans")
        self.hub.alias("accelerate_tpu_trace_requests",
                       "accelerate_tpu_tracing_requests")

    # ------------------------------------------------------------------
    # span plumbing
    # ------------------------------------------------------------------
    def _now(self) -> Optional[float]:
        return time.perf_counter() if self.config.wall_clock else None

    def _new_span(self, subsystem, name, kind, tick, *, tid=None,
                  request_id=None, t=None, attrs=None) -> Optional[Span]:
        if len(self._spans) >= self.config.max_spans:
            self._dropped += 1
            if not self._warned_drop:
                self._warned_drop = True
                logger.warning(
                    "TraceRecorder hit max_spans=%d; further spans are "
                    "dropped (counted in stats()['dropped_spans'])",
                    self.config.max_spans,
                )
            return None
        span = Span(self._seq, subsystem, name, kind, tid, request_id,
                    tick, t if t is not None else self._now(),
                    attrs if attrs is not None else {})
        self._seq += 1
        self._spans.append(span)
        self._counts[kind] = self._counts.get(kind, 0) + 1
        pending = self._pending_fault
        if pending is not None and subsystem != "chaos" and (
            request_id is None or pending.get("unit") in (0, request_id)
        ):
            span.attrs.update(injected=True, point=pending["point"],
                              kind=pending["kind"],
                              seed=pending.get("seed"))
            self._pending_fault = None
        return span

    def _touch_request(self, rid) -> Optional[_ReqTrace]:
        return self._requests.get(rid)

    def _evict_requests(self) -> None:
        while len(self._requests) > self.config.max_requests:
            for rid, rt in self._requests.items():
                if rt.done_t is not None:
                    del self._requests[rid]
                    break
            else:
                # All in flight: evict the oldest outright.
                del self._requests[next(iter(self._requests))]

    # ------------------------------------------------------------------
    # generic engine-level spans (resize/publish/checkpoint phases)
    # ------------------------------------------------------------------
    def begin(self, subsystem: str, name: str, tick: int, *, tid=None,
              request_id=None, detached: bool = False, **attrs) -> Optional[int]:
        """Open an engine-level span; returns a handle for :meth:`end`.

        ``detached=True`` keeps the span off the nesting stack so it can
        outlive its begin scope (e.g. a layout drain that ends ticks
        later) without being force-closed by an enclosing ``end``.
        """
        span = self._new_span(subsystem, name, "phase", tick, tid=tid,
                              request_id=request_id, attrs=attrs)
        if span is None:
            return None
        self._open[span.seq] = span
        if not detached:
            self._stack.append(span)
        return span.seq

    def end(self, handle: Optional[int], tick: int, **attrs) -> None:
        """Close a span opened by :meth:`begin`.

        Also force-closes any still-open *stacked* spans begun after it
        (abort paths unwind cleanly without per-phase bookkeeping).
        """
        if handle is None:
            return
        span = self._open.pop(handle, None)
        if span is None:
            return
        if span in self._stack:
            while self._stack and self._stack[-1].seq > span.seq:
                inner = self._stack.pop()
                self._open.pop(inner.seq, None)
                inner.end_tick = tick
                inner.t1 = self._now()
            if self._stack and self._stack[-1] is span:
                self._stack.pop()
        span.end_tick = tick
        span.t1 = self._now()
        if attrs:
            span.attrs.update(attrs)

    def instant(self, subsystem: str, name: str, tick: int, *, tid=None,
                request_id=None, **attrs) -> None:
        """Record a zero-duration span (events: quarantine, decisions...)."""
        self._new_span(subsystem, name, "instant", tick, tid=tid,
                       request_id=request_id, attrs=attrs)

    # ------------------------------------------------------------------
    # request lifecycle hooks (serving.py)
    # ------------------------------------------------------------------
    def request_submitted(self, rid: int, tick: int, t: Optional[float], *,
                          prompt_tokens: int, budget: int,
                          deadline_s: Optional[float] = None) -> None:
        rt = _ReqTrace(rid, tick, t, prompt_tokens, deadline_s)
        self._requests[rid] = rt
        self._evict_requests()
        span = self._new_span("serving", "queued", "queued", tick,
                              tid="queue", request_id=rid, t=t,
                              attrs={"prompt_tokens": prompt_tokens,
                                     "budget": budget})
        if span is not None:
            self._open_req[rid] = span

    def request_granted(self, rid: int, tick: int, t: Optional[float], *,
                        slot, lane, weights_version: int,
                        canary: bool) -> None:
        lane = _lane_id(lane)
        rt = self._touch_request(rid)
        if rt is not None:
            rt.admit_t = t
            if t is not None and rt.enqueue_t is not None:
                rt.queue_wait_s += t - rt.enqueue_t
            rt.status = "admitted"
            rt.weights_version = weights_version
            rt.canary = canary
            rt.slot = slot
            if lane is not None and lane not in rt.lanes:
                rt.lanes.append(lane)
        span = self._open_req.pop(rid, None)
        if span is not None:
            span.end_tick = tick
            span.t1 = t if t is not None else self._now()
            span.attrs.update(slot=slot, lane=lane,
                              weights_version=weights_version, canary=canary)

    def prefill_chunk(self, rid: int, tick: int, t0: Optional[float],
                      t1: Optional[float], *, size: int, valid: int,
                      lane, slot, index: int, final: bool) -> None:
        lane = _lane_id(lane)
        rt = self._touch_request(rid)
        if rt is not None and t0 is not None and t1 is not None:
            rt.prefill_active_s += t1 - t0
            if lane is not None and lane not in rt.lanes:
                rt.lanes.append(lane)
        span = self._new_span(
            "prefill", f"chunk[{size}]", "prefill_chunk", tick,
            tid=(f"lane {lane}" if lane is not None else f"slot {slot}"),
            request_id=rid, t=t0,
            attrs={"size": size, "valid": valid, "index": index,
                   "final": final, "lane": lane, "slot": slot})
        if span is not None:
            span.end_tick = tick
            span.t1 = t1

    def first_token(self, rid: int, tick: int, t: Optional[float]) -> None:
        rt = self._touch_request(rid)
        if rt is not None:
            rt.first_token_t = t
            if t is not None and rt.submit_t is not None:
                rt.ttft_s = t - rt.submit_t
            rt.status = "decoding"

    def decode_tick(self, tick: int, t0: Optional[float],
                    t1: Optional[float], *, weights_version: int,
                    occupancy: int, n_slots: int,
                    request_ids=(), drafted: int = 0,
                    accepted: int = 0) -> None:
        attrs = {"weights_version": weights_version,
                 "occupancy": occupancy, "n_slots": n_slots}
        if drafted:
            # Speculation attribution: how many draft tokens this tick's
            # single verify forward covered and how many survived.
            attrs["drafted"] = drafted
            attrs["accepted"] = accepted
        span = self._new_span(
            "decode", f"decode v{weights_version}", "decode_tick", tick,
            tid="decode", t=t0, attrs=attrs)
        if span is not None:
            span.end_tick = tick
            span.t1 = t1
        for rid in request_ids:
            rt = self._touch_request(rid)
            if rt is not None:
                rt.decode_ticks += 1

    def request_retry(self, rid: int, tick: int, *, reason: str,
                      attempt: int, t: Optional[float] = None) -> None:
        rt = self._touch_request(rid)
        if rt is not None:
            rt.retries = attempt
            rt.enqueue_t = t if t is not None else self._now()
            rt.status = "requeued"
        self.instant("serving", f"retry[{reason}]", tick, tid="queue",
                     request_id=rid, reason=reason, attempt=attempt)

    def quarantine(self, kind: str, unit, tick: int, *,
                   request_id=None, **attrs) -> None:
        self.instant("serving", f"quarantine[{kind}]", tick,
                     tid=f"{kind} {unit}", request_id=request_id,
                     unit=unit, **attrs)

    def request_finished(self, rid: int, tick: int, t: Optional[float], *,
                         status: str, new_tokens: int,
                         weights_version: int, drafted: int = 0,
                         accepted: int = 0) -> None:
        rt = self._touch_request(rid)
        if rt is not None:
            rt.done_t = t
            rt.done_tick = tick
            rt.status = status
            rt.new_tokens = new_tokens
            rt.weights_version = weights_version
            rt.drafted = drafted
            rt.accepted = accepted
            if drafted:
                self.instant("decode", "speculation", tick, tid="decode",
                             request_id=rid, drafted=drafted,
                             accepted=accepted,
                             rejected=drafted - accepted)
        # A request shed/failed while queued still holds an open span.
        span = self._open_req.pop(rid, None)
        if span is not None:
            span.end_tick = tick
            span.t1 = t if t is not None else self._now()
            span.attrs["status"] = status
        fin = self._new_span("serving", f"finish[{status}]", "finish", tick,
                             tid="queue", request_id=rid, t=t,
                             attrs={"status": status,
                                    "new_tokens": new_tokens,
                                    "weights_version": weights_version})
        if fin is not None:
            fin.t1 = fin.t0

    # ------------------------------------------------------------------
    # disagg hooks: handoff transfer + retries + insert flow
    # ------------------------------------------------------------------
    def handoff(self, rid: int, tick: int, t0: Optional[float],
                t1: Optional[float], *, lane, slot, nbytes: int,
                final: bool) -> Optional[int]:
        """KV handoff dispatched from a prefill lane; returns a flow id

        the engine threads to :meth:`handoff_insert` when the transfer
        lands in the decode cache, stitching the two sides in the
        Chrome export.
        """
        span = self._new_span(
            "handoff", "kv_handoff", "handoff", tick,
            tid=f"lane {lane}", request_id=rid, t=t0,
            attrs={"lane": lane, "slot": slot, "nbytes": nbytes,
                   "final": final})
        if span is None:
            return None
        span.end_tick = tick
        span.t1 = t1
        self._flow_seq += 1
        span.flow = self._flow_seq
        return self._flow_seq

    def handoff_retry(self, rid: int, tick: int, *, attempt: int,
                      backoff_s: float, lane,
                      measured_s: Optional[float] = None) -> None:
        """One handoff retry: ``backoff_s`` is the deterministic computed

        backoff (recorded in span attrs for the tick-domain trace);
        ``measured_s`` is the measured sleep wall charged to the
        request's backoff term (falls back to ``backoff_s``).
        """
        rt = self._touch_request(rid)
        if rt is not None:
            rt.backoff_s += measured_s if measured_s is not None else backoff_s
        span = self._new_span(
            "handoff", f"retry[{attempt}]", "handoff_retry", tick,
            tid=f"lane {lane}", request_id=rid,
            attrs={"attempt": attempt, "lane": lane,
                   "backoff_s": round(backoff_s, 9)})
        if span is not None:
            span.end_tick = tick
            span.t1 = self._now()

    def handoff_flush(self, rid: int, tick: int, t0: Optional[float],
                      t1: Optional[float]) -> None:
        """Final-chunk forced drain wall, charged to the handoff term."""
        rt = self._touch_request(rid)
        if rt is not None and t0 is not None and t1 is not None:
            rt.handoff_s += t1 - t0
        span = self._new_span("handoff", "flush", "handoff_flush", tick,
                              request_id=rid, t=t0, tid="drain", attrs={})
        if span is not None:
            span.end_tick = tick
            span.t1 = t1

    def handoff_insert(self, tick: int, *, slot, flow: Optional[int],
                       request_id=None, armed: bool = False) -> None:
        span = self._new_span(
            "decode", "kv_insert", "handoff_insert", tick,
            tid=f"slot {slot}", request_id=request_id,
            attrs={"slot": slot, "armed": armed})
        if span is not None:
            span.t1 = span.t0
            span.flow = flow

    # ------------------------------------------------------------------
    # chaos annotation
    # ------------------------------------------------------------------
    def attach_chaos(self, injector) -> None:
        """Wire a ``FaultInjector`` so every injection annotates the span

        it hits (``injected=true`` + point/kind/seed): if an engine-level
        span is open the annotation lands there, otherwise it is held for
        the next span recorded for the fault's unit (the retry or decode
        tick the fault manifests as). An instant chaos span is always
        recorded so injections are visible even when nothing absorbs them.
        """
        self._chaos_seed = getattr(injector, "seed", None)
        injector.on_inject = self.on_fault

    def on_fault(self, fault: Dict[str, Any]) -> None:
        try:
            info = {"point": fault.get("point"), "kind": fault.get("kind"),
                    "unit": fault.get("unit", 0), "seed": self._chaos_seed}
            tick = fault.get("tick", 0)
            self.instant("chaos", f"{info['point']}:{info['kind']}", tick,
                         tid="inject", injected=True,
                         point=info["point"], kind=info["kind"],
                         unit=info["unit"], seed=info["seed"])
            if self._stack:
                self._stack[-1].attrs.update(
                    injected=True, point=info["point"],
                    kind=info["kind"], seed=info["seed"])
            else:
                self._pending_fault = info
        except Exception:  # never let tracing break an injection site
            logger.exception("trace fault annotation failed")

    # ------------------------------------------------------------------
    # telemetry event forwarding (checkpoint/watchdog/publish records)
    # ------------------------------------------------------------------
    _EVENT_SUBSYSTEM = {
        "checkpoint_save": "checkpoint", "checkpoint_load": "checkpoint",
        "checkpoint_verify": "checkpoint",
        "checkpoint_save_retry": "checkpoint",
        "checkpoint_torn_skipped": "checkpoint",
        "preemption_save": "checkpoint", "rollback": "checkpoint",
        "checkpoint_fallback_save": "checkpoint",
        "checkpoint_async_error": "checkpoint",
        "training_stalled": "watchdog",
        "weights_published": "publish",
    }

    def on_event(self, event: str, fields: Dict[str, Any],
                 tick: int = 0) -> None:
        """Forward a telemetry ``record_event`` into the trace.

        Events with a ``seconds``-like duration become spans with that
        wall duration; the rest are instants. This is how checkpoint
        save/restore and watchdog stalls get spans without every caller
        growing a tracing kwarg.
        """
        subsystem = self._EVENT_SUBSYSTEM.get(event)
        if subsystem is None:
            return
        dur = None
        for key in ("seconds", "save_s", "load_s", "wall_s", "verify_s"):
            val = fields.get(key)
            if isinstance(val, (int, float)):
                dur = float(val)
                break
        attrs = {k: v for k, v in fields.items()
                 if isinstance(v, (int, float, str, bool)) and k != "time"}
        span = self._new_span(subsystem, event,
                              "event" if dur is None else "phase",
                              tick, tid=subsystem, attrs=attrs)
        if span is not None and dur is not None and span.t0 is not None:
            # The event is recorded *after* the work; backdate the start.
            span.t0 = span.t0 - dur
            span.t1 = span.t0 + dur

    # ------------------------------------------------------------------
    # consumer 1: explain(request_id)
    # ------------------------------------------------------------------
    def explain(self, request_id: int) -> Dict[str, Any]:
        """Critical-path SLO attribution for one request.

        Decomposes the measured TTFT (``first_token_t - submit_t``) into:

        - ``queue_wait_s``: submitted/requeued -> granted a slot
        - ``prefill_s``: chunk dispatch walls minus handoff/backoff
        - ``handoff_s``: KV handoff final-flush walls (disagg only)
        - ``backoff_s``: chaos-retry backoff sleeps (handoff retries)
        - ``stall_s``: the remainder — granted but not dispatching
          (prefill rotation across ticks, decode interleave, drain
          stalls during a resize)

        All five are disjoint sub-intervals of the TTFT window, so
        ``sum(terms) == ttft_s`` within float tolerance by construction
        (pinned by test). ``decode_s`` (first token -> done) is reported
        alongside but is not a TTFT term.
        """
        rt = self._requests.get(request_id)
        if rt is None:
            raise KeyError(f"request {request_id} not traced")
        n_spans = sum(1 for s in self._spans if s.request_id == request_id)
        out: Dict[str, Any] = {
            "request_id": request_id,
            "status": rt.status,
            "retries": rt.retries,
            "prompt_tokens": rt.prompt_tokens,
            "new_tokens": rt.new_tokens,
            "weights_version": rt.weights_version,
            "canary": rt.canary,
            "lanes": list(rt.lanes),
            "slot": rt.slot,
            "decode_ticks": rt.decode_ticks,
            "n_spans": n_spans,
            "ttft_s": rt.ttft_s,
            "terms": None,
            "dominant": None,
            "decode_s": None,
            "total_s": None,
            "deadline_s": rt.deadline_s,
            "deadline_missed": None,
            # Speculation is a decode-phase property, not a TTFT term:
            # accepted drafts shorten decode_s, never the TTFT window.
            "speculation": (
                {"drafted": rt.drafted, "accepted": rt.accepted,
                 "rejected": rt.drafted - rt.accepted}
                if rt.drafted else None
            ),
        }
        if rt.first_token_t is not None and rt.submit_t is not None:
            ttft = rt.first_token_t - rt.submit_t
            handoff = rt.handoff_s
            backoff = rt.backoff_s
            prefill = rt.prefill_active_s - handoff - backoff
            stall = ttft - rt.queue_wait_s - rt.prefill_active_s
            terms = {
                "queue_wait_s": rt.queue_wait_s,
                "prefill_s": prefill,
                "handoff_s": handoff,
                "backoff_s": backoff,
                "stall_s": stall,
            }
            out["ttft_s"] = ttft
            out["terms"] = terms
            out["dominant"] = max(terms, key=lambda k: terms[k])
        if rt.done_t is not None and rt.submit_t is not None:
            out["total_s"] = rt.done_t - rt.submit_t
            if rt.first_token_t is not None:
                out["decode_s"] = rt.done_t - rt.first_token_t
            if rt.deadline_s is not None:
                out["deadline_missed"] = out["total_s"] > rt.deadline_s
        return out

    # ------------------------------------------------------------------
    # consumer 2: Chrome trace (Perfetto) export
    # ------------------------------------------------------------------
    def chrome_trace(self) -> Dict[str, Any]:
        """Build the Chrome trace JSON object (see ``export_chrome_trace``)."""
        events: List[Dict[str, Any]] = []
        # Stable pid per subsystem, stable tid per (pid, thread-name).
        tids: Dict[tuple, int] = {}
        seen_pids: Dict[str, int] = {}
        extra_pid = max(_PIDS.values())

        def pid_of(subsystem: str) -> int:
            pid = _PIDS.get(subsystem)
            if pid is None:
                pid = seen_pids.get(subsystem)
                if pid is None:
                    nonlocal extra_pid
                    extra_pid += 1
                    pid = seen_pids[subsystem] = extra_pid
            return pid

        def tid_of(pid: int, name: Optional[str]) -> int:
            key = (pid, name or "main")
            tid = tids.get(key)
            if tid is None:
                tid = tids[key] = len([k for k in tids if k[0] == pid]) + 1
                events.append({"ph": "M", "pid": pid, "tid": tid,
                               "name": "thread_name",
                               "args": {"name": name or "main"}})
            return tid

        for subsystem, pid in sorted(_PIDS.items(), key=lambda kv: kv[1]):
            events.append({"ph": "M", "pid": pid, "tid": 0,
                           "name": "process_name",
                           "args": {"name": subsystem}})

        # Wall timestamps are relative to the first recorded wall so the
        # trace starts near t=0; spans without walls fall back to the
        # tick clock at 1 ms/tick so tick-only traces still render.
        base = min((s.t0 for s in self._spans if s.t0 is not None),
                   default=None)

        def ts_us(span: Span) -> tuple:
            if span.t0 is not None and base is not None:
                t0 = (span.t0 - base) * 1e6
                t1 = ((span.t1 - base) * 1e6
                      if span.t1 is not None else t0)
            else:
                t0 = span.start_tick * 1000.0
                t1 = span.end_tick * 1000.0
            return t0, max(t1 - t0, 0.0)

        for span in self._spans:
            pid = pid_of(span.subsystem)
            tid = tid_of(pid, span.tid)
            ts, dur = ts_us(span)
            args = {k: v for k, v in span.attrs.items()}
            if span.request_id is not None:
                args["request_id"] = span.request_id
            args["tick"] = span.start_tick
            ev = {"ph": "X", "pid": pid, "tid": tid, "name": span.name,
                  "cat": span.subsystem, "ts": round(ts, 3),
                  "dur": round(max(dur, 1.0), 3), "args": args}
            events.append(ev)
            if span.flow is not None:
                # Flow start at the producing side (handoff span on the
                # prefill lane), flow finish at the consuming side
                # (kv_insert on the decode slot). bp="e" binds the
                # finish to the enclosing slice.
                ph = "s" if span.kind == "handoff" else "f"
                flow_ev = {"ph": ph, "pid": pid, "tid": tid,
                           "name": "kv_handoff", "cat": "handoff",
                           "id": span.flow, "ts": round(ts, 3)}
                if ph == "f":
                    flow_ev["bp"] = "e"
                events.append(flow_ev)
        # The producer names the trace format, shared with the JAX package.
        return {"traceEvents": events,
                "displayTimeUnit": "ms",
                "otherData": {"producer": "accelerate_tpu.tracing",
                              "spans": len(self._spans),
                              "dropped_spans": self._dropped}}

    def export_chrome_trace(self, path: str) -> str:
        """Write a Perfetto-loadable Chrome trace JSON to ``path``.

        Load it at https://ui.perfetto.dev (or chrome://tracing):
        pid=subsystem (serving/prefill/handoff/decode/...), tid=lane or
        slot, with flow arrows stitching each KV handoff from its
        prefill lane to the decode slot it lands in.
        """
        with open(path, "w") as fh:
            json.dump(self.chrome_trace(), fh)
        return path

    # ------------------------------------------------------------------
    # consumer 3: Prometheus text exposition (delegated to the MetricsHub)
    # ------------------------------------------------------------------
    def register_gauges(self, subsystem: str,
                        provider: Callable[[], Dict[str, Any]]) -> None:
        """Register a live stats provider (e.g. ``engine.stats``) whose

        numeric leaves are exposed by :meth:`metrics_text` as
        ``accelerate_tpu_<subsystem>_<path>`` gauges — same numbers as
        ``stats()``/``window_stats()``, scraper-friendly format. Delegates
        to :meth:`MetricsHub.register_provider` (the single registry);
        the last registration wins, so an engine that replaces another in
        the same process takes over its gauges.
        """
        self.hub.register_provider(subsystem, provider, replace=True)

    @staticmethod
    def _sanitize(name: str) -> str:
        return "".join(c if c.isalnum() or c == "_" else "_" for c in name)

    def _span_metric_lines(self) -> List[str]:
        """Per-kind span counters for the hub renderer: the canonical
        ``accelerate_tpu_tracing_spans_total{kind=...}`` series plus the
        JAX package's older ``accelerate_tpu_trace_spans_total`` spelling
        (the hub's alias warning covers it)."""
        lines = [
            "# HELP accelerate_tpu_tracing_spans_total spans recorded by kind",
            "# TYPE accelerate_tpu_tracing_spans_total counter",
        ]
        for kind in sorted(self._counts):
            lines.append(
                f'accelerate_tpu_tracing_spans_total{{kind="{self._sanitize(kind)}"}} '
                f"{self._counts[kind]}")
        for kind in sorted(self._counts):
            lines.append(
                f'accelerate_tpu_trace_spans_total{{kind="{self._sanitize(kind)}"}} '
                f"{self._counts[kind]}")
        return lines

    def metrics_text(self) -> str:
        """Prometheus snapshot, rendered by the metrics hub (``self.hub``,
        ``profiler.MetricsHub``): one renderer and one naming scheme for
        every exporter."""
        return self.hub.render()

    # ------------------------------------------------------------------
    # deterministic projection + bookkeeping
    # ------------------------------------------------------------------
    def tick_trace(self) -> List[Dict[str, Any]]:
        """Deterministic tick-domain projection of every span.

        Contains no wall clocks; for a tick-driven seeded workload two
        runs produce bit-identical JSON (``json.dumps(tick_trace())``).
        """
        return [s.tick_view() for s in self._spans]

    def spans(self, request_id: Optional[int] = None) -> List[Span]:
        if request_id is None:
            return list(self._spans)
        return [s for s in self._spans if s.request_id == request_id]

    def request_ids(self) -> List[int]:
        return list(self._requests)

    def stats(self) -> Dict[str, Any]:
        """Summary block (embedded in ``telemetry.summary()["tracing"]``)."""
        return {
            "spans": len(self._spans),
            "dropped_spans": self._dropped,
            "by_kind": dict(sorted(self._counts.items())),
            "requests": len(self._requests),
            "open_spans": len(self._open) + len(self._open_req),
            "flows": self._flow_seq,
        }

    def reset(self) -> None:
        """Drop all spans and request accounting (warmup boundary: the

        engines call this from ``reset_metrics()`` so the measured
        window starts with a clean, tick-zeroed trace)."""
        self._spans.clear()
        self._seq = 0
        self._dropped = 0
        self._warned_drop = False
        self._requests.clear()
        self._open_req.clear()
        self._stack.clear()
        self._open.clear()
        self._flow_seq = 0
        self._pending_fault = None
        self._counts.clear()
