"""Continuous-batching serving engine: the core of
``accelerate_tpu/serving.py``.

- **Slot cache.** One ``(L, n_slots, T_max, Hkv, D)`` buffer pair
  (``generation.init_slot_cache``) with a per-slot length: a request holds a
  slot for its own lifetime and the slot is reused as soon as it retires.
- **Scheduler.** Requests queue; free slots fill every tick; a row that
  emits EOS or spends its budget retires and frees its slot.
- **Chunked prefill.** A prompt is written in ladder-sized chunks, up to
  ``prefill_chunks_per_tick`` of them per tick, so a long prompt does not
  stall the decode of the others.
- **Decode.** One step per tick advances every slot at once (rows that are
  free or done compute masked values that nothing reads); the tick reads
  its tokens and done flags back to the host in one copy.

Greedy decoding through the engine gives, per request, the tokens of a
batch-1 ``generate``. Sampled decoding draws each request's tokens from its
own ``torch.Generator`` (``submit(generator=...)``, default seeded
``ServingConfig.seed`` on the model's device; at the default seed 0 that is
``generate``'s default), so a request's tokens do not depend on the slot it
lands in.

Usage::

    engine = ServingEngine(model, ServingConfig(n_slots=8, eos_token_id=2))
    outs = engine.run(prompts, max_new_tokens=64)      # batch API
    rid = engine.submit(prompt, max_new_tokens=64)     # incremental API
    while engine.pending:
        engine.tick()
        for res in engine.poll():
            ...  # res["tokens"]: prompt + continuation, padded to the budget
    rows, secs = replay_trace(engine, prompts, arrivals=arrival_s)  # open loop

Observability: ``ServingEngine(telemetry=acc.telemetry)`` writes a
``serving_request_done`` record per finished request and, at the end of
``run``/``replay_trace`` and on ``close``, the ``stats()`` block
(``record_serving``); it registers ``stats()`` as the hub's ``serving``
provider and feeds the ``serving_availability`` SLO. With a profiler
(``profiler=``, or the recorder's from ``TelemetryKwargs(profile=True)``)
each tick is split into admit, prefill, decode, host-fetch and
bookkeeping seconds on the host clock (``DeviceTimeProfiler.on_tick``),
timing the tick's one host read without adding another.

Not ported yet, and refused where they would be set: the int8 KV cache,
speculation, admission control and SLOs (deadlines, queue bounds, retries,
the hang guard), the journal, tracing, chaos, fault tolerance, the compile
manager, canary and weight swaps, crash recovery and the SDC canary
(ROADMAP.md Queue A items 8 and 12), and generation plans other than
Llama's (item 10).
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from collections import deque
from typing import Optional

import numpy as np
import torch

from .generation import (
    KVCache,
    _cache_dims,
    _decode_params,
    _generation_plan,
    _params_device,
    init_slot_cache,
    sample_logits,
)
from .utils.dataclasses import ServingConfig

# Engine arguments of the JAX package that the port does not take yet.
_UNPORTED_ENGINE_ARGS = {
    "forward_cached": "ROADMAP.md Queue A item 10 (the other models' generation plans)",
    "compile_manager": "ROADMAP.md Queue A item 12 (control plane: compile_manager.py)",
    "fault_tolerance": "ROADMAP.md Queue A item 12 (control plane: preemption drain)",
    "chaos": "ROADMAP.md Queue A item 12 (control plane: chaos.py)",
    "tracing": "ROADMAP.md Queue A item 12 (control plane: tracing.py)",
    "journal": "ROADMAP.md Queue A item 12 (control plane: journal.py)",
}


# ---------------------------------------------------------------------------
# Chunk-ladder math
# ---------------------------------------------------------------------------


def default_prefill_ladder(max_len: int, min_chunk: int = 16,
                           max_chunk: int = 256) -> list[int]:
    """Pow2 chunk ladder for chunked prefill: ``min_chunk`` doubling up to
    ``min(max_chunk, max_len)``."""
    top = max(1, min(int(max_chunk), int(max_len)))
    rungs, c = set(), max(1, int(min_chunk))
    while c < top:
        rungs.add(c)
        c *= 2
    rungs.add(top)
    return sorted(rungs)


def plan_chunks(prompt_len: int, ladder) -> list[tuple[int, int]]:
    """Split a prompt into ``(chunk_size, valid_tokens)`` pieces: greedy
    largest rung that fits; the last partial piece pads up to the smallest
    rung (pad slots are never attended and the next write overwrites
    them)."""
    rungs = sorted({int(x) for x in ladder})
    if not rungs or prompt_len < 1:
        raise ValueError(f"need a non-empty ladder and prompt, got "
                         f"ladder={rungs} prompt_len={prompt_len}")
    out, rem = [], int(prompt_len)
    while rem > 0:
        fits = [r for r in rungs if r <= rem]
        if fits:
            out.append((fits[-1], fits[-1]))
            rem -= fits[-1]
        else:
            out.append((rungs[0], rem))
            rem = 0
    return out


# ---------------------------------------------------------------------------
# Device-side slot state
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SlotState:
    """Per-slot decode state, updated in place by the prefill and decode
    steps. ``generators`` is the one host-side field: each slot's sampling
    stream (the granted request's own generator; None while free)."""

    last_token: torch.Tensor  # (N,) long, the latest sampled token
    active: torch.Tensor      # (N,) bool, prompt fully prefilled
    done: torch.Tensor        # (N,) bool, emitted EOS or spent its budget
    generated: torch.Tensor   # (N,) long, new tokens so far
    budget: torch.Tensor      # (N,) long, the request's max_new_tokens
    generators: list


def init_slot_state(n_slots: int, device=None) -> SlotState:
    def zeros(dtype):
        return torch.zeros((n_slots,), dtype=dtype, device=device)

    return SlotState(
        last_token=zeros(torch.long), active=zeros(torch.bool), done=zeros(torch.bool),
        generated=zeros(torch.long), budget=zeros(torch.long), generators=[None] * n_slots)


def _build_decode_step(fwd, cfg, temperature, top_k, top_p, eos_token_id):
    """One decode step for every slot: ``decode(params, cache, state,
    sampled_slots) -> (toks (N, 1), emitted (N,))``. Live rows
    (``active & ~done``) advance their cache length, token and count; the
    others compute masked values and keep their state. ``sampled_slots``
    are the slots whose generator is drawn from (the live ones; the host
    knows them), so a stream advances only with its request."""
    greedy = temperature is None or temperature <= 0

    @torch.no_grad()
    def decode(params, cache: KVCache, state: SlotState, sampled_slots=()):
        live = state.active & ~state.done
        logits, new_cache = fwd(cfg, params, state.last_token[:, None], cache)
        cache.length.copy_(torch.where(live, new_cache.length, cache.length))
        tok = torch.argmax(logits, dim=-1)
        if not greedy:
            # Per-slot draws over a (1, V) row: the shape a batch-1
            # generate() samples, so each request's stream matches it.
            for slot in sampled_slots:
                tok[slot] = sample_logits(
                    logits[slot:slot + 1], state.generators[slot], temperature=temperature,
                    top_k=top_k, top_p=top_p)[0]
        tok = torch.where(live, tok, state.last_token)
        generated = state.generated + live.long()
        newly_done = live & (generated >= state.budget)
        if eos_token_id is not None:
            newly_done = newly_done | (live & (tok == eos_token_id))
        state.last_token.copy_(tok)
        state.generated.copy_(generated)
        state.done.logical_or_(newly_done)
        return tok[:, None], live.long()

    return decode


def _build_prefill_step(fwd, cfg, temperature, top_k, top_p, eos_token_id):
    """``prefill(params, cache, state, chunk, slot, valid, budget, generator,
    is_first, is_final) -> first token or None``: write a (1, C) prompt
    chunk into ``slot`` at that slot's own offset (0 for the first chunk)
    and advance it by the ``valid`` tokens. The final chunk samples the
    request's first token from the last valid position and arms the slot for
    decode; the others leave it inactive."""

    @torch.no_grad()
    def prefill(params, cache: KVCache, state: SlotState, chunk, slot: int, valid: int,
                budget: int, generator, is_first: bool, is_final: bool):
        if is_first:
            start = torch.zeros((1,), dtype=torch.long, device=cache.length.device)
        else:
            start = cache.length[slot:slot + 1].clone()
        sub_cache = KVCache(cache.k[:, slot:slot + 1], cache.v[:, slot:slot + 1], start)
        logits_all, _ = fwd(cfg, params, chunk, sub_cache, return_all=True)
        cache.length[slot:slot + 1] = start + valid
        state.budget[slot] = budget
        state.generators[slot] = generator
        if not is_final:
            state.active[slot] = False
            state.done[slot] = False
            state.generated[slot] = 0
            return None
        tok = sample_logits(logits_all[0, valid - 1][None], generator, temperature=temperature,
                            top_k=top_k, top_p=top_p)[0]
        done0 = torch.full_like(state.done[slot], budget <= 1)
        if eos_token_id is not None:
            done0 = done0 | (tok == eos_token_id)
        state.last_token[slot] = tok
        state.active[slot] = True
        state.done[slot] = done0
        state.generated[slot] = 1
        return tok

    return prefill


# ---------------------------------------------------------------------------
# Host-side request bookkeeping
# ---------------------------------------------------------------------------


class _Request:
    __slots__ = ("id", "tokens", "budget", "generator", "slot", "chunks", "next_chunk",
                 "consumed", "out", "submit_t", "first_token_t", "done_t")

    def __init__(self, rid, tokens, budget, generator):
        self.id = rid
        self.tokens = tokens          # np.int64 1-D prompt
        self.budget = budget
        self.generator = generator
        self.slot = None
        self.chunks = None            # [(chunk_size, valid)] once admitted
        self.next_chunk = 0
        self.consumed = 0             # prompt tokens already in the cache
        self.out: list[int] = []      # sampled continuation (EOS included)
        self.submit_t = time.perf_counter()
        self.first_token_t = None
        self.done_t = None


class ServingEngine:
    """Continuous-batching inference over one model (a ``Model``, a
    ``LlamaForCausalLM`` or a decode-quantized model) on the device that
    holds its parameters, with a :class:`ServingConfig`. The generation
    plan comes from the model's class. ``telemetry`` is a
    ``TelemetryRecorder`` (``Accelerator.telemetry``) and ``profiler`` a
    ``DeviceTimeProfiler``, by default the recorder's."""

    def __init__(self, model, config: Optional[ServingConfig] = None, *,
                 forward_cached=None, compile_manager=None, telemetry=None,
                 fault_tolerance=None, chaos=None, tracing=None, journal=None, profiler=None):
        given = dict(forward_cached=forward_cached, compile_manager=compile_manager,
                     fault_tolerance=fault_tolerance, chaos=chaos, tracing=tracing,
                     journal=journal)
        for name, value in given.items():
            if value is not None:
                raise NotImplementedError(
                    f"ServingEngine({name}=...) is not ported yet ({_UNPORTED_ENGINE_ARGS[name]})")
        self.telemetry = telemetry
        # Per-tick attribution (profiler.py): host perf_counter sections
        # only. None: every hook is one check.
        self._profiler = profiler if profiler is not None else getattr(
            telemetry, "profiler", None)
        self._tick_fetch_s = 0.0
        self.config = c = config if config is not None else ServingConfig()
        module = getattr(model, "module", model)
        self.cfg = module.config
        fwd = _generation_plan(module)
        self._params = _decode_params(model)
        self.device = _params_device(self._params)

        self.n_slots = int(c.n_slots)
        max_pos = _cache_dims(self.cfg)[3]
        self.t_max = int(c.max_len) if c.max_len else int(min(max_pos, 4096))
        if self.t_max > max_pos:
            raise ValueError(f"ServingConfig.max_len={self.t_max} exceeds "
                             f"max_position_embeddings={max_pos}")
        if c.prefill_chunks:
            ladder = sorted({int(x) for x in c.prefill_chunks})
        else:
            ladder = default_prefill_ladder(self.t_max, c.min_prefill_chunk,
                                            c.max_prefill_chunk)
        self.ladder = [r for r in ladder if r <= self.t_max] or [self.t_max]
        eos = c.eos_token_id
        self.pad_token_id = c.pad_token_id if c.pad_token_id is not None else (
            eos if eos is not None else 0)
        self._sampled = c.temperature is not None and c.temperature > 0
        self._decode = _build_decode_step(fwd, self.cfg, c.temperature, c.top_k, c.top_p, eos)
        self._prefill = _build_prefill_step(fwd, self.cfg, c.temperature, c.top_k, c.top_p, eos)
        self._cache = init_slot_cache(self.cfg, self.n_slots, self.t_max, device=self.device)
        self._state = init_slot_state(self.n_slots, device=self.device)

        self._queue: deque[_Request] = deque()
        self._prefilling: deque[_Request] = deque()
        self._decoding: dict[int, _Request] = {}
        self._free: list[int] = list(range(self.n_slots - 1, -1, -1))
        self._finished: deque[dict] = deque()
        self._ids = itertools.count()
        self._ttfts: list[float] = []
        self._stats = {}
        self.reset_metrics()
        # The metrics hub of the recorder: stats() as the "serving"
        # provider, and one good/bad sample per finished request into the
        # availability SLO's window.
        self._hub = getattr(telemetry, "hub", None)
        if self._hub is not None:
            self._hub.register_slo("serving_availability", 0.99)
            self._hub.register_provider("serving", self.stats, replace=True)

    # -- request lifecycle -------------------------------------------------

    def submit(self, prompt, max_new_tokens: Optional[int] = None,
               generator: Optional[torch.Generator] = None) -> int:
        """Queue one request; returns its id. ``prompt`` is a 1-D token id
        sequence; ``generator`` is this request's sampling stream (default
        seeded ``ServingConfig.seed`` on the model's device)."""
        tokens = np.asarray(prompt.cpu() if torch.is_tensor(prompt) else prompt,
                            np.int64).reshape(-1)
        if tokens.size < 1:
            raise ValueError("empty prompt")
        budget = int(max_new_tokens if max_new_tokens is not None
                     else self.config.max_new_tokens)
        if budget < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {budget}")
        if int(tokens.size) + budget > self.t_max:
            raise ValueError(
                f"prompt ({tokens.size}) + max_new_tokens ({budget}) exceeds the slot "
                f"capacity T_max={self.t_max}; raise ServingConfig.max_len.")
        if generator is None and self._sampled:
            generator = torch.Generator(device=self.device).manual_seed(self.config.seed)
        req = _Request(next(self._ids), tokens, budget, generator)
        self._stats["submitted"] += 1
        if self._first_submit_t is None:
            self._first_submit_t = req.submit_t
        self._queue.append(req)
        return req.id

    def poll(self) -> list[dict]:
        """Results finished since the last poll: ``{"id", "status",
        "tokens", "new_tokens", "ttft_s"}``; ``tokens`` is the
        prompt + continuation row padded to ``prompt + budget`` with
        ``pad_token_id`` (generate()'s row layout), ``status`` is ``ok``."""
        out = list(self._finished)
        self._finished.clear()
        return out

    @property
    def pending(self) -> int:
        """Requests not yet delivered (queued + prefilling + decoding)."""
        return len(self._queue) + len(self._prefilling) + len(self._decoding)

    # -- the tick ----------------------------------------------------------

    def tick(self) -> None:
        """One scheduler round: admit into free slots, advance up to
        ``prefill_chunks_per_tick`` prompt chunks, then one decode step for
        every live slot, retiring the rows that finished."""
        prof = self._profiler
        t0 = time.perf_counter() if prof is not None else 0.0
        tick_no = self._stats["ticks"]
        self._admit()
        t1 = time.perf_counter() if prof is not None else 0.0
        for _ in range(int(self.config.prefill_chunks_per_tick)):
            if not self._prefilling:
                break
            self._prefill_one(self._prefilling[0])
        t2 = time.perf_counter() if prof is not None else 0.0
        self._tick_fetch_s = 0.0  # the decode's host read, timed in _decode_tick
        if self._decoding:
            self._decode_tick()
        t3 = time.perf_counter() if prof is not None else 0.0
        self._stats["ticks"] += 1
        if prof is not None:
            # Lagged attribution from host sections; bookkeeping_s closes
            # the identity.
            t4 = time.perf_counter()
            prof.on_tick(tick_no, t4 - t0, sections={
                "admit_s": t1 - t0,
                "prefill_s": t2 - t1,
                "decode_s": (t3 - t2) - self._tick_fetch_s,
                "host_fetch_s": self._tick_fetch_s,
                "bookkeeping_s": t4 - t3,
            }, gauges={"occupancy": len(self._decoding)})

    def _admit(self) -> None:
        while self._free and self._queue:
            req, slot = self._queue.popleft(), self._free.pop()
            req.slot = slot
            req.chunks = plan_chunks(int(req.tokens.size), self.ladder)
            self._prefilling.append(req)

    def _prefill_one(self, req: _Request) -> None:
        size, valid = req.chunks[req.next_chunk]
        # A padded last chunk may reach past the slot's capacity; the JAX
        # scatter drops those pad writes, here the chunk stops at T_max.
        size = min(size, self.t_max - req.consumed)
        chunk = np.zeros((1, size), np.int64)
        chunk[0, :valid] = req.tokens[req.consumed:req.consumed + valid]
        is_first = req.next_chunk == 0
        is_final = req.next_chunk == len(req.chunks) - 1
        tok = self._prefill(self._params, self._cache, self._state,
                            torch.from_numpy(chunk).to(self.device), req.slot, valid,
                            req.budget, req.generator, is_first, is_final)
        req.next_chunk += 1
        req.consumed += valid
        self._stats["prefill_chunks"] += 1
        if is_final:
            self._prefilling.remove(req)
            first = int(tok)  # the one host read of a prefill: the TTFT moment
            req.first_token_t = time.perf_counter()
            req.out.append(first)
            eos = self.config.eos_token_id
            if req.budget <= 1 or (eos is not None and first == eos):
                self._retire(req)
            else:
                self._decoding[req.slot] = req

    def _decode_tick(self) -> None:
        live = len(self._decoding)
        self._stats["occupancy_sum"] += live
        self._stats["peak_occupancy"] = max(self._stats["peak_occupancy"], live)
        sampled = sorted(self._decoding) if self._sampled else ()
        toks, _ = self._decode(self._params, self._cache, self._state, sampled)
        self._stats["decode_steps"] += 1
        # The tick's one host sync: this step's tokens and done flags. The
        # profiler times it as the tick's host_fetch_s.
        tf0 = time.perf_counter() if self._profiler is not None else 0.0
        host = torch.stack((toks[:, 0], self._state.done.long())).cpu().numpy()
        if self._profiler is not None:
            self._tick_fetch_s += time.perf_counter() - tf0
        for slot, req in list(self._decoding.items()):
            req.out.append(int(host[0, slot]))
            if host[1, slot]:
                del self._decoding[slot]
                self._retire(req)

    def _retire(self, req: _Request) -> None:
        """Natural completion: the device row already flagged itself done,
        so the slot goes straight back to the free list."""
        self._free.append(req.slot)
        req.done_t = self._last_done_t = time.perf_counter()
        n_new = len(req.out)
        row = np.concatenate([req.tokens, np.asarray(req.out, np.int64),
                              np.full((req.budget - n_new,), self.pad_token_id, np.int64)])
        ttft = req.first_token_t - req.submit_t
        self._ttfts.append(ttft)
        self._stats["completed"] += 1
        self._stats["tokens_out"] += n_new
        self._finished.append({"id": req.id, "status": "ok", "tokens": row,
                               "new_tokens": n_new, "ttft_s": ttft})
        if self._hub is not None:
            self._hub.observe_slo("serving_availability", True)
        if self.telemetry is not None:
            tpot = (req.done_t - req.first_token_t) / (n_new - 1) if n_new > 1 else 0.0
            self.telemetry.record_event(
                "serving_request_done", request_id=req.id, status="ok", ttft_s=ttft,
                tpot_s=tpot, new_tokens=n_new, prompt_tokens=int(req.tokens.size),
                slot=req.slot)

    # -- batch front-end ---------------------------------------------------

    def run(self, prompts, max_new_tokens=None, generators=None,
            max_ticks: Optional[int] = None) -> list[np.ndarray]:
        """Submit every prompt, tick until drained, and return one
        ``prompt + continuation`` row per prompt in input order.
        ``max_new_tokens`` is an int or a per-request list, ``generators`` a
        per-request list."""
        n = len(prompts)
        budgets = (max_new_tokens if isinstance(max_new_tokens, (list, tuple))
                   else [max_new_tokens] * n)
        gens = generators if generators is not None else [None] * n
        ids = [self.submit(p, max_new_tokens=budgets[i], generator=gens[i])
               for i, p in enumerate(prompts)]
        results: dict[int, np.ndarray] = {}
        guard = max_ticks if max_ticks is not None else (
            10 * (sum(len(plan_chunks(len(np.ravel(p)), self.ladder)) for p in prompts)
                  + sum(int(b or self.config.max_new_tokens) for b in budgets)) + 100)
        ticks = 0
        while self.pending:
            self.tick()
            for res in self.poll():
                results[res["id"]] = res["tokens"]
            ticks += 1
            if ticks > guard:
                raise RuntimeError(f"serving engine failed to drain in {guard} ticks "
                                   f"({self.pending} requests still pending)")
        self._push_telemetry_summary()
        return [results[i] for i in ids]

    def warmup(self) -> None:
        """Run one request whose prompt walks every ladder rung, and two
        decode steps, then reset the metrics so a timed run starts clean."""
        prompt_len = min(sum(self.ladder), self.t_max - 2)
        self.run([np.ones((prompt_len,), np.int64)], max_new_tokens=2)
        self.reset_metrics()

    def reset_metrics(self) -> None:
        """Zero every counter and latency sample; device state stays."""
        self._stats = dict.fromkeys(
            ("submitted", "completed", "ticks", "decode_steps", "prefill_chunks",
             "tokens_out", "occupancy_sum", "peak_occupancy"), 0)
        self._first_submit_t = None
        self._last_done_t = None
        self._ttfts.clear()
        self._finished.clear()
        if self._profiler is not None:
            # Warm-up records would skew the term means and the flight ring.
            self._profiler.reset()

    def close(self) -> None:
        """Push the ``stats()`` block into the telemetry stream."""
        self._push_telemetry_summary()

    def _push_telemetry_summary(self) -> None:
        if self.telemetry is not None:
            self.telemetry.record_serving(self.stats())

    # -- reporting ---------------------------------------------------------

    def stats(self) -> dict:
        """Ticks, tokens, slot occupancy, TTFT percentiles and aggregate
        tokens/s, on the host clock."""
        s = self._stats
        elapsed = None
        if self._first_submit_t is not None:
            elapsed = (self._last_done_t or time.perf_counter()) - self._first_submit_t
        ttft = np.asarray(self._ttfts, np.float64)
        return {
            "requests_submitted": s["submitted"],
            "requests_completed": s["completed"],
            "tokens_out": s["tokens_out"],
            "elapsed_s": elapsed,
            "tokens_per_s": s["tokens_out"] / elapsed if elapsed else None,
            "ttft_p50_s": float(np.percentile(ttft, 50)) if ttft.size else None,
            "ttft_p95_s": float(np.percentile(ttft, 95)) if ttft.size else None,
            "ticks": s["ticks"],
            "decode_steps": s["decode_steps"],
            "prefill_chunks": s["prefill_chunks"],
            "n_slots": self.n_slots,
            "mean_occupancy": (s["occupancy_sum"] / s["decode_steps"]
                               if s["decode_steps"] else None),
            "peak_occupancy": s["peak_occupancy"],
        }


# ---------------------------------------------------------------------------
# Open-loop trace replay
# ---------------------------------------------------------------------------


def replay_trace(engine: ServingEngine, prompts, *, arrivals, max_new_tokens=None,
                 generators=None) -> tuple[list, float]:
    """Replay an open-loop arrival trace through a live engine: submit
    ``prompts[i]`` once ``arrivals[i]`` seconds (from the trace's start)
    have passed, and tick until drained. Unlike :meth:`ServingEngine.run`,
    the trace fixes the offered load, whatever the engine's drain rate.

    Returns ``(rows, elapsed_s)``: one prompt + continuation row per prompt
    in input order, and the wall time from the start to the last result."""
    n = len(prompts)
    if len(arrivals) != n:
        raise ValueError(f"{n} prompts but {len(arrivals)} arrivals")
    budgets = (max_new_tokens if isinstance(max_new_tokens, (list, tuple))
               else [max_new_tokens] * n)
    gens = generators if generators is not None else [None] * n
    order = sorted(range(n), key=lambda i: float(arrivals[i]))
    ids: dict[int, int] = {}
    results: dict[int, np.ndarray] = {}
    t0 = time.perf_counter()
    nxt = 0
    while nxt < n or engine.pending:
        now = time.perf_counter() - t0
        while nxt < n and float(arrivals[order[nxt]]) <= now:
            i = order[nxt]
            ids[i] = engine.submit(prompts[i], max_new_tokens=budgets[i], generator=gens[i])
            nxt += 1
        if engine.pending:
            engine.tick()
            for res in engine.poll():
                results[res["id"]] = res["tokens"]
        elif nxt < n:  # idle until the next arrival
            time.sleep(min(0.002, max(0.0, float(arrivals[order[nxt]]) - now)))
    elapsed = time.perf_counter() - t0
    engine._push_telemetry_summary()
    return [results[ids[i]] for i in range(n)], elapsed
