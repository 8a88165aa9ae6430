"""Continuous-batching serving engine (counterpart of
``accelerate_tpu/serving.py``).

- **Slot cache.** One ``(L, n_slots, T_max, Hkv, D)`` buffer pair
  (``generation.init_slot_cache``; int8 ``QuantPages`` with
  ``ServingConfig(cache_dtype=torch.int8)``) with a per-slot length: a
  request holds a slot for its own lifetime and the slot is reused as soon
  as it retires.
- **Scheduler.** Requests queue; free slots fill every tick; a row that
  emits EOS or spends its budget retires and frees its slot.
- **Chunked prefill.** A prompt is written in ladder-sized chunks, up to
  ``prefill_chunks_per_tick`` of them per tick, so a long prompt does not
  stall the decode of the others.
- **Decode.** One step per tick advances every slot at once (rows that are
  free or done compute masked values that nothing reads); the tick reads
  its tokens, emitted counts, done flags and the non-finite-logits
  sentinel back to the host in one copy.
- **Speculation** (``speculate_k > 0``): each slot drafts ``k`` tokens from
  its own token history (an n-gram match) and one ``(n_slots, k + 1)``
  forward verifies them. Greedy output equals the one-token step's;
  sampled output keeps the target distribution (``_speculative_accept``).

Greedy decoding through the engine gives, per request, the tokens of a
batch-1 ``generate``. Sampled decoding draws each request's tokens from its
own ``torch.Generator`` (``submit(generator=...)``, default seeded
``ServingConfig.seed`` on the model's device; at the default seed 0 that is
``generate``'s default), so a request's tokens do not depend on the slot it
lands in.

Every request ends with a ``status`` in its ``poll()`` row, one of
``REQUEST_STATUSES``: ``ok``, ``timeout`` (missed its ``deadline_s``; the
slot is freed that tick), ``shed`` (admission control:
``max_queue_depth`` with ``overload_policy`` ``reject``, ``shed_oldest`` or
``block``) or ``failed`` (``max_retries`` spent). A prefill that raises, or
a slot whose logits go non-finite (the slot is quarantined), sends its
request back to the head of the queue to replay from its prompt and its
generator's first state. ``max_idle_ticks`` ticks without progress while
requests are pending raise :class:`ServingStalledError`.

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
``serving_request_done`` record per finished request (and a
``serving_fault`` record for every other status) and, at the end of
``run``/``replay_trace`` and on ``close``, the ``stats()`` block
(``record_serving``); it registers ``stats()`` as the hub's ``serving``
provider and ``speculation_stats()`` as its ``spec`` provider and feeds
the ``serving_availability`` SLO. With a profiler (``profiler=``, or the
recorder's from ``TelemetryKwargs(profile=True)``) each tick is split into
admit, prefill, decode, host-fetch and bookkeeping seconds on the host
clock (``DeviceTimeProfiler.on_tick``), timing the tick's one host read
without adding another.

Not ported yet, and refused where they would be set: the journal and
``client_request_id``, tracing, chaos, fault tolerance, the compile
manager, canary and weight swaps, crash recovery and the SDC canary
(ROADMAP.md Queue A items 8.8 and 12). The engine runs every config of the
Llama chassis, Mixtral, GPT-2, OPT and GPT-NeoX, or the plan
``forward_cached=`` names; an encoder-decoder module (T5, Whisper) is
refused, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import itertools
import logging
import time
from collections import deque
from typing import Optional

import numpy as np
import torch

from .generation import (
    ENCDEC_GENERATION_PLANS,
    KVCache,
    _cache_dims,
    _decode_params,
    _filter_logits,
    _generation_plan,
    _params_device,
    init_slot_cache,
    sample_logits,
)
from .chaos import InjectedFaultError
from .utils.constants import PREEMPTION_EXIT_CODE
from .utils.dataclasses import ServingConfig

logger = logging.getLogger(__name__)

# Engine arguments of the JAX package that the port does not take yet.
_UNPORTED_ENGINE_ARGS = {
    "compile_manager": "ROADMAP.md Queue A item 12.4 (compile_manager.py)",
    "tracing": "ROADMAP.md Queue A item 12.2 (tracing.py)",
    "journal": "ROADMAP.md Queue A item 12.2 (journal.py)",
}
# Injection points whose engine paths are not ported: an injector that
# names one is refused.
_UNPORTED_CHAOS_POINTS = {
    "engine_crash": "ROADMAP.md Queue A item 12.2 (the hard crash and the journal's recovery)",
}
_IDEMPOTENCY_ITEM = "ROADMAP.md Queue A item 8.8 (the engine's journal hooks)"

#: The terminal statuses every request ends with (``poll()`` rows).
REQUEST_STATUSES = ("ok", "timeout", "shed", "failed")


class ServingStalledError(RuntimeError):
    """The engine made no progress for ``max_idle_ticks`` ticks in a row
    while requests were pending (every slot quarantined, say). Raised from
    ``tick()``, so ``run()`` and :func:`replay_trace` fail instead of
    spinning; the message names the stuck requests and the quarantined
    slots."""


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
    # (N, H) long rolling window of the slot's tokens (-1 before the
    # first), the n-gram draft's source; an armed slot's last entry is its
    # last_token. Untouched by the one-token step.
    history: torch.Tensor
    generators: list


def init_slot_state(n_slots: int, device=None, history: int = 16) -> SlotState:
    def zeros(dtype):
        return torch.zeros((n_slots,), dtype=dtype, device=device)

    return SlotState(
        last_token=zeros(torch.long), active=zeros(torch.bool), done=zeros(torch.bool),
        generated=zeros(torch.long), budget=zeros(torch.long),
        history=torch.full((n_slots, int(history)), -1, dtype=torch.long, device=device),
        generators=[None] * n_slots)


def _ngram_draft(history: torch.Tensor, last_token: torch.Tensor, k: int) -> torch.Tensor:
    """(N, k) drafts: the ``k`` tokens that followed the most recent earlier
    occurrence of ``last_token`` in each slot's history (cycling that
    suffix when it is shorter than ``k``); a slot with no match, or whose
    draft reaches the -1 padding, repeats ``last_token``."""
    h = history.shape[1]
    match = history[:, :h - 1] == last_token[:, None]             # (N, H-1)
    has = match.any(dim=1)
    last_match = (h - 2) - torch.argmax(match.flip(1).int(), dim=1)
    j = torch.where(has, last_match, h - 1)
    period = ((h - 1) - j).clamp_min(1)
    offs = j[:, None] + 1 + torch.arange(k, device=history.device)[None, :] % period[:, None]
    drafts = history.gather(1, offs.clamp_max(h - 1))
    return torch.where(has[:, None] & (drafts >= 0), drafts, last_token[:, None])


def _gumbel_argmax(logits: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """A categorical draw from ``logits`` by the Gumbel-max trick on
    uniforms ``u`` of the same shape (``sample_logits``'s rule)."""
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))
    return torch.argmax(logits + gumbel, dim=-1)


def _speculative_accept(probs: torch.Tensor, drafts: torch.Tensor, u: torch.Tensor,
                        u_resid: torch.Tensor, u_bonus: torch.Tensor):
    """Sampled acceptance of ``k`` drafts against the target's ``probs``
    (N, k+1, V). The draft is one token (a delta distribution), so draft
    ``d_i`` is kept with probability ``p_i(d_i)``: while ``u_i <
    p_i(d_i)``. At the first rejection the token is drawn from ``p_i`` with
    ``d_i`` removed, renormalised (``u_resid`` (N, k, V)); when all ``k``
    are kept, a bonus token is drawn from ``p_k`` (``u_bonus`` (N, V)).
    Each emitted token is then a draw from the target distribution.
    Returns ``(out (N, k+1), m (N,))``: ``out[:, :m]`` the kept drafts,
    ``out[:, m]`` the token after them."""
    n, k = drafts.shape
    p_draft = probs[:, :k].gather(2, drafts[..., None])[..., 0]
    m = torch.cumprod((u < p_draft).long(), dim=1).sum(dim=1)
    resid = torch.log(probs[:, :k].scatter(2, drafts[..., None], 0.0))
    cand = torch.cat([_gumbel_argmax(resid, u_resid),
                      _gumbel_argmax(torch.log(probs[:, k]), u_bonus)[:, None]], dim=1)
    idx = torch.arange(k + 1, device=drafts.device)[None, :]
    drafts_ext = torch.cat([drafts, drafts.new_zeros((n, 1))], dim=1)
    return torch.where(idx < m[:, None], drafts_ext, cand), m


def _build_decode_step(fwd, cfg, temperature, top_k, top_p, eos_token_id,
                       speculate_k: int = 0):
    """One decode step for every slot: ``decode(params, cache, state,
    sampled_slots) -> (toks (N, k+1), emitted (N,), bad (N,))``, where
    ``toks[slot, :emitted[slot]]`` are the tokens the slot produced
    (``k = 0``: one, for live rows) and ``bad`` flags live rows whose
    logits are not all finite. Live rows (``active & ~done``) advance their
    cache length, token, count and history; the others compute masked
    values and keep their state. ``sampled_slots`` are the slots whose
    generator is drawn from (the live ones; the host knows them), so a
    stream advances only with its request.

    With ``speculate_k = k > 0`` each slot drafts ``k`` tokens
    (``_ngram_draft``) and one ``(N, k+1)`` forward scores the window
    ``[last_token, drafts]``. Greedy mode keeps the longest prefix where
    the draft equals the argmax, which is the one-token step's chain.
    Sampled mode keeps the target distribution (``_speculative_accept``);
    each live slot draws from its own generator, in this order: ``k``
    uniforms, ``k`` rows of V residual uniforms, then V bonus uniforms. The
    emitted count stops at the first EOS and at the budget. Rows written
    past the accepted prefix are rewritten by the next tick's window before
    attention reads them."""
    k = int(speculate_k)
    greedy = temperature is None or temperature <= 0

    def finish(state: SlotState, cache: KVCache, live, out, e, new_history):
        """Advance the live rows by their ``e`` emitted tokens of ``out``."""
        idx = torch.arange(out.shape[1], device=out.device)[None, :]
        generated = state.generated + e
        newly_done = live & (e > 0) & (generated >= state.budget)
        if eos_token_id is not None:
            newly_done = newly_done | (live & ((out == eos_token_id) & (idx < e[:, None])).any(1))
        last = out.gather(1, (e - 1).clamp_min(0)[:, None])[:, 0]
        state.last_token.copy_(torch.where(live & (e > 0), last, state.last_token))
        state.generated.copy_(generated)
        state.done.logical_or_(newly_done)
        cache.length.copy_(torch.where(live, cache.length + e, cache.length))
        if new_history is not None:
            state.history.copy_(new_history)

    @torch.no_grad()
    def decode(params, cache: KVCache, state: SlotState, sampled_slots=()):
        live = state.active & ~state.done
        n = live.shape[0]
        if k == 0:
            logits, _ = fwd(cfg, params, state.last_token[:, None], cache)
            tok = torch.argmax(logits, dim=-1)
            if not greedy:
                # Per-slot draws over a (1, V) row: the shape a batch-1
                # generate() samples, so each request's stream matches it.
                for slot in sampled_slots:
                    tok[slot] = sample_logits(
                        logits[slot:slot + 1], state.generators[slot], temperature=temperature,
                        top_k=top_k, top_p=top_p)[0]
            # Computed on the rows live before this step, so parked rows'
            # masked values never flag.
            bad = live & ~torch.isfinite(logits).all(dim=-1)
            e = live.long()
            finish(state, cache, live, tok[:, None], e, None)
            return tok[:, None], e, bad

        drafts = _ngram_draft(state.history, state.last_token, k)
        window = torch.cat([state.last_token[:, None], drafts], dim=1)
        logits_all, _ = fwd(cfg, params, window, cache, return_all=True)  # (N, k+1, V)
        bad = live & ~torch.isfinite(logits_all).reshape(n, -1).all(dim=-1)
        if greedy:
            out = torch.argmax(logits_all, dim=-1)
            m = torch.cumprod((drafts == out[:, :k]).long(), dim=1).sum(dim=1)
        else:
            vocab = logits_all.shape[-1]
            probs = torch.softmax(_filter_logits(
                logits_all.reshape(-1, vocab), temperature=temperature, top_k=top_k,
                top_p=top_p), dim=-1).reshape(n, k + 1, vocab)
            u = torch.zeros((n, k), device=probs.device)
            u_resid = torch.zeros((n, k, vocab), device=probs.device)
            u_bonus = torch.zeros((n, vocab), device=probs.device)
            for slot in sampled_slots:
                g = state.generators[slot]
                u[slot] = torch.rand((k,), generator=g, device=probs.device)
                u_resid[slot] = torch.rand((k, vocab), generator=g, device=probs.device)
                u_bonus[slot] = torch.rand((vocab,), generator=g, device=probs.device)
            out, m = _speculative_accept(probs, drafts, u, u_resid, u_bonus)
        # The accepted drafts and the token after them, cut at the first EOS
        # and at the budget.
        avail = m + 1
        if eos_token_id is not None:
            idx = torch.arange(k + 1, device=out.device)[None, :]
            is_eos = (out == eos_token_id) & (idx < avail[:, None])
            avail = torch.where(is_eos.any(1), torch.argmax(is_eos.int(), dim=1) + 1, avail)
        room = (state.budget - state.generated).clamp_min(0)
        e = torch.where(live, torch.minimum(avail, room), 0)
        # Shift the e emitted tokens into the history window.
        h = state.history.shape[1]
        hist = torch.cat([state.history, out], dim=1).gather(
            1, torch.arange(h, device=out.device)[None, :] + e[:, None])
        finish(state, cache, live, out, e, hist)
        return out, e, bad

    return decode


def _build_prefill_step(fwd, cfg, temperature, top_k, top_p, eos_token_id):
    """``prefill(params, cache, state, chunk, slot, valid, budget, generator,
    is_first, is_final) -> first token or None``: write a (1, C) prompt
    chunk into ``slot`` at that slot's own offset (0 for the first chunk;
    pad rows past the slot's capacity are dropped) and advance it by the
    ``valid`` tokens, shifting them into the slot's history. The final
    chunk samples the request's first token from the last valid position
    and arms the slot for decode; the others leave it inactive."""

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
        h = state.history.shape[1]
        hist = torch.full_like(state.history[slot], -1) if is_first else state.history[slot]
        hist = torch.cat([hist, chunk[0, :valid]])[-h:]
        if not is_final:
            state.history[slot] = hist
            state.active[slot] = False
            state.done[slot] = False
            state.generated[slot] = 0
            return None
        tok = sample_logits(logits_all[0, valid - 1][None], generator, temperature=temperature,
                            top_k=top_k, top_p=top_p)[0]
        done0 = torch.full_like(state.done[slot], budget <= 1)
        if eos_token_id is not None:
            done0 = done0 | (tok == eos_token_id)
        state.history[slot] = torch.cat([hist[1:], tok[None]])
        state.last_token[slot] = tok
        state.active[slot] = True
        state.done[slot] = done0
        state.generated[slot] = 1
        return tok

    return prefill


def _release_slot_op(state: SlotState, slot: int) -> None:
    """Mark one slot done mid-flight (an eviction, a failed prefill, a
    quarantine): the decode step then masks the row until the next grant's
    first chunk rewrites it."""
    state.done[slot] = True


def _slo_aggregate(events) -> dict:
    """ok-only latency samples and per-status rates over terminal-request
    events (``{"status", "ttft_s", "tpot_s"}``)."""
    n = len(events)
    ok = [e for e in events if e["status"] == "ok"]
    ttft = np.asarray([e["ttft_s"] for e in ok if e["ttft_s"] is not None], np.float64)
    tpot = np.asarray([e["tpot_s"] for e in ok if e["tpot_s"] is not None], np.float64)

    def rate(status):
        return sum(1 for e in events if e["status"] == status) / n if n else 0.0

    return {"n": n, "ok": len(ok), "ttft": ttft, "tpot": tpot,
            "timeout_rate": rate("timeout"), "shed_rate": rate("shed"),
            "failed_rate": rate("failed")}


# ---------------------------------------------------------------------------
# Host-side request bookkeeping
# ---------------------------------------------------------------------------


class _Request:
    __slots__ = ("id", "tokens", "budget", "generator", "generator_state", "slot", "chunks",
                 "next_chunk", "consumed", "out", "submit_t", "admit_t", "first_token_t",
                 "done_t", "deadline", "retries", "status", "weights_version",
                 "spec_drafted", "spec_accepted")

    def __init__(self, rid, tokens, budget, generator):
        self.id = rid
        self.tokens = tokens          # np.int64 1-D prompt
        self.budget = budget
        self.generator = generator
        # Where the stream starts: a retry replays from here.
        self.generator_state = generator.get_state() if generator is not None else None
        self.slot = None
        self.chunks = None            # [(chunk_size, valid)] once admitted
        self.next_chunk = 0
        self.consumed = 0             # prompt tokens already in the cache
        self.out: list[int] = []      # sampled continuation (EOS included)
        self.submit_t = time.perf_counter()
        self.admit_t = None           # slot granted
        self.first_token_t = None
        self.done_t = None
        self.deadline = None          # absolute perf_counter time, or None
        self.retries = 0
        self.status = None            # ok | timeout | shed | failed
        self.weights_version = None   # bound at the first grant
        self.spec_drafted = 0
        self.spec_accepted = 0

    def reset_for_retry(self) -> None:
        """Back to freshly queued. The prompt, budget, deadline, submit time
        and bound weights version stay, and the generator returns to its
        first state, so the retry replays the same tokens."""
        self.slot = None
        self.chunks = None
        self.next_chunk = 0
        self.consumed = 0
        self.out = []
        self.admit_t = None
        self.first_token_t = None
        self.spec_drafted = 0
        self.spec_accepted = 0
        if self.generator is not None:
            self.generator.set_state(self.generator_state)


class ServingEngine:
    """Continuous-batching inference over one model (a ``Model``, a
    ``LlamaForCausalLM`` or a decode-quantized model) on the device that
    holds its parameters, with a :class:`ServingConfig`. The generation
    plan comes from the model's class unless ``forward_cached`` names
    one. ``telemetry`` is a ``TelemetryRecorder``
    (``Accelerator.telemetry``) and ``profiler`` a ``DeviceTimeProfiler``,
    by default the recorder's."""

    def __init__(self, model, config: Optional[ServingConfig] = None, *,
                 forward_cached=None, compile_manager=None, telemetry=None,
                 fault_tolerance=None, chaos=None, tracing=None, journal=None, profiler=None):
        given = dict(compile_manager=compile_manager, tracing=tracing, journal=journal)
        for name, value in given.items():
            if value is not None:
                raise NotImplementedError(
                    f"ServingEngine({name}=...) is not ported yet ({_UNPORTED_ENGINE_ARGS[name]})")
        # A FaultToleranceManager arms the preemption drain; a FaultInjector
        # the chaos draws at prefill_dispatch, decode_tick and
        # draft_mismatch.
        self.fault_tolerance = fault_tolerance
        self.chaos = chaos
        self._draining = False
        self._sdc_canary = None
        self.telemetry = telemetry
        # Per-tick attribution (profiler.py): host perf_counter sections
        # only. None: every hook is one check.
        self._profiler = profiler if profiler is not None else getattr(
            telemetry, "profiler", None)
        self._tick_fetch_s = 0.0
        self.config = c = config if config is not None else ServingConfig()
        module = getattr(model, "module", model)
        self.cfg = module.config
        name = type(module).__name__
        if forward_cached is None and name in ENCDEC_GENERATION_PLANS:
            raise ValueError("ServingEngine serves causal-LM plans; encoder-decoder families "
                             f"({name}) keep the static generate() path.")
        fwd = _generation_plan(module, forward_cached)
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
        self._speculate_k = int(c.speculate_k)
        self._spec_ngram = int(c.speculate_ngram)
        self._decode = _build_decode_step(fwd, self.cfg, c.temperature, c.top_k, c.top_p, eos,
                                          speculate_k=self._speculate_k)
        self._prefill = _build_prefill_step(fwd, self.cfg, c.temperature, c.top_k, c.top_p, eos)
        self._cache = init_slot_cache(self.cfg, self.n_slots, self.t_max, dtype=c.cache_dtype,
                                      device=self.device)
        self._state = init_slot_state(self.n_slots, device=self.device,
                                      history=self._spec_ngram)

        self._queue: deque[_Request] = deque()
        self._prefilling: deque[_Request] = deque()
        self._decoding: dict[int, _Request] = {}
        self._free: list[int] = list(range(self.n_slots - 1, -1, -1))
        self._used_slots: set[int] = set()
        self._quarantined_slots: set[int] = set()
        self._finished: deque[dict] = deque()
        self._ids = itertools.count()
        self._ttfts: list[float] = []
        self._tpots: list[float] = []
        # TTFT split: queued for a slot, then prefilling once granted.
        self._queue_waits: list[float] = []
        self._prefill_lats: list[float] = []
        # The rolling SLO window: the last window_requests terminal
        # requests and as many per-tick queue depths.
        self._window: deque[dict] = deque(maxlen=int(c.window_requests))
        self._queue_depth_window: deque[int] = deque(maxlen=int(c.window_requests))
        self._has_deadlines = c.deadline_s is not None
        self._idle_ticks = 0
        self._stats, self._fstats = {}, {}
        self.reset_metrics()
        # The metrics hub of the recorder: stats() as the "serving"
        # provider, speculation_stats() as "spec", and one good/bad sample
        # per finished request into the availability SLO's window.
        self._hub = getattr(telemetry, "hub", None)
        if self._hub is not None:
            self._hub.register_slo("serving_availability", 0.99)
            self._hub.register_provider("serving", self.stats, replace=True)
            self._hub.register_provider("spec", self._spec_metrics, replace=True)

    @property
    def chaos(self):
        """The attached ``chaos.FaultInjector``, or None."""
        return self._chaos

    @chaos.setter
    def chaos(self, injector) -> None:
        if injector is not None:
            named = set(injector.rates) | {e["point"] for e in injector._schedule}
            for point, item in _UNPORTED_CHAOS_POINTS.items():
                if point in named:
                    raise NotImplementedError(
                        f"ServingEngine(chaos=...) drawing {point!r} is not ported yet ({item})")
        self._chaos = injector

    # -- request lifecycle -------------------------------------------------

    def submit(self, prompt, max_new_tokens: Optional[int] = None,
               generator: Optional[torch.Generator] = None,
               deadline_s: Optional[float] = None, client_request_id=None) -> int:
        """Queue one request; returns its id, whose row ``poll()`` delivers
        whatever happens to it. ``prompt`` is a 1-D token id sequence;
        ``generator`` is this request's sampling stream (default seeded
        ``ServingConfig.seed`` on the model's device); ``deadline_s``
        overrides ``ServingConfig.deadline_s`` (seconds from now: a request
        past it finishes ``timeout``).

        With ``max_queue_depth`` set and the queue full,
        ``overload_policy`` decides: ``reject`` finishes this request
        ``shed``, ``shed_oldest`` sheds the oldest queued request instead,
        ``block`` ticks the engine until the queue has room."""
        if client_request_id is not None:
            raise NotImplementedError(
                f"submit(client_request_id=...) is not ported yet ({_IDEMPOTENCY_ITEM})")
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
        deadline = deadline_s if deadline_s is not None else self.config.deadline_s
        if deadline is not None:
            if float(deadline) <= 0:
                raise ValueError(f"deadline_s must be > 0, got {deadline}")
            req.deadline = req.submit_t + float(deadline)
            self._has_deadlines = True
        self._stats["submitted"] += 1
        if self._first_submit_t is None:
            self._first_submit_t = req.submit_t
        if self._draining:  # the preemption drain: nothing new gets in
            self._finish(req, "shed")
            return req.id
        cap = self.config.max_queue_depth
        if cap is not None and len(self._queue) >= cap:
            policy = self.config.overload_policy
            if policy == "reject":
                self._finish(req, "shed")
                return req.id
            if policy == "shed_oldest":
                self._finish(self._queue.popleft(), "shed")
            else:  # block: backpressure by running the engine
                while len(self._queue) >= cap:
                    self.tick()
        self._queue.append(req)
        return req.id

    def poll(self) -> list[dict]:
        """Results finished since the last poll: ``{"id", "status",
        "tokens", "new_tokens", "ttft_s", "tpot_s", "weights_version",
        "attempt", "recovered", "drafted", "accepted"}``. ``status`` is one
        of ``REQUEST_STATUSES``; ``tokens`` is the prompt + continuation
        row padded to ``prompt + budget`` with ``pad_token_id``
        (generate()'s row layout); ``weights_version`` is 0 once the
        request held a slot (None if it never did); ``attempt`` counts
        executions (1 + retries); ``drafted``/``accepted`` count its
        speculative drafts."""
        out = list(self._finished)
        self._finished.clear()
        return out

    @property
    def pending(self) -> int:
        """Requests not yet delivered (queued + prefilling + decoding)."""
        return len(self._queue) + len(self._prefilling) + len(self._decoding)

    # -- the tick ----------------------------------------------------------

    def tick(self) -> None:
        """One scheduler round: expire deadlines, admit into free slots,
        advance up to ``prefill_chunks_per_tick`` prompt chunks, then one
        decode step for every live slot, retiring the rows that finished.
        Raises :class:`ServingStalledError` once ``max_idle_ticks`` rounds
        in a row made no progress with requests pending."""
        prof = self._profiler
        t0 = time.perf_counter() if prof is not None else 0.0
        tick_no = self._stats["ticks"]
        snap = self._begin_tick()
        self._admit()
        self._sample_queue_depth()
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
        self._end_tick(snap)
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

    def _sample_queue_depth(self) -> None:
        depth = len(self._queue)
        self._stats["queue_depth_sum"] += depth
        self._stats["queue_samples"] += 1
        self._queue_depth_window.append(depth)

    def _progress_marker(self) -> tuple:
        """What changes when the engine moves: grants, prefill chunks,
        decode steps and terminal results."""
        s, f = self._stats, self._fstats
        return (s["slot_allocs"], s["prefill_chunks"], s["decode_steps"], s["completed"],
                f["sheds"], f["timeouts"], f["failed"])

    def _begin_tick(self) -> tuple:
        ft = self.fault_tolerance
        if not self._draining and ft is not None and getattr(ft, "preempted", False):
            # The preemption drain: nothing new is admitted, the queue is
            # shed, the requests in flight finish; then exit
            # preemption_exit_code.
            self._draining = True
            logger.warning("serving: preemption signal: shedding %d queued request(s), "
                           "draining %d in flight, then exiting resumable (code %d)",
                           len(self._queue), len(self._prefilling) + len(self._decoding),
                           PREEMPTION_EXIT_CODE)
            while self._queue:
                self._finish(self._queue.popleft(), "shed")
        if self._has_deadlines:
            self._expire_deadlines()
        return self._progress_marker()

    def _end_tick(self, snap: tuple) -> None:
        self._stats["ticks"] += 1
        if self._sdc_canary is not None:
            self._sdc_canary.on_tick()
        if not (self.pending and self._progress_marker() == snap):
            self._idle_ticks = 0
            return
        self._idle_ticks += 1
        if self._idle_ticks >= int(self.config.max_idle_ticks):
            states = ([f"{r.id}:queued" for r in self._queue]
                      + [f"{r.id}:prefilling(chunk {r.next_chunk}/{len(r.chunks or [])})"
                         for r in self._prefilling]
                      + [f"{r.id}:decoding(slot {s})" for s, r in sorted(self._decoding.items())])
            raise ServingStalledError(
                f"serving engine made no progress for {self._idle_ticks} consecutive ticks "
                f"with {self.pending} request(s) pending [{', '.join(states)}]; "
                f"{len(self._quarantined_slots)}/{self.n_slots} slots quarantined "
                f"{sorted(self._quarantined_slots)}")

    def _expire_deadlines(self) -> None:
        now = time.perf_counter()
        stale = [r for r in (*self._queue, *self._prefilling, *self._decoding.values())
                 if r.deadline is not None and now >= r.deadline]
        for req in stale:
            self._evict(req, "timeout")

    def _grant(self, req: _Request, slot: int) -> None:
        req.slot = slot
        req.admit_t = time.perf_counter()
        req.chunks = plan_chunks(int(req.tokens.size), self.ladder)
        if req.weights_version is None:
            req.weights_version = 0  # the engine serves one version of the weights
        self._stats["slot_allocs"] += 1
        if slot in self._used_slots:
            self._stats["slot_reuses"] += 1
        self._used_slots.add(slot)
        self._prefilling.append(req)

    def _admit(self) -> None:
        while self._free and self._queue:
            self._grant(self._queue.popleft(), self._free.pop())

    def _prefill_one(self, req: _Request) -> None:
        size, valid = req.chunks[req.next_chunk]
        chunk = np.zeros((1, size), np.int64)
        chunk[0, :valid] = req.tokens[req.consumed:req.consumed + valid]
        is_first = req.next_chunk == 0
        is_final = req.next_chunk == len(req.chunks) - 1
        try:
            if self._chaos is not None:
                fault = self._chaos.draw("prefill_dispatch", self._stats["ticks"], unit=req.id)
                if fault is not None:
                    raise InjectedFaultError(fault)
            tok = self._prefill(self._params, self._cache, self._state,
                                torch.from_numpy(chunk).to(self.device), req.slot, valid,
                                req.budget, req.generator, is_first, is_final)
        except RuntimeError as exc:  # a device failure; a programming error propagates
            self._on_prefill_failure(req, exc)
            return
        req.next_chunk += 1
        req.consumed += valid
        self._stats["prefill_chunks"] += 1
        self._stats["prefill_pad_tokens"] += size - valid
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
        flip_slot = None
        if self._chaos is not None:
            fault = self._chaos.draw("decode_tick", self._stats["ticks"])
            if fault is not None and fault.kind == "poison":
                self._poison_slot(min(self._decoding))
            elif fault is not None and fault.kind == "bit_flip":
                # Silent decode corruption: one emitted token XOR'd with 1
                # after the host read; only the decode canary sees it.
                flip_slot = int((fault.extra or {}).get("slot", min(self._decoding)))
            if self._speculate_k > 0:
                fault = self._chaos.draw("draft_mismatch", self._stats["ticks"])
                if fault is not None and fault.kind == "poison":
                    # One slot's n-gram history blanked: its drafts degrade,
                    # verification keeps the output equal.
                    self._state.history[min(self._decoding)] = -1
        live = len(self._decoding)
        self._stats["occupancy_sum"] += live
        self._stats["peak_occupancy"] = max(self._stats["peak_occupancy"], live)
        k = self._speculate_k
        t0 = time.perf_counter() if k > 0 else 0.0
        sampled = sorted(self._decoding) if self._sampled else ()
        toks, emitted, bad = self._decode(self._params, self._cache, self._state, sampled)
        self._stats["decode_steps"] += 1
        # The tick's one host sync: the tokens, emitted counts, done flags
        # and the sentinel. The profiler times it as the tick's host_fetch_s.
        tf0 = time.perf_counter() if self._profiler is not None else 0.0
        host = torch.cat([toks, emitted[:, None], self._state.done.long()[:, None],
                          bad.long()[:, None]], dim=1).cpu().numpy()
        if self._profiler is not None:
            self._tick_fetch_s += time.perf_counter() - tf0
        if flip_slot is not None and flip_slot in self._decoding:
            host[flip_slot, 0] ^= 1
        drafted = accepted = 0
        for slot, req in list(self._decoding.items()):
            if host[slot, k + 3]:
                self._on_poisoned_slot(slot, req)
                continue
            cnt = int(host[slot, k + 1])
            req.out.extend(int(t) for t in host[slot, :cnt])
            if k > 0:
                req.spec_drafted += k
                req.spec_accepted += max(cnt - 1, 0)
                drafted += k
                accepted += max(cnt - 1, 0)
                self._stats["spec_decode_tokens"] += cnt
            if host[slot, k + 2]:
                del self._decoding[slot]
                self._retire(req)
        if k > 0:
            self._stats["spec_drafted"] += drafted
            self._stats["spec_accepted"] += accepted
            # The speculative dispatch is the (k+1)-position verify forward;
            # its host clock runs to the end of the tick's read.
            self._stats["spec_verify_s"] += time.perf_counter() - t0

    def _poison_slot(self, slot: int) -> None:
        """Chaos ``poison``: ``slot``'s KV rows turn NaN, for the decode
        sentinel to catch (an int8 cache has no NaN: the fault is skipped)."""
        cache = self._cache
        if not (torch.is_tensor(cache.k) and cache.k.is_floating_point()):
            logger.warning("serving: poison fault skipped: the cache holds no floats")
            return
        cache.k[:, slot] = float("nan")
        cache.v[:, slot] = float("nan")

    @property
    def preempted(self) -> bool:
        """True once the preemption drain latched."""
        return self._draining

    @property
    def preemption_exit_code(self) -> int:
        """The resumable exit code (75) of a drained, preempted engine."""
        return PREEMPTION_EXIT_CODE

    def attach_sdc_canary(self, canary) -> None:
        """Register a ``sdc.DecodeCanary`` (its constructor calls this): it
        runs at the end of every tick."""
        self._sdc_canary = canary

    def sdc_stats(self) -> Optional[dict]:
        """The decode canary's counters, or None without one."""
        return None if self._sdc_canary is None else self._sdc_canary.summary()

    def _retire(self, req: _Request) -> None:
        """Natural completion: the device row already flagged itself done,
        so the slot goes straight back to the free list."""
        self._free.append(req.slot)
        self._finish(req, "ok")

    def _finish(self, req: _Request, status: str) -> None:
        """The one exit of every submitted request, with its status."""
        req.status = status
        req.done_t = self._last_done_t = time.perf_counter()
        n_new = len(req.out)
        row = np.concatenate([req.tokens, np.asarray(req.out, np.int64),
                              np.full((req.budget - n_new,), self.pad_token_id, np.int64)])
        ttft = req.first_token_t - req.submit_t if req.first_token_t is not None else None
        tpot = ((req.done_t - req.first_token_t) / (n_new - 1)
                if req.first_token_t is not None and n_new > 1 else 0.0)
        if status == "ok":
            self._ttfts.append(ttft)
            self._tpots.append(tpot)
            self._queue_waits.append(req.admit_t - req.submit_t)
            self._prefill_lats.append(req.first_token_t - req.admit_t)
            self._stats["completed"] += 1
            self._stats["tokens_out"] += n_new
            self._stats["prompt_tokens_in"] += int(req.tokens.size)
        else:
            self._fstats[{"timeout": "timeouts", "shed": "sheds", "failed": "failed"}[status]] += 1
        self._window.append({"status": status, "ttft_s": ttft, "tpot_s": tpot,
                             "prompt_tokens": int(req.tokens.size), "new_tokens": n_new})
        if self._hub is not None:
            self._hub.observe_slo("serving_availability", status == "ok")
        self._finished.append({
            "id": req.id, "status": status, "tokens": row, "new_tokens": n_new,
            "ttft_s": ttft, "tpot_s": tpot, "weights_version": req.weights_version,
            "attempt": 1 + req.retries, "recovered": False,
            "drafted": req.spec_drafted, "accepted": req.spec_accepted})
        if self.telemetry is not None:
            self.telemetry.record_event(
                "serving_request_done", request_id=req.id, status=status, ttft_s=ttft,
                tpot_s=tpot, new_tokens=n_new, prompt_tokens=int(req.tokens.size),
                slot=req.slot, weights_version=req.weights_version)
            if status != "ok":
                self.telemetry.record_event("serving_fault", request_id=req.id, status=status,
                                            retries=req.retries)

    # -- failure recovery --------------------------------------------------

    def _evict(self, req: _Request, status: str) -> None:
        """End an in-flight request (a missed deadline): take it out of the
        stage that holds it, free its slot now (the device row is marked
        done, so the next decode step masks it) and finish it."""
        if req in self._queue:
            self._queue.remove(req)
        elif req in self._prefilling:
            self._prefilling.remove(req)
        elif req.slot is not None and self._decoding.get(req.slot) is req:
            del self._decoding[req.slot]
        if req.slot is not None:
            self._release_slot(req.slot)
        self._finish(req, status)

    def _release_slot(self, slot: int) -> None:
        _release_slot_op(self._state, slot)
        self._free.append(slot)

    def _retry_or_fail(self, req: _Request, reason: str = "") -> None:
        """Send the request back to the head of the queue to replay from
        its prompt, or finish it ``failed`` once ``max_retries`` is spent."""
        if req.retries >= int(self.config.max_retries):
            logger.warning("serving: request %d failed after %d retries (%s)", req.id,
                           req.retries, reason)
            self._finish(req, "failed")
            return
        req.retries += 1
        self._fstats["retries"] += 1
        req.reset_for_retry()
        self._queue.appendleft(req)

    def _on_prefill_failure(self, req: _Request, exc: Exception) -> None:
        """A prefill chunk raised: free what the request held, then retry
        or fail it."""
        logger.warning("serving: prefill failed for request %d: %s", req.id, exc)
        if req in self._prefilling:
            self._prefilling.remove(req)
        if req.slot is not None:
            self._release_slot(req.slot)
            req.slot = None
        self._retry_or_fail(req, reason=str(exc))

    def _on_poisoned_slot(self, slot: int, req: _Request) -> None:
        """The decode sentinel saw non-finite logits in ``slot``: its cache
        rows are corrupt, so the slot leaves rotation for good and the
        request replays elsewhere."""
        del self._decoding[slot]
        self._quarantine_slot(slot)
        req.slot = None
        self._retry_or_fail(req, reason=f"nonfinite logits in slot {slot}")

    def _quarantine_slot(self, slot: int) -> None:
        self._quarantined_slots.add(slot)
        self._fstats["slot_quarantines"] += 1
        _release_slot_op(self._state, slot)
        logger.warning("serving: quarantined slot %d (nonfinite logits); %d/%d slots remain",
                       slot, self.n_slots - len(self._quarantined_slots), self.n_slots)
        if self.telemetry is not None:
            self.telemetry.record_event("serving_slot_quarantined", slot=slot)

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
        for res in self.poll():  # rows shed inside submit()
            results[res["id"]] = res["tokens"]
        self._push_telemetry_summary()
        return [results[i] for i in ids]

    def warmup(self) -> None:
        """Run one request whose prompt walks every ladder rung, and two
        decode steps, then reset the metrics so a timed run starts clean."""
        prompt_len = min(sum(self.ladder), self.t_max - 2)
        self.run([np.ones((prompt_len,), np.int64)], max_new_tokens=2)
        self.reset_metrics()

    def reset_metrics(self) -> None:
        """Zero every counter, latency sample and window; device state
        stays."""
        self._stats = dict.fromkeys(
            ("submitted", "completed", "ticks", "decode_steps", "prefill_chunks",
             "prefill_pad_tokens", "tokens_out", "prompt_tokens_in", "slot_allocs",
             "slot_reuses", "occupancy_sum", "peak_occupancy", "queue_depth_sum",
             "queue_samples", "spec_drafted", "spec_accepted", "spec_decode_tokens"), 0)
        self._stats["spec_verify_s"] = 0.0
        # Keys of the JAX package's fault block; lanes, handoffs and the
        # canary are not ported and stay 0.
        self._fstats = dict.fromkeys(
            ("sheds", "timeouts", "failed", "retries", "slot_quarantines", "lane_quarantines",
             "handoff_retries", "handoff_delays", "promoted", "rolled_back"), 0)
        self._idle_ticks = 0
        self._first_submit_t = None
        self._last_done_t = None
        for samples in (self._ttfts, self._tpots, self._queue_waits, self._prefill_lats,
                        self._window, self._queue_depth_window, self._finished):
            samples.clear()
        if self._profiler is not None:
            # Warm-up records would skew the term means and the flight ring.
            self._profiler.reset()
        if self._sdc_canary is not None:
            self._sdc_canary.reset_counters()

    def close(self) -> None:
        """Push the ``stats()`` block into the telemetry stream."""
        self._push_telemetry_summary()

    def _push_telemetry_summary(self) -> None:
        if self.telemetry is not None:
            self.telemetry.record_serving(self.stats())

    # -- reporting ---------------------------------------------------------

    def stats(self) -> dict:
        """The JAX package's serving block, on the host clock: TTFT and
        TPOT, queue depth, slot occupancy, aggregate tokens/s, and the
        ``window``, ``faults`` and ``speculation`` blocks. Eager PyTorch
        compiles no program, so the executable counts are None; there is
        one weights version (0) and no canary, SDC canary or journal."""
        s = self._stats
        elapsed = None
        if self._first_submit_t is not None:
            elapsed = (self._last_done_t or time.perf_counter()) - self._first_submit_t
        ttft = np.asarray(self._ttfts, np.float64)
        tpot = np.asarray(self._tpots, np.float64)
        return {
            "requests_submitted": s["submitted"],
            "requests_completed": s["completed"],
            "tokens_out": s["tokens_out"],
            "prompt_tokens_in": s["prompt_tokens_in"],
            "elapsed_s": round(elapsed, 6) if elapsed else None,
            "tokens_per_s": round(s["tokens_out"] / elapsed, 3) if elapsed else None,
            "ttft_p50_s": float(np.percentile(ttft, 50)) if ttft.size else None,
            "ttft_p95_s": float(np.percentile(ttft, 95)) if ttft.size else None,
            "ttft_queue_wait_mean_s": (float(np.mean(self._queue_waits))
                                       if self._queue_waits else None),
            "ttft_prefill_mean_s": (float(np.mean(self._prefill_lats))
                                    if self._prefill_lats else None),
            "tpot_mean_s": float(tpot.mean()) if tpot.size else None,
            "ticks": s["ticks"],
            "decode_steps": s["decode_steps"],
            "prefill_chunks": s["prefill_chunks"],
            "prefill_pad_tokens": s["prefill_pad_tokens"],
            "prefill_ladder": list(self.ladder),
            "n_slots": self.n_slots,
            "mean_occupancy": (round(s["occupancy_sum"] / s["decode_steps"], 3)
                               if s["decode_steps"] else None),
            "peak_occupancy": s["peak_occupancy"],
            "mean_queue_depth": (round(s["queue_depth_sum"] / s["queue_samples"], 3)
                                 if s["queue_samples"] else None),
            "slot_allocs": s["slot_allocs"],
            "slot_reuses": s["slot_reuses"],
            "steady_recompiles": 0,
            "decode_executables": None,
            "prefill_executables": None,
            "weights_version": 0,
            "canary": None,
            "sdc": None,
            "journal": None,
            "window": self.window_stats(),
            "faults": self.fault_stats(),
            "speculation": self.speculation_stats(),
        }

    def window_stats(self) -> dict:
        """SLO aggregates over the last ``window_requests`` terminal
        requests and as many per-tick queue depths: ok-only TTFT/TPOT
        percentiles, per-status rates, and ``prompt_decode_ratio`` (ok
        prompt tokens over ok tokens out)."""
        agg = _slo_aggregate(list(self._window))
        qd = np.asarray(self._queue_depth_window, np.float64)
        ok_prompt = sum(e["prompt_tokens"] for e in self._window if e["status"] == "ok")
        ok_new = sum(e["new_tokens"] for e in self._window if e["status"] == "ok")

        def pct(a, q):
            return float(np.percentile(a, q)) if a.size else None

        return {
            "requests": agg["n"],
            "capacity": self._window.maxlen,
            "ok": agg["ok"],
            "ttft_p50_s": pct(agg["ttft"], 50),
            "ttft_p95_s": pct(agg["ttft"], 95),
            "tpot_p50_s": pct(agg["tpot"], 50),
            "tpot_p95_s": pct(agg["tpot"], 95),
            "shed_rate": agg["shed_rate"],
            "timeout_rate": agg["timeout_rate"],
            "failed_rate": agg["failed_rate"],
            "queue_depth_p95": pct(qd, 95),
            "prompt_decode_ratio": round(ok_prompt / ok_new, 4) if ok_new else None,
        }

    def fault_stats(self) -> dict:
        """Terminal-status counters, retries, quarantines, the faults the
        injector drew and the preemption drain. The keys of what is not
        ported (lanes, handoffs, weight canaries, degraded mode) read 0 or
        False."""
        f = dict(self._fstats)
        f.update(injected=len(self._chaos.injected) if self._chaos is not None else 0,
                 quarantined_slots=len(self._quarantined_slots), degraded=False,
                 preempted=self._draining)
        return f

    def speculation_stats(self) -> dict:
        """Drafted and accepted tokens, the acceptance rate, tokens per
        decode step and the verify dispatches' host seconds; zeros and None
        with speculation off."""
        s = self._stats
        drafted, accepted, steps = int(s["spec_drafted"]), int(s["spec_accepted"]), \
            int(s["decode_steps"])
        return {
            "k": self._speculate_k,
            "ngram": self._spec_ngram,
            "drafted": drafted,
            "accepted": accepted,
            "acceptance_rate": round(accepted / drafted, 6) if drafted else None,
            "tokens_per_tick": round(s["spec_decode_tokens"] / steps, 6) if steps else None,
            "verify_time_s": round(float(s["spec_verify_s"]), 6),
        }

    def _spec_metrics(self) -> dict:
        """The hub's ``spec`` gauges (None reads 0.0)."""
        sp = self.speculation_stats()
        return {"k": float(sp["k"]), "drafted": float(sp["drafted"]),
                "accepted": float(sp["accepted"]),
                "acceptance_rate": float(sp["acceptance_rate"] or 0.0),
                "tokens_per_tick": float(sp["tokens_per_tick"] or 0.0),
                "verify_time_s": float(sp["verify_time_s"])}


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
        elif nxt < n:  # idle until the next arrival
            time.sleep(min(0.002, max(0.0, float(arrivals[order[nxt]]) - now)))
        for res in engine.poll():
            results[res["id"]] = res["tokens"]
    elapsed = time.perf_counter() - t0
    engine._push_telemetry_summary()
    return [results[ids[i]] for i in range(n)], elapsed
