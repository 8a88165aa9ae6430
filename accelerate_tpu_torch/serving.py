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
without adding another. With a ``tracing.TraceRecorder`` (``tracing=``, or
the recorder's from ``TelemetryKwargs(tracing=True)``) every request's
life becomes spans (host clocks only).

Weight versions: ``swap_params`` binds a new parameter tree as the primary
version; ``begin_canary`` routes an exact fraction of new admissions to a
candidate until ``promote_canary`` or ``rollback_canary``. A request keeps
the version it bound at its first grant; while two versions are live,
each tick decodes once per version, each pass leaving the other version's
slots untouched.

Crash durability: with a ``journal.RequestJournal`` (``journal=`` or
``ServingConfig.journal_dir``) every admission, binding, tick of progress
and terminal row is journaled; ``submit(client_request_id=...)`` dedupes;
a ``FaultInjector`` drawing ``engine_crash`` exits the process (code 78)
after the tick's flush; ``recover()`` on a new engine over the same
directory returns the finished requests' rows and replays the others
bit-equal.

Not ported yet, and refused where set: the compile manager (ROADMAP.md
Queue A item 12.4). The engine runs every config of the Llama chassis,
Mixtral, GPT-2, OPT and GPT-NeoX, or the plan ``forward_cached=`` names;
an encoder-decoder module (T5, Whisper) is refused, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import itertools
import logging
import os
import time
from collections import deque
from typing import Optional

import numpy as np
import torch

from .generation import (
    ENCDEC_GENERATION_PLANS,
    KVCache,
    QuantPages,
    _cache_dims,
    _decode_params,
    _filter_logits,
    _generation_plan,
    _params_device,
    init_slot_cache,
    sample_logits,
)
from .chaos import InjectedFaultError, flush_injected_log
from .journal import JournalAdoptionError, RequestJournal
from .profiler import dump_flight
from .utils.constants import PREEMPTION_EXIT_CODE, SERVING_CRASH_EXIT_CODE
from .utils.dataclasses import ServingConfig

logger = logging.getLogger(__name__)

# Engine arguments of the JAX package that the port does not take yet.
_UNPORTED_ENGINE_ARGS = {
    "compile_manager": "ROADMAP.md Queue A item 12.4 (compile_manager.py)",
}

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


def _cache_sides(cache: KVCache) -> list:
    """The cache's tensors indexed (L, N, T, ...): k and v, or an int8
    cache's codes and scales."""
    return [t for side in (cache.k, cache.v)
            for t in ((side.data, side.scale) if isinstance(side, QuantPages) else (side,))]


def _window_rows(cache: KVCache, width: int):
    """(rows (N, 1), positions (N, width)) of the window a decode step
    writes in every slot, at each slot's length, clamped to the last row
    as ``generation._write_plan`` clamps the writes past it."""
    t = _cache_sides(cache)[0].shape[2]
    pos = cache.length[:, None] + torch.arange(width, device=cache.length.device)[None, :]
    return torch.arange(pos.shape[0], device=pos.device)[:, None], pos.clamp(max=t - 1)


def _build_decode_step(fwd, cfg, temperature, top_k, top_p, eos_token_id,
                       speculate_k: int = 0):
    """One decode step for every slot: ``decode(params, cache, state,
    sampled_slots, run_mask) -> (toks (N, k+1), emitted (N,), bad (N,))``,
    where ``toks[slot, :emitted[slot]]`` are the tokens the slot produced
    (``k = 0``: one, for live rows) and ``bad`` flags live rows whose
    logits are not all finite. Live rows (``active & ~done``, and in
    ``run_mask`` when one is given) advance their cache length, token,
    count and history; the others compute masked values and keep their
    state. ``sampled_slots`` are the slots whose generator is drawn from
    (the live ones; the host knows them), so a stream advances only with
    its request.

    ``run_mask`` (a (N,) bool tensor, or None for every slot) selects the
    slots of one weights version while two are live: the step runs all N
    rows, so its shapes stay those of the one-version tick, and puts back
    the cache rows it wrote in the other slots, which it leaves
    bit-untouched.

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
    def decode(params, cache: KVCache, state: SlotState, sampled_slots=(), run_mask=None):
        live = state.active & ~state.done
        if run_mask is not None:
            live = live & run_mask
            rows, pos = _window_rows(cache, k + 1)
            held = [t[:, rows, pos] for t in _cache_sides(cache)]
        n = live.shape[0]
        out, e, bad = step(params, cache, state, sampled_slots, live, n)
        if run_mask is not None:
            hold = ~run_mask
            for t, old in zip(_cache_sides(cache), held):
                shape = (1, n) + (1,) * (old.dim() - 2)
                t[:, rows, pos] = torch.where(hold.view(shape), old, t[:, rows, pos])
        return out, e, bad

    def step(params, cache, state, sampled_slots, live, n):
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
                 "done_t", "deadline", "retries", "status", "weights_version", "canary",
                 "client_request_id", "recoveries", "spec_drafted", "spec_accepted")

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
        self.canary = False           # admitted inside a canary window
        self.client_request_id = None  # the caller's idempotency key
        self.recoveries = 0           # replays after a crash (no retry spent)
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
    by default the recorder's; ``tracing`` a ``tracing.TraceRecorder``, by
    default the recorder's; ``journal`` a ``journal.RequestJournal`` or a
    directory (``ServingConfig.journal_dir`` is the config's spelling)."""

    def __init__(self, model, config: Optional[ServingConfig] = None, *,
                 forward_cached=None, compile_manager=None, telemetry=None,
                 fault_tolerance=None, chaos=None, tracing=None, journal=None, profiler=None):
        if compile_manager is not None:
            raise NotImplementedError("ServingEngine(compile_manager=...) is not ported yet "
                                      f"({_UNPORTED_ENGINE_ARGS['compile_manager']})")
        self.config = c = config if config is not None else ServingConfig()
        # A FaultToleranceManager arms the preemption drain; a FaultInjector
        # the chaos draws at prefill_dispatch, decode_tick, draft_mismatch,
        # engine_crash and the journal's.
        self.fault_tolerance = fault_tolerance
        self.tracing = tracing if tracing is not None else getattr(telemetry, "tracing", None)
        jr = journal if journal is not None else c.journal_dir
        if isinstance(jr, (str, os.PathLike)):
            jr = RequestJournal(str(jr), fsync=c.journal_fsync,
                                segment_records=c.journal_segment_records)
        self._journal = jr
        # Tokens each live request emitted this tick: the tick's progress
        # record. Idempotency keys, cached terminal rows, recovery counts.
        self._journal_tokens: dict[int, list[int]] = {}
        self._client_ids: dict[str, int] = {}
        self._cached_rows: dict[int, dict] = {}
        self._jstats = dict.fromkeys(("recovered_inflight", "recovered_terminal", "deduped"), 0)
        self.chaos = chaos
        self._draining = False
        self._sdc_canary = None
        self.telemetry = telemetry
        # Per-tick attribution (profiler.py): host perf_counter sections
        # only. None: every hook is one check.
        self._profiler = profiler if profiler is not None else getattr(
            telemetry, "profiler", None)
        self._tick_fetch_s = 0.0
        module = getattr(model, "module", model)
        self.cfg = module.config
        name = type(module).__name__
        if forward_cached is None and name in ENCDEC_GENERATION_PLANS:
            raise ValueError("ServingEngine serves causal-LM plans; encoder-decoder families "
                             f"({name}) keep the static generate() path.")
        fwd = _generation_plan(module, forward_cached)
        self._params = _decode_params(model)
        self.device = _params_device(self._params)
        # Weight versions: _params is the primary's tree; a request decodes
        # the version it bound at its grant, which stays installed until no
        # request holds it.
        self._weights_version = 0
        self._params_by_version = {0: self._params}
        self._canary = None          # the canary window, or None
        self._canary_acc = 0.0       # its error-diffusion accumulator
        self._cohorts: dict[int, dict] = {}

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
        # The metrics hub (the tracer's, else the recorder's): stats() as
        # the "serving" provider, speculation_stats() as "spec", the
        # journal's, and one good/bad sample per finished request into the
        # availability SLO's window.
        self._hub = getattr(self.tracing, "hub", None) or getattr(telemetry, "hub", None)
        if self._hub is not None:
            self._hub.register_slo("serving_availability", 0.99)
            self._hub.register_provider("serving", self.stats, replace=True)
            self._hub.register_provider("spec", self._spec_metrics, replace=True)
            if self._journal is not None:
                self._hub.register_provider("journal", self._journal.stats, replace=True)

    @property
    def chaos(self):
        """The attached ``chaos.FaultInjector``, or None. Attaching one
        also wires the tracer's annotations and the journal's draws."""
        return self._chaos

    @chaos.setter
    def chaos(self, injector) -> None:
        self._chaos = injector
        if injector is not None and self.tracing is not None:
            self.tracing.attach_chaos(injector)
        jr = getattr(self, "_journal", None)
        if jr is not None:
            jr.chaos = injector

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

        ``client_request_id`` is the caller's idempotency key: a submit
        with a key seen before (in this process, or in the journal that
        ``recover()`` read) runs nothing and returns the first request's
        id; if that request has finished, its row goes to ``poll()`` again.

        With ``max_queue_depth`` set and the queue full,
        ``overload_policy`` decides: ``reject`` finishes this request
        ``shed``, ``shed_oldest`` sheds the oldest queued request instead,
        ``block`` ticks the engine until the queue has room."""
        cid = str(client_request_id) if client_request_id is not None else None
        if cid is not None and cid in self._client_ids:
            known = self._client_ids[cid]
            self._jstats["deduped"] += 1
            row = self._cached_rows.get(known)
            if row is not None:
                self._finished.append(dict(row))
            return known
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
        req.client_request_id = cid
        if cid is not None:
            self._client_ids[cid] = req.id
        deadline = deadline_s if deadline_s is not None else self.config.deadline_s
        if deadline is not None:
            if float(deadline) <= 0:
                raise ValueError(f"deadline_s must be > 0, got {deadline}")
            req.deadline = req.submit_t + float(deadline)
            self._has_deadlines = True
        self._stats["submitted"] += 1
        if self._first_submit_t is None:
            self._first_submit_t = req.submit_t
        if self._journal is not None:
            # What a bit-equal replay needs: the prompt, the budget and the
            # sampling stream's state before its first draw; the deadline as
            # a budget beside the submit time on the monotonic clock.
            self._journal.append({
                "t": "admit", "rid": req.id, "cid": cid, "tokens": tokens.tolist(),
                "budget": budget,
                "rng": (req.generator_state.tolist()
                        if self._sampled and req.generator_state is not None else None),
                "deadline_s": float(deadline) if deadline is not None else None,
                "t_mono": req.submit_t, "weights_version": self._weights_version,
            }, tick=self._stats["ticks"], unit=req.id)
        if self.tracing is not None:
            self.tracing.request_submitted(
                req.id, self._stats["ticks"], req.submit_t, prompt_tokens=int(tokens.size),
                budget=budget, deadline_s=float(deadline) if deadline is not None else None)
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
        (generate()'s row layout); ``weights_version`` is the version the
        request bound at its grant (None if it never held a slot);
        ``attempt`` counts executions (1 + retries + replays after a
        crash); ``recovered`` flags a row that crossed a crash (a cached
        row from the journal, or a request replayed by ``recover()``);
        ``drafted``/``accepted`` count its speculative drafts."""
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
            }, gauges={"journal_lsn": (self._journal.stats()["appends"]
                                       if self._journal is not None else None),
                       "occupancy": len(self._decoding)})

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
        if self._journal is not None:
            if self._journal_tokens:
                # One progress record a tick, then the tick's durability
                # point under the fsync policy.
                self._journal.append({"t": "progress", "tick": self._stats["ticks"],
                                      "t_mono": time.perf_counter(),
                                      "toks": self._journal_tokens},
                                     tick=self._stats["ticks"])
                self._journal_tokens = {}
            self._journal.tick_flush()
        if self._chaos is not None:
            # After the flush: what the fsync policy promised durable is
            # durable when the process dies.
            fault = self._chaos.draw("engine_crash", self._stats["ticks"])
            if fault is not None and fault.kind == "crash":
                self._hard_crash(fault)
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
        if req.weights_version not in self._params_by_version:
            # The first grant binds a version (the canary's routing picks
            # it); a retry or a recovered request keeps its binding, so it
            # replays under the same weights.
            req.weights_version = self._route_version()
            req.canary = self._canary is not None
            if self._journal is not None and not self._journal_suppressed(req.id):
                self._journal.append({"t": "bind", "rid": req.id,
                                      "weights_version": req.weights_version,
                                      "t_mono": req.admit_t},
                                     tick=self._stats["ticks"], unit=req.id)
        self._stats["slot_allocs"] += 1
        if slot in self._used_slots:
            self._stats["slot_reuses"] += 1
        self._used_slots.add(slot)
        self._prefilling.append(req)
        if self.tracing is not None:
            # No prefill lanes: those are the disaggregated router's.
            self.tracing.request_granted(req.id, self._stats["ticks"], req.admit_t, slot=slot,
                                         lane=None, weights_version=req.weights_version,
                                         canary=bool(req.canary))

    def _admit(self) -> None:
        while self._free and self._queue:
            self._grant(self._queue.popleft(), self._free.pop())

    def _prefill_one(self, req: _Request) -> None:
        size, valid = req.chunks[req.next_chunk]
        chunk = np.zeros((1, size), np.int64)
        chunk[0, :valid] = req.tokens[req.consumed:req.consumed + valid]
        is_first = req.next_chunk == 0
        is_final = req.next_chunk == len(req.chunks) - 1
        tr = self.tracing
        t0 = time.perf_counter() if tr is not None else None
        try:
            if self._chaos is not None:
                fault = self._chaos.draw("prefill_dispatch", self._stats["ticks"], unit=req.id)
                if fault is not None:
                    raise InjectedFaultError(fault)
            tok = self._prefill(self._params_for(req.weights_version), self._cache, self._state,
                                torch.from_numpy(chunk).to(self.device), req.slot, valid,
                                req.budget, req.generator, is_first, is_final)
        except RuntimeError as exc:  # a device failure; a programming error propagates
            self._on_prefill_failure(req, exc)
            return
        req.next_chunk += 1
        req.consumed += valid
        self._stats["prefill_chunks"] += 1
        self._stats["prefill_pad_tokens"] += size - valid
        if tr is not None:
            # The chunk's host span: its dispatch, not its device time (the
            # final chunk's first token is read below).
            tr.prefill_chunk(req.id, self._stats["ticks"], t0, time.perf_counter(), size=size,
                             valid=valid, lane=None, slot=req.slot,
                             index=req.next_chunk - 1, final=is_final)
        if is_final:
            self._prefilling.remove(req)
            first = int(tok)  # the one host read of a prefill: the TTFT moment
            req.first_token_t = time.perf_counter()
            req.out.append(first)
            if self._journal is not None and not self._journal_suppressed(req.id):
                self._journal_tokens.setdefault(req.id, []).append(first)
            if tr is not None:
                tr.first_token(req.id, self._stats["ticks"], req.first_token_t)
            eos = self.config.eos_token_id
            if req.budget <= 1 or (eos is not None and first == eos):
                self._retire(req)
            else:
                self._decoding[req.slot] = req

    def _decode_groups(self) -> list:
        """``(version, run_mask)`` for each decode pass of this tick: one
        pass with no mask while every decoding slot holds one version; one
        pass per version, each with a (N,) bool mask of its slots, while
        two are live (a canary window, or requests of a swapped-out version
        draining)."""
        versions = sorted({r.weights_version for r in self._decoding.values()})
        if len(versions) <= 1:
            return [(versions[0] if versions else self._weights_version, None)]
        groups = []
        for v in versions:
            mask = np.zeros((self.n_slots,), bool)
            for slot, r in self._decoding.items():
                mask[slot] = r.weights_version == v
            groups.append((v, torch.from_numpy(mask).to(self.device)))
        return groups

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
        tr = self.tracing
        journal = self._journal
        for version, mask in self._decode_groups():
            members = {slot: req for slot, req in self._decoding.items()
                       if req.weights_version == version}
            t0 = time.perf_counter() if (tr is not None or k > 0) else 0.0
            sampled = sorted(members) if self._sampled else ()
            toks, emitted, bad = self._decode(self._params_for(version), self._cache,
                                              self._state, sampled, mask)
            self._stats["decode_steps"] += 1
            # The pass's one host read: the tokens, emitted counts, done
            # flags and the sentinel (one a tick while one version is live).
            # The profiler times it as the tick's host_fetch_s.
            tf0 = time.perf_counter() if self._profiler is not None else 0.0
            host = torch.cat([toks, emitted[:, None], self._state.done.long()[:, None],
                              bad.long()[:, None]], dim=1).cpu().numpy()
            self._stats["host_reads"] += 1
            if self._profiler is not None:
                self._tick_fetch_s += time.perf_counter() - tf0
            if flip_slot is not None and flip_slot in members:
                host[flip_slot, 0] ^= 1
                flip_slot = None  # one flip a tick, not one a pass
            drafted = accepted = 0
            for slot, req in members.items():
                if host[slot, k + 3]:
                    self._on_poisoned_slot(slot, req)
                    continue
                cnt = int(host[slot, k + 1])
                new = [int(t) for t in host[slot, :cnt]]
                req.out.extend(new)
                if journal is not None and not self._journal_suppressed(req.id):
                    self._journal_tokens.setdefault(req.id, []).extend(new)
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
                # The speculative dispatch is the (k+1)-position verify
                # forward; its host clock runs to the end of the pass's read.
                self._stats["spec_verify_s"] += time.perf_counter() - t0
            if tr is not None:
                tr.decode_tick(self._stats["ticks"], t0, time.perf_counter(),
                               weights_version=version, occupancy=live, n_slots=self.n_slots,
                               request_ids=[r.id for r in members.values()], drafted=drafted,
                               accepted=accepted)

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
        if req.canary and req.weights_version in self._cohorts:
            self._cohorts[req.weights_version]["events"].append(
                {"status": status, "ttft_s": ttft, "tpot_s": tpot})
        attempt = 1 + req.retries + req.recoveries
        result = {
            "id": req.id, "status": status, "tokens": row, "new_tokens": n_new,
            "ttft_s": ttft, "tpot_s": tpot, "weights_version": req.weights_version,
            "attempt": attempt, "recovered": req.recoveries > 0,
            "drafted": req.spec_drafted, "accepted": req.spec_accepted}
        self._finished.append(result)
        if req.client_request_id is not None:
            # A duplicate submit with this key gets this row again.
            self._cached_rows[req.id] = result
        if self._journal is not None and not self._journal_suppressed(req.id):
            self._journal_tokens.pop(req.id, None)
            # Self-contained: compaction may drop the request's other
            # records, and this row still answers a duplicate and a restart.
            self._journal.append({
                "t": "terminal", "rid": req.id, "cid": req.client_request_id,
                "status": status, "row": row.tolist(), "new_tokens": n_new,
                "ttft_s": ttft, "tpot_s": tpot, "weights_version": req.weights_version,
                "attempt": attempt, "t_mono": req.done_t,
                "drafted": req.spec_drafted, "accepted": req.spec_accepted,
            }, tick=self._stats["ticks"], unit=req.id)
        if len(self._params_by_version) > 1:
            self._gc_versions()
        if self.tracing is not None:
            self.tracing.request_finished(
                req.id, self._stats["ticks"], req.done_t, status=status, new_tokens=n_new,
                weights_version=req.weights_version, drafted=req.spec_drafted,
                accepted=req.spec_accepted)
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
        if self.tracing is not None:
            self.tracing.request_retry(req.id, self._stats["ticks"], reason=reason or "retry",
                                       attempt=req.retries)

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
        if req.canary and req.weights_version in self._cohorts:
            # A candidate whose slots go non-finite reads as a regression.
            self._cohorts[req.weights_version]["poisoned"] += 1
        self._retry_or_fail(req, reason=f"nonfinite logits in slot {slot}")

    def _quarantine_slot(self, slot: int) -> None:
        self._quarantined_slots.add(slot)
        self._fstats["slot_quarantines"] += 1
        if self.tracing is not None:
            self.tracing.quarantine("slot", slot, self._stats["ticks"])
        _release_slot_op(self._state, slot)
        logger.warning("serving: quarantined slot %d (nonfinite logits); %d/%d slots remain",
                       slot, self.n_slots - len(self._quarantined_slots), self.n_slots)
        if self.telemetry is not None:
            self.telemetry.record_event("serving_slot_quarantined", slot=slot)

    # -- crash durability (the journal) --------------------------------------

    @property
    def journal(self):
        """The attached ``journal.RequestJournal``, or None."""
        return self._journal

    def _journal_suppressed(self, rid: int) -> bool:
        """True for the decode canary's probe in flight: its records reach
        neither the journal (recover() would replay it) nor poll()."""
        c = self._sdc_canary
        return c is not None and c._inflight == rid

    def _hard_crash(self, fault) -> None:
        """An injected ``engine_crash``: die as a killed process dies, with
        no drain and no seal of the journal (what the fsync policy made
        durable is what a restart finds), after the telemetry event, the
        injector's log and the flight bundle."""
        code = int((fault.extra or {}).get("exit_code", SERVING_CRASH_EXIT_CODE))
        logger.error("serving: injected engine_crash: exiting %d (tick %d); %d request(s) in "
                     "flight%s", code, self._stats["ticks"], self.pending,
                     "" if self._journal is None else "; recover() replays them from the journal")
        if self.telemetry is not None:
            try:
                self.telemetry.record_event("serving_engine_crash", tick=self._stats["ticks"],
                                            exit_code=code, pending=self.pending,
                                            journaled=self._journal is not None)
            except Exception:  # dying anyway
                pass
        flush_injected_log(self._chaos, self.telemetry)
        # The flight bundle last: the flush above closed the lagged tick
        # record, so its newest entries name the tick that died.
        dump_flight(self._profiler, code,
                    reason=f"injected engine_crash at tick {self._stats['ticks']}")
        os._exit(code)

    def _restore_generator(self, rng) -> Optional[torch.Generator]:
        """A journaled request's generator, on this engine's device, in the
        state it had at ``submit``; None for a greedy engine. A state this
        device's generator cannot take (another device kind, the JAX
        package's key data) falls back to ``ServingConfig.seed``."""
        if not self._sampled:
            return None
        gen = torch.Generator(device=self.device)
        if rng is not None:
            try:
                return gen.set_state(torch.tensor(rng, dtype=torch.uint8))
            except (RuntimeError, ValueError, TypeError) as exc:
                logger.warning("serving: a journaled generator state does not fit this "
                               "device (%s); the request samples from seed %d", exc,
                               self.config.seed)
        return gen.manual_seed(self.config.seed)

    def recover(self, journal_dir: Optional[str] = None) -> dict:
        """Rebuild the requests of a dead engine from its journal. Call on
        a new (warmed) engine over the same directory: the attached
        journal's, or ``journal_dir`` when the engine has none, whose
        adoption sentinel it then claims (``JournalAdoptionError`` if
        another party holds it).

        - A request with a journaled terminal row returns that row through
          ``poll()``, flagged ``recovered``, and never runs again; its
          ``client_request_id`` keeps deduping.
        - Every other request goes back to the queue in admission order
          and replays from its prompt and its generator's journaled state,
          under the weights version it bound (bit-equal), spending a
          ``recoveries`` count, not a retry.
        - A deadline's remaining budget is what the dead process had left
          on its own monotonic clock, rebased on this one's.

        Returns the counts recovered and the journal's scan (records,
        segments, torn tails, corrupt lines skipped) and the seconds."""
        if self._journal is None and journal_dir is not None:
            self._journal = RequestJournal.adopt(
                str(journal_dir), f"serving-recover:pid={os.getpid()}",
                fsync=self.config.journal_fsync,
                segment_records=self.config.journal_segment_records)
            self._journal.chaos = self._chaos
            if self._hub is not None:
                self._hub.register_provider("journal", self._journal.stats, replace=True)
        if self._journal is None:
            raise ValueError("recover() needs a journal: pass journal_dir=, set "
                             "ServingConfig.journal_dir, or build the engine with journal=.")
        if not self._journal.adopted:
            holder = self._journal.adoption_holder()
            if holder is not None:
                raise JournalAdoptionError(
                    f"journal {self._journal.dir!r} is adopted by "
                    f"{holder.get('owner', '<unreadable>')!r}: its requests were drained "
                    "elsewhere; relaunch with a fresh journal_dir instead of replaying it")
        t_start = time.perf_counter()
        tr = self.tracing
        span = tr.begin("serving", "recover", self._stats["ticks"]) if tr is not None else None
        records, scan = self._journal.replay()
        admits: dict[int, dict] = {}
        terminals: dict[int, dict] = {}
        binds: dict[int, int] = {}
        recovers: dict[int, int] = {}
        last_mono = None
        for rec in records:
            tm = rec.get("t_mono")
            if tm is not None:
                last_mono = tm if last_mono is None else max(last_mono, tm)
            rid, t = rec.get("rid"), rec.get("t")
            if rid is None:
                continue
            rid = int(rid)
            if t == "admit":
                admits[rid] = rec
            elif t == "terminal":
                terminals[rid] = rec
            elif t == "bind" and rec.get("weights_version") is not None:
                binds[rid] = int(rec["weights_version"])
            elif t == "recovered":
                recovers[rid] = recovers.get(rid, 0) + 1
        now = time.perf_counter()
        n_terminal = n_inflight = 0
        # Compaction drops a finished request's admit record, so a cached
        # row may have no admit left: the union of both.
        for rid in sorted(set(admits) | set(terminals)):
            a, trec = admits.get(rid), terminals.get(rid)
            cid = a.get("cid") if a is not None else trec.get("cid")
            if trec is not None:
                result = {
                    "id": rid, "status": trec.get("status"),
                    "tokens": np.asarray(trec.get("row", []), np.int64),
                    "new_tokens": int(trec.get("new_tokens", 0)),
                    "ttft_s": trec.get("ttft_s"), "tpot_s": trec.get("tpot_s"),
                    "weights_version": trec.get("weights_version"),
                    "attempt": int(trec.get("attempt", 1)), "recovered": True,
                    "drafted": int(trec.get("drafted", 0)),
                    "accepted": int(trec.get("accepted", 0))}
                self._finished.append(result)
                self._cached_rows[rid] = result
                if cid is not None:
                    self._client_ids[str(cid)] = rid
                n_terminal += 1
                continue
            req = _Request(rid, np.asarray(a["tokens"], np.int64), int(a["budget"]),
                           self._restore_generator(a.get("rng")))
            req.client_request_id = str(cid) if cid is not None else None
            # The journaled recovered markers carry the count over crashes.
            req.recoveries = recovers.get(rid, 0) + 1
            dl = a.get("deadline_s")
            if dl is not None:
                elapsed = 0.0
                if last_mono is not None and a.get("t_mono") is not None:
                    # Both stamps on the dead process's monotonic clock.
                    elapsed = max(0.0, float(last_mono) - float(a["t_mono"]))
                req.deadline = now + max(0.0, float(dl) - elapsed)
                self._has_deadlines = True
            v = binds.get(rid)
            if v is not None and v in self._params_by_version:
                # _grant keeps the binding: the replay runs the same weights.
                req.weights_version = v
            if req.client_request_id is not None:
                self._client_ids[req.client_request_id] = rid
            self._queue.append(req)
            self._journal.append({"t": "recovered", "rid": rid, "tick": self._stats["ticks"],
                                  "t_mono": now}, tick=self._stats["ticks"], unit=rid)
            self._stats["submitted"] += 1
            n_inflight += 1
            if tr is not None:
                tr.request_retry(rid, self._stats["ticks"], reason="recovered",
                                 attempt=req.retries + req.recoveries)
        if admits or terminals:
            # New ids never collide with journaled ones.
            self._ids = itertools.count(max([*admits, *terminals]) + 1)
        self._journal.tick_flush()
        self._jstats["recovered_inflight"] += n_inflight
        self._jstats["recovered_terminal"] += n_terminal
        summary = {
            "recovered_inflight": n_inflight, "recovered_terminal": n_terminal,
            "records": scan["records"], "segments": scan["segments"],
            "torn_tails": scan["torn_tails"], "corrupt_skipped": scan["corrupt_skipped"],
            "elapsed_s": round(time.perf_counter() - t_start, 6)}
        if span is not None:
            tr.end(span, self._stats["ticks"], recovered_inflight=n_inflight,
                   recovered_terminal=n_terminal, torn_tails=scan["torn_tails"],
                   corrupt_skipped=scan["corrupt_skipped"])
        if self.telemetry is not None:
            self.telemetry.record_event("serving_recovered", **summary)
        logger.info("serving: recovered from journal %s: %d request(s) in flight re-queued, "
                    "%d cached terminal row(s) (%d torn tail(s) truncated, %d corrupt "
                    "record(s) skipped)", self._journal.dir, n_inflight, n_terminal,
                    scan["torn_tails"], scan["corrupt_skipped"])
        return summary

    # -- weight versions and the canary window ------------------------------

    @property
    def weights_version(self) -> int:
        """The primary version: what new admissions bind outside a canary
        window (0: the weights the engine was built with)."""
        return self._weights_version

    def _params_for(self, version):
        """The parameter tree of a version a request bound; a version stays
        installed while any request holds it."""
        if version == self._weights_version:
            return self._params
        return self._params_by_version[version]

    def _route_version(self) -> int:
        """The version of a first grant. In a canary window an
        error-diffusion accumulator sends exactly the window's fraction of
        admissions to the candidate (no random draw, so a replay routes the
        same)."""
        c = self._canary
        if c is None:
            return self._weights_version
        self._canary_acc += c["fraction"]
        if self._canary_acc >= 1.0 - 1e-9:
            self._canary_acc -= 1.0
            c["routed_candidate"] += 1
            return c["version"]
        c["routed_primary"] += 1
        return self._weights_version

    def _gc_versions(self) -> None:
        """Drop the versions that are neither primary nor candidate and that
        no request in flight holds."""
        keep = {self._weights_version}
        if self._canary is not None:
            keep.add(self._canary["version"])
        for r in itertools.chain(self._queue, self._prefilling, self._decoding.values()):
            if r.weights_version is not None:
                keep.add(r.weights_version)
        for v in [v for v in self._params_by_version if v not in keep]:
            del self._params_by_version[v]

    def _validate_params_tree(self, params: dict) -> None:
        """The incoming tree must match the serving one name for name, in
        shape, dtype, device and, for a ``DTensor`` (``tp``), mesh and
        placements; the offending parameter is named."""
        cur = self._params
        if set(params) != set(cur):
            missing, extra = sorted(set(cur) - set(params)), sorted(set(params) - set(cur))
            raise ValueError(
                f"swap_params: the parameter names differ from the serving tree's (missing "
                f"{missing[:4]}, unexpected {extra[:4]}); publish the model family and config "
                "the engine was built with.")

        def leaves(name, x):
            if torch.is_tensor(x):
                return [(name, x)]
            if dataclasses.is_dataclass(x):  # a DecodeQuant's codes and scales
                return [(f"{name}.{f.name}", getattr(x, f.name)) for f in dataclasses.fields(x)
                        if torch.is_tensor(getattr(x, f.name))]
            return [(name, x)]

        for name in cur:
            a, b = cur[name], params[name]
            a_leaves, b_leaves = leaves(name, a), leaves(name, b)
            if (not (torch.is_tensor(a) and torch.is_tensor(b)) and type(a) is not type(b)) \
                    or len(a_leaves) != len(b_leaves):
                raise ValueError(f"swap_params: parameter {name!r} is a {type(b).__name__}, "
                                 f"serving holds a {type(a).__name__}.")
            for (leaf, a), (_, b) in zip(a_leaves, b_leaves):
                if not torch.is_tensor(b):
                    continue
                if a.shape != b.shape or a.dtype != b.dtype:
                    raise ValueError(f"swap_params: parameter {leaf!r} is "
                                     f"{tuple(b.shape)}/{b.dtype}, serving expects "
                                     f"{tuple(a.shape)}/{a.dtype}.")
                if a.device != b.device:
                    raise ValueError(f"swap_params: parameter {leaf!r} is on {b.device}, "
                                     f"serving runs on {a.device}.")
                pa, pb = getattr(a, "placements", None), getattr(b, "placements", None)
                if (pa, getattr(a, "device_mesh", None)) != (pb, getattr(b, "device_mesh", None)):
                    raise ValueError(f"swap_params: parameter {leaf!r} is placed {pb}, the "
                                     f"serving tree {pa}; redistribute it onto the serving "
                                     "mesh first.")

    def _check_new_version(self, weights_version) -> int:
        v = int(weights_version)
        if v <= self._weights_version:
            raise ValueError(f"weights_version {v} is not newer than the serving primary "
                             f"{self._weights_version}; versions are monotonic.")
        if self._canary is not None:
            raise ValueError(f"a canary for version {self._canary['version']} is active; "
                             "promote or roll it back before publishing again.")
        return v

    def swap_params(self, params, *, weights_version: int) -> None:
        """Bind ``params`` (a name → tensor dict as ``_decode_params`` gives,
        or a model) as the new primary version. Requests in flight finish
        on the version they bound; every admission from now on binds this
        one. The tensors are used as they are, not copied."""
        params = _decode_params(params)
        v = self._check_new_version(weights_version)
        self._validate_params_tree(params)
        self._params_by_version[v] = params
        self._weights_version = v
        self._params = params
        self._gc_versions()
        logger.debug("serving: params swapped to version %d", v)

    def begin_canary(self, params, *, weights_version: int, fraction: float = 0.1) -> None:
        """Install ``params`` as a candidate version and route ``fraction``
        of new admissions to it (exactly: error diffusion, not a draw)
        until :meth:`promote_canary` or :meth:`rollback_canary`; each arm's
        finished requests gather in :meth:`cohort_stats`."""
        if not 0.0 < float(fraction) <= 1.0:
            raise ValueError(f"canary fraction must be in (0, 1], got {fraction}")
        params = _decode_params(params)
        v = self._check_new_version(weights_version)
        self._validate_params_tree(params)
        self._params_by_version[v] = params
        self._canary = {"version": v, "fraction": float(fraction), "routed_candidate": 0,
                        "routed_primary": 0, "started_tick": self._stats["ticks"]}
        self._canary_acc = 0.0
        self._cohorts = {self._weights_version: {"events": [], "poisoned": 0},
                         v: {"events": [], "poisoned": 0}}

    def promote_canary(self) -> dict:
        """End the window with the candidate as primary; requests of the
        old version drain on it, then it goes."""
        c = self._require_canary()
        self._canary = None
        self._weights_version = c["version"]
        self._params = self._params_by_version[c["version"]]
        self._fstats["promoted"] += 1
        self._gc_versions()
        logger.info("serving: canary promoted: version %d is primary (%d canary / %d primary "
                    "admissions in the window)", c["version"], c["routed_candidate"],
                    c["routed_primary"])
        return c

    def rollback_canary(self) -> dict:
        """End the window discarding the candidate: new admissions bind
        the primary again, as if nothing had been published; the
        candidate's requests in flight finish on it, then it goes."""
        c = self._require_canary()
        self._canary = None
        self._fstats["rolled_back"] += 1
        self._gc_versions()
        logger.warning("serving: canary version %d rolled back; primary stays %d (%d canary / "
                       "%d primary admissions in the window)", c["version"],
                       self._weights_version, c["routed_candidate"], c["routed_primary"])
        return c

    def _require_canary(self) -> dict:
        if self._canary is None:
            raise ValueError("no canary window is active")
        return self._canary

    def canary_status(self) -> Optional[dict]:
        """The canary window (version, fraction, admissions routed to each
        arm, the tick it began), or None."""
        return dict(self._canary) if self._canary is not None else None

    def cohort_stats(self, version: int, warmup: int = 0) -> Optional[dict]:
        """SLO aggregates of one canary cohort past its first ``warmup``
        finished requests (None until the version has a cohort): rates
        over the window, ok-only TTFT/TPOT means, non-finite slots."""
        co = self._cohorts.get(version)
        if co is None:
            return None
        agg = _slo_aggregate(co["events"][int(warmup):])
        return {
            "version": int(version), "completed": agg["n"], "ok": agg["ok"],
            "ok_ttft_mean_s": float(agg["ttft"].mean()) if agg["ttft"].size else None,
            "ok_tpot_mean_s": float(agg["tpot"].mean()) if agg["tpot"].size else None,
            "timeout_rate": agg["timeout_rate"], "shed_rate": agg["shed_rate"],
            "failed_rate": agg["failed_rate"], "poisoned": int(co["poisoned"])}

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
        # The warm-up request stays out of the journal: recover() would
        # replay it.
        jr, self._journal = self._journal, None
        try:
            self.run([np.ones((prompt_len,), np.int64)], max_new_tokens=2)
        finally:
            self._journal = jr
        self.reset_metrics()

    def reset_metrics(self) -> None:
        """Zero every counter, latency sample and window; device state
        stays."""
        self._stats = dict.fromkeys(
            ("submitted", "completed", "ticks", "decode_steps", "prefill_chunks",
             "prefill_pad_tokens", "tokens_out", "prompt_tokens_in", "slot_allocs",
             "slot_reuses", "occupancy_sum", "peak_occupancy", "queue_depth_sum",
             "queue_samples", "spec_drafted", "spec_accepted", "spec_decode_tokens",
             "host_reads"), 0)
        self._stats["spec_verify_s"] = 0.0
        # Keys of the JAX package's fault block; lanes and handoffs (the
        # disaggregated router's) are not ported and stay 0.
        self._fstats = dict.fromkeys(
            ("sheds", "timeouts", "failed", "retries", "slot_quarantines", "lane_quarantines",
             "handoff_retries", "handoff_delays", "promoted", "rolled_back"), 0)
        self._idle_ticks = 0
        self._first_submit_t = None
        self._last_done_t = None
        for samples in (self._ttfts, self._tpots, self._queue_waits, self._prefill_lats,
                        self._window, self._queue_depth_window, self._finished):
            samples.clear()
        self._jstats = dict.fromkeys(self._jstats, 0)
        if self.tracing is not None:
            # The trace restarts with the metrics, at tick 0.
            self.tracing.reset()
        if self._profiler is not None:
            # Warm-up records would skew the term means and the flight ring.
            self._profiler.reset()
        if self._sdc_canary is not None:
            self._sdc_canary.reset_counters()

    def close(self) -> None:
        """Push the ``stats()`` block into the telemetry stream and seal the
        journal's active segment."""
        self._push_telemetry_summary()
        if self._journal is not None:
            self._journal.close()

    def _push_telemetry_summary(self) -> None:
        if self.telemetry is not None:
            self.telemetry.record_serving(self.stats())

    # -- reporting ---------------------------------------------------------

    def stats(self) -> dict:
        """The JAX package's serving block, on the host clock: TTFT and
        TPOT, queue depth, slot occupancy, aggregate tokens/s, the primary
        weights version, and the ``canary``, ``sdc``, ``journal``,
        ``window``, ``faults`` and ``speculation`` blocks. Eager PyTorch
        compiles no program, so the executable counts are None."""
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
            "weights_version": self._weights_version,
            "canary": self.canary_status(),
            "sdc": self.sdc_stats(),
            "journal": self.journal_stats(),
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

    def journal_stats(self) -> Optional[dict]:
        """The journal's counters (appends, syncs, rotations, compactions,
        torn writes and tails, corrupt lines skipped) and this engine's
        recovered and deduped counts, or None without a journal."""
        if self._journal is None:
            return None
        js = self._journal.stats()
        js.update(self._jstats)
        return js

    def fault_stats(self) -> dict:
        """Terminal-status counters, retries, quarantines, canary promotions
        and rollbacks, the faults the injector drew and the preemption
        drain. The keys of what is not ported (lanes, handoffs, degraded
        mode) read 0 or False."""
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
