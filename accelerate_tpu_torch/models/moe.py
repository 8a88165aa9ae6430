"""Mixtral-family sparse-MoE decoder in PyTorch.

Counterpart of ``accelerate_tpu/models/moe.py`` with the same numerics:

- **routing**: the router's product and softmax in fp32 (a true fp32
  product on the card: TF32 could flip a top-k choice), the top
  ``num_experts_per_tok`` experts with equal probabilities taken in index
  order, as ``jax.lax.top_k`` takes them, and their weights renormalised
  to sum to one;
- **capacity**: each expert takes ``capacity = max(1, min(ceil(k·T/E·cf),
  T))`` tokens (GShard/Switch). Tokens claim slots in token-major order, a
  token's second choice after its first; a choice past capacity is dropped
  and its token keeps only the residual path for it;
- **stacked experts**: ``w_gate``/``w_up`` ``(E, d, f)`` and ``w_down``
  ``(E, f, d)``, the router ``(d, E)``, all fp32 masters. Where the JAX
  layer contracts one-hot dispatch and combine tensors of ``(T, E, C)``,
  this one writes each kept token into its slot and reads the expert rows
  back by index: the same values, the combine weights rounded to the
  compute dtype before they mix, and the two choices summed in fp32;
- **the load-balance loss**: ``E · Σ_e frac_e · mean_prob_e`` times
  ``router_aux_loss_coef`` per layer, returned beside the logits
  (``return_aux=True``) where flax sows it.

The global batch: inside a train step over several processes
(``operations.loss_processes``) the JAX layer sees the global ``(T, E)``
array, so here capacity comes from the global token count, slot positions
run over every process's tokens in row order (process r's after process
r − 1's: one ``all_gather`` of the per-expert choice counts a layer), and
the aux loss takes ``frac`` and ``mean_prob`` over the global batch. Each
process's aux term is its share of the global one, scaled as
``cross_entropy_loss`` scales its sum, so that the step's mean over the
processes is the JAX loss and gives the JAX gradient.

The decoder reuses the Llama port's attention (``attention_impl``: the
Hopper flash kernels at Mixtral's GQA shape), norms and remat policies; the
decoder list is ``model.layers``, which FSDP2 wraps block by block.

Over a ``cp`` or ``sp`` axis each process holds a contiguous chunk of
the sequence of each of its rows (``parallel/cp.py``), while the JAX
layer's slot order runs token-major over the global ``(B, S)``: a
token's queue position counts every earlier row whole and the earlier
chunks of its own row, so the chunks of the processes interleave. The
gathered counts are therefore per (process, row) run, and each run's
offset is the sum of the runs before it in the global order
(``gather_choice_counts``); ``frac`` and ``mean_prob`` stay global.

Tensor parallelism (``mixtral_tp_rules()``, pure TP): the attention is
split as Llama's, and each expert's ffn dim over ``tp``
(``parallel/tp.expert_products``); the router stays whole, so every
``tp`` rank routes alike and drops the same choices.

Expert parallelism (``mixtral_tp_rules(ep_axes=...)`` with
``ParallelismConfig(ep_size=...)``): each expert stack is split on its
expert dim over ``ep_axes`` (a ``DTensor`` over that slice of the mesh,
``state.ExpertGroups``), so each ep rank holds ``E/ep`` experts. Routing
is unchanged: every rank routes its own tokens with the whole router,
over the global batch. The kept choices' rows then travel to the ranks
that own their experts (``parallel/ep.py``: one ``all_to_all_single``,
split sizes from the counts already gathered), each rank computes its
``(E/ep, C, d)`` products, and the reverse exchange brings the rows home
for the combine. Where ``ep_axes`` include ``tp``, whose ranks hold the
same rows, no row crosses ``tp``: each ``tp`` rank fills only its own
experts' slots and the rows it brings home are summed over ``tp``. The
result is the one without ep: the same slots, drops and aux loss; only
where the products run changes.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from functools import partial
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

from ..parallel import ep as ep_exchange
from ..parallel import tp
from ..parallel.pp import pipeline_forward
from ..state import current_expert_groups, current_parallelism_config, current_sequence_shard
from ..utils.operations import loss_group, loss_processes
from .llama import (
    LlamaAttention,
    LlamaConfig,
    RMSNorm,
    _Linear,
    _remat_policy,
    cross_entropy_loss,
    embed_tokens,
    rotary_embedding,
)

@dataclasses.dataclass
class MixtralConfig(LlamaConfig):
    num_local_experts: int = 8
    num_experts_per_tok: int = 2
    capacity_factor: float = 2.0
    router_aux_loss_coef: float = 0.02

    @classmethod
    def tiny(cls, **kw):
        defaults = dict(
            vocab_size=256, hidden_size=128, intermediate_size=256,
            num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
            max_position_embeddings=512, num_local_experts=4,
            num_experts_per_tok=2,
        )
        defaults.update(kw)
        return cls(**defaults)


def expert_capacity(cfg: MixtralConfig, tokens: int) -> int:
    """Slots per expert for ``tokens`` tokens, in the JAX layer's float order."""
    capacity = int(math.ceil(cfg.num_experts_per_tok * tokens / cfg.num_local_experts
                             * cfg.capacity_factor))
    return max(1, min(capacity, tokens))


@contextlib.contextmanager
def _true_fp32(device: torch.device):
    """fp32 products in fp32 on the card (TF32 off inside the block)."""
    if device.type != "cuda":
        yield
        return
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def router_probs(tokens: torch.Tensor, router: torch.Tensor) -> torch.Tensor:
    """(T, E) fp32 softmax of the tokens' router logits (``router`` (d, E))."""
    with _true_fp32(tokens.device):
        logits = tokens.float() @ router.float()
    return torch.softmax(logits, dim=-1)


def top_k_experts(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` most probable experts of each token and their weights
    renormalised to sum to one: equal probabilities in index order, as
    ``jax.lax.top_k`` orders them (``torch.topk`` promises no order)."""
    values, indices = torch.sort(probs, dim=-1, descending=True, stable=True)
    values, indices = values[:, :k], indices[:, :k]
    return values / values.sum(-1, keepdim=True).clamp_min(1e-9), indices


class Routing(NamedTuple):
    """Where each (token, choice) goes: ``experts`` (T, k), its slot
    ``position`` (T, k) in the expert's queue, ``kept`` (T, k) below
    capacity, the choice's ``weights`` (T, k) (zero where dropped); the
    per-expert ``dispatched`` counts (E,) of the batch they route over
    (the global one under a step over several processes); ``capacity``;
    ``counts``: the gathered per-run choice counts of a step over several
    processes (``parallel/ep.ChoiceCounts``), which the ep exchange plans
    from, else None."""

    experts: torch.Tensor
    position: torch.Tensor
    kept: torch.Tensor
    weights: torch.Tensor
    dispatched: torch.Tensor
    capacity: int
    counts: Optional[ep_exchange.ChoiceCounts] = None


def route(weights: torch.Tensor, experts: torch.Tensor, num_experts: int, capacity: int,
          offset=None, totals=None, counts=None) -> Routing:
    """Routing of the top-k choices (``top_k_experts``: ``weights``,
    ``experts`` (T, k)) into ``capacity`` slots per expert. ``offset``
    (R, E): for each of R equal runs of the tokens (a process's tokens, or
    each of its rows when the sequence is split: each row's chunk has its
    own place in the global order), the choices of each expert made by
    the tokens before the run; ``totals`` (E,): every choice of the batch
    (default: these tokens')."""
    t, k = experts.shape
    onehot = F.one_hot(experts, num_experts).reshape(t * k, num_experts)
    # Queue positions: token-major, a token's k-th choice after its (k-1)-th.
    runs = 1 if offset is None else offset.shape[0]
    per_run = onehot.reshape(runs, -1, num_experts)
    position = (torch.cumsum(per_run, 1) - per_run).reshape(t, k, num_experts)
    position = position.gather(-1, experts[..., None])[..., 0]
    if offset is not None:
        run = torch.arange(t, device=experts.device) // (t // runs)
        position = position + offset[run[:, None], experts]
    kept = position < capacity
    totals = onehot.sum(0) if totals is None else totals
    return Routing(experts, position, kept, torch.where(kept, weights, 0.0),
                   totals.clamp(max=capacity), capacity, counts)


def compute_dispatch(router_probs: torch.Tensor, num_experts_per_tok: int,
                     capacity: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The JAX package's dense GShard tensors of (T, E) ``router_probs``:
    ``dispatch`` (T, E, C), one where token t holds slot c of expert e, and
    ``combine`` (T, E, C), the dispatch weighted by the renormalised router
    weight. ``MoeLayer`` routes by index (``route``) to the same slots."""
    t, e = router_probs.shape
    r = route(*top_k_experts(router_probs, num_experts_per_tok), e, capacity)
    slot = torch.where(r.kept, r.position, capacity)
    pos_onehot = F.one_hot(r.experts * (capacity + 1) + slot, e * (capacity + 1))
    pos_onehot = pos_onehot.reshape(t, num_experts_per_tok, e, capacity + 1)[..., :capacity]
    pos_onehot = pos_onehot.to(router_probs.dtype)
    dispatch = pos_onehot.sum(1)
    combine = (pos_onehot * r.weights[:, :, None, None]).sum(1)
    return dispatch, combine


def load_balance_loss(router_probs: torch.Tensor, dispatch: torch.Tensor) -> torch.Tensor:
    """Switch-Transformer aux loss: E · Σ_e fraction_dispatched_e · mean_prob_e."""
    e = router_probs.shape[-1]
    tokens_per_expert = dispatch.sum((0, 2))
    frac = tokens_per_expert / dispatch.sum().clamp_min(1.0)
    return e * torch.sum(frac * router_probs.mean(0).float())


def _run_keys(ranks: list, runs: int) -> list:
    """The place in the global token order of each process's runs: (its
    global row, its slice of the sequence) for run ``c`` of ``ranks[i]``,
    rows by ``data_parallel_index`` (group order without a set-up state)."""
    cfg = current_parallelism_config()
    if cfg is None:
        return [(i * runs + c, 0) for i in range(len(ranks)) for c in range(runs)]
    return [(cfg.data_parallel_index(g) * runs + c, cfg.sequence_index(g))
            for g in ranks for c in range(runs)]


def gather_choice_counts(counts: torch.Tensor, tokens: int, group, capacity_of,
                         alone: bool = False) -> tuple[ep_exchange.ChoiceCounts, int]:
    """The (R, E) per-run choice counts of this process's ``tokens`` (R
    equal runs) gathered over ``group`` in one ``all_gather`` of R·(E + 1)
    integers, as the finished ``ChoiceCounts``, and the global token count.
    In a step (``group`` None: every process) the runs are placed in the
    global token order with the choices of each expert before each run,
    in one queue of ``capacity_of(global tokens)`` slots. ``alone``
    (outside a step) each process routes alone: its runs follow each
    other, its capacity is ``capacity_of(its tokens)`` and its slots start
    after the lower processes'; ``group`` None there is this process by
    itself, and nothing is gathered."""
    runs, e = counts.shape
    mine = torch.cat([counts, counts.new_full((runs, 1), tokens // runs)], 1)
    if alone and group is None:
        every, ranks, me = mine.cpu()[None], [dist.get_rank()], 0
    else:
        parts = [torch.empty_like(mine) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, mine, group=group)
        every = torch.stack(parts).cpu()
        ranks = (dist.get_process_group_ranks(group) if group is not None
                 else list(range(dist.get_world_size())))
        me = dist.get_rank(group)
    n = len(ranks)
    choices, sizes = every[..., :-1], every[..., -1].sum(1).tolist()
    if alone:
        offsets = torch.cumsum(choices, 1) - choices
        capacity = [capacity_of(size) for size in sizes]
        base, slots = [sum(capacity[:i]) for i in range(n)], sum(capacity)
    else:
        keys = _run_keys(ranks, runs)
        order = sorted(range(n * runs), key=keys.__getitem__)
        flat = choices.reshape(n * runs, e)
        before = torch.empty_like(flat)
        before[order] = torch.cumsum(flat[order], 0) - flat[order]
        offsets = before.reshape(n, runs, e)
        slots = capacity_of(sum(sizes))
        capacity, base = [slots] * n, [0] * n
    return (ep_exchange.ChoiceCounts(ranks, choices, offsets, capacity, base, slots, me),
            sum(sizes))


class MicrobatchRouting:
    """The routing state of a pipeline stage's ``count`` microbatches of one
    process's batch (``parallel/pp.py``), which go through each layer in
    row order: by layer, the choices of each expert made so far
    (``choices``) and before each microbatch (``before``), so that every
    microbatch takes the batch's capacity and its slots after the ones
    before it, as the whole batch routed at once would."""

    def __init__(self, count: int):
        self.count = count
        self.choices: dict = {}
        self.before: dict = {}


class Microbatch(NamedTuple):
    """Microbatch ``index`` of a ``MicrobatchRouting`` (a layer's
    ``processes`` argument inside a pipeline stage)."""

    index: int
    routing: MicrobatchRouting


def microbatch_aux(cfg: MixtralConfig, routing: MicrobatchRouting, extras: dict) -> dict:
    """Each microbatch's aux loss term once every microbatch has gone
    through the stage: ``extras`` maps each to its layers' ``(MoeLayer,
    probability sums)``; a layer's ``frac`` is the whole batch's, from its
    carried choices, and its ``mean_prob`` the sum of the microbatches'
    sums over the batch's tokens, so the terms add up to the batch's aux
    loss and each one's gradient reaches its own microbatch. Sets each
    layer's ``stats`` (dropped and routed choices) to the batch's."""
    e, k = cfg.num_local_experts, cfg.num_experts_per_tok
    terms = {}
    for key, parts in extras.items():
        term = 0.0
        for moe, sums in parts:
            totals = routing.choices[id(moe)]
            tokens = int(totals.sum()) // k
            dispatched = totals.clamp(max=expert_capacity(cfg, tokens))
            frac = dispatched.float() / dispatched.sum().clamp_min(1).float()
            term = term + cfg.router_aux_loss_coef * (e * torch.sum(frac * sums / tokens))
            moe.stats.update(dropped=tokens * k - dispatched.sum(), routed=tokens * k)
        terms[key] = term
    return terms


class MoeLayer(nn.Module):
    """Sparse SwiGLU expert layer (Mixtral's MLP) with stacked experts.

    ``forward(x, processes=1)`` returns ``(out, aux)``; with ``processes``
    > 1 it routes over the global batch of that many processes (one call
    each, in the same order). ``stats`` holds the last call's detached
    ``dropped`` and ``routed`` choice counts of the batch it routed over,
    and this process's chosen ``experts``, ``kept`` mask and router
    ``probs``."""

    def __init__(self, cfg: MixtralConfig, device=None):
        super().__init__()
        self.cfg = cfg
        d, e, f = cfg.hidden_size, cfg.num_local_experts, cfg.intermediate_size
        self.router = nn.Parameter(torch.empty(d, e, device=device))
        self.w_gate = nn.Parameter(torch.empty(e, d, f, device=device))
        self.w_up = nn.Parameter(torch.empty(e, d, f, device=device))
        self.w_down = nn.Parameter(torch.empty(e, f, d, device=device))
        self.stats: dict = {}

    def forward(self, x, processes: int = 1):
        b, s, d = x.shape
        tokens = x.reshape(b * s, d)
        r, aux = self.route(tokens, processes, rows=b)
        if tp.is_expert_split(self.w_gate):
            return self.expert_parallel(tokens, r).reshape(b, s, d), aux
        ye = self.experts(self.dispatch(tokens, r))
        return self.combine(ye, r).reshape(b, s, d), aux

    def route(self, tokens, processes: int = 1, rows: int = 1) -> tuple[Routing, torch.Tensor]:
        """The routing of (T, d) ``tokens`` (``rows`` rows) and the layer's
        aux loss; over several processes this process's share of it: its
        probabilities' sum times processes / T, whose mean over the
        processes is the global mean's term."""
        cfg = self.cfg
        e, k, t = cfg.num_local_experts, cfg.num_experts_per_tok, tokens.shape[0]
        probs = router_probs(tokens, self.router)
        weights, experts = top_k_experts(probs, k)
        if isinstance(processes, Microbatch):
            return self._route_microbatch(probs, weights, experts, processes)
        offset, totals, t_all, gathered = None, None, t, None
        if processes > 1:
            # One run per process, or one per row when the sequence is split.
            pc = current_parallelism_config()
            runs = rows if pc is not None and pc.seq_size > 1 else 1
            counts = F.one_hot(experts, e).reshape(runs, -1, e).sum(1)
            gathered, t_all = gather_choice_counts(counts, t, loss_group(),
                                                   partial(expert_capacity, cfg))
            offset = gathered.offsets[gathered.me].to(tokens.device)
            totals = gathered.counts.sum((0, 1)).to(tokens.device)
        capacity = expert_capacity(cfg, t) if gathered is None else gathered.slots
        r = route(weights, experts, e, capacity, offset, totals, gathered)
        frac = r.dispatched.float() / r.dispatched.sum().clamp_min(1).float()
        mean_prob = probs.mean(0) if processes == 1 else probs.sum(0) * (processes / t_all)
        aux = cfg.router_aux_loss_coef * (e * torch.sum(frac * mean_prob))
        self.stats = {"dropped": t_all * k - r.dispatched.sum().detach(), "routed": t_all * k,
                      "experts": experts.detach(), "kept": r.kept, "probs": probs.detach()}
        return r, aux

    def _route_microbatch(self, probs, weights, experts, mb: Microbatch):
        """The routing of one of a stage's microbatches (``MicrobatchRouting``)
        and its probabilities' sum, from which ``microbatch_aux`` makes its
        aux term once the batch's choices are all known. A recompute (remat)
        finds its microbatch's offsets where the first forward left them."""
        if tp.is_expert_split(self.w_gate):
            raise NotImplementedError(
                "experts split over ep inside a pipeline stage of several microbatches with "
                "one batch process: pass n_microbatches=1")
        e, t = self.cfg.num_local_experts, experts.shape[0]
        counts = F.one_hot(experts, e).reshape(-1, e).sum(0)
        key = (id(self), mb.index)
        first = key not in mb.routing.before
        if first:
            seen = mb.routing.choices.get(id(self), torch.zeros_like(counts))
            mb.routing.before[key] = seen
            mb.routing.choices[id(self)] = seen + counts
        capacity = expert_capacity(self.cfg, t * mb.routing.count)
        r = route(weights, experts, e, capacity, mb.routing.before[key][None])
        if first:  # microbatch_aux adds the batch's dropped and routed choices
            self.stats = {"experts": experts.detach(), "kept": r.kept, "probs": probs.detach()}
        return r, probs.sum(0)

    def dispatch(self, tokens, r: Routing) -> torch.Tensor:
        """(E, C, d) expert inputs: each kept choice's token in its slot,
        zeros in the empty ones. Dropped choices land in a spare slot C
        that no product reads."""
        e, d = self.cfg.num_local_experts, tokens.shape[1]
        t, k = r.experts.shape
        slot = torch.where(r.kept, r.position, r.capacity)
        token_of = torch.arange(t, device=tokens.device)[:, None].expand(t, k)
        buf = tokens.new_zeros((e, r.capacity + 1, d), dtype=self.cfg.dtype)
        buf = buf.index_put((r.experts.reshape(-1), slot.reshape(-1)),
                            tokens.to(self.cfg.dtype)[token_of.reshape(-1)])
        return buf[:, :r.capacity]

    def experts(self, xe) -> torch.Tensor:
        """The stacked SwiGLU experts on (E, C, d) inputs; under ep this
        rank's (E/ep, C, d)."""
        dtype = self.cfg.dtype
        if tp.is_split(self.w_gate):  # the ffn dim over tp, or the experts over ep
            return tp.expert_products(xe, self.w_gate, self.w_up, self.w_down, dtype)
        h = F.silu(torch.bmm(xe, self.w_gate.to(dtype))) * torch.bmm(xe, self.w_up.to(dtype))
        return torch.bmm(h, self.w_down.to(dtype))

    def combine(self, ye, r: Routing) -> torch.Tensor:
        """(T, d): each token's expert rows mixed with its weights rounded
        to the compute dtype, the k choices summed in fp32 (a dropped one
        reads a zero row with weight 0)."""
        dtype = self.cfg.dtype
        slot = torch.where(r.kept, r.position, r.capacity)
        picked = F.pad(ye, (0, 0, 0, 1))[r.experts, slot]
        w = r.weights.to(dtype).float()
        return (picked.float() * w[..., None]).sum(1).to(dtype)


    def expert_parallel(self, tokens, r: Routing) -> torch.Tensor:
        """(T, d) combined outputs with the experts split over ep
        (``state.ExpertGroups``): the kept choices' rows sent to their
        experts' ranks, this rank's ``(E/ep, C, d)`` products, the rows
        brought home and, where ``tp`` ranks share the ep slice, summed
        over ``tp``, then mixed as ``combine`` mixes them."""
        cfg, groups = self.cfg, current_expert_groups()
        if groups is None:
            raise RuntimeError("the experts are split over ep but no ep group is set up")
        dtype, d = cfg.dtype, tokens.shape[1]
        t, k = r.experts.shape
        counts = r.counts
        if counts is None:  # outside a step: each process routes alone
            e = cfg.num_local_experts
            own = F.one_hot(r.experts, e).reshape(1, -1, e).sum(1)
            counts, _ = gather_choice_counts(own, t, groups.exchange,
                                             partial(expert_capacity, cfg), alone=True)
        plan = ep_exchange.plan_exchange(r.experts, r.position, r.kept, counts, groups,
                                         cfg.num_local_experts)
        if groups.tp > 1:  # the expert path's input gradient is summed over tp
            tokens = tp.tp_input(tokens, groups.tp_group)
        rows = tokens.to(dtype)[plan.order // k]
        if groups.exchange is not None:
            rows = ep_exchange.ExchangeRows.apply(rows, plan.send, plan.recv, groups.exchange)
        local = cfg.num_local_experts // groups.size
        buf = rows.new_zeros((local * plan.queue, d)).index_put((plan.slots,), rows)
        ye = self.experts(buf.view(local, plan.queue, d)).reshape(local * plan.queue, d)
        back = ye[plan.slots]
        if groups.exchange is not None:
            back = ep_exchange.ExchangeRows.apply(back, plan.recv, plan.send, groups.exchange)
        picked = back.new_zeros((t * k, d)).index_put((plan.order,), back)
        if groups.tp > 1:
            picked = tp.tp_reduce(picked, groups.tp_group)
        w = r.weights.to(dtype).float()
        return (picked.view(t, k, d).float() * w[..., None]).sum(1).to(dtype)


class MixtralBlock(nn.Module):
    def __init__(self, cfg: MixtralConfig, device=None):
        super().__init__()
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, device)
        self.self_attn = LlamaAttention(cfg, device)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, device)
        self.moe = MoeLayer(cfg, device)

    def forward(self, x, cos, sin, processes: int = 1):
        h = x + self.self_attn(self.input_layernorm(x), cos, sin)
        out, aux = self.moe(self.post_attention_layernorm(h), processes)
        return h + out, aux


class MixtralModel(nn.Module):
    def __init__(self, cfg: MixtralConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size, device=device)
        self.layers = nn.ModuleList(MixtralBlock(cfg, device)
                                    for _ in range(cfg.num_hidden_layers))
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, device)
        policy = _remat_policy(cfg)
        self._remat_kwargs = {"use_reentrant": False}
        if policy is not None:
            self._remat_kwargs["context_fn"] = partial(create_selective_checkpoint_contexts, policy)

    def forward(self, input_ids):
        """(final hidden states, the sum of the layers' aux losses)."""
        cfg = self.cfg
        x = embed_tokens(cfg, self.embed_tokens.weight, input_ids)
        # Over a cp or sp axis this process holds slice i of n of each
        # sequence: its global positions, as LlamaModel takes them.
        n, i = current_sequence_shard()
        if n > 1 and cfg.attention_impl == "native":
            raise NotImplementedError(
                "attention_impl='native' attends within this process's slice of the sequence; "
                "over a cp or sp axis use flash, ring or ulysses")
        s = input_ids.shape[-1]
        positions = i * s + torch.arange(s, device=input_ids.device)
        cos, sin = rotary_embedding(positions, cfg.rotary_dim, cfg.rope_theta, x.dtype)
        # Read here, outside any checkpointed block: a recompute in the
        # backward routes over the same processes.
        processes = loss_processes()
        aux = x.new_zeros((), dtype=torch.float32)
        for layer in self.layers:
            if cfg.remat and torch.is_grad_enabled():
                x, a = checkpoint(layer, x, cos, sin, processes, **self._remat_kwargs)
            else:
                x, a = layer(x, cos, sin, processes)
            aux = aux + a
        return self.norm(x), aux


class MixtralForCausalLM(nn.Module):
    # FSDP2's per-block units (parallel/fsdp.decoder_blocks).
    _fsdp_blocks = (MixtralBlock,)
    # Set when prepare cuts the module to a pipeline stage
    # (parallel/pp.keep_stage): its forward is then the pipelined one.
    pipeline_stage = None

    def __init__(self, cfg: MixtralConfig, device=None):
        super().__init__()
        self.config = cfg
        self.model = MixtralModel(cfg, device)
        if not cfg.tie_word_embeddings:
            self.lm_head = _Linear(cfg.hidden_size, cfg.vocab_size, cfg.dtype, device)

    def head_weight(self) -> torch.Tensor:
        if self.config.tie_word_embeddings:
            return self.model.embed_tokens.weight
        return self.lm_head.weight

    def forward(self, input_ids, return_aux: bool = False):
        """Logits (B, S, V) in the compute dtype; with ``return_aux``,
        ``(logits, aux)``: the fp32 sum of the layers' router aux losses
        (flax's sown ``"losses"``)."""
        if self.pipeline_stage is not None:
            return pipeline_forward(self, input_ids, return_aux=return_aux)
        x, aux = self.model(input_ids)
        logits = tp.vocab_logits(x, self.head_weight().to(self.config.dtype))
        return (logits, aux) if return_aux else logits

    def router_stats(self) -> dict:
        """The last forward's dropped and routed choices, summed over the
        layers (detached tensors; read them after the step); on a pipeline
        stage, over its own layers."""
        layers = [blk.moe.stats for blk in self.model.layers if hasattr(blk, "moe")]
        return {"dropped": sum(s["dropped"] for s in layers),
                "routed": sum(s["routed"] for s in layers)}

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator, std: float = 0.02):
        """Seeded random weights: normal(0, std) matrices, expert stacks and
        embeddings, unit norm weights. ``generator`` must be on the
        parameters' device."""
        for p in self.parameters():
            if p.dim() >= 2:
                p.normal_(0.0, std, generator=generator)
            else:
                p.fill_(1.0)


def moe_cross_entropy_loss(model, input_ids, labels, ignore_index: int = -100):
    """The causal-LM loss of a ``MixtralForCausalLM`` (or a ``Model`` of
    one): ``cross_entropy_loss`` (the global token mean) plus the layers'
    router aux losses. A ``prepare_train_step`` loss and an imperative-loop
    one alike."""
    logits, aux = model(input_ids, return_aux=True)
    return cross_entropy_loss(logits, labels, ignore_index) + aux


def _mixtral_rules(scan_layers: bool, ep_axes: tuple) -> list[tuple[str, tuple]]:
    """The JAX package's TP + EP table as data: attention split as Llama's,
    the embedding and head on the vocab; the stacked experts on their
    expert dim over ``ep_axes`` or, without, on each expert's ffn dim over
    ``tp``. The router stays whole."""
    lead = (None,) if scan_layers else ()
    ep = ep_axes if len(ep_axes) != 1 else ep_axes[0]
    rules = [
        (r"self_attn/(q_proj|k_proj|v_proj)/kernel", lead + (None, "tp", None)),
        (r"self_attn/o_proj/kernel", lead + ("tp", None, None)),
        (r"embed_tokens/embedding", ("tp", None)),
        (r"lm_head/kernel", (None, "tp")),
    ]
    if ep_axes:
        return rules + [(r"moe/(w_gate|w_up|w_down)", lead + (ep, None, None))]
    return rules + [(r"moe/(w_gate|w_up)", lead + (None, None, "tp")),
                    (r"moe/w_down", lead + (None, "tp", None))]


def mixtral_tp_rules(scan_layers: bool = True, ep_axes: tuple = ()):
    """Mixtral's TP + EP rule table (``_mixtral_rules``): with ``ep_axes``
    (``ParallelismConfig.ep_axes``) the expert stacks split on their
    expert dim over those axes, else pure TP."""
    return _mixtral_rules(scan_layers, tuple(ep_axes))
