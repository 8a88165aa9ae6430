"""Tensor parallelism at run time: the Megatron operators on local shards.

``parallel/sharding.py`` plans each parameter's placement from a family's
TP rule table and puts the module on it: a parameter the table splits
becomes a ``DTensor`` over the mesh's 1-D ``tp`` slice (``Shard(dim)``,
or ``_StridedShard`` where the split axis is not the outer part of a
fused dim, GPT-2's ``c_attn``), every other one stays a whole tensor on
every ``tp`` rank. The forward then runs on each rank's local shards with
local head counts, and the operators below put in the collectives that
GSPMD puts into the JAX package's global program. Every one is an
all-reduce over the ``tp`` group (``utils/operations.all_reduce``, which
counts them):

- ``linear``: a projection whose weight is split on its output rows is
  column-parallel: its input passes ``tp_input`` (the identity forward,
  its gradient all-reduced backward: Megatron's *f*), its output stays
  local. One split on its input columns is row-parallel: its partial
  product is all-reduced forward (*g*) and its bias added after. A whole
  bias of a column-parallel projection (the rule tables split no bias, as
  in the JAX plan) contributes this rank's rows (``pick_rows``), its
  gradient all-reduced.
- ``embedding``: a vocab-split table looks up the ids in its rows, zeros
  the others and all-reduces.
- ``vocab_logits``: a vocab-split head gives this rank's logits as a
  ``DTensor`` ``Shard(-1)`` (no gather); ``cross_entropy_loss`` takes it
  through ``vocab_parallel_nll``: the max, the sum of exponentials and
  the label logit all-reduced, the gradient local. ``gather_vocab`` makes
  whole logits (generation) by an all-reduce of zero-padded shards.
- ``heads_for_local_q``: where the q heads are split but the kv heads are
  whole (GQA kv heads below ``tp``: the plan keeps ``k_proj``/``v_proj``
  whole, with the JAX plan's warning), each rank takes the kv heads its q
  heads read, and the kv gradient is all-reduced. The JAX package keeps
  the heads whole on every rank there; the numbers are the same.

The memo in ``tp_input`` makes q, k and v (gate and up) share one *f*, so
their input gradients are summed before one all-reduce.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Shard

from ..utils import operations


def _strided_factor(placement) -> int:
    return getattr(placement, "split_factor", 1)


def splits(placement) -> bool:
    """Whether a placement splits a dim: ``Shard`` or ``_StridedShard``
    (which need not subclass ``Shard``), not ``Replicate`` or ``Partial``."""
    return getattr(placement, "dim", None) is not None


def is_split(t) -> bool:
    """Whether ``t`` is a parameter split over ``tp`` (a DTensor whose
    placement on its mesh splits a dim)."""
    return isinstance(t, DTensor) and splits(t.placements[0])


def _group(t: DTensor):
    return t.device_mesh.get_group()


def _rank_size(t: DTensor) -> tuple[int, int]:
    mesh = t.device_mesh
    return mesh.get_local_rank(), mesh.size()


def local_rows(length: int, placement, rank: int, size: int, device) -> torch.Tensor:
    """The indices of a dim of ``length`` that ``rank`` holds under
    ``placement``: ``Shard``'s contiguous block, or ``_StridedShard``'s
    blocks ``j·size + rank`` of ``split_factor·size`` equal ones."""
    sf = _strided_factor(placement)
    chunk = length // (sf * size)
    idx = torch.arange(chunk, device=device)
    return torch.cat([(j * size + rank) * chunk + idx for j in range(sf)])


class _CopyToTP(torch.autograd.Function):
    """The identity; backward, the gradient all-reduced over the group. The
    output shares the input's storage without being a view of it, so that
    ``tp_input``'s memo on the input (a reference to the output) makes no
    cycle through the view's base, which Python's collector cannot see."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.detach()

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        operations.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromTP(torch.autograd.Function):
    """The sum over the group; backward, the identity."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        operations.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


class _PickRows(torch.autograd.Function):
    """Rows ``index`` of a tensor whole on every rank; backward, their
    gradient scattered into zeros and all-reduced, so that the whole
    tensor's gradient holds every rank's rows."""

    @staticmethod
    def forward(ctx, whole, index, group):
        ctx.group, ctx.shape = group, whole.shape
        ctx.save_for_backward(index)
        return whole.index_select(0, index)

    @staticmethod
    def backward(ctx, g):
        (index,) = ctx.saved_tensors
        full = g.new_zeros(ctx.shape)
        full.index_copy_(0, index, g)
        operations.all_reduce(full, group=ctx.group)
        return full, None, None


def tp_input(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` entering column-parallel products (Megatron's *f*). Repeated
    calls on one tensor share one all-reduce backward."""
    if not (torch.is_grad_enabled() and x.requires_grad):
        return x
    memo = getattr(x, "_tp_input", None)
    if memo is not None and memo[0] is group:
        return memo[1]
    y = _CopyToTP.apply(x, group)
    x._tp_input = (group, y)
    return y


def tp_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """The partial sums of a row-parallel product summed over the group
    (Megatron's *g*)."""
    if torch.is_grad_enabled():
        return _ReduceFromTP.apply(x, group)
    x = x.contiguous().clone()
    operations.all_reduce(x, group=group)
    return x


def pick_rows(whole: torch.Tensor, split_like: DTensor) -> torch.Tensor:
    """The rows of ``whole`` (dim 0) that this rank's shard of
    ``split_like`` (split on its dim 0) holds."""
    rank, size = _rank_size(split_like)
    index = local_rows(whole.shape[0], split_like.placements[0], rank, size, whole.device)
    if torch.is_grad_enabled() and whole.requires_grad:
        return _PickRows.apply(whole, index, _group(split_like))
    return whole.index_select(0, index)


def linear(x: torch.Tensor, weight: DTensor, bias: Optional[torch.Tensor], dtype,
           fn: Callable = F.linear) -> torch.Tensor:
    """``fn(x, W) + b`` for a ``(out, in)`` weight split over ``tp``:
    column-parallel on dim 0 (local output features), row-parallel on dim
    1 (``x`` holds the local input features; the output is whole). An fp8
    linear (``ops/fp8.fp8_dot_general``) is told the split, so that it takes
    the amax of each split operand over the group; the row-parallel fp8
    product stays a partial sum, reduced after its scales are applied."""
    group = _group(weight)
    w = weight.to_local().to(dtype)
    dim = weight.placements[0].dim
    if getattr(fn, "takes_tp_split", False):
        fn = functools.partial(fn, tp_split=(dim, group))
    if dim == 0:
        y = fn(tp_input(x, group).to(dtype), w)
        if bias is not None:
            y = y + pick_rows(bias, weight).to(dtype)
        return y
    y = tp_reduce(fn(x.to(dtype), w), group)
    return y if bias is None else y + bias.to(dtype)


def embedding(ids: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """``F.embedding(ids, weight)``; a table split over ``tp`` on its rows
    (the vocab) looks up the ids in this rank's rows and all-reduces."""
    if not is_split(weight):
        return F.embedding(ids, weight)
    local = weight.to_local()
    rank, _ = _rank_size(weight)
    n = local.shape[0]
    start = rank * n
    outside = (ids < start) | (ids >= start + n)
    out = F.embedding((ids - start).masked_fill(outside, 0), local)
    out = out.masked_fill(outside[..., None], 0)
    return tp_reduce(out, _group(weight))


def vocab_logits(x: torch.Tensor, head: torch.Tensor, bias: Optional[torch.Tensor] = None,
                 post: Optional[Callable] = None):
    """``x @ headᵀ (+ bias)`` then ``post`` on the logits. A head split over
    ``tp`` on its rows (the vocab) gives this rank's vocab slice of the
    logits as a ``DTensor`` ``Shard(-1)`` over the ``tp`` mesh; the
    collectives that would gather it are left to the loss
    (``vocab_parallel_nll``) or to ``gather_vocab``."""
    if not is_split(head):
        y = F.linear(x, head)
        if bias is not None:
            y = y + bias
        return y if post is None else post(y)
    y = F.linear(tp_input(x, _group(head)), head.to_local())
    if bias is not None:
        y = y + pick_rows(bias, head)
    if post is not None:
        y = post(y)
    return DTensor.from_local(y, head.device_mesh, [Shard(y.dim() - 1)], run_check=False)


def gather_vocab(logits):
    """Whole logits of a ``vocab_logits`` DTensor (an all-reduce of this
    rank's slice in zeros, exact); other tensors as they are."""
    if not isinstance(logits, DTensor):
        return logits
    local = logits.to_local()
    rank, size = _rank_size(logits)
    n = local.shape[-1]
    full = local.new_zeros(local.shape[:-1] + (n * size,))
    full[..., rank * n:(rank + 1) * n] = local
    operations.all_reduce(full, group=_group(logits))
    return full


class _VocabParallelNLL(torch.autograd.Function):
    """Per-row ``logsumexp(x) − x[label]`` of fp32 logits split on the
    vocab: the max, the sum of exponentials and the label's logit
    all-reduced; the gradient ``softmax − onehot`` on the local slice."""

    @staticmethod
    def forward(ctx, local, target, start, group):
        n = local.shape[-1]
        m = local.max(-1).values
        operations.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
        e = torch.exp(local - m[:, None])
        s = e.sum(-1)
        operations.all_reduce(s, group=group)
        mine = (target >= start) & (target < start + n)
        t = torch.where(mine, target - start, 0)
        picked = torch.where(mine, local.gather(-1, t[:, None])[:, 0], 0.0)
        operations.all_reduce(picked, group=group)
        ctx.save_for_backward(e / s[:, None], t, mine)
        return torch.log(s) + m - picked

    @staticmethod
    def backward(ctx, g):
        softmax, t, mine = ctx.saved_tensors
        grad = softmax * g[:, None]
        grad.scatter_add_(-1, t[:, None], -(mine.to(g.dtype) * g)[:, None])
        return grad, None, None, None


def vocab_parallel_nll(logits: DTensor, labels: torch.Tensor) -> torch.Tensor:
    """Token losses (``logsumexp − logit of the label``, fp32) of vocab-split
    logits (``vocab_logits``), shaped like ``labels``; a label outside the
    vocab (``ignore_index``) gets a loss the caller masks."""
    local = logits.to_local().float()
    rank, _ = _rank_size(logits)
    v = local.shape[-1]
    nll = _VocabParallelNLL.apply(local.reshape(-1, v), labels.reshape(-1), rank * v,
                                  _group(logits))
    return nll.reshape(labels.shape)


def heads_for_local_q(q, k, v, num_heads: int, num_kv_heads: int, q_weight):
    """k and v for this rank's q heads. With the q heads split over ``tp``
    and the kv heads whole (the plan keeps a kv projection whole when its
    heads do not divide by ``tp``): the kv heads those q heads read, one
    head when they fall in one group, else every q head's own copy; the
    kv gradient (a partial sum over this rank's heads) all-reduced. Else
    as they are."""
    if q.shape[2] == num_heads or k.shape[2] != num_kv_heads or not is_split(q_weight):
        return k, v
    rank, _ = _rank_size(q_weight)
    group = _group(q_weight)
    hq, g = q.shape[2], num_heads // num_kv_heads
    out = []
    for t in (k, v):
        if torch.is_grad_enabled() and t.requires_grad:
            t = _CopyToTP.apply(t, group)
        if g % hq == 0:
            head = rank * hq // g
            out.append(t[:, :, head:head + 1])
        else:
            out.append(t.repeat_interleave(g, dim=2)[:, :, rank * hq:(rank + 1) * hq])
    return tuple(out)


def is_expert_split(t) -> bool:
    """Whether ``t`` is an expert stack split on its expert dim (dim 0)
    over the ep slice of the mesh (expert parallelism); the TP rule splits
    a stack's ffn dim, never dim 0."""
    return isinstance(t, DTensor) and getattr(t.placements[0], "dim", None) == 0


def expert_products(xe: torch.Tensor, w_gate, w_up, w_down, dtype) -> torch.Tensor:
    """The stacked SwiGLU experts on (E, C, d) inputs with the ffn dim of
    each expert split over ``tp`` (gate and up on their last dim, down on
    its middle one): local products, the down projection all-reduced. With
    the stacks split on their expert dim over ep (``is_expert_split``) the
    inputs are this rank's experts' (E/ep, C, d), and the products are
    local and whole."""
    if is_expert_split(w_gate):
        h = F.silu(torch.bmm(xe, w_gate.to_local().to(dtype))) * torch.bmm(
            xe, w_up.to_local().to(dtype))
        return torch.bmm(h, w_down.to_local().to(dtype))
    group = _group(w_gate)
    xe = tp_input(xe, group)
    h = F.silu(torch.bmm(xe, w_gate.to_local().to(dtype))) * torch.bmm(
        xe, w_up.to_local().to(dtype))
    return tp_reduce(torch.bmm(h, w_down.to_local().to(dtype)), group)
