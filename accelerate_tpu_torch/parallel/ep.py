"""Expert parallelism: the token exchange of a Mixtral's expert layer.

Counterpart of what GSPMD makes of the JAX layer's dispatch and combine
einsums when the expert dim of the stacks is sharded over
``ParallelismConfig.ep_axes`` (``accelerate_tpu/models/moe.py:140-146``):
there the contractions become all-to-alls. Here each ep rank holds
``E/ep`` experts (``state.ExpertGroups``), routing stays whole and global
(``models/moe.py``), and the kept choices' token rows travel to the rank
that owns their expert and back:

- ``plan_exchange`` turns one routing into the two sides of the exchange:
  which of this process's choices it sends, to whom and in what order
  (by destination, then expert, then slot), and where each row it
  receives goes in its ``(E/ep, C, d)`` expert inputs. The split sizes and
  the slots come from the per-chunk choice counts the routing gathered
  already (``models/moe.gather_choice_counts``), so the exchange itself
  needs no other collective;
- ``exchange_rows`` is one ``all_to_all_single`` of rows packed by
  destination; ``ExchangeRows`` wraps it in autograd, its backward the
  transposed exchange (the received rows' gradients sent back to where the
  rows came from). The dispatch and the combine are both this function,
  with the splits swapped.

Over gloo with tensors on the card each exchange is staged through pinned
host memory (gloo's all-to-all takes host tensors), as ``parallel/pp.py``
stages its sends; ``exchange_counters`` counts the exchanges, their bytes
and the staged bytes. NCCL exchanges from the card.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist


class _ExchangeCounters:
    """Process-wide count of the exchanges (each ``all_to_all_single`` of
    rows, forward or backward), the bytes this process sends and
    receives, and the bytes staged through host memory (both ways)."""

    __slots__ = ("calls", "bytes", "staged_bytes")

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.calls = self.bytes = self.staged_bytes = 0

    def snapshot(self) -> dict:
        return {"calls": self.calls, "bytes": self.bytes, "staged_bytes": self.staged_bytes}


exchange_counters = _ExchangeCounters()


def exchange_rows(x: torch.Tensor, send: list, recv: list, group) -> torch.Tensor:
    """Rows of ``x`` (N, d), packed by destination (``send[j]`` rows for
    rank ``j`` of ``group``), exchanged: the rows every rank sent this
    one, ``recv[j]`` from rank ``j``, in rank order."""
    x = x.contiguous()
    out = x.new_empty((sum(recv),) + tuple(x.shape[1:]))
    exchange_counters.calls += 1
    exchange_counters.bytes += (x.numel() + out.numel()) * x.element_size()
    if x.is_cuda and dist.get_backend(group) == "gloo":
        host_in = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        host_in.copy_(x)
        host_out = torch.empty(out.shape, dtype=x.dtype, pin_memory=True)
        dist.all_to_all_single(host_out, host_in, list(recv), list(send), group=group)
        out.copy_(host_out)
        exchange_counters.staged_bytes += (x.numel() + out.numel()) * x.element_size()
        return out
    dist.all_to_all_single(out, x, list(recv), list(send), group=group)
    return out


class ExchangeRows(torch.autograd.Function):
    """``exchange_rows``; backward, the gradients of the received rows
    sent back to where the rows came from (the splits swapped)."""

    @staticmethod
    def forward(ctx, x, send, recv, group):
        ctx.args = (send, recv, group)
        return exchange_rows(x, send, recv, group)

    @staticmethod
    def backward(ctx, grad):
        send, recv, group = ctx.args
        return exchange_rows(grad.contiguous(), recv, send, group), None, None, None


class ChoiceCounts(NamedTuple):
    """Every routing source's choices per expert, as one routing gathered
    them. Source ``i`` (global rank ``ranks[i]``) holds ``chunks``
    contiguous runs of the routed order (its whole batch, or each of its
    rows when the sequence is split); ``counts[i, c, e]`` of its choices
    in run ``c`` went to expert ``e``, after ``offsets[i, c, e]`` choices
    of that expert that came before the run. ``capacity[i]`` bounds its
    slots, which start at ``base[i]`` in an owner's queue of ``slots``
    (one global queue in a train step: capacity the global one, base 0;
    outside a step each source routes alone and owns its own stretch).
    ``me``: this process's index. All on the host."""

    ranks: list
    counts: torch.Tensor
    offsets: torch.Tensor
    capacity: list
    base: list
    slots: int
    me: int

    def kept(self) -> torch.Tensor:
        """(n, chunks, E): the choices of each run below capacity."""
        cap = torch.tensor(self.capacity)[:, None, None]
        return torch.minimum(self.counts, (cap - self.offsets).clamp_min(0))


class Plan(NamedTuple):
    """One side of the exchange for one routing. ``order``: the flat
    (token, choice) indices this process sends, in send order; ``send``
    and ``recv``: the split sizes over the exchange group; ``slots``: for
    each received row, its flat index in the ``(E/ep · slots)`` rows of
    this rank's expert inputs; ``queue``: the slots per local expert."""

    order: torch.Tensor
    send: list
    recv: list
    slots: torch.Tensor
    queue: int


def plan_exchange(experts: torch.Tensor, position: torch.Tensor, kept: torch.Tensor,
                  counts: ChoiceCounts, groups, num_experts: int) -> Plan:
    """The exchange of one routing (``experts``, ``position``, ``kept``
    (T, k) of this process) over ``groups`` (``state.ExpertGroups``): the
    choices this rank sends are its kept ones whose expert lies with a
    rank of its own ``tp`` coordinate (each ``tp`` rank fills its own
    experts), ordered by expert then slot; what it receives from each
    source of the exchange group are that source's kept choices of this
    rank's experts in the same order, whose slots follow from the gathered
    counts."""
    per = num_experts // groups.size
    mine = groups.rank
    tp_me = mine % groups.tp
    flat_e = experts.reshape(-1)
    owner = flat_e // per
    sel = kept.reshape(-1) & (owner % groups.tp == tp_me)
    idx = sel.nonzero()[:, 0]
    key = flat_e[idx] * (counts.slots + 1) + position.reshape(-1)[idx]
    idx = idx[torch.argsort(key)]
    n_dest = groups.exchange_size
    send = torch.bincount(owner[idx] // groups.tp, minlength=n_dest).tolist()
    if groups.exchange is None:
        sources = [counts.me]
    else:
        sources = [counts.ranks.index(g) for g in dist.get_process_group_ranks(groups.exchange)]
    src, own = torch.tensor(sources), slice(mine * per, (mine + 1) * per)
    # (source, local expert, run): the kept choices of this rank's experts,
    # received in that order, and the slot each stretch starts at.
    kept_all = counts.kept()[src][:, :, own].transpose(1, 2)
    start = (counts.offsets[src][:, :, own].transpose(1, 2)
             + torch.tensor(counts.base)[src][:, None, None]
             + (torch.arange(per) * counts.slots)[:, None])
    kept_all, start = kept_all.reshape(-1), start.reshape(-1)
    first = torch.cumsum(kept_all, 0) - kept_all
    slots = (torch.repeat_interleave(start - first, kept_all)
             + torch.arange(int(kept_all.sum())))
    recv = kept_all.reshape(len(sources), -1).sum(1).tolist()
    return Plan(idx, send, recv, slots.to(experts.device), counts.slots)
