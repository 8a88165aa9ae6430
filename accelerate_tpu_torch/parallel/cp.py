"""Context parallelism: ring attention over the ``cp`` mesh axis.

Counterpart of ``accelerate_tpu/parallel/cp.py``. Each process of the
``cp`` axis holds one contiguous chunk of the sequence: rank ``i`` holds
positions ``[i·s, (i+1)·s)`` of q, k and v, with ``s = S/cp``. Causal
masking comes from the chunks' offsets: the kernels take the global
positions of q's and k's first rows (``q_offset``, ``k_offset``).

- ``"alltoall"`` (the default) is the ring. The forward takes ``cp``
  steps; at step ``t`` the process holds the K/V chunk of rank
  ``(i − t) mod cp``. It posts the send of that chunk to rank ``i + 1`` and
  the receive of the next one from rank ``i − 1`` (``batch_isend_irecv``)
  before the chunk's kernel, so that the transfer overlaps the kernel, and
  calls the forward kernel with ``q_offset = i·s``,
  ``k_offset = ((i − t) mod cp)·s``. The partial outputs merge in fp32
  (``merge_flash_chunks``). The backward takes the same ``cp`` steps with
  the merged lse and ``δ = rowsum(dO∘O)``: dQ accumulates here, and fp32
  dK/dV accumulators travel with their K/V chunk, arriving back at the
  chunk's owner after the last step.
- ``"allgather"`` gathers K and V over ``cp`` and makes one kernel call
  with ``q_offset = i·s``, ``k_offset = 0``; the backward sums every
  rank's dK/dV of this chunk in fp32 (an all-to-all).

Each chunk's forward is ``hopper_flash.FLASH_FWD_OP``, so the ``flash``
and ``dots`` remat policies keep every chunk's outputs, as the JAX policies
keep each chunk's ``flash_out``/``flash_lse``: the recompute of a block
launches no forward kernel, and rotates K/V again through the same ``cp``
steps on every rank. On CUDA tensors the kernels run (or their wrappers
raise); on the CPU their plain versions.

The per-step helpers (``ring_source``, ``chunk_forward``,
``chunk_backward``) are what the ring runs between transfers; a caller
that holds every rank's chunks in one process (``chip_smoke.py``) runs
the same schedule with the rotation done in place.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from ..ops.hopper_flash import FLASH_FWD_OP, flash_bwd, merge_flash_chunks, output_delta

ROTATE_METHODS = ("alltoall", "allgather")


def mesh_axis(mesh, axis_name: str):
    """(size, this process's rank, process group) of a mesh axis; (1, 0,
    None) without a mesh or when the axis has one process."""
    if mesh is None or axis_name not in (mesh.mesh_dim_names or ()):
        return 1, 0, None
    size = mesh.size(mesh.mesh_dim_names.index(axis_name))
    if size == 1:
        return 1, 0, None
    return size, mesh.get_local_rank(axis_name), mesh.get_group(axis_name)


def ring_source(idx: int, step: int, cp: int) -> int:
    """The rank whose K/V chunk rank ``idx`` holds at ring step ``step``."""
    return (idx - step) % cp


def chunk_forward(q, k, v, out, lse, *, causal: bool, q_offset: int, k_offset: int):
    """One ring step's forward: q over one K/V chunk, merged in fp32 into
    ``(out, lse)`` (None before the first chunk). Returns the merged
    ``(out fp32 (B, Sq, H, D), lse (B, H, Sq))``."""
    o_i, lse_i = FLASH_FWD_OP(q, k, v, causal, q_offset, k_offset)
    if out is None:
        return o_i.float(), lse_i
    return merge_flash_chunks(out, lse, o_i, lse_i)


def chunk_backward(q, k, v, dout, lse, delta, dq, dk, dv, *, causal: bool, q_offset: int,
                   k_offset: int):
    """One ring step's backward: the dQ and dK/dV kernels on one K/V chunk
    with the merged ``lse`` and ``delta``, added into the fp32 accumulators
    ``dq``, ``dk`` and ``dv`` in place."""
    dq_i, dk_i, dv_i = flash_bwd(q, k, v, dout, lse, delta, causal=causal, q_offset=q_offset,
                                 k_offset=k_offset)
    dq.add_(dq_i)
    dk.add_(dk_i)
    dv.add_(dv_i)


class _Ring:
    """Point-to-point transfers to the next rank of the ``cp`` group and
    from the previous one."""

    def __init__(self, group, idx: int, cp: int):
        ranks = dist.get_process_group_ranks(group)
        self.group, self.next, self.prev = group, ranks[(idx + 1) % cp], ranks[(idx - 1) % cp]

    def start(self, tensors):
        """Post the sends of ``tensors`` and the receives of like ones."""
        bufs = [torch.empty_like(t) for t in tensors]
        ops = ([dist.P2POp(dist.isend, t, self.next, self.group) for t in tensors]
               + [dist.P2POp(dist.irecv, b, self.prev, self.group) for b in bufs])
        return tensors, bufs, dist.batch_isend_irecv(ops)

    @staticmethod
    def finish(pending):
        """Wait for a ``start`` and return the received tensors."""
        _, bufs, works = pending
        for work in works:
            work.wait()
        return bufs


def _ring_forward(q, k, v, causal, idx, cp, ring):
    s = q.shape[1]
    out = lse = None
    for step in range(cp):
        pending = ring.start([k, v]) if step < cp - 1 else None
        out, lse = chunk_forward(q, k, v, out, lse, causal=causal, q_offset=idx * s,
                                 k_offset=ring_source(idx, step, cp) * k.shape[1])
        if pending is not None:
            k, v = ring.finish(pending)
    return out, lse


def _ring_backward(q, k, v, dout, lse, delta, causal, idx, cp, ring):
    s = q.shape[1]
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros_like(dk)
    for step in range(cp):
        pending = ring.start([k, v]) if step < cp - 1 else None
        chunk_backward(q, k, v, dout, lse, delta, dq, dk, dv, causal=causal, q_offset=idx * s,
                       k_offset=ring_source(idx, step, cp) * k.shape[1])
        # The accumulators follow their chunk; after cp moves they are home.
        dk, dv = ring.finish(ring.start([dk, dv]))
        if pending is not None:
            k, v = ring.finish(pending)
    return dq, dk, dv


def _gather_sequence(x, group, cp):
    parts = [torch.empty_like(x) for _ in range(cp)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=1)


def _sum_chunks(x, group, cp):
    """Chunk ``i`` (along dim 1) of ``x`` summed over the ranks of ``group``,
    for rank ``i``: a reduce-scatter, run as an all-to-all and a sum."""
    b, s = x.shape[:2]
    send = x.reshape(b, cp, s // cp, *x.shape[2:]).transpose(0, 1).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return recv.sum(0)


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, idx, cp, group, method):
        s = q.shape[1]
        if method == "allgather":  # keeps the gathered K/V for the backward
            k, v = _gather_sequence(k, group, cp), _gather_sequence(v, group, cp)
            out, lse = chunk_forward(q, k, v, None, None, causal=causal, q_offset=idx * s,
                                     k_offset=0)
        else:
            out, lse = _ring_forward(q, k, v, causal, idx, cp, _Ring(group, idx, cp))
        out = out.to(q.dtype)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, idx, cp, group, method)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        causal, idx, cp, group, method = ctx.args
        dout = dout.to(q.dtype).contiguous()
        delta = output_delta(out, dout)
        if method == "allgather":
            dq, dk, dv = flash_bwd(q, k, v, dout, lse, delta, causal=causal,
                                   q_offset=idx * q.shape[1], k_offset=0)
            dk, dv = _sum_chunks(dk.float(), group, cp), _sum_chunks(dv.float(), group, cp)
        else:
            dq, dk, dv = _ring_backward(q, k, v, dout, lse, delta, causal, idx, cp,
                                        _Ring(group, idx, cp))
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None, None, None, None


def ring_attention(q, k, v, *, causal: bool = True, mesh=None,
                   rotate_method: Optional[str] = None, axis_name: str = "cp",
                   batch_axes: Optional[tuple] = ("dp_replicate", "dp_shard")):
    """Attention of this process's sequence chunk over the whole sequence,
    split over the ``axis_name`` axis of ``mesh`` (default: the set-up
    ``AcceleratorState``'s mesh and its ``cp_rotate_method``).

    q: (B, S/cp, Hq, D); k, v: (B, S/cp, Hkv, D). Returns (B, S/cp, Hq, D).
    With one process on the axis it is ``auto_flash_attention``.
    ``batch_axes`` is the JAX signature's: each process already holds its
    own rows, so the port reads nothing from it."""
    del batch_axes
    if mesh is None:
        from ..state import AcceleratorState, current_mesh

        mesh = current_mesh()
        if mesh is not None and rotate_method is None:
            rotate_method = AcceleratorState().parallelism_config.cp_rotate_method
    rotate_method = rotate_method or "alltoall"
    if rotate_method not in ROTATE_METHODS:
        raise ValueError(f"rotate_method must be alltoall|allgather, got {rotate_method!r}")
    cp, idx, group = mesh_axis(mesh, axis_name)
    if cp == 1:
        from ..ops.flash_attention import auto_flash_attention

        return auto_flash_attention(q, k, v, causal=causal, mesh=mesh)
    if q.shape[1] != k.shape[1]:
        raise ValueError(f"ring attention needs q and k chunks of one length, got "
                         f"{q.shape[1]} and {k.shape[1]}")
    return _RingAttention.apply(q.contiguous(), k.contiguous(), v.contiguous(), bool(causal),
                                idx, cp, group, rotate_method)
