"""Ulysses sequence parallelism over the ``sp`` mesh axis.

Counterpart of ``accelerate_tpu/parallel/sp.py``. Each process of the
``sp`` axis holds one contiguous slice of the sequence, ``(B, S/sp, H,
D)``. KV heads are first repeated up to the query heads (as the JAX
package does, so that the exchange is the same for q, k and v); an
all-to-all then trades sequence for heads, giving each process the whole
sequence for ``H/sp`` heads; ``flash_attention`` runs on it (the Hopper
kernels on CUDA tensors, their plain versions on the CPU); and a second
all-to-all trades the heads back. Head group ``r`` goes to rank ``r``.

The exchange is ``all_to_all_single`` on a contiguous buffer whose dim 0
is the peer: ``pack_*`` lays a tensor out for it and ``unpack_*`` reads
what came back, so a caller that holds every rank's slices in one process
(``chip_smoke.py``) can run the same layouts with the exchange done in
place.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..ops.flash_attention import _repeat_kv, flash_attention
from .cp import mesh_axis


def pack_seq_to_heads(x, sp: int):
    """(B, s, H, D) → the send buffer (sp, B, s, H/sp, D): head group j for
    rank j."""
    b, s, h, d = x.shape
    return x.reshape(b, s, sp, h // sp, d).permute(2, 0, 1, 3, 4).contiguous()


def unpack_seq_to_heads(recv):
    """The received (sp, B, s, H/sp, D), entry j rank j's slice of the
    sequence → (B, sp·s, H/sp, D)."""
    sp, b, s, hh, d = recv.shape
    return recv.permute(1, 0, 2, 3, 4).reshape(b, sp * s, hh, d)


def pack_heads_to_seq(x, sp: int):
    """(B, S, H/sp, D) → the send buffer (sp, B, S/sp, H/sp, D): slice j of
    the sequence for rank j."""
    b, s, hh, d = x.shape
    return x.reshape(b, sp, s // sp, hh, d).transpose(0, 1).contiguous()


def unpack_heads_to_seq(recv):
    """The received (sp, B, s, H/sp, D), entry j head group j → (B, s, H, D)."""
    sp, b, s, hh, d = recv.shape
    return recv.permute(1, 2, 0, 3, 4).reshape(b, s, sp * hh, d)


class _AllToAll(torch.autograd.Function):
    """``all_to_all_single`` over dim 0; its own transpose, so the backward
    is the same exchange of the gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous()  # empty_like would keep a permuted grad's strides
        out = torch.empty_like(grad)
        dist.all_to_all_single(out, grad, group=ctx.group)
        return out, None


def _mesh():
    from ..state import current_mesh

    return current_mesh()


def ulysses_attention(q, k, v, *, causal: bool = True, mesh=None, axis_name: str = "sp"):
    """Attention of this process's sequence slice over the whole sequence,
    split over the ``axis_name`` axis of ``mesh`` (default: the set-up
    ``AcceleratorState``'s mesh).

    q: (B, S/sp, Hq, D); k, v: (B, S/sp, Hkv, D). Returns (B, S/sp, Hq, D).
    Hq must divide by sp. With one process on the axis it is
    ``auto_flash_attention``."""
    if mesh is None:
        mesh = _mesh()
    sp, _, group = mesh_axis(mesh, axis_name)
    if sp == 1:
        from ..ops.flash_attention import auto_flash_attention

        return auto_flash_attention(q, k, v, causal=causal, mesh=mesh)
    hq = q.shape[2]
    if hq % sp:
        raise ValueError(f"num_attention_heads {hq} must divide by sp_size {sp}")
    k, v = _repeat_kv(k, v, hq)

    def seq_to_heads(x):
        return unpack_seq_to_heads(_AllToAll.apply(pack_seq_to_heads(x, sp), group))

    out = flash_attention(seq_to_heads(q), seq_to_heads(k), seq_to_heads(v), causal=causal)
    return unpack_heads_to_seq(_AllToAll.apply(pack_heads_to_seq(out, sp), group))
