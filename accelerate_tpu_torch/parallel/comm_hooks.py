"""Gradient-compression communication hooks: fp16/bf16 and PowerSGD.

Counterpart of ``accelerate_tpu/parallel/comm_hooks.py``, with its
algorithm (not torch's DDP hooks: ``powerSGD_hook`` works per bucket,
warm-starts and only compresses after ``start_powerSGD_iter``). The step
that uses them (``Accelerator._comm_hook_step``) runs its backward with no
DDP reducer and hands each process's own gradients to the reducer made
here, as the JAX step computes them under ``shard_map`` and reduces them
by hand:

- ``"no"``: the mean over the group.
- ``"fp16"`` / ``"bf16"``: cast to the wire dtype, summed over the group in
  that dtype and divided by the group's size in it (the JAX ``pmean``'s
  order; torch's ``fp16_compress_hook`` divides first), cast back.
- ``"powersgd"``: rank-r power iteration with error feedback (Vogels et
  al., 2019) on each gradient as a matrix ``M (n×m)``: ``P = mean(M@Q)``
  orthonormalised, ``Q' = mean(Mᵀ@P)``, ``M̂ = P@Q'ᵀ``, and ``M − M̂``
  carried into the next step's gradient. Gradients with fewer than 2 dims
  or ``min(n, m) <= rank`` (or where the factors cost as much as ``M``)
  are averaged plainly.

The matrix of a gradient is its leaf's in the JAX package's flax tree
(``models/convert.flax_leaf``): ``(shape[0], prod(shape[1:]))`` of the flax
leaf, a scanned stack's layers taken together (``(L, in·out)``), so that
the same leaves are compressed, and into the same approximation, as in the
JAX package. The gradients come in and go out under their flax names
(``flax_gradients``, ``set_from_flax``).

The start vectors ``Q`` come from a ``torch.Generator`` seeded with the
step's seed: ``jax.random``'s draws cannot be reproduced, so a parity check
carries the JAX ``q`` across as numpy, as weights are carried. The QR's
column signs may differ from ``jnp.linalg.qr``'s; ``M̂`` does not depend on
them.
"""

from __future__ import annotations

import math

import torch
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

from ..utils import operations

COMM_HOOKS = ("no", "fp16", "bf16", "powersgd")


def _matrix_shape(g) -> tuple[int, int]:
    return g.shape[0], math.prod(g.shape[1:])


def _compressible(g, rank: int) -> bool:
    if getattr(g, "ndim", 0) < 2:
        return False
    n, m = _matrix_shape(g)
    # Below this point the factors P (n·r) + Q (m·r) cost as much wire as M.
    return min(n, m) > rank and rank * (n + m) < n * m


def init_powersgd_state(grads: dict, rank: int, seed: int = 0, device=None) -> dict:
    """Per leaf (flax name → tensor of its shape, on ``meta`` too):
    ``{"q": (m, r) start vectors, "e": (n, m) zeros}`` on ``device`` (default
    the leaf's) where it is compressible, else ``{}``. Q is drawn in the
    leaves' sorted order from a generator seeded with ``seed`` and is the
    same on every process; the error feedback is this process's own."""
    gen = torch.Generator().manual_seed(seed)
    states = {}
    for name in sorted(grads):
        g = grads[name]
        if _compressible(g, rank):
            n, m = _matrix_shape(g)
            q = torch.randn((m, rank), generator=gen, dtype=torch.float32)
            dev = g.device if device is None else device
            states[name] = {"q": q.to(dev),
                            "e": torch.zeros((n, m), dtype=torch.float32, device=dev)}
        else:
            states[name] = {}
    return states


def _orthonormalize(p: torch.Tensor) -> torch.Tensor:
    """Thin QR: an orthonormal basis of the columns of ``p`` (n, r)."""
    return torch.linalg.qr(p, mode="reduced").Q


def _mean_in_place(tensors: list, world: int, group) -> None:
    """Each tensor replaced by its mean over ``group``: one all-reduce of a
    flat buffer per dtype, summed and divided in that dtype."""
    for dtype in dict.fromkeys(t.dtype for t in tensors):
        same = [t for t in tensors if t.dtype == dtype]
        flat = _flatten_dense_tensors(same)
        operations.all_reduce(flat, group=group)
        flat.div_(world)
        torch._foreach_copy_(same, _unflatten_dense_tensors(flat, same))


def make_comm_hook_reducer(comm_hook: str, group=None, world: int = 1, rank: int = 8):
    """``reducer(grads, comm_state) -> (reduced, new_comm_state)`` over the
    ``world`` processes of ``group`` (None: every process); ``grads`` maps
    flax leaf names to this process's gradients. With one process the
    reduction is the identity (PowerSGD still compresses)."""
    if comm_hook not in COMM_HOOKS:
        raise ValueError(f"comm_hook must be one of {COMM_HOOKS}, got {comm_hook!r}")

    def mean(tensors: list) -> None:
        if world > 1 and tensors:
            _mean_in_place(tensors, world, group)

    if comm_hook in ("no", "fp16", "bf16"):
        wire = {"no": None, "fp16": torch.float16, "bf16": torch.bfloat16}[comm_hook]

        def reducer(grads: dict, comm_state):
            names = list(grads)
            sent = [grads[n].detach().clone() if wire is None else grads[n].to(wire)
                    for n in names]
            mean(sent)
            return {n: t.to(grads[n].dtype) for n, t in zip(names, sent)}, comm_state

        return reducer

    def reducer(grads: dict, comm_state):  # powersgd
        plain = [n for n in grads if not comm_state.get(n)]
        packed = [n for n in grads if comm_state.get(n)]
        out = {}
        sent = [grads[n].detach().clone() for n in plain]
        mean(sent)
        out.update(zip(plain, sent))
        mats = {n: grads[n].reshape(_matrix_shape(grads[n])).float() + comm_state[n]["e"]
                for n in packed}
        ps = [mats[n] @ comm_state[n]["q"] for n in packed]
        mean(ps)
        ps = [_orthonormalize(p) for p in ps]
        qs = [mats[n].t() @ p for n, p in zip(packed, ps)]
        mean(qs)
        new_state = {n: comm_state[n] for n in plain}
        for n, p, q in zip(packed, ps, qs):
            approx = p @ q.t()
            out[n] = approx.reshape(grads[n].shape).to(grads[n].dtype)
            new_state[n] = {"q": q, "e": mats[n] - approx}
        return out, new_state

    return reducer


def flax_gradients(module, params: list) -> tuple[dict, list]:
    """This process's gradients of ``params`` (name, parameter) as the flax
    tree's leaves: ``{flax name: gradient in the flax layout}`` (a scanned
    stack's layers stacked in layer order), and the (parameter, leaf) rows
    that ``set_from_flax`` writes them back by."""
    from ..models.convert import flax_leaf

    rows, stacks, out = [], {}, {}
    for fqn, p in params:
        leaf = flax_leaf(module, fqn)
        rows.append((p, leaf))
        g = leaf.to_flax(p.grad)
        if leaf.index is None:
            out[leaf.name] = g
        else:
            stacks.setdefault(leaf.name, {})[leaf.index] = g
    for name, layers in stacks.items():
        out[name] = torch.stack([layers[i] for i in sorted(layers)])
    return out, rows


def set_from_flax(rows: list, grads: dict) -> None:
    """Each parameter's gradient copied from its flax leaf in ``grads``."""
    for p, leaf in rows:
        g = grads[leaf.name] if leaf.index is None else grads[leaf.name][leaf.index]
        p.grad.copy_(leaf.from_flax(g))
