"""fp8 matmuls with per-tensor current scaling.

Counterpart of ``accelerate_tpu/ops/fp8.py``. Each operand's amax maps onto
the largest finite value of its fp8 format, every call (``_quant``): the
codes are ``(x.float() / scale)`` rounded to the format, with ``scale =
amax / fp8_max`` (1 where the tensor is all zero). The division, not a
multiply by the reciprocal, keeps the codes those of the JAX package bit
for bit.

Two formulations, as in the JAX package:

- **native** (the default; ``ACCELERATE_FP8_NATIVE=0`` turns it off, as
  there): the product takes the fp8 codes themselves and multiplies the
  fp32 result by the two scales (``_F8Linear``, the ``_f8_dot``
  ``custom_vjp`` there). The forward quantizes x and W in the forward
  format, the backward quantizes the cotangent in the backward format and
  computes dX = g·W and dW = gᵀ·x from the saved fp8 codes and scales (the
  residuals are the fp8 tensors, not the 16-bit values). HYBRID is e4m3
  forward and e5m2 backward.
- **QDQ**: quantize-dequantize each operand (``qdq_e4m3``, ``qdq_e5m2``,
  ``qdq_hybrid``) around a plain product in the compute dtype.

The fp8 product is the custom op ``accelerate_tpu_torch::fp8_mm``
(``FP8_MM_OP``), so that the ``dots`` remat policy can keep its output.
On a CUDA tensor it runs on Hopper's fp8 tensor cores through
``torch._scaled_mm`` (cuBLASLt's fp8 GEMM): the fp8 form of the plain
matrix product that the JAX package leaves to XLA (``lax.dot_general`` on
float8 operands), with no kernel of its own. cuBLASLt multiplies no e5m2
by e5m2, so the ``E5M2`` format (HYBRID never needs it: its backward is
e5m2 by e4m3) takes a path chosen by the operands' formats before any
launch: both operands dequantized to the output dtype, then a 16-bit
matrix product, which is what XLA computes for that format on chips
without the fp8 dot. Shapes that ``_scaled_mm`` does not take (dims not
multiples of 16) raise, naming the shape; nothing falls back silently. On
a CPU tensor the op runs its plain version, the computation of the JAX
package's ``_f8_dot`` on the CPU: the codes in fp32, ``torch.mm``, times
both scales, cast. ``PATHS`` counts the products by path.

``fp8_dot_general(fp8_format, use_during_eval, native)`` is the port's
linear, ``linear(x, w) = x @ wᵀ`` with ``w`` in ``nn.Linear``'s ``(out,
in)`` layout; inside ``eval_mode()`` it computes in full precision unless
``use_during_eval``.

The amax is the whole tensor's. In the JAX package's jitted step
``jnp.max(jnp.abs(x))`` is the max over the global array however GSPMD
splits it, so an operand split over processes takes its amax as an
``all_reduce(MAX)`` over exactly the processes it is split among, before
the scale (``_quant``'s ``groups``):

- ``x`` and the cotangent ``g`` over the processes of the running train
  step's batch (``utils/operations.loss_group``: ``dp_replicate``,
  ``dp_shard`` and ``cp``/``sp``, this stage's under ``pp``, never other
  ``tp`` ranks), read when the forward runs;
- under ``tp`` (``parallel/tp.linear`` passes the split), also over the
  ``tp`` group for an operand split there: the input of a row-parallel
  projection, the weight of every split projection and the cotangent of
  a column-parallel one. A replicated operand takes no collective.

Outside a step, and in the comm-hook step (whose gradients each process
computes on its own rows, as the JAX ``shard_map`` step does), the batch
takes none: each process scales its own tensors. ``AMAX_REDUCES`` counts
the reductions. ``fp8_einsum`` routes a two-operand einsum without
batch indices through the same linear and quantize-dequantizes the
operands of one with batch indices, as the JAX package's does.
"""

from __future__ import annotations

import os
import threading
from contextlib import contextmanager
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.utils.flop_counter import register_flop_formula

from ..utils.operations import loss_group, loss_processes

E4M3_MAX = 448.0        # float8_e4m3fn finite max
E5M2_MAX = 57344.0      # float8_e5m2 finite max
_F8_MAX = {torch.float8_e4m3fn: E4M3_MAX, torch.float8_e5m2: E5M2_MAX}

# Products since the last reset_paths(): on the fp8 tensor cores
# (``_scaled_mm``), dequantized to 16 bits (e5m2 by e5m2 on the card), or
# the plain version (CPU tensors).
PATHS = {"scaled_mm": 0, "dequantized": 0, "plain": 0}
# The amax all-reduces (one per operand and group) since the last reset_paths().
AMAX_REDUCES = {"all_reduce": 0}


def reset_paths() -> None:
    for name in PATHS:
        PATHS[name] = 0
    AMAX_REDUCES["all_reduce"] = 0


_EVAL_MODE = threading.local()


@contextmanager
def eval_mode(active: bool = True):
    """Inside this context the fp8 linears built with
    ``use_during_eval=False`` (the recipe's default) compute in full
    precision. ``Model.__call__`` enters it for inference calls."""
    prev = getattr(_EVAL_MODE, "active", False)
    _EVAL_MODE.active = active
    try:
        yield
    finally:
        _EVAL_MODE.active = prev


def in_eval_mode() -> bool:
    return getattr(_EVAL_MODE, "active", False)


def _scale(amax: torch.Tensor, fp8_max: float) -> torch.Tensor:
    """``amax / fp8_max`` (1 where amax is 0) by a true division: on a CUDA
    tensor, dividing by a Python number multiplies by its reciprocal
    instead, which can differ in the last bit."""
    return torch.where(amax > 0, amax / torch.full_like(amax, fp8_max), 1.0)


def _global_amax(amax: torch.Tensor, groups) -> torch.Tensor:
    """``amax`` (an fp32 scalar) as the max over every process of each of
    ``groups`` (in turn: the max over their product), in place."""
    for group in groups:
        dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
        AMAX_REDUCES["all_reduce"] += 1
    return amax


def batch_groups() -> tuple:
    """The groups over which the running train step splits its batch: its
    loss group when it averages more than one process's loss, else none
    (outside a step, one process, the comm-hook step)."""
    return (loss_group(),) if loss_processes() > 1 else ()


def _quant(x: torch.Tensor, fp8_dtype: torch.dtype, fp8_max: Optional[float] = None,
           groups=()):
    """x → (fp8 codes, fp32 scale) with per-tensor current scaling.

    The amax is read in fp32 (exact for 16-bit inputs), taken over the
    processes of ``groups`` where ``x`` is a shard of a larger tensor, and
    the division runs in fp32 and rounds once into the fp8 output:
    ``scale`` as a one-element 1-D tensor takes part in type promotion, so
    a 16-bit ``x`` is divided in fp32 without an fp32 copy of it."""
    fp8_max = _F8_MAX[fp8_dtype] if fp8_max is None else fp8_max
    amax = torch.linalg.vector_norm(x, float("inf"), dtype=torch.float32)
    scale = _scale(_global_amax(amax, groups), fp8_max)
    q = torch.empty(x.shape, dtype=fp8_dtype, device=x.device)
    torch.div(x, scale.reshape(1), out=q)
    return q, scale


class _GlobalMax(torch.autograd.Function):
    """The max of a local max over ``groups``; backward, the gradient of
    the global max (summed over the groups: each process holds its
    share of the cotangent) to the processes that hold it, shared among
    them as ``amax`` shares it among equal entries."""

    @staticmethod
    def forward(ctx, local, groups):
        ctx.groups = groups
        out = _global_amax(local.detach().clone(), groups)
        ctx.save_for_backward(local.detach() == out)
        return out

    @staticmethod
    def backward(ctx, g):
        (mine,) = ctx.saved_tensors
        g, holders = g.clone(), mine.to(g.dtype)
        for group in ctx.groups:
            dist.all_reduce(g, group=group)
            dist.all_reduce(holders, group=group)
        return torch.where(mine, g / holders, 0.0), None


def _qdq(x: torch.Tensor, fp8_dtype, fp8_max: float, groups=()) -> torch.Tensor:
    """Quantize-dequantize, differentiable as the JAX package's is (the
    gradient also flows through the scale, to the entry that holds the
    amax of the whole tensor over ``groups``)."""
    amax = x.abs().amax().float()
    if groups:
        amax = _GlobalMax.apply(amax, tuple(groups))
    scale = _scale(amax, fp8_max)
    q = (x.float() / scale).to(fp8_dtype)
    return (q.float() * scale).to(x.dtype)


def qdq_e4m3(x: torch.Tensor, groups=()) -> torch.Tensor:
    return _qdq(x, torch.float8_e4m3fn, E4M3_MAX, groups)


def qdq_e5m2(x: torch.Tensor, groups=()) -> torch.Tensor:
    return _qdq(x, torch.float8_e5m2, E5M2_MAX, groups)


class _QdqHybrid(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups, g_groups):
        ctx.g_groups = g_groups
        return qdq_e4m3(x, groups)

    @staticmethod
    def backward(ctx, g):
        return qdq_e5m2(g, ctx.g_groups), None, None


def qdq_hybrid(x: torch.Tensor, groups=(), g_groups=()) -> torch.Tensor:
    """E4M3 on the forward value, E5M2 on the backward cotangent (the
    HYBRID format); the amax of each over its ``groups``."""
    return _QdqHybrid.apply(x, tuple(groups), tuple(g_groups))


def backend_to_native(backend: str) -> Optional[bool]:
    """Recipe backend → the ``native`` flag of :func:`fp8_dot_general`: TE
    and AO select the native fp8 product, QDQ the simulation, AUTO the
    default (``ACCELERATE_FP8_NATIVE``). MS-AMP is refused, as in the JAX
    package."""
    b = backend.upper()
    if b == "MSAMP":
        raise ValueError(
            "MS-AMP is deprecated upstream and not supported; use "
            '"AUTO" (or "TE"/"AO" — both select native float8 dots).'
        )
    table = {"AUTO": None, "TE": True, "AO": True, "QDQ": False}
    if b not in table:
        raise ValueError(f"fp8 backend must be AUTO|TE|AO|QDQ, got {backend!r}")
    return table[b]


def _fmt_dtypes(fmt: str):
    """(forward, backward) fp8 dtypes of a format."""
    if fmt == "HYBRID":
        return torch.float8_e4m3fn, torch.float8_e5m2
    if fmt == "E4M3":
        return torch.float8_e4m3fn, torch.float8_e4m3fn
    if fmt == "E5M2":
        return torch.float8_e5m2, torch.float8_e5m2
    raise ValueError(f"fp8_format must be E4M3|E5M2|HYBRID, got {fmt}")


# ---------------------------------------------------------------------------
# The fp8 product: a custom op, so a remat policy can keep its output
# ---------------------------------------------------------------------------


def fp8_mm_plain(a, b, scale_a, scale_b, out_dtype):
    """``(a @ b) * scale_a * scale_b`` in fp32 from the codes, cast."""
    return (torch.mm(a.float(), b.float()) * (scale_a * scale_b)).to(out_dtype)


def _dequantized_mm(a, b, scale_a, scale_b, out_dtype):
    """The card's path for e5m2 by e5m2: each operand dequantized to
    ``out_dtype``, then a 16-bit product with fp32 accumulation."""
    return torch.mm((a.float() * scale_a).to(out_dtype), (b.float() * scale_b).to(out_dtype))


def _check_scaled_mm(a, b):
    """``_scaled_mm``'s contract on sm_90: ``a`` row-major, ``b``
    column-major, every dim a multiple of 16."""
    (m, k), n = a.shape, b.shape[1]
    if m % 16 or k % 16 or n % 16:
        raise ValueError(
            f"the fp8 product of ({m}, {k}) by ({k}, {n}) needs every dim a multiple of 16 "
            "(torch._scaled_mm on sm_90); use a model width that is, or fp8=False")
    if a.stride(1) != 1 or b.stride(0) != 1:
        raise ValueError(f"torch._scaled_mm takes a row-major and b column-major, got strides "
                         f"{a.stride()} and {b.stride()}")


@torch.library.custom_op("accelerate_tpu_torch::fp8_mm", mutates_args=())
def fp8_mm(a: torch.Tensor, b: torch.Tensor, scale_a: torch.Tensor, scale_b: torch.Tensor,
           out_dtype: torch.dtype) -> torch.Tensor:
    """``(a @ b) * scale_a * scale_b`` in ``out_dtype`` from fp8 ``a`` (M, K)
    and ``b`` (K, N) and fp32 scalar scales."""
    if a.device.type == "cpu":
        PATHS["plain"] += 1
        return fp8_mm_plain(a, b, scale_a, scale_b, out_dtype)
    if a.dtype == b.dtype == torch.float8_e5m2:
        PATHS["dequantized"] += 1
        return _dequantized_mm(a, b, scale_a, scale_b, out_dtype)
    _check_scaled_mm(a, b)
    PATHS["scaled_mm"] += 1
    return torch._scaled_mm(a, b, scale_a, scale_b, out_dtype=out_dtype)


@fp8_mm.register_fake
def _(a, b, scale_a, scale_b, out_dtype):
    return a.new_empty((a.shape[0], b.shape[1]), dtype=out_dtype)


# The op whose output the "dots" remat policy keeps.
FP8_MM_OP = torch.ops.accelerate_tpu_torch.fp8_mm.default


def _register_flop_formula() -> None:
    from torch.utils.flop_counter import flop_registry

    if torch.ops.accelerate_tpu_torch.fp8_mm in flop_registry:
        return

    @register_flop_formula(torch.ops.accelerate_tpu_torch.fp8_mm)
    def _mm_flops(a_shape, b_shape, *args, out_shape=None, **kwargs) -> int:
        return 2 * a_shape[0] * a_shape[1] * b_shape[1]


_register_flop_formula()


def _transposed(q: torch.Tensor) -> torch.Tensor:
    """A row-major copy of ``qᵀ`` (fp8 codes: 1 byte an element)."""
    return q.t().contiguous()


class _F8Linear(torch.autograd.Function):
    """``x @ wᵀ`` on fp8 codes (the JAX package's ``_f8_dot``). Operands of
    ``torch._scaled_mm`` on the card: the forward takes x's codes and
    ``wᵀ`` (a column-major view of the row-major (out, in) codes); the
    backward makes the transposed fp8 copies its two products need (W's,
    the cotangent's and x's; 1 byte an element)."""

    @staticmethod
    def forward(ctx, x, w, fwd_dtype, bwd_dtype, groups):
        x_groups, w_groups, g_groups = groups
        x2 = x.reshape(-1, x.shape[-1])
        xq, sx = _quant(x2, fwd_dtype, groups=x_groups)
        wq, sw = _quant(w, fwd_dtype, groups=w_groups)
        out = fp8_mm(xq, wq.t(), sx, sw, x.dtype)
        ctx.save_for_backward(xq, sx, wq, sw)
        ctx.bwd_dtype, ctx.x_shape, ctx.x_dtype, ctx.w_dtype = bwd_dtype, x.shape, x.dtype, w.dtype
        ctx.g_groups = g_groups
        return out.reshape(*x.shape[:-1], w.shape[0])

    @staticmethod
    def backward(ctx, g):
        xq, sx, wq, sw = ctx.saved_tensors
        gq, sg = _quant(g.reshape(-1, g.shape[-1]), ctx.bwd_dtype, groups=ctx.g_groups)
        dx = fp8_mm(gq, _transposed(wq).t(), sg, sw, ctx.x_dtype)
        dw = fp8_mm(_transposed(gq), _transposed(xq).t(), sg, sx, ctx.w_dtype)
        return dx.reshape(ctx.x_shape), dw, None, None, None


def amax_groups(tp_split=None) -> tuple:
    """The groups each operand's amax is taken over, ``(x, w, g)``: the
    running step's batch groups for x and g, and with ``tp_split`` (the
    split weight's dim and its ``tp`` group) that group for the weight and
    for the operand split with it: the cotangent of a column-parallel
    projection (dim 0), the input of a row-parallel one (dim 1)."""
    batch = batch_groups()
    if tp_split is None:
        return batch, (), batch
    dim, group = tp_split
    if dim == 0:
        return batch, (group,), batch + (group,)
    return batch + (group,), (group,), batch


def fp8_dot_general(fp8_format: str = "HYBRID", use_during_eval: bool = False,
                    native: Optional[bool] = None):
    """The fp8 linear ``linear(x, w) = x @ wᵀ`` (``w`` is ``(out, in)``).

    ``fp8_format``: ``HYBRID`` (e4m3 forward, e5m2 backward: the default
    recipe), ``E4M3`` or ``E5M2``. ``use_during_eval=False`` computes in
    full precision inside :func:`eval_mode`. ``native`` (default: the
    ``ACCELERATE_FP8_NATIVE`` environment variable, on unless ``"0"``)
    takes the fp8 product; ``native=False`` the QDQ formulation."""
    fmt = fp8_format.upper()
    fwd_dt, bwd_dt = _fmt_dtypes(fmt)
    q = {"HYBRID": qdq_hybrid, "E4M3": qdq_e4m3, "E5M2": qdq_e5m2}[fmt]
    if native is None:
        native = os.environ.get("ACCELERATE_FP8_NATIVE", "1") != "0"

    def linear(x: torch.Tensor, w: torch.Tensor, tp_split=None) -> torch.Tensor:
        """``x @ wᵀ``; ``tp_split``: ``(dim, group)`` of a weight split over
        ``tp`` on its output rows (0) or input columns (1)."""
        if not use_during_eval and in_eval_mode():
            return F.linear(x, w)
        groups = amax_groups(tp_split)
        if native:
            return _F8Linear.apply(x, w, fwd_dt, bwd_dt, groups)
        if fmt == "HYBRID":
            return F.linear(qdq_hybrid(x, groups[0], groups[2]),
                            qdq_hybrid(w, groups[1], groups[1]))
        return F.linear(q(x, groups[0]), q(w, groups[1]))

    linear.takes_tp_split = True
    return linear


def _parse_einsum(subscripts: str):
    lhs, out = subscripts.replace(" ", "").split("->")
    a, b = lhs.split(",")
    return a, b, out


def fp8_einsum(fp8_format: str = "HYBRID"):
    """``torch.einsum`` of two operands with fp8-quantized operands. A
    contraction without batch indices (none in both operands and the
    output) runs as :func:`fp8_dot_general`'s linear; one with batch
    indices quantize-dequantizes both operands around ``torch.einsum``, as
    the JAX package's einsum does for batch-dim dot_generals. Subscripts
    need an explicit ``->`` output."""
    linear = fp8_dot_general(fp8_format)
    q = {"HYBRID": qdq_hybrid, "E4M3": qdq_e4m3, "E5M2": qdq_e5m2}[fp8_format.upper()]

    def einsum(subscripts: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        sa, sb, so = _parse_einsum(subscripts)
        contracted = [c for c in sa if c in sb and c not in so]
        batch = [c for c in sa if c in sb and c in so]
        if batch or not contracted:
            return torch.einsum(subscripts, q(a), q(b))
        free_a = [c for c in sa if c not in contracted]
        free_b = [c for c in sb if c not in contracted]
        # a → (free_a, contracted) and b → (free_b, contracted): a linear.
        a2 = torch.einsum(f"{sa}->{''.join(free_a + contracted)}", a)
        b2 = torch.einsum(f"{sb}->{''.join(free_b + contracted)}", b)
        k = a2.shape[len(free_a):].numel()
        y = linear(a2.reshape(-1, k), b2.reshape(-1, k))
        y = y.reshape(*a2.shape[:len(free_a)], *b2.shape[:len(free_b)])
        return torch.einsum(f"{''.join(free_a + free_b)}->{so}", y)

    return einsum


def quantize_params_fp8(params, fp8_dtype=None):
    """Storage-side quantization: every floating tensor of a (nested) dict
    to fp8 with its per-tensor scale. Returns ``(codes, scales)`` of the
    same structure; other leaves pass through with a None scale."""
    fp8_dtype = fp8_dtype or torch.float8_e4m3fn
    if isinstance(params, dict):
        pairs = {k: quantize_params_fp8(v, fp8_dtype) for k, v in params.items()}
        return ({k: p[0] for k, p in pairs.items()}, {k: p[1] for k, p in pairs.items()})
    if torch.is_tensor(params) and params.is_floating_point():
        return _quant(params, fp8_dtype)
    return params, None


def dequantize_params_fp8(q_tree, s_tree, dtype=torch.bfloat16):
    if isinstance(q_tree, dict):
        return {k: dequantize_params_fp8(q_tree[k], s_tree[k], dtype) for k in q_tree}
    if s_tree is None:
        return q_tree
    return (q_tree.float() * s_tree).to(dtype)
