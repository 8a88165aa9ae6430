"""Flash attention on Hopper: hand-written forward, dQ and dK/dV kernels.

Counterpart of ``accelerate_tpu/ops/pallas_flash.py``. The CUDA kernels
under ``csrc/`` replace the three Pallas kernels there:

- ``flash_fwd.cu``  ← ``_fwd_kernel``: online-softmax forward, returns
  ``out`` and the fp32 row log-sum-exp ``lse``;
- ``flash_dq.cu``   ← ``_dq_kernel``: dQ from recomputed P;
- ``flash_dkv.cu``  ← ``_dkv_kernel``: dK/dV summed over the GQA group;
- ``flash_f32.cu``  ← all three for float32 inputs (CUDA-core FMA, since
  ``wgmma`` has no fp32 operands).

The first three take bf16 and fp16 (``wgmma``, fp32 accumulation, P cast
to v's dtype before P·V as the TPU kernel casts it). Every kernel is built
for head dims 64, 128 and 256 (``BUILT_HEAD_DIMS``); any other D up to 256
is zero-padded to the next of them and the results sliced back, with the
scale ``1/sqrt(d)`` of the unpadded d, as the Pallas kernel pads D to 128
lanes: zero columns add nothing to q·k and give zero output columns, so
the result is exact (``pad_head_dim``). D above 256 raises
``NotImplementedError``.

Layout is the model's ``(B, S, H, D)``, read through strides (by TMA tensor
maps in all three kernels); ``lse`` is ``(B, Hq, Sq)``. Offsets are the
global positions of element 0 of q and k, so ring attention can call the
same kernels on rotated chunks.

Each kernel has a wrapper (``flash_fwd_cuda``, ``flash_dq_cuda``,
``flash_dkv_cuda``) that checks its inputs, launches the kernel or raises,
and counts the launch in ``LAUNCHES`` (by kernel) and ``VARIANT_LAUNCHES``
(by kernel, dtype and built head dim: ``variant``); beside them are the
plain PyTorch versions (``flash_fwd_plain``, ``flash_dq_plain``, ``flash_dkv_plain``).
``flash_fwd`` and ``flash_bwd`` take the plain version only for tensors on
the CPU. The gradient is the custom op ``accelerate_tpu_torch::flash_fwd``
with a registered backward, so that a selective-checkpoint policy can name
the forward's outputs (``FLASH_FWD_OP``), as ``checkpoint_name("flash_out")``
does in the JAX package; the backward runs the custom op
``accelerate_tpu_torch::flash_bwd``. Both ops have FLOP formulas
(``torch.utils.flop_counter``), so that ``FlopCounterMode`` counts the
attention of a step (``profiler.DeviceTimeProfiler.capture_cost``): the
forward's two products over the (query, key) pairs the causal mask keeps,
``4·B·Hq·D·pairs``, and the backward's five, ``10·B·Hq·D·pairs`` (the
split into a dQ and a dK/dV kernel computes QKᵀ and dO·Vᵀ once more each;
the count leaves that out).
"""

from __future__ import annotations

import ctypes
import math

import torch

import torch.nn.functional as F
from torch.utils.flop_counter import register_flop_formula

NEG_INF = -1e30
# Head dims the kernels are built for; any D up to the last is padded to the
# next of them.
BUILT_HEAD_DIMS = (64, 128, 256)
HEAD_DIM_ITEM = "ROADMAP.md Queue B.1 item 1 (flash attention at head dims above 256)"
# The element types of the kernels, by the code their C entry points take.
DTYPES = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2}
_DTYPE_NAMES = {torch.bfloat16: "bf16", torch.float16: "f16", torch.float32: "f32"}

# Launches of each kernel since the last reset_launch_counts(), and of each
# variant (``variant(name, dtype, width)``).
LAUNCHES = {"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0}
VARIANT_LAUNCHES: dict[str, int] = {}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    VARIANT_LAUNCHES.clear()


def variant(name: str, dtype: torch.dtype, width: int) -> str:
    """The name of one built kernel: ``flash_fwd.bf16.d128``."""
    return f"{name}.{_DTYPE_NAMES[dtype]}.d{width}"


def source(name: str, dtype: torch.dtype) -> str:
    """The ``csrc`` source (without ``.cu``) that holds a kernel for ``dtype``."""
    return "flash_f32" if dtype == torch.float32 else name


def built_head_dim(d: int) -> int:
    """The width the kernels run a head dim ``d`` at: the smallest built
    width at or above it."""
    if d > BUILT_HEAD_DIMS[-1]:
        raise NotImplementedError(
            f"flash attention at head dim {d} > {BUILT_HEAD_DIMS[-1]} is not ported yet "
            f"({HEAD_DIM_ITEM})")
    return next(w for w in BUILT_HEAD_DIMS if w >= d)


def pad_head_dim(fn, width: int, *args, **kw):
    """``fn(*args)`` with every (B, S, H, D) argument zero-padded along D to
    ``width`` and every (B, S, H, width) result sliced back to D, at the
    scale ``1/sqrt(D)`` of the unpadded D. Row statistics pass as they are.
    Exact: zero columns add nothing to q·kᵀ, dO·vᵀ or the row sums, and the
    padded columns of out, dq, dk and dv come out zero."""
    d = args[0].shape[-1]
    if width == d:
        return fn(*args, **kw)
    kw.setdefault("scale", 1.0 / math.sqrt(d))
    out = fn(*(F.pad(x, (0, width - d)) if x.dim() == 4 else x for x in args), **kw)
    cut = lambda t: t[..., :d].contiguous() if t.dim() == 4 else t  # noqa: E731
    return tuple(map(cut, out)) if isinstance(out, tuple) else cut(out)


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the CPU path, and the reference on the card)
# ---------------------------------------------------------------------------


def _mask(sq, sk, causal, q_offset, k_offset, device):
    """(Sq, Sk) visibility: key inside Sk and, if causal, not after the query."""
    if not causal:
        return torch.ones(sq, sk, dtype=torch.bool, device=device)
    q_pos = q_offset + torch.arange(sq, device=device)
    k_pos = k_offset + torch.arange(sk, device=device)
    return q_pos[:, None] >= k_pos[None, :]


def _scale(q, scale):
    return 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale


def _scores(q, k, causal, q_offset, k_offset, scale=None):
    """Masked fp32 scores (B, Hq, Sq, Sk), KV heads repeated over the group."""
    hq, hkv = q.shape[2], k.shape[2]
    k = k.float().repeat_interleave(hq // hkv, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k) * _scale(q, scale)
    mask = _mask(q.shape[1], k.shape[1], causal, q_offset, k_offset, q.device)
    return s, mask


def flash_fwd_plain(q, k, v, *, causal=True, q_offset=0, k_offset=0, scale=None):
    """What the forward kernel computes, in fp32: (out in q's dtype, lse).
    ``scale`` defaults to ``1/sqrt(D)``."""
    hq, hkv = q.shape[2], k.shape[2]
    s, mask = _scores(q, k, causal, q_offset, k_offset, scale)
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m) * mask
    l_safe = p.sum(-1, keepdim=True).clamp_min(1e-30)
    v = v.float().repeat_interleave(hq // hkv, dim=2)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v) / l_safe.transpose(1, 2)
    lse = (m + torch.log(l_safe))[..., 0]
    return out.to(q.dtype), lse


def _bwd_terms(q, k, v, dout, lse, delta, causal, q_offset, k_offset, scale):
    """Recomputed P and dS = P∘(dP − δ), fp32 (B, Hq, Sq, Sk)."""
    rep = q.shape[2] // k.shape[2]
    s, mask = _scores(q, k, causal, q_offset, k_offset, scale)
    p = torch.where(mask, torch.exp(s - lse[..., None]), 0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", dout.float(), v.float().repeat_interleave(rep, dim=2))
    return p, p * (dp - delta[..., None])


def flash_dq_plain(q, k, v, dout, lse, delta, *, causal=True, q_offset=0, k_offset=0,
                   scale=None):
    """What the dQ kernel computes, in fp32: dq in q's dtype."""
    _, ds = _bwd_terms(q, k, v, dout, lse, delta, causal, q_offset, k_offset, scale)
    kf = k.float().repeat_interleave(q.shape[2] // k.shape[2], dim=2)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * _scale(q, scale)
    return dq.to(q.dtype)


def flash_dkv_plain(q, k, v, dout, lse, delta, *, causal=True, q_offset=0, k_offset=0,
                    scale=None):
    """What the dK/dV kernel computes, in fp32: (dk, dv) summed over the
    GQA group, in k's and v's dtype."""
    b, sk, hkv, d = k.shape
    rep = q.shape[2] // hkv
    p, ds = _bwd_terms(q, k, v, dout, lse, delta, causal, q_offset, k_offset, scale)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()) * _scale(q, scale)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dout.float())
    dk = dk.reshape(b, sk, hkv, rep, d).sum(3)
    dv = dv.reshape(b, sk, hkv, rep, d).sum(3)
    return dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

_PTR = ctypes.c_void_p
_STRIDES = ctypes.POINTER(ctypes.c_longlong)
_INT = ctypes.c_int
# (tensor pointers, strides, B, Sq, Sk, Hq, Hkv, D, dtype, causal, q_off, k_off, scale,
# stream)
_N_PTR = {"flash_fwd": 5, "flash_dq": 7, "flash_dkv": 8}
_kernels: dict = {}


def _kernel(name, dtype):
    """The C entry point of kernel ``name`` for ``dtype``, its library built
    first if needed."""
    key = (name, dtype == torch.float32)
    fn = _kernels.get(key)
    if fn is None:
        from ._build import load

        fn = getattr(load(source(name, dtype)), name + ("_f32" if key[1] else ""))
        fn.argtypes = [_PTR] * _N_PTR[name] + [_STRIDES] + [_INT] * 10 + [ctypes.c_float, _PTR]
        fn.restype = _INT
        _kernels[key] = fn
    return fn


def _check(name, q, k, v, dout=None, lse=None, delta=None):
    """Raise on anything the kernels do not take, and return the width the
    call runs at (``built_head_dim``). They take (B, S, H, D) q, k, v (and
    dout shaped as q) of one dtype among bf16, fp16 and fp32, with D up to
    256, contiguous fp32 (B, Hq, Sq) row statistics, all on one CUDA device.
    Tensors read in place (D at a built width) need a unit last stride;
    bf16 and fp16 ones, read by TMA tensor maps, also other strides that
    are positive multiples of 8 elements (16 bytes) and 16-byte aligned
    storage. Shapes and layouts are checked first, so a CPU caller sees
    them too."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"{name}: expected q (B, Sq, Hq, D) and k, v (B, Sk, Hkv, D)")
    b, sq, hq, d = q.shape
    if k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"{name}: q {tuple(q.shape)} and k {tuple(k.shape)} do not match")
    if hq % k.shape[2]:
        raise ValueError(f"{name}: GQA needs Hq % Hkv == 0, got {hq} % {k.shape[2]}")
    width = built_head_dim(d)
    if dout is not None and dout.shape != q.shape:
        raise ValueError(f"{name}: dout {tuple(dout.shape)} must have q's shape {tuple(q.shape)}")
    stats = [x for x in (lse, delta) if x is not None]
    for x in stats:
        if x.dtype != torch.float32 or x.shape != (b, hq, sq) or not x.is_contiguous():
            raise ValueError(f"{name}: row statistics must be contiguous float32 {(b, hq, sq)}")
    tensors = [t for t in (q, k, v, dout) if t is not None]
    dtypes = {t.dtype for t in tensors}
    if len(dtypes) != 1 or q.dtype not in DTYPES:
        raise TypeError(f"{name}: q, k, v (and dout) must share one dtype among "
                        f"{sorted(map(str, DTYPES))}, got {sorted(map(str, dtypes))}")
    if width == d:
        tma = q.dtype != torch.float32
        for t in tensors:
            if t.stride(-1) != 1 or tma and (any(s <= 0 or s % 8 for s in t.stride()[:-1])
                                             or t.data_ptr() % 16):
                raise ValueError(f"{name}: tensors need unit last stride, and for bf16 and "
                                 "fp16 other strides positive multiples of 8 elements and "
                                 "16-byte aligned storage")
    if not all(t.is_cuda for t in tensors + stats):
        raise ValueError(f"{name}: the Hopper kernel takes CUDA tensors only")
    if len({t.device for t in tensors + stats}) != 1:
        raise ValueError(f"{name}: all tensors must be on one device")
    return width


def _strides(*tensors):
    vals = [s for t in tensors for s in t.stride()[:3]]
    return (ctypes.c_longlong * len(vals))(*vals)


def _launch(name, dtype, width, *args):
    err = _kernel(name, dtype)(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{variant(name, dtype, width)}: CUDA error {err} at launch")
    LAUNCHES[name] += 1
    key = variant(name, dtype, width)
    VARIANT_LAUNCHES[key] = VARIANT_LAUNCHES.get(key, 0) + 1


def _fwd_launch(q, k, v, *, causal, q_offset, k_offset, scale=None):
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = torch.empty(b, hq, sq, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        _launch("flash_fwd", q.dtype, d, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                out.data_ptr(), lse.data_ptr(), _strides(q, k, v, out), b, sq, sk, hq, hkv, d,
                DTYPES[q.dtype], int(causal), int(q_offset), int(k_offset), _scale(q, scale))
    return out, lse


def _dq_launch(q, k, v, dout, lse, delta, *, causal, q_offset, k_offset, scale=None):
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    with torch.cuda.device(q.device):
        _launch("flash_dq", q.dtype, d, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                _strides(q, k, v, dout, dq), b, sq, sk, hq, hkv, d, DTYPES[q.dtype],
                int(causal), int(q_offset), int(k_offset), _scale(q, scale))
    return dq


def _dkv_launch(q, k, v, dout, lse, delta, *, causal, q_offset, k_offset, scale=None):
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    dk = torch.empty_like(k, memory_format=torch.contiguous_format)
    dv = torch.empty_like(v, memory_format=torch.contiguous_format)
    with torch.cuda.device(q.device):
        _launch("flash_dkv", q.dtype, d, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
                dv.data_ptr(), _strides(q, k, v, dout, dk, dv), b, sq, sk, hq, hkv, d,
                DTYPES[q.dtype], int(causal), int(q_offset), int(k_offset), _scale(q, scale))
    return dk, dv


def flash_fwd_cuda(q, k, v, *, causal=True, q_offset=0, k_offset=0):
    """Launch the forward kernel: (out (B, Sq, Hq, D) in q's dtype, lse fp32
    (B, Hq, Sq))."""
    width = _check("flash_fwd", q, k, v)
    return pad_head_dim(_fwd_launch, width, q, k, v, causal=causal, q_offset=q_offset,
                        k_offset=k_offset)


def flash_dq_cuda(q, k, v, dout, lse, delta, *, causal=True, q_offset=0, k_offset=0):
    """Launch the dQ kernel: dq (B, Sq, Hq, D) in q's dtype."""
    width = _check("flash_dq", q, k, v, dout, lse, delta)
    return pad_head_dim(_dq_launch, width, q, k, v, dout, lse, delta, causal=causal,
                        q_offset=q_offset, k_offset=k_offset)


def flash_dkv_cuda(q, k, v, dout, lse, delta, *, causal=True, q_offset=0, k_offset=0):
    """Launch the dK/dV kernel: (dk, dv) (B, Sk, Hkv, D) in k's dtype,
    group-summed."""
    width = _check("flash_dkv", q, k, v, dout, lse, delta)
    return pad_head_dim(_dkv_launch, width, q, k, v, dout, lse, delta, causal=causal,
                        q_offset=q_offset, k_offset=k_offset)


def flash_fwd(q, k, v, *, causal=True, q_offset=0, k_offset=0):
    """Forward: the kernel for CUDA tensors, the plain version on the CPU."""
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, causal=causal, q_offset=q_offset, k_offset=k_offset)
    return flash_fwd_cuda(q, k, v, causal=causal, q_offset=q_offset, k_offset=k_offset)


def flash_bwd(q, k, v, dout, lse, delta, *, causal=True, q_offset=0, k_offset=0):
    """Backward (dq, dk, dv): the dQ and dK/dV kernels for CUDA tensors, the
    plain version on the CPU."""
    kw = dict(causal=causal, q_offset=q_offset, k_offset=k_offset)
    if q.device.type == "cpu":
        dq = flash_dq_plain(q, k, v, dout, lse, delta, **kw)
        dk, dv = flash_dkv_plain(q, k, v, dout, lse, delta, **kw)
    else:
        dq = flash_dq_cuda(q, k, v, dout, lse, delta, **kw)
        dk, dv = flash_dkv_cuda(q, k, v, dout, lse, delta, **kw)
    return dq, dk, dv


# ---------------------------------------------------------------------------
# Autograd: a custom op, so remat policies can name its outputs
# ---------------------------------------------------------------------------


@torch.library.custom_op("accelerate_tpu_torch::flash_fwd", mutates_args=())
def _flash_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
              q_offset: int, k_offset: int) -> tuple[torch.Tensor, torch.Tensor]:
    return flash_fwd(q, k, v, causal=causal, q_offset=q_offset, k_offset=k_offset)


@_flash_op.register_fake
def _(q, k, v, causal, q_offset, k_offset):
    b, sq, hq, _ = q.shape
    return torch.empty_like(q), q.new_empty((b, hq, sq), dtype=torch.float32)


def _setup_context(ctx, inputs, output):
    q, k, v, causal, q_offset, k_offset = inputs
    out, lse = output
    # Residuals as in the TPU custom_vjp: (q, k, v, out, lse).
    ctx.save_for_backward(q, k, v, out, lse)
    ctx.kw = dict(causal=causal, q_offset=q_offset, k_offset=k_offset)


def output_delta(out, dout):
    """δ = rowsum(dO∘O): fp32 (B, H, S), as the backward kernels take it."""
    return (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


@torch.library.custom_op("accelerate_tpu_torch::flash_bwd", mutates_args=())
def _flash_bwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, dout: torch.Tensor,
                  lse: torch.Tensor, delta: torch.Tensor, causal: bool, q_offset: int,
                  k_offset: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return flash_bwd(q, k, v, dout, lse, delta, causal=causal, q_offset=q_offset,
                     k_offset=k_offset)


@_flash_bwd_op.register_fake
def _(q, k, v, dout, lse, delta, causal, q_offset, k_offset):
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


def _backward(ctx, g_out, g_lse):
    q, k, v, out, lse = ctx.saved_tensors
    g_out = torch.zeros_like(out) if g_out is None else g_out.to(q.dtype).contiguous()
    # δ folds the lse cotangent: dS = P∘(dP − δ), δ = rowsum(dO∘O) − g_lse.
    delta = output_delta(out, g_out)
    if g_lse is not None:
        delta = delta - g_lse.float()
    kw = ctx.kw
    dq, dk, dv = _flash_bwd_op(q, k, v, g_out, lse, delta, kw["causal"], kw["q_offset"],
                               kw["k_offset"])
    return dq, dk, dv, None, None, None


_flash_op.register_autograd(_backward, setup_context=_setup_context)

# The op whose outputs the "flash" and "dots" remat policies keep.
FLASH_FWD_OP = torch.ops.accelerate_tpu_torch.flash_fwd.default


def attention_pairs(sq: int, sk: int, causal: bool, q_offset: int = 0,
                    k_offset: int = 0) -> int:
    """(query, key) pairs attention computes: all ``sq·sk``, or with the
    causal mask those where the key's global position is at most the
    query's."""
    if not causal:
        return sq * sk
    first = q_offset - k_offset + 1  # keys the first query sees
    return sum(min(max(first + i, 0), sk) for i in range(sq))


def _attention_flops(per_pair: int, q_shape, k_shape, causal, q_offset, k_offset) -> int:
    b, sq, hq, d = q_shape
    return per_pair * b * hq * d * attention_pairs(sq, k_shape[1], causal, q_offset, k_offset)


def _register_flop_formulas() -> None:
    """FLOP formulas of the two custom ops, for FlopCounterMode (once per
    process: the registry refuses a second registration)."""
    from torch.utils.flop_counter import flop_registry

    if torch.ops.accelerate_tpu_torch.flash_fwd in flop_registry:
        return

    @register_flop_formula(torch.ops.accelerate_tpu_torch.flash_fwd)
    def _fwd_flops(q_shape, k_shape, v_shape, causal, q_offset, k_offset, *args,
                   out_shape=None, **kwargs) -> int:
        return _attention_flops(4, q_shape, k_shape, causal, q_offset, k_offset)

    @register_flop_formula(torch.ops.accelerate_tpu_torch.flash_bwd)
    def _bwd_flops(q_shape, k_shape, v_shape, dout_shape, lse_shape, delta_shape, causal,
                   q_offset, k_offset, *args, out_shape=None, **kwargs) -> int:
        return _attention_flops(10, q_shape, k_shape, causal, q_offset, k_offset)


_register_flop_formulas()


# ---------------------------------------------------------------------------
# Public entry points
# ---------------------------------------------------------------------------


def flash_attention_with_lse(q, k, v, *, causal: bool = True, q_offset: int = 0,
                             k_offset: int = 0):
    """Fused attention returning ``(out, lse)``.

    q: (B, Sq, Hq, D); k/v: (B, Sk, Hkv, D) with Hq a multiple of Hkv.
    Returns out (B, Sq, Hq, D) in q's dtype and lse (B, Hq, Sq) float32.
    Differentiable in q, k, v, with cotangents for both outputs."""
    if q.shape[2] % k.shape[2]:
        raise ValueError(f"GQA needs Hq % Hkv == 0, got {q.shape[2]} % {k.shape[2]}")
    return _flash_op(q, k, v, bool(causal), int(q_offset), int(k_offset))


def flash_attention(q, k, v, *, causal: bool = True, q_offset: int = 0, k_offset: int = 0):
    """Fused attention: (B, Sq, Hq, D) → (B, Sq, Hq, D)."""
    out, _ = flash_attention_with_lse(q, k, v, causal=causal, q_offset=q_offset,
                                      k_offset=k_offset)
    return out


def merge_flash_chunks(out_a, lse_a, out_b, lse_b):
    """Merge two flash outputs over disjoint key sets.

    out: (B, S, H, D); lse: (B, H, S). The exact merged output is
    Σ_i out_i · exp(lse_i − lse) with lse = logaddexp(lse_a, lse_b)."""
    lse = torch.logaddexp(lse_a, lse_b)
    wa = torch.exp(lse_a - lse).transpose(1, 2)[..., None]
    wb = torch.exp(lse_b - lse).transpose(1, 2)[..., None]
    out = out_a.float() * wa + out_b.float() * wb
    return out.to(out_a.dtype), lse
