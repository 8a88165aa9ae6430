"""Building blocks shared by the GPT-2, OPT, GPT-NeoX, T5, Whisper, BERT,
ViT, CLIP and ResNet modules, with the numerics of the flax layers their
JAX counterparts use.

- ``FlaxLayerNorm``: flax's ``nn.LayerNorm``: mean and variance in fp32,
  the variance as E[x²] − E[x]² clipped at zero, ``(x − mean) ·
  (rsqrt(var + eps) · scale) + bias`` in fp32, and the result in the type
  that ``x``, the scale and the bias promote to. Outside a train step
  (fp32 masters) a bf16 input thus comes out fp32; inside one (every
  parameter cast to the compute dtype) it comes out bf16, as in the JAX
  package.
- ``module_attention``: the JAX modules' materialised attention: scores in
  the type of q and k, divided by sqrt(head_dim) rounded to the compute
  dtype, ``finfo(scores).min`` where the causal mask or a key mask (BERT's
  padding) hides a key, the softmax in fp32 and its probabilities back in
  the compute dtype. Over a ``cp`` or ``sp`` axis, where each process
  holds a slice of every sequence, causal attention without a key mask
  attends over the whole sequence through ``auto_flash_attention``'s ring
  (the JAX modules' attention over the global array); ``sequence_positions``
  gives such a slice its global positions.
- ``run_blocks``: the layer list, each block under
  ``torch.utils.checkpoint`` when ``remat`` is set and autograd records
  (flax's ``nn.remat`` without a policy: the whole block recomputes); a
  dropout generator is rewound for the recompute, so that it draws the
  forward's masks again.
- ``dropout``: flax's ``nn.Dropout`` (kept values divided by the keep
  probability in the input's type), its masks drawn from an explicit
  ``torch.Generator``; none without one.
- ``FlaxBatchNorm``: flax's ``nn.BatchNorm`` on NCHW tensors (the port's
  convolutions run NCHW in ``channels_last`` memory, which is NHWC in
  memory). The batch's mean and variance in fp32, the variance as E[x²] −
  E[x]² clipped at zero, the running statistics updated as flax updates
  them: ``ra = momentum · ra + (1 − momentum) · batch`` with the biased
  variance (``torch.nn.BatchNorm2d`` takes ``1 − momentum`` and the
  unbiased one). Under a train step over several processes the sums are
  all-reduced in the forward, with their gradient (``_AllReduceSum``): the
  global batch's statistics, which the JAX step gets from GSPMD (sync-BN).
  ``torch.nn.SyncBatchNorm`` is no option: it refuses CPU tensors.
- ``gather_rows``: every process's rows of a tensor with their gradient,
  for a loss that contrasts each row with the whole global batch (CLIP's).
- ``same_padding``: flax's ``padding="SAME"``, which splits an odd total
  as ``(total // 2, total − total // 2)``: a 7×7 stride-2 convolution on
  224 pixels pads (2, 3), where ``nn.Conv2d(padding=3)`` pads (3, 3) and
  shifts every window by one.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..utils import operations
from .llama import as_dtype


def flax_layer_norm(x, weight, bias, eps: float) -> torch.Tensor:
    """flax ``nn.LayerNorm`` (``use_fast_variance``) on the last axis."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = ((xf * xf).mean(-1, keepdim=True) - mean * mean).clamp_min(0.0)
    mul = torch.rsqrt(var + eps) * weight.float()
    y = (xf - mean) * mul + bias.float()
    return y.to(torch.promote_types(torch.promote_types(x.dtype, weight.dtype), bias.dtype))


class FlaxLayerNorm(nn.Module):
    """``weight`` (flax's ``scale``) and ``bias``; see ``flax_layer_norm``."""

    def __init__(self, size: int, eps: float, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(size, device=device))
        self.bias = nn.Parameter(torch.zeros(size, device=device))
        self.eps = eps

    def forward(self, x):
        return flax_layer_norm(x, self.weight, self.bias, self.eps)


def causal_mask(sq: int, sk: int, device) -> torch.Tensor:
    """(Sq, Sk) bool: query i sees key j when j <= i + Sk − Sq."""
    return torch.ones(sq, sk, dtype=torch.bool, device=device).tril(sk - sq)


def sequence_positions(ids: torch.Tensor) -> torch.Tensor:
    """The global positions of this process's slice of each sequence of
    ``ids`` (B, S): ``arange(S)`` but over a ``cp`` or ``sp`` axis, where
    process slice ``i`` starts at ``i · S``."""
    from ..state import current_sequence_shard

    _, i = current_sequence_shard()
    s = ids.shape[-1]
    return i * s + torch.arange(s, device=ids.device)


def module_attention(q, k, v, dtype, causal: bool,
                     key_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q (B, Sq, H, D) against k, v (B, Sk, H, D): see the module's
    docstring; ``key_mask`` (B, Sk), nonzero where a key is seen. Returns
    (B, Sq, H, D) in the type of the probabilities times v."""
    from ..state import current_sequence_shard

    if causal and key_mask is None and current_sequence_shard()[0] > 1:
        from ..ops.flash_attention import auto_flash_attention

        return auto_flash_attention(q.to(dtype), k.to(dtype), v.to(dtype), causal=True)
    d = q.shape[-1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k)
    scores = scores / torch.full((), as_dtype(math.sqrt(d), dtype), dtype=scores.dtype,
                                 device=scores.device)
    if causal:
        mask = causal_mask(q.shape[1], k.shape[1], q.device)
        scores = scores.masked_fill(~mask, torch.finfo(scores.dtype).min)
    if key_mask is not None:
        scores = scores.masked_fill(~key_mask.bool()[:, None, None, :],
                                    torch.finfo(scores.dtype).min)
    probs = torch.softmax(scores.float(), dim=-1).to(dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v.to(dtype) if v.dtype != dtype else v)


def _rewinding(layer, generator: torch.Generator):
    """``layer`` for ``checkpoint``: its first call draws from ``generator``
    as the forward goes; a later call (the recompute) draws again from the
    state the first one started at, and leaves the generator where it was."""
    start, called = generator.get_state(), []

    def run(*args):
        if not called:
            called.append(True)
            return layer(*args)
        now = generator.get_state()
        generator.set_state(start)
        try:
            return layer(*args)
        finally:
            generator.set_state(now)

    return run


def run_blocks(layers, x, remat: bool, *args, generator: Optional[torch.Generator] = None):
    """``x`` through every block of ``layers`` (each ``block(x, *args)``);
    ``generator``: the one the blocks' dropout draws from, if any. On a
    pipeline stage whose ``layers`` ``keep_stage`` cut, this stage's
    chunks of them, pipelined (``parallel/pp.run_stack``)."""
    if getattr(layers, "_pp_plan", None) is not None:
        from ..parallel.pp import run_stack

        return run_stack(layers, list(layers), functools.partial(
            _blocks, remat=remat, generator=generator), x, *args)
    return _blocks(layers, x, *args, remat=remat, generator=generator)


def _blocks(layers, x, *args, remat: bool, generator: Optional[torch.Generator] = None):
    for layer in layers:
        if remat and torch.is_grad_enabled():
            fn = layer if generator is None else _rewinding(layer, generator)
            x = checkpoint(fn, x, *args, use_reentrant=False)
        else:
            x = layer(x, *args)
    return x


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax's ``nn.Dropout(rate)``: each value kept with probability
    ``1 − rate`` (a mask drawn from ``generator``) and divided by it in the
    input's type, the others zero. The identity without a generator or at
    rate 0 (flax's ``deterministic=True``)."""
    if generator is None or rate == 0.0:
        return x
    keep = torch.rand(x.shape, device=x.device, generator=generator) >= rate
    kept = x / torch.full((), as_dtype(1.0 - rate, x.dtype), dtype=x.dtype, device=x.device)
    return torch.where(keep, kept, torch.zeros((), dtype=x.dtype, device=x.device))


def same_padding(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """flax's ``padding="SAME"`` on one axis: (before, after)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def pad_same(x: torch.Tensor, kernel: int, stride: int, value: float = 0.0) -> torch.Tensor:
    """NCHW ``x`` padded on H and W as flax's ``"SAME"`` pads it."""
    top, bottom = same_padding(x.shape[2], kernel, stride)
    left, right = same_padding(x.shape[3], kernel, stride)
    if top == bottom == left == right == 0:
        return x
    return F.pad(x, (left, right, top, bottom), value=value)


class _AllReduceSum(torch.autograd.Function):
    """A sum over the processes whose gradient is the sum of theirs: every
    process's loss depends on every process's batch statistics."""

    @staticmethod
    def forward(ctx, t):
        ctx.group = operations.loss_group()
        return operations.all_reduce(t.clone(), group=ctx.group)

    @staticmethod
    def backward(ctx, grad):
        return operations.all_reduce(grad.clone(), group=ctx.group)


class _AllGatherRows(torch.autograd.Function):
    """Every process's rows stacked in rank order; the gradient of this
    process's rows is the sum of every process's gradient of them."""

    @staticmethod
    def forward(ctx, t):
        ctx.group = operations.loss_group()  # the step's processes of distinct rows
        rank, world = dist.get_rank(ctx.group), dist.get_world_size(ctx.group)
        ctx.rows = slice(rank * t.shape[0], (rank + 1) * t.shape[0])
        full = t.new_zeros((world * t.shape[0],) + t.shape[1:])
        full[ctx.rows] = t
        return operations.all_reduce(full, group=ctx.group)

    @staticmethod
    def backward(ctx, grad):
        return operations.all_reduce(grad.clone(), group=ctx.group)[ctx.rows]


def gather_rows(t: torch.Tensor) -> torch.Tensor:
    """Every process's rows of ``t`` in rank order, with their gradient:
    in a train step over several processes, each holding its own rows of
    the global batch, the global batch's."""
    return _AllGatherRows.apply(t)


def batch_moments(x: torch.Tensor, dims: tuple) -> tuple[torch.Tensor, torch.Tensor]:
    """The fp32 mean and (biased, fast) variance of ``x`` over ``dims``; in
    a train step over several processes, over the global batch."""
    xf = x.float()
    n = math.prod(x.shape[d] for d in dims)
    sums = torch.stack([xf.sum(dims), (xf * xf).sum(dims)])
    if operations.loss_processes() > 1:
        count = torch.full((1, sums.shape[1]), float(n), device=x.device)
        reduced = _AllReduceSum.apply(torch.cat([sums, count]))
        sums, n = reduced[:2], reduced[2]
    mean, mean2 = sums[0] / n, sums[1] / n
    return mean, (mean2 - mean * mean).clamp_min(0.0)


class FlaxBatchNorm(nn.Module):
    """flax's ``nn.BatchNorm`` over the channels of an NCHW tensor:
    parameters ``scale`` and ``bias``, running statistics ``mean`` and
    ``var`` (buffers, flax's ``batch_stats`` collection). ``forward(x,
    train, stats)`` normalises with the batch's statistics (``train``) or
    the running ones and returns the output in ``dtype`` and the running
    statistics after the call (``{"mean", "var"}``, new tensors; the
    buffers are not written). ``stats`` replaces the buffers as the
    running statistics read."""

    flax_collection = "batch_stats"

    def __init__(self, channels: int, momentum: float, eps: float, dtype, device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(channels, device=device))
        self.bias = nn.Parameter(torch.zeros(channels, device=device))
        self.register_buffer("mean", torch.zeros(channels, device=device))
        self.register_buffer("var", torch.ones(channels, device=device))
        self.momentum, self.eps, self.dtype = momentum, eps, dtype

    def forward(self, x, train: bool = False, stats: Optional[dict] = None):
        ra_mean, ra_var = (self.mean, self.var) if stats is None else (stats["mean"],
                                                                        stats["var"])
        if train:
            mean, var = batch_moments(x, (0, 2, 3))
            with torch.no_grad():
                m = self.momentum
                new = {"mean": m * ra_mean + (1 - m) * mean.detach(),
                       "var": m * ra_var + (1 - m) * var.detach()}
        else:
            mean, var = ra_mean, ra_var
            new = {"mean": ra_mean, "var": ra_var}
        mul = torch.rsqrt(var + self.eps) * self.scale.float()
        shape = (1, -1, 1, 1)
        y = (x.float() - mean.view(shape)) * mul.view(shape) + self.bias.float().view(shape)
        return y.to(self.dtype), new


@torch.no_grad()
def init_weights(module: nn.Module, generator: torch.Generator, std: float = 0.02,
                 keep=()) -> None:
    """Seeded random weights as flax's initialisers give them: normal(0,
    std) matrices, embeddings and convolution kernels, zero biases, unit
    norm scales. Parameters named in ``keep`` (fixed tables) stay."""
    for name, p in module.named_parameters():
        if name in keep:
            continue
        if p.dim() >= 2:
            p.normal_(0.0, std, generator=generator)
        elif name.endswith("bias"):
            p.zero_()
        else:
            p.fill_(1.0)
