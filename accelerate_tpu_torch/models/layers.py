"""Building blocks shared by the GPT-2, OPT, GPT-NeoX, T5 and Whisper
modules, with the numerics of the flax layers their JAX counterparts use.

- ``FlaxLayerNorm``: flax's ``nn.LayerNorm``: mean and variance in fp32,
  the variance as E[x²] − E[x]² clipped at zero, ``(x − mean) ·
  (rsqrt(var + eps) · scale) + bias`` in fp32, and the result in the type
  that ``x``, the scale and the bias promote to. Outside a train step
  (fp32 masters) a bf16 input thus comes out fp32; inside one (every
  parameter cast to the compute dtype) it comes out bf16, as in the JAX
  package.
- ``module_attention``: the JAX modules' materialised attention: scores in
  the type of q and k, divided by sqrt(head_dim) rounded to the compute
  dtype, ``finfo(scores).min`` where the causal mask hides a key, the
  softmax in fp32 and its probabilities back in the compute dtype.
- ``run_blocks``: the layer list, each block under
  ``torch.utils.checkpoint`` when ``remat`` is set and autograd records
  (flax's ``nn.remat`` without a policy: the whole block recomputes).
"""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

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


def module_attention(q, k, v, dtype, causal: bool) -> torch.Tensor:
    """q (B, Sq, H, D) against k, v (B, Sk, H, D): see the module's
    docstring. Returns (B, Sq, H, D) in the type of the probabilities
    times v."""
    d = q.shape[-1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k)
    scores = scores / torch.full((), as_dtype(math.sqrt(d), dtype), dtype=scores.dtype,
                                 device=scores.device)
    if causal:
        mask = causal_mask(q.shape[1], k.shape[1], q.device)
        scores = scores.masked_fill(~mask, torch.finfo(scores.dtype).min)
    probs = torch.softmax(scores.float(), dim=-1).to(dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v.to(dtype) if v.dtype != dtype else v)


def run_blocks(layers, x, remat: bool, *args):
    """``x`` through every block of ``layers`` (each ``block(x, *args)``)."""
    for layer in layers:
        if remat and torch.is_grad_enabled():
            x = checkpoint(layer, x, *args, use_reentrant=False)
        else:
            x = layer(x, *args)
    return x


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
