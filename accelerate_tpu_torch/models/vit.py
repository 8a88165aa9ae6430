"""ViT image classifier in PyTorch (counterpart of
``accelerate_tpu/models/vit.py``).

Pixels come in NHWC ``(B, H, W, C)`` as the JAX module takes them. A patch
convolution with ``VALID`` padding (kernel = stride = ``patch_size``), a
CLS token and learned positions, pre-LN blocks (``ln_before``, attention,
``ln_after``, an exact-erf GELU MLP) with flax's LayerNorm, ``ln_final``,
and a classifier on the CLS token with fp32 logits. The attention is the
JAX module's, materialised (``layers.module_attention``, no mask).

Parameter names follow the flax tree (``vit.layers.{i}.attention.query.
weight`` ↔ ``vit/layers/block/attention/query/kernel``); the patch
convolution's weight is ``(hidden, C, P, P)`` where flax's kernel is
``(P, P, C, hidden)`` (``models/convert.py``).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from .layers import FlaxLayerNorm, init_weights, module_attention, run_blocks
from .llama import _Linear

@dataclasses.dataclass
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    num_channels: int = 3
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    layer_norm_eps: float = 1e-12
    num_labels: int = 1000
    dtype: Any = torch.bfloat16
    # Kept so a JAX config's fields carry over; convert.py reads both layouts.
    scan_layers: bool = True
    remat: bool = False

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @classmethod
    def tiny(cls, **kw):
        defaults = dict(image_size=32, patch_size=8, hidden_size=64, num_hidden_layers=2,
                        num_attention_heads=4, intermediate_size=128, num_labels=4)
        defaults.update(kw)
        return cls(**defaults)

    @classmethod
    def vit_base(cls, **kw):
        return cls(**kw)

    @classmethod
    def vit_large(cls, **kw):
        return cls(hidden_size=1024, num_hidden_layers=24, num_attention_heads=16,
                   intermediate_size=4096, **kw)


def patch_embed(pixel_values, weight, bias, patch: int, dtype):
    """flax's ``nn.Conv`` with kernel = stride = ``patch`` and ``VALID``
    padding on NHWC pixels, in ``dtype``: (B, N, hidden) patches in
    row-major order (flax's reshape of the NHWC output). Each patch is one
    row of a product with the ``(hidden, C·P·P)`` weight, the bias added
    after it, as flax adds it."""
    b, h, w, c = pixel_values.shape
    x = pixel_values.to(dtype).reshape(b, h // patch, patch, w // patch, patch, c)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, (h // patch) * (w // patch), -1)
    y = F.linear(x, weight.to(dtype).permute(0, 2, 3, 1).reshape(weight.shape[0], -1))
    return y if bias is None else y + bias.to(dtype)


class ViTSelfAttention(nn.Module):
    def __init__(self, cfg: ViTConfig, device=None):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_size
        linear = partial(_Linear, dtype=cfg.dtype, device=device, bias=True)
        self.query, self.key, self.value = linear(h, h), linear(h, h), linear(h, h)
        self.output = linear(h, h)

    def forward(self, x):
        cfg = self.cfg
        b, s, _ = x.shape
        q, k, v = (p(x).view(b, s, -1, cfg.head_dim)  # local heads under tp
                   for p in (self.query, self.key, self.value))
        out = module_attention(q, k, v, cfg.dtype, causal=False)
        return self.output(out.reshape(b, s, -1))


class ViTBlock(nn.Module):
    """Pre-LN encoder block."""

    def __init__(self, cfg: ViTConfig, device=None):
        super().__init__()
        h, eps = cfg.hidden_size, cfg.layer_norm_eps
        linear = partial(_Linear, dtype=cfg.dtype, device=device, bias=True)
        self.ln_before = FlaxLayerNorm(h, eps, device)
        self.attention = ViTSelfAttention(cfg, device)
        self.ln_after = FlaxLayerNorm(h, eps, device)
        self.intermediate = linear(h, cfg.intermediate_size)
        self.output = linear(cfg.intermediate_size, h)

    def forward(self, x):
        x = x + self.attention(self.ln_before(x))
        return x + self.output(F.gelu(self.intermediate(self.ln_after(x))))  # exact erf GELU


class ViTModel(nn.Module):
    def __init__(self, cfg: ViTConfig, device=None):
        super().__init__()
        self.cfg = cfg
        h, p = cfg.hidden_size, cfg.patch_size
        self.patch_embed = nn.Conv2d(cfg.num_channels, h, p, stride=p, device=device)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, h, device=device))
        self.position_embeddings = nn.Parameter(
            torch.zeros(1, cfg.num_patches + 1, h, device=device))
        self.layers = nn.ModuleList(ViTBlock(cfg, device) for _ in range(cfg.num_hidden_layers))
        self.ln_final = FlaxLayerNorm(h, cfg.layer_norm_eps, device)

    def forward(self, pixel_values):
        """(B, H, W, C) NHWC → (B, N + 1, hidden)."""
        cfg = self.cfg
        x = patch_embed(pixel_values, self.patch_embed.weight, self.patch_embed.bias,
                        cfg.patch_size, cfg.dtype)
        cls = self.cls_token.to(x.dtype).expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x], 1) + self.position_embeddings.to(x.dtype)
        return self.ln_final(run_blocks(self.layers, x, cfg.remat))


class ViTForImageClassification(nn.Module):
    # FSDP2's per-block units (parallel/fsdp.decoder_blocks).
    _fsdp_blocks = (ViTBlock,)

    def __init__(self, cfg: ViTConfig, device=None):
        super().__init__()
        self.config = cfg
        self.vit = ViTModel(cfg, device)
        self.classifier = nn.Linear(cfg.hidden_size, cfg.num_labels, device=device)

    def forward(self, pixel_values):
        """fp32 logits (B, num_labels) of the CLS token."""
        x = self.vit(pixel_values)[:, 0]
        return F.linear(x.float(), self.classifier.weight.float(), self.classifier.bias.float())

    def init_weights(self, generator: torch.Generator, std: float = 0.02):
        """normal(0, std) matrices, kernels and the CLS token and positions,
        zero biases, unit norm scales; ``generator`` on the parameters'
        device."""
        init_weights(self, generator, std)


def vit_tp_rules(scan_layers: bool = True) -> list[tuple[str, tuple]]:
    """The JAX package's TP rule table for ViT (BERT's shape;
    ``parallel/sharding.py``)."""
    lead = (None,) if scan_layers else ()
    return [
        (r"attention/(query|key|value)/kernel", lead + (None, "tp", None)),
        (r"attention/output/kernel", lead + ("tp", None, None)),
        (r"intermediate/kernel", lead + (None, "tp")),
        (r"(?<!attention/)output/kernel", lead + ("tp", None)),
    ]
