"""GPT-2-family decoder in PyTorch (counterpart of
``accelerate_tpu/models/gpt2.py``).

Learned absolute positions (``wpe``), pre-LN blocks with flax's LayerNorm
(``layers.FlaxLayerNorm``), a fused ``c_attn`` projection, a tanh-GELU MLP
and the head tied to ``wte``. Parameter names follow the flax tree
(``transformer.h.{i}.attn.c_attn.weight`` ↔
``transformer/h/block/attn/c_attn/kernel``); weights are ``(out, in)``
Linears, so ``c_attn`` is ``(3 · H, H)`` with its rows ordered as the flax
kernel's ``(3, heads, D)`` output axes, and ``models/convert.py`` reshapes
one into the other.

``fp8=True`` sends the four block projections through
``ops/fp8.fp8_dot_general``, as the JAX module's ``dot_general`` does; the
embeddings and the tied head stay in the compute dtype. The tied head
multiplies the final LayerNorm's output (fp32 outside a train step) by the
embedding rounded to the compute dtype, in the type the two promote to, as
the JAX module's ``x @ embedding.T.astype(dtype)`` does.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.fp8 import backend_to_native, fp8_dot_general
from ..parallel import tp
from ..parallel.pp import pipeline_forward
from .layers import (FlaxLayerNorm, init_weights, module_attention, run_blocks,
                     sequence_positions)
from .llama import _Linear

@dataclasses.dataclass
class GPT2Config:
    vocab_size: int = 50257
    n_positions: int = 1024
    n_embd: int = 768
    n_layer: int = 12
    n_head: int = 12
    layer_norm_epsilon: float = 1e-5
    dtype: Any = torch.bfloat16
    # Kept so a JAX config's fields carry over; convert.py reads both layouts.
    scan_layers: bool = True
    remat: bool = False
    fp8: bool = False
    fp8_format: str = "HYBRID"
    fp8_backend: str = "AUTO"      # AUTO | TE | AO | QDQ (ops/fp8.py backend_to_native)

    @property
    def head_dim(self) -> int:
        return self.n_embd // self.n_head

    @property
    def dot_general(self):
        if not self.fp8:
            return None
        return fp8_dot_general(self.fp8_format, native=backend_to_native(self.fp8_backend))

    @classmethod
    def tiny(cls, **kw):
        defaults = dict(vocab_size=256, n_positions=128, n_embd=128, n_layer=2, n_head=4)
        defaults.update(kw)
        return cls(**defaults)

    @classmethod
    def gpt2(cls, **kw):
        return cls(**kw)

    @classmethod
    def gpt2_xl(cls, **kw):
        return cls(n_embd=1600, n_layer=48, n_head=25, **kw)


class GPT2Attention(nn.Module):
    def __init__(self, cfg: GPT2Config, device=None):
        super().__init__()
        self.cfg = cfg
        linear = partial(_Linear, dtype=cfg.dtype, device=device, linear=cfg.dot_general,
                         bias=True)
        self.c_attn = linear(cfg.n_embd, 3 * cfg.n_embd)
        self.c_proj = linear(cfg.n_embd, cfg.n_embd)

    def forward(self, x):
        cfg = self.cfg
        b, s, _ = x.shape
        # Under tp c_attn holds this rank's heads of q, k and v (a strided split).
        q, k, v = self.c_attn(x).view(b, s, 3, -1, cfg.head_dim).unbind(2)
        out = module_attention(q, k, v, cfg.dtype, causal=True)
        return self.c_proj(out.reshape(b, s, -1))


class GPT2Block(nn.Module):
    def __init__(self, cfg: GPT2Config, device=None):
        super().__init__()
        h, eps = cfg.n_embd, cfg.layer_norm_epsilon
        linear = partial(_Linear, dtype=cfg.dtype, device=device, linear=cfg.dot_general,
                         bias=True)
        self.ln_1 = FlaxLayerNorm(h, eps, device)
        self.attn = GPT2Attention(cfg, device)
        self.ln_2 = FlaxLayerNorm(h, eps, device)
        self.c_fc = linear(h, 4 * h)
        self.c_proj = linear(4 * h, h)

    def forward(self, x):
        x = x + self.attn(self.ln_1(x))
        h = F.gelu(self.c_fc(self.ln_2(x)), approximate="tanh")
        return x + self.c_proj(h)


class GPT2Model(nn.Module):
    def __init__(self, cfg: GPT2Config, device=None):
        super().__init__()
        self.cfg = cfg
        self.wte = nn.Embedding(cfg.vocab_size, cfg.n_embd, device=device)
        self.wpe = nn.Embedding(cfg.n_positions, cfg.n_embd, device=device)
        self.h = nn.ModuleList(GPT2Block(cfg, device) for _ in range(cfg.n_layer))
        self.ln_f = FlaxLayerNorm(cfg.n_embd, cfg.layer_norm_epsilon, device)

    def forward(self, input_ids):
        cfg = self.cfg
        pos = sequence_positions(input_ids)
        x = (tp.embedding(input_ids, self.wte.weight).to(cfg.dtype)
             + F.embedding(pos, self.wpe.weight).to(cfg.dtype))
        return self.ln_f(run_blocks(self.h, x, cfg.remat))


class GPT2LMHeadModel(nn.Module):
    # FSDP2's per-block units (parallel/fsdp.decoder_blocks).
    _fsdp_blocks = (GPT2Block,)
    # Set when prepare cuts the module to a pipeline stage
    # (parallel/pp.keep_stage): its forward is then the pipelined one.
    pipeline_stage = None

    def __init__(self, cfg: GPT2Config, device=None):
        super().__init__()
        self.config = cfg
        self.transformer = GPT2Model(cfg, device)

    def forward(self, input_ids):
        """fp32 logits (B, S, V); on a pipeline stage those of
        ``parallel/pp.pipeline_forward`` (a stand-in but on the last)."""
        if self.pipeline_stage is not None:
            return pipeline_forward(self, input_ids)
        x = self.transformer(input_ids)
        head = self.transformer.wte.weight.to(self.config.dtype)
        dt = torch.promote_types(x.dtype, head.dtype)
        return tp.vocab_logits(x.to(dt), head.to(dt), post=lambda y: y.float())

    def init_weights(self, generator: torch.Generator, std: float = 0.02):
        """normal(0, std) matrices and embeddings, zero biases, unit norm
        scales; ``generator`` on the parameters' device."""
        init_weights(self, generator, std)


def gpt2_tp_rules(scan_layers: bool = True) -> list[tuple[str, tuple]]:
    """The JAX package's TP rule table for GPT-2 (``parallel/sharding.py``):
    the fused ``c_attn`` split on its heads, ``c_fc`` on its output, both
    ``c_proj`` on their input, ``wte`` (and the tied head) on the vocab."""
    lead = (None,) if scan_layers else ()
    return [
        (r"attn/c_attn/kernel", lead + (None, None, "tp", None)),
        (r"attn/c_proj/kernel", lead + ("tp", None, None)),
        (r"c_fc/kernel", lead + (None, "tp")),
        (r"(?<!attn/)c_proj/kernel", lead + ("tp", None)),
        (r"wte/embedding", ("tp", None)),
    ]
