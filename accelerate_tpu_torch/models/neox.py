"""GPT-NeoX-family decoder in PyTorch (counterpart of
``accelerate_tpu/models/neox.py``).

A fused per-head ``[q|k|v]`` projection (``query_key_value``: rows
ordered ``(heads, 3, D)``, the layout of the flax kernel's output axes and
of NeoX checkpoints), partial rotary embeddings on the leading
``rotary_pct`` of each head's dims (``llama.apply_partial_rope``), flax's
LayerNorm, an exact-erf GELU MLP, the parallel residual
``x + attn(ln1 x) + mlp(ln2 x)`` (or the sequential one with
``use_parallel_residual=False``) and an untied ``embed_out`` head.

As in the JAX module, the rotary tables take the type of the attention
LayerNorm's output (fp32 outside a train step), so q and k are rotated,
and the scores taken, in the type the two promote to.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel import tp
from ..parallel.pp import pipeline_forward
from .layers import (FlaxLayerNorm, init_weights, module_attention, run_blocks,
                     sequence_positions)
from .llama import _Linear, apply_partial_rope, rotary_embedding

@dataclasses.dataclass
class GPTNeoXConfig:
    vocab_size: int = 50432
    hidden_size: int = 6144
    num_hidden_layers: int = 44
    num_attention_heads: int = 64
    intermediate_size: int = 24576
    rotary_pct: float = 0.25
    rotary_emb_base: float = 10000.0
    layer_norm_eps: float = 1e-5
    use_parallel_residual: bool = True
    max_position_embeddings: int = 2048
    dtype: Any = torch.bfloat16
    scan_layers: bool = True
    remat: bool = False

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def rotary_ndims(self) -> int:
        return int(self.head_dim * self.rotary_pct)

    @classmethod
    def tiny(cls, **kw):
        defaults = dict(vocab_size=256, hidden_size=64, num_hidden_layers=2,
                        num_attention_heads=4, intermediate_size=128,
                        max_position_embeddings=128)
        defaults.update(kw)
        return cls(**defaults)

    @classmethod
    def neox_20b(cls, **kw):
        return cls(**kw)

    @classmethod
    def pythia_1b(cls, **kw):
        return cls(vocab_size=50304, hidden_size=2048, num_hidden_layers=16,
                   num_attention_heads=8, intermediate_size=8192, **kw)


class GPTNeoXAttention(nn.Module):
    def __init__(self, cfg: GPTNeoXConfig, device=None):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_size
        self.query_key_value = _Linear(h, 3 * h, cfg.dtype, device, bias=True)
        self.dense = _Linear(h, h, cfg.dtype, device, bias=True)

    def forward(self, x, positions):
        cfg = self.cfg
        b, s, _ = x.shape
        qkv = self.query_key_value(x).view(b, s, -1, 3, cfg.head_dim)  # local heads under tp
        q, k, v = qkv.unbind(3)
        rnd = cfg.rotary_ndims
        cos, sin = rotary_embedding(positions, rnd, cfg.rotary_emb_base, x.dtype)
        dt = torch.promote_types(q.dtype, cos.dtype)
        q = apply_partial_rope(q.to(dt), cos.to(dt), sin.to(dt), rnd)
        k = apply_partial_rope(k.to(dt), cos.to(dt), sin.to(dt), rnd)
        out = module_attention(q, k, v, cfg.dtype, causal=True)
        return self.dense(out.reshape(b, s, -1))


class GPTNeoXBlock(nn.Module):
    def __init__(self, cfg: GPTNeoXConfig, device=None):
        super().__init__()
        h, eps = cfg.hidden_size, cfg.layer_norm_eps
        self.parallel = cfg.use_parallel_residual
        self.input_layernorm = FlaxLayerNorm(h, eps, device)
        self.attention = GPTNeoXAttention(cfg, device)
        self.post_attention_layernorm = FlaxLayerNorm(h, eps, device)
        linear = partial(_Linear, dtype=cfg.dtype, device=device, bias=True)
        self.dense_h_to_4h = linear(h, cfg.intermediate_size)
        self.dense_4h_to_h = linear(cfg.intermediate_size, h)

    def mlp(self, x):
        return self.dense_4h_to_h(F.gelu(self.dense_h_to_4h(self.post_attention_layernorm(x))))

    def forward(self, x, positions):
        attn = self.attention(self.input_layernorm(x), positions)
        if self.parallel:  # one residual for both sublayers
            return x + attn + self.mlp(x)
        x = x + attn
        return x + self.mlp(x)


class GPTNeoXModel(nn.Module):
    def __init__(self, cfg: GPTNeoXConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.embed_in = nn.Embedding(cfg.vocab_size, cfg.hidden_size, device=device)
        self.layers = nn.ModuleList(GPTNeoXBlock(cfg, device)
                                    for _ in range(cfg.num_hidden_layers))
        self.final_layer_norm = FlaxLayerNorm(cfg.hidden_size, cfg.layer_norm_eps, device)

    def forward(self, input_ids):
        cfg = self.cfg
        x = tp.embedding(input_ids, self.embed_in.weight).to(cfg.dtype)
        positions = sequence_positions(input_ids)
        positions = positions.expand(input_ids.shape)
        return self.final_layer_norm(run_blocks(self.layers, x, cfg.remat, positions))


class GPTNeoXForCausalLM(nn.Module):
    # FSDP2's per-block units (parallel/fsdp.decoder_blocks).
    _fsdp_blocks = (GPTNeoXBlock,)
    # Set when prepare cuts the module to a pipeline stage
    # (parallel/pp.keep_stage): its forward is then the pipelined one.
    pipeline_stage = None

    def __init__(self, cfg: GPTNeoXConfig, device=None):
        super().__init__()
        self.config = cfg
        self.gpt_neox = GPTNeoXModel(cfg, device)
        self.embed_out = _Linear(cfg.hidden_size, cfg.vocab_size, cfg.dtype, device)

    def forward(self, input_ids):
        """fp32 logits (B, S, V); the untied head computes in the compute
        dtype. On a pipeline stage those of ``parallel/pp.pipeline_forward``."""
        if self.pipeline_stage is not None:
            return pipeline_forward(self, input_ids)
        dt = self.config.dtype
        return tp.vocab_logits(self.gpt_neox(input_ids).to(dt), self.embed_out.weight.to(dt),
                               post=lambda y: y.float())

    def init_weights(self, generator: torch.Generator, std: float = 0.02):
        init_weights(self, generator, std)


def neox_tp_rules(scan_layers: bool = True) -> list[tuple[str, tuple]]:
    """The JAX package's TP rule table for GPT-NeoX (``parallel/sharding.py``):
    the fused ``query_key_value`` on its heads, ``dense_h_to_4h`` on its
    output, ``dense`` and ``dense_4h_to_h`` on their input, ``embed_in`` and
    ``embed_out`` on the vocab."""
    lead = (None,) if scan_layers else ()
    return [
        (r"attention/query_key_value/kernel", lead + (None, "tp", None, None)),
        (r"attention/dense/kernel", lead + ("tp", None, None)),
        (r"dense_h_to_4h/kernel", lead + (None, "tp")),
        (r"dense_4h_to_h/kernel", lead + ("tp", None)),
        (r"embed_in/embedding", ("tp", None)),
        (r"embed_out/kernel", (None, "tp")),
    ]
