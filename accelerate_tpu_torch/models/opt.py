"""OPT-family decoder in PyTorch (counterpart of
``accelerate_tpu/models/opt.py``).

Separate biased q/k/v/out projections, learned positions with OPT's
offset of 2 (fairseq's pad reservation), pre-LN blocks with flax's
LayerNorm, a ReLU MLP, a final LayerNorm and the head tied to
``embed_tokens`` (``do_layer_norm_before=True`` models). Names follow the
flax tree (``model.layers.{i}.self_attn.q_proj.weight`` ↔
``model/layers/block/self_attn/q_proj/kernel``), weights are ``(out, in)``
Linears.
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
from .llama import _Linear

@dataclasses.dataclass
class OPTConfig:
    vocab_size: int = 50272
    hidden_size: int = 768
    ffn_dim: int = 3072
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    max_position_embeddings: int = 2048
    layer_norm_eps: float = 1e-5
    dtype: Any = torch.bfloat16
    scan_layers: bool = True
    remat: bool = False

    # OPT's learned position table is offset by 2 (fairseq legacy).
    POSITION_OFFSET = 2

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @classmethod
    def tiny(cls, **kw):
        defaults = dict(vocab_size=256, hidden_size=64, ffn_dim=128, num_hidden_layers=2,
                        num_attention_heads=4, max_position_embeddings=128)
        defaults.update(kw)
        return cls(**defaults)

    @classmethod
    def opt_125m(cls, **kw):
        return cls(**kw)

    @classmethod
    def opt_1b3(cls, **kw):
        return cls(hidden_size=2048, ffn_dim=8192, num_hidden_layers=24,
                   num_attention_heads=32, **kw)


class OPTAttention(nn.Module):
    def __init__(self, cfg: OPTConfig, device=None):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_size
        linear = partial(_Linear, h, h, cfg.dtype, device, bias=True)
        self.q_proj, self.k_proj, self.v_proj, self.out_proj = (linear() for _ in range(4))

    def forward(self, x):
        cfg = self.cfg
        b, s, _ = x.shape
        shape = (b, s, -1, cfg.head_dim)  # local heads under tp
        q, k, v = (p(x).view(shape) for p in (self.q_proj, self.k_proj, self.v_proj))
        out = module_attention(q, k, v, cfg.dtype, causal=True)
        return self.out_proj(out.reshape(b, s, -1))


class OPTBlock(nn.Module):
    def __init__(self, cfg: OPTConfig, device=None):
        super().__init__()
        h, eps = cfg.hidden_size, cfg.layer_norm_eps
        self.self_attn_layer_norm = FlaxLayerNorm(h, eps, device)
        self.self_attn = OPTAttention(cfg, device)
        self.final_layer_norm = FlaxLayerNorm(h, eps, device)
        self.fc1 = _Linear(h, cfg.ffn_dim, cfg.dtype, device, bias=True)
        self.fc2 = _Linear(cfg.ffn_dim, h, cfg.dtype, device, bias=True)

    def forward(self, x):
        x = x + self.self_attn(self.self_attn_layer_norm(x))
        return x + self.fc2(F.relu(self.fc1(self.final_layer_norm(x))))


class OPTModel(nn.Module):
    def __init__(self, cfg: OPTConfig, device=None):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_size
        self.embed_tokens = nn.Embedding(cfg.vocab_size, h, device=device)
        self.embed_positions = nn.Embedding(cfg.max_position_embeddings + cfg.POSITION_OFFSET,
                                            h, device=device)
        self.layers = nn.ModuleList(OPTBlock(cfg, device) for _ in range(cfg.num_hidden_layers))
        self.final_layer_norm = FlaxLayerNorm(h, cfg.layer_norm_eps, device)

    def forward(self, input_ids):
        cfg = self.cfg
        pos = sequence_positions(input_ids) + cfg.POSITION_OFFSET
        x = (tp.embedding(input_ids, self.embed_tokens.weight).to(cfg.dtype)
             + F.embedding(pos, self.embed_positions.weight).to(cfg.dtype))
        return self.final_layer_norm(run_blocks(self.layers, x, cfg.remat))


class OPTForCausalLM(nn.Module):
    # FSDP2's per-block units (parallel/fsdp.decoder_blocks).
    _fsdp_blocks = (OPTBlock,)
    # Set when prepare cuts the module to a pipeline stage
    # (parallel/pp.keep_stage): its forward is then the pipelined one.
    pipeline_stage = None

    def __init__(self, cfg: OPTConfig, device=None):
        super().__init__()
        self.config = cfg
        self.model = OPTModel(cfg, device)

    def forward(self, input_ids):
        """fp32 logits (B, S, V) of the head tied to ``embed_tokens``; on a
        pipeline stage those of ``parallel/pp.pipeline_forward``."""
        if self.pipeline_stage is not None:
            return pipeline_forward(self, input_ids)
        x = self.model(input_ids)
        head = self.model.embed_tokens.weight.to(self.config.dtype)
        dt = torch.promote_types(x.dtype, head.dtype)
        return tp.vocab_logits(x.to(dt), head.to(dt), post=lambda y: y.float())

    def init_weights(self, generator: torch.Generator, std: float = 0.02):
        init_weights(self, generator, std)


def opt_tp_rules(scan_layers: bool = True) -> list[tuple[str, tuple]]:
    """The JAX package's TP rule table for OPT (``parallel/sharding.py``):
    q/k/v on their heads, ``fc1`` on its output, ``out_proj`` and ``fc2``
    on their input, ``embed_tokens`` (and the tied head) on the vocab."""
    lead = (None,) if scan_layers else ()
    return [
        (r"self_attn/(q_proj|k_proj|v_proj)/kernel", lead + (None, "tp", None)),
        (r"self_attn/out_proj/kernel", lead + ("tp", None, None)),
        (r"fc1/kernel", lead + (None, "tp")),
        (r"fc2/kernel", lead + ("tp", None)),
        (r"embed_tokens/embedding", ("tp", None)),
    ]
