"""Llama decoder in PyTorch.

Counterpart of ``accelerate_tpu/models/llama.py`` with the same numerics:
weights are fp32 masters cast to ``config.dtype`` at use (flax's
``dtype``/``param_dtype``), ``rms_norm`` takes its variance in fp32, RoPE
tables are computed in the activation dtype, and the loss is taken in
fp32. Module and parameter names follow the flax tree
(``model.layers.{i}.self_attn.q_proj.weight`` ↔
``model/layers/block/self_attn/q_proj/kernel``), so ``models/convert.py``
maps one onto the other.

Attention (``attention_impl``): ``flash`` (the Hopper kernels,
``ops/flash_attention.auto_flash_attention``), ``native`` (materialised
scores), ``ring`` (``parallel/cp.py``) and ``ulysses`` (``parallel/sp.py``).
Over a ``cp`` or ``sp`` axis each process holds a slice of every sequence
and RoPE takes the slice's global positions; ``flash`` then attends over
the whole sequence through the allgather ring, as the JAX package does.

Remat: with ``remat=True`` each block runs under ``torch.utils.checkpoint``.
The policies match the JAX ones: ``minimal`` recomputes everything, the
flash kernel included; ``flash`` keeps the flash forward's outputs
(``hopper_flash.FLASH_FWD_OP``, the ``flash_out``/``flash_lse`` names of the
JAX package; each ring chunk's too); ``dots`` also keeps every projection's
matmul output, the fp8 products included (``ops/fp8.FP8_MM_OP``), so that
the recompute quantizes again but does not redo a product.

fp8 (``fp8=True``): the seven block projections (q, k, v, o, gate, up,
down) go through ``ops/fp8.fp8_dot_general(fp8_format, native=
backend_to_native(fp8_backend))``; the embedding and ``lm_head`` stay in
the compute dtype, as in the JAX package. The weights are the same, so
``models/convert.py`` carries them over either way.

The other decoder-chassis knobs of the JAX config (layernorm, biases,
partial rotary, Granite and Gemma constants) are not ported yet: a config
that sets one raises ``NotImplementedError`` (ROADMAP.md Queue A item 10).
"""

from __future__ import annotations

import dataclasses
import math
from functools import partial
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from ..ops.flash_attention import auto_flash_attention
from ..ops.fp8 import FP8_MM_OP, backend_to_native, fp8_dot_general
from ..ops.hopper_flash import FLASH_FWD_OP
from ..parallel.cp import ring_attention
from ..parallel.sp import ulysses_attention
from ..state import current_sequence_shard
from ..utils.operations import global_token_count

# Chassis knobs of the JAX LlamaConfig with the value that means plain Llama.
_UNPORTED_KNOBS = {
    "attention_bias": False, "norm_type": "rmsnorm", "mlp_gated": True, "mlp_bias": False,
    "attention_out_bias": False, "partial_rotary_factor": 1.0, "embedding_multiplier": 1.0,
    "residual_multiplier": 1.0, "attention_multiplier": None, "logits_scaling": 1.0,
    "hidden_act": "silu", "rms_norm_plus_one": False, "scale_embeddings": False,
}


@dataclasses.dataclass
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32
    head_dim: Optional[int] = None
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    tie_word_embeddings: bool = False
    attention_bias: bool = False
    norm_type: str = "rmsnorm"
    mlp_gated: bool = True
    mlp_bias: bool = False
    attention_out_bias: bool = False
    partial_rotary_factor: float = 1.0
    embedding_multiplier: float = 1.0
    residual_multiplier: float = 1.0
    attention_multiplier: Optional[float] = None
    logits_scaling: float = 1.0
    hidden_act: str = "silu"
    rms_norm_plus_one: bool = False
    scale_embeddings: bool = False
    dtype: Any = torch.bfloat16         # compute dtype (params stay fp32 masters)
    # Kept so a JAX config's fields carry over; torch holds the layers in a
    # ModuleList either way, and convert.py reads both flax layouts.
    scan_layers: bool = True
    remat: bool = False
    remat_policy: str = "flash"         # flash | dots | minimal
    attention_impl: str = "flash"       # flash | native | ring | ulysses
    fp8: bool = False                   # fp8 matmuls in the block projections
    fp8_format: str = "HYBRID"          # E4M3 | E5M2 | HYBRID (e4m3 fwd / e5m2 bwd)
    fp8_backend: str = "AUTO"           # AUTO | TE | AO | QDQ (ops/fp8.py backend_to_native)

    def __post_init__(self):
        if self.head_dim is None:
            self.head_dim = self.hidden_size // self.num_attention_heads
        changed = [k for k, plain in _UNPORTED_KNOBS.items() if getattr(self, k) != plain]
        if changed:
            raise NotImplementedError(
                f"LlamaConfig knobs {changed} are not ported yet (ROADMAP.md Queue A item 10)")
        if self.remat_policy not in ("flash", "dots", "minimal"):
            raise ValueError(f"remat_policy must be flash|dots|minimal, got {self.remat_policy}")

    @property
    def rotary_dim(self) -> int:
        return int(self.head_dim * self.partial_rotary_factor)

    @property
    def dot_general(self):
        """The block projections' linear: fp8 when ``fp8`` is set, else None
        (``F.linear``)."""
        if not self.fp8:
            return None
        return fp8_dot_general(self.fp8_format, native=backend_to_native(self.fp8_backend))

    @classmethod
    def tiny(cls, **kw):
        defaults = dict(
            vocab_size=256, hidden_size=128, intermediate_size=384,
            num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
            max_position_embeddings=512,
        )
        defaults.update(kw)
        return cls(**defaults)


def rms_norm(x, weight, eps):
    var = x.float().square().mean(-1, keepdim=True)
    return (x * torch.rsqrt(var + eps)).to(x.dtype) * weight


def rotary_embedding(positions, head_dim: int, theta: float, dtype):
    """cos/sin tables for RoPE: (..., S, head_dim) in ``dtype``."""
    inv_freq = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                             device=positions.device) / head_dim))
    freqs = positions[..., None].float() * inv_freq
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.cos().to(dtype), emb.sin().to(dtype)


def apply_rope(x, cos, sin):
    """x: (B, S, H, D); cos/sin: (B, S, D) or (S, D)."""
    if cos.dim() == 2:
        cos, sin = cos[None], sin[None]
    cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    half = x.shape[-1] // 2
    rotated = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return x * cos + rotated * sin


def apply_partial_rope(x, cos, sin, rotary_dim):
    """RoPE on the leading ``rotary_dim`` dims, pass-through on the rest."""
    if rotary_dim == x.shape[-1]:
        return apply_rope(x, cos, sin)
    return torch.cat([apply_rope(x[..., :rotary_dim], cos, sin), x[..., rotary_dim:]], -1)


def naive_attention(q, k, v, *, causal: bool = True):
    """Reference attention: materialized scores, fp32 softmax.
    q: (B, S, Hq, D); k/v: (B, S, Hkv, D)."""
    sq, hq, d = q.shape[1], q.shape[2], q.shape[3]
    rep = hq // k.shape[2]
    if rep != 1:
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * (1.0 / math.sqrt(d))
    if causal:
        sk = k.shape[1]
        mask = torch.ones(sq, sk, dtype=torch.bool, device=q.device).tril(sk - sq)
        logits = logits.masked_fill(~mask, torch.finfo(logits.dtype).min)
    probs = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _dispatch_attention(impl: str):
    if impl == "native":
        return naive_attention
    if impl == "flash":
        return auto_flash_attention
    if impl == "ring":
        return ring_attention
    if impl == "ulysses":
        return ulysses_attention
    raise ValueError(f"Unknown attention_impl {impl}")


def _remat_policy(cfg: LlamaConfig):
    """Selective-checkpoint policy for one block, or None for full remat."""
    if cfg.remat_policy == "minimal":
        return None
    if cfg.remat_policy == "flash" and cfg.attention_impl == "native":
        return None  # nothing cheap to keep: plain full-block remat, as in JAX
    save = {FLASH_FWD_OP}
    if cfg.remat_policy == "dots":
        # JAX's dots_with_no_batch_dims_saveable: the projections (2-D
        # matmuls, fp8 ones included), not the batched attention einsums.
        save |= {torch.ops.aten.mm.default, torch.ops.aten.addmm.default, FP8_MM_OP,
                 torch.ops.aten._scaled_mm.default}

    def policy(ctx, op, *args, **kwargs):
        return CheckpointPolicy.MUST_SAVE if op in save else CheckpointPolicy.PREFER_RECOMPUTE

    return policy


class _Linear(nn.Module):
    """Bias-free projection whose fp32 weight is cast to the compute dtype
    at use; ``linear`` is ``F.linear`` or the fp8 one."""

    def __init__(self, in_features, out_features, dtype, device=None, linear=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features, device=device))
        self.dtype = dtype
        self.linear = linear or F.linear

    def forward(self, x):
        return self.linear(x.to(self.dtype), self.weight.to(self.dtype))


class RMSNorm(nn.Module):
    def __init__(self, size, eps, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(size, device=device))
        self.eps = eps

    def forward(self, x):
        return rms_norm(x, self.weight.to(x.dtype), self.eps)


class LlamaAttention(nn.Module):
    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        self.cfg = cfg
        h, d, dot = cfg.hidden_size, cfg.head_dim, cfg.dot_general
        self.q_proj = _Linear(h, cfg.num_attention_heads * d, cfg.dtype, device, dot)
        self.k_proj = _Linear(h, cfg.num_key_value_heads * d, cfg.dtype, device, dot)
        self.v_proj = _Linear(h, cfg.num_key_value_heads * d, cfg.dtype, device, dot)
        self.o_proj = _Linear(cfg.num_attention_heads * d, h, cfg.dtype, device, dot)
        self.attn_fn = _dispatch_attention(cfg.attention_impl)

    def forward(self, x, cos, sin):
        cfg = self.cfg
        b, s, _ = x.shape
        d = cfg.head_dim
        q = self.q_proj(x).view(b, s, cfg.num_attention_heads, d)
        k = self.k_proj(x).view(b, s, cfg.num_key_value_heads, d)
        v = self.v_proj(x).view(b, s, cfg.num_key_value_heads, d)
        q = apply_partial_rope(q, cos, sin, cfg.rotary_dim)
        k = apply_partial_rope(k, cos, sin, cfg.rotary_dim)
        out = self.attn_fn(q, k, v, causal=True)
        return self.o_proj(out.reshape(b, s, -1))


class LlamaMLP(nn.Module):
    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        h, inter, dot = cfg.hidden_size, cfg.intermediate_size, cfg.dot_general
        self.gate_proj = _Linear(h, inter, cfg.dtype, device, dot)
        self.up_proj = _Linear(h, inter, cfg.dtype, device, dot)
        self.down_proj = _Linear(inter, h, cfg.dtype, device, dot)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class LlamaBlock(nn.Module):
    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, device)
        self.self_attn = LlamaAttention(cfg, device)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, device)
        self.mlp = LlamaMLP(cfg, device)

    def forward(self, x, cos, sin):
        h = x + self.self_attn(self.input_layernorm(x), cos, sin)
        return h + self.mlp(self.post_attention_layernorm(h))


class LlamaModel(nn.Module):
    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size, device=device)
        self.layers = nn.ModuleList(LlamaBlock(cfg, device) for _ in range(cfg.num_hidden_layers))
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, device)
        policy = _remat_policy(cfg)
        self._remat_kwargs = {"use_reentrant": False}
        if policy is not None:
            self._remat_kwargs["context_fn"] = partial(create_selective_checkpoint_contexts, policy)

    def forward(self, input_ids):
        cfg = self.cfg
        x = F.embedding(input_ids, self.embed_tokens.weight).to(cfg.dtype)
        # Over a cp or sp axis this process holds slice i of n of each
        # sequence: its global positions, as the JAX package's arange over
        # the whole sequence gives them.
        n, i = current_sequence_shard()
        if n > 1 and cfg.attention_impl == "native":
            raise NotImplementedError(
                "attention_impl='native' attends within this process's slice of the sequence; "
                "over a cp or sp axis use flash, ring or ulysses")
        s = input_ids.shape[-1]
        positions = i * s + torch.arange(s, device=input_ids.device)
        cos, sin = rotary_embedding(positions, cfg.rotary_dim, cfg.rope_theta, x.dtype)
        for layer in self.layers:
            if cfg.remat and torch.is_grad_enabled():
                x = checkpoint(layer, x, cos, sin, **self._remat_kwargs)
            else:
                x = layer(x, cos, sin)
        return self.norm(x)


class LlamaForCausalLM(nn.Module):
    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        self.config = cfg
        self.model = LlamaModel(cfg, device)
        if not cfg.tie_word_embeddings:
            self.lm_head = _Linear(cfg.hidden_size, cfg.vocab_size, cfg.dtype, device)

    def forward(self, input_ids):
        x = self.model(input_ids)
        if self.config.tie_word_embeddings:
            return F.linear(x, self.model.embed_tokens.weight.to(self.config.dtype))
        return self.lm_head(x)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator, std: float = 0.02):
        """Seeded random weights: normal(0, std) matrices and embeddings,
        unit norm scales. ``generator`` must be on the parameters' device."""
        for name, p in self.named_parameters():
            if name.endswith("layernorm.weight") or name == "model.norm.weight":
                p.fill_(1.0)
            else:
                p.normal_(0.0, std, generator=generator)


def cross_entropy_loss(logits, labels, ignore_index: int = -100):
    """Token-level CE with masking, in fp32 whatever the compute dtype: the
    mean over the tokens whose label is not ``ignore_index``.

    Inside a train step over several processes the count is that of every
    process's tokens and the sum is scaled by their number, so that the
    step's mean over processes is the token mean of the global batch, as
    the JAX step takes it (``operations.global_token_count``)."""
    logits = logits.float()
    valid = labels != ignore_index
    total = F.cross_entropy(logits.reshape(-1, logits.shape[-1]), labels.reshape(-1),
                            ignore_index=ignore_index, reduction="sum")
    count, n = global_token_count(valid.sum())
    return total * n / count.clamp_min(1)
