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

The decoder chassis: every knob of the JAX config (all off means plain
Llama). ``norm_type="layernorm"`` (mean-centred, with a bias),
``rms_norm_plus_one`` (Gemma: the stored weight w computes as w + 1),
biases on q/k/v (``attention_bias``), on ``o_proj``
(``attention_out_bias``) and on the MLP (``mlp_bias``), an ungated MLP
(``mlp_gated=False``), ``hidden_act``, ``partial_rotary_factor``,
Gemma's ``scale_embeddings`` and Granite's four constants
(``embedding_multiplier``, ``residual_multiplier``,
``attention_multiplier``, ``logits_scaling``). Each constant is rounded to
the compute dtype before it multiplies, as the JAX package's
``jnp.asarray(c, dtype)`` does; the attention multiplier is folded into q
as ``mult * sqrt(head_dim)``, so every attention impl runs unchanged. A
bias is added after the projection's product, in the compute dtype.

``fused_cross_entropy_loss`` takes the causal-LM loss without the
(B, S, V) logits: the sequence goes through the head in ``chunk_size``
slices whose logits are recomputed in the backward.

Tensor parallelism (``llama_tp_rules``; ``parallel/sharding.py``). Of the
two designs, a DTensor program whose kernels sit in ``local_map`` (the
JAX package's GSPMD program with a ``shard_map`` around the Pallas call)
and a program on local shards with local head counts, the port takes the
second: every rank runs this module on its own heads and ffn slice, the
projections put in the Megatron all-reduces (``parallel/tp.py``), and the
views take ``-1`` heads where the JAX module writes the global count. The
hot path stays plain tensors: the step is already host-bound in places
(``PERF.md``), and a DTensor program would dispatch every norm, RoPE and
residual op through DTensor's sharding propagation; the flash kernels,
bound through ``ctypes`` on local tensors, need no ``local_map``; and the
JAX plan's whole biases beside split weights, GQA kv heads kept whole
below ``tp`` and GPT-2's strided ``c_attn`` are each one explicit slice
here. The parameters stay DTensors, so that FSDP2, checkpoints and the
grad norm see their placements. The vocab-split head returns its logits
as a ``DTensor`` ``Shard(-1)``, which ``cross_entropy_loss`` reduces with
three all-reduces and no gather.
"""

from __future__ import annotations

import dataclasses
import math
from functools import lru_cache, partial
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from ..ops.flash_attention import auto_flash_attention
from ..ops.fp8 import FP8_MM_OP, backend_to_native, fp8_dot_general
from ..ops.hopper_flash import FLASH_FWD_OP
from ..parallel import tp
from ..parallel.cp import ring_attention
from ..parallel.pp import is_stand_in, llama_pipeline_forward, stand_in_loss
from ..parallel.sp import ulysses_attention
from ..state import current_sequence_shard
from ..utils.operations import global_token_count


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
    attention_bias: bool = False        # bias on q/k/v (Qwen2)
    norm_type: str = "rmsnorm"          # rmsnorm | layernorm (mean-centred, with bias)
    mlp_gated: bool = True              # False: up_proj -> act -> down_proj
    mlp_bias: bool = False              # biases on the MLP projections
    attention_out_bias: bool = False    # bias on o_proj
    partial_rotary_factor: float = 1.0  # RoPE on this fraction of head_dim
    # Granite's constants (1.0 / None: plain Llama); the attention
    # multiplier replaces the 1/sqrt(head_dim) score scale.
    embedding_multiplier: float = 1.0
    residual_multiplier: float = 1.0
    attention_multiplier: Optional[float] = None
    logits_scaling: float = 1.0
    # Gemma's: GeGLU, norm weights stored as w and computed as w + 1,
    # embeddings scaled by sqrt(hidden_size).
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
        if self.norm_type not in ("rmsnorm", "layernorm"):
            raise ValueError(f"norm_type must be rmsnorm|layernorm, got {self.norm_type}")
        if self.rotary_dim % 2:
            raise ValueError(
                f"partial_rotary_factor {self.partial_rotary_factor} of head_dim "
                f"{self.head_dim} gives odd rotary_dim {self.rotary_dim}")
        activation_fn(self.hidden_act)
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


def layer_norm(x, weight, bias, eps):
    """Mean-centred norm with a bias, in fp32 and returned in ``x``'s dtype;
    shared by ``LayerNorm`` and the cached forward of ``generation.py``."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * weight + bias).to(x.dtype)


@lru_cache(maxsize=None)
def as_dtype(c: float, dtype) -> float:
    """``c`` rounded to ``dtype``, as the JAX package's ``jnp.asarray(c,
    dtype)`` rounds a constant before it multiplies (sqrt(2048) is 45.25 in
    bf16). Multiplying by the rounded value gives the product of the two
    ``dtype`` numbers."""
    return float(torch.tensor(c, dtype=torch.float64).to(dtype))


def scale_residual(y, mult: float):
    """A branch's output times Granite's ``residual_multiplier``."""
    return y if mult == 1.0 else y * as_dtype(mult, y.dtype)


def scale_logits(logits, scaling: float):
    """Granite's logits divided by ``logits_scaling`` in their dtype; the
    divisor is a tensor, so that the card divides as the CPU does (it
    multiplies by the reciprocal of a Python number)."""
    if scaling == 1.0:
        return logits
    return logits / torch.full((), as_dtype(scaling, logits.dtype), dtype=logits.dtype,
                               device=logits.device)


def embed_tokens(cfg, weight, ids):
    """Embedding rows in the compute dtype, scaled as Gemma
    (``scale_embeddings``: sqrt(hidden_size)) and Granite
    (``embedding_multiplier``) scale them."""
    x = tp.embedding(ids, weight).to(cfg.dtype)
    if cfg.scale_embeddings:
        x = x * as_dtype(math.sqrt(cfg.hidden_size), cfg.dtype)
    if cfg.embedding_multiplier != 1.0:
        x = x * as_dtype(cfg.embedding_multiplier, cfg.dtype)
    return x


_ACTIVATIONS = {
    "silu": F.silu,
    "gelu": F.gelu,
    "gelu_tanh": partial(F.gelu, approximate="tanh"),
    "gelu_new": partial(F.gelu, approximate="tanh"),
    "gelu_pytorch_tanh": partial(F.gelu, approximate="tanh"),
    "relu": F.relu,
}


def activation_fn(name: str):
    if name not in _ACTIVATIONS:
        raise ValueError(f"Unknown hidden_act {name!r}; known: {sorted(_ACTIVATIONS)}")
    return _ACTIVATIONS[name]


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
    """Projection whose fp32 weight (and bias) is cast to the compute dtype
    at use; ``linear`` is ``F.linear`` or the fp8 one. The bias is added
    after the product, as flax's Dense adds it."""

    def __init__(self, in_features, out_features, dtype, device=None, linear=None,
                 bias=False):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features, device=device))
        self.bias = nn.Parameter(torch.empty(out_features, device=device)) if bias else None
        self.dtype = dtype
        self.linear = linear or F.linear

    def forward(self, x):
        if tp.is_split(self.weight):
            return tp.linear(x, self.weight, self.bias, self.dtype, self.linear)
        y = self.linear(x.to(self.dtype), self.weight.to(self.dtype))
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)
        return y


class RMSNorm(nn.Module):
    """RMSNorm; with ``plus_one`` (Gemma) the stored weight w computes as
    w + 1, added in the weight's dtype before the cast, as in flax."""

    def __init__(self, size, eps, device=None, plus_one=False):
        super().__init__()
        init = torch.zeros if plus_one else torch.ones
        self.weight = nn.Parameter(init(size, device=device))
        self.eps = eps
        self.plus_one = plus_one

    def forward(self, x):
        w = self.weight + 1.0 if self.plus_one else self.weight
        return rms_norm(x, w.to(x.dtype), self.eps)


class LayerNorm(nn.Module):
    """Mean-centred norm with a bias; params ``weight``/``bias`` (the JAX
    module's names)."""

    def __init__(self, size, eps, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(size, device=device))
        self.bias = nn.Parameter(torch.zeros(size, device=device))
        self.eps = eps

    def forward(self, x):
        return layer_norm(x, self.weight, self.bias, self.eps)


def make_norm(cfg: LlamaConfig, device=None) -> nn.Module:
    if cfg.norm_type == "layernorm":
        return LayerNorm(cfg.hidden_size, cfg.rms_norm_eps, device)
    return RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, device, cfg.rms_norm_plus_one)


class LlamaAttention(nn.Module):
    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        self.cfg = cfg
        h, d, dot = cfg.hidden_size, cfg.head_dim, cfg.dot_general
        qkv = partial(_Linear, dtype=cfg.dtype, device=device, linear=dot,
                      bias=cfg.attention_bias)
        self.q_proj = qkv(h, cfg.num_attention_heads * d)
        self.k_proj = qkv(h, cfg.num_key_value_heads * d)
        self.v_proj = qkv(h, cfg.num_key_value_heads * d)
        self.o_proj = _Linear(cfg.num_attention_heads * d, h, cfg.dtype, device, dot,
                              bias=cfg.attention_out_bias)
        self.attn_fn = _dispatch_attention(cfg.attention_impl)

    def forward(self, x, cos, sin):
        cfg = self.cfg
        b, s, _ = x.shape
        d = cfg.head_dim
        # Local head counts under tp (parallel/tp.py): this rank's heads.
        q = self.q_proj(x).view(b, s, -1, d)
        k = self.k_proj(x).view(b, s, -1, d)
        v = self.v_proj(x).view(b, s, -1, d)
        k, v = tp.heads_for_local_q(q, k, v, cfg.num_attention_heads, cfg.num_key_value_heads,
                                    self.q_proj.weight)
        if cfg.attention_multiplier is not None:
            # attention divides by sqrt(d): (q * c * sqrt(d)) . k / sqrt(d) = c * (q . k)
            q = q * as_dtype(cfg.attention_multiplier * math.sqrt(d), q.dtype)
        q = apply_partial_rope(q, cos, sin, cfg.rotary_dim)
        k = apply_partial_rope(k, cos, sin, cfg.rotary_dim)
        out = self.attn_fn(q, k, v, causal=True)
        return self.o_proj(out.reshape(b, s, -1))


class LlamaMLP(nn.Module):
    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        h, inter = cfg.hidden_size, cfg.intermediate_size
        dense = partial(_Linear, dtype=cfg.dtype, device=device, linear=cfg.dot_general,
                        bias=cfg.mlp_bias)
        self.gated = cfg.mlp_gated
        if cfg.mlp_gated:
            self.gate_proj = dense(h, inter)
        self.up_proj = dense(h, inter)
        self.down_proj = dense(inter, h)
        self.act = activation_fn(cfg.hidden_act)

    def forward(self, x):
        up = self.up_proj(x)
        hidden = self.act(self.gate_proj(x)) * up if self.gated else self.act(up)
        return self.down_proj(hidden)


class LlamaBlock(nn.Module):
    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        self.input_layernorm = make_norm(cfg, device)
        self.self_attn = LlamaAttention(cfg, device)
        self.post_attention_layernorm = make_norm(cfg, device)
        self.mlp = LlamaMLP(cfg, device)
        self.residual_multiplier = cfg.residual_multiplier

    def forward(self, x, cos, sin):
        rm = self.residual_multiplier
        h = x + scale_residual(self.self_attn(self.input_layernorm(x), cos, sin), rm)
        return h + scale_residual(self.mlp(self.post_attention_layernorm(h)), rm)


class LlamaModel(nn.Module):
    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size, device=device)
        self.layers = nn.ModuleList(LlamaBlock(cfg, device) for _ in range(cfg.num_hidden_layers))
        self.norm = make_norm(cfg, device)
        policy = _remat_policy(cfg)
        self._remat_kwargs = {"use_reentrant": False}
        if policy is not None:
            self._remat_kwargs["context_fn"] = partial(create_selective_checkpoint_contexts, policy)

    def forward(self, input_ids):
        cfg = self.cfg
        x = embed_tokens(cfg, self.embed_tokens.weight, input_ids)
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
    # FSDP2's per-block units (parallel/fsdp.decoder_blocks).
    _fsdp_blocks = (LlamaBlock,)
    # (stages, this stage, virtual stages) once prepare cut the module to a
    # pipeline stage (parallel/pp.keep_stage): its forward is then the
    # pipelined one.
    pipeline_stage = None

    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        self.config = cfg
        self.model = LlamaModel(cfg, device)
        if not cfg.tie_word_embeddings:
            self.lm_head = _Linear(cfg.hidden_size, cfg.vocab_size, cfg.dtype, device)

    def head_weight(self) -> torch.Tensor:
        """The LM head's ``(V, H)`` weight: the embedding when tied."""
        if self.config.tie_word_embeddings:
            return self.model.embed_tokens.weight
        return self.lm_head.weight

    def forward(self, input_ids, labels=None, *, ignore_index: int = -100,
                chunk_size: int = 256):
        """Logits (B, S, V) in the compute dtype; with ``labels``, the fp32
        sum of the token losses and the count of labels that are not
        ``ignore_index`` instead (``fused_cross_entropy_loss``), the logits
        built ``chunk_size`` positions at a time. On a pipeline stage the
        logits of ``llama_pipeline_forward`` (a stand-in but on the last
        stage), without ``labels``."""
        if self.pipeline_stage is not None:
            if labels is not None:
                raise ValueError("a pipeline stage takes fused_cross_entropy_loss(model, ids, "
                                 "labels), not the chunked loss of model(ids, labels)")
            return llama_pipeline_forward(self, input_ids)
        x = self.model(input_ids)
        if labels is not None:
            return _chunked_loss(x, self.head_weight().to(self.config.dtype), labels,
                                 self.config.logits_scaling, ignore_index, chunk_size)
        return tp.vocab_logits(x, self.head_weight().to(self.config.dtype),
                               post=partial(scale_logits, scaling=self.config.logits_scaling))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator, std: float = 0.02):
        """Seeded random weights as flax's initialisers give them:
        normal(0, std) matrices and embeddings, zero biases, unit norm
        weights (zero for Gemma's plus-one RMSNorm, whose w + 1 is one).
        ``generator`` must be on the parameters' device."""
        cfg = self.config
        plus_one = cfg.rms_norm_plus_one and cfg.norm_type == "rmsnorm"
        for name, p in self.named_parameters():
            if p.dim() >= 2:
                p.normal_(0.0, std, generator=generator)
            elif name.endswith("bias") or plus_one:
                p.zero_()
            else:
                p.fill_(1.0)


def _chunk_loss(hidden, head, labels, scaling: float, ignore_index: int):
    """fp32 sum of the token losses of one chunk: hidden (B, C, H) against
    head (V, H), both in the compute dtype."""
    valid = labels != ignore_index
    if tp.is_split(head):  # vocab-split head: this rank's logits
        logits = tp.vocab_logits(hidden, head, post=lambda y: scale_logits(y, scaling).float())
        return torch.where(valid, tp.vocab_parallel_nll(logits, labels), 0.0).sum()
    logits = scale_logits(F.linear(hidden, head), scaling).float()
    safe = torch.where(valid, labels, 0)
    lse = torch.logsumexp(logits, dim=-1)
    picked = logits.gather(-1, safe[..., None])[..., 0]
    return torch.where(valid, lse - picked, 0.0).sum()


def _chunked_loss(hidden, head, labels, scaling, ignore_index, chunk_size):
    """(fp32 token-loss sum, valid count) over ``chunk_size`` slices of the
    sequence; each slice's logits are recomputed in the backward
    (``torch.utils.checkpoint``), so the (B, S, V) logits never exist. An
    odd tail falls back to one chunk, as in the JAX package."""
    s = hidden.shape[1]
    if s % chunk_size:
        chunk_size = s
    total = hidden.new_zeros((), dtype=torch.float32)
    for start in range(0, s, chunk_size):
        sl = slice(start, start + chunk_size)
        total = total + checkpoint(_chunk_loss, hidden[:, sl], head, labels[:, sl], scaling,
                                   ignore_index, use_reentrant=False)
    return total, (labels != ignore_index).sum()


def fused_cross_entropy_loss(model, input_ids, labels, ignore_index: int = -100,
                             chunk_size: int = 256):
    """Causal-LM loss with the head's matmul folded into a chunked loss:
    equal to ``cross_entropy_loss(model(input_ids), labels)`` up to the
    order of fp32 sums, without the (B, S, V) logits. ``model`` is a
    ``LlamaForCausalLM`` or a ``Model`` of one (the call goes through it, so
    FSDP2's and DDP's hooks run). The mean is the global token mean, as
    ``cross_entropy_loss`` takes it. On a pipeline stage (``prepare`` under
    pp) the head lives on the last stage only: the loss is
    ``cross_entropy_loss`` of the pipelined logits."""
    if getattr(getattr(model, "module", model), "pipeline_stage", None) is not None:
        return cross_entropy_loss(model(input_ids), labels, ignore_index)
    total, valid = model(input_ids, labels, ignore_index=ignore_index, chunk_size=chunk_size)
    count, n = global_token_count(valid)
    return total * n / count.clamp_min(1)


def cross_entropy_loss(logits, labels, ignore_index: int = -100):
    """Token-level CE with masking, in fp32 whatever the compute dtype: the
    mean over the tokens whose label is not ``ignore_index``.

    Inside a train step over several processes the count is that of every
    process's tokens and the sum is scaled by their number, so that the
    step's mean over processes is the token mean of the global batch, as
    the JAX step takes it (``operations.global_token_count``).

    Logits split on the vocab over ``tp`` (a head under a TP plan gives a
    ``DTensor``) take the vocab-parallel loss (``parallel/tp.py``): three
    all-reduces, no gather.

    On a pipeline stage other than the last, whose ``logits`` are a
    stand-in (``parallel/pp.py``), the loss is a zero that runs the stage's
    part of the backward."""
    if is_stand_in(logits):
        return stand_in_loss(logits)
    logits = logits.float()
    valid = labels != ignore_index
    if isinstance(logits, DTensor):
        total = torch.where(valid, tp.vocab_parallel_nll(logits, labels), 0.0).sum()
    else:
        total = F.cross_entropy(logits.reshape(-1, logits.shape[-1]), labels.reshape(-1),
                                ignore_index=ignore_index, reduction="sum")
    count, n = global_token_count(valid.sum())
    return total * n / count.clamp_min(1)


def llama_tp_rules(scan_layers: bool = True) -> list[tuple[str, tuple]]:
    """The JAX package's tensor-parallel rule table for the Llama chassis:
    regular expressions on the flax tree's ``/``-joined names, each with a
    spec of its flax leaf's dims (a scanned stack's leading layer dim
    first). q/k/v split their heads and gate/up their ffn dim
    (column-parallel), o_proj and down_proj their input (row-parallel),
    the embedding and the head their vocab (``parallel/sharding.py``)."""
    lead = (None,) if scan_layers else ()
    return [
        (r"self_attn/(q_proj|k_proj|v_proj)/kernel", lead + (None, "tp", None)),
        (r"mlp/(gate_proj|up_proj)/kernel", lead + (None, "tp")),
        (r"self_attn/o_proj/kernel", lead + ("tp", None, None)),
        (r"mlp/down_proj/kernel", lead + ("tp", None)),
        (r"embed_tokens/embedding", ("tp", None)),
        (r"lm_head/kernel", (None, "tp")),
    ]
