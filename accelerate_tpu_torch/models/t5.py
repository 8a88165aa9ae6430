"""T5-family encoder-decoder in PyTorch (counterpart of
``accelerate_tpu/models/t5.py``, T5 v1.0).

- ``T5LayerNorm``: RMS without a mean or a bias, the variance in fp32,
  ``(x · rsqrt(var + eps))`` back in ``x``'s type and times the weight in
  the type the two promote to;
- relative-position-bias attention: log-spaced buckets
  (``relative_position_bucket``), one table owned by the first block of
  each stack (``block_0``) and reused by the rest, no 1/sqrt(d) scale,
  scores and softmax in fp32, ``-1e9`` where the causal mask or the
  encoder's padding mask hides a key;
- pre-norm blocks with a ReLU feed-forward; the head tied to ``shared``
  with the ``d_model ** -0.5`` scale.

Names follow the flax tree: ``encoder.block_0.self_attn.q.weight`` ↔
``encoder/block_0/self_attn/q/kernel``; the flax tree scans blocks
1..L-1 (``encoder/layers/block/...``) when ``scan_layers``, which
``models/convert.py`` maps onto ``block_1``..``block_{L-1}`` here.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..parallel import tp
from ..parallel.pp import every_stage, run_stack
from .layers import causal_mask, init_weights
from .llama import _Linear, as_dtype

MASKED = -1e9


@dataclasses.dataclass
class T5Config:
    vocab_size: int = 32128
    d_model: int = 512
    d_kv: int = 64
    d_ff: int = 2048
    num_layers: int = 6
    num_decoder_layers: Optional[int] = None
    num_heads: int = 8
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_epsilon: float = 1e-6
    dtype: Any = torch.bfloat16
    scan_layers: bool = True
    remat: bool = False
    decoder_start_token_id: int = 0
    pad_token_id: int = 0

    @property
    def n_dec(self) -> int:
        return self.num_decoder_layers or self.num_layers

    @classmethod
    def tiny(cls, **kw):
        defaults = dict(vocab_size=256, d_model=64, d_kv=16, d_ff=128, num_layers=2, num_heads=4,
                        relative_attention_num_buckets=8, relative_attention_max_distance=32)
        defaults.update(kw)
        return cls(**defaults)

    @classmethod
    def t5_small(cls, **kw):
        return cls(**kw)

    @classmethod
    def t5_base(cls, **kw):
        return cls(d_model=768, d_ff=3072, num_layers=12, num_heads=12, **kw)


def t5_rms(x, weight, eps: float) -> torch.Tensor:
    var = x.float().square().mean(-1, keepdim=True)
    y = (x * torch.rsqrt(var + eps)).to(x.dtype)
    dt = torch.promote_types(y.dtype, weight.dtype)
    return y.to(dt) * weight.to(dt)


class T5LayerNorm(nn.Module):
    def __init__(self, size: int, eps: float, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(size, device=device))
        self.eps = eps

    def forward(self, x):
        return t5_rms(x, self.weight, self.eps)


def relative_position_bucket(relative_position: torch.Tensor, *, bidirectional: bool,
                             num_buckets: int, max_distance: int) -> torch.Tensor:
    """T5's log-spaced buckets of ``key − query`` offsets, with the JAX
    function's float order (the log in fp32, truncated toward zero)."""
    ret = torch.zeros_like(relative_position)
    n = -relative_position
    if bidirectional:
        num_buckets //= 2
        ret = ret + (n < 0).to(ret.dtype) * num_buckets
        n = n.abs()
    else:
        n = n.clamp_min(0)
    max_exact = num_buckets // 2
    is_small = n < max_exact
    scale = np.float32(np.log(max_distance / max_exact))
    large = torch.log(n.float() / max_exact + 1e-6) / torch.tensor(scale) * (num_buckets - max_exact)
    large = (max_exact + large.to(torch.int32)).clamp_max(num_buckets - 1)
    return ret + torch.where(is_small, n, large.to(n.dtype))


class T5Attention(nn.Module):
    def __init__(self, cfg: T5Config, causal: bool = False, has_relative_bias: bool = False,
                 device=None):
        super().__init__()
        self.cfg, self.causal = cfg, causal
        inner = cfg.num_heads * cfg.d_kv
        self.q = _Linear(cfg.d_model, inner, cfg.dtype, device)
        self.k = _Linear(cfg.d_model, inner, cfg.dtype, device)
        self.v = _Linear(cfg.d_model, inner, cfg.dtype, device)
        self.o = _Linear(inner, cfg.d_model, cfg.dtype, device)
        if has_relative_bias:
            self.relative_attention_bias = nn.Embedding(cfg.relative_attention_num_buckets,
                                                        cfg.num_heads, device=device)

    def position_bias(self, sq: int, sk: int, device) -> torch.Tensor:
        """(1, H, Sq, Sk) fp32: the relative bias (zeros in a block without
        the table), ``-1e9`` where a causal block hides a key. Under tp the
        H of this rank's heads: the table (whole on every rank) gives their
        columns, its gradient all-reduced (``parallel/tp.pick_rows``)."""
        cfg = self.cfg
        heads = cfg.num_heads
        split = tp.is_split(self.q.weight)
        if split:
            heads //= self.q.weight.device_mesh.size()
        if hasattr(self, "relative_attention_bias"):
            rel = (torch.arange(sk, device=device)[None, :]
                   - torch.arange(sq, device=device)[:, None])
            buckets = relative_position_bucket(
                rel, bidirectional=not self.causal, num_buckets=cfg.relative_attention_num_buckets,
                max_distance=cfg.relative_attention_max_distance)
            table = self.relative_attention_bias.weight
            if split:
                table = tp.pick_rows(table.t(), self.q.weight).t()
            bias = F.embedding(buckets, table).permute(2, 0, 1)[None]
        else:
            bias = torch.zeros((1, heads, sq, sk), device=device)
        bias = bias.float()
        if self.causal:
            bias = bias.masked_fill(~causal_mask(sq, sk, device), MASKED)
        return bias

    def forward(self, x, kv=None, mask=None, bias=None):
        """``(out, bias)``: x (B, Sq, D), ``kv`` (B, Sk, D) for
        cross-attention, ``mask`` (B, Sk) key validity, ``bias`` the first
        block's, reused."""
        cfg = self.cfg
        kv = x if kv is None else kv
        b, sq, _ = x.shape
        sk = kv.shape[1]
        q = self.q(x).view(b, sq, -1, cfg.d_kv)  # local heads under tp
        k = self.k(kv).view(b, sk, -1, cfg.d_kv)
        v = self.v(kv).view(b, sk, -1, cfg.d_kv)
        if bias is None:
            bias = self.position_bias(sq, sk, x.device)
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() + bias
        if mask is not None:
            scores = scores.masked_fill(~mask[:, None, None, :].bool(), MASKED)
        probs = torch.softmax(scores, dim=-1).to(cfg.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", probs, v)
        return self.o(out.reshape(b, sq, -1)), bias


class T5FFN(nn.Module):
    def __init__(self, cfg: T5Config, device=None):
        super().__init__()
        self.wi = _Linear(cfg.d_model, cfg.d_ff, cfg.dtype, device)
        self.wo = _Linear(cfg.d_ff, cfg.d_model, cfg.dtype, device)

    def forward(self, x):
        return self.wo(F.relu(self.wi(x)))


class T5EncoderBlock(nn.Module):
    def __init__(self, cfg: T5Config, has_relative_bias: bool = False, device=None):
        super().__init__()
        eps = cfg.layer_norm_epsilon
        self.ln0 = T5LayerNorm(cfg.d_model, eps, device)
        self.self_attn = T5Attention(cfg, False, has_relative_bias, device)
        self.ln1 = T5LayerNorm(cfg.d_model, eps, device)
        self.ffn = T5FFN(cfg, device)

    def forward(self, x, mask, bias):
        h, bias = self.self_attn(self.ln0(x), mask=mask, bias=bias)
        x = x + h
        return x + self.ffn(self.ln1(x)), bias


class T5DecoderBlock(nn.Module):
    def __init__(self, cfg: T5Config, has_relative_bias: bool = False, device=None):
        super().__init__()
        eps = cfg.layer_norm_epsilon
        self.ln0 = T5LayerNorm(cfg.d_model, eps, device)
        self.self_attn = T5Attention(cfg, True, has_relative_bias, device)
        self.ln1 = T5LayerNorm(cfg.d_model, eps, device)
        self.cross_attn = T5Attention(cfg, False, False, device)
        self.ln2 = T5LayerNorm(cfg.d_model, eps, device)
        self.ffn = T5FFN(cfg, device)

    def forward(self, x, enc, self_bias, enc_mask):
        h, self_bias = self.self_attn(self.ln0(x), bias=self_bias)
        x = x + h
        h, _ = self.cross_attn(self.ln1(x), kv=enc, mask=enc_mask)
        x = x + h
        return x + self.ffn(self.ln2(x)), self_bias


class T5Stack(nn.Module):
    """``block_0`` (the bias owner) and ``block_1``..``block_{L-1}``, then
    ``final_ln``."""

    def __init__(self, cfg: T5Config, is_decoder: bool = False, device=None):
        super().__init__()
        self.cfg, self.is_decoder = cfg, is_decoder
        n = cfg.n_dec if is_decoder else cfg.num_layers
        block = T5DecoderBlock if is_decoder else T5EncoderBlock
        for i in range(n):
            self.add_module(f"block_{i}", block(cfg, i == 0, device))
        self.n_blocks = n
        self.final_ln = T5LayerNorm(cfg.d_model, cfg.layer_norm_epsilon, device)

    def blocks(self):
        return [getattr(self, f"block_{i}") for i in range(self.n_blocks)]

    def forward(self, x, mask=None, enc=None, enc_mask=None):
        args = (enc, None, enc_mask) if self.is_decoder else (mask, None)
        x, bias = self.block_0(x, *args)
        args = (enc, bias, enc_mask) if self.is_decoder else (mask, bias)
        # block_1.. on a pipeline stage: this stage's chunks (parallel/pp.run_stack).
        x = run_stack(self, self.blocks()[1:], self._rest, x, *args)
        return self.final_ln(x)

    def _rest(self, blocks, x, *args):
        for blk in blocks:
            if self.cfg.remat and torch.is_grad_enabled():
                x, _ = checkpoint(blk, x, *args, use_reentrant=False)
            else:
                x, _ = blk(x, *args)
        return x


class T5ForConditionalGeneration(nn.Module):
    # FSDP2's per-block units (parallel/fsdp.decoder_blocks).
    _fsdp_blocks = (T5EncoderBlock, T5DecoderBlock)

    def __init__(self, cfg: T5Config, device=None):
        super().__init__()
        self.config = cfg
        self.shared = nn.Embedding(cfg.vocab_size, cfg.d_model, device=device)
        self.encoder = T5Stack(cfg, False, device)
        self.decoder = T5Stack(cfg, True, device)

    def embed(self, ids):
        return tp.embedding(ids, self.shared.weight).to(self.config.dtype)

    def encode(self, input_ids, attention_mask=None):
        """(encoder states, the (B, S) mask they were taken under)."""
        if attention_mask is None:
            attention_mask = (input_ids != self.config.pad_token_id).to(torch.int32)
        return self.encoder(self.embed(input_ids), mask=attention_mask), attention_mask

    def forward(self, input_ids, decoder_input_ids, attention_mask=None):
        """Logits (B, S_dec, V) in the type the decoder's output and the
        compute dtype promote to (fp32 outside a train step)."""
        cfg = self.config
        enc, mask = self.encode(input_ids, attention_mask)
        # On a pipeline stage the decoder's first block reads the encoder's
        # output on every stage: the last stage's.
        enc = every_stage(self, enc)
        dec = self.decoder(self.embed(decoder_input_ids), enc=enc, enc_mask=mask)
        dec = dec * as_dtype(cfg.d_model ** -0.5, dec.dtype)
        head = self.shared.weight.to(cfg.dtype)
        dt = torch.promote_types(dec.dtype, head.dtype)
        return tp.vocab_logits(dec.to(dt), head.to(dt))

    def init_weights(self, generator: torch.Generator, std: float = 0.02):
        init_weights(self, generator, std)


def shift_tokens_right(labels, decoder_start_token_id: int = 0, pad_token_id: int = 0):
    """Teacher-forcing inputs ``[start, y0, y1, ...]``; label padding (-100)
    becomes ``pad_token_id``."""
    labels = torch.as_tensor(labels)
    shifted = torch.cat([torch.full_like(labels[:, :1], decoder_start_token_id),
                         labels[:, :-1]], dim=1)
    return torch.where(shifted < 0, torch.full_like(shifted, pad_token_id), shifted)


def t5_cross_entropy_loss(logits, labels, ignore_index: int = -100):
    """The mean token loss in fp32 over the labels that are not
    ``ignore_index``; inside a train step over several processes the global
    token mean (``llama.cross_entropy_loss``)."""
    from .llama import cross_entropy_loss

    return cross_entropy_loss(logits, labels, ignore_index)


def t5_tp_rules(scan_layers: bool = True) -> list[tuple[str, tuple]]:
    """The JAX package's Megatron table for T5 (``parallel/sharding.py``):
    q/k/v on their heads, ``wi`` on its output, ``o`` and ``wo`` on their
    input, the shared embedding (and the tied head) on the vocab. With
    ``scan_layers`` ``block_0`` (the relative bias's owner) has no leading
    layer dim and the scanned rest does."""
    if not scan_layers:
        return [
            (r"(self_attn|cross_attn)/(q|k|v)/kernel", (None, "tp", None)),
            (r"(self_attn|cross_attn)/o/kernel", ("tp", None, None)),
            (r"ffn/wi/kernel", (None, "tp")),
            (r"ffn/wo/kernel", ("tp", None)),
            (r"shared/embedding", ("tp", None)),
        ]
    return [
        (r"block_0/(self_attn|cross_attn)/(q|k|v)/kernel", (None, "tp", None)),
        (r"block_0/(self_attn|cross_attn)/o/kernel", ("tp", None, None)),
        (r"block_0/ffn/wi/kernel", (None, "tp")),
        (r"block_0/ffn/wo/kernel", ("tp", None)),
        (r"layers/block/(self_attn|cross_attn)/(q|k|v)/kernel", (None, None, "tp", None)),
        (r"layers/block/(self_attn|cross_attn)/o/kernel", (None, "tp", None, None)),
        (r"layers/block/ffn/wi/kernel", (None, None, "tp")),
        (r"layers/block/ffn/wo/kernel", (None, "tp", None)),
        (r"shared/embedding", ("tp", None)),
    ]
