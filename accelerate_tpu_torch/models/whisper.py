"""Whisper-family speech encoder-decoder in PyTorch (counterpart of
``accelerate_tpu/models/whisper.py``).

The encoder takes log-mel features as ``(B, T, mel)`` (the JAX package's
time-major layout; Hugging Face's ``(B, mel, T)`` is transposed on the way
in), runs two 1-D convolutions (stride 1, then 2; exact GELU after each),
adds the fixed sinusoidal positions (a parameter, ``encoder.embed_positions``,
as in the flax tree and in checkpoints) and pre-LN blocks. The decoder has
learned positions, causal self-attention, cross-attention into the encoder
states and a head tied to ``embed_tokens``. q and v projections carry
biases, k projections none (Whisper's), and every attention scales by
1/sqrt(head_dim). Names follow the flax tree
(``decoder.layers.{i}.encoder_attn.q_proj.weight`` ↔
``decoder/layers/block/encoder_attn/q_proj/kernel``); the convolutions
keep torch's ``(out, in, k)`` weights.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..parallel import tp
from .layers import FlaxLayerNorm, init_weights, module_attention, run_blocks
from .llama import _Linear

@dataclasses.dataclass
class WhisperConfig:
    vocab_size: int = 51865
    num_mel_bins: int = 80
    d_model: int = 384
    encoder_layers: int = 4
    decoder_layers: int = 4
    encoder_attention_heads: int = 6
    decoder_attention_heads: int = 6
    encoder_ffn_dim: int = 1536
    decoder_ffn_dim: int = 1536
    max_source_positions: int = 1500
    max_target_positions: int = 448
    layer_norm_eps: float = 1e-5
    dtype: Any = torch.bfloat16
    scan_layers: bool = True
    remat: bool = False

    @property
    def head_dim(self) -> int:
        return self.d_model // self.encoder_attention_heads

    @property
    def decoder_head_dim(self) -> int:
        return self.d_model // self.decoder_attention_heads

    @classmethod
    def tiny(cls, **kw):
        defaults = dict(vocab_size=256, num_mel_bins=16, d_model=64, encoder_layers=2,
                        decoder_layers=2, encoder_attention_heads=4, decoder_attention_heads=4,
                        encoder_ffn_dim=128, decoder_ffn_dim=128, max_source_positions=50,
                        max_target_positions=32)
        defaults.update(kw)
        return cls(**defaults)

    @classmethod
    def whisper_tiny(cls, **kw):
        return cls(**kw)

    @classmethod
    def whisper_large(cls, **kw):
        return cls(d_model=1280, encoder_layers=32, decoder_layers=32,
                   encoder_attention_heads=20, decoder_attention_heads=20,
                   encoder_ffn_dim=5120, decoder_ffn_dim=5120, **kw)


def sinusoidal_positions(length: int, dim: int) -> torch.Tensor:
    """Whisper's fixed sinusoid table (checkpoints store their own copy)."""
    log_timescale = np.log(10000.0) / (dim // 2 - 1)
    inv = np.exp(-log_timescale * np.arange(dim // 2))
    scaled = np.arange(length)[:, None] * inv[None, :]
    return torch.from_numpy(np.concatenate([np.sin(scaled), np.cos(scaled)], axis=1)
                            .astype(np.float32))


class WhisperAttention(nn.Module):
    def __init__(self, cfg: WhisperConfig, num_heads: int, causal: bool = False, device=None):
        super().__init__()
        self.cfg, self.num_heads, self.causal = cfg, num_heads, causal
        dm = cfg.d_model
        linear = partial(_Linear, dm, dm, cfg.dtype, device)
        self.q_proj = linear(bias=True)
        self.k_proj = linear()  # Whisper: no K bias
        self.v_proj = linear(bias=True)
        self.out_proj = linear(bias=True)

    def forward(self, x, kv=None):
        kv = x if kv is None else kv
        b, sq, _ = x.shape
        sk = kv.shape[1]
        d = self.cfg.d_model // self.num_heads  # local heads under tp
        q = self.q_proj(x).view(b, sq, -1, d)
        k = self.k_proj(kv).view(b, sk, -1, d)
        v = self.v_proj(kv).view(b, sk, -1, d)
        out = module_attention(q, k, v, self.cfg.dtype, causal=self.causal)
        return self.out_proj(out.reshape(b, sq, -1))


def _mlp(cfg: WhisperConfig, ffn: int, device):
    return (_Linear(cfg.d_model, ffn, cfg.dtype, device, bias=True),
            _Linear(ffn, cfg.d_model, cfg.dtype, device, bias=True))


class WhisperEncoderBlock(nn.Module):
    def __init__(self, cfg: WhisperConfig, device=None):
        super().__init__()
        eps = cfg.layer_norm_eps
        self.self_attn_layer_norm = FlaxLayerNorm(cfg.d_model, eps, device)
        self.self_attn = WhisperAttention(cfg, cfg.encoder_attention_heads, device=device)
        self.final_layer_norm = FlaxLayerNorm(cfg.d_model, eps, device)
        self.fc1, self.fc2 = _mlp(cfg, cfg.encoder_ffn_dim, device)

    def forward(self, x):
        x = x + self.self_attn(self.self_attn_layer_norm(x))
        return x + self.fc2(F.gelu(self.fc1(self.final_layer_norm(x))))


class WhisperDecoderBlock(nn.Module):
    def __init__(self, cfg: WhisperConfig, device=None):
        super().__init__()
        eps, heads = cfg.layer_norm_eps, cfg.decoder_attention_heads
        self.self_attn_layer_norm = FlaxLayerNorm(cfg.d_model, eps, device)
        self.self_attn = WhisperAttention(cfg, heads, causal=True, device=device)
        self.encoder_attn_layer_norm = FlaxLayerNorm(cfg.d_model, eps, device)
        self.encoder_attn = WhisperAttention(cfg, heads, device=device)
        self.final_layer_norm = FlaxLayerNorm(cfg.d_model, eps, device)
        self.fc1, self.fc2 = _mlp(cfg, cfg.decoder_ffn_dim, device)

    def forward(self, x, enc):
        x = x + self.self_attn(self.self_attn_layer_norm(x))
        x = x + self.encoder_attn(self.encoder_attn_layer_norm(x), kv=enc)
        return x + self.fc2(F.gelu(self.fc1(self.final_layer_norm(x))))


class _Conv1d(nn.Module):
    """flax ``nn.Conv`` over (B, T, C) with padding 1, weights in torch's
    ``(out, in, k)``; kernel and input in the compute dtype, the bias added
    after the product."""

    def __init__(self, cin: int, cout: int, stride: int, dtype, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, 3, device=device))
        self.bias = nn.Parameter(torch.zeros(cout, device=device))
        self.stride, self.dtype = stride, dtype

    def forward(self, x):
        y = F.conv1d(x.to(self.dtype).transpose(1, 2), self.weight.to(self.dtype),
                     stride=self.stride, padding=1).transpose(1, 2)
        return y + self.bias.to(self.dtype)


class WhisperEncoder(nn.Module):
    def __init__(self, cfg: WhisperConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.conv1 = _Conv1d(cfg.num_mel_bins, cfg.d_model, 1, cfg.dtype, device)
        self.conv2 = _Conv1d(cfg.d_model, cfg.d_model, 2, cfg.dtype, device)
        self.embed_positions = nn.Parameter(
            sinusoidal_positions(cfg.max_source_positions, cfg.d_model).to(device))
        self.layers = nn.ModuleList(WhisperEncoderBlock(cfg, device)
                                    for _ in range(cfg.encoder_layers))
        self.layer_norm = FlaxLayerNorm(cfg.d_model, cfg.layer_norm_eps, device)

    def forward(self, input_features):
        """``input_features`` (B, T, mel) → (B, T/2, d_model)."""
        x = F.gelu(self.conv1(input_features))
        x = F.gelu(self.conv2(x))
        x = x + self.embed_positions[None, :x.shape[1]].to(x.dtype)
        return self.layer_norm(run_blocks(self.layers, x, self.cfg.remat))


class WhisperDecoder(nn.Module):
    def __init__(self, cfg: WhisperConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.d_model, device=device)
        self.embed_positions = nn.Embedding(cfg.max_target_positions, cfg.d_model, device=device)
        self.layers = nn.ModuleList(WhisperDecoderBlock(cfg, device)
                                    for _ in range(cfg.decoder_layers))
        self.layer_norm = FlaxLayerNorm(cfg.d_model, cfg.layer_norm_eps, device)

    def forward(self, input_ids, enc):
        cfg = self.cfg
        pos = torch.arange(input_ids.shape[-1], device=input_ids.device)
        x = (tp.embedding(input_ids, self.embed_tokens.weight).to(cfg.dtype)
             + F.embedding(pos, self.embed_positions.weight).to(cfg.dtype))
        return self.layer_norm(run_blocks(self.layers, x, cfg.remat, enc))


class WhisperForConditionalGeneration(nn.Module):
    # FSDP2's per-block units (parallel/fsdp.decoder_blocks).
    _fsdp_blocks = (WhisperEncoderBlock, WhisperDecoderBlock)

    def __init__(self, cfg: WhisperConfig, device=None):
        super().__init__()
        self.config = cfg
        self.encoder = WhisperEncoder(cfg, device)
        self.decoder = WhisperDecoder(cfg, device)

    def forward(self, input_features, decoder_input_ids):
        """fp32 logits (B, S_dec, V) of the head tied to ``embed_tokens``."""
        dec = self.decoder(decoder_input_ids, self.encoder(input_features))
        head = self.decoder.embed_tokens.weight.to(self.config.dtype)
        dt = torch.promote_types(dec.dtype, head.dtype)
        return tp.vocab_logits(dec.to(dt), head.to(dt), post=lambda y: y.float())

    def init_weights(self, generator: torch.Generator, std: float = 0.02):
        """normal(0, std) matrices, kernels and embeddings, zero biases, unit
        norm scales; the sinusoidal positions stay."""
        init_weights(self, generator, std, keep=("encoder.embed_positions",))


def whisper_tp_rules(scan_layers: bool = True) -> list[tuple[str, tuple]]:
    """The JAX package's TP rule table for Whisper (``parallel/sharding.py``):
    self- and cross-attention q/k/v on their heads, ``fc1`` on its output,
    ``out_proj`` and ``fc2`` on their input, the decoder's ``embed_tokens``
    (and the tied head) on the vocab."""
    lead = (None,) if scan_layers else ()
    return [
        (r"(self_attn|encoder_attn)/(q_proj|k_proj|v_proj)/kernel", lead + (None, "tp", None)),
        (r"(self_attn|encoder_attn)/out_proj/kernel", lead + ("tp", None, None)),
        (r"fc1/kernel", lead + (None, "tp")),
        (r"fc2/kernel", lead + ("tp", None)),
        (r"embed_tokens/embedding", ("tp", None)),
    ]
