"""CLIP dual encoder in PyTorch (counterpart of ``accelerate_tpu/models/clip.py``).

One pre-LN block (``CLIPBlock``: flax's LayerNorm, materialised attention,
a ``quick_gelu`` or ``gelu`` MLP by ``hidden_act``) serves both towers: the
text tower runs it causal, the vision tower bidirectional.

- Text: token and position embeddings, the blocks, ``final_ln``; the
  pooled feature is the EOT token's: with ``eos_token_id == 2`` (the
  legacy convention) at the arg-max of the ids, else at the first position
  holding ``eos_token_id``.
- Vision: a patch convolution without a bias on NHWC pixels (``VALID``),
  a class embedding and positions, ``pre_ln``, the blocks, ``post_ln`` on
  the class token.
- The fp32 projections, both embeddings normalised, and the logits scaled
  by ``exp(logit_scale)``: ``forward`` returns ``(logits_per_image,
  logits_per_text, image_embeds, text_embeds)`` as the JAX module does;
  inside a train step over several processes, this process's rows of the
  global batch's logits (``gather_rows``).

Parameter names follow the flax tree (``text.layers.{i}.self_attn.q_proj.
weight`` ↔ ``text/layers/block/self_attn/q_proj/kernel``; ``models/
convert.py``).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..utils import operations
from .layers import FlaxLayerNorm, gather_rows, init_weights, module_attention, run_blocks
from .llama import _Linear, as_dtype
from .vit import patch_embed

@dataclasses.dataclass
class CLIPConfig:
    # Text tower (defaults: openai/clip-vit-base-patch32)
    vocab_size: int = 49408
    text_hidden_size: int = 512
    text_num_layers: int = 12
    text_num_heads: int = 8
    text_intermediate_size: int = 2048
    max_position_embeddings: int = 77
    # Vision tower
    image_size: int = 224
    patch_size: int = 32
    num_channels: int = 3
    vision_hidden_size: int = 768
    vision_num_layers: int = 12
    vision_num_heads: int = 12
    vision_intermediate_size: int = 3072
    # Joint space
    projection_dim: int = 512
    logit_scale_init: float = 2.6592  # ln(1/0.07), the CLIP paper value
    layer_norm_eps: float = 1e-5
    # Text pooling: eos_token_id == 2 pools at the arg-max of the ids (the
    # legacy convention, EOT carries the largest id); any other value at the
    # first position equal to it.
    eos_token_id: int = 49407
    hidden_act: str = "quick_gelu"  # both towers; gelu for LAION-style checkpoints
    dtype: Any = torch.bfloat16
    # Kept so a JAX config's fields carry over; convert.py reads both layouts.
    scan_layers: bool = True
    remat: bool = False

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @classmethod
    def tiny(cls, **kw):
        defaults = dict(
            vocab_size=512, text_hidden_size=32, text_num_layers=2, text_num_heads=2,
            text_intermediate_size=64, max_position_embeddings=16, image_size=32,
            patch_size=8, vision_hidden_size=48, vision_num_layers=2, vision_num_heads=2,
            vision_intermediate_size=96, projection_dim=24, eos_token_id=2)
        defaults.update(kw)
        return cls(**defaults)


def quick_gelu(x):
    """CLIP's activation: x · sigmoid(1.702 x), the constant rounded to the
    input's type first, as the JAX module's weakly typed one is."""
    return x * torch.sigmoid(as_dtype(1.702, x.dtype) * x)


_ACTIVATIONS = {
    "quick_gelu": quick_gelu,
    "gelu": F.gelu,
    "gelu_new": partial(F.gelu, approximate="tanh"),
    "gelu_pytorch_tanh": partial(F.gelu, approximate="tanh"),
}


def _activation(name: str):
    if name not in _ACTIVATIONS:
        raise ValueError(f"Unsupported CLIP hidden_act {name!r}; supported: "
                         f"{sorted(_ACTIVATIONS)}")
    return _ACTIVATIONS[name]


class CLIPAttention(nn.Module):
    def __init__(self, cfg: CLIPConfig, hidden: int, heads: int, causal: bool, device=None):
        super().__init__()
        self.dtype, self.heads, self.causal = cfg.dtype, heads, causal
        linear = partial(_Linear, dtype=cfg.dtype, device=device, bias=True)
        self.q_proj, self.k_proj, self.v_proj = (linear(hidden, hidden) for _ in range(3))
        self.out_proj = linear(hidden, hidden)

    def forward(self, x):
        b, s, h = x.shape
        q, k, v = (p(x).view(b, s, -1, h // self.heads)  # local heads under tp
                   for p in (self.q_proj, self.k_proj, self.v_proj))
        out = module_attention(q, k, v, self.dtype, causal=self.causal)
        return self.out_proj(out.reshape(b, s, -1))


class CLIPBlock(nn.Module):
    """Pre-LN encoder block, shared by both towers."""

    def __init__(self, cfg: CLIPConfig, hidden: int, heads: int, intermediate: int,
                 causal: bool, device=None):
        super().__init__()
        eps = cfg.layer_norm_eps
        linear = partial(_Linear, dtype=cfg.dtype, device=device, bias=True)
        self.act = _activation(cfg.hidden_act)
        self.ln1 = FlaxLayerNorm(hidden, eps, device)
        self.self_attn = CLIPAttention(cfg, hidden, heads, causal, device)
        self.ln2 = FlaxLayerNorm(hidden, eps, device)
        self.fc1, self.fc2 = linear(hidden, intermediate), linear(intermediate, hidden)

    def forward(self, x):
        x = x + self.self_attn(self.ln1(x))
        return x + self.fc2(self.act(self.fc1(self.ln2(x))))


class CLIPTextModel(nn.Module):
    def __init__(self, cfg: CLIPConfig, device=None):
        super().__init__()
        self.cfg = cfg
        h = cfg.text_hidden_size
        self.token_embedding = nn.Parameter(torch.zeros(cfg.vocab_size, h, device=device))
        self.position_embedding = nn.Parameter(
            torch.zeros(cfg.max_position_embeddings, h, device=device))
        self.layers = nn.ModuleList(
            CLIPBlock(cfg, h, cfg.text_num_heads, cfg.text_intermediate_size, True, device)
            for _ in range(cfg.text_num_layers))
        self.final_ln = FlaxLayerNorm(h, cfg.layer_norm_eps, device)

    def forward(self, input_ids):
        """input_ids (B, S) → (last hidden (B, S, H), pooled (B, H))."""
        cfg = self.cfg
        s = input_ids.shape[1]
        x = (F.embedding(input_ids, self.token_embedding).to(cfg.dtype)
             + self.position_embedding[None, :s].to(cfg.dtype))
        x = self.final_ln(run_blocks(self.layers, x, cfg.remat))
        if cfg.eos_token_id == 2:
            eot = input_ids.argmax(-1)
        else:  # the first position holding the id (0 where none does)
            eot = (input_ids == cfg.eos_token_id).int().argmax(-1)
        return x, x[torch.arange(x.shape[0], device=x.device), eot]


class CLIPVisionModel(nn.Module):
    def __init__(self, cfg: CLIPConfig, device=None):
        super().__init__()
        self.cfg = cfg
        h, p = cfg.vision_hidden_size, cfg.patch_size
        self.patch_embed = nn.Conv2d(cfg.num_channels, h, p, stride=p, bias=False,
                                     device=device)
        self.class_embedding = nn.Parameter(torch.zeros(h, device=device))
        self.position_embedding = nn.Parameter(
            torch.zeros(cfg.num_patches + 1, h, device=device))
        self.pre_ln = FlaxLayerNorm(h, cfg.layer_norm_eps, device)
        self.layers = nn.ModuleList(
            CLIPBlock(cfg, h, cfg.vision_num_heads, cfg.vision_intermediate_size, False, device)
            for _ in range(cfg.vision_num_layers))
        self.post_ln = FlaxLayerNorm(h, cfg.layer_norm_eps, device)

    def forward(self, pixel_values):
        """(B, H, W, C) NHWC → (last hidden, pooled: the class token)."""
        cfg = self.cfg
        x = patch_embed(pixel_values, self.patch_embed.weight, None, cfg.patch_size, cfg.dtype)
        cls = self.class_embedding.to(x.dtype).expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x], 1) + self.position_embedding[None].to(x.dtype)
        x = run_blocks(self.layers, self.pre_ln(x), cfg.remat)
        return x, self.post_ln(x[:, 0])


class CLIPModel(nn.Module):
    """Dual encoder: ``(logits_per_image, logits_per_text, image_embeds,
    text_embeds)`` like transformers' ``CLIPModel``, the embeddings
    normalised."""

    # FSDP2's per-block units (parallel/fsdp.decoder_blocks).
    _fsdp_blocks = (CLIPBlock,)

    def __init__(self, cfg: CLIPConfig, device=None):
        super().__init__()
        self.config = cfg
        self.text = CLIPTextModel(cfg, device)
        self.vision = CLIPVisionModel(cfg, device)
        self.text_projection = nn.Linear(cfg.text_hidden_size, cfg.projection_dim, bias=False,
                                         device=device)
        self.visual_projection = nn.Linear(cfg.vision_hidden_size, cfg.projection_dim,
                                           bias=False, device=device)
        self.logit_scale = nn.Parameter(torch.full((), cfg.logit_scale_init, device=device))

    def encode_text(self, input_ids):
        _, pooled = self.text(input_ids)
        return F.linear(pooled.float(), self.text_projection.weight.float())

    def encode_image(self, pixel_values):
        _, pooled = self.vision(pixel_values)
        return F.linear(pooled.float(), self.visual_projection.weight.float())

    def forward(self, input_ids, pixel_values):
        """Inside a train step over several processes the logits are this
        process's rows of the global batch's: its images against every
        process's texts and its texts against every process's images
        (``gather_rows``), as the JAX step's logits on the global batch
        are; the embeddings are this process's own."""
        text = self.encode_text(input_ids)
        image = self.encode_image(pixel_values)
        text = text / torch.linalg.vector_norm(text, dim=-1, keepdim=True)
        image = image / torch.linalg.vector_norm(image, dim=-1, keepdim=True)
        scale = torch.exp(self.logit_scale.float())
        if operations.loss_processes() == 1:
            logits_per_text = scale * text @ image.T
            return logits_per_text.T, logits_per_text, image, text
        return (scale * image @ gather_rows(text).T, scale * text @ gather_rows(image).T,
                image, text)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator, std: float = 0.02):
        """normal(0, std) matrices, kernels and tables (the class embedding
        too), zero biases, unit norm scales, ``logit_scale`` at
        ``logit_scale_init``; ``generator`` on the parameters' device."""
        init_weights(self, generator, std, keep=("logit_scale",))
        self.vision.class_embedding.normal_(0.0, std, generator=generator)


def clip_contrastive_loss(model, input_ids, pixel_values):
    """Symmetric InfoNCE over the in-batch similarities: the mean of the
    two directions' cross entropies, the matched pairs on the diagonal.
    Inside a train step over several processes each row is contrasted
    against the whole global batch (``CLIPModel.forward``), and this
    process's rows sit on the diagonal from its first row's global index,
    so the step's mean over processes is the JAX step's loss on the global
    batch."""
    logits_per_image, logits_per_text, _, _ = model(input_ids, pixel_values)
    rows = torch.arange(logits_per_image.shape[0], device=logits_per_image.device)
    cols = rows
    if operations.loss_processes() > 1:
        cols = rows + dist.get_rank(operations.loss_group()) * rows.numel()
    li = -torch.log_softmax(logits_per_image.float(), -1)[rows, cols].mean()
    lt = -torch.log_softmax(logits_per_text.float(), -1)[rows, cols].mean()
    return (li + lt) / 2


def clip_tp_rules(scan_layers: bool = True) -> list[tuple[str, tuple]]:
    """The JAX package's TP rule table for both CLIP towers (ViT's shape;
    ``parallel/sharding.py``)."""
    lead = (None,) if scan_layers else ()
    return [
        (r"self_attn/(q_proj|k_proj|v_proj)/kernel", lead + (None, "tp", None)),
        (r"self_attn/out_proj/kernel", lead + ("tp", None, None)),
        (r"fc1/kernel", lead + (None, "tp")),
        (r"fc2/kernel", lead + ("tp", None)),
    ]
