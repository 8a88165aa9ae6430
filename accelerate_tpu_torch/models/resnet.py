"""ResNet v1.5 image classifier in PyTorch (counterpart of
``accelerate_tpu/models/resnet.py``).

Images come in as the JAX module takes them, NHWC ``(B, H, W, 3)``; the
permute to NCHW is a view whose memory is already ``channels_last``, the
layout cuDNN's NHWC convolutions take, and every activation stays in it.
Bottleneck blocks with the stride on the 3×3 convolution, flax's
``padding="SAME"`` (``layers.pad_same``: the stem pads (2, 3) on 224
pixels, the max pool (0, 1) with −inf, a stride-2 3×3 (0, 1)), flax's
BatchNorm (``layers.FlaxBatchNorm``: fp32 statistics, ``bn_momentum`` 0.9
on the biased variance, the global batch's statistics in a train step over
several processes) with each block's ``bn3`` scale zero-initialised, the
global average pool in fp32 and fp32 logits.

The parameter and buffer names are the flax tree's (``stage0_block0.conv1.
weight`` ↔ ``stage0_block0/conv1/kernel``, ``stem_bn.scale``, ``stem_bn.
mean``); convolution weights are ``(out, in, kh, kw)`` where flax's kernels
are ``(kh, kw, in, out)`` (``models/convert.py``).

The running statistics are flax's ``batch_stats`` collection: ``Model.
extra_state`` is ``{"batch_stats": ...}`` of the module's buffers, and
``resnet_loss`` is the loss ``prepare_train_step(mutable_state=True)``
takes. ``forward(images, train=True, batch_stats=...)`` returns the logits
and the updated statistics, as flax's ``apply(..., mutable=["batch_stats"])``
does; with ``train=False`` the logits of the running statistics.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch import nn

from .layers import FlaxBatchNorm, pad_same, same_padding


@dataclasses.dataclass
class ResNetConfig:
    num_classes: int = 1000
    width: int = 64
    stage_sizes: tuple = (3, 4, 6, 3)  # ResNet-50
    dtype: Any = torch.bfloat16
    bn_momentum: float = 0.9
    bn_eps: float = 1e-5

    @classmethod
    def tiny(cls, **kw):
        defaults = dict(num_classes=4, width=16, stage_sizes=(1, 1))
        defaults.update(kw)
        return cls(**defaults)

    @classmethod
    def resnet50(cls, **kw):
        return cls(**kw)

    @classmethod
    def resnet101(cls, **kw):
        return cls(stage_sizes=(3, 4, 23, 3), **kw)

    @classmethod
    def resnet152(cls, **kw):
        return cls(stage_sizes=(3, 8, 36, 3), **kw)


class _Conv(nn.Module):
    """flax's ``nn.Conv`` without a bias, ``padding="SAME"``: input and
    weight cast to the compute dtype."""

    def __init__(self, c_in: int, c_out: int, kernel: int, stride: int, dtype, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c_out, c_in, kernel, kernel, device=device))
        self.kernel, self.stride, self.dtype = kernel, stride, dtype

    def forward(self, x):
        x, w = x.to(self.dtype), self.weight.to(self.dtype)
        pad = [same_padding(x.shape[d], self.kernel, self.stride) for d in (2, 3)]
        if all(before == after for before, after in pad):  # the convolution pads itself
            return F.conv2d(x, w, stride=self.stride, padding=(pad[0][0], pad[1][0]))
        return F.conv2d(pad_same(x, self.kernel, self.stride), w, stride=self.stride)


def _stats(tree: Optional[dict], name: str) -> Optional[dict]:
    return None if tree is None else tree[name]


class BottleneckBlock(nn.Module):
    def __init__(self, cfg: ResNetConfig, c_in: int, filters: int, stride: int = 1,
                 device=None):
        super().__init__()
        conv = lambda i, o, k, s=1: _Conv(i, o, k, s, cfg.dtype, device)  # noqa: E731
        norm = lambda c: FlaxBatchNorm(c, cfg.bn_momentum, cfg.bn_eps, cfg.dtype,  # noqa: E731
                                       device)
        self.conv1, self.bn1 = conv(c_in, filters, 1), norm(filters)
        self.conv2, self.bn2 = conv(filters, filters, 3, stride), norm(filters)
        self.conv3, self.bn3 = conv(filters, 4 * filters, 1), norm(4 * filters)
        with torch.no_grad():
            self.bn3.scale.zero_()  # the block starts as the identity
        self.has_downsample = c_in != 4 * filters or stride != 1
        if self.has_downsample:
            self.downsample = conv(c_in, 4 * filters, 1, stride)
            self.downsample_bn = norm(4 * filters)

    def forward(self, x, train: bool = False, stats: Optional[dict] = None):
        new = {}
        y, new["bn1"] = self.bn1(self.conv1(x), train, _stats(stats, "bn1"))
        y, new["bn2"] = self.bn2(self.conv2(F.relu(y)), train, _stats(stats, "bn2"))
        y, new["bn3"] = self.bn3(self.conv3(F.relu(y)), train, _stats(stats, "bn3"))
        residual = x
        if self.has_downsample:
            residual, new["downsample_bn"] = self.downsample_bn(
                self.downsample(x), train, _stats(stats, "downsample_bn"))
        return F.relu(residual + y), new


class ResNet(nn.Module):
    """Images (B, H, W, 3) → logits (B, num_classes) in fp32."""

    # FSDP2's per-block units (parallel/fsdp.decoder_blocks).
    _fsdp_blocks = (BottleneckBlock,)

    def __init__(self, cfg: ResNetConfig, device=None):
        super().__init__()
        self.config = cfg
        self.stem = _Conv(3, cfg.width, 7, 2, cfg.dtype, device)
        self.stem_bn = FlaxBatchNorm(cfg.width, cfg.bn_momentum, cfg.bn_eps, cfg.dtype, device)
        self.block_names = []
        c_in = cfg.width
        for stage, n_blocks in enumerate(cfg.stage_sizes):
            filters = cfg.width * 2 ** stage
            for block in range(n_blocks):
                stride = 2 if stage > 0 and block == 0 else 1
                name = f"stage{stage}_block{block}"
                self.add_module(name, BottleneckBlock(cfg, c_in, filters, stride, device))
                self.block_names.append(name)
                c_in = 4 * filters
        self.classifier = nn.Linear(c_in, cfg.num_classes, device=device)

    def forward(self, images, train: bool = False, batch_stats: Optional[dict] = None):
        """``batch_stats``: the running statistics to read (flax's tree,
        ``Model.extra_state["batch_stats"]``), else the buffers. Returns the
        logits, and with ``train`` also ``{"batch_stats": ...}`` after the
        call."""
        cfg = self.config
        x = images.to(cfg.dtype).permute(0, 3, 1, 2)  # NCHW view, channels_last memory
        new = {}
        x, new["stem_bn"] = self.stem_bn(self.stem(x), train, _stats(batch_stats, "stem_bn"))
        x = F.max_pool2d(pad_same(F.relu(x), 3, 2, value=float("-inf")), 3, 2)
        for name in self.block_names:
            x, new[name] = getattr(self, name)(x, train, _stats(batch_stats, name))
        pooled = x.float().mean((2, 3)).to(cfg.dtype)  # flax's mean: summed in fp32
        logits = F.linear(pooled.float(), self.classifier.weight.float(),
                          self.classifier.bias.float())
        return (logits, {"batch_stats": new}) if train else logits

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        """Seeded random weights as flax's initialisers give them:
        lecun-normal convolution and classifier kernels (std 1/sqrt(fan-in)),
        zero biases, unit BatchNorm scales but each block's zero ``bn3``,
        running statistics of zero mean and unit variance."""
        for name, p in self.named_parameters():
            if p.dim() >= 2:
                p.normal_(0.0, 1.0 / p[0].numel() ** 0.5, generator=generator)
            elif name.endswith("bn3.scale") or name.endswith("bias"):
                p.zero_()
            else:
                p.fill_(1.0)
        for name, b in self.named_buffers():
            b.fill_(0.0 if name.endswith("mean") else 1.0)


def resnet_loss(model, extra_state: Optional[dict], images, labels, train: bool = True):
    """Cross-entropy of the logits, threading BatchNorm's statistics: the
    loss ``prepare_train_step(mutable_state=True)`` takes, as
    ``loss_fn(model, extra_state, batch)``. Returns ``(loss, new
    extra_state)`` with ``extra_state`` flax's ``{"batch_stats": ...}``."""
    stats = None if extra_state is None else extra_state["batch_stats"]
    if train:
        logits, new = model(images, train=True, batch_stats=stats)
    else:
        logits, new = model(images, train=False, batch_stats=stats), extra_state
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, labels.long()[:, None]).mean(), new
