"""Weight-only int8 / NF4 quantization and the int8 decode path
(counterpart of ``accelerate_tpu/utils/quantization.py``).

Weight-only (``QuantizationConfig``, ``load_and_quantize_model``): the JAX
package's codes on the JAX package's layouts. Every function here that
takes a weight takes it as the flax tree holds it, the output features last
(a Dense kernel ``(in, out)``, q/k/v ``(H, heads, D)``, a stacked
``nn.scan`` leaf with its layer axis first); a torch ``(out, in)`` weight is
quantized as its transpose, which ``models/convert.flax_leaf`` gives, so the
codes and scales equal the JAX package's bit for bit:

- **int8**: symmetric, one fp32 scale per output feature (the absmax over
  every other axis, stacked layers included, divided by 127);
- **NF4**: the 16 quantiles of N(0, 1) (QLoRA's codebook), one absmax scale
  per group of ``group_size`` rows of the leaf flattened to ``(rows, out)``
  (groups along the input axes, stacked layers included), two codes a
  byte.

``load_and_quantize_model`` quantizes the model's flax tree leaf by leaf and
gives a copy of the module whose quantized weights are parametrized
(``torch.nn.utils.parametrize``): each weight is dequantized to the compute
dtype where its module reads it, inside its forward. The JAX package
dequantizes the whole tree under ``jit``, where XLA fuses each
dequantization into its product; eager PyTorch would hold a full copy of the
model for the call, so here the peak stays near the codes' bytes plus one
weight. The model passed in keeps its own weights.

The int8 decode path (``quantize_model_for_decode``): an inference-only copy
of a Llama model whose block projections are int8 codes with one fp32 scale
per output channel (symmetric, reduced over the matmul's contraction dims).
The cached forward (``generation._kernel``) dequantizes each one next to its
matmul; embeddings, the LM head (a tied one is the embedding), the norms and
the biases stay full precision, as in the JAX package. Every config of the
Llama chassis takes it (an ungated MLP has no ``gate_proj`` to quantize).
The port's projections are 2-D ``(out, in)`` weights, so the contraction
dim is dim 1 for every projection. That is the logical reduction the JAX
package makes over its flax layouts (the hidden dim of the q/k/v and MLP
kernels, ``(heads, D)`` of the 4-D ``o_proj`` kernel), and the codes and
scales equal JAX's after ``models/convert.py``'s reshape.
"""

from __future__ import annotations

import dataclasses
import re
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch
from torch import nn

from ..model import Model

# Block projections (state-dict names inside ``model.layers.{i}.``) that
# quantize_model_for_decode turns into int8.
DECODE_QUANT_WEIGHTS = (
    "self_attn.q_proj.weight", "self_attn.k_proj.weight", "self_attn.v_proj.weight",
    "self_attn.o_proj.weight", "mlp.gate_proj.weight", "mlp.up_proj.weight",
    "mlp.down_proj.weight",
)


@dataclass
class DecodeQuant:
    """int8 ``data`` of a projection's weight and fp32 ``scales``, one per
    output channel (the reduced dims kept with size 1)."""

    data: torch.Tensor    # int8, the weight's shape
    scales: torch.Tensor  # fp32, (out, 1)


def quantize_decode_kernel(w: torch.Tensor) -> DecodeQuant:
    """Symmetric int8 of an ``(out, in)`` weight over its contraction dim
    (dim 1), one scale for every output channel."""
    w32 = w.detach().float()
    amax = w32.abs().amax(dim=1, keepdim=True)
    scales = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(w32 / scales), -127, 127).to(torch.int8)
    return DecodeQuant(data=q, scales=scales)


def dequantize_decode_kernel(dq: DecodeQuant, dtype=torch.bfloat16) -> torch.Tensor:
    # int8 × fp32 promotes to fp32 inside one kernel; the product is then
    # rounded to `dtype`, as the JAX package rounds it.
    return torch.mul(dq.data, dq.scales).to(dtype)


class DecodeQuantizedModel(Model):
    """A ``Model`` whose ``params`` (state-dict names → tensor or
    ``DecodeQuant``) hold int8 block projections. Only ``generate`` and
    ``ServingEngine`` read it; the wrapped module keeps its own weights."""

    def __init__(self, module, params: dict):
        super().__init__(module)
        self.params = params

    def __call__(self, *args, **kwargs):
        raise ValueError(
            "decode-quantized models only support generate()/ServingEngine; run full "
            "forwards on the original Model (its weights are untouched).")


def quantize_model_for_decode(model) -> DecodeQuantizedModel:
    """An inference-only copy of ``model`` (a ``Model`` or a Llama
    ``nn.Module``) whose block projections are int8 ``DecodeQuant``.
    Llama-family layouts only: a model without
    ``model.layers.{i}.self_attn.q_proj`` raises ``ValueError``."""
    module = getattr(model, "module", model)
    named = {name: p.detach() for name, p in module.named_parameters()}
    if "model.layers.0.self_attn.q_proj.weight" not in named:
        raise ValueError(
            "quantize_model_for_decode supports the Llama-family layout only; got a "
            f"{type(module).__name__} without model.layers.*.self_attn.q_proj")
    params = {}
    for name, p in named.items():
        block_weight = name.startswith("model.layers.") and name.split(".", 3)[3] in \
            DECODE_QUANT_WEIGHTS
        params[name] = quantize_decode_kernel(p) if block_weight else p
    return DecodeQuantizedModel(module, params)


# ---------------------------------------------------------------------------
# Weight-only int8 / NF4
# ---------------------------------------------------------------------------


@dataclass
class QuantizationConfig:
    """Weight-only quantization: ``load_in_8bit`` or ``load_in_4bit`` (NF4),
    ``group_size`` rows per NF4 scale, ``compute_dtype`` of the dequantized
    weights, ``skip_modules`` (name regexes kept in full precision),
    ``keep_in_fp32_modules`` (regexes cast to fp32) and
    ``min_size_to_quantize`` (smaller tensors are kept)."""

    load_in_8bit: bool = False
    load_in_4bit: bool = False
    group_size: int = 64
    compute_dtype: Any = torch.bfloat16
    skip_modules: Optional[list[str]] = None
    keep_in_fp32_modules: Optional[list[str]] = None
    min_size_to_quantize: int = 2**12

    def __post_init__(self):
        if self.load_in_8bit and self.load_in_4bit:
            raise ValueError("load_in_8bit and load_in_4bit are mutually exclusive")
        if not (self.load_in_8bit or self.load_in_4bit):
            raise ValueError("Set load_in_8bit=True or load_in_4bit=True")
        if self.group_size % 2 != 0:
            raise ValueError("group_size must be even (two int4 per byte)")

    @property
    def bits(self) -> int:
        return 8 if self.load_in_8bit else 4


BnbQuantizationConfig = QuantizationConfig

# NF4 codebook (QLoRA): the 16 quantiles of N(0, 1) normalised to [-1, 1],
# and the midpoints between neighbouring levels (fp32, as numpy makes them).
NF4_CODE = np.asarray(
    [-1.0, -0.6961928009986877, -0.5250730514526367, -0.39491748809814453,
     -0.28444138169288635, -0.18477343022823334, -0.09105003625154495, 0.0,
     0.07958029955625534, 0.16093020141124725, 0.24611230194568634, 0.33791524171829224,
     0.44070982933044434, 0.5626170039176941, 0.7229568362236023, 1.0], dtype=np.float32)
NF4_BOUNDARIES = (NF4_CODE[1:] + NF4_CODE[:-1]) / 2.0


@dataclass
class QuantizedTensor:
    """A quantized leaf: ``data`` (int8, or uint8 holding two NF4 codes),
    fp32 ``scales`` (per output feature for int8, ``(groups, out)`` for
    NF4), the leaf's ``shape``, ``bits`` and ``group_size``."""

    data: torch.Tensor
    scales: torch.Tensor
    shape: tuple
    bits: int
    group_size: int = 64

    @property
    def nbytes_packed(self) -> int:
        return (self.data.numel() * self.data.element_size()
                + self.scales.numel() * self.scales.element_size())


def quantize_tensor_int8(w: torch.Tensor) -> QuantizedTensor:
    """Symmetric int8, one scale per output feature (the last axis)."""
    w32 = torch.as_tensor(w).detach().float()
    amax = w32.abs().amax(dim=tuple(range(w32.dim() - 1)), keepdim=True)
    scales = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(w32 / scales), -127, 127).to(torch.int8)
    return QuantizedTensor(data=q, scales=scales, shape=tuple(w32.shape), bits=8)


def quantize_tensor_int4(w: torch.Tensor, group_size: int = 64) -> QuantizedTensor:
    """NF4: each group of ``group_size`` rows of the leaf flattened to
    ``(rows, out)`` divided by its absmax, each value coded as its nearest
    NF4 level, two codes a byte (even row in the low nibble)."""
    w32 = torch.as_tensor(w).detach().float()
    shape = tuple(w32.shape)
    w2 = w32.reshape(-1, shape[-1])
    k, n = w2.shape
    pad = (-k) % group_size
    if pad:
        w2 = torch.cat([w2, w2.new_zeros(pad, n)], dim=0)
    grouped = w2.reshape(-1, group_size, n)
    amax = grouped.abs().amax(dim=1, keepdim=True)
    scales = torch.where(amax > 0, amax, torch.ones_like(amax))
    normalized = (grouped / scales).contiguous()
    bounds = torch.from_numpy(NF4_BOUNDARIES).to(w32.device)
    idx = torch.searchsorted(bounds, normalized).to(torch.uint8).reshape(-1, n)
    packed = (idx[1::2] << 4) | idx[0::2]
    return QuantizedTensor(data=packed, scales=scales[:, 0, :], shape=shape, bits=4,
                           group_size=group_size)


def _unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """uint8 bytes → NF4 codes in [0, 15], interleaved back to rows."""
    rows = torch.stack([packed & 0xF, (packed >> 4) & 0xF], dim=1)
    return rows.reshape(-1, packed.shape[-1])


def dequantize_tensor(qt, dtype=torch.bfloat16) -> torch.Tensor:
    """The leaf's values in ``dtype`` (fp32 arithmetic, then rounded)."""
    if isinstance(qt, DecodeQuant):
        return dequantize_decode_kernel(qt, dtype)
    if not isinstance(qt, QuantizedTensor):
        raise TypeError(f"not a quantized leaf: {type(qt).__name__}")
    if qt.bits == 8:
        return (qt.data.float() * qt.scales).to(dtype).reshape(qt.shape)
    k = int(np.prod(qt.shape[:-1]))
    n = qt.shape[-1]
    code = torch.from_numpy(NF4_CODE).to(qt.data.device)
    vals = code[_unpack_int4(qt.data).long()]
    grouped = vals.reshape(-1, qt.group_size, n) * qt.scales[:, None, :]
    return grouped.reshape(-1, n)[:k].reshape(qt.shape).to(dtype)


def is_quantized(leaf) -> bool:
    return isinstance(leaf, (QuantizedTensor, DecodeQuant))


def _quantize_leaf(path: str, x, config: QuantizationConfig, skip, fp32_keep):
    """One leaf of ``quantize_params``: kept, cast to fp32, or quantized."""
    if not (torch.is_tensor(x) and x.is_floating_point()):
        return x
    if any(r.search(path) for r in fp32_keep):
        return x.float()
    if x.dim() < 2 or x.numel() < config.min_size_to_quantize or any(
            r.search(path) for r in skip):
        return x
    if config.bits == 8:
        return quantize_tensor_int8(x)
    return quantize_tensor_int4(x, config.group_size)


def quantize_params(params, config: QuantizationConfig, sep: str = "/"):
    """Quantize the eligible leaves of a flax-layout tree (nested dicts of
    tensors): floating tensors of at least two dims and
    ``min_size_to_quantize`` elements whose path matches no
    ``skip_modules`` regex. Returns the mixed tree."""
    skip = [re.compile(p) for p in (config.skip_modules or [])]
    fp32_keep = [re.compile(p) for p in (config.keep_in_fp32_modules or [])]

    def _walk(prefix, node):
        if isinstance(node, dict):
            return {k: _walk(f"{prefix}{sep}{k}" if prefix else k, v) for k, v in node.items()}
        return _quantize_leaf(prefix, torch.as_tensor(node) if isinstance(node, np.ndarray)
                              else node, config, skip, fp32_keep)

    return _walk("", params)


def dequantize_params(params, dtype=torch.bfloat16):
    """The tree with every quantized leaf dequantized to ``dtype``."""
    if isinstance(params, dict):
        return {k: dequantize_params(v, dtype) for k, v in params.items()}
    return dequantize_tensor(params, dtype) if is_quantized(params) else params


def quantized_nbytes(params) -> int:
    """Bytes at rest of a mixed tree (codes and scales of the quantized
    leaves, the others' own)."""
    if isinstance(params, dict):
        return sum(quantized_nbytes(v) for v in params.values())
    if is_quantized(params):
        return params.nbytes_packed
    if torch.is_tensor(params):
        return params.numel() * params.element_size()
    return int(getattr(params, "nbytes", 0))


class _Dequantize(nn.Module):
    """Parametrization of one quantized weight: its codes (the
    parametrization's original) to the compute dtype, then to the port's
    layout (contiguous). A layer of a stacked leaf keeps only its own rows of codes and
    scales where they lie apart (int8; NF4 when its groups do not cross
    layers), else the whole leaf and its index."""

    def __init__(self, qt: QuantizedTensor, index: Optional[int], from_flax, dtype):
        super().__init__()
        self.bits, self.group_size, self.dtype, self.from_flax = qt.bits, qt.group_size, \
            dtype, from_flax
        self.row = None
        scales, self.shape = qt.scales, qt.shape
        rows = int(np.prod(qt.shape[1:-1])) if index is not None else 0
        if index is not None and qt.bits == 8:
            scales, self.shape = qt.scales[0], qt.shape[1:]
        elif index is not None and rows % qt.group_size == 0:
            g = rows // qt.group_size
            scales, self.shape = qt.scales[index * g:(index + 1) * g], qt.shape[1:]
        elif index is not None:
            self.row = index
        self.register_buffer("scales", scales, persistent=False)

    def codes(self, qt: QuantizedTensor, index: Optional[int]) -> torch.Tensor:
        if index is None or self.row is not None:
            return qt.data
        if self.bits == 8:
            return qt.data[index]
        half = int(np.prod(self.shape[:-1])) // 2
        return qt.data[index * half:(index + 1) * half]

    def forward(self, data):
        w = dequantize_tensor(QuantizedTensor(data, self.scales, self.shape, self.bits,
                                              self.group_size), self.dtype)
        if self.row is not None:
            w = w[self.row]
        # Contiguous in the port's layout, as the unquantized weight is, so
        # that the product runs the same kernel.
        return self.from_flax(w).contiguous()


class QuantizedModel(Model):
    """A weight-only quantized copy of a model, for inference: ``params``
    is its flax-layout mixed tree (``quantized_nbytes(qm.params)``), the
    module's quantized weights dequantize where they are read."""

    def __init__(self, module, params, quantization_config):
        super().__init__(module)
        self.params = params
        self.quantization_config = quantization_config

    def __call__(self, *args, train: bool = False, **kwargs):
        if train:
            raise ValueError("Weight-only quantized models are inference-only.")
        with torch.no_grad():
            return super().__call__(*args, **kwargs)


def load_and_quantize_model(model, quantization_config: QuantizationConfig) -> QuantizedModel:
    """A quantized copy of ``model`` (a ``Model`` or a module) for
    inference: its flax tree quantized leaf by leaf (``quantize_params``'s
    rules; ``skip_modules`` defaults to ``["lm_head", "embed"]``, the head
    and the embeddings staying in full precision), and a copy of the module
    whose quantized weights are parametrized to dequantize to
    ``compute_dtype`` in their forward. The tree's names and layouts are
    those of ``models/convert.flax_leaf``."""
    from torch.nn.utils import parametrize

    from ..big_modeling import _skeleton
    from .modeling import _leaves
    from .other import unflatten_state_dict

    if quantization_config.skip_modules is None:
        quantization_config = dataclasses.replace(quantization_config,
                                                  skip_modules=["lm_head", "embed"])
    module = getattr(model, "module", model)
    skip = [re.compile(p) for p in quantization_config.skip_modules]
    fp32_keep = [re.compile(p) for p in (quantization_config.keep_in_fp32_modules or [])]
    members: dict[str, list] = {}
    for fqn, p, leaf in _leaves(module):
        members.setdefault(leaf.name, []).append((fqn, p, leaf))
    qmodule = _skeleton(module)
    flat = {}
    for name, group in members.items():
        group.sort(key=lambda m: m[2].index or 0)
        values = [leaf.to_flax(p.detach()) for _, p, leaf in group]
        value = values[0] if group[0][2].index is None else torch.stack(values)
        del values
        q = _quantize_leaf(name, value, quantization_config, skip, fp32_keep)
        flat[name] = q
        for fqn, p, leaf in group:
            owner, _, attr = fqn.rpartition(".")
            sub = qmodule.get_submodule(owner) if owner else qmodule
            if not is_quantized(q):
                kept = p.detach() if q is value else leaf.from_flax(
                    q if leaf.index is None else q[leaf.index])
                sub._parameters[attr] = nn.Parameter(kept, requires_grad=False)
                continue
            deq = _Dequantize(q, leaf.index, leaf.from_flax, quantization_config.compute_dtype)
            sub._parameters[attr] = nn.Parameter(deq.codes(q, leaf.index), requires_grad=False)
            parametrize.register_parametrization(sub, attr, deq, unsafe=True)
    return QuantizedModel(qmodule, unflatten_state_dict(flat), quantization_config)
