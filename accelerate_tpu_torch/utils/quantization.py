"""int8 weight-only decode (counterpart of the ``DecodeQuant`` half of
``accelerate_tpu/utils/quantization.py``).

``quantize_model_for_decode(model)`` gives an inference-only copy of a Llama
model whose block projections are int8 codes with one fp32 scale per output
channel (symmetric, reduced over the matmul's contraction dims). The cached
forward (``generation._kernel``) dequantizes each one next to its matmul;
embeddings, the LM head (a tied one is the embedding), the norms and the
biases stay full precision, as in the JAX package. Every config of the
Llama chassis takes it (an ungated MLP has no ``gate_proj`` to quantize).

The port's projections are 2-D ``(out, in)`` weights, so the contraction dim
is dim 1 for every projection. That is the logical reduction the JAX package
makes over its flax layouts (the hidden dim of the q/k/v and MLP kernels,
``(heads, D)`` of the 4-D ``o_proj`` kernel), and the codes and scales equal
JAX's after ``models/convert.py``'s reshape.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

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
