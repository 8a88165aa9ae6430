"""Carry Llama weights from the flax tree of the JAX package to a state dict.

The flax tree (``params`` of ``accelerate_tpu.models.LlamaForCausalLM``) holds
either one ``nn.scan`` stack, ``model/layers/block/...`` with a leading layer
axis, or unrolled ``model/layers_{i}/...`` (``scan_layers=False``). Kernels
are stored input-major: ``DenseGeneral`` q/k/v kernels are
``(H, heads, D)``, ``o_proj`` is ``(heads, D, H)``, ``Dense`` kernels are
``(in, out)``; a ``torch.nn.Linear`` weight is ``(out, in)``.
"""

from __future__ import annotations

import numpy as np
import torch

from .llama import LlamaConfig


def _linear(kernel) -> np.ndarray:
    """A flax kernel (in..., out...) of a projection with one input axis
    (q/k/v, gate/up/down, lm_head) as a Linear weight (out, in)."""
    kernel = np.asarray(kernel)
    return kernel.reshape(kernel.shape[0], -1).T


def _block(blk: dict) -> dict:
    attn, mlp = blk["self_attn"], blk["mlp"]
    o = np.asarray(attn["o_proj"]["kernel"])  # (heads, D, H)
    return {
        "input_layernorm.weight": np.asarray(blk["input_layernorm"]["weight"]),
        "post_attention_layernorm.weight": np.asarray(blk["post_attention_layernorm"]["weight"]),
        "self_attn.q_proj.weight": _linear(attn["q_proj"]["kernel"]),
        "self_attn.k_proj.weight": _linear(attn["k_proj"]["kernel"]),
        "self_attn.v_proj.weight": _linear(attn["v_proj"]["kernel"]),
        "self_attn.o_proj.weight": o.reshape(-1, o.shape[-1]).T,
        "mlp.gate_proj.weight": _linear(mlp["gate_proj"]["kernel"]),
        "mlp.up_proj.weight": _linear(mlp["up_proj"]["kernel"]),
        "mlp.down_proj.weight": _linear(mlp["down_proj"]["kernel"]),
    }


def _layer_trees(model: dict, n_layers: int) -> list[dict]:
    if "layers" in model:  # nn.scan: every leaf has a leading layer axis
        stacked = model["layers"]["block"]

        def take(tree, i):
            if isinstance(tree, dict) or hasattr(tree, "items"):
                return {k: take(v, i) for k, v in tree.items()}
            return np.asarray(tree)[i]

        return [take(stacked, i) for i in range(n_layers)]
    return [model[f"layers_{i}"] for i in range(n_layers)]


def llama_params_from_flax(cfg: LlamaConfig, flax_params) -> dict[str, torch.Tensor]:
    """State dict of ``LlamaForCausalLM(cfg)`` from the flax params tree
    (numpy or array leaves), fp32."""
    if "params" in flax_params and "model" not in flax_params:
        flax_params = flax_params["params"]
    model = flax_params["model"]
    flat = {
        "model.embed_tokens.weight": np.asarray(model["embed_tokens"]["embedding"]),
        "model.norm.weight": np.asarray(model["norm"]["weight"]),
    }
    for i, blk in enumerate(_layer_trees(model, cfg.num_hidden_layers)):
        for name, value in _block(blk).items():
            flat[f"model.layers.{i}.{name}"] = value
    if not cfg.tie_word_embeddings:
        flat["lm_head.weight"] = _linear(flax_params["lm_head"]["kernel"])
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in flat.items()}
