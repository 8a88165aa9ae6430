"""Carry Llama and Mixtral weights between the flax tree of the JAX package
and a state dict of the port, both ways.

The flax tree (``params`` of ``accelerate_tpu.models.LlamaForCausalLM``) holds
either one ``nn.scan`` stack, ``model/layers/block/...`` with a leading layer
axis, or unrolled ``model/layers_{i}/...`` (``scan_layers=False``). Kernels
are stored input-major: ``DenseGeneral`` q/k/v kernels are
``(H, heads, D)``, ``o_proj`` is ``(heads, D, H)``, ``Dense`` kernels are
``(in, out)``; a ``torch.nn.Linear`` weight is ``(out, in)``. The chassis
knobs add leaves: q/k/v biases ``(heads, D)`` (a ``(heads * D,)`` bias
here), the ``o_proj`` bias ``(H,)``, MLP biases, a LayerNorm's ``bias``
beside its ``weight``, and no ``gate_proj`` for an ungated MLP.

A Mixtral config (one with ``num_local_experts``) maps the same way: Llama's
attention and norms, and a ``moe`` subtree in place of ``mlp``: ``router``
``(d, E)`` and the stacked ``w_gate``/``w_up`` ``(E, d, f)`` and ``w_down``
``(E, f, d)``, which the port holds in the same layouts.

The same maps carry any tree shaped like the parameters, such as AdamW's
moments (optax's ``mu``/``nu``). Both directions work on torch tensors on
any device, so a checkpoint changes layouts on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from .llama import LlamaConfig

_NORMS = ("input_layernorm", "post_attention_layernorm")
_ATTN_IN = ("q_proj", "k_proj", "v_proj")


def _norm_leaves(cfg: LlamaConfig) -> tuple[str, ...]:
    return ("weight", "bias") if cfg.norm_type == "layernorm" else ("weight",)


def _mlp_names(cfg: LlamaConfig) -> tuple[str, ...]:
    return ("gate_proj", "up_proj", "down_proj") if cfg.mlp_gated else ("up_proj", "down_proj")


def _as_tensor(x) -> torch.Tensor:
    if torch.is_tensor(x):
        return x
    a = np.array(x)
    try:
        return torch.from_numpy(a)
    except TypeError:  # a numpy dtype torch lacks, such as ml_dtypes' bfloat16
        return torch.from_numpy(a.astype(np.float32))


def _map_tree(fn, tree):
    """``fn`` on every leaf of nested dicts (flax ``FrozenDict`` included)."""
    if isinstance(tree, dict) or hasattr(tree, "items"):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    return fn(tree)


def _linear(kernel: torch.Tensor) -> torch.Tensor:
    """A flax kernel (in, out...) of a projection with one input axis as a
    Linear weight (out, in): a view."""
    return kernel.reshape(kernel.shape[0], -1).t()


_MOE_LEAVES = ("router", "w_gate", "w_up", "w_down")


def _is_moe(cfg) -> bool:
    return hasattr(cfg, "num_local_experts")


def _block_from_flax(cfg: LlamaConfig, blk: dict) -> dict:
    out = {f"{n}.{leaf}": _as_tensor(blk[n][leaf]) for n in _NORMS for leaf in _norm_leaves(cfg)}
    if _is_moe(cfg):
        out.update({f"moe.{leaf}": _as_tensor(blk["moe"][leaf]) for leaf in _MOE_LEAVES})
    attn = blk["self_attn"]
    for name in _ATTN_IN:
        out[f"self_attn.{name}.weight"] = _linear(_as_tensor(attn[name]["kernel"]))
        if cfg.attention_bias:  # (heads, D)
            out[f"self_attn.{name}.bias"] = _as_tensor(attn[name]["bias"]).reshape(-1)
    kernel = _as_tensor(attn["o_proj"]["kernel"])  # (heads, D, H)
    out["self_attn.o_proj.weight"] = kernel.reshape(-1, kernel.shape[-1]).t()
    if cfg.attention_out_bias:
        out["self_attn.o_proj.bias"] = _as_tensor(attn["o_proj"]["bias"])
    for name in () if _is_moe(cfg) else _mlp_names(cfg):
        out[f"mlp.{name}.weight"] = _linear(_as_tensor(blk["mlp"][name]["kernel"]))
        if cfg.mlp_bias:
            out[f"mlp.{name}.bias"] = _as_tensor(blk["mlp"][name]["bias"])
    return out


def _layer_trees(model: dict, n_layers: int) -> list[dict]:
    if "layers" in model:  # nn.scan: every leaf has a leading layer axis
        stacked = _map_tree(_as_tensor, model["layers"]["block"])
        return [_map_tree(lambda t: t[i], stacked) for i in range(n_layers)]
    return [model[f"layers_{i}"] for i in range(n_layers)]


def llama_views_from_flax(cfg: LlamaConfig, flax_params) -> dict[str, torch.Tensor]:
    """``LlamaForCausalLM(cfg)`` names → tensors in its layouts, as views of
    the flax tree's tensors where the layout allows (no copy, any dtype and
    device). Either flax layout is read."""
    if "params" in flax_params and "model" not in flax_params:
        flax_params = flax_params["params"]
    model = flax_params["model"]
    flat = {"model.embed_tokens.weight": _as_tensor(model["embed_tokens"]["embedding"])}
    for leaf in _norm_leaves(cfg):
        flat[f"model.norm.{leaf}"] = _as_tensor(model["norm"][leaf])
    for i, blk in enumerate(_layer_trees(model, cfg.num_hidden_layers)):
        for name, value in _block_from_flax(cfg, blk).items():
            flat[f"model.layers.{i}.{name}"] = value
    if not cfg.tie_word_embeddings:
        flat["lm_head.weight"] = _linear(_as_tensor(flax_params["lm_head"]["kernel"]))
    return flat


def llama_params_from_flax(cfg: LlamaConfig, flax_params) -> dict[str, torch.Tensor]:
    """State dict of ``LlamaForCausalLM(cfg)`` from the flax params tree
    (numpy, array or tensor leaves): contiguous fp32 tensors."""
    return {k: v.float().contiguous() for k, v in llama_views_from_flax(cfg, flax_params).items()}


def _block_to_flax(get, cfg: LlamaConfig, prefix: str) -> dict:
    heads, kv, d, h = (cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim,
                       cfg.hidden_size)
    n_heads = {"q_proj": heads, "k_proj": kv, "v_proj": kv}
    attn = {}
    for name, n in n_heads.items():
        attn[name] = {"kernel": get(f"{prefix}self_attn.{name}.weight").t().reshape(h, n, d)}
        if cfg.attention_bias:
            attn[name]["bias"] = get(f"{prefix}self_attn.{name}.bias").reshape(n, d)
    attn["o_proj"] = {"kernel": get(f"{prefix}self_attn.o_proj.weight").t().reshape(heads, d, h)}
    if cfg.attention_out_bias:
        attn["o_proj"]["bias"] = get(f"{prefix}self_attn.o_proj.bias")
    norms = {n: {leaf: get(f"{prefix}{n}.{leaf}") for leaf in _norm_leaves(cfg)} for n in _NORMS}
    if _is_moe(cfg):
        return {**norms, "self_attn": attn,
                "moe": {leaf: get(f"{prefix}moe.{leaf}") for leaf in _MOE_LEAVES}}
    mlp = {}
    for name in _mlp_names(cfg):
        mlp[name] = {"kernel": get(f"{prefix}mlp.{name}.weight").t()}
        if cfg.mlp_bias:
            mlp[name]["bias"] = get(f"{prefix}mlp.{name}.bias")
    return {**norms, "self_attn": attn, "mlp": mlp}


def llama_params_to_flax(cfg: LlamaConfig, state_dict: dict) -> dict:
    """The flax params tree of ``cfg`` from a state dict (or any tree of
    tensors with its names, such as AdamW's moments), the inverse of
    ``llama_params_from_flax``: kernels input-major, q/k/v as
    ``(H, heads, D)`` (their biases ``(heads, D)``), ``o_proj`` as
    ``(heads, D, H)``, and the layers as one
    ``model/layers/block`` stack with a leading layer axis when
    ``cfg.scan_layers``, else as ``model/layers_{i}``. Leaves are contiguous
    tensors on the state dict's device, in its dtype."""
    get = state_dict.__getitem__
    layers = [_block_to_flax(get, cfg, f"model.layers.{i}.")
              for i in range(cfg.num_hidden_layers)]
    model = {"embed_tokens": {"embedding": get("model.embed_tokens.weight")},
             "norm": {leaf: get(f"model.norm.{leaf}") for leaf in _norm_leaves(cfg)}}
    if cfg.scan_layers:
        model["layers"] = {"block": _zip_trees(lambda *leaves: torch.stack(leaves), layers)}
    else:
        model.update({f"layers_{i}": layer for i, layer in enumerate(layers)})
    tree = {"model": model}
    if not cfg.tie_word_embeddings:
        tree["lm_head"] = {"kernel": get("lm_head.weight").t()}
    return _map_tree(lambda t: t.contiguous(), tree)


def _zip_trees(fn, trees: list[dict]) -> dict:
    first = trees[0]
    if isinstance(first, dict):
        return {k: _zip_trees(fn, [t[k] for t in trees]) for k in first}
    return fn(*trees)
