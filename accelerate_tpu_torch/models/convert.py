"""Carry weights between the flax trees of the JAX package and state dicts
of the port, both ways, for every ported family; and the registry that
``checkpointing.py`` looks a module's converter up in.

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

GPT-2, OPT, GPT-NeoX, T5, Whisper, BERT, ViT and CLIP are described as
data (``_Leaf`` tables below): each parameter's port name, its flax path and the two
layout maps between them. Linear weights ``(out, in)`` become kernels
``(in, *out_axes)`` (``DenseGeneral``'s per-head outputs: GPT-2's
``c_attn`` ``(H, 3, heads, D)``, NeoX's ``query_key_value``
``(H, heads, 3, D)``, q/k/v ``(H, heads, D)``) or ``(*in_axes, out)``
(output projections ``(heads, D, H)``); biases take the output axes'
shape; flax's LayerNorm ``scale`` is the port's ``weight``; Whisper's
convolutions are ``(k, in, out)`` kernels, ViT's and CLIP's patch
convolutions ``(kh, kw, in, out)``. A family's layers form one
``nn.scan`` stack with a leading layer axis (``scan_layers=True``) or
unrolled subtrees, and T5 keeps ``block_0`` (the relative-bias owner)
apart and scans the rest. CLIP has a stack per tower, each with its own
head count.

ResNet's names are the flax tree's already (``stage0_block0.conv1.weight``
↔ ``stage0_block0/conv1/kernel``, BatchNorm's ``scale`` and ``bias``):
only the convolutions' ``(out, in, kh, kw)`` ↔ ``(kh, kw, in, out)`` and
the classifier's transpose change (``resnet_params_to_flax``). Its running
statistics are no parameters: they travel as ``extra_state``
(``checkpointing.py``).

The same maps carry any tree shaped like the parameters, such as AdamW's
moments (optax's ``mu``/``nu``). Both directions work on torch tensors on
any device, so a checkpoint changes layouts on the card.

``FLAX_CONVERTERS`` maps a module class to its ``FlaxConverter``
(``to_flax``, ``views_from_flax``, ``flax_name``); ``flax_converter``
looks a module up, and a class without an entry keeps its own names.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Callable, Optional

import numpy as np
import torch

from ..utils.other import flatten_state_dict
from .bert import BertForMaskedLM, BertForSequenceClassification
from .clip import CLIPModel
from .gpt2 import GPT2LMHeadModel
from .llama import LlamaConfig, LlamaForCausalLM
from .moe import MixtralForCausalLM
from .neox import GPTNeoXForCausalLM
from .opt import OPTForCausalLM
from .resnet import ResNet
from .t5 import T5ForConditionalGeneration
from .vit import ViTForImageClassification
from .whisper import WhisperForConditionalGeneration

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


def llama_flax_name(cfg, fqn: str) -> str:
    """The ``/``-joined name of a Llama or Mixtral parameter in the unrolled
    flax tree: ``layers_<i>``, ``kernel`` for a projection's weight (its
    bias keeps ``bias``), ``embedding``."""
    owner, _, leaf = fqn.rpartition(".")
    if owner.endswith("embed_tokens"):
        leaf = "embedding"
    elif (owner.endswith("_proj") or owner == "lm_head") and leaf == "weight":
        leaf = "kernel"
    owner = re.sub(r"(^|\.)layers\.(\d+)(?=\.|$)", r"\1layers_\2", owner)
    return f"{owner.replace('.', '/')}/{leaf}"


# ---------------------------------------------------------------------------
# GPT-2, OPT, GPT-NeoX, T5, Whisper: leaf tables
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class _Leaf:
    """One parameter: its port name, its flax path, and the maps from the
    port's layout to flax's and back."""

    port: str
    flax: str
    to_flax: Callable = lambda t: t
    from_flax: Callable = lambda t: t


def _linear_leaf(port: str, flax: str, *out_axes) -> _Leaf:
    """A Linear ``(out, in)`` as a kernel ``(in, *out_axes)`` (Dense: no
    axes given)."""
    return _Leaf(port, flax,
                 lambda w: w.t().reshape(w.shape[1], *(out_axes or (w.shape[0],))),
                 lambda k: k.reshape(k.shape[0], -1).t())


def _out_leaf(port: str, flax: str, *in_axes) -> _Leaf:
    """An output projection ``(out, in)`` as a kernel ``(*in_axes, out)``."""
    return _Leaf(port, flax, lambda w: w.t().reshape(*in_axes, w.shape[0]),
                 lambda k: k.reshape(-1, k.shape[-1]).t())


def _bias_leaf(port: str, flax: str, *axes) -> _Leaf:
    return _Leaf(port, flax, lambda b: b.reshape(axes), lambda b: b.reshape(-1))


def _ln_leaves(port: str, flax: str) -> list[_Leaf]:
    """flax's LayerNorm: ``scale`` is the port's ``weight``."""
    return [_Leaf(f"{port}.weight", f"{flax}/scale"), _Leaf(f"{port}.bias", f"{flax}/bias")]


def _dense_leaves(name: str, bias: bool = True) -> list[_Leaf]:
    out = [_linear_leaf(f"{name}.weight", f"{name}/kernel")]
    return out + ([_Leaf(f"{name}.bias", f"{name}/bias")] if bias else [])


@dataclasses.dataclass(frozen=True)
class _Stack:
    """A list of identical layers: ``port`` (``{i}`` the layer), the scanned
    flax path, the unrolled one (``{i}``), the layer's leaves, and
    ``first_apart`` leaves that only layer 0 holds, which then sits apart
    at ``unrolled.format(i=0)`` and the scan covers layers 1..n-1 (T5)."""

    port: str
    scanned: str
    unrolled: str
    n: int
    leaves: list
    first_apart: list = dataclasses.field(default_factory=list)


def _gpt2_tables(cfg):
    nh, d = cfg.n_head, cfg.head_dim
    top = [_Leaf("transformer.wte.weight", "transformer/wte/embedding"),
           _Leaf("transformer.wpe.weight", "transformer/wpe/embedding"),
           *_ln_leaves("transformer.ln_f", "transformer/ln_f")]
    layer = [*_ln_leaves("ln_1", "ln_1"), *_ln_leaves("ln_2", "ln_2"),
             _linear_leaf("attn.c_attn.weight", "attn/c_attn/kernel", 3, nh, d),
             _bias_leaf("attn.c_attn.bias", "attn/c_attn/bias", 3, nh, d),
             _out_leaf("attn.c_proj.weight", "attn/c_proj/kernel", nh, d),
             _Leaf("attn.c_proj.bias", "attn/c_proj/bias"),
             *_dense_leaves("c_fc"), *_dense_leaves("c_proj")]
    return top, [_Stack("transformer.h.{i}.", "transformer/h/block", "transformer/h_{i}",
                        cfg.n_layer, layer)]


def _opt_tables(cfg):
    nh, d = cfg.num_attention_heads, cfg.head_dim
    top = [_Leaf("model.embed_tokens.weight", "model/embed_tokens/embedding"),
           _Leaf("model.embed_positions.weight", "model/embed_positions/embedding"),
           *_ln_leaves("model.final_layer_norm", "model/final_layer_norm")]
    layer = [*_ln_leaves("self_attn_layer_norm", "self_attn_layer_norm"),
             *_ln_leaves("final_layer_norm", "final_layer_norm"),
             _out_leaf("self_attn.out_proj.weight", "self_attn/out_proj/kernel", nh, d),
             _Leaf("self_attn.out_proj.bias", "self_attn/out_proj/bias"),
             *_dense_leaves("fc1"), *_dense_leaves("fc2")]
    for name in ("q_proj", "k_proj", "v_proj"):
        layer += [_linear_leaf(f"self_attn.{name}.weight", f"self_attn/{name}/kernel", nh, d),
                  _bias_leaf(f"self_attn.{name}.bias", f"self_attn/{name}/bias", nh, d)]
    return top, [_Stack("model.layers.{i}.", "model/layers/block", "model/layer_{i}",
                        cfg.num_hidden_layers, layer)]


def _neox_tables(cfg):
    nh, d = cfg.num_attention_heads, cfg.head_dim
    top = [_Leaf("gpt_neox.embed_in.weight", "gpt_neox/embed_in/embedding"),
           *_ln_leaves("gpt_neox.final_layer_norm", "gpt_neox/final_layer_norm"),
           _linear_leaf("embed_out.weight", "embed_out/kernel")]
    layer = [*_ln_leaves("input_layernorm", "input_layernorm"),
             *_ln_leaves("post_attention_layernorm", "post_attention_layernorm"),
             _linear_leaf("attention.query_key_value.weight", "attention/query_key_value/kernel",
                          nh, 3, d),
             _bias_leaf("attention.query_key_value.bias", "attention/query_key_value/bias",
                        nh, 3, d),
             _out_leaf("attention.dense.weight", "attention/dense/kernel", nh, d),
             _Leaf("attention.dense.bias", "attention/dense/bias"),
             *_dense_leaves("dense_h_to_4h"), *_dense_leaves("dense_4h_to_h")]
    return top, [_Stack("gpt_neox.layers.{i}.", "gpt_neox/layers/block", "gpt_neox/layer_{i}",
                        cfg.num_hidden_layers, layer)]


def _t5_attn(name: str, nh: int, dk: int) -> list[_Leaf]:
    return [*(_linear_leaf(f"{name}.{p}.weight", f"{name}/{p}/kernel", nh, dk) for p in "qkv"),
            _out_leaf(f"{name}.o.weight", f"{name}/o/kernel", nh, dk)]


def _t5_tables(cfg):
    nh, dk = cfg.num_heads, cfg.d_kv
    top = [_Leaf("shared.weight", "shared/embedding"),
           _Leaf("encoder.final_ln.weight", "encoder/final_ln/weight"),
           _Leaf("decoder.final_ln.weight", "decoder/final_ln/weight")]
    ffn = [_linear_leaf("ffn.wi.weight", "ffn/wi/kernel"),
           _linear_leaf("ffn.wo.weight", "ffn/wo/kernel")]
    enc = [*_t5_attn("self_attn", nh, dk), _Leaf("ln0.weight", "ln0/weight"),
           _Leaf("ln1.weight", "ln1/weight"), *ffn]
    dec = [*enc, *_t5_attn("cross_attn", nh, dk), _Leaf("ln2.weight", "ln2/weight")]
    bias = [_Leaf("self_attn.relative_attention_bias.weight",
                  "self_attn/relative_attention_bias/embedding")]
    return top, [_Stack(f"{s}.block_{{i}}.", f"{s}/layers/block", f"{s}/block_{{i}}", n, leaves,
                        bias)
                 for s, n, leaves in (("encoder", cfg.num_layers, enc),
                                      ("decoder", cfg.n_dec, dec))]


def _whisper_attn(name: str, nh: int, d: int) -> list[_Leaf]:
    out = [_out_leaf(f"{name}.out_proj.weight", f"{name}/out_proj/kernel", nh, d),
           _Leaf(f"{name}.out_proj.bias", f"{name}/out_proj/bias")]
    for p in ("q_proj", "k_proj", "v_proj"):
        out.append(_linear_leaf(f"{name}.{p}.weight", f"{name}/{p}/kernel", nh, d))
        if p != "k_proj":  # Whisper: no K bias
            out.append(_bias_leaf(f"{name}.{p}.bias", f"{name}/{p}/bias", nh, d))
    return out


_CONV = dict(to_flax=lambda w: w.permute(2, 1, 0), from_flax=lambda k: k.permute(2, 1, 0))


def _whisper_tables(cfg):
    top = [_Leaf("encoder.conv1.weight", "encoder/conv1/kernel", **_CONV),
           _Leaf("encoder.conv1.bias", "encoder/conv1/bias"),
           _Leaf("encoder.conv2.weight", "encoder/conv2/kernel", **_CONV),
           _Leaf("encoder.conv2.bias", "encoder/conv2/bias"),
           _Leaf("encoder.embed_positions", "encoder/embed_positions"),
           *_ln_leaves("encoder.layer_norm", "encoder/layer_norm"),
           _Leaf("decoder.embed_tokens.weight", "decoder/embed_tokens/embedding"),
           _Leaf("decoder.embed_positions.weight", "decoder/embed_positions/embedding"),
           *_ln_leaves("decoder.layer_norm", "decoder/layer_norm")]
    mlp = [*_dense_leaves("fc1"), *_dense_leaves("fc2"),
           *_ln_leaves("final_layer_norm", "final_layer_norm"),
           *_ln_leaves("self_attn_layer_norm", "self_attn_layer_norm")]
    enc = [*_whisper_attn("self_attn", cfg.encoder_attention_heads, cfg.head_dim), *mlp]
    nh, d = cfg.decoder_attention_heads, cfg.decoder_head_dim
    dec = [*_whisper_attn("self_attn", nh, d), *_whisper_attn("encoder_attn", nh, d),
           *_ln_leaves("encoder_attn_layer_norm", "encoder_attn_layer_norm"), *mlp]
    return top, [_Stack(f"{s}.layers.{{i}}.", f"{s}/layers/block", f"{s}/layer_{{i}}", n, leaves)
                 for s, n, leaves in (("encoder", cfg.encoder_layers, enc),
                                      ("decoder", cfg.decoder_layers, dec))]


_KERNEL_2D = dict(to_flax=lambda w: w.permute(2, 3, 1, 0),
                  from_flax=lambda k: k.permute(3, 2, 0, 1))


def _encoder_attn(name: str, nh: int, d: int, parts=("query", "key", "value"),
                  out: str = "output") -> list[_Leaf]:
    """Self-attention of per-head ``DenseGeneral``s with biases: q, k, v
    kernels ``(H, heads, D)``, the output ``(heads, D, H)``."""
    leaves = [_out_leaf(f"{name}.{out}.weight", f"{name}/{out}/kernel", nh, d),
              _Leaf(f"{name}.{out}.bias", f"{name}/{out}/bias")]
    for p in parts:
        leaves += [_linear_leaf(f"{name}.{p}.weight", f"{name}/{p}/kernel", nh, d),
                   _bias_leaf(f"{name}.{p}.bias", f"{name}/{p}/bias", nh, d)]
    return leaves


def _bert_tables(cfg, head: str):
    nh, d = cfg.num_attention_heads, cfg.head_dim
    top = [_Leaf(f"bert.{n}.weight", f"bert/{n}/embedding")
           for n in ("word_embeddings", "position_embeddings", "token_type_embeddings")]
    top += _ln_leaves("bert.embeddings_norm", "bert/embeddings_norm")
    if head == "classifier":
        top += [_linear_leaf("bert.pooler.weight", "bert/pooler/kernel"),
                _Leaf("bert.pooler.bias", "bert/pooler/bias"), *_dense_leaves("classifier")]
    else:
        top += [*_dense_leaves("transform"), *_ln_leaves("transform_norm", "transform_norm"),
                _Leaf("decoder_bias", "decoder_bias")]
    layer = [*_encoder_attn("attention", nh, d),
             *_ln_leaves("attention_norm", "attention_norm"),
             *_dense_leaves("intermediate"), *_dense_leaves("output"),
             *_ln_leaves("output_norm", "output_norm")]
    return top, [_Stack("bert.layers.{i}.", "bert/layers/block", "bert/layer_{i}",
                        cfg.num_hidden_layers, layer)]


def _vit_tables(cfg):
    nh, d = cfg.num_attention_heads, cfg.head_dim
    top = [_Leaf("vit.patch_embed.weight", "vit/patch_embed/kernel", **_KERNEL_2D),
           _Leaf("vit.patch_embed.bias", "vit/patch_embed/bias"),
           _Leaf("vit.cls_token", "vit/cls_token"),
           _Leaf("vit.position_embeddings", "vit/position_embeddings"),
           *_ln_leaves("vit.ln_final", "vit/ln_final"), *_dense_leaves("classifier")]
    layer = [*_ln_leaves("ln_before", "ln_before"), *_encoder_attn("attention", nh, d),
             *_ln_leaves("ln_after", "ln_after"),
             *_dense_leaves("intermediate"), *_dense_leaves("output")]
    return top, [_Stack("vit.layers.{i}.", "vit/layers/block", "vit/layer_{i}",
                        cfg.num_hidden_layers, layer)]


def _clip_tables(cfg):
    top = [_Leaf("text.token_embedding", "text/token_embedding"),
           _Leaf("text.position_embedding", "text/position_embedding"),
           *_ln_leaves("text.final_ln", "text/final_ln"),
           _Leaf("vision.patch_embed.weight", "vision/patch_embed/kernel", **_KERNEL_2D),
           _Leaf("vision.class_embedding", "vision/class_embedding"),
           _Leaf("vision.position_embedding", "vision/position_embedding"),
           *_ln_leaves("vision.pre_ln", "vision/pre_ln"),
           *_ln_leaves("vision.post_ln", "vision/post_ln"),
           _linear_leaf("text_projection.weight", "text_projection/kernel"),
           _linear_leaf("visual_projection.weight", "visual_projection/kernel"),
           _Leaf("logit_scale", "logit_scale")]

    def layer(hidden, heads):
        return [*_ln_leaves("ln1", "ln1"), *_ln_leaves("ln2", "ln2"),
                *_encoder_attn("self_attn", heads, hidden // heads,
                               ("q_proj", "k_proj", "v_proj"), "out_proj"),
                *_dense_leaves("fc1"), *_dense_leaves("fc2")]

    return top, [_Stack(f"{t}.layers.{{i}}.", f"{t}/layers/block", f"{t}/layer_{{i}}", n,
                        layer(h, nh))
                 for t, n, h, nh in (("text", cfg.text_num_layers, cfg.text_hidden_size,
                                      cfg.text_num_heads),
                                     ("vision", cfg.vision_num_layers, cfg.vision_hidden_size,
                                      cfg.vision_num_heads))]


def _set(tree: dict, path: str, value) -> None:
    *parents, leaf = path.split("/")
    for p in parents:
        tree = tree.setdefault(p, {})
    tree[leaf] = value


def _get(tree, path: str):
    for p in path.split("/"):
        tree = tree[p]
    return tree


def _tables_to_flax(tables, cfg, state_dict: dict) -> dict:
    """The flax tree of a state dict (or a tree of tensors with its names)
    by a family's tables: contiguous tensors on its device, in its dtype."""
    top, stacks = tables(cfg)
    get = state_dict.__getitem__
    tree: dict = {}
    for leaf in top:
        _set(tree, leaf.flax, leaf.to_flax(get(leaf.port)))
    for st in stacks:
        start = 1 if st.first_apart else 0
        if st.first_apart:
            for leaf in st.leaves + st.first_apart:
                _set(tree, f"{st.unrolled.format(i=0)}/{leaf.flax}",
                     leaf.to_flax(get(st.port.format(i=0) + leaf.port)))
        for leaf in st.leaves:
            per_layer = [leaf.to_flax(get(st.port.format(i=i) + leaf.port))
                         for i in range(start, st.n)]
            if not per_layer:
                continue
            if cfg.scan_layers:
                _set(tree, f"{st.scanned}/{leaf.flax}", torch.stack(per_layer))
            else:
                for i, t in enumerate(per_layer, start):
                    _set(tree, f"{st.unrolled.format(i=i)}/{leaf.flax}", t)
    return _map_tree(lambda t: t.contiguous(), tree)


def _tables_from_flax(tables, cfg, flax_params) -> dict[str, torch.Tensor]:
    """Port names → tensors in the port's layouts (views where the layout
    allows) from a flax tree in either layer layout."""
    if set(flax_params) == {"params"}:
        flax_params = flax_params["params"]
    top, stacks = tables(cfg)
    flat = {leaf.port: leaf.from_flax(_as_tensor(_get(flax_params, leaf.flax))) for leaf in top}
    for st in stacks:
        start = 1 if st.first_apart else 0
        if st.first_apart:
            for leaf in st.leaves + st.first_apart:
                flat[st.port.format(i=0) + leaf.port] = leaf.from_flax(_as_tensor(
                    _get(flax_params, f"{st.unrolled.format(i=0)}/{leaf.flax}")))
        scanned = st.n > start and _has(flax_params, st.scanned)
        for leaf in st.leaves:
            if scanned:
                stacked = _as_tensor(_get(flax_params, f"{st.scanned}/{leaf.flax}"))
            for i in range(start, st.n):
                t = (stacked[i - start] if scanned else _as_tensor(
                    _get(flax_params, f"{st.unrolled.format(i=i)}/{leaf.flax}")))
                flat[st.port.format(i=i) + leaf.port] = leaf.from_flax(t)
    return flat


def _has(tree, path: str) -> bool:
    try:
        _get(tree, path)
        return True
    except (KeyError, TypeError):
        return False


def _tables_flax_name(tables, cfg, fqn: str) -> str:
    """A parameter's ``/``-joined name in the unrolled flax tree."""
    top, stacks = tables(cfg)
    for leaf in top:
        if leaf.port == fqn:
            return leaf.flax
    for st in stacks:
        head, _, tail = st.port.partition("{i}")
        m = re.fullmatch(re.escape(head) + r"(\d+)" + re.escape(tail) + r"(.+)", fqn)
        if m:
            return f"{st.unrolled.format(i=int(m.group(1)))}/" + next(
                leaf.flax for leaf in st.leaves + st.first_apart if leaf.port == m.group(2))
    raise KeyError(fqn)


def _family(tables):
    """(to_flax, views_from_flax, params_from_flax, flax_name) of a
    family's tables."""
    def to_flax(cfg, state_dict: dict) -> dict:
        return _tables_to_flax(tables, cfg, state_dict)

    def views_from_flax(cfg, flax_params) -> dict[str, torch.Tensor]:
        return _tables_from_flax(tables, cfg, flax_params)

    def params_from_flax(cfg, flax_params) -> dict[str, torch.Tensor]:
        return {k: v.float().contiguous()
                for k, v in _tables_from_flax(tables, cfg, flax_params).items()}

    def flax_name(cfg, fqn: str) -> str:
        return _tables_flax_name(tables, cfg, fqn)

    return to_flax, views_from_flax, params_from_flax, flax_name


# ``*_params_to_flax(cfg, state_dict)``: the flax tree (the layers stacked
# when ``cfg.scan_layers``); ``*_params_from_flax(cfg, tree)``: the state
# dict (contiguous fp32), from either layout; ``*_views_from_flax``: the
# same as views where the layout allows.
(gpt2_params_to_flax, gpt2_views_from_flax, gpt2_params_from_flax,
 _gpt2_flax_name) = _family(_gpt2_tables)
opt_params_to_flax, opt_views_from_flax, opt_params_from_flax, _opt_flax_name = \
    _family(_opt_tables)
(neox_params_to_flax, neox_views_from_flax, neox_params_from_flax,
 _neox_flax_name) = _family(_neox_tables)
t5_params_to_flax, t5_views_from_flax, t5_params_from_flax, _t5_flax_name = \
    _family(_t5_tables)
(whisper_params_to_flax, whisper_views_from_flax, whisper_params_from_flax,
 _whisper_flax_name) = _family(_whisper_tables)
(bert_params_to_flax, bert_views_from_flax, bert_params_from_flax,
 _bert_flax_name) = _family(lambda cfg: _bert_tables(cfg, "classifier"))
(bert_mlm_params_to_flax, bert_mlm_views_from_flax, bert_mlm_params_from_flax,
 _bert_mlm_flax_name) = _family(lambda cfg: _bert_tables(cfg, "mlm"))
vit_params_to_flax, vit_views_from_flax, vit_params_from_flax, _vit_flax_name = \
    _family(_vit_tables)
clip_params_to_flax, clip_views_from_flax, clip_params_from_flax, _clip_flax_name = \
    _family(_clip_tables)


# ResNet: the flax names, kernels in flax's layouts.

def _resnet_flax_leaf(fqn: str, t: torch.Tensor) -> tuple[str, torch.Tensor]:
    owner, _, leaf = fqn.rpartition(".")
    if leaf != "weight":  # BatchNorm's scale and bias, the classifier's bias
        return fqn.replace(".", "/"), t
    kernel = t.permute(2, 3, 1, 0) if t.dim() == 4 else t.t()
    return f"{owner.replace('.', '/')}/kernel", kernel


def resnet_params_to_flax(cfg, state_dict: dict) -> dict:
    """The flax ``params`` tree of a ``ResNet(cfg)`` state dict (its
    parameters; the running statistics are ``extra_state``)."""
    tree: dict = {}
    for fqn, t in state_dict.items():
        if fqn.rpartition(".")[2] in ("mean", "var"):
            continue
        path, value = _resnet_flax_leaf(fqn, t)
        _set(tree, path, value.contiguous())
    return tree


def resnet_views_from_flax(cfg, flax_params) -> dict[str, torch.Tensor]:
    """``ResNet(cfg)`` parameter names → tensors in its layouts (views)."""
    if set(flax_params) == {"params"}:
        flax_params = flax_params["params"]
    out = {}
    for path, value in flatten_state_dict(flax_params).items():
        t = _as_tensor(value)
        owner, _, leaf = path.rpartition("/")
        if leaf == "kernel":
            out[f"{owner.replace('/', '.')}.weight"] = (t.permute(3, 2, 0, 1) if t.dim() == 4
                                                        else t.t())
        else:
            out[path.replace("/", ".")] = t
    return out


def resnet_params_from_flax(cfg, flax_params) -> dict[str, torch.Tensor]:
    return {k: v.float().contiguous() for k, v in resnet_views_from_flax(cfg, flax_params).items()}


def _resnet_flax_name(cfg, fqn: str) -> str:
    return _resnet_flax_leaf(fqn, torch.empty(0, 0))[0]


# Each table-described family's module class and its tables.
_TABLES = {GPT2LMHeadModel: _gpt2_tables, OPTForCausalLM: _opt_tables,
           GPTNeoXForCausalLM: _neox_tables, T5ForConditionalGeneration: _t5_tables,
           WhisperForConditionalGeneration: _whisper_tables,
           BertForSequenceClassification: lambda cfg: _bert_tables(cfg, "classifier"),
           BertForMaskedLM: lambda cfg: _bert_tables(cfg, "mlm"),
           ViTForImageClassification: _vit_tables, CLIPModel: _clip_tables}



# ---------------------------------------------------------------------------
# One parameter at a time
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FlaxLeaf:
    """Where one parameter of the port lives in the JAX package's tree of
    the same config: ``name`` (``/``-joined) in the config's own layout,
    ``index`` its row of a stacked ``nn.scan`` leaf (None when the leaf is
    the parameter's alone), and the maps of one layer's value from flax's
    layout to the port's and back (views where the layout allows)."""

    name: str
    index: Optional[int]
    from_flax: Callable
    to_flax: Callable


def _identity(t):
    return t


def _llama_leaf(cfg, fqn: str) -> FlaxLeaf:
    """A Llama or Mixtral parameter's leaf (``llama_flax_name``'s names)."""
    unrolled = llama_flax_name(cfg, fqn)
    owner, _, leaf = fqn.rpartition(".")
    heads = {"q_proj": cfg.num_attention_heads, "k_proj": cfg.num_key_value_heads,
             "v_proj": cfg.num_key_value_heads}
    proj = owner.rpartition(".")[2]
    h, d = cfg.hidden_size, cfg.head_dim
    from_flax, to_flax = _identity, _identity
    if proj in heads and leaf == "weight":
        from_flax, to_flax = _linear, (lambda w, n=heads[proj]: w.t().reshape(h, n, d))
    elif proj in heads:  # (heads, D) bias
        from_flax, to_flax = (lambda b: b.reshape(-1)), (lambda b, n=heads[proj]: b.reshape(n, d))
    elif proj == "o_proj" and leaf == "weight":
        from_flax = lambda k: k.reshape(-1, k.shape[-1]).t()  # noqa: E731
        to_flax = lambda w: w.t().reshape(cfg.num_attention_heads, d, h)  # noqa: E731
    elif leaf == "weight" and (proj.endswith("_proj") or proj == "lm_head"):
        from_flax, to_flax = _linear, (lambda w: w.t())
    m = re.fullmatch(r"model/layers_(\d+)/(.+)", unrolled)
    if m and cfg.scan_layers:
        return FlaxLeaf(f"model/layers/block/{m.group(2)}", int(m.group(1)), from_flax, to_flax)
    return FlaxLeaf(unrolled, None, from_flax, to_flax)


def _tables_leaf(tables, cfg, fqn: str) -> FlaxLeaf:
    top, stacks = tables(cfg)
    for leaf in top:
        if leaf.port == fqn:
            return FlaxLeaf(leaf.flax, None, leaf.from_flax, leaf.to_flax)
    for st in stacks:
        head, _, tail = st.port.partition("{i}")
        m = re.fullmatch(re.escape(head) + r"(\d+)" + re.escape(tail) + r"(.+)", fqn)
        if not m:
            continue
        i, rest = int(m.group(1)), m.group(2)
        leaf = next(lf for lf in st.leaves + st.first_apart if lf.port == rest)
        start = 1 if st.first_apart else 0
        if i < start or not cfg.scan_layers:
            return FlaxLeaf(f"{st.unrolled.format(i=i)}/{leaf.flax}", None, leaf.from_flax,
                            leaf.to_flax)
        return FlaxLeaf(f"{st.scanned}/{leaf.flax}", i - start, leaf.from_flax, leaf.to_flax)
    raise KeyError(fqn)


def _resnet_leaf(cfg, fqn: str) -> FlaxLeaf:
    owner, _, leaf = fqn.rpartition(".")
    name = _resnet_flax_name(cfg, fqn)
    if leaf != "weight":
        return FlaxLeaf(name, None, _identity, _identity)
    return FlaxLeaf(name, None, lambda k: k.permute(3, 2, 0, 1) if k.dim() == 4 else k.t(),
                    lambda w: w.permute(2, 3, 1, 0) if w.dim() == 4 else w.t())


def _table_of(module):
    for cls, tables in _TABLES.items():
        if isinstance(module, cls):
            return tables
    return None


def flax_leaf(module, fqn: str) -> FlaxLeaf:
    """The ``FlaxLeaf`` of ``module``'s parameter ``fqn``. A module without
    a converter keeps its own names (``/``-joined), and a 2-D ``Linear``
    weight maps to a ``kernel`` ``(in, out)``."""
    cfg = getattr(module, "config", None)
    if isinstance(module, (LlamaForCausalLM, MixtralForCausalLM)):
        return _llama_leaf(cfg, fqn)
    if isinstance(module, ResNet):
        return _resnet_leaf(cfg, fqn)
    tables = _table_of(module)
    if tables is not None:
        return _tables_leaf(tables, cfg, fqn)
    owner, _, leaf = fqn.rpartition(".")
    sub = module.get_submodule(owner) if owner else module
    if leaf == "weight" and isinstance(sub, torch.nn.Linear):
        return FlaxLeaf(f"{owner.replace('.', '/')}/kernel", None, lambda k: k.t(),
                        lambda w: w.t())
    return FlaxLeaf(fqn.replace(".", "/"), None, _identity, _identity)


# ---------------------------------------------------------------------------
# The registry
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FlaxConverter:
    """``to_flax(cfg, state_dict) -> tree``, ``views_from_flax(cfg, tree) ->
    {name: tensor}`` and ``flax_name(cfg, fqn) -> "a/b/c"`` (the name in the
    unrolled tree) of one module class."""

    to_flax: Callable
    views_from_flax: Callable
    flax_name: Callable


FLAX_CONVERTERS: dict[type, FlaxConverter] = {}


def register_flax_converter(module_class: type, to_flax: Callable, views_from_flax: Callable,
                            flax_name: Callable) -> None:
    """Make checkpoints of ``module_class`` hold the flax tree these give."""
    FLAX_CONVERTERS[module_class] = FlaxConverter(to_flax, views_from_flax, flax_name)


def flax_converter(module) -> Optional[FlaxConverter]:
    """The converter of ``module``'s class or of the nearest base class that
    has one (FSDP2's ``fully_shard`` makes a subclass of the module's class),
    or None (its own names)."""
    return next((FLAX_CONVERTERS[cls] for cls in type(module).__mro__
                 if cls in FLAX_CONVERTERS), None)


for _cls in (LlamaForCausalLM, MixtralForCausalLM):
    register_flax_converter(_cls, llama_params_to_flax, llama_views_from_flax, llama_flax_name)
register_flax_converter(GPT2LMHeadModel, gpt2_params_to_flax, gpt2_views_from_flax,
                        _gpt2_flax_name)
register_flax_converter(OPTForCausalLM, opt_params_to_flax, opt_views_from_flax,
                        _opt_flax_name)
register_flax_converter(GPTNeoXForCausalLM, neox_params_to_flax, neox_views_from_flax,
                        _neox_flax_name)
register_flax_converter(T5ForConditionalGeneration, t5_params_to_flax, t5_views_from_flax,
                        _t5_flax_name)
register_flax_converter(WhisperForConditionalGeneration, whisper_params_to_flax,
                        whisper_views_from_flax, _whisper_flax_name)
register_flax_converter(BertForSequenceClassification, bert_params_to_flax,
                        bert_views_from_flax, _bert_flax_name)
register_flax_converter(BertForMaskedLM, bert_mlm_params_to_flax, bert_mlm_views_from_flax,
                        _bert_mlm_flax_name)
register_flax_converter(ViTForImageClassification, vit_params_to_flax, vit_views_from_flax,
                        _vit_flax_name)
register_flax_converter(CLIPModel, clip_params_to_flax, clip_views_from_flax, _clip_flax_name)
register_flax_converter(ResNet, resnet_params_to_flax, resnet_views_from_flax,
                        _resnet_flax_name)
