"""Hugging Face checkpoints of the Llama family on the port's decoder
chassis (counterpart of the Llama-family part of
``accelerate_tpu/models/hub.py``).

The port's parameter names and layouts already are Hugging Face's
(``model.layers.{i}.self_attn.q_proj.weight``, a Linear weight
``(out, in)``), so a checkpoint maps over by name: ``llama_params_from_hf``
picks the tensors ``LlamaForCausalLM(cfg)`` holds and makes them fp32
masters, ``llama_params_to_hf`` hands them back as host tensors. Gemma's
norm weights are stored as w in both conventions (both compute w + 1).
Phi-3's fused ``qkv_proj`` and ``gate_up_proj`` are split by rows.
Mixtral's ``block_sparse_moe`` (a ``gate`` Linear of ``(E, d)`` and
``experts.{e}.w1``/``w3``/``w2``, gate, up and down as ``(out, in)``
Linears) maps onto the stacked, input-major ``moe.router`` ``(d, E)``,
``moe.w_gate``/``w_up`` ``(E, d, f)`` and ``moe.w_down`` ``(E, f, d)``.

``load_pretrained(src)`` takes a transformers model (anything with
``.config`` and ``.state_dict()``; transformers itself is not imported), a
local checkpoint directory (``config.json`` with ``*.safetensors``, read by
the port's own reader, or ``pytorch_model.bin``), or a ``(config,
state_dict)`` pair, picks the family from ``model_type`` and falls back to
the declarative specs of ``generic_hub.py`` for the types outside
``_FAMILIES``.

GPT-2, OPT, GPT-NeoX, T5 and Whisper map as the JAX hub maps them, onto
the port's flax-tree names: GPT-2's ``Conv1D`` weights are ``(in, out)``
and transpose into ``(out, in)`` Linears, every LayerNorm's ``weight`` and
``bias`` copy over, T5's ``layer.{0,1,2}`` sublayers become ``self_attn``/
``cross_attn``/``ffn`` with ``ln0``-``ln2`` and the first block's relative
bias table, Whisper's convolutions and sinusoid table copy as they are. A
checkpoint's own prefix (``transformer.``, ``model.decoder.``,
``gpt_neox.``, ``model.``) may be there or not. The JAX hub has no
``*_params_to_hf`` for these families, and neither has the port (the row's
fourth field is None).

BERT (``BertForSequenceClassification``), ViT (``ViTForImageClassification``)
and CLIP (``CLIPModel``) map as the JAX hub maps them: transformers'
``attention.self.query`` becomes ``attention.query``, the
``*.LayerNorm``s the ``attention_norm``/``output_norm``/``embeddings_norm``
of the flax tree, CLIP's towers ``text``/``vision`` (its ``pre_layrnorm``,
so spelled, is ``pre_ln``); the patch convolutions are ``(out, in, P, P)``
in both. A checkpoint's ``bert.``/``vit.`` prefix may be there or not. No
row for ResNet, as in the JAX hub.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Optional

import numpy as np
import torch

from ..utils.other import load_safetensors
from .bert import BertConfig, BertForSequenceClassification
from .clip import CLIPConfig, CLIPModel
from .gpt2 import GPT2Config, GPT2LMHeadModel
from .llama import LlamaConfig, LlamaForCausalLM
from .moe import MixtralConfig, MixtralForCausalLM
from .neox import GPTNeoXConfig, GPTNeoXForCausalLM
from .opt import OPTConfig, OPTForCausalLM
from .t5 import T5Config, T5ForConditionalGeneration
from .vit import ViTConfig, ViTForImageClassification
from .whisper import WhisperConfig, WhisperForConditionalGeneration


def _getter(hf: Any):
    """``get(key, default)`` over a config dict or a config object."""
    if isinstance(hf, dict):
        return hf.get
    return lambda k, d=None: getattr(hf, k, d)


def _tensor(x) -> torch.Tensor:
    """A host tensor of a checkpoint entry (torch tensor or array-like)."""
    if torch.is_tensor(x):
        return x.detach().cpu()
    return torch.from_numpy(np.asarray(x))


# ---------------------------------------------------------------------------
# Llama, Mistral, Qwen2, Gemma, Phi-3
# ---------------------------------------------------------------------------


def llama_config_from_hf(hf: Any) -> LlamaConfig:
    g = _getter(hf)
    return LlamaConfig(
        vocab_size=g("vocab_size"),
        hidden_size=g("hidden_size"),
        intermediate_size=g("intermediate_size"),
        num_hidden_layers=g("num_hidden_layers"),
        num_attention_heads=g("num_attention_heads"),
        num_key_value_heads=g("num_key_value_heads") or g("num_attention_heads"),
        head_dim=g("head_dim"),
        max_position_embeddings=g("max_position_embeddings", 4096),
        rms_norm_eps=g("rms_norm_eps", 1e-5),
        rope_theta=g("rope_theta", 10000.0),
        tie_word_embeddings=bool(g("tie_word_embeddings", False)),
        # Qwen2 always carries q/k/v biases; Llama and Mistral name the flag.
        attention_bias=bool(g("attention_bias", g("model_type") == "qwen2")),
    )


def gemma_config_from_hf(hf: Any) -> LlamaConfig:
    """The Llama chassis with Gemma's three knobs: a GeGLU MLP
    (``gelu_tanh``), norm weights computed as w + 1, and embeddings scaled
    by sqrt(hidden_size); head_dim 256 unless given, tied embeddings."""
    g = _getter(hf)
    return dataclasses.replace(
        llama_config_from_hf(hf), head_dim=g("head_dim", 256), tie_word_embeddings=True,
        hidden_act="gelu_tanh", rms_norm_plus_one=True, scale_embeddings=True)


def phi3_config_from_hf(hf: Any) -> LlamaConfig:
    """The Llama config, refusing what the chassis would load and compute
    wrong: rope scaling (longrope, Phi-3-mini-128k) and a partial rotary
    factor (Phi-4-mini)."""
    g = _getter(hf)
    scaling = g("rope_scaling")
    if scaling:
        kind = scaling.get("type", scaling) if isinstance(scaling, dict) else scaling
        raise ValueError(
            f"Phi-3 checkpoint uses rope_scaling={kind!r} — longrope is not supported by the "
            "Llama family; load the base (4k) variant instead.")
    partial = g("partial_rotary_factor", 1.0)
    if partial not in (None, 1.0):
        raise ValueError(f"Phi-3 checkpoint uses partial_rotary_factor={partial} — the Llama "
                         "family applies full-head RoPE only.")
    return llama_config_from_hf(hf)


def _module_params(cls, cfg, sd: dict) -> dict[str, torch.Tensor]:
    """State dict of ``cls(cfg)`` (contiguous fp32 host tensors, copies: the
    source's tensors stay untouched by training) from a checkpoint in the
    module's own names: the names the module holds, each checked against
    its shape. Other entries are left out."""
    want = cls(cfg, device="meta").state_dict()
    missing = sorted(set(want) - set(sd))
    if missing:
        raise KeyError(f"checkpoint lacks {len(missing)} tensors of the model: {missing[:8]}")
    out = {}
    for name, ref in want.items():
        t = _tensor(sd[name]).to(torch.float32, copy=True).contiguous()
        if t.shape != ref.shape:
            raise ValueError(f"{name}: checkpoint {tuple(t.shape)} vs model {tuple(ref.shape)}")
        out[name] = t
    return out


def llama_params_from_hf(cfg: LlamaConfig, sd: dict) -> dict[str, torch.Tensor]:
    """State dict of ``LlamaForCausalLM(cfg)`` (contiguous fp32 host
    tensors, copies) from a Hugging Face one: the names the module holds,
    each checked against its shape. Other entries (a tied
    ``lm_head.weight``, rotary buffers) are left out."""
    return _module_params(LlamaForCausalLM, cfg, sd)


def llama_params_to_hf(cfg: LlamaConfig, state_dict: dict) -> dict[str, torch.Tensor]:
    """The Hugging Face state dict of a ``LlamaForCausalLM(cfg)`` state dict
    (the inverse of ``llama_params_from_hf``): the same names, as
    contiguous host tensors in their dtype."""
    want = LlamaForCausalLM(cfg, device="meta").state_dict()
    return {name: _tensor(state_dict[name]).contiguous() for name in want}


def phi3_params_from_hf(cfg: LlamaConfig, sd: dict) -> dict[str, torch.Tensor]:
    """Phi-3's fused projections split into the Llama names: ``qkv_proj``
    rows are [q (Hq·D) | k (Hkv·D) | v (Hkv·D)], ``gate_up_proj`` rows
    [gate (I) | up (I)]; the rest is Llama's."""
    q_rows = cfg.num_attention_heads * cfg.head_dim
    kv_rows = cfg.num_key_value_heads * cfg.head_dim
    split: dict = {}
    for k, v in sd.items():
        if k.endswith("self_attn.qkv_proj.weight"):
            base, w = k[: -len("qkv_proj.weight")], _tensor(v)
            split[base + "q_proj.weight"] = w[:q_rows]
            split[base + "k_proj.weight"] = w[q_rows:q_rows + kv_rows]
            split[base + "v_proj.weight"] = w[q_rows + kv_rows:]
        elif k.endswith("mlp.gate_up_proj.weight"):
            base, w = k[: -len("gate_up_proj.weight")], _tensor(v)
            split[base + "gate_proj.weight"] = w[: cfg.intermediate_size]
            split[base + "up_proj.weight"] = w[cfg.intermediate_size:]
        else:
            split[k] = v
    return llama_params_from_hf(cfg, split)


# ---------------------------------------------------------------------------
# Mixtral
# ---------------------------------------------------------------------------


def mixtral_config_from_hf(hf: Any) -> MixtralConfig:
    """The JAX package's reading: the Llama fields, the expert count, top-k
    and the aux-loss coefficient; ``capacity_factor`` keeps its default."""
    g = _getter(hf)
    return MixtralConfig(
        vocab_size=g("vocab_size"),
        hidden_size=g("hidden_size"),
        intermediate_size=g("intermediate_size"),
        num_hidden_layers=g("num_hidden_layers"),
        num_attention_heads=g("num_attention_heads"),
        num_key_value_heads=g("num_key_value_heads") or g("num_attention_heads"),
        max_position_embeddings=g("max_position_embeddings", 4096),
        rms_norm_eps=g("rms_norm_eps", 1e-5),
        rope_theta=g("rope_theta", 10000.0),
        num_local_experts=g("num_local_experts", 8),
        num_experts_per_tok=g("num_experts_per_tok", 2),
        router_aux_loss_coef=g("router_aux_loss_coef", 0.02),
    )


_HF_EXPERTS = {"w_gate": "w1", "w_up": "w3", "w_down": "w2"}


def mixtral_params_from_hf(cfg: MixtralConfig, sd: dict) -> dict[str, torch.Tensor]:
    """State dict of ``MixtralForCausalLM(cfg)`` (contiguous fp32 host
    tensors) from a Hugging Face Mixtral one: attention, norms, embedding
    and head by name, each layer's router and experts transposed and
    stacked."""
    src = dict(sd)
    for i in range(cfg.num_hidden_layers):
        moe = f"model.layers.{i}.block_sparse_moe."
        src[f"model.layers.{i}.moe.router"] = _tensor(sd[moe + "gate.weight"]).t()
        for ours, theirs in _HF_EXPERTS.items():
            src[f"model.layers.{i}.moe.{ours}"] = torch.stack([
                _tensor(sd[f"{moe}experts.{e}.{theirs}.weight"]).t()
                for e in range(cfg.num_local_experts)])
    return _module_params(MixtralForCausalLM, cfg, src)


def mixtral_params_to_hf(cfg: MixtralConfig, state_dict: dict) -> dict[str, torch.Tensor]:
    """The Hugging Face state dict of a ``MixtralForCausalLM(cfg)`` state
    dict (the inverse of ``mixtral_params_from_hf``): contiguous host
    tensors in their dtype."""
    out = {}
    for name in MixtralForCausalLM(cfg, device="meta").state_dict():
        t = _tensor(state_dict[name])
        pre, _, leaf = name.rpartition(".moe.")
        if not pre:
            out[name] = t.contiguous()
        elif leaf == "router":
            out[f"{pre}.block_sparse_moe.gate.weight"] = t.t().contiguous()
        else:
            for e in range(cfg.num_local_experts):
                out[f"{pre}.block_sparse_moe.experts.{e}.{_HF_EXPERTS[leaf]}.weight"] = \
                    t[e].t().contiguous()
    return out


# ---------------------------------------------------------------------------
# GPT-2, OPT, GPT-NeoX
# ---------------------------------------------------------------------------


def _prefixed(sd: dict, prefix: str) -> str:
    """``prefix`` when the checkpoint's names carry it (a head class's),
    else ''."""
    return prefix if any(k.startswith(prefix) for k in sd) else ""


def _renamed(sd: dict, names: dict) -> dict:
    """port name → checkpoint tensor (``names``: port name → checkpoint
    name, or ``(checkpoint name, fn)`` to transform it); a name the
    checkpoint lacks is left for ``_module_params`` to report."""
    out = {}
    for ours, theirs in names.items():
        fn = None
        if isinstance(theirs, tuple):
            theirs, fn = theirs
        if theirs not in sd:
            continue
        t = _tensor(sd[theirs])
        out[ours] = fn(t) if fn else t
    return out


def _t(t: torch.Tensor) -> torch.Tensor:
    return t.t()


def gpt2_config_from_hf(hf: Any) -> GPT2Config:
    g = _getter(hf)
    return GPT2Config(vocab_size=g("vocab_size"), n_positions=g("n_positions", 1024),
                      n_embd=g("n_embd", 768), n_layer=g("n_layer", 12), n_head=g("n_head", 12),
                      layer_norm_epsilon=g("layer_norm_epsilon", 1e-5))


def gpt2_params_from_hf(cfg: GPT2Config, sd: dict) -> dict[str, torch.Tensor]:
    """GPT-2's ``Conv1D`` weights are ``(in, out)``: transposed here."""
    pre = _prefixed(sd, "transformer.")
    names = {f"transformer.{n}.weight": f"{pre}{n}.weight" for n in ("wte", "wpe")}
    for leaf in ("weight", "bias"):
        names[f"transformer.ln_f.{leaf}"] = f"{pre}ln_f.{leaf}"
    for i in range(cfg.n_layer):
        ours, theirs = f"transformer.h.{i}.", f"{pre}h.{i}."
        for n in ("ln_1", "ln_2", "attn.c_attn", "attn.c_proj"):
            names[f"{ours}{n}.bias"] = f"{theirs}{n}.bias"
        for n in ("ln_1", "ln_2"):
            names[f"{ours}{n}.weight"] = f"{theirs}{n}.weight"
        for n in ("attn.c_attn", "attn.c_proj"):
            names[f"{ours}{n}.weight"] = (f"{theirs}{n}.weight", _t)
        for n in ("c_fc", "c_proj"):
            names[f"{ours}{n}.weight"] = (f"{theirs}mlp.{n}.weight", _t)
            names[f"{ours}{n}.bias"] = f"{theirs}mlp.{n}.bias"
    return _module_params(GPT2LMHeadModel, cfg, _renamed(sd, names))


def opt_config_from_hf(hf: Any) -> OPTConfig:
    g = _getter(hf)
    return OPTConfig(vocab_size=g("vocab_size"), hidden_size=g("hidden_size"),
                     ffn_dim=g("ffn_dim"), num_hidden_layers=g("num_hidden_layers"),
                     num_attention_heads=g("num_attention_heads"),
                     max_position_embeddings=g("max_position_embeddings", 2048))


def opt_params_from_hf(cfg: OPTConfig, sd: dict) -> dict[str, torch.Tensor]:
    pre = "model.decoder." if any(k.startswith("model.decoder.") for k in sd) else "decoder."
    src = {("model." + k[len(pre):]): v for k, v in sd.items() if k.startswith(pre)}
    return _module_params(OPTForCausalLM, cfg, src)


def neox_config_from_hf(hf: Any) -> GPTNeoXConfig:
    g = _getter(hf)
    return GPTNeoXConfig(
        vocab_size=g("vocab_size"), hidden_size=g("hidden_size"),
        num_hidden_layers=g("num_hidden_layers"), num_attention_heads=g("num_attention_heads"),
        intermediate_size=g("intermediate_size"), rotary_pct=g("rotary_pct", 0.25),
        rotary_emb_base=g("rotary_emb_base", 10000.0), layer_norm_eps=g("layer_norm_eps", 1e-5),
        use_parallel_residual=bool(g("use_parallel_residual", True)),
        max_position_embeddings=g("max_position_embeddings", 2048))


def neox_params_from_hf(cfg: GPTNeoXConfig, sd: dict) -> dict[str, torch.Tensor]:
    """NeoX's names are the port's but for the MLP's ``mlp.`` level; its
    fused ``query_key_value`` rows are per head ``[q|k|v]`` already."""
    pre = _prefixed(sd, "gpt_neox.")
    src = {}
    for k, v in sd.items():
        if k == "embed_out.weight":
            src[k] = v
        elif k.startswith(pre):
            src["gpt_neox." + k[len(pre):].replace(".mlp.", ".")] = v
    return _module_params(GPTNeoXForCausalLM, cfg, src)


# ---------------------------------------------------------------------------
# T5, Whisper
# ---------------------------------------------------------------------------


def t5_config_from_hf(hf: Any) -> T5Config:
    g = _getter(hf)
    return T5Config(
        vocab_size=g("vocab_size"), d_model=g("d_model"), d_kv=g("d_kv", 64), d_ff=g("d_ff"),
        num_layers=g("num_layers"), num_decoder_layers=g("num_decoder_layers"),
        num_heads=g("num_heads"),
        relative_attention_num_buckets=g("relative_attention_num_buckets", 32),
        relative_attention_max_distance=g("relative_attention_max_distance", 128),
        layer_norm_epsilon=g("layer_norm_epsilon", 1e-6),
        decoder_start_token_id=g("decoder_start_token_id", 0), pad_token_id=g("pad_token_id", 0))


def t5_params_from_hf(cfg: T5Config, sd: dict) -> dict[str, torch.Tensor]:
    """``block.{i}.layer.{0,1,2}`` → ``block_{i}`` with ``self_attn``,
    ``cross_attn`` (decoder) and ``ffn``, norms ``ln0``-``ln2``."""
    names = {"shared.weight": "shared.weight"}
    for stack, n, sub in (("encoder", cfg.num_layers, ("self_attn", "ffn")),
                          ("decoder", cfg.n_dec, ("self_attn", "cross_attn", "ffn"))):
        names[f"{stack}.final_ln.weight"] = f"{stack}.final_layer_norm.weight"
        for i in range(n):
            ours, theirs = f"{stack}.block_{i}.", f"{stack}.block.{i}.layer."
            for j, part in enumerate(sub):
                names[f"{ours}ln{j}.weight"] = f"{theirs}{j}.layer_norm.weight"
                if part == "ffn":
                    for w in ("wi", "wo"):
                        names[f"{ours}ffn.{w}.weight"] = f"{theirs}{j}.DenseReluDense.{w}.weight"
                    continue
                hf_part = "SelfAttention" if part == "self_attn" else "EncDecAttention"
                for w in "qkvo":
                    names[f"{ours}{part}.{w}.weight"] = f"{theirs}{j}.{hf_part}.{w}.weight"
            names[f"{stack}.block_0.self_attn.relative_attention_bias.weight"] = \
                f"{stack}.block.0.layer.0.SelfAttention.relative_attention_bias.weight"
    return _module_params(T5ForConditionalGeneration, cfg, _renamed(sd, names))


def whisper_config_from_hf(hf: Any) -> WhisperConfig:
    g = _getter(hf)
    return WhisperConfig(
        vocab_size=g("vocab_size"), num_mel_bins=g("num_mel_bins", 80), d_model=g("d_model"),
        encoder_layers=g("encoder_layers"), decoder_layers=g("decoder_layers"),
        encoder_attention_heads=g("encoder_attention_heads"),
        decoder_attention_heads=g("decoder_attention_heads"),
        encoder_ffn_dim=g("encoder_ffn_dim"), decoder_ffn_dim=g("decoder_ffn_dim"),
        max_source_positions=g("max_source_positions", 1500),
        max_target_positions=g("max_target_positions", 448))


def whisper_params_from_hf(cfg: WhisperConfig, sd: dict) -> dict[str, torch.Tensor]:
    """The port's names are Whisper's but for the encoder's sinusoid table
    (a parameter here, ``embed_positions.weight`` there)."""
    pre = _prefixed(sd, "model.")
    src = {k[len(pre):]: v for k, v in sd.items() if k.startswith(pre)}
    if "encoder.embed_positions.weight" in src:
        src["encoder.embed_positions"] = src.pop("encoder.embed_positions.weight")
    return _module_params(WhisperForConditionalGeneration, cfg, src)


# ---------------------------------------------------------------------------
# BERT, ViT, CLIP
# ---------------------------------------------------------------------------


def _num_labels(g, default: int) -> int:
    """A classifier's label count: ``num_labels``, or the size of
    ``id2label`` (transformers' ``config.json`` keeps only that)."""
    return g("num_labels") or len(g("id2label") or {}) or default


def bert_config_from_hf(hf: Any, num_labels: int = 2) -> BertConfig:
    g = _getter(hf)
    return BertConfig(
        vocab_size=g("vocab_size"), hidden_size=g("hidden_size"),
        num_hidden_layers=g("num_hidden_layers"), num_attention_heads=g("num_attention_heads"),
        intermediate_size=g("intermediate_size"),
        max_position_embeddings=g("max_position_embeddings", 512),
        type_vocab_size=g("type_vocab_size", 2), layer_norm_eps=g("layer_norm_eps", 1e-12),
        hidden_dropout_prob=g("hidden_dropout_prob", 0.1),
        num_labels=_num_labels(g, num_labels))


def _pair(names: dict, ours: str, theirs: str) -> None:
    """A Linear's or a LayerNorm's ``weight`` and ``bias``, renamed."""
    for leaf in ("weight", "bias"):
        names[f"{ours}.{leaf}"] = f"{theirs}.{leaf}"


def bert_params_from_hf(cfg: BertConfig, sd: dict) -> dict[str, torch.Tensor]:
    pre = _prefixed(sd, "bert.")
    names: dict = {}
    for n in ("word_embeddings", "position_embeddings", "token_type_embeddings"):
        names[f"bert.{n}.weight"] = f"{pre}embeddings.{n}.weight"
    _pair(names, "bert.embeddings_norm", f"{pre}embeddings.LayerNorm")
    _pair(names, "bert.pooler", f"{pre}pooler.dense")
    _pair(names, "classifier", "classifier")
    for i in range(cfg.num_hidden_layers):
        ours, theirs = f"bert.layers.{i}.", f"{pre}encoder.layer.{i}."
        for n in ("query", "key", "value"):
            _pair(names, f"{ours}attention.{n}", f"{theirs}attention.self.{n}")
        _pair(names, f"{ours}attention.output", f"{theirs}attention.output.dense")
        _pair(names, f"{ours}attention_norm", f"{theirs}attention.output.LayerNorm")
        _pair(names, f"{ours}intermediate", f"{theirs}intermediate.dense")
        _pair(names, f"{ours}output", f"{theirs}output.dense")
        _pair(names, f"{ours}output_norm", f"{theirs}output.LayerNorm")
    return _module_params(BertForSequenceClassification, cfg, _renamed(sd, names))


def vit_config_from_hf(hf: Any) -> ViTConfig:
    g = _getter(hf)
    return ViTConfig(
        image_size=g("image_size", 224), patch_size=g("patch_size", 16),
        num_channels=g("num_channels", 3), hidden_size=g("hidden_size"),
        num_hidden_layers=g("num_hidden_layers"), num_attention_heads=g("num_attention_heads"),
        intermediate_size=g("intermediate_size"), layer_norm_eps=g("layer_norm_eps", 1e-12),
        num_labels=_num_labels(g, 1000))


def vit_params_from_hf(cfg: ViTConfig, sd: dict) -> dict[str, torch.Tensor]:
    pre = _prefixed(sd, "vit.")
    e = f"{pre}embeddings."
    names = {"vit.cls_token": f"{e}cls_token",
             "vit.position_embeddings": f"{e}position_embeddings"}
    _pair(names, "vit.patch_embed", f"{e}patch_embeddings.projection")
    _pair(names, "vit.ln_final", f"{pre}layernorm")
    _pair(names, "classifier", "classifier")
    for i in range(cfg.num_hidden_layers):
        ours, theirs = f"vit.layers.{i}.", f"{pre}encoder.layer.{i}."
        _pair(names, f"{ours}ln_before", f"{theirs}layernorm_before")
        for n in ("query", "key", "value"):
            _pair(names, f"{ours}attention.{n}", f"{theirs}attention.attention.{n}")
        _pair(names, f"{ours}attention.output", f"{theirs}attention.output.dense")
        _pair(names, f"{ours}ln_after", f"{theirs}layernorm_after")
        _pair(names, f"{ours}intermediate", f"{theirs}intermediate.dense")
        _pair(names, f"{ours}output", f"{theirs}output.dense")
    return _module_params(ViTForImageClassification, cfg, _renamed(sd, names))


def _same_in_both_towers(tg, vg, key: str, default):
    text, vision = tg(key, default), vg(key, default)
    if text != vision:
        raise ValueError(f"CLIP checkpoint mixes tower {key} (text={text!r}, "
                         f"vision={vision!r}) — not supported by the native family.")
    return text


def clip_config_from_hf(hf: Any) -> CLIPConfig:
    g = _getter(hf)
    text, vision = g("text_config") or {}, g("vision_config") or {}
    tg, vg = _getter(text), _getter(vision)
    return CLIPConfig(
        vocab_size=tg("vocab_size"), text_hidden_size=tg("hidden_size"),
        text_num_layers=tg("num_hidden_layers"), text_num_heads=tg("num_attention_heads"),
        text_intermediate_size=tg("intermediate_size"),
        max_position_embeddings=tg("max_position_embeddings", 77),
        image_size=vg("image_size", 224), patch_size=vg("patch_size", 32),
        num_channels=vg("num_channels", 3), vision_hidden_size=vg("hidden_size"),
        vision_num_layers=vg("num_hidden_layers"), vision_num_heads=vg("num_attention_heads"),
        vision_intermediate_size=vg("intermediate_size"),
        projection_dim=g("projection_dim", 512),
        logit_scale_init=g("logit_scale_init_value", 2.6592),
        layer_norm_eps=_same_in_both_towers(tg, vg, "layer_norm_eps", 1e-5),
        eos_token_id=tg("eos_token_id", 49407),
        hidden_act=_same_in_both_towers(tg, vg, "hidden_act", "quick_gelu"))


def clip_params_from_hf(cfg: CLIPConfig, sd: dict) -> dict[str, torch.Tensor]:
    names = {"text.token_embedding": "text_model.embeddings.token_embedding.weight",
             "text.position_embedding": "text_model.embeddings.position_embedding.weight",
             "vision.class_embedding": "vision_model.embeddings.class_embedding",
             "vision.patch_embed.weight": "vision_model.embeddings.patch_embedding.weight",
             "vision.position_embedding":
                 "vision_model.embeddings.position_embedding.weight",
             "text_projection.weight": "text_projection.weight",
             "visual_projection.weight": "visual_projection.weight",
             "logit_scale": "logit_scale"}
    _pair(names, "text.final_ln", "text_model.final_layer_norm")
    _pair(names, "vision.pre_ln", "vision_model.pre_layrnorm")
    _pair(names, "vision.post_ln", "vision_model.post_layernorm")
    for tower, n in (("text", cfg.text_num_layers), ("vision", cfg.vision_num_layers)):
        for i in range(n):
            ours, theirs = f"{tower}.layers.{i}.", f"{tower}_model.encoder.layers.{i}."
            _pair(names, f"{ours}ln1", f"{theirs}layer_norm1")
            _pair(names, f"{ours}ln2", f"{theirs}layer_norm2")
            for p in ("q_proj", "k_proj", "v_proj", "out_proj"):
                _pair(names, f"{ours}self_attn.{p}", f"{theirs}self_attn.{p}")
            for p in ("fc1", "fc2"):
                _pair(names, f"{ours}{p}", f"{theirs}mlp.{p}")
    return _module_params(CLIPModel, cfg, _renamed(sd, names))


# ---------------------------------------------------------------------------
# High-level entry
# ---------------------------------------------------------------------------

# model_type -> (module class, config from HF, state dict from HF, state
# dict to HF or None where the JAX hub has no exporter)
_LLAMA = (llama_params_from_hf, llama_params_to_hf)
_FAMILIES = {
    "llama": (LlamaForCausalLM, llama_config_from_hf, *_LLAMA),
    "mistral": (LlamaForCausalLM, llama_config_from_hf, *_LLAMA),
    "qwen2": (LlamaForCausalLM, llama_config_from_hf, *_LLAMA),
    "gemma": (LlamaForCausalLM, gemma_config_from_hf, *_LLAMA),
    "phi3": (LlamaForCausalLM, phi3_config_from_hf, phi3_params_from_hf, llama_params_to_hf),
    "mixtral": (MixtralForCausalLM, mixtral_config_from_hf, mixtral_params_from_hf,
                mixtral_params_to_hf),
    "gpt2": (GPT2LMHeadModel, gpt2_config_from_hf, gpt2_params_from_hf, None),
    "opt": (OPTForCausalLM, opt_config_from_hf, opt_params_from_hf, None),
    "gpt_neox": (GPTNeoXForCausalLM, neox_config_from_hf, neox_params_from_hf, None),
    "t5": (T5ForConditionalGeneration, t5_config_from_hf, t5_params_from_hf, None),
    "whisper": (WhisperForConditionalGeneration, whisper_config_from_hf,
                whisper_params_from_hf, None),
    "bert": (BertForSequenceClassification, bert_config_from_hf, bert_params_from_hf, None),
    "vit": (ViTForImageClassification, vit_config_from_hf, vit_params_from_hf, None),
    "clip": (CLIPModel, clip_config_from_hf, clip_params_from_hf, None),
}


def _read_checkpoint_dir(path: str) -> tuple[dict, dict]:
    """(config.json, name → host tensor) of a checkpoint directory: every
    ``*.safetensors`` shard, else ``pytorch_model.bin``."""
    with open(os.path.join(path, "config.json")) as f:
        hf_cfg = json.load(f)
    sd: dict = {}
    shards = sorted(fn for fn in os.listdir(path) if fn.endswith(".safetensors"))
    if shards:
        for fn in shards:
            sd.update(load_safetensors(os.path.join(path, fn)))
    elif os.path.exists(os.path.join(path, "pytorch_model.bin")):
        sd = torch.load(os.path.join(path, "pytorch_model.bin"), map_location="cpu",
                        weights_only=True)
    else:
        raise FileNotFoundError(f"No *.safetensors or pytorch_model.bin under {path}")
    return hf_cfg, sd


def load_pretrained(src, family: Optional[str] = None, dtype=torch.bfloat16):
    """A Hugging Face checkpoint as ``(config, state_dict, module_class)``:
    the state dict's tensors are fp32 masters on the host and ``dtype`` is
    the config's compute dtype.

    ``src``: a transformers model (``.config`` and ``.state_dict()``), a
    local checkpoint directory, or a ``(hf_config, state_dict)`` pair."""
    if isinstance(src, (str, os.PathLike)):
        hf_cfg, sd = _read_checkpoint_dir(os.fspath(src))
    elif isinstance(src, tuple):
        hf_cfg, sd = src
    else:
        hf_cfg, sd = src.config, src.state_dict()
    if family is None:
        family = _getter(hf_cfg)("model_type")
    if family not in _FAMILIES:
        from . import generic_hub

        spec = generic_hub.get_arch_spec(family)
        if spec is not None:
            return generic_hub.load_with_spec(spec, hf_cfg, sd, dtype)
        raise ValueError(
            f"Unsupported model family {family!r}; hand-written families: "
            f"{', '.join(sorted(_FAMILIES))}; generic specs: "
            f"{', '.join(generic_hub.known_generic_types())}. Register new architectures "
            f"with accelerate_tpu_torch.models.generic_hub.register_arch_spec.")
    cls, cfg_fn, params_fn, _ = _FAMILIES[family]
    cfg = dataclasses.replace(cfg_fn(hf_cfg), dtype=dtype)
    return cfg, params_fn(cfg, sd), cls


def model_from_pretrained(src, family: Optional[str] = None, dtype=torch.bfloat16,
                          device="cuda"):
    """A Hugging Face checkpoint as a ready ``Model`` on ``device`` (the
    card unless the caller asks for the CPU)."""
    from ..model import Model

    cfg, state_dict, cls = load_pretrained(src, family=family, dtype=dtype)
    module = cls(cfg, device="meta")
    module.load_state_dict(state_dict, assign=True)
    return Model(module.to(device))
