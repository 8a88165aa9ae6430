"""Generic Hugging Face checkpoint ingestion by declarative rules
(counterpart of ``accelerate_tpu/models/generic_hub.py``).

An :class:`ArchSpec` maps an unseen ``model_type`` onto the Llama chassis:
``config_map`` takes the checkpoint's config keys (or constants) to
``LlamaConfig`` fields, and :class:`WeightRule` s take checkpoint names
(regular expressions) to the port's parameter names. The port's names and
layouts are Hugging Face's, so a rule copies its tensor (the JAX package's
transposes and per-head reshapes into flax layouts have nothing to do
here; :func:`validate_against_module` holds the result to the module's
shapes), except ``qkv_split``, which splits a fused, KV-grouped QKV weight
(InternLM2) into q, k and v by rows.

``hub.load_pretrained`` falls back here for a ``model_type`` outside its
families; users add architectures with :func:`register_arch_spec`. The
built-in specs: StarCoder2, StableLM, Granite and InternLM2, with the JAX
package's refusals (StableLM's parallel residual and qk layernorm,
StarCoder2's sliding window, Granite's rope scaling), and every
checkpoint tensor claimed by exactly one rule.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Optional

import torch

from .llama import LlamaConfig, LlamaForCausalLM

_OPS = ("copy", "qkv_split")


@dataclasses.dataclass(frozen=True)
class WeightRule:
    """One checkpoint-name pattern → one port parameter name (three for
    ``qkv_split``).

    src: regex matched against the whole checkpoint name; ``(?P<i>\\d+)``
         is the layer index, and a rule with it places its tensor under
         ``model.layers.{i}.``.
    dst: the port's name (``model.norm.weight``), inside the layer for a
         per-layer rule (``self_attn.q_proj.weight``); for ``qkv_split``
         the attention prefix (``self_attn``), under which the rule emits
         ``q_proj``, ``k_proj`` and ``v_proj`` weights.
    op:  ``copy`` or ``qkv_split``.
    unless_tied: skipped when the config ties the embeddings (state dicts
         list the tied ``lm_head.weight`` alias; the tied module has none).
    """

    src: str
    dst: str
    op: str = "copy"
    unless_tied: bool = False

    def __post_init__(self):
        if self.op not in _OPS:
            raise ValueError(f"WeightRule.op must be one of {_OPS}, got {self.op!r}")


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    """Declarative recipe: a checkpoint of one ``model_type`` → the Llama
    chassis.

    config_map: config field → checkpoint config key (str), a chain of keys
                ending in a default (``("key1", "key2", default)``: the first
                present wins), or ``Const(value)``.
    rules:      weight rules; every checkpoint tensor must be claimed by
                exactly one rule and every parameter produced.
    require:    checkpoint-config invariants the chassis assumes,
                ``{key: allowed value or tuple of values}``; a violation
                raises at load time rather than load shape-compatible but
                wrong.
    """

    config_map: dict
    rules: tuple
    require: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        object.__setattr__(self, "rules", tuple(self.rules))


@dataclasses.dataclass(frozen=True)
class Const:
    value: Any


def _cfg_get(hf_cfg, key, default=None):
    if isinstance(hf_cfg, dict):
        return hf_cfg.get(key, default)
    return getattr(hf_cfg, key, default)


def build_config(spec: ArchSpec, hf_cfg) -> LlamaConfig:
    """``spec.config_map`` resolved against the checkpoint's config."""
    kwargs = {}
    for field, source in spec.config_map.items():
        if isinstance(source, Const):
            kwargs[field] = source.value
        elif isinstance(source, str):
            kwargs[field] = _cfg_get(hf_cfg, source)
        elif isinstance(source, (tuple, list)):
            *keys, default = source
            val = next((v for v in (_cfg_get(hf_cfg, k) for k in keys) if v is not None), None)
            kwargs[field] = val if val is not None else default
        else:
            raise TypeError(f"config_map[{field!r}]: bad source {source!r}")
    return LlamaConfig(**{k: v for k, v in kwargs.items() if v is not None})


def _apply_op(rule: WeightRule, t: torch.Tensor, cfg) -> dict[str, torch.Tensor]:
    """{name relative to the rule's place: tensor} (three for qkv_split)."""
    if rule.op != "qkv_split":
        return {rule.dst: t}
    # Per KV group, [ratio q heads | 1 k head | 1 v head] along the rows.
    nh, nkv, d = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    ratio = nh // nkv
    w = t.reshape(nkv, (ratio + 2) * d, -1)
    return {
        f"{rule.dst}.q_proj.weight": w[:, : ratio * d].reshape(nh * d, -1),
        f"{rule.dst}.k_proj.weight": w[:, ratio * d: (ratio + 1) * d].reshape(nkv * d, -1),
        f"{rule.dst}.v_proj.weight": w[:, (ratio + 1) * d:].reshape(nkv * d, -1),
    }


def build_params(spec: ArchSpec, cfg, sd: dict) -> dict[str, torch.Tensor]:
    """``spec.rules`` applied to a checkpoint's state dict: the port's
    state dict, contiguous fp32 host tensors."""
    from .hub import _tensor

    tied = bool(getattr(cfg, "tie_word_embeddings", False))
    compiled = [(re.compile(r.src), r) for r in spec.rules if not (r.unless_tied and tied)]
    skipped = [re.compile(r.src) for r in spec.rules if r.unless_tied and tied]
    out: dict[str, torch.Tensor] = {}
    seen_layers: set[int] = set()
    unmatched: list[str] = []
    for name, tensor in sd.items():
        hits = [(m, r) for pat, r in compiled for m in [pat.fullmatch(name)] if m]
        if not hits:
            if not any(pat.fullmatch(name) for pat in skipped):
                unmatched.append(name)
            continue
        if len(hits) > 1:
            raise ValueError(f"{name!r} claimed by multiple rules: "
                             f"{', '.join(r.src for _, r in hits)}")
        m, rule = hits[0]
        prefix = ""
        layer = m.groupdict().get("i")
        if layer is not None:
            if int(layer) >= cfg.num_hidden_layers:
                raise ValueError(
                    f"{name!r} addresses layer {layer} but the resolved config has "
                    f"num_hidden_layers={cfg.num_hidden_layers} — check the spec's config_map.")
            seen_layers.add(int(layer))
            prefix = f"model.layers.{layer}."
        for dst, t in _apply_op(rule, _tensor(tensor), cfg).items():
            out[prefix + dst] = t.to(torch.float32, copy=True).contiguous()
    if unmatched:
        raise ValueError(
            f"{len(unmatched)} checkpoint tensors matched no rule for model_type spec (first "
            f"few: {sorted(unmatched)[:8]}). Add rules or pass family= explicitly.")
    if seen_layers:
        missing = sorted(set(range(cfg.num_hidden_layers)) - seen_layers)
        if missing:
            raise ValueError(f"No per-layer tensors found for layers {missing}")
    return out


def validate_against_module(cfg, state_dict: dict, module_cls) -> None:
    """Hold the produced state dict to the module's parameter shapes
    (built on the meta device); raises listing missing, unexpected and
    mis-shaped names."""
    want = {k: tuple(v.shape) for k, v in module_cls(cfg, device="meta").state_dict().items()}
    got = {k: tuple(v.shape) for k, v in state_dict.items()}
    problems = [f"missing {k} {want[k]}" for k in sorted(set(want) - set(got))]
    problems += [f"unexpected {k} {got[k]}" for k in sorted(set(got) - set(want))]
    problems += [f"shape {k}: checkpoint {got[k]} vs module {want[k]}"
                 for k in sorted(set(got) & set(want)) if got[k] != want[k]]
    if problems:
        raise ValueError("Generic ingestion produced a state dict the module can't load:\n  "
                         + "\n  ".join(problems))


# ---------------------------------------------------------------------------
# Spec registry and the built-in specs
# ---------------------------------------------------------------------------

_SPECS: dict[str, ArchSpec] = {}


def register_arch_spec(model_type: str, spec: ArchSpec) -> None:
    """Register (or override) the recipe of a ``model_type``."""
    _SPECS[model_type] = spec


def get_arch_spec(model_type: str) -> Optional[ArchSpec]:
    return _SPECS.get(model_type)


def known_generic_types() -> list[str]:
    return sorted(_SPECS)


def load_with_spec(spec: ArchSpec, hf_cfg, sd: dict, dtype) -> tuple:
    """(config, state_dict, module_class), as ``hub.load_pretrained``
    returns them for a hand-written family."""
    for key, allowed in spec.require.items():
        allowed = allowed if isinstance(allowed, tuple) else (allowed,)
        got = _cfg_get(hf_cfg, key, allowed[0])
        if got not in allowed:
            raise ValueError(
                f"Checkpoint config {key}={got!r} is outside what the Llama chassis "
                f"computes (allowed: {allowed}); loading would be shape-compatible but "
                f"semantically wrong.")
    cfg = dataclasses.replace(build_config(spec, hf_cfg), dtype=dtype)
    state_dict = build_params(spec, cfg, sd)
    validate_against_module(cfg, state_dict, LlamaForCausalLM)
    return cfg, state_dict, LlamaForCausalLM


_LLAMA_STYLE_CONFIG = {
    "vocab_size": "vocab_size",
    "hidden_size": "hidden_size",
    "intermediate_size": "intermediate_size",
    "num_hidden_layers": "num_hidden_layers",
    "num_attention_heads": "num_attention_heads",
    "num_key_value_heads": ("num_key_value_heads", "num_attention_heads", None),
    "head_dim": ("head_dim", None),
    "max_position_embeddings": ("max_position_embeddings", 4096),
    # A checkpoint's 1e-6 eps must not become the chassis default 1e-5.
    "rms_norm_eps": ("rms_norm_eps", 1e-5),
    "rope_theta": ("rope_theta", 10000.0),
    "tie_word_embeddings": ("tie_word_embeddings", False),
    "hidden_act": ("hidden_act", "silu"),
}

_L = r"model\.layers\.(?P<i>\d+)\."


def _llama_name_rules(*, gated=True, norm_bias=False, qkv_bias=False, out_bias=False,
                      mlp_bias=False, up_name="up_proj", gate_name="gate_proj",
                      down_name="down_proj"):
    """Rules for checkpoints with Llama's tensor names."""
    rules = [
        WeightRule(r"model\.embed_tokens\.weight", "model.embed_tokens.weight"),
        WeightRule(r"model\.norm\.weight", "model.norm.weight"),
        WeightRule(r"lm_head\.weight", "lm_head.weight", unless_tied=True),
        WeightRule(_L + r"self_attn\.q_proj\.weight", "self_attn.q_proj.weight"),
        WeightRule(_L + r"self_attn\.k_proj\.weight", "self_attn.k_proj.weight"),
        WeightRule(_L + r"self_attn\.v_proj\.weight", "self_attn.v_proj.weight"),
        WeightRule(_L + r"self_attn\.o_proj\.weight", "self_attn.o_proj.weight"),
        WeightRule(_L + r"input_layernorm\.weight", "input_layernorm.weight"),
        WeightRule(_L + r"post_attention_layernorm\.weight", "post_attention_layernorm.weight"),
        WeightRule(_L + rf"mlp\.{up_name}\.weight", "mlp.up_proj.weight"),
        WeightRule(_L + rf"mlp\.{down_name}\.weight", "mlp.down_proj.weight"),
    ]
    if gated:
        rules.append(WeightRule(_L + rf"mlp\.{gate_name}\.weight", "mlp.gate_proj.weight"))
    if norm_bias:
        rules += [
            WeightRule(r"model\.norm\.bias", "model.norm.bias"),
            WeightRule(_L + r"input_layernorm\.bias", "input_layernorm.bias"),
            WeightRule(_L + r"post_attention_layernorm\.bias", "post_attention_layernorm.bias"),
        ]
    if qkv_bias:
        rules += [WeightRule(_L + rf"self_attn\.{p}_proj\.bias", f"self_attn.{p}_proj.bias")
                  for p in ("q", "k", "v")]
    if out_bias:
        rules.append(WeightRule(_L + r"self_attn\.o_proj\.bias", "self_attn.o_proj.bias"))
    if mlp_bias:
        rules += [WeightRule(_L + rf"mlp\.{up_name}\.bias", "mlp.up_proj.bias"),
                  WeightRule(_L + rf"mlp\.{down_name}\.bias", "mlp.down_proj.bias")]
        if gated:
            rules.append(WeightRule(_L + rf"mlp\.{gate_name}\.bias", "mlp.gate_proj.bias"))
    return rules


# StarCoder2: Llama names, LayerNorm with bias, an ungated gelu MLP named
# c_fc/c_proj, biases everywhere. Full causal attention only: a sliding
# window would diverge past the window, so the spec refuses one.
register_arch_spec("starcoder2", ArchSpec(
    config_map={
        **_LLAMA_STYLE_CONFIG,
        "norm_type": Const("layernorm"),
        "rms_norm_eps": ("norm_epsilon", 1e-5),
        "mlp_gated": Const(False),
        "mlp_bias": ("use_bias", True),
        "attention_bias": ("use_bias", True),
        "attention_out_bias": ("use_bias", True),
        "tie_word_embeddings": ("tie_word_embeddings", True),
        "hidden_act": ("hidden_act", "gelu_pytorch_tanh"),
    },
    rules=_llama_name_rules(gated=False, norm_bias=True, qkv_bias=True, out_bias=True,
                            mlp_bias=True, up_name="c_fc", down_name="c_proj"),
    require={"sliding_window": None},
))

# StableLM: LayerNorm with bias, gated silu MLP, partial rotary, optional
# q/k/v bias.
register_arch_spec("stablelm", ArchSpec(
    config_map={
        **_LLAMA_STYLE_CONFIG,
        "norm_type": Const("layernorm"),
        "rms_norm_eps": ("layer_norm_eps", 1e-5),
        "partial_rotary_factor": ("partial_rotary_factor", 0.25),
        "attention_bias": ("use_qkv_bias", False),
    },
    rules=_llama_name_rules(norm_bias=True),
    require={"use_parallel_residual": False, "qk_layernorm": False},
))

# Granite: Llama names and four constants. HF's attention_multiplier
# default is 1.0 (unscaled scores), not the chassis' None. The bias rules
# are inert for unbiased checkpoints.
register_arch_spec("granite", ArchSpec(
    config_map={
        **_LLAMA_STYLE_CONFIG,
        "embedding_multiplier": ("embedding_multiplier", 1.0),
        "residual_multiplier": ("residual_multiplier", 1.0),
        "attention_multiplier": ("attention_multiplier", 1.0),
        "logits_scaling": ("logits_scaling", 1.0),
        "attention_bias": ("attention_bias", False),
        "attention_out_bias": ("attention_bias", False),  # HF puts it on o_proj too
        "mlp_bias": ("mlp_bias", False),
    },
    rules=_llama_name_rules(qkv_bias=True, out_bias=True, mlp_bias=True),
    require={"rope_scaling": None},
))

# InternLM2: the Llama chassis with renamed tensors and a fused, KV-grouped
# wqkv.
register_arch_spec("internlm2", ArchSpec(
    config_map={**_LLAMA_STYLE_CONFIG, "attention_bias": ("bias", False)},
    rules=[
        WeightRule(r"model\.tok_embeddings\.weight", "model.embed_tokens.weight"),
        WeightRule(r"model\.norm\.weight", "model.norm.weight"),
        WeightRule(r"output\.weight", "lm_head.weight"),
        WeightRule(_L + r"attention\.wqkv\.weight", "self_attn", op="qkv_split"),
        WeightRule(_L + r"attention\.wo\.weight", "self_attn.o_proj.weight"),
        WeightRule(_L + r"feed_forward\.w1\.weight", "mlp.gate_proj.weight"),
        WeightRule(_L + r"feed_forward\.w3\.weight", "mlp.up_proj.weight"),
        WeightRule(_L + r"feed_forward\.w2\.weight", "mlp.down_proj.weight"),
        WeightRule(_L + r"attention_norm\.weight", "input_layernorm.weight"),
        WeightRule(_L + r"ffn_norm\.weight", "post_attention_layernorm.weight"),
    ],
))
