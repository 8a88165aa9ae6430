"""Megatron-LM checkpoint importer (counterpart of
``accelerate_tpu/models/megatron.py``).

Megatron's own engine is not needed to run its checkpoints: what remains of
the integration is checkpoint portability, a Megatron-saved GPT/Llama model
read into the Llama chassis. Two layouts:

- the **megatron-core** GPT layout (``model.decoder.layers.N...``):
  ``linear_qkv`` fused per GQA group ``[ng * (q_per_group + 2) * hn, h]``
  (queries of the group, then its K, then its V), ``linear_fc1`` as
  gate-then-up halves for SwiGLU, RMSNorm weights, rotary positions;
- the **legacy** ``language_model.encoder.*`` layout (checkpoint_version
  >= 2.0, whose fused QKV ordering is per-head/group q...q k v, as core's):
  names translate to core via :func:`megatron_legacy_to_core`, then the core
  converter runs. Learned absolute position embeddings (GPT-2-style legacy)
  have no rotary-Llama counterpart and raise; checkpoint_version < 2.0
  (interleaved QKV) raises.

TP-sharded checkpoints (``mp_rank_00 ... mp_rank_0{T-1}``) merge before
conversion: column-parallel weights concat on the output dim, row-parallel on
the input dim, per Megatron's partitioning rules, except SwiGLU's fc1, where
each rank holds its own ``[gate_r; up_r]`` halves (the glu chunks the
*local* output), so gate and up merge separately. Pipeline-parallel
checkpoints (``mp_rank_XX_YYY`` dirs, one per (tp, pp) rank, with per-stage
local layer numbering) load stage by stage: layer indices are renumbered by
each stage's offset and the stages union into one flat dict per TP rank
(embedding from the first stage, final norm and output layer from the last,
the tied ``word_embeddings_for_head`` copy dropped).

Every converter works on numpy and returns the flax-shaped numpy tree the
JAX package's does (the ``params`` of its ``LlamaForCausalLM``: stacked
``model/layers/block`` when ``cfg.scan_layers``, else ``model/layers_{i}``),
with the same refusals and messages. :func:`load_megatron_model` is the
port's entry point: the tree through ``convert.llama_params_from_flax`` into
a ``LlamaForCausalLM`` on the card (the JAX users' path is
``megatron_params_to_llama`` then ``Model.from_flax``).
"""

from __future__ import annotations

import os
import re
from typing import Any

import numpy as np
import torch

from .llama import LlamaConfig, LlamaForCausalLM

__all__ = [
    "is_legacy_megatron",
    "load_megatron_checkpoint",
    "load_megatron_model",
    "merge_megatron_tp_shards",
    "megatron_config_from_args",
    "megatron_core_params_to_llama",
    "megatron_legacy_to_core",
    "megatron_params_to_llama",
    "llama_params_to_megatron_core",
]


# ---------------------------------------------------------------------------
# Reading checkpoint directories
# ---------------------------------------------------------------------------


def _latest_iteration(root: str) -> str:
    """Resolve ``<root>`` to its newest ``iter_XXXXXXX`` subdir (or itself)."""
    tracker = os.path.join(root, "latest_checkpointed_iteration.txt")
    if os.path.isfile(tracker):
        with open(tracker) as f:
            it = f.read().strip()
        sub = os.path.join(root, "release" if it == "release" else f"iter_{int(it):07d}")
        if os.path.isdir(sub):
            return sub
    iters = sorted(
        (d for d in os.listdir(root) if re.fullmatch(r"iter_\d{7}", d))
    ) if os.path.isdir(root) else []
    return os.path.join(root, iters[-1]) if iters else root


def _flatten_torch_tree(obj, prefix="") -> dict[str, np.ndarray]:
    """Flatten Megatron's nested-dict-of-tensors into dotted fp32 numpy
    arrays."""
    out: dict[str, np.ndarray] = {}
    if torch.is_tensor(obj):
        out[prefix.rstrip(".")] = np.asarray(obj.detach().to("cpu").float().numpy())
    elif isinstance(obj, dict):
        for k, v in obj.items():
            out.update(_flatten_torch_tree(v, f"{prefix}{k}."))
    return out


def _rank_file(it_dir: str, rank_dir: str) -> str:
    for name in ("model_optim_rng.pt", "model_rng.pt"):
        p = os.path.join(it_dir, rank_dir, name)
        if os.path.isfile(p):
            return p
    raise FileNotFoundError(f"no checkpoint file under {it_dir}/{rank_dir}")


_LAYER_KEY = re.compile(r"((?:decoder|language_model\.encoder)\.layers\.)(\d+)(\..+)")


def _merge_pp_stages(stages: list[dict[str, np.ndarray]]) -> dict[str, np.ndarray]:
    """Union PP-stage dicts into one, renumbering each stage's local layer
    indices by the running offset (stage s's ``layers.0`` becomes global
    ``layers.sum(len(earlier stages))``). Non-layer keys keep their first
    occurrence (embedding lives on the first stage, final norm / output layer
    on the last); the tied-embedding copy Megatron stores on the last stage
    (``word_embeddings_for_head``) is dropped."""
    merged: dict[str, np.ndarray] = {}
    offset = 0
    for sd in stages:
        local_count = 0
        for k, v in sd.items():
            m = _LAYER_KEY.match(k)
            if m:
                idx = int(m.group(2))
                local_count = max(local_count, idx + 1)
                merged[f"{m.group(1)}{idx + offset}{m.group(3)}"] = v
            elif "word_embeddings_for_head" in k:
                continue
            elif k not in merged:
                merged[k] = v
        offset += local_count
    return merged


def load_megatron_checkpoint(path: str) -> tuple[list[dict[str, np.ndarray]], Any]:
    """Load a Megatron checkpoint directory into per-TP-rank flat dicts.

    ``path`` may be the experiment root (``latest_checkpointed_iteration.txt``
    resolves the iteration), an ``iter_*`` dir holding ``mp_rank_*``
    subdirs, or a single ``.pt`` file. Both TP-only (``mp_rank_0T``) and
    TP×PP (``mp_rank_0T_00P``, per-stage layer numbering) directory layouts
    load; PP stages are renumbered and unioned per TP rank
    (:func:`_merge_pp_stages`). Returns ``(shards, args)``: one flat
    ``{dotted_name: np.ndarray}`` per TP rank in rank order (pass to
    :func:`merge_megatron_tp_shards`) plus the checkpoint's stored Megatron
    ``args`` (for :func:`megatron_config_from_args`; None if absent).
    """
    args = None
    version = None

    def _load(f):
        nonlocal args, version
        payload = torch.load(f, map_location="cpu", weights_only=False)
        model = payload.get("model", payload) if isinstance(payload, dict) else payload
        if isinstance(payload, dict):
            if args is None:
                args = payload.get("args")
            if version is None:
                version = payload.get("checkpoint_version")
        return _flatten_torch_tree(model)

    if os.path.isfile(path):
        shards = [_load(path)]
    else:
        it_dir = _latest_iteration(path)
        ranks = sorted(d for d in os.listdir(it_dir) if d.startswith("mp_rank_"))
        if not ranks:
            raise FileNotFoundError(f"no mp_rank_* dirs under {it_dir}")
        pp_ranks = [re.fullmatch(r"mp_rank_(\d+)_(\d+)", r) for r in ranks]
        if any(pp_ranks):
            if not all(pp_ranks):
                raise ValueError(f"mixed TP-only and TP×PP rank dirs under {it_dir}")
            by_tp: dict[int, list[tuple[int, str]]] = {}
            for m in pp_ranks:
                by_tp.setdefault(int(m.group(1)), []).append((int(m.group(2)), m.group(0)))
            shards = []
            for tp in sorted(by_tp):
                stages = [_load(_rank_file(it_dir, r)) for _, r in sorted(by_tp[tp])]
                shards.append(_merge_pp_stages(stages))
        else:
            shards = [_load(_rank_file(it_dir, r)) for r in ranks]
    # Megatron semantics: a missing checkpoint_version key means 0 (the oldest
    # format). Only the legacy language_model.* layout ever existed pre-2.0 —
    # core-layout dicts are always modern, so absence is fine there.
    if version is None and any(
        k.startswith("language_model.") for sd in shards for k in sd
    ):
        version = 0
    if version is not None and float(version) < 2.0:
        raise NotImplementedError(
            f"Megatron checkpoint_version {version} < 2.0 stores fused QKV in "
            "the old interleaved ordering (and omitting the key means 0); "
            "re-save with a current Megatron (or fix_query_key_value_ordering) "
            "first"
        )
    return shards, args


# Column-parallel (concat dim 0 of the torch [out, in] weight): QKV, fc1/h_to_4h,
# output_layer, embeddings (vocab-parallel). Row-parallel (concat dim 1):
# attention out-proj, fc2/4h_to_h. Norms/biases-of-row-parallel are replicated.
_COL_PAT = re.compile(
    r"(linear_qkv|query_key_value|linear_fc1|dense_h_to_4h|output_layer|word_embeddings)\.weight$"
)
_COL_BIAS_PAT = re.compile(r"(linear_qkv|query_key_value|linear_fc1|dense_h_to_4h)\.bias$")
_ROW_PAT = re.compile(r"(linear_proj|dense|linear_fc2|dense_4h_to_h)\.weight$")


_FC1_PAT = re.compile(r"(linear_fc1|dense_h_to_4h)\.(weight|bias)$")


def merge_megatron_tp_shards(
    shards: list[dict[str, np.ndarray]], swiglu: bool = True
) -> dict[str, np.ndarray]:
    """Merge per-TP-rank flat dicts into one full dict (Megatron partition
    rules: column-parallel concat on dim 0, row-parallel on dim 1).

    ``swiglu=True`` (megatron-core Llama default): each rank's fc1 holds its
    own ``[gate_r; up_r]`` halves — the glu activation chunks the LOCAL
    output — so a naive dim-0 concat would interleave ``[g0,u0,g1,u1,...]``.
    Gate halves and up halves merge separately instead. Set ``swiglu=False``
    for GELU-MLP checkpoints where fc1 is plain column-parallel.
    """
    if len(shards) == 1:
        return dict(shards[0])
    merged: dict[str, np.ndarray] = {}
    for name in shards[0]:
        parts = [s[name] for s in shards]
        if swiglu and _FC1_PAT.search(name):
            gates, ups = zip(*(np.split(p, 2, axis=0) for p in parts))
            merged[name] = np.concatenate(list(gates) + list(ups), axis=0)
        elif _COL_PAT.search(name) or _COL_BIAS_PAT.search(name):
            merged[name] = np.concatenate(parts, axis=0)
        elif _ROW_PAT.search(name):
            merged[name] = np.concatenate(parts, axis=1)
        else:
            merged[name] = parts[0]  # replicated (norms, row-parallel biases)
    return merged


# ---------------------------------------------------------------------------
# legacy (language_model.encoder.*) -> megatron-core names
# ---------------------------------------------------------------------------

# Per-layer legacy -> core renames. ``.attention.`` is the pre-2.x spelling of
# ``.self_attention.``. post_attention_layernorm maps to pre_mlp_layernorm
# (same tensor, core renamed it).
_LEGACY_LAYER_RENAMES = [
    (re.compile(r"\.(?:self_)?attention\.query_key_value\."), ".self_attention.linear_qkv."),
    (re.compile(r"\.(?:self_)?attention\.dense\."), ".self_attention.linear_proj."),
    (re.compile(r"\.mlp\.dense_h_to_4h\."), ".mlp.linear_fc1."),
    (re.compile(r"\.mlp\.dense_4h_to_h\."), ".mlp.linear_fc2."),
    (re.compile(r"\.post_attention_layernorm\."), ".pre_mlp_layernorm."),
]


def is_legacy_megatron(sd: dict[str, np.ndarray]) -> bool:
    """True for a ``language_model.*`` (legacy) flat dict."""
    return any(k.startswith("language_model.") for k in sd)


def megatron_legacy_to_core(sd: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """Rename a legacy ``language_model.encoder.*`` flat dict to megatron-core
    names so :func:`megatron_core_params_to_llama` can convert it.

    The fused-QKV row ordering is unchanged — for checkpoint_version >= 2.0
    legacy stores per-head/group ``q...q k v`` rows exactly like core
    (``load_megatron_checkpoint`` rejects older versions). Derived buffers
    (``rotary_pos_emb.inv_freq``, ``_extra_state``) and the last-PP-stage tied
    embedding copy are dropped. GPT-2-style learned position embeddings have
    no rotary counterpart and raise.
    """
    if any("position_embeddings" in k for k in sd):
        raise ValueError(
            "legacy checkpoint has learned absolute position embeddings "
            "(GPT-2-style); the rotary Llama family cannot represent them"
        )
    out: dict[str, np.ndarray] = {}
    for k, v in sd.items():
        if "_extra_state" in k or "rotary_pos_emb" in k or "word_embeddings_for_head" in k:
            continue
        name = k
        if name.startswith("language_model."):
            name = name[len("language_model."):]
        if name.startswith("encoder.layers."):
            name = "decoder." + name[len("encoder."):]
            for pat, repl in _LEGACY_LAYER_RENAMES:
                name = pat.sub(repl, name)
        elif name.startswith("encoder.final_layernorm.") or name.startswith("encoder.final_norm."):
            name = "decoder.final_layernorm." + name.rsplit(".", 1)[1]
        elif name.startswith("embedding.word_embeddings."):
            pass  # same spelling in core
        elif name.startswith("output_layer."):
            pass
        out[name] = v
    return out


def megatron_params_to_llama(cfg, sd: dict[str, np.ndarray]) -> dict:
    """Layout-dispatching converter: translates legacy dicts to core names
    first (:func:`megatron_legacy_to_core`), then runs
    :func:`megatron_core_params_to_llama`."""
    if is_legacy_megatron(sd):
        sd = megatron_legacy_to_core(sd)
    return megatron_core_params_to_llama(cfg, sd)


# ---------------------------------------------------------------------------
# megatron-core GPT (Llama-style) -> LlamaForCausalLM params
# ---------------------------------------------------------------------------


def megatron_config_from_args(args: Any) -> LlamaConfig:
    """Map a Megatron ``args`` namespace/dict (as stored in the checkpoint
    payload) onto the port's :class:`LlamaConfig`."""
    get = (lambda k, d=None: args.get(k, d)) if isinstance(args, dict) else (
        lambda k, d=None: getattr(args, k, d)
    )
    heads = get("num_attention_heads")
    return LlamaConfig(
        vocab_size=get("padded_vocab_size") or get("vocab_size"),
        hidden_size=get("hidden_size"),
        intermediate_size=get("ffn_hidden_size"),
        num_hidden_layers=get("num_layers"),
        num_attention_heads=heads,
        num_key_value_heads=get("num_query_groups") or heads,
        head_dim=get("kv_channels"),  # None -> hidden_size // heads
        max_position_embeddings=get("max_position_embeddings", 4096),
        rms_norm_eps=get("norm_epsilon", 1e-5),
        rope_theta=get("rotary_base", 10000.0),
        tie_word_embeddings=not get("untie_embeddings_and_output_weights", False),
        attention_bias=bool(get("add_qkv_bias", False)),
    )


def megatron_core_params_to_llama(cfg, sd: dict[str, np.ndarray]) -> dict:
    """Convert a merged megatron-core GPT flat dict to LlamaForCausalLM params
    (stacked ``nn.scan`` layout when ``cfg.scan_layers``).

    Layout notes (see module docstring): fused QKV is per-GQA-group
    ``[ng, (q_per_group + 2) * hn, h]`` rows ordered q...q k v; fc1 is
    ``[gate; up]`` halves; torch Linear weights are ``[out, in]`` so every
    2-D kernel transposes.
    """
    h = cfg.hidden_size
    hn = cfg.head_dim
    nq = cfg.num_attention_heads
    ng = cfg.num_key_value_heads
    q_per_g = nq // ng

    def t(name):
        return sd[name].T  # [out, in] -> [in, out]

    def layer(i: int) -> dict:
        p = f"decoder.layers.{i}."
        qkv = sd[p + "self_attention.linear_qkv.weight"]  # [(ng*(q+2)*hn), h]
        grouped = qkv.reshape(ng, (q_per_g + 2) * hn, h)
        q = grouped[:, : q_per_g * hn].reshape(nq * hn, h)
        k = grouped[:, q_per_g * hn : (q_per_g + 1) * hn].reshape(ng * hn, h)
        v = grouped[:, (q_per_g + 1) * hn :].reshape(ng * hn, h)
        attn = {
            "q_proj": {"kernel": q.T.reshape(h, nq, hn)},
            "k_proj": {"kernel": k.T.reshape(h, ng, hn)},
            "v_proj": {"kernel": v.T.reshape(h, ng, hn)},
            "o_proj": {"kernel": t(p + "self_attention.linear_proj.weight").reshape(nq, hn, h)},
        }
        bias_name = p + "self_attention.linear_qkv.bias"
        if bias_name in sd:
            # add_qkv_bias (Qwen-style): slice the fused bias like the weight.
            b = sd[bias_name].reshape(ng, (q_per_g + 2) * hn)
            attn["q_proj"]["bias"] = b[:, : q_per_g * hn].reshape(nq, hn)
            attn["k_proj"]["bias"] = b[:, q_per_g * hn : (q_per_g + 1) * hn].reshape(ng, hn)
            attn["v_proj"]["bias"] = b[:, (q_per_g + 1) * hn :].reshape(ng, hn)
        fc1 = sd[p + "mlp.linear_fc1.weight"]  # [2*ffn, h]: gate then up
        gate, up = np.split(fc1, 2, axis=0)
        return {
            "input_layernorm": {"weight": sd[p + "self_attention.linear_qkv.layer_norm_weight"]
                                if p + "self_attention.linear_qkv.layer_norm_weight" in sd
                                else sd[p + "input_layernorm.weight"]},
            "post_attention_layernorm": {"weight": sd[p + "mlp.linear_fc1.layer_norm_weight"]
                                         if p + "mlp.linear_fc1.layer_norm_weight" in sd
                                         else sd[p + "pre_mlp_layernorm.weight"]},
            "self_attn": attn,
            "mlp": {
                "gate_proj": {"kernel": gate.T},
                "up_proj": {"kernel": up.T},
                "down_proj": {"kernel": t(p + "mlp.linear_fc2.weight")},
            },
        }

    layers = [layer(i) for i in range(cfg.num_hidden_layers)]
    if cfg.scan_layers:
        stacked = {"block": _stack(layers)}
    else:
        stacked = {f"layers_{i}": l for i, l in enumerate(layers)}
        # non-scan layout stores blocks as siblings of embed/norm
    model = {
        "embed_tokens": {"embedding": sd["embedding.word_embeddings.weight"]},
        "norm": {"weight": sd["decoder.final_layernorm.weight"]},
    }
    if cfg.scan_layers:
        model["layers"] = stacked
    else:
        model.update(stacked)
    params = {"model": model}
    if not cfg.tie_word_embeddings:
        params["lm_head"] = {"kernel": sd["output_layer.weight"].T}
    return params


def llama_params_to_megatron_core(cfg, params) -> dict[str, np.ndarray]:
    """Export native Llama params to the megatron-core flat layout — the
    inverse of :func:`megatron_core_params_to_llama` (fused per-GQA-group QKV
    rows q...q k v, SwiGLU gate-then-up fc1 halves, torch ``[out, in]``
    weights). Round-trip parity is pinned by tests/test_megatron.py."""
    h, hn = cfg.hidden_size, cfg.head_dim
    nq, ng = cfg.num_attention_heads, cfg.num_key_value_heads
    q_per_g = nq // ng
    if not cfg.scan_layers:
        raise ValueError("export requires scan_layers=True (stacked blocks)")
    stacked = params["model"]["layers"]["block"]
    sd: dict[str, np.ndarray] = {
        "embedding.word_embeddings.weight": np.asarray(
            params["model"]["embed_tokens"]["embedding"]
        ),
        "decoder.final_layernorm.weight": np.asarray(params["model"]["norm"]["weight"]),
    }
    if not cfg.tie_word_embeddings:
        sd["output_layer.weight"] = np.asarray(params["lm_head"]["kernel"]).T
    for i in range(cfg.num_hidden_layers):
        blk = _index_layer(stacked, i)
        a = blk["self_attn"]
        q = a["q_proj"]["kernel"].reshape(h, nq * hn).T
        k = a["k_proj"]["kernel"].reshape(h, ng * hn).T
        v = a["v_proj"]["kernel"].reshape(h, ng * hn).T
        groups = []
        for g in range(ng):
            groups.append(q[g * q_per_g * hn : (g + 1) * q_per_g * hn])
            groups.append(k[g * hn : (g + 1) * hn])
            groups.append(v[g * hn : (g + 1) * hn])
        p = f"decoder.layers.{i}."
        sd[p + "self_attention.linear_qkv.weight"] = np.concatenate(groups, axis=0)
        if "bias" in a["q_proj"]:
            bq = a["q_proj"]["bias"].reshape(nq * hn)
            bk = a["k_proj"]["bias"].reshape(ng * hn)
            bv = a["v_proj"]["bias"].reshape(ng * hn)
            bg = []
            for g in range(ng):
                bg.append(bq[g * q_per_g * hn : (g + 1) * q_per_g * hn])
                bg.append(bk[g * hn : (g + 1) * hn])
                bg.append(bv[g * hn : (g + 1) * hn])
            sd[p + "self_attention.linear_qkv.bias"] = np.concatenate(bg)
        sd[p + "self_attention.linear_qkv.layer_norm_weight"] = blk["input_layernorm"]["weight"]
        sd[p + "self_attention.linear_proj.weight"] = (
            a["o_proj"]["kernel"].reshape(nq * hn, h).T
        )
        sd[p + "mlp.linear_fc1.weight"] = np.concatenate(
            [blk["mlp"]["gate_proj"]["kernel"].T, blk["mlp"]["up_proj"]["kernel"].T], axis=0
        )
        sd[p + "mlp.linear_fc1.layer_norm_weight"] = blk["post_attention_layernorm"]["weight"]
        sd[p + "mlp.linear_fc2.weight"] = blk["mlp"]["down_proj"]["kernel"].T
    return sd


def _index_layer(stacked: dict, i: int) -> dict:
    """Slice layer ``i`` out of the stacked nn.scan subtree (pure numpy)."""
    if isinstance(stacked, dict):
        return {k: _index_layer(v, i) for k, v in stacked.items()}
    return np.asarray(stacked[i])


def _stack(per_layer: list[dict]) -> dict:
    """Stack per-layer nested dicts into the nn.scan layout — pure numpy (no
    module init needed for a checkpoint conversion)."""
    first = per_layer[0]
    if isinstance(first, dict):
        return {k: _stack([layer[k] for layer in per_layer]) for k in first}
    return np.stack(per_layer, axis=0)


def load_megatron_model(path: str, config: LlamaConfig | None = None, device="cuda",
                        dtype=torch.bfloat16, swiglu: bool = True) -> LlamaForCausalLM:
    """A Megatron checkpoint (any layout :func:`load_megatron_checkpoint`
    reads) as the port's ``LlamaForCausalLM`` on ``device`` (the card unless
    the caller asks for the CPU): the TP shards merged, the dict converted
    to the flax tree (:func:`megatron_params_to_llama`) and carried into
    the module by ``convert.llama_params_from_flax`` (fp32 masters).
    ``config`` defaults to :func:`megatron_config_from_args` of the
    checkpoint's stored ``args`` with compute dtype ``dtype``."""
    from .convert import llama_params_from_flax

    shards, args = load_megatron_checkpoint(path)
    if config is None:
        if args is None:
            raise ValueError(f"{path} stores no Megatron args; pass config=")
        config = megatron_config_from_args(args)
        config.dtype = dtype
    tree = megatron_params_to_llama(config, merge_megatron_tp_shards(shards, swiglu=swiglu))
    del shards
    module = LlamaForCausalLM(config, device="meta")
    module.load_state_dict(llama_params_from_flax(config, tree), assign=True)
    return module.to(device)
