"""The port's Megatron-LM importer (``accelerate_tpu_torch/models/megatron.py``)
against the JAX package's (``accelerate_tpu/models/megatron.py``), on the
CPU.

Weights are drawn with numpy from a seed in the port's layout and carried
to the flax tree with ``convert.llama_params_to_flax``. The Megatron
directories are those of tests/test_megatron.py: megatron-core with and
without GQA and with the fused QKV bias, the legacy ``language_model.*``
layout, TP 2 (SwiGLU's fc1 halves per rank), PP 2 (stage-local layer
numbers, the tied ``word_embeddings_for_head`` copy) and TP 2 x PP 2,
written with ``torch.save``. Both packages read each one: the converted
flax trees are equal exactly, leaf for leaf; the port's
``load_megatron_model`` gives logits equal bit for bit to the port's module
built from the source tree and within 1e-4 relative (L2) of the JAX
module's on the JAX tree (fp32, native attention). The refusals raise the
same errors with the same messages.
"""

import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from accelerate_tpu.models import LlamaConfig as JaxLlamaConfig
from accelerate_tpu.models import LlamaForCausalLM as JaxLlama
from accelerate_tpu.models import megatron as jmeg
from accelerate_tpu_torch.models import LlamaConfig, LlamaForCausalLM, convert
from accelerate_tpu_torch.models import megatron as pmeg


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _setup(gqa=True, attention_bias=False, seed=0):
    """(port config, flax numpy tree, ids) of a tiny 2-layer Llama."""
    kw = dict(dtype=torch.float32, scan_layers=True, attention_bias=attention_bias,
              attention_impl="native", num_key_value_heads=2 if gqa else 4)
    cfg = LlamaConfig.tiny(**kw)
    module = LlamaForCausalLM(cfg, device="meta")
    rng = np.random.default_rng(seed)
    sd = {}
    for name, p in module.named_parameters():
        a = (rng.standard_normal(p.shape) / np.sqrt(p.shape[-1]) if p.dim() == 2
             else 1.0 + 0.1 * rng.standard_normal(p.shape))
        sd[name] = torch.from_numpy(a.astype(np.float32))
    tree = jax.tree.map(lambda t: t.numpy(), convert.llama_params_to_flax(cfg, sd))
    ids = rng.integers(0, cfg.vocab_size, (2, 12))
    return cfg, tree, ids


def _jax_cfg(cfg):
    return JaxLlamaConfig.tiny(dtype=jnp.float32, scan_layers=True,
                               attention_bias=cfg.attention_bias, attention_impl="native",
                               num_key_value_heads=cfg.num_key_value_heads)


def _tp_split(name, arr):
    if name.endswith(("linear_fc1.weight", "dense_h_to_4h.weight")):
        gate, up = np.split(arr, 2, axis=0)
        g0, g1 = np.split(gate, 2, axis=0)
        u0, u1 = np.split(up, 2, axis=0)
        return [np.concatenate([g0, u0]), np.concatenate([g1, u1])]
    if name.endswith(("linear_qkv.weight", "query_key_value.weight", "word_embeddings.weight",
                      "output_layer.weight", "linear_qkv.bias")):
        return np.split(arr, 2, axis=0)
    if name.endswith(("linear_proj.weight", "linear_fc2.weight", "self_attention.dense.weight",
                      "dense_4h_to_h.weight")):
        return np.split(arr, 2, axis=1)
    return [arr, arr]


def _to_legacy(sd):
    """A core flat dict in the legacy ``language_model.encoder.*`` names."""
    out = {}
    for k, v in sd.items():
        name = k.replace("decoder.layers.", "encoder.layers.")
        name = name.replace(".self_attention.linear_qkv.layer_norm_weight", "#ILN#")
        name = name.replace(".mlp.linear_fc1.layer_norm_weight", "#PLN#")
        name = name.replace(".self_attention.linear_qkv.", ".self_attention.query_key_value.")
        name = name.replace(".self_attention.linear_proj.", ".self_attention.dense.")
        name = name.replace(".mlp.linear_fc1.", ".mlp.dense_h_to_4h.")
        name = name.replace(".mlp.linear_fc2.", ".mlp.dense_4h_to_h.")
        name = name.replace("#ILN#", ".input_layernorm.weight")
        name = name.replace("#PLN#", ".post_attention_layernorm.weight")
        name = name.replace("decoder.final_layernorm.", "encoder.final_layernorm.")
        out["language_model." + name] = v
    return out


_LAYER = re.compile(r"((?:decoder|language_model\.encoder)\.layers\.)(\d+)(\..+)")


def _stage(sd, pp, n_pp, layers_per_stage, legacy):
    out = {}
    for k, v in sd.items():
        m = _LAYER.match(k)
        if m:
            idx = int(m.group(2))
            if idx // layers_per_stage == pp:
                out[f"{m.group(1)}{idx - pp * layers_per_stage}{m.group(3)}"] = v
        elif "embedding.word_embeddings" in k:
            if pp == 0:
                out[k] = v
        elif pp == n_pp - 1:
            out[k] = v
    if legacy and pp == n_pp - 1 and n_pp > 1:
        out["word_embeddings_for_head.word_embeddings.weight"] = next(
            v for k, v in sd.items() if "embedding.word_embeddings" in k)
    return out


def _write(root, sd, tp=1, pp=1, legacy=False, version=3.0, args=None, iteration=100):
    """A Megatron experiment directory: ``mp_rank_0T`` (or ``_00P``) dirs
    of ``model_optim_rng.pt`` and the iteration tracker."""
    it = root / f"iter_{iteration:07d}"
    shards = [{k: _tp_split(k, v)[t] for k, v in sd.items()} if tp > 1 else sd
              for t in range(tp)]
    for t, shard in enumerate(shards):
        for p in range(pp):
            d = it / (f"mp_rank_{t:02d}_{p:03d}" if pp > 1 else f"mp_rank_{t:02d}")
            d.mkdir(parents=True)
            part = _stage(shard, p, pp, 2 // pp, legacy) if pp > 1 else shard
            payload = {"model": {k: torch.from_numpy(np.ascontiguousarray(v))
                                 for k, v in part.items()}}
            if version is not None:
                payload["checkpoint_version"] = version
            if args is not None:
                payload["args"] = args
            torch.save(payload, d / "model_optim_rng.pt")
    (root / "latest_checkpointed_iteration.txt").write_text(str(iteration))


def _assert_trees_equal(a, b):
    fa, fb = jax.tree_util.tree_leaves_with_path(a), jax.tree_util.tree_leaves_with_path(b)
    assert [p for p, _ in fa] == [p for p, _ in fb]
    for (path, x), (_, y) in zip(fa, fb):
        assert np.asarray(x).dtype == np.asarray(y).dtype, path
        assert np.array_equal(np.asarray(x), np.asarray(y)), path


def _args(cfg):
    return {"padded_vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden_size,
            "ffn_hidden_size": cfg.intermediate_size, "num_layers": cfg.num_hidden_layers,
            "num_attention_heads": cfg.num_attention_heads,
            "num_query_groups": cfg.num_key_value_heads,
            "max_position_embeddings": cfg.max_position_embeddings,
            "norm_epsilon": cfg.rms_norm_eps, "rotary_base": cfg.rope_theta,
            "untie_embeddings_and_output_weights": True, "add_qkv_bias": cfg.attention_bias}


CASES = {  # name -> (gqa, attention_bias, tp, pp, legacy)
    "core": (False, False, 1, 1, False),
    "core_gqa": (True, False, 1, 1, False),
    "qkv_bias": (True, True, 1, 1, False),
    "legacy": (True, False, 1, 1, True),
    "tp2": (False, False, 2, 1, False),
    "pp2_legacy": (False, False, 1, 2, True),
    "tp2_pp2": (False, False, 2, 2, False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_checkpoint_directories_match_jax(case, tmp_path):
    """Each directory read by both packages: equal shards, equal merged
    dicts, equal flax trees; the port's exports equal the JAX package's;
    ``load_megatron_model`` (config from the stored args) against the
    module built from the source tree and the JAX module."""
    gqa, bias, tp, pp, legacy = CASES[case]
    cfg, tree, ids = _setup(gqa, bias)
    sd = pmeg.llama_params_to_megatron_core(cfg, tree)
    jsd = jmeg.llama_params_to_megatron_core(_jax_cfg(cfg), tree)
    assert sd.keys() == jsd.keys()
    assert all(np.array_equal(np.asarray(sd[k]), np.asarray(jsd[k])) for k in sd)
    if legacy:
        sd = _to_legacy(sd)
    _write(tmp_path, sd, tp=tp, pp=pp, legacy=legacy, args=_args(cfg))
    shards, args = pmeg.load_megatron_checkpoint(str(tmp_path))
    jshards, jargs = jmeg.load_megatron_checkpoint(str(tmp_path))
    assert args == jargs and len(shards) == len(jshards) == tp
    for a, b in zip(shards, jshards):
        assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)
    merged = pmeg.merge_megatron_tp_shards(shards)
    assert not any("word_embeddings_for_head" in k for k in merged)
    assert pmeg.is_legacy_megatron(merged) == jmeg.is_legacy_megatron(merged) == legacy
    if legacy:
        core = pmeg.megatron_legacy_to_core(merged)
        jcore = jmeg.megatron_legacy_to_core(merged)
        assert core.keys() == jcore.keys()
    got = pmeg.megatron_params_to_llama(cfg, merged)
    want = jmeg.megatron_params_to_llama(_jax_cfg(cfg), jmeg.merge_megatron_tp_shards(jshards))
    _assert_trees_equal(got, want)
    _assert_trees_equal(got, tree)
    assert pmeg.megatron_config_from_args(args) == _config_of_args(cfg)

    model = pmeg.load_megatron_model(str(tmp_path), device="cpu", dtype=torch.float32)
    direct = LlamaForCausalLM(model.config)
    direct.load_state_dict(convert.llama_params_from_flax(model.config, tree))
    with torch.no_grad():
        logits = model(torch.from_numpy(ids))
        assert torch.equal(logits, direct(torch.from_numpy(ids)))
    jlogits = np.asarray(JaxLlama(_jax_cfg(cfg)).apply(
        {"params": jax.tree.map(jnp.asarray, want)}, jnp.asarray(ids, jnp.int32)))
    rel = np.linalg.norm(logits.numpy() - jlogits) / np.linalg.norm(jlogits)
    assert rel < 1e-4


def _config_of_args(cfg):
    """``cfg`` as ``megatron_config_from_args`` rebuilds it from ``_args``:
    the fields Megatron stores, the rest at their defaults."""
    return LlamaConfig(
        vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size,
        intermediate_size=cfg.intermediate_size, num_hidden_layers=cfg.num_hidden_layers,
        num_attention_heads=cfg.num_attention_heads, num_key_value_heads=cfg.num_key_value_heads,
        max_position_embeddings=cfg.max_position_embeddings, rms_norm_eps=cfg.rms_norm_eps,
        rope_theta=cfg.rope_theta, tie_word_embeddings=False,
        attention_bias=cfg.attention_bias)


def test_unrolled_layout_and_config_from_args():
    """``scan_layers=False`` gives ``model/layers_{i}`` in both packages;
    ``megatron_config_from_args`` maps a namespace as the JAX one does."""
    cfg, tree, _ = _setup(gqa=True)
    sd = pmeg.llama_params_to_megatron_core(cfg, tree)
    ucfg = LlamaConfig.tiny(dtype=torch.float32, scan_layers=False, num_key_value_heads=2)
    jucfg = JaxLlamaConfig.tiny(dtype=jnp.float32, scan_layers=False, num_key_value_heads=2)
    got = pmeg.megatron_core_params_to_llama(ucfg, sd)
    _assert_trees_equal(got, jmeg.megatron_core_params_to_llama(jucfg, sd))
    assert "layers_1" in got["model"]
    import types

    ns = types.SimpleNamespace(padded_vocab_size=50304, hidden_size=128, ffn_hidden_size=512,
                               num_layers=4, num_attention_heads=8, num_query_groups=2,
                               max_position_embeddings=2048, norm_epsilon=1e-6,
                               rotary_base=1e6, untie_embeddings_and_output_weights=True,
                               kv_channels=32)
    pc, jc = pmeg.megatron_config_from_args(ns), jmeg.megatron_config_from_args(ns)
    fields = ("vocab_size", "hidden_size", "intermediate_size", "num_hidden_layers",
              "num_attention_heads", "num_key_value_heads", "head_dim",
              "max_position_embeddings", "rms_norm_eps", "rope_theta", "tie_word_embeddings",
              "attention_bias")
    assert {f: getattr(pc, f) for f in fields} == {f: getattr(jc, f) for f in fields}


def _raises_same(fn_name, *args):
    with pytest.raises(Exception) as jerr:
        getattr(jmeg, fn_name)(*args)
    with pytest.raises(type(jerr.value)) as perr:
        getattr(pmeg, fn_name)(*args)
    assert str(perr.value) == str(jerr.value)
    return perr.value


def test_refusals_match_jax(tmp_path):
    """checkpoint_version < 2.0, a legacy layout without a version, learned
    position embeddings, mixed TP-only and TP x PP rank dirs and rank dirs
    without files: the same exception types and messages."""
    old = tmp_path / "old"
    _write(old, {"x": np.zeros(2, np.float32)}, version=0)
    assert isinstance(_raises_same("load_megatron_checkpoint", str(old)), NotImplementedError)
    unversioned = tmp_path / "unversioned"
    _write(unversioned, {"language_model.embedding.word_embeddings.weight":
                         np.zeros((4, 2), np.float32)}, version=None)
    assert "checkpoint_version" in str(
        _raises_same("load_megatron_checkpoint", str(unversioned)))
    assert "position embeddings" in str(_raises_same(
        "megatron_legacy_to_core",
        {"language_model.embedding.position_embeddings.weight": np.zeros((4, 8))}))
    mixed = tmp_path / "mixed" / "iter_0000001"
    (mixed / "mp_rank_00").mkdir(parents=True)
    (mixed / "mp_rank_00_000").mkdir(parents=True)
    assert isinstance(_raises_same("load_megatron_checkpoint", str(mixed)), ValueError)
    empty = tmp_path / "empty"
    (empty / "iter_0000005" / "mp_rank_00_000").mkdir(parents=True)
    (empty / "latest_checkpointed_iteration.txt").write_text("5")
    assert isinstance(_raises_same("load_megatron_checkpoint", str(empty)), FileNotFoundError)
    with pytest.raises(ValueError, match="stores no Megatron args"):
        _write(tmp_path / "no_args", pmeg.llama_params_to_megatron_core(*_setup()[:2]))
        pmeg.load_megatron_model(str(tmp_path / "no_args"), device="cpu")
