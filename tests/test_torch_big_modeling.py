"""The port's big-model inference (``accelerate_tpu_torch/big_modeling.py``,
``utils/modeling.py``, ``utils/offload.py``) against the JAX package's, on
the CPU, where the host stands in for the card (``torch.device("cpu")`` as
the execution device and as a device budget).

Weights are drawn with numpy from a seed in the port's layout and carried
to the flax tree with the family's converter; inputs are drawn with numpy
from a seed. Tolerances: device maps, abstract names, shapes and sizes
equal exactly; offload folders read back bit for bit; fp32 logits of the
port's streamed forward within 1e-4 relative (L2) of the JAX package's
streamed and full forwards (the decoder-family files' fp32 tolerance) and
equal bit for bit to the port's own resident forward, whatever the
placements; the peak of streamed groups at most the non-layer groups plus
two layers.

The JAX package's streamed Llama forward drops three knobs of its
resident module (``embedding_multiplier``, ``logits_scaling``,
``norm_type="layernorm"``, ``big_modeling.py:311-350``): the gap of its
streamed logits from its resident ones on those configs is recorded in
``test_streamed_equals_resident_for_every_chassis_knob``, where the port's
streamed forward equals its resident one bit for bit.
"""

import logging
import os
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import accelerate_tpu.big_modeling as jbm
from accelerate_tpu import Model as JaxModel
from accelerate_tpu import models as jmodels
from accelerate_tpu.utils import modeling as jmodeling
from accelerate_tpu.utils import offload as joffload
from accelerate_tpu.utils.other import flatten_state_dict as jflatten
from accelerate_tpu.utils.other import save_sharded_safetensors as jsave_sharded
from accelerate_tpu_torch import (
    Accelerator,
    Model,
    adamw,
    cpu_offload,
    cpu_offload_with_hook,
    disk_offload,
    dispatch_model,
    init_empty_weights,
    init_on_device,
    load_checkpoint_and_dispatch,
)
from accelerate_tpu_torch import big_modeling as bm
from accelerate_tpu_torch import models
from accelerate_tpu_torch.models import convert
from accelerate_tpu_torch.state import AcceleratorState, GradientState, PartialState
from accelerate_tpu_torch.utils import (
    OffloadedWeightsLoader,
    compute_abstract_params,
    extract_submodule_tensors,
    compute_module_sizes,
    get_balanced_memory,
    get_max_memory,
    infer_auto_device_map,
    load_offload_index,
    named_parameter_shapes,
    offload_state_dict,
)

CPU = torch.device("cpu")
FP32_REL = 1e-4

# name -> (JAX config, JAX module, port config, port module, config knobs)
FAMILIES = {
    "llama": (jmodels.LlamaConfig, jmodels.LlamaForCausalLM, models.LlamaConfig,
              models.LlamaForCausalLM, {"attention_impl": "native"}),
    "mixtral": (jmodels.MixtralConfig, jmodels.MixtralForCausalLM, models.MixtralConfig,
                models.MixtralForCausalLM, {"attention_impl": "native"}),
    "gpt2": (jmodels.GPT2Config, jmodels.GPT2LMHeadModel, models.GPT2Config,
             models.GPT2LMHeadModel, {}),
    "opt": (jmodels.OPTConfig, jmodels.OPTForCausalLM, models.OPTConfig,
            models.OPTForCausalLM, {}),
    "neox": (jmodels.GPTNeoXConfig, jmodels.GPTNeoXForCausalLM, models.GPTNeoXConfig,
             models.GPTNeoXForCausalLM, {}),
    "t5": (jmodels.T5Config, jmodels.T5ForConditionalGeneration, models.T5Config,
           models.T5ForConditionalGeneration, {}),
    "whisper": (jmodels.WhisperConfig, jmodels.WhisperForConditionalGeneration,
                models.WhisperConfig, models.WhisperForConditionalGeneration, {}),
}
LAYOUTS = {"stacked": True, "unrolled": False}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def reset_port_state():
    yield
    for cls in (AcceleratorState, GradientState, PartialState):
        cls._reset_state()


def _weights(module, seed=0) -> dict:
    rng = np.random.default_rng(seed)
    out = {}
    for name, p in module.named_parameters():
        if p.dim() == 1:
            a = rng.standard_normal(p.shape) * 0.1 + (0.0 if name.endswith("bias") else 1.0)
        else:
            a = rng.standard_normal(p.shape) / np.sqrt(np.prod(p.shape[1:]))
        out[name] = torch.from_numpy(a.astype(np.float32))
    return out


def _inputs(family, cfg, seed=1):
    rng = np.random.default_rng(seed)
    if family == "t5":
        return (rng.integers(1, cfg.vocab_size, (2, 10)), rng.integers(1, cfg.vocab_size, (2, 8)))
    if family == "whisper":
        return (rng.standard_normal((2, 24, cfg.num_mel_bins)).astype(np.float32),
                rng.integers(0, cfg.vocab_size, (2, 6)))
    return (rng.integers(0, cfg.vocab_size, (2, 12)),)


def _build(family, scan_layers, seed=0, **kw):
    """(JAX Model, port module with the same weights, numpy inputs)."""
    jc, jm, pc, pm, knobs = FAMILIES[family]
    knobs = {**knobs, **kw}
    cfg = pc.tiny(dtype=torch.float32, scan_layers=scan_layers, **knobs)
    module = pm(cfg)
    module.load_state_dict(_weights(module, seed), strict=False)
    tree = convert.flax_converter(module).to_flax(cfg, module.state_dict())
    params = jax.tree.map(lambda t: t.detach().numpy(), tree)
    jmodule = jm(jc.tiny(dtype=jnp.float32, scan_layers=scan_layers, **knobs))
    return JaxModel(module=jmodule, params=params), module, _inputs(family, cfg)


def _torch_inputs(xs):
    return tuple(torch.from_numpy(x).long() if x.dtype.kind == "i" else torch.from_numpy(x)
                 for x in xs)


def _jax_inputs(xs):
    return tuple(jnp.asarray(x.astype(np.int32) if x.dtype.kind == "i" else x) for x in xs)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _canon(device_map):
    """A device map with its devices as indices (both packages')."""
    def key(v):
        if isinstance(v, str):
            return v
        return v.index if isinstance(v, torch.device) else v.id
    return {k: key(v) for k, v in device_map.items()}


def _resident(module, xs):
    with torch.no_grad():
        return module(*_torch_inputs(xs))


# ---------------------------------------------------------------------------
# Abstract parameters and device maps
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_abstract_params_and_device_maps_match_jax(family, layout):
    """The abstract tree's names, shapes and dtypes and every module size
    equal the JAX package's ``compute_abstract_params``; ``auto`` over two
    devices and the host, ``balanced`` and a ``no_split_modules`` map equal
    the JAX package's maps for the same budgets."""
    jmodel, module, xs = _build(family, LAYOUTS[layout])
    jabs = jmodeling.compute_abstract_params(jmodel.module, *_jax_inputs(xs))
    pabs = compute_abstract_params(models.__dict__[type(module).__name__](
        module.config, device="meta"))
    jshapes = jmodeling.named_parameter_shapes(jabs)
    pshapes = named_parameter_shapes(pabs)
    assert list(jshapes) == list(pshapes)
    assert all(tuple(jshapes[k].shape) == tuple(pshapes[k].shape) for k in jshapes)
    assert {str(v.dtype) for v in jshapes.values()} == {"float32"}
    assert {v.dtype for v in pshapes.values()} == {torch.float32}
    sizes = compute_module_sizes(pabs)
    assert sizes == jmodeling.compute_module_sizes(jabs)
    assert compute_module_sizes(pabs, dtype=torch.bfloat16) == \
        jmodeling.compute_module_sizes(jabs, dtype=jnp.bfloat16)
    third = sizes[""] // 3
    budgets = {0: third, 1: third, "cpu": third}
    assert _canon(infer_auto_device_map(pabs, dict(budgets))) == \
        _canon(jmodeling.infer_auto_device_map(jabs, dict(budgets)))
    balanced = get_balanced_memory(pabs, {0: sizes[""], 1: sizes[""], "cpu": sizes[""]})
    assert balanced == jmodeling.get_balanced_memory(jabs, {0: sizes[""], 1: sizes[""],
                                                            "cpu": sizes[""]})
    assert _canon(infer_auto_device_map(pabs, balanced)) == \
        _canon(jmodeling.infer_auto_device_map(jabs, balanced))
    block = r"(layers_\d+|layer_\d+|h_\d+|block_\d+|block)"
    small = {0: sizes[""] // 8, "cpu": sizes[""] // 2}
    got = infer_auto_device_map(pabs, dict(small), no_split_modules=[block])
    assert _canon(got) == _canon(jmodeling.infer_auto_device_map(
        jabs, dict(small), no_split_modules=[block]))


def test_get_max_memory_and_abstract_init():
    """Budgets: the host always, no GPU entry without a card, sizes parsed;
    ``init_on_device("meta")`` and ``init_empty_weights()`` build on meta,
    ``init_empty_weights(module)`` gives the abstract tree."""
    mm = get_max_memory()
    assert "cpu" in mm and mm["cpu"] > 0
    assert [k for k in mm if k != "cpu"] == list(range(torch.cuda.device_count()))
    assert get_max_memory({0: "1GiB", "cpu": 123}) == {0: 1024**3, "cpu": 123}
    cfg = models.LlamaConfig.tiny()
    with init_on_device("meta"):
        a = models.LlamaForCausalLM(cfg)
    with init_empty_weights():
        b = models.LlamaForCausalLM(cfg)
    assert all(p.is_meta for p in a.parameters()) and all(p.is_meta for p in b.parameters())
    with init_on_device("cpu"):
        c = models.LlamaForCausalLM(cfg)
    assert all(p.device == CPU for p in c.parameters())
    abstract = init_empty_weights(a)
    assert "model/layers/block/self_attn/q_proj/kernel" in named_parameter_shapes(abstract)


def test_modeling_helpers_match_jax(tmp_path):
    """``dtype_byte_size``, ``tensor_bytes``, ``calculate_maximum_sizes``,
    ``check_device_map``'s refusal, ``placement_for``, ``place_tensor`` and
    ``load_checkpoint_in_model``: the same answers as the JAX package's,
    and a disk tier written in the JAX package's names and flax layouts,
    which it reads back."""
    import ml_dtypes

    from accelerate_tpu_torch.utils import (
        calculate_maximum_sizes,
        check_device_map,
        dtype_byte_size,
        load_checkpoint_in_model,
        placement_for,
    )
    from accelerate_tpu_torch.utils.modeling import place_tensor, tensor_bytes

    for tdt, jdt in ((torch.float32, np.float32), (torch.bfloat16, ml_dtypes.bfloat16),
                     (torch.int8, np.int8), (torch.float16, np.float16)):
        assert dtype_byte_size(tdt) == jmodeling.dtype_byte_size(np.dtype(jdt))
    assert dtype_byte_size("int4") == jmodeling.dtype_byte_size(jnp.int4) == 0.5
    t = torch.zeros(3, 5, dtype=torch.bfloat16)
    assert tensor_bytes(t) == jmodeling.tensor_bytes(jnp.zeros((3, 5), jnp.bfloat16)) == 30
    jmodel, module, xs = _build("llama", True)
    jabs = jmodeling.compute_abstract_params(jmodel.module, *_jax_inputs(xs))
    pabs = compute_abstract_params(module)
    assert calculate_maximum_sizes(pabs) == jmodeling.calculate_maximum_sizes(jabs)
    with pytest.raises(ValueError, match="'lm_head/kernel' not covered") as jerr:
        jmodeling.check_device_map(jabs, {"model": 0})
    with pytest.raises(ValueError, match=re.escape(str(jerr.value))):
        check_device_map(pabs, {"model": CPU})
    dm = {"": CPU, "model/layers": "disk", "model/layers/block/mlp": "cpu"}
    for name in ("lm_head/kernel", "model/layers/block/mlp/up_proj/kernel",
                 "model/layers/block/self_attn/q_proj/kernel"):
        jp = jmodeling.placement_for(name, {**dm, "": 0})
        assert placement_for(name, dm) == (CPU if not isinstance(jp, str) else jp)
    host = place_tensor(np.ones((2, 2), np.float32), "cpu", torch.bfloat16)
    assert host.dtype == torch.bfloat16 and place_tensor(host, CPU).device == CPU
    ckpt = str(tmp_path / "ckpt")
    os.makedirs(ckpt)
    jsave_sharded({k: np.asarray(v) for k, v in jflatten(jmodel.params).items()}, ckpt,
                  max_shard_size=50_000)
    store, index = load_checkpoint_in_model(module, ckpt, dm, offload_folder=str(tmp_path / "p"))
    _, jindex = jmodeling.load_checkpoint_in_model(jabs, ckpt, {**dm, "": jax.devices()[0]},
                                                   offload_folder=str(tmp_path / "j"))
    assert index == jindex
    assert isinstance(store["model.layers.1.self_attn.q_proj.weight"], bm._DiskHandle)
    assert store["model.layers.0.mlp.up_proj.weight"].device == CPU
    back = joffload.OffloadedWeightsLoader(save_folder=str(tmp_path / "p"))
    for name in index:
        assert np.array_equal(np.asarray(back[name]), np.asarray(
            jflatten(jmodel.params)[name])), name
    for fqn, p in module.named_parameters():
        v = store[fqn]
        v = v.load_port() if isinstance(v, bm._DiskHandle) else v
        assert torch.equal(v, p.detach()), fqn


# ---------------------------------------------------------------------------
# The offload store
# ---------------------------------------------------------------------------


def test_offload_folders_interchange(tmp_path):
    """A folder the JAX package wrote (flax names, fp32, fp16, ml_dtypes'
    bfloat16, a scalar) read by the port, bf16 as 16-bit words viewed as
    ``torch.bfloat16``; a folder the port wrote read by the JAX package."""
    import ml_dtypes

    rng = np.random.default_rng(0)
    sd = {"model/layers_0/mlp/up_proj/kernel": rng.standard_normal((6, 4)).astype(np.float32),
          "a/half": rng.standard_normal((3, 5)).astype(np.float16),
          "a/bf16": rng.standard_normal((4, 3)).astype(ml_dtypes.bfloat16),
          "a/scalar": np.asarray(3.5, np.float32)}
    joffload.offload_state_dict(str(tmp_path / "jax"), sd)
    loader = OffloadedWeightsLoader(save_folder=str(tmp_path / "jax"))
    assert sorted(loader) == sorted(sd)
    for k, v in sd.items():
        got = loader[k]
        if k == "a/bf16":
            assert got.dtype == torch.bfloat16
            assert np.array_equal(got.view(torch.int16).numpy().view(np.uint16),
                                  v.view(np.uint16))
        else:
            assert got.shape == v.shape and np.array_equal(got.numpy(), v)
    port = {"x/w": torch.randn(5, 2), "x/b": torch.randn(7, dtype=torch.bfloat16)}
    offload_state_dict(str(tmp_path / "port"), port)
    index = load_offload_index(str(tmp_path / "port"))
    assert index["x/b"] == {"dtype": "bfloat16", "shape": [7]}
    back = joffload.OffloadedWeightsLoader(save_folder=str(tmp_path / "port"))
    assert np.array_equal(np.asarray(back["x/w"]), port["x/w"].numpy())
    raw = np.asarray(np.memmap(tmp_path / "port" / "x--b.dat", np.uint16, "r"))
    assert np.array_equal(raw, port["x/b"].view(torch.int16).numpy().view(np.uint16))
    both = OffloadedWeightsLoader(state_dict={"y/z": torch.ones(2)},
                                  save_folder=str(tmp_path / "port"))
    sub = extract_submodule_tensors(both, ["x", "y"])
    jsub = joffload.extract_submodule_tensors(back, ["x"])
    assert sorted(sub) == ["x/b", "x/w", "y/z"] and sorted(jsub) == ["x/b", "x/w"]


# ---------------------------------------------------------------------------
# Streamed forwards
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_streamed_forward_matches_jax(family, layout, tmp_path):
    """Every family, both flax layouts: the port's ``cpu_offload``,
    ``disk_offload`` and a three-tier ``dispatch_model`` against the JAX
    package's streamed (``cpu_offload``) and full forwards, and equal to
    the port's resident forward bit for bit; the streamed path ran."""
    jmodel, module, xs = _build(family, LAYOUTS[layout])
    want_full = np.asarray(jmodel(*_jax_inputs(xs)), np.float32)
    joff = jbm.cpu_offload(jmodel)
    want_streamed = np.asarray(joff(*_jax_inputs(xs)), np.float32)
    assert joff.last_stream_peak_bytes is not None
    resident = _resident(module, xs)
    abstract = compute_abstract_params(module)
    sizes = compute_module_sizes(abstract)
    tiers = infer_auto_device_map(abstract, {CPU: sizes[""] // 3, "cpu": sizes[""] // 3})
    assert {bm.placement_key(v) for v in tiers.values()} == {"cpu:0", "cpu", "disk"}
    runs = {"cpu_offload": cpu_offload(Model(module), execution_device=CPU),
            "disk_offload": disk_offload(module, str(tmp_path / "disk"), execution_device=CPU),
            "three_tiers": dispatch_model(module, tiers, offload_dir=str(tmp_path / "mixed"))}
    for name, off in runs.items():
        got = off(*_torch_inputs(xs))
        assert off.last_stream_peak_bytes is not None, name
        assert torch.equal(got, resident), name
        assert _rel(got, want_streamed) < FP32_REL and _rel(got, want_full) < FP32_REL, name
    assert runs["cpu_offload"].hbm_resident_bytes() == 0
    tier_bytes = runs["three_tiers"].tier_bytes()
    assert sum(tier_bytes.values()) == sizes[""] and runs["three_tiers"].hbm_resident_bytes() == \
        tier_bytes["cpu:0"] > 0


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_load_checkpoint_and_dispatch_of_a_jax_checkpoint(layout, tmp_path):
    """The JAX package's sharded safetensors checkpoint (several shards)
    dispatched by the port: an explicit map (embedding, norm and head on
    the device, every block on the host), ``"auto"`` over the device, the
    host and the disk, ``"balanced"`` and one device (``device_map`` of
    ``""``): the port's resident logits bit for bit, the JAX package's
    dispatch of the same checkpoint within the fp32 tolerance."""
    jmodel, module, xs = _build("llama", LAYOUTS[layout])
    ckpt = str(tmp_path / "ckpt")
    os.makedirs(ckpt)
    jsave_sharded({k: np.asarray(v) for k, v in jflatten(jmodel.params).items()}, ckpt,
                  max_shard_size=50_000)
    assert len([f for f in os.listdir(ckpt) if f.endswith(".safetensors")]) > 1
    resident = _resident(module, xs)
    meta = models.LlamaForCausalLM(module.config, device="meta")
    abstract = compute_abstract_params(meta)
    sizes = compute_module_sizes(abstract)
    explicit = {f"model/{k}": "cpu" for k in abstract["model"]}
    explicit.update({"model/embed_tokens": CPU, "model/norm": CPU, "lm_head": CPU})
    jexplicit = {k: (0 if isinstance(v, torch.device) else v) for k, v in explicit.items()}
    jdm = jbm.load_checkpoint_and_dispatch(jmodel.module, ckpt, *_jax_inputs(xs),
                                           device_map=jexplicit)
    want = np.asarray(jdm(*_jax_inputs(xs)), np.float32)
    budgets = {CPU: sizes[""] // 3, "cpu": sizes[""] // 3}
    for device_map, kw in ((explicit, {}), ("auto", {"max_memory": budgets}),
                           ("balanced", {"max_memory": budgets}), ({"": CPU}, {})):
        off = load_checkpoint_and_dispatch(meta, ckpt, device_map=device_map,
                                           offload_folder=str(tmp_path / "off"), **kw)
        got = off(*_torch_inputs(xs))
        assert torch.equal(got, resident), device_map
        assert _rel(got, want) < FP32_REL
        if device_map is explicit:
            assert sizes["model/embed_tokens"] <= off.hbm_resident_bytes() < sizes[""]
            assert off.tier_bytes()["cpu"] == sum(sizes[f"model/{k}"] for k in abstract["model"]
                                                  if k not in ("embed_tokens", "norm"))


def test_stream_peak_is_two_layers(tmp_path):
    """An 8-layer GPT-NeoX on the host: the largest sum of groups resident
    at once is the non-layer groups plus two blocks (the JAX package's test
    allows three), and less than the model. Host tensors are read in place
    on the host; from the disk every byte is copied once a forward."""
    jc, jm, pc, pm, _ = FAMILIES["neox"]
    module = pm(pc.tiny(dtype=torch.float32, num_hidden_layers=8))
    ids = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (2, 12)))
    total = sum(p.numel() * 4 for p in module.parameters())
    per_layer = sum(p.numel() * 4 for p in module.gpt_neox.layers[0].parameters())
    non_layer = total - 8 * per_layer
    off = cpu_offload(module, execution_device=CPU)
    off(ids)
    assert non_layer + per_layer <= off.last_stream_peak_bytes <= non_layer + 2 * per_layer
    assert off.last_stream_peak_bytes < total
    assert off.last_stream_copied_bytes == 0
    disk = disk_offload(module, str(tmp_path), execution_device=CPU)
    disk(ids)
    assert disk.last_stream_copied_bytes == total


def test_streamed_equals_resident_for_every_chassis_knob():
    """The Llama chassis knobs the JAX package's streamed forward drops
    (Granite's ``embedding_multiplier`` and ``logits_scaling``, a
    ``layernorm`` chassis) and the rest (Gemma's plus-one RMSNorm and
    embedding scale, GeGLU, biases, an ungated MLP, partial rotary, the
    flash wrapper's plain version on the CPU): the port's streamed logits
    equal its resident ones bit for bit and the JAX package's resident
    ones within the fp32 tolerance. The JAX package's own streamed logits
    miss its resident ones by the recorded gaps (the reference's fault)."""
    knob_sets = {
        "granite": dict(embedding_multiplier=12.0, logits_scaling=8.0, residual_multiplier=0.22,
                        attention_multiplier=0.0078125),
        "layernorm": dict(norm_type="layernorm", mlp_gated=False, hidden_act="gelu",
                          attention_bias=True, attention_out_bias=True, mlp_bias=True,
                          partial_rotary_factor=0.5),
        "gemma": dict(rms_norm_plus_one=True, scale_embeddings=True, hidden_act="gelu_tanh",
                      tie_word_embeddings=True),
    }
    jax_gaps = {}
    for name, knobs in knob_sets.items():
        jmodel, module, xs = _build("llama", False, **knobs)
        resident = _resident(module, xs)
        got = cpu_offload(module, execution_device=CPU)(*_torch_inputs(xs))
        assert torch.equal(got, resident), name
        want = np.asarray(jmodel(*_jax_inputs(xs)), np.float32)
        assert _rel(got, want) < FP32_REL, name
        jax_gaps[name] = _rel(jbm.cpu_offload(jmodel)(*_jax_inputs(xs)), want)
    # Granite's two constants and the layernorm chassis: the JAX spec's
    # logits are far from its module's; Gemma's knobs it applies.
    assert jax_gaps["granite"] > 0.5 and jax_gaps["layernorm"] > 0.05, jax_gaps
    assert jax_gaps["gemma"] < FP32_REL, jax_gaps
    module = models.LlamaForCausalLM(models.LlamaConfig.tiny(dtype=torch.float32,
                                                             attention_impl="flash"))
    module.load_state_dict(_weights(module))
    ids = np.random.default_rng(2).integers(0, 256, (2, 16))
    assert torch.equal(cpu_offload(module, execution_device=CPU)(*_torch_inputs((ids,))),
                       _resident(module, (ids,)))


def test_fallback_warns_once_and_plans_register(caplog):
    """A class without a spec warns once and materialises (the output of
    the resident module); a call with keyword arguments falls back too; a
    registered stream plan, and then a registered spec of ``Seg`` and
    ``LayerSeg``, run instead."""
    torch.manual_seed(0)
    net = torch.nn.Sequential(torch.nn.Linear(8, 16), torch.nn.ReLU(), torch.nn.Linear(16, 4))
    x = torch.randn(2, 8)
    off = cpu_offload(net, execution_device=CPU)
    bm._warned_fallback.discard("Sequential")
    with caplog.at_level(logging.WARNING):
        got = off(x)
        off(x)
    assert torch.equal(got, net(x).detach())
    assert sum("no stream plan" in r.message for r in caplog.records) == 1
    jmodel, module, xs = _build("t5", False)
    ids, dec = _torch_inputs(xs)
    mask = (ids != 0).to(torch.int32)
    with caplog.at_level(logging.WARNING):
        got = cpu_offload(module, execution_device=CPU)(ids, dec, attention_mask=mask)
    assert torch.equal(got, _resident(module, (xs[0], xs[1])))
    assert any("keyword arguments" in r.message for r in caplog.records)

    def plan(module, resolver, x):
        return torch.nn.functional.linear(x, **resolver.take("0"))

    bm.register_stream_plan("Sequential", plan)
    try:
        assert torch.equal(off(x), torch.nn.functional.linear(x, net[0].weight, net[0].bias))
        assert off.last_stream_peak_bytes == 16 * 8 * 4 + 16 * 4
    finally:
        bm._STREAM_PLANS.pop("Sequential")

    def spec(module):
        """Two Linear layers as a stream of blocks: every group streamed."""
        return [bm.Seg("first", ["0"], lambda params, x: torch.relu(
                    torch.func.functional_call(module[0], params[0], (x,)))),
                bm.LayerSeg("last", "{i}", 1, lambda p, h: torch.func.functional_call(
                    module[2], p, (h,)), offset=2)]

    bm.register_stream_spec("Sequential", spec)
    try:
        assert torch.equal(off(x), net(x).detach())
        assert off.last_stream_peak_bytes == max(16 * 8 * 4 + 16 * 4, 8 * 16 * 4 + 8 * 4)
    finally:
        bm._STREAM_SPECS.pop("Sequential")


def test_cpu_offload_with_hook_chaining():
    """Parameters stay on the execution device between forwards;
    ``offload()`` evicts; loading model 2 offloads model 1 through its
    ``prev_module_hook``; outputs are the modules' own."""
    torch.manual_seed(0)
    m1 = torch.nn.Sequential(torch.nn.Linear(8, 16), torch.nn.ReLU(), torch.nn.Linear(16, 8))
    m2 = torch.nn.Sequential(torch.nn.Linear(8, 16), torch.nn.ReLU(), torch.nn.Linear(16, 8))
    x = torch.randn(2, 8)
    with torch.no_grad():
        want = m2(m1(x))
    h1, hook1 = cpu_offload_with_hook(Model(m1), execution_device=CPU)
    h2, hook2 = cpu_offload_with_hook(Model(m2), execution_device=CPU, prev_module_hook=hook1)
    assert not h1._on_device and not h2._on_device
    with torch.no_grad():
        y = h2(h1(x))
    assert torch.equal(y, want)
    assert not h1._on_device and h2._on_device
    hook2.offload()
    assert not h2._on_device
    hook1.remove()
    with torch.no_grad():
        h1(x)
    assert not h1._on_device


def test_verify_device_map_and_prepare_refuses_a_dispatched_model(tmp_path):
    """``verify_device_map`` is true for a model over more than one
    placement, and ``prepare`` refuses it; one placement passes."""
    module = models.LlamaForCausalLM(models.LlamaConfig.tiny(dtype=torch.float32))
    acc = Accelerator(cpu=True)
    multi = dispatch_model(module, {"model": "cpu", "lm_head": CPU})
    single = dispatch_model(module, {"": CPU})
    assert acc.verify_device_map(multi) and not acc.verify_device_map(single)
    assert not acc.verify_device_map(Model(module))
    with pytest.raises(ValueError, match="multi-placement device_map"):
        acc.prepare(multi, adamw(1e-3))
