"""The port's decoder chassis (every knob of ``LlamaConfig``) and
``fused_cross_entropy_loss`` against the JAX package's.

Weights are drawn with numpy from a seed in the port's layout (matrices and
the embedding of std 1/sqrt(last dim), biases and norm weights away from their initial zeros
and ones, so that every knob changes the numbers) and carried to the flax
tree with ``llama_params_to_flax``. Both packages run fp32 on the CPU.

Tolerances: logits within rtol 1e-5 and atol 1e-5 (fp32, other summation
orders); 3-step trajectories (loss and grad norm) within rtol 1e-4, as
tests/test_torch_train.py holds plain Llama; greedy tokens equal, with
every step's top-2 logit gap above 1e-4 so that equal tokens are not luck
at a near-tie. The fused loss equals the port's naive loss within rtol
1e-6 (value) and rtol 1e-5, atol 1e-5 (grads), as tests/test_llama.py
holds the JAX one.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from accelerate_tpu import Accelerator as JaxAccelerator
from accelerate_tpu import Model as JaxModel
from accelerate_tpu import ServingConfig as JaxServingConfig
from accelerate_tpu import ServingEngine as JaxServingEngine
from accelerate_tpu import generate as jax_generate
from accelerate_tpu import generation as jax_gen
from accelerate_tpu.models import LlamaConfig as JaxLlamaConfig
from accelerate_tpu.models import LlamaForCausalLM as JaxLlama
from accelerate_tpu.models import cross_entropy_loss as jax_cross_entropy
from accelerate_tpu.models import fused_cross_entropy_loss as jax_fused_loss
from accelerate_tpu.utils import quantization as jax_quant
from accelerate_tpu_torch import (
    Accelerator,
    Model,
    ServingConfig,
    ServingEngine,
    adamw,
    beam_search,
    generate,
    quantize_model_for_decode,
)
from accelerate_tpu_torch import generation as gen
from accelerate_tpu_torch.models import (
    LlamaConfig,
    LlamaForCausalLM,
    cross_entropy_loss,
    fused_cross_entropy_loss,
    llama_params_from_flax,
    llama_params_to_flax,
)
from accelerate_tpu_torch.state import AcceleratorState, GradientState, PartialState
from accelerate_tpu_torch.utils.quantization import DecodeQuant

MIN_GAP = 1e-4

GRANITE = dict(embedding_multiplier=3.0, residual_multiplier=0.5, attention_multiplier=0.08,
               logits_scaling=2.0)
# Together they set all 13 chassis knobs.
KNOBS = {
    "gemma": dict(hidden_act="gelu_tanh", rms_norm_plus_one=True, scale_embeddings=True,
                  tie_word_embeddings=True, head_dim=48),
    "qwen2_bias": dict(attention_bias=True),
    "layernorm_ungated": dict(norm_type="layernorm", mlp_gated=False, mlp_bias=True,
                              attention_out_bias=True, hidden_act="gelu"),
    "partial_rotary": dict(norm_type="layernorm", partial_rotary_factor=0.25,
                           hidden_act="relu"),
    "granite": GRANITE,
    "granite_bias": dict(GRANITE, norm_type="layernorm", attention_bias=True,
                         attention_out_bias=True, mlp_bias=True, mlp_gated=False,
                         partial_rotary_factor=0.5, hidden_act="gelu_pytorch_tanh"),
    "tied": dict(tie_word_embeddings=True, hidden_act="gelu_new"),
    "fp8_bias": dict(fp8=True, fp8_backend="QDQ", attention_bias=True, attention_out_bias=True,
                     mlp_bias=True),
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Many small torch ops: one intra-op thread keeps them from contending
    with the other test workers (restored after the module)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def reset_port_state():
    yield
    AcceleratorState._reset_state()
    GradientState._reset_state()
    PartialState._reset_state()


def _ids(b, s, seed, vocab=256):
    return np.random.default_rng(seed).integers(1, vocab, (b, s), dtype=np.int32)


def _weights(cfg, seed=0) -> dict:
    """Port state dict drawn with numpy (see the module docstring)."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, p in LlamaForCausalLM(cfg, device="meta").state_dict().items():
        if p.dim() == 2:  # (out, in), the embedding's (V, H) too
            a = rng.standard_normal(p.shape) / np.sqrt(p.shape[1])
        elif name.endswith("bias"):
            a = rng.standard_normal(p.shape) * 0.1
        else:  # norm weights: around 1, or around 0 for Gemma's w + 1
            a = rng.standard_normal(p.shape) * 0.1 + (0.0 if cfg.rms_norm_plus_one else 1.0)
        out[name] = torch.from_numpy(a.astype(np.float32))
    return out


def _flax(cfg, state_dict) -> dict:
    return jax.tree.map(lambda t: t.numpy(), llama_params_to_flax(cfg, state_dict))


def _build(knobs, seed=0, **kw):
    """(JAX config, flax params, port config, port module) on one set of
    weights."""
    jcfg = JaxLlamaConfig.tiny(dtype=jnp.float32, **knobs, **kw)
    tcfg = LlamaConfig.tiny(dtype=torch.float32, **knobs, **kw)
    sd = _weights(tcfg, seed)
    module = LlamaForCausalLM(tcfg)
    module.load_state_dict(sd)
    return jcfg, _flax(tcfg, sd), tcfg, module


def _min_greedy_gap(cfg, model, rows, prompt_len):
    rows = torch.as_tensor(np.asarray(rows)).long()
    b, t = rows.shape
    logits, _ = gen._llama_forward_cached(cfg, model, rows, gen.init_cache(cfg, b, t),
                                          return_all=True)
    top2 = torch.topk(logits[:, prompt_len - 1:t - 1], 2, dim=-1).values
    return float((top2[..., 0] - top2[..., 1]).min())


# ---------------------------------------------------------------------------
# The module
# ---------------------------------------------------------------------------


# The knob sets that change what attention itself is given: Gemma's head
# dim of 48 (which the kernels pad) over grouped KV heads, and Granite's
# attention multiplier (folded into q) with partial rotary. The others
# reach attention only through projections and norms that the native pass
# already holds.
FLASH_KNOBS = ("gemma", "granite_bias")


@pytest.mark.parametrize("name", sorted(set(KNOBS) - {"fp8_bias"}))
def test_logits_match_jax(name):
    """Logits of every knob set against the JAX module with attention
    native, and for FLASH_KNOBS with flash too (the plain version of the
    kernels here, Pallas in interpret mode there)."""
    ids = _ids(2, 24, seed=1)
    for impl in ("native", "flash") if name in FLASH_KNOBS else ("native",):
        jcfg, params, _, module = _build(KNOBS[name], attention_impl=impl)
        want = np.asarray(JaxLlama(jcfg).apply({"params": params}, jnp.asarray(ids)))
        with torch.no_grad():
            got = module(torch.from_numpy(ids).long()).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5, err_msg=impl)


def test_fp8_projections_with_biases_match_jax():
    """fp8 (QDQ) with biases. On one input the fp8 projections quantize the
    same values to the same codes, so a projection and its bias, forward
    and backward, agree within 1e-5 of the largest value, as
    tests/test_torch_fp8.py holds the fp8 linear. Through the model each
    package's fp32 sums round differently before the next quantization, and
    a value at a code boundary moves by a whole fp8 step, so there the loss
    is held within rtol 5e-3, as tests/test_torch_fp8.py holds the fp8
    Llama's."""
    import flax.linen as nn

    jcfg, params, cfg, module = _build(KNOBS["fp8_bias"], attention_impl="native")
    x = np.random.default_rng(13).standard_normal((2, 6, cfg.hidden_size)).astype(np.float32)
    g = np.random.default_rng(14).standard_normal((2, 6, 4, cfg.head_dim)).astype(np.float32)
    attn = module.model.layers[0].self_attn.q_proj
    dense = nn.DenseGeneral(features=(4, cfg.head_dim), use_bias=True, dtype=jnp.float32,
                            dot_general=jcfg.dot_general)
    p0 = params["model"]["layers"]["block"]["self_attn"]["q_proj"]
    p0 = jax.tree.map(lambda t: t[0], p0)
    want, vjp = jax.vjp(lambda p, xx: dense.apply({"params": p}, xx), p0, jnp.asarray(x))
    dp, dx = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_()
    got = attn(xt).view(2, 6, 4, -1)
    got.backward(torch.from_numpy(g))
    pairs = [(got.detach(), want), (xt.grad, dx), (attn.bias.grad.view(4, -1), dp["bias"]),
             (attn.weight.grad.t().reshape(cfg.hidden_size, 4, -1), dp["kernel"])]
    for a, b in pairs:
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-5 * np.abs(b).max())

    ids = _ids(4, 17, seed=1)
    want = float(jax.jit(lambda p: jax_cross_entropy(JaxLlama(jcfg).apply({"params": p},
                                                                         ids[:, :-1]),
                                                     ids[:, 1:]))(params))
    with torch.no_grad():
        got = float(cross_entropy_loss(module(torch.from_numpy(ids[:, :-1]).long()),
                                       torch.from_numpy(ids[:, 1:]).long()))
    np.testing.assert_allclose(got, want, rtol=5e-3)


def test_every_knob_is_covered_and_validated():
    knobs = {k for kw in KNOBS.values() for k in kw
             if k not in ("head_dim", "tie_word_embeddings", "fp8", "fp8_backend")}
    assert len(knobs) == 13, sorted(knobs)
    with pytest.raises(ValueError, match="hidden_act"):
        LlamaConfig.tiny(hidden_act="swish")


@pytest.mark.parametrize("scan_layers", [True, False])
def test_convert_round_trips_every_knob(scan_layers):
    for name, knobs in KNOBS.items():
        cfg = LlamaConfig.tiny(dtype=torch.float32, scan_layers=scan_layers, **knobs)
        sd = _weights(cfg)
        back = llama_params_from_flax(cfg, llama_params_to_flax(cfg, sd))
        assert back.keys() == sd.keys(), name
        for k in sd:
            assert torch.equal(back[k], sd[k]), (name, k)


def test_init_weights_match_flax_initialisers():
    """Zeros for a plus-one norm's weight and every bias, ones for the other
    norm weights (LayerNorm and RMSNorm), as flax initialises them."""
    ids = _ids(1, 8, seed=2)
    for name in ("gemma", "granite_bias"):
        jcfg, _, tcfg, module = _build(KNOBS[name])
        init = jax.jit(JaxLlama(jcfg).init)(jax.random.key(0), ids)["params"]
        flax_init = llama_params_from_flax(tcfg, jax.tree.map(np.asarray, init))
        module.init_weights(torch.Generator().manual_seed(0))
        for k, p in module.state_dict().items():
            assert p.shape == flax_init[k].shape, (name, k)
            if p.dim() == 1:
                assert torch.equal(p, flax_init[k]), (name, k)


def test_fsdp2_leaves_biases_and_norm_parameters_whole():
    """Under FSDP2 the rank-1 rule keeps every bias and LayerNorm parameter
    whole, as it does the norm scales; the matrices are the ones it
    shards."""
    from accelerate_tpu_torch import FullyShardedDataParallelPlugin
    from accelerate_tpu_torch.parallel.fsdp import whole_parameters

    module = LlamaForCausalLM(LlamaConfig.tiny(**KNOBS["granite_bias"]), device="meta")
    whole = whole_parameters(module, FullyShardedDataParallelPlugin(min_weight_size_to_shard=0),
                             shard_count=2)
    params = dict(module.named_parameters())
    assert {n for n, p in params.items() if p.dim() == 1} == set(whole)
    assert any(n.endswith("self_attn.q_proj.bias") for n in whole)
    assert any(n.endswith("input_layernorm.bias") for n in whole)


# ---------------------------------------------------------------------------
# Training: 3 steps against the JAX Accelerator
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["gemma", "granite_bias"])
def test_three_steps_match_jax_accelerator(name):
    rng = np.random.default_rng(3)
    batches = [rng.integers(0, 256, (8, 17), dtype=np.int32) for _ in range(3)]
    jcfg, params, tcfg, module = _build(KNOBS[name])
    jmodule = JaxLlama(jcfg)
    jacc = JaxAccelerator()
    jacc.prepare(JaxModel(module=jmodule, params=params), optax.adamw(1e-3))
    jstep = jacc.prepare_train_step(
        lambda p, b: jax_cross_entropy(jmodule.apply({"params": p}, b["x"]), b["y"]),
        max_grad_norm=1.0)
    jstate, want = jacc.train_state, []
    for ids in batches:
        jstate, m = jstep(jstate, {"x": jnp.asarray(ids[:, :-1]), "y": jnp.asarray(ids[:, 1:])})
        want.append((float(m["loss"]), float(m["grad_norm"])))

    acc = Accelerator(cpu=True)
    acc.prepare(Model(module), adamw(1e-3))
    step = acc.prepare_train_step(
        lambda m, b: cross_entropy_loss(m(b["x"].long()), b["y"].long()), max_grad_norm=1.0)
    state, got = acc.train_state, []
    for ids in batches:
        state, m = step(state, {"x": ids[:, :-1], "y": ids[:, 1:]})
        got.append((float(m["loss"]), float(m["grad_norm"])))
    np.testing.assert_allclose(np.array(got), np.array(want), rtol=1e-4)


# ---------------------------------------------------------------------------
# Generation and serving
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["gemma", "granite_bias"])
def test_generate_beam_search_and_engine_match_jax(name):
    """Greedy ``generate`` (a plain batch, and through ``forward_cached=``
    and a decode-quantized copy), ``beam_search`` and the engine against
    the JAX package's tokens."""
    jcfg, params, cfg, module = _build(KNOBS[name], seed=4, attention_impl="native")
    jmodel = JaxModel(module=JaxLlama(jcfg), params=params)
    ids = _ids(2, 6, seed=5)
    want = np.asarray(jax_generate(jmodel, ids, max_new_tokens=8))
    got = generate(module, ids, max_new_tokens=8)
    assert _min_greedy_gap(cfg, module, got, 6) > MIN_GAP
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        generate(module, ids, max_new_tokens=8, forward_cached=gen._llama_forward_cached), got)
    # int8 weights: the block projections only (biases, norms, the tied or
    # untied head stay), tokens equal to the JAX package's int8 decode.
    q = quantize_model_for_decode(module)
    for n, t in q.params.items():
        assert isinstance(t, DecodeQuant) == (".layers." in n and n.endswith("_proj.weight")), n
    got_q = generate(q, ids, max_new_tokens=8)
    assert _min_greedy_gap(cfg, q, got_q, 6) > MIN_GAP
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(
        jax_generate(jax_quant.quantize_model_for_decode(jmodel), ids, max_new_tokens=8)))

    np.testing.assert_array_equal(
        beam_search(module, ids, 5, num_beams=3).numpy(),
        np.asarray(jax_gen.beam_search(jmodel, ids, 5, num_beams=3)))

    prompts = [_ids(1, n, seed=6 + n)[0] for n in (3, 7, 5)]
    budgets = [5, 3, 6]
    kw = dict(n_slots=2, max_len=32, prefill_chunks=[4, 8])
    rows = ServingEngine(module, ServingConfig(**kw)).run(prompts, max_new_tokens=budgets)
    jrows = JaxServingEngine(jmodel, JaxServingConfig(**kw)).run(prompts,
                                                                  max_new_tokens=budgets)
    for prompt, row, jrow in zip(prompts, rows, jrows):
        assert _min_greedy_gap(cfg, module, np.asarray(row)[None], len(prompt)) > MIN_GAP
        np.testing.assert_array_equal(np.asarray(row), np.asarray(jrow))


def test_engine_and_beam_search_take_forward_cached():
    """``forward_cached=`` is the plan that runs (the registry's otherwise):
    a counting wrapper sees every call."""
    _, _, cfg, module = _build(KNOBS["qwen2_bias"], attention_impl="native")
    calls = []

    def counted(*args, **kwargs):
        calls.append(1)
        return gen._llama_forward_cached(*args, **kwargs)

    ids = _ids(1, 5, seed=7)
    beams = beam_search(module, ids, 3, num_beams=2, forward_cached=counted)
    assert len(calls) == 3 and torch.equal(beams, beam_search(module, ids, 3, num_beams=2))
    engine = ServingEngine(module, ServingConfig(n_slots=1, max_len=16), forward_cached=counted)
    row = engine.run([ids[0]], max_new_tokens=[3])[0]
    assert len(calls) > 3
    np.testing.assert_array_equal(np.asarray(row), generate(module, ids, 3)[0].numpy())


# ---------------------------------------------------------------------------
# fused_cross_entropy_loss
# ---------------------------------------------------------------------------


def _labels(ids, seed):
    labels = np.asarray(ids, np.int64).copy()
    labels[np.random.default_rng(seed).random(labels.shape) < 0.25] = -100
    return torch.from_numpy(labels)


def _loss_and_grads(module, fn):
    module.zero_grad(set_to_none=True)
    loss = fn()
    loss.backward()
    return float(loss.detach()), {n: p.grad.clone() for n, p in module.named_parameters()}


@pytest.mark.parametrize("name", ["untied", "tied", "granite"])
@pytest.mark.parametrize("seq", [24, 20], ids=["chunks", "odd_tail"])
def test_fused_loss_equals_the_naive_loss(name, seq):
    knobs = {"untied": {}, "tied": KNOBS["tied"], "granite": GRANITE}[name]
    _, _, _, module = _build(knobs)
    ids = torch.from_numpy(_ids(2, seq, seed=8)).long()
    labels = _labels(ids, seed=9)
    naive, g_naive = _loss_and_grads(module, lambda: cross_entropy_loss(module(ids), labels))
    fused, g_fused = _loss_and_grads(
        module, lambda: fused_cross_entropy_loss(Model(module), ids, labels, chunk_size=8))
    np.testing.assert_allclose(fused, naive, rtol=1e-6)
    for k in g_naive:
        torch.testing.assert_close(g_fused[k], g_naive[k], rtol=1e-5, atol=1e-5, msg=k)


@pytest.mark.parametrize("tied", [False, True])
def test_fused_loss_matches_jax(tied):
    knobs = {"tie_word_embeddings": tied}
    jcfg, params, cfg, module = _build(knobs)
    ids = _ids(2, 24, seed=10)
    labels = _labels(ids, seed=11)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jax_fused_loss(jcfg, p, jnp.asarray(ids), jnp.asarray(labels.numpy()),
                                 chunk_size=8)))(params)
    loss, grads = _loss_and_grads(module, lambda: fused_cross_entropy_loss(
        module, torch.from_numpy(ids).long(), labels, chunk_size=8))
    np.testing.assert_allclose(loss, float(jloss), rtol=1e-5)
    want = llama_params_from_flax(cfg, jax.tree.map(np.asarray, jgrads))
    for k, g in grads.items():
        torch.testing.assert_close(g, want[k], rtol=1e-4, atol=1e-6, msg=k)


def test_fused_loss_in_the_train_step_matches_the_naive_step():
    """One fused-loss step of the Accelerator is the naive loss's step."""
    ids = _ids(4, 17, seed=12)
    batch = {"x": ids[:, :-1], "y": ids[:, 1:]}
    metrics = []
    for fn in (lambda m, b: cross_entropy_loss(m(b["x"].long()), b["y"].long()),
               lambda m, b: fused_cross_entropy_loss(m, b["x"].long(), b["y"].long(),
                                                     chunk_size=4)):
        _, _, _, module = _build(KNOBS["gemma"])
        acc = Accelerator(cpu=True)
        acc.prepare(Model(module), adamw(1e-3))
        _, m = acc.prepare_train_step(fn, max_grad_norm=1.0)(acc.train_state, batch)
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
        for cls in (AcceleratorState, GradientState, PartialState):
            cls._reset_state()
    np.testing.assert_allclose(metrics[1], metrics[0], rtol=1e-5)
