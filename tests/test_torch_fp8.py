"""The port's fp8 matmuls (``accelerate_tpu_torch/ops/fp8.py``) and fp8 Llama
against the JAX package's ``accelerate_tpu/ops/fp8.py``, on the CPU (the
plain version of the fp8 product: the codes in fp32, a matrix product,
times both scales, as the JAX package computes it on the CPU).

Tolerances: the fp8 codes and scales are equal bit for bit. In fp32 the
linear's output and gradients agree within rtol 1e-5 of the largest value
(the same codes, summed in another order); in bf16 within one bf16 step
(2^-7 of the largest value). The tiny fp8 Llama's losses agree within rtol
5e-3 and its grad norms within 2e-2 over 3 steps: bf16 rounds at other
places in the two packages, and a one-ulp bf16 difference before a
quantization can move a code by a whole fp8 step (observed 1.4e-3 and
8.8e-3; the bf16 model without fp8 differs by 2.4e-4 and 9.7e-4).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from accelerate_tpu import Accelerator as JaxAccelerator
from accelerate_tpu import Model as JaxModel
from accelerate_tpu.models import LlamaConfig as JaxLlamaConfig
from accelerate_tpu.models import LlamaForCausalLM as JaxLlama
from accelerate_tpu.models import cross_entropy_loss as jax_cross_entropy
from accelerate_tpu.ops import fp8 as jfp8
from accelerate_tpu.utils import FP8RecipeKwargs as JaxFP8RecipeKwargs
from accelerate_tpu_torch import Accelerator, FP8RecipeKwargs, Model, adamw
from accelerate_tpu_torch.models import (
    LlamaConfig,
    LlamaForCausalLM,
    cross_entropy_loss,
    llama_params_from_flax,
)
from accelerate_tpu_torch.ops import fp8
from accelerate_tpu_torch.state import AcceleratorState, GradientState, PartialState


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the driver runs several test processes at once,
    and torch's spinning thread pools would contend for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


WIDTH = dict(num_hidden_layers=2, hidden_size=64)
_F8 = {"e4m3": (jnp.float8_e4m3fn, torch.float8_e4m3fn, fp8.E4M3_MAX),
       "e5m2": (jnp.float8_e5m2, torch.float8_e5m2, fp8.E5M2_MAX)}


def _reset():
    from accelerate_tpu.state import AcceleratorState as JS
    from accelerate_tpu.state import GradientState as JG

    for cls in (AcceleratorState, GradientState, PartialState, JS, JG):
        cls._reset_state()


@pytest.fixture(autouse=True)
def reset_state():
    _reset()
    yield
    _reset()


def _codes(t):
    return t.view(torch.uint8).numpy() if torch.is_tensor(t) else np.asarray(t).view(np.uint8)


@pytest.mark.parametrize("fmt", ["e4m3", "e5m2"])
@pytest.mark.parametrize("shape,scale,dtype", [
    ((16, 32), 3.0, "float32"), ((7, 13), 1e-3, "float32"), ((3, 5, 64), 40.0, "float32"),
    ((64, 48), 5.0, "bfloat16"), ((8, 8), 0.0, "float32"),   # the zero tensor: scale 1
])
def test_quant_codes_and_scales_equal_jax(fmt, shape, scale, dtype):
    jdt, tdt, fmax = _F8[fmt]
    x = (np.random.default_rng(0).standard_normal(shape) * scale).astype(np.float32)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    q, s = fp8._quant(xt, tdt)
    jq, js = jfp8._quant(jnp.asarray(xt.float().numpy()).astype(dtype), jdt, fmax)
    assert q.dtype == tdt and q.shape == xt.shape and s.dtype == torch.float32
    np.testing.assert_array_equal(_codes(q), _codes(jq))
    assert float(s) == float(js)
    if scale == 0.0:
        assert float(s) == 1.0 and not (_codes(q) & 0x7F).any()   # signed zeros


def _linear_case(dtype, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 24, 32)).astype(np.float32)
    w = rng.standard_normal((32, 48)).astype(np.float32) * 0.1    # JAX's (in, out) kernel
    g = rng.standard_normal((2, 24, 48)).astype(np.float32)
    cast = lambda a: jnp.asarray(a).astype(dtype)  # noqa: E731
    return x, w, g, cast


def _jax_linear(fmt, native, x, w, g):
    dg = jfp8.fp8_dot_general(fmt, native=native)
    y, vjp = jax.vjp(lambda a, b: dg(a, b, (((2,), (0,)), ((), ()))), x, w)
    dx, dw = vjp(g)
    return [np.asarray(t.astype(jnp.float32)) for t in (y, dx, dw)]


def _port_linear(fmt, native, x, w, g, dtype):
    xt = torch.from_numpy(np.array(x.astype(jnp.float32))).to(dtype).requires_grad_()
    wt = torch.from_numpy(np.array(w.astype(jnp.float32)).T.copy()).to(dtype).requires_grad_()
    y = fp8.fp8_dot_general(fmt, native=native)(xt, wt)
    y.backward(torch.from_numpy(np.array(g.astype(jnp.float32))).to(dtype))
    assert y.dtype == xt.grad.dtype == wt.grad.dtype == dtype
    return [t.float().numpy() for t in (y.detach(), xt.grad, wt.grad.T)]


@pytest.mark.parametrize("native", [True, False], ids=["native", "qdq"])
@pytest.mark.parametrize("fmt", ["HYBRID", "E4M3", "E5M2"])
def test_fp8_linear_matches_jax_in_fp32(fmt, native):
    x, w, g, cast = _linear_case(jnp.float32)
    want = _jax_linear(fmt, native, cast(x), cast(w), cast(g))
    got = _port_linear(fmt, native, cast(x), cast(w), cast(g), torch.float32)
    for name, a, b in zip(("out", "dx", "dw"), got, want):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5 * np.abs(b).max(), err_msg=name)


@pytest.mark.parametrize("fmt", ["HYBRID", "E4M3"])
def test_fp8_linear_matches_jax_in_bf16(fmt):
    x, w, g, cast = _linear_case(jnp.bfloat16, seed=2)
    want = _jax_linear(fmt, True, cast(x), cast(w), cast(g))
    got = _port_linear(fmt, True, cast(x), cast(w), cast(g), torch.bfloat16)
    for name, a, b in zip(("out", "dx", "dw"), got, want):
        np.testing.assert_allclose(a, b, rtol=0, atol=2.0**-7 * np.abs(b).max(), err_msg=name)


def test_eval_mode_is_exact_without_use_during_eval():
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((8, 16)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((4, 16)).astype(np.float32))
    exact = torch.nn.functional.linear(x, w)
    linear = fp8.fp8_dot_general("HYBRID", use_during_eval=False)
    with fp8.eval_mode():
        assert fp8.in_eval_mode()
        assert torch.equal(linear(x, w), exact)
    assert not fp8.in_eval_mode()
    assert float((linear(x, w) - exact).abs().max()) > 0
    with fp8.eval_mode():
        assert float((fp8.fp8_dot_general("HYBRID", use_during_eval=True)(x, w)
                      - exact).abs().max()) > 0
    want = np.asarray(jax.lax.dot_general(jnp.asarray(x.numpy()), jnp.asarray(w.numpy().T),
                                          (((1,), (0,)), ((), ()))))
    np.testing.assert_allclose(exact.numpy(), want, rtol=1e-5, atol=1e-5)


def test_quantize_params_round_trip_matches_jax():
    rng = np.random.default_rng(3)
    w = rng.standard_normal((16, 16)).astype(np.float32)
    b = rng.standard_normal((5,)).astype(np.float32) * 1e3
    port_q, port_s = fp8.quantize_params_fp8(
        {"w": torch.from_numpy(w), "inner": {"b": torch.from_numpy(b)}, "step": 3})
    jax_q, jax_s = jfp8.quantize_params_fp8(
        {"w": jnp.asarray(w), "inner": {"b": jnp.asarray(b)}, "step": jnp.asarray(3, jnp.int32)})
    assert port_q["w"].dtype == torch.float8_e4m3fn and port_q["step"] == 3
    assert port_s["step"] is None
    np.testing.assert_array_equal(_codes(port_q["w"]), _codes(jax_q["w"]))
    np.testing.assert_array_equal(_codes(port_q["inner"]["b"]), _codes(jax_q["inner"]["b"]))
    back = fp8.dequantize_params_fp8(port_q, port_s, dtype=torch.float32)
    jax_back = jfp8.dequantize_params_fp8(jax_q, jax_s, dtype=jnp.float32)
    np.testing.assert_array_equal(back["w"].numpy(), np.asarray(jax_back["w"]))
    assert float(np.abs(back["w"].numpy() - w).max() / np.abs(w).max()) < 0.1
    assert back["step"] == 3
    q5, _ = fp8.quantize_params_fp8({"w": torch.from_numpy(w)}, torch.float8_e5m2)
    assert q5["w"].dtype == torch.float8_e5m2


def test_backend_table_and_recipe_match_jax():
    for backend in ("AUTO", "te", "AO", "qdq"):
        assert fp8.backend_to_native(backend) == jfp8.backend_to_native(backend)
    assert [fp8.backend_to_native(b) for b in ("AUTO", "TE", "AO", "QDQ")] == [
        None, True, True, False]
    for bad in ("MSAMP", "other"):
        with pytest.raises(ValueError) as port_err:
            fp8.backend_to_native(bad)
        with pytest.raises(ValueError) as jax_err:
            jfp8.backend_to_native(bad)
        assert str(port_err.value) == str(jax_err.value)
    recipe = FP8RecipeKwargs(fp8_format="e4m3", backend="te", amax_history_len=1024)
    ref = JaxFP8RecipeKwargs(fp8_format="e4m3", backend="te", amax_history_len=1024)
    assert (recipe.fp8_format, recipe.backend, recipe.native_dots) == (
        ref.fp8_format, ref.backend, ref.native_dots) == ("E4M3", "TE", True)
    for kw in (dict(fp8_format="E3M4"), dict(backend="msamp")):
        with pytest.raises(ValueError):
            FP8RecipeKwargs(**kw)
    with pytest.raises(ValueError, match="E4M3|E5M2|HYBRID"):
        fp8.fp8_dot_general("E3M4")


@pytest.mark.parametrize("subscripts,shapes", [
    ("bsd,df->bsf", ((2, 8, 16), (16, 24))),      # no batch index: the fp8 linear
    ("ij,kj->ik", ((8, 16), (24, 16))),
    ("bij,bjk->bik", ((2, 8, 16), (2, 16, 24))),  # a batch index: quantize-dequantize
])
def test_fp8_einsum_matches_jax(subscripts, shapes):
    rng = np.random.default_rng(5)
    a, b = (rng.standard_normal(s).astype(np.float32) for s in shapes)
    want = np.asarray(jfp8.fp8_einsum("HYBRID")(subscripts, jnp.asarray(a), jnp.asarray(b)))
    got = fp8.fp8_einsum("HYBRID")(subscripts, torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())


def _ids():
    return np.random.default_rng(0).integers(0, 256, (8, 17)).astype(np.int32)


def test_tiny_fp8_llama_losses_match_jax():
    """mixed_precision="fp8" with LlamaConfig(fp8=True, HYBRID), bf16
    compute, 3 steps of adamw from the same weights: losses within rtol
    5e-3, grad norms within 2e-2 (module docstring); the losses descend."""
    ids = _ids()
    jcfg = JaxLlamaConfig.tiny(dtype=jnp.bfloat16, fp8=True, **WIDTH)
    module = JaxLlama(jcfg)
    jmodel = JaxModel.from_flax(module, jax.random.key(0), ids[:2, :-1])
    params = jax.tree.map(np.asarray, jmodel.params)
    jacc = JaxAccelerator(mixed_precision="fp8")
    jacc.prepare(jmodel, optax.adamw(1e-3))
    jstep = jacc.prepare_train_step(
        lambda p, b: jax_cross_entropy(module.apply({"params": p}, b["x"]), b["y"]),
        max_grad_norm=1.0)
    jstate, want = jacc.train_state, []
    batch = {"x": jnp.asarray(ids[:, :-1]), "y": jnp.asarray(ids[:, 1:])}
    for _ in range(3):
        jstate, m = jstep(jstate, batch)
        want.append((float(m["loss"]), float(m["grad_norm"])))

    cfg = LlamaConfig.tiny(dtype=torch.bfloat16, fp8=True, **WIDTH)
    module = LlamaForCausalLM(cfg)
    module.load_state_dict(llama_params_from_flax(cfg, params))
    acc = Accelerator(mixed_precision="fp8", cpu=True)
    acc.prepare(Model(module), adamw(1e-3))
    step = acc.prepare_train_step(
        lambda m, b: cross_entropy_loss(m(b["x"].long()), b["y"].long()), max_grad_norm=1.0)
    fp8.reset_paths()
    state, got = acc.train_state, []
    for _ in range(3):
        state, m = step(state, {"x": ids[:, :-1], "y": ids[:, 1:]})
        got.append((float(m["loss"]), float(m["grad_norm"])))
    got, want = np.array(got), np.array(want)
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=5e-3)
    np.testing.assert_allclose(got[:, 1], want[:, 1], rtol=2e-2)
    assert got[-1, 0] < got[0, 0]
    # 7 projections a layer: one product forward, two backward.
    assert fp8.PATHS == {"scaled_mm": 0, "dequantized": 0, "plain": 3 * 21 * cfg.num_hidden_layers}


@pytest.mark.parametrize("policy,per_layer", [("dots", 21), ("minimal", 28)])
def test_dots_remat_keeps_the_fp8_products(policy, per_layer):
    """Under remat "dots" the fp8 products of the forward are kept, so the
    recompute runs none of them again (7 forward + 14 backward products a
    layer); "minimal" recomputes them (7 more). The gradients are those of
    the model without remat."""
    ids = torch.from_numpy(_ids()).long()
    base = LlamaForCausalLM(LlamaConfig.tiny(dtype=torch.bfloat16, fp8=True, **WIDTH))
    base.init_weights(torch.Generator().manual_seed(0))
    remat = LlamaForCausalLM(LlamaConfig.tiny(dtype=torch.bfloat16, fp8=True, remat=True,
                                              remat_policy=policy, **WIDTH))
    remat.load_state_dict(base.state_dict())

    def grads(model):
        model.zero_grad()
        fp8.reset_paths()
        cross_entropy_loss(model(ids[:, :-1]), ids[:, 1:]).backward()
        return {n: p.grad.clone() for n, p in model.named_parameters()}, fp8.PATHS["plain"]

    want, plain_count = grads(base)
    got, count = grads(remat)
    assert plain_count == 21 * WIDTH["num_hidden_layers"]
    assert count == per_layer * WIDTH["num_hidden_layers"]
    for name in want:
        torch.testing.assert_close(got[name], want[name], rtol=0, atol=0, msg=name)


def test_accelerator_fp8_dot_general_and_inference_eval_mode():
    """``Accelerator.fp8_dot_general`` is None unless mixed_precision="fp8",
    else the recipe's linear; an inference call of an fp8 Llama (autograd
    off) computes in full precision, as the JAX package's
    ``Model.__call__(train=False)``."""
    assert Accelerator(mixed_precision="bf16", cpu=True).fp8_dot_general is None
    _reset()
    acc = Accelerator(mixed_precision="fp8", cpu=True,
                      kwargs_handlers=[FP8RecipeKwargs(fp8_format="E4M3", backend="QDQ")])
    assert acc._mp_policy.compute_dtype == torch.bfloat16
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.standard_normal((4, 16)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((8, 16)).astype(np.float32))
    assert torch.equal(acc.fp8_dot_general(x, w),
                       torch.nn.functional.linear(fp8.qdq_e4m3(x), fp8.qdq_e4m3(w)))

    ids = torch.from_numpy(_ids()).long()[:, :-1]
    plain = LlamaForCausalLM(LlamaConfig.tiny(dtype=torch.bfloat16, **WIDTH))
    plain.init_weights(torch.Generator().manual_seed(0))
    model = Model(LlamaForCausalLM(LlamaConfig.tiny(dtype=torch.bfloat16, fp8=True, **WIDTH)))
    model.load_state_dict(plain.state_dict())
    with torch.no_grad():
        want = plain(ids)
        assert torch.equal(model(ids), want)
    assert not torch.equal(model(ids).detach(), want)
