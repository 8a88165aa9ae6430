"""The port's weight-only int8 / NF4 quantization (the weight-only half of
``accelerate_tpu_torch/utils/quantization.py``) against the JAX package's,
on the CPU.

Weights are drawn with numpy from a seed. Codes and scales are compared on
the same flax-layout weights (a torch ``(out, in)`` weight quantizes as its
transpose) and must be equal bit for bit, stacked layers and padded groups
included; dequantized values too. ``load_and_quantize_model`` on a tiny
Llama (both flax layouts, fp32 compute): the quantized trees equal the JAX
package's leaf for leaf, ``quantized_nbytes`` equal, logits within 1e-4
relative (L2) of the JAX quantized model's; against the full-precision
logits the JAX package's own gates (cosine above 0.999 for int8 and 0.94
for NF4, int8 argmax agreement at least 0.8, bytes under 0.45x and 0.35x
of the fp32 model's).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accelerate_tpu import Model as JaxModel
from accelerate_tpu.models import LlamaConfig as JaxLlamaConfig
from accelerate_tpu.models import LlamaForCausalLM as JaxLlama
from accelerate_tpu.utils import quantization as jq
from accelerate_tpu_torch import Model
from accelerate_tpu_torch.models import LlamaConfig, LlamaForCausalLM, convert
from accelerate_tpu_torch.utils import quantization as pq


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


SHAPES = [(128, 64), (2, 128, 64), (64, 4, 32), (130, 48), (2, 128, 48), (3, 70, 16)]


@pytest.mark.parametrize("shape", SHAPES, ids=["x".join(map(str, s)) for s in SHAPES])
def test_codes_and_scales_equal_jax(shape):
    """int8 and NF4 (group 64, and 32) codes, scales and dequantized values
    bit-equal to the JAX package's on the same weights."""
    w = np.random.default_rng(sum(shape)).standard_normal(shape).astype(np.float32)
    w[..., 0] = 0.0  # an all-zero output feature takes scale 1
    for got, want in ((pq.quantize_tensor_int8(torch.from_numpy(w)),
                       jq.quantize_tensor_int8(jnp.asarray(w))),
                      (pq.quantize_tensor_int4(torch.from_numpy(w)),
                       jq.quantize_tensor_int4(jnp.asarray(w))),
                      (pq.quantize_tensor_int4(torch.from_numpy(w), 32),
                       jq.quantize_tensor_int4(jnp.asarray(w), 32))):
        assert got.data.dtype == {8: torch.int8, 4: torch.uint8}[got.bits]
        assert np.array_equal(got.data.numpy(), np.asarray(want.data))
        assert np.array_equal(got.scales.numpy(), np.asarray(want.scales))
        assert (got.shape, got.bits, got.group_size) == (want.shape, want.bits, want.group_size)
        assert got.nbytes_packed == want.nbytes_packed
        for dtype, jdtype in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
            back = pq.dequantize_tensor(got, dtype)
            jback = np.asarray(jq.dequantize_tensor(want, jdtype).astype(jnp.float32))
            assert back.dtype == dtype and np.array_equal(back.float().numpy(), jback)


def test_unpack_and_params_filters():
    """Nibble unpacking exact; ``quantize_params`` keeps 1-D, small and
    skipped leaves and casts ``keep_in_fp32_modules`` as the JAX one does;
    ``dequantize_params``; the config's refusals."""
    vals = torch.from_numpy(np.arange(16, dtype=np.uint8).repeat(2)[:28].reshape(28, 1))
    assert torch.equal(pq._unpack_int4((vals[1::2] << 4) | vals[0::2]), vals)
    rng = np.random.default_rng(2)
    params = {"mlp": {"kernel": rng.standard_normal((128, 64)).astype(np.float32)},
              "norm": {"scale": np.ones((128,), np.float32)},
              "small": {"kernel": np.ones((4, 4), np.float32)},
              "head": {"kernel": rng.standard_normal((128, 64)).astype(np.float32)},
              "keep": {"kernel": rng.standard_normal((64, 64)).astype(np.float16)}}
    cfg = pq.QuantizationConfig(load_in_8bit=True, skip_modules=["head"],
                                keep_in_fp32_modules=["keep"])
    jcfg = jq.QuantizationConfig(load_in_8bit=True, skip_modules=["head"],
                                 keep_in_fp32_modules=["keep"])
    got = pq.quantize_params(params, cfg)
    want = jq.quantize_params(jax.tree.map(jnp.asarray, params), jcfg)
    assert pq.is_quantized(got["mlp"]["kernel"])
    assert not any(pq.is_quantized(got[k][leaf]) for k, leaf in
                   (("norm", "scale"), ("small", "kernel"), ("head", "kernel"), ("keep", "kernel")))
    assert got["keep"]["kernel"].dtype == torch.float32
    assert np.array_equal(got["mlp"]["kernel"].data.numpy(), np.asarray(want["mlp"]["kernel"].data))
    assert pq.quantized_nbytes(got) == jq.quantized_nbytes(want)
    back = pq.dequantize_params(got, torch.float32)
    jback = jq.dequantize_params(want, jnp.float32)
    assert np.array_equal(back["mlp"]["kernel"].numpy(), np.asarray(jback["mlp"]["kernel"]))
    for bad in (dict(load_in_8bit=True, load_in_4bit=True), {},
                dict(load_in_4bit=True, group_size=63)):
        with pytest.raises(ValueError):
            pq.QuantizationConfig(**bad)
    assert pq.BnbQuantizationConfig is pq.QuantizationConfig


def _llama(scan_layers):
    cfg = LlamaConfig.tiny(dtype=torch.float32, scan_layers=scan_layers, attention_impl="native")
    module = LlamaForCausalLM(cfg)
    rng = np.random.default_rng(0)
    with torch.no_grad():
        for name, p in module.named_parameters():
            a = (rng.standard_normal(p.shape) / np.sqrt(p.shape[-1]) if p.dim() == 2
                 else 1.0 + 0.1 * rng.standard_normal(p.shape))
            p.copy_(torch.from_numpy(a.astype(np.float32)))
    tree = jax.tree.map(lambda t: t.detach().numpy(), convert.llama_params_to_flax(cfg, dict(
        module.named_parameters())))
    jmodule = JaxLlama(JaxLlamaConfig.tiny(dtype=jnp.float32, scan_layers=scan_layers,
                                           attention_impl="native"))
    ids = rng.integers(0, cfg.vocab_size, (2, 16))
    return module, JaxModel(module=jmodule, params=jax.tree.map(jnp.asarray, tree)), ids


@pytest.mark.parametrize("layout", ["stacked", "unrolled"])
@pytest.mark.parametrize("bits", [8, 4])
def test_load_and_quantize_model_matches_jax(bits, layout):
    """The quantized tree, its bytes and the logits against the JAX
    package's; the JAX package's gates against full precision; the model
    passed in untouched; ``train=True`` refused."""
    module, jmodel, ids = _llama(layout == "stacked")
    with torch.no_grad():
        ref = module(torch.from_numpy(ids)).numpy()
    before = {k: v.clone() for k, v in module.state_dict().items()}
    kw = dict(load_in_8bit=bits == 8, load_in_4bit=bits == 4)
    qm = pq.load_and_quantize_model(Model(module),
                                    pq.QuantizationConfig(compute_dtype=torch.float32, **kw))
    jqm = jq.load_and_quantize_model(jmodel, jq.QuantizationConfig(compute_dtype=jnp.float32,
                                                                   **kw))
    assert qm.quantization_config.skip_modules == ["lm_head", "embed"]
    got_leaves = jax.tree_util.tree_leaves_with_path(
        qm.params, is_leaf=pq.is_quantized)
    want_leaves = jax.tree_util.tree_leaves_with_path(
        jqm.params, is_leaf=jq.is_quantized)
    assert [p for p, _ in got_leaves] == [p for p, _ in want_leaves]
    for (path, g), (_, w) in zip(got_leaves, want_leaves):
        assert pq.is_quantized(g) == jq.is_quantized(w), path
        if pq.is_quantized(g):
            assert np.array_equal(g.data.numpy(), np.asarray(w.data)), path
            assert np.array_equal(g.scales.numpy(), np.asarray(w.scales)), path
        else:
            assert np.array_equal(g.detach().numpy(), np.asarray(w)), path
    assert pq.quantized_nbytes(qm.params) == jq.quantized_nbytes(jqm.params)
    got = qm(torch.from_numpy(ids)).numpy()
    want = np.asarray(jqm(jnp.asarray(ids, jnp.int32)), np.float32)
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 1e-4
    full_bytes = sum(p.numel() * 4 for p in module.parameters())
    assert pq.quantized_nbytes(qm.params) < full_bytes * (0.45 if bits == 8 else 0.35)
    cos = np.sum(got * ref) / (np.linalg.norm(got) * np.linalg.norm(ref))
    assert cos > (0.999 if bits == 8 else 0.94), cos
    if bits == 8:
        assert np.mean(np.argmax(got, -1) == np.argmax(ref, -1)) >= 0.8
    assert all(torch.equal(v, before[k]) for k, v in module.state_dict().items())
    with pytest.raises(ValueError, match="inference-only"):
        qm(torch.from_numpy(ids), train=True)
