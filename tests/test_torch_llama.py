"""The port's Llama (accelerate_tpu_torch/models) against the JAX package's.

Weights are initialised by the flax module, carried over with
``llama_params_from_flax``, and both models run the same numpy-seeded ids
in fp32 on the CPU.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from accelerate_tpu.models import LlamaConfig as JaxLlamaConfig
from accelerate_tpu.models import LlamaForCausalLM as JaxLlama
from accelerate_tpu.models import llama as jax_llama
from accelerate_tpu_torch.models import (
    LlamaConfig,
    LlamaForCausalLM,
    apply_rope,
    llama_params_from_flax,
    rms_norm,
    rotary_embedding,
)
from accelerate_tpu_torch.ops import hopper_flash


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the driver runs several test processes at once,
    and torch's spinning thread pools would contend for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _ids(b=2, s=24, vocab=256, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, size=(b, s), dtype=np.int32)


def _pair(**kw):
    """(flax module, its params, port module with the same weights)."""
    jcfg = JaxLlamaConfig.tiny(dtype=jnp.float32, **kw)
    tcfg = LlamaConfig.tiny(dtype=torch.float32, **kw)
    module = JaxLlama(jcfg)
    params = module.init(jax.random.key(0), _ids())["params"]
    model = LlamaForCausalLM(tcfg)
    model.load_state_dict(llama_params_from_flax(tcfg, jax.tree.map(np.asarray, params)))
    return module, params, model


@pytest.mark.parametrize("attention_impl", ["flash", "native"])
@pytest.mark.parametrize("scan_layers", [True, False])
def test_tiny_logits_match_flax(attention_impl, scan_layers):
    module, params, model = _pair(attention_impl=attention_impl, scan_layers=scan_layers)
    ids = _ids(seed=1)
    ref = np.asarray(module.apply({"params": params}, jnp.asarray(ids)))
    with torch.no_grad():
        out = model(torch.from_numpy(ids).long()).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)


def test_tied_embeddings_convert_and_match():
    module, params, model = _pair(tie_word_embeddings=True)
    assert not hasattr(model, "lm_head")
    ids = _ids(seed=2)
    ref = np.asarray(module.apply({"params": params}, jnp.asarray(ids)))
    with torch.no_grad():
        out = model(torch.from_numpy(ids).long()).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)


def test_norm_and_rope_match_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 8, 4, 32), dtype=np.float32)
    w = rng.standard_normal((32,), dtype=np.float32)
    np.testing.assert_allclose(
        rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5).numpy(),
        np.asarray(jax_llama.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5)),
        rtol=1e-6, atol=1e-6)
    pos = np.arange(8, dtype=np.int32)
    cos_j, sin_j = jax_llama.rotary_embedding(jnp.asarray(pos), 32, 10000.0, jnp.float32)
    cos_t, sin_t = rotary_embedding(torch.from_numpy(pos), 32, 10000.0, torch.float32)
    np.testing.assert_allclose(cos_t.numpy(), np.asarray(cos_j), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        apply_rope(torch.from_numpy(x), cos_t, sin_t).numpy(),
        np.asarray(jax_llama.apply_rope(jnp.asarray(x), cos_j, sin_j)), rtol=1e-5, atol=1e-5)


def _grads(model, ids):
    model.zero_grad(set_to_none=True)
    logits = model(ids)
    torch.nn.functional.cross_entropy(logits.reshape(-1, logits.shape[-1]).float(),
                                      ids.reshape(-1)).backward()
    return {n: p.grad.clone() for n, p in model.named_parameters()}


@pytest.mark.parametrize("policy,fwd_calls", [("flash", 2), ("dots", 2), ("minimal", 4)])
def test_remat_policies_keep_gradients_and_name_flash_outputs(policy, fwd_calls, monkeypatch):
    """Every remat policy gives remat=False's gradients; flash and dots keep
    the flash forward's outputs (one forward per layer), minimal recomputes
    them (two per layer), as the JAX policies do."""
    ids = torch.from_numpy(_ids(seed=4)).long()
    cfg = dict(dtype=torch.float32, attention_impl="flash")
    torch.manual_seed(0)
    base = LlamaForCausalLM(LlamaConfig.tiny(**cfg))
    base.init_weights(torch.Generator().manual_seed(0))
    remat = LlamaForCausalLM(LlamaConfig.tiny(remat=True, remat_policy=policy, **cfg))
    remat.load_state_dict(base.state_dict())
    ref = _grads(base, ids)

    calls = []
    plain = hopper_flash.flash_fwd_plain
    monkeypatch.setattr(hopper_flash, "flash_fwd_plain",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    got = _grads(remat, ids)
    assert len(calls) == fwd_calls
    for name in ref:
        torch.testing.assert_close(got[name], ref[name], rtol=1e-5, atol=1e-6, msg=name)


def test_unported_knobs_raise():
    """Every chassis knob is ported (tests/test_torch_chassis.py); a value
    the JAX config refuses raises here too. Ring and Ulysses attention are
    ported and, with no cp or sp axis to split the sequence over, give
    flash's logits."""
    with pytest.raises(ValueError, match="norm_type"):
        LlamaConfig.tiny(norm_type="batchnorm")
    with pytest.raises(ValueError, match="odd rotary_dim"):
        LlamaConfig.tiny(partial_rotary_factor=0.3)
    base = LlamaForCausalLM(LlamaConfig.tiny(dtype=torch.float32))
    base.init_weights(torch.Generator().manual_seed(0))
    ids = torch.from_numpy(_ids()).long()
    want = base(ids)
    for impl in ("ring", "ulysses"):
        model = LlamaForCausalLM(LlamaConfig.tiny(dtype=torch.float32, attention_impl=impl))
        model.load_state_dict(base.state_dict())
        assert torch.equal(model(ids), want), impl
