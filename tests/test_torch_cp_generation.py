"""The port's ``cp_generate`` in one process (no ``cp`` axis: the whole
prompt here, its prefill through the flash forward's plain version, its
decode through flash-decoding's partials) against the port's
``generate``; the gangs of ``tests/test_torch_context_parallel.py`` hold
it at cp 2 and 4 against the JAX ``cp_generate``.

Weights are drawn with numpy from a seed (std 1/sqrt(fan-in), biases of
0.1, norm weights around one). Greedy tokens are equal, with every step's
top-2 logit gap above 1e-4 so that equal tokens are not luck at a
near-tie.
"""

import numpy as np
import pytest
import torch

from accelerate_tpu_torch import cp_generate, generate, quantize_model_for_decode
from accelerate_tpu_torch import generation as gen
from accelerate_tpu_torch.cp_generation import _merge_stats, _prefill, clear_cp_generation_cache
from accelerate_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from accelerate_tpu_torch.ops.flash_attention import attention_stats

GRANITE = dict(norm_type="layernorm", attention_bias=True, attention_out_bias=True,
               mlp_bias=True, mlp_gated=False, partial_rotary_factor=0.5,
               embedding_multiplier=3.0, residual_multiplier=0.5, attention_multiplier=0.08,
               logits_scaling=2.0, hidden_act="gelu")
CONFIGS = {"llama": {}, "granite": GRANITE,
           "gemma": dict(hidden_act="gelu_tanh", rms_norm_plus_one=True, scale_embeddings=True,
                         tie_word_embeddings=True, head_dim=48)}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _module(knobs, seed=0):
    cfg = LlamaConfig.tiny(dtype=torch.float32, **knobs)
    module = LlamaForCausalLM(cfg)
    rng = np.random.default_rng(seed)
    sd = {}
    for name, p in module.state_dict().items():
        if p.dim() == 2:
            a = rng.standard_normal(p.shape) / np.sqrt(p.shape[1])
        else:
            a = rng.standard_normal(p.shape) * 0.1 + (0.0 if name.endswith("bias") or
                                                      cfg.rms_norm_plus_one else 1.0)
        sd[name] = torch.from_numpy(a.astype(np.float32))
    module.load_state_dict(sd)
    return cfg, module


def _ids(b, s, seed):
    return np.random.default_rng(seed).integers(1, 256, (b, s))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_cp_generate_gives_generate_tokens(name):
    """Greedy and EOS-padded tokens of every chassis config equal
    generate's, those the JAX cp_generate skips included (Granite's)."""
    cfg, module = _module(CONFIGS[name])
    ids = _ids(2, 12, seed=1)
    want = generate(module, ids, max_new_tokens=8)
    rows = want.long()
    logits, _ = gen._llama_forward_cached(cfg, module, rows, gen.init_cache(cfg, *rows.shape),
                                          return_all=True)
    top2 = torch.topk(logits[:, 11:-1], 2, dim=-1).values
    assert float((top2[..., 0] - top2[..., 1]).min()) > 1e-4
    torch.testing.assert_close(cp_generate(module, ids, 8), want, rtol=0, atol=0)
    eos = int(want[0, 14])
    torch.testing.assert_close(cp_generate(module, ids, 8, eos_token_id=eos),
                               generate(module, ids, max_new_tokens=8, eos_token_id=eos),
                               rtol=0, atol=0)


def test_cp_generate_contract():
    """No new tokens returns the prompt; a prompt past the positions
    raises; an int8 decode-quantized model runs; sampling follows the
    generator; the prefill's cache holds every layer's K and V."""
    cfg, module = _module({})
    ids = _ids(1, 8, seed=2)
    clear_cp_generation_cache()
    np.testing.assert_array_equal(cp_generate(module, ids, 0).numpy(), ids)
    with pytest.raises(ValueError, match="max_position_embeddings"):
        cp_generate(module, _ids(1, 500, seed=3), 13)
    q = quantize_model_for_decode(module)
    torch.testing.assert_close(cp_generate(q, ids, 6), generate(q, ids, max_new_tokens=6),
                               rtol=0, atol=0)
    a, b = (cp_generate(module, ids, 6, temperature=0.9,
                        generator=torch.Generator().manual_seed(5)) for _ in range(2))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    _, pk, pv = _prefill(cfg, dict(module.named_parameters()), torch.from_numpy(ids))
    assert pk.shape == pv.shape == (2, 1, 8, 2, 32)


def test_merge_stats_is_attention_over_the_union():
    """Partials over two disjoint key sets merge to attention over both."""
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((2, 1, 4, 16), (2, 10, 2, 16), (2, 10, 2, 16)))
    parts = [attention_stats(q, k[:, :6], v[:, :6], causal=False),
             attention_stats(q, k[:, 6:], v[:, 6:], causal=False)]
    acc, m, l = attention_stats(q, k, v, causal=False)
    want = (acc / l[..., None]).transpose(1, 2)
    torch.testing.assert_close(_merge_stats(parts), want, rtol=1e-6, atol=1e-6)
