"""The port's KV-cache generation (accelerate_tpu_torch/generation.py:
the cache and its int8 pages, generate, speculative_generate,
beam_search) and int8 weight-only decode (utils/quantization.py) against
the JAX package's.

The flax module initialises the tiny Llama (fp32, GQA), its weights come
over with ``llama_params_from_flax``, and both packages run the same
numpy-seeded inputs on the CPU. Token comparisons also assert that every
greedy step's top-2 logit gap is well above fp32 rounding, so equal tokens
are not luck at a near-tie.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from accelerate_tpu import Model as JaxModel
from accelerate_tpu import generate as jax_generate
from accelerate_tpu import generation as jax_gen
from accelerate_tpu.models import LlamaConfig as JaxLlamaConfig
from accelerate_tpu.models import LlamaForCausalLM as JaxLlama
from accelerate_tpu.utils import quantization as jax_quant
from accelerate_tpu_torch import (
    GenerationConfig,
    Model,
    beam_search,
    generate,
    quantize_model_for_decode,
    speculative_generate,
)
from accelerate_tpu_torch import generation as gen
from accelerate_tpu_torch.models import LlamaConfig, LlamaForCausalLM, llama_params_from_flax
from accelerate_tpu_torch.utils.quantization import DECODE_QUANT_WEIGHTS, quantize_decode_kernel

MIN_GAP = 1e-4  # top-2 logit gap each greedy step must exceed


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The tiny engines and decode loops run thousands of small ops: one
    intra-op thread keeps them from contending with the other test
    workers for the cores (restored after the module)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def pair():
    """(JAX config, JAX Model, port config, port module) with one set of weights."""
    jcfg = JaxLlamaConfig.tiny(dtype=jnp.float32, attention_impl="native")
    probe = np.random.default_rng(0).integers(0, jcfg.vocab_size, (2, 8), dtype=np.int32)
    jmodel = JaxModel.from_flax(JaxLlama(jcfg), jax.random.key(0), probe)
    tcfg = LlamaConfig.tiny(dtype=torch.float32)
    module = LlamaForCausalLM(tcfg)
    module.load_state_dict(llama_params_from_flax(tcfg, jax.tree.map(np.asarray, jmodel.params)))
    return jcfg, jmodel, tcfg, module


def _ids(b, s, seed, vocab=256):
    return np.random.default_rng(seed).integers(1, vocab, (b, s), dtype=np.int32)


def _min_greedy_gap(cfg, model, rows, prompt_len, mask=None, eos=None):
    """Smallest top-2 logit gap over the greedy steps that produced
    ``rows[:, prompt_len:]``, from one teacher-forced cached forward; steps
    after a row's EOS (pad output) are skipped."""
    rows = torch.as_tensor(np.asarray(rows)).long()
    b, t = rows.shape
    kwargs = {}
    if mask is not None:
        mask = np.asarray(mask)
        kv_valid = np.concatenate([mask.astype(bool), np.ones((b, t - prompt_len), bool)], 1)
        kwargs = {"pad_offset": torch.from_numpy(np.argmax(mask, 1)).long(),
                  "kv_valid": torch.from_numpy(kv_valid)}
    logits, _ = gen._llama_forward_cached(cfg, model, rows, gen.init_cache(cfg, b, t),
                                          return_all=True, **kwargs)
    top2 = torch.topk(logits[:, prompt_len - 1:t - 1], 2, dim=-1).values
    gaps = (top2[..., 0] - top2[..., 1]).numpy()
    if eos is not None:
        new = rows[:, prompt_len:].numpy()
        for r in range(b):
            hits = np.flatnonzero(new[r] == eos)
            if hits.size:
                gaps[r, hits[0] + 1:] = np.inf
    return float(gaps.min())


# ---------------------------------------------------------------------------
# Cache and attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("start", [5, [0, 3, 9]], ids=["scalar", "vector"])
def test_cache_write_matches_jax(start):
    rng = np.random.default_rng(1)
    ck = rng.standard_normal((3, 16, 2, 8), dtype=np.float32)
    new = rng.standard_normal((3, 4, 2, 8), dtype=np.float32)
    start_np = np.asarray(start, np.int32)
    want = np.asarray(jax_gen._cache_write(jnp.asarray(ck), jnp.asarray(new),
                                           jnp.asarray(start_np)))
    got = gen._cache_write(torch.from_numpy(ck.copy()), torch.from_numpy(new),
                           torch.from_numpy(start_np).long())
    np.testing.assert_array_equal(got.numpy(), want)


def test_scalar_and_vector_cache_paths_agree(pair):
    """The forward at a () start and at a (B,) vector of that start give the
    same logits and cache contents."""
    _, _, cfg, module = pair
    ids = torch.from_numpy(_ids(2, 6, seed=2)).long()
    nxt = torch.tensor([[7], [11]])
    out = []
    for start in (torch.tensor(6), torch.tensor([6, 6])):
        cache = gen.init_cache(cfg, 2, 16)
        _, cache = gen._llama_forward_cached(cfg, module, ids, cache)
        cache.length = start
        logits, cache = gen._llama_forward_cached(cfg, module, nxt, cache)
        out.append((logits, cache.k.clone(), cache.v.clone()))
    for a, b in zip(*out):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_attend_with_kv_valid_matches_jax():
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, 3, 4, 16), dtype=np.float32)
    k = rng.standard_normal((2, 12, 2, 16), dtype=np.float32)
    v = rng.standard_normal((2, 12, 2, 16), dtype=np.float32)
    pos = np.asarray([[5, 6, 7], [8, 9, 10]], np.int32)
    kv_valid = np.ones((2, 12), bool)
    kv_valid[0, :2] = kv_valid[1, :4] = False
    want = np.asarray(jax_gen._attend(*map(jnp.asarray, (q, k, v, pos, kv_valid))))
    got = gen._attend(*map(torch.from_numpy, (q, k, v)), torch.from_numpy(pos).long(),
                      torch.from_numpy(kv_valid))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("step", ["prefill", "decode"])
def test_cached_forward_matches_jax_and_full_forward(pair, step):
    jcfg, jmodel, cfg, module = pair
    ids = _ids(2, 8, seed=4)
    nxt = np.asarray([[7], [11]], np.int32)
    cache = gen.init_cache(cfg, 2, 32)
    logits, cache = gen._llama_forward_cached(cfg, module, torch.from_numpy(ids), cache)
    jcache = jax_gen.init_cache(jcfg, 2, 32)
    jlogits, jcache = jax_gen._llama_forward_cached(jcfg, jmodel.params, jnp.asarray(ids), jcache)
    full_ids = ids
    if step == "decode":
        logits, cache = gen._llama_forward_cached(cfg, module, torch.from_numpy(nxt), cache)
        jlogits, jcache = jax_gen._llama_forward_cached(jcfg, jmodel.params, jnp.asarray(nxt),
                                                        jcache)
        full_ids = np.concatenate([ids, nxt], 1)
    assert int(cache.length) == int(jcache.length) == full_ids.shape[1]
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(cache.k.numpy(), np.asarray(jcache.k), rtol=1e-5, atol=1e-5)
    with torch.no_grad():
        full = module(torch.from_numpy(full_ids).long())[:, -1]
    np.testing.assert_allclose(logits.numpy(), full.numpy(), rtol=1e-5, atol=1e-5)


def test_return_all_gives_every_position(pair):
    _, _, cfg, module = pair
    ids = torch.from_numpy(_ids(2, 8, seed=5)).long()
    logits, _ = gen._llama_forward_cached(cfg, module, ids, gen.init_cache(cfg, 2, 8),
                                          return_all=True)
    with torch.no_grad():
        full = module(ids)
    torch.testing.assert_close(logits, full, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# generate
# ---------------------------------------------------------------------------


def test_greedy_generate_matches_jax(pair):
    jcfg, jmodel, cfg, module = pair
    ids = _ids(2, 8, seed=6)
    got = generate(Model(module), ids, max_new_tokens=8)
    want = np.asarray(jax_generate(jmodel, ids, max_new_tokens=8))
    assert got.shape == (2, 16)
    assert _min_greedy_gap(cfg, module, got, 8) > MIN_GAP
    np.testing.assert_array_equal(got.numpy(), want)


def test_left_padded_generate_with_eos_matches_jax(pair):
    """Left-padded rows with EOS/pad: the same tokens as JAX, and the padded
    row continues as it does alone."""
    jcfg, jmodel, cfg, module = pair
    ids = _ids(2, 8, seed=7)
    mask = np.ones((2, 8), np.int32)
    mask[1, :3] = 0
    ids[1, :3] = 0
    plain = generate(module, ids, max_new_tokens=6, attention_mask=mask)
    eos = int(plain[0, 10])  # row 0's third new token ends it early
    kw = dict(max_new_tokens=6, attention_mask=mask, eos_token_id=eos, pad_token_id=1)
    got = generate(module, ids, **kw)
    want = np.asarray(jax_generate(jmodel, ids, **kw))
    assert _min_greedy_gap(cfg, module, got, 8, mask=mask, eos=eos) > MIN_GAP
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got[0, 11:].numpy(), [1, 1, 1])
    alone = generate(module, ids[1:, 3:], max_new_tokens=6)
    np.testing.assert_array_equal(plain[1, 8:].numpy(), alone[0, 5:].numpy())


def test_logit_processors_and_buckets_match_jax(pair):
    """suppress_tokens, begin_suppress_tokens, forced_decoder_ids and
    seq_buckets, all at once, give JAX's tokens."""
    jcfg, jmodel, cfg, module = pair
    ids = _ids(2, 5, seed=8)
    first = generate(module, ids, max_new_tokens=1)[:, -1].tolist()
    kw = dict(max_new_tokens=6, suppress_tokens=(3, 4), begin_suppress_tokens=tuple(first),
              forced_decoder_ids=((10, 42),), seq_buckets=(8, 16))
    got = generate(module, ids, **kw)
    want = np.asarray(jax_generate(jmodel, ids, **kw))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.shape == (2, 11)
    assert (got[:, 7] == 42).all()  # absolute position 10 = new token 2 after 8 (bucketed)
    assert not set(got[:, 5].tolist()) & set(first)


def test_generation_config_defaults_and_overrides(pair):
    _, _, cfg, module = pair
    ids = _ids(1, 6, seed=9)
    a = generate(module, ids, config=GenerationConfig(max_new_tokens=4))
    b = generate(module, ids, max_new_tokens=4, config=GenerationConfig(max_new_tokens=9))
    assert a.shape == b.shape == (1, 10)
    torch.testing.assert_close(a, b)


def test_generate_checks_positions_and_padding_side(pair):
    _, _, cfg, module = pair
    ids = _ids(2, 8, seed=10)
    with pytest.raises(ValueError, match="max_position_embeddings"):
        generate(module, ids, max_new_tokens=cfg.max_position_embeddings)
    right = np.ones((2, 8), np.int32)
    right[1, 5:] = 0
    with pytest.raises(ValueError, match="left-padded"):
        generate(module, ids, max_new_tokens=2, attention_mask=right)


# ---------------------------------------------------------------------------
# Sampling
# ---------------------------------------------------------------------------


def _logits_with_ties():
    rng = np.random.default_rng(11)
    logits = rng.standard_normal((3, 40)).astype(np.float32)
    logits[0, [3, 7, 9]] = 2.5        # a three-way tie at the top-k boundary
    logits[1, :5] = [4.0, 3.0, 3.0, 1.0, 0.5]
    return logits


@pytest.mark.parametrize("top_k,top_p", [(2, None), (5, None), (None, 0.5), (None, 0.9),
                                         (4, 0.8)])
def test_filter_logits_matches_jax(top_k, top_p):
    logits = _logits_with_ties()
    want = np.asarray(jax_gen._filter_logits(jnp.asarray(logits), temperature=0.7, top_k=top_k,
                                             top_p=top_p))
    got = gen._filter_logits(torch.from_numpy(logits), temperature=0.7, top_k=top_k,
                             top_p=top_p).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_allclose(got[~np.isinf(got)], want[~np.isinf(want)], rtol=1e-6)
    if top_k == 2:
        assert (~np.isinf(got[0])).sum() == 3  # the tie keeps all three


def test_sampling_follows_the_generator_and_the_filter():
    logits = torch.from_numpy(_logits_with_ties())
    draws = [gen.sample_logits(logits, torch.Generator().manual_seed(s), temperature=0.8,
                               top_k=5) for s in (1, 1, 2)]
    torch.testing.assert_close(draws[0], draws[1])
    kept = ~torch.isinf(gen._filter_logits(logits, temperature=0.8, top_k=5))
    for s in range(20):
        tok = gen.sample_logits(logits, torch.Generator().manual_seed(s), temperature=0.8,
                                top_k=5)
        assert kept[torch.arange(3), tok].all()
    torch.testing.assert_close(gen.sample_logits(logits, temperature=0.0), logits.argmax(-1))


def test_sampled_generate_is_seeded_and_greedy_at_temperature_zero(pair):
    _, _, cfg, module = pair
    ids = _ids(2, 6, seed=12)

    def sampled(seed):
        return generate(module, ids, max_new_tokens=6, temperature=0.9, top_p=0.95,
                        generator=torch.Generator().manual_seed(seed))

    torch.testing.assert_close(sampled(5), sampled(5))
    torch.testing.assert_close(generate(module, ids, max_new_tokens=6, temperature=0.0),
                               generate(module, ids, max_new_tokens=6))


# ---------------------------------------------------------------------------
# int8 KV pages and writes past the capacity
# ---------------------------------------------------------------------------


def _kv_rows(dtype):
    """Rows of 16 over (B=3, S=4, H=2): a zero row, rows whose absmax is
    127 × 2**-3 (scale exactly 2**-3) with exact halves of that scale (the
    round-half-to-even cases) and ±127 extremes, and random rows."""
    rng = np.random.default_rng(21)
    x = (rng.standard_normal((3, 4, 2, 16)) * 2.0).astype(np.float32)
    x[0, 0, 0] = 0.0
    halves = np.asarray([127, -127, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5, 126.5, -126.5,
                         0.0, 4.5, 5.5, -3.5, 64.5], np.float32) * 2.0 ** -3
    x[0, 1, 0] = halves
    x[1, 2, 1] = -halves
    x[2, 3, 0, 5] = -40.0  # one large entry: the others round near zero
    if dtype == "bfloat16":
        return jnp.asarray(x).astype(jnp.bfloat16), torch.from_numpy(x).bfloat16()
    return jnp.asarray(x), torch.from_numpy(x)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_page_is_bit_equal_to_jax(dtype):
    jx, tx = _kv_rows(dtype)
    want = jax_gen.quantize_kv_page(jx)
    got = gen.quantize_kv_page(tx)
    assert got.data.dtype == torch.int8 and got.scale.shape == (3, 4, 2, 1)
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    assert got.scale[0, 0, 0, 0] == 0.0  # a zero row: the subnormal scale flushed
    assert set(got.data[0, 1, 0].tolist()[:11]) == {127, -127, 0, 2, -2, 4, 126, -126}
    back = gen.dequantize_kv_page(got, torch.float32)
    np.testing.assert_array_equal(back.numpy(), np.asarray(
        jax_gen.dequantize_kv_page(want, jnp.float32)))


@pytest.mark.parametrize("pages", [False, True], ids=["float", "int8"])
def test_cache_write_drops_rows_past_capacity_like_jax(pages):
    """A window written at per-row offsets that run past T keeps the rows
    below T and drops the rest, as the JAX scatter does; rows whose whole
    window lies past T, or whose window ends exactly at T - 1, included."""
    rng = np.random.default_rng(22)
    b, t, s = 4, 10, 5
    ck = rng.standard_normal((b, t, 2, 8)).astype(np.float32)
    new = rng.standard_normal((b, s, 2, 8)).astype(np.float32)
    start = np.asarray([7, 5, 12, 2], np.int32)
    if pages:
        jck, tck = jax_gen.quantize_kv_page(jnp.asarray(ck)), gen.quantize_kv_page(
            torch.from_numpy(ck))
    else:
        jck, tck = jnp.asarray(ck), torch.from_numpy(ck.copy())
    want = jax_gen._cache_write(jck, jnp.asarray(new), jnp.asarray(start))
    got = gen._cache_write(tck, torch.from_numpy(new), torch.from_numpy(start).long())
    for g, w in ([(got.data, want.data), (got.scale, want.scale)] if pages
                 else [(got, want)]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    before = gen.quantize_kv_page(torch.from_numpy(ck)) if pages else torch.from_numpy(ck)
    after, before = (got.data, before.data) if pages else (got, before)
    assert not torch.equal(after[0, 7:], before[0, 7:])  # row 0 wrote 7..9
    assert torch.equal(after[2], before[2])              # row 2's window lies past T


def test_int8_cache_forward_matches_jax(pair):
    """Prefill and a decode step through int8 pages: the pages hold the
    JAX package's codes (within one code where a projection's rounding
    lands on a half) and the logits agree with JAX's and stay near the
    float cache's."""
    jcfg, jmodel, cfg, module = pair
    ids = _ids(2, 8, seed=23)
    nxt = np.asarray([[7], [11]], np.int32)
    cache = gen.init_cache(cfg, 2, 16, dtype=torch.int8)
    assert isinstance(cache.k, gen.QuantPages) and (cache.k.scale == 1).all()
    jcache = jax_gen.init_cache(jcfg, 2, 16, dtype=jnp.int8)
    fcache = gen.init_cache(cfg, 2, 16)
    for step in (ids, nxt):
        logits, cache = gen._llama_forward_cached(cfg, module, torch.from_numpy(step), cache)
        jlogits, jcache = jax_gen._llama_forward_cached(jcfg, jmodel.params, jnp.asarray(step),
                                                        jcache)
        flogits, fcache = gen._llama_forward_cached(cfg, module, torch.from_numpy(step), fcache)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(logits.numpy(), flogits.numpy(), rtol=0, atol=5e-2)
    codes = cache.k.data.numpy().astype(np.int32)
    assert np.abs(codes - np.asarray(jcache.k.data, np.int32)).max() <= 1
    np.testing.assert_allclose(cache.k.scale.numpy(), np.asarray(jcache.k.scale), rtol=1e-5)
    assert cache.k.nbytes == cache.k.data.numel() * (1 + 4 / cfg.head_dim)


# ---------------------------------------------------------------------------
# speculative_generate and beam_search
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def draft_pair(pair):
    """A second tiny Llama (other weights) as the draft, in both packages."""
    jcfg = pair[0]
    probe = np.random.default_rng(1).integers(0, jcfg.vocab_size, (1, 8), dtype=np.int32)
    jdraft = JaxModel.from_flax(JaxLlama(jcfg), jax.random.key(7), probe)
    cfg = LlamaConfig.tiny(dtype=torch.float32)
    draft = LlamaForCausalLM(cfg)
    draft.load_state_dict(llama_params_from_flax(cfg, jax.tree.map(np.asarray, jdraft.params)))
    return jdraft, draft


@pytest.mark.parametrize("draft,k,eos", [("self", 3, False), ("other", 4, False),
                                         ("other", 2, True)])
def test_speculative_generate_matches_jax_and_greedy(pair, draft_pair, draft, k, eos):
    """The target's greedy continuation whatever the draft: equal to the
    JAX package's speculative_generate and to the port's generate."""
    _, jmodel, cfg, module = pair
    jdraft, tdraft = draft_pair if draft == "other" else (jmodel, module)
    ids = _ids(1, 6, seed=24)
    greedy = generate(module, ids, max_new_tokens=12)
    eos_id = int(greedy[0, 10]) if eos else None
    got = speculative_generate(Model(module), tdraft, ids, 12, num_draft_tokens=k,
                               eos_token_id=eos_id)
    want = np.asarray(jax_gen.speculative_generate(jmodel, jdraft, ids, 12, num_draft_tokens=k,
                                                   eos_token_id=eos_id))
    assert got.shape == (1, 18)
    np.testing.assert_array_equal(got.numpy(), want)
    assert _min_greedy_gap(cfg, module, greedy, 6) > MIN_GAP
    if eos:
        np.testing.assert_array_equal(got[0, :11].numpy(), greedy[0, :11].numpy())
        assert (got[0, 11:] == eos_id).all()
    else:
        np.testing.assert_array_equal(got.numpy(), greedy.numpy())


def test_speculative_generate_checks_its_arguments(pair):
    _, _, cfg, module = pair
    with pytest.raises(ValueError, match="num_draft_tokens"):
        speculative_generate(module, module, _ids(1, 4, seed=25), 4, num_draft_tokens=0)
    with pytest.raises(ValueError, match="batch size 1"):
        speculative_generate(module, module, _ids(2, 4, seed=25), 4)
    with pytest.raises(ValueError, match="max positions"):
        speculative_generate(module, module, _ids(1, 4, seed=25), cfg.max_position_embeddings)


@pytest.mark.parametrize("num_beams,eos", [(1, False), (2, False), (4, False), (4, True)])
def test_beam_search_matches_jax(pair, num_beams, eos):
    """Beam search against the JAX package's, with frozen EOS beams padded
    by EOS; one beam is greedy generate()."""
    _, jmodel, cfg, module = pair
    ids = _ids(2, 6, seed=26)
    eos_id = None
    if eos:  # a token a high-scoring beam of row 0 emits early
        eos_id = int(beam_search(module, ids, 8, num_beams=num_beams)[0, 7])
    got = beam_search(Model(module), ids, 8, num_beams=num_beams, eos_token_id=eos_id,
                      length_penalty=0.8)
    want = np.asarray(jax_gen.beam_search(jmodel, ids, 8, num_beams=num_beams,
                                          eos_token_id=eos_id, length_penalty=0.8))
    assert got.shape == (2, 14)
    np.testing.assert_array_equal(got.numpy(), want)
    if num_beams == 1:
        np.testing.assert_array_equal(got.numpy(), generate(module, ids, 8).numpy())
    if eos:
        row = got[0, 6:].numpy()
        hits = np.flatnonzero(row == eos_id)
        assert hits.size and hits[0] < 7 and (row[hits[0]:] == eos_id).all()


# ---------------------------------------------------------------------------
# int8 weight-only decode
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def quantized(pair):
    _, jmodel, _, module = pair
    return jax_quant.quantize_model_for_decode(jmodel), quantize_model_for_decode(Model(module))


@pytest.mark.parametrize("name", DECODE_QUANT_WEIGHTS)
def test_int8_codes_and_scales_match_jax(pair, quantized, name):
    jcfg = pair[0]
    jq, tq = quantized
    part, proj, _ = name.split(".")
    leaf = jq.params["model"]["layers"]["block"][part][proj]["kernel"]
    for i in range(jcfg.num_hidden_layers):
        data, scales = np.asarray(leaf.data[i]), np.asarray(leaf.scales[i])
        # flax kernels are (in..., out...); o_proj's input is (heads, D).
        n_in = data.shape[0] * data.shape[1] if proj == "o_proj" else data.shape[0]
        got = tq.params[f"model.layers.{i}.{name}"]
        np.testing.assert_array_equal(got.data.numpy(), data.reshape(n_in, -1).T)
        np.testing.assert_array_equal(got.scales.numpy()[:, 0], scales.reshape(-1))


def test_int8_generate_matches_jax(pair, quantized):
    _, _, cfg, module = pair
    jq, tq = quantized
    ids = _ids(2, 8, seed=13)
    got = generate(tq, ids, max_new_tokens=6)
    want = np.asarray(jax_generate(jq, ids, max_new_tokens=6))
    assert _min_greedy_gap(cfg, tq, got, 8) > MIN_GAP
    np.testing.assert_array_equal(got.numpy(), want)
    # Embeddings, head and norms stay full precision; the module is untouched.
    assert tq.params["lm_head.weight"].data_ptr() == module.lm_head.weight.data_ptr()
    assert module.model.layers[0].mlp.up_proj.weight.dtype == torch.float32


def test_int8_dequantizes_next_to_the_matmul():
    w = torch.from_numpy(np.random.default_rng(14).standard_normal((6, 5)).astype(np.float32))
    w[2] = 0.0
    dq = quantize_decode_kernel(w)
    assert dq.data.dtype == torch.int8 and dq.scales.shape == (6, 1)
    assert dq.scales[2, 0] == 1.0  # an all-zero channel keeps scale 1
    back = gen._kernel(dq, torch.float32)
    torch.testing.assert_close(back, dq.data.float() * dq.scales)
    assert (back - w).abs().max() <= dq.scales.max() / 2 + 1e-7


def test_quantized_model_refuses_full_forwards(quantized):
    with pytest.raises(ValueError, match="generate"):
        quantized[1](torch.zeros((1, 4), dtype=torch.long))
    with pytest.raises(ValueError, match="Llama-family"):
        quantize_model_for_decode(torch.nn.Linear(2, 2))


# ---------------------------------------------------------------------------
# What is not ported raises
# ---------------------------------------------------------------------------


def test_unported_generation_options_raise(pair):
    """The compile manager is not ported; decoder_input_ids belong to
    encoder-decoder modules, and a class without a plan is refused, as in
    the JAX package (ValueError)."""
    _, _, cfg, module = pair
    ids = _ids(1, 4, seed=15)
    with pytest.raises(ValueError, match="encoder-decoder"):
        generate(module, ids, decoder_input_ids=ids)
    with pytest.raises(NotImplementedError, match="compile_manager"):
        generate(module, ids, compile_manager=object())
    with pytest.raises(ValueError, match="encoder-decoder"):
        gen.beam_search(module, ids, 2, decoder_input_ids=ids)

    class BertForSequenceClassification(torch.nn.Module):
        config = cfg

    with pytest.raises(ValueError, match="No generation plan for 'BertForSequenceClassification'"):
        generate(BertForSequenceClassification(), ids)
