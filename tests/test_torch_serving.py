"""The port's continuous-batching engine (accelerate_tpu_torch/serving.py)
against the port's generate() and the JAX package's ServingEngine.

The tiny Llama (fp32, GQA) is initialised by flax and carried over with
``llama_params_from_flax``; prompts are numpy-seeded. Token comparisons
also assert that each greedy step's top-2 logit gap is well above fp32
rounding, so equal tokens are not luck at a near-tie.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from accelerate_tpu import Model as JaxModel
from accelerate_tpu import ServingConfig as JaxServingConfig
from accelerate_tpu import ServingEngine as JaxServingEngine
from accelerate_tpu import serving as jax_serving
from accelerate_tpu.models import LlamaConfig as JaxLlamaConfig
from accelerate_tpu.models import LlamaForCausalLM as JaxLlama
from accelerate_tpu_torch import Model, ServingConfig, ServingEngine, generate
from accelerate_tpu_torch import generation as gen
from accelerate_tpu_torch import serving
from accelerate_tpu_torch.models import LlamaConfig, LlamaForCausalLM, llama_params_from_flax
from accelerate_tpu_torch.utils.dataclasses import _UNPORTED_SERVING_FIELDS

MIN_GAP = 1e-4  # top-2 logit gap each greedy step must exceed


@pytest.fixture(scope="module")
def pair():
    """(JAX Model, port config, port module) with one set of weights."""
    jcfg = JaxLlamaConfig.tiny(dtype=jnp.float32, attention_impl="native")
    probe = np.random.default_rng(0).integers(0, jcfg.vocab_size, (1, 8), dtype=np.int32)
    jmodel = JaxModel.from_flax(JaxLlama(jcfg), jax.random.key(0), probe)
    cfg = LlamaConfig.tiny(dtype=torch.float32)
    module = LlamaForCausalLM(cfg)
    module.load_state_dict(llama_params_from_flax(cfg, jax.tree.map(np.asarray, jmodel.params)))
    return jmodel, cfg, module


def _prompts(lengths, seed=3, vocab=256):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, (n,), dtype=np.int32) for n in lengths]


def _min_greedy_gap(cfg, module, row, prompt_len, eos=None):
    """Smallest top-2 logit gap over the greedy steps that produced
    ``row[prompt_len:]`` (up to its EOS), from one teacher-forced forward."""
    new = np.asarray(row[prompt_len:])
    end = prompt_len + (int(np.flatnonzero(new == eos)[0]) + 1
                        if eos is not None and (new == eos).any() else new.size)
    with torch.no_grad():
        logits = module(torch.as_tensor(np.asarray(row[:end])).long()[None])[0]
    top2 = torch.topk(logits[prompt_len - 1:end - 1], 2, dim=-1).values
    return float((top2[:, 0] - top2[:, 1]).min())


# ---------------------------------------------------------------------------
# Ladder math
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("max_len,lo,hi", [(256, 16, 256), (100, 16, 256), (8, 16, 256),
                                           (1024, 16, 256), (300, 4, 64), (64, 64, 64)])
def test_default_prefill_ladder_matches_jax(max_len, lo, hi):
    got = serving.default_prefill_ladder(max_len, lo, hi)
    assert got == jax_serving.default_prefill_ladder(max_len, lo, hi)


@pytest.mark.parametrize("ladder", [[4, 8, 16], [16], [3, 5, 16, 32], [16, 32, 64, 128, 256]])
def test_plan_chunks_matches_jax(ladder):
    for p in range(1, 300, 7):
        chunks = serving.plan_chunks(p, ladder)
        assert chunks == jax_serving.plan_chunks(p, ladder)
        assert sum(v for _, v in chunks) == p


def test_plan_chunks_rejects_empty():
    with pytest.raises(ValueError):
        serving.plan_chunks(0, [8])
    with pytest.raises(ValueError):
        serving.plan_chunks(5, [])


# ---------------------------------------------------------------------------
# Engine against generate() and against the JAX engine
# ---------------------------------------------------------------------------

PROMPT_LENGTHS = [3, 7, 12, 20, 3, 7, 12, 20]
BUDGETS = [6, 4, 8, 3, 6, 4, 8, 3]


@pytest.fixture(scope="module")
def greedy_run(pair):
    """The port engine's rows and stats for mixed lengths, chunked prefill
    and mid-flight slot reuse (3 slots, 8 requests)."""
    _, _, module = pair
    prompts = _prompts(PROMPT_LENGTHS)
    engine = ServingEngine(Model(module), ServingConfig(n_slots=3, max_len=64,
                                                        prefill_chunks=[4, 8]))
    return prompts, engine.run(prompts, max_new_tokens=BUDGETS), engine.stats()


def test_engine_greedy_matches_generate(pair, greedy_run):
    _, cfg, module = pair
    prompts, outs, stats = greedy_run
    for prompt, budget, got in zip(prompts, BUDGETS, outs):
        want = generate(module, prompt[None], max_new_tokens=budget)[0].numpy()
        assert _min_greedy_gap(cfg, module, want, len(prompt)) > MIN_GAP
        np.testing.assert_array_equal(got, want)
    # Eight requests through three slots: slots were reused mid-flight.
    assert stats["requests_completed"] == len(prompts) and stats["peak_occupancy"] == 3


def test_engine_greedy_matches_jax_engine(pair, greedy_run):
    jmodel, _, _ = pair
    prompts, outs, _ = greedy_run
    jengine = JaxServingEngine(jmodel, JaxServingConfig(n_slots=3, max_len=64,
                                                        prefill_chunks=[4, 8]))
    want = jengine.run(prompts, max_new_tokens=BUDGETS)
    for got, row in zip(outs, want):
        np.testing.assert_array_equal(got, np.asarray(row))


def test_per_slot_eos_retirement(pair):
    """Rows retire at their own EOS; the row pads with the pad id exactly
    like generate()."""
    _, cfg, module = pair
    prompts = _prompts([5, 9, 5, 9], seed=9)
    eos = int(generate(module, prompts[0][None], max_new_tokens=1)[0, -1])
    budget = 8
    engine = ServingEngine(module, ServingConfig(n_slots=2, max_len=64, prefill_chunks=[4, 8],
                                                 eos_token_id=eos))
    outs = engine.run(prompts, max_new_tokens=budget)
    lengths = []
    for prompt, got in zip(prompts, outs):
        want = generate(module, prompt[None], max_new_tokens=budget, eos_token_id=eos)[0].numpy()
        assert _min_greedy_gap(cfg, module, want, len(prompt), eos=eos) > MIN_GAP
        np.testing.assert_array_equal(got, want)
        new = got[len(prompt):]
        lengths.append(int(np.argmax(new == eos)) + 1 if eos in new else budget)
    assert len(set(lengths)) > 1  # rows really retired at different ticks
    assert engine.stats()["tokens_out"] == sum(lengths)


def test_chunked_prefill_matches_oneshot_prefill(pair):
    """Writing a prompt chunk by chunk into a slot leaves the cache and the
    first token of one whole-prompt prefill."""
    _, cfg, module = pair
    prompt = _prompts([13], seed=5)[0]
    engine = ServingEngine(module, ServingConfig(n_slots=2, max_len=32, prefill_chunks=[4, 8]))
    engine.submit(prompt, max_new_tokens=1)
    while engine._prefilling or engine._queue:
        engine.tick()
    slot, p = 0, len(prompt)
    one = gen.init_cache(cfg, 1, 32)
    logits, one = gen._llama_forward_cached(cfg, module, torch.from_numpy(prompt)[None], one)
    for got, want in ((engine._cache.k, one.k), (engine._cache.v, one.v)):
        torch.testing.assert_close(got[:, slot, :p], want[:, 0, :p], rtol=1e-5, atol=1e-5)
    assert int(engine._cache.length[slot]) == p
    (res,) = engine.poll()
    assert int(res["tokens"][p]) == int(logits[0].argmax())
    assert engine.stats()["prefill_chunks"] == 3


def test_padded_chunk_stops_at_slot_capacity(pair):
    """A last chunk whose padding would reach past max_len is cut at it."""
    _, _, module = pair
    prompt = _prompts([18], seed=6)[0]
    engine = ServingEngine(module, ServingConfig(n_slots=1, max_len=20, prefill_chunks=[8, 16]))
    (got,) = engine.run([prompt], max_new_tokens=2)
    want = generate(module, prompt[None], max_new_tokens=2)[0].numpy()
    np.testing.assert_array_equal(got, want)


def test_sampled_requests_follow_their_own_generator(pair):
    """temperature > 0: each request draws from its own generator, so its
    tokens are those of a batch-1 generate() with that generator, whatever
    its slot and neighbours."""
    _, _, module = pair
    prompts = _prompts([5, 8, 3, 6], seed=13)
    cfg = ServingConfig(n_slots=2, max_len=64, prefill_chunks=[4, 8], temperature=0.8, top_k=20)

    def run(order):
        engine = ServingEngine(module, cfg)
        outs = engine.run([prompts[i] for i in order], max_new_tokens=6,
                          generators=[torch.Generator().manual_seed(i) for i in order])
        return dict(zip(order, outs))

    a, b = run([0, 1, 2, 3]), run([3, 2, 1, 0])
    for i, prompt in enumerate(prompts):
        np.testing.assert_array_equal(a[i], b[i])
        want = generate(module, prompt[None], max_new_tokens=6, temperature=0.8, top_k=20,
                        generator=torch.Generator().manual_seed(i))[0].numpy()
        np.testing.assert_array_equal(a[i], want)


def test_incremental_submit_poll(pair):
    """Submissions land mid-flight and poll() delivers each result once."""
    _, _, module = pair
    prompts = _prompts([6, 4, 6, 4], seed=7)
    engine = ServingEngine(module, ServingConfig(n_slots=2, max_len=64, prefill_chunks=[4, 8]))
    first = [engine.submit(p, max_new_tokens=4) for p in prompts[:2]]
    for _ in range(3):
        engine.tick()
    late = [engine.submit(p, max_new_tokens=4) for p in prompts[2:]]
    seen = {}
    while engine.pending:
        engine.tick()
        for res in engine.poll():
            assert res["id"] not in seen and res["status"] == "ok"
            seen[res["id"]] = res["tokens"]
    assert set(seen) == set(first + late)
    for rid, prompt in zip(first + late, prompts):
        want = generate(module, prompt[None], max_new_tokens=4)[0].numpy()
        np.testing.assert_array_equal(seen[rid], want)


def test_occupancy_and_token_accounting(pair):
    _, _, module = pair
    budgets = [3, 6, 4, 5, 7, 2]
    engine = ServingEngine(module, ServingConfig(n_slots=2, max_len=64, prefill_chunks=[8]))
    engine.run(_prompts([4, 9, 5, 7, 3, 6], seed=2), max_new_tokens=budgets)
    stats = engine.stats()
    assert stats["requests_submitted"] == stats["requests_completed"] == 6
    assert stats["tokens_out"] == sum(budgets)
    assert stats["prefill_chunks"] == 7  # the 9-token prompt takes two 8-chunks
    assert 0 < stats["mean_occupancy"] <= 2 and stats["peak_occupancy"] <= 2
    assert stats["tokens_per_s"] > 0
    assert stats["ttft_p95_s"] >= stats["ttft_p50_s"] > 0
    engine.reset_metrics()
    assert engine.stats()["ticks"] == 0 and engine.stats()["tokens_per_s"] is None


def test_config_seed_seeds_requests_without_a_generator(pair):
    """A request submitted without a generator draws from one seeded
    ServingConfig.seed: at the default 0 that is generate()'s default
    stream, and another seed changes the sampled tokens."""
    _, _, module = pair
    prompts = _prompts([5, 8, 3], seed=8)
    kw = dict(temperature=1.5, top_k=50)

    def engine_rows(seed):
        engine = ServingEngine(module, ServingConfig(n_slots=2, max_len=32, prefill_chunks=[4, 8],
                                                     seed=seed, **kw))
        return engine.run(prompts, max_new_tokens=6)

    rows0, rows5 = engine_rows(0), engine_rows(5)
    for prompt, got0, got5 in zip(prompts, rows0, rows5):
        for seed, got in ((0, got0), (5, got5)):
            want = generate(module, prompt[None], max_new_tokens=6,
                            generator=torch.Generator().manual_seed(seed), **kw)[0].numpy()
            np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        rows0[0], generate(module, prompts[0][None], max_new_tokens=6, **kw)[0].numpy())
    assert any((a != b).any() for a, b in zip(rows0, rows5))


def test_replay_trace_matches_run_and_jax_replay(pair):
    """Requests submitted at their arrival times give run()'s rows, and the
    JAX package's replay_trace rows, in input order."""
    jmodel, _, module = pair
    prompts = _prompts([6, 3, 9, 4, 7], seed=11)
    arrivals, budgets = [0.0, 0.0, 0.02, 0.01, 0.05], [4, 6, 3, 5, 4]
    cfg = dict(n_slots=2, max_len=32, prefill_chunks=[4, 8])
    rows, elapsed = serving.replay_trace(ServingEngine(module, ServingConfig(**cfg)), prompts,
                                         arrivals=arrivals, max_new_tokens=budgets)
    assert elapsed >= 0.05
    want = ServingEngine(module, ServingConfig(**cfg)).run(prompts, max_new_tokens=budgets)
    jrows, _ = jax_serving.replay_trace(JaxServingEngine(jmodel, JaxServingConfig(**cfg)),
                                        prompts, arrivals=arrivals, max_new_tokens=budgets)
    for got, w, j in zip(rows, want, jrows):
        np.testing.assert_array_equal(got, w)
        np.testing.assert_array_equal(got, np.asarray(j))


def test_replay_trace_rejects_mismatched_arrivals(pair):
    _, _, module = pair
    engine = ServingEngine(module, ServingConfig(n_slots=1, max_len=16))
    with pytest.raises(ValueError, match="arrivals"):
        serving.replay_trace(engine, _prompts([3, 4]), arrivals=[0.0])


def test_submit_validation(pair):
    _, _, module = pair
    engine = ServingEngine(module, ServingConfig(n_slots=2, max_len=16))
    with pytest.raises(ValueError, match="empty"):
        engine.submit(np.zeros((0,), np.int32))
    with pytest.raises(ValueError, match="capacity"):
        engine.submit(np.ones((12,), np.int32), max_new_tokens=8)
    with pytest.raises(ValueError, match=">= 1"):
        engine.submit(np.ones((4,), np.int32), max_new_tokens=0)


# ---------------------------------------------------------------------------
# Configuration: validation, and what is not ported raises
# ---------------------------------------------------------------------------


def test_serving_config_validation():
    for bad in (dict(n_slots=0), dict(prefill_chunks_per_tick=0),
                dict(min_prefill_chunk=32, max_prefill_chunk=16), dict(max_new_tokens=0)):
        with pytest.raises(ValueError):
            ServingConfig(**bad)


_UNPORTED_VALUES = {
    "enabled": False, "cache_dtype": torch.int8, "speculate_k": 2, "speculate_ngram": 8,
    "max_queue_depth": 4, "overload_policy": "block", "deadline_s": 1.0, "max_retries": 0,
    "max_idle_ticks": 5, "window_requests": 16, "journal_dir": "wal",
    "journal_fsync": "os", "journal_segment_records": 8,
}


@pytest.mark.parametrize("field", sorted(_UNPORTED_SERVING_FIELDS))
def test_unported_serving_config_fields_raise(field):
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue A item"):
        ServingConfig(**{field: _UNPORTED_VALUES[field]})


@pytest.mark.parametrize("arg", sorted(serving._UNPORTED_ENGINE_ARGS))
def test_unported_engine_arguments_raise(pair, arg):
    _, _, module = pair
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue A item"):
        ServingEngine(module, ServingConfig(n_slots=1, max_len=8), **{arg: object()})
