"""The port's continuous-batching engine (accelerate_tpu_torch/serving.py)
against the port's generate() and the JAX package's ServingEngine: the
core, int8 KV pages, admission control, deadlines, retries, quarantine,
the hang guard, the rolling window and the key sets of poll rows and
stats().

The tiny Llama (fp32, GQA) is initialised by flax and carried over with
``llama_params_from_flax``; prompts are numpy-seeded. Token comparisons
also assert that each greedy step's top-2 logit gap is well above fp32
rounding, so equal tokens are not luck at a near-tie.
"""

import dataclasses
import time

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
from test_schemas import (
    FAULTS_KEYS,
    POLL_ROW_KEYS,
    SERVING_STATS_KEYS,
    SPECULATION_KEYS,
    WINDOW_KEYS,
)

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


BAD_CONFIGS = [dict(n_slots=0), dict(prefill_chunks_per_tick=0),
               dict(min_prefill_chunk=32, max_prefill_chunk=16), dict(max_new_tokens=0),
               dict(overload_policy="drop"), dict(max_queue_depth=0), dict(deadline_s=0.0),
               dict(max_retries=-1), dict(max_idle_ticks=0), dict(window_requests=0),
               dict(speculate_k=-1), dict(speculate_ngram=1)]


def test_serving_config_validation():
    """Each bad setting raises ValueError, as the JAX package's does."""
    for bad in BAD_CONFIGS:
        for cls in (ServingConfig, JaxServingConfig):
            with pytest.raises(ValueError):
                cls(**bad)


def test_cache_dtype_takes_int8_only():
    assert ServingConfig(cache_dtype=torch.int8).cache_dtype == torch.int8
    with pytest.raises(ValueError, match="cache_dtype"):
        ServingConfig(cache_dtype=torch.float16)


_UNPORTED_VALUES = {"enabled": False, "journal_dir": "wal", "journal_fsync": "os",
                    "journal_segment_records": 8}


@pytest.mark.parametrize("field", sorted(_UNPORTED_SERVING_FIELDS))
def test_unported_serving_config_fields_raise(field):
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue A item"):
        ServingConfig(**{field: _UNPORTED_VALUES[field]})


def test_client_request_id_is_refused(pair):
    engine = ServingEngine(pair[2], ServingConfig(n_slots=1, max_len=8))
    with pytest.raises(NotImplementedError, match="item 8.8"):
        engine.submit(np.ones((2,), np.int32), max_new_tokens=2, client_request_id="a")


@pytest.mark.parametrize("arg", sorted(serving._UNPORTED_ENGINE_ARGS))
def test_unported_engine_arguments_raise(pair, arg):
    _, _, module = pair
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue A item"):
        ServingEngine(module, ServingConfig(n_slots=1, max_len=8), **{arg: object()})


# ---------------------------------------------------------------------------
# int8 KV pages
# ---------------------------------------------------------------------------


def test_int8_cache_engine_matches_jax_int8_engine(pair):
    """The engine over int8 KV pages gives the JAX int8 engine's greedy
    rows, and its cache takes (D + 4) / (2 D) of a 16-bit cache's bytes."""
    jmodel, cfg, module = pair
    prompts = _prompts([5, 11, 3, 17, 8], seed=41)
    budgets = [7, 5, 9, 4, 6]
    kw = dict(n_slots=2, max_len=32, prefill_chunks=[4, 8])
    engine = ServingEngine(module, ServingConfig(**kw, cache_dtype=torch.int8))
    got = engine.run(prompts, max_new_tokens=budgets)
    jengine = JaxServingEngine(jmodel, JaxServingConfig(**kw, cache_dtype=jnp.int8))
    want = jengine.run(prompts, max_new_tokens=budgets)
    for prompt, g, w in zip(prompts, got, want):
        assert _min_greedy_gap(cfg, module, g, len(prompt)) > MIN_GAP
        np.testing.assert_array_equal(g, np.asarray(w))
    k = engine._cache.k
    assert isinstance(k, gen.QuantPages) and k.data.dtype == torch.int8
    d = cfg.head_dim
    assert (engine._cache.k.nbytes + engine._cache.v.nbytes) * 2 * d == \
        2 * k.data.numel() * 2 * (d + 4)


# ---------------------------------------------------------------------------
# Admission control, deadlines, retries, quarantine and the hang guard,
# each against the JAX engine given the same submissions
# ---------------------------------------------------------------------------

ADMISSION = dict(n_slots=2, max_len=32, prefill_chunks=[4, 8])
BURST = [5, 9, 4, 7, 6, 3]
BURST_BUDGETS = [6, 4, 5, 3, 6, 4]


@pytest.fixture(scope="module")
def jax_engine(pair):
    """One JAX engine for the module, reset to a fresh engine's host state
    (and given a config) by ``_fresh``."""
    return JaxServingEngine(pair[0], JaxServingConfig(**ADMISSION))


def _fresh(jengine, **config):
    jengine.config = JaxServingConfig(**ADMISSION, **config)
    jengine._free = list(range(jengine.n_slots - 1, -1, -1))
    jengine._used_slots.clear()
    jengine._has_deadlines = jengine.config.deadline_s is not None
    jengine.reset_metrics()
    return jengine


class _Clock:
    """A perf_counter both packages read, moved by the test."""

    def __init__(self):
        self.now = 1000.0

    def __call__(self):
        return self.now


def _drive(engine, submissions, clock=None, step=1.0, max_ticks=200):
    """Submit ``(prompt, budget, kwargs)`` in turn, then tick until drained
    (advancing ``clock`` by ``step`` a tick); every poll row by id."""
    ids = [engine.submit(p, max_new_tokens=b, **kw) for p, b, kw in submissions]
    rows = {r["id"]: r for r in engine.poll()}
    for _ in range(max_ticks):
        if not engine.pending:
            break
        engine.tick()
        if clock is not None:
            clock.now += step
        rows.update((r["id"], r) for r in engine.poll())
    return [rows[i] for i in ids]


def _assert_rows_match(got, want):
    assert [r["status"] for r in got] == [r["status"] for r in want]
    for g, w in zip(got, want):
        assert set(g) == set(w) == POLL_ROW_KEYS
        for key in ("new_tokens", "attempt", "recovered", "drafted", "accepted",
                    "weights_version"):
            assert g[key] == w[key], key
        assert (g["ttft_s"] is None) == (w["ttft_s"] is None)
        np.testing.assert_array_equal(g["tokens"], np.asarray(w["tokens"]))


def _assert_blocks_match(engine, jengine, timed=False):
    stats, jstats = engine.stats(), jengine.stats()
    assert set(stats) == set(jstats) == SERVING_STATS_KEYS
    assert set(stats["faults"]) == FAULTS_KEYS and stats["faults"] == jstats["faults"]
    assert set(stats["speculation"]) == SPECULATION_KEYS
    assert set(stats["window"]) == WINDOW_KEYS
    keys = ["requests", "capacity", "ok", "shed_rate", "timeout_rate", "failed_rate",
            "queue_depth_p95", "prompt_decode_ratio"]
    if timed:  # the same clock: the latencies agree too
        keys += ["ttft_p50_s", "ttft_p95_s", "tpot_p50_s", "tpot_p95_s"]
    for key in keys:
        assert stats["window"][key] == jstats["window"][key], key
    for key in ("requests_submitted", "requests_completed", "tokens_out", "prompt_tokens_in",
                "prefill_chunks", "prefill_pad_tokens", "decode_steps", "ticks",
                "slot_allocs", "slot_reuses", "mean_queue_depth", "peak_occupancy"):
        assert stats[key] == jstats[key], key
    assert stats["journal"] is None and stats["weights_version"] == 0


@pytest.mark.parametrize("policy,shed", [("reject", [2, 3, 4, 5]), ("shed_oldest", [0, 1, 2, 3]),
                                         ("block", [])])
def test_overload_policies_match_jax(pair, jax_engine, policy, shed):
    """Six requests submitted before the first tick into a queue of two:
    ``reject`` sheds the four that find it full, ``shed_oldest`` the four
    oldest, ``block`` none (submit ticks the engine until there is room)."""
    _, _, module = pair
    subs = [(p, b, {}) for p, b in zip(_prompts(BURST, seed=42), BURST_BUDGETS)]
    cfg = dict(max_queue_depth=2, overload_policy=policy)
    engine = ServingEngine(module, ServingConfig(**ADMISSION, **cfg))
    got = _drive(engine, subs)
    jengine = _fresh(jax_engine, **cfg)
    want = _drive(jengine, subs)
    _assert_rows_match(got, want)
    assert [i for i, r in enumerate(got) if r["status"] == "shed"] == shed
    for i, (row, (prompt, budget, _)) in enumerate(zip(got, subs)):
        if i in shed:
            assert row["weights_version"] is None and row["new_tokens"] == 0
            np.testing.assert_array_equal(row["tokens"][len(prompt):], 0)
        else:
            want_row = generate(module, prompt[None], max_new_tokens=budget)[0].numpy()
            np.testing.assert_array_equal(row["tokens"], want_row)
    _assert_blocks_match(engine, jengine)
    assert engine.stats()["faults"]["sheds"] == len(shed)
    assert engine.window_stats()["shed_rate"] == len(shed) / len(subs)


def test_deadlines_match_jax(pair, jax_engine, monkeypatch):
    """Per-request and default deadlines on one clock: the requests past
    theirs finish ``timeout`` mid-decode with the tokens they had, their
    slots go to the queued requests, and the others finish ``ok``."""
    _, _, module = pair
    clock = _Clock()
    monkeypatch.setattr(time, "perf_counter", clock)
    prompts = _prompts(BURST, seed=43)
    per_request = [{"deadline_s": 6.5}, {}, {"deadline_s": 3.5}, {}, {}, {"deadline_s": 0.5}]
    subs = [(p, b + 6, kw) for p, b, kw in zip(prompts, BURST_BUDGETS, per_request)]
    engine = ServingEngine(module, ServingConfig(**ADMISSION, deadline_s=60.0))
    got = _drive(engine, subs, clock)
    clock.now = 1000.0
    jengine = _fresh(jax_engine, deadline_s=60.0)
    want = _drive(jengine, subs, clock)
    _assert_rows_match(got, want)
    assert [r["status"] for r in got] == ["timeout", "ok", "timeout", "ok", "ok", "timeout"]
    assert 0 < got[0]["new_tokens"] < subs[0][1]        # cut mid-decode
    assert got[5]["ttft_s"] is None                      # expired in the queue
    assert engine.stats()["slot_reuses"] >= 2             # timed-out slots granted again
    _assert_blocks_match(engine, jengine, timed=True)


@pytest.mark.parametrize("max_retries", [0, 1])
def test_prefill_failures_retry_or_fail_like_jax(pair, jax_engine, max_retries):
    """The second and third prefill calls raise: with one retry the
    request replays and finishes ``ok`` on attempt 2 (its slot freed and
    granted again), with none it finishes ``failed``."""
    _, _, module = pair
    subs = [(p, b, {}) for p, b in zip(_prompts(BURST[:4], seed=44), BURST_BUDGETS)]

    def failing(step):
        calls = [0]

        def prefill(*args, **kwargs):
            calls[0] += 1
            if calls[0] in (2, 3):
                raise RuntimeError("injected prefill failure")
            return step(*args, **kwargs)

        return prefill

    engine = ServingEngine(module, ServingConfig(**ADMISSION, max_retries=max_retries))
    engine._prefill = failing(engine._prefill)
    got = _drive(engine, subs)
    jengine = _fresh(jax_engine, max_retries=max_retries)
    step = jengine._prefill
    jengine._prefill = failing(step)
    try:
        want = _drive(jengine, subs)
    finally:
        jengine._prefill = step
    _assert_rows_match(got, want)
    # Call 2 is request 0's second chunk, call 3 request 1's first.
    if max_retries:
        assert [(r["status"], r["attempt"]) for r in got] == [("ok", 2), ("ok", 2), ("ok", 1),
                                                               ("ok", 1)]
        for row, (prompt, budget, _) in zip(got, subs):
            np.testing.assert_array_equal(row["tokens"], generate(
                module, prompt[None], max_new_tokens=budget)[0].numpy())
    else:
        assert [r["status"] for r in got] == ["failed", "failed", "ok", "ok"]
    _assert_blocks_match(engine, jengine)


def _poison(engine, slot):
    """NaN into a port engine's cache rows of ``slot`` (the JAX engine's
    ``_poison_slot``)."""
    engine._cache.k[:, slot] = float("nan")
    engine._cache.v[:, slot] = float("nan")


def test_poisoned_slot_is_quarantined_and_retried_like_jax(pair):
    """NaN written into a live slot's cache rows: the sentinel quarantines
    the slot, the request replays in the other slot and finishes ``ok``
    with a clean run's greedy tokens on attempt 2; a sampled request
    replays its generator's tokens the same way."""
    jmodel, _, module = pair
    subs = [(p, b, {}) for p, b in zip(_prompts(BURST[:3], seed=45), [8, 4, 5])]
    # A window of two: window_stats() reads the last two requests only.
    engine = ServingEngine(module, ServingConfig(**ADMISSION, window_requests=2))
    jengine = JaxServingEngine(jmodel, JaxServingConfig(**ADMISSION, window_requests=2))
    runs = []
    for eng, j in ((engine, None), (jengine, jengine)):
        ids = [eng.submit(p, max_new_tokens=b) for p, b, _ in subs]
        rows = {}
        for tick in range(100):
            if not eng.pending:
                break
            if tick == 5:
                assert 0 in eng._decoding
                if j is None:
                    _poison(eng, 0)
                else:
                    j._poison_slot(0)
            eng.tick()
            rows.update((r["id"], r) for r in eng.poll())
        runs.append([rows[i] for i in ids])
    got, want = runs
    _assert_rows_match(got, want)
    assert [r["status"] for r in got] == ["ok"] * 3 and got[0]["attempt"] == 2
    for row, (prompt, budget, _) in zip(got, subs):
        np.testing.assert_array_equal(row["tokens"], generate(
            module, prompt[None], max_new_tokens=budget)[0].numpy())
    faults = engine.fault_stats()
    assert faults == jengine.fault_stats()
    assert (faults["slot_quarantines"], faults["quarantined_slots"], faults["retries"]) == (1, 1, 1)
    _assert_blocks_match(engine, jengine)
    assert engine.window_stats()["requests"] == engine.window_stats()["capacity"] == 2

    sampled = ServingConfig(**ADMISSION, temperature=0.9, top_k=30)
    clean = ServingEngine(module, sampled).run(
        [subs[0][0]], max_new_tokens=8, generators=[torch.Generator().manual_seed(5)])[0]
    engine = ServingEngine(module, sampled)
    rid = engine.submit(subs[0][0], max_new_tokens=8, generator=torch.Generator().manual_seed(5))
    for _ in range(4):
        engine.tick()
    _poison(engine, 0)
    while engine.pending:
        engine.tick()
    (row,) = engine.poll()
    assert row["id"] == rid and row["attempt"] == 2
    np.testing.assert_array_equal(row["tokens"], clean)


def test_every_slot_quarantined_raises_the_stall_error_like_jax(pair):
    """Both slots poisoned: their requests wait for a slot that never
    frees, and ``max_idle_ticks`` ticks later the engine raises
    ``ServingStalledError`` naming them and the quarantined slots."""
    jmodel, _, module = pair
    subs = _prompts([4, 6, 5], seed=46)
    cfg = dict(ADMISSION, max_idle_ticks=4)
    engine = ServingEngine(module, ServingConfig(**cfg))
    jengine = JaxServingEngine(jmodel, JaxServingConfig(**cfg))
    ticks = []
    for eng, error in ((engine, serving.ServingStalledError),
                       (jengine, jax_serving.ServingStalledError)):
        for p in subs:
            eng.submit(p, max_new_tokens=8)
        while len(eng._decoding) < 2:
            eng.tick()
        for slot in (0, 1):
            if eng is engine:
                _poison(engine, slot)
            else:
                eng._poison_slot(slot)
        n = 0
        with pytest.raises(error) as info:
            while True:
                n += 1
                eng.tick()
        ticks.append(n)
        assert "2/2 slots quarantined" in str(info.value)
        assert "0:queued" in str(info.value) and "1:queued" in str(info.value)
    # One tick flags the slots (progress: the decode step), then the fourth
    # idle one raises.
    assert ticks[0] == ticks[1] == 1 + 4
    assert engine.fault_stats() == jengine.fault_stats()


# ---------------------------------------------------------------------------
# Chaos, the decode canary and the preemption drain (ROADMAP item 12.1)
# ---------------------------------------------------------------------------

CHAOS_RATES = {"prefill_dispatch": 0.12, "decode_tick": {"poison": 0.08}}


def _statuses(engine, prompts, budgets):
    ids = [engine.submit(p, max_new_tokens=b) for p, b in zip(prompts, budgets)]
    rows = {}
    for _ in range(2000):
        if not engine.pending:
            break
        engine.tick()
        rows.update({r["id"]: r for r in engine.poll()})
    return [rows[i] for i in ids]


@pytest.mark.parametrize("seed", [3, 11])
def test_chaos_statuses_equal_the_jax_engines(pair, seed):
    """One injector's schedule (transfer errors at prefill dispatch, NaN
    pages at decode ticks; one retry each) through both engines: the same
    faults drawn, the same status for every request, equal rows for those
    that finish ``ok``, and the same fault counters."""
    from accelerate_tpu import FaultInjector as JaxInjector
    from accelerate_tpu_torch import FaultInjector

    jmodel, _, module = pair
    prompts = _prompts([3, 7, 12, 20, 5, 9, 4, 11], seed=21)
    budgets = [6, 4, 8, 3, 6, 5, 7, 2]
    kw = dict(n_slots=3, max_len=64, prefill_chunks=[4, 8], max_retries=1)
    port = ServingEngine(Model(module), ServingConfig(**kw),
                         chaos=FaultInjector(seed=seed, rates=CHAOS_RATES))
    jeng = JaxServingEngine(jmodel, JaxServingConfig(**kw),
                            chaos=JaxInjector(seed=seed, rates=CHAOS_RATES))
    got, want = _statuses(port, prompts, budgets), _statuses(jeng, prompts, budgets)
    assert port.chaos.injected == jeng.chaos.injected and port.chaos.injected
    assert [r["status"] for r in got] == [r["status"] for r in want]
    assert {r["status"] for r in got} >= {"ok"}
    for g, w in zip(got, want):
        assert g["attempt"] == w["attempt"]
        if g["status"] == "ok":
            np.testing.assert_array_equal(g["tokens"], np.asarray(w["tokens"]))
    keys = ("failed", "retries", "slot_quarantines", "injected")
    pf, jf = port.fault_stats(), jeng.fault_stats()
    assert {k: pf[k] for k in keys} == {k: jf[k] for k in keys}


def test_a_decode_poison_fails_exactly_its_request(pair):
    """With no retry, the request whose slot a ``decode_tick`` poison hits
    fails and its slot leaves rotation; every other request's row equals
    the fault-free run's."""
    from accelerate_tpu_torch import FaultInjector

    _, _, module = pair
    prompts = _prompts([5, 9, 6, 7], seed=4)
    budgets = [6, 6, 6, 6]
    kw = dict(n_slots=4, max_len=64, prefill_chunks=[4, 8], max_retries=0)
    clean = _statuses(ServingEngine(module, ServingConfig(**kw)), prompts, budgets)
    engine = ServingEngine(module, ServingConfig(**kw), chaos=FaultInjector(
        schedule=[{"point": "decode_tick", "kind": "poison", "tick": 4}]))
    got = _statuses(engine, prompts, budgets)
    assert [r["status"] for r in got] == ["failed", "ok", "ok", "ok"]
    for g, c in zip(got[1:], clean[1:]):
        np.testing.assert_array_equal(g["tokens"], c["tokens"])
    assert engine.fault_stats()["quarantined_slots"] == 1


def test_decode_canary_sees_a_bit_flip_only(pair):
    """``DecodeCanary(every=4)``: no mismatch in a fault-free run (its rows
    never reach poll()), one or more under a ``decode_tick`` bit flip of
    the canary's own slot, which no NaN sentinel sees."""
    from accelerate_tpu_torch import DecodeCanary, FaultInjector

    _, _, module = pair
    kw = dict(n_slots=2, max_len=64, prefill_chunks=[4, 8])
    prompts = _prompts([5, 9, 6, 7], seed=8)
    for flips, want in ((None, 0), ([{"point": "decode_tick", "kind": "bit_flip",
                                      "count": 40, "slot": 0}], 1)):
        engine = ServingEngine(module, ServingConfig(**kw))
        canary = DecodeCanary(engine, every=4, max_new_tokens=4)
        canary.warmup()
        assert canary.armed and canary.golden_digest is not None
        engine.chaos = FaultInjector(schedule=flips) if flips else None
        rows = _statuses(engine, prompts, [6] * 4)
        for _ in range(12):
            engine.tick()
        assert len(rows) == 4 and all(r["id"] not in canary.probe_rids for r in rows)
        summary = engine.sdc_stats()
        assert summary["probes"] >= 1
        assert (summary["mismatches"] >= want) if want else summary["mismatches"] == 0


def test_preemption_drain_sheds_the_queue_and_finishes_in_flight(pair):
    """A preempted fault-tolerance manager: queued requests are shed, the
    ones holding a slot finish ``ok`` (the fault-free rows), a new submit
    is shed, and the engine's exit code is 75."""
    import types

    _, _, module = pair
    prompts = _prompts([5, 9, 6, 7, 8, 4], seed=12)
    kw = dict(n_slots=2, max_len=64, prefill_chunks=[8])
    clean = _statuses(ServingEngine(module, ServingConfig(**kw)), prompts, [5] * 6)
    ft = types.SimpleNamespace(preempted=False)
    engine = ServingEngine(module, ServingConfig(**kw), fault_tolerance=ft)
    ids = [engine.submit(p, max_new_tokens=5) for p in prompts]
    engine.tick()
    ft.preempted = True
    rows = {}
    while engine.pending:
        engine.tick()
        rows.update({r["id"]: r for r in engine.poll()})
    late = engine.submit(prompts[0], max_new_tokens=5)
    rows.update({r["id"]: r for r in engine.poll()})
    assert [rows[i]["status"] for i in ids] == ["ok", "ok", "shed", "shed", "shed", "shed"]
    for i in ids[:2]:
        np.testing.assert_array_equal(rows[i]["tokens"], clean[i]["tokens"])
    assert rows[late]["status"] == "shed"
    assert engine.preempted and engine.preemption_exit_code == 75
    assert engine.fault_stats()["preempted"] is True


def test_engine_crash_and_tracing_stay_refused(pair):
    from accelerate_tpu_torch import FaultInjector

    _, _, module = pair
    with pytest.raises(NotImplementedError, match="item 12.2"):
        ServingEngine(module, ServingConfig(n_slots=1, max_len=32),
                      chaos=FaultInjector(rates={"engine_crash": 0.1}))
    with pytest.raises(NotImplementedError, match="item 12.2"):
        ServingEngine(module, ServingConfig(n_slots=1, max_len=32), tracing=object())
