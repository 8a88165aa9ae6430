"""Speculative decoding in the port's serving engine
(accelerate_tpu_torch/serving.py, ``ServingConfig.speculate_k``) against
the JAX package's engine and the port's one-token engine.

The tiny Llama (fp32, GQA) is initialised by flax and carried over with
``llama_params_from_flax``; prompts are numpy-seeded, half of them a short
motif repeated so that the n-gram draft is accepted. The JAX engines are
built once for the module. Greedy token comparisons also assert the top-2
logit gap of every step, so equal tokens are not luck at a near-tie.
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
from accelerate_tpu_torch import Model, ServingConfig, ServingEngine
from accelerate_tpu_torch import serving
from accelerate_tpu_torch.models import LlamaConfig, LlamaForCausalLM, llama_params_from_flax

MIN_GAP = 1e-4  # top-2 logit gap each greedy step must exceed
KS = (1, 2, 4)
# Prompt lengths and budgets; max_len is the longest prompt + budget, so
# the last windows of that request write past the slot's capacity.
LENGTHS = [5, 12, 20, 7, 16, 9]
BUDGETS = [10, 7, 8, 12, 9, 6]
MAX_LEN = 28
ENGINE = dict(n_slots=3, max_len=MAX_LEN, prefill_chunks=[4, 8], speculate_ngram=8)


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
    jcfg = JaxLlamaConfig.tiny(dtype=jnp.float32, attention_impl="native")
    probe = np.random.default_rng(0).integers(0, jcfg.vocab_size, (1, 8), dtype=np.int32)
    jmodel = JaxModel.from_flax(JaxLlama(jcfg), jax.random.key(0), probe)
    cfg = LlamaConfig.tiny(dtype=torch.float32)
    module = LlamaForCausalLM(cfg)
    module.load_state_dict(llama_params_from_flax(cfg, jax.tree.map(np.asarray, jmodel.params)))
    return jmodel, cfg, module


def _prompts():
    """Random prompts and motif prompts (a 3-token motif repeated)."""
    rng = np.random.default_rng(31)
    out = []
    for i, n in enumerate(LENGTHS):
        if i % 2:
            out.append(np.resize(rng.integers(1, 256, (3,), dtype=np.int32), n))
        else:
            out.append(rng.integers(1, 256, (n,), dtype=np.int32))
    return out


def _min_greedy_gap(module, row, prompt_len, eos):
    new = np.asarray(row[prompt_len:])
    end = prompt_len + (int(np.flatnonzero(new == eos)[0]) + 1 if (new == eos).any()
                        else new.size)
    with torch.no_grad():
        logits = module(torch.as_tensor(np.asarray(row[:end])).long()[None])[0]
    top2 = torch.topk(logits[prompt_len - 1:end - 1], 2, dim=-1).values
    return float((top2[:, 0] - top2[:, 1]).min())


def _drain(engine, prompts, **submit_kw):
    ids = [engine.submit(p, max_new_tokens=b, **submit_kw) for p, b in zip(prompts, BUDGETS)]
    rows = {}
    while engine.pending:
        engine.tick()
        rows.update((r["id"], r) for r in engine.poll())
    return [rows[i] for i in ids]


@pytest.fixture(scope="module")
def runs(pair):
    """Poll rows, stats and final slot histories of the port's engine at
    k = 0, 1, 2, 4 and the JAX engine's at k = 1, 2, 4, greedy with an EOS
    id that some rows emit."""
    jmodel, _, module = pair
    prompts = _prompts()
    plain = ServingEngine(Model(module), ServingConfig(**ENGINE))
    first = _drain(plain, prompts)
    eos = int(first[0]["tokens"][LENGTHS[0] + 4])  # row 0's fifth new token
    out = {"prompts": prompts, "eos": eos}
    for k in (0, *KS):
        engine = ServingEngine(module, ServingConfig(**ENGINE, speculate_k=k, eos_token_id=eos))
        out[k] = (_drain(engine, prompts), engine.stats(), engine._state.history.numpy().copy())
    for k in KS:
        jengine = JaxServingEngine(jmodel, JaxServingConfig(**ENGINE, speculate_k=k,
                                                            eos_token_id=eos))
        out["jax", k] = (_drain(jengine, prompts), jengine.stats(),
                         np.asarray(jengine._state.history))
    return out


def test_ngram_draft_matches_jax():
    rng = np.random.default_rng(32)
    for h, k in ((2, 1), (4, 3), (8, 4), (16, 6)):
        hist = rng.integers(0, 5, (64, h)).astype(np.int32)
        hist[::3, : h // 2] = -1                     # slots early in their history
        last = hist[:, -1].copy()
        last[::7] = 9                                # a token with no earlier match
        want = np.asarray(jax_serving._ngram_draft(jnp.asarray(hist), jnp.asarray(last), k))
        got = serving._ngram_draft(torch.from_numpy(hist).long(), torch.from_numpy(last).long(),
                                   k)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("k", KS)
def test_greedy_speculation_matches_jax_and_the_one_token_engine(pair, runs, k):
    _, _, module = pair
    rows, _, hist = runs[k]
    jrows, _, jhist = runs["jax", k]
    for prompt, row, plain, jrow in zip(runs["prompts"], rows, runs[0][0], jrows):
        assert row["status"] == "ok"
        assert _min_greedy_gap(module, row["tokens"], len(prompt), runs["eos"]) > MIN_GAP
        np.testing.assert_array_equal(row["tokens"], plain["tokens"])
        np.testing.assert_array_equal(row["tokens"], np.asarray(jrow["tokens"]))
    # Some rows stop at the EOS id, inside a window.
    assert any(r["new_tokens"] < b for r, b in zip(rows, BUDGETS))
    np.testing.assert_array_equal(hist, jhist)


@pytest.mark.parametrize("k", KS)
def test_speculation_counts_match_jax(runs, k):
    rows, stats, _ = runs[k]
    jrows, jstats, _ = runs["jax", k]
    assert [(r["drafted"], r["accepted"]) for r in rows] == \
        [(r["drafted"], r["accepted"]) for r in jrows]
    spec, jspec = stats["speculation"], jstats["speculation"]
    assert set(spec) == set(jspec)
    for key in ("k", "ngram", "drafted", "accepted", "acceptance_rate", "tokens_per_tick"):
        assert spec[key] == jspec[key], key
    assert spec["drafted"] == sum(r["drafted"] for r in rows)
    assert spec["accepted"] == sum(r["accepted"] for r in rows)
    assert all(r["drafted"] >= r["accepted"] for r in rows)
    assert spec["accepted"] > 0 and spec["verify_time_s"] > 0
    # Fewer decode steps than the one-token engine for the same tokens.
    assert stats["tokens_out"] == runs[0][1]["tokens_out"]
    assert stats["decode_steps"] < runs[0][1]["decode_steps"]
    assert runs[0][1]["speculation"] == {
        "k": 0, "ngram": 8, "drafted": 0, "accepted": 0, "acceptance_rate": None,
        "tokens_per_tick": 0.0, "verify_time_s": 0.0}


def test_sampled_acceptance_keeps_the_target_distribution():
    """With the uniforms given as input (numpy-seeded), over a 5-token
    vocab: the first emitted token is distributed as p_0, the second
    (after an accepted first draft) as p_1, and the bonus token (both
    drafts accepted) as p_2, each frequency within 5 sigma."""
    n, v = 60000, 5
    p = torch.tensor([[0.1, 0.4, 0.2, 0.25, 0.05],
                      [0.3, 0.05, 0.15, 0.2, 0.3],
                      [0.2, 0.2, 0.1, 0.4, 0.1]], dtype=torch.float64)
    drafts = torch.tensor([[1, 4]]).expand(n, 2)
    rng = np.random.default_rng(33)
    u, u_resid, u_bonus = (torch.from_numpy(rng.random(shape)) for shape in
                           ((n, 2), (n, 2, v), (n, v)))
    out, m = serving._speculative_accept(p.float().expand(n, 3, v), drafts, u.float(),
                                         u_resid.float(), u_bonus.float())
    assert ((m >= 0) & (m <= 2)).all()
    np.testing.assert_array_equal(out[m >= 1, 0].numpy(), 1)
    for pos, rows in ((0, torch.ones(n, dtype=torch.bool)), (1, m >= 1), (2, m == 2)):
        tokens = out[rows, pos]
        freq = torch.bincount(tokens, minlength=v).double() / tokens.numel()
        sigma = torch.sqrt(p[pos] * (1 - p[pos]) / tokens.numel())
        assert ((freq - p[pos]).abs() <= 5 * sigma + 1e-12).all(), (pos, freq, p[pos])
    # The acceptance rates are p_0(d_0) and p_0(d_0) p_1(d_1).
    assert abs(float((m >= 1).double().mean()) - 0.4) < 5 * (0.4 * 0.6 / n) ** 0.5
    assert abs(float((m == 2).double().mean()) - 0.4 * 0.3) < 5 * (0.12 * 0.88 / n) ** 0.5


def test_sampled_speculation_follows_each_request_generator(pair):
    """temperature > 0 with k = 2: a request's tokens come from its own
    generator, in the documented draw order, so the same request gives the
    same tokens in another slot beside other neighbours."""
    _, _, module = pair
    prompts = _prompts()
    cfg = ServingConfig(**ENGINE, speculate_k=2, temperature=0.9, top_k=40)

    def run(order):
        engine = ServingEngine(module, cfg)
        ids = [engine.submit(prompts[i], max_new_tokens=BUDGETS[i],
                             generator=torch.Generator().manual_seed(100 + i)) for i in order]
        rows = {}
        while engine.pending:
            engine.tick()
            rows.update((r["id"], r) for r in engine.poll())
        return {i: rows[rid] for i, rid in zip(order, ids)}, engine.stats()

    a, stats = run(list(range(6)))
    b, _ = run([5, 3, 1, 0, 2, 4])
    for i in range(6):
        np.testing.assert_array_equal(a[i]["tokens"], b[i]["tokens"])
        assert a[i]["status"] == "ok" and a[i]["new_tokens"] == BUDGETS[i]
        assert a[i]["drafted"] >= a[i]["accepted"]
    assert stats["speculation"]["drafted"] == sum(r["drafted"] for r in a.values())
    assert len({tuple(r["tokens"][len(p):]) for r, p in zip(a.values(), prompts)}) == 6
