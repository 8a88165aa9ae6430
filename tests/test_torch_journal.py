"""The port's crash-durable request journal (accelerate_tpu_torch/journal.py)
and ``ServingEngine.recover()`` against the JAX package's.

- The codec: ``_encode`` byte-equal to the JAX package's for the same
  records; each package decodes the other's lines.
- ``RequestJournal`` operation sequences run on both packages' journals
  (torn tail, corrupt line, the three fsync policies, rotation and
  compaction, a torn append, a torn compaction, the adoption sentinel):
  the same files with the same bytes, the same replay and the same stats.
- Engines: a journal the JAX engine wrote is recovered by the port's
  engine and one the port's wrote by the JAX engine, with the same
  summaries and rows; ``client_request_id`` dedupe; ``recover()`` exactly
  once and bit-equal for greedy, sampled (per-request generators) and
  speculative requests; deadlines rebased on the monotonic clock; attempts
  accumulating over repeated crashes; ``engine_crash`` flushing, then
  exiting 78 (``os._exit`` patched). The "crash" here is an engine
  abandoned without ``close()``: the state a dead process leaves.
"""

import os
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from accelerate_tpu import FaultInjector as JaxInjector
from accelerate_tpu import Model as JaxModel
from accelerate_tpu import ServingConfig as JaxServingConfig
from accelerate_tpu import ServingEngine as JaxServingEngine
from accelerate_tpu import journal as jax_journal
from accelerate_tpu.models import LlamaConfig as JaxLlamaConfig
from accelerate_tpu.models import LlamaForCausalLM as JaxLlama
from accelerate_tpu_torch import (
    FaultInjector,
    JournalAdoptionError,
    Model,
    RequestJournal,
    ServingConfig,
    ServingEngine,
)
from accelerate_tpu_torch import journal
from accelerate_tpu_torch.models import LlamaConfig, LlamaForCausalLM, llama_params_from_flax

CFG = dict(n_slots=2, max_len=32, prefill_chunks=[4, 8])
SUMMARY_KEYS = ("recovered_inflight", "recovered_terminal", "records", "segments",
                "torn_tails", "corrupt_skipped")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the suite runs several test processes at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def pair():
    """(JAX Model, port Model) with one set of weights."""
    jcfg = JaxLlamaConfig.tiny(dtype=jnp.float32, attention_impl="native")
    probe = np.random.default_rng(0).integers(0, jcfg.vocab_size, (1, 8), dtype=np.int32)
    jmodel = JaxModel.from_flax(JaxLlama(jcfg), jax.random.key(0), probe)
    cfg = LlamaConfig.tiny(dtype=torch.float32)
    module = LlamaForCausalLM(cfg)
    module.load_state_dict(llama_params_from_flax(cfg, jax.tree.map(np.asarray, jmodel.params)))
    return jmodel, Model(module)


def _prompts(lengths, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 256, (n,), dtype=np.int32) for n in lengths]


def _drain(engine, guard=2000):
    rows = {r["id"]: r for r in engine.poll()}
    for _ in range(guard):
        if not engine.pending:
            break
        engine.tick()
        rows.update((r["id"], r) for r in engine.poll())
    assert not engine.pending
    return rows


def _until_done(engine, rid, guard=500):
    done = {}
    for _ in range(guard):
        if rid in done:
            return done
        engine.tick()
        done.update((r["id"], r) for r in engine.poll())
    raise AssertionError(f"request {rid} never finished")


def _files(d) -> dict:
    out = {}
    for name in sorted(os.listdir(d)):
        if name.startswith("wal_"):
            with open(os.path.join(d, name), "rb") as f:
                out[name] = f.read()
    return out


def _stats(j) -> dict:
    return {k: v for k, v in j.stats().items() if k != "dir"}


def _same_row(got, want):
    for key in ("id", "status", "new_tokens", "weights_version", "attempt", "recovered",
                "drafted", "accepted"):
        assert got[key] == want[key], key
    np.testing.assert_array_equal(got["tokens"], np.asarray(want["tokens"]))


# ---------------------------------------------------------------------------
# The codec and RequestJournal against the JAX package's
# ---------------------------------------------------------------------------

RECORDS = [
    {"t": "admit", "rid": 3, "cid": "req-3", "tokens": [1, 2, 3], "budget": 4, "rng": None,
     "deadline_s": 1.5, "t_mono": 1234.5678901234, "weights_version": 0},
    {"t": "progress", "tick": 7, "t_mono": 1.0, "toks": {"3": [9, 8], "4": [1]}},
    {"t": "terminal", "rid": 3, "cid": None, "status": "ok", "row": [1, 2, 3, 9, 8],
     "new_tokens": 2, "ttft_s": None, "tpot_s": 0.25, "weights_version": 1, "attempt": 2,
     "t_mono": 2.0, "drafted": 0, "accepted": 0, "note": "ünïcode ✓"},
]


def test_codec_is_byte_equal_to_the_jax_codec():
    for rec in RECORDS:
        line = journal._encode(rec)
        assert line == jax_journal._encode(rec)
        assert journal._decode(line.rstrip("\n")) == rec
        assert jax_journal._decode(line.rstrip("\n")) == rec
        assert journal._decode(line.rstrip("\n").replace("1", "7", 1)) is None
    for bad in ("nonsense", "deadbeef not-json", "zzzzzzzz {}", "0000000 {}"):
        assert journal._decode(bad) is None and jax_journal._decode(bad) is None
    assert journal.JOURNAL_FSYNC_POLICIES == jax_journal.JOURNAL_FSYNC_POLICIES


def _torn_tail(mod, d):
    j = mod.RequestJournal(d, fsync="os")
    j.append({"t": "admit", "rid": 0})
    j.append({"t": "admit", "rid": 1})
    j.close()
    path = [p for _, p in j._segments()][0]
    with open(path, "a", encoding="utf-8") as f:
        f.write(mod._encode({"t": "admit", "rid": 2})[:17])
    j2 = mod.RequestJournal(d)
    first = j2.replay()
    return [first, mod.RequestJournal(d).replay(), _stats(j2)]


def _corrupt_line(mod, d):
    j = mod.RequestJournal(d, fsync="os")
    for i in range(3):
        j.append({"t": "admit", "rid": i})
    j.close()
    path = [p for _, p in j._segments()][0]
    lines = open(path, encoding="utf-8").read().splitlines(keepends=True)
    lines[1] = "0badc0de " + lines[1].split(" ", 1)[1]
    with open(path, "w", encoding="utf-8") as f:
        f.writelines(lines)
    return [mod.RequestJournal(d).replay()]


def _fsync_policy(policy):
    def run(mod, d):
        j = mod.RequestJournal(d, fsync=policy)
        counts = []
        for i in range(3):
            j.append({"t": "admit", "rid": i})
            counts.append(j.stats()["syncs"])
            j.tick_flush()
            counts.append(j.stats()["syncs"])
        j.tick_flush()
        counts.append(j.stats()["syncs"])
        # Whatever the policy, the records reached the OS.
        return [counts, mod.RequestJournal(d).replay(), _stats(j)]
    return run


def _rotation_and_compaction(mod, d):
    j = mod.RequestJournal(d, fsync="os", segment_records=4)
    j.append({"t": "admit", "rid": 0, "cid": "a", "tokens": [1]})
    j.append({"t": "admit", "rid": 1, "cid": "b", "tokens": [2]})
    j.append({"t": "bind", "rid": 0, "weights_version": 0})
    j.append({"t": "bind", "rid": 1, "weights_version": 0})
    j.append({"t": "progress", "tick": 0, "toks": {"0": [7], "1": [8]}})
    j.append({"t": "terminal", "rid": 0, "cid": "a", "status": "ok", "row": [1, 7]})
    j.append({"t": "admit", "rid": 2, "tokens": [3]})
    j.append({"t": "admit", "rid": 3, "tokens": [4]})
    j.close()
    st = _stats(j)
    assert st["rotations"] >= 2 and st["compactions"] >= 1 and st["records_retired"] > 0
    return [mod.RequestJournal(d).replay(), st]


def _torn_append(mod, injector):
    def run(m, d):
        chaos = injector(seed=1, schedule=[
            {"point": "journal_append", "kind": "torn_write", "tick": 0, "unit": 1}])
        j = m.RequestJournal(d, fsync="os", chaos=chaos)
        for i in range(3):
            j.append({"t": "admit", "rid": i}, unit=i)
        j.close()
        assert j.stats()["torn_writes"] == 1
        return [m.RequestJournal(d).replay(), _stats(j)]
    return run


def _torn_compact(mod, injector):
    def run(m, d):
        chaos = injector(seed=1, schedule=[
            {"point": "journal_compact", "kind": "torn_write", "tick": 0}])
        j = m.RequestJournal(d, fsync="os", segment_records=3, chaos=chaos)
        j.append({"t": "admit", "rid": 0, "tokens": [1]})
        j.append({"t": "terminal", "rid": 0, "status": "ok", "row": [1]})
        j.append({"t": "admit", "rid": 1, "tokens": [2]})
        j.close()
        st = _stats(j)
        assert st["compact_aborts"] == 1 and st["compactions"] == 0
        assert not os.path.exists(os.path.join(d, "compact.jsonl.tmp"))
        out = m.RequestJournal(d).replay()
        j2 = m.RequestJournal(d)
        j2.replay()
        return [st, out, j2.compact()]
    return run


def _adoption(mod, d):
    j1 = mod.RequestJournal.adopt(d, "router:cell0")
    with pytest.raises(mod.JournalAdoptionError, match="already adopted"):
        mod.RequestJournal.adopt(d, "supervisor:pid=999")
    holder = mod.RequestJournal(d).adoption_holder()["owner"]
    j1.append({"t": "admit", "rid": 0})
    j1.close()
    released = mod.RequestJournal(d).adoption_holder()
    j2 = mod.RequestJournal.adopt(d, "supervisor")
    j3 = mod.RequestJournal.adopt(d, "forced", force=True)
    j2.release_adoption()
    j3.release_adoption()
    return [holder, released, j3.adopted, mod.RequestJournal(d).replay()]


CASES = {
    "torn_tail": lambda m, i: _torn_tail,
    "corrupt_line": lambda m, i: _corrupt_line,
    "fsync_every_record": lambda m, i: _fsync_policy("every_record"),
    "fsync_every_tick": lambda m, i: _fsync_policy("every_tick"),
    "fsync_os": lambda m, i: _fsync_policy("os"),
    "rotation_and_compaction": lambda m, i: _rotation_and_compaction,
    "torn_append": lambda m, i: _torn_append(m, i),
    "torn_compact": lambda m, i: _torn_compact(m, i),
    "adoption": lambda m, i: _adoption,
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_journal_operations_equal_the_jax_journals(tmp_path, case):
    out, files = [], []
    for mod, injector in ((journal, FaultInjector), (jax_journal, JaxInjector)):
        d = str(tmp_path / mod.__name__.split(".")[0])
        out.append(CASES[case](mod, injector)(mod, d))
        files.append(_files(d))
    assert out[0] == out[1]
    assert files[0] == files[1] and files[0]


def test_journal_validation():
    with pytest.raises(ValueError):
        RequestJournal("unused", fsync="sometimes")
    with pytest.raises(ValueError):
        RequestJournal("unused", segment_records=0)


# ---------------------------------------------------------------------------
# Engines: the journal across the packages, dedupe, recover()
# ---------------------------------------------------------------------------


def _crash_run(engine, prompts, budget=4, first_done=True):
    """Submit prompts[0] and run it to its end (when ``first_done``), then
    submit the rest and flush: the journal a process leaves when it dies
    there. Returns (ids, rows finished before the crash)."""
    ids = [engine.submit(prompts[0], max_new_tokens=budget, client_request_id="req-0")]
    done = _until_done(engine, ids[0]) if first_done else {}
    ids += [engine.submit(p, max_new_tokens=budget, client_request_id=f"req-{i}")
            for i, p in enumerate(prompts[1:], 1)]
    engine.journal.tick_flush()
    return ids, done


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_each_engine_recovers_the_others_journal(pair, tmp_path, writer):
    """A greedy crash journal written by one package's engine, recovered by
    both: equal summaries, cached rows and replayed rows, and the replays
    equal to an uninterrupted run's."""
    jmodel, model = pair
    prompts = _prompts([5, 9, 7])
    wal = str(tmp_path / "wal")
    make = {"jax": lambda **kw: JaxServingEngine(jmodel, JaxServingConfig(**CFG, **kw)),
            "port": lambda **kw: ServingEngine(model, ServingConfig(**CFG, **kw))}
    ref = _drain_ids(make[writer](), prompts)
    ids, done = _crash_run(make[writer](journal_dir=wal), prompts)
    port_recs, _ = RequestJournal(wal).replay()
    jax_recs, _ = jax_journal.RequestJournal(wal).replay()
    assert port_recs == jax_recs
    results = []
    for reader in ("port", "jax"):
        d = str(tmp_path / f"copy_{reader}")
        os.makedirs(d)
        for name, data in _files(wal).items():
            with open(os.path.join(d, name), "wb") as f:
                f.write(data)
        engine = make[reader](journal_dir=d)
        summary = engine.recover()
        rows = _drain(engine)
        results.append(({k: summary[k] for k in SUMMARY_KEYS}, rows))
    (ps, prow), (js, jrow) = results
    assert ps == js and ps["recovered_terminal"] == 1 and ps["recovered_inflight"] == 2
    assert sorted(prow) == sorted(jrow) == sorted(ids)
    for rid in ids:
        _same_row(prow[rid], jrow[rid])
        np.testing.assert_array_equal(prow[rid]["tokens"], np.asarray(ref[ids.index(rid)]))
    _same_row(prow[ids[0]], {**done[ids[0]], "recovered": True})


def _drain_ids(engine, prompts, budget=4):
    ids = [engine.submit(p, max_new_tokens=budget) for p in prompts]
    rows = _drain(engine)
    return [rows[i]["tokens"] for i in ids]


def test_submit_dedupes_on_client_request_id(pair, tmp_path):
    jmodel, model = pair
    (p,) = _prompts([5])
    out = []
    for engine in (ServingEngine(model, ServingConfig(**CFG, journal_dir=str(tmp_path / "a"))),
                   JaxServingEngine(jmodel, JaxServingConfig(**CFG,
                                                             journal_dir=str(tmp_path / "b")))):
        rid = engine.submit(p, max_new_tokens=3, client_request_id="req-0")
        assert engine.submit(p, max_new_tokens=3, client_request_id="req-0") == rid
        res = _drain(engine)
        assert len(res) == 1 and res[rid]["status"] == "ok"
        completed = engine.stats()["requests_completed"]
        assert engine.submit(p, max_new_tokens=3, client_request_id="req-0") == rid
        (row,) = engine.poll()
        _same_row(row, res[rid])
        assert engine.stats()["requests_completed"] == completed
        out.append((row, engine.stats()["journal"]))
    _same_row(out[0][0], out[1][0])
    keep = ("appends", "syncs", "rotations", "pending", "retired", "deduped",
            "recovered_inflight", "recovered_terminal")
    assert {k: out[0][1][k] for k in keep} == {k: out[1][1][k] for k in keep}
    assert set(out[0][1]) == set(out[1][1])
    assert out[0][1]["deduped"] == 2


def test_dedupe_without_a_journal(pair):
    _, model = pair
    engine = ServingEngine(model, ServingConfig(**CFG))
    (p,) = _prompts([6], seed=9)
    rid = engine.submit(p, max_new_tokens=3, client_request_id="k")
    rows = _drain(engine)
    assert engine.submit(p, max_new_tokens=3, client_request_id="k") == rid
    (row,) = engine.poll()
    np.testing.assert_array_equal(row["tokens"], rows[rid]["tokens"])
    assert engine.journal_stats() is None and engine.stats()["journal"] is None


@pytest.mark.parametrize("mode", ["greedy", "sampled", "speculative"])
def test_recover_exactly_once_and_bit_equal(pair, tmp_path, mode):
    """Request 0 finishes before the crash, request 1 is decoding, request
    2 queued: after recover() request 0's cached row comes back flagged and
    is not run again, the others replay bit-equal to an uninterrupted run
    on attempt 2, every request ends ``ok`` once, and re-submitting every
    key dedupes."""
    _, model = pair
    kw = dict(CFG, max_len=48, n_slots=1)
    if mode == "sampled":
        kw.update(temperature=0.8, top_k=40)
    if mode == "speculative":
        kw.update(speculate_k=2, speculate_ngram=8)
    prompts = _prompts([5, 9, 7], seed=17)
    gens = (lambda: [torch.Generator().manual_seed(100 + i) for i in range(3)]) \
        if mode == "sampled" else (lambda: [None] * 3)
    ref_engine = ServingEngine(model, ServingConfig(**{k: v for k, v in kw.items()
                                                       if not k.startswith("speculate")}))
    ref = ref_engine.run(prompts, max_new_tokens=8, generators=gens())
    wal = str(tmp_path / "wal")
    e1 = ServingEngine(model, ServingConfig(**kw, journal_dir=wal))
    g = gens()
    ids = [e1.submit(prompts[0], max_new_tokens=8, generator=g[0], client_request_id="r0")]
    done = _until_done(e1, ids[0])
    ids += [e1.submit(p, max_new_tokens=8, generator=g[i], client_request_id=f"r{i}")
            for i, p in enumerate(prompts[1:], 1)]
    for _ in range(4):  # request 1 prefilled and decoding, request 2 queued
        e1.tick()
    assert ids[1] in {r.id for r in e1._decoding.values()}
    assert ids[2] in {r.id for r in e1._queue}
    e1.journal.tick_flush()
    del e1
    e2 = ServingEngine(model, ServingConfig(**kw, journal_dir=wal))
    summary = e2.recover()
    assert (summary["recovered_terminal"], summary["recovered_inflight"]) == (1, 2)
    rows = {r["id"]: r for r in e2.poll()}
    assert rows[ids[0]]["recovered"] is True and rows[ids[0]]["attempt"] == 1
    np.testing.assert_array_equal(rows[ids[0]]["tokens"], done[ids[0]]["tokens"])
    for i, p in enumerate(prompts):
        assert e2.submit(p, max_new_tokens=8, client_request_id=f"r{i}") == ids[i]
    rows.update(_drain(e2))
    statuses = [r["status"] for r in rows.values()]
    assert sorted(rows) == sorted(ids) and statuses == ["ok"] * 3
    for i in (1, 2):
        assert rows[ids[i]]["recovered"] is True and rows[ids[i]]["attempt"] == 2
    for i in range(3):
        np.testing.assert_array_equal(rows[ids[i]]["tokens"], ref[i])
    # Executions after the crash: the two replays only.
    assert e2.stats()["requests_completed"] == 2
    assert e2.stats()["journal"]["deduped"] == 3
    if mode == "speculative":
        assert rows[ids[1]]["drafted"] > 0
    assert e2.submit(prompts[0], max_new_tokens=2) > max(ids)


def test_recover_requires_a_journal_and_refuses_a_held_one(pair, tmp_path):
    _, model = pair
    with pytest.raises(ValueError, match="needs a journal"):
        ServingEngine(model, ServingConfig(**CFG)).recover()
    wal = str(tmp_path / "wal")
    e1 = ServingEngine(model, ServingConfig(**CFG, journal_dir=wal))
    (p,) = _prompts([5])
    rid = e1.submit(p, max_new_tokens=3, client_request_id="req-0")
    e1.journal.tick_flush()
    del e1
    e2 = ServingEngine(model, ServingConfig(**CFG))
    assert e2.recover(journal_dir=wal)["recovered_inflight"] == 1 and e2.journal.adopted
    with pytest.raises(JournalAdoptionError, match="already adopted"):
        ServingEngine(model, ServingConfig(**CFG)).recover(journal_dir=wal)
    with pytest.raises(JournalAdoptionError, match="drained elsewhere"):
        ServingEngine(model, ServingConfig(**CFG, journal_dir=wal)).recover()
    rows = _drain(e2)
    assert rows[rid]["status"] == "ok" and rows[rid]["recovered"] is True
    e2.close()
    assert RequestJournal(wal).adoption_holder() is None


def test_recover_deadline_rebased_on_the_monotonic_clock(pair, tmp_path):
    """The journal's deadline is a budget with the submit time on the dead
    process's monotonic clock: 30 s spent of 100 leaves 70 on this one; an
    overspent budget is due now."""
    jmodel, model = pair
    left = []
    for budget_s, last in ((100.0, 1030.0), (10.0, 1500.0)):
        for name, make in (("port", lambda d: ServingEngine(
                model, ServingConfig(**CFG, journal_dir=d))), ("jax", lambda d: JaxServingEngine(
                jmodel, JaxServingConfig(**CFG, journal_dir=d)))):
            wal = str(tmp_path / f"{name}{budget_s}")
            j = RequestJournal(wal, fsync="os")
            j.append({"t": "admit", "rid": 0, "cid": None, "tokens": [1, 2, 3], "budget": 2,
                      "rng": None, "deadline_s": budget_s, "t_mono": 1000.0,
                      "weights_version": 0})
            j.append({"t": "progress", "tick": 5, "toks": {}, "t_mono": last})
            j.close()
            engine = make(wal)
            engine.recover()
            (req,) = list(engine._queue)
            left.append(req.deadline - time.perf_counter())
    assert 65.0 < left[0] <= 70.0 and 65.0 < left[1] <= 70.0
    assert left[2] <= 0.5 and left[3] <= 0.5


def test_repeated_crashes_accumulate_attempts(pair, tmp_path):
    _, model = pair
    def mk():
        return ServingEngine(model, ServingConfig(**CFG, journal_dir=str(tmp_path / "w")))

    (p,) = _prompts([5])
    e1 = mk()
    rid = e1.submit(p, max_new_tokens=3, client_request_id="req-0")
    e1.journal.tick_flush()
    del e1
    e2 = mk()
    assert e2.recover()["recovered_inflight"] == 1
    del e2
    e3 = mk()
    assert e3.recover()["recovered_inflight"] == 1
    rows = _drain(e3)
    assert rows[rid]["attempt"] == 3 and rows[rid]["recovered"] is True
    assert e3.stats()["faults"]["retries"] == 0


def test_engine_crash_flushes_then_exits_78(pair, tmp_path, monkeypatch):
    """The injected ``engine_crash`` after the tick's flush: the telemetry
    gets the crash event and the injector's log, the flight bundle is
    written, then ``os._exit(78)``; a new engine recovers the request."""
    from accelerate_tpu_torch import serving

    _, model = pair

    class _Tel:
        def __init__(self):
            self.events, self.closed = [], False

        def record_event(self, event, **fields):
            self.events.append(event)

        def close(self):
            self.closed = True

    class _Exit(BaseException):
        pass

    codes = []

    def fake_exit(code):
        codes.append(code)
        raise _Exit()

    monkeypatch.setattr(serving.os, "_exit", fake_exit)
    tel, wal = _Tel(), str(tmp_path / "wal")
    engine = ServingEngine(model, ServingConfig(**CFG, journal_dir=wal), telemetry=tel,
                           chaos=FaultInjector(seed=1, schedule=[
                               {"point": "engine_crash", "kind": "crash", "tick": 0}]))
    (p,) = _prompts([5])
    engine.submit(p, max_new_tokens=3, client_request_id="req-0")
    with pytest.raises(_Exit):
        engine.tick()
    assert codes == [78]
    assert "serving_engine_crash" in tel.events and "chaos_injected_log" in tel.events
    assert tel.closed
    e2 = ServingEngine(model, ServingConfig(**CFG, journal_dir=wal))
    assert e2.recover()["recovered_inflight"] == 1
    assert _drain(e2)[0]["status"] == "ok"


def test_canary_probe_and_warmup_stay_out_of_the_journal(pair, tmp_path):
    from accelerate_tpu_torch import DecodeCanary

    _, model = pair
    wal = str(tmp_path / "wal")
    engine = ServingEngine(model, ServingConfig(**CFG, journal_dir=wal))
    engine.warmup()
    canary = DecodeCanary(engine, every=2, max_new_tokens=2)
    canary.warmup()
    (p,) = _prompts([5])
    rid = engine.submit(p, max_new_tokens=4)
    rows = _until_done(engine, rid)  # the canary keeps the engine pending
    for _ in range(6):
        engine.tick()
        assert not engine.poll()
    assert canary.summary()["probes"] >= 1
    records, _ = RequestJournal(wal).replay()
    assert {r["rid"] for r in records if "rid" in r} == {rid}
    assert all(int(k) == rid for r in records if r["t"] == "progress" for k in r["toks"])
    assert list(rows) == [rid]
