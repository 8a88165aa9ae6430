"""The port's silent-data-corruption sentinel (accelerate_tpu_torch.sdc)
against the JAX package's (accelerate_tpu.sdc), on the CPU.

- ``integrity_digest`` of the tiny fp32 Llama's parameters (both
  ``scan_layers`` layouts) within 1e-6 relative of the JAX digest of the
  same weights converted to the flax tree: the sums' orders differ, so not
  bit for bit; the port's digest equals itself bit for bit across calls;
- ``vote`` and ``flip_float32`` equal the JAX functions over a grid of
  tables and values (exactly); ``SDCConfig``'s checks and the quarantine
  record are the JAX package's;
- the sentinel's bit-flip modes and its golden capture putting the live
  state back bit for bit;
- the digest in a prepared step's metrics, and one step's digest equal on
  a replay of the same step (the golden probe's premise).

The votes, the probe's transient repair (rollback) and sticky conviction
(exit 79, ``sdc_quarantine.json``) at ``dp_replicate=2`` and the 3-rank
majority broadcast repair at ``dp_replicate=4`` run in the gangs of
``tests/test_torch_distributed.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from accelerate_tpu_torch import Accelerator, FaultToleranceKwargs, Model, adamw
from accelerate_tpu_torch import sdc
from accelerate_tpu_torch.chaos import Fault
from accelerate_tpu_torch.models import (
    LlamaConfig,
    LlamaForCausalLM,
    cross_entropy_loss,
    llama_params_to_flax,
)
from accelerate_tpu_torch.state import AcceleratorState, GradientState, PartialState

DIGEST_RTOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def reset_port_state():
    yield
    for cls in (AcceleratorState, GradientState, PartialState):
        cls._reset_state()


def _llama(scan_layers=True, seed=0):
    cfg = LlamaConfig.tiny(dtype=torch.float32, num_hidden_layers=3, hidden_size=64,
                           scan_layers=scan_layers)
    module = LlamaForCausalLM(cfg)
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.copy_(torch.from_numpy(rng.standard_normal(p.shape).astype(np.float32)))
    return cfg, module


@pytest.mark.parametrize("scan_layers", [True, False], ids=["stacked", "unrolled"])
def test_digest_matches_the_jax_digest(scan_layers):
    import jax
    import jax.numpy as jnp

    from accelerate_tpu.sdc import integrity_digest as jax_digest

    cfg, module = _llama(scan_layers)
    tree = llama_params_to_flax(cfg, dict(module.named_parameters()))
    want = float(jax_digest(jax.tree.map(lambda t: jnp.asarray(t.detach().numpy()), tree),
                            jnp.float32(1.25)))
    plan = sdc.DigestPlan(module)
    got = float(sdc.integrity_digest(plan, torch.tensor(1.25)))
    assert abs(got - want) <= DIGEST_RTOL * abs(want)
    assert float(sdc.integrity_digest(plan, torch.tensor(1.25))) == got
    # The leaf weights: every flax leaf of the tree gets one, in its order.
    leaves = jax.tree_util.tree_leaves(tree)
    assert sorted({w for _, _, ws in plan.groups for w in ws.tolist()}) == \
        sorted({float(i % 31 + 1) for i in range(len(leaves))})


def test_vote_and_flip_equal_the_jax_functions():
    from accelerate_tpu import sdc as jsdc

    tables = [[1.0, 1.0], [1.0, 2.0], [3.0, 3.0, 4.0], [1.0, 2.0, 3.0], [5.0, 5.0, 5.0, 6.0],
              [1.0, 1.0, 2.0, 2.0], [0.1 + 0.2, 0.3], [7.0, 7.0, 7.0, 7.0]]
    for t in tables:
        assert sdc.vote(t) == jsdc.vote(t)
    rng = np.random.default_rng(2)
    for v in rng.normal(size=20).tolist() + [0.0, 1e30, -3.5]:
        for bit in (0, 5, 22):
            got = sdc.flip_float32(v, bit)
            assert got == jsdc.flip_float32(v, bit) and np.isfinite(got)
            assert sdc.flip_float32(got, bit) == float(np.float32(v))


def test_config_and_quarantine_are_the_jax_packages(tmp_path):
    from accelerate_tpu import sdc as jsdc

    assert [(f.name, f.default) for f in dataclasses.fields(sdc.SDCConfig)] == \
        [(f.name, f.default) for f in dataclasses.fields(jsdc.SDCConfig)]
    for bad in (dict(vote_every=0), dict(repair="pray"), dict(probe="maybe"),
                dict(max_repairs=-1), dict(bit=23)):
        with pytest.raises(ValueError) as got:
            sdc.SDCConfig(**bad)
        with pytest.raises(ValueError) as want:
            jsdc.SDCConfig(**bad)
        assert str(got.value) == str(want.value)
    entry = {"process_index": 1, "host": "h", "step": 3, "tick": 4, "reason": "r", "time": 0.0}
    sdc.record_quarantine(str(tmp_path), entry)
    assert jsdc.load_quarantine(str(tmp_path)) == {"hosts": [entry]}
    jsdc.record_quarantine(str(tmp_path), entry)
    assert sdc.load_quarantine(str(tmp_path)) == {"hosts": [entry, entry]}
    (tmp_path / "sdc_quarantine.json").write_text("{torn")
    assert sdc.load_quarantine(str(tmp_path)) == {"hosts": []}
    assert sdc.load_quarantine(None) == {"hosts": []}


def _acc(tmp_path, **sdc_kw):
    acc = Accelerator(cpu=True, kwargs_handlers=[FaultToleranceKwargs(
        sentinel="off", sdc=dict(vote_every=1, **sdc_kw))])
    _, module = _llama(seed=1)
    with torch.no_grad():
        for p in module.parameters():
            p.mul_(0.05)
    acc.prepare(Model(module), adamw(1e-3))

    def loss_fn(m, b):
        return cross_entropy_loss(m(b["ids"][:, :-1]), b["ids"][:, 1:])

    return acc, acc.prepare_train_step(loss_fn, max_grad_norm=1.0)


def _ids(seed):
    return {"ids": torch.from_numpy(np.random.default_rng(seed).integers(0, 256, (2, 9)))}


def test_golden_capture_restores_the_live_state_and_replays(tmp_path):
    """The golden capture runs the step and puts every tensor back: the
    first real step is the one a run without SDC takes; the step's digest
    rides its metrics and a replay of the golden step gives the golden
    digest bit for bit."""
    acc, step = _acc(tmp_path)
    sentinel = acc.fault_tolerance.sdc
    assert sentinel.needs_golden
    state, m = step(acc.train_state, _ids(0))
    assert not sentinel.needs_golden and "sdc_digest" in m
    golden = sentinel._golden["digest"]
    assert golden == float(m["sdc_digest"])  # capture and step 1: the same step
    for cls in (AcceleratorState, GradientState, PartialState):
        cls._reset_state()
    plain = Accelerator(cpu=True)
    _, module = _llama(seed=1)
    with torch.no_grad():
        for p in module.parameters():
            p.mul_(0.05)
    plain.prepare(Model(module), adamw(1e-3))
    pstep = plain.prepare_train_step(
        lambda mm, b: cross_entropy_loss(mm(b["ids"][:, :-1]), b["ids"][:, 1:]),
        max_grad_norm=1.0)
    _, pm = pstep(plain.train_state, _ids(0))
    assert float(pm["loss"]) == float(m["loss"])
    for (n, a), b in zip(state.model.module.named_parameters(), module.parameters()):
        assert torch.equal(a, b), n
    before = [p.detach().clone() for p in state.model.module.parameters()]
    assert sentinel._run_probe() is False  # the replay: bit-equal
    assert all(torch.equal(a, b) for a, b in zip(before, state.model.module.parameters()))
    assert sentinel.summary()["probes"] == 1


def test_bit_flip_modes_and_single_process_observe(tmp_path):
    acc, step = _acc(tmp_path)
    sentinel = acc.fault_tolerance.sdc
    sentinel.note_bit_flip(Fault("train_step", "bit_flip", 4, 0, 0.1, {"mode": "transient"}))
    assert sentinel.take_flip() is not None and not sentinel._sticky
    sentinel.note_bit_flip(Fault("train_step", "bit_flip", 5, 0, 0.1, {"mode": "sticky"}))
    assert sentinel._sticky
    assert sentinel.observe(3.0, 0, None) is None  # one process: nothing to vote with
    assert sentinel.summary()["digests"] == 1
    with pytest.raises(NotImplementedError, match="item 12.5"):
        sdc.DecodeCanary(object(), autoscaler=object())
