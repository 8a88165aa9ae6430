"""``LocalSGD`` of the port against the JAX package's
(``accelerate_tpu/test_utils/scripts/test_local_sgd.py``, ``tests/test_local_sgd.py``).

On a gloo gang of 2 CPU processes spawned once for the module, under DDP
(``dp_replicate=2``, no plugin): the JAX script's regression ``a·x + b``
with SGD(0.1), each process fitting its own target (slope 1 on process 0,
3 on process 1), 20 steps inside ``LocalSGD(local_sgd_steps=4)``. Between
boundaries the processes train alone (DDP's reducer silenced, each loss its
own mean), so their parameters differ before each boundary and are
bit-equal after it; they equal a reference of two independent JAX
trainings (the JAX package's step, one state a target) averaged in fp32 at
the same boundaries and on leaving the block, within 1e-6. A model sharded
by FSDP2 is refused.

In this process: on one process ``LocalSGD`` does nothing, and the
Accelerator's step trains as it would without it.
"""

from __future__ import annotations

import pickle

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from accelerate_tpu_torch import (
    Accelerator,
    FullyShardedDataParallelPlugin,
    LocalSGD,
    Model,
    ParallelismConfig,
    adamw,
)
from accelerate_tpu_torch.state import AcceleratorState, GradientState, PartialState

STEPS, K, LR = 20, 4, 0.1


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _reset_port():
    for cls in (AcceleratorState, GradientState, PartialState):
        cls._reset_state()


@pytest.fixture(autouse=True)
def reset_port_state():
    yield
    _reset_port()


class Regression(torch.nn.Module):
    """The JAX test's ``a·x + b`` with both parameters starting at 0."""

    def __init__(self):
        super().__init__()
        self.a = torch.nn.Parameter(torch.zeros(()))
        self.b = torch.nn.Parameter(torch.zeros(()))

    def forward(self, x):
        return self.a * x + self.b


def _loss(m, batch):
    return ((m(batch["x"]) - batch["y"]) ** 2).mean()


def _batch(slope):
    x = np.linspace(-1, 1, 8).astype(np.float32)
    return {"x": x, "y": (slope * x).astype(np.float32)}


def _train(pc=None, plugin=None, steps=STEPS, k=K):
    """This process's run: (a, b) after each step, before and after
    ``lsgd.step()``, and at the end."""
    acc = Accelerator(cpu=True, parallelism_config=pc, fsdp_plugin=plugin)
    module = Regression()
    opt = adamw(LR) if plugin is not None else torch.optim.SGD(module.parameters(), lr=LR)
    model, _ = acc.prepare(Model(module), opt)
    step = acc.prepare_train_step(_loss)
    batch = {k_: torch.from_numpy(v) for k_, v in _batch(1.0 + 2.0 * acc.process_index).items()}
    state, before, after = acc.train_state, [], []
    with LocalSGD(acc, model, local_sgd_steps=k) as lsgd:
        for _ in range(steps):
            state, _ = step(state, batch)
            before.append([module.a.item(), module.b.item()])
            state = lsgd.step(state)
            after.append([module.a.item(), module.b.item()])
    return {"before": before, "after": after, "final": [module.a.item(), module.b.item()],
            "enabled": lsgd.enabled, "wrapped": type(model.forward_module).__name__}


def _job_local_sgd(ctx):
    return _train(ParallelismConfig(dp_replicate_size=2))


def _job_refused(ctx):
    try:
        _train(ParallelismConfig(dp_shard_size=2), FullyShardedDataParallelPlugin(
            min_weight_size_to_shard=0))
    except NotImplementedError as exc:
        return str(exc)
    return None


JOBS = {"local_sgd": _job_local_sgd, "refused": _job_refused}


def _worker(rank, world, init_file, ctx_path, jobs):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world)
    results = {}
    for job in jobs:
        results[job] = JOBS[job](None)
        _reset_port()
    gathered = [None] * world
    dist.all_gather_object(gathered, results)
    if rank == 0:
        with open(ctx_path + ".out", "wb") as f:
            pickle.dump(gathered, f)
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("local_sgd_gang")
    ctx_path = str(tmp / "ctx")
    mp.start_processes(_worker, args=(2, str(tmp / "rendezvous"), ctx_path,
                                      ["local_sgd", "refused"]),
                       nprocs=2, join=True, start_method="spawn")
    with open(ctx_path + ".out", "rb") as f:
        return pickle.load(f)


def _jax_reference():
    """Two JAX trainings (the JAX package's step, one state a target),
    their parameters averaged in fp32 every K steps and at the end, as the
    JAX LocalSGD averages them: (a, b) of each after every step, before and
    after the average."""
    import jax
    import jax.numpy as jnp
    import optax

    from accelerate_tpu import Accelerator as JaxAccelerator
    from accelerate_tpu import Model as JaxModel
    from accelerate_tpu.state import AcceleratorState as JS
    from accelerate_tpu.state import GradientState as JG
    from accelerate_tpu.state import PartialState as JP
    from accelerate_tpu.test_utils.training import make_regression_model

    for cls in (JS, JG, JP):
        cls._reset_state()
    module, loss_fn = make_regression_model()
    acc = JaxAccelerator()
    model = JaxModel.from_flax(module, jax.random.key(0), np.zeros((4,), np.float32))
    acc.prepare(model, optax.sgd(LR))
    step = acc.prepare_train_step(loss_fn)
    # The step donates its state: the second training starts from a copy.
    states = [acc.train_state, jax.tree.map(jnp.copy, acc.train_state)]
    batches = [{k: jnp.asarray(v) for k, v in _batch(s).items()} for s in (1.0, 3.0)]

    def ab(st):
        return [float(st.params["a"]), float(st.params["b"])]

    def average():
        mean = jax.tree.map(lambda p, q: (np.asarray(p, np.float32) + np.asarray(q, np.float32))
                            / 2, states[0].params, states[1].params)
        for i, st in enumerate(states):
            states[i] = st.replace(params=jax.tree.map(
                lambda m, p: jnp.asarray(m, p.dtype), mean, st.params))

    before, after = [], []
    for i in range(STEPS):
        states = [step(st, b)[0] for st, b in zip(states, batches)]
        before.append([ab(st) for st in states])
        if (i + 1) % K == 0:
            average()
        after.append([ab(st) for st in states])
    average()
    final = [ab(st) for st in states]
    for cls in (JS, JG, JP):
        cls._reset_state()
    return before, after, final


def test_local_sgd_averages_at_the_boundaries_as_jax(runs):
    """Both processes' (a, b) after every step, before and after each
    boundary, and at the end, within 1e-6 of the JAX reference; different
    across the processes before each boundary, bit-equal after it; the
    averaged slope near the mean target 2 (the JAX script's check)."""
    before, after, final = _jax_reference()
    got = [r["local_sgd"] for r in runs]
    assert all(g["enabled"] and g["wrapped"] == "DistributedDataParallel" for g in got)
    for rank, g in enumerate(got):
        np.testing.assert_allclose(g["before"], [b[rank] for b in before], rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(g["after"], [a[rank] for a in after], rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(g["final"], final[rank], rtol=1e-6, atol=1e-6)
    for i in range(STEPS):
        assert got[0]["before"][i] != got[1]["before"][i]
        assert (got[0]["after"][i] == got[1]["after"][i]) == ((i + 1) % K == 0)
    assert got[0]["final"] == got[1]["final"]
    assert abs(got[0]["final"][0] - 2.0) < 0.4


def test_local_sgd_refuses_a_sharded_model(runs):
    assert all("FSDP2, tp or pp" in r["refused"] for r in runs)


def test_local_sgd_single_process_noop():
    """One process: disabled, as in the reference and the JAX package; the
    step trains as it does without LocalSGD."""
    out = _train(steps=6, k=2)
    assert not out["enabled"]
    assert out["before"] == out["after"]
    assert out["final"][0] != 0.0
    _reset_port()
    acc = Accelerator(cpu=True)
    module = Regression()
    acc.prepare(Model(module), torch.optim.SGD(module.parameters(), lr=LR))
    step = acc.prepare_train_step(_loss)
    batch = {k: torch.from_numpy(v) for k, v in _batch(1.0).items()}
    for _ in range(6):
        step(acc.train_state, batch)
    assert [module.a.item(), module.b.item()] == out["final"]
