"""The gradient-compression comm hooks of the port against the JAX
package's (``tests/test_comm_hooks.py``).

On a gloo gang of 2 CPU processes spawned once for the module, at
``dp_replicate=2``, against the JAX package's hooked step
(``Accelerator._comm_hook_step``) at ``dp_replicate=8`` on the 8 virtual
CPU devices. The JAX batch holds each port process's rows four times, one
copy a device for each of its four devices: every device's own mean, its
microbatches and its PowerSGD matrices are then those of the port process
whose rows it holds, and the mean over 8 devices is the mean over the 2
processes. The first batch's ``-100`` labels fall on one process only.

- ``"no"``: the plain step (DDP's reducer), the global batch's token mean
  (``tests/test_torch_distributed.py`` holds it to the JAX step); the
  hooked steps take the mean of each process's own mean (the JAX
  semantics), and the two differ on that batch;
- ``"fp16"`` and ``"bf16"``: losses and grad norms within the wire dtype's
  relative precision of the JAX hooked step's, 2^-11 for fp16 and 2^-8 for
  bf16: the JAX wire sums 8 copies (4 a process), rounding each partial sum
  to the wire dtype, where the port's sums 2;
- ``"powersgd"`` (rank 8) with the JAX start vectors ``q`` carried across,
  at ``scan_layers`` True (the stacked block leaves of 2 layers are
  averaged plainly: ``n = 2 <= rank``) and False (each layer's leaf
  compressed): within 1e-5 relative in fp32, and the weights after 3
  steps; with gradient accumulation 2;
- an overflowed fp16 step (one process's batch poisoned) keeps the hook's
  state and the parameters, and training goes on;
- every refusal of ``_comm_hook_step`` and the unknown hook.

In this process: the reducer on one process against the JAX reducer (the
approximation of rank 4 and its error feedback).

The spawned processes import this module: JAX is imported only inside the
functions that compute the references.
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
    DistributedDataParallelKwargs,
    FullyShardedDataParallelPlugin,
    Model,
    ParallelismConfig,
    adamw,
)
from accelerate_tpu_torch import models as M
from accelerate_tpu_torch.models import convert, cross_entropy_loss
from accelerate_tpu_torch.parallel.comm_hooks import make_comm_hook_reducer
from accelerate_tpu_torch.state import AcceleratorState, GradientState, PartialState

STEPS, LR, SEQ, RANK = 3, 3e-3, 16, 8
# Each process's rows (2 a process, 4 in all); the JAX batch repeats each
# process's pair on its four devices.
ROWS = 2


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


def _config(scan_layers=True):
    return M.LlamaConfig.tiny(dtype=torch.float32, scan_layers=scan_layers)


def _weights() -> dict:
    module = M.LlamaForCausalLM(_config())
    module.init_weights(torch.Generator().manual_seed(0))
    return {k: v.clone() for k, v in module.state_dict().items()}


def _batches(steps=STEPS, rows=2 * ROWS) -> list:
    """The port's global batches (process p: rows [p·R, (p+1)·R)); in the
    first, 12 of process 0's first row's labels are -100."""
    rng = np.random.default_rng(0)
    out = []
    for i in range(steps):
        ids = rng.integers(0, 256, size=(rows, SEQ + 1))
        y = ids[:, 1:].copy()
        if i == 0:
            y[0, :12] = -100
        out.append({"x": ids[:, :-1], "y": y})
    return out


def _jax_batch(b, copies=4):
    """Each process's rows repeated on ``copies`` devices."""
    per = b["x"].shape[0] // 2
    return {k: np.concatenate([np.tile(v[p * per:(p + 1) * per], (copies, 1))
                               for p in range(2)]) for k, v in b.items()}


def _loss(m, b):
    return cross_entropy_loss(m(b["x"]), b["y"])


# ---------------------------------------------------------------------------
# The jobs each spawned process runs
# ---------------------------------------------------------------------------


def _hooked(ctx, hook, scan_layers=True, accum=1, q=None, mixed_precision="no"):
    """Process ``rank``'s Accelerator at dp_replicate=2 with ``hook``."""
    module = M.LlamaForCausalLM(_config(scan_layers))
    module.load_state_dict(ctx["weights"])
    acc = Accelerator(cpu=True, parallelism_config=ParallelismConfig(dp_replicate_size=2),
                      gradient_accumulation_steps=accum, mixed_precision=mixed_precision,
                      kwargs_handlers=[DistributedDataParallelKwargs(comm_hook=hook,
                                                                     powersgd_rank=RANK)])
    model, _ = acc.prepare(Model(module), adamw(LR))
    return acc, model, module


def _local(acc, b):
    """This process's half of the global batch's rows."""
    p, per = acc.process_index, b["x"].shape[0] // 2
    return {k: torch.from_numpy(v[p * per:(p + 1) * per]) for k, v in b.items()}


def _run(ctx, hook, scan_layers=True, accum=1, q=None):
    acc, model, module = _hooked(ctx, hook, scan_layers, accum)
    step = acc.prepare_train_step(_loss, max_grad_norm=1.0)
    if q is not None:
        state = acc._comm_hook_states[0]
        assert sorted(n for n, st in state.items() if st) == sorted(q)
        for name, value in q.items():
            state[name]["q"] = torch.from_numpy(value)
    metrics = []
    for b in ctx["batches" if accum == 1 else "accum_batches"]:
        _, m = step(acc.train_state, _local(acc, b))
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    return {"metrics": metrics,
            "params": {n: p.detach().numpy().copy() for n, p in module.named_parameters()},
            "compressed": sorted(n for n, st in (acc._comm_hook_states or [{}])[0].items()
                                 if st),
            "forward_module": type(model.forward_module).__name__}


def _job_no(ctx):
    return _run(ctx, "no")


def _job_fp16(ctx):
    return _run(ctx, "fp16")


def _job_bf16(ctx):
    return _run(ctx, "bf16")


def _job_powersgd(ctx):
    return _run(ctx, "powersgd", q=ctx["q"][True])


def _job_powersgd_unscanned(ctx):
    return _run(ctx, "powersgd", scan_layers=False, q=ctx["q"][False])


def _job_powersgd_accum2(ctx):
    return _run(ctx, "powersgd", accum=2, q=ctx["q"][True])


def _job_overflow(ctx):
    """fp16 with PowerSGD: a step whose loss is inf on process 0 only, then
    3 steps: the hook's state and the parameters across the overflowed step,
    and the metrics after it."""
    acc, model, module = _hooked(ctx, "powersgd", mixed_precision="fp16")

    def loss(m, b):
        return _loss(m, b) * torch.where(b["poison"].sum() > 0, torch.inf, 1.0)

    step = acc.prepare_train_step(loss)

    def batch(b, poison):
        local = _local(acc, b)
        local["poison"] = torch.full((ROWS,), int(poison and acc.process_index == 0))
        return local

    step(acc.train_state, batch(ctx["batches"][1], False))  # a state worth keeping
    before = {n: {k: t.clone() for k, t in st.items()}
              for n, st in acc._comm_hook_states[0].items()}
    params = [p.detach().clone() for p in module.parameters()]
    count = int(acc.train_state.step)
    _, m = step(acc.train_state, batch(ctx["batches"][0], True))
    skipped = int(acc.train_state.step) == count
    after = acc._comm_hook_states[0]
    kept = all(torch.equal(before[n][k], after[n][k]) for n in before for k in before[n])
    unchanged = all(torch.equal(a, p) for a, p in zip(params, module.parameters()))
    losses = [float(step(acc.train_state, batch(b, False))[1]["loss"])
              for b in ctx["batches"]]
    return {"kept": kept, "unchanged": unchanged, "skipped": skipped,
            "overflow_loss": float(m["loss"]), "losses": losses}


def _job_refusals(ctx):
    """prepare_train_step's refusals over the group: a sharded model and a
    mesh axis other than the data-parallel ones."""
    out = {}
    for label, kw in (("sharded", dict(fsdp_plugin=FullyShardedDataParallelPlugin(
                          min_weight_size_to_shard=0))),
                      ("mesh", dict(parallelism_config=ParallelismConfig(tp_size=2)))):
        module = M.LlamaForCausalLM(_config())
        acc = Accelerator(cpu=True, kwargs_handlers=[DistributedDataParallelKwargs(
            comm_hook="powersgd")], **kw)
        acc.prepare(Model(module), adamw(LR))
        try:
            acc.prepare_train_step(_loss)
        except ValueError as exc:
            out[label] = str(exc)
        _reset_port()
    return out


JOBS = {name[5:]: fn for name, fn in globals().items() if name.startswith("_job_")}


def _worker(rank, world, init_file, ctx_path, jobs):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world)
    with open(ctx_path, "rb") as f:
        ctx = pickle.load(f)
    results = {}
    for job in jobs:
        results[job] = JOBS[job](ctx)
        _reset_port()
    gathered = [None] * world
    dist.all_gather_object(gathered, results)
    if rank == 0:
        with open(ctx_path + ".out", "wb") as f:
            pickle.dump(gathered, f)
    dist.destroy_process_group()


def _spawn(tmp, world, jobs, ctx) -> list:
    ctx_path = str(tmp / f"ctx{world}.pkl")
    with open(ctx_path, "wb") as f:
        pickle.dump(ctx, f)
    mp.start_processes(_worker, args=(world, str(tmp / f"rendezvous{world}"), ctx_path, jobs),
                       nprocs=world, join=True, start_method="spawn")
    with open(ctx_path + ".out", "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("hook_gangs")
    weights = _weights()
    ctx = {"weights": weights, "batches": _batches(),
           "accum_batches": _batches(rows=4 * ROWS),
           "q": {scan: _jax_q(weights, scan) for scan in (True, False)}}
    return {2: _spawn(tmp, 2, sorted(JOBS), ctx), "ctx": ctx}


# ---------------------------------------------------------------------------
# The JAX references
# ---------------------------------------------------------------------------


def _jax_reset():
    from accelerate_tpu.state import AcceleratorState as JS
    from accelerate_tpu.state import GradientState as JG
    from accelerate_tpu.state import PartialState as JP

    for cls in (JS, JG, JP):
        cls._reset_state()


def _flax(sd, scan_layers=True):
    import jax

    module = M.LlamaForCausalLM(_config(scan_layers), device="meta")
    tree = convert.flax_converter(module).to_flax(module.config, sd)
    return jax.tree.map(lambda t: np.asarray(t.numpy()), tree)


def _flat(tree, prefix="") -> dict:
    out = {}
    for k, v in tree.items():
        name = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, name) if isinstance(v, dict) and "q" not in v else {name: v})
    return out


def _jax_q(weights, scan_layers) -> dict:
    """The JAX hook's start vectors for these parameters (its
    ``init_powersgd_state`` with the hooked step's seed), by flax leaf."""
    from accelerate_tpu.parallel.comm_hooks import init_powersgd_state

    state = init_powersgd_state(_flax(weights, scan_layers), RANK)
    return {n: np.asarray(st["q"]) for n, st in _flat(state).items() if st}


def _jax_module(scan_layers=True):
    import jax.numpy as jnp

    from accelerate_tpu.models import LlamaConfig as JaxLlamaConfig
    from accelerate_tpu.models import LlamaForCausalLM as JaxLlama

    return JaxLlama(JaxLlamaConfig.tiny(dtype=jnp.float32, scan_layers=scan_layers))


_JAX: dict = {}


def _jax_train(ctx, hook, scan_layers=True, accum=1):
    """STEPS steps of the JAX Accelerator at dp_replicate=8 with ``hook``
    (the plain step for "no") on the batches' JAX layout: metrics and the
    final parameters (memoised)."""
    key = (hook, scan_layers, accum)
    if key in _JAX:
        return _JAX[key]
    import jax
    import jax.numpy as jnp
    import optax

    from accelerate_tpu import Accelerator as JaxAccelerator
    from accelerate_tpu import Model as JaxModel
    from accelerate_tpu import ParallelismConfig as JaxPC
    from accelerate_tpu.models import cross_entropy_loss as jax_ce
    from accelerate_tpu.utils.dataclasses import DistributedDataParallelKwargs as JaxDDPK

    _jax_reset()
    module = _jax_module(scan_layers)
    acc = JaxAccelerator(parallelism_config=JaxPC(dp_replicate_size=8),
                         gradient_accumulation_steps=accum,
                         kwargs_handlers=[JaxDDPK(comm_hook=hook, powersgd_rank=RANK)])
    acc.prepare(JaxModel(module=module, params=_flax(ctx["weights"], scan_layers)),
                optax.adamw(LR))
    step = acc.prepare_train_step(
        lambda p, b: jax_ce(module.apply({"params": p}, b["x"]), b["y"]), max_grad_norm=1.0)
    metrics = []
    for b in ctx["batches" if accum == 1 else "accum_batches"]:
        jb = _jax_batch(b)
        _, m = step(acc.train_state, {k: jnp.asarray(v, jnp.int32) for k, v in jb.items()})
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    final = jax.tree.map(np.asarray, acc.train_state.params)
    _jax_reset()
    _JAX[key] = (metrics, final)
    return _JAX[key]


def _assert_metrics(got, want, rtol):
    for (gl, gn), (wl, wn) in zip(got, want):
        assert abs(gl - wl) <= rtol * abs(wl), (got, want)
        assert abs(gn - wn) <= rtol * abs(wn), (got, want)


def _assert_weights(got: dict, want_tree, init: dict, scan_layers=True):
    """The port's parameters after PowerSGD steps against the JAX ones:
    each update within 1e-2 of the JAX one's in norm, each entry within
    2·STEPS·lr. (PowerSGD's approximation gives every entry of a
    compressed gradient a value, near zero where the true gradient is zero,
    as on an embedding row no token used, and AdamW's m/√v moves such an
    entry by up to a step either way on the sign of its rounding: the
    entry-by-entry count of ``tests/test_torch_tensor_parallel.py`` does
    not hold there.)"""
    import jax

    want = convert.llama_views_from_flax(
        _config(scan_layers), jax.tree.map(lambda a: torch.from_numpy(np.array(a)), want_tree))
    for name, g in got.items():
        w, i = want[name].numpy(), init[name].numpy()
        diff = np.abs(g - w)
        assert diff.max() <= 2 * STEPS * LR, name
        assert np.linalg.norm(diff) <= 1e-2 * np.linalg.norm(w - i), name


# ---------------------------------------------------------------------------
# The tests
# ---------------------------------------------------------------------------


HOOK_CASES = [("fp16", "fp16", True, 1, 2.0 ** -11),
              ("bf16", "bf16", True, 1, 2.0 ** -8), ("powersgd", "powersgd", True, 1, 1e-5),
              ("powersgd_unscanned", "powersgd", False, 1, 1e-5),
              ("powersgd_accum2", "powersgd", True, 2, 1e-5)]


@pytest.mark.parametrize("job,hook,scan_layers,accum,rtol", HOOK_CASES,
                         ids=[c[0] for c in HOOK_CASES])
def test_hooked_steps_match_jax(runs, job, hook, scan_layers, accum, rtol):
    """3 steps' losses and grad norms within ``rtol`` of the JAX step's with
    the same hook, equal on both processes, and the weights after them
    (PowerSGD). The model is kept without DDP's reducer under a hook."""
    want_metrics, want_params = _jax_train(runs["ctx"], hook, scan_layers, accum)
    results = [r[job] for r in runs[2]]
    for r in results:
        _assert_metrics(r["metrics"], want_metrics, rtol)
        assert r["metrics"] == results[0]["metrics"]
        assert r["params"].keys() == results[0]["params"].keys()
    assert results[0]["forward_module"] == "LlamaForCausalLM"
    if hook == "powersgd":
        _assert_weights(results[0]["params"], want_params, runs["ctx"]["weights"], scan_layers)


def test_powersgd_compresses_the_flax_leaves(runs):
    """Which leaves PowerSGD compresses follows the flax layout: with
    ``scan_layers`` the 2-layer stacks are plain means (n = 2 <= rank 8)
    and only the embedding and head are compressed; without it each layer's
    projections are, but o_proj (4 heads ≤ 8 rows)."""
    scanned = runs[2][0]["powersgd"]["compressed"]
    assert scanned == ["lm_head/kernel", "model/embed_tokens/embedding"]
    unscanned = runs[2][0]["powersgd_unscanned"]["compressed"]
    assert "model/layers_0/self_attn/q_proj/kernel" in unscanned
    assert "model/layers_1/mlp/down_proj/kernel" in unscanned
    assert not any("o_proj" in n or "norm" in n for n in unscanned)
    assert sorted(runs["ctx"]["q"][False]) == unscanned


def test_hooked_loss_is_the_mean_of_the_processes_means(runs):
    """With process 0's labels partly -100, the plain step's first loss is
    the global batch's token mean (DDP's reducer, equal on both processes),
    and the hooked steps' the mean of each process's own mean, as the JAX
    hooked step's pmean; the two differ."""
    module = M.LlamaForCausalLM(_config())
    module.load_state_dict(runs["ctx"]["weights"])
    b = runs["ctx"]["batches"][0]
    with torch.no_grad():
        logits = module(torch.from_numpy(b["x"]))
    y = torch.from_numpy(b["y"])
    sums = torch.stack([torch.nn.functional.cross_entropy(
        logits[i:i + ROWS].reshape(-1, 256), y[i:i + ROWS].reshape(-1), ignore_index=-100,
        reduction="sum") for i in (0, ROWS)])
    counts = torch.stack([(y[i:i + ROWS] != -100).sum() for i in (0, ROWS)])
    plain = [r["no"] for r in runs[2]]
    assert plain[0]["metrics"] == plain[1]["metrics"]
    assert plain[0]["forward_module"] == "DistributedDataParallel"
    assert abs(plain[0]["metrics"][0][0] - float(sums.sum() / counts.sum())) <= 1e-6
    hooked = runs[2][0]["powersgd"]["metrics"][0][0]
    assert abs(hooked - float((sums / counts).mean())) <= 1e-6
    assert abs(plain[0]["metrics"][0][0] - hooked) > 1e-3
    assert abs(hooked - _jax_train(runs["ctx"], "powersgd")[0][0][0]) <= 1e-5 * hooked


def test_overflow_keeps_the_hook_state(runs):
    """fp16 with PowerSGD, one process's loss inf: the finite flag (MIN over
    the processes) skips the step on both, the hook's Q and error feedback
    and the parameters stay as they were, and the next steps train."""
    for r in runs[2]:
        o = r["overflow"]
        assert o["kept"] and o["unchanged"] and o["skipped"]
        assert np.isfinite(o["losses"]).all() and o["losses"][-1] < o["losses"][0] + 0.1


def test_comm_hook_refusals(runs):
    """Over the group: FSDP2-sharded parameters and a tp axis are refused,
    as the JAX step refuses them; in one process: mutable_state and
    has_aux, ZeRO-2's gradient sharding, an unknown hook."""
    ref = runs[2][0]["refusals"]
    assert "replicated (DDP) parameters" in ref["sharded"]
    assert "pure data-parallel mesh" in ref["mesh"] and "'tp'" in ref["mesh"]
    for kw in (dict(has_aux=True), dict(mutable_state=True)):
        acc = Accelerator(cpu=True, kwargs_handlers=[DistributedDataParallelKwargs(
            comm_hook="fp16")])
        acc.prepare(Model(M.LlamaForCausalLM(_config())), adamw(LR))
        with pytest.raises(NotImplementedError, match="mutable_state/has_aux"):
            acc.prepare_train_step(_loss, **kw)
        _reset_port()
    acc = Accelerator(cpu=True, fsdp_plugin=FullyShardedDataParallelPlugin(
        sharding_strategy="SHARD_GRAD_OP"), kwargs_handlers=[DistributedDataParallelKwargs(
            comm_hook="bf16")])
    acc.prepare(Model(M.LlamaForCausalLM(_config())), adamw(LR))
    with pytest.raises(ValueError, match="ZeRO-2"):
        acc.prepare_train_step(_loss)
    _reset_port()
    acc = Accelerator(cpu=True, kwargs_handlers=[DistributedDataParallelKwargs(
        comm_hook="gzip")])
    acc.prepare(Model(M.LlamaForCausalLM(_config())), adamw(LR))
    with pytest.raises(ValueError, match="comm_hook must be one of"):
        acc.prepare_train_step(_loss)
    with pytest.raises(ValueError, match="comm_hook"):
        make_comm_hook_reducer("gzip")


def test_powersgd_reducer_matches_jax_on_one_process():
    """One process: the port's reducer of a (64, 48) gradient at rank 4,
    with the JAX start vectors, gives the JAX reducer's rank-4
    approximation and error feedback within 1e-5."""
    import jax.numpy as jnp

    from accelerate_tpu.parallel.comm_hooks import init_powersgd_state as jax_init
    from accelerate_tpu.parallel.comm_hooks import make_comm_hook_reducer as jax_reducer

    g = np.random.default_rng(0).normal(size=(64, 48)).astype(np.float32)
    jst = jax_init({"w": jnp.asarray(g)}, rank=4)
    jred, jnew = jax_reducer("powersgd", (), rank=4)({"w": jnp.asarray(g)}, jst)
    state = {"w": {"q": torch.from_numpy(np.array(jst["w"]["q"])),
                   "e": torch.zeros(64, 48)}}
    red, new = make_comm_hook_reducer("powersgd", rank=4)({"w": torch.from_numpy(g)}, state)
    np.testing.assert_allclose(red["w"].numpy(), np.asarray(jred["w"]), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(new["w"]["e"].numpy(), np.asarray(jnew["w"]["e"][0]),
                               rtol=1e-5, atol=1e-5)
    s = np.linalg.svd(red["w"].numpy(), compute_uv=False)
    assert (s[4:] < 1e-4).all()
