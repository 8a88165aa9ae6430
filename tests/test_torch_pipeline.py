"""Pipeline parallelism of the port against the JAX package's.

On gloo gangs of 2 and 4 CPU processes (``torch.multiprocessing`` spawn, a
``file://`` rendezvous under the test's temporary directory), spawned once
for the module, against the JAX package on the 8 virtual CPU devices of
``tests/conftest.py``:

- ``pipeline_apply`` on a stack of affine layers at ``pp=2`` and ``pp=4``
  (GPipe) and interleaved at ``pp=2``, ``V=2``: the last stage's output
  within 1e-6 of the JAX ``pipeline_apply``'s, the stages' gradients summed
  within 1e-5 of the serial stack's (``tests/test_pp.py``); its validation
  errors; the ``pp=1`` pass-through;
- ``llama_pipeline_forward`` of the tiny Llama at ``pp=2`` against the JAX
  function's (``tests/test_pp.py::test_llama_pipeline_forward_matches_apply``);
- 3 steps of ``prepare_train_step`` in fp32 at ``pp=2``, ``pp=2``
  interleaved, ``pp=2 × dp_shard=2`` (FSDP2 on each stage's blocks),
  ``pp=2 × dp_replicate=2`` and ``pp=2 × tp=2`` against the JAX step at
  ``pp=2`` on its own mesh (``dp_shard`` filling the 8 devices): losses and
  grad norms within 1e-5 relative, the weights after them; ``pp=2`` in bf16
  within the bf16 gate of the same fp32 reference. The labels' ``-100``
  fall unevenly over the microbatches, so a schedule that averaged
  microbatch means would fail;
- Gemma's tied embedding and head at ``pp=2`` (the shared weight's
  gradient summed over the first and last stages, counted once in the
  norm) against the JAX step (at ``pp=1``: the same function);
- a checkpoint saved at ``pp=2`` resumed bit for bit at ``pp=1`` by the
  port and by the JAX package, and one saved at ``pp=1`` resumed bit for
  bit at ``pp=2``; ``DISTRIBUTED_STATE_DICT`` under ``pp`` refused.

The spawned processes import this module: JAX is imported only inside the
functions that compute the references.
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from accelerate_tpu_torch import (
    Accelerator,
    FullyShardedDataParallelPlugin,
    Model,
    ParallelismConfig,
    adamw,
    llama_pipeline_forward,
    pipeline_apply,
)
from accelerate_tpu_torch import models as M
from accelerate_tpu_torch.models import convert, cross_entropy_loss
from accelerate_tpu_torch.state import AcceleratorState, GradientState, PartialState

STEPS, LR, SEQ, BATCH, LAYERS = 3, 1e-3, 16, 8, 4
# The affine stack (tests/test_pp.py's shapes).
AFFINE = dict(L=8, B=8, D=16)


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


def _config(tied=False, dtype=torch.float32):
    return M.LlamaConfig.tiny(dtype=dtype, num_hidden_layers=LAYERS, tie_word_embeddings=tied)


def _weights(tied=False) -> dict:
    module = M.LlamaForCausalLM(_config(tied))
    module.init_weights(torch.Generator().manual_seed(0))
    return {k: v.clone() for k, v in module.state_dict().items()}


def _batches() -> list:
    """3 batches of 8 rows; in the first, 14 labels of each of rows 0-2 and
    3 of row 5's are -100, so the microbatches' valid counts differ."""
    rng = np.random.default_rng(0)
    out = []
    for i in range(STEPS):
        ids = rng.integers(0, 256, size=(BATCH, SEQ + 1))
        y = ids[:, 1:].copy()
        if i == 0:
            y[:3, :14] = -100
            y[5, 4:7] = -100
        out.append({"x": ids[:, :-1], "y": y})
    return out


def _affine():
    rng = np.random.default_rng(0)
    L, B, D = AFFINE["L"], AFFINE["B"], AFFINE["D"]
    return (rng.normal(size=(L, D, D), scale=0.3).astype(np.float32),
            rng.normal(size=(L, D), scale=0.1).astype(np.float32),
            rng.normal(size=(B, D)).astype(np.float32))


def _affine_stage(local, h):
    w, b = local
    for i in range(w.shape[0]):
        h = torch.tanh(h @ w[i] + b[i])
    return h


def _whole(t) -> np.ndarray:
    t = t.full_tensor() if hasattr(t, "full_tensor") else t
    return t.detach().float().numpy().copy()


# ---------------------------------------------------------------------------
# The jobs each spawned process runs
# ---------------------------------------------------------------------------


def _job_affine(ctx):
    """pipeline_apply's output (last stage) and each stage's gradients
    (GPipe m=4; interleaved V=2, m=pp where pp=2), and its errors."""
    world = dist.get_world_size()
    mesh = ParallelismConfig(pp_size=world).build_mesh("cpu")
    w0, b0, x0 = _affine()
    out = {}
    for name, v, m in (("gpipe", 1, 4), ("interleaved", 2, world)):
        if v > 1 and world > 2:
            continue
        w, b = (torch.from_numpy(a).requires_grad_() for a in (w0, b0))
        x = torch.from_numpy(x0).requires_grad_()
        y = pipeline_apply(_affine_stage, (w, b), x, mesh=mesh, n_microbatches=m,
                           virtual_stages=v)
        (y ** 2).sum().backward()
        out[name] = {"y": y.detach().numpy().copy() if dist.get_rank() == world - 1 else None,
                     "grads": [w.grad.numpy().copy(), b.grad.numpy().copy()],
                     "gx": None if x.grad is None else x.grad.numpy().copy()}
    errors = {}
    for label, kw, shape in (("m_ne_pp", dict(n_microbatches=2 * world, virtual_stages=2), None),
                             ("layers", dict(n_microbatches=world, virtual_stages=2),
                              (2 * world + 2, 4, 4)),
                             ("gpipe_layers", dict(n_microbatches=world), (world + 1, 4, 4)),
                             ("batch", dict(n_microbatches=3), None)):
        w = torch.zeros(shape or (4 * world, 4, 4))
        try:
            pipeline_apply(lambda p, h: h, w, torch.zeros(4 * world, 4), mesh=mesh, **kw)
        except ValueError as exc:
            errors[label] = str(exc)
    out["errors"] = errors
    return out


def _job_llama_forward(ctx):
    module = M.LlamaForCausalLM(_config())
    module.load_state_dict(ctx["weights"])
    Accelerator(cpu=True, parallelism_config=ParallelismConfig(pp_size=2))
    with torch.no_grad():
        logits = llama_pipeline_forward(Model(module), torch.from_numpy(ctx["ids"]),
                                        n_microbatches=4)
    return None if dist.get_rank() != 1 else logits.numpy().copy()


def _train(ctx, pc, mixed_precision="no", plugin=None, tied=False, rules=False, steps=STEPS,
           save=None, load=None):
    """``steps`` steps of the tiny Llama at ``pc`` on this process's rows:
    metrics and this stage's whole parameters after them."""
    module = M.LlamaForCausalLM(_config(tied))
    module.load_state_dict(ctx["tied_weights" if tied else "weights"])
    acc = Accelerator(cpu=True, parallelism_config=pc, mixed_precision=mixed_precision,
                      fsdp_plugin=plugin)
    model, _ = acc.prepare(Model(module, tp_rules=M.llama_tp_rules() if rules else None),
                           adamw(LR))
    if load is not None:
        acc.load_state(load)
        return {"params": {n: _whole(p) for n, p in module.named_parameters()},
                "moments": {n: {k: _whole(acc.train_state.optimizer.state[p][k])
                                for k in ("exp_avg", "exp_avg_sq")}
                            for n, p in module.named_parameters()}}
    step = acc.prepare_train_step(
        lambda m, b: cross_entropy_loss(llama_pipeline_forward(m, b["x"]), b["y"]),
        max_grad_norm=1.0)
    from accelerate_tpu_torch.parallel.sharding import local_batch

    metrics = []
    for b in ctx["batches"][:steps]:
        _, m = step(acc.train_state, {k: torch.from_numpy(v) for k, v in
                                      local_batch(b, acc.parallelism_config,
                                                  acc.process_index).items()})
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    out = {"metrics": metrics, "params": {n: _whole(p) for n, p in module.named_parameters()},
           "pp_rank": acc.pipeline_parallel_rank, "sharded": model.sharded,
           "shared": list(model.pipeline_shared)}
    if save is not None:
        acc.save_state(save)
        out["moments"] = {n: {k: _whole(acc.train_state.optimizer.state[p][k])
                              for k in ("exp_avg", "exp_avg_sq")}
                          for n, p in module.named_parameters()}
        # DISTRIBUTED_STATE_DICT under pp: each stage writes its own shards.
        acc.fsdp_plugin = FullyShardedDataParallelPlugin(state_dict_type="DISTRIBUTED_STATE_DICT")
        acc.save_state(save + "_dcp")
        out["dcp_files"] = sorted(os.listdir(os.path.join(save + "_dcp",
                                                          "distributed_state_torch")))
    return out


def _job_pp2(ctx):
    return _train(ctx, ParallelismConfig(pp_size=2))


def _job_pp2_interleaved(ctx):
    return _train(ctx, ParallelismConfig(pp_size=2, pp_virtual_stages=2))


def _job_pp2_bf16(ctx):
    return _train(ctx, ParallelismConfig(pp_size=2), mixed_precision="bf16")


def _job_gemma(ctx):
    return _train(ctx, ParallelismConfig(pp_size=2), tied=True)


def _job_save(ctx):
    return _train(ctx, ParallelismConfig(pp_size=2), steps=2, save=ctx["ckpt_pp2"])


def _job_load(ctx):
    return _train(ctx, ParallelismConfig(pp_size=2), load=ctx["ckpt_pp1"])


def _job_pp2_fsdp(ctx):
    return _train(ctx, ParallelismConfig(pp_size=2, dp_shard_size=2),
                  plugin=FullyShardedDataParallelPlugin(min_weight_size_to_shard=0))


def _job_pp2_ddp(ctx):
    return _train(ctx, ParallelismConfig(pp_size=2, dp_replicate_size=2))


def _job_pp2_tp(ctx):
    return _train(ctx, ParallelismConfig(pp_size=2, tp_size=2), rules=True)


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
    tmp = tmp_path_factory.mktemp("pp_gangs")
    ctx = {"weights": _weights(), "tied_weights": _weights(tied=True), "batches": _batches(),
           "ids": np.random.default_rng(2).integers(0, 256, size=(8, SEQ)),
           "ckpt_pp2": str(tmp / "ckpt_pp2"), "ckpt_pp1": str(tmp / "ckpt_pp1")}
    # The checkpoint the 2-process gang resumes at pp=2: 2 steps at pp=1.
    ctx["pp1"] = _train(ctx, None, steps=2, save=ctx["ckpt_pp1"])
    _reset_port()
    return {2: _spawn(tmp, 2, ["affine", "llama_forward", "pp2", "pp2_interleaved",
                               "pp2_bf16", "gemma", "save", "load"], ctx),
            4: _spawn(tmp, 4, ["affine", "pp2_fsdp", "pp2_ddp", "pp2_tp"], ctx),
            "ctx": ctx}


# ---------------------------------------------------------------------------
# The JAX references
# ---------------------------------------------------------------------------


def _jax_reset():
    from accelerate_tpu.state import AcceleratorState as JS
    from accelerate_tpu.state import GradientState as JG
    from accelerate_tpu.state import PartialState as JP

    for cls in (JS, JG, JP):
        cls._reset_state()


def _flax(sd, tied=False):
    import jax

    module = M.LlamaForCausalLM(_config(tied), device="meta")
    tree = convert.flax_converter(module).to_flax(module.config, sd)
    return jax.tree.map(lambda t: np.asarray(t.numpy()), tree)


def _jax_module(tied=False, dtype="float32"):
    import jax.numpy as jnp

    from accelerate_tpu.models import LlamaConfig as JaxLlamaConfig
    from accelerate_tpu.models import LlamaForCausalLM as JaxLlama

    return JaxLlama(JaxLlamaConfig.tiny(dtype=getattr(jnp, dtype), num_hidden_layers=LAYERS,
                                        tie_word_embeddings=tied))


_JAX_TRAIN: dict = {}


def _jax_train(ctx, mixed_precision="no", tied=False, pp=2):
    """STEPS steps of the JAX Accelerator at ``pp`` (dp_shard filling the 8
    devices), its loss ``cross_entropy_loss`` of ``llama_pipeline_forward``
    on the whole global batches: metrics and the parameters after them
    (memoised). At pp=1 the JAX pipelined forward is the plain stack (one
    stage), which ``tests/test_pp.py`` holds its pp=2 forward and
    gradients to."""
    key = (mixed_precision, tied, pp)
    if key in _JAX_TRAIN:
        return _JAX_TRAIN[key]
    import jax
    import jax.numpy as jnp
    import optax

    from accelerate_tpu import Accelerator as JaxAccelerator
    from accelerate_tpu import Model as JaxModel
    from accelerate_tpu import ParallelismConfig as JaxPC
    from accelerate_tpu.models import cross_entropy_loss as jax_ce
    from accelerate_tpu.parallel import llama_pipeline_forward as jax_pipe

    _jax_reset()
    module = _jax_module(tied)
    acc = JaxAccelerator(parallelism_config=JaxPC(pp_size=pp), mixed_precision=mixed_precision)
    params = _flax(ctx["tied_weights" if tied else "weights"], tied)
    acc.prepare(JaxModel(module=module, params=params), optax.adamw(LR))
    cfg = module.config
    step = acc.prepare_train_step(
        lambda p, b: jax_ce(jax_pipe(cfg, p, b["x"], mesh=acc.mesh), b["y"]),
        max_grad_norm=1.0)
    metrics = []
    for b in ctx["batches"]:
        _, m = step(acc.train_state, {k: jnp.asarray(v, jnp.int32) for k, v in b.items()})
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    final = jax.tree.map(np.asarray, acc.train_state.params)
    _jax_reset()
    _JAX_TRAIN[key] = (metrics, final)
    return _JAX_TRAIN[key]


def _assert_metrics(got, want, rtol):
    for (gl, gn), (wl, wn) in zip(got, want):
        assert abs(gl - wl) <= rtol * abs(wl), (got, want)
        assert abs(gn - wn) <= rtol * abs(wn), (got, want)


def _merged(results) -> dict:
    """Every stage's whole parameters by name (a tied weight equal on the
    two stages that hold it)."""
    out = {}
    for r in results:
        for n, a in r["params"].items():
            if n in out:
                np.testing.assert_array_equal(out[n], a, err_msg=n)
            out[n] = a
    return out


def _assert_weights(got: dict, want_tree, init: dict, tied=False, atol=1e-5):
    """The port's parameters against the JAX ones in the port's layout:
    every entry within STEPS·lr (AdamW's m/√v can turn the rounding of a
    near-zero gradient into a whole step), at most 1e-4 of a tensor's
    entries (and 2) beyond ``atol``, each tensor's update within 1e-2 of
    the JAX one's in norm."""
    import jax

    want = convert.llama_views_from_flax(
        _config(tied), jax.tree.map(lambda a: torch.from_numpy(np.array(a)), want_tree))
    assert set(got) == set(want)
    for name, g in got.items():
        w, i = want[name].numpy(), init[name].numpy()
        diff = np.abs(g - w)
        assert diff.max() <= STEPS * LR, name
        assert (diff > atol).sum() <= 1e-4 * diff.size + 2, (name, diff.max())
        assert np.linalg.norm(diff) <= 1e-2 * np.linalg.norm(w - i), name


# ---------------------------------------------------------------------------
# pipeline_apply
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("world,schedule", [(2, "gpipe"), (4, "gpipe"), (2, "interleaved")],
                         ids=["pp2", "pp4", "pp2-v2"])
def test_pipeline_apply_matches_jax_and_serial(runs, world, schedule):
    """The last stage's output equals the JAX pipeline_apply's within 1e-6;
    the stages' gradients (each holds its rows') summed equal the serial
    stack's within 1e-5, and stage 0's input gradient too."""
    import jax
    import jax.numpy as jnp

    from accelerate_tpu import ParallelismConfig as JaxPC
    from accelerate_tpu.parallel import pipeline_apply as jax_apply

    w, b, x = _affine()
    v, m = (2, world) if schedule == "interleaved" else (1, 4)

    def jax_stage(local, h):
        def body(carry, lp):
            return jnp.tanh(carry @ lp[0] + lp[1]), None

        return jax.lax.scan(body, h, local)[0]

    want = jax_apply(jax_stage, (jnp.asarray(w), jnp.asarray(b)), jnp.asarray(x),
                     mesh=JaxPC(pp_size=world).build_mesh(), n_microbatches=m,
                     virtual_stages=v)
    results = [r["affine"][schedule] for r in runs[world]]
    np.testing.assert_allclose(results[-1]["y"], np.asarray(want), rtol=1e-6, atol=1e-6)
    assert all(r["y"] is None for r in results[:-1])
    wt, bt, xt = (torch.from_numpy(a).requires_grad_() for a in (w, b, x))
    (_affine_stage((wt, bt), xt) ** 2).sum().backward()
    for i, ref in enumerate((wt.grad, bt.grad)):
        np.testing.assert_allclose(sum(r["grads"][i] for r in results), ref.numpy(),
                                   rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(results[0]["gx"], xt.grad.numpy(), rtol=1e-5, atol=1e-6)
    assert all(r["gx"] is None for r in results[1:])


def test_pipeline_apply_validation_and_pass_through(runs):
    """The JAX package's errors (n_microbatches == pp under interleaving,
    layers divisible by pp·V or pp, the batch by the microbatches), and
    without a pp axis wider than 1 the stage function on the whole stack."""
    for world in (2, 4):
        errors = runs[world][0]["affine"]["errors"]
        assert "n_microbatches == pp" in errors["m_ne_pp"]
        assert "not divisible by pp*virtual_stages" in errors["layers"]
        assert "not divisible by pp=" in errors["gpipe_layers"]
        assert "not divisible by n_microbatches 3" in errors["batch"]
    w, b, x = (torch.from_numpy(a) for a in _affine())
    mesh = type("Mesh", (), {"mesh_dim_names": ("dp_shard",)})()
    torch.testing.assert_close(pipeline_apply(_affine_stage, (w, b), x, mesh=mesh),
                               _affine_stage((w, b), x), rtol=0, atol=0)
    with pytest.raises(ValueError, match="needs a mesh"):
        pipeline_apply(_affine_stage, (w, b), x)


def test_llama_pipeline_forward_matches_jax(runs):
    """The tiny Llama's pipelined logits at pp=2 (4 microbatches) within
    2e-5 of the JAX llama_pipeline_forward's; only the last stage holds
    them."""
    import jax.numpy as jnp

    from accelerate_tpu import ParallelismConfig as JaxPC
    from accelerate_tpu.parallel import llama_pipeline_forward as jax_pipe

    ctx = runs["ctx"]
    module = _jax_module()
    want = jax_pipe(module.config, _flax(ctx["weights"]), jnp.asarray(ctx["ids"], jnp.int32),
                    mesh=JaxPC(pp_size=2).build_mesh(), n_microbatches=4)
    got = [r["llama_forward"] for r in runs[2]]
    assert got[0] is None
    np.testing.assert_allclose(got[1], np.asarray(want), rtol=2e-5, atol=2e-5)


# ---------------------------------------------------------------------------
# The train step
# ---------------------------------------------------------------------------


STEP_CASES = [(2, "pp2", 1e-5), (2, "pp2_interleaved", 1e-5), (4, "pp2_fsdp", 1e-5),
              (4, "pp2_ddp", 1e-5), (4, "pp2_tp", 1e-5), (2, "pp2_bf16", 2e-2)]


@pytest.mark.parametrize("world,job,rtol", STEP_CASES,
                         ids=["pp2-fp32", "pp2-interleaved-fp32", "pp2_dp_shard2-fp32",
                              "pp2_dp_replicate2-fp32", "pp2_tp2-fp32", "pp2-bf16"])
def test_pipelined_steps_match_jax(runs, world, job, rtol):
    """Losses and grad norms of 3 steps within ``rtol`` of the JAX step's at
    pp=2, equal on every process (the last stage's, broadcast); the stages'
    parameters together after them as the JAX ones (fp32); each stage holds
    its layers only."""
    bf16 = job.endswith("bf16")
    want_metrics, want_params = _jax_train(runs["ctx"])
    results = [r[job] for r in runs[world]]
    for r in results:
        _assert_metrics(r["metrics"], want_metrics, rtol)
        assert r["metrics"] == results[0]["metrics"]
    per_stage = world // 2
    assert [r["pp_rank"] for r in results] == [i // per_stage for i in range(world)]
    assert results[0]["sharded"] == (job == "pp2_fsdp")
    stage0 = [n for n in results[0]["params"] if n.startswith("model.layers.")]
    last = [n for n in results[-1]["params"] if n.startswith("model.layers.")]
    layers = {int(n.split(".")[2]) for n in stage0}, {int(n.split(".")[2]) for n in last}
    want_layers = ({0, 2}, {1, 3}) if job == "pp2_interleaved" else ({0, 1}, {2, 3})
    assert layers == want_layers
    assert "lm_head.weight" in results[-1]["params"]
    assert "lm_head.weight" not in results[0]["params"]
    assert "model.embed_tokens.weight" not in results[-1]["params"]
    if not bf16:
        _assert_weights(_merged(results), want_params, runs["ctx"]["weights"])


def test_a_microbatch_mean_schedule_would_differ(runs):
    """The first batch's -100 labels fall unevenly over the two
    microbatches: the mean of their means (what a schedule that averages
    per-microbatch losses takes) differs from the batch's token mean by far
    more than the steps' tolerance (1e-5), and the pipelined step's first
    loss is the token mean, as the JAX step's."""
    ctx = runs["ctx"]
    module = M.LlamaForCausalLM(_config())
    module.load_state_dict(ctx["weights"])
    b = ctx["batches"][0]
    with torch.no_grad():
        logits = module(torch.from_numpy(b["x"])).reshape(2, -1, 256)
    y = torch.from_numpy(b["y"]).reshape(2, -1)
    sums = torch.stack([torch.nn.functional.cross_entropy(
        logits[i], y[i], ignore_index=-100, reduction="sum") for i in range(2)])
    counts = (y != -100).sum(1)
    assert counts[0] != counts[1]
    token_mean = float(sums.sum() / counts.sum())
    mean_of_means = float((sums / counts).mean())
    got = runs[2][0]["pp2"]["metrics"][0][0]
    assert abs(mean_of_means - token_mean) > 10 * 1e-5 * token_mean
    assert abs(got - token_mean) <= 1e-5 * token_mean
    assert abs(got - _jax_train(ctx)[0][0][0]) <= 1e-5 * token_mean


def test_tied_embedding_at_pp2_matches_jax(runs):
    """Gemma's tied embedding and head: stage 0 and the last stage both hold
    it, its gradient summed over them (counted once in the norm), both
    copies equal after the steps and as the JAX step's (at pp=1, the
    cheaper compile of the same function)."""
    want_metrics, want_params = _jax_train(runs["ctx"], tied=True, pp=1)
    results = [r["gemma"] for r in runs[2]]
    for r in results:
        _assert_metrics(r["metrics"], want_metrics, 1e-5)
        assert r["shared"] == ["model.embed_tokens.weight"]
    _assert_weights(_merged(results), want_params, runs["ctx"]["tied_weights"], tied=True)


# ---------------------------------------------------------------------------
# Checkpoints across pp
# ---------------------------------------------------------------------------


def test_pp2_checkpoint_resumes_at_pp1_in_both_packages(runs):
    """A save at pp=2 holds whole tensors in the JAX package's layout: the
    port at pp=1 and the JAX package load it bit for bit (parameters and
    AdamW moments); DISTRIBUTED_STATE_DICT under pp writes both stages'
    shards (its round trips: tests/test_torch_parallel_rest.py)."""
    import jax

    from accelerate_tpu import Accelerator as JaxAccelerator
    from accelerate_tpu import Model as JaxModel

    ctx = runs["ctx"]
    saved = [r["save"] for r in runs[2]]
    assert saved[0]["dcp_files"] == [".metadata", "__0_0.distcp", "__1_0.distcp"]
    params = _merged(saved)
    moments = {}
    for r in saved:
        moments.update(r["moments"])
    module = M.LlamaForCausalLM(_config())
    acc = Accelerator(cpu=True)
    acc.prepare(Model(module), adamw(LR))
    acc.load_state(ctx["ckpt_pp2"])
    for n, p in module.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), params[n], err_msg=n)
        for k in ("exp_avg", "exp_avg_sq"):
            np.testing.assert_array_equal(acc.train_state.optimizer.state[p][k].numpy(),
                                          moments[n][k], err_msg=f"{n} {k}")
    _jax_reset()
    import optax

    jacc = JaxAccelerator()
    jacc.prepare(JaxModel(module=_jax_module(), params=_flax(ctx["weights"])),
                 optax.adamw(LR))
    jacc.load_state(ctx["ckpt_pp2"])
    got = convert.llama_views_from_flax(_config(), jax.tree.map(
        lambda a: torch.from_numpy(np.array(a)), jacc.train_state.params))
    for n, a in params.items():
        np.testing.assert_array_equal(got[n].numpy(), a, err_msg=n)
    _jax_reset()


def test_pp1_checkpoint_resumes_at_pp2(runs):
    """A save at pp=1 (2 steps) loaded at pp=2: each stage's parameters and
    moments bit for bit those saved."""
    want = runs["ctx"]["pp1"]
    for r in runs[2]:
        got = r["load"]
        assert got["params"]
        for n, a in got["params"].items():
            np.testing.assert_array_equal(a, want["params"][n], err_msg=n)
            for k in ("exp_avg", "exp_avg_sq"):
                np.testing.assert_array_equal(got["moments"][n][k], want["moments"][n][k])
