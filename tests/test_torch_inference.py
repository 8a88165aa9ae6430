"""Pipeline-parallel inference (``prepare_pippy``) of the port against the
JAX package's (``tests/test_inference.py``).

On a gloo gang of 2 CPU processes spawned once for the module (the
``tests/test_torch_pipeline.py`` pattern; its affine stack covers
``pp=4``), each rank one stage holding the whole weights and running its
own layers:

- the tiny Llama's pipelined logits at ``pp=2`` within 2e-5 of the JAX
  ``prepare_pippy``'s on the 8 virtual CPU devices, on the last stage; the
  other stage returns None;
- an odd batch (6 rows over 4 chunks: padded with the last row and sliced
  back) against the JAX package's;
- ``gather_output=True``: every rank gets the logits;
- the tiny GPT-2's plan at ``pp=2`` against the JAX one;
- a plan registered with ``register_pipeline_plan`` and ``forward_fn=``.

In this process: the unknown-model error and ``pipeline_stage_layers``
against the JAX function.
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
    Model,
    ParallelismConfig,
    pipeline_stage_layers,
    prepare_pippy,
    register_pipeline_plan,
)
from accelerate_tpu_torch import models as M
from accelerate_tpu_torch.inference import PIPELINE_PLANS
from accelerate_tpu_torch.models import convert
from accelerate_tpu_torch.state import AcceleratorState, GradientState, PartialState


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


def _llama(layers=4):
    module = M.LlamaForCausalLM(M.LlamaConfig.tiny(dtype=torch.float32, num_hidden_layers=layers))
    module.init_weights(torch.Generator().manual_seed(0))
    return module


def _gpt2():
    module = M.GPT2LMHeadModel(M.GPT2Config.tiny(dtype=torch.float32, n_layer=4))
    module.init_weights(torch.Generator().manual_seed(0))
    return module


def _ids(vocab=256, rows=8, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (rows, 16))


def _job_pippy(ctx):
    """Each rank's result of the plans (None off the last stage)."""
    world = dist.get_world_size()
    Accelerator(cpu=True, parallelism_config=ParallelismConfig(pp_size=world))
    llama = Model(_llama())
    ids = torch.from_numpy(_ids())
    out = {}
    with torch.no_grad():
        out["llama"] = _np(prepare_pippy(llama)(ids))
        out["odd"] = _np(prepare_pippy(llama, num_chunks=4)(ids[:6]))
        out["gathered"] = _np(prepare_pippy(llama, gather_output=True)(ids))
        out["gpt2"] = _np(prepare_pippy(Model(_gpt2()), num_chunks=4)(ids))
        calls = []

        def plan(model, input_ids, *, mesh, n_microbatches):
            calls.append(n_microbatches)
            return PIPELINE_PLANS["LlamaForCausalLM"](model, input_ids, mesh=mesh,
                                                      n_microbatches=n_microbatches)

        out["forward_fn"] = _np(prepare_pippy(llama, forward_fn=plan, num_chunks=2)(ids))
        out["calls"] = calls
    return out


def _np(t):
    return None if t is None else t.detach().numpy().copy()


JOBS = {"pippy": _job_pippy}


def _worker(rank, world, init_file, ctx_path, jobs):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world)
    results = {job: JOBS[job](None) for job in jobs}
    _reset_port()
    gathered = [None] * world
    dist.all_gather_object(gathered, results)
    if rank == 0:
        with open(ctx_path + ".out", "wb") as f:
            pickle.dump(gathered, f)
    dist.destroy_process_group()


def _spawn(tmp, world, jobs) -> list:
    ctx_path = str(tmp / f"ctx{world}")
    mp.start_processes(_worker, args=(world, str(tmp / f"rendezvous{world}"), ctx_path, jobs),
                       nprocs=world, join=True, start_method="spawn")
    with open(ctx_path + ".out", "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pippy_gangs")
    return {2: _spawn(tmp, 2, ["pippy"])}


_JAX: dict = {}


def _jax_logits(family, pp, rows=8, num_chunks=None):
    """The JAX prepare_pippy's logits of the same weights (memoised)."""
    key = (family, pp, rows, num_chunks)
    if key in _JAX:
        return _JAX[key]
    import jax
    import jax.numpy as jnp

    from accelerate_tpu import Model as JaxModel
    from accelerate_tpu import ParallelismConfig as JaxPC
    from accelerate_tpu import prepare_pippy as jax_pippy
    from accelerate_tpu import models as JM

    module = _llama() if family == "llama" else _gpt2()
    tree = convert.flax_converter(module).to_flax(module.config, module.state_dict())
    params = jax.tree.map(lambda t: np.asarray(t.numpy()), tree)
    if family == "llama":
        jmod = JM.LlamaForCausalLM(JM.LlamaConfig.tiny(dtype=jnp.float32, num_hidden_layers=4))
    else:
        jmod = JM.GPT2LMHeadModel(JM.GPT2Config.tiny(dtype=jnp.float32, n_layer=4))
    piped = jax_pippy(JaxModel(module=jmod, params=params),
                      mesh=JaxPC(pp_size=pp).build_mesh(), num_chunks=num_chunks)
    _JAX[key] = np.asarray(piped(jnp.asarray(_ids()[:rows], jnp.int32)))
    return _JAX[key]


def test_prepare_pippy_llama_matches_jax(runs):
    """The last stage's logits within 2e-5 of the JAX prepare_pippy's; the
    other stage returns None."""
    results = [r["pippy"]["llama"] for r in runs[2]]
    assert results[0] is None
    np.testing.assert_allclose(results[-1], _jax_logits("llama", 2), rtol=2e-5, atol=2e-5)


def test_prepare_pippy_pads_odd_batches(runs):
    """6 rows over 4 chunks: padded with the last row, sliced back to 6, as
    the JAX package's (and the reference's ``pad_input_tensors``)."""
    got = runs[2][-1]["pippy"]["odd"]
    assert got.shape[0] == 6
    np.testing.assert_allclose(got, _jax_logits("llama", 2, rows=6, num_chunks=4),
                               rtol=2e-5, atol=2e-5)


def test_prepare_pippy_gather_output_reaches_every_rank(runs):
    """``gather_output=True``: every rank holds the last stage's logits."""
    for r in runs[2]:
        np.testing.assert_array_equal(r["pippy"]["gathered"], runs[2][-1]["pippy"]["llama"])


def test_prepare_pippy_gpt2_matches_jax(runs):
    results = [r["pippy"]["gpt2"] for r in runs[2]]
    assert results[0] is None
    np.testing.assert_allclose(results[-1], _jax_logits("gpt2", 2, num_chunks=4),
                               rtol=2e-5, atol=2e-5)


def test_forward_fn_and_registered_plans(runs):
    """``forward_fn=`` replaces the class's plan and gets the chunk count;
    the built-in plans are the JAX package's."""
    for r in runs[2]:
        assert r["pippy"]["calls"] == [2]
    np.testing.assert_allclose(runs[2][-1]["pippy"]["forward_fn"],
                               runs[2][-1]["pippy"]["llama"], rtol=1e-6, atol=1e-6)
    assert sorted(PIPELINE_PLANS) >= ["GPT2LMHeadModel", "LlamaForCausalLM"]


def test_prepare_pippy_unknown_model_raises():
    """A class without a plan is refused, naming the built-in plans, as in
    the JAX package; registered, its plan is taken. Without a mesh or a
    set-up state prepare_pippy raises."""

    class Odd(torch.nn.Module):
        def forward(self, x):
            return x

    mesh = type("Mesh", (), {"mesh_dim_names": ()})()
    with pytest.raises(ValueError, match="No pipeline plan for 'Odd'.*GPT2LMHeadModel"):
        prepare_pippy(Model(Odd()), mesh=mesh)
    with pytest.raises(ValueError, match="needs a mesh"):
        prepare_pippy(Model(Odd()))

    def plan(model, input_ids, *, mesh, n_microbatches):
        return input_ids * 2

    register_pipeline_plan("Odd", plan)
    try:
        piped = prepare_pippy(Model(Odd()), mesh=mesh)
        assert torch.equal(piped(torch.arange(4)[:, None]), torch.arange(4)[:, None] * 2)
    finally:
        del PIPELINE_PLANS["Odd"]


def test_pipeline_stage_layers_matches_jax():
    from accelerate_tpu.inference import pipeline_stage_layers as jax_layers

    for n, s in ((8, 4), (8, 2), (4, 4), (6, 3)):
        assert pipeline_stage_layers(n, s) == jax_layers(n, s)
    assert [list(r) for r in pipeline_stage_layers(8, 4)] == [[0, 1], [2, 3], [4, 5], [6, 7]]
    with pytest.raises(ValueError):
        pipeline_stage_layers(6, 4)
