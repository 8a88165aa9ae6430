"""Expert parallelism and the sequence-axis compositions of the port
against the JAX package's.

Without processes: ``mixtral_tp_rules(ep_axes)`` equals the JAX table,
``ep_axes`` validation follows ``tests/test_moe.py``, and the plan puts
each expert stack's dim 0 on the ep axes.

On gloo gangs of 2 and 4 CPU processes (``torch.multiprocessing`` spawn,
a ``file://`` rendezvous under the test's temporary directory), spawned
once for the module, against the JAX Accelerator on the 8 virtual CPU
devices of ``tests/conftest.py``, from numpy-seeded weights carried into
both packages, the tiny fp32 Mixtral at capacity factor 0.5 over 8
experts (tokens drop) and the tiny fp32 Llama, 3 steps each on the same
global batches. The Mixtral reference is the JAX step at ``dp_shard=4 ×
tp=2, ep=4`` (``MULTICHIP_r05.json``'s scenario), the Llama one at
``dp_shard=2 × tp=2 × cp=2``; GSPMD gives every mesh the numbers of the
unsharded step, so each port layout is held to them:

- 2 processes: ep=2 over ``dp_shard`` (also against the port's own
  ``dp_shard=2`` run without ep, within 1e-6 and with equal drops),
  ``sp=2`` with ep=2 (Ulysses attention; ep over ``sp``), Mixtral over
  ``cp=2``; a checkpoint saved at ep=2 resumed bit for bit at ep=1, a
  ``DISTRIBUTED_STATE_DICT`` round trip at ep=2; greedy ``generate``
  under ep=2 against the JAX tokens;
- 4 processes: ``dp_shard=2 × tp=2`` with ep=2 and ep=4 over
  ``(dp_shard, tp)``; Llama steps at ``tp=2 × cp=2`` (flash: the
  ``"allgather"`` ring on each rank's heads), ``tp=2 × sp=2`` (Ulysses on
  each rank's heads) and ``pp=2 × cp=2``.

Losses and grad norms within 1e-5 relative, aux losses too, drop counts
exactly equal, parameters after the steps within 1e-4 (with the AdamW
allowance of ``tests/test_torch_distributed.py``'s
``_assert_params_close``).

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
    ProjectConfiguration,
    adamw,
    generate,
    moe_cross_entropy_loss,
)
from accelerate_tpu_torch.models import (
    LlamaConfig,
    LlamaForCausalLM,
    MixtralConfig,
    MixtralForCausalLM,
    cross_entropy_loss,
    llama_params_to_flax,
    llama_tp_rules,
    mixtral_tp_rules,
)
from accelerate_tpu_torch.parallel import tp
from accelerate_tpu_torch.parallel.sharding import local_batch
from accelerate_tpu_torch.state import AcceleratorState, GradientState, PartialState
from test_torch_distributed import _assert_params_close, _jax_reset

STEPS, LR, SEQ, BATCH = 3, 1e-3, 16, 8
RTOL, SELF_RTOL, MIN_GAP = 1e-5, 1e-6, 1e-4
MOE = dict(capacity_factor=0.5, num_local_experts=8)
PROMPT, NEW_TOKENS = (2, 8), 8

# Mixtral runs: name -> (processes, ParallelismConfig kwargs, attention_impl)
MOE_RUNS = {
    "dp_shard2": (2, dict(dp_shard_size=2), "flash"),
    "ep2": (2, dict(dp_shard_size=2, ep_size=2), "flash"),
    "sp2_ep2": (2, dict(sp_size=2, ep_size=2), "ulysses"),
    "cp2": (2, dict(cp_size=2), "flash"),
    "dp_shard2_tp2_ep2": (4, dict(dp_shard_size=2, tp_size=2, ep_size=2), "flash"),
    "ep4": (4, dict(dp_shard_size=2, tp_size=2, ep_size=4), "flash"),
}
# Llama runs at 4 processes: name -> (ParallelismConfig kwargs, attention_impl)
LLAMA_RUNS = {
    "tp2_cp2": (dict(tp_size=2, cp_size=2), "flash"),
    "tp2_sp2": (dict(tp_size=2, sp_size=2), "ulysses"),
    "pp2_cp2": (dict(pp_size=2, cp_size=2), "flash"),
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the suite runs several test processes at once,
    and torch's spinning thread pools would contend for the cores."""
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


def _moe_config(**kw) -> MixtralConfig:
    return MixtralConfig.tiny(dtype=torch.float32, **MOE, **kw)


def _weights(module_cls, cfg, seed) -> dict:
    """numpy-seeded fp32 weights: unit-ish norms, fan-in scaled matrices
    (stacks and the router by their input dim)."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, p in module_cls(cfg, device="meta").state_dict().items():
        if p.dim() == 1:
            a = rng.standard_normal(p.shape) * 0.1 + 1.0
        else:
            fan_in = p.shape[1] if p.dim() == 2 and not name.endswith("router") else p.shape[-2]
            a = rng.standard_normal(p.shape) / np.sqrt(fan_in)
        out[name] = np.asarray(a, np.float32)
    return out


def _batches(seed=0) -> list:
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(STEPS):
        ids = rng.integers(0, 256, size=(BATCH, SEQ + 1))
        out.append({"x": ids[:, :-1], "y": ids[:, 1:]})
    return out


def _whole(t) -> np.ndarray:
    return (t.full_tensor() if hasattr(t, "full_tensor") else t).detach().numpy().copy()


def _whole_state(acc) -> dict:
    st = acc.train_state
    return {"params": {n: _whole(p) for n, p in st.model.module.named_parameters()},
            "moments": {n: {k: _whole(st.optimizer.state[p][k])
                            for k in ("exp_avg", "exp_avg_sq")}
                        for n, p in st.model.module.named_parameters()},
            "step": int(st.step)}


# ---------------------------------------------------------------------------
# The jobs each spawned process runs
# ---------------------------------------------------------------------------


def _moe_accelerator(ctx, pc_kwargs, impl, project_dir=None, dcp=False):
    """A prepared tiny Mixtral on ctx's weights under ``pc_kwargs``: its
    Accelerator, Model and module; TP/EP rules whenever tp or ep is set."""
    cfg = _moe_config(attention_impl=impl)
    module = MixtralForCausalLM(cfg)
    module.load_state_dict({k: torch.from_numpy(v) for k, v in ctx["moe_weights"].items()})
    pc = ParallelismConfig(**pc_kwargs)
    plugin = (FullyShardedDataParallelPlugin(state_dict_type="DISTRIBUTED_STATE_DICT") if dcp
              else FullyShardedDataParallelPlugin())
    acc = Accelerator(cpu=True, parallelism_config=pc, fsdp_plugin=plugin,
                      project_config=ProjectConfiguration(project_dir=project_dir))
    rules = (mixtral_tp_rules(True, ep_axes=pc.ep_axes)
             if pc.tp_size > 1 or pc.ep_size > 1 else None)
    model, _ = acc.prepare(Model(module, tp_rules=rules), adamw(LR))
    return acc, model, module


def _moe_steps(ctx, name):
    """STEPS steps: per step the loss, the aux loss of the global batch,
    the grad norm and the layers' dropped choices; the whole parameters
    after them, and the exchange's calls per step."""
    from accelerate_tpu_torch.parallel.ep import exchange_counters

    _, pc_kwargs, impl = MOE_RUNS[name]
    acc, model, module = _moe_accelerator(ctx, pc_kwargs, impl,
                                          project_dir=ctx["save_dir"] if name == "ep2" else None)
    rank, world = dist.get_rank(), dist.get_world_size()
    aux = []

    def tap(*args, **kwargs):
        out = model(*args, **kwargs)
        aux.append(out[1].detach().clone())
        return out

    step = acc.prepare_train_step(
        lambda m, b: moe_cross_entropy_loss(tap, b["x"].long(), b["y"].long()),
        max_grad_norm=1.0)
    exchange_counters.reset()
    rows = []
    for i in range(STEPS):
        _, m = step(acc.train_state, local_batch(ctx["batches"][i], acc.parallelism_config, rank))
        share = aux[-1]
        dist.all_reduce(share)
        rows.append((float(m["loss"]), float(share) / world, float(m["grad_norm"]),
                     int(module.router_stats()["dropped"])))
    out = {"metrics": rows, "params": {n: _whole(p) for n, p in module.named_parameters()},
           "exchanges": exchange_counters.snapshot()["calls"] / STEPS,
           "experts": sorted(model.expert_params)}
    # A forward outside the step: each process routes its own rows alone.
    with torch.no_grad():
        x = local_batch(ctx["batches"][0], acc.parallelism_config, rank)["x"]
        logits = tp.gather_vocab(model(torch.from_numpy(x).long()))  # whole under tp
        out["eval_logits"] = logits.detach().numpy()
    if name == "ep2":
        acc.save_state(ctx["save_dir"])
        out["saved"] = _whole_state(acc)
    _reset_port()
    return out


def _job_moe(ctx):
    world = dist.get_world_size()
    return {name: _moe_steps(ctx, name) for name, (n, _, _) in MOE_RUNS.items() if n == world}


def _job_dcp(ctx):
    """At ep=2: one step, a DISTRIBUTED_STATE_DICT save, then a fresh
    Accelerator with other weights loads it: the whole state at the save
    and after the load. Then the ep=2 run's whole-tensor checkpoint loaded
    at ep=2 (each rank's rows of every stack from the flax leaves)."""
    rank = dist.get_rank()
    kw = MOE_RUNS["ep2"][1]
    acc, _, _ = _moe_accelerator(ctx, kw, "flash", dcp=True)
    step = acc.prepare_train_step(
        lambda m, b: moe_cross_entropy_loss(m, b["x"].long(), b["y"].long()), max_grad_norm=1.0)
    step(acc.train_state, local_batch(ctx["batches"][0], acc.parallelism_config, rank))
    acc.save_state(ctx["dcp_dir"])
    saved = _whole_state(acc)
    _reset_port()
    acc, _, module = _moe_accelerator(ctx, kw, "flash", dcp=True)
    with torch.no_grad():
        for p in module.parameters():
            p.zero_() if not hasattr(p, "to_local") else p.to_local().zero_()
    acc.load_state(ctx["dcp_dir"])
    loaded = _whole_state(acc)
    _reset_port()
    acc, _, _ = _moe_accelerator(ctx, kw, "flash")
    acc.load_state(ctx["save_dir"])
    whole = _whole_state(acc)
    _reset_port()
    return {"saved": saved, "loaded": loaded, "whole_loaded": whole}


def _job_generate(ctx):
    """Greedy ``generate`` of the tiny Mixtral prepared under ep=2, every
    rank on the same prompt."""
    acc, model, _ = _moe_accelerator(ctx, MOE_RUNS["ep2"][1], "flash")
    out = generate(model, ctx["prompt"], max_new_tokens=NEW_TOKENS).numpy()
    _reset_port()
    return out


def _job_llama(ctx):
    """STEPS steps of the tiny Llama in each 4-process layout: (loss, grad
    norm) per step and the whole parameters after them."""
    from accelerate_tpu_torch.parallel.pp import llama_pipeline_forward

    rank = dist.get_rank()
    out = {}
    for name, (kw, impl) in LLAMA_RUNS.items():
        cfg = LlamaConfig.tiny(dtype=torch.float32, attention_impl=impl)
        module = LlamaForCausalLM(cfg)
        module.load_state_dict({k: torch.from_numpy(v) for k, v in ctx["llama_weights"].items()})
        pc = ParallelismConfig(**kw)
        acc = Accelerator(cpu=True, parallelism_config=pc,
                          fsdp_plugin=FullyShardedDataParallelPlugin())
        rules = llama_tp_rules(True) if pc.tp_size > 1 else None
        model, _ = acc.prepare(Model(module, tp_rules=rules), adamw(LR))
        if pc.pp_size > 1:
            loss = lambda m, b: cross_entropy_loss(llama_pipeline_forward(m, b["x"].long()),
                                                   b["y"].long())
        else:
            loss = lambda m, b: cross_entropy_loss(m(b["x"].long()), b["y"].long())
        step = acc.prepare_train_step(loss, max_grad_norm=1.0)
        metrics = []
        for i in range(STEPS):
            _, m = step(acc.train_state,
                        local_batch(ctx["batches"][i], acc.parallelism_config, rank))
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
        params = {n: _whole(p) for n, p in module.named_parameters()}
        if pc.pp_size > 1:  # each stage holds its own layers: every stage's, whole
            parts = [None] * dist.get_world_size()
            dist.all_gather_object(parts, params)
            params = {n: v for part in parts for n, v in part.items()}
        out[name] = {"metrics": metrics, "params": params}
        _reset_port()
    return out


JOBS = {"moe": _job_moe, "dcp": _job_dcp, "generate": _job_generate, "llama": _job_llama}


def _worker(rank, world, init_file, ctx_path, jobs):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world)
    with open(ctx_path, "rb") as f:
        ctx = pickle.load(f)
    results = {job: JOBS[job](ctx) for job in jobs}
    gathered = [None] * world
    dist.all_gather_object(gathered, results)
    if rank == 0:
        with open(ctx_path + f".out{world}", "wb") as f:
            pickle.dump(gathered, f)
    dist.destroy_process_group()


def _spawn(tmp, world, jobs, ctx) -> list:
    ctx_path = str(tmp / f"ctx{world}.pkl")
    with open(ctx_path, "wb") as f:
        pickle.dump(ctx, f)
    mp.start_processes(_worker, args=(world, str(tmp / f"rendezvous{world}"), ctx_path, jobs),
                       nprocs=world, join=True, start_method="spawn")
    with open(ctx_path + f".out{world}", "rb") as f:
        return pickle.load(f)


# ---------------------------------------------------------------------------
# The JAX references
# ---------------------------------------------------------------------------


def _moe_flax(weights) -> dict:
    return llama_params_to_flax(_moe_config(), {k: torch.from_numpy(v)
                                                for k, v in weights.items()})


def _llama_flax(weights) -> dict:
    return llama_params_to_flax(LlamaConfig.tiny(dtype=torch.float32),
                                {k: torch.from_numpy(v) for k, v in weights.items()})


def _jax_moe_train(weights, batches):
    """The JAX Accelerator's tiny Mixtral at dp_shard=4 × tp=2, ep=4 (the
    expert dim over dp_shard) with the FSDP plugin on the whole global
    batches: per step the loss, the aux loss and the dropped choices (a
    forward of the step's parameters, its dispatch counted through a debug
    callback) and the grad norm; and the parameters after the steps."""
    import jax
    import jax.numpy as jnp
    import optax

    from accelerate_tpu import Accelerator as JaxAccelerator
    from accelerate_tpu import FullyShardedDataParallelPlugin as JaxPlugin
    from accelerate_tpu import Model as JaxModel
    from accelerate_tpu import ParallelismConfig as JaxPC
    from accelerate_tpu.models import moe as jax_moe

    _jax_reset()
    pc = JaxPC(dp_shard_size=4, tp_size=2, ep_size=4)
    module = jax_moe.MixtralForCausalLM(jax_moe.MixtralConfig.tiny(dtype=jnp.float32, **MOE))
    acc = JaxAccelerator(parallelism_config=pc, fsdp_plugin=JaxPlugin())
    params = jax.tree.map(lambda t: jnp.asarray(t.numpy()), _moe_flax(weights))
    acc.prepare(JaxModel(module=module, params=params,
                         tp_rules=jax_moe.mixtral_tp_rules(True, ep_axes=pc.ep_axes)),
                optax.adamw(LR))
    spec = acc.state_shardings.params["model"]["layers"]["block"]["moe"]["w_gate"].spec
    step = acc.prepare_train_step(
        lambda p, b: jax_moe.moe_cross_entropy_loss(module, p, b["x"], b["y"]),
        max_grad_norm=1.0)
    dispatch, dropped = jax_moe.compute_dispatch, []

    def counting(probs, k, capacity):
        d, c = dispatch(probs, k, capacity)
        jax.debug.callback(lambda n: dropped.append(int(n)), probs.shape[0] * k - d.sum())
        return d, c

    forward = jax.jit(lambda p, x: module.apply({"params": p}, x, mutable=["losses"])[1])
    rows = []
    for b in batches:
        b = {k: jnp.asarray(v, jnp.int32) for k, v in b.items()}
        jax_moe.compute_dispatch = counting
        try:
            col = forward(acc.train_state.params, b["x"])
            jax.effects_barrier()
        finally:
            jax_moe.compute_dispatch = dispatch
        aux = float(sum(jnp.sum(v) for v in jax.tree.leaves(col["losses"])))
        _, m = step(acc.train_state, b)
        rows.append((float(m["loss"]), aux, float(m["grad_norm"]), sum(dropped)))
        dropped.clear()
    final = jax.tree.map(np.asarray, acc.train_state.params)
    _jax_reset()
    return rows, final, tuple(spec)


def _jax_llama_train(weights, batches):
    """The JAX Accelerator's tiny Llama at dp_shard=2 × tp=2 × cp=2 with the
    FSDP plugin and llama_tp_rules: (loss, grad norm) per step and the
    parameters after the steps."""
    import jax
    import jax.numpy as jnp
    import optax

    from accelerate_tpu import Accelerator as JaxAccelerator
    from accelerate_tpu import FullyShardedDataParallelPlugin as JaxPlugin
    from accelerate_tpu import Model as JaxModel
    from accelerate_tpu import ParallelismConfig as JaxPC
    from accelerate_tpu.models import LlamaConfig as JaxLlamaConfig
    from accelerate_tpu.models import LlamaForCausalLM as JaxLlama
    from accelerate_tpu.models import cross_entropy_loss as jax_ce
    from accelerate_tpu.models import llama_tp_rules as jax_llama_rules

    _jax_reset()
    module = JaxLlama(JaxLlamaConfig.tiny(dtype=jnp.float32))
    acc = JaxAccelerator(parallelism_config=JaxPC(dp_shard_size=2, tp_size=2, cp_size=2),
                         fsdp_plugin=JaxPlugin())
    params = jax.tree.map(lambda t: jnp.asarray(t.numpy()), _llama_flax(weights))
    acc.prepare(JaxModel(module=module, params=params, tp_rules=jax_llama_rules(True)),
                optax.adamw(LR))
    step = acc.prepare_train_step(
        lambda p, b: jax_ce(module.apply({"params": p}, b["x"]), b["y"]), max_grad_norm=1.0)
    metrics = []
    for b in batches:
        _, m = step(acc.train_state, {k: jnp.asarray(v, jnp.int32) for k, v in b.items()})
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    final = jax.tree.map(np.asarray, acc.train_state.params)
    _jax_reset()
    return metrics, final


def _jax_generate(weights, prompt):
    import jax.numpy as jnp

    from accelerate_tpu import Model as JaxModel
    from accelerate_tpu.generation import generate as jax_generate
    from accelerate_tpu.models import moe as jax_moe

    import jax

    module = jax_moe.MixtralForCausalLM(jax_moe.MixtralConfig.tiny(dtype=jnp.float32, **MOE))
    params = jax.tree.map(lambda t: jnp.asarray(t.numpy()), _moe_flax(weights))
    model = JaxModel(module=module, params=params)
    return np.asarray(jax_generate(model, prompt, max_new_tokens=NEW_TOKENS))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both gangs' results and the JAX references."""
    tmp = tmp_path_factory.mktemp("ep")
    moe_weights = _weights(MixtralForCausalLM, _moe_config(), seed=0)
    llama_weights = _weights(LlamaForCausalLM, LlamaConfig.tiny(dtype=torch.float32), seed=1)
    batches = _batches()
    prompt = np.random.default_rng(3).integers(1, 256, PROMPT)
    ctx = {"moe_weights": moe_weights, "llama_weights": llama_weights, "batches": batches,
           "prompt": prompt, "save_dir": str(tmp / "ep2"), "dcp_dir": str(tmp / "dcp")}
    two = _spawn(tmp, 2, ["moe", "dcp", "generate"], ctx)
    four = _spawn(tmp, 4, ["moe", "llama"], ctx)
    moe_ref, moe_final, spec = _jax_moe_train(moe_weights, batches)
    llama_ref, llama_final = _jax_llama_train(llama_weights, batches)
    return {2: two, 4: four, "ctx": ctx, "moe_ref": moe_ref, "moe_final": moe_final,
            "spec": spec, "llama_ref": llama_ref, "llama_final": llama_final,
            "tokens": _jax_generate(moe_weights, prompt)}


# ---------------------------------------------------------------------------
# Tests without processes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scan_layers", [True, False], ids=["stacked", "unrolled"])
@pytest.mark.parametrize("ep_axes", [("dp_shard",), ("sp",), ("dp_shard", "tp")],
                         ids=["dp_shard", "sp", "dp_shard_tp"])
def test_mixtral_ep_rules_equal_the_jax_table(ep_axes, scan_layers):
    from accelerate_tpu.models.moe import mixtral_tp_rules as jax_rules

    want = [(p, tuple(s)) for p, s in jax_rules(scan_layers, ep_axes=ep_axes)]
    assert mixtral_tp_rules(scan_layers, ep_axes=ep_axes) == want


def test_ep_axes_validation_follows_the_jax_package():
    """tests/test_moe.py::test_ep_axes_validation, and the JAX
    constructor's bound."""
    from accelerate_tpu import ParallelismConfig as JaxPC

    for cls in (ParallelismConfig, JaxPC):
        with pytest.raises(ValueError):
            cls(dp_shard_size=4, ep_size=8).ep_axes  # 8 not a product
        assert cls(dp_shard_size=4, ep_size=4).ep_axes == ("dp_shard",)
        assert cls(ep_size=1).ep_axes == ()
        assert cls(dp_shard_size=2, tp_size=2, ep_size=4).ep_axes == ("dp_shard", "tp")
        assert cls(dp_shard_size=2, sp_size=2, ep_size=2).ep_axes == ("dp_shard",)
        with pytest.raises(ValueError, match="ep_size must divide"):
            cls(ep_size=2)


def test_plan_puts_the_expert_dim_on_the_ep_axes():
    """Each expert stack's dim 0 on the ep axes (``ParamPlacement.ep``,
    ``Shard(0)``), its spec the JAX plan's; attention as under tp."""
    from torch.distributed.tensor import Shard

    from accelerate_tpu_torch.parallel import sharding

    module = MixtralForCausalLM(_moe_config(), device="meta")
    pc = ParallelismConfig(dp_shard_size=2, tp_size=2, ep_size=4)
    plan = sharding.plan_parameter_sharding(
        module, pc, parallelism_config=pc, tp_rules=mixtral_tp_rules(True, ep_axes=pc.ep_axes))
    stacks = {n: p for n, p in plan.items() if n.rsplit(".", 1)[-1] in ("w_gate", "w_up",
                                                                      "w_down")}
    assert len(stacks) == 6
    for p in stacks.values():
        assert p.ep == Shard(0) and p.tp is None
        assert p.spec == (None, ("dp_shard", "tp"))
    assert plan["model.layers.0.self_attn.q_proj.weight"].tp == Shard(0)
    assert plan["model.layers.0.moe.router"].ep is None


# ---------------------------------------------------------------------------
# The gangs against the JAX package
# ---------------------------------------------------------------------------


def _close(got, want, rtol):
    return abs(got - want) <= rtol * abs(want)


def _assert_moe_rows(got, want, rtol):
    for (gl, ga, gn, gd), (wl, wa, wn, wd) in zip(got, want, strict=True):
        assert _close(gl, wl, rtol) and _close(ga, wa, rtol) and _close(gn, wn, rtol), (got, want)
        assert gd == wd, (got, want)


def _moe_result(runs, name):
    world = MOE_RUNS[name][0]
    return [rank["moe"][name] for rank in runs[world]]


@pytest.mark.parametrize("name", list(MOE_RUNS))
def test_moe_steps_match_jax(runs, name):
    """Loss, aux loss, grad norm and dropped choices of every Mixtral layout
    against the JAX step at dp_shard=4 × tp=2, ep=4, equal on every
    process; the parameters after the steps."""
    ranks = _moe_result(runs, name)
    for r in ranks:
        _assert_moe_rows(r["metrics"], runs["moe_ref"], RTOL)
        assert r["metrics"] == ranks[0]["metrics"]
    init = _moe_flax(runs["ctx"]["moe_weights"])
    got = _moe_flax(ranks[0]["params"])
    _assert_params_close(got, runs["moe_final"], init)
    assert runs["spec"][1] == "dp_shard"  # the JAX reference ran the expert dim on ep


def test_ep_matches_the_run_without_ep(runs):
    """ep=2 over dp_shard against the port's own dp_shard=2 run: losses,
    aux losses and grad norms within 1e-6, drops exactly equal; ep changes
    only where the products run. Two exchanges a layer forward, repeated
    in the backward: 8 a step over 2 layers."""
    with_ep, without = _moe_result(runs, "ep2")[0], _moe_result(runs, "dp_shard2")[0]
    _assert_moe_rows(with_ep["metrics"], without["metrics"], SELF_RTOL)
    assert with_ep["exchanges"] == 8 and without["exchanges"] == 0
    assert len(with_ep["experts"]) == 6 and without["experts"] == []
    for name, p in without["params"].items():
        np.testing.assert_allclose(with_ep["params"][name], p, rtol=0, atol=1e-6, err_msg=name)
    # Outside a step each process routes alone, under ep too (its slots in
    # its own stretch of each owner's queue).
    for r in range(2):
        np.testing.assert_allclose(runs[2][r]["moe"]["ep2"]["eval_logits"],
                                   runs[2][r]["moe"]["dp_shard2"]["eval_logits"],
                                   rtol=0, atol=1e-5)


def test_ep_over_tp_exchanges_over_dp_shard_only(runs):
    """ep=4 over (dp_shard, tp): each tp rank fills its own experts, so the
    rows cross dp_shard only (8 exchanges a step), and ep=2 over dp_shard
    beside tp=2 exchanges as ep=2 alone."""
    assert all(r["exchanges"] == 8 for r in _moe_result(runs, "ep4"))
    assert all(r["exchanges"] == 8 for r in _moe_result(runs, "dp_shard2_tp2_ep2"))


def test_checkpoint_saved_at_ep2_resumes_at_ep1(runs, tmp_path):
    """The whole-tensor checkpoint written by the ep=2 run resumed by one
    process without ep: parameters and moments bit for bit."""
    saved = _moe_result(runs, "ep2")[0]["saved"]
    cfg = _moe_config()
    module = MixtralForCausalLM(cfg)
    acc = Accelerator(cpu=True)
    acc.prepare(Model(module), adamw(LR))
    acc.load_state(runs["ctx"]["save_dir"])
    loaded = _whole_state(acc)
    assert loaded["step"] == saved["step"] == STEPS
    for name, p in saved["params"].items():
        np.testing.assert_array_equal(loaded["params"][name], p, err_msg=name)
        for k, m in saved["moments"][name].items():
            np.testing.assert_array_equal(loaded["moments"][name][k], m, err_msg=name)


def _assert_states_equal(got, want):
    assert got["step"] == want["step"]
    for name, p in want["params"].items():
        np.testing.assert_array_equal(got["params"][name], p, err_msg=name)
        for k, m in want["moments"][name].items():
            np.testing.assert_array_equal(got["moments"][name][k], m, err_msg=name)


def test_dcp_round_trip_at_ep2(runs):
    """DISTRIBUTED_STATE_DICT saved and loaded at ep=2: every process's
    parameters and moments bit for bit. The ep=2 run's whole-tensor
    checkpoint loaded back at ep=2 too: each rank takes its rows of every
    expert stack from the flax leaves."""
    saved_whole = _moe_result(runs, "ep2")[0]["saved"]
    for rank in runs[2]:
        saved, loaded = rank["dcp"]["saved"], rank["dcp"]["loaded"]
        assert saved["step"] == 1
        _assert_states_equal(loaded, saved)
        _assert_states_equal(rank["dcp"]["whole_loaded"], saved_whole)


def test_generate_under_ep_matches_jax(runs):
    """Greedy tokens of the model prepared under ep=2, equal on both
    processes, against the JAX package's generate; every step's top-2
    logit gap (the port's one-process cached forward) above 1e-4."""
    from accelerate_tpu_torch import generation as gen

    want = runs["tokens"]
    for rank in runs[2]:
        np.testing.assert_array_equal(rank["generate"], want)
    cfg = _moe_config()
    module = MixtralForCausalLM(cfg)
    module.load_state_dict({k: torch.from_numpy(v) for k, v in runs["ctx"]["moe_weights"].items()})
    rows = torch.as_tensor(want).long()
    logits, _ = gen._llama_forward_cached(cfg, module, rows, gen.init_cache(cfg, *rows.shape),
                                          return_all=True)
    top2 = torch.topk(logits[:, PROMPT[1] - 1:-1], 2, dim=-1).values
    assert float((top2[..., 0] - top2[..., 1]).min()) > MIN_GAP


@pytest.mark.parametrize("name", list(LLAMA_RUNS))
def test_llama_sequence_axis_compositions_match_jax(runs, name):
    """tp=2 × cp=2, tp=2 × sp=2 (Ulysses) and pp=2 × cp=2 against the JAX
    step at dp_shard=2 × tp=2 × cp=2: losses and grad norms within 1e-5
    relative on every process, the parameters after the steps."""
    for rank in runs[4]:
        got = rank["llama"][name]["metrics"]
        for (gl, gn), (wl, wn) in zip(got, runs["llama_ref"], strict=True):
            assert _close(gl, wl, RTOL) and _close(gn, wn, RTOL), (got, runs["llama_ref"])
    init = _llama_flax(runs["ctx"]["llama_weights"])
    got = _llama_flax(runs[4][0]["llama"][name]["params"])
    _assert_params_close(got, runs["llama_final"], init)


def test_pp_refuses_the_ring_over_a_sequence_axis(monkeypatch):
    """attention_impl ring or ulysses under pp with a cp or sp axis is
    refused, as the JAX llama_pipeline_forward fails there (a shard_map
    inside the pipeline's)."""
    from accelerate_tpu_torch.parallel import pp

    module = LlamaForCausalLM(LlamaConfig.tiny(dtype=torch.float32, attention_impl="ring"))
    monkeypatch.setattr(pp, "_pipeline_ranks", lambda mesh, axis: (2, 0, None))
    monkeypatch.setattr(pp, "_active_mesh", lambda mesh: None)
    monkeypatch.setattr("accelerate_tpu_torch.state.current_sequence_shard", lambda: (2, 0))
    with pytest.raises(NotImplementedError, match="JAX llama_pipeline_forward fails"):
        pp.llama_pipeline_forward(module, torch.zeros(2, 8, dtype=torch.long))
