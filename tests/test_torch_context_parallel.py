"""The port's context parallelism (ring attention over ``cp``) and Ulysses
sequence parallelism (over ``sp``) against the JAX package's.

Two gangs of gloo processes run on the CPU, started with
``torch.multiprocessing`` (spawn) and meeting through a ``file://``
rendezvous under the test's temporary directory, as in
``tests/test_torch_distributed.py``: one of 2 processes and one of 4. Each
process holds its slice of the sequence (``parallel.sharding.local_batch``)
and the tests compare every process's results with the JAX package run in
this process on its virtual CPU devices (``tests/conftest.py``), on the
same inputs made with numpy from a seed:

- ``ring_attention`` (both rotate methods, cp 2 and 4) and
  ``ulysses_attention`` (sp 2 and 4, GQA 4:2, so Hkv % sp != 0 at sp=4),
  causal and not: the output and the gradients of q, k and v of
  ``sum(out · w)`` for a fixed random ``w``, fp32, within 2e-5 (the bound
  ``tests/test_attention.py`` holds the JAX ring to); and
  ``auto_flash_attention`` over a cp mesh, which attends over the whole
  sequence;
- three train steps of the fp32 tiny Llama on batches with uneven ``-100``
  labels: ``dp_shard=2 × cp=2`` ring under FSDP2 (with remat ``flash``),
  ``cp=4`` allgather ring under DDP and ``dp_shard=2 × sp=2`` Ulysses under
  FSDP2, against the JAX Accelerator with the same ``ParallelismConfig``:
  losses and grad norms within rtol 1e-4, and the parameters after them;
- the ring run's checkpoint resumed in one process and read by the JAX
  package; the loader's and the dispatcher's slices against
  ``batch_partition_spec``; the logits of each process's slice (RoPE at
  its global positions) against the JAX model's on the whole sequence;
- ``gather`` and ``gather_for_metrics`` of a prepared loader's batches
  (7 rows: a ragged last batch) under ``cp`` 2 and 4, ``sp`` 2 and
  ``dp_shard=2 × cp=2``: exactly the JAX package's rows, at full length;
- step telemetry under ``cp=2``: the records count the global batch, as
  the JAX package's;
- a ``DISTRIBUTED_STATE_DICT`` checkpoint saved by 2 FSDP2 processes and
  loaded by 4 (the 2-process gang runs first here);
- ``cp_generate`` at cp 2, cp 4 and ``dp_shard=2 × cp=2``: greedy tokens
  equal the JAX ``cp_generate``'s and the port's ``generate``'s on every
  process, EOS padding and a first token that is EOS as ``generate`` pads
  them, seeded sampling reproducible and equal on every process, each
  process's prefix cache of ``(L, B, S/cp, Hkv, D)``, a prompt that does
  not divide refused, and a Granite config (the chassis knobs the JAX
  ``cp_generate`` skips) giving ``generate``'s tokens.

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
    ColumnDataset,
    DataLoaderConfiguration,
    FullyShardedDataParallelPlugin,
    Model,
    ParallelismConfig,
    ProjectConfiguration,
    adamw,
)
from accelerate_tpu_torch.models import (
    LlamaConfig,
    LlamaForCausalLM,
    cross_entropy_loss,
    llama_params_from_flax,
)
from accelerate_tpu_torch.parallel.sharding import local_batch
from accelerate_tpu_torch.state import AcceleratorState, GradientState, PartialState
from test_torch_distributed import (
    DCP,
    LR,
    STEPS,
    _assert_params_close,
    _assert_states_equal,
    _batches,
    _flax,
    _jax_reset,
    _uneven,
)
from test_torch_distributed import _train as _dp_train


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the driver runs several test processes at once,
    and torch's spinning thread pools would contend for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


ATOL = 2e-5
# Attention inputs: (B, S, Hq, D) queries, Hkv KV heads.
B, S, HQ, HKV, D = 4, 32, 4, 2, 16
ATTENTION = [(impl, n, m, c) for impl, n, m in (("ring", 2, "alltoall"), ("ring", 2, "allgather"),
                                              ("ring", 4, "alltoall"), ("ring", 4, "allgather"),
                                              ("ulysses", 2, None), ("ulysses", 4, None),
                                              ("flash", 2, None))
             for c in (True, False)]
# Train runs: (name, world, ParallelismConfig kwargs, attention_impl, FSDP2 plugin).
TRAIN = [("dp_shard2_cp2_ring", 4, dict(dp_shard_size=2, cp_size=2), "ring", True),
         ("cp4_allgather_ddp", 4, dict(cp_size=4, cp_rotate_method="allgather"), "ring", False),
         ("dp_shard2_sp2_ulysses", 4, dict(dp_shard_size=2, sp_size=2), "ulysses", True)]
LOADER_ROWS, LOADER_BATCH = 12, 2


def _attention_inputs(seed=0):
    rng = np.random.default_rng(seed)
    return {name: rng.standard_normal(shape, dtype=np.float32) for name, shape in (
        ("q", (B, S, HQ, D)), ("k", (B, S, HKV, D)), ("v", (B, S, HKV, D)),
        ("w", (B, S, HQ, D)))}


def _reset_port():
    for cls in (AcceleratorState, GradientState, PartialState):
        cls._reset_state()


@pytest.fixture(autouse=True)
def reset_port_state():
    yield
    _reset_port()


# ---------------------------------------------------------------------------
# The jobs each spawned process runs
# ---------------------------------------------------------------------------


def _axis_config(impl, n, method):
    if impl == "ulysses":
        return ParallelismConfig(sp_size=n)
    return ParallelismConfig(cp_size=n, cp_rotate_method=method or "alltoall")


def _job_attention(ctx):
    """Each attention case this gang's size runs: this process's slice of
    the output and of the gradients of q, k and v."""
    from accelerate_tpu_torch.ops import auto_flash_attention
    from accelerate_tpu_torch.parallel.cp import ring_attention
    from accelerate_tpu_torch.parallel.sp import ulysses_attention

    rank, world = dist.get_rank(), dist.get_world_size()
    out = {}
    for case in ATTENTION:
        impl, n, method, causal = case
        if n != world:
            continue
        cfg = _axis_config(impl, n, method)
        acc = Accelerator(cpu=True, parallelism_config=cfg)
        mesh = acc.state.device_mesh
        x = {k: torch.from_numpy(v).requires_grad_(k != "w")
             for k, v in local_batch(ctx["attention"], cfg, rank).items()}
        if impl == "ring":
            o = ring_attention(x["q"], x["k"], x["v"], causal=causal, mesh=mesh,
                               rotate_method=method)
        elif impl == "ulysses":
            o = ulysses_attention(x["q"], x["k"], x["v"], causal=causal, mesh=mesh)
        else:
            o = auto_flash_attention(x["q"], x["k"], x["v"], causal=causal)
        (o * x["w"]).sum().backward()
        out[case] = {"out": o.detach().numpy(),
                     **{f"d{k}": x[k].grad.numpy() for k in ("q", "k", "v")}}
        _reset_port()
    return out


def _port_loss(model, b):
    return cross_entropy_loss(model(b["x"].long()), b["y"].long())


def _whole_params(model) -> dict:
    return {n: (p.full_tensor() if hasattr(p, "full_tensor") else p).detach().numpy().copy()
            for n, p in model.module.named_parameters()}


def _train(ctx, name, pc_kwargs, impl, fsdp):
    """STEPS steps of the tiny Llama on this process's slices of the uneven
    batches; the ring run also saves after step 2 and counts the forward
    kernel's calls (its plain version here) per step under remat flash."""
    from accelerate_tpu_torch.ops import hopper_flash

    rank = dist.get_rank()
    ring = name == "dp_shard2_cp2_ring"
    cfg = LlamaConfig.tiny(dtype=torch.float32, attention_impl=impl, remat=ring,
                           remat_policy="flash")
    module = LlamaForCausalLM(cfg)
    module.load_state_dict(llama_params_from_flax(cfg, ctx["flax_params"]))
    pc = ParallelismConfig(**pc_kwargs)
    acc = Accelerator(cpu=True, parallelism_config=pc,
                      fsdp_plugin=FullyShardedDataParallelPlugin() if fsdp else None,
                      project_config=ProjectConfiguration(
                          project_dir=ctx["save_dir"] if ring else None,
                          automatic_checkpoint_naming=ring))
    model, _ = acc.prepare(Model(module), adamw(LR))
    step = acc.prepare_train_step(_port_loss, max_grad_norm=1.0)
    calls = []
    plain = hopper_flash.flash_fwd_plain
    hopper_flash.flash_fwd_plain = lambda *a, **k: calls.append(1) or plain(*a, **k)
    metrics, saved = [], None
    try:
        for i in range(STEPS):
            _, m = step(acc.train_state, local_batch(ctx["uneven_batches"][i], pc, rank))
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
            if ring and i + 1 == 2:
                acc.save_state()
                saved = _whole_params(model)
    finally:
        hopper_flash.flash_fwd_plain = plain
    out = {"metrics": metrics, "params": _whole_params(model), "params_at_save": saved,
           "sharded": model.sharded, "ddp": model.forward_module is not model.module,
           "fwd_calls_per_step": len(calls) / STEPS,
           "ranks": (acc.data_parallel_rank, acc.data_parallel_shard_rank,
                     acc.context_parallel_rank)}
    _reset_port()
    return out


def _job_train(ctx):
    return {name: _train(ctx, name, kw, impl, fsdp) for name, world, kw, impl, fsdp in TRAIN}


def _loader_spec():
    from types import SimpleNamespace

    ids = np.arange(LOADER_ROWS * 2 * 8).reshape(LOADER_ROWS, 16)
    return SimpleNamespace(dataset=ColumnDataset(ids=ids, row=np.arange(LOADER_ROWS)),
                           batch_size=LOADER_BATCH, drop_last=False)


def _job_loader(ctx):
    """The batches a prepared loader and a dispatcher give this process under
    dp_shard=2 × cp=2; and the logits of its slice of the sequence."""
    rank = dist.get_rank()
    out = {}
    pc = ParallelismConfig(dp_shard_size=2, cp_size=2)
    for dispatch in (False, True):
        acc = Accelerator(cpu=True, parallelism_config=pc,
                          dataloader_config=DataLoaderConfiguration(dispatch_batches=dispatch))
        out[dispatch] = [{k: v.numpy() for k, v in b.items()}
                         for b in acc.prepare(_loader_spec())]
        _reset_port()
    for impl in ("ring", "flash"):
        Accelerator(cpu=True, parallelism_config=pc)
        cfg = LlamaConfig.tiny(dtype=torch.float32, attention_impl=impl)
        module = LlamaForCausalLM(cfg)
        module.load_state_dict(llama_params_from_flax(cfg, ctx["flax_params"]))
        x = local_batch(ctx["batches"][0], pc, rank)["x"]
        with torch.no_grad():
            out[impl] = module(torch.from_numpy(x).long()).numpy()
        _reset_port()
    return out


# gather and gather_for_metrics: the sequence layouts each gang runs, and a
# loader of GATHER_ROWS rows of GATHER_SEQ ids in batches of GATHER_BATCH a
# data-parallel process, so that the last global batch is ragged.
GATHER = {2: {"cp2": dict(cp_size=2), "sp2": dict(sp_size=2)},
          4: {"cp4": dict(cp_size=4), "dp_shard2_cp2": dict(dp_shard_size=2, cp_size=2)}}
GATHER_ROWS, GATHER_SEQ, GATHER_BATCH = 7, 8, 2


def _gather_ids():
    return np.arange(GATHER_ROWS * GATHER_SEQ).reshape(GATHER_ROWS, GATHER_SEQ) * 10


def _job_gather(ctx):
    """Each batch of a prepared loader through gather and gather_for_metrics."""
    from types import SimpleNamespace

    out = {}
    for name, kw in GATHER[dist.get_world_size()].items():
        acc = Accelerator(cpu=True, parallelism_config=ParallelismConfig(**kw))
        loader = acc.prepare(SimpleNamespace(
            dataset=ColumnDataset(ids=_gather_ids(), row=np.arange(GATHER_ROWS)),
            batch_size=GATHER_BATCH, drop_last=False))
        got = out[name] = {"gather": [], "metrics": [], "local": []}
        for batch in loader:
            got["local"].append(tuple(batch["ids"].shape))
            got["gather"].append({k: v.numpy() for k, v in acc.gather(batch).items()})
            got["metrics"].append({k: v.numpy()
                                   for k, v in acc.gather_for_metrics(batch).items()})
        _reset_port()
    return out


def _job_telemetry(ctx):
    """Two steps of the tiny Llama's ring under cp=2 (DDP) with telemetry:
    the step records."""
    import json

    from accelerate_tpu_torch import TelemetryKwargs

    rank = dist.get_rank()
    cfg = LlamaConfig.tiny(dtype=torch.float32, attention_impl="ring")
    module = LlamaForCausalLM(cfg)
    module.load_state_dict(llama_params_from_flax(cfg, ctx["flax_params"]))
    pc = ParallelismConfig(cp_size=2)
    acc = Accelerator(cpu=True, parallelism_config=pc, project_dir=ctx["telemetry_dir"],
                      kwargs_handlers=[TelemetryKwargs(log_every=0, straggler_probe_every=1)])
    acc.prepare(Model(module), adamw(LR))
    step = acc.prepare_train_step(_port_loss, max_grad_norm=1.0)
    for i in range(2):
        step(acc.train_state, local_batch(ctx["batches"][i], pc, rank))
    acc.end_training()
    with open(os.path.join(ctx["telemetry_dir"], "telemetry", f"rank_{rank}.jsonl")) as f:
        records = [json.loads(line) for line in f]
    _reset_port()
    return records


def _job_dcp_save(ctx):
    """FSDP2 at this gang's size with DISTRIBUTED_STATE_DICT, saved after step 2."""
    return _dp_train(ctx, "fsdp", save_after=2, project_dir=ctx["dcp_dir"], plugin_kw=DCP)


def _job_dcp_load(ctx):
    return _dp_train(ctx, "fsdp", load_dir=os.path.join(ctx["dcp_dir"], "checkpoints",
                                                        "checkpoint_0"), plugin_kw=DCP)


# cp_generate: each gang's layouts, the prompt (B, S) and new tokens.
CP_GENERATE = {2: {"cp2": dict(cp_size=2)},
               4: {"cp4": dict(cp_size=4), "dp_shard2_cp2": dict(dp_shard_size=2, cp_size=2)}}
CP_PROMPT, CP_NEW = (2, 16), 8
# The chassis knobs the JAX cp_generate skips (layernorm, partial rotary,
# the o_proj bias, Granite's constants), with biases and an ungated MLP.
GRANITE_KNOBS = dict(norm_type="layernorm", attention_bias=True, attention_out_bias=True,
                     mlp_bias=True, mlp_gated=False, partial_rotary_factor=0.5,
                     embedding_multiplier=3.0, residual_multiplier=0.5,
                     attention_multiplier=0.08, logits_scaling=2.0, hidden_act="gelu")


def _granite_weights(cfg) -> dict:
    """Numpy-drawn weights (std 1/sqrt(fan-in); biases of 0.1, norm weights
    around one) that give every knob work."""
    rng = np.random.default_rng(11)
    out = {}
    for name, p in LlamaForCausalLM(cfg, device="meta").state_dict().items():
        if p.dim() == 2:
            a = rng.standard_normal(p.shape) / np.sqrt(p.shape[1])
        else:
            a = rng.standard_normal(p.shape) * 0.1 + (0.0 if name.endswith("bias") else 1.0)
        out[name] = torch.from_numpy(a.astype(np.float32))
    return out


def _job_cp_generate(ctx):
    """cp_generate in each layout of this gang: greedy (and the port's
    generate beside it), EOS at a mid-row token and at the first token,
    two seeded samples, the prefix cache's shape, the refusal of a prompt
    that does not divide, and the Granite config against generate."""
    from accelerate_tpu_torch import cp_generate, generate
    from accelerate_tpu_torch.cp_generation import _prefill
    from accelerate_tpu_torch.generation import _decode_params

    out = {}
    prompt = ctx["cp_prompt"]
    s = prompt.shape[1]
    for name, kw in CP_GENERATE[dist.get_world_size()].items():
        acc = Accelerator(cpu=True, parallelism_config=ParallelismConfig(**kw))
        cfg = LlamaConfig.tiny(dtype=torch.float32)
        module = LlamaForCausalLM(cfg)
        module.load_state_dict(llama_params_from_flax(cfg, ctx["flax_params"]))
        res = {"greedy": cp_generate(module, prompt, CP_NEW).numpy(),
               "generate": generate(module, prompt, CP_NEW).numpy()}
        eos = int(res["generate"][0, s + 2])
        first = int(res["generate"][0, s])
        for key, kwargs in (("eos", dict(eos_token_id=eos, pad_token_id=0)),
                            ("first_eos", dict(eos_token_id=first, pad_token_id=1))):
            res[key] = cp_generate(module, prompt, CP_NEW, **kwargs).numpy()
            res[key + "_generate"] = generate(module, prompt, CP_NEW, **kwargs).numpy()
        res["sampled"] = [cp_generate(module, prompt, CP_NEW, temperature=0.8, top_k=20,
                                      generator=torch.Generator().manual_seed(7)).numpy()
                          for _ in range(2)]
        cp, idx = acc.state.parallelism_config.cp_size, acc.context_parallel_rank
        dp, di = acc.state.data_parallel_size, acc.state.data_parallel_index
        rows = prompt[di * len(prompt) // dp:(di + 1) * len(prompt) // dp]
        chunk = s // cp
        _, pk, _ = _prefill(cfg, _decode_params(module),
                            torch.from_numpy(rows[:, idx * chunk:(idx + 1) * chunk]),
                            acc.state.device_mesh)
        res["prefix_shape"] = tuple(pk.shape)
        try:
            cp_generate(module, prompt[:, :s - 1], 2)
        except ValueError as exc:
            res["refused"] = str(exc)
        gcfg = LlamaConfig.tiny(dtype=torch.float32, **GRANITE_KNOBS)
        granite = LlamaForCausalLM(gcfg)
        granite.load_state_dict(_granite_weights(gcfg))
        res["granite"] = cp_generate(granite, prompt, CP_NEW).numpy()
        res["granite_generate"] = generate(granite, prompt, CP_NEW).numpy()
        out[name] = res
        _reset_port()
    return out


JOBS = {"attention": _job_attention, "cp_generate": _job_cp_generate, "train": _job_train, "loader": _job_loader,
        "gather": _job_gather, "telemetry": _job_telemetry, "dcp_save": _job_dcp_save,
        "dcp_load": _job_dcp_load}


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


def _jax_state(**pc_kwargs):
    from accelerate_tpu import AcceleratorState as JaxState
    from accelerate_tpu import ParallelismConfig as JaxPC

    _jax_reset()
    return JaxState(parallelism_config=JaxPC(**pc_kwargs))


def _jax_attention(x, impl, n, method, causal):
    """The JAX package's attention on the whole sequence over a mesh whose
    cp (or sp) axis is n wide: the output and the gradients of
    sum(out · w)."""
    import jax
    import jax.numpy as jnp

    from accelerate_tpu.ops.flash_attention import auto_flash_attention
    from accelerate_tpu.parallel.cp import ring_attention
    from accelerate_tpu.parallel.sp import ulysses_attention

    kw = dict(sp_size=n) if impl == "ulysses" else dict(cp_size=n)
    mesh = _jax_state(**kw).mesh

    def attend(q, k, v):
        if impl == "ring":
            return ring_attention(q, k, v, causal=causal, mesh=mesh, rotate_method=method)
        if impl == "ulysses":
            return ulysses_attention(q, k, v, causal=causal, mesh=mesh)
        return auto_flash_attention(q, k, v, causal=causal, mesh=mesh)

    @jax.jit
    def forward_and_vjp(q, k, v, w):
        out, vjp = jax.vjp(attend, q, k, v)
        return (out, *vjp(w))

    out, dq, dk, dv = forward_and_vjp(*(jnp.asarray(x[name]) for name in ("q", "k", "v", "w")))
    _jax_reset()
    return {"out": np.asarray(out), "dq": np.asarray(dq), "dk": np.asarray(dk),
            "dv": np.asarray(dv)}


def _jax_train(batches, pc_kwargs, impl, plugin, project_dir=None, save_after=None):
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

    _jax_reset()
    module = JaxLlama(JaxLlamaConfig.tiny(dtype=jnp.float32, attention_impl=impl))
    acc = JaxAccelerator(parallelism_config=JaxPC(**pc_kwargs),
                         fsdp_plugin=JaxPlugin() if plugin else None)
    model = JaxModel.from_flax(module, jax.random.key(0), batches[0]["x"])
    params = jax.tree.map(np.asarray, model.params)
    acc.prepare(model, optax.adamw(LR))

    def loss_fn(p, b):
        return jax_ce(module.apply({"params": p}, b["x"]), b["y"])

    step = acc.prepare_train_step(loss_fn, max_grad_norm=1.0)
    metrics = []
    for b in batches:
        _, m = step(acc.train_state, {k: jnp.asarray(v) for k, v in b.items()})
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    final = jax.tree.map(np.asarray, acc.train_state.params)
    _jax_reset()
    return params, metrics, final


def _jax_logits(flax_params, x):
    import jax.numpy as jnp

    from accelerate_tpu.models import LlamaConfig as JaxLlamaConfig
    from accelerate_tpu.models import LlamaForCausalLM as JaxLlama

    module = JaxLlama(JaxLlamaConfig.tiny(dtype=jnp.float32))
    return np.asarray(module.apply({"params": flax_params}, jnp.asarray(x)))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both gangs' results and the JAX train references."""
    tmp = tmp_path_factory.mktemp("cp")
    batches = _batches()
    ref = {}
    for name, world, kw, impl, fsdp in TRAIN:
        params, ref[name], ref[name + "_params"] = _jax_train(_uneven(batches), kw, impl, fsdp)
    prompt = np.random.default_rng(12).integers(1, 256, CP_PROMPT)
    ctx = {"flax_params": params, "batches": batches, "uneven_batches": _uneven(batches),
           "cp_prompt": prompt,
           "attention": _attention_inputs(), "save_dir": str(tmp / "ring"),
           "telemetry_dir": str(tmp / "telemetry"), "dcp_dir": str(tmp / "dcp2")}
    two = _spawn(tmp, 2, ["attention", "gather", "telemetry", "dcp_save", "cp_generate"], ctx)
    four = _spawn(tmp, 4, ["attention", "train", "loader", "gather", "dcp_load", "cp_generate"],
                  ctx)
    return {"ref": ref, 2: two, 4: four, "ctx": ctx}


# ---------------------------------------------------------------------------
# Tests
# ---------------------------------------------------------------------------


def _seq_cfg(impl, n):
    return ParallelismConfig(sp_size=n) if impl == "ulysses" else ParallelismConfig(cp_size=n)


@pytest.mark.parametrize("case", ATTENTION, ids=[
    f"{impl}{n}-{method or 'a2a'}-{'causal' if c else 'full'}" for impl, n, method, c in ATTENTION])
def test_attention_matches_jax(runs, case):
    """Every process's slice of the output and of dq, dk, dv against the
    JAX package's on the whole sequence, fp32 within 2e-5."""
    impl, n, method, causal = case
    x = runs["ctx"]["attention"]
    want = _jax_attention(x, impl, n, method, causal)
    cfg = _seq_cfg(impl, n)
    for rank, r in enumerate(runs[n]):
        got = r["attention"][case]
        for key, value in local_batch(want, cfg, rank).items():
            np.testing.assert_allclose(got[key], value, rtol=ATOL, atol=ATOL,
                                       err_msg=f"{key} rank {rank}")


@pytest.mark.parametrize("name", [t[0] for t in TRAIN])
def test_train_steps_match_jax(runs, name):
    """Three steps on batches with uneven -100 labels: every process reports
    the JAX step's loss (the token mean of the global batch) and grad norm
    within rtol 1e-4, and holds its parameters after them."""
    for r in runs[4]:
        np.testing.assert_allclose(np.array(r["train"][name]["metrics"]),
                                   np.array(runs["ref"][name]), rtol=1e-4)
    _assert_params_close(_flax(runs[4][0]["train"][name]["params"]), runs["ref"][name + "_params"],
                         runs["ctx"]["flax_params"])
    for r in runs[4][1:]:
        for key, value in r["train"][name]["params"].items():
            np.testing.assert_array_equal(value, runs[4][0]["train"][name]["params"][key])


def test_sharding_and_ranks_of_the_train_runs(runs):
    """FSDP2 shards the ring and Ulysses runs and DDP wraps the allgather
    run; each process's mesh coordinates are row-major over (dp_replicate,
    dp_shard, cp)."""
    for rank, r in enumerate(runs[4]):
        t = r["train"]
        assert t["dp_shard2_cp2_ring"]["sharded"] and t["dp_shard2_sp2_ulysses"]["sharded"]
        assert t["cp4_allgather_ddp"]["ddp"]
        assert t["dp_shard2_cp2_ring"]["ranks"] == (0, rank // 2, rank % 2)
        assert t["cp4_allgather_ddp"]["ranks"] == (0, 0, rank)


def test_remat_flash_keeps_each_ring_chunk(runs):
    """Under remat "flash" each of the 2 layers runs its forward kernel once
    per ring step (cp=2) a train step, and the recompute none."""
    for r in runs[4]:
        assert r["train"]["dp_shard2_cp2_ring"]["fwd_calls_per_step"] == 2 * 2


def test_cp_checkpoint_resumes_in_one_process_and_in_jax(runs):
    """The checkpoint the dp_shard=2 × cp=2 ring run saved after step 2:
    one process resumes it and takes step 3 with the ring's numbers, and
    the JAX package reads exactly the parameters it held."""
    from accelerate_tpu.utils import other as jax_other
    from test_torch_distributed import _assert_trees_close

    ring = runs[4][0]["train"]["dp_shard2_cp2_ring"]
    ckpt = os.path.join(runs["ctx"]["save_dir"], "checkpoints", "checkpoint_0")
    tree = jax_other.unflatten_state_dict(jax_other.load_sharded_safetensors(ckpt))
    _assert_trees_close(tree, _flax(ring["params_at_save"]), rtol=0, atol=0)
    cfg = LlamaConfig.tiny(dtype=torch.float32)
    module = LlamaForCausalLM(cfg)
    acc = Accelerator(cpu=True)
    acc.prepare(Model(module), adamw(LR))
    step = acc.prepare_train_step(_port_loss, max_grad_norm=1.0)
    acc.load_state(ckpt)
    assert acc.train_state.step == 2
    _, m = step(acc.train_state, runs["ctx"]["uneven_batches"][2])
    np.testing.assert_allclose([float(m["loss"]), float(m["grad_norm"])], ring["metrics"][2],
                               rtol=1e-4)
    _assert_params_close(_flax({n: p.detach().numpy() for n, p in module.named_parameters()}),
                         _flax(ring["params"]), runs["ctx"]["flax_params"])


@pytest.mark.parametrize("dispatch", [False, True], ids=["shard", "dispatch"])
def test_loader_slices_follow_batch_partition_spec(runs, dispatch):
    """Each process's batches from a prepared loader (and from the
    dispatcher) under dp_shard=2 × cp=2 are its device's shard of the
    global batch laid out by the JAX package's batch_partition_spec."""
    import jax
    from jax.sharding import NamedSharding

    from accelerate_tpu import ParallelismConfig as JaxPC
    from accelerate_tpu.parallel.sharding import batch_partition_spec

    pc = JaxPC(dp_shard_size=2, cp_size=2)
    mesh = pc.build_mesh(jax.devices()[:4])
    spec = _loader_spec()
    global_batches = [spec.dataset.gather_batch(np.arange(i, i + 2 * LOADER_BATCH))
                      for i in range(0, LOADER_ROWS, 2 * LOADER_BATCH)]
    devices = list(mesh.devices.flat)
    for rank, r in enumerate(runs[4]):
        got = r["loader"][dispatch]
        assert len(got) == len(global_batches)
        for g, whole in zip(got, global_batches):
            for key, value in whole.items():
                arr = jax.device_put(value, NamedSharding(mesh, batch_partition_spec(
                    value.ndim, pc)))
                shard = next(s for s in arr.addressable_shards if s.device == devices[rank])
                np.testing.assert_array_equal(g[key], np.asarray(shard.data), err_msg=key)


@pytest.mark.parametrize("impl", ["ring", "flash"])
def test_each_slice_of_the_sequence_sees_its_global_positions(runs, impl):
    """The logits of each process's slice of the sequence (RoPE at its
    global positions, attention over the whole sequence) are the JAX
    model's on the whole sequence, sliced."""
    ctx = runs["ctx"]
    want = _jax_logits(ctx["flax_params"], ctx["batches"][0]["x"])
    pc = ParallelismConfig(dp_shard_size=2, cp_size=2)
    for rank, r in enumerate(runs[4]):
        np.testing.assert_allclose(r["loader"][impl], local_batch({"l": want}, pc, rank)["l"],
                                   rtol=1e-4, atol=1e-5)


def test_sequence_slice_must_divide():
    pc = ParallelismConfig(cp_size=2, dp_shard_size=1)
    with pytest.raises(ValueError, match="does not divide"):
        local_batch({"x": np.zeros((2, 5))}, pc, 0)
    with pytest.raises(ValueError, match="does not divide"):
        local_batch({"x": np.zeros((3, 4))}, ParallelismConfig(dp_shard_size=2), 0)
    got = local_batch({"x": np.arange(16).reshape(2, 8), "n": np.arange(2)}, pc, 1)
    np.testing.assert_array_equal(got["x"], [[4, 5, 6, 7], [12, 13, 14, 15]])
    np.testing.assert_array_equal(got["n"], [0, 1])


# ---------------------------------------------------------------------------
# gather under cp/sp, telemetry under cp, DCP from 2 processes to 4
# ---------------------------------------------------------------------------


def _jax_gathered(dp):
    """The JAX package's gather and gather_for_metrics of each global batch
    of the loader (its rows dealt by its BatchSamplerShard at ``dp``
    data-parallel processes, even_batches), with the last batch's
    remainder; a global batch is one array there, so its gather is the
    batch's rows at full length."""
    from types import SimpleNamespace

    import accelerate_tpu.data_loader as jdl
    from accelerate_tpu import Accelerator as JaxAccelerator
    from accelerate_tpu.utils.operations import gather as jax_gather

    shards = [list(jdl.BatchSamplerShard(
        jdl.BatchSampler(jdl.SequentialSampler(GATHER_ROWS), batch_size=GATHER_BATCH),
        num_processes=dp, process_index=d)) for d in range(dp)]
    ids, out = _gather_ids(), {"gather": [], "metrics": []}
    for k in range(len(shards[0])):
        rows = np.concatenate([shards[d][k] for d in range(dp)])
        batch = {"ids": ids[rows], "row": rows}
        last = k == len(shards[0]) - 1
        stub = SimpleNamespace(gather=jax_gather, gradient_state=SimpleNamespace(
            end_of_dataloader=last,
            remainder=GATHER_ROWS % (GATHER_BATCH * dp) if last else -1))
        out["gather"].append(jax_gather(batch))
        out["metrics"].append(JaxAccelerator.gather_for_metrics(stub, batch))
    return out


GATHER_CASES = [(world, name) for world in (2, 4) for name in GATHER[world]]


@pytest.mark.parametrize("world,name", GATHER_CASES, ids=[c[1] for c in GATHER_CASES])
def test_gather_for_metrics_under_cp_and_sp_matches_jax(runs, world, name):
    """Each process holds a slice of the sequence; gather returns the global
    batch's rows at full length and gather_for_metrics drops the repeated
    rows of the ragged last batch: exactly the JAX package's values, on
    every process, and every row once."""
    pc = ParallelismConfig(**GATHER[world][name]).infer_missing_axis(world)
    want = _jax_gathered(pc.dp_size)
    for r in runs[world]:
        got = r["gather"][name]
        assert got["local"][0] == (GATHER_BATCH, GATHER_SEQ // pc.seq_size)
        for key in ("gather", "metrics"):
            assert len(got[key]) == len(want[key])
            for g, w in zip(got[key], want[key]):
                assert g.keys() == w.keys()
                for k in w:
                    np.testing.assert_array_equal(g[k], w[k], err_msg=f"{key} {k}")
        rows = np.concatenate([m["row"] for m in got["metrics"]])
        np.testing.assert_array_equal(rows, np.arange(GATHER_ROWS))


def test_telemetry_counts_the_global_batch_under_cp(runs):
    """Under cp=2 each process's step holds half of each sequence; its
    records count the global batch (samples, tokens_per_s × wall_s) as the
    JAX package's _batch_counts of the global batch, and the straggler
    probe has both processes' times."""
    from accelerate_tpu.telemetry import _batch_counts as jax_batch_counts

    want = [jax_batch_counts(b) for b in _batches()[:2]]
    for rank, records in enumerate(r["telemetry"] for r in runs[2]):
        steps = [x for x in records if x["event"] == "step"]
        assert len(steps) == 2
        for s, (samples, tokens) in zip(steps, want):
            assert s["samples"] == samples
            assert s["tokens_per_s"] * s["wall_s"] == pytest.approx(tokens, rel=1e-9)
        probes = [x for x in records if x["event"] == "straggler_probe"]
        assert [len(p["rank_times_s"]) for p in probes] == [2, 2]


def test_dcp_saved_at_world2_loads_at_world4(runs):
    """The DCP checkpoint 2 FSDP2 processes saved after step 2, loaded by 4:
    every parameter, moment, count and step equal, and step 3 the
    uninterrupted run's (rtol 1e-5)."""
    saved = runs[2][0]["dcp_save"]
    for r in runs[4]:
        loaded = r["dcp_load"]
        _assert_states_equal(loaded["state_at_load"], saved["state_at_save"])
        np.testing.assert_allclose(loaded["metrics"], saved["metrics"][2:], rtol=1e-5)


# ---------------------------------------------------------------------------
# cp_generate
# ---------------------------------------------------------------------------

CP_CASES = [(world, name) for world, layouts in CP_GENERATE.items() for name in layouts]


def _jax_cp_generate(flax_params, prompt, cp):
    """The JAX package's greedy cp_generate on the forced 8-device host,
    cp ranks times 8 / cp data-parallel ones."""
    import jax.numpy as jnp

    from accelerate_tpu import Model as JaxModel
    from accelerate_tpu.cp_generation import cp_generate as jax_cp_generate
    from accelerate_tpu.models import LlamaConfig as JaxLlamaConfig
    from accelerate_tpu.models import LlamaForCausalLM as JaxLlama

    mesh = _jax_state(cp_size=cp, dp_shard_size=8 // cp).mesh
    model = JaxModel(module=JaxLlama(JaxLlamaConfig.tiny(dtype=jnp.float32)), params=flax_params)
    out = np.asarray(jax_cp_generate(model, prompt, CP_NEW, mesh=mesh))
    _jax_reset()
    return out


@pytest.mark.parametrize("cp", [2, 4])
def test_cp_generate_greedy_matches_jax_and_generate(runs, cp):
    """Greedy tokens of every layout with this cp size, on every process:
    the JAX cp_generate's and the port's generate's, with every step's
    top-2 logit gap above 1e-4 (equal tokens are not luck at a near-tie)."""
    from accelerate_tpu_torch import generation as gen

    prompt = runs["ctx"]["cp_prompt"]
    want = _jax_cp_generate(runs["ctx"]["flax_params"], prompt, cp)
    cfg = LlamaConfig.tiny(dtype=torch.float32)
    module = LlamaForCausalLM(cfg)
    module.load_state_dict(llama_params_from_flax(cfg, runs["ctx"]["flax_params"]))
    rows = torch.from_numpy(np.array(want)).long()
    logits, _ = gen._llama_forward_cached(cfg, module, rows, gen.init_cache(cfg, *rows.shape),
                                          return_all=True)
    top2 = torch.topk(logits[:, prompt.shape[1] - 1:-1], 2, dim=-1).values
    assert float((top2[..., 0] - top2[..., 1]).min()) > 1e-4
    for world, name in CP_CASES:
        if CP_GENERATE[world][name]["cp_size"] != cp:
            continue
        for r in runs[world]:
            np.testing.assert_array_equal(r["cp_generate"][name]["greedy"], want, err_msg=name)
            np.testing.assert_array_equal(r["cp_generate"][name]["generate"], want)


@pytest.mark.parametrize("world,name", CP_CASES, ids=[c[1] for c in CP_CASES])
def test_cp_generate_eos_sampling_and_cache(runs, world, name):
    """EOS at a mid-row token and at the first new token pad as generate
    pads them; two samples from one seed are equal, on every process; the
    prefix cache holds this process's rows and S/cp positions of each of
    the 2 layers' 2 KV heads; a prompt that does not divide by cp raises;
    the Granite config's tokens are generate's."""
    cp = CP_GENERATE[world][name]["cp_size"]
    rows = CP_PROMPT[0] // (world // cp)
    first = runs[world][0]["cp_generate"][name]
    for r in runs[world]:
        res = r["cp_generate"][name]
        for key in ("eos", "first_eos", "granite"):
            np.testing.assert_array_equal(res[key], res[key + "_generate"], err_msg=key)
        np.testing.assert_array_equal(res["sampled"][0], res["sampled"][1])
        np.testing.assert_array_equal(res["sampled"][0], first["sampled"][0])
        assert res["prefix_shape"] == (2, rows, CP_PROMPT[1] // cp, 2, 32)
        assert f"must divide by cp={cp}" in res["refused"]
    s = CP_PROMPT[1]
    assert (first["first_eos"][0, s + 1:] == 1).all()
    eos_row = first["eos"][0, s:]
    assert (eos_row[3:] == 0).all() and eos_row[2] == first["generate"][0, s + 2]
    assert not np.array_equal(first["granite"], first["sampled"][0])
