"""The port's data parallelism (FSDP2, DDP and HSDP over torch.distributed)
against the JAX package's ``dp_shard``/``dp_replicate`` meshes.

Two gangs of gloo processes run on the CPU, started with
``torch.multiprocessing`` (spawn) and meeting through a ``file://``
rendezvous under the test's temporary directory, so that no port is
contended: one of 2 processes and one of 4. Each process runs a list of
jobs and process 0 pickles everyone's results; the tests compare them with
the JAX Accelerator run in this process on its virtual CPU devices
(``tests/conftest.py``), on the same global batches made with numpy from a
seed, from the same flax-initialised tiny Llama (fp32):

- three steps of FSDP2 at 2 and 4 processes, DDP at 2, and HSDP at 2 × 2:
  losses and grad norms within rtol 1e-4, and the parameters after them;
- three steps of FSDP2 at 2 processes on batches whose ``-100`` labels
  fall unevenly over the processes: the loss is the token mean of the
  global batch, as the JAX step's, with ``cross_entropy_loss`` and with
  ``fused_cross_entropy_loss``;
- the collectives of ``utils/operations.py`` against the JAX package's
  own functions, run here with its process count and all-gather replaced
  by the gang's per-process inputs;
- the dispatcher's batches against the JAX ``DataLoaderDispatcher`` run
  the same way, and synchronised RNG states;
- a checkpoint written by 4 FSDP2 processes resumed in one process and
  read by the JAX package, and a JAX checkpoint saved under ``dp_shard=4``
  resumed by 2 FSDP2 processes;
- the imperative loop (``accumulate``/``backward``/``optimizer.step()``) at
  two microbatches a step under FSDP2 and DDP at 2 processes and HSDP at
  2 × 2 against the port's fused step on the same batches, with the
  gradient collectives skipped on the microbatch that does not end the
  window (and run on each with ``sync_each_batch``); triggers,
  ``split_between_processes``, ``main_process_first`` and
  ``gather_for_metrics`` inside an accumulation window across the ranks;
- step telemetry at 2 processes: the straggler probe's gather of every
  process's step time, and ``collective_counters`` counting each
  collective of a step and of ``utils/operations.py``;
- fp16 with loss scaling under FSDP2 at 2 processes, fused and as the
  imperative loop: a step whose gradients overflow on process 1's shard
  only is skipped by both processes (the finite flag's MIN over the
  group), with every shard, moment and count unchanged;
- every ``sharding_strategy`` (``SHARD_GRAD_OP`` at 2 and 4 processes,
  ``NO_SHARD``, ``HYBRID_SHARD`` at 2 × 2), ``min_weight_size_to_shard``
  and ``DeepSpeedPlugin`` stages 0-3 against the JAX package's runs of the
  same plugin, and which parameters FSDP2 shards against the JAX plan;
  ``DistributedDataParallelKwargs`` reaching DDP;
- ``DISTRIBUTED_STATE_DICT`` (torch.distributed.checkpoint): saved by 4
  FSDP2 processes, loaded by 2 and by one (resharded, every tensor equal,
  the next step the uninterrupted run's), and ``save_state(block=False)``
  with steps taken while it persists and a second save queued behind it.
  (The 4-process gang runs first; a save at 2 loaded at 4 is in
  ``tests/test_torch_context_parallel.py``.)
- the Mixtral family under FSDP2 at 2 processes, capacity factor 0.5:
  capacity, slot positions and the aux loss over the global batch, so
  that losses, aux losses, grad norms and drop counts are the JAX
  package's on the whole batch;
- ResNet's BatchNorm at 2 processes under DDP (three SGD steps) and FSDP2
  (one AdamW step) with ``prepare_train_step(mutable_state=True)``: the
  batch statistics of the global batch (sync-BN), so that the running
  statistics, losses and grad norms are the JAX step's on the whole batch;
- FSDP2's units at 2 processes: one on every block of every family
  (ROADMAP.md fault 7; GPT-2's and T5's steps under them keep the
  one-process numbers), and ``activation_checkpointing`` under
  ``NO_SHARD`` (DDP) turning the model's remat on as the JAX package does
  (fault 6);
- ``verify_operation`` in debug mode at 2 processes (a collective whose
  shapes differ on process 1 raises on both; equal shapes pass), and
  ``utils.other``'s ``wait_for_everyone`` and
  ``extract_model_from_parallel`` of a DDP-wrapped module.

The spawned processes import this module: JAX is imported only inside the
functions that compute the references.
"""

from __future__ import annotations

import importlib.util
import os
import pickle
import random
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from accelerate_tpu_torch import (
    Accelerator,
    DeepSpeedPlugin,
    DistributedDataParallelKwargs,
    FullyShardedDataParallelPlugin,
    GradientAccumulationPlugin,
    GradScalerKwargs,
    Model,
    ParallelismConfig,
    ProjectConfiguration,
    adamw,
)
from accelerate_tpu_torch import models as port_models
from accelerate_tpu_torch.models import (
    LlamaConfig,
    LlamaForCausalLM,
    ResNet,
    ResNetConfig,
    cross_entropy_loss,
    fused_cross_entropy_loss,
    llama_params_from_flax,
    llama_params_to_flax,
    resnet_loss,
    resnet_params_to_flax,
)
from accelerate_tpu_torch.accelerator import _microbatch_split
from accelerate_tpu_torch.parallel.fsdp import decoder_blocks
from accelerate_tpu_torch.state import AcceleratorState, GradientState, PartialState
from accelerate_tpu_torch.train_state import tree_items
from accelerate_tpu_torch.utils import operations


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the driver runs several test processes at once,
    and torch's spinning thread pools would contend for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


SEQ, GLOBAL_BATCH, STEPS, LR = 16, 8, 3, 1e-3
# Per-process inputs of the collectives: rank r holds (r + 1) rows, so that
# pad_across_processes has work to do.
COLLECTIVE_ROWS = 3
# Parameters after AdamW steps: see _assert_params_close.
PARAM_ATOL, UPDATE_RTOL, OUTLIER_SHARE = 1e-4, 1e-2, 1e-4


def _batches(n=STEPS, bs=GLOBAL_BATCH, seq=SEQ, vocab=256):
    rng = np.random.default_rng(0)
    out = []
    for _ in range(n):
        ids = rng.integers(0, vocab, size=(bs, seq + 1), dtype=np.int32)
        out.append({"x": ids[:, :-1], "y": ids[:, 1:]})
    return out


def _uneven(batches):
    """The batches with labels of -100 that fall unevenly over 2 processes:
    most of the second half of the rows, and the tail of every sequence."""
    out = []
    for b in batches:
        y = b["y"].copy()
        y[GLOBAL_BATCH // 2:, 3:] = -100
        y[:, -5:] = -100
        out.append({"x": b["x"], "y": y})
    return out


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


def _local(batch, rank, world):
    n = GLOBAL_BATCH // world
    return {k: v[rank * n:(rank + 1) * n] for k, v in batch.items()}


def _port_loss(model, b):
    return cross_entropy_loss(model(b["x"].long()), b["y"].long())


# FSDP plugin fields that map onto FSDP2, each set alone: the numbers must
# stay those of the default plugin.
PLUGIN_OPTIONS = {
    "ignored_norms": dict(ignored_params=[r"norm\.weight$"]),
    "activation_checkpointing": dict(activation_checkpointing=True),
    "no_reshard_after_forward": dict(reshard_after_forward=False),
    "cpu_offload": dict(cpu_offload=True),
}


def _port_accelerator(kind, plugin_kw=None, **kw):
    if kind == "ddp":
        return Accelerator(cpu=True, **kw)
    if kind == "ds":
        return Accelerator(cpu=True, deepspeed_plugin=DeepSpeedPlugin(**plugin_kw), **kw)
    pc = ParallelismConfig(dp_replicate_size=2, dp_shard_size=2) if kind == "hsdp" else None
    return Accelerator(cpu=True, fsdp_plugin=FullyShardedDataParallelPlugin(**plugin_kw or {}),
                       parallelism_config=pc, **kw)


def _whole(t):
    return (t.full_tensor() if hasattr(t, "full_tensor") else t).detach().numpy().copy()


def _whole_params(model) -> dict:
    return {n: _whole(p) for n, p in model.module.named_parameters()}


def _whole_state(acc) -> dict:
    """Whole parameters, AdamW moments, count and step of the train state."""
    st = acc.train_state
    return {"params": _whole_params(st.model),
            "moments": {n: {k: _whole(st.optimizer.state[p][k]) for k in ("exp_avg",
                                                                          "exp_avg_sq")}
                        for n, p in st.model.module.named_parameters()},
            "count": st.optimizer.count, "step": int(st.step)}


def _dtensors(model) -> list:
    from torch.distributed.tensor import DTensor

    return sorted(n for n, p in model.module.named_parameters() if isinstance(p, DTensor))


DCP = {"state_dict_type": "DISTRIBUTED_STATE_DICT"}


def _train(ctx, kind, steps=STEPS, save_after=None, load_dir=None, project_dir=None,
           plugin_kw=None, ga=1, batches="batches", acc_kw=None, loss_fn=_port_loss):
    """``steps`` steps of the tiny Llama from ctx's flax weights on this
    process's share of each global batch: (loss, grad norm) per step and
    the whole parameters after them; the whole train state at the save and
    after the load."""
    rank, world = dist.get_rank(), dist.get_world_size()
    cfg = LlamaConfig.tiny(dtype=torch.float32)
    module = LlamaForCausalLM(cfg)
    module.load_state_dict(llama_params_from_flax(cfg, ctx["flax_params"]))
    acc = _port_accelerator(kind, plugin_kw, gradient_accumulation_steps=ga,
                            project_config=ProjectConfiguration(
                                project_dir=project_dir,
                                automatic_checkpoint_naming=project_dir is not None),
                            **acc_kw or {})
    model, opt = acc.prepare(Model(module), adamw(LR))
    step = acc.prepare_train_step(loss_fn, max_grad_norm=1.0)
    first, loaded = 0, None
    if load_dir is not None:
        acc.load_state(load_dir)
        first = acc.train_state.step
        loaded = _whole_state(acc)
    metrics, saved = [], None
    for i in range(first, steps):
        _, m = step(acc.train_state, _local(ctx[batches][i], rank, world))
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
        if save_after is not None and i + 1 == save_after:
            acc.save_state()
            saved = _whole_state(acc)
    out = {"metrics": metrics, "params": _whole_params(model),
           "params_at_save": saved and saved["params"], "state_at_save": saved,
           "state_at_load": loaded,
           "sharded": model.sharded, "ddp": model.forward_module is not model.module,
           "fused": opt.param_groups[0].get("fused"), "step": acc.train_state.step,
           "remat": model.module.config.remat, "ignored": sorted(model.ignored), "dtensors": _dtensors(model),
           "format": acc.checkpoint_stats and acc.checkpoint_stats["format"]}
    _reset_port()
    return out


def _job_collectives(ctx):
    rank, world = dist.get_rank(), dist.get_world_size()
    acc = Accelerator(cpu=True)
    x = torch.arange((rank + 1) * COLLECTIVE_ROWS, dtype=torch.float32).reshape(rank + 1, -1)
    x = x + 100 * rank
    padded = acc.pad_across_processes(x, pad_index=-1)
    padded_first = operations.pad_across_processes(x.numpy(), pad_index=-2, pad_first=True)
    out = {
        "pad": padded.numpy(), "pad_first": padded_first,
        "gather": acc.gather(padded).numpy(),
        "gather_tree": operations.gather({"a": torch.full((2,), float(rank)),
                                          "b": [np.full((1, 2), rank, np.int64)]}),
        "gather_object": operations.gather_object({"rank": rank}),
        "gather_object_list": operations.gather_object([rank, rank * 10]),
        "reduce_sum": acc.reduce(torch.tensor([rank + 1.0, 2.0])).numpy(),
        "reduce_mean": operations.reduce(np.array([rank + 1.0, 2.0]), "mean", scale=2.0),
        "broadcast": operations.broadcast(torch.full((3,), float(rank)), from_process=world - 1
                                          ).numpy(),
        "broadcast_object_list": operations.broadcast_object_list(
            [f"from {rank}", {"r": rank}], from_process=1),
        "pad_input": operations.pad_input_tensors(torch.arange(world + 1), world + 1, world
                                                  ).numpy(),
    }
    # Attention over the data-parallel mesh: each process on its own shard.
    from accelerate_tpu_torch.ops import auto_flash_attention, flash_attention

    q, k, v = (torch.from_numpy(np.random.default_rng(rank).standard_normal(
        (1, 32, 4, 16), dtype=np.float32)) for _ in range(3))
    mesh = AcceleratorState().device_mesh
    out["mesh"] = (list(mesh.mesh_dim_names), list(mesh.shape))
    out["auto_flash_equal"] = torch.equal(auto_flash_attention(q, k, v, mesh=mesh),
                                          flash_attention(q, k, v))
    _reset_port()
    return out


def _sharded(params) -> list:
    from torch.distributed.tensor import DTensor

    return [p for p in params if isinstance(p, DTensor)]


class _Spec:
    """What a user hands prepare() as a loader: a dataset and a batch size."""

    def __init__(self, dataset, batch_size):
        self.dataset, self.batch_size, self.drop_last = dataset, batch_size, False


def _dispatch_dataset():
    from accelerate_tpu_torch import ColumnDataset

    rng = np.random.default_rng(3)
    return ColumnDataset(x=rng.standard_normal((22, 3)).astype(np.float32),
                         idx=np.arange(22))


def _job_dispatcher(ctx):
    from accelerate_tpu_torch import DataLoaderConfiguration

    out = {}
    for split in (False, True):
        acc = Accelerator(cpu=True, dataloader_config=DataLoaderConfiguration(
            dispatch_batches=True, split_batches=split, dispatch_group_size=2))
        loader = acc.prepare(_Spec(_dispatch_dataset(), 4))
        out[split] = {"len": len(loader),
                      "batches": [{k: v.numpy() for k, v in b.items()} for b in loader]}
        _reset_port()
    return out


def _job_rng(ctx):
    from accelerate_tpu_torch.utils.random import synchronize_rng_states

    rank = dist.get_rank()
    PartialState(cpu=True)
    gen = torch.Generator().manual_seed(1000 + rank)
    torch.manual_seed(rank)
    np.random.seed(rank)
    random.seed(rank)
    before = float(torch.rand(()))
    synchronize_rng_states(["torch", "numpy", "python", "generator"], generator=gen)
    draws = (torch.rand(3).tolist(), np.random.rand(3).tolist(), random.random(),
             torch.rand(2, generator=gen).tolist())
    _reset_port()
    return {"before": before, "draws": draws}


def _job_fsdp(ctx):
    return _train(ctx, "fsdp")


def _job_ddp(ctx):
    return _train(ctx, "ddp")


def _job_hsdp(ctx):
    return _train(ctx, "hsdp")


def _job_per_node(ctx):
    """One FSDP2 step, saved into a directory of this process's own (a node's
    local disk) with and without save_on_each_node; LOCAL_RANK=0 makes each
    process a node of its own. The files each wrote."""
    rank = dist.get_rank()
    listing = {}
    for per_node in (False, True):
        os.environ["LOCAL_RANK"] = "0" if per_node else str(rank)
        cfg = LlamaConfig.tiny(dtype=torch.float32)
        module = LlamaForCausalLM(cfg)
        module.load_state_dict(llama_params_from_flax(cfg, ctx["flax_params"]))
        node_dir = os.path.join(ctx["per_node_dir"], f"{per_node}", f"node{rank}")
        acc = Accelerator(cpu=True, fsdp_plugin=FullyShardedDataParallelPlugin(),
                          project_config=ProjectConfiguration(
                              project_dir=node_dir, automatic_checkpoint_naming=True,
                              save_on_each_node=per_node))
        acc.prepare(Model(module), adamw(LR))
        step = acc.prepare_train_step(_port_loss, max_grad_norm=1.0)
        step(acc.train_state, _local(ctx["batches"][0], rank, dist.get_world_size()))
        out = acc.save_state()
        listing[per_node] = {"local": acc.local_process_index, "files": sorted(os.listdir(out))}
        _reset_port()
    del os.environ["LOCAL_RANK"]
    return listing


def _job_options(ctx):
    return {name: _train(ctx, "fsdp", plugin_kw=kw) for name, kw in PLUGIN_OPTIONS.items()}


def _job_fsdp_ga2(ctx):
    return _train(ctx, "fsdp", ga=2)


def _job_fsdp_uneven(ctx):
    return _train(ctx, "fsdp", batches="uneven_batches")


def _job_fused_ce(ctx):
    return _train(ctx, "fsdp", batches="uneven_batches", loss_fn=lambda m, b: (
        fused_cross_entropy_loss(m, b["x"].long(), b["y"].long(), chunk_size=4)))


def _job_save(ctx):
    """FSDP2 for STEPS - 1 steps with a checkpoint after the second, then one
    more step: the checkpoint and the step it resumes into."""
    return _train(ctx, "fsdp", save_after=2, project_dir=ctx["save_dir"])


def _job_resume_jax(ctx):
    """FSDP2 resuming the JAX package's dp_shard=4 checkpoint, then the
    steps after it."""
    return _train(ctx, "fsdp", load_dir=ctx["jax_ckpt"])


def _reduces_gradients(model) -> bool:
    """Whether every FSDP2 parameter group of the model reduces its
    gradients (``set_requires_gradient_sync``)."""
    from torch.distributed.fsdp import FSDPModule

    return all(group.reduce_grads for m in model.module.modules() if isinstance(m, FSDPModule)
               for group in m._get_fsdp_state()._fsdp_param_groups)


def _imperative(ctx, kind, ga=2, sync_each_batch=False):
    """The imperative loop over the same STEPS global batches as ``_train``
    (each process its share, split into ``ga`` microbatches as the fused
    step splits it): (window loss, grad norm) per step, the parameters
    after, and a probe of the window's first microbatch: what
    ``clip_grad_norm_`` returned, whether FSDP2 reduced gradients during
    its backward, whether the sharded parameters had a ``grad`` after it,
    and the sum of this process's first gradient."""
    rank, world = dist.get_rank(), dist.get_world_size()
    cfg = LlamaConfig.tiny(dtype=torch.float32)
    module = LlamaForCausalLM(cfg)
    module.load_state_dict(llama_params_from_flax(cfg, ctx["flax_params"]))
    acc = _port_accelerator(kind, gradient_accumulation_plugin=GradientAccumulationPlugin(
        num_steps=ga, sync_each_batch=sync_each_batch))
    model, opt = acc.prepare(Model(module), adamw(LR))
    metrics, probe, flags = [], {}, []

    def loss_fn(m, b):
        if model.sharded and not probe:
            probe["reduces_gradients"] = _reduces_gradients(model)
        return _port_loss(m, b)

    for i in range(STEPS):
        local = {k: torch.from_numpy(v) for k, v in _local(ctx["batches"][i], rank, world).items()}
        losses = []
        for mb in _microbatch_split(local, ga):
            with acc.accumulate(model):
                losses.append(acc.backward(loss_fn, mb))
                norm = acc.clip_grad_norm_(None, 1.0)
                flags.append(acc.sync_gradients)
                if "norm" not in probe:
                    probe["norm"] = None if norm is None else float(norm)
                    # FSDP2's sharded parameters (the whole ones get their
                    # process's own gradients from autograd); DDP's all.
                    params = list(model.parameters())
                    grads = [p.grad for p in (_sharded(params) or params)]
                    probe["grads_kept_back"] = all(g is None for g in grads)
                    probe["first_grad_sum"] = (None if grads[0] is None else float(
                        (grads[0].to_local() if hasattr(grads[0], "to_local")
                         else grads[0]).double().sum()))
                opt.step()
                opt.zero_grad()
        metrics.append((float(sum(losses) / ga), float(norm)))
    out = {"metrics": metrics, "params": _whole_params(model), "probe": probe, "flags": flags,
           "step": acc.train_state.step, "grad_after_step": [p.grad for p in
                                                             model.parameters()] == [None] * len(
                                                                 list(model.parameters()))}
    _reset_port()
    return out


def _job_imperative(ctx):
    """FSDP2 and DDP at 2 processes: the fused step and the imperative loop
    at ga 2, and the loop with sync_each_batch."""
    return {kind: {"fused": _train(ctx, kind, ga=2), "loop": _imperative(ctx, kind),
                   "each_batch": _imperative(ctx, kind, sync_each_batch=True)}
            for kind in ("fsdp", "ddp")}


def _job_imperative_hsdp(ctx):
    return {"hsdp": {"fused": _train(ctx, "hsdp", ga=2), "loop": _imperative(ctx, "hsdp")}}


def _job_surface(ctx):
    """Triggers, split_between_processes, main_process_first and
    gather_for_metrics inside an accumulation window, on every rank."""
    from accelerate_tpu_torch import ColumnDataset

    rank, world = dist.get_rank(), dist.get_world_size()
    acc = Accelerator(cpu=True, gradient_accumulation_steps=2)
    out = {"triggers": []}
    for raiser in (None, world - 1):
        if rank == raiser:
            acc.set_trigger()
        out["triggers"].append(acc.check_trigger())
    out["triggers"].append(acc.check_trigger())  # lowered after it was seen
    items = list(range(5))
    for padding in (False, True):
        with acc.split_between_processes(items, apply_padding=padding) as share:
            out[f"list_{padding}"] = share
        with acc.split_between_processes({"a": torch.arange(5), "b": np.arange(5) * 10},
                                         apply_padding=padding) as share:
            out[f"dict_{padding}"] = {k: np.asarray(v).tolist() for k, v in share.items()}
    log = os.path.join(ctx["surface_dir"], f"order{world}.txt")
    with acc.main_process_first():
        with open(log, "a") as f:
            f.write(f"{rank}\n")
    acc.wait_for_everyone()
    with open(log) as f:
        out["first"] = f.read().split()

    model, opt, loader = acc.prepare(
        Model(torch.nn.Linear(2, 1)), adamw(LR),
        _Spec(ColumnDataset(x=np.ones((7, 2), np.float32), idx=np.arange(7)), 2))
    out["gathered"], out["sync"] = [], []
    for batch in loader:
        with acc.accumulate(model):
            acc.backward(lambda m, b: m(b["x"]).sum(), batch)
            out["gathered"].extend(acc.gather_for_metrics(batch["idx"]).tolist())
            out["sync"].append(acc.sync_gradients)
            opt.step()
            opt.zero_grad()
    out["opt_steps"] = acc.train_state.step
    _reset_port()
    return out


def _job_telemetry(ctx):
    """Step telemetry over the gang: two FSDP2 steps with the straggler
    probe on every step, the collective counters read around each step,
    then each collective of ``utils/operations.py`` once."""
    import json

    from accelerate_tpu_torch.utils import TelemetryKwargs
    from accelerate_tpu_torch.utils.operations import collective_counters

    rank, world = dist.get_rank(), dist.get_world_size()
    cfg = LlamaConfig.tiny(dtype=torch.float32)
    module = LlamaForCausalLM(cfg)
    module.load_state_dict(llama_params_from_flax(cfg, ctx["flax_params"]))
    acc = _port_accelerator("fsdp", project_dir=ctx["telemetry_dir"], kwargs_handlers=[
        TelemetryKwargs(straggler_probe_every=1, log_every=0, profile=True)])
    acc.prepare(Model(module), adamw(LR))
    step = acc.prepare_train_step(_port_loss, max_grad_norm=1.0)
    per_step = []
    for i in range(2):
        before = collective_counters.snapshot()
        step(acc.train_state, _local(ctx["batches"][i], rank, world))
        after = collective_counters.snapshot()
        per_step.append({op: {k: v[k] - before.get(op, {}).get(k, 0) for k in v}
                         for op, v in after.items()})
    before = collective_counters.snapshot()
    x = torch.ones(2, 3)
    acc.gather(x)
    acc.reduce(x)
    acc.pad_across_processes(x)
    operations.broadcast(x)
    operations.gather_object({"rank": rank})
    operations.broadcast_object_list([rank])
    after = collective_counters.snapshot()
    ops = {op: {k: v[k] - before.get(op, {}).get(k, 0) for k in v} for op, v in after.items()
           if v != before.get(op)}
    token_count_bytes = torch.ones((), dtype=torch.long).element_size()
    whole_grad_bytes = sum(p.numel() * p.element_size() for p in
                           acc.train_state.model.ignored.values())
    sharded_grads = len(_dtensors(acc.train_state.model))
    acc.end_training()
    profile = acc.telemetry.profiler.summary()  # the lagged last record flushed
    with open(os.path.join(ctx["telemetry_dir"], "telemetry", f"rank_{rank}.jsonl")) as f:
        records = [json.loads(line) for line in f]
    _reset_port()
    return {"per_step": per_step, "ops": ops, "records": records,
            "token_count_bytes": token_count_bytes, "whole_grad_bytes": whole_grad_bytes,
            "sharded_grads": sharded_grads,
            "profile": profile, "enabled_after": collective_counters.enabled}


def _own(t):
    """A process's own part of a tensor: its shard of a DTensor."""
    return t.to_local() if hasattr(t, "to_local") else t


def _job_fp16(ctx):
    """fp16 FSDP2 steps, fused then as the imperative loop (2 microbatches),
    3 each, the second of which overflows on process 1's shard only: an inf
    written into that process's shard of the embedding's gradient once
    FSDP2 has reduce-scattered it. Per step: loss, grad norm, scale, growth
    tracker, step, optimizer count, and whether this process's shards and
    AdamW state stayed bit-equal."""
    rank, world = dist.get_rank(), dist.get_world_size()
    out = {}
    for loop in (False, True):
        cfg = LlamaConfig.tiny(dtype=torch.float16)
        module = LlamaForCausalLM(cfg)
        module.load_state_dict(llama_params_from_flax(cfg, ctx["flax_params"]))
        acc = _port_accelerator("fsdp", mixed_precision="fp16", gradient_accumulation_steps=2,
                                kwargs_handlers=[GradScalerKwargs(init_scale=1024.0,
                                                                  growth_interval=2)])
        model, opt = acc.prepare(Model(module), adamw(LR))
        overflow = {"on": False}

        def poison(p):
            if overflow["on"] and rank == 1:
                p.grad.to_local().view(-1)[0] = float("inf")

        module.model.embed_tokens.weight.register_post_accumulate_grad_hook(poison)
        step = acc.prepare_train_step(_port_loss, max_grad_norm=1.0)
        st, rows = acc.train_state, []
        for i in range(STEPS):
            overflow["on"] = i == 1
            before = [_own(t).clone() for t in module.parameters()] + [
                _own(v).clone() for s in st.optimizer.state.values() for v in s.values()]
            batch = _local(ctx["batches"][i], rank, world)
            if loop:
                for mb in _microbatch_split(batch, 2):
                    with acc.accumulate(model):
                        loss = acc.backward(_port_loss, mb)
                        norm = acc.clip_grad_norm_(None, 1.0)
                        opt.step()
                        opt.zero_grad()
                skipped = opt.step_was_skipped
            else:
                st, m = step(st, batch)
                loss, norm, skipped = m["loss"], m["grad_norm"], None
            after = [_own(t) for t in module.parameters()] + [
                _own(v) for s in st.optimizer.state.values() for v in s.values()]
            rows.append({"loss": float(loss), "grad_norm": float(norm), "skipped": skipped,
                         "scale": float(st.loss_scale.scale),
                         "tracker": int(st.loss_scale.growth_tracker), "step": int(st.step),
                         "count": st.optimizer.count,
                         "unchanged": all(torch.equal(a, b) for a, b in zip(before, after))})
        out["loop" if loop else "fused"] = rows
        _reset_port()
    return out


# Strategies and plugins: name -> (kind, plugin kwargs, the JAX reference
# run of the same plugin). min_weight_size_to_shard=0 plans the tiny Llama
# as the default does (its norms stay whole by rank, every other parameter
# is over 2**11 elements: test_min_weight_size_plans_like_jax), so its run
# is the default's; HYBRID_SHARD is FULL_SHARD in the JAX package (it reads
# a strategy only through shards_params and shards_grads_and_opt, equal for
# the two: test_sharding_strategy_names_and_codes), so its run is the HSDP
# one; a DeepSpeed stage is the JAX run of the strategy the JAX package
# maps it to (test_deepspeed_stages_map_as_in_jax).
STRATEGIES = {
    2: {"shard_grad_op": ("fsdp", {"sharding_strategy": "SHARD_GRAD_OP"}, "sgo2"),
        "no_shard": ("fsdp", {"sharding_strategy": "3"}, "no_shard2"),
        "min_size_0": ("fsdp", {"min_weight_size_to_shard": 0}, "fsdp2"),
        **{f"zero{k}": ("ds", {"zero_stage": k}, ref)
           for k, ref in ((0, "no_shard2"), (1, "sgo2"), (2, "sgo2"), (3, "fsdp2"))}},
    4: {"shard_grad_op": ("fsdp", {"sharding_strategy": "SHARD_GRAD_OP"}, "sgo4"),
        "hybrid_shard": ("hsdp", {"sharding_strategy": "HYBRID_SHARD"}, "hsdp")},
}
DDP_KWARGS = {"ddp": dict(bucket_cap_mb=1, find_unused_parameters=True,
                          gradient_as_bucket_view=True),
              "no_shard": dict(static_graph=True)}


def _job_strategies(ctx):
    return {name: _train(ctx, kind, plugin_kw=kw)
            for name, (kind, kw, _) in STRATEGIES[dist.get_world_size()].items()}


def _job_ddp_kwargs(ctx):
    """DistributedDataParallelKwargs on DDP without a plugin and under
    NO_SHARD: the reducer's settings as DDP holds them."""
    out = {}
    for name, kw in DDP_KWARGS.items():
        plugin = FullyShardedDataParallelPlugin(sharding_strategy="NO_SHARD") if name != "ddp" \
            else None
        acc = Accelerator(cpu=True, fsdp_plugin=plugin,
                          kwargs_handlers=[DistributedDataParallelKwargs(**kw)])
        model, _ = acc.prepare(Model(LlamaForCausalLM(LlamaConfig.tiny(dtype=torch.float32))),
                               adamw(LR))
        ddp = model.forward_module
        out[name] = {"type": type(ddp).__name__, "sharded": model.sharded,
                     "bucket_cap_mb": ddp.bucket_bytes_cap / 2**20,
                     "find_unused_parameters": ddp.find_unused_parameters,
                     "gradient_as_bucket_view": ddp.gradient_as_bucket_view,
                     "static_graph": ddp.static_graph}
        _reset_port()
    return out


def _job_dcp_save(ctx):
    """FSDP2 with DISTRIBUTED_STATE_DICT: a checkpoint after step 2, then step 3."""
    return _train(ctx, "fsdp", save_after=2, project_dir=ctx["dcp_dir"], plugin_kw=DCP)


def _dcp_ckpt(ctx):
    return os.path.join(ctx["dcp_dir"], "checkpoints", "checkpoint_0")


def _job_dcp_load(ctx):
    """The checkpoint of _job_dcp_save loaded at this gang's size, then step 3."""
    return _train(ctx, "fsdp", load_dir=_dcp_ckpt(ctx), plugin_kw=DCP)


def _job_dcp_async(ctx):
    """save_state(block=False) after step 1, steps 2 and 3 while it persists,
    then wait_for_checkpoint; two more asynchronous saves, the second
    queued behind the first, drained by end_training. Each checkpoint
    loaded by a fresh Accelerator."""
    rank, world = dist.get_rank(), dist.get_world_size()
    cfg = LlamaConfig.tiny(dtype=torch.float32)
    module = LlamaForCausalLM(cfg)
    module.load_state_dict(llama_params_from_flax(cfg, ctx["flax_params"]))
    acc = _port_accelerator("fsdp", DCP)
    acc.prepare(Model(module), adamw(LR))
    step = acc.prepare_train_step(_port_loss, max_grad_norm=1.0)
    dirs = [os.path.join(ctx["dcp_async_dir"], name) for name in ("a", "b", "c")]
    step(acc.train_state, _local(ctx["batches"][0], rank, world))
    acc.save_state(dirs[0], block=False)
    out = {"in_flight": acc._pending_save is not None, "at_save": _whole_state(acc)}
    for i in (1, 2):
        step(acc.train_state, _local(ctx["batches"][i], rank, world))
    acc.wait_for_checkpoint()
    out["after"] = _whole_state(acc)
    acc.save_state(dirs[1], block=False)
    acc.save_state(dirs[2], block=False)
    acc.end_training()
    out["drained"] = acc._pending_save is None
    _reset_port()
    out["loaded"] = [_train(ctx, "fsdp", steps=0, load_dir=d, plugin_kw=DCP)["state_at_load"]
                     for d in (dirs[0], dirs[2])]
    return out


def _job_verify(ctx):
    """``verify_operation`` around ``gather`` in debug mode: equal shapes
    gather, shapes that differ on the last process raise on every one."""
    from accelerate_tpu_torch.parallel.fsdp import apply_ddp
    from accelerate_tpu_torch.utils import operations, other

    rank, world = dist.get_rank(), dist.get_world_size()
    os.environ["ACCELERATE_DEBUG_MODE"] = "1"
    try:
        acc = Accelerator(cpu=True)
        out = {"debug": PartialState().debug}
        gather = operations.verify_operation(operations.gather)
        out["equal"] = gather({"x": torch.full((2,), float(rank))})["x"].tolist()
        try:
            gather(torch.zeros(3 if rank == world - 1 else 2))
            out["error"] = None
        except operations.DistributedOperationException as exc:
            out["error"] = str(exc)
        other.wait_for_everyone()
        module = torch.nn.Linear(2, 2)
        out["unwrapped"] = other.extract_model_from_parallel(apply_ddp(module, acc.device)) \
            is module
    finally:
        del os.environ["ACCELERATE_DEBUG_MODE"]
    _reset_port()
    return out


# The Mixtral job: capacity factor 0.5, so that tokens drop, over 8 experts
# (top 2), whose loads differ enough that some stay under capacity.
MOE = dict(capacity_factor=0.5, num_local_experts=8, scan_layers=False)


def _job_moe(ctx):
    """The Mixtral runs: routing over the global batch, and, for contrast,
    each process routing its own rows alone (the layer told it runs on one
    process)."""
    from accelerate_tpu_torch.models import moe

    out = {"global": _moe_steps(ctx)}
    routed_over = moe.loss_processes
    moe.loss_processes = lambda: 1
    try:
        out["local"] = _moe_steps(ctx)
    finally:
        moe.loss_processes = routed_over
    return out


def _moe_steps(ctx):
    """STEPS steps of the tiny fp32 Mixtral under FSDP2 on this process's
    rows: per step the loss, the aux loss (the mean of the processes'
    shares: the global batch's), the grad norm and the layers' dropped
    choices."""
    from accelerate_tpu_torch import moe_cross_entropy_loss
    from accelerate_tpu_torch.models import MixtralConfig, MixtralForCausalLM

    rank, world = dist.get_rank(), dist.get_world_size()
    cfg = MixtralConfig.tiny(dtype=torch.float32, **MOE)
    module = MixtralForCausalLM(cfg)
    module.load_state_dict(llama_params_from_flax(cfg, ctx["moe_flax"]))
    acc = _port_accelerator("fsdp")
    model, _ = acc.prepare(Model(module), adamw(LR))
    aux = []

    def tap(*args, **kwargs):
        out = model(*args, **kwargs)
        aux.append(out[1].detach().clone())
        return out

    step = acc.prepare_train_step(
        lambda m, b: moe_cross_entropy_loss(tap, b["x"].long(), b["y"].long()),
        max_grad_norm=1.0)
    rows = []
    for i in range(STEPS):
        _, m = step(acc.train_state, _local(ctx["batches"][i], rank, world))
        share = aux[-1]
        dist.all_reduce(share)
        rows.append((float(m["loss"]), float(share) / world, float(m["grad_norm"]),
                     int(module.router_stats()["dropped"])))
    _reset_port()
    return rows


# The tiny ResNet's sync-BN runs: (strategy, optimizer, steps). SGD's update
# is linear in the gradient, so its running statistics after three steps
# compare at 1e-5 (tests/test_torch_resnet.py); AdamW's after one.
RESNET_RUNS = {"ddp": ("ddp", "sgd", STEPS), "fsdp2": ("fsdp", "adamw", 1)}
RESNET_LR = 0.1


def _resnet_weights():
    """numpy-seeded weights and running statistics of the tiny fp32
    ResNet: (the port's state dict, flax params, flax batch_stats), numpy;
    and the global batch of 8 images."""
    module = ResNet(ResNetConfig.tiny(dtype=torch.float32))
    rng = np.random.default_rng(11)
    sd = {}
    for name, t in module.state_dict().items():
        if name.endswith("mean"):
            a = rng.standard_normal(t.shape) * 0.1
        elif name.endswith("var"):
            a = rng.uniform(0.5, 1.5, t.shape)
        elif t.dim() == 1:
            a = rng.standard_normal(t.shape) * 0.1 + (0.0 if name.endswith("bias") else 1.0)
        else:
            a = rng.standard_normal(t.shape) / np.sqrt(np.prod(t.shape[1:]))
        sd[name] = a.astype(np.float32)
    module.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    params = {k: v.detach().numpy() for k, v in _flat(resnet_params_to_flax(
        module.config, dict(module.named_parameters()))).items()}
    stats = {k: t.numpy().copy() for k, t in tree_items(Model(module).extra_state)}
    batch = (rng.normal(size=(GLOBAL_BATCH, 32, 32, 3)).astype(np.float32),
             rng.integers(0, 4, GLOBAL_BATCH).astype(np.int64))
    return sd, params, stats, batch


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, prefix + (k,)) if isinstance(v, dict) else {prefix + (k,): v})
    return out


def _nest(flat):
    out: dict = {}
    for path, v in flat.items():
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return out


def _job_sync_bn(ctx):
    """The tiny ResNet's ``mutable_state`` steps on this process's half of
    the global batch, under each of ``RESNET_RUNS``: (loss, grad norm) per
    step and the running statistics after, by flax path."""
    rank, world = dist.get_rank(), dist.get_world_size()
    x, y = ctx["resnet_batch"]
    n = len(x) // world
    batch = {"x": torch.from_numpy(x[rank * n:(rank + 1) * n]),
             "y": torch.from_numpy(y[rank * n:(rank + 1) * n])}
    out = {}
    for name, (kind, opt, steps) in RESNET_RUNS.items():
        module = ResNet(ResNetConfig.tiny(dtype=torch.float32))
        module.load_state_dict({k: torch.from_numpy(v) for k, v in ctx["resnet_sd"].items()})
        acc = _port_accelerator(kind)
        optimizer = (torch.optim.SGD(module.parameters(), lr=RESNET_LR) if opt == "sgd"
                     else adamw(LR))
        model, _ = acc.prepare(Model(module), optimizer)
        step = acc.prepare_train_step(lambda m, e, b: resnet_loss(m, e, b["x"], b["y"]),
                                      mutable_state=True, max_grad_norm=1.0)
        metrics = []
        for _ in range(steps):
            _, m = step(acc.train_state, batch)
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
        out[name] = {"metrics": metrics, "sharded": model.sharded,
                     "ddp": model.forward_module is not model.module,
                     "stats": {k: t.numpy().copy()
                               for k, t in tree_items(acc.train_state.extra_state)}}
        _reset_port()
    return out


# The encoder losses whose global-batch mean needs every process: BERT's
# masked-LM count and CLIP's in-batch negatives; (config, module class).
ENCODER_LOSSES = {"bert_mlm": ("BertConfig", "BertForMaskedLM"),
                  "clip": ("CLIPConfig", "CLIPModel")}


def _encoder_module(family):
    cfg_name, mod_name = ENCODER_LOSSES[family]
    return getattr(port_models, mod_name)(getattr(port_models, cfg_name).tiny(
        dtype=torch.float32))


def _encoder_weights(family):
    """numpy-seeded weights of the family's tiny fp32 module (the port's
    state dict and the flax params, numpy) and its global batch: BERT's
    ids, padding mask and 30 % masked labels (uneven over the halves),
    CLIP's ids (the largest id last: the EOT) and pixels."""
    module = _encoder_module(family)
    rng = np.random.default_rng(13)
    sd = {}
    for name, t in module.state_dict().items():
        if t.dim() == 0:  # CLIP's logit_scale
            a = np.full((), 2.6592)
        elif t.dim() == 1:
            a = rng.standard_normal(t.shape) * 0.1 + (0.0 if name.endswith("bias") else 1.0)
        else:
            a = rng.standard_normal(t.shape) / np.sqrt(np.prod(t.shape[1:]))
        sd[name] = a.astype(np.float32)
    tree = port_models.convert.flax_converter(module).to_flax(
        module.config, {k: torch.from_numpy(v) for k, v in sd.items()})
    params = {k: v.detach().numpy() for k, v in _flat(tree).items()}
    ids = rng.integers(1, 250, (GLOBAL_BATCH, 12))
    if family == "bert_mlm":
        mask = np.ones_like(ids)
        mask[1::2, 8:] = 0
        batch = {"ids": ids, "mask": mask,
                 "labels": np.where(rng.random(ids.shape) < 0.3, ids, -100)}
    else:
        ids[:, -1] = 511
        batch = {"ids": ids,
                 "pixels": rng.normal(size=(GLOBAL_BATCH, 32, 32, 3)).astype(np.float32)}
    return sd, params, batch


def _encoder_loss(family):
    if family == "bert_mlm":
        return lambda m, b: port_models.masked_lm_loss(m(b["ids"], b["mask"]), b["labels"])
    return lambda m, b: port_models.clip_contrastive_loss(m, b["ids"], b["pixels"])


def _job_encoder_losses(ctx):
    """Three AdamW steps of each ``ENCODER_LOSSES`` family on this
    process's half of its global batch, under DDP and FSDP2: (loss, grad
    norm) per step."""
    rank, world = dist.get_rank(), dist.get_world_size()
    out = {}
    for family in ENCODER_LOSSES:
        sd, _, batch = ctx["encoders"][family]
        local = {k: torch.from_numpy(v) for k, v in _local(batch, rank, world).items()}
        for kind in ("ddp", "fsdp"):
            module = _encoder_module(family)
            module.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
            acc = _port_accelerator(kind)
            acc.prepare(Model(module), adamw(LR))
            step = acc.prepare_train_step(_encoder_loss(family), max_grad_norm=1.0)
            metrics = []
            for _ in range(STEPS):
                _, m = step(acc.train_state, local)
                metrics.append((float(m["loss"]), float(m["grad_norm"])))
            out[family, kind] = metrics
            _reset_port()
    return out


# chip_smoke.py's table of every family the port trains, with the blocks of
# its tiny config, and its classes (``unit_family``).
_SPEC = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(chip_smoke)
UNIT_FAMILIES = chip_smoke.UNIT_FAMILIES
# The families whose blocks fault 7 left without units: one FSDP2 step.
UNIT_STEPS = ("gpt2", "t5")


def _unit_module(family, seed=0):
    cfg_cls, mod_cls = chip_smoke.unit_family(family)[:2]
    module = mod_cls(cfg_cls.tiny(dtype=torch.float32))
    module.init_weights(torch.Generator().manual_seed(seed))
    return module


def _unit_loss(family):
    if family == "t5":
        return lambda m, b: port_models.t5_cross_entropy_loss(
            m(b["x"].long(), port_models.shift_tokens_right(b["y"].long())), b["y"].long())
    return _port_loss


def _unit_batch(family):
    rng = np.random.default_rng(12)
    if family == "t5":
        return {"x": rng.integers(2, 256, (GLOBAL_BATCH, 10)),
                "y": rng.integers(2, 256, (GLOBAL_BATCH, 6))}
    ids = rng.integers(0, 256, (GLOBAL_BATCH, SEQ + 1))
    return {"x": ids[:, :-1], "y": ids[:, 1:]}


def _job_units(ctx):
    """FSDP2 at this world size on every family's tiny module: its blocks
    and how many of them are FSDP2 units, whether the root is one; one
    step of ``UNIT_STEPS``'s families on this process's share of the
    global batch; and ``activation_checkpointing`` under ``NO_SHARD``."""
    from torch.distributed.fsdp import FSDPModule

    rank, world = dist.get_rank(), dist.get_world_size()
    out = {}
    for family in UNIT_FAMILIES:
        module = _unit_module(family)
        acc = _port_accelerator("fsdp")
        model, _ = acc.prepare(Model(module), adamw(LR))
        blocks = decoder_blocks(model.module)
        out[family] = {"blocks": len(blocks),
                       "units": sum(isinstance(b, FSDPModule) for b in blocks),
                       "root": isinstance(model.module, FSDPModule)}
        if family in UNIT_STEPS:
            step = acc.prepare_train_step(_unit_loss(family), max_grad_norm=1.0)
            batch = {k: torch.from_numpy(v) for k, v in
                     _local(_unit_batch(family), rank, world).items()}
            _, m = step(acc.train_state, batch)
            out[family]["metrics"] = (float(m["loss"]), float(m["grad_norm"]))
        _reset_port()
    cfg = LlamaConfig.tiny(dtype=torch.float32)
    acc = _port_accelerator("fsdp", dict(sharding_strategy="NO_SHARD",
                                         activation_checkpointing=True))
    model, _ = acc.prepare(Model(LlamaForCausalLM(cfg)), adamw(LR))
    out["no_shard_remat"] = {"remat": model.module.config.remat, "caller": cfg.remat,
                            "ddp": model.forward_module is not model.module}
    _reset_port()
    return out


SDC_STEPS = 6


def _sdc_run(ctx, name, flip=None, repair="rollback"):
    """SDC_STEPS DDP steps (every process a replica: the same batch) of the
    tiny Llama with the SDC sentinel voting every step, a checkpoint after
    step 1 and chaos ``bit_flip`` entries ``flip``; each step on the batch
    of the state's step. A conviction's ``os._exit`` is caught here."""
    from unittest import mock

    from accelerate_tpu_torch import FaultToleranceKwargs

    rank = dist.get_rank()
    cfg = LlamaConfig.tiny(dtype=torch.float32)
    module = LlamaForCausalLM(cfg)
    module.load_state_dict(llama_params_from_flax(cfg, ctx["flax_params"]))
    project = os.path.join(ctx["surface_dir"], "sdc", name)
    handler = FaultToleranceKwargs(sentinel="off", sdc=dict(vote_every=1, repair=repair),
                                   chaos=dict(seed=0, schedule=flip or []))
    acc = Accelerator(cpu=True, project_config=ProjectConfiguration(
        project_dir=project, automatic_checkpoint_naming=True), kwargs_handlers=[handler])
    acc.prepare(Model(module), adamw(LR))
    step = acc.prepare_train_step(_port_loss, max_grad_norm=1.0)
    batches, state, losses, code = _batches(SDC_STEPS), acc.train_state, [], None
    sentinel = acc.fault_tolerance.sdc
    def exit_(code):
        raise SystemExit(code)

    with mock.patch("os._exit", side_effect=exit_):
        try:
            for _ in range(SDC_STEPS + 4):
                if int(state.step) >= SDC_STEPS or sentinel.peer_quarantined:
                    break
                s0 = int(state.step)
                batch = {k: torch.from_numpy(v) for k, v in batches[s0].items()}
                state, m = step(state, batch)
                losses.append((s0, float(m["loss"]), float(m["sdc_digest"])))
                if int(state.step) == 1 and name != "clean" and len(losses) == 1:
                    acc.save_state()
        except SystemExit as e:
            code = e.code
    out = {"losses": losses, "summary": sentinel.summary(), "exit": code,
           "params": _whole_params(acc.train_state.model), "project": project}
    acc.end_training()
    _reset_port()
    return out


def _job_sdc(ctx):
    """Fault-free, a transient flip on rank 1 (two replicas: no majority;
    the probe is clean, the run rolls back to step 1) and a sticky one
    (the probe reproduces it: rank 1 convicted, exit 79, the quarantine
    record; rank 0 told its peer was)."""
    flip = {"point": "train_step", "kind": "bit_flip", "tick": 2, "unit": 1}
    return {"clean": _sdc_run(ctx, "clean"),
            "transient": _sdc_run(ctx, "transient", [dict(flip, mode="transient")]),
            "sticky": _sdc_run(ctx, "sticky", [dict(flip, mode="sticky")])}


def _job_sdc_broadcast(ctx):
    """4 replicas, a transient flip on rank 2: the 3-rank majority names it
    and ``repair="broadcast"`` re-syncs every rank from rank 0."""
    flip = {"point": "train_step", "kind": "bit_flip", "tick": 2, "unit": 2, "mode": "transient"}
    return {"clean": _sdc_run(ctx, "clean", repair="broadcast"),
            "broadcast": _sdc_run(ctx, "broadcast", [flip], repair="broadcast")}


JOBS = {"verify": _job_verify, "sdc": _job_sdc, "sdc_broadcast": _job_sdc_broadcast, "moe": _job_moe, "sync_bn": _job_sync_bn, "units": _job_units,
        "encoder_losses": _job_encoder_losses,
        "fsdp": _job_fsdp, "ddp": _job_ddp, "hsdp": _job_hsdp, "collectives": _job_collectives,
        "dispatcher": _job_dispatcher, "rng": _job_rng, "save": _job_save,
        "options": _job_options, "fsdp_ga2": _job_fsdp_ga2, "per_node": _job_per_node,
        "resume_jax": _job_resume_jax, "fsdp_uneven": _job_fsdp_uneven,
        "fused_ce": _job_fused_ce,
        "imperative": _job_imperative, "imperative_hsdp": _job_imperative_hsdp,
        "surface": _job_surface, "telemetry": _job_telemetry, "fp16": _job_fp16,
        "strategies": _job_strategies, "ddp_kwargs": _job_ddp_kwargs,
        "dcp_save": _job_dcp_save, "dcp_load": _job_dcp_load, "dcp_async": _job_dcp_async}


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
    """Run ``jobs`` in a gang of ``world`` gloo processes; every process's
    results, by rank."""
    ctx_path = str(tmp / f"ctx{world}.pkl")
    with open(ctx_path, "wb") as f:
        pickle.dump(ctx, f)
    mp.start_processes(_worker, args=(world, str(tmp / f"rendezvous{world}"), ctx_path, jobs),
                       nprocs=world, join=True, start_method="spawn")
    with open(ctx_path + f".out{world}", "rb") as f:
        return pickle.load(f)


# ---------------------------------------------------------------------------
# The JAX references, and one run of each gang for the whole module
# ---------------------------------------------------------------------------


def _jax_reset():
    from accelerate_tpu.state import AcceleratorState as JS
    from accelerate_tpu.state import GradientState as JG
    from accelerate_tpu.state import PartialState as JP

    for cls in (JS, JG, JP):
        cls._reset_state()


def _jax_plan(shardings) -> set:
    """The ``/``-joined flax names of the leaves a sharding tree shards."""
    import jax

    return {"/".join(str(k.key) for k in path)
            for path, s in jax.tree_util.tree_flatten_with_path(shardings)[0]
            if any(axis is not None for axis in s.spec)}


def _jax_train(batches, pc_kwargs, plugin, project_dir=None, save_after=None, ga=1, plan=None):
    """STEPS steps of the JAX Accelerator on the whole global batches:
    (loss, grad norm) per step and the parameters after them. ``plugin``:
    True for the default FSDP plugin, or its kwargs. ``plan`` (a dict)
    gets the names of the parameters whose AdamW state the plan shards
    (the parameters themselves but under SHARD_GRAD_OP)."""
    import jax
    import jax.numpy as jnp
    import optax

    from accelerate_tpu import Accelerator as JaxAccelerator
    from accelerate_tpu import FullyShardedDataParallelPlugin as JaxPlugin
    from accelerate_tpu import Model as JaxModel
    from accelerate_tpu import ParallelismConfig as JaxPC
    from accelerate_tpu import ProjectConfiguration as JaxProject
    from accelerate_tpu.models import LlamaConfig as JaxLlamaConfig
    from accelerate_tpu.models import LlamaForCausalLM as JaxLlama
    from accelerate_tpu.models import cross_entropy_loss as jax_ce

    _jax_reset()
    module = JaxLlama(JaxLlamaConfig.tiny(dtype=jnp.float32))
    acc = JaxAccelerator(parallelism_config=JaxPC(**pc_kwargs), gradient_accumulation_steps=ga,
                         fsdp_plugin=(JaxPlugin(**plugin) if isinstance(plugin, dict)
                                      else JaxPlugin() if plugin else None),
                         project_config=JaxProject(project_dir=project_dir,
                                                   automatic_checkpoint_naming=bool(project_dir)))
    model = JaxModel.from_flax(module, jax.random.key(0), batches[0]["x"])
    params = jax.tree.map(np.asarray, model.params)
    acc.prepare(model, optax.adamw(LR))
    if plan is not None:
        plan["sharded"] = _jax_plan(acc._state_shardings.opt_state[0].mu)

    def loss_fn(p, b):
        return jax_ce(module.apply({"params": p}, b["x"]), b["y"])

    step = acc.prepare_train_step(loss_fn, max_grad_norm=1.0)
    metrics = []
    for i, b in enumerate(batches):
        _, m = step(acc.train_state, {k: jnp.asarray(v) for k, v in b.items()})
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
        if save_after is not None and i + 1 == save_after:
            acc.save_state()
    final = jax.tree.map(np.asarray, acc.train_state.params)
    _jax_reset()
    return params, metrics, final


def _jax_moe_train(batches):
    """STEPS steps of the JAX Accelerator's tiny fp32 Mixtral (unscanned
    layers: one dispatch per layer) under dp_shard=2 with the FSDP plugin
    on the whole global batches: per step the loss, the aux loss and the
    dropped choices (a forward of the step's parameters, its dispatch
    counted through a debug callback) and the grad norm; and the initial
    parameters."""
    import jax
    import jax.numpy as jnp
    import optax

    from accelerate_tpu import Accelerator as JaxAccelerator
    from accelerate_tpu import FullyShardedDataParallelPlugin as JaxPlugin
    from accelerate_tpu import Model as JaxModel
    from accelerate_tpu import ParallelismConfig as JaxPC
    from accelerate_tpu.models import moe as jax_moe

    _jax_reset()
    module = jax_moe.MixtralForCausalLM(jax_moe.MixtralConfig.tiny(dtype=jnp.float32, **MOE))
    acc = JaxAccelerator(parallelism_config=JaxPC(dp_shard_size=2), fsdp_plugin=JaxPlugin())
    model = JaxModel.from_flax(module, jax.random.key(0), batches[0]["x"])
    params = jax.tree.map(np.asarray, model.params)
    acc.prepare(model, optax.adamw(LR))
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
        b = {k: jnp.asarray(v) for k, v in b.items()}
        jax_moe.compute_dispatch = counting
        try:  # traced (when it is) with the counting dispatch
            col = forward(acc.train_state.params, b["x"])
            jax.effects_barrier()
        finally:
            jax_moe.compute_dispatch = dispatch
        aux = float(sum(jnp.sum(v) for v in jax.tree.leaves(col["losses"])))
        _, m = step(acc.train_state, b)
        rows.append((float(m["loss"]), aux, float(m["grad_norm"]), sum(dropped)))
        dropped.clear()
    _jax_reset()
    return params, rows


def _jax_resnet_train(params, stats, batch, opt, steps):
    """The JAX Accelerator's ``mutable_state`` steps of the tiny ResNet on
    the whole global batch: (loss, grad norm) per step and the running
    statistics after, by flax path."""
    import jax
    import jax.numpy as jnp
    import optax

    from accelerate_tpu import Accelerator as JaxAccelerator
    from accelerate_tpu import Model as JaxModel
    from accelerate_tpu.models import resnet as jresnet

    _jax_reset()
    module = jresnet.ResNet(jresnet.ResNetConfig.tiny(dtype=jnp.float32))
    acc = JaxAccelerator()
    acc.prepare(JaxModel(module=module, params=jax.tree.map(jnp.array, _nest(params)),
                         extra_state=jax.tree.map(jnp.array, _nest(stats))),
                optax.sgd(RESNET_LR) if opt == "sgd" else optax.adamw(LR))
    step = acc.prepare_train_step(
        lambda p, extra, b: jresnet.resnet_loss(module, p, extra, b["x"], b["y"]),
        mutable_state=True, max_grad_norm=1.0)
    x, y = batch
    state, metrics = acc.train_state, []
    for _ in range(steps):
        state, m = step(state, {"x": jnp.asarray(x), "y": jnp.asarray(y, jnp.int32)})
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    after = {k: np.asarray(v) for k, v in _flat(jax.tree.map(np.asarray,
                                                             dict(state.extra_state))).items()}
    _jax_reset()
    return {"metrics": metrics, "stats": after}


def _jax_encoder_train(family, params, batch):
    """The JAX Accelerator's three AdamW steps of the family's loss on the
    whole global batch: (loss, grad norm) per step; and at the first
    weights, the loss on the whole batch and the mean of each half's own."""
    import jax
    import jax.numpy as jnp
    import optax

    from accelerate_tpu import Accelerator as JaxAccelerator
    from accelerate_tpu import Model as JaxModel
    from accelerate_tpu.models import bert as jbert
    from accelerate_tpu.models import clip as jclip

    _jax_reset()
    if family == "bert_mlm":
        module = jbert.BertForMaskedLM(jbert.BertConfig.tiny(dtype=jnp.float32))

        def loss(p, b):
            return jbert.masked_lm_loss(module.apply({"params": p}, b["ids"], b["mask"]),
                                        b["labels"])
    else:
        module = jclip.CLIPModel(jclip.CLIPConfig.tiny(dtype=jnp.float32))

        def loss(p, b):
            return jclip.clip_contrastive_loss(module, p, b["ids"], b["pixels"])

    params = jax.tree.map(jnp.array, _nest(params))
    whole = {k: jnp.asarray(v.astype(np.int32) if v.dtype == np.int64 else v)
             for k, v in batch.items()}
    at_start = {"whole": float(loss(params, whole)),
                "halves": float(np.mean([loss(params, _local(whole, r, 2)) for r in range(2)]))}
    acc = JaxAccelerator()
    acc.prepare(JaxModel(module=module, params=params), optax.adamw(LR))
    step = acc.prepare_train_step(loss, max_grad_norm=1.0)
    state, metrics = acc.train_state, []
    for _ in range(STEPS):
        state, m = step(state, whole)
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    _jax_reset()
    return {"metrics": metrics, **at_start}


def _jax_no_shard_remat(batches) -> tuple[bool, bool]:
    """The module's ``config.remat`` and the caller's after the JAX package
    prepares the tiny Llama with ``activation_checkpointing`` under
    ``NO_SHARD`` on ``dp_replicate=2``."""
    import jax
    import jax.numpy as jnp
    import optax

    from accelerate_tpu import Accelerator as JaxAccelerator
    from accelerate_tpu import FullyShardedDataParallelPlugin as JaxPlugin
    from accelerate_tpu import Model as JaxModel
    from accelerate_tpu import ParallelismConfig as JaxPC
    from accelerate_tpu.models import LlamaConfig as JaxLlamaConfig
    from accelerate_tpu.models import LlamaForCausalLM as JaxLlama

    _jax_reset()
    acc = JaxAccelerator(parallelism_config=JaxPC(dp_replicate_size=2),
                         fsdp_plugin=JaxPlugin(sharding_strategy="NO_SHARD",
                                               activation_checkpointing=True))
    cfg = JaxLlamaConfig.tiny(dtype=jnp.float32)
    model = JaxModel.from_flax(JaxLlama(cfg), jax.random.key(0), batches[0]["x"])
    acc.prepare(model, optax.adamw(LR))
    remat = model.module.config.remat, cfg.remat
    _jax_reset()
    return remat


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX references and both gangs' results."""
    tmp = tmp_path_factory.mktemp("dist")
    batches = _batches()
    ref = {}
    plans = {}
    params, ref["fsdp4"], ref["fsdp4_params"] = _jax_train(
        batches, dict(dp_shard_size=4), plugin=True, project_dir=str(tmp / "jax"), save_after=2,
        plan=plans.setdefault("fsdp4", {}))
    _, ref["fsdp2"], ref["fsdp2_params"] = _jax_train(batches, dict(dp_shard_size=2), True,
                                                      plan=plans.setdefault("fsdp2", {}))
    for name, pc, kw in (("sgo2", dict(dp_shard_size=2), {"sharding_strategy": "SHARD_GRAD_OP"}),
                         ("sgo4", dict(dp_shard_size=4), {"sharding_strategy": "SHARD_GRAD_OP"}),
                         ("no_shard2", dict(dp_shard_size=2), {"sharding_strategy": "NO_SHARD"})):
        _, ref[name], ref[name + "_params"] = _jax_train(batches, pc, kw,
                                                         plan=plans.setdefault(name, {}))
    _, ref["ddp"], ref["ddp_params"] = _jax_train(batches, dict(dp_replicate_size=2), False)
    _, ref["fsdp2_ga2"], _ = _jax_train(batches, dict(dp_shard_size=2), True, ga=2)
    _, ref["fsdp2_uneven"], ref["fsdp2_uneven_params"] = _jax_train(
        _uneven(batches), dict(dp_shard_size=2), True)
    _, ref["hsdp"], ref["hsdp_params"] = _jax_train(
        batches, dict(dp_replicate_size=2, dp_shard_size=2), True,
        plan=plans.setdefault("hsdp", {}))
    ctx_moe, ref["moe"] = _jax_moe_train(batches)
    resnet_sd, resnet_params, resnet_stats, resnet_batch = _resnet_weights()
    for name, (_, opt, steps) in RESNET_RUNS.items():
        ref["resnet_" + name] = _jax_resnet_train(resnet_params, resnet_stats, resnet_batch,
                                                  opt, steps)
    ref["no_shard_remat"] = _jax_no_shard_remat(batches)
    encoders = {family: _encoder_weights(family) for family in ENCODER_LOSSES}
    for family, (_, flax_params, batch) in encoders.items():
        ref["encoder_" + family] = _jax_encoder_train(family, flax_params, batch)
    ctx = {"flax_params": params, "batches": batches, "uneven_batches": _uneven(batches),
           "moe_flax": ctx_moe, "resnet_sd": resnet_sd, "resnet_batch": resnet_batch,
           "encoders": encoders,
           "save_dir": str(tmp / "port4"),
           "per_node_dir": str(tmp / "per_node"), "surface_dir": str(tmp),
           "telemetry_dir": str(tmp / "telemetry"),
           "dcp_dir": str(tmp / "dcp4"), "dcp_async_dir": str(tmp / "dcp_async"),
           "jax_ckpt": str(tmp / "jax" / "checkpoints" / "checkpoint_0")}
    # The 4-process gang first: the 2-process one loads its DCP checkpoint.
    four = _spawn(tmp, 4, ["fsdp", "hsdp", "collectives", "save", "imperative_hsdp",
                           "surface", "strategies", "dcp_save", "sdc_broadcast"], ctx)
    two = _spawn(tmp, 2, ["fsdp", "ddp", "collectives", "dispatcher", "rng", "resume_jax",
                          "options", "fsdp_ga2", "per_node", "fsdp_uneven", "fused_ce",
                          "imperative",
                          "surface", "telemetry", "fp16", "strategies", "ddp_kwargs",
                          "dcp_load", "dcp_async", "verify", "moe", "sync_bn", "units",
                          "encoder_losses", "sdc"], ctx)
    return {"ref": ref, "plans": plans, 2: two, 4: four, "ctx": ctx, "tmp": tmp}


def _flax(params: dict) -> dict:
    cfg = LlamaConfig.tiny(dtype=torch.float32)
    return llama_params_to_flax(cfg, {k: torch.from_numpy(v) for k, v in params.items()})


def _assert_params_close(got, want, init):
    """Parameters after STEPS AdamW steps against the reference's. AdamW's
    m/√v turns the rounding of a near-zero gradient into a move of up to a
    whole step (lr) either way, so a few entries may differ by up to
    STEPS·lr while the rest agree to rounding. The JAX package's own runs
    on two meshes differ so: dp_shard=2 with the plugin and dp_replicate=2
    without give one embedding entry 9.4e-4 apart, and the embedding's
    update 3.5e-3 apart in norm. So: every entry within STEPS·lr; at most
    OUTLIER_SHARE of a tensor's entries (and 2) beyond PARAM_ATOL; each
    tensor's update (its change from ``init``) within UPDATE_RTOL in norm."""
    import jax

    flat = [dict(jax.tree_util.tree_flatten_with_path(t)[0]) for t in (got, want, init)]
    assert flat[0].keys() == flat[1].keys() == flat[2].keys()
    for path in flat[1]:
        g, w, i = (np.asarray(f[path], np.float64) for f in flat)
        name, diff = jax.tree_util.keystr(path), np.abs(g - w)
        assert diff.max() <= STEPS * LR, name
        assert (diff > PARAM_ATOL).sum() <= OUTLIER_SHARE * diff.size + 2, name
        assert np.linalg.norm(diff) <= UPDATE_RTOL * np.linalg.norm(w - i), name


def _assert_trees_close(got, want, rtol, atol):
    import jax

    flat_got = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    flat_want = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    assert flat_got.keys() == flat_want.keys()
    for path, w in flat_want.items():
        np.testing.assert_allclose(np.asarray(flat_got[path]), np.asarray(w), rtol=rtol,
                                   atol=atol, err_msg=jax.tree_util.keystr(path))


# ---------------------------------------------------------------------------
# Tests
# ---------------------------------------------------------------------------

CASES = [(2, "fsdp", "fsdp2"), (4, "fsdp", "fsdp4"), (2, "ddp", "ddp"), (4, "hsdp", "hsdp")]


@pytest.mark.parametrize("world,job,ref", CASES, ids=[c[2] for c in CASES])
def test_losses_and_grad_norms_match_jax(runs, world, job, ref):
    """Every process reports the global mean loss and the global grad norm,
    equal to the JAX package's on the whole batch within rtol 1e-4."""
    for rank_results in runs[world]:
        np.testing.assert_allclose(np.array(rank_results[job]["metrics"]),
                                   np.array(runs["ref"][ref]), rtol=1e-4)


@pytest.mark.parametrize("world,job,ref", CASES, ids=[c[2] for c in CASES])
def test_parameters_after_three_steps_match_jax(runs, world, job, ref):
    """The whole parameters after the steps, in flax layout, against the
    JAX package's (_assert_params_close), and the same on every process."""
    results = runs[world]
    _assert_params_close(_flax(results[0][job]["params"]), runs["ref"][ref + "_params"],
                         runs["ctx"]["flax_params"])
    for r in results[1:]:
        for name, value in r[job]["params"].items():
            np.testing.assert_array_equal(value, results[0][job]["params"][name])


@pytest.mark.parametrize("option", list(PLUGIN_OPTIONS))
def test_plugin_options_keep_the_numbers(runs, option):
    """Each honoured plugin field, at 2 processes, against the JAX
    package's dp_shard=2 run: the ignored norms stay whole (and their
    gradients are averaged by the step), activation checkpointing turns
    the model's remat on. The 5 norm scales stay whole under every option
    (rank 1, as the JAX plan keeps them); ``ignored_params`` names the same
    ones here."""
    for r in runs[2]:
        got = r["options"][option]
        np.testing.assert_allclose(np.array(got["metrics"]), np.array(runs["ref"]["fsdp2"]),
                                   rtol=1e-4)
        assert got["remat"] == (option == "activation_checkpointing")
        assert len(got["ignored"]) == 5 and all(n.endswith("norm.weight") for n in got["ignored"])
    _assert_params_close(_flax(runs[2][0]["options"][option]["params"]),
                         runs["ref"]["fsdp2_params"], runs["ctx"]["flax_params"])


def test_gradient_accumulation_matches_jax(runs):
    """Two microbatches a step on each of 2 FSDP2 processes against the JAX
    package's two microbatches of the global batch."""
    for r in runs[2]:
        np.testing.assert_allclose(np.array(r["fsdp_ga2"]["metrics"]),
                                   np.array(runs["ref"]["fsdp2_ga2"]), rtol=1e-4)


def test_uneven_ignored_labels_give_the_global_token_mean(runs):
    """Labels of -100 fall unevenly over 2 FSDP2 processes (44 valid labels
    on one, 12 on the other): the loss and the gradients are those of the
    token mean over the global batch, the JAX step's, not the mean of the
    processes' means."""
    for b in _uneven(_batches()):
        assert [int(half.sum()) for half in np.split(b["y"] != -100, 2)] == [44, 12]
    for r in runs[2]:
        np.testing.assert_allclose(np.array(r["fsdp_uneven"]["metrics"]),
                                   np.array(runs["ref"]["fsdp2_uneven"]), rtol=1e-4)
    _assert_params_close(_flax(runs[2][0]["fsdp_uneven"]["params"]),
                         runs["ref"]["fsdp2_uneven_params"], runs["ctx"]["flax_params"])


def test_fused_loss_takes_the_global_token_mean(runs):
    """``fused_cross_entropy_loss`` (chunks of 4) on the same uneven labels
    over 2 FSDP2 processes: the JAX step's global token mean, as
    ``cross_entropy_loss`` gives it, within rtol 1e-4, and the port's
    naive-loss run within 1e-5."""
    for r in runs[2]:
        got = np.array(r["fused_ce"]["metrics"])
        np.testing.assert_allclose(got, np.array(runs["ref"]["fsdp2_uneven"]), rtol=1e-4)
        np.testing.assert_allclose(got, np.array(r["fsdp_uneven"]["metrics"]), rtol=1e-5)
    _assert_params_close(_flax(runs[2][0]["fused_ce"]["params"]),
                         runs["ref"]["fsdp2_uneven_params"], runs["ctx"]["flax_params"])


def test_mixtral_routes_over_the_global_batch(runs):
    """The tiny Mixtral under FSDP2 at 2 processes, capacity factor 0.5:
    each process routes its rows with the global batch's capacity, slot
    positions after the lower rank's choices and the aux loss's sums over
    both, so losses, aux losses and grad norms equal the JAX package's on
    the global batch within ``DP_REL_TOL`` (1e-4) and the dropped choices
    are the JAX dispatch's, on every process."""
    want = np.array(runs["ref"]["moe"])
    assert (want[:, 3] > 0).all() and len(set(want[:, 3])) > 1
    for rank_rows in runs[2]:
        got = np.array(rank_rows["moe"]["global"])
        np.testing.assert_allclose(got[:, :3], want[:, :3], rtol=1e-4)
        np.testing.assert_array_equal(got[:, 3], want[:, 3])


def test_mixtral_routing_each_process_alone_would_differ(runs):
    """The same steps with each process routing its own rows alone
    (capacity from its own tokens, positions from its own first token):
    other tokens drop, and the loss leaves the JAX package's by far more
    than ``DP_REL_TOL``, so the test above tells the two apart."""
    want = np.array(runs["ref"]["moe"])
    local = np.array(runs[2][0]["moe"]["local"])
    assert np.abs(local[:, 0] / want[:, 0] - 1).max() > 1e-3


def _flax_stacked(names) -> set:
    """Port parameter names as the scanned flax tree's (one leaf for every
    layer's weight)."""
    import re

    from accelerate_tpu_torch.checkpointing import _flax_name

    module = LlamaForCausalLM(LlamaConfig.tiny(dtype=torch.float32), device="meta")
    return {re.sub(r"layers_\d+", "layers/block", _flax_name(module, n)) for n in names}


def _assert_split_is_the_jax_plan(result, plan):
    """The parameters FSDP2 shards (DTensors) are those the JAX plan shards,
    and each stacked leaf is sharded in every layer or in none."""
    whole = {n for n in _whole_params_names() if n not in result["dtensors"]}
    sharded, kept = _flax_stacked(result["dtensors"]), _flax_stacked(whole)
    assert sharded == plan and not sharded & kept


def _whole_params_names() -> list:
    module = LlamaForCausalLM(LlamaConfig.tiny(dtype=torch.float32), device="meta")
    return [n for n, _ in module.named_parameters()]


def test_fsdp_shards_and_ddp_replicates(runs):
    """FSDP2 and HSDP shard exactly what the JAX plan of the same mesh
    shards (every parameter but the norm scales, of rank 1); DDP shards
    nothing."""
    assert all(r["fsdp"]["sharded"] and not r["fsdp"]["ddp"] for r in runs[2] + runs[4])
    assert all(r["hsdp"]["sharded"] for r in runs[4])
    assert all(r["ddp"]["ddp"] and not r["ddp"]["sharded"] and not r["ddp"]["dtensors"]
               for r in runs[2])
    for world in (2, 4):
        for r in runs[world]:
            _assert_split_is_the_jax_plan(r["fsdp"], runs["plans"][f"fsdp{world}"]["sharded"])
    assert not any("norm" in name for name in runs["plans"]["fsdp2"]["sharded"])
    # AdamW runs foreach on the CPU's DTensors; fused only for CUDA parameters.
    assert runs[2][0]["fsdp"]["fused"] is None


def _jax_collectives(world, monkeypatch):
    """The JAX package's collectives for each rank of a gang of ``world``,
    run here: its process count is patched to ``world`` and its all-gather
    returns the gang's per-rank inputs of the call (given in order)."""
    from accelerate_tpu.utils import operations as jops

    inputs = [np.arange((r + 1) * COLLECTIVE_ROWS, dtype=np.float32).reshape(r + 1, -1) + 100 * r
              for r in range(world)]
    monkeypatch.setattr(jops, "_world", lambda: world)
    out = []
    for rank in range(world):
        queue, caller = [], [rank]

        def allgather(x, tiled, _queue=queue, _caller=caller):
            parts = _queue.pop(0)
            assert np.array_equal(np.asarray(parts[_caller[0]]), np.asarray(x))
            return np.concatenate(parts) if tiled else np.stack(parts)

        monkeypatch.setattr(jops, "_process_allgather", allgather)
        sizes = [np.array([x.shape[0]], np.int64) for x in inputs]
        # Every rank's padded input, as the gather that follows sees them.
        padded_all = []
        for r in range(world):
            caller[0] = r
            queue.append(sizes)
            padded_all.append(np.asarray(jops.pad_across_processes(inputs[r], pad_index=-1)))
        caller[0] = rank
        queue.append(sizes)
        pad_first = np.asarray(jops.pad_across_processes(inputs[rank], pad_index=-2,
                                                         pad_first=True))
        queue.append(padded_all)
        gathered = np.asarray(jops.gather(padded_all[rank]))
        queue.append([np.array([r + 1.0, 2.0]) for r in range(world)])
        reduced_sum = np.asarray(jops.reduce(np.array([rank + 1.0, 2.0]), reduction="sum"))
        queue.append([np.array([r + 1.0, 2.0]) for r in range(world)])
        reduced_mean = np.asarray(jops.reduce(np.array([rank + 1.0, 2.0]), "mean", scale=2.0))
        out.append({"pad": padded_all[rank], "pad_first": pad_first, "gather": gathered,
                    "reduce_sum": reduced_sum, "reduce_mean": reduced_mean,
                    "pad_input": np.asarray(jops.pad_input_tensors(np.arange(world + 1),
                                                                   world + 1, world))})
        assert not queue
    return out


@pytest.mark.parametrize("world", [2, 4])
def test_collectives_match_jax(runs, world, monkeypatch):
    want = _jax_collectives(world, monkeypatch)
    for rank, (got, ref) in enumerate(zip((r["collectives"] for r in runs[world]), want)):
        for key, value in ref.items():
            np.testing.assert_allclose(got[key], value, err_msg=f"{key} rank {rank}")
        assert got["gather_object"] == [{"rank": r} for r in range(world)]
        assert got["gather_object_list"] == [x for r in range(world) for x in (r, r * 10)]
        assert got["broadcast"].tolist() == [float(world - 1)] * 3
        assert got["broadcast_object_list"] == ["from 1", {"r": 1}]
        tree = got["gather_tree"]
        assert tree["a"].tolist() == [float(r) for r in range(world) for _ in range(2)]
        assert isinstance(tree["b"][0], np.ndarray)
        assert tree["b"][0].tolist() == [[r, r] for r in range(world)]


def _jax_dispatch(world, split, monkeypatch):
    """The JAX DataLoaderDispatcher's slices for each rank of a gang of
    ``world``: its PartialState reports the rank, and its broadcast hands
    every rank what rank 0 sent."""
    from types import SimpleNamespace

    import accelerate_tpu.data_loader as jdl

    class _Ds:
        def __init__(self, ds):
            self.ds = ds

        def __len__(self):
            return len(self.ds)

        def __getitem__(self, i):
            return self.ds[i]

    ds = _Ds(_dispatch_dataset())
    sent = []
    out = []
    for rank in range(world):
        state = SimpleNamespace(num_processes=world, process_index=rank,
                                is_main_process=rank == 0)
        monkeypatch.setattr(jdl, "PartialState", lambda state=state: state)
        replay = iter(sent) if rank else None

        def bcast(payload, from_process=0, _replay=replay):
            if _replay is None:
                sent.append(list(payload))
            else:
                payload[:] = next(_replay)
            return payload

        monkeypatch.setattr(jdl, "broadcast_object_list", bcast)
        inner = jdl.BatchSampler(jdl.SequentialSampler(len(ds)), batch_size=4)
        loader = jdl.DataLoaderDispatcher(ds, batch_sampler=inner, split_batches=split,
                                          dispatch_group_size=2)
        out.append({"len": len(loader),
                    "batches": [{k: np.asarray(v) for k, v in b.items()}
                                for b in loader._raw_batches()]})
    return out


@pytest.mark.parametrize("split", [False, True], ids=["whole", "split"])
def test_dispatcher_batches_match_jax(runs, split, monkeypatch):
    want = _jax_dispatch(2, split, monkeypatch)
    for rank, r in enumerate(runs[2]):
        got = r["dispatcher"][split]
        assert got["len"] == want[rank]["len"]
        assert len(got["batches"]) == len(want[rank]["batches"]) > 0
        for g, w in zip(got["batches"], want[rank]["batches"]):
            assert g.keys() == w.keys()
            for k in w:
                np.testing.assert_array_equal(g[k], w[k])


def test_save_on_each_node_writes_once_per_node(runs):
    """Without save_on_each_node process 0 alone writes the shared files; with
    it each node's local process 0 does (here every process is a node of
    its own, with a directory of its own). Every process writes its own
    random states either way."""
    shared = {"model.safetensors", "optimizer.bin", "accelerator_step.bin"}
    for rank, r in enumerate(runs[2]):
        once, per_node = r["per_node"][False], r["per_node"][True]
        assert once["local"] == rank and per_node["local"] == 0
        for listing in (once, per_node):
            assert f"random_states_{rank}.pkl" in listing["files"]
        assert shared <= set(per_node["files"])
        assert (shared <= set(once["files"])) == (rank == 0)
        if rank:
            assert once["files"] == [f"random_states_{rank}.pkl"]


def test_auto_flash_attention_runs_on_the_data_parallel_mesh(runs):
    for world in (2, 4):
        for r in runs[world]:
            assert r["collectives"]["mesh"] == (["pp", "dp_replicate", "dp_shard", "cp", "sp",
                                                 "tp"], [1, 1, world, 1, 1, 1])
            assert r["collectives"]["auto_flash_equal"]


def test_rng_states_are_synchronised_from_rank_0(runs):
    results = [r["rng"] for r in runs[2]]
    assert results[0]["before"] != results[1]["before"]
    assert results[0]["draws"] == results[1]["draws"]


def test_world4_checkpoint_resumes_in_one_process(runs):
    """The checkpoint the 4 FSDP2 processes wrote after step 2, resumed by
    one process: its step 3 is theirs, and so are the parameters after it."""
    from accelerate_tpu_torch.state import PartialState as P

    four = runs[4][0]["save"]
    ckpt = os.path.join(runs["ctx"]["save_dir"], "checkpoints", "checkpoint_0")
    assert sorted(f for f in os.listdir(ckpt) if f.startswith("random_states")) == [
        f"random_states_{r}.pkl" for r in range(4)]
    cfg = LlamaConfig.tiny(dtype=torch.float32)
    module = LlamaForCausalLM(cfg)
    acc = Accelerator(cpu=True)
    assert not P().use_distributed
    model, _ = acc.prepare(Model(module), adamw(LR))
    step = acc.prepare_train_step(_port_loss, max_grad_norm=1.0)
    acc.load_state(ckpt)
    assert acc.train_state.step == 2 and acc.train_state.optimizer.count == 2
    _, m = step(acc.train_state, runs["ctx"]["batches"][2])
    np.testing.assert_allclose([float(m["loss"]), float(m["grad_norm"])], four["metrics"][2],
                               rtol=1e-4)
    _assert_params_close(_flax({n: p.detach().numpy() for n, p in module.named_parameters()}),
                         _flax(four["params"]), runs["ctx"]["flax_params"])


def test_world4_checkpoint_reads_in_the_jax_package(runs):
    """The model.safetensors the 4 processes gathered holds, read by the JAX
    package's own reader, exactly the whole parameters they had."""
    from accelerate_tpu.utils import other as jax_other

    ckpt = os.path.join(runs["ctx"]["save_dir"], "checkpoints", "checkpoint_0")
    tree = jax_other.unflatten_state_dict(jax_other.load_sharded_safetensors(ckpt))
    _assert_trees_close(tree, _flax(runs[4][0]["save"]["params_at_save"]), rtol=0, atol=0)


def test_jax_dp_shard4_checkpoint_resumes_at_world2(runs):
    """The JAX package's checkpoint, saved under dp_shard=4 after step 2,
    resumed by 2 FSDP2 processes: step 3 and the parameters after it are
    the JAX run's."""
    for r in runs[2]:
        resumed = r["resume_jax"]
        assert resumed["step"] == STEPS
        np.testing.assert_allclose(np.array(resumed["metrics"]),
                                   np.array(runs["ref"]["fsdp4"][2:]), rtol=1e-4)
    _assert_params_close(_flax(runs[2][0]["resume_jax"]["params"]),
                         runs["ref"]["fsdp4_params"], runs["ctx"]["flax_params"])


def test_torchrun_environment_must_be_complete(monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(ValueError, match="incomplete"):
        PartialState(cpu=True)
    _reset_port()


def test_world_fill_and_refused_axes():
    """dp_shard fills the world around the other axes; pp, cp, sp and tp
    place each process on the 6-D mesh in row-major order (pp outermost, tp
    innermost); ep borrows whole axes, and outside them raises as the JAX
    constructor does."""
    assert ParallelismConfig().infer_missing_axis(4).dp_shard_size == 4
    pc = ParallelismConfig(dp_replicate_size=2).infer_missing_axis(8)
    assert (pc.dp_replicate_size, pc.dp_shard_size) == (2, 4)
    with pytest.raises(ValueError, match="does not divide"):
        ParallelismConfig(dp_shard_size=3).infer_missing_axis(4)
    for axis in ("cp", "sp"):
        pc = ParallelismConfig(**{f"{axis}_size": 2}).infer_missing_axis(8)
        assert (pc.dp_shard_size, pc.axis_size(axis), pc.seq_size) == (4, 2, 2)
        assert [pc.coordinates(r)[axis] for r in range(4)] == [0, 1, 0, 1]
        assert [pc.data_parallel_index(r) for r in range(4)] == [0, 0, 1, 1]
        assert [pc.sequence_index(r) for r in range(4)] == [0, 1, 0, 1]
    pc = ParallelismConfig(tp_size=2).infer_missing_axis(8)
    assert (pc.dp_shard_size, pc.tp_size) == (4, 2)
    assert [pc.coordinates(r)["tp"] for r in range(4)] == [0, 1, 0, 1]
    assert [pc.data_parallel_index(r) for r in range(4)] == [0, 0, 1, 1]
    pc = ParallelismConfig(pp_size=2, tp_size=2).infer_missing_axis(8)
    assert (pc.pp_size, pc.dp_shard_size, pc.non_pp_size) == (2, 2, 4)
    assert [pc.coordinates(r)["pp"] for r in range(8)] == [0] * 4 + [1] * 4
    assert [pc.data_parallel_index(r) for r in range(8)] == [0, 0, 1, 1] * 2
    with pytest.raises(ValueError, match="ep_size must divide"):
        ParallelismConfig(ep_size=2)
    assert ParallelismConfig(dp_shard_size=2, ep_size=2).infer_missing_axis(2).ep_axes == (
        "dp_shard",)
    env = ParallelismConfig(dp_replicate_size=2, dp_shard_size=3).to_env()
    for k, v in env.items():
        os.environ[k] = v
    try:
        assert ParallelismConfig.from_env() == ParallelismConfig(dp_replicate_size=2,
                                                                 dp_shard_size=3)
    finally:
        for k in env:
            del os.environ[k]


# ---------------------------------------------------------------------------
# The imperative loop and the rest of the surface across processes
# ---------------------------------------------------------------------------

IMPERATIVE = [(2, "imperative", "fsdp"), (2, "imperative", "ddp"), (4, "imperative_hsdp", "hsdp")]


@pytest.mark.parametrize("world,job,kind", IMPERATIVE, ids=[c[2] for c in IMPERATIVE])
def test_imperative_loop_matches_the_fused_step(runs, world, job, kind):
    """Two microbatches a window: the window losses and grad norms of the
    fused step (rtol 1e-5: the loop reduces its gradients once a window,
    the fused step once a microbatch), the same parameters on every
    process (_assert_params_close against the fused step's), and a
    window ending every second microbatch."""
    for r in runs[world]:
        got, want = r[job][kind]["loop"], r[job][kind]["fused"]
        np.testing.assert_allclose(np.array(got["metrics"]), np.array(want["metrics"]),
                                   rtol=1e-5)
        assert got["flags"] == [False, True] * STEPS and got["step"] == STEPS
        assert got["grad_after_step"]
    _assert_params_close(_flax(runs[world][0][job][kind]["loop"]["params"]),
                         _flax(runs[world][0][job][kind]["fused"]["params"]),
                         runs["ctx"]["flax_params"])
    for r in runs[world][1:]:
        for name, value in r[job][kind]["loop"]["params"].items():
            np.testing.assert_array_equal(value, runs[world][0][job][kind]["loop"]["params"][name])


@pytest.mark.parametrize("world,job,kind", IMPERATIVE, ids=[c[2] for c in IMPERATIVE])
def test_first_microbatch_skips_the_gradient_collectives(runs, world, job, kind):
    """On the microbatch that does not end the window FSDP2 (and HSDP)
    reduced nothing (its sharded parameters have no grad yet) and DDP left
    each process its own gradients; clip_grad_norm_ returns None there."""
    probes = [r[job][kind]["loop"]["probe"] for r in runs[world]]
    assert all(p["norm"] is None for p in probes)
    if kind == "ddp":
        assert probes[0]["first_grad_sum"] != probes[1]["first_grad_sum"]
    else:
        assert all(p["grads_kept_back"] and p["reduces_gradients"] is False for p in probes)


@pytest.mark.parametrize("kind", ["fsdp", "ddp"])
def test_sync_each_batch_reduces_every_microbatch_and_steps_per_window(runs, kind):
    """With sync_each_batch every microbatch reduces (equal gradients on
    both processes after the first, a norm there) and the optimizer still
    steps once a window: the fused step's numbers and parameters."""
    probes = [r["imperative"][kind]["each_batch"]["probe"] for r in runs[2]]
    assert all(p["norm"] is not None and not p["grads_kept_back"] for p in probes)
    if kind == "ddp":
        assert probes[0]["first_grad_sum"] == probes[1]["first_grad_sum"]
    else:
        assert all(p["reduces_gradients"] for p in probes)
    for r in runs[2]:
        got, want = r["imperative"][kind]["each_batch"], r["imperative"][kind]["fused"]
        np.testing.assert_allclose(np.array(got["metrics"]), np.array(want["metrics"]),
                                   rtol=1e-5)
        assert got["step"] == STEPS
    _assert_params_close(_flax(runs[2][0]["imperative"][kind]["each_batch"]["params"]),
                         _flax(runs[2][0]["imperative"][kind]["fused"]["params"]),
                         runs["ctx"]["flax_params"])


@pytest.mark.parametrize("world", [2, 4])
def test_triggers_and_process_helpers_across_ranks(runs, world):
    """A flag raised on the last rank is seen on every rank, once; the
    shares of 5 items are contiguous, the longer first, and padded with
    the last item; the main process runs its block first."""
    shares = {2: [[0, 1, 2], [3, 4]], 4: [[0, 1], [2], [3], [4]]}[world]
    longest = max(map(len, shares))
    for rank, r in enumerate(runs[world]):
        s = r["surface"]
        assert s["triggers"] == [False, True, False]
        assert s["list_False"] == shares[rank]
        assert s["list_True"] == shares[rank] + [4] * (longest - len(shares[rank]))
        assert s["dict_False"] == {"a": shares[rank], "b": [10 * x for x in shares[rank]]}
        padded = s["list_True"]
        assert s["dict_True"] == {"a": padded, "b": [10 * x for x in padded]}
        assert s["first"][0] == "0" and sorted(s["first"]) == [str(i) for i in range(world)]


@pytest.mark.parametrize("world", [2, 4])
def test_gather_for_metrics_inside_an_accumulation_window(runs, world):
    """7 samples in batches of 2 per process: the last global batch is padded
    by even_batches and gather_for_metrics drops the repeats, inside
    ``accumulate`` as outside; the loader's last batch ends a window."""
    for r in runs[world]:
        s = r["surface"]
        assert s["gathered"] == list(range(7))
        assert s["sync"][-1] and s["opt_steps"] == sum(s["sync"])
        n = len(s["sync"])
        assert s["sync"] == [(i + 1) % 2 == 0 or i == n - 1 for i in range(n)]


# ---------------------------------------------------------------------------
# Step telemetry over the gang
# ---------------------------------------------------------------------------


def test_straggler_probe_gathers_every_process_step_time(runs):
    """Every process writes a probe record a step holding every process's
    step time in rank order, its own among them; the skew follows."""
    out = [r["telemetry"] for r in runs[2]]
    for rank, res in enumerate(out):
        steps = [r for r in res["records"] if r["event"] == "step"]
        probes = [r for r in res["records"] if r["event"] == "straggler_probe"]
        assert [p["step"] for p in probes] == [1, 2]
        for st, probe in zip(steps, probes):
            times = probe["rank_times_s"]
            assert len(times) == 2 and times[rank] == st["wall_s"]
            assert (probe["step_time_max_s"], probe["step_time_min_s"]) == (max(times),
                                                                            min(times))
            assert probe["skew"] == pytest.approx((max(times) - min(times)) / np.mean(times))
        assert res["profile"]["steps"] == 2 and not res["enabled_after"]
    assert ([p["rank_times_s"] for p in out[0]["records"] if p["event"] == "straggler_probe"]
            == [p["rank_times_s"] for p in out[1]["records"] if p["event"] == "straggler_probe"])


def test_collective_counters_count_every_collective_of_a_step(runs):
    """A step at 2 processes runs four collectives of this package: the
    all-reduce of the loss's token count, that of the gradients FSDP2
    leaves whole (one flat buffer), that of the sharded gradients' squared
    norms (one fp32 each) and that of the loss (FSDP2's own all-gathers
    and reduce-scatters are torch's). The probe's gather does not count. Each operation of utils/operations.py counts once with its
    payload, pad_across_processes without the gather inside it."""
    for res in (r["telemetry"] for r in runs[2]):
        assert res["whole_grad_bytes"] == 5 * 128 * 4  # the norm scales, in one all-reduce
        assert res["sharded_grads"] == 16
        step_bytes = (res["token_count_bytes"] + 4 + res["whole_grad_bytes"]
                      + 4 * res["sharded_grads"])
        assert res["per_step"] == [{"all_reduce": {"count": 4, "bytes": step_bytes}}] * 2
        steps = [r for r in res["records"] if r["event"] == "step"]
        assert [s["collectives"] for s in steps] == [
            {"all_reduce": {"count": 4 * (i + 1), "bytes": (i + 1) * step_bytes}}
            for i in range(2)]
        assert res["ops"] == {
            "gather": {"count": 1, "bytes": 24}, "reduce": {"count": 1, "bytes": 24},
            "pad_across_processes": {"count": 1, "bytes": 24},
            "broadcast": {"count": 1, "bytes": 24}, "gather_object": {"count": 1, "bytes": 0},
            "broadcast_object_list": {"count": 1, "bytes": 0}}



@pytest.mark.parametrize("loop", ["fused", "loop"])
def test_fp16_overflow_on_one_shard_skips_on_every_process(runs, loop):
    """Only process 1's gradient shard overflows in step 2, so only it sees
    a non-finite value; the finite flag's MIN over the group makes both
    processes skip, keeping every shard, moment and count, and back off
    the scale. Steps 1 and 3 apply, and both processes agree on every
    number."""
    ranks = [r["fp16"][loop] for r in runs[2]]
    assert ranks[0] == ranks[1]
    rows = ranks[0]
    assert [r["unchanged"] for r in rows] == [False, True, False]
    assert [(r["scale"], r["tracker"], r["step"], r["count"]) for r in rows] == [
        (1024.0, 1, 1, 1), (512.0, 0, 1, 1), (512.0, 1, 2, 2)]
    assert all(np.isfinite(r["loss"]) for r in rows)
    assert np.isfinite(rows[0]["grad_norm"]) and not np.isfinite(rows[1]["grad_norm"])
    if loop == "loop":
        assert [r["skipped"] for r in rows] == [False, True, False]


def test_telemetry_counts_the_global_batch(runs):
    """Each process's step records count the global batch, as the JAX
    package's record of the dp_shard=2 step does (its _batch_counts on the
    global batch): samples, and tokens as tokens_per_s × wall_s."""
    from accelerate_tpu.telemetry import _batch_counts as jax_batch_counts

    want = [jax_batch_counts(b) for b in _batches()[:2]]
    assert want[0] == (GLOBAL_BATCH, GLOBAL_BATCH * SEQ)
    for res in (r["telemetry"] for r in runs[2]):
        steps = [r for r in res["records"] if r["event"] == "step"]
        got = [(s["samples"], s["tokens_per_s"] * s["wall_s"]) for s in steps]
        for (samples, tokens), (jax_samples, jax_tokens) in zip(got, want):
            assert samples == jax_samples
            assert tokens == pytest.approx(jax_tokens, rel=1e-9)


# ---------------------------------------------------------------------------
# Sharding strategies, DeepSpeed stages and DDP's settings
# ---------------------------------------------------------------------------

STRATEGY_CASES = [(world, name) for world in (2, 4) for name in STRATEGIES[world]]


@pytest.mark.parametrize("world,name", STRATEGY_CASES, ids=[f"{n}{w}" for w, n in STRATEGY_CASES])
def test_strategies_match_jax(runs, world, name):
    """Three steps of each strategy and DeepSpeed stage: losses and grad
    norms within rtol 1e-4 of the JAX package's run of the same plugin,
    the parameters after them (_assert_params_close, and equal on every
    process), and FSDP2 sharding exactly what the JAX plan shards (nothing
    under NO_SHARD and stage 0, which run DDP)."""
    kind, _, ref = STRATEGIES[world][name]
    results = runs[world]
    for r in results:
        got = r["strategies"][name]
        np.testing.assert_allclose(np.array(got["metrics"]), np.array(runs["ref"][ref]),
                                   rtol=1e-4)
        assert got["ddp"] == (not got["sharded"])
        _assert_split_is_the_jax_plan(got, runs["plans"][ref]["sharded"])
    _assert_params_close(_flax(results[0]["strategies"][name]["params"]),
                         runs["ref"][ref + "_params"], runs["ctx"]["flax_params"])
    for r in results[1:]:
        for key, value in r["strategies"][name]["params"].items():
            np.testing.assert_array_equal(value, results[0]["strategies"][name]["params"][key])


def test_strategy_plans_follow_jax(runs):
    """The JAX plans the strategies are held to: SHARD_GRAD_OP shards the
    optimizer state of what FULL_SHARD shards, NO_SHARD nothing."""
    plans = {k: v["sharded"] for k, v in runs["plans"].items()}
    assert plans["sgo2"] == plans["sgo4"] == plans["fsdp2"] == plans["hsdp"] != set()
    assert plans["no_shard2"] == set()


def test_min_weight_size_plans_like_jax():
    """min_weight_size_to_shard and the rank-1 rule keep the same parameters
    whole as the JAX planner, at 0, the default 2**11 and 20,000 elements
    (over the tiny Llama's per-layer q_proj, under its stacked one: the
    one place the split differs, as parallel/fsdp.py says)."""
    import jax
    import jax.numpy as jnp

    from accelerate_tpu import FullyShardedDataParallelPlugin as JaxPlugin
    from accelerate_tpu import ParallelismConfig as JaxPC
    from accelerate_tpu.models import LlamaConfig as JaxLlamaConfig
    from accelerate_tpu.models import LlamaForCausalLM as JaxLlama
    from accelerate_tpu.parallel.sharding import plan_parameter_sharding

    from accelerate_tpu_torch.parallel.fsdp import whole_parameters

    module = JaxLlama(JaxLlamaConfig.tiny(dtype=jnp.float32))
    params = jax.eval_shape(lambda: module.init(jax.random.key(0), jnp.zeros((1, 8), jnp.int32))
                            )["params"]
    pc = JaxPC(dp_shard_size=2)
    mesh = pc.build_mesh(jax.devices()[:2])
    port = LlamaForCausalLM(LlamaConfig.tiny(dtype=torch.float32), device="meta")
    names = [n for n, _ in port.named_parameters()]
    for size in (0, 2**11, 20_000):
        want = _jax_plan(plan_parameter_sharding(
            params, mesh, fsdp_plugin=JaxPlugin(min_weight_size_to_shard=size),
            parallelism_config=pc))
        whole = whole_parameters(port, FullyShardedDataParallelPlugin(
            min_weight_size_to_shard=size), 2)
        got = _flax_stacked(n for n in names if n not in whole)
        if size == 20_000:  # q and o: 16,384 elements a layer, 32,768 stacked
            assert want - got == {f"model/layers/block/self_attn/{p}/kernel"
                                  for p in ("q_proj", "o_proj")}
            assert got <= want
        else:
            assert got == want


def test_deepspeed_stages_map_as_in_jax(tmp_path):
    """Each ZeRO stage maps to the JAX package's strategy, and from_ds_json
    reads a ds_config as the JAX package's does ("auto" values, the
    mixed-precision sections, offload)."""
    import json

    from accelerate_tpu.utils.dataclasses import DeepSpeedPlugin as JaxDeepSpeedPlugin

    for stage in range(4):
        assert (DeepSpeedPlugin(zero_stage=stage).to_fsdp_plugin().sharding_strategy
                == JaxDeepSpeedPlugin(zero_stage=stage).to_fsdp_plugin().sharding_strategy)
    configs = {
        "zero3": {"zero_optimization": {"stage": 3, "offload_param": {"device": "cpu"}},
                  "bf16": {"enabled": "auto"}, "gradient_accumulation_steps": 4,
                  "gradient_clipping": 1.0, "optimizer": {"type": "AdamW"}},
        "auto": {"zero_optimization": {"stage": "auto"}, "fp16": {"enabled": "auto"},
                 "gradient_accumulation_steps": "auto", "gradient_clipping": "auto"},
        "none": {"train_batch_size": 8},
    }
    fields = ("zero_stage", "offload_optimizer_device", "offload_param_device",
              "gradient_accumulation_steps", "gradient_clipping", "mixed_precision")
    for name, cfg in configs.items():
        path = tmp_path / f"{name}.json"
        path.write_text(json.dumps(cfg))
        for mp in (None, "bf16", "fp16"):
            port, ref = DeepSpeedPlugin.from_ds_json(str(path), mp), \
                JaxDeepSpeedPlugin.from_ds_json(str(path), mp)
            assert [getattr(port, f) for f in fields] == [getattr(ref, f) for f in fields]
            assert (port.to_fsdp_plugin().cpu_offload, port.to_fsdp_plugin().sharding_strategy) \
                == (ref.to_fsdp_plugin().cpu_offload, ref.to_fsdp_plugin().sharding_strategy)
    acc = Accelerator(cpu=True, deepspeed_plugin=DeepSpeedPlugin.from_ds_json(
        str(tmp_path / "zero3.json")))
    assert acc.gradient_accumulation_steps == 4 and acc._ds_gradient_clipping == 1.0
    assert acc.fsdp_plugin.sharding_strategy == "FULL_SHARD" and acc.fsdp_plugin.cpu_offload


def test_sharding_strategy_names_and_codes():
    from accelerate_tpu.utils.dataclasses import FullyShardedDataParallelPlugin as JaxPlugin

    from accelerate_tpu_torch import ShardingStrategy

    for code, name in zip("1234", ShardingStrategy.list()):
        for value in (code, name, name.lower(), ShardingStrategy(name)):
            port, ref = FullyShardedDataParallelPlugin(sharding_strategy=value), \
                JaxPlugin(sharding_strategy=value)
            assert port.sharding_strategy == ref.sharding_strategy == name
            assert (port.shards_params, port.shards_grads_and_opt) == (
                ref.shards_params, ref.shards_grads_and_opt)
    with pytest.raises(ValueError, match="sharding_strategy"):
        FullyShardedDataParallelPlugin(sharding_strategy="ZERO9")


def test_ddp_kwargs_reach_ddp(runs):
    """DistributedDataParallelKwargs' bucket size, unused-parameter search,
    bucket views and static graph are DDP's own, without a plugin and
    under NO_SHARD; a comm_hook is taken (tests/test_torch_comm_hooks.py
    runs it) and an unknown one refused by the reducer."""
    for r in runs[2]:
        for name, kw in DDP_KWARGS.items():
            got = r["ddp_kwargs"][name]
            assert got["type"] == "DistributedDataParallel" and not got["sharded"]
            want = {**{k: v for k, v in DistributedDataParallelKwargs().ddp_kwargs().items()}, **kw}
            assert {k: got[k] for k in want} == want
    assert DistributedDataParallelKwargs(comm_hook="powersgd").comm_hook == "powersgd"
    from accelerate_tpu_torch.parallel.comm_hooks import make_comm_hook_reducer

    with pytest.raises(ValueError, match="comm_hook"):
        make_comm_hook_reducer("gzip")


# ---------------------------------------------------------------------------
# DISTRIBUTED_STATE_DICT across world sizes
# ---------------------------------------------------------------------------


def _assert_states_equal(got, want):
    assert (got["step"], got["count"]) == (want["step"], want["count"])
    for name, value in want["params"].items():
        np.testing.assert_array_equal(got["params"][name], value, err_msg=name)
        for k, m in want["moments"][name].items():
            np.testing.assert_array_equal(got["moments"][name][k], m, err_msg=f"{name} {k}")


def test_dcp_saved_at_world4_loads_at_world2(runs):
    """The DCP checkpoint 4 FSDP2 processes wrote after step 2 (each its own
    shards, no model.safetensors), loaded by 2: every parameter, moment,
    count and step equal, and step 3 the uninterrupted run's (rtol 1e-5)."""
    ckpt = _dcp_ckpt(runs["ctx"])
    assert "distributed_state_torch" in os.listdir(ckpt)
    assert not {"model.safetensors", "optimizer.bin"} & set(os.listdir(ckpt))
    saved = runs[4][0]["dcp_save"]
    assert saved["format"] == "dcp"
    for r in runs[2]:
        loaded = r["dcp_load"]
        _assert_states_equal(loaded["state_at_load"], saved["state_at_save"])
        np.testing.assert_allclose(loaded["metrics"], saved["metrics"][2:], rtol=1e-5)
        assert loaded["step"] == STEPS and loaded["dtensors"]


def test_dcp_saved_at_world4_loads_in_one_process(runs):
    from accelerate_tpu_torch.state import PartialState as P

    saved = runs[4][0]["dcp_save"]
    cfg = LlamaConfig.tiny(dtype=torch.float32)
    acc = Accelerator(cpu=True)
    assert not P().use_distributed
    acc.prepare(Model(LlamaForCausalLM(cfg)), adamw(LR))
    step = acc.prepare_train_step(_port_loss, max_grad_norm=1.0)
    acc.load_state(_dcp_ckpt(runs["ctx"]))
    _assert_states_equal(_whole_state(acc), saved["state_at_save"])
    _, m = step(acc.train_state, runs["ctx"]["batches"][2])
    np.testing.assert_allclose([float(m["loss"]), float(m["grad_norm"])], saved["metrics"][2],
                               rtol=1e-5)


def test_async_dcp_save_across_processes(runs):
    """save_state(block=False) returned with the save in flight, two steps
    ran before wait_for_checkpoint, and the checkpoint holds the state at
    the save; the third save, queued behind the second, holds the state
    after the steps, and end_training drained it."""
    for r in runs[2]:
        res = r["dcp_async"]
        assert res["in_flight"] and res["drained"]
        assert res["at_save"]["step"] == 1 and res["after"]["step"] == 3
        _assert_states_equal(res["loaded"][0], res["at_save"])
        _assert_states_equal(res["loaded"][1], res["after"])


def test_verify_operation_checks_shapes_across_processes(runs):
    """In debug mode a collective whose leaves differ in shape on one
    process raises ``DistributedOperationException`` on every process,
    naming it, as the JAX package's ``verify_operation`` does."""
    for rank, out in enumerate(runs[2]):
        res = out["verify"]
        assert res["debug"] and res["unwrapped"]
        assert res["equal"] == [0.0, 0.0, 1.0, 1.0]
        assert "Operation: `gather`" in res["error"]
        assert "Process 0: [2]" in res["error"] and "Process 1: [3]" in res["error"]
        assert res["error"].endswith("Mismatched processes: [1]")


@pytest.mark.parametrize("run", sorted(RESNET_RUNS))
def test_sync_batch_norm_uses_the_global_batch(runs, run):
    """ResNet's BatchNorm at 2 processes normalises with the global batch's
    statistics, as GSPMD makes the JAX step's: every process's running
    statistics within 1e-5 of the JAX step's on the whole batch (equal on
    both processes), losses and grad norms within rtol 1e-4."""
    want = runs["ref"]["resnet_" + run]
    for r in runs[2]:
        got = r["sync_bn"][run]
        assert got["ddp"] == (run == "ddp") and got["sharded"] == (run == "fsdp2")
        np.testing.assert_allclose(np.array(got["metrics"]), np.array(want["metrics"]),
                                   rtol=1e-4)
        assert got["stats"].keys() == want["stats"].keys()
        for k, w in want["stats"].items():
            np.testing.assert_allclose(got["stats"][k], w, rtol=0, atol=1e-5, err_msg=str(k))
            np.testing.assert_array_equal(got["stats"][k], runs[2][0]["sync_bn"][run]["stats"][k])


@pytest.mark.parametrize("family", sorted(ENCODER_LOSSES))
def test_encoder_losses_take_the_global_batch(runs, family):
    """BERT's masked-LM loss divides by the global batch's masked count
    and CLIP's loss contrasts each row with the whole global batch: three
    AdamW steps at 2 processes, under DDP and FSDP2, give the JAX step's
    losses and grad norms on the whole batch within rtol 1e-4. The mean of
    each half's own loss differs from the whole batch's, so a loss taken
    per process would fail."""
    want = runs["ref"]["encoder_" + family]
    assert abs(want["halves"] - want["whole"]) > 1e-3 * abs(want["whole"])
    for r in runs[2]:
        for kind in ("ddp", "fsdp"):
            np.testing.assert_allclose(np.array(r["encoder_losses"][family, kind]),
                                       np.array(want["metrics"]), rtol=1e-4, err_msg=kind)


@pytest.mark.parametrize("family", sorted(UNIT_FAMILIES))
def test_fsdp2_puts_a_unit_on_every_block(runs, family):
    """Fault 7: under FSDP2 at 2 processes every block of every family is
    a unit of its own (GPT-2's ``h``, T5's ``block_{i}``), and the root."""
    n = UNIT_FAMILIES[family]
    for r in runs[2]:
        assert r["units"][family]["blocks"] == r["units"][family]["units"] == n
        assert r["units"][family]["root"]


@pytest.mark.parametrize("family", UNIT_STEPS)
def test_steps_under_the_block_units_keep_the_numbers(runs, family):
    """A step of GPT-2 and T5 under their new units at 2 processes gives
    the one-process step's loss and grad norm on the global batch
    (rtol 1e-4)."""
    acc = Accelerator(cpu=True)
    acc.prepare(Model(_unit_module(family)), adamw(LR))
    step = acc.prepare_train_step(_unit_loss(family), max_grad_norm=1.0)
    _, m = step(acc.train_state, {k: torch.from_numpy(v)
                                  for k, v in _unit_batch(family).items()})
    for r in runs[2]:
        np.testing.assert_allclose(r["units"][family]["metrics"],
                                   (float(m["loss"]), float(m["grad_norm"])), rtol=1e-4)


def test_activation_checkpointing_under_ddp_matches_jax(runs):
    """Fault 6: ``activation_checkpointing`` with ``NO_SHARD`` at 2
    processes (DDP) turns ``config.remat`` on, as the JAX package's
    ``dp_replicate=2`` prepare does: on the prepared module's config, the
    caller's config left alone."""
    assert runs["ref"]["no_shard_remat"] == (True, False)
    for r in runs[2]:
        assert r["units"]["no_shard_remat"] == {"remat": True, "caller": False, "ddp": True}


# ---------------------------------------------------------------------------
# Silent data corruption (sdc.py) in the gangs
# ---------------------------------------------------------------------------


def test_sdc_transient_flip_rolls_back_to_the_fault_free_run(runs):
    """Two replicas vote every step; rank 1's observed digest of step 3 is
    flipped: no majority, both ranks probe, the probe is clean, the run
    rolls back to the checkpoint after step 1 and replays; every step's
    loss and digest, and the parameters at the end, equal the fault-free
    run's bit for bit, on both ranks."""
    for rank in range(2):
        clean, run = runs[2][rank]["sdc"]["clean"], runs[2][rank]["sdc"]["transient"]
        assert [s for s, _, _ in run["losses"]] == [0, 1, 2, 3, 1, 2, 3, 4, 5]
        want = {s: (loss, d) for s, loss, d in clean["losses"]}
        assert all((loss, d) == want[s] for s, loss, d in run["losses"])
        summary = run["summary"]
        assert (summary["mismatches"], summary["probes"], summary["probes_failed"],
                summary["repairs"], run["exit"]) == (1, 1, 0, 1, None)
        for n, p in clean["params"].items():
            assert np.array_equal(run["params"][n], p), n
    assert runs[2][0]["sdc"]["clean"]["losses"] == runs[2][1]["sdc"]["clean"]["losses"]


def test_sdc_sticky_flip_convicts_and_quarantines(runs):
    from accelerate_tpu_torch.sdc import load_quarantine

    bad, peer = runs[2][1]["sdc"]["sticky"], runs[2][0]["sdc"]["sticky"]
    assert bad["exit"] == 79 and bad["summary"]["probes_failed"] == 1
    assert bad["summary"]["quarantines"] == 1
    assert peer["exit"] is None and peer["summary"]["peer_quarantined"]
    hosts = load_quarantine(bad["project"])["hosts"]
    assert [(h["process_index"], h["tick"]) for h in hosts] == [(1, 2)]


def test_sdc_broadcast_repair_with_a_three_rank_majority(runs):
    for rank in range(4):
        clean, run = runs[4][rank]["sdc_broadcast"]["clean"], runs[4][rank]["sdc_broadcast"][
            "broadcast"]
        summary = run["summary"]
        assert (summary["mismatches"], summary["repairs"], summary["probes_failed"]) == (1, 1, 0)
        # No rollback: the steps run on, each the fault-free run's.
        assert [s for s, _, _ in run["losses"]] == list(range(SDC_STEPS))
        assert [x[1:] for x in run["losses"]] == [x[1:] for x in clean["losses"]]
