"""The Accelerator: the port of ``accelerate_tpu/accelerator.py``'s training
surface, in two forms. The fused step:

    acc = Accelerator(mixed_precision="bf16",
                      project_config=ProjectConfiguration(project_dir=run_dir,
                                                          automatic_checkpoint_naming=True))
    schedule = warmup_cosine_decay_schedule(0.0, 3e-4, 100, 10_000)
    model, opt, loader, sched = acc.prepare(
        Model(LlamaForCausalLM(cfg)), adamw(schedule, weight_decay=0.1), train_spec, schedule)
    step = acc.prepare_train_step(loss_fn, max_grad_norm=1.0)   # loss_fn(model, batch)
    state = acc.train_state
    for batch in loader:                                        # tensors on acc.device
        state, metrics = step(state, batch)                     # {"loss", "grad_norm"}
        sched.step()
    acc.save_state()                                            # checkpoints/checkpoint_<i>
    acc.load_state()                                            # the newest, mid-epoch too

and the imperative loop, one microbatch at a time:

    acc = Accelerator(mixed_precision="bf16", gradient_accumulation_steps=4)
    model, opt, loader, sched = acc.prepare(model, adamw(schedule), train_spec, schedule)
    for batch in loader:
        with acc.accumulate(model):
            loss = acc.backward(loss_fn, batch)                 # loss_fn(model, batch)
            acc.clip_grad_norm_(None, 1.0)
            opt.step()                                          # on the window's last batch
            sched.step()
            opt.zero_grad()

The step has the JAX step's semantics: the loss runs on the parameters cast
to the compute dtype, gradients land on the fp32 masters, accumulate over a
leading microbatch split (summed, then divided by the number of
microbatches), are clipped by global norm with
``factor = min(1, max_norm / (norm + 1e-6))``, and the optimizer updates the
masters. The parameters and optimizer state are updated in place (the JAX
step donates its buffers to the same effect). Metrics are device tensors:
reading them waits for the step.

``prepare`` takes models, optimizers, data loaders (anything with a
``dataset``, or iterable with a ``batch_size``) and schedules
(``schedule(count) -> lr``) in any order and returns them in order.

Over a process group (torchrun's environment, ``state.py``), ``prepare``
shards each model with FSDP2 when an ``fsdp_plugin`` is given (HSDP when
``ParallelismConfig.dp_replicate_size > 1``), else replicates it under DDP
(``parallel/fsdp.py``); each process feeds its own share of the batch. The
step then has the same numbers as one process on the whole batch: the
gradients are averaged over processes, the grad norm is the global norm
over every shard, and the loss metric is the mean over processes. With
``ParallelismConfig(cp_size=...)`` or ``sp_size`` the processes of a
``cp``/``sp`` axis share rows and each holds a slice of the sequence
(``parallel/sharding.py``); the model attends over the whole sequence
through ``parallel/cp.py`` or ``parallel/sp.py``. With
``ParallelismConfig(tp_size=...)`` and a model with TP rules
(``Model(module, tp_rules=...)``, each family's ``*_tp_rules``) the
``tp`` ranks share rows and each holds its shards of the split parameters
(``parallel/sharding.py``, ``parallel/tp.py``); FSDP2 (2-D with ``tp``) or
the step's own all-reduce over the data-parallel group averages the
gradients, and the loss is averaged over every axis but ``tp``.
``cross_entropy_loss`` counts the valid labels of every process inside the step
(``operations.global_token_count``), so the loss is the token mean of
the global batch however unevenly ``-100`` labels fall; a loss function
of the user's own that returns its process's mean gets the mean of the
processes' means.
With ``ParallelismConfig(pp_size=...)`` (and ``pp_virtual_stages``)
``prepare`` cuts the Llama chassis to each process's pipeline stage
(``parallel/pp.py``: its layers, the embedding on the first stage, the
final norm and head on the last, a tied embedding on both) and applies the
other axes to that stage's blocks; a loss around ``llama_pipeline_forward``
(or the cut module's own forward) runs the GPipe or interleaved schedule,
the last stage's loss and the global grad norm (squares summed over the
stages, a tied weight's gradient summed over its two stages and counted
once) reach every process. With ``DistributedDataParallelKwargs(
comm_hook="fp16"|"bf16"|"powersgd")`` the step reduces the gradients
through the hook (``_comm_hook_step``, ``parallel/comm_hooks.py``), and
inside a ``LocalSGD`` block (``local_sgd.py``) it trains each process alone.
``gather``, ``gather_for_metrics``, ``reduce`` and ``pad_across_processes``
run the collectives of ``utils/operations.py``. The plugin's
``sharding_strategy`` picks FSDP2, HSDP or DDP (``parallel/fsdp.py``);
``deepspeed_plugin`` is read as a strategy, and
``DistributedDataParallelKwargs`` sets DDP's reducer.

Checkpoints (``checkpointing.py``): ``save_state``/``load_state`` in the
JAX package's directory contract, which either package resumes; under
``DISTRIBUTED_STATE_DICT`` every process writes its own shards with
``torch.distributed.checkpoint``, and ``save_state(block=False)`` returns
once the state is staged in host memory while a thread writes it, until
``wait_for_checkpoint`` (one save in flight at a time).

The imperative loop has the JAX package's semantics as well.
``accumulate`` counts microbatches in ``step`` and sets
``sync_gradients`` on every ``gradient_accumulation_steps``-th one, and
on a loader's last batch with ``sync_with_dataloader``. ``backward(loss_fn,
*args)`` runs the forward itself, as the fused step does (the compute
cast, the loss averaged over processes), backpropagates the loss divided
by the accumulation steps into the fp32 masters' ``grad`` and returns the
loss (the mean over processes). The optimizer that ``prepare`` returns
(``AcceleratedOptimizer``) steps only when ``sync_gradients`` is set.
``clip_grad_norm_`` arms the clip for every later step and returns the
global norm of the gradients accumulated so far; the step then scales
them by ``min(1, max_norm / (norm + 1e-6))``. Over a process group the
microbatches that do not end a window skip the gradient collectives
(FSDP2's ``set_requires_gradient_sync(False)``, DDP's ``no_sync``), unless
``sync_each_batch``; their gradients are then each process's own, so
``clip_grad_norm_`` there arms the clip and returns None.

Reduced precision, as in the JAX package. ``mixed_precision="fp16"``
computes in float16 with dynamic loss scaling (``GradScalerKwargs``,
``train_state.DynamicLossScale``): the loss is multiplied by the scale
before its backward, the gradients are unscaled before their norm and
clip, and a step whose gradients are not all finite (on any process:
the flag is all-reduced with MIN) leaves the parameters, the AdamW moments
and step counts, the schedule's count and ``state.step`` as they were,
while the scale backs off. The skip runs on the card (fused AdamW's
``found_inf``), so the fused step still never waits for it;
``optimizer.step_was_skipped`` reads the flag and waits. Checkpoints
carry the scale in ``scaler.bin``. ``mixed_precision="fp8"`` computes in
bfloat16 and ``fp8_dot_general`` is the recipe's fp8 linear
(``FP8RecipeKwargs``, ``ops/fp8.py``) for custom modules; Llama takes
``LlamaConfig(fp8=True)``.

Observability, as in the JAX package: ``log_with`` names trackers
(``tracking.py``), built by ``init_trackers`` and fed by ``log``;
``kwargs_handlers=[TelemetryKwargs(...)]`` makes ``self.telemetry``
(``telemetry.py``), which the prepared step, ``backward``, the optimizer
step, the prepared loaders and ``save_state``/``load_state`` report to;
``profile()`` traces windows with ``torch.profiler`` after
``ProfileKwargs``. ``end_training`` closes the telemetry, then the
trackers.
"""

from __future__ import annotations

import contextlib
import functools
import os
import shutil
import time
import types
from typing import Callable, Optional, Union

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from .data_loader import BaseDataLoader, prepare_data_loader, skip_first_batches
from .model import Model
from .logging import get_logger
from .optimizer import AcceleratedOptimizer, AdamW
from .parallel import apply_data_parallel
from .parallel.fsdp import (
    apply_activation_checkpointing,
    average_whole_gradients,
    gradient_sync,
)
from .parallel.pp import stage_loss, stage_scope
from .parallel.tp import splits
from .parallelism_config import ParallelismConfig
from .scheduler import AcceleratedScheduler
from .state import AcceleratorState, DistributedType, GradientState
from .tracking import GeneralTracker, filter_trackers
from .train_state import DynamicLossScale, TrainState
from .utils import operations
from .utils.dataclasses import (
    AutocastKwargs,
    DataLoaderConfiguration,
    DeepSpeedPlugin,
    DistributedDataParallelKwargs,
    FP8RecipeKwargs,
    FaultToleranceKwargs,
    FullyShardedDataParallelPlugin,
    GradientAccumulationPlugin,
    GradScalerKwargs,
    InitProcessGroupKwargs,
    KwargsHandler,
    MixedPrecisionPolicy,
    ProfileKwargs,
    ProjectConfiguration,
    TelemetryKwargs,
)

logger = get_logger(__name__)


def _microbatch_split(batch: dict, num_accum: int) -> list[dict]:
    """(B, ...) → num_accum microbatches of B/num_accum rows, taken as the JAX
    step takes them: reshape to (B/num_accum, num_accum, ...) and index the
    second axis, so microbatch i holds rows i, i + num_accum, ..."""
    b = next(iter(batch.values())).shape[0]
    if b % num_accum:
        raise ValueError(f"Batch dim {b} not divisible by gradient accumulation steps {num_accum}.")
    views = {k: v.reshape(b // num_accum, num_accum, *v.shape[1:]) for k, v in batch.items()}
    return [{k: v[:, i] for k, v in views.items()} for i in range(num_accum)]


def _scaled(loss: torch.Tensor, loss_scale) -> torch.Tensor:
    """The loss times the fp16 loss scale, or the loss without one."""
    return loss if loss_scale is None else loss * loss_scale.scale


def _is_dataloader_like(obj) -> bool:
    if isinstance(obj, BaseDataLoader):
        return True
    return hasattr(obj, "dataset") or (hasattr(obj, "__iter__") and hasattr(obj, "batch_size"))


def _is_schedule(obj) -> bool:
    return callable(obj) and not isinstance(obj, (Model, AdamW)) and not _is_dataloader_like(obj)


def _local(t: torch.Tensor) -> torch.Tensor:
    """The process's own part of a (possibly sharded) tensor."""
    return t.to_local() if isinstance(t, DTensor) else t


def _global_norm(grads: list, pipeline_group=None, skip=frozenset()) -> torch.Tensor:
    """The L2 norm over every gradient, whole or sharded, with the
    one-process step's arithmetic: the norm of the per-tensor norms, in the
    parameters' order. A sharded gradient's norm (FSDP2's DTensors) is the
    root of its shards' squared norms summed over the mesh dims it is
    sharded on (FSDP2's dim and, under ``tp``, the ``tp`` one: a split
    gradient's shards count once), not over a replicated one (HSDP's
    ``dp_replicate × sp``; a ``tp``-replicated gradient, equal on every
    ``tp`` rank; an expert stack split over ep is summed over its ep
    slice alone, not over ``tp`` again):
    one all-reduce for all of them. Whole ones (DDP's, and the parameters
    FSDP2 leaves whole) are equal on every process after their
    all-reduce, so the local norm is theirs. Over a group of one the
    result is the one-process step's bit for bit. Under ``pp`` each stage
    holds its own gradients: the squares are summed over
    ``pipeline_group`` too, without the gradients in ``skip`` (by id: a
    weight two stages hold counts once)."""
    norms = list(torch._foreach_norm([_local(g) for g in grads]))
    by_layout: dict = {}
    for i, g in enumerate(grads):
        if isinstance(g, DTensor):
            by_layout.setdefault((g.device_mesh, tuple(g.placements)), []).append(i)
    for (mesh, placements), idx in by_layout.items():
        dims = [d for d, p in enumerate(placements) if splits(p) and mesh.size(d) > 1]
        if not dims:
            continue
        sq = torch.stack([norms[i] for i in idx]).square()
        if mesh.device_type == "cuda" and not sq.is_cuda:  # CPU-offloaded shards
            sq = sq.cuda()
        for d in dims:
            operations.all_reduce(sq, group=mesh.get_group(d))
        for i, n in zip(idx, sq.sqrt().to(norms[idx[0]].device).unbind()):
            norms[i] = n
    device = norms[0].device
    if pipeline_group is None:
        return torch.linalg.vector_norm(torch.stack([n.to(device) for n in norms]))
    kept = [n.to(device) for n, g in zip(norms, grads) if id(g) not in skip]
    sq = (torch.stack(kept).square().sum() if kept
          else torch.zeros((), dtype=norms[0].dtype, device=device))
    operations.all_reduce(sq, group=pipeline_group)
    return sq.sqrt()


class _HookHandle:
    def __init__(self, registry: list, hook):
        self._registry, self._hook = registry, hook

    def remove(self):
        if self._hook in self._registry:
            self._registry.remove(self._hook)


class Accelerator:
    def __init__(
        self,
        mixed_precision: Optional[str] = None,
        gradient_accumulation_steps: int = 1,
        cpu: bool = False,
        parallelism_config: Optional[ParallelismConfig] = None,
        fsdp_plugin: Optional[FullyShardedDataParallelPlugin] = None,
        split_batches: bool = False,
        dataloader_config: Optional[DataLoaderConfiguration] = None,
        project_dir: Optional[str] = None,
        project_config: Optional[ProjectConfiguration] = None,
        gradient_accumulation_plugin: Optional[GradientAccumulationPlugin] = None,
        step_scheduler_with_optimizer: bool = True,
        log_with=None,
        kwargs_handlers: Optional[list[KwargsHandler]] = None,
        deepspeed_plugin: Optional[DeepSpeedPlugin] = None,
    ):
        # A DeepSpeed ZeRO stage is a sharding strategy (DeepSpeedPlugin),
        # taken when no fsdp_plugin is given, as in the JAX package; its
        # accumulation steps and clipping apply unless set here, as the
        # DeepSpeed engine applied them.
        self._ds_gradient_clipping = None
        if deepspeed_plugin is not None:
            if fsdp_plugin is None:
                fsdp_plugin = deepspeed_plugin.to_fsdp_plugin()
            if (gradient_accumulation_steps == 1 and gradient_accumulation_plugin is None
                    and deepspeed_plugin.gradient_accumulation_steps > 1):
                gradient_accumulation_steps = deepspeed_plugin.gradient_accumulation_steps
            self._ds_gradient_clipping = deepspeed_plugin.gradient_clipping
        self.deepspeed_plugin = deepspeed_plugin
        # fsdp_plugin shards the models over a process group (FSDP2, or DDP
        # under NO_SHARD); alone, only its state_dict_type acts (the
        # checkpoint's format).
        self.fsdp_plugin = fsdp_plugin
        self.project_configuration = project_config or ProjectConfiguration(project_dir=project_dir)
        if project_dir is not None and self.project_configuration.project_dir is None:
            self.project_configuration.set_directories(project_dir)
        self.profile_handler: Optional[ProfileKwargs] = None
        self.telemetry_handler: Optional[TelemetryKwargs] = None
        self.scaler_handler: Optional[GradScalerKwargs] = None
        self.fp8_recipe_handler: Optional[FP8RecipeKwargs] = None
        self.ddp_handler: Optional[DistributedDataParallelKwargs] = None
        # Taken and not read, as in the JAX package.
        self.init_handler: Optional[InitProcessGroupKwargs] = None
        self.autocast_handler: Optional[AutocastKwargs] = None
        self.fault_tolerance_handler: Optional[FaultToleranceKwargs] = None
        for handler in kwargs_handlers or []:
            if isinstance(handler, ProfileKwargs):
                self.profile_handler = handler
            elif isinstance(handler, TelemetryKwargs):
                self.telemetry_handler = handler
            elif isinstance(handler, GradScalerKwargs):
                self.scaler_handler = handler
            elif isinstance(handler, FP8RecipeKwargs):
                self.fp8_recipe_handler = handler
            elif isinstance(handler, DistributedDataParallelKwargs):
                self.ddp_handler = handler
            elif isinstance(handler, InitProcessGroupKwargs):
                self.init_handler = handler
            elif isinstance(handler, AutocastKwargs):
                self.autocast_handler = handler
            elif isinstance(handler, FaultToleranceKwargs):
                self.fault_tolerance_handler = handler
            else:
                raise NotImplementedError(
                    f"kwargs handler {type(handler).__name__} is not ported yet (ROADMAP.md "
                    "Queue A item 12: CompileKwargs with item 12.4, ElasticKwargs and "
                    "AutoPlanKwargs with item 12.3)")
        if mixed_precision is not None:
            mixed_precision = str(mixed_precision)  # a PrecisionType member too
        self._mp_policy = MixedPrecisionPolicy.from_mixed_precision(mixed_precision)
        self.state = AcceleratorState(
            mixed_precision=mixed_precision, cpu=cpu, parallelism_config=parallelism_config)
        # The plugin, when given, decides; as in the JAX package.
        self.gradient_state = GradientState(
            gradient_accumulation_plugin
            or GradientAccumulationPlugin(num_steps=gradient_accumulation_steps))
        self.step_scheduler_with_optimizer = step_scheduler_with_optimizer
        self.dataloader_config = dataloader_config or DataLoaderConfiguration(
            split_batches=split_batches)
        self._train_states: list[TrainState] = []
        self._models: list[Model] = []
        self._optimizers: list[AcceleratedOptimizer] = []
        self._schedulers: list[AcceleratedScheduler] = []
        self._dataloaders: list[BaseDataLoader] = []
        self._custom_objects: list = []
        self._save_state_pre_hooks: list[Callable] = []
        self._load_state_pre_hooks: list[Callable] = []
        # Microbatches of the imperative loop since the last window ended
        # (accumulate); saved and restored with a checkpoint.
        self.step = 0
        # The imperative loop's clip, armed by clip_grad_norm_ for every
        # later step, and whether the gradients are each process's own (a
        # window that skips the collectives).
        self._max_grad_norm: Optional[float] = None
        self._grads_local = False
        # Under pp, the window's tied-weight gradients once summed over the
        # edge group: the ids the norm leaves out (None: not summed yet).
        self._pp_skip: Optional[frozenset] = None
        # Inside a LocalSGD block the fused step trains this process alone.
        self._local_sgd_active = False
        # Each slot's comm-hook state (parallel/comm_hooks.py), by slot.
        self._comm_hook_states: list = []
        self.flag_tensor: Optional[torch.Tensor] = None
        # The last save_state/load_state: its directory and seconds, split
        # into host copies and disk; a save also counts its bytes.
        self.checkpoint_stats: Optional[dict] = None
        # A save_state(block=False) still writing, and the stager that keeps
        # its host copies for the next one (checkpointing.py).
        self._pending_save: Optional[dict] = None
        self._dcp_stager = None
        # Trackers (tracking.py): resolved now, built by init_trackers.
        self.log_with = filter_trackers(log_with, self.project_configuration.logging_dir)
        self.trackers: list[GeneralTracker] = []
        # Step telemetry (telemetry.py): without a TelemetryKwargs handler
        # every hook is one None check.
        self.telemetry = None
        if self.telemetry_handler is not None and self.telemetry_handler.enabled:
            from .telemetry import TelemetryRecorder

            self.telemetry = TelemetryRecorder(self, self.telemetry_handler)
        # Fault tolerance (fault_tolerance.py): atomic verified checkpoints,
        # preemption saves, save retries, the divergence sentinel, the
        # watchdog, chaos and SDC. Without a handler every hook is one None
        # check and checkpoints are written as before.
        self.fault_tolerance = None
        if self.fault_tolerance_handler is not None and self.fault_tolerance_handler.enabled:
            from .fault_tolerance import FaultToleranceManager

            self.fault_tolerance = FaultToleranceManager(self, self.fault_tolerance_handler)

    @property
    def device(self) -> torch.device:
        return self.state.device

    @property
    def num_processes(self) -> int:
        return self.state._partial.num_processes

    @property
    def process_index(self) -> int:
        return self.state._partial.process_index

    @property
    def local_process_index(self) -> int:
        return self.state._partial.local_process_index

    @property
    def is_main_process(self) -> bool:
        return self.process_index == 0

    @property
    def is_last_process(self) -> bool:
        return self.state._partial.is_last_process

    @property
    def distributed_type(self) -> DistributedType:
        return self.state._partial.distributed_type

    @property
    def use_distributed(self) -> bool:
        return self.state._partial.use_distributed

    @property
    def mixed_precision(self) -> str:
        return self.state.mixed_precision

    @property
    def split_batches(self) -> bool:
        return self.dataloader_config.split_batches

    @property
    def even_batches(self) -> bool:
        return self.dataloader_config.even_batches

    @property
    def sync_gradients(self) -> bool:
        return self.gradient_state.sync_gradients

    @property
    def gradient_accumulation_steps(self) -> int:
        return self.gradient_state.num_steps

    @gradient_accumulation_steps.setter
    def gradient_accumulation_steps(self, value: int):
        self.gradient_state.plugin_kwargs.update({"num_steps": value})

    @property
    def optimizer_step_was_skipped(self) -> bool:
        """Whether the last optimizer step overflowed under fp16 loss
        scaling (reading it waits for the card)."""
        return any(opt.step_was_skipped for opt in self._optimizers)

    @property
    def fp8_dot_general(self):
        """The recipe's fp8 linear for custom modules, ``linear(x, w) = x @
        wᵀ`` (``ops/fp8.py``), or None unless ``mixed_precision="fp8"``. The
        recipe's format, eval policy and backend act; its delayed-scaling
        fields do not (current scaling, as in the JAX package)."""
        if self.mixed_precision != "fp8":
            return None
        from .ops.fp8 import fp8_dot_general

        recipe = self.fp8_recipe_handler
        return fp8_dot_general(
            recipe.fp8_format if recipe else "HYBRID",
            use_during_eval=recipe.use_during_eval if recipe else False,
            native=recipe.native_dots if recipe else None)

    # This process's coordinate on a mesh axis, as the JAX package names them.

    @property
    def data_parallel_rank(self) -> int:
        return self.state.axis_rank("dp_replicate")

    @property
    def data_parallel_shard_rank(self) -> int:
        return self.state.axis_rank("dp_shard")

    @property
    def context_parallel_rank(self) -> int:
        return self.state.axis_rank("cp")

    @property
    def tensor_parallel_rank(self) -> int:
        return self.state.axis_rank("tp")

    @property
    def pipeline_parallel_rank(self) -> int:
        return self.state.axis_rank("pp")

    @property
    def mesh(self):
        """The 5-D ``DeviceMesh`` over the process group, or None without
        one."""
        return self.state.device_mesh

    @property
    def parallelism_config(self) -> ParallelismConfig:
        return self.state.parallelism_config

    @property
    def is_local_main_process(self) -> bool:
        return self.local_process_index == 0

    def wait_for_everyone(self) -> None:
        self.state._partial.wait_for_everyone()

    # Process control: PartialState's helpers.

    def on_main_process(self, function):
        return self.state._partial.on_main_process(function)

    def on_local_main_process(self, function):
        return self.state._partial.on_local_main_process(function)

    def on_last_process(self, function):
        return self.state._partial.on_last_process(function)

    def on_process(self, function=None, process_index=None):
        if function is None:
            return functools.partial(self.on_process, process_index=process_index)
        return self.state._partial.on_process(function, process_index)

    def on_local_process(self, function=None, local_process_index=None):
        if function is None:
            return functools.partial(self.on_local_process,
                                     local_process_index=local_process_index)
        return self.state._partial.on_local_process(function, local_process_index)

    @contextlib.contextmanager
    def main_process_first(self):
        with self.state._partial.main_process_first():
            yield

    @contextlib.contextmanager
    def local_main_process_first(self):
        with self.state._partial.local_main_process_first():
            yield

    def split_between_processes(self, inputs, apply_padding: bool = False):
        return self.state._partial.split_between_processes(inputs, apply_padding=apply_padding)

    def print(self, *args, **kwargs):
        self.state._partial.print(*args, **kwargs)

    @property
    def project_dir(self) -> Optional[str]:
        return self.project_configuration.project_dir

    @property
    def logging_dir(self) -> Optional[str]:
        return self.project_configuration.logging_dir

    @property
    def save_iteration(self) -> int:
        return self.project_configuration.iteration

    # The loader settings, as the JAX package exposes them.

    @property
    def dispatch_batches(self) -> Optional[bool]:
        return self.dataloader_config.dispatch_batches

    @property
    def use_seedable_sampler(self) -> bool:
        return self.dataloader_config.use_seedable_sampler

    @property
    def non_blocking(self) -> bool:
        return self.dataloader_config.non_blocking

    @property
    def train_state(self) -> TrainState:
        if not self._train_states:
            raise RuntimeError("Call accelerator.prepare(model, optimizer) first.")
        return self._train_states[0]

    # ------------------------------------------------------------------
    # prepare()
    # ------------------------------------------------------------------

    def prepare(self, *args):
        """Prepare models, optimizers, data loaders and schedules, returning
        them in the order given. Each optimizer is built on the parameters of
        the model before it; loaders and schedules may come anywhere."""
        for obj in args:
            if isinstance(obj, Model) and self.verify_device_map(obj):
                # A model dispatched over the card, the host and the disk
                # holds no trainable parameters a process group can shard.
                raise ValueError(
                    "You can't train a model that has been dispatched with a "
                    "multi-placement device_map (offloaded to cpu/disk). Load the "
                    "model on-device (or shard it with a ParallelismConfig mesh) "
                    "before calling prepare().")
        out, model = list(args), None
        for i, obj in enumerate(args):
            if isinstance(obj, Model):
                model = self.prepare_model(obj)
            elif isinstance(obj, (AdamW, torch.optim.Optimizer)):
                if model is None:
                    raise ValueError("prepare() needs the model before its optimizer")
                out[i] = self._prepare_optimizer_for(model, obj)
        for i, obj in enumerate(args):
            if isinstance(obj, (Model, AdamW, torch.optim.Optimizer)):
                continue
            if _is_dataloader_like(obj):
                out[i] = self.prepare_data_loader(obj)
            elif isinstance(obj, AcceleratedScheduler) or _is_schedule(obj):
                out[i] = self.prepare_scheduler(obj)
            else:
                raise TypeError(f"prepare() does not take {type(obj).__name__}")
        self._maybe_elastic_resume()
        if self.fault_tolerance is not None:
            # Every process runs prepare(); the launcher signals the whole gang.
            self.fault_tolerance.install_signal_handlers()
            self.fault_tolerance.start_watchdog()
        return out[0] if len(out) == 1 else tuple(out)

    def _maybe_elastic_resume(self) -> None:
        """``ProjectConfiguration(automatic_resume=True)``: a relaunched run
        (``ACCELERATE_RESTART_ATTEMPT > 0``) with automatic checkpoint naming
        restores the newest checkpoint right after the ``prepare()`` that
        gave it an optimizer, once; with none (or only an interrupted
        ``.tmp``) it starts fresh. Under fault tolerance the verified
        resolver refuses a checkpoint of another world size or layout
        (``fault_tolerance.py``, ROADMAP.md Queue A item 12.3)."""
        from .checkpointing import _list_checkpoint_dirs

        pc = self.project_configuration
        if not (pc.automatic_resume and pc.automatic_checkpoint_naming):
            return
        if getattr(self, "_elastic_resumed", False) or not self._train_states:
            return
        attempt = int(os.environ.get("ACCELERATE_RESTART_ATTEMPT", "0") or 0)
        if attempt <= 0:
            return
        self._elastic_resumed = True
        base = os.path.join(self.project_dir or ".", "checkpoints")
        if not os.path.isdir(base) or not _list_checkpoint_dirs(base):
            logger.warning("automatic_resume: restart attempt %d but no checkpoints under %s: "
                           "starting fresh.", attempt, base)
            return
        loaded = self.load_state()
        logger.info("automatic_resume: restart attempt %d resumed from %s (step %d)", attempt,
                    loaded, int(self._train_states[0].step))

    def prepare_model(self, model: Model, device_placement=None,
                      evaluation_mode: bool = False) -> Model:
        """``model`` on this process's device, sharded or replicated over
        the process group as ``prepare`` does it; prepared once. The
        plugin's ``activation_checkpointing`` turns the module's remat on
        first, with or without a group."""
        if model not in self._models:
            if self.fsdp_plugin is not None and self.fsdp_plugin.activation_checkpointing:
                apply_activation_checkpointing(model.module)
            model.module.to(self.device)
            apply_data_parallel(model, self.state, self.fsdp_plugin,
                                self._mp_policy.compute_dtype, self.ddp_handler)
            self._models.append(model)
        return model

    def prepare_optimizer(self, optimizer, device_placement=None) -> AcceleratedOptimizer:
        """``optimizer`` built on (or bound to) the first prepared model
        that has none yet, as ``prepare(model, optimizer)`` binds it."""
        if isinstance(optimizer, AcceleratedOptimizer) and optimizer in self._optimizers:
            return optimizer
        bound = {id(st.model) for st in self._train_states}
        model = next((m for m in self._models if id(m) not in bound), None)
        if model is None:
            raise ValueError("prepare_optimizer() needs a prepared model without an optimizer: "
                             "call prepare_model(model) first")
        return self._prepare_optimizer_for(model, optimizer)

    def _prepare_optimizer_for(self, model: Model, obj) -> AcceleratedOptimizer:
        if (model.sharded or model.tp_plan) and not isinstance(obj, AdamW):
            raise ValueError("under FSDP2 or tp pass adamw(...), so that prepare() builds "
                             "the optimizer on the sharded parameters")
        if isinstance(obj, AcceleratedOptimizer):
            obj = obj.optimizer
        loss_scale = self._new_loss_scale()
        if isinstance(obj, AdamW):
            opt = obj(model.parameters(), skip_on_overflow=loss_scale is not None)
        else:
            opt = obj
            if loss_scale is not None and not getattr(opt, "_step_supports_amp_scaling", False):
                raise ValueError(
                    "mixed_precision='fp16' skips an overflowed step on the device: "
                    "pass adamw(...) or a fused torch optimizer (fused=True)")
        # The train state (the fused step, checkpoints) keeps the optimizer
        # itself; the caller gets the imperative loop's.
        step = (0 if loss_scale is None
                else torch.zeros((), dtype=torch.int32, device=self.device))
        self._train_states.append(TrainState(step=step, model=model, optimizer=opt,
                                             loss_scale=loss_scale,
                                             extra_state=model.extra_state))
        self._optimizers.append(AcceleratedOptimizer(opt, accelerator=self))
        return self._optimizers[-1]

    def _new_loss_scale(self) -> Optional[DynamicLossScale]:
        """The dynamic loss scale of ``mixed_precision="fp16"`` (the
        ``GradScalerKwargs`` handler's settings), or None."""
        if self.mixed_precision != "fp16":
            return None
        kw = self.scaler_handler.to_kwargs() if self.scaler_handler else {}
        if not kw.pop("enabled", True):
            return None
        return DynamicLossScale.create(device=self.device, **kw)

    def prepare_data_loader(self, data_loader):
        """This package's loader over ``data_loader``, placing batches on
        ``self.device``; registered for checkpoints. Samples are dealt over
        the data-parallel processes, and each process keeps its slice of
        the sequence over ``cp``/``sp``."""
        if isinstance(data_loader, BaseDataLoader):
            prepared = data_loader
        else:
            cfg = self.dataloader_config
            prepared = prepare_data_loader(
                data_loader, device=self.device, num_processes=self.state.data_parallel_size,
                process_index=self.state.data_parallel_index,
                sequence_shard=self.state.sequence_shard, split_batches=cfg.split_batches,
                dispatch_batches=cfg.dispatch_batches,
                even_batches=cfg.even_batches, use_seedable_sampler=cfg.use_seedable_sampler,
                data_seed=cfg.data_seed, non_blocking=cfg.non_blocking,
                prefetch_size=cfg.prefetch_size, dispatch_group_size=cfg.dispatch_group_size)
        if prepared not in self._dataloaders:
            self._dataloaders.append(prepared)
        prepared._telemetry = self.telemetry  # the loader's wait goes to add_data_wait
        prepared._fault_tolerance = self.fault_tolerance  # chaos corrupt_batch
        return prepared

    def prepare_scheduler(self, scheduler) -> AcceleratedScheduler:
        if isinstance(scheduler, AcceleratedScheduler):
            wrapped = scheduler
        else:
            wrapped = AcceleratedScheduler(
                scheduler, optimizers=self._optimizers or None,
                step_with_optimizer=self.step_scheduler_with_optimizer,
                split_batches=self.dataloader_config.split_batches)
        if wrapped not in self._schedulers:
            self._schedulers.append(wrapped)
        return wrapped

    def skip_first_batches(self, dataloader, num_batches: int = 0):
        return skip_first_batches(dataloader, num_batches)

    def verify_device_map(self, model) -> bool:
        """True when ``model`` was dispatched (``big_modeling``) with a
        device map of more than one placement; ``prepare`` refuses such a
        model."""
        from .big_modeling import DispatchedModel
        from .utils.modeling import placement_key

        if not isinstance(model, DispatchedModel):
            return False
        return len({placement_key(p) for p in model.device_map.values()}) > 1

    def unwrap_model(self, model: Model) -> torch.nn.Module:
        return model.module if isinstance(model, Model) else model

    # ------------------------------------------------------------------
    # The train step
    # ------------------------------------------------------------------

    def _place(self, v) -> torch.Tensor:
        """A host value (numpy array, host tensor) on the device; a tensor a
        prepared loader already placed passes as it is."""
        if torch.is_tensor(v) and v.device == self.device:
            return v
        return torch.as_tensor(v if torch.is_tensor(v) else np.asarray(v)).to(
            self.device, non_blocking=True)

    def _to_device(self, batch: dict) -> dict:
        return {k: self._place(v) for k, v in batch.items()}

    def prepare_train_step(self, loss_fn: Callable, *, has_aux: bool = False,
                           mutable_state: bool = False,
                           max_grad_norm: Optional[float] = None,
                           donate: Optional[bool] = None, model: Optional[Model] = None):
        """``step(state, batch) -> (state, {"loss", "grad_norm"})`` around
        ``loss_fn(model, batch) -> scalar loss``. Over a process group each
        process passes its own share of the global batch
        (``parallel.sharding.local_batch``). The losses and gradients are
        averaged over the processes of ``ParallelismConfig.loss_reduce_axes``
        (every process but other ``tp`` ranks of the same rows). Under fp16 loss
        scaling the loss is the unscaled one and the norm that of the
        unscaled gradients; an overflowed step is skipped on the card.
        Without ``max_grad_norm`` a ``DeepSpeedPlugin``'s
        ``gradient_clipping`` clips.

        The JAX package's options:

        - ``has_aux``: ``loss_fn`` returns ``(loss, aux)``; the step uses the
          loss and drops the aux, as the JAX step does (its metrics stay
          ``{"loss", "grad_norm"}``).
        - ``mutable_state``: ``loss_fn(model, extra_state, batch) -> (loss,
          new_extra_state)`` for a model whose forward updates non-parameter
          collections (BatchNorm's ``batch_stats``, ``models.resnet_loss``).
          The state's ``extra_state`` goes in, each microbatch of an
          accumulation window gets the one the previous returned (the JAX
          step's ``scan`` carry), and the last is stored in
          ``state.extra_state`` (the model's buffers, in place). Over
          several processes BatchNorm normalises with the global batch's
          statistics, as GSPMD makes the JAX step's (``FlaxBatchNorm``).
          Exclusive with ``has_aux``.
        - ``model``: the step of that prepared model's slot (its optimizer
          and state); the first model's by default. The state carries its
          model and optimizer, so the step advances the state it is passed,
          and it refuses one of another slot.
        - ``donate``: taken for the signature. Eager PyTorch already updates
          the parameters and optimizer state in place, which is what the
          JAX step's donated buffers buy."""
        if not self._train_states:
            raise RuntimeError("Call accelerator.prepare(...) first.")
        if mutable_state and has_aux:
            raise ValueError("mutable_state and has_aux are mutually exclusive")
        if model is not None and not any(st.model is model for st in self._train_states):
            raise ValueError("model was not prepared by this Accelerator (with an optimizer)")
        if max_grad_norm is None:
            max_grad_norm = self._ds_gradient_clipping
        policy = self._mp_policy
        num_accum = self.gradient_state.num_steps
        comm_hook = getattr(self.ddp_handler, "comm_hook", "no") or "no"
        if comm_hook != "no":
            step = self._comm_hook_step(loss_fn, comm_hook=comm_hook, bound=model,
                                        max_grad_norm=max_grad_norm, has_aux=has_aux,
                                        mutable_state=mutable_state)
            return self._tracked(step)
        # Under pp the stages' gradients and metrics meet over the pp slice.
        n_stages, _ = self.state.pipeline_stage
        pipe = (self.state.pipeline_mesh.get_group()
                if n_stages > 1 and self.use_distributed else None)
        if pipe is not None:
            self.state.pipeline_edge_group  # built by every process, before any step

        bound = model

        def step(state: TrainState, batch: dict):
            if bound is not None and state.model is not bound:
                raise ValueError("this step was prepared for another model's slot")
            # The processes whose losses the step averages: all of them, or
            # under tp and pp those of distinct rows of one stage (their
            # group); inside a LocalSGD block, this process alone.
            local = self._local_sgd_active
            world, group = (1, None) if local else (self.state.loss_size, self.state.loss_group)
            model, opt = state.model, state.optimizer
            params = [p for p in model.parameters() if p.requires_grad]
            microbatches = _microbatch_split(self._to_device(batch), num_accum)
            opt.zero_grad(set_to_none=True)
            loss_sum = torch.zeros((), dtype=torch.float32, device=self.device)
            extra = state.extra_state
            for mb in microbatches:
                with (operations.loss_over_processes(world, group),
                      gradient_sync(model, not local),
                      model.compute_params(policy.cast_for_compute(self._cast_params(model))),
                      stage_scope() as scope):
                    if mutable_state:
                        loss, extra = loss_fn(model, extra, mb)
                    else:
                        loss = loss_fn(model, mb)
                        if has_aux:
                            loss, _aux = loss
                    loss = stage_loss(model.module, loss.float(), scope)
                    _scaled(loss, state.loss_scale).backward()
                loss_sum += loss.detach()
            if mutable_state:
                state.set_extra_state(extra if pipe is None
                                      else self._from_last_stage(extra, pipe))
            if pipe is not None:
                self._pipeline_zero_grads(model)
            grads = [p.grad for p in params if p.grad is not None]
            # Parameters FSDP2 leaves whole are averaged here over every
            # process (loss_reduce_axes), as DDP would.
            if world > 1:
                average_whole_gradients(model, world, group)
            skip = self._sum_shared_gradients(model) if pipe is not None else frozenset()
            if num_accum > 1:
                torch._foreach_div_([_local(g) for g in grads], num_accum)
            finite = self._unscale_and_check(state, grads, local=local)
            gnorm = _global_norm(grads, pipe, skip)
            if max_grad_norm is not None:
                factor = torch.clamp(max_grad_norm / (gnorm + 1e-6), max=1.0)
                torch._foreach_mul_([_local(g) for g in grads], factor)
            self._optimizer_step(state, finite)
            loss = loss_sum / num_accum
            if world > 1:
                operations.all_reduce(loss, group=group)
                loss = loss / world
            if pipe is not None:
                loss = self._last_stage_loss(loss, pipe)
            return state, self._step_metrics(model, loss, gnorm)

        return self._tracked(step)

    def _last_stage_loss(self, loss: torch.Tensor, pipe) -> torch.Tensor:
        """The last stage's loss on every stage of ``pipe`` (the others add
        zero)."""
        n_stages, stage = self.state.pipeline_stage
        if stage != n_stages - 1:
            loss = torch.zeros_like(loss)
        return operations.all_reduce(loss, group=pipe)

    def _from_last_stage(self, tree, pipe):
        """``tree``'s tensors (the new ``extra_state`` of a ``mutable_state``
        step) as the last stage computed them, broadcast over ``pipe``: the
        stages before it ran its loss function on a stand-in."""
        n_stages, _ = self.state.pipeline_stage
        src = torch.distributed.get_global_rank(pipe, n_stages - 1)

        def bcast(t):
            t = t.detach().contiguous().clone()
            torch.distributed.broadcast(t, src=src, group=pipe)
            return t

        return operations.recursively_apply(bcast, tree)

    def _pipeline_norm_args(self, model: Model) -> tuple:
        """Under ``pp``, ``(pipe, skip)`` for ``_global_norm`` in the
        imperative loop, the window's tied-weight gradients summed over the
        edge group once (``_sum_shared_gradients``); ``(None, empty)``
        otherwise."""
        n_stages, _ = self.state.pipeline_stage
        if n_stages == 1 or not self.use_distributed:
            return None, frozenset()
        if self._pp_skip is None:
            self._pp_skip = self._sum_shared_gradients(model)
        return self.state.pipeline_mesh.get_group(), self._pp_skip

    def _step_metrics(self, model: Model, loss: torch.Tensor, gnorm: torch.Tensor) -> dict:
        """The step's metrics; with the SDC sentinel armed also the
        integrity digest of the new parameters and the grad norm
        (``sdc.integrity_digest``), computed on the card inside the step."""
        metrics = {"loss": loss, "grad_norm": gnorm}
        ft = self.fault_tolerance
        if ft is not None and ft.sdc is not None:
            metrics["sdc_digest"] = ft.sdc.digest(model, gnorm)
        return metrics

    def _tracked(self, step: Callable) -> Callable:
        """``step`` reporting to the telemetry, when there is one, and to
        fault tolerance: before the first step the SDC sentinel's golden
        capture, after every step ``observe_step`` (``_maybe_sentinel``)."""

        def run(state: TrainState, batch: dict):
            tel = self.telemetry
            if tel is None:
                return step(state, batch)
            # The first profiled step runs under the FLOP counter.
            counting = (tel.profiler.capture_cost() if tel.profiler is not None
                        else contextlib.nullcontext())
            t0 = time.perf_counter()
            with counting:
                state, metrics = step(state, batch)
            if tel.handler.sync_timing:
                self._synchronize()
            tel.on_train_step(step, batch, time.perf_counter() - t0, metrics=metrics)
            return state, metrics

        def step_and_track(state: TrainState, batch: dict):
            ft = self.fault_tolerance
            if ft is None:
                return run(state, batch)
            if ft.sdc is not None and ft.sdc.needs_golden:
                ft.sdc.capture_golden(step, state, batch)
            state, metrics = run(state, batch)
            return self._maybe_sentinel(state, metrics), metrics

        return step_and_track

    def _maybe_sentinel(self, state: TrainState, metrics) -> TrainState:
        """``observe_step`` after a step: the state to train on next, the
        restored one after a rollback or an SDC repair (restored in place:
        the same object, at the checkpoint's step)."""
        slot = next((i for i, st in enumerate(self._train_states) if st is state), 0)
        restored = self.fault_tolerance.observe_step(metrics, slot=slot)
        return restored if restored is not None else state

    def _comm_hook_step(self, loss_fn: Callable, *, comm_hook: str, bound: Optional[Model],
                        max_grad_norm: Optional[float], has_aux: bool, mutable_state: bool):
        """The step whose data-parallel gradient mean runs through a
        compression hook (``DistributedDataParallelKwargs(comm_hook=...)``,
        ``parallel/comm_hooks.py``), as the JAX package's
        ``_comm_hook_step``: each process's backward on its own rows with
        no reducer (its loss the mean over its own tokens), the gradients
        summed over an accumulation window and divided once, reduced by the
        hook (PowerSGD on the unscaled gradients, the wire hooks on the
        still-scaled ones), then the plain update: unscale, finite check,
        global norm, clip, AdamW. The loss metric is the mean of the
        processes' own means. An overflowed step (the finite flag the MIN
        over the processes) keeps the hook's state, as the parameters.
        The hook's state (PowerSGD's Q and error feedback by flax leaf) is
        ``_comm_hook_states[slot]``. DDP semantics only: replicated
        parameters over a purely data-parallel mesh."""
        from .parallel.comm_hooks import (
            flax_gradients,
            init_powersgd_state,
            make_comm_hook_reducer,
            set_from_flax,
        )
        from .parallelism_config import MESH_AXES

        if mutable_state or has_aux:
            raise NotImplementedError(
                "comm_hook is not supported together with mutable_state/has_aux")
        plugin = self.fsdp_plugin
        if plugin is not None and plugin.sharding_strategy == "SHARD_GRAD_OP":
            raise ValueError(
                "comm_hook requires replicated (DDP) gradients — it cannot compose with ZeRO-2 "
                "SHARD_GRAD_OP reduce-scatter")
        pc = self.parallelism_config
        bad = [a for a in MESH_AXES if a not in ("dp_replicate", "dp_shard") and pc.axis_size(a) > 1]
        if bad:
            raise ValueError(
                f"comm_hook requires a pure data-parallel mesh; axes {bad} have size > 1 (the "
                "reference's DDP comm hooks are DP-only too)")
        slot = next(i for i, st in enumerate(self._train_states)
                    if bound is None or st.model is bound)
        model = self._train_states[slot].model
        if model.sharded or any(isinstance(p, DTensor) for p in model.parameters()):
            raise ValueError(
                "comm_hook requires replicated (DDP) parameters; the model is sharded by "
                "FSDP2 — drop the FSDP plugin or the hook")
        rank = int(self.ddp_handler.powersgd_rank)
        world = self.num_processes
        reducer = make_comm_hook_reducer(comm_hook, None, world, rank=rank)
        named = [(n, p) for n, p in model.module.named_parameters() if p.requires_grad]
        state0: dict = {}
        if comm_hook == "powersgd":
            meta = [(n, types.SimpleNamespace(grad=torch.empty(p.shape, device="meta")))
                    for n, p in named]
            state0 = init_powersgd_state(flax_gradients(model.module, meta)[0], rank,
                                         device=self.device)
        while len(self._comm_hook_states) <= slot:
            self._comm_hook_states.append(None)
        self._comm_hook_states[slot] = state0
        policy = self._mp_policy
        num_accum = self.gradient_state.num_steps

        def step(state: TrainState, batch: dict):
            if bound is not None and state.model is not bound:
                raise ValueError("this step was prepared for another model's slot")
            model, opt = state.model, state.optimizer
            microbatches = _microbatch_split(self._to_device(batch), num_accum)
            opt.zero_grad(set_to_none=True)
            loss_sum = torch.zeros((), dtype=torch.float32, device=self.device)
            for mb in microbatches:
                with model.compute_params(policy.cast_for_compute(self._cast_params(model))):
                    loss = loss_fn(model, mb).float()  # this process's own mean
                    _scaled(loss, state.loss_scale).backward()
                loss_sum += loss.detach()
            for _, p in named:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            grads = [p.grad for _, p in named]
            if num_accum > 1:
                torch._foreach_div_(grads, num_accum)
            scale = None if state.loss_scale is None else state.loss_scale.scale
            unscale = comm_hook == "powersgd" and scale is not None
            if unscale:
                torch._foreach_div_(grads, scale)
            flax, rows = flax_gradients(model.module, named)
            comm = self._comm_hook_states[slot]
            reduced, new_comm = reducer(flax, comm)
            if comm_hook == "powersgd":
                finite = torch.stack([torch.isfinite(g).all() for g in grads]).all()
                if world > 1:
                    flag = finite.to(torch.int32)
                    operations.all_reduce(flag, op=torch.distributed.ReduceOp.MIN)
                    finite = flag.bool()
                self._comm_hook_states[slot] = {
                    n: {k: torch.where(finite, t, comm[n][k]) for k, t in st.items()}
                    for n, st in new_comm.items()}
            set_from_flax(rows, reduced)
            if unscale:
                torch._foreach_mul_(grads, scale)
            finite = self._unscale_and_check(state, grads)
            gnorm = _global_norm(grads)
            if max_grad_norm is not None:
                factor = torch.clamp(max_grad_norm / (gnorm + 1e-6), max=1.0)
                torch._foreach_mul_(grads, factor)
            self._optimizer_step(state, finite)
            loss = loss_sum / num_accum
            if world > 1:
                operations.all_reduce(loss)
                loss = loss / world
            return state, self._step_metrics(model, loss, gnorm)

        return step

    def _sum_shared_gradients(self, model: Model) -> frozenset:
        """Under pp: the gradients of the weights two stages hold (a tied
        embedding and head) summed over the first and last stages, so that
        both copies take the whole gradient; returns the ids of the
        gradients this stage leaves out of the norm (the last stage's
        copies: the weight counts once). For a family whose every stage
        holds the parameters outside its cut stacks (``parallel/pp.
        ReplicatedSpec``) those are summed over the whole pp group and count
        on stage 0 only."""
        shared = [model.module.get_parameter(n) for n in model.pipeline_shared]
        if not shared:
            return frozenset()
        replicated = getattr(model.module, "pipeline_replicated", False)
        group = (self.state.pipeline_mesh.get_group() if replicated
                 else self.state.pipeline_edge_group)
        for p in shared:
            if p.grad is not None:
                operations.all_reduce(_local(p.grad), group=group)
        n_stages, stage = self.state.pipeline_stage
        counted_here = stage == 0 if replicated else stage != n_stages - 1
        return frozenset() if counted_here else frozenset(id(p.grad) for p in shared)

    @staticmethod
    def _pipeline_zero_grads(model: Model) -> None:
        """Under pp of a replicated family: a parameter every stage holds
        that took no gradient on this stage (its part of the graph ran
        elsewhere) takes zeros, so that every stage sums the same list."""
        if not getattr(model.module, "pipeline_replicated", False):
            return
        for n in model.pipeline_shared:
            p = model.module.get_parameter(n)
            if p.requires_grad and p.grad is None:
                p.grad = torch.zeros_like(p)

    @staticmethod
    def _cast_params(model: Model) -> dict:
        """The parameters the step casts for compute itself: all of them,
        or under FSDP2 (whose policy casts the ones it shards) those it
        leaves whole."""
        return dict(model.ignored) if model.sharded else dict(model.module.named_parameters())

    def _unscale_and_check(self, state: TrainState, grads: list,
                           local: bool = False) -> Optional[torch.Tensor]:
        """Under loss scaling: ``grads`` unscaled in place, and whether every
        gradient of every process is finite (a bool device tensor; MIN over
        the processes, which hold different shards or stages, so that all
        take the same decision; this process's alone with ``local``). None
        without loss scaling."""
        if state.loss_scale is None:
            return None
        finite = state.loss_scale.unscale([_local(g) for g in grads])
        if self.num_processes > 1 and not local:
            flag = finite.to(torch.int32)
            operations.all_reduce(flag, op=torch.distributed.ReduceOp.MIN)
            finite = flag.bool()
        return finite

    def _optimizer_step(self, state: TrainState, finite: Optional[torch.Tensor]) -> None:
        """``optimizer.step()`` and the step count; under loss scaling the
        optimizer skips the step where ``finite`` is False (its
        ``found_inf``), the count advances by ``finite`` and the scale is
        updated, all on the device."""
        opt = state.optimizer
        if finite is None:
            opt.step()
            state.step += 1
            return
        opt.found_inf = (~finite).float()
        try:
            opt.step()
        finally:
            opt.found_inf = None
        state.step += finite.to(state.step.dtype)
        state.loss_scale.update(finite)

    def _synchronize(self) -> None:
        """Wait for the card (telemetry's ``sync_timing``)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------
    # The imperative loop
    # ------------------------------------------------------------------

    @contextlib.contextmanager
    def accumulate(self, *models):
        """One microbatch of an accumulation window: sets ``sync_gradients``
        when the microbatch ends the window. ``models`` are taken for the
        JAX package's signature; ``backward`` acts on the prepared model."""
        self._do_sync()
        yield

    def _do_sync(self) -> None:
        gs = self.gradient_state
        if gs.sync_with_dataloader and gs.end_of_dataloader:
            self.step = 0
            gs._set_sync_gradients(True)
        else:
            self.step += 1
            gs._set_sync_gradients(self.step % gs.num_steps == 0)

    @contextlib.contextmanager
    def no_sync(self, model=None):
        """Inside the block ``sync_gradients`` is False: ``backward`` skips
        the gradient collectives and the optimizer does not step."""
        old = self.gradient_state.sync_gradients
        self.gradient_state._set_sync_gradients(False)
        try:
            yield
        finally:
            self.gradient_state._set_sync_gradients(old)

    @contextlib.contextmanager
    def join_uneven_inputs(self, joinables, even_batches: Optional[bool] = None):
        """Overrides the prepared loaders' ``even_batches`` inside the block
        and restores it on exit, as the JAX package does. Every process must
        still run as many microbatches: the loss's token count is
        all-reduced on each one."""
        overridden = []
        if even_batches is not None:
            for dl in self._dataloaders:
                sampler = getattr(dl, "batch_sampler", None)
                if hasattr(sampler, "even_batches"):
                    overridden.append((sampler, sampler.even_batches))
                    sampler.even_batches = even_batches
        try:
            yield
        finally:
            for sampler, old in overridden:
                sampler.even_batches = old

    def backward(self, loss_fn: Callable, *args, has_aux: bool = False, **kwargs):
        """Run ``loss_fn(model, *args, **kwargs)`` on the prepared model and
        accumulate the gradients of the loss divided by the accumulation
        steps (times the loss scale under fp16) in the fp32 masters'
        ``grad``. Returns the loss (detached, not divided, unscaled; the
        mean over processes), and ``aux`` when ``has_aux`` (``loss_fn`` then
        returns ``(loss, aux)``).

        The JAX package's signature: a loss function and its inputs, not a
        loss tensor. Host arrays among the inputs go to the device. The
        forward runs as in the fused step: on the parameters cast to the
        compute dtype (FSDP2's policy under a plugin), with the loss averaged
        over the processes. A microbatch that does not end the window skips
        the gradient collectives unless ``sync_each_batch``; the one that
        ends it reduces them and averages the parameters FSDP2 leaves whole.
        Under ``pp`` the loss is the last stage's (the others' stand-in
        losses run their part of the backward); each stage's gradients stay
        its own, and the clip's norm and the step take them over the stages
        with a tied weight counted once, as the fused step does."""
        if torch.is_tensor(loss_fn) or not callable(loss_fn):
            raise TypeError(
                "backward() takes the loss function and its inputs, as the JAX package's "
                "does: accelerator.backward(loss_fn, batch) with loss_fn(model, batch) -> "
                f"scalar loss; got a {type(loss_fn).__name__}")
        if not self._train_states:
            raise RuntimeError("Call accelerator.prepare(...) before backward().")
        model, loss_scale = self._train_states[0].model, self._train_states[0].loss_scale
        gs, world, group = self.gradient_state, self.state.loss_size, self.state.loss_group
        communicate = gs.sync_gradients or gs.sync_each_batch
        tel = self.telemetry
        t0 = time.perf_counter() if tel is not None else 0.0
        args, kwargs = operations.recursively_apply(self._place, (args, kwargs))
        cast = self._mp_policy.cast_for_compute(self._cast_params(model))
        with (operations.loss_over_processes(world, group), gradient_sync(model, communicate),
              model.compute_params(cast), stage_scope() as scope):
            out = loss_fn(model, *args, **kwargs)
            loss, aux = out if has_aux else (out, None)
            loss = stage_loss(model.module, loss.float(), scope)
            _scaled(loss / gs.num_steps, loss_scale).backward()
        if communicate and world > 1:
            average_whole_gradients(model, world, group)
        # A reducing backward reduces what earlier microbatches accumulated too.
        self._grads_local = not communicate and self.use_distributed
        loss = loss.detach()
        if world > 1:
            operations.all_reduce(loss, group=group)
            loss = loss / world
        if self.parallelism_config.pp_size > 1 and self.use_distributed:
            loss = self._last_stage_loss(loss, self.state.pipeline_mesh.get_group())
        if tel is not None:
            if tel.handler.sync_timing:
                self._synchronize()
            tel.on_backward(loss_fn, (args, kwargs), time.perf_counter() - t0)
        return (loss, aux) if has_aux else loss

    def _grads(self, train_state) -> list:
        return [p.grad for p in train_state.model.parameters()
                if p.requires_grad and p.grad is not None]

    def clip_grad_norm_(self, parameters=None, max_norm: float = 1.0, norm_type: float = 2.0):
        """Arm the clip for this and every later optimizer step, and return
        the global L2 norm of the gradients accumulated so far (a device
        scalar; FSDP2's shards counted once), unscaled under fp16 loss
        scaling (the JAX package returns the scaled norm there: a fault of
        the reference, ROADMAP.md Queue C). ``parameters`` is taken for the
        signature: the clip acts on the prepared model. None without
        gradients, or while the window's gradients are each process's own."""
        if norm_type != 2.0:
            raise NotImplementedError("Only L2 grad-norm clipping is supported, as in the "
                                      "JAX package")
        self._max_grad_norm = float(max_norm)
        grads = self._grads(self._train_states[0]) if self._train_states else []
        if not grads or self._grads_local:
            return None
        loss_scale = self._train_states[0].loss_scale
        norm = _global_norm(grads, *self._pipeline_norm_args(self._train_states[0].model))
        return norm if loss_scale is None else norm / loss_scale.scale

    def clip_grad_value_(self, parameters=None, clip_value: float = 1.0):
        raise NotImplementedError(
            "clip_grad_value_ is not supported; use clip_grad_norm_, as in the JAX package "
            "(clipping each value breaks the linearity of the data-parallel mean)")

    def unscale_gradients(self, optimizer=None):
        """A no-op: every path that reads the gradients under fp16 loss
        scaling unscales them first (``clip_grad_norm_``'s norm, the
        optimizer step's clip and finite check), so callers migrating from
        Accelerate's ``unscale_gradients()``-then-clip run unchanged."""
        return None

    def _apply_gradients(self, optimizer: torch.optim.Optimizer) -> Optional[torch.Tensor]:
        """The optimizer step of a window (``AcceleratedOptimizer.step``):
        under fp16 the gradients unscaled and checked, the armed clip by the
        global norm of the gradients as they are now, then the step (skipped
        on the device where they overflowed). Returns the finite flag under
        loss scaling, else None. Nothing without gradients."""
        state = next(st for st in self._train_states if st.optimizer is optimizer)
        if self.parallelism_config.pp_size > 1 and self.use_distributed:
            self._pipeline_zero_grads(state.model)
        grads = self._grads(state)
        if not grads:
            return None
        tel = self.telemetry
        t0 = time.perf_counter() if tel is not None else 0.0
        pipe, skip = self._pipeline_norm_args(state.model)
        finite = self._unscale_and_check(state, grads)
        if self._max_grad_norm is not None:
            factor = torch.clamp(self._max_grad_norm / (_global_norm(grads, pipe, skip) + 1e-6),
                                 max=1.0)
            torch._foreach_mul_([_local(g) for g in grads], factor)
        self._optimizer_step(state, finite)
        self._grads_local = False
        self._pp_skip = None
        if tel is not None:
            if tel.handler.sync_timing:
                self._synchronize()
            tel.on_apply_gradients(time.perf_counter() - t0)
        if self.fault_tolerance is not None:
            # The imperative loop has no step metrics: the chaos draws and
            # the watchdog's note run (a restored state is restored in place).
            self.fault_tolerance.observe_step(None, slot=self._train_states.index(state))
        return finite

    # ------------------------------------------------------------------
    # Collectives across processes (utils/operations.py)
    # ------------------------------------------------------------------

    def gather(self, tensor):
        """The global values of every process's tensors
        (``operations.gather``): the rows of every data-parallel process
        on dim 0, each at full length under ``cp``/``sp``."""
        return operations.gather(tensor)

    def gather_for_metrics(self, input_data, use_gather_object: bool = False):
        """The gathered values without the samples that ``even_batches``
        repeated to fill the last batch (rows of the global batch, under
        ``cp``/``sp`` too). Data with leaves other than
        tensors and arrays (or ``use_gather_object``) is gathered as Python
        objects."""
        as_objects = use_gather_object or not operations.is_array_tree(input_data)
        data = (operations.gather_object(input_data) if as_objects
                else operations.gather(input_data))
        gs = self.gradient_state
        if gs.end_of_dataloader and gs.remainder > 0:
            if as_objects:
                return data[: gs.remainder]
            return operations.recursively_apply(lambda t: t[: gs.remainder], data)
        return data

    def reduce(self, tensor, reduction: str = "sum", scale: float = 1.0):
        return operations.reduce(tensor, reduction=reduction, scale=scale)

    def pad_across_processes(self, tensor, dim: int = 0, pad_index: int = 0,
                             pad_first: bool = False):
        return operations.pad_across_processes(tensor, dim=dim, pad_index=pad_index,
                                               pad_first=pad_first)

    def set_trigger(self) -> None:
        """Raise this process's flag; ``check_trigger`` sees it on every
        process."""
        self.flag_tensor = torch.tensor(1, device=self.device)

    def check_trigger(self) -> bool:
        """Whether any process raised its flag since the last check that
        saw one (a sum over processes); lowers it."""
        if self.flag_tensor is None:
            self.flag_tensor = torch.tensor(0, device=self.device)
        if int(operations.reduce(self.flag_tensor, reduction="sum")) >= 1:
            self.flag_tensor = torch.tensor(0, device=self.device)
            return True
        return False

    @contextlib.contextmanager
    def autocast(self, autocast_handler=None):
        """A no-op that warns once: the compute dtype is the precision
        policy's, applied by ``backward`` and the fused step to the cast
        copies of the parameters (``Model.compute_params``)."""
        logger.warning_once(
            "Accelerator.autocast() does nothing: mixed precision is a policy applied inside "
            "backward() and the prepared train step (mixed_precision=%s).",
            self.state.mixed_precision)
        yield

    # ------------------------------------------------------------------
    # Trackers, telemetry and the profiler
    # ------------------------------------------------------------------

    def init_trackers(self, project_name: str, config: Optional[dict] = None,
                      init_kwargs: Optional[dict] = None):
        """Build the trackers ``log_with`` named (``init_kwargs[name]``
        goes to each one's constructor) and store ``config`` in each."""
        from .tracking import resolve_trackers

        self.trackers = resolve_trackers(self.log_with, project_name, self.logging_dir,
                                         init_kwargs or {})
        if config is not None:
            for tracker in self.trackers:
                tracker.store_init_configuration(config)

    def get_tracker(self, name: str, unwrap: bool = False):
        """The tracker called ``name``, or with ``unwrap`` the object it
        writes through (a ``SummaryWriter``, a run)."""
        for tracker in self.trackers:
            if tracker.name == name:
                return tracker.tracker if unwrap else tracker
        raise ValueError(f"{name} is not an available tracker stored inside the `Accelerator`.")

    def log(self, values: dict, step: Optional[int] = None, log_kwargs: Optional[dict] = None):
        """``values`` to every tracker, on the main process (a device
        scalar among them is read, which waits for the card)."""
        log_kwargs = log_kwargs or {}
        if self.is_main_process:
            for tracker in self.trackers:
                tracker.log(values, step=step, **log_kwargs.get(tracker.name, {}))

    def end_training(self):
        """Wait for a save in flight (and free its host copies), close the
        telemetry (its summary record, the profiler's last record), then
        finish every tracker, and wait for every process."""
        from .checkpointing import release_staging

        release_staging(self)
        if self.fault_tolerance is not None:
            self.fault_tolerance.close()  # the watchdog, the previous signal handlers
        if self.telemetry is not None:
            self.telemetry.close()
        if self.is_main_process:
            for tracker in self.trackers:
                tracker.finish()
        self.wait_for_everyone()

    @contextlib.contextmanager
    def profile(self, profile_handler: Optional[ProfileKwargs] = None):
        """A ``torch.profiler`` trace honouring :class:`ProfileKwargs`
        (``utils/profiling.py``): with ``schedule_option`` the block gets
        a session whose ``step()`` is called once per train step, and each
        active window is written as ``<dir>/cycle_<i>/trace.json``; without
        it the whole block is written as ``<dir>/trace.json``. The
        directory is ``output_trace_dir`` or the project directory; with
        neither, nothing is traced and the block gets None."""
        from .utils.profiling import ProfileSession

        handler = profile_handler or self.profile_handler or ProfileKwargs()
        if handler.output_trace_dir is None and self.project_dir is None:
            yield None
            return
        session = ProfileSession(handler, handler.output_trace_dir or self.project_dir,
                                 device=self.device)
        session.enter()
        try:
            yield session
        finally:
            session.exit()

    # ------------------------------------------------------------------
    # Exporting weights, and freeing memory
    # ------------------------------------------------------------------

    def get_state_dict(self, model: Model, unwrap: bool = True) -> dict:
        """The model's whole fp32 parameters on the host, under the flat
        ``/``-joined names and layouts of the JAX package's ``get_state_dict``
        for the same model (the flax tree, ``models/convert.py``). Every
        process joins the gathers of FSDP2's shards and gets the whole."""
        from .checkpointing import _flat_model_tree, _to_host, _whole

        whole = {n: _whole(p.detach(), self.device)
                 for n, p in model.module.named_parameters()}
        return _to_host(_flat_model_tree(model.module, whole), self.device)

    def save_model(self, model: Model, save_directory: str,
                   max_shard_size: Union[int, str] = "5GB", safe_serialization: bool = True):
        """``get_state_dict(model)`` written by the main process as
        ``model.safetensors``, or shards of ``max_shard_size`` and
        ``model.safetensors.index.json``: the files and keys of the JAX
        package's ``save_model``."""
        from .utils.other import save_sharded_safetensors

        if not safe_serialization:
            raise ValueError("save_model writes safetensors: safe_serialization=False has no "
                             "other format")
        flat = self.get_state_dict(model)
        if self.is_main_process:
            save_sharded_safetensors(flat, save_directory, max_shard_size=max_shard_size)
        self.wait_for_everyone()

    def save(self, obj, f, safe_serialization: bool = False) -> None:
        """``obj`` written once (once per node with ``save_on_each_node``):
        safetensors for a flat dict of tensors when ``safe_serialization``,
        else ``torch.save``."""
        operations.save(obj, f, save_on_each_node=self.project_configuration.save_on_each_node,
                        safe_serialization=safe_serialization)

    def free_memory(self, *objects):
        """Drop every prepared object this Accelerator holds and the
        imperative loop's state, then ``release_memory(*objects)``: returns
        a None for each, and the caller rebinds its own names to them."""
        from .checkpointing import release_staging
        from .utils.memory import release_memory

        release_staging(self)
        if self.telemetry is not None:
            self.telemetry.close()
            self.telemetry = None
        for held in (self._train_states, self._models, self._optimizers, self._schedulers,
                     self._dataloaders):
            held.clear()
        self.step = 0
        self._max_grad_norm = self.flag_tensor = self._pp_skip = None
        self._grads_local = False
        return release_memory(*objects)

    def clear(self, *objects):
        return self.free_memory(*objects)

    # ------------------------------------------------------------------
    # Checkpoints
    # ------------------------------------------------------------------

    def register_for_checkpointing(self, *objects):
        invalid = [o for o in objects
                   if not (hasattr(o, "state_dict") and hasattr(o, "load_state_dict"))]
        if invalid:
            raise ValueError(
                "All `objects` must include a `state_dict` and `load_state_dict` function "
                f"to be stored: {invalid}")
        self._custom_objects.extend(objects)

    def register_save_state_pre_hook(self, hook: Callable) -> _HookHandle:
        """``hook(models, train_state, output_dir)`` runs before every
        ``save_state`` writes; the handle's ``remove()`` drops it."""
        self._save_state_pre_hooks.append(hook)
        return _HookHandle(self._save_state_pre_hooks, hook)

    def register_load_state_pre_hook(self, hook: Callable) -> _HookHandle:
        """``hook(models, input_dir)`` runs before every ``load_state`` reads."""
        self._load_state_pre_hooks.append(hook)
        return _HookHandle(self._load_state_pre_hooks, hook)

    def save_state(self, output_dir: Optional[str] = None, safe_serialization: bool = True,
                   block: bool = True) -> str:
        """Write the training state (``checkpointing.py`` lists the files)
        and return the directory. A save still in flight is waited for
        first. ``block=False`` under ``DISTRIBUTED_STATE_DICT`` returns once
        the state is staged in host memory and writes it in the background
        (``wait_for_checkpoint`` waits for it); the safetensors formats warn
        and save synchronously, as the JAX package does."""
        from .checkpointing import _checkpoint_dir, save_accelerator_state

        if not safe_serialization:
            raise ValueError("checkpoints hold model.safetensors: safe_serialization=False "
                             "has no other format")
        self.wait_for_checkpoint()
        train_state = self._train_states[0] if self._train_states else None
        ft = self.fault_tolerance
        if ft is None:
            if self._save_state_pre_hooks:
                output_dir = _checkpoint_dir(self, output_dir)
                for hook in self._save_state_pre_hooks:
                    hook(self._models, train_state, output_dir)
            return save_accelerator_state(self, output_dir, block=block)
        # Under fault tolerance the save stages into <dir>.tmp and commits
        # (checkpointing.py); the pre-hooks write into the staging directory,
        # so their files ride the commit, again on every retry.
        from .fault_tolerance import staging_path

        def do_save(target: str) -> str:
            if self._save_state_pre_hooks:
                hook_dir = staging_path(target) if ft.atomic else target
                if ft.atomic:
                    if self.is_main_process and os.path.isdir(hook_dir):
                        shutil.rmtree(hook_dir)
                    self.wait_for_everyone()
                    os.makedirs(hook_dir, exist_ok=True)
                    ft.prearm_staging(hook_dir)
                for hook in self._save_state_pre_hooks:
                    hook(self._models, train_state, hook_dir)
            return save_accelerator_state(self, target, block=block)

        return ft.run_save_with_retry(do_save, _checkpoint_dir(self, output_dir))

    def load_state(self, input_dir: Optional[str] = None) -> str:
        """Restore the training state from ``input_dir`` or the newest
        automatic checkpoint (this package's or the JAX package's) and
        return the directory. The next pass over a prepared loader resumes
        at the batch after the last one the saved run took."""
        from .checkpointing import _checkpoint_dir, load_accelerator_state

        self.wait_for_checkpoint()
        if self._load_state_pre_hooks:
            input_dir = _checkpoint_dir(self, input_dir, for_load=True)
            for hook in self._load_state_pre_hooks:
                hook(self._models, input_dir)
        return load_accelerator_state(self, input_dir)

    # -- preemption (fault_tolerance.py) ------------------------------------

    def should_checkpoint(self) -> bool:
        """True once this process received a preemption signal (SIGTERM or
        SIGUSR1 under ``FaultToleranceKwargs``): save now. Local and free."""
        ft = self.fault_tolerance
        return ft is not None and ft.preempted

    def check_preemption(self) -> bool:
        """True on every process once any received a preemption signal (an
        OR over a gloo group, ``PartialState.agree_any``). After the final
        ``save_state()`` exit with ``preemption_exit_code``."""
        ft = self.fault_tolerance
        if ft is None:
            return False
        return self.state._partial.agree_any(ft.preempted)

    @property
    def preemption_exit_code(self) -> int:
        """The exit code of a preempted run (75): a supervisor relaunches it
        as resumable."""
        from .utils.constants import PREEMPTION_EXIT_CODE

        return PREEMPTION_EXIT_CODE

    def wait_for_checkpoint(self) -> None:
        """Block until a ``save_state(block=False)`` has finished writing.
        A failure in the background raises ``CheckpointSaveError`` here
        (recorded as a ``checkpoint_async_error`` telemetry event), and the
        save is no longer in flight."""
        from .checkpointing import finish_pending_save

        finish_pending_save(self)
