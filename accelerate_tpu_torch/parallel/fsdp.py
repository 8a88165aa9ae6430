"""Data parallelism over the process group: FSDP2, HSDP and DDP.

Counterpart of ``accelerate_tpu/parallel/sharding.py``'s FSDP half
(``fsdp_spec_for_leaf``, ``plan_parameter_sharding``) and of what
``FullyShardedDataParallelPlugin`` decides there. The JAX package shards
each parameter over the ``dp_shard`` mesh axis and lets GSPMD gather it
where it is used; here FSDP2's ``fully_shard`` does the same per module.
The plugin's ``sharding_strategy`` picks the layout:

- ``FULL_SHARD`` and ``HYBRID_SHARD``: ``fully_shard`` goes on each decoder
  block and then on the root, over ``dp_shard × cp``
  (``ParallelismConfig.fsdp_axes``: the ``cp`` ranks shard the parameters
  too); when ``dp_replicate × sp`` is wider than 1 the mesh is the 2-D
  ``(replicate, shard)`` one (``AcceleratorState.data_parallel_mesh``) and
  FSDP2 runs HSDP: sharded within a replica group, gradients averaged
  across the groups. In the JAX plan the two strategies are one
  (``shards_params`` is true for both). ``sp`` ranks hold replicas, since
  each runs the whole weights on its slice of the sequence;
- ``SHARD_GRAD_OP``: FSDP2 with ``reshard_after_forward=False``, torch's
  counterpart of ZeRO-2: gradients and optimizer state sharded, the
  parameters gathered once for the forward and kept whole through the
  backward. Unlike the JAX plan, which keeps the parameters whole on every
  process between steps (``2N`` bytes of bf16 compute copies, plus the fp32
  masters replicated), FSDP2 reshards them after the backward: between
  steps each process holds ``1/W`` of the fp32 masters. The numbers are
  the same;
- ``NO_SHARD``, and no plugin: the model replicated under DDP over every
  process (``DistributedDataParallelKwargs`` sets its reducer).

Either way the gradients are averaged over every process
(``loss_reduce_axes``), which with ``cross_entropy_loss``'s global token
count gives the gradient of the global token mean.

Which parameters FSDP2 shards is the JAX plan's rule
(``whole_parameters``): a parameter of rank below 2 (norm scales, biases),
one with fewer than ``min_weight_size_to_shard`` elements, one with no dim
that divides by the shard count, and one that ``ignored_params`` names
stay whole on every process, outside FSDP2. The train step casts them for
compute and averages their gradients itself, in one all-reduce over a flat
buffer (``average_whole_gradients``). The others are sharded on dim 0
(FSDP2's default); the layout changes nothing in the numbers. The JAX
package counts the elements of a scanned layout's stacked leaf (every
layer's weight at once), the port those of one layer's parameter: the
split differs only for a block weight under the minimum whose stack is
over it. The bf16 compute copy comes from FSDP2's
``MixedPrecisionPolicy(param_dtype=compute dtype, reduce_dtype=fp32)``:
the sharded masters stay fp32, each all-gather casts them, and gradients
are reduce-scattered in fp32, as the one-process step casts the masters
for its forward and lands fp32 gradients on them.

The imperative loop's microbatches that do not end an accumulation
window skip the gradient collectives (``gradient_sync``): FSDP2 keeps the
unsharded fp32 gradients on each process until the microbatch that ends
the window reduce-scatters their sum; DDP's ``no_sync`` keeps each
process's gradients until the next synchronised backward all-reduces them.

The other plugin fields that map onto FSDP2 are honoured:
``reshard_after_forward`` and ``cpu_offload`` (``CPUOffloadPolicy``: masters,
gradients and the optimizer step on the host). ``activation_checkpointing``
(the model's own remat, ``config.remat``) is applied by
``Accelerator.prepare_model`` to every prepared model, with or without a
process group (``apply_activation_checkpointing``).

Under ``pp`` (``apply_pipeline_stage``) the model is first cut to the
process's stage, and each axis then acts on that stage alone: ``tp`` and
ep on its parameters, FSDP2 on its blocks (each block its own root: the
stage's forward runs the blocks, never the module's own forward), or DDP's
arithmetic by the step over the stage's data-parallel slice.

Under ``ep_size > 1`` a Mixtral's expert stacks are split over the ep
slice of the mesh (``apply_tensor_parallel_model``); FSDP2 and the step's
DDP arithmetic leave them out, and their gradients, already summed over
the ep slice's tokens by the exchange's backward, are summed over the
ranks that hold the same experts only (``average_whole_gradients``).

FSDP2's units: one per repeated block of the model and one on the root.
A family names its block classes in the class attribute ``_fsdp_blocks``
(``LlamaBlock``, GPT-2's ``GPT2Block`` under ``h``, T5's ``block_{i}``
submodules, ResNet's bottlenecks, ...); a module without one has the
items of its ``ModuleList``s named ``layers`` wrapped.
"""

from __future__ import annotations

import copy
import dataclasses
import logging
import re
from contextlib import contextmanager

import torch
from torch import nn

logger = logging.getLogger(__name__)


def decoder_blocks(module: nn.Module) -> list[nn.Module]:
    """The repeated blocks FSDP2 wraps one by one: the submodules of the
    classes ``module._fsdp_blocks`` names, in module order; without it, the
    items of every ``ModuleList`` named ``layers``."""
    kinds = getattr(type(module), "_fsdp_blocks", None)
    if kinds is not None:
        return [child for _, child in module.named_modules() if isinstance(child, kinds)]
    return [block for name, child in module.named_modules()
            if isinstance(child, nn.ModuleList) and name.rsplit(".", 1)[-1] == "layers"
            for block in child]


def ignored_parameters(module: nn.Module, patterns) -> dict[str, nn.Parameter]:
    """Parameters whose name matches one of the regular expressions."""
    regexes = [re.compile(p) for p in patterns or ()]
    return {name: p for name, p in module.named_parameters()
            if any(r.search(name) for r in regexes)}


def whole_parameters(module: nn.Module, plugin, shard_count: int) -> dict[str, nn.Parameter]:
    """The parameters that stay whole on every process under ``plugin``,
    by name: those ``ignored_params`` names, and, as the JAX plan keeps
    them replicated, those of rank below 2, with fewer than
    ``min_weight_size_to_shard`` elements, or with no dim that divides by
    ``shard_count``."""
    whole = ignored_parameters(module, plugin.ignored_params)
    for name, p in module.named_parameters():
        if (p.dim() < 2 or p.numel() < plugin.min_weight_size_to_shard
                or not any(s % shard_count == 0 for s in p.shape)):
            whole[name] = p
    return whole


def average_whole_gradients(model, world: int, group=None) -> None:
    """The gradients of the parameters FSDP2 leaves whole (under ``tp``
    without a plugin that shards: every parameter's, a ``tp`` shard's
    local one) averaged over the ``world`` processes of ``group`` (None:
    every process), as DDP would average them: one all-reduce of a flat
    buffer per dtype (Llama's 37 norm scales in one collective).

    The expert stacks split over ep (``model.expert_params``) are left out
    of that: the exchange's backward already brought each expert's
    gradient from every token of its ep slice to its owner, so their sum
    over the processes that hold the same experts (``ExpertGroups.
    replicas``: the loss axes outside ``ep_axes``, if any) is the sum over
    every process, and is divided by ``world`` as the others' is."""
    from torch.distributed.tensor import DTensor

    from ..state import current_expert_groups

    experts = {id(p) for p in model.expert_params.values()}
    grads = [(p.grad.to_local() if isinstance(p.grad, DTensor) else p.grad, id(p) in experts)
             for p in model.ignored.values() if p.grad is not None]
    _sum_and_divide([g for g, expert in grads if not expert], group, world)
    expert_grads = [g for g, expert in grads if expert]
    if not expert_grads:
        return
    replicas = current_expert_groups().replicas
    if replicas is None:  # no replicas: the owner's sum is the whole sum
        torch._foreach_div_(expert_grads, world)
    else:
        _sum_and_divide(expert_grads, replicas, world)


def _sum_and_divide(grads: list, group, world: int) -> None:
    """``grads`` summed over ``group`` and divided by ``world``, in place:
    one all-reduce of a flat buffer per dtype."""
    from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

    from ..utils import operations

    for dtype in dict.fromkeys(g.dtype for g in grads):
        same = [g for g in grads if g.dtype == dtype]
        flat = _flatten_dense_tensors(same)
        operations.all_reduce(flat, group=group)
        flat.div_(world)
        torch._foreach_copy_(same, _unflatten_dense_tensors(flat, same))


def apply_activation_checkpointing(module: nn.Module) -> None:
    """``fsdp_plugin.activation_checkpointing``: the module's own remat
    switch (``config.remat``) turned on, as the JAX package's
    ``Accelerator._apply_activation_checkpointing`` does for every prepared
    model; a module without one is left as it is, with a warning. Like the
    JAX package's rebuild from ``dataclasses.replace(config, remat=True)``,
    the caller's config object is left alone: the module and every
    submodule that holds that object (as ``config`` or ``cfg``) get the
    replaced one."""
    config = getattr(module, "config", None)
    if config is None or not hasattr(config, "remat"):
        logger.warning(
            "fsdp_plugin.activation_checkpointing=True but %s has no config.remat knob: "
            "apply torch.utils.checkpoint inside your module to get activation "
            "checkpointing.", type(module).__name__)
        return
    if config.remat is False:
        if dataclasses.is_dataclass(config):
            remat = dataclasses.replace(config, remat=True)
        else:
            remat = copy.copy(config)
            remat.remat = True
        for sub in module.modules():
            for attr in ("config", "cfg"):
                if getattr(sub, attr, None) is config:
                    setattr(sub, attr, remat)
        logger.warning("activation_checkpointing: %s now runs with config.remat=True.",
                       type(module).__name__)


def apply_fsdp(module: nn.Module, mesh, plugin, compute_dtype: torch.dtype,
               root: bool = True, keep_whole: dict | None = None) -> dict:
    """``fully_shard`` on each decoder block and on ``module``, in place.
    ``mesh`` is the 2-D ``(replicate, shard)`` data-parallel mesh. Returns
    the parameters left whole (``whole_parameters``, and ``keep_whole``:
    the expert stacks split over ep) by name. With ``root=False`` (a
    pipeline stage, whose forward runs its blocks one by one and never the
    module's own) only the blocks are sharded, each its own root, and the
    parameters outside them stay whole too."""
    from torch.distributed.fsdp import CPUOffloadPolicy, MixedPrecisionPolicy, OffloadPolicy
    from torch.distributed.fsdp import fully_shard

    shard_mesh = mesh if mesh.size(0) > 1 else mesh[mesh.mesh_dim_names[1]]
    mp = (MixedPrecisionPolicy() if compute_dtype == torch.float32 else
          MixedPrecisionPolicy(param_dtype=compute_dtype, reduce_dtype=torch.float32))
    experts = dict(keep_whole or {})
    ignored = {n: p for n, p in whole_parameters(module, plugin, mesh.size(1)).items()
               if n not in experts}
    ignored.update(experts)
    blocks = decoder_blocks(module)
    if not root:
        inside = {id(p) for block in blocks for p in block.parameters()}
        ignored.update({n: p for n, p in module.named_parameters() if id(p) not in inside})
    # Pinned host memory needs the card; on a CPU device the policy only
    # keeps the optimizer step where the shards already are.
    offload = (CPUOffloadPolicy(pin_memory=shard_mesh.device_type == "cuda")
               if plugin.cpu_offload else OffloadPolicy())
    reshard = plugin.reshard_after_forward and plugin.sharding_strategy != "SHARD_GRAD_OP"
    kw = dict(mesh=shard_mesh, reshard_after_forward=reshard,
              mp_policy=mp, offload_policy=offload, ignored_params=set(ignored.values()) or None)
    for block in blocks:
        fully_shard(block, **kw)
    if root:
        fully_shard(module, **kw)
    return ignored


def apply_ddp(module: nn.Module, device: torch.device, ddp_kwargs=None) -> nn.Module:
    """``module`` replicated under DDP over the default group: the wrapper
    to run its forward through (its parameters are the module's own).
    ``ddp_kwargs`` (a ``DistributedDataParallelKwargs``) sets the reducer."""
    from torch.nn.parallel import DistributedDataParallel

    return DistributedDataParallel(
        module, device_ids=[device.index] if device.type == "cuda" else None,
        **(ddp_kwargs.ddp_kwargs() if ddp_kwargs is not None else {}))


def apply_tensor_parallel_model(model, state, plugin) -> None:
    """``model`` (a ``Model``) split over ``tp`` and ``ep`` by its rule
    table (``parallel/sharding.py``): the plan in ``model.tp_plan``, each
    split parameter a DTensor over the mesh's ``tp`` slice, each expert
    stack an ep rule splits a DTensor over the ep slice
    (``state.ExpertGroups``; by name in ``model.expert_params``). Without
    rules every parameter stays whole on every ``tp`` rank, as in the JAX
    plan."""
    from .sharding import apply_tensor_parallel, plan_parameter_sharding

    cfg = state.parallelism_config
    model.tp_plan = plan_parameter_sharding(
        model.module, state.device_mesh, fsdp_plugin=plugin, parallelism_config=cfg,
        tp_rules=model.tp_rules)
    if cfg.tp_size > 1:
        apply_tensor_parallel(model.module, model.tp_plan, state.tensor_parallel_mesh)
    _apply_expert_parallel(model, state)


def _apply_expert_parallel(model, state) -> None:
    """The expert stacks of ``model.tp_plan`` with an ep placement split
    over the ep slice; ``model.expert_params`` by name. Under ``ep_size >
    1`` a plan that splits no stack (rules without ``ep_axes``) is
    refused: the experts would be whole while the mesh says otherwise."""
    cfg = state.parallelism_config
    if cfg.ep_size == 1:
        return
    from .sharding import apply_tensor_parallel

    names = [n for n, pl in model.tp_plan.items() if pl.ep is not None]
    if not names:
        raise ValueError(
            f"ep_size={cfg.ep_size} but the model's TP rules split no expert stack over "
            f"ep_axes={cfg.ep_axes}: pass tp_rules=mixtral_tp_rules(ep_axes=pc.ep_axes)")
    apply_tensor_parallel(model.module, model.tp_plan, state.expert_groups.mesh, kind="ep")
    model.expert_params = {n: model.module.get_parameter(n) for n in names}


def apply_pipeline_stage(model, state, plugin, compute_dtype: torch.dtype) -> None:
    """``model`` (a ``Model`` of a family ``parallel/pp.STAGE_SPECS`` names)
    cut to this process's pipeline stage (``parallel/pp.keep_stage``; the
    names it shares with another stage in ``model.pipeline_shared``), then,
    on that stage's parameters only, what the other axes ask: the TP
    program over the stage's ``tp`` slice and the expert stacks over the ep
    slice inside the stage (``state.ExpertGroups``; the plan made on the
    whole module, with the JAX plan's ``pp`` rule), and over its
    ``(dp_replicate, dp_shard)`` slice FSDP2 on each block under a plugin
    that shards (the expert stacks left out), else every gradient averaged
    over the slice by the step (DDP's arithmetic, without DDP's wrapper)."""
    from .pp import keep_stage
    from .sharding import apply_tensor_parallel, plan_parameter_sharding

    cfg = state.parallelism_config
    n_stages, stage = state.pipeline_stage
    plan = None
    if cfg.tp_size > 1 or cfg.ep_size > 1:
        plan = plan_parameter_sharding(model.module, state.device_mesh, fsdp_plugin=plugin,
                                       parallelism_config=cfg, tp_rules=model.tp_rules)
    model.pipeline_shared = keep_stage(model.module, n_stages, stage, cfg.pp_virtual_stages)
    if plan is not None:
        names = {n for n, _ in model.module.named_parameters()}
        model.tp_plan = {n: pl for n, pl in plan.items() if n in names}
        if cfg.tp_size > 1:
            apply_tensor_parallel(model.module, model.tp_plan, state.tensor_parallel_mesh)
        _apply_expert_parallel(model, state)
    if state.loss_size == 1:
        return
    if plugin is not None and plugin.sharding_strategy != "NO_SHARD":
        model.ignored = apply_fsdp(model.module, state.data_parallel_mesh, plugin, compute_dtype,
                                   root=False, keep_whole=model.expert_params)
        model.sharded = True
    else:
        model.ignored = dict(model.module.named_parameters())


def _broadcast_parameters(module: nn.Module) -> None:
    """Every parameter and buffer from process 0, as DDP's constructor
    does, in one broadcast of a flat buffer per dtype."""
    from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

    import torch.distributed as dist

    tensors = [t.data for t in (*module.parameters(), *module.buffers())]
    for dtype in dict.fromkeys(t.dtype for t in tensors):
        same = [t for t in tensors if t.dtype == dtype]
        flat = _flatten_dense_tensors(same)
        dist.broadcast(flat, src=0)
        torch._foreach_copy_(same, _unflatten_dense_tensors(flat, same))


def apply_data_parallel(model, state, plugin, compute_dtype: torch.dtype,
                        ddp_kwargs=None) -> None:
    """Shard or replicate ``model`` (a ``Model``) over ``state``'s process
    group: FSDP2/HSDP with a plugin whose strategy shards, DDP without a
    plugin or under ``NO_SHARD``. Does nothing without a group.

    Under ``tp`` the model is first split over ``tp``
    (``apply_tensor_parallel_model``); the data-parallel axes then act on
    the ``(dp_replicate, dp_shard)`` slice of the same mesh: FSDP2 (2-D
    with the ``tp`` DTensors) under a plugin that shards, else every
    gradient averaged over the data-parallel group by the step
    (``average_whole_gradients``: DDP's arithmetic, without DDP's wrapper,
    whose hooks would hand a recomputed block its local tensors)."""
    if not state._partial.use_distributed:
        return
    if state.parallelism_config.pp_size > 1:
        apply_pipeline_stage(model, state, plugin, compute_dtype)
        return
    pc = state.parallelism_config
    if pc.tp_size > 1 or pc.ep_size > 1:
        apply_tensor_parallel_model(model, state, plugin)
        if state.loss_size == 1:
            return
        if plugin is not None and plugin.sharding_strategy != "NO_SHARD":
            model.ignored = apply_fsdp(model.module, state.data_parallel_mesh, plugin,
                                       compute_dtype, keep_whole=model.expert_params)
            model.sharded = True
        else:
            model.ignored = dict(model.module.named_parameters())
        return
    if plugin is not None and plugin.sharding_strategy == "NO_SHARD" and plugin.cpu_offload:
        raise NotImplementedError(
            "cpu_offload needs a strategy that shards (FSDP2's CPUOffloadPolicy); NO_SHARD "
            "replicates under DDP, which keeps every tensor on the device")
    if plugin is not None and plugin.sharding_strategy != "NO_SHARD":
        model.ignored = apply_fsdp(model.module, state.data_parallel_mesh, plugin, compute_dtype)
        model.sharded = True
    elif ddp_kwargs is not None and ddp_kwargs.comm_hook != "no":
        # The hooked step reduces the gradients itself (parallel/comm_hooks.py),
        # so no DDP reducer: the replicas start from process 0's weights, and
        # the imperative loop averages every gradient as DDP would.
        _broadcast_parameters(model.module)
        model.ignored = dict(model.module.named_parameters())
    else:
        model.forward_module = apply_ddp(model.module, state.device, ddp_kwargs)


@contextmanager
def gradient_sync(model, enabled: bool):
    """A forward and backward of ``model`` (a ``Model``) inside the block
    reduce the gradients over the processes, or with ``enabled=False``
    leave each process's own to accumulate: FSDP2's
    ``set_requires_gradient_sync(False)`` on the root (it recurses), turned
    back on at exit; DDP's ``no_sync()``, which DDP reads when the forward
    runs. Alone, nothing to skip."""
    if enabled:
        yield
    elif model.sharded:
        model.module.set_requires_gradient_sync(False)
        try:
            yield
        finally:
            model.module.set_requires_gradient_sync(True)
    elif model.forward_module is not model.module:
        with model.forward_module.no_sync():
            yield
    else:
        yield
