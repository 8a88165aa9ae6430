"""Training-state checkpoints in the JAX package's directory contract.

Counterpart of ``accelerate_tpu/checkpointing.py``. A checkpoint directory
holds:

- ``model.safetensors``: the fp32 master parameters under the flax tree's
  ``/``-joined names and in its layouts (``models/convert.py``), as one
  file (``FULL_STATE_DICT``) or 5 GB shards plus
  ``model.safetensors.index.json`` (``SHARDED_STATE_DICT``, the default);
- ``optimizer.bin``: a pickle of ``{"opt_state", "step", "extra_state"}``
  with ``opt_state`` in the structure of ``optax.adamw``'s chain state, so
  that the JAX package's ``load_state`` maps it onto its live state:
  ``(ScaleByAdamState(count, mu, nu), EmptyState(), EmptyState())``, the
  last ``ScaleByScheduleState(count)`` when the rate is a schedule, with
  the moments in the parameters' flax names and layouts (numpy leaves).
  The pickle names optax's classes (``_OptaxPickler``) without importing
  optax; the reader maps them to stand-ins (below), and still reads the
  plain ``{"count", "mu", "nu"}`` of older port checkpoints;
- ``scheduler.bin``, ``sampler.bin`` (a loader's full mid-epoch
  ``state_dict``), ``custom_checkpoint_<i>.pkl`` for registered objects,
  ``accelerator_step.bin`` and ``random_states_<rank>.pkl`` (with the JAX
  package's ``jax`` entry, ``utils/random.py``);
- ``scaler.bin`` under fp16 loss scaling: the JAX package's pickle
  ``{"scale": float, "growth_tracker": int}`` of the first model's scale,
  restored into the live one on load (a JAX fp16 checkpoint resumes with
  its scale);
- ``model_<i>.safetensors`` and ``optimizer_<i>.bin`` for a second and
  later prepared model.

So a checkpoint of either package resumes in the other.

``DISTRIBUTED_STATE_DICT`` replaces ``model.safetensors`` and
``optimizer.bin`` with ``distributed_state_torch/``, written with
``torch.distributed.checkpoint`` (DCP): every process writes its own
shards, nothing is gathered. It holds the model's and AdamW's state from
``get_state_dict`` (FSDP2's DTensors as they are sharded) under the flax
tree's ``/``-joined names of the unrolled layers (``params/...``,
``opt_state/mu/...``, ``opt_state/nu/...``), in the port's layouts, with
``opt_state/count``, ``step`` and the extra state's leaves
(``extra_state/batch_stats/...``); the other files are as above. A load
reads it into the live layout at any world size (DCP reshards), without a
process group too (``no_dist``). Under ``pp`` each stage writes its own
parameters and moments under their global names (a tied embedding two
stages hold is written once, DCP keeping one copy of a tensor several
processes hold whole), so a load takes each stage's at any ``pp`` and
``pp_virtual_stages``. ``save_state(block=False)`` stages the
state into host buffers (pinned on the card; ``_HostStaging``, DCP's
stager interface, keeps them for the next save) and returns;
a thread writes the files while training goes on, until
``Accelerator.wait_for_checkpoint``. The JAX package's orbax directory
(``distributed_state/``) is refused: each package reads only its own
distributed format, and the safetensors formats are the interchange. One
prepared model only, as in the JAX package.

With ``ProjectConfiguration(automatic_checkpoint_naming=True)`` the
directory is ``<project_dir>/checkpoints/checkpoint_<iteration>``: a save
prunes the oldest beyond ``total_limit`` first and then advances
``iteration``; a load takes the newest and continues the numbering past it.

Parameters and moments move to the host through pinned buffers, all copies
issued before one synchronisation, and back through pinned buffers with
asynchronous copies; the layout changes run on the device.

Over a process group the contract is the same. Sharded tensors (FSDP2's
DTensors) are gathered whole, one at a time, every process joining each
all-gather, and process 0 writes (each node's local process 0 with
``save_on_each_node``); every process writes its own
``random_states_<rank>.pkl``. On load every process reads the files and
keeps its own shard of each tensor, so a checkpoint written at one world
size (or by the JAX package under any mesh) loads at any other. The save
ends with a barrier, so that every file is there when it returns.

Every pickle of a checkpoint is read with a restricted unpickler: it
allows numpy's array reconstructors and maps optax's ``ScaleByAdamState``,
``ScaleByScheduleState`` and ``EmptyState`` to stand-in records of the same
fields, so a JAX checkpoint loads without optax; any other global is
refused.

Under ``FaultToleranceKwargs`` (``fault_tolerance.py``) a save writes into
``<dir>.tmp``, then process 0 writes ``manifest.json`` and renames the
directory (the commit), and ``total_limit`` prunes after the commit; a
``block=False`` save commits in ``finish_pending_save`` once its write has
finished. A load resolves to the newest checkpoint whose manifest
verifies.
"""

from __future__ import annotations

import contextlib
import logging
import os
import warnings
import pickle
import re
import shutil
import time
from collections import namedtuple
from typing import Optional

import numpy as np
import torch
from torch.distributed.tensor import DTensor, distribute_tensor

from .models.convert import _map_tree, flax_converter
from .train_state import tree_items
from .utils.constants import (
    CHECKPOINT_DIR_REGEX,
    DCP_DIR_NAME,
    MAX_SHARD_SIZE,
    MODEL_NAME,
    OPTIMIZER_NAME,
    ORBAX_DIR_NAME,
    RNG_STATE_NAME,
    SAMPLER_NAME,
    SCALER_NAME,
    SCHEDULER_NAME,
)
from .utils.operations import gather_shards
from .utils.other import (
    flatten_state_dict,
    load_sharded_safetensors,
    save_sharded_safetensors,
    unflatten_state_dict,
)
from .utils.random import load_rng_state, rng_state

logger = logging.getLogger(__name__)


class CheckpointSaveError(RuntimeError):
    """A checkpoint failed to persist: raised by
    ``Accelerator.wait_for_checkpoint`` for a ``save_state(block=False)``
    whose background write failed."""

# ---------------------------------------------------------------------------
# Reading pickles without optax
# ---------------------------------------------------------------------------

ScaleByAdamState = namedtuple("ScaleByAdamState", "count mu nu")
ScaleByScheduleState = namedtuple("ScaleByScheduleState", "count")
EmptyState = namedtuple("EmptyState", "")

_OPTAX_RECORDS = {
    ("optax._src.transform", "ScaleByAdamState"): ScaleByAdamState,
    ("optax._src.transform", "ScaleByScheduleState"): ScaleByScheduleState,
    ("optax._src.base", "EmptyState"): EmptyState,
}
_NUMPY_MODULES = ("numpy", "numpy.core.multiarray", "numpy._core.multiarray",
                  "numpy.core.numeric", "numpy._core.numeric")
_NUMPY_NAMES = ("ndarray", "dtype", "_reconstruct", "scalar", "_frombuffer")


class RestrictedUnpickler(pickle.Unpickler):
    """Unpickles plain data, numpy arrays and optax's adamw state records;
    refuses every other global."""

    def find_class(self, module, name):
        if (module, name) in _OPTAX_RECORDS:
            return _OPTAX_RECORDS[module, name]
        if (module in _NUMPY_MODULES and name in _NUMPY_NAMES
                or (module, name) == ("_codecs", "encode")):  # bytes at protocol < 3
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"checkpoint pickle refers to {module}.{name}, which a checkpoint does not hold "
            "(only numpy arrays and optax's ScaleByAdamState, ScaleByScheduleState and "
            "EmptyState are allowed)")


def restricted_load(path: str):
    with open(path, "rb") as f:
        return RestrictedUnpickler(f).load()


_OPTAX_NAMES = {cls: key for key, cls in _OPTAX_RECORDS.items()}


class _OptaxPickler(pickle._Pickler):
    """Pickles the stand-in records under optax's module and class names,
    as the JAX package's pickle of its optimizer state names them, so that
    a JAX process unpickles optax's own classes. Everything else as
    ``pickle.dump`` does (the pure-Python pickler, whose ``save_global``
    can be taught the names: the C one verifies each name by importing
    its module)."""

    def save_global(self, obj, name=None):
        if obj not in _OPTAX_NAMES:
            return super().save_global(obj, name)
        module, qualname = _OPTAX_NAMES[obj]
        self.save(module)
        self.save(qualname)
        self.write(pickle.STACK_GLOBAL)
        self.memoize(obj)


def _dump(obj, path: str) -> None:
    with open(path, "wb") as f:
        pickle.dump(obj, f, protocol=5)


def _dump_optax(obj, path: str) -> None:
    with open(path, "wb") as f:
        _OptaxPickler(f, protocol=5).dump(obj)


# ---------------------------------------------------------------------------
# Directories
# ---------------------------------------------------------------------------


def _checkpoint_index(name: str) -> Optional[int]:
    m = re.match(CHECKPOINT_DIR_REGEX, name)
    return int(m.group(1)) if m else None


def _list_checkpoint_dirs(base: str) -> list[str]:
    """``checkpoint_<N>`` entries of ``base`` by N; anything else is skipped."""
    found = [(_checkpoint_index(f), f) for f in os.listdir(base)]
    return [f for i, f in sorted(x for x in found if x[0] is not None)]


def _checkpoint_dir(accelerator, output_dir: Optional[str], for_load: bool = False) -> str:
    pc = accelerator.project_configuration
    if pc.automatic_checkpoint_naming and output_dir is None:
        base = os.path.join(accelerator.project_dir or ".", "checkpoints")
        if for_load:
            folders = _list_checkpoint_dirs(base) if os.path.isdir(base) else []
            if not folders:
                raise FileNotFoundError(f"No checkpoints found in {base}")
            ft = getattr(accelerator, "fault_tolerance", None)
            # Under fault tolerance: the newest checkpoint whose manifest
            # verifies, the torn ones skipped.
            chosen = (ft.resolve_verified(base, folders)
                      if ft is not None and ft.handler.verify_on_load else folders[-1])
            # The next save continues past the newest checkpoint, a torn one
            # too, so that no save reuses its name.
            pc.iteration = _checkpoint_index(folders[-1]) + 1
            return os.path.join(base, chosen)
        return os.path.join(base, f"checkpoint_{pc.iteration}")
    if output_dir is None:
        raise ValueError("Provide output_dir or enable automatic_checkpoint_naming.")
    return output_dir


def _prune_total_limit(accelerator, base: str, room_for: int) -> None:
    """Remove the oldest checkpoints so that ``room_for`` more fit
    ``total_limit``."""
    limit = accelerator.project_configuration.total_limit
    if limit is None or not os.path.isdir(base):
        return
    existing = _list_checkpoint_dirs(base)
    for f in existing[:max(0, len(existing) + room_for - limit)]:
        shutil.rmtree(os.path.join(base, f), ignore_errors=True)


# ---------------------------------------------------------------------------
# Host <-> device through pinned buffers
# ---------------------------------------------------------------------------


def _to_host(tensors: dict, device: torch.device) -> dict:
    """Copies of device tensors in (pinned) host memory: every copy is
    issued, then one synchronisation."""
    pin = device.type == "cuda"
    out = {}
    for k, t in tensors.items():
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=pin)
        host.copy_(t, non_blocking=pin)
        out[k] = host
    if pin:
        torch.cuda.synchronize(device)
    return out


def _whole(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """The whole tensor of a sharded one (``utils/operations.gather_shards``:
    an all-gather every process of its mesh joins; CPU-offloaded shards are
    gathered on the card), on ``device``; a plain tensor as it is."""
    if not isinstance(t, DTensor):
        return t
    return gather_shards(t, device)


def _to_device(tensors: dict, device: torch.device) -> dict:
    """Host tensors on ``device``; from pinned memory the copies do not
    wait (the caller's later use on the same stream orders after them)."""
    return {k: t.to(device, non_blocking=t.is_pinned()) for k, t in tensors.items()}


def _model_tree(module: torch.nn.Module, tensors: dict) -> dict:
    """Parameter-named tensors as the flax tree of the JAX package's model
    (the module class's converter, ``models/convert.FLAX_CONVERTERS``),
    else keyed by the module's own names with ``/``."""
    conv = flax_converter(module)
    if conv is not None:
        return conv.to_flax(module.config, tensors)
    return unflatten_state_dict({k.replace(".", "/"): v for k, v in tensors.items()})


def _flat_model_tree(module: torch.nn.Module, tensors: dict) -> dict:
    """``_model_tree`` flattened to ``/``-joined names, in sorted order: the
    order of the JAX package's prepared params (JAX's tree functions sort
    dict keys), so that shards split at the same keys."""
    return dict(sorted(flatten_state_dict(_model_tree(module, tensors)).items()))


def _model_views(module: torch.nn.Module, tree: dict) -> dict:
    """Inverse of ``_model_tree``: parameter name → tensor (a view where the
    layout allows) in the module's layout."""
    conv = flax_converter(module)
    if conv is not None:
        return conv.views_from_flax(module.config, tree)
    return {k.replace("/", "."): v for k, v in flatten_state_dict(tree).items()}


def _adam_state(opt: torch.optim.Optimizer, p: torch.nn.Parameter, group: dict) -> dict:
    """``opt.state[p]``, created as ``torch.optim.AdamW`` creates it before its
    first step when it does not exist yet."""
    state = opt.state[p]
    if not state:
        on_device = group.get("fused") or group.get("capturable")
        state["step"] = torch.zeros((), dtype=torch.float32,
                                    device=p.device if on_device else "cpu")
        state["exp_avg"] = torch.zeros_like(p, memory_format=torch.preserve_format)
        state["exp_avg_sq"] = torch.zeros_like(p, memory_format=torch.preserve_format)
    return state


def _named_params(train_state) -> list:
    """(name, parameter, its optimizer group) of every parameter the
    optimizer updates, in the module's order."""
    if not isinstance(train_state.optimizer, (torch.optim.Adam, torch.optim.AdamW)):
        raise NotImplementedError(
            f"checkpoints hold AdamW state; {type(train_state.optimizer).__name__} is not ported")
    groups = {id(p): g for g in train_state.optimizer.param_groups for p in g["params"]}
    return [(n, p, groups[id(p)]) for n, p in train_state.model.module.named_parameters()
            if id(p) in groups]


# ---------------------------------------------------------------------------
# DISTRIBUTED_STATE_DICT: torch.distributed.checkpoint
# ---------------------------------------------------------------------------


def _flax_name(module: torch.nn.Module, fqn: str) -> str:
    """The ``/``-joined name of a parameter in the unrolled flax tree of the
    module class's converter (Llama: ``layers_<i>``, ``kernel`` for a
    projection, ``embedding``), else the module's own name with ``/``."""
    conv = flax_converter(module)
    if conv is None:
        return fqn.replace(".", "/")
    return conv.flax_name(module.config, fqn)


def _dcp_state(train_state) -> tuple[dict, list]:
    """The DCP state of a train state, from ``get_state_dict``: parameters
    and AdamW moments (FSDP2's DTensors as sharded) under ``params/``,
    ``opt_state/mu/`` and ``opt_state/nu/`` plus the flax name, with
    ``opt_state/count`` and ``step``; and for each entry the live tensor it
    belongs to (the optimizer's state is created first, as AdamW creates
    it, so that ``get_state_dict`` takes no initialising step)."""
    from torch.distributed.checkpoint.state_dict import StateDictOptions, get_state_dict

    module, opt = train_state.model.module, train_state.optimizer
    named = _named_params(train_state)
    for _, p, g in named:
        _adam_state(opt, p, g)
    msd, osd = get_state_dict(module, opt,
                              options=StateDictOptions(flatten_optimizer_state_dict=True))
    state, live = {}, []
    for fqn, p, _ in named:
        name = _flax_name(module, fqn)
        for key, value, dst in ((f"params/{name}", msd[fqn], p),
                                (f"opt_state/mu/{name}", osd[f"state.{fqn}.exp_avg"],
                                 opt.state[p]["exp_avg"]),
                                (f"opt_state/nu/{name}", osd[f"state.{fqn}.exp_avg_sq"],
                                 opt.state[p]["exp_avg_sq"])):
            state[key] = value
            live.append((key, dst))
    for path, t in tree_items(train_state.extra_state or {}):
        key = "extra_state/" + "/".join(path)
        state[key] = t
        live.append((key, t))
    state["opt_state/count"] = torch.tensor(int(getattr(opt, "count", train_state.step)))
    state["step"] = torch.tensor(int(train_state.step))
    return state, live


def _local_view(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if isinstance(t, DTensor) else t


class _HostStaging:
    """DCP's ``AsyncStager`` for background saves: ``stage`` copies every
    tensor of the state into a host buffer it keeps (pinned on the card,
    with non-blocking copies and one synchronisation), so ``async_save``
    returns once the device-to-host copy is done. The buffers are reused by
    the next save of the same state: only the first pays for allocating
    (and pinning) them, and none is freed while training runs. A DTensor
    is staged as a DTensor of the same layout over its host shard."""

    should_synchronize_after_execute = False

    def __init__(self, pin: bool):
        self.pin = pin
        self.buffers: dict = {}

    def stage(self, state_dict: dict) -> dict:
        staged = {}
        for key, value in state_dict.items():
            local = _local_view(value)
            buf = self.buffers.get(key)
            if buf is None or buf.shape != local.shape or buf.dtype != local.dtype:
                buf = self.buffers[key] = torch.empty(local.shape, dtype=local.dtype,
                                                      pin_memory=self.pin)
            buf.copy_(local, non_blocking=self.pin)
            staged[key] = (DTensor.from_local(buf, value.device_mesh, value.placements,
                                              run_check=False, shape=value.shape,
                                              stride=value.stride())
                           if isinstance(value, DTensor) else buf)
        if self.pin:
            torch.cuda.synchronize()
        return staged

    def synchronize_staging(self) -> None:
        pass

    def close(self) -> None:
        self.buffers.clear()


def _stager(accelerator) -> _HostStaging:
    """The accelerator's stager (``_HostStaging``), kept from one background
    save to the next; ``release_staging`` drops its buffers (at
    ``end_training`` and ``free_memory``)."""
    if getattr(accelerator, "_dcp_stager", None) is None:
        accelerator._dcp_stager = _HostStaging(pin=accelerator.device.type == "cuda")
    return accelerator._dcp_stager


def release_staging(accelerator) -> None:
    """Free the host copies a background save kept (after waiting for it)."""
    finish_pending_save(accelerator)
    stager = getattr(accelerator, "_dcp_stager", None)
    if stager is not None:
        accelerator._dcp_stager = None
        stager.close()


def _async_group(accelerator):
    """The gloo group a background save plans over (None alone): DCP needs
    a CPU backend there, and its thread must not interleave collectives
    with the training's on the default group. Made once, by every
    process."""
    if not accelerator.use_distributed:
        return None
    if getattr(accelerator, "_dcp_async_group", None) is None:
        accelerator._dcp_async_group = torch.distributed.new_group(backend="gloo")
    return accelerator._dcp_async_group


@contextlib.contextmanager
def _no_single_process_warning():
    """DCP warns that it saves or loads in one process even when told so
    (``no_dist``)."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="torch.distributed is disabled")
        yield


def _dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(root, f))
               for root, _, files in os.walk(path) for f in files)


def _save_distributed(accelerator, output_dir: str, block: bool, stats: dict) -> None:
    """Every process writes its own shards to ``<output_dir>/distributed_state_torch``;
    with ``block=False`` the state is staged into host memory and a thread
    writes it (``accelerator._pending_save``)."""
    import torch.distributed.checkpoint as dcp

    if len(accelerator._train_states) > 1:
        raise NotImplementedError(
            "DISTRIBUTED_STATE_DICT saves a single prepared model, as in the JAX package; use "
            "FULL_STATE_DICT or SHARDED_STATE_DICT for more than one")
    path = os.path.join(output_dir, DCP_DIR_NAME)
    state, _ = _dcp_state(accelerator._train_states[0])
    no_dist = not accelerator.use_distributed
    t0 = time.perf_counter()
    if block:
        with _no_single_process_warning():
            dcp.save(state, checkpoint_id=path, no_dist=no_dist)
        stats["write_s"] += time.perf_counter() - t0
        return
    future = dcp.async_save(state, checkpoint_id=path, process_group=_async_group(accelerator),
                            async_stager=_stager(accelerator), no_dist=no_dist)
    stats["stage_s"] = time.perf_counter() - t0
    stats["staged_bytes"] = sum(_local_view(t).numel() * t.element_size()
                                for t in state.values())
    # Whether the write was still running when the call returned.
    stats["persisting_at_return"] = not future.done()
    accelerator._pending_save = {"future": future, "dir": output_dir, "path": path,
                                 "started": time.perf_counter()}


def finish_pending_save(accelerator) -> Optional[dict]:
    """Wait for the save ``save_state(block=False)`` left in flight, if any:
    its seconds (``wait_s``, and ``persist_s`` since the call returned) and
    bytes join ``accelerator.checkpoint_stats``. A failure in the
    background raises ``CheckpointSaveError`` (and is recorded as a
    telemetry event); the save is no longer in flight either way."""
    pending = getattr(accelerator, "_pending_save", None)
    if pending is None:
        return None
    accelerator._pending_save = None
    t0 = time.perf_counter()
    try:
        pending["future"].result()
    except Exception as exc:
        tel = getattr(accelerator, "telemetry", None)
        if tel is not None:
            tel.record_event("checkpoint_async_error", dir=pending["dir"],
                             error=f"{type(exc).__name__}: {exc}"[:500])
        if pending.get("commit") is not None:  # an uncommitted staging directory
            shutil.rmtree(pending["dir"], ignore_errors=True)
        raise CheckpointSaveError(
            f"the checkpoint {pending['dir']} failed to persist in the background: {exc}"
        ) from exc
    accelerator.wait_for_everyone()
    if pending.get("commit") is not None:
        # Under fault tolerance the background write committed nothing yet:
        # the manifest and the rename come now that every byte is on disk.
        final_dir, step = pending["commit"]
        _finalize_save(accelerator, pending["dir"], final_dir, step)
        pending["dir"] = final_dir
    done = {"wait_s": time.perf_counter() - t0,
            "persist_s": time.perf_counter() - pending["started"],
            "bytes": _dir_bytes(pending["dir"])}
    if accelerator.checkpoint_stats and accelerator.checkpoint_stats.get("dir") == pending["dir"]:
        accelerator.checkpoint_stats.update(done)
    return done


def _load_distributed(accelerator, input_dir: str, stats: dict) -> None:
    """``<input_dir>/distributed_state_torch`` read into the live tensors,
    resharded to this run's layout by DCP."""
    import torch.distributed.checkpoint as dcp

    if len(accelerator._train_states) > 1:
        raise NotImplementedError(
            "DISTRIBUTED_STATE_DICT holds a single prepared model, as in the JAX package")
    train_state = accelerator._train_states[0]
    opt = train_state.optimizer
    state, live = _dcp_state(train_state)
    t0 = time.perf_counter()
    with _no_single_process_warning():
        dcp.load(state, checkpoint_id=os.path.join(input_dir, DCP_DIR_NAME),
                 no_dist=not accelerator.use_distributed)
    with torch.no_grad():  # where get_state_dict handed out a copy
        for key, dst in live:
            src = state[key]
            if _local_view(src).data_ptr() != _local_view(dst).data_ptr():
                _local_view(dst).copy_(_local_view(src))
    count = int(state["opt_state/count"])
    for _, p, _ in _named_params(train_state):
        opt.state[p]["step"].fill_(count)
    if hasattr(opt, "count"):
        opt.count = count
    train_state.set_step(int(state["step"]))
    if accelerator.device.type == "cuda":
        torch.cuda.synchronize(accelerator.device)
    stats["read_s"] += time.perf_counter() - t0


# ---------------------------------------------------------------------------
# Save
# ---------------------------------------------------------------------------


def _suffix(i: int) -> str:
    return "" if i == 0 else f"_{i}"


def _pipeline_leader_group():
    """Under ``pp``: (the group of the processes that lead each stage of
    process 0's pipeline, whether this process is one); (None, False)
    without ``pp``. A stage's leader is its process whose other mesh
    coordinates are all 0."""
    from .state import AcceleratorState

    state = AcceleratorState()
    cfg = state.parallelism_config
    if cfg.pp_size == 1 or not state._partial.use_distributed:
        return None, False
    leader = state._partial.process_index % cfg.non_pp_size == 0
    return (state.pipeline_mesh.get_group() if leader else None), leader


def _pipeline_stage_count() -> int:
    from .state import AcceleratorState

    pc = AcceleratorState._shared_state.get("parallelism_config")
    return 1 if pc is None else pc.pp_size


def _gather_stages(host: dict, group) -> dict:
    """Under ``pp``, on process 0: every stage's whole host tensors merged
    (their names are global; a tied weight two stages hold is equal on
    both); the other leaders send theirs and get None."""
    import torch.distributed as dist

    parts = [None] * dist.get_world_size(group) if dist.get_rank() == 0 else None
    dist.gather_object(host, parts, dst=0, group=group)
    if parts is None:
        return None
    return {key: {n: t for part in parts for n, t in part[key].items()} for key in host}


def _save_train_state(train_state, i: int, write_dir: str, max_shard, device,
                      stats: dict, writer: bool = True) -> None:
    """Write one model's parameters and moments; under FSDP2 or ``tp``
    every process joins the gathers (whole tensors, the JAX package's
    layout) and only the ``writer`` keeps and writes them. Under ``pp`` each
    stage's leader gathers its stage's whole tensors and sends them to the
    writer (process 0)."""
    module, opt = train_state.model.module, train_state.optimizer
    split = any(isinstance(p, DTensor) for p in module.parameters())  # FSDP2 or tp
    stage_group, leader = _pipeline_leader_group()
    if not (writer or split or leader):
        return
    named = _named_params(train_state)
    trees = {"params": {n: p.detach() for n, p, _ in named}}
    for key in ("exp_avg", "exp_avg_sq"):
        trees[key] = {n: _adam_state(opt, p, g)[key] for n, p, g in named}
    t0 = time.perf_counter()
    host = {}
    keep = writer or leader
    for key, tensors in trees.items():
        whole = {}
        for n, t in tensors.items():
            full = _whole(t, device)
            if keep:
                whole[n] = full
        if keep:
            host[key] = (_to_host(whole, device) if stage_group is not None
                         else _to_host(_flat_model_tree(module, whole), device))
        del whole
    if stage_group is not None:
        host = _gather_stages(host, stage_group)
        if writer:
            host = {key: _flat_model_tree(module, tensors) for key, tensors in host.items()}
    stats["d2h_s"] += time.perf_counter() - t0
    if not writer:
        return
    flat_params, moments = host["params"], host

    t0 = time.perf_counter()
    save_sharded_safetensors(flat_params, write_dir, max_shard_size=max_shard,
                             weights_name=f"{MODEL_NAME}{_suffix(i)}.safetensors")
    count = np.asarray(int(getattr(opt, "count", train_state.step)), dtype=np.int32)
    adam = ScaleByAdamState(
        count, unflatten_state_dict({k: v.numpy() for k, v in moments["exp_avg"].items()}),
        unflatten_state_dict({k: v.numpy() for k, v in moments["exp_avg_sq"].items()}))
    # optax.adamw: scale_by_adam, add_decayed_weights, then the rate's
    # transform (scale_by_schedule for a schedule, stateless for a float).
    rate = ScaleByScheduleState(count.copy()) if getattr(opt, "scheduled", False) else EmptyState()
    extra = (None if train_state.extra_state is None else _map_tree(
        lambda t: t.detach().cpu().numpy(), train_state.extra_state))
    _dump_optax({"opt_state": (adam, EmptyState(), rate), "step": int(train_state.step),
                 "extra_state": extra},
                os.path.join(write_dir, f"{OPTIMIZER_NAME}{_suffix(i)}.bin"))
    stats["write_s"] += time.perf_counter() - t0


def _save_host_side_state(accelerator, output_dir: str, writer: bool) -> None:
    _dump(rng_state(), os.path.join(
        output_dir, f"{RNG_STATE_NAME}_{accelerator.process_index}.pkl"))
    if not writer:
        return
    loss_scale = accelerator._train_states[0].loss_scale
    if loss_scale is not None:
        _dump({"scale": float(loss_scale.scale), "growth_tracker": int(loss_scale.growth_tracker)},
              os.path.join(output_dir, f"{SCALER_NAME}.bin"))
    for i, scheduler in enumerate(accelerator._schedulers):
        _dump(scheduler.state_dict(), os.path.join(output_dir, f"{SCHEDULER_NAME}{_suffix(i)}.bin"))
    for i, dl in enumerate(accelerator._dataloaders):
        _dump(dl.state_dict(), os.path.join(output_dir, f"{SAMPLER_NAME}{_suffix(i)}.bin"))
    for i, obj in enumerate(accelerator._custom_objects):
        save_custom_state(obj, output_dir, i)
    _dump({"step": accelerator.step}, os.path.join(output_dir, "accelerator_step.bin"))


def _finalize_save(accelerator, write_dir: str, final_dir: str, step: int) -> None:
    """The commit of an atomic save: every process has written into the
    staging directory; process 0 writes the manifest and renames it; then
    ``total_limit`` prunes."""
    ft = accelerator.fault_tolerance
    accelerator.wait_for_everyone()
    if accelerator.is_main_process:
        ft.commit(write_dir, final_dir, step)
    accelerator.wait_for_everyone()
    if accelerator.project_configuration.automatic_checkpoint_naming and \
            accelerator.is_main_process:
        _prune_total_limit(accelerator, os.path.dirname(final_dir), room_for=0)


def save_accelerator_state(accelerator, output_dir: Optional[str] = None,
                           block: bool = True) -> str:
    """Write the prepared training state to ``output_dir`` (or the next
    automatic checkpoint directory) and return the directory. Fills
    ``accelerator.checkpoint_stats`` with the seconds of the whole save, of
    the copies to the host and of the writes, and the bytes written.
    ``block=False`` under ``DISTRIBUTED_STATE_DICT`` returns once the state
    is staged in host memory (``finish_pending_save`` waits for the rest);
    the safetensors formats warn and save synchronously, as the JAX
    package does."""
    t_start = time.perf_counter()
    if not accelerator._train_states:
        raise RuntimeError("Nothing prepared; call accelerator.prepare(...) first.")
    pc = accelerator.project_configuration
    plugin = accelerator.fsdp_plugin
    distributed = plugin is not None and plugin.state_dict_type == "DISTRIBUTED_STATE_DICT"
    if not block and not distributed:
        logger.warning("save_state(block=False) is only asynchronous for DISTRIBUTED_STATE_DICT "
                       "checkpoints; the safetensors gather path saves synchronously.")
        block = True
    # One writer of the shared files: process 0, or each node's local process 0
    # (under pp process 0 alone, which the stages send their tensors to).
    writer = (accelerator.is_local_main_process
              if pc.save_on_each_node and accelerator.parallelism_config.pp_size == 1
              else accelerator.is_main_process)
    output_dir = _checkpoint_dir(accelerator, output_dir)
    ft = getattr(accelerator, "fault_tolerance", None)
    atomic = ft is not None and ft.atomic
    if pc.automatic_checkpoint_naming:
        base = os.path.dirname(output_dir)
        os.makedirs(base, exist_ok=True)
        # Under atomic saves total_limit prunes after the commit
        # (_finalize_save), so a failed save never removes the only good one.
        if writer and not atomic:
            _prune_total_limit(accelerator, base, room_for=1)
    write_dir = output_dir
    if atomic:
        from .fault_tolerance import staging_path

        write_dir = staging_path(output_dir)
        if (accelerator.is_main_process and os.path.isdir(write_dir)
                and not ft.consume_prearmed(write_dir)):
            shutil.rmtree(write_dir)  # a failed or killed attempt's leftovers
        accelerator.wait_for_everyone()
    os.makedirs(write_dir, exist_ok=True)

    max_shard = (MAX_SHARD_SIZE if plugin is None or plugin.state_dict_type == "SHARDED_STATE_DICT"
                 else 10**15)
    stats = {"d2h_s": 0.0, "write_s": 0.0}
    if distributed:
        _save_distributed(accelerator, write_dir, block, stats)
    else:
        for i, train_state in enumerate(accelerator._train_states):
            _save_train_state(train_state, i, write_dir, max_shard, accelerator.device, stats,
                              writer)
    _save_host_side_state(accelerator, write_dir, writer)
    accelerator.wait_for_everyone()
    if atomic:
        step = int(accelerator._train_states[0].step)
        if block:
            t0 = time.perf_counter()
            _finalize_save(accelerator, write_dir, output_dir, step)
            stats["commit_s"] = time.perf_counter() - t0
        else:  # committed by finish_pending_save once the write is done
            accelerator._pending_save["commit"] = (output_dir, step)
    if pc.automatic_checkpoint_naming:
        pc.iteration += 1
    stats["seconds"] = time.perf_counter() - t_start
    if block:
        stats["bytes"] = _dir_bytes(output_dir)
    fmt = "dcp" if distributed else "safetensors"
    accelerator.checkpoint_stats = {"event": "save", "dir": output_dir, "format": fmt,
                                    "blocking": block, **stats}
    _record_checkpoint_event(accelerator, "checkpoint_save", output_dir, fmt, stats)
    return output_dir


def _record_checkpoint_event(accelerator, event: str, path: str, fmt: str,
                             stats: dict) -> None:
    """The save's or load's seconds (and its split) in the telemetry JSONL,
    beside the step records, as the JAX package records them."""
    tel = getattr(accelerator, "telemetry", None)
    if tel is not None:
        tel.record_event(event, dir=path, format=fmt, **stats)


# ---------------------------------------------------------------------------
# Load
# ---------------------------------------------------------------------------


def _opt_payload_parts(opt_state):
    """(count, mu tree, nu tree) from the port's dict or optax's state tuple."""
    if isinstance(opt_state, dict):
        return int(opt_state["count"]), opt_state["mu"], opt_state["nu"]
    for part in opt_state:
        if isinstance(part, ScaleByAdamState):
            return int(np.asarray(part.count)), part.mu, part.nu
    raise ValueError(
        "optimizer.bin holds no adamw state (ScaleByAdamState): only adamw is ported")


def _copy_named(dst: dict, src: dict, what: str) -> None:
    """``dst[name].copy_(src[name])`` for every name, which must match; a
    sharded ``dst`` takes its own shard of the whole ``src``."""
    if set(dst) != set(src):
        missing, extra = sorted(set(dst) - set(src)), sorted(set(src) - set(dst))
        raise KeyError(f"{what}: checkpoint lacks {missing[:5]}, has unknown {extra[:5]}")
    with torch.no_grad():
        for name, t in dst.items():
            if tuple(src[name].shape) != tuple(t.shape):
                raise ValueError(f"{what}: {name} is {tuple(src[name].shape)} in the checkpoint, "
                                 f"{tuple(t.shape)} here")
            if isinstance(t, DTensor):
                shard = distribute_tensor(src[name].contiguous(), t.device_mesh, t.placements,
                                          src_data_rank=None)
                t.to_local().copy_(shard.to_local())
            else:
                t.copy_(src[name])


def _load_train_state(train_state, i: int, input_dir: str, device, stats: dict) -> None:
    module, opt = train_state.model.module, train_state.optimizer
    pin = device.type == "cuda"
    t0 = time.perf_counter()
    flat = load_sharded_safetensors(input_dir, f"{MODEL_NAME}{_suffix(i)}.safetensors",
                                    pin_memory=pin)
    opt_path = os.path.join(input_dir, f"{OPTIMIZER_NAME}{_suffix(i)}.bin")
    if not os.path.exists(opt_path):
        raise FileNotFoundError(f"Checkpoint {input_dir} has no {os.path.basename(opt_path)}")
    payload = restricted_load(opt_path)
    count, mu, nu = _opt_payload_parts(payload["opt_state"])
    stats["read_s"] += time.perf_counter() - t0

    t0 = time.perf_counter()
    named = _named_params(train_state)
    params = {n: p for n, p, _ in named}
    # Under pp a stage holds some of the checkpoint's tensors: its own.
    stage = _pipeline_stage_count() > 1

    def views(host):
        out = _model_views(module, unflatten_state_dict(_to_device(host, device)))
        return {n: v for n, v in out.items() if n in params} if stage else out

    _copy_named(params, views(flat), "parameters")
    for key, tree in (("exp_avg", mu), ("exp_avg_sq", nu)):
        host = {k: torch.from_numpy(np.asarray(v)) if not torch.is_tensor(v) else v
                for k, v in flatten_state_dict(tree).items()}
        _copy_named({n: _adam_state(opt, p, g)[key] for n, p, g in named}, views(host),
                    f"optimizer {key}")
    for _, p, g in named:
        opt.state[p]["step"].fill_(count)
    if hasattr(opt, "count"):
        opt.count = count
    train_state.set_step(int(payload["step"]))
    if payload.get("extra_state") is not None and train_state.extra_state is not None:
        train_state.set_extra_state(_map_tree(
            lambda a: torch.as_tensor(np.asarray(a)), payload["extra_state"]))
    if pin:
        torch.cuda.synchronize(device)
    stats["h2d_s"] += time.perf_counter() - t0


def _load_host_side_state(accelerator, input_dir: str) -> None:
    def read(name):
        path = os.path.join(input_dir, name)
        return restricted_load(path) if os.path.exists(path) else None

    loss_scale = accelerator._train_states[0].loss_scale
    scaler = read(f"{SCALER_NAME}.bin")
    if loss_scale is not None and scaler is not None:
        loss_scale.scale.fill_(float(scaler["scale"]))
        loss_scale.growth_tracker.fill_(int(scaler["growth_tracker"]))
    for i, scheduler in enumerate(accelerator._schedulers):
        sd = read(f"{SCHEDULER_NAME}{_suffix(i)}.bin")
        if sd is not None:
            scheduler.load_state_dict(sd)
    for i, dl in enumerate(accelerator._dataloaders):
        sd = read(f"{SAMPLER_NAME}{_suffix(i)}.bin")
        if sd is not None:
            dl.load_state_dict(sd)  # arms the mid-epoch skip of the next pass
    for i, obj in enumerate(accelerator._custom_objects):
        if os.path.exists(os.path.join(input_dir, f"custom_checkpoint_{i}.pkl")):
            load_custom_state(obj, input_dir, i)
    step = read("accelerator_step.bin")
    if step is not None:
        accelerator.step = step["step"]
    rng = read(f"{RNG_STATE_NAME}_{accelerator.process_index}.pkl")
    if rng is not None:
        load_rng_state(rng)


def load_accelerator_state(accelerator, input_dir: Optional[str] = None) -> str:
    """Restore the prepared training state from ``input_dir`` (or the
    newest automatic checkpoint), written by this package or the JAX
    package, in place: parameters and moments are copied into the live
    tensors. Returns the directory and fills ``accelerator.checkpoint_stats``
    with the seconds of the whole load, of the reads and of the copies to
    the device."""
    t_start = time.perf_counter()
    if not accelerator._train_states:
        raise RuntimeError("Call accelerator.prepare(...) before load_state().")
    input_dir = _checkpoint_dir(accelerator, input_dir, for_load=True)
    ft = getattr(accelerator, "fault_tolerance", None)
    if ft is not None and ft.handler.verify_on_load:
        ft.verify_before_load(input_dir)  # an explicit path; the resolver's pick passes
    stats = {"read_s": 0.0, "h2d_s": 0.0}
    distributed = os.path.isdir(os.path.join(input_dir, DCP_DIR_NAME))
    if distributed:
        _load_distributed(accelerator, input_dir, stats)
    else:
        if (os.path.isdir(os.path.join(input_dir, ORBAX_DIR_NAME))
                and not os.path.exists(os.path.join(input_dir, f"{OPTIMIZER_NAME}.bin"))):
            raise ValueError(
                f"{input_dir} holds the JAX package's DISTRIBUTED_STATE_DICT (orbax, "
                f"{ORBAX_DIR_NAME}/), which the port does not read: save it from the JAX package "
                "with state_dict_type FULL_STATE_DICT or SHARDED_STATE_DICT (safetensors), the "
                "formats both packages read")
        for i, train_state in enumerate(accelerator._train_states):
            _load_train_state(train_state, i, input_dir, accelerator.device, stats)
    _load_host_side_state(accelerator, input_dir)
    stats["seconds"] = time.perf_counter() - t_start
    fmt = "dcp" if distributed else "safetensors"
    accelerator.checkpoint_stats = {"event": "load", "dir": input_dir, "format": fmt, **stats}
    _record_checkpoint_event(accelerator, "checkpoint_load", input_dir, fmt, stats)
    return input_dir


def save_custom_state(obj, path: str, index: int = 0) -> None:
    _dump(obj.state_dict(), os.path.join(path, f"custom_checkpoint_{index}.pkl"))


def load_custom_state(obj, path: str, index: int = 0) -> None:
    obj.load_state_dict(restricted_load(os.path.join(path, f"custom_checkpoint_{index}.pkl")))
