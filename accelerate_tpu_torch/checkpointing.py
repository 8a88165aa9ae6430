"""Training-state checkpoints in the JAX package's directory contract.

Counterpart of ``accelerate_tpu/checkpointing.py`` (its safetensors path).
A checkpoint directory holds:

- ``model.safetensors``: the fp32 master parameters under the flax tree's
  ``/``-joined names and in its layouts (``models/convert.py``), as one
  file (``FULL_STATE_DICT``) or 5 GB shards plus
  ``model.safetensors.index.json`` (``SHARDED_STATE_DICT``, the default);
- ``optimizer.bin``: a pickle of ``{"opt_state", "step", "extra_state"}``.
  The port writes ``opt_state`` as the plain dict ``{"count", "mu", "nu"}``
  with the moments in the parameters' flax names and layouts (numpy
  leaves); the JAX package writes optax's state tuple, which the port reads
  (below);
- ``scheduler.bin``, ``sampler.bin`` (a loader's full mid-epoch
  ``state_dict``), ``custom_checkpoint_<i>.pkl`` for registered objects,
  ``accelerator_step.bin`` and ``random_states_<rank>.pkl``;
- ``scaler.bin`` under fp16 loss scaling: the JAX package's pickle
  ``{"scale": float, "growth_tracker": int}`` of the first model's scale,
  restored into the live one on load (a JAX fp16 checkpoint resumes with
  its scale);
- ``model_<i>.safetensors`` and ``optimizer_<i>.bin`` for a second and
  later prepared model.

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
refused. The JAX package's ``random_states_0.pkl`` holds ``python``,
``numpy`` and ``jax`` states: the first two are restored, ``jax`` is
skipped (``utils/random.py``).

Not ported: the atomic manifest commit of ``fault_tolerance.py`` and orbax
(``DISTRIBUTED_STATE_DICT``). A JAX process cannot unpickle the port's
``optimizer.bin`` as optax state, so resuming a port checkpoint in the JAX
package's ``load_state`` is not supported; its ``model.safetensors`` reads
back there exactly.
"""

from __future__ import annotations

import os
import pickle
import re
import shutil
import time
from collections import namedtuple
from typing import Optional

import numpy as np
import torch
from torch.distributed.tensor import DTensor, distribute_tensor

from .models.convert import llama_params_to_flax, llama_views_from_flax
from .models.llama import LlamaForCausalLM
from .utils.constants import (
    CHECKPOINT_DIR_REGEX,
    MAX_SHARD_SIZE,
    MODEL_NAME,
    OPTIMIZER_NAME,
    RNG_STATE_NAME,
    SAMPLER_NAME,
    SCALER_NAME,
    SCHEDULER_NAME,
)
from .utils.other import (
    flatten_state_dict,
    load_sharded_safetensors,
    save_sharded_safetensors,
    unflatten_state_dict,
)
from .utils.random import load_rng_state, rng_state

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


def _dump(obj, path: str) -> None:
    with open(path, "wb") as f:
        pickle.dump(obj, f, protocol=5)


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
            # The next save continues past the newest checkpoint.
            pc.iteration = _checkpoint_index(folders[-1]) + 1
            return os.path.join(base, folders[-1])
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
    """The whole tensor of a sharded one (an all-gather every process of
    its mesh joins), on ``device``; a plain tensor as it is."""
    if not isinstance(t, DTensor):
        return t
    if t.device.type != device.type:  # CPU-offloaded shards, gathered on the card
        t = DTensor.from_local(t.to_local().to(device), t.device_mesh, t.placements,
                               shape=t.shape, stride=t.stride())
    return t.full_tensor()


def _to_device(tensors: dict, device: torch.device) -> dict:
    """Host tensors on ``device``; from pinned memory the copies do not
    wait (the caller's later use on the same stream orders after them)."""
    return {k: t.to(device, non_blocking=t.is_pinned()) for k, t in tensors.items()}


def _model_tree(module: torch.nn.Module, tensors: dict) -> dict:
    """Parameter-named tensors as the flax tree of the JAX package's model
    (Llama), else keyed by the module's own names with ``/``."""
    if isinstance(module, LlamaForCausalLM):
        return llama_params_to_flax(module.config, tensors)
    return unflatten_state_dict({k.replace(".", "/"): v for k, v in tensors.items()})


def _flat_model_tree(module: torch.nn.Module, tensors: dict) -> dict:
    """``_model_tree`` flattened to ``/``-joined names, in sorted order: the
    order of the JAX package's prepared params (JAX's tree functions sort
    dict keys), so that shards split at the same keys."""
    return dict(sorted(flatten_state_dict(_model_tree(module, tensors)).items()))


def _model_views(module: torch.nn.Module, tree: dict) -> dict:
    """Inverse of ``_model_tree``: parameter name → tensor (a view where the
    layout allows) in the module's layout."""
    if isinstance(module, LlamaForCausalLM):
        return llama_views_from_flax(module.config, tree)
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
# Save
# ---------------------------------------------------------------------------


def _suffix(i: int) -> str:
    return "" if i == 0 else f"_{i}"


def _save_train_state(train_state, i: int, write_dir: str, max_shard, device,
                      stats: dict, writer: bool = True) -> None:
    """Write one model's parameters and moments; under FSDP2 every process
    joins the gathers and only the ``writer`` keeps and writes them."""
    module, opt = train_state.model.module, train_state.optimizer
    if not (writer or train_state.model.sharded):
        return
    named = _named_params(train_state)
    trees = {"params": {n: p.detach() for n, p, _ in named}}
    for key in ("exp_avg", "exp_avg_sq"):
        trees[key] = {n: _adam_state(opt, p, g)[key] for n, p, g in named}
    t0 = time.perf_counter()
    host = {}
    for key, tensors in trees.items():
        whole = {}
        for n, t in tensors.items():
            full = _whole(t, device)
            if writer:
                whole[n] = full
        if writer:
            host[key] = _to_host(_flat_model_tree(module, whole), device)
        del whole
    stats["d2h_s"] += time.perf_counter() - t0
    if not writer:
        return
    flat_params, moments = host["params"], host

    t0 = time.perf_counter()
    save_sharded_safetensors(flat_params, write_dir, max_shard_size=max_shard,
                             weights_name=f"{MODEL_NAME}{_suffix(i)}.safetensors")
    count = int(getattr(opt, "count", train_state.step))
    opt_state = {"count": np.asarray(count, dtype=np.int32),
                 "mu": unflatten_state_dict({k: v.numpy() for k, v in moments["exp_avg"].items()}),
                 "nu": unflatten_state_dict(
                     {k: v.numpy() for k, v in moments["exp_avg_sq"].items()})}
    _dump({"opt_state": opt_state, "step": int(train_state.step), "extra_state": None},
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


def save_accelerator_state(accelerator, output_dir: Optional[str] = None) -> str:
    """Write the prepared training state to ``output_dir`` (or the next
    automatic checkpoint directory) and return the directory. Fills
    ``accelerator.checkpoint_stats`` with the seconds of the whole save, of
    the copies to the host and of the writes, and the bytes written."""
    t_start = time.perf_counter()
    if not accelerator._train_states:
        raise RuntimeError("Nothing prepared; call accelerator.prepare(...) first.")
    pc = accelerator.project_configuration
    # One writer of the shared files: process 0, or each node's local process 0.
    writer = (accelerator.is_local_main_process if pc.save_on_each_node
              else accelerator.is_main_process)
    output_dir = _checkpoint_dir(accelerator, output_dir)
    if pc.automatic_checkpoint_naming:
        base = os.path.dirname(output_dir)
        os.makedirs(base, exist_ok=True)
        if writer:
            _prune_total_limit(accelerator, base, room_for=1)
    os.makedirs(output_dir, exist_ok=True)

    plugin = accelerator.fsdp_plugin
    max_shard = (MAX_SHARD_SIZE if plugin is None or plugin.state_dict_type == "SHARDED_STATE_DICT"
                 else 10**15)
    stats = {"d2h_s": 0.0, "write_s": 0.0}
    for i, train_state in enumerate(accelerator._train_states):
        _save_train_state(train_state, i, output_dir, max_shard, accelerator.device, stats,
                          writer)
    _save_host_side_state(accelerator, output_dir, writer)
    accelerator.wait_for_everyone()
    if pc.automatic_checkpoint_naming:
        pc.iteration += 1
    stats["seconds"] = time.perf_counter() - t_start
    stats["bytes"] = sum(os.path.getsize(os.path.join(output_dir, f))
                         for f in os.listdir(output_dir))
    accelerator.checkpoint_stats = {"event": "save", "dir": output_dir, **stats}
    _record_checkpoint_event(accelerator, "checkpoint_save", output_dir, stats)
    return output_dir


def _record_checkpoint_event(accelerator, event: str, path: str, stats: dict) -> None:
    """The save's or load's seconds (and its split) in the telemetry JSONL,
    beside the step records, as the JAX package records them."""
    tel = getattr(accelerator, "telemetry", None)
    if tel is not None:
        tel.record_event(event, dir=path, format="safetensors", **stats)


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
    _copy_named(params, _model_views(module, unflatten_state_dict(_to_device(flat, device))),
                "parameters")
    for key, tree in (("exp_avg", mu), ("exp_avg_sq", nu)):
        host = {k: torch.from_numpy(np.asarray(v)) if not torch.is_tensor(v) else v
                for k, v in flatten_state_dict(tree).items()}
        _copy_named({n: _adam_state(opt, p, g)[key] for n, p, g in named},
                    _model_views(module, unflatten_state_dict(_to_device(host, device))),
                    f"optimizer {key}")
    for _, p, g in named:
        opt.state[p]["step"].fill_(count)
    if hasattr(opt, "count"):
        opt.count = count
    train_state.set_step(int(payload["step"]))
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
    stats = {"read_s": 0.0, "h2d_s": 0.0}
    for i, train_state in enumerate(accelerator._train_states):
        _load_train_state(train_state, i, input_dir, accelerator.device, stats)
    _load_host_side_state(accelerator, input_dir)
    stats["seconds"] = time.perf_counter() - t_start
    accelerator.checkpoint_stats = {"event": "load", "dir": input_dir, **stats}
    _record_checkpoint_event(accelerator, "checkpoint_load", input_dir, stats)
    return input_dir


def save_custom_state(obj, path: str, index: int = 0) -> None:
    _dump(obj.state_dict(), os.path.join(path, f"custom_checkpoint_{index}.pkl"))


def load_custom_state(obj, path: str, index: int = 0) -> None:
    obj.load_state_dict(restricted_load(os.path.join(path, f"custom_checkpoint_{index}.pkl")))
