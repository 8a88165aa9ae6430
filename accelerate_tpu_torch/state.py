"""Process and device state singletons over ``torch.distributed``.

Counterpart of ``accelerate_tpu/state.py``. Each class shares one state
dict between its instances (the borg pattern), so every ``PartialState()``
in a process sees the same rank and device. ``_reset_state()`` clears it.

Processes: ``PartialState`` joins a process group when torchrun's
environment is set (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR``, ``MASTER_PORT``), at any world size including 1: NCCL on
``cuda:LOCAL_RANK``, gloo when the caller asks for the CPU. A group the
caller initialised before (``torch.distributed.init_process_group``) is
adopted as it is. Without either, the process runs alone and no group
exists. ``_reset_state()`` destroys a group that ``PartialState`` created,
and leaves an adopted one to its owner.

Device resolution: ``cuda:LOCAL_RANK`` (``cuda:0`` alone) unless the caller
asks for the CPU. Without a CUDA device and without ``cpu=True`` the
constructor raises: nothing runs on the CPU unless it was asked for.
"""

from __future__ import annotations

import enum
import os
from contextlib import contextmanager
from datetime import timedelta
from functools import wraps
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from .parallelism_config import ParallelismConfig
from .utils.dataclasses import GradientAccumulationPlugin

_TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


class DistributedType(str, enum.Enum):
    """How the processes are joined. The parallelism strategy (FSDP2, DDP,
    HSDP) is the ``Accelerator``'s choice over the group."""

    NO = "NO"                # one process, no process group
    MULTI_CPU = "MULTI_CPU"  # a gloo group over CPU processes
    MULTI_GPU = "MULTI_GPU"  # an NCCL group, one GPU per process


def _torchrun_env() -> Optional[dict]:
    """torchrun's variables when all are set, else None; raises when some
    are missing and ``WORLD_SIZE`` asks for more than one process."""
    found = {k: os.environ[k] for k in _TORCHRUN_ENV if k in os.environ}
    if len(found) == len(_TORCHRUN_ENV):
        return found
    if int(found.get("WORLD_SIZE", "1")) > 1:
        missing = [k for k in _TORCHRUN_ENV if k not in found]
        raise ValueError(f"torchrun's environment is incomplete: {missing} unset "
                         f"(have {sorted(found)}); launch with torchrun or set all of "
                         f"{list(_TORCHRUN_ENV)}")
    return None


class PartialState:
    """Rank, device and process group of this process. ``PartialState()``
    reads the state that is set up, or sets it up; an explicit ``cpu`` must
    agree with the state already set up."""

    _shared_state: dict = {}

    def __init__(self, cpu: Optional[bool] = None):
        self.__dict__ = self._shared_state
        if self.initialized:
            if cpu is not None and cpu != self._cpu:
                raise ValueError(
                    f"PartialState was already set up with cpu={self._cpu}; "
                    "call PartialState._reset_state() first")
            return
        adopted = dist.is_available() and dist.is_initialized()
        env = None if adopted else _torchrun_env()
        if adopted:
            local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        else:
            local = int(env["LOCAL_RANK"]) if env else 0
        if cpu:
            device = torch.device("cpu")
        elif torch.cuda.is_available():
            device = torch.device("cuda", local)
            if env is not None or adopted:
                torch.cuda.set_device(device)  # before NCCL's first use
        else:
            raise RuntimeError(
                "No CUDA device is available. Pass cpu=True to run on the CPU.")
        owns_group = False
        if env is not None and not adopted:
            dist.init_process_group(
                backend="gloo" if cpu else "nccl", init_method="env://",
                rank=int(env["RANK"]), world_size=int(env["WORLD_SIZE"]),
                timeout=timedelta(minutes=10))
            owns_group = True
        grouped = adopted or owns_group
        if grouped and cpu and dist.get_backend() != "gloo":
            raise ValueError(f"cpu=True needs a gloo process group, got {dist.get_backend()}")
        self._cpu = bool(cpu)
        self._owns_group = owns_group
        # ACCELERATE_DEBUG_MODE: collectives check their shapes across
        # processes first (operations.verify_operation).
        self.debug = os.environ.get("ACCELERATE_DEBUG_MODE", "").lower() in (
            "1", "y", "yes", "t", "true", "on")
        self.device = device
        self.backend = dist.get_backend() if grouped else None
        self.num_processes = dist.get_world_size() if grouped else 1
        self.process_index = dist.get_rank() if grouped else 0
        self.local_process_index = local
        self.distributed_type = (DistributedType.NO if not grouped else DistributedType.MULTI_CPU
                                 if cpu else DistributedType.MULTI_GPU)

    @property
    def initialized(self) -> bool:
        return "device" in self._shared_state

    @property
    def use_distributed(self) -> bool:
        """Whether a process group joins this process to others (or to
        itself, at world size 1)."""
        return self.distributed_type != DistributedType.NO

    @property
    def is_main_process(self) -> bool:
        return self.process_index == 0

    @property
    def is_local_main_process(self) -> bool:
        return self.local_process_index == 0

    @property
    def is_last_process(self) -> bool:
        return self.process_index == self.num_processes - 1

    def wait_for_everyone(self) -> None:
        """A barrier across the group; alone, nothing to wait for."""
        if self.use_distributed:
            if self.backend == "nccl":
                dist.barrier(device_ids=[self.device.index])
            else:
                dist.barrier()

    def _host_group(self):
        """A gloo group over every process, made once on first use (by
        every process, at the same call): the host-side collectives below
        run on CPU tensors and never enqueue work on the card. The default
        group when it is gloo already."""
        if self.backend == "gloo":
            return None
        if self._shared_state.get("_gloo_group") is None:
            self._shared_state["_gloo_group"] = dist.new_group(backend="gloo")
        return self._shared_state["_gloo_group"]

    def agree_any(self, flag: bool) -> bool:
        """OR of a host-side flag over the processes: True everywhere once
        any process passes True (``Accelerator.check_preemption``)."""
        if self.num_processes <= 1:
            return bool(flag)
        t = torch.tensor([1 if flag else 0], dtype=torch.int32)
        dist.all_reduce(t, group=self._host_group())
        return int(t) > 0

    def allgather_host_floats(self, values) -> np.ndarray:
        """A small float vector from every process: a ``(num_processes,
        len(values))`` float64 array, row r rank r's (``(1, n)`` alone).
        The step watchdog's heartbeat and the SDC vote; float64 on the wire,
        so a float32 digest arrives bit for bit."""
        vec = torch.tensor(np.asarray(values, np.float64).reshape(1, -1))
        if self.num_processes <= 1:
            return vec.numpy()
        out = [torch.empty_like(vec) for _ in range(self.num_processes)]
        dist.all_gather(out, vec, group=self._host_group())
        return torch.cat(out).numpy()

    @contextmanager
    def main_process_first(self):
        """The main process runs the body first; the others wait for it,
        then run it."""
        with self._first(self.is_main_process):
            yield

    @contextmanager
    def local_main_process_first(self):
        """As ``main_process_first``, with each node's local main process."""
        with self._first(self.is_local_main_process):
            yield

    @contextmanager
    def _first(self, leader: bool):
        if not leader:
            self.wait_for_everyone()
        yield
        if leader:
            self.wait_for_everyone()

    def on_process(self, function: Callable = None, process_index: int = None):
        """Decorator: ``function`` runs on process ``process_index`` only and
        returns None elsewhere."""
        return self._only_if(function, lambda: self.process_index == process_index)

    def on_main_process(self, function: Callable = None):
        return self._only_if(function, lambda: self.is_main_process)

    def on_local_main_process(self, function: Callable = None):
        return self._only_if(function, lambda: self.is_local_main_process)

    def on_last_process(self, function: Callable):
        return self._only_if(function, lambda: self.is_last_process)

    def on_local_process(self, function: Callable = None, local_process_index: int = None):
        return self._only_if(function, lambda: self.local_process_index == local_process_index)

    @staticmethod
    def _only_if(function: Callable, here: Callable[[], bool]) -> Callable:
        @wraps(function)
        def wrapper(*args, **kwargs):
            if here():
                return function(*args, **kwargs)

        return wrapper

    @contextmanager
    def split_between_processes(self, inputs, apply_padding: bool = False):
        """This process's contiguous share of a list, tuple, tensor, array or
        dict of them (each value split alike). Shares differ by at most one
        element, the longer ones first; ``apply_padding`` repeats the last
        element so that every share has the longest length."""
        if self.num_processes == 1:
            yield inputs
            return
        per, extra = divmod(len(next(iter(inputs.values())) if isinstance(inputs, dict)
                                 else inputs), self.num_processes)
        start = self.process_index * per + min(self.process_index, extra)
        end = start + per + (1 if self.process_index < extra else 0)
        target = per + (1 if extra else 0)

        def share(x):
            part = x[start:end]
            if not apply_padding or len(part) >= target:
                return part
            fill = target - len(part)
            if torch.is_tensor(x):
                return torch.cat([part, x[-1:].expand(fill, *x.shape[1:])])
            if isinstance(x, np.ndarray):
                return np.concatenate([part, np.repeat(x[-1:], fill, axis=0)])
            return list(part) + [x[-1]] * fill

        yield ({k: share(v) for k, v in inputs.items()} if isinstance(inputs, dict)
               else share(inputs))

    def print(self, *args, **kwargs):
        """``print`` on each node's local main process only."""
        if self.is_local_main_process:
            print(*args, **kwargs)

    @classmethod
    def _reset_state(cls):
        if cls._shared_state.get("_owns_group") and dist.is_initialized():
            dist.destroy_process_group()
        cls._shared_state.clear()


class ExpertGroups(NamedTuple):
    """Where a Mixtral's experts lie under ``ep_size > 1``. ``mesh``: the
    1-D slice of the mesh over ``ep_axes`` (flattened when they are
    several), on which each expert stack is a ``DTensor`` split on its
    expert dim: ep rank ``rank`` of ``size`` holds experts ``[rank·E/size,
    (rank+1)·E/size)``. ``exchange``: the ranks of that slice that hold
    distinct tokens, those of its ``dp_shard`` and ``sp`` axes
    (``exchange_size`` of them; None when ``ep_axes`` is ``tp`` alone);
    the token rows travel over it. ``tp``: the ``tp`` ranks inside the ep
    slice (1 when ``tp`` is not an ep axis); they hold the same tokens, so
    each fills only its own experts' slots and ``tp_group`` sums the
    results. ``replicas``: the ranks that hold the same experts and other
    tokens (the loss axes outside ``ep_axes``), over which the experts'
    gradients are summed; None when there are none."""

    mesh: Any
    size: int
    rank: int
    exchange: Any
    exchange_size: int
    tp: int
    tp_group: Any
    replicas: Any


class AcceleratorState:
    """PartialState plus the precision and parallelism choices."""

    _shared_state: dict = {}

    def __init__(self, mixed_precision: Optional[str] = None, cpu: Optional[bool] = None,
                 parallelism_config: Optional[ParallelismConfig] = None):
        self.__dict__ = self._shared_state
        # PartialState raises if it was set up with the other device; None
        # takes the device already set up.
        partial = PartialState(cpu=cpu)
        if self.initialized:
            return
        self._partial = partial
        self.mixed_precision = "no" if mixed_precision is None else mixed_precision
        pc = parallelism_config or ParallelismConfig()
        # The data-parallel axes fill the world, as the JAX package fills its
        # devices (ParallelismConfig.infer_missing_axis).
        self.parallelism_config = pc.infer_missing_axis(partial.num_processes)
        self._mesh = None
        self._dp_mesh = None
        self._loss_group = None
        self._edge_group = None
        self._expert_groups = None
        self._flattened: dict = {}

    @property
    def device_mesh(self):
        """The 6-D ``DeviceMesh`` (``parallelism_config.MESH_AXES``) over the
        process group, or None without a group. Built on first use, with one
        process group per axis (``get_group(axis)``)."""
        if self._mesh is None and self._partial.use_distributed:
            self._mesh = self.parallelism_config.build_mesh(self._partial.device.type)
        return self._mesh

    def _flat(self, axes: tuple):
        """The 1-D slice of ``device_mesh`` over ``axes`` (in mesh order),
        flattened into one dim when there are several, or None when
        ``axes`` is empty. Every process builds it (its groups) together."""
        mesh = self.device_mesh
        if not axes:
            return None
        if len(axes) == 1:
            return mesh[axes[0]]
        name = "_".join(axes)
        if name not in self._flattened:
            self._flattened[name] = mesh[axes]._flatten(name)
        return self._flattened[name]

    @property
    def data_parallel_mesh(self):
        """The 2-D ``(replicate, shard)`` mesh FSDP2 runs over
        (``ParallelismConfig.build_data_parallel_mesh``), built on first
        use; None without a group. Under ``tp`` or ``pp`` it is a slice of
        ``device_mesh`` (this stage's under ``pp``), so that FSDP2 composes
        with the ``tp`` slice's DTensors and every group comes from one
        root mesh: ``(dp_replicate, dp_shard)``, or with a sequence axis
        ``dp_replicate × sp`` by ``dp_shard × cp``, each flattened."""
        if self._dp_mesh is None and self._partial.use_distributed:
            cfg = self.parallelism_config
            if (cfg.tp_size > 1 or cfg.pp_size > 1) and cfg.seq_size > 1:
                replicate = self._flat(("dp_replicate", "sp"))
                shard = self._flat(("dp_shard", "cp"))
                self._dp_mesh = self.device_mesh[replicate.mesh_dim_names[0],
                                                 shard.mesh_dim_names[0]]
            elif cfg.tp_size > 1 or cfg.pp_size > 1:
                self._dp_mesh = self.device_mesh["dp_replicate", "dp_shard"]
            else:
                self._dp_mesh = self.parallelism_config.build_data_parallel_mesh(
                    self._partial.device.type)
        return self._dp_mesh

    @property
    def tensor_parallel_mesh(self):
        """The 1-D ``tp`` slice of ``device_mesh`` (the DTensors of a
        tensor-parallel model live on it), or None without a group."""
        mesh = self.device_mesh
        return None if mesh is None else mesh["tp"]

    @property
    def pipeline_mesh(self):
        """The 1-D ``pp`` slice of ``device_mesh``: this process's stages, in
        order (``parallel/pp.py`` sends activations along it), or None
        without a group."""
        mesh = self.device_mesh
        return None if mesh is None else mesh["pp"]

    @property
    def loss_group(self):
        """The process group of this process's loss: every axis but ``tp``
        and ``pp`` (``loss_reduce_axes``): ``tp`` ranks compute one loss on
        the same rows, and a pipeline's last stage alone computes it. Under
        ``tp`` or ``pp`` that is the ``loss_reduce_axes`` slice of
        ``device_mesh`` of this process's ``tp`` rank and stage, flattened,
        built on first use by every process; None (the default group, every
        process) otherwise."""
        cfg = self.parallelism_config
        if (self._loss_group is None and (cfg.tp_size > 1 or cfg.pp_size > 1)
                and self._partial.use_distributed):
            axes = tuple(a for a in cfg.loss_reduce_axes if cfg.axis_size(a) > 1)
            if not axes:  # a group of one
                self._loss_group = self._flat(("dp_replicate", "dp_shard")).get_group()
            else:
                self._loss_group = self._flat(axes).get_group()
        return self._loss_group

    @property
    def expert_groups(self) -> Optional["ExpertGroups"]:
        """Under ``ep_size > 1`` the groups expert parallelism runs over
        (``ExpertGroups``), built on first use by every process; None
        otherwise or without a process group."""
        cfg = self.parallelism_config
        if cfg.ep_size == 1 or not self._partial.use_distributed:
            return None
        if self._expert_groups is None:
            ep = cfg.ep_axes
            rows = tuple(a for a in ep if a != "tp")
            tp_in_ep = cfg.tp_size if "tp" in ep else 1
            replicas = tuple(a for a in cfg.loss_reduce_axes
                             if a not in ep and cfg.axis_size(a) > 1)
            mesh = self._flat(ep)
            exchange = self._flat(rows)
            replica = self._flat(replicas)
            self._expert_groups = ExpertGroups(
                mesh=mesh, size=cfg.ep_size, rank=mesh.get_local_rank(),
                exchange=None if exchange is None else exchange.get_group(),
                exchange_size=1 if exchange is None else exchange.size(),
                tp=tp_in_ep,
                tp_group=self.device_mesh["tp"].get_group() if tp_in_ep > 1 else None,
                replicas=None if replica is None else replica.get_group())
        return self._expert_groups

    @property
    def loss_size(self) -> int:
        """How many processes' losses a step averages: the world over
        ``tp`` and ``pp``."""
        cfg = self.parallelism_config
        return self._partial.num_processes // (cfg.tp_size * cfg.pp_size)

    @property
    def pipeline_edge_group(self):
        """The group of this process's first and last pipeline stages (the
        ranks of its ``pp`` slice at stage 0 and ``pp - 1``), over which a
        weight both hold (a tied embedding and head) sums its gradient;
        None on a middle stage or without ``pp``. Every process takes part
        in building the groups of every slice on first use."""
        cfg = self.parallelism_config
        if cfg.pp_size == 1 or not self._partial.use_distributed:
            return None
        if self._edge_group is None:
            if cfg.pp_size == 2:
                self._edge_group = self.pipeline_mesh.get_group()
            else:
                ranks = torch.arange(cfg.total_size).reshape(cfg.pp_size, -1)
                me = self._partial.process_index
                for col in range(ranks.shape[1]):
                    pair = [int(ranks[0, col]), int(ranks[-1, col])]
                    group = dist.new_group(pair)
                    if me in pair:
                        self._edge_group = group
        return self._edge_group

    def axis_rank(self, axis: str) -> int:
        """This process's coordinate on a mesh axis (0 without a group)."""
        return self.parallelism_config.coordinates(self._partial.process_index)[axis]

    @property
    def pipeline_stage(self) -> tuple[int, int]:
        """(number of stages, this process's stage) over ``pp``."""
        cfg = self.parallelism_config
        return cfg.pp_size, self.axis_rank("pp")

    @property
    def data_parallel_size(self) -> int:
        """Processes that read distinct batch rows (``dp_replicate × dp_shard``)."""
        return self.parallelism_config.dp_size

    @property
    def data_parallel_index(self) -> int:
        """This process's position among them; ``cp``, ``sp``, ``tp`` and
        ``pp`` ranks of one position read the same rows."""
        return self.parallelism_config.data_parallel_index(self._partial.process_index)

    @property
    def sequence_shard(self) -> tuple[int, int]:
        """(number of slices, this process's slice) of the sequence dim over
        the active sequence axis (``cp`` or ``sp``)."""
        cfg = self.parallelism_config
        return cfg.seq_size, cfg.sequence_index(self._partial.process_index)

    @property
    def initialized(self) -> bool:
        return "_partial" in self._shared_state

    @property
    def device(self) -> torch.device:
        return self._partial.device

    @classmethod
    def _reset_state(cls):
        cls._shared_state.clear()


def current_mesh():
    """The set-up ``AcceleratorState``'s 6-D mesh, or None when no state is
    set up or it has no process group. Sets nothing up."""
    if not AcceleratorState._shared_state.get("_partial"):
        return None
    return AcceleratorState().device_mesh


def current_expert_groups() -> Optional[ExpertGroups]:
    """The set-up ``AcceleratorState``'s ``expert_groups``, or None when no
    state is set up, ``ep_size`` is 1 or there is no process group."""
    if not AcceleratorState._shared_state.get("_partial"):
        return None
    return AcceleratorState().expert_groups


def current_parallelism_config() -> Optional[ParallelismConfig]:
    """The set-up ``AcceleratorState``'s ``parallelism_config``, or None."""
    if not AcceleratorState._shared_state.get("_partial"):
        return None
    return AcceleratorState().parallelism_config


def current_sequence_shard() -> tuple[int, int]:
    """(number of slices, this process's slice) of the sequence over the
    set-up ``AcceleratorState``'s ``cp``/``sp`` axis; (1, 0) without one."""
    if not AcceleratorState._shared_state.get("_partial"):
        return 1, 0
    return AcceleratorState().sequence_shard


class GradientState:
    """Gradient-accumulation bookkeeping and the data loaders being iterated.

    A loader registers itself while it is iterated (the active-loader
    stack, innermost last) and flags ``end_of_dataloader`` when the batch it
    just yielded is its last (a one-batch lookahead); ``remainder`` is the
    number of real samples in the last global batch when the loader pads
    it, else -1. ``sync_gradients`` says whether the current microbatch
    ends an accumulation window: ``Accelerator.accumulate`` sets it, the
    optimizer steps and the gradients are reduced over the processes only
    when it is set (or on every microbatch with ``sync_each_batch``). The
    fused train step leaves it at True. The plugin's fields live in
    ``plugin_kwargs`` (``GradientAccumulationPlugin.to_kwargs()``)."""

    _shared_state: dict = {}

    def __init__(self, gradient_accumulation_plugin: Optional[GradientAccumulationPlugin] = None):
        self.__dict__ = self._shared_state
        if "sync_gradients" not in self._shared_state:
            self.sync_gradients = True
            self.dataloader_references = [None]
            self.plugin_kwargs = {}
        if gradient_accumulation_plugin is not None:
            self.plugin_kwargs = gradient_accumulation_plugin.to_kwargs()

    @property
    def num_steps(self) -> int:
        return self.plugin_kwargs.get("num_steps") or 1

    @property
    def adjust_scheduler(self) -> bool:
        return self.plugin_kwargs.get("adjust_scheduler", True)

    @property
    def sync_with_dataloader(self) -> bool:
        return self.plugin_kwargs.get("sync_with_dataloader", True)

    @property
    def sync_each_batch(self) -> bool:
        return self.plugin_kwargs.get("sync_each_batch", False)

    def _set_sync_gradients(self, sync_gradients: bool) -> None:
        self.sync_gradients = sync_gradients

    @property
    def active_dataloader(self):
        return self.dataloader_references[-1]

    @property
    def in_dataloader(self) -> bool:
        return self.active_dataloader is not None

    @property
    def end_of_dataloader(self) -> bool:
        return self.in_dataloader and self.active_dataloader.end_of_dataloader

    @property
    def remainder(self) -> int:
        return self.active_dataloader.remainder if self.in_dataloader else -1

    def _add_dataloader(self, dataloader) -> None:
        self.dataloader_references.append(dataloader)

    def _remove_dataloader(self, dataloader) -> None:
        # A loader's iteration may end after _reset_state() cleared the stack.
        if dataloader in getattr(self, "dataloader_references", ()):
            self.dataloader_references.remove(dataloader)

    @classmethod
    def _reset_state(cls):
        cls._shared_state.clear()
