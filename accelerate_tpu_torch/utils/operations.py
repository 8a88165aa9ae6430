"""Collectives across processes over ``torch.distributed``.

Counterpart of ``accelerate_tpu/utils/operations.py``: the collectives
``gather``, ``gather_object``, ``broadcast``, ``broadcast_object_list``,
``reduce``, ``pad_across_processes``, ``pad_input_tensors`` and ``save``,
with its semantics, and the helpers over nested structures
(``send_to_device``, ``convert_to_fp32``, ``get_data_structure``,
``listify``, ``verify_operation``, ...). Each takes a tensor, a numpy
array or a nested list, tuple or dict of them, and gives back the same
structure and leaf types. Alone (no process group, or a group of one) each
collective is an identity, as in the JAX package.

The group's backend decides where a collective runs: NCCL on the
process's GPU (host leaves go there and come back), gloo on the CPU.

``collective_counters`` tallies each collective this package makes (the
functions here, and the train step's and ``backward``'s all-reduces of the
loss, its token count and the gradients FSDP2 leaves whole, through
``all_reduce``): a count and the payload bytes by operation, as the JAX
package's counters do for its collectives. The collectives inside FSDP2's
and DDP's own hooks are torch's and not counted. The counters are off (one
bool check a call) unless step telemetry is on (``telemetry.py``).
"""

from __future__ import annotations

import functools
from collections.abc import Mapping
from contextlib import contextmanager
from typing import Any, Callable, Optional

import numpy as np
import torch
import torch.distributed as dist


class _CollectiveCounters:
    """Process-wide count and payload bytes of this package's collectives,
    by operation; read by ``telemetry.TelemetryRecorder``, which turns them
    on."""

    __slots__ = ("enabled", "counts", "bytes")

    def __init__(self):
        self.enabled = False
        self.counts: dict = {}
        self.bytes: dict = {}

    def record(self, op: str, data) -> None:
        if not self.enabled:
            return
        nbytes = 0

        def add(leaf):
            nonlocal nbytes
            nbytes += leaf.nbytes if isinstance(leaf, np.ndarray) else (
                leaf.numel() * leaf.element_size())
            return leaf

        recursively_apply(add, data)
        self.counts[op] = self.counts.get(op, 0) + 1
        self.bytes[op] = self.bytes.get(op, 0) + nbytes

    def snapshot(self) -> dict:
        return {op: {"count": n, "bytes": self.bytes.get(op, 0)}
                for op, n in sorted(self.counts.items())}

    def reset(self) -> None:
        self.counts.clear()
        self.bytes.clear()


collective_counters = _CollectiveCounters()


def _state():
    from ..state import PartialState

    return PartialState()


def _world() -> int:
    return _state().num_processes


# While the train step runs a loss function and its backward, the number of
# processes whose losses it averages (Accelerator.prepare_train_step) and
# their group (None: every process), innermost last; 1 and None elsewhere.
# Process-wide, not a context variable: the autograd engine runs a CUDA
# backward, and the remat recompute inside it, on a thread of its own.
_LOSS_PROCESSES: list = [(1, None)]


@contextmanager
def loss_over_processes(n: int, group=None):
    """Inside the block the step averages the losses of ``n`` processes:
    those of ``group`` (``ParallelismConfig.loss_reduce_axes``; every
    process by default, the ranks of other rows under ``tp``)."""
    _LOSS_PROCESSES.append((n, group))
    try:
        yield
    finally:
        _LOSS_PROCESSES.pop()


def loss_processes() -> int:
    """How many processes' losses the running train step averages (1
    outside a step): those whose tokens make its global batch."""
    return _LOSS_PROCESSES[-1][0]


def loss_group():
    """The process group of those processes (None: every process)."""
    return _LOSS_PROCESSES[-1][1]


def global_token_count(count: torch.Tensor) -> tuple[torch.Tensor, int]:
    """For a loss that divides a sum over this process's tokens by their
    ``count``: the count summed over the processes whose losses the train
    step averages, and how many they are (``count`` and 1 outside the
    step). ``sum · n / total`` averaged over the ``n`` processes is the
    token mean over all of them, as the JAX step's loss on the global
    batch is."""
    n, group = _LOSS_PROCESSES[-1]
    if n == 1:
        return count, 1
    count = count.detach().clone()
    all_reduce(count, group=group)
    return count, n


def all_reduce(tensor: torch.Tensor, op=dist.ReduceOp.SUM, group=None) -> torch.Tensor:
    """``dist.all_reduce(tensor, op, group)`` (a sum over every process by
    default, in place), counted by ``collective_counters``: the step's and
    ``backward``'s reductions of the loss, its token count, the gradients
    FSDP2 leaves whole, the sharded gradients' squared norms and the fp16
    step's finite flag (a MIN)."""
    collective_counters.record("all_reduce", tensor)
    dist.all_reduce(tensor, op=op, group=group)
    return tensor


class DistributedOperationException(Exception):
    """A collective called with shapes that differ across processes
    (``verify_operation``)."""


def _is_array(x) -> bool:
    return torch.is_tensor(x) or isinstance(x, np.ndarray)


def honor_type(obj, generator):
    """A sequence of ``obj``'s exact type (a namedtuple too) from
    ``generator``."""
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*list(generator))
    return type(obj)(generator)


def recursively_apply(func: Callable, data: Any, *args, test_type: Callable = None,
                      error_on_other_type: bool = False, **kwargs) -> Any:
    """``func(leaf, *args, **kwargs)`` on every leaf of a nested list,
    tuple or dict that passes ``test_type`` (default: a tensor or a numpy
    array); other leaves pass as they are, or raise ``TypeError`` with
    ``error_on_other_type``."""
    test_type = test_type or _is_array
    if isinstance(data, (tuple, list)):
        return honor_type(data, (recursively_apply(func, d, *args, test_type=test_type,
                                                   error_on_other_type=error_on_other_type,
                                                   **kwargs) for d in data))
    if isinstance(data, Mapping):
        return type(data)({k: recursively_apply(func, v, *args, test_type=test_type,
                                                error_on_other_type=error_on_other_type, **kwargs)
                           for k, v in data.items()})
    if test_type(data):
        return func(data, *args, **kwargs)
    if error_on_other_type:
        raise TypeError(f"Unsupported type {type(data).__name__}: only nested lists, tuples and "
                        f"dicts of leaves that satisfy {test_type.__name__} are supported.")
    return data


class TensorInformation:
    """A leaf's shape and dtype (``get_data_structure``)."""

    def __init__(self, shape, dtype):
        self.shape = tuple(shape)
        self.dtype = dtype

    def __repr__(self):
        return f"TensorInformation(shape={self.shape}, dtype={self.dtype})"

    def __eq__(self, other):
        return (isinstance(other, TensorInformation) and self.shape == other.shape
                and self.dtype == other.dtype)


def send_to_device(tensor, device=None, non_blocking: bool = True, skip_keys=None):
    """Every tensor or numpy leaf as a tensor on ``device`` (default: this
    process's device); a dict's ``skip_keys`` stay where they are."""
    device = torch.device(device) if device is not None else _state().device

    def send(t):
        t = torch.from_numpy(np.ascontiguousarray(t)) if isinstance(t, np.ndarray) else t
        return t.to(device, non_blocking=non_blocking)

    if isinstance(tensor, Mapping) and skip_keys:
        return type(tensor)({k: v if k in skip_keys else send_to_device(v, device, non_blocking)
                             for k, v in tensor.items()})
    return recursively_apply(send, tensor)


def get_data_structure(data):
    """The structure of ``data`` with a ``TensorInformation`` per leaf."""
    return recursively_apply(lambda t: TensorInformation(t.shape, t.dtype), data)


def get_shape(data):
    """The structure of ``data`` with each leaf's shape as a list."""
    return recursively_apply(lambda t: list(t.shape), data)


def initialize_tensors(data_structure):
    """Zeroed tensors from a ``get_data_structure`` skeleton, on this
    process's device."""
    return recursively_apply(
        lambda info: torch.zeros(info.shape, dtype=info.dtype, device=_state().device),
        data_structure, test_type=lambda x: isinstance(x, TensorInformation))


def copy_tensor_to_devices(tensor):
    """A host tensor on this process's device: each process holds one
    device, so that is every device of the process (the JAX package's
    replication over a host's local devices)."""
    return send_to_device(tensor)


def convert_to_fp32(tensor):
    """Floating leaves upcast (or cast down from float64) to float32."""

    def convert(t):
        if torch.is_tensor(t):
            return t.float() if t.is_floating_point() else t
        return t.astype(np.float32) if np.issubdtype(t.dtype, np.floating) else t

    return recursively_apply(convert, tensor)


def convert_outputs_to_fp32(model_forward):
    """``model_forward`` whose outputs go through ``convert_to_fp32``."""

    @functools.wraps(model_forward)
    def forward(*args, **kwargs):
        return convert_to_fp32(model_forward(*args, **kwargs))

    return forward


def listify(data):
    """Tensors and arrays as plain Python lists (for logging)."""
    return recursively_apply(
        lambda t: t.detach().cpu().tolist() if torch.is_tensor(t) else t.tolist(), data)


def verify_operation(function):
    """A collective that first checks, in debug mode (``PartialState.debug``,
    ``ACCELERATE_DEBUG_MODE``) over more than one process, that every
    process passes leaves of the same shapes, and raises
    ``DistributedOperationException`` naming the processes that differ."""

    @functools.wraps(function)
    def wrapper(*args, **kwargs):
        state = _state()
        if not getattr(state, "debug", False) or state.num_processes <= 1:
            return function(*args, **kwargs)
        tensor = kwargs.get("tensor", args[0] if args else None)
        output = gather_object([get_shape(tensor)])
        if output[0] is not None and not all(o == output[0] for o in output):
            bad = [i for i, o in enumerate(output) if o != output[0]]
            raise DistributedOperationException(
                "Cannot apply the desired operation due to shape mismatches. All shapes "
                f"across devices must be valid.\n\nOperation: `{function.__name__}`\n"
                "Input shapes:\n" + "\n".join(f"  - Process {i}: {o}"
                                               for i, o in enumerate(output))
                + f"\nMismatched processes: {bad}")
        return function(*args, **kwargs)

    return wrapper


def is_array_tree(data: Any) -> bool:
    """Whether every leaf of a nested list, tuple or dict is a tensor or a
    numpy array."""
    if isinstance(data, (tuple, list)):
        return all(map(is_array_tree, data))
    if isinstance(data, Mapping):
        return all(map(is_array_tree, data.values()))
    return torch.is_tensor(data) or isinstance(data, np.ndarray)


def _on_comm_device(fn: Callable) -> Callable:
    """Wrap ``fn(torch_tensor) -> torch_tensor`` so that a leaf moves to the
    device the backend runs on and comes back as the type and device it
    came as (numpy leaves as numpy)."""

    def wrapper(leaf):
        was_numpy = isinstance(leaf, np.ndarray)
        t = torch.from_numpy(np.ascontiguousarray(leaf)) if was_numpy else leaf
        comm = _state().device if _state().backend == "nccl" else torch.device("cpu")
        out = fn(t.to(comm).contiguous())
        return out.cpu().numpy() if was_numpy else out.to(t.device)

    return wrapper


def gather(tensor):
    """The global values of every process's tensors, in rank order (each
    must have the same shape: ``pad_across_processes`` first otherwise).

    Under ``cp`` or ``sp`` the processes of one sequence group hold one
    set of rows, each its slice of the sequence (``parallel/sharding.py``):
    a leaf with more than one dim is joined on dim 1 over the group, in
    the group's order, and the groups' rows are joined on dim 0, so that
    the result is the global batch's rows at full length, as the JAX
    package's gather of a global array gives them. A scalar or 1-dim leaf,
    which every process of a group holds whole, is taken once per group.
    Without ``cp``/``sp`` that is every process's tensor on dim 0. One
    all-gather over every process: the sequence axes are the mesh's
    innermost, so process ``r`` holds slice ``r % n`` of row group
    ``r // n``."""
    collective_counters.record("gather", tensor)
    return _gather(tensor)


def _gather(tensor, seq_size: Optional[int] = None):
    """``gather`` without the counter; ``seq_size`` overrides the set-up
    sequence groups (1: every process's tensor on dim 0)."""
    world = _world()
    if world == 1:
        return tensor
    if seq_size is None:
        from ..state import current_sequence_shard

        seq_size = current_sequence_shard()[0]

    @_on_comm_device
    def one(t):
        whole = t.dim() <= 1
        t = t.reshape(1) if t.dim() == 0 else t
        parts = [torch.empty_like(t) for _ in range(world)]
        dist.all_gather(parts, t)
        if seq_size == 1:
            return torch.cat(parts, dim=0)
        groups = [parts[i:i + seq_size] for i in range(0, world, seq_size)]
        return torch.cat([g[0] if whole else torch.cat(g, dim=1) for g in groups], dim=0)

    return recursively_apply(one, tensor)


def _shard_rows(length: int, placement, rank: int, size: int) -> torch.Tensor:
    """The indices of a dim of ``length`` that ``rank`` of ``size`` holds
    under a placement that splits it: ``Shard``'s ``torch.chunk`` rows (the
    last chunks short or empty where the length does not divide), or
    ``_StridedShard``'s blocks ``j·size + rank`` of ``split_factor·size``
    equal ones."""
    factor = getattr(placement, "split_factor", 1)
    if factor == 1:
        chunks = torch.arange(length).chunk(size)
        return chunks[rank] if rank < len(chunks) else torch.arange(0)
    chunk = length // (factor * size)
    idx = torch.arange(chunk)
    return torch.cat([(j * size + rank) * chunk + idx for j in range(factor)])


def _held_rows(shape, placements, coords, sizes) -> list:
    """For each dim of a tensor of ``shape``, the indices of the whole
    tensor that the process at mesh coordinates ``coords`` holds: each mesh
    dim's split applied, in mesh order, to what the dims before it left
    (``(Shard(0), Shard(0))`` nests the second split in the first's rows;
    FSDP2's ``_StridedShard`` before a ``tp`` split takes its rows from
    within each ``tp`` chunk)."""
    held = [torch.arange(n) for n in shape]
    for placement, rank, size in zip(placements, coords, sizes):
        dim = getattr(placement, "dim", None)
        if dim is None or size == 1:
            continue
        held[dim] = held[dim][_shard_rows(len(held[dim]), placement, rank, size)]
    return held


def gather_shards(t, device: Optional[torch.device] = None) -> torch.Tensor:
    """The whole tensor of a ``DTensor`` parameter or state (any ``Shard``
    or ``_StridedShard`` over any dims of its mesh: FSDP2's, ``tp``'s, the
    2-D ``dp_shard × tp`` ones, an ep stack's), on ``device`` (default: its
    local tensor's); a plain tensor as it is. One ``dist.all_gather`` per
    mesh dim that splits it (every process of those groups joins), each
    rank's part padded to the largest, then every part written into the
    rows it holds. ``DTensor.full_tensor``'s functional collectives fault
    over gloo with tensors on the card (torch 2.11); this path does not.
    The values are the whole tensor's bit for bit."""
    from torch.distributed.tensor import DTensor

    if not isinstance(t, DTensor):
        return t
    local = t.to_local().detach()
    if device is not None:
        local = local.to(device)
    mesh, placements = t.device_mesh, t.placements
    sizes = [mesh.size(m) for m in range(mesh.ndim)]
    mine = [mesh.get_local_rank(m) for m in range(mesh.ndim)]
    split = [m for m, pl in enumerate(placements)
             if getattr(pl, "dim", None) is not None and sizes[m] > 1]
    if not split:
        return local.clone()
    # Every rank's part, padded to the largest on each dim: (parts, *padded).
    every = [list(mine)]
    for m in split:
        every = [[r if k == m else c[k] for k in range(mesh.ndim)]
                 for r in range(sizes[m]) for c in every]
    held = [_held_rows(t.shape, placements, c, sizes) for c in every]
    pad = [max(len(h[d]) for h in held) for d in range(local.dim())]
    parts = local.new_zeros([1] + pad)
    parts[(0,) + tuple(slice(0, n) for n in local.shape)] = local
    for m in split:  # stacked in the order of ``every``
        gathered = [torch.empty_like(parts) for _ in range(sizes[m])]
        dist.all_gather(gathered, parts.contiguous(), group=mesh.get_group(m))
        parts = torch.cat(gathered)
    whole = local.new_empty(t.shape)
    for part, rows in zip(parts, held):
        if any(len(r) == 0 for r in rows):
            continue
        block = part[tuple(slice(0, len(r)) for r in rows)]
        index = tuple(r.to(whole.device).reshape([-1 if d == i else 1 for d in range(len(rows))])
                      for i, r in enumerate(rows))
        whole[index] = block
    return whole


def gather_object(obj: Any) -> list:
    """Every process's picklable object, in rank order; a list's items are
    concatenated instead."""
    collective_counters.record("gather_object", [])
    world = _world()
    if world == 1:
        return obj if isinstance(obj, list) else [obj]
    out = [None] * world
    dist.all_gather_object(out, obj)
    if isinstance(obj, list):
        return [x for part in out for x in part]
    return out


def broadcast(tensor, from_process: int = 0):
    """Process ``from_process``'s values on every process, in place where
    the leaf allows it (tensors on the backend's device), as returned."""
    collective_counters.record("broadcast", tensor)
    if _world() == 1:
        return tensor

    @_on_comm_device
    def one(t):
        dist.broadcast(t, src=from_process)
        return t

    def in_place(leaf):
        out = one(leaf)
        if torch.is_tensor(leaf) and out is not leaf:
            leaf.copy_(out)
            return leaf
        if isinstance(leaf, np.ndarray) and leaf.flags.writeable:
            leaf[...] = out
            return leaf
        return out

    return recursively_apply(in_place, tensor)


def broadcast_object_list(object_list: list, from_process: int = 0) -> list:
    """Process ``from_process``'s picklable objects into ``object_list`` on
    every process, in place; returns it."""
    collective_counters.record("broadcast_object_list", [])
    state = _state()
    if state.num_processes == 1:
        return object_list
    device = state.device if state.backend == "nccl" else None
    dist.broadcast_object_list(object_list, src=from_process, device=device)
    return object_list


def reduce(tensor, reduction: str = "mean", scale: float = 1.0):
    """The sum (``"sum"``) or mean (``"mean"``) over processes of every
    leaf, times ``scale``; ``"none"`` applies only the scale."""
    if reduction not in ("sum", "mean", "none"):
        raise ValueError(f"reduction must be sum|mean|none, got {reduction!r}")
    collective_counters.record("reduce", tensor)
    world = _world()

    @_on_comm_device
    def one(t):
        t = t.clone()
        if world > 1 and reduction != "none":
            dist.all_reduce(t, op=dist.ReduceOp.SUM)  # gloo has no AVG
            if reduction == "mean":
                t = t / world
        return t * scale if scale != 1.0 else t

    return recursively_apply(one, tensor)


def pad_across_processes(tensor, dim: int = 0, pad_index: int = 0, pad_first: bool = False):
    """Every leaf padded with ``pad_index`` along ``dim`` to the largest
    size any process has there, so that ``gather`` can take it."""
    collective_counters.record("pad_across_processes", tensor)
    world = _world()

    def one(leaf):
        if dim >= leaf.ndim:
            return leaf
        size = torch.tensor([leaf.shape[dim]], dtype=torch.int64)
        sizes = _gather(size, seq_size=1) if world > 1 else size
        pad = int(sizes.max()) - leaf.shape[dim]
        if pad == 0:
            return leaf
        shape = list(leaf.shape)
        shape[dim] = pad
        if isinstance(leaf, np.ndarray):
            filler = np.full(shape, pad_index, dtype=leaf.dtype)
            return np.concatenate([filler, leaf] if pad_first else [leaf, filler], axis=dim)
        filler = leaf.new_full(shape, pad_index)
        return torch.cat([filler, leaf] if pad_first else [leaf, filler], dim=dim)

    return recursively_apply(one, tensor)


def pad_input_tensors(tensor, batch_size: int, num_processes: int, dim: int = 0):
    """A batch of ``batch_size`` along ``dim`` padded, by repeating its first
    samples, to the next multiple of ``num_processes``."""

    def one(leaf):
        if batch_size % num_processes == 0:
            return leaf
        extra = -(-batch_size // num_processes) * num_processes - leaf.shape[dim]
        if isinstance(leaf, np.ndarray):
            idx = np.arange(extra) % leaf.shape[dim]
            return np.concatenate([leaf, np.take(leaf, idx, axis=dim)], axis=dim)
        idx = torch.arange(extra, device=leaf.device) % leaf.shape[dim]
        return torch.cat([leaf, leaf.index_select(dim, idx)], dim=dim)

    return recursively_apply(one, tensor)


def find_batch_size(data) -> int:
    """Dim 0 of the first tensor or array in ``data``."""
    if isinstance(data, (tuple, list)):
        return find_batch_size(data[0])
    if isinstance(data, Mapping):
        return find_batch_size(next(iter(data.values())))
    if torch.is_tensor(data) or isinstance(data, np.ndarray):
        return data.shape[0]
    raise TypeError(f"Cannot find the batch size of {type(data).__name__}")


def iterate_over_batch(data, start: int, stop: int):
    """Rows ``start:stop`` of every leaf."""
    return recursively_apply(lambda t: t[start:stop], data)


slice_tensors = iterate_over_batch


def concatenate(data: list, dim: int = 0):
    """Leaf-wise concatenation of a list of like structures."""
    first = data[0]
    if isinstance(first, (tuple, list)):
        return type(first)(concatenate([d[i] for d in data], dim) for i in range(len(first)))
    if isinstance(first, Mapping):
        return type(first)({k: concatenate([d[k] for d in data], dim) for k in first})
    if isinstance(first, np.ndarray):
        return np.concatenate(data, axis=dim)
    return torch.cat(data, dim=dim)


def save(obj, f, save_on_each_node: bool = False, safe_serialization: bool = True) -> None:
    """Write ``obj`` to ``f`` on the main process (each node's local main
    process with ``save_on_each_node``): a flat dict of tensors as
    safetensors when ``safe_serialization``, anything else with
    ``torch.save``."""
    state = _state()
    if not (state.is_main_process or save_on_each_node and state.is_local_main_process):
        return
    if safe_serialization and isinstance(obj, Mapping) and all(
            torch.is_tensor(v) or isinstance(v, np.ndarray) for v in obj.values()):
        from .other import save_safetensors

        save_safetensors(obj, f)
    else:
        torch.save(obj, f)
