"""Where each parameter and each batch lies over the processes.

Counterpart of ``accelerate_tpu/parallel/sharding.py``.

The batch (``batch_partition_spec``). There a batch is one global array
laid out by a PartitionSpec: dim 0 over the data-parallel axes and, when
``cp`` or ``sp`` is wider than 1, dim 1 over that axis. Here each process
holds its own slice of it, by the same rule:

- rows are split over ``dp_replicate × dp_shard`` (``batch_axes``);
- dim 1 of every leaf with more than one dim is split over ``cp × sp``
  (``seq_axes``): rank ``i`` holds positions ``[i·S/n, (i+1)·S/n)``.

Processes that differ only in ``cp``, ``sp``, ``tp`` or ``pp`` hold the same
rows.

The parameters (``plan_parameter_sharding``). The JAX planner gives every
leaf of the flax tree a PartitionSpec: a TP rule (a regular expression on
the ``/``-joined name, with a spec in the flax layout) first, then the
``pp`` rule (a scanned stack's free layer dim on ``pp``), then the FSDP
policy (the largest free dim that divides over ``dp_shard × cp``, rank-1
and small leaves and ``ignored_params`` excepted), else replicated. Here
the same function runs on the flax names and shapes of the port's
parameters (``models/convert.flax_leaf``: a scanned stack's leaf is every
layer's parameter at once), so each parameter's ``spec`` equals the JAX
plan's for the same config. A dim a rule splits that does not divide by
its axes stays whole, with the JAX plan's warning (GQA kv heads below
``tp``). The ``tp`` part is then mapped into the port's layout: the flax
dim a rule splits is the outer part of one port dim (``Shard(dim)``), or,
inside a fused dim, a strided part (``_StridedShard(dim, split_factor)``:
GPT-2's ``c_attn`` ``(3, heads, D)`` rows split on the heads).

``apply_tensor_parallel`` puts a module on its plan: each split parameter
becomes a ``DTensor`` over the mesh's 1-D ``tp`` slice, each other stays
whole on every ``tp`` rank. The forward runs on local shards with local
head counts (``parallel/tp.py``; ``models/llama.py`` says why this design
and not a DTensor program with ``local_map`` around the kernels). Under ``dp_shard × tp``
FSDP2's ``fully_shard`` over the ``(dp_replicate, dp_shard)`` slice of the
same root mesh composes on top (``parallel/fsdp.py``): its 2-D DTensors
hold each ``tp`` shard sharded on dim 0, where the JAX plan puts the FSDP
axes on the largest free dim (``spec`` says which). The layout differs;
the numbers do not.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import re
from typing import Any

import torch

from ..utils.operations import find_batch_size, recursively_apply, slice_tensors

logger = logging.getLogger(__name__)


def sequence_slice(batch, num_slices: int, index: int, seq_dim: int = 1):
    """Slice ``index`` of ``num_slices`` equal ones along ``seq_dim`` of every
    tensor or array leaf with more than ``seq_dim`` dims; others pass as
    they are. A length that does not divide raises ``ValueError``."""
    if num_slices == 1:
        return batch

    def cut(t):
        if t.ndim <= seq_dim:
            return t
        s = t.shape[seq_dim]
        if s % num_slices:
            raise ValueError(f"sequence length {s} does not divide by the {num_slices} "
                             "processes of the cp/sp axis")
        n = s // num_slices
        return t[(slice(None),) * seq_dim + (slice(index * n, (index + 1) * n),)]

    return recursively_apply(cut, batch)


def local_batch(batch, parallelism_config, rank: int):
    """Process ``rank``'s slice of a global batch: its rows, then its slice
    of the sequence."""
    cfg = parallelism_config
    rows, dp = find_batch_size(batch), cfg.dp_size
    if rows % dp:
        raise ValueError(f"batch of {rows} rows does not divide by the {dp} data-parallel "
                         "processes")
    n, i = rows // dp, cfg.data_parallel_index(rank)
    return sequence_slice(slice_tensors(batch, i * n, (i + 1) * n), cfg.seq_size,
                          cfg.sequence_index(rank))


# ---------------------------------------------------------------------------
# The parameter plan
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ParamPlacement:
    """One parameter's place over the mesh. ``flax_name``: its leaf in the
    JAX package's tree of the same config (``models/convert.flax_leaf``);
    ``spec``: the JAX plan's PartitionSpec of that leaf as a tuple (trailing
    ``None``s dropped; a scanned leaf's leading layer dim included);
    ``tp``: how the port's tensor is split over ``tp`` (``Shard`` or
    ``_StridedShard``), or None where it is whole on every ``tp`` rank;
    ``ep``: how an expert stack is split over the ep slice of the mesh
    (``Shard(0)``, its expert dim over ``ep_axes``), else None."""

    flax_name: str
    spec: tuple
    tp: Any = None
    ep: Any = None


def mesh_sizes(mesh) -> dict:
    """``{axis: size}`` of a ``DeviceMesh``, a ``ParallelismConfig`` or a
    mapping of sizes (a mesh without processes); absent axes are 1."""
    from ..parallelism_config import MESH_AXES, ParallelismConfig

    if isinstance(mesh, ParallelismConfig):
        sizes = {ax: mesh.axis_size(ax) for ax in MESH_AXES}
    elif hasattr(mesh, "mesh_dim_names"):
        sizes = dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))
    else:
        sizes = dict(mesh)
    return {ax: sizes.get(ax, 1) for ax in MESH_AXES} | sizes


def _capacity(sizes: dict, axes) -> int:
    return math.prod(sizes[a] for a in (axes if isinstance(axes, tuple) else (axes,)))


_SCAN_LAYER_RE = re.compile(r"(^|/)(layers|h)/")
# The expert stacks an ep rule splits on their expert dim.
_EXPERT_STACK_RE = re.compile(r"moe/(w_gate|w_up|w_down)$")


def _leaf_spec(name: str, shape: tuple, sizes: dict, tp_rules, ignored, fsdp_axes,
               min_size: int) -> tuple:
    """The JAX planner's ``_spec_for`` on one flax leaf: a TP rule, then the
    ``pp`` rule (a scanned stack's free layer dim that divides by ``pp``
    goes on ``pp``: each stage holds its layers), then the FSDP policy."""
    if any(r.search(name) for r in ignored):
        return ()
    entries: list = [None] * len(shape)
    for pattern, spec in tp_rules:
        if re.search(pattern, name):
            entries = list(spec) + [None] * (len(shape) - len(spec))
            for d, entry in enumerate(entries):
                if entry is not None and shape[d] % _capacity(sizes, entry):
                    logger.warning(
                        "TP rule %s: dim %d of %s (size %d) not divisible by axis %s — "
                        "replicating that dim.", pattern, d, name, shape[d], entry)
                    entries[d] = None
            break
    pp = sizes.get("pp", 1)
    if (pp > 1 and entries and entries[0] is None and _SCAN_LAYER_RE.search(name)
            and shape[0] % pp == 0):
        entries[0] = "pp"
    if fsdp_axes:
        used = {a for e in entries if e for a in (e if isinstance(e, tuple) else (e,))}
        free = tuple(a for a in fsdp_axes if a not in used)
        rank1_like = len(shape) < 2 or (_SCAN_LAYER_RE.search(name) and len(shape) == 2)
        if free and not rank1_like and math.prod(shape) >= min_size:
            n = _capacity(sizes, free)
            best, best_size = None, 0
            for d, s in enumerate(shape):
                if entries[d] is None and s % n == 0 and s >= best_size:
                    best, best_size = d, s
            if best is not None:
                entries[best] = free if len(free) > 1 else free[0]
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(entries)


def _shards_params(fsdp_plugin, cfg) -> bool:
    """The JAX plan's ``shards_params``: FULL_SHARD and HYBRID_SHARD, or a
    ``dp_shard`` axis without a plugin."""
    if fsdp_plugin is None:
        return cfg.dp_shard_size > 1
    return fsdp_plugin.sharding_strategy in ("FULL_SHARD", "HYBRID_SHARD")


def _flax_leaves(module) -> list:
    """(port name, parameter, FlaxLeaf, the leaf's whole flax shape) of
    every parameter: one layer's flax shape from the leaf's ``to_flax`` on
    a meta tensor, with a scanned stack's layer count in front."""
    from ..models.convert import flax_leaf

    rows, stacks = [], {}
    for fqn, p in module.named_parameters():
        leaf = flax_leaf(module, fqn)
        layer = tuple(leaf.to_flax(torch.empty(tuple(p.shape), device="meta")).shape)
        rows.append((fqn, p, leaf, layer))
        if leaf.index is not None:
            stacks[leaf.name] = stacks.get(leaf.name, 0) + 1
    return [(fqn, p, leaf, ((stacks[leaf.name],) + layer) if leaf.index is not None else layer)
            for fqn, p, leaf, layer in rows]


def plan_parameter_sharding(module, mesh, *, fsdp_plugin=None, parallelism_config=None,
                            tp_rules=None) -> dict:
    """``{parameter name: ParamPlacement}`` of ``module`` over ``mesh`` (a
    ``DeviceMesh``, or sizes without processes: ``mesh_sizes``), with the
    JAX planner's precedence: a TP rule, then the FSDP policy, then
    replicated; ``ignored_params`` always whole. ``spec`` equals the JAX
    plan's for the leaf ``flax_name`` of the same config and rules."""
    from ..parallelism_config import ParallelismConfig

    sizes = mesh_sizes(mesh)
    cfg = parallelism_config or ParallelismConfig(
        **{f"{ax}_size": sizes[ax] for ax in ("dp_replicate", "dp_shard", "cp", "sp")})
    tp_rules = list(tp_rules or [])
    ignored = [re.compile(p) for p in (getattr(fsdp_plugin, "ignored_params", None) or [])]
    shards = _shards_params(fsdp_plugin, cfg)
    fsdp_axes = tuple(ax for ax in cfg.fsdp_axes if sizes[ax] > 1) if shards else ()
    min_size_to_shard = (fsdp_plugin.min_weight_size_to_shard if fsdp_plugin is not None
                         else 2**11)
    tp = sizes["tp"]
    ep_axes = cfg.ep_axes
    plan, found = {}, {}
    for fqn, p, leaf, shape in _flax_leaves(module):
        spec = _leaf_spec(leaf.name, shape, sizes, tp_rules, ignored, fsdp_axes,
                          min_size_to_shard)
        placement = expert = None
        layer_spec = spec[1:] if leaf.index is not None else spec
        layer_shape = shape[1:] if leaf.index is not None else shape
        for f, entry in enumerate(layer_spec):
            axes = entry if isinstance(entry, tuple) else (entry,)
            if entry is None:
                continue
            key = (leaf.name, layer_shape, tuple(p.shape), f)
            if ep_axes and axes == ep_axes and _EXPERT_STACK_RE.search(leaf.name):
                if key not in found:
                    found[key] = _port_placement(leaf, layer_shape, tuple(p.shape), f,
                                                 cfg.ep_size)
                expert = found[key]
                continue
            if axes != ("tp",) or tp == 1:
                continue
            if key not in found:  # every layer of a stack maps alike
                found[key] = _port_placement(leaf, layer_shape, tuple(p.shape), f, tp)
            placement = found[key]
        plan[fqn] = ParamPlacement(leaf.name, spec, placement, expert)
    return plan


def _port_placement(leaf, flax_shape: tuple, port_shape: tuple, f: int, tp: int):
    """The placement of the port's tensor that gives each of ``tp`` ranks
    the elements the flax dim ``f`` split ``tp`` ways gives it: found by
    carrying each element's rank through the leaf's ``from_flax``."""
    from torch.distributed.tensor import Shard

    n = flax_shape[f]
    view = [1] * len(flax_shape)
    view[f] = n
    ranks = (torch.arange(n) // (n // tp)).to(torch.uint8).view(view).expand(flax_shape)
    port = leaf.from_flax(ranks.contiguous())
    for dim in range(port.dim()):
        other = [d for d in range(port.dim()) if d != dim]
        along = port.amax(other) if other else port
        if other and not torch.equal(along, port.amin(other)):
            continue
        length = port_shape[dim]
        for sf in range(1, length + 1):
            if length % (sf * tp):
                continue
            chunk = length // (sf * tp)
            want = (torch.arange(length) // chunk) % tp
            if not torch.equal(along.long(), want):
                continue
            if sf == 1:
                return Shard(dim)
            from torch.distributed.tensor.placement_types import _StridedShard

            return _StridedShard(dim, split_factor=sf)
    raise ValueError(f"{leaf.name}: the split of flax dim {f} is no split of one dim of the "
                     f"port's {port_shape} tensor")


def apply_tensor_parallel(module, plan: dict, mesh, kind: str = "tp") -> None:
    """Put ``module`` on ``plan`` in place: each parameter with a ``tp``
    placement (with ``kind="ep"``, an ``ep`` one) becomes a ``DTensor``
    over ``mesh`` (the 1-D ``tp`` slice, or the ep slice of
    ``state.ExpertGroups``) whose local tensor is a copy of this rank's
    rows of the whole tensor every rank holds (no communication; the
    whole one is freed); the others stay as they are."""
    from torch import nn
    from torch.distributed.tensor import DTensor

    from .tp import local_rows

    for fqn, p in list(module.named_parameters()):
        placement = getattr(plan[fqn], kind)
        if placement is None:
            continue
        owner, _, attr = fqn.rpartition(".")
        mod = module.get_submodule(owner) if owner else module
        rows = local_rows(p.shape[placement.dim], placement, mesh.get_local_rank(), mesh.size(),
                          p.device)
        local = p.detach().index_select(placement.dim, rows)
        dt = DTensor.from_local(local, mesh, [placement], run_check=False, shape=p.shape,
                                stride=p.stride())
        setattr(mod, attr, nn.Parameter(dt, requires_grad=p.requires_grad))
