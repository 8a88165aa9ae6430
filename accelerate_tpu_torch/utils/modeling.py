"""Model placement for big-model inference (counterpart of
``accelerate_tpu/utils/modeling.py``).

Names, sizes and device maps are those of the JAX package: every parameter
is keyed by its ``/``-joined name in the flax tree of the same config
(``models/convert.flax_leaf``: ``model/layers_3/mlp/down_proj/kernel``, or
the stacked ``model/layers/block/...`` of ``scan_layers``), so one device
map places a model the same way in both packages, and
``infer_auto_device_map`` gives equal maps for equal budgets. A torch
``weight`` ``(out, in)`` holds the bytes of flax's ``kernel`` ``(in, out)``.

- The abstract model is the port's module built on ``device="meta"``;
  ``compute_abstract_params`` gives its flax tree of meta tensors (zero
  bytes), shapes and dtypes as the JAX package's ``jax.eval_shape``.
- A placement is a GPU (an index or a ``torch.device``), ``"cpu"`` (host
  memory, pinned where a card takes the copies) or ``"disk"`` (a memmap of
  ``utils/offload.py``).
- ``load_checkpoint_in_model`` reads the JAX package's sharded safetensors
  checkpoint (flax names, scanned or not) one shard at a time and converts
  each leaf to the port's layout as it places it: the store it returns maps
  the module's parameter names to a tensor on its device or on the host, or
  to a ``_DiskHandle`` of a leaf written to the offload folder in flax's
  layout (the folder the JAX package writes).
"""

from __future__ import annotations

import json
import os
import re
import warnings
from collections import defaultdict
from typing import Any, Mapping, Optional, Union

import numpy as np
import torch

from .other import convert_bytes, load_safetensors, parse_bytes, unflatten_state_dict

# A placement: a GPU (torch.device), "cpu" (host memory) or "disk" (memmap).
Placement = Union[torch.device, str]


# ---------------------------------------------------------------------------
# Abstract (meta) parameters
# ---------------------------------------------------------------------------


def _leaves(module):
    """(fqn, parameter, FlaxLeaf) of every parameter of ``module``."""
    from ..models.convert import flax_leaf

    return [(fqn, p, flax_leaf(module, fqn)) for fqn, p in module.named_parameters()]


def compute_abstract_params(module, *sample_args, rng=None, **sample_kwargs):
    """The flax tree of ``module``'s parameters as meta tensors: the JAX
    package's names, shapes and dtypes (fp32 masters), no bytes allocated.
    The sample inputs of the JAX signature are not needed (a torch module
    knows its shapes) and are ignored."""
    stacks: dict[str, dict[int, torch.Tensor]] = defaultdict(dict)
    flat: dict[str, torch.Tensor] = {}
    for _, p, leaf in _leaves(module):
        value = leaf.to_flax(torch.empty(p.shape, dtype=p.dtype, device="meta"))
        if leaf.index is None:
            flat[leaf.name] = value
        else:
            stacks[leaf.name][leaf.index] = value
    for name, rows in stacks.items():
        first = rows[0]
        flat[name] = torch.empty((len(rows), *first.shape), dtype=first.dtype, device="meta")
    return unflatten_state_dict(flat)


def named_parameter_shapes(abstract_params, sep: str = "/") -> dict[str, torch.Tensor]:
    """Flat ``{"path/to/param": meta tensor}`` view of an abstract tree
    (keys in sorted order, as the JAX package walks them)."""
    flat = {}

    def _walk(prefix, node):
        if isinstance(node, Mapping):
            for k in sorted(node):
                _walk(f"{prefix}{sep}{k}" if prefix else k, node[k])
        else:
            flat[prefix] = node

    _walk("", abstract_params)
    return flat


def dtype_byte_size(dtype) -> float:
    """Bytes per element of a torch or numpy dtype or its name; int4 is
    half a byte."""
    name = str(dtype).replace("torch.", "")
    if "int4" in name:
        return 0.5
    if isinstance(dtype, torch.dtype):
        return dtype.itemsize
    if name == "bfloat16":
        return 2
    return np.dtype(dtype).itemsize


def tensor_bytes(t) -> int:
    n = int(np.prod(tuple(t.shape))) if len(t.shape) else 1
    return int(n * dtype_byte_size(t.dtype))


def compute_module_sizes(abstract_params, dtype=None, sep: str = "/") -> dict[str, int]:
    """Bytes per name prefix, ``""`` for the whole model: every ancestor
    prefix of a leaf accumulates its size. ``dtype`` overrides the stored
    one (a load-time cast)."""
    sizes: dict[str, int] = defaultdict(int)
    for name, spec in named_parameter_shapes(abstract_params, sep=sep).items():
        size = int(np.prod(tuple(spec.shape)) * dtype_byte_size(dtype or spec.dtype))
        sizes[""] += size
        parts = name.split(sep)
        for i in range(1, len(parts) + 1):
            sizes[sep.join(parts[:i])] += size
    return dict(sizes)


def calculate_maximum_sizes(abstract_params, sep: str = "/"):
    """(total bytes, (largest leaf module's bytes, its name))."""
    sizes = compute_module_sizes(abstract_params, sep=sep)
    leaf_names = named_parameter_shapes(abstract_params, sep=sep)
    modules = {sep.join(n.split(sep)[:-1]) or n: 0 for n in leaf_names}
    for m in modules:
        modules[m] = sizes.get(m, 0)
    biggest = max(modules.items(), key=lambda kv: kv[1]) if modules else ("", 0)
    return sizes[""], (biggest[1], biggest[0])


# ---------------------------------------------------------------------------
# Memory budgets
# ---------------------------------------------------------------------------


def _is_device_key(k) -> bool:
    return k not in ("cpu", "disk")


def _device_order(k) -> tuple:
    d = torch.device("cuda", k) if isinstance(k, int) else torch.device(k)
    return (d.type, d.index if d.index is not None else -1)


def get_max_memory(max_memory: Optional[dict] = None) -> dict[Any, int]:
    """``{gpu index: bytes, "cpu": bytes}``: 90 % of each visible GPU's free
    memory (``torch.cuda.mem_get_info``) and of the host's physical pages.
    A given map passes through with ``"10GiB"``-style sizes parsed; its GPU
    keys may be indices or ``torch.device``s (``torch.device("cpu")`` makes
    the host the "GPU" of a run without a card)."""
    if max_memory is not None:
        return {k: parse_bytes(v) if isinstance(v, (str, int)) else v
                for k, v in max_memory.items()}
    out: dict[Any, int] = {}
    if torch.cuda.is_available():
        for i in range(torch.cuda.device_count()):
            free, _ = torch.cuda.mem_get_info(i)
            out[i] = int(free * 0.9)
    try:
        cpu_bytes = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    except (ValueError, OSError, AttributeError):
        cpu_bytes = 32 * 1024**3
    out["cpu"] = int(cpu_bytes * 0.9)
    return out


def _matches(pattern: str, leaf: str) -> bool:
    return bool(re.fullmatch(pattern, leaf)) or leaf == pattern


def get_balanced_memory(abstract_params, max_memory: Optional[dict] = None,
                        no_split_modules: Optional[list[str]] = None, dtype=None,
                        low_zero: bool = False) -> dict[Any, int]:
    """Even out the GPU budgets so that layers spread over the GPUs instead
    of filling GPU 0 first; ``low_zero`` keeps GPU 0 light (room for the
    cache and the inputs of generation)."""
    max_memory = get_max_memory(max_memory)
    devices = [k for k in max_memory if _is_device_key(k)]
    if len(devices) <= 1:
        return max_memory
    sizes = compute_module_sizes(abstract_params, dtype=dtype)
    n = len(devices) - (1 if low_zero else 0)
    per_device = sizes[""] // n
    # Room for the largest group that may not be split, matched as the map
    # matches it: the last name segment, by regex or equality.
    leaves = [sizes[m] for m in sizes
              if m and no_split_modules
              and any(_matches(pat, m.split("/")[-1]) for pat in no_split_modules)]
    if not leaves:
        # No match: the largest group that holds parameters directly (one
        # block), not a top-level group that is nearly the whole model.
        parents = {"/".join(n.split("/")[:-1]) or n for n in named_parameter_shapes(abstract_params)}
        leaves = [sizes.get(p, 0) for p in parents]
    buffer = max(leaves)
    target = per_device + buffer
    out = dict(max_memory)
    for d in devices:
        cap = 0 if (low_zero and d == devices[0]) else target
        out[d] = min(max_memory[d], cap) if cap else max_memory[d]
    if low_zero:
        out[devices[0]] = min(max_memory[devices[0]], buffer)
    return out


# ---------------------------------------------------------------------------
# Device maps
# ---------------------------------------------------------------------------


def infer_auto_device_map(abstract_params, max_memory: Optional[dict] = None,
                          no_split_modules: Optional[list[str]] = None, dtype=None,
                          offload_buffers: bool = False, sep: str = "/") -> dict[str, Placement]:
    """Greedy top-down packing of name groups onto the budgets: the GPUs in
    order, then ``"cpu"``, then ``"disk"``. A group that does not fit where
    the cursor is splits into its children, unless its last name segment
    matches ``no_split_modules``; then the cursor moves on. The JAX
    package's algorithm on the same names and sizes, so equal budgets give
    equal maps."""
    max_memory = get_max_memory(max_memory)
    no_split = no_split_modules or []
    budgets: list[tuple[Any, float]] = sorted(
        ((k, v) for k, v in max_memory.items() if _is_device_key(k)),
        key=lambda kv: _device_order(kv[0]))
    budgets.append(("cpu", max_memory.get("cpu", 0)))
    budgets.append(("disk", float("inf")))
    sizes = compute_module_sizes(abstract_params, dtype=dtype, sep=sep)
    device_map: dict[str, Any] = {}
    cursor = 0
    remaining = [b for _, b in budgets]

    def _splittable(name: str, node) -> bool:
        if not isinstance(node, Mapping):
            return False
        return not any(_matches(pat, name.split(sep)[-1]) for pat in no_split)

    def _assign(name: str, node):
        nonlocal cursor
        size = sizes.get(name, 0)
        while cursor < len(remaining):
            if size <= remaining[cursor]:
                remaining[cursor] -= size
                device_map[name] = budgets[cursor][0]
                return
            if _splittable(name, node):
                for k in sorted(node):
                    _assign(f"{name}{sep}{k}", node[k])
                return
            cursor += 1
        raise MemoryError(f"Could not place module {name!r} ({convert_bytes(size)}) anywhere.")

    for k in sorted(abstract_params):
        _assign(k, abstract_params[k])
    return normalize_device_map(device_map)


def _covers(name: str, prefix: str, sep: str) -> bool:
    """A map entry covers a name; ``""`` is the match-all root entry."""
    return prefix == "" or name == prefix or name.startswith(prefix + sep)


def normalize_device_map(device_map: Mapping[str, Any]) -> dict[str, Any]:
    """GPU indices (and device strings other than ``"cpu"``/``"disk"``)
    become ``torch.device``s."""
    def _norm(v):
        if isinstance(v, int):
            return torch.device("cuda", v)
        if isinstance(v, str) and v in ("cpu", "disk"):
            return v
        d = torch.device(v)
        return torch.device("cuda", 0) if d.type == "cuda" and d.index is None else d

    return {k: _norm(v) for k, v in device_map.items()}


def default_execution_device(device_map: Mapping[str, Any]) -> torch.device:
    """The first device of the map, else the first GPU."""
    devs = [d for d in normalize_device_map(device_map).values() if isinstance(d, torch.device)]
    return devs[0] if devs else torch.device("cuda", 0)


def check_device_map(abstract_params, device_map: Mapping[str, Placement], sep: str = "/"):
    """Every parameter must be covered, by one entry or by nested ones
    (the longest wins); overlapping entries that do not nest raise."""
    for n in named_parameter_shapes(abstract_params, sep=sep):
        hits = [p for p in device_map if _covers(n, p, sep)]
        if not hits:
            raise ValueError(f"Param {n!r} not covered by device_map")
        hits.sort(key=len)
        for a, b in zip(hits, hits[1:]):
            if a != "" and not b.startswith(a + sep) and a != b:
                raise ValueError(f"Param {n!r} covered by overlapping entries {hits}")


def placement_key(placement) -> str:
    """A placement as a string that tells a device from the host tier:
    ``"cpu"`` and ``"disk"`` as they are, a device as ``"<type>:<index>"``
    (the host as a device, in a run without a card, is ``"cpu:0"``)."""
    if isinstance(placement, str):
        return placement
    return f"{placement.type}:{placement.index if placement.index is not None else 0}"


def placement_for(name: str, device_map: Mapping[str, Placement], sep: str = "/") -> Placement:
    """Longest-prefix lookup of a name's placement."""
    best, best_len = None, -1
    for prefix, placement in device_map.items():
        if _covers(name, prefix, sep) and len(prefix) > best_len:
            best, best_len = placement, len(prefix)
    if best is None:
        raise KeyError(f"No device_map entry covers {name!r}")
    return best


# ---------------------------------------------------------------------------
# Placement and checkpoint streaming
# ---------------------------------------------------------------------------

_warned_pageable: list = []


def _pinned_copy(t: torch.Tensor) -> torch.Tensor:
    """A contiguous host copy of ``t``, pinned where a card will take the
    copies. If pinning is refused (the limit on locked memory), the
    copy stays pageable, and a ``non_blocking`` copy from it to the card is
    then silently synchronous: warned once."""
    pin = torch.cuda.is_available()
    try:
        out = torch.empty(t.shape, dtype=t.dtype, pin_memory=pin)
    except RuntimeError as exc:
        if not _warned_pageable:
            _warned_pageable.append(True)
            warnings.warn(f"host weights stay pageable ({exc}): copies to the card from them "
                          "are synchronous")
        out = torch.empty(t.shape, dtype=t.dtype)
    return out.copy_(t)


def place_tensor(tensor, placement: Placement, target_dtype=None):
    """One weight to its home: a GPU (a copy there), ``"cpu"`` (a pinned
    host copy) or ``"disk"`` (returned as it is; the caller writes it to the
    offload store)."""
    t = tensor if torch.is_tensor(tensor) else torch.as_tensor(np.asarray(tensor))
    if target_dtype is not None and t.dtype != target_dtype:
        t = t.to(target_dtype)
    if placement == "cpu":
        return _pinned_copy(t)
    if placement == "disk":
        return t
    return t.to(placement).contiguous()


class _DiskHandle:
    """A disk-offloaded leaf: ``name``, ``folder``, ``shape`` and ``dtype``
    of the stored (flax-layout) leaf, as the JAX package's handle; in the
    port's store also ``index`` (the layer's row of a stacked leaf) and
    ``from_flax`` (that row in the port's layout)."""

    __slots__ = ("name", "folder", "shape", "dtype", "index", "from_flax")

    def __init__(self, name, folder, shape, dtype, index=None, from_flax=None):
        self.name, self.folder, self.shape = name, folder, tuple(shape)
        self.dtype = dtype if isinstance(dtype, str) else str(dtype).replace("torch.", "")
        self.index, self.from_flax = index, from_flax

    def load(self) -> torch.Tensor:
        """The whole stored leaf, over its memmap."""
        from .offload import load_offloaded_weight

        return load_offloaded_weight(self.folder, self.name,
                                     {"shape": list(self.shape), "dtype": self.dtype})

    def load_port(self) -> torch.Tensor:
        """This parameter's value in the port's layout (a view of the
        memmap where the layout allows)."""
        t = self.load()
        if self.index is not None:
            t = t[self.index]
        return self.from_flax(t) if self.from_flax is not None else t

    @property
    def nbytes(self) -> int:
        shape = self.shape[1:] if self.index is not None else self.shape
        n = int(np.prod(shape)) if shape else 1
        return int(n * dtype_byte_size(self.dtype))

    def __repr__(self):
        return (f"_DiskHandle({self.name!r}, shape={self.shape}, dtype={self.dtype}"
                + (f", index={self.index})" if self.index is not None else ")"))


def _shard_files(checkpoint: str) -> list[str]:
    index_file = os.path.join(checkpoint, "model.safetensors.index.json")
    if os.path.isdir(checkpoint) and os.path.isfile(index_file):
        with open(index_file) as f:
            index = json.load(f)
        return [os.path.join(checkpoint, s) for s in sorted(set(index["weight_map"].values()))]
    if os.path.isdir(checkpoint):
        return [os.path.join(checkpoint, f) for f in sorted(os.listdir(checkpoint))
                if f.endswith(".safetensors")]
    return [checkpoint]


def load_checkpoint_in_model(module, checkpoint: str,
                             device_map: Optional[Mapping[str, Placement]] = None,
                             offload_folder: Optional[str] = None, dtype=None, sep: str = "/"):
    """Read a (sharded) safetensors checkpoint in the JAX package's flax
    names and layouts into the placements of ``device_map`` (flax names;
    default: everything on GPU 0), one shard at a time.

    ``module`` is the port's module (its parameters may be on ``meta``);
    its config's ``scan_layers`` says which flax layout the checkpoint
    holds. Each leaf is cast to ``dtype`` (default: the parameter's, fp32)
    and converted to the port's layout as it is placed. Returns ``(store,
    disk_index)``: ``store`` maps each parameter name of ``module`` to a
    tensor on its GPU, a (pinned) host tensor, or a ``_DiskHandle`` of a
    leaf written to ``offload_folder`` in flax's layout; ``disk_index`` is
    that folder's index."""
    from .offload import offload_weight, save_offload_index

    leaves = _leaves(module)
    by_name: dict[str, list] = defaultdict(list)
    for fqn, p, leaf in leaves:
        by_name[leaf.name].append((fqn, p, leaf))
    if device_map is None:
        device_map = {"": torch.device("cuda", 0)}
    device_map = normalize_device_map(device_map)
    abstract = compute_abstract_params(module)
    check_device_map(abstract, device_map, sep=sep)
    shapes = named_parameter_shapes(abstract, sep=sep)

    store: dict[str, Any] = {}
    disk_index: dict[str, dict] = {}
    for shard in _shard_files(checkpoint):
        for name, arr in load_safetensors(shard).items():
            if name not in by_name:
                continue  # an extra weight is tolerated
            want = shapes[name]
            if tuple(arr.shape) != tuple(want.shape):
                raise ValueError(f"Checkpoint weight {name!r} has shape {tuple(arr.shape)} but "
                                 f"the model expects {tuple(want.shape)}")
            placement = placement_for(name, device_map, sep=sep)
            if isinstance(placement, torch.device):
                arr = arr.to(placement)  # convert on the card: one copy over the bus
            arr = arr.to(dtype or want.dtype)
            if placement == "disk":
                if offload_folder is None:
                    raise ValueError("device_map contains 'disk' entries but no offload_folder "
                                     "given")
                disk_index[name] = offload_weight(arr, name, offload_folder)
                for fqn, _, leaf in by_name[name]:
                    store[fqn] = _DiskHandle(name, offload_folder, arr.shape,
                                             disk_index[name]["dtype"], leaf.index,
                                             leaf.from_flax)
                continue
            for fqn, _, leaf in by_name[name]:
                value = leaf.from_flax(arr if leaf.index is None else arr[leaf.index])
                store[fqn] = (_pinned_copy(value) if placement == "cpu"
                              else value.contiguous())
            del arr
    missing = sorted({fqn for fqn, _, _ in leaves} - set(store))
    if missing:
        raise ValueError(f"Checkpoint {checkpoint} is missing weights: {missing[:8]}…")
    if disk_index:
        save_offload_index(disk_index, offload_folder)
    return store, disk_index
