"""Name-keyed state dicts and the safetensors format.

Counterpart of ``accelerate_tpu/utils/other.py:27-190``: ``/``-path
flattening of nested dicts, byte sizes, shard splitting with an index, and
safetensors files. The format is written and read here, without the
``safetensors`` package: an 8-byte little-endian header length, a JSON
header (``{name: {"dtype", "shape", "data_offsets"}}``, space-padded so the
data starts 8-byte aligned) and the tensors' raw little-endian bytes, one
after another. Large files go through the native library's parallel
positioned reads and writes (``native.pread_segments``/``pwrite_segments``,
which also fsync), small ones through Python file I/O.

Tensors are torch tensors on the host (numpy arrays are accepted when
saving). A load can land in pinned host memory, from which a copy to the
card runs asynchronously.

Also the small helpers of ``accelerate_tpu/utils/other.py``:
``convert_bytes``, ``get_free_port``, ``merge_dicts``,
``extract_model_from_parallel`` and ``wait_for_everyone``.
"""

from __future__ import annotations

import json
import os
import re
import socket
from typing import Any, Mapping

import numpy as np
import torch

from .. import native

ST_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I64": torch.int64, "I32": torch.int32, "I16": torch.int16, "I8": torch.int8,
    "U8": torch.uint8, "BOOL": torch.bool,
}
_ST_NAMES = {dtype: name for name, dtype in ST_DTYPES.items()}


# ---------------------------------------------------------------------------
# Nested dict <-> flat dict with "/"-joined keys
# ---------------------------------------------------------------------------


def flatten_state_dict(tree, sep: str = "/") -> dict[str, Any]:
    """``{"a": {"b": x}}`` → ``{"a/b": x}``; lists and tuples are keyed by
    position and ``None`` leaves are dropped, as in the JAX package."""
    flat: dict[str, Any] = {}
    _flatten_into(flat, "", tree, sep)
    return flat


def _flatten_into(flat: dict, prefix: str, node, sep: str) -> None:
    # A module-level function, not a closure over `flat`: a recursive closure
    # is a reference cycle, which would keep the leaves (device tensors of a
    # checkpoint) alive until the cyclic garbage collector runs.
    if isinstance(node, Mapping):
        items = node.items()
    elif isinstance(node, (list, tuple)):
        items = enumerate(node)
    else:
        if node is not None:
            flat[prefix] = node
        return
    for k, v in items:
        _flatten_into(flat, f"{prefix}{sep}{k}" if prefix else str(k), v, sep)


def unflatten_state_dict(flat: Mapping[str, Any], sep: str = "/") -> dict:
    """Inverse of :func:`flatten_state_dict`; every level becomes a dict."""
    tree: dict = {}
    for key, value in flat.items():
        parts = key.split(sep)
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return tree


# ---------------------------------------------------------------------------
# Sizes and shards
# ---------------------------------------------------------------------------


def parse_bytes(size: str | int) -> int:
    """'5GB' → 5·10⁹ bytes; 'KiB'-style units are powers of two."""
    if isinstance(size, int):
        return size
    m = re.fullmatch(r"\s*([\d.]+)\s*([KMGT]?I?B?)\s*", size.upper())
    if not m:
        raise ValueError(f"Unparseable size {size!r}")
    mult = {"B": 1, "": 1, "KB": 10**3, "KIB": 2**10, "MB": 10**6, "MIB": 2**20,
            "GB": 10**9, "GIB": 2**30, "TB": 10**12, "TIB": 2**40}[m.group(2)]
    return int(float(m.group(1)) * mult)


def _nbytes(x) -> int:
    if torch.is_tensor(x):
        return x.numel() * x.element_size()
    return int(np.asarray(x).nbytes)


def shard_state_dict(state_dict: dict, max_shard_size: str | int = "5GB",
                     weights_name: str = "model.safetensors"):
    """Split a flat state dict, in order, into shards of at most
    ``max_shard_size`` bytes (a larger tensor gets a shard of its own).
    Returns ``({file name: shard}, index)``; the index is None for one
    shard, else ``{"metadata": {"total_size"}, "weight_map": {key: file}}``
    with files named ``model-00001-of-00003.safetensors``."""
    max_bytes = parse_bytes(max_shard_size)
    shards: list[dict] = [{}]
    sizes = [0]
    for key, tensor in state_dict.items():
        nbytes = _nbytes(tensor)
        if sizes[-1] + nbytes > max_bytes and sizes[-1] > 0:
            shards.append({})
            sizes.append(0)
        shards[-1][key] = tensor
        sizes[-1] += nbytes
    if len(shards) == 1:
        return {weights_name: shards[0]}, None
    root, ext = os.path.splitext(weights_name)
    named, index = {}, {"metadata": {"total_size": sum(sizes)}, "weight_map": {}}
    for i, shard in enumerate(shards):
        shard_name = f"{root}-{i + 1:05d}-of-{len(shards):05d}{ext}"
        named[shard_name] = shard
        for key in shard:
            index["weight_map"][key] = shard_name
    return named, index


# ---------------------------------------------------------------------------
# safetensors files
# ---------------------------------------------------------------------------


def _host_tensor(x) -> torch.Tensor:
    if isinstance(x, np.ndarray) or np.isscalar(x):
        a = np.asarray(x)
        return torch.from_numpy(a if a.flags.c_contiguous else a.copy(order="C"))
    if not torch.is_tensor(x):
        raise TypeError(f"cannot save {type(x).__name__} to safetensors")
    if x.device.type != "cpu":
        raise ValueError("safetensors files are written from host tensors; copy to the host first")
    return x.contiguous()


def _bytes(t: torch.Tensor) -> np.ndarray:
    """The raw bytes of a contiguous host tensor, as a writable uint8 view."""
    return t.reshape(-1).view(torch.uint8).numpy()


def save_safetensors(state_dict: Mapping[str, Any], path: str) -> None:
    """Write one safetensors file (created or truncated)."""
    host = {k: _host_tensor(v) for k, v in state_dict.items()}
    header, offset = {}, 0
    for name, t in host.items():
        if t.dtype not in _ST_NAMES:
            raise TypeError(f"{name}: dtype {t.dtype} has no safetensors name")
        nbytes = _nbytes(t)
        header[name] = {"dtype": _ST_NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    hjson = json.dumps(header, separators=(",", ":")).encode()
    hjson += b" " * (-(8 + len(hjson)) % 8)
    blob = len(hjson).to_bytes(8, "little") + hjson
    tensors = list(host.values())
    sizes = [_nbytes(t) for t in tensors]
    offsets = [len(blob) + header[k]["data_offsets"][0] for k in host]
    if native.pwrite_segments(path, blob, offsets, sizes, [t.data_ptr() for t in tensors]):
        return
    native.count_path("pwrite_segments", False)
    with open(path, "wb") as f:
        f.write(blob)
        for t in tensors:
            f.write(memoryview(_bytes(t)))
        f.flush()
        os.fsync(f.fileno())


def load_safetensors(path: str, pin_memory: bool = False) -> dict[str, torch.Tensor]:
    """Read one safetensors file into host tensors (pinned when asked)."""
    with open(path, "rb") as f:
        hlen = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(hlen))
    base = 8 + hlen
    out, offsets, sizes = {}, [], []
    for name, meta in header.items():
        if name == "__metadata__":
            continue
        if meta["dtype"] not in ST_DTYPES:
            raise ValueError(f"{path}: {name} has unsupported dtype {meta['dtype']}")
        t = torch.empty(meta["shape"], dtype=ST_DTYPES[meta["dtype"]], pin_memory=pin_memory)
        b0, b1 = meta["data_offsets"]
        if b1 - b0 != _nbytes(t):
            raise ValueError(f"{path}: {name} holds {b1 - b0} bytes for shape {meta['shape']}")
        out[name] = t
        offsets.append(base + b0)
        sizes.append(b1 - b0)
    tensors = list(out.values())
    if native.pread_segments(path, offsets, sizes, [t.data_ptr() for t in tensors]):
        return out
    native.count_path("pread_segments", False)
    with open(path, "rb") as f:
        for t, off, size in zip(tensors, offsets, sizes):
            if size == 0:
                continue
            f.seek(off)
            if f.readinto(memoryview(_bytes(t))) != size:
                raise ValueError(f"{path} is shorter than its header says")
    return out


def save_sharded_safetensors(state_dict: dict, save_directory: str,
                             max_shard_size: str | int = "5GB",
                             weights_name: str = "model.safetensors") -> list[str]:
    """Save as one file, or as shards plus ``<name>.index.json`` when the
    dict exceeds ``max_shard_size``. Returns the file names."""
    os.makedirs(save_directory, exist_ok=True)
    named, index = shard_state_dict(state_dict, max_shard_size, weights_name)
    for shard_name, shard in named.items():
        save_safetensors(shard, os.path.join(save_directory, shard_name))
    if index is not None:
        index_path = os.path.join(
            save_directory, weights_name.replace(".safetensors", ".safetensors.index.json"))
        with open(index_path, "w") as f:
            json.dump(index, f, indent=2)
    return sorted(named)


def load_sharded_safetensors(directory: str, weights_name: str = "model.safetensors",
                             pin_memory: bool = False) -> dict[str, torch.Tensor]:
    """Read the shards named by the index, or the single file."""
    index_path = os.path.join(
        directory, weights_name.replace(".safetensors", ".safetensors.index.json"))
    single = os.path.join(directory, weights_name)
    state: dict[str, torch.Tensor] = {}
    if os.path.exists(index_path):
        with open(index_path) as f:
            index = json.load(f)
        for shard_name in sorted(set(index["weight_map"].values())):
            state.update(load_safetensors(os.path.join(directory, shard_name), pin_memory))
    elif os.path.exists(single):
        state.update(load_safetensors(single, pin_memory))
    else:
        raise FileNotFoundError(f"No {weights_name} or index found in {directory}")
    return state


def convert_bytes(size: float) -> str:
    """Bytes in human units of 1024 (``"1.50 KB"``)."""
    for unit in ["B", "KB", "MB", "GB", "TB"]:
        if abs(size) < 1024.0:
            return f"{size:.2f} {unit}"
        size /= 1024.0
    return f"{size:.2f} PB"


def get_free_port() -> int:
    """A TCP port free on this host now (for a ``tcp://localhost`` group)."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("", 0))
        return s.getsockname()[1]


def merge_dicts(source: dict, destination: dict) -> dict:
    """``source`` merged into ``destination`` in place, nested dicts key by
    key; returns ``destination``."""
    for key, value in source.items():
        if isinstance(value, dict):
            merge_dicts(value, destination.setdefault(key, {}))
        else:
            destination[key] = value
    return destination


def extract_model_from_parallel(model, keep_fp32_wrapper: bool = True, recursive: bool = False):
    """The user's model from a prepared one. ``prepare`` hands back the
    user's ``Model`` itself, so only a ``DistributedDataParallel`` wrapper
    goes (of a module passed alone, and with ``recursive`` of its
    submodules)."""
    from torch.nn.parallel import DistributedDataParallel

    while isinstance(model, DistributedDataParallel):
        model = model.module
    if recursive and isinstance(model, torch.nn.Module):
        for name, child in list(model.named_children()):
            setattr(model, name, extract_model_from_parallel(child, recursive=True))
    return model


def wait_for_everyone() -> None:
    """A barrier over every process (nothing alone)."""
    from ..state import PartialState

    PartialState().wait_for_everyone()
