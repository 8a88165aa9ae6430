"""Disk offload store: raw memmaps and a JSON index (counterpart of
``accelerate_tpu/utils/offload.py``).

The format is the JAX package's: one ``<name>.dat`` file of raw
little-endian elements per weight (``/`` in the name written ``--``) and
``index.json`` mapping each name to ``{"dtype", "shape"}``, so a folder one
package wrote the other reads, weight by weight, with O(1) host memory.

``dtype`` is numpy's name of the element type. bfloat16, which numpy lacks
(the JAX package writes it through ``ml_dtypes`` as ``"bfloat16"``), is
stored as its 16-bit words: the port writes a ``torch.bfloat16`` tensor's
words under that name and reads such an entry as ``uint16`` viewed as
``torch.bfloat16``, with no ``ml_dtypes`` needed. Weights come back as torch
tensors over the memmap (copy-on-write: writing to one never reaches the
file).
"""

from __future__ import annotations

import json
import os
from collections.abc import Mapping
from typing import Any, Optional

import numpy as np
import torch

_BF16 = "bfloat16"


def _path(offload_folder: str, weight_name: str) -> str:
    return os.path.join(offload_folder, f"{weight_name.replace('/', '--')}.dat")


def _host_words(weight) -> tuple[np.ndarray, str]:
    """(a numpy array of the weight's elements, the index's dtype name);
    bfloat16 as its uint16 words."""
    if torch.is_tensor(weight):
        t = weight.detach().to("cpu").contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), _BF16
        return t.numpy(), t.numpy().dtype.name
    a = np.asarray(weight)
    if a.dtype.name == _BF16:  # ml_dtypes' bfloat16
        return a.view(np.uint16), _BF16
    return a, a.dtype.name


def offload_weight(weight, weight_name: str, offload_folder: str,
                   index: Optional[dict] = None) -> dict:
    """Write one weight (a tensor or an array) to ``<folder>/<name>.dat``;
    return its index entry (and add it to ``index`` when given)."""
    os.makedirs(offload_folder, exist_ok=True)
    array, dtype = _host_words(weight)
    entry = {"dtype": dtype, "shape": list(array.shape)}
    shape = tuple(array.shape) or (1,)
    mm = np.memmap(_path(offload_folder, weight_name), dtype=array.dtype, mode="w+",
                   shape=shape)
    mm[:] = array.reshape(shape)[:]
    mm.flush()
    del mm
    if index is not None:
        index[weight_name] = entry
    return entry


def load_offloaded_weight(offload_folder: str, weight_name: str,
                          weight_info: Mapping[str, Any]) -> torch.Tensor:
    """One weight back as a tensor over its memmap (no copy)."""
    dtype = weight_info["dtype"]
    np_dtype = np.uint16 if dtype == _BF16 else np.dtype(dtype)
    shape = tuple(weight_info["shape"]) or (1,)
    mm = np.memmap(_path(offload_folder, weight_name), dtype=np_dtype, mode="c", shape=shape)
    t = torch.from_numpy(mm)
    if dtype == _BF16:
        t = t.view(torch.bfloat16)
    return t.reshape(tuple(weight_info["shape"]))


def save_offload_index(index: Mapping[str, Any], offload_folder: str) -> None:
    """Merge ``index`` into ``<folder>/index.json``."""
    os.makedirs(offload_folder, exist_ok=True)
    path = os.path.join(offload_folder, "index.json")
    current = {}
    if os.path.isfile(path):
        with open(path) as f:
            current = json.load(f)
    current.update(index)
    with open(path, "w") as f:
        json.dump(current, f, indent=2)


def load_offload_index(offload_folder: str) -> dict:
    path = os.path.join(offload_folder, "index.json")
    if not os.path.isfile(path):
        return {}
    with open(path) as f:
        return json.load(f)


def offload_state_dict(save_dir: str, state_dict: Mapping[str, Any]) -> dict:
    """Offload a whole flat state dict; returns the index."""
    index: dict = {}
    for name, w in state_dict.items():
        offload_weight(w, name, save_dir, index=index)
    save_offload_index(index, save_dir)
    return index


class OffloadedWeightsLoader(Mapping):
    """Read-through mapping over an in-memory state dict and an offload
    folder: the folder's weights load lazily, each as a tensor over its
    memmap."""

    def __init__(self, state_dict: Optional[Mapping[str, Any]] = None,
                 save_folder: Optional[str] = None, index: Optional[Mapping[str, Any]] = None):
        if state_dict is None and save_folder is None:
            raise ValueError("Need either a state_dict or a save_folder")
        self.state_dict = dict(state_dict or {})
        self.save_folder = save_folder
        self.index = dict(index if index is not None else
                          (load_offload_index(save_folder) if save_folder else {}))
        self.all_keys = sorted(set(self.state_dict) | set(self.index))

    def __getitem__(self, key: str):
        if key in self.state_dict:
            return self.state_dict[key]
        return load_offloaded_weight(self.save_folder, key, self.index[key])

    def __iter__(self):
        return iter(self.all_keys)

    def __len__(self):
        return len(self.all_keys)


def extract_submodule_tensors(loader: Mapping, prefixes: list[str], sep: str = "/") -> dict:
    """The entries of ``loader`` under any of ``prefixes``."""
    return {key: loader[key] for key in loader
            if any(key == p or key.startswith(p + sep) for p in prefixes)}
