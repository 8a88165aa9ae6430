"""Seeding and the host RNG state of a checkpoint.

Counterpart of ``accelerate_tpu/utils/random.py``: ``set_seed``, and
``rng_state``/``load_rng_state`` for ``random_states_<rank>.pkl``. The JAX
package keeps ``python``, ``numpy`` and ``jax`` (its key registry's seed and
counters); the port keeps ``python``, ``numpy``, ``torch`` (the CPU
generator) and ``torch_cuda`` (one state per CUDA device, when CUDA is set
up). Torch states are stored as numpy uint8 arrays, so the file unpickles
without torch's classes.
"""

from __future__ import annotations

import os
import random
from typing import Iterable

import numpy as np
import torch

_MULTI_GPU_ITEM = "ROADMAP.md Queue A item 1 (multi-GPU FSDP2/DDP)"


def set_seed(seed: int, device_specific: bool = False) -> torch.Generator:
    """Seed python, numpy and torch (every CUDA device included), and return
    a ``torch.Generator`` seeded with the same value for code that takes an
    explicit generator. ``device_specific`` offsets the seed by the process
    index."""
    if device_specific:
        from ..state import PartialState

        seed += PartialState().process_index
    random.seed(seed)
    np.random.seed(seed % (2**32))
    torch.manual_seed(seed)
    os.environ["ACCELERATE_SEED"] = str(seed)
    generator = torch.Generator()
    generator.manual_seed(seed)
    return generator


def rng_state() -> dict:
    """Every host RNG state this process draws from, for a checkpoint."""
    state = {
        "python": random.getstate(),
        "numpy": np.random.get_state(),
        "torch": torch.get_rng_state().numpy(),
    }
    if torch.cuda.is_initialized():
        state["torch_cuda"] = [s.numpy() for s in torch.cuda.get_rng_state_all()]
    return state


def load_rng_state(state: dict) -> None:
    """Restore what ``state`` holds. A JAX package checkpoint holds
    ``python``, ``numpy`` and ``jax``: the first two are restored, and
    ``jax`` (its key registry) has no torch counterpart and is skipped, so
    the torch generators keep their state."""
    random.setstate(state["python"])
    np.random.set_state(state["numpy"])
    if "torch" in state:
        torch.set_rng_state(torch.from_numpy(np.asarray(state["torch"], dtype=np.uint8)))
    if "torch_cuda" in state and torch.cuda.is_available():
        torch.cuda.set_rng_state_all(
            [torch.from_numpy(np.asarray(s, dtype=np.uint8)) for s in state["torch_cuda"]])


def synchronize_rng_states(rng_types: Iterable[str], generator=None) -> None:
    """Broadcast rank 0's RNG states to every process: nothing to do for
    one process."""
    from ..state import PartialState

    if PartialState().num_processes > 1:
        raise NotImplementedError(
            f"synchronising RNG states across processes is {_MULTI_GPU_ITEM}")
