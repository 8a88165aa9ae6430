"""Seeding and the host RNG state of a checkpoint.

Counterpart of ``accelerate_tpu/utils/random.py``: ``set_seed``, and
``rng_state``/``load_rng_state`` for ``random_states_<rank>.pkl``. The JAX
package keeps ``python``, ``numpy`` and ``jax`` (its key registry's seed and
counters); the port keeps ``python``, ``numpy``, ``torch`` (the CPU
generator) and ``torch_cuda`` (one state per CUDA device, when CUDA is set
up), and the JAX package's ``jax`` entry, so that its ``load_rng_state``
reads the file: the one the last ``load_rng_state`` read, else the state
``set_seed`` gives the JAX key registry (``{"seed": seed, "counters":
{}}``, seed 0 before any ``set_seed``). Torch states are stored as numpy
uint8 arrays, so the file unpickles without torch's classes.

``synchronize_rng_states`` broadcasts process 0's states of the named kinds
(``RNGType``) to every process, as the JAX package broadcasts its own.
"""

from __future__ import annotations

import enum
import os
import random
from typing import Iterable, Optional

import numpy as np
import torch

# The JAX package's key-registry state (its random_states' "jax" entry),
# carried through a port run unchanged.
_jax_registry_state: dict = {"seed": 0, "counters": {}}


class RNGType(str, enum.Enum):
    """The generators ``synchronize_rng_state`` can align. ``generator`` is
    a ``torch.Generator`` passed by the caller (a sampler's)."""

    TORCH = "torch"
    CUDA = "cuda"
    GENERATOR = "generator"
    NUMPY = "numpy"
    PYTHON = "python"


def set_seed(seed: int, device_specific: bool = False) -> torch.Generator:
    """Seed python, numpy and torch (every CUDA device included), and return
    a ``torch.Generator`` seeded with the same value for code that takes an
    explicit generator. ``device_specific`` offsets the seed by the process
    index."""
    if device_specific:
        from ..state import PartialState

        seed += PartialState().process_index
    global _jax_registry_state
    random.seed(seed)
    np.random.seed(seed % (2**32))
    torch.manual_seed(seed)
    _jax_registry_state = {"seed": int(seed), "counters": {}}
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
        "jax": {"seed": _jax_registry_state["seed"],
                "counters": dict(_jax_registry_state["counters"])},
    }
    if torch.cuda.is_initialized():
        state["torch_cuda"] = [s.numpy() for s in torch.cuda.get_rng_state_all()]
    return state


def load_rng_state(state: dict) -> None:
    """Restore what ``state`` holds. A JAX package checkpoint holds
    ``python``, ``numpy`` and ``jax``: the first two are restored, and
    ``jax`` (its key registry), which no torch generator reads, is kept to
    be written back by ``rng_state``; the torch generators keep their
    state."""
    global _jax_registry_state
    if "jax" in state:
        _jax_registry_state = {"seed": int(state["jax"]["seed"]),
                               "counters": dict(state["jax"]["counters"])}
    random.setstate(state["python"])
    np.random.set_state(state["numpy"])
    if "torch" in state:
        torch.set_rng_state(torch.from_numpy(np.asarray(state["torch"], dtype=np.uint8)))
    if "torch_cuda" in state and torch.cuda.is_available():
        torch.cuda.set_rng_state_all(
            [torch.from_numpy(np.asarray(s, dtype=np.uint8)) for s in state["torch_cuda"]])


def synchronize_rng_state(rng_type: Optional[RNGType] = None,
                          generator: Optional[torch.Generator] = None) -> None:
    """Process 0's state of one generator on every process; alone, nothing
    to do. ``None`` means ``generator`` when one is given, else torch's CPU
    generator."""
    from ..state import PartialState
    from .operations import broadcast_object_list

    if PartialState().num_processes == 1:
        return
    if rng_type is None:
        rng_type = RNGType.GENERATOR if generator is not None else RNGType.TORCH
    rng_type = RNGType(rng_type)
    get, put = {
        RNGType.TORCH: (lambda: torch.get_rng_state().numpy(),
                        lambda s: torch.set_rng_state(torch.from_numpy(s))),
        RNGType.CUDA: (lambda: torch.cuda.get_rng_state().numpy(),
                       lambda s: torch.cuda.set_rng_state(torch.from_numpy(s))),
        RNGType.GENERATOR: (lambda: generator.get_state().numpy(),
                            lambda s: generator.set_state(torch.from_numpy(s))),
        RNGType.NUMPY: (np.random.get_state, np.random.set_state),
        RNGType.PYTHON: (random.getstate, random.setstate),
    }[rng_type]
    if rng_type == RNGType.GENERATOR and generator is None:
        raise ValueError("rng_type 'generator' needs the generator")
    payload = [get()]
    broadcast_object_list(payload, from_process=0)
    put(payload[0])


def synchronize_rng_states(rng_types: Iterable[str], generator=None) -> None:
    """``synchronize_rng_state`` for each named kind, in order."""
    for rng_type in rng_types:
        synchronize_rng_state(RNGType(rng_type), generator=generator)
