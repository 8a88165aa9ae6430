"""Seeding (counterpart of ``accelerate_tpu/utils/random.py:set_seed``)."""

from __future__ import annotations

import os
import random

import numpy as np
import torch


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
