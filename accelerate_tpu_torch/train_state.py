"""The training state the train step advances.

Counterpart of ``accelerate_tpu/train_state.py``. The JAX ``TrainState`` is
an immutable pytree (step, params, opt_state) threaded through a jitted
step; here the parameters live in the module and the moments in the torch
optimizer, both updated in place, so the state names them and counts
steps. ``DynamicLossScale`` (fp16) is not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .model import Model


@dataclass
class TrainState:
    step: int
    model: Model
    optimizer: torch.optim.Optimizer

    @property
    def params(self) -> dict:
        return dict(self.model.module.named_parameters())
