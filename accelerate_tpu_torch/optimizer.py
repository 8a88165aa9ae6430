"""Optimizer factories with optax's names and defaults.

Counterpart of the optax transforms the JAX package takes. ``adamw(...)``
is built before the model's parameters exist, as an optax transform is;
``Accelerator.prepare`` calls it on the parameters.

``optax.adamw`` and ``torch.optim.AdamW`` compute the same update. With
bias-corrected moments m̂ and v̂, optax applies
``p ← p − lr·(m̂/(√v̂ + eps) + wd·p)`` and torch applies
``p ← p·(1 − lr·wd) − lr·m̂/(√v̂ + eps)``: both decouple the weight decay
from the moments, scale it by the learning rate, and apply it to the
parameter before the step. optax's ``eps_root`` is 0 by default, as here.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Iterable

import torch


@dataclass(frozen=True)
class AdamW:
    learning_rate: float
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 1e-4

    def __call__(self, params: Iterable[torch.nn.Parameter]) -> torch.optim.AdamW:
        params = list(params)
        # On the GPU, the fused implementation: one pass over p, g, m and v
        # per parameter group, where the default (foreach) makes several.
        fused = bool(params) and all(p.is_cuda for p in params)
        return torch.optim.AdamW(
            params, lr=self.learning_rate, betas=(self.b1, self.b2), eps=self.eps,
            weight_decay=self.weight_decay, fused=fused or None)


def adamw(learning_rate: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 1e-4, mu_dtype: Any = None) -> AdamW:
    """optax.adamw's signature and defaults (note: weight_decay 1e-4, not
    torch's 1e-2). Moments stay fp32: a lower ``mu_dtype`` is not ported."""
    if mu_dtype not in (None, torch.float32):
        raise NotImplementedError(
            f"mu_dtype={mu_dtype} is not ported yet (ROADMAP.md Queue A item 7)")
    return AdamW(learning_rate, b1, b2, eps, weight_decay)
