"""The training state the train step advances, and fp16 loss scaling.

Counterpart of ``accelerate_tpu/train_state.py``. The JAX ``TrainState`` is
an immutable pytree (step, params, opt_state, loss_scale) threaded through
a jitted step; here the parameters live in the module and the moments in
the torch optimizer, both updated in place, so the state names them and
counts steps.

``extra_state`` is the JAX state's: flax's non-parameter collections
(BatchNorm's ``{"batch_stats": ...}``), here the model's buffers
(``Model.extra_state``), which a ``mutable_state`` step updates in place.

Under fp16 loss scaling a step whose gradients are not all finite is
skipped without the host waiting for the card: ``step`` is then a device
tensor (int32) advanced by the finite flag, and ``DynamicLossScale``'s
scale and growth tracker are device tensors updated in place. Reading
``int(state.step)`` waits for the card; checkpoints do.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Union

import torch

from .model import Model


class DynamicLossScale:
    """fp16 dynamic loss scaling with the JAX package's rule: after
    ``growth_interval`` finite steps in a row the scale grows by
    ``growth_factor``; a non-finite step multiplies it by
    ``backoff_factor``, never below 1.0, and restarts the count.
    ``scale`` (fp32) and ``growth_tracker`` (int32) are device tensors;
    nothing here waits for the card."""

    def __init__(self, scale: torch.Tensor, growth_tracker: torch.Tensor,
                 growth_factor: float = 2.0, backoff_factor: float = 0.5,
                 growth_interval: int = 2000):
        self.scale, self.growth_tracker = scale, growth_tracker
        self.growth_factor, self.backoff_factor = growth_factor, backoff_factor
        self.growth_interval = growth_interval

    @classmethod
    def create(cls, init_scale: float = 2.0**16, device=None, **kwargs) -> "DynamicLossScale":
        return cls(scale=torch.tensor(init_scale, dtype=torch.float32, device=device),
                   growth_tracker=torch.zeros((), dtype=torch.int32, device=device), **kwargs)

    def unscale(self, grads: list) -> torch.Tensor:
        """Multiply ``grads`` in place by ``1 / scale`` and return whether
        every value is finite (a bool device tensor), in one multi-tensor
        pass (``torch._amp_foreach_non_finite_check_and_unscale_``). It
        checks the scaled values; since the scale never falls below 1, a
        scaled value is finite exactly when the unscaled one is, which is
        what the JAX package checks."""
        if not grads:
            return torch.ones((), dtype=torch.bool, device=self.scale.device)
        # On the gradients' device (the host's under FSDP2's CPU offload).
        found_inf = torch.zeros((), dtype=torch.float32, device=grads[0].device)
        torch._amp_foreach_non_finite_check_and_unscale_(
            grads, found_inf, (1.0 / self.scale).to(found_inf.device))
        return (found_inf == 0).to(self.scale.device)

    def update(self, finite: torch.Tensor) -> "DynamicLossScale":
        """The next scale and growth tracker after a step whose gradients
        were ``finite`` (a bool tensor), in place."""
        tracker = torch.where(finite, self.growth_tracker + 1, 0)
        grow = tracker >= self.growth_interval
        new_scale = torch.where(
            finite, torch.where(grow, self.scale * self.growth_factor, self.scale),
            torch.clamp(self.scale * self.backoff_factor, min=1.0))
        self.scale.copy_(new_scale)
        self.growth_tracker.copy_(torch.where(grow, 0, tracker))
        return self


def tree_items(tree, prefix: tuple = ()):
    """(key path, leaf) of nested dicts, in sorted key order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_items(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def grads_all_finite(grads: list) -> torch.Tensor:
    """Whether every gradient value is finite: a bool device tensor."""
    if not grads:
        return torch.tensor(True)
    return torch.stack([torch.isfinite(g).all() for g in grads]).all()


@dataclass
class TrainState:
    step: Union[int, torch.Tensor]
    model: Model
    optimizer: torch.optim.Optimizer
    loss_scale: Optional[DynamicLossScale] = None
    extra_state: Any = None

    @property
    def params(self) -> dict:
        return dict(self.model.module.named_parameters())

    def set_extra_state(self, new) -> None:
        """Take ``new`` (a tree shaped as ``extra_state``) as the extra
        state: copied into the tensors ``extra_state`` holds (a module's
        buffers stay its running statistics), or kept when there were none."""
        if self.extra_state is None:
            self.extra_state = new
            return
        old, new = dict(tree_items(self.extra_state)), dict(tree_items(new))
        if old.keys() != new.keys():
            raise ValueError(f"extra_state holds {sorted(old)[:4]}..., the new one "
                             f"{sorted(new)[:4]}...: the trees must match")
        with torch.no_grad():
            torch._foreach_copy_(list(old.values()), [new[k].to(old[k].device) for k in old])

    def set_step(self, step: int) -> None:
        """Set the step count (a checkpoint's), in place on the device
        under loss scaling."""
        if torch.is_tensor(self.step):
            self.step.fill_(step)
        else:
            self.step = step
