"""Learning-rate schedule wrapper.

Counterpart of ``accelerate_tpu/scheduler.py``. The wrapped object is a
callable ``schedule(count) -> lr`` (``optimizer.py`` has the optax
schedules). The optimizer built by ``adamw(schedule)`` evaluates the
schedule itself, at its own update count, so the rate it applies does not
depend on this wrapper; the wrapper keeps an explicit count for
``get_last_lr``, logging and checkpoints (``scheduler.bin``). ``step()``
counts only when the optimizer really stepped: on the microbatch that
ends an accumulation window (``GradientState.sync_gradients``) and not
after a skipped step, ``num_processes`` times unless ``split_batches``.
``adjust_scheduler`` has nothing to adjust: a schedule is a pure function
of the count.
"""

from __future__ import annotations

from typing import Callable

from .state import GradientState, PartialState


class AcceleratedScheduler:
    def __init__(self, scheduler: Callable, optimizers=None, step_with_optimizer: bool = True,
                 split_batches: bool = False):
        self.scheduler = scheduler
        self.optimizers = optimizers if isinstance(optimizers, (list, tuple)) else [optimizers]
        self.split_batches = split_batches
        self.step_with_optimizer = step_with_optimizer
        self.gradient_state = GradientState()
        self._step_count = 0

    def step(self, *args, **kwargs):
        if not self.step_with_optimizer:
            self._step_count += 1
            return
        if not self.gradient_state.sync_gradients:
            return
        if any(getattr(opt, "step_was_skipped", False) for opt in self.optimizers):
            return
        self._step_count += 1 if self.split_batches else PartialState().num_processes

    def get_last_lr(self):
        """The schedule at this wrapper's count (a constant rate as is)."""
        if callable(self.scheduler):
            return float(self.scheduler(self._step_count))
        return float(self.scheduler)

    def get_lr(self):
        return self.get_last_lr()

    def state_dict(self):
        return {"step_count": self._step_count}

    def load_state_dict(self, state_dict):
        self._step_count = int(state_dict["step_count"])
