"""Optimizer factories and learning-rate schedules with optax's names.

Counterpart of the optax transforms and schedules the JAX package takes.
``adamw(...)`` is built before the model's parameters exist, as an optax
transform is; ``Accelerator.prepare`` calls it on the parameters.

``optax.adamw`` and ``torch.optim.AdamW`` compute the same update. With
bias-corrected moments m̂ and v̂, optax applies
``p ← p − lr·(m̂/(√v̂ + eps) + wd·p)`` and torch applies
``p ← p·(1 − lr·wd) − lr·m̂/(√v̂ + eps)``: both decouple the weight decay
from the moments, scale it by the learning rate, and apply it to the
parameter before the step. optax's ``eps_root`` is 0 by default, as here.

``Accelerator.prepare`` hands back an ``AcceleratedOptimizer`` around the
built one for the imperative loop (``accumulate``/``backward``/``step``);
the train state keeps the built optimizer itself.

The learning rate is a float or a schedule ``schedule(count) -> lr``. optax
evaluates the schedule at the update count before it increments
(``scale_by_schedule``), so update k (from 0) uses ``schedule(k)``;
``ScheduledAdamW`` sets every group's ``lr`` to that value before each
step and counts its updates in ``count``, which a checkpoint carries as
optax's ``count``. The schedules below are copies of optax's, with its
formulas and argument names; at a Python int count they compute in Python
floats, at a device tensor count in float32 tensors (as optax does), so
values agree to float32 rounding.

Under fp16 loss scaling the optimizer skips an overflowed step on the
device (``skip_on_overflow``): the Accelerator sets ``found_inf``, which
torch's fused AdamW reads, leaving parameters, moments and its step
counts as they were. ``count`` is then a device tensor advanced by
``1 - found_inf`` and the rate a device tensor evaluated from it, so that
the schedule follows the skip as optax's ``count`` does, and nothing waits
for the card.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Iterable, Sequence, Union

import torch
from torch.distributed.tensor import DTensor

from .state import GradientState

Schedule = Callable[[int], float]


def constant_schedule(value: float) -> Schedule:
    return lambda count: value


def polynomial_schedule(init_value: float, end_value: float, power: float,
                        transition_steps: int, transition_begin: int = 0) -> Schedule:
    if transition_steps <= 0:
        return lambda count: init_value
    transition_begin = max(transition_begin, 0)

    def schedule(count):
        if torch.is_tensor(count):
            count = torch.clamp(count - transition_begin, 0, transition_steps)
        else:
            count = min(max(count - transition_begin, 0), transition_steps)
        frac = 1 - count / transition_steps
        return (init_value - end_value) * frac**power + end_value

    return schedule


def linear_schedule(init_value: float, end_value: float, transition_steps: int,
                    transition_begin: int = 0) -> Schedule:
    return polynomial_schedule(init_value, end_value, 1, transition_steps, transition_begin)


def cosine_decay_schedule(init_value: float, decay_steps: int, alpha: float = 0.0,
                          exponent: float = 1.0) -> Schedule:
    if not decay_steps > 0:
        raise ValueError(
            f"The cosine_decay_schedule requires positive decay_steps, got decay_steps={decay_steps}.")

    def schedule(count):
        if torch.is_tensor(count):
            count = torch.clamp(count, max=decay_steps)
            cosine_decay = 0.5 * (1 + torch.cos(math.pi * count / decay_steps))
        else:
            count = min(count, decay_steps)
            cosine_decay = 0.5 * (1 + math.cos(math.pi * count / decay_steps))
        return init_value * ((1 - alpha) * cosine_decay**exponent + alpha)

    return schedule


def join_schedules(schedules: Sequence[Schedule], boundaries: Sequence[int]) -> Schedule:
    """``schedules[i]`` from ``boundaries[i - 1]`` on, counted from there."""

    def schedule(count):
        output = schedules[0](count)
        for boundary, sched in zip(boundaries, schedules[1:]):
            if torch.is_tensor(count):
                output = torch.where(count < boundary, output, sched(count - boundary))
            elif count >= boundary:
                output = sched(count - boundary)
        return output

    return schedule


def warmup_cosine_decay_schedule(init_value: float, peak_value: float, warmup_steps: int,
                                 decay_steps: int, end_value: float = 0.0,
                                 exponent: float = 1.0) -> Schedule:
    """Linear warm-up to ``peak_value``, then cosine decay to ``end_value``
    at ``decay_steps`` (which includes the warm-up)."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    return join_schedules(
        [linear_schedule(init_value, peak_value, warmup_steps),
         cosine_decay_schedule(peak_value, decay_steps - warmup_steps, alpha, exponent)],
        [warmup_steps])


class ScheduledAdamW(torch.optim.AdamW):
    """``torch.optim.AdamW`` whose rate follows ``schedule(count)``, where
    ``count`` is the number of updates already applied. ``scheduled`` says
    whether the caller gave a schedule (False for a constant rate): optax's
    state has a schedule's count then (``checkpointing.py``)."""

    def __init__(self, params, schedule: Schedule, scheduled: bool = True, **kwargs):
        self.schedule = schedule
        self.scheduled = scheduled
        self._count = 0
        super().__init__(params, lr=float(schedule(0)), **kwargs)

    def skip_on_overflow(self) -> None:
        """Keep the count and the rate on the device, for steps that
        ``found_inf`` may skip (fused AdamW only)."""
        if not self.defaults.get("fused"):
            raise ValueError("skipping an overflowed step on the device needs fused AdamW")
        device = self.param_groups[0]["params"][0].device
        self._count = torch.tensor(self._count, dtype=torch.int32, device=device)
        for group in self.param_groups:
            group["lr"] = torch.tensor(float(group["lr"]), dtype=torch.float32, device=device)

    @property
    def count(self) -> int:
        """The updates applied (reading a device count waits for the card)."""
        return int(self._count)

    @count.setter
    def count(self, value: int) -> None:
        if torch.is_tensor(self._count):
            self._count.fill_(value)
        else:
            self._count = int(value)

    def step(self, closure=None):
        if not torch.is_tensor(self._count):
            lr = float(self.schedule(self._count))
            for group in self.param_groups:
                group["lr"] = lr
            loss = super().step(closure)
            self._count += 1
            return loss
        lr = self.schedule(self._count)
        for group in self.param_groups:
            if torch.is_tensor(lr):
                group["lr"].copy_(lr)
            else:
                group["lr"].fill_(lr)
        loss = super().step(closure)
        found_inf = getattr(self, "found_inf", None)
        self._count += 1 if found_inf is None else (1 - found_inf).to(self._count)
        return loss

    def state_dict(self):
        return {**super().state_dict(), "count": self.count}

    def load_state_dict(self, state_dict):
        state_dict = dict(state_dict)
        self.count = int(state_dict.pop("count", 0))
        lrs = [group["lr"] for group in self.param_groups]
        super().load_state_dict(state_dict)
        for group, lr in zip(self.param_groups, lrs):  # a device rate stays one
            if torch.is_tensor(lr):
                group["lr"] = lr


@dataclass(frozen=True)
class AdamW:
    learning_rate: Union[float, Schedule]
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 1e-4

    def __call__(self, params: Iterable[torch.nn.Parameter],
                 skip_on_overflow: bool = False) -> ScheduledAdamW:
        """The optimizer on ``params``; with ``skip_on_overflow`` (fp16 loss
        scaling) fused on any device, with its count on the device."""
        params = list(params)
        schedule = (self.learning_rate if callable(self.learning_rate)
                    else constant_schedule(self.learning_rate))
        # On the GPU, the fused implementation: one pass over p, g, m and v
        # per parameter group, where the default (foreach) makes several.
        fused = skip_on_overflow or (bool(params) and all(p.is_cuda for p in params))
        # FSDP2's sharded parameters (DTensors) and the ones it leaves whole
        # go in groups of their own: one fused or foreach call takes one kind.
        sharded = [p for p in params if isinstance(p, DTensor)]
        whole = [p for p in params if not isinstance(p, DTensor)]
        groups = params if not (sharded and whole) else [{"params": sharded}, {"params": whole}]
        opt = ScheduledAdamW(
            groups, schedule, scheduled=callable(self.learning_rate), betas=(self.b1, self.b2),
            eps=self.eps, weight_decay=self.weight_decay, fused=fused or None)
        if skip_on_overflow:
            opt.skip_on_overflow()
        return opt


def adamw(learning_rate: Union[float, Schedule], b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 1e-4, mu_dtype: Any = None) -> AdamW:
    """optax.adamw's signature and defaults (note: weight_decay 1e-4, not
    torch's 1e-2); ``learning_rate`` is a float or a schedule. Moments stay
    fp32: a lower ``mu_dtype`` (bench.py's rung for cards under 30 GiB) is
    not ported, since torch's AdamW keeps both moments in the parameters'
    dtype."""
    if mu_dtype not in (None, torch.float32):
        raise NotImplementedError(
            f"mu_dtype={mu_dtype} is not ported yet (ROADMAP.md Queue A item 9: torch's AdamW "
            "cannot keep only the first moment in bf16 beside fp32 masters)")
    return AdamW(learning_rate, b1, b2, eps, weight_decay)


class AcceleratedOptimizer(torch.optim.Optimizer):
    """The prepared optimizer as the imperative loop drives it.

    Counterpart of ``accelerate_tpu/optimizer.py``. ``step()`` applies the
    gradients accumulated on the parameters (``Accelerator.backward``) only
    when ``GradientState.sync_gradients`` is set, through
    ``Accelerator._apply_gradients`` (the parameters the FSDP plugin leaves
    whole averaged over the processes, then the armed clip), and is a no-op
    inside an accumulation window or with no gradient to apply;
    ``zero_grad()`` is a no-op inside a window. Under fp16 loss scaling a
    step whose gradients overflowed is skipped (on the device), and
    ``step_was_skipped`` says so. ``param_groups``, ``state``,
    ``defaults``, ``state_dict`` and ``load_state_dict`` are the wrapped
    optimizer's. It does not run ``torch.optim.Optimizer.__init__``: the
    wrapped optimizer holds the parameters and the hooks."""

    def __init__(self, optimizer: torch.optim.Optimizer, accelerator=None):
        self.optimizer = optimizer
        self.gradient_state = GradientState()
        self._accelerator = accelerator
        # Whether the last step overflowed: False, or a bool device tensor
        # under fp16 loss scaling.
        self._is_overflow = False

    @property
    def state(self):
        return self.optimizer.state

    @property
    def param_groups(self):
        return self.optimizer.param_groups

    @property
    def defaults(self):
        return self.optimizer.defaults

    def state_dict(self):
        return self.optimizer.state_dict()

    def load_state_dict(self, state_dict):
        self.optimizer.load_state_dict(state_dict)

    def zero_grad(self, set_to_none: bool = True):
        if self.gradient_state.sync_gradients:
            self.optimizer.zero_grad(set_to_none=set_to_none)

    def step(self, closure=None):
        if not self.gradient_state.sync_gradients:
            return None
        if self._accelerator is None:
            raise RuntimeError("This optimizer is not bound to an Accelerator; pass it "
                               "through accelerator.prepare(...) first.")
        finite = self._accelerator._apply_gradients(self.optimizer)
        self._is_overflow = False if finite is None else ~finite
        return None

    @property
    def step_was_skipped(self) -> bool:
        """Whether the last step was skipped (fp16 overflow). Under loss
        scaling reading it waits for the card, as the JAX package's
        ``bool(finite)`` does."""
        return bool(self._is_overflow)

    def train(self):
        if hasattr(self.optimizer, "train"):
            self.optimizer.train()

    def eval(self):
        if hasattr(self.optimizer, "eval"):
            self.optimizer.eval()
