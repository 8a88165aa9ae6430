"""The Accelerator: the subset of ``accelerate_tpu/accelerator.py`` on the
training step's path.

    acc = Accelerator(mixed_precision="bf16")
    model, opt = acc.prepare(Model(LlamaForCausalLM(cfg)), adamw(3e-4, weight_decay=0.1))
    step = acc.prepare_train_step(loss_fn, max_grad_norm=1.0)   # loss_fn(model, batch)
    state = acc.train_state
    state, metrics = step(state, batch)                         # {"loss", "grad_norm"}

The step has the JAX step's semantics: the loss runs on the parameters cast
to the compute dtype, gradients land on the fp32 masters, accumulate over a
leading microbatch split (summed, then divided by the number of
microbatches), are clipped by global norm with
``factor = min(1, max_norm / (norm + 1e-6))``, and the optimizer updates the
masters. The parameters and optimizer state are updated in place (the JAX
step donates its buffers to the same effect). Metrics are device tensors:
reading them waits for the step.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from .model import Model
from .optimizer import AdamW
from .parallelism_config import ParallelismConfig
from .state import AcceleratorState, GradientState
from .train_state import TrainState
from .utils.dataclasses import (
    FullyShardedDataParallelPlugin,
    GradientAccumulationPlugin,
    MixedPrecisionPolicy,
)


def _microbatch_split(batch: dict, num_accum: int) -> list[dict]:
    """(B, ...) → num_accum microbatches of B/num_accum rows, taken as the JAX
    step takes them: reshape to (B/num_accum, num_accum, ...) and index the
    second axis, so microbatch i holds rows i, i + num_accum, ..."""
    b = next(iter(batch.values())).shape[0]
    if b % num_accum:
        raise ValueError(f"Batch dim {b} not divisible by gradient accumulation steps {num_accum}.")
    views = {k: v.reshape(b // num_accum, num_accum, *v.shape[1:]) for k, v in batch.items()}
    return [{k: v[:, i] for k, v in views.items()} for i in range(num_accum)]


class Accelerator:
    def __init__(
        self,
        mixed_precision: Optional[str] = None,
        gradient_accumulation_steps: int = 1,
        cpu: bool = False,
        parallelism_config: Optional[ParallelismConfig] = None,
        fsdp_plugin: Optional[FullyShardedDataParallelPlugin] = None,
    ):
        # fsdp_plugin is accepted only at its defaults (it raises otherwise):
        # on one device FSDP has nothing to shard, and a wider mesh raises in
        # AcceleratorState.
        del fsdp_plugin
        self._mp_policy = MixedPrecisionPolicy.from_mixed_precision(mixed_precision)
        self.state = AcceleratorState(
            mixed_precision=mixed_precision, cpu=cpu, parallelism_config=parallelism_config)
        self.gradient_state = GradientState(
            GradientAccumulationPlugin(num_steps=gradient_accumulation_steps))
        self._train_states: list[TrainState] = []

    @property
    def device(self) -> torch.device:
        return self.state.device

    @property
    def train_state(self) -> TrainState:
        if not self._train_states:
            raise RuntimeError("Call accelerator.prepare(model, optimizer) first.")
        return self._train_states[0]

    def prepare(self, *args):
        """Move each ``Model`` to the device and build each optimizer on the
        parameters of the model before it. Returns the arguments in order."""
        out, model = [], None
        for obj in args:
            if isinstance(obj, Model):
                obj.module.to(self.device)
                model = obj
                out.append(obj)
            elif isinstance(obj, (AdamW, torch.optim.Optimizer)):
                if model is None:
                    raise ValueError("prepare() needs the model before its optimizer")
                opt = obj(model.parameters()) if isinstance(obj, AdamW) else obj
                self._train_states.append(TrainState(step=0, model=model, optimizer=opt))
                out.append(opt)
            else:
                raise TypeError(f"prepare() does not take {type(obj).__name__} yet")
        return out[0] if len(out) == 1 else tuple(out)

    def unwrap_model(self, model: Model) -> torch.nn.Module:
        return model.module if isinstance(model, Model) else model

    def _to_device(self, batch: dict) -> dict:
        return {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v)
                .to(self.device, non_blocking=True) for k, v in batch.items()}

    def prepare_train_step(self, loss_fn: Callable, *, max_grad_norm: Optional[float] = None):
        """``step(state, batch) -> (state, {"loss", "grad_norm"})`` around
        ``loss_fn(model, batch) -> scalar loss``."""
        if not self._train_states:
            raise RuntimeError("Call accelerator.prepare(...) first.")
        policy = self._mp_policy
        num_accum = self.gradient_state.num_steps

        def step(state: TrainState, batch: dict):
            model, opt = state.model, state.optimizer
            params = [p for p in model.parameters() if p.requires_grad]
            named = dict(model.module.named_parameters())
            microbatches = _microbatch_split(self._to_device(batch), num_accum)
            opt.zero_grad(set_to_none=True)
            loss_sum = torch.zeros((), dtype=torch.float32, device=self.device)
            for mb in microbatches:
                with model.compute_params(policy.cast_for_compute(named)):
                    loss = loss_fn(model, mb).float()
                    loss.backward()
                loss_sum += loss.detach()
            grads = [p.grad for p in params if p.grad is not None]
            if num_accum > 1:
                torch._foreach_div_(grads, num_accum)
            gnorm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
            if max_grad_norm is not None:
                factor = torch.clamp(max_grad_norm / (gnorm + 1e-6), max=1.0)
                torch._foreach_mul_(grads, factor)
            opt.step()
            state.step += 1
            return state, {"loss": loss_sum / num_accum, "grad_norm": gnorm}

        return step
