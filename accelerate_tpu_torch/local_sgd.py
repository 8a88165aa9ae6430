"""LocalSGD: ``local_sgd_steps`` steps each process trains alone, then the
parameters averaged over the processes.

Counterpart of ``accelerate_tpu/local_sgd.py``. Inside the block the
prepared fused step trains this process alone: its loss is the mean over
its own rows, and no gradient crosses processes (DDP's reducer is silenced
with ``no_sync`` and the step averages nothing), so the replicas diverge
between boundaries. Every ``local_sgd_steps`` steps, and on leaving the
block, each parameter is averaged over the processes in fp32 (one
all-reduce of a flat buffer) and cast back to its dtype. On one process,
or with ``enabled=False``, it does nothing.

    with LocalSGD(accelerator, model, local_sgd_steps=8) as lsgd:
        for batch in loader:
            state, metrics = step(state, batch)
            state = lsgd.step(state)
"""

from __future__ import annotations

import torch
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

from .utils import operations


class LocalSGD:
    def __init__(self, accelerator, model=None, local_sgd_steps: int = 8, enabled: bool = True):
        self.accelerator = accelerator
        self.model = model
        self.local_sgd_steps = local_sgd_steps
        self.enabled = enabled and accelerator.num_processes > 1
        self.num_steps = 0
        if self.enabled:
            for st in accelerator._train_states:
                m = st.model
                if m.sharded or m.tp_plan or accelerator.parallelism_config.pp_size > 1:
                    raise NotImplementedError(
                        "LocalSGD averages whole replicas: a model sharded by FSDP2, tp or pp "
                        "is not supported, as in the reference (DDP only)")

    def __enter__(self) -> "LocalSGD":
        if self.enabled:
            self.accelerator.wait_for_everyone()
            self.accelerator._local_sgd_active = True
        return self

    def __exit__(self, exc_type, exc, tb):
        if self.enabled:
            self.accelerator._local_sgd_active = False
            if exc_type is None:
                self._sync_params()

    def step(self, state=None):
        """Call once per optimizer step; averages on every
        ``local_sgd_steps``-th. Returns the accelerator's train state (the
        step updates it in place), or ``state``."""
        self.num_steps += 1
        if self.enabled and self.num_steps % self.local_sgd_steps == 0:
            self._sync_params()
        return self.accelerator._train_states[0] if self.accelerator._train_states else state

    @torch.no_grad()
    def _sync_params(self) -> None:
        """Every prepared model's parameters averaged over the processes in
        fp32, cast back to each one's dtype."""
        n = self.accelerator.num_processes
        for st in self.accelerator._train_states:
            params = [p for p in st.model.parameters()]
            flat = _flatten_dense_tensors([p.detach().float() for p in params])
            operations.all_reduce(flat)
            flat.div_(n)
            for p, avg in zip(params, _unflatten_dense_tensors(flat, params)):
                p.copy_(avg.to(p.dtype))
