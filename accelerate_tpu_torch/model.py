"""User-facing model bundle.

Counterpart of ``accelerate_tpu/model.py``. The JAX ``Model`` pairs an apply
function with a params tree; a torch module carries its own parameters, so
``Model(module)`` is the whole bundle. ``Model.from_flax`` has no
counterpart here (there is no flax): weights from the JAX package come over
through ``models/convert.py`` and ``load_state_dict``.

Inside a train step built by ``Accelerator.prepare_train_step`` the model
runs on its parameters cast to the compute dtype (the JAX step's
``policy.cast_for_compute(params)``); the fp32 masters receive the
gradients. The cast copies stand in for the parameters through the forward
and the backward, because a checkpointed block recomputes its forward
during the backward and must see the same tensors.

``tp_rules`` is the tensor-parallel rule table, as the JAX ``Model``
takes it (falling back to the module's own ``tp_rules``); under
``ParallelismConfig(tp_size>1)`` ``prepare`` splits the parameters it
names over ``tp`` (``parallel/sharding.py``, ``tp_plan``).

Over a process group (``parallel/fsdp.py``) the module keeps its names:
FSDP2 shards it in place (``sharded``; its mixed-precision policy makes the
compute copies, and ``ignored`` holds the parameters it leaves whole), and
DDP wraps it (``forward_module``, through which calls run).

An inference call (autograd off) runs inside ``ops.fp8.eval_mode()``.

``extra_state`` is flax's non-parameter collections of the module, as
``Model.from_flax`` splits them off: ``{"batch_stats": ...}`` of its
BatchNorm layers' running statistics (``models/layers.FlaxBatchNorm``,
ResNet's) under the flax tree's names, the buffers themselves; None
without any.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Optional

import torch
from torch import nn


class Model:
    def __init__(self, module: nn.Module, tp_rules: Optional[list] = None):
        if not isinstance(module, nn.Module):
            raise TypeError(f"Model wraps a torch.nn.Module, got {type(module).__name__}")
        self.module = module
        self.forward_module = module
        self.sharded = False
        self.ignored: dict = {}
        # The tensor-parallel rule table, [(name regex, spec)] on the flax
        # tree's names (parallel/sharding.py), else the module's own.
        self.tp_rules = list(tp_rules or getattr(module, "tp_rules", None) or [])
        # The plan prepare put the module on under tp (ParamPlacement by
        # parameter name), or None.
        self.tp_plan: Optional[dict] = None
        # Under ep, the expert stacks split over the ep slice of the mesh,
        # by parameter name (their gradients are reduced apart).
        self.expert_params: dict = {}
        # Under pp, the names of the parameters this stage shares with
        # another (a tied embedding on the first and last stages).
        self.pipeline_shared: list = []

    def parameters(self):
        return self.module.parameters()

    @property
    def extra_state(self):
        """``{"batch_stats": {path...: {"mean", "var"}}}`` of the module's
        BatchNorm buffers (the tensors themselves), or None."""
        stats: dict = {}
        for name, mod in self.module.named_modules():
            if getattr(mod, "flax_collection", None) == "batch_stats":
                *parents, leaf = name.split(".")
                node = stats
                for p in parents:
                    node = node.setdefault(p, {})
                node[leaf] = {"mean": mod.mean, "var": mod.var}
        return {"batch_stats": stats} if stats else None

    def num_parameters(self) -> int:
        return sum(p.numel() for p in self.module.parameters())

    def state_dict(self) -> dict:
        return self.module.state_dict()

    def load_state_dict(self, state_dict: dict, strict: bool = True):
        return self.module.load_state_dict(state_dict, strict=strict)

    @contextmanager
    def compute_params(self, params: dict):
        """Inside the block the module reads ``params`` (name → tensor) in
        place of its own parameters of those names."""
        slots = []
        for name, tensor in params.items():
            owner, _, attr = name.rpartition(".")
            mod = self.module.get_submodule(owner)
            slots.append((mod, attr, mod._parameters[attr]))
            mod._parameters[attr] = tensor
        try:
            yield
        finally:
            for mod, attr, original in slots:
                mod._parameters[attr] = original

    def __call__(self, *args, **kwargs):
        """The module's forward. An inference call (autograd not recording:
        under ``torch.no_grad()`` or ``torch.inference_mode()``) runs inside
        ``ops.fp8.eval_mode()``, so that fp8 projections built with
        ``use_during_eval=False`` compute in full precision, as the JAX
        package's ``Model.__call__(train=False)`` does. The train step and
        ``backward`` call it with autograd on."""
        if torch.is_grad_enabled():
            return self.forward_module(*args, **kwargs)
        from .ops.fp8 import eval_mode

        with eval_mode():
            return self.forward_module(*args, **kwargs)
