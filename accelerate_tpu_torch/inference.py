"""Pipeline-parallel inference: the ``prepare_pippy`` surface.

Counterpart of ``accelerate_tpu/inference.py``. The JAX package's
pipelined forward is one compiled program whose logits are a global array
every process can address. Here each process is one stage
(``parallel/pp.py``): every rank calls the wrapped model on the same
batch, each runs its own layers (the embedding on stage 0, the final norm
and head on the last), and the logits exist on the last stage. With
``gather_output=True`` they are broadcast over the ``pp`` slice, so every
rank gets them (the reference's contract); with ``False`` the last stage
returns them and the other stages return None.

Families register a pipelined forward in ``PIPELINE_PLANS`` by module
class name; the Llama chassis and GPT-2 come built in. A plan is
``fn(model, input_ids, *, mesh, n_microbatches) -> logits`` (a stand-in on
the stages other than the last, ``parallel/pp.is_stand_in``).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist

from .model import Model
from .parallel.pp import (
    _active_mesh,
    _pipeline_ranks,
    llama_pipeline_forward,
    pipeline_forward,
)

# module class name -> fn(model, input_ids, *, mesh, n_microbatches)
PIPELINE_PLANS: dict = {}


def register_pipeline_plan(module_class_name: str, fn: Callable) -> None:
    """Register a pipelined forward for a module class (by class name)."""
    PIPELINE_PLANS[module_class_name] = fn


def pipeline_stage_layers(n_layers: int, n_stages: int) -> list[range]:
    """Which layer indices each pipeline stage owns (contiguous, balanced),
    as the JAX package reports them."""
    if n_layers % n_stages != 0:
        raise ValueError(f"n_layers {n_layers} not divisible by n_stages {n_stages}")
    per = n_layers // n_stages
    return [range(i * per, (i + 1) * per) for i in range(n_stages)]


def gpt2_pipeline_forward(model, input_ids: torch.Tensor, *, mesh=None,
                          n_microbatches: Optional[int] = None) -> torch.Tensor:
    """Pipelined ``GPT2LMHeadModel`` forward: fp32 logits on the last stage
    (``wte`` + ``wpe`` on stage 0, the blocks over ``pp``, the final
    LayerNorm and the tied head on the last stage; ``parallel/pp.
    pipeline_forward``)."""
    return pipeline_forward(model, input_ids, mesh=mesh, n_microbatches=n_microbatches)


def _llama_plan(model, input_ids, *, mesh, n_microbatches):
    return llama_pipeline_forward(model, input_ids, mesh=mesh, n_microbatches=n_microbatches)


PIPELINE_PLANS["LlamaForCausalLM"] = _llama_plan
PIPELINE_PLANS["GPT2LMHeadModel"] = gpt2_pipeline_forward


class PipelinedModel(Model):
    """A ``Model`` whose call runs its plan's pipelined forward; the
    original stays available as ``.inner`` (the reference keeps it on
    ``__wrapped__``)."""

    def __init__(self, inner: Model, plan: Callable, mesh, num_chunks: int,
                 gather_output: bool):
        super().__init__(inner.module, tp_rules=inner.tp_rules)
        self.inner = inner
        self._plan = plan
        self._pp_mesh = mesh
        self._num_chunks = num_chunks
        self._gather_output = gather_output

    def __call__(self, input_ids, **kwargs):
        """Logits of ``input_ids`` (B, S) on the last stage, or on every
        rank with ``gather_output``; None on the other stages without it.
        A batch that does not divide into ``num_chunks`` is padded by
        repeating its last row, and the padding is sliced off."""
        batch = input_ids.shape[0]
        padded = -batch % self._num_chunks
        if padded:
            pad = input_ids[-1:].expand(padded, *input_ids.shape[1:])
            input_ids = torch.cat([input_ids, pad], dim=0)
        out = self._plan(self.inner, input_ids, mesh=self._pp_mesh,
                         n_microbatches=self._num_chunks, **kwargs)
        n_stages, stage, ranks = _pipeline_ranks(self._pp_mesh, "pp")
        last = stage == n_stages - 1
        if n_stages > 1 and self._gather_output:
            shape, dtype = (input_ids.shape[0], *out.shape[1:]), out.dtype
            buf = out.contiguous() if last else torch.empty(shape, dtype=dtype,
                                                            device=out.device)
            group = (self._pp_mesh["pp"] if self._pp_mesh.ndim > 1 else self._pp_mesh).get_group()
            # gloo broadcasts host tensors: a card tensor goes through the host.
            wire = buf.cpu() if buf.is_cuda and dist.get_backend() == "gloo" else buf
            dist.broadcast(wire, src=ranks[-1], group=group)
            out = buf.copy_(wire) if wire is not buf else buf
        elif n_stages > 1 and not last:
            return None
        return out[:batch]


def prepare_pippy(model: Model, *, num_chunks: Optional[int] = None,
                  gather_output: bool = False, mesh=None,
                  forward_fn: Optional[Callable] = None) -> PipelinedModel:
    """Wrap ``model`` for pipeline-parallel inference over the ``pp`` axis
    of ``mesh`` (default the set-up state's). ``num_chunks`` (the
    microbatches) defaults to the ``pp`` degree, as the reference's one
    chunk per process. The arguments that drive the reference's FX tracing
    (example inputs, split points) have no counterpart: the stages are the
    contiguous ``L/pp`` slices of the layers. ``forward_fn`` overrides the
    registered plan."""
    mesh = _active_mesh(mesh)
    n_stages, _, _ = _pipeline_ranks(mesh, "pp")
    if num_chunks is None:
        num_chunks = max(n_stages, 1)
    plan = forward_fn
    module = getattr(model, "module", None)
    if plan is None and module is not None:
        plan = PIPELINE_PLANS.get(type(module).__name__)
        if plan is None:  # FSDP2's subclass of the module's class
            plan = next((PIPELINE_PLANS[c.__name__] for c in type(module).__mro__
                         if c.__name__ in PIPELINE_PLANS), None)
    if plan is None:
        known = ", ".join(sorted(PIPELINE_PLANS))
        raise ValueError(
            f"No pipeline plan for {type(module).__name__!r}; pass forward_fn= "
            f"or register_pipeline_plan(). Built-in plans: {known}")
    if not isinstance(model, Model):
        model = Model(model)
    return PipelinedModel(model, plan, mesh, num_chunks, gather_output)
