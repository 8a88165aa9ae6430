"""Pipeline parallelism: the GPipe and interleaved schedules over ``pp``.

Counterpart of ``accelerate_tpu/parallel/pp.py``. There the schedule is one
``shard_map`` over the ``pp`` mesh axis: a ``lax.scan`` over ticks whose
``ppermute`` hands each stage's output to the next, and ``jax.grad``
through the scan is the backward. Here every stage is a process holding
only its own layers, and the schedule is this module's own loop of
microbatches with point-to-point sends between neighbouring stages
(``dist.isend``/``dist.recv`` over the ``pp`` slice of the mesh).

Why not ``torch.distributed.pipelining``: its stages own the loss
(``ScheduleGPipe(stage, n, loss_fn)``) and run the step themselves, so a
loss function that calls ``llama_pipeline_forward`` (the JAX package's
contract: ``loss_fn(model, batch)`` around a pipelined forward, then the
step's own backward) has no place in it, and its ``scale_grads`` averages
microbatch means where the JAX loss is the whole batch's token mean. Here
the whole schedule is one autograd node (``_PipelineFn``): its forward runs
every microbatch through this stage (autograd recording each one's graph),
and its backward, reached from the loss on the last stage and from a
stand-in on the others, runs the microbatches' backwards in reverse order,
receiving each output's gradient from the next stage and sending each
input's gradient to the one before. The last stage's output is the whole
batch, so the loss over it is the JAX loss over the whole batch's logits.

- GPipe (``virtual_stages=1``): stage ``d`` holds layers ``[d·L/pp,
  (d+1)·L/pp)``; all microbatches go forward, then all backward.
- Interleaved (``virtual_stages=V``): stage ``d`` holds the V chunks
  ``v·pp + d`` of ``L/(pp·V)`` layers each, and a microbatch passes the
  ring of stages V times (the last stage's chunk ``v`` feeds stage 0's
  chunk ``v + 1``). As in the JAX package ``n_microbatches`` must equal
  ``pp`` then.

Every send is asynchronous and every receive waits, and each stage takes
its work in one order consistent with the data's dependencies (round by
round, microbatch by microbatch), so no cycle of waits can form. Over gloo
with tensors on the card each send and receive is staged through pinned
host memory (gloo's point-to-point takes host tensors); ``p2p_counters``
counts the sends, their bytes and the staged bytes. NCCL sends from the
card.

On stages other than the last, ``pipeline_apply`` and
``llama_pipeline_forward`` return a stand-in: zeros of the output's shape
(a stride-0 view, no memory) that carries the schedule's autograd node, so
that the step's ``backward()`` on any loss of it runs this stage's part of
the backward. Its values are not the output. ``cross_entropy_loss`` and
``fused_cross_entropy_loss`` take a stand-in without computing over it
(``is_stand_in``); the train step's loss metric comes from the last stage.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import os
import threading
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist

_STAND_IN = "_pp_stand_in"


class _P2PCounters:
    """Process-wide count of the schedule's sends, their payload bytes and
    the bytes staged through host memory (both ways), for the chip run's
    report; always on (three adds a send)."""

    __slots__ = ("sends", "bytes", "staged_bytes")

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.sends = self.bytes = self.staged_bytes = 0

    def snapshot(self) -> dict:
        return {"sends": self.sends, "bytes": self.bytes, "staged_bytes": self.staged_bytes}


p2p_counters = _P2PCounters()


def is_stand_in(t) -> bool:
    """Whether ``t`` is a pipeline stage's stand-in for an output that only
    the last stage holds."""
    return torch.is_tensor(t) and getattr(t, _STAND_IN, False)


def _stand_in(anchor: torch.Tensor, shape, device) -> torch.Tensor:
    """fp32 zeros of ``shape`` as a stride-0 view of the zero-dim
    ``anchor`` (the schedule's output on a stage that is not the last)."""
    out = anchor.float().to(device).expand(tuple(shape))
    setattr(out, _STAND_IN, True)
    return out


def stand_in_loss(t: torch.Tensor) -> torch.Tensor:
    """A zero loss that backpropagates into a stand-in's schedule."""
    return t[(0,) * t.dim()] * 0.0


def _resolve_virtual_stages(virtual_stages: Optional[int]) -> int:
    """Explicit argument > the set-up ``ParallelismConfig.pp_virtual_stages``
    > ``PARALLELISM_CONFIG_PP_VIRTUAL_STAGES`` > 1. The state is read
    passively (its shared dict): nothing is set up as a side effect."""
    if virtual_stages is not None:
        v = int(virtual_stages)
        if v < 1:
            raise ValueError(f"virtual_stages must be a positive int, got {virtual_stages}")
        return v
    from ..parallelism_config import PARALLELISM_CONFIG_PREFIX
    from ..state import AcceleratorState

    pc = AcceleratorState._shared_state.get("parallelism_config")
    if pc is not None:
        return int(getattr(pc, "pp_virtual_stages", 1) or 1)
    v = int(os.environ.get(f"{PARALLELISM_CONFIG_PREFIX}PP_VIRTUAL_STAGES", "1"))
    if v < 1:
        raise ValueError(f"PARALLELISM_CONFIG_PP_VIRTUAL_STAGES must be a positive int, got {v}")
    return v


def _active_mesh(mesh):
    """``mesh``, else the set-up state's (None for a state without a
    process group: one process, one stage)."""
    if mesh is not None:
        return mesh
    from ..state import AcceleratorState

    if not AcceleratorState._shared_state.get("_partial"):
        raise ValueError("pipeline_apply needs a mesh (pass mesh= or build an Accelerator).")
    return AcceleratorState().device_mesh


def _pipeline_ranks(mesh, axis_name: str) -> tuple[int, int, list]:
    """(stages, this process's stage, the global ranks of its ``axis_name``
    slice in stage order); one stage without that axis."""
    if mesh is None or axis_name not in (mesh.mesh_dim_names or ()):
        return 1, 0, [dist.get_rank() if dist.is_initialized() else 0]
    sub = mesh[axis_name] if mesh.ndim > 1 else mesh
    return sub.size(), sub.get_local_rank(), [int(r) for r in sub.mesh.flatten().tolist()]


def stage_layer_indices(n_layers: int, n_stages: int, stage: int,
                        virtual_stages: int = 1) -> list[list[int]]:
    """The global layer indices of each of ``stage``'s chunks: one
    contiguous ``L/pp`` chunk under GPipe; under interleaving the V chunks
    ``v·pp + stage`` of ``L/(pp·V)`` layers, in round order."""
    if virtual_stages == 1:
        if n_layers % n_stages:
            raise ValueError(f"layer-stack leading dim {n_layers} not divisible by "
                             f"pp={n_stages}")
    elif n_layers % (n_stages * virtual_stages):
        raise ValueError(f"layer count {n_layers} not divisible by pp*virtual_stages="
                         f"{n_stages}*{virtual_stages}")
    lc = n_layers // (n_stages * virtual_stages)
    return [list(range((v * n_stages + stage) * lc, (v * n_stages + stage + 1) * lc))
            for v in range(virtual_stages)]


class _Link:
    """One schedule's sends and receives between neighbouring stages."""

    def __init__(self, ranks: list, stage: int, device: torch.device):
        n = len(ranks)
        self.prev, self.next = ranks[(stage - 1) % n], ranks[(stage + 1) % n]
        self.device = device
        self.staged = device.type == "cuda" and dist.get_backend() == "gloo"
        self.pending: list = []

    def send(self, t: torch.Tensor, dst: int) -> None:
        t = t.detach().contiguous()
        nbytes = t.numel() * t.element_size()
        if self.staged:
            buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            buf.copy_(t)
            p2p_counters.staged_bytes += nbytes
        else:
            buf = t
        self.pending.append((dist.isend(buf, dst), buf))
        p2p_counters.sends += 1
        p2p_counters.bytes += nbytes

    def recv(self, shape, dtype, src: int) -> torch.Tensor:
        if self.staged:
            buf = torch.empty(shape, dtype=dtype, pin_memory=True)
            dist.recv(buf, src)
            p2p_counters.staged_bytes += buf.numel() * buf.element_size()
            return buf.to(self.device)
        buf = torch.empty(shape, dtype=dtype, device=self.device)
        dist.recv(buf, src)
        return buf

    def finish(self) -> None:
        for work, _ in self.pending:
            work.wait()
        self.pending.clear()


class _Schedule:
    """One pipelined call on this stage: ``chunks[v]`` is the callable of
    its v-th chunk (``h -> h``, shape and dtype kept)."""

    def __init__(self, chunks: list, ranks: list, stage: int, n_micro: int, mb_shape,
                 dtype, device, aux_fn: Optional[Callable] = None, context: tuple = ()):
        self.chunks, self.stage, self.n_stages = chunks, stage, len(ranks)
        self.n_micro, self.mb_shape, self.dtype = n_micro, tuple(mb_shape), dtype
        self.link = _Link(ranks, stage, device)
        self.ins: dict = {}
        self.outs: dict = {}
        # Tensors every chunk reads beside its input (an encoder's output, a
        # mask, a position bias): each microbatch's rows of those with the
        # batch's leading dim, the others whole. Those that take a gradient
        # get it summed over the microbatches (``context_grads``).
        self.context = context
        self.batch = mb_shape[0] * n_micro
        self.ctx_leaves: dict = {}
        self.context_grads = [torch.zeros_like(c) if _takes_grad(c) else None for c in context]
        # Chunks that return ``(h, extra)``: ``aux_fn`` turns every
        # microbatch's extras, once all have gone forward, into each one's
        # aux loss term (``aux``), which its backward takes with its output.
        self.aux_fn, self.extras, self.aux = aux_fn, {}, {}

    def _first(self, v: int) -> bool:
        return self.stage == 0 and v == 0

    def _last(self, v: int) -> bool:
        return self.stage == self.n_stages - 1 and v == len(self.chunks) - 1

    @property
    def is_last_stage(self) -> bool:
        return self.stage == self.n_stages - 1

    def _gather_context_grads(self, i: int, leaves: tuple) -> None:
        mb = self.mb_shape[0]
        for j, leaf in enumerate(leaves):
            if self.context_grads[j] is None or leaf.grad is None:
                continue
            if leaf.shape != self.context_grads[j].shape:
                self.context_grads[j][i * mb:(i + 1) * mb] += leaf.grad
            else:
                self.context_grads[j] += leaf.grad

    def _context(self, i: int, record: bool) -> tuple:
        """Microbatch ``i``'s context: row slices where the leading dim is the
        batch's; with ``record`` fresh leaves for those that take a
        gradient."""
        mb = self.mb_shape[0]
        out = []
        for c in self.context:
            if torch.is_tensor(c) and c.dim() > 0 and c.shape[0] == self.batch:
                c = c[i * mb:(i + 1) * mb]
            if record and _takes_grad(c):
                c = c.detach().requires_grad_(True)
            out.append(c)
        return tuple(out)

    def forward(self, x: Optional[torch.Tensor], record: bool) -> Optional[torch.Tensor]:
        """Every microbatch through this stage's chunks; on the last stage
        the (B, ...) output, else None. ``record`` keeps each microbatch's
        graph for ``backward``."""
        link, rows = self.link, []
        mbs = x.reshape(self.n_micro, *self.mb_shape) if self.stage == 0 else None
        for v, chunk in enumerate(self.chunks):
            for i in range(self.n_micro):
                if self._first(v):
                    h = mbs[i].detach()
                    if record:
                        h.requires_grad_(x.requires_grad)
                else:
                    h = link.recv(self.mb_shape, self.dtype, link.prev)
                    if record:
                        h.requires_grad_(True)
                with torch.set_grad_enabled(record):
                    if self.context:
                        ctx = self._context(i, record)
                        self.ctx_leaves[v, i] = ctx
                        y = chunk(h, *ctx)
                    else:
                        y = chunk(h)
                    if self.aux_fn is not None:
                        y, self.extras[v, i] = y
                if record:
                    self.ins[v, i], self.outs[v, i] = h, y
                if self._last(v):
                    rows.append(y if record else y.detach())
                else:
                    link.send(y, link.next)
        link.finish()
        if self.aux_fn is not None:
            with torch.set_grad_enabled(record):
                self.aux = self.aux_fn(self.extras)
            self.extras = {}
        return torch.cat(rows) if rows else None

    def aux_total(self, like: torch.Tensor) -> torch.Tensor:
        """This stage's aux loss: its microbatches' terms summed (detached;
        fp32 zero without terms)."""
        total = like.new_zeros((), dtype=torch.float32)
        for term in self.aux.values():
            total = total + term.detach().float()
        return total

    def backward(self, grad: Optional[torch.Tensor],
                 grad_aux: Optional[torch.Tensor] = None) -> Optional[torch.Tensor]:
        """The recorded microbatches' backwards in reverse order, each with
        its aux term's (times ``grad_aux``); returns the gradient of stage
        0's input (None elsewhere, or where the input takes none)."""
        link, gx = self.link, [None] * self.n_micro
        gmbs = (grad.reshape(self.n_micro, *self.mb_shape) if grad is not None
                and self.is_last_stage else None)
        for v in reversed(range(len(self.chunks))):
            for i in reversed(range(self.n_micro)):
                h, y = self.ins.pop((v, i)), self.outs.pop((v, i))
                gy = gmbs[i] if self._last(v) else link.recv(y.shape, y.dtype, link.next)
                term = self.aux.pop((v, i), None)
                if term is not None and grad_aux is not None and torch.is_tensor(term) \
                        and term.requires_grad:
                    torch.autograd.backward([y, term], [gy, grad_aux.to(term.dtype)])
                else:
                    torch.autograd.backward(y, gy)
                self._gather_context_grads(i, self.ctx_leaves.pop((v, i), ()))
                if self._first(v):
                    gx[i] = h.grad
                else:
                    link.send(h.grad, link.prev)
        link.finish()
        if self.stage == 0 and all(g is not None for g in gx):
            return torch.cat(gx)
        return None


def _takes_grad(t) -> bool:
    return torch.is_tensor(t) and t.is_floating_point() and t.requires_grad


class _PipelineFn(torch.autograd.Function):
    """The schedule as one autograd node: forward runs every microbatch
    (recording their graphs), backward runs theirs in reverse. ``anchor``
    (a zero-dim leaf that requires grad) makes the node's output require
    grad on every stage, so that a stage whose input takes no gradient
    still runs its backward. The second output is the stage's aux loss
    (zero without one), whose gradient reaches each microbatch's term.
    The schedule's context tensors follow as inputs and get their
    gradients summed over the microbatches."""

    @staticmethod
    def forward(ctx, schedule, x, anchor, *context):
        ctx.schedule = schedule
        with torch.enable_grad():
            out = schedule.forward(x, record=True)
        out = out if out is not None else anchor.detach().clone()
        return out, schedule.aux_total(anchor)

    @staticmethod
    def backward(ctx, grad, grad_aux):
        schedule = ctx.schedule
        ctx.schedule = None
        gx = schedule.backward(grad if schedule.is_last_stage else None, grad_aux)
        return (None, gx, None, *schedule.context_grads)


def _run_pipeline(chunks: list, x: torch.Tensor, *, mesh, axis_name: str,
                  n_microbatches: Optional[int], v_stages: int,
                  stand_in_shape=None, aux_fn: Optional[Callable] = None, context: tuple = ()):
    """``x`` (B, ...) through this stage's ``chunks`` pipelined over
    ``axis_name``: the last stage's output, or elsewhere a stand-in of
    ``stand_in_shape`` (default ``x``'s). ``x`` is read on stage 0; the
    other stages take only its shape and dtype. With ``aux_fn`` each chunk
    returns ``(h, extra)`` and the result is ``(output, this stage's aux
    loss)`` (``_Schedule``)."""
    n_stages, stage, ranks = _pipeline_ranks(mesh, axis_name)
    n_micro = int(n_microbatches or n_stages)
    if v_stages > 1 and n_micro != n_stages:
        raise ValueError(
            f"virtual_stages>1 requires n_microbatches == pp (got m={n_micro}, "
            f"pp={n_stages}); accumulate over multiple calls for bigger batches")
    batch = x.shape[0]
    if batch % n_micro:
        raise ValueError(f"batch dim {batch} not divisible by n_microbatches {n_micro}")
    mb_shape = (batch // n_micro, *x.shape[1:])
    schedule = _Schedule(chunks, ranks, stage, n_micro, mb_shape, x.dtype, x.device, aux_fn,
                         context)
    if torch.is_grad_enabled():
        anchor = torch.zeros((), dtype=x.dtype, device=x.device, requires_grad=True)
        out, aux = _PipelineFn.apply(schedule, x, anchor, *context)
    else:
        out = schedule.forward(x, record=False)
        if out is None:
            out = torch.zeros((), dtype=x.dtype, device=x.device)
        aux = schedule.aux_total(out)
    if not schedule.is_last_stage:
        out = _stand_in(out, x.shape if stand_in_shape is None else stand_in_shape, x.device)
    return (out, aux) if aux_fn is not None else out


def pipeline_apply(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor], stage_params: Any,
                   x: torch.Tensor, *, mesh=None, n_microbatches: Optional[int] = None,
                   axis_name: str = "pp", virtual_stages: Optional[int] = None) -> torch.Tensor:
    """Run ``x`` through a layer stack pipelined over the ``pp`` mesh axis.

    ``stage_fn(local_stack, h) -> h`` applies one stage's (or chunk's)
    layers to a microbatch of hidden states, keeping its shape and dtype.
    ``stage_params`` is a tensor or a tuple/list of tensors whose leading
    dim is the layer count L (every process holds the whole stack, as the
    JAX package's caller does; each stage reads its own rows, views whose
    gradients land in the whole tensors' rows). ``x`` (B, ...) is split
    into ``n_microbatches`` (default ``pp``) contiguous microbatches; stage
    0 reads it, the others its shape and dtype. ``virtual_stages``: the
    interleaving degree (default ``ParallelismConfig.pp_virtual_stages``).
    ``mesh``: a ``DeviceMesh`` with a ``pp`` dim (default the set-up
    state's).

    Returns the (B, ...) output on the last stage and a stand-in on the
    others (module docstring). Without a ``pp`` axis wider than 1,
    ``stage_fn(stage_params, x)``."""
    mesh = _active_mesh(mesh)
    n_stages, stage, _ = _pipeline_ranks(mesh, axis_name)
    if n_stages == 1:
        return stage_fn(stage_params, x)
    v_stages = _resolve_virtual_stages(virtual_stages)
    leaves = list(stage_params) if isinstance(stage_params, (tuple, list)) else [stage_params]
    n_layers = leaves[0].shape[0]
    for leaf in leaves:
        if v_stages == 1 and leaf.shape[0] % n_stages:
            raise ValueError(f"layer-stack leading dim {leaf.shape[0]} not divisible by "
                             f"pp={n_stages}")
        if v_stages > 1 and leaf.shape[0] != n_layers:
            raise ValueError(f"stage_params leaves disagree on layer count "
                             f"({leaf.shape[0]} vs {n_layers})")

    def rows(idx):
        lo, hi = idx[0], idx[-1] + 1
        if isinstance(stage_params, (tuple, list)):
            return type(stage_params)(leaf[lo:hi] for leaf in stage_params)
        return stage_params[lo:hi]

    chunks = [functools.partial(stage_fn, rows(idx))
              for idx in stage_layer_indices(n_layers, n_stages, stage, v_stages)]
    return _run_pipeline(chunks, x, mesh=mesh, axis_name=axis_name,
                         n_microbatches=n_microbatches, v_stages=v_stages)


# ---------------------------------------------------------------------------
# Pipeline stages of the decoder families: what runs before the stack on
# stage 0 (the embeddings), the blocks, what runs after it on the last
# stage (the final norm and the head); the JAX package computes those
# outside its pipeline on every device, GSPMD splitting the stacked layer
# dim of ``(layers|h)/`` leaves over ``pp``.
# ---------------------------------------------------------------------------


def _run_layers(layers: list, cos, sin, remat: bool, remat_kwargs: dict, h):
    """``h`` through ``layers`` with the module's per-layer remat."""
    from torch.utils.checkpoint import checkpoint

    for layer in layers:
        if remat and torch.is_grad_enabled():
            h = checkpoint(layer, h, cos, sin, **remat_kwargs)
        else:
            h = layer(h, cos, sin)
    return h


def _module(model):
    return getattr(model, "module", model)


@dataclasses.dataclass(frozen=True)
class StageSpec:
    """How a decoder family is cut into pipeline stages; the family keeps
    its own modules and forward, the spec names them.

    ``blocks``: the path of the block ``ModuleList``; ``layers``, ``width``:
    the config fields of the layer count and the hidden width; ``first``,
    ``last``: the submodules stage 0 and the last stage hold (a path in
    both, the tied embedding, is held by both, its gradient summed over
    the edge group); ``embed(module, ids, positions) -> h`` on stage 0;
    ``chunk(module, layers, positions, n_micro) -> h -> h`` makes a chunk's
    callable (``h -> (h, extra)`` with ``aux``); ``head(module, h) ->
    logits`` on the last stage; ``aux(module, n_micro) -> aux_fn`` makes
    ``_Schedule``'s aux function where the blocks add to an aux loss;
    ``microbatches(n_stages)`` the default microbatch count (``pp``)."""

    blocks: str
    layers: str
    width: str
    first: tuple
    last: tuple
    embed: Callable
    chunk: Callable
    head: Callable
    aux: Optional[Callable] = None
    microbatches: Callable = lambda n_stages: n_stages

    def shared(self) -> list:
        """The names of the parameters both edges hold."""
        return [f"{path}.weight" for path in self.first if path in self.last]


def _llama_spec(module) -> StageSpec:
    from ..models.llama import embed_tokens, rotary_embedding, scale_logits
    from . import tp

    cfg = module.config
    head = "model.embed_tokens" if cfg.tie_word_embeddings else "lm_head"

    def chunk(m, layers, positions, n_micro):
        cos, sin = rotary_embedding(positions, cfg.rotary_dim, cfg.rope_theta, cfg.dtype)
        return functools.partial(_run_layers, layers, cos, sin, cfg.remat,
                                 m.model._remat_kwargs)

    return StageSpec(
        blocks="model.layers", layers="num_hidden_layers", width="hidden_size",
        first=("model.embed_tokens",), last=("model.norm", head),
        embed=lambda m, ids, pos: embed_tokens(cfg, m.model.embed_tokens.weight, ids),
        chunk=chunk,
        head=lambda m, h: tp.vocab_logits(
            m.model.norm(h), m.head_weight().to(cfg.dtype),
            post=functools.partial(scale_logits, scaling=cfg.logits_scaling)))


def _mixtral_spec(module) -> StageSpec:
    """Mixtral: the Llama chassis's cut; each block also gives its part of
    the router aux loss. Routing stays the global batch's: with one process
    a stage's microbatches are the batch's rows in order, so each layer
    carries the choices of the microbatches before (``models/moe.
    MicrobatchRouting``: the slot offsets, the batch's capacity) and the
    aux terms wait for the last microbatch's choices (``frac`` is the whole
    batch's); over several processes one microbatch (the default there)
    routes over their global batch as the step without pp does."""
    from ..models.llama import embed_tokens, rotary_embedding
    from ..models.moe import Microbatch, MicrobatchRouting, microbatch_aux
    from ..utils.operations import loss_processes
    from . import tp

    cfg = module.config
    head = "model.embed_tokens" if cfg.tie_word_embeddings else "lm_head"
    routing: dict = {}

    def chunk(m, layers, positions, n_micro):
        from torch.utils.checkpoint import checkpoint

        cos, sin = rotary_embedding(positions, cfg.rotary_dim, cfg.rope_theta, cfg.dtype)
        processes = loss_processes()
        if n_micro > 1 and processes > 1:
            raise ValueError(
                f"Mixtral under pp with {processes} batch processes routes the global batch, "
                "whose slot order runs over each process's rows whole: its microbatches "
                "cannot route in that order; pass n_microbatches=1")
        if n_micro > 1:
            routing["micro"] = routing.get("micro") or MicrobatchRouting(n_micro)
        calls = iter(range(n_micro))

        def run(h):
            route = (Microbatch(next(calls), routing["micro"]) if n_micro > 1 else processes)
            extra = []
            for layer in layers:
                if cfg.remat and torch.is_grad_enabled():
                    h, a = checkpoint(layer, h, cos, sin, route, **m.model._remat_kwargs)
                else:
                    h, a = layer(h, cos, sin, route)
                extra.append((layer.moe, a))
            return h, extra

        return run

    def aux(m, n_micro):
        def aux_fn(extras):
            micro = routing.pop("micro", None)
            if micro is None:  # one microbatch: each block's aux is its term
                return {key: sum(a for _, a in parts) for key, parts in extras.items()}
            return microbatch_aux(cfg, micro, extras)

        return aux_fn

    return StageSpec(
        blocks="model.layers", layers="num_hidden_layers", width="hidden_size",
        first=("model.embed_tokens",), last=("model.norm", head),
        embed=lambda m, ids, pos: embed_tokens(cfg, m.model.embed_tokens.weight, ids),
        chunk=chunk,
        head=lambda m, h: tp.vocab_logits(m.model.norm(h), m.head_weight().to(cfg.dtype)),
        aux=aux, microbatches=lambda n_stages: 1 if loss_processes() > 1 else n_stages)


def _tied_head(weight, dtype, h):
    """fp32 logits of the head tied to ``weight``, in the type ``h`` and the
    weight rounded to ``dtype`` promote to (GPT-2's and OPT's head)."""
    from . import tp

    head = weight.to(dtype)
    dt = torch.promote_types(h.dtype, head.dtype)
    return tp.vocab_logits(h.to(dt), head.to(dt), post=lambda y: y.float())


def _gpt2_spec(module) -> StageSpec:
    import torch.nn.functional as F

    from ..models.layers import run_blocks
    from . import tp

    cfg = module.config
    return StageSpec(
        blocks="transformer.h", layers="n_layer", width="n_embd",
        first=("transformer.wte", "transformer.wpe"), last=("transformer.ln_f", "transformer.wte"),
        embed=lambda m, ids, pos: (tp.embedding(ids, m.transformer.wte.weight).to(cfg.dtype)
                                   + F.embedding(pos, m.transformer.wpe.weight).to(cfg.dtype)),
        chunk=lambda m, layers, pos, n: functools.partial(run_blocks, layers, remat=cfg.remat),
        head=lambda m, h: _tied_head(m.transformer.wte.weight, cfg.dtype,
                                     m.transformer.ln_f(h)))


def _opt_spec(module) -> StageSpec:
    import torch.nn.functional as F

    from ..models.layers import run_blocks
    from . import tp

    cfg = module.config
    return StageSpec(
        blocks="model.layers", layers="num_hidden_layers", width="hidden_size",
        first=("model.embed_tokens", "model.embed_positions"),
        last=("model.final_layer_norm", "model.embed_tokens"),
        embed=lambda m, ids, pos: (
            tp.embedding(ids, m.model.embed_tokens.weight).to(cfg.dtype)
            + F.embedding(pos + cfg.POSITION_OFFSET, m.model.embed_positions.weight).to(cfg.dtype)),
        chunk=lambda m, layers, pos, n: functools.partial(run_blocks, layers, remat=cfg.remat),
        head=lambda m, h: _tied_head(m.model.embed_tokens.weight, cfg.dtype,
                                     m.model.final_layer_norm(h)))


def _neox_spec(module) -> StageSpec:
    from ..models.layers import run_blocks
    from . import tp

    cfg = module.config

    def chunk(m, layers, positions, n_micro):
        def run(h):
            return run_blocks(layers, h, cfg.remat, positions.expand(h.shape[0], -1))

        return run

    return StageSpec(
        blocks="gpt_neox.layers", layers="num_hidden_layers", width="hidden_size",
        first=("gpt_neox.embed_in",), last=("gpt_neox.final_layer_norm", "embed_out"),
        embed=lambda m, ids, pos: tp.embedding(ids, m.gpt_neox.embed_in.weight).to(cfg.dtype),
        chunk=chunk,
        head=lambda m, h: tp.vocab_logits(
            m.gpt_neox.final_layer_norm(h).to(cfg.dtype), m.embed_out.weight.to(cfg.dtype),
            post=lambda y: y.float()))


# ---------------------------------------------------------------------------
# Pipeline stages of the encoders (BERT, ViT), the two-stack models (CLIP,
# T5, Whisper) and ResNet. The JAX package splits the layer dim of a
# stacked leaf over pp when it divides and leaves every other leaf whole on
# every stage; here each stage holds the blocks of its chunks of every
# stack whose depth divides by pp (times the virtual stages) and every
# other parameter, and the family's own forward runs on every stage: its
# stacks (``run_stack``: ``models/layers.run_blocks``, T5's ``rest``) run
# pipelined, everything else on every stage. A stack's output exists on the
# last stage only (a stand-in elsewhere), so a tensor a later stack reads
# beside its input (an encoder's output, a position bias) is broadcast from
# the last stage first (``every_stage``), its gradient summed back. The
# step counts each stage's own part of the gradient of a parameter every
# stage holds (the embeddings through stage 0's pipeline input, a context
# through the broadcast on the last stage, the heads on the last stage;
# ``stage_loss`` drops the graph of the heads elsewhere) and sums it over
# the pp group (``Accelerator._sum_shared_gradients``). Two stacks of one
# forward run their backwards in one order on every stage: the second's
# input depends on the first's output (``_After``). With no stack that
# divides (ResNet, T5-base's 11 ``rest`` blocks at pp=2) every stage runs
# the whole model and the step takes the last stage's gradient.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ReplicatedSpec:
    """``stacks(module) -> [(owner path, [child names in layer order])]``:
    the family's stacked blocks."""

    stacks: Callable


def _module_list(path: str):
    def stacks(module):
        owner = module.get_submodule(path)
        return [(path, [str(i) for i in range(len(owner))])]

    return stacks


def _t5_stacks(module):
    return [(stack, [f"block_{i}" for i in range(1, module.get_submodule(stack).n_blocks)])
            for stack in ("encoder", "decoder")]


_REPLICATED_SPECS = {
    "BertForSequenceClassification": ReplicatedSpec(_module_list("bert.layers")),
    "BertForMaskedLM": ReplicatedSpec(_module_list("bert.layers")),
    "ViTForImageClassification": ReplicatedSpec(_module_list("vit.layers")),
    "CLIPModel": ReplicatedSpec(lambda m: [*_module_list("text.layers")(m),
                                           *_module_list("vision.layers")(m)]),
    "T5ForConditionalGeneration": ReplicatedSpec(_t5_stacks),
    "WhisperForConditionalGeneration": ReplicatedSpec(
        lambda m: [*_module_list("encoder.layers")(m), *_module_list("decoder.layers")(m)]),
    "ResNet": ReplicatedSpec(lambda m: []),
}


# Module class name -> its stage spec's maker.
STAGE_SPECS: dict = {
    "LlamaForCausalLM": _llama_spec,
    "MixtralForCausalLM": _mixtral_spec,
    "GPT2LMHeadModel": _gpt2_spec,
    "OPTForCausalLM": _opt_spec,
    "GPTNeoXForCausalLM": _neox_spec,
    **{name: (lambda spec: lambda module: spec)(spec) for name, spec in _REPLICATED_SPECS.items()},
}


def stage_spec(module):
    """The stage spec of ``module``'s family: a ``StageSpec`` for the decoder
    families, a ``ReplicatedSpec`` for the others."""
    from ..models.llama import LlamaForCausalLM

    name = "LlamaForCausalLM" if isinstance(module, LlamaForCausalLM) else type(module).__name__
    if name not in STAGE_SPECS:
        raise NotImplementedError(
            f"pp of {type(module).__name__}: no stage spec (parallel/pp.STAGE_SPECS names "
            "the families it cuts)")
    return STAGE_SPECS[name](module)


class _Scope:
    """The pipelined stacks one loss function ran: their outputs (each the
    last stage's, or a stand-in)."""

    def __init__(self):
        self.outputs: list = []
        self.stand_ins: list = []


_TLS = threading.local()


@contextlib.contextmanager
def stage_scope():
    """Collect the pipelined stacks of the forwards inside (the train
    step's loss function), for ``stage_loss`` and the order of stacks."""
    prev = getattr(_TLS, "scope", None)
    _TLS.scope = scope = _Scope()
    try:
        yield scope
    finally:
        _TLS.scope = prev


def stage_loss(module, loss: torch.Tensor, scope: _Scope) -> torch.Tensor:
    """On a stage of a replicated family other than the last, the loss that
    runs only this stage's part of the backward: its stacks' stand-in
    losses, or with no pipelined stack zero (its gradients then all come
    from the last stage). ``loss`` elsewhere."""
    stage = getattr(module, "pipeline_stage", None)
    if stage is None or not getattr(module, "pipeline_replicated", False):
        return loss
    n_stages, this, _ = stage
    if this == n_stages - 1:
        return loss
    if scope.stand_ins:
        return sum(stand_in_loss(t) for t in scope.stand_ins)
    return loss * 0.0


class _FromLastStage(torch.autograd.Function):
    """``t`` as the last stage holds it, on every stage of ``group``; the
    gradient is summed over the stages onto the last one's ``t``."""

    @staticmethod
    def forward(ctx, t, group, src, is_src):
        out = t.detach().contiguous().clone()
        dist.broadcast(out, src=src, group=group)
        ctx.group, ctx.is_src = group, is_src
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return (g if ctx.is_src else torch.zeros_like(g)), None, None, None


def _every_stage(t: torch.Tensor, mesh) -> torch.Tensor:
    sub = mesh["pp"] if mesh.ndim > 1 else mesh
    n_stages, stage, ranks = sub.size(), sub.get_local_rank(), sub.mesh.flatten().tolist()
    out = _FromLastStage.apply(t, sub.get_group(), int(ranks[-1]), stage == n_stages - 1)
    out._pp_everywhere = True
    return out


def every_stage(module, t):
    """``t`` broadcast from the last stage when ``module`` is a pipeline
    stage of a replicated family with a pipelined stack (T5's encoder
    output, which the decoder's first block reads on stage 0); else ``t``."""
    if (not getattr(module, "pipeline_replicated", False) or not torch.is_tensor(t)
            or not getattr(module, "_pp_pipelined", False) or getattr(t, "_pp_everywhere", False)):
        return t
    return _every_stage(t, _active_mesh(None))


class _After(torch.autograd.Function):
    """``x`` after ``prev``: the identity on ``x`` whose backward gives
    ``prev`` a zero gradient, so that the stack reading ``x`` runs its
    backward before the one that made ``prev``, on every stage."""

    @staticmethod
    def forward(ctx, x, prev):
        ctx.prev_shape, ctx.prev_dtype = prev.shape, prev.dtype
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        return g, torch.zeros(ctx.prev_shape, dtype=ctx.prev_dtype, device=g.device)


def run_stack(owner, blocks: list, body: Callable, x: torch.Tensor, *context):
    """``body(blocks, x, *context) -> h`` with ``blocks`` the stack in
    layer order, pipelined over ``pp`` when ``keep_stage`` cut this stack
    (``owner._pp_plan``): this stage's chunks of it, the last stage's
    output, a stand-in elsewhere. The floating-point context tensors are
    the last stage's on every stage (``every_stage``)."""
    plan = getattr(owner, "_pp_plan", None)
    if plan is None:
        return body(blocks, x, *context)
    n_stages, stage, chunks_idx = plan
    mesh = _active_mesh(None)
    context = tuple(
        _every_stage(c, mesh) if torch.is_tensor(c) and c.is_floating_point()
        and not getattr(c, "_pp_everywhere", False) else c for c in context)
    scope = getattr(_TLS, "scope", None)
    if scope is not None and scope.outputs and torch.is_grad_enabled():
        x = _After.apply(x, scope.outputs[-1])
    chunks = [functools.partial(body, [blocks[i] for i in idx]) for idx in chunks_idx]
    out = _run_pipeline(chunks, x, mesh=mesh, axis_name="pp", n_microbatches=None,
                        v_stages=len(chunks_idx), context=context)
    if scope is not None:
        scope.outputs.append(out)
        if stage != n_stages - 1:
            scope.stand_ins.append(out)
    return out


def _keep_replicated(module, spec: ReplicatedSpec, n_stages: int, stage: int,
                     virtual_stages: int) -> list[str]:
    """``keep_stage`` of a replicated family: each stack whose depth divides
    by ``pp × virtual_stages`` keeps this stage's chunks' blocks (the
    others become ``nn.Identity``) and is marked for ``run_stack``; other
    stacks and every other parameter stay. Returns the names of the
    parameters every stage holds."""
    from torch import nn

    cut_prefixes = []
    pipelined = False
    for path, names in spec.stacks(module):
        owner = module.get_submodule(path)
        if not names or len(names) % (n_stages * virtual_stages):
            continue  # stays whole on every stage, as the JAX package leaves it
        chunks = stage_layer_indices(len(names), n_stages, stage, virtual_stages)
        keep = {i for idx in chunks for i in idx}
        for i, name in enumerate(names):
            if i in keep:
                cut_prefixes.append(f"{path}.{name}.")
            else:
                setattr(owner, name, nn.Identity())
        owner._pp_plan = (n_stages, stage, chunks)
        pipelined = True
    module.pipeline_stage = (n_stages, stage, virtual_stages)
    module.pipeline_replicated = True
    module._pp_pipelined = pipelined
    return [n for n, _ in module.named_parameters()
            if not any(n.startswith(pre) for pre in cut_prefixes)]


def pipeline_forward(model, input_ids: torch.Tensor, *, mesh=None,
                     n_microbatches: Optional[int] = None,
                     virtual_stages: Optional[int] = None, return_aux: bool = False):
    """Pipelined forward of a decoder family (``STAGE_SPECS``): its logits on
    the last stage (as the module's forward gives them), a stand-in of the
    logits' shape elsewhere; with ``return_aux`` (Mixtral) ``(logits, aux)``,
    the layers' router aux loss summed over the stages, on every stage
    (its gradient reaches each stage's routers). ``model`` is a ``Model``
    or the module; under ``ParallelismConfig(pp_size>1)`` ``prepare``
    leaves each stage its own layers, the embeddings on stage 0 and the
    final norm and head on the last (a tied embedding on both), and each
    stage runs only what it holds. Requires ``config.scan_layers=True``,
    as the JAX package does (its stacked layers are the stages)."""
    from ..state import current_sequence_shard

    module = _module(model)
    cfg = module.config
    spec = stage_spec(module)
    if isinstance(spec, ReplicatedSpec):
        raise ValueError(f"pipeline_forward takes the decoder families; a pipeline stage of "
                         f"{type(module).__name__} runs its own forward (run_stack)")
    if not cfg.scan_layers:
        raise ValueError("pipeline parallelism requires scan_layers=True (stacked blocks)")
    if return_aux and spec.aux is None:
        raise ValueError(f"{type(module).__name__} has no aux loss")
    mesh = _active_mesh(mesh)
    n_stages, stage, _ = _pipeline_ranks(mesh, "pp")
    if n_stages == 1:
        return module(input_ids, return_aux=True) if return_aux else module(input_ids)
    v_stages = _resolve_virtual_stages(virtual_stages)
    # Over a cp or sp axis each stage's process holds its slice of the
    # sequence (the sends carry it) at its global positions; the stage's
    # attention over the whole sequence is auto_flash_attention's ring.
    n_seq, _ = current_sequence_shard()
    if n_seq > 1 and getattr(cfg, "attention_impl", "flash") != "flash":
        raise NotImplementedError(
            f"attention_impl={cfg.attention_impl!r} under pp with a cp or sp axis: the JAX "
            "llama_pipeline_forward fails there too (the ring's shard_map inside the "
            "pipeline's finds a context mesh with pp Manual that does not match its mesh); "
            "use attention_impl='flash'")
    b, s = input_ids.shape
    from ..models.layers import sequence_positions

    positions = sequence_positions(input_ids)
    if stage == 0:
        x = spec.embed(module, input_ids, positions)
    else:
        x = torch.empty((b, s, getattr(cfg, spec.width)), dtype=cfg.dtype,
                        device=input_ids.device)
    blocks = module.get_submodule(spec.blocks)
    n_micro = int(n_microbatches or spec.microbatches(n_stages))
    chunks = [spec.chunk(module, [blocks[i] for i in idx], positions, n_micro)
              for idx in stage_layer_indices(getattr(cfg, spec.layers), n_stages, stage,
                                             v_stages)]
    aux_fn = None if spec.aux is None else spec.aux(module, n_micro)
    out = _run_pipeline(chunks, x, mesh=mesh, axis_name="pp", n_microbatches=n_micro,
                        v_stages=v_stages, stand_in_shape=(b, s, cfg.vocab_size), aux_fn=aux_fn)
    h, aux = out if aux_fn is not None else (out, None)
    logits = h if stage != n_stages - 1 else spec.head(module, h)
    if not return_aux:
        return logits
    sub = mesh["pp"] if mesh.ndim > 1 else mesh
    return logits, sum_over_stages(aux, sub.get_group())


class _SumOverStages(torch.autograd.Function):
    """The sum over the ``pp`` group; backward, the identity (each stage's
    part takes the gradient of the sum)."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.detach().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def sum_over_stages(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over the stages of ``group``, differentiable: each
    stage's own ``x`` gets the sum's gradient."""
    return _SumOverStages.apply(x, group)


def llama_pipeline_forward(model, input_ids: torch.Tensor, *, mesh=None,
                           n_microbatches: Optional[int] = None,
                           virtual_stages: Optional[int] = None) -> torch.Tensor:
    """Pipelined ``LlamaForCausalLM`` forward (``pipeline_forward``): its
    logits on the last stage (in the compute dtype, as the module's forward
    gives them), a stand-in of the logits' shape elsewhere. The JAX
    package's name; any family of ``STAGE_SPECS`` takes it."""
    return pipeline_forward(model, input_ids, mesh=mesh, n_microbatches=n_microbatches,
                            virtual_stages=virtual_stages)


def keep_stage(module, n_stages: int, stage: int, virtual_stages: int = 1) -> list[str]:
    """Leave ``module`` (a family of ``STAGE_SPECS``) only this stage's
    parameters, in place: the blocks of its chunks (``stage_layer_indices``;
    the others become parameterless ``nn.Identity``, so that names stay
    global), the spec's ``first`` submodules on stage 0 and its ``last``
    ones on the last stage (a tied embedding on both); its
    ``pipeline_stage`` is set, which makes its forward the pipelined one.
    Returns the names of the parameters that two stages hold, whose
    gradients the step sums over the edge group."""
    from torch import nn

    spec = stage_spec(module)
    if isinstance(spec, ReplicatedSpec):
        return _keep_replicated(module, spec, n_stages, stage, virtual_stages)
    cfg = module.config
    if not cfg.scan_layers:
        raise ValueError("pipeline parallelism requires scan_layers=True (stacked blocks)")
    keep = {i for idx in stage_layer_indices(getattr(cfg, spec.layers), n_stages, stage,
                                             virtual_stages) for i in idx}
    layers = module.get_submodule(spec.blocks)
    for i in range(len(layers)):
        if i not in keep:
            layers[i] = nn.Identity()
    first, last = stage == 0, stage == n_stages - 1
    held = set(spec.first if first else ()) | set(spec.last if last else ())
    for path in (*spec.first, *spec.last):
        if path not in held:
            owner, _, attr = path.rpartition(".")
            setattr(module.get_submodule(owner) if owner else module, attr, None)
    module.pipeline_stage = (n_stages, stage, virtual_stages)
    return spec.shared() if first or last else []
