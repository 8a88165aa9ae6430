"""Per-GPU memory of a training plan.

Counterpart of ``accelerate_tpu/utils/estimate_memory.py``. The number a
user needs is per GPU under a given ``ParallelismConfig``: will the 7B
model with AdamW fit at ``dp_shard=64``? It comes from the planner the
trainer uses (``parallel/sharding.plan_parameter_sharding``), so the
estimate and the run cannot drift apart:

- parameters, gradients and optimizer moments: exact bytes per GPU, leaf
  by leaf of the JAX package's flax tree (a scanned stack is one leaf), each
  leaf's bytes divided by the mesh axes its spec names, over a mesh of sizes
  without processes (``build_abstract_mesh``: estimate a 64-GPU plan on a
  laptop). The module is the port's, on the ``meta`` device: no memory;
- activations: the JAX package's closed-form model of what the remat policy
  saves per layer plus the recompute peak (approximate by nature; the
  tensor-state rows above are exact and decide most fit questions).

The rows equal the JAX function's for the same config and rules. The JAX
package prices FSDP on its own dim choice and FSDP2 shards dim 0 of each
tensor; the bytes per GPU are the same.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch

GiB = 1024 ** 3


def build_abstract_mesh(parallelism_config) -> dict:
    """The mesh's sizes by axis (``ParallelismConfig.MESH_AXES``), with no
    process behind them: what the planner reads of a mesh."""
    from ..parallel.sharding import mesh_sizes

    return mesh_sizes(parallelism_config)


def _itemsize(dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def _shard_factor(spec: tuple, sizes: dict) -> int:
    n = 1
    for entry in spec:
        if entry is None:
            continue
        for ax in entry if isinstance(entry, tuple) else (entry,):
            n *= sizes[ax]
    return n


def _leaves(shapes: dict, placements: dict) -> dict:
    """Flax leaf name → (element count over its parameters, spec, dtype)."""
    out: dict = {}
    for name, (shape, dtype) in shapes.items():
        pl = placements[name]
        count, _, _ = out.get(pl.flax_name, (0, None, None))
        out[pl.flax_name] = (count + math.prod(shape), pl.spec, dtype)
    return out


def _tree_bytes_per_chip(shapes: dict, placements: dict, sizes: dict, dtype=None) -> int:
    """Exact bytes per GPU of the parameters' tree laid out by ``placements``
    (each flax leaf's bytes over its spec's shard count, as the JAX
    package counts its sharded arrays)."""
    return sum(count * _itemsize(dtype or dt) // _shard_factor(spec, sizes)
               for count, spec, dt in _leaves(shapes, placements).values())


def replicated_large_leaves(shapes: dict, placements: dict, mesh,
                            min_bytes: int = 2 ** 20) -> list[str]:
    """Flax leaves of at least ``min_bytes`` whose spec replicates them on
    every GPU: the 'involuntary replication' check of an FSDP plan."""
    from ..parallel.sharding import mesh_sizes

    sizes = mesh_sizes(mesh)
    return [name for name, (count, spec, dt) in _leaves(shapes, placements).items()
            if count * _itemsize(dt) >= min_bytes and _shard_factor(spec, sizes) == 1]


@dataclasses.dataclass
class MemoryEstimate:
    params_gib: float
    grads_gib: float
    opt_state_gib: float
    activations_gib: float
    logits_gib: float

    @property
    def total_gib(self) -> float:
        return (self.params_gib + self.grads_gib + self.opt_state_gib
                + self.activations_gib + self.logits_gib)

    def rows(self) -> list[tuple[str, float]]:
        return [
            ("params", self.params_gib),
            ("grads", self.grads_gib),
            ("optimizer state", self.opt_state_gib),
            ("activations (model)", self.activations_gib),
            ("loss/logits (model)", self.logits_gib),
            ("total", self.total_gib),
        ]


def _decoder_dims(cfg):
    """The families' dims under their own field names (GPT-2: n_embd,
    n_head, n_layer; OPT and NeoX lack kv heads or an inner size)."""
    h = getattr(cfg, "hidden_size", None) or getattr(cfg, "n_embd")
    nh = getattr(cfg, "num_attention_heads", None) or getattr(cfg, "n_head")
    L = getattr(cfg, "num_hidden_layers", None) or getattr(cfg, "n_layer")
    nkv = getattr(cfg, "num_key_value_heads", None) or nh
    d = getattr(cfg, "head_dim", None) or h // nh
    inter = (getattr(cfg, "intermediate_size", None)
             or getattr(cfg, "n_inner", None)
             or getattr(cfg, "ffn_dim", None)
             or 4 * h)
    return h, nh, L, nkv, d, inter, cfg.vocab_size


def _activation_model(cfg, per_chip_batch: int, seq_local: int,
                      compute_bytes: int) -> tuple[int, int]:
    """(saved_bytes, logits_bytes) per GPU for a decoder, the JAX package's
    model: with ``remat`` each of the L layers saves its block input; the
    ``flash`` policy also the kernel's (out, lse), ``dots`` every
    projection's output too; the recompute peak is one block's working
    set. Without remat every layer keeps the ``dots`` footprint. The fused
    chunked loss keeps one (B, 256, V) fp32 logits slice."""
    H, nh, L, nkv, d, inter, vocab = _decoder_dims(cfg)
    B, S = per_chip_batch, seq_local
    c = compute_bytes

    carry = B * S * H * c
    flash_saved = B * S * nh * d * c + B * nh * S * 4
    dots_saved = B * S * ((nh + 2 * nkv) * d + H + 2 * inter + inter) * c
    policy = getattr(cfg, "remat_policy", "flash")
    if getattr(cfg, "remat", False):
        if policy == "minimal":
            per_layer = carry
        elif policy == "dots":
            per_layer = carry + flash_saved + dots_saved
        else:
            per_layer = carry + flash_saved
        peak = dots_saved + flash_saved
    else:
        per_layer = carry + flash_saved + dots_saved
        peak = 0
    chunk = 256  # fused_cross_entropy_loss's default
    logits = B * min(chunk, S) * vocab * 4
    return per_layer * L + peak, logits


def activation_bytes(cfg, per_chip_batch: int, seq_local: int, compute_bytes: int, *,
                     remat: Optional[bool] = None,
                     remat_policy: Optional[str] = None) -> tuple[int, int]:
    """``_activation_model`` with the remat switch and policy overridden,
    for a planner that walks the none → selective → full ladder."""
    if remat is not None or remat_policy is not None:
        cfg = dataclasses.replace(
            cfg,
            remat=cfg.remat if remat is None else remat,
            remat_policy=cfg.remat_policy if remat_policy is None else remat_policy,
        )
    return _activation_model(cfg, per_chip_batch, seq_local, compute_bytes)


def abstract_param_shapes(module: torch.nn.Module) -> dict:
    """``{parameter name: (shape, dtype)}`` of a module (build it on the
    ``meta`` device: no memory, no FLOPs)."""
    return {name: (tuple(p.shape), p.dtype) for name, p in module.named_parameters()}


def estimate_per_chip(module, cfg, parallelism_config, *, seq: int, per_chip_batch: int = 1,
                      optimizer: str = "adamw", master_dtype: Any = torch.float32,
                      moments_dtype: Any = None, fsdp_plugin=None,
                      tp_rules: Optional[list] = None) -> tuple[MemoryEstimate, dict, dict]:
    """Per-GPU memory of training ``module`` (the port's, on ``meta`` or
    anywhere) under ``parallelism_config``: ``(estimate, param_shapes,
    placements)``, the latter ``plan_parameter_sharding``'s over
    ``build_abstract_mesh`` of the config."""
    from ..parallel.sharding import plan_parameter_sharding

    sizes = build_abstract_mesh(parallelism_config)
    shapes = abstract_param_shapes(module)
    placements = plan_parameter_sharding(module, sizes, fsdp_plugin=fsdp_plugin,
                                         parallelism_config=parallelism_config,
                                         tp_rules=tp_rules)
    params_b = _tree_bytes_per_chip(shapes, placements, sizes, dtype=master_dtype)
    grads_b = params_b  # the step's gradients share the masters' specs and dtype

    moments = {"adamw": 2, "adam": 2, "sgd": 0, "momentum": 1, "lion": 1,
               "adafactor": 0}.get(optimizer, 2)
    opt_b = params_b // _itemsize(master_dtype) * _itemsize(moments_dtype or master_dtype) * moments

    pc = parallelism_config
    seq_local = seq // max(1, pc.cp_size * pc.sp_size)
    act_b, logits_b = _activation_model(cfg, per_chip_batch, seq_local,
                                        _itemsize(getattr(cfg, "dtype", torch.bfloat16)))
    est = MemoryEstimate(params_gib=params_b / GiB, grads_gib=grads_b / GiB,
                         opt_state_gib=opt_b / GiB, activations_gib=act_b / GiB,
                         logits_gib=logits_b / GiB)
    return est, shapes, placements
