"""Plugin dataclasses: the subset of ``accelerate_tpu/utils/dataclasses.py``
that the training step needs, with torch dtypes.

The fields keep the JAX package's names and defaults. A field the port does
not act on yet raises ``NotImplementedError`` naming its ROADMAP.md item
when it is set away from its default, so no setting is silently ignored."""

from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Any, Optional

import torch

_MULTI_GPU_ITEM = "ROADMAP.md Queue A item 1 (multi-GPU FSDP2/DDP)"
_CHECKPOINT_ITEM = "ROADMAP.md Queue A item 4 (checkpointing)"
_DATA_LOADER_ITEM = "ROADMAP.md Queue A item 3 (data loader)"


def _refuse_non_defaults(obj, item: str, honoured: tuple = ()) -> None:
    for f in fields(obj):
        if f.name not in honoured and getattr(obj, f.name) != f.default:
            raise NotImplementedError(
                f"{type(obj).__name__}({f.name}={getattr(obj, f.name)!r}) is not "
                f"ported yet ({item})")


@dataclass
class MixedPrecisionPolicy:
    """What dtype each tensor class uses inside the train step.

    Params and optimizer state stay fp32 master copies; compute and
    activations run in ``compute_dtype``; gradients are reduced in
    ``reduce_dtype``. Only ``compute_dtype`` may be changed yet."""

    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.bfloat16
    reduce_dtype: Any = torch.float32
    output_dtype: Any = torch.float32

    def __post_init__(self):
        _refuse_non_defaults(self, "ROADMAP.md Queue A item 7 (fp8 and reduced precision)",
                             honoured=("compute_dtype",))

    @classmethod
    def from_mixed_precision(cls, mixed_precision: Optional[str]) -> "MixedPrecisionPolicy":
        if mixed_precision in (None, "no"):
            return cls(compute_dtype=torch.float32)
        if mixed_precision == "bf16":
            return cls(compute_dtype=torch.bfloat16)
        if mixed_precision in ("fp16", "fp8"):
            raise NotImplementedError(
                f"mixed_precision={mixed_precision!r} is not ported yet (fp16 needs "
                "DynamicLossScale; fp8 is ROADMAP.md Queue A item 7)")
        raise ValueError(f"Unknown mixed precision {mixed_precision}")

    def cast_for_compute(self, tensors: dict) -> dict:
        """Floating tensors cast to the compute dtype (a no-op where they
        already have it, so gradients flow to the masters)."""
        return {
            name: t.to(self.compute_dtype) if t.is_floating_point() else t
            for name, t in tensors.items()
        }


@dataclass
class GradientAccumulationPlugin:
    """``num_steps`` microbatches per optimizer step; the data-loader
    coupling of the other fields waits for the data loader."""

    num_steps: int = None
    adjust_scheduler: bool = True
    sync_with_dataloader: bool = True
    sync_each_batch: bool = False

    def __post_init__(self):
        _refuse_non_defaults(self, _DATA_LOADER_ITEM, honoured=("num_steps",))


@dataclass
class FullyShardedDataParallelPlugin:
    """Accepted at its defaults, where on one device there is nothing to
    shard and it changes nothing; any other setting is not ported yet."""

    sharding_strategy: str = "FULL_SHARD"
    reshard_after_forward: bool = True
    min_weight_size_to_shard: int = 2**11
    cpu_offload: bool = False
    state_dict_type: str = "SHARDED_STATE_DICT"
    activation_checkpointing: bool = False
    mixed_precision_policy: Optional[MixedPrecisionPolicy] = None
    ignored_params: Optional[list] = None

    def __post_init__(self):
        _refuse_non_defaults(self, _MULTI_GPU_ITEM)


@dataclass
class ProjectConfiguration:
    """Where checkpoints and logs go. The port writes neither yet, so only
    the defaults are accepted."""

    project_dir: str = None
    logging_dir: str = None
    automatic_checkpoint_naming: bool = False
    total_limit: int = None
    iteration: int = 0
    save_on_each_node: bool = False
    automatic_resume: bool = False

    def __post_init__(self):
        _refuse_non_defaults(self, _CHECKPOINT_ITEM)
