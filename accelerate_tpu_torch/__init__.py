"""PyTorch/CUDA port of accelerate_tpu: the Llama training step on one
NVIDIA Hopper GPU, with hand-written CUDA kernels for flash attention.

It imports torch only, never JAX or the ``accelerate_tpu`` package, and
runs on CUDA unless the caller asks for the CPU (``Accelerator(cpu=True)``).
"""

from .accelerator import Accelerator
from .model import Model
from .optimizer import adamw
from .parallelism_config import ParallelismConfig
from .state import AcceleratorState, GradientState, PartialState
from .train_state import TrainState
from .utils import (
    FullyShardedDataParallelPlugin,
    GradientAccumulationPlugin,
    MixedPrecisionPolicy,
    ProjectConfiguration,
    set_seed,
)

__all__ = [
    "Accelerator",
    "AcceleratorState",
    "FullyShardedDataParallelPlugin",
    "GradientAccumulationPlugin",
    "GradientState",
    "MixedPrecisionPolicy",
    "Model",
    "ParallelismConfig",
    "PartialState",
    "ProjectConfiguration",
    "TrainState",
    "adamw",
    "set_seed",
]
