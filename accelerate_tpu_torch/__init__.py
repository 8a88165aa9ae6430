"""PyTorch/CUDA port of accelerate_tpu: the Llama training step on one
NVIDIA Hopper GPU, with hand-written CUDA kernels for flash attention, and
KV-cache generation and continuous-batching serving for Llama.

It imports torch only, never JAX or the ``accelerate_tpu`` package, and
runs on CUDA unless the caller asks for the CPU (``Accelerator(cpu=True)``).
"""

from .accelerator import Accelerator
from .generation import GenerationConfig, generate
from .model import Model
from .optimizer import adamw
from .parallelism_config import ParallelismConfig
from .serving import ServingEngine
from .state import AcceleratorState, GradientState, PartialState
from .train_state import TrainState
from .utils import (
    FullyShardedDataParallelPlugin,
    GradientAccumulationPlugin,
    MixedPrecisionPolicy,
    ProjectConfiguration,
    ServingConfig,
    set_seed,
)
from .utils.quantization import quantize_model_for_decode

__all__ = [
    "Accelerator",
    "AcceleratorState",
    "FullyShardedDataParallelPlugin",
    "GenerationConfig",
    "GradientAccumulationPlugin",
    "GradientState",
    "MixedPrecisionPolicy",
    "Model",
    "ParallelismConfig",
    "PartialState",
    "ProjectConfiguration",
    "ServingConfig",
    "ServingEngine",
    "TrainState",
    "adamw",
    "generate",
    "quantize_model_for_decode",
    "set_seed",
]
