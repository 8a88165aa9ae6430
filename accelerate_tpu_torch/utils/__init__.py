from .dataclasses import (
    FullyShardedDataParallelPlugin,
    GradientAccumulationPlugin,
    MixedPrecisionPolicy,
    ProjectConfiguration,
)
from .random import set_seed

__all__ = [
    "FullyShardedDataParallelPlugin",
    "GradientAccumulationPlugin",
    "MixedPrecisionPolicy",
    "ProjectConfiguration",
    "set_seed",
]
