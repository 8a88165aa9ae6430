from .dataclasses import (
    FullyShardedDataParallelPlugin,
    GradientAccumulationPlugin,
    MixedPrecisionPolicy,
    ProjectConfiguration,
    ServingConfig,
)
from .random import set_seed

__all__ = [
    "FullyShardedDataParallelPlugin",
    "GradientAccumulationPlugin",
    "MixedPrecisionPolicy",
    "ProjectConfiguration",
    "ServingConfig",
    "set_seed",
]
