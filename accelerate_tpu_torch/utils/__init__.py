from .dataclasses import (
    DataLoaderConfiguration,
    FullyShardedDataParallelPlugin,
    GradientAccumulationPlugin,
    MixedPrecisionPolicy,
    ProjectConfiguration,
    ServingConfig,
)
from .random import set_seed

__all__ = [
    "DataLoaderConfiguration",
    "FullyShardedDataParallelPlugin",
    "GradientAccumulationPlugin",
    "MixedPrecisionPolicy",
    "ProjectConfiguration",
    "ServingConfig",
    "set_seed",
]
