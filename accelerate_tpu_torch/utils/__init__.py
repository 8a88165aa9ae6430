from .dataclasses import (
    DataLoaderConfiguration,
    FullyShardedDataParallelPlugin,
    GradientAccumulationPlugin,
    MixedPrecisionPolicy,
    ProjectConfiguration,
    ServingConfig,
)
from .memory import (
    clear_device_cache,
    find_executable_batch_size,
    get_device_memory_stats,
    release_memory,
    should_reduce_batch_size,
)
from .random import set_seed

__all__ = [
    "DataLoaderConfiguration",
    "FullyShardedDataParallelPlugin",
    "GradientAccumulationPlugin",
    "MixedPrecisionPolicy",
    "ProjectConfiguration",
    "ServingConfig",
    "clear_device_cache",
    "find_executable_batch_size",
    "get_device_memory_stats",
    "release_memory",
    "set_seed",
    "should_reduce_batch_size",
]
