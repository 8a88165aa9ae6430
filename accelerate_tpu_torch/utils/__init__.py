from .dataclasses import (
    DataLoaderConfiguration,
    FP8RecipeKwargs,
    FullyShardedDataParallelPlugin,
    GradientAccumulationPlugin,
    GradScalerKwargs,
    KwargsHandler,
    MixedPrecisionPolicy,
    ProfileKwargs,
    ProjectConfiguration,
    ServingConfig,
    TelemetryKwargs,
)
from .memory import (
    clear_device_cache,
    find_executable_batch_size,
    get_device_memory_stats,
    live_bytes_on_device,
    release_memory,
    should_reduce_batch_size,
)
from .random import set_seed

__all__ = [
    "DataLoaderConfiguration",
    "FP8RecipeKwargs",
    "FullyShardedDataParallelPlugin",
    "GradientAccumulationPlugin",
    "GradScalerKwargs",
    "KwargsHandler",
    "MixedPrecisionPolicy",
    "ProfileKwargs",
    "ProjectConfiguration",
    "ServingConfig",
    "TelemetryKwargs",
    "clear_device_cache",
    "find_executable_batch_size",
    "get_device_memory_stats",
    "live_bytes_on_device",
    "release_memory",
    "set_seed",
    "should_reduce_batch_size",
]
