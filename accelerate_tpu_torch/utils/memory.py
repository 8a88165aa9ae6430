"""Device-memory helpers and the out-of-memory retry decorator.

Counterpart of ``accelerate_tpu/utils/memory.py``. The CUDA caching
allocator keeps freed blocks for reuse, so ``clear_device_cache`` collects
Python's garbage first (the tensors only it still holds) and then releases
the allocator's free blocks (``torch.cuda.empty_cache``). ``find_executable_batch_size``
retries a function with half the batch after an allocation failure:
``torch.OutOfMemoryError``, or the CUDA, cuBLAS and cuDNN messages of one
(``should_reduce_batch_size``).
"""

from __future__ import annotations

import functools
import gc
import inspect
from typing import Callable

import torch

# Messages of allocation failures that do not arrive as torch.OutOfMemoryError.
_OOM_MESSAGES = (
    "CUDA out of memory",
    "CUDA error: out of memory",
    "CUBLAS_STATUS_ALLOC_FAILED",
    "CUDNN_STATUS_ALLOC_FAILED",
    "cuDNN error: CUDNN_STATUS_NOT_SUPPORTED. This error may appear if you passed in a "
    "non-contiguous input.",
    "DefaultCPUAllocator: can't allocate memory",
)


def release_memory(*objects):
    """``None`` in place of each of ``objects`` (the caller rebinds its names
    to the result), then ``clear_device_cache``."""
    objects = [None for _ in objects]
    clear_device_cache(garbage_collection=True)
    return objects


def clear_device_cache(garbage_collection: bool = False) -> None:
    if garbage_collection:
        gc.collect()
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.empty_cache()


def get_device_memory_stats(device=None) -> dict:
    """``device``'s memory under the JAX package's names, from the CUDA
    caching allocator's counters (``torch.cuda.memory_stats``, read on the
    host without waiting for the card): ``bytes_in_use`` (allocated tensor
    bytes), ``peak_bytes_in_use`` (their high-water mark since the last
    ``reset_peak_memory_stats``) and ``bytes_limit`` (the card's memory).
    The current card by default; {} for the CPU, as the JAX package's CPU
    devices report none."""
    if device is not None and torch.device(device).type != "cuda":
        return {}
    if not torch.cuda.is_available():
        return {}
    raw = torch.cuda.memory_stats(device)
    return {
        "bytes_in_use": raw.get("allocated_bytes.all.current", 0),
        "peak_bytes_in_use": raw.get("allocated_bytes.all.peak", 0),
        "bytes_limit": torch.cuda.get_device_properties(device).total_memory,
    }


def live_bytes_on_device(device=None) -> int:
    """Bytes of the live tensors on ``device``: the allocator's count on a
    card (``torch.cuda.memory_allocated``), a census of the live tensors'
    storages on the CPU (each storage once), as the JAX package counts its
    live arrays where the backend reports no memory statistics."""
    device = torch.device(device) if device is not None else (
        torch.device("cuda") if torch.cuda.is_available() else torch.device("cpu"))
    if device.type == "cuda":
        return torch.cuda.memory_allocated(device)
    seen, total = set(), 0
    for obj in gc.get_objects():
        if issubclass(type(obj), torch.Tensor) and obj.device.type == device.type \
                and not obj.is_meta:
            try:
                storage = obj.untyped_storage()
                ptr, nbytes = storage.data_ptr(), storage.nbytes()
            except (RuntimeError, NotImplementedError):
                continue  # no storage: sparse, wrapper subclasses, freed ones
            if ptr not in seen:
                seen.add(ptr)
                total += nbytes
    return total


def should_reduce_batch_size(exception: Exception) -> bool:
    """Whether ``exception`` is an allocation failure that a smaller batch
    may avoid."""
    if isinstance(exception, torch.OutOfMemoryError):
        return True
    return isinstance(exception, RuntimeError) and any(
        m in str(exception) for m in _OOM_MESSAGES)


def find_executable_batch_size(function: Callable = None, starting_batch_size: int = 128,
                               reduce_batch_size_fn: Callable = None):
    """Decorator: call ``function(batch_size, *args, **kwargs)`` from
    ``starting_batch_size``, halving the batch (or ``reduce_batch_size_fn``)
    after each allocation failure until a call returns; other exceptions
    pass through. The failed call's exception and its traceback, which
    hold that call's activations, are dropped before the device cache is
    cleared and the next call runs."""
    if function is None:
        return functools.partial(find_executable_batch_size,
                                 starting_batch_size=starting_batch_size,
                                 reduce_batch_size_fn=reduce_batch_size_fn)
    if reduce_batch_size_fn is None:
        reduce_batch_size_fn = lambda bs: bs // 2  # noqa: E731

    @functools.wraps(function)
    def wrapper(*args, **kwargs):
        params = list(inspect.signature(function).parameters.keys())
        if len(params) < len(args) + 1:
            arg_str = ", ".join(f"{arg}={value}" for arg, value in zip(params[1:], args[1:]))
            raise TypeError(
                f"Batch size was passed into `{function.__name__}` as the first argument when "
                f"called. Remove this as the decorator already does so: "
                f"`{function.__name__}({arg_str})`")
        batch_size = starting_batch_size
        clear_device_cache(garbage_collection=True)
        while True:
            if batch_size == 0:
                raise RuntimeError("No executable batch size found, reached zero.")
            try:
                return function(batch_size, *args, **kwargs)
            except RuntimeError as e:  # torch.OutOfMemoryError is one
                if not should_reduce_batch_size(e):
                    raise
            # Outside the except block: the exception and its frames are gone.
            clear_device_cache(garbage_collection=True)
            batch_size = reduce_batch_size_fn(batch_size)

    return wrapper
