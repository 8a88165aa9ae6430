"""Sharded, seeded, resumable data loading.

Counterpart of ``accelerate_tpu/data_loader.py``. Which process reads which
sample is pure Python and is the JAX package's, index for index:
``SeedableRandomSampler`` draws ``np.random.default_rng(seed + epoch)``
permutations, ``BatchSamplerShard`` deals whole batches round-robin (or
splits each batch, ``split_batches``) and cycles samples from the start so
every process gets as many batches (``even_batches``), and
``IterableDatasetShard`` does the same for a stream.

The device side is PyTorch's. A batch is collated on the host (numpy,
large uniform items through the native library), turned into torch
tensors, and copied to the loader's device. On a CUDA device each batch
gets its own pinned host buffer and the copy is issued with
``non_blocking=True``: the caching host allocator keeps a pinned block
until the copy that reads it has completed, so a buffer is never refilled
under a running copy. Collation and pinning run ahead on a prefetch thread
(``prefetch_size`` batches); the copy is issued by the thread that iterates
the loader, on its current stream, which is the stream the train step runs
on.

Iteration looks one batch ahead, so ``end_of_dataloader`` is set while the
last batch is out and ``GradientState`` can see it. ``state_dict()`` holds
``{"batches_yielded", "sampler"}`` as plain values, in the JAX package's
form, so either package resumes the other's ``sampler.bin`` mid-epoch:
``load_state_dict`` arms the next iteration to skip the batches already
taken, at the sampler (no skipped batch is collated).

Dispatch mode (``DataLoaderDispatcher``): process 0 reads, and sends the
batches to every process in grouped broadcasts (``dispatch_group_size``
batches, or 1 MiB, to a broadcast), each process keeping its slice.

Over a ``cp`` or ``sp`` axis the samples are dealt over the data-parallel
processes only (``num_processes``/``process_index`` are the data-parallel
size and position, which ``Accelerator.prepare_data_loader`` passes), so
processes that differ only in ``cp``/``sp`` read the same rows; each
keeps its slice of the sequence dim (``sequence_shard``, cut by
``parallel.sharding.sequence_slice`` before the copy to the device).
"""

from __future__ import annotations

import copy
import itertools
import math
import os
import queue
import random as _pyrandom
import threading
import time
from typing import Any, Iterable, Iterator, Optional

import numpy as np
import torch

from . import native
from .parallel.sharding import sequence_slice
from .state import GradientState, PartialState
from .utils.operations import (
    broadcast_object_list,
    concatenate,
    find_batch_size,
    pad_input_tensors,
    recursively_apply,
    slice_tensors,
)
from .utils.random import synchronize_rng_states


class SeedableRandomSampler:
    """Shuffles with ``np.random.default_rng(seed + epoch)`` and moves to the
    next epoch when a pass ends."""

    def __init__(self, data_source_len: int, seed: int = 0, epoch: int = 0):
        self.data_source_len = data_source_len
        self.seed = seed
        self.epoch = epoch

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self):
        return self.data_source_len

    def __iter__(self) -> Iterator[int]:
        rng = np.random.default_rng(self.seed + self.epoch)
        yield from rng.permutation(self.data_source_len).tolist()
        self.epoch += 1

    def state_dict(self):
        return {"seed": self.seed, "epoch": self.epoch}

    def load_state_dict(self, state):
        self.seed = state["seed"]
        self.epoch = state["epoch"]


class SequentialSampler:
    def __init__(self, data_source_len: int):
        self.data_source_len = data_source_len

    def __len__(self):
        return self.data_source_len

    def __iter__(self):
        return iter(range(self.data_source_len))


class BatchSampler:
    """Groups sampler indices into lists of ``batch_size``."""

    def __init__(self, sampler, batch_size: int, drop_last: bool = False):
        self.sampler = sampler
        self.batch_size = batch_size
        self.drop_last = drop_last

    def __iter__(self):
        batch = []
        for idx in self.sampler:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        n = len(self.sampler)
        return n // self.batch_size if self.drop_last else math.ceil(n / self.batch_size)


class BatchSamplerShard:
    """This process's share of a batch sampler's batches.

    With ``split_batches`` every batch is cut into ``num_processes`` equal
    slices; otherwise whole batches go round-robin. ``even_batches`` fills a
    short last round with samples cycled from the first batches, so every
    process yields as many full batches (processes without a real batch
    take distinct chunks)."""

    def __init__(self, batch_sampler, num_processes: int = 1, process_index: int = 0,
                 split_batches: bool = False, even_batches: bool = True):
        if split_batches and getattr(batch_sampler, "batch_size", 0) % num_processes != 0:
            raise ValueError(
                f"batch_size {batch_sampler.batch_size} must be divisible by "
                f"num_processes {num_processes} with split_batches=True")
        self.batch_sampler = batch_sampler
        self.num_processes = num_processes
        self.process_index = process_index
        self.split_batches = split_batches
        self.even_batches = even_batches
        self.batch_size = getattr(batch_sampler, "batch_size", None)
        self.drop_last = getattr(batch_sampler, "drop_last", False)

    @property
    def total_length(self):
        return len(self.batch_sampler)

    def __len__(self):
        n = len(self.batch_sampler)
        if self.split_batches:
            return n
        if n % self.num_processes == 0:
            return n // self.num_processes
        length = n // self.num_processes
        if self.drop_last:
            return length
        if not self.even_batches and self.process_index >= n % self.num_processes:
            return length
        return length + 1

    def __iter__(self):
        yield from self._iter_with_split() if self.split_batches else self._iter_with_shard()

    def _iter_with_split(self):
        initial_data = []
        batch_length = self.batch_sampler.batch_size // self.num_processes
        lo, hi = batch_length * self.process_index, batch_length * (self.process_index + 1)
        last_batch = None
        for idx, batch in enumerate(self.batch_sampler):
            if idx == 0:
                initial_data = batch
            last_batch = batch
            if len(batch) == self.batch_size:
                yield batch[lo:hi]
        if not self.drop_last and last_batch is not None and len(last_batch) < self.batch_size:
            if self.even_batches:
                while len(initial_data) < self.batch_size:
                    initial_data += initial_data
                yield (last_batch + initial_data)[: self.batch_size][lo:hi]
            elif lo < len(last_batch):
                yield last_batch[lo:hi]

    def _iter_with_shard(self):
        initial_data = []
        batch_to_yield = []
        last_yielded = False
        idx = -1
        for idx, batch in enumerate(self.batch_sampler):
            if not self.drop_last and idx < self.num_processes:
                initial_data += batch
            if idx % self.num_processes == self.process_index:
                batch_to_yield = batch
            if idx % self.num_processes == self.num_processes - 1 and (
                    self.batch_size is None or len(batch) == self.batch_size):
                yield batch_to_yield
                last_yielded = True
                batch_to_yield = []
            else:
                last_yielded = False
        if self.drop_last or last_yielded and not batch_to_yield:
            return
        if not self.even_batches:
            if batch_to_yield:
                yield batch_to_yield
            return
        if initial_data:
            target = self.batch_size or max(len(batch_to_yield), 1)
            while len(initial_data) < self.num_processes * target:
                initial_data += initial_data
            if batch_to_yield:
                yield (batch_to_yield + initial_data)[:target]
            else:
                # The processes holding real batches are the first
                # (idx + 1) % P ranks of the last round; the others take
                # consecutive chunks of the cycled start.
                fill_rank = self.process_index - (idx + 1) % self.num_processes
                start = (fill_rank * target) % len(initial_data)
                yield list(itertools.islice(itertools.cycle(initial_data), start, start + target))


class IterableDatasetShard:
    """This process's chunk of each window of ``batch_size * num_processes``
    elements of a stream (``batch_size`` with ``split_batches``); a short
    last window is filled from the first (or from itself) unless
    ``drop_last``."""

    def __init__(self, dataset: Iterable, batch_size: int = 1, drop_last: bool = False,
                 num_processes: int = 1, process_index: int = 0, split_batches: bool = False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.drop_last = drop_last
        self.num_processes = num_processes
        self.process_index = process_index
        self.split_batches = split_batches
        self.epoch = 0

    def set_epoch(self, epoch):
        self.epoch = epoch
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)

    @property
    def _window(self) -> int:
        return self.batch_size if self.split_batches else self.batch_size * self.num_processes

    def _my_chunk(self, window: list) -> list:
        chunk = self._window // self.num_processes
        return window[self.process_index * chunk:(self.process_index + 1) * chunk]

    def __iter__(self):
        window: list = []
        pad_source: list = []
        for element in self.dataset:
            window.append(element)
            if len(window) == self._window:
                yield from self._my_chunk(window)
                pad_source = pad_source or list(window)
                window = []
        if window and not self.drop_last:
            pad_source = pad_source or list(window)
            while len(window) < self._window:
                window.extend(pad_source[: self._window - len(window)])
            yield from self._my_chunk(window)


def default_collate(samples: list) -> Any:
    """Stack samples into a batch: dicts, tuples and lists by field, numpy
    items through ``native.stack_items``, torch tensors with
    ``torch.stack``, scalars into a numpy array."""
    first = samples[0]
    if torch.is_tensor(first):
        return torch.stack(samples)
    if isinstance(first, dict):
        return {k: default_collate([s[k] for s in samples]) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(default_collate([s[i] for s in samples]) for i in range(len(first)))
    if isinstance(first, np.ndarray) and first.ndim > 0:
        return native.stack_items(samples)
    return np.asarray(samples)


class ColumnDataset:
    """A dict-of-arrays dataset whose batches are gathered in one native call
    (``native.gather_columns``); ``dataset[i]`` is still a dict per item."""

    def __init__(self, **columns: np.ndarray):
        if not columns:
            raise ValueError("ColumnDataset needs at least one column")
        lengths = {k: len(v) for k, v in columns.items()}
        if len(set(lengths.values())) != 1:
            raise ValueError(f"Column lengths differ: {lengths}")
        self.columns = {k: np.asarray(v) for k, v in columns.items()}
        self._length = next(iter(lengths.values()))

    def __len__(self):
        return self._length

    def __getitem__(self, i):
        return {k: v[i] for k, v in self.columns.items()}

    def gather_batch(self, indices) -> dict[str, np.ndarray]:
        return native.gather_columns(self.columns, indices)


class _PrefetchIterator:
    """Runs a source iterator on a daemon thread, at most ``prefetch_size``
    items ahead; an exception in the source is raised to the consumer."""

    _SENTINEL = object()

    def __init__(self, source, prefetch_size: int = 2):
        self._queue = queue.Queue(maxsize=max(1, prefetch_size))
        self._stop = threading.Event()
        self._error = None

        def put(item) -> bool:
            while not self._stop.is_set():
                try:
                    self._queue.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def fill():
            try:
                for item in source:
                    if not put(item):
                        return
            except BaseException as exc:  # raised again on the consumer side
                self._error = exc
            finally:
                put(self._SENTINEL)

        self._thread = threading.Thread(target=fill, daemon=True, name="accel-prefetch")
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        item = self._queue.get()
        if item is self._SENTINEL:
            if self._error is not None:
                raise self._error
            raise StopIteration
        return item

    def close(self):
        self._stop.set()
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5)


class BaseDataLoader:
    """Iteration with a one-batch lookahead, host-to-device placement, the
    mid-epoch state and ``GradientState`` registration."""

    def __init__(self, dataset, batch_sampler=None, collate_fn=None, device=None,
                 device_placement: bool = True, rng_types=None, non_blocking: bool = True,
                 prefetch_size: int = 2, _drop_last: bool = False,
                 sequence_shard: tuple[int, int] = (1, 0)):
        self.dataset = dataset
        self.batch_sampler = batch_sampler
        self.collate_fn = collate_fn or default_collate
        self.device_placement = device_placement
        self.device = torch.device(device) if device is not None else None
        self.rng_types = rng_types
        self.non_blocking = non_blocking
        self.prefetch_size = prefetch_size
        self.sequence_shard = tuple(sequence_shard)
        self.gradient_state = GradientState()
        self.end_of_dataloader = False
        self.remainder = -1
        self._drop_last = _drop_last
        # Batches handed out in the current epoch; a load_state_dict arms
        # _resume_skip, which the next __iter__ moves to _pending_skip for
        # _raw_batches to consume.
        self.batches_yielded = 0
        self._resume_skip = 0
        self._pending_skip = 0
        self._sampler_snapshot = None
        # Step telemetry (telemetry.py), set by Accelerator.prepare: the
        # seconds next() blocks on the next batch go to add_data_wait.
        self._telemetry = None
        # Set by Accelerator.prepare_data_loader under fault tolerance: a chaos
        # corrupt_batch fault NaN-poisons a batch at the device boundary.
        self._fault_tolerance = None

    # -- device side -----------------------------------------------------

    @property
    def _pin(self) -> bool:
        return (self.device_placement and self.non_blocking and self.device is not None
                and self.device.type == "cuda")

    def _host_batch(self, batch):
        """This process's slice of the sequence; numpy leaves → torch
        tensors, in pinned memory when the copy to the card is to run
        without waiting. Runs on the prefetch thread."""
        batch = sequence_slice(batch, *self.sequence_shard)
        if not self.device_placement:
            return batch

        def host(x):
            if isinstance(x, np.ndarray) and x.dtype.kind in "biuf":
                x = torch.from_numpy(x if x.flags.c_contiguous else np.ascontiguousarray(x))
            if torch.is_tensor(x) and self._pin and not x.is_pinned():
                x = x.pin_memory()
            return x

        return recursively_apply(host, batch)

    def _device_put_batch(self, batch):
        """Host tensors → the loader's device, on the caller's stream. A
        chaos ``corrupt_batch`` fault (``fault_tolerance.draw_batch_fault``)
        fills every floating tensor with NaN first: a real divergence through
        the step, for the sentinel to roll back."""
        ft = self._fault_tolerance
        if ft is not None and ft.draw_batch_fault() is not None:
            batch = recursively_apply(
                lambda x: torch.full_like(x, float("nan"))
                if torch.is_tensor(x) and x.is_floating_point() else x, batch)
        if not self.device_placement:
            return batch
        return recursively_apply(
            lambda x: x.to(self.device, non_blocking=self.non_blocking)
            if torch.is_tensor(x) else x, batch)

    # -- iteration protocol ----------------------------------------------

    def _raw_batches(self) -> Iterator:
        """Host batches of this process; each loader mode defines it."""
        raise NotImplementedError

    def __iter__(self):
        if self.rng_types is not None:
            synchronize_rng_states(self.rng_types)
        self.begin()
        self.end_of_dataloader = False
        self._pending_skip = self._resume_skip
        self._resume_skip = 0
        self.batches_yielded = self._pending_skip
        # The sampler state at the start of this epoch: the prefetch thread
        # and the lookahead may finish the sampler's pass (advancing its
        # epoch) while the consumer is mid-epoch, and a mid-epoch save must
        # name the epoch being consumed.
        sampler = self._stateful_sampler()
        self._sampler_snapshot = sampler.state_dict() if sampler is not None else None
        iterator = map(self._host_batch, self._raw_batches())
        if self.prefetch_size > 0:
            iterator = _PrefetchIterator(iterator, self.prefetch_size)
        tel = self._telemetry

        def _next():
            # The time this blocks is the host wait the prefetch thread did
            # not hide: input starvation.
            if tel is None:
                return next(iterator, None)
            t0 = time.perf_counter()
            try:
                return next(iterator, None)
            finally:
                tel.add_data_wait(time.perf_counter() - t0)

        try:
            current = _next()
            if current is None:
                self.batches_yielded = 0
                self._sampler_snapshot = None
                return
            while True:
                nxt = _next()
                self.batches_yielded += 1
                if nxt is None:
                    self.end_of_dataloader = True
                    yield self._device_put_batch(current)
                    # A finished epoch: the next save records the advanced
                    # sampler and no batch to skip.
                    self.batches_yielded = 0
                    self._sampler_snapshot = None
                    break
                yield self._device_put_batch(current)
                current = nxt
        finally:
            if isinstance(iterator, _PrefetchIterator):
                iterator.close()
            self.end()

    # -- mid-epoch resume -------------------------------------------------

    def _consume_skip(self) -> int:
        """How many batches this epoch's ``_raw_batches`` skips (armed by
        ``load_state_dict``); called once by each mode."""
        n, self._pending_skip = self._pending_skip, 0
        return n

    def _find_sampler(self, *methods):
        """The first object down the batch-sampler chain with ``methods``."""
        obj, seen = self.batch_sampler, set()
        while obj is not None and id(obj) not in seen:
            seen.add(id(obj))
            if all(hasattr(obj, m) for m in methods):
                return obj
            obj = getattr(obj, "sampler", None) or getattr(obj, "batch_sampler", None)
        return None

    def _stateful_sampler(self):
        return self._find_sampler("state_dict", "load_state_dict")

    def state_dict(self) -> dict:
        sd = {"batches_yielded": self.batches_yielded}
        if self._sampler_snapshot is not None:
            sd["sampler"] = self._sampler_snapshot
        else:
            sampler = self._stateful_sampler()
            if sampler is not None:
                sd["sampler"] = sampler.state_dict()
        return sd

    def load_state_dict(self, state: dict):
        self._resume_skip = int(state.get("batches_yielded", 0))
        sampler = self._stateful_sampler()
        if sampler is not None and state.get("sampler") is not None:
            sampler.load_state_dict(state["sampler"])

    def begin(self):
        """Register with ``GradientState``; a loader that pads its last
        batch (no ``drop_last``) records how many of its samples are real."""
        total_bs, total_len = self.total_batch_size, self.total_dataset_length
        if total_bs and total_len is not None and not self._drop_last:
            self.remainder = total_len % total_bs
        self.gradient_state._add_dataloader(self)

    def end(self):
        self.gradient_state._remove_dataloader(self)

    def set_epoch(self, epoch: int):
        """Set the epoch of the sampler down the batch-sampler chain, else of
        the dataset. (The JAX package looks only one level down, which
        misses the sampler under a ``BatchSamplerShard``; its seedable
        sampler then moves on by itself after each pass, so the two agree
        when epochs are set in order.)"""
        sampler = self._find_sampler("set_epoch")
        if sampler is not None:
            sampler.set_epoch(epoch)
        elif hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)

    @property
    def total_batch_size(self):
        if self.batch_sampler is None:
            return None
        if isinstance(self.batch_sampler, BatchSamplerShard):
            if self.batch_sampler.split_batches:
                return self.batch_sampler.batch_size
            return (self.batch_sampler.batch_size or 1) * self.batch_sampler.num_processes
        return getattr(self.batch_sampler, "batch_size", None)

    @property
    def total_dataset_length(self):
        try:
            return len(self.dataset)
        except TypeError:
            return None


class DataLoaderShard(BaseDataLoader):
    """The loader of one process over a sharded batch sampler."""

    def __len__(self):
        return len(self.batch_sampler)

    def _raw_batches(self):
        fast = self.collate_fn is default_collate
        sampler_it = iter(self.batch_sampler)
        for _ in range(self._consume_skip()):  # resume: indices only, no collation
            if next(sampler_it, None) is None:
                return
        for batch_indices in sampler_it:
            if fast and isinstance(self.dataset, ColumnDataset):
                yield self.dataset.gather_batch(batch_indices)
            elif fast and isinstance(self.dataset, np.ndarray) and self.dataset.ndim > 0:
                yield native.gather_rows(self.dataset, batch_indices)
            else:
                yield self.collate_fn([self.dataset[i] for i in batch_indices])


class IterableDataLoaderShard(BaseDataLoader):
    """The loader over an :class:`IterableDatasetShard`."""

    def __init__(self, dataset_shard: IterableDatasetShard, batch_size: int, **kwargs):
        super().__init__(dataset_shard, batch_sampler=None, **kwargs)
        self.batch_size = batch_size

    def _raw_batches(self):
        element_it = iter(self.dataset)
        end = object()
        for _ in range(self._consume_skip() * self.batch_size):  # resume
            if next(element_it, end) is end:
                return
        samples = []
        for element in element_it:
            samples.append(element)
            if len(samples) == self.batch_size:
                yield self.collate_fn(samples)
                samples = []
        if samples:
            yield self.collate_fn(samples)


class DataLoaderDispatcher(BaseDataLoader):
    """Process 0 reads the data and broadcasts it; each process keeps its
    slice (the JAX package's ``DataLoaderDispatcher``, batch for batch).

    Without ``split_batches`` every process gets a whole ``batch_size``
    batch: process 0 reads ``world`` sampler batches a step and
    concatenates them; with it, one sampler batch is cut into ``world``
    slices. A last batch that does not divide repeats its first samples
    (``pad_input_tensors``), which ``gather_for_metrics`` trims. A
    broadcast costs about the same for any payload up to about 1 MB, so
    process 0 reads ahead and sends ``dispatch_group_size`` batches, or 1
    MiB of them (``dispatch_group_bytes``), in one ``broadcast_object_list``;
    an ``exhausted`` flag in it ends every process's loop together. The
    broadcasts run on the thread that iterates, in the same order on every
    process, so with more than one process there is no prefetch thread."""

    def __init__(self, dataset, batch_sampler=None, split_batches: bool = False,
                 dispatch_group_size: int = 8, num_processes: Optional[int] = None,
                 process_index: Optional[int] = None, **kwargs):
        super().__init__(dataset, batch_sampler=batch_sampler, **kwargs)
        state = PartialState()
        # The processes reading distinct rows (all of them unless cp/sp
        # split the sequence) and this one's position among them.
        self.num_processes = state.num_processes if num_processes is None else num_processes
        self.process_index = state.process_index if process_index is None else process_index
        self.split_batches = split_batches
        self.dispatch_group_size = max(1, int(dispatch_group_size))
        self.dispatch_group_bytes = 1 << 20
        if PartialState().num_processes > 1:
            self.prefetch_size = 0

    @property
    def total_batch_size(self):
        bs = getattr(self.batch_sampler, "batch_size", None)
        if bs is None:
            return None
        return bs if self.split_batches else bs * self.num_processes

    def __len__(self):
        n, world = len(self.batch_sampler), self.num_processes
        return n if self.split_batches or world == 1 else math.ceil(n / world)

    def _read(self, batch_indices):
        """One collated batch with numpy leaves, for the broadcast's pickle."""
        return recursively_apply(lambda t: t.detach().cpu().numpy() if torch.is_tensor(t) else t,
                                 self.collate_fn([self.dataset[i] for i in batch_indices]))

    def _raw_batches(self):
        state = PartialState()
        world = self.num_processes
        it = iter(self.batch_sampler)
        if state.num_processes == 1:
            for _ in range(self._consume_skip()):
                if next(it, None) is None:
                    return
            for batch_indices in it:
                yield self.collate_fn([self.dataset[i] for i in batch_indices])
            return
        per_yield = 1 if self.split_batches else world
        skip = self._consume_skip()
        if state.is_main_process:
            for _ in range(skip * per_yield):
                if next(it, None) is None:
                    break
        while True:
            payload = [None, None]
            if state.is_main_process:
                batches, sizes, nbytes, exhausted = [], [], 0, False
                while len(batches) < self.dispatch_group_size:
                    parts = [self._read(ix) for ix in itertools.islice(it, per_yield)]
                    if not parts:
                        exhausted = True
                        break
                    batch = parts[0] if len(parts) == 1 else concatenate(parts)
                    batches.append(batch)
                    recursively_apply(lambda leaf: sizes.append(leaf.nbytes), batch)
                    nbytes = sum(sizes)
                    if nbytes >= self.dispatch_group_bytes:
                        break
                payload = [batches, exhausted]
            broadcast_object_list(payload, from_process=0)
            batches, exhausted = payload
            for batch in batches:
                bs = find_batch_size(batch)
                if bs % world:
                    batch = pad_input_tensors(batch, bs, world)
                    bs = find_batch_size(batch)
                shard = bs // world
                start = self.process_index * shard
                yield slice_tensors(batch, start, start + shard)
            if exhausted:
                return


def _infer_shuffle(dataloader) -> bool:
    sampler = getattr(dataloader, "sampler", None)
    return sampler is not None and "Random" in type(sampler).__name__


def prepare_data_loader(dataloader, device=None, num_processes: Optional[int] = None,
                        process_index: Optional[int] = None, split_batches: bool = False,
                        put_on_device: bool = True, rng_types=None,
                        dispatch_batches: Optional[bool] = None, even_batches: bool = True,
                        use_seedable_sampler: bool = True, data_seed: Optional[int] = None,
                        non_blocking: bool = True, prefetch_size: int = 2,
                        dispatch_group_size: int = 8,
                        sequence_shard: tuple[int, int] = (1, 0)) -> BaseDataLoader:
    """A loader of this package over a user's loader: a
    ``torch.utils.data.DataLoader`` or anything with ``.dataset`` and
    ``.batch_size`` (its ``collate_fn``, ``drop_last`` and, by the name of
    its ``sampler`` class, whether it shuffles), or a dataset. A dataset
    without ``__len__`` is a stream (:class:`IterableDatasetShard`).

    ``num_processes``/``process_index`` (the processes that read distinct
    rows, and this one's position among them) default to this process's;
    ``sequence_shard`` is (slices, this process's slice) of the sequence
    dim. The device defaults to ``PartialState().device`` and is resolved
    only when ``put_on_device``."""
    if num_processes is None or process_index is None:
        state = PartialState()
        num_processes = state.num_processes if num_processes is None else num_processes
        process_index = state.process_index if process_index is None else process_index
    if put_on_device and device is None:
        device = PartialState().device

    dataset = getattr(dataloader, "dataset", dataloader)
    batch_size = getattr(dataloader, "batch_size", None) or 1
    collate_fn = getattr(dataloader, "collate_fn", None) or default_collate
    drop_last = bool(getattr(dataloader, "drop_last", False))
    shuffle = _infer_shuffle(dataloader)
    common = dict(collate_fn=collate_fn, device=device, device_placement=put_on_device,
                  rng_types=rng_types, non_blocking=non_blocking, prefetch_size=prefetch_size,
                  _drop_last=drop_last, sequence_shard=sequence_shard)
    try:
        len(dataset)
    except TypeError:
        shard = IterableDatasetShard(dataset, batch_size=batch_size, drop_last=drop_last,
                                     num_processes=num_processes, process_index=process_index,
                                     split_batches=split_batches)
        return IterableDataLoaderShard(
            shard, batch_size=batch_size // num_processes if split_batches else batch_size,
            **common)

    if shuffle:
        if use_seedable_sampler:
            seed = data_seed if data_seed is not None else 0
        else:
            seed = int(os.environ.get("ACCELERATE_SEED", _pyrandom.randint(0, 2**31)))
        sampler = SeedableRandomSampler(len(dataset), seed=seed)
    else:
        sampler = SequentialSampler(len(dataset))
    inner = BatchSampler(sampler, batch_size=batch_size, drop_last=drop_last)
    if dispatch_batches:
        return DataLoaderDispatcher(dataset, batch_sampler=inner, split_batches=split_batches,
                                    dispatch_group_size=dispatch_group_size,
                                    num_processes=num_processes, process_index=process_index,
                                    **common)
    sharded = BatchSamplerShard(inner, num_processes=num_processes, process_index=process_index,
                                split_batches=split_batches, even_batches=even_batches)
    return DataLoaderShard(dataset, batch_sampler=sharded, **common)


class SkipBatchSampler:
    """The batches of an inner batch sampler after the first
    ``skip_batches``."""

    def __init__(self, batch_sampler, skip_batches: int = 0):
        self.batch_sampler = batch_sampler
        self.skip_batches = skip_batches

    def __iter__(self):
        for index, samples in enumerate(self.batch_sampler):
            if index >= self.skip_batches:
                yield samples

    @property
    def total_length(self):
        return len(self.batch_sampler)

    def __len__(self):
        return max(0, len(self.batch_sampler) - self.skip_batches)


class _SkipIterable:
    def __init__(self, dataloader, num_batches: int):
        self.dataloader = dataloader
        self.num_batches = num_batches

    def __iter__(self):
        return itertools.islice(iter(self.dataloader), self.num_batches, None)

    def __len__(self):
        return max(0, len(self.dataloader) - self.num_batches)


def skip_first_batches(dataloader, num_batches: int = 0):
    """A loader that starts after the first ``num_batches`` batches: this
    package's loaders skip at the batch sampler, anything else by
    iterating past them."""
    if isinstance(dataloader, BaseDataLoader) and dataloader.batch_sampler is not None:
        new_loader = copy.copy(dataloader)
        new_loader.batch_sampler = SkipBatchSampler(dataloader.batch_sampler,
                                                    skip_batches=num_batches)
        return new_loader
    return _SkipIterable(dataloader, num_batches)
