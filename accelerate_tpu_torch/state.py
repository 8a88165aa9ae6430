"""Process and device state singletons for one process on one device.

Counterpart of ``accelerate_tpu/state.py``. Each class shares one state
dict between its instances (the borg pattern), so every ``PartialState()``
in a process sees the same device. ``_reset_state()`` clears it.

Device resolution: ``cuda:0`` unless the caller asks for the CPU. Without
a CUDA device and without ``cpu=True`` the constructor raises: nothing runs
on the CPU unless it was asked for.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from .parallelism_config import ParallelismConfig
from .utils.dataclasses import GradientAccumulationPlugin

_MULTI_GPU_ITEM = "ROADMAP.md Queue A item 1 (multi-GPU FSDP2/DDP)"


class PartialState:
    """Rank and device of this process. ``PartialState()`` reads the state
    that is set up, or sets it up on the card; an explicit ``cpu`` must
    agree with the state already set up."""

    _shared_state: dict = {}

    def __init__(self, cpu: Optional[bool] = None):
        self.__dict__ = self._shared_state
        if self.initialized:
            if cpu is not None and cpu != self._cpu:
                raise ValueError(
                    f"PartialState was already set up with cpu={self._cpu}; "
                    "call PartialState._reset_state() first")
            return
        world = int(os.environ.get("WORLD_SIZE", "1"))
        if world > 1:
            raise NotImplementedError(
                f"WORLD_SIZE={world}: more than one process is {_MULTI_GPU_ITEM}")
        if cpu:
            device = torch.device("cpu")
        elif torch.cuda.is_available():
            device = torch.device("cuda", 0)
        else:
            raise RuntimeError(
                "No CUDA device is available. Pass cpu=True to run on the CPU.")
        self._cpu = bool(cpu)
        self.device = device
        self.num_processes = 1
        self.process_index = 0

    @property
    def initialized(self) -> bool:
        return "device" in self._shared_state

    @property
    def is_main_process(self) -> bool:
        return self.process_index == 0

    def wait_for_everyone(self) -> None:
        """A barrier across processes: one process has nothing to wait for."""

    @classmethod
    def _reset_state(cls):
        cls._shared_state.clear()


class AcceleratorState:
    """PartialState plus the precision and parallelism choices."""

    _shared_state: dict = {}

    def __init__(self, mixed_precision: Optional[str] = None, cpu: bool = False,
                 parallelism_config: Optional[ParallelismConfig] = None):
        self.__dict__ = self._shared_state
        # PartialState raises if it was set up with the other device.
        partial = PartialState(cpu=cpu)
        if self.initialized:
            return
        self._partial = partial
        self.mixed_precision = "no" if mixed_precision is None else mixed_precision
        self.parallelism_config = parallelism_config or ParallelismConfig()

    @property
    def initialized(self) -> bool:
        return "_partial" in self._shared_state

    @property
    def device(self) -> torch.device:
        return self._partial.device

    @classmethod
    def _reset_state(cls):
        cls._shared_state.clear()


class GradientState:
    """Gradient-accumulation bookkeeping and the data loaders being iterated.

    A loader registers itself while it is iterated (the active-loader
    stack, innermost last) and flags ``end_of_dataloader`` when the batch it
    just yielded is its last (a one-batch lookahead); ``remainder`` is the
    number of real samples in the last global batch when the loader pads
    it, else -1. ``sync_gradients`` stays True: the fused train step
    applies every optimizer step (the imperative ``accumulate`` loop that
    toggles it is ROADMAP.md Queue A item 3)."""

    _shared_state: dict = {}

    def __init__(self, gradient_accumulation_plugin: Optional[GradientAccumulationPlugin] = None):
        self.__dict__ = self._shared_state
        if "num_steps" not in self._shared_state:
            self.num_steps = 1
            self.sync_gradients = True
            self.dataloader_references = [None]
        if gradient_accumulation_plugin is not None:
            self.num_steps = gradient_accumulation_plugin.num_steps or 1

    @property
    def active_dataloader(self):
        return self.dataloader_references[-1]

    @property
    def in_dataloader(self) -> bool:
        return self.active_dataloader is not None

    @property
    def end_of_dataloader(self) -> bool:
        return self.in_dataloader and self.active_dataloader.end_of_dataloader

    @property
    def remainder(self) -> int:
        return self.active_dataloader.remainder if self.in_dataloader else -1

    def _add_dataloader(self, dataloader) -> None:
        self.dataloader_references.append(dataloader)

    def _remove_dataloader(self, dataloader) -> None:
        # A loader's iteration may end after _reset_state() cleared the stack.
        if dataloader in getattr(self, "dataloader_references", ()):
            self.dataloader_references.remove(dataloader)

    @classmethod
    def _reset_state(cls):
        cls._shared_state.clear()
