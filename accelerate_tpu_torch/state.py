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
    """Rank and device of this process."""

    _shared_state: dict = {}

    def __init__(self, cpu: bool = False):
        self.__dict__ = self._shared_state
        if self.initialized:
            if cpu != self._cpu:
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
        self._cpu = cpu
        self.device = device
        self.num_processes = 1
        self.process_index = 0

    @property
    def initialized(self) -> bool:
        return "device" in self._shared_state

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
    """Gradient-accumulation bookkeeping shared by the accelerator."""

    _shared_state: dict = {}

    def __init__(self, gradient_accumulation_plugin: Optional[GradientAccumulationPlugin] = None):
        self.__dict__ = self._shared_state
        if "num_steps" not in self._shared_state:
            self.num_steps = 1
        if gradient_accumulation_plugin is not None:
            self.num_steps = gradient_accumulation_plugin.num_steps or 1

    @classmethod
    def _reset_state(cls):
        cls._shared_state.clear()
