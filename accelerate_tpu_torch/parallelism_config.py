"""N-D parallelism configuration and its device mesh.

Counterpart of ``accelerate_tpu/parallelism_config.py``: the same axis
names, validation, environment round trip and world-size fill. The port
runs six axes over a ``torch.distributed`` group, one process per GPU:
``pp`` (pipeline stages, ``parallel/pp.py``), ``dp_replicate`` (DDP, or
the replicate axis of HSDP), ``dp_shard`` (FSDP2), ``cp`` (ring attention,
``parallel/cp.py``), ``sp`` (Ulysses, ``parallel/sp.py``) and ``tp``
(tensor parallelism, ``parallel/sharding.py`` and ``parallel/tp.py``).
``ep`` is no axis of its own: as in the JAX package it borrows whole axes
of ``(dp_shard, sp, tp)`` (``ep_axes``), over which a Mixtral's expert
stacks are split (``models/moe.py``).

Processes lie on the mesh in row-major order of ``MESH_AXES``, as the JAX
package lays its devices (``pp`` outermost, as its ``build_mesh`` puts it
in front of ``MESH_AXIS_ORDER``; ``tp`` innermost): rank ``r_pp ·
non_pp_size + (((r_dp_replicate · dp_shard + r_dp_shard) · cp + r_cp) ·
sp + r_sp) · tp + r_tp``. At ``pp=1`` that is the rank of the other five
axes.
"""

from __future__ import annotations

import dataclasses
import math
import os

PARALLELISM_CONFIG_PREFIX = "PARALLELISM_CONFIG_"
# The mesh's axes, outermost first: pp, then the JAX package's
# MESH_AXIS_ORDER.
MESH_AXES = ("pp", "dp_replicate", "dp_shard", "cp", "sp", "tp")


class ParallelismOversubscriptionError(ValueError):
    """The axes multiply to more processes than there are: an axis must
    shrink. Its message names each axis above 1 and the variable that sets
    it, as the JAX package's does."""


@dataclasses.dataclass
class ParallelismConfig:
    dp_replicate_size: int = 1
    dp_shard_size: int = 1
    cp_size: int = 1
    sp_size: int = 1
    tp_size: int = 1
    ep_size: int = 1
    pp_size: int = 1
    cp_rotate_method: str = "alltoall"
    pp_virtual_stages: int = 1

    def __post_init__(self):
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if f.name.endswith("_size") and (not isinstance(v, int) or v < 1):
                raise ValueError(f"{f.name} must be a positive int, got {v!r}")
        if self.cp_size > 1 and self.sp_size > 1:
            raise ValueError(
                "cp_size and sp_size cannot both be >1: ring context-parallelism "
                "and Ulysses sequence-parallelism are mutually exclusive.")
        if self.cp_rotate_method not in ("alltoall", "allgather"):
            raise ValueError(
                f"cp_rotate_method must be alltoall|allgather, got {self.cp_rotate_method}")
        if self.ep_size > 1 and self.ep_size > self.dp_shard_size * self.sp_size * self.tp_size:
            raise ValueError(
                "ep_size must divide into dp_shard*sp*tp (experts are sharded over those axes); "
                f"got ep={self.ep_size}")
        if not isinstance(self.pp_virtual_stages, int) or self.pp_virtual_stages < 1:
            raise ValueError(
                f"pp_virtual_stages must be a positive int, got {self.pp_virtual_stages!r}")

    @property
    def dp_size(self) -> int:
        return self.dp_replicate_size * self.dp_shard_size

    @property
    def non_pp_size(self) -> int:
        """Processes of one pipeline stage: every axis but ``pp``."""
        return self.dp_size * self.cp_size * self.sp_size * self.tp_size

    @property
    def total_size(self) -> int:
        return self.non_pp_size * self.pp_size

    def axis_size(self, axis: str) -> int:
        return getattr(self, f"{axis}_size")

    @property
    def fsdp_axes(self) -> tuple[str, ...]:
        """Axes FSDP2 shards the parameters over: ``dp_shard`` joined with
        ``cp``."""
        return ("dp_shard", "cp")

    @property
    def batch_axes(self) -> tuple[str, ...]:
        """Axes the batch rows are split over; ``tp`` ranks see the same
        rows, ``cp`` and ``sp`` ranks share rows and split the sequence."""
        return ("dp_replicate", "dp_shard")

    @property
    def seq_axes(self) -> tuple[str, ...]:
        """Axes the sequence dim is split over (``cp`` or ``sp``, never both)."""
        return ("cp", "sp")

    @property
    def ep_axes(self) -> tuple[str, ...]:
        """Mesh axes the expert dim of MoE layers is sharded over: whole axes
        of ``(dp_shard, sp, tp)`` whose sizes multiply to ``ep_size``, the
        earlier ones preferred, as in the JAX package; empty while
        ``ep_size`` is 1."""
        if self.ep_size == 1:
            return ()
        from itertools import combinations

        candidates = [ax for ax in ("dp_shard", "sp", "tp") if self.axis_size(ax) > 1]
        for r in range(1, len(candidates) + 1):
            for combo in combinations(candidates, r):
                if math.prod(self.axis_size(ax) for ax in combo) == self.ep_size:
                    return combo
        raise ValueError(
            f"ep_size={self.ep_size} is not a product of whole mesh axes from "
            f"(dp_shard={self.dp_shard_size}, sp={self.sp_size}, tp={self.tp_size}); "
            "choose ep equal to such a product.")

    @property
    def loss_reduce_axes(self) -> tuple[str, ...]:
        """Axes a scalar loss is averaged over: every axis but ``tp``, whose
        ranks hold the same rows and compute the same loss, and ``pp``, whose
        last stage alone computes it."""
        return ("dp_replicate", "dp_shard", "cp", "sp")

    @property
    def seq_size(self) -> int:
        """How many processes split one sequence (``cp_size · sp_size``)."""
        return self.cp_size * self.sp_size

    def coordinates(self, rank: int) -> dict[str, int]:
        """The position of process ``rank`` on each of ``MESH_AXES``."""
        coords = {}
        for axis in reversed(MESH_AXES):
            rank, coords[axis] = divmod(rank, self.axis_size(axis))
        return {axis: coords[axis] for axis in MESH_AXES}

    def data_parallel_index(self, rank: int) -> int:
        """Which rows process ``rank`` reads: its position on
        ``dp_replicate × dp_shard``."""
        c = self.coordinates(rank)
        return c["dp_replicate"] * self.dp_shard_size + c["dp_shard"]

    def sequence_index(self, rank: int) -> int:
        """Which slice of the sequence process ``rank`` holds: its position
        on ``cp × sp``."""
        c = self.coordinates(rank)
        return c["cp"] * self.sp_size + c["sp"]

    @classmethod
    def from_env(cls) -> "ParallelismConfig":
        """The sizes from ``PARALLELISM_CONFIG_*``, as the launcher sets them."""
        p = PARALLELISM_CONFIG_PREFIX

        def size(axis):
            return int(os.environ.get(f"{p}{axis.upper()}_SIZE", "1"))

        return cls(dp_replicate_size=size("dp_replicate"), dp_shard_size=size("dp_shard"),
                   cp_size=size("cp"), sp_size=size("sp"), tp_size=size("tp"),
                   ep_size=size("ep"), pp_size=size("pp"),
                   cp_rotate_method=os.environ.get(f"{p}CP_ROTATE_METHOD", "alltoall"),
                   pp_virtual_stages=int(os.environ.get(f"{p}PP_VIRTUAL_STAGES", "1")))

    def to_env(self) -> dict[str, str]:
        p = PARALLELISM_CONFIG_PREFIX
        env = {f"{p}{f.name.upper()}": str(getattr(self, f.name))
               for f in dataclasses.fields(self) if f.name.endswith("_size")}
        env[f"{p}CP_ROTATE_METHOD"] = self.cp_rotate_method
        env[f"{p}PP_VIRTUAL_STAGES"] = str(self.pp_virtual_stages)
        return env

    def infer_missing_axis(self, n_processes: int) -> "ParallelismConfig":
        """Fill ``dp_shard_size`` so that the axes cover every process when
        their product falls short of it, as the JAX package fills its
        devices."""
        fixed = self.total_size
        if fixed == n_processes:
            return self
        if fixed > n_processes:
            p = PARALLELISM_CONFIG_PREFIX
            axes = [f"{ax}={self.axis_size(ax)} ({p}{ax.upper()}_SIZE)"
                    for ax in MESH_AXES if self.axis_size(ax) > 1]
            raise ParallelismOversubscriptionError(
                f"parallelism axes multiply to {fixed} but only {n_processes} process(es) "
                f"run: {', '.join(axes) or 'none >1'}. Reduce one of these axes (or launch "
                "more processes).")
        if n_processes % fixed:
            raise ValueError(
                f"parallelism axes multiply to {fixed}, which does not divide the "
                f"{n_processes} process(es)")
        return dataclasses.replace(self, dp_shard_size=self.dp_shard_size * (n_processes // fixed))

    def build_mesh(self, device_type: str):
        """The 6-D ``DeviceMesh`` over the process group with the axes
        ``MESH_AXES``, one process per device. Axes of size 1 are kept, so
        that every name resolves."""
        from torch.distributed.device_mesh import init_device_mesh

        return init_device_mesh(device_type, tuple(self.axis_size(a) for a in MESH_AXES),
                                mesh_dim_names=MESH_AXES)

    def build_data_parallel_mesh(self, device_type: str):
        """The 2-D ``DeviceMesh`` FSDP2 shards over: ``("replicate",
        "shard")`` of ``dp_replicate × sp`` by ``dp_shard × cp``. ``sp``
        ranks hold replicas (each attends to a slice of the sequence with
        whole weights); ``cp`` ranks shard the parameters as ``dp_shard``
        ranks do (``fsdp_axes``)."""
        import torch
        from torch.distributed.device_mesh import DeviceMesh

        if self.tp_size > 1 or self.pp_size > 1:
            raise ValueError("under tp or pp the data-parallel mesh is a slice of the 6-D mesh "
                             "(AcceleratorState.data_parallel_mesh)")
        replicate = ("dp_replicate", "sp")
        ranks = torch.arange(self.total_size).reshape([self.axis_size(a) for a in MESH_AXES])
        ranks = ranks.permute([MESH_AXES.index(a)
                               for a in ("pp",) + replicate + self.fsdp_axes + ("tp",)])
        return DeviceMesh(device_type, ranks.reshape(self.dp_replicate_size * self.sp_size, -1),
                          mesh_dim_names=("replicate", "shard"))
