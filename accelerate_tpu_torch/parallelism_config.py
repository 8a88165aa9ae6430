"""N-D parallelism configuration and its device mesh.

Counterpart of ``accelerate_tpu/parallelism_config.py``: the same axis
names, validation, environment round trip and world-size fill. The port
runs four axes over a ``torch.distributed`` group, one process per GPU:
``dp_replicate`` (DDP, or the replicate axis of HSDP), ``dp_shard``
(FSDP2), ``cp`` (ring attention, ``parallel/cp.py``) and ``sp`` (Ulysses,
``parallel/sp.py``). ``tp``, ``pp`` and ``ep`` above 1 raise, naming
ROADMAP.md Queue A item 6.

Processes lie on the mesh in row-major order of ``MESH_AXES``, as the JAX
package lays its devices: rank ``((r_dp_replicate · dp_shard + r_dp_shard)
· cp + r_cp) · sp + r_sp``.
"""

from __future__ import annotations

import dataclasses
import os

PARALLELISM_CONFIG_PREFIX = "PARALLELISM_CONFIG_"
# The mesh's axes, outermost first (the JAX package's MESH_AXIS_ORDER
# without the unported tp).
MESH_AXES = ("dp_replicate", "dp_shard", "cp", "sp")
_UNPORTED_AXES = {
    "tp_size": "ROADMAP.md Queue A item 6 (TP)",
    "pp_size": "ROADMAP.md Queue A item 6 (PP)",
    "ep_size": "ROADMAP.md Queue A item 6 (EP)",
}


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
        if not isinstance(self.pp_virtual_stages, int) or self.pp_virtual_stages < 1:
            raise ValueError(
                f"pp_virtual_stages must be a positive int, got {self.pp_virtual_stages!r}")
        for name, item in _UNPORTED_AXES.items():
            if getattr(self, name) > 1:
                raise NotImplementedError(
                    f"{name}={getattr(self, name)}: only the data-parallel, cp and sp axes "
                    f"are ported yet ({item})")

    @property
    def dp_size(self) -> int:
        return self.dp_replicate_size * self.dp_shard_size

    @property
    def total_size(self) -> int:
        return self.dp_size * self.cp_size * self.sp_size * self.tp_size * self.pp_size

    def axis_size(self, axis: str) -> int:
        return getattr(self, f"{axis}_size")

    @property
    def fsdp_axes(self) -> tuple[str, ...]:
        """Axes FSDP2 shards the parameters over: ``dp_shard`` joined with
        ``cp``."""
        return ("dp_shard", "cp")

    @property
    def batch_axes(self) -> tuple[str, ...]:
        """Axes the batch rows are split over; ``cp`` and ``sp`` ranks share
        rows and split the sequence."""
        return ("dp_replicate", "dp_shard")

    @property
    def seq_axes(self) -> tuple[str, ...]:
        """Axes the sequence dim is split over (``cp`` or ``sp``, never both)."""
        return ("cp", "sp")

    @property
    def loss_reduce_axes(self) -> tuple[str, ...]:
        """Axes a scalar loss is averaged over. While ``tp``, ``pp`` and
        ``ep`` are not ported they span every process."""
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
        if fixed > n_processes or n_processes % fixed:
            raise ValueError(
                f"parallelism axes multiply to {fixed}, which does not divide the "
                f"{n_processes} process(es)")
        return dataclasses.replace(self, dp_shard_size=self.dp_shard_size * (n_processes // fixed))

    def build_mesh(self, device_type: str):
        """The 4-D ``DeviceMesh`` over the process group with the axes
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

        replicate = ("dp_replicate", "sp")
        ranks = torch.arange(self.total_size).reshape([self.axis_size(a) for a in MESH_AXES])
        ranks = ranks.permute([MESH_AXES.index(a) for a in replicate + self.fsdp_axes])
        return DeviceMesh(device_type, ranks.reshape(self.dp_replicate_size * self.sp_size, -1),
                          mesh_dim_names=("replicate", "shard"))
