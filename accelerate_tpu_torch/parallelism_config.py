"""N-D parallelism configuration and its device mesh.

Counterpart of ``accelerate_tpu/parallelism_config.py``: the same axis
names, validation, environment round trip and world-size fill. The port
runs the data-parallel axes: ``dp_replicate`` (DDP, or the replicate axis
of HSDP) and ``dp_shard`` (FSDP2), over a ``torch.distributed`` group, one
process per GPU. ``cp`` and ``sp`` above 1 raise, naming ROADMAP.md Queue A
item 3 (ring attention and Ulysses); ``tp``, ``pp`` and ``ep`` above 1
raise, naming item 6.
"""

from __future__ import annotations

import dataclasses
import os

PARALLELISM_CONFIG_PREFIX = "PARALLELISM_CONFIG_"
_UNPORTED_AXES = {
    "cp_size": "ROADMAP.md Queue A item 3 (ring attention)",
    "sp_size": "ROADMAP.md Queue A item 3 (Ulysses)",
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
                    f"{name}={getattr(self, name)}: only the data-parallel axes are ported "
                    f"yet ({item})")

    @property
    def dp_size(self) -> int:
        return self.dp_replicate_size * self.dp_shard_size

    @property
    def total_size(self) -> int:
        return self.dp_size * self.cp_size * self.sp_size * self.tp_size * self.pp_size

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
        """The ``DeviceMesh`` over the process group with the axes
        ``("dp_replicate", "dp_shard")``, one process per device."""
        from torch.distributed.device_mesh import init_device_mesh

        return init_device_mesh(device_type, (self.dp_replicate_size, self.dp_shard_size),
                                mesh_dim_names=("dp_replicate", "dp_shard"))
