"""N-D parallelism configuration.

Counterpart of ``accelerate_tpu/parallelism_config.py``: the same axis
names and validation. This port runs on one device, so every axis of size
above 1 raises ``NotImplementedError``; the mesh is ROADMAP.md Queue A
item 1 (FSDP2/DDP) and item 2 (cp/sp over the same flash kernels).
"""

from __future__ import annotations

import dataclasses


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
        wide = {f.name: getattr(self, f.name) for f in dataclasses.fields(self)
                if f.name.endswith("_size") and getattr(self, f.name) > 1}
        if wide:
            raise NotImplementedError(
                f"{wide}: only one device is ported yet (ROADMAP.md Queue A items 1-2)")
