"""This process's slice of a batch.

Counterpart of ``batch_partition_spec`` in
``accelerate_tpu/parallel/sharding.py``. There a batch is one global array
laid out by a PartitionSpec: dim 0 over the data-parallel axes and, when
``cp`` or ``sp`` is wider than 1, dim 1 over that axis. Here each process
holds its own slice of it, by the same rule:

- rows are split over ``dp_replicate × dp_shard`` (``batch_axes``);
- dim 1 of every leaf with more than one dim is split over ``cp × sp``
  (``seq_axes``): rank ``i`` holds positions ``[i·S/n, (i+1)·S/n)``.

Processes that differ only in ``cp`` or ``sp`` hold the same rows.
"""

from __future__ import annotations

from ..utils.operations import find_batch_size, recursively_apply, slice_tensors


def sequence_slice(batch, num_slices: int, index: int, seq_dim: int = 1):
    """Slice ``index`` of ``num_slices`` equal ones along ``seq_dim`` of every
    tensor or array leaf with more than ``seq_dim`` dims; others pass as
    they are. A length that does not divide raises ``ValueError``."""
    if num_slices == 1:
        return batch

    def cut(t):
        if t.ndim <= seq_dim:
            return t
        s = t.shape[seq_dim]
        if s % num_slices:
            raise ValueError(f"sequence length {s} does not divide by the {num_slices} "
                             "processes of the cp/sp axis")
        n = s // num_slices
        return t[(slice(None),) * seq_dim + (slice(index * n, (index + 1) * n),)]

    return recursively_apply(cut, batch)


def local_batch(batch, parallelism_config, rank: int):
    """Process ``rank``'s slice of a global batch: its rows, then its slice
    of the sequence."""
    cfg = parallelism_config
    rows, dp = find_batch_size(batch), cfg.dp_size
    if rows % dp:
        raise ValueError(f"batch of {rows} rows does not divide by the {dp} data-parallel "
                         "processes")
    n, i = rows // dp, cfg.data_parallel_index(rank)
    return sequence_slice(slice_tensors(batch, i * n, (i + 1) * n), cfg.seq_size,
                          cfg.sequence_index(rank))
