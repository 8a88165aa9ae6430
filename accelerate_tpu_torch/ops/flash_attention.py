"""Memory-efficient attention.

Counterpart of ``accelerate_tpu/ops/flash_attention.py``:

- :func:`blockwise_attention` — online-softmax attention as a loop over KV
  blocks in plain PyTorch, O(S·B_k) memory instead of O(S²).
- :func:`attention_stats` — one-chunk attention returning the online-softmax
  statistics that ring attention merges.
- :func:`flash_attention` — the fused attention of ``ops/hopper_flash.py``:
  the Hopper kernels for CUDA tensors, their plain version on the CPU.
- :func:`auto_flash_attention` — the model layer's: ``flash_attention``
  over the process's mesh, on its own heads under ``tp``, through the ring
  when the sequence is split.

All support GQA (Hq a multiple of Hkv) and causal masking with query/key
position offsets. Layout is (B, S, H, D).
"""

from __future__ import annotations

import math

import torch

from .hopper_flash import NEG_INF, flash_attention  # noqa: F401  (re-exported)


def _repeat_kv(k, v, hq):
    rep = hq // k.shape[2]
    if rep != 1:
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    return k, v


def blockwise_attention(q, k, v, *, causal: bool = True, q_offset: int = 0,
                        k_offset: int = 0, block_k: int = 512):
    """Online-softmax attention over KV blocks.

    q: (B, Sq, Hq, D); k/v: (B, Sk, Hkv, D). ``q_offset``/``k_offset`` are the
    global positions of element 0 of q/k. Returns (B, Sq, Hq, D)."""
    b, sq, hq, d = q.shape
    k, v = _repeat_kv(k, v, hq)
    sk = k.shape[1]
    block_k = min(block_k, sk)
    scale = 1.0 / math.sqrt(d)
    q_pos = q_offset + torch.arange(sq, device=q.device)
    acc = torch.zeros(b, hq, sq, d, dtype=torch.float32, device=q.device)
    m = torch.full((b, hq, sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros(b, hq, sq, dtype=torch.float32, device=q.device)
    for start in range(0, sk, block_k):
        k_blk, v_blk = k[:, start:start + block_k], v[:, start:start + block_k]
        k_pos = k_offset + start + torch.arange(k_blk.shape[1], device=q.device)
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k_blk).float() * scale
        if causal:
            logits = torch.where(q_pos[:, None] >= k_pos[None, :], logits, NEG_INF)
        m_new = torch.maximum(m, logits.amax(-1))
        p = torch.exp(logits - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhqk,bkhd->bhqd", p.to(v_blk.dtype), v_blk).float()
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)


def attention_stats(q, k, v, *, causal: bool = True, q_offset: int = 0, k_offset: int = 0,
                    kv_valid_len=None):
    """One-chunk attention returning online-softmax stats instead of the
    normalized output: (acc (B, H, Sq, D) fp32, m (B, H, Sq), l (B, H, Sq)).
    ``kv_valid_len`` masks key slots at or past it."""
    sq, hq, d = q.shape[1], q.shape[2], q.shape[3]
    k, v = _repeat_kv(k, v, hq)
    sk = k.shape[1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * (1.0 / math.sqrt(d))
    if causal:
        q_pos = q_offset + torch.arange(sq, device=q.device)
        k_pos = k_offset + torch.arange(sk, device=q.device)
        logits = torch.where(q_pos[:, None] >= k_pos[None, :], logits, NEG_INF)
    if kv_valid_len is not None:
        slot = torch.arange(sk, device=q.device)
        logits = torch.where(slot < kv_valid_len, logits, NEG_INF)
    m = logits.amax(-1)
    p = torch.exp(logits - m[..., None])
    acc = torch.einsum("bhqk,bkhd->bhqd", p.to(v.dtype), v).float()
    return acc, m, p.sum(-1)


# Mesh axes along which attention runs on this process's tensors as they
# are: its slice of the batch, or (pp) its pipeline stage's layers.
DATA_PARALLEL_AXES = ("pp", "dp_replicate", "dp_shard")
# Mesh axes that split the heads: each process's projections give it its
# own heads (parallel/tp.py), and attention runs on them as they are.
HEAD_AXES = ("tp",)
# Mesh axes that split the sequence: each process attends over the whole
# sequence through the "allgather" ring over the axis.
SEQUENCE_AXES = ("cp", "sp")


def auto_flash_attention(q, k, v, *, causal: bool = True, mesh=None):
    """Model-layer fused attention: :func:`flash_attention` on this
    process's tensors, over ``mesh`` (a ``DeviceMesh`` with named axes, as
    ``ParallelismConfig.build_mesh`` makes; default: the set-up
    ``AcceleratorState``'s, if any).

    Over ``dp_replicate`` and ``dp_shard`` each process attends over its
    own rows, and over ``pp`` with its own stage's layers. Over ``tp`` it attends with its own heads: the JAX package's
    ``shard_map`` splits the heads over ``tp`` when both the q and the kv
    head counts divide and otherwise leaves them whole, and the port's
    column-parallel projections give each rank the same heads (q split
    with kv whole: the kv heads its q heads read,
    ``parallel/tp.heads_for_local_q``), so the kernels run at H/tp heads.
    Over a ``cp`` or ``sp`` axis wider than 1, where each process holds a
    slice of the sequence, it attends over the whole sequence, as the JAX
    package's ``shard_map`` leaves the sequence dim whole: the
    ``"allgather"`` ring over that axis (``parallel/cp.py``). Over ``tp``
    with a sequence axis both hold: each rank's ``H/tp`` heads go through
    the ``"allgather"`` ring over the sequence group of its ``tp`` slice
    (the mesh's ``cp`` or ``sp`` group that holds this process), as the
    JAX ``shard_map`` splits the heads over ``tp`` and leaves the sequence
    whole."""
    if mesh is None:
        from ..state import current_mesh

        mesh = current_mesh()
    if mesh is not None:
        names = mesh.mesh_dim_names or ()
        wide = [n for i, n in enumerate(names) if mesh.size(i) > 1 and n not in DATA_PARALLEL_AXES]
        other = [n for n in wide if n not in SEQUENCE_AXES + HEAD_AXES]
        seq = [n for n in wide if n in SEQUENCE_AXES]
        if len(names) != mesh.ndim or other or len(seq) > 1:
            raise NotImplementedError(
                f"auto_flash_attention over mesh axes {other or wide or mesh} is not ported yet "
                "(ROADMAP.md Queue A item 6)")
        if seq:
            from ..parallel.cp import ring_attention

            return ring_attention(q, k, v, causal=causal, mesh=mesh, rotate_method="allgather",
                                  axis_name=seq[0])
    return flash_attention(q, k, v, causal=causal)
