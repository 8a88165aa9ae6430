"""The port's flash attention (accelerate_tpu_torch/ops) against the JAX
package's Pallas kernels, run in interpret mode on the CPU.

Inputs come from numpy seeds and go through both packages in fp32. On the
CPU the port takes the kernels' plain PyTorch version, so these tests hold
that version (the reference the Hopper kernels are checked against on the
card) to the TPU kernels' semantics: GQA, ragged S, runtime offsets, the
fully masked chunk, and the lse cotangent.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from accelerate_tpu.ops import blockwise_attention as jax_blockwise
from accelerate_tpu.ops.flash_attention import attention_stats as jax_attention_stats
from accelerate_tpu.ops.pallas_flash import (
    merge_flash_chunks as jax_merge,
    pallas_flash_attention_with_lse,
)
from accelerate_tpu_torch.ops import (
    attention_stats,
    blockwise_attention,
    flash_attention_with_lse,
    merge_flash_chunks,
)
from accelerate_tpu_torch.ops import hopper_flash


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the driver runs several test processes at once,
    and torch's spinning thread pools would contend for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


ATOL = 2e-5  # fp32 on both sides; block order differs (tests/test_attention.py)


def _qkv(b=2, s=128, hq=4, hkv=4, d=16, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, hq, d), dtype=np.float32)
    k = rng.standard_normal((b, s, hkv, d), dtype=np.float32)
    v = rng.standard_normal((b, s, hkv, d), dtype=np.float32)
    return q, k, v


def _jax_flash(q, k, v, **kw):
    out, lse = pallas_flash_attention_with_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), block_q=128, block_k=128,
        interpret=True, **kw)
    return np.asarray(out), np.asarray(lse)


def _torch_flash(q, k, v, **kw):
    out, lse = flash_attention_with_lse(torch.from_numpy(q), torch.from_numpy(k),
                                        torch.from_numpy(v), **kw)
    return out.numpy(), lse.numpy()


def _check_forward(causal, hkv, d):
    q, k, v = _qkv(s=160, hkv=hkv, d=d)  # 160: a ragged tail past the 128 block
    out_j, lse_j = _jax_flash(q, k, v, causal=causal)
    out_t, lse_t = _torch_flash(q, k, v, causal=causal)
    np.testing.assert_allclose(out_t, out_j, rtol=ATOL, atol=ATOL)
    np.testing.assert_allclose(lse_t, lse_j, rtol=ATOL, atol=ATOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hkv", [4, 2])
def test_forward_matches_pallas(causal, hkv):
    _check_forward(causal, hkv, d=16)


# Head dims the Hopper kernels are built for (hopper_flash.BUILT_HEAD_DIMS),
# so the plain versions they are held to on the card are held to Pallas there.
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hkv", [4, 2])
def test_forward_matches_pallas_at_kernel_head_dims(causal, hkv, d):
    _check_forward(causal, hkv, d)


def test_offsets_visible_and_fully_masked():
    q, k, v = _qkv(s=128, hkv=2)
    # q is the second chunk, k the first: every key visible.
    out_j, lse_j = _jax_flash(q, k, v, causal=True, q_offset=128, k_offset=0)
    out_t, lse_t = _torch_flash(q, k, v, causal=True, q_offset=128, k_offset=0)
    np.testing.assert_allclose(out_t, out_j, rtol=ATOL, atol=ATOL)
    np.testing.assert_allclose(lse_t, lse_j, rtol=ATOL, atol=ATOL)
    # A future chunk: no key visible, exact zeros and lse ~ -1e30.
    out_j, lse_j = _jax_flash(q, k, v, causal=True, q_offset=0, k_offset=128)
    out_t, lse_t = _torch_flash(q, k, v, causal=True, q_offset=0, k_offset=128)
    assert np.max(np.abs(out_t)) == 0.0 == np.max(np.abs(out_j))
    assert lse_t.max() < -1e29 and lse_j.max() < -1e29


def test_merge_flash_chunks_matches_jax_and_single_shot():
    q, k, v = _qkv(s=128)
    o1, l1 = _torch_flash(q, k[:, :64], v[:, :64], causal=True, q_offset=0, k_offset=0)
    o2, l2 = _torch_flash(q, k[:, 64:], v[:, 64:], causal=True, q_offset=0, k_offset=64)
    out, lse = merge_flash_chunks(*map(torch.from_numpy, (o1, l1, o2, l2)))
    out_j, lse_j = jax_merge(*map(jnp.asarray, (o1, l1, o2, l2)))
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), rtol=ATOL, atol=ATOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j), rtol=ATOL, atol=ATOL)
    whole, _ = _torch_flash(q, k, v, causal=True)
    np.testing.assert_allclose(out.numpy(), whole, rtol=ATOL, atol=ATOL)


GRAD_CASES = [(True, 2, 0, 0), (False, 4, 0, 0), (True, 2, 32, 0), (True, 2, 0, 32)]


def _check_gradients(causal, hkv, q_offset, k_offset, d):
    q, k, v = _qkv(s=160, hq=4, hkv=hkv, d=d, seed=1)
    rng = np.random.default_rng(2)
    w_out = rng.standard_normal(q.shape, dtype=np.float32)
    w_lse = rng.standard_normal((q.shape[0], q.shape[2], q.shape[1]), dtype=np.float32)
    kw = dict(causal=causal, q_offset=q_offset, k_offset=k_offset)

    def jax_loss(q, k, v):
        out, lse = pallas_flash_attention_with_lse(q, k, v, block_q=128, block_k=128,
                                                   interpret=True, **kw)
        return jnp.sum(out * w_out) + jnp.sum(lse * w_lse)

    g_j = jax.grad(jax_loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out, lse = flash_attention_with_lse(qt, kt, vt, **kw)
    (torch.sum(out * torch.from_numpy(w_out)) + torch.sum(lse * torch.from_numpy(w_lse))).backward()
    for name, a, b in zip("qkv", (qt.grad, kt.grad, vt.grad), g_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-3, atol=1e-4,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("causal,hkv,q_offset,k_offset", GRAD_CASES)
def test_gradients_with_lse_cotangent_match_pallas(causal, hkv, q_offset, k_offset):
    """dq, dk, dv of Σ w_o·out + Σ w_l·lse against jax.grad through the
    Pallas custom_vjp (interpret mode). k_offset=32 leaves the first rows
    with no visible key inside blocks that do run."""
    _check_gradients(causal, hkv, q_offset, k_offset, d=16)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal,hkv,q_offset,k_offset", GRAD_CASES)
def test_gradients_match_pallas_at_kernel_head_dims(causal, hkv, q_offset, k_offset, d):
    _check_gradients(causal, hkv, q_offset, k_offset, d)


@pytest.mark.parametrize("causal", [True, False])
def test_blockwise_and_stats_match_jax(causal):
    q, k, v = _qkv(s=96, hkv=2, seed=3)
    ref = jax_blockwise(*map(jnp.asarray, (q, k, v)), causal=causal, q_offset=32, block_k=32)
    out = blockwise_attention(*map(torch.from_numpy, (q, k, v)), causal=causal, q_offset=32,
                              block_k=32)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=ATOL, atol=ATOL)
    stats_j = jax_attention_stats(*map(jnp.asarray, (q, k, v)), causal=causal, kv_valid_len=80)
    stats_t = attention_stats(*map(torch.from_numpy, (q, k, v)), causal=causal, kv_valid_len=80)
    for a, b in zip(stats_t, stats_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-4)


def test_cuda_wrappers_not_reached_for_cpu_tensors(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA wrapper was called for CPU tensors")

    for name in ("flash_fwd_cuda", "flash_dq_cuda", "flash_dkv_cuda"):
        monkeypatch.setattr(hopper_flash, name, refuse)
    q, k, v = (torch.from_numpy(x).requires_grad_() for x in _qkv(s=64, hkv=2))
    out, lse = flash_attention_with_lse(q, k, v)
    (out.sum() + lse.sum()).backward()
    assert q.grad is not None and hopper_flash.LAUNCHES == {
        "flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0}


def test_cuda_wrappers_raise_on_what_they_do_not_take():
    """Head dims above 256 raise NotImplementedError naming their ROADMAP
    entry, mixed or unported dtypes TypeError, and every other head dim and
    dtype the Pallas kernel takes reaches the device check."""
    with pytest.raises(NotImplementedError, match="Queue B.1 item 1"):
        hopper_flash.flash_fwd_cuda(*(torch.from_numpy(x) for x in _qkv(s=64, d=288)))
    q, k, v = (torch.from_numpy(x) for x in _qkv(s=64, d=32))
    with pytest.raises(TypeError, match="one dtype"):
        hopper_flash.flash_fwd_cuda(q, k.half(), v)
    with pytest.raises(TypeError, match="one dtype"):
        hopper_flash.flash_fwd_cuda(q.double(), k.double(), v.double())
    for d in (16, 80, 96, 256):
        for dtype in hopper_flash.DTYPES:
            x = [torch.from_numpy(t).to(dtype) for t in _qkv(s=64, d=d)]
            with pytest.raises(ValueError, match="CUDA tensors only"):
                hopper_flash.flash_fwd_cuda(*x)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        hopper_flash.flash_fwd_cuda(q, k, v)
    lse = torch.zeros(2, 4, 64)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        hopper_flash.flash_dq_cuda(q, k, v, q, lse, lse)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        hopper_flash.flash_dkv_cuda(q, k, v, q, lse, lse)


@pytest.mark.parametrize("wrapper", ["flash_dq_cuda", "flash_dkv_cuda"])
def test_cuda_backward_wrappers_check_shapes_before_launch(wrapper):
    q, k, v = (torch.from_numpy(x) for x in _qkv(s=64, d=32))
    fn = getattr(hopper_flash, wrapper)
    lse = torch.zeros(2, 4, 64)
    with pytest.raises(ValueError, match="dout"):
        fn(q, k, v, q[:, :32], lse, lse)
    with pytest.raises(ValueError, match="row statistics"):
        fn(q, k, v, q, lse[:, :, :32], lse)


def test_cuda_wrappers_refuse_strides_the_tensor_maps_cannot_take():
    """TMA tensor maps (bf16 and fp16 at a built head dim, read in place)
    need every stride but the last a positive multiple of 16 bytes; the
    wrappers refuse others before looking at the device. fp32 tensors and
    padded head dims are not read by tensor maps."""
    q, k, v = (torch.from_numpy(x).bfloat16() for x in _qkv(s=64, d=64))
    broadcast_k = k[:, :, :1].expand(k.shape)  # stride 0 over the heads
    with pytest.raises(ValueError, match="strides positive"):
        hopper_flash.flash_fwd_cuda(q, broadcast_k, v)
    padded = torch.zeros(2, 64, 4, 68, dtype=torch.bfloat16)[..., :64]  # rows 136 bytes apart
    with pytest.raises(ValueError, match="multiples of 8 elements"):
        hopper_flash.flash_fwd_cuda(padded, k, v)
    lse = torch.zeros(2, 4, 64)
    with pytest.raises(ValueError, match="multiples of 8 elements"):
        hopper_flash.flash_dkv_cuda(q, k, v, padded, lse, lse)
    for args in ((q.float(), broadcast_k.float(), v.float()), (q[..., :48], k[..., :48],
                                                              v[..., :48])):
        with pytest.raises(ValueError, match="CUDA tensors only"):
            hopper_flash.flash_fwd_cuda(*args)


# ---------------------------------------------------------------------------
# Every head dim and dtype the Pallas kernel takes
# ---------------------------------------------------------------------------

# Head dims the kernels run padded (80 and 96, to 128) and the widest built
# one (256, Gemma's); the Pallas kernel pads each to a multiple of 128 lanes.
WIDE_DIMS = [80, 96, 256]


@pytest.mark.parametrize("d", WIDE_DIMS)
@pytest.mark.parametrize("causal", [True, False])
def test_forward_matches_pallas_at_padded_and_wide_head_dims(causal, d):
    _check_forward(causal, 2, d)


@pytest.mark.parametrize("d", WIDE_DIMS)
@pytest.mark.parametrize("causal,hkv,q_offset,k_offset", GRAD_CASES[:3])
def test_gradients_match_pallas_at_padded_and_wide_head_dims(causal, hkv, q_offset, k_offset,
                                                             d):
    _check_gradients(causal, hkv, q_offset, k_offset, d)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


# fp16 against Pallas, both from the same fp16 inputs: the Pallas kernel
# computes in fp16 with fp32 accumulation and casts P to fp16 before P·V;
# the plain version computes in fp32. The tolerance is the one the card
# holds the bf16 kernels to (chip_smoke.py: out and gradients 1e-2 and 2e-2
# relative in norm, lse 5e-3 absolute), which fp16's finer mantissa meets
# with room to spare.
@pytest.mark.parametrize("d", [64, 96, 256])
@pytest.mark.parametrize("causal", [True, False])
def test_fp16_matches_pallas(causal, d):
    q, k, v = (x.astype(np.float16) for x in _qkv(s=160, hkv=2, d=d, seed=4))
    rng = np.random.default_rng(5)
    w_out = rng.standard_normal(q.shape, dtype=np.float32)
    w_lse = rng.standard_normal((q.shape[0], q.shape[2], q.shape[1]), dtype=np.float32)

    def jax_loss(q, k, v):
        out, lse = pallas_flash_attention_with_lse(q, k, v, block_q=128, block_k=128,
                                                   interpret=True, causal=causal)
        return jnp.sum(out.astype(jnp.float32) * w_out) + jnp.sum(lse * w_lse), (out, lse)

    (_, (out_j, lse_j)), g_j = jax.value_and_grad(jax_loss, argnums=(0, 1, 2), has_aux=True)(
        *map(jnp.asarray, (q, k, v)))
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out, lse = flash_attention_with_lse(qt, kt, vt, causal=causal)
    assert out.dtype == torch.float16 and lse.dtype == torch.float32
    (torch.sum(out.float() * torch.from_numpy(w_out))
     + torch.sum(lse * torch.from_numpy(w_lse))).backward()
    assert _rel(out.detach().float(), np.asarray(out_j, np.float32)) <= 1e-2
    assert np.max(np.abs(lse.detach().numpy() - np.asarray(lse_j))) <= 5e-3
    for name, a, b in zip("qkv", (qt.grad, kt.grad, vt.grad), g_j):
        assert a.dtype == torch.float16
        assert _rel(a.float(), np.asarray(b, np.float32)) <= 2e-2, f"d{name}"


@pytest.mark.parametrize("d", [64, 128, 256])
def test_fp32_matches_pallas_at_rtol_1e5(d):
    """fp32 on both sides: forward and gradients within rtol 1e-5 (atol
    1e-5 for entries near zero)."""
    q, k, v = _qkv(s=160, hkv=2, d=d, seed=6)
    out_j, lse_j = _jax_flash(q, k, v, causal=True)
    out_t, lse_t = _torch_flash(q, k, v, causal=True)
    np.testing.assert_allclose(out_t, out_j, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(lse_t, lse_j, rtol=1e-5, atol=1e-5)

    def jax_loss(q, k, v):
        out, lse = pallas_flash_attention_with_lse(q, k, v, block_q=128, block_k=128,
                                                   interpret=True, causal=True)
        return jnp.sum(out * out_j) + jnp.sum(lse)

    g_j = jax.grad(jax_loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out, lse = flash_attention_with_lse(qt, kt, vt, causal=True)
    (torch.sum(out * torch.from_numpy(np.array(out_j))) + torch.sum(lse)).backward()
    for name, a, b in zip("qkv", (qt.grad, kt.grad, vt.grad), g_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("d,width", [(16, 64), (80, 128), (96, 128), (160, 256)])
@pytest.mark.parametrize("causal,hkv,q_offset,k_offset", GRAD_CASES)
def test_pad_head_dim_gives_the_unpadded_plain_results(causal, hkv, q_offset, k_offset, d,
                                                       width):
    """What the wrappers run for a head dim between built widths: the
    inputs zero-padded to the width, the plain version at the unpadded
    scale, the results sliced back. Output, lse, dq, dk and dv equal the
    plain version at the unpadded D up to fp32 rounding of the sums."""
    assert hopper_flash.built_head_dim(d) == width
    q, k, v = map(torch.from_numpy, _qkv(s=96, hkv=hkv, d=d, seed=7))
    rng = np.random.default_rng(8)
    dout = torch.from_numpy(rng.standard_normal(q.shape, dtype=np.float32))
    kw = dict(causal=causal, q_offset=q_offset, k_offset=k_offset)
    out, lse = hopper_flash.pad_head_dim(hopper_flash.flash_fwd_plain, width, q, k, v, **kw)
    out_ref, lse_ref = hopper_flash.flash_fwd_plain(q, k, v, **kw)
    assert out.shape == q.shape and out.is_contiguous()
    torch.testing.assert_close(out, out_ref, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(lse, lse_ref, rtol=1e-6, atol=1e-6)
    delta = (dout * out_ref).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, dout, lse_ref, delta)
    dq = hopper_flash.pad_head_dim(hopper_flash.flash_dq_plain, width, *args, **kw)
    dk, dv = hopper_flash.pad_head_dim(hopper_flash.flash_dkv_plain, width, *args, **kw)
    torch.testing.assert_close(dq, hopper_flash.flash_dq_plain(*args, **kw),
                               rtol=1e-6, atol=1e-6)
    for got, want in zip((dk, dv), hopper_flash.flash_dkv_plain(*args, **kw)):
        assert got.shape == k.shape
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def test_built_head_dims_and_variant_names():
    assert [hopper_flash.built_head_dim(d) for d in (1, 64, 65, 128, 129, 256)] == [
        64, 64, 128, 128, 256, 256]
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue B.1 item 1"):
        hopper_flash.built_head_dim(257)
    assert hopper_flash.variant("flash_dq", torch.float16, 256) == "flash_dq.f16.d256"
    assert hopper_flash.source("flash_dkv", torch.float32) == "flash_f32"
    assert hopper_flash.source("flash_dkv", torch.bfloat16) == "flash_dkv"


class _Mesh:
    """What auto_flash_attention reads of a DeviceMesh."""

    def __init__(self, **axes):
        self.mesh_dim_names, self.shape = tuple(axes), tuple(axes.values())
        self.ndim = len(axes)

    def size(self, i):
        return self.shape[i]


def test_auto_flash_attention_takes_data_parallel_meshes_only(monkeypatch):
    """Over dp_replicate and dp_shard each process attends over its own
    batch shard; over a cp or sp axis, which splits the sequence, it
    attends over the whole sequence through the allgather ring over that
    axis (tests/test_torch_context_parallel.py holds it to the JAX
    package's); over tp, which splits the heads, each process attends with
    its own heads as they are (tests/test_torch_tensor_parallel.py); tp
    with a sequence axis takes the ring over the sequence axis on each
    rank's heads (tests/test_torch_expert_parallel.py)."""
    from accelerate_tpu_torch.ops import auto_flash_attention, flash_attention
    from accelerate_tpu_torch.parallel import cp

    q, k, v = map(torch.from_numpy, _qkv(s=32, hkv=2))
    want = flash_attention(q, k, v)
    for mesh in (None, _Mesh(dp_replicate=2, dp_shard=4), _Mesh(dp_shard=8, cp=1)):
        assert torch.equal(auto_flash_attention(q, k, v, mesh=mesh), want)
    calls = []
    monkeypatch.setattr(cp, "ring_attention", lambda *a, **kw: calls.append(kw) or a[0])
    for mesh, axis in ((_Mesh(dp_shard=2, cp=2, sp=1), "cp"), (_Mesh(cp=1, sp=4), "sp")):
        assert auto_flash_attention(q, k, v, causal=False, mesh=mesh) is q
        assert calls.pop() == dict(causal=False, mesh=mesh, rotate_method="allgather",
                                   axis_name=axis)
    for mesh in (_Mesh(tp=2), _Mesh(dp_shard=2, tp=2)):
        assert torch.equal(auto_flash_attention(q, k, v, mesh=mesh), want)
    for mesh, axis in ((_Mesh(cp=2, tp=2), "cp"), (_Mesh(sp=2, tp=2), "sp")):
        assert auto_flash_attention(q, k, v, causal=False, mesh=mesh) is q
        assert calls.pop() == dict(causal=False, mesh=mesh, rotate_method="allgather",
                                   axis_name=axis)
