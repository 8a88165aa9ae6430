// Shared pieces of the three flash-attention kernels: the element type, the
// causal block arithmetic, the backward arguments and the shared-memory
// limit (all three), and the dQ kernel's (flash_dq.cu) tensor-core path:
// bf16 products through mma.sync.m16n8k16, fragments loaded from shared
// memory with ldmatrix, and tiles copied from the (B, S, H, D) layout, read
// through its strides, with cp.async so that the next tile's copy overlaps
// this tile's products. The forward and dK/dV kernels use wgmma and TMA
// instead (hopper_common.cuh).
//
// Fragment layout of mma.m16n8k16 (lane = 4*g + t, g = lane/4, t = lane%4):
//   A (16x16, row-major): a0 = (g, 2t..2t+1), a1 = (g+8, 2t..), a2 = (g, 8+2t..),
//                         a3 = (g+8, 8+2t..)
//   B (16x8, "col"):      b0 = (k 2t..2t+1, n g), b1 = (k 8+2t.., n g)
//   C (16x8, fp32):       c0,c1 = (g, 2t..2t+1), c2,c3 = (g+8, 2t..2t+1)
// Every shared tile is row-major with 8 elements of padding per row, so the
// eight row addresses of each ldmatrix phase fall on distinct banks. A right
// operand stored with the reduction dimension contiguous (K for Q·Kᵀ) is read
// with plain ldmatrix; one stored the other way round (V for P·V) with
// ldmatrix.trans, so no transposed copy is needed.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

using bf16 = __nv_bfloat16;

constexpr float NEG_INF = -1e30f;  // the masked-score value of the TPU kernels
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// c += a · b on the tensor cores, fp32 accumulate.
__device__ __forceinline__ void mma16816(float c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const bf16* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t r[4], const bf16* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_addr(p)));
}

// A fragment of rows row0..row0+15, reduction columns k0..k0+15 of a
// row-major tile with leading dimension ld (elements).
__device__ __forceinline__ void load_a(uint32_t a[4], const bf16* s, int ld, int row0, int k0,
                                       int lane) {
    ldsm_x4(a, s + (row0 + (lane & 15)) * ld + k0 + (lane >> 4) * 8);
}

// B fragments of two n-tiles (n0..n0+7 in b[0..1], n0+8..n0+15 in b[2..3])
// of Nᵀ, where N is a row-major tile [n][k]; reduction columns k0..k0+15.
__device__ __forceinline__ void load_b_nk(uint32_t b[4], const bf16* s, int ld, int n0, int k0,
                                          int lane) {
    ldsm_x4(b, s + (n0 + (lane & 7) + ((lane >> 4) << 3)) * ld + k0 + ((lane >> 3) & 1) * 8);
}

// B fragments of two n-tiles (as load_b_nk) of a row-major tile X[k][n]:
// reduction rows k0..k0+15, columns n0..n0+15.
__device__ __forceinline__ void load_b_kn(uint32_t b[4], const bf16* s, int ld, int k0, int n0,
                                          int lane) {
    ldsm_x4_t(b, s + (k0 + (lane & 15)) * ld + n0 + (lane >> 4) * 8);
}

// The A fragment of a 16x16 slice of a C-layout score tile held in
// registers: columns 16kk..16kk+15 are the n-tiles 2kk and 2kk+1.
__device__ __forceinline__ void c_to_a(uint32_t a[4], const float lo[4], const float hi[4]) {
    a[0] = pack_bf16(lo[0], lo[1]);
    a[1] = pack_bf16(lo[2], lo[3]);
    a[2] = pack_bf16(hi[0], hi[1]);
    a[3] = pack_bf16(hi[2], hi[3]);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
    // src-size 0 fills the 16 bytes with zeros and reads nothing.
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

// Wait until at most N of this thread's committed copy groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// Start copying rows r0..r0+R-1 of a (S, D) slice with row stride `stride`
// into a row-major shared tile (leading dimension D + 8); rows at or past
// `limit` are zero-filled. NT threads, 16 bytes per thread per step.
template <int D, int R, int NT>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, long long stride, int r0,
                                          int limit, int tid) {
    constexpr int VEC = D / 8;
#pragma unroll
    for (int i = tid; i < R * VEC; i += NT) {
        const int r = i / VEC;
        const int c = (i % VEC) * 8;
        const bool valid = r0 + r < limit;
        cp_async16(dst + r * (D + 8) + c, valid ? src + (long long)(r0 + r) * stride + c : src,
                   valid);
    }
}

// Sum over the four lanes that share one row of a C fragment.
__device__ __forceinline__ float quad_sum(float x) {
    x += __shfl_xor_sync(0xffffffffu, x, 1);
    x += __shfl_xor_sync(0xffffffffu, x, 2);
    return x;
}

__device__ __forceinline__ float quad_max(float x) {
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
    return x;
}

// Number of key blocks a causal query block [q0, q0+bq) reaches: a key
// block whose first key lies after the block's last query is skipped, as
// the TPU kernel predicates it out (offsets are global positions).
__device__ __forceinline__ int causal_key_blocks(int nkb, int causal, int q_off, int k_off,
                                                 int q0, int bq, int bk) {
    if (!causal) return nkb;
    const long long last = (long long)q_off + q0 + bq - 1 - k_off;
    if (last < 0) return 0;
    const long long n = last / bk + 1;
    return n < nkb ? (int)n : nkb;
}

// Whether a (query block, key block) pair needs the element mask: it
// straddles the causal diagonal, or the key block runs past Sk, or the
// query block past Sq. Elsewhere every pair is visible.
__device__ __forceinline__ bool needs_mask(int causal, int q_off, int k_off, int q0, int bq,
                                           int k0, int bk, int sq, int sk) {
    const bool diag = causal && (long long)k_off + k0 + bk - 1 > (long long)q_off + q0;
    return diag || k0 + bk > sk || q0 + bq > sq;
}

// Arguments of the two backward kernels (flash_dq.cu, flash_dkv.cu).
struct BwdArgs {
    const bf16 *q, *k, *v, *dout;
    const float *lse, *delta;  // (B, Hq, Sq), contiguous
    bf16 *dq, *dk, *dv;
    long long q_b, q_s, q_h, k_b, k_s, k_h, v_b, v_s, v_h, do_b, do_s, do_h;
    long long dq_b, dq_s, dq_h, dk_b, dk_s, dk_h, dv_b, dv_s, dv_h;
    int Sq, Sk, Hq, Hkv, causal, q_off, k_off;
    float scale;
};

// Set the dynamic shared-memory limit of a kernel before its first launch.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, int bytes) {
    if (bytes <= 48 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace flash
