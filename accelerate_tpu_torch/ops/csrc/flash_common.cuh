// Shared pieces of the three flash-attention kernels (flash_fwd.cu,
// flash_dq.cu, flash_dkv.cu): the 16-bit element types and their packing,
// shared addresses, the reductions over the four lanes of an accumulator row, the
// causal block arithmetic, the backward arguments and the shared-memory
// limit. The Hopper primitives (TMA, mbarriers, wgmma, setmaxnreg) are in
// hopper_common.cuh.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

using bf16 = __nv_bfloat16;
using f16 = __half;

constexpr float NEG_INF = -1e30f;  // the masked-score value of the TPU kernels
constexpr float LOG2E = 1.4426950408889634f;

// Two floats rounded to the element type T (bf16 or f16) in one 32-bit
// register, `lo` in the low half.
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi);

template <>
__device__ __forceinline__ uint32_t pack2<bf16>(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
}

template <>
__device__ __forceinline__ uint32_t pack2<f16>(float lo, float hi) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Sum over the four lanes that share one row of an accumulator.
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

// Arguments of the two backward kernels (flash_dq.cu, flash_dkv.cu). The
// inputs are read through TMA tensor maps built from their strides; the
// outputs are written through the strides here.
template <typename T>
struct BwdArgs {
    const T *q, *k, *v, *dout;
    const float *lse, *delta;  // (B, Hq, Sq), contiguous
    T *dq, *dk, *dv;
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
