// Flash-attention forward for Hopper (sm_90a).
//
// Replaces: accelerate_tpu/ops/pallas_flash.py:_fwd_kernel (launched by _fwd).
// Computes causal (or full) online-softmax attention with GQA (query head h
// reads KV head h / (Hq/Hkv)), runtime q/k position offsets, key padding
// against the actual Sk, and returns out (bf16) and the row log-sum-exp
// lse = m + log(l) (fp32, (B, Hq, Sq)). A row with no visible key gives
// out = 0 and lse ~ -1e30, as the TPU kernel does.
//
// Bound on the H100: at the training shapes (S=2048, D=128) the kernel does
// ~2·S·D FLOP per byte of q/k/v it must read, far above the card's ~295
// FLOP/byte ridge, so it is bound by tensor-core operations. Design: one
// thread block of 8 warps per (b, q_head, 128-query block) walks the KV
// blocks in a loop (the TPU kernel's sequential "arbitrary" grid axis);
// each warp owns 16 query rows and keeps m, l and its output accumulator in
// registers. K/V tiles of 64 keys are double-buffered in shared memory with
// cp.async, so the next tile's copy overlaps this tile's products, which run
// on the tensor cores through ldmatrix + mma.sync bf16 fragments with fp32
// accumulation. The loop stops at the causal diagonal computed from the
// runtime offsets, and only the blocks that straddle it (or the ragged tail)
// evaluate the element mask. q/k/v are read in place through their strides
// (no transpose or pad copy). Causal blocks are issued heaviest first. Not
// yet done: TMA loads, wgmma and warp specialisation.
#include "flash_common.cuh"

namespace flash {

struct FwdArgs {
    const bf16 *q, *k, *v;
    bf16* o;
    float* lse;
    long long q_b, q_s, q_h, k_b, k_s, k_h, v_b, v_s, v_h, o_b, o_s, o_h;
    int Sq, Sk, Hq, Hkv, causal, q_off, k_off;
    float scale;
};

constexpr int FWD_WARPS = 8;
constexpr int FWD_BQ = 16 * FWD_WARPS;
constexpr int FWD_BK = 64;

template <int D>
constexpr int fwd_smem_bytes() {
    return (FWD_BQ + 4 * FWD_BK) * (D + 8) * 2;  // Q, and K and V in two stages
}

template <int D>
__global__ void __launch_bounds__(32 * FWD_WARPS) flash_fwd_kernel(FwdArgs a) {
    constexpr int NT = 32 * FWD_WARPS, BQ = FWD_BQ, BK = FWD_BK, LD = D + 8;
    extern __shared__ __align__(16) unsigned char smem[];
    bf16* sQ = reinterpret_cast<bf16*>(smem);
    bf16* sK = sQ + BQ * LD;       // [2][BK][LD]
    bf16* sV = sK + 2 * BK * LD;   // [2][BK][LD]

    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
    const int qb = gridDim.x - 1 - blockIdx.x;
    const int b = blockIdx.y / a.Hq, h = blockIdx.y % a.Hq;
    const int hk = h / (a.Hq / a.Hkv);
    const int q0 = qb * BQ;
    const bf16* Q = a.q + b * a.q_b + h * a.q_h;
    const bf16* K = a.k + b * a.k_b + hk * a.k_h;
    const bf16* V = a.v + b * a.v_b + hk * a.v_h;

    const int nkb = causal_key_blocks((a.Sk + BK - 1) / BK, a.causal, a.q_off, a.k_off, q0, BQ, BK);
    load_tile<D, BQ, NT>(sQ, Q, a.q_s, q0, a.Sq, tid);
    if (nkb > 0) {
        load_tile<D, BK, NT>(sK, K, a.k_s, 0, a.Sk, tid);
        load_tile<D, BK, NT>(sV, V, a.v_s, 0, a.Sk, tid);
    }
    cp_async_commit();

    const int row = warp * 16 + g;  // tile row of c0/c1; row + 8 holds c2/c3
    float acc[D / 8][4];
#pragma unroll
    for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
    float m[2] = {NEG_INF, NEG_INF};
    float l[2] = {0.f, 0.f};  // this lane's partial row sums; reduced at the end

    for (int kb = 0; kb < nkb; ++kb) {
        const int k0 = kb * BK;
        const bf16* cK = sK + (kb & 1) * BK * LD;
        const bf16* cV = sV + (kb & 1) * BK * LD;
        if (kb + 1 < nkb) {
            load_tile<D, BK, NT>(sK + ((kb + 1) & 1) * BK * LD, K, a.k_s, k0 + BK, a.Sk, tid);
            load_tile<D, BK, NT>(sV + ((kb + 1) & 1) * BK * LD, V, a.v_s, k0 + BK, a.Sk, tid);
        }
        cp_async_commit();
        cp_async_wait<1>();
        __syncthreads();

        float s[BK / 8][4];
#pragma unroll
        for (int n = 0; n < BK / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
            uint32_t af[4];
            load_a(af, sQ, LD, warp * 16, kk * 16, lane);
#pragma unroll
            for (int n = 0; n < BK / 16; ++n) {
                uint32_t bf[4];
                load_b_nk(bf, cK, LD, n * 16, kk * 16, lane);
                mma16816(s[2 * n], af, bf[0], bf[1]);
                mma16816(s[2 * n + 1], af, bf[2], bf[3]);
            }
        }

        const bool masked = needs_mask(a.causal, a.q_off, a.k_off, q0, BQ, k0, BK, a.Sq, a.Sk);
        float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
        for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                bool ok = true;
                if (masked) {
                    const int qpos = q0 + row + (e >> 1) * 8;
                    const int kpos = k0 + n * 8 + 2 * t + (e & 1);
                    ok = kpos < a.Sk && (!a.causal || a.q_off + qpos >= a.k_off + kpos);
                }
                s[n][e] = ok ? s[n][e] * a.scale : NEG_INF;
                mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
            }
        }
        float alpha[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            const float m_new = fmaxf(m[i], quad_max(mx[i]));
            alpha[i] = __expf(m[i] - m_new);
            m[i] = m_new;
            l[i] *= alpha[i];
        }
#pragma unroll
        for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                // A masked score contributes 0, also while every key so far
                // is masked and m is still NEG_INF.
                const float p = s[n][e] <= NEG_INF ? 0.f : __expf(s[n][e] - m[e >> 1]);
                s[n][e] = p;
                l[e >> 1] += p;
            }
        }
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
            acc[n][0] *= alpha[0];
            acc[n][1] *= alpha[0];
            acc[n][2] *= alpha[1];
            acc[n][3] *= alpha[1];
        }
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
            uint32_t pa[4];
            c_to_a(pa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
            for (int n = 0; n < D / 16; ++n) {
                uint32_t bf[4];
                load_b_kn(bf, cV, LD, kk * 16, n * 16, lane);
                mma16816(acc[2 * n], pa, bf[0], bf[1]);
                mma16816(acc[2 * n + 1], pa, bf[2], bf[3]);
            }
        }
        __syncthreads();  // this stage is refilled by the next iteration
    }
    cp_async_wait<0>();

#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const float l_safe = fmaxf(quad_sum(l[i]), 1e-30f);
        const float inv = 1.f / l_safe;
        const int qpos = q0 + row + i * 8;
        if (qpos < a.Sq) {
            bf16* O = a.o + b * a.o_b + (long long)qpos * a.o_s + h * a.o_h;
#pragma unroll
            for (int n = 0; n < D / 8; ++n)
                *reinterpret_cast<uint32_t*>(O + n * 8 + 2 * t) =
                    pack_bf16(acc[n][2 * i] * inv, acc[n][2 * i + 1] * inv);
            if (t == 0) a.lse[((long long)b * a.Hq + h) * a.Sq + qpos] = m[i] + logf(l_safe);
        }
    }
}

template <int D>
cudaError_t launch_fwd(const FwdArgs& a, int B, cudaStream_t stream) {
    const int smem = fwd_smem_bytes<D>();
    cudaError_t err = allow_smem(flash_fwd_kernel<D>, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((a.Sq + FWD_BQ - 1) / FWD_BQ, B * a.Hq);
    flash_fwd_kernel<D><<<grid, 32 * FWD_WARPS, smem, stream>>>(a);
    return cudaGetLastError();
}

}  // namespace flash

// strides: q (b, s, h), k (b, s, h), v (b, s, h), out (b, s, h), in elements.
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* out, void* lse,
                         const long long* strides, int B, int Sq, int Sk, int Hq, int Hkv, int D,
                         int causal, int q_off, int k_off, float scale, void* stream) {
    using namespace flash;
    FwdArgs a;
    a.q = static_cast<const bf16*>(q);
    a.k = static_cast<const bf16*>(k);
    a.v = static_cast<const bf16*>(v);
    a.o = static_cast<bf16*>(out);
    a.lse = static_cast<float*>(lse);
    a.q_b = strides[0]; a.q_s = strides[1]; a.q_h = strides[2];
    a.k_b = strides[3]; a.k_s = strides[4]; a.k_h = strides[5];
    a.v_b = strides[6]; a.v_s = strides[7]; a.v_h = strides[8];
    a.o_b = strides[9]; a.o_s = strides[10]; a.o_h = strides[11];
    a.Sq = Sq; a.Sk = Sk; a.Hq = Hq; a.Hkv = Hkv;
    a.causal = causal; a.q_off = q_off; a.k_off = k_off; a.scale = scale;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (D) {
        case 32: return launch_fwd<32>(a, B, s);
        case 64: return launch_fwd<64>(a, B, s);
        case 128: return launch_fwd<128>(a, B, s);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}
