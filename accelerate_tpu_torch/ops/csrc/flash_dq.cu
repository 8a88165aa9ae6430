// Flash-attention backward, dQ pass, for Hopper (sm_90a).
//
// Replaces: accelerate_tpu/ops/pallas_flash.py:_dq_kernel (launched by _bwd).
// Recomputes P = exp(S·scale − lse) under the causal and key-padding mask,
// then dS = P∘(dP − δ) with dP = dO·Vᵀ, and dQ = scale · Σ_k dS·K. δ is
// rowsum(dO∘O) − g_lse, computed outside the kernel (as on the TPU), so the
// lse cotangent of ring attention's chunk merge flows through here.
//
// Bound on the H100: three S×S×D products per (b, head) at ~3·S·D FLOP per
// byte read: bound by tensor-core operations at the training shapes.
// Design: one thread block of 8 warps per (b, q_head, 128-query block) loops
// over the KV blocks up to the causal diagonal (runtime offsets); each warp
// owns 16 query rows and keeps its dQ accumulator in registers, so dQ is
// written once and needs no atomics. K/V tiles of 64 keys are
// double-buffered with cp.async; the products use ldmatrix + mma.sync bf16
// fragments with fp32 accumulation (K read with ldmatrix for S = Q·Kᵀ and
// with ldmatrix.trans for dS·K). GQA: query head h reads KV head
// h / (Hq/Hkv). Not yet done: TMA loads and wgmma.
#include "flash_common.cuh"

namespace flash {

constexpr int DQ_WARPS = 8;
constexpr int DQ_BQ = 16 * DQ_WARPS;
constexpr int DQ_BK = 64;

template <int D>
constexpr int dq_smem_bytes() {
    return (2 * DQ_BQ + 4 * DQ_BK) * (D + 8) * 2;  // Q, dO, and K and V in two stages
}

template <int D>
__global__ void __launch_bounds__(32 * DQ_WARPS) flash_dq_kernel(BwdArgs a) {
    constexpr int NT = 32 * DQ_WARPS, BQ = DQ_BQ, BK = DQ_BK, LD = D + 8;
    extern __shared__ __align__(16) unsigned char smem[];
    bf16* sQ = reinterpret_cast<bf16*>(smem);
    bf16* sdO = sQ + BQ * LD;
    bf16* sK = sdO + BQ * LD;      // [2][BK][LD]
    bf16* sV = sK + 2 * BK * LD;   // [2][BK][LD]

    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
    const int qb = gridDim.x - 1 - blockIdx.x;
    const int b = blockIdx.y / a.Hq, h = blockIdx.y % a.Hq;
    const int hk = h / (a.Hq / a.Hkv);
    const int q0 = qb * BQ;
    const bf16* K = a.k + b * a.k_b + hk * a.k_h;
    const bf16* V = a.v + b * a.v_b + hk * a.v_h;

    const int nkb = causal_key_blocks((a.Sk + BK - 1) / BK, a.causal, a.q_off, a.k_off, q0, BQ, BK);
    load_tile<D, BQ, NT>(sQ, a.q + b * a.q_b + h * a.q_h, a.q_s, q0, a.Sq, tid);
    load_tile<D, BQ, NT>(sdO, a.dout + b * a.do_b + h * a.do_h, a.do_s, q0, a.Sq, tid);
    if (nkb > 0) {
        load_tile<D, BK, NT>(sK, K, a.k_s, 0, a.Sk, tid);
        load_tile<D, BK, NT>(sV, V, a.v_s, 0, a.Sk, tid);
    }
    cp_async_commit();

    const int row = warp * 16 + g;
    const long long stat = ((long long)b * a.Hq + h) * a.Sq;
    float lse[2], delta[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int qpos = q0 + row + i * 8;
        lse[i] = qpos < a.Sq ? a.lse[stat + qpos] : 0.f;
        delta[i] = qpos < a.Sq ? a.delta[stat + qpos] : 0.f;
    }

    float acc[D / 8][4];
#pragma unroll
    for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

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

        float s[BK / 8][4], dp[BK / 8][4];
#pragma unroll
        for (int n = 0; n < BK / 8; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
            uint32_t qa[4], da[4];
            load_a(qa, sQ, LD, warp * 16, kk * 16, lane);
            load_a(da, sdO, LD, warp * 16, kk * 16, lane);
#pragma unroll
            for (int n = 0; n < BK / 16; ++n) {
                uint32_t bf[4];
                load_b_nk(bf, cK, LD, n * 16, kk * 16, lane);
                mma16816(s[2 * n], qa, bf[0], bf[1]);
                mma16816(s[2 * n + 1], qa, bf[2], bf[3]);
                load_b_nk(bf, cV, LD, n * 16, kk * 16, lane);
                mma16816(dp[2 * n], da, bf[0], bf[1]);
                mma16816(dp[2 * n + 1], da, bf[2], bf[3]);
            }
        }
        const bool masked = needs_mask(a.causal, a.q_off, a.k_off, q0, BQ, k0, BK, a.Sq, a.Sk);
#pragma unroll
        for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int i = e >> 1;
                bool ok = true;
                if (masked) {
                    const int qpos = q0 + row + i * 8;
                    const int kpos = k0 + n * 8 + 2 * t + (e & 1);
                    ok = kpos < a.Sk && (!a.causal || a.q_off + qpos >= a.k_off + kpos);
                }
                const float p = ok ? __expf(s[n][e] * a.scale - lse[i]) : 0.f;
                s[n][e] = p * (dp[n][e] - delta[i]);  // dS
            }
        }
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
            uint32_t sa[4];
            c_to_a(sa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
            for (int n = 0; n < D / 16; ++n) {
                uint32_t bf[4];
                load_b_kn(bf, cK, LD, kk * 16, n * 16, lane);
                mma16816(acc[2 * n], sa, bf[0], bf[1]);
                mma16816(acc[2 * n + 1], sa, bf[2], bf[3]);
            }
        }
        __syncthreads();  // this stage is refilled by the next iteration
    }
    cp_async_wait<0>();

#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int qpos = q0 + row + i * 8;
        if (qpos < a.Sq) {
            bf16* dQ = a.dq + b * a.dq_b + (long long)qpos * a.dq_s + h * a.dq_h;
#pragma unroll
            for (int n = 0; n < D / 8; ++n)
                *reinterpret_cast<uint32_t*>(dQ + n * 8 + 2 * t) =
                    pack_bf16(acc[n][2 * i] * a.scale, acc[n][2 * i + 1] * a.scale);
        }
    }
}

template <int D>
cudaError_t launch_dq(const BwdArgs& a, int B, cudaStream_t stream) {
    const int smem = dq_smem_bytes<D>();
    cudaError_t err = allow_smem(flash_dq_kernel<D>, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((a.Sq + DQ_BQ - 1) / DQ_BQ, B * a.Hq);
    flash_dq_kernel<D><<<grid, 32 * DQ_WARPS, smem, stream>>>(a);
    return cudaGetLastError();
}

}  // namespace flash

// strides: q, k, v, dout, dq, each (b, s, h), in elements.
extern "C" int flash_dq(const void* q, const void* k, const void* v, const void* dout,
                        const void* lse, const void* delta, void* dq, const long long* strides,
                        int B, int Sq, int Sk, int Hq, int Hkv, int D, int causal, int q_off,
                        int k_off, float scale, void* stream) {
    using namespace flash;
    BwdArgs a = {};
    a.q = static_cast<const bf16*>(q);
    a.k = static_cast<const bf16*>(k);
    a.v = static_cast<const bf16*>(v);
    a.dout = static_cast<const bf16*>(dout);
    a.lse = static_cast<const float*>(lse);
    a.delta = static_cast<const float*>(delta);
    a.dq = static_cast<bf16*>(dq);
    a.q_b = strides[0]; a.q_s = strides[1]; a.q_h = strides[2];
    a.k_b = strides[3]; a.k_s = strides[4]; a.k_h = strides[5];
    a.v_b = strides[6]; a.v_s = strides[7]; a.v_h = strides[8];
    a.do_b = strides[9]; a.do_s = strides[10]; a.do_h = strides[11];
    a.dq_b = strides[12]; a.dq_s = strides[13]; a.dq_h = strides[14];
    a.Sq = Sq; a.Sk = Sk; a.Hq = Hq; a.Hkv = Hkv;
    a.causal = causal; a.q_off = q_off; a.k_off = k_off; a.scale = scale;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (D) {
        case 32: return launch_dq<32>(a, B, s);
        case 64: return launch_dq<64>(a, B, s);
        case 128: return launch_dq<128>(a, B, s);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}
