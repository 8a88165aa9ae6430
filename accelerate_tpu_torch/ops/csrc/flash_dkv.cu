// Flash-attention backward, dK/dV pass, for Hopper (sm_90a).
//
// Replaces: accelerate_tpu/ops/pallas_flash.py:_dkv_kernel (launched by _bwd).
// dV = Σ Pᵀ·dO and dK = scale · Σ dSᵀ·Q, summed over the query blocks AND
// the query heads of the GQA group, so dK/dV come out at KV-head
// resolution. P and dS are recomputed from q, k, v, dO, lse and δ as in the
// dQ pass.
//
// Bound on the H100: four S×S×D products per (b, head) at ~4·S·D FLOP per
// byte read: bound by tensor-core operations at the training shapes.
// Design: one thread block of 8 warps per (b, kv_head, 128-key block)
// loops over the heads of its GQA group and, for each, over the 32-query
// blocks from the causal diagonal on (runtime offsets). Each warp owns 16
// keys and keeps its dK and dV accumulators in registers, so every output
// row is written once by one block: no atomics, and the result is
// deterministic. The Q, dO, lse and δ tiles are double-buffered with
// cp.async. The products run as Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ (Q, dO read
// with ldmatrix) and dV += Pᵀ·dO, dK += dSᵀ·Q (read with ldmatrix.trans),
// all mma.sync bf16 fragments with fp32 accumulation. Not yet done: TMA
// loads and wgmma.
#include "flash_common.cuh"

namespace flash {

constexpr int DKV_WARPS = 8;
constexpr int DKV_BK = 16 * DKV_WARPS;
constexpr int DKV_BQ = 32;

template <int D>
constexpr int dkv_smem_bytes() {
    // K and V; Q and dO in two stages; lse and δ in two stages.
    return (2 * DKV_BK + 4 * DKV_BQ) * (D + 8) * 2 + 4 * DKV_BQ * 4;
}

template <int D>
__global__ void __launch_bounds__(32 * DKV_WARPS) flash_dkv_kernel(BwdArgs a) {
    constexpr int NT = 32 * DKV_WARPS, BQ = DKV_BQ, BK = DKV_BK, LD = D + 8;
    extern __shared__ __align__(16) unsigned char smem[];
    bf16* sK = reinterpret_cast<bf16*>(smem);
    bf16* sV = sK + BK * LD;
    bf16* sQ = sV + BK * LD;        // [2][BQ][LD]
    bf16* sdO = sQ + 2 * BQ * LD;   // [2][BQ][LD]
    float* sLse = reinterpret_cast<float*>(sdO + 2 * BQ * LD);  // [2][BQ]
    float* sDelta = sLse + 2 * BQ;                               // [2][BQ]

    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
    const int kb = blockIdx.x;
    const int b = blockIdx.y / a.Hkv, hk = blockIdx.y % a.Hkv;
    const int rep = a.Hq / a.Hkv;
    const int k0 = kb * BK;

    // Query blocks from the first that sees any key of this block under the
    // causal mask; the work list runs over (group head, query block).
    const int nqb = (a.Sq + BQ - 1) / BQ;
    int qb_first = 0;
    if (a.causal) {
        const long long first = (long long)a.k_off + k0 - a.q_off - (BQ - 1);
        qb_first = first <= 0 ? 0 : (int)((first + BQ - 1) / BQ);
    }
    const int nq = qb_first < nqb ? nqb - qb_first : 0;
    const int n_iter = rep * nq;

    // Start the copies of work item `it` into stage `st`.
    auto load_q = [&](int it, int st) {
        const int h = hk * rep + it / nq;
        const int q0 = (qb_first + it % nq) * BQ;
        load_tile<D, BQ, NT>(sQ + st * BQ * LD, a.q + b * a.q_b + h * a.q_h, a.q_s, q0, a.Sq, tid);
        load_tile<D, BQ, NT>(sdO + st * BQ * LD, a.dout + b * a.do_b + h * a.do_h, a.do_s, q0,
                             a.Sq, tid);
        if (tid < 2 * BQ) {
            const int r = tid % BQ;
            const bool valid = q0 + r < a.Sq;
            const float* src = (tid < BQ ? a.lse : a.delta) + ((long long)b * a.Hq + h) * a.Sq;
            float* dst = (tid < BQ ? sLse : sDelta) + st * BQ + r;
            cp_async4(dst, valid ? src + q0 + r : src, valid);
        }
    };

    load_tile<D, BK, NT>(sK, a.k + b * a.k_b + hk * a.k_h, a.k_s, k0, a.Sk, tid);
    load_tile<D, BK, NT>(sV, a.v + b * a.v_b + hk * a.v_h, a.v_s, k0, a.Sk, tid);
    if (n_iter > 0) load_q(0, 0);
    cp_async_commit();

    const int row = warp * 16 + g;  // key row of c0/c1 in the tile; row + 8 holds c2/c3
    float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

    for (int it = 0; it < n_iter; ++it) {
        const int st = it & 1;
        const int q0 = (qb_first + it % nq) * BQ;
        if (it + 1 < n_iter) load_q(it + 1, st ^ 1);
        cp_async_commit();
        cp_async_wait<1>();
        __syncthreads();
        const bf16* cQ = sQ + st * BQ * LD;
        const bf16* cdO = sdO + st * BQ * LD;
        const float* cLse = sLse + st * BQ;
        const float* cDelta = sDelta + st * BQ;

        float sT[BQ / 8][4], dpT[BQ / 8][4];  // Sᵀ and dPᵀ: keys × queries
#pragma unroll
        for (int n = 0; n < BQ / 8; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) sT[n][e] = dpT[n][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
            uint32_t ka[4], va[4];
            load_a(ka, sK, LD, warp * 16, kk * 16, lane);
            load_a(va, sV, LD, warp * 16, kk * 16, lane);
#pragma unroll
            for (int n = 0; n < BQ / 16; ++n) {
                uint32_t bf[4];
                load_b_nk(bf, cQ, LD, n * 16, kk * 16, lane);
                mma16816(sT[2 * n], ka, bf[0], bf[1]);
                mma16816(sT[2 * n + 1], ka, bf[2], bf[3]);
                load_b_nk(bf, cdO, LD, n * 16, kk * 16, lane);
                mma16816(dpT[2 * n], va, bf[0], bf[1]);
                mma16816(dpT[2 * n + 1], va, bf[2], bf[3]);
            }
        }
        const bool masked = needs_mask(a.causal, a.q_off, a.k_off, q0, BQ, k0, BK, a.Sq, a.Sk);
#pragma unroll
        for (int n = 0; n < BQ / 8; ++n) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int qcol = n * 8 + 2 * t + (e & 1);
                bool ok = true;
                if (masked) {
                    const int kpos = k0 + row + (e >> 1) * 8;
                    const int qpos = q0 + qcol;
                    ok = kpos < a.Sk && qpos < a.Sq &&
                         (!a.causal || a.q_off + qpos >= a.k_off + kpos);
                }
                const float p = ok ? __expf(sT[n][e] * a.scale - cLse[qcol]) : 0.f;
                sT[n][e] = p;
                dpT[n][e] = p * (dpT[n][e] - cDelta[qcol]);  // dSᵀ
            }
        }
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk) {
            uint32_t pa[4], sa[4];
            c_to_a(pa, sT[2 * kk], sT[2 * kk + 1]);
            c_to_a(sa, dpT[2 * kk], dpT[2 * kk + 1]);
#pragma unroll
            for (int n = 0; n < D / 16; ++n) {
                uint32_t bf[4];
                load_b_kn(bf, cdO, LD, kk * 16, n * 16, lane);
                mma16816(dv[2 * n], pa, bf[0], bf[1]);
                mma16816(dv[2 * n + 1], pa, bf[2], bf[3]);
                load_b_kn(bf, cQ, LD, kk * 16, n * 16, lane);
                mma16816(dk[2 * n], sa, bf[0], bf[1]);
                mma16816(dk[2 * n + 1], sa, bf[2], bf[3]);
            }
        }
        __syncthreads();  // this stage is refilled by the next iteration
    }
    cp_async_wait<0>();

#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int kpos = k0 + row + i * 8;
        if (kpos < a.Sk) {
            bf16* dK = a.dk + b * a.dk_b + (long long)kpos * a.dk_s + hk * a.dk_h;
            bf16* dV = a.dv + b * a.dv_b + (long long)kpos * a.dv_s + hk * a.dv_h;
#pragma unroll
            for (int n = 0; n < D / 8; ++n) {
                *reinterpret_cast<uint32_t*>(dK + n * 8 + 2 * t) =
                    pack_bf16(dk[n][2 * i] * a.scale, dk[n][2 * i + 1] * a.scale);
                *reinterpret_cast<uint32_t*>(dV + n * 8 + 2 * t) =
                    pack_bf16(dv[n][2 * i], dv[n][2 * i + 1]);
            }
        }
    }
}

template <int D>
cudaError_t launch_dkv(const BwdArgs& a, int B, cudaStream_t stream) {
    const int smem = dkv_smem_bytes<D>();
    cudaError_t err = allow_smem(flash_dkv_kernel<D>, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((a.Sk + DKV_BK - 1) / DKV_BK, B * a.Hkv);
    flash_dkv_kernel<D><<<grid, 32 * DKV_WARPS, smem, stream>>>(a);
    return cudaGetLastError();
}

}  // namespace flash

// strides: q, k, v, dout, dk, dv, each (b, s, h), in elements.
extern "C" int flash_dkv(const void* q, const void* k, const void* v, const void* dout,
                         const void* lse, const void* delta, void* dk, void* dv,
                         const long long* strides, int B, int Sq, int Sk, int Hq, int Hkv, int D,
                         int causal, int q_off, int k_off, float scale, void* stream) {
    using namespace flash;
    BwdArgs a = {};
    a.q = static_cast<const bf16*>(q);
    a.k = static_cast<const bf16*>(k);
    a.v = static_cast<const bf16*>(v);
    a.dout = static_cast<const bf16*>(dout);
    a.lse = static_cast<const float*>(lse);
    a.delta = static_cast<const float*>(delta);
    a.dk = static_cast<bf16*>(dk);
    a.dv = static_cast<bf16*>(dv);
    a.q_b = strides[0]; a.q_s = strides[1]; a.q_h = strides[2];
    a.k_b = strides[3]; a.k_s = strides[4]; a.k_h = strides[5];
    a.v_b = strides[6]; a.v_s = strides[7]; a.v_h = strides[8];
    a.do_b = strides[9]; a.do_s = strides[10]; a.do_h = strides[11];
    a.dk_b = strides[12]; a.dk_s = strides[13]; a.dk_h = strides[14];
    a.dv_b = strides[15]; a.dv_s = strides[16]; a.dv_h = strides[17];
    a.Sq = Sq; a.Sk = Sk; a.Hq = Hq; a.Hkv = Hkv;
    a.causal = causal; a.q_off = q_off; a.k_off = k_off; a.scale = scale;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (D) {
        case 32: return launch_dkv<32>(a, B, s);
        case 64: return launch_dkv<64>(a, B, s);
        case 128: return launch_dkv<128>(a, B, s);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}
