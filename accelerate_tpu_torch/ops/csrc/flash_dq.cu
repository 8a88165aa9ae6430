// Flash-attention backward, dQ pass, for Hopper (sm_90a).
//
// Replaces: accelerate_tpu/ops/pallas_flash.py:_dq_kernel (launched by _bwd).
// Recomputes P = exp(S·scale − lse) under the causal and key-padding mask,
// then dS = P∘(dP − δ) with dP = dO·Vᵀ, and dQ = scale · Σ_k dS·K. δ is
// rowsum(dO∘O) − g_lse, computed outside the kernel (as on the TPU), so the
// lse cotangent of ring attention's chunk merge flows through here.
//
// Bound on the H100: three S×S×D products per (b, head) at ~3·S·D FLOP per
// byte read: bound by tensor-core operations (0.1043 ms at the training
// shapes B=4, S=2048, H=16, D=128, causal), which reach their rate only
// through wgmma fed from shared memory.
//
// Design: flash_dkv.cu with queries and keys swapped. One block per
// (b, q_head, 128-query tile), the heaviest causal tiles of every head
// first, so each dQ row is written once by one block: no atomics, and the
// result is deterministic. Three warpgroups, specialised:
// - the producer warpgroup gives its registers up (setmaxnreg.dec); one
//   thread loads the Q and dO tiles once by TMA, then streams the K and V
//   tiles of 64 keys, up to the causal diagonal of the runtime offsets,
//   through a ring of two stages with full and empty mbarriers;
// - two consumer warpgroups (setmaxnreg.inc) own 64 queries each and keep
//   their dQ accumulator (64 queries × D, fp32) in registers beside the lse
//   (in base 2) and δ of their rows, read once from global memory. Per key
//   tile: S = Q·Kᵀ and dP = dO·Vᵀ as wgmma m64n64k16 with both operands
//   from shared memory (K-major); P (one FFMA and one exp2 per score) while
//   dP is computed; dS = P∘(dP − δ) packed as register A operands of the
//   input's 16-bit type (bf16 or f16);
//   then dQ += dS·K with K read MN-major from the same tile (the transpose
//   bit). The dS·K product of one tile runs under the S and dP products of
//   the next; a warp releases a stage after the wait that retires its dS·K.
//   Each warpgroup stops at its own causal diagonal, so the first skips
//   the last key tile when its queries see none of it.
// At D = 256 the dQ accumulator (64 queries × 256 fp32, 128 registers a
// thread) is held as two column halves, each the accumulator of an
// m64n128 product over its half of K, and the key tile shrinks to 32 so
// that S, dP and dS fit beside it and the ring fits in 192 KB.
// TMA reads the tensors in place through their strides and zero-fills rows
// past Sq or Sk; scores of keys past Sk are masked, and rows past Sq are
// not written.
#include "hopper_common.cuh"

namespace flash {

constexpr int DQ_BM = 128;  // queries of a block: 64 per consumer warpgroup
constexpr int DQ_STAGES = 2;
constexpr int DQ_THREADS = 384;

template <int D>
struct DqSmem {
    static constexpr int BN = D > 128 ? 32 : 64;   // keys of a K/V tile
    static constexpr int DN = D > 128 ? 128 : D;   // columns of one dQ accumulator
    static constexpr int NH = D / DN;              // dQ accumulators along D
    static constexpr int Q_TILE = DQ_BM * D * 2;   // bytes of the Q or the dO tile
    static constexpr int KV_TILE = BN * D * 2;     // bytes of one K or V tile
    static constexpr int BYTES = 1024 + 2 * Q_TILE + 2 * DQ_STAGES * KV_TILE;  // + alignment slack
};

template <int D, typename T>
__global__ void __launch_bounds__(DQ_THREADS, 1)
    flash_dq_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const __grid_constant__ CUtensorMap tm_do, const BwdArgs<T> a) {
    using L = Swz<D>;
    using M = DqSmem<D>;
    constexpr int DQ_BN = M::BN;
    extern __shared__ unsigned char smem_raw[];
    __shared__ __align__(8) uint64_t q_full, full[DQ_STAGES], empty[DQ_STAGES];
    unsigned char* sQ = align1024(smem_raw);
    unsigned char* sdO = sQ + M::Q_TILE;
    unsigned char* sK = sdO + M::Q_TILE;              // [stage] tiles
    unsigned char* sV = sK + DQ_STAGES * M::KV_TILE;  // [stage] tiles

    const int qb = gridDim.y - 1 - blockIdx.y;  // every head's heaviest causal tile first
    const int b = blockIdx.x / a.Hq, h = blockIdx.x % a.Hq;
    const int hk = h / (a.Hq / a.Hkv);
    const int q0 = qb * DQ_BM;
    const int nkt = (a.Sk + DQ_BN - 1) / DQ_BN;
    const int nkb = causal_key_blocks(nkt, a.causal, a.q_off, a.k_off, q0, DQ_BM, DQ_BN);
    const int wg = threadIdx.x / 128;

    if (threadIdx.x == 0) {
        mbar_init(&q_full, 1);
        for (int s = 0; s < DQ_STAGES; ++s) {
            mbar_init(&full[s], 1);
            mbar_init(&empty[s], 8);  // one arrival per consumer warp
        }
        mbar_init_fence();
    }
    __syncthreads();

    if (wg == 0) {
        // Producer: one thread issues every load. The ring runs to the
        // block's causal diagonal, which is the second warpgroup's, so every
        // tile loaded is waited for.
        reg_dealloc<24>();
        if (threadIdx.x == 0) {
            mbar_arrive_tx(&q_full, 2 * M::Q_TILE);
            for (int c = 0; c < L::CHUNKS; ++c) {
                tma_load_4d(sQ + c * DQ_BM * L::ROW, &tm_q, &q_full, c * L::ELEMS, h, q0, b);
                tma_load_4d(sdO + c * DQ_BM * L::ROW, &tm_do, &q_full, c * L::ELEMS, h, q0, b);
            }
            for (int kb = 0; kb < nkb; ++kb) {
                const int st = kb % DQ_STAGES;
                mbar_wait(&empty[st], ((kb / DQ_STAGES) & 1) ^ 1);
                mbar_arrive_tx(&full[st], 2 * M::KV_TILE);
                unsigned char* k_dst = sK + st * M::KV_TILE;
                unsigned char* v_dst = sV + st * M::KV_TILE;
                for (int c = 0; c < L::CHUNKS; ++c) {
                    tma_load_4d(k_dst + c * DQ_BN * L::ROW, &tm_k, &full[st], c * L::ELEMS, hk,
                                kb * DQ_BN, b);
                    tma_load_4d(v_dst + c * DQ_BN * L::ROW, &tm_v, &full[st], c * L::ELEMS, hk,
                                kb * DQ_BN, b);
                }
            }
        }
    } else {
        // Consumers: warpgroup cw owns queries q0 + 64cw .. q0 + 64cw + 63.
        // Tile kb issues S and dP, waits for dS·K of tile kb−1 and S, computes
        // P while dP runs, then dS, and issues dS·K. Each wait is
        // unconditional, so that ptxas keeps every product chain asynchronous.
        reg_alloc<240>();
        const int cw = wg - 1;
        const int lane = threadIdx.x % 32, w = (threadIdx.x % 128) / 32;
        const int g = lane / 4, t = lane % 4;
        const int qw0 = q0 + cw * 64;        // first query of this warpgroup
        const int qrow = qw0 + w * 16 + g;   // query of d[4j], d[4j+1]; qrow + 8 of the rest
        const int nkw = causal_key_blocks(nkt, a.causal, a.q_off, a.k_off, qw0, 64, DQ_BN);
        const float scale_log2 = a.scale * LOG2E;

        // lse in base 2, for exp2; rows past Sq are not written, and their
        // statistics are 0 here.
        const long long stat = ((long long)b * a.Hq + h) * a.Sq;
        float lse2[2], delta[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            const int qpos = qrow + i * 8;
            lse2[i] = qpos < a.Sq ? a.lse[stat + qpos] * LOG2E : 0.f;
            delta[i] = qpos < a.Sq ? a.delta[stat + qpos] : 0.f;
        }

        float dq[M::NH][M::DN / 2];  // column half h holds columns h·DN..
#pragma unroll
        for (int hh = 0; hh < M::NH; ++hh)
#pragma unroll
            for (int i = 0; i < M::DN / 2; ++i) dq[hh][i] = 0.f;
        float s[DQ_BN / 2], dp[DQ_BN / 2];
        uint32_t ds[DQ_BN / 16][4];  // dS of the tile, the A operand of dS·K

        auto issue_s_dp = [&](int kb) {
            const int st = kb % DQ_STAGES;
            const uint32_t aQ = opaque(smem_addr(sQ)), adO = opaque(smem_addr(sdO));
            const uint32_t aK = opaque(smem_addr(sK + st * M::KV_TILE));
            const uint32_t aV = opaque(smem_addr(sV + st * M::KV_TILE));
            mbar_wait(&full[st], (kb / DQ_STAGES) & 1);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < D / 16; ++kk)
                wgmma_ss<DQ_BN, T>(s, desc_k_major<D>(aQ, DQ_BM, cw * 64, kk),
                                   desc_k_major<D>(aK, DQ_BN, 0, kk), kk > 0);
            wgmma_commit();
#pragma unroll
            for (int kk = 0; kk < D / 16; ++kk)
                wgmma_ss<DQ_BN, T>(dp, desc_k_major<D>(adO, DQ_BM, cw * 64, kk),
                                   desc_k_major<D>(aV, DQ_BN, 0, kk), kk > 0);
            wgmma_commit();
        };
        // P of the complete S, in place.
        auto probs = [&](int kb) {
            fence_regs(s);
            const int k0 = kb * DQ_BN;
            const bool masked =
                needs_mask(a.causal, a.q_off, a.k_off, qw0, 64, k0, DQ_BN, a.Sq, a.Sk);
#pragma unroll
            for (int j = 0; j < DQ_BN / 8; ++j) {
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    bool ok = true;
                    if (masked) {
                        const int qpos = qrow + (e >> 1) * 8;
                        const int kpos = k0 + j * 8 + 2 * t + (e & 1);
                        ok = kpos < a.Sk && (!a.causal || a.q_off + qpos >= a.k_off + kpos);
                    }
                    float& x = s[4 * j + e];
                    x = ok ? exp2_approx(fmaf(x, scale_log2, -lse2[e >> 1])) : 0.f;
                }
            }
        };
        // dS = P∘(dP − δ) of the complete dP, packed as the A operand: k-step
        // kk covers keys 16kk..16kk+15, the accumulators' n8 tiles 2kk and
        // 2kk+1; register r holds row g + 8·(r % 2).
        auto grads = [&]() {
            fence_regs(dp);
#pragma unroll
            for (int kk = 0; kk < DQ_BN / 16; ++kk) {
#pragma unroll
                for (int r = 0; r < 4; ++r) {
                    const int x = 8 * kk + 2 * r;
                    const float d = delta[r % 2];
                    ds[kk][r] = pack2<T>(s[x] * (dp[x] - d), s[x + 1] * (dp[x + 1] - d));
                }
            }
        };
        auto issue_dq = [&](int kb) {
            const uint32_t aK = opaque(smem_addr(sK + (kb % DQ_STAGES) * M::KV_TILE));
            wgmma_fence();
            fence_regs(dq);
#pragma unroll
            for (int kk = 0; kk < DQ_BN / 16; ++kk)
#pragma unroll
                for (int hh = 0; hh < M::NH; ++hh)
                    wgmma_rs<M::DN, T>(
                        dq[hh], ds[kk],
                        desc_mn_major<D>(aK + column_offset<D>(DQ_BN, hh * M::DN), DQ_BN, kk), 1);
            wgmma_commit();
        };
        auto release = [&](int kb) {
            fence_regs(dq);
            if (lane == 0) mbar_arrive(&empty[kb % DQ_STAGES]);  // this warp is done with K_kb
        };

        mbar_wait(&q_full, 0);
        if (nkw > 0) {
            issue_s_dp(0);
            wgmma_wait<1>();  // S is done; dP may still run
            probs(0);
            wgmma_wait<0>();
            grads();
            issue_dq(0);
            for (int kb = 1; kb < nkw; ++kb) {
                issue_s_dp(kb);
                wgmma_wait<1>();  // dS·K of tile kb−1 and S are done; dP may still run
                release(kb - 1);
                probs(kb);
                wgmma_wait<0>();
                grads();
                issue_dq(kb);
            }
            wgmma_wait<0>();
            release(nkw - 1);
        }

        // A warpgroup that saw no key writes the zeros it holds.
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            const int qpos = qrow + i * 8;
            if (qpos < a.Sq) {
                T* dQ = a.dq + b * a.dq_b + (long long)qpos * a.dq_s + h * a.dq_h;
#pragma unroll
                for (int hh = 0; hh < M::NH; ++hh)
#pragma unroll
                    for (int j = 0; j < M::DN / 8; ++j)
                        *reinterpret_cast<uint32_t*>(dQ + hh * M::DN + j * 8 + 2 * t) =
                            pack2<T>(dq[hh][4 * j + 2 * i] * a.scale,
                                     dq[hh][4 * j + 2 * i + 1] * a.scale);
            }
        }
    }
}

template <int D, typename T>
cudaError_t launch_dq(const BwdArgs<T>& a, const long long* st, int B, cudaStream_t stream) {
    using M = DqSmem<D>;
    CUtensorMap tm_q, tm_k, tm_v, tm_do;
    if (!make_rows_map<D, T>(&tm_q, a.q, B, a.Sq, a.Hq, st[0], st[1], st[2], DQ_BM) ||
        !make_rows_map<D, T>(&tm_k, a.k, B, a.Sk, a.Hkv, st[3], st[4], st[5], M::BN) ||
        !make_rows_map<D, T>(&tm_v, a.v, B, a.Sk, a.Hkv, st[6], st[7], st[8], M::BN) ||
        !make_rows_map<D, T>(&tm_do, a.dout, B, a.Sq, a.Hq, st[9], st[10], st[11], DQ_BM))
        return cudaErrorInvalidValue;
    cudaError_t err = allow_smem(flash_dq_kernel<D, T>, M::BYTES);
    if (err != cudaSuccess) return err;
    const dim3 grid(B * a.Hq, (a.Sq + DQ_BM - 1) / DQ_BM);
    flash_dq_kernel<D, T><<<grid, DQ_THREADS, M::BYTES, stream>>>(tm_q, tm_k, tm_v, tm_do, a);
    return cudaGetLastError();
}

template <typename T>
int launch_dq_typed(const void* q, const void* k, const void* v, const void* dout,
                    const void* lse, const void* delta, void* dq, const long long* st, int B,
                    int Sq, int Sk, int Hq, int Hkv, int D, int causal, int q_off, int k_off,
                    float scale, cudaStream_t s) {
    BwdArgs<T> a = {};
    a.q = static_cast<const T*>(q);
    a.k = static_cast<const T*>(k);
    a.v = static_cast<const T*>(v);
    a.dout = static_cast<const T*>(dout);
    a.lse = static_cast<const float*>(lse);
    a.delta = static_cast<const float*>(delta);
    a.dq = static_cast<T*>(dq);
    a.dq_b = st[12]; a.dq_s = st[13]; a.dq_h = st[14];
    a.Sq = Sq; a.Sk = Sk; a.Hq = Hq; a.Hkv = Hkv;
    a.causal = causal; a.q_off = q_off; a.k_off = k_off; a.scale = scale;
    switch (D) {
        case 64: return launch_dq<64, T>(a, st, B, s);
        case 128: return launch_dq<128, T>(a, st, B, s);
        case 256: return launch_dq<256, T>(a, st, B, s);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

}  // namespace flash

// strides: q, k, v, dout, dq, each (b, s, h), in elements. dtype: 0 bf16, 1 f16.
extern "C" int flash_dq(const void* q, const void* k, const void* v, const void* dout,
                        const void* lse, const void* delta, void* dq, const long long* strides,
                        int B, int Sq, int Sk, int Hq, int Hkv, int D, int dtype, int causal,
                        int q_off, int k_off, float scale, void* stream) {
    using namespace flash;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0)
        return launch_dq_typed<bf16>(q, k, v, dout, lse, delta, dq, strides, B, Sq, Sk, Hq, Hkv,
                                     D, causal, q_off, k_off, scale, s);
    if (dtype == 1)
        return launch_dq_typed<f16>(q, k, v, dout, lse, delta, dq, strides, B, Sq, Sk, Hq, Hkv,
                                    D, causal, q_off, k_off, scale, s);
    return static_cast<int>(cudaErrorInvalidValue);
}
