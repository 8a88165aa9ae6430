// Flash-attention backward, dK/dV pass, for Hopper (sm_90a).
//
// Replaces: accelerate_tpu/ops/pallas_flash.py:_dkv_kernel (launched by _bwd).
// dV = Σ Pᵀ·dO and dK = scale · Σ dSᵀ·Q, summed over the query tiles AND
// the query heads of the GQA group, so dK/dV come out at KV-head
// resolution. P and dS are recomputed from q, k, v, dO, lse and δ as in the
// dQ pass.
//
// Bound on the H100: four S×S×D products per (b, head) at ~4·S·D FLOP per
// byte read: bound by tensor-core operations at the training shapes, which
// reach their rate only through wgmma fed from shared memory.
//
// Design: one block per (b, kv_head, 128-key tile), the heaviest causal
// tiles of every head first, so each dK/dV row is written once by one
// block: no atomics, and the result is deterministic. Three warpgroups,
// specialised:
// - the producer warpgroup gives its registers up (setmaxnreg.dec); one
//   thread loads the K and V tiles once by TMA, then streams the work items
//   (group head, 64-query tile from the causal diagonal on) through a ring
//   of two stages: the Q and dO tiles by TMA, while the lanes of its warp
//   copy that tile's lse and δ rows (a TMA copy of them would need Sq to be
//   a multiple of 4, for 16-byte aligned rows); the stage's full barrier
//   waits for the bytes and the 32 lanes;
// - two consumer warpgroups (setmaxnreg.inc) own 64 keys each and keep
//   their dK and dV accumulators (64 keys × D, fp32) in registers. Per item:
//   Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ as wgmma m64n64k16 with both operands from
//   shared memory (K-major); P (exp2 with the scale folded in, lse kept in
//   base 2) and dS = P∘(dP − δ) in registers; then dV += Pᵀ·dO and
//   dK += dSᵀ·Q with Pᵀ and dSᵀ as register A operands of the input's
//   16-bit type (bf16 or f16) and dO and Q
//   read MN-major (the transpose bit). The products run as asynchronous
//   groups, so that P is computed while dPᵀ is, and dS while dV is. A
//   warpgroup whose 64 keys the causal mask hides from a whole item skips
//   its products. The 64-query item keeps Sᵀ and dPᵀ at 32 registers each
//   beside the 2·D/2 of the accumulators, under the 240 of setmaxnreg.
// At D = 256 the dK and dV accumulators (64 keys × 256 fp32 each) would
// need 256 registers a thread, above the 255 a thread can address. So the
// grid's third dimension splits D: a block writes dK and dV for one half
// of the columns (two m64n128 accumulators, the registers of D = 128) and
// recomputes Sᵀ and dPᵀ over the whole D, which the other half's block
// computes too (1.5 times the products of one pass). Its work items shrink
// to 32 queries, so that the K and V tiles (128 KB) and a ring of two Q
// and dO stages (64 KB) fit in shared memory.
// TMA reads the tensors in place through their strides and zero-fills rows
// past Sq or Sk; the scores of queries past Sq are masked.
#include "hopper_common.cuh"

namespace flash {

constexpr int DKV_BN = 128;  // keys of a block: 64 per consumer warpgroup
constexpr int DKV_STAGES = 2;
constexpr int DKV_THREADS = 384;

template <int D>
struct DkvSmem {
    static constexpr int BM = D > 128 ? 32 : 64;    // queries of a work item
    static constexpr int DN = D > 128 ? 128 : D;    // dK/dV columns of a block
    static constexpr int SPLIT = D / DN;            // blocks along D (grid z)
    static constexpr int KV_TILE = DKV_BN * D * 2;  // bytes of the K or the V tile
    static constexpr int Q_TILE = BM * D * 2;       // bytes of one Q or dO tile
    static constexpr int STATS = BM * 4;            // bytes of one lse or δ row
    static constexpr int BYTES =
        1024 + 2 * KV_TILE + DKV_STAGES * (2 * Q_TILE + 2 * STATS);  // + alignment slack
};

template <int D, typename T>
__global__ void __launch_bounds__(DKV_THREADS, 1)
    flash_dkv_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const __grid_constant__ CUtensorMap tm_do, const BwdArgs<T> a) {
    using L = Swz<D>;
    using M = DkvSmem<D>;
    constexpr int DKV_BM = M::BM;
    extern __shared__ unsigned char smem_raw[];
    __shared__ __align__(8) uint64_t kv_full, full[DKV_STAGES], empty[DKV_STAGES];
    unsigned char* sK = align1024(smem_raw);
    unsigned char* sV = sK + M::KV_TILE;
    unsigned char* sQ = sV + M::KV_TILE;                 // [stage] tiles
    unsigned char* sdO = sQ + DKV_STAGES * M::Q_TILE;    // [stage] tiles
    float* sLse = reinterpret_cast<float*>(sdO + DKV_STAGES * M::Q_TILE);  // [stage][DKV_BM]
    float* sDelta = sLse + DKV_STAGES * DKV_BM;                            // [stage][DKV_BM]

    const int kb = blockIdx.y;  // every head's heaviest causal tile first
    const int b = blockIdx.x / a.Hkv, hk = blockIdx.x % a.Hkv;
    const int rep = a.Hq / a.Hkv;
    const int k0 = kb * DKV_BN;
    const int col0 = blockIdx.z * M::DN;  // first dK/dV column of this block

    // Query tiles from the first that sees any key of this block under the
    // causal mask; the work list runs over (group head, query tile).
    const int nqb = (a.Sq + DKV_BM - 1) / DKV_BM;
    int qb_first = 0;
    if (a.causal) {
        const long long first = (long long)a.k_off + k0 - a.q_off - (DKV_BM - 1);
        qb_first = first <= 0 ? 0 : (int)((first + DKV_BM - 1) / DKV_BM);
    }
    const int nq = qb_first < nqb ? nqb - qb_first : 0;
    const int n_iter = rep * nq;
    const int wg = threadIdx.x / 128;

    if (threadIdx.x == 0) {
        mbar_init(&kv_full, 1);
        for (int s = 0; s < DKV_STAGES; ++s) {
            mbar_init(&full[s], 32);  // every lane of the producer warp
            mbar_init(&empty[s], 8);  // one arrival per consumer warp
        }
        mbar_init_fence();
    }
    __syncthreads();

    if (wg == 0) {
        // Producer: warp 0 streams the work items; its lane 0 issues the TMA
        // loads, and each lane copies two lse and two δ values of the item
        // and then arrives, so the stage is full when both have landed.
        reg_dealloc<24>();
        const int lane = threadIdx.x;
        if (lane < 32) {
            if (lane == 0) {
                mbar_arrive_tx(&kv_full, 2 * M::KV_TILE);
                for (int c = 0; c < L::CHUNKS; ++c) {
                    tma_load_4d(sK + c * DKV_BN * L::ROW, &tm_k, &kv_full, c * L::ELEMS, hk, k0, b);
                    tma_load_4d(sV + c * DKV_BN * L::ROW, &tm_v, &kv_full, c * L::ELEMS, hk, k0, b);
                }
            }
            for (int it = 0; it < n_iter; ++it) {
                const int st = it % DKV_STAGES;
                const int h = hk * rep + it / nq;
                const int q0 = (qb_first + it % nq) * DKV_BM;
                mbar_wait(&empty[st], ((it / DKV_STAGES) & 1) ^ 1);
                if (lane == 0) {
                    mbar_expect_tx(&full[st], 2 * M::Q_TILE);
                    unsigned char* q_dst = sQ + st * M::Q_TILE;
                    unsigned char* do_dst = sdO + st * M::Q_TILE;
                    for (int c = 0; c < L::CHUNKS; ++c) {
                        tma_load_4d(q_dst + c * DKV_BM * L::ROW, &tm_q, &full[st], c * L::ELEMS, h,
                                    q0, b);
                        tma_load_4d(do_dst + c * DKV_BM * L::ROW, &tm_do, &full[st],
                                    c * L::ELEMS, h, q0, b);
                    }
                }
                // lse in base 2, for exp2; the scores of queries past Sq are
                // masked, and their row statistics are 0 here.
                const long long row = ((long long)b * a.Hq + h) * a.Sq + q0;
                for (int r = lane; r < DKV_BM; r += 32) {
                    const bool valid = q0 + r < a.Sq;
                    sLse[st * DKV_BM + r] = valid ? a.lse[row + r] * LOG2E : 0.f;
                    sDelta[st * DKV_BM + r] = valid ? a.delta[row + r] : 0.f;
                }
                mbar_arrive(&full[st]);
            }
        }
    } else {
        // Consumers: warpgroup cw owns keys k0 + 64cw .. k0 + 64cw + 63.
        reg_alloc<240>();
        const int cw = wg - 1;
        const int lane = threadIdx.x % 32, w = (threadIdx.x % 128) / 32;
        const int g = lane / 4, t = lane % 4;
        const int kw0 = k0 + cw * 64;           // first key of this warpgroup
        const int krow = kw0 + w * 16 + g;      // key of d[4j], d[4j+1]; krow + 8 of the rest
        const float scale_log2 = a.scale * LOG2E;

        float dk[M::DN / 2], dv[M::DN / 2];
#pragma unroll
        for (int i = 0; i < M::DN / 2; ++i) dk[i] = dv[i] = 0.f;
        mbar_wait(&kv_full, 0);

        for (int it = 0; it < n_iter; ++it) {
            const int st = it % DKV_STAGES;
            const int q0 = (qb_first + it % nq) * DKV_BM;
            mbar_wait(&full[st], (it / DKV_STAGES) & 1);
            const bool hidden = kw0 >= a.Sk ||
                                (a.causal && (long long)a.q_off + q0 + DKV_BM - 1 <
                                                 (long long)a.k_off + kw0);
            if (!hidden) {
                const uint32_t aK = opaque(smem_addr(sK)), aV = opaque(smem_addr(sV));
                const uint32_t aQ = opaque(smem_addr(sQ + st * M::Q_TILE));
                const uint32_t adO = opaque(smem_addr(sdO + st * M::Q_TILE));
                const float* cLse = sLse + st * DKV_BM;
                const float* cDelta = sDelta + st * DKV_BM;
                const bool masked = needs_mask(a.causal, a.q_off, a.k_off, q0, DKV_BM, kw0, 64,
                                               a.Sq, a.Sk);

                // Sᵀ and dPᵀ (64 keys × 64 queries) as two groups in flight.
                float sT[DKV_BM / 2], dpT[DKV_BM / 2];
                wgmma_fence();
#pragma unroll
                for (int kk = 0; kk < D / 16; ++kk)
                    wgmma_ss<DKV_BM, T>(sT, desc_k_major<D>(aK, DKV_BN, cw * 64, kk),
                                        desc_k_major<D>(aQ, DKV_BM, 0, kk), kk > 0);
                wgmma_commit();
#pragma unroll
                for (int kk = 0; kk < D / 16; ++kk)
                    wgmma_ss<DKV_BM, T>(dpT, desc_k_major<D>(aV, DKV_BN, cw * 64, kk),
                                        desc_k_major<D>(adO, DKV_BM, 0, kk), kk > 0);
                wgmma_commit();

                // P while dPᵀ is computed, then dV += Pᵀ·dO while dS is.
                // Pᵀ and dSᵀ as A operands: k-step kk covers queries
                // 16kk..16kk+15, the accumulators' n8 tiles 2kk and 2kk+1.
                wgmma_wait<1>();
                fence_regs(sT);
#pragma unroll
                for (int j = 0; j < DKV_BM / 8; ++j) {
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        const int qcol = j * 8 + 2 * t + (e & 1);
                        bool ok = true;
                        if (masked) {
                            const int kpos = krow + (e >> 1) * 8;
                            const int qpos = q0 + qcol;
                            ok = kpos < a.Sk && qpos < a.Sq &&
                                 (!a.causal || a.q_off + qpos >= a.k_off + kpos);
                        }
                        float& x = sT[4 * j + e];
                        x = ok ? exp2_approx(fmaf(x, scale_log2, -cLse[qcol])) : 0.f;
                    }
                }
                uint32_t pa[DKV_BM / 16][4];
#pragma unroll
                for (int kk = 0; kk < DKV_BM / 16; ++kk)
#pragma unroll
                    for (int r = 0; r < 4; ++r)
                        pa[kk][r] = pack2<T>(sT[8 * kk + 2 * r], sT[8 * kk + 2 * r + 1]);
                wgmma_fence();
                fence_regs(dv);
#pragma unroll
                for (int kk = 0; kk < DKV_BM / 16; ++kk)
                    wgmma_rs<M::DN, T>(
                        dv, pa[kk],
                        desc_mn_major<D>(adO + column_offset<D>(DKV_BM, col0), DKV_BM, kk), 1);
                wgmma_commit();

                wgmma_wait<1>();  // dPᵀ is done; dV may still run
                fence_regs(dpT);
                uint32_t sa[DKV_BM / 16][4];
#pragma unroll
                for (int kk = 0; kk < DKV_BM / 16; ++kk) {
#pragma unroll
                    for (int r = 0; r < 4; ++r) {
                        const int j = 2 * kk + r / 2, e = 2 * (r % 2);  // n8 tile, first element
                        const float d0 = cDelta[j * 8 + 2 * t], d1 = cDelta[j * 8 + 2 * t + 1];
                        const float p0 = sT[4 * j + e], p1 = sT[4 * j + e + 1];
                        sa[kk][r] = pack2<T>(p0 * (dpT[4 * j + e] - d0),
                                             p1 * (dpT[4 * j + e + 1] - d1));  // dSᵀ
                    }
                }
                wgmma_fence();
                fence_regs(dk);
#pragma unroll
                for (int kk = 0; kk < DKV_BM / 16; ++kk)
                    wgmma_rs<M::DN, T>(
                        dk, sa[kk],
                        desc_mn_major<D>(aQ + column_offset<D>(DKV_BM, col0), DKV_BM, kk), 1);
                wgmma_commit();
                wgmma_wait<0>();
                fence_regs(dv);
                fence_regs(dk);
            }
            if (lane == 0) mbar_arrive(&empty[st]);  // this warp is done with the stage
        }

#pragma unroll
        for (int i = 0; i < 2; ++i) {
            const int kpos = krow + i * 8;
            if (kpos < a.Sk) {
                T* dK = a.dk + b * a.dk_b + (long long)kpos * a.dk_s + hk * a.dk_h + col0;
                T* dV = a.dv + b * a.dv_b + (long long)kpos * a.dv_s + hk * a.dv_h + col0;
#pragma unroll
                for (int j = 0; j < M::DN / 8; ++j) {
                    *reinterpret_cast<uint32_t*>(dK + j * 8 + 2 * t) =
                        pack2<T>(dk[4 * j + 2 * i] * a.scale, dk[4 * j + 2 * i + 1] * a.scale);
                    *reinterpret_cast<uint32_t*>(dV + j * 8 + 2 * t) =
                        pack2<T>(dv[4 * j + 2 * i], dv[4 * j + 2 * i + 1]);
                }
            }
        }
    }
}

template <int D, typename T>
cudaError_t launch_dkv(const BwdArgs<T>& a, const long long* st, int B, cudaStream_t stream) {
    using M = DkvSmem<D>;
    CUtensorMap tm_q, tm_k, tm_v, tm_do;
    if (!make_rows_map<D, T>(&tm_q, a.q, B, a.Sq, a.Hq, st[0], st[1], st[2], M::BM) ||
        !make_rows_map<D, T>(&tm_k, a.k, B, a.Sk, a.Hkv, st[3], st[4], st[5], DKV_BN) ||
        !make_rows_map<D, T>(&tm_v, a.v, B, a.Sk, a.Hkv, st[6], st[7], st[8], DKV_BN) ||
        !make_rows_map<D, T>(&tm_do, a.dout, B, a.Sq, a.Hq, st[9], st[10], st[11], M::BM))
        return cudaErrorInvalidValue;
    cudaError_t err = allow_smem(flash_dkv_kernel<D, T>, M::BYTES);
    if (err != cudaSuccess) return err;
    const dim3 grid(B * a.Hkv, (a.Sk + DKV_BN - 1) / DKV_BN, M::SPLIT);
    flash_dkv_kernel<D, T><<<grid, DKV_THREADS, M::BYTES, stream>>>(tm_q, tm_k, tm_v, tm_do, a);
    return cudaGetLastError();
}

template <typename T>
int launch_dkv_typed(const void* q, const void* k, const void* v, const void* dout,
                     const void* lse, const void* delta, void* dk, void* dv, const long long* st,
                     int B, int Sq, int Sk, int Hq, int Hkv, int D, int causal, int q_off,
                     int k_off, float scale, cudaStream_t s) {
    BwdArgs<T> a = {};
    a.q = static_cast<const T*>(q);
    a.k = static_cast<const T*>(k);
    a.v = static_cast<const T*>(v);
    a.dout = static_cast<const T*>(dout);
    a.lse = static_cast<const float*>(lse);
    a.delta = static_cast<const float*>(delta);
    a.dk = static_cast<T*>(dk);
    a.dv = static_cast<T*>(dv);
    a.dk_b = st[12]; a.dk_s = st[13]; a.dk_h = st[14];
    a.dv_b = st[15]; a.dv_s = st[16]; a.dv_h = st[17];
    a.Sq = Sq; a.Sk = Sk; a.Hq = Hq; a.Hkv = Hkv;
    a.causal = causal; a.q_off = q_off; a.k_off = k_off; a.scale = scale;
    switch (D) {
        case 64: return launch_dkv<64, T>(a, st, B, s);
        case 128: return launch_dkv<128, T>(a, st, B, s);
        case 256: return launch_dkv<256, T>(a, st, B, s);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

}  // namespace flash

// strides: q, k, v, dout, dk, dv, each (b, s, h), in elements. dtype: 0 bf16, 1 f16.
extern "C" int flash_dkv(const void* q, const void* k, const void* v, const void* dout,
                         const void* lse, const void* delta, void* dk, void* dv,
                         const long long* strides, int B, int Sq, int Sk, int Hq, int Hkv, int D,
                         int dtype, int causal, int q_off, int k_off, float scale,
                         void* stream) {
    using namespace flash;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0)
        return launch_dkv_typed<bf16>(q, k, v, dout, lse, delta, dk, dv, strides, B, Sq, Sk, Hq,
                                      Hkv, D, causal, q_off, k_off, scale, s);
    if (dtype == 1)
        return launch_dkv_typed<f16>(q, k, v, dout, lse, delta, dk, dv, strides, B, Sq, Sk, Hq,
                                     Hkv, D, causal, q_off, k_off, scale, s);
    return static_cast<int>(cudaErrorInvalidValue);
}
