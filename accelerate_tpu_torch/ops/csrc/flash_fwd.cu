// Flash-attention forward for Hopper (sm_90a).
//
// Replaces: accelerate_tpu/ops/pallas_flash.py:_fwd_kernel (launched by _fwd).
// Computes causal (or full) online-softmax attention with GQA (query head h
// reads KV head h / (Hq/Hkv)), runtime q/k position offsets, key padding
// against the actual Sk, and returns out (in the input's 16-bit type, bf16
// or f16) and the row log-sum-exp lse = m + log(l) (fp32, (B, Hq, Sq)). A
// row with no visible key gives out = 0 and lse ~ -1e30, as the TPU kernel
// does. Built for D = 64, 128 and 256; the wrapper pads any other D up to
// the next of them with zero columns. fp32 inputs go to flash_f32.cu.
//
// Bound on the H100: at the training shapes (S=2048, D=128) the kernel does
// ~2·S·D FLOP per byte of q/k/v it must read, far above the card's ~295
// FLOP/byte ridge, so it is bound by tensor-core operations, which reach
// their rate only through wgmma fed from shared memory.
//
// Design: one block per (b, q_head, 128-query tile), the heaviest causal
// tiles of every head first. The grid is not persistent: a persistent
// version (one block per SM walking the tiles, the next tile's Q loaded
// under the last one's epilogue) was no faster on an H100 at the training
// shapes (PERF.md), so the simpler grid stays.
// Three warpgroups, specialised:
// - the producer warpgroup gives its registers up (setmaxnreg.dec) and one
//   thread issues TMA loads: the Q tile once, then the K and V tiles of 128
//   keys (64 at D = 256) into a ring of two stages, each stage with full and empty
//   mbarriers for K and for V, so that a K stage is refilled as soon as its
//   S = Q·Kᵀ is done;
// - two consumer warpgroups (setmaxnreg.inc) own 64 query rows each and keep
//   m, l and the output accumulator in registers. Iteration j issues
//   S_j = Q·K_jᵀ (wgmma m64n128k16, Q and K from shared memory, K-major) and
//   O += P_{j−1}·V_{j−1} (P as register A operands in the input's type,
//   as the TPU kernel casts P to v's dtype; V read MN-major through the
//   transpose bit) as two groups, then the online softmax of
//   S_j (exp2 with the scale folded in). ptxas places the softmax after the
//   wait for P·V; pinning it before that wait measured slower (PERF.md).
//   The two warpgroups take turns to issue their products (named
//   barriers), so one's softmax overlaps the other's products.
// At D = 256 the O accumulator (64 rows × 256 fp32, 128 registers a
// thread) is held as two column halves, each the accumulator of an
// m64n128 product over its half of V, and the key tile shrinks to 64 so
// that S and P fit beside it and the shared-memory ring (192 KB) fits.
// TMA reads q/k/v in place through their strides and zero-fills rows past
// Sq or Sk. The loop stops at the causal diagonal computed from the runtime
// offsets, and only tiles that straddle it (or the ragged tail) evaluate the
// element mask.
#include "hopper_common.cuh"

namespace flash {

template <typename T>
struct FwdArgs {
    T* o;
    float* lse;
    long long o_b, o_s, o_h;
    int Sq, Sk, Hq, Hkv, causal, q_off, k_off;
    float scale;
};

constexpr int FWD_BM = 128;  // query rows of a block: 64 per consumer warpgroup
constexpr int FWD_STAGES = 2;
constexpr int FWD_THREADS = 384;

template <int D>
struct FwdCfg {
    static constexpr int BN = D > 128 ? 64 : 128;  // keys of a K/V tile
    static constexpr int DN = D > 128 ? 128 : D;   // columns of one O accumulator
    static constexpr int NH = D / DN;              // O accumulators along D
    static constexpr int Q_TILE = FWD_BM * D * 2;  // bytes of the Q tile
    static constexpr int KV_TILE = BN * D * 2;     // bytes of one K or V tile
    static constexpr int BYTES = 1024 + Q_TILE + 2 * FWD_STAGES * KV_TILE;  // + alignment slack
};

template <int D, typename T>
__global__ void __launch_bounds__(FWD_THREADS, 1)
    flash_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v, const FwdArgs<T> a) {
    using L = Swz<D>;
    using C = FwdCfg<D>;
    constexpr int BN = C::BN, TILE = C::KV_TILE;
    extern __shared__ unsigned char smem_raw[];
    __shared__ __align__(8) uint64_t q_full, k_full[FWD_STAGES], v_full[FWD_STAGES],
        k_empty[FWD_STAGES], v_empty[FWD_STAGES];
    unsigned char* sQ = align1024(smem_raw);
    unsigned char* sK = sQ + C::Q_TILE;           // [stage] tiles
    unsigned char* sV = sK + FWD_STAGES * TILE;   // [stage] tiles

    const int qb = gridDim.y - 1 - blockIdx.y;  // every head's heaviest causal tile first
    const int b = blockIdx.x / a.Hq, h = blockIdx.x % a.Hq;
    const int hk = h / (a.Hq / a.Hkv);
    const int q0 = qb * FWD_BM;
    const int nkb = causal_key_blocks((a.Sk + BN - 1) / BN, a.causal, a.q_off, a.k_off, q0,
                                      FWD_BM, BN);
    const int wg = threadIdx.x / 128;

    if (threadIdx.x == 0) {
        mbar_init(&q_full, 1);
        for (int s = 0; s < FWD_STAGES; ++s) {
            mbar_init(&k_full[s], 1);
            mbar_init(&v_full[s], 1);
            mbar_init(&k_empty[s], 8);  // one arrival per consumer warp
            mbar_init(&v_empty[s], 8);
        }
        mbar_init_fence();
    }
    __syncthreads();

    if (wg == 0) {
        // Producer: one thread issues every load.
        reg_dealloc<24>();
        if (threadIdx.x == 0) {
            mbar_arrive_tx(&q_full, C::Q_TILE);
            for (int c = 0; c < L::CHUNKS; ++c)
                tma_load_4d(sQ + c * FWD_BM * L::ROW, &tm_q, &q_full, c * L::ELEMS, h, q0, b);
            for (int kb = 0; kb < nkb; ++kb) {
                const int st = kb % FWD_STAGES;
                const uint32_t free_parity = ((kb / FWD_STAGES) & 1) ^ 1;
                mbar_wait(&k_empty[st], free_parity);
                mbar_arrive_tx(&k_full[st], TILE);
                for (int c = 0; c < L::CHUNKS; ++c)
                    tma_load_4d(sK + st * TILE + c * BN * L::ROW, &tm_k, &k_full[st],
                                c * L::ELEMS, hk, kb * BN, b);
                mbar_wait(&v_empty[st], free_parity);
                mbar_arrive_tx(&v_full[st], TILE);
                for (int c = 0; c < L::CHUNKS; ++c)
                    tma_load_4d(sV + st * TILE + c * BN * L::ROW, &tm_v, &v_full[st],
                                c * L::ELEMS, hk, kb * BN, b);
            }
        }
    } else {
        // Consumers: warpgroup cw owns query rows 64cw..64cw+63 of the tile.
        // Iteration kb issues S = Q·K_kbᵀ and then O += P·V of tile kb−1,
        // then computes the softmax of S. The two warpgroups take turns to
        // issue their products (named barriers 1 and 2; warpgroup 0 first),
        // so that one's softmax runs beside the other's products. Each wait
        // is unconditional, so that ptxas keeps every product chain
        // asynchronous.
        reg_alloc<240>();
        const int cw = wg - 1;
        const int lane = threadIdx.x % 32, w = (threadIdx.x % 128) / 32;
        const int g = lane / 4, t = lane % 4;
        const int row = cw * 64 + w * 16 + g;  // tile row of d[4j], d[4j+1]; row + 8 of the rest
        const float scale_log2 = a.scale * LOG2E;

        float o[C::NH][C::DN / 2];  // column half h holds columns h·DN..
#pragma unroll
        for (int hh = 0; hh < C::NH; ++hh)
#pragma unroll
            for (int i = 0; i < C::DN / 2; ++i) o[hh][i] = 0.f;
        float m[2] = {-INFINITY, -INFINITY};  // running row maxima of the raw scores
        float l[2] = {0.f, 0.f};  // this lane's partial row sums; reduced at the end
        float s[BN / 2];
        uint32_t pa[BN / 16][4];  // P of the previous tile, the A operand of P·V
        float alpha[2];

        auto issue_qk = [&](int kb) {
            const int st = kb % FWD_STAGES;
            const uint32_t aQ = opaque(smem_addr(sQ));
            const uint32_t aK = opaque(smem_addr(sK + st * TILE));
            mbar_wait(&k_full[st], (kb / FWD_STAGES) & 1);
#pragma unroll
            for (int kk = 0; kk < D / 16; ++kk)
                wgmma_ss<BN, T>(s, desc_k_major<D>(aQ, FWD_BM, cw * 64, kk),
                                desc_k_major<D>(aK, BN, 0, kk), kk > 0);
            wgmma_commit();
        };
        auto issue_pv = [&](int kb) {
            const int st = kb % FWD_STAGES;
            const uint32_t aV = opaque(smem_addr(sV + st * TILE));
            mbar_wait(&v_full[st], (kb / FWD_STAGES) & 1);
            fence_regs(o);
#pragma unroll
            for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
                for (int hh = 0; hh < C::NH; ++hh)
                    wgmma_rs<C::DN, T>(
                        o[hh], pa[kk],
                        desc_mn_major<D>(aV + column_offset<D>(BN, hh * C::DN), BN, kk), 1);
            wgmma_commit();
        };
        // Masked online softmax of S = Q·K_kbᵀ (complete): P into s, the
        // running maxima and sums updated, the factor for O in alpha.
        auto softmax = [&](int kb) {
            fence_regs(s);
            if (lane == 0) mbar_arrive(&k_empty[kb % FWD_STAGES]);  // this warp has read K_kb
            const int k0 = kb * BN;
            if (needs_mask(a.causal, a.q_off, a.k_off, q0, FWD_BM, k0, BN, a.Sq, a.Sk)) {
#pragma unroll
                for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        const int qpos = q0 + row + (e >> 1) * 8;
                        const int kpos = k0 + j * 8 + 2 * t + (e & 1);
                        if (kpos >= a.Sk || (a.causal && a.q_off + qpos < a.k_off + kpos))
                            s[4 * j + e] = -INFINITY;
                    }
                }
            }
            float mx[2] = {m[0], m[1]};
#pragma unroll
            for (int j = 0; j < BN / 8; ++j) {
                mx[0] = fmaxf(mx[0], fmaxf(s[4 * j], s[4 * j + 1]));
                mx[1] = fmaxf(mx[1], fmaxf(s[4 * j + 2], s[4 * j + 3]));
            }
            float base[2];
#pragma unroll
            for (int i = 0; i < 2; ++i) {
                const float m_new = quad_max(mx[i]);
                // While every key so far is masked the maximum is -inf, and
                // exp2 of -inf minus a base of 0 gives the 0 those keys add.
                base[i] = m_new == -INFINITY ? 0.f : m_new * scale_log2;
                alpha[i] = exp2_approx(m[i] * scale_log2 - base[i]);
                m[i] = m_new;
                l[i] *= alpha[i];
            }
#pragma unroll
            for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    float& x = s[4 * j + e];
                    x = exp2_approx(fmaf(x, scale_log2, -base[e >> 1]));
                    l[e >> 1] += x;
                }
            }
        };
        // O scaled to the new maxima, and P packed as the A operand: k-step
        // kk covers keys 16kk..16kk+15, the accumulator's n8 tiles 2kk, 2kk+1.
        auto rescale_and_pack = [&]() {
#pragma unroll
            for (int hh = 0; hh < C::NH; ++hh) {
#pragma unroll
                for (int j = 0; j < C::DN / 8; ++j) {
                    o[hh][4 * j] *= alpha[0];
                    o[hh][4 * j + 1] *= alpha[0];
                    o[hh][4 * j + 2] *= alpha[1];
                    o[hh][4 * j + 3] *= alpha[1];
                }
            }
#pragma unroll
            for (int kk = 0; kk < BN / 16; ++kk) {
                pa[kk][0] = pack2<T>(s[8 * kk], s[8 * kk + 1]);
                pa[kk][1] = pack2<T>(s[8 * kk + 2], s[8 * kk + 3]);
                pa[kk][2] = pack2<T>(s[8 * kk + 4], s[8 * kk + 5]);
                pa[kk][3] = pack2<T>(s[8 * kk + 6], s[8 * kk + 7]);
            }
        };
        auto release_v = [&](int kb) {
            fence_regs(o);
            if (lane == 0) mbar_arrive(&v_empty[kb % FWD_STAGES]);  // this warp has read V_kb
        };

        mbar_wait(&q_full, 0);
        if (nkb > 0) {
            if (cw == 1) named_arrive<256>(1);
            named_sync<256>(1 + cw);
            wgmma_fence();
            issue_qk(0);
            named_arrive<256>(2 - cw);
            wgmma_wait<0>();
            softmax(0);
            rescale_and_pack();
            for (int kb = 1; kb < nkb; ++kb) {
                named_sync<256>(1 + cw);
                wgmma_fence();
                issue_qk(kb);
                issue_pv(kb - 1);
                named_arrive<256>(2 - cw);
                wgmma_wait<1>();  // S is done; P·V of tile kb−1 may still run
                softmax(kb);
                wgmma_wait<0>();
                release_v(kb - 1);
                rescale_and_pack();
            }
            named_sync<256>(1 + cw);
            wgmma_fence();
            issue_pv(nkb - 1);
            if (cw == 0) named_arrive<256>(2);
            wgmma_wait<0>();
            release_v(nkb - 1);
        }

#pragma unroll
        for (int i = 0; i < 2; ++i) {
            const float l_safe = fmaxf(quad_sum(l[i]), 1e-30f);
            const float inv = 1.f / l_safe;
            const int qpos = q0 + row + i * 8;
            if (qpos < a.Sq) {
                T* O = a.o + b * a.o_b + (long long)qpos * a.o_s + h * a.o_h;
#pragma unroll
                for (int hh = 0; hh < C::NH; ++hh)
#pragma unroll
                    for (int j = 0; j < C::DN / 8; ++j)
                        *reinterpret_cast<uint32_t*>(O + hh * C::DN + j * 8 + 2 * t) =
                            pack2<T>(o[hh][4 * j + 2 * i] * inv, o[hh][4 * j + 2 * i + 1] * inv);
                // A row with no visible key has lse = NEG_INF + log(1e-30).
                const float m_row = m[i] == -INFINITY ? NEG_INF : m[i] * a.scale;
                if (t == 0) a.lse[((long long)b * a.Hq + h) * a.Sq + qpos] = m_row + logf(l_safe);
            }
        }
    }
}

template <int D, typename T>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, const long long* st,
                       const FwdArgs<T>& a, int B, cudaStream_t stream) {
    using C = FwdCfg<D>;
    CUtensorMap tm_q, tm_k, tm_v;
    if (!make_rows_map<D, T>(&tm_q, q, B, a.Sq, a.Hq, st[0], st[1], st[2], FWD_BM) ||
        !make_rows_map<D, T>(&tm_k, k, B, a.Sk, a.Hkv, st[3], st[4], st[5], C::BN) ||
        !make_rows_map<D, T>(&tm_v, v, B, a.Sk, a.Hkv, st[6], st[7], st[8], C::BN))
        return cudaErrorInvalidValue;
    cudaError_t err = allow_smem(flash_fwd_kernel<D, T>, C::BYTES);
    if (err != cudaSuccess) return err;
    const dim3 grid(B * a.Hq, (a.Sq + FWD_BM - 1) / FWD_BM);
    flash_fwd_kernel<D, T><<<grid, FWD_THREADS, C::BYTES, stream>>>(tm_q, tm_k, tm_v, a);
    return cudaGetLastError();
}

template <typename T>
int launch_fwd_typed(const void* q, const void* k, const void* v, void* out, void* lse,
                     const long long* st, int B, int Sq, int Sk, int Hq, int Hkv, int D,
                     int causal, int q_off, int k_off, float scale, cudaStream_t s) {
    FwdArgs<T> a;
    a.o = static_cast<T*>(out);
    a.lse = static_cast<float*>(lse);
    a.o_b = st[9]; a.o_s = st[10]; a.o_h = st[11];
    a.Sq = Sq; a.Sk = Sk; a.Hq = Hq; a.Hkv = Hkv;
    a.causal = causal; a.q_off = q_off; a.k_off = k_off; a.scale = scale;
    switch (D) {
        case 64: return launch_fwd<64, T>(q, k, v, st, a, B, s);
        case 128: return launch_fwd<128, T>(q, k, v, st, a, B, s);
        case 256: return launch_fwd<256, T>(q, k, v, st, a, B, s);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

}  // namespace flash

// strides: q (b, s, h), k (b, s, h), v (b, s, h), out (b, s, h), in elements.
// dtype: 0 bf16, 1 f16.
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* out, void* lse,
                         const long long* strides, int B, int Sq, int Sk, int Hq, int Hkv, int D,
                         int dtype, int causal, int q_off, int k_off, float scale,
                         void* stream) {
    using namespace flash;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0)
        return launch_fwd_typed<bf16>(q, k, v, out, lse, strides, B, Sq, Sk, Hq, Hkv, D, causal,
                                      q_off, k_off, scale, s);
    if (dtype == 1)
        return launch_fwd_typed<f16>(q, k, v, out, lse, strides, B, Sq, Sk, Hq, Hkv, D, causal,
                                     q_off, k_off, scale, s);
    return static_cast<int>(cudaErrorInvalidValue);
}
