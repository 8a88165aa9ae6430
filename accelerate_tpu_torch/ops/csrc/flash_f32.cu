// Flash attention for float32 inputs on Hopper's CUDA cores (sm_90a):
// forward, dQ and dK/dV.
//
// Replaces: accelerate_tpu/ops/pallas_flash.py:_fwd_kernel, _dq_kernel and
// _dkv_kernel for float32 q, k and v. The Pallas kernels compute in the
// input's dtype with fp32 accumulation, so fp32 inputs get fp32 products.
// wgmma has no fp32 form (its 32-bit operands are tf32, 10 mantissa bits,
// and K-major only), so these kernels multiply in full fp32 with FMA on the
// CUDA cores. The 16-bit inputs go to the wgmma kernels of flash_fwd.cu,
// flash_dq.cu and flash_dkv.cu, whose semantics these follow: GQA, runtime
// q/k offsets, the causal mask, ragged tails, lse = m + log(l) with a fully
// masked row giving out = 0 and lse ~ -1e30, δ folded in outside.
//
// Bound on the H100: operations, at 67 TFLOP/s of fp32 FMA (2 FLOP each);
// at the training shapes the kernels do ~2·S·D FLOP per byte read.
//
// Design: the simple one. A block of 256 threads owns 64 rows (queries in
// the forward and dQ, keys in dK/dV) and streams tiles of BN rows of the
// other side (64, or 32 at D = 256, so that every tile fits in shared
// memory) with plain loads through the tensors' strides; rows are padded to
// D + 1 floats so that no two lanes of a warp read one bank. Thread
// (ty, tx) = (tid / 16, tid % 16) owns rows 4ty..4ty+3 and, of a score
// tile, columns tx + 16j; of an output tile, head-dim columns tx + 16c, in
// registers. A score tile goes through shared memory to its second product
// (P·V, dS·K, Pᵀ·dO, dSᵀ·Q). Row maxima and sums reduce over the 16 lanes
// of a row's half-warp. No double buffering and no tensor cores: the
// simple form, 2-5 times slower than SDPA in fp32 on an H100 (ROADMAP.md
// Queue B.2).
#include "flash_common.cuh"

namespace flash {

constexpr int F32_THREADS = 256;
constexpr int F32_BM = 64;  // rows a block owns

template <int D>
struct F32Cfg {
    static constexpr int BN = D > 128 ? 32 : 64;  // rows of a streamed tile
    static constexpr int LD = D + 1;              // padded row of a D-wide tile
    static constexpr int LS = BN + 1;             // padded row of the score tile
    static constexpr int NJ = BN / 16;            // score columns of a thread
    static constexpr int NC = D / 16;             // head-dim columns of a thread
};

struct F32Args {
    const float *q, *k, *v, *dout;
    const float *lse, *delta;  // (B, Hq, Sq), contiguous
    float *o, *lse_out, *dq, *dk, *dv;
    long long st[18];  // element strides (b, s, h) of q, k, v, then out or dout and the outputs
    int Sq, Sk, Hq, Hkv, causal, q_off, k_off;
    float scale;
};

// rows r0..r0+rows-1 (zero past `limit`) of head h, batch b of a (B, S, H, D)
// tensor into a tile of `rows` rows of LD floats.
template <int D, int ROWS>
__device__ __forceinline__ void load_rows(float* tile, const float* base, const long long* st,
                                          int b, int h, int r0, int limit) {
    constexpr int LD = F32Cfg<D>::LD;
    for (int i = threadIdx.x; i < ROWS * D; i += F32_THREADS) {
        const int r = i / D, d = i % D;
        float x = 0.f;
        if (r0 + r < limit) x = base[b * st[0] + (long long)(r0 + r) * st[1] + h * st[2] + d];
        tile[r * LD + d] = x;
    }
}

// Sum and maximum over the 16 lanes (tx) that share a row.
__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
    for (int o = 1; o < 16; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
    return x;
}

__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
    for (int o = 1; o < 16; o <<= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
    return x;
}

// s[i][j] = Σ_d A[4ty + i][d] · B[tx + 16j][d], both tiles of LD floats.
template <int D>
__device__ __forceinline__ void score_tile(float (&s)[4][F32Cfg<D>::NJ], const float* A,
                                           const float* B, int ty, int tx) {
    using C = F32Cfg<D>;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < C::NJ; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
        float a[4], bb[C::NJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = A[(4 * ty + i) * C::LD + d];
#pragma unroll
        for (int j = 0; j < C::NJ; ++j) bb[j] = B[(tx + 16 * j) * C::LD + d];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < C::NJ; ++j) s[i][j] = fmaf(a[i], bb[j], s[i][j]);
    }
}

// acc[i][c] += Σ_n S[4ty + i][n] · B[n][tx + 16c] over the `n` rows of the
// tile B (LD floats a row), S of LS floats a row.
template <int D>
__device__ __forceinline__ void accumulate(float (&acc)[4][F32Cfg<D>::NC], const float* S,
                                           const float* B, int n, int ty, int tx) {
    using C = F32Cfg<D>;
    for (int r = 0; r < n; ++r) {
        float p[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) p[i] = S[(4 * ty + i) * C::LS + r];
#pragma unroll
        for (int c = 0; c < C::NC; ++c) {
            const float x = B[r * C::LD + tx + 16 * c];
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(p[i], x, acc[i][c]);
        }
    }
}

template <int D>
__device__ __forceinline__ void store_rows(float* base, const long long* st, int b, int h,
                                           int r0, int limit,
                                           const float (&acc)[4][F32Cfg<D>::NC], float mul,
                                           int ty, int tx) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int r = r0 + 4 * ty + i;
        if (r < limit) {
            float* row = base + b * st[0] + (long long)r * st[1] + h * st[2];
#pragma unroll
            for (int c = 0; c < F32Cfg<D>::NC; ++c) row[tx + 16 * c] = acc[i][c] * mul;
        }
    }
}

__device__ __forceinline__ bool visible(const F32Args& a, int qpos, int kpos) {
    return qpos < a.Sq && kpos < a.Sk && (!a.causal || a.q_off + qpos >= a.k_off + kpos);
}

template <int D>
__global__ void __launch_bounds__(F32_THREADS)
    flash_fwd_f32_kernel(const __grid_constant__ F32Args a) {
    using C = F32Cfg<D>;
    extern __shared__ float smem[];
    float* sQ = smem;                  // [F32_BM][LD]
    float* sK = sQ + F32_BM * C::LD;   // [BN][LD]
    float* sV = sK + C::BN * C::LD;    // [BN][LD]
    float* sS = sV + C::BN * C::LD;    // [F32_BM][LS]
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
    const int q0 = (gridDim.y - 1 - blockIdx.y) * F32_BM;  // heaviest causal tiles first
    const int b = blockIdx.x / a.Hq, h = blockIdx.x % a.Hq, hk = h / (a.Hq / a.Hkv);
    const long long* st = a.st;
    const int nkb = causal_key_blocks((a.Sk + C::BN - 1) / C::BN, a.causal, a.q_off, a.k_off,
                                      q0, F32_BM, C::BN);
    load_rows<D, F32_BM>(sQ, a.q, st, b, h, q0, a.Sq);

    float acc[4][C::NC], m[4], l[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        m[i] = -INFINITY;
        l[i] = 0.f;  // this lane's partial row sum
#pragma unroll
        for (int c = 0; c < C::NC; ++c) acc[i][c] = 0.f;
    }
    for (int kb = 0; kb < nkb; ++kb) {
        const int k0 = kb * C::BN;
        __syncthreads();  // the last tile is read
        load_rows<D, C::BN>(sK, a.k, st + 3, b, hk, k0, a.Sk);
        load_rows<D, C::BN>(sV, a.v, st + 6, b, hk, k0, a.Sk);
        __syncthreads();
        float s[4][C::NJ];
        score_tile<D>(s, sQ, sK, ty, tx);
        const bool masked = needs_mask(a.causal, a.q_off, a.k_off, q0, F32_BM, k0, C::BN, a.Sq,
                                       a.Sk);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            float mx = m[i];
#pragma unroll
            for (int j = 0; j < C::NJ; ++j) {
                s[i][j] *= a.scale;
                const int kpos = k0 + tx + 16 * j;
                if (masked && (kpos >= a.Sk || (a.causal && a.q_off + q0 + 4 * ty + i <
                                                                a.k_off + kpos)))
                    s[i][j] = -INFINITY;
                mx = fmaxf(mx, s[i][j]);
            }
            const float m_new = row_max16(mx);
            // While every key so far is masked the maximum is -inf, and
            // exp of -inf minus a base of 0 gives the 0 those keys add.
            const float base = m_new == -INFINITY ? 0.f : m_new;
            const float alpha = expf(m[i] - base);
            m[i] = m_new;
            l[i] *= alpha;
#pragma unroll
            for (int c = 0; c < C::NC; ++c) acc[i][c] *= alpha;
#pragma unroll
            for (int j = 0; j < C::NJ; ++j) {
                const float p = expf(s[i][j] - base);
                l[i] += p;
                sS[(4 * ty + i) * C::LS + tx + 16 * j] = p;
            }
        }
        __syncthreads();
        accumulate<D>(acc, sS, sV, C::BN, ty, tx);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const float l_safe = fmaxf(row_sum16(l[i]), 1e-30f);
        const int qpos = q0 + 4 * ty + i;
        if (qpos < a.Sq && tx == 0) {
            // A row with no visible key has lse = NEG_INF + log(1e-30).
            const float m_row = m[i] == -INFINITY ? NEG_INF : m[i];
            a.lse_out[((long long)b * a.Hq + h) * a.Sq + qpos] = m_row + logf(l_safe);
        }
        const float inv = 1.f / l_safe;
#pragma unroll
        for (int c = 0; c < C::NC; ++c) acc[i][c] *= inv;
    }
    store_rows<D>(a.o, st + 9, b, h, q0, a.Sq, acc, 1.f, ty, tx);
}

template <int D>
__global__ void __launch_bounds__(F32_THREADS)
    flash_dq_f32_kernel(const __grid_constant__ F32Args a) {
    using C = F32Cfg<D>;
    extern __shared__ float smem[];
    float* sQ = smem;                    // [F32_BM][LD]
    float* sdO = sQ + F32_BM * C::LD;    // [F32_BM][LD]
    float* sK = sdO + F32_BM * C::LD;    // [BN][LD]
    float* sV = sK + C::BN * C::LD;      // [BN][LD]
    float* sS = sV + C::BN * C::LD;      // [F32_BM][LS]
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
    const int q0 = (gridDim.y - 1 - blockIdx.y) * F32_BM;
    const int b = blockIdx.x / a.Hq, h = blockIdx.x % a.Hq, hk = h / (a.Hq / a.Hkv);
    const long long* st = a.st;
    const int nkb = causal_key_blocks((a.Sk + C::BN - 1) / C::BN, a.causal, a.q_off, a.k_off,
                                      q0, F32_BM, C::BN);
    load_rows<D, F32_BM>(sQ, a.q, st, b, h, q0, a.Sq);
    load_rows<D, F32_BM>(sdO, a.dout, st + 9, b, h, q0, a.Sq);
    float lse[4], delta[4], dq[4][C::NC];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int qpos = q0 + 4 * ty + i;
        const long long row = ((long long)b * a.Hq + h) * a.Sq + qpos;
        lse[i] = qpos < a.Sq ? a.lse[row] : 0.f;
        delta[i] = qpos < a.Sq ? a.delta[row] : 0.f;
#pragma unroll
        for (int c = 0; c < C::NC; ++c) dq[i][c] = 0.f;
    }
    for (int kb = 0; kb < nkb; ++kb) {
        const int k0 = kb * C::BN;
        __syncthreads();
        load_rows<D, C::BN>(sK, a.k, st + 3, b, hk, k0, a.Sk);
        load_rows<D, C::BN>(sV, a.v, st + 6, b, hk, k0, a.Sk);
        __syncthreads();
        float s[4][C::NJ], dp[4][C::NJ];
        score_tile<D>(s, sQ, sK, ty, tx);
        score_tile<D>(dp, sdO, sV, ty, tx);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < C::NJ; ++j) {
                const int qpos = q0 + 4 * ty + i, kpos = k0 + tx + 16 * j;
                const float p = visible(a, qpos, kpos) ? expf(s[i][j] * a.scale - lse[i]) : 0.f;
                sS[(4 * ty + i) * C::LS + tx + 16 * j] = p * (dp[i][j] - delta[i]);
            }
        __syncthreads();
        accumulate<D>(dq, sS, sK, C::BN, ty, tx);
    }
    store_rows<D>(a.dq, st + 12, b, h, q0, a.Sq, dq, a.scale, ty, tx);
}

template <int D>
__global__ void __launch_bounds__(F32_THREADS)
    flash_dkv_f32_kernel(const __grid_constant__ F32Args a) {
    using C = F32Cfg<D>;
    extern __shared__ float smem[];
    float* sK = smem;                     // [F32_BM][LD]
    float* sV = sK + F32_BM * C::LD;      // [F32_BM][LD]
    float* sQ = sV + F32_BM * C::LD;      // [BN][LD]
    float* sdO = sQ + C::BN * C::LD;      // [BN][LD]
    float* sS = sdO + C::BN * C::LD;      // [F32_BM][LS]: Pᵀ, then dSᵀ
    float* sLse = sS + F32_BM * C::LS;    // [BN]
    float* sDelta = sLse + C::BN;         // [BN]
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
    const int k0 = blockIdx.y * F32_BM;
    const int b = blockIdx.x / a.Hkv, hk = blockIdx.x % a.Hkv, rep = a.Hq / a.Hkv;
    const long long* st = a.st;
    // Query tiles from the first that sees any key of this block.
    const int nqb = (a.Sq + C::BN - 1) / C::BN;
    int qb_first = 0;
    if (a.causal) {
        const long long first = (long long)a.k_off + k0 - a.q_off - (C::BN - 1);
        qb_first = first <= 0 ? 0 : (int)((first + C::BN - 1) / C::BN);
    }
    load_rows<D, F32_BM>(sK, a.k, st + 3, b, hk, k0, a.Sk);
    load_rows<D, F32_BM>(sV, a.v, st + 6, b, hk, k0, a.Sk);
    float dk[4][C::NC], dv[4][C::NC];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < C::NC; ++c) dk[i][c] = dv[i][c] = 0.f;
    for (int h = hk * rep; h < (hk + 1) * rep; ++h) {
        for (int qb = qb_first; qb < nqb; ++qb) {
            const int q0 = qb * C::BN;
            __syncthreads();
            load_rows<D, C::BN>(sQ, a.q, st, b, h, q0, a.Sq);
            load_rows<D, C::BN>(sdO, a.dout, st + 9, b, h, q0, a.Sq);
            for (int r = threadIdx.x; r < C::BN; r += F32_THREADS) {
                const long long row = ((long long)b * a.Hq + h) * a.Sq + q0 + r;
                sLse[r] = q0 + r < a.Sq ? a.lse[row] : 0.f;
                sDelta[r] = q0 + r < a.Sq ? a.delta[row] : 0.f;
            }
            __syncthreads();
            float p[4][C::NJ], dp[4][C::NJ];
            score_tile<D>(p, sK, sQ, ty, tx);  // Sᵀ: keys × queries
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < C::NJ; ++j) {
                    const int kpos = k0 + 4 * ty + i, qcol = tx + 16 * j;
                    p[i][j] = visible(a, q0 + qcol, kpos)
                                  ? expf(p[i][j] * a.scale - sLse[qcol]) : 0.f;
                    sS[(4 * ty + i) * C::LS + qcol] = p[i][j];
                }
            __syncthreads();
            accumulate<D>(dv, sS, sdO, C::BN, ty, tx);  // dV += Pᵀ·dO
            score_tile<D>(dp, sV, sdO, ty, tx);         // dPᵀ
            __syncthreads();  // every thread has read Pᵀ
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < C::NJ; ++j) {
                    const int qcol = tx + 16 * j;
                    sS[(4 * ty + i) * C::LS + qcol] = p[i][j] * (dp[i][j] - sDelta[qcol]);
                }
            __syncthreads();
            accumulate<D>(dk, sS, sQ, C::BN, ty, tx);   // dK += dSᵀ·Q
        }
    }
    store_rows<D>(a.dk, st + 12, b, hk, k0, a.Sk, dk, a.scale, ty, tx);
    store_rows<D>(a.dv, st + 15, b, hk, k0, a.Sk, dv, 1.f, ty, tx);
}

template <int D>
constexpr int f32_smem(int kind) {  // 0 forward, 1 dQ, 2 dK/dV
    using C = F32Cfg<D>;
    const int rows = kind == 0 ? F32_BM + 2 * C::BN : 2 * F32_BM + 2 * C::BN;
    return 4 * (rows * C::LD + F32_BM * C::LS + (kind == 2 ? 2 * C::BN : 0));
}

template <int D>
cudaError_t launch_f32(int kind, const F32Args& a, int B, cudaStream_t stream) {
    const int smem = f32_smem<D>(kind);
    cudaError_t err;
    if (kind == 0) {
        err = allow_smem(flash_fwd_f32_kernel<D>, smem);
        if (err != cudaSuccess) return err;
        flash_fwd_f32_kernel<D><<<dim3(B * a.Hq, (a.Sq + F32_BM - 1) / F32_BM), F32_THREADS,
                                  smem, stream>>>(a);
    } else if (kind == 1) {
        err = allow_smem(flash_dq_f32_kernel<D>, smem);
        if (err != cudaSuccess) return err;
        flash_dq_f32_kernel<D><<<dim3(B * a.Hq, (a.Sq + F32_BM - 1) / F32_BM), F32_THREADS,
                                 smem, stream>>>(a);
    } else {
        err = allow_smem(flash_dkv_f32_kernel<D>, smem);
        if (err != cudaSuccess) return err;
        flash_dkv_f32_kernel<D><<<dim3(B * a.Hkv, (a.Sk + F32_BM - 1) / F32_BM), F32_THREADS,
                                  smem, stream>>>(a);
    }
    return cudaGetLastError();
}

inline int launch_f32_d(int kind, const F32Args& a, int B, int D, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (D) {
        case 64: return static_cast<int>(launch_f32<64>(kind, a, B, s));
        case 128: return static_cast<int>(launch_f32<128>(kind, a, B, s));
        case 256: return static_cast<int>(launch_f32<256>(kind, a, B, s));
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

inline F32Args f32_args(const void* q, const void* k, const void* v, const long long* st,
                        int n_st, int Sq, int Sk, int Hq, int Hkv, int causal, int q_off,
                        int k_off, float scale) {
    F32Args a = {};
    a.q = static_cast<const float*>(q);
    a.k = static_cast<const float*>(k);
    a.v = static_cast<const float*>(v);
    for (int i = 0; i < n_st; ++i) a.st[i] = st[i];
    a.Sq = Sq; a.Sk = Sk; a.Hq = Hq; a.Hkv = Hkv;
    a.causal = causal; a.q_off = q_off; a.k_off = k_off; a.scale = scale;
    return a;
}

}  // namespace flash

// The entry points take the arguments of flash_fwd, flash_dq and
// flash_dkv: strides (b, s, h) in elements of q, k, v, then out (forward),
// or dout and dq (dQ), or dout, dk and dv (dK/dV), copied into the
// kernel's arguments. dtype must be 2 (float32).
extern "C" int flash_fwd_f32(const void* q, const void* k, const void* v, void* out, void* lse,
                             const long long* strides, int B, int Sq, int Sk, int Hq, int Hkv,
                             int D, int dtype, int causal, int q_off, int k_off, float scale,
                             void* stream) {
    using namespace flash;
    if (dtype != 2) return static_cast<int>(cudaErrorInvalidValue);
    F32Args a = f32_args(q, k, v, strides, 12, Sq, Sk, Hq, Hkv, causal, q_off, k_off, scale);
    a.o = static_cast<float*>(out);
    a.lse_out = static_cast<float*>(lse);
    return launch_f32_d(0, a, B, D, stream);
}

extern "C" int flash_dq_f32(const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* delta, void* dq,
                            const long long* strides, int B, int Sq, int Sk, int Hq, int Hkv,
                            int D, int dtype, int causal, int q_off, int k_off, float scale,
                            void* stream) {
    using namespace flash;
    if (dtype != 2) return static_cast<int>(cudaErrorInvalidValue);
    F32Args a = f32_args(q, k, v, strides, 15, Sq, Sk, Hq, Hkv, causal, q_off, k_off, scale);
    a.dout = static_cast<const float*>(dout);
    a.lse = static_cast<const float*>(lse);
    a.delta = static_cast<const float*>(delta);
    a.dq = static_cast<float*>(dq);
    return launch_f32_d(1, a, B, D, stream);
}

extern "C" int flash_dkv_f32(const void* q, const void* k, const void* v, const void* dout,
                             const void* lse, const void* delta, void* dk, void* dv,
                             const long long* strides, int B, int Sq, int Sk, int Hq, int Hkv,
                             int D, int dtype, int causal, int q_off, int k_off, float scale,
                             void* stream) {
    using namespace flash;
    if (dtype != 2) return static_cast<int>(cudaErrorInvalidValue);
    F32Args a = f32_args(q, k, v, strides, 18, Sq, Sk, Hq, Hkv, causal, q_off, k_off, scale);
    a.dout = static_cast<const float*>(dout);
    a.lse = static_cast<const float*>(lse);
    a.delta = static_cast<const float*>(delta);
    a.dk = static_cast<float*>(dk);
    a.dv = static_cast<float*>(dv);
    return launch_f32_d(2, a, B, D, stream);
}
