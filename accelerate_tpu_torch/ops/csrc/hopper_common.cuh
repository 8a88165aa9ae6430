// Hopper primitives of the three flash-attention kernels (flash_fwd.cu,
// flash_dq.cu, flash_dkv.cu), for bf16 and f16 elements: TMA tensor-map loads that complete on
// mbarriers, wgmma shared-memory descriptors and products, setmaxnreg, named
// barriers, and the host code that encodes the tensor maps.
//
// Shared tiles. A tile of R rows of a (B, S, H, D) tensor is loaded by TMA
// as D / E chunks of E = min(64, D) head-dim elements; chunk c holds R rows
// of E·2 bytes (64 or 128), swizzled by the TMA unit with the same span
// (64B or 128B swizzle), and lies at c·R·E·2 bytes from the tile. The wgmma
// descriptors below read exactly that layout:
// - K-major (the reduction runs along D: Q and K in Q·Kᵀ, K and Q in K·Qᵀ,
//   dO and V in dO·Vᵀ): k-step kk (16 elements) starts at chunk
//   kk / (E/16), byte 32·(kk % (E/16)) of the row; 8-row groups are 8·E·2
//   bytes apart (SBO).
// - MN-major (the reduction runs along the rows: V in P·V, K in dS·K, dO
//   and Q in Pᵀ·dO and dSᵀ·Q; the transpose bit of 16-bit types): k-step kk
//   starts at row 16·kk; 8-row groups are 8·E·2 bytes apart (SBO) and the
//   E-wide chunks along D are R·E·2 bytes apart (LBO).
// Every tile starts on a 1024-byte boundary, so the swizzle phase is that of
// the tile's own rows.
//
// wgmma accumulators (m64nN, fp32): thread t of the warpgroup (warp w =
// t/32, g = (t%32)/4, q = t%4) holds d[4j+e] at row 16w + g + 8·(e>>1),
// column 8j + 2q + (e&1). The register A operand of m64k16 (16 columns of
// the 64 rows, as four 32-bit registers of bf16 or f16 pairs) is, per warp:
// a0 = (row 16w + g, columns 2q, 2q+1), a1 = (row + 8, the same columns),
// a2 = (row, columns 8 + 2q, 9 + 2q), a3 = (row + 8, those). So the
// accumulator's n8 tiles 2kk and 2kk+1, packed in order (d[8kk+2r],
// d[8kk+2r+1]) into register r, are the A operand of k-step kk.
#pragma once

#include <cuda.h>
#include <math.h>

#include "flash_common.cuh"

namespace flash {

// ---------------------------------------------------------------------------
// Shared-memory layout of a tile
// ---------------------------------------------------------------------------

template <int D>
struct Swz {
    static constexpr int ROW = D * 2 < 128 ? D * 2 : 128;  // bytes of one row of a chunk
    static constexpr int ELEMS = ROW / 2;                   // head-dim elements of a chunk
    static constexpr int CHUNKS = D / ELEMS;
    static constexpr int KSTEPS = ELEMS / 16;               // k16 steps inside one chunk
    static constexpr uint64_t LAYOUT = ROW == 128 ? 1 : 2;  // descriptor swizzle: 128B or 64B
};

// The first 1024-byte boundary of the shared window at or after p.
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
    return p + ((1024u - (smem_addr(p) & 1023u)) & 1023u);
}

__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint64_t layout) {
    return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)((lbo & 0x3FFFF) >> 4) << 16 |
           (uint64_t)((sbo & 0x3FFFF) >> 4) << 32 | layout << 62;
}

// A shared address the compiler cannot see through: descriptors built from
// it inside a loop are rebuilt there (two integer operations each) instead
// of being hoisted out of the loop and held in registers.
__device__ __forceinline__ uint32_t opaque(uint32_t x) {
    asm volatile("mov.b32 %0, %0;\n" : "+r"(x));
    return x;
}

// Operand whose reduction runs along D: rows row0.. of the tile of `rows`
// rows at shared address `tile`, k-step kk over D.
template <int D>
__device__ __forceinline__ uint64_t desc_k_major(uint32_t tile, int rows, int row0, int kk) {
    using L = Swz<D>;
    return make_desc(tile + (kk / L::KSTEPS) * rows * L::ROW + row0 * L::ROW +
                         (kk % L::KSTEPS) * 32,
                     16, 8 * L::ROW, L::LAYOUT);
}

// Operand whose reduction runs along the rows of the tile of `rows` rows at
// shared address `tile`: k-step kk covers rows 16kk..16kk+15, N runs along D.
template <int D>
__device__ __forceinline__ uint64_t desc_mn_major(uint32_t tile, int rows, int kk) {
    using L = Swz<D>;
    return make_desc(tile + kk * 16 * L::ROW, rows * L::ROW, 8 * L::ROW, L::LAYOUT);
}

// Byte offset, in a tile of `rows` rows, of head-dim column `col` (a
// multiple of the chunk width): an MN-major operand over columns col.. of
// the tile starts there. A product whose N would pass 128 (D = 256) is
// split into column ranges this way.
template <int D>
__host__ __device__ constexpr int column_offset(int rows, int col) {
    return col / Swz<D>::ELEMS * rows * Swz<D>::ROW;
}

// ---------------------------------------------------------------------------
// mbarriers and TMA
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_addr(bar)), "r"(count)
                 : "memory");
}

// Make the initialised barriers visible to the other threads and to TMA.
__device__ __forceinline__ void mbar_init_fence() {
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(smem_addr(bar)) : "memory");
}

// Arrive and add `bytes` to the transaction count the phase waits for.
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// Add `bytes` to the transaction count of the current phase, without arriving.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
    asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;\n"
                 :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// Wait until the phase of parity `parity` has completed. The retry loop is
// one asm block with no other exit: a branch here that the producer and
// consumer paths share (a time-out, say) keeps ptxas from giving the
// consumers the registers of their setmaxnreg, and they spill.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
    asm volatile(
        "{\n.reg .pred P1;\n"
        "LAB_WAIT:\n"
        "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
        "@P1 bra DONE;\n"
        "bra LAB_WAIT;\n"
        "DONE:\n}\n"
        :: "r"(smem_addr(bar)), "r"(parity) : "memory");
}

// Copy the box at (c0, c1, c2, c3) of a 4-D tensor map into shared memory;
// completion is counted in bytes on `bar`. Rows outside the tensor read 0.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
        :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)),
           "r"(c0), "r"(c1), "r"(c2), "r"(c3)
        : "memory");
}

// ---------------------------------------------------------------------------
// Warp specialisation
// ---------------------------------------------------------------------------

template <int R>
__device__ __forceinline__ void reg_alloc() {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(R));
}

template <int R>
__device__ __forceinline__ void reg_dealloc() {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(R));
}

// 2^x on the special-function unit; 2^-inf = 0.
__device__ __forceinline__ float exp2_approx(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
}

// Named barriers (ids 1..15; 0 is __syncthreads) over `n` threads.
template <int N>
__device__ __forceinline__ void named_sync(int id) {
    asm volatile("bar.sync %0, %1;\n" :: "r"(id), "n"(N) : "memory");
}

template <int N>
__device__ __forceinline__ void named_arrive(int id) {
    asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "n"(N) : "memory");
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

// Order this warpgroup's register and shared-memory writes before the
// wgmma products that follow.
__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of an accumulator across
// the asynchronous products that own it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

template <int H, int N>
__device__ __forceinline__ void fence_regs(float (&d)[H][N]) {
#pragma unroll
    for (int h = 0; h < H; ++h) fence_regs(d[h]);
}

// d (m64nN, fp32) = A·B + (scale_d ? d : 0), A and B of the 16-bit type T
// (bf16 or f16) from shared memory, both K-major.
template <int N, typename T>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db, int scale_d);

// d (m64nN, fp32) = A·B + (scale_d ? d : 0), A of type T from registers (the
// layout in the header, per warp 16 rows), B from shared memory, MN-major.
template <int N, typename T>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db,
                                         int scale_d);

// The instructions, one macro per shape with the element type's PTX name
// (TY: "bf16" or "f16") as its argument; f16 and bf16 operands share every
// layout and the transpose bit.

#define FLASH_WGMMA_SS_N32(TY) \
    asm volatile( \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n" \
        "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " {" \
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15" \
        "}, %16, %17, p, 1, 1, 0, 0;\n}\n" \
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), \
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), \
        "+f"(d[14]), "+f"(d[15]) \
        : "l"(da), "l"(db), "r"(scale_d))

#define FLASH_WGMMA_SS_N64(TY) \
    asm volatile( \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n" \
        "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {" \
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31" \
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n" \
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), \
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), \
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), \
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]) \
        : "l"(da), "l"(db), "r"(scale_d))

#define FLASH_WGMMA_SS_N128(TY) \
    asm volatile( \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n" \
        "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {" \
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63" \
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n" \
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), \
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), \
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), \
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), \
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), \
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), \
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), \
        "+f"(d[62]), "+f"(d[63]) \
        : "l"(da), "l"(db), "r"(scale_d))

#define FLASH_WGMMA_RS_N64(TY) \
    asm volatile( \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n" \
        "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {" \
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31" \
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n" \
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), \
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), \
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), \
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]) \
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d))

#define FLASH_WGMMA_RS_N128(TY) \
    asm volatile( \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n" \
        "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {" \
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63" \
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n" \
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), \
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), \
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), \
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), \
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), \
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), \
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), \
        "+f"(d[62]), "+f"(d[63]) \
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d))

template <>
__device__ __forceinline__ void wgmma_ss<32, bf16>(float (&d)[16], uint64_t da, uint64_t db,
                                                  int scale_d) {
    FLASH_WGMMA_SS_N32("bf16");
}

template <>
__device__ __forceinline__ void wgmma_ss<32, f16>(float (&d)[16], uint64_t da, uint64_t db,
                                                  int scale_d) {
    FLASH_WGMMA_SS_N32("f16");
}

template <>
__device__ __forceinline__ void wgmma_ss<64, bf16>(float (&d)[32], uint64_t da, uint64_t db,
                                                  int scale_d) {
    FLASH_WGMMA_SS_N64("bf16");
}

template <>
__device__ __forceinline__ void wgmma_ss<64, f16>(float (&d)[32], uint64_t da, uint64_t db,
                                                  int scale_d) {
    FLASH_WGMMA_SS_N64("f16");
}

template <>
__device__ __forceinline__ void wgmma_ss<128, bf16>(float (&d)[64], uint64_t da, uint64_t db,
                                                  int scale_d) {
    FLASH_WGMMA_SS_N128("bf16");
}

template <>
__device__ __forceinline__ void wgmma_ss<128, f16>(float (&d)[64], uint64_t da, uint64_t db,
                                                  int scale_d) {
    FLASH_WGMMA_SS_N128("f16");
}

template <>
__device__ __forceinline__ void wgmma_rs<64, bf16>(float (&d)[32], const uint32_t (&a)[4],
                                                  uint64_t db, int scale_d) {
    FLASH_WGMMA_RS_N64("bf16");
}

template <>
__device__ __forceinline__ void wgmma_rs<64, f16>(float (&d)[32], const uint32_t (&a)[4],
                                                  uint64_t db, int scale_d) {
    FLASH_WGMMA_RS_N64("f16");
}

template <>
__device__ __forceinline__ void wgmma_rs<128, bf16>(float (&d)[64], const uint32_t (&a)[4],
                                                  uint64_t db, int scale_d) {
    FLASH_WGMMA_RS_N128("bf16");
}

template <>
__device__ __forceinline__ void wgmma_rs<128, f16>(float (&d)[64], const uint32_t (&a)[4],
                                                  uint64_t db, int scale_d) {
    FLASH_WGMMA_RS_N128("f16");
}

#undef FLASH_WGMMA_SS_N32
#undef FLASH_WGMMA_SS_N64
#undef FLASH_WGMMA_SS_N128
#undef FLASH_WGMMA_RS_N64
#undef FLASH_WGMMA_RS_N128

// ---------------------------------------------------------------------------
// Host: tensor maps
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime, so that the
// library needs no link against libcuda.
inline EncodeTiled encode_tiled() {
    static EncodeTiled fn = nullptr;
    if (fn == nullptr) {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
        cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &found);
#else
        cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                                  &found);
#endif
        if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
        fn = reinterpret_cast<EncodeTiled>(p);
    }
    return fn;
}

// The TMA data type of a 16-bit element type.
template <typename T>
constexpr CUtensorMapDataType tma_type();
template <>
constexpr CUtensorMapDataType tma_type<bf16>() { return CU_TENSOR_MAP_DATA_TYPE_BFLOAT16; }
template <>
constexpr CUtensorMapDataType tma_type<f16>() { return CU_TENSOR_MAP_DATA_TYPE_FLOAT16; }

// Boxes of `rows` rows by one chunk of a (B, S, H, D) tensor of the 16-bit
// type T, read in place through its element strides (each a multiple of 8:
// _check).
template <int D, typename T>
inline bool make_rows_map(CUtensorMap* map, const void* base, int B, int S, int H,
                          long long stride_b, long long stride_s, long long stride_h, int rows) {
    using L = Swz<D>;
    EncodeTiled encode = encode_tiled();
    if (encode == nullptr) return false;
    const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S, (cuuint64_t)B};
    const cuuint64_t strides[3] = {(cuuint64_t)stride_h * 2, (cuuint64_t)stride_s * 2,
                                   (cuuint64_t)stride_b * 2};
    const cuuint32_t box[4] = {(cuuint32_t)L::ELEMS, 1, (cuuint32_t)rows, 1};
    const cuuint32_t unit[4] = {1, 1, 1, 1};
    return encode(map, tma_type<T>(), 4, const_cast<void*>(base), dims,
                  strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                  L::ROW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace flash
