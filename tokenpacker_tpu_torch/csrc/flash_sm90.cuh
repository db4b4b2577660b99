// Hopper building blocks of the port's attention and GEMM kernels: K2's
// flash kernels (flash_fwd.cu, flash_bwd.cu; d = 128), K1's tower attention
// (vit_attention.cu; d = 64), K9's block products (vit_block.cu) and K8's
// int8 GEMM (s8_gemm.cu, which adds its own int8 wgmma): TMA tile
// loads completed on mbarriers (and cp.async for K2's full bias), wgmma
// products with operands in shared memory (SS) or A in registers (RS), and
// the host-side encoding of the tensor maps.
// sm_90a only (wgmma does not exist on plain sm_90).
//
// Shared-memory tiles. Every tile lands as "boxes" of 64 bf16 columns (128
// bytes a row): box c holds columns 64c..64c+63 of all the tile's rows,
// rows 128 bytes apart, with the 128-byte swizzle (the 16-byte chunk j of
// row r sits at chunk j ^ (r % 8)). A row of d = 128 (K2's q, k, v, o, dO)
// is two boxes, a row of d = 64 (K1's) one; K9's operands are cut into
// boxes of 64 columns too. TMA writes that layout
// (CU_TENSOR_MAP_SWIZZLE_128B) and wgmma reads it through a descriptor of
// layout type 1, so no thread touches the tile and the 8 rows a tensor core
// reads at once lie in different banks. Box bases are 1024-byte aligned, as
// the swizzle pattern requires.
//  - As a K-major operand (the reduction runs along the row: Q K^T, K Q^T,
//    dO V^T, V dO^T, K9's A = activation rows) the 16-wide slice kk of the
//    reduction starts at box kk / 4, byte (kk % 4) * 32 of the row; groups
//    of 8 rows are 1024 bytes apart (SBO). At d = 64 every slice lies in
//    the one box.
//  - As an MN-major B operand (the tile's rows are the reduction: P V,
//    P^T dO, dS^T Q, dS K, K9's [in, out] weights) the 16 rows of slice kk
//    start at byte kk * 2048; groups of 8 rows are 1024 bytes apart (SBO)
//    and neighbouring 64-column boxes one box apart (LBO); wgmma's
//    transpose bit for B.
//
// Accumulator fragments (m64nNk16, fp32): thread t of the warpgroup (warp
// w = t / 32, lane l) holds d[4j + e] at row 16w + l/4 + 8*(e >> 1) and
// column 8j + 2*(l % 4) + (e & 1). A register A fragment (bf16, m64k16)
// holds, for the same rows, columns 2*(l % 4) + {0, 1} (+8): so two
// neighbouring accumulator pairs pack into one A register, and a product's
// fp32 result becomes the next product's A operand without leaving the
// registers.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

namespace sm90 {

using bf16 = __nv_bfloat16;

constexpr int HEAD_DIM = 128;  // K2's (Vicuna-7B, MPT-7B); K1 and K9 take 64
constexpr int ROW_BYTES = 128;  // one box row: 64 bf16
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The dynamic shared memory rounded up to 1024 bytes (the launch asks for
// 1 KB more than the layout needs).
__device__ __forceinline__ unsigned char* align_1024(unsigned char* p) {
  const uint32_t a = smem_u32(p);
  return p + ((1024u - (a & 1023u)) & 1023u);
}

// ---- mbarriers ----------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// Arrives once and adds `bytes` to the transactions the current phase waits for.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Makes this thread's ordinary shared-memory writes visible to the async
// proxy (wgmma, TMA): a thread that fills an operand tile itself fences
// before it arrives on the barrier that the tile's readers wait on.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

// Spins until the phase of parity `parity` has completed. A phase that
// never completes (a copy that was never issued) traps after ~2^26 tries
// instead of hanging the card: the launch then fails with an error.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  for (uint32_t tries = 0;; ++tries) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (tries == (1u << 26)) __trap();
  }
}

// ---- TMA ----------------------------------------------------------------------------

// One box of a 4-D tensor map ({64 columns, 1 head, rows, 1 sample} here)
// at coordinates (c0 innermost) into `dst`; completes `bytes` on `bar`.
// Rows past the tensor's end arrive as zeros.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, int c3, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(smem_u32(bar))
      : "memory");
}

// One box of a 2-D tensor map ({64 columns, rows} of a row-major matrix)
// at coordinates (c0 = column, c1 = row) into `dst`; completes on `bar`.
// Rows past the matrix's end arrive as zeros.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}

// Ampere-style asynchronous copies of 16 or 4 bytes into shared memory;
// wait_all completes this thread's copies.
__device__ __forceinline__ void cp_async_16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// ---- wgmma --------------------------------------------------------------------------

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Pins registers in place around asynchronous products: the compiler must
// not read an accumulator before the wait that completes it, nor reuse an
// A fragment's registers while a product still reads them.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

__device__ __forceinline__ uint64_t desc_field(uint32_t bytes) {
  return (uint64_t)((bytes & 0x3FFFFu) >> 4);
}

// Operand descriptor, 128-byte swizzle (layout type 1): start address,
// leading (LBO) and stride (SBO) byte offsets.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return desc_field(addr) | (desc_field(lbo) << 16) | (desc_field(sbo) << 32) | (1ull << 62);
}

// Slice kk (16 wide) of a K-major operand whose tile rows are `box_bytes`
// per 64-column box.
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t tile, int kk, uint32_t box_bytes) {
  return make_desc(tile + (kk >> 2) * box_bytes + (kk & 3) * 32, 16, 1024);
}

// Slice kk (16 rows) of an MN-major B operand of two 64-column boxes.
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t tile, int kk, uint32_t box_bytes) {
  return make_desc(tile + kk * 16 * ROW_BYTES, box_bytes, 1024);
}

#define TP_ACC8(i)                                                                            \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])

// d[32] (+)= A B, m64n64k16, A and B from shared memory, both K-major.
__device__ __forceinline__ void wgmma_n64_ss(float (&d)[32], uint64_t a, uint64_t b,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : TP_ACC8(0), TP_ACC8(8), TP_ACC8(16), TP_ACC8(24)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d[64] (+)= A B, m64n128k16, A and B from shared memory, both K-major.
__device__ __forceinline__ void wgmma_n128_ss(float (&d)[64], uint64_t a, uint64_t b,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : TP_ACC8(0), TP_ACC8(8), TP_ACC8(16), TP_ACC8(24), TP_ACC8(32), TP_ACC8(40),
        TP_ACC8(48), TP_ACC8(56)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d[64] += A B, m64n128k16, A (4 registers of bf16 pairs) from registers,
// B from shared memory, MN-major (transpose bit set).
__device__ __forceinline__ void wgmma_n128_rs(float (&d)[64], const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : TP_ACC8(0), TP_ACC8(8), TP_ACC8(16), TP_ACC8(24), TP_ACC8(32), TP_ACC8(40),
        TP_ACC8(48), TP_ACC8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d[64] (+)= A B, m64n128k16, A from shared memory K-major, B from shared
// memory MN-major (transpose bit set): K9's products on [in, out] weights.
__device__ __forceinline__ void wgmma_n128_ss_tb(float (&d)[64], uint64_t a, uint64_t b,
                                                 int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n}\n"
      : TP_ACC8(0), TP_ACC8(8), TP_ACC8(16), TP_ACC8(24), TP_ACC8(32), TP_ACC8(40),
        TP_ACC8(48), TP_ACC8(56)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d[128] (+)= A B, m64n256k16, A from shared memory K-major, B from shared
// memory MN-major (transpose bit set): K9's wide products.
__device__ __forceinline__ void wgmma_n256_ss_tb(float (&d)[128], uint64_t a, uint64_t b,
                                                 int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 1;\n}\n"
      : TP_ACC8(0), TP_ACC8(8), TP_ACC8(16), TP_ACC8(24),
        TP_ACC8(32), TP_ACC8(40), TP_ACC8(48), TP_ACC8(56),
        TP_ACC8(64), TP_ACC8(72), TP_ACC8(80), TP_ACC8(88),
        TP_ACC8(96), TP_ACC8(104), TP_ACC8(112), TP_ACC8(120)
      : "l"(a), "l"(b), "r"(accumulate));
}

#define TP_OUT8(i)                                                                            \
  "=f"(d[i]), "=f"(d[i + 1]), "=f"(d[i + 2]), "=f"(d[i + 3]), "=f"(d[i + 4]), "=f"(d[i + 5]), \
      "=f"(d[i + 6]), "=f"(d[i + 7])

// d[64] = A B, m64n128k16, both from shared memory, K-major: the first
// slice of a product whose accumulator registers are outputs only, so no
// earlier definition of them reaches the product (K1's S, whose registers
// its softmax rewrites in place between products).
__device__ __forceinline__ void wgmma_n128_ss_set(float (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : TP_OUT8(0), TP_OUT8(8), TP_OUT8(16), TP_OUT8(24), TP_OUT8(32), TP_OUT8(40),
        TP_OUT8(48), TP_OUT8(56)
      : "l"(a), "l"(b), "r"(0));
}

#undef TP_OUT8

// d[32] += A B, m64n64k16, A (4 registers of bf16 pairs) from registers, B
// from shared memory, MN-major (transpose bit set): K1's P V at d = 64.
__device__ __forceinline__ void wgmma_n64_rs(float (&d)[32], const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : TP_ACC8(0), TP_ACC8(8), TP_ACC8(16), TP_ACC8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#undef TP_ACC8

// ---- fragments ----------------------------------------------------------------------

__device__ __forceinline__ float ex2(float x) {  // 2^x; -inf gives +0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The A fragments of an m64 x k(8*N/4) operand from an accumulator d[N]
// of the same rows: the bf16-rounded values, in the order wgmma_n128_rs
// takes them (4 registers per 16 columns).
template <int N>
__device__ __forceinline__ void to_a_fragments(const float (&d)[N], uint32_t (&a)[N / 2]) {
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    a[4 * (j / 2) + 2 * (j % 2)] = pack_bf16(d[4 * j], d[4 * j + 1]);
    a[4 * (j / 2) + 2 * (j % 2) + 1] = pack_bf16(d[4 * j + 2], d[4 * j + 3]);
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Writes this thread's rows `row` and `row + 8` of an accumulator d[N]
// (N / 4 columns; rows `stride` elements apart from `dst`) times `mul[0]`
// and `mul[1]` as bf16 pairs, columns 8j + 2(l % 4); a row at or past
// `limit` is dropped.
template <int N>
__device__ __forceinline__ void store_rows(const float (&d)[N], bf16* dst, long stride, int row,
                                           int limit, const float (&mul)[2]) {
  const int c2 = 2 * (threadIdx.x % 4);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row + 8 * r >= limit) continue;
    bf16* out = dst + (long)(row + 8 * r) * stride + c2;
#pragma unroll
    for (int j = 0; j < N / 4; ++j)
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * j) =
          __floats2bfloat162_rn(d[4 * j + 2 * r] * mul[r], d[4 * j + 2 * r + 1] * mul[r]);
  }
}

// ---- host: tensor maps --------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime already loaded (no
// -lcuda at link time); null if the driver does not have it.
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &found);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return e == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A map over a [n, t, heads, d] bf16 tensor (d = 128 or 64) whose box is
// {64 columns, 1 head, `rows` rows, 1 sample} with the 128-byte swizzle.
// Returns 0 or a CUresult code (CUDA_ERROR_INVALID_VALUE is
// cudaErrorInvalidValue, CUDA_ERROR_INVALID_CONTEXT
// cudaErrorDeviceUninitialized, ...).
inline int encode_rows(CUtensorMap* map, const void* base, int n, int t, int heads, int d,
                       int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)heads, (cuuint64_t)(t > 0 ? t : 1),
                              (cuuint64_t)n};
  const cuuint64_t strides[3] = {(cuuint64_t)d * 2, (cuuint64_t)heads * d * 2,
                                 (cuuint64_t)(t > 0 ? t : 1) * heads * d * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
                            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return (int)r;  // the driver's codes below 1000 are the runtime's
}

// A map over a row-major [rows, cols] bf16 matrix (cols % 64 == 0) whose box
// is {64 columns, `box_rows` rows} with the 128-byte swizzle. Returns as
// encode_rows.
inline int encode_2d(CUtensorMap* map, const void* base, long rows, long cols, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base),
                            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return (int)r;
}

// A map over a row-major [rows, cols] int8 matrix (cols % 16 == 0) whose box
// is {128 columns, `box_rows` rows}, one 128-byte row as a bf16 box, with
// the 128-byte swizzle (K8's activation rows and weight tiles). Returns as
// encode_rows.
inline int encode_2d_s8(CUtensorMap* map, const void* base, long rows, long cols, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols};
  const cuuint32_t box[2] = {128, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), dims,
                            strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return (int)r;
}

}  // namespace sm90
