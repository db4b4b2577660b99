// K8: the large-M w8a8 GEMM, row quantization inside the kernel.
//
// Replaces tokenpacker_tpu/ops/s8_gemm.py:s8_gemm (its Pallas `_kernel`).
//
// y [m, n] bf16 = bf16(f32(xq @ wq) * ax * wscale), where each row of x
// [m, k] bf16 is quantized as quantize_activations does: ax = max(max |x|,
// 1e-8) / 127, xq = round-half-even(x / ax) (IEEE division: this file must
// not be built with fast math), |xq| <= 127. wq [k, n] int8, wscale [1, n]
// f32. The int32 sums are exact.
//
// What bounds it on the H100: at the serving shapes (m >= 256, k and n of
// 1024-22016) it does 2 m k n int8 operations on ~(2 m k + k n + 2 m n)
// bytes, hundreds of operations a byte: bound by the int8 tensor-core rate
// (1,979 TOPS dense) more than by bytes. The TPU kernel quantized the rows
// of its M tile once into VMEM scratch and kept K whole; a block here
// cannot hold a [128, k] tile of int8 rows for k up to 11008, so:
//   - one block per 128 x 128 output tile; it first takes the absmax of its
//     128 rows (one pass over them), then walks k in chunks of 64: it
//     quantizes the chunk of its rows into shared memory (the int8 rows
//     never go to device memory) and stages the weight chunk transposed
//     (4 x 4 byte squares turned in registers) so that each thread's
//     fragment is one 32-bit shared load;
//   - 8 warps, each a 64 x 32 sub-tile of mma.sync m16n8k32 s8 products
//     into int32 registers; shared rows are padded to 20 words so the
//     fragment loads hit 32 distinct banks;
//   - the epilogue scales acc by ax (row) and wscale (column) in f32 and
//     writes bf16 in the same pass. Optional outputs (the card checks) are
//     the int8 rows, their scales and the int32 accumulator.
// Each block re-reads its rows of x for every k chunk and for each of the
// n / 128 column tiles (from L2). No cp.async / TMA pipeline and no wgmma
// yet: a simple, exact first form.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "int8_rows.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int BM = 128, BN = 128, BK = 64, THREADS = 256;
constexpr int LDS = BK / 4 + 4;  // 32-bit words a staged row: 16 + 4 pad

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t quant_byte(float v, float ax) {
  const float q = fminf(fmaxf(rintf(v / ax), -127.f), 127.f);
  return (uint32_t)((int)q & 0xFF);
}

__global__ void __launch_bounds__(THREADS)
    s8_gemm_kernel(const bf16* __restrict__ x, const int8_t* __restrict__ w,
                   const float* __restrict__ wscale, bf16* __restrict__ y, int m, int k, int n,
                   int8_t* __restrict__ xq_out, float* __restrict__ ax_out,
                   int* __restrict__ acc_out) {
  __shared__ uint32_t xs[BM][LDS];  // the chunk's int8 rows, 4 per word
  __shared__ uint32_t ws[BN][LDS];  // the weight chunk by column, 4 rows per word
  __shared__ float axs[BM];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;  // mma fragment coordinates
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const bool first_col_tile = blockIdx.y == 0;

  // per-row absmax of this tile's rows: warp w takes rows w, w + 8, ...
  for (int r = warp; r < BM; r += THREADS / 32) {
    const int row = m0 + r;
    float mx = 0.f;
    if (row < m) {
      const bf16* xr = x + (long)row * k;
      for (int i = lane * 4; i < k; i += 128) {
        const uint2 raw = *reinterpret_cast<const uint2*>(xr + i);
        const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
        const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
        mx = fmaxf(mx, fmaxf(fmaxf(fabsf(a.x), fabsf(a.y)), fmaxf(fabsf(b.x), fabsf(b.y))));
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    if (lane == 0) {
      const float ax = fmaxf(mx, 1e-8f) / 127.0f;
      axs[r] = ax;
      if (ax_out != nullptr && first_col_tile && row < m) ax_out[row] = ax;
    }
  }
  __syncthreads();

  const int wm = warp / 4, wn = warp % 4;  // 2 x 4 warps of 64 x 32
  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  for (int kc = 0; kc < k; kc += BK) {
    // the rows' chunk, quantized: BM x BK / 4 words, 8 a thread
    for (int i = tid; i < BM * (BK / 4); i += THREADS) {
      const int r = i / (BK / 4), q = i % (BK / 4), row = m0 + r;
      uint32_t word = 0u;
      if (row < m) {
        const uint2 raw = *reinterpret_cast<const uint2*>(x + (long)row * k + kc + 4 * q);
        const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
        const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
        const float ax = axs[r];
        word = quant_byte(a.x, ax) | (quant_byte(a.y, ax) << 8) | (quant_byte(b.x, ax) << 16) |
               (quant_byte(b.y, ax) << 24);
        if (xq_out != nullptr && first_col_tile)
          *reinterpret_cast<uint32_t*>(xq_out + (long)row * k + kc + 4 * q) = word;
      }
      xs[r][q] = word;
    }
    // the weight chunk: (BK / 4) x (BN / 4) squares of 4 x 4 bytes, 2 a thread
    for (int i = tid; i < (BK / 4) * (BN / 4); i += THREADS) {
      const int nq = i % (BN / 4), kq = i / (BN / 4);
      const int8_t* src = w + (long)(kc + 4 * kq) * n + n0 + 4 * nq;
      uint32_t col[4];
      transpose4(*reinterpret_cast<const uint32_t*>(src),
                 *reinterpret_cast<const uint32_t*>(src + n),
                 *reinterpret_cast<const uint32_t*>(src + 2 * (long)n),
                 *reinterpret_cast<const uint32_t*>(src + 3 * (long)n), col);
#pragma unroll
      for (int j = 0; j < 4; ++j) ws[4 * nq + j][kq] = col[j];
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < BK / 32; ++ks) {
      uint32_t a[4][4], b[4][2];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const int r = wm * 64 + mt * 16 + g, kw = ks * 8 + t;
        a[mt][0] = xs[r][kw];
        a[mt][1] = xs[r + 8][kw];
        a[mt][2] = xs[r][kw + 4];
        a[mt][3] = xs[r + 8][kw + 4];
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int c = wn * 32 + nt * 8 + g;
        b[nt][0] = ws[c][ks * 8 + t];
        b[nt][1] = ws[c][ks * 8 + t + 4];
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_s8(acc[mt][nt], a[mt], b[nt]);
    }
    __syncthreads();
  }

  // epilogue: (f32(acc) * ax) * wscale -> bf16, two columns a store
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int col = n0 + wn * 32 + nt * 8 + 2 * t;
      const float s0 = wscale[col], s1 = wscale[col + 1];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wm * 64 + mt * 16 + g + 8 * h, row = m0 + r;
        if (row >= m) continue;
        const int c0 = acc[mt][nt][2 * h], c1 = acc[mt][nt][2 * h + 1];
        const float ax = axs[r];
        __nv_bfloat162 out;
        out.x = __float2bfloat16((float)c0 * ax * s0);
        out.y = __float2bfloat16((float)c1 * ax * s1);
        *reinterpret_cast<__nv_bfloat162*>(y + (long)row * n + col) = out;
        if (acc_out != nullptr)
          *reinterpret_cast<int2*>(acc_out + (long)row * n + col) = make_int2(c0, c1);
      }
    }
  }
}

}  // namespace

// x: [m, k] bf16; wq: [k, n] int8; wscale: [n] f32; y: [m, n] bf16; the
// optional xq_out [m, k] int8, ax_out [m] f32 and acc_out [m, n] int32 may
// be null. All on the device, contiguous, 16-byte aligned; k % 128 == 0 and
// n % 128 == 0 (the serving path's routing condition). Returns 0, a
// cudaError_t code, or -1 for a shape the kernel does not take.
extern "C" int tp_s8_gemm(const void* x, const void* wq, const void* wscale, void* y, int m,
                          int k, int n, void* xq_out, void* ax_out, void* acc_out,
                          void* stream) {
  if (m <= 0 || k <= 0 || n <= 0 || k % 128 || n % 128) return -1;
  dim3 grid((m + BM - 1) / BM, n / BN);
  s8_gemm_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const int8_t*>(wq),
      static_cast<const float*>(wscale), static_cast<bf16*>(y), m, k, n,
      static_cast<int8_t*>(xq_out), static_cast<float*>(ax_out), static_cast<int*>(acc_out));
  return (int)cudaGetLastError();
}
