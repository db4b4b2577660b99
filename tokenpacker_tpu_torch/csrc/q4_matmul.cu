// K6: the 4-bit (nf4 / int4) dequant-in-kernel matmul for small M.
//
// Replaces tokenpacker_tpu/ops/q4_matmul.py:q4_matmul (_q4_matmul_2d and
// its Pallas `_kernel`).
//
// y [m, n] = x [m, k] @ W, W[r, c] = code(idx[r, c]) * absmax[r / 64, c],
// from packed [k/2, n] uint8 (row 2i in the low nibble of packed[i], row
// 2i+1 in the high one) and absmax [k/64, n] f32. code is the nf4 table or
// (idx - 8) / 7 (int4). The dense weight is never built.
//
// What bounds it on the H100: a decode product reads every packed byte and
// absmax once (0.5625 bytes a weight) for 2 * m FLOP a weight, m <= 32:
// far below the ~295 FLOP/byte where the tensor cores would matter, so it
// is bound by bytes at 3.35 TB/s. The TPU kernel folded int4's -8 out of
// the dot and decoded nf4 with a chain of selects; here every weight is
// decoded in registers from a 16-entry table in shared memory (lanes read
// distinct entries or broadcast one: no bank conflicts) and scaled by its
// column's absmax, the same f32 value `dequantize_4bit` makes. Design:
//   - neighbouring threads take neighbouring CPT-byte column groups of a
//     packed row (coalesced 16/8/4-byte loads), 8 warps split each 64-row
//     quantization block's 32 packed rows (4 each, all loads in flight
//     before any math), and each thread loads its columns' absmax once a
//     block;
//   - k is split over blockIdx.y so that n = 4096 still gives ~264 blocks
//     for 132 SMs; the splits' partial sums go to a workspace and an
//     epilogue adds them in a fixed order (no float atomics: two calls
//     give the same bits);
//   - x rows ride in shared memory as f32; up to 16 rows a launch (m = 32
//     reads the weight twice), the accumulators in registers.
// A TMA ring, and mma with dequantized fragments for m > 8, are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "int8_rows.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int WARPS = 8;
constexpr int QBLOCK = 64;           // rows per absmax (the leaf's block)
constexpr int PACKED_PER_BLOCK = 32;  // packed rows per quantization block
constexpr int MAX_SPLIT_ROWS = 512;   // bounds the staged x slice in shared memory
constexpr int TARGET_BLOCKS = 264;    // 2 per SM on 132 SMs
constexpr int MAX_ROWS = 16;          // rows of x per launch

__constant__ float NF4[16] = {
    -1.0f, -0.6961928009986877f, -0.5250730514526367f, -0.39491748809814453f,
    -0.28444138169288635f, -0.18477343022823334f, -0.09105003625154495f, 0.0f,
    0.07958029955625534f, 0.16093020141124725f, 0.24611230194568634f,
    0.33791524171829224f, 0.44070982933044434f, 0.5626170039176941f,
    0.7229568362236023f, 1.0f};

// CPT packed bytes (columns) of one packed row, one vector load
template <int CPT>
struct Bytes {
  uint32_t w[CPT / 4];
  __device__ __forceinline__ void load(const uint8_t* p) {
    if constexpr (CPT == 16) {
      const uint4 v = __ldcs(reinterpret_cast<const uint4*>(p));
      w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
    } else if constexpr (CPT == 8) {
      const uint2 v = __ldcs(reinterpret_cast<const uint2*>(p));
      w[0] = v.x; w[1] = v.y;
    } else {
      w[0] = __ldcs(reinterpret_cast<const unsigned int*>(p));
    }
  }
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < CPT / 4; ++i) w[i] = 0u;
  }
  __device__ __forceinline__ uint32_t byte(int c) const { return (w[c / 4] >> (8 * (c % 4))) & 0xFFu; }
};

// partials[b][split][col] = sum over the split's rows r of x[b, r] * W[r, col]
// for the MB rows of this launch (rows >= m read as 0 and are not written).
// grid (ceil(n / (32 * CPT)), splits), WARPS * 32 threads.
template <int MB, int CPT>
__global__ void __launch_bounds__(WARPS * 32)
    q4_partial_kernel(const bf16* __restrict__ x, int m, const uint8_t* __restrict__ packed,
                      const float* __restrict__ absmax, int k, int n, int split_rows, int nf4,
                      float* __restrict__ partials) {
  constexpr int COLS = 32 * CPT;
  extern __shared__ float smem[];
  float* xs = smem;                      // [MB][split_rows]
  float* red = smem + MB * split_rows;   // [WARPS][COLS]
  __shared__ float table[16];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  if (tid < 16) table[tid] = nf4 ? NF4[tid] : (float)(tid - 8) / 7.0f;
  const int split = blockIdx.y;
  const int k0 = split * split_rows;
  const int rows = min(k, k0 + split_rows) - k0;  // a multiple of QBLOCK
  for (int i = tid; i < MB * rows; i += WARPS * 32) {
    const int b = i / rows, r = i % rows;
    xs[b * split_rows + r] = b < m ? __bfloat162float(x[(long)b * k + k0 + r]) : 0.f;
  }
  __syncthreads();

  const int col0 = blockIdx.x * COLS + lane * CPT;
  const bool active = col0 < n;
  float acc[MB][CPT];
#pragma unroll
  for (int b = 0; b < MB; ++b)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[b][c] = 0.f;

  for (int g = 0; g < rows / QBLOCK; ++g) {
    const int kg = k0 + g * QBLOCK;  // first row of this quantization block
    Bytes<CPT> wv[PACKED_PER_BLOCK / WARPS];
    float am[CPT];
#pragma unroll
    for (int u = 0; u < PACKED_PER_BLOCK / WARPS; ++u) {
      if (active) wv[u].load(packed + (long)(kg / 2 + warp + u * WARPS) * n + col0);
      else wv[u].zero();
    }
#pragma unroll
    for (int c = 0; c < CPT; c += 4) {
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
      if (active) a = *reinterpret_cast<const float4*>(absmax + (long)(kg / QBLOCK) * n + col0 + c);
      am[c] = a.x; am[c + 1] = a.y; am[c + 2] = a.z; am[c + 3] = a.w;
    }
#pragma unroll
    for (int u = 0; u < PACKED_PER_BLOCK / WARPS; ++u) {
      const int r = g * QBLOCK + 2 * (warp + u * WARPS);  // local row of the low nibble
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const uint32_t byte = wv[u].byte(c);
        const float lo = table[byte & 15u] * am[c];
        const float hi = table[byte >> 4] * am[c];
#pragma unroll
        for (int b = 0; b < MB; ++b) {
          acc[b][c] = fmaf(xs[b * split_rows + r], lo, acc[b][c]);
          acc[b][c] = fmaf(xs[b * split_rows + r + 1], hi, acc[b][c]);
        }
      }
    }
  }

  // the 8 warps' sums of each column, added in warp order
  const int splits = gridDim.y;
#pragma unroll
  for (int b = 0; b < MB; ++b) {
    float4* dst = reinterpret_cast<float4*>(red + warp * COLS + lane * CPT);
#pragma unroll
    for (int c = 0; c < CPT / 4; ++c)
      dst[c] = make_float4(acc[b][4 * c], acc[b][4 * c + 1], acc[b][4 * c + 2], acc[b][4 * c + 3]);
    __syncthreads();
    if (b < m) {
      for (int j = tid; j < COLS; j += WARPS * 32) {
        const int col = blockIdx.x * COLS + j;
        float t = 0.f;
#pragma unroll
        for (int i = 0; i < WARPS; ++i) t += red[i * COLS + j];
        if (col < n) partials[((long)b * splits + split) * n + col] = t;
      }
    }
    __syncthreads();
  }
}

// out[b, col] = bf16(sum of the splits, in split order); grid (ceil(n/256), m)
__global__ void __launch_bounds__(256)
    q4_epilogue_kernel(const float* __restrict__ partials, int splits, int n,
                       bf16* __restrict__ out) {
  const int col = blockIdx.x * 256 + threadIdx.x, b = blockIdx.y;
  if (col >= n) return;
  const float* p = partials + (long)b * splits * n + col;
  float t = 0.f;
  for (int s = 0; s < splits; ++s) t += p[(long)s * n];
  out[(long)b * n + col] = __float2bfloat16(t);
}

int cols_per_thread(int mb) { return mb <= 4 ? 16 : (mb <= 8 ? 8 : 4); }

// How k splits: enough blocks for the card, whole quantization blocks, at
// most MAX_SPLIT_ROWS rows a split.
struct SplitPlan {
  int split_rows, splits;
};

SplitPlan plan_for(int k, int n, int cpt) {
  const int col_blocks = (n + 32 * cpt - 1) / (32 * cpt);
  const int qblocks = k / QBLOCK;
  int splits = (TARGET_BLOCKS + col_blocks - 1) / col_blocks;
  splits = std::max(splits, (k + MAX_SPLIT_ROWS - 1) / MAX_SPLIT_ROWS);
  splits = std::max(1, std::min(splits, qblocks));
  SplitPlan p;
  p.split_rows = (qblocks + splits - 1) / splits * QBLOCK;
  p.splits = (k + p.split_rows - 1) / p.split_rows;
  return p;
}

// rows [0, m) of x (m <= MB) times the leaf -> out rows [0, m)
template <int MB, int CPT>
int launch_group(const bf16* x, int m, const uint8_t* packed, const float* absmax, int k, int n,
                 int nf4, float* partials, bf16* out, cudaStream_t stream) {
  const SplitPlan p = plan_for(k, n, CPT);
  const size_t smem = sizeof(float) * ((size_t)MB * p.split_rows + WARPS * 32 * CPT);
  dim3 grid((n + 32 * CPT - 1) / (32 * CPT), p.splits);
  q4_partial_kernel<MB, CPT><<<grid, WARPS * 32, smem, stream>>>(x, m, packed, absmax, k, n,
                                                                 p.split_rows, nf4, partials);
  const int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  q4_epilogue_kernel<<<dim3((n + 255) / 256, m), 256, 0, stream>>>(partials, p.splits, n, out);
  return (int)cudaGetLastError();
}

}  // namespace

// Bytes of workspace tp_q4_matmul needs for m rows of x times a [k, n] leaf.
extern "C" long long tp_q4_matmul_workspace(int m, int k, int n) {
  long long most = 0;
  for (int r0 = 0; r0 < m; r0 += MAX_ROWS) {
    const int mb = std::min(MAX_ROWS, m - r0);
    const SplitPlan p = plan_for(k, n, cols_per_thread(padded_rows(mb)));
    most = std::max(most, (long long)mb * p.splits * n * (long long)sizeof(float));
  }
  return most;
}

// x: [m, k] bf16; packed: [k/2, n] uint8; absmax: [k/64, n] f32; out:
// [m, n] bf16; work: tp_q4_matmul_workspace(m, k, n) bytes; all on the
// device, contiguous, 16-byte aligned. nf4 = 1 for the nf4 codebook, 0 for
// int4. k % 64 == 0 and n % 16 == 0. Returns 0, a cudaError_t code, or -1
// for a shape the kernel does not take.
extern "C" int tp_q4_matmul(const void* x, const void* packed, const void* absmax, void* out,
                            void* work, int m, int k, int n, int nf4, void* stream) {
  if (m <= 0 || k <= 0 || n <= 0 || k % QBLOCK || n % 16) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  const uint8_t* pk = static_cast<const uint8_t*>(packed);
  const float* am = static_cast<const float*>(absmax);
  float* partials = static_cast<float*>(work);
  for (int r0 = 0; r0 < m; r0 += MAX_ROWS) {
    const int mb = std::min(MAX_ROWS, m - r0);
    const bf16* xg = xb + (long)r0 * k;
    bf16* og = static_cast<bf16*>(out) + (long)r0 * n;
    int rc;
    switch (padded_rows(mb)) {
      case 1: rc = launch_group<1, 16>(xg, mb, pk, am, k, n, nf4, partials, og, st); break;
      case 2: rc = launch_group<2, 16>(xg, mb, pk, am, k, n, nf4, partials, og, st); break;
      case 4: rc = launch_group<4, 16>(xg, mb, pk, am, k, n, nf4, partials, og, st); break;
      case 8: rc = launch_group<8, 8>(xg, mb, pk, am, k, n, nf4, partials, og, st); break;
      default: rc = launch_group<16, 4>(xg, mb, pk, am, k, n, nf4, partials, og, st); break;
    }
    if (rc != 0) return rc;
  }
  return 0;
}
