// K7: the w8a8 GEMV, int8 x int8 -> exact int32.
//
// Replaces tokenpacker_tpu/ops/q8_matmul.py:s8_matmul (its Pallas `_kernel`).
//
// out [m, n] int32 = xq [m, k] int8 @ wq [k, n] int8, for decode-sized m
// (<= 64 on the serving path). The sums are exact: |out| <= 127^2 k < 2^31
// for k < 133,000.
//
// What bounds it on the H100: it streams the int8 weight once (k * n
// bytes) for 2 * m operations a byte, far below the ~590 int8 operations a
// byte where the tensor cores would be the limit: bound by bytes at
// 3.35 TB/s. Design:
//   - neighbouring threads take neighbouring CPT-byte column groups of 4
//     consecutive weight rows (coalesced vector loads), transpose each
//     4 x 4 byte square in registers (__byte_perm) so a word holds 4 rows
//     of one column, and take dp4a with a word of 4 activations of one x
//     row, read from shared memory (a broadcast);
//   - 8 warps split a block's row quads, k is split over blockIdx.y so that
//     n = 4096 still fills the card, and each block adds its 8 warps' sums
//     and then atomically adds them into `out` (zeroed by the caller):
//     integer addition is exact and associative, so the result does not
//     depend on the order;
//   - up to 16 x rows a launch (m = 64 reads the weight 4 times); the
//     accumulators live in registers.
// An mma.sync (m16n8k32 s8) form for m of 16-64 is later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "int8_rows.cuh"

namespace {

constexpr int WARPS = 8;
constexpr int UNROLL = 2;             // row quads in flight per warp
constexpr int MAX_SPLIT_ROWS = 1024;  // bounds the staged x slice in shared memory
constexpr int TARGET_BLOCKS = 264;    // 2 per SM on 132 SMs
constexpr int MAX_ROWS = 16;          // rows of x per launch

template <int CPT>
__device__ __forceinline__ void load_row(const int8_t* p, uint32_t* w) {
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

// out[b, col] += sum over the split's rows of xq[b, r] * wq[r, col] for the
// MB rows of this launch (rows >= m read as 0 and are not written).
// grid (ceil(n / (32 * CPT)), splits), WARPS * 32 threads.
template <int MB, int CPT>
__global__ void __launch_bounds__(WARPS * 32)
    s8_matmul_kernel(const int8_t* __restrict__ xq, int m, const int8_t* __restrict__ w, int k,
                     int n, int split_rows, int* __restrict__ out) {
  constexpr int COLS = 32 * CPT;
  extern __shared__ int smem[];
  const int quads_max = split_rows / 4;
  int* xs = smem;                       // [MB][split_rows / 4] words of 4 activations
  int* red = smem + MB * quads_max;     // [WARPS][COLS]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int k0 = blockIdx.y * split_rows;
  const int quads = (min(k, k0 + split_rows) - k0) / 4;
  for (int i = tid; i < MB * quads; i += WARPS * 32) {
    const int b = i / quads, q = i % quads;
    xs[b * quads_max + q] =
        b < m ? *reinterpret_cast<const int*>(xq + (long)b * k + k0 + 4 * q) : 0;
  }
  __syncthreads();

  const int col0 = blockIdx.x * COLS + lane * CPT;
  const bool active = col0 < n;
  int acc[MB][CPT];
#pragma unroll
  for (int b = 0; b < MB; ++b)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[b][c] = 0;

  const int8_t* wp = w + (long)k0 * n + col0;
  for (int q = warp; q < quads; q += WARPS * UNROLL) {
    uint32_t raw[UNROLL][4][CPT / 4];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int qq = q + u * WARPS;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (active && qq < quads) {
          load_row<CPT>(wp + (long)(4 * qq + j) * n, raw[u][j]);
        } else {
#pragma unroll
          for (int i = 0; i < CPT / 4; ++i) raw[u][j][i] = 0u;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int qq = q + u * WARPS;
      if (qq >= quads) break;  // uniform across the warp
#pragma unroll
      for (int g = 0; g < CPT / 4; ++g) {
        uint32_t col[4];
        transpose4(raw[u][0][g], raw[u][1][g], raw[u][2][g], raw[u][3][g], col);
#pragma unroll
        for (int b = 0; b < MB; ++b) {
          const int xw = xs[b * quads_max + qq];
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[b][4 * g + c] = __dp4a((int)col[c], xw, acc[b][4 * g + c]);
        }
      }
    }
  }

#pragma unroll
  for (int b = 0; b < MB; ++b) {
#pragma unroll
    for (int c = 0; c < CPT; ++c) red[warp * COLS + lane * CPT + c] = acc[b][c];
    __syncthreads();
    if (b < m) {
      for (int j = tid; j < COLS; j += WARPS * 32) {
        const int col = blockIdx.x * COLS + j;
        int t = 0;
#pragma unroll
        for (int i = 0; i < WARPS; ++i) t += red[i * COLS + j];
        if (col < n) atomicAdd(out + (long)b * n + col, t);
      }
    }
    __syncthreads();
  }
}

template <int MB, int CPT>
int launch_group(const int8_t* xq, int m, const int8_t* w, int k, int n, int* out,
                 cudaStream_t stream) {
  const int col_blocks = (n + 32 * CPT - 1) / (32 * CPT);
  const int quads32 = k / 32;  // split rows are multiples of 32
  int splits = (TARGET_BLOCKS + col_blocks - 1) / col_blocks;
  splits = std::max(splits, (k + MAX_SPLIT_ROWS - 1) / MAX_SPLIT_ROWS);
  splits = std::max(1, std::min(splits, quads32));
  const int split_rows = (quads32 + splits - 1) / splits * 32;
  splits = (k + split_rows - 1) / split_rows;
  const size_t smem = sizeof(int) * ((size_t)MB * (split_rows / 4) + WARPS * 32 * CPT);
  s8_matmul_kernel<MB, CPT><<<dim3(col_blocks, splits), WARPS * 32, smem, stream>>>(
      xq, m, w, k, n, split_rows, out);
  return (int)cudaGetLastError();
}

}  // namespace

// xq: [m, k] int8; wq: [k, n] int8; out: [m, n] int32, zeroed; all on the
// device, contiguous, 16-byte aligned. k % 32 == 0, n % 16 == 0. Returns 0,
// a cudaError_t code, or -1 for a shape the kernel does not take.
extern "C" int tp_s8_matmul(const void* xq, const void* wq, void* out, int m, int k, int n,
                            void* stream) {
  if (m <= 0 || k <= 0 || n <= 0 || k % 32 || n % 16) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* w = static_cast<const int8_t*>(wq);
  for (int r0 = 0; r0 < m; r0 += MAX_ROWS) {
    const int mb = std::min(MAX_ROWS, m - r0);
    const int8_t* xg = static_cast<const int8_t*>(xq) + (long)r0 * k;
    int* og = static_cast<int*>(out) + (long)r0 * n;
    int rc;
    switch (padded_rows(mb)) {
      case 1: rc = launch_group<1, 16>(xg, mb, w, k, n, og, st); break;
      case 2: rc = launch_group<2, 16>(xg, mb, w, k, n, og, st); break;
      case 4: rc = launch_group<4, 16>(xg, mb, w, k, n, og, st); break;
      case 8: rc = launch_group<8, 8>(xg, mb, w, k, n, og, st); break;
      default: rc = launch_group<16, 4>(xg, mb, w, k, n, og, st); break;
    }
    if (rc != 0) return rc;
  }
  return 0;
}
