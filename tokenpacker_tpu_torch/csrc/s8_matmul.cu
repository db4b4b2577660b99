// K7: the w8a8 GEMV, int8 x int8 -> exact int32, on the tensor cores.
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
// 3.35 TB/s. The earlier design (dp4a on the CUDA cores, 16 rows a launch,
// split-K through atomics into a zeroed output) streamed the weight once
// per 16 rows and paid a zero-fill launch. Design:
//   - one launch for every m <= 64, streaming the weight once: the
//     products run on mma.sync.m16n8k32 (s8 in, s32 accumulate) with the
//     weight as A (out^T = W^T x^T): N on the 16-row side, x's rows on the
//     8-wide side, so m <= 8 costs one mma a 16 x 32 weight fragment and
//     m = 64 eight;
//   - the fragment wants 4 consecutive k of one column in a register, the
//     [k, n] weight gives 4 consecutive columns of one k: each thread
//     transposes 4 x 4 byte squares in registers (__byte_perm, transpose4).
//     Thread (g, t) of a warp reads rows 4t..4t+3 of the k32 step at byte
//     columns 4g and 32 + 4g of its 64-column half, so its four n16 tiles'
//     A rows g and g + 8 are columns 4g + j and 32 + 4g + j (tile j);
//   - a block takes 128 columns; its 4 warps are 2 column halves x 2 k32
//     steps of each 64-row stage. Each stage's [64, 128] weight tile (16-
//     byte chunks swizzled by row, so a warp's 4-byte loads hit 32 banks)
//     and x's [m, 64] slice stream through a 4-stage cp.async ring;
//   - k is split over the blocks of a thread-block cluster (whole stages,
//     balanced; the split count is chosen on the host,
//     ops/q8_matmul.py:s8_splits). Each block leaves its int32 partial in
//     shared memory; after a cluster barrier block r sums columns [r w,
//     (r + 1) w) of every split's partial through distributed shared
//     memory and writes them: no atomics, no zeroed output, no second
//     launch. Integer sums are exact, so the result is bit-equal to the
//     plain product whatever the split.

#include <cuda_runtime.h>
#include <stdint.h>

#include "int8_rows.cuh"
#include "split_merge.cuh"

namespace {

using namespace split_merge;

constexpr int SROWS = 64;       // weight rows (k) a stage
constexpr int NB = 128;         // columns a block
constexpr int THREADS = 128;    // 4 warps: 2 column halves x 2 k32 steps
constexpr int STAGES = 4;       // stages in the cp.async ring
constexpr int XSTRIDE = 80;     // bytes a staged x row: 64 + 16 (conflict-free B loads)
constexpr int PART_LD = 132;    // ints a partial row: 128 + 4 (conflict-free stores)
constexpr int MAX_SPLITS = 8;   // the portable cluster size
constexpr int W_BYTES = SROWS * NB;

template <int MT>
__host__ __device__ constexpr int stage_bytes() {
  return W_BYTES + MT * 8 * XSTRIDE;
}

// the block's int32 partial after the loop: [2 k steps][MT * 8 rows][PART_LD]
template <int MT>
constexpr int part_bytes() {
  return 2 * MT * 8 * PART_LD * 4;
}

template <int MT>
constexpr int smem_bytes() {
  return STAGES * stage_bytes<MT>() > part_bytes<MT>() ? STAGES * stage_bytes<MT>()
                                                        : part_bytes<MT>();
}

// the byte offset of 16-byte chunk c (16 columns) of stage row r: chunks
// swizzled by bits 2-3 of the row, so the 4 rows 4t + i that a warp's
// lanes t read at one column word land on 4 distinct 8-word bank groups
__device__ __forceinline__ int w_offset(int r, int c) {
  return r * NB + ((c ^ (((r >> 2) & 3) << 1)) << 4);
}

__device__ __forceinline__ void mma_s8(int* c, uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// out rows [0, m) (m <= MT * 8) = xq @ wq for columns [blockIdx.y * NB, +
// NB) of n; grid (splits, ceil(n / NB)), one cluster of `splits` blocks a
// column tile.
template <int MT>
__global__ void __launch_bounds__(THREADS, MT <= 4 ? 3 : 2)
    s8_matmul_kernel(const int8_t* __restrict__ xq, int m, const int8_t* __restrict__ w, int k,
                     int n, int* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int STAGE = stage_bytes<MT>();
  const int split = blockIdx.x, splits = gridDim.x, col0 = blockIdx.y * NB;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int ch = warp & 1, ks = warp >> 1;  // column half, k32 step of a stage

  // this split's stages, balanced
  const int nstages = (k + SROWS - 1) / SROWS;
  const int s0 = split * nstages / splits, s1 = (split + 1) * nstages / splits;
  const int ns = s1 - s0;

  // This thread's copies of a stage, the same every stage: weight chunks
  // tid + 128 u (row j / 8, 16 columns j % 8), x chunks tid (+ 128) of MT
  // * 32 (row j / 4, 16 k's j % 4); a stage moves the sources on by 64 rows.
  constexpr int XCHUNKS = MT * 32, XLOADS = (XCHUNKS + THREADS - 1) / THREADS;
  const int8_t* w_src[4];
  int w_dst[4], w_row[4];
  bool w_col_ok[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int j = tid + u * THREADS, r = j / 8, c = j % 8, col = col0 + 16 * c;
    w_col_ok[u] = col < n;
    w_row[u] = r;
    w_src[u] = w + (long)r * n + (w_col_ok[u] ? col : 0);
    w_dst[u] = w_offset(r, c);
  }
  const int8_t* x_src[XLOADS];
  int x_dst[XLOADS], x_col[XLOADS];
  bool x_row_ok[XLOADS];
#pragma unroll
  for (int u = 0; u < XLOADS; ++u) {
    const int j = tid + u * THREADS, r = j / 4, c = j % 4;
    x_row_ok[u] = j < XCHUNKS && r < m;
    x_src[u] = xq + (x_row_ok[u] ? (long)r * k : 0) + 16 * c;
    x_col[u] = 16 * c;
    x_dst[u] = W_BYTES + r * XSTRIDE + 16 * c;
  }
  auto load = [&](int i) {
    unsigned char* st = smem + (i % STAGES) * STAGE;
    const int r0 = (s0 + i) * SROWS;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const bool ok = w_col_ok[u] && r0 + w_row[u] < k;
      cp_async_16(st + w_dst[u], ok ? w_src[u] + (long)r0 * n : w, ok);
    }
#pragma unroll
    for (int u = 0; u < XLOADS; ++u)
      if (tid + u * THREADS < XCHUNKS) {
        const bool ok = x_row_ok[u] && r0 + x_col[u] < k;
        cp_async_16(st + x_dst[u], ok ? x_src[u] + r0 : xq, ok);
      }
  };

  int acc[4][MT][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][i][e] = 0;

#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < ns) load(i);
    cp_async_commit();
  }
  // this thread's column words in a stage row: a0 / a2 at byte column 64
  // ch + 4 g, a1 / a3 at 64 ch + 32 + 4 g (word 16 ch + g, + 8)
  const int word_lo = 16 * ch + g, word_hi = word_lo + 8;
  for (int it = 0; it < ns; ++it) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage it landed; every thread is done with stage it - 1
    if (it + STAGES - 1 < ns) load(it + STAGES - 1);
    cp_async_commit();
    const unsigned char* st = smem + (it % STAGES) * STAGE;
    const int rb = 32 * ks;  // this warp's k32 step: stage rows rb .. rb + 31
    uint32_t wa[4][4];       // [a register][row 4t + i (+16)] words
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r_lo = rb + 4 * t + i, r_hi = r_lo + 16;
      // the swizzle: word ^ 8 ((r >> 2) & 3), which is 8 t for these rows
      const int sw = 8 * t;
      wa[0][i] = *reinterpret_cast<const uint32_t*>(st + r_lo * NB + 4 * (word_lo ^ sw));
      wa[1][i] = *reinterpret_cast<const uint32_t*>(st + r_lo * NB + 4 * (word_hi ^ sw));
      wa[2][i] = *reinterpret_cast<const uint32_t*>(st + r_hi * NB + 4 * (word_lo ^ sw));
      wa[3][i] = *reinterpret_cast<const uint32_t*>(st + r_hi * NB + 4 * (word_hi ^ sw));
    }
    uint32_t a[4][4];  // [a register][n16 tile j]
#pragma unroll
    for (int q = 0; q < 4; ++q) transpose4(wa[q][0], wa[q][1], wa[q][2], wa[q][3], a[q]);
    const unsigned char* xs = st + W_BYTES;
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const unsigned char* xr = xs + (8 * i + g) * XSTRIDE + rb + 4 * t;
      const uint32_t b0 = *reinterpret_cast<const uint32_t*>(xr);
      const uint32_t b1 = *reinterpret_cast<const uint32_t*>(xr + 16);
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_s8(acc[j][i], a[0][j], a[1][j], a[2][j], a[3][j], b0, b1);
    }
  }

  // the block's partial into the free ring: c0 / c2 (x row 8 i + 2 t) and
  // c1 / c3 (row 8 i + 2 t + 1) of columns 64 ch + 4 g + j (c0, c1) and
  // 64 ch + 32 + 4 g + j (c2, c3), four tiles j in one 16-byte store
  cp_async_wait<0>();
  __syncthreads();
  int* part = reinterpret_cast<int*>(smem);  // [2][MT * 8][PART_LD]
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    int* p = part + (ks * MT * 8 + 8 * i + 2 * t) * PART_LD + 64 * ch + 4 * g;
    *reinterpret_cast<int4*>(p) = make_int4(acc[0][i][0], acc[1][i][0], acc[2][i][0], acc[3][i][0]);
    *reinterpret_cast<int4*>(p + PART_LD) =
        make_int4(acc[0][i][1], acc[1][i][1], acc[2][i][1], acc[3][i][1]);
    *reinterpret_cast<int4*>(p + 32) =
        make_int4(acc[0][i][2], acc[1][i][2], acc[2][i][2], acc[3][i][2]);
    *reinterpret_cast<int4*>(p + PART_LD + 32) =
        make_int4(acc[0][i][3], acc[1][i][3], acc[2][i][3], acc[3][i][3]);
  }

  // block `split` sums its slice of the columns over every split's partial
  // (both k steps) through distributed shared memory
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int width = NB / splits, quads = width / 4;
  for (int j = tid; j < m * quads; j += THREADS) {
    const int row = j / quads, col = split * width + 4 * (j % quads);
    int4 v[2 * MAX_SPLITS];
#pragma unroll
    for (int r = 0; r < MAX_SPLITS; ++r) {
      if (r < splits) {
        const int* remote = cluster.map_shared_rank(part, r);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          v[2 * r + hh] = *reinterpret_cast<const int4*>(remote + (hh * MT * 8 + row) * PART_LD + col);
      }
    }
    int4 sum = make_int4(0, 0, 0, 0);
#pragma unroll
    for (int r = 0; r < 2 * MAX_SPLITS; ++r) {
      if (r < 2 * splits) {
        sum.x += v[r].x;
        sum.y += v[r].y;
        sum.z += v[r].z;
        sum.w += v[r].w;
      }
    }
    if (col0 + col < n) *reinterpret_cast<int4*>(out + (long)row * n + col0 + col) = sum;
  }
  cluster.sync();  // the others' partials are read: they may exit
}

template <int MT>
int launch(const void* xq, const void* wq, void* out, int m, int k, int n, int splits,
           cudaStream_t stream) {
  auto* kernel = s8_matmul_kernel<MT>;
  constexpr int bytes = smem_bytes<MT>();
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, (n + NB - 1) / NB);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, static_cast<const int8_t*>(xq), m,
                         static_cast<const int8_t*>(wq), k, n, static_cast<int*>(out));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// xq: [m, k] int8; wq: [k, n] int8; out: [m, n] int32 (every element
// written); all on the device, contiguous, 16-byte aligned. 1 <= m <= 64,
// k % 32 == 0, n % 16 == 0; splits in {1, 2, 4, 8}, at most ceil(k / 64)
// (blocks a column tile, one cluster). Returns 0, a cudaError_t code, or
// -1 for a shape the kernel does not take.
extern "C" int tp_s8_matmul(const void* xq, const void* wq, void* out, int m, int k, int n,
                            int splits, void* stream) {
  if (m <= 0 || m > 64 || k <= 0 || n <= 0 || k % 32 || n % 16) return -1;
  if (splits < 1 || splits > MAX_SPLITS || (splits & (splits - 1)) ||
      splits > (k + SROWS - 1) / SROWS)
    return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch ((m + 7) / 8) {
    case 1: return launch<1>(xq, wq, out, m, k, n, splits, st);
    case 2: return launch<2>(xq, wq, out, m, k, n, splits, st);
    case 3: return launch<3>(xq, wq, out, m, k, n, splits, st);
    case 4: return launch<4>(xq, wq, out, m, k, n, splits, st);
    case 5: return launch<5>(xq, wq, out, m, k, n, splits, st);
    case 6: return launch<6>(xq, wq, out, m, k, n, splits, st);
    case 7: return launch<7>(xq, wq, out, m, k, n, splits, st);
    default: return launch<8>(xq, wq, out, m, k, n, splits, st);
  }
}
