// K6: the 4-bit (nf4 / int4) dequant-in-kernel matmul for small M, on the
// tensor cores.
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
// far below the ~295 FLOP/byte where the tensor cores would be the limit,
// so it is bound by bytes at 3.35 TB/s. At that rate the card has to
// decode ~25 weights per SM per cycle, about 5 lane-instructions a
// weight: the product itself must not take them. Design:
//   - the product runs on mma.sync.m16n8k16 (bf16 in, fp32 accumulate)
//     with the weight as A: y^T = W^T x^T, x's rows on the 8-wide N side,
//     so m <= 8 wastes no tensor-core work and m = 32 is four n8 tiles of
//     one decoded A fragment. One launch takes every m <= 32: each packed
//     byte and absmax is read once whatever m is;
//   - the packing fits the fragment: byte packed[i, c] holds rows 2i and
//     2i+1 of column c, the pair of consecutive k that one 32-bit register
//     of A holds for one row (here: one output column). A thread's A rows
//     g and g + 8 of n tile j are columns 8g + 2j and 8g + 2j + 1, so its
//     four tiles' bytes are 8 neighbouring bytes of a packed row: one
//     8-byte shared load gives a0 / a1 of four tiles, one more a2 / a3;
//   - each byte is decoded in registers: the nibble indexes a 16-entry
//     fp32 code table in shared memory (lanes read distinct entries or
//     broadcast one: no bank conflicts), times the column's absmax in fp32,
//     rounded to bf16: the bf16 weight that dequantize_4bit(leaf, bf16)
//     builds. A word's 8 nibbles become table offsets in one shift and one
//     mask each half, then one byte permute each;
//   - the decode, not the bytes, takes the instruction slots: a stage's
//     copies are fixed-count, with addresses set up once (a copy loop of
//     run-time trip count cost more instructions than the decode);
//   - a block takes 128 columns; its 4 warps are 2 column halves x 2
//     halves of each quantization block's 4 k steps. Each quantization
//     block's packed tile [32, 128] (chunks swizzled by row, so the 8-byte
//     loads of a warp hit distinct banks), its absmax row and x's
//     [m, 64] slice stream through a 4-stage cp.async ring: the next three
//     blocks are in flight under this one's decode;
//   - k is split across the blocks of a thread-block cluster (whole
//     quantization blocks, balanced; the split count is chosen on the host,
//     ops/q4_matmul.py:q4_splits). Each block leaves its fp32 partial in
//     shared memory; after a cluster barrier block r sums columns [r w, (r
//     + 1) w) of every split's partial through distributed shared memory,
//     in split order, and writes them as bf16: no workspace, no second
//     launch, and two calls give the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "split_merge.cuh"

namespace {

using namespace split_merge;
using bf16 = __nv_bfloat16;

constexpr int QBLOCK = 64;      // rows per absmax (the leaf's block)
constexpr int PROWS = 32;       // packed rows per quantization block
constexpr int NB = 128;         // columns a block
constexpr int THREADS = 128;    // 4 warps: 2 column halves x 2 k halves
constexpr int STAGES = 4;       // quantization blocks in the cp.async ring
constexpr int XSTRIDE = 72;     // bf16 a staged x row: 64 + 8 (conflict-free B loads)
constexpr int MAX_SPLITS = 8;   // the portable cluster size
constexpr int W_BYTES = PROWS * NB;
constexpr int A_BYTES = NB * 4;

template <int MT>
__host__ __device__ constexpr int stage_bytes() {
  return W_BYTES + A_BYTES + MT * 8 * XSTRIDE * 2;
}

// the block's fp32 partial after the loop: [2 k halves][MT * 8 rows][NB]
template <int MT>
constexpr int part_bytes() {
  return 2 * MT * 8 * NB * 4;
}

template <int MT>
constexpr int smem_bytes() {
  return STAGES * stage_bytes<MT>() > part_bytes<MT>() ? STAGES * stage_bytes<MT>()
                                                        : part_bytes<MT>();
}

__constant__ float NF4[16] = {
    -1.0f, -0.6961928009986877f, -0.5250730514526367f, -0.39491748809814453f,
    -0.28444138169288635f, -0.18477343022823334f, -0.09105003625154495f, 0.0f,
    0.07958029955625534f, 0.16093020141124725f, 0.24611230194568634f,
    0.33791524171829224f, 0.44070982933044434f, 0.5626170039176941f,
    0.7229568362236023f, 1.0f};

// The 8 nibbles of a packed word as byte offsets into the code table:
// lo holds the low nibbles x 4 (one a byte), hi the high ones.
struct Nibbles {
  uint32_t lo, hi;
  __device__ __forceinline__ explicit Nibbles(uint32_t w)
      : lo((w << 2) & 0x3C3C3C3Cu), hi((w >> 2) & 0x3C3C3C3Cu) {}
};

__device__ __forceinline__ float code(const float* table, uint32_t offsets, int byte) {
  const uint32_t off = __byte_perm(offsets, 0u, 0x4440u + byte);
  return *reinterpret_cast<const float*>(reinterpret_cast<const char*>(table) + off);
}

// byte B of the word (two rows of one column) -> bf16x2 (the lower row low)
template <int B>
__device__ __forceinline__ uint32_t decode(const float* table, const Nibbles& w, float am) {
  const __nv_bfloat162 v =
      __floats2bfloat162_rn(code(table, w.lo, B) * am, code(table, w.hi, B) * am);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float* c, uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// One n tile of one k step: bytes B0 and B0 + 1 of wa (packed row 8 s +
// t) and wb (row 8 s + t + 4) are A's rows g and g + 8, decoded with their
// columns' absmax, times each of x's MT n8 tiles.
template <int B0, int MT>
__device__ __forceinline__ void n_tile(float (&acc)[MT][4], const float* table, const Nibbles& wa,
                                       const Nibbles& wb, float am0, float am1,
                                       const uint32_t (&b)[MT][2]) {
  const uint32_t a0 = decode<B0>(table, wa, am0), a1 = decode<B0 + 1>(table, wa, am1);
  const uint32_t a2 = decode<B0>(table, wb, am0), a3 = decode<B0 + 1>(table, wb, am1);
#pragma unroll
  for (int i = 0; i < MT; ++i) mma_bf16(acc[i], a0, a1, a2, a3, b[i][0], b[i][1]);
}

// the byte of packed row r (of a stage), column chunk c (16 columns), in
// shared memory: chunks swizzled by the row's low 2 bits
__device__ __forceinline__ int w_offset(int r, int c) {
  return r * NB + ((c ^ ((r & 3) << 1)) << 4);
}

// out rows [0, m) (m <= MT * 8) = x @ W for columns [blockIdx.y * NB, + NB)
// of n; grid (splits, ceil(n / NB)), one cluster of `splits` blocks a
// column tile.
template <int MT>
__global__ void __launch_bounds__(THREADS, 4)
    q4_matmul_kernel(const bf16* __restrict__ x, int m, const uint8_t* __restrict__ packed,
                     const float* __restrict__ absmax, int k, int n, int nf4,
                     bf16* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float table[16];
  constexpr int STAGE = stage_bytes<MT>();
  const int split = blockIdx.x, splits = gridDim.x, col0 = blockIdx.y * NB;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int half = warp & 1, kh = warp >> 1;  // column half, k half
  if (tid < 16) table[tid] = nf4 ? NF4[tid] : (float)(tid - 8) / 7.0f;

  // this split's quantization blocks, balanced
  const int qblocks = k / QBLOCK;
  const int q0 = split * qblocks / splits, q1 = (split + 1) * qblocks / splits;
  const int nq = q1 - q0;

  // This thread's copies of a stage, the same every stage: packed chunks
  // tid and tid + 128 (row j / 8, 16 columns j % 8), absmax chunk tid (tid
  // < 32), x chunks tid (+ 128) of MT * 64 (row j / 8, 8 k's j % 8); a
  // stage moves the sources on by one quantization block.
  constexpr int XCHUNKS = MT * 64, XLOADS = (XCHUNKS + THREADS - 1) / THREADS;
  const uint8_t* w_src[2];
  int w_dst[2];
  bool w_ok[2];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int j = tid + u * THREADS, r = j / 8, c = j % 8, col = col0 + 16 * c;
    w_ok[u] = col < n;
    w_src[u] = w_ok[u] ? packed + (long)r * n + col : packed;
    w_dst[u] = w_offset(r, c);
  }
  const long w_step = (long)PROWS * n;
  const bool a_ok = tid < NB / 4 && col0 + 4 * tid < n;
  const float* a_src = a_ok ? absmax + col0 + 4 * tid : absmax;
  const bf16* x_src[XLOADS];
  int x_dst[XLOADS];
  bool x_ok[XLOADS];
#pragma unroll
  for (int u = 0; u < XLOADS; ++u) {
    const int j = tid + u * THREADS, r = j / 8, c = j % 8;
    x_ok[u] = j < XCHUNKS && r < m;
    x_src[u] = x_ok[u] ? x + (long)r * k + 8 * c : x;
    x_dst[u] = W_BYTES + A_BYTES + r * XSTRIDE * 2 + 16 * c;
  }
  auto load = [&](int i) {
    unsigned char* st = smem + (i % STAGES) * STAGE;
    const int qb = q0 + i;
#pragma unroll
    for (int u = 0; u < 2; ++u)
      cp_async_16(st + w_dst[u], w_src[u] + (w_ok[u] ? qb * w_step : 0), w_ok[u]);
    if (tid < NB / 4) cp_async_16(st + W_BYTES + 16 * tid, a_src + (a_ok ? (long)qb * n : 0), a_ok);
#pragma unroll
    for (int u = 0; u < XLOADS; ++u)
      if (tid + u * THREADS < XCHUNKS)
        cp_async_16(st + x_dst[u], x_src[u] + (x_ok[u] ? qb * QBLOCK : 0), x_ok[u]);
  };

  float acc[4][MT][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][i][e] = 0.f;

#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < nq) load(i);
    cp_async_commit();
  }
  for (int it = 0; it < nq; ++it) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage it landed; every thread is done with stage it - 1
    if (it + STAGES - 1 < nq) load(it + STAGES - 1);
    cp_async_commit();
    const unsigned char* st = smem + (it % STAGES) * STAGE;
    const float4* am4 = reinterpret_cast<const float4*>(st + W_BYTES) + (64 * half + 8 * g) / 4;
    const float4 am_lo = am4[0], am_hi = am4[1];
    const float am[8] = {am_lo.x, am_lo.y, am_lo.z, am_lo.w, am_hi.x, am_hi.y, am_hi.z, am_hi.w};
    const bf16* xs = reinterpret_cast<const bf16*>(st + W_BYTES + A_BYTES);
    const int c = 4 * half + g / 2, byte8 = 8 * (g & 1);
#pragma unroll
    for (int s2 = 0; s2 < 2; ++s2) {
      const int s = 2 * kh + s2;  // k step: packed rows 8 s .. 8 s + 7
      const uint2 wa = *reinterpret_cast<const uint2*>(st + w_offset(8 * s + t, c) + byte8);
      const uint2 wb = *reinterpret_cast<const uint2*>(st + w_offset(8 * s + t + 4, c) + byte8);
      uint32_t b[MT][2];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const bf16* xr = xs + (8 * i + g) * XSTRIDE + 16 * s + 2 * t;
        b[i][0] = *reinterpret_cast<const uint32_t*>(xr);
        b[i][1] = *reinterpret_cast<const uint32_t*>(xr + 8);
      }
      // n tile j: A rows g, g + 8 are columns 8 g + 2 j, 8 g + 2 j + 1
      const Nibbles wa0(wa.x), wa1(wa.y), wb0(wb.x), wb1(wb.y);
      n_tile<0>(acc[0], table, wa0, wb0, am[0], am[1], b);
      n_tile<2>(acc[1], table, wa0, wb0, am[2], am[3], b);
      n_tile<0>(acc[2], table, wa1, wb1, am[4], am[5], b);
      n_tile<2>(acc[3], table, wa1, wb1, am[6], am[7], b);
    }
  }

  // the block's partial into the free ring: c0 / c2 (row 8 i + 2 t) and
  // c1 / c3 (row 8 i + 2 t + 1) of columns 8 g + 2 j, + 1
  cp_async_wait<0>();
  __syncthreads();
  float* part = reinterpret_cast<float*>(smem);  // [2][MT * 8][NB]
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int col = 64 * half + 8 * g + 2 * j, row = 8 * i + 2 * t;
      float* p = part + (kh * MT * 8 + row) * NB + col;
      *reinterpret_cast<float2*>(p) = make_float2(acc[j][i][0], acc[j][i][2]);
      *reinterpret_cast<float2*>(p + NB) = make_float2(acc[j][i][1], acc[j][i][3]);
    }

  // block `split` sums its slice of the columns over every split's partial
  // (both k halves), in split order, through distributed shared memory
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int width = NB / splits, quads = width / 4;
  for (int j = tid; j < m * quads; j += THREADS) {
    const int row = j / quads, col = split * width + 4 * (j % quads);
    float4 v[2 * MAX_SPLITS];
#pragma unroll
    for (int r = 0; r < MAX_SPLITS; ++r) {
      if (r < splits) {
        const float* remote = cluster.map_shared_rank(part, r);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          v[2 * r + hh] =
              *reinterpret_cast<const float4*>(remote + (hh * MT * 8 + row) * NB + col);
      }
    }
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int r = 0; r < 2 * MAX_SPLITS; ++r) {
      if (r < 2 * splits) {
        sum.x += v[r].x;
        sum.y += v[r].y;
        sum.z += v[r].z;
        sum.w += v[r].w;
      }
    }
    if (col0 + col < n) {
      __nv_bfloat162 lo = __floats2bfloat162_rn(sum.x, sum.y);
      __nv_bfloat162 hi = __floats2bfloat162_rn(sum.z, sum.w);
      uint2 pack;
      pack.x = *reinterpret_cast<const uint32_t*>(&lo);
      pack.y = *reinterpret_cast<const uint32_t*>(&hi);
      *reinterpret_cast<uint2*>(out + (long)row * n + col0 + col) = pack;
    }
  }
  cluster.sync();  // the others' partials are read: they may exit
}

template <int MT>
int launch(const void* x, const void* packed, const void* absmax, void* out, int m, int k, int n,
           int nf4, int splits, cudaStream_t stream) {
  auto* kernel = q4_matmul_kernel<MT>;
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
  e = cudaLaunchKernelEx(&cfg, kernel, static_cast<const bf16*>(x), m,
                         static_cast<const uint8_t*>(packed), static_cast<const float*>(absmax), k,
                         n, nf4, static_cast<bf16*>(out));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// x: [m, k] bf16; packed: [k/2, n] uint8; absmax: [k/64, n] f32; out:
// [m, n] bf16; all on the device, contiguous, 16-byte aligned. nf4 = 1 for
// the nf4 codebook, 0 for int4. 1 <= m <= 32, k % 64 == 0, n % 16 == 0;
// splits in {1, 2, 4, 8}, at most k / 64 (blocks a column tile, one
// cluster). Returns 0, a cudaError_t code, or -1 for a shape the kernel
// does not take.
extern "C" int tp_q4_matmul(const void* x, const void* packed, const void* absmax, void* out,
                            int m, int k, int n, int nf4, int splits, void* stream) {
  if (m <= 0 || m > 32 || k <= 0 || n <= 0 || k % QBLOCK || n % 16) return -1;
  if (splits < 1 || splits > MAX_SPLITS || (splits & (splits - 1)) || splits > k / QBLOCK)
    return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch ((m + 7) / 8) {
    case 1: return launch<1>(x, packed, absmax, out, m, k, n, nf4, splits, st);
    case 2: return launch<2>(x, packed, absmax, out, m, k, n, nf4, splits, st);
    case 3: return launch<3>(x, packed, absmax, out, m, k, n, nf4, splits, st);
    default: return launch<4>(x, packed, absmax, out, m, k, n, nf4, splits, st);
  }
}
