// K8: the large-M w8a8 GEMM for Hopper: a row-quantize pass, then int8
// wgmma on a TMA ring.
//
// Replaces tokenpacker_tpu/ops/s8_gemm.py:s8_gemm (its Pallas `_kernel`).
//
// y [m, n] bf16 = bf16((f32(xq @ wq) * ax) * wscale), where each row of x
// [m, k] bf16 is quantized as quantize_activations does: ax = max(max |x|,
// 1e-8) / 127, xq = round-half-even(x / ax) (IEEE division: this file must
// not be built with fast math), |xq| <= 127. wq [k, n] int8, wscale [1, n]
// f32. The int32 sums are exact.
//
// What bounds it on the H100: at the serving shapes (m >= 256, k and n of
// 1024-22016) it does 2 m k n int8 operations on ~(2 m k + k n + 2 m n)
// bytes, hundreds of operations a byte: bound by the int8 tensor-core rate
// (1,979 TOPS dense) more than by bytes. The TPU kernel quantized the rows
// of its M tile once into VMEM; here two launches on the caller's stream:
//   quantize_rows  one warp a row reads x once (16-byte loads), takes the
//                  absmax, then writes xq [m, k] int8 and ax [m] f32 to
//                  device memory (24 MB moved at m = 2048, k = 4096: ~8 us
//                  against a GEMM of hundreds); the GEMM reads them back
//                  from L2 for each column tile. parts=True returns them.
//   gemm           persistent, one block an SM walking output tiles of
//                  BM x 128: BM / 64 consumer warpgroups of 64 rows, four
//                  transposer warps and one producer warp, a ring of 4 K
//                  steps of 128 bytes. BM = 128 up to m = 512 (m = 256 then
//                  fills 192 tiles), 192 above: a taller tile brings more
//                  operations a byte from L2, 192 rows is the tallest whose
//                  64 accumulators a thread fit the 544 threads' registers
//                  (96, no spills), and 4 stages of it fill 225 KB.
// wgmma takes 8-bit operands from shared memory K-major only (the transpose
// bit exists for 16-bit types), and the int8 leaves are [k, n], N-major for
// B; they stay so, since K7, the weight-only route and the weights bridge
// read that layout and a transposed copy of Vicuna-7B's would add ~6.5 GB.
// So each stage holds three tiles:
//   A  xq's BM rows x 128 k by TMA (K-major, 128-byte swizzle);
//   W  wq's 128 k rows x 128 columns by TMA (N-major staging, swizzled too);
//   B  W turned K-major by the transposer warps: each thread reads 16 k
//      rows of 4 columns (16 conflict-free 4-byte loads), turns the 4 x 4
//      byte squares with __byte_perm (int8_rows.cuh:transpose4) and writes
//      4 column rows of 16 k bytes into the swizzled K-major layout that
//      wgmma reads (the 4 stores rotated by lane so that the 32 lanes hit 8
//      distinct 16-byte slots: no bank conflicts); then fence.proxy.async
//      and an arrive on the stage's own barrier.
// The consumers wait on the TMA barrier and the transposers' barrier, issue
// four m64n128k32 s32.s8.s8 wgmma a step (int32 accumulators in registers),
// keep one step in flight and release the stage before. The swapped
// product y^T = wq^T xq^T (wq^T from registers, RS) was the other way round
// the layout; it needs the same byte transpose plus a shuffle per fragment
// and a transposed epilogue, so the SS form with separate transposer warps
// was kept: the transposes overlap the products of the steps before.
// Measured on an H100 (PERF.md): the transposes cost 10-27% (the
// same kernel without them, its sums wrong, ran 1.1-1.4x faster); with
// 128 x 128 tiles the products take 32 KB from L2 a K step for 4.2 M
// operations, and the kernel ran at 360-630 TOPS; 256 x 128 tiles (two
// sub-tiles a warpgroup, 168 registers) spilled. Tiles run in groups of 8
// along M so that neighbouring blocks reuse a weight tile from L2. The
// epilogue scales in f32 in the plain version's order and writes bf16
// pairs; rows past m arrive from TMA as zeros and are not stored. k and n
// are multiples of 128 (the routing condition of ops/layers.py); no
// split-K and no atomics, so two calls give the same bits.

#include "flash_sm90.cuh"
#include "int8_rows.cuh"

namespace {

using namespace sm90;

constexpr int BN = 128, BK = 128;  // tile columns; K step (bytes)
constexpr int STAGES = 4;
constexpr int TRANSPOSERS = 4;  // warps
constexpr int W_BYTES = BK * BN, B_BYTES = BN * BK;
constexpr int GROUP_M = 8;  // M tiles a group of the tile order

// An output tile of 64 C rows x BN: C consumer warpgroups of 64 rows (64
// int32 accumulators a thread), the transposer warps and a producer warp.
template <int C>
struct Tile {
  static constexpr int CONSUMERS = C, BM = 64 * C;
  static constexpr int THREADS = C * 128 + TRANSPOSERS * 32 + 32;
  static constexpr int A_BYTES = BM * BK, STAGE_BYTES = A_BYTES + W_BYTES + B_BYTES;
  static constexpr size_t SMEM_BYTES = 1024 + STAGES * STAGE_BYTES + 3 * 8 * STAGES;
};

#define TP_IACC8(i)                                                                           \
  "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]), "+r"(d[i + 4]), "+r"(d[i + 5]), \
      "+r"(d[i + 6]), "+r"(d[i + 7])

// d[64] (+)= A B, m64n128k32, s8 x s8 -> s32, both from shared memory,
// K-major. Integer wgmma has no scale or transpose operands.
__device__ __forceinline__ void wgmma_s8_n128(int (&d)[64], uint64_t a, uint64_t b,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n}\n"
      : TP_IACC8(0), TP_IACC8(8), TP_IACC8(16), TP_IACC8(24), TP_IACC8(32), TP_IACC8(40),
        TP_IACC8(48), TP_IACC8(56)
      : "l"(a), "l"(b), "r"(accumulate));
}

#undef TP_IACC8

template <int N>
__device__ __forceinline__ void fence_iregs(int (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

__device__ __forceinline__ uint32_t quant_byte(float v, float ax) {
  const float q = fminf(fmaxf(rintf(v / ax), -127.f), 127.f);
  return (uint32_t)((int)q & 0xFF);
}

// xq[r] = round(x[r] / ax[r]), ax[r] = max(max |x[r]|, 1e-8) / 127: one warp
// a row, 16-byte loads (k % 128 == 0), the second pass from L1/L2.
__global__ void __launch_bounds__(256)
    quantize_rows_kernel(const bf16* __restrict__ x, int8_t* __restrict__ xq,
                         float* __restrict__ ax, int m, int k) {
  const int row = blockIdx.x * 8 + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= m) return;
  const uint4* xr = reinterpret_cast<const uint4*>(x + (long)row * k);
  const int chunks = k / 8;
  float mx = 0.f;
  for (int c = lane; c < chunks; c += 32) {
    const uint4 raw = xr[c];
    const __nv_bfloat162* e = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(e[i]);
      mx = fmaxf(mx, fmaxf(fabsf(f.x), fabsf(f.y)));
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  const float a = fmaxf(mx, 1e-8f) / 127.0f;
  if (lane == 0) ax[row] = a;
  uint2* qr = reinterpret_cast<uint2*>(xq + (long)row * k);
  for (int c = lane; c < chunks; c += 32) {
    const uint4 raw = xr[c];
    const __nv_bfloat162* e = reinterpret_cast<const __nv_bfloat162*>(&raw);
    uint32_t word[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float2 lo = __bfloat1622float2(e[2 * h]), hi = __bfloat1622float2(e[2 * h + 1]);
      word[h] = quant_byte(lo.x, a) | (quant_byte(lo.y, a) << 8) | (quant_byte(hi.x, a) << 16) |
                (quant_byte(hi.y, a) << 24);
    }
    qr[c] = make_uint2(word[0], word[1]);
  }
}

// One transposer thread's share of a K step: 16 k rows (chunk kc) of the 4
// columns 4 lane .. 4 lane + 3 of the N-major staging tile `w`, written as
// 4 rows of 16 k bytes of the K-major tile `b`. Both tiles are 128-byte
// rows with the 128-byte swizzle (16-byte slot j of row r at j ^ (r % 8)).
__device__ __forceinline__ void transpose_chunk(const unsigned char* w, unsigned char* b, int kc,
                                                int lane) {
  uint32_t sq[4][4];  // [4-row square][column]: the column's 4 k bytes
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    uint32_t r[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kr = 16 * kc + 4 * q + i;
      r[i] = *reinterpret_cast<const uint32_t*>(w + kr * 128 + (((lane / 4) ^ (kr % 8)) * 16) +
                                                (lane % 4) * 4);
    }
    transpose4(r[0], r[1], r[2], r[3], sq[q]);
  }
  uint4 col[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) col[c] = make_uint4(sq[0][c], sq[1][c], sq[2][c], sq[3][c]);
  // rotate by rot = (lane / 4) % 4, so that store j writes column (j + rot)
  // % 4: the 32 lanes' rows then cover all 8 swizzle slots
  const int rot = (lane / 4) % 4;
  if (rot & 1) {
    const uint4 t = col[0];
    col[0] = col[1];
    col[1] = col[2];
    col[2] = col[3];
    col[3] = t;
  }
  if (rot & 2) {
    const uint4 t0 = col[0], t1 = col[1];
    col[0] = col[2];
    col[1] = col[3];
    col[2] = t0;
    col[3] = t1;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int row = 4 * lane + ((j + rot) & 3);
    *reinterpret_cast<uint4*>(b + row * 128 + ((kc ^ (row % 8)) * 16)) = col[j];
  }
}

// The tile order, grouped along M: GROUP_M row tiles walk each column tile
// in turn, so that neighbouring blocks reuse a weight tile from L2.
__device__ __forceinline__ void tile_origin(int tile, int bm, int tiles_m, int tiles_n, int& m0,
                                            int& n0) {
  const int per_group = GROUP_M * tiles_n;
  const int first_m = (tile / per_group) * GROUP_M;
  const int group_m = min(tiles_m - first_m, GROUP_M);
  const int in_group = tile % per_group;
  m0 = (first_m + in_group % group_m) * bm;
  n0 = (in_group / group_m) * BN;
}

// y = bf16((f32(A W) * ax) * wscale) over T's tiles; A = xq [m, k] and W =
// wq [k, n] through their tensor maps. Persistent: block b takes tiles b,
// b + gridDim.x, ...; the ring's step count runs on across its tiles, so
// the producer and the transposers fill the next tile's stages while the
// consumers write this tile's outputs.
template <class T>
__global__ void __launch_bounds__(T::THREADS, 1)
    s8_gemm_kernel(const __grid_constant__ CUtensorMap a_map,
                   const __grid_constant__ CUtensorMap w_map, const float* __restrict__ ax,
                   const float* __restrict__ wscale, bf16* __restrict__ y,
                   int* __restrict__ acc_out, int m, int k, int n) {
  constexpr int CONSUMERS = T::CONSUMERS, BM = T::BM;
  constexpr int A_BYTES = T::A_BYTES, STAGE_BYTES = T::STAGE_BYTES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align_1024(smem_raw);  // stage s: A, W (staging), B
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * STAGE_BYTES);
  uint64_t* bfull = full + STAGES;
  uint64_t* empty = bfull + STAGES;

  const int tiles_m = (m + BM - 1) / BM, tiles_n = n / BN, tiles = tiles_m * tiles_n;
  const int num_kt = k / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&bfull[s], TRANSPOSERS * 32);
      mbar_init(&empty[s], CONSUMERS * 4);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == CONSUMERS * 4 + TRANSPOSERS) {  // the producer
    if (lane == 0) {
      int it = 0;  // ring steps so far
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        int m0, n0;
        tile_origin(tile, BM, tiles_m, tiles_n, m0, n0);
        for (int kt = 0; kt < num_kt; ++kt, ++it) {
          const int s = it % STAGES;
          if (it >= STAGES) mbar_wait(&empty[s], (it / STAGES - 1) & 1);
          unsigned char* st = ring + s * STAGE_BYTES;
          mbar_expect_tx(&full[s], A_BYTES + W_BYTES);
          tma_load_2d(st, &a_map, kt * BK, m0, &full[s]);
          tma_load_2d(st + A_BYTES, &w_map, n0, kt * BK, &full[s]);
        }
      }
    }
    return;
  }
  if (warp >= CONSUMERS * 4) {  // a transposer: chunks kc = tw, tw + TRANSPOSERS, ..
    const int tw = warp - CONSUMERS * 4;
    const int steps = (tiles - blockIdx.x + gridDim.x - 1) / gridDim.x * num_kt;
    for (int it = 0; it < steps; ++it) {
      const int s = it % STAGES;
      unsigned char* st = ring + s * STAGE_BYTES;
      mbar_wait(&full[s], (it / STAGES) & 1);
      for (int kc = tw; kc < BK / 16; kc += TRANSPOSERS)
        transpose_chunk(st + A_BYTES, st + A_BYTES + W_BYTES, kc, lane);
      fence_proxy_async();
      mbar_arrive(&bfull[s]);
    }
    return;
  }

  // a consumer warpgroup: rows m0 + 64 wg ..; this thread's rows row, row + 8
  const int wg = warp / 4;
  const uint32_t ring_u32 = smem_u32(ring);
  int it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    int m0, n0;
    tile_origin(tile, BM, tiles_m, tiles_n, m0, n0);
    int acc[64];
    for (int kt = 0; kt < num_kt; ++kt, ++it) {
      const int s = it % STAGES;
      const uint32_t a_tile = ring_u32 + s * STAGE_BYTES + wg * 64 * 128;
      const uint32_t b_tile = ring_u32 + s * STAGE_BYTES + A_BYTES + W_BYTES;
      mbar_wait(&full[s], (it / STAGES) & 1);
      mbar_wait(&bfull[s], (it / STAGES) & 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 32; ++kk)
        wgmma_s8_n128(acc, desc_kmajor(a_tile, kk, 0), desc_kmajor(b_tile, kk, 0),
                      kt > 0 || kk > 0);
      wgmma_commit();
      wgmma_wait<1>();  // the step before is done: release its stage
      if (kt > 0 && lane == 0) mbar_arrive(&empty[(it - 1) % STAGES]);
    }
    wgmma_wait<0>();
    fence_iregs(acc);
    if (lane == 0) mbar_arrive(&empty[(it - 1) % STAGES]);

    const int row = m0 + wg * 64 + (warp % 4) * 16 + lane / 4;
    const int c2 = 2 * (lane % 4);
    float a_row[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) a_row[r] = row + 8 * r < m ? ax[row + 8 * r] : 0.f;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = n0 + 8 * j + c2;
      const float2 ws = *reinterpret_cast<const float2*>(wscale + col);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int rr = row + 8 * r;
        if (rr >= m) continue;
        const long off = (long)rr * n + col;
        const int c0 = acc[4 * j + 2 * r], c1 = acc[4 * j + 2 * r + 1];
        *reinterpret_cast<__nv_bfloat162*>(y + off) =
            __floats2bfloat162_rn((float)c0 * a_row[r] * ws.x, (float)c1 * a_row[r] * ws.y);
        if (acc_out != nullptr) *reinterpret_cast<int2*>(acc_out + off) = make_int2(c0, c1);
      }
    }
  }
}

int sm_count() {
  static const int count = [] {
    int dev = 0, c = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&c, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      return 132;
    return c;
  }();
  return count;
}

// The GEMM over the quantized rows, persistent: one block an SM.
template <class T>
int launch_gemm(const void* xq, const void* wq, const void* ax, const void* wscale, void* y,
                void* acc_out, int m, int k, int n, cudaStream_t st) {
  const cudaError_t e = cudaFuncSetAttribute(
      s8_gemm_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  CUtensorMap a_map, w_map;
  int rc = encode_2d_s8(&a_map, xq, m, k, T::BM);
  if (rc == 0) rc = encode_2d_s8(&w_map, wq, k, n, BK);
  if (rc != 0) return rc;
  const int tiles = (m + T::BM - 1) / T::BM * (n / BN);
  s8_gemm_kernel<T><<<min(tiles, sm_count()), T::THREADS, T::SMEM_BYTES, st>>>(
      a_map, w_map, static_cast<const float*>(ax), static_cast<const float*>(wscale),
      static_cast<bf16*>(y), static_cast<int*>(acc_out), m, k, n);
  return (int)cudaGetLastError();
}

}  // namespace

// x: [m, k] bf16; wq: [k, n] int8; wscale: [n] f32; y: [m, n] bf16; xq
// [m, k] int8 and ax [m] f32 receive the quantized rows (the GEMM reads
// them); the optional acc_out [m, n] int32 may be null. All on the device,
// contiguous, 16-byte aligned; k % 128 == 0 and n % 128 == 0 (the serving
// path's routing condition). Returns 0, a cudaError_t code, or -1 for a
// shape the kernel does not take.
extern "C" int tp_s8_gemm(const void* x, const void* wq, const void* wscale, void* y, int m,
                          int k, int n, void* xq, void* ax, void* acc_out, void* stream) {
  if (m <= 0 || k <= 0 || n <= 0 || k % 128 || n % 128 || xq == nullptr || ax == nullptr)
    return -1;
  const auto st = static_cast<cudaStream_t>(stream);
  quantize_rows_kernel<<<(m + 7) / 8, 256, 0, st>>>(static_cast<const bf16*>(x),
                                                    static_cast<int8_t*>(xq),
                                                    static_cast<float*>(ax), m, k);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  // 128-row tiles up to m = 512 (m = 256 fills 192 of them), 192 above
  return m <= 512 ? launch_gemm<Tile<2>>(xq, wq, ax, wscale, y, acc_out, m, k, n, st)
                  : launch_gemm<Tile<3>>(xq, wq, ax, wscale, y, acc_out, m, k, n, st);
}
