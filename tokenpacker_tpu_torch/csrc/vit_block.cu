// K9: one whole pre-LN CLIP block, from one host call.
//
// Replaces tokenpacker_tpu/ops/vit_block.py:vit_block (the Pallas `_kernel`):
// on x [N, T, W], with one layer's dense params,
//   x1  = x + bf16(attention(bf16(LN1(x)) Wq/Wk/Wv + b) Wo + bo)
//   out = x1 + bf16(bf16(quick_gelu(bf16(LN2(x1)) W1 + b1)) W2 + b2)
// with the TPU kernel's numerics: LayerNorm in fp32, rounded to bf16 before
// each product; every product bf16 x bf16 with fp32 sums, plus the fp32
// bias, then rounded; attention logits in fp32, exp2 with log2(e) folded
// into the scale, bf16 probabilities whose row sum is taken over the
// rounded values, one divide at the output; quick-GELU in fp32; the
// residual adds in bf16.
//
// What bounds it on the H100: at [8, 577, 1024] with F = 4096 the six
// products are 2 * 4616 * (4 * 1024^2 + 2 * 1024 * 4096) ~ 116 GFLOP and
// attention ~11 GFLOP, against ~44 MB of weights and hidden state, so the
// tensor cores bound it (~0.13 ms at the dense bf16 rate, ~0.013 ms of
// bytes). The TPU kernel kept one image's whole block (~50 MB of blocks)
// in VMEM so that the hidden stream made one HBM round trip a layer; an
// SM has 227 KB of shared memory and one image's [577, 1024] bf16 rows are
// 1.18 MB, so that shape does not carry over. This first form enqueues 7
// kernels a block on the caller's stream:
//   ln_stats        mean and 1/sqrt(var + eps) of each row (one warp a
//                   row, two passes in fp32), 8 bytes a row;
//   gemm<LN_QKV>    the three projections (grid z = q, k, v): the A tile is
//                   read from x and normalized as it is staged into shared
//                   memory (LN1 in the prologue of the product, so bf16(LN1
//                   (x)) never reaches device memory), bias in the epilogue;
//   attention       per (64-query tile, head, image) with K1's device code
//                   (attention_tile.cuh: online softmax, bf16 WMMA);
//   gemm<RESIDUAL>  the o product, bias and the residual add in its
//                   epilogue -> x1;
//   ln_stats        of x1;
//   gemm<LN_GELU>   fc1 with LN2 in its prologue, bias and the fp32
//                   quick-GELU in its epilogue -> h [M, F];
//   gemm<RESIDUAL>  fc2, bias and the residual -> out.
// The GEMM tile is 128 x 128 with K steps of 32, eight warps of 32 x 64,
// bf16 WMMA 16x16x16 with fp32 accumulators; each step's tiles are loaded
// into registers during the previous step's products (no cp.async or TMA
// ring yet).
// Counting each [M, W] tensor once for every kernel that reads or writes
// it, the hidden stream makes 16 passes through device memory a block here
// (x: 3 reads; q, k, v: written and read; the attention output: written
// and read; x1: written, read 3 times; out: written), against about 24 for
// the per-op block (LayerNorm outputs, separate residual adds, the
// activation pass over h), and h [M, F] is written and read once instead
// of twice each way. The TPU kernel's one round trip would take keeping a
// row block's whole block on chip, a later form.
// Every row and column edge is masked: T = 577 = 9 * 64 + 1 and M = N * T
// is no multiple of any tile.

#include "attention_tile.cuh"

namespace {

using tp::bf16;
namespace wmma = nvcuda::wmma;

constexpr int BM = 128, BN = 128, BKS = 32;  // GEMM block tile and K step
constexpr int GEMM_THREADS = 256;            // 8 warps, 4 x 2 over the tile
constexpr int A_LD = BKS + 8, B_LD = BN + 8;  // padded smem rows

enum Mode { LN_QKV = 0, RESIDUAL = 1, LN_GELU = 2 };

__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float round_bf(float x) { return __bfloat162float(__float2bfloat16(x)); }

// stats[2 * r] = mean, stats[2 * r + 1] = 1 / sqrt(var + eps) of row r of
// x [m, k]; one warp a row, var = mean((x - mean)^2) as the TPU kernel.
__global__ void __launch_bounds__(128)
    ln_stats_kernel(const bf16* __restrict__ x, float* __restrict__ stats, int m, int k,
                    float eps) {
  const int row = blockIdx.x * 4 + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= m) return;
  const bf16* xr = x + (long)row * k;
  float s = 0.f;
  for (int i = lane; i < k; i += 32) s += to_f(xr[i]);
  const float mean = tp::warp_sum(s) / (float)k;
  float v = 0.f;
  for (int i = lane; i < k; i += 32) {
    const float c = to_f(xr[i]) - mean;
    v += c * c;
  }
  const float var = tp::warp_sum(v) / (float)k;
  if (lane == 0) {
    stats[2 * row] = mean;
    stats[2 * row + 1] = rsqrtf(var + eps);
  }
}

// Up to three products a launch (grid z), sharing A, m, k and n.
struct GemmArgs {
  const bf16* w[3];     // [k, n] row-major
  const bf16* bias[3];  // [n]
  bf16* out[3];         // [m, n]
};

// A thread's share of one K step: 2 chunks of 8 bf16 of the A tile (128
// rows x 32) and 2 of the B tile (32 rows x 128), loaded from device
// memory one step ahead of the products that use them.
struct Stage {
  uint4 a[2], b[2];
};

__device__ __forceinline__ void load_stage(Stage& st, const bf16* __restrict__ a,
                                           const bf16* __restrict__ w, int row0, int col0,
                                           int k0, int m, int k, int n) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int i = threadIdx.x + j * GEMM_THREADS;
    const int ar = i / (BKS / 8), ac = (i % (BKS / 8)) * 8;
    st.a[j] = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + ar < m) st.a[j] = *reinterpret_cast<const uint4*>(a + (long)(row0 + ar) * k + k0 + ac);
    const int br = i / (BN / 8), bc = (i % (BN / 8)) * 8;
    st.b[j] = make_uint4(0u, 0u, 0u, 0u);
    if (col0 + bc < n) st.b[j] = *reinterpret_cast<const uint4*>(w + (long)(k0 + br) * n + col0 + bc);
  }
}

// out[z] = epilogue(A W[z] + bias[z]) over a 128 x 128 tile per block.
//   LN_QKV, LN_GELU: A = bf16(LN(a)) with the rows' stats and ln scale /
//     bias [k], computed as the tile is staged into shared memory;
//   LN_QKV: out = bf16(acc + bias);
//   LN_GELU: out = bf16(g * (1 / (1 + exp(-1.702 g)))), g = acc + bias, fp32;
//   RESIDUAL: out = bf16(res + bf16(acc + bias)).
// 8 warps, each 32 x 64 of the tile (2 x 4 WMMA accumulators); the next K
// step's tiles are loaded into registers while the current one's products
// run. k % 32 == 0, n % 8 == 0; rows and columns past m and n are masked.
template <int MODE>
__global__ void __launch_bounds__(GEMM_THREADS, 2)
    gemm_kernel(const bf16* __restrict__ a, const float* __restrict__ stats,
                const bf16* __restrict__ ln_s, const bf16* __restrict__ ln_b,
                const bf16* __restrict__ res, GemmArgs args, int m, int k, int n) {
  __shared__ __align__(128) bf16 As[BM * A_LD];
  __shared__ __align__(128) bf16 Bs[BKS * B_LD];
  __shared__ __align__(128) float stage_c[GEMM_THREADS / 32][16 * 16];
  __shared__ float row_mean[BM], row_rstd[BM];

  const int z = blockIdx.z;
  const bf16* __restrict__ w = args.w[z];
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 64;

  if (MODE != RESIDUAL && threadIdx.x < BM) {
    const int r = row0 + threadIdx.x;
    row_mean[threadIdx.x] = r < m ? stats[2 * r] : 0.f;
    row_rstd[threadIdx.x] = r < m ? stats[2 * r + 1] : 0.f;
  }

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  Stage st;
  load_stage(st, a, w, row0, col0, 0, m, k, n);
  __syncthreads();  // the row statistics

  for (int k0 = 0; k0 < k; k0 += BKS) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int i = threadIdx.x + j * GEMM_THREADS;
      const int ar = i / (BKS / 8), ac = (i % (BKS / 8)) * 8;
      uint4 raw = st.a[j];
      if (MODE != RESIDUAL && row0 + ar < m) {
        bf16* e = reinterpret_cast<bf16*>(&raw);
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const float y = (to_f(e[q]) - row_mean[ar]) * row_rstd[ar];
          e[q] = __float2bfloat16(y * to_f(ln_s[k0 + ac + q]) + to_f(ln_b[k0 + ac + q]));
        }
      }
      *reinterpret_cast<uint4*>(As + ar * A_LD + ac) = raw;
      const int br = i / (BN / 8), bc = (i % (BN / 8)) * 8;
      *reinterpret_cast<uint4*>(Bs + br * B_LD + bc) = st.b[j];
    }
    __syncthreads();
    if (k0 + BKS < k) load_stage(st, a, w, row0, col0, k0 + BKS, m, k, n);
#pragma unroll
    for (int kk = 0; kk < BKS; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(fa[i], As + (wm + 16 * i) * A_LD + kk, A_LD);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fb, Bs + kk * B_LD + wn + 16 * j, B_LD);
#pragma unroll
        for (int i = 0; i < 2; ++i) wmma::mma_sync(acc[i][j], fa[i], fb, acc[i][j]);
      }
    }
    __syncthreads();  // every warp is done with As/Bs before the next stage is stored
  }

  // the epilogue, one 16 x 16 accumulator at a time through the warp's
  // own staging area
  const bf16* __restrict__ bias = args.bias[z];
  bf16* __restrict__ out = args.out[z];
  float* sc = stage_c[warp];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(sc, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int row = row0 + wm + 16 * i + e / 16, col = col0 + wn + 16 * j + e % 16;
        if (row < m && col < n) {
          const float g = sc[e] + to_f(bias[col]);
          const long o = (long)row * n + col;
          float y;
          if (MODE == LN_QKV) {
            y = g;
          } else if (MODE == LN_GELU) {
            y = g * (1.0f / (1.0f + expf(-1.702f * g)));
          } else {
            y = to_f(res[o]) + round_bf(g);
          }
          out[o] = __float2bfloat16(y);
        }
      }
      __syncwarp();
    }
  }
}

// One 64-query tile of one head of one image: softmax(q k^T / 8) v with
// K1's device code; q, k, v, o are [n, t, w] rows, the head's 64 columns.
__global__ void __launch_bounds__(tp::THREADS)
    attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o, int t, int w) {
  extern __shared__ __align__(128) unsigned char smem[];
  const long base = (long)blockIdx.z * t * w + (long)blockIdx.y * 64;
  tp::attention_tile<64>(q + base, w, k + base, w, v + base, w, o + base, w, nullptr, t, t,
                         blockIdx.x * tp::BQ, false, rsqrtf(64.f), smem);
}

template <int MODE>
int launch_gemm(const bf16* a, const float* stats, const bf16* ln_s, const bf16* ln_b,
                const bf16* res, const GemmArgs& args, int parts, int m, int k, int n,
                cudaStream_t st) {
  dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM, parts);
  gemm_kernel<MODE><<<grid, GEMM_THREADS, 0, st>>>(a, stats, ln_s, ln_b, res, args, m, k, n);
  return (int)cudaGetLastError();
}

}  // namespace

// One CLIP block.
//   params: host array of 16 device pointers, all bf16: ln1 scale,
//     ln1 bias [w], then kernel and bias of q, k, v, o ([w, w], [w]), ln2
//     scale, ln2 bias [w], fc1 kernel [w, f], bias [f], fc2 kernel [f, w],
//     bias [w].
//   bufs: host array of 8 device pointers, bf16: x [n, t, w] (in), the
//     scratch q, k, v, attention output and x1 ([n * t, w] each), h
//     [n * t, f], and out [n, t, w], whose first 8 * n * t bytes hold the
//     LayerNorms' row statistics until fc2 writes it.
// head_dim 64 (w = heads * 64), w and f multiples of 128. Returns 0, a
// cudaError_t code, or -1 for a shape it does not take.
extern "C" int tp_vit_block(const void* const* params, const void* const* bufs, int n, int t,
                            int w, int f, int heads, float eps, void* stream) {
  if (n < 1 || t < 1 || heads < 1 || w != heads * 64 || w % 128 || f % 128 || f < 128) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto P = [&](int i) { return static_cast<const bf16*>(params[i]); };
  const auto B = [&](int i) { return static_cast<bf16*>(const_cast<void*>(bufs[i])); };
  const bf16* x = B(0);
  bf16 *q = B(1), *kk = B(2), *v = B(3), *attn = B(4), *x1 = B(5), *h = B(6), *out = B(7);
  const int m = n * t;
  float* stats = reinterpret_cast<float*>(out);
  int rc;

  ln_stats_kernel<<<(m + 3) / 4, 128, 0, st>>>(x, stats, m, w, eps);
  if ((rc = (int)cudaGetLastError())) return rc;
  GemmArgs qkv = {{P(2), P(4), P(6)}, {P(3), P(5), P(7)}, {q, kk, v}};
  if ((rc = launch_gemm<LN_QKV>(x, stats, P(0), P(1), nullptr, qkv, 3, m, w, w, st))) return rc;

  const size_t smem = tp::tile_smem_bytes<64>();
  cudaError_t e = cudaFuncSetAttribute(attention_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  attention_kernel<<<dim3((t + tp::BQ - 1) / tp::BQ, heads, n), tp::THREADS, smem, st>>>(
      q, kk, v, attn, t, w);
  if ((rc = (int)cudaGetLastError())) return rc;

  GemmArgs o = {{P(8), nullptr, nullptr}, {P(9), nullptr, nullptr}, {x1, nullptr, nullptr}};
  if ((rc = launch_gemm<RESIDUAL>(attn, nullptr, nullptr, nullptr, x, o, 1, m, w, w, st)))
    return rc;

  ln_stats_kernel<<<(m + 3) / 4, 128, 0, st>>>(x1, stats, m, w, eps);
  if ((rc = (int)cudaGetLastError())) return rc;
  GemmArgs fc1 = {{P(12), nullptr, nullptr}, {P(13), nullptr, nullptr}, {h, nullptr, nullptr}};
  if ((rc = launch_gemm<LN_GELU>(x1, stats, P(10), P(11), nullptr, fc1, 1, m, w, f, st)))
    return rc;

  GemmArgs fc2 = {{P(14), nullptr, nullptr}, {P(15), nullptr, nullptr}, {out, nullptr, nullptr}};
  return launch_gemm<RESIDUAL>(h, nullptr, nullptr, nullptr, x1, fc2, 1, m, f, w, st);
}
