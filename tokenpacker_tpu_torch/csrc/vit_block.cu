// K9: one whole pre-LN CLIP block, from one host call, on Hopper's
// tensor-core path (wgmma) with TMA-fed tiles.
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
// bytes). The TPU kernel kept one image's whole block in VMEM; an SM has
// 227 KB of shared memory and one image's [577, 1024] bf16 rows are 1.18
// MB, so that shape does not carry over. The block enqueues 7 kernels on
// the caller's stream:
//   ln_rows         bf16(LN1(x)) rows into the attention output's buffer
//                   (free until attention runs): one warp a row, fp32;
//   gemm<BIAS>      the three projections (grid z = q, k, v; one tensor
//                   map of the weights each), bias in the epilogue;
//   attention       K1 (vit_attention.cu) on the q, k, v rows;
//   gemm<RESIDUAL>  the o product, bias and the residual add -> x1;
//   ln_rows         bf16(LN2(x1)) rows into q's buffer (free again);
//   gemm<GELU>      fc1, bias and the fp32 quick-GELU -> h [M, F];
//   gemm<RESIDUAL>  fc2, bias and the residual -> out.
// LayerNorm is written once as bf16 rows rather than applied in the
// products' prologue: the products then take A straight from TMA-fed
// shared memory (SS wgmma) and no thread touches the tiles; the rows cost
// one write and one read of [M, W] bf16 each (~5.6 us at 8 views at 3.35
// TB/s, against the block's 0.13 ms bound).
//
// The products (gemm_kernel): an output tile of 128 x BN a block, 288
// threads: two consumer warpgroups of 64 rows and one producer warp. The
// producer's lane 0 streams 64-wide K steps through a ring of 4 stages with
// TMA: A's 128 rows as one 64-column box (K-major), the weight's 64 rows x
// BN columns as BN / 64 boxes (the weights are [in, out] row-major, so B is
// MN-major and takes wgmma's transpose bit; they are read in place, never
// copied). Each consumer issues 4 m64nBNk16 wgmma a step, keeps one step
// in flight and releases the stage before. The fp32 accumulators stay in
// registers; the epilogue adds the bias and does the rest from there and
// writes bf16 pairs. Rows past M arrive as zeros and are not stored; W and
// F are multiples of 128, so no column is ragged. Tiles: 128 x 256 for q/k/v
// and fc1 (154 registers, 193 KB of shared memory: one block an SM), 444
// and 592 of them at 8 views (3.4 and 4.5 waves on 132 SMs); 128 x 128 for
// o and fc2 (n = 1024; 90 registers, 129 KB), 296 (2.2 waves). On an H100
// 128 x 128 everywhere, or two 3-stage blocks of 128 x 128 an SM, measured
// no faster at 8 views and 0-6% slower or faster at 26 (PERF.md). No
// split-K and no atomics: every output element is summed by one thread in
// one order, so two calls give the same bits.

#include "flash_sm90.cuh"

extern "C" int tp_vit_attention(const void* q, const void* k, const void* v, void* o, int n,
                                int t, int w, int heads, void* stream);

namespace {

using namespace sm90;

constexpr int BM = 128, BK = 64;               // output tile rows and K step
constexpr int STAGES = 4;                      // K steps in the ring
constexpr int CONSUMERS = 2;                   // warpgroups of 64 rows
constexpr int THREADS = CONSUMERS * 128 + 32;  // and one producer warp
constexpr int A_BYTES = BM * ROW_BYTES;        // 128 rows x 64 columns
constexpr int B_BOX = BK * ROW_BYTES;          // 64 rows x 64 columns

// A product's tile: BN output columns.
template <int BN_>
struct Tiles {
  static constexpr int BN = BN_;
  static constexpr int STAGE_BYTES = A_BYTES + (BN / 64) * B_BOX;
  static constexpr size_t SMEM_BYTES = 1024 + STAGES * STAGE_BYTES + 8 * 2 * STAGES;
};
// q/k/v and fc1 (n = 3 x 1024 and 4096): 128 x 256 tiles (128 x 128 where n
// is no multiple of 256); o and fc2 (n = 1024): 128 x 128
using Wide = Tiles<256>;
using Narrow = Tiles<128>;

enum Mode { BIAS = 0, RESIDUAL = 1, GELU = 2 };

__device__ __forceinline__ float round_bf(float x) { return __bfloat162float(__float2bfloat16(x)); }

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// y[r] = bf16(LN(x[r]) * scale + shift) of each row of x [m, k] (k % 8 ==
// 0): one warp a row, 16-byte chunks, mean and var = mean((x - mean)^2) in
// fp32 as the TPU kernel's _ln.
__global__ void __launch_bounds__(128)
    ln_rows_kernel(const bf16* __restrict__ x, const bf16* __restrict__ scale,
                   const bf16* __restrict__ shift, bf16* __restrict__ y, int m, int k,
                   float eps) {
  const int row = blockIdx.x * 4 + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= m) return;
  const uint4* xr = reinterpret_cast<const uint4*>(x + (long)row * k);
  const int chunks = k / 8;
  float s = 0.f;
  for (int c = lane; c < chunks; c += 32) {
    const uint4 raw = xr[c];
    const bf16* e = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
    for (int i = 0; i < 8; ++i) s += __bfloat162float(e[i]);
  }
  const float mean = warp_sum(s) / (float)k;
  float v = 0.f;
  for (int c = lane; c < chunks; c += 32) {
    const uint4 raw = xr[c];
    const bf16* e = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float d = __bfloat162float(e[i]) - mean;
      v += d * d;
    }
  }
  const float rstd = rsqrtf(warp_sum(v) / (float)k + eps);
  uint4* yr = reinterpret_cast<uint4*>(y + (long)row * k);
  for (int c = lane; c < chunks; c += 32) {
    const uint4 raw = xr[c], sr = reinterpret_cast<const uint4*>(scale)[c],
                br = reinterpret_cast<const uint4*>(shift)[c];
    const bf16* e = reinterpret_cast<const bf16*>(&raw);
    const bf16* se = reinterpret_cast<const bf16*>(&sr);
    const bf16* be = reinterpret_cast<const bf16*>(&br);
    uint4 out;
    bf16* oe = reinterpret_cast<bf16*>(&out);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float n = (__bfloat162float(e[i]) - mean) * rstd;
      oe[i] = __float2bfloat16(n * __bfloat162float(se[i]) + __bfloat162float(be[i]));
    }
    yr[c] = out;
  }
}

// Up to three products a launch (grid z), sharing A, m, k and n.
struct Epilogue {
  const bf16* bias[3];  // [n]
  bf16* out[3];         // [m, n]
};

// out[z] = epilogue(A W[z] + bias[z]) over a 128 x T::BN tile a block, A
// [m, k] and W[z] [k, n] through their tensor maps (k % 64 == 0, n % T::BN
// == 0):
//   BIAS:     out = bf16(acc + bias);
//   GELU:     out = bf16(g * (1 / (1 + exp(-1.702 g)))), g = acc + bias, fp32;
//   RESIDUAL: out = bf16(res + bf16(acc + bias)).
template <int MODE, class T>
__global__ void __launch_bounds__(THREADS, 1)
    gemm_kernel(const __grid_constant__ CUtensorMap a_map,
                const __grid_constant__ CUtensorMap b_map0,
                const __grid_constant__ CUtensorMap b_map1,
                const __grid_constant__ CUtensorMap b_map2, Epilogue epi,
                const bf16* __restrict__ res, int m, int k, int n) {
  constexpr int BN = T::BN, STAGE_BYTES = T::STAGE_BYTES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align_1024(smem_raw);  // stage s: A, then the weight's boxes
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * STAGE_BYTES);
  uint64_t* empty = full + STAGES;

  const int z = blockIdx.z;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int num_kt = k / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS * 4);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == CONSUMERS * 4) {  // the producer
    if (lane == 0) {
      const CUtensorMap* b_map = z == 0 ? &b_map0 : z == 1 ? &b_map1 : &b_map2;
      for (int kt = 0; kt < num_kt; ++kt) {
        const int s = kt % STAGES;
        if (kt >= STAGES) mbar_wait(&empty[s], (kt / STAGES - 1) & 1);
        unsigned char* st = ring + s * STAGE_BYTES;
        mbar_expect_tx(&full[s], STAGE_BYTES);
        tma_load_2d(st, &a_map, kt * BK, m0, &full[s]);
#pragma unroll
        for (int c = 0; c < BN / 64; ++c)
          tma_load_2d(st + A_BYTES + c * B_BOX, b_map, n0 + 64 * c, kt * BK, &full[s]);
      }
    }
    return;
  }

  // a consumer warpgroup: rows m0 + 64 wg ..; this thread's rows row, row + 8
  const int wg = warp / 4;
  const uint32_t ring_u32 = smem_u32(ring);
  float acc[BN / 2];
  for (int kt = 0; kt < num_kt; ++kt) {
    const int s = kt % STAGES;
    const uint32_t a_tile = ring_u32 + s * STAGE_BYTES + wg * 64 * ROW_BYTES;
    const uint32_t b_tile = ring_u32 + s * STAGE_BYTES + A_BYTES;
    mbar_wait(&full[s], (kt / STAGES) & 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t a = desc_kmajor(a_tile, kk, 0), b = desc_mnmajor(b_tile, kk, B_BOX);
      if constexpr (BN == 256) wgmma_n256_ss_tb(acc, a, b, kt > 0 || kk > 0);
      else wgmma_n128_ss_tb(acc, a, b, kt > 0 || kk > 0);
    }
    wgmma_commit();
    wgmma_wait<1>();  // the step before is done: release its stage
    if (kt > 0 && lane == 0) mbar_arrive(&empty[(kt - 1) % STAGES]);
  }
  wgmma_wait<0>();
  fence_regs(acc);

  const int row = m0 + wg * 64 + (warp % 4) * 16 + lane / 4;
  const int c2 = 2 * (lane % 4);
  const bf16* __restrict__ bias = z == 0 ? epi.bias[0] : z == 1 ? epi.bias[1] : epi.bias[2];
  bf16* __restrict__ out = z == 0 ? epi.out[0] : z == 1 ? epi.out[1] : epi.out[2];
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = n0 + 8 * j + c2;
    const float2 bb = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(bias + col));
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int rr = row + 8 * r;
      if (rr >= m) continue;
      const long off = (long)rr * n + col;
      float y0 = acc[4 * j + 2 * r] + bb.x, y1 = acc[4 * j + 2 * r + 1] + bb.y;
      if (MODE == GELU) {
        y0 = y0 * (1.0f / (1.0f + expf(-1.702f * y0)));
        y1 = y1 * (1.0f / (1.0f + expf(-1.702f * y1)));
      } else if (MODE == RESIDUAL) {
        const float2 rv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(res + off));
        y0 = rv.x + round_bf(y0);
        y1 = rv.y + round_bf(y1);
      }
      *reinterpret_cast<__nv_bfloat162*>(out + off) = __floats2bfloat162_rn(y0, y1);
    }
  }
}

// A [m, k] times `parts` weights [k, n] (grid z), each with its epilogue.
template <int MODE, class T>
int launch_gemm(const bf16* a, const bf16* const (&w)[3], const Epilogue& epi, int parts,
                const bf16* res, int m, int k, int n, cudaStream_t st) {
  if (n % T::BN) return -1;
  const cudaError_t e = cudaFuncSetAttribute(
      gemm_kernel<MODE, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  CUtensorMap a_map, b_map[3];
  int rc = encode_2d(&a_map, a, m, k, BM);
  for (int i = 0; i < parts && rc == 0; ++i) rc = encode_2d(&b_map[i], w[i], k, n, BK);
  if (rc != 0) return rc;
  for (int i = parts; i < 3; ++i) b_map[i] = b_map[0];
  dim3 grid(n / T::BN, (m + BM - 1) / BM, parts);
  gemm_kernel<MODE, T><<<grid, THREADS, T::SMEM_BYTES, st>>>(a_map, b_map[0], b_map[1],
                                                            b_map[2], epi, res, m, k, n);
  return (int)cudaGetLastError();
}

// The q/k/v and fc1 products: 128 x 256 tiles where n allows them.
template <int MODE>
int launch_wide(const bf16* a, const bf16* const (&w)[3], const Epilogue& epi, int parts,
                const bf16* res, int m, int k, int n, cudaStream_t st) {
  if (n % Wide::BN == 0) return launch_gemm<MODE, Wide>(a, w, epi, parts, res, m, k, n, st);
  return launch_gemm<MODE, Narrow>(a, w, epi, parts, res, m, k, n, st);
}

int launch_ln(const bf16* x, const bf16* scale, const bf16* shift, bf16* y, int m, int k,
              float eps, cudaStream_t st) {
  ln_rows_kernel<<<(m + 3) / 4, 128, 0, st>>>(x, scale, shift, y, m, k, eps);
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
//     [n * t, f], and out [n, t, w]; the LayerNorms' bf16 rows go to the
//     attention output's buffer (LN1) and to q's (LN2) while those are free.
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
  int rc;

  if ((rc = launch_ln(x, P(0), P(1), attn, m, w, eps, st))) return rc;
  const bf16* const w_qkv[3] = {P(2), P(4), P(6)};
  const Epilogue qkv = {{P(3), P(5), P(7)}, {q, kk, v}};
  if ((rc = launch_wide<BIAS>(attn, w_qkv, qkv, 3, nullptr, m, w, w, st))) return rc;
  if ((rc = tp_vit_attention(q, kk, v, attn, n, t, w, heads, st))) return rc;

  const bf16* const w_o[3] = {P(8), nullptr, nullptr};
  const Epilogue o = {{P(9), nullptr, nullptr}, {x1, nullptr, nullptr}};
  if ((rc = launch_gemm<RESIDUAL, Narrow>(attn, w_o, o, 1, x, m, w, w, st))) return rc;

  if ((rc = launch_ln(x1, P(10), P(11), q, m, w, eps, st))) return rc;
  const bf16* const w_fc1[3] = {P(12), nullptr, nullptr};
  const Epilogue fc1 = {{P(13), nullptr, nullptr}, {h, nullptr, nullptr}};
  if ((rc = launch_wide<GELU>(q, w_fc1, fc1, 1, nullptr, m, w, f, st))) return rc;

  const bf16* const w_fc2[3] = {P(14), nullptr, nullptr};
  const Epilogue fc2 = {{P(15), nullptr, nullptr}, {out, nullptr, nullptr}};
  return launch_gemm<RESIDUAL, Narrow>(h, w_fc2, fc2, 1, x1, m, f, w, st);
}
