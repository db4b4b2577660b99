// K4: one int8 weight-only LLaMA decode step over every layer, from one
// host call.
//
// Replaces tokenpacker_tpu/ops/fused_decode.py:fused_decode_hidden (T = 1)
// and fused_verify_hidden (T = k+1 fed tokens a sample, speculative
// verify), with or without their slot-LoRA operand (K4-LoRA, below); the
// Pallas `_kernel` behind `_fused_call`. Per
// layer, for B samples and T tokens each (B * T rows, sample-major):
//   RMSNorm(h) * ln1 -> qkv GEMV (int8 weights, f32 sums, f32 per-column
//   scales) -> RoPE on q, k -> with an int8 cache, quantize-dequantize of
//   the new k, v per (row, head) -> attention over the cache ranges
//   [0, len0) U [start2, end2) plus the current token -> o GEMV, h += ao ->
//   RMSNorm(h) * ln2 -> gate/up GEMV -> silu(gate) * up -> down GEMV,
//   h += mo.
//
// What bounds it on the H100: the step streams every int8 weight once
// (Vicuna-7B: 6.48 GB) and the valid cache rows once, at 2 * B FLOP per
// weight byte; with B <= 8 that is far below the ~295 FLOP/byte where the
// tensor cores would be the limit, so the step is bound by bytes at
// 3.35 TB/s. The TPU kernel streamed the weights through one VMEM DMA ring
// inside one pallas_call, because each call cost ~55 us there. The card
// has no such floor, so here `tp_fused_decode` loops over the layers on
// the host and enqueues 9 plain kernels per layer on the caller's stream:
//   gemv_partial   x [B, K] bf16 (optionally RMSNorm(h) * ln, computed in
//                  the prologue) times one int8 [K, N] matrix. Neighbouring
//                  threads take neighbouring 16-byte column groups (16 int8
//                  each), 8 warps split the block's rows, and K is split
//                  over blockIdx.y so that even N = 4096 gives ~256 blocks
//                  for 132 SMs. Partial sums go to a workspace, never to
//                  float atomics, so the result does not depend on timing.
//   *_epilogue     sum the splits in a fixed order, times the scales, then
//                  per matrix: qkv -> RoPE, qdq, the cache-row write; o and
//                  down -> residual add; gate/up -> bf16(silu(g) * u).
//   attention      one block per (head, sample); each warp keeps online
//                  softmax states over a strided share of the valid keys
//                  with 16-byte loads (an int8 row is 8 lanes, a bf16 row
//                  16), merged through shared memory with the current
//                  token's term. Keys outside the ranges are never read.
// One host call per step keeps the property the TPU design was after (no
// per-layer Python work) and can be captured in a CUDA graph later.
//
// The verify form (T > 1) is the same call over B * T rows: fed token t of
// a sample ropes at its own position, writes its row at write_pos + t, and
// attends the sample's cache ranges plus fed tokens 0..t (causal among the
// fed tokens, as the TPU kernel's in-chunk mask). Its GEMVs take B * T > 8
// rows on the tensor cores (gemv_mma_kernel), 32 rows a pass, so a verify
// round of 4 slots x 5 tokens streams the 6.48 GB once, as a plain step
// does; the CUDA-core GEMV, at up to 8 rows a launch, would stream them 3
// times (on an H100: 21.4 ms a round against a 5.9 ms step, PERF.md).
//
// K4-LoRA (multi-LoRA serving; the TPU kernel's `lora` form, _kernel's
// setup and per-layer terms, bundle from build_fd_lora): every slot's
// adapter term beside each of the four products. Per target, A [in, W]
// flattens the n adapters into columns and B [W, out] into rows (W = n *
// rcat, any width), and selm [rows, Wq + Wo + Wg + Wd] is each row's
// column mask (its slot's adapter). The term is
//   u = x @ A (bf16 operands, f32 sums), um = bf16(u * mask), um @ B (f32)
// added in f32 to the scaled base product: qkv before RoPE and the qdq
// of the new k and v (so the cache rows carry the adapter), o and down
// before the bf16 cast and the residual, gate and up before SiLU; x is the
// GEMV's own input (RMSNorm(h) * ln for qkv and gate/up, the attention
// output for o, the MLP activation for down). It adds per layer one
// lora_u launch per target (with a row_rms before the two normed ones):
// u's partial sums over 128-row splits of A, no atomics. The um @ B dot
// runs in the target's epilogue, which already owns one output column a
// thread: the block sums u's splits for its row in a fixed order (the
// same bits in every block), masks and rounds them into shared memory
// LORA_CHUNK columns at a time, and each thread walks B's column, reads
// coalesced across the block. What bounds it: the adapters' bytes, ~5 MB
// a layer at n = 2, r = 16 over all seven targets of Vicuna-7B (B's
// block-diagonal zeros, which it also reads, are not work; ~8 MB with
// them), against K4's 202 MB a layer; the extra launches cost more than
// those bytes at B <= 8. An all-zero mask row gives an exact 0 term, so
// an empty slot keeps K4's output.
//
// Numerics follow the TPU kernel: x and the weights are exact in f32, so
// the GEMVs differ from it only in the order of the sums; RoPE in f32 then
// bf16; the current token's k/v quantize-dequantized with
// scale = max(amax, 1e-8) / 127 and round-half-even (rintf, IEEE division:
// this file must not be built with fast math); attention logits f32, the
// value product with bf16-rounded probabilities and an f32 denominator.
// The cache row is written as kv_quant.quantize_kv of the bf16
// quantize-dequantized row, so it equals what the plain version writes.
// The TPU kernel also rounds each k*q product to bf16 before the head sum;
// this kernel does not. At T > 1 the fed tokens' probabilities are rounded
// to bf16 for the value product like the cache's (the TPU kernel's T > 1
// form); at T = 1 the current token's is not.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <algorithm>
#include <cmath>

namespace {

using bf16 = __nv_bfloat16;

constexpr int HD = 128;               // head_dim (Vicuna)
constexpr int GEMV_WARPS = 8;         // warps per GEMV block, splitting its rows
constexpr int GEMV_UNROLL = 4;        // rows in flight per thread
constexpr int TARGET_BLOCKS = 264;    // 2 per SM on 132 SMs
constexpr int MAX_SPLIT_ROWS = 1024;  // bounds the staged x slice in shared memory
constexpr int MAX_GROUP = 8;          // rows per CUDA-core GEMV launch
constexpr int MMA_ROWS = 32;          // rows per tensor-core GEMV launch (B x T > 8)
constexpr int MMA_COLS = 128, MMA_KS = 64;  // its block's columns and K step
constexpr int EPI_THREADS = 256;
constexpr int ATT_WARPS = 16;
constexpr int ATT_UNROLL = 4;         // key steps in flight per warp
constexpr int PTRS_PER_LAYER = 10;
constexpr int LORA_ROWS = 8;      // rows of x per lora_u block
constexpr int LORA_SPLIT = 128;   // rows of A per lora_u block
constexpr int LORA_CHUNK = 512;   // columns of um an epilogue stages at a time

__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float round_bf(float x) { return __bfloat162float(__float2bfloat16(x)); }

// 4 int8 in one word -> 4 exact floats. b ^ 0x80 = b + 128 goes into the
// low mantissa byte of 2^23, so one PRMT and one FADD replace the slow
// integer-to-float conversion.
__device__ __forceinline__ void i8x4_to_f32(uint32_t word, float* out) {
  const uint32_t u = word ^ 0x80808080u;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[i] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 + i)) - 8388736.0f;
  }
}

// CPT int8 columns from one vector load -> floats
template <int CPT>
struct WeightVec;

template <>
struct WeightVec<16> {
  uint4 raw;
  __device__ __forceinline__ void load(const int8_t* p) {
    raw = __ldcs(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ void zero() { raw = make_uint4(0, 0, 0, 0); }
  __device__ __forceinline__ void to_float(float* out) const {
    i8x4_to_f32(raw.x, out);
    i8x4_to_f32(raw.y, out + 4);
    i8x4_to_f32(raw.z, out + 8);
    i8x4_to_f32(raw.w, out + 12);
  }
};

template <>
struct WeightVec<8> {
  uint2 raw;
  __device__ __forceinline__ void load(const int8_t* p) {
    raw = __ldcs(reinterpret_cast<const uint2*>(p));
  }
  __device__ __forceinline__ void zero() { raw = make_uint2(0, 0); }
  __device__ __forceinline__ void to_float(float* out) const {
    i8x4_to_f32(raw.x, out);
    i8x4_to_f32(raw.y, out + 4);
  }
};

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// partials[b][split][col] = sum over the split's rows k of x[b, k] * W[k, col].
// grid (ceil(n / (32 * CPT)), splits), 256 threads. With ln != nullptr, x is
// the residual stream h and the block uses bf16(bf16(h * inv_rms) * ln),
// inv_rms = 1 / sqrt(mean(h^2) + eps) over the whole row: every block
// computes the same row sums in the same order.
template <int B, int CPT>
__global__ void __launch_bounds__(GEMV_WARPS * 32, 2)
    gemv_partial_kernel(const bf16* __restrict__ x, const bf16* __restrict__ ln, float eps,
                        const int8_t* __restrict__ w, int k, int n, int split_rows,
                        float* __restrict__ partials) {
  constexpr int COLS = 32 * CPT;
  extern __shared__ float smem[];
  float* xs = smem;                   // [B][split_rows]
  float* red = smem + B * split_rows;  // [GEMV_WARPS][COLS]
  __shared__ float inv_rms[B];
  __shared__ float sums[GEMV_WARPS][B];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int split = blockIdx.y;
  const int k0 = split * split_rows;
  const int rows = min(k, k0 + split_rows) - k0;

  if (ln != nullptr) {
    float ss[B];
#pragma unroll
    for (int b = 0; b < B; ++b) {
      ss[b] = 0.f;
      for (int i = tid * 2; i < k; i += GEMV_WARPS * 64) {
        const float2 v = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(x + (long)b * k + i));
        ss[b] += v.x * v.x + v.y * v.y;
      }
      ss[b] = warp_sum(ss[b]);
      if (lane == 0) sums[warp][b] = ss[b];
    }
    __syncthreads();
    if (tid < B) {
      float t = 0.f;
      for (int i = 0; i < GEMV_WARPS; ++i) t += sums[i][tid];
      inv_rms[tid] = 1.0f / sqrtf(t / (float)k + eps);
    }
    __syncthreads();
  }
  for (int i = tid; i < B * rows; i += GEMV_WARPS * 32) {
    const int b = i / rows, r = i % rows;
    float v = to_f(x[(long)b * k + k0 + r]);
    if (ln != nullptr) v = round_bf(round_bf(v * inv_rms[b]) * to_f(ln[k0 + r]));
    xs[b * split_rows + r] = v;
  }
  __syncthreads();

  const int col0 = blockIdx.x * COLS + lane * CPT;
  const bool active = col0 < n;
  float acc[B][CPT];
#pragma unroll
  for (int b = 0; b < B; ++b)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[b][c] = 0.f;

  const int8_t* wp = w + (long)k0 * n + col0;
  int r = warp;
  for (; r + GEMV_WARPS * (GEMV_UNROLL - 1) < rows; r += GEMV_WARPS * GEMV_UNROLL) {
    WeightVec<CPT> wv[GEMV_UNROLL];
#pragma unroll
    for (int u = 0; u < GEMV_UNROLL; ++u) {
      if (active) wv[u].load(wp + (long)(r + u * GEMV_WARPS) * n);
      else wv[u].zero();
    }
#pragma unroll
    for (int u = 0; u < GEMV_UNROLL; ++u) {
      float wf[CPT];
      wv[u].to_float(wf);
      const int rr = r + u * GEMV_WARPS;
#pragma unroll
      for (int b = 0; b < B; ++b) {
        const float xv = xs[b * split_rows + rr];
#pragma unroll
        for (int c = 0; c < CPT; ++c) acc[b][c] = fmaf(xv, wf[c], acc[b][c]);
      }
    }
  }
  for (; r < rows; r += GEMV_WARPS) {
    WeightVec<CPT> wv;
    if (active) wv.load(wp + (long)r * n);
    else wv.zero();
    float wf[CPT];
    wv.to_float(wf);
#pragma unroll
    for (int b = 0; b < B; ++b) {
      const float xv = xs[b * split_rows + r];
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[b][c] = fmaf(xv, wf[c], acc[b][c]);
    }
  }

  // the 8 warps' sums of each column, added in warp order
  const int splits = gridDim.y;
#pragma unroll
  for (int b = 0; b < B; ++b) {
    float4* dst = reinterpret_cast<float4*>(red + warp * COLS + lane * CPT);
#pragma unroll
    for (int c = 0; c < CPT / 4; ++c)
      dst[c] = make_float4(acc[b][4 * c], acc[b][4 * c + 1], acc[b][4 * c + 2], acc[b][4 * c + 3]);
    __syncthreads();
    for (int j = tid; j < COLS; j += GEMV_WARPS * 32) {
      const int col = blockIdx.x * COLS + j;
      float t = 0.f;
#pragma unroll
      for (int i = 0; i < GEMV_WARPS; ++i) t += red[i * COLS + j];
      if (col < n) partials[((long)b * splits + split) * n + col] = t;
    }
    __syncthreads();
  }
}

// How one [k, n] matrix splits its rows: enough blocks for the card at 512
// columns a block, at most MAX_SPLIT_ROWS rows a split, split rows a
// multiple of 32. The plan does not depend on the batch, so every row
// group of a launch and the epilogues agree on it.
struct SplitPlan {
  int split_rows, splits;
};

SplitPlan plan_for(int k, int n) {
  const int col_blocks = (n + 511) / 512;
  int splits = (TARGET_BLOCKS + col_blocks - 1) / col_blocks;
  splits = std::max(splits, (k + MAX_SPLIT_ROWS - 1) / MAX_SPLIT_ROWS);
  splits = std::max(1, std::min(splits, k / 32));
  const int rows = (k + splits - 1) / splits;
  SplitPlan p;
  p.split_rows = (rows + 31) / 32 * 32;
  p.splits = (k + p.split_rows - 1) / p.split_rows;
  return p;
}

template <int B, int CPT>
int launch_gemv(const bf16* x, const bf16* ln, float eps, const int8_t* w, int k, int n,
                float* partials, cudaStream_t stream) {
  const SplitPlan p = plan_for(k, n);
  const size_t smem = sizeof(float) * ((size_t)B * p.split_rows + GEMV_WARPS * 32 * CPT);
  dim3 grid((n + 32 * CPT - 1) / (32 * CPT), p.splits);
  gemv_partial_kernel<B, CPT><<<grid, GEMV_WARPS * 32, smem, stream>>>(x, ln, eps, w, k, n,
                                                                       p.split_rows, partials);
  return (int)cudaGetLastError();
}

// inv_rms[b] = 1 / sqrt(mean(x[b]^2) + eps) for one row per block, 256
// threads, summed in gemv_partial_kernel's order (a thread's stride of 512,
// the warp's butterfly, the warps in order), so both GEMVs normalize a row
// to the same bits.
__global__ void __launch_bounds__(GEMV_WARPS * 32)
    row_rms_kernel(const bf16* __restrict__ x, int k, float eps, float* __restrict__ inv_rms) {
  __shared__ float sums[GEMV_WARPS];
  const int tid = threadIdx.x, b = blockIdx.x;
  float ss = 0.f;
  for (int i = tid * 2; i < k; i += GEMV_WARPS * 64) {
    const float2 v =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(x + (long)b * k + i));
    ss += v.x * v.x + v.y * v.y;
  }
  ss = warp_sum(ss);
  if (tid % 32 == 0) sums[tid / 32] = ss;
  __syncthreads();
  if (tid == 0) {
    float t = 0.f;
    for (int i = 0; i < GEMV_WARPS; ++i) t += sums[i];
    inv_rms[b] = 1.0f / sqrtf(t / (float)k + eps);
  }
}

// The same partial sums for rows b < m <= MMA_ROWS on the tensor cores (a
// verify step's B x T rows). The block stages its split of the rows of x
// once, as the CUDA-core kernel does (bf16 values; with ln, the RMSNorm of
// inv_rms from row_rms_kernel), then each K step widens a 64 x 128 int8
// weight chunk to bf16 in shared memory (exact) and adds the bf16 WMMA
// product in fp32, the next chunk's weights loaded into registers
// meanwhile. One pass over the weights takes all 32 rows; the fp32 sums
// come in the tensor cores' order, so the rows' bits differ from the CUDA-
// core kernel's in the last places. 8 warps, one 16-column slice each
// over both 16-row halves. grid (ceil(n / 128), splits), dynamic shared
// memory mma_smem_bytes(split_rows); rows past the split's end read as 0.
// x's staged columns: the split's rows rounded up to whole K steps (the
// columns past the split read as 0), plus a pad against bank conflicts
__host__ __device__ constexpr int mma_xs_cols(int split_rows) {
  return (split_rows + MMA_KS - 1) / MMA_KS * MMA_KS;
}
__host__ __device__ constexpr int mma_xs_ld(int split_rows) { return mma_xs_cols(split_rows) + 8; }
constexpr int MMA_WS_LD = MMA_COLS + 8, MMA_CS_LD = MMA_COLS + 4;

size_t mma_smem_bytes(int split_rows) {
  const size_t ws = (size_t)MMA_KS * MMA_WS_LD * sizeof(bf16);
  const size_t cs = (size_t)MMA_ROWS * MMA_CS_LD * sizeof(float);
  return (size_t)MMA_ROWS * mma_xs_ld(split_rows) * sizeof(bf16) + std::max(ws, cs);
}

__global__ void __launch_bounds__(GEMV_WARPS * 32)
    gemv_mma_kernel(const bf16* __restrict__ x, int m, const bf16* __restrict__ ln,
                    const float* __restrict__ inv_rms, const int8_t* __restrict__ w, int k, int n,
                    int split_rows, float* __restrict__ partials) {
  namespace wmma = nvcuda::wmma;
  constexpr int CHUNKS = MMA_KS * MMA_COLS / 16 / (GEMV_WARPS * 32);  // 16-byte loads a thread
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int xs_ld = mma_xs_ld(split_rows);
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);                     // [MMA_ROWS][xs_ld]
  bf16* ws = xs + MMA_ROWS * xs_ld;                                   // [MMA_KS][MMA_WS_LD]
  float* cs = reinterpret_cast<float*>(ws);                           // after the loop

  const int tid = threadIdx.x, warp = tid / 32;
  const int split = blockIdx.y, k0 = split * split_rows;
  const int rows = min(k, k0 + split_rows) - k0;
  const int col0 = blockIdx.x * MMA_COLS;

  WeightVec<16> next[CHUNKS];
  auto load = [&](int r0) {
#pragma unroll
    for (int j = 0; j < CHUNKS; ++j) {
      const int i = tid + j * GEMV_WARPS * 32;
      const int r = i / (MMA_COLS / 16), c = (i % (MMA_COLS / 16)) * 16;
      if (col0 + c < n && r0 + r < rows) next[j].load(w + (long)(k0 + r0 + r) * n + col0 + c);
      else next[j].zero();
    }
  };
  load(0);

  // the split's rows of x, 8 at a time (k is a multiple of 16)
  const int xs_chunks = mma_xs_cols(split_rows) / 8;
  for (int i = tid; i < MMA_ROWS * xs_chunks; i += GEMV_WARPS * 32) {
    const int b = i / xs_chunks, r = (i % xs_chunks) * 8;
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (b < m && r < rows) {
      raw = *reinterpret_cast<const uint4*>(x + (long)b * k + k0 + r);
      if (ln != nullptr) {
        bf16* e = reinterpret_cast<bf16*>(&raw);
#pragma unroll
        for (int q = 0; q < 8; ++q)
          e[q] = __float2bfloat16(round_bf(to_f(e[q]) * inv_rms[b]) * to_f(ln[k0 + r + q]));
      }
    }
    *reinterpret_cast<uint4*>(xs + b * xs_ld + r) = raw;
  }

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
  wmma::fill_fragment(acc[0], 0.f);
  wmma::fill_fragment(acc[1], 0.f);
  for (int r0 = 0; r0 < rows; r0 += MMA_KS) {
#pragma unroll
    for (int j = 0; j < CHUNKS; ++j) {  // the loaded chunk, widened into shared memory
      const int i = tid + j * GEMV_WARPS * 32;
      const int r = i / (MMA_COLS / 16), c = (i % (MMA_COLS / 16)) * 16;
      float f[16];
      next[j].to_float(f);
      __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(ws + r * MMA_WS_LD + c);
#pragma unroll
      for (int q = 0; q < 8; ++q) dst[q] = __floats2bfloat162_rn(f[2 * q], f[2 * q + 1]);
    }
    __syncthreads();
    if (r0 + MMA_KS < rows) load(r0 + MMA_KS);
#pragma unroll
    for (int kq = 0; kq < MMA_KS; kq += 16) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
      wmma::load_matrix_sync(fb, ws + kq * MMA_WS_LD + warp * 16, MMA_WS_LD);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::load_matrix_sync(fa, xs + h * 16 * xs_ld + r0 + kq, xs_ld);
        wmma::mma_sync(acc[h], fa, fb, acc[h]);
      }
    }
    __syncthreads();
  }
  wmma::store_matrix_sync(cs + warp * 16, acc[0], MMA_CS_LD, wmma::mem_row_major);
  wmma::store_matrix_sync(cs + 16 * MMA_CS_LD + warp * 16, acc[1], MMA_CS_LD,
                          wmma::mem_row_major);
  __syncthreads();
  const int splits = gridDim.y;
  for (int i = tid; i < m * MMA_COLS; i += GEMV_WARPS * 32) {
    const int b = i / MMA_COLS, c = i % MMA_COLS, col = col0 + c;
    if (col < n) partials[((long)b * splits + split) * n + col] = cs[b * MMA_CS_LD + c];
  }
}

// rows [0, b) of x [b, k] times w [k, n] -> partials [b][splits][n]. Up to
// MAX_GROUP rows (plain decode steps) on the CUDA cores (16 columns a thread
// up to 4 rows, 8 above, to bound the accumulator registers); more (verify
// steps' B x T rows) on the tensor cores, MMA_ROWS a launch, so that a
// verify step streams the weights once as a plain step does.
int gemv(const bf16* x, const bf16* ln, float eps, const int8_t* w, int b, int k, int n,
         float* partials, float* inv_rms, cudaStream_t st) {
  const SplitPlan p = plan_for(k, n);
  if (b > MAX_GROUP) {
    if (ln != nullptr) {
      row_rms_kernel<<<b, GEMV_WARPS * 32, 0, st>>>(x, k, eps, inv_rms);
      const int rc = (int)cudaGetLastError();
      if (rc != 0) return rc;
    }
    const size_t smem = mma_smem_bytes(p.split_rows);
    const cudaError_t e = cudaFuncSetAttribute(
        gemv_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    for (int r0 = 0; r0 < b; r0 += MMA_ROWS) {
      const int g = std::min(MMA_ROWS, b - r0);
      dim3 grid((n + MMA_COLS - 1) / MMA_COLS, p.splits);
      gemv_mma_kernel<<<grid, GEMV_WARPS * 32, smem, st>>>(
          x + (long)r0 * k, g, ln, inv_rms + r0, w, k, n, p.split_rows,
          partials + (long)r0 * p.splits * n);
      const int rc = (int)cudaGetLastError();
      if (rc != 0) return rc;
    }
    return 0;
  }
  int rc;
  switch (b) {
    case 1: rc = launch_gemv<1, 16>(x, ln, eps, w, k, n, partials, st); break;
    case 2: rc = launch_gemv<2, 16>(x, ln, eps, w, k, n, partials, st); break;
    case 3: rc = launch_gemv<3, 16>(x, ln, eps, w, k, n, partials, st); break;
    case 4: rc = launch_gemv<4, 16>(x, ln, eps, w, k, n, partials, st); break;
    case 5: rc = launch_gemv<5, 8>(x, ln, eps, w, k, n, partials, st); break;
    case 6: rc = launch_gemv<6, 8>(x, ln, eps, w, k, n, partials, st); break;
    case 7: rc = launch_gemv<7, 8>(x, ln, eps, w, k, n, partials, st); break;
    default: rc = launch_gemv<8, 8>(x, ln, eps, w, k, n, partials, st); break;
  }
  return rc;
}

// Sum of the splits of partials [b][splits][n] at (row, col), in split order
__device__ __forceinline__ float split_sum(const float* __restrict__ partials, int splits, int n,
                                           int row, int col) {
  const float* p = partials + (long)row * splits * n + col;
  float t = 0.f;
  for (int s = 0; s < splits; ++s) t += p[(long)s * n];
  return t;
}

__device__ __forceinline__ float block_max_128(float v, float* red4) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  __syncthreads();  // red4 may still be read from the previous call
  if (threadIdx.x % 32 == 0) red4[threadIdx.x / 32] = v;
  __syncthreads();
  return fmaxf(fmaxf(red4[0], red4[1]), fmaxf(red4[2], red4[3]));
}

// One target's adapter term in one layer, as an epilogue reads it: u's
// partial sums upart [splits][rows][w] from lora_u_kernel, the rows'
// column mask selm (this target's first column; row stride ldm) and B [w,
// ldb]. w == 0: no term.
struct LoraTarget {
  const float* upart;
  const float* selm;
  const bf16* b;
  int splits, rows, w, ldm, ldb;
};

// upart[split][row][c] = sum over the split's rows r of x'[row, r] * a[r,
// c] for c < w: x' = x or, with ln, bf16(bf16(x * inv_rms[row]) * ln[r])
// as the GEMVs normalize it (inv_rms from row_rms_kernel). a [k, lda]
// bf16, its first w columns used. grid (ceil(k / LORA_SPLIT), ceil(rows /
// LORA_ROWS)), GEMV_WARPS * 32 threads: warp j takes the split's rows j,
// j + 8, ..., a lane one of 32 columns, the warps' sums added in order.
__global__ void __launch_bounds__(GEMV_WARPS * 32)
    lora_u_kernel(const bf16* __restrict__ x, const bf16* __restrict__ ln,
                  const float* __restrict__ inv_rms, int rows, int k,
                  const bf16* __restrict__ a, int lda, int w, float* __restrict__ upart) {
  __shared__ float xs[LORA_ROWS][LORA_SPLIT];
  __shared__ float red[GEMV_WARPS][LORA_ROWS][32];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int split = blockIdx.x, k0 = split * LORA_SPLIT, nk = min(LORA_SPLIT, k - k0);
  const int r0 = blockIdx.y * LORA_ROWS, nr = min(LORA_ROWS, rows - r0);
  for (int i = tid; i < LORA_ROWS * LORA_SPLIT; i += GEMV_WARPS * 32) {
    const int b = i / LORA_SPLIT, r = i % LORA_SPLIT;
    float v = 0.f;
    if (b < nr && r < nk) {
      v = to_f(x[(long)(r0 + b) * k + k0 + r]);
      if (ln != nullptr) v = round_bf(round_bf(v * inv_rms[r0 + b]) * to_f(ln[k0 + r]));
    }
    xs[b][r] = v;
  }
  __syncthreads();
  for (int c0 = 0; c0 < w; c0 += 32) {
    const int c = c0 + lane;
    float acc[LORA_ROWS];
#pragma unroll
    for (int b = 0; b < LORA_ROWS; ++b) acc[b] = 0.f;
    if (c < w) {
#pragma unroll 4
      for (int r = warp; r < nk; r += GEMV_WARPS) {
        const float av = to_f(a[(long)(k0 + r) * lda + c]);
#pragma unroll
        for (int b = 0; b < LORA_ROWS; ++b) acc[b] = fmaf(xs[b][r], av, acc[b]);
      }
    }
#pragma unroll
    for (int b = 0; b < LORA_ROWS; ++b) red[warp][b][lane] = acc[b];
    __syncthreads();
    for (int i = tid; i < LORA_ROWS * 32; i += GEMV_WARPS * 32) {
      const int b = i / 32, l = i % 32;
      if (b < nr && c0 + l < w) {
        float t = 0.f;
#pragma unroll
        for (int q = 0; q < GEMV_WARPS; ++q) t += red[q][b][l];
        upart[((long)split * rows + r0 + b) * w + c0 + l] = t;
      }
    }
    __syncthreads();
  }
}

// The term at output columns col and, with two, col2 of one row: the sum
// over j of um[j] * B[j, col] in f32, um[j] = bf16(sum of u's splits at
// (row, j) * mask[row, j]). um is staged into shared memory (ums,
// LORA_CHUNK floats) a chunk of columns at a time, so any width w works;
// every block of the row sums u's splits in the same order (the loops
// are unrolled so that several loads are in flight; the order of the sums
// stays). All threads of the block call it; one with active false only
// stages.
__device__ __forceinline__ float2 lora_term(const LoraTarget& lt, int row, float* ums,
                                            bool active, int col, bool two, int col2) {
  float t = 0.f, t2 = 0.f;
  for (int j0 = 0; j0 < lt.w; j0 += LORA_CHUNK) {
    const int nj = min(LORA_CHUNK, lt.w - j0);
    for (int j = threadIdx.x; j < nj; j += blockDim.x) {
      float u = 0.f;
#pragma unroll 8
      for (int sp = 0; sp < lt.splits; ++sp)
        u += lt.upart[((long)sp * lt.rows + row) * lt.w + j0 + j];
      ums[j] = round_bf(u * lt.selm[(long)row * lt.ldm + j0 + j]);
    }
    __syncthreads();
    if (active) {
      const bf16* bj = lt.b + (long)j0 * lt.ldb;
#pragma unroll 8
      for (int j = 0; j < nj; ++j, bj += lt.ldb) {
        t = fmaf(ums[j], to_f(bj[col]), t);
        if (two) t2 = fmaf(ums[j], to_f(bj[col2]), t2);
      }
    }
    __syncthreads();
  }
  return make_float2(t, t2);
}

// One (part, head) of one row of the qkv product: part 0 = q, 1 = k,
// 2 = v. grid (3 * heads, b * t_tok), HD threads. The adapter term (lt)
// is added to the scaled sum first; q and k get RoPE (f32), all three are
// rounded to bf16; with an int8 cache k and v are quantize-dequantized.
// The new k/v rows go to k_new / v_new [rows, heads * HD] and into this
// layer's cache (in place) at write_pos[sample] + t for row sample * t_tok
// + t; a slot at or past s_len is not written.
template <bool INT8>
__global__ void __launch_bounds__(HD)
    qkv_epilogue_kernel(const float* __restrict__ partials, int splits,
                        const float* __restrict__ scale, const int* __restrict__ positions,
                        const int* __restrict__ write_pos, int t_tok, float theta, int heads,
                        int s_len,
                        bf16* __restrict__ q_out, bf16* __restrict__ k_new,
                        bf16* __restrict__ v_new, void* cache_k, void* cache_v,
                        float* __restrict__ k_scale, float* __restrict__ v_scale,
                        LoraTarget lt) {
  __shared__ float vals[HD];
  __shared__ float red4[4];
  __shared__ float ums[LORA_CHUNK];
  const int part = blockIdx.x / heads, head = blockIdx.x % heads, row = blockIdx.y;
  const int t = threadIdx.x;
  const int n = 3 * heads * HD;
  const int col = blockIdx.x * HD + t;
  float x = split_sum(partials, splits, n, row, col) * scale[col];
  if (lt.w > 0) x += lora_term(lt, row, ums, true, col, false, 0).x;
  if (part < 2) {
    vals[t] = x;
    __syncthreads();
    const float rot = t < HD / 2 ? -vals[t + HD / 2] : vals[t - HD / 2];
    const float inv_freq = 1.0f / powf(theta, (float)(2 * (t % (HD / 2))) / (float)HD);
    const float f = (float)positions[row] * inv_freq;
    x = x * cosf(f) + rot * sinf(f);
  }
  x = round_bf(x);
  const long out = ((long)row * heads + head) * HD + t;
  if (part == 0) {
    q_out[out] = __float2bfloat16(x);
    return;
  }
  const int sample = row / t_tok, pos = write_pos[sample] + row % t_tok;
  const bool store = pos >= 0 && pos < s_len;
  const long slot = ((long)sample * s_len + pos) * heads + head;
  if (INT8) {
    const float s1 = fmaxf(block_max_128(fabsf(x), red4), 1e-8f) / 127.0f;
    x = round_bf(rintf(x / s1) * s1);
    const float s2 = fmaxf(block_max_128(fabsf(x), red4), 1e-8f) / 127.0f;
    int8_t* cache = static_cast<int8_t*>(part == 1 ? cache_k : cache_v);
    if (store) {
      cache[slot * HD + t] = (int8_t)rintf(x / s2);
      if (t == 0) (part == 1 ? k_scale : v_scale)[slot] = s2;
    }
  } else if (store) {
    static_cast<bf16*>(part == 1 ? cache_k : cache_v)[slot * HD + t] = __float2bfloat16(x);
  }
  (part == 1 ? k_new : v_new)[out] = __float2bfloat16(x);
}

// h[row, col] = bf16(h + bf16(sum * scale + term)); grid (ceil(n / 256), b)
__global__ void __launch_bounds__(EPI_THREADS)
    residual_epilogue_kernel(const float* __restrict__ partials, int splits, int n,
                             const float* __restrict__ scale, bf16* __restrict__ h,
                             LoraTarget lt) {
  __shared__ float ums[LORA_CHUNK];
  const int col = blockIdx.x * EPI_THREADS + threadIdx.x, row = blockIdx.y;
  const float term = lt.w > 0 ? lora_term(lt, row, ums, col < n, col, false, 0).x : 0.f;
  if (col >= n) return;
  float y = split_sum(partials, splits, n, row, col) * scale[col];
  if (lt.w > 0) y += term;
  const long i = (long)row * n + col;
  h[i] = __float2bfloat16(to_f(h[i]) + round_bf(y));
}

// xm[row, col] = bf16(silu(gate) * up), gate = column col, up = f + col of
// the [2f]-wide product, each with its adapter term; grid (ceil(f / 256), b)
__global__ void __launch_bounds__(EPI_THREADS)
    gateup_epilogue_kernel(const float* __restrict__ partials, int splits, int f,
                           const float* __restrict__ scale, bf16* __restrict__ xm,
                           LoraTarget lt) {
  __shared__ float ums[LORA_CHUNK];
  const int col = blockIdx.x * EPI_THREADS + threadIdx.x, row = blockIdx.y;
  const float2 term = lt.w > 0 ? lora_term(lt, row, ums, col < f, col, true, f + col)
                               : make_float2(0.f, 0.f);
  if (col >= f) return;
  float g = split_sum(partials, splits, 2 * f, row, col) * scale[col];
  float u = split_sum(partials, splits, 2 * f, row, f + col) * scale[f + col];
  if (lt.w > 0) {
    g += term.x;
    u += term.y;
  }
  xm[(long)row * f + col] = __float2bfloat16(g / (1.0f + expf(-g)) * u);
}

// Cache element types: LPR lanes hold one head row (16 bytes each, EPL
// elements per lane), so a warp covers 32 / LPR keys per step.
template <typename T>
struct CacheRow;

template <>
struct CacheRow<int8_t> {
  static constexpr int EPL = 16, LPR = HD / EPL;
  // dequantized like kv_quant.dequantize_kv: bf16(q * scale)
  __device__ __forceinline__ static void to_float(const uint4& raw, float scale, float* out) {
    i8x4_to_f32(raw.x, out);
    i8x4_to_f32(raw.y, out + 4);
    i8x4_to_f32(raw.z, out + 8);
    i8x4_to_f32(raw.w, out + 12);
#pragma unroll
    for (int i = 0; i < EPL; ++i) out[i] = round_bf(out[i] * scale);
  }
};

template <>
struct CacheRow<bf16> {
  static constexpr int EPL = 8, LPR = HD / EPL;
  __device__ __forceinline__ static void to_float(const uint4& raw, float, float* out) {
    const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 v = __bfloat1622float2(b[i]);
      out[2 * i] = v.x;
      out[2 * i + 1] = v.y;
    }
  }
};

template <typename T>
struct AttnState {
  static constexpr int EPL = CacheRow<T>::EPL;
  float q[EPL], acc[EPL], m, l;
};

// Folds keys [k0, k1) of this (warp, lane group) into st: keys
// k0 + warp * KPW + grp + i * ATT_WARPS * KPW. ATT_UNROLL keys' raw 16-byte
// K and V loads are in flight before the first is used.
template <typename T>
__device__ __forceinline__ void fold_range(AttnState<T>& st, const T* __restrict__ kc,
                                           const T* __restrict__ vc,
                                           const float* __restrict__ ks,
                                           const float* __restrict__ vs, long row_stride,
                                           int heads, int k0, int k1, float sm_scale) {
  using R = CacheRow<T>;
  constexpr int EPL = R::EPL, LPR = R::LPR, KPW = 32 / LPR, STEP = ATT_WARPS * KPW;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int grp = lane / LPR, sub = lane % LPR;
  for (int base = k0 + warp * KPW + grp; base - grp < k1; base += STEP * ATT_UNROLL) {
    uint4 kraw[ATT_UNROLL], vraw[ATT_UNROLL];
    float kscale[ATT_UNROLL], vscale[ATT_UNROLL];
#pragma unroll
    for (int u = 0; u < ATT_UNROLL; ++u) {
      const int key = base + u * STEP;
      kraw[u] = vraw[u] = make_uint4(0, 0, 0, 0);
      kscale[u] = vscale[u] = 1.f;
      if (key < k1) {
        kraw[u] = *reinterpret_cast<const uint4*>(kc + key * row_stride + sub * EPL);
        vraw[u] = *reinterpret_cast<const uint4*>(vc + key * row_stride + sub * EPL);
        if (ks != nullptr) {
          kscale[u] = ks[(long)key * heads];
          vscale[u] = vs[(long)key * heads];
        }
      }
    }
#pragma unroll
    for (int u = 0; u < ATT_UNROLL; ++u) {
      const int key = base + u * STEP;
      if (key - grp >= k1) break;  // uniform across the warp
      float f[EPL];
      R::to_float(kraw[u], kscale[u], f);
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < EPL; ++i) dot += st.q[i] * f[i];
#pragma unroll
      for (int o = LPR / 2; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
      if (key < k1) {
        R::to_float(vraw[u], vscale[u], f);
        const float logit = dot * sm_scale;
        const float m_new = fmaxf(st.m, logit);
        const float alpha = expf(st.m - m_new);  // 0 for the group's first key
        const float p = expf(logit - m_new);
        const float pb = round_bf(p);
        st.l = st.l * alpha + p;
#pragma unroll
        for (int i = 0; i < EPL; ++i) st.acc[i] = st.acc[i] * alpha + pb * f[i];
        st.m = m_new;
      }
    }
  }
}

// softmax state (m1, l1, acc1) += (m2, l2, acc2)
template <int EPL>
__device__ __forceinline__ void merge_state(float& m1, float& l1, float* acc1, float m2, float l2,
                                            const float* acc2) {
  const float m = fmaxf(m1, m2);
  if (m == -INFINITY) return;  // both empty
  const float f1 = expf(m1 - m), f2 = expf(m2 - m);
  l1 = l1 * f1 + l2 * f2;
#pragma unroll
  for (int i = 0; i < EPL; ++i) acc1[i] = acc1[i] * f1 + acc2[i] * f2;
  m1 = m;
}

// One (head, row) of the attention: grid (heads, b * t_tok), ATT_WARPS
// warps; row = sample * t_tok + t. The cache of this layer is [b, s_len,
// heads, HD] (T), scales [b, s_len, heads] (int8 only), read over the
// sample's ranges. q, k_cur, v_cur: [b * t_tok, heads * HD] bf16, the fed
// tokens; row attends fed tokens 0..t of its sample. out: [b * t_tok,
// heads * HD] bf16. t_tok <= ATT_WARPS (warp j scores fed token j).
template <typename T>
__global__ void __launch_bounds__(ATT_WARPS * 32)
    attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k_cur,
                     const bf16* __restrict__ v_cur, const T* __restrict__ cache_k,
                     const T* __restrict__ cache_v, const float* __restrict__ k_scale,
                     const float* __restrict__ v_scale, const int* __restrict__ len0,
                     const int* __restrict__ start2, const int* __restrict__ end2,
                     bf16* __restrict__ out, int s_len, int heads, int t_tok) {
  using R = CacheRow<T>;
  constexpr int EPL = R::EPL, LPR = R::LPR;
  __shared__ float red_m[ATT_WARPS], red_l[ATT_WARPS], red_acc[ATT_WARPS][HD];
  __shared__ float fed_logit[ATT_WARPS];

  const int head = blockIdx.x, row = blockIdx.y;
  const int sample = row / t_tok, tt = row % t_tok, fed0 = sample * t_tok;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, sub = lane % LPR;
  const float sm_scale = rsqrtf((float)HD);
  const long vec = ((long)row * heads + head) * HD;

  AttnState<T> st;
#pragma unroll
  for (int i = 0; i < EPL; ++i) {
    st.q[i] = to_f(q[vec + sub * EPL + i]);
    st.acc[i] = 0.f;
  }
  st.m = -INFINITY;
  st.l = 0.f;

  if (warp <= tt) {  // fed token `warp`'s logit (the current token's at T = 1)
    const long kvec = ((long)(fed0 + warp) * heads + head) * HD;
    float dot = 0.f;
    for (int i = lane; i < HD; i += 32) dot += to_f(q[vec + i]) * to_f(k_cur[kvec + i]);
    dot = warp_sum(dot);
    if (lane == 0) fed_logit[warp] = dot * sm_scale;
  }

  const int len = min(len0[sample], s_len);
  const int e2 = min(end2[sample], s_len);
  const long row_stride = (long)heads * HD;
  const long base = (long)sample * s_len * row_stride + (long)head * HD;
  const T* kc = cache_k + base;
  const T* vc = cache_v + base;
  const float* ks = k_scale ? k_scale + (long)sample * s_len * heads + head : nullptr;
  const float* vs = v_scale ? v_scale + (long)sample * s_len * heads + head : nullptr;
  fold_range<T>(st, kc, vc, ks, vs, row_stride, heads, 0, len, sm_scale);
  fold_range<T>(st, kc, vc, ks, vs, row_stride, heads, max(start2[sample], len), e2, sm_scale);

  // merge the lane groups of the warp, then the warps through shared memory
#pragma unroll
  for (int o = LPR; o < 32; o <<= 1) {
    float acc2[EPL];
#pragma unroll
    for (int i = 0; i < EPL; ++i) acc2[i] = __shfl_xor_sync(0xffffffffu, st.acc[i], o);
    const float m2 = __shfl_xor_sync(0xffffffffu, st.m, o);
    const float l2 = __shfl_xor_sync(0xffffffffu, st.l, o);
    merge_state<EPL>(st.m, st.l, st.acc, m2, l2, acc2);
  }
  if (lane < LPR) {
#pragma unroll
    for (int i = 0; i < EPL; ++i) red_acc[warp][sub * EPL + i] = st.acc[i];
    if (lane == 0) {
      red_m[warp] = st.m;
      red_l[warp] = st.l;
    }
  }
  __syncthreads();
  if (threadIdx.x < HD) {
    const int t = threadIdx.x;
    float mx = fed_logit[0];
    for (int j = 1; j <= tt; ++j) mx = fmaxf(mx, fed_logit[j]);
    for (int w = 0; w < ATT_WARPS; ++w) mx = fmaxf(mx, red_m[w]);
    float l = 0.f, o = 0.f;
    for (int j = 0; j <= tt; ++j) {
      const float pc = expf(fed_logit[j] - mx);
      const float vj = to_f(v_cur[((long)(fed0 + j) * heads + head) * HD + t]);
      l += pc;
      o += (t_tok > 1 ? round_bf(pc) : pc) * vj;
    }
    for (int w = 0; w < ATT_WARPS; ++w) {
      if (red_m[w] == -INFINITY) continue;  // a warp that saw no key
      const float f = expf(red_m[w] - mx);
      l += red_l[w] * f;
      o += red_acc[w][t] * f;
    }
    out[vec + t] = __float2bfloat16(o / l);
  }
}

size_t align256(size_t x) { return (x + 255) / 256 * 256; }

int lora_splits(int k) { return (k + LORA_SPLIT - 1) / LORA_SPLIT; }

// The workspace of one step: the GEMVs' partial sums, then q, the
// attention output (both [b, d] bf16), the MLP activation [b, f] bf16, the
// rows' inverse RMS [b] f32 (the tensor-core GEMV's and lora_u's) and
// K4-LoRA's u partial sums (the widest d-input target wd, the f-input wf).
struct Workspace {
  size_t q, attn, xm, rms, upart, bytes;
  Workspace(int b, int d, int f, int wd, int wf) {
    size_t floats = 0;
    const int shapes[4][2] = {{d, 3 * d}, {d, d}, {d, 2 * f}, {f, d}};
    for (const auto& kn : shapes)
      floats = std::max(floats, (size_t)b * plan_for(kn[0], kn[1]).splits * kn[1]);
    q = align256(floats * sizeof(float));
    attn = q + align256((size_t)b * d * sizeof(bf16));
    xm = attn + align256((size_t)b * d * sizeof(bf16));
    rms = xm + align256((size_t)b * f * sizeof(bf16));
    upart = rms + align256((size_t)b * sizeof(float));
    const size_t u = std::max((size_t)lora_splits(d) * wd, (size_t)lora_splits(f) * wf);
    bytes = upart + align256((size_t)b * u * sizeof(float));
  }
};

// lora_u over rows [0, b) of x [b, k] for A's columns [0, w) (row stride
// lda), normalizing x with ln first when given; the target's LoraTarget.
int lora_u(const bf16* x, const bf16* ln, float eps, const bf16* a, int lda, int w,
           const float* selm, int ldm, const bf16* bmat, int ldb, int b, int k, float* inv_rms,
           float* upart, cudaStream_t st, LoraTarget* lt) {
  if (ln != nullptr) {
    row_rms_kernel<<<b, GEMV_WARPS * 32, 0, st>>>(x, k, eps, inv_rms);
    const int rc = (int)cudaGetLastError();
    if (rc != 0) return rc;
  }
  const dim3 grid(lora_splits(k), (b + LORA_ROWS - 1) / LORA_ROWS);
  lora_u_kernel<<<grid, GEMV_WARPS * 32, 0, st>>>(x, ln, inv_rms, b, k, a, lda, w, upart);
  lt->upart = upart;
  lt->selm = selm;
  lt->b = bmat;
  lt->splits = lora_splits(k);
  lt->rows = b;
  lt->w = w;
  lt->ldm = ldm;
  lt->ldb = ldb;
  return (int)cudaGetLastError();
}

}  // namespace

// Bytes of the workspace tp_fused_decode needs for this shape; wd, wf: the
// widest d-input and the f-input adapter target (0 without slot LoRA).
extern "C" long long tp_fused_decode_workspace(int b, int d, int f, int wd, int wf) {
  return (long long)Workspace(b, d, f, wd, wf).bytes;
}

// One decode step of the whole decoder stack, for b samples and t_tok fed
// tokens each (t_tok = 1: a plain step; t_tok > 1: a verify step).
//   weights: host array of PTRS_PER_LAYER device pointers per layer: ln1
//     [d] bf16, qkv int8 [d, 3d], qkv scale [3d] f32, o int8 [d, d], o scale,
//     ln2 [d] bf16, gateup int8 [d, 2f], gateup scale, down int8 [f, d],
//     down scale.
//   h: [b * t_tok, d] bf16 (sample-major), the embedded tokens in, the
//     pre-final-norm hidden out.
//   len0, start2, end2, write_pos: [b] int32 on the device; positions:
//     [b * t_tok] int32.
//   cache_k/v: [layers, b, s_len, heads, 128] int8 (kv_int8) or bf16,
//     k_scale/v_scale [layers, b, s_len, heads] f32 (int8 only); the new
//     rows are written at write_pos + t in place (not past s_len).
//   k_new/v_new: [layers, b * t_tok, heads * 128] bf16, the new rows as
//     attended.
//   work: tp_fused_decode_workspace(b * t_tok, d, f, max(lwq, lwo, lwg),
//     lwd) bytes.
//   K4-LoRA (lora_a_d == nullptr: none): lora_a_d [layers, d, lwq + lwo +
//     lwg] bf16 (the A's of qkv | o | gateup), lora_a_f [layers, f, lwd],
//     lora_b_qkv [layers, lwq, 3d], lora_b_o [layers, lwo, d], lora_b_gu
//     [layers, lwg, 2f], lora_b_down [layers, lwd, d] bf16, selm [b *
//     t_tok, lwq + lwo + lwg + lwd] f32; each width >= 1.
// MHA, head_dim 128, d = heads * 128, d and f multiples of 16, 1 <= t_tok
// <= 16. Returns 0, a cudaError_t code, or -1 for a shape it does not take.
extern "C" int tp_fused_decode(const void* const* weights, int layers, int b, int t_tok, int d,
                               int f, int heads, int head_dim, int s_len, float eps, float theta,
                               void* h, const void* len0, const void* start2, const void* end2,
                               const void* write_pos, const void* positions, void* cache_k,
                               void* cache_v, void* k_scale, void* v_scale, int kv_int8,
                               void* k_new, void* v_new, void* work, const void* lora_a_d,
                               const void* lora_a_f, const void* lora_b_qkv,
                               const void* lora_b_o, const void* lora_b_gu,
                               const void* lora_b_down, const void* selm, int lwq, int lwo, int lwg,
                               int lwd, void* stream) {
  const bool lora = lora_a_d != nullptr;
  if (head_dim != HD || heads < 1 || d != heads * HD || d % 16 || f % 16 || f < 32 || b < 1 ||
      t_tok < 1 || t_tok > ATT_WARPS || s_len < 1 || layers < 1 ||
      (kv_int8 && (k_scale == nullptr || v_scale == nullptr)))
    return -1;
  if (lora && (std::min(std::min(lwq, lwo), std::min(lwg, lwd)) < 1 ||
               lora_a_f == nullptr || lora_b_qkv == nullptr || lora_b_o == nullptr ||
               lora_b_gu == nullptr || lora_b_down == nullptr || selm == nullptr))
    return -1;
  if (!lora) lwq = lwo = lwg = lwd = 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  char* wk = static_cast<char*>(work);
  const int rows = b * t_tok;
  const Workspace ws(rows, d, f, std::max(std::max(lwq, lwo), lwg), lwd);
  float* partials = reinterpret_cast<float*>(wk);
  bf16* qbuf = reinterpret_cast<bf16*>(wk + ws.q);
  bf16* attn = reinterpret_cast<bf16*>(wk + ws.attn);
  bf16* xm = reinterpret_cast<bf16*>(wk + ws.xm);
  float* rms = reinterpret_cast<float*>(wk + ws.rms);
  float* upart = reinterpret_cast<float*>(wk + ws.upart);
  const int lwa = lwq + lwo + lwg, lwm = lwa + lwd;
  const float* p_selm = static_cast<const float*>(selm);

  bf16* hb = static_cast<bf16*>(h);
  const int* p_len0 = static_cast<const int*>(len0);
  const int* p_start2 = static_cast<const int*>(start2);
  const int* p_end2 = static_cast<const int*>(end2);
  const int* p_wpos = static_cast<const int*>(write_pos);
  const int* p_pos = static_cast<const int*>(positions);
  const size_t elem = kv_int8 ? 1 : 2;
  const size_t layer_rows = (size_t)b * s_len * heads;
  const int sp_qkv = plan_for(d, 3 * d).splits, sp_o = plan_for(d, d).splits;
  const int sp_gu = plan_for(d, 2 * f).splits, sp_down = plan_for(f, d).splits;
  const dim3 epi_d((d + EPI_THREADS - 1) / EPI_THREADS, rows);
  const dim3 epi_f((f + EPI_THREADS - 1) / EPI_THREADS, rows);
  int rc;

  for (int l = 0; l < layers; ++l) {
    const void* const* w = weights + (size_t)l * PTRS_PER_LAYER;
    const bf16* ln1 = static_cast<const bf16*>(w[0]);
    const int8_t* qkv = static_cast<const int8_t*>(w[1]);
    const float* qkv_s = static_cast<const float*>(w[2]);
    const int8_t* wo = static_cast<const int8_t*>(w[3]);
    const float* wo_s = static_cast<const float*>(w[4]);
    const bf16* ln2 = static_cast<const bf16*>(w[5]);
    const int8_t* gu = static_cast<const int8_t*>(w[6]);
    const float* gu_s = static_cast<const float*>(w[7]);
    const int8_t* down = static_cast<const int8_t*>(w[8]);
    const float* down_s = static_cast<const float*>(w[9]);
    char* ck = static_cast<char*>(cache_k) + l * layer_rows * HD * elem;
    char* cv = static_cast<char*>(cache_v) + l * layer_rows * HD * elem;
    float* ks = kv_int8 ? static_cast<float*>(k_scale) + l * layer_rows : nullptr;
    float* vs = kv_int8 ? static_cast<float*>(v_scale) + l * layer_rows : nullptr;
    bf16* kn = static_cast<bf16*>(k_new) + (size_t)l * rows * d;
    bf16* vn = static_cast<bf16*>(v_new) + (size_t)l * rows * d;
    // this layer's adapter matrices (K4-LoRA)
    auto layer_of = [l](const void* p, size_t per_layer) {
      return p ? static_cast<const bf16*>(p) + (size_t)l * per_layer : nullptr;
    };
    const bf16* la = layer_of(lora_a_d, (size_t)d * lwa);
    const bf16* laf = layer_of(lora_a_f, (size_t)f * lwd);
    const bf16* lbq = layer_of(lora_b_qkv, (size_t)lwq * 3 * d);
    const bf16* lbo = layer_of(lora_b_o, (size_t)lwo * d);
    const bf16* lbg = layer_of(lora_b_gu, (size_t)lwg * 2 * f);
    const bf16* lbd = layer_of(lora_b_down, (size_t)lwd * d);
    LoraTarget lt = {};  // w = 0: no term

    if (lora && (rc = lora_u(hb, ln1, eps, la, lwa, lwq, p_selm, lwm, lbq, 3 * d, rows, d,
                             rms, upart, st, &lt)))
      return rc;
    if ((rc = gemv(hb, ln1, eps, qkv, rows, d, 3 * d, partials, rms, st))) return rc;
    if (kv_int8)
      qkv_epilogue_kernel<true><<<dim3(3 * heads, rows), HD, 0, st>>>(
          partials, sp_qkv, qkv_s, p_pos, p_wpos, t_tok, theta, heads, s_len, qbuf, kn, vn, ck,
          cv, ks, vs, lt);
    else
      qkv_epilogue_kernel<false><<<dim3(3 * heads, rows), HD, 0, st>>>(
          partials, sp_qkv, qkv_s, p_pos, p_wpos, t_tok, theta, heads, s_len, qbuf, kn, vn, ck,
          cv, nullptr, nullptr, lt);
    if ((rc = (int)cudaGetLastError())) return rc;
    if (kv_int8)
      attention_kernel<int8_t><<<dim3(heads, rows), ATT_WARPS * 32, 0, st>>>(
          qbuf, kn, vn, reinterpret_cast<const int8_t*>(ck), reinterpret_cast<const int8_t*>(cv),
          ks, vs, p_len0, p_start2, p_end2, attn, s_len, heads, t_tok);
    else
      attention_kernel<bf16><<<dim3(heads, rows), ATT_WARPS * 32, 0, st>>>(
          qbuf, kn, vn, reinterpret_cast<const bf16*>(ck), reinterpret_cast<const bf16*>(cv),
          nullptr, nullptr, p_len0, p_start2, p_end2, attn, s_len, heads, t_tok);
    if ((rc = (int)cudaGetLastError())) return rc;
    if (lora && (rc = lora_u(attn, nullptr, eps, la + lwq, lwa, lwo, p_selm + lwq, lwm, lbo, d,
                             rows, d, rms, upart, st, &lt)))
      return rc;
    if ((rc = gemv(attn, nullptr, eps, wo, rows, d, d, partials, rms, st))) return rc;
    residual_epilogue_kernel<<<epi_d, EPI_THREADS, 0, st>>>(partials, sp_o, d, wo_s, hb, lt);
    if ((rc = (int)cudaGetLastError())) return rc;
    if (lora && (rc = lora_u(hb, ln2, eps, la + lwq + lwo, lwa, lwg, p_selm + lwq + lwo, lwm,
                             lbg, 2 * f, rows, d, rms, upart, st, &lt)))
      return rc;
    if ((rc = gemv(hb, ln2, eps, gu, rows, d, 2 * f, partials, rms, st))) return rc;
    gateup_epilogue_kernel<<<epi_f, EPI_THREADS, 0, st>>>(partials, sp_gu, f, gu_s, xm, lt);
    if ((rc = (int)cudaGetLastError())) return rc;
    if (lora && (rc = lora_u(xm, nullptr, eps, laf, lwd, lwd, p_selm + lwa, lwm, lbd, d, rows, f,
                             rms, upart, st, &lt)))
      return rc;
    if ((rc = gemv(xm, nullptr, eps, down, rows, f, d, partials, rms, st))) return rc;
    residual_epilogue_kernel<<<epi_d, EPI_THREADS, 0, st>>>(partials, sp_down, d, down_s, hb, lt);
    if ((rc = (int)cudaGetLastError())) return rc;
  }
  return 0;
}
