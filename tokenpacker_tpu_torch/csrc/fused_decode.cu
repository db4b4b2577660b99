// K4: one int8 weight-only LLaMA decode step over every layer, from one
// host call.
//
// Replaces tokenpacker_tpu/ops/fused_decode.py:fused_decode_hidden (T = 1,
// no slot LoRA; the Pallas `_kernel` behind `_fused_call`). Per layer, for
// B samples and one token each:
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
// Numerics follow the TPU kernel: x and the weights are exact in f32, so
// the GEMVs differ from it only in the order of the sums; RoPE in f32 then
// bf16; the current token's k/v quantize-dequantized with
// scale = max(amax, 1e-8) / 127 and round-half-even (rintf, IEEE division:
// this file must not be built with fast math); attention logits f32, the
// value product with bf16-rounded probabilities and an f32 denominator.
// The cache row is written as kv_quant.quantize_kv of the bf16
// quantize-dequantized row, so it equals what the plain version writes.
// The TPU kernel also rounds each k*q product to bf16 before the head sum;
// this kernel does not.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
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
constexpr int MAX_GROUP = 8;          // rows per GEMV launch (B > 8 runs in groups)
constexpr int EPI_THREADS = 256;
constexpr int ATT_WARPS = 16;
constexpr int ATT_UNROLL = 4;         // key steps in flight per warp
constexpr int PTRS_PER_LAYER = 10;

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

// rows [0, b) of x [b, k] times w [k, n] -> partials [b][splits][n], in
// launches of at most MAX_GROUP rows (16 columns a thread up to 4 rows, 8
// above, to bound the accumulator registers)
int gemv(const bf16* x, const bf16* ln, float eps, const int8_t* w, int b, int k, int n,
         float* partials, cudaStream_t st) {
  const int splits = plan_for(k, n).splits;
  for (int r0 = 0; r0 < b; r0 += MAX_GROUP) {
    const int g = std::min(MAX_GROUP, b - r0);
    const bf16* xg = x + (long)r0 * k;
    float* pg = partials + (long)r0 * splits * n;
    int rc;
    switch (g) {
      case 1: rc = launch_gemv<1, 16>(xg, ln, eps, w, k, n, pg, st); break;
      case 2: rc = launch_gemv<2, 16>(xg, ln, eps, w, k, n, pg, st); break;
      case 3: rc = launch_gemv<3, 16>(xg, ln, eps, w, k, n, pg, st); break;
      case 4: rc = launch_gemv<4, 16>(xg, ln, eps, w, k, n, pg, st); break;
      case 5: rc = launch_gemv<5, 8>(xg, ln, eps, w, k, n, pg, st); break;
      case 6: rc = launch_gemv<6, 8>(xg, ln, eps, w, k, n, pg, st); break;
      case 7: rc = launch_gemv<7, 8>(xg, ln, eps, w, k, n, pg, st); break;
      default: rc = launch_gemv<8, 8>(xg, ln, eps, w, k, n, pg, st); break;
    }
    if (rc != 0) return rc;
  }
  return 0;
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

// One (part, head) of one row of the qkv product: part 0 = q, 1 = k,
// 2 = v. grid (3 * heads, b), HD threads. q and k get RoPE (f32), all
// three are rounded to bf16; with an int8 cache k and v are
// quantize-dequantized. The new k/v rows go to k_new / v_new [b, heads * HD]
// and into this layer's cache at write_pos (in place).
template <bool INT8>
__global__ void __launch_bounds__(HD)
    qkv_epilogue_kernel(const float* __restrict__ partials, int splits,
                        const float* __restrict__ scale, const int* __restrict__ positions,
                        const int* __restrict__ write_pos, float theta, int heads, int s_len,
                        bf16* __restrict__ q_out, bf16* __restrict__ k_new,
                        bf16* __restrict__ v_new, void* cache_k, void* cache_v,
                        float* __restrict__ k_scale, float* __restrict__ v_scale) {
  __shared__ float vals[HD];
  __shared__ float red4[4];
  const int part = blockIdx.x / heads, head = blockIdx.x % heads, row = blockIdx.y;
  const int t = threadIdx.x;
  const int n = 3 * heads * HD;
  const int col = blockIdx.x * HD + t;
  float x = split_sum(partials, splits, n, row, col) * scale[col];
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
  const long slot = ((long)row * s_len + write_pos[row]) * heads + head;
  if (INT8) {
    const float s1 = fmaxf(block_max_128(fabsf(x), red4), 1e-8f) / 127.0f;
    x = round_bf(rintf(x / s1) * s1);
    const float s2 = fmaxf(block_max_128(fabsf(x), red4), 1e-8f) / 127.0f;
    int8_t* cache = static_cast<int8_t*>(part == 1 ? cache_k : cache_v);
    cache[slot * HD + t] = (int8_t)rintf(x / s2);
    if (t == 0) (part == 1 ? k_scale : v_scale)[slot] = s2;
  } else {
    static_cast<bf16*>(part == 1 ? cache_k : cache_v)[slot * HD + t] = __float2bfloat16(x);
  }
  (part == 1 ? k_new : v_new)[out] = __float2bfloat16(x);
}

// h[row, col] = bf16(h + bf16(sum * scale)); grid (ceil(n / 256), b)
__global__ void __launch_bounds__(EPI_THREADS)
    residual_epilogue_kernel(const float* __restrict__ partials, int splits, int n,
                             const float* __restrict__ scale, bf16* __restrict__ h) {
  const int col = blockIdx.x * EPI_THREADS + threadIdx.x, row = blockIdx.y;
  if (col >= n) return;
  const float y = round_bf(split_sum(partials, splits, n, row, col) * scale[col]);
  const long i = (long)row * n + col;
  h[i] = __float2bfloat16(to_f(h[i]) + y);
}

// xm[row, col] = bf16(silu(gate) * up), gate = column col, up = f + col of
// the [2f]-wide product; grid (ceil(f / 256), b)
__global__ void __launch_bounds__(EPI_THREADS)
    gateup_epilogue_kernel(const float* __restrict__ partials, int splits, int f,
                           const float* __restrict__ scale, bf16* __restrict__ xm) {
  const int col = blockIdx.x * EPI_THREADS + threadIdx.x, row = blockIdx.y;
  if (col >= f) return;
  const float g = split_sum(partials, splits, 2 * f, row, col) * scale[col];
  const float u = split_sum(partials, splits, 2 * f, row, f + col) * scale[f + col];
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

// One (head, row) of the decode attention: grid (heads, b), ATT_WARPS warps.
// The cache of this layer is [b, s_len, heads, HD] (T), scales [b, s_len,
// heads] (int8 only). q, k_cur, v_cur: [b, heads * HD] bf16, the current
// token; out: [b, heads * HD] bf16.
template <typename T>
__global__ void __launch_bounds__(ATT_WARPS * 32)
    attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k_cur,
                     const bf16* __restrict__ v_cur, const T* __restrict__ cache_k,
                     const T* __restrict__ cache_v, const float* __restrict__ k_scale,
                     const float* __restrict__ v_scale, const int* __restrict__ len0,
                     const int* __restrict__ start2, const int* __restrict__ end2,
                     bf16* __restrict__ out, int s_len, int heads) {
  using R = CacheRow<T>;
  constexpr int EPL = R::EPL, LPR = R::LPR;
  __shared__ float red_m[ATT_WARPS], red_l[ATT_WARPS], red_acc[ATT_WARPS][HD];
  __shared__ float cur_logit;

  const int head = blockIdx.x, row = blockIdx.y;
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

  if (warp == 0) {  // the current token's logit
    float dot = 0.f;
    for (int i = lane; i < HD; i += 32) dot += to_f(q[vec + i]) * to_f(k_cur[vec + i]);
    dot = warp_sum(dot);
    if (lane == 0) cur_logit = dot * sm_scale;
  }

  const int len = min(len0[row], s_len);
  const int e2 = min(end2[row], s_len);
  const long row_stride = (long)heads * HD;
  const long base = (long)row * s_len * row_stride + (long)head * HD;
  const T* kc = cache_k + base;
  const T* vc = cache_v + base;
  const float* ks = k_scale ? k_scale + (long)row * s_len * heads + head : nullptr;
  const float* vs = v_scale ? v_scale + (long)row * s_len * heads + head : nullptr;
  fold_range<T>(st, kc, vc, ks, vs, row_stride, heads, 0, len, sm_scale);
  fold_range<T>(st, kc, vc, ks, vs, row_stride, heads, max(start2[row], len), e2, sm_scale);

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
    float mx = cur_logit;
    for (int w = 0; w < ATT_WARPS; ++w) mx = fmaxf(mx, red_m[w]);
    const float pc = expf(cur_logit - mx);
    float l = pc, o = pc * to_f(v_cur[vec + t]);
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

// The workspace of one step: the GEMVs' partial sums, then q, the
// attention output (both [b, d] bf16) and the MLP activation [b, f] bf16.
struct Workspace {
  size_t q, attn, xm, bytes;
  Workspace(int b, int d, int f) {
    size_t floats = 0;
    const int shapes[4][2] = {{d, 3 * d}, {d, d}, {d, 2 * f}, {f, d}};
    for (const auto& kn : shapes)
      floats = std::max(floats, (size_t)b * plan_for(kn[0], kn[1]).splits * kn[1]);
    q = align256(floats * sizeof(float));
    attn = q + align256((size_t)b * d * sizeof(bf16));
    xm = attn + align256((size_t)b * d * sizeof(bf16));
    bytes = xm + align256((size_t)b * f * sizeof(bf16));
  }
};

}  // namespace

// Bytes of the workspace tp_fused_decode needs for this shape.
extern "C" long long tp_fused_decode_workspace(int b, int d, int f) {
  return (long long)Workspace(b, d, f).bytes;
}

// One decode step of the whole decoder stack.
//   weights: host array of PTRS_PER_LAYER device pointers per layer: ln1
//     [d] bf16, qkv int8 [d, 3d], qkv scale [3d] f32, o int8 [d, d], o scale,
//     ln2 [d] bf16, gateup int8 [d, 2f], gateup scale, down int8 [f, d],
//     down scale.
//   h: [b, d] bf16, the embedded tokens in, the pre-final-norm hidden out.
//   len0, start2, end2, write_pos, positions: [b] int32 on the device.
//   cache_k/v: [layers, b, s_len, heads, 128] int8 (kv_int8) or bf16,
//     k_scale/v_scale [layers, b, s_len, heads] f32 (int8 only); the new
//     rows are written at write_pos in place.
//   k_new/v_new: [layers, b, heads * 128] bf16, the new rows as attended.
// MHA, head_dim 128, d = heads * 128, d and f multiples of 16. Returns 0,
// a cudaError_t code, or -1 for a shape it does not take.
extern "C" int tp_fused_decode(const void* const* weights, int layers, int b, int d, int f,
                               int heads, int head_dim, int s_len, float eps, float theta,
                               void* h, const void* len0, const void* start2, const void* end2,
                               const void* write_pos, const void* positions, void* cache_k,
                               void* cache_v, void* k_scale, void* v_scale, int kv_int8,
                               void* k_new, void* v_new, void* work, void* stream) {
  if (head_dim != HD || heads < 1 || d != heads * HD || d % 16 || f % 16 || f < 32 || b < 1 ||
      s_len < 1 || layers < 1 || (kv_int8 && (k_scale == nullptr || v_scale == nullptr)))
    return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  char* wk = static_cast<char*>(work);
  const Workspace ws(b, d, f);
  float* partials = reinterpret_cast<float*>(wk);
  bf16* qbuf = reinterpret_cast<bf16*>(wk + ws.q);
  bf16* attn = reinterpret_cast<bf16*>(wk + ws.attn);
  bf16* xm = reinterpret_cast<bf16*>(wk + ws.xm);

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
  const dim3 epi_d((d + EPI_THREADS - 1) / EPI_THREADS, b);
  const dim3 epi_f((f + EPI_THREADS - 1) / EPI_THREADS, b);
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
    bf16* kn = static_cast<bf16*>(k_new) + (size_t)l * b * d;
    bf16* vn = static_cast<bf16*>(v_new) + (size_t)l * b * d;

    if ((rc = gemv(hb, ln1, eps, qkv, b, d, 3 * d, partials, st))) return rc;
    if (kv_int8)
      qkv_epilogue_kernel<true><<<dim3(3 * heads, b), HD, 0, st>>>(
          partials, sp_qkv, qkv_s, p_pos, p_wpos, theta, heads, s_len, qbuf, kn, vn, ck, cv, ks,
          vs);
    else
      qkv_epilogue_kernel<false><<<dim3(3 * heads, b), HD, 0, st>>>(
          partials, sp_qkv, qkv_s, p_pos, p_wpos, theta, heads, s_len, qbuf, kn, vn, ck, cv,
          nullptr, nullptr);
    if ((rc = (int)cudaGetLastError())) return rc;
    if (kv_int8)
      attention_kernel<int8_t><<<dim3(heads, b), ATT_WARPS * 32, 0, st>>>(
          qbuf, kn, vn, reinterpret_cast<const int8_t*>(ck), reinterpret_cast<const int8_t*>(cv),
          ks, vs, p_len0, p_start2, p_end2, attn, s_len, heads);
    else
      attention_kernel<bf16><<<dim3(heads, b), ATT_WARPS * 32, 0, st>>>(
          qbuf, kn, vn, reinterpret_cast<const bf16*>(ck), reinterpret_cast<const bf16*>(cv),
          nullptr, nullptr, p_len0, p_start2, p_end2, attn, s_len, heads);
    if ((rc = (int)cudaGetLastError())) return rc;
    if ((rc = gemv(attn, nullptr, eps, wo, b, d, d, partials, st))) return rc;
    residual_epilogue_kernel<<<epi_d, EPI_THREADS, 0, st>>>(partials, sp_o, d, wo_s, hb);
    if ((rc = (int)cudaGetLastError())) return rc;
    if ((rc = gemv(hb, ln2, eps, gu, b, d, 2 * f, partials, st))) return rc;
    gateup_epilogue_kernel<<<epi_f, EPI_THREADS, 0, st>>>(partials, sp_gu, f, gu_s, xm);
    if ((rc = (int)cudaGetLastError())) return rc;
    if ((rc = gemv(xm, nullptr, eps, down, b, f, d, partials, st))) return rc;
    residual_epilogue_kernel<<<epi_d, EPI_THREADS, 0, st>>>(partials, sp_down, d, down_s, hb);
    if ((rc = (int)cudaGetLastError())) return rc;
  }
  return 0;
}
