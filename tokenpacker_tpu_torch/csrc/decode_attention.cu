// K3: single-query decode attention over the dense bf16 KV cache.
//
// Replaces tokenpacker_tpu/ops/decode_attention.py:decode_attention
// (_kernel with its PrefetchScalarGridSpec length prefetch).
//
// What bounds it on the H100: one decode step reads every needed K/V row
// once (2 * keys * Hkv * d * 2 bytes per sample) for 4 FLOP per byte, far
// below the ~295 FLOP/byte where the tensor cores would be the limit, so
// the only lever is to read fewer bytes, and to keep enough of them in
// flight to cover the memory latency. The plain path reads and upcasts
// the whole [N, S, Hkv, d] cache and builds an [N, H, S] mask. The kernel:
//   - runs one block per (kv head, sample) for the G query heads that
//     share the kv head, so each K/V row is read once;
//   - reads lengths[n] and needed[n] from device memory itself and visits
//     only the two valid ranges, [0, min(len, needed)) and
//     [max(span_start, len), needed) (just [0, needed) when span_start is
//     0): keys past `needed` and keys in the gap are never read, and no
//     mask is built;
//   - gives each of NW warps a strided share of those keys and its own
//     fp32 online softmax; a lane holds d/32 features of every head and
//     keeps U keys' 8-byte K and V loads in flight, and the warps' partial
//     results are merged through shared memory at the end.
// The value product uses the probabilities rounded to bf16 while the row
// sum adds them in fp32, as the TPU kernel does. S need not be a multiple
// of anything. Split-K across blocks (flash-decoding), for batches too
// small to fill 132 SMs, is later work.
//
// The ALiBi form (decode_attention with `slopes`, decode_attention.py:84-85
// and :142-146; MPT) adds slope[head] * tok_pos to each fp32 logit, where
// tok_pos is the key's true token position: the slot index in the prompt
// range, kpos - span_start + len in the decoded span (the gap between them
// compacted away). fold_range takes each range's position offset. The
// logits reach ~1.7e3 at 2k positions; they stay in fp32 and the online
// max keeps exp in range. MPT is MHA, so only G = 1 takes slopes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

namespace {

using bf16 = __nv_bfloat16;

constexpr int NW = 16;  // warps per block
constexpr int U = 4;    // keys in flight per warp

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// EPL consecutive bf16 -> float, one 8-byte vector load
template <int EPL>
__device__ __forceinline__ void load_vec(const bf16* p, float* out) {
  static_assert(EPL == 4, "head_dim 128");
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(&raw);
  const float2 lo = __bfloat1622float2(b[0]), hi = __bfloat1622float2(b[1]);
  out[0] = lo.x; out[1] = lo.y; out[2] = hi.x; out[3] = hi.y;
}

template <int D, int G>
struct WarpState {
  static constexpr int EPL = D / 32;
  float q[G][EPL], acc[G][EPL], m[G], l[G], slope[G];
};

// Folds keys [k0, k1) owned by this warp (k0 + warp + NW*i) into st; with
// ALIBI key kj sits at token position kj + pos_off.
template <int D, int G, bool ALIBI>
__device__ __forceinline__ void fold_range(WarpState<D, G>& st, const bf16* kb,
                                           const bf16* vb, long row, int k0, int k1,
                                           int pos_off, int warp, int lane) {
  constexpr int EPL = D / 32;
  for (int base = k0 + warp; base < k1; base += NW * U) {
    float kf[U][EPL], vf[U][EPL];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int kj = base + u * NW;
      if (kj < k1) {
        load_vec<EPL>(kb + (long)kj * row + lane * EPL, kf[u]);
        load_vec<EPL>(vb + (long)kj * row + lane * EPL, vf[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (base + u * NW >= k1) break;  // uniform across the warp
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) dot += st.q[g][e] * kf[u][e];
        dot = warp_sum(dot);
        if constexpr (ALIBI) dot += st.slope[g] * (float)(base + u * NW + pos_off);
        const float m_new = fmaxf(st.m[g], dot);
        const float alpha = expf(st.m[g] - m_new);  // 0 for the first key
        const float p = expf(dot - m_new);
        const float pb = __bfloat162float(__float2bfloat16(p));
        st.l[g] = st.l[g] * alpha + p;
#pragma unroll
        for (int e = 0; e < EPL; ++e) st.acc[g][e] = st.acc[g][e] * alpha + pb * vf[u][e];
        st.m[g] = m_new;
      }
    }
  }
}

template <int D, int G, bool ALIBI>
__global__ void __launch_bounds__(NW * 32)
    decode_attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                            const bf16* __restrict__ v, const int* __restrict__ lengths,
                            const int* __restrict__ needed, const float* __restrict__ slopes,
                            bf16* __restrict__ o, int s, int h, int hkv, int span_start,
                            float scale) {
  constexpr int EPL = D / 32;
  __shared__ float red_m[NW], red_l[NW];
  __shared__ float red_acc[NW][D];

  const int kvh = blockIdx.x, n = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int len = lengths[n];
  const int need = min(needed[n], s);
  const long row = (long)hkv * D;
  const bf16* kb = k + ((long)n * s * hkv + kvh) * D;
  const bf16* vb = v + ((long)n * s * hkv + kvh) * D;
  const bf16* qb = q + ((long)n * h + (long)kvh * G) * D;

  WarpState<D, G> st;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    load_vec<EPL>(qb + g * D + lane * EPL, st.q[g]);
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      st.q[g][e] *= scale;
      st.acc[g][e] = 0.f;
    }
    st.m[g] = -INFINITY;
    st.l[g] = 0.f;
    st.slope[g] = ALIBI ? slopes[kvh * G + g] : 0.f;
  }

  if (span_start > 0) {
    const int a_end = min(len, need);
    fold_range<D, G, ALIBI>(st, kb, vb, row, 0, a_end, 0, warp, lane);
    fold_range<D, G, ALIBI>(st, kb, vb, row, max(span_start, a_end), need, len - span_start,
                            warp, lane);
  } else {
    fold_range<D, G, ALIBI>(st, kb, vb, row, 0, need, 0, warp, lane);
  }

  // merge the warps' partial softmax states, one head at a time
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (lane == 0) {
      red_m[warp] = st.m[g];
      red_l[warp] = st.l[g];
    }
#pragma unroll
    for (int e = 0; e < EPL; ++e) red_acc[warp][lane * EPL + e] = st.acc[g][e];
    __syncthreads();
    if (threadIdx.x < D) {
      float mx = -INFINITY;
      for (int w = 0; w < NW; ++w) mx = fmaxf(mx, red_m[w]);
      float l = 0.f, out = 0.f;
      for (int w = 0; w < NW; ++w) {
        if (red_m[w] == -INFINITY) continue;  // a warp that saw no key
        const float f = expf(red_m[w] - mx);
        l += red_l[w] * f;
        out += red_acc[w][threadIdx.x] * f;
      }
      o[((long)n * h + (long)kvh * G + g) * D + threadIdx.x] =
          __float2bfloat16(l > 0.f ? out / l : 0.f);
    }
    __syncthreads();
  }
}

template <int D, int G, bool ALIBI = false>
int launch(const void* q, const void* k, const void* v, const void* lengths,
           const void* needed, void* o, int n, int s, int h, int hkv, int span_start,
           cudaStream_t stream, const void* slopes = nullptr) {
  dim3 grid(hkv, n);
  decode_attention_kernel<D, G, ALIBI><<<grid, NW * 32, 0, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const int*>(lengths), static_cast<const int*>(needed),
      static_cast<const float*>(slopes), static_cast<bf16*>(o), s, h, hkv, span_start,
      1.0f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

template <int D>
int launch_groups(int groups, const void* q, const void* k, const void* v,
                  const void* lengths, const void* needed, void* o, int n, int s, int h,
                  int hkv, int span_start, cudaStream_t st) {
  switch (groups) {
    case 1: return launch<D, 1>(q, k, v, lengths, needed, o, n, s, h, hkv, span_start, st);
    case 2: return launch<D, 2>(q, k, v, lengths, needed, o, n, s, h, hkv, span_start, st);
    case 4: return launch<D, 4>(q, k, v, lengths, needed, o, n, s, h, hkv, span_start, st);
    case 8: return launch<D, 8>(q, k, v, lengths, needed, o, n, s, h, hkv, span_start, st);
    default: return -1;
  }
}

}  // namespace

// q, o: [n, h, d] bf16; k, v: [n, s, hkv, d] bf16; lengths, needed: [n]
// int32 on the device; slopes: null, or [h] f32 ALiBi slopes (h == hkv
// only); all contiguous; d = 128 only (Vicuna-7B, MPT-7B); h / hkv in {1,
// 2, 4, 8}. Returns 0, a cudaError_t code, or -1 for an unsupported
// head_dim or group count.
extern "C" int tp_decode_attention(const void* q, const void* k, const void* v,
                                   const void* lengths, const void* needed, const void* slopes,
                                   void* o, int n, int s, int h, int hkv, int d, int span_start,
                                   void* stream) {
  if (d != 128 || hkv <= 0 || h % hkv != 0) return -1;
  const auto st = static_cast<cudaStream_t>(stream);
  if (slopes != nullptr) {
    if (h != hkv) return -1;
    return launch<128, 1, true>(q, k, v, lengths, needed, o, n, s, h, hkv, span_start, st,
                                slopes);
  }
  return launch_groups<128>(h / hkv, q, k, v, lengths, needed, o, n, s, h, hkv, span_start, st);
}
