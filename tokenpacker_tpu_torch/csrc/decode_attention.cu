// K3: single-query decode attention over the dense bf16 KV cache, with the
// keys split across the blocks of a thread-block cluster (flash-decoding).
//
// Replaces tokenpacker_tpu/ops/decode_attention.py:decode_attention
// (_kernel with its PrefetchScalarGridSpec length prefetch).
//
// What bounds it on the H100: one decode step reads every needed K/V row
// once (2 * keys * Hkv * d * 2 bytes per sample) for 4 FLOP per byte, far
// below the ~295 FLOP/byte where the tensor cores would be the limit, so
// the only levers are to read fewer bytes and to keep enough of them in
// flight to cover the memory latency. At B = 4 one block per (kv head,
// sample) is 128 blocks on 132 SMs, each walking up to 2,080 keys alone;
// so the grid is (split, kv head, sample) and the splits of one (kv head,
// sample) form one cluster:
//   - each block reads lengths[n] and needed[n] itself and visits only the
//     two valid ranges, [0, min(len, needed)) and [max(span_start, len),
//     needed) (just [0, needed) when span_start is 0), numbered as one run
//     of valid keys that the splits share in whole tiles of 32 keys: no key
//     past `needed` or in the gap is read, and a split past the run's end
//     (it holds no key) writes an empty partial;
//   - it streams its K and V rows through a 3-stage cp.async ring, 16-byte
//     copies (a row beyond the split's end is zero-filled, not read), the
//     next two tiles in flight under this one's arithmetic;
//   - tile by tile, not key by key: each half-warp takes one key, 16 lanes
//     x 8 features, and reduces its G dot products in 4 shuffles each (16
//     keys per pass of the 8 warps); then warp g takes head g's 32 logits,
//     one max, one rescale and the tile's row sum; then the P V pass over
//     the same shared tile, each thread 2 features of every head over a
//     quarter of the tile's keys;
//   - the partial (m, l, acc[d]) of each head stays in the block's shared
//     memory and the split-0 block merges the cluster's partials in split
//     order through distributed shared memory (csrc/split_merge.cuh,
//     which K5 shares: one remote load after another, each waited for,
//     cost more than the whole key loop at 8 kv heads, so several are in
//     flight a thread). The splits (a power of two up to the portable
//     cluster size of 8) are chosen on the host from S and the grid
//     (ops/decode_attention.py:decode_splits).
// The value product uses the probabilities rounded to bf16 while the row
// sum adds them in fp32, as the TPU kernel does. A row with no valid key
// gives 0. S need not be a multiple of anything.
//
// The ALiBi form (decode_attention with `slopes`, decode_attention.py:84-85
// and :142-146; MPT) adds slope[head] * tok_pos to each fp32 logit, where
// tok_pos is the key's true token position: the slot index, and kpos -
// span_start + len in the decoded span (the bucket's gap compacted away).
// The logits reach ~1.7e3 at 2k positions; they stay in fp32 and the
// running max keeps exp in range. MPT is MHA, so only G = 1 takes slopes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

#include "split_merge.cuh"

namespace {

using namespace split_merge;

using bf16 = __nv_bfloat16;

constexpr int D = 128;          // head dim (Vicuna-7B, MPT-7B)
constexpr int ROW = D * 2;      // bytes of one K or V row
constexpr int TILE = 32;        // keys a tile
constexpr int STAGES = 3;       // tiles in the cp.async ring
constexpr int THREADS = 256;    // 8 warps: one per head in the softmax pass (G <= 8)
constexpr int KEY_GROUPS = 4;   // P V pass: thread t takes keys t / 64 + 4 i of a tile
constexpr int MAX_SPLITS = 8;   // the portable cluster size
constexpr int RING = STAGES * TILE * ROW;

// Dynamic shared memory: K's ring, V's ring (after the key loop: the key
// groups' sums, then the cluster's partials gathered by the split-0
// block), then the block's partial (fp32 [G][D] acc, [G] max, [G] row
// sum: PART floats), [G][TILE] logits (probabilities after the softmax
// pass) and [G] rescales.
template <int G>
constexpr size_t smem_bytes() {
  return 2 * RING + sizeof(float) * (part_floats<G, D>() + G * TILE + G);
}

// The valid keys of one sample as one run: run index v < a_end is key v,
// the rest key v - a_end + b_start.
struct Ranges {
  int a_end, b_start, total, len, span_start;

  __device__ int key(int v) const { return v < a_end ? v : v - a_end + b_start; }
  // the key's true token position (ALiBi)
  __device__ int pos(int kp) const {
    return span_start > 0 && kp >= span_start ? kp - span_start + len : kp;
  }
};

// Rows [v0, v0 + TILE) of the run into the ring's tile (zeros past v1):
// thread t copies 16-byte chunks t % 8 and t % 8 + 8 of row t / 8, of K
// and of V.
__device__ __forceinline__ void load_tile(unsigned char* kdst, unsigned char* vdst,
                                          const bf16* kb, const bf16* vb, long stride,
                                          const Ranges& rg, int v0, int v1) {
  const int r = threadIdx.x / 8, c = threadIdx.x % 8;
  const bool ok = v0 + r < v1;
  const long off = ok ? (long)rg.key(v0 + r) * stride : 0;
  const unsigned char* ks = reinterpret_cast<const unsigned char*>(kb + off);
  const unsigned char* vs = reinterpret_cast<const unsigned char*>(vb + off);
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int ch = 16 * (c + 8 * j);
    cp_async_16(kdst + r * ROW + ch, ks + ch, ok);
    cp_async_16(vdst + r * ROW + ch, vs + ch, ok);
  }
}

template <int G, bool ALIBI>
__global__ void __launch_bounds__(THREADS, 2)
    decode_attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                            const bf16* __restrict__ v, const int* __restrict__ lengths,
                            const int* __restrict__ needed, const float* __restrict__ slopes,
                            bf16* __restrict__ o, int s, int h, int hkv, int span_start,
                            float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* k_ring = smem;
  unsigned char* v_ring = smem + RING;
  constexpr int PART = part_floats<G, D>();
  static_assert(MAX_SPLITS * PART * sizeof(float) <= 2 * RING, "the gather fits the rings");
  float* part_acc = reinterpret_cast<float*>(smem + 2 * RING);  // [G][D]
  float* p_s = part_acc + PART;                                 // [G][TILE]
  float* alpha_s = p_s + G * TILE;                              // [G]

  const int split = blockIdx.x, splits = gridDim.x, kvh = blockIdx.y, n = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  Ranges rg;
  rg.len = lengths[n];
  rg.span_start = span_start;
  const int need = max(0, min(needed[n], s));
  rg.a_end = span_start > 0 ? max(0, min(rg.len, need)) : need;
  rg.b_start = span_start > 0 ? max(span_start, rg.a_end) : need;
  rg.total = rg.a_end + max(0, need - rg.b_start);
  // this split's share of the run, in whole tiles
  const int per = ((rg.total + splits - 1) / splits + TILE - 1) / TILE * TILE;
  const int v0 = min(rg.total, split * per), v1 = min(rg.total, v0 + per);
  const int tiles = (v1 - v0 + TILE - 1) / TILE;

  const long stride = (long)hkv * D;
  const bf16* kb = k + ((long)n * s * hkv + kvh) * D;
  const bf16* vb = v + ((long)n * s * hkv + kvh) * D;

  // logits pass: lane l16 of each half-warp holds features 8 l16 .. 8 l16 + 7
  const int l16 = lane % 16, half = lane / 16;
  float qf[G][8], slope[G];
  const bf16* qb = q + ((long)n * h + (long)kvh * G) * D;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const uint4 raw = *reinterpret_cast<const uint4*>(qb + g * D + 8 * l16);
    const __nv_bfloat162* e = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(e[i]);
      qf[g][2 * i] = f.x * scale;
      qf[g][2 * i + 1] = f.y * scale;
    }
    slope[g] = ALIBI ? slopes[kvh * G + g] : 0.f;
  }
  // softmax pass: warp g < G keeps head g's running max and row sum
  float m_run = -INFINITY, l_run = 0.f;
  // P V pass: features 2 fp, 2 fp + 1 of every head over keys kq + 4 i
  const int fp = tid % 64, kq = tid / 64;
  float acc[G][2];
#pragma unroll
  for (int g = 0; g < G; ++g) acc[g][0] = acc[g][1] = 0.f;

#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < tiles)
      load_tile(k_ring + t * TILE * ROW, v_ring + t * TILE * ROW, kb, vb, stride, rg,
                v0 + t * TILE, v1);
    cp_async_commit();
  }
  for (int t = 0; t < tiles; ++t) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // tile t landed; every thread is done with tile t - 1
    const int tn = t + STAGES - 1;
    if (tn < tiles)
      load_tile(k_ring + (tn % STAGES) * TILE * ROW, v_ring + (tn % STAGES) * TILE * ROW, kb, vb,
                stride, rg, v0 + tn * TILE, v1);
    cp_async_commit();
    const unsigned char* kt = k_ring + (t % STAGES) * TILE * ROW;
    const unsigned char* vt = v_ring + (t % STAGES) * TILE * ROW;
    const int base = v0 + t * TILE;

#pragma unroll
    for (int pass = 0; pass < TILE / 16; ++pass) {
      const int r = pass * 16 + warp * 2 + half;
      const uint4 raw = *reinterpret_cast<const uint4*>(kt + r * ROW + l16 * 16);
      const __nv_bfloat162* e = reinterpret_cast<const __nv_bfloat162*>(&raw);
      float kf[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(e[i]);
        kf[2 * i] = f.x;
        kf[2 * i + 1] = f.y;
      }
      float dot[G];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        dot[g] = 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i) dot[g] += qf[g][i] * kf[i];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
#pragma unroll
        for (int g = 0; g < G; ++g) dot[g] += __shfl_xor_sync(0xffffffffu, dot[g], off);
      if (l16 == 0) {
        const int vi = base + r;
#pragma unroll
        for (int g = 0; g < G; ++g) {
          float x = -INFINITY;
          if (vi < v1) {
            x = dot[g];
            if constexpr (ALIBI) x += slope[g] * (float)rg.pos(rg.key(vi));
          }
          p_s[g * TILE + r] = x;
        }
      }
    }
    __syncthreads();
    if (warp < G) {
      const float x = p_s[warp * TILE + lane];
      const float m_new = fmaxf(m_run, warp_max(x));
      const float alpha = m_new == -INFINITY ? 1.f : expf(m_run - m_new);
      const float p = x == -INFINITY ? 0.f : expf(x - m_new);
      l_run = l_run * alpha + warp_sum(p);
      m_run = m_new;
      p_s[warp * TILE + lane] = __bfloat162float(__float2bfloat16(p));
      if (lane == 0) alpha_s[warp] = alpha;
    }
    __syncthreads();
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float al = alpha_s[g];
      acc[g][0] *= al;
      acc[g][1] *= al;
    }
#pragma unroll
    for (int i = 0; i < TILE / KEY_GROUPS; ++i) {
      const int r = kq + KEY_GROUPS * i;
      const float2 vv =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(vt + r * ROW + fp * 4));
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float p = p_s[g * TILE + r];
        acc[g][0] += p * vv.x;
        acc[g][1] += p * vv.y;
      }
    }
  }

  // the block's partial (the key groups' sums through K's ring, free
  // now), then the cluster's merge, gathered into the split-0 block's rings
  cp_async_wait<0>();
  __syncthreads();
  block_partial<G, D, THREADS>(reinterpret_cast<float*>(k_ring), part_acc, acc, m_run, l_run);
  merge_cluster<G, D, THREADS>(part_acc, reinterpret_cast<float2*>(smem), split, splits,
                               o + ((long)n * h + (long)kvh * G) * D);
}

template <int G, bool ALIBI = false>
int launch(const void* q, const void* k, const void* v, const void* lengths, const void* needed,
           const void* slopes, void* o, int n, int s, int h, int hkv, int span_start,
           int splits, cudaStream_t stream) {
  auto* kernel = decode_attention_kernel<G, ALIBI>;
  constexpr size_t bytes = smem_bytes<G>();
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, hkv, n);
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
  e = cudaLaunchKernelEx(&cfg, kernel, static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                         static_cast<const bf16*>(v), static_cast<const int*>(lengths),
                         static_cast<const int*>(needed), static_cast<const float*>(slopes),
                         static_cast<bf16*>(o), s, h, hkv, span_start, 1.0f / sqrtf((float)D));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// q, o: [n, h, d] bf16; k, v: [n, s, hkv, d] bf16; lengths, needed: [n]
// int32 on the device; slopes: null, or [h] f32 ALiBi slopes (h == hkv
// only); all contiguous; d = 128 only (Vicuna-7B, MPT-7B); h / hkv in {1,
// 2, 4, 8}; splits in {1, 2, 4, 8} (blocks a (sample, kv head), one
// cluster). Returns 0, a cudaError_t code, or -1 for an unsupported head
// dim, group count or split count.
extern "C" int tp_decode_attention(const void* q, const void* k, const void* v,
                                   const void* lengths, const void* needed, const void* slopes,
                                   void* o, int n, int s, int h, int hkv, int d, int span_start,
                                   int splits, void* stream) {
  if (d != D || hkv <= 0 || h % hkv != 0 || n <= 0 || s <= 0) return -1;
  if (splits < 1 || splits > MAX_SPLITS || (splits & (splits - 1))) return -1;
  const auto st = static_cast<cudaStream_t>(stream);
  if (slopes != nullptr) {
    if (h != hkv) return -1;
    return launch<1, true>(q, k, v, lengths, needed, slopes, o, n, s, h, hkv, span_start, splits,
                           st);
  }
  const void* none = nullptr;
  switch (h / hkv) {
    case 1:
      return launch<1>(q, k, v, lengths, needed, none, o, n, s, h, hkv, span_start, splits, st);
    case 2:
      return launch<2>(q, k, v, lengths, needed, none, o, n, s, h, hkv, span_start, splits, st);
    case 4:
      return launch<4>(q, k, v, lengths, needed, none, o, n, s, h, hkv, span_start, splits, st);
    case 8:
      return launch<8>(q, k, v, lengths, needed, none, o, n, s, h, hkv, span_start, splits, st);
    default: return -1;
  }
}
