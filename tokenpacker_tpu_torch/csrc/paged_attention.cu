// K5: single-query decode attention through a page table (paged KV pool),
// with each sequence's pages split across the blocks of a thread-block
// cluster.
//
// Replaces tokenpacker_tpu/ops/paged_attention.py:paged_attention (_kernel,
// whose PrefetchScalarGridSpec carries the page table and the lengths).
//
// What bounds it on the H100: one decode step reads each valid K/V row of
// a sequence once (plus an f32 scale per row and kv head for an int8 pool)
// for about 4 FLOP per byte, far below the ~295 FLOP/byte where the tensor
// cores would be the limit. So the levers are to read no byte twice and
// nothing past a sequence's length, and to keep enough bytes in flight.
// One block per (kv head, sequence) is 64 blocks at 8 kv heads and 8
// sequences, one of them walking 2,080 keys alone; so the grid is (split,
// kv head, sequence) and the splits of one (kv head, sequence) form one
// cluster, as in K3 (decode_attention.cu):
//   - each block serves the G = H / Hkv query heads of its kv head, so
//     each K/V row is read once; it reads lengths[n] itself and takes its
//     share of the sequence's ceil(len / PS) valid pages, in whole pages,
//     balanced over the true length (not over the table's MP entries): no
//     table entry at or past that is read (they may be stale or 0), and a
//     split with no page writes an empty partial;
//   - it streams its pages' K and V rows through a 3-stage cp.async ring of
//     32-row tiles, 16-byte copies gathered through the page table (the
//     int8 pool's scales by 4-byte copies beside them); each thread reads
//     the table entries of its rows a tile before their copies, so no copy
//     waits on a dependent load. A row at or past the length is
//     zero-filled, never read, so 0 x NaN cannot reach the sums;
//   - tile by tile: each half-warp takes one key (16 lanes x 8 features)
//     and reduces its G dot products in 4 shuffles; warp g takes head g's
//     32 logits, one max, one rescale and the tile's row sum; then the P V
//     pass over the same shared tile, each thread 2 features of every
//     head over a quarter of the tile's keys;
//   - an int8 pool is never dequantized: the logits are multiplied by the
//     K scale of their (position, kv head) and the probabilities by the V
//     scale before the product with int8 V cast to float, as the TPU
//     kernel folds them. A bf16 pool rounds the probabilities to bf16
//     before the value product while the row sum adds them in fp32;
//   - the block's partial (m, l, acc[G][D]) is merged by the split-0 block
//     in split order through distributed shared memory, in the same launch
//     (csrc/split_merge.cuh, shared with K3): no workspace, no counter, two
//     calls give the same bits. The splits (a power of two up to 8) are
//     chosen on the host (ops/paged_attention.py:paged_splits).
// A row with no valid key (len 0) gives 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

#include "split_merge.cuh"

namespace {

using namespace split_merge;
using bf16 = __nv_bfloat16;

constexpr int D = 128;          // head_dim (Vicuna-7B)
constexpr int TILE = 32;        // keys a tile
constexpr int STAGES = 3;       // tiles in the cp.async ring
constexpr int THREADS = 256;    // 8 warps: one per head in the softmax pass (G <= 8)
constexpr int KEY_GROUPS = 4;   // P V pass: thread t takes keys t / 64 + 4 i of a tile
constexpr int MAX_SPLITS = 8;   // the portable cluster size

template <typename T>
__host__ __device__ constexpr int row_bytes() {
  return D * (int)sizeof(T);
}

template <typename T>
__host__ __device__ constexpr int ring_bytes() {
  return STAGES * TILE * row_bytes<T>();
}

// Dynamic shared memory: a region holding K's ring, V's ring and (int8
// pool) the K and V scales' rings; after the key loop the key groups'
// sums, then the cluster's partials gathered by the split-0 block; then
// the block's partial (PART floats), [G][TILE] logits (probabilities
// after the softmax pass) and [G] rescales.
template <int G, typename T>
__host__ __device__ constexpr int region_bytes() {
  constexpr int rings = 2 * ring_bytes<T>() + (sizeof(T) == 1 ? 2 * STAGES * TILE * 4 : 0);
  constexpr int gather = MAX_SPLITS * part_floats<G, D>() * 4;
  constexpr int red = KEY_GROUPS * G * D * 4;
  return rings > gather ? (rings > red ? rings : red) : (gather > red ? gather : red);
}

template <int G, typename T>
constexpr size_t smem_bytes() {
  return region_bytes<G, T>() + sizeof(float) * (part_floats<G, D>() + G * TILE + G);
}

// 8 consecutive features of a staged row -> float
__device__ __forceinline__ void load8(const bf16* p, float* out) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* e = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(e[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const int8_t* p, float* out) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const int8_t* e = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) out[i] = (float)e[i];
}

__device__ __forceinline__ float2 load2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ float2 load2(const int8_t* p) {
  const char2 c = *reinterpret_cast<const char2*>(p);
  return make_float2(c.x, c.y);
}

// The page of position v0 + r of the sequence (0 at or past v1: not read)
template <int PS>
__device__ __forceinline__ int page_of(const int* trow, int v0, int r, int v1) {
  return v0 + r < v1 ? __ldg(trow + (v0 + r) / PS) : 0;
}

// Positions [v0, v0 + TILE) of the sequence into the ring's tile (zeros at
// or past v1): thread t copies the 16-byte chunks t % 8 (+ 8) of row t / 8
// of K and of V from page `page` (the table's entry for its row); with an
// int8 pool threads 0-31 copy row t's K scale and threads 32-63 row t -
// 32's V scale from page `spage`.
template <int PS, typename T>
__device__ __forceinline__ void load_tile(unsigned char* kdst, unsigned char* vdst, float* ksd,
                                          float* vsd, const T* kp, const T* vp, const float* ks,
                                          const float* vs, int page, int spage, int hkv, int kvh,
                                          int v0, int v1) {
  constexpr int ROW = row_bytes<T>();
  const int tid = threadIdx.x;
  {
    const int r = tid / 8, c = tid % 8, pos = v0 + r;
    const bool ok = pos < v1;
    // element offset of (page, row, kv head) in [P, PS, Hkv, D]
    const long off = ok ? (((long)page * PS + pos % PS) * hkv + kvh) * D : 0;
    const unsigned char* ksrc = reinterpret_cast<const unsigned char*>(kp + off);
    const unsigned char* vsrc = reinterpret_cast<const unsigned char*>(vp + off);
#pragma unroll
    for (int j = 0; j < ROW / 128; ++j) {
      const int ch = 16 * (c + 8 * j);
      cp_async_16(kdst + r * ROW + ch, ksrc + ch, ok);
      cp_async_16(vdst + r * ROW + ch, vsrc + ch, ok);
    }
  }
  if constexpr (sizeof(T) == 1) {
    if (tid < 2 * TILE) {
      const int r = tid % TILE, pos = v0 + r;
      const bool ok = pos < v1;
      const long si = ok ? ((long)spage * PS + pos % PS) * hkv + kvh : 0;
      if (tid < TILE) cp_async_4(ksd + r, ks + si, ok);
      else cp_async_4(vsd + r, vs + si, ok);
    }
  }
}

template <int PS, int G, typename T>
__global__ void __launch_bounds__(THREADS, 2)
    paged_attention_kernel(const bf16* __restrict__ q, const T* __restrict__ kp,
                           const T* __restrict__ vp, const float* __restrict__ ks,
                           const float* __restrict__ vs, const int* __restrict__ table,
                           const int* __restrict__ lengths, bf16* __restrict__ o, int mp,
                           int h, int hkv, float scale) {
  constexpr bool INT8 = sizeof(T) == 1;
  constexpr int ROW = row_bytes<T>();
  constexpr int RING = ring_bytes<T>();
  constexpr int PART = part_floats<G, D>();
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* k_ring = smem;
  unsigned char* v_ring = smem + RING;
  float* ks_ring = reinterpret_cast<float*>(smem + 2 * RING);  // [STAGES][TILE] (int8)
  float* vs_ring = ks_ring + STAGES * TILE;
  float* part_acc = reinterpret_cast<float*>(smem + region_bytes<G, T>());  // PART floats
  float* p_s = part_acc + PART;                                            // [G][TILE]
  float* alpha_s = p_s + G * TILE;                                         // [G]

  const int split = blockIdx.x, splits = gridDim.x, kvh = blockIdx.y, n = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  // this split's whole pages of the sequence's valid ones, balanced
  const int len = min(lengths[n], mp * PS);  // keys past mp * PS are not attended
  const int pages = max(0, (len + PS - 1) / PS);
  const int p0 = split * pages / splits, p1 = (split + 1) * pages / splits;
  const int v0 = p0 * PS, v1 = min(len, p1 * PS);
  const int tiles = v1 > v0 ? (v1 - v0 + TILE - 1) / TILE : 0;
  const int* trow = table + (long)n * mp;

  // logits pass: lane l16 of each half-warp holds features 8 l16 .. 8 l16 + 7
  const int l16 = lane % 16, half = lane / 16;
  float qf[G][8];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    load8(q + ((long)n * h + (long)kvh * G + g) * D + 8 * l16, qf[g]);
#pragma unroll
    for (int i = 0; i < 8; ++i) qf[g][i] *= scale;
  }
  // softmax pass: warp g < G keeps head g's running max and row sum
  float m_run = -INFINITY, l_run = 0.f;
  // P V pass: features 2 fp, 2 fp + 1 of every head over keys kq + 4 i
  const int fp = tid % 64, kq = tid / 64;
  float acc[G][2];
#pragma unroll
  for (int g = 0; g < G; ++g) acc[g][0] = acc[g][1] = 0.f;

  // The table entries of this thread's rows are read a tile ahead of the
  // copies that use them, so no copy waits on a dependent load.
  const int row_kv = tid / 8, row_s = tid % TILE;
  auto pages_of = [&](int t, int& page, int& spage) {
    page = page_of<PS>(trow, v0 + t * TILE, row_kv, v1);
    spage = INT8 && tid < 2 * TILE ? page_of<PS>(trow, v0 + t * TILE, row_s, v1) : 0;
  };
  auto load = [&](int t, int page, int spage) {
    const int s = t % STAGES;
    load_tile<PS, T>(k_ring + s * TILE * ROW, v_ring + s * TILE * ROW, ks_ring + s * TILE,
                     vs_ring + s * TILE, kp, vp, ks, vs, page, spage, hkv, kvh, v0 + t * TILE,
                     v1);
  };
  int page, spage;
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < tiles) {
      pages_of(t, page, spage);
      load(t, page, spage);
    }
    cp_async_commit();
  }
  pages_of(STAGES - 1, page, spage);
  for (int t = 0; t < tiles; ++t) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // tile t landed; every thread is done with tile t - 1
    if (t + STAGES - 1 < tiles) load(t + STAGES - 1, page, spage);
    cp_async_commit();
    pages_of(t + STAGES, page, spage);  // used by the next tile's copies
    const int s = t % STAGES;
    const T* kt = reinterpret_cast<const T*>(k_ring + s * TILE * ROW);
    const T* vt = reinterpret_cast<const T*>(v_ring + s * TILE * ROW);
    const float* kst = ks_ring + s * TILE;
    const float* vst = vs_ring + s * TILE;
    const int base = v0 + t * TILE;

#pragma unroll
    for (int pass = 0; pass < TILE / 16; ++pass) {
      const int r = pass * 16 + warp * 2 + half;
      float kf[8];
      load8(kt + r * D + 8 * l16, kf);
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
        const bool ok = base + r < v1;
        const float kscale = INT8 ? kst[r] : 1.f;
#pragma unroll
        for (int g = 0; g < G; ++g) p_s[g * TILE + r] = ok ? dot[g] * kscale : -INFINITY;
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
      p_s[warp * TILE + lane] = INT8 ? p * vst[lane] : __bfloat162float(__float2bfloat16(p));
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
      const float2 vv = load2(vt + r * D + 2 * fp);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float p = p_s[g * TILE + r];
        acc[g][0] += p * vv.x;
        acc[g][1] += p * vv.y;
      }
    }
  }

  // the block's partial (the key groups' sums through the free region),
  // then the cluster's merge, gathered into the split-0 block's region
  cp_async_wait<0>();
  __syncthreads();
  block_partial<G, D, THREADS>(reinterpret_cast<float*>(smem), part_acc, acc, m_run, l_run);
  merge_cluster<G, D, THREADS>(part_acc, reinterpret_cast<float2*>(smem), split, splits,
                               o + ((long)n * h + (long)kvh * G) * D);
}

template <int PS, int G, typename T>
int launch(const void* q, const void* kp, const void* vp, const void* ks, const void* vs,
           const void* table, const void* lengths, void* o, int n, int h, int hkv, int mp,
           int splits, cudaStream_t stream) {
  auto* kernel = paged_attention_kernel<PS, G, T>;
  constexpr size_t bytes = smem_bytes<G, T>();
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
  e = cudaLaunchKernelEx(&cfg, kernel, static_cast<const bf16*>(q), static_cast<const T*>(kp),
                         static_cast<const T*>(vp), static_cast<const float*>(ks),
                         static_cast<const float*>(vs), static_cast<const int*>(table),
                         static_cast<const int*>(lengths), static_cast<bf16*>(o), mp, h, hkv,
                         1.0f / sqrtf((float)D));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <int PS, typename T>
int launch_groups(int groups, const void* q, const void* kp, const void* vp, const void* ks,
                  const void* vs, const void* table, const void* lengths, void* o, int n, int h,
                  int hkv, int mp, int splits, cudaStream_t st) {
  switch (groups) {
    case 1: return launch<PS, 1, T>(q, kp, vp, ks, vs, table, lengths, o, n, h, hkv, mp, splits, st);
    case 2: return launch<PS, 2, T>(q, kp, vp, ks, vs, table, lengths, o, n, h, hkv, mp, splits, st);
    case 4: return launch<PS, 4, T>(q, kp, vp, ks, vs, table, lengths, o, n, h, hkv, mp, splits, st);
    case 8: return launch<PS, 8, T>(q, kp, vp, ks, vs, table, lengths, o, n, h, hkv, mp, splits, st);
    default: return -1;
  }
}

template <typename T>
int launch_pages(int ps, int groups, const void* q, const void* kp, const void* vp,
                 const void* ks, const void* vs, const void* table, const void* lengths, void* o,
                 int n, int h, int hkv, int mp, int splits, cudaStream_t st) {
  switch (ps) {
    case 16:
      return launch_groups<16, T>(groups, q, kp, vp, ks, vs, table, lengths, o, n, h, hkv, mp,
                                  splits, st);
    case 32:
      return launch_groups<32, T>(groups, q, kp, vp, ks, vs, table, lengths, o, n, h, hkv, mp,
                                  splits, st);
    case 64:
      return launch_groups<64, T>(groups, q, kp, vp, ks, vs, table, lengths, o, n, h, hkv, mp,
                                  splits, st);
    default: return -1;
  }
}

}  // namespace

// q, o: [n, h, d] bf16; k_pages, v_pages: [P, ps, hkv, d] bf16, or int8 with
// k_scales, v_scales [P, ps, hkv] f32 (kv_int8 = 1; null pointers
// otherwise); page_table: [n, mp] int32; lengths: [n] int32; all on the
// device and contiguous. d = 128, ps in {16, 32, 64}, h / hkv in {1, 2, 4,
// 8}; splits in {1, 2, 4, 8} (blocks a (sequence, kv head), one cluster).
// Returns 0, a cudaError_t code, or -1 for a shape it does not take.
extern "C" int tp_paged_attention(const void* q, const void* k_pages, const void* v_pages,
                                  const void* k_scales, const void* v_scales,
                                  const void* page_table, const void* lengths, void* o, int n,
                                  int h, int hkv, int d, int ps, int mp, int kv_int8, int splits,
                                  void* stream) {
  if (d != D || hkv <= 0 || h % hkv != 0 || mp <= 0) return -1;
  if (splits < 1 || splits > MAX_SPLITS || (splits & (splits - 1))) return -1;
  if (n == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kv_int8)
    return launch_pages<int8_t>(ps, h / hkv, q, k_pages, v_pages, k_scales, v_scales, page_table,
                                lengths, o, n, h, hkv, mp, splits, st);
  return launch_pages<bf16>(ps, h / hkv, q, k_pages, v_pages, nullptr, nullptr, page_table,
                            lengths, o, n, h, hkv, mp, splits, st);
}
