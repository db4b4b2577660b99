// K5: single-query decode attention through a page table (paged KV pool).
//
// Replaces tokenpacker_tpu/ops/paged_attention.py:paged_attention (_kernel,
// whose PrefetchScalarGridSpec carries the page table and the lengths).
//
// What bounds it on the H100: one decode step reads each valid K/V row of
// a sequence once (plus an f32 scale per row and kv head for an int8 pool)
// for about 4 FLOP per byte, far below the ~295 FLOP/byte where the tensor
// cores would be the limit. So the only lever is to read no byte twice and
// nothing past a sequence's length. The design:
//   - one block per (kv head, sequence) serves the G = H / Hkv query heads
//     of that kv head, so each K/V row is read once;
//   - the block reads lengths[n] and its row of the page table itself and
//     walks only the pages [0, ceil(len / PS)); within the last page only
//     the rows below len are read. Table entries past that may be stale
//     or 0 and are never read;
//   - each thread loads its share of the next page's K and V rows (16
//     bytes at a time, all issued together) into registers while the
//     block computes the current page, so memory latency is paid about
//     once a page and overlaps the compute; a page is then staged in
//     shared memory, warps form the G x PS logits (a lane holds 4
//     features, warp sums), warp g updates head g's fp32 online softmax,
//     and each thread accumulates two output columns of every head over
//     a quarter of the page's rows;
//   - an int8 pool is never dequantized: the logits are multiplied by the
//     K scale of their (position, kv head) and the probabilities by the V
//     scale before the product with int8 V cast to float, as the TPU
//     kernel folds them. A bf16 pool rounds the probabilities to bf16
//     before the value product while the row sum adds them in fp32.
// A row with no valid key (len 0) gives 0. Splitting long sequences across
// blocks (flash-decoding) and a TMA page pipeline are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

namespace {

using bf16 = __nv_bfloat16;

constexpr int D = 128;          // head_dim (Vicuna-7B)
constexpr int NW = 8;           // warps per block
constexpr int NT = NW * 32;     // threads per block
constexpr int PAIRS = D / 2;    // output column pairs
constexpr int RG = NT / PAIRS;  // row groups of the value product (4)

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// 4 consecutive elements of a staged row -> float
__device__ __forceinline__ void load4(const bf16* p, float* out) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(&raw);
  const float2 lo = __bfloat1622float2(b[0]), hi = __bfloat1622float2(b[1]);
  out[0] = lo.x; out[1] = lo.y; out[2] = hi.x; out[3] = hi.y;
}

__device__ __forceinline__ void load4(const int8_t* p, float* out) {
  const char4 c = *reinterpret_cast<const char4*>(p);
  out[0] = c.x; out[1] = c.y; out[2] = c.z; out[3] = c.w;
}

__device__ __forceinline__ float2 load2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ float2 load2(const int8_t* p) {
  const char2 c = *reinterpret_cast<const char2*>(p);
  return make_float2(c.x, c.y);
}

template <int PS, int G, typename T>
__global__ void __launch_bounds__(NT)
    paged_attention_kernel(const bf16* __restrict__ q, const T* __restrict__ kp,
                           const T* __restrict__ vp, const float* __restrict__ ks,
                           const float* __restrict__ vs, const int* __restrict__ table,
                           const int* __restrict__ lengths, bf16* __restrict__ o, int mp,
                           int h, int hkv, float scale) {
  constexpr bool INT8 = sizeof(T) == 1;
  constexpr int CPR = D * (int)sizeof(T) / 16;  // 16-byte chunks per row
  constexpr int TILE = PS * D;                  // elements of one staged page
  constexpr int KV_BYTES = 2 * TILE * (int)sizeof(T);
  constexpr int RED_BYTES = (RG - 1) * G * D * (int)sizeof(float);
  constexpr int SMEM = KV_BYTES > RED_BYTES ? KV_BYTES : RED_BYTES;
  constexpr int LOADS = (PS * CPR + NT - 1) / NT;  // 16-byte chunks a thread loads per tile
  __shared__ __align__(16) unsigned char smem[SMEM];
  __shared__ float s_p[G][PS];  // logits, then the probabilities of the product
  __shared__ float s_ks[PS], s_vs[PS];
  __shared__ float s_alpha[G], s_l[G];
  T* k_tile = reinterpret_cast<T*>(smem);
  T* v_tile = k_tile + TILE;

  const int kvh = blockIdx.x, n = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int len = lengths[n];
  const int pages = min((len + PS - 1) / PS, mp);  // keys past mp * PS are not attended
  const long row = (long)hkv * D;  // elements between positions of a page

  float qr[G][4];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    load4(q + ((long)n * h + (long)kvh * G + g) * D + lane * 4, qr[g]);
#pragma unroll
    for (int e = 0; e < 4; ++e) qr[g][e] *= scale;
  }
  // head `warp`'s softmax state (warps >= G hold none)
  float m_run = -INFINITY, l_run = 0.f;
  // this thread's output columns 2*cp, 2*cp+1 over row group rg
  const int cp = tid % PAIRS, rg = tid / PAIRS;
  float acc[G][2];
#pragma unroll
  for (int g = 0; g < G; ++g) acc[g][0] = acc[g][1] = 0.f;

  // page j's valid rows (and scales) of this kv head -> registers
  uint4 kr[LOADS], vr[LOADS];
  float ksr = 0.f, vsr = 0.f;
  auto fetch = [&](int j) {
    const int page = table[(long)n * mp + j];
    const int valid = min(PS, len - j * PS);
    const long base = (long)page * PS * row + (long)kvh * D;
#pragma unroll
    for (int i = 0; i < LOADS; ++i) {
      const int c = tid + i * NT;
      if (c < valid * CPR) {
        const long src = base + (c / CPR) * row;
        kr[i] = reinterpret_cast<const uint4*>(kp + src)[c % CPR];
        vr[i] = reinterpret_cast<const uint4*>(vp + src)[c % CPR];
      }
    }
    if (INT8 && tid < valid) {
      const long si = ((long)page * PS + tid) * hkv + kvh;
      ksr = ks[si];
      vsr = vs[si];
    }
  };
  if (pages > 0) fetch(0);

  for (int j = 0; j < pages; ++j) {
    const int valid = min(PS, len - j * PS);
    __syncthreads();  // the previous page's tiles are no longer read
#pragma unroll
    for (int i = 0; i < LOADS; ++i) {
      const int c = tid + i * NT;
      if (c < valid * CPR) {
        reinterpret_cast<uint4*>(k_tile + (c / CPR) * D)[c % CPR] = kr[i];
        reinterpret_cast<uint4*>(v_tile + (c / CPR) * D)[c % CPR] = vr[i];
      }
    }
    if (INT8 && tid < valid) {
      s_ks[tid] = ksr;
      s_vs[tid] = vsr;
    }
    __syncthreads();
    if (j + 1 < pages) fetch(j + 1);  // in flight while this page is computed

    // logits: warp w takes rows w, w + NW, ...
    for (int r = warp; r < valid; r += NW) {
      float kf[4];
      load4(k_tile + r * D + lane * 4, kf);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < 4; ++e) dot += qr[g][e] * kf[e];
        dot = warp_sum(dot);
        if (lane == 0) s_p[g][r] = INT8 ? dot * s_ks[r] : dot;
      }
    }
    __syncthreads();

    // online softmax: warp g owns head g
    if (warp < G) {
      float s[PS / 32 > 0 ? PS / 32 : 1];
      float mx = -INFINITY;
#pragma unroll
      for (int i = 0; i * 32 < PS; ++i) {
        const int r = lane + i * 32;
        s[i] = (r < PS && r < valid) ? s_p[warp][r] : -INFINITY;
        mx = fmaxf(mx, s[i]);
      }
      mx = warp_max(mx);
      const float m_new = fmaxf(m_run, mx);
      const float alpha = expf(m_run - m_new);  // 0 for the first page
      float psum = 0.f;
#pragma unroll
      for (int i = 0; i * 32 < PS; ++i) {
        const int r = lane + i * 32;
        if (r < PS && r < valid) {
          const float p = expf(s[i] - m_new);
          psum += p;
          s_p[warp][r] = INT8 ? p * s_vs[r] : __bfloat162float(__float2bfloat16(p));
        }
      }
      l_run = l_run * alpha + warp_sum(psum);
      m_run = m_new;
      if (lane == 0) s_alpha[warp] = alpha;
    }
    __syncthreads();

    // value product over this thread's rows rg, rg + RG, ...
#pragma unroll
    for (int g = 0; g < G; ++g) {
      acc[g][0] *= s_alpha[g];
      acc[g][1] *= s_alpha[g];
    }
    for (int r = rg; r < valid; r += RG) {
      const float2 v = load2(v_tile + r * D + 2 * cp);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float p = s_p[g][r];
        acc[g][0] += p * v.x;
        acc[g][1] += p * v.y;
      }
    }
  }

  // merge the row groups (the staged tiles are free now) and normalise
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);  // [RG - 1][G][D]
  if (rg > 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      red[((rg - 1) * G + g) * D + 2 * cp] = acc[g][0];
      red[((rg - 1) * G + g) * D + 2 * cp + 1] = acc[g][1];
    }
  }
  if (warp < G && lane == 0) s_l[warp] = l_run;
  __syncthreads();
  if (rg == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float a0 = acc[g][0], a1 = acc[g][1];
      for (int i = 0; i < RG - 1; ++i) {
        a0 += red[(i * G + g) * D + 2 * cp];
        a1 += red[(i * G + g) * D + 2 * cp + 1];
      }
      const float l = s_l[g];
      const float inv = l > 0.f ? 1.f / l : 0.f;
      __nv_bfloat162 out;
      out.x = __float2bfloat16(a0 * inv);
      out.y = __float2bfloat16(a1 * inv);
      *reinterpret_cast<__nv_bfloat162*>(o + ((long)n * h + (long)kvh * G + g) * D + 2 * cp) = out;
    }
  }
}

template <int PS, int G, typename T>
int launch(const void* q, const void* kp, const void* vp, const void* ks, const void* vs,
           const void* table, const void* lengths, void* o, int n, int h, int hkv, int mp,
           cudaStream_t stream) {
  dim3 grid(hkv, n);
  paged_attention_kernel<PS, G, T><<<grid, NT, 0, stream>>>(
      static_cast<const bf16*>(q), static_cast<const T*>(kp), static_cast<const T*>(vp),
      static_cast<const float*>(ks), static_cast<const float*>(vs),
      static_cast<const int*>(table), static_cast<const int*>(lengths), static_cast<bf16*>(o),
      mp, h, hkv, 1.0f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

template <int PS, typename T>
int launch_groups(int groups, const void* q, const void* kp, const void* vp, const void* ks,
                  const void* vs, const void* table, const void* lengths, void* o, int n, int h,
                  int hkv, int mp, cudaStream_t st) {
  switch (groups) {
    case 1: return launch<PS, 1, T>(q, kp, vp, ks, vs, table, lengths, o, n, h, hkv, mp, st);
    case 2: return launch<PS, 2, T>(q, kp, vp, ks, vs, table, lengths, o, n, h, hkv, mp, st);
    case 4: return launch<PS, 4, T>(q, kp, vp, ks, vs, table, lengths, o, n, h, hkv, mp, st);
    case 8: return launch<PS, 8, T>(q, kp, vp, ks, vs, table, lengths, o, n, h, hkv, mp, st);
    default: return -1;
  }
}

template <typename T>
int launch_pages(int ps, int groups, const void* q, const void* kp, const void* vp,
                 const void* ks, const void* vs, const void* table, const void* lengths, void* o,
                 int n, int h, int hkv, int mp, cudaStream_t st) {
  switch (ps) {
    case 16: return launch_groups<16, T>(groups, q, kp, vp, ks, vs, table, lengths, o, n, h, hkv, mp, st);
    case 32: return launch_groups<32, T>(groups, q, kp, vp, ks, vs, table, lengths, o, n, h, hkv, mp, st);
    case 64: return launch_groups<64, T>(groups, q, kp, vp, ks, vs, table, lengths, o, n, h, hkv, mp, st);
    default: return -1;
  }
}

}  // namespace

// q, o: [n, h, d] bf16; k_pages, v_pages: [P, ps, hkv, d] bf16, or int8 with
// k_scales, v_scales [P, ps, hkv] f32 (kv_int8 = 1; null pointers
// otherwise); page_table: [n, mp] int32; lengths: [n] int32; all on the
// device and contiguous. d = 128, ps in {16, 32, 64}, h / hkv in {1, 2, 4,
// 8}. Returns 0, a cudaError_t code, or -1 for a shape it does not take.
extern "C" int tp_paged_attention(const void* q, const void* k_pages, const void* v_pages,
                                  const void* k_scales, const void* v_scales,
                                  const void* page_table, const void* lengths, void* o, int n,
                                  int h, int hkv, int d, int ps, int mp, int kv_int8,
                                  void* stream) {
  if (d != D || hkv <= 0 || h % hkv != 0 || mp <= 0) return -1;
  if (n == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kv_int8)
    return launch_pages<int8_t>(ps, h / hkv, q, k_pages, v_pages, k_scales, v_scales, page_table,
                                lengths, o, n, h, hkv, mp, st);
  return launch_pages<bf16>(ps, h / hkv, q, k_pages, v_pages, nullptr, nullptr, page_table,
                            lengths, o, n, h, hkv, mp, st);
}
