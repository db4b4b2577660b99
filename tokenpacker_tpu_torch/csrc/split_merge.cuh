// Building blocks shared by the split decode kernels: K3
// (decode_attention.cu), K5 (paged_attention.cu), K6 (q4_matmul.cu), K7
// (s8_matmul.cu) and K4 (fused_decode.cu).
//
//   - the cp.async ring's copies (16 bytes, or 4 for K5's int8 scales),
//     zero-filled where the source is not valid: nothing is read there,
//     so a row past a length may hold anything, NaN included;
//   - warp reductions;
//   - the attention kernels' block partial (m, l, acc[G][D]) and its merge
//     across the blocks of one thread-block cluster: after a cluster
//     barrier the split-0 block copies the others' partials into its own
//     shared memory through distributed shared memory (4 float2 loads in
//     flight a thread) and merges them in split order, so two calls give
//     the same bits, in the same launch, with no workspace in device
//     memory and no counter to reset.
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <cmath>

namespace split_merge {

namespace cg = cooperative_groups;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from src, or 16 zero bytes (nothing read) where !valid
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

// 4 bytes from src, or 4 zero bytes where !valid
__device__ __forceinline__ void cp_async_4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// A block's attention partial: fp32 [G][D] acc, [G] running max, [G] row
// sum, PART floats.
template <int G, int D>
__host__ __device__ constexpr int part_floats() {
  return G * D + 2 * G;
}

// The block's partial from its threads' sums. Thread t holds features 2
// (t % (D / 2)), + 1 of every head over key group t / (D / 2) (acc[g][0..1]);
// warp g < G holds head g's running max and row sum. `red` is free
// shared memory for [KEY_GROUPS][G][D] floats. Every cp.async must have
// landed and every thread be done with the ring before the call.
template <int G, int D, int THREADS>
__device__ __forceinline__ void block_partial(float* red, float* part, const float (&acc)[G][2],
                                              float m_run, float l_run) {
  constexpr int KEY_GROUPS = THREADS / (D / 2);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int fp = tid % (D / 2), kq = tid / (D / 2);
#pragma unroll
  for (int g = 0; g < G; ++g)
    *reinterpret_cast<float2*>(red + (kq * G + g) * D + 2 * fp) = make_float2(acc[g][0], acc[g][1]);
  if (warp < G && lane == 0) {
    part[G * D + warp] = m_run;
    part[G * D + G + warp] = l_run;
  }
  __syncthreads();
  for (int i = tid; i < G * D; i += THREADS) {
    float sum = 0.f;
#pragma unroll
    for (int gr = 0; gr < KEY_GROUPS; ++gr) sum += red[gr * G * D + i];
    part[i] = sum;
  }
}

// The cluster's merge: every block's partial sits at `part` in its own
// shared memory; the split-0 block gathers them into `gather` (free shared
// memory for splits x PART floats, not overlapping `part`) and writes the
// G x D output rows at `out` (head g's row at out + g * D): the splits'
// sums rescaled to the largest max, in split order, over their row sums;
// 0 where no split saw a key. Every block of the cluster must call it.
template <int G, int D, int THREADS>
__device__ __forceinline__ void merge_cluster(const float* part, float2* gather, int split,
                                              int splits, __nv_bfloat16* out) {
  constexpr int PART = part_floats<G, D>();
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x;
  cluster.sync();
  if (split == 0) {
    const int total = splits * (PART / 2);
    for (int base = tid; base < total; base += 4 * THREADS) {
      float2 got[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = base + u * THREADS;
        if (i < total) {
          const int r = i / (PART / 2);
          const float2* remote = reinterpret_cast<const float2*>(
              cluster.map_shared_rank(const_cast<float*>(part), r));
          got[u] = remote[i - r * (PART / 2)];
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (base + u * THREADS < total) gather[base + u * THREADS] = got[u];
    }
  }
  cluster.sync();  // the others' partials are read: they may exit
  if (split != 0) return;
  const float* parts = reinterpret_cast<const float*>(gather);
  for (int i = tid; i < G * D; i += THREADS) {
    const int g = i / D;
    float mx = -INFINITY;
    for (int r = 0; r < splits; ++r) mx = fmaxf(mx, parts[r * PART + G * D + g]);
    float l = 0.f, o = 0.f;
    for (int r = 0; r < splits; ++r) {
      const float* pr = parts + r * PART;
      if (pr[G * D + g] == -INFINITY) continue;  // a split that saw no key
      const float f = expf(pr[G * D + g] - mx);
      l += pr[G * D + G + g] * f;
      o += pr[i] * f;
    }
    out[i] = __float2bfloat16(l > 0.f ? o / l : 0.f);
  }
}

}  // namespace split_merge
