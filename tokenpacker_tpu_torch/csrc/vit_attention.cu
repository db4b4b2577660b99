// K1: non-causal multi-head attention for the CLIP tower, on Hopper's
// tensor-core path (wgmma) with TMA tile loads.
//
// Replaces tokenpacker_tpu/ops/vit_attention.py:vit_attention (_kernel),
// which held one image's whole attention in TPU VMEM. K9 (vit_block.cu)
// runs its attention through this kernel too.
//
// What bounds it on the H100: at ViT-L/14-336 (T = 577, 16 heads of d = 64)
// the two products are 4*T^2*d FLOP a head (10.9 GFLOP at [8, 577, 1024],
// ~11 us at 989 TFLOP/s) against 8*T*64 bytes of q/k/v/o a head (0.011
// ms at 3.35 TB/s): the tensor cores bound it, and at d = 64 the softmax
// costs as much again: one ex2 per logit (42.6 M at 8 views) at 16 a clock
// per SM is ~11 us as well. So the design keeps every logit on chip, in
// registers (flash_sm90.cuh has the building blocks):
//  - A block owns 128 query rows of one (image, head); 288 threads: two
//    consumer warpgroups of 64 rows each and one producer warp. The grid
//    is (5 query tiles, 16 heads, N) at T = 577: 640 blocks at 8 views.
//  - The producer's lane 0 loads Q once and K and V in tiles of BN keys
//    through a ring of STAGES stages with TMA, over tensor maps of the
//    natural [N, T, heads, 64] rows (box: 64 columns, 1 head, rows, 1
//    image): a block reads its head's slice in place, with no transpose
//    copy, and a row of d = 64 is one 128-byte swizzled box. Rows past T
//    arrive as zeros. A stage is refilled once all 8 consumer warps have
//    released it.
//  - Per key tile j: S_j = Q K_j^T (SS wgmma, fp32 in registers) and O =
//    O * alpha + P_{j-1} V_{j-1} (RS wgmma: P in registers as the A
//    operand, V MN-major with the transpose bit) are issued as one group,
//    so the tensor cores run the two back to back; then the consumer runs
//    S_j's softmax in place (max, ex2, P rounded to bf16, the row sums) and
//    packs P into the A registers. S, P and O never leave the registers.
//    The two consumer warpgroups interleave their softmax and products on
//    the SM. Running S_j's softmax while P_{j-1} V_{j-1} is still in
//    flight (FA3's intra-warpgroup overlap) measured slower on an H100
//    (0.060-0.062 against 0.058 ms at 8 views).
//  - Occupancy: ~113 KB of shared memory (Q, 3 stages of K and V) and
//    ~154 registers x 288 threads a block allow one block an SM: 640
//    blocks are 4.8 waves on 132 SMs at 8 views, 2,080 are 15.8 at 26.
//  - The ragged tail: T = 577 = 4*128 + 65, so the last key tile holds 65
//    keys. TMA zero-fills the keys past T, which would still give logit 0,
//    so that tile (and only it) masks keys >= T to -inf. Rows past T are
//    not stored.
//
// Numerics follow the TPU kernel (ops/vit_attention.py:40-71): fp32 logits
// with scale * log2(e) folded into one multiply, exp2 against the running
// maximum, P rounded to bf16 for the value product, the row sum taken over
// the rounded P (the TPU kernel's ones column of V), one divide at the
// output.

#include "flash_sm90.cuh"

namespace {

using namespace sm90;

constexpr int D = 64;         // head dim (CLIP ViT-L)
constexpr int BM = 128;       // query rows a block
constexpr int BN = 128;       // keys a tile (one m64n128k16 S product)
constexpr int STAGES = 3;     // K/V ring
constexpr int CONSUMERS = 2;  // warpgroups of 64 rows
constexpr int THREADS = CONSUMERS * 128 + 32;  // and one producer warp
constexpr int Q_BYTES = BM * ROW_BYTES;        // one 64-column box a row
constexpr int KV_BYTES = BN * ROW_BYTES;
// Q, the K/V ring, barriers
constexpr size_t SMEM_BYTES = 1024 + Q_BYTES + STAGES * 2 * KV_BYTES + 8 * (1 + 2 * STAGES);
constexpr float SL2 = 0.125f * LOG2E;  // d^-0.5 * log2(e)

// S = Q K^T of one stage (issued, not committed): N = BN = 128 keys,
// K-major over the head dim; the first slice writes the accumulator
// without reading it.
__device__ __forceinline__ void s_product(float (&s)[BN / 2], uint32_t q_tile, uint32_t k_tile) {
  wgmma_n128_ss_set(s, desc_kmajor(q_tile, 0, 0), desc_kmajor(k_tile, 0, 0));
#pragma unroll
  for (int kk = 1; kk < D / 16; ++kk)
    wgmma_n128_ss(s, desc_kmajor(q_tile, kk, 0), desc_kmajor(k_tile, kk, 0), 1);
}

// O += P V of one stage (issued, not committed): one m64n64k16 for each 16
// keys.
__device__ __forceinline__ void pv_product(float (&o)[32], const uint32_t (&p)[BN / 4],
                                           uint32_t v_tile) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk)
    wgmma_n64_rs(o, p + 4 * kk, desc_mnmajor(v_tile, kk, KV_BYTES));
}

// The online softmax of one tile's S fragment (rows r = 0, 1 of this
// thread), in place: the logits S * scale * log2(e), keys >= t masked to
// -inf where the tile passes the sequence end, the new running max m, the
// rescale factor alpha of the earlier tiles, P = exp2(logit - m) rounded to
// bf16 (kept as floats in S's registers), and l = l * alpha + the row sum
// of the rounded P. The max is taken over the unscaled S (a positive scale
// keeps the order and rounds the maximum to the maximum of the rounded
// logits).
__device__ __forceinline__ void softmax_tile(float (&s)[BN / 2], int k0, int t, float (&m)[2],
                                             float (&l)[2], float (&alpha)[2]) {
  const int c2 = 2 * (threadIdx.x % 4);
  if (k0 + BN > t) {
#pragma unroll
    for (int i = 0; i < BN / 2; ++i)
      if (k0 + 8 * (i / 4) + c2 + (i & 1) >= t) s[i] = -INFINITY;
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int jj = 0; jj < BN / 8; ++jj) {
    mx[0] = fmaxf(mx[0], fmaxf(s[4 * jj], s[4 * jj + 1]));
    mx[1] = fmaxf(mx[1], fmaxf(s[4 * jj + 2], s[4 * jj + 3]));
  }
  float mu[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m_new = fmaxf(m[r], quad_max(mx[r]) * SL2);
    mu[r] = m_new == -INFINITY ? 0.f : m_new;  // a row with no key yet: p = 0
    alpha[r] = ex2(m[r] - mu[r]);
    m[r] = m_new;
  }
  float ls[2] = {0.f, 0.f};
#pragma unroll
  for (int jj = 0; jj < BN / 8; ++jj) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float& s0 = s[4 * jj + 2 * r];
      float& s1 = s[4 * jj + 2 * r + 1];
      // the logit rounded to fp32 before the subtraction (no fused
      // multiply-add), as the TPU kernel's s * (scale * log2 e) - m
      const __nv_bfloat162 pv = __floats2bfloat162_rn(ex2(__fmul_rn(s0, SL2) - mu[r]),
                                                      ex2(__fmul_rn(s1, SL2) - mu[r]));
      s0 = __low2float(pv);
      s1 = __high2float(pv);
      ls[r] += s0 + s1;
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + ls[r];
}

// O *= alpha per row.
__device__ __forceinline__ void rescale(float (&o)[32], const float (&alpha)[2]) {
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
    o[4 * jj] *= alpha[0];
    o[4 * jj + 1] *= alpha[0];
    o[4 * jj + 2] *= alpha[1];
    o[4 * jj + 3] *= alpha[1];
  }
}

__global__ void __launch_bounds__(THREADS, 1)
    vit_attention_kernel(const __grid_constant__ CUtensorMap q_map,
                         const __grid_constant__ CUtensorMap k_map,
                         const __grid_constant__ CUtensorMap v_map, bf16* __restrict__ o, int t,
                         int heads) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  unsigned char* qs = smem;
  unsigned char* ring = smem + Q_BYTES;  // stage s: K at s * 2 * KV_BYTES, V after it
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(ring + STAGES * 2 * KV_BYTES);
  uint64_t* full = bar_q + 1;
  uint64_t* empty = full + STAGES;

  const int q0 = blockIdx.x * BM, head = blockIdx.y, b = blockIdx.z;
  const int num_kt = (t + BN - 1) / BN;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
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
      mbar_expect_tx(bar_q, Q_BYTES);
      tma_load_4d(qs, &q_map, 0, head, q0, b, bar_q);
      for (int j = 0; j < num_kt; ++j) {
        const int s = j % STAGES;
        if (j >= STAGES) mbar_wait(&empty[s], (j / STAGES - 1) & 1);
        unsigned char* ks = ring + s * 2 * KV_BYTES;
        mbar_expect_tx(&full[s], 2 * KV_BYTES);
        tma_load_4d(ks, &k_map, 0, head, j * BN, b, &full[s]);
        tma_load_4d(ks + KV_BYTES, &v_map, 0, head, j * BN, b, &full[s]);
      }
    }
    return;
  }

  // a consumer warpgroup: rows q0 + 64 wg ..; this thread's rows qa, qa + 8
  const int wg = warp / 4;
  const int qa = q0 + wg * 64 + (warp % 4) * 16 + lane / 4;
  const uint32_t q_tile = smem_u32(qs) + wg * 64 * ROW_BYTES;
  const uint32_t ring_u32 = smem_u32(ring);
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, alpha[2];
  float oacc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) oacc[i] = 0.f;
  float s[BN / 2];
  uint32_t pa[BN / 4];
  mbar_wait(bar_q, 0);

  // tile 0: S alone
  mbar_wait(&full[0], 0);
  wgmma_fence();
  s_product(s, q_tile, ring_u32);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(s);
  softmax_tile(s, 0, t, m, l, alpha);
  to_a_fragments(s, pa);

  for (int j = 1; j < num_kt; ++j) {
    const int st = j % STAGES, prev = (j - 1) % STAGES;
    mbar_wait(&full[st], (j / STAGES) & 1);
    // S_j, then O = O * alpha + P_{j-1} V_{j-1}: one group of products,
    // each product's registers pinned before its fence, so that no other
    // instruction defines them inside the group (ptxas would serialize it)
    fence_regs(s);
    wgmma_fence();
    s_product(s, q_tile, ring_u32 + st * 2 * KV_BYTES);
    rescale(oacc, alpha);
    fence_regs(oacc);
    fence_regs(pa);
    wgmma_fence();
    pv_product(oacc, pa, ring_u32 + prev * 2 * KV_BYTES + KV_BYTES);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(oacc);
    fence_regs(pa);
    if (lane == 0) mbar_arrive(&empty[prev]);
    softmax_tile(s, j * BN, t, m, l, alpha);
    to_a_fragments(s, pa);
  }
  rescale(oacc, alpha);
  fence_regs(oacc);
  fence_regs(pa);
  wgmma_fence();
  pv_product(oacc, pa, ring_u32 + ((num_kt - 1) % STAGES) * 2 * KV_BYTES + KV_BYTES);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(oacc);
  fence_regs(pa);

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float sum = quad_sum(l[r]);
    inv[r] = sum > 0.f ? 1.f / sum : 0.f;
  }
  const long row_stride = (long)heads * D;
  store_rows(oacc, o + (long)b * t * row_stride + (long)head * D, row_stride, qa, t, inv);
}

}  // namespace

// q, k, v, o: [n, t, w] bf16 contiguous and 16-byte aligned, w = heads *
// head_dim. head_dim 64 only (CLIP ViT-L). Returns 0, a cudaError_t code,
// or -1 for an unsupported head_dim.
extern "C" int tp_vit_attention(const void* q, const void* k, const void* v, void* o, int n,
                                int t, int w, int heads, void* stream) {
  if (heads <= 0 || w != heads * D) return -1;
  if ((long)n * t == 0) return 0;
  const cudaError_t e = cudaFuncSetAttribute(
      vit_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  CUtensorMap q_map, k_map, v_map;
  int rc = encode_rows(&q_map, q, n, t, heads, D, BM);
  if (rc == 0) rc = encode_rows(&k_map, k, n, t, heads, D, BN);
  if (rc == 0) rc = encode_rows(&v_map, v, n, t, heads, D, BN);
  if (rc != 0) return rc;
  dim3 grid((t + BM - 1) / BM, heads, n);
  vit_attention_kernel<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      q_map, k_map, v_map, static_cast<bf16*>(o), t, heads);
  return (int)cudaGetLastError();
}

extern "C" const char* tp_error_string(int code) {
  if (code < 0) return "shape not supported by the kernel";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
