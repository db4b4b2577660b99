// K4: one int8 weight-only LLaMA decode step over every layer, from one
// host call.
//
// Replaces tokenpacker_tpu/ops/fused_decode.py:fused_decode_hidden (T = 1)
// and fused_verify_hidden (T = k+1 fed tokens a sample, speculative
// verify), with or without their slot-LoRA operand (K4-LoRA, below); the
// Pallas `_kernel` behind `_fused_call`. Per layer, for B samples and T
// tokens each (B * T rows, sample-major):
//   RMSNorm(h) * ln1 -> qkv GEMV (int8 weights, f32 sums, f32 per-column
//   scales) -> RoPE on q, k -> with an int8 cache, quantize-dequantize of
//   the new k, v per (row, head) -> attention over the cache ranges
//   [0, len0) U [start2, end2) plus the fed tokens -> o GEMV, h += ao ->
//   RMSNorm(h) * ln2 -> gate/up GEMV -> silu(gate) * up -> down GEMV,
//   h += mo.
//
// What bounds it on the H100: the step streams every int8 weight once
// (Vicuna-7B: 6.48 GB) and the valid cache rows once, at 2 * B * T FLOP
// per weight byte, far below the ~295 FLOP/byte where the tensor cores
// would be the limit: bound by bytes at 3.35 TB/s. The TPU kernel
// streamed the weights through one VMEM DMA ring inside one pallas_call.
// Here `tp_fused_decode` loops over the layers on the host and enqueues
// five kernels a layer (B * T <= 32; 32 rows a pass above that):
//   1. qkv GEMV with its epilogue (scales, RoPE, the qdq of the new k and
//      v, the cache-row write);  2. attention;  3. o GEMV with the
//   residual add;  4. gate/up GEMV with SiLU(g) * u;  5. down GEMV with
//   the residual add.
// The earlier design (9 kernels a layer, 16-byte weight loads straight
// into registers, fp32 partial sums of every K split through device
// memory into separate epilogue kernels, a row_rms launch before each
// tensor-core GEMV, one attention block a (head, fed token)) reached 40%
// of the bound at T = 1 and 22% in the verify form (PERF.md). This one
// (H100 80GB HBM3, 700 W, PERF.md: 46% at T = 1, 35% at T = 5):
//   - GEMV (gemv_kernel): the products run on mma.sync.m16n8k16 (bf16 in,
//     fp32 accumulate) with the weight as A (N on the 16-row side, x's
//     rows on the 8-wide side: one mma a 16 x 16 weight fragment at up to
//     8 rows, four at 32), every int8 pair widened to bf16 in registers
//     (exact: the low 7 bits into the mantissa of 128, less 128 or 256 by
//     the sign bit, one byte permute, two logic ops and one bf16x2
//     subtract a pair). A block takes 128 columns; its 4 warps are 2
//     column halves x 2 k halves of each 64-row stage, fed by a 4-stage
//     cp.async ring of [64, 128] weight tiles (chunks swizzled by row) with
//     x's slice and ln's. K is split over the blocks of a thread-block
//     cluster (gemv_splits); each leaves its fp32 partial in shared memory
//     and, after a cluster barrier, block r of the cluster takes rows r, r
//     + splits, ... of the tile: the splits' partials summed in split
//     order through distributed shared memory, then the epilogue in the
//     same launch. No workspace of partial sums, no epilogue launch.
//   - The qkv tile of 128 columns is one head of q, k or v, so RoPE's
//     pairs and the qdq's per-(row, head) amax stay in the block. A
//     gate/up tile takes gate columns [j, j + 64) and the same up columns
//     f apart (two runs of the one [d, 2f] weight).
//   - RMSNorm: the residual epilogues leave each (row, 128-column tile)'s
//     sum of squares of the new h (ssq); the next normed GEMV sums a row's
//     tiles in order for 1 / rms (the first layer's qkv sums h itself) and
//     normalizes x as it loads the B fragments: no row_rms launch.
//   - attention: one cluster a (head, sample) takes all T fed tokens'
//     queries, so each valid cache row is read once for all T, its keys
//     split over the cluster's blocks in whole 32-key tiles (att_splits;
//     keys outside the ranges are never read: KvSplit). At T = 1 on the
//     CUDA cores (attention_kernel): 8 warps a block read their keys
//     straight into registers, a lane group a key and 4 keys' loads in
//     flight, each lane group with its own online softmax, no barrier in
//     the loop. At 2-16 fed tokens on mma.sync with the queries as one m16
//     tile (attention_mma_kernel), its 32-key tiles through a 3-stage
//     cp.async ring (rows past a split's end are zero-filled copies),
//     where the CUDA-core form spent ~2 FMAs and a shared load a (query,
//     key, feature). Block 0 also takes the fed tokens (causal among
//     themselves) and merges the splits in split order through
//     distributed shared memory (merge_splits).
//   - Programmatic dependent launch: every kernel is launched with
//     cudaLaunchAttributeProgrammaticStreamSerialization (no other launch
//     mode: a trace's kernel spans overlap); it prefetches
//     its first weight stages (or cache tiles) into L2, waits
//     (griddepcontrol.wait) before its first read of anything an earlier
//     kernel writes and lets the next kernel launch (launch_dependents)
//     once its main loop is done, so the next kernel's prefetch streams
//     under this one's merge and epilogue. Triggered at the start instead,
//     the early blocks took SM slots from the running grid and the step
//     ran slower than in plain stream order.
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
// GEMV's own input, except for gate/up's, below. u is left as partial
// sums where x is made: for o by the attention's merge (a head's 128
// inputs), for down by the gate/up epilogue (a tile's 64 inputs), for
// gate/up by o's residual epilogue (a tile's 128 inputs, u's columns split
// over the cluster: lora_u_cluster); qkv's takes the one lora_u launch a
// layer (its rows normalized as the GEMV does; 512-row K groups, each a
// cluster merged in split order). A residual epilogue holds its tile of
// the new h but not the row's 1 / rms, which needs every tile: it leaves
// sum(h * ln * A) (f32 products of bf16 values), and gate/up multiplies
// the tiles' sum by the row's 1 / rms, so its u takes x' = h * inv * ln
// unrounded where the GEMV takes bf16(bf16(h * inv) * ln): 2^-8 at most
// relative a term of the sum, below um's own bf16 rounding. (Folding
// qkv's u into down's epilogue the same way, for no u launch past the
// first layer, made the step slower: PERF.md.) In the GEMV each
// split takes a share of um's columns: it sums u's partials in order,
// masks and rounds them, stages its share of B's rows for the tile and
// leaves its share of the term for every row as a third partial plane,
// which the cluster merge adds in split order after the scaled base sum:
// B is read once a tile and the term costs no serial tail. An all-zero
// mask row gives an exact 0 term, so an empty slot keeps K4's output.
//
// Numerics follow the TPU kernel: x and the weights are exact in bf16, so
// the GEMVs differ from it only in the order of the f32 sums; RoPE in f32
// then bf16; the current token's k/v quantize-dequantized with
// scale = max(amax, 1e-8) / 127 and round-half-even (rintf, IEEE division:
// this file must not be built with fast math); attention logits f32, the
// value product with bf16-rounded probabilities and an f32 denominator.
// The cache row is written as kv_quant.quantize_kv of the bf16
// quantize-dequantized row, so it equals what the plain version writes.
// The TPU kernel also rounds each k*q product to bf16 before the head sum;
// this kernel does not. At T > 1 the fed tokens' probabilities are rounded
// to bf16 for the value product like the cache's (the TPU kernel's T > 1
// form); at T = 1 the current token's is not. Every sum runs in a fixed
// order, so two calls give the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <cmath>

#include "split_merge.cuh"

namespace {

using namespace split_merge;
using bf16 = __nv_bfloat16;

constexpr int HD = 128;             // head_dim (Vicuna)
constexpr int MAX_SPLITS = 8;       // the portable cluster size
constexpr int PTRS_PER_LAYER = 10;

// GEMV
constexpr int SROWS = 64;           // weight rows a stage
constexpr int NB = 128;             // columns a block
constexpr int GEMV_THREADS = 128;   // 4 warps: 2 column halves x 2 k halves
constexpr int STAGES = 4;           // stages in the cp.async ring
constexpr int XSTRIDE = 144;        // bytes a staged x row: 64 bf16 + 16 (conflict-free)
constexpr int PART_LD = 132;        // floats a partial row: 128 + 4 (conflict-free)
constexpr int MAX_MT = 4;           // 8-row tiles of x a pass: 32 rows
constexpr int W_BYTES = SROWS * NB;
constexpr int LN_BYTES = SROWS * 2;
constexpr int LORA_CHUNK = 64;      // um columns an epilogue stages at a time (8 rows)
constexpr int LB_ROWS = 128;        // rows of K4-LoRA's B a GEMV block stages in shared memory

// attention
constexpr int TILE = 32;            // keys a tile
constexpr int ATT_STAGES = 3;
constexpr int ATT_THREADS = 256;    // 8 warps
constexpr int MAX_TOK = 16;         // fed tokens a sample
constexpr int MQ = MAX_TOK;         // query rows of the tensor-core attention

// lora_u
constexpr int LU_THREADS = 256;
constexpr int LU_COLS = 32;         // columns of A a block
constexpr int LU_CHUNK = 64;        // rows of K a block
constexpr int LU_SPLITS = 8;        // blocks a cluster: 512 rows of K a group

__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float round_bf(float x) { return __bfloat162float(__float2bfloat16(x)); }

__device__ __forceinline__ void griddep_wait() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}
__device__ __forceinline__ void griddep_launch() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}
__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

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

// byte J of lo (lower half) and of hi (upper half) -> bf16x2, exact: the
// low 7 bits b go into the mantissa of 128 (128 + b), the sign bit s
// into the lowest exponent bit of 128 (128 or 256); (128 + b) - (128 +
// 128 s) = b - 128 s is the int8 value.
template <int J>
__device__ __forceinline__ uint32_t i8pair_bf16(uint32_t lo, uint32_t hi) {
  const uint32_t p = __byte_perm(lo, hi, (J) | (J << 4) | ((4 + J) << 8) | ((4 + J) << 12));
  const uint32_t a = (p & 0x007F007Fu) | 0x43004300u;
  const uint32_t b = (p & 0x00800080u) | 0x43004300u;
  const __nv_bfloat162 r = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&a),
                                   *reinterpret_cast<const __nv_bfloat162*>(&b));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// bf16x2 of x -> bf16x2 of bf16(bf16(x * inv) * ln) (RMSNorm as the plain
// version rounds it)
__device__ __forceinline__ uint32_t norm_pair(uint32_t x, float inv, uint32_t ln) {
  const float lo = __uint_as_float(x << 16) * inv, hi = __uint_as_float(x & 0xFFFF0000u) * inv;
  const __nv_bfloat162 y = __hmul2(__floats2bfloat162_rn(lo, hi),
                                   *reinterpret_cast<const __nv_bfloat162*>(&ln));
  return *reinterpret_cast<const uint32_t*>(&y);
}

__device__ __forceinline__ void mma_bf16(float* c, uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// the largest |v| of a 128-thread block; red4: 4 floats of shared memory
__device__ __forceinline__ float block_max_128(float v, float* red4) {
  v = warp_max(v);
  __syncthreads();  // red4 may still be read from the previous call
  if (threadIdx.x % 32 == 0) red4[threadIdx.x / 32] = v;
  __syncthreads();
  return fmaxf(fmaxf(red4[0], red4[1]), fmaxf(red4[2], red4[3]));
}

// the sum of a 128-thread block, warps in order; red4 as above
__device__ __forceinline__ float block_sum_128(float v, float* red4) {
  v = warp_sum(v);
  __syncthreads();
  if (threadIdx.x % 32 == 0) red4[threadIdx.x / 32] = v;
  __syncthreads();
  return ((red4[0] + red4[1]) + red4[2]) + red4[3];
}

// 1 / rms of rows [0, rows) of x [rows, k] into inv[]: from ssq [rows]
// [tiles] (the residual epilogues' sums of squares, summed in tile order)
// or, without it, from x itself (a warp a row). Every block of a launch
// computes the same bits. Ends with a barrier.
__device__ __forceinline__ void row_inv_rms(const bf16* x, int rows, int k, const float* ssq,
                                            int tiles, float eps, float* inv) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, warps = blockDim.x / 32;
  if (ssq != nullptr) {
    if (tid < rows) {
      float s = 0.f;
      for (int i = 0; i < tiles; ++i) s += ssq[(long)tid * tiles + i];
      inv[tid] = 1.0f / sqrtf(s / (float)k + eps);
    }
  } else {
    for (int r = warp; r < rows; r += warps) {
      float s = 0.f;
      for (int i = 2 * lane; i < k; i += 64) {
        const float2 v =
            __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(x + (long)r * k + i));
        s += v.x * v.x + v.y * v.y;
      }
      s = warp_sum(s);
      if (lane == 0) inv[r] = 1.0f / sqrtf(s / (float)k + eps);
    }
  }
  __syncthreads();
}

// K4-LoRA's u where its input is made: the o target's from the attention
// output (a block's head: 128 inputs), the down target's from the MLP
// activation (a gate/up tile: 64 inputs). For rows < nr and j < w:
// uout[r * ustride + j] = sum over c < nc of xs[r * xld + c] * a[c * lda
// + j], a's columns staged 64 at a time into `as` (shared, nc * AS_LD
// bf16; 16 loads in flight a thread); each sum split over the tpp lanes
// of an aligned group (c = sub, sub + tpp, ...) and added in a fixed
// butterfly. Every thread of the block calls it.
constexpr int AS_LD = 66;  // bf16 a staged row of A (the group's lanes hit distinct banks)
__device__ __forceinline__ void lora_u_partial(const float* xs, int xld, int nr, int nc,
                                               const bf16* a, int lda, int w, bf16* as,
                                               float* uout, long ustride) {
  const int n = blockDim.x;
  for (int j0 = 0; j0 < w; j0 += 64) {
    const int nj = min(64, w - j0);
    __syncthreads();  // as may still be read from the previous chunk
    for (int e0 = threadIdx.x; e0 < nc * 64; e0 += 16 * n) {
      bf16 got[16];
#pragma unroll
      for (int q = 0; q < 16; ++q) {
        const int e = e0 + q * n;
        got[q] = e < nc * 64 && e % 64 < nj ? a[(long)(e / 64) * lda + j0 + e % 64]
                                            : __float2bfloat16(0.f);
      }
#pragma unroll
      for (int q = 0; q < 16; ++q) {
        const int e = e0 + q * n;
        if (e < nc * 64) as[(e / 64) * AS_LD + e % 64] = got[q];
      }
    }
    __syncthreads();
    const int pairs = nr * nj;
    int tpp = 1;
    while (tpp < 32 && 2 * tpp * pairs <= n) tpp *= 2;
    for (int base = 0; base < pairs * tpp; base += n) {  // uniform trip count
      const int e = base + threadIdx.x, pr = e / tpp, sub = e % tpp;
      const bool act = e < pairs * tpp;
      float u = 0.f;
      if (act) {
        const int r = pr / nj, j = pr % nj;
        for (int c = sub; c < nc; c += tpp) u = fmaf(xs[r * xld + c], to_f(as[c * AS_LD + j]), u);
      }
      for (int o = tpp / 2; o > 0; o >>= 1) u += __shfl_xor_sync(0xffffffffu, u, o);
      if (act && sub == 0) uout[(pr / nj) * ustride + j0 + pr % nj] = u;
    }
  }
}

// K4-LoRA's u over one residual tile's NB inputs for every row < rows of
// a pass, split over the cluster by u's columns: block `split` takes
// columns [j0, j0 + nj) = [split w / splits, (split + 1) w / splits).
// Its share of A ([NB][nj], at most NB * LU_SHARE elements) is loaded
// all at once (up to 16 loads a thread in flight) while the rows' inputs
// (row i in block i % splits at xrows + (i / splits) * NB) are gathered
// through distributed shared memory; both land in xs (rows * NB floats,
// then A's share as floats). Each sum is split over the tpp lanes of an
// aligned group (c = sub, sub + tpp, ...) and added in a fixed butterfly:
// uout[i * w + j] = sum over c of x[i][c] * a[c * lda + j]. Every thread
// of every block of the cluster calls it, after a cluster barrier.
constexpr int LU_SHARE = 16;  // u columns a block of the cluster takes at most
__device__ __forceinline__ void lora_u_cluster(const float* xrows, float* xs, int rows, int split,
                                               int splits, const bf16* a, int lda, int w,
                                               float* uout) {
  cg::cluster_group cluster = cg::this_cluster();
  const int n = blockDim.x, tid = threadIdx.x;
  float* as = xs + rows * NB;
  for (int jb = 0; jb < w; jb += LU_SHARE * splits) {  // uniform
    const int wb = min(LU_SHARE * splits, w - jb);
    const int j0 = jb + split * wb / splits, nj = jb + (split + 1) * wb / splits - j0;
    constexpr int PER = 16;
    float got[PER];
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      const int e = tid + q * n;
      got[q] = e < NB * nj ? to_f(a[(long)(e / nj) * lda + j0 + e % nj]) : 0.f;
    }
    if (jb == 0)
      for (int e = tid; e < rows * NB; e += n)
        xs[e] = cluster.map_shared_rank(xrows, (e / NB) % splits)[(e / NB / splits) * NB + e % NB];
    __syncthreads();  // as may still be read from the previous columns
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      const int e = tid + q * n;
      if (e < NB * nj) as[e] = got[q];
    }
    __syncthreads();
    const int pairs = rows * nj;
    int tpp = 1;
    while (tpp < 32 && 2 * tpp * pairs <= n) tpp *= 2;
    for (int base = 0; base < pairs * tpp; base += n) {  // uniform trip count
      const int e = base + tid, pr = e / tpp, sub = e % tpp;
      const bool act = e < pairs * tpp;
      const int r = act ? pr / nj : 0, j = act ? pr % nj : 0;
      float u = 0.f;
      if (act)
        for (int c = sub; c < NB; c += tpp) u = fmaf(xs[r * NB + c], as[c * nj + j], u);
      for (int o = tpp / 2; o > 0; o >>= 1) u += __shfl_xor_sync(0xffffffffu, u, o);
      if (act && sub == 0) uout[(long)r * w + j0 + j] = u;
    }
  }
}

// The attention's part in K4-LoRA: the o target's A (this layer, its
// columns), and u's partial sums out, [heads][rows][w] (a = nullptr: none)
struct LoraU {
  const bf16* a;
  int lda, w, rows;
  float* upart;
};

// ---- GEMV with its epilogue ------------------------------------------------

enum Epi { EPI_QKV = 0, EPI_RESIDUAL = 1, EPI_GATEUP = 2 };

// One product of one pass of at most 32 rows. Row-indexed arrays (x, out,
// ssq, ssq_out, um, positions, k_new, v_new) start at this pass's first
// row; row0 is that row's index in the step (its sample and fed token).
struct GemvArgs {
  const bf16* x;          // [rows, k] bf16
  int rows, k;
  const bf16* ln;         // RMSNorm prologue (ln != nullptr): x' = bf16(bf16(x * inv) * ln)
  const float* ssq;       // [rows][ssq_tiles], or nullptr: from x
  int ssq_tiles;
  float eps;
  const int8_t* w;        // [k, ldw]
  int ldw, f;             // f: gate/up's half width
  const float* scale;     // [ldw]
  const float* upart;     // K4-LoRA: u's partial sums [uparts][..][lw] f32, or nullptr
  int uparts;
  long ucs;               // floats from one partial's plane to the next
  int u_inv;              // the sums are of the rows before RMSNorm's 1 / rms: times inv
  const float* selm;      // [rows][ldm]: the target's column mask
  int ldm;
  const bf16* lb;         // [lw, ldw]
  int lw;
  bf16* out;              // QKV: q [rows, d]; RESIDUAL: h [rows, ldw]; GATEUP: xm [rows, f]
  const bf16* ua;         // K4-LoRA: the next target's A, or nullptr: GATEUP down's [f, ulda],
                          // RESIDUAL (o) gate/up's [d, ulda]
  const bf16* uln;        // RESIDUAL: that product's RMSNorm weights [d]
  int ulda, uw, urows;
  float* uout;            // its u partial sums [planes][urows][uw], at this pass's first row:
                          // a plane a tile
  float* ssq_out;         // RESIDUAL: [rows][ldw / 128]
  // QKV
  int row0, t_tok, heads, s_len, kv_int8;
  const int* positions;   // [rows]
  const int* write_pos;   // [b]
  float theta;
  bf16 *k_new, *v_new;    // [rows, d]
  void *cache_k, *cache_v;  // this layer's [b, s_len, heads, 128]
  float *k_scale, *v_scale;  // [b, s_len, heads] (int8)
};

template <int MT>
__host__ __device__ constexpr int gemv_stage_bytes() {
  return W_BYTES + LN_BYTES + MT * 8 * XSTRIDE;
}

// the ring (or, after the loop, the partial: the two k halves' sums and
// K4-LoRA's term), then K4-LoRA's B rows of this split's share of the
// block's columns: [<= LB_ROWS][NB] bf16
template <int MT>
__host__ __device__ constexpr int gemv_ring_bytes() {
  return STAGES * gemv_stage_bytes<MT>() > 3 * MT * 8 * PART_LD * 4 ? STAGES * gemv_stage_bytes<MT>()
                                                                     : 3 * MT * 8 * PART_LD * 4;
}
// K4-LoRA's staging after the ring: B's rows of the split's share, um
// [MAX_MT * 8][LORA_CHUNK] f32 (once the term is done, the rows of the
// next target's u input: gate/up's MLP activation, 64 a row, or the
// residual's h * ln, 128 a row), the next target's A chunk [64][64] bf16
constexpr int UMS_BYTES = MAX_MT * 8 * LORA_CHUNK * 4, AS_BYTES = 64 * 66 * 2;
__host__ __device__ constexpr int lora_b_rows(int lw, int splits) {
  return (lw + splits - 1) / splits < LB_ROWS ? (lw + splits - 1) / splits : LB_ROWS;
}
__host__ __device__ constexpr int ums_bytes(int rows, int splits) {
  return (rows + splits - 1) / splits * NB * 4 > UMS_BYTES ? (rows + splits - 1) / splits * NB * 4
                                                           : UMS_BYTES;
}
template <int MT>
constexpr int gemv_smem_bytes() {
  return gemv_ring_bytes<MT>() + LB_ROWS * NB * 2 + ums_bytes(MT * 8, 1) + AS_BYTES;
}

// the byte offset of 16-byte chunk c (16 columns) of stage row r: chunks
// swizzled by bits 1-2 of the row, so the rows 2t (+1, +8, +9) that lanes
// t of a warp read at one column word land on 4 distinct 8-word bank groups
__device__ __forceinline__ int w_offset(int r, int c) {
  return r * NB + ((c ^ (((r >> 1) & 3) << 1)) << 4);
}

// the weight column of virtual column v (0..127) of tile `tile`, and
// whether it exists
template <int EPI>
__device__ __forceinline__ int col_of(int v, int tile, int f) {
  if (EPI == EPI_GATEUP) return v < 64 ? tile * 64 + v : f + tile * 64 + v - 64;
  return tile * NB + v;
}
template <int EPI>
__device__ __forceinline__ bool col_ok(int v, int tile, const GemvArgs& a) {
  if (EPI == EPI_GATEUP) return tile * 64 + (v & 63) < a.f;
  return tile * NB + v < a.ldw;
}

// grid (splits, tiles), one cluster of `splits` blocks a tile of 128
// virtual columns; rows <= MT * 8.
template <int MT, int EPI>
__global__ void __launch_bounds__(GEMV_THREADS, 3) gemv_kernel(const GemvArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float inv_s[MAX_MT * 8];
  __shared__ float vals[NB];
  __shared__ float red4[4];
  constexpr int STAGE = gemv_stage_bytes<MT>();
  const bf16* lbs = reinterpret_cast<const bf16*>(smem + gemv_ring_bytes<MT>());
  float* ums = reinterpret_cast<float*>(smem + gemv_ring_bytes<MT>() +
                                        lora_b_rows(a.lw, gridDim.x) * NB * 2);
  float* xrows = ums;  // the next target's u input rows, once the term is done
  bf16* as_u =
      reinterpret_cast<bf16*>(reinterpret_cast<unsigned char*>(ums) + ums_bytes(a.rows, gridDim.x));
  const int split = blockIdx.x, splits = gridDim.x, tile = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int ch = warp & 1, kh = warp >> 1;  // column half, k half
  const int k = a.k, rows = a.rows;
  const bool norm = a.ln != nullptr;

  // this split's stages, balanced
  const int nstages = (k + SROWS - 1) / SROWS;
  const int s0 = split * nstages / splits, s1 = (split + 1) * nstages / splits;
  const int ns = s1 - s0;

  // This thread's copies of a stage, the same every stage: weight chunks
  // tid + 128 u (row j / 8, 16 columns j % 8), x chunks tid (+ 128) of MT
  // * 64 (row j / 8, 8 k's j % 8), ln chunk tid (tid < 8).
  constexpr int XCHUNKS = MT * 64, XLOADS = (XCHUNKS + GEMV_THREADS - 1) / GEMV_THREADS;
  const int8_t* w_src[4];
  int w_dst[4], w_row[4];
  bool w_ok[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int j = tid + u * GEMV_THREADS, r = j / 8, c = j % 8;
    const int col = col_of<EPI>(16 * c, tile, a.f);
    w_ok[u] = col_ok<EPI>(16 * c, tile, a);
    w_row[u] = r;
    w_src[u] = a.w + (long)r * a.ldw + (w_ok[u] ? col : 0);
    w_dst[u] = w_offset(r, c);
  }
  const bf16* x_src[XLOADS];
  int x_dst[XLOADS], x_col[XLOADS];
  bool x_ok[XLOADS];
#pragma unroll
  for (int u = 0; u < XLOADS; ++u) {
    const int j = tid + u * GEMV_THREADS, r = j / 8, c = j % 8;
    x_ok[u] = j < XCHUNKS && r < rows;
    x_src[u] = a.x + (x_ok[u] ? (long)r * k : 0) + 8 * c;
    x_col[u] = 8 * c;
    x_dst[u] = W_BYTES + LN_BYTES + r * XSTRIDE + 16 * c;
  }
  auto load = [&](int i) {
    unsigned char* st = smem + (i % STAGES) * STAGE;
    const int r0 = (s0 + i) * SROWS;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const bool ok = w_ok[u] && r0 + w_row[u] < k;
      cp_async_16(st + w_dst[u], ok ? w_src[u] + (long)r0 * a.ldw : a.w, ok);
    }
#pragma unroll
    for (int u = 0; u < XLOADS; ++u)
      if (tid + u * GEMV_THREADS < XCHUNKS) {
        const bool ok = x_ok[u] && r0 + x_col[u] < k;
        cp_async_16(st + x_dst[u], ok ? x_src[u] + r0 : a.x, ok);
      }
    if (norm && tid < 8) {
      const bool ok = r0 + 8 * tid < k;
      cp_async_16(st + W_BYTES + 16 * tid, ok ? a.ln + r0 + 8 * tid : a.ln, ok);
    }
  };

  // the first stages' weights (and K4-LoRA's B columns of this tile) into
  // L2 while the previous kernel drains
#pragma unroll
  for (int i = 0; i < STAGES; ++i)
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (i < ns && w_ok[u] && (s0 + i) * SROWS + w_row[u] < k)
        prefetch_l2(w_src[u] + (long)(s0 + i) * SROWS * a.ldw);
  // K4-LoRA: this split's share [js0, js1) of um's columns, whose term
  // it adds for every row; B's rows of the share for this tile into
  // shared memory (the first LB_ROWS; the rest into L2)
  const bool lora = a.upart != nullptr;
  const int js0 = lora ? split * a.lw / splits : 0, js1 = lora ? (split + 1) * a.lw / splits : 0;
  const int lb_rows = min(js1 - js0, LB_ROWS);
  for (int i = tid; i < 2 * (js1 - js0 - lb_rows); i += GEMV_THREADS)
    if (col_ok<EPI>(64 * (i & 1), tile, a))
      prefetch_l2(a.lb + (long)(js0 + lb_rows + i / 2) * a.ldw + col_of<EPI>(64 * (i & 1), tile, a.f));
  if (EPI != EPI_QKV && a.ua != nullptr && split < rows) {  // the next target's A rows of the tile
    const int ur = EPI == EPI_GATEUP ? 64 : NB;
    for (int c = tid; c < min(ur, (EPI == EPI_GATEUP ? a.f : a.ldw) - tile * ur); c += GEMV_THREADS)
      prefetch_l2(a.ua + (long)(tile * ur + c) * a.ulda);
  }
  // (in the last prologue group: the first stages go first)
  auto load_b = [&]() {
    for (int i = tid; i < lb_rows * (NB / 8); i += GEMV_THREADS) {
      const int j = i / (NB / 8), c = i % (NB / 8);
      const bool ok = col_ok<EPI>(8 * c, tile, a);
      cp_async_16(const_cast<bf16*>(lbs) + j * NB + 8 * c,
                  ok ? a.lb + (long)(js0 + j) * a.ldw + col_of<EPI>(8 * c, tile, a.f) : a.lb, ok);
    }
  };
  griddep_wait();

  float acc[4][MT][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][i][e] = 0.f;

#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < ns) load(i);
    if (i == STAGES - 2) load_b();
    cp_async_commit();
  }
  float inv[MT];
  if (norm) {
    row_inv_rms(a.x, rows, k, a.ssq, a.ssq_tiles, a.eps, inv_s);
#pragma unroll
    for (int i = 0; i < MT; ++i) inv[i] = 8 * i + g < rows ? inv_s[8 * i + g] : 0.f;
  }
  // this thread's column words in a stage row: a0 / a2 at byte column 64
  // ch + 4 g, a1 / a3 at 64 ch + 32 + 4 g (word 16 ch + g, + 8)
  const int word_lo = 16 * ch + g, word_hi = word_lo + 8;
  const int sw_lo = 4 * (word_lo ^ (8 * t)), sw_hi = 4 * (word_hi ^ (8 * t));
  for (int it = 0; it < ns; ++it) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage it landed; every thread is done with stage it - 1
    if (it + STAGES - 1 < ns) load(it + STAGES - 1);
    cp_async_commit();
    const unsigned char* st = smem + (it % STAGES) * STAGE;
    const unsigned char* xs = st + W_BYTES + LN_BYTES;
#pragma unroll
    for (int s2 = 0; s2 < 2; ++s2) {
      const int rb = 16 * (2 * kh + s2);  // this k16 step: stage rows rb .. rb + 15
      const unsigned char* r0p = st + (rb + 2 * t) * NB;
      const uint32_t w00 = *reinterpret_cast<const uint32_t*>(r0p + sw_lo);
      const uint32_t w01 = *reinterpret_cast<const uint32_t*>(r0p + NB + sw_lo);
      const uint32_t w10 = *reinterpret_cast<const uint32_t*>(r0p + sw_hi);
      const uint32_t w11 = *reinterpret_cast<const uint32_t*>(r0p + NB + sw_hi);
      const uint32_t w20 = *reinterpret_cast<const uint32_t*>(r0p + 8 * NB + sw_lo);
      const uint32_t w21 = *reinterpret_cast<const uint32_t*>(r0p + 9 * NB + sw_lo);
      const uint32_t w30 = *reinterpret_cast<const uint32_t*>(r0p + 8 * NB + sw_hi);
      const uint32_t w31 = *reinterpret_cast<const uint32_t*>(r0p + 9 * NB + sw_hi);
      uint32_t b[MT][2];
      uint32_t ln0 = 0, ln1 = 0;
      if (norm) {
        ln0 = *reinterpret_cast<const uint32_t*>(st + W_BYTES + (rb + 2 * t) * 2);
        ln1 = *reinterpret_cast<const uint32_t*>(st + W_BYTES + (rb + 2 * t + 8) * 2);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const unsigned char* xr = xs + (8 * i + g) * XSTRIDE + (rb + 2 * t) * 2;
        b[i][0] = *reinterpret_cast<const uint32_t*>(xr);
        b[i][1] = *reinterpret_cast<const uint32_t*>(xr + 16);
        if (norm) {
          b[i][0] = norm_pair(b[i][0], inv[i], ln0);
          b[i][1] = norm_pair(b[i][1], inv[i], ln1);
        }
      }
#define TP_TILE(J)                                                                   \
  {                                                                                  \
    const uint32_t a0 = i8pair_bf16<J>(w00, w01), a1 = i8pair_bf16<J>(w10, w11);     \
    const uint32_t a2 = i8pair_bf16<J>(w20, w21), a3 = i8pair_bf16<J>(w30, w31);     \
    _Pragma("unroll") for (int i = 0; i < MT; ++i)                                   \
        mma_bf16(acc[J][i], a0, a1, a2, a3, b[i][0], b[i][1]);                        \
  }
      TP_TILE(0)
      TP_TILE(1)
      TP_TILE(2)
      TP_TILE(3)
#undef TP_TILE
    }
  }

  // the block's partial into the free ring: c0 / c2 (x row 8 i + 2 t) and
  // c1 / c3 (row 8 i + 2 t + 1) of virtual columns 64 ch + 4 g + j (c0,
  // c1) and 64 ch + 32 + 4 g + j (c2, c3), four tiles j a 16-byte store
  cp_async_wait<0>();
  __syncthreads();
  griddep_launch();  // the next kernel's blocks may start their prefetch
  float* part = reinterpret_cast<float*>(smem);  // [3][MT * 8][PART_LD]
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    float* p = part + (kh * MT * 8 + 8 * i + 2 * t) * PART_LD + 64 * ch + 4 * g;
    *reinterpret_cast<float4*>(p) =
        make_float4(acc[0][i][0], acc[1][i][0], acc[2][i][0], acc[3][i][0]);
    *reinterpret_cast<float4*>(p + PART_LD) =
        make_float4(acc[0][i][1], acc[1][i][1], acc[2][i][1], acc[3][i][1]);
    *reinterpret_cast<float4*>(p + 32) =
        make_float4(acc[0][i][2], acc[1][i][2], acc[2][i][2], acc[3][i][2]);
    *reinterpret_cast<float4*>(p + PART_LD + 32) =
        make_float4(acc[0][i][3], acc[1][i][3], acc[2][i][3], acc[3][i][3]);
  }

  const int v = tid;
  const int col = col_of<EPI>(v, tile, a.f);
  const bool ok = col_ok<EPI>(v, tile, a);
  if (lora) {  // the term of this split's share for every row: um[row, js0:js1] @ B[js0:js1, col]
    float tacc[MT * 8];
#pragma unroll
    for (int r = 0; r < MT * 8; ++r) tacc[r] = 0.f;
    for (int j0 = js0; j0 < js1; j0 += LORA_CHUNK) {
      const int nj = min(LORA_CHUNK, js1 - j0);
      __syncthreads();  // ums may still be read from the previous chunk
      // um = bf16(u * mask), u's partial sums added in order
      for (int e = tid; e < rows * nj; e += GEMV_THREADS) {
        const int r = e / nj, j = e % nj;
        const float* up = a.upart + (long)r * a.lw + j0 + j;
        float u = 0.f;
        int c = 0;
        for (; c + 16 <= a.uparts; c += 16) {  // 16 loads in flight, added in order
          float t16[16];
#pragma unroll
          for (int q = 0; q < 16; ++q) t16[q] = up[(c + q) * a.ucs];
#pragma unroll
          for (int q = 0; q < 16; ++q) u += t16[q];
        }
        for (; c < a.uparts; ++c) u += up[c * a.ucs];
        if (a.u_inv) u *= inv_s[r];
        ums[r * LORA_CHUNK + j] = round_bf(u * a.selm[(long)r * a.ldm + j0 + j]);
      }
      __syncthreads();
      if (ok) {
        for (int j = 0; j < nj; ++j) {
          const int jj = j0 + j - js0;
          const float b = to_f(jj < lb_rows ? lbs[jj * NB + v] : a.lb[(long)(j0 + j) * a.ldw + col]);
#pragma unroll
          for (int r = 0; r < MT * 8; ++r)
            if (r < rows) tacc[r] = fmaf(ums[r * LORA_CHUNK + j], b, tacc[r]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < MT * 8; ++r) part[(2 * MT * 8 + r) * PART_LD + v] = tacc[r];
  }

  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const float sc = ok ? a.scale[col] : 0.f;
  // RoPE's frequency of this thread's feature (q and k tiles)
  const float inv_freq =
      EPI == EPI_QKV ? 1.0f / powf(a.theta, (float)(2 * (v % (HD / 2))) / (float)HD) : 0.f;
  // (row, v) of every split's partial planes, through distributed shared
  // memory; the next row's are in flight while a row's epilogue runs
  float nxt[3 * MAX_SPLITS];
  auto gather = [&](int row) {
#pragma unroll
    for (int r = 0; r < MAX_SPLITS; ++r)
      if (r < splits) {
        const float* remote = cluster.map_shared_rank(part, r);
        nxt[3 * r] = remote[row * PART_LD + v];
        nxt[3 * r + 1] = remote[(MT * 8 + row) * PART_LD + v];
        nxt[3 * r + 2] = lora ? remote[(2 * MT * 8 + row) * PART_LD + v] : 0.f;
      }
  };
  if (split < rows) gather(split);
  for (int row = split; row < rows; row += splits) {  // uniform across the block
    // the splits' sums of (row, v) in split order, times the scale, plus
    // the splits' adapter terms in split order
    float got[3 * MAX_SPLITS];
#pragma unroll
    for (int r = 0; r < 3 * MAX_SPLITS; ++r) got[r] = nxt[r];
    if (row + splits < rows) gather(row + splits);
    float y = 0.f, term = 0.f;
#pragma unroll
    for (int r = 0; r < MAX_SPLITS; ++r)
      if (r < splits) {
        y += got[3 * r];
        y += got[3 * r + 1];
        term += got[3 * r + 2];
      }
    y *= sc;
    if (lora) y += term;

    if constexpr (EPI == EPI_QKV) {
      const int part_id = tile / a.heads, head = tile % a.heads;
      if (part_id < 2) {
        __syncthreads();  // vals may still be read from the previous row
        vals[v] = y;
        __syncthreads();
        const float rot = v < HD / 2 ? -vals[v + HD / 2] : vals[v - HD / 2];
        const float fr = (float)a.positions[row] * inv_freq;
        y = y * cosf(fr) + rot * sinf(fr);
      }
      y = round_bf(y);
      const long o = ((long)row * a.heads + head) * HD + v;
      if (part_id == 0) {
        a.out[o] = __float2bfloat16(y);
      } else {
        const int arow = a.row0 + row, sample = arow / a.t_tok;
        const int pos = a.write_pos[sample] + arow % a.t_tok;
        const bool store = pos >= 0 && pos < a.s_len;
        const long slot = ((long)sample * a.s_len + pos) * a.heads + head;
        if (a.kv_int8) {
          const float s1 = fmaxf(block_max_128(fabsf(y), red4), 1e-8f) / 127.0f;
          y = round_bf(rintf(y / s1) * s1);
          const float s2 = fmaxf(block_max_128(fabsf(y), red4), 1e-8f) / 127.0f;
          int8_t* cache = static_cast<int8_t*>(part_id == 1 ? a.cache_k : a.cache_v);
          if (store) {
            cache[slot * HD + v] = (int8_t)rintf(y / s2);
            if (v == 0) (part_id == 1 ? a.k_scale : a.v_scale)[slot] = s2;
          }
        } else if (store) {
          static_cast<bf16*>(part_id == 1 ? a.cache_k : a.cache_v)[slot * HD + v] =
              __float2bfloat16(y);
        }
        (part_id == 1 ? a.k_new : a.v_new)[o] = __float2bfloat16(y);
      }
    } else if constexpr (EPI == EPI_RESIDUAL) {
      float sq = 0.f;
      if (ok) {
        const long at = (long)row * a.ldw + col;
        const bf16 hn = __float2bfloat16(to_f(a.out[at]) + round_bf(y));
        a.out[at] = hn;
        sq = to_f(hn) * to_f(hn);
        if (a.ua != nullptr) xrows[(row - split) / splits * NB + v] = to_f(hn) * to_f(a.uln[col]);
      }
      const float s = block_sum_128(sq, red4);
      if (v == 0) a.ssq_out[(long)row * (a.ldw / NB) + tile] = s;
    } else {  // EPI_GATEUP
      __syncthreads();  // vals may still be read from the previous row
      vals[v] = y;
      __syncthreads();
      float xv = 0.f;
      if (v < 64 && ok) {
        const float gt = vals[v], up = vals[v + 64];
        const bf16 xb = __float2bfloat16(gt / (1.0f + expf(-gt)) * up);
        a.out[(long)row * a.f + tile * 64 + v] = xb;
        xv = to_f(xb);
      }
      if (a.ua != nullptr && v < 64) xrows[(row - split) / splits * 64 + v] = xv;
    }
  }
  if constexpr (EPI == EPI_GATEUP) {
    if (a.ua != nullptr && split < rows)  // the down target's u over this tile's 64 inputs, the block's rows
      lora_u_partial(xrows, 64, (rows - split + splits - 1) / splits,
                     min(64, a.f - tile * 64), a.ua + (long)tile * 64 * a.ulda, a.ulda, a.uw,
                     as_u, a.uout + ((long)tile * a.urows + split) * a.uw, (long)splits * a.uw);
  } else if constexpr (EPI == EPI_RESIDUAL) {
    // with K4-LoRA, o's epilogue leaves gate/up's u before 1 / rms over
    // this tile's 128 inputs, sum of h * ln * A, for every row of the pass:
    // u's columns split over the cluster's blocks (lora_u_cluster), the
    // rows' inputs gathered from the blocks that made them into the ring,
    // which no block reads past this barrier (gate/up multiplies the
    // tiles' sum by the row's 1 / rms)
    if (a.ua != nullptr) {
      cluster.sync();
      lora_u_cluster(xrows, reinterpret_cast<float*>(smem), rows, split, splits,
                     a.ua + (long)tile * NB * a.ulda, a.ulda, a.uw,
                     a.uout + (long)tile * a.urows * a.uw);
    }
  }
  cluster.sync();  // the others' partials are read: they may exit
}

// ---- attention -----------------------------------------------------------------

// Cache element types: a head row is HD elements, RB bytes
template <typename T>
struct CacheElem;
template <>
struct CacheElem<int8_t> {
  static constexpr int RB = HD;
};
template <>
struct CacheElem<bf16> {
  static constexpr int RB = 2 * HD;
};

// The valid keys of one sample as one run: run index v < a_end is key v,
// the rest key v - a_end + b_start.
struct Ranges {
  int a_end, b_start, total;
  __device__ int key(int v) const { return v < a_end ? v : v - a_end + b_start; }
};

// One split's share of one (head, sample)'s cache rows: the ranges
// numbered as one run of valid keys, the split's whole 32-key tiles of it
// and their copies into a ring stage (K rows, then V rows, RBP bytes
// apart; with int8, K's and V's scales after them). A row past the
// split's end is a zero-filled copy: nothing outside the ranges is read.
template <typename T, int RBP>
struct KvSplit {
  static constexpr int RB = CacheElem<T>::RB;
  static constexpr bool INT8 = sizeof(T) == 1;
  const T *kb, *vb;
  const float *ksb, *vsb;
  long row_stride;  // elements between keys
  int heads, v0, v1, tiles;
  Ranges rg;

  __device__ KvSplit(const T* cache_k, const T* cache_v, const float* k_scale,
                     const float* v_scale, const int* len0, const int* start2, const int* end2,
                     int s_len, int heads_, int n, int head, int split, int splits)
      : heads(heads_) {
    row_stride = (long)heads * HD;
    kb = cache_k + (long)n * s_len * row_stride + (long)head * HD;
    vb = cache_v + (long)n * s_len * row_stride + (long)head * HD;
    ksb = INT8 ? k_scale + (long)n * s_len * heads + head : nullptr;
    vsb = INT8 ? v_scale + (long)n * s_len * heads + head : nullptr;
    const int len = max(0, min(len0[n], s_len)), e2 = min(end2[n], s_len);
    rg.a_end = len;
    rg.b_start = max(start2[n], len);
    rg.total = len + max(0, e2 - rg.b_start);
    const int per = ((rg.total + splits - 1) / splits + TILE - 1) / TILE * TILE;
    v0 = min(rg.total, split * per);
    v1 = min(rg.total, v0 + per);
    tiles = (v1 - v0 + TILE - 1) / TILE;
  }

  // the first tiles' rows into L2 (before the wait for the previous kernel)
  __device__ void prefetch() const {
    for (int j = threadIdx.x; j < ATT_STAGES * TILE; j += (int)blockDim.x)
      if (v0 + j < v1) {
        prefetch_l2(kb + (long)rg.key(v0 + j) * row_stride);
        prefetch_l2(vb + (long)rg.key(v0 + j) * row_stride);
      }
  }

  // tile i's rows [v0 + 32 i, + 32) into stage st: 16-byte chunks of the K
  // and V rows, 64 threads the scales
  __device__ void load(unsigned char* st, int i) const {
    constexpr int CPR = RB / 16, CHUNKS = TILE * CPR;
    const int tid = threadIdx.x;
    for (int j = tid; j < CHUNKS; j += (int)blockDim.x) {
      const int r = j / CPR, c = j % CPR, vi = v0 + TILE * i + r;
      const bool ok = vi < v1;
      const long off = ok ? (long)rg.key(vi) * row_stride : 0;
      cp_async_16(st + r * RBP + 16 * c, reinterpret_cast<const unsigned char*>(kb + off) + 16 * c, ok);
      cp_async_16(st + TILE * RBP + r * RBP + 16 * c,
                  reinterpret_cast<const unsigned char*>(vb + off) + 16 * c, ok);
    }
    if (INT8 && tid < 2 * TILE) {
      const int r = tid % TILE, vi = v0 + TILE * i + r;
      const bool ok = vi < v1;
      const long off = ok ? (long)rg.key(vi) * heads : 0;
      cp_async_4(st + 2 * TILE * RBP + (tid / TILE) * TILE * 4 + 4 * r,
                 (tid < TILE ? ksb : vsb) + off, ok);
    }
  }
};

// The fed tokens' K and V rows of one (head, sample), bf16, zero past
// t_tok, into TILE-row K and V tiles at dst (rows RBP bytes apart)
template <int RBP>
__device__ __forceinline__ void load_fed(unsigned char* dst, const bf16* k_cur, const bf16* v_cur,
                                         int n, int head, int heads, int t_tok) {
  constexpr int CPR = 2 * HD / 16;
  for (int j = threadIdx.x; j < TILE * CPR; j += (int)blockDim.x) {
    const int r = j / CPR, c = j % CPR;
    uint4 kv = make_uint4(0, 0, 0, 0), vv = kv;
    if (r < t_tok) {
      const long off = ((long)(n * t_tok + r) * heads + head) * HD;
      kv = reinterpret_cast<const uint4*>(k_cur + off)[c];
      vv = reinterpret_cast<const uint4*>(v_cur + off)[c];
    }
    *reinterpret_cast<uint4*>(dst + r * RBP + 16 * c) = kv;
    *reinterpret_cast<uint4*>(dst + TILE * RBP + r * RBP + 16 * c) = vv;
  }
}

// The cluster's merge: each block's partial at `part` ([NQ][HD] sums, [NQ]
// running maxima, [NQ] row sums); the split-0 block reads every split's
// (m, l) into ml, then each output element of the t_tok rows over the
// splits, in split order, and writes them at out (row t at out + t *
// heads * HD). With lu, it also leaves the o target's u over this head's
// inputs (spare: free dynamic shared memory, >= MQ * HD * 4 + HD *
// AS_LD * 2 bytes). Every block of the cluster calls it.
template <int NQ>
__device__ __forceinline__ void merge_splits(const float* part, float* ml, int split, int splits,
                                             int t_tok, int heads, int head, int n, bf16* out,
                                             unsigned char* spare, const LoraU& lu) {
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x;
  cluster.sync();
  if (split == 0) {
    for (int i = tid; i < splits * NQ; i += (int)blockDim.x) {
      const int r = i / NQ, qq = i % NQ;
      const float* remote = cluster.map_shared_rank(part, r);
      ml[i] = remote[NQ * HD + qq];
      ml[MAX_SPLITS * NQ + i] = remote[NQ * HD + NQ + qq];
    }
    __syncthreads();
    for (int i = tid; i < t_tok * HD; i += (int)blockDim.x) {
      const int qq = i / HD, c = i % HD;
      float got[MAX_SPLITS];
#pragma unroll
      for (int r = 0; r < MAX_SPLITS; ++r)
        if (r < splits) got[r] = cluster.map_shared_rank(part, r)[qq * HD + c];
      float mx = -INFINITY;
      for (int r = 0; r < splits; ++r) mx = fmaxf(mx, ml[r * NQ + qq]);
      float l = 0.f, o = 0.f;
#pragma unroll
      for (int r = 0; r < MAX_SPLITS; ++r) {
        if (r >= splits || ml[r * NQ + qq] == -INFINITY) continue;  // a split that saw no key
        const float f = expf(ml[r * NQ + qq] - mx);
        l += ml[MAX_SPLITS * NQ + r * NQ + qq] * f;
        o += got[r] * f;
      }
      const bf16 ob = __float2bfloat16(o / l);
      out[(long)qq * heads * HD + c] = ob;
      if (lu.a != nullptr) reinterpret_cast<float*>(spare)[i] = to_f(ob);
    }
    if (lu.a != nullptr)  // the o target's u over this head's 128 inputs
      lora_u_partial(reinterpret_cast<float*>(spare), HD, t_tok, HD,
                     lu.a + (long)head * HD * lu.lda, lu.lda, lu.w,
                     reinterpret_cast<bf16*>(spare + MQ * HD * 4),
                     lu.upart + ((long)head * lu.rows + n * t_tok) * lu.w, lu.w);
  }
  cluster.sync();  // the others' partials are read: they may exit
}

// ---- attention for one fed token, on the CUDA cores -----------------------------------

// The T = 1 form reads its split's cache rows straight into registers,
// with no ring and no barrier in its loop: a lane group of LPR lanes
// holds one key's row (16 bytes a lane, EPL elements), a warp covers 32 /
// LPR keys a step and ATT_UNROLL steps' K and V loads are in flight before
// the first is used; each lane group keeps its own online softmax, and
// the block's warps and the cluster's splits are merged once at the end.
// att_splits keeps the grid to one wave of two blocks an SM. (A ring of
// 32-key tiles with one softmax a tile behind three barriers, and 16
// warps a (head, sample) unsplit, both took longer on B's step: PERF.md.)
constexpr int ATT_UNROLL = 4;                 // key steps in flight a warp
constexpr int ATT1_WARPS = 8;                 // warps a block
constexpr int ATT1_THREADS = 32 * ATT1_WARPS;
constexpr int ATT1_PER_SM = 2;                // blocks an SM (att_splits keeps one wave)

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

// Folds cache slots [k0, k1) of this (warp, lane group) into st: slots
// k0 + warp * KPW + grp + i * ATT1_WARPS * KPW, ATT_UNROLL of them a round.
// kc / vc: the (sample, head)'s first row, row_stride elements between
// slots; ks / vs its scales (int8), heads apart. A round's K and V loads
// are all in flight before the first is used; its logits are independent
// of one another, and one online-softmax update takes them together, so
// the only chain from key to key is one max, one rescale and the sums a
// round.
template <typename T>
__device__ __forceinline__ void fold_range(AttnState<T>& st, const T* __restrict__ kc,
                                           const T* __restrict__ vc,
                                           const float* __restrict__ ks,
                                           const float* __restrict__ vs, long row_stride,
                                           int heads, int k0, int k1, float sm_scale) {
  using R = CacheRow<T>;
  constexpr int EPL = R::EPL, LPR = R::LPR, KPW = 32 / LPR, STEP = ATT1_WARPS * KPW;
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
    float logit[ATT_UNROLL];
    float m_new = st.m;
#pragma unroll
    for (int u = 0; u < ATT_UNROLL; ++u) {
      float f[EPL];
      R::to_float(kraw[u], kscale[u], f);
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < EPL; ++i) dot += st.q[i] * f[i];
#pragma unroll
      for (int o = LPR / 2; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
      logit[u] = base + u * STEP < k1 ? dot * sm_scale : -INFINITY;
      m_new = fmaxf(m_new, logit[u]);
    }
    if (m_new == -INFINITY) continue;  // no key of this lane group in the round
    const float alpha = expf(st.m - m_new);  // 0 for the group's first keys
    st.l *= alpha;
#pragma unroll
    for (int i = 0; i < EPL; ++i) st.acc[i] *= alpha;
#pragma unroll
    for (int u = 0; u < ATT_UNROLL; ++u) {
      const float p = expf(logit[u] - m_new);  // 0 past k1
      st.l += p;
      const float pb = round_bf(p);
      float f[EPL];
      R::to_float(vraw[u], vscale[u], f);
#pragma unroll
      for (int i = 0; i < EPL; ++i) st.acc[i] += pb * f[i];
    }
    st.m = m_new;
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

// K4-LoRA's spare space of the T = 1 form (merge_splits), its dynamic
// shared memory
constexpr int att1_lora_bytes() { return MQ * HD * 4 + HD * AS_LD * 2; }

// One (head, sample) over the cache ranges and the current token (T =
// 1): grid (splits, heads, b), one cluster of `splits` blocks, each
// folding its split's share of the valid keys (KvSplit's run, as the two
// slot ranges it covers); the split-0 block also takes the current token,
// its probability not rounded. The cache of this layer is [b, s_len,
// heads, HD] (T), scales [b, s_len, heads] (int8 only). q, k_cur, v_cur:
// [b, heads * HD] bf16, the current tokens; out: [b, heads * HD] bf16.
template <typename T>
__global__ void __launch_bounds__(ATT1_THREADS, ATT1_PER_SM)
    attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k_cur,
                     const bf16* __restrict__ v_cur, const T* __restrict__ cache_k,
                     const T* __restrict__ cache_v, const float* __restrict__ k_scale,
                     const float* __restrict__ v_scale, const int* __restrict__ len0,
                     const int* __restrict__ start2, const int* __restrict__ end2,
                     bf16* __restrict__ out, int s_len, int heads, int t_tok, const LoraU lu) {
  using R = CacheRow<T>;
  constexpr int EPL = R::EPL, LPR = R::LPR;
  extern __shared__ __align__(16) unsigned char smem[];  // K4-LoRA's spare (merge_splits)
  __shared__ float red_m[ATT1_WARPS], red_l[ATT1_WARPS];
  __shared__ __align__(16) float red_acc[ATT1_WARPS][HD];
  __shared__ __align__(16) float part[HD + 2];  // acc, m, l
  __shared__ float ml[2 * MAX_SPLITS];
  __shared__ float fed_logit[1];

  const int split = blockIdx.x, splits = gridDim.x, head = blockIdx.y, n = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, sub = lane % LPR;
  const float sm_scale = rsqrtf((float)HD);
  // the ranges (nothing an earlier kernel of the step writes)
  const KvSplit<T, CacheElem<T>::RB> kv(cache_k, cache_v, k_scale, v_scale, len0, start2, end2,
                                        s_len, heads, n, head, split, splits);
  kv.prefetch();
  if (lu.a != nullptr && split == 0)
    for (int c = tid; c < HD; c += ATT1_THREADS) prefetch_l2(lu.a + (long)(head * HD + c) * lu.lda);
  griddep_wait();

  const long vec = ((long)n * heads + head) * HD;
  AttnState<T> st;
  {
    const uint4 raw = *reinterpret_cast<const uint4*>(q + vec + sub * EPL);
    const uint4 raw2 = EPL == 16 ? *reinterpret_cast<const uint4*>(q + vec + sub * EPL + 8) : raw;
    const __nv_bfloat162* e = reinterpret_cast<const __nv_bfloat162*>(&raw);
    const __nv_bfloat162* e2 = reinterpret_cast<const __nv_bfloat162*>(&raw2);
#pragma unroll
    for (int i = 0; i < EPL / 2; ++i) {
      const float2 f = __bfloat1622float2(i < 4 ? e[i] : e2[i - 4]);
      st.q[2 * i] = f.x;
      st.q[2 * i + 1] = f.y;
    }
  }
#pragma unroll
  for (int i = 0; i < EPL; ++i) st.acc[i] = 0.f;
  st.m = -INFINITY;
  st.l = 0.f;
  if (split == 0 && warp == 0) {  // the current token's logit
    float dot = 0.f;
    for (int i = lane; i < HD; i += 32) dot += to_f(q[vec + i]) * to_f(k_cur[vec + i]);
    dot = warp_sum(dot);
    if (lane == 0) fed_logit[0] = dot * sm_scale;
  }

  // the split's run [v0, v1) of valid keys: slots [v0, a_end) of the
  // first range, then the second range's from b_start on
  const int a1 = min(kv.v1, kv.rg.a_end), b0 = max(kv.v0, kv.rg.a_end);
  fold_range<T>(st, kv.kb, kv.vb, kv.ksb, kv.vsb, kv.row_stride, heads, kv.v0, a1, sm_scale);
  if (b0 < kv.v1)
    fold_range<T>(st, kv.kb, kv.vb, kv.ksb, kv.vsb, kv.row_stride, heads, kv.rg.key(b0),
                  kv.rg.key(b0) + kv.v1 - b0, sm_scale);
  griddep_launch();  // the next kernel's blocks may start their prefetch

  // the warp's lane groups, then the block's warps, into the block's partial
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
  if (tid < HD) {
    float mx = split == 0 ? fed_logit[0] : -INFINITY;
    for (int w = 0; w < ATT1_WARPS; ++w) mx = fmaxf(mx, red_m[w]);
    float l = 0.f, o = 0.f;
    if (split == 0) {
      l = expf(fed_logit[0] - mx);
      o = l * to_f(v_cur[vec + tid]);
    }
    for (int w = 0; w < ATT1_WARPS; ++w) {
      if (red_m[w] == -INFINITY) continue;  // a warp that saw no key
      const float f = expf(red_m[w] - mx);
      l += red_l[w] * f;
      o += red_acc[w][tid] * f;
    }
    part[tid] = o;
    if (tid == 0) {
      part[HD] = mx;
      part[HD + 1] = l;
    }
  }
  merge_splits<1>(part, ml, split, splits, 1, heads, head, n, out + vec, smem, lu);
}

// ---- attention for 2-16 fed tokens, on the tensor cores ------------------------------

// At T > 1 the CUDA-core form above spends ~2 FMAs and a shared load a
// (query, key, feature) and is bound by them, not by the cache's bytes.
// This form takes the queries as one m16 tile (t_tok padded to 16) and
// runs S = Q K^T and P V on mma.sync.m16n8k16 (bf16 operands, fp32 sums),
// with the int8 rows dequantized to bf16 (bf16(q * scale), as
// kv_quant.dequantize_kv) on their way into the fragments. Per 32-key
// tile: warps 0-3 take S for 8 keys each over the 8 k16 steps of the head
// (Q's A fragments stay in registers), warps 4-7 meanwhile dequantize
// the V tile (int8); then the online softmax (warp w: queries w, w + 8),
// P rounded to bf16 (at T > 1 every probability is, the fed tokens'
// too); then P V, warp w for features 16w .. 16w + 15 (B fragments by
// ldmatrix.trans from the row-major V tile).
constexpr int QLD = HD + 8;          // bf16 a staged row (conflict-free ldmatrix)
constexpr int PLD = TILE + 8;        // bf16 a P row

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// bytes of a padded ring row of the mma form (E: the tile's element)
template <typename E>
__host__ __device__ constexpr int mma_row_bytes() {
  return CacheElem<E>::RB + 16;
}
template <typename T>
__host__ __device__ constexpr int mma_stage_bytes() {
  return 2 * TILE * mma_row_bytes<T>() + 2 * TILE * 4;
}
template <typename T>
constexpr int att_mma_smem_bytes() {
  return std::max(std::max(ATT_STAGES * mma_stage_bytes<T>(), 2 * TILE * mma_row_bytes<bf16>()),
                  MQ * HD * 4 + HD * AS_LD * 2);
}

// The block's state: Q's A fragments, the softmax states of queries w and
// w + 8 (warp w), the P V sums of features 16 w + 8 j + 2 t (+ 1) of
// queries g (acc[j][0..1]) and g + 8 (acc[j][2..3]).
struct MmaAttn {
  uint32_t qa[8][4];
  float m_run[2], l_run[2];
  float acc[2][4];
  float* p_s;     // [MQ][TILE] f32 logits
  bf16* pb;       // [MQ][PLD] bf16 probabilities
  float* alpha_s; // [MQ]
  bf16* vb;       // [TILE][QLD] the dequantized V tile (int8)

  // One tile: E the rows' element (the cache's, or bf16 for the fed
  // tokens, FED: key u valid for query q iff u < t_tok and u <= q; else
  // key r valid iff base + r < v1).
  template <typename E, bool FED>
  __device__ __forceinline__ void step(const unsigned char* kt, const unsigned char* vt,
                                       const float* ksc, const float* vsc, int base, int v1,
                                       int t_tok, float sm_scale) {
    constexpr int RBP = mma_row_bytes<E>();
    constexpr bool I8 = sizeof(E) == 1;
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
    if (warp < 4) {
      const int key = 8 * warp + g;
      const unsigned char* kr = kt + key * RBP;
      const float sc = I8 ? ksc[key] : 1.f;
      float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int ks = 0; ks < 8; ++ks) {
        uint32_t b[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int d = 16 * ks + 8 * h + 2 * t;
          if constexpr (I8) {
            const int w = *reinterpret_cast<const short*>(kr + d);
            const __nv_bfloat162 v = __floats2bfloat162_rn((float)(signed char)(w & 0xFF) * sc,
                                                           (float)(w >> 8) * sc);
            b[h] = *reinterpret_cast<const uint32_t*>(&v);
          } else {
            b[h] = *reinterpret_cast<const uint32_t*>(kr + 2 * d);
          }
        }
        mma_bf16(c, qa[ks][0], qa[ks][1], qa[ks][2], qa[ks][3], b[0], b[1]);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int q = g + 8 * (e / 2), r = 8 * warp + 2 * t + (e & 1);
        const bool valid = FED ? (r < t_tok && r <= q) : base + r < v1;
        p_s[q * TILE + r] = valid ? c[e] * sm_scale : -INFINITY;
      }
    } else if constexpr (I8) {  // warps 4-7: the V tile to bf16
      const int j = tid - 128, r = j / 4, c0 = 32 * (j % 4);
      const float sc = vsc[r];
      const uint4* src = reinterpret_cast<const uint4*>(vt + r * RBP + c0);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint4 raw = src[h];
        const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
        uint32_t out[8];
#pragma unroll
        for (int wd = 0; wd < 4; ++wd) {
          float f[4];
          i8x4_to_f32(words[wd], f);
          const __nv_bfloat162 lo = __floats2bfloat162_rn(f[0] * sc, f[1] * sc);
          const __nv_bfloat162 hi = __floats2bfloat162_rn(f[2] * sc, f[3] * sc);
          out[2 * wd] = *reinterpret_cast<const uint32_t*>(&lo);
          out[2 * wd + 1] = *reinterpret_cast<const uint32_t*>(&hi);
        }
        uint4* dst = reinterpret_cast<uint4*>(vb + r * QLD + c0 + 16 * h);
        dst[0] = make_uint4(out[0], out[1], out[2], out[3]);
        dst[1] = make_uint4(out[4], out[5], out[6], out[7]);
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int q = warp + 8 * i;
      const float x = p_s[q * TILE + lane];
      const float m_new = fmaxf(m_run[i], warp_max(x));
      const float alpha = m_new == -INFINITY ? 1.f : expf(m_run[i] - m_new);
      const float p = x == -INFINITY ? 0.f : expf(x - m_new);
      l_run[i] = l_run[i] * alpha + warp_sum(p);
      m_run[i] = m_new;
      pb[q * PLD + lane] = __float2bfloat16(p);
      if (lane == 0) alpha_s[q] = alpha;
    }
    __syncthreads();
    const float al0 = alpha_s[g], al1 = alpha_s[g + 8];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      acc[j][0] *= al0;
      acc[j][1] *= al0;
      acc[j][2] *= al1;
      acc[j][3] *= al1;
    }
    const unsigned char* vsrc = I8 ? reinterpret_cast<const unsigned char*>(vb) : vt;
    constexpr int VRB = I8 ? 2 * QLD : RBP;  // bytes a V row of the ldmatrix source
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      uint32_t a[4], bv[4];
      ldsm_x4(a, pb + (lane % 16) * PLD + 16 * kk + (lane / 16) * 8);
      const int key = 16 * kk + (lane % 8) + ((lane / 8) & 1) * 8;
      ldsm_x4_t(bv, vsrc + key * VRB + 2 * (16 * warp + (lane / 16) * 8));
      mma_bf16(acc[0], a[0], a[1], a[2], a[3], bv[0], bv[1]);
      mma_bf16(acc[1], a[0], a[1], a[2], a[3], bv[2], bv[3]);
    }
  }
};

// attention_kernel's function for 2 <= t_tok <= 16 (same grid, same
// arguments, same merge), the products on the tensor cores.
template <typename T>
__global__ void __launch_bounds__(ATT_THREADS)
    attention_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k_cur,
                         const bf16* __restrict__ v_cur, const T* __restrict__ cache_k,
                         const T* __restrict__ cache_v, const float* __restrict__ k_scale,
                         const float* __restrict__ v_scale, const int* __restrict__ len0,
                         const int* __restrict__ start2, const int* __restrict__ end2,
                         bf16* __restrict__ out, int s_len, int heads, int t_tok, const LoraU lu) {
  constexpr int RBP = mma_row_bytes<T>(), STAGE = mma_stage_bytes<T>();
  constexpr bool INT8 = sizeof(T) == 1;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(16) bf16 qs[MQ * QLD];
  __shared__ float p_s[MQ * TILE];
  __shared__ __align__(16) bf16 pb[MQ * PLD];
  __shared__ float alpha_s[MQ];
  __shared__ __align__(16) bf16 vb[INT8 ? TILE * QLD : 8];
  __shared__ __align__(16) float part[MQ * HD + 2 * MQ];  // acc, m, l
  __shared__ float ml[2 * MAX_SPLITS * MQ];

  const int split = blockIdx.x, splits = gridDim.x, head = blockIdx.y, n = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const float sm_scale = rsqrtf((float)HD);
  const KvSplit<T, RBP> kv(cache_k, cache_v, k_scale, v_scale, len0, start2, end2, s_len, heads,
                           n, head, split, splits);
  kv.prefetch();
  if (lu.a != nullptr && split == 0)
    for (int c = tid; c < HD; c += ATT_THREADS) prefetch_l2(lu.a + (long)(head * HD + c) * lu.lda);
  griddep_wait();

#pragma unroll
  for (int i = 0; i < ATT_STAGES - 1; ++i) {
    if (i < kv.tiles) kv.load(smem + (i % ATT_STAGES) * STAGE, i);
    cp_async_commit();
  }
  // the queries, bf16 (rows past t_tok zero), and Q's A fragments
  for (int j = tid; j < MQ * HD / 8; j += ATT_THREADS) {
    const int qq = j / (HD / 8), c = 8 * (j % (HD / 8));
    uint4 v = make_uint4(0, 0, 0, 0);
    if (qq < t_tok)
      v = *reinterpret_cast<const uint4*>(q + ((long)(n * t_tok + qq) * heads + head) * HD + c);
    *reinterpret_cast<uint4*>(qs + qq * QLD + c) = v;
  }
  __syncthreads();
  MmaAttn st;
  st.p_s = p_s;
  st.pb = pb;
  st.alpha_s = alpha_s;
  st.vb = vb;
  if (warp < 4) {
#pragma unroll
    for (int ks = 0; ks < 8; ++ks) ldsm_x4(st.qa[ks], qs + (lane % 16) * QLD + 16 * ks + (lane / 16) * 8);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    st.m_run[i] = -INFINITY;
    st.l_run[i] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) st.acc[j][e] = 0.f;

  for (int i = 0; i < kv.tiles; ++i) {
    cp_async_wait<ATT_STAGES - 2>();
    __syncthreads();  // tile i landed; every thread is done with tile i - 1
    if (i + ATT_STAGES - 1 < kv.tiles)
      kv.load(smem + ((i + ATT_STAGES - 1) % ATT_STAGES) * STAGE, i + ATT_STAGES - 1);
    cp_async_commit();
    const unsigned char* s = smem + (i % ATT_STAGES) * STAGE;
    const float* sc = reinterpret_cast<const float*>(s + 2 * TILE * RBP);
    st.template step<T, false>(s, s + TILE * RBP, INT8 ? sc : nullptr, INT8 ? sc + TILE : nullptr,
                               kv.v0 + TILE * i, kv.v1, t_tok, sm_scale);
  }
  cp_async_wait<0>();
  __syncthreads();
  griddep_launch();  // the next kernel's blocks may start their prefetch
  if (split == 0) {  // the fed tokens, bf16 rows, through the free ring
    constexpr int FRBP = mma_row_bytes<bf16>();
    load_fed<FRBP>(smem, k_cur, v_cur, n, head, heads, t_tok);
    __syncthreads();
    st.template step<bf16, true>(smem, smem + TILE * FRBP, nullptr, nullptr, 0, 0, t_tok,
                                 sm_scale);
  }

  // the block's partial straight from the fragments and the softmax warps
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int d = 16 * warp + 8 * j + 2 * t;
    *reinterpret_cast<float2*>(part + g * HD + d) = make_float2(st.acc[j][0], st.acc[j][1]);
    *reinterpret_cast<float2*>(part + (g + 8) * HD + d) = make_float2(st.acc[j][2], st.acc[j][3]);
  }
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      part[MQ * HD + warp + 8 * i] = st.m_run[i];
      part[MQ * HD + MQ + warp + 8 * i] = st.l_run[i];
    }
  }
  merge_splits<MQ>(part, ml, split, splits, t_tok, heads, head, n,
                   out + ((long)n * t_tok * heads + head) * HD, smem, lu);
}

// ---- K4-LoRA's u -----------------------------------------------------------------

// u's partial sums for one target and one pass of rows <= MT * 8:
// upart[kc][row][c] = sum over rows r of K group kc of x'[row, r] * a[r, c]
// for c < w, x' = x or, with ln, bf16(bf16(x * inv) * ln) as the GEMVs
// normalize it; a [k, lda] bf16, its first w columns. grid (LU_SPLITS,
// ceil(w / 32), groups), one cluster of LU_SPLITS blocks a (column tile, K
// group), each block 64 rows of K (LU_CHUNK): warp j takes rows j, j + 8,
// ... (8 loads of A in flight a lane), a lane one of 32 columns; the warps'
// sums added in order, the cluster's in split order by block 0. The GEMV's
// epilogue adds the groups in order, masks and rounds (um).
template <int MT>
__global__ void __launch_bounds__(LU_THREADS)
    lora_u_kernel(const bf16* __restrict__ x, int rows, int k, const bf16* __restrict__ ln,
                  const float* __restrict__ ssq, int ssq_tiles, float eps,
                  const bf16* __restrict__ a, int lda, int w, float* __restrict__ upart) {
  constexpr int R = MT * 8;
  __shared__ float xs[R][LU_CHUNK];
  __shared__ float red[LU_THREADS / 32][R][LU_COLS];
  __shared__ float inv_s[R];
  const int split = blockIdx.x, splits = gridDim.x, kc = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int c = blockIdx.y * LU_COLS + lane;
  const int k0 = (kc * splits + split) * LU_CHUNK, nk = max(0, min(LU_CHUNK, k - k0));
  // this block's rows of A into L2 while the previous kernel drains
  if (c < w)
    for (int kk = warp; kk < nk; kk += LU_THREADS / 32) prefetch_l2(a + (long)(k0 + kk) * lda + c);
  griddep_wait();
  griddep_launch();
  if (ln != nullptr) row_inv_rms(x, rows, k, ssq, ssq_tiles, eps, inv_s);
  for (int i = tid; i < R * LU_CHUNK; i += LU_THREADS) {
    const int r = i / LU_CHUNK, kk = i % LU_CHUNK;
    float v = 0.f;
    if (r < rows && kk < nk) {
      v = to_f(x[(long)r * k + k0 + kk]);
      if (ln != nullptr) v = round_bf(round_bf(v * inv_s[r]) * to_f(ln[k0 + kk]));
    }
    xs[r][kk] = v;
  }
  __syncthreads();
  float acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = 0.f;
  if (c < w) {
    float av[LU_CHUNK / 8];
#pragma unroll
    for (int i = 0; i < LU_CHUNK / 8; ++i) {
      const int kk = warp + 8 * i;
      av[i] = kk < nk ? to_f(a[(long)(k0 + kk) * lda + c]) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < LU_CHUNK / 8; ++i)
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = fmaf(xs[r][warp + 8 * i], av[i], acc[r]);
  }
#pragma unroll
  for (int r = 0; r < R; ++r) red[warp][r][lane] = acc[r];
  __syncthreads();
  float* part = &xs[0][0];  // [R][LU_COLS]: this block's sums
  for (int i = tid; i < R * LU_COLS; i += LU_THREADS) {
    const int r = i / LU_COLS, l = i % LU_COLS;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < LU_THREADS / 32; ++j) sum += red[j][r][l];
    part[i] = sum;
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  if (split == 0) {
    for (int i = tid; i < rows * LU_COLS; i += LU_THREADS) {
      const int r = i / LU_COLS, l = i % LU_COLS, col = blockIdx.y * LU_COLS + l;
      float got[MAX_SPLITS];
#pragma unroll
      for (int sp = 0; sp < MAX_SPLITS; ++sp)
        if (sp < splits) got[sp] = cluster.map_shared_rank(part, sp)[i];
      float u = 0.f;
#pragma unroll
      for (int sp = 0; sp < MAX_SPLITS; ++sp)
        if (sp < splits) u += got[sp];
      if (col < w) upart[((long)kc * rows + r) * w + col] = u;
    }
  }
  cluster.sync();
}

// ---- host --------------------------------------------------------------------------

size_t align256(size_t x) { return (x + 255) / 256 * 256; }

int sm_count() {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

// The blocks that share one tile's K in a GEMV (ops/fused_decode.py:
// gemv_splits): a power of two up to MAX_SPLITS, doubled while the grid
// holds fewer than two blocks an SM, as long as each split keeps a
// 64-row stage.
int gemv_splits(int k, int tiles, int sms) {
  const int stages = (k + SROWS - 1) / SROWS;
  int s = 1;
  while (s < MAX_SPLITS && 2 * s <= stages && tiles * s < 2 * sms) s *= 2;
  return s;
}

// The blocks that share one (head, sample)'s keys (ops/fused_decode.py:
// att_splits): a power of two up to MAX_SPLITS, doubled while each split
// keeps 256 of the cache's S slots and the grid, at T = 1, stays within
// one wave (ATT1_PER_SM blocks an SM) or, at T > 1, holds fewer than one
// block an SM.
int att_splits(int b, int heads, int s_len, int t_tok, int sms) {
  int s = 1;
  while (s < MAX_SPLITS && s_len >= 2 * 256 * s &&
         (t_tok == 1 ? 2 * b * heads * s <= ATT1_PER_SM * sms : b * heads * s < sms))
    s *= 2;
  return s;
}

// The clusters of one step (ops/fused_decode.py: step_plan, held to it
// by tp_fused_decode_plan): the four GEMVs' splits and the attention's
struct Plan {
  int qkv, o, gu, down, att;
  Plan(int b, int t_tok, int d, int f, int heads, int s_len, int sms)
      : qkv(gemv_splits(d, 3 * d / NB, sms)),
        o(gemv_splits(d, d / NB, sms)),
        gu(gemv_splits(d, (f + 63) / 64, sms)),
        down(gemv_splits(f, d / NB, sms)),
        att(att_splits(b, heads, s_len, t_tok, sms)) {}
};

// lora_u's K groups: LU_SPLITS x LU_CHUNK rows each
int lora_groups(int k) { return (k + LU_SPLITS * LU_CHUNK - 1) / (LU_SPLITS * LU_CHUNK); }

// The workspace of one step: q, the attention output (both [rows, d]
// bf16), the MLP activation [rows, f] bf16, the residual epilogues' sums
// of squares [rows][d / 128] f32 and K4-LoRA's u partial sums (f32): of
// qkv from lora_u, [groups][pass rows][width], of o from the attention,
// [heads][rows][width], of down from the gate/up epilogue, [gate/up
// tiles][rows][width], of gate/up from o's residual epilogue, [d /
// 128][rows][width].
struct Workspace {
  size_t q, attn, xm, ssq, um, uo, ud, un, bytes;
  Workspace(int rows, int d, int f, int wd, int wf) {
    q = 0;
    attn = q + align256((size_t)rows * d * sizeof(bf16));
    xm = attn + align256((size_t)rows * d * sizeof(bf16));
    ssq = xm + align256((size_t)rows * f * sizeof(bf16));
    um = ssq + align256((size_t)rows * (d / HD) * sizeof(float));
    uo = um + align256((size_t)lora_groups(d) * std::min(rows, MAX_MT * 8) * std::max(wd, 1) *
                       sizeof(float));
    ud = uo + align256((size_t)(d / HD) * rows * std::max(wd, 1) * sizeof(float));
    un = ud + align256((size_t)((f + 63) / 64) * rows * std::max(wf, 1) * sizeof(float));
    bytes = un + align256((size_t)(d / HD) * rows * std::max(wd, 1) * sizeof(float));
  }
};

// a launch with the cluster attribute and programmatic stream
// serialization
template <typename... KArgs, typename... Args>
int launch_ex(void (*kernel)(KArgs...), dim3 grid, dim3 block, int smem, int cluster,
              cudaStream_t st, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// the dynamic shared memory a kernel takes above 48 KB, set once a device
// (a static for each kernel, not for each kernel type)
template <auto kernel>
int allow_smem(int bytes) {
  static int set_for = -1;  // the device it was set for
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (set_for == dev) return 0;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  set_for = dev;
  return 0;
}

template <int MT, int EPI>
int launch_gemv_mt(const GemvArgs& a, int tiles, int splits, cudaStream_t st) {
  auto* kernel = gemv_kernel<MT, EPI>;
  int rc = allow_smem<gemv_kernel<MT, EPI>>(gemv_smem_bytes<MT>());
  if (rc) return rc;
  // with K4-LoRA: B's rows of the widest split's share, um, gate/up's A chunk
  const int bytes = gemv_ring_bytes<MT>() +
                    (a.upart != nullptr ? lora_b_rows(a.lw, splits) * NB * 2 +
                                              ums_bytes(a.rows, splits) +
                                              (EPI == EPI_GATEUP && a.ua != nullptr ? AS_BYTES : 0)
                                        : 0);
  return launch_ex(kernel, dim3(splits, tiles), dim3(GEMV_THREADS), bytes, splits, st, a);
}

template <int EPI>
int launch_gemv(const GemvArgs& a, int tiles, int splits, cudaStream_t st) {
  switch ((a.rows + 7) / 8) {
    case 1: return launch_gemv_mt<1, EPI>(a, tiles, splits, st);
    case 2: return launch_gemv_mt<2, EPI>(a, tiles, splits, st);
    case 3: return launch_gemv_mt<3, EPI>(a, tiles, splits, st);
    default: return launch_gemv_mt<4, EPI>(a, tiles, splits, st);
  }
}

// t_tok = 1 on the CUDA cores (attention_kernel), 2-16 on the tensor cores
template <typename T>
int launch_attention(dim3 grid, int splits, cudaStream_t st, const bf16* q, const bf16* kn,
                     const bf16* vn, const void* ck, const void* cv, const float* ks,
                     const float* vs, const int* len0, const int* start2, const int* end2,
                     bf16* out, int s_len, int heads, int t_tok, const LoraU& lu) {
  auto* kernel = t_tok == 1 ? attention_kernel<T> : attention_mma_kernel<T>;
  const int bytes = t_tok > 1 ? att_mma_smem_bytes<T>() : lu.a != nullptr ? att1_lora_bytes() : 0;
  if (t_tok > 1) {
    const int rc = allow_smem<attention_mma_kernel<T>>(bytes);
    if (rc) return rc;
  }
  return launch_ex(kernel, grid, dim3(t_tok == 1 ? ATT1_THREADS : ATT_THREADS), bytes, splits, st,
                   q, kn, vn,
                   static_cast<const T*>(ck), static_cast<const T*>(cv), ks, vs, len0, start2,
                   end2, out, s_len, heads, t_tok, lu);
}

// u's partial sums of one target for one pass (rows <= 32)
int lora_u(const bf16* x, int rows, int k, const bf16* ln, const float* ssq, int ssq_tiles,
           float eps, const bf16* a, int lda, int w, float* upart, cudaStream_t st) {
  const dim3 grid(LU_SPLITS, (w + LU_COLS - 1) / LU_COLS, lora_groups(k));
  switch ((rows + 7) / 8) {
#define TP_LU(N)                                                                            \
  case N:                                                                                   \
    return launch_ex(lora_u_kernel<N>, grid, dim3(LU_THREADS), 0, LU_SPLITS, st, x,            \
                     rows, k, ln, ssq, ssq_tiles, eps, a, lda, w, upart);
    TP_LU(1)
    TP_LU(2)
    TP_LU(3)
    default: TP_LU(4)
#undef TP_LU
  }
  return -1;
}

__global__ void pdl_probe_kernel(int* out) {
  griddep_wait();
  griddep_launch();
  if (out != nullptr) *out = 1;
}

}  // namespace

// Bytes of the workspace tp_fused_decode needs for this shape; wd, wf: the
// widest d-input and the f-input adapter target (0 without slot LoRA).
extern "C" long long tp_fused_decode_workspace(int b, int d, int f, int wd, int wf) {
  return (long long)Workspace(b, d, f, wd, wf).bytes;
}

// The splits tp_fused_decode launches for this step on a card of `sms`
// SMs (0: the current device's), into out[5]: qkv, o, gate/up and down
// GEMVs, attention.
extern "C" int tp_fused_decode_plan(int b, int t_tok, int d, int f, int heads, int s_len,
                                    int sms, void* out) {
  const Plan p(b, t_tok, d, f, heads, s_len, sms > 0 ? sms : sm_count());
  int* o = static_cast<int*>(out);
  o[0] = p.qkv;
  o[1] = p.o;
  o[2] = p.gu;
  o[3] = p.down;
  o[4] = p.att;
  return 0;
}

// One launch of a one-block kernel with the attributes K4's launches carry
// (a cluster of 1 and programmatic stream serialization): 0 where the
// CUDA runtime takes them, else its cudaError_t code.
extern "C" int tp_fused_decode_pdl_probe(void* stream) {
  return launch_ex(pdl_probe_kernel, dim3(1), dim3(32), 0, 1, static_cast<cudaStream_t>(stream),
                   static_cast<int*>(nullptr));
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
      t_tok < 1 || t_tok > MAX_TOK || s_len < 1 || layers < 1 ||
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
  bf16* qbuf = reinterpret_cast<bf16*>(wk + ws.q);
  bf16* attn = reinterpret_cast<bf16*>(wk + ws.attn);
  bf16* xm = reinterpret_cast<bf16*>(wk + ws.xm);
  float* ssq = reinterpret_cast<float*>(wk + ws.ssq);
  float* um = reinterpret_cast<float*>(wk + ws.um);
  float* uo = reinterpret_cast<float*>(wk + ws.uo);
  float* ud = reinterpret_cast<float*>(wk + ws.ud);
  float* un = reinterpret_cast<float*>(wk + ws.un);
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
  const int tl_qkv = 3 * d / NB, tl_d = d / NB, tl_gu = (f + 63) / 64;
  const Plan plan(b, t_tok, d, f, heads, s_len, sm_count());
  const int tiles_d = d / HD;
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
    // the normed GEMVs' sums of squares: the previous residual epilogue's
    // (none before the first layer's qkv: it sums h itself)
    const float* ssq_in = l == 0 ? nullptr : ssq;

    // K4-LoRA's operands of one product: the target's A (for a lora_u
    // launch), its width, mask column and B; where its u partial sums come
    // from (upart: made upstream, [uparts][rows][lw], times the row's 1 /
    // rms with inv; nullptr: a lora_u launch a pass); the next target whose
    // u this product's epilogue leaves in `uout` (ua: its A, lda columns,
    // uw wide; uln: its RMSNorm weights, o's residual epilogue only)
    struct Lora {
      const bf16* a;
      int lda, lw, mcol;
      const bf16* b;
      const float* upart;
      int uparts, inv;
      const bf16 *ua, *uln;
      int ulda, uw;
      float* uout;
    };
    // one product over every pass of 32 rows: K4-LoRA's u first (qkv),
    // then the GEMV with its epilogue
    auto product = [&](int epi, const bf16* x, int k, const bf16* ln, const float* ssq_p,
                       const int8_t* wq, int ldw, const float* scale, int tiles, int splits,
                       bf16* out, const Lora& lo) {
      for (int r0 = 0; r0 < rows; r0 += MAX_MT * 8) {
        const int pr = std::min(MAX_MT * 8, rows - r0);
        GemvArgs a = {};
        a.x = x + (size_t)r0 * k;
        a.rows = pr;
        a.k = k;
        a.ln = ln;
        a.ssq = ssq_p ? ssq_p + (size_t)r0 * tiles_d : nullptr;
        a.ssq_tiles = tiles_d;
        a.eps = eps;
        a.w = wq;
        a.ldw = ldw;
        a.f = f;
        a.scale = scale;
        if (lora) {
          if (lo.upart != nullptr) {
            a.upart = lo.upart + (size_t)r0 * lo.lw;
            a.uparts = lo.uparts;
            a.ucs = (long)rows * lo.lw;
            a.u_inv = lo.inv;
          } else {
            int rc2 = lora_u(a.x, pr, k, ln, a.ssq, tiles_d, eps, lo.a, lo.lda, lo.lw, um, st);
            if (rc2) return rc2;
            a.upart = um;
            a.uparts = lora_groups(k);
            a.ucs = (long)pr * lo.lw;
          }
          a.selm = p_selm + (size_t)r0 * lwm + lo.mcol;
          a.ldm = lwm;
          a.lb = lo.b;
          a.lw = lo.lw;
          if (lo.ua != nullptr) {
            a.ua = lo.ua;
            a.uln = lo.uln;
            a.ulda = lo.ulda;
            a.uw = lo.uw;
            a.urows = rows;
            a.uout = lo.uout + (size_t)r0 * lo.uw;
          }
        }
        a.row0 = r0;
        a.t_tok = t_tok;
        a.heads = heads;
        a.s_len = s_len;
        a.kv_int8 = kv_int8;
        a.theta = theta;
        a.positions = p_pos + r0;
        a.write_pos = p_wpos;
        if (epi == EPI_QKV) {
          a.out = out + (size_t)r0 * d;
          a.k_new = kn + (size_t)r0 * d;
          a.v_new = vn + (size_t)r0 * d;
          a.cache_k = ck;
          a.cache_v = cv;
          a.k_scale = ks;
          a.v_scale = vs;
          rc = launch_gemv<EPI_QKV>(a, tiles, splits, st);
        } else if (epi == EPI_RESIDUAL) {
          a.out = out + (size_t)r0 * ldw;
          a.ssq_out = ssq + (size_t)r0 * tiles_d;
          rc = launch_gemv<EPI_RESIDUAL>(a, tiles, splits, st);
        } else {
          a.out = out + (size_t)r0 * f;
          rc = launch_gemv<EPI_GATEUP>(a, tiles, splits, st);
        }
        if (rc) return rc;
      }
      return 0;
    };

    // qkv: u by a lora_u launch
    const Lora lora_q = {la, lwa, lwq, 0, lbq, nullptr, 0, 0, nullptr, nullptr, 0, 0, nullptr};
    if ((rc = product(EPI_QKV, hb, d, ln1, ssq_in, qkv, 3 * d, qkv_s, tl_qkv, plan.qkv, qbuf, lora_q)))
      return rc;
    const dim3 att_grid(plan.att, heads, b);
    LoraU lu = {};  // the o target's u partial sums, made by the attention
    if (lora) lu = {la + lwq, lwa, lwo, rows, uo};
    rc = kv_int8 ? launch_attention<int8_t>(att_grid, plan.att, st, qbuf, kn, vn, ck, cv, ks, vs,
                                            p_len0, p_start2, p_end2, attn, s_len, heads, t_tok,
                                            lu)
                 : launch_attention<bf16>(att_grid, plan.att, st, qbuf, kn, vn, ck, cv, nullptr,
                                          nullptr, p_len0, p_start2, p_end2, attn, s_len, heads,
                                          t_tok, lu);
    if (rc) return rc;
    // o: u from the attention; its epilogue leaves gate/up's
    const Lora lora_o = {nullptr, lwa, lwo, lwq, lbo, uo, heads, 0,
                         la ? la + lwq + lwo : nullptr, ln2, lwa, lwg, un};
    if ((rc = product(EPI_RESIDUAL, attn, d, nullptr, nullptr, wo, d, wo_s, tl_d, plan.o, hb, lora_o)))
      return rc;
    // gate/up: u from o's epilogue; its epilogue leaves down's
    const Lora lora_g = {nullptr, lwa, lwg, lwq + lwo, lbg, un, tiles_d, 1,
                         laf, nullptr, lwd, lwd, ud};
    if ((rc = product(EPI_GATEUP, hb, d, ln2, ssq, gu, 2 * f, gu_s, tl_gu, plan.gu, xm, lora_g)))
      return rc;
    // down: u from gate/up's epilogue
    const Lora lora_d = {nullptr, lwd, lwd, lwa, lbd, ud, tl_gu, 0,
                         nullptr, nullptr, 0, 0, nullptr};
    if ((rc = product(EPI_RESIDUAL, xm, f, nullptr, nullptr, down, d, down_s, tl_d, plan.down, hb,
                      lora_d)))
      return rc;
  }
  return 0;
}
