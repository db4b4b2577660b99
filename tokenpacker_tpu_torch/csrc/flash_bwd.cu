// K2 (backward): dq, dk and dv of the prefill / training flash attention,
// with GQA, from the log-sum-exp the forward (flash_fwd.cu) saved, on
// Hopper's tensor-core path (wgmma) with TMA tile loads.
//
// Replaces tokenpacker_tpu/ops/flash_attention.py:_flash_bwd_pallas (its
// dq pass _dq_kernel and its dk/dv pass _dkv_kernel) in the no-bias and
// the key-only bias forms, and the head repeat and group sum that
// mha_flash's GQA costs there.
//
// With P = exp(q k^T * scale + bias[key] - lse), dP = dO v^T and delta =
// rowsum(dO o):
//   dS = P (dP - delta),  dq = dS k * scale,  dk = dS^T q * scale,  dv = P^T dO.
//
// What bounds it on the H100: at the training shape [8, 2048, 32, 128],
// causal, the five products the math needs are ~0.69 TFLOP against ~1.07
// GB of q, k, v, o, dO, dq, dk, dv and lse: the tensor cores (0.70 ms at
// the dense bf16 rate, 0.32 ms of bytes). The design runs seven products,
// S and dP twice, so that no float atomics are needed and two calls give
// the same bits:
//   - a delta pass, one warp per (token, head) row of o and dO;
//   - the dk/dv kernel: a block (one warpgroup, two blocks an SM) owns 64
//     keys of one (sample, kv head), holds their K and V in shared memory
//     and walks the G = H / Hkv query heads of its group and, for each, the
//     query tiles of 64 from the diagonal on. Q and dO stream through a
//     ring of 2 stages by TMA (128-byte swizzle, zero-filled past the end;
//     the next tile's copy is issued by one thread as the current one is
//     computed), lse and delta through two slots the threads fill one item
//     ahead (loaded before the products, stored after them). S^T = K Q^T and dP^T = V dO^T are wgmma m64n64k16 from shared
//     memory into fp32 registers; P^T and dS^T are formed in the registers
//     and rounded to bf16 as A operands (RS form) of dV += P^T dO and
//     dK += dS^T Q (m64n128k16, dO and Q MN-major). dK and dV accumulate in
//     fp32 registers across the whole walk, so summing the group inside
//     the block makes GQA exact without a repeat of K/V in memory;
//   - the dq kernel: a block (one warpgroup) owns 64 queries of one
//     (sample, head) with their Q and dO in shared memory, streams K and V
//     tiles of 64 keys up to the causal diagonal through the same kind of
//     ring, recomputes S = Q K^T and dP = dO V^T, forms dS in registers and
//     accumulates dQ += dS K (K MN-major) in fp32 registers.
// Registers (ptxas, sm_90a): dk/dv 234 (238 with the bias), dq 160 (157),
// no spills; two one-warpgroup blocks of ~98 KB shared memory an SM.
// No fp32 tile goes to shared memory; each block writes only its own rows,
// in a fixed order, so two calls give the same bits. Causality is aligned
// bottom-right (key j visible to query i iff j <= i + Tk - Tq) and only the
// tiles that straddle the diagonal or the sequence end pay for the mask;
// rows with lse = +inf (no visible key) get P = 0 and zero gradients.
//
// The key-only bias form (_flash_bwd_pallas with `bias`, asserted key-only
// at flash_attention.py:382; MPT's ALiBi) takes the forward's [h, tk] fp32
// bias and adds it (in log2 units) at the two recomputes of P: per column
// in the dq kernel (each key tile's values through two slots, like lse in
// the dk/dv kernel), per row in the dk/dv kernel (S^T's rows are keys,
// read once a query head). The bias is a constant: it has no gradient.

#include "flash_sm90.cuh"

namespace {

using namespace sm90;

constexpr int BT = 64;                    // rows of every tile (keys or queries)
constexpr int THREADS = 128;              // one warpgroup
constexpr int TILE_BYTES = 2 * BT * ROW_BYTES;  // two 64-column boxes: 16 KB
constexpr int BOX_BYTES = BT * ROW_BYTES;
// dk/dv: K, V, then 2 stages of (Q, dO); dq: Q, dO, then 2 stages of (K, V)
constexpr size_t SMEM_BYTES = 1024 + 6 * TILE_BYTES + 4 * BT * 4 + 8 * 3;

// delta[(b*h + head) * tq + i] = sum_c o[b, i, head, c] * dO[b, i, head, c]
// in fp32; one warp per row, rows in memory order.
__global__ void __launch_bounds__(THREADS)
    flash_bwd_delta_kernel(const bf16* __restrict__ o, const bf16* __restrict__ dout,
                           float* __restrict__ delta, long rows, int tq, int h) {
  const long row = (long)blockIdx.x * (THREADS / 32) + threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x % 32;
  float acc = 0.f;
#pragma unroll
  for (int j = 0; j < HEAD_DIM / 32; ++j) {
    const long at = row * HEAD_DIM + lane * (HEAD_DIM / 32) + j;
    acc += __bfloat162float(o[at]) * __bfloat162float(dout[at]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const int head = (int)(row % h);
    const long bi = row / h;
    const int i = (int)(bi % tq);
    const long b = bi / tq;
    delta[(b * h + head) * tq + i] = acc;
  }
}

// S (or S^T) and dP (or dP^T) of one pair of 64-row tiles: A rows from
// `a_tile` / `da_tile`, B rows from `b_tile` / `db_tile`, all K-major over
// the head dim.
__device__ __forceinline__ void two_products(float (&s)[32], float (&dp)[32], uint32_t a_tile,
                                             uint32_t b_tile, uint32_t da_tile,
                                             uint32_t db_tile) {
  wgmma_fence();  // the first slice of each product overwrites its accumulator
#pragma unroll
  for (int kk = 0; kk < HEAD_DIM / 16; ++kk)
    wgmma_n64_ss(s, desc_kmajor(a_tile, kk, BOX_BYTES), desc_kmajor(b_tile, kk, BOX_BYTES),
                 kk > 0);
#pragma unroll
  for (int kk = 0; kk < HEAD_DIM / 16; ++kk)
    wgmma_n64_ss(dp, desc_kmajor(da_tile, kk, BOX_BYTES), desc_kmajor(db_tile, kk, BOX_BYTES),
                 kk > 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(s);
  fence_regs(dp);
}

// Loads the two 64-column boxes of one 64-row tile.
__device__ __forceinline__ void load_tile(unsigned char* dst, const CUtensorMap* map, int head,
                                          int row0, int b, uint64_t* bar) {
  tma_load_4d(dst, map, 0, head, row0, b, bar);
  tma_load_4d(dst + BOX_BYTES, map, 64, head, row0, b, bar);
}

template <bool BIAS>
__global__ void __launch_bounds__(THREADS, 2)
    flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap q_map,
                         const __grid_constant__ CUtensorMap k_map,
                         const __grid_constant__ CUtensorMap v_map,
                         const __grid_constant__ CUtensorMap do_map,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         const float* __restrict__ bias, bf16* __restrict__ dk,
                         bf16* __restrict__ dv, int tq, int tk, int h, int hkv, int causal) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  unsigned char* ks = smem;
  unsigned char* vs = ks + TILE_BYTES;
  unsigned char* ring = vs + TILE_BYTES;  // stage s: Q at 2s tiles, dO after it
  float* lse_slot = reinterpret_cast<float*>(ring + 4 * TILE_BYTES);  // [2][BT], log2 units
  float* delta_slot = lse_slot + 2 * BT;                               // [2][BT]
  uint64_t* bar_kv = reinterpret_cast<uint64_t*>(delta_slot + 2 * BT);
  uint64_t* full = bar_kv + 1;

  const int k0 = blockIdx.x * BT;  // the first key tiles see the most queries
  const int bkv = blockIdx.y;
  const int b = bkv / hkv, kv_head = bkv % hkv;
  const int group = h / hkv;
  const int shift = tk - tq;
  // query tiles before the first one that can see key k0 are skipped
  const int qt0 = causal ? max(0, k0 - shift) / BT : 0;
  const int num_qt = (tq + BT - 1) / BT;
  const int per_head = max(0, num_qt - qt0);
  const int items = group * per_head;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  // item i: query head kv_head * group + i / per_head, query tile qt0 + i % per_head.
  // Its lse (log2 units) and delta go to the slots: query tid of the tile's
  // lse from threads below BT, query tid - BT's delta from the others.
  auto row_value = [&](int i) {
    const int head = kv_head * group + i / per_head;
    const int q = (qt0 + i % per_head) * BT + tid % BT;
    const long at = ((long)b * h + head) * tq + q;
    if (q >= tq) return tid < BT ? INFINITY : 0.f;
    return tid < BT ? lse[at] * LOG2E : delta[at];
  };
  float* row_slot = tid < BT ? lse_slot + tid : delta_slot + tid - BT;  // slot 0's entry

  if (tid == 0) {
    mbar_init(bar_kv, 1);
    mbar_init(&full[0], 1);
    mbar_init(&full[1], 1);
    fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar_kv, 2 * TILE_BYTES);
    load_tile(ks, &k_map, kv_head, k0, b, bar_kv);
    load_tile(vs, &v_map, kv_head, k0, b, bar_kv);
    if (items > 0) {
      mbar_expect_tx(&full[0], 2 * TILE_BYTES);
      load_tile(ring, &q_map, kv_head * group, qt0 * BT, b, &full[0]);
      load_tile(ring + TILE_BYTES, &do_map, kv_head * group, qt0 * BT, b, &full[0]);
    }
  }
  if (items > 0) row_slot[0] = row_value(0);

  const int ra = warp * 16 + lane / 4;  // this thread's key rows ra, ra + 8
  const int c2 = 2 * (lane % 4);
  const float sl2 = rsqrtf((float)HEAD_DIM) * LOG2E;
  float dk_acc[64], dv_acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  const uint32_t k_tile = smem_u32(ks), v_tile = smem_u32(vs);
  float kb[2] = {0.f, 0.f};  // the key bias of rows ra, ra + 8 (log2 units; 0 past tk)
  int kb_head = -1;
  mbar_wait(bar_kv, 0);

  for (int i = 0; i < items; ++i) {
    const int s = i & 1;
    const int head = kv_head * group + i / per_head;
    const int q0 = (qt0 + i % per_head) * BT;
    __syncthreads();  // item i-1 is done: its stage and slot are free
    const bool more = i + 1 < items;
    if (more && tid == 0) {
      const int nhead = kv_head * group + (i + 1) / per_head;
      const int nq0 = (qt0 + (i + 1) % per_head) * BT;
      unsigned char* st = ring + (s ^ 1) * 2 * TILE_BYTES;
      mbar_expect_tx(&full[s ^ 1], 2 * TILE_BYTES);
      load_tile(st, &q_map, nhead, nq0, b, &full[s ^ 1]);
      load_tile(st + TILE_BYTES, &do_map, nhead, nq0, b, &full[s ^ 1]);
    }
    // the next item's lse or delta, loaded now and stored after the
    // products, so that its latency hides behind them
    const float next_row = more ? row_value(i + 1) : 0.f;
    if (BIAS && head != kb_head) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int key = k0 + ra + 8 * r;
        kb[r] = key < tk ? bias[(long)head * tk + key] * LOG2E : 0.f;
      }
      kb_head = head;
    }
    const uint32_t q_tile = smem_u32(ring + s * 2 * TILE_BYTES), do_tile = q_tile + TILE_BYTES;
    mbar_wait(&full[s], (i >> 1) & 1);

    float sacc[32], dpacc[32];
    two_products(sacc, dpacc, k_tile, q_tile, v_tile, do_tile);  // S^T, dP^T

    // P^T and dS^T: rows are keys k0 + ra (+8), columns queries q0 + col
    const bool edge = causal && q0 + shift < k0 + BT - 1;
    const float* ls = lse_slot + s * BT;
    const float* ds = delta_slot + s * BT;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int col = 8 * jj + c2;
      const float2 l2 = *reinterpret_cast<const float2*>(ls + col);
      const float2 d2 = *reinterpret_cast<const float2*>(ds + col);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float lv = (e & 1) ? l2.y : l2.x;
        const float dl = (e & 1) ? d2.y : d2.x;
        float p = ex2(fmaf(sacc[4 * jj + e], sl2, kb[r]) - lv);
        if (edge && k0 + ra + 8 * r > q0 + col + (e & 1) + shift) p = 0.f;
        sacc[4 * jj + e] = p;
        dpacc[4 * jj + e] = p * (dpacc[4 * jj + e] - dl);
      }
    }
    uint32_t pa[16], dsa[16];
    to_a_fragments(sacc, pa);
    to_a_fragments(dpacc, dsa);

    // dV += P^T dO, dK += dS^T Q
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BT / 16; ++kk)
      wgmma_n128_rs(dv_acc, pa + 4 * kk, desc_mnmajor(do_tile, kk, BOX_BYTES));
#pragma unroll
    for (int kk = 0; kk < BT / 16; ++kk)
      wgmma_n128_rs(dk_acc, dsa + 4 * kk, desc_mnmajor(q_tile, kk, BOX_BYTES));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dk_acc);
    fence_regs(dv_acc);
    fence_regs(pa);
    fence_regs(dsa);
    if (more) row_slot[(s ^ 1) * BT] = next_row;
  }

  const long kv_stride = (long)hkv * HEAD_DIM;
  const long kv_off = (long)b * tk * kv_stride + (long)kv_head * HEAD_DIM;
  const float scale = rsqrtf((float)HEAD_DIM);
  const float dk_mul[2] = {scale, scale}, dv_mul[2] = {1.f, 1.f};
  store_rows(dk_acc, dk + kv_off, kv_stride, k0 + ra, tk, dk_mul);
  store_rows(dv_acc, dv + kv_off, kv_stride, k0 + ra, tk, dv_mul);
}

template <bool BIAS>
__global__ void __launch_bounds__(THREADS, 2)
    flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap q_map,
                        const __grid_constant__ CUtensorMap k_map,
                        const __grid_constant__ CUtensorMap v_map,
                        const __grid_constant__ CUtensorMap do_map,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        const float* __restrict__ bias, bf16* __restrict__ dq, int tq, int tk,
                        int h, int hkv, int causal) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  unsigned char* qs = smem;
  unsigned char* dos = qs + TILE_BYTES;
  unsigned char* ring = dos + TILE_BYTES;  // stage s: K at 2s tiles, V after it
  float* bias_slot = reinterpret_cast<float*>(ring + 4 * TILE_BYTES);  // [2][BT], log2 units
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(bias_slot + 4 * BT);
  uint64_t* full = bar_q + 1;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BT;  // heaviest tiles first
  const int bh = blockIdx.y;
  const int b = bh / h, head = bh % h;
  const int kv_head = head / (h / hkv);
  const int shift = tk - tq;
  int kend = tk;
  if (causal) kend = min(tk, q0 + BT + shift);
  const int num_kt = kend > 0 ? (kend + BT - 1) / BT : 0;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // the key bias of tile j's key tid in log2 units (0 past tk), for slot j % 2
  auto key_bias = [&](int j) {
    const int key = j * BT + tid;
    return key < tk ? bias[(long)head * tk + key] * LOG2E : 0.f;
  };

  if (tid == 0) {
    mbar_init(bar_q, 1);
    mbar_init(&full[0], 1);
    mbar_init(&full[1], 1);
    fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar_q, 2 * TILE_BYTES);
    load_tile(qs, &q_map, head, q0, b, bar_q);
    load_tile(dos, &do_map, head, q0, b, bar_q);
    if (num_kt > 0) {
      mbar_expect_tx(&full[0], 2 * TILE_BYTES);
      load_tile(ring, &k_map, kv_head, 0, b, &full[0]);
      load_tile(ring + TILE_BYTES, &v_map, kv_head, 0, b, &full[0]);
    }
  }

  if (BIAS && tid < BT && num_kt > 0) bias_slot[tid] = key_bias(0);
  const int qa = q0 + warp * 16 + lane / 4;  // this thread's query rows qa, qa + 8
  const int c2 = 2 * (lane % 4);
  const float sl2 = rsqrtf((float)HEAD_DIM) * LOG2E;
  float lr[2], dl[2];  // lse (log2 units) and delta of the two rows
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int q = qa + 8 * r;
    lr[r] = q < tq ? lse[(long)bh * tq + q] * LOG2E : INFINITY;
    dl[r] = q < tq ? delta[(long)bh * tq + q] : 0.f;
  }
  float dq_acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) dq_acc[i] = 0.f;
  const uint32_t q_tile = smem_u32(qs), do_tile = smem_u32(dos);
  mbar_wait(bar_q, 0);

  for (int j = 0; j < num_kt; ++j) {
    const int s = j & 1, k0 = j * BT;
    __syncthreads();  // tile j-1 is done: its stage and slot are free
    const bool more = j + 1 < num_kt;
    if (more && tid == 0) {
      unsigned char* st = ring + (s ^ 1) * 2 * TILE_BYTES;
      mbar_expect_tx(&full[s ^ 1], 2 * TILE_BYTES);
      load_tile(st, &k_map, kv_head, k0 + BT, b, &full[s ^ 1]);
      load_tile(st + TILE_BYTES, &v_map, kv_head, k0 + BT, b, &full[s ^ 1]);
    }
    // the next tile's key bias, stored after the products (latency hidden)
    const bool next_bias = BIAS && more && tid < BT;
    const float next_kb = next_bias ? key_bias(j + 1) : 0.f;
    const uint32_t k_tile = smem_u32(ring + s * 2 * TILE_BYTES), v_tile = k_tile + TILE_BYTES;
    mbar_wait(&full[s], (j >> 1) & 1);

    float sacc[32], dpacc[32];
    two_products(sacc, dpacc, q_tile, k_tile, do_tile, v_tile);  // S, dP

    const bool edge = k0 + BT > tk || (causal && k0 + BT - 1 > q0 + shift);
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      float2 kb = make_float2(0.f, 0.f);  // the key bias of this thread's two columns
      if constexpr (BIAS) kb = *reinterpret_cast<const float2*>(bias_slot + s * BT + 8 * jj + c2);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, key = k0 + 8 * jj + c2 + (e & 1);
        float p = ex2(fmaf(sacc[4 * jj + e], sl2, (e & 1) ? kb.y : kb.x) - lr[r]);
        if (edge && (key >= tk || (causal && key > qa + 8 * r + shift))) p = 0.f;
        dpacc[4 * jj + e] = p * (dpacc[4 * jj + e] - dl[r]);
      }
    }
    uint32_t dsa[16];
    to_a_fragments(dpacc, dsa);

    // dQ += dS K
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BT / 16; ++kk)
      wgmma_n128_rs(dq_acc, dsa + 4 * kk, desc_mnmajor(k_tile, kk, BOX_BYTES));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq_acc);
    fence_regs(dsa);
    if (next_bias) bias_slot[(s ^ 1) * BT + tid] = next_kb;
  }

  const long q_stride = (long)h * HEAD_DIM;
  const float scale = rsqrtf((float)HEAD_DIM);
  const float mul[2] = {scale, scale};
  store_rows(dq_acc, dq + (long)b * tq * q_stride + (long)head * HEAD_DIM, q_stride, qa, tq,
             mul);
}

template <bool BIAS>
int launch(const void* q, const void* k, const void* v, const void* o, const void* lse,
           const void* dout, const void* bias, void* dq, void* dk, void* dv, void* delta, int n,
           int tq, int tk, int h, int hkv, int causal, cudaStream_t stream) {
  const auto* biasf = static_cast<const float*>(bias);
  const auto* lsef = static_cast<const float*>(lse);
  auto* deltaf = static_cast<float*>(delta);
  // runtime calls first: they make the device's context current on this
  // thread (autograd's backward thread may have none), which the driver's
  // tensor-map encoder needs
  cudaError_t e = cudaFuncSetAttribute(flash_bwd_dq_kernel<BIAS>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)SMEM_BYTES);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(flash_bwd_dkv_kernel<BIAS>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  CUtensorMap q_map, k_map, v_map, do_map;
  int rc = encode_rows(&q_map, q, n, tq, h, HEAD_DIM, BT);
  if (rc == 0) rc = encode_rows(&do_map, dout, n, tq, h, HEAD_DIM, BT);
  if (rc == 0) rc = encode_rows(&k_map, k, n, tk, hkv, HEAD_DIM, BT);
  if (rc == 0) rc = encode_rows(&v_map, v, n, tk, hkv, HEAD_DIM, BT);
  if (rc != 0) return rc;
  const long rows = (long)n * tq * h;
  if (rows > 0) {
    const long blocks = (rows + THREADS / 32 - 1) / (THREADS / 32);
    flash_bwd_delta_kernel<<<(unsigned)blocks, THREADS, 0, stream>>>(
        static_cast<const bf16*>(o), static_cast<const bf16*>(dout), deltaf, rows, tq, h);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    dim3 grid((tq + BT - 1) / BT, n * h);
    flash_bwd_dq_kernel<BIAS><<<grid, THREADS, SMEM_BYTES, stream>>>(
        q_map, k_map, v_map, do_map, lsef, deltaf, biasf, static_cast<bf16*>(dq), tq, tk, h,
        hkv, causal);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  if ((long)n * tk * hkv > 0) {
    dim3 grid((tk + BT - 1) / BT, n * hkv);
    flash_bwd_dkv_kernel<BIAS><<<grid, THREADS, SMEM_BYTES, stream>>>(
        q_map, k_map, v_map, do_map, lsef, deltaf, biasf, static_cast<bf16*>(dk),
        static_cast<bf16*>(dv), tq, tk, h, hkv, causal);
    return (int)cudaGetLastError();
  }
  return 0;
}

}  // namespace

// q, o, dout, dq: [n, tq, h, d] bf16; k, v, dk, dv: [n, tk, hkv, d] bf16;
// lse and the delta workspace: [n*h, tq] f32; bias: null, or the forward's
// key-only bias as [h, tk] f32; all contiguous and 16-byte aligned, h % hkv
// == 0, d = 128 only (Vicuna-7B, MPT-7B). Returns 0, a cudaError_t code, or
// -1 for an unsupported head_dim.
extern "C" int tp_flash_bwd(const void* q, const void* k, const void* v, const void* o,
                            const void* lse, const void* dout, const void* bias, void* dq,
                            void* dk, void* dv, void* delta, int n, int tq, int tk, int h,
                            int hkv, int d, int causal, void* stream) {
  if (d != HEAD_DIM) return -1;
  const auto st = static_cast<cudaStream_t>(stream);
  if (bias != nullptr)
    return launch<true>(q, k, v, o, lse, dout, bias, dq, dk, dv, delta, n, tq, tk, h, hkv,
                        causal, st);
  return launch<false>(q, k, v, o, lse, dout, bias, dq, dk, dv, delta, n, tq, tk, h, hkv,
                       causal, st);
}
