// K2 (forward): flash attention for the LM prefill and training, with GQA,
// on Hopper's tensor-core path (wgmma) with TMA tile loads.
//
// Replaces tokenpacker_tpu/ops/flash_attention.py:flash_attention's
// forward (_flash_fwd / _fwd_kernel) and the head repeat of mha_flash.
//
// What bounds it on the H100: at Vicuna-7B's and MPT-7B's shapes (32 heads
// of d = 128, T of a few hundred to 2048) the two products, 4*T^2*d FLOP a
// head (half of it under a causal mask), against T*d*2*4 bytes of q/k/v/o:
// the tensor cores, from T ~ 300 on. The full-bias form adds the bias's
// bytes (a [4, 32, 2048, 2048] fp32 bias is 2 GiB, 0.64 ms at 3.35 TB/s),
// which then bound the call.
//
// The design (flash_sm90.cuh has the building blocks):
//  - A block owns 128 query rows of one (sample, head); 288 threads: two
//    consumer warpgroups, each owning 64 of the rows from the first product
//    to the output, and one producer warp. Nine warps put three on one of
//    the SM's four register files, so ptxas allots at most 168 registers a
//    thread: S (64), O (64) and P (32 registers of bf16 pairs) fit without
//    spills (155, 168 and 152 registers in the three forms). The heaviest
//    query tiles (the last ones under a causal mask) are scheduled first.
//  - The producer's lane 0 loads Q once and then K and V in tiles of 128
//    keys (64 in the full-bias form) through a ring of 2 stages in shared
//    memory, with TMA: each tile is two 64-column boxes with the 128-byte
//    swizzle, rows past the sequence end zero-filled by the hardware,
//    completion on the stage's "full" mbarrier. A stage is refilled once all 8 consumer warps have
//    arrived on its "empty" mbarrier, so the next tile's copy overlaps the
//    current tile's products and softmax. A query head h reads kv head
//    h / (H / Hkv) in place: GQA never repeats K/V in memory.
//  - S = Q K^T: 8 wgmma m64n128k16 (m64n64k16) a tile, both operands from
//    shared memory, the fp32 accumulator in registers. S never goes to
//    memory.
//  - The online softmax runs on each thread's own accumulator fragment, in
//    log2 units (scale * log2 e folded into one multiply): the row max and,
//    at the end, the row sum reduce over the 4 threads of a row (quad
//    shuffles). Only a tile that straddles the causal diagonal or the
//    sequence end pays for the mask; tiles wholly above the diagonal are
//    never loaded.
//  - O += P V: P rounded to bf16 in registers is wgmma's A operand (RS
//    form), V the MN-major B operand from the stage (transpose bit), one
//    m64n128k16 for each 16 keys. O stays in fp32 registers, is rescaled there when
//    the row max moves, and is divided by l once at the end. l adds the
//    bf16-rounded P, the weights the product actually used.
//  - Epilogue: o as bf16 pairs straight from the registers, lse (natural
//    log) per row, +inf for a row with no visible key (o = 0).
// Causal masking is aligned bottom-right (query i sees keys <= i + tk -
// tq); ragged T is masked in-kernel, with no padding of T.
//
// The key-only bias form (_flash_fwd with a [1, H|1, 1, Tk] bias, the
// branch at flash_attention.py:194-229; MPT's ALiBi) takes the bias as one
// [h, tk] fp32 row per head: the producer warp writes each tile's 128 key
// biases (in log2 units) beside its K and V in the stage and arrives on
// its "full" barrier, and each thread adds its columns' values to its
// fragment, so [Tq, Tk] is never built.
//
// The full-bias form (_flash_fwd with a [N|1, H|1, Tq, Tk] bias, the branch
// at flash_attention.py:202-205 and :223-227, which no model of the repo
// reaches) reads the bias in place, fp32 with rows tk apart and a sample
// and a head stride that are 0 on a broadcast axis. The producer warp
// copies each tile's block of bias entries (128 rows x 64 keys, only those
// below tq and tk) into the stage by cp.async (16 bytes a copy where tk
// % 4 == 0) and arrives on the stage's "full" barrier once they land; the
// tiles are 64 keys wide so that two stages of K, V and bias fit, and each
// thread reads its fragment's entries from shared memory: loaded per
// thread from global memory after the product, they would leave this form
// bound by the loads' latency (and spilling), at ~20% of its byte bound
// on the H100. The running max starts at -1e30 (in log2 units), the TPU
// kernel's NEG_INF, not at -inf: a row whose biased logits all lie below
// it keeps l = 0 and gets o = 0 and lse = +inf (the rule ROADMAP's R8 and
// R9 keep for the port).

#include "flash_sm90.cuh"

namespace {

using namespace sm90;

enum BiasForm { NO_BIAS, KEY_BIAS, FULL_BIAS };
// FULL_BIAS's first running max: the TPU kernel's NEG_INF in log2 units
constexpr float FULL_BIAS_M0 = -1e30f * LOG2E;

constexpr int BM = 128;       // query rows a block
constexpr int STAGES = 2;     // K/V ring
constexpr int CONSUMERS = 2;  // warpgroups of 64 rows
constexpr int THREADS = CONSUMERS * 128 + 32;  // and one producer warp
constexpr int Q_BYTES = 2 * BM * ROW_BYTES;    // two 64-column boxes

// The tile of one bias form: keys a tile (64 for FULL_BIAS, whose staged
// bias tile takes the room of the other 64), the bytes of K or V of one
// stage, and the fp32 bias each stage holds beside them (KEY_BIAS: the
// tile's key bias; FULL_BIAS: BM rows of BN, rows BIAS_LD apart so that
// the 8 rows a warp reads at once fall in different banks).
template <BiasForm BIAS>
struct Tile {
  static constexpr int BN = BIAS == FULL_BIAS ? 64 : 128;
  static constexpr int KV_BYTES = 2 * BN * ROW_BYTES;
  static constexpr int BIAS_LD = BN + 8;
  static constexpr int BIAS_FLOATS = BIAS == FULL_BIAS ? BM * BIAS_LD : BIAS == KEY_BIAS ? BN : 0;
  // Q, the K/V ring, the bias of each stage, barriers
  static constexpr size_t SMEM_BYTES = 1024 + Q_BYTES + STAGES * 2 * KV_BYTES +
                                       STAGES * BIAS_FLOATS * 4 + 8 * (1 + 2 * STAGES);
};

// S = Q K^T of one stage: N = BN keys, K-major over the head dim (the first
// slice overwrites the accumulator).
template <int BN>
__device__ __forceinline__ void s_product(float (&sacc)[BN / 2], uint32_t q_tile,
                                          uint32_t k_tile) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < HEAD_DIM / 16; ++kk) {
    const uint64_t a = desc_kmajor(q_tile, kk, BM * ROW_BYTES);
    const uint64_t b = desc_kmajor(k_tile, kk, BN * ROW_BYTES);
    if constexpr (BN == 128) wgmma_n128_ss(sacc, a, b, kk > 0);
    else wgmma_n64_ss(sacc, a, b, kk > 0);
  }
  wgmma_commit();
}

template <BiasForm BIAS>
__global__ void __launch_bounds__(THREADS, 1)
    flash_fwd_kernel(const __grid_constant__ CUtensorMap q_map,
                     const __grid_constant__ CUtensorMap k_map,
                     const __grid_constant__ CUtensorMap v_map, bf16* __restrict__ o,
                     float* __restrict__ lse, const float* __restrict__ bias, long bias_sn,
                     long bias_sh, int tq, int tk, int h, int hkv, int causal) {
  constexpr int BN = Tile<BIAS>::BN, KV_BYTES = Tile<BIAS>::KV_BYTES;
  constexpr int BIAS_LD = Tile<BIAS>::BIAS_LD, BIAS_FLOATS = Tile<BIAS>::BIAS_FLOATS;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  unsigned char* qs = smem;
  unsigned char* ring = smem + Q_BYTES;  // stage s: K at s * 2 * KV_BYTES, V after it
  float* bias_tiles = reinterpret_cast<float*>(ring + STAGES * 2 * KV_BYTES);  // [STAGES][..]
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(bias_tiles + STAGES * BIAS_FLOATS);
  uint64_t* full = bar_q + 1;
  uint64_t* empty = full + STAGES;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BM;  // heaviest tiles first
  const int bh = blockIdx.y;
  const int b = bh / h, head = bh % h;
  const int kv_head = head / (h / hkv);
  const int shift = tk - tq;
  // keys any row of this block can see: the causal bound of its last row
  int kend = tk;
  if (causal) kend = min(tk, q0 + BM + shift);
  const int num_kt = kend > 0 ? (kend + BN - 1) / BN : 0;
  // FULL_BIAS: the (sample, head) [tq, tk] matrix
  const float* bias_mat = BIAS == FULL_BIAS ? bias + b * bias_sn + head * bias_sh : nullptr;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      // with a staged bias: the TMA's arrival and one from each producer lane
      mbar_init(&full[s], BIAS == NO_BIAS ? 1 : 33);
      mbar_init(&empty[s], CONSUMERS * 4);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == CONSUMERS * 4) {  // the producer
    if (lane == 0) {
      mbar_expect_tx(bar_q, Q_BYTES);
      for (int c = 0; c < 2; ++c)
        tma_load_4d(qs + c * BM * ROW_BYTES, &q_map, 64 * c, head, q0, b, bar_q);
    }
    // FULL_BIAS: 16-byte copies where every row starts 16-byte aligned
    const bool chunks = BIAS == FULL_BIAS && tk % 4 == 0 &&
                        reinterpret_cast<uintptr_t>(bias_mat) % 16 == 0;
    for (int j = 0; j < num_kt; ++j) {
      const int s = j % STAGES, k0 = j * BN;
      if (j >= STAGES) mbar_wait(&empty[s], (j / STAGES - 1) & 1);
      if (lane == 0) {
        unsigned char* ks = ring + s * 2 * KV_BYTES;
        mbar_expect_tx(&full[s], 2 * KV_BYTES);
        for (int c = 0; c < 2; ++c) {
          tma_load_4d(ks + c * BN * ROW_BYTES, &k_map, 64 * c, kv_head, k0, b, &full[s]);
          tma_load_4d(ks + KV_BYTES + c * BN * ROW_BYTES, &v_map, 64 * c, kv_head, k0, b,
                      &full[s]);
        }
      }
      float* dst = bias_tiles + s * BIAS_FLOATS;
      if constexpr (BIAS == KEY_BIAS) {  // the tile's key bias in log2 units, 0 past tk
        for (int c = lane; c < BN; c += 32) {
          const int key = k0 + c;
          dst[c] = key < tk ? bias[(long)head * tk + key] * LOG2E : 0.f;
        }
        mbar_arrive(&full[s]);
      } else if constexpr (BIAS == FULL_BIAS) {
        // the block's BM x BN bias entries below tq and tk, as they lie
        // (the consumers mask the rest), by cp.async
        if (chunks) {
          for (int i = lane; i < BM * (BN / 4); i += 32) {
            const int r = i / (BN / 4), c = 4 * (i % (BN / 4));
            if (q0 + r < tq && k0 + c < tk)
              cp_async_16(dst + r * BIAS_LD + c, bias_mat + (long)(q0 + r) * tk + k0 + c);
          }
        } else {
          for (int i = lane; i < BM * BN; i += 32) {
            const int r = i / BN, c = i % BN;
            if (q0 + r < tq && k0 + c < tk)
              cp_async_4(dst + r * BIAS_LD + c, bias_mat + (long)(q0 + r) * tk + k0 + c);
          }
        }
        cp_async_wait_all();
        mbar_arrive(&full[s]);
      }
    }
    return;
  }

  // a consumer warpgroup: rows wq0.. wq0 + 63; this thread's rows qa, qa + 8
  const int wg = warp / 4;
  const int wq0 = q0 + wg * 64;
  const int ra = wg * 64 + (warp % 4) * 16 + lane / 4;  // qa's row in the block
  const int qa = q0 + ra;
  const int c2 = 2 * (lane % 4);
  const float sl2 = rsqrtf((float)HEAD_DIM) * LOG2E;
  const float scale = rsqrtf((float)HEAD_DIM);
  const float m0 = BIAS == FULL_BIAS ? FULL_BIAS_M0 : -INFINITY;
  float m[2] = {m0, m0}, l[2] = {0.f, 0.f};
  float oacc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) oacc[i] = 0.f;
  const uint32_t q_tile = smem_u32(qs) + wg * 64 * ROW_BYTES;
  mbar_wait(bar_q, 0);

  for (int j = 0; j < num_kt; ++j) {
    const int s = j % STAGES, k0 = j * BN;
    const uint32_t k_tile = smem_u32(ring + s * 2 * KV_BYTES), v_tile = k_tile + KV_BYTES;
    const float* stage_bias = bias_tiles + s * BIAS_FLOATS;
    mbar_wait(&full[s], (j / STAGES) & 1);

    float sacc[BN / 2];
    s_product<BN>(sacc, q_tile, k_tile);  // S = Q K^T
    wgmma_wait<0>();
    fence_regs(sacc);

    // the logits in log2 units, -inf where a key is not visible
    const bool edge = k0 + BN > tk || (causal && k0 + BN - 1 > wq0 + shift);
    if constexpr (BIAS == KEY_BIAS) {
#pragma unroll
      for (int jj = 0; jj < BN / 8; ++jj) {
        const float2 kb = *reinterpret_cast<const float2*>(stage_bias + 8 * jj + c2);
        sacc[4 * jj] = fmaf(sacc[4 * jj], sl2, kb.x);
        sacc[4 * jj + 1] = fmaf(sacc[4 * jj + 1], sl2, kb.y);
        sacc[4 * jj + 2] = fmaf(sacc[4 * jj + 2], sl2, kb.x);
        sacc[4 * jj + 3] = fmaf(sacc[4 * jj + 3], sl2, kb.y);
      }
    } else if constexpr (BIAS == FULL_BIAS) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int q = qa + 8 * r;
        const float* brow = stage_bias + (ra + 8 * r) * BIAS_LD;
#pragma unroll
        for (int jj = 0; jj < BN / 8; ++jj) {
          const int key = k0 + 8 * jj + c2;
          const float2 bv = *reinterpret_cast<const float2*>(brow + 8 * jj + c2);
          float& s0 = sacc[4 * jj + 2 * r];
          float& s1 = sacc[4 * jj + 2 * r + 1];
          const bool ok0 = q < tq && key < tk && (!causal || key <= q + shift);
          const bool ok1 = q < tq && key + 1 < tk && (!causal || key + 1 <= q + shift);
          s0 = ok0 ? fmaf(s0, scale, bv.x) * LOG2E : -INFINITY;
          s1 = ok1 ? fmaf(s1, scale, bv.y) * LOG2E : -INFINITY;
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) sacc[i] *= sl2;
    }
    if (BIAS != FULL_BIAS && edge) {
#pragma unroll
      for (int jj = 0; jj < BN / 8; ++jj) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + 8 * jj + c2 + (e & 1);
          const int q = qa + 8 * (e >> 1);
          if (key >= tk || (causal && key > q + shift)) sacc[4 * jj + e] = -INFINITY;
        }
      }
    }

    // online softmax on the fragment: rows qa (r = 0) and qa + 8 (r = 1)
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int jj = 0; jj < BN / 8; ++jj) {
      mx[0] = fmaxf(mx[0], fmaxf(sacc[4 * jj], sacc[4 * jj + 1]));
      mx[1] = fmaxf(mx[1], fmaxf(sacc[4 * jj + 2], sacc[4 * jj + 3]));
    }
    float mu[2], alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], quad_max(mx[r]));
      mu[r] = m_new == -INFINITY ? 0.f : m_new;  // a row with no key yet: p = 0
      alpha[r] = ex2(m[r] - mu[r]);
      m[r] = m_new;
    }
    uint32_t pa[BN / 4];
    float ls[2] = {0.f, 0.f};
#pragma unroll
    for (int jj = 0; jj < BN / 8; ++jj) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const uint32_t pb = pack_bf16(ex2(sacc[4 * jj + 2 * r] - mu[r]),
                                      ex2(sacc[4 * jj + 2 * r + 1] - mu[r]));
        const __nv_bfloat162 pv = *reinterpret_cast<const __nv_bfloat162*>(&pb);
        ls[r] += __low2float(pv) + __high2float(pv);
        pa[4 * (jj / 2) + 2 * (jj % 2) + r] = pb;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + ls[r];
#pragma unroll
    for (int jj = 0; jj < 16; ++jj) {
      oacc[4 * jj] *= alpha[0];
      oacc[4 * jj + 1] *= alpha[0];
      oacc[4 * jj + 2] *= alpha[1];
      oacc[4 * jj + 3] *= alpha[1];
    }

    // O += P V
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
      wgmma_n128_rs(oacc, pa + 4 * kk, desc_mnmajor(v_tile, kk, BN * ROW_BYTES));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(oacc);
    fence_regs(pa);
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = quad_sum(l[r]);
    inv[r] = l[r] > 0.f ? 1.f / l[r] : 0.f;
  }
  const long row_stride = (long)h * HEAD_DIM;
  store_rows(oacc, o + (long)b * tq * row_stride + (long)head * HEAD_DIM, row_stride, qa, tq,
             inv);
  if (lane % 4 == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int q = qa + 8 * r;
      if (q < tq) lse[(long)bh * tq + q] = l[r] > 0.f ? (m[r] + log2f(l[r])) * LN2 : INFINITY;
    }
  }
}

template <BiasForm BIAS>
int launch(const void* q, const void* k, const void* v, void* o, void* lse, const void* bias,
           long bias_sn, long bias_sh, int n, int tq, int tk, int h, int hkv, int causal,
           cudaStream_t stream) {
  if ((long)n * h * tq == 0) return 0;
  // a runtime call first: it makes the device's context current on this
  // thread (autograd's backward thread may have none), which the driver's
  // tensor-map encoder needs
  constexpr size_t SMEM_BYTES = Tile<BIAS>::SMEM_BYTES;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel<BIAS>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  CUtensorMap q_map, k_map, v_map;
  int rc = encode_rows(&q_map, q, n, tq, h, HEAD_DIM, BM);
  if (rc == 0) rc = encode_rows(&k_map, k, n, tk, hkv, HEAD_DIM, Tile<BIAS>::BN);
  if (rc == 0) rc = encode_rows(&v_map, v, n, tk, hkv, HEAD_DIM, Tile<BIAS>::BN);
  if (rc != 0) return rc;
  dim3 grid((tq + BM - 1) / BM, n * h);
  flash_fwd_kernel<BIAS><<<grid, THREADS, SMEM_BYTES, stream>>>(
      q_map, k_map, v_map, static_cast<bf16*>(o), static_cast<float*>(lse),
      static_cast<const float*>(bias), bias_sn, bias_sh, tq, tk, h, hkv, causal);
  return (int)cudaGetLastError();
}

}  // namespace

// q, o: [n, tq, h, d] bf16; k, v: [n, tk, hkv, d] bf16; lse: [n*h, tq] f32;
// bias: null, or the key-only bias as [h, tk] f32; all contiguous and
// 16-byte aligned, h % hkv == 0, d = 128 only (Vicuna-7B, MPT-7B). Returns
// 0, a cudaError_t code, or -1 for an unsupported head_dim.
extern "C" int tp_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                            const void* bias, int n, int tq, int tk, int h, int hkv, int d,
                            int causal, void* stream) {
  if (d != HEAD_DIM) return -1;
  const auto st = static_cast<cudaStream_t>(stream);
  if (bias != nullptr)
    return launch<KEY_BIAS>(q, k, v, o, lse, bias, 0, 0, n, tq, tk, h, hkv, causal, st);
  return launch<NO_BIAS>(q, k, v, o, lse, bias, 0, 0, n, tq, tk, h, hkv, causal, st);
}

// The full-bias form: q, k, v, o, lse as above; bias: fp32, the (sample b,
// head h) [tq, tk] matrix at bias + b * bias_sn + h * bias_sh, rows tk
// apart (a stride is 0 on a broadcast axis). Returns 0, a cudaError_t code,
// or -1 for an unsupported head_dim.
extern "C" int tp_flash_fwd_full_bias(const void* q, const void* k, const void* v, void* o,
                                      void* lse, const void* bias, long long bias_sn,
                                      long long bias_sh, int n, int tq, int tk, int h, int hkv,
                                      int d, int causal, void* stream) {
  if (d != HEAD_DIM || bias == nullptr) return -1;
  return launch<FULL_BIAS>(q, k, v, o, lse, bias, (long)bias_sn, (long)bias_sh, n, tq, tk, h,
                           hkv, causal, static_cast<cudaStream_t>(stream));
}
