// One 64-row query tile of softmax(q k^T * scale) v for one head, shared by
// the tower attention (vit_attention.cu) and the prefill flash forward
// (flash_fwd.cu).
//
// A block of 4 warps owns 64 query rows; each warp owns 16 of them from the
// first product to the output, so only the K/V tile loads need the whole
// block to meet. Per 64-key tile:
//   S  = Q K^T           bf16 WMMA 16x16x16, fp32 accumulate, into smem
//   P  = exp2(S*scale*log2e - m)  online softmax in fp32; P rounded to bf16
//   O  = O*alpha + P V   O kept in fp32 smem, loaded into and stored from
//                        the WMMA accumulators around each product
// The row sum l adds the bf16-rounded P, the weights the product actually
// used, and the output is divided by l once at the end. Rows and keys past
// the sequence end are zero-filled on load and masked, so no length has to
// be a multiple of the tile. Causal masking is aligned bottom-right
// (query i sees keys <= i + tk - tq) and tiles wholly above the diagonal
// are never loaded.
//
// With KEY_BIAS (K2's key-only additive bias, MPT's ALiBi) the logits are
// S*scale + bias[key] before the softmax: each lane reads its two keys'
// fp32 bias once per key tile (never past tk) and the tile works on
// (S*scale + bias)*log2e, so lse stays the natural-log log-sum-exp of the
// biased logits.
//
// With FULL_BIAS (K2's full additive bias [N|1, H|1, Tq, Tk], the branch
// that no model of the repo reaches) `bias` points at the (sample, head)
// [tq, tk] fp32 matrix; before the softmax each lane folds the scale and
// its two keys' bias of each of its warp's 16 rows into S (one coalesced
// 128-byte read per row and half-tile, never past tq or tk, and not for
// keys above the causal diagonal). The running max starts at -1e30 (in
// log2 units), the TPU kernel's NEG_INF, not at -inf: a row whose biased
// logits all lie below it (a prefix-LM row of the fp32 minimum) keeps
// l = 0 and gets o = 0 and lse = +inf, as the TPU kernel gives it. Such a
// bias overflows to -inf in log2 units (finfo.min * log2e), which the
// softmax already reads as a masked key. NO_BIAS compiles to the code
// without the argument.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <cmath>

namespace tp {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

constexpr int BQ = 64;            // query rows per block
constexpr int BK = 64;            // keys per tile
constexpr int WARPS = 4;          // each warp owns 16 query rows
constexpr int THREADS = WARPS * 32;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

enum BiasForm { NO_BIAS, KEY_BIAS, FULL_BIAS };
// FULL_BIAS's first running max: the TPU kernel's NEG_INF in log2 units
constexpr float FULL_BIAS_M0 = -1e30f * LOG2E;

// Row strides of the shared-memory tiles, padded past a multiple of 128
// bytes so that the 8 rows of an ldmatrix land in different banks; every
// 16-row fragment still starts 32-byte aligned, as WMMA requires.
template <int D> constexpr int QKV_LD = D + 8;  // bf16 Q, K, V
constexpr int S_LD = BK + 4;                    // fp32 logits
constexpr int P_LD = BK + 8;                    // bf16 probabilities
template <int D> constexpr int O_LD = D + 4;     // fp32 output

template <int D>
constexpr size_t tile_smem_bytes() {
  return 3 * (size_t)BQ * QKV_LD<D> * 2  // Q, K, V (BK == BQ)
         + (size_t)BQ * S_LD * 4          // S
         + (size_t)BQ * P_LD * 2          // P
         + (size_t)BQ * O_LD<D> * 4       // O
         + 3 * (size_t)BQ * 4;            // m, l, alpha
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

// Copies rows [row0, row0 + nrows) of D bf16 each into dst (QKV_LD
// apart), 16 bytes per thread per step; rows at or past `limit` become 0.
template <int D>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, long stride,
                                          int row0, int limit, int nrows) {
  constexpr int CH = D / 8;
  for (int i = threadIdx.x; i < nrows * CH; i += THREADS) {
    const int r = i / CH, c = i % CH;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < limit)
      val = *reinterpret_cast<const uint4*>(src + (long)(row0 + r) * stride + c * 8);
    *reinterpret_cast<uint4*>(dst + r * QKV_LD<D> + c * 8) = val;
  }
}

// q/k/v/o point at element 0 of the head in row 0 of the sequence; rows
// are `*_stride` elements apart. lse (nullable) gets the natural-log
// log-sum-exp of each query row, +inf for a row with no visible key.
// bias: KEY_BIAS the head's [tk] fp32 key bias; FULL_BIAS the (sample,
// head) [tq, tk] fp32 bias, rows tk apart.
template <int D, BiasForm BIAS = NO_BIAS>
__device__ void attention_tile(const bf16* __restrict__ q, long q_stride,
                               const bf16* __restrict__ k, long k_stride,
                               const bf16* __restrict__ v, long v_stride,
                               bf16* __restrict__ o, long o_stride,
                               float* __restrict__ lse, int tq, int tk, int q0,
                               bool causal, float scale, unsigned char* smem,
                               const float* __restrict__ bias = nullptr) {
  constexpr int LD = QKV_LD<D>, OL = O_LD<D>;
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + BQ * LD;
  bf16* Vs = Ks + BK * LD;
  float* S = reinterpret_cast<float*>(Vs + BK * LD);
  bf16* P = reinterpret_cast<bf16*>(S + BQ * S_LD);
  float* O = reinterpret_cast<float*>(P + BQ * P_LD);
  float* row_m = O + BQ * OL;
  float* row_l = row_m + BQ;
  float* row_a = row_l + BQ;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = warp * 16;
  const float sl2 = scale * LOG2E;
  const int shift = tk - tq;

  load_rows<D>(Qs, q, q_stride, q0, tq, BQ);
  for (int i = threadIdx.x; i < BQ * OL; i += THREADS) O[i] = 0.f;
  if (threadIdx.x < BQ) {
    row_m[threadIdx.x] = BIAS == FULL_BIAS ? FULL_BIAS_M0 : -INFINITY;
    row_l[threadIdx.x] = 0.f;
  }
  // keys any row of this tile can see: the causal bound of its last row
  int kend = tk;
  if (causal) kend = min(tk, q0 + BQ + shift);
  const int num_kt = kend > 0 ? (kend + BK - 1) / BK : 0;
  __syncthreads();

  for (int kt = 0; kt < num_kt; ++kt) {
    const int k0 = kt * BK;
    load_rows<D>(Ks, k, k_stride, k0, tk, BK);
    load_rows<D>(Vs, v, v_stride, k0, tk, BK);
    __syncthreads();

    // S[r0:r0+16, :] = Q K^T
#pragma unroll
    for (int nt = 0; nt < BK / 16; ++nt) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
        wmma::load_matrix_sync(a, Qs + r0 * LD + kk * 16, LD);
        wmma::load_matrix_sync(b, Ks + nt * 16 * LD + kk * 16, LD);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(S + r0 * S_LD + nt * 16, acc, S_LD, wmma::mem_row_major);
    }
    __syncwarp();

    // the bias of this lane's two keys (0 past tk, where it is never read)
    float kb[2] = {0.f, 0.f};
    if constexpr (BIAS == KEY_BIAS) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kj = k0 + lane + 32 * j;
        if (kj < tk) kb[j] = bias[kj];
      }
    }

    // S*scale + the full bias, for this warp's rows and this lane's keys;
    // the loads of all 16 rows are independent, so they are in flight together
    if constexpr (BIAS == FULL_BIAS) {
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int qi = q0 + r0 + i;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int kj = k0 + lane + 32 * j;
          const bool ok = qi < tq && kj < tk && (!causal || kj <= qi + shift);
          float& sv = S[(r0 + i) * S_LD + lane + 32 * j];
          sv = sv * scale + (ok ? bias[(long)qi * tk + kj] : 0.f);
        }
      }
    }

    // online softmax; lane holds keys lane and lane + 32 of each row
    for (int r = r0; r < r0 + 16; ++r) {
      const int qi = q0 + r;
      float s[2];
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kj = k0 + lane + 32 * j;
        const bool ok = kj < tk && (!causal || kj <= qi + shift);
        float x;
        if constexpr (BIAS == KEY_BIAS) {
          x = (S[r * S_LD + lane + 32 * j] * scale + kb[j]) * LOG2E;
        } else if constexpr (BIAS == FULL_BIAS) {
          x = S[r * S_LD + lane + 32 * j] * LOG2E;
        } else {
          x = S[r * S_LD + lane + 32 * j] * sl2;
        }
        s[j] = ok ? x : -INFINITY;
        mx = fmaxf(mx, s[j]);
      }
      mx = warp_max(mx);
      const float m_old = row_m[r];
      const float m_new = fmaxf(m_old, mx);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float p = s[j] == -INFINITY ? 0.f : exp2f(s[j] - m_new);
        const bf16 pb = __float2bfloat16(p);
        P[r * P_LD + lane + 32 * j] = pb;
        psum += __bfloat162float(pb);
      }
      psum = warp_sum(psum);
      if (lane == 0) {
        const float alpha = m_old == -INFINITY ? 0.f : exp2f(m_old - m_new);
        row_a[r] = alpha;
        row_l[r] = row_l[r] * alpha + psum;
        row_m[r] = m_new;
      }
    }
    __syncwarp();

    for (int i = lane; i < 16 * D; i += 32) O[(r0 + i / D) * OL + i % D] *= row_a[r0 + i / D];
    __syncwarp();

    // O[r0:r0+16, :] += P V
#pragma unroll
    for (int nt = 0; nt < D / 16; ++nt) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::load_matrix_sync(acc, O + r0 * OL + nt * 16, OL, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(a, P + r0 * P_LD + kk * 16, P_LD);
        wmma::load_matrix_sync(b, Vs + kk * 16 * LD + nt * 16, LD);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(O + r0 * OL + nt * 16, acc, OL, wmma::mem_row_major);
    }
    __syncthreads();  // every warp is done with Ks/Vs before the next load
  }

  for (int i = lane; i < 16 * D; i += 32) {
    const int r = r0 + i / D, c = i % D, qi = q0 + r;
    if (qi < tq) {
      const float l = row_l[r];
      o[(long)qi * o_stride + c] = __float2bfloat16(l > 0.f ? O[r * OL + c] / l : 0.f);
    }
  }
  if (lse != nullptr && lane < 16) {
    const int r = r0 + lane, qi = q0 + r;
    if (qi < tq) {
      const float l = row_l[r];
      lse[qi] = l > 0.f ? (row_m[r] + log2f(l)) * LN2 : INFINITY;
    }
  }
}

}  // namespace tp
