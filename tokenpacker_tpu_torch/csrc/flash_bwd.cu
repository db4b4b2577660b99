// K2 (backward): dq, dk and dv of the prefill / training flash attention,
// with GQA, from the log-sum-exp the forward (flash_fwd.cu) saved.
//
// Replaces tokenpacker_tpu/ops/flash_attention.py:_flash_bwd_pallas (its
// dq pass _dq_kernel and its dk/dv pass _dkv_kernel) in the no-bias form,
// and the head repeat and group sum that mha_flash's GQA costs there.
//
// With P = exp(q k^T * scale - lse), dP = dO v^T and delta = rowsum(dO o):
//   dS = P (dP - delta),  dq = dS k * scale,  dk = dS^T q * scale,  dv = P^T dO.
//
// What bounds it on the H100: at the training shape [8, 2048, 32, 128],
// causal, the five products are ~0.69 TFLOP against ~1.07 GB of q, k, v,
// o, dO, dq, dk, dv and lse, so the tensor cores bound it (0.69 ms at the
// dense bf16 rate, 0.32 ms of bytes). The design is FA2's split into two
// passes, so that no float atomics are needed and two calls give the same
// bits:
//   - a delta pass, one warp per (token, head) row of o and dO;
//   - the dq kernel: grid (64-row query tile, batch*head). The block walks
//     the key tiles up to the causal diagonal, recomputes S and dP with
//     bf16 WMMA (fp32 accumulate), forms dS in fp32 and rounds it to bf16
//     for the product with K; dq accumulates in fp32 fragments in
//     registers;
//   - the dk/dv kernel: grid (64-row key tile, batch*kv head). The block
//     walks the G = H / Hkv query heads of its group and the query tiles
//     from the diagonal on, recomputes S^T and dP^T, and accumulates dk and
//     dv in fp32 fragments in registers. Summing the group inside the block
//     makes GQA exact without a repeat of K/V in memory.
// Every product is bf16 x bf16 on the tensor cores (WMMA 16x16x16) with
// fp32 accumulation; P and dS are rounded to bf16 only as operands. Each
// warp owns 16 rows of its block's tile from the first product to the
// last, so only the tile loads need the whole block to meet. q, k, v, o
// and dO are read in place in their [N, T, H, d] layout with strides;
// ragged T, causality aligned bottom-right (key j visible to query i iff
// j <= i + Tk - Tq) and rows with lse = +inf (no visible key, P = 0) are
// masked in the kernels.
//
// The key-only bias form (_flash_bwd_pallas with `bias`, asserted key-only
// at flash_attention.py:382; MPT's ALiBi) takes the forward's [h, tk] fp32
// bias and adds it at the two recomputes of P, P = exp(S*scale + bias[key]
// - lse): in the dq kernel a lane's key is k0 + c, in the dk/dv kernel
// (S^T) the row's key is k0 + r, whose bias lane r - r0 holds and shares.
// The bias is a constant: it has no gradient.
//
// A correct, simple first version: one or two blocks per SM, no software
// pipelining of the tile loads, no wgmma or TMA. Its time against its
// bound is in PERF.md.

#include "attention_tile.cuh"

namespace {

using tp::BK;
using tp::BQ;
using tp::bf16;
using tp::THREADS;
namespace wmma = nvcuda::wmma;

constexpr int SF_LD = 64 + 4;  // fp32 [64 x 64] tiles (S, dP), padded rows
constexpr int PB_LD = 64 + 8;  // bf16 [64 x 64] tiles (P, dS), padded rows

using AccFrag = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;
using RowA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using RowB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using ColB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;

template <int D>
constexpr size_t dq_smem_bytes() {
  return 4 * (size_t)BQ * tp::QKV_LD<D> * 2  // Q, dO, K, V
         + 2 * (size_t)BQ * SF_LD * 4         // S, dP
         + (size_t)BQ * PB_LD * 2             // dS
         + 2 * (size_t)BQ * 4;                // lse, delta
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  return 4 * (size_t)BQ * tp::QKV_LD<D> * 2  // K, V, Q, dO
         + 2 * (size_t)BQ * SF_LD * 4         // S^T, dP^T
         + 2 * (size_t)BQ * PB_LD * 2         // P^T, dS^T
         + 2 * (size_t)BQ * 4;                // lse, delta
}

// [16 x 64] tile of A B^T for one warp: A rows at `a` (16 x D, row stride
// lda), B rows at `b` (64 x D, row stride ldb); stored to `out` (fp32,
// row stride SF_LD).
template <int D>
__device__ __forceinline__ void rows_times_rows_t(const bf16* a, int lda, const bf16* b, int ldb,
                                                  float* out) {
#pragma unroll
  for (int nt = 0; nt < 64 / 16; ++nt) {
    AccFrag acc;
    wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      RowA fa;
      ColB fb;
      wmma::load_matrix_sync(fa, a + kk * 16, lda);
      wmma::load_matrix_sync(fb, b + nt * 16 * ldb + kk * 16, ldb);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(out + nt * 16, acc, SF_LD, wmma::mem_row_major);
  }
}

// acc[nt] += A (16 x 64 bf16, row stride PB_LD) times B (64 x D, row
// stride ldb), for the D/16 column fragments of one warp's 16 rows.
template <int D>
__device__ __forceinline__ void accumulate(AccFrag (&acc)[D / 16], const bf16* a, const bf16* b,
                                           int ldb) {
#pragma unroll
  for (int kk = 0; kk < 64 / 16; ++kk) {
    RowA fa;
    wmma::load_matrix_sync(fa, a + kk * 16, PB_LD);
#pragma unroll
    for (int nt = 0; nt < D / 16; ++nt) {
      RowB fb;
      wmma::load_matrix_sync(fb, b + kk * 16 * ldb + nt * 16, ldb);
      wmma::mma_sync(acc[nt], fa, fb, acc[nt]);
    }
  }
}

// Writes one warp's 16 x D fp32 fragments times `mul` as bf16 rows
// row0.. (rows at or past `limit` are dropped) through a 16 x 16 fp32
// staging area of the warp's own.
template <int D>
__device__ __forceinline__ void store_rows(const AccFrag (&acc)[D / 16], float* stage, bf16* dst,
                                           long stride, int row0, int limit, float mul) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int nt = 0; nt < D / 16; ++nt) {
    wmma::store_matrix_sync(stage, acc[nt], 16, wmma::mem_row_major);
    __syncwarp();
    for (int i = lane; i < 256; i += 32) {
      const int r = i / 16, c = i % 16;
      if (row0 + r < limit) dst[(long)(row0 + r) * stride + nt * 16 + c] = __float2bfloat16(stage[i] * mul);
    }
    __syncwarp();
  }
}

// delta[(b*h + head) * tq + i] = sum_c o[b, i, head, c] * dO[b, i, head, c]
// in fp32; one warp per row, rows in memory order.
template <int D>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_delta_kernel(const bf16* __restrict__ o, const bf16* __restrict__ dout,
                           float* __restrict__ delta, long rows, int tq, int h) {
  const long row = (long)blockIdx.x * (THREADS / 32) + threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x % 32;
  float acc = 0.f;
#pragma unroll
  for (int j = 0; j < D / 32; ++j) {
    const long at = row * D + lane * (D / 32) + j;
    acc += __bfloat162float(o[at]) * __bfloat162float(dout[at]);
  }
  acc = tp::warp_sum(acc);
  if (lane == 0) {
    const int head = (int)(row % h);
    const long bi = row / h;
    const int i = (int)(bi % tq);
    const long b = bi / tq;
    delta[(b * h + head) * tq + i] = acc;
  }
}

template <int D, bool BIAS>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        const float* __restrict__ bias, bf16* __restrict__ dq, int tq, int tk,
                        int h, int hkv, int causal) {
  constexpr int LD = tp::QKV_LD<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* dOs = Qs + BQ * LD;
  bf16* Ks = dOs + BQ * LD;
  bf16* Vs = Ks + BK * LD;
  float* S = reinterpret_cast<float*>(Vs + BK * LD);
  float* dP = S + BQ * SF_LD;
  bf16* dS = reinterpret_cast<bf16*>(dP + BQ * SF_LD);
  float* row_lse = reinterpret_cast<float*>(dS + BQ * PB_LD);
  float* row_delta = row_lse + BQ;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // heaviest tiles first
  const int bh = blockIdx.y;
  const int b = bh / h, head = bh % h;
  const int kv_head = head / (h / hkv);
  const long q_stride = (long)h * D, kv_stride = (long)hkv * D;
  const bf16* qp = q + (long)b * tq * q_stride + (long)head * D;
  const bf16* dop = dout + (long)b * tq * q_stride + (long)head * D;
  const bf16* kp = k + (long)b * tk * kv_stride + (long)kv_head * D;
  const bf16* vp = v + (long)b * tk * kv_stride + (long)kv_head * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = warp * 16;
  const int shift = tk - tq;
  const float scale = rsqrtf((float)D);

  tp::load_rows<D>(Qs, qp, q_stride, q0, tq, BQ);
  tp::load_rows<D>(dOs, dop, q_stride, q0, tq, BQ);
  if (threadIdx.x < BQ) {
    const int qi = q0 + threadIdx.x;
    row_lse[threadIdx.x] = qi < tq ? lse[(long)bh * tq + qi] : INFINITY;
    row_delta[threadIdx.x] = qi < tq ? delta[(long)bh * tq + qi] : 0.f;
  }
  int kend = tk;
  if (causal) kend = min(tk, q0 + BQ + shift);
  const int num_kt = kend > 0 ? (kend + BK - 1) / BK : 0;
  AccFrag acc[D / 16];
#pragma unroll
  for (int nt = 0; nt < D / 16; ++nt) wmma::fill_fragment(acc[nt], 0.f);
  __syncthreads();

  for (int kt = 0; kt < num_kt; ++kt) {
    const int k0 = kt * BK;
    tp::load_rows<D>(Ks, kp, kv_stride, k0, tk, BK);
    tp::load_rows<D>(Vs, vp, kv_stride, k0, tk, BK);
    __syncthreads();

    rows_times_rows_t<D>(Qs + r0 * LD, LD, Ks, LD, S + r0 * SF_LD);    // S = Q K^T
    rows_times_rows_t<D>(dOs + r0 * LD, LD, Vs, LD, dP + r0 * SF_LD);  // dP = dO V^T
    __syncwarp();

    // the bias of this lane's two keys (never read past tk)
    float kb[2] = {0.f, 0.f};
    if constexpr (BIAS) {
#pragma unroll
      for (int j = 0; j < 2; ++j)
        if (k0 + lane + 32 * j < tk) kb[j] = bias[(long)head * tk + k0 + lane + 32 * j];
    }

    // dS = P (dP - delta); lane holds keys lane and lane + 32 of each row
    for (int r = r0; r < r0 + 16; ++r) {
      const int qi = q0 + r;
      const float l = row_lse[r], dl = row_delta[r];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = lane + 32 * j, kj = k0 + c;
        const bool ok = kj < tk && (!causal || kj <= qi + shift);
        float x = S[r * SF_LD + c] * scale;
        if constexpr (BIAS) x += kb[j];
        const float p = ok ? expf(x - l) : 0.f;
        dS[r * PB_LD + c] = __float2bfloat16(p * (dP[r * SF_LD + c] - dl));
      }
    }
    __syncwarp();

    accumulate<D>(acc, dS + r0 * PB_LD, Ks, LD);  // dq += dS K
    __syncthreads();  // every warp is done with Ks/Vs before the next load
  }
  store_rows<D>(acc, S + r0 * SF_LD, dq + (long)b * tq * q_stride + (long)head * D, q_stride,
                q0 + r0, tq, scale);
}

template <int D, bool BIAS>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         const float* __restrict__ bias, bf16* __restrict__ dk,
                         bf16* __restrict__ dv, int tq, int tk, int h, int hkv, int causal) {
  constexpr int LD = tp::QKV_LD<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + BK * LD;
  bf16* Qs = Vs + BK * LD;
  bf16* dOs = Qs + BQ * LD;
  float* St = reinterpret_cast<float*>(dOs + BQ * LD);
  float* dPt = St + BK * SF_LD;
  bf16* Pt = reinterpret_cast<bf16*>(dPt + BK * SF_LD);
  bf16* dSt = Pt + BK * PB_LD;
  float* row_lse = reinterpret_cast<float*>(dSt + BK * PB_LD);
  float* row_delta = row_lse + BQ;

  const int k0 = blockIdx.x * BK;  // the first key tiles see the most queries
  const int bkv = blockIdx.y;
  const int b = bkv / hkv, kv_head = bkv % hkv;
  const int group = h / hkv;
  const long q_stride = (long)h * D, kv_stride = (long)hkv * D;
  const long kv_off = (long)b * tk * kv_stride + (long)kv_head * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = warp * 16;
  const int shift = tk - tq;
  const float scale = rsqrtf((float)D);

  tp::load_rows<D>(Ks, k + kv_off, kv_stride, k0, tk, BK);
  tp::load_rows<D>(Vs, v + kv_off, kv_stride, k0, tk, BK);
  AccFrag dk_acc[D / 16], dv_acc[D / 16];
#pragma unroll
  for (int nt = 0; nt < D / 16; ++nt) {
    wmma::fill_fragment(dk_acc[nt], 0.f);
    wmma::fill_fragment(dv_acc[nt], 0.f);
  }
  // query tiles before the first one that can see key k0 are skipped
  const int qt0 = causal ? max(0, k0 - shift) / BQ : 0;
  const int num_qt = (tq + BQ - 1) / BQ;

  for (int g = 0; g < group; ++g) {
    const int head = kv_head * group + g;
    const long bh = (long)b * h + head;
    // lane l < 16 holds the bias of this warp's key row r0 + l (0 past tk)
    float row_bias = 0.f;
    if constexpr (BIAS) {
      const int kj = k0 + r0 + lane;
      if (lane < 16 && kj < tk) row_bias = bias[(long)head * tk + kj];
    }
    const bf16* qp = q + (long)b * tq * q_stride + (long)head * D;
    const bf16* dop = dout + (long)b * tq * q_stride + (long)head * D;
    for (int qt = qt0; qt < num_qt; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();  // every warp is done with the previous Q/dO tile
      tp::load_rows<D>(Qs, qp, q_stride, q0, tq, BQ);
      tp::load_rows<D>(dOs, dop, q_stride, q0, tq, BQ);
      if (threadIdx.x < BQ) {
        const int qi = q0 + threadIdx.x;
        row_lse[threadIdx.x] = qi < tq ? lse[bh * tq + qi] : INFINITY;
        row_delta[threadIdx.x] = qi < tq ? delta[bh * tq + qi] : 0.f;
      }
      __syncthreads();

      rows_times_rows_t<D>(Ks + r0 * LD, LD, Qs, LD, St + r0 * SF_LD);    // S^T = K Q^T
      rows_times_rows_t<D>(Vs + r0 * LD, LD, dOs, LD, dPt + r0 * SF_LD);  // dP^T = V dO^T
      __syncwarp();

      // P^T and dS^T; lane holds queries lane and lane + 32 of each key row
      for (int r = r0; r < r0 + 16; ++r) {
        const int kj = k0 + r;
        float kb = 0.f;  // the bias of key kj, the same for the whole row
        if constexpr (BIAS) kb = __shfl_sync(0xffffffffu, row_bias, r - r0);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int c = lane + 32 * j, qi = q0 + c;
          const bool ok = kj < tk && qi < tq && (!causal || kj <= qi + shift);
          float x = St[r * SF_LD + c] * scale;
          if constexpr (BIAS) x += kb;
          const float p = ok ? expf(x - row_lse[c]) : 0.f;
          Pt[r * PB_LD + c] = __float2bfloat16(p);
          dSt[r * PB_LD + c] = __float2bfloat16(p * (dPt[r * SF_LD + c] - row_delta[c]));
        }
      }
      __syncwarp();

      accumulate<D>(dv_acc, Pt + r0 * PB_LD, dOs, LD);  // dv += P^T dO
      accumulate<D>(dk_acc, dSt + r0 * PB_LD, Qs, LD);  // dk += dS^T Q
    }
  }
  store_rows<D>(dk_acc, St + r0 * SF_LD, dk + kv_off, kv_stride, k0 + r0, tk, scale);
  store_rows<D>(dv_acc, St + r0 * SF_LD, dv + kv_off, kv_stride, k0 + r0, tk, 1.f);
}

template <int D, bool BIAS>
int launch(const void* q, const void* k, const void* v, const void* o, const void* lse,
           const void* dout, const void* bias, void* dq, void* dk, void* dv, void* delta, int n,
           int tq, int tk, int h, int hkv, int causal, cudaStream_t stream) {
  const auto* biasf = static_cast<const float*>(bias);
  const auto* qb = static_cast<const bf16*>(q);
  const auto* kb = static_cast<const bf16*>(k);
  const auto* vb = static_cast<const bf16*>(v);
  const auto* dob = static_cast<const bf16*>(dout);
  const auto* lsef = static_cast<const float*>(lse);
  auto* deltaf = static_cast<float*>(delta);
  const long rows = (long)n * tq * h;
  if (rows > 0) {
    const long blocks = (rows + THREADS / 32 - 1) / (THREADS / 32);
    flash_bwd_delta_kernel<D><<<(unsigned)blocks, THREADS, 0, stream>>>(
        static_cast<const bf16*>(o), dob, deltaf, rows, tq, h);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;

    const size_t smem = dq_smem_bytes<D>();
    e = cudaFuncSetAttribute(flash_bwd_dq_kernel<D, BIAS>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    dim3 grid((tq + BQ - 1) / BQ, n * h);
    flash_bwd_dq_kernel<D, BIAS><<<grid, THREADS, smem, stream>>>(
        qb, kb, vb, dob, lsef, deltaf, biasf, static_cast<bf16*>(dq), tq, tk, h, hkv, causal);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  if ((long)n * tk * hkv > 0) {
    const size_t smem = dkv_smem_bytes<D>();
    cudaError_t e = cudaFuncSetAttribute(
        flash_bwd_dkv_kernel<D, BIAS>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    dim3 grid((tk + BK - 1) / BK, n * hkv);
    flash_bwd_dkv_kernel<D, BIAS><<<grid, THREADS, smem, stream>>>(
        qb, kb, vb, dob, lsef, deltaf, biasf, static_cast<bf16*>(dk), static_cast<bf16*>(dv),
        tq, tk, h, hkv, causal);
    return (int)cudaGetLastError();
  }
  return 0;
}

}  // namespace

// q, o, dout, dq: [n, tq, h, d] bf16; k, v, dk, dv: [n, tk, hkv, d] bf16;
// lse and the delta workspace: [n*h, tq] f32; bias: null, or the forward's
// key-only bias as [h, tk] f32; all contiguous, h % hkv == 0, d = 128 only
// (Vicuna-7B, MPT-7B). Returns 0, a cudaError_t code, or -1 for an
// unsupported head_dim.
extern "C" int tp_flash_bwd(const void* q, const void* k, const void* v, const void* o,
                            const void* lse, const void* dout, const void* bias, void* dq,
                            void* dk, void* dv, void* delta, int n, int tq, int tk, int h,
                            int hkv, int d, int causal, void* stream) {
  if (d != 128) return -1;
  const auto st = static_cast<cudaStream_t>(stream);
  if (bias != nullptr)
    return launch<128, true>(q, k, v, o, lse, dout, bias, dq, dk, dv, delta, n, tq, tk, h, hkv,
                             causal, st);
  return launch<128, false>(q, k, v, o, lse, dout, bias, dq, dk, dv, delta, n, tq, tk, h, hkv,
                            causal, st);
}
