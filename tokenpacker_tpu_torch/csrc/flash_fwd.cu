// K2 (forward): flash attention for the LM prefill, with GQA.
//
// Replaces tokenpacker_tpu/ops/flash_attention.py:flash_attention's
// forward (_flash_fwd / _fwd_kernel) and the head repeat of mha_flash.
//
// What bounds it on the H100: at the Vicuna-7B prefill (32 heads of
// d=128, T = prompt bucket) the two products are 4*T^2*d FLOP per head
// against T*d*2*4 bytes of q/k/v/o, so it is bound by the tensor cores
// once T is a few hundred. The plain path instead writes [N,H,T,T] fp32
// logits and probabilities to device memory. The kernel keeps them on
// chip: grid (64-row query tile, batch*head), K/V streamed through shared
// memory in 64-key tiles with an online fp32 softmax and bf16 WMMA for
// both products (attention_tile.cuh). Key tiles wholly above the causal
// diagonal are skipped inside the block's loop, and the heaviest query
// tiles (the last ones) are scheduled first. A query head h reads kv head
// h / (H / Hkv) in place, so GQA never repeats K/V in memory. Ragged T is
// masked in-kernel (no padding of T to the tile or of d to 128).
//
// Returns o and the log-sum-exp per (batch*head, query), +inf for a row
// with no visible key, as the TPU kernel does; the backward needs it.

#include "attention_tile.cuh"

namespace {

template <int D>
__global__ void __launch_bounds__(tp::THREADS)
    flash_fwd_kernel(const tp::bf16* __restrict__ q, const tp::bf16* __restrict__ k,
                     const tp::bf16* __restrict__ v, tp::bf16* __restrict__ o,
                     float* __restrict__ lse, int tq, int tk, int h, int hkv, int causal) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int q0 = (gridDim.x - 1 - blockIdx.x) * tp::BQ;  // heaviest tiles first
  const int bh = blockIdx.y;
  const int b = bh / h, head = bh % h;
  const int kv_head = head / (h / hkv);
  const long q_base = (long)b * tq * h * D + (long)head * D;
  const long kv_base = (long)b * tk * hkv * D + (long)kv_head * D;
  tp::attention_tile<D>(q + q_base, (long)h * D, k + kv_base, (long)hkv * D, v + kv_base,
                        (long)hkv * D, o + q_base, (long)h * D, lse + (long)bh * tq, tq,
                        tk, q0, causal != 0, rsqrtf((float)D), smem);
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, void* lse, int n, int tq,
           int tk, int h, int hkv, int causal, cudaStream_t stream) {
  const size_t smem = tp::tile_smem_bytes<D>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((tq + tp::BQ - 1) / tp::BQ, n * h);
  flash_fwd_kernel<D><<<grid, tp::THREADS, smem, stream>>>(
      static_cast<const tp::bf16*>(q), static_cast<const tp::bf16*>(k),
      static_cast<const tp::bf16*>(v), static_cast<tp::bf16*>(o), static_cast<float*>(lse),
      tq, tk, h, hkv, causal);
  return (int)cudaGetLastError();
}

}  // namespace

// q, o: [n, tq, h, d] bf16; k, v: [n, tk, hkv, d] bf16; lse: [n*h, tq] f32;
// all contiguous, h % hkv == 0, d = 128 only (Vicuna-7B). Returns 0, a
// cudaError_t code, or -1 for an unsupported head_dim.
extern "C" int tp_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                            int n, int tq, int tk, int h, int hkv, int d, int causal,
                            void* stream) {
  if (d != 128) return -1;
  return launch<128>(q, k, v, o, lse, n, tq, tk, h, hkv, causal,
                     static_cast<cudaStream_t>(stream));
}
