// K1: non-causal multi-head attention for the CLIP tower.
//
// Replaces tokenpacker_tpu/ops/vit_attention.py:vit_attention (_kernel),
// which held one image's whole attention in TPU VMEM.
//
// What bounds it on the H100: at ViT-L/14-336 (T=577, 16 heads of d=64)
// each head's logits are 577x577, so the plain path writes and re-reads
// [N,16,577,577] probabilities through device memory; the two products are
// only 2*577*577*64 FLOP per head, well under the tensor cores' rate. The
// kernel keeps the probabilities on chip: grid (64-row query tile, head,
// image), K/V streamed through shared memory in 64-key tiles with an
// online fp32 softmax (attention_tile.cuh), bf16 WMMA with fp32
// accumulate for both products. Each block reads its head's 64-wide slice
// straight out of the natural [N, T, W] rows (128 contiguous bytes per
// row) and writes the output back into the same layout, so no transpose
// copy is made. 577 = 9*64 + 1: the ragged last tile is masked in-kernel.
//
// Numerics follow the TPU kernel: exp2 with log2(e) folded into the scale,
// unnormalized bf16 probabilities in the value product, one divide by
// their sum at the output.

#include "attention_tile.cuh"

namespace {

template <int D>
__global__ void __launch_bounds__(tp::THREADS)
    vit_attention_kernel(const tp::bf16* __restrict__ q, const tp::bf16* __restrict__ k,
                         const tp::bf16* __restrict__ v, tp::bf16* __restrict__ o, int t,
                         int w) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int q0 = blockIdx.x * tp::BQ;
  const long base = (long)blockIdx.z * t * w + (long)blockIdx.y * D;
  tp::attention_tile<D>(q + base, w, k + base, w, v + base, w, o + base, w, nullptr, t, t,
                        q0, false, rsqrtf((float)D), smem);
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int n, int t, int w,
           int heads, cudaStream_t stream) {
  const size_t smem = tp::tile_smem_bytes<D>();
  cudaError_t e = cudaFuncSetAttribute(
      vit_attention_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((t + tp::BQ - 1) / tp::BQ, heads, n);
  vit_attention_kernel<D><<<grid, tp::THREADS, smem, stream>>>(
      static_cast<const tp::bf16*>(q), static_cast<const tp::bf16*>(k),
      static_cast<const tp::bf16*>(v), static_cast<tp::bf16*>(o), t, w);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, o: [n, t, w] bf16 contiguous, w = heads * head_dim.
// head_dim 64 only (CLIP ViT-L). Returns 0, a cudaError_t code, or -1 for
// an unsupported head_dim.
extern "C" int tp_vit_attention(const void* q, const void* k, const void* v, void* o,
                                int n, int t, int w, int heads, void* stream) {
  if (heads <= 0 || w != heads * 64) return -1;
  return launch<64>(q, k, v, o, n, t, w, heads, static_cast<cudaStream_t>(stream));
}

extern "C" const char* tp_error_string(int code) {
  if (code < 0) return "shape not supported by the kernel";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
