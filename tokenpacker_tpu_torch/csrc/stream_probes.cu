// The card probes P1-P4: how fast a weight stream runs on the H100, by
// layout (P1), by storage (P2: int4 nibbles with their unpack; P3: int8
// rows packed into 16-bit pairs) and by load width and element type (P4).
//
// Replaces the Pallas probes of scripts/: probe_dma_stride.py:run (P1),
// probe_int4_ring.py:run (P2), probe_bitcast_pack.py:semantics (P3a) and
// :stream (P3b), probe_stream_dtype.py:run (P4). On the TPU each streamed
// the weights through a two-slot VMEM ring of DMAs; here there is no
// software ring to copy: every block streams its own rows from device
// memory, and the card's many warps in flight take the ring's place.
//
// What bounds them: bytes. Each probe is built to read every byte it
// streams and to give a definite value, so that nvcc keeps every load and
// a check can hold it against the plain version:
//   stream_sum    P1 and P4: the wrapping 32-bit sum of the streamed
//                 elements' bit patterns (zero-extended), loaded LOAD bytes
//                 at a time (1, 2 or 4: the element's own width; 16: the
//                 width of the port's GEMVs); one atomicAdd a warp, in
//                 integers, so every call gives the same bits. P4 also
//                 returns scale * sum(x), the TPU kernel's value under
//                 TOKENPACKER_FD_DEBUG=nodot.
//   gemv_chain    P2 and P3b: sum over the streamed layers of rowsum(x @
//                 W[li % L]) over the first ncols_gemv columns, a GEMV of
//                 B rows (fp32 FMAs, per-column sums), and the wrapping sum
//                 of the bytes of the other columns (P3b streams all 12288
//                 and multiplies 4096). Weights: int8 rows; int4 nibbles,
//                 plane-split per 512-row chunk (source rows c*256 + j give
//                 W rows c*512 + j from the high nibble and c*512 + 256 + j
//                 from the low); or int8 rows packed in pairs into 16 bits
//                 (low byte row 2r, high byte row 2r + 1). Bytes become
//                 floats in registers: XOR and a byte permute build the
//                 float 2^23 + byte, one subtraction removes the offset.
//                 Each block writes its sum; a second pass adds them in
//                 one fixed order (in double), so two calls agree.
//   pack_rows     P3a: int8 [2R, C] -> u16 [R, C], low byte row 2r, and
//                 its inverse: the packing that pltpu.bitcast gives on the
//                 TPU (interleaved row pairs).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int CK = 512;  // W rows a chain block takes: the scripts' chunk

// ---------------------------------------------------------------------------
// stream_sum (P1, P4)

template <int LOAD, int ELEM>
__device__ __forceinline__ unsigned load_sum(const unsigned char* p) {
  if constexpr (LOAD == 1) {
    return *p;
  } else if constexpr (LOAD == 2) {
    return *reinterpret_cast<const unsigned short*>(p);
  } else if constexpr (LOAD == 4) {
    return *reinterpret_cast<const unsigned*>(p);
  } else {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    if constexpr (ELEM == 4) return v.x + v.y + v.z + v.w;
    if constexpr (ELEM == 2)
      return __vsadu2(v.x, 0u) + __vsadu2(v.y, 0u) + __vsadu2(v.z, 0u) + __vsadu2(v.w, 0u);
    return __vsadu4(v.x, 0u) + __vsadu4(v.y, 0u) + __vsadu4(v.z, 0u) + __vsadu4(v.w, 0u);
  }
}

// x element i of the kind the wrapper names: 0 int8, 1 int16, 2 uint16,
// 3 int32, 4 bf16
__device__ __forceinline__ double x_elem(const void* x, int kind, int i) {
  switch (kind) {
    case 0: return (double)static_cast<const signed char*>(x)[i];
    case 1: return (double)static_cast<const short*>(x)[i];
    case 2: return (double)static_cast<const unsigned short*>(x)[i];
    case 3: return (double)static_cast<const int*>(x)[i];
    default: return (double)__bfloat162float(static_cast<const __nv_bfloat16*>(x)[i]);
  }
}

__device__ __forceinline__ double warp_sum_d(double s) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

// Chunk ci (of total_rows / rows_per_chunk) is chunk ci % nchunks of copy
// (ci / nchunks) % ncopies: rows_per_chunk rows of row_bytes, row_pitch
// apart. One warp a row, the warps striding over all rows.
template <int LOAD, int ELEM>
__global__ void __launch_bounds__(THREADS)
    stream_sum_kernel(const unsigned char* __restrict__ src, long row_pitch, long chunk_pitch,
                      long copy_pitch, int rows_per_chunk, int nchunks, int ncopies,
                      int row_bytes, long total_rows, unsigned* __restrict__ checksum,
                      const void* __restrict__ x, int x_kind, int x_count, double value_scale,
                      float* __restrict__ value, int value_rows) {
  __shared__ double red[WARPS];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if (value != nullptr && blockIdx.x == 0) {
    double s = 0.0;
    for (int i = threadIdx.x; i < x_count; i += THREADS) s += x_elem(x, x_kind, i);
    s = warp_sum_d(s);
    if (lane == 0) red[warp] = s;
    __syncthreads();
    if (threadIdx.x == 0) {
      double total = 0.0;
      for (int i = 0; i < WARPS; ++i) total += red[i];
      for (int b = 0; b < value_rows; ++b) value[b] = (float)(value_scale * total);
    }
  }
  const int nvec = row_bytes / LOAD;
  const long nwarps = (long)gridDim.x * WARPS;
  unsigned acc = 0u;
  for (long r = (long)blockIdx.x * WARPS + warp; r < total_rows; r += nwarps) {
    const long ci = r / rows_per_chunk;
    const long rr = r - ci * rows_per_chunk;
    const unsigned char* row = src + ((ci / nchunks) % ncopies) * copy_pitch +
                               (ci % nchunks) * chunk_pitch + rr * row_pitch;
#pragma unroll 4
    for (int c = lane; c < nvec; c += 32) acc += load_sum<LOAD, ELEM>(row + (long)c * LOAD);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if (lane == 0) atomicAdd(checksum, acc);
}

template <int LOAD, int ELEM>
int launch_stream(const void* src, long row_pitch, long chunk_pitch, long copy_pitch,
                  int rows_per_chunk, int nchunks, int ncopies, int row_bytes, int reps,
                  void* checksum, const void* x, int x_kind, int x_count, double value_scale,
                  void* value, int value_rows, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long total_rows = (long)reps * rows_per_chunk;
  long blocks = (total_rows + WARPS - 1) / WARPS;
  if (blocks > 8L * sms) blocks = 8L * sms;
  if (blocks < 1) blocks = 1;
  stream_sum_kernel<LOAD, ELEM><<<(unsigned)blocks, THREADS, 0, stream>>>(
      static_cast<const unsigned char*>(src), row_pitch, chunk_pitch, copy_pitch,
      rows_per_chunk, nchunks, ncopies, row_bytes, total_rows, static_cast<unsigned*>(checksum),
      x, x_kind, x_count, value_scale, static_cast<float*>(value), value_rows);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// gemv_chain (P2, P3b)

enum ChainMode { CHAIN_INT8 = 0, CHAIN_INT4 = 1, CHAIN_PACKED = 2 };

// byte i of u (which holds a value + the offset) as the float value:
// bits 0x4B0000XX are 2^23 + XX
__device__ __forceinline__ float byte_value(unsigned u, int i, float offset) {
  return __int_as_float((int)__byte_perm(u, 0x4B000000u, 0x7650u | i)) - offset;
}

constexpr float INT8_OFF = 8388608.f + 128.f;  // int8 b stored as b + 128
constexpr float INT4_OFF = 8388608.f + 8.f;    // int4 n stored as n + 8

// bytes a thread loads a row: at most 64 accumulators
template <int MODE, int B>
__host__ __device__ constexpr int chain_vec() {
  return (MODE == CHAIN_PACKED || B * 16 <= 64) ? 16 : 8;
}

// output columns a thread owns
template <int MODE, int VEC>
__host__ __device__ constexpr int chain_cols() {
  return MODE == CHAIN_PACKED ? VEC / 2 : VEC;
}

template <int VEC>
__device__ __forceinline__ void load_words(const unsigned char* p, unsigned (&wd)[VEC / 4]) {
  if constexpr (VEC == 16) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    wd[0] = v.x, wd[1] = v.y, wd[2] = v.z, wd[3] = v.w;
  } else {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    wd[0] = v.x, wd[1] = v.y;
  }
}

// Grid (column blocks, k / CK, streamed layers): a block takes the W rows
// [kc * CK, (kc + 1) * CK) of layer li % layers over THREADS * COLS
// columns. A block of the first ncols_gemv columns multiplies and writes
// its sum of x @ W per row b to partials; a block past them adds its
// bytes to the checksum.
template <int B, int MODE, int VEC>
__global__ void __launch_bounds__(THREADS)
    gemv_chain_kernel(const __nv_bfloat16* __restrict__ x, const unsigned char* __restrict__ w,
                      int k, int n, int layers, int ncols_gemv, float* __restrict__ partials,
                      unsigned* __restrict__ checksum) {
  constexpr int WORDS = VEC / 4;
  constexpr int COLS = chain_cols<MODE, VEC>();
  constexpr int SPAN = THREADS * COLS;
  constexpr int SRC_ROWS = MODE == CHAIN_INT8 ? CK : CK / 2;
  __shared__ float xs[B][CK];
  __shared__ float red[WARPS][B];
  const int cb = blockIdx.x, kc = blockIdx.y, li = blockIdx.z;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const long row_pitch = MODE == CHAIN_PACKED ? 2L * n : (long)n;
  const long src_rows = MODE == CHAIN_INT8 ? k : k / 2;
  const unsigned char* p = w + ((long)(li % layers) * src_rows + (long)kc * SRC_ROWS) * row_pitch +
                           ((long)cb * THREADS + threadIdx.x) * VEC;
  unsigned wd[WORDS];

  if (cb * SPAN >= ncols_gemv) {  // checksum columns: every byte read, none multiplied
    unsigned u = 0u;
#pragma unroll 4
    for (int r = 0; r < SRC_ROWS; ++r) {
      load_words<VEC>(p + r * row_pitch, wd);
#pragma unroll
      for (int j = 0; j < WORDS; ++j) u += __vsadu4(wd[j], 0u);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) u += __shfl_xor_sync(0xffffffffu, u, o);
    if (lane == 0) atomicAdd(checksum, u);
    return;
  }

  for (int i = threadIdx.x; i < B * CK; i += THREADS)
    xs[i / CK][i % CK] = __bfloat162float(x[(long)(i / CK) * k + (long)kc * CK + i % CK]);
  __syncthreads();

  float acc[B][COLS];
#pragma unroll
  for (int b = 0; b < B; ++b)
#pragma unroll
    for (int c = 0; c < COLS; ++c) acc[b][c] = 0.f;

#pragma unroll 4
  for (int r = 0; r < SRC_ROWS; ++r) {
    load_words<VEC>(p + r * row_pitch, wd);
#pragma unroll
    for (int j = 0; j < WORDS; ++j) {
      if constexpr (MODE == CHAIN_INT8) {
        const unsigned u = wd[j] ^ 0x80808080u;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float wv = byte_value(u, i, INT8_OFF);
#pragma unroll
          for (int b = 0; b < B; ++b) acc[b][4 * j + i] = fmaf(xs[b][r], wv, acc[b][4 * j + i]);
        }
      } else if constexpr (MODE == CHAIN_INT4) {
        const unsigned hi = ((wd[j] >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u;
        const unsigned lo = (wd[j] & 0x0F0F0F0Fu) ^ 0x08080808u;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float hv = byte_value(hi, i, INT4_OFF), lv = byte_value(lo, i, INT4_OFF);
#pragma unroll
          for (int b = 0; b < B; ++b)
            acc[b][4 * j + i] =
                fmaf(xs[b][CK / 2 + r], lv, fmaf(xs[b][r], hv, acc[b][4 * j + i]));
        }
      } else {  // bytes: (row 2r, col 2j), (2r + 1, 2j), (2r, 2j + 1), (2r + 1, 2j + 1)
        const unsigned u = wd[j] ^ 0x80808080u;
        const float w0 = byte_value(u, 0, INT8_OFF), w1 = byte_value(u, 1, INT8_OFF);
        const float w2 = byte_value(u, 2, INT8_OFF), w3 = byte_value(u, 3, INT8_OFF);
#pragma unroll
        for (int b = 0; b < B; ++b) {
          const float x0 = xs[b][2 * r], x1 = xs[b][2 * r + 1];
          acc[b][2 * j] = fmaf(x1, w1, fmaf(x0, w0, acc[b][2 * j]));
          acc[b][2 * j + 1] = fmaf(x1, w3, fmaf(x0, w2, acc[b][2 * j + 1]));
        }
      }
    }
  }

  // the block's sum of its columns, per row b, in one fixed order
#pragma unroll
  for (int b = 0; b < B; ++b) {
    float s = 0.f;
#pragma unroll
    for (int c = 0; c < COLS; ++c) s += acc[b][c];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) red[warp][b] = s;
  }
  __syncthreads();
  if (threadIdx.x < B) {
    float s = 0.f;
    for (int i = 0; i < WARPS; ++i) s += red[i][threadIdx.x];
    const long blk = ((long)li * gridDim.y + kc) * (ncols_gemv / SPAN) + cb;
    partials[blk * B + threadIdx.x] = s;
  }
}

// out[b] = the sum of partials[i * rows + b] over i, in double, one order
__global__ void __launch_bounds__(THREADS)
    reduce_partials_kernel(const float* __restrict__ partials, long count, int rows,
                           float* __restrict__ out) {
  __shared__ double red[WARPS];
  const int b = blockIdx.x;
  double s = 0.0;
  for (long i = threadIdx.x; i < count; i += THREADS) s += partials[i * rows + b];
  s = warp_sum_d(s);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    double total = 0.0;
    for (int i = 0; i < WARPS; ++i) total += red[i];
    out[b] = (float)total;
  }
}

template <int B, int MODE>
long chain_partials(int k, int ncols_gemv, int reps) {
  constexpr int SPAN = THREADS * chain_cols<MODE, chain_vec<MODE, B>()>();
  return (long)reps * (k / CK) * (ncols_gemv / SPAN);
}

template <int B, int MODE>
int launch_chain(const void* x, const void* w, void* partials, void* value, void* checksum,
                 int k, int n, int layers, int reps, int ncols_gemv, cudaStream_t stream) {
  constexpr int VEC = chain_vec<MODE, B>();
  constexpr int SPAN = THREADS * chain_cols<MODE, VEC>();
  if (k % CK || n % SPAN || ncols_gemv % SPAN || ncols_gemv > n || ncols_gemv < SPAN ||
      reps < 1 || reps > 65535 || layers < 1)
    return -1;
  dim3 grid(n / SPAN, k / CK, reps);
  gemv_chain_kernel<B, MODE, VEC><<<grid, THREADS, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const unsigned char*>(w), k, n, layers,
      ncols_gemv, static_cast<float*>(partials), static_cast<unsigned*>(checksum));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  reduce_partials_kernel<<<B, THREADS, 0, stream>>>(static_cast<const float*>(partials),
                                                    chain_partials<B, MODE>(k, ncols_gemv, reps),
                                                    B, static_cast<float*>(value));
  return (int)cudaGetLastError();
}

template <int MODE>
int chain_by_rows(int b, const void* x, const void* w, void* partials, void* value,
                  void* checksum, int k, int n, int layers, int reps, int ncols_gemv,
                  cudaStream_t stream) {
  switch (b) {
#define TP_CHAIN(R)                                                                      \
  return launch_chain<R, MODE>(x, w, partials, value, checksum, k, n, layers, reps, \
                               ncols_gemv, stream)
    case 1: TP_CHAIN(1);
    case 2: TP_CHAIN(2);
    case 4: TP_CHAIN(4);
    case 8: TP_CHAIN(8);
#undef TP_CHAIN
    default: return -1;
  }
}

template <int MODE>
long partials_by_rows(int b, int k, int ncols_gemv, int reps) {
  switch (b) {
    case 1: return chain_partials<1, MODE>(k, ncols_gemv, reps);
    case 2: return chain_partials<2, MODE>(k, ncols_gemv, reps);
    case 4: return chain_partials<4, MODE>(k, ncols_gemv, reps);
    case 8: return chain_partials<8, MODE>(k, ncols_gemv, reps);
    default: return -1;
  }
}

// ---------------------------------------------------------------------------
// pack_rows / unpack_rows (P3a): one thread, 4 columns of one pair of rows

__global__ void __launch_bounds__(THREADS)
    pack_rows_kernel(const unsigned char* __restrict__ src, unsigned short* __restrict__ dst,
                     long pairs, int c) {
  const long i = (long)blockIdx.x * THREADS + threadIdx.x;
  const int c4 = c / 4;
  if (i >= pairs * c4) return;
  const long r = i / c4;
  const int col = (int)(i % c4) * 4;
  const uchar4 lo = *reinterpret_cast<const uchar4*>(src + 2 * r * c + col);
  const uchar4 hi = *reinterpret_cast<const uchar4*>(src + (2 * r + 1) * c + col);
  ushort4 o;
  o.x = (unsigned short)(lo.x | (hi.x << 8));
  o.y = (unsigned short)(lo.y | (hi.y << 8));
  o.z = (unsigned short)(lo.z | (hi.z << 8));
  o.w = (unsigned short)(lo.w | (hi.w << 8));
  *reinterpret_cast<ushort4*>(dst + r * c + col) = o;
}

__global__ void __launch_bounds__(THREADS)
    unpack_rows_kernel(const unsigned short* __restrict__ src, unsigned char* __restrict__ dst,
                       long pairs, int c) {
  const long i = (long)blockIdx.x * THREADS + threadIdx.x;
  const int c4 = c / 4;
  if (i >= pairs * c4) return;
  const long r = i / c4;
  const int col = (int)(i % c4) * 4;
  const ushort4 v = *reinterpret_cast<const ushort4*>(src + r * c + col);
  *reinterpret_cast<uchar4*>(dst + 2 * r * c + col) =
      make_uchar4(v.x & 0xFF, v.y & 0xFF, v.z & 0xFF, v.w & 0xFF);
  *reinterpret_cast<uchar4*>(dst + (2 * r + 1) * c + col) =
      make_uchar4(v.x >> 8, v.y >> 8, v.z >> 8, v.w >> 8);
}

}  // namespace

// P1, P4. src: chunks as described at stream_sum_kernel, every row start
// `load_bytes` aligned; checksum: u32 [1], zeroed by the caller; x (null:
// no value) [x_count] of x_kind; value: f32 [value_rows], each set to
// value_scale * sum(x). load_bytes is elem_bytes (1, 2, 4) or 16 (elem
// 1, 2, 4). Returns 0, a cudaError_t code, or -1 for what it does not take.
extern "C" int tp_probe_stream_sum(const void* src, long long row_pitch, long long chunk_pitch,
                                   long long copy_pitch, int rows_per_chunk, int nchunks,
                                   int ncopies, int row_bytes, int reps, int load_bytes,
                                   int elem_bytes, void* checksum, const void* x, int x_kind,
                                   int x_count, double value_scale, void* value, int value_rows,
                                   void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  if (row_bytes % load_bytes || row_pitch % load_bytes || chunk_pitch % load_bytes ||
      copy_pitch % load_bytes || reinterpret_cast<uintptr_t>(src) % load_bytes ||
      rows_per_chunk < 1 || nchunks < 1 || ncopies < 1 || reps < 1)
    return -1;
  const long rp = (long)row_pitch, cp = (long)chunk_pitch, op = (long)copy_pitch;
#define TP_STREAM(L, E)                                                                        \
  return launch_stream<L, E>(src, rp, cp, op, rows_per_chunk, nchunks, ncopies, row_bytes,     \
                             reps, checksum, x, x_kind, x_count, value_scale, value,           \
                             value_rows, st)
  if (load_bytes == elem_bytes) {
    if (load_bytes == 1) TP_STREAM(1, 1);
    if (load_bytes == 2) TP_STREAM(2, 2);
    if (load_bytes == 4) TP_STREAM(4, 4);
  }
  if (load_bytes == 16) {
    if (elem_bytes == 1) TP_STREAM(16, 1);
    if (elem_bytes == 2) TP_STREAM(16, 2);
    if (elem_bytes == 4) TP_STREAM(16, 4);
  }
#undef TP_STREAM
  return -1;
}

// P2, P3b. x: bf16 [b, k]; w: the layers' source (mode 0 int8 [L, k, n];
// 1 int4 planes [L, k/2, n]; 2 packed pairs [L, k/2, n] u16); partials:
// f32 [tp_probe_gemv_chain_partials(...) * b]; value: f32 [b]; checksum:
// u32 [1], zeroed by the caller. b in {1, 2, 4, 8}, k % 512 == 0, n and
// ncols_gemv multiples of the block's columns (4096 or 2048), reps <=
// 65535. Returns 0, a cudaError_t code, or -1.
extern "C" int tp_probe_gemv_chain(const void* x, const void* w, void* partials, void* value,
                                   void* checksum, int b, int k, int n, int layers, int reps,
                                   int ncols_gemv, int mode, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case CHAIN_INT8:
      return chain_by_rows<CHAIN_INT8>(b, x, w, partials, value, checksum, k, n, layers, reps,
                                       ncols_gemv, st);
    case CHAIN_INT4:
      return chain_by_rows<CHAIN_INT4>(b, x, w, partials, value, checksum, k, n, layers, reps,
                                       ncols_gemv, st);
    case CHAIN_PACKED:
      return chain_by_rows<CHAIN_PACKED>(b, x, w, partials, value, checksum, k, n, layers, reps,
                                         ncols_gemv, st);
    default: return -1;
  }
}

// The number of per-block sums tp_probe_gemv_chain writes per row b (-1
// for an unsupported b or mode).
extern "C" long long tp_probe_gemv_chain_partials(int b, int k, int ncols_gemv, int reps,
                                                  int mode) {
  switch (mode) {
    case CHAIN_INT8: return partials_by_rows<CHAIN_INT8>(b, k, ncols_gemv, reps);
    case CHAIN_INT4: return partials_by_rows<CHAIN_INT4>(b, k, ncols_gemv, reps);
    case CHAIN_PACKED: return partials_by_rows<CHAIN_PACKED>(b, k, ncols_gemv, reps);
    default: return -1;
  }
}

// P3a. pack: src int8 [2 * pairs, c] -> dst u16 [pairs, c]; unpack the
// inverse. c % 4 == 0. Returns 0, a cudaError_t code, or -1.
extern "C" int tp_probe_pack_rows(const void* src, void* dst, long long pairs, int c,
                                  void* stream) {
  if (c % 4 || pairs < 1) return -1;
  const long items = (long)pairs * (c / 4);
  pack_rows_kernel<<<(unsigned)((items + THREADS - 1) / THREADS), THREADS, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(src), static_cast<unsigned short*>(dst), (long)pairs, c);
  return (int)cudaGetLastError();
}

extern "C" int tp_probe_unpack_rows(const void* src, void* dst, long long pairs, int c,
                                    void* stream) {
  if (c % 4 || pairs < 1) return -1;
  const long items = (long)pairs * (c / 4);
  unpack_rows_kernel<<<(unsigned)((items + THREADS - 1) / THREADS), THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned short*>(src), static_cast<unsigned char*>(dst), (long)pairs, c);
  return (int)cudaGetLastError();
}
