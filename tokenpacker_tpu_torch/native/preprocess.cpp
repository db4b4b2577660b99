// tokenpacker_tpu_torch native preprocessing library (the port's copy of the
// JAX package's native/preprocess.cpp; the JPEG decoder is compiled only
// with -DTPP_JPEG, where libjpeg's header is present).
//
// The host-side image hot path — bilinear resize (torch `F.interpolate`
// align_corners=false semantics), CLIP normalization, and the HD
// canvas+crop slicing (reference train.py:695-731) — implemented in C++
// with a std::thread pool. This is the framework's "native data loader"
// layer (SURVEY.md §2.6): on a serving host the per-image preprocessing
// otherwise bottlenecks eval/serving pipelines at high batch.
//
// Exposed as a C ABI for ctypes (no pybind11). Built with g++ at first use
// by tokenpacker_tpu_torch/image/native.py into _kernels_build/.
//
// All buffers are float32, CHW layout, C-contiguous.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <functional>
#include <thread>
#include <vector>

namespace {

struct Tap {
  int i0, i1;
  float w0, w1;
};

// torch align_corners=false sampling: pos = (i + 0.5) * scale - 0.5,
// 2-tap triangle with edge clamping.
static void build_taps(int src, int dst, std::vector<Tap>& taps) {
  taps.resize(dst);
  const double scale = static_cast<double>(src) / dst;
  for (int i = 0; i < dst; ++i) {
    double pos = (i + 0.5) * scale - 0.5;
    int i0 = static_cast<int>(std::floor(pos));
    float frac = static_cast<float>(pos - i0);
    int i0c = std::min(std::max(i0, 0), src - 1);
    int i1c = std::min(std::max(i0 + 1, 0), src - 1);
    taps[i] = {i0c, i1c, 1.0f - frac, frac};
  }
}

// resize one channel plane [src_h, src_w] -> [dst_h, dst_w]
static void resize_plane(const float* src, int src_h, int src_w, float* dst,
                         int dst_h, int dst_w, const std::vector<Tap>& row_taps,
                         const std::vector<Tap>& col_taps) {
  // horizontal pass into a scratch row buffer per output row group
  std::vector<float> tmp(static_cast<size_t>(src_h) * dst_w);
  for (int y = 0; y < src_h; ++y) {
    const float* in = src + static_cast<size_t>(y) * src_w;
    float* out = tmp.data() + static_cast<size_t>(y) * dst_w;
    for (int x = 0; x < dst_w; ++x) {
      const Tap& t = col_taps[x];
      out[x] = t.w0 * in[t.i0] + t.w1 * in[t.i1];
    }
  }
  for (int y = 0; y < dst_h; ++y) {
    const Tap& t = row_taps[y];
    const float* r0 = tmp.data() + static_cast<size_t>(t.i0) * dst_w;
    const float* r1 = tmp.data() + static_cast<size_t>(t.i1) * dst_w;
    float* out = dst + static_cast<size_t>(y) * dst_w;
    for (int x = 0; x < dst_w; ++x) {
      out[x] = t.w0 * r0[x] + t.w1 * r1[x];
    }
  }
}

static void parallel_for(int n, int n_threads, const std::function<void(int)>& fn) {
  if (n_threads <= 1 || n <= 1) {
    for (int i = 0; i < n; ++i) fn(i);
    return;
  }
  std::atomic<int> next{0};
  std::vector<std::thread> pool;
  int workers = std::min(n_threads, n);
  pool.reserve(workers);
  for (int t = 0; t < workers; ++t) {
    pool.emplace_back([&] {
      for (int i = next.fetch_add(1); i < n; i = next.fetch_add(1)) fn(i);
    });
  }
  for (auto& th : pool) th.join();
}

}  // namespace

extern "C" {

// Bilinear resize: src [C, src_h, src_w] -> dst [C, dst_h, dst_w].
void tpp_resize_bilinear(const float* src, int c, int src_h, int src_w,
                         float* dst, int dst_h, int dst_w, int n_threads) {
  std::vector<Tap> row_taps, col_taps;
  build_taps(src_h, dst_h, row_taps);
  build_taps(src_w, dst_w, col_taps);
  parallel_for(c, n_threads, [&](int ch) {
    resize_plane(src + static_cast<size_t>(ch) * src_h * src_w, src_h, src_w,
                 dst + static_cast<size_t>(ch) * dst_h * dst_w, dst_h, dst_w,
                 row_taps, col_taps);
  });
}

// uint8 HWC -> normalized float CHW: (x/255 - mean[c]) / std[c].
void tpp_normalize_u8(const uint8_t* src, int h, int w, const float* mean,
                      const float* stdv, float* dst, int n_threads) {
  parallel_for(3, n_threads, [&](int ch) {
    const float m = mean[ch], inv = 1.0f / stdv[ch];
    float* out = dst + static_cast<size_t>(ch) * h * w;
    for (int y = 0; y < h; ++y) {
      const uint8_t* in = src + (static_cast<size_t>(y) * w) * 3 + ch;
      float* o = out + static_cast<size_t>(y) * w;
      for (int x = 0; x < w; ++x) {
        o[x] = (in[static_cast<size_t>(x) * 3] * (1.0f / 255.0f) - m) * inv;
      }
    }
  });
}

// HD slice (reference train.py:695-731): normalized img [3, H, W] ->
// crops [(hb*wb + extra), 3, block, block], row-major, plus a global view
// when hb*wb > 1. fit_h/fit_w: aspect-preserving target inside the canvas
// (computed by the caller to keep grid selection in one place).
// Returns the number of crops written.
int tpp_hd_slice(const float* img, int h, int w, int hb, int wb, int block,
                 int fit_h, int fit_w, int g_fit_h, int g_fit_w, float* out,
                 int n_threads) {
  const int canvas_h = block * hb, canvas_w = block * wb;
  std::vector<float> canvas(static_cast<size_t>(3) * canvas_h * canvas_w, 0.0f);
  // resize into top-left corner of the zero canvas
  {
    std::vector<Tap> row_taps, col_taps;
    build_taps(h, fit_h, row_taps);
    build_taps(w, fit_w, col_taps);
    parallel_for(3, n_threads, [&](int ch) {
      std::vector<float> plane(static_cast<size_t>(fit_h) * fit_w);
      resize_plane(img + static_cast<size_t>(ch) * h * w, h, w, plane.data(),
                   fit_h, fit_w, row_taps, col_taps);
      float* cv = canvas.data() + static_cast<size_t>(ch) * canvas_h * canvas_w;
      for (int y = 0; y < fit_h; ++y) {
        std::memcpy(cv + static_cast<size_t>(y) * canvas_w,
                    plane.data() + static_cast<size_t>(y) * fit_w,
                    sizeof(float) * fit_w);
      }
    });
  }
  const size_t crop_sz = static_cast<size_t>(3) * block * block;
  int n_crops = hb * wb;
  parallel_for(n_crops, n_threads, [&](int idx) {
    int bi = idx / wb, bj = idx % wb;
    float* dst = out + static_cast<size_t>(idx) * crop_sz;
    for (int ch = 0; ch < 3; ++ch) {
      const float* cv = canvas.data() +
                        static_cast<size_t>(ch) * canvas_h * canvas_w +
                        static_cast<size_t>(bi) * block * canvas_w + bj * block;
      float* o = dst + static_cast<size_t>(ch) * block * block;
      for (int y = 0; y < block; ++y) {
        std::memcpy(o + static_cast<size_t>(y) * block,
                    cv + static_cast<size_t>(y) * canvas_w, sizeof(float) * block);
      }
    }
  });
  if (n_crops > 1) {
    // global view: resize the CANVAS (not the original) into a zero block
    float* dst = out + static_cast<size_t>(n_crops) * crop_sz;
    std::memset(dst, 0, sizeof(float) * crop_sz);
    std::vector<Tap> row_taps, col_taps;
    build_taps(canvas_h, g_fit_h, row_taps);
    build_taps(canvas_w, g_fit_w, col_taps);
    parallel_for(3, n_threads, [&](int ch) {
      std::vector<float> plane(static_cast<size_t>(g_fit_h) * g_fit_w);
      resize_plane(canvas.data() + static_cast<size_t>(ch) * canvas_h * canvas_w,
                   canvas_h, canvas_w, plane.data(), g_fit_h, g_fit_w, row_taps,
                   col_taps);
      float* o = dst + static_cast<size_t>(ch) * block * block;
      for (int y = 0; y < g_fit_h; ++y) {
        std::memcpy(o + static_cast<size_t>(y) * block,
                    plane.data() + static_cast<size_t>(y) * g_fit_w,
                    sizeof(float) * g_fit_w);
      }
    });
    ++n_crops;
  }
  return n_crops;
}

// ---------------------------------------------------------------------------
// JPEG decode (libjpeg): the eval/serving loaders' decode hot path.
// ---------------------------------------------------------------------------

// Returns 0 on success; fills h/w/channels. out must hold h*w*3 bytes when
// decoding (pass out=nullptr to probe dimensions only). Output is RGB HWC.
#ifdef TPP_JPEG
int tpp_jpeg_decode(const uint8_t* data, int len, uint8_t* out, long out_cap,
                    int* h, int* w);
#endif

}  // extern "C"

#ifdef TPP_JPEG

#include <csetjmp>
#include <cstdio>
#include <jpeglib.h>

namespace {
struct JpegError {
  jpeg_error_mgr mgr;
  jmp_buf jump;
};
static void jpeg_error_exit(j_common_ptr cinfo) {
  JpegError* err = reinterpret_cast<JpegError*>(cinfo->err);
  longjmp(err->jump, 1);
}
}  // namespace

extern "C" int tpp_jpeg_decode(const uint8_t* data, int len, uint8_t* out,
                               long out_cap, int* h, int* w) {
  jpeg_decompress_struct cinfo;
  JpegError jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_error_exit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<unsigned char*>(data),
               static_cast<unsigned long>(len));
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return -2;
  }
  cinfo.out_color_space = JCS_RGB;
  *h = static_cast<int>(cinfo.image_height);
  *w = static_cast<int>(cinfo.image_width);
  if (out == nullptr) {  // dimension probe
    jpeg_destroy_decompress(&cinfo);
    return 0;
  }
  const long need = static_cast<long>(*h) * (*w) * 3;
  if (out_cap < need) {
    jpeg_destroy_decompress(&cinfo);
    return -3;
  }
  jpeg_start_decompress(&cinfo);
  const int stride = (*w) * 3;
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = out + static_cast<size_t>(cinfo.output_scanline) * stride;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}
#endif  // TPP_JPEG
