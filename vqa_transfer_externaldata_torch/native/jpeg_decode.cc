// Native JPEG decode + resize of the port's raw-image ingest
// (``data/ingest.py``): a whole batch of files decoded in parallel C++
// threads (ctypes releases the GIL for the entire call), where PIL would
// decode one file per GIL-contended worker thread.
//
// Decode: libjpeg (the codec PIL wraps, so pixels at the file's own size
// match PIL's bit for bit). Resize: separable triangle-filter resampling,
// the algorithm of PIL's BILINEAR (Imaging/Resample.c) with float
// accumulation, so resized pixels are within one 8-bit step of PIL's.
//
// Plain C ABI (``vqa_jpeg_abi_version`` 1) loaded with ctypes by
// ``data/native.py``; its own shared object (needs -ljpeg), so the
// dependency-free gather library builds where libjpeg is missing.

#include <algorithm>
#include <cmath>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

#include <jpeglib.h>

#include <atomic>
#include <thread>

namespace {

struct ErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf jb;
};

void error_exit(j_common_ptr cinfo) {
  // The libjpeg default handler calls exit(); longjmp back instead.
  longjmp(reinterpret_cast<ErrorMgr*>(cinfo->err)->jb, 1);
}

void output_message(j_common_ptr) {}  // silence warnings

// Decode one JPEG file to tightly-packed RGB8. Returns true on success and
// sets (w, h); `pixels` is resized to w*h*3.
bool decode_file(const char* path, std::vector<uint8_t>& pixels, int* w,
                 int* h) {
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return false;
  jpeg_decompress_struct cinfo;
  ErrorMgr err;
  cinfo.err = jpeg_std_error(&err.pub);
  err.pub.error_exit = error_exit;
  err.pub.output_message = output_message;
  if (setjmp(err.jb)) {
    jpeg_destroy_decompress(&cinfo);
    std::fclose(fp);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, fp);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;  // grayscale converts; CMYK errors out
  jpeg_start_decompress(&cinfo);
  *w = static_cast<int>(cinfo.output_width);
  *h = static_cast<int>(cinfo.output_height);
  if (cinfo.output_components != 3 || *w <= 0 || *h <= 0) {
    jpeg_destroy_decompress(&cinfo);
    std::fclose(fp);
    return false;
  }
  pixels.resize(static_cast<size_t>(*w) * *h * 3);
  const size_t stride = static_cast<size_t>(*w) * 3;
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = pixels.data() + cinfo.output_scanline * stride;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  std::fclose(fp);
  return true;
}

// Precomputed resampling taps for one axis (PIL Resample.c, triangle
// filter): output pixel i sums src[starts[i] .. starts[i]+counts[i]) with
// normalized weights.
struct Taps {
  std::vector<int> starts;
  std::vector<int> counts;
  std::vector<float> weights;  // [d, kmax] row-major
  int kmax = 0;
};

Taps build_taps(int s, int d) {
  Taps t;
  const double scale = static_cast<double>(s) / d;
  const double fscale = std::max(1.0, scale);
  const double support = 1.0 * fscale;  // triangle filter support
  t.kmax = static_cast<int>(std::ceil(support)) * 2 + 1;
  t.starts.resize(d);
  t.counts.resize(d);
  t.weights.assign(static_cast<size_t>(d) * t.kmax, 0.0f);
  for (int i = 0; i < d; ++i) {
    const double center = (i + 0.5) * scale;
    int xmin = static_cast<int>(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = static_cast<int>(center + support + 0.5);
    if (xmax > s) xmax = s;
    double sum = 0.0;
    float* w = &t.weights[static_cast<size_t>(i) * t.kmax];
    for (int x = xmin; x < xmax; ++x) {
      const double v = 1.0 - std::abs((x + 0.5 - center) / fscale);
      const double tw = v > 0.0 ? v : 0.0;
      w[x - xmin] = static_cast<float>(tw);
      sum += tw;
    }
    if (sum > 0.0) {
      for (int k = 0; k < xmax - xmin; ++k)
        w[k] = static_cast<float>(w[k] / sum);
    }
    t.starts[i] = xmin;
    t.counts[i] = xmax - xmin;
  }
  return t;
}

// Separable triangle resize RGB8 [sh, sw] -> [dh, dw] (horizontal pass to
// a float intermediate, then vertical).
void resize_triangle(const uint8_t* src, int sh, int sw, uint8_t* dst,
                     int dh, int dw) {
  const Taps tx = build_taps(sw, dw);
  const Taps ty = build_taps(sh, dh);
  std::vector<float> mid(static_cast<size_t>(sh) * dw * 3);
  for (int y = 0; y < sh; ++y) {
    const uint8_t* srow = src + static_cast<size_t>(y) * sw * 3;
    float* mrow = mid.data() + static_cast<size_t>(y) * dw * 3;
    for (int i = 0; i < dw; ++i) {
      const float* w = &tx.weights[static_cast<size_t>(i) * tx.kmax];
      float acc[3] = {0.f, 0.f, 0.f};
      const uint8_t* p = srow + static_cast<size_t>(tx.starts[i]) * 3;
      for (int k = 0; k < tx.counts[i]; ++k, p += 3) {
        acc[0] += w[k] * p[0];
        acc[1] += w[k] * p[1];
        acc[2] += w[k] * p[2];
      }
      mrow[i * 3 + 0] = acc[0];
      mrow[i * 3 + 1] = acc[1];
      mrow[i * 3 + 2] = acc[2];
    }
  }
  for (int i = 0; i < dh; ++i) {
    const float* w = &ty.weights[static_cast<size_t>(i) * ty.kmax];
    uint8_t* drow = dst + static_cast<size_t>(i) * dw * 3;
    for (int x = 0; x < dw * 3; ++x) {
      float acc = 0.f;
      const float* m = mid.data() + static_cast<size_t>(ty.starts[i]) * dw * 3 + x;
      for (int k = 0; k < ty.counts[i]; ++k, m += static_cast<size_t>(dw) * 3)
        acc += w[k] * *m;
      const int v = static_cast<int>(acc + 0.5f);
      drow[x] = static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
    }
  }
}

}  // namespace

extern "C" {

// Decode + resize `n` JPEG files into `out` [n, size, size, 3] uint8 RGB.
// status[i]: 0 ok, 1 open/decode failed (caller falls back per image).
void decode_jpeg_batch(const char** paths, int64_t n, int size,
                       uint8_t* out, int32_t* status, int threads) {
  const size_t img_elems = static_cast<size_t>(size) * size * 3;
  std::atomic<int64_t> next(0);
  auto work = [&]() {
    std::vector<uint8_t> pixels;  // reused across this thread's images
    for (;;) {
      const int64_t i = next.fetch_add(1);
      if (i >= n) return;
      int w = 0, h = 0;
      if (!decode_file(paths[i], pixels, &w, &h)) {
        status[i] = 1;
        std::memset(out + i * img_elems, 0, img_elems);
        continue;
      }
      status[i] = 0;
      uint8_t* dst = out + i * img_elems;
      if (w == size && h == size) {
        std::memcpy(dst, pixels.data(), img_elems);
      } else {
        resize_triangle(pixels.data(), h, w, dst, size, size);
      }
    }
  };
  if (threads <= 1 || n < 2) {
    work();
    return;
  }
  std::vector<std::thread> pool;
  const int nt = static_cast<int>(std::min<int64_t>(threads, n));
  pool.reserve(nt);
  for (int t = 0; t < nt; ++t) pool.emplace_back(work);
  for (auto& th : pool) th.join();
}

int vqa_jpeg_abi_version() { return 1; }

}  // extern "C"
