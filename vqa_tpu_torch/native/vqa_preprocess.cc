// vqa_preprocess.cc — native host-side image preprocessing for the
// PyTorch/CUDA port (vqa_tpu_torch).
//
// The port's own copy of vqa_tpu/native/vqa_preprocess.cc, built by the
// port (vqa_tpu_torch/native/__init__.py) into vqa_tpu_torch/build/. The
// serving and data paths decode with PIL and resize here:
//
//   * vqa_resize_bilinear_u8        — single-image resize, BIT-IDENTICAL to
//     PIL's Image.resize(..., BILINEAR): the same two-pass (horizontal then
//     vertical) separable triangle-filter resample with 22-bit fixed-point
//     coefficients and the same rounding, so switching between this path
//     and PIL never changes the pixels the model sees.
//   * vqa_resize_bilinear_u8_batch  — batched resize across a thread pool.
//   * vqa_normalize_f32             — fused uint8→float32 /255 + per-channel
//     mean/std normalize (the host-side parity path; the serving path
//     ships uint8 to the card and normalizes there).
//
// Build: g++ -O3 -std=c++17 -shared -fPIC -pthread.
// Python binding: vqa_tpu_torch/native/__init__.py (ctypes).

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr int kPrecisionBits = 32 - 8 - 2;  // 22: PIL's 8bpc fixed point

// Normalized coefficients sum to ~1<<22 and pixels are ≤255, so the
// accumulator (with the rounding half) stays within int32 — same bound PIL
// relies on for its 8-bit-per-channel fixed-point path.
inline uint8_t clip8(int32_t v) {
  if (v >= (1 << kPrecisionBits << 8)) return 255;
  if (v <= 0) return 0;
  return static_cast<uint8_t>(v >> kPrecisionBits);
}

inline double triangle_filter(double x) {
  if (x < 0.0) x = -x;
  return x < 1.0 ? 1.0 - x : 0.0;
}

// Precompute normalized fixed-point filter coefficients for one axis.
// Returns ksize (coefficients per output element); bounds[i] = {first input
// index, count} for output element i; kk = ksize coeffs per output element.
int precompute_coeffs(int in_size, int out_size, std::vector<int>& bounds,
                      std::vector<int32_t>& kk) {
  const double scale = static_cast<double>(in_size) / out_size;
  const double filterscale = scale < 1.0 ? 1.0 : scale;
  const double support = 1.0 * filterscale;  // triangle support = 1.0
  const int ksize = static_cast<int>(std::ceil(support)) * 2 + 1;

  bounds.assign(static_cast<size_t>(out_size) * 2, 0);
  std::vector<double> w(ksize);
  kk.assign(static_cast<size_t>(out_size) * ksize, 0);

  const double ss = 1.0 / filterscale;
  for (int xx = 0; xx < out_size; ++xx) {
    const double center = (xx + 0.5) * scale;
    int xmin = static_cast<int>(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = static_cast<int>(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    xmax -= xmin;

    double wsum = 0.0;
    for (int x = 0; x < xmax; ++x) {
      w[x] = triangle_filter((x + xmin - center + 0.5) * ss);
      wsum += w[x];
    }
    int32_t* k = &kk[static_cast<size_t>(xx) * ksize];
    for (int x = 0; x < xmax; ++x) {
      const double c = wsum == 0.0 ? 0.0 : w[x] / wsum;
      // round-half-away-from-zero, matching PIL's coefficient quantization
      k[x] = static_cast<int32_t>(c < 0 ? c * (1 << kPrecisionBits) - 0.5
                                        : c * (1 << kPrecisionBits) + 0.5);
    }
    bounds[xx * 2 + 0] = xmin;
    bounds[xx * 2 + 1] = xmax;
  }
  return ksize;
}

// Horizontal resample: [h, sw, ch] u8 → [h, dw, ch] u8. Channel-innermost
// accumulation keeps the source reads contiguous; the ch==3 case (RGB, the
// only one on the hot path) is specialized so the compiler vectorizes it.
void resample_horizontal(const uint8_t* src, int h, int sw, int ch,
                         uint8_t* dst, int dw, const std::vector<int>& bounds,
                         const std::vector<int32_t>& kk, int ksize) {
  constexpr int32_t half = 1 << (kPrecisionBits - 1);
  for (int yy = 0; yy < h; ++yy) {
    const uint8_t* srow = src + static_cast<size_t>(yy) * sw * ch;
    uint8_t* drow = dst + static_cast<size_t>(yy) * dw * ch;
    if (ch == 3) {
      for (int xx = 0; xx < dw; ++xx) {
        const int xmin = bounds[xx * 2 + 0];
        const int xmax = bounds[xx * 2 + 1];
        const int32_t* k = &kk[static_cast<size_t>(xx) * ksize];
        int32_t s0 = half, s1 = half, s2 = half;
        const uint8_t* sp = srow + static_cast<size_t>(xmin) * 3;
        for (int x = 0; x < xmax; ++x) {
          const int32_t w = k[x];
          s0 += sp[0] * w;
          s1 += sp[1] * w;
          s2 += sp[2] * w;
          sp += 3;
        }
        drow[0] = clip8(s0);
        drow[1] = clip8(s1);
        drow[2] = clip8(s2);
        drow += 3;
      }
    } else {
      for (int xx = 0; xx < dw; ++xx) {
        const int xmin = bounds[xx * 2 + 0];
        const int xmax = bounds[xx * 2 + 1];
        const int32_t* k = &kk[static_cast<size_t>(xx) * ksize];
        for (int c = 0; c < ch; ++c) {
          int32_t ss = half;
          const uint8_t* sp = srow + static_cast<size_t>(xmin) * ch + c;
          for (int x = 0; x < xmax; ++x)
            ss += sp[static_cast<size_t>(x) * ch] * k[x];
          drow[static_cast<size_t>(xx) * ch + c] = clip8(ss);
        }
      }
    }
  }
}

// Vertical resample: [sh, w, ch] u8 → [dh, w, ch] u8. The inner loop runs
// along the contiguous row with a fixed weight per source row, so it
// vectorizes into wide u8×s32 FMAs over a row-sized s32 accumulator strip.
void resample_vertical(const uint8_t* src, int sh, int w, int ch, uint8_t* dst,
                       int dh, const std::vector<int>& bounds,
                       const std::vector<int32_t>& kk, int ksize) {
  constexpr int32_t half = 1 << (kPrecisionBits - 1);
  const size_t row = static_cast<size_t>(w) * ch;
  std::vector<int32_t> acc(row);
  for (int yy = 0; yy < dh; ++yy) {
    const int ymin = bounds[yy * 2 + 0];
    const int ymax = bounds[yy * 2 + 1];
    const int32_t* k = &kk[static_cast<size_t>(yy) * ksize];
    uint8_t* drow = dst + static_cast<size_t>(yy) * row;
    std::fill(acc.begin(), acc.end(), half);
    for (int y = 0; y < ymax; ++y) {
      const int32_t w0 = k[y];
      const uint8_t* sp = src + static_cast<size_t>(ymin + y) * row;
      int32_t* a = acc.data();
      for (size_t i = 0; i < row; ++i) a[i] += sp[i] * w0;
    }
    for (size_t i = 0; i < row; ++i) drow[i] = clip8(acc[i]);
  }
}

int resize_one(const uint8_t* src, int sh, int sw, uint8_t* dst, int dh,
               int dw, int ch) {
  if (sh <= 0 || sw <= 0 || dh <= 0 || dw <= 0 || ch <= 0) return -1;
  if (sh == dh && sw == dw) {
    std::memcpy(dst, src, static_cast<size_t>(sh) * sw * ch);
    return 0;
  }
  std::vector<int> bounds;
  std::vector<int32_t> kk;

  const bool need_h = sw != dw;
  const bool need_v = sh != dh;
  std::vector<uint8_t> tmp;
  const uint8_t* cur = src;
  int cur_h = sh, cur_w = sw;

  if (need_h) {
    const int ksize = precompute_coeffs(sw, dw, bounds, kk);
    uint8_t* out;
    if (need_v) {
      tmp.resize(static_cast<size_t>(sh) * dw * ch);
      out = tmp.data();
    } else {
      out = dst;
    }
    resample_horizontal(cur, sh, sw, ch, out, dw, bounds, kk, ksize);
    cur = out;
    cur_w = dw;
  }
  if (need_v) {
    const int ksize = precompute_coeffs(sh, dh, bounds, kk);
    resample_vertical(cur, cur_h, cur_w, ch, dst, dh, bounds, kk, ksize);
  }
  return 0;
}

}  // namespace

extern "C" {

// Single image: src [sh, sw, ch] u8 (C-contiguous) → dst [dh, dw, ch] u8.
// Bit-identical to PIL Image.resize((dw, dh), Image.BILINEAR).
int vqa_resize_bilinear_u8(const uint8_t* src, int sh, int sw, uint8_t* dst,
                           int dh, int dw, int ch) {
  return resize_one(src, sh, sw, dst, dh, dw, ch);
}

// Batch of n images with per-image source dims, resized into one contiguous
// [n, dh, dw, ch] output across a thread pool.
int vqa_resize_bilinear_u8_batch(const uint8_t* const* srcs, const int* shs,
                                 const int* sws, uint8_t* dst, int n, int dh,
                                 int dw, int ch, int num_threads) {
  if (n <= 0) return 0;
  if (num_threads <= 0) {
    num_threads = static_cast<int>(std::thread::hardware_concurrency());
    if (num_threads <= 0) num_threads = 1;
  }
  num_threads = std::min(num_threads, n);
  const size_t out_stride = static_cast<size_t>(dh) * dw * ch;
  std::atomic<int> next(0), err(0);
  auto worker = [&]() {
    for (;;) {
      const int i = next.fetch_add(1);
      if (i >= n) return;
      if (resize_one(srcs[i], shs[i], sws[i], dst + out_stride * i, dh, dw,
                     ch) != 0)
        err.store(-1);
    }
  };
  if (num_threads == 1) {
    worker();
  } else {
    std::vector<std::thread> pool;
    pool.reserve(num_threads);
    for (int t = 0; t < num_threads; ++t) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
  }
  return err.load();
}

// Fused u8 → f32 normalize: dst[i*ch+c] = (src[i*ch+c]/255 - mean[c]) * std_inv[c]
// over n pixels of ch channels (host-side parity path).
int vqa_normalize_f32(const uint8_t* src, float* dst, int64_t n_pixels, int ch,
                      const float* mean, const float* std_inv) {
  if (ch <= 0 || n_pixels < 0) return -1;
  constexpr float inv255 = 1.0f / 255.0f;
  for (int64_t i = 0; i < n_pixels; ++i) {
    const uint8_t* s = src + i * ch;
    float* d = dst + i * ch;
    for (int c = 0; c < ch; ++c)
      d[c] = (static_cast<float>(s[c]) * inv255 - mean[c]) * std_inv[c];
  }
  return 0;
}

int vqa_native_abi_version() { return 1; }

}  // extern "C"
