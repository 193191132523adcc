// Native host-side image ops of the data loader: a copy of
// textboost_tpu/csrc/image_ops.cpp (the port imports nothing from the JAX
// package).
//
// normalize_u8_to_f32 converts uint8 pixels to float32 in [-1, 1] in one
// multithreaded pass; affine_scale_bicubic_u8 is the zoom of paired
// augmentation's adjust_scale, bit-exact with PIL. Built on first use with
// g++ -ffp-contract=off (textboost_torch/data/native.py), which raises when
// the build fails.
//
// Counterpart of the torchvision ToDtype+Normalize chain the reference
// uses (textboost/dataset.py:328-334).

#include <cmath>
#include <memory>
#include <cstdint>
#include <cstddef>
#include <thread>
#include <vector>

extern "C" {

// dst[i] = (src[i]/255 - mean)/std, over n elements, using `threads` workers.
void normalize_u8_to_f32(const uint8_t* src, float* dst, int64_t n,
                         float mean, float inv_std, int threads) {
  // Precomputed 256-entry LUT: one load + one store per element.
  float lut[256];
  for (int i = 0; i < 256; ++i) {
    lut[i] = (static_cast<float>(i) / 255.0f - mean) * inv_std;
  }
  if (threads < 1) threads = 1;
  auto worker = [&](int64_t begin, int64_t end) {
    for (int64_t i = begin; i < end; ++i) dst[i] = lut[src[i]];
  };
  if (threads == 1 || n < (1 << 16)) {
    worker(0, n);
    return;
  }
  std::vector<std::thread> pool;
  int64_t chunk = (n + threads - 1) / threads;
  for (int t = 0; t < threads; ++t) {
    int64_t begin = t * chunk;
    int64_t end = begin + chunk > n ? n : begin + chunk;
    if (begin >= end) break;
    pool.emplace_back(worker, begin, end);
  }
  for (auto& th : pool) th.join();
}

// Gather HWC uint8 crops into a float32 NHWC batch in one pass:
// for each image i, copy the (size x size) window at (tops[i], lefts[i])
// from srcs[i] (h_i x w_i x 3) with normalization.
void crop_normalize_batch(const uint8_t** srcs, const int32_t* heights,
                          const int32_t* widths, const int32_t* tops,
                          const int32_t* lefts, float* dst, int32_t batch,
                          int32_t size, float mean, float inv_std) {
  float lut[256];
  for (int i = 0; i < 256; ++i) {
    lut[i] = (static_cast<float>(i) / 255.0f - mean) * inv_std;
  }
  int64_t img_elems = static_cast<int64_t>(size) * size * 3;
  auto worker = [&](int b) {
    const uint8_t* src = srcs[b];
    int32_t w = widths[b];
    float* out = dst + b * img_elems;
    for (int32_t y = 0; y < size; ++y) {
      const uint8_t* row = src + (static_cast<int64_t>(tops[b] + y) * w +
                                  lefts[b]) * 3;
      float* orow = out + static_cast<int64_t>(y) * size * 3;
      for (int32_t x = 0; x < size * 3; ++x) orow[x] = lut[row[x]];
    }
  };
  std::vector<std::thread> pool;
  for (int b = 0; b < batch; ++b) pool.emplace_back(worker, b);
  for (auto& th : pool) th.join();
}

// Axis-aligned affine resample, bit-exact to PIL's
// Image.transform(AFFINE, BICUBIC) composed with a prior edge-pad
// (torchvision v2.functional.pad(edge) + affine(scale) as used by the
// reference's adjust_scale, paired_augmentation.py:20-49).
//
// Conventions (empirically pinned against Pillow, see
// tests/test_native.py::test_affine_bicubic_matches_pil):
//   xin = a0*(x_out + 0.5) + a2; outside iff xin < 0 or xin >= W_padded
//   sample position p = xin - 0.5; taps at floor(p)-1 .. floor(p)+2,
//   clamped to the padded extent; cubic kernel a = -1; per-channel
//   horizontal-then-vertical interpolation in double; final value
//   truncated (toward zero) and clipped to [0, 255].
//
// The edge-pad is virtual: tap indices are clamped into the padded
// extent, then mapped into the source with a second clamp — identical
// to materializing np.pad(mode="edge") and sampling that.

// Pillow's BICUBIC macro (kernel a=-1) in its exact difference-Horner
// form: p-coefficients are exact zeros on constant patches, so edge-pad
// plateaus interpolate exactly (a per-tap weights formulation drifts by
// 1 ulp there and flips the final truncation on ~1% of padded pixels).
static inline double pil_cubic(double v1, double v2, double v3, double v4,
                               double d) {
  double p2 = -v1 + v3;
  double p3 = 2.0 * (v1 - v2) + v3 - v4;
  double p4 = -v1 + v2 - v3 + v4;
  return v2 + d * (p2 + d * (p3 + d * p4));
}

static inline int32_t clamp_i(int32_t v, int32_t lo, int32_t hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

void affine_scale_bicubic_u8(const uint8_t* src, int32_t src_h, int32_t src_w,
                             int32_t pad_w, int32_t pad_h, uint8_t* dst,
                             int32_t out_h, int32_t out_w, double a0, double a2,
                             double a4, double a5) {
  const int32_t W = src_w + 2 * pad_w;  // virtual padded extent
  const int32_t H = src_h + 2 * pad_h;

  // Per-output-column taps: resolved source x-indices + fractional d.
  std::vector<int32_t> xi(static_cast<size_t>(out_w) * 4);
  std::vector<double> dx(out_w);
  std::vector<uint8_t> x_ok(out_w);
  for (int32_t x = 0; x < out_w; ++x) {
    double xin0 = a0 * (x + 0.5) + a2;
    x_ok[x] = (xin0 >= 0.0 && xin0 < static_cast<double>(W)) ? 1 : 0;
    double p = xin0 - 0.5;
    double f = std::floor(p);
    dx[x] = p - f;
    int32_t xf = static_cast<int32_t>(f);
    for (int t = 0; t < 4; ++t) {
      int32_t ip = clamp_i(xf - 1 + t, 0, W - 1);          // padded extent
      xi[x * 4 + t] = clamp_i(ip - pad_w, 0, src_w - 1);   // into source
    }
  }

  // Source rows actually referenced by some output row's vertical taps
  // (zoom-in windows touch only the centre band).
  int32_t row_lo = src_h, row_hi = -1;
  for (int32_t y = 0; y < out_h; ++y) {
    double yin0 = a4 * (y + 0.5) + a5;
    if (!(yin0 >= 0.0 && yin0 < static_cast<double>(H))) continue;
    int32_t yf = static_cast<int32_t>(std::floor(yin0 - 0.5));
    for (int t = 0; t < 4; ++t) {
      int32_t iy = clamp_i(clamp_i(yf - 1 + t, 0, H - 1) - pad_h, 0, src_h - 1);
      if (iy < row_lo) row_lo = iy;
      if (iy > row_hi) row_hi = iy;
    }
  }
  if (row_hi < row_lo) { row_lo = 0; row_hi = -1; }

  // Horizontal pass over referenced source rows (padded rows alias them).
  // Uninitialized buffer: rows outside [row_lo, row_hi] are never read.
  std::unique_ptr<double[]> tmp(
      new double[static_cast<size_t>(src_h) * out_w * 3]);
  for (int32_t y = row_lo; y <= row_hi; ++y) {
    const uint8_t* row = src + static_cast<int64_t>(y) * src_w * 3;
    double* trow = tmp.get() + static_cast<int64_t>(y) * out_w * 3;
    for (int32_t x = 0; x < out_w; ++x) {
      const int32_t* ix = &xi[x * 4];
      double d = dx[x];
      for (int c = 0; c < 3; ++c) {
        trow[x * 3 + c] =
            pil_cubic(row[ix[0] * 3 + c], row[ix[1] * 3 + c],
                      row[ix[2] * 3 + c], row[ix[3] * 3 + c], d);
      }
    }
  }

  // Vertical pass.
  for (int32_t y = 0; y < out_h; ++y) {
    uint8_t* orow = dst + static_cast<int64_t>(y) * out_w * 3;
    double yin0 = a4 * (y + 0.5) + a5;
    if (!(yin0 >= 0.0 && yin0 < static_cast<double>(H))) {
      for (int32_t i = 0; i < out_w * 3; ++i) orow[i] = 0;
      continue;
    }
    double p = yin0 - 0.5;
    double f = std::floor(p);
    double d = p - f;
    int32_t yf = static_cast<int32_t>(f);
    const double* r[4];
    for (int t = 0; t < 4; ++t) {
      int32_t ip = clamp_i(yf - 1 + t, 0, H - 1);
      int32_t iy = clamp_i(ip - pad_h, 0, src_h - 1);
      r[t] = tmp.get() + static_cast<int64_t>(iy) * out_w * 3;
    }
    for (int32_t x = 0; x < out_w; ++x) {
      if (!x_ok[x]) {
        orow[x * 3] = orow[x * 3 + 1] = orow[x * 3 + 2] = 0;
        continue;
      }
      for (int c = 0; c < 3; ++c) {
        int32_t i = x * 3 + c;
        double v = pil_cubic(r[0][i], r[1][i], r[2][i], r[3][i], d);
        orow[i] = v <= 0.0 ? 0
                           : (v >= 255.0 ? 255 : static_cast<uint8_t>(v));
      }
    }
  }
}

}  // extern "C"
