// Native preprocessing for the rajni_tpu_torch data pipeline (a copy of
// rajni_tpu/data/_native/preprocess.cpp, built on its own by
// rajni_tpu_torch/data/native.py).
//
// Implements the reference eval transform (Resize(shorter-side, bicubic) ->
// CenterCrop -> ToTensor -> Normalize) as a single C++ pass over the decoded
// RGB buffer, standing in for torchvision's C++ ops: the Python DataLoader
// calls it through ctypes (which releases the GIL), so a thread pool of
// decoders scales across cores.
//
// Resampling matches PIL's convolution-based resize: bicubic kernel with
// a = -0.5, filter support scaled by the downsampling ratio (PIL's
// antialiasing), per-output-pixel weight normalization, horizontal pass then
// vertical pass, with round-and-clamp to uint8 between passes (PIL's 8bpc
// pipeline does the same, so results agree within +-1/255 fixed-point vs
// float rounding).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

namespace {

constexpr double kA = -0.5;  // PIL bicubic
constexpr double kSupport = 2.0;

double bicubic(double x) {
  x = std::fabs(x);
  if (x < 1.0) return ((kA + 2.0) * x - (kA + 3.0)) * x * x + 1.0;
  if (x < 2.0) return (((x - 5.0) * x + 8.0) * x - 4.0) * kA;
  return 0.0;
}

// Per-output-pixel filter bounds and normalized weights (PIL
// precompute_coeffs semantics).
struct Coeffs {
  std::vector<int> xmin;
  std::vector<int> xsize;
  std::vector<std::vector<double>> weights;
};

Coeffs precompute(int in_size, int out_size) {
  Coeffs c;
  c.xmin.resize(out_size);
  c.xsize.resize(out_size);
  c.weights.resize(out_size);
  const double scale = static_cast<double>(in_size) / out_size;
  const double filterscale = std::max(scale, 1.0);
  const double support = kSupport * filterscale;

  for (int xx = 0; xx < out_size; ++xx) {
    const double center = (xx + 0.5) * scale;
    int xmin = static_cast<int>(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = static_cast<int>(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;

    auto& w = c.weights[xx];
    w.resize(xmax - xmin);
    double total = 0.0;
    for (int x = xmin; x < xmax; ++x) {
      w[x - xmin] = bicubic((x + 0.5 - center) / filterscale);
      total += w[x - xmin];
    }
    if (total != 0.0) {
      for (auto& v : w) v /= total;
    }
    c.xmin[xx] = xmin;
    c.xsize[xx] = xmax - xmin;
  }
  return c;
}

inline uint8_t clamp8(double v) {
  return static_cast<uint8_t>(std::min(255.0, std::max(0.0, v + 0.5)));
}

}  // namespace

extern "C" {

// src: [h, w, 3] uint8 RGB. out: [crop, crop, 3] float32 (normalized).
// (nw, nh): resize target (shorter side already resolved by the caller);
// (left, top): crop offsets (caller computes them with Python round() to
// keep torchvision's rounding quirk in exactly one place).
// Returns 0 on success.
int rajni_preprocess(const uint8_t* src, int h, int w, int nh, int nw,
                     int crop, int left, int top, const float* mean,
                     const float* stddev, float* out) {
  if (!src || !out || h <= 0 || w <= 0 || nh <= 0 || nw <= 0 || crop <= 0)
    return 1;
  if (left < 0 || top < 0 || left + crop > nw || top + crop > nh) return 2;

  // Horizontal pass: [h, w, 3] -> [h, nw, 3] (uint8, PIL 8bpc pipeline).
  Coeffs ch = precompute(w, nw);
  std::vector<uint8_t> tmp(static_cast<size_t>(h) * nw * 3);
  for (int y = 0; y < h; ++y) {
    const uint8_t* row = src + static_cast<size_t>(y) * w * 3;
    uint8_t* orow = tmp.data() + static_cast<size_t>(y) * nw * 3;
    for (int xx = 0; xx < nw; ++xx) {
      const auto& wts = ch.weights[xx];
      const int x0 = ch.xmin[xx];
      double acc[3] = {0.0, 0.0, 0.0};
      for (int k = 0; k < ch.xsize[xx]; ++k) {
        const uint8_t* px = row + static_cast<size_t>(x0 + k) * 3;
        acc[0] += wts[k] * px[0];
        acc[1] += wts[k] * px[1];
        acc[2] += wts[k] * px[2];
      }
      orow[xx * 3 + 0] = clamp8(acc[0]);
      orow[xx * 3 + 1] = clamp8(acc[1]);
      orow[xx * 3 + 2] = clamp8(acc[2]);
    }
  }

  // Vertical pass fused with crop + normalize: only the cropped rows/cols
  // are produced ([crop, crop, 3] float32 straight to the output).
  Coeffs cv = precompute(h, nh);
  const float inv_std[3] = {1.0f / stddev[0], 1.0f / stddev[1],
                            1.0f / stddev[2]};
  for (int yy = 0; yy < crop; ++yy) {
    const int src_y = yy + top;
    const auto& wts = cv.weights[src_y];
    const int y0 = cv.xmin[src_y];
    float* orow = out + static_cast<size_t>(yy) * crop * 3;
    for (int xx = 0; xx < crop; ++xx) {
      const int src_x = xx + left;
      double acc[3] = {0.0, 0.0, 0.0};
      for (int k = 0; k < cv.xsize[src_y]; ++k) {
        const uint8_t* px = tmp.data() +
                            (static_cast<size_t>(y0 + k) * nw + src_x) * 3;
        acc[0] += wts[k] * px[0];
        acc[1] += wts[k] * px[1];
        acc[2] += wts[k] * px[2];
      }
      for (int ci = 0; ci < 3; ++ci) {
        const float v = clamp8(acc[ci]) / 255.0f;  // PIL rounds pass 2 too
        orow[xx * 3 + ci] = (v - mean[ci]) * inv_std[ci];
      }
    }
  }
  return 0;
}

}  // extern "C"
