// Host crop rectification for the OCR engine's host_rectify path, bit for
// bit as OpenCV 5.0.0 computes the two calls the JAX package makes
// (bbocr_tpu/runtime/wire.py::host_warp_crop) on an x86-64 CPU with
// AVX-512, where cv2 dispatches its vector code:
//
//   cv2.warpPerspective(src, M, (w, h), INTER_LINEAR | WARP_INVERSE_MAP,
//                       BORDER_REPLICATE)
//   cv2.resize(src, (w / k, h / k), interpolation=INTER_AREA), k integer
//
// warpPerspective (OpenCV >= 4.11, float path): M is rounded to float32;
// the source coordinate of output pixel (x, y) is X / W with
//   X = fma(M0, x, M1 * y + M2)        for the vector body of each row
//                                      (the first floor(w / 16) * 16 pixels)
//   X = fma(M0, x, M1 * y) + M2        for the scalar tail,
// likewise Y and W; the four taps are clamped to the image (replicate) and
// blended with fused multiply-adds, v0 = fma(a, p01 - p00, p00),
// v1 = fma(a, p11 - p10, p10), v = fma(b, v1 - v0, v0), then rounded to
// nearest even and saturated.
// INTER_AREA at an integer factor averages k x k blocks: (s + 2) >> 2 for
// k = 2, round-to-nearest-even of s * (1.f / k^2) otherwise.
//
// Build with -ffp-contract=off: every fused multiply-add is written out.

#include <algorithm>
#include <cmath>
#include <cstdint>

namespace {

constexpr int kBodyBlock = 16;

inline uint8_t saturate_round(float v) {
  const float r = std::nearbyint(v);
  return static_cast<uint8_t>(std::min(255.f, std::max(0.f, r)));
}

}  // namespace

extern "C" {

// src (sh, sw) u8, m (3, 3) float64 output -> source map, dst (dh, dw) u8.
int bbocr_warp_perspective_u8(const uint8_t* src, int32_t sh, int32_t sw, const double* m,
                              uint8_t* dst, int32_t dh, int32_t dw) {
  if (sh <= 0 || sw <= 0 || dh <= 0 || dw <= 0) return 1;
  float M[9];
  for (int i = 0; i < 9; ++i) M[i] = static_cast<float>(m[i]);
  const int body = (dw / kBodyBlock) * kBodyBlock;
  // far outside the image every tap replicates one border pixel: clamping
  // there changes no output and keeps the indices in range
  const float lo_x = -2.f, hi_x = static_cast<float>(sw) + 1.f;
  const float lo_y = -2.f, hi_y = static_cast<float>(sh) + 1.f;
  for (int y = 0; y < dh; ++y) {
    const float fy = static_cast<float>(y);
    const float ax = M[1] * fy, ay = M[4] * fy, aw = M[7] * fy;
    const float rx = ax + M[2], ry = ay + M[5], rw = aw + M[8];
    uint8_t* out = dst + static_cast<int64_t>(y) * dw;
    for (int x = 0; x < dw; ++x) {
      const float fx = static_cast<float>(x);
      float X, Y, W;
      if (x < body) {
        X = std::fma(M[0], fx, rx);
        Y = std::fma(M[3], fx, ry);
        W = std::fma(M[6], fx, rw);
      } else {
        X = std::fma(M[0], fx, ax) + M[2];
        Y = std::fma(M[3], fx, ay) + M[5];
        W = std::fma(M[6], fx, aw) + M[8];
      }
      const float sx = std::min(hi_x, std::max(lo_x, X / W));
      const float sy = std::min(hi_y, std::max(lo_y, Y / W));
      const float flx = std::floor(sx), fly = std::floor(sy);
      const float a = sx - flx, b = sy - fly;
      const int ix = static_cast<int>(flx), iy = static_cast<int>(fly);
      const int x0 = std::min(sw - 1, std::max(0, ix)), x1 = std::min(sw - 1, std::max(0, ix + 1));
      const int y0 = std::min(sh - 1, std::max(0, iy)), y1 = std::min(sh - 1, std::max(0, iy + 1));
      const uint8_t* r0 = src + static_cast<int64_t>(y0) * sw;
      const uint8_t* r1 = src + static_cast<int64_t>(y1) * sw;
      const float p00 = r0[x0], p01 = r0[x1], p10 = r1[x0], p11 = r1[x1];
      const float v0 = std::fma(a, p01 - p00, p00);
      const float v1 = std::fma(a, p11 - p10, p10);
      out[x] = saturate_round(std::fma(b, v1 - v0, v0));
    }
  }
  return 0;
}

// src (dh * k, dw * k) u8 -> dst (dh, dw) u8, the mean of each k x k block.
int bbocr_resize_area_u8(const uint8_t* src, int32_t dh, int32_t dw, int32_t k, uint8_t* dst) {
  if (dh <= 0 || dw <= 0 || k < 1) return 1;
  const int64_t sw = static_cast<int64_t>(dw) * k;
  const float scale = 1.f / static_cast<float>(k * k);
  for (int y = 0; y < dh; ++y) {
    for (int x = 0; x < dw; ++x) {
      int s = 0;
      for (int i = 0; i < k; ++i) {
        const uint8_t* row = src + (static_cast<int64_t>(y) * k + i) * sw + static_cast<int64_t>(x) * k;
        for (int j = 0; j < k; ++j) s += row[j];
      }
      dst[static_cast<int64_t>(y) * dw + x] =
          k == 2 ? static_cast<uint8_t>((s + 2) >> 2) : saturate_round(static_cast<float>(s) * scale);
    }
  }
  return 0;
}

}  // extern "C"
