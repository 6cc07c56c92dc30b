// Hopper kernels for the book-cover preprocessing chain (sm_90a).
//
// They replace the two Pallas kernel sites of
// bbocr_tpu/kernels/preprocess_pallas.py:
//
//   sepconv_u8_kernel  <- _run_sepconv / _sepconv_kernel, in its two
//                         instantiations blur3_u8_pallas (3 taps,
//                         REFLECT_101, round+clip) and unsharp_u8_pallas
//                         (7 taps, edge border, PIL UnsharpMask epilogue);
//   enhance_u8_kernel  <- enhance_u8_pallas / _enhance_kernel (PIL Contrast
//                         then Brightness, per-image mean as a scalar).
//
// What bounds them: bytes. Each does a handful of float operations per
// pixel, so the least time is one read and one write of the (N, H, W)
// float32 image at the card's memory rate (2 * N*H*W*4 bytes). The design
// keeps every intermediate on chip: a block stages its output tile plus the
// filter halo in shared memory once (the border comes from index
// reflection or clamping, not from a padded copy in device memory), runs
// the vertical pass into a second shared tile, then the horizontal pass
// and the epilogue, and writes each output pixel once.
//
// Results are bit-exact against the plain PyTorch versions in
// bbocr_tpu_torch/ops (and through them against the JAX reference): taps
// are summed in index order, every multiply and add is rounded on its own
// (__fmul_rn / __fadd_rn; the file is also built with --fmad=false),
// rintf rounds half to even like jnp.round, and the unsharp mask's /100
// is an IEEE division (__fdiv_rn).
//
// Launchers have a plain C interface for ctypes: device pointers, ints,
// host-side taps and the caller's cudaStream_t; each returns
// cudaGetLastError() so a refused launch is reported by the wrapper.

#include <cuda_runtime.h>

namespace {

constexpr int kTileW = 32;
constexpr int kTileH = 32;
constexpr int kThreadsX = 32;
constexpr int kThreadsY = 8;
constexpr int kMaxTaps = 7;

enum Border { kReflect101 = 0, kReplicate = 1 };
enum Epilogue { kBlur = 0, kUnsharp = 1 };

struct Taps {
  float t[kMaxTaps];
};

template <int BORDER>
__device__ __forceinline__ int border_index(int i, int n) {
  if (BORDER == kReplicate) return min(max(i, 0), n - 1);
  if (n == 1) return 0;
  const int period = 2 * (n - 1);
  i %= period;
  if (i < 0) i += period;
  return i >= n ? period - i : i;
}

// round half to even, then clip to [0, 255]: the uint8 store
__device__ __forceinline__ float quant(float x) {
  return fminf(fmaxf(rintf(x), 0.0f), 255.0f);
}

template <int EPI>
__device__ __forceinline__ float epilogue(float conv, float center, float percent,
                                          float threshold) {
  if (EPI == kBlur) return quant(conv);
  // PIL UnsharpMask: where |src - blur| >= threshold,
  // out = src + sign(d) * floor(|d * percent| / 100) (C truncation).
  const float blurred = quant(conv);
  const float src = quant(center);
  const float diff = __fsub_rn(src, blurred);
  const float scaled = __fmul_rn(diff, percent);
  const float mag = floorf(__fdiv_rn(fabsf(scaled), 100.0f));
  const float adj = scaled > 0.0f ? mag : (scaled < 0.0f ? -mag : 0.0f);
  return quant(fabsf(diff) >= threshold ? __fadd_rn(src, adj) : src);
}

// One block: a kTileH x kTileW output tile of one image.
template <int R, int BORDER, int EPI>
__global__ void __launch_bounds__(kThreadsX * kThreadsY)
sepconv_u8_kernel(const float* __restrict__ in, float* __restrict__ out, int h, int w,
                  Taps taps, float percent, float threshold) {
  constexpr int kInH = kTileH + 2 * R;
  constexpr int kInW = kTileW + 2 * R;
  __shared__ float tile[kInH][kInW];
  __shared__ float vert[kTileH][kInW];

  const size_t plane = static_cast<size_t>(h) * w;
  const float* src = in + blockIdx.z * plane;
  float* dst = out + blockIdx.z * plane;
  const int y0 = blockIdx.y * kTileH;
  const int x0 = blockIdx.x * kTileW;
  const int tid = threadIdx.y * kThreadsX + threadIdx.x;
  constexpr int kThreads = kThreadsX * kThreadsY;

  for (int k = tid; k < kInH * kInW; k += kThreads) {
    const int ty = k / kInW;
    const int tx = k - ty * kInW;
    const int sy = border_index<BORDER>(y0 - R + ty, h);
    const int sx = border_index<BORDER>(x0 - R + tx, w);
    tile[ty][tx] = src[static_cast<size_t>(sy) * w + sx];
  }
  __syncthreads();

  for (int k = tid; k < kTileH * kInW; k += kThreads) {
    const int ty = k / kInW;
    const int tx = k - ty * kInW;
    float v = __fmul_rn(taps.t[0], tile[ty][tx]);
#pragma unroll
    for (int t = 1; t <= 2 * R; ++t) v = __fadd_rn(v, __fmul_rn(taps.t[t], tile[ty + t][tx]));
    vert[ty][tx] = v;
  }
  __syncthreads();

  for (int k = tid; k < kTileH * kTileW; k += kThreads) {
    const int ty = k / kTileW;
    const int tx = k - ty * kTileW;
    const int y = y0 + ty;
    const int x = x0 + tx;
    if (y >= h || x >= w) continue;
    float c = __fmul_rn(taps.t[0], vert[ty][tx]);
#pragma unroll
    for (int t = 1; t <= 2 * R; ++t) c = __fadd_rn(c, __fmul_rn(taps.t[t], vert[ty][tx + t]));
    dst[static_cast<size_t>(y) * w + x] =
        epilogue<EPI>(c, tile[ty + R][tx + R], percent, threshold);
  }
}

// PIL Contrast(c) then Brightness(b), elementwise; mean[n] = floor(mean + 0.5).
__global__ void enhance_u8_kernel(const float* __restrict__ in, const float* __restrict__ mean,
                                  float* __restrict__ out, int hw, float contrast,
                                  float brightness) {
  const float m = mean[blockIdx.y];
  const size_t base = static_cast<size_t>(blockIdx.y) * hw;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < hw; i += gridDim.x * blockDim.x) {
    const float x = in[base + i];
    const float blend = __fadd_rn(m, __fmul_rn(contrast, __fsub_rn(x, m)));
    const float y = fminf(fmaxf(floorf(__fadd_rn(blend, 0.5f)), 0.0f), 255.0f);
    out[base + i] = fminf(fmaxf(floorf(__fadd_rn(__fmul_rn(brightness, y), 0.5f)), 0.0f), 255.0f);
  }
}

template <int R, int BORDER, int EPI>
int launch_sepconv(const void* in, void* out, int n, int h, int w, const float* taps_host,
                   float percent, float threshold, cudaStream_t stream) {
  Taps taps = {};
  for (int t = 0; t <= 2 * R; ++t) taps.t[t] = taps_host[t];
  const dim3 block(kThreadsX, kThreadsY);
  const dim3 grid((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH, n);
  sepconv_u8_kernel<R, BORDER, EPI><<<grid, block, 0, stream>>>(
      static_cast<const float*>(in), static_cast<float*>(out), h, w, taps, percent, threshold);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// cv2.GaussianBlur 3x3 (taps: 3 floats) + uint8 store, REFLECT_101 border.
int bbocr_blur3_u8(const void* in, void* out, int n, int h, int w, const float* taps,
                   void* stream) {
  return launch_sepconv<1, kReflect101, kBlur>(in, out, n, h, w, taps, 0.0f, 0.0f,
                                               static_cast<cudaStream_t>(stream));
}

// PIL UnsharpMask with a 7-tap blur (taps: 7 floats), edge border.
int bbocr_unsharp_u8(const void* in, void* out, int n, int h, int w, const float* taps,
                     float percent, float threshold, void* stream) {
  return launch_sepconv<3, kReplicate, kUnsharp>(in, out, n, h, w, taps, percent, threshold,
                                                 static_cast<cudaStream_t>(stream));
}

int bbocr_enhance_u8(const void* in, const void* mean, void* out, int n, int h, int w,
                     float contrast, float brightness, void* stream) {
  const int hw = h * w;
  const int threads = 256;
  const dim3 grid((hw + threads - 1) / threads, n);
  enhance_u8_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(in), static_cast<const float*>(mean), static_cast<float*>(out),
      hw, contrast, brightness);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
