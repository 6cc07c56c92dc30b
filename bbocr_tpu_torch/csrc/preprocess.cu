// Hopper kernels for the book-cover preprocessing chain (sm_90a).
//
// They replace the two Pallas kernel sites of
// bbocr_tpu/kernels/preprocess_pallas.py:
//
//   sepconv_u8_kernel  <- _run_sepconv (:91) / _sepconv_kernel (:63), in its
//                         two instantiations blur3_u8_pallas (:137; 3 taps,
//                         REFLECT_101, round+clip) and unsharp_u8_pallas
//                         (:143; 7 taps, edge border, PIL UnsharpMask
//                         epilogue);
//   enhance_u8_kernel  <- enhance_u8_pallas (:169) / _enhance_kernel (:160)
//                         (PIL Contrast then Brightness, per-image mean as a
//                         scalar).
//
// What bounds them: bytes. Each does a few dozen float operations per pixel
// at most, so the least time is one read and one write of the (N, H, W)
// float32 image at the card's memory rate: 2 * N*H*W*4 bytes, 11.02 MB and
// 3.29 us at (1, 1312, 1050) on an H100 SXM (3.35 TB/s).
//
// The separable-conv kernel, first design: a block staged a 32x32
// output tile plus its halo in shared memory with one 4-byte load per
// element, each through two border_index calls (a runtime % for
// REFLECT_101) and a division of the flat index, then ran the vertical pass
// into a second shared tile and the horizontal pass from it, with three
// barrier phases and no overlap of loads and arithmetic; the halo tiles
// re-read 1.13x (blur3) and 1.41x (unsharp) of the image, the unsharp
// epilogue used an IEEE division, and 1,353 blocks made 1.28 waves. On an
// NVIDIA H100 80GB HBM3 at 700 W that took 10.4 us (blur3) and 10.6 us
// (unsharp) of device time at (1, 1312, 1050), 31 % of the bound.
//
// The present design, against each of those causes:
// - Work per warp, not per tile: a warp owns a strip of 128 input columns
//   (4 consecutive columns a lane) and walks down a band of rows. Its
//   output is the strip less P = R rounded up to even columns on each side:
//   those halo columns are loaded and filtered vertically but not written,
//   so the horizontal neighbours come from the next lane by warp shuffles
//   and the row loop needs no barrier.
// - Each input row is read once per band: the vertical windows of two
//   output rows (2R+2 input rows) live in registers, input row i of the
//   band in slot i % (2R+2); a step takes two new rows and makes two output
//   rows, whose independent chains fill the pipeline, and the loop is
//   unrolled by R+1 steps, so the slots are registers with constant names
//   and the window never moves. The vertical halo is re-read once per band,
//   not once per 32 rows.
// - Index work is done once per band: a lane's source columns are resolved
//   once (the border formula only where a lane touches an image edge; the
//   general periodic reflection stays for images smaller than the halo), a
//   row's source once per row, and nothing divides in the row loop.
// - Rows stream in with cp.async, kDepth row pairs ahead of the
//   arithmetic, into a ring in shared memory that only the issuing thread
//   reads, so a thread's own cp.async.wait_group is all the synchronisation
//   there is. Rows are 8-byte aligned where w is even (1050 * 4 = 4,200 B,
//   not a multiple of 16: TMA and cp.async.bulk cannot describe this image),
//   so a lane copies its 16 bytes in one 16-byte cp.async where the row's
//   position allows it (every other row at w = 1050) and in two 8-byte ones
//   elsewhere, and stores the same way; an odd w, an unaligned view or a
//   warp at an image edge takes 4-byte copies through the border-resolved
//   columns, in a second instantiation of the row loop, so the interior
//   loop has no per-lane branch.
// - The grid is sized from the SM count (queried once per device): the band
//   height makes about kWarpsPerSM warps per SM, one wave.
// - The unsharp epilogue has no division and no branch: its correction
//   depends only on d = src - blur, a difference of two uint8 values, so
//   each block first evaluates the IEEE formula (__fdiv_rn, threshold test
//   and all) for the 511 values of d into a table in shared memory, and a
//   pixel looks its correction up. That is exact by construction, for any
//   percent and threshold.
//
// Results are bit-exact against the plain PyTorch versions in
// bbocr_tpu_torch/ops (and through them against the JAX reference): taps
// are summed in index order, every multiply and add is rounded on its own
// (__fmul_rn / __fadd_rn; the file is also built with --fmad=false), and
// rintf rounds half to even like jnp.round. Tensor cores cannot do this
// work: an MMA accumulates in its own order, not tap by tap with each
// product and sum rounded.
//
// Launchers have a plain C interface for ctypes: device pointers, ints,
// host-side taps and the caller's cudaStream_t; each returns a CUDA error
// code (0 on success) so a refused launch is reported by the wrapper.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxTaps = 7;
constexpr int kCols = 4;                 // output columns per lane
constexpr int kWarpCols = 32 * kCols;    // input columns per warp
constexpr int kWarpsPerBlock = 4;
constexpr int kBlockThreads = 32 * kWarpsPerBlock;
constexpr int kDepth = 3;                // row pairs in flight per thread
constexpr int kSlots = kDepth + 1;
constexpr int kWarpsPerSM = 16;          // warps per SM the band height aims at
constexpr int kMinBand = 4;              // the shortest band, in rows
constexpr unsigned kFullMask = 0xffffffffu;

enum Border { kReflect101 = 0, kReplicate = 1 };
enum Epilogue { kBlur = 0, kUnsharp = 1 };

struct Taps {
  float t[kMaxTaps];
};

// halo columns on each side of a warp's output: R rounded up to even, so
// that output columns pair up on 8-byte boundaries
__host__ __device__ constexpr int halo_pad(int r) { return (r + 1) / 2 * 2; }

template <int BORDER>
__device__ __forceinline__ int border_index(int i, int n) {
  if (BORDER == kReplicate) return min(max(i, 0), n - 1);
  if (n == 1) return 0;
  const int period = 2 * (n - 1);
  i %= period;
  if (i < 0) i += period;
  return i >= n ? period - i : i;
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// round half to even, then clip to [0, 255]: the uint8 store
__device__ __forceinline__ float quant(float x) {
  return fminf(fmaxf(rintf(x), 0.0f), 255.0f);
}

// PIL UnsharpMask's correction for one difference d = src - blur: where
// |d| >= threshold, sign(d) * floor(|d * percent| / 100) (C truncation),
// else 0. Both operands are uint8 values, so d takes 511 values only.
__device__ __forceinline__ float unsharp_adj(float d, float percent, float threshold) {
  const float scaled = __fmul_rn(d, percent);
  const float mag = floorf(__fdiv_rn(fabsf(scaled), 100.0f));
  const float adj = scaled > 0.0f ? mag : (scaled < 0.0f ? -mag : 0.0f);
  return fabsf(d) >= threshold ? adj : 0.0f;
}

// What one warp needs to walk its band.
struct Band {
  const float* src;  // the image's first row
  float* out_row;    // output row y0, at column x_lane
  float4* mine;      // this thread's element of ring slot pair 0
  int h, w, y0, rows, x_lane;
  unsigned written;  // bit j: this lane writes column x_lane + j
  int col[kCols];    // source column of each of the lane's columns
};

// The rows of one band, two output rows a step. FAST: every lane's four
// columns lie inside the image and w is even with 8-byte aligned pointers,
// so rows move in 16- or 8-byte pieces with no per-lane branch; otherwise
// 4 bytes at a time through the border-resolved columns.
template <int R, int BORDER, int EPI, bool FAST>
__device__ __forceinline__ void sepconv_band(const Band& b, const Taps& taps,
                                             const float* adj_table) {
  constexpr int kWin = 2 * R + 2;    // input rows of two output rows
  constexpr int kTurn = kWin / 2;    // steps per turn of the window
  const int total = b.rows + 2 * R;  // input rows of the band
  const int steps = (total + 1) / 2;
  auto issue_row = [&](int i, float* d) {
    const int r = b.y0 - R + i;
    const int sr = (r >= 0 && r < b.h) ? r : border_index<BORDER>(r, b.h);
    const float* row = b.src + static_cast<size_t>(sr) * b.w;
    if (FAST) {
      if ((reinterpret_cast<uintptr_t>(row + b.x_lane) & 15) == 0) {  // uniform
        cp_async16(d, row + b.x_lane);
      } else {
        cp_async8(d, row + b.x_lane);
        cp_async8(d + 2, row + b.x_lane + 2);
      }
    } else {
#pragma unroll
      for (int j = 0; j < kCols; ++j) cp_async4(d + j, row + b.col[j]);
    }
  };
  // step s: input rows 2s and 2s + 1, into one pair of ring slots
  auto issue = [&](int step, int slot) {
    float* d = reinterpret_cast<float*>(b.mine + 2 * slot * kBlockThreads);
    issue_row(2 * step, d);
    if (2 * step + 1 < total) issue_row(2 * step + 1, d + 4 * kBlockThreads);
  };
#pragma unroll
  for (int k = 0; k < kDepth; ++k) {
    if (k < steps) issue(k, k);
    cp_async_commit();
  }

  // Input row i of the band sits in win[i % kWin]: the loop is unrolled by
  // kTurn steps, so every index below is a constant and the window never
  // moves.
  float win[kWin][kCols];
  float* out_row = b.out_row;
  int slot = 0;         // ring slot pair of step s
  int ahead = kDepth;   // ring slot pair of step s + kDepth
  for (int s0 = 0; s0 < steps; s0 += kTurn) {
#pragma unroll
    for (int u = 0; u < kTurn; ++u) {
      const int step = s0 + u;
      if (step >= steps) break;  // uniform across the warp
      cp_async_wait<kDepth - 1>();  // rows 2s and 2s + 1 have landed
      const float4* pair = b.mine + 2 * slot * kBlockThreads;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float4 row = pair[e * kBlockThreads];
        win[2 * u + e][0] = row.x;
        win[2 * u + e][1] = row.y;
        win[2 * u + e][2] = row.z;
        win[2 * u + e][3] = row.w;
      }

      const int m = 2 * step - 2 * R;  // output rows m and m + 1
      if (m >= 0) {  // uniform across the warp
        float o[2][kCols];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          // input rows m + e .. m + e + 2R, at win[(2u + e + t + 2) % kWin]
          float v[kCols];
#pragma unroll
          for (int j = 0; j < kCols; ++j) {
            float a = __fmul_rn(taps.t[0], win[(2 * u + e + 2) % kWin][j]);
#pragma unroll
            for (int t = 1; t < 2 * R + 1; ++t)
              a = __fadd_rn(a, __fmul_rn(taps.t[t], win[(2 * u + e + t + 2) % kWin][j]));
            v[j] = a;
          }
          // ext[i]: the vertical sum at column x_lane - R + i
          float ext[kCols + 2 * R];
#pragma unroll
          for (int i = 0; i < R; ++i) {
            ext[i] = __shfl_up_sync(kFullMask, v[kCols - R + i], 1);
            ext[R + kCols + i] = __shfl_down_sync(kFullMask, v[i], 1);
          }
#pragma unroll
          for (int j = 0; j < kCols; ++j) ext[R + j] = v[j];
#pragma unroll
          for (int j = 0; j < kCols; ++j) {
            float c = __fmul_rn(taps.t[0], ext[j]);
#pragma unroll
            for (int t = 1; t < 2 * R + 1; ++t) c = __fadd_rn(c, __fmul_rn(taps.t[t], ext[j + t]));
            if (EPI == kBlur) {
              o[e][j] = quant(c);
            } else {
              // src + adj is a whole number: clipping it is its uint8 store
              const float src = quant(win[(2 * u + e + R + 2) % kWin][j]);
              const float d = __fsub_rn(src, quant(c));
              o[e][j] = fminf(fmaxf(__fadd_rn(src, adj_table[__float2int_rz(d) + 255]), 0.0f), 255.0f);
            }
          }
        }
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (m + e < b.rows) {  // uniform across the warp
            if (FAST) {
              if (b.written == 15u && (reinterpret_cast<uintptr_t>(out_row) & 15) == 0) {
                *reinterpret_cast<float4*>(out_row) = make_float4(o[e][0], o[e][1], o[e][2], o[e][3]);
              } else {
                if (b.written & 3u) *reinterpret_cast<float2*>(out_row) = make_float2(o[e][0], o[e][1]);
                if (b.written & 12u) *reinterpret_cast<float2*>(out_row + 2) = make_float2(o[e][2], o[e][3]);
              }
            } else {
#pragma unroll
              for (int j = 0; j < kCols; ++j)
                if (b.written & (1u << j)) out_row[j] = o[e][j];
            }
            out_row += b.w;
          }
        }
      }

      // the pair read one step ago is free: its values are in registers
      if (step + kDepth < steps) issue(step + kDepth, ahead);
      cp_async_commit();
      slot = slot + 1 == kSlots ? 0 : slot + 1;
      ahead = ahead + 1 == kSlots ? 0 : ahead + 1;
    }
  }
}

// One warp: columns [x_warp, x_warp + 128) of rows [y0 - R, y0 + rows + R)
// of one image in, output rows [y0, y0 + rows) of the columns
// [x_warp + P, x_warp + 128 - P) out. vec_ok: w is even and both pointers
// are 8-byte aligned, so a lane's column pairs can move 8 bytes at a time.
template <int R, int BORDER, int EPI>
__global__ void __launch_bounds__(kBlockThreads)
sepconv_u8_kernel(const float* __restrict__ in, float* __restrict__ out, int n, int h, int w,
                  int strips, int bands, int band_h, int vec_ok, Taps taps, float percent,
                  float threshold) {
  constexpr int P = halo_pad(R);
  constexpr int kStep = kWarpCols - 2 * P;
  static_assert(R <= kCols && 2 * R + 1 <= kMaxTaps, "one neighbour lane holds the halo");
  __shared__ float4 ring[kSlots][2][kBlockThreads];
  __shared__ float adj_table[EPI == kUnsharp ? 511 : 1];

  if (EPI == kUnsharp) {
    for (int i = threadIdx.x; i < 511; i += kBlockThreads)
      adj_table[i] = unsharp_adj(static_cast<float>(i - 255), percent, threshold);
    __syncthreads();
  }

  const int lane = threadIdx.x & 31;
  const int item = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (item >= n * strips * bands) return;  // whole warps only
  const int band = item % bands;
  const int strip = (item / bands) % strips;
  const int img = item / bands / strips;
  const int x_warp = strip * kStep - P;
  const size_t plane = static_cast<size_t>(h) * w;

  // Once per band: where the lane's columns come from, which it writes.
  Band b;
  b.src = in + img * plane;
  b.mine = &ring[0][0][threadIdx.x];
  b.h = h;
  b.w = w;
  b.y0 = band * band_h;
  b.rows = min(band_h, h - b.y0);
  b.x_lane = x_warp + kCols * lane;
  b.out_row = out + img * plane + static_cast<size_t>(b.y0) * w + b.x_lane;
  b.written = 0;
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
    const int x = b.x_lane + j;
    b.col[j] = (x >= 0 && x < w) ? x : border_index<BORDER>(x, w);
    const int c = kCols * lane + j;
    if (c >= P && c < kWarpCols - P && x < w) b.written |= 1u << j;
  }
  if (vec_ok && x_warp >= 0 && x_warp + kWarpCols <= w) {  // uniform across the warp
    sepconv_band<R, BORDER, EPI, true>(b, taps, adj_table);
  } else {
    sepconv_band<R, BORDER, EPI, false>(b, taps, adj_table);
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

// The SM count of the current device, queried once per device.
cudaError_t sm_count(int* count) {
  constexpr int kMaxDevices = 64;
  static int cached[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && cached[dev] > 0) {
    *count = cached[dev];
    return cudaSuccess;
  }
  err = cudaDeviceGetAttribute(count, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && dev < kMaxDevices) cached[dev] = *count;
  return err;
}

template <int R, int BORDER, int EPI>
int launch_sepconv(const void* in, void* out, int n, int h, int w, const float* taps_host,
                   float percent, float threshold, cudaStream_t stream) {
  Taps taps = {};
  for (int t = 0; t <= 2 * R; ++t) taps.t[t] = taps_host[t];
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  // Strips of output columns; bands of rows tall enough for one wave of
  // about kWarpsPerSM warps per SM, and no shorter than kMinBand.
  const int strips = (w + kWarpCols - 2 * halo_pad(R) - 1) / (kWarpCols - 2 * halo_pad(R));
  const long long per_band = static_cast<long long>(n) * strips;
  const long long want = (static_cast<long long>(sms) * kWarpsPerSM + per_band - 1) / per_band;
  const int bands_wanted = static_cast<int>(want < 1 ? 1 : (want > h ? h : want));
  const int band_h = min(h, max(kMinBand, (h + bands_wanted - 1) / bands_wanted));
  const int bands = (h + band_h - 1) / band_h;
  const long long warps = per_band * bands;
  const int vec_ok = w % 2 == 0 && reinterpret_cast<uintptr_t>(in) % 8 == 0 &&
                     reinterpret_cast<uintptr_t>(out) % 8 == 0;
  const long long blocks = (warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (warps > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  sepconv_u8_kernel<R, BORDER, EPI><<<static_cast<unsigned>(blocks), kBlockThreads, 0, stream>>>(
      static_cast<const float*>(in), static_cast<float*>(out), n, h, w, strips, bands, band_h,
      vec_ok, taps, percent, threshold);
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
