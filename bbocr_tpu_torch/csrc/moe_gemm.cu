// The routed experts of a mixture-of-experts layer (sm_90a): a grouped GEMM
// over token-expert pairs, in two kernels.
//
// It replaces no TPU kernel: the JAX package has no mixture of experts. It
// was added for the MLA/MoE language model (models/mla_moe.py), whose
// experts do most of its work. A loop over the experts in PyTorch needs
// data-dependent shapes (a host sync each layer, and no CUDA graph) and
// three GEMMs an expert.
//
// The wrapper (kernels/moe_gemm.py) sorts the pairs by expert on the card
// and pads each expert's run to a multiple of the row block BM. It hands in
// pair_of_row (the pair of each padded row, P where the row is padding) and
// tile_e (the expert of each row block, E past the last run). Both have
// shapes fixed by P, so the grid is too, and a CUDA graph replays it.
//
//   bbocr_moe_gate_up_kernel_*: a block takes BM rows of pairs and BN
//     columns of its expert's gate and up projections. It gathers each
//     row's token from x and sums both products in float32 in one pass over
//     the hidden size. It stores silu(gate) * up with the roundings that
//     F.linear, F.silu and the product make in the compute type.
//   bbocr_moe_down_kernel_*: those rows against the expert's down
//     projection; each pair's output goes to its own row of y (pair order),
//     so the weighted sum over a token's pairs (in PyTorch) is one
//     deterministic reduction.
//
// What bounds them: in decode, a few pairs an expert, the experts' weights
// (3 * E * width * hidden values a layer, read once a row block); in
// prefill, thousands of pairs an expert, the tensor cores. So there are two
// tilings. Decode takes 32-row blocks, so an expert's pairs mostly fit one
// block and its weights are read about once; a 3-stage cp.async ring keeps
// 32 KB of weights in flight a block. Prefill takes 128-row blocks of 8
// warps, so each weight tile loaded to shared memory serves 128 pairs: in
// gate/up each warp holds 32 x 32 of both products, in down 64 x 32 with a
// 4-stage ring (of the tilings timed at Moonlight's widths on an H100, the
// fastest for each kernel). 16-bit types run on the tensor cores (wmma,
// 16x16x16, float32 sums); float32 runs a plain FMA loop over the same
// tiles (for tests; no tensor core keeps float32 whole). bfloat16 is the
// published type; there is no float16 build, as no caller needs one.
//
// The kernels carry plain C names, so a device trace finds them by the
// prefix bbocr_moe_. Each launcher returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>

#include <type_traits>

namespace {

using namespace nvcuda;

template <int BM_, int BN_, int BK_, int WM_, int WN_, int STAGES_>
struct Tiles {
  static constexpr int BM = BM_, BN = BN_, BK = BK_, WM = WM_, WN = WN_, STAGES = STAGES_;
  static constexpr int THREADS = 32 * WM * WN;
  static constexpr int TM = BM / WM, TN = BN / WN;  // a warp's share of the block's output
  static constexpr int FM = TM / 16, FN = TN / 16;  // in 16 x 16 pieces
  static_assert(TM % 16 == 0 && TN % 16 == 0 && BK % 16 == 0, "tiles are made of 16 x 16 pieces");
};

// Tilings <BM, BN, BK, warps down, warps across, ring stages>; the two
// kernels of a phase share BM, the padding of an expert's run.
using DecodeGateUp = Tiles<32, 64, 64, 2, 2, 3>;
using DecodeDown = Tiles<32, 64, 64, 2, 2, 3>;
using PrefillGateUp = Tiles<128, 64, 32, 4, 2, 3>;
using PrefillDown = Tiles<128, 128, 32, 2, 4, 4>;
static_assert(DecodeGateUp::BM == DecodeDown::BM && PrefillGateUp::BM == PrefillDown::BM, "one padding a phase");

// float32's accumulator: lane l holds row l / 2, columns (l % 2) * 8 .. + 8
// of a 16 x 16 piece.
struct SimtAcc {
  enum { num_elements = 8 };
  float x[8];
};

template <typename T> struct Acc { using type = wmma::fragment<wmma::accumulator, 16, 16, 16, float>; };
template <> struct Acc<float> { using type = SimtAcc; };

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) { return __float2bfloat16(v); }

template <typename T> __device__ __forceinline__ float to_float(T v);
template <> __device__ __forceinline__ float to_float<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 v) { return __bfloat162float(v); }

// a float32 value rounded to T (to nearest, ties to even) and back
template <typename T> __device__ __forceinline__ float rounded(float v) { return to_float<T>(from_float<T>(v)); }

// 16 bytes from global to shared memory, or 16 zero bytes where !ok
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = ok ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N> __device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

template <typename T, class C, int NB>
constexpr size_t smem_bytes() {
  constexpr size_t ld = C::BK + 16 / sizeof(T);
  constexpr size_t ring = size_t(C::STAGES) * (C::BM + NB * C::BN) * ld * sizeof(T);
  constexpr size_t out = size_t(C::BM) * (C::BN + 4) * sizeof(float);
  return ring > out ? ring : out;
}

// One block of out = act(a_rows @ w^T): NB = 2 is gate/up (rows gathered by
// token, silu(gate) * up stored in padded-row order), NB = 1 is down (rows
// of h, each output row stored at its pair).
template <typename T, class C, int NB>
__device__ __forceinline__ void grouped_gemm(const T* __restrict__ a, const T* __restrict__ w0,
                                             const T* __restrict__ w1, T* __restrict__ out,
                                             const long long* __restrict__ pair_of_row,
                                             const long long* __restrict__ tile_e, long long P, int topk,
                                             int N, int K, int E) {
  constexpr int VEC = 16 / sizeof(T);  // elements a 16-byte copy moves
  constexpr int LD = C::BK + VEC;      // a tile row in shared memory, padded off the banks' period
  constexpr int LDC = C::BN + 4;
  constexpr int STAGE = (C::BM + NB * C::BN) * LD;
  constexpr int CPR = C::BK / VEC;
  constexpr bool SIMT = std::is_same<T, float>::value;
  using A = typename Acc<T>::type;

  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  __shared__ long long a_off[C::BM];   // element offset of each row's input, -1 for padding
  __shared__ long long out_row[C::BM]; // the row each output row goes to, -1 for none

  const long long e = tile_e[blockIdx.x];
  if (e >= E) return;  // past the last expert's run: padding blocks of the static grid
  const long long row0 = static_cast<long long>(blockIdx.x) * C::BM;
  const int n0 = blockIdx.y * C::BN;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / C::WN, wn = warp % C::WN;

  for (int r = tid; r < C::BM; r += C::THREADS) {
    const long long p = pair_of_row[row0 + r];
    const bool ok = p < P;
    a_off[r] = ok ? (NB == 2 ? p / topk : row0 + r) * static_cast<long long>(K) : -1;
    out_row[r] = NB == 2 ? row0 + r : (ok ? p : -1);
  }
  __syncthreads();

  const T* g0 = w0 + e * N * static_cast<long long>(K);
  const T* g1 = w1 + e * N * static_cast<long long>(K);
  const int KT = (K + C::BK - 1) / C::BK;

  auto load = [&](int stage, int kt) {
    T* s = smem + stage * STAGE;
    const int k0 = kt * C::BK;
    for (int i = tid; i < C::BM * CPR; i += C::THREADS) {
      const int r = i / CPR, c = (i % CPR) * VEC, k = k0 + c;
      const long long off = a_off[r];
      const bool ok = off >= 0 && k < K;
      cp_async16(s + r * LD + c, ok ? a + off + k : a, ok);
    }
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      T* sw = s + (C::BM + b * C::BN) * LD;
      const T* w = b == 0 ? g0 : g1;
      for (int i = tid; i < C::BN * CPR; i += C::THREADS) {
        const int r = i / CPR, c = (i % CPR) * VEC, k = k0 + c, n = n0 + r;
        const bool ok = n < N && k < K;
        cp_async16(sw + r * LD + c, ok ? w + static_cast<long long>(n) * K + k : w, ok);
      }
    }
  };

  A acc[NB][C::FM][C::FN];
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int i = 0; i < C::FM; ++i)
#pragma unroll
      for (int j = 0; j < C::FN; ++j)
#pragma unroll
        for (int t = 0; t < A::num_elements; ++t) acc[b][i][j].x[t] = 0.0f;

#pragma unroll
  for (int s = 0; s < C::STAGES - 1; ++s) {
    if (s < KT) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<C::STAGES - 2>();
    __syncthreads();  // tile kt has landed, and every warp is done with the stage refilled next
    const int next = kt + C::STAGES - 1;
    if (next < KT) load(next % C::STAGES, next);
    cp_async_commit();
    const T* s = smem + (kt % C::STAGES) * STAGE;
    if constexpr (SIMT) {
      const int lr = lane >> 1, lc = (lane & 1) * 8;
#pragma unroll 4
      for (int kk = 0; kk < C::BK; ++kk) {
        float av[C::FM];
#pragma unroll
        for (int i = 0; i < C::FM; ++i) av[i] = to_float<T>(s[(wm * C::TM + i * 16 + lr) * LD + kk]);
#pragma unroll
        for (int b = 0; b < NB; ++b)
#pragma unroll
          for (int j = 0; j < C::FN; ++j)
#pragma unroll
            for (int t = 0; t < 8; ++t) {
              const float bv = to_float<T>(s[(C::BM + b * C::BN + wn * C::TN + j * 16 + lc + t) * LD + kk]);
#pragma unroll
              for (int i = 0; i < C::FM; ++i) acc[b][i][j].x[t] = fmaf(av[i], bv, acc[b][i][j].x[t]);
            }
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < C::BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> fa[C::FM];
#pragma unroll
        for (int i = 0; i < C::FM; ++i) wmma::load_matrix_sync(fa[i], s + (wm * C::TM + i * 16) * LD + kk, LD);
#pragma unroll
        for (int b = 0; b < NB; ++b)
#pragma unroll
          for (int j = 0; j < C::FN; ++j) {
            // w is (N, K) row-major: as the K x N operand it is column-major
            wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::col_major> fb;
            wmma::load_matrix_sync(fb, s + (C::BM + b * C::BN + wn * C::TN + j * 16) * LD + kk, LD);
#pragma unroll
            for (int i = 0; i < C::FM; ++i) wmma::mma_sync(acc[b][i][j], fa[i], fb, acc[b][i][j]);
          }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: the block's output is staged in its place

  if constexpr (NB == 2) {
    // gate and up pieces share one layout, so element t is one (row, column)
    // of both: F.linear rounds each product, F.silu its result, and the
    // product is rounded by the store below
#pragma unroll
    for (int i = 0; i < C::FM; ++i)
#pragma unroll
      for (int j = 0; j < C::FN; ++j)
#pragma unroll
        for (int t = 0; t < A::num_elements; ++t) {
          const float g = rounded<T>(acc[0][i][j].x[t]);
          const float u = rounded<T>(acc[1][i][j].x[t]);
          acc[0][i][j].x[t] = rounded<T>(g / (1.0f + expf(-g))) * u;
        }
  }
  float* cs = reinterpret_cast<float*>(smem_raw);
#pragma unroll
  for (int i = 0; i < C::FM; ++i)
#pragma unroll
    for (int j = 0; j < C::FN; ++j) {
      float* c = cs + (wm * C::TM + i * 16) * LDC + wn * C::TN + j * 16;
      if constexpr (SIMT) {
        const int lr = lane >> 1, lc = (lane & 1) * 8;
#pragma unroll
        for (int t = 0; t < 8; ++t) c[lr * LDC + lc + t] = acc[0][i][j].x[t];
      } else {
        wmma::store_matrix_sync(c, acc[0][i][j], LDC, wmma::mem_row_major);
      }
    }
  __syncthreads();
  for (int i = tid; i < C::BM * C::BN; i += C::THREADS) {
    const int r = i / C::BN, c = i % C::BN, n = n0 + c;
    const long long row = out_row[r];
    if (n < N && row >= 0) out[row * N + n] = from_float<T>(cs[r * LDC + c]);
  }
}

template <typename T, class C, int NB, typename Kernel, typename... Args>
int launch(Kernel kernel, int row_blocks, int n, cudaStream_t stream, Args... args) {
  constexpr size_t smem = smem_bytes<T, C, NB>();
  // above 48 KB a block needs the attribute; set on each launch, as it is
  // per device (this is no stream work, so a graph's capture allows it)
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(row_blocks, (n + C::BN - 1) / C::BN);
  kernel<<<grid, C::THREADS, smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define BBOCR_MOE_KERNELS(T, TNAME, C, CNAME)                                                                  \
  extern "C" __global__ void __launch_bounds__(C##GateUp::THREADS)                                           \
      bbocr_moe_gate_up_kernel_##TNAME##_##CNAME(                                                            \
      const T* x, const T* gate, const T* up, T* h, const long long* pair_of_row, const long long* tile_e,    \
      long long P, int topk, int N, int K, int E) {                                                          \
    grouped_gemm<T, C##GateUp, 2>(x, gate, up, h, pair_of_row, tile_e, P, topk, N, K, E);                   \
  }                                                                                                          \
  extern "C" __global__ void __launch_bounds__(C##Down::THREADS)                                             \
      bbocr_moe_down_kernel_##TNAME##_##CNAME(                                                               \
      const T* h, const T* down, T* y, const long long* pair_of_row, const long long* tile_e, long long P,    \
      int N, int K, int E) {                                                                                 \
    grouped_gemm<T, C##Down, 1>(h, down, down, y, pair_of_row, tile_e, P, 1, N, K, E);                      \
  }

BBOCR_MOE_KERNELS(__nv_bfloat16, bf16, Decode, decode)
BBOCR_MOE_KERNELS(__nv_bfloat16, bf16, Prefill, prefill)
BBOCR_MOE_KERNELS(float, f32, Decode, decode)
BBOCR_MOE_KERNELS(float, f32, Prefill, prefill)

namespace {

template <typename T, class C>
int gate_up(void (*kernel)(const T*, const T*, const T*, T*, const long long*, const long long*, long long, int,
                           int, int, int),
            const void* x, const void* gate, const void* up, void* h, const void* pair_of_row, const void* tile_e,
            int row_blocks, long long P, int topk, int N, int K, int E, cudaStream_t stream) {
  return launch<T, C, 2>(kernel, row_blocks, N, stream, static_cast<const T*>(x), static_cast<const T*>(gate),
                         static_cast<const T*>(up), static_cast<T*>(h), static_cast<const long long*>(pair_of_row),
                         static_cast<const long long*>(tile_e), P, topk, N, K, E);
}

template <typename T, class C>
int down(void (*kernel)(const T*, const T*, T*, const long long*, const long long*, long long, int, int, int),
         const void* h, const void* w, void* y, const void* pair_of_row, const void* tile_e, int row_blocks,
         long long P, int N, int K, int E, cudaStream_t stream) {
  return launch<T, C, 1>(kernel, row_blocks, N, stream, static_cast<const T*>(h), static_cast<const T*>(w),
                         static_cast<T*>(y), static_cast<const long long*>(pair_of_row),
                         static_cast<const long long*>(tile_e), P, N, K, E);
}

}  // namespace

extern "C" {

// Rows of a row block: the padding the wrapper gives each expert's run.
int bbocr_moe_block_rows(int decode) { return decode ? DecodeGateUp::BM : PrefillGateUp::BM; }

// dtype: 0 bfloat16, 1 float32. x (T, K), gate and up (E, N, K),
// h (row_blocks * BM, N); pair_of_row (row_blocks * BM,) and tile_e
// (row_blocks,) int64 on the card.
int bbocr_moe_gate_up(int dtype, int decode, const void* x, const void* gate, const void* up, void* h,
                      const void* pair_of_row, const void* tile_e, int row_blocks, long long P, int topk, int N,
                      int K, int E, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define BBOCR_GATE_UP(T, TNAME, C, CNAME) \
  gate_up<T, C##GateUp>(bbocr_moe_gate_up_kernel_##TNAME##_##CNAME, x, gate, up, h, pair_of_row, tile_e, row_blocks, P, topk, N, K, E, s)
  switch (dtype * 2 + (decode ? 1 : 0)) {
    case 0: return BBOCR_GATE_UP(__nv_bfloat16, bf16, Prefill, prefill);
    case 1: return BBOCR_GATE_UP(__nv_bfloat16, bf16, Decode, decode);
    case 2: return BBOCR_GATE_UP(float, f32, Prefill, prefill);
    case 3: return BBOCR_GATE_UP(float, f32, Decode, decode);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef BBOCR_GATE_UP
}

// h (row_blocks * BM, K), down (E, N, K), y (P, N).
int bbocr_moe_down(int dtype, int decode, const void* h, const void* w, void* y, const void* pair_of_row,
                   const void* tile_e, int row_blocks, long long P, int N, int K, int E, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define BBOCR_DOWN(T, TNAME, C, CNAME) \
  down<T, C##Down>(bbocr_moe_down_kernel_##TNAME##_##CNAME, h, w, y, pair_of_row, tile_e, row_blocks, P, N, K, E, s)
  switch (dtype * 2 + (decode ? 1 : 0)) {
    case 0: return BBOCR_DOWN(__nv_bfloat16, bf16, Prefill, prefill);
    case 1: return BBOCR_DOWN(__nv_bfloat16, bf16, Decode, decode);
    case 2: return BBOCR_DOWN(float, f32, Prefill, prefill);
    case 3: return BBOCR_DOWN(float, f32, Decode, decode);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef BBOCR_DOWN
}

}  // extern "C"
