// Forward adaptive FIR of the ALAC encoder: signal -> residuals, one
// channel per lane, for Hopper (sm_90a).
//
// Replaces: alacnet_tpu/ops/pallas/enc_stages.py, `_pred_kernel` (reached
// via `predictor_errors_fused` / `encode_stages_fused` -> `_pred_blocks`).
// The per-sample expressions mirror that kernel's `sample` body one for
// one (the decoder's reconstruction, AlacFile.cs:256-336, run in lockstep
// over the known signal); the plain torch version is
// ops/encode.predictor_errors (alacnet_tpu_torch/ops/cuda/enc_stages.py).
//
// What bounds it on the H100: each lane is a serial recurrence (every
// residual depends on the coefficient table that the previous residuals
// adapted), so a lane cannot be split across threads.  A chunk is 2048
// lanes, so the kernel has 2048 threads: it is bound by the latency of
// one thread's per-sample chain (the FIR sum, then the coefficient walk),
// not by bytes (8 bytes a sample) or by the card's operation rate.
//
// What the design does about it: one thread per lane and small blocks
// (kThreads lanes each), so a chunk spreads over 64 SMs instead of
// piling onto a few.  The window D[0..TMAX] and the coefficients
// rc[0..TMAX] live in registers: TMAX (the JAX kernel's static
// `max_order`) is a template parameter, every index is an unrolled loop
// counter, and the FIR and the walk are exactly TMAX long.  The walk ends
// as soon as the lane stops acting (it never acts again).  Planes are
// sample-major (S, B): the 32 lanes of a warp read and write 128
// contiguous bytes per sample.  The TPU kernel's (8, 128) lane tiles,
// 1024-lane padding and DMA'd staging tiles do not carry over: the
// kernel takes any B and S.
//
// Bit-exactness: ALAC's arithmetic is C# int32 with wraparound.  Signed
// overflow is undefined in CUDA C++, so every product or sum that can
// wrap runs in uint32_t; shift counts are masked where the JAX kernel
// masks them (`& 31` in signext and qshift), and the arithmetic shift by
// `quant` gives the sign fill for counts of 32 or more, as jax.lax does.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 32;  // lanes per block: 2048 lanes -> 64 blocks
constexpr int kMaxOrder = 31;

__device__ __forceinline__ int32_t wsub(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a - (uint32_t)b);
}
__device__ __forceinline__ int32_t wmul(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a * (uint32_t)b);
}
// jax.lax.shift_right_arithmetic: counts outside [0, 31] give the sign.
__device__ __forceinline__ int32_t sra(int32_t x, int32_t n) {
  return (uint32_t)n > 31u ? (x >> 31) : (x >> n);
}
// (x << s) >> s with s = (32 - bits) & 31: sign-extend the low bits.
__device__ __forceinline__ int32_t signext(int32_t x, int32_t rss) {
  const uint32_t s = (uint32_t)(32 - rss) & 31u;
  return (int32_t)((uint32_t)x << s) >> s;
}

template <int TMAX>
__global__ void __launch_bounds__(kThreads) enc_pred_kernel(
    const int32_t* __restrict__ sig_sb, int B, int S,
    const int32_t* __restrict__ n_arr, const int32_t* __restrict__ rss_arr,
    const int32_t* __restrict__ order_arr,
    const int32_t* __restrict__ quant_arr, const int32_t* __restrict__ rc_in,
    int32_t* __restrict__ errs_sb) {
  const int b = blockIdx.x * kThreads + threadIdx.x;
  if (b >= B) return;

  const int32_t n = n_arr[b];
  const int32_t rss = rss_arr[b];
  const int32_t order = order_arr[b];
  const int32_t quant = quant_arr[b];
  const int32_t qshift = (quant - 1) & 31;
  const int32_t round = (int32_t)(1u << qshift);
  const bool is_pass = order == 0;
  const bool is_int31 = order == kMaxOrder;

  int32_t rc[TMAX + 1];
  int32_t D[TMAX + 1];  // D[t] = x[i - 1 - order + t] once warm
#pragma unroll
  for (int t = 0; t <= TMAX; ++t) {
    rc[t] = rc_in[(size_t)b * (kMaxOrder + 1) + t];
    D[t] = 0;
  }
  int32_t prev = 0;

  for (int i = 0; i < S; ++i) {
    const int32_t x = sig_sb[(size_t)i * B + b];
    const int32_t err_int = signext(wsub(x, prev), rss);
    const int32_t base = D[0];
    uint32_t fir = 0u;
#pragma unroll
    for (int t = 1; t <= TMAX; ++t) {
      fir += (uint32_t)wsub(D[t], base) * (uint32_t)rc[t];
    }
    const int32_t outval = sra((int32_t)((uint32_t)round + fir), quant);
    const int32_t err_fir = signext(wsub(wsub(x, outval), base), rss);
    const bool use_int = is_int31 || i <= order;
    int32_t err = is_pass ? x : (use_int ? err_int : err_fir);
    if (i == 0) err = x;  // the first sample is copied verbatim

    // adaptive coefficient walk (AlacFile.cs:312-332), the decoder's
    if (!(is_pass || is_int31 || use_int) && err != 0) {
      const bool pos_b = err > 0;
      int32_t ev = err;
#pragma unroll
      for (int t = 0; t < TMAX; ++t) {
        const bool act = t < order && (pos_b ? ev > 0 : ev < 0);
        // A lane that stops acting never acts again: ev keeps its sign
        // and t < order only turns false.
        if (!act) break;
        const int32_t val = wsub(base, D[t + 1]);
        const int32_t sgn = (val > 0) - (val < 0);
        const int32_t se = pos_b ? sgn : -sgn;
        rc[t + 1] = wsub(rc[t + 1], se);
        ev = wsub(ev, wmul(sra(wmul(val, se), quant), t + 1));
      }
    }

    // Shift the window left by one and append the input at slot
    // `order`; unconditional past n, like the JAX kernel.
#pragma unroll
    for (int t = 0; t < TMAX; ++t) D[t] = order == t ? x : D[t + 1];
    D[TMAX] = order == TMAX ? x : D[TMAX];

    const bool live = i < n;
    errs_sb[(size_t)i * B + b] = live ? err : 0;
    if (live) prev = x;
  }
}

template <int TMAX>
void launch(const int32_t* sig, int B, int S, const int32_t* n,
            const int32_t* rss, const int32_t* order, const int32_t* quant,
            const int32_t* rc, int32_t* errs, cudaStream_t stream) {
  enc_pred_kernel<TMAX><<<(B + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      sig, B, S, n, rss, order, quant, rc, errs);
}

using LaunchFn = void (*)(const int32_t*, int, int, const int32_t*,
                          const int32_t*, const int32_t*, const int32_t*,
                          const int32_t*, int32_t*, cudaStream_t);

template <int... Ts>
struct Table {
  static constexpr LaunchFn fns[sizeof...(Ts)] = {&launch<Ts>...};
};

// One instantiation per static bound 0..31.
using Launchers = Table<0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15,
                        16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28,
                        29, 30, 31>;

}  // namespace

extern "C" int alac_enc_pred(const void* sig_sb, int B, int S, const void* n,
                             const void* rss, const void* order,
                             const void* quant, const void* rc, int max_order,
                             void* errs_sb, void* stream) {
  if (max_order < 0 || max_order > kMaxOrder) return (int)cudaErrorInvalidValue;
  if (B > 0 && S > 0) {
    Launchers::fns[max_order](
        (const int32_t*)sig_sb, B, S, (const int32_t*)n, (const int32_t*)rss,
        (const int32_t*)order, (const int32_t*)quant, (const int32_t*)rc,
        (int32_t*)errs_sb, (cudaStream_t)stream);
  }
  return (int)cudaGetLastError();
}
