// The encoder's zero-run lookahead, for Hopper (sm_90a).
//
// Replaces: the XLA reverse cummin between the two encode kernels in
// alacnet_tpu/ops/pallas/enc_stages.py (:566-576, `zero_run_lengths` of
// alacnet_tpu/ops/encode.py on the kernels' layout), kept out of Pallas
// there on purpose.  On the sample-major (S, B) residual plane that the
// enc_pred kernel writes: a break is a nonzero residual or a sample at
// or past the lane's n (n is not clamped: n <= 0 breaks everywhere,
// n >= S only at nonzero residuals); out[i] is the distance from i + 1
// to the next break at or after it (S where there is none), 0 at
// S - 1, capped at 0xFFFF.  The plain torch version is
// ops/encode.zero_run_lengths_sb (two flips and a cummin), bit for bit.
//
// What bounds it on the H100: memory traffic, the residuals read once
// and the runs written once, 8 bytes and about 4 integer operations a
// position.  The scan runs along S, but a thread a lane alone gives ~16
// threads an SM at the encoder's <= 2,048 lanes.
//
// What the design does about it: one launch, no scratch in device
// memory.  A block owns a strip of kStrip = 4 * LQ lanes (a thread 4
// neighbouring lanes: 16-byte loads and stores where B % 4 == 0 and the
// planes are aligned, `VEC`) and walks the whole of S backward, a pass
// of kThreads / LQ row groups of kRows rows at a time.  A thread keeps
// its kRows x 4 residuals in registers only as long as it takes to turn
// them into a break mask a lane, so the next pass's loads are issued
// before this pass's scan and stores (a prefetch in registers).  The
// next break after a thread's rows comes from a reverse min-scan over
// the pass's groups: shuffles within a warp, one shared-memory word a
// warp and lane across warps, and the carry from the passes above it
// (one __syncthreads a pass, the shared words double-buffered by the
// pass's parity).  Then each thread walks its rows backward, writing
// each run and moving the next break down as it meets one.  The strip
// width is the caller's (`strip`, 8 or 16 lanes: a row of 32 or 64
// bytes); the narrower strip gives twice the blocks when B is small.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 8;  // rows a thread a pass
constexpr int kWarps = kThreads / 32;

template <bool VEC>
__device__ __forceinline__ void load_rows(const int32_t* __restrict__ errs, int B, int S,
                                          int r0, int bq, int (&e)[kRows][4]) {
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const int row = r0 + k;
    const int32_t* p = errs + (size_t)row * B + bq;
    if (VEC) {
      int4 v = make_int4(0, 0, 0, 0);
      if (row < S && bq < B) v = *(const int4*)p;
      e[k][0] = v.x;
      e[k][1] = v.y;
      e[k][2] = v.z;
      e[k][3] = v.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) e[k][j] = row < S && bq + j < B ? p[j] : 0;
    }
  }
}

template <int LQ, bool VEC>
__global__ void __launch_bounds__(kThreads)
    zero_runs_kernel(const int32_t* __restrict__ errs, const int32_t* __restrict__ n, int B,
                     int S, int32_t* __restrict__ out) {
  constexpr int kStrip = 4 * LQ;               // lanes a block
  constexpr int kPass = kThreads / LQ * kRows;  // rows a pass
  __shared__ int wt[2][kWarps][kStrip];  // each warp's first break, a lane
  __shared__ int carry[2][kStrip];       // the next break below the pass's rows
  const int t = threadIdx.x, i = t % 32, w = t / 32;
  const int q = t % LQ, g = t / LQ;
  const int bq = blockIdx.x * kStrip + 4 * q;  // the thread's first lane
  int nb[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) nb[j] = bq + j < B ? n[bq + j] : 0;
  const int npass = (S + kPass - 1) / kPass;
  if (t < kStrip) carry[(npass - 1) & 1][t] = S;  // no break past S
  int e[kRows][4];
  load_rows<VEC>(errs, B, S, (npass - 1) * kPass + g * kRows, bq, e);
  for (int p = npass - 1; p >= 0; --p) {
    const int r0 = p * kPass + g * kRows;
    uint32_t m[4] = {0u, 0u, 0u, 0u};  // bit k: row r0 + k breaks
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (r0 + k < S && (r0 + k >= nb[j] || e[k][j] != 0)) m[j] |= 1u << k;
      }
    }
    if (p > 0) load_rows<VEC>(errs, B, S, r0 - kPass, bq, e);
    int v[4], ex[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = m[j] ? r0 + __ffs(m[j]) - 1 : S;
    // v: the first break from this thread's group to the warp's last.
#pragma unroll
    for (int d = LQ; d < 32; d <<= 1) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int o = __shfl_down_sync(0xffffffffu, v[j], d);
        if (i + d < 32) v[j] = min(v[j], o);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int o = __shfl_down_sync(0xffffffffu, v[j], LQ);
      ex[j] = i + LQ < 32 ? o : S;
    }
    const int par = p & 1;
    if (i < LQ) {
#pragma unroll
      for (int j = 0; j < 4; ++j) wt[par][w][4 * q + j] = v[j];
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int c = carry[par][4 * q + j];
      for (int u = w + 1; u < kWarps; ++u) c = min(c, wt[par][u][4 * q + j]);
      ex[j] = min(ex[j], c);
      // the pass's first group: its own first break is the next pass's carry
      if (t < LQ) carry[par ^ 1][4 * q + j] = min(v[j], ex[j]);
    }
    // ex: the next break after the thread's rows.  Walk them backward.
#pragma unroll
    for (int k = kRows - 1; k >= 0; --k) {
      const int row = r0 + k;
      if (row >= S) continue;
      int o[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ex[j] - (row + 1);  // zeros from row + 1 on
        o[j] = r < 0xFFFF ? r : 0xFFFF;
        if (m[j] >> k & 1u) ex[j] = row;
      }
      int32_t* dst = out + (size_t)row * B + bq;
      if (VEC) {
        if (bq < B) *(int4*)dst = make_int4(o[0], o[1], o[2], o[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (bq + j < B) dst[j] = o[j];
        }
      }
    }
  }
}

template <int LQ>
int launch(const int32_t* errs, const int32_t* n, int B, int S, int32_t* out,
           cudaStream_t stream) {
  const bool vec = B % 4 == 0 && ((uintptr_t)errs | (uintptr_t)out) % 16 == 0;
  const int grid = (B + 4 * LQ - 1) / (4 * LQ);
  if (vec) {
    zero_runs_kernel<LQ, true><<<grid, kThreads, 0, stream>>>(errs, n, B, S, out);
  } else {
    zero_runs_kernel<LQ, false><<<grid, kThreads, 0, stream>>>(errs, n, B, S, out);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// errs, out: (S, B) int32; n: (B,) int32; strip: lanes a block, 8 or 16.
// One launch on the stream.
extern "C" int alac_zero_runs(const void* errs, const void* n, int B, int S, int strip,
                              void* out, void* stream) {
  if (B <= 0 || S <= 0) return (int)cudaGetLastError();
  const cudaStream_t st = (cudaStream_t)stream;
  const int32_t* e = (const int32_t*)errs;
  switch (strip) {
    case 8:
      return launch<2>(e, (const int32_t*)n, B, S, (int32_t*)out, st);
    case 16:
      return launch<4>(e, (const int32_t*)n, B, S, (int32_t*)out, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
