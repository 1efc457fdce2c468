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
// and the runs written once, about 4 integer operations a sample.  The
// scan runs along S, but a thread a lane alone gives ~16 threads an SM
// at the encoder's <= 2,048 lanes.
//
// What the design does about it: S is cut into kTile-sample tiles on
// the grid's y axis, lanes on x, a thread a (tile, lane), so every load
// and store is a warp's 32 neighbouring lanes of one sample row.  Pass 1
// writes each (tile, lane)'s first break, or S, to a small (tiles, B)
// array, and stops reading at it.  Pass 2 takes the first break after
// its tile from the tiles that follow (a run may cross many tiles; the
// walk stops at the first tile with a break), then walks its tile
// backward, writing each run and moving the next break down as it
// meets one.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;     // samples a tile
constexpr int kLanes = 128;   // lanes (threads) a block

__global__ void __launch_bounds__(kLanes)
    first_break_kernel(const int32_t* __restrict__ errs, const int32_t* __restrict__ n,
                       int B, int S, int32_t* __restrict__ first) {
  const int b = blockIdx.x * kLanes + threadIdx.x;
  if (b >= B) return;
  const int tile = blockIdx.y;
  const int s0 = tile * kTile, s1 = min(s0 + kTile, S);
  const int nb = n[b];
  // samples from lim on break for being at or past n
  const int lim = nb < s1 ? max(s0, nb) : s1;
  int f = lim < s1 ? lim : S;
  for (int s = s0; s < lim; ++s) {
    if (errs[(size_t)s * B + b] != 0) {
      f = s;
      break;
    }
  }
  first[(size_t)tile * B + b] = f;
}

__global__ void __launch_bounds__(kLanes)
    runs_kernel(const int32_t* __restrict__ errs, const int32_t* __restrict__ n, int B,
                int S, int tiles, const int32_t* __restrict__ first,
                int32_t* __restrict__ out) {
  const int b = blockIdx.x * kLanes + threadIdx.x;
  if (b >= B) return;
  const int tile = blockIdx.y;
  int nxt = S;  // the next break at or after the tile's end
  for (int t = tile + 1; t < tiles; ++t) {
    const int f = first[(size_t)t * B + b];
    if (f < S) {
      nxt = f;
      break;
    }
  }
  const int s0 = tile * kTile, s1 = min(s0 + kTile, S);
  const int nb = n[b];
#pragma unroll 8
  for (int i = s1 - 1; i >= s0; --i) {
    const int r = nxt - (i + 1);  // zeros from i + 1 on
    out[(size_t)i * B + b] = r < 0xFFFF ? r : 0xFFFF;
    if (i >= nb || errs[(size_t)i * B + b] != 0) nxt = i;
  }
}

}  // namespace

// errs, out: (S, B) int32; n: (B,) int32; first: (ceil(S / 64), B) int32
// scratch.  Two launches on one stream.  The caller guarantees
// ceil(S / 64) <= 65535.
extern "C" int alac_zero_runs(const void* errs, const void* n, int B, int S, void* first,
                              void* out, void* stream) {
  if (B > 0 && S > 0) {
    const int tiles = (S + kTile - 1) / kTile;
    const dim3 grid((B + kLanes - 1) / kLanes, tiles);
    first_break_kernel<<<grid, kLanes, 0, (cudaStream_t)stream>>>(
        (const int32_t*)errs, (const int32_t*)n, B, S, (int32_t*)first);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    runs_kernel<<<grid, kLanes, 0, (cudaStream_t)stream>>>(
        (const int32_t*)errs, (const int32_t*)n, B, S, tiles, (const int32_t*)first,
        (int32_t*)out);
  }
  return (int)cudaGetLastError();
}
