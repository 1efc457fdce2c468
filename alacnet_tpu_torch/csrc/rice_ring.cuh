// The block skeleton of the two Rice emitter kernels, enc_rice.cu (the
// four fields of a sample merged into a 96-bit chunk) and rice_emit.cu
// (the fields written unmerged, as symbol planes): a state warp and
// kEmitWarps emit warps per block of kLanes lanes, and the ring of
// sample tiles between them.  The ring protocol lives here once; each
// kernel supplies only its emit body.
//
// What bounds both on the H100: the history, sign-modifier and skip
// state make each lane a serial recurrence, and an encode chunk is 2048
// lanes, so the kernels are bound by per-lane latency and issue, not by
// bytes or the card's operation rate.  The symbols depend on the state
// only through k, kz and two flags, so the serial part runs apart from
// them:
//  - a block owns kLanes = 16 lanes (a chunk's 2048 lanes on 128 SMs;
//    32-lane blocks measured 2% slower) and runs 1 + kEmitWarps warps,
//    each on its own scheduler, threads past kLanes idle;
//  - the state warp (a thread per lane) runs only the serial part,
//    enc_rice_common.cuh's state_step, for the block's first T tiles of
//    kTile samples, and writes each sample's (raw, zr, k | kz | live
//    flags) into a ring of kSymSlots tiles in shared memory.  Its
//    inputs come through its own ring of kInSlots tiles (residuals,
//    zero runs), filled by 16-byte cp.async copies kInSlots - 1 tiles
//    ahead, so no device-memory load sits on its chain;
//  - the emit warps take the ring's tiles in turn (tile c to warp
//    c % kEmitWarps) and run the kernel's emit body: symbol_step (both
//    nine-step ladders) and its own outputs, stored with 16-byte stores;
//  - tiles are handed over with named barriers, FULL(s) and FREE(s) per
//    ring slot (ids 1..2 * kSymSlots), each between the state warp and
//    the one emit warp of the tile; kSymSlots is a multiple of
//    kEmitWarps, so a slot's tiles all go to one emit warp, which takes
//    them in order (a 64-thread named barrier completes with any second
//    warp).
//
// The handover clamps k to [0, 32] and kz to [0, 31] (8 bits each).
// emit_sym reads k only through clamp(k, 1, 31) and k == 1, for the
// values as for the widths, and the clamp keeps both, so every field of
// a symbol, live or not, is the one the unclamped k gives.
//
// A kernel's Body supplies: Args (with an `In in` member), Smem (with a
// `Ring ring` member), tiles() (the tiles the state warp runs, uniform
// across the block), emit_warp() and finish() (after __syncthreads).
// Planes are sample-major (S, B); any B and S (16-byte copies and
// stores where B % 16 == 0 and the planes are 16-byte aligned, one
// element a copy otherwise).

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "enc_rice_common.cuh"
#include "ring_sync.cuh"

namespace alac_rice_ring {

using namespace alac_rice;
using namespace alac_ring;

constexpr int kLanes = 16;                  // lanes per block
constexpr int kEmitWarps = 3;
constexpr int kThreads = 32 * (1 + kEmitWarps);
constexpr int kTile = 16;                   // samples per tile
constexpr int kInSlots = 4;                 // the state warp's input ring
constexpr int kInAhead = kInSlots - 1;
constexpr int kSymSlots = 2 * kEmitWarps;   // a multiple of kEmitWarps
constexpr int kPair = 64;                   // threads at a barrier: two warps

// Named barriers 1..2*kSymSlots.
__device__ __forceinline__ int bar_full(int s) { return 1 + s; }
__device__ __forceinline__ int bar_free(int s) { return 1 + kSymSlots + s; }

struct Ring {
  int32_t err[kInSlots][kTile][kCols];   // 8 KB
  int32_t zr[kInSlots][kTile][kCols];    // 8 KB
  // The symbol ring: per sample raw, zr and the packed k/kz/flags from
  // the state warp (enc_rice's emit warps overwrite them with chunks).
  int32_t s0[kSymSlots][kTile][kCols];   // 12 KB
  int32_t s1[kSymSlots][kTile][kCols];   // 12 KB
  int32_t s2[kSymSlots][kTile][kCols];   // 12 KB
};

// What both kernels read, and the desync flag both write.
struct In {
  const int32_t* __restrict__ errs;
  const int32_t* __restrict__ zr;
  int B, S;
  bool vec;
  const int32_t* __restrict__ n;
  const int32_t* __restrict__ rss;
  const int32_t* __restrict__ kmod;
  const int32_t* __restrict__ ihist;
  const int32_t* __restrict__ mult;
  const int32_t* __restrict__ kmask;
  bool* __restrict__ bad;
};

__device__ __forceinline__ int32_t pack_meta(const StepOut& o) {
  const int32_t k = o.k < 0 ? 0 : (o.k > 32 ? 32 : o.k);
  const int32_t kz = o.kz < 0 ? 0 : o.kz;
  return k | (kz << 8) | ((int32_t)o.emit_v << 16) | ((int32_t)o.emit_z << 17);
}
__device__ __forceinline__ StepOut unpack_meta(int32_t raw, int32_t m) {
  StepOut o;
  o.raw = raw;
  o.k = m & 0xFF;
  o.kz = (m >> 8) & 0xFF;
  o.emit_v = (m >> 16) & 1;
  o.emit_z = (m >> 17) & 1;
  return o;
}

// Tiles up to the block's longest lane (uniform across the block).
__device__ __forceinline__ int live_tiles(const In& a, int lane, int b) {
  const int32_t n = lane < kLanes && b < a.B ? a.n[b] : 0;
  const int nlive = n < 0 ? 0 : (n > a.S ? a.S : n);
  const int nmax = (int)__reduce_max_sync(0xFFFFFFFFu, (unsigned)nlive);
  return (nmax + kTile - 1) / kTile;
}

// ---- state warp: the serial part of the automaton, tiles 0..T-1 ----
__device__ __forceinline__ void state_warp(const In& a, Ring& sm, int lane, int b,
                                           int b0, int T) {
  const bool valid = lane < kLanes && b < a.B;
  const Params p{valid ? a.n[b] : 0, 0, valid ? a.kmod[b] : 0,
                 valid ? a.mult[b] : 0, 0};
  State st{valid ? a.ihist[b] : 0, 0, 0, false};
  for (int j = 0; j < kInAhead; ++j) {
    if (j < T) {
      load_tile<kLanes, kTile>(sm.err[j], a.errs, a.B, a.S, b0, j * kTile, a.vec, lane);
      load_tile<kLanes, kTile>(sm.zr[j], a.zr, a.B, a.S, b0, j * kTile, a.vec, lane);
    }
    cp_async_commit();
  }
  for (int c = 0; c < T; ++c) {
    // Tile c + kInAhead goes into the slot that tile c - 1 held, once
    // every thread has read it; one group per tile, so all but the
    // newest kInAhead landed is tile c landed.
    __syncwarp();
    const int j = c + kInAhead;
    if (j < T) {
      load_tile<kLanes, kTile>(sm.err[j % kInSlots], a.errs, a.B, a.S, b0, j * kTile,
                          a.vec, lane);
      load_tile<kLanes, kTile>(sm.zr[j % kInSlots], a.zr, a.B, a.S, b0, j * kTile,
                          a.vec, lane);
    }
    cp_async_commit();
    cp_async_wait<kInAhead>();
    __syncwarp();

    const int s = c % kSymSlots, ri = c % kInSlots;
    if (c >= kSymSlots) bar_sync(bar_free(s), kPair);
    const int rows = min(kTile, a.S - c * kTile);
#pragma unroll 4
    for (int r = 0; r < rows; ++r) {
      const int32_t zr = sm.zr[ri][r][lane];
      const StepOut o = state_step(st, p, c * kTile + r, sm.err[ri][r][lane], zr);
      sm.s0[s][r][lane] = o.raw;
      sm.s1[s][r][lane] = zr;
      sm.s2[s][r][lane] = pack_meta(o);
    }
    bar_arrive(bar_full(s), kPair);
  }
  cp_async_wait<0>();
  if (valid) a.bad[b] = st.bad;
}

template <class Body>
__global__ void __launch_bounds__(kThreads) ring_kernel(const typename Body::Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto& sm = *reinterpret_cast<typename Body::Smem*>(smem_raw);
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b0 = blockIdx.x * kLanes, b = b0 + lane;
  // Every warp walks the same tiles.
  const int T = Body::tiles(a.in, lane, b);
  if (w == 0) {
    state_warp(a.in, sm.ring, lane, b, b0, T);
  } else {
    Body::emit_warp(a, sm, w - 1, lane, b, b0, T);
  }
  __syncthreads();
  Body::finish(a, sm, w, lane, b);
}

// Launch Body's kernel over a.in.B lanes; the CUDA error code.
template <class Body>
int launch(const typename Body::Args& a, void* stream) {
  if (a.in.B <= 0) return (int)cudaGetLastError();
  // Above 48 KB of shared memory a block must ask for it.
  const cudaError_t e = cudaFuncSetAttribute(
      ring_kernel<Body>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)sizeof(typename Body::Smem));
  if (e != cudaSuccess) return (int)e;
  ring_kernel<Body><<<(a.in.B + kLanes - 1) / kLanes, kThreads,
                      sizeof(typename Body::Smem), (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace alac_rice_ring
