// Rice / adaptive-Golomb emitter of the ALAC encoder, with the four bit
// fields of each sample merged into one right-aligned 96-bit chunk, one
// channel per lane, for Hopper (sm_90a).
//
// Replaces: alacnet_tpu/ops/pallas/enc_stages.py, `_rice_kernel` (reached
// via `rice_merge_fused` / `encode_stages_fused` -> `_rice_blocks`).  The
// per-sample expressions mirror that kernel's `sample` body (the
// decoder's EntropyRiceDecode state machine run forward,
// AlacFile.cs:214-252) and its `_merge4`; the plain torch version is
// ops/encode.rice_symbols -> merge_symbol_chunks -> ws.sum(1)
// (alacnet_tpu_torch/ops/cuda/enc_stages.py).
//
// What bounds it on the H100: the history, sign-modifier and skip state
// make each lane a serial recurrence, and a chunk is 2048 lanes, so the
// kernel is bound by per-lane latency and issue, not by bytes (8 in, 13
// out a sample) or the card's operation rate.  The first port ran the
// whole sample in one thread (~1,570 cycles): a device-memory load, the
// serial state update, then two nine-step symbol ladders and the 96-bit
// merge, though the symbols depend on the state only through k, kz and
// two flags.
//
// What the design does about it: a block owns kLanes = 16 lanes (a
// chunk's 2048 lanes on 128 SMs; 32-lane blocks measured 2% slower) and
// runs 1 + kEmitWarps warps, each on its own scheduler, threads past
// kLanes idle.
//  - The state warp (a thread per lane) runs only the serial part,
//    enc_rice_common.cuh's state_step, and writes each sample's (raw,
//    zr, k | kz | live flags) into a ring of kSymSlots tiles of kTile
//    samples in shared memory.  Its inputs come through its own ring of
//    kInSlots tiles (residuals, zero runs), filled by 16-byte cp.async
//    copies kInSlots - 1 tiles ahead, so no device-memory load sits on
//    its chain.
//  - The emit warps take the ring's tiles in turn (tile c to warp
//    c % kEmitWarps) and run symbol_step (both ladders), the int8 width
//    casts and the four appends; each writes its chunks in place of the
//    tile's inputs and its widths into its own int8 tile, stores them with
//    16-byte stores, and keeps a per-lane partial of `bits`, summed at the
//    end with wrapping adds.  So the ladders and the merge of kEmitWarps
//    tiles run beside the state chain.
//  - Tiles are handed over with named barriers, FULL(s) and FREE(s) per
//    ring slot, each between the state warp and the one emit warp of the
//    tile; kSymSlots is a multiple of kEmitWarps, so a slot's tiles all
//    go to one emit warp, which takes them in order.
//  - Samples past the block's longest lane (all widths 0) are stored as
//    zeros without being run.  Planes are sample-major (S, B); any B and
//    S (16-byte copies and stores where B % 16 == 0 and the planes are
//    aligned, one element a copy otherwise; the int8 widths go out 16
//    lanes to a store).
//
// What limits it now (measured on the H100, PERF.md §6): the state
// warp's serial step, ~5x faster than the first port but ~11x over the
// kernel's operation bound.  Without the emit warps' ladders and merge
// the kernel ran 3% faster, without the state step 26% faster.
//
// Bit-exactness: every wrapping product and sum runs in uint32_t
// (2*err, h*mult, dv*mult); shifts follow jax.lax (left by 32 or more
// gives 0, arithmetic right by 32 or more gives the sign fill); the
// merge's logical shifts give 0 for counts of 32 or more; clz(0) is 40.
// k travels clamped to [0, 32] and kz to [0, 31]: emit_sym reads them
// only through clamp(k, 1, 31) and k == 1, which the clamp keeps.

#include <cstdint>
#include <cuda_runtime.h>

#include "enc_rice_common.cuh"
#include "ring_sync.cuh"

namespace {

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

struct Smem {
  int32_t err[kInSlots][kTile][kCols];   // 8 KB
  int32_t zr[kInSlots][kTile][kCols];    // 8 KB
  // The symbol ring: per sample raw, zr and the packed k/kz/flags from
  // the state warp, overwritten in place with c0, c1, c2 by the emit warp.
  int32_t s0[kSymSlots][kTile][kCols];   // 12 KB
  int32_t s1[kSymSlots][kTile][kCols];   // 12 KB
  int32_t s2[kSymSlots][kTile][kCols];   // 12 KB
  int8_t ws[kEmitWarps][kTile][kCols];   // 1.5 KB
  int32_t bits[kEmitWarps][kCols];
};

struct Args {
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
  int32_t* __restrict__ c0;
  int32_t* __restrict__ c1;
  int32_t* __restrict__ c2;
  int8_t* __restrict__ ws;
  int32_t* __restrict__ bits;
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

// The merge's u32 shifts: c >= 32 gives 0, else the count's low 5 bits.
__device__ __forceinline__ uint32_t shl_u(uint32_t x, int32_t c) {
  return c >= 32 ? 0u : x << (c & 31);
}
__device__ __forceinline__ uint32_t shr_u(uint32_t x, int32_t c) {
  return c >= 32 ? 0u : x >> (c & 31);
}

// Append field (val, w) to the right-aligned 96-bit chunk h:m:l
// (`_merge4`, ops/encode.merge_symbol_chunks).
__device__ __forceinline__ void append(uint32_t& h, uint32_t& m, uint32_t& l,
                                       int32_t val, int32_t w) {
  const uint32_t v = (uint32_t)val & (shl_u(1u, w) - 1u);
  const int32_t inv = 32 - w;
  h = shl_u(h, w) | shr_u(m, inv);
  m = shl_u(m, w) | shr_u(l, inv);
  l = shl_u(l, w) | v;
}

// ---- state warp: the serial part of the automaton ----
__device__ __forceinline__ void state_warp(const Args& a, Smem& sm, int lane, int b,
                                           int b0, int nmax) {
  const bool valid = lane < kLanes && b < a.B;
  const Params p{valid ? a.n[b] : 0, 0, valid ? a.kmod[b] : 0,
                 valid ? a.mult[b] : 0, 0};
  State st{valid ? a.ihist[b] : 0, 0, 0, false};
  const int T = (nmax + kTile - 1) / kTile;
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

// ---- emit warp e: symbols, widths, the merge, the stores ----
__device__ __forceinline__ void emit_warp(const Args& a, Smem& sm, int e, int lane,
                                          int b, int b0, int nmax) {
  const bool valid = lane < kLanes && b < a.B;
  const Params p{0, valid ? a.rss[b] : 0, 0, 0, valid ? a.kmask[b] : 0};
  int32_t bits = 0;
  const int T = (nmax + kTile - 1) / kTile;
  for (int c = e; c < T; c += kEmitWarps) {
    const int s = c % kSymSlots;
    bar_sync(bar_full(s), kPair);
    const int rows = min(kTile, a.S - c * kTile);
    // Samples are independent here: four at a time give the scheduler
    // four ladders to interleave.
#pragma unroll 4
    for (int r = 0; r < rows; ++r) {
      const int32_t zr = sm.s1[s][r][lane];
      const StepOut o = unpack_meta(sm.s0[s][r][lane], sm.s2[s][r][lane]);
      Sym sv, sz;
      symbol_step(o, zr, p, sv, sz);
      // Widths pass through int8, as the plain version's width planes do
      // (a no-op for every width a lane without a desync can have).
      const int32_t w0 = (int8_t)(o.emit_v ? sv.w0 : 0);
      const int32_t w1 = (int8_t)(o.emit_v ? sv.w1 : 0);
      const int32_t w2 = (int8_t)(o.emit_z ? sz.w0 : 0);
      const int32_t w3 = (int8_t)(o.emit_z ? sz.w1 : 0);
      uint32_t ch = 0u, cm = 0u, cl = 0u;
      append(ch, cm, cl, sv.v0, w0);
      append(ch, cm, cl, sv.v1, w1);
      append(ch, cm, cl, sz.v0, w2);
      append(ch, cm, cl, sz.v1, w3);
      const int8_t ws = (int8_t)(w0 + w1 + w2 + w3);
      sm.s0[s][r][lane] = (int32_t)ch;
      sm.s1[s][r][lane] = (int32_t)cm;
      sm.s2[s][r][lane] = (int32_t)cl;
      sm.ws[e][r][lane] = ws;
      bits = wadd(bits, ws);
    }
    __syncwarp();
    const int i0 = c * kTile;
    store_tile<int32_t, kLanes, kTile>(a.c0, sm.s0[s], a.B, a.S, b0, i0, a.vec, lane);
    store_tile<int32_t, kLanes, kTile>(a.c1, sm.s1[s], a.B, a.S, b0, i0, a.vec, lane);
    store_tile<int32_t, kLanes, kTile>(a.c2, sm.s2[s], a.B, a.S, b0, i0, a.vec, lane);
    store_tile<int8_t, kLanes, kTile>(a.ws, sm.ws[e], a.B, a.S, b0, i0, a.vec, lane);
    __syncwarp();
    if (c + kSymSlots < T) bar_arrive(bar_free(s), kPair);
  }
  // Every sample past the block's longest lane emits nothing: zeros.
  for (int i0 = (T + e) * kTile; i0 < a.S; i0 += kEmitWarps * kTile) {
    store_tile<int32_t, kLanes, kTile>(a.c0, nullptr, a.B, a.S, b0, i0, a.vec, lane);
    store_tile<int32_t, kLanes, kTile>(a.c1, nullptr, a.B, a.S, b0, i0, a.vec, lane);
    store_tile<int32_t, kLanes, kTile>(a.c2, nullptr, a.B, a.S, b0, i0, a.vec, lane);
    store_tile<int8_t, kLanes, kTile>(a.ws, nullptr, a.B, a.S, b0, i0, a.vec, lane);
  }
  sm.bits[e][lane] = bits;
}

__global__ void __launch_bounds__(kThreads) enc_rice_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b0 = blockIdx.x * kLanes, b = b0 + lane;
  const int32_t n = lane < kLanes && b < a.B ? a.n[b] : 0;
  // Every warp walks the same tiles: up to the block's longest lane.
  const int nlive = n < 0 ? 0 : (n > a.S ? a.S : n);
  const int nmax = (int)__reduce_max_sync(0xFFFFFFFFu, (unsigned)nlive);
  if (w == 0) {
    state_warp(a, sm, lane, b, b0, nmax);
  } else {
    emit_warp(a, sm, w - 1, lane, b, b0, nmax);
  }
  __syncthreads();
  if (w == 0 && lane < kLanes && b < a.B) {
    int32_t bits = 0;
#pragma unroll
    for (int e = 0; e < kEmitWarps; ++e) bits = wadd(bits, sm.bits[e][lane]);
    a.bits[b] = bits;
  }
}

}  // namespace

extern "C" int alac_enc_rice(const void* errs_sb, const void* zr_sb, int B,
                             int S, const void* n, const void* rss,
                             const void* kmod, const void* ihist,
                             const void* mult, const void* kmask, void* c0_sb,
                             void* c1_sb, void* c2_sb, void* ws_sb, void* bits,
                             void* bad, void* stream) {
  if (B <= 0) return (int)cudaGetLastError();
  const uintptr_t planes = (uintptr_t)errs_sb | (uintptr_t)zr_sb | (uintptr_t)c0_sb |
                           (uintptr_t)c1_sb | (uintptr_t)c2_sb | (uintptr_t)ws_sb;
  const bool vec = B % 16 == 0 && planes % 16 == 0;
  const Args a{(const int32_t*)errs_sb, (const int32_t*)zr_sb, B, S, vec,
               (const int32_t*)n, (const int32_t*)rss, (const int32_t*)kmod,
               (const int32_t*)ihist, (const int32_t*)mult, (const int32_t*)kmask,
               (int32_t*)c0_sb, (int32_t*)c1_sb, (int32_t*)c2_sb, (int8_t*)ws_sb,
               (int32_t*)bits, (bool*)bad};
  // Above 48 KB of shared memory a block must ask for it.
  const cudaError_t e = cudaFuncSetAttribute(
      enc_rice_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sizeof(Smem));
  if (e != cudaSuccess) return (int)e;
  enc_rice_kernel<<<(B + kLanes - 1) / kLanes, kThreads, sizeof(Smem),
                    (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
