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
// What bounds it on the H100, and the design: rice_ring.cuh, the block
// skeleton (a state warp running the serial step, three emit warps
// beside it, a ring of 16-sample tiles between them) that rice_emit.cu
// shares.  The first port ran the whole sample in one thread (~1,570
// cycles): a device-memory load, the serial state update, then two
// nine-step symbol ladders and the 96-bit merge.  This kernel's emit
// body:
//  - runs symbol_step (both ladders), the int8 width casts and the four
//    appends; writes its chunks in place of the tile's inputs and its
//    widths into its own int8 tile, stores them with 16-byte stores, and
//    keeps a per-lane partial of `bits`, summed at the end with wrapping
//    adds;
//  - samples past the block's longest lane (all widths 0) are stored as
//    zeros without being run: the state warp stops there.  The int8
//    widths go out 16 lanes to a store.
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

#include <cstdint>
#include <cuda_runtime.h>

#include "rice_ring.cuh"

namespace {

using namespace alac_rice_ring;

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

struct Merged {
  struct Args {
    In in;
    int32_t* __restrict__ c0;
    int32_t* __restrict__ c1;
    int32_t* __restrict__ c2;
    int8_t* __restrict__ ws;
    int32_t* __restrict__ bits;
  };
  struct Smem {
    Ring ring;                              // chunks overwrite s0..s2
    int8_t ws[kEmitWarps][kTile][kCols];    // 1.5 KB
    int32_t bits[kEmitWarps][kCols];
  };

  static __device__ __forceinline__ int tiles(const In& a, int lane, int b) {
    return live_tiles(a, lane, b);
  }

  // ---- emit warp e: symbols, widths, the merge, the stores ----
  static __device__ __forceinline__ void emit_warp(const Args& a, Smem& sm, int e,
                                                   int lane, int b, int b0, int T) {
    const In& in = a.in;
    Ring& rg = sm.ring;
    const bool valid = lane < kLanes && b < in.B;
    const Params p{0, valid ? in.rss[b] : 0, 0, 0, valid ? in.kmask[b] : 0};
    int32_t bits = 0;
    for (int c = e; c < T; c += kEmitWarps) {
      const int s = c % kSymSlots;
      bar_sync(bar_full(s), kPair);
      const int rows = min(kTile, in.S - c * kTile);
      // Samples are independent here: four at a time give the scheduler
      // four ladders to interleave.
#pragma unroll 4
      for (int r = 0; r < rows; ++r) {
        const int32_t zr = rg.s1[s][r][lane];
        const StepOut o = unpack_meta(rg.s0[s][r][lane], rg.s2[s][r][lane]);
        Sym sv, sz;
        symbol_step(o, zr, p, sv, sz);
        // Widths pass through int8, as the plain version's width planes
        // do (a no-op for every width a lane without a desync can have).
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
        rg.s0[s][r][lane] = (int32_t)ch;
        rg.s1[s][r][lane] = (int32_t)cm;
        rg.s2[s][r][lane] = (int32_t)cl;
        sm.ws[e][r][lane] = ws;
        bits = wadd(bits, ws);
      }
      __syncwarp();
      const int i0 = c * kTile;
      store_tile<int32_t, kLanes, kTile>(a.c0, rg.s0[s], in.B, in.S, b0, i0, in.vec, lane);
      store_tile<int32_t, kLanes, kTile>(a.c1, rg.s1[s], in.B, in.S, b0, i0, in.vec, lane);
      store_tile<int32_t, kLanes, kTile>(a.c2, rg.s2[s], in.B, in.S, b0, i0, in.vec, lane);
      store_tile<int8_t, kLanes, kTile>(a.ws, sm.ws[e], in.B, in.S, b0, i0, in.vec, lane);
      __syncwarp();
      if (c + kSymSlots < T) bar_arrive(bar_free(s), kPair);
    }
    // Every sample past the block's longest lane emits nothing: zeros.
    for (int i0 = (T + e) * kTile; i0 < in.S; i0 += kEmitWarps * kTile) {
      store_tile<int32_t, kLanes, kTile>(a.c0, nullptr, in.B, in.S, b0, i0, in.vec, lane);
      store_tile<int32_t, kLanes, kTile>(a.c1, nullptr, in.B, in.S, b0, i0, in.vec, lane);
      store_tile<int32_t, kLanes, kTile>(a.c2, nullptr, in.B, in.S, b0, i0, in.vec, lane);
      store_tile<int8_t, kLanes, kTile>(a.ws, nullptr, in.B, in.S, b0, i0, in.vec, lane);
    }
    sm.bits[e][lane] = bits;
  }

  static __device__ __forceinline__ void finish(const Args& a, Smem& sm, int w,
                                                int lane, int b) {
    if (w == 0 && lane < kLanes && b < a.in.B) {
      int32_t bits = 0;
#pragma unroll
      for (int e = 0; e < kEmitWarps; ++e) bits = wadd(bits, sm.bits[e][lane]);
      a.bits[b] = bits;
    }
  }
};

}  // namespace

extern "C" int alac_enc_rice(const void* errs_sb, const void* zr_sb, int B,
                             int S, const void* n, const void* rss,
                             const void* kmod, const void* ihist,
                             const void* mult, const void* kmask, void* c0_sb,
                             void* c1_sb, void* c2_sb, void* ws_sb, void* bits,
                             void* bad, void* stream) {
  const uintptr_t planes = (uintptr_t)errs_sb | (uintptr_t)zr_sb | (uintptr_t)c0_sb |
                           (uintptr_t)c1_sb | (uintptr_t)c2_sb | (uintptr_t)ws_sb;
  const bool vec = B % 16 == 0 && planes % 16 == 0;
  const Merged::Args a{
      {(const int32_t*)errs_sb, (const int32_t*)zr_sb, B, S, vec, (const int32_t*)n,
       (const int32_t*)rss, (const int32_t*)kmod, (const int32_t*)ihist,
       (const int32_t*)mult, (const int32_t*)kmask, (bool*)bad},
      (int32_t*)c0_sb, (int32_t*)c1_sb, (int32_t*)c2_sb, (int8_t*)ws_sb,
      (int32_t*)bits};
  return launch<Merged>(a, stream);
}
