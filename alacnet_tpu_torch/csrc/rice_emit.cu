// Rice / adaptive-Golomb emitter of the ALAC encoder with the four bit
// fields of each sample written unmerged (the symbol planes), one
// channel per lane, for Hopper (sm_90a).
//
// Replaces: alacnet_tpu/ops/pallas/rice_emit.py, `_kernel` (reached via
// `rice_symbols_fused`).  Its plain torch version is
// ops/encode.rice_symbols (alacnet_tpu_torch/ops/cuda/rice_emit.py), and
// its output feeds the native symbol-plane packer
// (native.pack_symbol_frames_native).  The automaton is the one
// enc_rice.cu runs (enc_rice_common.cuh); only the output differs.
//
// What bounds it on the H100, and the design: rice_ring.cuh, the block
// skeleton it shares with enc_rice.cu (a state warp running the serial
// step, three emit warps beside it, a ring of 16-sample tiles between
// them).  The first port ran state_step and both symbol ladders in one
// thread per lane, in 32-lane blocks (2048 lanes on 64 SMs), with the
// device-memory loads on the serial chain.  This kernel's emit body:
//  - runs symbol_step and the low-bits casts of the plain version (int16
//    for the unary/marker fields, int8 for the widths), writes each
//    sample's [v0, v2] (4 bytes), [v1, v3] (8 bytes) and four widths
//    (4 bytes) into the emit warp's own output tiles, hands the ring
//    slot back, and stores the tiles with 16-byte stores: the planes are
//    (S, B, 2) int16, (S, B, 2) int32 and (S, B, 4) int8, so a tile row
//    of 16 lanes is 64, 128 and 64 contiguous bytes.
//
// Every output element is written, values where the width is 0 too, so
// the planes equal the plain version's everywhere.  Past a lane's n the
// plain version still computes the symbols (from the state, which holds
// there), so the state warp runs every sample to S; a block's tiles all
// take one wave of the card for a chunk's lanes, so that costs the main
// path nothing against stopping at the block's longest lane.

#include <cstdint>
#include <cuda_runtime.h>

#include "rice_ring.cuh"

namespace {

using namespace alac_rice_ring;

__device__ __forceinline__ uint32_t lo16(int32_t v) {
  return (uint32_t)(uint16_t)(uint32_t)v;
}
__device__ __forceinline__ uint32_t byte_of(int32_t w, int at) {
  return ((uint32_t)(uint8_t)(int8_t)w) << (8 * at);
}

struct Planes {
  struct Args {
    In in;
    uint32_t* __restrict__ v16;   // (S, B) words of two int16
    int2* __restrict__ v32;
    uint32_t* __restrict__ wid;   // (S, B) words of four int8
  };
  struct Smem {
    Ring ring;
    uint32_t v16[kEmitWarps][kTile][kCols];   // 6 KB
    int2 v32[kEmitWarps][kTile][kCols];       // 12 KB
    uint32_t wid[kEmitWarps][kTile][kCols];   // 6 KB
  };

  static __device__ __forceinline__ int tiles(const In& a, int, int) {
    return (a.S + kTile - 1) / kTile;
  }

  // ---- emit warp e: symbols, the int16 / int8 casts, the stores ----
  static __device__ __forceinline__ void emit_warp(const Args& a, Smem& sm, int e,
                                                   int lane, int b, int b0, int T) {
    const In& in = a.in;
    const Ring& rg = sm.ring;
    const bool valid = lane < kLanes && b < in.B;
    const Params p{0, valid ? in.rss[b] : 0, 0, 0, valid ? in.kmask[b] : 0};
    for (int c = e; c < T; c += kEmitWarps) {
      const int s = c % kSymSlots;
      bar_sync(bar_full(s), kPair);
      const int rows = min(kTile, in.S - c * kTile);
#pragma unroll 4
      for (int r = 0; r < rows; ++r) {
        const int32_t zr = rg.s1[s][r][lane];
        const StepOut o = unpack_meta(rg.s0[s][r][lane], rg.s2[s][r][lane]);
        Sym sv, sz;
        symbol_step(o, zr, p, sv, sz);
        sm.v16[e][r][lane] = lo16(sv.v0) | (lo16(sz.v0) << 16);
        sm.v32[e][r][lane] = make_int2(sv.v1, sz.v1);
        sm.wid[e][r][lane] = byte_of(o.emit_v ? sv.w0 : 0, 0) |
                             byte_of(o.emit_v ? sv.w1 : 0, 1) |
                             byte_of(o.emit_z ? sz.w0 : 0, 2) |
                             byte_of(o.emit_z ? sz.w1 : 0, 3);
      }
      __syncwarp();
      // The slot is read: the state warp may refill it while this warp
      // stores its own tiles.
      if (c + kSymSlots < T) bar_arrive(bar_free(s), kPair);
      const int i0 = c * kTile;
      store_tile<uint32_t, kLanes, kTile>(a.v16, sm.v16[e], in.B, in.S, b0, i0, in.vec, lane);
      store_tile<int2, kLanes, kTile>(a.v32, sm.v32[e], in.B, in.S, b0, i0, in.vec, lane);
      store_tile<uint32_t, kLanes, kTile>(a.wid, sm.wid[e], in.B, in.S, b0, i0, in.vec, lane);
      __syncwarp();
    }
  }

  static __device__ __forceinline__ void finish(const Args&, Smem&, int, int, int) {}
};

}  // namespace

extern "C" int alac_rice_emit(const void* errs_sb, const void* zr_sb, int B,
                              int S, const void* n, const void* rss,
                              const void* kmod, const void* ihist,
                              const void* mult, const void* kmask,
                              void* v16_sb, void* v32_sb, void* wid_sb,
                              void* bad, void* stream) {
  const uintptr_t planes = (uintptr_t)errs_sb | (uintptr_t)zr_sb | (uintptr_t)v16_sb |
                           (uintptr_t)v32_sb | (uintptr_t)wid_sb;
  const bool vec = B % 16 == 0 && planes % 16 == 0;
  const Planes::Args a{
      {(const int32_t*)errs_sb, (const int32_t*)zr_sb, B, S, vec, (const int32_t*)n,
       (const int32_t*)rss, (const int32_t*)kmod, (const int32_t*)ihist,
       (const int32_t*)mult, (const int32_t*)kmask, (bool*)bad},
      (uint32_t*)v16_sb, (int2*)v32_sb, (uint32_t*)wid_sb};
  return launch<Planes>(a, stream);
}
