// The encoder's prologue, for Hopper (sm_90a).
//
// Replaces: the elementwise head of alacnet_tpu/ops/encode.py
// `encode_stages_pcm` (:465-524), which XLA fuses under jit into the
// automaton prologue (no Pallas kernel), together with the transpose
// that feeds the enc_pred kernel its sample-major signal.  From the
// interleaved PCM (F, S, 2) int32 and the (F,) stereo flags it strips
// the extra bits (hi = x >> ub8), decorrelates stereo frames
// (cb = L - R, ca = R + ((cb * lw) >> sh) where lw != 0) and folds the
// channels into 2F lanes: lane f takes ca (stereo) or L (mono), lane
// F + f takes cb (stereo) or 0 (mono).  The output is the (S, 2F)
// sample-major storage that enc_pred reads.  Narrow content multiplies
// in int32 with wraparound (on uint32 here); `wide` content takes the
// product in int64, shifts it and keeps its low 32 bits, as the host
// encoder does.  Shift counts past the type's width give the sign fill,
// as torch's shifts do (the wrapper clamps them).  The plain torch
// version is `encode_prologue_plain` (alacnet_tpu_torch/ops/cuda/
// enc_prologue.py), bit for bit.
//
// What bounds it on the H100: memory traffic, 8 bytes read and 8
// written a frame-sample, against a handful of integer operations.  The
// plain chain's thirteen-odd torch ops, its cat and the transposing copy
// move some ten times that.
//
// What the design does about it: one pass, the reverse of
// dec_epilogue.cu's transpose.  A block owns kFrames frames by kTile
// samples.  It reads its tile frame row by frame row (a warp 512
// contiguous bytes, a thread one 16-byte (L, R, L, R) load where S is
// even and pcm 16-byte aligned, `vec_in`), computes both lanes' values
// and stages them in two padded shared tiles, sample-major.  Then each
// thread writes 4 neighbouring lanes of one sample row of one half (f or
// F + f) with a 16-byte store where F % 4 == 0 and the output is
// aligned (`vec_out`), else word by word; those reads of the tiles are
// free of bank conflicts.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kFrames = 32;  // frames a block
constexpr int kTile = 64;    // samples a block
constexpr int kThreads = 256;

// One frame-sample: its two lane values.
template <bool WIDE>
__device__ __forceinline__ void fold(int32_t L, int32_t R, bool stereo, int lw, int sh,
                                     int ub8, int32_t& a, int32_t& b) {
  const int32_t l = L >> ub8, r = R >> ub8;
  int32_t ca = l, cb = r;
  if (lw != 0) {
    cb = (int32_t)((uint32_t)l - (uint32_t)r);
    int32_t adj;
    if (WIDE) {
      adj = (int32_t)(uint32_t)(((long long)cb * (long long)lw) >> sh);
    } else {
      adj = (int32_t)((uint32_t)cb * (uint32_t)lw) >> sh;
    }
    ca = (int32_t)((uint32_t)r + (uint32_t)adj);
  }
  a = stereo ? ca : l;
  b = stereo ? cb : 0;
}

template <bool WIDE>
__global__ void __launch_bounds__(kThreads)
    prologue_kernel(const int32_t* __restrict__ pcm, const uint8_t* __restrict__ stereo,
                    int F, int S, int lw, int sh, int ub8, bool vec_in, bool vec_out,
                    int32_t* __restrict__ out) {
  __shared__ int32_t ta[kTile][kFrames + 1];
  __shared__ int32_t tb[kTile][kFrames + 1];
  const int f0 = blockIdx.x * kFrames, s0 = blockIdx.y * kTile;
  constexpr int kPairs = kTile / 2;  // sample pairs of a frame's tile row
  for (int i = threadIdx.x; i < kFrames * kPairs; i += kThreads) {
    const int l = i / kPairs, p = i % kPairs;
    const int f = f0 + l, s = s0 + 2 * p;
    int32_t a0 = 0, b0 = 0, a1 = 0, b1 = 0;
    if (f < F && s < S) {
      const int32_t* row = pcm + ((size_t)f * S + s) * 2;
      int4 q;
      if (vec_in) {  // S even: s + 1 < S too
        q = *reinterpret_cast<const int4*>(row);
      } else {
        q = make_int4(row[0], row[1], 0, 0);
        if (s + 1 < S) {
          q.z = row[2];
          q.w = row[3];
        }
      }
      const bool st = stereo[f] != 0;
      fold<WIDE>(q.x, q.y, st, lw, sh, ub8, a0, b0);
      fold<WIDE>(q.z, q.w, st, lw, sh, ub8, a1, b1);
    }
    ta[2 * p][l] = a0;
    tb[2 * p][l] = b0;
    ta[2 * p + 1][l] = a1;
    tb[2 * p + 1][l] = b1;
  }
  __syncthreads();
  constexpr int kGroups = kFrames / 4;  // 4-lane groups of a tile row
  const size_t row_words = 2 * (size_t)F;
  for (int i = threadIdx.x; i < 2 * kTile * kGroups; i += kThreads) {
    const int g = i % kGroups, r = (i / kGroups) % kTile, half = i / (kGroups * kTile);
    const int s = s0 + r, f = f0 + 4 * g;
    if (s >= S || f >= F) continue;
    const int32_t* t = half ? &tb[r][4 * g] : &ta[r][4 * g];
    int32_t* dst = out + (size_t)s * row_words + (size_t)half * F + f;
    if (vec_out) {  // F % 4 == 0: the group lies below F
      *reinterpret_cast<int4*>(dst) = make_int4(t[0], t[1], t[2], t[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (f + j < F) dst[j] = t[j];
      }
    }
  }
}

}  // namespace

// pcm: (F, S, 2) int32; stereo: (F,) bool; out: (S, 2F) int32.  The
// caller guarantees ceil(S / 64) <= 65535, 0 <= ub8 <= 31, and
// 0 <= sh <= 31 (narrow) or <= 63 (wide).
extern "C" int alac_enc_prologue(const void* pcm, const void* stereo, int F, int S, int lw,
                                 int sh, int ub8, int wide, void* out, void* stream) {
  if (F > 0 && S > 0) {
    const bool vec_in = S % 2 == 0 && (uintptr_t)pcm % 16 == 0;
    const bool vec_out = F % 4 == 0 && (uintptr_t)out % 16 == 0;
    const dim3 grid((F + kFrames - 1) / kFrames, (S + kTile - 1) / kTile);
    if (wide) {
      prologue_kernel<true><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
          (const int32_t*)pcm, (const uint8_t*)stereo, F, S, lw, sh, ub8, vec_in, vec_out,
          (int32_t*)out);
    } else {
      prologue_kernel<false><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
          (const int32_t*)pcm, (const uint8_t*)stereo, F, S, lw, sh, ub8, vec_in, vec_out,
          (int32_t*)out);
    }
  }
  return (int)cudaGetLastError();
}
