// The decode epilogue, for Hopper (sm_90a).
//
// Replaces: the elementwise stretch at the end of the JAX package's
// decode, alacnet_tpu/ops/frame_decode.py `_decode_frames_impl`
// (:392-438), which XLA fuses into one loop under jit (no Pallas
// kernel).  Per lane b and sample s < S it picks the compressed or the
// raw sample (raw ones sign-extended: plainly for sample_size <= 16, the
// reference's 24-bit (x ^ m) - m form above), undoes the stereo
// decorrelation, merges the extra bits (24-bit lanes with ub > 0), wraps
// 24-bit values to their low 24 bits, zeroes channel B of mono lanes and
// every sample at s >= n, and writes the interleaved (L, R) pair as
// int32 or, under emit16, its low 16 bits as int16.  The plain torch
// version is `decode_epilogue_plain` (alacnet_tpu_torch/ops/cuda/
// epilogue.py), bit for bit: int32 arithmetic wraps (products and sums
// on uint32 here), shl gives 0 and sra the sign fill for counts outside
// [0, 31] (ops/bitops.py), as torch's int32 shifts do.
//
// What bounds it on the H100: memory traffic.  Each output pair costs a
// few dozen integer operations against 12 bytes moved (stereo 16-bit:
// two int32 samples in, one int16 pair out); one pass over the planes is
// the least the function can do, where the plain chain's ~28 torch ops
// make ~28 passes.
//
// What the design does about it: one pass.  A block owns kLanes lanes by
// kTile samples.  The compressed planes come from the rice_lpc kernel as
// sample-major (S, B) storage (a flag per plane also takes lane-major
// rows), so the block stages its tile of each through shared memory with
// loads coalesced along whichever axis is contiguous, then each thread
// takes one lane and two groups of 4 consecutive samples: the lane-major
// planes (extra bits, raw bodies) with one 16-byte load a group, the
// output with 16-byte stores (int16: one a group, int32: two), where S
// and every pointer allow it (`vec`), else element by element.  A plane
// that the caller passes as null reads as zeros and is never allocated.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 32;                  // lanes a block
constexpr int kTile = 64;                   // samples a block
constexpr int kThreads = 256;
constexpr int kPerLane = kThreads / kLanes;  // threads a lane: 8
constexpr int kGroups = kTile / 4 / kPerLane;  // 4-sample groups a thread: 2

struct Planes {
  const int32_t* out_a;  // compressed channel A (kernel 2), may be null
  const int32_t* out_b;  // compressed channel B, may be null
  const int32_t* extra_a;  // (B, S) lane-major extra bits, may be null
  const int32_t* extra_b;
  const int32_t* raw_a;  // (B, S) lane-major raw bodies, may be null
  const int32_t* raw_b;
  bool a_sm, b_sm;  // out_a / out_b are sample-major (S, B) storage
};

struct Columns {  // per-lane (B,) columns
  const uint8_t* stereo;  // bool
  const uint8_t* comp;    // bool
  const int32_t* ss;      // sample_size
  const int32_t* ub;
  const int32_t* shift;
  const int32_t* lw;      // interlacing_leftweight
  const int32_t* n;       // samples to keep, clamped to [0, S] by the caller
};

__device__ __forceinline__ int32_t shl(int32_t x, int32_t c) {
  return (c < 0 || c > 31) ? 0 : (int32_t)((uint32_t)x << c);
}

__device__ __forceinline__ int32_t sra(int32_t x, int32_t c) {
  return (c < 0 || c > 31) ? (x < 0 ? -1 : 0) : (x >> c);
}

// `_extend_raw`: ss <= 16 sign-extends the low ss bits
// ((x << (32 - ss) & 31) >> the same), above it the 24-bit form.
__device__ __forceinline__ int32_t extend_raw(int32_t v, int32_t ss) {
  if (ss <= 16) {
    const int32_t sh = (int32_t)((32u - (uint32_t)ss) & 31u);
    return (int32_t)((uint32_t)v << sh) >> sh;
  }
  return ((v & 0xFFFFFF) ^ 0x800000) - 0x800000;
}

// One lane's columns, read once and folded into what each sample needs.
struct Lane {
  bool comp, stereo, use_w, has_extra, extra_b, is24;
  int32_t ss, lw, sh, ub8, mask, n;
};

__device__ __forceinline__ Lane load_lane(const Columns& c, int b) {
  Lane L;
  L.comp = c.comp[b] != 0;
  L.stereo = c.stereo[b] != 0;
  L.ss = c.ss[b];
  L.n = c.n[b];
  L.lw = L.comp ? c.lw[b] : 0;
  L.sh = (L.comp ? c.shift[b] : 0) & 31;
  L.use_w = L.lw != 0 && L.stereo;
  L.ub8 = L.comp ? (int32_t)((uint32_t)c.ub[b] * 8u) : 0;
  L.mask = shl(-1, L.ub8) ^ -1;
  L.is24 = L.ss > 16;
  L.has_extra = L.ub8 > 0 && L.is24;
  L.extra_b = L.has_extra && L.stereo;
  return L;
}

// The epilogue of one sample: (left, right) from the six plane values.
__device__ __forceinline__ void sample(const Lane& L, int32_t oa, int32_t ob,
                                       int32_t ea, int32_t eb, int32_t ra,
                                       int32_t rb, bool live, int32_t& left,
                                       int32_t& right) {
  const int32_t a = L.comp ? oa : extend_raw(ra, L.ss);
  const int32_t b = L.comp ? ob : extend_raw(rb, L.ss);
  left = a;
  right = b;
  if (L.use_w) {  // decorrelation (AlacFile.cs:338-421)
    const int32_t bw = (int32_t)((uint32_t)b * (uint32_t)L.lw);
    right = (int32_t)((uint32_t)a - (uint32_t)sra(bw, L.sh));
    left = (int32_t)((uint32_t)right + (uint32_t)b);
  }
  if (L.has_extra) {  // extra-bits merge (:381-395,549-554)
    left = shl(left, L.ub8) | (ea & L.mask);
    if (L.extra_b) right = shl(right, L.ub8) | (eb & L.mask);
  }
  if (L.is24) {  // the 3-byte layout keeps the low 24 bits
    left = sra(shl(left, 8), 8);
    right = sra(shl(right, 8), 8);
  }
  left = live ? left : 0;
  right = live && L.stereo ? right : 0;
}

// A (kTile, kLanes) tile of a compressed plane into shared memory, each
// warp reading 32 consecutive words of the plane's contiguous axis.
__device__ __forceinline__ void stage(int32_t (*tile)[kLanes + 1],
                                      const int32_t* __restrict__ plane, bool sm,
                                      int b0, int s0, int B, int S) {
  if (plane == nullptr) return;
  for (int i = threadIdx.x; i < kLanes * kTile; i += kThreads) {
    int l, s;
    if (sm) {
      s = i / kLanes;
      l = i % kLanes;
    } else {
      l = i / kTile;
      s = i % kTile;
    }
    const int b = b0 + l, si = s0 + s;
    int32_t v = 0;
    if (b < B && si < S) {
      v = sm ? plane[(size_t)si * B + b] : plane[(size_t)b * S + si];
    }
    tile[s][l] = v;
  }
}

// Four consecutive samples of a lane-major plane from sample s.
__device__ __forceinline__ void load4(const int32_t* __restrict__ plane, size_t row,
                                      int s, int S, bool vec, int32_t v[4]) {
  if (plane == nullptr) {
    v[0] = v[1] = v[2] = v[3] = 0;
  } else if (vec && s + 3 < S) {
    const int4 q = *reinterpret_cast<const int4*>(plane + row + s);
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = s + j < S ? plane[row + s + j] : 0;
  }
}

__device__ __forceinline__ uint32_t pack16(int32_t lo, int32_t hi) {
  return (uint32_t)(uint16_t)lo | ((uint32_t)(uint16_t)hi << 16);
}

// Four interleaved (L, R) pairs from sample s of the lane's output row.
__device__ __forceinline__ void store4(int16_t* __restrict__ out, size_t row, int s,
                                       int S, bool vec, const int32_t l[4],
                                       const int32_t r[4]) {
  if (vec && s + 3 < S) {
    *reinterpret_cast<uint4*>(out + 2 * (row + s)) = make_uint4(
        pack16(l[0], r[0]), pack16(l[1], r[1]), pack16(l[2], r[2]), pack16(l[3], r[3]));
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (s + j < S) {
      out[2 * (row + s + j)] = (int16_t)(uint16_t)l[j];
      out[2 * (row + s + j) + 1] = (int16_t)(uint16_t)r[j];
    }
  }
}

__device__ __forceinline__ void store4(int32_t* __restrict__ out, size_t row, int s,
                                       int S, bool vec, const int32_t l[4],
                                       const int32_t r[4]) {
  if (vec && s + 3 < S) {
    int4* q = reinterpret_cast<int4*>(out + 2 * (row + s));
    q[0] = make_int4(l[0], r[0], l[1], r[1]);
    q[1] = make_int4(l[2], r[2], l[3], r[3]);
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (s + j < S) {
      out[2 * (row + s + j)] = l[j];
      out[2 * (row + s + j) + 1] = r[j];
    }
  }
}

template <typename Out>
__global__ void __launch_bounds__(kThreads)
    epilogue_kernel(Planes p, Columns c, int B, int S, bool vec, Out* __restrict__ out) {
  __shared__ int32_t ta[kTile][kLanes + 1];
  __shared__ int32_t tb[kTile][kLanes + 1];
  const int b0 = blockIdx.x * kLanes, s0 = blockIdx.y * kTile;
  stage(ta, p.out_a, p.a_sm, b0, s0, B, S);
  stage(tb, p.out_b, p.b_sm, b0, s0, B, S);
  __syncthreads();
  const int l = threadIdx.x / kPerLane, b = b0 + l;
  if (b >= B) return;
  const Lane L = load_lane(c, b);
  const size_t row = (size_t)b * S;
#pragma unroll
  for (int k = 0; k < kGroups; ++k) {
    // groups of a warp's threads are neighbours: coalesced per instruction
    const int g = threadIdx.x % kPerLane + kPerLane * k;
    const int s = s0 + 4 * g;
    if (s >= S) break;
    int32_t ea[4], eb[4], ra[4], rb[4], left[4], right[4];
    load4(p.extra_a, row, s, S, vec, ea);
    load4(p.extra_b, row, s, S, vec, eb);
    load4(p.raw_a, row, s, S, vec, ra);
    load4(p.raw_b, row, s, S, vec, rb);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int32_t oa = p.out_a ? ta[4 * g + j][l] : 0;
      const int32_t ob = p.out_b ? tb[4 * g + j][l] : 0;
      sample(L, oa, ob, ea[j], eb[j], ra[j], rb[j], s + j < L.n, left[j], right[j]);
    }
    store4(out, row, s, S, vec, left, right);
  }
}

// The epilogue into an output of C channels a sample (a pool of frames
// of up to 8 channels, ops/frame_decode._element_chain): the same
// samples as `epilogue_kernel`, written element by element.  Without
// `coff` (the frame's first element) each lane writes its whole row:
// channel 0, channel 1 (zero for a mono lane) and zeros in the others;
// with it, each lane writes only its element's channel or pair, at
// channel coff[b], and a lane whose coff is negative writes nothing.
template <typename Out>
__global__ void __launch_bounds__(kThreads)
    epilogue_wide_kernel(Planes p, Columns c, int B, int S, int C,
                         const int32_t* __restrict__ coff, Out* __restrict__ out) {
  __shared__ int32_t ta[kTile][kLanes + 1];
  __shared__ int32_t tb[kTile][kLanes + 1];
  const int b0 = blockIdx.x * kLanes, s0 = blockIdx.y * kTile;
  stage(ta, p.out_a, p.a_sm, b0, s0, B, S);
  stage(tb, p.out_b, p.b_sm, b0, s0, B, S);
  __syncthreads();
  const int l = threadIdx.x / kPerLane, b = b0 + l;
  if (b >= B) return;
  const int off = coff ? coff[b] : 0;
  if (off < 0) return;
  const Lane L = load_lane(c, b);
  const size_t row = (size_t)b * S;
#pragma unroll
  for (int k = 0; k < kGroups; ++k) {
    const int g = threadIdx.x % kPerLane + kPerLane * k;
    const int s = s0 + 4 * g;
    if (s >= S) break;
    int32_t ea[4], eb[4], ra[4], rb[4];
    load4(p.extra_a, row, s, S, false, ea);
    load4(p.extra_b, row, s, S, false, eb);
    load4(p.raw_a, row, s, S, false, ra);
    load4(p.raw_b, row, s, S, false, rb);
#pragma unroll
    for (int j = 0; j < 4 && s + j < S; ++j) {
      const int32_t oa = p.out_a ? ta[4 * g + j][l] : 0;
      const int32_t ob = p.out_b ? tb[4 * g + j][l] : 0;
      int32_t left, right;
      sample(L, oa, ob, ea[j], eb[j], ra[j], rb[j], s + j < L.n, left, right);
      Out* o = out + (row + s + j) * C + off;
      if (coff == nullptr) {
        o[0] = (Out)left;
        o[1] = (Out)right;
        for (int x = 2; x < C; ++x) o[x] = 0;
      } else {
        o[0] = (Out)left;
        if (L.stereo) o[1] = (Out)right;
      }
    }
  }
}

}  // namespace

// planes: out_a, out_b, extra_a, extra_b, raw_a, raw_b (any may be null);
// columns: stereo, comp (bool), sample_size, ub, shift, leftweight, n
// (int32); out: (B, S, C) int16 under emit16, else int32; coff: (B,)
// int32 or null.  C = 2 without coff is `epilogue_kernel`, any other
// `epilogue_wide_kernel`.  The caller guarantees ceil(S / 64) <= 65535.
extern "C" int alac_dec_epilogue(const void* out_a, const void* out_b, int a_sm,
                                 int b_sm, const void* extra_a, const void* extra_b,
                                 const void* raw_a, const void* raw_b,
                                 const void* stereo, const void* comp, const void* ss,
                                 const void* ub, const void* shift, const void* lw,
                                 const void* n, int B, int S, int emit16, int C,
                                 const void* coff, void* out, void* stream) {
  if (B > 0 && S > 0) {
    const Planes p{(const int32_t*)out_a, (const int32_t*)out_b,
                   (const int32_t*)extra_a, (const int32_t*)extra_b,
                   (const int32_t*)raw_a, (const int32_t*)raw_b, a_sm != 0, b_sm != 0};
    const Columns c{(const uint8_t*)stereo, (const uint8_t*)comp, (const int32_t*)ss,
                    (const int32_t*)ub, (const int32_t*)shift, (const int32_t*)lw,
                    (const int32_t*)n};
    const uintptr_t ptrs = (uintptr_t)extra_a | (uintptr_t)extra_b | (uintptr_t)raw_a |
                           (uintptr_t)raw_b | (uintptr_t)out;
    const bool vec = S % 4 == 0 && ptrs % 16 == 0;
    const dim3 grid((B + kLanes - 1) / kLanes, (S + kTile - 1) / kTile);
    if (C != 2 || coff != nullptr) {
      if (emit16) {
        epilogue_wide_kernel<int16_t><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
            p, c, B, S, C, (const int32_t*)coff, (int16_t*)out);
      } else {
        epilogue_wide_kernel<int32_t><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
            p, c, B, S, C, (const int32_t*)coff, (int32_t*)out);
      }
    } else if (emit16) {
      epilogue_kernel<int16_t><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
          p, c, B, S, vec, (int16_t*)out);
    } else {
      epilogue_kernel<int32_t><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
          p, c, B, S, vec, (int32_t*)out);
    }
  }
  return (int)cudaGetLastError();
}
