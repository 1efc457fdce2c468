// The encoder's pair merge, and with it the quad merge, for Hopper (sm_90a).
//
// Replaces: `merge_pair_chunks` and `merge_quad_chunks` of the JAX
// package's alacnet_tpu/ops/encode.py (:324, :377), which XLA fuses into
// one elementwise loop under jit (no Pallas kernel).  Per lane, samples
// (2j, 2j + 1) fold into pair j: sample A's right-aligned 96-bit chunk
// shifted left by B's width (a sub-word shift by wb & 31 on the
// three-word ladder, counts of 32 or more giving 0, then a word roll by
// wb >> 5) ORed with B's; the pair's width is wa + wb, or -1 where it
// passes 96 bits, which also sets the lane's `fat` flag.  An odd S
// merges a zero-width tail.  With quads, pairs (2i, 2i + 1) fold the
// same way into quad i, a pair width of -1 clamped to 0 for the shifts
// and setting the lane's `qfat` flag.  The plain torch versions are
// merge_pair_chunks and merge_quad_chunks of alacnet_tpu_torch/ops/
// encode.py, bit for bit (int32 patterns on uint32 here; widths are the
// int8 values sign-extended, so any int8 width gives the plain
// version's bits).
//
// What bounds it on the H100: memory traffic.  A lane-sample reads 13
// bytes (three int32 chunk words and an int8 width) and a pair writes
// 13, a quad 13 more: 19.5 bytes a lane-sample, 22.75 with quads, for
// about 40 integer operations a pair.  The plain chain's ~70 torch ops
// (~150 with quads) each make a pass over strided views.
//
// What the design does about it: one pass, one launch.  The chunk
// planes come from the enc_rice kernel as sample-major (S, B) storage
// (any strides are taken; the tile's loads are coalesced where the lane
// stride is 1), and the outputs are lane-major, contiguous (B, P) and
// (B, Q) planes, so the host's copies of them need no transpose on the
// card.  A block stages a tile of kLanes lanes by kTile samples of each
// plane through shared memory (columns XOR-swizzled, so that the
// staging stores and the merge's reads are both free of bank
// conflicts), then each thread merges 16 consecutive samples of one
// lane: 8 pairs, stored with two 16-byte stores a plane (the widths with
// one 8-byte store), and with quads 4 quads, one 16-byte store a plane,
// where the row lengths allow it (`vec_p`, `vec_q`), else element by
// element.  The per-lane flags are ORed across the lane's four threads
// by shuffles and set by plain stores of 1 into a buffer the entry
// zeroes with one memset.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 32;                 // lanes a block
constexpr int kTile = 64;                  // samples a block
constexpr int kThreads = 128;
constexpr int kPerLane = kThreads / kLanes;  // threads a lane: 4
constexpr int kRun = kTile / kPerLane;       // samples a thread: 16
constexpr int kRowsPerPass = kThreads / kLanes;  // staging rows a pass: 4

struct In {
  const int32_t* c0;  // high words
  const int32_t* c1;
  const int32_t* c2;  // low words
  const int8_t* ws;   // widths
  long long cb, cs;   // element strides of the chunk planes: lane, sample
  long long wb, wsm;  // element strides of the widths: lane, sample
};

struct Out {
  int32_t *ph, *pm, *pl;  // (B, P) lane-major
  int8_t* pws;
  int32_t *qh, *qm, *ql;  // (B, Q) lane-major (quads only)
  int8_t* qws;
  uint8_t* fat;   // (B,) bool, zeroed by the entry
  uint8_t* qfat;  // (B,) bool (quads only)
};

// The staging column of lane l at tile row s: rows of 16 samples, the
// ones one thread merges, share an XOR pattern on bits 3-4 of the lane.
__device__ __forceinline__ int col(int s, int l) { return l ^ (((s >> 4) & 3) << 3); }

// `_shr_s` of the plain version for counts in [1, 32]: 32 gives 0.
__device__ __forceinline__ uint32_t shr_s(uint32_t x, int c) { return c >= 32 ? 0u : x >> c; }

struct Chunk {
  uint32_t h, m, l;
};

// One merge_pair_chunks position: A (the earlier of the two) shifted by
// B's width, ORed with B.  `wp` gets wa + wb.
__device__ __forceinline__ Chunk merge(Chunk a, Chunk b, int32_t wb) {
  const int r = wb & 31;
  const int inv = 32 - r;  // in [1, 32]
  const uint32_t h = (a.h << r) | shr_s(a.m, inv);
  const uint32_t m = (a.m << r) | shr_s(a.l, inv);
  const uint32_t l = a.l << r;
  const int32_t q = wb >> 5;  // arithmetic, as torch's >> on int32
  Chunk out;
  out.h = (q == 0 ? h : q == 1 ? m : l) | b.h;
  out.m = (q == 0 ? m : q == 1 ? l : 0u) | b.m;
  out.l = (q == 0 ? l : 0u) | b.l;
  return out;
}

template <bool kQuads>
__global__ void __launch_bounds__(kThreads)
    pair_merge_kernel(In in, Out out, int B, int S, int P, int Q, bool vec_p, bool vec_q) {
  __shared__ uint32_t sh[3][kTile][kLanes];
  __shared__ int8_t sw[kTile][kLanes];
  const int t = threadIdx.x;
  const int b0 = blockIdx.x * kLanes;
  const int s0 = blockIdx.y * kTile;

  // Stage: each pass a warp loads one sample row of the tile's 32 lanes.
  {
    const int l = t % kLanes;
    const int b = b0 + l;
#pragma unroll
    for (int i = 0; i < kTile / kRowsPerPass; ++i) {
      const int s = t / kLanes + i * kRowsPerPass;
      const int sa = s0 + s;
      uint32_t v0 = 0, v1 = 0, v2 = 0;
      int8_t w = 0;
      if (b < B && sa < S) {  // past S: the zero-width tail
        const long long o = (long long)b * in.cb + (long long)sa * in.cs;
        v0 = (uint32_t)in.c0[o];
        v1 = (uint32_t)in.c1[o];
        v2 = (uint32_t)in.c2[o];
        w = in.ws[(long long)b * in.wb + (long long)sa * in.wsm];
      }
      const int c = col(s, l);
      sh[0][s][c] = v0;
      sh[1][s][c] = v1;
      sh[2][s][c] = v2;
      sw[s][c] = w;
    }
  }
  __syncthreads();

  // Merge: thread (lane l, run k) takes samples [16k, 16k + 16) of lane l.
  const int l = t / kPerLane;
  const int k = t % kPerLane;
  const int b = b0 + l;
  const int sb = k * kRun;
  const int c = col(sb, l);  // the same for the run's 16 rows
  Chunk pr[kRun / 2];
  int8_t pw[kRun / 2];
  bool fat = false, bad = false;
#pragma unroll
  for (int j = 0; j < kRun / 2; ++j) {
    const int sa = sb + 2 * j;
    const Chunk a{sh[0][sa][c], sh[1][sa][c], sh[2][sa][c]};
    const Chunk bb{sh[0][sa + 1][c], sh[1][sa + 1][c], sh[2][sa + 1][c]};
    const int32_t wa = sw[sa][c], wb = sw[sa + 1][c];
    const int32_t wp = wa + wb;
    const bool fits = wp <= 96;
    pr[j] = merge(a, bb, wb);
    pw[j] = (int8_t)(fits ? wp : -1);
    fat |= !fits;
    bad |= pw[j] < 0;
  }
  Chunk qr[kRun / 4];
  int8_t qw[kRun / 4];
  bool qfat = bad;
  if (kQuads) {
#pragma unroll
    for (int j = 0; j < kRun / 4; ++j) {
      const int32_t wa = pw[2 * j] > 0 ? pw[2 * j] : 0;  // -1 pairs clamp to 0
      const int32_t wb = pw[2 * j + 1] > 0 ? pw[2 * j + 1] : 0;
      const int32_t wq = wa + wb;
      const bool fits = wq <= 96;
      qr[j] = merge(pr[2 * j], pr[2 * j + 1], wb);
      qw[j] = (int8_t)(fits ? wq : -1);
      qfat |= !fits;
    }
  }

  // The lane's flags: OR over its kPerLane neighbouring threads.
#pragma unroll
  for (int d = 1; d < kPerLane; d <<= 1) {
    fat |= __shfl_xor_sync(0xffffffffu, fat, d);
    if (kQuads) qfat |= __shfl_xor_sync(0xffffffffu, qfat, d);
  }
  if (b >= B) return;
  if (k == 0) {
    if (fat) out.fat[b] = 1;
    if (kQuads && qfat) out.qfat[b] = 1;
  }

  const int j0 = s0 / 2 + sb / 2;  // the run's first pair
  if (j0 < P) {
    const size_t o = (size_t)b * P + j0;
    if (vec_p) {  // P % 8 == 0: the run's 8 pairs lie in the row
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const Chunk* p = pr + 4 * h;
        *(uint4*)(out.ph + o + 4 * h) = make_uint4(p[0].h, p[1].h, p[2].h, p[3].h);
        *(uint4*)(out.pm + o + 4 * h) = make_uint4(p[0].m, p[1].m, p[2].m, p[3].m);
        *(uint4*)(out.pl + o + 4 * h) = make_uint4(p[0].l, p[1].l, p[2].l, p[3].l);
      }
      uint2 w;
      w.x = (uint32_t)(uint8_t)pw[0] | (uint32_t)(uint8_t)pw[1] << 8 |
            (uint32_t)(uint8_t)pw[2] << 16 | (uint32_t)(uint8_t)pw[3] << 24;
      w.y = (uint32_t)(uint8_t)pw[4] | (uint32_t)(uint8_t)pw[5] << 8 |
            (uint32_t)(uint8_t)pw[6] << 16 | (uint32_t)(uint8_t)pw[7] << 24;
      *(uint2*)(out.pws + o) = w;
    } else {
#pragma unroll
      for (int j = 0; j < kRun / 2; ++j) {
        if (j0 + j < P) {
          out.ph[o + j] = (int32_t)pr[j].h;
          out.pm[o + j] = (int32_t)pr[j].m;
          out.pl[o + j] = (int32_t)pr[j].l;
          out.pws[o + j] = pw[j];
        }
      }
    }
  }
  if (kQuads) {
    const int i0 = s0 / 4 + sb / 4;  // the run's first quad
    if (i0 < Q) {
      const size_t o = (size_t)b * Q + i0;
      if (vec_q) {  // Q % 4 == 0: the run's 4 quads lie in the row
        *(uint4*)(out.qh + o) = make_uint4(qr[0].h, qr[1].h, qr[2].h, qr[3].h);
        *(uint4*)(out.qm + o) = make_uint4(qr[0].m, qr[1].m, qr[2].m, qr[3].m);
        *(uint4*)(out.ql + o) = make_uint4(qr[0].l, qr[1].l, qr[2].l, qr[3].l);
        *(uint32_t*)(out.qws + o) =
            (uint32_t)(uint8_t)qw[0] | (uint32_t)(uint8_t)qw[1] << 8 |
            (uint32_t)(uint8_t)qw[2] << 16 | (uint32_t)(uint8_t)qw[3] << 24;
      } else {
#pragma unroll
        for (int j = 0; j < kRun / 4; ++j) {
          if (i0 + j < Q) {
            out.qh[o + j] = (int32_t)qr[j].h;
            out.qm[o + j] = (int32_t)qr[j].m;
            out.ql[o + j] = (int32_t)qr[j].l;
            out.qws[o + j] = qw[j];
          }
        }
      }
    }
  }
}

}  // namespace

// c0, c1, c2: int32 chunk planes, element (b, s) at b * cb + s * cs;
// ws: int8 widths at b * wb + s * wsm.  pair: ph, pm, pl int32 and pws
// int8, (B, P) contiguous, P = ceil(S / 2).  quads != 0: also qh, qm, ql
// int32 and qws int8, (B, Q) contiguous, Q = ceil(P / 2) (else null).
// flags: (B,) bool fat, then with quads (B,) bool qfat; zeroed here by
// one memset.  One launch on the stream.  The caller guarantees
// ceil(S / 64) <= 65535 and 16-byte aligned outputs.
extern "C" int alac_pair_merge(const void* c0, const void* c1, const void* c2,
                               const void* ws, long long cb, long long cs, long long wb,
                               long long wsm, int B, int S, int quads, void* ph, void* pm,
                               void* pl, void* pws, void* qh, void* qm, void* ql, void* qws,
                               void* flags, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (B > 0) {
    const cudaError_t err = cudaMemsetAsync(flags, 0, (size_t)B * (quads ? 2 : 1), st);
    if (err != cudaSuccess) return (int)err;
  }
  if (B > 0 && S > 0) {
    const int P = (S + 1) / 2, Q = (P + 1) / 2;
    const In in{(const int32_t*)c0, (const int32_t*)c1, (const int32_t*)c2,
                (const int8_t*)ws, cb, cs, wb, wsm};
    const Out out{(int32_t*)ph, (int32_t*)pm, (int32_t*)pl, (int8_t*)pws,
                  (int32_t*)qh, (int32_t*)qm, (int32_t*)ql, (int8_t*)qws,
                  (uint8_t*)flags, (uint8_t*)flags + B};
    const uintptr_t words = (uintptr_t)ph | (uintptr_t)pm | (uintptr_t)pl;
    const uintptr_t qwords = (uintptr_t)qh | (uintptr_t)qm | (uintptr_t)ql;
    const bool vec_p = P % 8 == 0 && words % 16 == 0 && (uintptr_t)pws % 8 == 0;
    const bool vec_q = Q % 4 == 0 && qwords % 16 == 0 && (uintptr_t)qws % 4 == 0;
    const dim3 grid((B + kLanes - 1) / kLanes, (S + kTile - 1) / kTile);
    if (quads) {
      pair_merge_kernel<true><<<grid, kThreads, 0, st>>>(in, out, B, S, P, Q, vec_p, vec_q);
    } else {
      pair_merge_kernel<false><<<grid, kThreads, 0, st>>>(in, out, B, S, P, Q, vec_p, false);
    }
  }
  return (int)cudaGetLastError();
}
