// The element header of a multichannel frame's next element, for Hopper
// (sm_90a).
//
// A frame of 3-8 channels is a chain of elements (Apple's ALACDecoder::
// Decode): SCE, CPE, ..., END, each packed right after the one before,
// each with its own header.  Element k+1 starts where element k's last
// Rice section ends, which is known only after its entropy decode, so
// the host parses element 0 (codec/framemeta_vec.py) and this kernel
// parses each later one on the card, from the bit where the previous
// element ended, and writes the per-lane columns that the decode's
// stages read (the packed layout of ops/frame_decode.FrameMetaArrays,
// then the derived counts and widths of the stages, the element's
// channel offset and the lane's status).  No JAX kernel: the JAX package
// decodes no frame of more than two channels.  The plain torch version
// is `elem_head_plain` (alacnet_tpu_torch/ops/cuda/elem_head.py), bit
// for bit.
//
// Per lane b, pass k (1 <= k <= the lane's element count): the previous
// element's end (compressed: the end bit of its last Rice section, from
// the rice_lpc kernel; raw: its body's end), then DSE and FIL elements
// skipped (ALACDecoder::DataStreamElement / FillElement), then
//  - k below the element count: the element's header, which must carry
//    the tag of the channel map (SCE or LFE for one channel, CPE for a
//    pair) and the sample count of element 0, else status 1; a
//    prediction type other than 0 gives status 2;
//  - k equal to it: the END tag, else status 1.
// A lane whose status is set, or that has no element k, is idle: its
// counts are zero and its channel offset -1, so no stage touches it.
// Each channel's count goes to the narrow rice_lpc launch (the host's
// order bucket, `max_order`: element 0's) where its order is at most
// max_order or 31, else to the wide one (the order-31 bucket), which
// has nothing to do unless a later element's order exceeds element 0's.
// The last pass also writes each lane's sample count, or -status where
// a pass refused the lane.
//
// What bounds it: latency.  A header is at most ~1,100 bits, read field
// by field (each field a 64-bit window of two words); a thread a lane,
// a few thousand lanes: a few microseconds of work on the card.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxOrder = 31;
constexpr int kMaxSkips = 16;  // DSE / FIL elements skipped before one element
constexpr int kMaxElements = 5;  // of a frame of 8 channels
// The layout, which the wrapper (ops/cuda/elem_head.py) passes to the C
// entry and the entry checks: rows of the host's packed metadata
// (FrameMetaArrays.pack_host), then the chain columns it appends for
// frames of 3 or more channels; the output's rows, FrameMetaArrays'
// then these.
constexpr int kStereo = 0, kComp = 1, kN = 2, kSS = 3, kPayload = 8, kKmod = 10,
              kIhist = 11, kKmask = 12, kElements = 83, kHistMult4 = 84, kFrame = 85,
              kChained = 87;
constexpr int kRowNComp = 83, kRowNB = 84, kRowBulkN = 85, kRowBulkN1 = 86,
              kRowBulkN2 = 87, kRowWideA = 88, kRowWideB = 89, kRowCoff = 90,
              kRowStatus = 91, kRows = 92;
constexpr int kSCE = 0, kCPE = 1, kLFE = 3, kDSE = 4, kFIL = 6, kEND = 7;

// Channels of element e of a lane's frame (1: SCE or LFE, 2: CPE; 0 past
// the last), from its elements column: 2 bits an element, element 0's
// lowest, as the host writes it from the channel map.
__device__ __forceinline__ int kind(uint32_t elements, int e) {
  return (int)((elements >> (2 * e)) & 3u);
}

struct Row {
  const uint32_t* __restrict__ w;
  int W;
  // Word j of the row; zero outside it.
  __device__ __forceinline__ uint32_t word(int64_t j) const {
    return (j >= 0 && j < W) ? w[j] : 0u;
  }
  // The n-bit field (1 <= n <= 32) at bit p, MSB first.
  __device__ __forceinline__ uint32_t bits(int64_t p, int n) const {
    const int64_t j = p >> 5;
    const int s = (int)(p & 31);
    const uint64_t win = ((uint64_t)word(j) << 32) | word(j + 1);
    return (uint32_t)((win << s) >> (64 - n));
  }
};

__device__ __forceinline__ int32_t clampn(int64_t n, int S) {
  return (int32_t)(n < 0 ? 0 : (n > S ? S : n));
}

// Skip DSE and FIL elements from bit p; returns the bit of the next
// other tag, or -1 after kMaxSkips of them.
__device__ __forceinline__ int64_t skip_aux(const Row& r, int64_t p) {
  for (int i = 0; i < kMaxSkips; ++i) {
    const uint32_t tag = r.bits(p, 3);
    if (tag == kDSE) {
      // instance (4), align (1), count (8, +8 where 255), align, bytes
      const uint32_t align = r.bits(p + 7, 1);
      int64_t count = r.bits(p + 8, 8);
      int64_t q = p + 16;
      if (count == 255) {
        count += r.bits(q, 8);
        q += 8;
      }
      if (align) q = (q + 7) & ~(int64_t)7;
      p = q + 8 * count;
    } else if (tag == kFIL) {
      // count (4; where 15, + 8 more bits - 1), bytes
      int64_t count = r.bits(p + 3, 4);
      int64_t q = p + 7;
      if (count == 15) {
        count += (int64_t)r.bits(q, 8) - 1;
        q += 8;
      }
      p = q + 8 * count;
    } else {
      return p;
    }
  }
  return -1;
}

__global__ void __launch_bounds__(kThreads)
    elem_head_kernel(const uint32_t* __restrict__ words, int B, int W,
                     const int32_t* __restrict__ base, const int32_t* __restrict__ prev,
                     const int32_t* __restrict__ end_a, const int32_t* __restrict__ end_b,
                     const int32_t* __restrict__ status_in, int k, int S,
                     int max_order, int32_t* __restrict__ rows,
                     uint8_t* __restrict__ flags, int32_t* __restrict__ n_out) {
  const int b = blockIdx.x * kThreads + threadIdx.x;
  if (b >= B) return;
  const size_t sB = (size_t)B;
  auto in = [&](const int32_t* t, int row) { return t[row * sB + b]; };
  const uint32_t elements = (uint32_t)in(base, kElements);
  int nel = 0;
  while (nel < kMaxElements && kind(elements, nel)) ++nel;
  int32_t status = status_in ? status_in[b] : 0;
  const int32_t n0 = clampn(in(base, kN), S);
  const bool active = status == 0 && k <= nel;

  // the columns the pass writes; idle unless an element parses
  int32_t stereo = 0, comp = 0, n = 0, ub = 0, rss = 0, shift = 0, lw = 0;
  int32_t payload = 0, entropy = 0, coff = -1, order[2] = {0, 0}, quant[2] = {0, 0};
  int32_t mult[2] = {0, 0}, rc[2][kMaxOrder + 1];
  for (int c = 0; c < 2; ++c)
    for (int t = 0; t <= kMaxOrder; ++t) rc[c][t] = 0;
  const int32_t ss = in(base, kSS);

  if (active) {
    const Row r{words + (size_t)b * W, W};
    const bool pst = in(prev, kStereo) != 0, pcomp = in(prev, kComp) != 0;
    const int64_t pn = clampn(in(prev, kN), S);
    int64_t p = pcomp ? (int64_t)(pst ? end_b[b] : end_a[b])
                      : (int64_t)in(prev, kPayload) +
                            pn * (int64_t)in(prev, kSS) * (pst ? 2 : 1);
    p = skip_aux(r, p);
    const uint32_t tag = p < 0 ? kDSE : r.bits(p, 3);
    if (k == nel) {
      if (tag != kEND) status = 1;
    } else {
      const int want = kind(elements, k);
      const bool tag_ok = want == 2 ? tag == kCPE : (tag == kSCE || tag == kLFE);
      int off = 0;
      for (int e = 0; e < k; ++e) off += kind(elements, e);
      if (!tag_ok) {
        status = 1;
      } else {
        stereo = want == 2;
        const int nch = want;
        const uint32_t hassize = r.bits(p + 19, 1);
        const int32_t u = (int32_t)r.bits(p + 20, 2);
        comp = r.bits(p + 22, 1) == 0;
        int64_t q = p + 23;
        const int64_t nraw = hassize ? (int64_t)r.bits(q, 32) : (int64_t)in(base, kFrame);
        q += 32 * hassize;
        n = clampn(nraw, S);
        if (n != pn) status = 1;
        int64_t c = q;
        if (comp) {
          shift = stereo ? (int32_t)r.bits(q, 8) : 0;
          lw = stereo ? (int32_t)r.bits(q + 8, 8) : 0;
          c = q + 16;
          const int32_t hm4 = in(base, kHistMult4);
          for (int h = 0; h < nch; ++h) {
            const uint32_t ptype = r.bits(c, 4);
            if (ptype != 0 && status == 0) status = 2;
            quant[h] = (int32_t)r.bits(c + 4, 4);
            mult[h] = (int32_t)((uint32_t)r.bits(c + 8, 3) * (uint32_t)hm4);
            const int o = (int)r.bits(c + 11, 5);
            order[h] = o;
            if (o < kMaxOrder) {
              // base-aligned reversed layout: rc[t] = coef[o - t] (ops/lpc.py)
              for (int t = 1; t <= o; ++t) {
                rc[h][t] = (int32_t)(int16_t)(uint16_t)r.bits(c + 16 + 16 * (o - t), 16);
              }
            }
            c += 16 + 16 * (int64_t)o;
          }
        }
        payload = (int32_t)c;
        ub = comp ? u : 0;
        rss = comp ? ss - 8 * u + stereo : ss + stereo;
        entropy = (int32_t)(c + (comp ? (int64_t)n * 8 * ub * nch : 0));
        coff = off;
      }
    }
    if (status != 0) {  // a refused lane runs no stage
      stereo = comp = n = ub = rss = shift = lw = payload = entropy = 0;
      coff = -1;
      for (int h = 0; h < 2; ++h) {
        order[h] = quant[h] = mult[h] = 0;
        for (int t = 0; t <= kMaxOrder; ++t) rc[h][t] = 0;
      }
    }
  }
  if (n_out) n_out[b] = status != 0 ? -status : n0;
  if (rows == nullptr) return;
  auto out = [&](int row, int32_t v) { rows[row * sB + b] = v; };
  const int32_t ncomp = comp ? n : 0;
  const int32_t bn1 = comp ? 8 * ub : ss;
  bool wide[2];
  for (int h = 0; h < 2; ++h) wide[h] = order[h] > max_order && order[h] != kMaxOrder;
  out(0, stereo);
  out(1, comp);
  out(2, n);
  out(3, ss);
  out(4, ub);
  out(5, rss);
  out(6, shift);
  out(7, lw);
  out(8, payload);
  out(9, entropy);
  out(10, in(base, kKmod));
  out(11, in(base, kIhist));
  out(12, in(base, kKmask));
  for (int h = 0; h < 2; ++h) {
    out(13 + h, order[h]);
    out(15 + h, quant[h]);
    out(17 + h, mult[h]);
    for (int t = 0; t <= kMaxOrder; ++t) out(19 + 32 * h + t, rc[h][t]);
  }
  out(kRowNComp, wide[0] ? 0 : ncomp);
  out(kRowNB, stereo && !wide[1] ? ncomp : 0);
  out(kRowBulkN, comp ? (ub > 0 ? n : 0) : n);
  out(kRowBulkN1, bn1);
  out(kRowBulkN2, stereo ? bn1 : 0);
  out(kRowWideA, wide[0] ? ncomp : 0);
  out(kRowWideB, stereo && wide[1] ? ncomp : 0);
  out(kRowCoff, coff);
  out(kRowStatus, status);
  flags[b] = (uint8_t)stereo;
  flags[sB + b] = (uint8_t)comp;
  flags[2 * sB + b] = (uint8_t)(wide[0] && ncomp > 0);
  flags[3 * sB + b] = (uint8_t)(stereo && wide[1] && ncomp > 0);
}

}  // namespace

// words: (B, W) int32 rows; base: (87, B) element 0's packed rows with
// the chain columns; prev: (>= 83, B) the previous element's rows (base
// itself for k = 1); end_a, end_b: (B,) its Rice sections' end bits;
// status_in: (B,) or null (none refused yet); max_order: the narrow
// launch's order bucket; rows: (92, B) int32 and flags: (4, B) bool, or
// both null on the last pass; n_out: (B,) or null.  packed, chained,
// rows_n: the wrapper's layout (83, 87, 92); another is refused.
extern "C" int alac_elem_head(const void* words, int B, int W, const void* base,
                              const void* prev, const void* end_a, const void* end_b,
                              const void* status_in, int k, int S, int max_order,
                              int packed, int chained, int rows_n, void* rows, void* flags,
                              void* n_out, void* stream) {
  if (packed != kElements || chained != kChained || rows_n != kRows) {
    return (int)cudaErrorInvalidValue;
  }
  if (B > 0) {
    elem_head_kernel<<<(B + kThreads - 1) / kThreads, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)words, B, W, (const int32_t*)base, (const int32_t*)prev,
        (const int32_t*)end_a, (const int32_t*)end_b, (const int32_t*)status_in, k, S,
        max_order, (int32_t*)rows, (uint8_t*)flags, (int32_t*)n_out);
  }
  return (int)cudaGetLastError();
}
