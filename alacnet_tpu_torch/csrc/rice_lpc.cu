// Fused Rice / adaptive-Golomb entropy decode + adaptive FIR (LPC)
// reconstruction of one channel per lane, for Hopper (sm_90a).
//
// Replaces: alacnet_tpu/ops/pallas/rice_lpc.py, `_kernel` (reached via
// `fused_rice_lpc`; its event decode is `_decode_event`).  The per-sample
// expressions below mirror that kernel's step body one for one; the
// plain torch version is ops/rice.rice_decode followed by
// ops/lpc.lpc_decode (alacnet_tpu_torch/ops/cuda/rice_lpc.py).
//
// What bounds it on the H100: the decode is a serial recurrence per
// frame (every sample's bit position depends on the previous sample's
// code length, and every output on the previous outputs), so a lane
// cannot be split across threads, and a span of a few thousand lanes is
// a few thousand threads: the kernel is bound by the latency of one
// lane's per-sample dependency chain, not by bytes or operations.
//
// What the design does about it: it shortens the chain.
//  - Warp roles.  A block owns 32 lanes and runs two warps, one thread
//    per lane in each.  The entropy warp runs only the Rice chain (bit
//    cursor, history, sign modifier, zero runs) and writes residuals
//    into a ring in shared memory (kSlots slots of kSlotSamples samples
//    x 32 lanes, lane-minor); the LPC warp reads them and runs the FIR
//    and the adaptive walk.  The two chains overlap, so a sample costs
//    the longer of them, not their sum.  Slots are handed over with
//    named barriers (bar.arrive / bar.sync over the block's 64 threads):
//    FULL(s) when the entropy warp has filled slot s, EMPTY(s) when the
//    LPC warp has drained it.
//  - Rows staged in shared memory.  Each entropy thread reads its word
//    row through its own ring of kRingWords words (a column of a
//    lane-minor array: conflict-free), filled by 4-byte cp.async copies
//    kWordAhead chunks of kChunkWords words ahead of the chunk its bit
//    cursor needs, so no global load sits on the chain; and the ring
//    feeds an 8-word register window (Cursor), so a sample's move is a
//    register select and its shared-memory loads run a move ahead.  Reads
//    past the row clip to its last word, as the JAX fetch does (the
//    padded row's tail is zero).
//  - No branch per sample in the common case: both warps compute every
//    step and keep what the lane's sample needs by selects (frozen lanes,
//    zero runs, pass-through and integrator outputs); only a zero-run
//    event (and a window reload) branches.
//  - Loops bounded by an order bucket.  The LPC part is a template on
//    MO, a bound on every live lane's order below 31 (4, 6, 8, 12, 16
//    or 31; the wrapper picks it from max_order): the FIR, the walk and
//    the window shift run MO steps, not 31.  The FIR sums in 4 partial
//    sums; coefficients past the lane's order are zeroed once, so the
//    FIR needs no predicate.  The walk is branch free: its stop flag is
//    a running AND, and its error update is one add per tap on the chain.
//  - Outputs go to sample-major (S, B), 32 consecutive words per warp
//    and sample.  A block stops at the longest of its lanes; the
//    entropy warp writes the zero tail beyond it.
//
// Bit-exactness: ALAC's arithmetic is C# int32 with wraparound.  Signed
// overflow is undefined in CUDA C++, so every product or sum that can
// wrap runs in uint32_t and is cast back; every shift count is masked
// exactly where the JAX kernel masks it; clz(0) is 40, not __clz's 32.

#include <cstdint>
#include <cuda_runtime.h>

#include "ring_sync.cuh"

namespace {

using namespace alac_ring;

constexpr int kLanes = 32;          // lanes per block: one per thread of each warp
constexpr int kThreads = 2 * kLanes;
constexpr int kSlots = 4;           // residual ring slots
constexpr int kSlotSamples = 32;    // samples per slot
constexpr int kChunkShift = 4;
constexpr int kChunkWords = 1 << kChunkShift;  // words per cp.async chunk of a row
constexpr int kWordAhead = 2;       // chunks in flight past the cursor's
constexpr int kRingWords = kChunkWords * (kWordAhead + 2);  // 64, a power of 2
constexpr int kRiceThreshold = 8;
constexpr int kMaxOrder = 31;

struct Smem {
  uint32_t words[kRingWords][kLanes];           // 8 KB
  int32_t res[kSlots][kSlotSamples][kLanes];    // 16 KB
};

// Named barriers 1..2*kSlots (0 is __syncthreads'), 64 threads each.
__device__ __forceinline__ int bar_full(int s) { return 1 + s; }
__device__ __forceinline__ int bar_empty(int s) { return 1 + kSlots + s; }

__device__ __forceinline__ int32_t clz40(uint32_t x) {
  return x == 0u ? 40 : __clz(x);
}
__device__ __forceinline__ int32_t wadd(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a + (uint32_t)b);
}
__device__ __forceinline__ int32_t wsub(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a - (uint32_t)b);
}
__device__ __forceinline__ int32_t wmul(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a * (uint32_t)b);
}
// (x << s) >> s with s = (32 - bits) & 31: sign-extend the low bits.
__device__ __forceinline__ int32_t signext(int32_t x, int32_t rss) {
  const uint32_t s = (uint32_t)(32 - rss) & 31u;
  return (int32_t)((uint32_t)x << s) >> s;
}

// Word reads clip to the row, as the JAX fetch does.
__device__ __forceinline__ int clip_word(int j, int W) {
  return j < 0 ? 0 : (j > W - 1 ? W - 1 : j);
}

// One lane's word row, staged through its column of Smem::words: word j
// of the row, clipped (clip_word), lives at ring position j % kRingWords.
// Chunk k is words [k*kChunkWords, (k+1)*kChunkWords); each issued
// chunk is one cp.async group, so "all but the newest kWordAhead groups
// have landed" means "every chunk up to the one asked for has".
struct WordRing {
  const uint32_t* __restrict__ row;
  uint32_t* col;    // &words[0][lane]; position q lives at col[q * kLanes]
  int W;
  int next;         // next chunk to issue
  int refill;       // ensure(j) issues more once j reaches this word

  __device__ __forceinline__ void issue(int k) {
    const int j0 = k * kChunkWords;
#pragma unroll
    for (int t = 0; t < kChunkWords; ++t) {
      const int j = j0 + t;
      cp_async4(col + (j & (kRingWords - 1)) * kLanes, row + clip_word(j, W));
    }
    cp_async_commit();
  }
  // Make every word up to j readable: issue chunks up to kWordAhead past
  // j's and wait for j's.  Taken once per kChunkWords words of cursor
  // travel; j moves at most kChunkWords - 1 words between calls.
  __device__ __forceinline__ void ensure(int j) {
    if (j < refill) return;
    const int kh = j >> kChunkShift;
    do {
      issue(next);
      ++next;
    } while (next <= kh + kWordAhead);
    cp_async_wait<kWordAhead>();
    refill = (next - kWordAhead) << kChunkShift;
  }
  // Start over at word j (the first sample, or a jump): let every copy
  // in flight land, so that none can overwrite a slot refilled now.
  __device__ __forceinline__ void restart(int j) {
    cp_async_wait<0>();
    next = j >> kChunkShift;
    refill = INT32_MIN;
  }
  __device__ __forceinline__ uint32_t word(int j) const {
    return col[(j & (kRingWords - 1)) * kLanes];
  }
};

// An entropy thread's register window on its row: words cw .. cw+3 in
// c0..c3, and the next four in n0..n3, loaded one move ahead.  A
// well-formed sample moves the cursor by at most 84 bits (an escape of
// rss <= 33 bits, then a zero-run event), so the move to its word is at
// most 3 words: a register select, with no shared-memory load on the
// chain; and both of its events read only these 8 words.  Anything
// else (the first sample, a malformed header's wider escape) reloads.
struct Cursor {
  const uint32_t* __restrict__ row;
  int W, cw;
  uint32_t c0, c1, c2, c3, n0, n1, n2, n3;

  __device__ __forceinline__ void load_next(WordRing& r) {
    r.ensure(cw + 7);
    n0 = r.word(cw + 4);
    n1 = r.word(cw + 5);
    n2 = r.word(cw + 6);
    n3 = r.word(cw + 7);
  }
  __device__ __forceinline__ void load(WordRing& r, int wi) {
    r.restart(wi);
    r.ensure(wi + 7);
    cw = wi;
    c0 = r.word(wi);
    c1 = r.word(wi + 1);
    c2 = r.word(wi + 2);
    c3 = r.word(wi + 3);
    load_next(r);
  }
  // Move the window to start at word wi: a select per word (the
  // identity when the cursor stays in its word), then the next four
  // words from shared memory.
  __device__ __forceinline__ void seek(WordRing& r, int wi) {
    const int d = wi - cw;
    if (d < 0 || d > 4) {
      load(r, wi);
      return;
    }
    const uint32_t x0 = d == 0 ? c0 : (d == 1 ? c1 : (d == 2 ? c2 : (d == 3 ? c3 : n0)));
    const uint32_t x1 = d == 0 ? c1 : (d == 1 ? c2 : (d == 2 ? c3 : (d == 3 ? n0 : n1)));
    const uint32_t x2 = d == 0 ? c2 : (d == 1 ? c3 : (d == 2 ? n0 : (d == 3 ? n1 : n2)));
    const uint32_t x3 = d == 0 ? c3 : (d == 1 ? n0 : (d == 2 ? n1 : (d == 3 ? n2 : n3)));
    c0 = x0;
    c1 = x1;
    c2 = x2;
    c3 = x3;
    cw = wi;
    load_next(r);
  }
  // The 32 bits at absolute bit position p >= 32 * cw, left-aligned
  // (`_window32`).
  __device__ __forceinline__ uint32_t at(int p) const {
    const int d = (p >> 5) - cw;
    uint32_t hi, lo;
    if (d <= 3) {
      hi = d == 0 ? c0 : (d == 1 ? c1 : (d == 2 ? c2 : c3));
      lo = d == 0 ? c1 : (d == 1 ? c2 : (d == 2 ? c3 : n0));
    } else {
      hi = __ldg(row + clip_word(cw + d, W));
      lo = __ldg(row + clip_word(cw + d + 1, W));
    }
    return __funnelshift_l(lo, hi, (uint32_t)p & 31u);
  }
};

// One entropy_decode_value (`_decode_event`, AlacFile.cs:193-212), given
// the 64 bits at its first bit: hi, then lo.  Both reads after the
// unary prefix (escape rss bits, or k bits) come from one funnel shift.
__device__ __forceinline__ void decode_event(
    uint32_t hi, uint32_t lo, int32_t rss, int32_t k, int32_t mult_mask,
    int32_t* value, int32_t* consumed) {
  const int32_t u9 = (int32_t)(hi >> 23);
  const int32_t inv = (~u9) & 0x1FF;
  int32_t x = clz40((uint32_t)inv << 23);
  x = x < kRiceThreshold + 1 ? x : kRiceThreshold + 1;
  const int32_t ucons = x > kRiceThreshold ? 9 : x + 1;
  const bool esc = x > kRiceThreshold;
  const uint32_t fwin = __funnelshift_l(lo, hi, (uint32_t)ucons);  // ucons <= 9
  const int32_t esc_val = (int32_t)(fwin >> ((32u - (uint32_t)rss) & 31u));
  const int32_t k_safe = k < 1 ? 1 : (k > 31 ? 31 : k);
  const int32_t extra = (int32_t)(fwin >> ((32u - (uint32_t)k_safe) & 31u));
  const int32_t m = (int32_t)(((1u << k_safe) - 1u) & (uint32_t)mult_mask);
  const int32_t vk = wadd(wmul(x, m), extra > 1 ? extra - 1 : 0);
  const int32_t k_cons = extra > 1 ? k_safe : k_safe - 1;
  const bool is_k1 = k == 1;
  *value = esc ? esc_val : (is_k1 ? x : vk);
  *consumed = ucons + (esc ? rss : (is_k1 ? 0 : k_cons));
}

struct Args {
  const uint32_t* __restrict__ words;
  int B, W, S, max_order;
  const int32_t* __restrict__ start;
  const int32_t* __restrict__ n;
  const int32_t* __restrict__ rss;
  const int32_t* __restrict__ kmod;
  const int32_t* __restrict__ ihist;
  const int32_t* __restrict__ mult;
  const int32_t* __restrict__ kmask;
  const int32_t* __restrict__ order;
  const int32_t* __restrict__ quant;
  const int32_t* __restrict__ rc;
  int32_t* __restrict__ out_sb;
  int32_t* __restrict__ end;
};

// ---- entropy warp: the Rice chain (AlacFile.cs:214-252) ----
__device__ __forceinline__ void entropy_warp(const Args& a, Smem& sm, int lane,
                                             int b, int32_t n, int nslots) {
  const bool live = b < a.B;
  int32_t rss = 0, kmod = 0, mult = 0, kmask = 0, hist = 0, bitpos = 0;
  WordRing ring;
  ring.col = &sm.words[0][lane];
  ring.W = a.W;
  ring.row = a.words + (size_t)(live ? b : 0) * a.W;
  Cursor cur;
  cur.row = ring.row;
  cur.W = a.W;
  if (live) {
    rss = a.rss[b];
    kmod = a.kmod[b];
    mult = a.mult[b];
    kmask = a.kmask[b];
    hist = a.ihist[b];
    bitpos = a.start[b];
  }
  cur.load(ring, bitpos >> 5);
  int32_t signmod = 0, zrun = 0;

  for (int c = 0; c < nslots; ++c) {
    const int s = c % kSlots;
    if (c >= kSlots) bar_sync(bar_empty(s), kThreads);
    const int i0 = c * kSlotSamples;
    const int i1 = min(i0 + kSlotSamples, a.S);
    for (int i = i0; i < i1; ++i) {
      // Every lane decodes the event at its cursor and keeps it only if
      // its sample needs one (live, not inside a zero run), so the
      // common sample has no branch; only a zero-run event branches.
      const bool live_i = i < n;
      const bool in_zero = zrun > 0;
      const bool act = live_i && !in_zero;
      cur.seek(ring, bitpos >> 5);
      int32_t k = 31 - clz40((uint32_t)wadd(hist >> 9, 3));
      k = k < kmod ? k : kmod;
      const uint32_t sh = (uint32_t)bitpos & 31u;
      int32_t raw, consumed;
      decode_event(__funnelshift_l(cur.c1, cur.c0, sh), __funnelshift_l(cur.c2, cur.c1, sh),
                   rss, k, -1, &raw, &consumed);
      const int32_t dv = wadd(raw, signmod);
      const int32_t tplus = wadd(dv, 1);
      int32_t almost = tplus >> 1;
      if (tplus < 0 && (tplus & 1) != 0) almost += 1;
      const int32_t err = !act ? 0 : ((dv & 1) != 0 ? wsub(0, almost) : almost);
      const int32_t hist2 = dv > 0xFFFF
          ? 0xFFFF
          : wsub(wadd(hist, wmul(dv, mult)), wmul(hist, mult) >> 9);
      const bool zev = act && hist2 < 128 && i + 1 < n;
      int32_t bsize = 0, bcons = 0;
      if (zev) {
        int32_t kz = clz40((uint32_t)hist2) + (wadd(hist2, 16) >> 6) - 24;
        kz = kz < 31 ? kz : 31;
        const int32_t p = bitpos + consumed;
        decode_event(cur.at(p), cur.at(p + 32), 16, kz, kmask, &bsize, &bcons);
      }
      hist = act ? (zev ? 0 : hist2) : hist;
      signmod = act ? (zev && bsize <= 0xFFFF ? 1 : 0) : signmod;
      zrun = act ? (zev ? bsize : 0) : (live_i && in_zero ? zrun - 1 : zrun);
      bitpos = act ? wadd(bitpos, consumed + bcons) : bitpos;
      sm.res[s][i - i0][lane] = err;
    }
    bar_arrive(bar_full(s), kThreads);
  }
  cp_async_wait<0>();  // no copy may land in shared memory after exit
  if (!live) return;
  a.end[b] = bitpos;
  for (int i = nslots * kSlotSamples; i < a.S; ++i) a.out_sb[(size_t)i * a.B + b] = 0;
}

// ---- LPC warp: adaptive FIR (AlacFile.cs:256-336; base-aligned) ----
template <int MO>
__device__ __forceinline__ void lpc_warp(const Args& a, Smem& sm, int lane,
                                         int b, int32_t n, int nslots) {
  const bool live = b < a.B;
  const int32_t order = live ? a.order[b] : 0;
  const int32_t quant = live ? a.quant[b] : 0;
  const int32_t rss = live ? a.rss[b] : 0;
  const int32_t qshift = (quant - 1) & 31;
  const bool is_pass = order == 0;
  const bool is_int31 = order == kMaxOrder;
  // FIR / walk depth, bounded like the JAX kernel's static block bound;
  // the wrapper's bucket MO >= max_order bounds it in turn.
  const int tmax = order < a.max_order ? order : a.max_order;
  // Window length - 1: the lane's order (MO bounds every live order).
  const int ordc = order < MO ? order : MO;

  // The arrays are indexed only by unrolled loop counters, so they live
  // in registers.  rc[t] = 0 past tmax: the walk never touches those
  // slots, so the FIR can run all MO taps unpredicated, and window slots
  // past the lane's order may hold anything (every product with them is
  // zero, and no acting tap reads them).  at[t]: all ones at slot ordc,
  // where each sample appends, so the shift is one bit select a slot.
  int32_t rc[MO + 1];
  int32_t D[MO + 1];  // D[t] = out[i - 1 - order + t], t <= ordc
  uint32_t at[MO];
#pragma unroll
  for (int t = 0; t <= MO; ++t) {
    rc[t] = live && t <= tmax ? a.rc[(size_t)b * (kMaxOrder + 1) + t] : 0;
    D[t] = 0;
    if (t < MO) at[t] = t == ordc ? ~0u : 0u;
  }
  // Order-0 and order-31 lanes read no window; the others shift it
  // every live sample (AlacFile.cs keeps it from the first).
  const bool shifts = live && !is_pass && !is_int31;
  int32_t prev = 0;

  for (int c = 0; c < nslots; ++c) {
    const int s = c % kSlots;
    bar_sync(bar_full(s), kThreads);
    const int i0 = c * kSlotSamples;
    const int i1 = min(i0 + kSlotSamples, a.S);
    int32_t err_next = sm.res[s][0][lane];
    for (int i = i0; i < i1; ++i) {
      // the next sample's residual is loaded while this one runs
      const int32_t err = err_next;
      if (i + 1 < i1) err_next = sm.res[s][i + 1 - i0][lane];
      // Every lane computes the FIR and the walk and keeps what its
      // sample needs, so a sample has no branch: pass-through and
      // integrator outputs are selects, and a frozen lane (i >= n) or a
      // lane of no row keeps all its state.
      const bool on = live && i < n;
      const bool direct = i == 0 || is_pass;
      const bool fir_path = on && !direct && !is_int31 && i > order;
      const int32_t base = D[0];
      uint32_t f0 = 0u, f1 = 0u, f2 = 0u, f3 = 0u;
#pragma unroll
      for (int t = 1; t <= MO; ++t) {
        const uint32_t p = (uint32_t)wsub(D[t], base) * (uint32_t)rc[t];
        if ((t & 3) == 0) f0 += p;
        if ((t & 3) == 1) f1 += p;
        if ((t & 3) == 2) f2 += p;
        if ((t & 3) == 3) f3 += p;
      }
      const uint32_t fir = (f0 + f1) + (f2 + f3);
      const int32_t outval = (int32_t)((1u << qshift) + fir) >> quant;
      const int32_t out = direct ? err
          : (fir_path ? signext(wadd(wadd(outval, base), err), rss)
                      : signext(wadd(prev, err), rss));
      // Adaptive coefficient walk (AlacFile.cs:312-332): tap t acts
      // while every earlier tap acted and ev keeps err's sign (none acts
      // for err == 0).  With pm = err > 0 ? 0 : -1: "ev keeps the sign"
      // is (ev ^ pm) > pm, and val * se (se = +-sign(val)) is
      // (val ^ q) - q for q = (val >> 31) ^ pm, i.e. +-|val|.
      const int32_t pm = err > 0 ? 0 : -1;
      int32_t ev = err;
      bool alive = fir_path && err != 0;
#pragma unroll
      for (int t = 0; t < MO; ++t) {
        const int32_t val = wsub(base, D[t + 1]);
        const int32_t q = (val >> 31) ^ pm;
        const int32_t vse = wsub(val ^ q, q);
        const int32_t sgn = (val > 0) - (val < 0);
        alive = alive && t < tmax && (ev ^ pm) > pm;
        rc[t + 1] = wsub(rc[t + 1], alive ? wsub(sgn ^ pm, pm) : 0);
        ev = wsub(ev, wmul(vse >> quant, t + 1));
      }
      if (shifts && on) {
#pragma unroll
        for (int t = 0; t < MO; ++t) {
          D[t] = (int32_t)(((uint32_t)out & at[t]) | ((uint32_t)D[t + 1] & ~at[t]));
        }
        D[MO] = out;
      }
      if (on) prev = out;
      if (live) a.out_sb[(size_t)i * a.B + b] = on ? out : 0;
    }
    if (c + kSlots < nslots) bar_arrive(bar_empty(s), kThreads);
  }
}

template <int MO>
__global__ void __launch_bounds__(kThreads) rice_lpc_kernel(const Args a) {
  __shared__ Smem sm;
  const int lane = threadIdx.x & (kLanes - 1);
  const int b = blockIdx.x * kLanes + lane;
  const int32_t n = b < a.B ? a.n[b] : 0;
  // Both warps walk the same slots: up to the block's longest lane.
  const int nlive = n < 0 ? 0 : (n > a.S ? a.S : n);
  const int nmax = __reduce_max_sync(0xFFFFFFFFu, (unsigned)nlive);
  const int nslots = (nmax + kSlotSamples - 1) / kSlotSamples;
  if (threadIdx.x < kLanes) {
    entropy_warp(a, sm, lane, b, n, nslots);
  } else {
    lpc_warp<MO>(a, sm, lane, b, n, nslots);
  }
}

}  // namespace

// order_bucket: 4, 6, 8, 12, 16 or 31, at least max_order (the wrapper
// picks it).
extern "C" int alac_rice_lpc(
    const void* words, int B, int W, const void* start, const void* n,
    const void* rss, const void* kmod, const void* ihist, const void* mult,
    const void* kmask, const void* order, const void* quant, const void* rc,
    int S, int max_order, int order_bucket, void* out_sb, void* end,
    void* stream) {
  if (max_order > order_bucket) return (int)cudaErrorInvalidValue;
  if (B <= 0) return (int)cudaGetLastError();
  const Args a{(const uint32_t*)words, B, W, S, max_order,
               (const int32_t*)start, (const int32_t*)n, (const int32_t*)rss,
               (const int32_t*)kmod, (const int32_t*)ihist, (const int32_t*)mult,
               (const int32_t*)kmask, (const int32_t*)order, (const int32_t*)quant,
               (const int32_t*)rc, (int32_t*)out_sb, (int32_t*)end};
  const int grid = (B + kLanes - 1) / kLanes;
  cudaStream_t st = (cudaStream_t)stream;
  switch (order_bucket) {
    case 4: rice_lpc_kernel<4><<<grid, kThreads, 0, st>>>(a); break;
    case 6: rice_lpc_kernel<6><<<grid, kThreads, 0, st>>>(a); break;
    case 8: rice_lpc_kernel<8><<<grid, kThreads, 0, st>>>(a); break;
    case 12: rice_lpc_kernel<12><<<grid, kThreads, 0, st>>>(a); break;
    case 16: rice_lpc_kernel<16><<<grid, kThreads, 0, st>>>(a); break;
    case 31: rice_lpc_kernel<31><<<grid, kThreads, 0, st>>>(a); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
