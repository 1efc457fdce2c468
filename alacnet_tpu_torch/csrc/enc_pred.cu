// Forward adaptive FIR of the ALAC encoder: signal -> residuals, one
// channel per lane, for Hopper (sm_90a).
//
// Replaces: alacnet_tpu/ops/pallas/enc_stages.py, `_pred_kernel` (reached
// via `predictor_errors_fused` / `encode_stages_fused` -> `_pred_blocks`).
// The per-sample expressions mirror that kernel's `sample` body (the
// decoder's reconstruction, AlacFile.cs:256-336, run in lockstep over
// the known signal); the plain torch version is
// ops/encode.predictor_errors (alacnet_tpu_torch/ops/cuda/enc_stages.py).
//
// What bounds it on the H100: each lane is a serial recurrence (every
// residual depends on the coefficient table that the previous residuals
// adapted), so a lane cannot be split across threads, and a chunk is
// 2048 lanes: the kernel is bound by one lane's per-sample chain, not by
// bytes (8 a sample) or the card's operation rate.  The first port (one
// thread per lane) put a device-memory load and the whole walk on that
// chain: ~1,250 cycles a sample.
//
// What the design does about it:
//  - Memory off the chain.  A block owns kLanes = 16 lanes (a chunk's
//    2048 lanes on 128 SMs; 32-lane blocks on 64 SMs measured 2% slower)
//    and runs two warps, threads past kLanes idle.  The producer warp
//    stages the signal into a ring of kInSlots tiles of kTile samples x
//    kLanes lanes in shared memory (a column per lane),
//    kInSlots - 1 tiles ahead, with 16-byte cp.async copies; the
//    predictor warp (a thread per lane) writes residuals into a ring of
//    kOutSlots tiles, which the producer writes out with 16-byte stores.
//    Tiles are handed over with named barriers: FULL(s) / EMPTY(s) for
//    input slot s, OFULL(o) / OEMPTY(o) for output slot o.
//  - A short chain.  The window holds inputs, not outputs, so everything
//    but the coefficients depends on the signal alone.  For sample i+1
//    the predictor computes, while sample i's chain runs (`Pre`): the
//    deltas D[t] - base, x - base, the residual of lanes that do not
//    use the FIR, the walk's signs, and its running sums
//    P(t) = sum over s < t of ((+-|val_s|) >> quant) * (s + 1) for both
//    signs of the residual.  On the chain remain: the FIR as a dot
//    product of known deltas with the coefficients (4 partial sums), the
//    round and shift, the residual, the walk's stop, the coefficient
//    update.
//  - A branch-free walk.  Tap t acts while every earlier tap acted and
//    ev(t) = err - P(t) keeps err's sign, so the stop is a running AND of
//    comparisons against the precomputed sums, and each coefficient
//    update a select.  ev(t) is the serial walk's error exactly: both
//    are err minus the same terms in wrapping int32 arithmetic, and
//    subtraction mod 2^32 regroups freely.  This was also fuzzed against
//    the one-thread kernel on the CPU (both sources compiled with g++
//    under a thread emulation of the block), the int32-wraparound inputs
//    included.
//  - Order buckets.  The FIR, the walk and the window run MO steps, a
//    template bound on max_order (4, 6, 8, 12, 16 or 31, the decoder's
//    buckets); coefficients past max_order are zeroed once and the
//    window is appended only at slot order <= max_order, which keeps
//    every lane's result that of an instantiation at max_order.
//  - A block stops at its longest lane; the producer writes the zero
//    tail.  Planes are sample-major (S, B); any B and S (16-byte copies
//    where B % 4 == 0 and the planes are aligned, 4-byte ones otherwise).
//
// What limits it now (measured on the H100, PERF.md §6): still the
// predictor warp's per-sample chain, ~3.3x faster than the first port
// but ~40x over the kernel's operation bound.  A single warp issues in
// order, and the next sample's part hides only partly under the chain:
// without the walk's running sums the kernel ran in 58% of its time.
// The next step is that part on a helper warp through the ring.
//
// Bit-exactness: ALAC's arithmetic is C# int32 with wraparound.  Signed
// overflow is undefined in CUDA C++, so every product or sum that can
// wrap runs in uint32_t; shift counts are masked where the JAX kernel
// masks them (`& 31` in signext and qshift), and the arithmetic shift by
// `quant` gives the sign fill for counts of 32 or more, as jax.lax does.

#include <cstdint>
#include <cuda_runtime.h>

#include "ring_sync.cuh"

namespace {

using namespace alac_ring;

constexpr int kMaxOrder = 31;
constexpr int kLanes = 16;     // lanes per block
constexpr int kThreads = 64;   // producer warp, predictor warp
constexpr int kTile = 32;      // samples per tile
constexpr int kInSlots = 4;    // signal ring
constexpr int kAhead = kInSlots - 1;  // tiles in flight past the one read
constexpr int kOutSlots = 2;   // residual ring

// Named barriers 1..2*(kInSlots + kOutSlots), over both warps.
__device__ __forceinline__ int bar_full(int s) { return 1 + s; }
__device__ __forceinline__ int bar_empty(int s) { return 1 + kInSlots + s; }
__device__ __forceinline__ int bar_ofull(int o) { return 1 + 2 * kInSlots + o; }
__device__ __forceinline__ int bar_oempty(int o) {
  return 1 + 2 * kInSlots + kOutSlots + o;
}

struct Smem {
  int32_t in[kInSlots][kTile][kCols];    // 16 KB
  int32_t out[kOutSlots][kTile][kCols];  // 8 KB
};

struct Args {
  const int32_t* __restrict__ sig;
  int B, S, max_order;
  bool vec;
  const int32_t* __restrict__ n;
  const int32_t* __restrict__ rss;
  const int32_t* __restrict__ order;
  const int32_t* __restrict__ quant;
  const int32_t* __restrict__ rc;
  int32_t* __restrict__ errs;
};

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

// ---- producer warp: signal tiles in, residual tiles out ----
__device__ __forceinline__ void produce(const Args& a, Smem& sm, int t, int b0,
                                        int nmax) {
  const int T = (nmax + kTile - 1) / kTile;  // tiles with a live sample
  for (int j = 0; j < kAhead; ++j) {
    if (j < T) load_tile<kLanes, kTile>(sm.in[j], a.sig, a.B, a.S, b0, j * kTile, a.vec, t);
    cp_async_commit();
  }
  for (int c = 0; c <= T; ++c) {
    if (c < T) {
      // One group per tile: all but the newest kAhead - 1 landed is
      // tile c landed.
      cp_async_wait<kAhead - 1>();
      bar_arrive(bar_full(c % kInSlots), kThreads);
      const int j = c + kAhead;  // refill the slot of tile c - 1
      if (j < T) {
        if (j >= kInSlots) bar_sync(bar_empty(j % kInSlots), kThreads);
        load_tile<kLanes, kTile>(sm.in[j % kInSlots], a.sig, a.B, a.S, b0, j * kTile,
                            a.vec, t);
      }
      cp_async_commit();
    }
    if (c >= 1) {  // tile c - 1's residuals
      const int d = c - 1, o = d % kOutSlots;
      bar_sync(bar_ofull(o), kThreads);
      // rows up to the block's longest lane (nmax <= S)
      store_tile<int32_t, kLanes, kTile>(a.errs, sm.out[o], a.B, nmax, b0, d * kTile, a.vec, t);
      if (d + kOutSlots < T) bar_arrive(bar_oempty(o), kThreads);
    }
  }
  // Every sample past the block's longest lane is 0.
  for (int i = nmax; i < a.S; i += kTile) {
    store_tile<int32_t, kLanes, kTile>(a.errs, nullptr, a.B, a.S, b0, i, a.vec, t);
  }
  cp_async_wait<0>();
}

// What the chain of one sample needs that depends on the signal alone.
template <int MO>
struct Pre {
  uint32_t d[MO + 1];  // d[t] = D[t] - base, t = 1..MO
  int32_t pp[MO];      // P(t) for err > 0 (pp[0] = 0)
  int32_t pn[MO];      // P(t) for err <= 0
  int32_t sg[MO];      // sign of val_t = base - D[t + 1]
  int32_t xb;          // x - base
  int32_t alt;         // the residual where the FIR is not used
  bool fir;            // the FIR and the walk run
};

// ---- predictor warp: the chain (AlacFile.cs:256-336, base-aligned) ----
template <int MO>
__device__ __forceinline__ void predict(const Args& a, Smem& sm, int lane, int b,
                                        int nmax) {
  const bool valid = lane < kLanes && b < a.B;
  const int32_t n = valid ? a.n[b] : 0;
  const int32_t order = valid ? a.order[b] : 0;
  const int32_t quant = valid ? a.quant[b] : 0;
  const int32_t rss = valid ? a.rss[b] : 0;
  // sra by quant (counts outside [0, 31] give the sign fill)
  const int32_t qs = (uint32_t)quant > 31u ? 31 : quant;
  const uint32_t round = 1u << ((quant - 1) & 31);
  const bool is_pass = order == 0;
  const bool fir_lane = !is_pass && order != kMaxOrder;
  const int tmax = order < a.max_order ? order : a.max_order;  // walk depth

  // Indexed only by unrolled loop counters: registers.  rc[t] = 0 past
  // max_order; at[t] is all ones at the slot each sample appends to.
  int32_t rc[MO + 1];
  int32_t D[MO + 1];  // D[t] = x[i - 1 - order + t], t <= order
  uint32_t at[MO + 1];
#pragma unroll
  for (int t = 0; t <= MO; ++t) {
    rc[t] = valid && t <= a.max_order ? a.rc[(size_t)b * (kMaxOrder + 1) + t] : 0;
    D[t] = 0;
    at[t] = t == order && order <= a.max_order ? ~0u : 0u;
  }

  // The signal-only part of sample j, from the window before j's append.
  auto prep = [&](Pre<MO>& p, int32_t x, int32_t xprev, int j) {
    const int32_t base = D[0];
    p.xb = wsub(x, base);
    p.alt = (j == 0 || is_pass) ? x : signext(wsub(x, xprev), rss);
    p.fir = fir_lane && j > 0 && j > order;
    int32_t sp = 0, sn = 0;
#pragma unroll
    for (int t = 0; t < MO; ++t) {
      p.d[t + 1] = (uint32_t)wsub(D[t + 1], base);
      const int32_t val = wsub(base, D[t + 1]);
      const int32_t av = val < 0 ? wsub(0, val) : val;  // |val|, INT32_MIN stays
      p.sg[t] = (val > 0) - (val < 0);
      p.pp[t] = sp;
      p.pn[t] = sn;
      sp = wadd(sp, wmul(av >> qs, t + 1));
      sn = wadd(sn, wmul(wsub(0, av) >> qs, t + 1));
    }
  };
  // Append x at the lane's slot, shifting the window left by one (every
  // sample, past n too: nothing after n is observable).
  auto advance = [&](int32_t x) {
#pragma unroll
    for (int t = 0; t < MO; ++t) {
      D[t] = (int32_t)(((uint32_t)x & at[t]) | ((uint32_t)D[t + 1] & ~at[t]));
    }
    D[MO] = (int32_t)(((uint32_t)x & at[MO]) | ((uint32_t)D[MO] & ~at[MO]));
  };

  const int T = (nmax + kTile - 1) / kTile;
  if (T == 0) return;
  bar_sync(bar_full(0), kThreads);
  int32_t x = sm.in[0][0][lane];
  Pre<MO> p;
  prep(p, x, 0, 0);
  advance(x);

  // Sample i = c * kTile + r: the next sample's signal-only part (xn
  // is its input), then the chain of sample i.  Called for every row of
  // a tile but the last from a loop without a branch, so consecutive
  // samples form one basic block the compiler can interleave.
  auto sample = [&](int c, int r, int32_t xn) {
    const int i = c * kTile + r;
    Pre<MO> pn;
    prep(pn, xn, x, i + 1);

    uint32_t f0 = round, f1 = 0u, f2 = 0u, f3 = 0u;
#pragma unroll
    for (int t = 1; t <= MO; ++t) {
      const uint32_t q = p.d[t] * (uint32_t)rc[t];
      if ((t & 3) == 0) f0 += q;
      if ((t & 3) == 1) f1 += q;
      if ((t & 3) == 2) f2 += q;
      if ((t & 3) == 3) f3 += q;
    }
    const int32_t outval = (int32_t)((f0 + f1) + (f2 + f3)) >> qs;
    const int32_t err = p.fir ? signext(wsub(p.xb, outval), rss) : p.alt;
    // Tap t acts while every earlier tap acted and ev(t) = err - P(t)
    // keeps err's sign (none acts for err == 0).  With pm = err > 0 ?
    // 0 : -1, "keeps the sign" is (ev ^ pm) > pm and +-sign(val) is
    // (sg ^ pm) - pm.
    const int32_t pm = err > 0 ? 0 : -1;
    bool alive = p.fir;
#pragma unroll
    for (int t = 0; t < MO; ++t) {
      const int32_t ev = wsub(err, pm == 0 ? p.pp[t] : p.pn[t]);
      alive = alive && t < tmax && (ev ^ pm) > pm;
      rc[t + 1] = wsub(rc[t + 1], alive ? wsub(p.sg[t] ^ pm, pm) : 0);
    }
    sm.out[c % kOutSlots][r][lane] = i < n ? err : 0;

    advance(xn);
    x = xn;
    p = pn;
  };

  for (int c = 0; c < T; ++c) {
    const int s = c % kInSlots;
    if (c >= kOutSlots) bar_sync(bar_oempty(c % kOutSlots), kThreads);
    const int rows = min(kTile, nmax - c * kTile);
    const int body = min(rows, kTile - 1);
#pragma unroll 2
    for (int r = 0; r < body; ++r) sample(c, r, sm.in[s][r + 1][lane]);
    if (rows == kTile) {  // the last row reads the next tile's first sample
      int32_t xn = 0;
      if (c + 1 < T) {
        bar_sync(bar_full((c + 1) % kInSlots), kThreads);
        xn = sm.in[(c + 1) % kInSlots][0][lane];
      }
      sample(c, kTile - 1, xn);
    }
    if (c + kInSlots < T) bar_arrive(bar_empty(s), kThreads);
    bar_arrive(bar_ofull(c % kOutSlots), kThreads);
  }
}

template <int MO>
__global__ void __launch_bounds__(kThreads) enc_pred_kernel(const Args a) {
  __shared__ __align__(16) Smem sm;
  const int t = threadIdx.x & 31;
  const int b0 = blockIdx.x * kLanes;
  const int b = b0 + t;
  const int32_t n = t < kLanes && b < a.B ? a.n[b] : 0;
  // Both warps walk the same tiles: up to the block's longest lane.
  const int nlive = n < 0 ? 0 : (n > a.S ? a.S : n);
  const int nmax = (int)__reduce_max_sync(0xFFFFFFFFu, (unsigned)nlive);
  if (threadIdx.x < 32) {
    produce(a, sm, t, b0, nmax);
  } else {
    predict<MO>(a, sm, t, b, nmax);
  }
}

template <int MO>
void launch(const Args& a, cudaStream_t st) {
  enc_pred_kernel<MO><<<(a.B + kLanes - 1) / kLanes, kThreads, 0, st>>>(a);
}

}  // namespace

// order_bucket: 4, 6, 8, 12, 16 or 31, at least max_order (the wrapper
// picks it).
extern "C" int alac_enc_pred(const void* sig_sb, int B, int S, const void* n,
                             const void* rss, const void* order,
                             const void* quant, const void* rc, int max_order,
                             int order_bucket, void* errs_sb, void* stream) {
  if (max_order < 0 || max_order > kMaxOrder || max_order > order_bucket) {
    return (int)cudaErrorInvalidValue;
  }
  if (B <= 0 || S <= 0) return (int)cudaGetLastError();
  const bool vec = B % 4 == 0 && ((uintptr_t)sig_sb | (uintptr_t)errs_sb) % 16 == 0;
  const Args a{(const int32_t*)sig_sb, B, S, max_order, vec,
               (const int32_t*)n, (const int32_t*)rss, (const int32_t*)order,
               (const int32_t*)quant, (const int32_t*)rc, (int32_t*)errs_sb};
  cudaStream_t st = (cudaStream_t)stream;
  switch (order_bucket) {
    case 4: launch<4>(a, st); break;
    case 6: launch<6>(a, st); break;
    case 8: launch<8>(a, st); break;
    case 12: launch<12>(a, st); break;
    case 16: launch<16>(a, st); break;
    case 31: launch<31>(a, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
