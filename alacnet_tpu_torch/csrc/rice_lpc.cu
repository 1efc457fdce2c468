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
// cannot be split across threads.  The work per sample is a few dozen
// integer ops plus dependent loads, so the kernel is bound by the
// latency of one thread's dependency chain, not by bytes or ops: a
// 4096-lane span is only 4096 threads, far below the card's capacity.
//
// What the design does about it: one thread per lane, and small blocks
// (kThreads lanes each) so that a 4096-lane span spreads over all 132
// SMs instead of piling onto a few.  Each thread keeps a 4-word register
// window of its own word row (refilled as its bit cursor moves, at most
// 3 words per sample), so the event reads are register selects, not
// loads.  The FIR window is a 32-entry shift register of recent outputs
// and the coefficients a 32-entry array, both in registers (every index
// is an unrolled loop counter); the FIR, the walk and the shift stop at
// the lane's own order.  Outputs go to sample-major (S, B) scratch, so
// the 32 lanes of a warp store 32 consecutive words per sample.
//
// Bit-exactness: ALAC's arithmetic is C# int32 with wraparound.  Signed
// overflow is undefined in CUDA C++, so every product or sum that can
// wrap runs in uint32_t and is cast back; every shift count is masked
// exactly where the JAX kernel masks it; clz(0) is 40, not __clz's 32.
// Word reads past the row clip to its last word, as the JAX fetch does
// (the padded row's tail is zero).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 32;  // lanes per block: 4096 lanes -> 128 blocks
constexpr int kRiceThreshold = 8;
constexpr int kMaxOrder = 31;

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

struct Row {
  const uint32_t* __restrict__ w;
  int W;
  int cw;             // word index of c0
  uint32_t c0, c1, c2, c3;

  __device__ __forceinline__ uint32_t ld(int j) const {
    j = j < 0 ? 0 : (j > W - 1 ? W - 1 : j);
    return __ldg(w + j);
  }
  __device__ __forceinline__ void reset(int wp) {
    cw = wp;
    c0 = ld(wp); c1 = ld(wp + 1); c2 = ld(wp + 2); c3 = ld(wp + 3);
  }
  // Slide the window forward so that it starts at word wp.
  __device__ __forceinline__ void seek(int wp) {
    const int d = wp - cw;
    if (d == 0) return;
    if (d < 0 || d > 3) { reset(wp); return; }
    for (int k = 0; k < d; ++k) {
      c0 = c1; c1 = c2; c2 = c3; c3 = ld(cw + 4 + k);
    }
    cw = wp;
  }
  // The 32 bits at absolute bit position p, left-aligned
  // (`_window32`: hi << s | (s ? lo >> (32 - s) : 0)).
  __device__ __forceinline__ uint32_t win32(int p) const {
    const int wi = p >> 5;
    const uint32_t s = (uint32_t)p & 31u;
    const int d = wi - cw;
    uint32_t hi, lo;
    if (d >= 0 && d <= 2) {
      hi = d == 0 ? c0 : (d == 1 ? c1 : c2);
      lo = d == 0 ? c1 : (d == 1 ? c2 : c3);
    } else {
      hi = ld(wi);
      lo = ld(wi + 1);
    }
    return (hi << s) | (s == 0u ? 0u : lo >> ((32u - s) & 31u));
  }
};

// One entropy_decode_value at absolute bit position p (`_decode_event`,
// AlacFile.cs:193-212).
__device__ __forceinline__ void decode_event(
    const Row& row, int p, int32_t rss, int32_t k, int32_t mult_mask,
    int32_t* value, int32_t* consumed) {
  const int32_t u9 = (int32_t)(row.win32(p) >> 23);
  const int32_t inv = (~u9) & 0x1FF;
  int32_t x = clz40((uint32_t)inv << 23);
  x = x < kRiceThreshold + 1 ? x : kRiceThreshold + 1;
  const int32_t ucons = x > kRiceThreshold ? 9 : x + 1;
  const bool esc = x > kRiceThreshold;
  const uint32_t fwin = row.win32(p + ucons);
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

__global__ void __launch_bounds__(kThreads) rice_lpc_kernel(
    const uint32_t* __restrict__ words, int B, int W,
    const int32_t* __restrict__ start, const int32_t* __restrict__ n_arr,
    const int32_t* __restrict__ rss_arr, const int32_t* __restrict__ kmod_arr,
    const int32_t* __restrict__ ihist_arr, const int32_t* __restrict__ mult_arr,
    const int32_t* __restrict__ kmask_arr, const int32_t* __restrict__ order_arr,
    const int32_t* __restrict__ quant_arr, const int32_t* __restrict__ rc_in,
    int S, int max_order, int32_t* __restrict__ out_sb,
    int32_t* __restrict__ end) {
  const int b = blockIdx.x * kThreads + threadIdx.x;
  if (b >= B) return;

  const int32_t n = n_arr[b];
  const int32_t rss = rss_arr[b];
  const int32_t kmod = kmod_arr[b];
  const int32_t mult = mult_arr[b];
  const int32_t kmask = kmask_arr[b];
  const int32_t order = order_arr[b];
  const int32_t quant = quant_arr[b];
  const int32_t qshift = (quant - 1) & 31;
  const bool is_pass = order == 0;
  const bool is_int31 = order == kMaxOrder;
  // FIR / adaptive-walk depth: the lane's order, bounded like the JAX
  // kernel's static block bound (slots past `order` hold zero
  // coefficients there, so they add nothing).
  const int tmax = order < max_order ? order : max_order;

  // Both arrays are indexed only by unrolled loop counters, so they
  // live in registers.
  int32_t rc[kMaxOrder + 1];
  int32_t D[kMaxOrder + 1];  // D[t] = out[i - 1 - order + t]
#pragma unroll
  for (int t = 0; t <= kMaxOrder; ++t) {
    rc[t] = rc_in[(size_t)b * (kMaxOrder + 1) + t];
    D[t] = 0;
  }

  Row row;
  row.w = words + (size_t)b * W;
  row.W = W;
  int32_t bitpos = start[b];
  row.reset(n > 0 ? (bitpos >> 5) : 0);

  int32_t hist = ihist_arr[b];
  int32_t signmod = 0, zrun = 0, prev = 0;

  for (int i = 0; i < S; ++i) {
    if (i >= n) {  // frozen lane: zero output, state kept
      out_sb[(size_t)i * B + b] = 0;
      continue;
    }
    const bool in_zero = zrun > 0;
    int32_t err = 0;
    if (!in_zero) {
      // ---- Rice event (AlacFile.cs:214-252) ----
      row.seek(bitpos >> 5);
      int32_t k = 31 - clz40((uint32_t)wadd(hist >> 9, 3));
      k = k < kmod ? k : kmod;
      int32_t raw, consumed;
      decode_event(row, bitpos, rss, k, -1, &raw, &consumed);
      const int32_t dv = wadd(raw, signmod);
      const int32_t tplus = wadd(dv, 1);
      int32_t almost = tplus >> 1;
      if (tplus < 0 && (tplus & 1) != 0) almost += 1;
      err = (dv & 1) != 0 ? wsub(0, almost) : almost;
      const int32_t hist2 = dv > 0xFFFF
          ? 0xFFFF
          : wsub(wadd(hist, wmul(dv, mult)), wmul(hist, mult) >> 9);
      const bool zcond = hist2 < 128 && i + 1 < n;
      int32_t consumed_tot = consumed;
      if (zcond) {
        int32_t kz = clz40((uint32_t)hist2) + (wadd(hist2, 16) >> 6) - 24;
        kz = kz < 31 ? kz : 31;
        int32_t bsize, bcons;
        decode_event(row, bitpos + consumed, 16, kz, kmask, &bsize, &bcons);
        consumed_tot += bcons;
        hist = 0;
        signmod = bsize > 0xFFFF ? 0 : 1;
        zrun = bsize;
      } else {
        hist = hist2;
        signmod = 0;
        zrun = 0;
      }
      bitpos = wadd(bitpos, consumed_tot);
    } else {
      zrun -= 1;
    }

    // ---- fused LPC (AlacFile.cs:256-336; base-aligned layout) ----
    int32_t out;
    const bool use_int = is_int31 || i <= order;
    if (i == 0 || is_pass) {
      out = err;
    } else if (use_int) {
      out = signext(wadd(prev, err), rss);
    } else {
      const int32_t base = D[0];
      uint32_t fir = 0u;
#pragma unroll
      for (int t = 1; t <= kMaxOrder; ++t) {
        if (t <= tmax) fir += (uint32_t)wsub(D[t], base) * (uint32_t)rc[t];
      }
      const int32_t outval = (int32_t)((1u << qshift) + fir) >> quant;
      out = signext(wadd(wadd(outval, base), err), rss);
      // adaptive coefficient walk (AlacFile.cs:312-332)
      if (err != 0) {
        const bool pos_b = err > 0;
        int32_t ev = err;
#pragma unroll
        for (int t = 0; t < kMaxOrder; ++t) {
          const bool act_p = pos_b && ev > 0;
          const bool act_n = !pos_b && ev < 0;
          // A lane that stops acting never acts again: ev keeps its
          // sign from here on.
          if (t >= tmax || !(act_p || act_n)) break;
          const int32_t val = wsub(base, D[t + 1]);
          const int32_t sgn = (val > 0) - (val < 0);
          const int32_t se = act_p ? sgn : -sgn;
          rc[t + 1] = wsub(rc[t + 1], se);
          ev = wsub(ev, wmul(wmul(val, se) >> quant, t + 1));
        }
      }
    }
    // Shift the window left by one and append at slot `order`.  Only
    // slots 0..order are ever read (FIR and walk stop at tmax <= order),
    // and order-0 / order-31 lanes read none.
    if (!is_pass && !is_int31) {
#pragma unroll
      for (int t = 0; t < kMaxOrder; ++t) {
        if (t > order) break;
        D[t] = t < order ? D[t + 1] : out;
      }
    }
    prev = out;
    out_sb[(size_t)i * B + b] = out;
  }
  end[b] = bitpos;
}

}  // namespace

extern "C" int alac_rice_lpc(
    const void* words, int B, int W, const void* start, const void* n,
    const void* rss, const void* kmod, const void* ihist, const void* mult,
    const void* kmask, const void* order, const void* quant, const void* rc,
    int S, int max_order, void* out_sb, void* end, void* stream) {
  if (B > 0) {
    rice_lpc_kernel<<<(B + kThreads - 1) / kThreads, kThreads, 0,
                      (cudaStream_t)stream>>>(
        (const uint32_t*)words, B, W, (const int32_t*)start,
        (const int32_t*)n, (const int32_t*)rss, (const int32_t*)kmod,
        (const int32_t*)ihist, (const int32_t*)mult, (const int32_t*)kmask,
        (const int32_t*)order, (const int32_t*)quant, (const int32_t*)rc, S,
        max_order, (int32_t*)out_sb, (int32_t*)end);
  }
  return (int)cudaGetLastError();
}
