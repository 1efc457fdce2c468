// The Rice / adaptive-Golomb emitter automaton of the ALAC encoder, one
// channel per thread, in two steps that both kernels of the automaton
// share, so they cannot drift apart:
//  - state_step: the serial part of a sample (dv, raw, the desync flag,
//    k, the history update h2, the zero-run test, kz, and the history /
//    sign-modifier / skip update);
//  - symbol_step: the two symbols of a sample (value, zero run) from
//    what state_step handed over; no state.
// Both kernels, enc_rice.cu (fields merged into 96-bit chunks) and
// rice_emit.cu (fields written unmerged), run state_step in the state
// warp and symbol_step in the emit warps of rice_ring.cuh's skeleton.
//
// The step is ops/encode.rice_symbols' state machine (the decoder's
// EntropyRiceDecode run forward, AlacFile.cs:214-252) and each symbol
// ops/encode._emit_sym's nine-step quotient ladder, expression for
// expression.
//
// Bit-exactness: every wrapping product and sum runs in uint32_t
// (2*err, h*mult, dv*mult); shifts follow jax.lax (left by 32 or more
// gives 0, arithmetic right by 32 or more gives the sign fill); clz(0)
// is 40.

#pragma once

#include <cstdint>

namespace alac_rice {

constexpr int kRiceThreshold = 8;

__device__ __forceinline__ int32_t wadd(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a + (uint32_t)b);
}
__device__ __forceinline__ int32_t wsub(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a - (uint32_t)b);
}
__device__ __forceinline__ int32_t wmul(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a * (uint32_t)b);
}
__device__ __forceinline__ int32_t clz40(int32_t x) {
  return x == 0 ? 40 : __clz(x);
}
// jax.lax.shift_left on int32: counts outside [0, 31] give 0.
__device__ __forceinline__ int32_t shl(int32_t x, int32_t c) {
  return (uint32_t)c > 31u ? 0 : (int32_t)((uint32_t)x << c);
}

struct Sym {
  int32_t v0, w0, v1, w1;
};

// One entropy symbol (ops/encode._emit_sym; AlacFile.cs:193-212 run
// forward): the unary/escape field and the remainder/raw field.
__device__ __forceinline__ Sym emit_sym(int32_t raw, int32_t rss, int32_t k,
                                        int32_t mask) {
  const int32_t k_safe = k < 1 ? 1 : (k > 31 ? 31 : k);
  const int32_t m = (int32_t)(((1u << k_safe) - 1u) & (uint32_t)mask);
  int32_t rem = raw, q = 0;
#pragma unroll
  for (int s = 0; s <= kRiceThreshold; ++s) {
    const bool c = m > 0 && rem >= m;
    rem = c ? wsub(rem, m) : rem;
    q += c;
  }
  const bool esc_q = m <= 0 || q > kRiceThreshold;
  const bool is_k1 = k == 1;
  const bool esc = is_k1 ? raw > kRiceThreshold : esc_q;
  const int32_t uq = is_k1 ? (raw < kRiceThreshold ? raw : kRiceThreshold) : q;
  Sym s;
  s.v0 = esc ? 0x1FF : wsub(shl(1, wadd(uq, 1)), 2);
  s.w0 = esc ? 9 : wadd(uq, 1);
  s.v1 = esc ? raw : (is_k1 ? 0 : (rem == 0 ? 0 : wadd(rem, 1)));
  s.w1 = esc ? rss : (is_k1 ? 0 : (rem == 0 ? k_safe - 1 : k_safe));
  return s;
}

// A lane's parameters (each (B,) int32 on the host side).
struct Params {
  int32_t n, rss, kmod, mult, kmask;
};

// A lane's automaton state, carried in registers across samples.
struct State {
  int32_t h, sgnmod, skip;
  bool bad;
};

// What state_step hands to symbol_step for one sample: the value's
// code (raw, k), the zero run's k (kz), and whether each symbol is live
// (the widths of a symbol that is not live are 0).
struct StepOut {
  int32_t raw, k, kz;
  bool emit_v, emit_z;
};

// Sample i of a lane: the state machine's serial part.  It runs for
// every i (past n too, where nothing is live and the state holds), as
// the plain version runs over the whole plane.
__device__ __forceinline__ StepOut state_step(State& st, const Params& p, int i,
                                              int32_t err, int32_t zr) {
  const bool in_skip = st.skip > 0;
  const bool active = i < p.n && !in_skip;

  const int32_t dv = err > 0 ? wmul(2, err)
                             : (err < 0 ? wsub(wmul(-2, err), 1) : 0);
  StepOut out;
  out.raw = wsub(dv, st.sgnmod);
  st.bad = st.bad | (active & (out.raw < 0));
  const int32_t ik = 31 - p.kmod - clz40(wadd(st.h >> 9, 3));
  out.k = ik < 0 ? ik + p.kmod : p.kmod;

  const int32_t h2 = dv > 0xFFFF
                         ? 0xFFFF
                         : wsub(wadd(st.h, wmul(dv, p.mult)),
                                wmul(st.h, p.mult) >> 9);
  const bool zcond = h2 < 128 && i + 1 < p.n;
  const int32_t kz = clz40(h2) + (wadd(h2, 16) >> 6) - 24;
  out.kz = kz < 31 ? kz : 31;
  out.emit_v = active;
  out.emit_z = active && zcond;

  // Selects, not branches: a branch here would end the basic block, and
  // the compiler could not interleave consecutive samples' work.
  const int32_t skip_idle = in_skip && i < p.n ? st.skip - 1 : st.skip;
  st.h = active ? (zcond ? 0 : h2) : st.h;
  st.sgnmod = active ? (zcond ? 1 : 0) : st.sgnmod;
  st.skip = active ? (zcond ? zr : 0) : skip_idle;
  return out;
}

// The sample's two symbols: the value (raw under k) and the zero run
// (zr under kz and the lane's mask).  Computed whether live or not.
__device__ __forceinline__ void symbol_step(const StepOut& o, int32_t zr,
                                            const Params& p, Sym& sv, Sym& sz) {
  sv = emit_sym(o.raw, p.rss, o.k, -1);
  sz = emit_sym(zr, 16, o.kz, p.kmask);
}

}  // namespace alac_rice
