// The Rice / adaptive-Golomb emitter automaton of the ALAC encoder, one
// channel per thread: the per-sample step shared by enc_rice.cu (fields
// merged into 96-bit chunks) and rice_emit.cu (fields written unmerged),
// so the two kernels cannot drift apart.
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

// What one sample emits: the value symbol, the zero-run symbol, and
// whether each is live (widths of a symbol that is not live are 0).
struct Step {
  Sym sv, sz;
  bool emit_v, emit_z;
};

// Sample i of a lane: both symbols, then the state update.  Symbols are
// computed for every i (past n too, where they are not live), as the
// plain version computes them over the whole plane.
__device__ __forceinline__ Step step(State& st, const Params& p, int i,
                                     int32_t err, int32_t zr) {
  const bool in_skip = st.skip > 0;
  const bool active = i < p.n && !in_skip;

  const int32_t dv = err > 0 ? wmul(2, err)
                             : (err < 0 ? wsub(wmul(-2, err), 1) : 0);
  const int32_t raw = wsub(dv, st.sgnmod);
  st.bad = st.bad || (active && raw < 0);
  const int32_t ik = 31 - p.kmod - clz40(wadd(st.h >> 9, 3));
  const int32_t k = ik < 0 ? ik + p.kmod : p.kmod;
  Step out;
  out.sv = emit_sym(raw, p.rss, k, -1);

  const int32_t h2 = dv > 0xFFFF
                         ? 0xFFFF
                         : wsub(wadd(st.h, wmul(dv, p.mult)),
                                wmul(st.h, p.mult) >> 9);
  const bool zcond = h2 < 128 && i + 1 < p.n;
  int32_t kz = clz40(h2) + (wadd(h2, 16) >> 6) - 24;
  kz = kz < 31 ? kz : 31;
  out.sz = emit_sym(zr, 16, kz, p.kmask);
  out.emit_v = active;
  out.emit_z = active && zcond;

  if (active) {
    st.h = zcond ? 0 : h2;
    st.sgnmod = zcond ? 1 : 0;
    st.skip = zcond ? zr : 0;
  } else if (in_skip && i < p.n) {
    st.skip -= 1;
  }
  return out;
}

}  // namespace alac_rice
