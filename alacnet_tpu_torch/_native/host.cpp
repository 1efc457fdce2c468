// Native host runtime for alacnet_tpu: frame-record packing + header parse.
//
// This is the C++ tier of the host pipeline (stage 1 of SURVEY.md §2.5
// "PP"): given the mdat blob and the stsz-derived (offset, size) table, it
// simultaneously
//   * packs every coded ALAC frame into a zero-padded big-endian uint32
//     word grid (the device kernels' input layout, ops/bitreader.py) —
//     memcpy+bswap32 inner loop, ~4 GB/s single-core — and
//   * parses each frame's header (element tag, flags, per-channel
//     prediction headers + coefficient tables — AlacFile.cs:435-475,
//     577-632) into the per-lane parameter arrays of codec.framemeta.
//
// Exposed as a flat C ABI consumed via ctypes (alacnet_tpu/native.py);
// the NumPy implementations remain as the portable fallback and the
// differential oracle (tests/test_native.py).
//
// Build: g++ -O3 -shared -fPIC -fopenmp host.cpp -o libalachost.so

#include <cstdint>
#include <cstring>
#include <algorithm>
#include <vector>

namespace {

constexpr int kMaxOrder = 31;

struct BitReader {
  const uint8_t* buf;
  int64_t len;
  int64_t idx = 0;
  int acc = 0;

  explicit BitReader(const uint8_t* b, int64_t n) : buf(b), len(n) {}

  inline uint32_t byte_at(int64_t i) const {
    return (i >= 0 && i < len) ? buf[i] : 0u;
  }

  // 1..16-bit big-endian read (AlacFile.cs:101-118).
  inline uint32_t readbits16(int bits) {
    uint32_t w = (byte_at(idx) << 16) | (byte_at(idx + 1) << 8) | byte_at(idx + 2);
    uint32_t result = ((w << acc) & 0x00FFFFFFu) >> (24 - bits);
    int na = acc + bits;
    idx += na >> 3;
    acc = na & 7;
    return result;
  }

  // 1..32-bit big-endian read (AlacFile.cs:125-129).
  inline uint32_t readbits(int bits_param) {
    int bits = bits_param <= 16 ? bits_param : bits_param - 16;
    uint32_t hi = bits_param <= 16 ? 0u : readbits16(16) << bits;
    return hi | readbits16(bits);
  }

  inline int64_t bitpos() const { return idx * 8 + acc; }
};

}  // namespace

extern "C" {

// Pack ragged frames into a (B, nwords) big-endian->native uint32 grid.
//   blob: concatenated file bytes;  offsets/sizes: (B,) int64
//   words: preallocated (B * nwords) uint32, zeroed by callee
void alac_pack_frames(const uint8_t* blob, int64_t blob_len,
                      const int64_t* offsets, const int64_t* sizes,
                      int64_t batch, int64_t nwords, uint32_t* words) {
#pragma omp parallel for schedule(static)
  for (int64_t b = 0; b < batch; ++b) {
    const int64_t off = offsets[b];
    int64_t sz = sizes[b];
    if (off < 0 || off > blob_len) sz = 0;
    if (off + sz > blob_len) sz = blob_len - off;
    const uint8_t* src = blob + off;
    uint32_t* dst = words + b * nwords;
    const int64_t full = std::min(sz / 4, nwords);
    // memcpy + bswap32: compiles to vectorized loads + byte shuffles
    // (the manual shift-OR form stays scalar), ~4x the pack bandwidth.
    int64_t w = 0;
    for (; w < full; ++w) {
      uint32_t v;
      std::memcpy(&v, src + w * 4, 4);
      dst[w] = __builtin_bswap32(v);
    }
    if (w < nwords) {
      uint32_t tail = 0;
      for (int64_t i = w * 4; i < sz; ++i) {
        tail |= uint32_t(src[i]) << (24 - 8 * (i - w * 4));
      }
      if (sz - w * 4 > 0) dst[w++] = tail;
      std::memset(dst + w, 0, size_t(nwords - w) * 4);
    }
  }
}

// Parse every frame header. Per-frame cookie inputs:
//   sample_size, kmod, init_history, hist_mult4 (historymult/4),
//   max_samples — all (B,) int32.
// Outputs (preallocated): see codec/framemeta.FrameBatch; rc is the
// base-aligned reversed coefficient layout (B, 2, 32).
// Returns 0 on success, or 1 + index of the first offending frame:
//   status_out[b]: 0 ok, 1 bad channel tag, 2 bad prediction type.
int64_t alac_parse_headers(
    const uint8_t* blob, int64_t blob_len,
    const int64_t* offsets, const int64_t* sizes, int64_t batch,
    const int32_t* sample_size, const int32_t* kmod,
    const int32_t* init_history, const int32_t* hist_mult4,
    const int32_t* max_samples,
    // outputs
    uint8_t* is_stereo, uint8_t* is_compressed, int32_t* n_samples,
    int32_t* ub, int32_t* rss, int32_t* ishift, int32_t* ilw,
    int32_t* payload_pos, int32_t* entropy_pos,
    int32_t* order /*(B,2)*/, int32_t* quant /*(B,2)*/,
    int32_t* rice_mult /*(B,2)*/, int32_t* rc /*(B,2,32)*/,
    int32_t* kmod_out, int32_t* ihist_out, int32_t* kmask_out,
    int32_t* status_out) {
  int64_t first_bad = -1;
#pragma omp parallel for schedule(static)
  for (int64_t b = 0; b < batch; ++b) {
    status_out[b] = 0;
    const int64_t off = offsets[b];
    int64_t sz = sizes[b];
    if (off < 0 || off + sz > blob_len) sz = 0;
    BitReader r(blob + off, sz);
    const uint32_t tag = r.readbits(3);
    if (tag > 1) {
      status_out[b] = 1;
      continue;
    }
    const bool stereo = tag == 1;
    r.readbits(4);
    r.readbits(12);
    const uint32_t hassize = r.readbits(1);
    const uint32_t u = r.readbits(2);
    const uint32_t notcomp = r.readbits(1);
    const int32_t n = hassize ? int32_t(r.readbits(32)) : max_samples[b];
    is_stereo[b] = stereo;
    is_compressed[b] = notcomp == 0;
    n_samples[b] = n;
    kmod_out[b] = kmod[b];
    ihist_out[b] = init_history[b];
    kmask_out[b] = (1 << kmod[b]) - 1;
    int32_t* rcb = rc + b * 2 * (kMaxOrder + 1);
    for (int i = 0; i < 2 * (kMaxOrder + 1); ++i) rcb[i] = 0;
    order[b * 2] = order[b * 2 + 1] = 0;
    quant[b * 2] = quant[b * 2 + 1] = 0;
    rice_mult[b * 2] = rice_mult[b * 2 + 1] = 0;
    ishift[b] = ilw[b] = 0;
    if (notcomp == 0) {
      ub[b] = int32_t(u);
      rss[b] = sample_size[b] - 8 * int32_t(u) + (stereo ? 1 : 0);
      if (stereo) {
        ishift[b] = int32_t(r.readbits(8));
        ilw[b] = int32_t(r.readbits(8));
      } else {
        r.readbits(8);  // 16 unexplained bits (AlacFile.cs:457-459)
        r.readbits(8);
      }
      const int nch = stereo ? 2 : 1;
      bool bad = false;
      for (int c = 0; c < nch && !bad; ++c) {
        const uint32_t ptype = r.readbits(4);
        if (ptype != 0) {
          status_out[b] = 2;
          bad = true;
          break;
        }
        quant[b * 2 + c] = int32_t(r.readbits(4));
        const uint32_t rmod = r.readbits(3);
        const int32_t o = int32_t(r.readbits(5));
        order[b * 2 + c] = o;
        rice_mult[b * 2 + c] = int32_t(rmod) * hist_mult4[b];
        int32_t coefs[kMaxOrder];
        for (int j = 0; j < o; ++j) {
          int32_t v = int32_t(r.readbits(16));
          if (v > 32767) v -= 65536;
          coefs[j] = v;
        }
        if (o > 0 && o < kMaxOrder) {
          // base-aligned reversed layout rc[t] = coef[order - t]
          for (int t = 1; t <= o; ++t) {
            rcb[c * (kMaxOrder + 1) + t] = coefs[o - t];
          }
        }
      }
      if (bad) continue;
      payload_pos[b] = int32_t(r.bitpos());
      entropy_pos[b] =
          int32_t(r.bitpos()) + n * 8 * int32_t(u) * nch;
    } else {
      ub[b] = 0;
      rss[b] = sample_size[b] + (stereo ? 1 : 0);
      payload_pos[b] = int32_t(r.bitpos());
      entropy_pos[b] = int32_t(r.bitpos());
    }
  }
  for (int64_t b = 0; b < batch; ++b) {
    if (status_out[b] != 0) {
      first_bad = b;
      break;
    }
  }
  return first_bad < 0 ? 0 : 1 + first_bad;
}

int32_t alac_native_abi_version() { return 5; }

// Batched windowed autocorrelation for the encoder's Levinson stage:
// r[k*B + b] = sum_s x[b,s] * x[b,s+k], k = 0..order, over the
// zero-padded window (codec/encoder.levinson_coefs_batch).  One pass
// converts the lane to an L1-resident double buffer, then the lag dot
// products run over that hot buffer — replaces order+1 full-batch
// einsum sweeps (4.0 ms for B=1024, S=1024, order 6 on the bench host)
// with one.  The dot products use eight manual partial accumulators:
// -O3 alone must not vectorize an FP reduction (reassociation), so a
// single-accumulator loop serializes on FMA latency; the 8-way split
// both breaks that chain and gives the vectorizer independent lanes
// (2.8 -> 1.2 ms measured), while fixing the summation order
// identically on every ISA — coefficients are reproducible across
// hosts, unlike a fast-math reduction.
void alac_autocorr(
    const int32_t* x, int64_t B, int64_t S, int32_t order, double* r) {
#pragma omp parallel
  {
    std::vector<double> buf(static_cast<size_t>(S), 0.0);
#pragma omp for schedule(static)
    for (int64_t b = 0; b < B; ++b) {
      const int32_t* xb = x + b * S;
      double* __restrict__ d = buf.data();
      for (int64_t s = 0; s < S; ++s) d[s] = double(xb[s]);
      for (int32_t k = 0; k <= order; ++k) {
        double a0 = 0, a1 = 0, a2 = 0, a3 = 0;
        double a4 = 0, a5 = 0, a6 = 0, a7 = 0;
        const int64_t m = S - k;
        int64_t s = 0;
        for (; s + 8 <= m; s += 8) {
          a0 += d[s] * d[s + k];
          a1 += d[s + 1] * d[s + 1 + k];
          a2 += d[s + 2] * d[s + 2 + k];
          a3 += d[s + 3] * d[s + 3 + k];
          a4 += d[s + 4] * d[s + 4 + k];
          a5 += d[s + 5] * d[s + 5 + k];
          a6 += d[s + 6] * d[s + 6 + k];
          a7 += d[s + 7] * d[s + 7 + k];
        }
        for (; s < m; ++s) a0 += d[s] * d[s + k];
        r[int64_t(k) * B + b] = ((a0 + a1) + (a2 + a3)) + ((a4 + a5) + (a6 + a7));
      }
    }
  }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Encoder core (mirror of codec/encoder.py, which mirrors the decoder).
// ---------------------------------------------------------------------------

namespace {

struct BitWriter {
  uint8_t* out;
  int64_t bitpos;
  explicit BitWriter(uint8_t* o, int64_t p) : out(o), bitpos(p) {}
  inline void write(uint32_t value, int bits) {
    // MSB-first append into a pre-zeroed buffer.
    if (bits <= 0) return;
    value &= bits >= 32 ? 0xFFFFFFFFu : ((1u << bits) - 1u);
    int64_t p = bitpos;
    bitpos += bits;
    while (bits > 0) {
      const int64_t byte = p >> 3;
      const int used = int(p & 7);
      const int take = 8 - used < bits ? 8 - used : bits;
      const uint32_t chunk = (value >> (bits - take)) & ((1u << take) - 1u);
      out[byte] |= uint8_t(chunk << (8 - used - take));
      p += take;
      bits -= take;
    }
  }
  inline void write_unary(int ones) {
    for (int i = 0; i < ones; ++i) write(1, 1);
    write(0, 1);
  }
};

// Frame-local writer: 128-bit accumulator, whole 64-bit big-endian
// stores (no per-byte read-modify-write).  Only valid when one writer
// produces the whole buffer from bit 0 (alac_pack_symbol_frames /
// alac_pack_chunk_frames); the continuing writers (alac_rice_encode /
// alac_pack_bits append at arbitrary bit positions into shared
// buffers) keep the RMW BitWriter above.
//
// The 128-bit accumulator (vs the earlier 64-bit/32-bit-flush form)
// halves flush checks AND lets callers pre-combine several narrow
// fields into one push64 — the pack loop's serial dependency is the
// accumulator chain, so fewer/wider pushes are the whole ballgame
// (measured 1.7-1.8x on the chunk packer, DESIGN.md §7).
struct FastBitWriter {
  uint8_t* out;
  int64_t bytepos = 0;
  unsigned __int128 acc = 0;
  int nbits = 0;
  explicit FastBitWriter(uint8_t* o) : out(o) {}
  inline void write(uint32_t value, int bits) {
    if (bits <= 0) return;
    value &= bits >= 32 ? 0xFFFFFFFFu : ((1u << bits) - 1u);
    push(value, bits);
  }
  inline void push(uint32_t value, int bits) { push64(value, bits); }
  // Pre-masked fast path (value already < 2^bits); bits in [0, 64].
  inline void push64(uint64_t value, int bits) {
    acc = (acc << bits) | value;
    nbits += bits;
    if (nbits >= 64) {
      const uint64_t v = __builtin_bswap64(uint64_t(acc >> (nbits - 64)));
      std::memcpy(out + bytepos, &v, 8);
      bytepos += 8;
      nbits -= 64;
    }
  }
  // Flush the partial tail (zero-padded low bits); returns end bit pos.
  inline int64_t finish() {
    const int64_t endbits = bytepos * 8 + nbits;
    int rem = nbits;
    while (rem > 0) {
      const int take = rem >= 8 ? 8 : rem;
      out[bytepos++] =
          uint8_t((uint64_t(acc >> (rem - take)) << (8 - take)) & 0xFF);
      rem -= take;
    }
    nbits = 0;
    return endbits;
  }
};

constexpr int kRiceThreshold = 8;

inline int clz32i(int32_t x) {
  // Reference ladder semantics: clz(0) = 40 (AlacFile.cs:190).
  const uint32_t u = uint32_t(x);
  return u == 0 ? 40 : __builtin_clz(u);
}

inline int32_t trunc_div(int32_t a, int32_t b) { return a / b; }  // C++ == C#

// Emit one entropy symbol so entropy_decode_value(rss, k, mask) = raw
// (mirror of AlacFile.cs:193-212 / encoder.py::_emit_value).
inline void emit_value(BitWriter& w, int32_t raw, int rss, int k, int32_t mask) {
  if (k == 1) {
    if (raw <= kRiceThreshold) {
      w.write_unary(raw);
    } else {
      w.write((1u << (kRiceThreshold + 1)) - 1, kRiceThreshold + 1);
      w.write(uint32_t(raw), rss);
    }
    return;
  }
  const int32_t m = int32_t(((1u << k) - 1u)) & mask;
  int64_t q = m > 0 ? raw / m : kRiceThreshold + 1;
  int64_t r = m > 0 ? raw % m : 0;
  if (q > kRiceThreshold) {
    w.write((1u << (kRiceThreshold + 1)) - 1, kRiceThreshold + 1);
    w.write(uint32_t(raw), rss);
    return;
  }
  w.write_unary(int(q));
  if (r == 0) {
    w.write(0, k - 1);
  } else {
    w.write(uint32_t(r + 1), k);
  }
}

inline int64_t zigzag(int64_t x) { return x > 0 ? 2 * x : (x < 0 ? -2 * x - 1 : 0); }

}  // namespace

extern "C" {

// Bulk MSB-first bit packing: fields (vals[i], widths[i]) appended at
// bitpos into a pre-zeroed buffer. Returns the end bit position.
int64_t alac_pack_bits(const uint32_t* vals, const uint8_t* widths,
                       int64_t count, uint8_t* out, int64_t bitpos) {
  BitWriter w(out, bitpos);
  for (int64_t i = 0; i < count; ++i) w.write(vals[i], widths[i]);
  return w.bitpos;
}

// Assemble whole coded frames from the device encoder's symbol planes
// (ops/encode.py rice_symbols) + per-frame ragged header/extra fields.
// Planes: v16 (B,S,2) marker fields, v32 (B,S,2) remainder fields,
// wid (B,S,4) widths in emission order v0,v1,v2,v3; lane f is channel A
// of frame f and lane F+f is channel B (stereo only). Output rows need
// no pre-zeroing (every byte below each frame's end position is stored
// exactly once); returns per-frame end bit positions.
void alac_pack_symbol_frames(
    const uint32_t* hv, const uint8_t* hw, const int64_t* h_off,
    const uint16_t* v16, const uint32_t* v32, const int8_t* wid,
    const int32_t* n, const uint8_t* stereo, int64_t F, int64_t S,
    uint8_t* out, int64_t out_stride, int64_t* end_bits) {
#pragma omp parallel for schedule(dynamic, 8)
  for (int64_t f = 0; f < F; ++f) {
    FastBitWriter w(out + f * out_stride);
    for (int64_t i = h_off[f]; i < h_off[f + 1]; ++i) w.write(hv[i], hw[i]);
    const int64_t nch = stereo[f] ? 2 : 1;
    for (int64_t c = 0; c < nch; ++c) {
      const int64_t lane = f + c * F;
      const uint16_t* pv16 = v16 + lane * S * 2;
      const uint32_t* pv32 = v32 + lane * S * 2;
      const int8_t* pw = wid + lane * S * 4;
      for (int64_t i = 0; i < n[f]; ++i) {
        const int w0 = uint8_t(pw[4 * i]);
        const int w1 = uint8_t(pw[4 * i + 1]);
        const int w2 = uint8_t(pw[4 * i + 2]);
        const int w3 = uint8_t(pw[4 * i + 3]);
        const int total = w0 + w1 + w2 + w3;
        if (total <= 64) {
          // Typical symbol (short unary + k-bit remainder): fold the
          // four fields into ONE accumulator push instead of four
          // mask/shift/store sequences.  Each width <= 32 here, so the
          // uint64 masks are well-defined and the fold fits 64 bits.
          uint64_t v = pv16[2 * i] & ((uint64_t(1) << w0) - 1);
          v = (v << w1) | (pv32[2 * i] & ((uint64_t(1) << w1) - 1));
          v = (v << w2) | (pv16[2 * i + 1] & ((uint64_t(1) << w2) - 1));
          v = (v << w3) | (pv32[2 * i + 1] & ((uint64_t(1) << w3) - 1));
          w.push64(v, total);
        } else {
          w.write(pv16[2 * i], w0);
          w.write(pv32[2 * i], w1);
          w.write(pv16[2 * i + 1], w2);
          w.write(pv32[2 * i + 1], w3);
        }
      }
    }
    end_bits[f] = w.finish();
  }
}

// Rice-encode one channel's residuals (mirror of EntropyRiceDecode's
// state machine, AlacFile.cs:214-252). Returns end bit position.
int64_t alac_rice_encode(const int32_t* vals, int64_t n, int32_t rss,
                         int32_t init_hist, int32_t kmod, int32_t mult,
                         int32_t kmask, uint8_t* out, int64_t bitpos) {
  BitWriter w(out, bitpos);
  int32_t history = init_hist;
  int32_t sign_modifier = 0;
  int64_t i = 0;
  while (i < n) {
    const int64_t dv = zigzag(vals[i]);
    const int64_t raw = dv - sign_modifier;
    const int32_t ik = 31 - kmod - clz32i(int32_t((history >> 9) + 3));
    const int k = ik < 0 ? ik + kmod : kmod;
    emit_value(w, int32_t(raw), rss, k, -1);
    sign_modifier = 0;
    if (dv > 0xFFFF) {
      history = 0xFFFF;
    } else {
      history = int32_t(history + int32_t(dv) * mult - ((history * mult) >> 9));
    }
    if (history < 128 && i + 1 < n) {
      sign_modifier = 1;
      const int kz = clz32i(history) + trunc_div(history + 16, 64) - 24;
      int64_t run = 0;
      while (i + 1 + run < n && vals[i + 1 + run] == 0) ++run;
      if (run > 0xFFFF) run = 0xFFFF;
      emit_value(w, int32_t(run), 16, kz, kmask);
      i += run;
      history = 0;
    }
    ++i;
  }
  return w.bitpos;
}

// Forward adaptive-FIR residuals (mirror of AlacFile.cs:256-336 run in
// lockstep; encoder.py::_predictor_errors). Mutates coefs like the
// decoder will.
void alac_predictor_errors(const int32_t* sig, int64_t n, int32_t* coefs,
                           int32_t order, int32_t quant, int32_t rss,
                           int32_t* errs) {
  if (n == 0) return;
  const int64_t half = int64_t(1) << (rss - 1);
  const int64_t wrap = int64_t(1) << rss;
  auto center = [&](int64_t v) -> int32_t {
    v &= wrap - 1;
    return int32_t(v >= half ? v - wrap : v);
  };
  errs[0] = sig[0];
  if (order == 0) {
    for (int64_t i = 0; i < n; ++i) errs[i] = sig[i];
    return;
  }
  if (order == 31) {
    for (int64_t i = 1; i < n; ++i) errs[i] = center(int64_t(sig[i]) - sig[i - 1]);
    return;
  }
  const int64_t warm = order < n - 1 ? order : (n > 0 ? n - 1 : 0);
  for (int64_t i = 0; i < warm; ++i)
    errs[i + 1] = center(int64_t(sig[i + 1]) - sig[i]);
  int64_t base = 0;
  for (int64_t i = order + 1; i < n; ++i) {
    int32_t total = 0;
    const int32_t b0 = sig[base];
    for (int32_t j = 0; j < order; ++j) {
      total = int32_t(total + int32_t((sig[base + order - j] - b0) * coefs[j]));
    }
    const int32_t pred =
        int32_t((int32_t(1u << ((quant - 1) & 31)) + total)) >> quant;
    const int32_t error_val = center(int64_t(sig[i]) - pred - b0);
    errs[i] = error_val;
    if (error_val > 0) {
      int32_t pn = order - 1;
      int32_t ev = error_val;
      while (pn >= 0 && ev > 0) {
        int32_t val = int32_t(b0 - sig[base + order - pn]);
        const int32_t sgn = (val > 0) - (val < 0);
        coefs[pn] = int32_t(coefs[pn] - sgn);
        val = int32_t(val * sgn);
        ev = int32_t(ev - (val >> quant) * (order - pn));
        --pn;
      }
    } else if (error_val < 0) {
      int32_t pn = order - 1;
      int32_t ev = error_val;
      while (pn >= 0 && ev < 0) {
        int32_t val = int32_t(b0 - sig[base + order - pn]);
        const int32_t sgn = -((val > 0) - (val < 0));
        coefs[pn] = int32_t(coefs[pn] - sgn);
        val = int32_t(val * sgn);
        ev = int32_t(ev - (val >> quant) * (order - pn));
        --pn;
      }
    }
    ++base;
  }
}

}  // extern "C"

namespace {

// One-pass Levinson-window decorrelation (encoder prep).  Replaces the
// ~6 NumPy passes in codec/encoder_tpu._prep's window block (astype,
// sub, mul/shift/add, 2x where, 2x copyto) with a single read of the
// PCM window and a single write of the (2F, w) signal matrix.
// WideT = int64 when products may pass 2^31 (24-bit no-extra-bits
// content), int32 otherwise — matching the NumPy work_dtype exactly
// (int32 arithmetic wraps; -fwrapv makes that defined here).
template <typename WideT>
void decorr_window_impl(const int32_t* pcm, int64_t F, int64_t S,
                        int64_t w, int ub8, int32_t lw, int32_t sh,
                        const uint8_t* stereo, int32_t* sig) {
#pragma omp parallel for schedule(static)
  for (int64_t f = 0; f < F; ++f) {
    const int32_t* p = pcm + f * S * 2;
    int32_t* sa = sig + f * w;
    int32_t* sb = sig + (F + f) * w;
    if (!stereo[f]) {
      for (int64_t i = 0; i < w; ++i) {
        sa[i] = int32_t(WideT(p[2 * i] >> ub8));
        sb[i] = 0;
      }
      continue;
    }
    if (lw == 0) {
      for (int64_t i = 0; i < w; ++i) {
        sa[i] = int32_t(WideT(p[2 * i] >> ub8));
        sb[i] = int32_t(WideT(p[2 * i + 1] >> ub8));
      }
      continue;
    }
    for (int64_t i = 0; i < w; ++i) {
      const WideT h0 = WideT(p[2 * i] >> ub8);
      const WideT h1 = WideT(p[2 * i + 1] >> ub8);
      const WideT cb = WideT(h0 - h1);
      const WideT ca = WideT(h1 + ((cb * lw) >> sh));
      sa[i] = int32_t(ca);
      sb[i] = int32_t(cb);
    }
  }
}

}  // namespace

extern "C" {

// See decorr_window_impl; `wide` selects the int64 work type.
void alac_decorr_window(const int32_t* pcm, int64_t F, int64_t S,
                        int64_t w, int32_t ub8, int32_t lw, int32_t sh,
                        const uint8_t* stereo, int32_t wide,
                        int32_t* sig) {
  if (wide) decorr_window_impl<int64_t>(pcm, F, S, w, ub8, lw, sh, stereo, sig);
  else decorr_window_impl<int32_t>(pcm, F, S, w, ub8, lw, sh, stereo, sig);
}

}  // extern "C"

extern "C" {

// Assemble coded frames from device-merged 96-bit sample chunks
// (ops/encode.merge_symbol_chunks): per channel-sample ONE right-aligned
// multi-word field (c0:c1:c2 low `ws` bits) instead of four separate
// fields — the serial per-field bookkeeping is the encode pipeline's
// host bottleneck on a single-core box.  `extra` is an optional
// per-sample extra-bits plane written between the header and the
// entropy body (width extra_w[f] bits per sample; 0 = no plane).
// Chunk values arrive pre-masked (bits above ws are zero), so the
// writer skips the per-call mask.
void alac_pack_chunk_frames(
    const uint32_t* hv, const uint8_t* hw, const int64_t* h_off,
    const uint32_t* extra, const uint8_t* extra_w,
    const uint32_t* c0, const uint32_t* c1, const uint32_t* c2,
    const int8_t* ws, const int32_t* n, const uint8_t* stereo,
    int64_t F, int64_t S,
    uint8_t* out, int64_t out_stride, int64_t* end_bits) {
#pragma omp parallel for schedule(dynamic, 8)
  for (int64_t f = 0; f < F; ++f) {
    FastBitWriter w(out + f * out_stride);
    for (int64_t i = h_off[f]; i < h_off[f + 1]; ++i) w.write(hv[i], hw[i]);
    const int64_t nf = n[f];
    if (extra_w != nullptr && extra_w[f] != 0) {
      const int eb = extra_w[f];
      const uint32_t* pe = extra + f * S;
      const uint32_t em = eb >= 32 ? 0xFFFFFFFFu : ((1u << eb) - 1u);
      int64_t i = 0;
      if (eb <= 16) {
        // Equal-width plane: fold four fields per accumulator push.
        for (; i + 3 < nf; i += 4) {
          uint64_t v = pe[i] & em;
          v = (v << eb) | (pe[i + 1] & em);
          v = (v << eb) | (pe[i + 2] & em);
          v = (v << eb) | (pe[i + 3] & em);
          w.push64(v, 4 * eb);
        }
      }
      for (; i < nf; ++i) w.write(pe[i], eb);
    }
    const int64_t nch = stereo[f] ? 2 : 1;
    for (int64_t c = 0; c < nch; ++c) {
      const int64_t lane = f + c * F;
      const uint32_t* p0 = c0 + lane * S;
      const uint32_t* p1 = c1 + lane * S;
      const uint32_t* p2 = c2 + lane * S;
      const int8_t* pw = ws + lane * S;
      // Quad/single combine ladder: pre-fold four neighbouring
      // samples into one accumulator push when their widths fit 64
      // bits.  The folds are independent of the accumulator chain, so
      // the CPU overlaps them; the serial chain shrinks to one
      // push64 per 4 (typ.) samples — measured 2x over the per-sample
      // ladder on real planes (DESIGN.md §7).  The miss path MUST
      // stay a simple inline field-by-field ladder: both a pair-fold
      // fallback and an out-of-line helper (which forces the writer
      // state to spill to memory every iteration) each cost 2x on the
      // hot path, measured at a 0.1% miss rate (same section).  The
      // <= 63 sub-guards keep the intra-fold shift amounts defined
      // even for degenerate zero-width symbols (can't occur in
      // conforming streams, but the packer is property-tested on
      // adversarial planes).
      int64_t i = 0;
      for (; i + 3 < nf; i += 4) {
        const int b0 = pw[i], b1 = pw[i + 1], b2 = pw[i + 2], b3 = pw[i + 3];
        const int b01 = b0 + b1, b23 = b2 + b3;
        if (b01 + b23 <= 64 && b1 <= 63 && b3 <= 63 && b23 <= 63) {
          const uint64_t v0 = (uint64_t(p1[i]) << 32) | p2[i];
          const uint64_t v1 = (uint64_t(p1[i + 1]) << 32) | p2[i + 1];
          const uint64_t v2 = (uint64_t(p1[i + 2]) << 32) | p2[i + 2];
          const uint64_t v3 = (uint64_t(p1[i + 3]) << 32) | p2[i + 3];
          w.push64(((v0 << b1) | v1) << b23 | (v2 << b3) | v3, b01 + b23);
          continue;
        }
        for (int t = 0; t < 4; ++t) {
          const int bits = pw[i + t];
          const uint64_t lo = (uint64_t(p1[i + t]) << 32) | p2[i + t];
          if (bits <= 64) w.push64(lo, bits);
          else { w.push64(p0[i + t], bits - 64); w.push64(lo, 64); }
        }
      }
      for (; i < nf; ++i) {
        const int bits = pw[i];
        const uint64_t lo = (uint64_t(p1[i]) << 32) | p2[i];
        if (bits <= 64) w.push64(lo, bits);
        else { w.push64(p0[i], bits - 64); w.push64(lo, 64); }
      }
    }
    end_bits[f] = w.finish();
  }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Pair-plane frame packer (round 3): the device merges ADJACENT samples'
// chunks into one <=96-bit field (ops/encode.merge_pair_chunks), halving
// both the host's per-field bookkeeping and the plane D2H.  Two frames
// are packed per loop iteration with independent writers so their
// accumulator dependency chains overlap (measured ~2x over the
// single-writer per-sample chunk loop on the 1-core bench host; see
// DESIGN.md §7).  Precondition: pws values are in [-1, 96].  -1 is a
// LEGAL no-op width: the field is skipped and emits ZERO bits — the
// quad caller (codec/encoder_tpu, ALAC_ENC_QUAD) intentionally hands
// planes where quad-FAT frames' lanes carry -1 widths (their rows
// come out garbage and are repacked from pair rows afterwards), so
// the `bits_ > 0` / `(b0_|b1_) >= 0` guards in ALAC_PAIR1/ALAC_PAIR2
// below are load-bearing for it, not just defensive.  What callers must never pass
// is a WIDE field (> 96 bits): merge_pair_chunks marks such pairs -1
// and sets the batch's `fat` flag, and codec/encoder_tpu._pack routes
// fat batches to the classic chunk path instead.
// ---------------------------------------------------------------------------

namespace {

// One pair field: value right-aligned in the low `bits` of ph:pm:pl.
#define ALAC_PAIR1(W, ph_, pm_, pl_, pw_, j)                                 \
  {                                                                          \
    const int bits_ = pw_[j];                                                \
    const uint64_t lo_ = (uint64_t(pm_[j]) << 32) | pl_[j];                  \
    if (bits_ > 64) { W.push64(ph_[j], bits_ - 64); W.push64(lo_, 64); }     \
    else if (bits_ > 0) W.push64(lo_, bits_);                                \
  }

// Two pair fields folded into one accumulator push when they fit 64
// bits (the common case: two pairs = four ~8-bit symbols).
#define ALAC_PAIR2(W, ph_, pm_, pl_, pw_, j)                                 \
  {                                                                          \
    const int b0_ = pw_[j], b1_ = pw_[j + 1];                                \
    if ((b0_ | b1_) >= 0 && b0_ + b1_ <= 64 && b1_ <= 63) {                  \
      const uint64_t v0_ = (uint64_t(pm_[j]) << 32) | pl_[j];                \
      const uint64_t v1_ = (uint64_t(pm_[j + 1]) << 32) | pl_[j + 1];        \
      W.push64((v0_ << b1_) | v1_, b0_ + b1_);                               \
    } else {                                                                 \
      ALAC_PAIR1(W, ph_, pm_, pl_, pw_, j)                                   \
      ALAC_PAIR1(W, ph_, pm_, pl_, pw_, j + 1)                               \
    }                                                                        \
  }

// Frame prefix: ragged header fields + optional equal-width extra-bits
// plane (same fold as alac_pack_chunk_frames' extra section).
inline void pair_prefix(FastBitWriter& w, const uint32_t* hv,
                        const uint8_t* hw, int64_t lo, int64_t hi,
                        const uint32_t* pe, int eb, int64_t nf) {
  for (int64_t i = lo; i < hi; ++i) w.write(hv[i], hw[i]);
  if (eb != 0 && pe != nullptr) {
    const uint32_t em = eb >= 32 ? 0xFFFFFFFFu : ((1u << eb) - 1u);
    int64_t i = 0;
    if (eb <= 16) {
      for (; i + 3 < nf; i += 4) {
        uint64_t v = pe[i] & em;
        v = (v << eb) | (pe[i + 1] & em);
        v = (v << eb) | (pe[i + 2] & em);
        v = (v << eb) | (pe[i + 3] & em);
        w.push64(v, 4 * eb);
      }
    }
    for (; i < nf; ++i) w.write(pe[i], eb);
  }
}

}  // namespace

extern "C" {

// Pair planes: ph/pm/pl (2F, NP) uint32, pws (2F, NP) int8; lane f is
// channel A of frame f, lane F+f channel B.  NP = ceil(S/2) pairs.
void alac_pack_pair_frames(
    const uint32_t* hv, const uint8_t* hw, const int64_t* h_off,
    const uint32_t* extra, const uint8_t* extra_w,
    const uint32_t* ph, const uint32_t* pm, const uint32_t* pl,
    const int8_t* pws, const int32_t* n, const uint8_t* stereo,
    int64_t F, int64_t S, int64_t NP,
    uint8_t* out, int64_t out_stride, int64_t* end_bits) {
  const int64_t half = (F + 1) / 2;
#pragma omp parallel for schedule(dynamic, 8)
  for (int64_t fp = 0; fp < half; ++fp) {
    const int64_t f = 2 * fp, g = f + 1;
    if (g < F && n[f] == n[g] && stereo[f] == stereo[g]) {
      // Interleaved two-frame path: both writers advance in lockstep,
      // overlapping their serial accumulator chains.
      FastBitWriter wa(out + f * out_stride);
      FastBitWriter wb(out + g * out_stride);
      const int ea = extra_w != nullptr ? extra_w[f] : 0;
      const int eg = extra_w != nullptr ? extra_w[g] : 0;
      pair_prefix(wa, hv, hw, h_off[f], h_off[f + 1],
                  extra != nullptr ? extra + f * S : nullptr, ea, n[f]);
      pair_prefix(wb, hv, hw, h_off[g], h_off[g + 1],
                  extra != nullptr ? extra + g * S : nullptr, eg, n[g]);
      const int64_t np = (n[f] + 1) / 2;
      const int64_t nch = stereo[f] ? 2 : 1;
      for (int64_t c = 0; c < nch; ++c) {
        const int64_t la = (f + c * F) * NP, lb = (g + c * F) * NP;
        const uint32_t* pha = ph + la; const uint32_t* phb = ph + lb;
        const uint32_t* pma = pm + la; const uint32_t* pmb = pm + lb;
        const uint32_t* pla = pl + la; const uint32_t* plb = pl + lb;
        const int8_t* pwa = pws + la; const int8_t* pwb = pws + lb;
        int64_t j = 0;
        for (; j + 1 < np; j += 2) {
          ALAC_PAIR2(wa, pha, pma, pla, pwa, j)
          ALAC_PAIR2(wb, phb, pmb, plb, pwb, j)
        }
        for (; j < np; ++j) {
          ALAC_PAIR1(wa, pha, pma, pla, pwa, j)
          ALAC_PAIR1(wb, phb, pmb, plb, pwb, j)
        }
      }
      end_bits[f] = wa.finish();
      end_bits[g] = wb.finish();
      continue;
    }
    for (int64_t ff = f; ff < F && ff <= g; ++ff) {
      FastBitWriter w(out + ff * out_stride);
      const int eb = extra_w != nullptr ? extra_w[ff] : 0;
      pair_prefix(w, hv, hw, h_off[ff], h_off[ff + 1],
                  extra != nullptr ? extra + ff * S : nullptr, eb, n[ff]);
      const int64_t np = (n[ff] + 1) / 2;
      const int64_t nch = stereo[ff] ? 2 : 1;
      for (int64_t c = 0; c < nch; ++c) {
        const int64_t l0 = (ff + c * F) * NP;
        const uint32_t* ph_ = ph + l0;
        const uint32_t* pm_ = pm + l0;
        const uint32_t* pl_ = pl + l0;
        const int8_t* pw_ = pws + l0;
        int64_t j = 0;
        for (; j + 1 < np; j += 2) ALAC_PAIR2(w, ph_, pm_, pl_, pw_, j)
        for (; j < np; ++j) ALAC_PAIR1(w, ph_, pm_, pl_, pw_, j)
      }
      end_bits[ff] = w.finish();
    }
  }
}

// Four-frame interleaved variant (A/B experiment): same ABI as
// alac_pack_pair_frames, but groups of FOUR equal-shape frames advance
// four independent FastBitWriter accumulator chains in lockstep.  The
// two-frame interleave measured ~2x over one writer (the chain is the
// bottleneck, DESIGN.md §7); four chains probe whether the core still
// has issue slots left or register pressure (4 x 128-bit accumulators)
// eats the win.  Selected via ALAC_ENC_PAIR_ILV=4 (codec/encoder_tpu);
// groups with mixed n/stereo fall back to frame-at-a-time, so the
// output is byte-identical to the two-frame packer on every input.
void alac_pack_pair_frames4(
    const uint32_t* hv, const uint8_t* hw, const int64_t* h_off,
    const uint32_t* extra, const uint8_t* extra_w,
    const uint32_t* ph, const uint32_t* pm, const uint32_t* pl,
    const int8_t* pws, const int32_t* n, const uint8_t* stereo,
    int64_t F, int64_t S, int64_t NP,
    uint8_t* out, int64_t out_stride, int64_t* end_bits) {
  const int64_t groups = (F + 3) / 4;
#pragma omp parallel for schedule(dynamic, 4)
  for (int64_t gp = 0; gp < groups; ++gp) {
    const int64_t f0 = 4 * gp;
    bool lock = f0 + 3 < F;
    for (int64_t t = 1; t < 4 && lock; ++t)
      lock = n[f0 + t] == n[f0] && stereo[f0 + t] == stereo[f0];
    if (lock) {
      FastBitWriter w0(out + (f0 + 0) * out_stride);
      FastBitWriter w1(out + (f0 + 1) * out_stride);
      FastBitWriter w2(out + (f0 + 2) * out_stride);
      FastBitWriter w3(out + (f0 + 3) * out_stride);
      FastBitWriter* ws4[4] = {&w0, &w1, &w2, &w3};
      for (int t = 0; t < 4; ++t) {
        const int64_t ff = f0 + t;
        const int eb = extra_w != nullptr ? extra_w[ff] : 0;
        pair_prefix(*ws4[t], hv, hw, h_off[ff], h_off[ff + 1],
                    extra != nullptr ? extra + ff * S : nullptr, eb, n[ff]);
      }
      const int64_t np = (n[f0] + 1) / 2;
      const int64_t nch = stereo[f0] ? 2 : 1;
      for (int64_t c = 0; c < nch; ++c) {
        const int64_t l0 = (f0 + 0 + c * F) * NP;
        const int64_t l1 = (f0 + 1 + c * F) * NP;
        const int64_t l2 = (f0 + 2 + c * F) * NP;
        const int64_t l3 = (f0 + 3 + c * F) * NP;
        const uint32_t *ph0 = ph + l0, *pm0 = pm + l0, *pl0 = pl + l0;
        const uint32_t *ph1 = ph + l1, *pm1 = pm + l1, *pl1 = pl + l1;
        const uint32_t *ph2 = ph + l2, *pm2 = pm + l2, *pl2 = pl + l2;
        const uint32_t *ph3 = ph + l3, *pm3 = pm + l3, *pl3 = pl + l3;
        const int8_t *pw0 = pws + l0, *pw1 = pws + l1;
        const int8_t *pw2 = pws + l2, *pw3 = pws + l3;
        int64_t j = 0;
        for (; j + 1 < np; j += 2) {
          ALAC_PAIR2(w0, ph0, pm0, pl0, pw0, j)
          ALAC_PAIR2(w1, ph1, pm1, pl1, pw1, j)
          ALAC_PAIR2(w2, ph2, pm2, pl2, pw2, j)
          ALAC_PAIR2(w3, ph3, pm3, pl3, pw3, j)
        }
        for (; j < np; ++j) {
          ALAC_PAIR1(w0, ph0, pm0, pl0, pw0, j)
          ALAC_PAIR1(w1, ph1, pm1, pl1, pw1, j)
          ALAC_PAIR1(w2, ph2, pm2, pl2, pw2, j)
          ALAC_PAIR1(w3, ph3, pm3, pl3, pw3, j)
        }
      }
      for (int t = 0; t < 4; ++t) end_bits[f0 + t] = ws4[t]->finish();
      continue;
    }
    for (int64_t ff = f0; ff < F && ff < f0 + 4; ++ff) {
      FastBitWriter w(out + ff * out_stride);
      const int eb = extra_w != nullptr ? extra_w[ff] : 0;
      pair_prefix(w, hv, hw, h_off[ff], h_off[ff + 1],
                  extra != nullptr ? extra + ff * S : nullptr, eb, n[ff]);
      const int64_t np = (n[ff] + 1) / 2;
      const int64_t nch = stereo[ff] ? 2 : 1;
      for (int64_t c = 0; c < nch; ++c) {
        const int64_t l0 = (ff + c * F) * NP;
        const uint32_t* ph_ = ph + l0;
        const uint32_t* pm_ = pm + l0;
        const uint32_t* pl_ = pl + l0;
        const int8_t* pw_ = pws + l0;
        int64_t j = 0;
        for (; j + 1 < np; j += 2) ALAC_PAIR2(w, ph_, pm_, pl_, pw_, j)
        for (; j < np; ++j) ALAC_PAIR1(w, ph_, pm_, pl_, pw_, j)
      }
      end_bits[ff] = w.finish();
    }
  }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Eight-frame AVX-512 pair packer (round 5).  The scalar packers above
// are ACCUMULATOR-CHAIN bound: every pair field passes through one
// serial 128-bit shift-or chain per frame, and interleaving 2 (win) or
// 4 (loss, §7e) chains is the only parallelism a scalar core offers.
// AVX-512 changes the game: VBMI2's per-lane funnel shifts (VPSHLDVQ /
// VPSHRDVQ) run EIGHT independent 128-bit writer accumulators in two
// ZMM registers, so eight equal-shape frames advance in lockstep —
// loads vectorize via an 8x8 u32 transpose of the pair planes, pushes
// are one funnel + shift + OR, and the 64-bit flush scatters eight
// big-endian words to the frames' rows (VPSCATTERQQ) behind a mask of
// lanes whose pending count crossed 64.
//
// Byte-identical to alac_pack_pair_frames on every input: the flush
// emits exactly the scalar writer's bits [nbits-64, nbits) window, a
// -1 width is the same legal skip (masked to a zero-width push), and
// >64-bit fields take a two-push column (ph then pm:pl), so there is
// no semantic fork — groups that cannot lockstep (mixed n/stereo,
// tail < 8) fall back to the scalar frame-at-a-time path.
// Selected via ALAC_ENC_PAIR_ILV=8; compiled only where AVX-512
// F+BW+VBMI2 exist (the function always exists and delegates to the
// two-frame packer elsewhere, so callers never need a CPU probe).
// ---------------------------------------------------------------------------

#if defined(__AVX512F__) && defined(__AVX512BW__) && defined(__AVX512VBMI2__)
#define ALAC_AVX512_PACK 1
#include <immintrin.h>

namespace {

// (hi:lo) <<= w per lane, then OR v into the low bits; w in [0, 64].
// VPSHLDVQ shifts mod 64, so the w == 64 case (where the new high half
// is exactly the old lo) is blended explicitly.
static inline void simd_push(__m512i& hi, __m512i& lo, __m512i& nb,
                             __m512i v, __m512i w) {
  const __m512i c64 = _mm512_set1_epi64(64);
  const __m512i hi_s = _mm512_shldv_epi64(hi, lo, w);
  const __mmask8 is64 = _mm512_cmpeq_epi64_mask(w, c64);
  hi = _mm512_mask_blend_epi64(is64, hi_s, lo);
  lo = _mm512_or_si512(_mm512_sllv_epi64(lo, w), v);
  nb = _mm512_add_epi64(nb, w);
}

// Flush lanes whose pending count reached 64: emit the scalar writer's
// exact window (hi:lo) >> (nb-64) as a big-endian qword at each lane's
// cursor.  hi/lo keep their bits — anything at or above the live count
// is dead by construction (never enters a later window).
static inline void simd_flush(uint8_t* out, __m512i& hi, __m512i& lo,
                              __m512i& nb, __m512i& addr,
                              const __m512i bswap64) {
  const __m512i c64 = _mm512_set1_epi64(64);
  const __mmask8 m = _mm512_cmp_epi64_mask(nb, c64, _MM_CMPINT_NLT);
  if (!m) return;
  const __m512i sh = _mm512_sub_epi64(nb, c64);  // [0, 63] where m
  __m512i word = _mm512_shrdv_epi64(lo, hi, sh);
  word = _mm512_shuffle_epi8(word, bswap64);
  _mm512_mask_i64scatter_epi64(out, m, addr, word, 1);
  addr = _mm512_mask_add_epi64(addr, m, addr, _mm512_set1_epi64(8));
  nb = _mm512_mask_sub_epi64(nb, m, nb, c64);
}

// 16x16 u32 butterfly transpose.  Fed the 8 lanes' pl rows at even
// inputs and pm rows at odd ones, each OUTPUT register is directly the
// column's 8x u64 value vector ((pm << 32) | pl per lane, little-
// endian u32 pairing) — 4 shuffles per column and no per-column
// widen/shift/or at all.
static inline void tr16x16_u32(const __m512i in[16], __m512i out[16]) {
  __m512i a[16], b[16];
  for (int i = 0; i < 8; ++i) {
    a[2 * i] = _mm512_unpacklo_epi32(in[2 * i], in[2 * i + 1]);
    a[2 * i + 1] = _mm512_unpackhi_epi32(in[2 * i], in[2 * i + 1]);
  }
  for (int i = 0; i < 4; ++i) {
    b[4 * i] = _mm512_unpacklo_epi64(a[4 * i], a[4 * i + 2]);
    b[4 * i + 1] = _mm512_unpackhi_epi64(a[4 * i], a[4 * i + 2]);
    b[4 * i + 2] = _mm512_unpacklo_epi64(a[4 * i + 1], a[4 * i + 3]);
    b[4 * i + 3] = _mm512_unpackhi_epi64(a[4 * i + 1], a[4 * i + 3]);
  }
  for (int i = 0; i < 4; ++i) {
    a[i] = _mm512_shuffle_i32x4(b[i], b[i + 4], 0x88);
    a[i + 4] = _mm512_shuffle_i32x4(b[i], b[i + 4], 0xDD);
    a[i + 8] = _mm512_shuffle_i32x4(b[i + 8], b[i + 12], 0x88);
    a[i + 12] = _mm512_shuffle_i32x4(b[i + 8], b[i + 12], 0xDD);
  }
  for (int i = 0; i < 8; ++i) {
    out[i] = _mm512_shuffle_i32x4(a[i], a[i + 8], 0x88);
    out[i + 8] = _mm512_shuffle_i32x4(a[i], a[i + 8], 0xDD);
  }
}

// One pair column across 8 lanes: v = (pm:pl) 64-bit values, w raw
// widths (may be -1 = skip, or > 64 = wide, taking the two-push form
// with the ph column supplied by the caller).
static inline void simd_column(uint8_t* out, __m512i& hi, __m512i& lo,
                               __m512i& nb, __m512i& addr,
                               const __m512i bswap64, __m512i v,
                               __m512i w, int maxw,
                               const uint32_t* const* ph_rows, int64_t j) {
  const __m512i zero = _mm512_setzero_si512();
  const __m512i c64 = _mm512_set1_epi64(64);
  if (__builtin_expect(maxw > 64, 0)) {
    alignas(32) uint32_t pht[8];
    for (int l = 0; l < 8; ++l) pht[l] = ph_rows[l][j];
    const __m512i w1 = _mm512_max_epi64(_mm512_sub_epi64(w, c64), zero);
    __m512i v1 = _mm512_cvtepu32_epi64(
        _mm256_load_si256((const __m256i*)pht));
    v1 = _mm512_maskz_mov_epi64(_mm512_cmpgt_epi64_mask(w1, zero), v1);
    simd_push(hi, lo, nb, v1, w1);
    simd_flush(out, hi, lo, nb, addr, bswap64);
    w = _mm512_min_epi64(_mm512_max_epi64(w, zero), c64);
  } else {
    const __mmask8 kz = _mm512_cmpgt_epi64_mask(w, zero);
    v = _mm512_maskz_mov_epi64(kz, v);
    w = _mm512_max_epi64(w, zero);
  }
  simd_push(hi, lo, nb, v, w);
  simd_flush(out, hi, lo, nb, addr, bswap64);
}

// 16x8 int8 transpose (widths): out[k] = {rows[0][j0+k], ...,
// rows[7][j0+k]}.  Done per 16-column block so the column loop loads
// each 8-lane width vector with ONE 8-byte load — the per-column
// scalar gather/stack form costs a blocked-store-forward stall every
// column (8 byte stores immediately reloaded as one qword).
static inline void byte_tr16x8(const int8_t* const* rows, int64_t j0,
                               int8_t out16x8[16][8], bool* anywide) {
  __m128i r[8];
  __m128i wide = _mm_setzero_si128();
  const __m128i c64 = _mm_set1_epi8(64);
  for (int l = 0; l < 8; ++l) {
    r[l] = _mm_loadu_si128((const __m128i*)(rows[l] + j0));
    wide = _mm_or_si128(wide, _mm_cmpgt_epi8(r[l], c64));
  }
  *anywide = _mm_movemask_epi8(wide) != 0;
  const __m128i a0 = _mm_unpacklo_epi8(r[0], r[1]);
  const __m128i a1 = _mm_unpackhi_epi8(r[0], r[1]);
  const __m128i a2 = _mm_unpacklo_epi8(r[2], r[3]);
  const __m128i a3 = _mm_unpackhi_epi8(r[2], r[3]);
  const __m128i a4 = _mm_unpacklo_epi8(r[4], r[5]);
  const __m128i a5 = _mm_unpackhi_epi8(r[4], r[5]);
  const __m128i a6 = _mm_unpacklo_epi8(r[6], r[7]);
  const __m128i a7 = _mm_unpackhi_epi8(r[6], r[7]);
  const __m128i b0 = _mm_unpacklo_epi16(a0, a2);
  const __m128i b1 = _mm_unpackhi_epi16(a0, a2);
  const __m128i b2 = _mm_unpacklo_epi16(a1, a3);
  const __m128i b3 = _mm_unpackhi_epi16(a1, a3);
  const __m128i b4 = _mm_unpacklo_epi16(a4, a6);
  const __m128i b5 = _mm_unpackhi_epi16(a4, a6);
  const __m128i b6 = _mm_unpacklo_epi16(a5, a7);
  const __m128i b7 = _mm_unpackhi_epi16(a5, a7);
  _mm_store_si128((__m128i*)out16x8[0], _mm_unpacklo_epi32(b0, b4));
  _mm_store_si128((__m128i*)out16x8[2], _mm_unpackhi_epi32(b0, b4));
  _mm_store_si128((__m128i*)out16x8[4], _mm_unpacklo_epi32(b1, b5));
  _mm_store_si128((__m128i*)out16x8[6], _mm_unpackhi_epi32(b1, b5));
  _mm_store_si128((__m128i*)out16x8[8], _mm_unpacklo_epi32(b2, b6));
  _mm_store_si128((__m128i*)out16x8[10], _mm_unpackhi_epi32(b2, b6));
  _mm_store_si128((__m128i*)out16x8[12], _mm_unpacklo_epi32(b3, b7));
  _mm_store_si128((__m128i*)out16x8[14], _mm_unpackhi_epi32(b3, b7));
}

}  // namespace
#endif  // ALAC_AVX512_PACK

extern "C" {

// 8 when this binary carries the AVX-512 eight-frame pair packer, else
// 2 (alac_pack_pair_frames8 then delegates to the two-frame kernel).
int64_t alac_pack_simd_width() {
#ifdef ALAC_AVX512_PACK
  return 8;
#else
  return 2;
#endif
}

void alac_pack_pair_frames8(
    const uint32_t* hv, const uint8_t* hw, const int64_t* h_off,
    const uint32_t* extra, const uint8_t* extra_w,
    const uint32_t* ph, const uint32_t* pm, const uint32_t* pl,
    const int8_t* pws, const int32_t* n, const uint8_t* stereo,
    int64_t F, int64_t S, int64_t NP,
    uint8_t* out, int64_t out_stride, int64_t* end_bits) {
#ifndef ALAC_AVX512_PACK
  alac_pack_pair_frames(hv, hw, h_off, extra, extra_w, ph, pm, pl, pws,
                        n, stereo, F, S, NP, out, out_stride, end_bits);
#else
  const __m512i bswap64 = _mm512_broadcast_i32x4(
      _mm_setr_epi8(7, 6, 5, 4, 3, 2, 1, 0, 15, 14, 13, 12, 11, 10, 9, 8));
  const int64_t groups = (F + 7) / 8;
#pragma omp parallel for schedule(dynamic, 2)
  for (int64_t gp = 0; gp < groups; ++gp) {
    const int64_t f0 = 8 * gp;
    bool lock = f0 + 7 < F;
    for (int64_t t = 1; t < 8 && lock; ++t)
      lock = n[f0 + t] == n[f0] && stereo[f0 + t] == stereo[f0];
    if (lock) {
      // Scalar ragged prefix per lane (headers + optional extra-bits
      // plane), then hand each writer's exact state — 128-bit pending
      // accumulator, pending count, byte cursor — to the SIMD lanes.
      alignas(64) uint64_t hi8[8], lo8[8];
      alignas(64) int64_t nb8[8], ad8[8];
      for (int t = 0; t < 8; ++t) {
        const int64_t ff = f0 + t;
        FastBitWriter w(out + ff * out_stride);
        const int eb = extra_w != nullptr ? extra_w[ff] : 0;
        pair_prefix(w, hv, hw, h_off[ff], h_off[ff + 1],
                    extra != nullptr ? extra + ff * S : nullptr, eb, n[ff]);
        hi8[t] = uint64_t(w.acc >> 64);
        lo8[t] = uint64_t(w.acc);
        nb8[t] = w.nbits;
        ad8[t] = ff * out_stride + w.bytepos;
      }
      __m512i hi = _mm512_load_si512(hi8);
      __m512i lo = _mm512_load_si512(lo8);
      __m512i nb = _mm512_load_si512(nb8);
      __m512i addr = _mm512_load_si512(ad8);
      const int64_t np = (n[f0] + 1) / 2;
      const int64_t nch = stereo[f0] ? 2 : 1;
      for (int64_t c = 0; c < nch; ++c) {
        const uint32_t* phr[8];
        const uint32_t* pmr[8];
        const uint32_t* plr[8];
        const int8_t* pwr[8];
        for (int l = 0; l < 8; ++l) {
          const int64_t base = (f0 + l + c * F) * NP;
          phr[l] = ph + base;
          pmr[l] = pm + base;
          plr[l] = pl + base;
          pwr[l] = pws + base;
        }
        int64_t j0 = 0;
        __m512i vin[16], vcols[16];
        alignas(16) int8_t wbuf[16][8];
        const __m512i zero = _mm512_setzero_si512();
        const __m512i c64v = _mm512_set1_epi64(64);
        for (; j0 + 16 <= np; j0 += 16) {
          for (int l = 0; l < 8; ++l) {
            vin[2 * l] = _mm512_loadu_si512(
                (const void*)(plr[l] + j0));
            vin[2 * l + 1] = _mm512_loadu_si512(
                (const void*)(pmr[l] + j0));
          }
          tr16x16_u32(vin, vcols);
          bool anywide;
          byte_tr16x8(pwr, j0, wbuf, &anywide);
          if (__builtin_expect(anywide, 0)) {
            // Rare escape-dense block: per-column wide-capable form.
            for (int k = 0; k < 16; ++k) {
              int maxw = -1;
              for (int l = 0; l < 8; ++l)
                if (wbuf[k][l] > maxw) maxw = wbuf[k][l];
              const __m512i w = _mm512_cvtepi8_epi64(
                  _mm_loadl_epi64((const __m128i*)wbuf[k]));
              simd_column(out, hi, lo, nb, addr, bswap64, vcols[k], w,
                          maxw, phr, j0 + k);
            }
            continue;
          }
          for (int k = 0; k < 16; k += 2) {
            // Column pair: the SIMD analog of ALAC_PAIR2 — when every
            // lane's two pair fields fit 64 bits together, fold them
            // into ONE push (halves the flush checks on the serial
            // accumulator state; typical music pairs are ~20-28 bits).
            __m512i w0 = _mm512_cvtepi8_epi64(
                _mm_loadl_epi64((const __m128i*)wbuf[k]));
            __m512i w1 = _mm512_cvtepi8_epi64(
                _mm_loadl_epi64((const __m128i*)wbuf[k + 1]));
            __m512i v0 = _mm512_maskz_mov_epi64(
                _mm512_cmpgt_epi64_mask(w0, zero), vcols[k]);
            __m512i v1 = _mm512_maskz_mov_epi64(
                _mm512_cmpgt_epi64_mask(w1, zero), vcols[k + 1]);
            w0 = _mm512_max_epi64(w0, zero);
            w1 = _mm512_max_epi64(w1, zero);
            const __m512i ws = _mm512_add_epi64(w0, w1);
            if (__builtin_expect(
                    _mm512_cmp_epi64_mask(ws, c64v, _MM_CMPINT_LE) == 0xFF,
                    1)) {
              // w1 == 64 forces w0 == 0 (sum <= 64), so the fold's
              // sllv-by-64 -> 0 plus OR v1 is exact there too.
              const __m512i v = _mm512_or_si512(
                  _mm512_sllv_epi64(v0, w1), v1);
              simd_push(hi, lo, nb, v, ws);
              simd_flush(out, hi, lo, nb, addr, bswap64);
            } else {
              simd_push(hi, lo, nb, v0, w0);
              simd_flush(out, hi, lo, nb, addr, bswap64);
              simd_push(hi, lo, nb, v1, w1);
              simd_flush(out, hi, lo, nb, addr, bswap64);
            }
          }
        }
        for (; j0 < np; ++j0) {  // tail columns: strided scalar loads
          alignas(16) int8_t wt[8];
          alignas(32) uint32_t pmt[8], plt[8];
          int maxw = -1;
          for (int l = 0; l < 8; ++l) {
            wt[l] = pwr[l][j0];
            pmt[l] = pmr[l][j0];
            plt[l] = plr[l][j0];
            if (wt[l] > maxw) maxw = wt[l];
          }
          const __m512i w = _mm512_cvtepi8_epi64(
              _mm_loadl_epi64((const __m128i*)wt));
          const __m512i v = _mm512_or_si512(
              _mm512_slli_epi64(
                  _mm512_cvtepu32_epi64(_mm256_load_si256((__m256i*)pmt)),
                  32),
              _mm512_cvtepu32_epi64(_mm256_load_si256((__m256i*)plt)));
          simd_column(out, hi, lo, nb, addr, bswap64, v, w, maxw, phr, j0);
        }
      }
      _mm512_store_si512(hi8, hi);
      _mm512_store_si512(lo8, lo);
      _mm512_store_si512(nb8, nb);
      _mm512_store_si512(ad8, addr);
      for (int t = 0; t < 8; ++t) {
        const int64_t ff = f0 + t;
        FastBitWriter w(out + ff * out_stride);
        w.bytepos = ad8[t] - ff * out_stride;
        w.acc = (unsigned __int128)(hi8[t]) << 64 | lo8[t];
        w.nbits = int(nb8[t]);
        end_bits[ff] = w.finish();
      }
      continue;
    }
    for (int64_t ff = f0; ff < F && ff < f0 + 8; ++ff) {
      FastBitWriter w(out + ff * out_stride);
      const int eb = extra_w != nullptr ? extra_w[ff] : 0;
      pair_prefix(w, hv, hw, h_off[ff], h_off[ff + 1],
                  extra != nullptr ? extra + ff * S : nullptr, eb, n[ff]);
      const int64_t np = (n[ff] + 1) / 2;
      const int64_t nch = stereo[ff] ? 2 : 1;
      for (int64_t c = 0; c < nch; ++c) {
        const int64_t l0 = (ff + c * F) * NP;
        const uint32_t* ph_ = ph + l0;
        const uint32_t* pm_ = pm + l0;
        const uint32_t* pl_ = pl + l0;
        const int8_t* pw_ = pws + l0;
        int64_t j = 0;
        for (; j + 1 < np; j += 2) ALAC_PAIR2(w, ph_, pm_, pl_, pw_, j)
        for (; j < np; ++j) ALAC_PAIR1(w, ph_, pm_, pl_, pw_, j)
      }
      end_bits[ff] = w.finish();
    }
  }
#endif  // ALAC_AVX512_PACK
}

}  // extern "C"
