// Rice / adaptive-Golomb emitter of the ALAC encoder, with the four bit
// fields of each sample merged into one right-aligned 96-bit chunk, one
// channel per lane, for Hopper (sm_90a).
//
// Replaces: alacnet_tpu/ops/pallas/enc_stages.py, `_rice_kernel` (reached
// via `rice_merge_fused` / `encode_stages_fused` -> `_rice_blocks`).  The
// per-sample expressions mirror that kernel's `sample` body (the
// decoder's EntropyRiceDecode state machine run forward,
// AlacFile.cs:214-252) and its `_merge4`; the plain torch version is
// ops/encode.rice_symbols -> merge_symbol_chunks -> ws.sum(1)
// (alacnet_tpu_torch/ops/cuda/enc_stages.py).
//
// What bounds it on the H100: the history, sign-modifier and skip state
// make each lane a serial recurrence, and a chunk is 2048 lanes, so the
// kernel is bound by one thread's per-sample instruction chain (two
// symbol emissions and the 96-bit merge), not by bytes (8 bytes in, 13
// out per sample) or the card's operation rate.
//
// What the design does about it: one thread per lane with all state in
// registers, and small blocks (kThreads lanes) so that a chunk spreads
// over 64 SMs.  Planes are sample-major (S, B): the 32 lanes of a warp
// read and write contiguous words per sample.  Each symbol takes the
// nine-step quotient ladder of ops/encode._emit_sym, so the kernel is
// the plain version's arithmetic step for step; the automaton lives in
// enc_rice_common.cuh, shared with rice_emit.cu.  The TPU kernel's lane
// tiles, 1024-lane padding and staging tiles do not carry over: the
// kernel takes any B and S.
//
// Bit-exactness: every wrapping product and sum runs in uint32_t
// (2*err, h*mult, dv*mult); shifts follow jax.lax (left by 32 or more
// gives 0, arithmetic right by 32 or more gives the sign fill); the
// merge's logical shifts give 0 for counts of 32 or more; clz(0) is 40.

#include <cstdint>
#include <cuda_runtime.h>

#include "enc_rice_common.cuh"

namespace {

using namespace alac_rice;

constexpr int kThreads = 32;  // lanes per block: 2048 lanes -> 64 blocks

// The merge's u32 shifts: c >= 32 gives 0, else the count's low 5 bits.
__device__ __forceinline__ uint32_t shl_u(uint32_t x, int32_t c) {
  return c >= 32 ? 0u : x << (c & 31);
}
__device__ __forceinline__ uint32_t shr_u(uint32_t x, int32_t c) {
  return c >= 32 ? 0u : x >> (c & 31);
}

// Append field (val, w) to the right-aligned 96-bit chunk h:m:l
// (`_merge4`, ops/encode.merge_symbol_chunks).
__device__ __forceinline__ void append(uint32_t& h, uint32_t& m, uint32_t& l,
                                       int32_t val, int32_t w) {
  const uint32_t v = (uint32_t)val & (shl_u(1u, w) - 1u);
  const int32_t inv = 32 - w;
  h = shl_u(h, w) | shr_u(m, inv);
  m = shl_u(m, w) | shr_u(l, inv);
  l = shl_u(l, w) | v;
}

__global__ void __launch_bounds__(kThreads) enc_rice_kernel(
    const int32_t* __restrict__ errs_sb, const int32_t* __restrict__ zr_sb,
    int B, int S, const int32_t* __restrict__ n_arr,
    const int32_t* __restrict__ rss_arr, const int32_t* __restrict__ kmod_arr,
    const int32_t* __restrict__ ihist_arr,
    const int32_t* __restrict__ mult_arr,
    const int32_t* __restrict__ kmask_arr, int32_t* __restrict__ c0_sb,
    int32_t* __restrict__ c1_sb, int32_t* __restrict__ c2_sb,
    int8_t* __restrict__ ws_sb, int32_t* __restrict__ bits_out,
    bool* __restrict__ bad_out) {
  const int b = blockIdx.x * kThreads + threadIdx.x;
  if (b >= B) return;

  const Params p{n_arr[b], rss_arr[b], kmod_arr[b], mult_arr[b], kmask_arr[b]};
  State st{ihist_arr[b], 0, 0, false};
  int32_t bits = 0;

  for (int i = 0; i < S; ++i) {
    const size_t at = (size_t)i * B + b;
    const Step e = step(st, p, i, errs_sb[at], zr_sb[at]);

    // Widths pass through int8, as the plain version's width planes do
    // (a no-op for every width a lane without a desync can have).
    const int32_t w0 = (int8_t)(e.emit_v ? e.sv.w0 : 0);
    const int32_t w1 = (int8_t)(e.emit_v ? e.sv.w1 : 0);
    const int32_t w2 = (int8_t)(e.emit_z ? e.sz.w0 : 0);
    const int32_t w3 = (int8_t)(e.emit_z ? e.sz.w1 : 0);
    uint32_t ch = 0u, cm = 0u, cl = 0u;
    append(ch, cm, cl, e.sv.v0, w0);
    append(ch, cm, cl, e.sv.v1, w1);
    append(ch, cm, cl, e.sz.v0, w2);
    append(ch, cm, cl, e.sz.v1, w3);
    const int8_t ws = (int8_t)(w0 + w1 + w2 + w3);
    c0_sb[at] = (int32_t)ch;
    c1_sb[at] = (int32_t)cm;
    c2_sb[at] = (int32_t)cl;
    ws_sb[at] = ws;
    bits = wadd(bits, ws);
  }
  bits_out[b] = bits;
  bad_out[b] = st.bad;
}

}  // namespace

extern "C" int alac_enc_rice(const void* errs_sb, const void* zr_sb, int B,
                             int S, const void* n, const void* rss,
                             const void* kmod, const void* ihist,
                             const void* mult, const void* kmask, void* c0_sb,
                             void* c1_sb, void* c2_sb, void* ws_sb, void* bits,
                             void* bad, void* stream) {
  if (B > 0) {
    enc_rice_kernel<<<(B + kThreads - 1) / kThreads, kThreads, 0,
                      (cudaStream_t)stream>>>(
        (const int32_t*)errs_sb, (const int32_t*)zr_sb, B, S,
        (const int32_t*)n, (const int32_t*)rss, (const int32_t*)kmod,
        (const int32_t*)ihist, (const int32_t*)mult, (const int32_t*)kmask,
        (int32_t*)c0_sb, (int32_t*)c1_sb, (int32_t*)c2_sb, (int8_t*)ws_sb,
        (int32_t*)bits, (bool*)bad);
  }
  return (int)cudaGetLastError();
}
