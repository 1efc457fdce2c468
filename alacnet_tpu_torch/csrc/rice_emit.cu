// Rice / adaptive-Golomb emitter of the ALAC encoder with the four bit
// fields of each sample written unmerged (the symbol planes), one
// channel per lane, for Hopper (sm_90a).
//
// Replaces: alacnet_tpu/ops/pallas/rice_emit.py, `_kernel` (reached via
// `rice_symbols_fused`).  Its plain torch version is
// ops/encode.rice_symbols (alacnet_tpu_torch/ops/cuda/rice_emit.py), and
// its output feeds the native symbol-plane packer
// (native.pack_symbol_frames_native).  The automaton is the one
// enc_rice.cu runs (enc_rice_common.cuh): this kernel calls its state
// step and then its symbol step in one thread; only the output differs.
//
// What bounds it on the H100: the history, sign-modifier and skip state
// make each lane a serial recurrence, so at an encode chunk's 2048 lanes
// the kernel is bound by one thread's per-sample instruction chain (two
// nine-step symbol ladders), not by bytes (8 bytes in, 16 out per
// sample) or the card's operation rate.
//
// What the design does about it: one thread per lane, its state in
// registers, small blocks (kThreads lanes) so that 2048 lanes spread
// over 64 SMs.  Inputs are sample-major (S, B), and so are the outputs,
// with each sample's fields interleaved per lane: (S, B, 2) int16 for the
// unary/marker fields [v0, v2], (S, B, 2) int32 for the remainder/escape
// fields [v1, v3], (S, B, 4) int8 for the widths.  Per sample a thread
// stores one 4-byte word, one 8-byte word and one 4-byte word, so a
// warp writes 128, 256 and 128 contiguous bytes.  The TPU kernel's
// (8, 128) lane tiles, 1024-lane padding and OUT_TILE staging with DMA
// semaphores do not carry over: any B and S, no padding.
//
// Every output element is written: values for every sample (past n too,
// where the plain version computes them as well), widths 0 where a
// symbol is not live, so the planes equal the plain version's
// everywhere.

#include <cstdint>
#include <cuda_runtime.h>

#include "enc_rice_common.cuh"

namespace {

using namespace alac_rice;

constexpr int kThreads = 32;  // lanes per block: 2048 lanes -> 64 blocks

__device__ __forceinline__ uint32_t lo16(int32_t v) {
  return (uint32_t)(uint16_t)(uint32_t)v;
}
__device__ __forceinline__ uint32_t byte_of(int32_t w, int at) {
  return ((uint32_t)(uint8_t)(int8_t)w) << (8 * at);
}

__global__ void __launch_bounds__(kThreads) rice_emit_kernel(
    const int32_t* __restrict__ errs_sb, const int32_t* __restrict__ zr_sb,
    int B, int S, const int32_t* __restrict__ n_arr,
    const int32_t* __restrict__ rss_arr, const int32_t* __restrict__ kmod_arr,
    const int32_t* __restrict__ ihist_arr,
    const int32_t* __restrict__ mult_arr,
    const int32_t* __restrict__ kmask_arr, uint32_t* __restrict__ v16_sb,
    int2* __restrict__ v32_sb, uint32_t* __restrict__ wid_sb,
    bool* __restrict__ bad_out) {
  const int b = blockIdx.x * kThreads + threadIdx.x;
  if (b >= B) return;

  const Params p{n_arr[b], rss_arr[b], kmod_arr[b], mult_arr[b], kmask_arr[b]};
  State st{ihist_arr[b], 0, 0, false};

  for (int i = 0; i < S; ++i) {
    const size_t at = (size_t)i * B + b;
    const int32_t zr = zr_sb[at];
    const StepOut e = state_step(st, p, i, errs_sb[at], zr);
    Sym sv, sz;
    symbol_step(e, zr, p, sv, sz);
    // int16 and int8 planes take the low bits, as torch's .to() does.
    v16_sb[at] = lo16(sv.v0) | (lo16(sz.v0) << 16);
    v32_sb[at] = make_int2(sv.v1, sz.v1);
    wid_sb[at] = byte_of(e.emit_v ? sv.w0 : 0, 0) |
                 byte_of(e.emit_v ? sv.w1 : 0, 1) |
                 byte_of(e.emit_z ? sz.w0 : 0, 2) |
                 byte_of(e.emit_z ? sz.w1 : 0, 3);
  }
  bad_out[b] = st.bad;
}

}  // namespace

extern "C" int alac_rice_emit(const void* errs_sb, const void* zr_sb, int B,
                              int S, const void* n, const void* rss,
                              const void* kmod, const void* ihist,
                              const void* mult, const void* kmask,
                              void* v16_sb, void* v32_sb, void* wid_sb,
                              void* bad, void* stream) {
  if (B > 0) {
    rice_emit_kernel<<<(B + kThreads - 1) / kThreads, kThreads, 0,
                       (cudaStream_t)stream>>>(
        (const int32_t*)errs_sb, (const int32_t*)zr_sb, B, S,
        (const int32_t*)n, (const int32_t*)rss, (const int32_t*)kmod,
        (const int32_t*)ihist, (const int32_t*)mult, (const int32_t*)kmask,
        (uint32_t*)v16_sb, (int2*)v32_sb, (uint32_t*)wid_sb, (bool*)bad);
  }
  return (int)cudaGetLastError();
}
