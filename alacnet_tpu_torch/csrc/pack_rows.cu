// Device-side row assembly: the (B, W) word-row table from the blob's
// big-endian words, for Hopper (sm_90a).
//
// Replaces: alacnet_tpu/ops/pallas/pack_rows.py, `_kernel` (reached via
// `pack_rows`).  Row b is flat[clip(ow[b], 0, L - W) + j] for j < W,
// with every byte at or after nbytes[b] zeroed (`_mask_tail`).  The
// plain torch version follows `pack_rows_xla`
// (alacnet_tpu_torch/ops/cuda/pack_rows.py).
//
// What bounds it on the H100: pure data movement, one read and one
// write of B*W words, so HBM bandwidth (and, for a small span, launch
// latency).  The TPU kernel's aligned-window DMA and log2 shifter exist
// because Mosaic has no word-granular dynamic slice; a GPU thread can
// load any word, so none of that carries over.
//
// What the design does about it: one thread per (lane, word).  A block
// covers kThreads consecutive words of one lane (blockIdx.x = lane), so
// a warp's loads and stores are 32 consecutive words: coalesced on both
// sides.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void pack_rows_kernel(const uint32_t* __restrict__ flat, int L,
                                 const int32_t* __restrict__ ow,
                                 const int32_t* __restrict__ nbytes, int W,
                                 uint32_t* __restrict__ out) {
  const int j = blockIdx.y * kThreads + threadIdx.x;
  const int b = blockIdx.x;
  if (j >= W) return;
  int o = ow[b];
  const int hi = L - W;
  o = o < 0 ? 0 : (o > hi ? hi : o);
  const uint32_t v = flat[(size_t)o + j];
  int nb = nbytes[b] - 4 * j;
  nb = nb < 0 ? 0 : (nb > 4 ? 4 : nb);
  // nb == 4 keeps the word, 0 zeroes it, else keep the top nb bytes.
  const uint32_t mask =
      nb >= 4 ? 0xFFFFFFFFu : (nb <= 0 ? 0u : 0xFFFFFFFFu << ((4 - nb) * 8));
  out[(size_t)b * W + j] = v & mask;
}

}  // namespace

extern "C" int alac_pack_rows(const void* flat, int L, const void* ow,
                              const void* nbytes, int B, int W, void* out,
                              void* stream) {
  if (B > 0 && W > 0) {
    const dim3 grid(B, (W + kThreads - 1) / kThreads);
    pack_rows_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)flat, L, (const int32_t*)ow, (const int32_t*)nbytes,
        W, (uint32_t*)out);
  }
  return (int)cudaGetLastError();
}
