// Fixed-stride bulk bit extraction, for Hopper (sm_90a).
//
// Replaces: alacnet_tpu/ops/pallas/bulk_bits.py, `_kernel` (reached via
// `bulk_bits`).  Per lane b and sample i < n[b], two right-aligned
// fields at pos = start[b] + i * (n1[b] + n2[b]): a is the n1-bit field
// at pos, b the n2-bit field at pos + n1.  Both are zero for i >= n; b
// is zero where n2 == 0.  It serves the extra-bits side channel and the
// bodies of uncompressed frames.  The plain torch version reads the
// same fields with ops/bitreader.gather_bits
// (alacnet_tpu_torch/ops/cuda/bulk_bits.py).
//
// What bounds it on the H100: memory traffic, two (B, S) int32 planes
// written and the coded words read once, with no dependency between
// samples.  The TPU kernel walks a per-lane bit reservoir sample by
// sample only because Mosaic has no vector gather; each field's
// position is affine in i, so every (lane, sample) is independent here.
//
// What the design does about it: one thread per (lane, sample).  A
// block covers kThreads consecutive samples of one lane (blockIdx.x =
// lane), so a warp's stores to both planes are contiguous and its word
// loads fall in a few consecutive words (served by L1).  Extraction uses
// the same two-word form as `_window32` and `gather_bits`; word reads
// past the row clip to its last word, as the JAX fetch does.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t win32(const uint32_t* __restrict__ row,
                                          int W, int p) {
  int wi = p >> 5;
  const uint32_t s = (uint32_t)p & 31u;
  wi = wi < 0 ? 0 : (wi > W - 1 ? W - 1 : wi);
  const int wj = wi + 1 > W - 1 ? W - 1 : wi + 1;
  const uint32_t hi = __ldg(row + wi);
  const uint32_t lo = __ldg(row + wj);
  return (hi << s) | (s == 0u ? 0u : lo >> ((32u - s) & 31u));
}

__global__ void bulk_bits_kernel(const uint32_t* __restrict__ words, int W,
                                 const int32_t* __restrict__ start,
                                 const int32_t* __restrict__ n_arr,
                                 const int32_t* __restrict__ n1_arr,
                                 const int32_t* __restrict__ n2_arr, int S,
                                 int32_t* __restrict__ a_out,
                                 int32_t* __restrict__ b_out) {
  const int i = blockIdx.y * kThreads + threadIdx.x;
  const int b = blockIdx.x;
  if (i >= S) return;
  const size_t o = (size_t)b * S + i;
  const int32_t n = n_arr[b];
  if (i >= n) {
    a_out[o] = 0;
    b_out[o] = 0;
    return;
  }
  const uint32_t n1 = (uint32_t)n1_arr[b];
  const uint32_t n2 = (uint32_t)n2_arr[b];
  // int32 wraparound like the JAX kernel's accumulated cursor.
  const int pos = (int)((uint32_t)start[b] + (uint32_t)i * (n1 + n2));
  const uint32_t* row = words + (size_t)b * W;
  a_out[o] = (int32_t)(win32(row, W, pos) >> ((32u - n1) & 31u));
  b_out[o] = n2 == 0u
      ? 0
      : (int32_t)(win32(row, W, (int)((uint32_t)pos + n1)) >> ((32u - n2) & 31u));
}

}  // namespace

extern "C" int alac_bulk_bits(const void* words, int B, int W,
                              const void* start, const void* n, const void* n1,
                              const void* n2, int S, void* a, void* b,
                              void* stream) {
  if (B > 0 && S > 0) {
    const dim3 grid(B, (S + kThreads - 1) / kThreads);
    bulk_bits_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)words, W, (const int32_t*)start, (const int32_t*)n,
        (const int32_t*)n1, (const int32_t*)n2, S, (int32_t*)a, (int32_t*)b);
  }
  return (int)cudaGetLastError();
}
