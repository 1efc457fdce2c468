// Fixed-stride bulk bit extraction, for Hopper (sm_90a).
//
// Replaces: alacnet_tpu/ops/pallas/bulk_bits.py, `_kernel` (reached via
// `bulk_bits`).  Per lane b and sample i < n[b], two right-aligned
// fields at pos = start[b] + i * (n1[b] + n2[b]) (wrapping in int32, as
// the JAX kernel's accumulated cursor does): a is the n1-bit field at
// pos, b the n2-bit field at pos + n1.  Both are zero for i >= n; b is
// zero where n2 == 0.  It serves the extra-bits side channel and the
// bodies of uncompressed frames.  The plain torch version reads the
// same fields with ops/bitreader.gather_bits
// (alacnet_tpu_torch/ops/cuda/bulk_bits.py).  Word reads past the row
// clip to its last word (and below it to word 0, with the second word
// of the pair then word 1), as the JAX fetch does; the plain version
// clips the window's start instead, so the two differ only on rows
// whose fields run past their end (malformed frames).
//
// What bounds it on the H100: memory traffic, two (B, S) int32 planes
// written and the coded words read once, with no dependency between
// samples.  The TPU kernel walks a per-lane bit reservoir sample by
// sample only because Mosaic has no vector gather; each field's
// position is affine in i, so every sample is independent here.
//
// What the design does about it: a block owns kSamples consecutive
// samples of one lane (blockIdx.x = lane).  The live samples' fields lie
// in one contiguous run of words, which the block stages in shared
// memory with 16-byte cp.async copies (4-byte ones where a row is not
// 16-byte aligned or the run passes the row's last word, each clipped
// there).  Each thread then extracts kPer consecutive samples from
// shared memory and writes them to both planes with one 16-byte store
// each.  Samples past n are written as zeros with the same stores; a
// block with no live sample touches no word.  A block whose positions
// wrap in int32, start below bit 0, or run wider than the staging
// buffer (a stride past kMaxStride bits) reads each word from device
// memory instead, clipped per read, as before.

#include <cstdint>
#include <cuda_runtime.h>

#include "ring_sync.cuh"

namespace {

using namespace alac_ring;

constexpr int kThreads = 256;
constexpr int kPer = 4;                          // samples per thread
constexpr int kSamples = kThreads * kPer;        // samples per block
constexpr int kMaxStride = 64;                   // bits a sample, staged
// The staged run: kSamples fields of kMaxStride bits, the pair's second
// word and the 4-word alignment of the run's start.
constexpr int kWords = kSamples * kMaxStride / 32 + 8;

// The 32-bit window at bit p of a row in device memory, clipped per
// word read (`_window32`).
__device__ __forceinline__ uint32_t win32_row(const uint32_t* __restrict__ row,
                                              int W, int p) {
  int wi = p >> 5;
  const uint32_t s = (uint32_t)p & 31u;
  wi = wi < 0 ? 0 : (wi > W - 1 ? W - 1 : wi);
  const int wj = wi + 1 > W - 1 ? W - 1 : wi + 1;
  const uint32_t hi = __ldg(row + wi);
  const uint32_t lo = __ldg(row + wj);
  return (hi << s) | (s == 0u ? 0u : lo >> ((32u - s) & 31u));
}

// The same window from the staged run, whose word 0 is row word w0.
__device__ __forceinline__ uint32_t win32_smem(const uint32_t* sw, int w0, int p) {
  const int j = (p >> 5) - w0;
  const uint32_t s = (uint32_t)p & 31u;
  return (sw[j] << s) | (s == 0u ? 0u : sw[j + 1] >> ((32u - s) & 31u));
}

// Sample i's two fields at pos.
template <bool kStaged>
__device__ __forceinline__ int2 fields(const uint32_t* __restrict__ src, int W, int w0,
                                       int pos, uint32_t n1, uint32_t n2) {
  const int pb = (int)((uint32_t)pos + n1);
  const uint32_t wa = kStaged ? win32_smem(src, w0, pos) : win32_row(src, W, pos);
  const int32_t a = (int32_t)(wa >> ((32u - n1) & 31u));
  if (n2 == 0u) return make_int2(a, 0);
  const uint32_t wb = kStaged ? win32_smem(src, w0, pb) : win32_row(src, W, pb);
  return make_int2(a, (int32_t)(wb >> ((32u - n2) & 31u)));
}

struct Lane {
  const uint32_t* __restrict__ row;
  int W, S, live_end;     // samples i < live_end are live
  uint32_t start, n1, n2;
  int32_t* __restrict__ a;
  int32_t* __restrict__ b;
  bool vec;               // 16-byte stores to both planes
};

// This thread's kPer samples from i: extracted where live, else zero.
template <bool kStaged>
__device__ __forceinline__ void run_samples(const Lane& ln, const uint32_t* src, int w0,
                                            int i) {
  int32_t va[kPer], vb[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int ik = i + k;
    // int32 wraparound like the JAX kernel's accumulated cursor.
    const int pos = (int)(ln.start + (uint32_t)ik * (ln.n1 + ln.n2));
    const int2 f = ik < ln.live_end ? fields<kStaged>(src, ln.W, w0, pos, ln.n1, ln.n2)
                                    : make_int2(0, 0);
    va[k] = f.x;
    vb[k] = f.y;
  }
  if (ln.vec && i + kPer <= ln.S) {
    *reinterpret_cast<int4*>(ln.a + i) = make_int4(va[0], va[1], va[2], va[3]);
    *reinterpret_cast<int4*>(ln.b + i) = make_int4(vb[0], vb[1], vb[2], vb[3]);
  } else {
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      if (i + k < ln.S) {
        ln.a[i + k] = va[k];
        ln.b[i + k] = vb[k];
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads) bulk_bits_kernel(
    const uint32_t* __restrict__ words, int W, const int32_t* __restrict__ start,
    const int32_t* __restrict__ n_arr, const int32_t* __restrict__ n1_arr,
    const int32_t* __restrict__ n2_arr, int S, bool vec_rows, bool vec_out,
    int32_t* __restrict__ a_out, int32_t* __restrict__ b_out,
    bool* __restrict__ stalled) {
  __shared__ __align__(16) uint32_t sw[kWords];
  const int lane = blockIdx.x, t = threadIdx.x;
  const int i0 = blockIdx.y * kSamples;
  const int i = i0 + kPer * t;
  if (blockIdx.y == 0 && t == 0) stalled[lane] = false;  // it never stalls
  const int32_t n = n_arr[lane];
  Lane ln{words + (size_t)lane * W, W, S, n < S ? n : S,
          (uint32_t)start[lane], (uint32_t)n1_arr[lane], (uint32_t)n2_arr[lane],
          a_out + (size_t)lane * S, b_out + (size_t)lane * S, vec_out};
  const int cnt = min(ln.live_end - i0, kSamples);  // live samples of the block
  if (cnt <= 0) {  // the dead tail: zeros, no word read
    run_samples<true>(ln, sw, 0, i);
    return;
  }
  // The live fields' bits, [p0, p_end), without the int32 wrap.
  const int64_t stride = (int64_t)ln.n1 + ln.n2;
  const int64_t p0 = (int64_t)(int32_t)ln.start + (int64_t)i0 * stride;
  const int64_t p_end = p0 + (int64_t)cnt * stride;
  const int64_t w0 = (p0 >> 5) & ~(int64_t)3;
  const int64_t nw = (p_end >> 5) + 2 - w0;  // through the pair's second word
  if (p0 < 0 || p_end > INT32_MAX || nw > kWords) {
    run_samples<false>(ln, ln.row, 0, i);
    return;
  }
  // Stage row words w0 .. w0 + nw - 1, each clipped to the row.
  for (int q = t; 4 * q < nw; q += kThreads) {
    const int w = (int)w0 + 4 * q;
    if (vec_rows && w + 3 <= W - 1) {
      cp_async16(&sw[4 * q], ln.row + w);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        cp_async4(&sw[4 * q + k], ln.row + (w + k < W - 1 ? w + k : W - 1));
      }
    }
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  run_samples<true>(ln, sw, (int)w0, i);
}

}  // namespace

extern "C" int alac_bulk_bits(const void* words, int B, int W,
                              const void* start, const void* n, const void* n1,
                              const void* n2, int S, void* a, void* b,
                              void* stalled, void* stream) {
  if (B > 0 && S > 0) {
    const bool vec_rows = W % 4 == 0 && (uintptr_t)words % 16 == 0;
    const bool vec_out = S % 4 == 0 && ((uintptr_t)a | (uintptr_t)b) % 16 == 0;
    const dim3 grid(B, (S + kSamples - 1) / kSamples);
    bulk_bits_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)words, W, (const int32_t*)start, (const int32_t*)n,
        (const int32_t*)n1, (const int32_t*)n2, S, vec_rows, vec_out, (int32_t*)a,
        (int32_t*)b, (bool*)stalled);
  } else if (B > 0) {
    cudaMemsetAsync(stalled, 0, (size_t)B, (cudaStream_t)stream);
  }
  return (int)cudaGetLastError();
}
