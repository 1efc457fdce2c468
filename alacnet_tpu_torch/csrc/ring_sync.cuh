// Hand-off primitives of the kernels' shared-memory rings (enc_pred.cu,
// rice_ring.cuh, rice_lpc.cu): named barriers between warps of a block,
// cp.async copies from device memory into shared memory, and tiles of
// sample-major planes moved between the two.
//
// A named barrier `id` (1..15; 0 is __syncthreads') completes when
// `threads` threads of the block have reached it: a warp that hands a
// slot over arrives (bar.arrive, no wait), the warp that takes it syncs
// (bar.sync), and the pair orders the shared-memory writes before the
// barrier against the reads after it.  bar.* is warp-aligned, so each
// call first converges its warp.

#pragma once

#include <cstdint>

namespace alac_ring {

__device__ __forceinline__ void bar_sync(int id, int threads) {
  __syncwarp();
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int threads) {
  __syncwarp();
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// 16 bytes (both addresses 16-byte aligned) or 4 bytes, device memory to
// shared memory, asynchronously; each commit closes a group, and
// cp_async_wait<N> returns once all but the newest N groups of this
// thread have landed.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s), "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(s), "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Tiles of a sample-major (S, B) plane in shared memory: rows i0 ..
// i0 + ROWS - 1 of lanes b0 .. b0 + L - 1, lane b0 + l in column l of a
// kCols-wide array (a warp's 32 threads read a row without bank
// conflicts).  Rows past S and lanes past B are not touched.  `vec`:
// B and the plane's address allow 16-byte accesses (B a multiple of 16
// elements' worth, the base 16-byte aligned); otherwise one element per
// access.  The 32 threads of one warp (t = 0..31) share the work.
constexpr int kCols = 32;

template <int L, int ROWS>
__device__ __forceinline__ void load_tile(int32_t (*dst)[kCols],
                                          const int32_t* __restrict__ plane, int B,
                                          int S, int b0, int i0, bool vec, int t) {
  if (vec) {
    constexpr int kChunks = L / 4;
    for (int q = t; q < ROWS * kChunks; q += 32) {
      const int r = q / kChunks, ch = q % kChunks;
      const int i = i0 + r, b = b0 + 4 * ch;
      if (i < S && b < B) cp_async16(&dst[r][4 * ch], plane + (size_t)i * B + b);
    }
  } else {
    for (int q = t; q < ROWS * L; q += 32) {
      const int r = q / L, l = q % L;
      const int i = i0 + r, b = b0 + l;
      if (i < S && b < B) cp_async4(&dst[r][l], plane + (size_t)i * B + b);
    }
  }
}

// Write a tile's rows to the plane, 16 bytes a store where `vec`; zeros
// where `src` is null.
template <typename T, int L, int ROWS>
__device__ __forceinline__ void store_tile(T* __restrict__ plane, const T (*src)[kCols],
                                           int B, int S, int b0, int i0, bool vec,
                                           int t) {
  if (vec) {
    constexpr int kPer = 16 / (int)sizeof(T);
    constexpr int kChunks = L / kPer;
    for (int q = t; q < ROWS * kChunks; q += 32) {
      const int r = q / kChunks, ch = q % kChunks;
      const int i = i0 + r, b = b0 + kPer * ch;
      if (i < S && b < B) {
        const int4 v = src ? *reinterpret_cast<const int4*>(&src[r][kPer * ch])
                           : make_int4(0, 0, 0, 0);
        *reinterpret_cast<int4*>(plane + (size_t)i * B + b) = v;
      }
    }
  } else {
    for (int q = t; q < ROWS * L; q += 32) {
      const int r = q / L, l = q % L;
      const int i = i0 + r, b = b0 + l;
      if (i < S && b < B) plane[(size_t)i * B + b] = src ? src[r][l] : T{};
    }
  }
}

}  // namespace alac_ring
