// The decode's blob upload epilogue, for Hopper (sm_90a).
//
// Replaces: `_words_from_le` of alacnet_tpu/ops/pallas/pack_rows.py
// (:110-125), the device half of `blob_words`, which XLA runs as one
// pass under jit (no Pallas kernel).  The host ships the coded blob as
// little-endian int32 words x[0, m) (its whole words) plus the <= 3 tail
// bytes folded into one big-endian word; out is the (nq, 128) big-endian
// word blob that pack_rows cuts rows from: out[i] = bswap(x[i]) for
// i < m, out[m] = the tail word, every later word 0.  The plain torch
// version is `blob_words_plain` (alacnet_tpu_torch/ops/cuda/
// pack_rows.py), bit for bit.
//
// What bounds it on the H100: memory traffic, 4 bytes read and 4 written
// a blob word, one byte permute each.  The plain chain's eleven
// elementwise ops, zero fill, slice copy and scalar copy move some
// fifteen times that.
//
// What the design does about it: one pass, every output word written
// once by this kernel (no separate fill).  A thread takes 4 words at a
// time in a grid-stride loop: one 16-byte load (where x is 16-byte
// aligned and the 4 words lie below m), four __byte_perm swaps, one
// 16-byte store.  The quad that holds m, and every quad when x is not
// aligned, reads word by word; the padding past it is stores only.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 4096;

__device__ __forceinline__ int32_t bswap(int32_t v) {
  return (int32_t)__byte_perm((uint32_t)v, 0u, 0x0123);
}

__global__ void __launch_bounds__(kThreads)
    blob_words_kernel(const int32_t* __restrict__ x, long long m, int32_t tail,
                      long long quads, bool vec, int32_t* __restrict__ out) {
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long q = (long long)blockIdx.x * kThreads + threadIdx.x; q < quads;
       q += stride) {
    const long long i = 4 * q;
    int4 w;
    if (vec && i + 4 <= m) {
      w = *reinterpret_cast<const int4*>(x + i);
      w = make_int4(bswap(w.x), bswap(w.y), bswap(w.z), bswap(w.w));
    } else if (i > m) {
      w = make_int4(0, 0, 0, 0);
    } else {
      int32_t v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const long long k = i + j;
        v[j] = k < m ? bswap(x[k]) : (k == m ? tail : 0);
      }
      w = make_int4(v[0], v[1], v[2], v[3]);
    }
    *reinterpret_cast<int4*>(out + i) = w;
  }
}

}  // namespace

// x: m little-endian int32 words (may be null when m == 0); tail: the
// big-endian tail word as an int32 pattern; out: total int32 words,
// 16-byte aligned, total % 4 == 0 and total > m (the caller's checks).
extern "C" int alac_blob_words(const void* x, long long m, int tail, long long total,
                               void* out, void* stream) {
  const long long quads = total / 4;
  if (quads > 0) {
    const bool vec = (uintptr_t)x % 16 == 0;
    long long blocks = (quads + kThreads - 1) / kThreads;
    if (blocks > kMaxBlocks) blocks = kMaxBlocks;
    blob_words_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)x, m, (int32_t)tail, quads, vec, (int32_t*)out);
  }
  return (int)cudaGetLastError();
}
