// Device-side row assembly: the (B, W) word-row table from the blob's
// big-endian words, for Hopper (sm_90a).
//
// Replaces: alacnet_tpu/ops/pallas/pack_rows.py, `_kernel` (reached via
// `pack_rows`).  Row b is flat[clip(ow[b], 0, L - W) + j] for j < W,
// with every byte at or after nbytes[b] zeroed (`_mask_tail`).  The
// plain torch version follows `pack_rows_xla`
// (alacnet_tpu_torch/ops/cuda/pack_rows.py).
//
// What bounds it on the H100: pure data movement — the words below a
// row's ceil(nbytes / 4) read once, all B*W words written once — so HBM
// bandwidth (and, for a small span, launch latency).  The TPU kernel's
// aligned-window DMA and log2 shifter exist because Mosaic has no
// word-granular dynamic slice; none of that carries over.
//
// What the design does about it: a block of kThreads threads owns a
// chunk of kChunk words of one row (grid: rows x chunks) and reads the
// row's two parameters once, into shared memory.  On the vector path
// (W % 4 == 0, the blob 16-byte aligned and L % 4 == 0: the main path,
// where W is a multiple of 256 words) each thread moves kGroups groups
// of 4 words with one 16-byte store each; a group's source starts at
// word o + j, which is word- but not 16-byte aligned, so it is cut from
// two aligned 16-byte loads (one where o % 4 == 0) by a block-uniform
// word select.  Groups at or past the row's last valid word are stored
// as zeros with no load.  Every other shape takes the scalar path: the
// same chunks, one word per thread per step, coalesced.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kGroups = 2;                          // 4-word groups a thread moves
constexpr int kChunk = kThreads * kGroups * 4;      // words per block: 1024

// nb == 4 keeps the word, <= 0 zeroes it, else keeps its top nb bytes.
__device__ __forceinline__ uint32_t tail_mask(int nb) {
  return nb >= 4 ? 0xFFFFFFFFu : (nb <= 0 ? 0u : 0xFFFFFFFFu << ((4 - nb) * 8));
}

// Words of a row that hold at least one valid byte.
__device__ __forceinline__ int valid_words(int nb, int W) {
  const long long w = ((long long)nb + 3) >> 2;
  return w <= 0 ? 0 : (w >= W ? W : (int)w);
}

// The row's clipped source offset and byte count, read once per block.
__device__ __forceinline__ void row_params(const int32_t* __restrict__ ow,
                                           const int32_t* __restrict__ nbytes,
                                           int L, int W, int* o, int* nb) {
  __shared__ int s_o, s_nb;
  if (threadIdx.x == 0) {
    const int hi = L - W;
    const int v = ow[blockIdx.x];
    s_o = v < 0 ? 0 : (v > hi ? hi : v);
    s_nb = nbytes[blockIdx.x];
  }
  __syncthreads();
  *o = s_o;
  *nb = s_nb;
}

__global__ void __launch_bounds__(kThreads) pack_rows_vec4(
    const uint32_t* __restrict__ flat, int L, const int32_t* __restrict__ ow,
    const int32_t* __restrict__ nbytes, int W, uint32_t* __restrict__ out) {
  int o, nb;
  row_params(ow, nbytes, L, W, &o, &nb);
  const int sh = o & 3;             // block-uniform word shift
  const uint4* src = reinterpret_cast<const uint4*>(flat + (o - sh));
  uint4* dst = reinterpret_cast<uint4*>(out + (size_t)blockIdx.x * W);
  // Words below nw hold at least one valid byte; groups from nwg on are
  // all zero and load nothing.
  const int nw = valid_words(nb, W);
  const int nwg = (nw + 3) >> 2;
  const int g0 = blockIdx.y * (kChunk / 4) + threadIdx.x;
  uint4 v[kGroups];
#pragma unroll
  for (int k = 0; k < kGroups; ++k) {
    const int g = g0 + k * kThreads;
    v[k] = make_uint4(0u, 0u, 0u, 0u);
    if (g >= nwg) continue;
    const uint4 x = __ldg(src + g);
    if (sh == 0) {
      v[k] = x;
    } else {
      // Source words 4g+sh .. 4g+sh+3 of the aligned base: in bounds,
      // since L % 4 == 0 and word o + 4g + 3 < L.
      const uint4 y = __ldg(src + g + 1);
      v[k] = sh == 1 ? make_uint4(x.y, x.z, x.w, y.x)
           : sh == 2 ? make_uint4(x.z, x.w, y.x, y.y)
                     : make_uint4(x.w, y.x, y.y, y.z);
    }
    const int rest = nb - 16 * g;   // valid bytes from the group's first
    if (rest < 16) {
      v[k].x &= tail_mask(rest);
      v[k].y &= tail_mask(rest - 4);
      v[k].z &= tail_mask(rest - 8);
      v[k].w &= tail_mask(rest - 12);
    }
  }
#pragma unroll
  for (int k = 0; k < kGroups; ++k) {
    const int g = g0 + k * kThreads;
    if (4 * g < W) dst[g] = v[k];
  }
}

__global__ void __launch_bounds__(kThreads) pack_rows_scalar(
    const uint32_t* __restrict__ flat, int L, const int32_t* __restrict__ ow,
    const int32_t* __restrict__ nbytes, int W, uint32_t* __restrict__ out) {
  int o, nb;
  row_params(ow, nbytes, L, W, &o, &nb);
  const int nw = valid_words(nb, W);
  const int j0 = blockIdx.y * kChunk + threadIdx.x;
  uint32_t* row = out + (size_t)blockIdx.x * W;
#pragma unroll 4
  for (int k = 0; k < kChunk / kThreads; ++k) {
    const int j = j0 + k * kThreads;
    if (j >= W) break;
    row[j] = j < nw ? __ldg(flat + (size_t)o + j) & tail_mask(nb - 4 * j) : 0u;
  }
}

}  // namespace

// vec4 != 0 selects the vector path; the caller guarantees its
// conditions (W % 4 == 0, L % 4 == 0, flat and out 16-byte aligned).
extern "C" int alac_pack_rows(const void* flat, int L, const void* ow,
                              const void* nbytes, int B, int W, int vec4,
                              void* out, void* stream) {
  if (B > 0 && W > 0) {
    const dim3 grid(B, (W + kChunk - 1) / kChunk);
    auto kernel = vec4 ? pack_rows_vec4 : pack_rows_scalar;
    kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)flat, L, (const int32_t*)ow, (const int32_t*)nbytes,
        W, (uint32_t*)out);
  }
  return (int)cudaGetLastError();
}
