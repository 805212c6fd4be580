// Monotone integer keys of float32 values and the warp-aggregated histogram
// add, shared by the exact radix selections of macenko_fused.cu (inside
// B1/B2), selection.cu (B6) and select_rows.cu (B3). Host twin:
// stainx_tpu_torch/kernels/selection.py.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace stainx {

constexpr int kBins = 256;                      // 8 key bits a radix pass
constexpr uint32_t kSentinelKey = 0xFF800000u;  // monotone_key(+inf)
constexpr unsigned kFull = 0xFFFFFFFFu;

// key = bits XOR (sign ? 0xFFFFFFFF : 0x80000000): orders as the floats do.
__device__ __forceinline__ uint32_t monotone_key(float x) {
  const uint32_t u = __float_as_uint(x);
  return u ^ ((u >> 31) ? 0xFFFFFFFFu : 0x80000000u);
}

__device__ __forceinline__ float unkey(uint32_t k) {
  return __uint_as_float(k ^ ((k >> 31) ? 0x80000000u : 0xFFFFFFFFu));
}

// Adds one to hist[bin] for every lane of the warp, a bin of `bins` or more
// meaning none; lanes with the same bin are added by one shared-memory
// atomic of their leader. Every lane of the warp must call it.
__device__ __forceinline__ void hist_add(unsigned int* hist, unsigned bin,
                                         unsigned bins = kBins) {
  const unsigned peers = __match_any_sync(kFull, bin);
  if (bin < bins && static_cast<int>(threadIdx.x & 31) == __ffs(peers) - 1) {
    atomicAdd(&hist[bin], static_cast<unsigned>(__popc(peers)));
  }
}

}  // namespace stainx
