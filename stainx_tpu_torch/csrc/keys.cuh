// Monotone integer keys of float32 values, the warp-aggregated histogram
// add of macenko_fused.cu (inside B1/B2), the per-row ticket of the
// multi-block selections, and the descent from a row's common prefix that
// selection.cu (B6) and select_rows.cu (B3) share. Host
// twin: stainx_tpu_torch/kernels/selection.py.
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

// Whether this block is the last of its row to get here, for a pick that
// runs in the row's last block (B4/B5's streamed route, B6): every block
// calls it once (after its device-memory writes), the last one resets the
// ticket and sees the others' writes.
__device__ __forceinline__ bool last_of_row(unsigned* ticket, unsigned blocks) {
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(ticket, 1u) == blocks - 1;
    if (last) *ticket = 0u;
  }
  __syncthreads();
  if (last) __threadfence();
  return last;
}

// ------------------------------------------- descent from the common prefix
// B3 and B6 start a row's radix descent below the leading bits that its
// smallest and largest key (below the sentinel) share, so the first
// histogram already separates the row's values, and choose up to 8 bits a
// pass: `top` is the number of low key bits still to choose (32 when the
// extremes differ in the top bit, 0 once the key is known).
constexpr uint32_t kNoKey = 0xFFFFFFFFu;  // pads a ragged tail; never counted

// Whether key k lies under prefix: equal in every bit above the low `top`.
__device__ __forceinline__ bool under_prefix(uint32_t k, uint32_t prefix, int top) {
  return top >= 32 || ((k ^ prefix) >> top) == 0u;
}

// The low bit of the digit a pass chooses when `top` bits are left.
__device__ __forceinline__ int digit_shift(int top) { return top > 8 ? top - 8 : 0; }

// That digit of key k: the bits [digit_shift(top), top) of k, below kBins.
__device__ __forceinline__ unsigned digit_at(uint32_t k, int top) {
  const int shift = digit_shift(top);
  return (k >> shift) & ((1u << (top - shift)) - 1u);
}

// The bits left to choose below the common prefix of lo < hi, and that
// prefix (the top 32 - top bits of lo).
__device__ __forceinline__ int common_top(uint32_t lo, uint32_t hi, uint32_t& prefix) {
  const int top = 32 - __clz(lo ^ hi);
  prefix = top >= 32 ? 0u : lo & ~((1u << top) - 1u);
  return top;
}

// One warp: the bin of the kBins counts h that holds rank (0 <= rank < the
// counts' sum), and the rank left inside that bin. Lane l scans bins
// [8l, 8l + 8) after a prefix sum over the lanes.
__device__ __forceinline__ void warp_pick(const unsigned* h, long long rank, unsigned& bin,
                                          long long& rem) {
  const int lane = threadIdx.x & 31;
  unsigned local[8];
  long long total = 0;
  for (int i = 0; i < 8; ++i) {
    local[i] = h[lane * 8 + i];
    total += local[i];
  }
  long long incl = total;
  for (int off = 1; off < 32; off <<= 1) {
    const long long up = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += up;
  }
  long long below = incl - total;
  unsigned b = 0u;
  long long r = 0;
  const bool mine = below <= rank && rank < incl;
  if (mine) {
    for (int i = 0; i < 8; ++i) {
      if (rank < below + local[i]) {
        b = static_cast<unsigned>(lane * 8 + i);
        r = rank - below;
        break;
      }
      below += local[i];
    }
  }
  const unsigned owners = __ballot_sync(kFull, mine);
  const int who = owners ? __ffs(owners) - 1 : 0;
  bin = __shfl_sync(kFull, b, who);
  rem = __shfl_sync(kFull, r, who);
}

}  // namespace stainx
