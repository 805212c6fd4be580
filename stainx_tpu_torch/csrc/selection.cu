// Exact multi-block rank selection for Hopper (sm_90a), with a plain C
// interface loaded through ctypes (stainx_tpu_torch/kernels/selection_stream.py).
//
// What it replaces
//   stainx_tpu/kernels/selection_stream.py::kth_smallest_streaming
//   (_stream_kernel), B6: K nearest-rank selections per row of an (R, P)
//   float32 field with +inf sentinels, rows of any length, with an optional
//   per-row (min, max, count) init. The staged Macenko route runs it on few
//   long rows (stainx_tpu_torch/ops/macenko.py select_route); B4 and B5
//   select inside their own kernels (macenko_stream.cu).
//
// What bounds it
//   Reading the field once: 4 bytes an element, 0.020 ms for a 16.8 M field
//   at 3.35 TB/s. The descent reads it once per 8-bit digit (4 passes), so
//   its floor is 4x that unless the field stays in the 50 MB L2.
//
// What the design does about it
//   The TPU kernel walks one row per grid step through a 6-cut interval
//   descent, a ladder tuned against TPU sync costs. Here a row is split
//   across many blocks, and the descent is a radix select on the uint32
//   monotone key, 8 bits a pass:
//   - count: every block builds a shared-memory histogram of the digit of
//     the keys that match the row's prefix so far (warp-aggregated shared
//     atomics), then adds its non-zero bins into a global (R, K, 256) int32
//     histogram with integer atomics: exact and independent of block order,
//     so repeat runs are bit-identical;
//   - pick: one warp per (row, rank) scans the 256 bins, clamps the rank to
//     the count (a rank past the count takes the largest element; a row
//     with no element gives +inf), appends the bin to the prefix and keeps
//     the rank left inside it, all on the device: no host sync between
//     passes, so the whole selection can be captured in a CUDA graph.
//   Ranks whose prefix is equal share one histogram (the two Macenko angle
//   ranks share the first pass). With an init, the descent starts below the
//   common leading bytes of min and max, and a row of equal keys or with a
//   count of 0 launches no count work at all. The result is unkey(prefix),
//   an element of the data.

#include <cuda_runtime.h>

#include <cstdint>

#include "keys.cuh"

namespace {

using namespace stainx;

constexpr int kThreads = 256;
constexpr int kMaxK = 8;  // ranks a launch serves; the wrapper splits more
constexpr int kPasses = 4;

struct SelState {
  uint32_t prefix;  // key bits chosen so far
  int32_t level;    // first pass that still has to choose a digit (4: done)
  long long rank;   // rank left inside the prefix
};

// State of each (row, rank): rank as given, or with an init the common
// leading bytes of the min and max keys and the rank clamped to the count.
__global__ void select_init(const int* __restrict__ ranks, const uint32_t* __restrict__ init,
                            SelState* __restrict__ st, int64_t n, int k_ranks) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  SelState s{0u, 0, static_cast<long long>(ranks[i])};
  if (init != nullptr) {
    const int64_t r = i / k_ranks;
    const uint32_t lo = init[3 * r], hi = init[3 * r + 1];
    const long long cnt = static_cast<int>(init[3 * r + 2]);
    if (cnt <= 0) {
      s.prefix = kSentinelKey;
      s.level = kPasses;
    } else {
      const uint32_t diff = lo ^ hi;
      s.level = diff == 0u ? kPasses : __clz(diff) / 8;
      s.prefix = s.level == 0 ? 0u : (lo & (0xFFFFFFFFu << (32 - 8 * s.level)));
      s.rank = s.rank < 0 ? 0 : (s.rank >= cnt ? cnt - 1 : s.rank);
    }
  }
  st[i] = s;
}

// Whether rank k of a row counts its own histogram at pass d: it is still
// descending and no earlier rank of the row has the same prefix.
__device__ __forceinline__ int hist_owner(const SelState* s, int k, int d) {
  for (int j = 0; j < k; ++j) {
    if (s[j].level <= d && s[j].prefix == s[k].prefix) return j;
  }
  return k;
}

// Pass d of row blockIdx.y: digit histograms of the keys that match each
// rank's prefix, over this block's contiguous share of the row.
template <int V>
__global__ void __launch_bounds__(kThreads)
select_count(const float* __restrict__ x, int64_t p, int k_ranks, const SelState* __restrict__ st,
             int* __restrict__ hist, int d) {
  __shared__ unsigned int sh[kMaxK][kBins];
  __shared__ SelState ss[kMaxK];
  __shared__ int own[kMaxK];
  const int64_t r = blockIdx.y;
  if (threadIdx.x < k_ranks) ss[threadIdx.x] = st[r * k_ranks + threadIdx.x];
  for (int i = threadIdx.x; i < k_ranks * kBins; i += kThreads) sh[i / kBins][i % kBins] = 0u;
  __syncthreads();
  if (threadIdx.x < k_ranks) {
    const int k = threadIdx.x;
    own[k] = ss[k].level <= d && hist_owner(ss, k, d) == k;
  }
  __syncthreads();
  int any = 0;
  for (int k = 0; k < k_ranks; ++k) any |= own[k];
  if (!any) return;  // block-uniform: every rank of the row knows this digit

  const int shift = 24 - 8 * d;
  const int64_t groups = p / V;
  const int64_t per_block = (groups + gridDim.x - 1) / gridDim.x;
  const int64_t g_begin = static_cast<int64_t>(blockIdx.x) * per_block;
  const int64_t g_end = g_begin + per_block < groups ? g_begin + per_block : groups;
  const float* row = x + r * p;
  for (int64_t g0 = g_begin; g0 < g_end; g0 += kThreads) {
    const int64_t g = g0 + threadIdx.x;
    const bool ok = g < g_end;
    float v[V];
    if constexpr (V == 4) {
      const float4 q = ok ? reinterpret_cast<const float4*>(row)[g] : make_float4(0, 0, 0, 0);
      v[0] = q.x;
      v[1] = q.y;
      v[2] = q.z;
      v[3] = q.w;
    } else {
      v[0] = ok ? row[g] : 0.0f;
    }
    for (int j = 0; j < V; ++j) {
      const uint32_t key = monotone_key(v[j]);
      const bool valid = ok && key < kSentinelKey;
      for (int k = 0; k < k_ranks; ++k) {
        if (!own[k]) continue;  // block-uniform
        const bool in = valid && (d == 0 || ((key ^ ss[k].prefix) >> (shift + 8)) == 0u);
        hist_add(sh[k], in ? (key >> shift) & 0xFFu : kBins);
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < k_ranks * kBins; i += kThreads) {
    const int k = i / kBins, b = i % kBins;
    if (own[k] && sh[k][b] != 0u) {
      atomicAdd(&hist[(r * k_ranks + k) * kBins + b], static_cast<int>(sh[k][b]));
    }
  }
}

// Pass d, one block per row, warp k for rank k: pick the bin that holds the
// rank, carry prefix and rank on, clear the histogram for the next pass. At
// the last pass, write unkey(prefix) of every rank.
__global__ void select_pick(SelState* __restrict__ st, int* __restrict__ hist, int k_ranks,
                            int d, float* __restrict__ out) {
  __shared__ SelState ss[kMaxK];
  const int64_t r = blockIdx.x;
  const int k = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x < k_ranks) ss[threadIdx.x] = st[r * k_ranks + threadIdx.x];
  __syncthreads();
  SelState s = ss[k];
  const bool active = s.level <= d;  // warp-uniform
  unsigned local[8];
  long long total = 0;
  if (active) {
    const int* h = hist + (r * k_ranks + hist_owner(ss, k, d)) * kBins + lane * 8;
    for (int i = 0; i < 8; ++i) {
      local[i] = static_cast<unsigned>(h[i]);
      total += local[i];
    }
  }
  __syncthreads();  // every warp has read its histogram before any is cleared
  if (active) {
    int* h = hist + (r * k_ranks + k) * kBins + lane * 8;
    for (int i = 0; i < 8; ++i) h[i] = 0;
    long long incl = total;
    for (int off = 1; off < 32; off <<= 1) {
      const long long up = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += up;
    }
    const long long n = __shfl_sync(kFull, incl, 31);
    if (n == 0) {
      s.prefix = kSentinelKey;
      s.level = kPasses;
    } else {
      const long long rr = s.rank < 0 ? 0 : (s.rank >= n ? n - 1 : s.rank);
      long long below = incl - total, rem = 0;
      int bin = -1;
      if (below <= rr && rr < incl) {
        for (int i = 0; i < 8; ++i) {
          if (rr < below + local[i]) {
            bin = lane * 8 + i;
            rem = rr - below;
            break;
          }
          below += local[i];
        }
      }
      const int who = __ffs(__ballot_sync(kFull, bin >= 0)) - 1;
      bin = __shfl_sync(kFull, bin, who);
      rem = __shfl_sync(kFull, rem, who);
      s.prefix |= static_cast<uint32_t>(bin) << (24 - 8 * d);
      s.rank = rem;
      s.level = d + 1;
    }
  }
  if (lane == 0) {
    st[r * k_ranks + k] = s;
    if (d == kPasses - 1) out[r * k_ranks + k] = unkey(s.prefix);
  }
}

}  // namespace

// ------------------------------------------------------------- C interface
extern "C" {

const char* stainx_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x: (rows, p) float32 with +inf sentinels; ranks: (rows, k) int32; init:
// null or (rows, 3) int32 holding min key, max key (uint32 bits) and count;
// state: rows*k*16 bytes and hist: rows*k*256 int32 of scratch; out: (rows,
// k) float32. k <= 8, rows <= 65535. vec is 4 when p % 4 == 0 and x is
// 16-byte aligned, else 1. Returns cudaGetLastError().
int stainx_kth_smallest_streaming(const void* x, long long rows, long long p, const void* ranks,
                                  int k, const void* init, void* state, void* hist, void* out,
                                  int vec, int blocks_x, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  auto* st = static_cast<SelState*>(state);
  auto* h = static_cast<int*>(hist);
  const int64_t n = rows * k;
  select_init<<<static_cast<unsigned>((n + 255) / 256), 256, 0, s>>>(
      static_cast<const int*>(ranks), static_cast<const uint32_t*>(init), st, n, k);
  cudaMemsetAsync(h, 0, static_cast<size_t>(n) * kBins * sizeof(int), s);
  const dim3 grid(static_cast<unsigned>(blocks_x), static_cast<unsigned>(rows));
  const auto* xf = static_cast<const float*>(x);
  for (int d = 0; d < kPasses; ++d) {
    if (vec == 4) select_count<4><<<grid, kThreads, 0, s>>>(xf, p, k, st, h, d);
    else select_count<1><<<grid, kThreads, 0, s>>>(xf, p, k, st, h, d);
    select_pick<<<static_cast<unsigned>(rows), 32 * k, 0, s>>>(st, h, k, d,
                                                               static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
