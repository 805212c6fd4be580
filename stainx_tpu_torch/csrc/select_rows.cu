// Exact nearest-rank selection, one thread block per row, for Hopper
// (sm_90a), with a plain C interface loaded through ctypes
// (stainx_tpu_torch/kernels/selection.py).
//
// What it replaces
//   stainx_tpu/kernels/selection.py::kth_smallest_pallas (_select_kernel),
//   B3: K nearest-rank selections per row of an (R, P) float32 field with
//   +inf sentinels. The staged Macenko pipeline (bfloat16, float16 and
//   float64 input) calls it for the two angle percentiles (K = 2 a row) and
//   the 99th-percentile concentrations (K = 1, two rows an image).
//
// What bounds it
//   Reading the field once: 4 bytes an element, 0.040 ms for (128, 262 144)
//   at 3.35 TB/s. The counting is one warp-aggregated shared-memory atomic
//   per element and pass.
//
// What the design does about it
//   The TPU kernel keeps a row in VMEM and runs a 4-bit descent on it. Here
//   one block of 1024 threads takes a row (B3's regime: many rows of
//   moderate length; B6 in selection.cu spreads a few long rows over the
//   card), and the descent is a radix select on the uint32 monotone key,
//   8 bits a pass:
//   - residency: where the row's keys fit the block's shared memory (opt-in
//     up to 227 KB: rows of up to ~56 K elements, a 224^2 image's 50 176),
//     pass 0 reads the row from device memory once and keeps its keys, and
//     passes 1-3 run on shared memory. Longer rows are read again from
//     device memory (and L2) at each pass. A thread issues 4 loads of 16
//     bytes before it counts them, so one block keeps enough bytes in
//     flight;
//   - count: a shared-memory histogram per distinct prefix of the row's
//     ranks (ranks that share a prefix share one, so pass 0 counts once for
//     all K), filled by warp-aggregated integer atomics: exact in any order,
//     so repeat runs are bit-identical;
//   - pick: warp k scans the 256 bins of rank k's histogram, clamps the
//     rank to the count at pass 0 (a rank past the count takes the row's
//     largest element; a row with no element gives +inf), and carries the
//     prefix and the rank left inside it. Nothing goes back to the host, so
//     a call can be captured in a CUDA graph.
//   The result is unkey(prefix): an element of the row, bit for bit what
//   the plain version's sort reads at the clamped rank.

#include <cuda_runtime.h>

#include <cstdint>

#include "keys.cuh"

namespace {

using namespace stainx;

constexpr int kThreads = 1024;
constexpr int kMaxK = 8;  // ranks a launch serves; the wrapper splits more
constexpr int kPasses = 4;
constexpr int kUnroll = 4;  // groups a thread loads before it counts them
constexpr int kHistWords = kMaxK * kBins;  // one histogram per distinct prefix
constexpr int kMaxDevices = 64;

struct RowState {
  uint32_t prefix[kMaxK];       // key bits chosen so far, per rank
  long long rank[kMaxK];        // rank left inside the prefix
  uint32_t slot_prefix[kMaxK];  // the prefix each histogram slot counts
  int slot[kMaxK];              // the histogram slot of each rank
  int slots;                    // distinct prefixes at this pass
  int empty;                    // the row holds no element below +inf
};

template <int V>
__device__ __forceinline__ void load_keys(const float* row, int64_t g, bool ok, uint32_t (&key)[V]) {
  if constexpr (V == 4) {
    const float4 q = ok ? reinterpret_cast<const float4*>(row)[g] : make_float4(0, 0, 0, 0);
    key[0] = monotone_key(q.x);
    key[1] = monotone_key(q.y);
    key[2] = monotone_key(q.z);
    key[3] = monotone_key(q.w);
  } else {
    key[0] = monotone_key(ok ? row[g] : 0.0f);
  }
}

template <int V>
__device__ __forceinline__ void cached_keys(const uint32_t* cache, int64_t g, bool ok,
                                            uint32_t (&key)[V]) {
  if constexpr (V == 4) {
    const uint4 q = ok ? reinterpret_cast<const uint4*>(cache)[g] : make_uint4(0, 0, 0, 0);
    key[0] = q.x;
    key[1] = q.y;
    key[2] = q.z;
    key[3] = q.w;
  } else {
    key[0] = ok ? cache[g] : 0u;
  }
}

template <int V>
__device__ __forceinline__ void cache_keys(uint32_t* cache, int64_t g, const uint32_t (&key)[V]) {
  if constexpr (V == 4) {
    reinterpret_cast<uint4*>(cache)[g] = make_uint4(key[0], key[1], key[2], key[3]);
  } else {
    cache[g] = key[0];
  }
}

// Adds the pass-d digit of each key below +inf to the histogram of the slot
// whose prefix it matches (distinct slots have distinct prefixes, so at most
// one); a warp with no such key skips the add. Every thread of the block
// calls it the same number of times.
template <int V>
__device__ __forceinline__ void count_keys(const uint32_t (&key)[V], bool ok, int d,
                                           const RowState& st, unsigned* hist) {
  const int shift = 24 - 8 * d;
  const unsigned bins = static_cast<unsigned>(st.slots) * kBins;
  for (int j = 0; j < V; ++j) {
    unsigned bin = bins;  // none
    if (ok && key[j] < kSentinelKey) {
      if (d == 0) {
        bin = key[j] >> 24;
      } else {
        for (int s = 0; s < st.slots; ++s) {
          if (((key[j] ^ st.slot_prefix[s]) >> (shift + 8)) == 0u) {
            bin = s * kBins + ((key[j] >> shift) & 0xFFu);
          }
        }
      }
    }
    if (__any_sync(kFull, bin < bins)) hist_add(hist, bin, bins);  // warp-uniform
  }
}

// Pass d's pick, warp k for rank k: the bin of its slot's histogram that
// holds its rank joins the prefix, and the rank left inside that bin is
// kept. At pass 0 the histogram counts every element below +inf: the rank
// is clamped to that count, and a row with none is marked empty.
__device__ __forceinline__ void pick(RowState& st, const unsigned* hist, int k_ranks, int d) {
  const int k = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (k >= k_ranks) return;  // warp-uniform
  const long long want = st.rank[k];
  const unsigned* h = hist + st.slot[k] * kBins + lane * 8;
  unsigned local[8];
  long long total = 0;
  for (int i = 0; i < 8; ++i) {
    local[i] = h[i];
    total += local[i];
  }
  long long incl = total;
  for (int off = 1; off < 32; off <<= 1) {
    const long long up = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += up;
  }
  const long long n = __shfl_sync(kFull, incl, 31);
  if (n == 0) {  // pass 0 only: no element below +inf
    if (lane == 0) st.empty = 1;
    return;
  }
  const long long rr = want < 0 ? 0 : (want >= n ? n - 1 : want);
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
  if (lane == 0) {
    st.prefix[k] |= static_cast<uint32_t>(bin) << (24 - 8 * d);
    st.rank[k] = rem;
  }
}

// Row blockIdx.x: the K values at ranks[row, :] among its elements below
// +inf. Dynamic shared memory: kHistWords histogram words, then, when
// kResident, the row's p keys.
template <int V, bool kResident>
__global__ void __launch_bounds__(kThreads)
select_rows(const float* __restrict__ x, int64_t p, const int* __restrict__ ranks, int k_ranks,
            float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned smem[];
  unsigned* hist = smem;
  uint32_t* cache = smem + kHistWords;
  __shared__ RowState st;
  const int64_t r = blockIdx.x;
  const float* row = x + r * p;
  const int64_t groups = p / V;

  for (int i = threadIdx.x; i < kBins; i += kThreads) hist[i] = 0u;
  if (threadIdx.x < k_ranks) {
    st.prefix[threadIdx.x] = 0u;
    st.rank[threadIdx.x] = ranks[r * k_ranks + threadIdx.x];
    st.slot[threadIdx.x] = 0;
  }
  if (threadIdx.x == 0) {
    st.slots = 1;
    st.slot_prefix[0] = 0u;
    st.empty = 0;
  }
  __syncthreads();

  for (int d = 0; d < kPasses; ++d) {
    if (d > 0) {
      if (threadIdx.x == 0) {
        int slots = 0;
        for (int k = 0; k < k_ranks; ++k) {
          int s = 0;
          while (s < slots && st.slot_prefix[s] != st.prefix[k]) ++s;
          if (s == slots) st.slot_prefix[slots++] = st.prefix[k];
          st.slot[k] = s;
        }
        st.slots = slots;
      }
      __syncthreads();
      for (int i = threadIdx.x; i < st.slots * kBins; i += kThreads) hist[i] = 0u;
      __syncthreads();
    }
    for (int64_t g0 = 0; g0 < groups; g0 += kThreads * kUnroll) {
      uint32_t key[kUnroll][V];
      bool ok[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {  // all loads in flight before any count
        const int64_t g = g0 + u * kThreads + threadIdx.x;
        ok[u] = g < groups;
        if (kResident && d > 0) {
          cached_keys<V>(cache, g, ok[u], key[u]);
        } else {
          load_keys<V>(row, g, ok[u], key[u]);
          if (kResident && ok[u]) cache_keys<V>(cache, g, key[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) count_keys<V>(key[u], ok[u], d, st, hist);
    }
    __syncthreads();
    pick(st, hist, k_ranks, d);
    __syncthreads();
    if (st.empty) {  // block-uniform
      if (threadIdx.x < k_ranks) out[r * k_ranks + threadIdx.x] = __int_as_float(0x7F800000);
      return;
    }
  }
  if (threadIdx.x < k_ranks) out[r * k_ranks + threadIdx.x] = unkey(st.prefix[threadIdx.x]);
}

// The longest row whose keys a block keeps in shared memory on the current
// device: the opt-in maximum less the static state and the histograms.
cudaError_t resident_max(long long* out) {
  static long long cached[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < kMaxDevices && cached[dev] > 0) {
    *out = cached[dev];
    return cudaSuccess;
  }
  int optin = 0;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return e;
  cudaFuncAttributes fa;
  e = cudaFuncGetAttributes(&fa, select_rows<4, true>);
  if (e != cudaSuccess) return e;
  const long long words =
      (static_cast<long long>(optin) - static_cast<long long>(fa.sharedSizeBytes)) / 4;
  *out = words - kHistWords;
  if (dev < kMaxDevices) cached[dev] = *out;
  return cudaSuccess;
}

template <int V, bool kResident>
cudaError_t launch(const float* x, long long rows, long long p, const int* ranks, int k,
                   float* out, cudaStream_t s) {
  const size_t smem = sizeof(unsigned) * (kHistWords + (kResident ? p : 0));
  if (kResident) {
    const cudaError_t e = cudaFuncSetAttribute(
        select_rows<V, kResident>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  select_rows<V, kResident><<<static_cast<unsigned>(rows), kThreads, smem, s>>>(x, p, ranks, k,
                                                                               out);
  return cudaGetLastError();
}

}  // namespace

// ------------------------------------------------------------- C interface
extern "C" {

const char* stainx_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Writes to *out the longest row (in elements) that a block keeps resident
// in shared memory on the current device. Returns a CUDA error code.
int stainx_kth_smallest_rows_resident_max(long long* out) {
  return static_cast<int>(resident_max(out));
}

// x: (rows, p) float32 with +inf sentinels, 1 <= p < 2^31; ranks: (rows, k)
// int32; out: (rows, k) float32. 1 <= k <= 8, 1 <= rows < 2^31. vec is 4
// when p % 4 == 0 and x is 16-byte aligned, else 1. Returns a CUDA error
// code (cudaGetLastError() after the launch).
int stainx_kth_smallest_rows(const void* x, long long rows, long long p, const void* ranks, int k,
                             void* out, int vec, void* stream) {
  long long cap = 0;
  cudaError_t e = resident_max(&cap);
  if (e != cudaSuccess) return static_cast<int>(e);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* xf = static_cast<const float*>(x);
  const auto* rk = static_cast<const int*>(ranks);
  auto* o = static_cast<float*>(out);
  const bool resident = p <= cap;
  if (vec == 4) {
    e = resident ? launch<4, true>(xf, rows, p, rk, k, o, s) : launch<4, false>(xf, rows, p, rk, k, o, s);
  } else {
    e = resident ? launch<1, true>(xf, rows, p, rk, k, o, s) : launch<1, false>(xf, rows, p, rk, k, o, s);
  }
  return static_cast<int>(e);
}

}  // extern "C"
