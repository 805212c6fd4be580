// Exact nearest-rank selection, one thread-block cluster a row, for Hopper
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
//   Reading the field once: 4 bytes an element at 3.35 TB/s. At the staged
//   paths' shapes: (64, 512^2) K=2 0.0200 ms, (128, 512^2) K=1 0.0401,
//   (256, 224^2) K=2 0.0153, (512, 224^2) K=1 0.0307, and the staged 512^2
//   fit's (1, 512^2) K=2 0.0003 and (2, 512^2) K=1 0.0006: those two are a
//   lone row or two, bound in practice by one block's latency, not bytes.
//
// What the design does about it
//   The TPU kernel keeps a row in VMEM and runs a 4-bit descent on it. Here
//   a thread-block cluster of 1 to 16 blocks of 1024 threads takes a row
//   (kernels/selection.py cluster_shape: the largest cluster whose clusters
//   for all the rows run in at most two waves, so few or long rows spread
//   over the card and many rows take a block each). Block r of the cluster takes the
//   slice [r*S, (r+1)*S) of the row and keeps the monotone keys of its
//   first R elements in shared memory; the rest, if any, it reads again
//   from device memory (L2) at each pass. The descent is a radix select on
//   the uint32 monotone key:
//   - first read: every block keeps its keys and finds its smallest and
//     largest key below the sentinel and its count (integer max and add);
//     the cluster's are merged through distributed shared memory (DSMEM).
//     Ranks are clamped to the count (a rank past it takes the largest
//     element); a row with no element gives +inf, a row whose extremes are
//     equal gives that element, and otherwise the descent starts below the
//     extremes' common leading bits, so the first histogram already
//     separates the row's values (an angle field shares its top 8-10 bits);
//   - count: up to 8 bits a pass into a shared-memory histogram per distinct
//     prefix of the row's ranks, in 8 copies (lane l adds to copy l % 8,
//     copies a bank apart) with plain shared atomics: crowded bins conflict
//     at most 4 ways, and integer counts are exact in any order, so repeat
//     runs are bit-identical. The blocks' histograms are added through
//     DSMEM; every block adds them in the same way and picks the same bins
//     (a warp a rank), so one cluster.sync a pass is enough (histograms are
//     double-buffered);
//   - candidates: once a block's keys under the new prefixes fit kCand (its
//     own counts of the chosen bins say so exactly), the next pass also
//     stores them in shared memory, and the passes after it count only the
//     stored keys: a few hundred instead of the slice.
//   The result is unkey(prefix): an element of the row, bit for bit what
//   the plain version's sort reads at the clamped rank. Nothing goes back to
//   the host, so a call can be captured in a CUDA graph.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "keys.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace stainx;

constexpr int kThreads = 1024;
constexpr int kMaxK = 8;  // ranks a launch serves; the wrapper splits more
constexpr int kCopies = 8;  // histogram copies a block counts into
constexpr int kCand = 4096;  // keys a block stores once they are all its candidates
constexpr int kUnroll = 4;  // 16-byte groups a thread loads before it counts them

// What a block's pass reads: its slice, its slice while storing the
// candidates' keys, or only the stored keys.
enum CandState { kSweep = 0, kCollect = 1, kFromBuffer = 2 };

// The head of a block's dynamic shared memory (kernels/selection.py
// STATE_BYTES); the histogram copies, the block's histograms (double-
// buffered), the merged histograms, the candidates and the resident keys
// follow it.
struct RowsShared {
  uint32_t prefix[kMaxK];       // key bits chosen so far, per rank
  long long rank[kMaxK];        // rank left under the prefix
  uint32_t slot_prefix[kMaxK];  // the prefix each histogram slot counts
  int slot[kMaxK];              // the histogram slot of each rank
  int slots;                    // distinct prefixes at this pass
  int top;                      // key bits left to choose; 0: known, -1: no element
  unsigned lo_not, hi, cnt;     // this block's ~min key, max key and count
  unsigned cand_count;          // stored candidates
  int cand_state;               // CandState of the next pass
  int pad[1];
};
constexpr int kStateBytes = 192;
static_assert(sizeof(RowsShared) == kStateBytes, "RowsShared layout");

// 32-bit words of shared memory after RowsShared and before the resident
// keys, for k ranks (a multiple of 4, so the keys start 16-byte aligned).
__host__ __device__ constexpr int64_t copy_stride(int k) { return k * kBins + 1; }
__host__ __device__ constexpr int64_t copy_words(int k) {
  return (kCopies * copy_stride(k) + 3) / 4 * 4;
}
__host__ __device__ constexpr int64_t fixed_words(int k) {
  return copy_words(k) + 3 * k * kBins + kCand;
}

// A block's share of its row: elements [begin, begin + n) of the row (src
// points at the first), S of them in all with the ragged tail padded, the
// first R with their keys in shared memory.
struct Slice {
  const float* src;
  int64_t n, S, R;
};

template <bool Vec>
__device__ __forceinline__ void load4(const Slice& sl, int64_t g, uint32_t (&k)[4]) {
  const int64_t q = 4 * g;
  if (Vec) {  // n is a multiple of 4: a group is all in or all out
    if (q < sl.n) {
      const float4 v = reinterpret_cast<const float4*>(sl.src)[g];
      k[0] = monotone_key(v.x);
      k[1] = monotone_key(v.y);
      k[2] = monotone_key(v.z);
      k[3] = monotone_key(v.w);
    } else {
      k[0] = k[1] = k[2] = k[3] = kNoKey;
    }
  } else {
    for (int j = 0; j < 4; ++j) k[j] = q + j < sl.n ? monotone_key(sl.src[q + j]) : kNoKey;
  }
}

// Calls f(key) for every key of the block's slice: the resident ones from
// shared memory, the rest from device memory (kUnroll groups of 4 in flight
// a thread). Padding keys are kNoKey.
template <bool Vec, typename F>
__device__ __forceinline__ void slice_keys(const Slice& sl, const uint32_t* keys, F&& f) {
  const int64_t res = sl.R / 4, all = sl.S / 4;
  for (int64_t g = threadIdx.x; g < res; g += kThreads) {
    const uint4 q = reinterpret_cast<const uint4*>(keys)[g];
    f(q.x);
    f(q.y);
    f(q.z);
    f(q.w);
  }
  for (int64_t g0 = res; g0 < all; g0 += kThreads * kUnroll) {
    uint32_t k[kUnroll][4];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t g = g0 + u * kThreads + threadIdx.x;
      if (g < all) {
        load4<Vec>(sl, g, k[u]);
      } else {
        k[u][0] = k[u][1] = k[u][2] = k[u][3] = kNoKey;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      for (int j = 0; j < 4; ++j) f(k[u][j]);
  }
}

// The first read: the resident keys into shared memory, and the block's
// smallest and largest key below the sentinel and its count into sh.
template <bool Vec>
__device__ void first_read(const Slice& sl, uint32_t* keys, RowsShared& sh) {
  unsigned lo_not = 0u, hi = 0u, cnt = 0u;
  const int64_t all = sl.S / 4;
  for (int64_t g0 = 0; g0 < all; g0 += kThreads * kUnroll) {
    uint32_t k[kUnroll][4];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t g = g0 + u * kThreads + threadIdx.x;
      if (g < all) {
        load4<Vec>(sl, g, k[u]);
      } else {
        k[u][0] = k[u][1] = k[u][2] = k[u][3] = kNoKey;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t g = g0 + u * kThreads + threadIdx.x;
      if (4 * g < sl.R) {
        reinterpret_cast<uint4*>(keys)[g] = make_uint4(k[u][0], k[u][1], k[u][2], k[u][3]);
      }
      for (int j = 0; j < 4; ++j) {
        if (k[u][j] < kSentinelKey) {
          lo_not = max(lo_not, ~k[u][j]);
          hi = max(hi, k[u][j]);
          ++cnt;
        }
      }
    }
  }
  lo_not = __reduce_max_sync(kFull, lo_not);
  hi = __reduce_max_sync(kFull, hi);
  cnt = __reduce_add_sync(kFull, cnt);
  if ((threadIdx.x & 31) == 0) {
    atomicMax(&sh.lo_not, lo_not);
    atomicMax(&sh.hi, hi);
    atomicAdd(&sh.cnt, cnt);
  }
}

// Thread 0: the row's extremes and count from every block of the cluster,
// the ranks clamped to the count, and the descent's start.
__device__ void start_descent(RowsShared& sh, const int* ranks, int k_ranks,
                              cg::cluster_group& cluster) {
  unsigned lo_not = 0u, hi = 0u;
  long long cnt = 0;
  for (unsigned q = 0; q < cluster.num_blocks(); ++q) {
    const RowsShared* other = cluster.map_shared_rank(&sh, q);
    lo_not = max(lo_not, other->lo_not);
    hi = max(hi, other->hi);
    cnt += other->cnt;
  }
  if (cnt == 0) {
    sh.top = -1;
    return;
  }
  const uint32_t lo = ~lo_not;
  uint32_t prefix = lo;
  sh.top = lo == hi ? 0 : common_top(lo, hi, prefix);
  for (int k = 0; k < k_ranks; ++k) {
    const long long r = ranks[k];
    sh.rank[k] = r < 0 ? 0 : (r >= cnt ? cnt - 1 : r);
    sh.prefix[k] = prefix;
    sh.slot[k] = 0;
  }
  sh.slot_prefix[0] = prefix;
  sh.slots = 1;
}

// Adds one to the histogram copy of the calling lane for key k, in the slot
// whose prefix it lies under (distinct slots have distinct prefixes, so at
// most one), and returns whether it was counted.
__device__ __forceinline__ bool count_key(uint32_t k, const RowsShared& sh, int top,
                                          unsigned* copy, int slots) {
  if (k >= kSentinelKey) return false;
  for (int s = 0; s < slots; ++s) {
    if (under_prefix(k, sh.slot_prefix[s], top)) {
      atomicAdd(copy + s * kBins + digit_at(k, top), 1u);
      return true;
    }
  }
  return false;
}

// Row blockIdx.x / cluster size: the K values at ranks[row, :] among its
// elements below +inf. Block r of the cluster takes elements [r*S, (r+1)*S)
// of the row, the first R of them resident.
template <bool Vec>
__global__ void __launch_bounds__(kThreads, 1)
select_rows(const float* __restrict__ x, int64_t p, const int* __restrict__ ranks, int k_ranks,
            float* __restrict__ out, int64_t S, int64_t R) {
  extern __shared__ __align__(16) unsigned char smem[];
  RowsShared& sh = *reinterpret_cast<RowsShared*>(smem);
  unsigned* rep = reinterpret_cast<unsigned*>(smem + kStateBytes);
  unsigned* hist = rep + copy_words(k_ranks);  // [2][k][kBins]
  unsigned* merged = hist + 2 * k_ranks * kBins;  // [k][kBins]
  uint32_t* cand = merged + k_ranks * kBins;
  uint32_t* keys = cand + kCand;
  cg::cluster_group cluster = cg::this_cluster();
  const int64_t row = blockIdx.x / cluster.num_blocks();
  const int64_t begin = static_cast<int64_t>(cluster.block_rank()) * S;
  const int64_t n = begin < p ? (p - begin < S ? p - begin : S) : 0;
  const Slice sl{x + row * p + begin, n, S, R};
  unsigned* copy = rep + (threadIdx.x & (kCopies - 1)) * copy_stride(k_ranks);

  for (int i = threadIdx.x; i < copy_words(k_ranks); i += kThreads) rep[i] = 0u;
  if (threadIdx.x == 0) {
    sh.lo_not = sh.hi = sh.cnt = 0u;
    sh.cand_state = kSweep;
  }
  __syncthreads();
  first_read<Vec>(sl, keys, sh);
  cluster.sync();
  if (threadIdx.x == 0) start_descent(sh, ranks + row * k_ranks, k_ranks, cluster);
  __syncthreads();

  for (int pass = 0; sh.top > 0; ++pass) {  // the same passes in every block of the cluster
    const int top = sh.top, slots = sh.slots, state = sh.cand_state;
    unsigned* own = hist + (pass & 1) * k_ranks * kBins;
    if (state == kFromBuffer) {
      for (unsigned i = threadIdx.x; i < sh.cand_count; i += kThreads) {
        count_key(cand[i], sh, top, copy, slots);
      }
    } else if (state == kCollect) {
      slice_keys<Vec>(sl, keys, [&](uint32_t k) {
        if (count_key(k, sh, top, copy, slots)) {
          const unsigned i = atomicAdd(&sh.cand_count, 1u);
          if (i < kCand) cand[i] = k;  // always: the block's own counts bound them
        }
      });
    } else {
      slice_keys<Vec>(sl, keys, [&](uint32_t k) { count_key(k, sh, top, copy, slots); });
    }
    __syncthreads();
    for (int i = threadIdx.x; i < slots * kBins; i += kThreads) {
      unsigned c = 0u;
      for (int q = 0; q < kCopies; ++q) {
        c += rep[q * copy_stride(k_ranks) + i];
        rep[q * copy_stride(k_ranks) + i] = 0u;
      }
      own[i] = c;
    }
    cluster.sync();
    for (int i = threadIdx.x; i < slots * kBins; i += kThreads) {
      unsigned c = 0u;
#pragma unroll 4  // the remote loads in flight together
      for (unsigned q = 0; q < cluster.num_blocks(); ++q) c += cluster.map_shared_rank(own, q)[i];
      merged[i] = c;
    }
    __syncthreads();
    const int warp = threadIdx.x >> 5, shift = digit_shift(top);
    if (warp < k_ranks) {
      unsigned bin;
      long long rem;
      warp_pick(merged + sh.slot[warp] * kBins, sh.rank[warp], bin, rem);
      if ((threadIdx.x & 31) == 0) {
        sh.prefix[warp] |= bin << shift;
        sh.rank[warp] = rem;
      }
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      // The block's keys under the new prefixes: its own counts of the
      // chosen bins, one for each distinct new prefix.
      unsigned stored = 0u;
      int s_new = 0;
      for (int k = 0; k < k_ranks; ++k) {  // slot_prefix[0, s_new) holds new prefixes
        int s = 0;
        while (s < s_new && sh.slot_prefix[s] != sh.prefix[k]) ++s;
        if (s == s_new) {
          stored += own[sh.slot[k] * kBins + digit_at(sh.prefix[k], top)];
          sh.slot_prefix[s_new++] = sh.prefix[k];
        }
        sh.slot[k] = s;
      }
      sh.slots = s_new;
      sh.top = shift;
      if (state != kSweep) {
        sh.cand_state = kFromBuffer;  // the stored keys hold every later candidate
      } else if (shift > 0 && stored <= static_cast<unsigned>(kCand)) {
        sh.cand_state = kCollect;
        sh.cand_count = 0u;
      }
    }
    __syncthreads();
  }
  if (cluster.block_rank() == 0 && static_cast<int>(threadIdx.x) < k_ranks) {
    out[row * k_ranks + threadIdx.x] =
        sh.top < 0 ? __int_as_float(0x7F800000) : unkey(sh.prefix[threadIdx.x]);
  }
  cluster.sync();  // no block leaves while another still reads its shared memory
}

using RowsKernel = void (*)(const float*, int64_t, const int*, int, float*, int64_t, int64_t);

// Sets the kernel's shared memory for k ranks and R resident keys a block
// and allows clusters of 16 (past the portable 8), and fills cfg for `rows`
// clusters of csize blocks.
cudaError_t rows_config(RowsKernel kernel, long long rows, int csize, int k, long long R,
                        cudaStream_t s, cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr) {
  const size_t smem = kStateBytes + 4 * static_cast<size_t>(fixed_words(k) + R);
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e == cudaSuccess) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(rows * csize));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = static_cast<unsigned>(csize);
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return e;
}

RowsKernel rows_kernel(int vec) { return vec == 4 ? select_rows<true> : select_rows<false>; }

}  // namespace

// ------------------------------------------------------------- C interface
extern "C" {

const char* stainx_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x: (rows, p) float32 with +inf sentinels, 1 <= p < 2^31; ranks: (rows, k)
// int32; out: (rows, k) float32; 1 <= k <= 8. One cluster of csize blocks a
// row (rows * csize < 2^31), a slice of S elements a block (a multiple of
// 4, csize * S >= p), the first R (a multiple of 4, at most S) resident.
// vec is 4 when p % 4 == 0 and x is 16-byte aligned, else 1. Returns a
// CUDA error code (cudaGetLastError() after the launch).
int stainx_kth_smallest_rows(const void* x, long long rows, long long p, const void* ranks, int k,
                             void* out, int vec, int csize, long long S, long long R,
                             void* stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  const RowsKernel kernel = rows_kernel(vec);
  cudaError_t e = rows_config(kernel, rows, csize, k, R, static_cast<cudaStream_t>(stream), cfg,
                              attr);
  if (e == cudaSuccess) {
    e = cudaLaunchKernelEx(&cfg, kernel, static_cast<const float*>(x), static_cast<int64_t>(p),
                           static_cast<const int*>(ranks), k, static_cast<float*>(out),
                           static_cast<int64_t>(S), static_cast<int64_t>(R));
  }
  if (e != cudaSuccess) {
    cudaGetLastError();  // clear it: the wrapper raises
    return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}

// Clusters of csize blocks, each with k ranks and R resident keys, that the
// current card holds at once (cudaOccupancyMaxActiveClusters).
int stainx_kth_smallest_rows_occupancy(int csize, int k, long long R, void* clusters) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  const RowsKernel kernel = rows_kernel(4);
  cudaError_t e = rows_config(kernel, 1, csize, k, R, nullptr, cfg, attr);
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveClusters(static_cast<int*>(clusters),
                                       reinterpret_cast<const void*>(kernel), &cfg);
  }
  if (e != cudaSuccess) cudaGetLastError();
  return static_cast<int>(e);
}

}  // extern "C"
