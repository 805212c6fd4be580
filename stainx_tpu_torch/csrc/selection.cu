// Exact multi-block rank selection for Hopper (sm_90a), with a plain C
// interface loaded through ctypes (stainx_tpu_torch/kernels/selection_stream.py).
//
// What it replaces
//   stainx_tpu/kernels/selection_stream.py::kth_smallest_streaming
//   (_stream_kernel), B6: K nearest-rank selections per row of an (R, P)
//   float32 field with +inf sentinels, rows of any length and any number of
//   rows, with an optional per-row (min, max, count) init. The staged
//   Macenko route runs it on few long rows (stainx_tpu_torch/ops/macenko.py
//   select_route); B4 and B5 select inside their own kernels
//   (macenko_stream.cu).
//
// What bounds it
//   Reading the field once: 4 bytes an element, 0.0153 ms for path (d)'s
//   (1, 12 845 056) angle field and 0.0307 ms for its (2, 12 845 056)
//   concentrations at 3.35 TB/s. Those fields (51 and 103 MB) are larger
//   than the 50 MB L2, so every read of them goes to device memory.
//
// What the design does about it
//   The TPU kernel walks one row per grid step through a 6-cut interval
//   descent, a ladder tuned against TPU sync costs. Here a row is split
//   across many 256-thread blocks (rows folded into the grid's x extent, so
//   any number of rows fits), and the descent is a radix select on the
//   uint32 monotone key. One C call: a memset, a read for the row's
//   extremes and count (none when an init is given), and 4 pass launches:
//   - start: the last block of a row to finish the extremes read (a per-row
//     ticket) clamps the ranks to the count (a rank past it takes the
//     largest element), writes +inf for a row with no element and the
//     element itself for a row whose extremes are equal, and otherwise
//     starts the descent below the extremes' common leading bits, so the
//     first histogram already separates the row's values. With an init,
//     every block of the first pass derives the same start from it;
//   - count: every block counts up to 8 key bits a pass into shared-memory
//     histograms (one per distinct prefix of the row's ranks, 8 copies,
//     plain shared atomics) and adds their non-zero bins into the row's
//     device histogram with integer atomics: exact and independent of block
//     order, so repeat runs are bit-identical;
//   - pick: the row's last block to finish a pass picks each rank's bin (a
//     warp a rank), clears the histogram and carries prefix and rank on, all
//     on the device: no pick launch and no host sync, so the whole
//     selection can be captured in a CUDA graph;
//   - candidates: once the keys under the new prefixes fit the row's
//     candidate buffer in device memory (at most 2^20 keys a row), the next
//     pass also appends them there (staged in shared memory, one global
//     atomicAdd a block for their offset; the order does not matter to an
//     exact count), and the passes after it read only the buffer. On the
//     staged route's fields that is after the first pass: 2 reads of the
//     field with an init, 3 without, instead of 4.
//   Passes a row does not need return at once. The result is unkey(prefix),
//   an element of the data.

#include <cuda_runtime.h>

#include <cstdint>

#include "keys.cuh"

namespace {

using namespace stainx;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxK = 8;  // ranks a launch serves; the wrapper splits more
constexpr int kCopies = 8;  // histogram copies a block counts into
constexpr int kStage = 2048;  // candidates a block stages before it appends them
constexpr int kPasses = 4;  // 32 key bits, up to 8 a pass

// What a pass of a row reads: the field, the field while appending the
// candidates' keys to the buffer, or only the buffer.
enum Source { kSweep = 0, kCollect = 1, kFromBuffer = 2 };

// The descent of a row, carried from pass to pass in device memory
// (kernels/selection_stream.py STATE_BYTES).
struct SelRow {
  uint32_t prefix[kMaxK];       // key bits chosen so far, per rank
  long long rank[kMaxK];        // rank left under the prefix
  uint32_t slot_prefix[kMaxK];  // the prefix each histogram slot counts
  int slot[kMaxK];              // the histogram slot of each rank
  int slots;                    // distinct prefixes at this pass
  int top;                      // key bits left to choose; 0: known, -1: no element
  int source;                   // Source of the next pass
  int pad;
};
static_assert(sizeof(SelRow) == 176, "SelRow layout");

// A row's counters, zeroed by the call's memset (COUNTER_BYTES): its
// ~min key, max key and count below the sentinel, the ticket of its blocks
// and the keys in its candidate buffer.
struct RowCount {
  unsigned lo_not, hi, cnt, ticket, cand_n, pad[3];
};
static_assert(sizeof(RowCount) == 32, "RowCount layout");

// Thread 0: the start of a row's descent from its extremes and count (see
// the head of the file).
__device__ void start_row(SelRow& s, uint32_t lo, uint32_t hi, long long cnt, const int* ranks,
                          int k_ranks) {
  s.source = kSweep;
  if (cnt <= 0) {
    s.top = -1;
    return;
  }
  uint32_t prefix = lo;
  s.top = lo == hi ? 0 : common_top(lo, hi, prefix);
  for (int k = 0; k < k_ranks; ++k) {
    const long long r = ranks[k];
    s.rank[k] = r < 0 ? 0 : (r >= cnt ? cnt - 1 : r);
    s.prefix[k] = prefix;
    s.slot[k] = 0;
  }
  s.slot_prefix[0] = prefix;
  s.slots = 1;
}

// Threads below k_ranks: the row's values once its descent has ended.
__device__ __forceinline__ void write_out(const SelRow& s, float* out_row, int k_ranks) {
  if (static_cast<int>(threadIdx.x) < k_ranks) {
    out_row[threadIdx.x] = s.top < 0 ? __int_as_float(0x7F800000) : unkey(s.prefix[threadIdx.x]);
  }
}

// The items [begin, end) of n that part blockIdx.x % bx of a row covers.
struct Span {
  int64_t begin, end;
};

__device__ __forceinline__ Span part_span(int64_t n, int bx) {
  const int64_t per = (n + bx - 1) / bx;
  const int64_t begin = static_cast<int64_t>(blockIdx.x % bx) * per;
  return {begin, begin + per < n ? begin + per : n};
}

// The keys of group g of a row (V floats; kNoKey past the span's end).
template <int V>
__device__ __forceinline__ void group_keys(const float* row, int64_t g, bool ok,
                                           uint32_t (&k)[V]) {
  if constexpr (V == 4) {
    const float4 q = ok ? reinterpret_cast<const float4*>(row)[g] : make_float4(0, 0, 0, 0);
    k[0] = ok ? monotone_key(q.x) : kNoKey;
    k[1] = ok ? monotone_key(q.y) : kNoKey;
    k[2] = ok ? monotone_key(q.z) : kNoKey;
    k[3] = ok ? monotone_key(q.w) : kNoKey;
  } else {
    k[0] = ok ? monotone_key(row[g]) : kNoKey;
  }
}

// The row's extremes and count (no init given): every block adds its share
// into the row's counters; the last one starts the descent.
template <int V>
__global__ void __launch_bounds__(kThreads)
select_extremes(const float* __restrict__ x, int64_t p, int bx, const int* __restrict__ ranks,
                int k_ranks, RowCount* __restrict__ counts, SelRow* __restrict__ state,
                float* __restrict__ out) {
  __shared__ unsigned part[3][kWarps];
  __shared__ SelRow s;
  const int64_t row = blockIdx.x / bx;
  const float* src = x + row * p;
  const Span sp = part_span(p / V, bx);
  unsigned lo_not = 0u, hi = 0u, cnt = 0u;
  for (int64_t g = sp.begin + threadIdx.x; g < sp.end; g += kThreads) {
    uint32_t k[V];
    group_keys<V>(src, g, true, k);
    for (int j = 0; j < V; ++j) {
      if (k[j] < kSentinelKey) {
        lo_not = max(lo_not, ~k[j]);
        hi = max(hi, k[j]);
        ++cnt;
      }
    }
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  lo_not = __reduce_max_sync(kFull, lo_not);
  hi = __reduce_max_sync(kFull, hi);
  cnt = __reduce_add_sync(kFull, cnt);
  if (lane == 0) {
    part[0][warp] = lo_not;
    part[1][warp] = hi;
    part[2][warp] = cnt;
  }
  __syncthreads();
  RowCount& rc = counts[row];
  if (threadIdx.x == 0) {
    for (int w = 1; w < kWarps; ++w) {
      lo_not = max(lo_not, part[0][w]);
      hi = max(hi, part[1][w]);
      cnt += part[2][w];
    }
    atomicMax(&rc.lo_not, lo_not);
    atomicMax(&rc.hi, hi);
    atomicAdd(&rc.cnt, cnt);
  }
  if (!last_of_row(&rc.ticket, static_cast<unsigned>(bx))) return;
  if (threadIdx.x == 0) {
    start_row(s, ~__ldcg(&rc.lo_not), __ldcg(&rc.hi), __ldcg(&rc.cnt), ranks + row * k_ranks,
              k_ranks);
    state[row] = s;
  }
  __syncthreads();
  if (s.top <= 0) write_out(s, out + row * k_ranks, k_ranks);
}

// Adds one to the calling lane's histogram copy for key k, in the slot whose
// prefix it lies under (at most one), and returns whether it was counted.
__device__ __forceinline__ bool count_key(uint32_t k, const SelRow& s, int top, unsigned* copy) {
  if (k >= kSentinelKey) return false;
  for (int i = 0; i < s.slots; ++i) {
    if (under_prefix(k, s.slot_prefix[i], top)) {
      atomicAdd(copy + i * kBins + digit_at(k, top), 1u);
      return true;
    }
  }
  return false;
}

// Appends the block's n staged candidates to the row's buffer at an offset
// taken by one atomicAdd. Every thread of the block calls it.
__device__ void flush_stage(const uint32_t* stage, unsigned n, unsigned* cand_n, uint32_t* buf,
                            int64_t cap) {
  __shared__ unsigned base;
  if (threadIdx.x == 0) base = atomicAdd(cand_n, n);
  __syncthreads();
  for (unsigned i = threadIdx.x; i < n; i += kThreads) {
    if (base + i < cap) buf[base + i] = stage[i];  // always: the pick bounds the candidates
  }
  __syncthreads();
}

// One pass of every row still descending. With first and an init, every
// block derives the row's start from the init (rows init[3r .. 3r+2]: min
// key, max key, count); otherwise the state the last pass (or
// select_extremes) left. Dynamic shared memory: kCopies histogram copies of
// k * kBins + 1 words, then kStage staged candidates.
template <int V>
__global__ void __launch_bounds__(kThreads)
select_pass(const float* __restrict__ x, int64_t p, int bx, const int* __restrict__ ranks,
            int k_ranks, const uint32_t* __restrict__ init, int first,
            RowCount* __restrict__ counts, SelRow* __restrict__ state,
            unsigned* __restrict__ hist, uint32_t* __restrict__ cand, int64_t cap,
            float* __restrict__ out) {
  extern __shared__ unsigned dyn[];
  const int64_t stride = static_cast<int64_t>(k_ranks) * kBins + 1;
  unsigned* rep = dyn;
  uint32_t* stage = dyn + kCopies * stride;
  __shared__ SelRow s;
  __shared__ unsigned stage_n;
  const int64_t row = blockIdx.x / bx;
  RowCount& rc = counts[row];
  if (threadIdx.x == 0) {
    if (first && init != nullptr) {
      const uint32_t* in = init + 3 * row;
      start_row(s, in[0], in[1], static_cast<int>(in[2]), ranks + row * k_ranks, k_ranks);
      if (s.top <= 0 && blockIdx.x % bx == 0) state[row] = s;
    } else {
      s = state[row];
    }
    stage_n = 0u;
  }
  for (int64_t i = threadIdx.x; i < kCopies * stride; i += kThreads) rep[i] = 0u;
  __syncthreads();
  if (s.top <= 0) {  // block-uniform: this row's descent has ended
    if (first && init != nullptr && blockIdx.x % bx == 0) {
      write_out(s, out + row * k_ranks, k_ranks);
    }
    return;
  }
  const int top = s.top, source = s.source;
  unsigned* copy = rep + (threadIdx.x & (kCopies - 1)) * stride;
  uint32_t* buf = cand + row * cap;
  if (source == kFromBuffer) {
    const Span sp = part_span(__ldcg(&rc.cand_n), bx);
    for (int64_t i = sp.begin + threadIdx.x; i < sp.end; i += kThreads) {
      count_key(buf[i], s, top, copy);
    }
  } else {
    const float* src = x + row * p;
    const Span sp = part_span(p / V, bx);
    for (int64_t g0 = sp.begin; g0 < sp.end; g0 += kThreads) {  // the same trips for all threads
      const int64_t g = g0 + threadIdx.x;
      uint32_t k[V];
      group_keys<V>(src, g, g < sp.end, k);
      for (int j = 0; j < V; ++j) {
        if (count_key(k[j], s, top, copy) && source == kCollect) {
          stage[atomicAdd(&stage_n, 1u)] = k[j];
        }
      }
      if (source == kCollect) {  // block-uniform
        __syncthreads();
        const unsigned n = stage_n;
        __syncthreads();  // every thread holds the same n before the next group adds to it
        if (n > kStage - kThreads * V) {
          flush_stage(stage, n, &rc.cand_n, buf, cap);
          if (threadIdx.x == 0) stage_n = 0u;
          __syncthreads();
        }
      }
    }
    if (source == kCollect) {
      __syncthreads();
      if (stage_n > 0u) flush_stage(stage, stage_n, &rc.cand_n, buf, cap);
    }
  }
  __syncthreads();
  unsigned* h = hist + row * k_ranks * kBins;
  for (int i = threadIdx.x; i < s.slots * kBins; i += kThreads) {
    unsigned c = 0u;
    for (int q = 0; q < kCopies; ++q) c += rep[q * stride + i];
    if (c != 0u) atomicAdd(h + i, c);
  }
  if (!last_of_row(&rc.ticket, static_cast<unsigned>(bx))) return;

  // The row's last block: pick each rank's bin from the row's histograms
  // (copied into rep, then cleared for the next pass).
  unsigned* merged = rep;
  for (int i = threadIdx.x; i < s.slots * kBins; i += kThreads) {
    merged[i] = __ldcg(h + i);
    h[i] = 0u;
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, shift = digit_shift(top);
  for (int k = warp; k < k_ranks; k += kWarps) {
    unsigned bin;
    long long rem;
    warp_pick(merged + s.slot[k] * kBins, s.rank[k], bin, rem);
    if ((threadIdx.x & 31) == 0) {
      s.prefix[k] |= bin << shift;
      s.rank[k] = rem;
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    // The row's keys under the new prefixes: the chosen bins' counts, one
    // for each distinct new prefix.
    long long under = 0;
    int s_new = 0;
    for (int k = 0; k < k_ranks; ++k) {  // slot_prefix[0, s_new) holds new prefixes
      int i = 0;
      while (i < s_new && s.slot_prefix[i] != s.prefix[k]) ++i;
      if (i == s_new) {
        under += merged[s.slot[k] * kBins + digit_at(s.prefix[k], top)];
        s.slot_prefix[s_new++] = s.prefix[k];
      }
      s.slot[k] = i;
    }
    s.slots = s_new;
    s.top = shift;
    if (source != kSweep) {
      s.source = kFromBuffer;  // the buffer holds every later candidate
    } else if (shift > 0 && under <= cap) {
      s.source = kCollect;
    }
    state[row] = s;
  }
  __syncthreads();
  if (s.top == 0) write_out(s, out + row * k_ranks, k_ranks);
}

}  // namespace

// ------------------------------------------------------------- C interface
extern "C" {

const char* stainx_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x: (rows, p) float32 with +inf sentinels, p < 2^31; ranks: (rows, k)
// int32, 1 <= k <= 8; init: null or (rows, 3) int32 holding min key, max
// key (uint32 bits) and count; counts: rows * 32 bytes followed by hist,
// rows * k * 256 uint32 (both zeroed here); state: rows * 176 bytes; cand:
// rows * cap uint32, cap >= 1; out: (rows, k) float32. bx blocks a row,
// rows * bx < 2^31. vec is 4 when p % 4 == 0 and x is 16-byte aligned,
// else 1. Returns cudaGetLastError().
int stainx_kth_smallest_streaming(const void* x, long long rows, long long p, const void* ranks,
                                  int k, const void* init, void* counts, void* state, void* cand,
                                  long long cap, void* out, int vec, int bx, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* xf = static_cast<const float*>(x);
  const auto* rk = static_cast<const int*>(ranks);
  const auto* in = static_cast<const uint32_t*>(init);
  auto* rc = static_cast<RowCount*>(counts);
  auto* hist = reinterpret_cast<unsigned*>(rc + rows);
  auto* st = static_cast<SelRow*>(state);
  auto* cb = static_cast<uint32_t*>(cand);
  auto* o = static_cast<float*>(out);
  const size_t smem = sizeof(unsigned) * (kCopies * (static_cast<size_t>(k) * kBins + 1) + kStage);
  cudaError_t e = cudaMemsetAsync(
      counts, 0, static_cast<size_t>(rows) * (sizeof(RowCount) + k * kBins * sizeof(unsigned)), s);
  if (e == cudaSuccess) {
    e = cudaFuncSetAttribute(vec == 4 ? select_pass<4> : select_pass<1>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  const auto grid = static_cast<unsigned>(rows * bx);
  if (init == nullptr) {
    if (vec == 4) select_extremes<4><<<grid, kThreads, 0, s>>>(xf, p, bx, rk, k, rc, st, o);
    else select_extremes<1><<<grid, kThreads, 0, s>>>(xf, p, bx, rk, k, rc, st, o);
  }
  for (int d = 0; d < kPasses; ++d) {
    if (vec == 4) {
      select_pass<4><<<grid, kThreads, smem, s>>>(xf, p, bx, rk, k, in, d == 0, rc, st, hist, cb,
                                                  cap, o);
    } else {
      select_pass<1><<<grid, kThreads, smem, s>>>(xf, p, bx, rk, k, in, d == 0, rc, st, hist, cb,
                                                  cap, o);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
