// Histogram-matching kernels for Hopper (sm_90a), with a plain C interface
// loaded through ctypes (stainx_tpu_torch/kernels/histogram.py).
//
// What they replace
//   hist_kernel: stainx_tpu/kernels/histogram.py::histogram_256_mxu
//     (_hist_mxu_kernel, B8a), per-channel 256-bin counts of (N, C, P)
//     uint8, and ::histogram_256_pallas (_hist_kernel, B8c), the same counts
//     of (C, P), which is the N = 1 case of the same kernel.
//   apply_kernel: stainx_tpu/kernels/histogram.py::apply_lut_u8_mxu
//     (_apply_lut_kernel, B8b), out[n, c, p] = table[c, x[n, c, p]]. The
//     wrapper makes the table: floor(clip(lut, 0, 255)) as uint8, or, for
//     the float output of the JAX XLA route, clip(lut / 255, 0, 1) as float.
//   The TPU kernels count and look up through one-hot matrix products on
//   the MXU, tiled to its (8, 128) layout, because a TPU has no scatter and
//   no fast gather; none of that is carried over. Each kernel masks its own
//   ragged end, so the pad-to-bin-0 correction of the JAX wrappers has no
//   counterpart here.
//
// What bounds them
//   Bytes. At 64x3x512^2 uint8 the histogram reads 50.33 MB (15.0 us at
//   3.35 TB/s) and does one increment a byte; the apply reads 50.33 MB and
//   writes 50.33 MB (30.0 us) for the uint8 output.
//
// What the design does about it
//   Both kernels read the flat N*C*P buffer 16 bytes a thread (uint4) in a
//   grid-stride loop when the buffer is 16-byte aligned, with a scalar loop
//   for the last N*C*P % 16 bytes (and for an unaligned buffer). The channel
//   of element i is (i / P) % C: rows of odd P do not start aligned, so a
//   vector may cross rows; it is computed once a vector and then stepped.
//   The histogram counts into shared-memory sub-histograms with integer
//   atomics, one copy per pair of warps, and merges each thread's runs of
//   equal bytes before it adds, because H&E tiles are mostly near-white
//   background and one bin then takes most updates: an all-white vector is
//   one atomic, not 16. At the end each block adds its counts into the
//   global int32 (C, 256) counts with integer atomicAdd. Integer sums do not
//   depend on order, so the counts are exact and the same on every run;
//   the wrapper converts them to float32 once. Above 8 channels the shared
//   copies would not fit and the kernel adds to the global counts directly.
//   The apply kernel stages the C x 256 table in shared memory (in device
//   memory, read through the read-only cache, when it exceeds 32 KB), looks
//   up each byte of a 16-byte load and stores 16 bytes (uint8) or 64 bytes
//   (float32) at once.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kCopies = 4;                 // shared sub-histograms a block
constexpr int kSharedChannels = 8;         // channels the shared copies hold
constexpr int kTableBytes = 32 * 1024;     // largest table staged in shared memory

// Counting sink: a run of `run` elements of key c * 256 + v.
template <bool kShared>
__device__ __forceinline__ void add(int* sh, int* counts, int key, int run) {
  if constexpr (kShared) atomicAdd(sh + key, run);
  else atomicAdd(counts + key, run);
}

// Channel (row % c) and position within the row of element i.
__device__ __forceinline__ void locate(int64_t i, int64_t p, int c, int& ch, int64_t& pos) {
  const int64_t row = i / p;
  pos = i - row * p;
  ch = static_cast<int>(row % c);
}

__device__ __forceinline__ void step(int64_t p, int c, int& ch, int64_t& pos) {
  if (++pos == p) {
    pos = 0;
    ch = (ch + 1 == c) ? 0 : ch + 1;
  }
}

__device__ __forceinline__ int byte_of(const uint4& q, int j) {
  const unsigned w = j < 4 ? q.x : (j < 8 ? q.y : (j < 12 ? q.z : q.w));
  return static_cast<int>((w >> (8 * (j & 3))) & 0xFFu);
}

// counts: (c, 256) int32, zeroed by the caller. kVec: x is 16-byte aligned.
template <bool kVec, bool kShared>
__global__ void __launch_bounds__(kThreads)
hist_kernel(const uint8_t* __restrict__ x, int* __restrict__ counts, int64_t total, int64_t p,
            int c) {
  __shared__ int sh[kShared ? kCopies * kSharedChannels * 256 : 1];
  int* mine = nullptr;  // this warp's shared sub-histogram
  if constexpr (kShared) {
    for (int k = threadIdx.x; k < kCopies * c * 256; k += kThreads) sh[k] = 0;
    mine = sh + ((threadIdx.x >> 5) % kCopies) * c * 256;
    __syncthreads();
  }
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;

  int64_t scalar_from = 0;
  if constexpr (kVec) {
    const int64_t nvec = total / 16;
    scalar_from = nvec * 16;
    const uint4* xv = reinterpret_cast<const uint4*>(x);
    for (int64_t v = tid; v < nvec; v += stride) {
      const uint4 q = xv[v];
      int ch;
      int64_t pos;
      locate(v * 16, p, c, ch, pos);
      int key = ch * 256 + byte_of(q, 0), run = 1;
      for (int j = 1; j < 16; ++j) {
        step(p, c, ch, pos);
        const int k = ch * 256 + byte_of(q, j);
        if (k == key) {
          ++run;
        } else {
          add<kShared>(mine, counts, key, run);
          key = k;
          run = 1;
        }
      }
      add<kShared>(mine, counts, key, run);
    }
  }
  for (int64_t i = scalar_from + tid; i < total; i += stride) {
    int ch;
    int64_t pos;
    locate(i, p, c, ch, pos);
    add<kShared>(mine, counts, ch * 256 + x[i], 1);
  }

  if constexpr (kShared) {
    __syncthreads();
    for (int k = threadIdx.x; k < c * 256; k += kThreads) {
      int s = 0;
      for (int copy = 0; copy < kCopies; ++copy) s += sh[copy * c * 256 + k];
      if (s != 0) atomicAdd(counts + k, s);
    }
  }
}

template <bool kShared, typename Tab>
__device__ __forceinline__ Tab lookup(const Tab* tab, int k) {
  if constexpr (kShared) return tab[k];
  else return __ldg(tab + k);
}

template <typename Tab>
__device__ __forceinline__ void store16(Tab* __restrict__ out, int64_t i, const Tab (&v)[16]) {
  if constexpr (sizeof(Tab) == 1) {
    uint4 w;
    unsigned* wp = reinterpret_cast<unsigned*>(&w);
    for (int k = 0; k < 4; ++k) {
      wp[k] = static_cast<unsigned>(v[4 * k]) | (static_cast<unsigned>(v[4 * k + 1]) << 8) |
              (static_cast<unsigned>(v[4 * k + 2]) << 16) |
              (static_cast<unsigned>(v[4 * k + 3]) << 24);
    }
    *reinterpret_cast<uint4*>(out + i) = w;
  } else {
    float4* o = reinterpret_cast<float4*>(out + i);
    for (int k = 0; k < 4; ++k) o[k] = make_float4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]);
  }
}

// out[i] = table[(i / p) % c][x[i]]; table: (c, 256) of Tab. kVec: x and out
// are 16-byte aligned. kShared: the table fits kTableBytes.
template <typename Tab, bool kVec, bool kShared>
__global__ void __launch_bounds__(kThreads)
apply_kernel(const uint8_t* __restrict__ x, Tab* __restrict__ out, const Tab* __restrict__ table,
             int64_t total, int64_t p, int c) {
  __shared__ __align__(16) unsigned char raw[kShared ? kTableBytes : 16];
  const Tab* tab = table;
  if constexpr (kShared) {
    Tab* st = reinterpret_cast<Tab*>(raw);
    for (int k = threadIdx.x; k < c * 256; k += kThreads) st[k] = table[k];
    __syncthreads();
    tab = st;
  }
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;

  int64_t scalar_from = 0;
  if constexpr (kVec) {
    const int64_t nvec = total / 16;
    scalar_from = nvec * 16;
    const uint4* xv = reinterpret_cast<const uint4*>(x);
    for (int64_t v = tid; v < nvec; v += stride) {
      const uint4 q = xv[v];
      int ch;
      int64_t pos;
      locate(v * 16, p, c, ch, pos);
      Tab vals[16];
      for (int j = 0; j < 16; ++j) {
        if (j > 0) step(p, c, ch, pos);
        const int k = ch * 256 + byte_of(q, j);
        vals[j] = lookup<kShared>(tab, k);
      }
      store16<Tab>(out, v * 16, vals);
    }
  }
  for (int64_t i = scalar_from + tid; i < total; i += stride) {
    int ch;
    int64_t pos;
    locate(i, p, c, ch, pos);
    const int k = ch * 256 + x[i];
    out[i] = lookup<kShared>(tab, k);
  }
}

template <bool kVec, bool kShared>
void launch_hist(const uint8_t* x, int* counts, int64_t total, int64_t p, int c, int blocks,
                 cudaStream_t s) {
  hist_kernel<kVec, kShared><<<blocks, kThreads, 0, s>>>(x, counts, total, p, c);
}

template <typename Tab>
void launch_apply(const uint8_t* x, void* out, const void* table, int64_t total, int64_t p, int c,
                  int vec, int blocks, cudaStream_t s) {
  auto* o = static_cast<Tab*>(out);
  const auto* t = static_cast<const Tab*>(table);
  const bool shared = static_cast<int64_t>(c) * 256 * sizeof(Tab) <= kTableBytes;
  if (vec && shared) apply_kernel<Tab, true, true><<<blocks, kThreads, 0, s>>>(x, o, t, total, p, c);
  else if (vec) apply_kernel<Tab, true, false><<<blocks, kThreads, 0, s>>>(x, o, t, total, p, c);
  else if (shared) apply_kernel<Tab, false, true><<<blocks, kThreads, 0, s>>>(x, o, t, total, p, c);
  else apply_kernel<Tab, false, false><<<blocks, kThreads, 0, s>>>(x, o, t, total, p, c);
}

}  // namespace

// ------------------------------------------------------------- C interface
extern "C" {

const char* stainx_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x: (n, c, p) contiguous uint8, total = n * c * p < 2^31 per channel;
// counts: (c, 256) int32, zeroed. vec: x is 16-byte aligned.
int stainx_histogram_256(const void* x, void* counts, long long total, long long p, int c, int vec,
                         int blocks, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* xi = static_cast<const uint8_t*>(x);
  auto* ci = static_cast<int*>(counts);
  const bool shared = c <= kSharedChannels;
  if (vec && shared) launch_hist<true, true>(xi, ci, total, p, c, blocks, s);
  else if (vec) launch_hist<true, false>(xi, ci, total, p, c, blocks, s);
  else if (shared) launch_hist<false, true>(xi, ci, total, p, c, blocks, s);
  else launch_hist<false, false>(xi, ci, total, p, c, blocks, s);
  return static_cast<int>(cudaGetLastError());
}

// x: (n, c, p) contiguous uint8; table: (c, 256) uint8 (is_float 0) or
// float32 (is_float 1); out: (n, c, p) of the table's type. vec: x and out
// are 16-byte aligned.
int stainx_apply_lut(const void* x, void* out, const void* table, long long total, long long p,
                     int c, int is_float, int vec, int blocks, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* xi = static_cast<const uint8_t*>(x);
  if (is_float) launch_apply<float>(xi, out, table, total, p, c, vec, blocks, s);
  else launch_apply<uint8_t>(xi, out, table, total, p, c, vec, blocks, s);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
