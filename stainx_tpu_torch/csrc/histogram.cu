// Histogram-matching kernels for Hopper (sm_90a), with a plain C interface
// loaded through ctypes (stainx_tpu_torch/kernels/histogram.py).
//
// What they replace
//   hist_kernel: stainx_tpu/kernels/histogram.py::histogram_256_mxu
//     (_hist_mxu_kernel, B8a), per-channel 256-bin counts of (N, C, P)
//     uint8, and ::histogram_256_pallas (_hist_kernel, B8c), the same counts
//     of (C, P), which is the N = 1 case of the same kernel.
//   hist_finalize: what the JAX package computes around those counts in
//     plain jnp (stainx_tpu/ops/histogram_matching.py): the counts as float32,
//     hm_fit's normalized reference histogram, or hm_build_lut's LUT and the
//     (C, 256) table the apply looks up.
//   apply_kernel: stainx_tpu/kernels/histogram.py::apply_lut_u8_mxu
//     (_apply_lut_kernel, B8b), out[n, c, p] = table[c, x[n, c, p]]: the
//     table is floor(clip(lut, 0, 255)) as uint8, or, for the float output of
//     the JAX XLA route, clip(lut / 255, 0, 1) as float.
//   The TPU kernels count and look up through one-hot matrix products on
//   the MXU, tiled to its (8, 128) layout, because a TPU has no scatter and
//   no fast gather; none of that is carried over. Each kernel masks its own
//   ragged end, so the pad-to-bin-0 correction of the JAX wrappers has no
//   counterpart here.
//
// What bounds them
//   Bytes. At 64x3x512^2 uint8 the histogram reads 50.33 MB (15.0 us at
//   3.35 TB/s) and does one increment a byte; the apply reads 50.33 MB and
//   writes 50.33 MB (30.0 us) for the uint8 output. The finalize works on
//   C x 256 values: its time is its latency (a few dependent shared-memory
//   sums and a binary search), about that of a launch.
//
// What the design does about it
//   hist_kernel: a block counts a contiguous stretch of one channel's N * P
//   values (grid: C x blocks_per_channel), walking the images it covers
//   row by row, so it knows every value's channel: no division or channel
//   step a byte. Each row stretch is read as an unaligned head, 16-byte
//   vectors (kUnroll in flight a thread) and a tail, so odd P and unaligned
//   buffers need no other path. Every lane of the block owns one column of
//   a 256 x 32 word histogram in shared memory (word 32 * bin + lane): a
//   byte is one shared atomic add that no other lane of its warp can
//   conflict with, whatever the data (an all-white tile as well as noise),
//   so no run merging or warp matching is needed. At the end each warp adds
//   the 32 columns of its bins with one warp reduction and the block writes
//   its 256 counts to its own row of int32 partials: no global atomics and
//   no zeroed buffer, so a call needs no memset.
//   hist_finalize: one block of 256 threads a channel (thread b, bin b) adds
//   the channel's partials (integers: exact in any order) and converts the
//   count to float32 once; then, by mode, writes the counts, the normalized
//   histogram counts / (sum + 1e-8), or the LUT of hm_build_lut and the
//   table. Every float step is the plain version's, in its order: the sums
//   of 256 bins as eight sequential windows of 32 and then the eight window
//   sums (kernels/histogram.py::sum256), the cumulative sums as sequential
//   blocks of 16, the block totals and each block's prefix added
//   (::scan256), true divisions where the JAX package divides by a
//   computed value and products by a float32 reciprocal where it divides by
//   a constant of its compiled program, which XLA folds so (::_reciprocal:
//   the pixel count, 255), the searchsorted (left) binary search of
//   torch.searchsorted, and float32 constants; built with -fmad=false, so
//   no product and sum are fused. The LUT is therefore bit for bit that of
//   hm_build_lut on the same counts, on any device.
//   apply_kernel: a block takes a stretch of one channel's N * P values and
//   walks its planes, as hist_kernel does (grid: C x blocks_per_channel), so
//   the channel and the table row it looks up are fixed for the block: no
//   division and no channel step in the loop (a grid-stride walk over the
//   flat input paid a 64-bit division a vector and a 64-bit step a byte,
//   17 instructions a byte, and ran at 1.2x a copy's time). A vector is
//   what one 16-byte store of the output holds, 16 input bytes for uint8
//   and 4 for float32, so a warp stores 512 contiguous bytes either way
//   (four 16-byte stores a thread, 64 bytes apart, would write half
//   sectors). Where input and output line up, each plane stretch is a head
//   up to the first vector boundary, the vectors (kApplyUnroll or
//   kApplyUnrollF32 loads in flight a thread before any lookup; __ldcs and
//   __stcs, as each byte is touched once) and a tail, so any P and
//   alignment runs through the same kernel; otherwise the stretch goes byte
//   by byte. Blocks are short (kernels/histogram.py::apply_split): many
//   blocks in turn keep more loads in flight than few long ones, which wait
//   in step. The C x 256 table is staged in dynamic shared memory of its
//   own size (in device memory, read through the read-only cache, when it
//   exceeds 32 KB). What bounds it now is its bytes: 1.03-1.05x the time of
//   a copy of them at 256x3x512^2 uint8 (77 instructions a 16-byte vector).
//   stainx_hm_fit and stainx_hm_transform launch the histogram, the finalize
//   and (transform) the apply in one C call: nothing is issued between them
//   and nothing returns to the host.

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 256;      // apply_kernel, hist_finalize
constexpr int kHistThreads = 512;  // hist_kernel
constexpr int kHistWarps = kHistThreads / 32;
constexpr int kUnroll = 4;         // 16-byte loads in flight a thread (hist_kernel)
constexpr int kApplyUnroll = 2;    // 16-byte loads in flight a thread (apply_kernel, uint8 out)
constexpr int kApplyUnrollF32 = 4; // 4-byte loads in flight a thread (apply_kernel, float32 out)
constexpr int kTableBytes = 32 * 1024;  // largest table staged in shared memory
constexpr unsigned kFull = 0xFFFFFFFFu;

// ---------------------------------------------------------------- counting
// Adds the four bytes of w to the lane's column of the block histogram.
__device__ __forceinline__ void count4(unsigned* col, unsigned w) {
  atomicAdd(col + ((w & 0xFFu) << 5), 1u);
  atomicAdd(col + (((w >> 8) & 0xFFu) << 5), 1u);
  atomicAdd(col + (((w >> 16) & 0xFFu) << 5), 1u);
  atomicAdd(col + ((w >> 24) << 5), 1u);
}

// Counts the len bytes at row into the lane columns: the bytes before the
// first 16-byte boundary, the 16-byte vectors, then the rest.
__device__ __forceinline__ void count_stretch(const uint8_t* __restrict__ row, int64_t len,
                                              unsigned* col) {
  const int64_t head_raw = (16 - static_cast<int64_t>(reinterpret_cast<uintptr_t>(row) & 15)) & 15;
  const int64_t head = head_raw < len ? head_raw : len;
  if (threadIdx.x < head) atomicAdd(col + (static_cast<unsigned>(row[threadIdx.x]) << 5), 1u);
  const uint4* vec = reinterpret_cast<const uint4*>(row + head);
  const int64_t nvec = (len - head) / 16;
  for (int64_t v0 = threadIdx.x; v0 < nvec; v0 += kUnroll * kHistThreads) {
    uint4 q[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int64_t v = v0 + k * kHistThreads;
      q[k] = v < nvec ? __ldcs(vec + v) : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      if (v0 + k * kHistThreads < nvec) {
        count4(col, q[k].x);
        count4(col, q[k].y);
        count4(col, q[k].z);
        count4(col, q[k].w);
      }
    }
  }
  const int64_t done = head + 16 * nvec;
  if (done + threadIdx.x < len) {
    atomicAdd(col + (static_cast<unsigned>(row[done + threadIdx.x]) << 5), 1u);
  }
}

// x: (n, c, p) uint8. Block blockIdx.x counts stretch blockIdx.x % bpc of
// channel blockIdx.x / bpc, the channel's n * p values split in bpc
// stretches of `chunk` (the last shorter), into partials[blockIdx.x]:
// (c * bpc, 256) int32, each row written whole.
__global__ void __launch_bounds__(kHistThreads)
hist_kernel(const uint8_t* __restrict__ x, int* __restrict__ partials, int64_t n, int64_t p,
            int c, int bpc, int64_t chunk) {
  __shared__ unsigned hist[256 * 32];
  for (int k = threadIdx.x; k < 256 * 32; k += kHistThreads) hist[k] = 0u;
  __syncthreads();
  unsigned* col = hist + (threadIdx.x & 31);
  const int ch = blockIdx.x / bpc;
  const int64_t total = n * p;
  int64_t f = static_cast<int64_t>(blockIdx.x % bpc) * chunk;
  const int64_t end = f + chunk < total ? f + chunk : total;
  if (f < end) {
    int64_t img = f / p, pos = f - img * p;  // once a block
    while (f < end) {
      const int64_t len = p - pos < end - f ? p - pos : end - f;
      count_stretch(x + (img * c + ch) * p + pos, len, col);
      f += len;
      ++img;
      pos = 0;
    }
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int* out = partials + static_cast<int64_t>(blockIdx.x) * 256;
  for (int b = warp; b < 256; b += kHistWarps) {
    const unsigned s = __reduce_add_sync(kFull, hist[b * 32 + lane]);
    if (lane == 0) out[b] = static_cast<int>(s);
  }
}

// ---------------------------------------------------------------- finalize
enum FinalizeMode { kCounts = 0, kFit = 1, kLut = 2 };

// Sum of the 256 values v in the order of sum256: eight windows of 32
// summed sequentially, then the eight window sums. Every thread gets it.
__device__ float sum256(const float* v, float* part) {
  if (threadIdx.x < 8) {
    float s = v[32 * threadIdx.x];
    for (int j = 1; j < 32; ++j) s = s + v[32 * threadIdx.x + j];
    part[threadIdx.x] = s;
  }
  __syncthreads();
  float total = part[0];
  for (int k = 1; k < 8; ++k) total = total + part[k];
  __syncthreads();  // part may be reused
  return total;
}

// In-place inclusive cumulative sums of the 256 values v in the order of
// scan256: sequentially within blocks of 16, sequentially over the block
// totals, then each block's exclusive prefix added to it.
__device__ void scan256(float* v, float* before) {
  if (threadIdx.x < 16) {
    float* blk = v + 16 * threadIdx.x;
    for (int j = 1; j < 16; ++j) blk[j] = blk[j - 1] + blk[j];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = 0.0f;
    before[0] = 0.0f;
    for (int k = 1; k < 16; ++k) {
      t = k == 1 ? v[15] : t + v[16 * k - 1];
      before[k] = t;
    }
  }
  __syncthreads();
  const float own = v[threadIdx.x] + before[threadIdx.x >> 4];
  __syncthreads();
  v[threadIdx.x] = own;
  __syncthreads();
}

// torch.searchsorted(seq, val, side="left") on 256 sorted values: the
// binary search of its CPU and CUDA kernels (first index whose value is
// not below val).
__device__ __forceinline__ int search_left(const float* seq, float val) {
  int lo = 0, hi = 256;
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (!(seq[mid] >= val)) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ float clamp_keep_nan(float x, float lo, float hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// One block of 256 threads a channel (thread b: bin b). partials: (c * bpc,
// 256) int32 from hist_kernel. kCounts: out = the float32 counts. kFit: out
// = counts / (sum + 1e-8). kLut: out = hm_build_lut(counts, ref_hist,
// num_pixels) with src_scale = float32(1 / float32(num_pixels + 1e-8)), and
// table = its uint8 or float32 (is_float) form. out, ref_hist, table:
// (c, 256).
__global__ void __launch_bounds__(kThreads)
hist_finalize(const int* __restrict__ partials, int bpc, int mode,
              const float* __restrict__ ref_hist, float src_scale, float* __restrict__ out,
              void* __restrict__ table, int is_float) {
  __shared__ float src[256], ref[256], part[8], before[16];
  __shared__ int last_occupied;
  const int ch = blockIdx.x, b = threadIdx.x;
  const int* rows = partials + static_cast<int64_t>(ch) * bpc * 256 + b;
  int cnt = 0;
  for (int k = 0; k < bpc; ++k) cnt += __ldg(rows + static_cast<int64_t>(k) * 256);
  const float cf = static_cast<float>(cnt);
  float* dst = out + ch * 256 + b;
  if (mode == kCounts) {
    *dst = cf;
    return;
  }
  src[b] = cf;
  if (b == 0) last_occupied = -1;
  __syncthreads();
  if (mode == kFit) {
    const float den = sum256(src, part) + 1e-8f;
    *dst = cf / den;
    return;
  }
  if (cnt > 0) atomicMax(&last_occupied, b);
  ref[b] = ref_hist[ch * 256 + b];
  __syncthreads();
  const float ref_den = sum256(ref, part) + 1e-8f;
  src[b] = cf * src_scale;
  ref[b] = ref[b] / ref_den;
  __syncthreads();
  scan256(src, before);
  scan256(ref, before);
  const float cdf = src[b];
  int idx = search_left(ref, cdf);
  idx = idx < 1 ? 1 : (idx > 255 ? 255 : idx);
  const float q_left = ref[idx - 1], q_right = ref[idx];
  const float q_diff = q_right - q_left;
  const float alpha = q_diff > 1e-10f ? (cdf - q_left) / q_diff : 0.0f;
  float lut = static_cast<float>(idx - 1) + alpha;
  const bool below_min = cdf <= ref[0] * (1.0f + 3.0f * 0x1p-23f);
  const int last = last_occupied;
  const bool above_max = (last >= 0 && b >= last) || ref[255] <= 0.0f;
  if (below_min) lut = 0.0f;
  if (above_max) lut = 255.0f;
  lut = clamp_keep_nan(lut, 0.0f, 255.0f);
  *dst = lut;
  if (is_float) {
    static_cast<float*>(table)[ch * 256 + b] = clamp_keep_nan(lut * (1.0f / 255.0f), 0.0f, 1.0f);
  } else {
    static_cast<uint8_t*>(table)[ch * 256 + b] =
        static_cast<uint8_t>(static_cast<int>(floorf(lut)));
  }
}

// ------------------------------------------------------------------- apply
template <bool kShared, typename Tab>
__device__ __forceinline__ Tab lookup(const Tab* row, unsigned v) {
  if constexpr (kShared) return row[v];
  else return __ldg(row + v);
}

// The table entries of the four bytes of w: packed as four bytes (uint8) or
// as a float4 (float32).
template <bool kShared>
__device__ __forceinline__ unsigned look4(const uint8_t* row, unsigned w) {
  return static_cast<unsigned>(lookup<kShared>(row, w & 0xFFu)) |
         (static_cast<unsigned>(lookup<kShared>(row, (w >> 8) & 0xFFu)) << 8) |
         (static_cast<unsigned>(lookup<kShared>(row, (w >> 16) & 0xFFu)) << 16) |
         (static_cast<unsigned>(lookup<kShared>(row, w >> 24)) << 24);
}

template <bool kShared>
__device__ __forceinline__ float4 look4(const float* row, unsigned w) {
  return make_float4(lookup<kShared>(row, w & 0xFFu), lookup<kShared>(row, (w >> 8) & 0xFFu),
                     lookup<kShared>(row, (w >> 16) & 0xFFu), lookup<kShared>(row, w >> 24));
}

// A vector is what one 16-byte store of the output holds: 16 input bytes
// (a uint4) for uint8 output, 4 (an unsigned) for float32, so the lanes of a
// warp store 512 contiguous bytes.
template <typename Tab>
using VecIn = std::conditional_t<sizeof(Tab) == 1, uint4, unsigned>;

// Looks up the bytes of q and stores their entries at dst, 16-byte aligned.
template <bool kShared>
__device__ __forceinline__ void put16(uint8_t* dst, const uint8_t* row, const uint4& q) {
  __stcs(reinterpret_cast<uint4*>(dst),
         make_uint4(look4<kShared>(row, q.x), look4<kShared>(row, q.y),
                    look4<kShared>(row, q.z), look4<kShared>(row, q.w)));
}

template <bool kShared>
__device__ __forceinline__ void put16(float* dst, const float* row, unsigned q) {
  __stcs(reinterpret_cast<float4*>(dst), look4<kShared>(row, q));
}

// dst[i] = row[src[i]] for the len values of one plane stretch (len < 2^31).
// kVec: src and dst line up (where src sits on a vector boundary, dst sits
// on a 16-byte one): the bytes before src's first vector boundary, the
// vectors, kApplyUnroll (uint8) or kApplyUnrollF32 loads in flight a thread
// before any lookup (the rest one at a time), then the bytes after the last
// boundary. Otherwise byte by byte.
template <typename Tab, bool kVec, bool kShared>
__device__ __forceinline__ void apply_stretch(const uint8_t* __restrict__ src,
                                              Tab* __restrict__ dst, int len, const Tab* row) {
  int done = 0;
  if constexpr (kVec) {
    using In = VecIn<Tab>;
    constexpr int kB = sizeof(In);  // input bytes a vector
    constexpr int kU = sizeof(Tab) == 1 ? kApplyUnroll : kApplyUnrollF32;
    const int head_raw =
        static_cast<int>((kB - (reinterpret_cast<uintptr_t>(src) & (kB - 1))) & (kB - 1));
    const int head = head_raw < len ? head_raw : len;
    if (static_cast<int>(threadIdx.x) < head) {
      dst[threadIdx.x] = lookup<kShared>(row, src[threadIdx.x]);
    }
    const In* vec = reinterpret_cast<const In*>(src + head);
    Tab* out = dst + head;
    const int nvec = (len - head) / kB;
    int v = threadIdx.x;
    for (; v + (kU - 1) * kThreads < nvec; v += kU * kThreads) {
      In q[kU];
#pragma unroll
      for (int k = 0; k < kU; ++k) q[k] = __ldcs(vec + v + k * kThreads);
#pragma unroll
      for (int k = 0; k < kU; ++k) put16<kShared>(out + kB * (v + k * kThreads), row, q[k]);
    }
    for (; v < nvec; v += kThreads) put16<kShared>(out + kB * v, row, __ldcs(vec + v));
    done = head + kB * nvec;
  }
  for (int i = done + threadIdx.x; i < len; i += kThreads) {
    dst[i] = lookup<kShared>(row, src[i]);
  }
}

// out[n, c, p] = table[c, x[n, c, p]]; x: (n, c, p) uint8, table: (c, 256)
// of Tab. Block blockIdx.x applies stretch blockIdx.x % bpc of channel
// blockIdx.x / bpc, the channel's n * p values split in bpc stretches of
// `chunk` < 2^31 (the last shorter), walking the images it covers plane by
// plane.
// kShared: the table is staged in dynamic shared memory (c * 256 entries);
// else it is read through the read-only cache.
template <typename Tab, bool kVec, bool kShared>
__global__ void __launch_bounds__(kThreads)
apply_kernel(const uint8_t* __restrict__ x, Tab* __restrict__ out, const Tab* __restrict__ table,
             int64_t n, int64_t p, int c, int bpc, int64_t chunk) {
  extern __shared__ __align__(16) unsigned char raw[];
  const int ch = blockIdx.x / bpc;
  const int64_t total = n * p;
  int64_t f = static_cast<int64_t>(blockIdx.x % bpc) * chunk;
  const int64_t end = f + chunk < total ? f + chunk : total;
  if (f >= end) return;
  const Tab* row = table + ch * 256;
  if constexpr (kShared) {
    Tab* st = reinterpret_cast<Tab*>(raw);
    for (int k = threadIdx.x; k < c * 256; k += kThreads) st[k] = table[k];
    __syncthreads();
    row = st + ch * 256;
  }
  int64_t img = f / p, pos = f - img * p;  // once a block
  while (f < end) {
    const int len = static_cast<int>(p - pos < end - f ? p - pos : end - f);
    const int64_t at = (img * c + ch) * p + pos;
    apply_stretch<Tab, kVec, kShared>(x + at, out + at, len, row);
    f += len;
    ++img;
    pos = 0;
  }
}

// ---------------------------------------------------------------- launches
struct HistArgs {
  const uint8_t* x;
  int* partials;
  long long n, p;
  int c, bpc;
  long long chunk;
};

HistArgs hist_args(const void* x, void* partials, long long n, long long p, int c, int bpc,
                   long long chunk) {
  return {static_cast<const uint8_t*>(x), static_cast<int*>(partials), n, p, c, bpc, chunk};
}

void launch_hist(const HistArgs& a, cudaStream_t s) {
  hist_kernel<<<a.c * a.bpc, kHistThreads, 0, s>>>(a.x, a.partials, a.n, a.p, a.c, a.bpc, a.chunk);
}

void launch_finalize(const HistArgs& a, int mode, const float* ref_hist, float src_scale,
                     float* out, void* table, int is_float, cudaStream_t s) {
  hist_finalize<<<a.c, kThreads, 0, s>>>(a.partials, a.bpc, mode, ref_hist, src_scale, out, table,
                                         is_float);
}

struct ApplyArgs {
  const uint8_t* x;
  void* out;
  const void* table;
  long long n, p;
  int c, bpc;
  long long chunk;
  int is_float, vec;
};

template <typename Tab, bool kVec, bool kShared>
void launch_apply_k(const ApplyArgs& a, cudaStream_t s) {
  const size_t smem = kShared ? static_cast<size_t>(a.c) * 256 * sizeof(Tab) : 0;
  apply_kernel<Tab, kVec, kShared><<<a.c * a.bpc, kThreads, smem, s>>>(
      a.x, static_cast<Tab*>(a.out), static_cast<const Tab*>(a.table), a.n, a.p, a.c, a.bpc,
      a.chunk);
}

template <typename Tab>
void launch_apply_t(const ApplyArgs& a, cudaStream_t s) {
  const bool shared = static_cast<int64_t>(a.c) * 256 * sizeof(Tab) <= kTableBytes;
  if (a.vec && shared) launch_apply_k<Tab, true, true>(a, s);
  else if (a.vec) launch_apply_k<Tab, true, false>(a, s);
  else if (shared) launch_apply_k<Tab, false, true>(a, s);
  else launch_apply_k<Tab, false, false>(a, s);
}

void launch_apply(const ApplyArgs& a, cudaStream_t s) {
  if (a.is_float) launch_apply_t<float>(a, s);
  else launch_apply_t<uint8_t>(a, s);
}

// Records `event` (a CUDA event, or null for none) on `s`; the CUDA error.
int mark(void* event, cudaStream_t s) {
  return event == nullptr
             ? 0
             : static_cast<int>(cudaEventRecord(static_cast<cudaEvent_t>(event), s));
}

}  // namespace

// ------------------------------------------------------------- C interface
// x: (n, c, p) contiguous uint8 with n * p < 2^31; partials: (c * bpc, 256)
// int32 scratch; bpc blocks a channel, each counting `chunk` of the
// channel's n * p values (bpc * chunk >= n * p). Every function returns
// cudaGetLastError().
extern "C" {

const char* stainx_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// counts: (c, 256) float32 per-channel counts.
int stainx_histogram_256(const void* x, void* partials, void* counts, long long n, long long p,
                         int c, int bpc, long long chunk, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const HistArgs a = hist_args(x, partials, n, p, c, bpc, chunk);
  launch_hist(a, s);
  launch_finalize(a, kCounts, nullptr, 0.0f, static_cast<float*>(counts), nullptr, 0, s);
  return static_cast<int>(cudaGetLastError());
}

// hist: (c, 256) float32 reference histograms, counts / (sum + 1e-8).
int stainx_hm_fit(const void* x, void* partials, void* hist, long long n, long long p, int c,
                  int bpc, long long chunk, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const HistArgs a = hist_args(x, partials, n, p, c, bpc, chunk);
  launch_hist(a, s);
  launch_finalize(a, kFit, nullptr, 0.0f, static_cast<float*>(hist), nullptr, 0, s);
  return static_cast<int>(cudaGetLastError());
}

// The histogram-matching transform: the counts, the LUT of hm_build_lut
// against ref_hist ((c, 256) float32) into lut ((c, 256) float32) and its
// table ((c, 256) uint8, or float32 when is_float), then out ((n, c, p) of
// the table's type) = table[c, x]. src_scale: float32(1 / float32(n * p +
// 1e-8)). The apply: apply_bpc blocks a channel, each applying
// apply_chunk of the channel's n * p values; vec: x and out line up modulo
// 16 bytes and the planes run 16-byte vectors.
// stats_start and stats_end, where not null, are CUDA events of the stream's
// device, made with timing: stats_start is recorded before the histogram
// launch and stats_end after the LUT finalize, so the interval between them
// holds the call-wide histogram and LUT and nothing the host or the apply
// does. launch_start and launch_end, where not null, are such events too:
// recorded just before the first launch and just after the last, so the
// interval holds the call's three launches. The launches, their order and
// the outputs are the same with or without.
int stainx_hm_transform(const void* x, void* out, void* partials, const void* ref_hist, void* lut,
                        void* table, long long n, long long p, int c, int bpc, long long chunk,
                        float src_scale, int is_float, int vec, int apply_bpc,
                        long long apply_chunk, void* stream, void* stats_start,
                        void* stats_end, void* launch_start, void* launch_end) {
  const auto s = static_cast<cudaStream_t>(stream);
  const HistArgs a = hist_args(x, partials, n, p, c, bpc, chunk);
  int code = mark(launch_start, s);
  if (code == 0) code = mark(stats_start, s);
  if (code != 0) return code;
  launch_hist(a, s);
  launch_finalize(a, kLut, static_cast<const float*>(ref_hist), src_scale, static_cast<float*>(lut),
                  table, is_float, s);
  code = mark(stats_end, s);
  if (code != 0) return code;
  launch_apply({a.x, out, table, n, p, c, apply_bpc, apply_chunk, is_float, vec}, s);
  code = static_cast<int>(cudaGetLastError());
  if (code != 0) return code;
  return mark(launch_end, s);
}

// The transform's finalize alone, on given (c, 256) int32 counts: lut and
// table as stainx_hm_transform writes them for values with those counts.
int stainx_hm_lut(const void* counts, const void* ref_hist, void* lut, void* table, int c,
                  float src_scale, int is_float, void* stream) {
  const HistArgs a = hist_args(nullptr, const_cast<void*>(counts), 0, 0, c, 1, 0);
  launch_finalize(a, kLut, static_cast<const float*>(ref_hist), src_scale, static_cast<float*>(lut),
                  table, is_float, static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

// x: (n, c, p) contiguous uint8; table: (c, 256) uint8 (is_float 0) or
// float32 (is_float 1); out: (n, c, p) of the table's type. bpc blocks a
// channel, each applying `chunk` of the channel's n * p values (bpc * chunk
// >= n * p); vec: x and out line up modulo 16 bytes and the planes run
// 16-byte vectors.
int stainx_apply_lut(const void* x, void* out, const void* table, long long n, long long p, int c,
                     int bpc, long long chunk, int is_float, int vec, void* stream) {
  launch_apply({static_cast<const uint8_t*>(x), out, table, n, p, c, bpc, chunk, is_float, vec},
               static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
