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
//   apply_kernel stages the C x 256 table in shared memory (in device memory,
//   read through the read-only cache, when it exceeds 32 KB), looks up each
//   byte of a 16-byte load and stores 16 bytes (uint8) or 64 bytes (float32)
//   at once.
//   stainx_hm_fit and stainx_hm_transform launch the histogram, the finalize
//   and (transform) the apply in one C call: nothing is issued between them
//   and nothing returns to the host.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;      // apply_kernel, hist_finalize
constexpr int kHistThreads = 512;  // hist_kernel
constexpr int kHistWarps = kHistThreads / 32;
constexpr int kUnroll = 4;         // 16-byte loads in flight a thread
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
__device__ __forceinline__ int byte_of(const uint4& q, int j) {
  const unsigned w = j < 4 ? q.x : (j < 8 ? q.y : (j < 12 ? q.z : q.w));
  return static_cast<int>((w >> (8 * (j & 3))) & 0xFFu);
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

template <typename Tab>
void launch_apply_t(const uint8_t* x, void* out, const void* table, int64_t total, int64_t p, int c,
                    int vec, int blocks, cudaStream_t s) {
  auto* o = static_cast<Tab*>(out);
  const auto* t = static_cast<const Tab*>(table);
  const bool shared = static_cast<int64_t>(c) * 256 * sizeof(Tab) <= kTableBytes;
  if (vec && shared) apply_kernel<Tab, true, true><<<blocks, kThreads, 0, s>>>(x, o, t, total, p, c);
  else if (vec) apply_kernel<Tab, true, false><<<blocks, kThreads, 0, s>>>(x, o, t, total, p, c);
  else if (shared) apply_kernel<Tab, false, true><<<blocks, kThreads, 0, s>>>(x, o, t, total, p, c);
  else apply_kernel<Tab, false, false><<<blocks, kThreads, 0, s>>>(x, o, t, total, p, c);
}

void launch_apply(const uint8_t* x, void* out, const void* table, long long total, long long p,
                  int c, int is_float, int vec, int blocks, cudaStream_t s) {
  if (is_float) launch_apply_t<float>(x, out, table, total, p, c, vec, blocks, s);
  else launch_apply_t<uint8_t>(x, out, table, total, p, c, vec, blocks, s);
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
// 1e-8)). vec: x
// and out are 16-byte aligned; apply_blocks: the apply's grid.
// stats_start and stats_end, where not null, are CUDA events of the stream's
// device, made with timing: stats_start is recorded before the histogram
// launch and stats_end after the LUT finalize, so the interval between them
// holds the call-wide histogram and LUT and nothing the host or the apply
// does. The launches, their order and the outputs are the same with or
// without.
int stainx_hm_transform(const void* x, void* out, void* partials, const void* ref_hist, void* lut,
                        void* table, long long n, long long p, int c, int bpc, long long chunk,
                        float src_scale, int is_float, int vec, int apply_blocks, void* stream,
                        void* stats_start, void* stats_end) {
  const auto s = static_cast<cudaStream_t>(stream);
  const HistArgs a = hist_args(x, partials, n, p, c, bpc, chunk);
  int code = 0;
  if (stats_start != nullptr) {
    code = static_cast<int>(cudaEventRecord(static_cast<cudaEvent_t>(stats_start), s));
    if (code != 0) return code;
  }
  launch_hist(a, s);
  launch_finalize(a, kLut, static_cast<const float*>(ref_hist), src_scale, static_cast<float*>(lut),
                  table, is_float, s);
  if (stats_end != nullptr) {
    code = static_cast<int>(cudaEventRecord(static_cast<cudaEvent_t>(stats_end), s));
    if (code != 0) return code;
  }
  launch_apply(a.x, out, table, n * c * p, p, c, is_float, vec, apply_blocks, s);
  return static_cast<int>(cudaGetLastError());
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
// float32 (is_float 1); out: (n, c, p) of the table's type. vec: x and out
// are 16-byte aligned.
int stainx_apply_lut(const void* x, void* out, const void* table, long long total, long long p,
                     int c, int is_float, int vec, int blocks, void* stream) {
  launch_apply(static_cast<const uint8_t*>(x), out, table, total, p, c, is_float, vec, blocks,
               static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
