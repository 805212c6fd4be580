// Macenko fit and transform kernels for Hopper (sm_90a), with a plain C
// interface loaded through ctypes (stainx_tpu_torch/kernels/macenko_fused.py).
//
// What they replace
//   resident_kernel and transform_kernel, its two bodies:
//     stainx_tpu/kernels/macenko_fused.py::macenko_transform_mega
//     (_mega_kernel), the whole per-image Macenko transform (B1).
//   fit_kernel: stainx_tpu/kernels/macenko_fused.py::macenko_fit_mega
//     (_fit_mega_kernel), the pooled reference fit (B2).
//   All use the device helpers of macenko_common.cuh (OD, covariance of the
//   10 moments about OD-1, the closed-form 3x3 eigh, the diamond pseudo-angle
//   and its inverse, H/E ordering, the 2x2 normal rows, the maxC scale) and
//   an exact radix select on the monotone key of keys.cuh (the job of
//   selection.py's radix_select_multi inside the TPU kernels).
//
// What bounds them
//   B1 on the small-patch path (256x3x64^2 uint8) must read and write 6.3 MB:
//   1.9 us at 3.35 TB/s. Its arithmetic (about 90 float ops a pixel, 1 M
//   pixels) needs 1.4 us at 67 TFLOP/s. The fit of one 64^2 reference needs
//   far less. What takes the time is one image's chain of dependent steps:
//   sums, a closed-form eigh, exact selections, each a few block barriers.
//
// What the design does about it
//   resident_kernel (B1 wherever an image fits a block's shared memory:
//   uint8 up to 19 222 pixels, float32 up to 10 572 on an H100; the wrapper's
//   size rule, kernels/macenko_fused.py::transform_body) gives an image one
//   block of 512 threads, two blocks an SM, so 256 images run in one wave
//   and their chains overlap. The block reads its image from device memory
//   once into shared memory (uint8 raw values; float32 as OD, each logarithm
//   taken once) and computes each selection's keys once, into shared
//   memory: the angle keys, then the two concentrations' keys, which the
//   reconstruction reads back (unkey of a concentration key is the
//   concentration itself, bit for bit). Each selection's radix descent
//   starts below the bits its smallest and largest key share, as B3's does,
//   so the angles take about 3 passes of 8 bits and the concentrations 4,
//   each over shared memory; a pass counts into 8 histogram copies (no warp
//   matching), which 512 threads sum, and a warp picks each bin. Moments
//   add a 4-pixel group in float32, then the groups in float64.
//   transform_kernel (B1 for larger rows) and fit_kernel (B2) are
//   multi-pass over device memory and L2, one block of 1024 threads an
//   image or the pool: one moments pass (a second one only for the
//   <3-pixel fallback), 4 passes for the two angle selections, 4 for the
//   two concentration selections, and at transform one reconstruction pass.
//   Every pass recomputes OD, the projections and the keys from the raw
//   values instead of storing them, so device memory sees one read of the
//   input and one write of the output. uint8 OD is a 256-entry table in
//   shared memory, built once per block with the same formula. Rows whose
//   pixel count is a multiple of 4 are read 4 pixels per thread (uchar4 /
//   float4).
//
// Exactness and determinism
//   Sums use no float atomics: each thread accumulates in double in a fixed
//   order, then warp shuffles and one warp combine the partial sums in a
//   fixed order, so two runs give the same bits. The count is an integer.
//   Selections are radix selects on the uint32 monotone key, 8 bits a pass:
//   each pass counts the keys that match the prefix chosen so far in a
//   256-bin shared-memory histogram (integer atomics: exact in any order)
//   and descends into the bin holding the rank. The result is unkey(final
//   prefix), an actual element of the data. The two angle ranks share one
//   key and the two concentration selections share their passes. The L2
//   bodies count sentinel keys too; the resident body skips keys at or above
//   the sentinel, as B4 and B6 do; the ranks never reach them.
//   The TPU kernels carried probe seeds from image to image (_select_seeded);
//   blocks here run in parallel and the radix select needs no probes, so the
//   seed state is passed through by the Python layer.
//
// Formulas
//   Eigenvalues use the trigonometric closed form with acosf/cosf, the same
//   arithmetic as stainx_tpu_torch/ops/eigh3.py (the plain versions call it);
//   the JAX kernel's trig-free _cos_third_acos root was a Mosaic workaround.
//   Angles use the diamond pseudo-angle and _dir_from_pseudo, as the JAX
//   kernels do. Built with -fmad=false, so products and sums round as in the
//   plain PyTorch versions.

#include <cuda_runtime.h>

#include <cstdint>

#include "macenko_common.cuh"

namespace {

using namespace stainx;

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;

struct Shared {
  float lut[256];                 // uint8 value -> OD
  double part[kWarps][kSums];     // per-warp partial sums
  double sums[kSums];             // block totals
  unsigned int hist[2][kBins];    // radix histograms of the two selections
  uint32_t prefix[2];             // key bits chosen so far
  long long rank[2];              // rank left within the chosen prefix
  float evs[6];                   // v_mid (3), v_max (3)
  float m0[3];                    // normal rows of the HE columns
  float m1[3];
  float he[6];                    // HE row-major (3, 2)
  float scale[2];                 // tmc / maxC
};

// Calls f(ok, od, img_index, group) for every group of V pixels of the
// n_img images of a row, block-stride. Every thread of the block runs the
// same number of iterations (ok marks the real groups), so warp-wide
// intrinsics inside f see full warps.
template <typename T, int V, typename F>
__device__ __forceinline__ void sweep(const T* x, int n_img, int64_t p, const float* lut, F&& f) {
  const int64_t groups = p / V;
  for (int i = 0; i < n_img; ++i) {
    const T* img = x + static_cast<int64_t>(i) * 3 * p;
    for (int64_t g0 = 0; g0 < groups; g0 += blockDim.x) {
      const int64_t g = g0 + threadIdx.x;
      const bool ok = g < groups;
      float od[3][V];
      if (ok) {
        load_od<T, V>(img, p, g, lut, od);
      } else {
        for (int c = 0; c < 3; ++c)
          for (int j = 0; j < V; ++j) od[c][j] = 0.0f;
      }
      f(ok, od, i, g);
    }
  }
}

// --------------------------------------------------------------- reductions
// Block sum of kSums doubles into sh.sums, in a fixed order (Warps warps;
// sh.part holds a row a warp).
template <int Warps, typename S>
__device__ void block_sum(double (&acc)[kSums], S& sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int k = 0; k < kSums; ++k) {
    for (int off = 16; off > 0; off >>= 1) acc[k] += __shfl_down_sync(kFull, acc[k], off);
  }
  if (lane == 0) {
    for (int k = 0; k < kSums; ++k) sh.part[warp][k] = acc[k];
  }
  __syncthreads();
  if (warp == 0) {
    for (int k = 0; k < kSums; ++k) {
      double v = lane < Warps ? sh.part[lane][k] : 0.0;
      for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(kFull, v, off);
      if (lane == 0) sh.sums[k] = v;
    }
  }
  __syncthreads();
}

// Count and moments about OD-1 of the beta-masked pixels (or all pixels).
template <typename T, int V>
__device__ void moments(const T* x, int n_img, int64_t p, bool all, Shared& sh) {
  double acc[kSums];
  for (int k = 0; k < kSums; ++k) acc[k] = 0.0;
  sweep<T, V>(x, n_img, p, sh.lut, [&](bool ok, const float (&od)[3][V], int, int64_t) {
    for (int j = 0; j < V; ++j) {
      if (!ok || !(all || min3(od[0][j], od[1][j], od[2][j]) >= kBeta)) continue;
      const float y0 = od[0][j] - 1.0f, y1 = od[1][j] - 1.0f, y2 = od[2][j] - 1.0f;
      acc[0] += 1.0;
      acc[1] += y0;
      acc[2] += y1;
      acc[3] += y2;
      acc[4] += static_cast<double>(y0 * y0);
      acc[5] += static_cast<double>(y0 * y1);
      acc[6] += static_cast<double>(y0 * y2);
      acc[7] += static_cast<double>(y1 * y1);
      acc[8] += static_cast<double>(y1 * y2);
      acc[9] += static_cast<double>(y2 * y2);
    }
  });
  block_sum<kWarps>(acc, sh);
}

// ---------------------------------------------------------------- selection
// One warp finds the bin of selection s that holds its rank, and descends.
__device__ void descend(Shared& sh, int s, int shift) {
  const int lane = threadIdx.x & 31;
  const long long r = sh.rank[s];
  unsigned local[8];
  long long total = 0;
  for (int i = 0; i < 8; ++i) {
    local[i] = sh.hist[s][lane * 8 + i];
    total += local[i];
  }
  long long incl = total;
  for (int off = 1; off < 32; off <<= 1) {
    const long long up = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += up;
  }
  long long below = incl - total;
  if (below <= r && r < incl) {
    for (int i = 0; i < 8; ++i) {
      if (r < below + local[i]) {
        sh.prefix[s] |= static_cast<uint32_t>(lane * 8 + i) << shift;
        sh.rank[s] = r - below;
        break;
      }
      below += local[i];
    }
  }
}

// Two exact rank selections over the keys key2(od, j, k0, k1) of every
// pixel, 8 key bits a pass. Reads sh.rank, leaves the selected keys in
// sh.prefix.
template <typename T, int V, typename KeyFn>
__device__ void select2(const T* x, int n_img, int64_t p, Shared& sh, KeyFn&& key2) {
  const int warp = threadIdx.x >> 5;
  for (int d = 0; d < 4; ++d) {
    const int shift = 24 - 8 * d;
    for (int i = threadIdx.x; i < 2 * kBins; i += blockDim.x) sh.hist[i / kBins][i % kBins] = 0u;
    __syncthreads();
    const uint32_t pre0 = sh.prefix[0], pre1 = sh.prefix[1];
    sweep<T, V>(x, n_img, p, sh.lut, [&](bool ok, const float (&od)[3][V], int, int64_t) {
      for (int j = 0; j < V; ++j) {
        uint32_t k0, k1;
        key2(od, j, k0, k1);
        const bool in0 = ok && (d == 0 || ((k0 ^ pre0) >> (shift + 8)) == 0u);
        const bool in1 = ok && (d == 0 || ((k1 ^ pre1) >> (shift + 8)) == 0u);
        hist_add(sh.hist[0], in0 ? (k0 >> shift) & 0xFFu : kBins);
        hist_add(sh.hist[1], in1 ? (k1 >> shift) & 0xFFu : kBins);
      }
    });
    __syncthreads();
    if (warp < 2) descend(sh, warp, shift);
    __syncthreads();
  }
}

// ----------------------------------------------------------- shared pipeline
// Everything both kernels compute before reconstruction: moments (with the
// <3-pixel fallback when `fallback`), eigh, the two angle selections, HE and
// normal rows, and the two concentration selections. Leaves sh.he, sh.m0,
// sh.m1 and the selected concentration keys in sh.prefix.
template <typename T, int V>
__device__ void stain_params(const T* x, int n_img, int64_t p, bool fallback, long long idx99,
                             Shared& sh) {
  build_lut<T>(sh.lut);
  __syncthreads();
  moments<T, V>(x, n_img, p, false, sh);
  const bool use_all = fallback && sh.sums[0] < 3.0;  // block-uniform
  if (use_all) moments<T, V>(x, n_img, p, true, sh);

  if (threadIdx.x == 0) {
    float a[6];
    cov_from_moments(sh.sums, a);
    eigh3_top2(a, sh.evs);
    const long long cnt = static_cast<long long>(sh.sums[0]);
    sh.rank[0] = nearest_rank_index(kAlpha, cnt);
    sh.rank[1] = nearest_rank_index(100 - kAlpha, cnt);
    sh.prefix[0] = sh.prefix[1] = 0u;
  }
  __syncthreads();

  float v[6];
  for (int k = 0; k < 6; ++k) v[k] = sh.evs[k];
  select2<T, V>(x, n_img, p, sh, [&](const float (&od)[3][V], int j, uint32_t& k0, uint32_t& k1) {
    const float t0 = od[0][j] * v[0] + od[1][j] * v[1] + od[2][j] * v[2];
    const float t1 = od[0][j] * v[3] + od[1][j] * v[4] + od[2][j] * v[5];
    const bool member = use_all || min3(od[0][j], od[1][j], od[2][j]) >= kBeta;
    k0 = member ? monotone_key(pseudo_angle(t0, t1)) : kSentinelKey;
    k1 = k0;
  });

  if (threadIdx.x == 0) {
    stain_from_phi(sh.evs, unkey(sh.prefix[0]), unkey(sh.prefix[1]), sh.he, sh.m0, sh.m1);
    sh.rank[0] = sh.rank[1] = idx99;
    sh.prefix[0] = sh.prefix[1] = 0u;
  }
  __syncthreads();

  float m[6];
  for (int k = 0; k < 3; ++k) {
    m[k] = sh.m0[k];
    m[3 + k] = sh.m1[k];
  }
  select2<T, V>(x, n_img, p, sh, [&](const float (&od)[3][V], int j, uint32_t& k0, uint32_t& k1) {
    k0 = monotone_key(od[0][j] * m[0] + od[1][j] * m[1] + od[2][j] * m[2]);
    k1 = monotone_key(od[0][j] * m[3] + od[1][j] * m[4] + od[2][j] * m[5]);
  });
}

// ------------------------------------------------------------------ kernels
// One block per image: the whole Macenko transform of image blockIdx.x.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads, 1)
transform_kernel(const T* __restrict__ x, T* __restrict__ out, const float* __restrict__ stain,
                 const float* __restrict__ tmc, int64_t p, long long idx99) {
  __shared__ Shared sh;
  const int64_t offset = static_cast<int64_t>(blockIdx.x) * 3 * p;
  const T* img = x + offset;
  stain_params<T, V>(img, 1, p, true, idx99, sh);

  if (threadIdx.x == 0) {
    sh.scale[0] = maxc_scale(tmc[0], unkey(sh.prefix[0]));
    sh.scale[1] = maxc_scale(tmc[1], unkey(sh.prefix[1]));
  }
  __syncthreads();

  float m[6], st[6];
  for (int k = 0; k < 3; ++k) {
    m[k] = sh.m0[k];
    m[3 + k] = sh.m1[k];
  }
  for (int k = 0; k < 6; ++k) st[k] = stain[k];
  const float sc0 = sh.scale[0], sc1 = sh.scale[1];
  T* dst = out + offset;
  sweep<T, V>(img, 1, p, sh.lut, [&](bool ok, const float (&od)[3][V], int, int64_t g) {
    if (!ok) return;
    float rgb[3][V];
    for (int j = 0; j < V; ++j) {
      const float cn0 = (od[0][j] * m[0] + od[1][j] * m[1] + od[2][j] * m[2]) * sc0;
      const float cn1 = (od[0][j] * m[3] + od[1][j] * m[4] + od[2][j] * m[5]) * sc1;
      for (int c = 0; c < 3; ++c) rgb[c][j] = reconstruct(st, c, cn0, cn1);
    }
    store_rgb<T, V>(dst, p, g, rgb);
  });
}

// One block for the whole pool: HE (3, 2) row-major and maxC (2) into out8.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads, 1)
fit_kernel(const T* __restrict__ x, float* __restrict__ out8, int n_img, int64_t p,
           long long idx99) {
  __shared__ Shared sh;
  stain_params<T, V>(x, n_img, p, false, idx99, sh);
  if (threadIdx.x == 0) {
    for (int k = 0; k < 6; ++k) out8[k] = sh.he[k];
    out8[6] = unkey(sh.prefix[0]);
    out8[7] = unkey(sh.prefix[1]);
  }
}

// ============================================================ resident body
// B1 for rows that fit one block's shared memory: a block of kRThreads a
// image, several images an SM. The image is read from device memory once;
// every later pass reads shared memory.
constexpr int kRThreads = 512;
constexpr int kRWarps = kRThreads / 32;
// A resident block counts a pass's digits into kRCopies copies of both
// selections' histograms, lane l into copy l % kRCopies, copies a bank apart
// (kRCopyStride words): lanes whose keys crowd one bin (angles and
// concentrations fill a few bins of a digit) conflict at most 4 ways, with
// no warp matching.
constexpr int kRCopies = 8;
constexpr int kRCopyStride = 2 * kBins + 1;

// The fixed head of a resident block's shared memory (kernels/macenko_fused.py
// RESIDENT_FIXED_BYTES); the keys of the two selections (p uint32 each),
// then, from the next 16-byte boundary, the image's three planes (uint8 raw
// values, or float32 OD) follow it.
struct ResidentShared {
  float lut[256];                 // uint8 value -> OD
  double part[kRWarps][kSums];    // per-warp partial sums
  double sums[kSums];             // block totals
  unsigned int rep[kRCopies * kRCopyStride];  // the pass's histogram copies
  unsigned int hist[2][kBins];    // the pass's histograms of the two selections
  uint32_t lo[2], hi[2];          // smallest and largest key below the sentinel
  unsigned int cnt[2];            // keys below the sentinel
  uint32_t prefix[2];             // key bits chosen so far
  long long rank[2];              // rank left within the chosen prefix
  int top[2];                     // low key bits still to choose
  float evs[6];                   // v_mid (3), v_max (3)
  float m0[3];                    // normal rows of the HE columns
  float m1[3];
  float he[6];                    // HE row-major (3, 2)
  float pad[4];                   // to a multiple of 16 bytes
};
constexpr int kResidentFixed = 20992;
static_assert(sizeof(ResidentShared) == kResidentFixed, "ResidentShared layout");
static_assert(kResidentFixed % 16 == 0, "the keys start 16-byte aligned");

// What a resident plane holds for pixel value v: uint8 keeps the raw value
// (OD through the table), float32 the OD itself, computed once at load.
__device__ __forceinline__ float stored_od(uint8_t v, const float* lut) { return lut[v]; }
__device__ __forceinline__ float stored_od(float v, const float*) { return v; }

// Copies the image's 3 * p values (contiguous planes) into shared memory:
// 16-byte loads where the image is 16-byte aligned, 4-byte ones where it
// is 4-byte aligned, then single bytes.
template <typename T>
__device__ void load_image(const T* __restrict__ img, int p, T* planes) {
  const auto* src = reinterpret_cast<const unsigned char*>(img);
  auto* dst = reinterpret_cast<unsigned char*>(planes);
  const int bytes = 3 * p * static_cast<int>(sizeof(T));
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int units = bytes / 16;
    for (int u = threadIdx.x; u < units; u += kRThreads) {
      reinterpret_cast<uint4*>(dst)[u] = __ldg(reinterpret_cast<const uint4*>(src) + u);
    }
    done = units * 16;
  } else if ((reinterpret_cast<uintptr_t>(src) & 3) == 0) {
    const int units = bytes / 4;
    for (int u = threadIdx.x; u < units; u += kRThreads) {
      reinterpret_cast<unsigned*>(dst)[u] = __ldg(reinterpret_cast<const unsigned*>(src) + u);
    }
    done = units * 4;
  }
  for (int b = done + threadIdx.x; b < bytes; b += kRThreads) dst[b] = __ldg(src + b);
}

// Calls f(ok, od, g) for every group of V pixels [V*g, V*g + V) of the
// resident planes, block-stride; every thread runs the same iterations (ok
// marks the real groups), so warp-wide intrinsics inside f see full warps.
template <typename T, int V, typename F>
__device__ __forceinline__ void rsweep(const T* planes, int p, const float* lut, F&& f) {
  const int groups = p / V;
  for (int g0 = 0; g0 < groups; g0 += kRThreads) {
    const int g = g0 + threadIdx.x;
    const bool ok = g < groups;
    float od[3][V];
    for (int c = 0; c < 3; ++c) {
      if constexpr (V == 4) {
        const auto q = ok ? reinterpret_cast<const typename Vec4<T>::type*>(planes + c * p)[g]
                          : typename Vec4<T>::type{};
        od[c][0] = stored_od(q.x, lut);
        od[c][1] = stored_od(q.y, lut);
        od[c][2] = stored_od(q.z, lut);
        od[c][3] = stored_od(q.w, lut);
      } else {
        od[c][0] = stored_od(ok ? planes[c * p + g] : T(0), lut);
      }
    }
    f(ok, od, g);
  }
}

// The keys of group g (V of them) of a resident key array.
template <int V>
__device__ __forceinline__ void load_keys(const uint32_t* keys, int g, uint32_t (&k)[V]) {
  if constexpr (V == 4) {
    const uint4 q = reinterpret_cast<const uint4*>(keys)[g];
    k[0] = q.x;
    k[1] = q.y;
    k[2] = q.z;
    k[3] = q.w;
  } else {
    k[0] = keys[g];
  }
}

template <int V>
__device__ __forceinline__ void store_keys(uint32_t* keys, int g, const uint32_t (&k)[V]) {
  if constexpr (V == 4) reinterpret_cast<uint4*>(keys)[g] = make_uint4(k[0], k[1], k[2], k[3]);
  else keys[g] = k[0];
}

// A thread's smallest and largest key below the sentinel, and their count.
struct Extremes {
  uint32_t lo = 0xFFFFFFFFu, hi = 0u;
  unsigned n = 0u;
  __device__ __forceinline__ void add(bool ok, uint32_t k) {
    if (ok && k < kSentinelKey) {
      lo = k < lo ? k : lo;
      hi = k > hi ? k : hi;
      ++n;
    }
  }
};

// Adds every thread's extremes of selection s into sh (set to lo = ~0, hi
// = 0, cnt = 0 before). Every thread must call it.
__device__ __forceinline__ void reduce_extremes(const Extremes& e, int s, ResidentShared& sh) {
  const uint32_t lo = __reduce_min_sync(kFull, e.lo), hi = __reduce_max_sync(kFull, e.hi);
  const unsigned n = __reduce_add_sync(kFull, e.n);
  if ((threadIdx.x & 31) == 0) {
    atomicMin(&sh.lo[s], lo);
    atomicMax(&sh.hi[s], hi);
    atomicAdd(&sh.cnt[s], n);
  }
}

__device__ __forceinline__ void reset_extremes(ResidentShared& sh) {
  for (int s = 0; s < 2; ++s) {
    sh.lo[s] = 0xFFFFFFFFu;
    sh.hi[s] = 0u;
    sh.cnt[s] = 0u;
  }
}

// The moments of the beta-masked (or, with all, every) pixel: a group's V
// pixels are added in float32, the groups in float64 (one conversion a
// group and moment, not a pixel: the conversions bounded this pass), all in
// a fixed order, so repeat runs give the same bits.
template <typename T, int V>
__device__ void rmoments(const T* planes, int p, bool all, ResidentShared& sh) {
  double acc[kSums];
  for (int k = 0; k < kSums; ++k) acc[k] = 0.0;
  rsweep<T, V>(planes, p, sh.lut, [&](bool ok, const float (&od)[3][V], int) {
    float part[kSums];
    for (int k = 0; k < kSums; ++k) part[k] = 0.0f;
    for (int j = 0; j < V; ++j) {
      if (!ok || !(all || min3(od[0][j], od[1][j], od[2][j]) >= kBeta)) continue;
      const float y0 = od[0][j] - 1.0f, y1 = od[1][j] - 1.0f, y2 = od[2][j] - 1.0f;
      part[0] += 1.0f;
      part[1] += y0;
      part[2] += y1;
      part[3] += y2;
      part[4] += y0 * y0;
      part[5] += y0 * y1;
      part[6] += y0 * y2;
      part[7] += y1 * y1;
      part[8] += y1 * y2;
      part[9] += y2 * y2;
    }
    for (int k = 0; k < kSums; ++k) acc[k] += static_cast<double>(part[k]);
  });
  block_sum<kRWarps>(acc, sh);
}

__device__ __forceinline__ void rep_add(unsigned* rep, int s, bool in, unsigned bin) {
  if (in) atomicAdd(rep + (threadIdx.x & (kRCopies - 1)) * kRCopyStride + s * kBins + bin, 1u);
}

// One warp: the bin of the kBins counts h (16-byte aligned) that holds
// rank (0 <= rank < the counts' sum), and the rank left inside that bin.
// Lane l reads bins [8l, 8l + 8) in two 16-byte loads, then a prefix sum
// over the lanes in 32-bit integers (a resident image has fewer than 2^31
// pixels).
__device__ __forceinline__ void rpick(const unsigned* h, int rank, unsigned& bin, int& rem) {
  const int lane = threadIdx.x & 31;
  const uint4 q0 = reinterpret_cast<const uint4*>(h)[2 * lane];
  const uint4 q1 = reinterpret_cast<const uint4*>(h)[2 * lane + 1];
  const int local[8] = {static_cast<int>(q0.x), static_cast<int>(q0.y), static_cast<int>(q0.z),
                        static_cast<int>(q0.w), static_cast<int>(q1.x), static_cast<int>(q1.y),
                        static_cast<int>(q1.z), static_cast<int>(q1.w)};
  int total = 0;
  for (int i = 0; i < 8; ++i) total += local[i];
  int incl = total;
  for (int off = 1; off < 32; off <<= 1) {
    const int up = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += up;
  }
  int below = incl - total;
  const bool mine = below <= rank && rank < incl;
  unsigned b = 0u;
  int r = 0;
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
  const int who = __ffs(__ballot_sync(kFull, mine)) - 1;
  bin = __shfl_sync(kFull, b, who);
  rem = __shfl_sync(kFull, r, who);
}

// Two exact selections from resident keys: rank sh.rank[s] among the keys
// below the sentinel of keys s (k0 == k1 for the two angle ranks), a rank
// past their count taking the largest and no key giving +inf (B4's and
// B6's conventions). The descent starts below the bits that the
// selection's extremes share (sh.lo, sh.hi, sh.cnt) and chooses up to 8
// bits a pass: the keys under the prefix count their digit into the
// histogram copies (one histogram while both selections read the same keys
// under the same prefix), the copies are summed (and cleared) into sh.hist,
// and a warp a selection picks the bin holding the rank. Leaves the
// selected keys in sh.prefix.
template <int V>
__device__ void rselect2(const uint32_t* k0, const uint32_t* k1, int p, ResidentShared& sh) {
  if (threadIdx.x < 2) {
    const int s = threadIdx.x;
    const int n = static_cast<int>(sh.cnt[s]);
    if (n == 0) {
      sh.prefix[s] = kSentinelKey;
      sh.top[s] = 0;
    } else {
      const long long r = sh.rank[s];
      sh.rank[s] = r < 0 ? 0 : (r >= n ? n - 1 : r);
      uint32_t prefix = sh.lo[s];
      sh.top[s] = sh.lo[s] == sh.hi[s] ? 0 : common_top(sh.lo[s], sh.hi[s], prefix);
      sh.prefix[s] = prefix;
    }
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  const int groups = p / V;
  for (;;) {
    const int top0 = sh.top[0], top1 = sh.top[1];  // block-uniform
    if (top0 == 0 && top1 == 0) break;
    const uint32_t pre0 = sh.prefix[0], pre1 = sh.prefix[1];
    const bool one = k0 == k1 && top0 == top1 && pre0 == pre1;  // one histogram serves both
    for (int g = threadIdx.x; g < groups; g += kRThreads) {
      uint32_t a[V];
      if (top0 > 0) {
        load_keys<V>(k0, g, a);
        for (int j = 0; j < V; ++j) {
          const bool in = a[j] < kSentinelKey && under_prefix(a[j], pre0, top0);
          rep_add(sh.rep, 0, in, in ? digit_at(a[j], top0) : 0u);
        }
      }
      if (top1 > 0 && !one) {
        load_keys<V>(k1, g, a);
        for (int j = 0; j < V; ++j) {
          const bool in = a[j] < kSentinelKey && under_prefix(a[j], pre1, top1);
          rep_add(sh.rep, 1, in, in ? digit_at(a[j], top1) : 0u);
        }
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < 2 * kBins; i += kRThreads) {
      unsigned c = 0u;
      for (int k = 0; k < kRCopies; ++k) {
        c += sh.rep[k * kRCopyStride + i];
        sh.rep[k * kRCopyStride + i] = 0u;
      }
      sh.hist[i / kBins][i % kBins] = c;
    }
    __syncthreads();
    if (warp < 2 && sh.top[warp] > 0) {
      unsigned bin;
      int rem;
      rpick(sh.hist[one ? 0 : warp], static_cast<int>(sh.rank[warp]), bin, rem);
      if ((threadIdx.x & 31) == 0) {
        const int top = sh.top[warp];
        sh.prefix[warp] |= bin << digit_shift(top);
        sh.rank[warp] = rem;
        sh.top[warp] = digit_shift(top);
      }
    }
    __syncthreads();
  }
}

// Check only: copies the resident keys of image img into rows [row0,
// row0 + rows) of its (3, p) block of `keys` (angles, then the two
// concentrations).
__device__ void copy_keys(const uint32_t* resident, uint32_t* keys, int64_t img, int row0, int rows,
                          int p) {
  uint32_t* dst = keys + (img * 3 + row0) * p;
  for (int i = threadIdx.x; i < rows * p; i += kRThreads) dst[i] = resident[i];
}

// One block per image: the whole Macenko transform of image blockIdx.x with
// the image resident in shared memory. With kCheck it also writes the keys
// it selected on into keys ((n, 3, p) uint32) and the selected values into
// sel ((n, 4) float32: the two angles, the two maxC).
template <typename T, int V, bool kCheck>
__global__ void __launch_bounds__(kRThreads, 2)
resident_kernel(const T* __restrict__ x, T* __restrict__ out, const float* __restrict__ stain,
                const float* __restrict__ tmc, int p, long long idx99, uint32_t* keys, float* sel) {
  extern __shared__ __align__(16) unsigned char smem[];
  ResidentShared& sh = *reinterpret_cast<ResidentShared*>(smem);
  uint32_t* keys0 = reinterpret_cast<uint32_t*>(smem + kResidentFixed);
  uint32_t* keys1 = keys0 + p;
  T* planes = reinterpret_cast<T*>(smem + kResidentFixed + ((8 * p + 15) & ~15));
  const int64_t offset = static_cast<int64_t>(blockIdx.x) * 3 * p;
  build_lut<T>(sh.lut);
  for (int i = threadIdx.x; i < kRCopies * kRCopyStride; i += kRThreads) sh.rep[i] = 0u;
  load_image<T>(x + offset, p, planes);
  __syncthreads();
  if constexpr (sizeof(T) == 4) {  // float32: the planes hold OD from here on
    for (int i = threadIdx.x; i < 3 * p; i += kRThreads) planes[i] = od_f32(planes[i]);
    __syncthreads();
  }

  rmoments<T, V>(planes, p, false, sh);
  const bool use_all = sh.sums[0] < 3.0;  // block-uniform: the <3-pixel fallback
  if (use_all) rmoments<T, V>(planes, p, true, sh);
  if (threadIdx.x == 0) {
    float a[6];
    cov_from_moments(sh.sums, a);
    eigh3_top2(a, sh.evs);
    const long long cnt = static_cast<long long>(sh.sums[0]);
    sh.rank[0] = nearest_rank_index(kAlpha, cnt);
    sh.rank[1] = nearest_rank_index(100 - kAlpha, cnt);
    reset_extremes(sh);
  }
  __syncthreads();

  // The angle keys, once: the pseudo-angle in the stain plane, the sentinel
  // off the beta-mask.
  {
    float v[6];
    for (int k = 0; k < 6; ++k) v[k] = sh.evs[k];
    Extremes e;
    rsweep<T, V>(planes, p, sh.lut, [&](bool ok, const float (&od)[3][V], int g) {
      uint32_t k[V];
      for (int j = 0; j < V; ++j) {
        const float t0 = od[0][j] * v[0] + od[1][j] * v[1] + od[2][j] * v[2];
        const float t1 = od[0][j] * v[3] + od[1][j] * v[4] + od[2][j] * v[5];
        const bool member = use_all || min3(od[0][j], od[1][j], od[2][j]) >= kBeta;
        k[j] = member ? monotone_key(pseudo_angle(t0, t1)) : kSentinelKey;
        e.add(ok, k[j]);
      }
      if (ok) store_keys<V>(keys0, g, k);
    });
    reduce_extremes(e, 0, sh);
    reduce_extremes(e, 1, sh);
  }
  __syncthreads();
  if constexpr (kCheck) copy_keys(keys0, keys, blockIdx.x, 0, 1, p);
  rselect2<V>(keys0, keys0, p, sh);

  if (threadIdx.x == 0) {
    if constexpr (kCheck) {
      sel[4 * blockIdx.x] = unkey(sh.prefix[0]);
      sel[4 * blockIdx.x + 1] = unkey(sh.prefix[1]);
    }
    stain_from_phi(sh.evs, unkey(sh.prefix[0]), unkey(sh.prefix[1]), sh.he, sh.m0, sh.m1);
    sh.rank[0] = sh.rank[1] = idx99;
    reset_extremes(sh);
  }
  __syncthreads();

  // The two concentration keys, once; the reconstruction reads them back.
  float m[6];
  for (int k = 0; k < 3; ++k) {
    m[k] = sh.m0[k];
    m[3 + k] = sh.m1[k];
  }
  {
    Extremes e0, e1;
    rsweep<T, V>(planes, p, sh.lut, [&](bool ok, const float (&od)[3][V], int g) {
      uint32_t a[V], b[V];
      for (int j = 0; j < V; ++j) {
        a[j] = monotone_key(od[0][j] * m[0] + od[1][j] * m[1] + od[2][j] * m[2]);
        b[j] = monotone_key(od[0][j] * m[3] + od[1][j] * m[4] + od[2][j] * m[5]);
        e0.add(ok, a[j]);
        e1.add(ok, b[j]);
      }
      if (ok) {
        store_keys<V>(keys0, g, a);
        store_keys<V>(keys1, g, b);
      }
    });
    reduce_extremes(e0, 0, sh);
    reduce_extremes(e1, 1, sh);
  }
  __syncthreads();
  if constexpr (kCheck) copy_keys(keys0, keys, blockIdx.x, 1, 2, p);
  rselect2<V>(keys0, keys1, p, sh);
  if (kCheck && threadIdx.x == 0) {
    sel[4 * blockIdx.x + 2] = unkey(sh.prefix[0]);
    sel[4 * blockIdx.x + 3] = unkey(sh.prefix[1]);
  }

  float st[6];
  for (int k = 0; k < 6; ++k) st[k] = stain[k];
  const float sc0 = maxc_scale(tmc[0], unkey(sh.prefix[0]));
  const float sc1 = maxc_scale(tmc[1], unkey(sh.prefix[1]));
  T* dst = out + offset;
  for (int g = threadIdx.x; g < p / V; g += kRThreads) {
    uint32_t a[V], b[V];
    load_keys<V>(keys0, g, a);
    load_keys<V>(keys1, g, b);
    float rgb[3][V];
    for (int j = 0; j < V; ++j) {
      const float cn0 = unkey(a[j]) * sc0;
      const float cn1 = unkey(b[j]) * sc1;
      for (int c = 0; c < 3; ++c) rgb[c][j] = reconstruct(st, c, cn0, cn1);
    }
    store_rgb<T, V>(dst, p, g, rgb);
  }
}

template <typename T, int V, bool kCheck>
cudaError_t launch_resident(const T* x, T* out, const float* stain, const float* tmc, long long n,
                            long long p, long long idx99, size_t smem, uint32_t* keys, float* sel,
                            cudaStream_t s) {
  const cudaError_t e = cudaFuncSetAttribute(resident_kernel<T, V, kCheck>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  resident_kernel<T, V, kCheck><<<static_cast<unsigned>(n), kRThreads, smem, s>>>(
      x, out, stain, tmc, static_cast<int>(p), idx99, keys, sel);
  return cudaSuccess;
}

template <typename T>
cudaError_t launch_transform(const void* x, void* out, const float* stain, const float* tmc,
                             long long n, long long p, int vec4, long long idx99, long long smem,
                             uint32_t* keys, float* sel, cudaStream_t s) {
  const auto* xi = static_cast<const T*>(x);
  auto* xo = static_cast<T*>(out);
  const dim3 grid(static_cast<unsigned>(n));
  if (keys != nullptr) {
    return vec4 ? launch_resident<T, 4, true>(xi, xo, stain, tmc, n, p, idx99, smem, keys, sel, s)
                : launch_resident<T, 1, true>(xi, xo, stain, tmc, n, p, idx99, smem, keys, sel, s);
  }
  if (smem > 0) {
    return vec4 ? launch_resident<T, 4, false>(xi, xo, stain, tmc, n, p, idx99, smem, keys, sel, s)
                : launch_resident<T, 1, false>(xi, xo, stain, tmc, n, p, idx99, smem, keys, sel, s);
  }
  if (vec4) transform_kernel<T, 4><<<grid, kThreads, 0, s>>>(xi, xo, stain, tmc, p, idx99);
  else transform_kernel<T, 1><<<grid, kThreads, 0, s>>>(xi, xo, stain, tmc, p, idx99);
  return cudaSuccess;
}

}  // namespace

// ------------------------------------------------------------- C interface
extern "C" {

const char* stainx_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x, out: (n, 3, p) contiguous uint8 or float32; stain: (3, 2) float32;
// tmc: (2,) float32; all on the current device. smem: the resident body's
// dynamic shared memory (kResidentFixed, then 8p and 3p * sizeof(T) bytes,
// each rounded up to 16), or 0 for the body that re-reads the image from L2. keys and sel are
// null, or (check only, resident body) (n, 3, p) uint32 and (n, 4) float32
// for the keys each image selected on and the selected values. Returns the
// CUDA error of the launch.
int stainx_macenko_transform_mega(const void* x, void* out, const void* stain, const void* tmc,
                                  long long n, long long p, int is_uint8, int vec4,
                                  long long idx99, long long smem, void* keys, void* sel,
                                  void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* st = static_cast<const float*>(stain);
  const auto* tm = static_cast<const float*>(tmc);
  auto* k = static_cast<uint32_t*>(keys);
  auto* sl = static_cast<float*>(sel);
  const cudaError_t e =
      is_uint8 ? launch_transform<uint8_t>(x, out, st, tm, n, p, vec4, idx99, smem, k, sl, s)
               : launch_transform<float>(x, out, st, tm, n, p, vec4, idx99, smem, k, sl, s);
  if (e != cudaSuccess) {
    cudaGetLastError();  // clear it: the wrapper raises
    return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}

// x: (n, 3, p) contiguous uint8 or float32, pooled; out8: (8,) float32.
int stainx_macenko_fit_mega(const void* x, void* out8, long long n, long long p, int is_uint8,
                            int vec4, long long idx99, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  auto* o = static_cast<float*>(out8);
  const int ni = static_cast<int>(n);
  if (is_uint8) {
    const auto* xi = static_cast<const uint8_t*>(x);
    if (vec4) fit_kernel<uint8_t, 4><<<1, kThreads, 0, s>>>(xi, o, ni, p, idx99);
    else fit_kernel<uint8_t, 1><<<1, kThreads, 0, s>>>(xi, o, ni, p, idx99);
  } else {
    const auto* xi = static_cast<const float*>(x);
    if (vec4) fit_kernel<float, 4><<<1, kThreads, 0, s>>>(xi, o, ni, p, idx99);
    else fit_kernel<float, 1><<<1, kThreads, 0, s>>>(xi, o, ni, p, idx99);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
