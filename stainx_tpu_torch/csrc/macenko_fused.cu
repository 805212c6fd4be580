// Macenko fit and transform kernels for Hopper (sm_90a), with a plain C
// interface loaded through ctypes (stainx_tpu_torch/kernels/macenko_fused.py).
//
// What they replace
//   resident_kernel and transform_kernel, its two bodies:
//     stainx_tpu/kernels/macenko_fused.py::macenko_transform_mega
//     (_mega_kernel), the whole per-image Macenko transform (B1).
//   fit_resident_kernel:
//     stainx_tpu/kernels/macenko_fused.py::macenko_fit_mega
//     (_fit_mega_kernel), the pooled reference fit (B2), for every pool
//     that fits one block's shared memory; larger pools go to B5
//     (stainx_tpu_torch/ops/macenko.py::fit_route).
//   All use the device helpers of macenko_common.cuh (OD, covariance of the
//   10 moments about OD-1, the closed-form 3x3 eigh, the diamond pseudo-angle
//   and its inverse, H/E ordering, the 2x2 normal rows, the maxC scale) and
//   an exact radix select on the monotone key of keys.cuh (the job of
//   selection.py's radix_select_multi inside the TPU kernels).
//
// What bounds them
//   B1 on the small-patch path (256x3x64^2 uint8) must read and write 6.3 MB:
//   1.9 us at 3.35 TB/s. Its arithmetic (about 90 float ops a pixel, 1 M
//   pixels) needs 1.4 us at 67 TFLOP/s. The fit of one 64^2 reference reads
//   12 KB and needs 4 ns of arithmetic. What takes the time is one image's
//   (or the pool's) chain of dependent phases: sums, a closed-form eigh on
//   one thread, exact selections, each a few block barriers. A fit has one
//   such chain and nothing to overlap it with: one block on one SM.
//
// What the design does about it
//   The resident bodies shorten the chain: the pixels are read from device
//   memory once into shared memory (uint8 raw values; float32 as OD, each
//   logarithm taken once) and each selection's keys are computed once, into
//   shared memory: the angle keys, then the two concentrations' keys, which
//   B1's reconstruction reads back (unkey of a concentration key is the
//   concentration itself, bit for bit). Each selection's radix descent
//   starts below the bits its smallest and largest key share, as B3's does,
//   so the angles take about 3 passes of 8 bits and the concentrations 4,
//   each over shared memory; a pass counts into 8 histogram copies (no warp
//   matching), the two selections' 16-bit counts packed into one word, which
//   the block sums, and a warp picks each bin. Moments add
//   a 4-pixel group in float32, then the groups in float64. Both kernels run
//   the same phase functions (load_resident, rmoments, angle_setup,
//   angle_keys, rselect2, conc_setup, conc_keys), templated on the block's
//   thread count.
//   resident_kernel (B1 wherever an image fits a block's shared memory:
//   uint8 up to 19 968 pixels, float32 up to 10 982 on an H100; the wrapper's
//   size rule, kernels/macenko_fused.py::transform_body) gives an image one
//   block of 512 threads, two blocks an SM wherever two fit (uint8 up to
//   about 9 350 pixels: a 96^2 block takes 114 176 bytes), so 256 images of
//   64^2 run in one wave, 512 of 96^2 in two, and their chains overlap.
//   fit_resident_kernel (B2, wherever the pool fits: kernels/macenko_fused.py
//   ::fit_resident_bytes; on an H100 uint8 up to 19 850 pixels, float32 up
//   to 10 918) gives the pool one block with the SM to itself, pooled
//   channel-major into three planes. On one SM the sweeps over a large pool are bound by
//   instruction issue, so the block has 1024 threads: on an H100 at 700 W
//   that was 7 % faster than 512 on a 128^2 pool and 14 % on the largest,
//   3 % slower on a 64^2 one (tools/probe_b2.py). The launch and the load
//   of a 64^2 pool take a third of its time; the selections most of the
//   rest.
//   transform_kernel (B1 for larger rows) is multi-pass over device memory
//   and L2, one block of 1024 threads an image: one moments pass (a second
//   one only for the <3-pixel fallback), 4 passes for the two angle
//   selections, 4 for the two concentration selections and one
//   reconstruction pass.
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
//   body counts sentinel keys too; the resident bodies skip keys at or above
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
//   plain PyTorch versions; those divide by a constant as these kernels do
//   (ops/eigh3.py::div_rn), not by a product with its reciprocal.

#include <cuda_runtime.h>

#include <cstddef>
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

// Calls f(ok, od, group) for every group of V pixels of an image,
// block-stride. Every thread of the block runs the same number of
// iterations (ok marks the real groups), so warp-wide intrinsics inside f
// see full warps.
template <typename T, int V, typename F>
__device__ __forceinline__ void sweep(const T* img, int64_t p, const float* lut, F&& f) {
  const int64_t groups = p / V;
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
    f(ok, od, g);
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
__device__ void moments(const T* img, int64_t p, bool all, Shared& sh) {
  double acc[kSums];
  for (int k = 0; k < kSums; ++k) acc[k] = 0.0;
  sweep<T, V>(img, p, sh.lut, [&](bool ok, const float (&od)[3][V], int64_t) {
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
__device__ void select2(const T* img, int64_t p, Shared& sh, KeyFn&& key2) {
  const int warp = threadIdx.x >> 5;
  for (int d = 0; d < 4; ++d) {
    const int shift = 24 - 8 * d;
    for (int i = threadIdx.x; i < 2 * kBins; i += blockDim.x) sh.hist[i / kBins][i % kBins] = 0u;
    __syncthreads();
    const uint32_t pre0 = sh.prefix[0], pre1 = sh.prefix[1];
    sweep<T, V>(img, p, sh.lut, [&](bool ok, const float (&od)[3][V], int64_t) {
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

// ---------------------------------------------------------------- stain fit
// Everything the transform computes before reconstruction: moments (with
// the <3-pixel fallback), eigh, the two angle selections, HE and normal
// rows, and the two concentration selections. Leaves sh.he, sh.m0, sh.m1
// and the selected concentration keys in sh.prefix.
template <typename T, int V>
__device__ void stain_params(const T* img, int64_t p, long long idx99, Shared& sh) {
  build_lut<T>(sh.lut);
  __syncthreads();
  moments<T, V>(img, p, false, sh);
  const bool use_all = sh.sums[0] < 3.0;  // block-uniform
  if (use_all) moments<T, V>(img, p, true, sh);

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
  select2<T, V>(img, p, sh, [&](const float (&od)[3][V], int j, uint32_t& k0, uint32_t& k1) {
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
  select2<T, V>(img, p, sh, [&](const float (&od)[3][V], int j, uint32_t& k0, uint32_t& k1) {
    k0 = monotone_key(od[0][j] * m[0] + od[1][j] * m[1] + od[2][j] * m[2]);
    k1 = monotone_key(od[0][j] * m[3] + od[1][j] * m[4] + od[2][j] * m[5]);
  });
}

// ------------------------------------------------------------------ kernels
// One block per image: the whole Macenko transform of image blockIdx.x.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads, 1)
transform_kernel(const T* __restrict__ x, T* __restrict__ out, const float* __restrict__ stain,
                 const float* __restrict__ tmc, int64_t p, long long idx99, float out_scale) {
  __shared__ Shared sh;
  const int64_t offset = static_cast<int64_t>(blockIdx.x) * 3 * p;
  const T* img = x + offset;
  stain_params<T, V>(img, p, idx99, sh);

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
  sweep<T, V>(img, p, sh.lut, [&](bool ok, const float (&od)[3][V], int64_t g) {
    if (!ok) return;
    float rgb[3][V];
    for (int j = 0; j < V; ++j) {
      const float cn0 = (od[0][j] * m[0] + od[1][j] * m[1] + od[2][j] * m[2]) * sc0;
      const float cn1 = (od[0][j] * m[3] + od[1][j] * m[4] + od[2][j] * m[5]) * sc1;
      for (int c = 0; c < 3; ++c) rgb[c][j] = reconstruct(st, c, cn0, cn1);
    }
    store_rgb<T, V>(dst, p, g, rgb, out_scale);
  });
}

// =========================================================== resident bodies
// B1 for rows that fit one block's shared memory (resident_kernel: a block of
// kRThreads an image, several images an SM) and B2 for pools that fit
// (fit_resident_kernel: one block of kFThreads for the pool, its SM to
// itself). The pixels are read from device memory once; every later pass
// reads shared memory. Both kernels run the same phases, the device
// functions below, templated on the block's thread count.
constexpr int kRThreads = 512;
constexpr int kFThreads = 1024;
// A resident block counts a pass's digits into kRCopies copies of both
// selections' histograms, lane l into copy l % kRCopies, copies a bank apart
// (kRCopyStride words): lanes whose keys crowd one bin (angles and
// concentrations fill a few bins of a digit) conflict at most 4 ways, with
// no warp matching. A word holds one bin of both selections, selection s's
// count in bits [16s, 16s + 16): a copy sees at most 4 * ceil(P / 32) keys
// of a selection (groups g with g % kRCopies its own, V <= 4 keys each),
// below 2^16 for every P a block holds (2 496 at the largest uint8 row), so
// no count carries into the other's half.
constexpr int kRCopies = 8;
constexpr int kRCopyStride = kBins + 1;
// sm_90's most shared memory a block, 232 448 bytes, holds fewer than
// 232 448 / 8 pixels' keys: a copy's counts stay below 2^16 at any P.
static_assert(4 * ((232448 / 8 + 4 * kRCopies - 1) / (4 * kRCopies)) < (1 << 16),
              "a histogram copy's 16-bit counts could carry");

// The fixed head of a resident block's shared memory (kernels/macenko_fused.py
// RESIDENT_FIXED_BYTES and FIT_FIXED_BYTES); the keys of the two selections
// (one uint32 a pixel each), then, from the next 16-byte boundary, the three
// planes (uint8 raw values, or float32 OD) follow it.
template <int Warps>
struct ResidentShared {
  float lut[256];                 // uint8 value -> OD
  double part[Warps][kSums];      // per-warp partial sums
  double sums[kSums];             // block totals
  unsigned int rep[kRCopies * kRCopyStride];  // the pass's histogram copies, packed
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
using TransformShared = ResidentShared<kRThreads / 32>;
using FitShared = ResidentShared<kFThreads / 32>;
constexpr int kResidentFixed = 12800;
constexpr int kFitFixed = 14080;
static_assert(sizeof(TransformShared) == kResidentFixed, "ResidentShared layout");
static_assert(sizeof(FitShared) == kFitFixed, "ResidentShared layout");
static_assert(kResidentFixed % 16 == 0 && kFitFixed % 16 == 0, "the keys start 16-byte aligned");
static_assert(offsetof(TransformShared, hist) % 16 == 0 && offsetof(FitShared, hist) % 16 == 0,
              "rpick reads the histograms 16 bytes at a time");

// What a resident plane holds for pixel value v: uint8 keeps the raw value
// (OD through the table), float32 the OD itself, computed once at load.
__device__ __forceinline__ float stored_od(uint8_t v, const float* lut) { return lut[v]; }
__device__ __forceinline__ float stored_od(float v, const float*) { return v; }

// Copies bytes [from, to) of each of `stretches` stretches of `bytes` bytes,
// read one after another from src, sizeof(U) bytes at a time; stretch s of a
// pool of n > 1 images (image s / 3, channel s % 3) goes to its channel's
// plane, one image is one stretch.
template <typename U, int Threads>
__device__ __forceinline__ void copy_stretches(const unsigned char* __restrict__ src,
                                               unsigned char* dst, int n, int stretches,
                                               int bytes, int from, int to) {
  const int units = (to - from) / static_cast<int>(sizeof(U));
  if (units == 0) return;
  for (int u = threadIdx.x; u < stretches * units; u += Threads) {
    const int s = u / units;
    const int k = from + (u - s * units) * static_cast<int>(sizeof(U));
    const int d = n == 1 ? 0 : ((s % 3) * n + s / 3) * bytes;
    *reinterpret_cast<U*>(dst + d + k) = __ldg(reinterpret_cast<const U*>(src + s * bytes + k));
  }
}

// Copies n images ((n, 3, p) contiguous values) into shared memory as three
// pooled planes: channel c of image i at planes + (c * n + i) * p. One image
// is one stretch of 3p values, a pool of more 3n stretches of p. 16-byte
// loads where every stretch starts 16-byte aligned in device memory (and so
// in shared memory, whose planes start 16-byte aligned), 4-byte ones where
// every stretch is 4-byte aligned, then single bytes.
template <typename T, int Threads>
__device__ void load_pool(const T* __restrict__ x, int n, int p, T* planes) {
  const auto* src = reinterpret_cast<const unsigned char*>(x);
  auto* dst = reinterpret_cast<unsigned char*>(planes);
  const int stretches = n == 1 ? 1 : 3 * n;
  const int bytes = (n == 1 ? 3 * p : p) * static_cast<int>(sizeof(T));
  const uintptr_t align = reinterpret_cast<uintptr_t>(src) | (n == 1 ? 0u : bytes);
  int done = 0;
  if ((align & 15) == 0) {
    done = bytes & ~15;
    copy_stretches<uint4, Threads>(src, dst, n, stretches, bytes, 0, done);
  } else if ((align & 3) == 0) {
    done = bytes & ~3;
    copy_stretches<unsigned, Threads>(src, dst, n, stretches, bytes, 0, done);
  }
  copy_stretches<unsigned char, Threads>(src, dst, n, stretches, bytes, done, bytes);
}

// The start of a resident block: the OD table, the histogram copies
// cleared, the pool's n images loaded, and float32 values turned into OD.
template <typename T, int Threads, typename S>
__device__ void load_resident(const T* __restrict__ x, int n, int p, T* planes, S& sh) {
  build_lut<T>(sh.lut);
  for (int i = threadIdx.x; i < kRCopies * kRCopyStride; i += Threads) sh.rep[i] = 0u;
  load_pool<T, Threads>(x, n, p, planes);
  __syncthreads();
  if constexpr (sizeof(T) == 4) {  // float32: the planes hold OD from here on
    for (int i = threadIdx.x; i < 3 * n * p; i += Threads) planes[i] = od_f32(planes[i]);
    __syncthreads();
  }
}

// Calls f(ok, od, g) for every group of V pixels [V*g, V*g + V) of the
// resident planes (P pixels each), block-stride; every thread runs the same
// iterations (ok marks the real groups), so warp-wide intrinsics inside f
// see full warps.
template <typename T, int V, int Threads, typename F>
__device__ __forceinline__ void rsweep(const T* planes, int P, const float* lut, F&& f) {
  const int groups = P / V;
  for (int g0 = 0; g0 < groups; g0 += Threads) {
    const int g = g0 + threadIdx.x;
    const bool ok = g < groups;
    float od[3][V];
    for (int c = 0; c < 3; ++c) {
      if constexpr (V == 4) {
        const auto q = ok ? reinterpret_cast<const typename Vec4<T>::type*>(planes + c * P)[g]
                          : typename Vec4<T>::type{};
        od[c][0] = stored_od(q.x, lut);
        od[c][1] = stored_od(q.y, lut);
        od[c][2] = stored_od(q.z, lut);
        od[c][3] = stored_od(q.w, lut);
      } else {
        od[c][0] = stored_od(ok ? planes[c * P + g] : T(0), lut);
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
template <typename S>
__device__ __forceinline__ void reduce_extremes(const Extremes& e, int s, S& sh) {
  const uint32_t lo = __reduce_min_sync(kFull, e.lo), hi = __reduce_max_sync(kFull, e.hi);
  const unsigned n = __reduce_add_sync(kFull, e.n);
  if ((threadIdx.x & 31) == 0) {
    atomicMin(&sh.lo[s], lo);
    atomicMax(&sh.hi[s], hi);
    atomicAdd(&sh.cnt[s], n);
  }
}

template <typename S>
__device__ __forceinline__ void reset_extremes(S& sh) {
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
template <typename T, int V, int Threads, typename S>
__device__ void rmoments(const T* planes, int P, bool all, S& sh) {
  double acc[kSums];
  for (int k = 0; k < kSums; ++k) acc[k] = 0.0;
  rsweep<T, V, Threads>(planes, P, sh.lut, [&](bool ok, const float (&od)[3][V], int) {
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
  block_sum<Threads / 32>(acc, sh);
}

// Thread 0: the covariance, its eigh and the two angle ranks from the
// moments; the extremes cleared for the angle keys.
template <typename S>
__device__ void angle_setup(S& sh) {
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
}

// The angle keys, once, into keys: the pseudo-angle in the stain plane, the
// sentinel off the beta-mask (unless all), and their extremes.
template <typename T, int V, int Threads, typename S>
__device__ void angle_keys(const T* planes, int P, bool all, uint32_t* keys, S& sh) {
  float v[6];
  for (int k = 0; k < 6; ++k) v[k] = sh.evs[k];
  Extremes e;
  rsweep<T, V, Threads>(planes, P, sh.lut, [&](bool ok, const float (&od)[3][V], int g) {
    uint32_t k[V];
    for (int j = 0; j < V; ++j) {
      const float t0 = od[0][j] * v[0] + od[1][j] * v[1] + od[2][j] * v[2];
      const float t1 = od[0][j] * v[3] + od[1][j] * v[4] + od[2][j] * v[5];
      const bool member = all || min3(od[0][j], od[1][j], od[2][j]) >= kBeta;
      k[j] = member ? monotone_key(pseudo_angle(t0, t1)) : kSentinelKey;
      e.add(ok, k[j]);
    }
    if (ok) store_keys<V>(keys, g, k);
  });
  reduce_extremes(e, 0, sh);
  reduce_extremes(e, 1, sh);
  __syncthreads();
}

// Thread 0: H/E and the normal rows from the two selected angles, the
// concentration ranks, the extremes cleared for the concentration keys.
template <typename S>
__device__ void conc_setup(S& sh, long long idx99) {
  if (threadIdx.x == 0) {
    stain_from_phi(sh.evs, unkey(sh.prefix[0]), unkey(sh.prefix[1]), sh.he, sh.m0, sh.m1);
    sh.rank[0] = sh.rank[1] = idx99;
    reset_extremes(sh);
  }
  __syncthreads();
}

// The two concentration keys, once, into keys0 and keys1, and their
// extremes.
template <typename T, int V, int Threads, typename S>
__device__ void conc_keys(const T* planes, int P, uint32_t* keys0, uint32_t* keys1, S& sh) {
  float m[6];
  for (int k = 0; k < 3; ++k) {
    m[k] = sh.m0[k];
    m[3 + k] = sh.m1[k];
  }
  Extremes e0, e1;
  rsweep<T, V, Threads>(planes, P, sh.lut, [&](bool ok, const float (&od)[3][V], int g) {
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
  __syncthreads();
}

// Counts bin of selection s (a literal at each call: the shift is a
// constant) in the thread's histogram copy.
__device__ __forceinline__ void rep_add(unsigned* rep, int s, bool in, unsigned bin) {
  if (in) atomicAdd(rep + (threadIdx.x & (kRCopies - 1)) * kRCopyStride + bin, 1u << (16 * s));
}

// One warp: the bin of the kBins counts h (16-byte aligned) that holds
// rank (0 <= rank < the counts' sum), and the rank left inside that bin.
// Lane l reads bins [8l, 8l + 8) in two 16-byte loads, then a prefix sum
// over the lanes in 32-bit integers (a resident pool has fewer than 2^31
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

// Two exact selections from resident keys (P of each): rank sh.rank[s]
// among the keys below the sentinel of keys s (k0 == k1 for the two angle
// ranks), a rank past their count taking the largest and no key giving
// +inf (B4's and B6's conventions). The descent starts below the bits that
// the selection's extremes share (sh.lo, sh.hi, sh.cnt) and chooses up to 8
// bits a pass: the keys under the prefix count their digit into the
// histogram copies (one histogram while both selections read the same keys
// under the same prefix), the copies' two halves are summed (and the copies
// cleared) into sh.hist, and a warp a selection picks the bin holding the
// rank. Leaves the selected keys in sh.prefix.
template <int V, int Threads, typename S>
__device__ void rselect2(const uint32_t* k0, const uint32_t* k1, int P, S& sh) {
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
  const int groups = P / V;
  for (;;) {
    const int top0 = sh.top[0], top1 = sh.top[1];  // block-uniform
    if (top0 == 0 && top1 == 0) break;
    const uint32_t pre0 = sh.prefix[0], pre1 = sh.prefix[1];
    const bool one = k0 == k1 && top0 == top1 && pre0 == pre1;  // one histogram serves both
    for (int g = threadIdx.x; g < groups; g += Threads) {
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
    for (int i = threadIdx.x; i < kBins; i += Threads) {
      unsigned c0 = 0u, c1 = 0u;
      for (int k = 0; k < kRCopies; ++k) {
        const unsigned w = sh.rep[k * kRCopyStride + i];
        c0 += w & 0xFFFFu;
        c1 += w >> 16;
        sh.rep[k * kRCopyStride + i] = 0u;
      }
      sh.hist[0][i] = c0;
      sh.hist[1][i] = c1;
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

// Check only: copies `count` resident keys to device memory.
template <int Threads>
__device__ void copy_keys(const uint32_t* resident, uint32_t* dst, int count) {
  for (int i = threadIdx.x; i < count; i += Threads) dst[i] = resident[i];
}

// One block per image: the whole Macenko transform of image blockIdx.x with
// the image resident in shared memory. With kCheck it also writes the keys
// it selected on into keys ((n, 3, p) uint32) and the selected values into
// sel ((n, 4) float32: the two angles, the two maxC).
template <typename T, int V, bool kCheck>
__global__ void __launch_bounds__(kRThreads, 2)
resident_kernel(const T* __restrict__ x, T* __restrict__ out, const float* __restrict__ stain,
                const float* __restrict__ tmc, int p, long long idx99, uint32_t* keys, float* sel,
                float out_scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  TransformShared& sh = *reinterpret_cast<TransformShared*>(smem);
  uint32_t* keys0 = reinterpret_cast<uint32_t*>(smem + kResidentFixed);
  uint32_t* keys1 = keys0 + p;
  T* planes = reinterpret_cast<T*>(smem + kResidentFixed + ((8 * p + 15) & ~15));
  const int64_t offset = static_cast<int64_t>(blockIdx.x) * 3 * p;
  load_resident<T, kRThreads>(x + offset, 1, p, planes, sh);
  rmoments<T, V, kRThreads>(planes, p, false, sh);
  const bool use_all = sh.sums[0] < 3.0;  // block-uniform: the <3-pixel fallback
  if (use_all) rmoments<T, V, kRThreads>(planes, p, true, sh);
  angle_setup(sh);
  angle_keys<T, V, kRThreads>(planes, p, use_all, keys0, sh);
  if constexpr (kCheck) copy_keys<kRThreads>(keys0, keys + offset, p);
  rselect2<V, kRThreads>(keys0, keys0, p, sh);
  if (kCheck && threadIdx.x == 0) {
    sel[4 * blockIdx.x] = unkey(sh.prefix[0]);
    sel[4 * blockIdx.x + 1] = unkey(sh.prefix[1]);
  }
  conc_setup(sh, idx99);
  conc_keys<T, V, kRThreads>(planes, p, keys0, keys1, sh);
  if constexpr (kCheck) copy_keys<kRThreads>(keys0, keys + offset + p, 2 * p);
  rselect2<V, kRThreads>(keys0, keys1, p, sh);
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
    store_rgb<T, V>(dst, p, g, rgb, out_scale);
  }
}

// One block for the whole pool (n images of p pixels, pooled channel-major
// into P = n * p pixels) resident in shared memory: HE (3, 2) row-major and
// maxC (2) into out8 (no <3-pixel fallback at fit). With
// kCheck it also writes the keys it selected on into keys ((3, P) uint32:
// the angles, then the two concentrations) and the selected values into
// sel ((4,) float32).
template <typename T, int V, bool kCheck>
__global__ void __launch_bounds__(kFThreads, 1)
fit_resident_kernel(const T* __restrict__ x, float* __restrict__ out8, int n, int p,
                    long long idx99, uint32_t* keys, float* sel) {
  extern __shared__ __align__(16) unsigned char smem[];
  FitShared& sh = *reinterpret_cast<FitShared*>(smem);
  const int P = n * p;
  uint32_t* keys0 = reinterpret_cast<uint32_t*>(smem + kFitFixed);
  uint32_t* keys1 = keys0 + P;
  T* planes = reinterpret_cast<T*>(smem + kFitFixed + ((8 * P + 15) & ~15));
  load_resident<T, kFThreads>(x, n, p, planes, sh);
  rmoments<T, V, kFThreads>(planes, P, false, sh);
  angle_setup(sh);
  angle_keys<T, V, kFThreads>(planes, P, false, keys0, sh);
  if constexpr (kCheck) copy_keys<kFThreads>(keys0, keys, P);
  rselect2<V, kFThreads>(keys0, keys0, P, sh);
  if (kCheck && threadIdx.x == 0) {
    sel[0] = unkey(sh.prefix[0]);
    sel[1] = unkey(sh.prefix[1]);
  }
  conc_setup(sh, idx99);
  conc_keys<T, V, kFThreads>(planes, P, keys0, keys1, sh);
  if constexpr (kCheck) copy_keys<kFThreads>(keys0, keys + P, 2 * P);
  rselect2<V, kFThreads>(keys0, keys1, P, sh);
  if (threadIdx.x == 0) {
    for (int k = 0; k < 6; ++k) out8[k] = sh.he[k];
    out8[6] = unkey(sh.prefix[0]);
    out8[7] = unkey(sh.prefix[1]);
    if constexpr (kCheck) {
      sel[2] = unkey(sh.prefix[0]);
      sel[3] = unkey(sh.prefix[1]);
    }
  }
}

// Records `start` on `s` where it is not null: the timing mark just before a
// launch, after the host's set-up of it.
cudaError_t mark(cudaEvent_t start, cudaStream_t s) {
  return start == nullptr ? cudaSuccess : cudaEventRecord(start, s);
}

template <typename T, int V, bool kCheck>
cudaError_t launch_resident(const T* x, T* out, const float* stain, const float* tmc,
                            float out_scale, long long n, long long p, long long idx99,
                            size_t smem, uint32_t* keys, float* sel, cudaStream_t s,
                            cudaEvent_t start) {
  cudaError_t e = cudaFuncSetAttribute(resident_kernel<T, V, kCheck>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e == cudaSuccess) e = mark(start, s);
  if (e != cudaSuccess) return e;
  resident_kernel<T, V, kCheck><<<static_cast<unsigned>(n), kRThreads, smem, s>>>(
      x, out, stain, tmc, static_cast<int>(p), idx99, keys, sel, out_scale);
  return cudaSuccess;
}

template <typename T>
cudaError_t launch_transform(const void* x, void* out, const float* stain, const float* tmc,
                             float out_scale, long long n, long long p, int vec4, long long idx99,
                             long long smem, uint32_t* keys, float* sel, cudaStream_t s,
                             cudaEvent_t start) {
  const auto* xi = static_cast<const T*>(x);
  auto* xo = static_cast<T*>(out);
  const dim3 grid(static_cast<unsigned>(n));
  if (keys != nullptr) {
    return vec4 ? launch_resident<T, 4, true>(xi, xo, stain, tmc, out_scale, n, p, idx99, smem,
                                              keys, sel, s, start)
                : launch_resident<T, 1, true>(xi, xo, stain, tmc, out_scale, n, p, idx99, smem,
                                              keys, sel, s, start);
  }
  if (smem > 0) {
    return vec4 ? launch_resident<T, 4, false>(xi, xo, stain, tmc, out_scale, n, p, idx99, smem,
                                               keys, sel, s, start)
                : launch_resident<T, 1, false>(xi, xo, stain, tmc, out_scale, n, p, idx99, smem,
                                               keys, sel, s, start);
  }
  const cudaError_t e = mark(start, s);
  if (e != cudaSuccess) return e;
  if (vec4) {
    transform_kernel<T, 4><<<grid, kThreads, 0, s>>>(xi, xo, stain, tmc, p, idx99, out_scale);
  } else {
    transform_kernel<T, 1><<<grid, kThreads, 0, s>>>(xi, xo, stain, tmc, p, idx99, out_scale);
  }
  return cudaSuccess;
}

// Blocks of B1 that one SM holds at once: the resident body with `smem`
// bytes of dynamic shared memory (its attribute set as the launch sets it),
// or the L2 body where smem is 0.
template <typename T, int V>
cudaError_t body_occupancy(long long smem, int* blocks) {
  if (smem == 0) {
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, transform_kernel<T, V>, kThreads,
                                                         0);
  }
  const cudaError_t e = cudaFuncSetAttribute(resident_kernel<T, V, false>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, resident_kernel<T, V, false>,
                                                       kRThreads, static_cast<size_t>(smem));
}

template <typename T>
cudaError_t transform_occupancy(int vec4, long long smem, int* blocks) {
  return vec4 ? body_occupancy<T, 4>(smem, blocks) : body_occupancy<T, 1>(smem, blocks);
}

template <typename T, int V, bool kCheck>
cudaError_t launch_fit_resident(const T* x, float* out8, long long n, long long p,
                                long long idx99, size_t smem, uint32_t* keys, float* sel,
                                cudaStream_t s) {
  const cudaError_t e = cudaFuncSetAttribute(fit_resident_kernel<T, V, kCheck>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  fit_resident_kernel<T, V, kCheck><<<1, kFThreads, smem, s>>>(
      x, out8, static_cast<int>(n), static_cast<int>(p), idx99, keys, sel);
  return cudaSuccess;
}

template <typename T>
cudaError_t launch_fit(const void* x, float* out8, long long n, long long p, int vec4,
                       long long idx99, long long smem, uint32_t* keys, float* sel,
                       cudaStream_t s) {
  const auto* xi = static_cast<const T*>(x);
  if (keys != nullptr) {
    return vec4 ? launch_fit_resident<T, 4, true>(xi, out8, n, p, idx99, smem, keys, sel, s)
                : launch_fit_resident<T, 1, true>(xi, out8, n, p, idx99, smem, keys, sel, s);
  }
  return vec4 ? launch_fit_resident<T, 4, false>(xi, out8, n, p, idx99, smem, keys, sel, s)
              : launch_fit_resident<T, 1, false>(xi, out8, n, p, idx99, smem, keys, sel, s);
}

}  // namespace

// ------------------------------------------------------------- C interface
extern "C" {

const char* stainx_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x, out: (n, 3, p) contiguous uint8 or float32; stain: (3, 2) float32;
// tmc: (2,) float32; all on the current device. out_scale: each float32
// output value is the clipped reconstruction times out_scale (1 for
// [0, 255]); uint8 output takes none (pass 1). smem: the resident body's
// dynamic shared memory (kResidentFixed, then 8p and 3p * sizeof(T) bytes,
// each rounded up to 16), or 0 for the body that re-reads the image from L2. keys and sel are
// null, or (check only, resident body) (n, 3, p) uint32 and (n, 4) float32
// for the keys each image selected on and the selected values.
// launch_start and launch_end, where not null, are CUDA events of the
// stream's device, made with timing: recorded just before the launch (after
// its shared-memory attribute is set) and just after it, so the interval
// between them holds B1 and nothing the host does before it. The launch and
// the output are the same with or without. Returns the CUDA error of the
// launch.
int stainx_macenko_transform_mega(const void* x, void* out, const void* stain, const void* tmc,
                                  float out_scale, long long n, long long p, int is_uint8, int vec4,
                                  long long idx99, long long smem, void* keys, void* sel,
                                  void* stream, void* launch_start, void* launch_end) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* st = static_cast<const float*>(stain);
  const auto* tm = static_cast<const float*>(tmc);
  auto* k = static_cast<uint32_t*>(keys);
  auto* sl = static_cast<float*>(sel);
  const auto start = static_cast<cudaEvent_t>(launch_start);
  cudaError_t e =
      is_uint8 ? launch_transform<uint8_t>(x, out, st, tm, out_scale, n, p, vec4, idx99, smem, k,
                                           sl, s, start)
               : launch_transform<float>(x, out, st, tm, out_scale, n, p, vec4, idx99, smem, k,
                                         sl, s, start);
  if (e == cudaSuccess) e = mark(static_cast<cudaEvent_t>(launch_end), s);
  if (e != cudaSuccess) {
    cudaGetLastError();  // clear it: the wrapper raises
    return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}

// Blocks of stainx_macenko_transform_mega's launch (the same is_uint8, vec4
// and smem) that one SM of the current device holds at once, into *blocks
// (int). Returns the CUDA error of the query.
int stainx_macenko_transform_occupancy(int is_uint8, int vec4, long long smem, void* blocks) {
  auto* b = static_cast<int*>(blocks);
  const cudaError_t e = is_uint8 ? transform_occupancy<uint8_t>(vec4, smem, b)
                                 : transform_occupancy<float>(vec4, smem, b);
  if (e != cudaSuccess) {
    cudaGetLastError();  // clear it: the wrapper raises
    return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}

// x: (n, 3, p) contiguous uint8 or float32, pooled; out8: (8,) float32.
// smem: the block's dynamic shared memory (kFitFixed, then 8np and
// 3np * sizeof(T) bytes, each rounded up to 16). vec4: the pool's pixels
// are taken 4 at a time (np % 4 == 0). keys and sel are null, or (check
// only) (3, np) uint32 and (4,) float32 for the keys the pool selected on
// and the selected values. Returns the CUDA error of the launch.
int stainx_macenko_fit_mega(const void* x, void* out8, long long n, long long p, int is_uint8,
                            int vec4, long long idx99, long long smem, void* keys, void* sel,
                            void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  auto* o = static_cast<float*>(out8);
  auto* k = static_cast<uint32_t*>(keys);
  auto* sl = static_cast<float*>(sel);
  const cudaError_t e =
      is_uint8 ? launch_fit<uint8_t>(x, o, n, p, vec4, idx99, smem, k, sl, s)
               : launch_fit<float>(x, o, n, p, vec4, idx99, smem, k, sl, s);
  if (e != cudaSuccess) {
    cudaGetLastError();  // clear it: the wrapper raises
    return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
