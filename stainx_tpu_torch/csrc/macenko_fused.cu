// Macenko fit and transform kernels for Hopper (sm_90a), with a plain C
// interface loaded through ctypes (stainx_tpu_torch/kernels/macenko_fused.py).
//
// What they replace
//   transform_kernel: stainx_tpu/kernels/macenko_fused.py::macenko_transform_mega
//     (_mega_kernel), the whole per-image Macenko transform (B1).
//   fit_kernel: stainx_tpu/kernels/macenko_fused.py::macenko_fit_mega
//     (_fit_mega_kernel), the pooled reference fit (B2).
//   Both use the device helpers of macenko_common.cuh (OD, covariance of the
//   10 moments about OD-1, the closed-form 3x3 eigh, the diamond pseudo-angle
//   and its inverse, H/E ordering, the 2x2 normal rows, the maxC scale) and
//   an exact radix select on the monotone key of keys.cuh (the job of
//   selection.py's radix_select_multi inside the TPU kernels).
//
// What bounds them
//   The transform at 64x3x512^2 uint8 must read 50.33 MB and write 50.33 MB:
//   at 3.35 TB/s that is 30.0 us, so it is bound by bytes. Its arithmetic
//   (about 90 float ops a pixel, 16.8 M pixels) needs 22 us at 67 TFLOP/s.
//   The fit of one 512^2 reference reads 0.79 MB (0.23 us at 3.35 TB/s) and
//   needs 63 float ops a pixel (0.25 us): a bound far below what one block's
//   chain of dependent passes can reach, so in practice latency bounds it.
//
// What the design does about it
//   A 512^2 row (768 KB of uint8) does not fit the 227 KB of shared memory a
//   block may hold, so the kernels are multi-pass over device memory and L2:
//   one moments pass (a second one only for the <3-pixel fallback), 4 passes
//   for the two angle selections, 4 for the two concentration selections,
//   and at transform one reconstruction pass. Every pass recomputes OD, the
//   projections and the keys from the raw values instead of storing them, so
//   device memory sees one read of the input (then L2 re-reads: the 64
//   images of the main path are 50 MB, about the size of L2) and one write
//   of the output. uint8 OD is a 256-entry table in shared memory, built
//   once per block with the same formula. Rows whose pixel count is a
//   multiple of 4 are read 4 pixels per thread (uchar4 / float4).
//   One thread block of 1024 threads runs one image (transform) or the whole
//   pool (fit); no image is split across blocks, so no second reduction step
//   is needed. 64 images fill 64 of the 132 SMs: the main path's batch does
//   not fill the card, which is work for a later change.
//
// Exactness and determinism
//   Sums use no float atomics: each thread accumulates in double in a fixed
//   order, then warp shuffles and one warp combine the partial sums in a
//   fixed order, so two runs give the same bits. The count is an integer.
//   Selections are a 4-pass radix select on the uint32 monotone key, 8 bits
//   a pass: each pass counts the keys that match the prefix chosen so far in
//   a 256-bin shared-memory histogram (integer atomics, aggregated per warp
//   with __match_any_sync) and descends into the bin holding the rank. The
//   result is unkey(final prefix), an actual element of the data. The two
//   angle ranks share one key and the two concentration selections share
//   their passes: two histograms per pass.
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
// Block sum of kSums doubles into sh.sums, in a fixed order.
__device__ void block_sum(double (&acc)[kSums], Shared& sh) {
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
      double v = lane < kWarps ? sh.part[lane][k] : 0.0;
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
  block_sum(acc, sh);
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

}  // namespace

// ------------------------------------------------------------- C interface
extern "C" {

const char* stainx_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x, out: (n, 3, p) contiguous uint8 or float32; stain: (3, 2) float32;
// tmc: (2,) float32; all on the current device. Returns cudaGetLastError().
int stainx_macenko_transform_mega(const void* x, void* out, const void* stain, const void* tmc,
                                  long long n, long long p, int is_uint8, int vec4,
                                  long long idx99, void* stream) {
  const dim3 grid(static_cast<unsigned>(n));
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* st = static_cast<const float*>(stain);
  const auto* tm = static_cast<const float*>(tmc);
  if (is_uint8) {
    const auto* xi = static_cast<const uint8_t*>(x);
    auto* xo = static_cast<uint8_t*>(out);
    if (vec4) transform_kernel<uint8_t, 4><<<grid, kThreads, 0, s>>>(xi, xo, st, tm, p, idx99);
    else transform_kernel<uint8_t, 1><<<grid, kThreads, 0, s>>>(xi, xo, st, tm, p, idx99);
  } else {
    const auto* xi = static_cast<const float*>(x);
    auto* xo = static_cast<float*>(out);
    if (vec4) transform_kernel<float, 4><<<grid, kThreads, 0, s>>>(xi, xo, st, tm, p, idx99);
    else transform_kernel<float, 1><<<grid, kThreads, 0, s>>>(xi, xo, st, tm, p, idx99);
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
