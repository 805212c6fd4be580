// Multi-block Macenko transform and fit for Hopper (sm_90a), with a plain C
// interface loaded through ctypes (stainx_tpu_torch/kernels/macenko_stream.py).
//
// What they replace
//   stainx_tpu/kernels/macenko_stream.py::macenko_transform_stream (B4) and
//   ::macenko_fit_stream (B5), the streaming tier: B1's and B2's functions
//   for rows and pools past one block's reach. B1 and B2 (macenko_fused.cu)
//   run one thread block per image or per pool; here a row (one image, or at
//   fit the N images pooled channel-major, read in place) is split across
//   many blocks.
//
// What bounds them
//   4x3x2048^2 or 1x3x4096^2 uint8 through B4 must read 50.33 MB and write
//   50.33 MB: 0.030 ms at 3.35 TB/s, above the 0.022 ms that 89 float32
//   operations a pixel need at 67 TFLOP/s, so bytes bound it. B5 on
//   256x3x224^2 float32 reads 154.1 MB: 0.046 ms.
//
// What the design does about it
//   The pipeline is a few grid-wide launches, each over (blocks, images):
//   1. stream_moments: count and the 9 moments about OD-1 of the beta-masked
//      pixels (and, at transform, of all pixels for the <3-pixel fallback),
//      float64 per thread, fixed-order block sums, one float64 partial per
//      block: no float atomics.
//   2. stream_scalars, one block per row: the partials added in index order
//      (fixed, so repeat runs are bit-identical), covariance, eigh, the
//      alpha and 100-alpha ranks, all on the device.
//   3. stream_angle_field: the diamond pseudo-angle of every pixel, +inf
//      where the beta-mask drops it, into a float32 key cache in device
//      memory (4 bytes a pixel: the TPU kernel's HBM key cache), with the
//      row's min and max member keys by integer atomics: the init of B6.
//   4. B6 (selection.cu, launched by the wrapper) selects both angles.
//   5. stream_conc_field: HE, the normal rows, and both concentration fields
//      into a (2R, P) cache; B6 selects their 99th percentiles.
//   6. stream_reconstruct (transform only): OD, rescaled concentrations and
//      clip(240 exp(-HE C), 0, 255), truncated for uint8.
//   Every pixel kernel recomputes OD from the raw bytes (uint8 through a
//   256-entry table) instead of storing it. Ranks, statistics and the
//   selected values stay on the device from pass to pass: the wrappers make
//   no host sync, so the whole path can be captured in a CUDA graph. The
//   arithmetic is B1's and B2's (macenko_common.cuh); only the order of the
//   float64 sums differs.

#include <cuda_runtime.h>

#include <cstdint>

#include "macenko_common.cuh"

namespace {

using namespace stainx;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPart = 2 * kSums;  // beta-masked sums, then all-pixel sums

// Per-row statistics, 32 float32 a row (stainx_tpu_torch/kernels/macenko_stream.py
// reads he at [8, 14)).
struct RowParams {
  float evs[6];  // v_mid (3), v_max (3)
  float use_all;  // 1 when the <3-pixel fallback took all pixels
  float pad0;
  float he[6];  // HE row-major (3, 2)
  float m0[3];  // normal rows of the HE columns
  float m1[3];
  float pad1[12];
};
static_assert(sizeof(RowParams) == 32 * sizeof(float), "RowParams is 32 floats");

// The pixel groups [begin, end) of image blockIdx.y that block blockIdx.x
// covers, V pixels a group.
struct Span {
  int64_t begin, end;
};

__device__ __forceinline__ Span block_span(int64_t p, int v) {
  const int64_t groups = p / v;
  const int64_t per_block = (groups + gridDim.x - 1) / gridDim.x;
  const int64_t begin = static_cast<int64_t>(blockIdx.x) * per_block;
  return {begin, begin + per_block < groups ? begin + per_block : groups};
}

// Calls f(ok, od, g) for every group of the block's span of image
// blockIdx.y. Every thread runs the same number of iterations (ok marks
// the real groups), so warp-wide intrinsics inside f see full warps.
template <typename T, int V, typename F>
__device__ __forceinline__ void sweep(const T* x, int64_t p, const float* lut, F&& f) {
  const T* img = x + static_cast<int64_t>(blockIdx.y) * 3 * p;
  const Span sp = block_span(p, V);
  for (int64_t g0 = sp.begin; g0 < sp.end; g0 += kThreads) {
    const int64_t g = g0 + threadIdx.x;
    const bool ok = g < sp.end;
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

// Offset of pixel group g of image blockIdx.y in a row-major (rows, ipr*p)
// field: image i is part `i % ipr` of row `i / ipr`.
__device__ __forceinline__ int64_t field_offset(int64_t p, int ipr, int64_t row_stride,
                                                int64_t q) {
  const int64_t i = blockIdx.y;
  return (i / ipr) * row_stride + (i % ipr) * p + q;
}

__device__ __forceinline__ void add_moments(double* acc, float o0, float o1, float o2) {
  const float y0 = o0 - 1.0f, y1 = o1 - 1.0f, y2 = o2 - 1.0f;
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

// 1. One partial of kPart float64 sums a block, at
// partials[(row * ipr + part) * gridDim.x + blockIdx.x].
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
stream_moments(const T* __restrict__ x, int64_t p, int fallback, double* __restrict__ partials) {
  __shared__ float lut[256];
  __shared__ double warp_part[kWarps][kPart];
  build_lut<T>(lut);
  __syncthreads();
  double acc[kPart];
  for (int k = 0; k < kPart; ++k) acc[k] = 0.0;
  sweep<T, V>(x, p, lut, [&](bool ok, const float (&od)[3][V], int64_t) {
    if (!ok) return;
    for (int j = 0; j < V; ++j) {
      if (min3(od[0][j], od[1][j], od[2][j]) >= kBeta) {
        add_moments(acc, od[0][j], od[1][j], od[2][j]);
      }
      if (fallback) add_moments(acc + kSums, od[0][j], od[1][j], od[2][j]);
    }
  });
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int k = 0; k < kPart; ++k) {
    double v = acc[k];
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(kFull, v, off);
    if (lane == 0) warp_part[warp][k] = v;
  }
  __syncthreads();
  if (threadIdx.x < kPart) {
    double s = 0.0;
    for (int w = 0; w < kWarps; ++w) s += warp_part[w][threadIdx.x];
    const int64_t b = static_cast<int64_t>(blockIdx.y) * gridDim.x + blockIdx.x;
    partials[b * kPart + threadIdx.x] = s;
  }
}

// 2. One block of kPart warps per row: warp k adds sum k of the row's
// n_part partials in index order (lane l takes l, l + 32, ...; then a fixed
// shuffle tree); thread 0 then derives the row's statistics and ranks.
__global__ void stream_scalars(const double* __restrict__ partials, int n_part, int fallback,
                               long long idx99, RowParams* __restrict__ prm,
                               int* __restrict__ ranks2, uint32_t* __restrict__ init3,
                               int* __restrict__ ranks99) {
  __shared__ double sums[kPart];
  const int64_t r = blockIdx.x;
  const int lane = threadIdx.x & 31, k = threadIdx.x >> 5;
  const double* part = partials + r * n_part * kPart;
  double s = 0.0;
  for (int b = lane; b < n_part; b += 32) s += part[static_cast<int64_t>(b) * kPart + k];
  for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(kFull, s, off);
  if (lane == 0) sums[k] = s;
  __syncthreads();
  if (threadIdx.x != 0) return;
  const bool use_all = fallback && sums[0] < 3.0;
  const double* m = use_all ? sums + kSums : sums;
  float a[6];
  cov_from_moments(m, a);
  RowParams& row = prm[r];
  eigh3_top2(a, row.evs);
  row.use_all = use_all ? 1.0f : 0.0f;
  const long long cnt = static_cast<long long>(m[0]);
  ranks2[2 * r] = static_cast<int>(nearest_rank_index(kAlpha, cnt));
  ranks2[2 * r + 1] = static_cast<int>(nearest_rank_index(100 - kAlpha, cnt));
  init3[3 * r] = 0xFFFFFFFFu;  // min and max member keys, by stream_angle_field
  init3[3 * r + 1] = 0u;
  init3[3 * r + 2] = static_cast<uint32_t>(cnt);
  ranks99[2 * r] = ranks99[2 * r + 1] = static_cast<int>(idx99);
}

// 3. The pseudo-angle field (+inf off the mask) and its member key range.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
stream_angle_field(const T* __restrict__ x, int64_t p, int ipr, const RowParams* __restrict__ prm,
                   float* __restrict__ field, uint32_t* __restrict__ init3) {
  __shared__ float lut[256];
  build_lut<T>(lut);
  __syncthreads();
  const int64_t row = blockIdx.y / ipr;
  const RowParams& rp = prm[row];
  float v[6];
  for (int k = 0; k < 6; ++k) v[k] = rp.evs[k];
  const bool use_all = rp.use_all != 0.0f;
  const int64_t row_stride = static_cast<int64_t>(ipr) * p;
  uint32_t kmin = 0xFFFFFFFFu, kmax = 0u;
  sweep<T, V>(x, p, lut, [&](bool ok, const float (&od)[3][V], int64_t g) {
    if (!ok) return;
    float a[V];
    for (int j = 0; j < V; ++j) {
      const float t0 = od[0][j] * v[0] + od[1][j] * v[1] + od[2][j] * v[2];
      const float t1 = od[0][j] * v[3] + od[1][j] * v[4] + od[2][j] * v[5];
      const bool member = use_all || min3(od[0][j], od[1][j], od[2][j]) >= kBeta;
      a[j] = member ? pseudo_angle(t0, t1) : __int_as_float(0x7F800000);
      if (member) {
        const uint32_t key = monotone_key(a[j]);
        kmin = key < kmin ? key : kmin;
        kmax = key > kmax ? key : kmax;
      }
    }
    float* dst = field + field_offset(p, ipr, row_stride, g * V);
    if constexpr (V == 4) {
      *reinterpret_cast<float4*>(dst) = make_float4(a[0], a[1], a[2], a[3]);
    } else {
      dst[0] = a[0];
    }
  });
  kmin = __reduce_min_sync(kFull, kmin);
  kmax = __reduce_max_sync(kFull, kmax);
  if ((threadIdx.x & 31) == 0 && kmin <= kmax) {
    atomicMin(&init3[3 * row], kmin);
    atomicMax(&init3[3 * row + 1], kmax);
  }
}

// 5. Both concentration fields: c0 into row 2r, c1 into row 2r+1 of a
// (2R, ipr*p) field. The first block of a row also records HE and m0, m1.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
stream_conc_field(const T* __restrict__ x, int64_t p, int ipr, RowParams* __restrict__ prm,
                  const float* __restrict__ phi, float* __restrict__ field2) {
  __shared__ float lut[256];
  __shared__ float he[6], m[6];
  build_lut<T>(lut);
  const int64_t row = blockIdx.y / ipr;
  if (threadIdx.x == 0) {
    stain_from_phi(prm[row].evs, phi[2 * row], phi[2 * row + 1], he, m, m + 3);
    if (blockIdx.x == 0 && blockIdx.y % ipr == 0) {
      RowParams& rp = prm[row];
      for (int k = 0; k < 6; ++k) rp.he[k] = he[k];
      for (int k = 0; k < 3; ++k) {
        rp.m0[k] = m[k];
        rp.m1[k] = m[3 + k];
      }
    }
  }
  __syncthreads();
  float w[6];
  for (int k = 0; k < 6; ++k) w[k] = m[k];
  const int64_t row_stride = static_cast<int64_t>(ipr) * p;
  sweep<T, V>(x, p, lut, [&](bool ok, const float (&od)[3][V], int64_t g) {
    if (!ok) return;
    float c0[V], c1[V];
    for (int j = 0; j < V; ++j) {
      c0[j] = od[0][j] * w[0] + od[1][j] * w[1] + od[2][j] * w[2];
      c1[j] = od[0][j] * w[3] + od[1][j] * w[4] + od[2][j] * w[5];
    }
    const int64_t off = field_offset(p, ipr, 2 * row_stride, g * V);
    float* d0 = field2 + off;
    float* d1 = field2 + off + row_stride;
    if constexpr (V == 4) {
      *reinterpret_cast<float4*>(d0) = make_float4(c0[0], c0[1], c0[2], c0[3]);
      *reinterpret_cast<float4*>(d1) = make_float4(c1[0], c1[1], c1[2], c1[3]);
    } else {
      d0[0] = c0[0];
      d1[0] = c1[0];
    }
  });
}

// 6. Reconstruction of image blockIdx.y (one image a row).
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
stream_reconstruct(const T* __restrict__ x, T* __restrict__ out, int64_t p,
                   const RowParams* __restrict__ prm, const float* __restrict__ maxc,
                   const float* __restrict__ stain, const float* __restrict__ tmc) {
  __shared__ float lut[256];
  build_lut<T>(lut);
  __syncthreads();
  const int64_t i = blockIdx.y;
  const RowParams& rp = prm[i];
  float m[6], st[6];
  for (int k = 0; k < 3; ++k) {
    m[k] = rp.m0[k];
    m[3 + k] = rp.m1[k];
  }
  for (int k = 0; k < 6; ++k) st[k] = stain[k];
  const float sc0 = maxc_scale(tmc[0], maxc[2 * i]);
  const float sc1 = maxc_scale(tmc[1], maxc[2 * i + 1]);
  T* dst = out + i * 3 * p;
  sweep<T, V>(x, p, lut, [&](bool ok, const float (&od)[3][V], int64_t g) {
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

template <typename T, int V>
void launch_stats(const void* x, int64_t n, int64_t p, int ipr, int fallback, int bx,
                  long long idx99, double* partials, RowParams* prm, int* ranks2,
                  uint32_t* init3, int* ranks99, float* field, cudaStream_t s) {
  const auto* xt = static_cast<const T*>(x);
  const dim3 grid(static_cast<unsigned>(bx), static_cast<unsigned>(n));
  const int64_t rows = n / ipr;
  stream_moments<T, V><<<grid, kThreads, 0, s>>>(xt, p, fallback, partials);
  stream_scalars<<<static_cast<unsigned>(rows), 32 * kPart, 0, s>>>(
      partials, ipr * bx, fallback, idx99, prm, ranks2, init3, ranks99);
  stream_angle_field<T, V><<<grid, kThreads, 0, s>>>(xt, p, ipr, prm, field, init3);
}

template <typename T, int V>
void launch_conc(const void* x, int64_t n, int64_t p, int ipr, int bx, RowParams* prm,
                 const float* phi, float* field2, cudaStream_t s) {
  const dim3 grid(static_cast<unsigned>(bx), static_cast<unsigned>(n));
  stream_conc_field<T, V><<<grid, kThreads, 0, s>>>(static_cast<const T*>(x), p, ipr, prm, phi,
                                                    field2);
}

template <typename T, int V>
void launch_reconstruct(const void* x, void* out, int64_t n, int64_t p, int bx,
                        const RowParams* prm, const float* maxc, const float* stain,
                        const float* tmc, cudaStream_t s) {
  const dim3 grid(static_cast<unsigned>(bx), static_cast<unsigned>(n));
  stream_reconstruct<T, V><<<grid, kThreads, 0, s>>>(static_cast<const T*>(x),
                                                     static_cast<T*>(out), p, prm, maxc, stain,
                                                     tmc);
}

// Calls launcher<T, V> for the input's type and vector width.
#define STAINX_DISPATCH(launcher, ...)                                 \
  do {                                                                 \
    if (is_uint8) {                                                    \
      if (vec == 4) launcher<uint8_t, 4>(__VA_ARGS__);                 \
      else launcher<uint8_t, 1>(__VA_ARGS__);                          \
    } else {                                                           \
      if (vec == 4) launcher<float, 4>(__VA_ARGS__);                   \
      else launcher<float, 1>(__VA_ARGS__);                            \
    }                                                                  \
  } while (0)

}  // namespace

// ------------------------------------------------------------- C interface
// x: (n, 3, p) contiguous uint8 or float32 on the current device; rows of
// ipr images each (1 at transform; n at fit, the pool); bx blocks an image;
// vec is 4 when p % 4 == 0 and every buffer is 16-byte aligned, else 1.
// Each function returns cudaGetLastError().
extern "C" {

const char* stainx_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Steps 1-3. partials: (n*bx, 20) float64; prm: (rows, 32) float32; ranks2:
// (rows, 2) int32; init3: (rows, 3) int32; ranks99: (2*rows,) int32; field:
// (rows, ipr*p) float32.
int stainx_stream_stats(const void* x, long long n, long long p, int ipr, int is_uint8, int vec,
                        int bx, int fallback, long long idx99, void* partials, void* prm,
                        void* ranks2, void* init3, void* ranks99, void* field, void* stream) {
  STAINX_DISPATCH(launch_stats, x, n, p, ipr, fallback, bx, idx99,
                  static_cast<double*>(partials), static_cast<RowParams*>(prm),
                  static_cast<int*>(ranks2), static_cast<uint32_t*>(init3),
                  static_cast<int*>(ranks99), static_cast<float*>(field),
                  static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

// Step 5. phi: (rows, 2) float32 selected angles; field2: (2*rows, ipr*p).
int stainx_stream_conc(const void* x, long long n, long long p, int ipr, int is_uint8, int vec,
                       int bx, void* prm, const void* phi, void* field2, void* stream) {
  STAINX_DISPATCH(launch_conc, x, n, p, ipr, bx, static_cast<RowParams*>(prm),
                  static_cast<const float*>(phi), static_cast<float*>(field2),
                  static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

// Step 6 (transform, one image a row). maxc: (n, 2) float32; stain: (3, 2)
// and tmc: (2,) float32.
int stainx_stream_reconstruct(const void* x, void* out, long long n, long long p, int is_uint8,
                              int vec, int bx, const void* prm, const void* maxc,
                              const void* stain, const void* tmc, void* stream) {
  STAINX_DISPATCH(launch_reconstruct, x, out, n, p, bx, static_cast<const RowParams*>(prm),
                  static_cast<const float*>(maxc), static_cast<const float*>(stain),
                  static_cast<const float*>(tmc), static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
