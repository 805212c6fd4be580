// Reinhard kernels for Hopper (sm_90a), with a plain C interface loaded
// through ctypes (stainx_tpu_torch/kernels/reinhard_fused.py).
//
// What they replace
//   moments_kernel (+ moments_finalize):
//     stainx_tpu/kernels/reinhard_fused.py::reinhard_moments_pallas
//     (_reinhard_moments_kernel), the batch-global centred LAB sums
//     S1 = sum(LAB - 128) and S2 = sum((LAB - 128)^2) per channel (B7b).
//   apply_kernel: stainx_tpu/kernels/reinhard_fused.py::reinhard_apply_pallas
//     (_reinhard_kernel), RGB -> LAB -> (lab - mu) / (sigma + 1e-8) *
//     sigma_ref + mu_ref -> RGB -> clip [0, 1] in one pass (B7a).
//
// What bounds them
//   Not bytes. At 64x3x512^2 uint8 the moments read 50.33 MB (15.0 us at
//   3.35 TB/s) and the apply moves 100.66 MB (30.0 us). But every pixel
//   needs powf: per pixel the moments evaluate 3 cube roots (powf) and the
//   apply 3 cube roots and 3 powf(x, 1/2.4) (the uint8 sRGB linearization
//   is a 256-entry table; float input adds 3 powf(x, 2.4)). The accurate
//   powf that nvcc emits for sm_90a is a polynomial logarithm and
//   exponential on the FMA pipes, 58 float32 operations on its common path,
//   not a special-function instruction. With the colour arithmetic around
//   it that is about 212 float32 operations a uint8 pixel for the moments
//   and 433 for the apply: 53 us and 108 us at 67 TFLOP/s, above the byte
//   bound. These kernels are bound by float32 operations (chip_smoke.py
//   computes the bound from the counts it states).
//
// What the design does about it
//   Both kernels are one grid-stride pass over the N*H*W pixels, each thread
//   reading all three channel planes of 4 neighbouring pixels (uchar4 or
//   float4 loads when a row's pixel count is a multiple of 4, else one
//   pixel), at most 8 blocks of 256 threads an SM so that every SM has
//   enough warps in flight to keep its FMA pipes busy. uint8
//   input linearizes through a shared table built once per block with the
//   same formula. Each kernel masks its own ragged end, so the pad
//   corrections of the JAX wrappers have no counterpart here; the pixel
//   count N*H*W is exact host arithmetic.
//
// Exactness and determinism
//   No float atomics. Each thread sums its pixels' centred LAB values and
//   their squares in double; warp shuffles, then one thread per sum over the
//   warps, reduce a block in a fixed order into per-block partials; a second
//   one-block kernel adds the partials in index order, one warp per sum with
//   a strided sweep and a fixed shuffle tree. The grid depends only on the
//   shape and the card, so two runs give the same bits.
//
// Formulas
//   Those of stainx_tpu_torch/ops/color.py, term by term: pow(max(t, 1e-12),
//   1/3) for the cube root (not cbrtf), no fast-math intrinsics, built with
//   -fmad=false. Division by a constant is written as multiplication by its
//   float reciprocal, which is how PyTorch evaluates `tensor / scalar` on a
//   CUDA tensor, so the plain versions on the card round the same way;
//   divisions by data (the z-score) are true divisions.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMoments = 6;  // S1 (3), S2 (3)
constexpr float kCenter = 128.0f;
constexpr unsigned kFull = 0xFFFFFFFFu;

// Python-double constants as PyTorch hands them to a float kernel.
constexpr float kSixteenOver116 = static_cast<float>(16.0 / 116.0);
constexpr float kThird = static_cast<float>(1.0 / 3.0);
constexpr float kInvGamma = static_cast<float>(1.0 / 2.4);

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// sRGB [0, 1] -> linear.
__device__ __forceinline__ float srgb_to_linear(float p) {
  return p > 0.04045f ? powf((p + 0.055f) * (1.0f / 1.055f), 2.4f) : p * (1.0f / 12.92f);
}

__device__ __forceinline__ float lab_f(float t) {
  const float cube_root = powf(fmaxf(t, 1e-12f), kThird);
  return t > 0.008856f ? cube_root : 7.787f * t + kSixteenOver116;
}

// Linear RGB -> scaled LAB (L * 2.55, a + 128, b + 128).
__device__ __forceinline__ void linear_to_lab(float r, float g, float b, float (&lab)[3]) {
  const float x = 0.412453f * r + 0.357580f * g + 0.180423f * b;
  const float y = 0.212671f * r + 0.715160f * g + 0.072169f * b;
  const float z = 0.019334f * r + 0.119193f * g + 0.950227f * b;
  const float fx = lab_f(x * (1.0f / 0.95047f));
  const float fy = lab_f(y);
  const float fz = lab_f(z * (1.0f / 1.08883f));
  lab[0] = (116.0f * fy - 16.0f) * 2.55f;
  lab[1] = 500.0f * (fx - fy) + 128.0f;
  lab[2] = 200.0f * (fy - fz) + 128.0f;
}

__device__ __forceinline__ float lab_f_inv(float t) {
  return t > 0.2068966f ? t * t * t : (t - kSixteenOver116) * (1.0f / 7.787f);
}

__device__ __forceinline__ float linear_to_srgb(float c) {
  const float v = c > 0.0031308f ? 1.055f * powf(fmaxf(c, 1e-12f), kInvGamma) - 0.055f
                                 : 12.92f * c;
  return clampf(v, 0.0f, 1.0f);
}

// Scaled LAB -> sRGB clamped to [0, 1].
__device__ __forceinline__ void lab_to_rgb(const float (&lab)[3], float (&rgb)[3]) {
  const float L = lab[0] * (1.0f / 2.55f);
  const float a = lab[1] - 128.0f;
  const float b = lab[2] - 128.0f;
  const float fy = (L + 16.0f) * (1.0f / 116.0f);
  const float fx = a * (1.0f / 500.0f) + fy;
  const float fz = fy - b * (1.0f / 200.0f);
  const float x = lab_f_inv(fx) * 0.95047f;
  const float y = lab_f_inv(fy) * 1.0f;
  const float z = lab_f_inv(fz) * 1.08883f;
  rgb[0] = linear_to_srgb(3.2404542f * x + -1.5371385f * y + -0.4985314f * z);
  rgb[1] = linear_to_srgb(-0.9692660f * x + 1.8760108f * y + 0.0415560f * z);
  rgb[2] = linear_to_srgb(0.0556434f * x + -0.2040259f * y + 1.0572252f * z);
}

// Shared table: uint8 value -> linear RGB, the formula of srgb_to_linear on
// v / 255 (evaluated as v * (1 / 255), as PyTorch divides by a scalar).
template <typename T>
__device__ void build_lut(float* lut) {
  if constexpr (sizeof(T) == 1) {
    for (int v = threadIdx.x; v < 256; v += blockDim.x) {
      lut[v] = srgb_to_linear(static_cast<float>(v) * (1.0f / 255.0f));
    }
  }
}

// Linear RGB of V neighbouring pixels starting at `base` in channel plane 0.
template <typename T, int V>
__device__ __forceinline__ void load_linear(const T* __restrict__ x, int64_t base, int64_t p,
                                            const float* lut, float (&lin)[3][V]) {
  for (int c = 0; c < 3; ++c) {
    const T* src = x + base + c * p;
    if constexpr (sizeof(T) == 1) {
      if constexpr (V == 4) {
        const uchar4 q = *reinterpret_cast<const uchar4*>(src);
        lin[c][0] = lut[q.x];
        lin[c][1] = lut[q.y];
        lin[c][2] = lut[q.z];
        lin[c][3] = lut[q.w];
      } else {
        lin[c][0] = lut[src[0]];
      }
    } else {
      if constexpr (V == 4) {
        const float4 q = *reinterpret_cast<const float4*>(src);
        lin[c][0] = srgb_to_linear(q.x);
        lin[c][1] = srgb_to_linear(q.y);
        lin[c][2] = srgb_to_linear(q.z);
        lin[c][3] = srgb_to_linear(q.w);
      } else {
        lin[c][0] = srgb_to_linear(src[0]);
      }
    }
  }
}

// uint8 stores trunc(clip(x * 255, 0, 255)); float32 stores x.
template <typename T>
__device__ __forceinline__ T to_out(float v) {
  if constexpr (sizeof(T) == 1) {
    return static_cast<T>(static_cast<int>(clampf(v * 255.0f, 0.0f, 255.0f)));
  } else {
    return v;
  }
}

template <typename T, int V>
__device__ __forceinline__ void store_rgb(T* __restrict__ out, int64_t base, int64_t p,
                                          const float (&rgb)[3][V]) {
  for (int c = 0; c < 3; ++c) {
    T* dst = out + base + c * p;
    if constexpr (V == 4) {
      if constexpr (sizeof(T) == 1) {
        *reinterpret_cast<uchar4*>(dst) = make_uchar4(to_out<T>(rgb[c][0]), to_out<T>(rgb[c][1]),
                                                      to_out<T>(rgb[c][2]), to_out<T>(rgb[c][3]));
      } else {
        *reinterpret_cast<float4*>(dst) = make_float4(rgb[c][0], rgb[c][1], rgb[c][2], rgb[c][3]);
      }
    } else {
      dst[0] = to_out<T>(rgb[c][0]);
    }
  }
}

// ------------------------------------------------------------------ kernels
// Per-block partial sums (kMoments doubles a block) of the centred LAB
// values of pixel groups [0, groups), V pixels a group, gpi groups an image.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
moments_kernel(const T* __restrict__ x, double* __restrict__ partials, int64_t groups,
               int64_t gpi, int64_t p) {
  __shared__ float lut[256];
  __shared__ double warp_part[kWarps][kMoments];
  build_lut<T>(lut);
  __syncthreads();

  double acc[kMoments] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t g = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; g < groups;
       g += stride) {
    const int64_t img = g / gpi;
    const int64_t base = img * 3 * p + (g - img * gpi) * V;
    float lin[3][V];
    load_linear<T, V>(x, base, p, lut, lin);
    for (int j = 0; j < V; ++j) {
      float lab[3];
      linear_to_lab(lin[0][j], lin[1][j], lin[2][j], lab);
      for (int c = 0; c < 3; ++c) {
        const float y = lab[c] - kCenter;
        acc[c] += static_cast<double>(y);
        acc[3 + c] += static_cast<double>(y * y);
      }
    }
  }

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int k = 0; k < kMoments; ++k) {
    double v = acc[k];
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(kFull, v, off);
    if (lane == 0) warp_part[warp][k] = v;
  }
  __syncthreads();
  if (threadIdx.x < kMoments) {
    double s = 0.0;
    for (int w = 0; w < kWarps; ++w) s += warp_part[w][threadIdx.x];
    partials[static_cast<int64_t>(blockIdx.x) * kMoments + threadIdx.x] = s;
  }
}

// One block of kMoments warps: warp k adds the blocks' partials of sum k in
// index order (lane l takes blocks l, l + 32, ...; then a fixed shuffle
// tree) and writes it as float.
__global__ void moments_finalize(const double* __restrict__ partials, int blocks,
                                 float* __restrict__ out) {
  const int lane = threadIdx.x & 31, k = threadIdx.x >> 5;
  double s = 0.0;
  for (int b = lane; b < blocks; b += 32) s += partials[static_cast<int64_t>(b) * kMoments + k];
  for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(kFull, s, off);
  if (lane == 0) out[k] = static_cast<float>(s);
}

// The fused transfer of pixel groups [0, groups); stats are the four (3,)
// float32 statistics on the device.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
apply_kernel(const T* __restrict__ x, T* __restrict__ out, const float* __restrict__ lab_mean,
             const float* __restrict__ lab_std, const float* __restrict__ ref_mean,
             const float* __restrict__ ref_std, int64_t groups, int64_t gpi, int64_t p) {
  __shared__ float lut[256];
  __shared__ float st[12];  // mean, std + 1e-8, reference mean, reference std
  build_lut<T>(lut);
  if (threadIdx.x < 3) {
    const int c = threadIdx.x;
    st[c] = lab_mean[c];
    st[3 + c] = lab_std[c] + 1e-8f;
    st[6 + c] = ref_mean[c];
    st[9 + c] = ref_std[c];
  }
  __syncthreads();
  float s[12];
  for (int k = 0; k < 12; ++k) s[k] = st[k];

  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t g = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; g < groups;
       g += stride) {
    const int64_t img = g / gpi;
    const int64_t base = img * 3 * p + (g - img * gpi) * V;
    float lin[3][V];
    load_linear<T, V>(x, base, p, lut, lin);
    float rgb[3][V];
    for (int j = 0; j < V; ++j) {
      float lab[3], px[3];
      linear_to_lab(lin[0][j], lin[1][j], lin[2][j], lab);
      for (int c = 0; c < 3; ++c) lab[c] = (lab[c] - s[c]) / s[3 + c] * s[9 + c] + s[6 + c];
      lab_to_rgb(lab, px);
      for (int c = 0; c < 3; ++c) rgb[c][j] = clampf(px[c], 0.0f, 1.0f);
    }
    store_rgb<T, V>(out, base, p, rgb);
  }
}

template <typename T, int V>
void launch_moments(const void* x, double* partials, float* out, int64_t n, int64_t p, int blocks,
                    cudaStream_t s) {
  const int64_t gpi = p / V;
  moments_kernel<T, V><<<blocks, kThreads, 0, s>>>(static_cast<const T*>(x), partials, n * gpi,
                                                   gpi, p);
  moments_finalize<<<1, 32 * kMoments, 0, s>>>(partials, blocks, out);
}

template <typename T, int V>
void launch_apply(const void* x, void* out, const float* const (&stats)[4], int64_t n, int64_t p,
                  int blocks, cudaStream_t s) {
  const int64_t gpi = p / V;
  apply_kernel<T, V><<<blocks, kThreads, 0, s>>>(static_cast<const T*>(x), static_cast<T*>(out),
                                                 stats[0], stats[1], stats[2], stats[3], n * gpi,
                                                 gpi, p);
}

}  // namespace

// ------------------------------------------------------------- C interface
extern "C" {

const char* stainx_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x: (n, 3, p) contiguous uint8 or float32; partials: (blocks, 6) float64
// scratch; out6: S1 (3) then S2 (3), float32. vec is 4 when p % 4 == 0 and x
// is 16-byte aligned, else 1. Returns cudaGetLastError().
int stainx_reinhard_moments(const void* x, void* partials, void* out6, long long n, long long p,
                            int is_uint8, int vec, int blocks, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  auto* part = static_cast<double*>(partials);
  auto* o = static_cast<float*>(out6);
  if (is_uint8) {
    if (vec == 4) launch_moments<uint8_t, 4>(x, part, o, n, p, blocks, s);
    else launch_moments<uint8_t, 1>(x, part, o, n, p, blocks, s);
  } else {
    if (vec == 4) launch_moments<float, 4>(x, part, o, n, p, blocks, s);
    else launch_moments<float, 1>(x, part, o, n, p, blocks, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// x, out: (n, 3, p) contiguous uint8 or float32; lab_mean, lab_std,
// ref_mean, ref_std: (3,) float32; all on the current device.
int stainx_reinhard_apply(const void* x, void* out, const void* lab_mean, const void* lab_std,
                          const void* ref_mean, const void* ref_std, long long n, long long p,
                          int is_uint8, int vec, int blocks, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const float* const stats[4] = {
      static_cast<const float*>(lab_mean), static_cast<const float*>(lab_std),
      static_cast<const float*>(ref_mean), static_cast<const float*>(ref_std)};
  if (is_uint8) {
    if (vec == 4) launch_apply<uint8_t, 4>(x, out, stats, n, p, blocks, s);
    else launch_apply<uint8_t, 1>(x, out, stats, n, p, blocks, s);
  } else {
    if (vec == 4) launch_apply<float, 4>(x, out, stats, n, p, blocks, s);
    else launch_apply<float, 1>(x, out, stats, n, p, blocks, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
