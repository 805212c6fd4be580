// Reinhard kernels for Hopper (sm_90a), with a plain C interface loaded
// through ctypes (stainx_tpu_torch/kernels/reinhard_fused.py).
//
// What they replace
//   moments_kernel (+ moments_finalize):
//     stainx_tpu/kernels/reinhard_fused.py::reinhard_moments_pallas
//     (_reinhard_moments_kernel), the batch-global centred LAB sums
//     S1 = sum(LAB - 128) and S2 = sum((LAB - 128)^2) per channel (B7b).
//     The finalize also writes the Bessel-corrected LAB mean and std, in
//     ops/reinhard.py::moments_to_mean_std's order.
//   apply_kernel: stainx_tpu/kernels/reinhard_fused.py::reinhard_apply_pallas
//     (_reinhard_kernel), RGB -> LAB -> (lab - mu) / (sigma + 1e-8) *
//     sigma_ref + mu_ref -> RGB -> clip [0, 1] in one pass (B7a).
//
// What bounds them
//   The least time is the bytes: a cube root or a gamma is one operation of
//   the function's work, so a uint8 pixel needs about 41 float32 operations
//   for the moments and 91 for the apply (10 us and 23 us at 67 TFLOP/s over
//   64x3x512^2), while the moments read 50.33 MB (15.0 us at 3.35 TB/s) and
//   the apply moves 100.66 MB (30.0 us). What the card spends is
//   instructions: the accurate powf of libm is ~58 operations on the FMA
//   pipes, evaluated 3 (moments) and 6 (apply) times a uint8 pixel, over
//   half of both kernels' time before this design. As built, about 53 and
//   113 instructions a uint8 pixel remain (6 and 12 of them MUFU), so both
//   are bound by instruction issue at 2-3x their byte bounds.
//
// What the design does about it
//   - Every power on the special-function unit: x^e = ex2(e * lg2(x))
//     (MUFU.LG2, MUFU.EX2, flush-to-zero forms), for the cube root (t >
//     0.008856), the inverse gamma (c > 0.0031308) and the forward gamma
//     (float32 input). Each argument there is a positive normal float, so
//     the forms hold for any input, [0, 1] or not; both branches are
//     evaluated and one selected. The error is a few ulps of the result
//     (ex2 and lg2 are good to about 2^-22), against 1 grey level of slack.
//   - Products and sums that belong together are explicit __fmaf_rn (the
//     library is built with -fmad=false for the Macenko kernels' bit-exact
//     selections); constants are folded: the white point into both 3x3
//     matrices, 2.55 and 116 into the L lines, the z-score, reference and
//     LAB->f scalings into per-channel scale and offset pairs computed once
//     a block, so the apply has no division a pixel. The z-score keeps its
//     subtraction (lab - mu) before the product: folded into one FMA, a
//     uniform batch (sigma = 0, scale ~1e9) would cancel catastrophically.
//   - A thread adds its group's centred values and squares in float32 and
//     adds that partial to its float64 sums: 6 conversions a group of 16
//     uint8 (4 float32) pixels, not a pixel.
//   - A grid-stride launch of at most 8 blocks an SM, the groups of all
//     images dealt out evenly over its threads; a thread steps its group
//     and image with no division (one 64-bit division a group was software
//     emulated), its group in 32 bits and its image in 64. A thread reads
//     16 bytes of each channel plane (16 uint8 or 4 float32 pixels) when
//     the plane's pixel count and the base allow it, else one pixel. uint8
//     input linearizes through a 256-entry shared table built once a block;
//     uint8 output truncates by adding 2^23 rounding toward zero and keeping
//     the low byte (no F2I).
//   - The finalize writes the mean and std beside the sums, and the apply
//     reads its statistics from the device: a transform is one C call
//     (moments, finalize, apply) with nothing between the kernels.
//
// Exactness and determinism
//   No float atomics. Per-thread float64 sums; warp shuffles, then one
//   thread per sum over the warps, reduce a block in a fixed order into
//   per-block partials; a one-block finalize adds the partials in index
//   order, one warp per sum with a strided sweep and a fixed shuffle tree.
//   The grid depends only on the shape and the card, so two runs give the
//   same bits.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMoments = 6;  // S1 (3), S2 (3)
constexpr unsigned kFull = 0xFFFFFFFFu;

// Python-double constants as float; folded products are taken in double.
__host__ __device__ constexpr float f32(double v) { return static_cast<float>(v); }
constexpr float kSixteenOver116 = f32(16.0 / 116.0);
constexpr float kThird = f32(1.0 / 3.0);
constexpr float kInvGamma = f32(1.0 / 2.4);
constexpr double kWhiteX = 0.95047, kWhiteZ = 1.08883;

__device__ __forceinline__ float fma_rn(float a, float b, float c) { return __fmaf_rn(a, b, c); }

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// x^e for a positive normal x on the special-function unit.
__device__ __forceinline__ float pow_pos(float x, float e) {
  float l, y;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(l) : "f"(x));
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(l * e));
  return y;
}

// sRGB [0, 1] -> linear.
__device__ __forceinline__ float srgb_to_linear(float p) {
  const float u = fma_rn(p, f32(1.0 / 1.055), f32(0.055 / 1.055));
  return p > 0.04045f ? pow_pos(u, 2.4f) : p * f32(1.0 / 12.92);
}

__device__ __forceinline__ float lab_f(float t) {
  const float root = pow_pos(t, kThird);
  return t > 0.008856f ? root : fma_rn(7.787f, t, kSixteenOver116);
}

// f(X / Xn), f(Y), f(Z / Zn) of linear RGB: the RGB -> XYZ matrix with the
// white point folded into its rows.
__device__ __forceinline__ void lab_fs(float r, float g, float b, float& fx, float& fy,
                                       float& fz) {
  fx = lab_f(fma_rn(f32(0.412453 / kWhiteX), r,
                    fma_rn(f32(0.357580 / kWhiteX), g, f32(0.180423 / kWhiteX) * b)));
  fy = lab_f(fma_rn(0.212671f, r, fma_rn(0.715160f, g, 0.072169f * b)));
  fz = lab_f(fma_rn(f32(0.019334 / kWhiteZ), r,
                    fma_rn(f32(0.119193 / kWhiteZ), g, f32(0.950227 / kWhiteZ) * b)));
}

__device__ __forceinline__ float lab_f_inv(float t) {
  const float linear = fma_rn(t, f32(1.0 / 7.787), f32(-16.0 / 116.0 / 7.787));
  return t > 0.2068966f ? t * t * t : linear;
}

// Linear -> sRGB times `scale` (1 for float32 output, 255 for uint8),
// clamped to [0, scale].
__device__ __forceinline__ float linear_to_srgb(float c, float scale) {
  const float gamma = fma_rn(1.055f * scale, pow_pos(c, kInvGamma), -0.055f * scale);
  return clampf(c > 0.0031308f ? gamma : (12.92f * scale) * c, 0.0f, scale);
}

// f values of the transferred LAB -> sRGB times `scale`: the XYZ -> RGB
// matrix with the white point folded into its columns.
__device__ __forceinline__ void fs_to_rgb(float fx, float fy, float fz, float scale,
                                          float& r, float& g, float& b) {
  const float x = lab_f_inv(fx), y = lab_f_inv(fy), z = lab_f_inv(fz);
  r = linear_to_srgb(fma_rn(f32(3.2404542 * kWhiteX), x,
                            fma_rn(-1.5371385f, y, f32(-0.4985314 * kWhiteZ) * z)), scale);
  g = linear_to_srgb(fma_rn(f32(-0.9692660 * kWhiteX), x,
                            fma_rn(1.8760108f, y, f32(0.0415560 * kWhiteZ) * z)), scale);
  b = linear_to_srgb(fma_rn(f32(0.0556434 * kWhiteX), x,
                            fma_rn(-0.2040259f, y, f32(1.0572252 * kWhiteZ) * z)), scale);
}

// A value in [0, 255] truncated to its byte, in the low 8 bits (adding 2^23
// rounded toward zero leaves the integer part in the mantissa's low bits).
__device__ __forceinline__ uint32_t trunc_byte(float v) {
  return __float_as_uint(__fadd_rz(v, 8388608.0f));
}

// ------------------------------------------------------------- pixel I/O
// A group is V neighbouring pixels of one image: 16 bytes of each channel
// plane (V = 16 uint8, V = 4 float32) or one pixel (V = 1). The input words
// stay intact until every pixel of the group is read; outputs go to their
// own words.
template <typename T, int V>
struct Group {
  static constexpr int kWords = V * sizeof(T) / 4 > 0 ? V * sizeof(T) / 4 : 1;
  uint32_t w[3][kWords];  // input
  uint32_t o[3][kWords];  // output
  uint32_t staged[3][4];  // uint8: the truncated bytes of 4 pixels, then packed

  __device__ __forceinline__ void load(const T* __restrict__ plane0, int64_t p, int64_t first) {
    for (int c = 0; c < 3; ++c) {
      const T* src = plane0 + c * p + first;
      if constexpr (V * sizeof(T) == 16) {
        const uint4 q = __ldg(reinterpret_cast<const uint4*>(src));
        w[c][0] = q.x;
        w[c][1] = q.y;
        w[c][2] = q.z;
        w[c][3] = q.w;
      } else if constexpr (sizeof(T) == 1) {
        w[c][0] = src[0];
      } else {
        w[c][0] = __float_as_uint(src[0]);
      }
    }
  }

  // Linear RGB of pixel j.
  __device__ __forceinline__ void linear(int j, const float* lut, float (&rgb)[3]) const {
    for (int c = 0; c < 3; ++c) {
      if constexpr (sizeof(T) == 1) {
        rgb[c] = lut[__byte_perm(w[c][j >> 2], 0u, 0x4440u | (j & 3))];
      } else {
        rgb[c] = srgb_to_linear(__uint_as_float(w[c][j]));
      }
    }
  }

  // Output value v of pixel j, channel c: in [0, 255] for uint8 (its
  // truncated byte), in [0, 1] for float32.
  __device__ __forceinline__ void put(int c, int j, float v) {
    if constexpr (sizeof(T) == 1 && V > 1) {
      staged[c][j & 3] = trunc_byte(v);
      if ((j & 3) == 3) {
        o[c][j >> 2] = __byte_perm(__byte_perm(staged[c][0], staged[c][1], 0x0040),
                                   __byte_perm(staged[c][2], staged[c][3], 0x0040), 0x5410);
      }
    } else if constexpr (sizeof(T) == 1) {
      o[c][0] = trunc_byte(v);
    } else {
      o[c][j] = __float_as_uint(v);
    }
  }

  __device__ __forceinline__ void store(T* __restrict__ plane0, int64_t p, int64_t first) const {
    for (int c = 0; c < 3; ++c) {
      T* dst = plane0 + c * p + first;
      if constexpr (V * sizeof(T) == 16) {
        *reinterpret_cast<uint4*>(dst) = make_uint4(o[c][0], o[c][1], o[c][2], o[c][3]);
      } else if constexpr (sizeof(T) == 1) {
        dst[0] = static_cast<uint8_t>(o[c][0]);
      } else {
        dst[0] = __uint_as_float(o[c][0]);
      }
    }
  }
};

// Shared table: uint8 value -> linear RGB, srgb_to_linear of v * (1 / 255)
// (as PyTorch divides by a scalar).
template <typename T>
__device__ void build_lut(float* lut) {
  if constexpr (sizeof(T) == 1) {
    for (int v = threadIdx.x; v < 256; v += blockDim.x) {
      lut[v] = srgb_to_linear(static_cast<float>(v) * f32(1.0 / 255.0));
    }
  }
}

// Calls body(image, first pixel) for each group of this thread. Groups are
// numbered image by image, gpi an image; thread t of the grid takes groups
// t, t + stride, ... One division a thread finds its first group; a step
// then adds the stride's whole images and remainder, with no division
// (g + r < 2 gpi <= 2^32: the wrapper allows at most 2^31 groups an image).
template <typename F>
__device__ __forceinline__ void for_each_group(int64_t n, unsigned gpi, int V, F&& body) {
  const unsigned stride = gridDim.x * kThreads;
  const unsigned q = stride / gpi, r = stride - q * gpi;
  const uint64_t first = static_cast<uint64_t>(blockIdx.x) * kThreads + threadIdx.x;
  int64_t img = static_cast<int64_t>(first / gpi);
  unsigned g = static_cast<unsigned>(first - static_cast<uint64_t>(img) * gpi);
  while (img < n) {
    body(img, static_cast<int64_t>(g) * V);
    img += q;
    g += r;
    if (g >= gpi) {
      g -= gpi;
      ++img;
    }
  }
}

// ------------------------------------------------------------------ kernels
// Per-block partial sums (kMoments doubles a block) of the centred LAB
// values of n images of p pixels, gpi groups of V pixels an image.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
moments_kernel(const T* __restrict__ x, double* __restrict__ partials, int64_t n, int64_t p,
               unsigned gpi) {
  __shared__ float lut[256];
  __shared__ double warp_part[kWarps][kMoments];
  build_lut<T>(lut);
  __syncthreads();

  double acc[kMoments] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
  for_each_group(n, gpi, V, [&](int64_t img, int64_t first) {
    Group<T, V> grp;
    grp.load(x + img * 3 * p, p, first);
    float part[kMoments] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < V; ++j) {
      float rgb[3], fx, fy, fz;
      grp.linear(j, lut, rgb);
      lab_fs(rgb[0], rgb[1], rgb[2], fx, fy, fz);
      // L - 128 = (116 fy - 16) 2.55 - 128; a - 128; b - 128.
      const float y[3] = {fma_rn(fy, 295.8f, -168.8f), 500.0f * (fx - fy), 200.0f * (fy - fz)};
      for (int c = 0; c < 3; ++c) {
        part[c] += y[c];
        part[3 + c] = fma_rn(y[c], y[c], part[3 + c]);
      }
    }
    for (int k = 0; k < kMoments; ++k) acc[k] += static_cast<double>(part[k]);
  });

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
// tree) and writes it as float. Three threads then write the LAB mean (3)
// and std (3) of n pixels into `stats` from the float sums, as
// moments_to_mean_std computes them: mean_c = S1 / n, var = max(S2 -
// n mean_c mean_c, 0) / max(n - 1, 1), mean = mean_c + 128, std = sqrt(var),
// every operation rounded on its own (true divisions).
__global__ void moments_finalize(const double* __restrict__ partials, int blocks,
                                 float* __restrict__ out, float* __restrict__ stats,
                                 long long n) {
  __shared__ float sums[kMoments];
  const int lane = threadIdx.x & 31, k = threadIdx.x >> 5;
  double s = 0.0;
  for (int b = lane; b < blocks; b += 32) s += partials[static_cast<int64_t>(b) * kMoments + k];
  for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(kFull, s, off);
  if (lane == 0) {
    out[k] = static_cast<float>(s);
    sums[k] = static_cast<float>(s);
  }
  __syncthreads();
  if (threadIdx.x < 3) {
    const int c = threadIdx.x;
    const float nf = static_cast<float>(n);
    const float den = static_cast<float>(n > 1 ? static_cast<double>(n) - 1.0 : 1.0);
    const float mean_c = __fdiv_rn(sums[c], nf);
    const float sq = __fmul_rn(__fmul_rn(nf, mean_c), mean_c);
    const float var = fmaxf(__fsub_rn(sums[3 + c], sq), 0.0f);
    stats[c] = __fadd_rn(mean_c, 128.0f);
    stats[3 + c] = __fsqrt_rn(__fdiv_rn(var, den));
  }
}

// The fused transfer of n images of p pixels (gpi groups of V pixels an
// image); the statistics are four (3,) float32 vectors on the device.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
apply_kernel(const T* __restrict__ x, T* __restrict__ out, const float* __restrict__ lab_mean,
             const float* __restrict__ lab_std, const float* __restrict__ ref_mean,
             const float* __restrict__ ref_std, int64_t n, int64_t p, unsigned gpi) {
  constexpr float kScale = sizeof(T) == 1 ? 255.0f : 1.0f;
  __shared__ float lut[256];
  // Per channel: the offset of the centred LAB value (0-2), then the scale
  // (3-5) and offset (6-8) that take it to the transferred f value:
  //   L' = (L - mu) s + mu_ref,  s = sigma_ref / (sigma + 1e-8),
  //   fy' = L' / 295.8 + 16 / 116, fx' = fy' + (a' - 128) / 500,
  //   fz' = fy' - (b' - 128) / 200.
  __shared__ float k_sh[9];
  build_lut<T>(lut);
  if (threadIdx.x < 3) {
    const int c = threadIdx.x;
    const float unit = c == 0 ? f32(1.0 / 295.8) : (c == 1 ? 0.002f : -0.005f);
    const float scale = ref_std[c] / (lab_std[c] + 1e-8f);
    k_sh[c] = (c == 0 ? -40.8f : 128.0f) - lab_mean[c];
    k_sh[3 + c] = scale * unit;
    k_sh[6 + c] = c == 0 ? fma_rn(ref_mean[0], unit, kSixteenOver116)
                         : (ref_mean[c] - 128.0f) * unit;
  }
  __syncthreads();
  float k[9];
  for (int i = 0; i < 9; ++i) k[i] = k_sh[i];

  for_each_group(n, gpi, V, [&](int64_t img, int64_t first) {
    Group<T, V> grp;
    grp.load(x + img * 3 * p, p, first);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      float rgb[3], fx, fy, fz;
      grp.linear(j, lut, rgb);
      lab_fs(rgb[0], rgb[1], rgb[2], fx, fy, fz);
      const float dl = fma_rn(fy, 295.8f, k[0]);
      const float da = fma_rn(500.0f, fx - fy, k[1]);
      const float db = fma_rn(200.0f, fy - fz, k[2]);
      const float fy2 = fma_rn(dl, k[3], k[6]);
      const float fx2 = fma_rn(da, k[4], fy2 + k[7]);
      const float fz2 = fma_rn(db, k[5], fy2 + k[8]);
      fs_to_rgb(fx2, fy2, fz2, kScale, rgb[0], rgb[1], rgb[2]);
      for (int c = 0; c < 3; ++c) grp.put(c, j, rgb[c]);
    }
    grp.store(out + img * 3 * p, p, first);
  });
}

// A one-dimensional grid of `blocks`; gpi groups of V pixels an image.
template <typename T, int V>
void launch_moments(const void* x, double* partials, float* out, float* stats, int64_t n,
                    int64_t p, int blocks, cudaStream_t s) {
  moments_kernel<T, V><<<blocks, kThreads, 0, s>>>(static_cast<const T*>(x), partials, n, p,
                                                   static_cast<unsigned>(p / V));
  moments_finalize<<<1, 32 * kMoments, 0, s>>>(partials, blocks, out, stats, n * p);
}

template <typename T, int V>
void launch_apply(const void* x, void* out, const float* const (&stats)[4], int64_t n,
                  int64_t p, int blocks, cudaStream_t s) {
  apply_kernel<T, V><<<blocks, kThreads, 0, s>>>(static_cast<const T*>(x), static_cast<T*>(out),
                                                 stats[0], stats[1], stats[2], stats[3], n, p,
                                                 static_cast<unsigned>(p / V));
}

// Records `event` (a CUDA event, or null for none) on `s`; the CUDA error.
int mark(void* event, cudaStream_t s) {
  return event == nullptr
             ? 0
             : static_cast<int>(cudaEventRecord(static_cast<cudaEvent_t>(event), s));
}

}  // namespace

// ------------------------------------------------------------- C interface
extern "C" {

const char* stainx_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x: (n, 3, p) contiguous uint8 or float32, p / vec <= 2^31; partials:
// (blocks, 6) float64 scratch; out6: S1 (3) then S2 (3), float32; stats6:
// the LAB mean (3) then std (3), float32. vec is the group: 16 (uint8) or 4
// (float32) when p is a multiple of it and x is 16-byte aligned, else 1.
// Returns cudaGetLastError().
int stainx_reinhard_moments(const void* x, void* partials, void* out6, void* stats6, long long n,
                            long long p, int is_uint8, int vec, int blocks, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  auto* part = static_cast<double*>(partials);
  auto* o = static_cast<float*>(out6);
  auto* st = static_cast<float*>(stats6);
  if (is_uint8) {
    if (vec == 16) launch_moments<uint8_t, 16>(x, part, o, st, n, p, blocks, s);
    else launch_moments<uint8_t, 1>(x, part, o, st, n, p, blocks, s);
  } else {
    if (vec == 4) launch_moments<float, 4>(x, part, o, st, n, p, blocks, s);
    else launch_moments<float, 1>(x, part, o, st, n, p, blocks, s);
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
    if (vec == 16) launch_apply<uint8_t, 16>(x, out, stats, n, p, blocks, s);
    else launch_apply<uint8_t, 1>(x, out, stats, n, p, blocks, s);
  } else {
    if (vec == 4) launch_apply<float, 4>(x, out, stats, n, p, blocks, s);
    else launch_apply<float, 1>(x, out, stats, n, p, blocks, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// The Reinhard transform of x into out: the moments and their finalize,
// which writes the LAB mean and std into stats6, then the apply with those
// statistics and ref_mean, ref_std ((3,) float32), all on `stream`. One
// call from the host in place of two keeps the host's issue time below the
// card's run time on the main path. Scratch and shapes as above.
// stats_start and stats_end, where not null, are CUDA events of the stream's
// device, made with timing: stats_start is recorded before the moments
// launch and stats_end after their finalize, so the interval between them
// holds the call-wide statistics and nothing the host or the apply does.
// launch_start and launch_end, where not null, are such events too:
// recorded just before the first launch and just after the last, so the
// interval holds the call's three launches. The launches, their order and
// the outputs are the same with or without.
int stainx_reinhard_transform(const void* x, void* out, void* partials, void* out6,
                              void* stats6, const void* ref_mean, const void* ref_std,
                              long long n, long long p, int is_uint8, int vec, int blocks,
                              void* stream, void* stats_start, void* stats_end,
                              void* launch_start, void* launch_end) {
  const auto s = static_cast<cudaStream_t>(stream);
  int code = mark(launch_start, s);
  if (code == 0) code = mark(stats_start, s);
  if (code != 0) return code;
  code = stainx_reinhard_moments(x, partials, out6, stats6, n, p, is_uint8, vec, blocks, stream);
  if (code != 0) return code;
  code = mark(stats_end, s);
  if (code != 0) return code;
  const auto* st = static_cast<const float*>(stats6);
  code = stainx_reinhard_apply(x, out, st, st + 3, ref_mean, ref_std, n, p, is_uint8, vec,
                               blocks, stream);
  if (code != 0) return code;
  return mark(launch_end, s);
}

}  // extern "C"
