// Device helpers of the Macenko kernels, shared by macenko_fused.cu (B1, B2)
// and macenko_stream.cu (B4, B5): OD and its uint8 table, the covariance of
// the 10 moments about OD-1, the closed-form 3x3 eigh, the diamond
// pseudo-angle and its inverse, H/E ordering with the 2x2 normal rows, the
// maxC scale, and 1- or 4-pixel loads and stores of the channel planes.
// Plain PyTorch twins: stainx_tpu_torch/kernels/macenko_fused.py and
// stainx_tpu_torch/ops/eigh3.py. Built with -fmad=false, so products and
// sums round as in those twins.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "keys.cuh"

namespace stainx {

constexpr int kSums = 10;  // count, 3 sums, 6 second moments
constexpr float kIo = 240.0f;
constexpr float kBeta = 0.15f;
constexpr int kAlpha = 1;

// 0-based round(0.01*q*(n-1)), half to even, clamped at 0.
__device__ inline long long nearest_rank_index(int q, long long n) {
  const long long m = n - 1;
  if (m < 0) return 0;
  const long long t = q * m;
  const long long quot = t / 100, rem = t % 100;
  return quot + ((rem > 50 || (rem == 50 && (quot & 1))) ? 1 : 0);
}

__device__ __forceinline__ float od_u8(float v) { return -logf((v + 1.0f) / kIo); }
__device__ __forceinline__ float od_f32(float v) { return -logf((v * 255.0f + 1.0f) / kIo); }

__device__ __forceinline__ float min3(float a, float b, float c) {
  const float ab = a < b ? a : b;
  return ab < c ? ab : c;
}

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// uint8 value -> OD table in shared memory, built with the same formula.
template <typename T>
__device__ inline void build_lut(float* lut) {
  if constexpr (sizeof(T) == 1) {
    for (int v = threadIdx.x; v < 256; v += blockDim.x) lut[v] = od_u8(static_cast<float>(v));
  }
}

// Covariance entries (a00, a01, a02, a11, a12, a22) from the kSums totals
// (s[0] is the count).
__device__ inline void cov_from_moments(const double* s, float* a) {
  const float cnt = static_cast<float>(s[0]);
  const float s0 = static_cast<float>(s[1]), s1 = static_cast<float>(s[2]),
              s2 = static_cast<float>(s[3]);
  const float mom[6] = {static_cast<float>(s[4]), static_cast<float>(s[5]),
                        static_cast<float>(s[6]), static_cast<float>(s[7]),
                        static_cast<float>(s[8]), static_cast<float>(s[9])};
  const float safe = cnt > 1.0f ? cnt : 1.0f;
  const float mu[3] = {s0 / safe, s1 / safe, s2 / safe};
  const float den = (cnt - 1.0f) > 1.0f ? (cnt - 1.0f) : 1.0f;
  const bool ok = cnt > 1.0f;
  const int ij[6][2] = {{0, 0}, {0, 1}, {0, 2}, {1, 1}, {1, 2}, {2, 2}};
  for (int k = 0; k < 6; ++k) {
    a[k] = ok ? (mom[k] - cnt * mu[ij[k][0]] * mu[ij[k][1]]) / den : 0.0f;
  }
}

__device__ inline void cross(const float* u, const float* v, float* c) {
  c[0] = u[1] * v[2] - u[2] * v[1];
  c[1] = u[2] * v[0] - u[0] * v[2];
  c[2] = u[0] * v[1] - u[1] * v[0];
}

__device__ __forceinline__ float sq3(const float* c) {
  return c[0] * c[0] + c[1] * c[1] + c[2] * c[2];
}

// Unit null-space direction of A - lam*I: the largest cross product of its
// rows, zero when all are degenerate.
__device__ inline void nullspace(const float* a, float lam, float* v) {
  const float r0[3] = {a[0] - lam, a[1], a[2]};
  const float r1[3] = {a[1], a[3] - lam, a[4]};
  const float r2[3] = {a[2], a[4], a[5] - lam};
  float c01[3], c02[3], c12[3];
  cross(r0, r1, c01);
  cross(r0, r2, c02);
  cross(r1, r2, c12);
  const float n01 = sq3(c01), n02 = sq3(c02), n12 = sq3(c12);
  const float* best = n02 > n01 ? c02 : c01;
  const float bn = n01 > n02 ? n01 : n02;
  if (n12 > bn) best = c12;
  const float norm = sqrtf(sq3(best));
  const float inv = norm > 1e-30f ? 1.0f / norm : 0.0f;
  for (int c = 0; c < 3; ++c) v[c] = best[c] * inv;
}

// Eigenvectors of the middle and largest eigenvalues: v[0..2], v[3..5].
__device__ inline void eigh3_top2(const float* a, float* v) {
  const float a00 = a[0], a01 = a[1], a02 = a[2], a11 = a[3], a12 = a[4], a22 = a[5];
  const float p1 = a01 * a01 + a02 * a02 + a12 * a12;
  const float q = (a00 + a11 + a22) / 3.0f;
  const float d0 = a00 - q, d1 = a11 - q, d2 = a22 - q;
  const float p2 = d0 * d0 + d1 * d1 + d2 * d2 + 2.0f * p1;
  const float p6 = p2 / 6.0f;
  const float p = sqrtf(p6 > 1e-30f ? p6 : 1e-30f);
  const float inv_p = 1.0f / p;
  const float b00 = d0 * inv_p, b11 = d1 * inv_p, b22 = d2 * inv_p;
  const float b01 = a01 * inv_p, b02 = a02 * inv_p, b12 = a12 * inv_p;
  const float det_b = b00 * (b11 * b22 - b12 * b12) - b01 * (b01 * b22 - b12 * b02) +
                      b02 * (b01 * b12 - b11 * b02);
  const float r = clampf(det_b / 2.0f, -1.0f, 1.0f);
  const float phi = acosf(r) / 3.0f;
  float e_max = q + 2.0f * p * cosf(phi);
  const float e_min = q + 2.0f * p * cosf(phi + 2.0943951023931953f);
  float e_mid = 3.0f * q - e_max - e_min;
  if (p1 <= 1e-30f) {  // (effectively) diagonal: the sorted diagonal
    float lo = a00, mid = a11, hi = a22, t;
    if (lo > mid) { t = lo; lo = mid; mid = t; }
    if (mid > hi) { t = mid; mid = hi; hi = t; }
    if (lo > mid) { t = lo; lo = mid; mid = t; }
    e_mid = mid;
    e_max = hi;
  }
  nullspace(a, e_mid, v);
  nullspace(a, e_max, v + 3);
}

// Diamond angle, order-isomorphic to atan2(t1, t0) on (-2, 2].
__device__ __forceinline__ float pseudo_angle(float t0, float t1) {
  const float s = fabsf(t0) + fabsf(t1) + 1e-37f;
  const float a = t1 / s;
  return t0 >= 0.0f ? a : (t1 >= 0.0f ? 2.0f - a : -2.0f - a);
}

// (cos, sin) of the direction a diamond angle encodes.
__device__ inline void dir_from_pseudo(float p, float* c, float* s) {
  const float ap = fabsf(p);
  const float u = ap <= 1.0f ? 1.0f - ap : (p > 1.0f ? 1.0f - p : 1.0f + p);
  const float v = ap <= 1.0f ? p : (p > 1.0f ? 2.0f - p : -2.0f - p);
  const float norm = sqrtf(u * u + v * v);
  const float inv = norm > 1e-30f ? 1.0f / norm : 0.0f;
  *c = u * inv;
  *s = v * inv;
}

// Extreme stain vectors, H/E ordering (he row-major (3, 2)) and the 2x2
// normal rows m0, m1 with the +-1e12 inverse clamp.
__device__ inline void stain_from_phi(const float* evs, float phi_lo, float phi_hi, float* he,
                                      float* m0, float* m1) {
  float cl, sl, ch, sh;
  dir_from_pseudo(phi_lo, &cl, &sl);
  dir_from_pseudo(phi_hi, &ch, &sh);
  float vlo[3], vhi[3];
  for (int c = 0; c < 3; ++c) {
    vlo[c] = evs[c] * cl + evs[3 + c] * sl;
    vhi[c] = evs[c] * ch + evs[3 + c] * sh;
  }
  const bool swap = vlo[0] > vhi[0];
  float h0[3], h1[3];
  for (int c = 0; c < 3; ++c) {
    h0[c] = swap ? vlo[c] : vhi[c];
    h1[c] = swap ? vhi[c] : vlo[c];
    he[2 * c] = h0[c];
    he[2 * c + 1] = h1[c];
  }
  const float a = h0[0] * h0[0] + h0[1] * h0[1] + h0[2] * h0[2];
  const float b = h0[0] * h1[0] + h0[1] * h1[1] + h0[2] * h1[2];
  const float cc = h1[0] * h1[0] + h1[1] * h1[1] + h1[2] * h1[2];
  const float inv_det = clampf(1.0f / (a * cc - b * b), -1e12f, 1e12f);
  for (int d = 0; d < 3; ++d) {
    m0[d] = (cc * h0[d] - b * h1[d]) * inv_det;
    m1[d] = (a * h1[d] - b * h0[d]) * inv_det;
  }
}

// Sign-preserving maxC floor.
__device__ __forceinline__ float maxc_scale(float tmc, float maxc) {
  return tmc / (fabsf(maxc) > 1e-30f ? maxc : 1e-30f);
}

// Beer-Lambert reconstruction of one pixel's channel c from its scaled
// concentrations, clipped to [0, 255]; st is HE row-major (3, 2).
__device__ __forceinline__ float reconstruct(const float* st, int c, float cn0, float cn1) {
  return clampf(kIo * expf(-(st[2 * c] * cn0 + st[2 * c + 1] * cn1)), 0.0f, 255.0f);
}

// ------------------------------------------------------------- pixel access
template <typename T> struct Vec4;
template <> struct Vec4<uint8_t> { using type = uchar4; };
template <> struct Vec4<float> { using type = float4; };

__device__ __forceinline__ float od_of(uint8_t v, const float* lut) { return lut[v]; }
__device__ __forceinline__ float od_of(float v, const float*) { return od_f32(v); }

// OD of pixels [V*g, V*g+V) of the three channel planes starting at `img`,
// planes p elements apart.
template <typename T, int V>
__device__ __forceinline__ void load_od(const T* img, int64_t p, int64_t g, const float* lut,
                                        float (&od)[3][V]) {
  for (int c = 0; c < 3; ++c) {
    const T* plane = img + c * p;
    if constexpr (V == 4) {
      const auto q = reinterpret_cast<const typename Vec4<T>::type*>(plane)[g];
      od[c][0] = od_of(q.x, lut);
      od[c][1] = od_of(q.y, lut);
      od[c][2] = od_of(q.z, lut);
      od[c][3] = od_of(q.w, lut);
    } else {
      od[c][0] = od_of(plane[g], lut);
    }
  }
}

__device__ __forceinline__ uint8_t to_store(float v, uint8_t) {
  return static_cast<uint8_t>(static_cast<int>(v));  // truncate after the clip
}
__device__ __forceinline__ float to_store(float v, float) { return v; }

template <typename T, int V>
__device__ __forceinline__ void store_rgb(T* img, int64_t p, int64_t g, const float (&rgb)[3][V]) {
  for (int c = 0; c < 3; ++c) {
    T* plane = img + c * p;
    if constexpr (V == 4) {
      typename Vec4<T>::type q;
      q.x = to_store(rgb[c][0], T());
      q.y = to_store(rgb[c][1], T());
      q.z = to_store(rgb[c][2], T());
      q.w = to_store(rgb[c][3], T());
      reinterpret_cast<typename Vec4<T>::type*>(plane)[g] = q;
    } else {
      plane[g] = to_store(rgb[c][0], T());
    }
  }
}

}  // namespace stainx
