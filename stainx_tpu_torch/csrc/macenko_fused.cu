// Macenko fit and transform kernels for Hopper (sm_90a), with a plain C
// interface loaded through ctypes (stainx_tpu_torch/kernels/macenko_fused.py).
//
// What they replace
//   transform_kernel: stainx_tpu/kernels/macenko_fused.py::macenko_transform_mega
//     (_mega_kernel), the whole per-image Macenko transform (B1).
//   fit_kernel: stainx_tpu/kernels/macenko_fused.py::macenko_fit_mega
//     (_fit_mega_kernel), the pooled reference fit (B2).
//   Both share the device helpers below: OD, the 10 moments about OD-1,
//   covariance, the closed-form 3x3 eigh, the diamond pseudo-angle and its
//   inverse, H/E ordering, the 2x2 normal rows, the maxC scale, and an exact
//   radix select on the monotone key (the job of selection.py's
//   radix_select_multi inside the TPU kernels).
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

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kSums = 10;  // count, 3 sums, 6 second moments
constexpr int kBins = 256;
constexpr float kIo = 240.0f;
constexpr float kBeta = 0.15f;
constexpr int kAlpha = 1;
constexpr uint32_t kSentinelKey = 0xFF800000u;  // monotone_key(+inf)
constexpr unsigned kFull = 0xFFFFFFFFu;

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

// ------------------------------------------------------------ scalar helpers
__device__ __forceinline__ uint32_t monotone_key(float x) {
  const uint32_t u = __float_as_uint(x);
  return u ^ ((u >> 31) ? 0xFFFFFFFFu : 0x80000000u);
}

__device__ __forceinline__ float unkey(uint32_t k) {
  return __uint_as_float(k ^ ((k >> 31) ? 0x80000000u : 0xFFFFFFFFu));
}

// 0-based round(0.01*q*(n-1)), half to even, clamped at 0.
__device__ long long nearest_rank_index(int q, long long n) {
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

// Covariance entries (a00, a01, a02, a11, a12, a22) from the block totals.
__device__ void cov_from_moments(const double* s, float* a) {
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

__device__ void cross(const float* u, const float* v, float* c) {
  c[0] = u[1] * v[2] - u[2] * v[1];
  c[1] = u[2] * v[0] - u[0] * v[2];
  c[2] = u[0] * v[1] - u[1] * v[0];
}

__device__ __forceinline__ float sq3(const float* c) {
  return c[0] * c[0] + c[1] * c[1] + c[2] * c[2];
}

// Unit null-space direction of A - lam*I: the largest cross product of its
// rows, zero when all are degenerate.
__device__ void nullspace(const float* a, float lam, float* v) {
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
__device__ void eigh3_top2(const float* a, float* v) {
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
__device__ void dir_from_pseudo(float p, float* c, float* s) {
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
__device__ void stain_from_phi(const float* evs, float phi_lo, float phi_hi, float* he,
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

// ------------------------------------------------------------- pixel access
template <typename T> struct Vec4;
template <> struct Vec4<uint8_t> { using type = uchar4; };
template <> struct Vec4<float> { using type = float4; };

__device__ __forceinline__ float od_of(uint8_t v, const float* lut) { return lut[v]; }
__device__ __forceinline__ float od_of(float v, const float*) { return od_f32(v); }

// OD of pixels [V*g, V*g+V) of the three channel planes starting at `img`.
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

template <typename T>
__device__ void build_lut(Shared& sh) {
  if constexpr (sizeof(T) == 1) {
    for (int v = threadIdx.x; v < 256; v += blockDim.x) sh.lut[v] = od_u8(static_cast<float>(v));
  }
  __syncthreads();
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
// Adds one to hist[bin] for every lane of the warp, bin 256 meaning none;
// lanes with the same bin are added by one atomic of their leader.
__device__ __forceinline__ void hist_add(unsigned int* hist, unsigned bin) {
  const unsigned peers = __match_any_sync(kFull, bin);
  if (bin < kBins && static_cast<int>(threadIdx.x & 31) == __ffs(peers) - 1) {
    atomicAdd(&hist[bin], static_cast<unsigned>(__popc(peers)));
  }
}

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
  build_lut<T>(sh);
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
      for (int c = 0; c < 3; ++c) {
        rgb[c][j] = clampf(kIo * expf(-(st[2 * c] * cn0 + st[2 * c + 1] * cn1)), 0.0f, 255.0f);
      }
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
