// Multi-block Macenko transform and fit for Hopper (sm_90a), with a plain C
// interface loaded through ctypes (stainx_tpu_torch/kernels/macenko_stream.py).
//
// What they replace
//   stainx_tpu/kernels/macenko_stream.py::macenko_transform_stream (B4) and
//   ::macenko_fit_stream (B5), the streaming tier: B1's and B2's functions
//   for rows and pools past one block's reach. A row is one image at
//   transform, or at fit the N images pooled channel-major, read in place.
//
// What bounds them
//   64x3x512^2 uint8 through B4 must read 50.33 MB and write 50.33 MB:
//   0.030 ms at 3.35 TB/s, above the 0.022 ms that 89 float32 operations a
//   pixel need at 67 TFLOP/s, so bytes bound it; likewise 4x3x2048^2. B5 on
//   256x3x224^2 float32 reads 154.1 MB: 0.046 ms. In practice the exact
//   selections' passes over the pixels, each recomputing OD and the keys
//   and counting them into shared-memory histograms, take the time: the
//   instructions a pixel and pass, not the bytes.
//
// What the design does about it: two routes, each one C call.
//
// 1. Cluster (cluster_kernel, one launch): one thread-block cluster a row,
//    for rows whose three planes fit the shared memory of 8 blocks (uint8
//    rows up to 505 344 pixels, float32 up to 126 336). Block r of the
//    cluster takes pixels [r*S, (r+1)*S) of the row and copies the first R
//    of them into shared memory once (16-byte loads); every pass reads those
//    from there and the rest, if any, from device memory (they stay in L2).
//    Device memory sees one read of the input and, at transform, one write
//    of the output: 100.7 MB at 64x3x512^2 uint8, against 1.26 GB when the
//    keys went to device-memory fields that a separate select re-read for
//    every digit. The passes: the beta-masked moments (and
//    all-pixel ones for the <3-pixel fallback), block sums in a fixed order,
//    then the cluster's block sums added in rank order through distributed
//    shared memory (DSMEM), so every block holds the same bits and computes
//    the covariance, eigh and ranks itself; the two angle selections and
//    then the two concentration selections, each 4 passes of an 8-bit radix
//    select on the monotone key: per pass every block counts its keys'
//    digits in shared memory (integer atomics: exact, order-free), one
//    cluster.sync, and every block adds the cluster's histograms through
//    DSMEM and picks the same bin. Keys are recomputed from the pixels while
//    many match the prefixes; once a block's matching keys fit kCand, the
//    next pass also stores them in shared memory and the passes after it
//    read only those (on H&E tiles: passes 0-2 over the pixels, pass 3 over
//    about 2 000 stored keys a block). The angle selections' pass 0 also
//    counts the second digit under the top byte of the members' mean
//    direction, which on H&E rows is the one both selections take: they
//    then skip pass 1, and a row takes 7 sweeps over its pixels, not 8
//    (cluster_select2). No uint8 key reaches device memory.
//    float32 rows take each pixel's OD once a call, not once a pass (the
//    three logarithms were 39 % of B4 on 128x3x256^2 float32, paid on all 8
//    passes): the resident planes are stored as OD, converted as they are
//    loaded, and where a slice has pixels past the resident ones (R < S),
//    the first pass of each selection writes their keys to a key field in
//    device memory (8 bytes a pixel: the angle key, then the two
//    concentration keys over it) and the later passes and the
//    reconstruction read them, which needs only the concentrations (unkey
//    of a concentration key is the concentration, bit for bit). Those
//    pixels' logarithms are then taken in 3 passes (moments, and the first
//    of each selection), and a transform reads 68 bytes of them and writes
//    12 where it read 96. uint8 rows keep raw bytes and the 256-entry OD
//    table, which beats 4-byte OD and keys there.
//    Histograms are double-buffered, so one cluster.sync a pass is enough.
//    Every block runs the same passes and sweep iterations (S and R are the
//    same for all, the last slice's tail is masked), so no cluster.sync can
//    deadlock.
//    Cluster shape (kernels/macenko_stream.py cluster_shape): the largest
//    cluster, up to 16 blocks (past the portable 8: the kernel allows it),
//    of which the card holds every row's cluster at once
//    (cudaOccupancyMaxActiveClusters), then as much of each slice resident
//    as fits. 64x512^2 uint8 takes clusters of 2 blocks of 131 072 pixels,
//    63 168 of them resident: 128 blocks in one wave (the card holds 66 such
//    clusters, 30 of 4 and 15 of 8: one 1024-thread block an SM, and a
//    cluster's blocks share a GPC). A lone 512^2 row, the main path's
//    reference fit, takes a cluster of 16 (7 at once). chip_smoke.py phase
//    5 times every size on both.
//    Angles and concentrations crowd a few bins of their leading digits, so
//    a block counts into 8 copies of its histograms (lane l into copy l % 8,
//    copies a bank apart): warp-aggregated atomics (__match_any_sync) or a
//    single copy spent most of a pass there.
//
// 2. Streamed (stream_*, one memset and 10 kernels at transform, 9 at fit,
//    each in launches of at most 65 535 images):
//    longer rows (2048^2, 4096^2, 8192^2 uint8, path (a)'s 12.85 M-pixel
//    float32 pool) are spread over the card in 256-thread blocks. For uint8 every selection pass
//    recomputes the keys from the raw bytes: 3 bytes a pixel a pass against
//    4 for an angle field or 8 for two concentration fields. Per pixel:
//    moments 3, 4 angle passes 12, 4 concentration passes 12,
//    reconstruction 3 + 3 written: 33 bytes against 75 with key fields. A float32
//    pixel is 12 bytes, so there the first pass of each selection also
//    writes the keys (4 bytes, or 8 for both concentrations) and passes 1-3
//    read them: 84 bytes a pixel at fit against 96 (raw re-reads
//    would take 108), and three logarithms a pixel in 3 passes, not 9. The
//    pick of each pass runs in the last block of the row to finish its
//    histogram (a per-row ticket): no separate init, scalar or pick launch
//    and no host sync.
//
// 3. The batch-mode fit fused into the cluster route's transform (one
//    cooperative launch of cluster_kernel<T, true>): batch mode fits image
//    ref_row and transforms the batch on that fit, and every row's cluster
//    already computes the row's own statistics, ref_row's among them, with
//    the fit's arithmetic. So the rank-0 block of row ref_row also writes
//    them to fit_prm, a RowParams of its own (B5's numbers for that image,
//    the moments summed in B4's block order); a grid barrier follows, and
//    every row reconstructs on fit_prm's HE and maxC. A reference row whose
//    beta-masked pixels number under 3 takes the transform's fallback for
//    its own statistics, so its cluster first runs the fit's path (no
//    fallback) for fit_prm. The barrier needs every row's cluster resident
//    at once: the launch is cooperative, which the card refuses rather than
//    run a grid it cannot hold, and the wrapper takes this route only where
//    the card holds all the clusters (kernels/macenko_stream.py
//    fused_shape). This saves B5's separate launch, which ran one cluster on
//    16 of 132 SMs while the rest of the card waited.
//
// Both routes write a row's statistics into a 32-float RowParams: v_mid and
// v_max, the fallback flag, HE, the normal rows, the selected angles and
// maxC. stainx_stream_fields writes a row's angle and concentration keys
// with the same device functions, for checks of the fused selections.
// The arithmetic is B1's and B2's (macenko_common.cuh); only the order of
// the float64 sums differs, and it is fixed, so repeat runs are
// bit-identical. Selections follow B6's conventions: keys at or above
// monotone_key(+inf) (+inf, positive NaN) are not counted, a rank past the
// count takes the largest element, and a row with no element gives +inf.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "macenko_common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace stainx;

// Per-row statistics, 32 float32 a row (stainx_tpu_torch/kernels/macenko_stream.py
// reads he at [8, 14), phi at [20, 22) and maxc at [22, 24)).
struct RowParams {
  float evs[6];  // v_mid (3), v_max (3)
  float use_all;  // 1 when the <3-pixel fallback took all pixels
  float two_digit;  // 1 when the cluster route's angle selections skipped digit pass 1
  float he[6];  // HE row-major (3, 2)
  float m0[3];  // normal rows of the HE columns
  float m1[3];
  float phi[2];  // the selected alpha and 100-alpha pseudo-angles
  float maxc[2];  // the selected 99th-percentile concentrations
  float pad1[8];
};
static_assert(sizeof(RowParams) == 32 * sizeof(float), "RowParams is 32 floats");

// Two selections in flight: key bits chosen so far, rank left inside them,
// and whether the row had no element (the result is then +inf).
struct Sel2 {
  uint32_t prefix[2];
  int32_t empty[2];
  long long rank[2];
};
static_assert(sizeof(Sel2) == 32, "Sel2 is 32 bytes");

enum KeyMode { kAngle = 0, kConc = 1 };

// ---------------------------------------------------------------- keys
// The angle key of one pixel: the pseudo-angle in the stain plane, or the
// sentinel where the beta-mask drops the pixel.
__device__ __forceinline__ float angle_value(float o0, float o1, float o2, const float* v,
                                             bool use_all) {
  const float t0 = o0 * v[0] + o1 * v[1] + o2 * v[2];
  const float t1 = o0 * v[3] + o1 * v[4] + o2 * v[5];
  const bool member = use_all || min3(o0, o1, o2) >= kBeta;
  return member ? pseudo_angle(t0, t1) : __int_as_float(0x7F800000);
}

// The top byte of the angle key of the members' mean OD (m: their kSums
// totals of OD - 1; v: v_mid and v_max), the cluster route's guess of the
// top byte both angle selections take. The projection of the mean is the
// mean of the projections, so where the members' directions span less than
// a half-turn that does not cross the angle's cut, the mean's angle lies
// between the extreme ones; on H&E rows every member angle shares one top
// byte, and this names it. The selections' first pass verifies it.
__device__ __forceinline__ uint32_t mean_angle_byte(const double* m, const float* v) {
  float o[3];
  for (int c = 0; c < 3; ++c) o[c] = static_cast<float>(m[1 + c] / m[0]) + 1.0f;
  return monotone_key(angle_value(o[0], o[1], o[2], v, true)) >> 24;
}

// Keys of selection 0 and 1 for one pixel: the angle twice, or the two
// concentrations (m: the normal rows m0, m1).
template <int Mode>
__device__ __forceinline__ void keys2(float o0, float o1, float o2, const float* w, bool use_all,
                                      uint32_t& k0, uint32_t& k1) {
  if constexpr (Mode == kAngle) {
    k0 = k1 = monotone_key(angle_value(o0, o1, o2, w, use_all));
  } else {
    k0 = monotone_key(o0 * w[0] + o1 * w[1] + o2 * w[2]);
    k1 = monotone_key(o0 * w[3] + o1 * w[4] + o2 * w[5]);
  }
}

// Histogram bin of key k at pass d (shift = 24 - 8d) for a selection whose
// prefix is pre, or kBins when the key is not counted.
__device__ __forceinline__ unsigned digit(bool ok, uint32_t k, uint32_t pre, int d, int shift) {
  const bool in = ok && k < kSentinelKey && (d == 0 || ((k ^ pre) >> (shift + 8)) == 0u);
  return in ? (k >> shift) & 0xFFu : kBins;
}

// A block keeps its pass's histograms in Copies copies, lane l adding to
// copy l % Copies: lanes whose keys crowd one bin (angles and
// concentrations fill a few bins of their leading digits) then conflict at
// most 32 / Copies ways, where one copy serializes the whole warp. A copy
// holds both selections' bins and a word of padding, so the same bin of two
// copies lies in two banks.
constexpr int kClusterCopies = 8;
constexpr int kStreamCopies = 8;
constexpr int kCopyStride = 2 * kBins + 1;

template <int Copies>
__device__ __forceinline__ void rep_add(unsigned* rep, int s, unsigned bin) {
  if (bin < kBins) atomicAdd(rep + (threadIdx.x & (Copies - 1)) * kCopyStride + s * kBins + bin, 1u);
}

// Bin i of the 2 * kBins, summed over the copies, which are cleared.
template <int Copies>
__device__ __forceinline__ unsigned rep_take(unsigned* rep, int i) {
  unsigned c = 0u;
  for (int k = 0; k < Copies; ++k) {
    c += rep[k * kCopyStride + i];
    rep[k * kCopyStride + i] = 0u;
  }
  return c;
}

// One warp: pick the bin of histogram h that holds selection s's rank (the
// rank clamped to the count), append it to the prefix and keep the rank
// left inside it. A count of 0 at pass 0 marks the row empty.
__device__ void descend(const unsigned* h, Sel2& st, int s, int d) {
  const int lane = threadIdx.x & 31;
  if (st.empty[s]) return;  // warp-uniform
  unsigned local[8];
  long long total = 0;
  for (int i = 0; i < 8; ++i) {
    local[i] = h[lane * 8 + i];
    total += local[i];
  }
  long long incl = total;
  for (int off = 1; off < 32; off <<= 1) {
    const long long up = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += up;
  }
  const long long n = __shfl_sync(kFull, incl, 31);
  if (n == 0) {
    if (lane == 0) {
      st.empty[s] = 1;
      st.prefix[s] = kSentinelKey;
    }
    return;
  }
  const long long r = st.rank[s];
  const long long rr = r < 0 ? 0 : (r >= n ? n - 1 : r);
  long long below = incl - total;
  if (below <= rr && rr < incl) {
    for (int i = 0; i < 8; ++i) {
      if (rr < below + local[i]) {
        st.prefix[s] |= static_cast<uint32_t>(lane * 8 + i) << (24 - 8 * d);
        st.rank[s] = rr - below;
        break;
      }
      below += local[i];
    }
  }
}

__device__ __forceinline__ void sel_reset(Sel2& st, long long r0, long long r1) {
  st.prefix[0] = st.prefix[1] = 0u;
  st.empty[0] = st.empty[1] = 0;
  st.rank[0] = r0;
  st.rank[1] = r1;
}

__device__ __forceinline__ float sel_value(const Sel2& st, int s) { return unkey(st.prefix[s]); }

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

// Thread 0: covariance, eigh and the angle ranks of a row from its kSums
// totals; records v_mid, v_max and the fallback flag.
__device__ void row_scalars(const double* m, bool use_all, RowParams& row, Sel2& st) {
  float a[6];
  cov_from_moments(m, a);
  eigh3_top2(a, row.evs);
  row.use_all = use_all ? 1.0f : 0.0f;
  row.two_digit = 0.0f;
  const long long cnt = static_cast<long long>(m[0]);
  sel_reset(st, nearest_rank_index(kAlpha, cnt), nearest_rank_index(100 - kAlpha, cnt));
}

// Thread 0, after the angle selections: HE and the normal rows.
__device__ void row_stains(const Sel2& st, RowParams& row) {
  row.phi[0] = sel_value(st, 0);
  row.phi[1] = sel_value(st, 1);
  stain_from_phi(row.evs, row.phi[0], row.phi[1], row.he, row.m0, row.m1);
}

// ============================================================ streamed route
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPart = 2 * kSums;  // beta-masked sums, then all-pixel sums

// A streamed grid is (blocks an item, items), an item being an image or a
// key row. The y extent stops at 65 535, so the items run in launches of at
// most kMaxGridY, the launch for items [y0, y0 + gridDim.y) serving item
// y0 + blockIdx.y: any number of items fits.
constexpr unsigned kMaxGridY = 65535;

__device__ __forceinline__ unsigned grid_item(unsigned y0) { return y0 + blockIdx.y; }

// The pixel groups [begin, end) of its item that block blockIdx.x covers, V
// pixels a group.
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
// grid_item(y0). Every thread runs the same number of iterations (ok marks
// the real groups), so warp-wide intrinsics inside f see full warps.
template <typename T, int V, typename F>
__device__ __forceinline__ void sweep(const T* x, int64_t p, unsigned y0, const float* lut,
                                      F&& f) {
  const T* img = x + static_cast<int64_t>(grid_item(y0)) * 3 * p;
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

// Moments of each block into partials[(grid_item(y0) * gridDim.x +
// blockIdx.x) * kPart]; the row's last block adds the row's partials in
// index order and derives its statistics and angle ranks.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
stream_moments(const T* __restrict__ x, int64_t p, int ipr, unsigned y0, int fallback,
               double* __restrict__ partials, RowParams* __restrict__ prm, Sel2* __restrict__ sel,
               unsigned* __restrict__ tickets) {
  __shared__ float lut[256];
  __shared__ double warp_part[kWarps][kPart];
  __shared__ double sums[kPart];
  build_lut<T>(lut);
  __syncthreads();
  double acc[kPart];
  for (int k = 0; k < kPart; ++k) acc[k] = 0.0;
  sweep<T, V>(x, p, y0, lut, [&](bool ok, const float (&od)[3][V], int64_t) {
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
  const int64_t row = grid_item(y0) / static_cast<unsigned>(ipr);
  const int n_part = ipr * static_cast<int>(gridDim.x);
  if (threadIdx.x < kPart) {
    double s = 0.0;
    for (int w = 0; w < kWarps; ++w) s += warp_part[w][threadIdx.x];
    const int64_t b = static_cast<int64_t>(grid_item(y0)) * gridDim.x + blockIdx.x;
    partials[b * kPart + threadIdx.x] = s;
  }
  if (!last_of_row(tickets + row, static_cast<unsigned>(n_part))) return;
  // Sum k of the row's partials in index order: lane l takes l, l + 32,
  // ..., then a fixed shuffle tree; warp w serves sums w, w + 8, w + 16.
  const double* part = partials + row * n_part * kPart;
  for (int k = warp; k < kPart; k += kWarps) {
    double s = 0.0;
    for (int b = lane; b < n_part; b += 32) s += __ldcg(part + static_cast<int64_t>(b) * kPart + k);
    for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(kFull, s, off);
    if (lane == 0) sums[k] = s;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const bool use_all = fallback && sums[0] < 3.0;
    row_scalars(use_all ? sums + kSums : sums, use_all, prm[row], sel[row]);
  }
}

// The end of pass d for a streamed block: its histogram copies are added
// into the row's (2, 256) device histogram; the row's last block picks the
// bins, clears the histogram and, after the last pass, derives HE and the
// normal rows (angles) or records maxC. hist: (rows, 2, 256) uint32, then
// the rows' tickets.
template <int Mode>
__device__ void finish_pass(unsigned* rep, unsigned (*sh)[kBins], Sel2& st, int64_t row,
                            unsigned blocks, int d, bool shared_first, long long idx99,
                            RowParams* prm, Sel2* sel, unsigned* hist, unsigned* tickets) {
  __syncthreads();
  unsigned* h = hist + row * 2 * kBins;
  for (int i = threadIdx.x; i < 2 * kBins; i += kThreads) {
    const unsigned c = rep_take<kStreamCopies>(rep, i);
    if (c != 0u) atomicAdd(h + i, c);
  }
  if (!last_of_row(tickets + row, blocks)) return;
  for (int i = threadIdx.x; i < 2 * kBins; i += kThreads) {
    const int s = i / kBins, b = i % kBins;
    sh[s][b] = __ldcg(h + (shared_first ? b : i));
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 2 * kBins; i += kThreads) h[i] = 0u;
  const int warp = threadIdx.x >> 5;
  if (warp < 2) descend(sh[warp], st, warp, d);
  __syncthreads();
  if (threadIdx.x == 0) {
    RowParams& rp = prm[row];
    if (d == 3 && Mode == kAngle) {
      row_stains(st, rp);
      sel_reset(st, idx99, idx99);
    } else if (d == 3) {
      rp.maxc[0] = sel_value(st, 0);
      rp.maxc[1] = sel_value(st, 1);
    }
    sel[row] = st;
  }
}

// Pass d of the row's two selections (angles or concentrations) from the
// raw input: each block counts the digit of its keys that match the
// prefixes so far. With Write (float32, pass 0) it also stores the keys in
// a key field: the angle key at row r of a (rows, len) field, the two
// concentration keys at rows 2r and 2r+1 of a (2 * rows, len) one.
template <typename T, int V, int Mode, bool Write>
__global__ void __launch_bounds__(kThreads)
stream_count(const T* __restrict__ x, int64_t p, int ipr, unsigned y0, int d, long long idx99,
             RowParams* __restrict__ prm, Sel2* __restrict__ sel, unsigned* __restrict__ hist,
             unsigned* __restrict__ tickets, uint32_t* __restrict__ keys) {
  __shared__ float lut[256];
  __shared__ unsigned int rep[kStreamCopies * kCopyStride];
  __shared__ unsigned int sh[2][kBins];
  __shared__ Sel2 st;
  __shared__ float w[6];
  const int64_t row = grid_item(y0) / static_cast<unsigned>(ipr);
  build_lut<T>(lut);
  for (int i = threadIdx.x; i < kStreamCopies * kCopyStride; i += kThreads) rep[i] = 0u;
  if (threadIdx.x == 0) {
    st = sel[row];
    const RowParams& rp = prm[row];
    for (int k = 0; k < 6; ++k) w[k] = Mode == kAngle ? rp.evs[k] : (k < 3 ? rp.m0[k] : rp.m1[k - 3]);
  }
  __syncthreads();
  const bool use_all = prm[row].use_all != 0.0f;
  const bool shared_first = Mode == kAngle && d == 0;  // both angle ranks start alike
  const int shift = 24 - 8 * d;
  const uint32_t pre0 = st.prefix[0], pre1 = st.prefix[1];
  const int64_t len = static_cast<int64_t>(ipr) * p;
  uint32_t* key0 =
      keys + (Mode == kAngle ? row : 2 * row) * len +
      static_cast<int64_t>(grid_item(y0) % static_cast<unsigned>(ipr)) * p;
  uint32_t* key1 = key0 + len;
  float wr[6];
  for (int k = 0; k < 6; ++k) wr[k] = w[k];
  sweep<T, V>(x, p, y0, lut, [&](bool ok, const float (&od)[3][V], int64_t g) {
    uint32_t k0[V], k1[V];
    for (int j = 0; j < V; ++j) {
      keys2<Mode>(od[0][j], od[1][j], od[2][j], wr, use_all, k0[j], k1[j]);
      rep_add<kStreamCopies>(rep, 0, digit(ok, k0[j], pre0, d, shift));
      if (!shared_first) rep_add<kStreamCopies>(rep, 1, digit(ok, k1[j], pre1, d, shift));
    }
    if constexpr (Write) {
      if (!ok) return;
      if constexpr (V == 4) {
        reinterpret_cast<uint4*>(key0)[g] = make_uint4(k0[0], k0[1], k0[2], k0[3]);
        if constexpr (Mode == kConc) {
          reinterpret_cast<uint4*>(key1)[g] = make_uint4(k1[0], k1[1], k1[2], k1[3]);
        }
      } else {
        key0[g] = k0[0];
        if constexpr (Mode == kConc) key1[g] = k1[0];
      }
    }
  });
  finish_pass<Mode>(rep, sh, st, row, static_cast<unsigned>(ipr) * gridDim.x, d, shared_first,
                    idx99, prm, sel, hist, tickets);
}

// Pass d >= 1 of the row's two selections from the key field that pass 0
// wrote (float32 input): 4 bytes a key against the 12 of a raw pixel, and
// no logarithm. Grid (blocks, rows), from row y0.
template <int V, int Mode>
__global__ void __launch_bounds__(kThreads)
stream_count_keys(const uint32_t* __restrict__ keys, int64_t len, unsigned y0, int d,
                  long long idx99,
                  RowParams* __restrict__ prm, Sel2* __restrict__ sel,
                  unsigned* __restrict__ hist, unsigned* __restrict__ tickets) {
  __shared__ unsigned int rep[kStreamCopies * kCopyStride];
  __shared__ unsigned int sh[2][kBins];
  __shared__ Sel2 st;
  const int64_t row = grid_item(y0);
  for (int i = threadIdx.x; i < kStreamCopies * kCopyStride; i += kThreads) rep[i] = 0u;
  if (threadIdx.x == 0) st = sel[row];
  __syncthreads();
  const int shift = 24 - 8 * d;
  const uint32_t pre0 = st.prefix[0], pre1 = st.prefix[1];
  const uint32_t* key0 = keys + (Mode == kAngle ? row : 2 * row) * len;
  const uint32_t* key1 = Mode == kAngle ? key0 : key0 + len;
  const Span sp = block_span(len, V);
  for (int64_t g0 = sp.begin; g0 < sp.end; g0 += kThreads) {
    const int64_t g = g0 + threadIdx.x;
    const bool ok = g < sp.end;
    uint32_t k0[V], k1[V];
    if constexpr (V == 4) {
      const uint4 a = ok ? reinterpret_cast<const uint4*>(key0)[g] : make_uint4(0, 0, 0, 0);
      const uint4 b = ok ? reinterpret_cast<const uint4*>(key1)[g] : make_uint4(0, 0, 0, 0);
      k0[0] = a.x; k0[1] = a.y; k0[2] = a.z; k0[3] = a.w;
      k1[0] = b.x; k1[1] = b.y; k1[2] = b.z; k1[3] = b.w;
    } else {
      k0[0] = ok ? key0[g] : 0u;
      k1[0] = ok ? key1[g] : 0u;
    }
    for (int j = 0; j < V; ++j) {
      rep_add<kStreamCopies>(rep, 0, digit(ok, k0[j], pre0, d, shift));
      rep_add<kStreamCopies>(rep, 1, digit(ok, k1[j], pre1, d, shift));
    }
  }
  finish_pass<Mode>(rep, sh, st, row, gridDim.x, d, false, idx99, prm, sel, hist, tickets);
}

// Reconstruction of image grid_item(y0) (one image a row).
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
stream_reconstruct(const T* __restrict__ x, T* __restrict__ out, int64_t p, unsigned y0,
                   const RowParams* __restrict__ prm, const float* __restrict__ stain,
                   const float* __restrict__ tmc, float out_scale) {
  __shared__ float lut[256];
  build_lut<T>(lut);
  __syncthreads();
  const int64_t i = grid_item(y0);
  const RowParams& rp = prm[i];
  float m[6], st[6];
  for (int k = 0; k < 3; ++k) {
    m[k] = rp.m0[k];
    m[3 + k] = rp.m1[k];
  }
  for (int k = 0; k < 6; ++k) st[k] = stain[k];
  const float sc0 = maxc_scale(tmc[0], rp.maxc[0]);
  const float sc1 = maxc_scale(tmc[1], rp.maxc[1]);
  T* dst = out + i * 3 * p;
  sweep<T, V>(x, p, y0, lut, [&](bool ok, const float (&od)[3][V], int64_t g) {
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

// Check-only: the angle keys (as values, +inf off the mask) into row r of a
// (rows, ipr*p) field and both concentrations into rows 2r and 2r+1 of a
// (2*rows, ipr*p) field, from a call's RowParams, with the kernels' own
// device functions. Image i is part i % ipr of row i / ipr.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
stream_fields(const T* __restrict__ x, int64_t p, int ipr, unsigned y0,
              const RowParams* __restrict__ prm, float* __restrict__ angles,
              float* __restrict__ conc) {
  __shared__ float lut[256];
  build_lut<T>(lut);
  __syncthreads();
  const int64_t i = grid_item(y0), row = grid_item(y0) / static_cast<unsigned>(ipr);
  const RowParams& rp = prm[row];
  float v[6], w[6];
  for (int k = 0; k < 6; ++k) {
    v[k] = rp.evs[k];
    w[k] = k < 3 ? rp.m0[k] : rp.m1[k - 3];
  }
  const bool use_all = rp.use_all != 0.0f;
  const int64_t len = static_cast<int64_t>(ipr) * p;
  const int64_t base = (i % ipr) * p;
  sweep<T, V>(x, p, y0, lut, [&](bool ok, const float (&od)[3][V], int64_t g) {
    if (!ok) return;
    for (int j = 0; j < V; ++j) {
      const float o0 = od[0][j], o1 = od[1][j], o2 = od[2][j];
      const int64_t q = base + g * V + j;
      angles[row * len + q] = angle_value(o0, o1, o2, v, use_all);
      conc[2 * row * len + q] = o0 * w[0] + o1 * w[1] + o2 * w[2];
      conc[(2 * row + 1) * len + q] = o0 * w[3] + o1 * w[4] + o2 * w[5];
    }
  });
}

// ============================================================= cluster route
constexpr int kCThreads = 1024;
constexpr int kCWarps = kCThreads / 32;

// Keys a cluster block keeps as candidates of its two selections once few
// of its pixels still match their prefixes.
constexpr int kCand = 4096;
// What a block's pass of a selection reads: every pixel of its slice, every
// pixel while also storing its candidates' keys, or only the stored keys.
enum CandState { kSweep = 0, kCollect = 1, kFromBuffer = 2 };

// The fixed part of a cluster block's shared memory; the resident pixels'
// three planes follow it (stainx_tpu_torch/kernels/macenko_stream.py
// CLUSTER_FIXED_BYTES).
struct ClusterShared {
  float lut[256];                           // uint8 value -> OD
  double warp_part[kCWarps][kSums];         // per-warp partial sums
  double part[2][kSums];                    // the block's sums, one slot a moments pass
  double sums[kSums];                       // the cluster's sums, in rank order
  unsigned int rep[kClusterCopies * kCopyStride];  // the pass's histogram copies
  unsigned int hist[2][2][kBins];           // the block's histograms, double-buffered
  unsigned int merged[2][kBins];            // the cluster's histograms
  Sel2 st;
  RowParams row;
  uint32_t cand[kCand];                     // selection 0's keys, then selection 1's from cand_split
  unsigned int cand_count[2];
  int cand_split;
  int cand_state;                           // CandState of the next pass
};
constexpr int kClusterFixed = 42944;
static_assert(sizeof(ClusterShared) == kClusterFixed, "ClusterShared layout");
static_assert(kClusterFixed % 16 == 0, "the planes start 16-byte aligned");

// float32 rows take each pixel's OD once a call: the resident planes hold
// OD from the load on, and the pixels past them go through a key field
// (count_pixels). uint8 rows keep raw bytes and the OD table.
template <typename T>
constexpr bool kOdOnce = sizeof(T) == 4;

// A block's share of its row: pooled pixels [begin, begin + n_loc), of
// which the first R live in shared memory (planes, R apart) and the rest,
// up to the slice length S, are read from device memory (L2) each pass.
template <typename T>
struct Slice {
  const T* x;  // the row's first image
  const T* planes;
  int64_t p, begin, n_loc, S, R;
  int ipr;
  bool vec;  // 16-byte loads: p a multiple of 16 / sizeof(T), buffers aligned
  // float32 with R < S: the block's 2 * (S - R) keys in device memory, the
  // angle keys of the pixels past R, then over them the two concentration
  // keys, plane after plane (store_keys); else null.
  uint32_t* keys;
};

// Image and offset of pooled pixel qg of a row (ipr images of p pixels).
template <typename T>
__device__ __forceinline__ const T* pixel_image(const Slice<T>& sl, int64_t qg, int64_t& j) {
  if (sl.ipr == 1) {
    j = qg;
    return sl.x;
  }
  const int64_t i = static_cast<uint32_t>(qg) / static_cast<uint32_t>(sl.p);
  j = qg - i * sl.p;
  return sl.x + i * 3 * sl.p;
}

// Copies the resident pixels into shared memory, zero past n_loc; float32
// values as their OD, each logarithm taken once a call.
template <typename T>
__device__ void load_slice(const Slice<T>& sl, T* planes) {
  const int64_t R = sl.R;
  if (sl.vec) {
    constexpr int W = 16 / sizeof(T);
    const int64_t units = R / W;
#pragma unroll 4
    for (int64_t u = threadIdx.x; u < 3 * units; u += kCThreads) {
      const int64_t c = u / units, k = (u % units) * W;
      uint4 q = make_uint4(0u, 0u, 0u, 0u);
      if (k < sl.n_loc) {
        int64_t j;
        const T* img = pixel_image(sl, sl.begin + k, j);
        q = *reinterpret_cast<const uint4*>(img + c * sl.p + j);
      }
      if constexpr (kOdOnce<T>) {
        q = make_uint4(__float_as_uint(od_f32(__uint_as_float(q.x))),
                       __float_as_uint(od_f32(__uint_as_float(q.y))),
                       __float_as_uint(od_f32(__uint_as_float(q.z))),
                       __float_as_uint(od_f32(__uint_as_float(q.w))));
      }
      *reinterpret_cast<uint4*>(planes + c * R + k) = q;
    }
  } else {
    for (int64_t u = threadIdx.x; u < 3 * R; u += kCThreads) {
      const int64_t c = u / R, k = u % R;
      T v = T(0);
      if (k < sl.n_loc) {
        int64_t j;
        const T* img = pixel_image(sl, sl.begin + k, j);
        v = img[c * sl.p + j];
      }
      if constexpr (kOdOnce<T>) v = od_f32(v);
      planes[c * R + k] = v;
    }
  }
}

// OD of resident pixels [4g, 4g + 4): float32 planes hold it already.
template <typename T>
__device__ __forceinline__ void resident_od(const T* planes, int64_t R, int64_t g, const float* lut,
                                            float (&od)[3][4]) {
  if constexpr (kOdOnce<T>) {
    for (int c = 0; c < 3; ++c) {
      const float4 q = reinterpret_cast<const float4*>(planes + c * R)[g];
      od[c][0] = q.x;
      od[c][1] = q.y;
      od[c][2] = q.z;
      od[c][3] = q.w;
    }
  } else {
    load_od<T, 4>(planes, R, g, lut, od);
  }
}

// The parts of a block's slice a sweep covers: the resident pixels, the
// others, or both.
enum SweepPart { kResident = 1, kRest = 2, kWhole = 3 };

// Calls f(ok, od, q) for every group of 4 pixels [q, q + 4) of the block's
// slice (of Part of it): the resident ones from shared memory, then the
// others from device memory. Every block of the cluster runs the same R / 4
// and (S - R) / 4 groups and every thread the same iterations (ok marks the
// real pixels; a thread past the last group of a part gets q past it).
template <typename T, int Part = kWhole, typename F>
__device__ __forceinline__ void csweep(const Slice<T>& sl, const float* lut, F&& f) {
  const int64_t res = sl.R / 4, all = sl.S / 4;
  if constexpr ((Part & kResident) != 0) {
    for (int64_t g0 = 0; g0 < res; g0 += kCThreads) {
      const int64_t g = g0 + threadIdx.x;
      float od[3][4];
      bool ok[4];
      if (g < res) {
        resident_od<T>(sl.planes, sl.R, g, lut, od);
      } else {
        for (int c = 0; c < 3; ++c)
          for (int j = 0; j < 4; ++j) od[c][j] = 0.0f;
      }
      for (int j = 0; j < 4; ++j) ok[j] = g < res && 4 * g + j < sl.n_loc;
      f(ok, od, 4 * g);
    }
  }
  if constexpr ((Part & kRest) != 0) {
    for (int64_t g0 = res; g0 < all; g0 += kCThreads) {
      const int64_t g = g0 + threadIdx.x, q = 4 * g;
      float od[3][4];
      bool ok[4];
      for (int j = 0; j < 4; ++j) {
        ok[j] = g < all && q + j < sl.n_loc;
        for (int c = 0; c < 3; ++c) od[c][j] = 0.0f;
      }
      if (sl.vec) {  // a group is all in or all out: n_loc is a multiple of 4
        if (ok[0]) {
          int64_t j;
          const T* img = pixel_image(sl, sl.begin + q, j);
          load_od<T, 4>(img, sl.p, j / 4, lut, od);
        }
      } else {
        for (int jj = 0; jj < 4; ++jj) {
          if (!ok[jj]) continue;
          int64_t j;
          const T* img = pixel_image(sl, sl.begin + q + jj, j);
          for (int c = 0; c < 3; ++c) od[c][jj] = od_of(img[c * sl.p + j], lut);
        }
      }
      f(ok, od, q);
    }
  }
}

// The key field of a float32 block (Slice::keys): the keys of its pixels
// past the resident ones, 4 pixels a 16-byte word, in two planes of
// (S - R) / 4 words. A selection's first pass writes them (the angle key in
// plane 0; later the concentration keys in planes 0 and 1, over the angle
// keys, which nothing reads any more) and its later passes and the
// reconstruction read them, each thread the words it wrote itself.
template <int Mode>
__device__ __forceinline__ void store_keys(uint32_t* keys, int64_t words, int64_t i,
                                           const uint32_t (&k0)[4], const uint32_t (&k1)[4]) {
  reinterpret_cast<uint4*>(keys)[i] = make_uint4(k0[0], k0[1], k0[2], k0[3]);
  if constexpr (Mode == kConc) {
    reinterpret_cast<uint4*>(keys)[words + i] = make_uint4(k1[0], k1[1], k1[2], k1[3]);
  }
}

// Calls f(ok, k0, k1, q) for every group of 4 pixels [q, q + 4) of the
// block's slice past the resident ones, with their keys from the key field
// (the angle key twice, or the two concentration keys), in csweep's order.
template <typename T, int Mode, typename F>
__device__ __forceinline__ void ksweep(const Slice<T>& sl, F&& f) {
  const int64_t res = sl.R / 4, all = sl.S / 4, words = all - res;
  const uint4* key0 = reinterpret_cast<const uint4*>(sl.keys);
  const uint4* key1 = Mode == kAngle ? key0 : key0 + words;
  for (int64_t g0 = res; g0 < all; g0 += kCThreads) {
    const int64_t g = g0 + threadIdx.x, q = 4 * g;
    bool ok[4];
    for (int j = 0; j < 4; ++j) ok[j] = g < all && q + j < sl.n_loc;
    uint4 a = make_uint4(0u, 0u, 0u, 0u), b = a;
    if (g < all) {
      a = key0[g - res];
      b = Mode == kAngle ? a : key1[g - res];
    }
    const uint32_t k0[4] = {a.x, a.y, a.z, a.w}, k1[4] = {b.x, b.y, b.z, b.w};
    f(ok, k0, k1, q);
  }
}

// The beta-masked (or, with all, every) pixel's moments of the row: block
// sums in a fixed order into part[buf], then the cluster's in rank order
// into sums, the same bits in every block.
template <typename T>
__device__ void cluster_moments(const Slice<T>& sl, bool all, int buf, ClusterShared& sh,
                                cg::cluster_group& cluster) {
  double acc[kSums];
  for (int k = 0; k < kSums; ++k) acc[k] = 0.0;
  csweep<T>(sl, sh.lut, [&](const bool (&ok)[4], const float (&od)[3][4], int64_t) {
    for (int j = 0; j < 4; ++j) {
      if (ok[j] && (all || min3(od[0][j], od[1][j], od[2][j]) >= kBeta)) {
        add_moments(acc, od[0][j], od[1][j], od[2][j]);
      }
    }
  });
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int k = 0; k < kSums; ++k) {
    for (int off = 16; off > 0; off >>= 1) acc[k] += __shfl_down_sync(kFull, acc[k], off);
  }
  if (lane == 0) {
    for (int k = 0; k < kSums; ++k) sh.warp_part[warp][k] = acc[k];
  }
  __syncthreads();
  if (warp == 0) {
    for (int k = 0; k < kSums; ++k) {
      double v = lane < kCWarps ? sh.warp_part[lane][k] : 0.0;
      for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(kFull, v, off);
      if (lane == 0) sh.part[buf][k] = v;
    }
  }
  cluster.sync();
  if (threadIdx.x < kSums) {
    double s = 0.0;
    for (unsigned r = 0; r < cluster.num_blocks(); ++r) {
      s += cluster.map_shared_rank(sh.part[buf], r)[threadIdx.x];
    }
    sh.sums[threadIdx.x] = s;
  }
  __syncthreads();
}

// Stores key k of selection s in the block's candidate buffer. Few pixels
// take this path (the buffer holds at most kCand keys), so a shared atomic
// a key costs less than gathering a warp's keys for every pixel.
__device__ __forceinline__ void cand_push(ClusterShared& sh, int s, uint32_t k) {
  const unsigned i = (s ? sh.cand_split : 0) + atomicAdd(&sh.cand_count[s], 1u);
  if (i < kCand) sh.cand[i] = k;
}

// Pass d's digits of every pixel of the block's slice; with Collect, the
// keys that match their selection's prefix are also stored as candidates.
// The angle selections' pass 0 counts two digits: histogram 0 the top digit
// of every key (both selections start alike), histogram 1 the second digit
// of the keys whose top byte is `guess` (cluster_select2).
// With a key field (float32), pass 0 computes the keys of the pixels past
// the resident ones from the input and writes them, and passes 1-3 read
// them: their logarithms are taken in one pass of the selection, not four.
template <typename T, int Mode, bool Collect>
__device__ __forceinline__ void count_pixels(const Slice<T>& sl, const float* w, bool use_all,
                                             ClusterShared& sh, int d, uint32_t guess) {
  const int shift = 24 - 8 * d;
  const bool two_digit = Mode == kAngle && d == 0;
  const int d1 = two_digit ? 1 : d;
  const uint32_t pre0 = sh.st.prefix[0], pre1 = two_digit ? guess << 24 : sh.st.prefix[1];
  const bool live0 = !sh.st.empty[0], live1 = !sh.st.empty[1];
  auto tally = [&](bool ok, uint32_t k0, uint32_t k1) {
    const unsigned b0 = digit(ok, k0, pre0, d, shift);
    const unsigned b1 = digit(ok, k1, pre1, d1, 24 - 8 * d1);
    rep_add<kClusterCopies>(sh.rep, 0, b0);
    rep_add<kClusterCopies>(sh.rep, 1, b1);
    if constexpr (Collect) {
      if (live0 && b0 < kBins) cand_push(sh, 0, k0);
      if (live1 && b1 < kBins) cand_push(sh, 1, k1);
    }
  };
  auto from_od = [&](const bool (&ok)[4], const float (&od)[3][4], int64_t) {
    for (int j = 0; j < 4; ++j) {
      uint32_t k0, k1;
      keys2<Mode>(od[0][j], od[1][j], od[2][j], w, use_all, k0, k1);
      tally(ok[j], k0, k1);
    }
  };
  if constexpr (kOdOnce<T>) {
    if (sl.keys != nullptr) {  // block-uniform
      csweep<T, kResident>(sl, sh.lut, from_od);
      if (d == 0) {
        const int64_t words = (sl.S - sl.R) / 4;
        csweep<T, kRest>(sl, sh.lut, [&](const bool (&ok)[4], const float (&od)[3][4], int64_t q) {
          uint32_t k0[4], k1[4];
          for (int j = 0; j < 4; ++j) {
            keys2<Mode>(od[0][j], od[1][j], od[2][j], w, use_all, k0[j], k1[j]);
            tally(ok[j], k0[j], k1[j]);
          }
          if (q < sl.S) store_keys<Mode>(sl.keys, words, (q - sl.R) / 4, k0, k1);
        });
      } else {
        ksweep<T, Mode>(sl, [&](const bool (&ok)[4], const uint32_t (&k0)[4],
                                const uint32_t (&k1)[4], int64_t) {
          for (int j = 0; j < 4; ++j) tally(ok[j], k0[j], k1[j]);
        });
      }
      return;
    }
  }
  csweep<T>(sl, sh.lut, from_od);
}

// Whether selection s has no element or took the guessed top byte.
__device__ __forceinline__ bool on_guess(const Sel2& st, int s, uint32_t guess) {
  return st.empty[s] || (st.prefix[s] >> 24) == guess;
}

// The row's two selections (angles or concentrations; w: v_mid and v_max,
// or the normal rows), 4 passes of 8 key bits over the block's slice.
// Starts from sh.st (and, for angles, the members' sums in sh.sums) and
// leaves the selected keys there. Once the block's
// keys that match the prefixes fit kCand (its own histogram of the last pass
// counts them exactly), the next pass stores them as it counts, and the
// passes after it count only the stored keys. Angles and concentrations
// fill a few bins of their leading digit, so on H&E tiles pass 2 collects
// and pass 3 reads only the stored keys.
// The angle selections' pass 0 decides nothing on H&E rows (every member
// angle has one top byte), so it also counts the second digit of the keys
// under the top byte of the members' mean direction (mean_angle_byte). Where
// both selections take that byte (or have no element), that histogram is
// the one pass 1 would count for each: they descend on it, pass 1 is
// skipped and RowParams::two_digit is set. Else pass 1 runs. The selected
// keys are the same either way.
template <typename T, int Mode>
__device__ void cluster_select2(const Slice<T>& sl, const float* w, bool use_all,
                                ClusterShared& sh, cg::cluster_group& cluster) {
  const int warp = threadIdx.x >> 5;
  const uint32_t guess = Mode == kAngle ? mean_angle_byte(sh.sums, w) : 0u;  // cluster-uniform
  if (threadIdx.x == 0) sh.cand_state = kSweep;
  __syncthreads();
  // buf alternates with the passes made, so one cluster.sync a pass is enough.
  for (int d = 0, buf = 0; d < 4; ++d, buf ^= 1) {
    const bool first = Mode == kAngle && d == 0;  // counts two digits
    const int state = sh.cand_state;  // block-uniform
    if (state == kFromBuffer) {
      const int shift = 24 - 8 * d;
      const uint32_t pre0 = sh.st.prefix[0], pre1 = sh.st.prefix[1];
      const int split = sh.cand_split;  // selection 0 stored exactly split keys
      const int n = split + static_cast<int>(sh.cand_count[1]);
      for (int i = threadIdx.x; i < n; i += kCThreads) {
        const int s = i >= split;
        rep_add<kClusterCopies>(sh.rep, s, digit(true, sh.cand[i], s ? pre1 : pre0, d, shift));
      }
    } else if (state == kCollect) {
      count_pixels<T, Mode, true>(sl, w, use_all, sh, d, guess);
    } else {
      count_pixels<T, Mode, false>(sl, w, use_all, sh, d, guess);
    }
    __syncthreads();
    for (int i = threadIdx.x; i < 2 * kBins; i += kCThreads) {
      sh.hist[buf][i / kBins][i % kBins] = rep_take<kClusterCopies>(sh.rep, i);
    }
    cluster.sync();
    for (int i = threadIdx.x; i < 2 * kBins; i += kCThreads) {
      const int s = i / kBins, b = i % kBins;
      unsigned* mine = &sh.hist[buf][s][b];
      unsigned c = 0u;
#pragma unroll 4  // the remote loads in flight together
      for (unsigned r = 0; r < cluster.num_blocks(); ++r) c += *cluster.map_shared_rank(mine, r);
      sh.merged[s][b] = c;
    }
    __syncthreads();
    if (first) {  // both descend on the top digits, then on the guess's second digits
      if (warp < 2) descend(sh.merged[0], sh.st, warp, 0);
      __syncthreads();
      const bool hit = on_guess(sh.st, 0, guess) && on_guess(sh.st, 1, guess);  // cluster-uniform
      __syncthreads();  // every thread has read the prefixes the next descent extends
      if (hit) {
        if (warp < 2) descend(sh.merged[1], sh.st, warp, 1);
        d = 1;  // pass 1 is done
      }
      if (threadIdx.x == 0) sh.row.two_digit = hit ? 1.0f : 0.0f;
    } else if (warp < 2) {
      descend(sh.merged[warp], sh.st, warp, d);
    }
    __syncthreads();
    if (threadIdx.x == 0 && d < 3) {
      if (state != kSweep) {
        sh.cand_state = kFromBuffer;  // the stored keys hold every later candidate
      } else if (d < 2) {  // a pass must follow the one that collects
        // This block's keys that match each new prefix: its own count of the
        // chosen bin (none for a selection already known to be empty); after
        // the angles' pass 0, both counts are in the histogram of the digit
        // they took last.
        const int shift = 24 - 8 * d;
        unsigned c[2];
        for (int s = 0; s < 2; ++s) {
          const unsigned bin = (sh.st.prefix[s] >> shift) & 0xFFu;
          c[s] = sh.st.empty[s] ? 0u : sh.hist[buf][first ? d : s][bin];
        }
        if (c[0] + c[1] <= static_cast<unsigned>(kCand)) {
          sh.cand_state = kCollect;
          sh.cand_count[0] = sh.cand_count[1] = 0u;
          sh.cand_split = static_cast<int>(c[0]);
        }
      }
    }
    __syncthreads();
  }
  cluster.sync();  // no block reuses or leaves a histogram another still reads
}

// One cluster per row: the whole fit (out == nullptr) or transform of the
// row blockIdx.x / cluster size, its statistics into prm[row]. Block r of
// the cluster takes pixels [r*S, (r+1)*S) of the row, the first R of them
// resident. keys: for float32 rows with R < S, 2 * (S - R) uint32 a block
// (block b's from keys + b * 2 * (S - R)), else null. out_scale multiplies
// each float32 output value (store_rgb). Fused (a transform, one image a
// row, launched cooperatively): row ref_row's fit, without the fallback,
// also goes to fit_prm, and every row reconstructs on it in place of stain
// and tmc (which are then null). Without Fused, ref_row and fit_prm are
// not read.
template <typename T, bool Fused>
__global__ void __launch_bounds__(kCThreads, 1)
cluster_kernel(const T* __restrict__ x, T* __restrict__ out, int64_t p, int ipr, int64_t S,
               int64_t R, int vec, int fallback, long long idx99, const float* __restrict__ stain,
               const float* __restrict__ tmc, RowParams* __restrict__ prm,
               uint32_t* __restrict__ keys, float out_scale, int64_t ref_row,
               RowParams* fit_prm) {
  extern __shared__ __align__(16) unsigned char smem[];
  ClusterShared& sh = *reinterpret_cast<ClusterShared*>(smem);
  T* planes = reinterpret_cast<T*>(smem + kClusterFixed);
  cg::cluster_group cluster = cg::this_cluster();
  const int64_t rank = cluster.block_rank();
  const int64_t row = blockIdx.x / cluster.num_blocks();
  const int64_t len = static_cast<int64_t>(ipr) * p, begin = rank * S;
  const int64_t n_loc = begin < len ? (len - begin < S ? len - begin : S) : 0;
  uint32_t* block_keys = nullptr;
  if constexpr (kOdOnce<T>) {
    if (keys != nullptr) block_keys = keys + static_cast<int64_t>(blockIdx.x) * 2 * (S - R);
  }
  const Slice<T> sl{x + row * ipr * 3 * p, planes, p, begin, n_loc, S, R, ipr, vec != 0,
                    block_keys};
  build_lut<T>(sh.lut);
  for (int i = threadIdx.x; i < kClusterCopies * kCopyStride; i += kCThreads) sh.rep[i] = 0u;
  load_slice<T>(sl, planes);
  __syncthreads();

  cluster_moments<T>(sl, false, 0, sh, cluster);
  const bool use_all = fallback && sh.sums[0] < 3.0;  // the same in every block
  if constexpr (Fused) {
    if (use_all && row == ref_row) {  // the same in every block of the cluster
      // The fit takes no fallback: its statistics from the beta-masked sums.
      float v[6];
      if (threadIdx.x == 0) row_scalars(sh.sums, false, sh.row, sh.st);
      __syncthreads();
      for (int k = 0; k < 6; ++k) v[k] = sh.row.evs[k];
      cluster_select2<T, kAngle>(sl, v, false, sh, cluster);
      if (threadIdx.x == 0) {
        row_stains(sh.st, sh.row);
        sel_reset(sh.st, idx99, idx99);
      }
      __syncthreads();
      for (int k = 0; k < 3; ++k) {
        v[k] = sh.row.m0[k];
        v[3 + k] = sh.row.m1[k];
      }
      cluster_select2<T, kConc>(sl, v, false, sh, cluster);
      if (threadIdx.x == 0) {
        sh.row.maxc[0] = sel_value(sh.st, 0);
        sh.row.maxc[1] = sel_value(sh.st, 1);
        if (rank == 0) *fit_prm = sh.row;
      }
      __syncthreads();
    }
  }
  if (use_all) cluster_moments<T>(sl, true, 1, sh, cluster);
  if (threadIdx.x == 0) row_scalars(sh.sums, use_all, sh.row, sh.st);
  __syncthreads();

  float w[6];
  for (int k = 0; k < 6; ++k) w[k] = sh.row.evs[k];
  cluster_select2<T, kAngle>(sl, w, use_all, sh, cluster);
  if (threadIdx.x == 0) {
    row_stains(sh.st, sh.row);
    sel_reset(sh.st, idx99, idx99);
  }
  __syncthreads();
  for (int k = 0; k < 3; ++k) {
    w[k] = sh.row.m0[k];
    w[3 + k] = sh.row.m1[k];
  }
  cluster_select2<T, kConc>(sl, w, use_all, sh, cluster);
  if (threadIdx.x == 0) {
    sh.row.maxc[0] = sel_value(sh.st, 0);
    sh.row.maxc[1] = sel_value(sh.st, 1);
    if (rank == 0) prm[row] = sh.row;
    if constexpr (Fused) {
      if (rank == 0 && row == ref_row && !use_all) *fit_prm = sh.row;
    }
  }
  if constexpr (!Fused) {
    if (out == nullptr) return;
  }

  __syncthreads();
  float st[6], tm[2];
  if constexpr (Fused) {
    cg::this_grid().sync();  // fit_prm is written
    // Written in this launch by another block: read through L2, not the
    // read-only path.
    for (int k = 0; k < 6; ++k) st[k] = __ldcg(fit_prm->he + k);
    for (int k = 0; k < 2; ++k) tm[k] = __ldcg(fit_prm->maxc + k);
  } else {
    for (int k = 0; k < 6; ++k) st[k] = stain[k];
    for (int k = 0; k < 2; ++k) tm[k] = tmc[k];
  }
  const float sc0 = maxc_scale(tm[0], sh.row.maxc[0]);
  const float sc1 = maxc_scale(tm[1], sh.row.maxc[1]);
  T* dst = out + row * 3 * p;  // one image a row
  auto put = [&](const bool (&ok)[4], const float (&rgb)[3][4], int64_t q) {
    if (vec) {  // a group is all in or all out
      if (ok[0]) store_rgb<T, 4>(dst, p, (begin + q) / 4, rgb, out_scale);
    } else {
      for (int j = 0; j < 4; ++j) {
        if (!ok[j]) continue;
        for (int c = 0; c < 3; ++c) {
          dst[c * p + begin + q + j] = to_store(rgb[c][j], T(), out_scale);
        }
      }
    }
  };
  auto from_od = [&](const bool (&ok)[4], const float (&od)[3][4], int64_t q) {
    float rgb[3][4];
    for (int j = 0; j < 4; ++j) {
      const float cn0 = (od[0][j] * w[0] + od[1][j] * w[1] + od[2][j] * w[2]) * sc0;
      const float cn1 = (od[0][j] * w[3] + od[1][j] * w[4] + od[2][j] * w[5]) * sc1;
      for (int c = 0; c < 3; ++c) rgb[c][j] = reconstruct(st, c, cn0, cn1);
    }
    put(ok, rgb, q);
  };
  if constexpr (kOdOnce<T>) {
    if (sl.keys != nullptr) {
      // Past the resident pixels the concentrations are the keys' values:
      // unkey of a concentration key is the concentration, bit for bit.
      csweep<T, kResident>(sl, sh.lut, from_od);
      ksweep<T, kConc>(sl, [&](const bool (&ok)[4], const uint32_t (&k0)[4],
                               const uint32_t (&k1)[4], int64_t q) {
        float rgb[3][4];
        for (int j = 0; j < 4; ++j) {
          const float cn0 = unkey(k0[j]) * sc0, cn1 = unkey(k1[j]) * sc1;
          for (int c = 0; c < 3; ++c) rgb[c][j] = reconstruct(st, c, cn0, cn1);
        }
        put(ok, rgb, q);
      });
      return;
    }
  }
  csweep<T>(sl, sh.lut, from_od);
}

template <typename T>
using ClusterKernel = void (*)(const T*, T*, int64_t, int, int64_t, int64_t, int, int, long long,
                               const float*, const float*, RowParams*, uint32_t*, float, int64_t,
                               RowParams*);

// Sets the cluster kernel's shared memory for R resident pixels a block and
// allows clusters of 16 (past the portable 8), and fills cfg for `rows`
// clusters of csize blocks; Fused: a cooperative launch.
template <typename T, bool Fused>
cudaError_t cluster_config(long long rows, int csize, long long R, cudaStream_t s,
                           cudaLaunchConfig_t& cfg, cudaLaunchAttribute (&attrs)[2]) {
  const size_t smem = kClusterFixed + 3 * static_cast<size_t>(R) * sizeof(T);
  const ClusterKernel<T> kernel = cluster_kernel<T, Fused>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e == cudaSuccess) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(rows * csize));
  cfg.blockDim = dim3(kCThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = static_cast<unsigned>(csize);
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  attrs[1].id = cudaLaunchAttributeCooperative;
  attrs[1].val.cooperative = 1;
  cfg.attrs = attrs;
  cfg.numAttrs = Fused ? 2 : 1;
  return e;
}

template <typename T, bool Fused>
cudaError_t launch_cluster(const void* x, void* out, long long rows, long long p, int ipr,
                           int csize, long long S, long long R, int vec, int fallback,
                           long long idx99, const float* stain, const float* tmc, float out_scale,
                           RowParams* prm, uint32_t* keys, long long ref_row, RowParams* fit_prm,
                           cudaStream_t s, cudaEvent_t start) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attrs[2];
  cudaError_t e = cluster_config<T, Fused>(rows, csize, R, s, cfg, attrs);
  if (e == cudaSuccess && start != nullptr) e = cudaEventRecord(start, s);
  if (e != cudaSuccess) return e;
  return cudaLaunchKernelEx(&cfg, ClusterKernel<T>(cluster_kernel<T, Fused>),
                            static_cast<const T*>(x), static_cast<T*>(out),
                            static_cast<int64_t>(p), ipr, static_cast<int64_t>(S),
                            static_cast<int64_t>(R), vec, fallback, idx99, stain, tmc, prm, keys,
                            out_scale, static_cast<int64_t>(ref_row), fit_prm);
}

template <typename T>
cudaError_t cluster_occupancy(int csize, long long R, int* clusters) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attrs[2];
  const cudaError_t e = cluster_config<T, false>(1, csize, R, nullptr, cfg, attrs);
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveClusters(
      clusters, reinterpret_cast<const void*>(ClusterKernel<T>(cluster_kernel<T, false>)), &cfg);
}

// ------------------------------------------------------- streamed launches
// Calls launch(grid, y0) for each launch of bx blocks an item over `items`
// items, at most kMaxGridY a launch, in order.
template <typename F>
void over_items(long long items, int bx, F&& launch) {
  for (long long y0 = 0; y0 < items; y0 += kMaxGridY) {
    const long long count = items - y0 < kMaxGridY ? items - y0 : kMaxGridY;
    launch(dim3(static_cast<unsigned>(bx), static_cast<unsigned>(count)),
           static_cast<unsigned>(y0));
  }
}

template <typename T, int V>
void launch_stream(const void* xv, void* outv, long long n, long long p, int ipr, int bx,
                   int bx_keys, int fallback, long long idx99, const float* stain,
                   const float* tmc, float out_scale, RowParams* prm, Sel2* sel, unsigned* hist,
                   double* partials, uint32_t* keys, cudaStream_t s) {
  const auto* x = static_cast<const T*>(xv);
  const int64_t rows = n / ipr, len = static_cast<int64_t>(ipr) * p;
  unsigned* tickets = hist + rows * 2 * kBins;
  cudaMemsetAsync(hist, 0, static_cast<size_t>(rows) * (2 * kBins + 1) * sizeof(unsigned), s);
  over_items(n, bx, [&](dim3 g, unsigned y0) {
    stream_moments<T, V><<<g, kThreads, 0, s>>>(x, p, ipr, y0, fallback, partials, prm, sel,
                                                tickets);
  });
  // Pass d of a selection from the raw input (Write: also store the keys),
  // or, for float32 passes 1-3, from the key field.
  auto count = [&](auto mode, auto write, int d) {
    constexpr int Mode = decltype(mode)::value;
    constexpr bool Write = decltype(write)::value;
    over_items(n, bx, [&](dim3 g, unsigned y0) {
      stream_count<T, V, Mode, Write><<<g, kThreads, 0, s>>>(x, p, ipr, y0, d, idx99, prm, sel,
                                                             hist, tickets, keys);
    });
  };
  auto count_keys = [&](auto mode, int d) {
    constexpr int Mode = decltype(mode)::value;
    over_items(rows, bx_keys, [&](dim3 g, unsigned y0) {
      stream_count_keys<V, Mode><<<g, kThreads, 0, s>>>(keys, len, y0, d, idx99, prm, sel, hist,
                                                        tickets);
    });
  };
  using Angle = std::integral_constant<int, kAngle>;
  using Conc = std::integral_constant<int, kConc>;
  using Yes = std::true_type;
  using No = std::false_type;
  if (keys == nullptr) {  // uint8: every pass from the raw bytes
    for (int d = 0; d < 4; ++d) count(Angle(), No(), d);
    for (int d = 0; d < 4; ++d) count(Conc(), No(), d);
  } else {  // float32: pass 0 writes the key field, passes 1-3 read it
    count(Angle(), Yes(), 0);
    for (int d = 1; d < 4; ++d) count_keys(Angle(), d);
    count(Conc(), Yes(), 0);
    for (int d = 1; d < 4; ++d) count_keys(Conc(), d);
  }
  if (outv != nullptr) {
    over_items(n, bx, [&](dim3 g, unsigned y0) {
      stream_reconstruct<T, V><<<g, kThreads, 0, s>>>(x, static_cast<T*>(outv), p, y0, prm,
                                                      stain, tmc, out_scale);
    });
  }
}

template <typename T, int V>
void launch_fields(const void* x, long long n, long long p, int ipr, int bx, const RowParams* prm,
                   float* angles, float* conc, cudaStream_t s) {
  over_items(n, bx, [&](dim3 g, unsigned y0) {
    stream_fields<T, V><<<g, kThreads, 0, s>>>(static_cast<const T*>(x), p, ipr, y0, prm, angles,
                                               conc);
  });
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
// x: (n, 3, p) contiguous uint8 or float32 on the current device, in rows
// of ipr images (1 at transform; n at fit, the pool); out: the transform's
// (n, 3, p) output, or null for a fit; stain (3, 2) and tmc (2,) float32
// (ignored at fit); out_scale: each float32 output value is the clipped
// reconstruction times out_scale (1 for [0, 255]; uint8 output takes none,
// pass 1); prm: (rows, 32) float32 RowParams. fallback is 1 at
// transform (the <3-pixel fallback), idx99 the 99th-percentile rank of a
// row. Each function returns the launch's CUDA error (cudaGetLastError()).
extern "C" {

const char* stainx_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The cluster route: one cluster of csize blocks a row, slice S pixels a
// block (a multiple of 16; csize * S >= ipr * p), the first R (a multiple
// of 16, at most S) resident in shared memory. vec: p a multiple of 16 /
// sizeof(T) and x, out 16-byte aligned. keys: for float32 with R < S, a
// 16-byte aligned key field of rows * csize * 2 * (S - R) uint32, else null.
// launch_start and launch_end, where not null, are CUDA events of the
// stream's device, made with timing: recorded just before the launch (after
// its attributes are set) and just after it. The launch and the outputs are
// the same with or without.
int stainx_cluster_run(const void* x, void* out, long long n, long long p, int ipr, int is_uint8,
                       int vec, int csize, long long S, long long R, int fallback, long long idx99,
                       const void* stain, const void* tmc, float out_scale, void* prm,
                       void* keys, void* stream, void* launch_start, void* launch_end) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* st = static_cast<const float*>(stain);
  const auto* tm = static_cast<const float*>(tmc);
  auto* rp = static_cast<RowParams*>(prm);
  auto* kf = static_cast<uint32_t*>(keys);
  const auto start = static_cast<cudaEvent_t>(launch_start);
  const long long rows = n / ipr;
  cudaError_t e =
      is_uint8 ? launch_cluster<uint8_t, false>(x, out, rows, p, ipr, csize, S, R, vec, fallback,
                                                idx99, st, tm, out_scale, rp, nullptr, 0, nullptr,
                                                s, start)
               : launch_cluster<float, false>(x, out, rows, p, ipr, csize, S, R, vec, fallback,
                                              idx99, st, tm, out_scale, rp, kf, 0, nullptr, s,
                                              start);
  if (e == cudaSuccess && launch_end != nullptr) {
    e = cudaEventRecord(static_cast<cudaEvent_t>(launch_end), s);
  }
  if (e != cudaSuccess) {
    cudaGetLastError();  // clear it: the wrapper raises
    return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}

// The cluster route's transform (one image a row, the <3-pixel fallback on)
// with batch mode's fit of image ref_row fused in: fit_prm (one 32-float
// RowParams) gets that image's fit, as stainx_cluster_run gives it with
// out null and fallback 0 on that image alone, up to the order of its
// float64 sums, and every image is reconstructed on its HE and maxC. One
// cooperative cluster launch: the card must hold every row's cluster at
// once (else cudaErrorCooperativeLaunchTooLarge). The other arguments as
// stainx_cluster_run's, launch_start and launch_end too.
int stainx_cluster_fit_transform(const void* x, void* out, long long n, long long p, int is_uint8,
                                 int vec, int csize, long long S, long long R, long long idx99,
                                 long long ref_row, float out_scale, void* prm, void* fit_prm,
                                 void* keys, void* stream, void* launch_start, void* launch_end) {
  const auto s = static_cast<cudaStream_t>(stream);
  auto* rp = static_cast<RowParams*>(prm);
  auto* fp = static_cast<RowParams*>(fit_prm);
  auto* kf = static_cast<uint32_t*>(keys);
  const auto start = static_cast<cudaEvent_t>(launch_start);
  cudaError_t e =
      is_uint8 ? launch_cluster<uint8_t, true>(x, out, n, p, 1, csize, S, R, vec, 1, idx99,
                                               nullptr, nullptr, out_scale, rp, nullptr, ref_row,
                                               fp, s, start)
               : launch_cluster<float, true>(x, out, n, p, 1, csize, S, R, vec, 1, idx99, nullptr,
                                             nullptr, out_scale, rp, kf, ref_row, fp, s, start);
  if (e == cudaSuccess && launch_end != nullptr) {
    e = cudaEventRecord(static_cast<cudaEvent_t>(launch_end), s);
  }
  if (e != cudaSuccess) {
    cudaGetLastError();  // clear it: the wrapper raises
    return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}

// Clusters of the cluster route that the card holds at once for that shape
// (R resident pixels a block).
int stainx_cluster_occupancy(int is_uint8, int csize, long long R, void* clusters) {
  auto* c = static_cast<int*>(clusters);
  const cudaError_t e = is_uint8 ? cluster_occupancy<uint8_t>(csize, R, c)
                                 : cluster_occupancy<float>(csize, R, c);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

// The streamed route: bx blocks an image, in launches of at most 65 535
// images (any number of images); vec is 4 when p % 4 == 0 and x,
// out are 16-byte aligned, else 1. sel: (rows,) 32-byte selection states;
// hist: (rows, 2, 256) uint32 followed by rows uint32 tickets (zeroed here);
// partials: (n * bx, 20) float64; keys: null for uint8, for float32 a
// (2 * rows, ipr * p) uint32 key field read by bx_keys blocks a row.
int stainx_stream_run(const void* x, void* out, long long n, long long p, int ipr, int is_uint8,
                      int vec, int bx, int bx_keys, int fallback, long long idx99,
                      const void* stain, const void* tmc, float out_scale, void* prm, void* sel,
                      void* hist, void* partials, void* keys, void* stream) {
  STAINX_DISPATCH(launch_stream, x, out, n, p, ipr, bx, bx_keys, fallback, idx99,
                  static_cast<const float*>(stain), static_cast<const float*>(tmc), out_scale,
                  static_cast<RowParams*>(prm), static_cast<Sel2*>(sel),
                  static_cast<unsigned*>(hist), static_cast<double*>(partials),
                  static_cast<uint32_t*>(keys), static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

// Check-only: a call's keys from its RowParams. angles: (rows, ipr*p) and
// conc: (2*rows, ipr*p) float32.
int stainx_stream_fields(const void* x, long long n, long long p, int ipr, int is_uint8, int vec,
                         int bx, const void* prm, void* angles, void* conc, void* stream) {
  STAINX_DISPATCH(launch_fields, x, n, p, ipr, bx, static_cast<const RowParams*>(prm),
                  static_cast<float*>(angles), static_cast<float*>(conc),
                  static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
