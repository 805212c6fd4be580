"""Macenko stain normalization on tensors: fit and transform.

Counterpart of ``stainx_tpu/ops/macenko.py`` (constants Io=240, β=0.15,
α=1), routed as that module routes on the JAX package's ``pallas`` backend:

- uint8 and float32 go by size to the kernel wrappers of
  :mod:`stainx_tpu_torch.kernels.macenko_fused` (B1, B2: one thread block
  per image or pool) or :mod:`stainx_tpu_torch.kernels.macenko_stream` (B4,
  B5: a thread-block cluster a row, or a row spread over the card). These
  kernels are exact, so ``precision`` has nothing to trade there.
- Every other dtype (bfloat16, float16, float64), which those kernels do
  not take, runs the staged pipeline: OD, the β-mask (with the <3-pixel
  fallback at transform only), the two-pass masked covariance,
  ``eigh3_top2``, the stain-plane projection, ``atan2``, the α and 100−α
  angle percentiles, H/E from the extremes, the 2×2 concentrations, their
  99th percentiles, the reconstruction in ``recon_dtype`` (bfloat16 under
  ``precision="fast"``) and the cast back to the input dtype. Its steps
  are plain PyTorch, as the JAX package leaves them to XLA; its selections
  go to B3 (one thread-block cluster a row) or, for few long rows, to B6
  (which finds the rows' extremes and count itself), as
  :func:`~stainx_tpu_torch.ops.percentile.select_route` chooses. Both
  selections are exact, so the route never changes an output.

Batch mode's fit of one image and transform of the batch
(:func:`macenko_fit_transform`) is one launch where :func:`fuses_fit` finds
B4's cluster route with every row resident at once, the fit fused into the
transform's kernel; elsewhere it is :func:`macenko_fit` then
:func:`macenko_transform`.

A CUDA tensor launches the hand-written kernels, a CPU tensor runs their
plain PyTorch versions. Each staged fit or transform is counted in
``route.staged`` (:mod:`stainx_tpu_torch.profiling`).

The method's constants and formulas live in
:mod:`stainx_tpu_torch.kernels.macenko_fused`, the B3/B6 choice in
:mod:`stainx_tpu_torch.ops.percentile`; their names are imported here too
(patch a threshold in its own module).

``seed_state`` is the (7,) int32 cross-call state of the JAX kernels. The
CUDA kernels run the images of a batch in parallel and need no probe seeds,
so the state is passed through unchanged, as the JAX non-kernel routes do
(``stainx_tpu/ops/macenko.py:345-353,514-515``).
"""

from __future__ import annotations

import torch

from stainx_tpu_torch import kernels, profiling
from stainx_tpu_torch.kernels import macenko_fused, macenko_stream
from stainx_tpu_torch.kernels.macenko_fused import (  # noqa: F401 (IO, maxc_scale: names kept here)
    ALPHA,
    BETA,
    IO,
    maxc_scale,
    optical_density,
    rescale_and_reconstruct,
)
from stainx_tpu_torch.ops import color
from stainx_tpu_torch.ops.eigh3 import eigh3_top2
from stainx_tpu_torch.ops.percentile import (  # noqa: F401 (the B3/B6 threshold: names kept here)
    SELECT_STREAM_MAX_ROWS,
    SELECT_STREAM_MIN_ELEMS,
    _select,
    nearest_rank_index,
    select_route,
    static_nearest_rank_index,
)

_KERNEL_DTYPES = (torch.uint8, torch.float32)

# The H100's size ladder, from the three-round sweep of B1 against B4 and
# B2 against B5 in chip_smoke.py phase 5 (H100 80GB HBM3, 700 W). A
# multi-block kernel takes a size only where it was faster as called in
# every round; each bound is the last size measured on the winning side. B4
# and B5 make one C call (one cluster launch for rows that fit a cluster),
# so their host cost needs no margin of its own. The figures are the last
# sweep's, after B1 and B2 took their resident bodies for images and pools
# that fit a block's shared memory (B1: uint8 up to 19 222 pixels, float32
# up to 10 572, larger images keep a body that re-reads L2; B2: 19 106 and
# 10 508).
# Transform (B4): uint8 rows of at least 50 176 pixels (224²) in batches of
# up to 512 rows. B4 won every cell from 224² up, 4 to 512 rows: 4x224² at
# 0.068-0.069 ms called against B1's 0.285-0.289, the WSI tiles' 256x224²
# at 0.414-0.445 against 0.593-0.609, 64x512² at 0.499-0.513 against
# 1.494-1.514, 512x224² at 0.808-0.815 against 1.155-1.161. B1 won every
# cell measured below (64², 96², 128² and 136², 4 to 256 rows; 256x64²
# 0.035-0.044 against 0.083-0.085, 64x128² 0.053-0.054 against
# 0.059-0.062). float32
# rows of at least 25 600 pixels (160²) in batches of up to 256 rows: B4
# won 4 to 256 rows of 160² (256x160² 0.518-0.530 against 0.562) and path
# (a)'s 256x224² (0.939-0.943 against 1.103-1.106); B1 won 96² and 102² at
# 4 to 256 rows and 256x128² (0.345-0.346 against 0.405-0.406), though B4
# won 4 and 64 rows of 128² (0.073-0.075 against 0.171-0.173).
STREAM_MIN_ELEMS = 50_176
STREAM_MAX_ROWS = 512
STREAM_MIN_ELEMS_F32 = 25_600
STREAM_MAX_ROWS_F32 = 256
# Fit (fit_route): B2 takes every pool that fits one block's shared memory
# (kernels/macenko_fused.py::fit_resident_bytes; on the H100 up to 19 106
# uint8 pixels, 10 508 float32), B5 every larger one. In two sweeps B2 won
# every round at every pool it holds, from 1x64² (0.055-0.061 ms called
# against B5's 0.076-0.078) through 1x128² (0.044-0.046 against
# 0.063-0.065), 4x64², 8x48², 2x96² and 1x136²; float32 1x64² (0.058-0.075
# against 0.079-0.090), 1x80², 2x64², 1x96², 1x102² and the largest,
# 1x1x10 508 (0.058-0.064 against 0.077-0.081); at the largest uint8 pool,
# 1x1x19 106, the second sweep's rounds overlapped as called (0.056-0.068
# against 0.065-0.077; on the device 0.052 against 0.062), so B2 keeps it.
# Past it B5 beat a B2 body that re-read the pool from L2 in every round
# at every pool: 1x1x19 107 uint8 (0.077-0.092 against 0.117-0.118),
# 1x144² to 1x192², 224² and up; float32 1x1x10 509 (0.070-0.074 against
# 0.112-0.114), 1x128² and up. So B2 keeps no body for larger pools, and
# the card's shared memory alone sets the fit step.
# The CPU runs the plain version of either route; it takes the route of an
# H100, whose blocks opt in to 232 448 bytes (227 KiB) of shared memory.
CPU_ROUTE_SMEM = 232_448
# normalize_to_0_1's ÷255 as PyTorch runs ``x / 255.0`` on a float32 CUDA
# tensor: a product with the float32 reciprocal 1.0f / 255.0f. The
# transform kernels' store multiplies by it, so a folded ÷255 gives the
# bits of the division that follows an unscaled transform.
UNIT_SCALE = float(torch.tensor(1.0, dtype=torch.float32) / 255.0)


def transform_route(n: int, p: int, dtype: torch.dtype) -> str:
    """``"stream"`` (B4) or ``"mega"`` (B1) for N rows of P pixels of the
    kernel input ``dtype`` (uint8 or float32)."""
    if dtype == torch.uint8:
        floor, cap = STREAM_MIN_ELEMS, STREAM_MAX_ROWS
    else:
        floor, cap = STREAM_MIN_ELEMS_F32, STREAM_MAX_ROWS_F32
    return "stream" if p >= floor and n <= cap else "mega"


def fit_route(pixels: int, dtype: torch.dtype, smem_limit: int) -> str:
    """``"mega"`` (B2) for a pool of that many pixels of the kernel input
    ``dtype`` that fits one block's ``smem_limit`` bytes of shared memory,
    else ``"stream"`` (B5)."""
    return "mega" if macenko_fused.fit_resident_bytes(pixels, dtype) <= smem_limit else "stream"


# The distributed fit accumulates its OD moments about this fixed shift:
# the covariance does not depend on it, and centring removes the
# E[xxᵀ] − μμᵀ cancellation of raw float32 moments.
MOMENT_CENTER = 1.0


def masked_od_moments(od_c, weights: torch.Tensor):
    """Additive masked OD moments of each row from three (N, P) channel
    planes ``od_c`` and 0/1 float ``weights`` (N, P): ``(count (N,), sum
    (N, 3), outer-product sum (N, 3, 3))`` about :data:`MOMENT_CENTER`, in
    float32. They add across shards, so the distributed fit reduces them."""
    y = [od_c[i] - MOMENT_CENTER for i in range(3)]
    cnt = weights.sum(-1)
    s1 = torch.stack([(weights * y[i]).sum(-1) for i in range(3)], dim=-1)
    s2 = torch.stack(
        [torch.stack([(weights * y[i] * y[j]).sum(-1) for j in range(3)], dim=-1)
         for i in range(3)],
        dim=-2,
    )
    return cnt, s1, s2


def cov_from_moments(cnt: torch.Tensor, s1: torch.Tensor, s2: torch.Tensor) -> torch.Tensor:
    """Covariance (N, 3, 3) from :func:`masked_od_moments`' (reduced)
    moments: ``(s2 − cnt·μμᵀ) / max(cnt − 1, 1)``, zeros where cnt ≤ 1."""
    mu = s1 / torch.clamp(cnt, min=1.0)[:, None]
    cov = (s2 - cnt[:, None, None] * mu[:, :, None] * mu[:, None, :]) / torch.clamp(
        cnt - 1.0, min=1.0
    )[:, None, None]
    return torch.where((cnt > 1.0)[:, None, None], cov, 0.0)


# ------------------------------------------------------------ staged route
def _masked_cov_two_pass(od_c, weights: torch.Tensor, cnt: torch.Tensor) -> torch.Tensor:
    """Σ w·(x−μ)(x−μ)ᵀ / (cnt−1) over three (N, P) OD planes ``od_c`` with
    0/1 ``weights`` (N, P) and float counts (N,); zeros when cnt ≤ 1."""
    safe_cnt = torch.clamp(cnt, min=1.0)
    mu = [(weights * od_c[i]).sum(-1) / safe_cnt for i in range(3)]
    centered = [od_c[i] - mu[i][:, None] for i in range(3)]
    denom = torch.clamp(cnt - 1.0, min=1.0)
    rows = []
    for i in range(3):
        wc_i = weights * centered[i]
        rows.append(torch.stack([(wc_i * centered[j]).sum(-1) / denom for j in range(3)], dim=-1))
    cov = torch.stack(rows, dim=-2)  # (N, 3, 3)
    return torch.where((cnt > 1.0)[:, None, None], cov, 0.0)


def _project_plane(od_c, evecs: torch.Tensor, dtype: torch.dtype):
    """The two stain-plane projections Σ_c od_c·v_ck (N, P), evaluated in
    ``dtype`` and returned as float32."""
    out = []
    for k in range(2):
        acc = od_c[0].to(dtype) * evecs[:, 0, k].to(dtype)[:, None]
        for i in (1, 2):
            acc = acc + od_c[i].to(dtype) * evecs[:, i, k].to(dtype)[:, None]
        out.append(acc.to(torch.float32))
    return out[0], out[1]


def _he_from_phi_extremes(evecs: torch.Tensor, min_phi: torch.Tensor, max_phi: torch.Tensor):
    """The extreme stain vectors and H/E ordering: HE (N, 3, 2)."""
    def extreme(phi):
        return evecs[:, :, 0] * torch.cos(phi)[:, None] + evecs[:, :, 1] * torch.sin(phi)[:, None]

    v_min, v_max = extreme(min_phi), extreme(max_phi)
    swap = (v_min[:, 0] > v_max[:, 0])[:, None, None]
    return torch.where(swap, torch.stack([v_min, v_max], -1), torch.stack([v_max, v_min], -1))


def _concentrations_2x2(he: torch.Tensor, od_c):
    """Least-squares concentrations (C0, C1), each (N, P), from the 2×2
    normal equations of HE (N, 3, 2); 1/det is clamped to ±1e12 so
    (anti)parallel columns stay finite."""
    h0, h1 = he[:, :, 0], he[:, :, 1]
    a, b, c = (h0 * h0).sum(-1), (h0 * h1).sum(-1), (h1 * h1).sum(-1)
    inv_det = torch.clamp(1.0 / (a * c - b * b), -1e12, 1e12)
    rhs0 = h0[:, 0, None] * od_c[0] + h0[:, 1, None] * od_c[1] + h0[:, 2, None] * od_c[2]
    rhs1 = h1[:, 0, None] * od_c[0] + h1[:, 1, None] * od_c[1] + h1[:, 2, None] * od_c[2]
    c0 = (c * inv_det)[:, None] * rhs0 - (b * inv_det)[:, None] * rhs1
    c1 = (a * inv_det)[:, None] * rhs1 - (b * inv_det)[:, None] * rhs0
    return c0, c1


def _stain_separate(od_c, mask: torch.Tensor, cnt: torch.Tensor):
    """Masked covariance → stain plane → α and 100−α angle percentiles →
    ordered H/E (N, 3, 2). Returns (HE, evecs). The projection stays
    float32 under both precisions, as in the JAX package."""
    cov = _masked_cov_two_pass(od_c, mask.to(torch.float32), cnt.to(torch.float32))
    evecs = eigh3_top2(cov)
    t0, t1 = _project_plane(od_c, evecs, torch.float32)
    xs = torch.where(mask, torch.atan2(t1, t0), torch.inf)
    ranks = torch.stack(
        [nearest_rank_index(ALPHA, cnt), nearest_rank_index(100 - ALPHA, cnt)], dim=1
    )
    phi = _select(xs, ranks)
    return _he_from_phi_extremes(evecs, phi[:, 0], phi[:, 1]), evecs


def _max_concentrations(c0: torch.Tensor, c1: torch.Tensor) -> torch.Tensor:
    """The 99th percentile of each row of C0 then of C1, over all pixels:
    (2N,), the N rows of C0 first."""
    rows, p = c0.shape
    c_stack = torch.cat([c0, c1], dim=0)
    dev = c0.device
    idx99 = static_nearest_rank_index(99, p)
    ranks = torch.full((2 * rows, 1), idx99, dtype=torch.int32, device=dev)
    return _select(c_stack, ranks)[:, 0]


def _staged_transform(images, stain_matrix, target_max_conc, precision: str) -> torch.Tensor:
    profiling.count("route.staged")
    images_float = color.normalize_to_float(images)
    n, c, h, w = images_float.shape
    p = h * w
    od = optical_density(images_float).reshape(n, 3, p)
    od_c = (od[:, 0], od[:, 1], od[:, 2])
    # β-mask, and all pixels where fewer than 3 survive.
    mask = torch.minimum(torch.minimum(od_c[0], od_c[1]), od_c[2]) >= BETA
    cnt = mask.sum(-1)
    use_all = cnt < 3
    he, _ = _stain_separate(od_c, mask | use_all[:, None], torch.where(use_all, p, cnt))
    c0, c1 = _concentrations_2x2(he, od_c)
    max_c = _max_concentrations(c0, c1)
    recon_dtype = torch.bfloat16 if precision == "fast" else torch.float32
    rgb = rescale_and_reconstruct(
        c0, c1, max_c[:n], max_c[n:], target_max_conc, stain_matrix, recon_dtype
    ).reshape(n, c, h, w)
    return color.preserve_dtype(rgb, images.dtype, result_in_0_255_range=True)


def _staged_fit(images):
    profiling.count("route.staged")
    images_float = color.normalize_to_float(images)
    n, _, h, w = images_float.shape
    ptot = n * h * w
    od = optical_density(images_float)
    od_c = tuple(od[:, i].reshape(1, ptot) for i in range(3))  # pooled planes
    mask = torch.minimum(torch.minimum(od_c[0], od_c[1]), od_c[2]) >= BETA  # no fallback
    he, _ = _stain_separate(od_c, mask, mask.sum(-1))
    c0, c1 = _concentrations_2x2(he, od_c)
    return he[0], _max_concentrations(c0, c1)


# ------------------------------------------------------------ entry points
def macenko_transform(
    images: torch.Tensor,
    stain_matrix: torch.Tensor,
    target_max_conc: torch.Tensor,
    seed_state: torch.Tensor | None = None,
    precision: str = "stable",
    scale: float = 1.0,
):
    """Normalize an (N, 3, H, W) batch to the fitted stain matrix (3, 2) and
    max concentrations (2,). Output range [0, 255] in the input dtype; a
    float32 batch's values times ``scale``, multiplied in by the kernels'
    store (:data:`UNIT_SCALE` gives [0, 1]; other dtypes take only 1).
    ``precision="fast"`` reconstructs in bfloat16 on the staged route (every
    dtype but uint8 and float32). With ``seed_state`` the return is
    ``(out, seed_state)``."""
    if images.dtype in _KERNEL_DTYPES:
        x = images.contiguous()
        if transform_route(x.shape[0], x.shape[2] * x.shape[3], x.dtype) == "stream":
            kernel = macenko_stream.macenko_transform_stream
        else:
            kernel = macenko_fused.macenko_transform_mega
        out = kernel(x, stain_matrix, target_max_conc, scale=scale)
    else:
        if scale != 1.0:
            raise ValueError(f"scale applies to float32 output only, got {images.dtype}")
        out = _staged_transform(images, stain_matrix, target_max_conc, precision)
    return (out, seed_state) if seed_state is not None else out


def fuses_fit(images: torch.Tensor) -> bool:
    """Whether :func:`macenko_fit_transform` fuses the fit into the
    transform's launch: an (N, 3, H, W) uint8 or float32 batch on CUDA that
    the ladder gives B4 (:func:`transform_route`), on B4's cluster route
    with every row's cluster held by the card at once
    (:func:`~stainx_tpu_torch.kernels.macenko_stream.fused_shape`; the
    occupancy asked once a shape). Reads only the device, dtype and shape."""
    if not images.is_cuda or images.dtype not in _KERNEL_DTYPES or images.dim() != 4:
        return False
    n, c, h, w = images.shape
    if c != 3 or transform_route(n, h * w, images.dtype) != "stream":
        return False
    index = images.device.index
    active = macenko_stream.active_clusters(index, images.dtype)
    itemsize = 1 if images.dtype == torch.uint8 else 4
    return macenko_stream.fused_shape(n, h * w, itemsize, kernels.device_limits(index)[1],
                                      active) is not None


def macenko_fit_transform(images: torch.Tensor, idx: int, scale: float = 1.0,
                          precision: str = "stable"):
    """Batch mode's step: fit on image ``idx`` of an (N, 3, H, W) batch and
    transform the batch on that fit. Returns ``(out, stain_matrix (3, 2),
    max_concentrations (2,))``. Where :func:`fuses_fit` holds, one launch
    (:func:`~stainx_tpu_torch.kernels.macenko_stream.
    macenko_fit_transform_stream`: the same fit, its float64 sums in another
    order); else :func:`macenko_fit` then :func:`macenko_transform`
    (``scale`` and ``precision`` as there)."""
    idx = macenko_stream.check_fit_row(idx, images.shape[0])
    if fuses_fit(images):
        return macenko_stream.macenko_fit_transform_stream(images.contiguous(), idx, scale=scale)
    he, maxc = macenko_fit(images[idx:idx + 1])
    out = macenko_transform(images, he, maxc, precision=precision, scale=scale)
    return out, he, maxc


def macenko_fit(images: torch.Tensor, seed_state: torch.Tensor | None = None):
    """Fit the reference stain matrix (3, 2) and max concentrations (2,) on
    the pooled pixels of all N images: β-filter without the <3-pixel
    fallback, covariance and angle percentiles over the filtered pixels,
    concentration 99th percentiles over all pooled pixels. With
    ``seed_state`` the return is ``(he, maxc, seed_state)``."""
    if images.dtype in _KERNEL_DTYPES:
        x = images.contiguous()
        n, _, h, w = x.shape
        smem = kernels.device_limits(x.device.index)[1] if x.is_cuda else CPU_ROUTE_SMEM
        if fit_route(n * h * w, x.dtype, smem) == "stream":
            he, maxc = macenko_stream.macenko_fit_stream(x)
        else:
            he, maxc = macenko_fused.macenko_fit_mega(x)
    else:
        he, maxc = _staged_fit(images)
    return (he, maxc, seed_state) if seed_state is not None else (he, maxc)
