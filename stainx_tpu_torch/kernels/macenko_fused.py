"""The Macenko fit and transform kernels: wrappers, plain versions, counts.

Counterpart of ``stainx_tpu/kernels/macenko_fused.py``. Each wrapper takes
an (N, 3, H, W) uint8 or float32 tensor. On a CUDA tensor it launches its
hand-written kernel from ``csrc/macenko_fused.cu`` (built at first use) or
raises; on a CPU tensor it runs its plain PyTorch version. Each wrapper is
the span ``stainx.kernel.B1`` or ``stainx.kernel.B2`` and counts its
launches in ``launch.B1`` or ``launch.B2`` (:mod:`stainx_tpu_torch.profiling`).
In a profiler session B1's span holds the device interval of its launch
alone (events recorded inside its C call) and names its body (``route``)
and the blocks an SM holds (``blocks_per_sm``, asked of the card once a
shape); each B1 launch also counts in ``resident.B1`` or ``l2.B1``, by
body.

The plain versions repeat the kernels' arithmetic on batched tensors:

- OD from the raw values (uint8 through int32, float as ``I·255``);
  divisions by a constant here and in the eigh divide on every device, as
  the kernels do (:func:`~stainx_tpu_torch.ops.eigh3.div_rn`);
- the β-mask; at transform, all pixels when fewer than 3 survive;
- the 10 masked moments about OD−1, products in float32, summed in float64
  (the kernels sum in float64 in a fixed order: no float atomics);
- covariance from the moments and the closed-form eigh of
  :mod:`stainx_tpu_torch.ops.eigh3` (``acos``/``cos``);
- the diamond pseudo-angle of the stain-plane projection, its α and 100−α
  nearest-rank selections, and the inverse map to (cos, sin);
- H/E ordering, the 2×2 normal rows with the ±1e12 inverse clamp;
- the 99th-percentile concentrations over all pixels and, at transform,
  the sign-preserving maxC scale and ``clip(240·exp(−HE·C), 0, 255)``,
  truncated for uint8.

Selections are exact: the element at the nearest rank of the monotone
integer keys, always an actual element of the data.

The method's constants and the formulas the staged route and
:mod:`stainx_tpu_torch.parallel` share with the plain versions live here.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from stainx_tpu_torch import kernels, profiling
from stainx_tpu_torch.kernels.selection_stream import kth_smallest_streaming_plain
from stainx_tpu_torch.ops.eigh3 import div_rn, eigh3_top2
from stainx_tpu_torch.ops.percentile import (
    kth_smallest,
    nearest_rank_index,
    static_nearest_rank_index,
)

IO = 240.0
BETA = 0.15
ALPHA = 1  # integer percent: percentile ranks are computed exactly

SEED_STATE_LEN = 7  # 4 terminal keys + 2 miss streaks + valid flag (JAX layout)


def seed_state_init(device: str | torch.device = "cpu") -> torch.Tensor:
    """Fresh cross-call state, the (7,) int32 zeros of the JAX kernels. The
    port passes it through unchanged."""
    return torch.zeros(SEED_STATE_LEN, dtype=torch.int32, device=device)


# --------------------------------------------------------- plain helpers
def optical_density(images_float: torch.Tensor) -> torch.Tensor:
    """OD = −log((I·255 + 1) / Io) for float [0, 1] images, dividing as the
    kernels do (:func:`~stainx_tpu_torch.ops.eigh3.div_rn`)."""
    return -torch.log(div_rn(images_float * 255.0 + 1.0, IO))


def maxc_scale(tmc: torch.Tensor, maxc: torch.Tensor) -> torch.Tensor:
    """``tmc / maxC`` with the sign-preserving floor: a uniform tile's maxC
    of 0 becomes 1e-30 (finite scale), while a negative 99th-percentile
    concentration divides through unchanged, like the reference."""
    return tmc / torch.where(maxc.abs() > 1e-30, maxc, 1e-30)


def rescale_and_reconstruct(
    c0: torch.Tensor,
    c1: torch.Tensor,
    max_c0: torch.Tensor,
    max_c1: torch.Tensor,
    target_max_conc: torch.Tensor,
    stain_matrix: torch.Tensor,
    recon_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """maxC guard, concentration rescale and Beer–Lambert reconstruction.
    ``c0``/``c1`` are (N, P) concentration planes, ``max_c*`` their (N,)
    99th percentiles; the rescaled concentrations and the stain matrix are
    combined in ``recon_dtype``. Returns clipped RGB (N, 3, P) float32 in
    [0, 255]."""
    tmc = target_max_conc.reshape(-1).to(device=c0.device, dtype=torch.float32)
    cn0 = (c0 * maxc_scale(tmc[0], max_c0)[:, None]).to(recon_dtype)
    cn1 = (c1 * maxc_scale(tmc[1], max_c1)[:, None]).to(recon_dtype)
    stain = stain_matrix.to(device=c0.device, dtype=torch.float32).to(recon_dtype)
    od_recon = torch.stack(
        [(cn0 * stain[i, 0] + cn1 * stain[i, 1]).to(torch.float32) for i in range(3)], dim=1
    )
    return torch.clamp(IO * torch.exp(-od_recon), 0.0, 255.0)


def od_from_planes(x: torch.Tensor, is_uint8: bool) -> torch.Tensor:
    """OD of raw (R, 3, P) values as float32."""
    if is_uint8:
        return -torch.log(div_rn(x.to(torch.int32).to(torch.float32) + 1.0, IO))
    return optical_density(x.to(torch.float32))


def masked_moments(od: torch.Tensor, weight: torch.Tensor):
    """Integer count (R,) and the 9 sums (R, 9) of ``y = OD − 1`` over the
    pixels where ``weight`` (R, P) is true: Σy0, Σy1, Σy2, Σy0², Σy0y1,
    Σy0y2, Σy1², Σy1y2, Σy2². Products are float32, sums float64, results
    float32."""
    y0, y1, y2 = (od - 1.0).unbind(1)
    terms = (y0, y1, y2, y0 * y0, y0 * y1, y0 * y2, y1 * y1, y1 * y2, y2 * y2)
    sums = torch.stack(
        [torch.where(weight, t, 0.0).to(torch.float64).sum(-1) for t in terms], dim=-1
    )
    return weight.sum(-1), sums.to(torch.float32)


def cov_from_moments(cnt: torch.Tensor, sums: torch.Tensor) -> torch.Tensor:
    """Covariance (R, 3, 3) from :func:`masked_moments`; zeros when cnt ≤ 1."""
    cnt = cnt.to(torch.float32)
    s0, s1, s2, xx, xy, xz, yy, yz, zz = sums.unbind(-1)
    safe = torch.clamp(cnt, min=1.0)
    mu = (s0 / safe, s1 / safe, s2 / safe)
    den = torch.clamp(cnt - 1.0, min=1.0)
    ok = cnt > 1.0

    def entry(s, i, j):
        return torch.where(ok, (s - cnt * mu[i] * mu[j]) / den, 0.0)

    a00, a01, a02 = entry(xx, 0, 0), entry(xy, 0, 1), entry(xz, 0, 2)
    a11, a12, a22 = entry(yy, 1, 1), entry(yz, 1, 2), entry(zz, 2, 2)
    rows = [torch.stack(r, -1) for r in ((a00, a01, a02), (a01, a11, a12), (a02, a12, a22))]
    return torch.stack(rows, dim=-2)


def pseudo_angle(t0: torch.Tensor, t1: torch.Tensor) -> torch.Tensor:
    """Diamond angle, order-isomorphic to atan2(t1, t0), range (−2, 2]."""
    s = t0.abs() + t1.abs() + 1e-37
    a = t1 / s
    return torch.where(t0 >= 0, a, torch.where(t1 >= 0, 2.0 - a, -2.0 - a))


def dir_from_pseudo(p: torch.Tensor):
    """(cos, sin) of the direction a diamond angle encodes."""
    ap = p.abs()
    u = torch.where(ap <= 1.0, 1.0 - ap, torch.where(p > 1.0, 1.0 - p, 1.0 + p))
    v = torch.where(ap <= 1.0, p, torch.where(p > 1.0, 2.0 - p, -2.0 - p))
    norm = torch.sqrt(u * u + v * v)
    inv = torch.where(norm > 1e-30, 1.0 / norm, 0.0)
    return u * inv, v * inv


def he_from_phi(evecs, cos_lo, sin_lo, cos_hi, sin_hi) -> torch.Tensor:
    """Extreme stain vectors and H/E ordering: (R, 3, 2) → HE (R, 3, 2)."""
    v_mid, v_max = evecs[..., 0], evecs[..., 1]
    v_lo = v_mid * cos_lo[:, None] + v_max * sin_lo[:, None]
    v_hi = v_mid * cos_hi[:, None] + v_max * sin_hi[:, None]
    swap = (v_lo[:, 0] > v_hi[:, 0])[:, None]
    return torch.stack(
        [torch.where(swap, v_lo, v_hi), torch.where(swap, v_hi, v_lo)], dim=-1
    )


def normal_rows(he: torch.Tensor):
    """Rows (m0, m1), each (R, 3), of the 2×2 normal-equation inverse of the
    HE columns; 1/det is clamped to ±1e12 so (anti)parallel columns stay
    finite."""
    h0, h1 = he[..., 0], he[..., 1]

    def dot(u, v):
        return u[:, 0] * v[:, 0] + u[:, 1] * v[:, 1] + u[:, 2] * v[:, 2]

    a, b, c = dot(h0, h0), dot(h0, h1), dot(h1, h1)
    inv_det = torch.clamp(1.0 / (a * c - b * b), -1e12, 1e12)[:, None]
    m0 = (c[:, None] * h0 - b[:, None] * h1) * inv_det
    m1 = (a[:, None] * h1 - b[:, None] * h0) * inv_det
    return m0, m1


def _project(od: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Σ_c od_c · w_c for (R, 3, P) planes and (R, 3) weights, left to right."""
    return od[:, 0] * w[:, 0, None] + od[:, 1] * w[:, 1, None] + od[:, 2] * w[:, 2, None]


def _stain_params(od: torch.Tensor, fallback: bool, stream: bool = False):
    """The statistics both kernels share, for rows of OD (R, 3, P):
    returns HE (R, 3, 2), concentration planes c0, c1 (R, P) and their 99th
    percentiles maxc (R, 2). With ``stream`` (the plain versions of B4 and
    B5) the selections run through B6's plain version on fields with +inf
    sentinels, the angles with their (min, max, count) init: B6's
    conventions, which B4 and B5 follow in the radix selects inside their
    own kernels. Both forms select the same elements."""
    rows, _, p = od.shape
    bmask = torch.amin(od, dim=1) >= BETA
    cnt, sums = masked_moments(od, bmask)
    phi_mask = bmask
    if fallback:
        use_all = cnt < 3
        cnt_all, sums_all = masked_moments(od, torch.ones_like(bmask))
        cnt = torch.where(use_all, cnt_all, cnt)
        sums = torch.where(use_all[:, None], sums_all, sums)
        phi_mask = bmask | use_all[:, None]

    evecs = eigh3_top2(cov_from_moments(cnt, sums))
    pseudo = pseudo_angle(_project(od, evecs[..., 0]), _project(od, evecs[..., 1]))
    ranks = torch.stack(
        [nearest_rank_index(ALPHA, cnt), nearest_rank_index(100 - ALPHA, cnt)], dim=-1
    )
    if stream:
        field = torch.where(phi_mask, pseudo, torch.inf)
        top = torch.where(phi_mask, pseudo, -torch.inf).amax(-1)
        phi = kth_smallest_streaming_plain(field, ranks, (field.amin(-1), top, cnt))
    else:
        phi = kth_smallest(pseudo, ranks, phi_mask)
    cos_lo, sin_lo = dir_from_pseudo(phi[:, 0])
    cos_hi, sin_hi = dir_from_pseudo(phi[:, 1])
    he = he_from_phi(evecs, cos_lo, sin_lo, cos_hi, sin_hi)

    m0, m1 = normal_rows(he)
    c0, c1 = _project(od, m0), _project(od, m1)
    idx99 = torch.full((2 * rows, 1), static_nearest_rank_index(99, p), device=od.device)
    conc = torch.stack([c0, c1], dim=1).reshape(2 * rows, p)
    select = kth_smallest_streaming_plain if stream else kth_smallest
    maxc = select(conc, idx99)
    return he, c0, c1, maxc.reshape(rows, 2)


def transform_plain(images, stain_matrix, target_max_conc, stream: bool = False):
    """The plain transform of B1 (and, with ``stream``, of B4)."""
    n, c, h, w = images.shape
    is_uint8 = images.dtype == torch.uint8
    od = od_from_planes(images.reshape(n, 3, h * w), is_uint8)
    _he, c0, c1, maxc = _stain_params(od, fallback=True, stream=stream)
    rgb = rescale_and_reconstruct(c0, c1, maxc[:, 0], maxc[:, 1], target_max_conc, stain_matrix)
    if is_uint8:
        rgb = rgb.to(torch.int32).to(torch.uint8)
    return rgb.reshape(n, c, h, w)


def fit_plain(images, stream: bool = False):
    """The plain fit of B2 (and, with ``stream``, of B5): the N images'
    pixels pooled channel-major into one row."""
    n, _, h, w = images.shape
    od = od_from_planes(images.reshape(n, 3, h * w), images.dtype == torch.uint8)
    pooled = od.transpose(0, 1).reshape(1, 3, n * h * w)
    he, _c0, _c1, maxc = _stain_params(pooled, fallback=False, stream=stream)
    return he[0], maxc[0]


def _check_scale(images: torch.Tensor, scale: float, what: str) -> None:
    """A transform kernel multiplies float32 output by ``scale`` in its
    store; uint8 output, truncated, takes only 1."""
    if scale != 1.0 and images.dtype != torch.float32:
        raise ValueError(f"{what}: scale applies to float32 output only, got {images.dtype} "
                         f"and scale {scale}")


def _scaled(out: torch.Tensor, scale: float) -> torch.Tensor:
    """The plain versions' form of the kernels' scaled store: each value
    times ``scale`` in float32, a rounded product of its own."""
    return out if scale == 1.0 else out * scale


def macenko_transform_mega_plain(images, stain_matrix, target_max_conc,
                                 scale: float = 1.0) -> torch.Tensor:
    """Plain PyTorch version of the transform kernel (B1); a float32
    output is multiplied by ``scale`` as the kernel's store does."""
    kernels.check_rgb_batch(images, "macenko_transform_mega")
    _check_scale(images, scale, "macenko_transform_mega")
    return _scaled(transform_plain(images, stain_matrix, target_max_conc), scale)


def macenko_fit_mega_plain(images):
    """Plain PyTorch version of the fit kernel (B2)."""
    kernels.check_rgb_batch(images, "macenko_fit_mega")
    return fit_plain(images)


# --------------------------------------------------------------- wrappers
def _lib() -> ctypes.CDLL:
    lib = kernels.library("macenko_fused")
    if not getattr(lib, "_stainx_declared", False):
        ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.stainx_macenko_transform_mega.argtypes = [
            ptr, ptr, ptr, ptr, ctypes.c_float, i64, i64, i32, i32, i64, i64, ptr, ptr, ptr, ptr, ptr
        ]
        lib.stainx_macenko_transform_mega.restype = i32
        lib.stainx_macenko_fit_mega.argtypes = [
            ptr, ptr, i64, i64, i32, i32, i64, i64, ptr, ptr, ptr
        ]
        lib.stainx_macenko_fit_mega.restype = i32
        lib._stainx_declared = True
    return lib


def _params(t: torch.Tensor, device, numel: int, name: str) -> torch.Tensor:
    """``t`` as a contiguous float32 tensor on ``device``; such a tensor
    passes as it is."""
    if not (torch.is_tensor(t) and t.dtype == torch.float32 and t.device == device
            and t.is_contiguous()):
        t = torch.as_tensor(t).to(device=device, dtype=torch.float32).contiguous()
    if t.numel() != numel:
        raise ValueError(f"{name} must have {numel} entries, got shape {tuple(t.shape)}")
    return t


def _vec4(p: int, *tensors: torch.Tensor) -> bool:
    """Whether rows can be read 4 pixels at a time (16-byte aligned planes)."""
    return p % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in tensors)


# The resident body's fixed shared memory (csrc/macenko_fused.cu
# kResidentFixed); an image adds its two selections' keys (8 bytes a pixel)
# and its three planes (3 bytes a uint8 pixel, 12 a float32 one, kept as
# OD), each rounded up to 16 bytes.
RESIDENT_FIXED_BYTES = 12800


def resident_bytes(p: int, dtype: torch.dtype) -> int:
    """Shared memory of a resident block for images of ``p`` pixels."""
    itemsize = 1 if dtype == torch.uint8 else 4
    return RESIDENT_FIXED_BYTES + kernels.ceil_to(8 * p, 16) + kernels.ceil_to(3 * p * itemsize, 16)


def transform_body(p: int, dtype: torch.dtype, smem_limit: int) -> str:
    """``"resident"`` (the image in one 512-thread block's shared memory) or
    ``"l2"`` (a 1024-thread block re-reading it from L2 each pass) for
    images of ``p`` pixels of ``dtype``, given a block's opt-in shared
    memory: resident wherever it fits (on an H100 up to 19 968 uint8
    pixels or 10 982 float32, two blocks an SM up to 9 354 uint8 pixels,
    such as a 96² patch)."""
    return "resident" if resident_bytes(p, dtype) <= smem_limit else "l2"


def _transform(images, stain_matrix, target_max_conc, body, check: bool, scale: float = 1.0,
               events=None):
    """One B1 launch: the output (float32 values times ``scale``), and with
    ``check`` the keys and selections of :func:`resident_selections`.
    Without ``check`` the launch counts in ``launch.B1`` and in its body's
    counter, ``resident.B1`` or ``l2.B1``. ``events``: None, or the two
    event handles of :func:`~stainx_tpu_torch.profiling.caller_timed`, which
    the C call records around the launch; given them, the span also notes
    :func:`blocks_per_sm`."""
    _check_scale(images, scale, "macenko_transform_mega")
    kernels.check_cuda(images, "macenko_transform_mega")
    dev = images.device
    he = _params(stain_matrix, dev, 6, "stain_matrix")
    tmc = _params(target_max_conc, dev, 2, "target_max_conc")
    out = torch.empty_like(images)
    n, _, h, w = images.shape
    p = h * w
    if p >= 2**31:
        raise ValueError(f"macenko_transform_mega takes images below 2^31 pixels, got {p}")
    smem_limit = kernels.device_limits(dev.index)[1]
    body = "resident" if check else body or transform_body(p, images.dtype, smem_limit)
    profiling.note(route=body)
    smem = resident_bytes(p, images.dtype) if body == "resident" else 0
    if smem > smem_limit:
        raise ValueError(f"macenko_transform_mega: a {p}-pixel image needs {smem} bytes of shared "
                         f"memory resident, more than the card's {smem_limit}")
    keys = torch.empty((n, 3, p), dtype=torch.int32, device=dev) if check else None
    sel = torch.empty((n, 4), dtype=torch.float32, device=dev) if check else None
    if out.numel() == 0:
        return out, keys, sel
    is_uint8, vec4 = int(images.dtype == torch.uint8), int(_vec4(p, images, out))
    lib = _lib()
    with kernels.on_device(dev):
        code = lib.stainx_macenko_transform_mega(
            images.data_ptr(), out.data_ptr(), he.data_ptr(), tmc.data_ptr(), scale,
            n, p, is_uint8, vec4, static_nearest_rank_index(99, p), smem,
            keys.data_ptr() if check else None, sel.data_ptr() if check else None,
            kernels.current_stream(dev), *(events or (None, None)),
        )
    kernels.check(lib, code, "macenko_transform_mega")
    if not check:
        profiling.count("launch.B1")
        profiling.count(f"{body}.B1")
    if events is not None:
        profiling.note(blocks_per_sm=blocks_per_sm(dev.index, is_uint8, vec4, smem))
    return out, keys, sel


@functools.cache
def blocks_per_sm(index: int, is_uint8: int, vec4: int, smem: int) -> int:
    """Blocks of a B1 launch (its dtype, vector width and the resident
    body's ``smem`` bytes, or 0 for the L2 body) that one SM of CUDA device
    ``index`` holds at once (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``),
    asked once a shape (each ask counted in ``occupancy.query``)."""
    profiling.count("occupancy.query")
    lib = _lib()
    query = lib.stainx_macenko_transform_occupancy
    query.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]
    query.restype = ctypes.c_int
    found = ctypes.c_int(0)
    with kernels.on_device(index):
        code = query(is_uint8, vec4, smem, ctypes.addressof(found))
    kernels.check(lib, code, "cudaOccupancyMaxActiveBlocksPerMultiprocessor")
    return found.value


def macenko_transform_mega(images, stain_matrix, target_max_conc, body: str | None = None, *,
                           scale: float = 1.0):
    """Macenko transform (B1): (N, 3, H, W) uint8/float32 → normalized batch
    of the same shape and dtype, values in [0, 255]; a float32 batch's
    values times ``scale``, which the kernel's store multiplies in
    (``ops.macenko.UNIT_SCALE`` writes [0, 1]; uint8 takes only 1). One
    launch per call, one thread block per image; ``body`` (``"resident"``
    or ``"l2"``) overrides :func:`transform_body`, for measurements."""
    with profiling.caller_timed("stainx.kernel.B1", images.device) as events:
        kernels.check_rgb_batch(images, "macenko_transform_mega")
        if images.device.type == "cpu":
            return macenko_transform_mega_plain(images, stain_matrix, target_max_conc, scale)
        out, _, _ = _transform(images, stain_matrix, target_max_conc, body, check=False,
                               scale=scale, events=events)
        return out


def resident_selections(images, stain_matrix, target_max_conc):
    """Check only, on the card: B1's resident body run with its keys kept.
    Returns ``(out, keys, sel)``: the output, the (N, 3, P) int32 monotone
    keys each image selected on (the angle keys, +inf's key off the
    β-mask, then the two concentrations' keys) and the (N, 4) float32
    selected values (the α and 100−α angles, the two maxC). Not counted as
    a launch."""
    kernels.check_rgb_batch(images, "macenko_transform_mega")
    return _transform(images, stain_matrix, target_max_conc, None, check=True)


# B2's block (csrc/macenko_fused.cu kFitFixed: B1's resident head with a
# 1024-thread block's partial sums) holds a pool as B1's holds an image.
FIT_FIXED_BYTES = 14080


def fit_resident_bytes(pixels: int, dtype: torch.dtype) -> int:
    """Shared memory of B2's block for a pool of ``pixels``."""
    return resident_bytes(pixels, dtype) + FIT_FIXED_BYTES - RESIDENT_FIXED_BYTES


def _fit(images, check: bool):
    """One B2 launch: HE, maxC and, with ``check``, the keys and selections
    of :func:`fit_selections`."""
    kernels.check_cuda(images, "macenko_fit_mega")
    n, _, h, w = images.shape
    p = h * w
    pool = n * p
    if pool == 0:
        raise ValueError("macenko_fit_mega pools at least one pixel")
    dev = images.device
    smem_limit = kernels.device_limits(dev.index)[1]
    smem = fit_resident_bytes(pool, images.dtype)
    if smem > smem_limit:
        raise ValueError(f"macenko_fit_mega: a pool of {pool} pixels needs {smem} bytes of "
                         f"shared memory, more than the card's {smem_limit}; larger pools "
                         f"take macenko_fit_stream (B5)")
    out = torch.empty(8, dtype=torch.float32, device=dev)
    keys = torch.empty((3, pool), dtype=torch.int32, device=dev) if check else None
    sel = torch.empty(4, dtype=torch.float32, device=dev) if check else None
    lib = _lib()
    with kernels.on_device(dev):
        code = lib.stainx_macenko_fit_mega(
            images.data_ptr(), out.data_ptr(), n, p, int(images.dtype == torch.uint8),
            int(pool % 4 == 0), static_nearest_rank_index(99, pool), smem,
            keys.data_ptr() if check else None, sel.data_ptr() if check else None,
            kernels.current_stream(dev),
        )
    kernels.check(lib, code, "macenko_fit_mega")
    return out[:6].reshape(3, 2), out[6:8], keys, sel


def macenko_fit_mega(images):
    """Pooled Macenko fit (B2): (N, 3, H, W) uint8/float32 → ``(stain_matrix
    (3, 2) float32, max_concentrations (2,) float32)``. One launch per call:
    one thread block holds the whole pool in its shared memory, so on the
    card the pool must fit it (:func:`fit_resident_bytes`)."""
    with profiling.annotate("stainx.kernel.B2"):
        kernels.check_rgb_batch(images, "macenko_fit_mega")
        if images.device.type == "cpu":
            return macenko_fit_mega_plain(images)
        he, maxc, _, _ = _fit(images, check=False)
        profiling.count("launch.B2")
        return he, maxc


def fit_selections(images):
    """Check only, on the card: B2 run with its keys kept.
    Returns ``(he, maxc, keys, sel)``: the fit, the (3, N·P) int32 monotone
    keys the pool selected on (the angle keys, +inf's key off the β-mask,
    then the two concentrations' keys; pixels pooled channel-major, image
    by image) and the (4,) float32 selected values (the α and 100−α angles,
    the two maxC). Not counted as a launch."""
    kernels.check_rgb_batch(images, "macenko_fit_mega")
    return _fit(images, check=True)

