"""The multi-block Macenko transform and fit: wrappers, plain versions, counts.

Counterpart of ``stainx_tpu/kernels/macenko_stream.py``, the streaming tier.
:func:`macenko_transform_stream` (B4) computes B1's function and
:func:`macenko_fit_stream` (B5) B2's, each with a row (one image, or at fit
the N images pooled channel-major, read in place) spread over many thread
blocks. On a CUDA tensor a wrapper launches ``csrc/macenko_stream.cu``
(built at first use) by one of two routes (:func:`route`):

- ``"cluster"``: one thread-block cluster a row holds the row's pixels in
  shared memory for every pass, for rows whose raw bytes fit 8 blocks
  (:func:`fits_cluster`; the cluster's size, up to 16, is
  :func:`cluster_shape`'s); one kernel launch a call. A float32 row holds
  its resident pixels as OD, and where a block's slice has pixels past
  them, their keys go to a key field in device memory (8 bytes a pixel,
  :func:`cluster_scratch`), so each pixel's logarithm is taken once a
  call (the resident ones) or in 3 passes of 8 (the others), not on every
  pass;
- ``"stream"``: longer rows over many blocks, every selection pass
  recomputing its keys from the raw input (a float32 row writes its keys
  once and re-reads them); one memset and 10 kernels at transform, 9 at
  fit (each in launches of at most 65 535 images, so a pool of any size
  fits), all issued by one C call.

Both select inside their own kernels (an exact radix select on the
monotone key, with B6's conventions): no B6 launch; uint8 keys never reach
device memory. A wrapper raises rather than fall back. On a CPU tensor it runs its
plain version: B1's or B2's plain pipeline with the selections run through
B6's plain version, which selects the same elements. Each wrapper is the
span ``stainx.kernel.B4`` or ``stainx.kernel.B5`` (its route in the span's
arguments) and counts its C calls in ``launch.B4.<route>`` or
``launch.B5.<route>``, and a cluster call that writes a key field in
``keyfield.B4`` or ``keyfield.B5``, its bytes in the span's ``keyfield``
argument (:mod:`stainx_tpu_torch.profiling`).

Nothing is read back to the host: ranks, statistics and selected values stay
on the device, so a call can be captured in a CUDA graph. ``seed_state`` is
passed through by the ops layer, as for B1 and B2.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from stainx_tpu_torch import kernels, profiling
from stainx_tpu_torch.kernels import macenko_fused as mf
from stainx_tpu_torch.ops.percentile import static_nearest_rank_index

PARAMS_WIDTH = 32  # float32 a row of csrc/macenko_stream.cu RowParams
HE_COLUMNS = slice(8, 14)  # RowParams.he, HE row-major (3, 2)
PHI_COLUMNS = slice(20, 22)  # RowParams.phi, the selected pseudo-angles
MAXC_COLUMNS = slice(22, 24)  # RowParams.maxc
PARTIAL_SUMS = 20  # float64 sums a streamed block: beta-masked, then all pixels
SEL_BYTES = 32  # csrc/macenko_stream.cu Sel2
HIST_BINS = 256
CLUSTER_FIXED_BYTES = 42_944  # csrc/macenko_stream.cu ClusterShared
CLUSTER_SIZES = (1, 2, 4, 8, 16)  # 16 is past the portable 8, allowed by the kernel
FIT_BLOCKS = 8  # a row takes the cluster route when its planes fit 8 blocks
SLICE_QUANTUM = 16  # pixels: a slice is a whole number of 16-byte loads
KEY_BYTES = 8  # a key-field pixel: its angle key, then its two concentration keys over it
ALIGN = 256  # bytes between the streamed route's scratch regions


def macenko_transform_stream_plain(images, stain_matrix, target_max_conc) -> torch.Tensor:
    """Plain PyTorch version of the multi-block transform (B4)."""
    kernels.check_rgb_batch(images, "macenko_transform_stream")
    return mf.transform_plain(images, stain_matrix, target_max_conc, stream=True)


def macenko_fit_stream_plain(images):
    """Plain PyTorch version of the multi-block fit (B5)."""
    kernels.check_rgb_batch(images, "macenko_fit_stream")
    return mf.fit_plain(images, stream=True)


# ------------------------------------------------------------ host logic
def resident_budget(itemsize: int, smem_per_block: int) -> int:
    """Pixels of a row a cluster block can hold in shared memory beside its
    fixed part, a multiple of :data:`SLICE_QUANTUM`."""
    budget = (smem_per_block - CLUSTER_FIXED_BYTES) // (3 * itemsize)
    return budget - budget % SLICE_QUANTUM


def fits_cluster(row_len: int, itemsize: int, smem_per_block: int) -> bool:
    """Whether a row's three planes fit the shared memory of
    :data:`FIT_BLOCKS` cluster blocks."""
    return 0 < row_len <= FIT_BLOCKS * resident_budget(itemsize, smem_per_block)


def cluster_shape(rows: int, row_len: int, itemsize: int, smem_per_block: int,
                  active) -> tuple[int, int, int] | None:
    """``(cluster size, slice, resident)`` of the cluster route for ``rows``
    rows of ``row_len`` pixels of ``itemsize`` bytes, or None when a row does
    not fit (:func:`fits_cluster`). ``active(c, resident)`` is the number of
    clusters of ``c`` blocks the card holds at once. The cluster is the
    largest of which the card holds all the rows' clusters at once (else
    1), so the rows run in one wave where they can; a block takes a slice of
    the row (a multiple of :data:`SLICE_QUANTUM` pixels) and holds as much
    of it as fits in shared memory, reading the rest from device memory
    each pass."""
    if not fits_cluster(row_len, itemsize, smem_per_block):
        return None
    budget = resident_budget(itemsize, smem_per_block)
    for c in reversed(CLUSTER_SIZES):
        slice_ = kernels.ceil_to(-(-row_len // c), SLICE_QUANTUM)
        resident = min(slice_, budget)
        if c == 1 or active(c, resident) >= rows:
            return c, slice_, resident


def cluster_scratch(rows: int, csize: int, slice_: int, resident: int,
                    itemsize: int) -> tuple[int, int]:
    """``(buffer rows, key-field bytes)`` of the cluster route's scratch: one
    float32 ``(buffer rows, PARAMS_WIDTH)`` tensor whose first ``rows`` rows
    are the RowParams and whose rest, from byte ``rows * PARAMS_WIDTH * 4``
    (16-byte aligned), holds the key field of float32 rows whose slices have
    pixels past the resident ones: :data:`KEY_BYTES` for each such pixel of
    each block, ``2 * (slice_ - resident)`` uint32 a block in block order.
    uint8 rows and wholly resident float32 rows have none (0 bytes, no extra
    rows)."""
    keyfield = 0 if itemsize == 1 else rows * csize * (slice_ - resident) * KEY_BYTES
    return rows + -(-keyfield // (PARAMS_WIDTH * 4)), keyfield


def stream_layout(rows: int, blocks: int, key_len: int = 0):
    """The streamed route's scratch in one byte buffer: ``{name: (offset,
    nbytes)}`` and the total. ``params`` (rows, 32) float32, ``sel`` (rows,)
    selection states, ``hist`` (rows, 2, 256) uint32 with the rows' uint32
    tickets right after it (the kernel zeroes both with one memset),
    ``partials`` (blocks, 20) float64 and ``keys``, the float32 input's
    (2·rows, key_len) uint32 key field (empty for uint8). Regions start
    :data:`ALIGN` apart."""
    sizes = [("params", rows * PARAMS_WIDTH * 4), ("sel", rows * SEL_BYTES),
             ("hist", rows * 2 * HIST_BINS * 4 + rows * 4), ("partials", blocks * PARTIAL_SUMS * 8),
             ("keys", 2 * rows * key_len * 4)]
    layout, off = {}, 0
    for name, nbytes in sizes:
        layout[name] = (off, nbytes)
        off = kernels.ceil_to(off + nbytes, ALIGN)
    return layout, off


def route(row_len: int, dtype: torch.dtype, smem_per_block: int) -> str:
    """``"cluster"`` when a row's raw bytes fit a cluster, else ``"stream"``."""
    itemsize = 1 if dtype == torch.uint8 else 4
    return "cluster" if fits_cluster(row_len, itemsize, smem_per_block) else "stream"


# --------------------------------------------------------------- wrappers
def _lib() -> ctypes.CDLL:
    lib = kernels.library("macenko_stream")
    if not getattr(lib, "_stainx_declared", False):
        ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.stainx_cluster_run.argtypes = [
            ptr, ptr, i64, i64, i32, i32, i32, i32, i64, i64, i32, i64, ptr, ptr, ptr, ptr, ptr
        ]
        lib.stainx_stream_run.argtypes = [
            ptr, ptr, i64, i64, i32, i32, i32, i32, i32, i32, i64, ptr, ptr, ptr, ptr, ptr, ptr,
            ptr, ptr
        ]
        lib.stainx_stream_fields.argtypes = [ptr, i64, i64, i32, i32, i32, i32, ptr, ptr, ptr, ptr]
        lib.stainx_cluster_occupancy.argtypes = [i32, i32, i64, ptr]
        for fn in (lib.stainx_cluster_run, lib.stainx_stream_run, lib.stainx_stream_fields,
                   lib.stainx_cluster_occupancy):
            fn.restype = i32
        lib._stainx_declared = True
    return lib


def _run(images, out, stain, tmc, fit: bool, force: str | None = None,
         shape: tuple[int, int, int] | None = None) -> torch.Tensor:
    """One B4 (``out`` given) or B5 call on the card; returns the (rows, 32)
    RowParams, and counts the launch by its route. ``force`` takes a route
    other than :func:`route` would (the streamed route takes every row; the
    cluster route only rows that fit); ``shape``, for checks, a cluster
    ``(size, slice, resident)`` other than :func:`cluster_shape`'s (slice
    and resident multiples of :data:`SLICE_QUANTUM`, the slices covering the
    row, resident within the slice and the block's shared memory)."""
    n, _, h, w = images.shape
    p = h * w
    per_row = n if fit else 1
    rows, row_len = n // per_row, per_row * p
    what = "macenko_fit_stream" if fit else "macenko_transform_stream"
    counter = "launch.B5." if fit else "launch.B4."
    if row_len >= 2**31:
        raise ValueError(f"{what} takes rows below 2^31 pixels, got {row_len}")
    dev = images.device
    smem = kernels.device_limits(dev.index)[1]
    is_uint8 = images.dtype == torch.uint8
    itemsize = 1 if is_uint8 else 4
    take = force or route(row_len, images.dtype, smem)
    aligned = (images,) if out is None else (images, out)
    idx99 = static_nearest_rank_index(99, row_len)
    lib = _lib()
    stream = kernels.current_stream(dev)
    null = None
    if take == "cluster":
        if shape is None:
            active = functools.partial(_active_clusters, dev.index, images.dtype)
            shape = cluster_shape(rows, row_len, itemsize, smem, active)
        if shape is None:
            raise ValueError(f"{what}: rows of {row_len} pixels do not fit a cluster")
        csize, slice_, resident = shape
        buf_rows, keyfield = cluster_scratch(rows, csize, slice_, resident, itemsize)
        profiling.note(route=take, csize=csize, slice=slice_, resident=resident, keyfield=keyfield)
        vec = p % (16 // itemsize) == 0 and all(t.data_ptr() % 16 == 0 for t in aligned)
        buf = torch.empty((buf_rows, PARAMS_WIDTH), dtype=torch.float32, device=dev)
        keys = buf.data_ptr() + rows * PARAMS_WIDTH * 4 if keyfield else null
        with kernels.on_device(dev):
            code = lib.stainx_cluster_run(
                images.data_ptr(), null if out is None else out.data_ptr(), n, p, per_row,
                int(is_uint8), int(vec), csize, slice_, resident, int(not fit), idx99,
                null if fit else stain.data_ptr(), null if fit else tmc.data_ptr(),
                buf.data_ptr(), keys, stream,
            )
        kernels.check(lib, code, what)
        profiling.count(counter + take)
        if keyfield:
            profiling.count("keyfield.B5" if fit else "keyfield.B4")
            return buf[:rows]
        return buf
    profiling.note(route=take)
    vec = 4 if mf._vec4(p, *aligned) else 1
    blocks = kernels.row_blocks(n, p // vec, dev)
    layout, total = stream_layout(rows, n * blocks, 0 if is_uint8 else row_len)
    scratch = torch.empty(total, dtype=torch.uint8, device=dev)
    base = scratch.data_ptr()
    with kernels.on_device(dev):
        code = lib.stainx_stream_run(
            images.data_ptr(), null if out is None else out.data_ptr(), n, p, per_row,
            int(is_uint8), vec, blocks, kernels.row_blocks(rows, row_len // vec, dev),
            int(not fit), idx99, null if fit else stain.data_ptr(),
            null if fit else tmc.data_ptr(), base + layout["params"][0], base + layout["sel"][0],
            base + layout["hist"][0], base + layout["partials"][0],
            null if is_uint8 else base + layout["keys"][0], stream,
        )
    kernels.check(lib, code, what)
    profiling.count(counter + take)
    off, nbytes = layout["params"]
    return scratch[off:off + nbytes].view(torch.float32).view(rows, PARAMS_WIDTH)


def kernel_keys(images: torch.Tensor, params: torch.Tensor, fit: bool):
    """Check-only: the keys a B4 (``fit`` False) or B5 call selected on,
    recomputed on the card by the kernels' own device functions from the
    call's RowParams. Returns the (rows, P) pseudo-angle field (+inf off
    the beta-mask) and the (2·rows, P) concentration field."""
    n, _, h, w = images.shape
    p = h * w
    per_row = n if fit else 1
    rows, row_len = n // per_row, per_row * p
    dev = images.device
    vec = 4 if mf._vec4(p, images) else 1
    angles = torch.empty((rows, row_len), dtype=torch.float32, device=dev)
    conc = torch.empty((2 * rows, row_len), dtype=torch.float32, device=dev)
    lib = _lib()
    with kernels.on_device(dev):
        code = lib.stainx_stream_fields(
            images.data_ptr(), n, p, per_row, int(images.dtype == torch.uint8), vec,
            kernels.row_blocks(n, p // vec, dev), params.data_ptr(), angles.data_ptr(),
            conc.data_ptr(), kernels.current_stream(dev),
        )
    kernels.check(lib, code, "stainx_stream_fields")
    return angles, conc


def cluster_occupancy(dtype: torch.dtype, csize: int, resident: int) -> int:
    """Clusters of that shape the current card holds at once
    (``cudaOccupancyMaxActiveClusters``)."""
    lib = _lib()
    found = ctypes.c_int(0)
    code = lib.stainx_cluster_occupancy(int(dtype == torch.uint8), csize, resident,
                                        ctypes.addressof(found))
    kernels.check(lib, code, "cudaOccupancyMaxActiveClusters")
    return found.value


@functools.cache
def _active_clusters(index: int, dtype: torch.dtype, csize: int, resident: int) -> int:
    """:func:`cluster_occupancy` on CUDA device ``index``, asked once a shape
    (each ask counted in ``occupancy.query``)."""
    profiling.count("occupancy.query")
    with kernels.on_device(index):
        return cluster_occupancy(dtype, csize, resident)


def macenko_transform_stream(images, stain_matrix, target_max_conc, *, force=None) -> torch.Tensor:
    """Multi-block Macenko transform (B4): (N, 3, H, W) uint8/float32 →
    normalized batch of the same shape and dtype, values in [0, 255]. One
    C call, one cluster launch or the streamed route's kernels. ``force``
    (``"cluster"`` or ``"stream"``) overrides :func:`route`, for checks."""
    with profiling.annotate("stainx.kernel.B4"):
        kernels.check_rgb_batch(images, "macenko_transform_stream")
        if images.device.type == "cpu":
            return macenko_transform_stream_plain(images, stain_matrix, target_max_conc)
        kernels.check_cuda(images, "macenko_transform_stream")
        dev = images.device
        he = mf._params(stain_matrix, dev, 6, "stain_matrix")
        tmc = mf._params(target_max_conc, dev, 2, "target_max_conc")
        out = torch.empty_like(images)
        if out.numel() == 0:
            return out
        _run(images, out, he, tmc, fit=False, force=force)
        return out


def macenko_fit_stream(images, *, force=None):
    """Pooled multi-block Macenko fit (B5): (N, 3, H, W) uint8/float32 →
    ``(stain_matrix (3, 2) float32, max_concentrations (2,) float32)``.
    One C call, as B4."""
    with profiling.annotate("stainx.kernel.B5"):
        kernels.check_rgb_batch(images, "macenko_fit_stream")
        if images.device.type == "cpu":
            return macenko_fit_stream_plain(images)
        kernels.check_cuda(images, "macenko_fit_stream")
        n, _, h, w = images.shape
        if n * h * w == 0:
            raise ValueError("macenko_fit_stream pools at least one pixel")
        params = _run(images, None, None, None, fit=True, force=force)
        return params[0, HE_COLUMNS].reshape(3, 2), params[0, MAXC_COLUMNS]
