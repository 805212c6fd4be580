"""The multi-block Macenko transform and fit: wrappers, plain versions, counts.

Counterpart of ``stainx_tpu/kernels/macenko_stream.py``, the streaming tier.
:func:`macenko_transform_stream` (B4) computes B1's function and
:func:`macenko_fit_stream` (B5) B2's, each with a row (one image, or at fit
the N images pooled channel-major, read in place) split across many thread
blocks. On a CUDA tensor a wrapper launches the kernels of
``csrc/macenko_stream.cu`` (built at first use) and selects through B6
(:func:`~stainx_tpu_torch.kernels.selection_stream.kth_smallest_streaming`)
on device-memory key caches of 4 bytes a pixel and field; it raises rather
than fall back. On a CPU tensor it runs its plain version: B1's or B2's
plain pipeline with the selections run as the kernels run them, through
B6's plain version. Each wrapper counts its own launches in ``launches``;
a call also adds two to B6's count.

Nothing is read back to the host between launches: ranks, statistics and
selected values stay on the device, so a call can be captured in a CUDA
graph. ``seed_state`` is passed through by the ops layer, as for B1 and B2.
"""

from __future__ import annotations

import ctypes

import torch

from stainx_tpu_torch import kernels
from stainx_tpu_torch.kernels import macenko_fused as mf
from stainx_tpu_torch.kernels.selection_stream import MAX_ROWS, select_on_device
from stainx_tpu_torch.ops.percentile import static_nearest_rank_index

PARAMS_WIDTH = 32  # float32 a row of csrc/macenko_stream.cu RowParams
HE_COLUMNS = slice(8, 14)  # RowParams.he, HE row-major (3, 2)
PARTIAL_SUMS = 20  # float64 sums a block: beta-masked, then all pixels


def macenko_transform_stream_plain(images, stain_matrix, target_max_conc) -> torch.Tensor:
    """Plain PyTorch version of the multi-block transform (B4)."""
    kernels.check_rgb_batch(images, "macenko_transform_stream")
    return mf.transform_plain(images, stain_matrix, target_max_conc, stream=True)


def macenko_fit_stream_plain(images):
    """Plain PyTorch version of the multi-block fit (B5)."""
    kernels.check_rgb_batch(images, "macenko_fit_stream")
    return mf.fit_plain(images, stream=True)


# --------------------------------------------------------------- wrappers
def _lib() -> ctypes.CDLL:
    lib = kernels.library("macenko_stream")
    if not getattr(lib, "_stainx_declared", False):
        ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.stainx_stream_stats.argtypes = [
            ptr, i64, i64, i32, i32, i32, i32, i32, i64, ptr, ptr, ptr, ptr, ptr, ptr, ptr
        ]
        lib.stainx_stream_conc.argtypes = [ptr, i64, i64, i32, i32, i32, i32, ptr, ptr, ptr, ptr]
        lib.stainx_stream_reconstruct.argtypes = [
            ptr, ptr, i64, i64, i32, i32, i32, ptr, ptr, ptr, ptr, ptr
        ]
        for fn in (lib.stainx_stream_stats, lib.stainx_stream_conc, lib.stainx_stream_reconstruct):
            fn.restype = i32
        lib._stainx_declared = True
    return lib


def _stain_stats(images: torch.Tensor, per_row: int, fallback: bool, what: str, out=None):
    """Steps 1-5 of ``csrc/macenko_stream.cu`` on rows of ``per_row``
    images: returns the (rows, 32) row parameters, the (rows, 2) selected
    99th-percentile concentrations, and the launch shape (vec, blocks)."""
    n, _, h, w = images.shape
    p = h * w
    rows, row_len = n // per_row, per_row * p
    if 2 * rows > MAX_ROWS or n > MAX_ROWS:
        raise ValueError(f"{what} takes at most {MAX_ROWS // 2} rows, got {rows}")
    if row_len >= 2**31:
        raise ValueError(f"{what} takes rows below 2^31 pixels, got {row_len}")
    dev = images.device
    aligned = (images,) if out is None else (images, out)
    vec = 4 if mf._vec4(p, *aligned) else 1
    blocks = kernels.row_blocks(n, p // vec, dev)
    is_uint8 = int(images.dtype == torch.uint8)
    partials = torch.empty((n * blocks, PARTIAL_SUMS), dtype=torch.float64, device=dev)
    params = torch.empty((rows, PARAMS_WIDTH), dtype=torch.float32, device=dev)
    ranks = torch.empty((rows, 2), dtype=torch.int32, device=dev)
    init3 = torch.empty((rows, 3), dtype=torch.int32, device=dev)
    ranks99 = torch.empty((2 * rows, 1), dtype=torch.int32, device=dev)
    field = torch.empty((rows, row_len), dtype=torch.float32, device=dev)
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        code = lib.stainx_stream_stats(
            images.data_ptr(), n, p, per_row, is_uint8, vec, blocks, int(fallback),
            static_nearest_rank_index(99, row_len), partials.data_ptr(), params.data_ptr(),
            ranks.data_ptr(), init3.data_ptr(), ranks99.data_ptr(), field.data_ptr(), stream,
        )
    kernels.check(lib, code, what)
    phi = select_on_device(field, ranks, init3)
    del field  # the allocator hands its memory to the concentration fields
    field2 = torch.empty((2 * rows, row_len), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        code = lib.stainx_stream_conc(
            images.data_ptr(), n, p, per_row, is_uint8, vec, blocks, params.data_ptr(),
            phi.data_ptr(), field2.data_ptr(), stream,
        )
    kernels.check(lib, code, what)
    maxc = select_on_device(field2, ranks99, None)
    return params, maxc.reshape(rows, 2), vec, blocks


def macenko_transform_stream(images, stain_matrix, target_max_conc) -> torch.Tensor:
    """Multi-block Macenko transform (B4): (N, 3, H, W) uint8/float32 →
    normalized batch of the same shape and dtype, values in [0, 255]. One
    launch per call (its kernels in sequence), plus two B6 launches."""
    kernels.check_rgb_batch(images, "macenko_transform_stream")
    if images.device.type == "cpu":
        return macenko_transform_stream_plain(images, stain_matrix, target_max_conc)
    kernels.check_cuda(images, "macenko_transform_stream")
    dev = images.device
    he = mf._params(stain_matrix, dev, 6, "stain_matrix")
    tmc = mf._params(target_max_conc, dev, 2, "target_max_conc")
    out = torch.empty_like(images)
    n, _, h, w = images.shape
    if out.numel() == 0:
        return out
    params, maxc, vec, blocks = _stain_stats(images, 1, True, "macenko_transform_stream", out)
    lib = _lib()
    with torch.cuda.device(dev):
        code = lib.stainx_stream_reconstruct(
            images.data_ptr(), out.data_ptr(), n, h * w, int(images.dtype == torch.uint8), vec,
            blocks, params.data_ptr(), maxc.data_ptr(), he.data_ptr(), tmc.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    kernels.check(lib, code, "macenko_transform_stream")
    macenko_transform_stream.launches += 1
    return out


def macenko_fit_stream(images):
    """Pooled multi-block Macenko fit (B5): (N, 3, H, W) uint8/float32 →
    ``(stain_matrix (3, 2) float32, max_concentrations (2,) float32)``. One
    launch per call (its kernels in sequence), plus two B6 launches."""
    kernels.check_rgb_batch(images, "macenko_fit_stream")
    if images.device.type == "cpu":
        return macenko_fit_stream_plain(images)
    kernels.check_cuda(images, "macenko_fit_stream")
    n, _, h, w = images.shape
    if n * h * w == 0:
        raise ValueError("macenko_fit_stream pools at least one pixel")
    params, maxc, _vec, _blocks = _stain_stats(images, n, False, "macenko_fit_stream")
    macenko_fit_stream.launches += 1
    return params[0, HE_COLUMNS].reshape(3, 2), maxc[0]


macenko_transform_stream.launches = 0
macenko_fit_stream.launches = 0
