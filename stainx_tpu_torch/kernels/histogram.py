"""The histogram-matching kernels: wrappers, plain versions, counts.

Counterpart of ``stainx_tpu/kernels/histogram.py``. On a CUDA tensor each
wrapper launches hand-written kernels from ``csrc/histogram.cu`` (built at
first use) or raises; on a CPU tensor it runs its plain PyTorch version.
Any channel count C ≥ 1 is accepted. Each wrapper is a span,
``stainx.kernel.B8a``, ``stainx.kernel.B8b`` or, for :func:`hm_transfer`,
``stainx.kernel.B8``; ``launch.B8a`` counts the C calls that launch the
histogram kernel (B8a/B8c, with its finalize), ``launch.B8b`` those that
launch the LUT apply, and ``lut.vector`` those LUT applies whose planes
run vectors (:mod:`stainx_tpu_torch.profiling`).

- :func:`histogram_256`: per-channel 256-bin counts of (N, C, P) or (C, P)
  uint8 as (C, 256) float32. The kernel counts in int32 (exact, the same on
  every run); its finalize converts them to float32 once. One kernel serves
  both TPU kernels, ``histogram_256_mxu`` and ``histogram_256_pallas``.
- :func:`hm_reference`: the fit, the histogram and a finalize that writes
  ``counts / (sum + 1e-8)``, in one C call.
- :func:`hm_transfer`: the transform, the histogram, a finalize that builds
  the LUT of :func:`hm_build_lut` and its table, and the apply, in one C
  call: nothing is issued between them. Inside a profiler session, on a
  CUDA tensor, it also opens the span ``stainx.stats``, the call-wide
  histogram and LUT, as a child of ``stainx.kernel.B8``: the wrapper passes
  ``stainx_hm_transform`` two CUDA timing events from
  :func:`~stainx_tpu_torch.profiling.caller_timed`, which the C call
  records on the stream before the histogram launch and after the LUT
  finalize, before the apply. With no session running it passes two nulls.
  In a call that the call timeline samples it also passes the call's two
  launch events (:func:`~stainx_tpu_torch.profiling.launch_events`),
  recorded before the first launch and after the last; elsewhere two more
  nulls. The launches, their order and the outputs are the same either way.
- :func:`apply_lut`: a per-channel 256-entry lookup of (N, C, P) uint8
  through a (C, 256) float32 LUT: ``⌊clip(lut[c, v], 0, 255)⌋`` as uint8, or
  ``clip(lut[c, v] / 255, 0, 1)`` as float32. The (C, 256) table of either
  form is made here, on the device, and the kernel only looks it up.

The apply kernel walks its input as the histogram kernel does: a block
takes a stretch of one channel's N·P values (:func:`apply_split`) and
walks the planes it covers, so the channel and its table row are fixed
for the block. A vector is what one 16-byte store of the output holds: 16
input bytes for uint8 output, 4 for float32. Where the input and the
output line up (:func:`vector_aligned`), each plane stretch runs as a
head, vectors and a tail; otherwise byte by byte.

The finalize computes in float32 in the order of the plain versions
(:func:`sum256`, :func:`scan256`, true divisions, and the products by a
reciprocal of :func:`_reciprocal`), so its LUT is the plain LUT bit for bit
on the same counts.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from stainx_tpu_torch import kernels, profiling

_OUT_DTYPES = (torch.uint8, torch.float32)
MIN_BLOCK_VALUES = 32_768  # values a 512-thread histogram block counts at least
MIN_APPLY_VALUES = 4_096  # values a 256-thread apply block looks up at least
APPLY_BLOCK_VALUES = 16_384  # and at most: short blocks, many in turn
APPLY_BLOCKS_PER_SM = 8  # apply blocks of 256 threads an SM that fill the card


# --------------------------------------------------------- plain versions
def _as_ncp(values_u8: torch.Tensor, what: str) -> torch.Tensor:
    if values_u8.dtype != torch.uint8:
        raise TypeError(f"{what} takes uint8 values, got {values_u8.dtype}")
    if values_u8.dim() == 2:
        return values_u8[None]
    if values_u8.dim() != 3:
        raise ValueError(f"{what} expects (N, C, P) or (C, P) values, got shape {tuple(values_u8.shape)}")
    return values_u8


def _flat_index(values: torch.Tensor) -> torch.Tensor:
    """c·256 + v for every element of (N, C, P) uint8, as int64."""
    chan = torch.arange(values.shape[1], device=values.device).reshape(1, -1, 1)
    return chan * 256 + values.long()


def histogram_256_plain(values_u8: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the histogram kernel (B8a/B8c): one
    ``bincount`` over c·256 + v."""
    values = _as_ncp(values_u8, "histogram_256")
    c = values.shape[1]
    counts = torch.bincount(_flat_index(values).reshape(-1), minlength=c * 256)
    return counts.reshape(c, 256).to(torch.float32)


# The LUT is sensitive to the last ulp of its sums: an interpolated entry
# divides by a quantile step (~1/900 at a few thousand pixels), so one ulp
# of a CDF value moves it by ~1e-4. The two helpers below add in float32 in
# the order XLA's CPU backend takes for the JAX package's ``sum`` and
# ``cumsum`` over 256 bins, as elementwise additions, which round alike on
# every device (``torch.sum`` and ``torch.cumsum`` do not: the CPU
# accumulates in double, CUDA in a tree). The finalize kernel adds in the
# same order.


def sum256(x: torch.Tensor) -> torch.Tensor:
    """Float32 sums of the rows of (R, 256) ``x``, (R, 1): eight windows of
    32 summed sequentially, then the eight window sums sequentially (XLA's
    tree-reduction rewrite of a 256-long reduce)."""
    windows = x.reshape(x.shape[0], 8, 32)
    part = windows[..., 0]
    for j in range(1, 32):
        part = part + windows[..., j]
    total = part[:, 0]
    for k in range(1, 8):
        total = total + part[:, k]
    return total[:, None]


def scan256(x: torch.Tensor) -> torch.Tensor:
    """Inclusive float32 prefix sums of the rows of (R, 256) ``x``:
    sequentially within blocks of 16, sequentially over the 16 block totals,
    then each block's exclusive prefix added to it (XLA's rewrite of a
    256-long cumsum)."""
    blocks = x.reshape(x.shape[0], 16, 16)
    cols = [blocks[..., 0]]
    for j in range(1, 16):
        cols.append(cols[-1] + blocks[..., j])
    inner = torch.stack(cols, dim=-1)
    totals = [inner[:, 0, -1]]
    for k in range(1, 16):
        totals.append(totals[-1] + inner[:, k, -1])
    before = torch.stack([torch.zeros_like(totals[0]), *totals[:-1]], dim=-1)
    return (inner + before[..., None]).reshape(x.shape)


def _reciprocal(v: float) -> float:
    """``float32(1 / float32(v))``. The JAX package divides by constants of
    its compiled programs (the pixel count of a transform, 255 for float
    output), and XLA folds such a division into a product with the
    constant's float32 reciprocal, which rounds differently from the
    division at most counts that are not a power of two. The port takes the
    same product."""
    return float(np.float32(1.0) / np.float32(v))


def normalized_histogram(counts: torch.Tensor) -> torch.Tensor:
    """``counts / (sum + 1e-8)`` of (C, 256) float32 counts, the 1e-8 added
    in float32: the plain version of the fit's finalize."""
    return counts / (sum256(counts) + 1e-8)


def hm_build_lut(
    source_counts: torch.Tensor, ref_hist: torch.Tensor, num_pixels: float
) -> torch.Tensor:
    """The per-channel 256-entry LUT, (C, 256) float32 in [0, 255]: the
    plain version of the transform's finalize.

    ``source_counts``: (C, 256) raw counts; ``ref_hist``: (C, 256) reference
    histogram (any normalization). Every guard of the JAX function, bit for
    bit: ``searchsorted`` (left) clipped to [1, 255], the ``q_diff > 1e-10``
    gate, the below-min pin with a 3-ulp slack on ``rq0`` (self-matching
    ties must not depend on rounding), the above-max pin decided by
    occupancy (a bin pins iff no occupied source bin lies after it) rather
    than by a float compare, and the two degenerate-channel gates: an
    all-empty source channel does not pin above, an all-empty reference
    channel pins every bin to 255.

    The row sum and the two cumulative sums add in the JAX package's order
    (:func:`sum256`, :func:`scan256`), so the LUT is the same on the CPU
    and the card and follows the JAX one step for step.
    """
    source_counts = source_counts.to(torch.float32)
    ref_hist = ref_hist.to(torch.float32)
    # The JAX function divides by num_pixels + 1e-8, a constant of the
    # compiled transform: a product with its reciprocal (:func:`_reciprocal`).
    source_norm = source_counts * source_counts.new_full((1, 1), _reciprocal(num_pixels + 1e-8))
    ref_norm = normalized_histogram(ref_hist)
    source_cdf, ref_quantiles = scan256(torch.cat([source_norm, ref_norm])).split(
        source_norm.shape[0]
    )

    indices = torch.searchsorted(ref_quantiles, source_cdf, side="left")
    indices = torch.clamp(indices, 1, 255)
    q_left = torch.gather(ref_quantiles, 1, indices - 1)
    q_right = torch.gather(ref_quantiles, 1, indices)
    q_diff = q_right - q_left
    alpha = torch.where(q_diff > 1e-10, (source_cdf - q_left) / q_diff, 0.0)
    lut = (indices - 1).to(torch.float32) + alpha

    rq0 = ref_quantiles[:, 0:1]
    below_min = source_cdf <= rq0 * (1.0 + 3.0 * 2.0**-23)
    occ = (source_counts > 0).to(torch.int32)
    occ_at_or_after = torch.flip(torch.cumsum(torch.flip(occ, [1]), dim=1), [1])
    has_occ = occ_at_or_after[:, 0:1] > 0
    ref_empty = ref_quantiles[:, -1:] <= 0.0
    above_max = (((occ_at_or_after - occ) == 0) & has_occ) | ref_empty
    lut = torch.where(below_min, 0.0, lut)
    lut = torch.where(above_max, 255.0, lut)
    return torch.clamp(lut, 0.0, 255.0)


def lut_table(lut: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """The (C, 256) table the apply kernel looks up: ``⌊clip(lut, 0, 255)⌋``
    as uint8, or ``clip(lut / 255, 0, 1)`` as float32, the division taken
    as the JAX package's compiled transform takes it: a product with
    ``_reciprocal(255)``, as the finalize's."""
    lut = lut.to(torch.float32)
    if out_dtype == torch.uint8:
        return torch.floor(torch.clamp(lut, 0.0, 255.0)).to(torch.uint8).contiguous()
    return torch.clamp(lut * lut.new_full((), _reciprocal(255.0)), 0.0, 1.0).contiguous()


def apply_lut_plain(values_u8, lut, out_dtype: torch.dtype = torch.uint8) -> torch.Tensor:
    """Plain PyTorch version of the LUT-apply kernel (B8b): a gather from
    the flattened table."""
    _check_apply(values_u8, lut, out_dtype)
    table = lut_table(torch.as_tensor(lut).to(values_u8.device), out_dtype)
    return table.reshape(-1)[_flat_index(values_u8)]


def hm_transfer_plain(values_u8: torch.Tensor, ref_hist: torch.Tensor, out_dtype: torch.dtype):
    """Plain version of :func:`hm_transfer`: the counts, :func:`hm_build_lut`,
    :func:`lut_table` and the lookup, as ``(out, lut, table)``."""
    n, _c, p = values_u8.shape
    lut = hm_build_lut(histogram_256_plain(values_u8), ref_hist.to(values_u8.device), float(n * p))
    table = lut_table(lut, out_dtype)
    return table.reshape(-1)[_flat_index(values_u8)], lut, table


# --------------------------------------------------------------- wrappers
def _check_apply(values_u8, lut, out_dtype) -> None:
    if values_u8.dtype != torch.uint8:
        raise TypeError(f"apply_lut takes uint8 values, got {values_u8.dtype}")
    if values_u8.dim() != 3:
        raise ValueError(f"apply_lut expects (N, C, P) values, got shape {tuple(values_u8.shape)}")
    if tuple(lut.shape) != (values_u8.shape[1], 256):
        raise ValueError(f"apply_lut needs a ({values_u8.shape[1]}, 256) LUT, got {tuple(lut.shape)}")
    if out_dtype not in _OUT_DTYPES:
        raise TypeError(f"apply_lut writes uint8 or float32, not {out_dtype}")


def _lib() -> ctypes.CDLL:
    lib = kernels.library("histogram")
    if not getattr(lib, "_stainx_declared", False):
        ptr, i64, i32, f32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
        lib.stainx_histogram_256.argtypes = [ptr, ptr, ptr, i64, i64, i32, i32, i64, ptr]
        lib.stainx_histogram_256.restype = i32
        lib.stainx_hm_fit.argtypes = [ptr, ptr, ptr, i64, i64, i32, i32, i64, ptr]
        lib.stainx_hm_fit.restype = i32
        lib.stainx_hm_transform.argtypes = (
            [ptr] * 6 + [i64, i64, i32, i32, i64, f32, i32, i32, i32, i64] + [ptr] * 5
        )
        lib.stainx_hm_transform.restype = i32
        lib.stainx_hm_lut.argtypes = [ptr, ptr, ptr, ptr, i32, f32, i32, ptr]
        lib.stainx_hm_lut.restype = i32
        lib.stainx_apply_lut.argtypes = [ptr, ptr, ptr, i64, i64, i32, i32, i64, i32, i32, ptr]
        lib.stainx_apply_lut.restype = i32
        lib._stainx_declared = True
    return lib


def hist_split(n: int, c: int, p: int, sms: int) -> tuple[int, int]:
    """(blocks a channel, values a block) of a histogram launch over (N, C,
    P) values: about four blocks an SM over all channels, each counting at
    least :data:`MIN_BLOCK_VALUES` of its channel's N·P values (a multiple
    of 16), one block for an empty input."""
    total = n * p
    want = max(1, min(-(-4 * sms // c), -(-total // MIN_BLOCK_VALUES)))
    chunk = max(16, kernels.ceil_to(-(-total // want), 16))
    return max(1, -(-total // chunk)), chunk


def _hist_args(values: torch.Tensor, what: str):
    """Checks, the partials scratch and the launch shape of a histogram
    launch: (partials, n, p, c, blocks a channel, chunk)."""
    kernels.check_cuda(values, what)
    n, c, p = values.shape
    if n * p >= 2**31:
        raise ValueError(f"{what} counts in int32: at most 2^31 - 1 values a channel, got {n * p}")
    bpc, chunk = hist_split(n, c, p, kernels.device_limits(values.device.index)[0])
    if c * bpc > kernels.MAX_GRID_X:
        raise ValueError(f"{what}: {c} channels of {bpc} blocks exceed a grid")
    partials = torch.empty((c * bpc, 256), dtype=torch.int32, device=values.device)
    return partials, n, p, c, bpc, chunk


def apply_split(n: int, c: int, p: int, sms: int) -> tuple[int, int]:
    """(blocks a channel, values a block) of a LUT-apply launch over (N, C,
    P) values. A block looks up a stretch of its channel's N·P values (a
    multiple of 16): enough blocks to give each SM
    :data:`APPLY_BLOCKS_PER_SM` over all channels, each stretch kept
    between :data:`MIN_APPLY_VALUES` and :data:`APPLY_BLOCK_VALUES`, so a
    large input is many short blocks; one block for an empty input.
    Raises where the blocks exceed a grid."""
    total = n * p
    fill = -(-APPLY_BLOCKS_PER_SM * sms // c)
    chunk = kernels.ceil_to(min(max(-(-total // fill), MIN_APPLY_VALUES), APPLY_BLOCK_VALUES), 16)
    bpc = max(1, -(-total // chunk))
    if c * bpc > kernels.MAX_GRID_X:
        raise ValueError(f"apply_lut: {c} channels of {bpc} blocks exceed a grid")
    return bpc, chunk


def vector_aligned(values: torch.Tensor, out: torch.Tensor) -> bool:
    """Whether the apply kernel runs vectors over the planes of (N, C, P)
    uint8 ``values`` into ``out``: where the input sits on a vector
    boundary (16 bytes for uint8 output, 4 for float32), the output sits on
    a 16-byte one, which holds when ``out.data_ptr() - out.element_size()
    * values.data_ptr()`` is a multiple of 16; and a plane of P ≥ 32 values
    holds a whole vector wherever it starts."""
    lined_up = (out.data_ptr() - out.element_size() * values.data_ptr()) % 16 == 0
    return lined_up and values.shape[2] >= 32


def _apply_launch(values: torch.Tensor, out: torch.Tensor) -> tuple[int, int, int]:
    """(vector walk, blocks a channel, values a block) of an apply launch,
    the vector walk counted in ``lut.vector``."""
    n, c, p = values.shape
    vec = vector_aligned(values, out)
    if vec:
        profiling.count("lut.vector")
    return (int(vec), *apply_split(n, c, p, kernels.device_limits(values.device.index)[0]))


def histogram_256(values_u8: torch.Tensor) -> torch.Tensor:
    """Per-channel 256-bin counts (B8a, and B8c for a (C, P) input): (N, C,
    P) or (C, P) uint8 → (C, 256) float32. One C call: the histogram kernel
    and its finalize."""
    with profiling.annotate("stainx.kernel.B8a"):
        values = _as_ncp(values_u8, "histogram_256")
        if values.device.type == "cpu":
            return histogram_256_plain(values)
        partials, n, p, c, bpc, chunk = _hist_args(values, "histogram_256")
        counts = torch.empty((c, 256), dtype=torch.float32, device=values.device)
        lib = _lib()
        with kernels.on_device(values.device):
            code = lib.stainx_histogram_256(values.data_ptr(), partials.data_ptr(),
                                            counts.data_ptr(), n, p, c, bpc, chunk,
                                            kernels.current_stream(values.device))
        kernels.check(lib, code, "histogram_256")
        profiling.count("launch.B8a")
        return counts


def hm_reference(values_u8: torch.Tensor) -> torch.Tensor:
    """The fit's reference histograms of (N, C, P) uint8: (C, 256) float32
    ``counts / (sum + 1e-8)``. One C call: the histogram kernel and a
    finalize that normalizes."""
    with profiling.annotate("stainx.kernel.B8a"):
        values = _as_ncp(values_u8, "hm_reference")
        if values.device.type == "cpu":
            return normalized_histogram(histogram_256_plain(values))
        partials, n, p, c, bpc, chunk = _hist_args(values, "hm_reference")
        hist = torch.empty((c, 256), dtype=torch.float32, device=values.device)
        lib = _lib()
        with kernels.on_device(values.device):
            code = lib.stainx_hm_fit(values.data_ptr(), partials.data_ptr(), hist.data_ptr(),
                                     n, p, c, bpc, chunk, kernels.current_stream(values.device))
        kernels.check(lib, code, "hm_reference")
        profiling.count("launch.B8a")
        return hist


def hm_transfer(values_u8: torch.Tensor, ref_hist: torch.Tensor, out_dtype: torch.dtype):
    """The histogram-matching transform of (N, C, P) uint8 to the (C, 256)
    reference histograms: ``(out, lut, table)``, out (N, C, P) of
    ``out_dtype`` (uint8, or float32 in [0, 1]), the (C, 256) float32 LUT
    of :func:`hm_build_lut` and the table looked up. One C call: the
    histogram kernel, a finalize that builds the LUT and the table, and the
    apply kernel on that table."""
    with profiling.annotate("stainx.kernel.B8"):
        _check_apply(values_u8, ref_hist, out_dtype)
        if values_u8.device.type == "cpu":
            return hm_transfer_plain(values_u8, ref_hist, out_dtype)
        partials, n, p, c, bpc, chunk = _hist_args(values_u8, "hm_transfer")
        dev = values_u8.device
        ref = torch.as_tensor(ref_hist).to(device=dev, dtype=torch.float32).contiguous()
        lut = torch.empty((c, 256), dtype=torch.float32, device=dev)
        table = torch.empty((c, 256), dtype=out_dtype, device=dev)
        out = torch.empty(values_u8.shape, dtype=out_dtype, device=dev)
        lib = _lib()
        call = (values_u8.data_ptr(), out.data_ptr(), partials.data_ptr(), ref.data_ptr(),
                lut.data_ptr(), table.data_ptr(), n, p, c, bpc, chunk,
                _reciprocal(float(n * p) + 1e-8), int(out_dtype == torch.float32),
                *_apply_launch(values_u8, out), kernels.current_stream(dev))
        launch = profiling.launch_events(dev) or (None, None)
        with kernels.on_device(dev), profiling.caller_timed("stainx.stats", dev) as events:
            code = lib.stainx_hm_transform(*call, *(events or (None, None)), *launch)
        kernels.check(lib, code, "hm_transfer")
        profiling.count("launch.B8a")
        profiling.count("launch.B8b")
        return out, lut, table


def hm_lut(counts: torch.Tensor, ref_hist: torch.Tensor, num_pixels: int, out_dtype: torch.dtype):
    """The transform's finalize alone on given (C, 256) counts: ``(lut,
    table)`` as :func:`hm_transfer` builds them for values with these
    counts and ``num_pixels`` values a channel (on the CPU
    :func:`hm_build_lut` and :func:`lut_table`). Not counted as a launch of
    the histogram."""
    if tuple(ref_hist.shape) != tuple(counts.shape) or counts.dim() != 2 or counts.shape[1] != 256:
        raise ValueError(f"hm_lut needs (C, 256) counts and reference histograms, got "
                         f"{tuple(counts.shape)} and {tuple(ref_hist.shape)}")
    if out_dtype not in _OUT_DTYPES:
        raise TypeError(f"hm_lut writes a uint8 or float32 table, not {out_dtype}")
    if counts.device.type == "cpu":
        lut = hm_build_lut(counts.to(torch.float32), ref_hist, float(num_pixels))
        return lut, lut_table(lut, out_dtype)
    kernels.check_cuda(counts, "hm_lut")
    dev = counts.device
    c = counts.shape[0]
    counts_i32 = counts.to(torch.int32).contiguous()
    ref = torch.as_tensor(ref_hist).to(device=dev, dtype=torch.float32).contiguous()
    lut = torch.empty((c, 256), dtype=torch.float32, device=dev)
    table = torch.empty((c, 256), dtype=out_dtype, device=dev)
    lib = _lib()
    with kernels.on_device(dev):
        code = lib.stainx_hm_lut(counts_i32.data_ptr(), ref.data_ptr(), lut.data_ptr(),
                                 table.data_ptr(), c, _reciprocal(float(num_pixels) + 1e-8),
                                 int(out_dtype == torch.float32),
                                 kernels.current_stream(counts.device))
    kernels.check(lib, code, "hm_lut")
    return lut, table


def apply_lut(values_u8: torch.Tensor, lut: torch.Tensor, out_dtype: torch.dtype = torch.uint8):
    """Per-channel LUT apply (B8b): (N, C, P) uint8 and a (C, 256) LUT →
    (N, C, P) ``out_dtype``: uint8 ``⌊clip(lut[c, v], 0, 255)⌋`` or float32
    ``clip(lut[c, v] / 255, 0, 1)``. One launch a call: each block walks
    a stretch of one channel's planes (:func:`apply_split`), in vectors
    where :func:`vector_aligned` holds (counted in ``lut.vector``), byte
    by byte where it does not."""
    with profiling.annotate("stainx.kernel.B8b"):
        _check_apply(values_u8, lut, out_dtype)
        if values_u8.device.type == "cpu":
            return apply_lut_plain(values_u8, lut, out_dtype)
        kernels.check_cuda(values_u8, "apply_lut")
        table = lut_table(torch.as_tensor(lut).to(values_u8.device), out_dtype)
        out = torch.empty(values_u8.shape, dtype=out_dtype, device=values_u8.device)
        if out.numel() == 0:
            return out
        n, c, p = values_u8.shape
        vec, bpc, chunk = _apply_launch(values_u8, out)
        lib = _lib()
        with kernels.on_device(values_u8.device):
            code = lib.stainx_apply_lut(
                values_u8.data_ptr(), out.data_ptr(), table.data_ptr(), n, p, c, bpc, chunk,
                int(out_dtype == torch.float32), vec, kernels.current_stream(values_u8.device),
            )
        kernels.check(lib, code, "apply_lut")
        profiling.count("launch.B8b")
        return out

