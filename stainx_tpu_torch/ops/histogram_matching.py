"""Histogram matching on tensors: per-channel 256-bin CDF matching.

Counterpart of ``stainx_tpu/ops/histogram_matching.py``: uint8
quantization, per-channel 256-bin histograms, ``searchsorted`` into the
reference CDF with linear interpolation, edge pinning to bins 0 and 255,
and a 256-entry LUT per channel. The histogram and the LUT apply route to
the kernel wrappers of :mod:`stainx_tpu_torch.kernels.histogram` (a CUDA
tensor launches the kernels, a CPU tensor runs their plain versions); the
(C, 256) LUT is built here in plain PyTorch, on the device of the data.

On CUDA a uint8 batch runs histogram → LUT → uint8 apply, the JAX
package's ``use_pallas`` uint8 route; a float batch is quantized to uint8,
runs the same histogram, then the float form of the apply,
``clip(lut[v] / 255, 0, 1)``, the function the JAX XLA route computes for
floats, and is cast back to its dtype. NHWC batches (``channel_axis`` −1
or 3) are copied to NCHW for the kernels and returned as an NHWC view.
"""

from __future__ import annotations

import torch

from stainx_tpu_torch.kernels import histogram as hist_kernels
from stainx_tpu_torch.ops import color


def histogram_256(values_u8: torch.Tensor) -> torch.Tensor:
    """Per-channel 256-bin counts: (C, P) uint8 → (C, 256) float32."""
    return hist_kernels.histogram_256(values_u8.contiguous())


def _histogram_nchw(images_u8: torch.Tensor) -> torch.Tensor:
    """(N, C, H, W) uint8 → (C, 256) float32 counts, read as (N, C, H·W)
    without a channel transpose."""
    n, c, h, w = images_u8.shape
    return hist_kernels.histogram_256(images_u8.contiguous().reshape(n, c, h * w))


def hm_fit(images: torch.Tensor, channel_axis: int = 1) -> torch.Tensor:
    """Reference histograms, (C, 256) float32, each row normalized by
    ``counts / (row sum + 1e-8)``."""
    images_cf, _ = color._nchw(images, channel_axis)
    images_u8, _ = color.images_to_uint8(images_cf)
    counts = _histogram_nchw(images_u8)
    return counts / (_sum256(counts) + 1e-8)


# The LUT is sensitive to the last ulp of its sums: an interpolated entry
# divides by a quantile step (~1/900 at a few thousand pixels), so one ulp
# of a CDF value moves it by ~1e-4. The two helpers below add in float32 in
# the order XLA's CPU backend takes for the JAX package's ``sum`` and
# ``cumsum`` over 256 bins, as elementwise additions, which round alike on
# every device (``torch.sum`` and ``torch.cumsum`` do not: the CPU
# accumulates in double, CUDA in a tree).


def _sum256(x: torch.Tensor) -> torch.Tensor:
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


def _scan256(x: torch.Tensor) -> torch.Tensor:
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


def hm_build_lut(
    source_counts: torch.Tensor, ref_hist: torch.Tensor, num_pixels: float
) -> torch.Tensor:
    """The per-channel 256-entry LUT, (C, 256) float32 in [0, 255].

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
    (:func:`_sum256`, :func:`_scan256`), so the LUT is the same on the CPU
    and the card and follows the JAX one step for step.
    """
    source_counts = source_counts.to(torch.float32)
    ref_hist = ref_hist.to(torch.float32)
    # A tensor divisor: PyTorch divides by a Python scalar on CUDA as a
    # multiplication by its reciprocal, which can round differently.
    source_norm = source_counts / source_counts.new_full((1, 1), num_pixels + 1e-8)
    ref_norm = ref_hist / (_sum256(ref_hist) + 1e-8)
    source_cdf, ref_quantiles = _scan256(torch.cat([source_norm, ref_norm])).split(
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


def hm_transform(
    images: torch.Tensor, ref_histograms: torch.Tensor, channel_axis: int = 1
) -> torch.Tensor:
    """Match each channel's histogram to ``ref_histograms`` (C, 256). The
    output has the input's layout and dtype (uint8 in [0, 255], floats in
    [0, 1])."""
    original_dtype = images.dtype
    images_cf, needs_permute = color._nchw(images, channel_axis)
    images_u8, needs_scale_back = color.images_to_uint8(images_cf)
    n, c, h, w = images_u8.shape
    values = images_u8.contiguous().reshape(n, c, h * w)

    source_counts = hist_kernels.histogram_256(values)
    lut = hm_build_lut(source_counts, ref_histograms.to(values.device), float(n * h * w))
    if needs_scale_back:
        result = hist_kernels.apply_lut(values, lut, torch.float32).to(original_dtype)
    else:
        result = hist_kernels.apply_lut(values, lut, torch.uint8)
    result = result.reshape(n, c, h, w)
    return result.permute(0, 2, 3, 1) if needs_permute else result
