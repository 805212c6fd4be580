"""Histogram matching on tensors: per-channel 256-bin CDF matching.

Counterpart of ``stainx_tpu/ops/histogram_matching.py``: uint8
quantization, per-channel 256-bin histograms, ``searchsorted`` into the
reference CDF with linear interpolation, edge pinning to bins 0 and 255,
and a 256-entry LUT per channel. Both steps route to the kernel wrappers of
:mod:`stainx_tpu_torch.kernels.histogram` (a CUDA tensor launches the
kernels, a CPU tensor runs their plain versions): the fit is the histogram
and a finalize that normalizes it; the transform is the histogram, a
finalize that builds the LUT (:func:`hm_build_lut`, bit for bit) and its
table on the card, and the apply, one C call with nothing issued between
them.

A uint8 batch gets the uint8 table, the JAX package's ``use_pallas`` uint8
route; a float batch is quantized to uint8, runs the same histogram, then
the float form of the table, ``clip(lut[v] / 255, 0, 1)``, the function the
JAX XLA route computes for floats, and is cast back to its dtype. NHWC
batches (``channel_axis`` −1 or 3) are copied to NCHW for the kernels and
returned as an NHWC view.
"""

from __future__ import annotations

import torch

from stainx_tpu_torch.kernels import histogram as hist_kernels
from stainx_tpu_torch.kernels.histogram import hm_build_lut  # noqa: F401 (the LUT's plain form)
from stainx_tpu_torch.ops import color


def histogram_256(values_u8: torch.Tensor) -> torch.Tensor:
    """Per-channel 256-bin counts: (C, P) uint8 → (C, 256) float32."""
    return hist_kernels.histogram_256(values_u8.contiguous())


def hm_fit(images: torch.Tensor, channel_axis: int = 1) -> torch.Tensor:
    """Reference histograms, (C, 256) float32, each row normalized by
    ``counts / (row sum + 1e-8)``: one C call on CUDA (the histogram and a
    finalize that normalizes)."""
    images_cf, _ = color._nchw(images, channel_axis)
    images_u8, _ = color.images_to_uint8(images_cf)
    n, c, h, w = images_u8.shape
    return hist_kernels.hm_reference(images_u8.contiguous().reshape(n, c, h * w))


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

    out_dtype = torch.float32 if needs_scale_back else torch.uint8
    result, _lut, _table = hist_kernels.hm_transfer(values, ref_histograms, out_dtype)
    result = result.to(original_dtype).reshape(n, c, h, w)
    return result.permute(0, 2, 3, 1) if needs_permute else result
