"""Histogram-matching normalizer (counterpart of
``stainx_tpu/normalizers/histogram_matching.py``).

Fitted state: ``_ref_histograms_256``, the (C, 256) normalized reference
histograms. ``_reference_histogram``, ``_ref_cdf`` and ``_ref_vals`` are
derived views, kept for API compatibility; the transform reads only the
256-bin histograms.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from stainx_tpu_torch.normalizers._template import NormalizerTemplate
from stainx_tpu_torch.ops import histogram_matching as hm_ops
from stainx_tpu_torch.ops.color import CHANNEL_AXES


def _host(hists: Any) -> np.ndarray:
    if torch.is_tensor(hists):
        return hists.detach().cpu().numpy()
    return np.asarray(hists)


class HistogramMatching(NormalizerTemplate):
    """Per-channel 256-bin histogram matching.

    Parameters
    ----------
    device : ``None`` (``cuda:0``, raises without CUDA), ``"cuda[:i]"`` or
        ``"cpu"``. On CUDA the histogram and the LUT apply run the
        hand-written kernels; on the CPU, their plain PyTorch versions.
    channel_axis : 1 / -3 for NCHW (default), -1 / 3 for NHWC. Any channel
        count is accepted.
    """

    def __init__(self, device: str | torch.device | None = None, channel_axis: int = 1):
        if channel_axis not in CHANNEL_AXES:
            raise ValueError(
                f"channel_axis must be one of {CHANNEL_AXES} (1/-3 NCHW, -1/3 NHWC), "
                f"got {channel_axis}"
            )
        self.channel_axis = channel_axis
        super().__init__(device=device)

    def _init_algorithm_attributes(self):
        self._ref_histograms_256 = None

    def _state_attrs(self):
        return ("_ref_histograms_256",)

    # Derived views of the fitted state.
    @property
    def _reference_histogram(self):
        """The first channel's full 256-bin CDF."""
        if self._ref_histograms_256 is None:
            return None
        return torch.cumsum(torch.as_tensor(self._ref_histograms_256)[0], dim=0)

    @property
    def _ref_cdf(self):
        """Per-channel CDFs over the bins with a non-zero count (host numpy,
        variable length; 256 zeros for an empty channel)."""
        if self._ref_histograms_256 is None:
            return None
        out = []
        for hist in _host(self._ref_histograms_256):
            nz = np.nonzero(hist)[0]
            if len(nz) > 0:
                cdf = np.cumsum(hist[nz])
                out.append(cdf / (cdf[-1] + 1e-8))
            else:
                out.append(np.zeros(256, np.float32))
        return out

    @property
    def _ref_vals(self):
        """Per-channel bin values with a non-zero count (all 256 for an
        empty channel)."""
        if self._ref_histograms_256 is None:
            return None
        out = []
        for hist in _host(self._ref_histograms_256):
            nz = np.nonzero(hist)[0]
            out.append(nz.astype(np.float32) if len(nz) > 0 else np.arange(256, dtype=np.float32))
        return out

    def _compute_reference_params(self, images: torch.Tensor) -> None:
        self._validate_layout(images)
        self._ref_histograms_256 = hm_ops.hm_fit(images, channel_axis=self.channel_axis)

    def _transform_impl(self, images: torch.Tensor) -> torch.Tensor:
        self._validate_layout(images)
        ref = self._coerce_reference(self._ref_histograms_256, images)
        return hm_ops.hm_transform(images, ref, channel_axis=self.channel_axis)

    def _coerce_reference(self, ref: Any, images: torch.Tensor) -> torch.Tensor:
        """(C, 256) tensors pass (cut to C rows); a list of per-channel
        histograms is cut or padded (with its last entry) to C; a single 1-D
        256-bin histogram is broadcast to every channel."""
        c = images.shape[1] if self.channel_axis in (1, -3) else images.shape[-1]

        def as_f32(h):
            h = h if torch.is_tensor(h) else torch.as_tensor(np.array(h))
            return h.to(device=self.device, dtype=torch.float32)

        if isinstance(ref, (list, tuple)):
            hists = [as_f32(h) for h in ref][:c]
            while len(hists) < c:
                hists.append(hists[-1])
            return torch.stack(hists)
        ref = as_f32(ref)
        if ref.dim() == 1:
            return ref.expand(c, 256)
        return ref[:c]

    @staticmethod
    def _validate_layout(images: torch.Tensor) -> None:
        if images.dim() != 4:
            raise ValueError(
                f"HistogramMatching expects 4D batches, got shape {tuple(images.shape)}"
            )
