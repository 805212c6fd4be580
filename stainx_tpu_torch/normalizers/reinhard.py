"""Reinhard normalizer (counterpart of ``stainx_tpu/normalizers/reinhard.py``).

Fitted state: ``_reference_mean`` and ``_reference_std``, the per-channel
LAB statistics of the reference, shape (3,).
"""

from __future__ import annotations

import torch

from stainx_tpu_torch.normalizers._template import NormalizerTemplate
from stainx_tpu_torch.ops import reinhard as reinhard_ops


class Reinhard(NormalizerTemplate):
    """Reinhard stain normalization (LAB mean / std transfer).

    Parameters
    ----------
    device : ``None`` (``cuda:0``, raises without CUDA), ``"cuda[:i]"`` or
        ``"cpu"``. On CUDA, fit and transform run the hand-written kernels;
        on the CPU, their plain PyTorch versions.

    Source statistics are taken over the whole batch (N·H·W at once).
    """

    def _init_algorithm_attributes(self):
        self._reference_mean = None
        self._reference_std = None

    def _state_attrs(self):
        return ("_reference_mean", "_reference_std")

    def _compute_reference_params(self, images: torch.Tensor) -> None:
        self._validate_layout(images)
        self._reference_mean, self._reference_std = reinhard_ops.reinhard_fit(images)

    def _transform_impl(self, images: torch.Tensor) -> torch.Tensor:
        self._validate_layout(images)
        return reinhard_ops.reinhard_transform(images, self._reference_mean, self._reference_std)

    @staticmethod
    def _validate_layout(images: torch.Tensor) -> None:
        if images.dim() != 4 or images.shape[1] != 3:
            raise ValueError(
                f"Reinhard expects NCHW images with C=3, got shape {tuple(images.shape)}"
            )
