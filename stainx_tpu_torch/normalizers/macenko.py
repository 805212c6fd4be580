"""Macenko normalizer (counterpart of ``stainx_tpu/normalizers/macenko.py``).

Fitted state: ``_stain_matrix`` (3, 2) H/E columns and ``_target_max_conc``
(2,). ``normalize_to_0_1`` defaults to False (output ~[0, 255]).
"""

from __future__ import annotations

import torch

from stainx_tpu_torch.normalizers._template import NormalizerTemplate
from stainx_tpu_torch.ops import macenko as macenko_ops

_VALID_PRECISION = ("stable", "fast")


class Macenko(NormalizerTemplate):
    """Macenko stain normalization (OD eigen-plane + percentile stain vectors).

    Parameters
    ----------
    device : ``None`` (``cuda:0``, raises without CUDA), ``"cuda[:i]"`` or
        ``"cpu"``. On CUDA, fit and transform run the hand-written kernels;
        on the CPU, their plain PyTorch versions.
    normalize_to_0_1 : bool
        Divide output by 255 so results land in [0, 1]. Default False. On
        float32 input on CUDA the transform kernels' store does the
        division (a product with the float32 reciprocal, as PyTorch's
        ``/ 255.0`` on the card: the same bits); elsewhere it is an eager
        division after the transform.
    precision : {"stable", "fast"}
        Validated at construction. As on the JAX package's ``pallas``
        backend: for uint8 and float32 input both run the same exact
        kernels, so ``fast`` trades nothing there; for every other dtype
        (bfloat16, float16, float64: the staged route) ``fast`` runs the
        reconstruction in bfloat16, and the statistics, selections and
        solves stay float32 and exact.

    Non-finite float pixels are not validated; results on them are
    unspecified, and the CUDA and plain routes may differ there.
    """

    def __init__(
        self,
        device: str | torch.device | None = None,
        normalize_to_0_1: bool = False,
        precision: str = "stable",
    ):
        if precision not in _VALID_PRECISION:
            raise ValueError(f"precision must be 'stable' or 'fast', got {precision!r}")
        self._precision = precision
        self.normalize_to_0_1 = normalize_to_0_1
        super().__init__(device=device)

    @property
    def precision(self) -> str:
        """``"stable"`` or ``"fast"``, as constructed."""
        return self._precision

    def _init_algorithm_attributes(self):
        self._stain_matrix = None
        self._target_max_conc = None

    def _state_attrs(self):
        return ("_stain_matrix", "_target_max_conc")

    def _compute_reference_params(self, images: torch.Tensor) -> None:
        self._validate_layout(images, "fit")
        self._stain_matrix, self._target_max_conc = macenko_ops.macenko_fit(images)

    def _validate_fitted_params(self) -> None:
        """Gate restored state shapes at the API boundary."""
        if tuple(self._stain_matrix.shape) != (3, 2):
            raise ValueError(
                f"stain_matrix must have shape (3, 2), got {tuple(self._stain_matrix.shape)}"
            )
        if self._target_max_conc.numel() != 2:
            raise ValueError(
                "target_max_conc must have 2 entries (one per stain), got shape "
                f"{tuple(self._target_max_conc.shape)}"
            )

    def _transform_impl(self, images: torch.Tensor) -> torch.Tensor:
        self._validate_layout(images, "transform")
        self._validate_fitted_params()
        scale = macenko_ops.UNIT_SCALE if self._folds_range(images) else 1.0
        return macenko_ops.macenko_transform(
            images, self._stain_matrix, self._target_max_conc, precision=self._precision,
            scale=scale,
        )

    def _folds_range(self, images: torch.Tensor) -> bool:
        """The ÷255 goes into the kernels' store for float32 input on CUDA:
        there a kernel writes the output, in the input's dtype. uint8 output
        takes no scale, the staged dtypes run no transform kernel, and the
        CPU keeps the eager division's bits."""
        return bool(self.normalize_to_0_1) and images.dtype == torch.float32 and images.is_cuda

    @staticmethod
    def _validate_layout(images: torch.Tensor, stage: str) -> None:
        if images.dim() != 4:
            raise ValueError(f"Macenko {stage} expects NCHW images, got shape {tuple(images.shape)}")
        if images.shape[1] != 3:
            raise ValueError(
                f"Macenko {stage} expects 3 channels in dim 1 (NCHW), got C={images.shape[1]} "
                f"with shape {tuple(images.shape)}"
            )
