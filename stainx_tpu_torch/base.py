"""Abstract normalizer base: the ``fit / transform / fit_transform`` contract.

Counterpart of ``stainx_tpu/base.py``: holds the resolved device and the
fitted flag; ``fit_transform`` composes ``fit`` then ``transform``.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Any

import torch

from stainx_tpu_torch.utils import get_device


class StainNormalizerBase(ABC):
    """Base class for stain normalizers."""

    def __init__(self, device: str | torch.device | None = None):
        self.device = get_device(device)
        self._is_fitted = False

    @abstractmethod
    def fit(self, images: Any) -> "StainNormalizerBase":
        """Fit the normalizer to reference images. Returns self."""

    @abstractmethod
    def transform(self, images: Any) -> torch.Tensor:
        """Transform images using the fitted normalizer."""

    def fit_transform(self, images: Any) -> torch.Tensor:
        """Fit and transform in one step."""
        self.fit(images)
        return self.transform(images)
