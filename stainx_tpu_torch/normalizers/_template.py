"""Normalizer template: inputs, the fitted gate, state save/load, devices.

Counterpart of ``stainx_tpu/normalizers/_template.py``. There is no backend
knob: the device decides the route (CUDA runs the hand-written kernels, the
CPU runs their plain PyTorch versions). ``fit``, ``transform`` and the
÷255 are the spans ``stainx.fit``, ``stainx.transform`` and
``stainx.finalize``, each with its device interval
(:mod:`stainx_tpu_torch.profiling`).

Where the ÷255 of ``normalize_to_0_1`` runs: a normalizer whose transform
kernels write the output already scaled (Macenko on float32 input on CUDA:
the kernels' store multiplies by ``1/255``, :meth:`_folds_range`) runs no
division of its own, and the call counts ``finalize.folded``; every other
call (uint8 input, the staged dtypes, every CPU call, the mesh path of
``StainNormalizerTransform``) divides eagerly in ``_finalize_range``, the
span ``stainx.finalize``. Both give the same bits on the card.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from stainx_tpu_torch import profiling
from stainx_tpu_torch.base import StainNormalizerBase
from stainx_tpu_torch.utils import get_device


class NormalizerTemplate(StainNormalizerBase):
    """Template with the fitted-state gate and state (de)serialization."""

    def __init__(self, device: str | torch.device | None = None):
        super().__init__(device)
        self._init_algorithm_attributes()

    def _init_algorithm_attributes(self):
        """Initialize algorithm-specific fitted-state attributes."""

    # ---------------------------------------------------------------- inputs
    def _as_device_tensor(self, images: Any) -> torch.Tensor:
        """Accept tensors or array-likes (numpy, anything ``np.asarray``
        takes); place them on ``self.device``."""
        if not torch.is_tensor(images):
            images = torch.as_tensor(np.asarray(images))
        return images.to(self.device)

    # ------------------------------------------------------------- fit state
    def fit(self, images: Any) -> "NormalizerTemplate":
        """Fit on reference images; returns self."""
        with profiling.annotate("stainx.fit", device=self.device):
            self._compute_reference_params(self._as_device_tensor(images))
        self._is_fitted = True
        return self

    def transform(self, images: Any) -> torch.Tensor:
        """Transform images with the fitted parameters."""
        with profiling.annotate("stainx.transform", device=self.device):
            if not self._is_fitted:
                raise ValueError("Must call fit() before transform()")
            images = self._as_device_tensor(images)
            result = self._transform_impl(images)
        if self._folds_range(images):
            profiling.count("finalize.folded")
            return result
        return self._finalize_range(result)

    def _finalize_range(self, result: torch.Tensor) -> torch.Tensor:
        """The output value-range contract: ``normalize_to_0_1`` divides by 255."""
        if getattr(self, "normalize_to_0_1", False):
            with profiling.annotate("stainx.finalize", device=result.device):
                result = result / 255.0
        return result

    # ----------------------------------------------------------- state dict
    @property
    def state(self) -> dict[str, Any]:
        """Fitted parameters as a dict of tensors."""
        return {name: getattr(self, name) for name in self._state_attrs()}

    def load_state(self, state: dict[str, Any]) -> "NormalizerTemplate":
        """Restore fitted parameters from :attr:`state` (tensors or arrays);
        marks self fitted when every required entry is present."""
        for name in self._state_attrs():
            value = state.get(name)
            if value is not None:
                if not torch.is_tensor(value):
                    value = torch.tensor(np.asarray(value))
                value = value.to(device=self.device, dtype=torch.float32)
            setattr(self, name, value)
        self._is_fitted = all(getattr(self, n) is not None for n in self._state_attrs())
        return self

    def save_state(self, path: str) -> None:
        """Persist fitted parameters to an ``.npz`` file (the keys of the
        JAX package's files, so either package reads the other's)."""
        if not self._is_fitted:
            raise ValueError("Must call fit() before save_state()")
        np.savez(
            path,
            **{k: v.detach().cpu().numpy() for k, v in self.state.items() if v is not None},
        )

    def load_state_file(self, path: str) -> "NormalizerTemplate":
        """Restore fitted parameters from a :meth:`save_state` file."""
        with np.load(path) as data:
            return self.load_state({k: data[k] for k in data.files})

    def to_device(self, device: str | torch.device | None) -> "NormalizerTemplate":
        """Move the normalizer and its fitted parameters to ``device``."""
        self.device = get_device(device)
        for name in self._state_attrs():
            value = getattr(self, name, None)
            if torch.is_tensor(value):
                setattr(self, name, value.to(self.device))
        return self

    # ------------------------------------------------------- subclass hooks
    def _state_attrs(self) -> tuple[str, ...]:
        raise NotImplementedError

    def _compute_reference_params(self, images: torch.Tensor) -> None:
        raise NotImplementedError

    def _transform_impl(self, images: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def _folds_range(self, images: torch.Tensor) -> bool:
        """Whether :meth:`_transform_impl` writes the output of ``images``
        (on ``self.device``) already in the range :meth:`_finalize_range`
        gives, so that ``transform`` skips the division."""
        return False
