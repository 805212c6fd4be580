"""Normalizer template: inputs, the fitted gate, state save/load, devices.

Counterpart of ``stainx_tpu/normalizers/_template.py``. There is no backend
knob: the device decides the route (CUDA runs the hand-written kernels, the
CPU runs their plain PyTorch versions). ``fit`` is the span ``stainx.fit``,
with its device interval; ``transform`` is the root span ``stainx.transform``
of a public call, which the call timeline samples
(:mod:`stainx_tpu_torch.profiling`).
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
        with profiling.call("stainx.transform"):
            if not self._is_fitted:
                raise ValueError("Must call fit() before transform()")
            return self._transform_impl(self._as_device_tensor(images))

    def _fit_transform_at(self, batch: torch.Tensor, idx: int) -> torch.Tensor:
        """Batch mode's step: fit on image ``idx`` of ``batch``, then
        transform the batch. A normalizer may do both in one pass."""
        self.fit(batch[idx : idx + 1])
        return self.transform(batch)

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
