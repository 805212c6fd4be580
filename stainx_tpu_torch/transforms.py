"""Training-pipeline transform (counterpart of ``stainx_tpu/transforms.py``).

:class:`StainNormalizerTransform` is an :class:`torch.nn.Module`, the
reference's own form, that normalizes each batch inside a training or
inference pipeline. It keeps the JAX package's contracts:

- Modes: ``reference`` (fit once) and ``batch`` (re-fit on
  ``batch[batch_ref_index]`` every call, or on the whole batch when
  ``batch_ref_index`` is None; intentionally mutable).
- Layout: Macenko and Reinhard take NCHW with C=3; ``channel_axis`` applies
  to histogram matching only; NHWC into Macenko or Reinhard raises.
- Value range: uint8 means [0, 255], float always [0, 1].
  ``normalize_to_0_1`` defaults to True for ``method="macenko"`` without a
  prebuilt normalizer.
- Device: ``device=None`` follows a CUDA input tensor's device and moves
  the normalizer (with its fitted state) there; a numpy array or a CPU
  tensor is a host input and goes to the normalizer's device, ``cuda:0`` by
  default. The CPU runs only with ``device="cpu"``.
- Serialization: fitted parameters are not in ``state_dict()``: the
  normalizer is a plain attribute, not a submodule, and holds no buffers.
  Use ``.normalizer.state`` to persist them.

- Mesh: ``mesh=`` (a ``torch.distributed`` ``DeviceMesh``) runs every
  forward through :mod:`stainx_tpu_torch.parallel`, and ``pixel_axis=``
  also shards each image's rows (see :meth:`StainNormalizerTransform.
  __init__`).

The JAX package's ``backend`` is left out: the port has no backend knob
(the device decides the route).
"""

from __future__ import annotations

from typing import Any, Literal

import numpy as np
import torch
from torch import nn

from stainx_tpu_torch import profiling
from stainx_tpu_torch.normalizers import HistogramMatching, Macenko, Reinhard
from stainx_tpu_torch.utils import get_device

MethodName = Literal["macenko", "reinhard", "histogram_matching"]
ModeName = Literal["reference", "batch"]

_METHOD_MAP = {"macenko": Macenko, "reinhard": Reinhard, "histogram_matching": HistogramMatching}
_CHANNELS_FIRST = frozenset({1, -3})
_CHANNELS_LAST = frozenset({-1, 3})


def _check_ref_index(idx: int, n: int) -> None:
    """A batch-mode fit's ``batch_ref_index`` must pick one of ``n`` images."""
    if idx < 0 or idx >= n:
        raise IndexError(f"batch_ref_index={idx} out of range for batch size {n}")


class StainNormalizerTransform(nn.Module):
    """Apply stain normalization inside a training input pipeline."""

    def __init__(
        self,
        method: MethodName = "macenko",
        *,
        mode: ModeName = "reference",
        reference: Any | None = None,
        device: str | torch.device | None = None,
        channel_axis: int = 1,
        batch_ref_index: int | None = 0,
        normalize_to_0_1: bool | None = None,
        normalizer: Any | None = None,
        mesh: Any | None = None,
        pixel_axis: str | None = None,
    ):
        """``mesh``: an optional ``DeviceMesh``
        (:func:`stainx_tpu_torch.parallel.make_mesh`). With it, batches are
        sharded over the mesh's ``"batch"`` axis, transforms run
        batch-parallel, and batch-mode fits reduce their statistics over
        every rank exactly; every rank of the mesh calls the transform, with
        the same global batch or a ``DTensor``. The normalizer (and its
        fitted state) lives on the rank's mesh device unless ``device`` is
        given. ``pixel_axis``: an optional mesh axis to ALSO shard each
        image's rows over, for images beyond one card (any H; padded rows
        are left out of the statistics and cut off the output; see
        :func:`stainx_tpu_torch.parallel.transform_on_mesh`)."""
        super().__init__()
        self.mode = mode
        self.channel_axis = channel_axis
        self.batch_ref_index = batch_ref_index
        self.mesh = mesh
        if pixel_axis is not None and mesh is None:
            raise ValueError("pixel_axis requires mesh= (a torch.distributed DeviceMesh).")
        self.pixel_axis = pixel_axis
        # None = follow a CUDA input's device each call.
        self.device = None if device is None else get_device(device)
        norm_device = self.device
        if norm_device is None and mesh is not None:
            from stainx_tpu_torch.parallel.mesh import mesh_device

            norm_device = mesh_device(mesh)

        if mode not in ("reference", "batch"):
            raise ValueError(f"Unsupported mode '{mode}'. Use 'reference' or 'batch'.")

        explicit_n01 = normalize_to_0_1
        if normalize_to_0_1 is None:
            normalize_to_0_1 = method == "macenko" and normalizer is None

        if normalizer is not None:
            self.normalizer = normalizer
            if isinstance(self.normalizer, Macenko):
                if explicit_n01 is not None:
                    self.normalizer.normalize_to_0_1 = bool(explicit_n01)
            elif explicit_n01:
                raise ValueError("normalize_to_0_1 only applies to Macenko normalizers.")
            if isinstance(self.normalizer, HistogramMatching):
                # Layout follows the prebuilt normalizer.
                norm_axis = int(self.normalizer.channel_axis)
                if channel_axis != 1 and not self._same_channel_layout(channel_axis, norm_axis):
                    raise ValueError(
                        f"channel_axis={channel_axis} conflicts with prebuilt "
                        f"HistogramMatching(channel_axis={norm_axis})."
                    )
                self.channel_axis = norm_axis
            elif channel_axis not in _CHANNELS_FIRST:
                raise ValueError(
                    f"channel_axis={channel_axis} is only supported for histogram_matching; "
                    f"Macenko/Reinhard require NCHW (channel_axis=1)."
                )
        else:
            if method not in _METHOD_MAP:
                raise ValueError(f"Unknown method '{method}'. Choose from {sorted(_METHOD_MAP)}")
            if method != "histogram_matching" and channel_axis not in _CHANNELS_FIRST:
                raise ValueError(
                    f"channel_axis={channel_axis} is only supported for histogram_matching; "
                    f"{method} requires NCHW (channel_axis=1)."
                )
            if explicit_n01 and method != "macenko":
                raise ValueError("normalize_to_0_1 only applies to Macenko (method='macenko').")
            cls = _METHOD_MAP[method]
            if method == "histogram_matching":
                self.normalizer = cls(device=norm_device, channel_axis=channel_axis)
            elif method == "macenko":
                self.normalizer = cls(device=norm_device, normalize_to_0_1=bool(normalize_to_0_1))
            else:
                self.normalizer = cls(device=norm_device)

        # After a prebuilt normalizer may have set channel_axis: the sharded
        # ops are NCHW only.
        if mesh is not None and self.channel_axis not in _CHANNELS_FIRST:
            raise ValueError("mesh execution currently requires NCHW (channel_axis=1).")

        if mode == "reference":
            if reference is None and not getattr(self.normalizer, "_is_fitted", False):
                raise ValueError(
                    "mode='reference' requires a reference tensor (or a pre-fitted normalizer)."
                )
            if reference is not None:
                self.fit_reference(reference)

    # ------------------------------------------------------------ layout
    @staticmethod
    def _same_channel_layout(a: int, b: int) -> bool:
        a_first, b_first = a in _CHANNELS_FIRST, b in _CHANNELS_FIRST
        a_last, b_last = a in _CHANNELS_LAST, b in _CHANNELS_LAST
        return (a_first and b_first) or (a_last and b_last)

    # ------------------------------------------------------------ devices
    def _target_device(self, images: Any) -> torch.device:
        if self.device is not None:
            return self.device
        if torch.is_tensor(images) and images.is_cuda:
            return images.device
        return self.normalizer.device

    def _sync_normalizer_device(self, device: torch.device) -> None:
        """Keep the inner normalizer and its fitted state on the batch's device."""
        if self.normalizer.device != device:
            self.normalizer.to_device(device)

    # ------------------------------------------------------------ forward
    def _validate_layout(self, images: Any) -> torch.Tensor:
        if not torch.is_tensor(images):
            images = torch.as_tensor(np.asarray(images))
        if images.dim() == 3:
            images = images.unsqueeze(0)
        if images.dim() != 4:
            raise ValueError(
                f"Expected CHW/NCHW or HWC/NHWC image tensor, got shape {tuple(images.shape)}"
            )
        if (
            isinstance(self.normalizer, HistogramMatching)
            and self.normalizer.channel_axis in _CHANNELS_LAST
        ):
            if images.shape[-1] != 3:
                raise ValueError(
                    f"channels-last histogram matching expects shape (N, H, W, 3), "
                    f"got {tuple(images.shape)}"
                )
        elif images.shape[1] != 3:
            raise ValueError(
                f"Expected NCHW with C=3 (got shape {tuple(images.shape)}). Macenko/Reinhard "
                f"do not accept NHWC; use channel_axis=-1 only with histogram_matching, or "
                f"permute to NCHW first."
            )
        return images

    def _prepare(self, images: Any) -> torch.Tensor:
        target = self._target_device(images)
        images = self._validate_layout(images)
        self._sync_normalizer_device(target)
        return images.to(target)

    def fit_reference(self, reference: Any) -> "StainNormalizerTransform":
        """Fit the underlying normalizer on a reference image or batch. With
        ``pixel_axis`` the fit runs pixel-sharded on the mesh: one image may
        exceed a card, so it is never placed whole on one."""
        if self.mesh is not None and self.pixel_axis is not None:
            from stainx_tpu_torch import parallel

            method = self._method_name()
            params = parallel.fit_on_mesh(
                method, self._validate_layout(reference), self.mesh, pixel_axis=self.pixel_axis
            )
            self._store_mesh_params(method, params)
            return self
        self.normalizer.fit(self._prepare(reference))
        return self

    def forward(self, img: Any) -> torch.Tensor:
        """Normalize one image (C, H, W) or a batch (N, C, H, W): in batch
        mode after re-fitting on the batch, through the mesh when one was
        given. Returns the normalized tensor on the normalizer's device, in
        the input's layout and the value range the module docstring sets.
        The call is the span ``stainx.forward``
        (:mod:`stainx_tpu_torch.profiling`)."""
        with profiling.call("stainx.forward", outer=True):
            return self._forward(img)

    def _forward(self, img: Any) -> torch.Tensor:
        # Convert before the single-image check: a nested list has no .ndim.
        if not torch.is_tensor(img) and not hasattr(img, "ndim"):
            img = np.asarray(img)
        was_single = img.ndim == 3
        if self.mesh is not None:
            result = self._forward_on_mesh(img)
            return result[0] if was_single else result
        batch = self._prepare(img)

        if self.mode == "batch" and self.batch_ref_index is not None:
            # Intentional: re-fits every call, on the designated image.
            _check_ref_index(self.batch_ref_index, batch.shape[0])
            result = self.normalizer._fit_transform_at(batch, self.batch_ref_index)
        else:
            if self.mode == "batch":  # batch_ref_index=None fits on the whole batch
                self.normalizer.fit(batch)
            result = self.normalizer.transform(batch)
        return result[0] if was_single else result

    # ------------------------------------------------------------ mesh path
    def _method_name(self) -> str:
        for name, cls in _METHOD_MAP.items():
            if isinstance(self.normalizer, cls):
                return name
        raise TypeError(f"Unknown normalizer type {type(self.normalizer)}")

    def _mesh_params(self, method: str):
        n = self.normalizer
        if method == "macenko":
            # The single-device transform's fitted-state gates.
            n._validate_fitted_params()
            return (n._stain_matrix, n._target_max_conc)
        if method == "reinhard":
            return (n._reference_mean, n._reference_std)
        return n._ref_histograms_256

    def _store_mesh_params(self, method: str, params) -> None:
        """Keep mesh-fitted state on the normalizer's device, usable by its
        single-device transform."""
        n = self.normalizer
        put = lambda p: p.to(n.device)  # noqa: E731
        if method == "macenko":
            n._stain_matrix, n._target_max_conc = put(params[0]), put(params[1])
        elif method == "reinhard":
            n._reference_mean, n._reference_std = put(params[0]), put(params[1])
        else:
            n._ref_histograms_256 = put(params)
        n._is_fitted = True

    def _fit_mesh_reference(self, method: str, img, idx: int):
        """The fitted parameters of image ``idx`` of the batch: fitted
        pixel-sharded with ``pixel_axis`` (one image may exceed a card),
        else by the normalizer on one device. From a DTensor batch, only
        image ``idx`` moves (:func:`~stainx_tpu_torch.parallel.distributed.
        image_from_mesh`)."""
        from torch.distributed.tensor import DTensor

        from stainx_tpu_torch import parallel
        from stainx_tpu_torch.parallel import distributed
        from stainx_tpu_torch.parallel.mesh import axis_group

        if not isinstance(img, DTensor):
            if self.pixel_axis is not None:
                return parallel.fit_on_mesh(
                    method, img[idx : idx + 1], self.mesh, pixel_axis=self.pixel_axis
                )
            self.normalizer.fit(img[idx : idx + 1])
            return self._mesh_params(method)
        slab = distributed.image_from_mesh(img, idx, self.mesh)
        if self.pixel_axis is not None:
            group = axis_group(self.mesh, self.pixel_axis)
            return distributed.FIT_SHARDED[method](slab, group=group)
        self.normalizer.fit(slab)
        return self._mesh_params(method)

    def _forward_on_mesh(self, img: Any) -> torch.Tensor:
        """Sharded forward: the batch-parallel transform; in batch mode the
        fit's statistics reduce over every rank of the mesh
        (``batch_ref_index`` picks one image, ``None`` makes it an exact
        whole-batch distributed fit)."""
        from stainx_tpu_torch import parallel
        from stainx_tpu_torch.parallel.distributed import onto_mesh

        img = onto_mesh(self._validate_layout(img), self.mesh, pixel_axis=self.pixel_axis)
        method = self._method_name()
        if self.mode == "batch":
            idx = self.batch_ref_index
            if idx is None:
                params = parallel.fit_on_mesh(method, img, self.mesh, pixel_axis=self.pixel_axis)
            else:
                _check_ref_index(idx, img.shape[0])
                params = self._fit_mesh_reference(method, img, idx)
            self._store_mesh_params(method, params)
        else:
            params = self._mesh_params(method)

        if method == "macenko":
            # Numerics must not depend on whether a mesh is attached.
            result = parallel.transform_on_mesh(method, img, params, self.mesh,
                                                pixel_axis=self.pixel_axis,
                                                precision=self.normalizer.precision)
            return self.normalizer._finalize_range(result)
        if method == "histogram_matching":
            params = self.normalizer._coerce_reference(params, img)
        return parallel.transform_on_mesh(method, img, params, self.mesh,
                                          pixel_axis=self.pixel_axis)
