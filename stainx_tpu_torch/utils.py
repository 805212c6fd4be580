"""Device resolution and channel layouts for the PyTorch / CUDA port.

Counterpart of ``stainx_tpu/utils.py``. Entry points run on the
CUDA card by default. There is no quiet fallback: when CUDA is missing, the
default device raises, and the CPU runs only when the caller asks for it
(``device="cpu"``), which routes every kernel wrapper to its plain PyTorch
version. :class:`ChannelFormatConverter` converts between channel layouts
for tensors and numpy arrays.
"""

from __future__ import annotations

from typing import Any, ClassVar

import numpy as np
import torch


def get_device(device: str | torch.device | None = None) -> torch.device:
    """Resolve ``device`` to a :class:`torch.device`.

    ``None`` means ``cuda:0``; a bare ``"cuda"`` means the current CUDA
    device. Raises ``RuntimeError`` when a CUDA device is asked for (or
    defaulted to) and none is available, and ``ValueError`` for device
    types other than ``cuda`` and ``cpu``.
    """
    dev = torch.device("cuda", 0) if device is None else torch.device(device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {str(dev)!r}: use 'cuda[:i]' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "stainx_tpu_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run the plain PyTorch versions of the kernels"
        )
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class ChannelFormatConverter:
    """Channel-axis registry and layout conversion for tensors and numpy
    arrays.

    Counterpart of ``stainx_tpu.utils.ChannelFormatConverter``: the same
    ``channel_axis`` registry (1 / -3 channels-first, -1 / 3
    channels-last), ``to_hwc`` for numpy interop, and
    ``prepare_for_normalizer`` for NHWC/HWC → NCHW conversion.
    """

    _CHANNEL_AXIS_FORMAT: ClassVar[dict[int, dict[str, Any]]] = {
        1: {"is_channels_first": True, "permute_to_hwc": (1, 2, 0)},
        -3: {"is_channels_first": True, "permute_to_hwc": (1, 2, 0)},
        -1: {"is_channels_first": False, "permute_to_hwc": None},
        3: {"is_channels_first": False, "permute_to_hwc": None},
    }

    def __init__(self, channel_axis: int = 1):
        if channel_axis not in self._CHANNEL_AXIS_FORMAT:
            raise ValueError(
                f"Unsupported channel_axis={channel_axis}. Valid values: "
                f"{sorted(self._CHANNEL_AXIS_FORMAT)}"
            )
        self.channel_axis = channel_axis
        info = self._CHANNEL_AXIS_FORMAT[channel_axis]
        self.is_channels_first = info["is_channels_first"]
        self.permute_to_hwc = info["permute_to_hwc"]

    @staticmethod
    def _to_numpy(x: Any) -> np.ndarray:
        if torch.is_tensor(x):
            x = x.detach().cpu()
            return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
        return np.asarray(x)

    def to_hwc(self, images: Any, squeeze_batch: bool = False) -> np.ndarray:
        """Return a numpy HWC view of the (single) image for visualization."""
        images_np = self._to_numpy(images)
        if squeeze_batch:
            images_np = np.squeeze(images_np, axis=0)
        if self.permute_to_hwc is not None:
            return np.transpose(images_np, self.permute_to_hwc)
        return images_np

    def prepare_for_normalizer(self, images: Any) -> Any:
        """Return images in channels-first layout for NCHW-expecting
        normalizers: a tensor stays a tensor (``permute``), an array an
        array (``transpose``).

        Channels-first inputs pass through unchanged. NHWC is permuted with
        ``(0, 3, 1, 2)``; HWC becomes ``(1, C, H, W)``. After conversion use
        ``channel_axis=1`` on the normalizer.
        """
        if self.is_channels_first:
            return images
        ndim = images.ndim if hasattr(images, "ndim") else len(images.shape)
        if ndim == 4:
            order = (0, 3, 1, 2)
        elif ndim == 3:
            order = (2, 0, 1)
        else:
            raise ValueError(f"prepare_for_normalizer expects 3D or 4D images, got ndim={ndim}")
        out = images.permute(*order) if torch.is_tensor(images) else images.transpose(*order)
        return out if ndim == 4 else out[None]
