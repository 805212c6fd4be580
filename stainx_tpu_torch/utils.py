"""Device resolution for the PyTorch / CUDA port.

Counterpart of ``stainx_tpu/utils.py::get_device``. Entry points run on the
CUDA card by default. There is no quiet fallback: when CUDA is missing, the
default device raises, and the CPU runs only when the caller asks for it
(``device="cpu"``), which routes every kernel wrapper to its plain PyTorch
version.
"""

from __future__ import annotations

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
