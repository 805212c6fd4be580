"""stainx_tpu_torch: the PyTorch / CUDA port of ``stainx_tpu``.

Stain normalization for histopathology with the ``fit / transform /
fit_transform`` API of ``stainx_tpu``. The compute runs on an NVIDIA Hopper
card (H100) through hand-written CUDA kernels (``csrc/``), built at first
use; the same entry points run on the CPU through the kernels' plain
PyTorch versions when the caller passes ``device="cpu"``. There is no
backend knob: the device decides the route.

Ported so far: :class:`Macenko` (fit and transform, with the multi-block
kernels for large rows and pools), :class:`Reinhard`,
:class:`HistogramMatching`, the training-pipeline
:class:`StainNormalizerTransform` (reference and batch modes, on one device
or a mesh), and the distributed layer :mod:`stainx_tpu_torch.parallel`
(exact sharded fits, sharded transforms and the mesh wrappers on
``torch.distributed``; importing it creates no process group), the
tile-ingest path :mod:`stainx_tpu_torch.io` (imported on its own: its
first use builds a library), :mod:`stainx_tpu_torch.profiling` and
:class:`~stainx_tpu_torch.utils.ChannelFormatConverter`.
"""

from stainx_tpu_torch import parallel, profiling
from stainx_tpu_torch.normalizers import HistogramMatching, Macenko, Reinhard
from stainx_tpu_torch.transforms import StainNormalizerTransform


def _get_version() -> str:
    """The version of the ``stainx-tpu`` distribution, which ships both
    packages: installed metadata first, then the ``version`` line of the
    checkout's ``pyproject.toml`` (read, not copied), else
    ``"0.0.0+unknown"``."""
    import re
    from importlib.metadata import PackageNotFoundError, version
    from pathlib import Path

    try:
        return version("stainx-tpu")
    except PackageNotFoundError:
        pass
    try:
        text = (Path(__file__).resolve().parent.parent / "pyproject.toml").read_text()
        return re.search(r'^version\s*=\s*"([^"]+)"', text, re.M).group(1)
    except (OSError, AttributeError):
        return "0.0.0+unknown"


__version__ = _get_version()

__all__ = [
    "HistogramMatching",
    "Macenko",
    "Reinhard",
    "StainNormalizerTransform",
    "__version__",
    "parallel",
    "profiling",
]
