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
``torch.distributed``; importing it creates no process group).
"""

from stainx_tpu_torch import parallel
from stainx_tpu_torch.normalizers import HistogramMatching, Macenko, Reinhard
from stainx_tpu_torch.transforms import StainNormalizerTransform

__all__ = ["HistogramMatching", "Macenko", "Reinhard", "StainNormalizerTransform", "parallel"]
