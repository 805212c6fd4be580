"""Normalizer API classes of the PyTorch port."""

from stainx_tpu_torch.normalizers.histogram_matching import HistogramMatching
from stainx_tpu_torch.normalizers.macenko import Macenko
from stainx_tpu_torch.normalizers.reinhard import Reinhard

__all__ = ["HistogramMatching", "Macenko", "Reinhard"]
