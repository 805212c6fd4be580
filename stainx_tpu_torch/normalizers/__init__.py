"""Normalizer API classes of the PyTorch port."""

from stainx_tpu_torch.normalizers.macenko import Macenko

__all__ = ["Macenko"]
