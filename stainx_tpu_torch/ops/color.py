"""Dtype and value-range gates.

Counterpart of ``stainx_tpu/ops/color.py`` (``normalize_to_float`` and
``preserve_dtype``): ``uint8`` inputs are [0, 255]; float inputs are
**always** [0, 1], never guessed from ``max() > 1``.
"""

from __future__ import annotations

import torch


def normalize_to_float(images: torch.Tensor) -> torch.Tensor:
    """float32 in [0, 1]: uint8 divides by 255, floats are cast as they are."""
    if images.dtype == torch.uint8:
        return images.to(torch.float32) / 255.0
    return images.to(torch.float32)


def preserve_dtype(
    result: torch.Tensor,
    original_dtype: torch.dtype,
    was_uint8_or_high_range: bool = False,
    result_in_0_255_range: bool = False,
) -> torch.Tensor:
    """Restore the caller's dtype and range: a [0, 1] result is scaled ×255
    when the input was uint8 or high-range, a [0, 255] result is clamped,
    then the result is cast to ``original_dtype`` (float → uint8 truncates
    toward zero)."""
    if not result_in_0_255_range and (
        original_dtype == torch.uint8 or was_uint8_or_high_range
    ):
        result = torch.clamp(result * 255.0, 0.0, 255.0)
    elif result_in_0_255_range:
        result = torch.clamp(result, 0.0, 255.0)
    return result.to(original_dtype)
