"""Colour-space math and dtype / value-range gates.

Counterpart of ``stainx_tpu/ops/color.py``:

- ``uint8`` inputs are [0, 255]; float inputs are **always** [0, 1], never
  guessed from ``max() > 1``;
- RGB↔LAB is the sRGB / D65 pipeline with OpenCV-style scaling: ``L``
  scaled by 2.55 into ~[0, 255], ``a`` and ``b`` offset by +128.

The plane functions take three broadcast-compatible float32 tensors and are
written term by term in the order the CUDA kernels of
``csrc/reinhard_fused.cu`` evaluate them: the kernels' plain versions are
built on them. The cube root is ``pow(max(t, 1e-12), 1/3)``, as in the JAX
package, in both the kernels and here.
"""

from __future__ import annotations

import torch

# sRGB → XYZ (D65).
_RGB2XYZ = (
    (0.412453, 0.357580, 0.180423),
    (0.212671, 0.715160, 0.072169),
    (0.019334, 0.119193, 0.950227),
)
# XYZ → sRGB (the inverse, standard values).
_XYZ2RGB = (
    (3.2404542, -1.5371385, -0.4985314),
    (-0.9692660, 1.8760108, 0.0415560),
    (0.0556434, -0.2040259, 1.0572252),
)
# D65 reference white.
_XYZ_REF = (0.95047, 1.0, 1.08883)

# The channel-axis registry: 1 / -3 are channels-first, -1 / 3 channels-last.
CHANNEL_AXES = (1, -3, -1, 3)


def normalize_to_float(images: torch.Tensor) -> torch.Tensor:
    """float32 in [0, 1]: uint8 divides by 255, floats are cast as they are."""
    if images.dtype == torch.uint8:
        return images.to(torch.float32) / 255.0
    return images.to(torch.float32)


def images_to_uint8(images: torch.Tensor) -> tuple[torch.Tensor, bool]:
    """Quantize to uint8; returns ``(uint8_images, needs_scale_back)``. Floats
    (taken as [0, 1]) scale by 255, clip to [0, 255] and truncate toward
    zero."""
    if images.dtype == torch.uint8:
        return images, False
    scaled = torch.clamp(images.to(torch.float32) * 255.0, 0.0, 255.0)
    return scaled.to(torch.uint8), True


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


def _nchw(images: torch.Tensor, channel_axis: int) -> tuple[torch.Tensor, bool]:
    """Channels-first view of a 4-D batch; ``True`` when it was permuted
    from NHWC. Raises for axes outside :data:`CHANNEL_AXES` and for inputs
    that are not 4-D."""
    if channel_axis not in CHANNEL_AXES:
        raise ValueError(
            f"channel_axis must be one of {CHANNEL_AXES} (1/-3 NCHW, -1/3 NHWC), got {channel_axis}"
        )
    if images.dim() != 4:
        raise ValueError(
            f"expected a 4D batch (NCHW or NHWC), got shape {tuple(images.shape)}; "
            "add a leading batch dimension first"
        )
    if channel_axis in (-1, 3):
        return images.permute(0, 3, 1, 2), True
    return images, False


def _apply_3x3(matrix, planes):
    """3×3 colour transform as elementwise products summed left to right."""
    return [
        matrix[i][0] * planes[0] + matrix[i][1] * planes[1] + matrix[i][2] * planes[2]
        for i in range(3)
    ]


def rgb_planes_to_lab(planes):
    """sRGB [0, 1] planes (R, G, B) → scaled LAB planes (L, a, b)."""
    linear = [
        torch.where(p > 0.04045, torch.pow((p + 0.055) / 1.055, 2.4), p / 12.92) for p in planes
    ]
    xyz = _apply_3x3(_RGB2XYZ, linear)

    def f(i):
        t = xyz[i] / _XYZ_REF[i]
        cube_root = torch.pow(torch.clamp(t, min=1e-12), 1.0 / 3.0)
        return torch.where(t > 0.008856, cube_root, 7.787 * t + 16.0 / 116.0)

    f_x, f_y, f_z = f(0), f(1), f(2)
    L = (116.0 * f_y - 16.0) * 2.55
    a = 500.0 * (f_x - f_y) + 128.0
    b = 200.0 * (f_y - f_z) + 128.0
    return [L, a, b]


def lab_planes_to_rgb(planes):
    """Inverse of :func:`rgb_planes_to_lab`, clamped to [0, 1]."""
    L = planes[0] / 2.55
    a = planes[1] - 128.0
    b = planes[2] - 128.0
    fy = (L + 16.0) / 116.0
    fx = a / 500.0 + fy
    fz = fy - b / 200.0

    def f_inv(t):
        return torch.where(t > 0.2068966, t * t * t, (t - 16.0 / 116.0) / 7.787)

    xyz = [f_inv(fx) * _XYZ_REF[0], f_inv(fy) * _XYZ_REF[1], f_inv(fz) * _XYZ_REF[2]]
    linear = _apply_3x3(_XYZ2RGB, xyz)
    return [
        torch.clamp(
            torch.where(
                c > 0.0031308,
                1.055 * torch.pow(torch.clamp(c, min=1e-12), 1.0 / 2.4) - 0.055,
                12.92 * c,
            ),
            0.0,
            1.0,
        )
        for c in linear
    ]


def rgb_to_lab(rgb: torch.Tensor, channel_axis: int = 1) -> torch.Tensor:
    """sRGB (uint8 [0, 255] or float [0, 1]) → float32 LAB with OpenCV-style
    scaling, in the layout ``channel_axis`` names."""
    rgb, needs_permute = _nchw(normalize_to_float(rgb), channel_axis)
    lab = torch.cat(rgb_planes_to_lab([rgb[:, 0:1], rgb[:, 1:2], rgb[:, 2:3]]), dim=1)
    return lab.permute(0, 2, 3, 1) if needs_permute else lab


def lab_to_rgb(lab: torch.Tensor, channel_axis: int = 1) -> torch.Tensor:
    """Inverse of :func:`rgb_to_lab`: float32 RGB clamped to [0, 1]."""
    lab, needs_permute = _nchw(lab, channel_axis)
    rgb = torch.cat(lab_planes_to_rgb([lab[:, 0:1], lab[:, 1:2], lab[:, 2:3]]), dim=1)
    return rgb.permute(0, 2, 3, 1) if needs_permute else rgb
