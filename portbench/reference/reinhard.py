"""Plain PyTorch Reinhard: the reference that decides a Reinhard cell's ``correct``.

A frozen copy, in plain ``torch`` on the CPU and in float32, of the numpy
oracle's ``rgb_to_lab``, ``lab_to_rgb``, ``restore_dtype``,
``reinhard_fit`` and ``reinhard_transform``, term by term (upstream
stainx's ``torch_backend.py`` Reinhard: sRGB to LAB scaled to 0-255,
the LAB mean and Bessel-corrected std over the call's whole N*H*W, the
z-score with a ``+1e-8`` eps onto the reference's statistics, LAB to sRGB,
the clip to [0, 1], and for uint8 ``trunc(clip(x*255, 0, 255))``). It takes
numpy in and gives numpy out, imports nothing of the program, and takes
nothing the program made: it is handed the benchmark's own inputs and
works the statistics out again.

Departures from the oracle, each of which only makes the reference more
exact or leaves its bits as they are:

- the LAB sums are accumulated in float64, where the oracle takes float32
  ``mean`` and ``std``; the mean and std are then rounded to float32;
- a call is worked through in blocks of ``BLOCK_ROWS`` images, so that the
  float32 temporaries stay a few hundred MB at 128x3x512^2: first the LAB
  sums of the whole call, then the transform, block by block, on the
  statistics of the whole call. Every step after the sums is elementwise,
  so the blocking leaves each output value's bits as they are.

``rounding`` is applied to every stored float32 intermediate. The benchmark
runs with it off; the control (``portbench.control``) passes :func:`bf16`,
the reference computed in the precision below the configuration's float32,
and must come out as not correct.
"""

from __future__ import annotations

import numpy as np
import torch

# The reference's float32 matrix products must not run in TF32 on a card.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

STATISTICS = "call"
BLOCK_ROWS = 8

RGB2XYZ = ((0.412453, 0.357580, 0.180423), (0.212671, 0.715160, 0.072169),
           (0.019334, 0.119193, 0.950227))
XYZ2RGB = ((3.2404542, -1.5371385, -0.4985314), (-0.9692660, 1.8760108, 0.0415560),
           (0.0556434, -0.2040259, 1.0572252))
XYZ_REF = (0.95047, 1.0, 1.08883)

# Floating-point operations a pixel (3 channels) needs, a power or a cube
# root counted as one and comparisons, selections and clips as none. The
# LAB conversion is counted once a pixel, as the work the input needs,
# whatever the kernels redo. sRGB to LAB 39: the inverse gamma 9 (per
# channel add, divide, power), the 3x3 product 15, the white point 3, the
# cube roots 3, L, a and b 9 (two products and a sum each); the statistics
# 9 (a sum and a square's product and sum per channel). A transform adds the
# z-score 12 (subtract, divide, multiply, add per channel) and LAB to sRGB
# 39: L, a, b unscaled 3, fx, fy, fz 6, the cubes 3, the white point 3, the
# 3x3 product 15, the gamma 9 (a power, a product and a difference per
# channel). A fit is LAB and the statistics alone. The uint8 /255 on the way
# in and *255 on the way out are the casts' scaling, counted as none, so
# float input and unit output add nothing.
OPS_PER_PIXEL = {"fit": 48, "transform": 99, "float_input": 0, "unit_output": 0}


def _same(a):
    return a


def bf16(a: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to the nearest bfloat16 (ties to even)."""
    return a.to(torch.bfloat16).to(torch.float32)


def to_float01(images: torch.Tensor) -> torch.Tensor:
    """uint8 to [0, 1]; a float input is taken as [0, 1] already."""
    if images.dtype == torch.uint8:
        return images.to(torch.float32) / 255.0
    return images.to(torch.float32)


def _product(m, planes):
    """The 3x3 product ``m @ planes`` over channel planes, term by term."""
    return [planes[0] * m[i][0] + planes[1] * m[i][1] + planes[2] * m[i][2] for i in range(3)]


def rgb_to_lab(images: torch.Tensor, r=_same) -> torch.Tensor:
    """NCHW uint8 or float [0, 1] to scaled LAB (L*2.55, a + 128, b + 128)."""
    rgb = to_float01(images)
    linear = r(torch.where(rgb > 0.04045, ((rgb + 0.055) / 1.055) ** 2.4, rgb / 12.92))
    xyz = _product(RGB2XYZ, linear.unbind(1))
    xyz_n = r(torch.stack([xyz[i] / XYZ_REF[i] for i in range(3)], dim=1))
    f = r(torch.where(xyz_n > 0.008856, xyz_n ** (1.0 / 3.0), 7.787 * xyz_n + 16.0 / 116.0))
    fx, fy, fz = f[:, 0], f[:, 1], f[:, 2]
    lab = [(116.0 * fy - 16.0) * 2.55, 500.0 * (fx - fy) + 128.0, 200.0 * (fy - fz) + 128.0]
    return r(torch.stack(lab, dim=1))


def lab_to_rgb(lab: torch.Tensor, r=_same) -> torch.Tensor:
    """Scaled LAB to sRGB in [0, 1]."""
    big_l = lab[:, 0] / 2.55
    a = lab[:, 1] - 128.0
    b = lab[:, 2] - 128.0
    fy = (big_l + 16.0) / 116.0
    fx = a / 500.0 + fy
    fz = fy - b / 200.0
    f = r(torch.stack([fx, fy, fz], dim=1))
    f_inv = r(torch.where(f > 0.2068966, f ** 3, (f - 16.0 / 116.0) / 7.787))
    xyz = [f_inv[:, i] * XYZ_REF[i] for i in range(3)]
    linear = r(torch.stack(_product(XYZ2RGB, xyz), dim=1))
    rgb = torch.where(linear > 0.0031308, 1.055 * linear.abs() ** (1.0 / 2.4) - 0.055,
                      12.92 * linear)
    return torch.clamp(r(rgb), 0.0, 1.0)


def restore_dtype(rgb01: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """[0, 1] values in the input's dtype: uint8 truncates ``clip(x*255)``."""
    if dtype == torch.uint8:
        return torch.clamp(rgb01 * 255.0, 0.0, 255.0).to(torch.uint8)
    return rgb01.to(dtype)


def _blocks(images: np.ndarray):
    """``(lo, block)``: each block of ``BLOCK_ROWS`` images, as a tensor."""
    for lo in range(0, len(images), BLOCK_ROWS):
        yield lo, torch.from_numpy(np.ascontiguousarray(images[lo:lo + BLOCK_ROWS]))


def mean_std(images: np.ndarray, r=_same) -> tuple[torch.Tensor, torch.Tensor]:
    """The LAB mean and Bessel-corrected std over all of ``images``'
    N*H*W pixels, each (3,) float32, from float64 sums over blocks."""
    n, _, h, w = images.shape
    total = torch.zeros(3, dtype=torch.float64)
    squares = torch.zeros(3, dtype=torch.float64)
    for _, block in _blocks(images):
        lab = rgb_to_lab(block, r).to(torch.float64)
        total += lab.sum(dim=(0, 2, 3))
        squares += (lab * lab).sum(dim=(0, 2, 3))
    count = n * h * w
    mean = total / count
    var = torch.clamp(squares - count * mean * mean, min=0.0) / max(count - 1, 1)
    return r(mean.to(torch.float32)), r(torch.sqrt(var).to(torch.float32))


def fit(images: np.ndarray, rounding=_same) -> dict[str, np.ndarray]:
    """The LAB mean and std (3,) of all pixels of ``images`` (N, 3, H, W)."""
    mean, std = mean_std(images, rounding)
    return {"_reference_mean": mean.numpy(), "_reference_std": std.numpy()}


def transform(images: np.ndarray, state: dict[str, np.ndarray], rounding=_same) -> np.ndarray:
    """``images`` (N, 3, H, W) normalized onto ``state`` with the LAB
    statistics of the whole call, in the input's dtype (uint8 in [0, 255],
    float in [0, 1])."""
    r = rounding
    mean, std = mean_std(images, r)
    mean, std = mean.reshape(1, 3, 1, 1), std.reshape(1, 3, 1, 1)
    ref_mean = torch.as_tensor(np.reshape(state["_reference_mean"], (1, 3, 1, 1)),
                               dtype=torch.float32)
    ref_std = torch.as_tensor(np.reshape(state["_reference_std"], (1, 3, 1, 1)),
                              dtype=torch.float32)
    out = np.empty(images.shape, images.dtype)
    for lo, block in _blocks(images):
        lab = rgb_to_lab(block, r)
        lab_n = r(((lab - mean) / (std + 1e-8)) * ref_std + ref_mean)
        rgb = torch.clamp(lab_to_rgb(lab_n, r), 0.0, 1.0)
        out[lo:lo + len(block)] = restore_dtype(rgb, block.dtype).numpy()
    return out


def state_gaps(program: dict, reference: dict) -> dict[str, float]:
    """How far the program's fit lies from the reference's: the largest
    relative gap of the LAB mean and std."""
    gaps = []
    for k in ("_reference_mean", "_reference_std"):
        ref = reference[k].astype(np.float64)
        gaps.append(np.abs(np.asarray(program[k], np.float64).reshape(-1) - ref) / np.abs(ref))
    return {"stat_gap": float(max(g.max() for g in gaps))}
