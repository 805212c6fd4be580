"""Closed-form eigendecomposition of symmetric 3×3 matrices, batched.

Counterpart of ``stainx_tpu/ops/eigh3.py``: the trigonometric closed form
(eigenvalues from ``acos``/``cos``, no iteration) and eigenvectors as the
largest cross product of the rows of ``A − λI``. This is the one eigh
formula of the port: the plain versions of the Macenko kernels call it, and
``csrc/macenko_fused.cu::eigh3_top2`` is the same arithmetic on scalars.
Column 0 is the eigenvector of the middle eigenvalue, column 1 that of the
largest; signs are arbitrary, as with LAPACK.
"""

from __future__ import annotations

import math

import torch

_DIAG_EPS = 1e-30


def div_rn(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` rounded once, on every device, as the kernels divide.
    PyTorch's CUDA division by a Python number multiplies by the number's
    float32 reciprocal instead, which rounds differently for about a third
    of float32 values; a divisor tensor on ``x``'s device keeps the
    division."""
    return x / x.new_full((), c)


def eigvalsh3(a: torch.Tensor) -> torch.Tensor:
    """Ascending eigenvalues (..., 3) of symmetric ``a`` (..., 3, 3)."""
    a = a.to(torch.float32)
    a00, a01, a02 = a[..., 0, 0], a[..., 0, 1], a[..., 0, 2]
    a11, a12, a22 = a[..., 1, 1], a[..., 1, 2], a[..., 2, 2]

    p1 = a01 * a01 + a02 * a02 + a12 * a12
    q = div_rn(a00 + a11 + a22, 3.0)

    p2 = (a00 - q) ** 2 + (a11 - q) ** 2 + (a22 - q) ** 2 + 2.0 * p1
    p = torch.sqrt(torch.clamp(div_rn(p2, 6.0), min=_DIAG_EPS))
    inv_p = 1.0 / p
    b00, b11, b22 = (a00 - q) * inv_p, (a11 - q) * inv_p, (a22 - q) * inv_p
    b01, b02, b12 = a01 * inv_p, a02 * inv_p, a12 * inv_p
    det_b = (
        b00 * (b11 * b22 - b12 * b12)
        - b01 * (b01 * b22 - b12 * b02)
        + b02 * (b01 * b12 - b11 * b02)
    )
    r = torch.clamp(det_b / 2.0, -1.0, 1.0)
    phi = div_rn(torch.acos(r), 3.0)
    e_max = q + 2.0 * p * torch.cos(phi)
    e_min = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    e_mid = 3.0 * q - e_max - e_min
    trig = torch.stack([e_min, e_mid, e_max], dim=-1)

    diag_sorted = torch.sort(torch.stack([a00, a11, a22], dim=-1), dim=-1).values
    return torch.where((p1 <= _DIAG_EPS)[..., None], diag_sorted, trig)


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.stack(
        [
            a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
            a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
            a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
        ],
        dim=-1,
    )


def _sq3(c: torch.Tensor) -> torch.Tensor:
    """Squared norm over the last axis, summed left to right."""
    return c[..., 0] * c[..., 0] + c[..., 1] * c[..., 1] + c[..., 2] * c[..., 2]


def _nullspace_direction(m: torch.Tensor) -> torch.Tensor:
    """Unit null-space direction of near-singular symmetric ``m`` (..., 3, 3):
    the largest cross product of its rows, zero when all are degenerate."""
    r0, r1, r2 = m[..., 0, :], m[..., 1, :], m[..., 2, :]
    c01, c02, c12 = _cross(r0, r1), _cross(r0, r2), _cross(r1, r2)
    n01, n02, n12 = _sq3(c01)[..., None], _sq3(c02)[..., None], _sq3(c12)[..., None]

    best = torch.where(n02 > n01, c02, c01)
    best = torch.where(n12 > torch.maximum(n01, n02), c12, best)

    norm = torch.sqrt(_sq3(best))[..., None]
    inv = torch.where(norm > 1e-30, 1.0 / torch.clamp(norm, min=1e-38), 0.0)
    return best * inv


def eigh3_top2(a: torch.Tensor) -> torch.Tensor:
    """Eigenvectors of the middle and largest eigenvalues of symmetric
    (..., 3, 3) matrices, as (..., 3, 2)."""
    a = a.to(torch.float32)
    evals = eigvalsh3(a)
    eye = torch.eye(3, dtype=a.dtype, device=a.device)
    v_mid = _nullspace_direction(a - evals[..., 1, None, None] * eye)
    v_max = _nullspace_direction(a - evals[..., 2, None, None] * eye)
    return torch.stack([v_mid, v_max], dim=-1)
