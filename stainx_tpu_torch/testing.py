"""Synthetic H&E data for tests and on-card checks (numpy only).

A copy of ``benchmarks/utils.py::synthetic_he_batch``, which imports JAX:
Beer–Lambert tiles from the torchstain default H&E basis with per-pixel
random concentrations, so the stain plane is well posed.
"""

from __future__ import annotations

import numpy as np

HE_REF = np.array([[0.5626, 0.2159], [0.7201, 0.8012], [0.4062, 0.5581]], np.float32)


def synthetic_he_batch(n: int, h: int, w: int, seed: int = 0, he_scale: float = 1.0) -> np.ndarray:
    """(n, 3, h, w) uint8 Beer–Lambert H&E tiles, made from ``seed``."""
    rng = np.random.default_rng(seed)
    he = HE_REF * he_scale
    conc = np.stack(
        [0.3 + 1.8 * rng.random((n, h * w), np.float32), 0.2 + rng.random((n, h * w), np.float32)],
        axis=1,
    )
    od = np.einsum("cs,nsp->ncp", he, conc)
    return np.clip(240.0 * np.exp(-od), 0, 255).astype(np.uint8).reshape(n, 3, h, w)
