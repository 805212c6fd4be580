"""Synthetic H&E data for tests and on-card checks (numpy only at import),
and the two helpers the tests, ``chip_smoke.py`` and ``tools/`` share.

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


def colour_cube(step: int = 1) -> np.ndarray:
    """Every RGB triple whose levels are multiples of ``step``, once each, as
    a (1, 3, side, side) uint8 image (step 1: 1×3×4096², step 4: 1×3×512²)."""
    levels = np.arange(0, 256, step, dtype=np.uint8)
    r, g, b = np.meshgrid(levels, levels, levels, indexing="ij")
    side = int(round(levels.size ** 1.5))
    return np.stack([r.ravel(), g.ravel(), b.ravel()]).reshape(1, 3, side, side)


# Where the Reinhard colour formulas branch, as float32 sRGB input: the sRGB
# knee (also linear 0.0031308 on the way back under an identity transfer),
# the grey levels at which X/Xn, Y and Z/Zn reach t = 0.008856 (the row sums
# of the RGB→XYZ matrix over the D65 white), and the ends of [0, 1].
BRANCH_POINTS = (0.04045, 0.0, 1.0) + tuple(
    1.055 * (0.008856 / white) ** (1.0 / 2.4) - 0.055
    for white in (0.950456 / 0.95047, 1.0, 1.088754 / 1.08883)
)


def branch_point_field(ulps: int, rows: int, seed: int = 0) -> np.ndarray:
    """(1, 3, rows, w) float32: each of :data:`BRANCH_POINTS` and the
    ``ulps`` float32 values either side of it (some below 0 and above 1),
    padded with 0.5 to a multiple of 4; row 0 is grey, the other rows
    permute the values in each channel, made from ``seed``."""
    values = []
    for v in BRANCH_POINTS:
        values.append(np.float32(v))
        for direction in (np.inf, -np.inf):
            u = np.float32(v)
            for _ in range(ulps):
                u = np.nextafter(u, np.float32(direction))
                values.append(u)
    values += [np.float32(0.5)] * (-len(values) % 4)
    pool = np.array(values, np.float32)
    rng = np.random.default_rng(seed)
    planes = [np.stack([pool] * 3)] + [np.stack([rng.permutation(pool) for _ in range(3)])
                                       for _ in range(rows - 1)]
    return np.stack(planes, axis=1)[None]


def largest(fits) -> int:
    """The largest size up to 2^24 for which ``fits(size)`` holds, where it
    holds up to some size and never past it: the edge of a size rule such
    as ``kernels.macenko_fused.transform_body``."""
    lo, hi = 1, 1 << 24
    while lo < hi:
        mid = (lo + hi + 1) // 2
        lo, hi = (mid, hi) if fits(mid) else (lo, mid - 1)
    return lo


def selections_exact(keys, sel, p: int) -> bool:
    """Whether ``sel`` ((R, 4) float32: the α and 100−α angles, the two
    maxC) are ``kth_smallest`` of the keys ((R, 3, p) int32: angles, +inf's
    key off the β-mask, then the two concentrations) that B1's resident
    body or B2 selected on, bit for bit
    (``kernels.macenko_fused.resident_selections``, ``fit_selections``)."""
    import torch

    from stainx_tpu_torch.kernels import macenko_fused as mf
    from stainx_tpu_torch.kernels.selection import unkey
    from stainx_tpu_torch.ops.percentile import (
        kth_smallest,
        nearest_rank_index,
        static_nearest_rank_index,
    )

    k = keys.to(torch.int64) & 0xFFFFFFFF
    vals = unkey(k)
    member = k[:, 0] < 0xFF800000
    cnt = member.sum(-1)
    ranks = torch.stack([nearest_rank_index(mf.ALPHA, cnt),
                         nearest_rank_index(100 - mf.ALPHA, cnt)], -1)
    idx = torch.full((keys.shape[0],), static_nearest_rank_index(99, p), device=keys.device)
    want = torch.cat([kth_smallest(vals[:, 0], ranks, member),
                      kth_smallest(vals[:, 1], idx)[:, None],
                      kth_smallest(vals[:, 2], idx)[:, None]], -1)
    return torch.equal(sel.contiguous().view(torch.int32), want.contiguous().view(torch.int32))
