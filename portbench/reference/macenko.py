"""Plain numpy Macenko: the reference that decides a Macenko cell's ``correct``.

A frozen copy of the numpy oracle's ``macenko_fit`` and
``macenko_transform`` (torchstain's arithmetic: Io = 240, beta = 0.15,
alpha = 1, nearest-rank percentiles, float32 tensors). It imports nothing
of the program, and takes nothing the program made: it is handed the
benchmark's own inputs and works the fit out again.

``rounding`` is applied to every stored intermediate. The benchmark runs
with it off; the control (``portbench.control``) passes :func:`bf16`, the
reference computed in the precision below the configuration's float32,
and must come out as not correct.
"""

from __future__ import annotations

import numpy as np

IO = 240.0
BETA = 0.15
ALPHA = 1.0
STATISTICS = "image"

# Floating-point operations a pixel needs, a transcendental (log, exp,
# atan2) counted as one and comparisons, selections and casts as none:
# optical density 12 (3 channels: +1, scale, log, negate), the beta-mask 3,
# the masked moments 16, the projection on the stain plane 10, the angle 1,
# the 2x2 concentrations 10; a transform re-fits each image and adds the
# reconstruction 17 (rescale 2, 3x2 products 9, exp 3, times Io 3).
OPS_PER_PIXEL = {"fit": 52, "transform": 69, "float_input": 3, "unit_output": 3}


def _same(a):
    return a


def bf16(a) -> np.ndarray:
    """float32 values rounded to the nearest bfloat16 (ties to even)."""
    a = np.ascontiguousarray(a, np.float32)
    u = a.view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32).reshape(a.shape)


def to_float01(images: np.ndarray) -> np.ndarray:
    if images.dtype == np.uint8:
        return images.astype(np.float32) / 255.0
    return images.astype(np.float32)


def _percentile(t: np.ndarray, q: float) -> float:
    """torchstain's nearest rank: kthvalue(1 + round(q/100 (n - 1)))."""
    k = 1 + round(0.01 * float(q) * (t.size - 1))
    return float(np.partition(t.reshape(-1), k - 1)[k - 1])


def _stain_vectors(od_f: np.ndarray, r):
    """H and E columns from the OD pixels past beta (rows of 3)."""
    if od_f.shape[0] > 1:
        cov = r(np.cov(od_f.T.astype(np.float32), ddof=1).astype(np.float32))
    else:
        cov = np.zeros((3, 3), np.float32)
    _, eigvecs = np.linalg.eigh(cov)
    v = r(eigvecs[:, [1, 2]].astype(np.float32))
    that = r(od_f @ v)
    phi = r(np.arctan2(that[:, 1], that[:, 0]))
    min_phi = _percentile(phi, ALPHA)
    max_phi = _percentile(phi, 100 - ALPHA)
    v_min = r(v @ np.array([np.cos(min_phi), np.sin(min_phi)], np.float32))
    v_max = r(v @ np.array([np.cos(max_phi), np.sin(max_phi)], np.float32))
    if v_min[0] > v_max[0]:
        return np.stack([v_min, v_max], axis=1)
    return np.stack([v_max, v_min], axis=1)


def fit(images: np.ndarray, rounding=_same) -> dict[str, np.ndarray]:
    """The stain matrix (3, 2) and the 99th-percentile concentrations (2,)
    of the pool of all pixels of ``images`` (N, 3, H, W)."""
    r = rounding
    od = r(-np.log((to_float01(images) * 255.0 + 1.0) / IO))
    od_flat = np.transpose(od, (1, 0, 2, 3)).reshape(3, -1)
    od_pix = od_flat.T
    od_f = od_pix[od_pix.min(axis=1) >= BETA]
    he = _stain_vectors(od_f, r)
    conc = r(np.linalg.lstsq(he, od_flat, rcond=None)[0])
    max_conc = np.array([_percentile(conc[0], 99), _percentile(conc[1], 99)], np.float32)
    return {"_stain_matrix": he.astype(np.float32), "_target_max_conc": max_conc}


def transform(images: np.ndarray, state: dict[str, np.ndarray], rounding=_same) -> np.ndarray:
    """Each image of ``images`` normalized onto ``state``: values in
    [0, 255], in the input's dtype (uint8 truncates)."""
    r = rounding
    stain = np.asarray(state["_stain_matrix"], np.float32)
    tmc = np.reshape(state["_target_max_conc"], -1).astype(np.float32)
    n, _, h, w = images.shape
    od_all = r(-np.log((to_float01(images) * 255.0 + 1.0) / IO))
    out = np.empty((n, 3, h, w), np.float32)
    for i in range(n):
        od = od_all[i]
        od_r = od.transpose(1, 2, 0).reshape(-1, 3)
        od_f = od_r[od_r.min(axis=1) >= BETA]
        if od_f.shape[0] < 3:
            od_f = od_r
        he = _stain_vectors(od_f, r)
        conc = r(np.linalg.lstsq(he, od.reshape(3, -1), rcond=None)[0])
        max_c = np.array([_percentile(conc[0], 99), _percentile(conc[1], 99)], np.float32)
        conc_n = r(conc * (tmc / max_c)[:, None])
        recon = r(IO * np.exp(-r(stain @ conc_n)))
        out[i] = np.clip(recon, 0, 255).reshape(3, h, w)
    return out.astype(images.dtype)


def state_gaps(program: dict, reference: dict) -> dict[str, float]:
    """How far the program's fit lies from the reference's: the largest
    absolute gap of the stain matrix, and the largest relative gap of the
    99th-percentile concentrations."""
    he = np.abs(np.asarray(program["_stain_matrix"], np.float64) - reference["_stain_matrix"])
    ref_mc = reference["_target_max_conc"].astype(np.float64)
    mc = np.abs(np.asarray(program["_target_max_conc"], np.float64).reshape(-1) - ref_mc)
    return {"he_gap": float(he.max()), "maxc_gap": float((mc / np.abs(ref_mc)).max())}
