"""The port's distributed layer on CPU process groups: cases and their runner.

``tests/test_torch_parallel*.py`` start one ``gloo`` group per suite in
worker processes (this file run as a script), let every rank run every case
of the suite twice, and hold the results against ``stainx_tpu.parallel`` on
the JAX package's virtual CPU devices. This module imports torch and the
port only, never JAX, so the workers start quickly.

    python tests/torch_parallel_cases.py SUITE RANK WORLD INIT_FILE OUT_DIR

A case is a function of the suite's meshes that returns a dict of numpy
arrays, replicated on every rank (a transform's output is the global one).
Each rank pickles ``{case: (result, repeat_equal) or error text}`` into
``OUT_DIR/rank{RANK}.pkl``.
"""

from __future__ import annotations

import datetime
import os
import pickle
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
SUITES = {"batch": 2, "pixel": 2, "mesh4": 4, "nn": 4}
ALPHA_PAIR = ((1, 99),)


# ----------------------------------------------------------------- inputs
# Built from seeds with numpy only: the test process builds the same arrays
# for the JAX side.
def he_batch() -> np.ndarray:
    """The 8×3×32×32 uint8 batch of ``tests/test_parallel.py``."""
    sys.path.insert(0, str(ROOT))
    from tests.oracles import numpy_reference as oracle

    tiles = [oracle.synthetic_he_tile(32, 32, seed=s, he_scale=1.0 + 0.02 * s) for s in range(8)]
    return np.concatenate(tiles, axis=0)


def oracle_params(method: str, images: np.ndarray):
    """Fitted parameters of ``images`` from the numpy oracle, as float32
    arrays: the same parameters feed the port and JAX."""
    sys.path.insert(0, str(ROOT))
    from tests.oracles import numpy_reference as oracle

    if method == "macenko":
        he, mc = oracle.macenko_fit(images)
        return np.asarray(he, np.float32), np.asarray(mc, np.float32)
    if method == "reinhard":
        mean, std = oracle.reinhard_fit(images)
        return np.asarray(mean, np.float32), np.asarray(std, np.float32)
    return np.stack(oracle.hm_fit(images)).astype(np.float32)


BACKGROUND_PARAMS = (
    np.asarray([[0.5626, 0.2159], [0.7201, 0.8012], [0.4062, 0.5581]], np.float32),
    np.asarray([1.9705, 1.0308], np.float32),
)


def percentile_field(name: str):
    """``(x, mask, q)`` of a percentile case (the fields of
    ``tests/test_parallel.py``'s percentile class); shards split the last
    axis."""
    if name in ("q1", "q50", "q99"):
        q = int(name[1:])
        rng = np.random.default_rng(q)
        x = rng.standard_normal(8 * 500).astype(np.float32)
        return x, rng.random(8 * 500) < 0.8, q
    if name == "cluster":
        x = np.linspace(0.0, 1.0, 8 * 4096).astype(np.float32)
        x[:4000] = np.float32(0.5) + np.arange(4000, dtype=np.float32) * np.float32(2**-23)
        return x, np.ones_like(x, bool), 50
    if name == "wide":
        x = (np.arange(8 * 500, dtype=np.float64) * 1e-30).astype(np.float32)
        x[-1] = np.float32(3e38)
        return x, np.ones_like(x, bool), 1
    if name in ("inf_q1", "inf_q99"):
        rng = np.random.default_rng(3)
        x = rng.standard_normal(8 * 64).astype(np.float32)
        x[0], x[1] = np.inf, -np.inf
        x[2:6] = np.float32(1e-42) * np.arange(1, 5, dtype=np.float32)
        return x, np.ones_like(x, bool), int(name[5:])
    if name == "duplicates":
        x = np.full(8 * 400, 5.0, np.float32)
        x[:100] = np.linspace(0, 1, 100, dtype=np.float32)
        return x, np.ones_like(x, bool), 99
    if name == "nested":
        rng = np.random.default_rng(7)
        x = rng.standard_normal((2, 8 * 300)).astype(np.float32)
        return x, rng.random((2, 8 * 300)) < 0.7, ((1, 50, 99), (99, 1, 25))
    if name == "nested_1d":
        x = np.random.default_rng(13).standard_normal(8 * 250).astype(np.float32)
        return x, None, ALPHA_PAIR
    if name == "mask_none":
        return np.random.default_rng(11).standard_normal((2, 8 * 200)).astype(np.float32), None, (25, 75)
    if name == "empty_row":
        x = np.random.default_rng(17).standard_normal((2, 8 * 100)).astype(np.float32)
        mask = np.ones_like(x, bool)
        mask[1] = False
        return x, mask, (50, 50)
    raise KeyError(name)


PERCENTILE_CASES = ["q1", "q50", "q99", "cluster", "wide", "inf_q1", "inf_q99", "duplicates",
                    "nested", "nested_1d", "mask_none", "empty_row"]


def random_composition(seed: int):
    """``(method, batch, reference)`` of a randomized composition case of
    ``tests/test_parallel.py`` (method, N, H, W, dtype from the seed)."""
    sys.path.insert(0, str(ROOT))
    from tests.oracles import numpy_reference as oracle

    rng = np.random.default_rng(seed + 500)
    method = ("macenko", "reinhard", "histogram_matching")[seed % 3]
    n, h, w = int(rng.integers(1, 10)), int(rng.integers(18, 46)), int(rng.integers(18, 46))
    as_float = bool(rng.integers(0, 2))
    tiles = [oracle.synthetic_he_tile(h, w, seed=seed * 37 + i, he_scale=1.0 + 0.03 * i)
             for i in range(n)]
    batch, ref = np.concatenate(tiles, axis=0), oracle.synthetic_he_tile(h, w, seed=seed * 37 + 99)
    if as_float:
        batch, ref = batch.astype(np.float32) / 255.0, ref.astype(np.float32) / 255.0
    return method, batch, ref


# ------------------------------------------------------------- the cases
def _np(x) -> np.ndarray:
    import torch

    if hasattr(x, "full_tensor"):
        x = x.full_tensor()
    if torch.is_tensor(x):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x)


def _params(p):
    import torch

    return tuple(torch.as_tensor(a) for a in p) if isinstance(p, tuple) else torch.as_tensor(p)


def fit_out(params) -> dict:
    """Fitted parameters (a tuple or one array, torch or JAX) as ``p0``, ``p1``."""
    return {f"p{i}": _np(a) for i, a in enumerate(params if isinstance(params, tuple) else (params,))}


def error_of(fn) -> dict:
    """The message of the ValueError ``fn`` raises (an empty string when it
    raises none)."""
    try:
        fn()
    except (ValueError, IndexError) as exc:
        return {"error": np.asarray(str(exc))}
    return {"error": np.asarray("")}


def _local_slice(x: np.ndarray, rank: int, world: int) -> np.ndarray:
    p = x.shape[-1] // world
    return x[..., rank * p : (rank + 1) * p]


def batch_cases(meshes) -> dict:
    """Suite "batch": the ("batch",) mesh of 2 ranks."""
    import torch
    import torch.distributed as dist

    from stainx_tpu_torch import parallel
    from stainx_tpu_torch.parallel.mesh import axis_group

    mesh = meshes["batch"]
    he = he_batch()
    cases = {}

    def percentile(name):
        rank, world = dist.get_rank(), dist.get_world_size()
        x, mask, q = percentile_field(name)
        xl = torch.as_tensor(_local_slice(x, rank, world))
        ml = None if mask is None else torch.as_tensor(_local_slice(mask, rank, world))
        return {"pct": _np(parallel.distributed_masked_percentile(xl, ml, q, mesh.get_group()))}

    for name in PERCENTILE_CASES:
        cases[f"percentile_{name}"] = lambda name=name: percentile(name)
    for method in ("reinhard", "histogram_matching", "macenko"):
        cases[f"fit_{method}"] = lambda m=method: fit_out(parallel.fit_on_mesh(m, he, mesh))
        cases[f"transform_{method}"] = lambda m=method: {"out": _np(parallel.transform_on_mesh(
            m, he, _params(oracle_params(m, he[:1])), mesh))}
        cases[f"uneven_fit_{method}"] = lambda m=method: fit_out(parallel.fit_on_mesh(m, he[:5], mesh))
        cases[f"uneven_transform_{method}"] = lambda m=method: {"out": _np(
            parallel.transform_on_mesh(m, he[:5], _params(oracle_params(m, he[:1])), mesh))}
        cases[f"masks_fit_{method}"] = lambda m=method: fit_out(_masked_sharded(m, he, mesh))
    cases["single_image"] = lambda: {
        "out": _np(parallel.transform_on_mesh("reinhard", he[:1],
                                              _params(oracle_params("reinhard", he[1:2])), mesh)),
        **fit_out(parallel.fit_on_mesh("reinhard", he[:1], mesh)),
    }
    for method in ("reinhard", "histogram_matching"):
        cases[f"masks_transform_{method}"] = lambda m=method: {"out": _masked_transform(m, he, mesh)}
    cases["bad_batch_axis"] = lambda: error_of(
        lambda: parallel.fit_on_mesh("reinhard", he, mesh, batch_axis="nope"))
    cases["group_reused"] = lambda: {"same": np.asarray([
        axis_group(mesh, "batch") is axis_group(mesh, ("batch",)) is mesh.get_group("batch"),
        parallel.transform_on_mesh("macenko", he, _params(oracle_params("macenko", he[:1])), mesh)
        .equal(parallel.transform_on_mesh("macenko", he, _params(oracle_params("macenko", he[:1])),
                                          mesh)),
    ])}
    return cases


def _masked_sharded(method, he, mesh):
    """A ``*_sharded`` fit given tensor masks straight: 5 of the 8 images
    padded to 6 and 31 of 32 rows real, this rank's 3 rows."""
    import torch
    import torch.distributed as dist

    from stainx_tpu_torch import parallel

    rank = dist.get_rank()
    padded = np.concatenate([he[:5], np.zeros_like(he[:1])])
    padded[:, :, 31:] = 0
    local = torch.as_tensor(padded[3 * rank : 3 * rank + 3])
    weights = torch.as_tensor([1.0, 1.0, 1.0] if rank == 0 else [1.0, 1.0, 0.0])
    valid_rows = torch.arange(32) < 31
    fit = {"reinhard": parallel.reinhard_fit_sharded, "histogram_matching": parallel.hm_fit_sharded,
           "macenko": parallel.macenko_fit_sharded}[method]
    return fit(local, group=mesh.get_group(), weights=weights, valid_rows=valid_rows)


def _masked_transform(method, he, mesh):
    """A ``*_transform_sharded`` call given tensor masks straight (the
    batch-global statistics of he[:5, :, :31]); the real rows of the global
    output."""
    import torch
    import torch.distributed as dist

    from stainx_tpu_torch import parallel

    rank, group = dist.get_rank(), mesh.get_group()
    padded = np.concatenate([he[:5], np.zeros_like(he[:1])])
    padded[:, :, 31:] = 0
    local = torch.as_tensor(padded[3 * rank : 3 * rank + 3])
    weights = torch.as_tensor([1.0, 1.0, 1.0] if rank == 0 else [1.0, 1.0, 0.0])
    valid_rows = torch.arange(32) < 31
    params = _params(oracle_params(method, he[:1]))
    if method == "reinhard":
        out = parallel.reinhard_transform_sharded(local, *params, group=group, weights=weights,
                                                  valid_rows=valid_rows)
    else:
        out = parallel.hm_transform_sharded(local, params, group=group, weights=weights,
                                            valid_rows=valid_rows)
    parts = [torch.empty_like(out) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, out.contiguous(), group=group)
    return _np(torch.cat(parts)[:5, :, :31])


def pixel_cases(meshes) -> dict:
    """Suite "pixel": the ("batch", "pixel") mesh of shape (1, 2)."""
    import torch

    from stainx_tpu_torch import parallel
    from stainx_tpu_torch.parallel.distributed import macenko_transform_sharded
    from stainx_tpu_torch.parallel.mesh import axis_group

    mesh = meshes["px"]
    he = he_batch()
    cases = {}

    def tr(method, x, params, **kw):
        return {"out": _np(parallel.transform_on_mesh(method, x, _params(params), mesh,
                                                      pixel_axis="pixel", **kw))}

    cases["macenko_single_image"] = lambda: tr("macenko", he[:1], oracle_params("macenko", he[1:2]))
    cases["macenko_fast"] = lambda: tr("macenko", he[:2], oracle_params("macenko", he[2:3]),
                                       precision="fast")
    cases["macenko_float32"] = lambda: tr("macenko", he[:2].astype(np.float32) / 255.0,
                                          oracle_params("macenko", he[2:3]))
    cases["background_fallback"] = lambda: tr("macenko", np.full((1, 3, 32, 32), 250, np.uint8),
                                              BACKGROUND_PARAMS)
    for method in ("macenko", "reinhard", "histogram_matching"):
        cases[f"odd_h_{method}"] = lambda m=method: tr(m, he[:2, :, :31],
                                                       oracle_params(m, he[2:3]))
        cases[f"fit_{method}"] = lambda m=method: fit_out(
            parallel.fit_on_mesh(m, he, mesh, pixel_axis="pixel"))
        cases[f"fit_odd_h_{method}"] = lambda m=method: fit_out(
            parallel.fit_on_mesh(m, he[:, :, :31], mesh, pixel_axis="pixel"))

    def valid_mask():
        padded = np.concatenate([he[:1], np.zeros((1, 3, 2, 32), np.uint8)], axis=2)  # H 34
        p = mesh.get_coordinate()[1]
        local = torch.as_tensor(padded[:, :, 17 * p : 17 * p + 17])
        valid = (torch.arange(34) < 32)[17 * p : 17 * p + 17][None, :, None].expand(1, 17, 32)
        he_p, mc_p = _params(oracle_params("macenko", he[1:2]))
        out = macenko_transform_sharded(local, he_p, mc_p, group=axis_group(mesh, "pixel"),
                                        valid=valid)
        parts = [torch.empty_like(out) for _ in range(2)]
        torch.distributed.all_gather(parts, out, group=axis_group(mesh, "pixel"))
        return {"out": _np(torch.cat(parts, dim=2)[:, :, :32])}

    cases["valid_mask"] = valid_mask
    return cases


def mesh4_cases(meshes) -> dict:
    """Suite "mesh4": the ("batch", "pixel") mesh of shape (2, 2); the
    ("batch", "pixel", "model") meshes of shapes (2, 2, 1) and (1, 2, 2);
    ("batch",) meshes of ranks 0 and 1, by ``devices`` and by shape."""
    import torch
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from stainx_tpu_torch import parallel
    from stainx_tpu_torch.parallel import distributed
    from stainx_tpu_torch.parallel.mesh import axis_group

    mesh = meshes["2d"]
    he = he_batch()
    cases = {}

    def tr(method, x, params, pixel_axis="pixel"):
        return {"out": _np(parallel.transform_on_mesh(method, x, _params(params), mesh,
                                                      pixel_axis=pixel_axis))}

    def fit(method, x, pixel_axis="pixel"):
        return fit_out(parallel.fit_on_mesh(method, x, mesh, pixel_axis=pixel_axis))

    for method in ("macenko", "reinhard", "histogram_matching"):
        cases[f"transform_pixel_{method}"] = lambda m=method: tr(m, he, oracle_params(m, he[:1]))
        cases[f"fit_odd_h_{method}"] = lambda m=method: fit(m, he[:, :, :31])
        cases[f"batch_only_fit_{method}"] = lambda m=method: fit(m, he, None)
        cases[f"presharded_{method}"] = lambda m=method: _presharded(m, he, mesh)
    cases["fit_pixel_macenko"] = lambda: fit("macenko", he)
    cases["fit_odd_h_uneven_reinhard"] = lambda: fit("reinhard", he[:3, :, :31])
    cases["uneven_pixel_reinhard"] = lambda: tr("reinhard", he[:3], oracle_params("reinhard", he[:1]))
    cases["odd_h_uneven_reinhard"] = lambda: tr("reinhard", he[:3, :, :31],
                                                oracle_params("reinhard", he[3:4]))
    cases["batch_only_transform_reinhard"] = lambda: tr("reinhard", he,
                                                        oracle_params("reinhard", he[:1]), None)
    for seed in range(6):
        def composition(seed=seed):
            method, batch, ref = random_composition(seed)
            return tr(method, batch, oracle_params(method, ref))

        cases[f"random_{seed}"] = composition
    cases["error_pixel_axis_missing"] = lambda: error_of(lambda: parallel.transform_on_mesh(
        "macenko", he, _params(BACKGROUND_PARAMS), mesh, pixel_axis="nope"))
    cases["error_pixel_axis_is_batch"] = lambda: error_of(lambda: parallel.transform_on_mesh(
        "macenko", he, _params(BACKGROUND_PARAMS), mesh, pixel_axis="batch"))
    cases["error_dtensor_uneven"] = lambda: error_of(lambda: parallel.fit_on_mesh(
        "reinhard", distribute_tensor(torch.as_tensor(he[:5]), mesh, [Shard(0), Replicate()]),
        mesh))

    def fit_sharded_2d():
        b, p = mesh.get_coordinate()
        local = torch.as_tensor(he[4 * b : 4 * b + 4, :, 16 * p : 16 * p + 16])
        return fit_out(parallel.macenko_fit_sharded(local, group=axis_group(mesh, ("batch", "pixel"))))

    cases["fit_sharded_2d"] = fit_sharded_2d

    def no_copy():
        dt = distribute_tensor(torch.as_tensor(he), mesh, [Shard(0), Shard(2)])
        loc = distributed._local_shard(dt, mesh, "batch", "pixel")
        return {"same": np.asarray([loc.x.data_ptr() == dt.to_local().data_ptr(),
                                    loc.placements == (Shard(0), Shard(2))])}

    cases["presharded_no_copy"] = no_copy

    for shape_name in ("221", "122"):
        m3 = meshes[f"3d_{shape_name}"]
        for method in ("macenko", "reinhard", "histogram_matching"):
            cases[f"mesh3d_{shape_name}_fit_{method}"] = lambda m=method, m3=m3: fit_out(
                parallel.fit_on_mesh(m, he, m3, pixel_axis="pixel"))
            cases[f"mesh3d_{shape_name}_transform_{method}"] = lambda m=method, m3=m3: {
                "out": _np(parallel.transform_on_mesh(m, he, _params(oracle_params(m, he[:1])), m3,
                                                      pixel_axis="pixel"))}
    cases["mesh3d_221_odd_h_uneven_reinhard"] = lambda: {"out": _np(parallel.transform_on_mesh(
        "reinhard", he[:3, :, :31], _params(oracle_params("reinhard", he[3:4])), meshes["3d_221"],
        pixel_axis="pixel"))}
    cases["mesh3d_122_batch_only_fit_reinhard"] = lambda: fit_out(
        parallel.fit_on_mesh("reinhard", he, meshes["3d_122"]))

    def fit_sharded_3d():
        m3 = meshes["3d_122"]
        p = m3.get_coordinate()[1]
        return fit_out(parallel.macenko_fit_sharded(torch.as_tensor(he[:, :, 16 * p : 16 * p + 16]),
                                                    group=axis_group(m3, ("batch", "pixel"))))

    cases["mesh3d_122_fit_sharded"] = fit_sharded_3d
    cases["submesh_devices_fit_reinhard"] = lambda: _submesh(
        meshes["devices01"], lambda m: fit_out(parallel.fit_on_mesh("reinhard", he, m)))
    cases["submesh_devices_transform_macenko"] = lambda: _submesh(
        meshes["devices01"], lambda m: {"out": _np(parallel.transform_on_mesh(
            "macenko", he, _params(oracle_params("macenko", he[:1])), m))})
    cases["submesh_shape_fit_histogram_matching"] = lambda: _submesh(
        meshes["first2"], lambda m: fit_out(parallel.fit_on_mesh("histogram_matching", he, m)))
    for method in ("macenko", "reinhard", "histogram_matching"):
        cases[f"dtensor_other_mesh_{method}"] = lambda m=method: _other_mesh(
            m, he, mesh, meshes["3d_221"])
    return cases


def _submesh(mesh, run) -> dict:
    """``run(mesh)`` on a mesh of ranks 0 and 1 in a world of 4: rank 0's
    result on every rank, and whether the mesh holds ranks 0 and 1 and
    ranks 2 and 3 (outside it) got ``ValueError("... not in the mesh")``."""
    import torch.distributed as dist

    rank = dist.get_rank()
    try:
        result, error = run(mesh), ""
    except ValueError as exc:
        result, error = None, str(exc)
    shared = [result]
    dist.broadcast_object_list(shared, src=0)
    outside = rank >= 2
    return {**shared[0], "same": np.asarray([
        mesh.mesh.flatten().tolist() == [0, 1], outside == (result is None),
        not outside or "not in the mesh" in error])}


def _other_mesh(method, he, mesh, other):
    """Fit and transform on ``mesh`` of a DTensor batch that lives on
    ``other``: the outputs, and whether they equal the plain global batch's
    bit for bit, with the transform a DTensor on ``mesh``."""
    import torch
    from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

    from stainx_tpu_torch import parallel

    dt = distribute_tensor(torch.as_tensor(he), other, [Shard(0), Replicate(), Replicate()])
    p_dt = parallel.fit_on_mesh(method, dt, mesh, pixel_axis="pixel")
    p_host = parallel.fit_on_mesh(method, he, mesh, pixel_axis="pixel")
    params = _params(oracle_params(method, he[:1]))
    out_dt = parallel.transform_on_mesh(method, dt, params, mesh, pixel_axis="pixel")
    out_host = parallel.transform_on_mesh(method, he, params, mesh, pixel_axis="pixel")
    fits = p_dt if isinstance(p_dt, tuple) else (p_dt,)
    hosts = p_host if isinstance(p_host, tuple) else (p_host,)
    return {**fit_out(p_dt), "out": _np(out_dt), "same": np.asarray([
        all(torch.equal(a, b) for a, b in zip(fits, hosts)), isinstance(out_dt, DTensor),
        out_dt.device_mesh == mesh, torch.equal(out_dt.full_tensor(), out_host)])}


def _presharded(method, he, mesh):
    """Fit and transform of a DTensor batch (N on the batch axis, rows on
    the pixel axis) against the same calls on the plain global batch: the
    DTensor's outputs, and whether they equal the plain ones bit for bit."""
    import torch
    from torch.distributed.tensor import DTensor, Shard, distribute_tensor

    from stainx_tpu_torch import parallel

    dt = distribute_tensor(torch.as_tensor(he), mesh, [Shard(0), Shard(2)])
    p_dt = parallel.fit_on_mesh(method, dt, mesh, pixel_axis="pixel")
    p_host = parallel.fit_on_mesh(method, he, mesh, pixel_axis="pixel")
    params = _params(oracle_params(method, he[:1]))
    out_dt = parallel.transform_on_mesh(method, dt, params, mesh, pixel_axis="pixel")
    out_host = parallel.transform_on_mesh(method, he, params, mesh, pixel_axis="pixel")
    fits = p_dt if isinstance(p_dt, tuple) else (p_dt,)
    hosts = p_host if isinstance(p_host, tuple) else (p_host,)
    same = all(torch.equal(a, b) for a, b in zip(fits, hosts))
    return {**fit_out(p_dt), "out": _np(out_dt),
            "same": np.asarray([same, isinstance(out_dt, DTensor),
                                torch.equal(out_dt.full_tensor(), out_host),
                                tuple(out_dt.placements) == (Shard(0), Shard(2))])}


def nn_cases(meshes) -> dict:
    """Suite "nn": ``StainNormalizerTransform(mesh=...)`` on the ("batch",)
    mesh of 4 ranks, the (2, 2) ("batch", "pixel") mesh and the (1, 2, 2)
    ("batch", "pixel", "model") mesh."""
    import torch
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from stainx_tpu_torch import HistogramMatching, Macenko, StainNormalizerTransform

    m1, m2 = meshes["batch4"], meshes["2d"]
    he = he_batch()
    sys.path.insert(0, str(ROOT))
    from tests.oracles import numpy_reference as oracle

    ref = oracle.synthetic_he_tile(64, 64, seed=42)
    big = np.concatenate([oracle.synthetic_he_tile(32, 32, seed=s, he_scale=1.1) for s in range(8)])
    cases = {}

    def out(t, x):
        return {"out": _np(t(x))}

    cases["reference_reinhard"] = lambda: out(
        StainNormalizerTransform("reinhard", reference=ref, mesh=m1), big)
    cases["batch_whole_macenko"] = lambda: out(
        StainNormalizerTransform("macenko", mode="batch", batch_ref_index=None, mesh=m1), big)
    cases["batch_index_macenko"] = lambda: out(
        StainNormalizerTransform("macenko", mode="batch", batch_ref_index=3, mesh=m1), big)
    cases["batch_whole_hm"] = lambda: out(
        StainNormalizerTransform("histogram_matching", mode="batch", batch_ref_index=None,
                                 mesh=m1), big)

    def state_usable():
        t = StainNormalizerTransform("macenko", mode="batch", batch_ref_index=None, mesh=m1)
        t(big)
        return {"out": _np(t.normalizer.transform(big[:1])),
                "p0": _np(t.normalizer._stain_matrix)}

    cases["state_usable"] = state_usable

    def malformed():
        m = Macenko(device="cpu").load_state({"_stain_matrix": np.full((3, 2), 0.5, np.float32),
                                              "_target_max_conc": np.ones(3, np.float32)})
        return error_of(lambda: StainNormalizerTransform(normalizer=m, mesh=m1)(big))

    cases["error_malformed_state"] = malformed

    def hm_1d_state():
        hist_1d = np.zeros(256, np.float32)
        hist_1d[80:180] = 1.0 / 100.0
        norm = HistogramMatching(device="cpu").load_state({"_ref_histograms_256": hist_1d})
        return out(StainNormalizerTransform(normalizer=norm, mesh=m1), big)

    cases["hm_1d_state"] = hm_1d_state
    cases["uneven_reinhard"] = lambda: out(
        StainNormalizerTransform("reinhard", reference=ref, mesh=m1), big[:5])
    cases["single_3d_reinhard"] = lambda: out(
        StainNormalizerTransform("reinhard", reference=ref, mesh=m1), big[0])
    cases["error_layout_c4"] = lambda: error_of(lambda: StainNormalizerTransform(
        "macenko", reference=ref, mesh=m1)(np.zeros((8, 4, 32, 32), np.uint8)))
    cases["error_layout_5d"] = lambda: error_of(lambda: StainNormalizerTransform(
        "macenko", reference=ref, mesh=m1)(np.zeros((8, 4, 3, 32, 32), np.uint8)))
    cases["error_channels_last"] = lambda: error_of(lambda: StainNormalizerTransform(
        normalizer=HistogramMatching(device="cpu", channel_axis=-1),
        reference=np.zeros((1, 16, 16, 3), np.uint8), mesh=m1))
    cases["error_pixel_axis_without_mesh"] = lambda: error_of(lambda: StainNormalizerTransform(
        "macenko", reference=ref, pixel_axis="pixel"))
    cases["px_reference_macenko"] = lambda: out(
        StainNormalizerTransform("macenko", reference=ref, mesh=m2, pixel_axis="pixel"), big)
    cases["px_batch_whole_macenko"] = lambda: out(StainNormalizerTransform(
        "macenko", mode="batch", batch_ref_index=None, mesh=m2, pixel_axis="pixel"), big)
    cases["px_batch_index_macenko"] = lambda: out(StainNormalizerTransform(
        "macenko", mode="batch", batch_ref_index=0, mesh=m2, pixel_axis="pixel"), big)
    cases["dtensor_batch_index_macenko"] = lambda: out(
        StainNormalizerTransform("macenko", mode="batch", batch_ref_index=5, mesh=m1),
        distribute_tensor(torch.as_tensor(big), m1, [Shard(0)]))
    cases["dtensor_px_batch_index_reinhard"] = lambda: out(
        StainNormalizerTransform("reinhard", mode="batch", batch_ref_index=6, mesh=m2,
                                 pixel_axis="pixel"),
        distribute_tensor(torch.as_tensor(big), m2, [Shard(0), Shard(2)]))
    cases["dtensor_batch_index_hm"] = lambda: out(
        StainNormalizerTransform("histogram_matching", mode="batch", batch_ref_index=2, mesh=m2),
        distribute_tensor(torch.as_tensor(big), m2, [Shard(0), Replicate()]))
    m3 = meshes["3d_122"]
    cases["mesh3d_px_reference_macenko"] = lambda: out(
        StainNormalizerTransform("macenko", reference=ref, mesh=m3, pixel_axis="pixel"), big)
    cases["mesh3d_px_batch_whole_reinhard"] = lambda: out(StainNormalizerTransform(
        "reinhard", mode="batch", batch_ref_index=None, mesh=m3, pixel_axis="pixel"), big)
    cases["mesh3d_px_batch_index_hm"] = lambda: out(StainNormalizerTransform(
        "histogram_matching", mode="batch", batch_ref_index=1, mesh=m3, pixel_axis="pixel"), big)
    cases["dtensor_other_mesh_batch_index_macenko"] = lambda: out(
        StainNormalizerTransform("macenko", mode="batch", batch_ref_index=4, mesh=m2,
                                 pixel_axis="pixel"),
        distribute_tensor(torch.as_tensor(big), m1, [Shard(0)]))
    return cases


def check(got: dict, want: dict, fit: str | None = None, error: str | None = None) -> None:
    """Hold a port result against the JAX one by the gates of each key:
    ``pct`` bit for bit; ``out`` (a transform) within 1 grey level (1/255
    for float output); ``p0``/``p1`` by the fit gates of ``fit``
    (Reinhard mean and std rtol 1e-4, atol 1e-3; HM histograms atol 1e-6;
    Macenko HE atol 2e-5, maxC rtol 1e-4); ``error`` (a message) matching
    the regex ``error`` (on the JAX side where JAX has the case); ``same`` (port-only facts) all
    true."""
    import re

    assert set(want) <= set(got), f"keys {sorted(got)} against {sorted(want)}"
    if "same" in got:
        assert got["same"].all(), f"port facts {got['same']}"
    for key, w in want.items():
        g = got[key]
        if key == "pct":
            assert g.shape == w.shape and np.array_equal(g, w, equal_nan=True), (g, w)
        elif key == "out":
            assert g.shape == w.shape and g.dtype == w.dtype, (g.shape, g.dtype, w.shape, w.dtype)
            grey = 1.0 if w.dtype == np.uint8 or w.max() > 1.5 else 1.0 / 255.0 + 1e-6
            np.testing.assert_allclose(g.astype(np.float32), w.astype(np.float32), atol=grey, rtol=0)
        elif key in ("p0", "p1"):
            tol = {("reinhard", "p0"): dict(rtol=1e-4, atol=1e-3),
                   ("reinhard", "p1"): dict(rtol=1e-4, atol=1e-3),
                   ("histogram_matching", "p0"): dict(rtol=0, atol=1e-6),
                   ("macenko", "p0"): dict(rtol=0, atol=2e-5),
                   ("macenko", "p1"): dict(rtol=1e-4, atol=0)}[fit, key]
            np.testing.assert_allclose(g, w, **tol)
        elif key == "error":
            assert re.search(error, str(w)), f"JAX error {str(w)!r} does not match {error!r}"
        else:
            raise KeyError(key)
    if error is not None:
        msg = str(got["error"])
        assert re.search(error, msg), f"port error {msg!r} does not match {error!r}"


SUITE_CASES = {"batch": batch_cases, "pixel": pixel_cases, "mesh4": mesh4_cases, "nn": nn_cases}


def suite_case_names(suite: str) -> list[str]:
    """The case names of a suite, without a process group (the meshes are
    only named)."""
    return list(SUITE_CASES[suite]({"batch": None, "px": None, "2d": None, "batch4": None,
                                    "3d_221": None, "3d_122": None, "devices01": None,
                                    "first2": None}))


# ---------------------------------------------------------------- worker
def _meshes(suite: str) -> dict:
    from stainx_tpu_torch.parallel import make_mesh

    if suite == "batch":
        return {"batch": make_mesh(axis_names=("batch",), device_type="cpu")}
    if suite == "pixel":
        return {"px": make_mesh((1, 2), ("batch", "pixel"), device_type="cpu")}
    axes3 = ("batch", "pixel", "model")
    if suite == "mesh4":
        return {"2d": make_mesh((2, 2), ("batch", "pixel"), device_type="cpu"),
                "3d_221": make_mesh((2, 2, 1), axes3, device_type="cpu"),
                "3d_122": make_mesh((1, 2, 2), axes3, device_type="cpu"),
                "devices01": make_mesh(axis_names=("batch",), device_type="cpu", devices=[0, 1]),
                "first2": make_mesh((2,), ("batch",), device_type="cpu")}
    return {"batch4": make_mesh(axis_names=("batch",), device_type="cpu"),
            "2d": make_mesh((2, 2), ("batch", "pixel"), device_type="cpu"),
            "3d_122": make_mesh((1, 2, 2), axes3, device_type="cpu")}


def _same(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(
        a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
        and np.array_equal(a[k], b[k], equal_nan=a[k].dtype.kind == "f") for k in a)


def worker(suite: str, rank: int, world: int, init_file: str, out_dir: str) -> None:
    """Run every case of ``suite`` twice on this rank of a gloo group and
    pickle the results (module docstring)."""
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", world_size=world,
                            rank=rank, timeout=datetime.timedelta(seconds=60))
    try:
        cases = SUITE_CASES[suite](_meshes(suite))
        results = {}
        for name, case in cases.items():
            try:
                first, second = case(), case()
                results[name] = (first, _same(first, second))
            except Exception:  # the case fails alone; the suite goes on
                results[name] = traceback.format_exc()
        with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as f:
            pickle.dump(results, f)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------- parent
class Group:
    """A suite's worker processes, started at once; :meth:`results` joins
    them with a deadline, kills what is left and loads every rank's
    results."""

    def __init__(self, suite: str, tmp: Path):
        self.suite, self.world, self.tmp = suite, SUITES[suite], Path(tmp)
        env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT))
        self.logs = [open(self.tmp / f"rank{r}.log", "w") for r in range(self.world)]
        self.procs = [
            subprocess.Popen([sys.executable, __file__, suite, str(r), str(self.world),
                              str(self.tmp / "init"), str(self.tmp)],
                             stdout=log, stderr=subprocess.STDOUT, env=env, cwd=str(ROOT))
            for r, log in zip(range(self.world), self.logs)
        ]
        self._results = None

    def results(self, deadline_s: float = 240.0) -> list:
        if self._results is None:
            end = time.monotonic() + deadline_s
            try:
                for p in self.procs:
                    p.wait(timeout=max(0.0, end - time.monotonic()))
            except subprocess.TimeoutExpired:
                pass
            finally:
                for p in self.procs:
                    if p.poll() is None:
                        p.kill()
                        p.wait()
                for log in self.logs:
                    log.close()
            self._results = []
            for r in range(self.world):
                path = self.tmp / f"rank{r}.pkl"
                if path.exists():
                    with open(path, "rb") as f:
                        self._results.append(pickle.load(f))
                else:
                    self._results.append((self.tmp / f"rank{r}.log").read_text()[-4000:])
        return self._results

    def case(self, name: str) -> dict:
        """Rank 0's result of case ``name``, after checking that every rank
        finished it, got the same bits, and repeated them on a second run."""
        per_rank = self.results()
        for r, res in enumerate(per_rank):
            if isinstance(res, str):
                raise AssertionError(f"rank {r} of suite {self.suite} did not finish:\n{res}")
            if isinstance(res[name], str):
                raise AssertionError(f"rank {r}, case {name}:\n{res[name]}")
        first, repeat_equal = per_rank[0][name]
        assert repeat_equal, f"case {name}: a second run on rank 0 differs"
        for r in range(1, self.world):
            other, again = per_rank[r][name]
            assert again, f"case {name}: a second run on rank {r} differs"
            assert _same(first, other), f"case {name}: rank {r} differs from rank 0"
        return first


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    suite_name, rank_s, world_s, init_path, out_path = sys.argv[1:6]
    worker(suite_name, int(rank_s), int(world_s), init_path, out_path)
