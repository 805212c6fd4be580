"""Randomized parity sweep of the port on the CPU.

The port's counterpart of ``tests/test_fuzz_parity.py``. Every check on the
card uses fixed shapes; this sweep draws the shapes between them, on the
port's CPU path (``device="cpu"``: the kernels' plain versions, which take
the route an H100 takes, ``ops/macenko.py::CPU_ROUTE_SMEM``):

- the JAX sweep's own cases (``_random_case``: the same 12 seeds, uint8
  and float32 [0, 1], extents 17-96, batches of 1-4, a white patch in half
  of them) against the numpy oracle at that sweep's gates (Macenko MAE ≤
  0.35; Reinhard and histogram matching, on its dense-noise fixtures,
  within 1 grey level or 1/255), and against ``stainx_tpu`` (backend
  ``xla``) on the same arrays within the cross-path contracts (fit HE atol
  2e-5 and maxC rtol 1e-4, Macenko and Reinhard outputs within 1 grey
  level, histogram matching bit for bit);
- the Macenko route edges of ``ops/macenko.py``, where each side runs
  another plain code path: rows of B1 or B4 (uint8 at 50 176 pixels,
  float32 at 25 600) and pools of B2 or B5 (uint8 past 19 850 pixels,
  float32 past 10 918, from ``fit_route`` at the H100's shared memory),
  each at the last size below the edge, the first above it and one H × W
  drawn at random within 1 % on each side; the route each case took is
  read from the plain versions' ``stream`` flag. They are held against
  ``stainx_tpu`` (backend ``xla``) and the oracle;
- a tile whose pixels past β project mostly to negative concentrations
  (the maxC sign guard) and a tile with fewer than 3 pixels past β (the
  transform's fallback), at seeded sizes, against ``stainx_tpu``;
- seeded odd-H pixel-sharded transforms (``transform_on_mesh`` with
  ``pixel_axis``) on a 2-rank gloo group (``tests/torch_parallel_cases.py``
  suite "knife"): every rank and a second run the same bits, histogram
  matching bit for bit the single-process call. The pixel-sharded Macenko
  transform adds float32 partials by rank, so it is held at 1 grey level of
  the single-process call, as ``tests/test_parallel.py`` holds JAX's.

The JAX references are computed by a pool of worker processes while the
port's side runs in this one (tracing and compiling a JAX program for each
random shape is most of the file's time), each case its own test. Seeds
are fixed, so a failure reproduces.
"""

from __future__ import annotations

import math
import multiprocessing
from concurrent.futures import ProcessPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stainx_tpu
from stainx_tpu.ops import macenko as jax_mk
from stainx_tpu_torch import HistogramMatching, Macenko, Reinhard
from stainx_tpu_torch.kernels import macenko_fused as mf
from stainx_tpu_torch.ops import histogram_matching as hm_ops
from stainx_tpu_torch.ops import macenko as mk
from tests import torch_parallel_cases as cases
from tests.oracles import numpy_reference as oracle
from tests.test_fuzz_parity import _N_CASES, _random_case

MAE_GATE = 0.35  # Macenko against the oracle (docs/correctness_report.md)
HE_ATOL, MC_RTOL, GREY = 2e-5, 1e-4, 1.0  # the cross-path contracts (tests/test_kernels.py)
JAX_WORKERS = 4  # processes that compute the JAX references


# ------------------------------------------------------------------ inputs
def sweep_inputs(seed: int, as_float: bool):
    """The JAX sweep's arrays of one case: ``(ref, batch)`` of
    ``_random_case`` and its dense-noise histogram-matching fixtures."""
    ref, batch = _random_case(seed)
    rng = np.random.default_rng(seed * 101 + 13)
    hh, wh = max(ref.shape[2], 64), max(ref.shape[3], 64)
    ref_h = rng.integers(0, 256, size=(1, 3, hh, wh), dtype=np.uint8)
    batch_h = rng.integers(0, 256, size=(batch.shape[0], 3, hh, wh), dtype=np.uint8)
    arrays = (ref, batch, ref_h, batch_h)
    if as_float:
        arrays = tuple(a.astype(np.float32) / 255.0 for a in arrays)
    return arrays


def _last_mega_pool(dtype: torch.dtype) -> int:
    """The largest pool ``fit_route`` gives B2 at the H100's shared memory."""
    lo, hi = 1, 1 << 20
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if mk.fit_route(mid, dtype, mk.CPU_ROUTE_SMEM) == "mega":
            lo = mid
        else:
            hi = mid - 1
    return lo


# name: (what, numpy dtype, the last size below the edge)
EDGES = {
    "transform_u8": ("transform", np.uint8, mk.STREAM_MIN_ELEMS - 1),
    "transform_f32": ("transform", np.float32, mk.STREAM_MIN_ELEMS_F32 - 1),
    "fit_u8": ("fit", np.uint8, _last_mega_pool(torch.uint8)),
    "fit_f32": ("fit", np.float32, _last_mega_pool(torch.float32)),
}
EDGE_CASES = [(edge, side, draw) for edge in EDGES for side in ("below", "above")
              for draw in ("exact", "random")]


def _most_square(p: int) -> tuple[int, int]:
    h = math.isqrt(p)
    while p % h:
        h -= 1
    return h, p // h


def edge_shape(edge: str, side: str, draw: str) -> tuple[int, int, int]:
    """``(n, h, w)`` of an edge case: a row of h·w pixels (a transform of n
    rows) or a pool of n·h·w (a fit). ``exact``: the last size below the
    edge or the first above it, as square as it factors; ``random``: H and
    W drawn within 1 % of the edge on ``side``."""
    what, _, last = EDGES[edge]
    edge_at = last + 1
    if draw == "exact":
        h, w = _most_square(last if side == "below" else edge_at)
        return 1, h, w
    lo, hi = ((math.ceil(0.99 * edge_at), last) if side == "below"
              else (edge_at, math.floor(1.01 * edge_at)))
    rng = np.random.default_rng([sorted(EDGES).index(edge), side == "above", 7])
    n = int(rng.integers(1, 4)) if what == "fit" else int(rng.integers(1, 3))
    per = 1 if what == "transform" else n  # images a size counts
    while True:
        h = int(rng.integers(math.isqrt(lo // per) * 3 // 4, math.isqrt(hi // per) * 4 // 3))
        w_lo, w_hi = -(-lo // (per * h)), hi // (per * h)
        if w_lo <= w_hi:
            return n, h, int(rng.integers(w_lo, w_hi + 1))


def he_tiles(n: int, h: int, w: int, seed: int, dtype) -> np.ndarray:
    tiles = np.concatenate([oracle.synthetic_he_tile(h, w, seed=seed + i, he_scale=1.0 + 0.05 * i)
                            for i in range(n)])
    return tiles if dtype == np.uint8 else tiles.astype(np.float32) / 255.0


def negative_maxc_tile(seed: int) -> np.ndarray:
    """The 64² OD design of ``tests/test_kernels.py::
    test_negative_max_concentration_tile`` drawn from ``seed`` (0 is that
    test's tile): a bulk cluster, an anchor and a satellite clump more than
    π away in the stain plane, over a diluted background, so the second
    stain's 99th-percentile concentration is negative."""
    rng = np.random.default_rng(seed)
    n = 64
    n_bg, n_sat, n_anchor = 2560, 20, 16
    n_bulk = n * n - n_bg - n_sat - n_anchor
    d = np.ones(3) / np.sqrt(3)
    t1 = np.array([1.0, -1.0, 0.0]) / np.sqrt(2)
    t2 = np.array([1.0, 1.0, -2.0]) / np.sqrt(6)

    def v(psi):
        return np.cos(psi)[..., None] * t1 + np.sin(psi)[..., None] * t2

    psis, rs = rng.uniform(0.05, 0.2, n_bulk), rng.uniform(0.06, 0.10, n_bulk)
    od = np.concatenate([
        0.5 * d + rs[:, None] * v(psis),
        0.5 * d + 0.08 * v(np.full(n_anchor, -0.2)),
        0.5 * d + 0.09 * v(-2.8 + rng.uniform(-0.02, 0.02, n_sat)),
        np.tile(0.17 * (0.5 * d + 0.08 * v(np.array(0.125))), (n_bg, 1)),
    ])
    tile = np.clip(np.round(240.0 * np.exp(-od) - 1.0), 0, 255).astype(np.uint8)
    rng.shuffle(tile, axis=0)
    return np.ascontiguousarray(tile.T.reshape(1, 3, n, n))


def fallback_tile(seed: int) -> np.ndarray:
    """A seeded odd-size tile whose red plane is light (OD below β) but for
    two pixels: fewer than 3 survive the β-mask, so the transform takes
    every pixel's moments and angles."""
    rng = np.random.default_rng(seed)
    h, w = 2 * int(rng.integers(20, 48)) + 1, 2 * int(rng.integers(20, 48)) + 1
    tile = oracle.synthetic_he_tile(h, w, seed=seed + 11).copy()
    tile[0, 0] = np.maximum(tile[0, 0], 215)
    for y, x in zip(rng.choice(h, 2, replace=False), rng.choice(w, 2, replace=False)):
        tile[0, :, y, x] = rng.integers(60, 140, 3)
    return tile


NEGATIVE_SEEDS = (0, 1, 2)
FALLBACK_SEEDS = (3, 4)
REFERENCE = oracle.synthetic_he_tile(64, 64, seed=3)  # the transform cases' reference


def reference_params():
    he, mc = oracle.macenko_fit(REFERENCE)
    return np.asarray(he, np.float32), np.asarray(mc, np.float32).reshape(2)


# ------------------------------------------------------------- JAX side
def _jax_sweep(seed: int, as_float: bool) -> dict:
    ref, batch, ref_h, batch_h = sweep_inputs(seed, as_float)
    macenko = stainx_tpu.Macenko(backend="xla").fit(ref)
    return {
        "he": np.asarray(macenko._stain_matrix),
        "mc": np.asarray(macenko._target_max_conc).reshape(-1),
        "macenko": np.asarray(macenko.transform(batch)),
        "reinhard": np.asarray(stainx_tpu.Reinhard(backend="xla").fit(ref).transform(batch)),
        "hm": np.asarray(stainx_tpu.HistogramMatching(backend="xla").fit(ref_h).transform(batch_h)),
    }


def _jax_fit(x: np.ndarray) -> dict:
    he, mc = jax_mk.macenko_fit(jnp.asarray(x), use_pallas=False)
    return {"he": np.asarray(he), "mc": np.asarray(mc).reshape(-1),
            "out": _jax_transform(he_tiles(1, 48, 48, 77, x.dtype.type), np.asarray(he),
                                  np.asarray(mc))}


def _jax_transform(x: np.ndarray, he, mc) -> np.ndarray:
    return np.asarray(jax_mk.macenko_transform(jnp.asarray(x), jnp.asarray(he), jnp.asarray(mc),
                                               use_pallas=False))


def edge_inputs(edge: str, side: str, draw: str) -> np.ndarray:
    n, h, w = edge_shape(edge, side, draw)
    return he_tiles(n, h, w, 1000 + 10 * EDGE_CASES.index((edge, side, draw)), EDGES[edge][1])


def _jax_edge(edge: str, side: str, draw: str) -> dict:
    x = edge_inputs(edge, side, draw)
    if EDGES[edge][0] == "fit":
        return _jax_fit(x)
    return {"out": _jax_transform(x, *reference_params())}


def _jax_negative(seed: int) -> dict:
    """Both JAX routes on the tile: each one's fit, the tile's transform
    under the well-posed reference, and the probe's under each fit."""
    tile, ref_params = negative_maxc_tile(seed), reference_params()
    probe = he_tiles(1, 48, 48, 77, np.uint8)
    out = {}
    for route, use_pallas in (("xla", False), ("pallas", True)):
        he, mc = jax_mk.macenko_fit(jnp.asarray(tile), use_pallas=use_pallas)
        out[route] = {
            "he": np.asarray(he), "mc": np.asarray(mc).reshape(-1),
            "probe": _jax_transform(probe, np.asarray(he), np.asarray(mc)),
            "tile": np.asarray(jax_mk.macenko_transform(
                jnp.asarray(tile), *(jnp.asarray(a) for a in ref_params), use_pallas=use_pallas)),
        }
    return out


def _jax_fallback(seed: int) -> dict:
    return {"out": _jax_transform(fallback_tile(seed), *reference_params())}


def _jax_worker(cache_dir: str) -> None:
    """A worker's JAX: the CPU, and the compile cache of this process
    (``tests/conftest.py``'s settings)."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.3)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)


@pytest.fixture(scope="module")
def jax_side():
    """Every case's JAX results, computed by a pool of spawned worker
    processes: ``{case: future}``; a case's test waits on its own."""
    import jax

    pool = ProcessPoolExecutor(JAX_WORKERS, mp_context=multiprocessing.get_context("spawn"),
                               initializer=_jax_worker,
                               initargs=(jax.config.jax_compilation_cache_dir,))
    futures = {}
    for as_float in (False, True):
        for seed in range(_N_CASES):
            futures["sweep", seed, as_float] = pool.submit(_jax_sweep, seed, as_float)
    for case in EDGE_CASES:
        futures[("edge", *case)] = pool.submit(_jax_edge, *case)
    for seed in NEGATIVE_SEEDS:
        futures["negative_maxc", seed] = pool.submit(_jax_negative, seed)
    for seed in FALLBACK_SEEDS:
        futures["fallback", seed] = pool.submit(_jax_fallback, seed)
    yield futures
    pool.shutdown(wait=True, cancel_futures=True)


@pytest.fixture(scope="module")
def knife(tmp_path_factory):
    """The 2-rank gloo group of the "knife" suite, started at once."""
    return cases.Group("knife", tmp_path_factory.mktemp("knife"))


# -------------------------------------------------------------- helpers
def _grey_diff(got, want) -> np.ndarray:
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    return np.abs(got.astype(np.float32) - np.asarray(want).astype(np.float32))


def _assert_fit(he, mc, want: dict, what: str) -> None:
    np.testing.assert_allclose(he.numpy(), want["he"], atol=HE_ATOL, rtol=0, err_msg=what)
    np.testing.assert_allclose(mc.numpy().reshape(-1), want["mc"], atol=0, rtol=MC_RTOL,
                               err_msg=what)


def _params(he, mc):
    return torch.as_tensor(he), torch.as_tensor(mc)


@pytest.fixture
def fit_routes(monkeypatch):
    """The ``stream`` flag of every plain fit and transform run: B5/B4's
    plain versions pass True, B2/B1's False."""
    seen = {"fit": [], "transform": []}
    fit, transform = mf.fit_plain, mf.transform_plain

    def fit_spy(images, stream=False):
        seen["fit"].append(stream)
        return fit(images, stream=stream)

    def transform_spy(images, stain_matrix, target_max_conc, stream=False):
        seen["transform"].append(stream)
        return transform(images, stain_matrix, target_max_conc, stream=stream)

    monkeypatch.setattr(mf, "fit_plain", fit_spy)
    monkeypatch.setattr(mf, "transform_plain", transform_spy)
    return seen


# ----------------------------------------------------------------- tests
@pytest.mark.parametrize("seed", range(_N_CASES))
@pytest.mark.parametrize("as_float", [False, True])
def test_sweep(jax_side, seed, as_float):
    """One case of the JAX sweep through the port: the oracle gates, then
    ``stainx_tpu`` on the same arrays."""
    ref, batch, ref_h, batch_h = sweep_inputs(seed, as_float)
    grey = 1.0 / 255.0 if as_float else 1.0
    what = f"seed {seed}, shape {batch.shape}, {batch.dtype}"

    macenko = Macenko(device="cpu").fit(ref)
    got_m = macenko.transform(batch)
    assert got_m.dtype == torch.from_numpy(batch).dtype and torch.isfinite(got_m.float()).all()
    he_o, mc_o = oracle.macenko_fit(ref)
    mae = _grey_diff(got_m, oracle.macenko_transform(batch, he_o, mc_o)).mean()
    assert mae <= MAE_GATE, f"macenko MAE {mae} ({what})"
    got_r = Reinhard(device="cpu").fit(ref).transform(batch)
    diff_r = _grey_diff(got_r, oracle.reinhard_transform(batch, *oracle.reinhard_fit(ref))).max()
    assert diff_r <= grey * (1.0 + 1e-5), f"reinhard maxdiff {diff_r} ({what})"
    got_h = HistogramMatching(device="cpu").fit(ref_h).transform(batch_h)
    diff_h = _grey_diff(got_h, oracle.hm_transform(batch_h, oracle.hm_fit(ref_h))).max()
    assert diff_h <= grey * (1.0 + 1e-5), f"hm maxdiff {diff_h} ({what})"

    want = jax_side["sweep", seed, as_float].result()
    _assert_fit(macenko._stain_matrix, macenko._target_max_conc, want, what)
    assert _grey_diff(got_m, want["macenko"]).max() <= GREY, what
    assert _grey_diff(got_r, want["reinhard"]).max() <= grey * (1.0 + 1e-5), what
    np.testing.assert_array_equal(got_h.numpy(), want["hm"], err_msg=what)


def test_edges_are_the_ladders():
    """The edges the cases straddle are the ladder's: B4 from 50 176 uint8
    and 25 600 float32 pixels a row, B5 past 19 850 uint8 and 10 918
    float32 pooled pixels on an H100's shared memory."""
    assert [EDGES[e][2] + 1 for e in EDGES] == [50_176, 25_600, 19_851, 10_919]
    for edge, side, draw in EDGE_CASES:
        n, h, w = edge_shape(edge, side, draw)
        what, _, last = EDGES[edge]
        size = h * w * (n if what == "fit" else 1)
        assert (size <= last) == (side == "below"), (edge, side, draw, n, h, w)
        assert abs(size - (last + 1)) <= 0.01 * (last + 1) + 1


@pytest.mark.parametrize("edge, side, draw", EDGE_CASES)
def test_route_edge(jax_side, fit_routes, edge, side, draw):
    """One side of a route edge: the plain path the H100's route names,
    held against ``stainx_tpu`` (backend ``xla``) and the oracle."""
    x = edge_inputs(edge, side, draw)
    what, _, _ = EDGES[edge]
    label = f"{edge} {side} {draw}: {x.shape} {x.dtype}"
    want = jax_side["edge", edge, side, draw].result()
    if what == "fit":
        he, mc = mk.macenko_fit(torch.from_numpy(x))
        assert fit_routes["fit"] == [side == "above"], label
        _assert_fit(he, mc, want, label)
        probe = he_tiles(1, 48, 48, 77, x.dtype.type)
        out = mk.macenko_transform(torch.from_numpy(probe), he, mc)
        assert _grey_diff(out, want["out"]).max() <= GREY, label
        he_o, mc_o = oracle.macenko_fit(x)
        np.testing.assert_allclose(he.numpy(), he_o, atol=5e-3, err_msg=label)
        mae = _grey_diff(out, oracle.macenko_transform(probe, he_o, mc_o)).mean()
    else:
        he, mc = reference_params()
        out = mk.macenko_transform(torch.from_numpy(x), *_params(he, mc))
        assert fit_routes["transform"] == [side == "above"], label
        assert out.dtype == torch.from_numpy(x).dtype and out.shape == x.shape
        assert _grey_diff(out, want["out"]).max() <= GREY, label
        mae = _grey_diff(out, oracle.macenko_transform(x, he, mc)).mean()
    assert mae <= MAE_GATE, f"{label}: MAE {mae}"


@pytest.mark.parametrize("seed", NEGATIVE_SEEDS)
def test_negative_max_concentration_tile(jax_side, seed):
    """The maxC sign guard, on a tile whose fit gives a negative maxC. No
    cross-path contract holds on such a tile: its percentile picks flip
    between float32 sums of different order, and the JAX package's own two
    routes disagree past them (its pallas fit is not even in the negative
    regime). So the port is held to the behaviour of ``tests/
    test_kernels.py`` (the regime, a finite transform, under half of it
    saturated) and to lie within the JAX routes' own spread."""
    tile = negative_maxc_tile(seed)
    want = jax_side["negative_maxc", seed].result()
    xla, pallas = want["xla"], want["pallas"]
    he, mc = mk.macenko_fit(torch.from_numpy(tile))
    assert float(mc[1]) < -0.005 and float(xla["mc"][1]) < -0.005
    spread_he = np.abs(xla["he"] - pallas["he"]).max()
    assert spread_he > HE_ATOL and float(pallas["mc"][1]) > 0.0  # the JAX package's own
    assert np.abs(he.numpy() - xla["he"]).max() <= spread_he
    probe = he_tiles(1, 48, 48, 77, np.uint8)
    got_probe = mk.macenko_transform(torch.from_numpy(probe), he, mc)
    spread = _grey_diff(xla["probe"], pallas["probe"]).max()
    assert _grey_diff(got_probe, xla["probe"]).max() <= max(spread, GREY)
    out = mk.macenko_transform(torch.from_numpy(tile), *_params(*reference_params())).float()
    assert torch.isfinite(out).all() and ((out == 0) | (out == 255)).float().mean() < 0.5
    spread = _grey_diff(xla["tile"], pallas["tile"]).max()
    assert _grey_diff(out, xla["tile"]).max() <= max(spread, GREY)


@pytest.mark.parametrize("seed", FALLBACK_SEEDS)
def test_fallback_tile(jax_side, seed):
    """Fewer than 3 pixels past β: the transform takes every pixel."""
    tile = fallback_tile(seed)
    od = -np.log((tile.astype(np.float32) + 1.0) / 240.0)
    assert (od.min(axis=1) >= mk.BETA).sum() == 2
    out = mk.macenko_transform(torch.from_numpy(tile), *_params(*reference_params()))
    assert _grey_diff(out, jax_side["fallback", seed].result()["out"]).max() <= GREY


@pytest.mark.parametrize("seed", cases.KNIFE_SEEDS)
def test_pixel_sharded_odd_h(knife, seed):
    """A seeded odd-H pixel-sharded transform on 2 gloo ranks (every rank
    and a second run the same bits) against the single-process call:
    histogram matching bit for bit (integer counts reduce exactly), Macenko
    within 1 grey level (float32 partials added by rank)."""
    got = knife.case(f"odd_h_{seed}")["out"]
    method, batch, ref = cases.knife_case(seed)
    assert batch.shape[2] % 2 == 1
    params = cases.oracle_params(method, ref)
    if method == "histogram_matching":
        single = hm_ops.hm_transform(torch.from_numpy(batch), torch.from_numpy(params))
        np.testing.assert_array_equal(got, single.numpy())
    else:
        single = mk.macenko_transform(torch.from_numpy(batch), *_params(*params))
        assert got.dtype == single.numpy().dtype and got.shape == batch.shape
        assert _grey_diff(got, single).max() <= GREY


# ------------------------------------------------ the repair the sweep forced
@pytest.mark.parametrize("n, h, w", [(3, 85, 67), (1, 97, 89)])
@pytest.mark.parametrize("out_dtype", [torch.uint8, torch.float32])
def test_hm_lut_as_the_jax_transform_compiles_it(n, h, w, out_dtype):
    """The histogram-matching LUT and table bit for bit those of the JAX
    transform as compiled: ``hm_transform`` divides by the pixel count and
    by 255, constants of its program, which XLA folds into products with
    their float32 reciprocals. The port divided, one grey level off the
    JAX package on some pixels at pixel counts that are not a power of two
    (the sweep's seeds 0, 3, 4, 8 and 10 on uint8, every float seed)."""
    import jax

    from stainx_tpu.ops import histogram_matching as jax_hm
    from stainx_tpu_torch.kernels import histogram as hk

    rng = np.random.default_rng(n * h * w)
    values = torch.from_numpy(rng.integers(0, 256, (n, 3, h * w), dtype=np.uint8))
    ref = np.array(jax_hm.hm_fit(jnp.asarray(rng.integers(0, 256, (1, 3, 61, 59), np.uint8))))
    counts = hk.histogram_256_plain(values)
    build = jax.jit(jax_hm.hm_build_lut, static_argnums=2)
    want = np.asarray(build(jnp.asarray(counts.numpy()), jnp.asarray(ref), float(n * h * w)))
    out, lut, table = hk.hm_transfer(values, torch.from_numpy(ref), out_dtype)
    np.testing.assert_array_equal(lut.numpy(), want)
    if out_dtype == torch.float32:
        to_float = jax.jit(lambda m: jnp.clip(m / 255.0, 0.0, 1.0))
        np.testing.assert_array_equal(table.numpy(), np.asarray(to_float(jnp.asarray(want))))
    images = values.reshape(n, 3, h, w)
    if out_dtype == torch.float32:
        images = images.to(torch.float32) / 255.0
    jax_out = jax_hm.hm_transform(jnp.asarray(images.numpy()), jnp.asarray(ref))
    np.testing.assert_array_equal(out.reshape(images.shape).numpy(), np.asarray(jax_out))


def test_hm_pixel_sharded_division_is_jax_s_own():
    """The JAX package's pixel-sharded HM transform divides by the pixel
    total it reduced (a value, not a constant of the program), so its LUT
    differs from its own single-device transform's at odd pixel counts,
    here by one grey level. The port builds the single-device LUT on both
    paths (``test_pixel_sharded_odd_h``), so it holds its mesh path to the
    JAX one within 1 grey level and to the single-device JAX bits."""
    import jax

    from stainx_tpu import parallel as jp
    from stainx_tpu.ops import histogram_matching as jax_hm

    rng = np.random.default_rng(5)
    batch = rng.integers(0, 256, (2, 3, 75, 61), dtype=np.uint8)
    ref = np.array(jax_hm.hm_fit(jnp.asarray(rng.integers(0, 256, (1, 3, 75, 61), np.uint8))))
    mesh = jp.make_mesh(shape=(1, 2), axis_names=("batch", "pixel"), devices=jax.devices()[:2])
    jax_mesh = np.asarray(jp.transform_on_mesh("histogram_matching", batch, jnp.asarray(ref), mesh,
                                               pixel_axis="pixel"))
    jax_single = np.asarray(jax_hm.hm_transform(jnp.asarray(batch), jnp.asarray(ref)))
    assert (jax_mesh != jax_single).any() and _grey_diff(jax_mesh, jax_single).max() == GREY
    port = hm_ops.hm_transform(torch.from_numpy(batch), torch.from_numpy(ref)).numpy()
    np.testing.assert_array_equal(port, jax_single)
