"""The PyTorch port's streaming tier (B4, B5, B6) against the JAX package, on the CPU.

On a CPU tensor each wrapper runs its plain PyTorch version; the JAX kernels
run in interpret mode (four calls, in module-scoped fixtures: they take
seconds each here) or through their plain twins and the XLA path.
Tolerances are the JAX repo's own: B6 bit-exact against
``kth_smallest_streaming_reference`` (both return the element at the
clamped nearest rank); the fit HE atol 2e-5 and maxC rtol 1e-4 and the
transform within 1 grey level (``tests/test_kernels.py``: float32 sums in
another order move a selected pixel by an ulp-level rank tie or a truncated
uint8 by one level).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from stainx_tpu.kernels.macenko_stream import macenko_fit_stream as jax_fit_stream
from stainx_tpu.kernels.macenko_stream import macenko_transform_stream as jax_transform_stream
from stainx_tpu.kernels.selection_stream import _init_keys as jax_init_keys
from stainx_tpu.kernels.selection_stream import kth_smallest_streaming_reference
from stainx_tpu.ops import macenko as jax_mk
from stainx_tpu_torch import Macenko, kernels, profiling
from stainx_tpu_torch.kernels import macenko_fused as mf
from stainx_tpu_torch.kernels import macenko_stream as ms
from stainx_tpu_torch.kernels import selection as sel
from stainx_tpu_torch.kernels import selection_stream as ss
from stainx_tpu_torch.ops import macenko as mk
from stainx_tpu_torch.ops import percentile as pct

from tests.oracles import numpy_reference as oracle

HE_ATOL, MC_RTOL, GREY = 2e-5, 1e-4, 1.0


def _t(a):
    return torch.as_tensor(np.array(a))


def _tiles(n, h, w, seed, he_scale=1.0):
    return np.concatenate(
        [oracle.synthetic_he_tile(h, w, seed=seed + i, he_scale=he_scale) for i in range(n)]
    )


def _f32(x_u8):
    return x_u8.astype(np.float32) / 255.0


def _assert_fit_close(got, want):
    np.testing.assert_allclose(np.asarray(got[0]), np.asarray(want[0]), atol=HE_ATOL)
    np.testing.assert_allclose(
        np.asarray(got[1]).reshape(-1), np.asarray(want[1]).reshape(-1), rtol=MC_RTOL
    )


def _assert_grey_close(got, want):
    np.testing.assert_allclose(
        np.asarray(got, np.float32), np.asarray(want).astype(np.float32), atol=GREY, rtol=0
    )


# ------------------------------------------------------------------- B6
def _field(rows, p, seed):
    """Rows with negative values, ±0, duplicates, +inf sentinels; the last
    row is empty (all sentinels)."""
    rng = np.random.default_rng(seed)
    x = np.round(rng.standard_normal((rows, p)) * 8.0) / 8.0  # heavy duplicates
    x[:, ::7] = rng.standard_normal((rows, len(range(0, p, 7))))
    x[0, :3] = [0.0, -0.0, -0.0]
    x[rng.random((rows, p)) < 0.3] = np.inf
    x[-1] = np.inf
    return x.astype(np.float32)


def _init(x):
    valid = x < np.inf
    lo = np.where(valid, x, np.inf).min(1)
    hi = np.where(valid, x, -np.inf).max(1)
    return lo.astype(np.float32), hi.astype(np.float32), valid.sum(1).astype(np.int32)


class TestSelection:
    @pytest.mark.parametrize(
        "rows,p,ranks,with_init",
        [
            (3, 257, [[0], [128], [5]], False),
            (3, 257, [[256], [40], [0]], True),
            (2, 1000, [[10, 990], [0, 5000]], False),
            (2, 1000, [[699, 700], [3, 4]], True),
        ],
        ids=["k1", "k1-init", "k2-past-count", "k2-init"],
    )
    def test_plain_matches_jax_twin_bit_for_bit(self, rows, p, ranks, with_init):
        x = _field(rows, p, seed=p + rows)
        r = np.array(ranks, np.int32)
        init = _init(x) if with_init else None
        want = np.asarray(
            kth_smallest_streaming_reference(
                jnp.asarray(x), jnp.asarray(r),
                None if init is None else tuple(jnp.asarray(a) for a in init),
            )
        )
        got = ss.kth_smallest_streaming(
            _t(x), _t(r), None if init is None else tuple(_t(a) for a in init)
        ).numpy()
        assert got.dtype == np.float32 and got.shape == r.shape
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
        assert np.isinf(got[-1]).all()  # the empty row

    def test_count_zero_init_gives_inf(self):
        """A count of 0 in the init gives +inf, whatever the row holds (the
        JAX twin resolves such a row to the sentinel without a sweep)."""
        x = _field(2, 64, seed=3)
        lo, hi, n = _init(x)
        n[0] = 0
        want = np.asarray(
            kth_smallest_streaming_reference(
                jnp.asarray(x), jnp.zeros((2, 1), jnp.int32), tuple(jnp.asarray(a) for a in (lo, hi, n))
            )
        )
        got = ss.kth_smallest_streaming_plain(_t(x), torch.zeros(2, 1), (_t(lo), _t(hi), _t(n)))
        np.testing.assert_array_equal(got.numpy(), want)
        assert torch.isinf(got[0, 0])

    def test_empty_field(self):
        got = ss.kth_smallest_streaming(torch.zeros((2, 0)), torch.zeros((2, 3), dtype=torch.int32))
        assert got.shape == (2, 3) and torch.isinf(got).all()

    def test_init_keys_match_jax(self):
        lo, hi, n = _init(_field(3, 100, seed=5))
        want = np.asarray(jax_init_keys(tuple(jnp.asarray(a) for a in (lo, hi, n))))
        got = ss.init_keys(_t(lo), _t(hi), _t(n)).numpy()
        # JAX holds the signed view of the key (key ^ 2^31); the port its bits.
        np.testing.assert_array_equal(got[:-1, :2] ^ np.int32(-(2**31)), want[:-1, :2])
        np.testing.assert_array_equal(got[:, 2], want[:, 2])

    def test_shape_is_checked(self):
        with pytest.raises(ValueError, match=r"\(R, P\)"):
            ss.kth_smallest_streaming(torch.zeros(8), torch.zeros((1, 1), dtype=torch.int32))


# ------------------------------------------------------------------- B5
@pytest.fixture(scope="module")
def pool_u8():
    return _tiles(4, 128, 128, seed=11, he_scale=1.05)


@pytest.fixture(scope="module", params=["uint8", "float32"])
def pool_fits(request, pool_u8):
    """(dtype, pool, JAX streaming fit in interpret mode)."""
    pool = pool_u8 if request.param == "uint8" else _f32(pool_u8)
    return request.param, pool, jax_fit_stream(jnp.asarray(pool), interpret=True)


class TestFitStream:
    def test_plain_matches_jax_stream_kernel(self, pool_fits):
        _, pool, want = pool_fits
        _assert_fit_close(ms.macenko_fit_stream(_t(pool)), want)

    def test_plain_matches_jax_xla_path(self, pool_fits):
        _, pool, _ = pool_fits
        _assert_fit_close(ms.macenko_fit_stream_plain(_t(pool)), jax_mk.macenko_fit(jnp.asarray(pool)))

    def test_plain_selects_what_b2_selects(self, pool_fits):
        """B5's plain version selects through B6 on +inf-sentinel fields; B2's
        sorts masked keys. Both pick the same elements."""
        _, pool, _ = pool_fits
        he5, mc5 = ms.macenko_fit_stream_plain(_t(pool))
        he2, mc2 = mf.macenko_fit_mega_plain(_t(pool))
        assert torch.equal(he5, he2) and torch.equal(mc5, mc2)

    def test_white_pool_matches_jax_stream_kernel(self):
        """No β-surviving pixel: the angle field is empty and its selection
        +inf, so HE is NaN, as in every JAX route; maxC follows the JAX
        streaming kernel (its XLA route gives +inf there)."""
        white = np.full((1, 3, 32, 32), 255, np.uint8)
        he_j, mc_j = jax_fit_stream(jnp.asarray(white), interpret=True)
        he, mc = ms.macenko_fit_stream(_t(white))
        assert torch.isnan(he).all()
        np.testing.assert_array_equal(he.numpy(), np.asarray(he_j))
        np.testing.assert_array_equal(mc.numpy(), np.asarray(mc_j))


# ------------------------------------------------------------------- B4
@pytest.fixture(scope="module")
def fitted():
    he, mc = jax_mk.macenko_fit(jnp.asarray(oracle.synthetic_he_tile(64, 64, seed=42)))
    return np.asarray(he), np.asarray(mc)


class TestTransformStream:
    def test_plain_matches_jax_stream_kernel(self, fitted):
        """300×800 takes the JAX kernel through several chunks with a partial
        tail (its multi-chunk steady state)."""
        he, mc = fitted
        src = oracle.synthetic_he_tile(300, 800, seed=21, he_scale=1.15)
        want = jax_transform_stream(jnp.asarray(src), he, mc, interpret=True)
        got = ms.macenko_transform_stream(_t(src), _t(he), _t(mc))
        assert got.dtype == torch.uint8 and got.shape == src.shape
        _assert_grey_close(got.numpy(), want)

    @pytest.mark.parametrize("dtype", ["uint8", "float32"])
    def test_plain_matches_jax_xla_path(self, dtype, fitted):
        he, mc = fitted
        src = _tiles(2, 200, 350, seed=9, he_scale=1.2)
        src = src if dtype == "uint8" else _f32(src)
        want = jax_mk.macenko_transform(jnp.asarray(src), he, mc, use_pallas=False)
        got = ms.macenko_transform_stream_plain(_t(src), _t(he), _t(mc))
        assert got.dtype == getattr(torch, dtype)
        _assert_grey_close(got.numpy(), want)

    @pytest.mark.parametrize("shape", [(2, 37, 41), (1, 64, 64)], ids=["ragged", "square"])
    def test_plain_selects_what_b1_selects(self, shape, fitted):
        he, mc = fitted
        src = _t(_tiles(shape[0], shape[1], shape[2], seed=4))
        got = ms.macenko_transform_stream_plain(src, _t(he), _t(mc))
        assert torch.equal(got, mf.macenko_transform_mega_plain(src, _t(he), _t(mc)))

    @pytest.mark.parametrize("value", [255, 250])
    def test_uniform_tile_finite_and_uniform(self, value, fitted):
        """A 32² white (or uniform) tile takes the <3-pixel fallback; its
        covariance is exactly zero, so it is held against the JAX XLA path
        (as in ``tests/test_torch_macenko.py::TestEdgeTiles``)."""
        he, mc = fitted
        tile = np.full((1, 3, 32, 32), value, np.uint8)
        got = ms.macenko_transform_stream(_t(tile), _t(he), _t(mc)).float()
        assert torch.isfinite(got).all()
        flat = got.reshape(3, -1)
        assert (flat.amax(1) == flat.amin(1)).all()
        _assert_grey_close(got.numpy(), jax_mk.macenko_transform(jnp.asarray(tile), he, mc))

    def test_kernel_dtype_is_checked(self):
        with pytest.raises(TypeError, match="uint8 or float32"):
            ms.macenko_transform_stream(
                torch.zeros((1, 3, 8, 8), dtype=torch.int16), torch.zeros(3, 2), torch.ones(2)
            )


# ----------------------------------------------------------- route ladder
class TestRouteLadder:
    def test_thresholds_route_public_api_through_stream_wrappers(self, monkeypatch, fitted):
        """With the thresholds cut small, ``Macenko(device="cpu")`` fits and
        transforms through B5 and B4; the results are B2's and B1's."""
        calls = []

        def spy(fn):
            def wrapped(*args, **kwargs):
                calls.append(fn.__name__)
                return fn(*args, **kwargs)
            return wrapped

        ref = oracle.synthetic_he_tile(40, 48, seed=42)
        batch = _tiles(2, 40, 48, seed=3, he_scale=1.1)
        want = Macenko(device="cpu").fit(ref).transform(batch)
        assert mk.fit_route(40 * 48, torch.uint8, mk.CPU_ROUTE_SMEM) == "mega"
        assert mk.transform_route(2, 40 * 48, torch.uint8) == "mega"

        monkeypatch.setattr(mk, "STREAM_MIN_ELEMS", 40 * 48)
        monkeypatch.setattr(mk, "CPU_ROUTE_SMEM", 0)
        monkeypatch.setattr(ms, "macenko_fit_stream", spy(ms.macenko_fit_stream))
        monkeypatch.setattr(ms, "macenko_transform_stream", spy(ms.macenko_transform_stream))
        got = Macenko(device="cpu").fit(ref).transform(batch)
        assert calls == ["macenko_fit_stream", "macenko_transform_stream"]
        assert torch.equal(got, want)

    @pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float64])
    def test_other_floats_take_the_float32_ladder(self, monkeypatch, dtype):
        """Other float dtypes no longer ride the float32 ladder: with its
        thresholds cut small they still skip B5 and take the staged route,
        whose selections go to B3 or, past the select threshold, to B6."""
        calls = []
        monkeypatch.setattr(mk, "STREAM_MIN_ELEMS_F32", 16 * 16)
        monkeypatch.setattr(mk, "CPU_ROUTE_SMEM", 0)
        monkeypatch.setattr(ms, "macenko_fit_stream", lambda x: calls.append("B5"))
        monkeypatch.setattr(pct, "SELECT_STREAM_MIN_ELEMS", 16 * 16 * 2)
        b3, b6 = sel.kth_smallest_pallas, ss.kth_smallest_streaming
        monkeypatch.setattr(sel, "kth_smallest_pallas",
                            lambda x, r: calls.append(("B3", x.shape)) or b3(x, r))
        monkeypatch.setattr(ss, "kth_smallest_streaming",
                            lambda x, r, init=None: calls.append(("B6", x.shape)) or b6(x, r, init))
        x = torch.as_tensor(_f32(_tiles(2, 16, 16, seed=2))).to(dtype)
        mk.macenko_fit(x[:1])
        mk.macenko_fit(x)
        assert calls == [("B3", (1, 256)), ("B3", (2, 256)), ("B6", (1, 512)), ("B6", (2, 512))]

    def test_main_path_sizes(self):
        """Where the H100 measurements put the port's configurations."""
        u8, f32 = torch.uint8, torch.float32
        h100 = 232_448  # a block's opt-in shared memory
        assert mk.fit_route(256 * 224 * 224, f32, h100) == "stream"  # path (a)
        assert mk.fit_route(224 * 224, f32, h100) == "stream"  # path (a), batch_ref_index=0
        assert mk.fit_route(512 * 512, u8, h100) == "stream"  # the 512² reference
        assert mk.fit_route(224 * 224, u8, h100) == "stream"  # a WSI tile as reference
        assert mk.fit_route(4 * 128 * 128, u8, h100) == "stream"
        assert mk.fit_route(128 * 128, u8, h100) == "mega"  # B2 holds it
        assert mk.fit_route(64 * 64, u8, h100) == "mega"  # a small patch as reference
        assert mk.fit_route(96 * 96, f32, h100) == "mega"  # B2 holds it
        assert mk.fit_route(128 * 128, f32, h100) == "stream"  # past it
        assert mk.fit_route(64 * 64, f32, h100) == "mega"
        assert mk.transform_route(256, 224 * 224, f32) == "stream"  # path (a)'s batch
        assert mk.transform_route(4, 2048 * 2048, u8) == "stream"  # path (b)
        assert mk.transform_route(1, 4096 * 4096, u8) == "stream"  # path (b)
        assert mk.transform_route(64, 512 * 512, u8) == "stream"  # the main path
        assert mk.transform_route(96, 512 * 512, u8) == "stream"
        assert mk.transform_route(512, 224 * 224, u8) == "stream"
        assert mk.transform_route(1024, 224 * 224, u8) == "mega"  # past the row cap
        assert mk.transform_route(16, 256 * 256, u8) == "stream"
        assert mk.transform_route(64, 288 * 288, f32) == "stream"
        assert mk.transform_route(256, 224 * 224, u8) == "stream"  # WSI tiles
        assert mk.transform_route(256, 128 * 128, u8) == "mega"  # below the floor
        assert mk.transform_route(256, 64 * 64, u8) == "mega"  # small patches
        assert mk.transform_route(256, 128 * 128, f32) == "mega"  # below the float32 floor
        assert mk.transform_route(512, 224 * 224, f32) == "mega"  # past the float32 cap

    def test_cpu_path_never_builds(self, monkeypatch):
        def no_build():
            raise AssertionError("the CPU path must not build the CUDA kernels")

        monkeypatch.setattr(kernels, "build_all", no_build)
        counts = profiling.counters("launch.")
        x = _t(_tiles(1, 64, 64, seed=1))
        he, mc = ms.macenko_fit_stream(x)
        ms.macenko_transform_stream(x, he, mc)
        ss.kth_smallest_streaming(torch.zeros((1, 4)), torch.zeros((1, 1), dtype=torch.int32))
        assert profiling.counters("launch.") == counts
