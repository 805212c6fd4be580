"""The PyTorch port's Reinhard path against the JAX package, on the CPU.

On a CPU tensor the kernel wrappers of ``stainx_tpu_torch`` run their plain
PyTorch versions; the JAX kernels run in interpret mode. Tolerances are the
JAX repo's own (``tests/test_kernels.py``, ``tests/test_reinhard.py``):
moments rtol 1e-4, atol 1e-2 (the port sums in float64, JAX in float32);
outputs within 1 grey level for uint8 and 1/255 for float32 (a few ulps of
``pow`` can move a truncated level by one); the fit within mean rtol 1e-4,
atol 1e-3 and std rtol 1e-3, atol 1e-3.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import stainx_tpu
from stainx_tpu.kernels.reinhard_fused import reinhard_apply_pallas, reinhard_moments_pallas
from stainx_tpu.ops import reinhard as jax_rh
from stainx_tpu_torch import Reinhard, kernels, profiling
from stainx_tpu_torch.convert import state_from_jax
from stainx_tpu_torch.kernels import reinhard_fused as rf
from stainx_tpu_torch.ops import reinhard as rh
from stainx_tpu_torch.testing import branch_point_field, colour_cube

from tests.oracles import numpy_reference as oracle

GREY = {"uint8": 1.0, "float32": 1.0 / 255.0}
SIZES = {"24x24": (24, 24), "33x31": (33, 31)}


def _images(dtype, n, h, w, seed):
    rng = np.random.default_rng(seed)
    if dtype == "uint8":
        return rng.integers(0, 256, (n, 3, h, w), np.uint8)
    return rng.random((n, 3, h, w), dtype=np.float32)


def _he_batch(n, h, w, seed):
    return np.concatenate([oracle.synthetic_he_tile(h, w, seed=seed + i, he_scale=1.1) for i in range(n)])


def _t(a):
    return torch.as_tensor(np.array(a))


def _assert_close(got, want, atol):
    got = got.float().numpy() if torch.is_tensor(got) else np.asarray(got, np.float32)
    np.testing.assert_allclose(got, np.asarray(want).astype(np.float32), atol=atol, rtol=0)


@pytest.fixture(scope="module")
def ref_tile():
    return oracle.synthetic_he_tile(64, 64, seed=42)


@pytest.fixture(scope="module")
def ref_stats(ref_tile):
    """JAX fit of the 64² reference: (mean, std) as numpy."""
    mean, std = jax_rh.reinhard_fit(jnp.asarray(ref_tile))
    return np.asarray(mean), np.asarray(std)


@pytest.fixture(scope="module")
def batch():
    return _he_batch(3, 64, 64, seed=123)


@pytest.fixture(scope="module")
def jax_moments():
    """JAX interpret-mode moments and its jnp twin, per (dtype, size)."""
    out = {}
    for dtype in ("uint8", "float32"):
        for name, (h, w) in SIZES.items():
            x = _images(dtype, 3, h, w, seed=2)
            kernel = reinhard_moments_pallas(jnp.asarray(x), interpret=True)
            twin = jax_rh.lab_moments(jnp.asarray(x))
            out[dtype, name] = (x, [np.asarray(a) for a in kernel], [np.asarray(a) for a in twin])
    return out


class TestMoments:
    @pytest.mark.parametrize("size", list(SIZES))
    @pytest.mark.parametrize("dtype", ["uint8", "float32"])
    def test_plain_matches_jax_kernel_and_twin(self, dtype, size, jax_moments):
        x, (s1_k, s2_k), (n_r, s1_r, s2_r) = jax_moments[dtype, size]
        s1, s2 = rf.reinhard_moments_plain(_t(x))
        assert s1.dtype == s2.dtype == torch.float32 and s1.shape == s2.shape == (3,)
        for want in ((s1_k, s2_k), (s1_r, s2_r)):
            np.testing.assert_allclose(s1.numpy(), want[0], rtol=1e-4, atol=1e-2)
            np.testing.assert_allclose(s2.numpy(), want[1], rtol=1e-4, atol=1e-2)
        n, t1, t2 = rh.lab_moments(_t(x))
        assert n == float(n_r) == x.shape[0] * x.shape[2] * x.shape[3]
        np.testing.assert_allclose(t1.numpy(), s1_r, rtol=1e-4, atol=1e-2)
        np.testing.assert_allclose(t2.numpy(), s2_r, rtol=1e-4, atol=1e-2)

    def test_wrapper_on_cpu_is_plain(self, batch):
        a, b = rf.reinhard_moments(_t(batch)), rf.reinhard_moments_plain(_t(batch))
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])

    @pytest.mark.parametrize("n", [1.0, 2.0, 3 * 24 * 24.0])
    def test_moments_to_mean_std_matches_jax(self, n):
        rng = np.random.default_rng(int(n))
        s = rng.normal(0, 50 * n, 3).astype(np.float32)
        sq = (s * s / np.float32(n) + rng.uniform(0, 400 * n, 3)).astype(np.float32)
        sq[0] = 0.0  # a negative variance clamps to 0
        want = [np.asarray(a) for a in jax_rh.moments_to_mean_std(jnp.float32(n), s, sq)]
        got = [a.numpy() for a in rh.moments_to_mean_std(n, _t(s), _t(sq))]
        np.testing.assert_allclose(got[0], want[0], rtol=1e-6)
        np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=1e-6)


class TestMeanStd:
    """The LAB mean and std B7b's finalize writes from the float32 sums, on
    the CPU its plain version ``moments_to_mean_std``: against the JAX fit
    (mean rtol 1e-4, atol 1e-3; std rtol 1e-3, atol 1e-3) and the
    wrapper's CPU path (equal). One pixel is the Bessel edge: the JAX
    fit's ``ddof=1`` gives NaN there, its additive form ``max(n − 1, 1)``
    0."""

    @pytest.mark.parametrize("shape", [(1, 1, 1), (1, 1, 2), (2, 5, 7), (3, 24, 24), (2, 33, 31)])
    @pytest.mark.parametrize("dtype", ["uint8", "float32"])
    def test_plain_matches_moments_to_mean_std_and_jax(self, dtype, shape):
        n_img, h, w = shape
        x = _images(dtype, n_img, h, w, seed=h * w)
        n = n_img * h * w
        s1, s2 = rf.reinhard_moments_plain(_t(x))
        mean, std = rh.moments_to_mean_std(n, s1, s2)
        assert mean.dtype == std.dtype == torch.float32 and mean.shape == std.shape == (3,)
        if n == 1:
            want = jax_rh.moments_to_mean_std(*jax_rh.lab_moments(jnp.asarray(x)))
            assert np.all(std.numpy() == 0.0)
        else:
            want = jax_rh.reinhard_fit(jnp.asarray(x))
        np.testing.assert_allclose(mean.numpy(), np.asarray(want[0]), rtol=1e-4, atol=1e-3)
        np.testing.assert_allclose(std.numpy(), np.asarray(want[1]), rtol=1e-3, atol=1e-3)
        got = rf.reinhard_mean_std(_t(x))
        assert torch.equal(got[0], mean) and torch.equal(got[1], std)

    @pytest.mark.parametrize("n", [1, 3, 2**24 + 1, 64 * 512 * 512])
    def test_divisions_are_float32_true_divisions(self, n):
        """Each step rounds once in float32, as the finalize computes it:
        ``n`` and ``max(n − 1, 1)`` are float32 values, the divisions true
        divisions (not products with a reciprocal)."""
        rng = np.random.default_rng(n)
        s = rng.normal(0, 40 * n, 3).astype(np.float32)
        sq = (s.astype(np.float64) ** 2 / n + rng.uniform(0, 900 * n, 3)).astype(np.float32)
        mean, std = rh.moments_to_mean_std(n, _t(s), _t(sq))
        nf, den = np.float32(n), np.float32(max(n - 1, 1))
        mean_c = s / nf
        var = np.maximum(sq - nf * mean_c * mean_c, np.float32(0)) / den
        assert np.array_equal(mean.numpy(), mean_c + np.float32(128.0))
        assert np.array_equal(std.numpy(), np.sqrt(var))


class TestLaunchShape:
    """The kernels' launch shape, a pure function of the batch and the card."""

    @pytest.mark.parametrize("dtype, pixels, aligned, want", [
        (torch.uint8, 512 * 512, True, 16), (torch.uint8, 71 * 73, True, 1),
        (torch.uint8, 8, True, 1), (torch.uint8, 512 * 512, False, 1),
        (torch.float32, 8, True, 4), (torch.float32, 71 * 73, True, 1),
        (torch.float32, 512 * 512, False, 1),
    ])
    def test_group_pixels(self, dtype, pixels, aligned, want):
        assert rf.group_pixels(dtype, pixels, aligned) == want


class TestApply:
    @pytest.mark.parametrize("size", list(SIZES))
    @pytest.mark.parametrize("dtype", ["uint8", "float32"])
    def test_plain_matches_jax_kernel(self, dtype, size, jax_moments, ref_stats):
        x, _, (n_r, s1_r, s2_r) = jax_moments[dtype, size]
        mean, std = (np.asarray(a) for a in jax_rh.moments_to_mean_std(n_r, s1_r, s2_r))
        want = reinhard_apply_pallas(jnp.asarray(x), mean, std, *ref_stats, interpret=True)
        got = rf.reinhard_apply_plain(_t(x), _t(mean), _t(std), *map(_t, ref_stats))
        assert got.dtype == getattr(torch, dtype) and tuple(got.shape) == x.shape
        _assert_close(got, want, GREY[dtype])

    @pytest.mark.parametrize("stats", ["own", "reference"])
    @pytest.mark.parametrize("field", ["colour cube", "branch points"])
    def test_plain_matches_jax_kernel_on_edge_fields(self, field, stats, ref_stats):
        """Every 4th level of the colour cube (64³ triples, 1×3×512² uint8)
        and float32 values 16 ulps either side of the formulas' branch
        points, under the field's own statistics (the identity transfer)
        and the reference's: within 1 grey level or 1/255."""
        if field == "colour cube":
            x, dtype = colour_cube(4), "uint8"
        else:
            x, dtype = branch_point_field(16, 8, seed=3), "float32"
        mean, std = (np.asarray(a) for a in jax_rh.moments_to_mean_std(*jax_rh.lab_moments(jnp.asarray(x))))
        target = (mean, std) if stats == "own" else ref_stats
        want = reinhard_apply_pallas(jnp.asarray(x), mean, std, *target, interpret=True)
        got = rf.reinhard_apply_plain(_t(x), _t(mean), _t(std), *map(_t, target))
        assert got.dtype == getattr(torch, dtype) and tuple(got.shape) == x.shape
        _assert_close(got, want, GREY[dtype])

    def test_wrapper_on_cpu_is_plain(self, batch, ref_stats):
        stats = [_t(a) for a in (*ref_stats, *ref_stats)]
        assert torch.equal(rf.reinhard_apply(_t(batch), *stats), rf.reinhard_apply_plain(_t(batch), *stats))


class TestTransform:
    @pytest.mark.parametrize("use_pallas", [True, False])
    @pytest.mark.parametrize("dtype", ["uint8", "float32"])
    def test_matches_jax(self, dtype, use_pallas, batch, ref_stats):
        x = batch if dtype == "uint8" else (batch / 255.0).astype(np.float32)
        want = jax_rh.reinhard_transform(jnp.asarray(x), *ref_stats, use_pallas=use_pallas)
        got = rh.reinhard_transform(_t(x), *map(_t, ref_stats))
        assert got.dtype == getattr(torch, dtype)
        _assert_close(got, want, GREY[dtype])

    @pytest.mark.parametrize("size", list(SIZES))
    @pytest.mark.parametrize("dtype", ["uint8", "float32"])
    def test_fit_matches_jax(self, dtype, size):
        x = _images(dtype, 2, *SIZES[size], seed=9)
        mean_j, std_j = jax_rh.reinhard_fit(jnp.asarray(x))
        mean, std = rh.reinhard_fit(_t(x))
        assert mean.shape == std.shape == (3,)
        np.testing.assert_allclose(mean.numpy(), np.asarray(mean_j), rtol=1e-4, atol=1e-3)
        np.testing.assert_allclose(std.numpy(), np.asarray(std_j), rtol=1e-3, atol=1e-3)


@pytest.fixture(scope="module")
def jax_normalizer(ref_tile):
    return stainx_tpu.Reinhard(device="cpu").fit(ref_tile)


class TestPublicAPI:
    @pytest.mark.parametrize("dtype", ["uint8", "float32"])
    def test_matches_jax_and_oracle(self, dtype, ref_tile, jax_normalizer, batch):
        x = batch if dtype == "uint8" else (batch / 255.0).astype(np.float32)
        got = Reinhard(device="cpu").fit(ref_tile).transform(x)
        assert got.device.type == "cpu" and got.dtype == getattr(torch, dtype)
        _assert_close(got, jax_normalizer.transform(x), GREY[dtype])
        mean_o, std_o = oracle.reinhard_fit(ref_tile)
        _assert_close(got, oracle.reinhard_transform(x, mean_o, std_o), GREY[dtype])

    def test_fitted_state_matches_jax(self, ref_tile, jax_normalizer):
        port = Reinhard(device="cpu").fit(ref_tile)
        for name in ("_reference_mean", "_reference_std"):
            assert tuple(getattr(port, name).shape) == (3,)
        np.testing.assert_allclose(port._reference_mean.numpy(), np.asarray(jax_normalizer._reference_mean),
                                   rtol=1e-4, atol=1e-3)
        np.testing.assert_allclose(port._reference_std.numpy(), np.asarray(jax_normalizer._reference_std),
                                   rtol=1e-3, atol=1e-3)

    @pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
    def test_low_precision_floats_match_jax(self, dtype, ref_tile, jax_normalizer, batch):
        x32 = (batch / 255.0).astype(np.float32)
        want = np.asarray(jax_normalizer.transform(jnp.asarray(x32).astype(dtype)), np.float32)
        got = Reinhard(device="cpu").fit(ref_tile).transform(torch.as_tensor(x32).to(getattr(torch, dtype)))
        assert got.dtype == getattr(torch, dtype)
        # One grey level, plus one quantum of the output dtype below 1.0: a
        # sub-level float32 difference can straddle a rounding boundary.
        quantum = {"bfloat16": 2.0**-8, "float16": 2.0**-11}[dtype]
        _assert_close(got, want, 1.0 / 255.0 + quantum)

    @pytest.mark.parametrize("source", ["npz", "state_dict"])
    def test_jax_state_carries_over(self, source, tmp_path, jax_normalizer, batch):
        if source == "npz":
            path = tmp_path / "ref.npz"
            jax_normalizer.save_state(str(path))
            ported = Reinhard(device="cpu").load_state(state_from_jax(path, device="cpu"))
            direct = Reinhard(device="cpu").load_state_file(str(path))
            assert torch.equal(direct.transform(batch), ported.transform(batch))
        else:
            state = {k: np.asarray(v) for k, v in jax_normalizer.state.items()}
            ported = Reinhard(device="cpu").load_state(state_from_jax(state, device="cpu"))
        assert ported._is_fitted
        _assert_close(ported.transform(batch), jax_normalizer.transform(batch), GREY["uint8"])

    def test_save_state_round_trip(self, tmp_path, ref_tile, batch):
        r = Reinhard(device="cpu").fit(ref_tile)
        path = tmp_path / "port.npz"
        r.save_state(str(path))
        with np.load(path) as data:
            assert sorted(data.files) == ["_reference_mean", "_reference_std"]
        back = Reinhard(device="cpu").load_state_file(str(path))
        assert torch.equal(back.transform(batch), r.transform(batch))


class TestErrors:
    def test_transform_before_fit(self):
        for r in (Reinhard(device="cpu"), stainx_tpu.Reinhard(device="cpu")):
            with pytest.raises(ValueError, match="Must call fit"):
                r.transform(np.zeros((1, 3, 8, 8), np.uint8))

    @pytest.mark.parametrize("shape", [(3, 16, 16), (1, 4, 16, 16), (1, 16, 16, 3)])
    @pytest.mark.parametrize("stage", ["fit", "transform"])
    def test_layout_errors_match_jax(self, shape, stage, ref_tile):
        bad = np.zeros(shape, np.uint8)
        for r in (Reinhard(device="cpu"), stainx_tpu.Reinhard(device="cpu")):
            if stage == "transform":
                r.fit(ref_tile)
            with pytest.raises(ValueError, match=r"Reinhard expects NCHW images with C=3, got shape"):
                getattr(r, stage)(bad)

    def test_kernel_dtype_and_stats_are_checked(self):
        with pytest.raises(TypeError, match="uint8 or float32"):
            rf.reinhard_moments(torch.zeros((1, 3, 8, 8), dtype=torch.int16))
        with pytest.raises(ValueError, match="3 entries"):
            rf.reinhard_apply(torch.zeros((1, 3, 8, 8), dtype=torch.uint8),
                              torch.zeros(2), torch.ones(3), torch.zeros(3), torch.ones(3))

    def test_cpu_path_never_builds(self, monkeypatch, ref_tile):
        def no_build():
            raise AssertionError("the CPU path must not build the CUDA kernels")

        monkeypatch.setattr(kernels, "build_all", no_build)
        before = profiling.counters("launch.")
        Reinhard(device="cpu").fit(ref_tile).transform(ref_tile)
        rf.reinhard_mean_std(_t(ref_tile))
        assert profiling.counters("launch.") == before
