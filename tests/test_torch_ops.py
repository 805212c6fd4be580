"""The PyTorch port's tensor ops against the JAX package, on the CPU.

Same seeded numpy inputs through ``stainx_tpu`` and ``stainx_tpu_torch``:
the rank formula and the monotone keys must agree bit for bit, the dtype
gates exactly, the closed-form eigh within 1e-5, and the plain selection
exactly (it returns an actual element of the row).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from stainx_tpu.kernels.selection import _monotone_key as jax_monotone_key
from stainx_tpu.ops import color as jax_color
from stainx_tpu.ops import eigh3 as jax_eigh3
from stainx_tpu.ops import percentile as jax_pct
from stainx_tpu_torch.kernels.selection import monotone_key, unkey
from stainx_tpu_torch.ops import color, eigh3
from stainx_tpu_torch.ops import percentile as pct

# Counts around the int32 edge of q·(n−1) (~21.7M at q=99) and beyond.
_COUNTS = np.array(
    [0, 1, 2, 3, 7, 100, 101, 151, 4096, 5760, 262_144, 16_777_216, 21_691_754,
     21_691_755, 21_700_000, 100_000_001, 2**31 - 1],
    dtype=np.int64,
)


class TestNearestRank:
    @pytest.mark.parametrize("q", [0, 1, 50, 99, 100])
    def test_matches_jax(self, q):
        want = np.asarray(jax_pct.nearest_rank_index(q, jnp.asarray(_COUNTS.astype(np.int32))))
        got = pct.nearest_rank_index(q, torch.as_tensor(_COUNTS)).numpy()
        np.testing.assert_array_equal(got, want)

    @pytest.mark.parametrize("q", [1, 99])
    def test_static_matches_jax_and_tensor(self, q):
        for n in _COUNTS.tolist():
            assert pct.static_nearest_rank_index(q, n) == jax_pct.static_nearest_rank_index(q, n)
            assert pct.static_nearest_rank_index(q, n) == int(
                pct.nearest_rank_index(q, torch.tensor([n]))[0]
            )

    def test_rejects_fractional_q(self):
        with pytest.raises(ValueError):
            pct.nearest_rank_index(2.5, torch.tensor([10]))


def _key_values(seed):
    rng = np.random.default_rng(seed)
    special = np.array(
        [-np.inf, -3.4e38, -1.0, -1e-38, -1e-45, -0.0, 0.0, 1e-45, 1e-38, 1.0, 3.4e38, np.inf],
        np.float32,
    )
    wide = (rng.standard_normal(500) * 10.0 ** rng.integers(-30, 30, 500)).astype(np.float32)
    return np.concatenate([special, wide, rng.standard_normal(500).astype(np.float32)])


class TestMonotoneKey:
    @pytest.mark.parametrize("seed", [0, 1])
    def test_keys_match_jax(self, seed):
        x = _key_values(seed)
        want = np.asarray(jax_monotone_key(jnp.asarray(x))).astype(np.int64)
        np.testing.assert_array_equal(monotone_key(torch.as_tensor(x)).numpy(), want)

    @pytest.mark.parametrize("seed", [0, 1])
    def test_order_and_round_trip(self, seed):
        x = torch.as_tensor(_key_values(seed))
        k = monotone_key(x)
        assert ((k >= 0) & (k < 2**32)).all()
        back = unkey(k)
        assert torch.equal(back.view(torch.int32), x.view(torch.int32))
        # Key order is float order (−0.0 sorts just below +0.0).
        order = torch.argsort(k)
        assert (x[order][1:] >= x[order][:-1]).all()


class TestColor:
    @pytest.mark.parametrize("dtype", ["uint8", "float32", "float16", "bfloat16"])
    def test_normalize_to_float(self, dtype):
        rng = np.random.default_rng(3)
        raw = rng.integers(0, 256, (2, 3, 5, 7)).astype(np.uint8)
        x_np = raw if dtype == "uint8" else (raw / 255.0).astype(np.float32)
        jx = jnp.asarray(x_np).astype(dtype)
        tx = torch.as_tensor(x_np).to(getattr(torch, dtype))
        want = np.asarray(jax_color.normalize_to_float(jx))
        got = color.normalize_to_float(tx)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)

    @pytest.mark.parametrize(
        "dtype,high,in255",
        [("uint8", False, False), ("uint8", False, True), ("float32", False, False),
         ("float32", True, False), ("float32", False, True), ("float16", False, True)],
    )
    def test_preserve_dtype(self, dtype, high, in255):
        rng = np.random.default_rng(4)
        res = rng.uniform(-20.0, 300.0, (2, 3, 4, 4)).astype(np.float32)
        if not in255:
            res = res / 255.0
        want = np.asarray(
            jax_color.preserve_dtype(jnp.asarray(res), jnp.dtype(dtype), high, in255)
        ).astype(np.float32)
        got = color.preserve_dtype(torch.as_tensor(res), getattr(torch, dtype), high, in255)
        assert got.dtype == getattr(torch, dtype)
        np.testing.assert_array_equal(got.float().numpy(), want)


def _rgb(dtype, shape=(2, 3, 9, 11), seed=21):
    raw = np.random.default_rng(seed).integers(0, 256, shape).astype(np.uint8)
    return raw if dtype == "uint8" else (raw / 255.0).astype(np.float32)


def _to_layout(x, layout):
    return np.ascontiguousarray(np.transpose(x, (0, 2, 3, 1))) if layout == "nhwc" else x


class TestLab:
    """RGB↔LAB against the JAX package: atol 1e-3 in LAB units (the two
    libraries' float32 pow differ by an ulp or two, scaled by up to 500 in
    ``a``) and 1e-5 in RGB [0, 1]."""

    @pytest.mark.parametrize("layout", ["nchw", "nhwc"])
    @pytest.mark.parametrize("dtype", ["uint8", "float32"])
    def test_rgb_to_lab_matches_jax(self, dtype, layout):
        x = _to_layout(_rgb(dtype), layout)
        axis = -1 if layout == "nhwc" else 1
        want = np.asarray(jax_color.rgb_to_lab(jnp.asarray(x), channel_axis=axis))
        got = color.rgb_to_lab(torch.as_tensor(x), channel_axis=axis)
        assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), want, atol=1e-3, rtol=0)

    @pytest.mark.parametrize("layout", ["nchw", "nhwc"])
    @pytest.mark.parametrize("dtype", ["uint8", "float32"])
    def test_lab_to_rgb_matches_jax(self, dtype, layout):
        lab = np.asarray(jax_color.rgb_to_lab(jnp.asarray(_rgb(dtype, seed=22))))
        # Push some LAB values off the sRGB gamut so the clip is exercised.
        lab = _to_layout(lab * np.float32(1.1) - np.float32(5.0), layout)
        axis = 3 if layout == "nhwc" else -3
        want = np.asarray(jax_color.lab_to_rgb(jnp.asarray(lab), channel_axis=axis))
        got = color.lab_to_rgb(torch.as_tensor(lab), channel_axis=axis).numpy()
        assert got.min() >= 0.0 and got.max() <= 1.0
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)

    @pytest.mark.parametrize("dtype", ["uint8", "float32", "float16", "bfloat16"])
    def test_images_to_uint8_is_exact(self, dtype):
        rng = np.random.default_rng(23)
        x = rng.uniform(-0.2, 1.2, (2, 3, 6, 7)).astype(np.float32)
        if dtype == "uint8":
            x = rng.integers(0, 256, x.shape).astype(np.uint8)
        want, want_scale = jax_color.images_to_uint8(jnp.asarray(x).astype(dtype))
        got, got_scale = color.images_to_uint8(torch.as_tensor(x).to(getattr(torch, dtype)))
        assert got.dtype == torch.uint8 and got_scale == want_scale == (dtype != "uint8")
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    @pytest.mark.parametrize(
        "shape,axis,match",
        [((1, 3, 4, 4), 0, "channel_axis must be one of"), ((3, 4, 4), 1, "expected a 4D batch")],
    )
    def test_nchw_raises_like_jax(self, shape, axis, match):
        x = np.zeros(shape, np.float32)
        with pytest.raises(ValueError, match=match):
            jax_color._nchw(jnp.asarray(x), axis)
        with pytest.raises(ValueError, match=match):
            color._nchw(torch.as_tensor(x), axis)


def _spd(seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((64, 3)).astype(np.float32) * rng.uniform(0.1, 3.0, 3)
    return np.cov(x.T).astype(np.float32)


class TestEigh3:
    @pytest.mark.parametrize(
        "case", ["spd0", "spd1", "spd2", "spd3", "diag", "diag_ties", "zero"]
    )
    def test_top2_matches_jax(self, case):
        if case.startswith("spd"):
            a = _spd(int(case[3:]))
        elif case == "diag":
            a = np.diag([0.3, 2.0, 0.9]).astype(np.float32)
        elif case == "diag_ties":
            a = np.diag([1.5, 1.5, 0.2]).astype(np.float32)
        else:
            a = np.zeros((3, 3), np.float32)
        want = np.asarray(jax_eigh3.eigh3_top2(jnp.asarray(a[None])))[0]
        got = eigh3.eigh3_top2(torch.as_tensor(a[None]))[0].numpy()
        np.testing.assert_allclose(got, want, atol=1e-5)

    def test_eigvals_match_jax_batched(self):
        a = np.stack([_spd(s) for s in range(8)])
        want = np.asarray(jax_eigh3.eigvalsh3(jnp.asarray(a)))
        got = eigh3.eigvalsh3(torch.as_tensor(a)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)

    @pytest.mark.parametrize("c", [3.0, 6.0, 240.0])
    def test_div_rn_rounds_the_quotient_once(self, c):
        """The plain versions' divisions by a constant (the eigh's 3 and 6,
        OD's Io) are the kernels' correctly rounded ``/``, which differs from
        a product with the float32 reciprocal in the last bit."""
        x = np.random.default_rng(int(c)).random(4096, dtype=np.float32) * 300
        got = eigh3.div_rn(torch.as_tensor(x), c).numpy()
        want = x / np.float32(c)
        assert np.array_equal(got.view(np.int32), want.view(np.int32))
        assert not np.array_equal(want, x * (np.float32(1) / np.float32(c)))


class TestKthSmallest:
    @pytest.mark.parametrize("case", ["random", "duplicates", "sentinels", "masked", "empty_rows"])
    def test_matches_jax_exactly(self, case):
        rng = np.random.default_rng(11)
        rows, p = 6, 700
        x = rng.standard_normal((rows, p)).astype(np.float32)
        mask = None
        if case == "duplicates":
            x = rng.integers(-3, 4, (rows, p)).astype(np.float32) * 0.25
        elif case == "sentinels":
            x[rng.random((rows, p)) < 0.4] = np.inf
        elif case == "masked":
            mask = rng.random((rows, p)) < 0.6
        elif case == "empty_rows":
            x[::2] = np.inf
        valid = np.isfinite(x) if mask is None else mask & np.isfinite(x)
        cnt = valid.sum(-1)
        ranks = np.stack([np.minimum(rng.integers(0, p, rows), np.maximum(cnt - 1, 0)),
                          np.zeros(rows, np.int64), np.maximum(cnt - 1, 0)], axis=1)
        for k in range(ranks.shape[1]):
            r = ranks[:, k]
            jm = None if mask is None else jnp.asarray(mask)
            want = np.asarray(jax_pct.kth_smallest(jnp.asarray(x), jnp.asarray(r), jm))
            tm = None if mask is None else torch.as_tensor(mask)
            got = pct.kth_smallest(torch.as_tensor(x), torch.as_tensor(r), tm).numpy()
            np.testing.assert_array_equal(got, want)

    def test_multi_rank_shape_and_oracle(self):
        rng = np.random.default_rng(5)
        x = rng.standard_normal((4, 301)).astype(np.float32)
        ranks = np.array([[0, 3, 300]] * 4)
        got = pct.kth_smallest(torch.as_tensor(x), torch.as_tensor(ranks)).numpy()
        np.testing.assert_array_equal(got, np.sort(x, axis=1)[:, [0, 3, 300]])
