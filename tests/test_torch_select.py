"""The PyTorch port's exact row select (B3) against the JAX kernel, on the CPU.

On a CPU tensor :func:`stainx_tpu_torch.kernels.selection.kth_smallest_pallas`
runs its plain version (sort each row's monotone keys, read the clamped
rank); the JAX kernel ``kth_smallest_pallas`` runs in interpret mode (about
a second a call here, so the fields stay small). Both return the element at
the nearest rank among each row's elements below +inf, so they agree bit
for bit, −0.0 against +0.0 included.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from stainx_tpu.kernels.selection import kth_smallest_pallas as jax_kth_smallest_pallas
from stainx_tpu_torch import kernels
from stainx_tpu_torch.kernels import selection as sel
from stainx_tpu_torch.kernels import selection_stream as ss


def _t(a):
    return torch.as_tensor(np.array(a))


def _jax_select(x, ranks):
    return np.asarray(jax_kth_smallest_pallas(jnp.asarray(x), jnp.asarray(ranks), interpret=True))


def _assert_bits_equal(got, want):
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.int32), np.asarray(want, np.float32).view(np.int32))


def _field(rows, p, seed, inf_share=0.3):
    """Rows with negative values, ±0, heavy duplicates and +inf sentinels;
    the last row is all sentinels."""
    rng = np.random.default_rng(seed)
    x = np.round(rng.standard_normal((rows, p)) * 8.0) / 8.0
    x[:, ::5] = rng.standard_normal((rows, len(range(0, p, 5))))
    x[0, :4] = [0.0, -0.0, -0.0, 0.0]
    x[rng.random((rows, p)) < inf_share] = np.inf
    x[-1] = np.inf
    return x.astype(np.float32)


def _ranks(rows, k, p, seed):
    """Ranks across the row, some past the count of elements below +inf and
    some past P, and a negative one."""
    rng = np.random.default_rng(seed)
    r = rng.integers(0, p, (rows, k)).astype(np.int32)
    r[0, -1] = p + 11
    if k > 1:
        r[1 % rows, 0] = p - 1
        r[0, 0] = -3
    return r


class TestPlainMatchesJaxKernel:
    @pytest.mark.parametrize(
        "rows,p,k,inf_share",
        [
            (8, 5000, 1, 0.3),
            (8, 5000, 2, 0.3),
            (4, 1021, 2, 0.0),
            (6, 3000, 10, 0.5),
            (3, 777, 3, 0.95),
        ],
        ids=["k1", "k2", "k2-ragged-no-sentinel", "k10", "k3-sparse"],
    )
    def test_bit_for_bit(self, rows, p, k, inf_share):
        x = _field(rows, p, seed=rows * p + k, inf_share=inf_share)
        r = _ranks(rows, k, p, seed=k)
        got = sel.kth_smallest_pallas(_t(x), _t(r)).numpy()
        _assert_bits_equal(got, _jax_select(x, r))
        assert np.isinf(got[-1]).all()  # the all-sentinel row

    def test_conventions(self):
        """−0.0 sorts below +0.0; a rank past the count takes the largest
        element below +inf; a row of +inf gives +inf."""
        x = np.array([[3.0, 1.0, np.inf, -0.0, 0.0, 2.0], [np.inf] * 6], np.float32)
        r = np.array([[0, 5, 1, 2], [0, 1, 2, 3]], np.int32)
        got = sel.kth_smallest_pallas(_t(x), _t(r)).numpy()
        _assert_bits_equal(got, _jax_select(x, r))
        assert np.signbit(got[0, 0]) and got[0, 0] == 0.0
        assert got[0, 1] == 3.0 and got[0, 2] == 0.0 and not np.signbit(got[0, 2])
        assert got[0, 3] == 1.0
        assert np.isinf(got[1]).all()

    def test_ties_and_extremes(self):
        """A row of one repeated value, and rows holding the largest and
        smallest finite float32 beside ±0 and subnormals."""
        big = np.finfo(np.float32).max
        tiny = np.float32(1e-45)
        x = np.array(
            [
                [0.5] * 64,
                [big, -big, tiny, -tiny, 0.0, -0.0, 1.0, -1.0] * 8,
                [np.inf, -big] + [np.inf] * 62,
            ],
            np.float32,
        )
        r = np.array([[0, 63], [0, 63], [0, 5]], np.int32)
        _assert_bits_equal(sel.kth_smallest_pallas(_t(x), _t(r)).numpy(), _jax_select(x, r))


class TestWrapper:
    def test_cpu_wrapper_is_plain_and_never_builds(self, monkeypatch):
        def no_build():
            raise AssertionError("the CPU path must not build the CUDA kernels")

        monkeypatch.setattr(kernels, "build_all", no_build)
        before = sel.kth_smallest_pallas.launches
        x, r = _t(_field(3, 300, seed=1)), _t(_ranks(3, 10, 300, seed=2))
        got = sel.kth_smallest_pallas(x, r)
        plain = sel.kth_smallest_pallas_plain(x, r)
        assert torch.equal(got.view(torch.int32), plain.view(torch.int32))
        assert sel.kth_smallest_pallas.launches == before

    def test_b6_plain_shares_the_b3_plain_version(self):
        """Without an init, B6's plain version is B3's; with one, a count of
        0 gives +inf."""
        x, r = _t(_field(4, 200, seed=3)), _t(_ranks(4, 2, 200, seed=4))
        plain = sel.kth_smallest_pallas_plain(x, r)
        assert torch.equal(ss.kth_smallest_streaming_plain(x, r), plain)
        valid = x < torch.inf
        init = (x.amin(1), torch.where(valid, x, -torch.inf).amax(1), valid.sum(1))
        init[2][0] = 0
        got = ss.kth_smallest_streaming_plain(x, r, init)
        assert torch.isinf(got[0]).all()
        assert torch.equal(got[1:], plain[1:])

    def test_empty_field(self):
        got = sel.kth_smallest_pallas(torch.zeros((2, 0)), torch.zeros((2, 3), dtype=torch.int32))
        assert got.shape == (2, 3) and torch.isinf(got).all()

    def test_shape_is_checked(self):
        with pytest.raises(ValueError, match=r"\(R, P\)"):
            sel.kth_smallest_pallas(torch.zeros(8), torch.zeros((1, 1), dtype=torch.int32))
        with pytest.raises(ValueError, match=r"\(R, P\)"):
            sel.kth_smallest_pallas(torch.zeros((2, 8)), torch.zeros((3, 1), dtype=torch.int32))

    def test_other_devices_raise(self):
        """A tensor on neither the CPU nor a card is refused, not copied."""
        x = torch.zeros((2, 8), device="meta")
        with pytest.raises(ValueError, match="expected a CUDA or CPU tensor"):
            sel.kth_smallest_pallas(x, torch.zeros((2, 1), dtype=torch.int32))
