"""The PyTorch port's exact selections (B3, B6) against the JAX package, on the CPU.

On a CPU tensor :func:`stainx_tpu_torch.kernels.selection.kth_smallest_pallas`
runs its plain version (sort each row's monotone keys, read the clamped
rank); the JAX kernel ``kth_smallest_pallas`` runs in interpret mode (about
a second a call here, so the fields stay small). Both return the element at
the nearest rank among each row's elements below +inf, so they agree bit
for bit, −0.0 against +0.0 included.
"""

import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from stainx_tpu.kernels.selection import kth_smallest_pallas as jax_kth_smallest_pallas
from stainx_tpu.kernels.selection_stream import kth_smallest_streaming_reference
from stainx_tpu_torch import kernels, profiling
from stainx_tpu_torch.kernels import macenko_stream as ms
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


def _kind_field(kind, seed):
    """(field, ranks) of one of the kinds the prefix descent and the
    candidate finish must get right."""
    rng = np.random.default_rng(seed)
    if kind == "crowded":  # angle-like: one top key byte, few second bytes
        x = rng.uniform(-1.63, -1.34, (3, 4099)).astype(np.float32)
        x[rng.random(x.shape) < 0.3] = np.inf
        r = np.array([[40, 4050], [0, 2800], [1400, 1400]], np.int32)
    elif kind == "min-equals-max":  # every element one value, sentinels around it
        x = np.full((2, 777), 0.625, np.float32)
        x[0, ::3] = np.inf
        x[1] = -3.5
        r = np.array([[0, 517], [776, 3]], np.int32)
    elif kind == "only-inf":
        x = np.full((2, 300), np.inf, np.float32)
        r = np.array([[0, 299], [5, 5]], np.int32)
    elif kind == "past-count":  # ranks past the count and past P, and negative
        x = _field(3, 1001, seed=seed, inf_share=0.6)
        r = np.array([[1000, 5000], [-7, 999], [0, 1]], np.int32)
    elif kind == "shared-prefix":  # two ranks on neighbouring elements of a tie run
        x = np.round(rng.standard_normal((2, 2048)) * 2.0).astype(np.float32) / 2.0
        r = np.array([[1023, 1024], [77, 77]], np.int32)
    else:  # "wide": extremes that differ in the top key bit, subnormals, ±0
        big, tiny = np.finfo(np.float32).max, np.float32(1e-45)
        x = np.array([[big, -big, tiny, -tiny, 0.0, -0.0, 1.0, -1.0] * 64], np.float32)
        r = np.array([[0, 1, 255, 256, 511, 300]], np.int32)
    return x, r


KINDS = ["crowded", "min-equals-max", "only-inf", "past-count", "shared-prefix", "wide"]


class TestFieldKinds:
    @pytest.mark.parametrize("kind", KINDS)
    def test_b3_plain_matches_jax_kernel(self, kind):
        x, r = _kind_field(kind, seed=len(kind))
        _assert_bits_equal(sel.kth_smallest_pallas(_t(x), _t(r)).numpy(), _jax_select(x, r))

    @pytest.mark.parametrize("with_init", [False, True], ids=["no-init", "init"])
    @pytest.mark.parametrize("kind", KINDS)
    def test_b6_plain_matches_jax_reference(self, kind, with_init):
        x, r = _kind_field(kind, seed=len(kind))
        valid = x < np.inf
        init = None
        if with_init:
            init = (np.where(valid, x, np.inf).min(1), np.where(valid, x, -np.inf).max(1),
                    valid.sum(1).astype(np.int32))
        want = np.asarray(kth_smallest_streaming_reference(
            jnp.asarray(x), jnp.asarray(r),
            None if init is None else tuple(jnp.asarray(a) for a in init)))
        got = ss.kth_smallest_streaming(
            _t(x), _t(r), None if init is None else tuple(_t(a) for a in init)).numpy()
        _assert_bits_equal(got, want)

    def test_crowded_field_is_crowded(self):
        """The crowded kind is what the staged route's angles look like: one
        top key byte and a few distinct 16-bit prefixes, which a descent
        from the top byte would spend its first pass on."""
        x, _ = _kind_field("crowded", seed=len("crowded"))
        keys = sel.monotone_key(_t(x))
        keys = keys[keys < sel.SENTINEL_KEY]
        assert len(torch.unique(keys >> 24)) == 1
        assert len(torch.unique(keys >> 16)) < 64


H100_SMEM = 232_448
H100_ACTIVE = {1: 132, 2: 66, 4: 30, 8: 15, 16: 7}  # clusters of c 1024-thread blocks at once


def h100_active(c, resident):
    return H100_ACTIVE[c]


class TestClusterShape:
    @pytest.mark.parametrize(
        "rows,p,k,want",
        [
            (1, 512 * 512, 2, 16),  # the staged 512^2 fit's angles: a lone row over 16 SMs
            (2, 512 * 512, 1, 16),  # its concentrations
            (64, 512 * 512, 2, 2),  # path (c)'s transform angles: 128 blocks, one wave
            (128, 512 * 512, 1, 2),  # its concentrations: two waves of clusters of 2
            (256, 224 * 224, 2, 1),  # path (d)'s transform
            (512, 224 * 224, 1, 1),
            (8, 224 * 224, 1, 4),  # 4 blocks of 12 544, the fastest measured
            (300, 512 * 512, 1, 1),  # past two waves of any cluster: a block a row
            (1, 5000, 2, 1),  # short rows are not split below MIN_SLICE
            (1, 3 * 8192, 1, 2),
            (1, 224 * 224, 2, 4),  # the staged fit of a 224^2 reference: 12 544 a block
        ],
    )
    def test_shape(self, rows, p, k, want):
        c, slice_, resident = sel.cluster_shape(rows, p, k, H100_SMEM, h100_active)
        assert c == want
        assert slice_ % 4 == 0 and c * slice_ >= p > (c - 1) * slice_ - 4
        assert resident % 4 == 0 and resident == min(slice_, sel.resident_budget(k, H100_SMEM))

    @pytest.mark.parametrize("k", [1, 2, 8])
    def test_shared_memory_fits_a_block(self, k):
        """State, histograms, candidates and the resident keys fit the
        opt-in shared memory; a 224^2 row stays resident at K = 1."""
        budget = sel.resident_budget(k, H100_SMEM)
        assert sel.STATE_BYTES + 4 * (sel.fixed_words(k) + budget) <= H100_SMEM
        assert sel.fixed_words(k) % 4 == 0
        if k == 1:
            assert budget >= 224 * 224

    @pytest.mark.parametrize("size", sel.CLUSTER_SIZES)
    def test_forced_size_covers_the_row(self, size):
        slice_, resident = sel.cluster_slice(1_000_003, size, sel.resident_budget(2, H100_SMEM))
        assert slice_ % 4 == 0 and size * slice_ >= 1_000_003 and resident <= slice_

    def test_an_unknown_size_is_refused(self):
        with pytest.raises(ValueError, match="no cluster of 3 blocks"):
            sel.cluster_slice(1000, 3, sel.resident_budget(1, H100_SMEM))

    def test_constants_match_the_source(self):
        src = (kernels.CSRC / "select_rows.cu").read_text()
        assert int(re.search(r"kStateBytes = (\d+);", src).group(1)) == sel.STATE_BYTES
        assert int(re.search(r"kCopies = (\d+);", src).group(1)) == sel.HIST_COPIES
        assert int(re.search(r"kCand = (\d+);", src).group(1)) == sel.CAND_KEYS
        assert int(re.search(r"kMaxK = (\d+);", src).group(1)) == sel.MAX_RANKS
        assert "cudaFuncAttributeNonPortableClusterSizeAllowed, 1" in src
        assert "__match_any_sync" not in src  # plain shared atomics into copies


class TestStreamingScratch:
    @pytest.mark.parametrize("rows,p,k", [(1, 256 * 224 * 224, 2), (2, 256 * 224 * 224, 1),
                                          (65536, 64, 1), (3, 1_000_003, 8), (1, 1, 1)])
    def test_regions_are_aligned_disjoint_and_sized(self, rows, p, k):
        layout, total = ss.scratch_layout(rows, p, k)
        assert list(layout) == ["counts", "state", "cand"]
        sizes = {"counts": rows * (ss.COUNTER_BYTES + k * 256 * 4),
                 "state": rows * ss.STATE_BYTES, "cand": rows * min(p, ss.CAND_CAP) * 4}
        end = 0
        for name, (off, nbytes) in layout.items():
            assert nbytes == sizes[name] and off % ss.ALIGN == 0 and off >= end
            end = off + nbytes
        assert end <= total < end + ss.ALIGN

    def test_constants_match_the_source(self):
        src = (kernels.CSRC / "selection.cu").read_text()
        assert re.search(r"sizeof\(SelRow\) == (\d+)", src).group(1) == str(ss.STATE_BYTES)
        assert re.search(r"sizeof\(RowCount\) == (\d+)", src).group(1) == str(ss.COUNTER_BYTES)
        assert int(re.search(r"kMaxK = (\d+);", src).group(1)) == ss.MAX_RANKS
        assert "2^20 keys a row" in src and ss.CAND_CAP == 2**20
        assert "__match_any_sync" not in src and "gridDim.y" not in src


class TestGridLimits:
    """More rows (B6) or images (B5's streamed route) than a grid's y extent,
    65 535: B6 folds its rows into the x extent (2^31 - 1 blocks); the
    streamed route runs its images in launches of at most 65 535."""

    @pytest.fixture
    def h100(self, monkeypatch):
        monkeypatch.setattr(kernels, "device_limits", lambda index: (132, H100_SMEM))

    @pytest.mark.parametrize("rows,p", [(65536, 64), (65535, 64), (1, 256 * 224 * 224),
                                        (2, 256 * 224 * 224), (200_000, 4096)])
    def test_b6_rows_fold(self, h100, rows, p):
        blocks = kernels.row_blocks(rows, p // 4, torch.device("cuda", 0))
        assert kernels.folded_grid(rows, blocks, "b6") == rows * blocks <= kernels.MAX_GRID_X
        assert blocks >= 1 and (rows < 1056 or blocks == 1)

    @pytest.mark.parametrize("n,side", [(65536, 16), (70000, 8), (64, 2048), (1, 4096)])
    def test_b5_blocks_an_image(self, h100, n, side):
        """The grid's x extent is the blocks an image (at most 8 an SM over
        all images), never the image count."""
        blocks = kernels.row_blocks(n, side * side // 4, torch.device("cuda", 0))
        assert 1 <= blocks <= 132 * 8
        if n > 65535:
            assert blocks == 1

    def test_past_the_x_extent_raises(self):
        with pytest.raises(ValueError, match="exceed a grid"):
            kernels.folded_grid(2**30, 2, "b6")
        assert kernels.folded_grid(2**30, 1, "b6") == 2**30

    def test_streamed_launches_take_at_most_65535_images(self):
        src = (kernels.CSRC / "macenko_stream.cu").read_text()
        streamed = src[src.index("= streamed route"):src.index("= cluster route")]
        assert "blockIdx.y" not in streamed.replace("y0 + blockIdx.y", "")
        assert "kMaxGridY = 65535;" in src
        launches = src[src.index("void over_items("):src.index("STAINX_DISPATCH(launcher")]
        assert launches.count("<<<g, kThreads") == 5  # every streamed kernel, in chunks
        assert "MAX_IMAGES" not in vars(ms)


class TestWrapper:
    def test_cpu_wrapper_is_plain_and_never_builds(self, monkeypatch):
        def no_build():
            raise AssertionError("the CPU path must not build the CUDA kernels")

        monkeypatch.setattr(kernels, "build_all", no_build)
        before = profiling.counters("launch.")
        x, r = _t(_field(3, 300, seed=1)), _t(_ranks(3, 10, 300, seed=2))
        got = sel.kth_smallest_pallas(x, r)
        plain = sel.kth_smallest_pallas_plain(x, r)
        assert torch.equal(got.view(torch.int32), plain.view(torch.int32))
        assert profiling.counters("launch.") == before

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
