"""The PyTorch port's histogram-matching path against the JAX package, on
the CPU.

On a CPU tensor the kernel wrappers of ``stainx_tpu_torch`` run their plain
PyTorch versions; the JAX kernels run in interpret mode. The histogram and
the LUT apply are exact (integer counts; a table lookup). The LUT agrees
within 1e-4 with identical pins: the port adds its row sums and cumulative
sums in the order of XLA's CPU reductions, and the rest of the LUT is
elementwise. Outputs agree within 1 grey level.

Pixel counts are chosen coprime between source (2·37·41 a channel) and
reference (29·31): a source CDF value k/3034 then never equals a reference
quantile m/899 exactly, so no test sits on a plateau tie, where any float32
scan may resolve the tie either way.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import stainx_tpu
from stainx_tpu.kernels.histogram import (
    apply_lut_u8_mxu,
    histogram_256_mxu,
    histogram_256_pallas,
)
from stainx_tpu.ops import histogram_matching as jax_hm
from stainx_tpu_torch import HistogramMatching, kernels
from stainx_tpu_torch.convert import state_from_jax
from stainx_tpu_torch.kernels import histogram as hk
from stainx_tpu_torch.ops import histogram_matching as hm

from tests.oracles import numpy_reference as oracle

GREY = {"uint8": 1.0, "float32": 1.0 / 255.0}
SRC, REF = (2, 37, 41), (1, 29, 31)  # (N, H, W): 3034 and 899 pixels a channel


def _images(dtype, n, h, w, seed, c=3, layout="nchw"):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 256, (n, c, h, w), np.uint8)
    if dtype == "float32":
        x = (x / 255.0 + rng.uniform(0, 0.9 / 255, x.shape)).astype(np.float32)
    return np.ascontiguousarray(np.transpose(x, (0, 2, 3, 1))) if layout == "nhwc" else x


def _t(a):
    return torch.as_tensor(np.array(a))


def _assert_close(got, want, atol):
    got = got.float().numpy() if torch.is_tensor(got) else np.asarray(got, np.float32)
    np.testing.assert_allclose(got, np.asarray(want).astype(np.float32), atol=atol, rtol=0)


class TestHistogramKernel:
    @pytest.mark.parametrize("shape", [(3, 4096), (3, 5000), (2, 3, 70000), (1, 1, 100)])
    def test_plain_matches_jax_mxu_kernel(self, shape):
        vals = np.random.default_rng(sum(shape)).integers(0, 256, shape, np.uint8)
        want = np.asarray(histogram_256_mxu(jnp.asarray(vals), interpret=True))
        got = hk.histogram_256_plain(_t(vals))
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)

    def test_plain_matches_jax_vpu_kernel(self):
        vals = np.random.default_rng(5000).integers(0, 256, (3, 5000), np.uint8)
        want = np.asarray(histogram_256_pallas(jnp.asarray(vals), interpret=True))
        np.testing.assert_array_equal(hk.histogram_256_plain(_t(vals)).numpy(), want)

    def test_all_zero_values(self):
        vals = np.zeros((2, 1, 5000), np.uint8)
        want = np.asarray(histogram_256_mxu(jnp.asarray(vals), interpret=True))
        got = hk.histogram_256(_t(vals)).numpy()
        np.testing.assert_array_equal(got, want)
        assert got[0, 0] == 10000.0 and got[0, 1:].sum() == 0.0

    def test_op_matches_jax_xla_histogram(self):
        vals = np.random.default_rng(3).integers(0, 256, (4, 999), np.uint8)
        want = np.asarray(jax_hm.histogram_256(jnp.asarray(vals)))
        np.testing.assert_array_equal(hm.histogram_256(_t(vals)).numpy(), want)

    def test_rejects_other_dtypes_and_ranks(self):
        with pytest.raises(TypeError, match="uint8"):
            hk.histogram_256(torch.zeros((3, 10), dtype=torch.int32))
        with pytest.raises(ValueError, match=r"\(N, C, P\) or \(C, P\)"):
            hk.histogram_256(torch.zeros((1, 3, 4, 4), dtype=torch.uint8))


class TestApplyLutKernel:
    @pytest.mark.parametrize("case", ["sorted", "extreme"])
    def test_plain_matches_jax_kernel(self, case):
        rng = np.random.default_rng(7)
        if case == "sorted":
            vals = rng.integers(0, 256, (2, 3, 5000), np.uint8)
            lut = np.sort(rng.random((3, 256)).astype(np.float32) * 255.0, axis=1)
        else:
            vals = np.arange(256, dtype=np.uint8).reshape(1, 1, 256)
            lut = np.linspace(-5.0, 260.0, 256, dtype=np.float32).reshape(1, 256)
        want = np.asarray(apply_lut_u8_mxu(jnp.asarray(vals), jnp.asarray(lut), interpret=True))
        got = hk.apply_lut_plain(_t(vals), _t(lut))
        assert got.dtype == torch.uint8
        np.testing.assert_array_equal(got.numpy(), want)

    @pytest.mark.parametrize("case", ["sorted", "extreme"])
    def test_float_form_matches_jax_xla(self, case):
        """The float32 output is the JAX XLA route's ``clip(lut[v] / 255, 0, 1)``,
        compiled as ``hm_transform`` compiles it: XLA folds the division by
        the constant 255 into a product with its float32 reciprocal."""
        rng = np.random.default_rng(8)
        vals = rng.integers(0, 256, (2, 3, 40, 50), np.uint8)
        lut = np.sort(rng.random((3, 256)).astype(np.float32) * 255.0, axis=1)
        if case == "extreme":
            lut = np.linspace(-5.0, 260.0, 256, dtype=np.float32)[None].repeat(3, 0)
        matched = jax_hm._apply_lut(jnp.asarray(vals), jnp.asarray(lut))
        to_float = jax.jit(lambda m: jnp.clip(m / 255.0, 0.0, 1.0))
        want = np.asarray(to_float(matched)).reshape(2, 3, -1)
        got = hk.apply_lut(_t(vals.reshape(2, 3, -1)), _t(lut), torch.float32)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)

    def test_rejects_bad_lut(self):
        with pytest.raises(ValueError, match=r"\(3, 256\) LUT"):
            hk.apply_lut(torch.zeros((1, 3, 10), dtype=torch.uint8), torch.zeros(2, 256))
        with pytest.raises(TypeError, match="uint8 or float32"):
            hk.apply_lut(torch.zeros((1, 3, 10), dtype=torch.uint8), torch.zeros(3, 256), torch.int32)


def _counts(images):
    n, c = images.shape[:2]
    flat = np.transpose(images, (1, 0, 2, 3)).reshape(c, -1)
    return np.stack([np.bincount(row, minlength=256) for row in flat]).astype(np.float32)


def _lut_case(case):
    """(source counts, reference histogram, pixel count) of a LUT case."""
    src = _images("uint8", *SRC, seed=31)
    ref = _images("uint8", *REF, seed=32)
    counts, num = _counts(src), float(SRC[0] * SRC[1] * SRC[2])
    ref_hist = _counts(ref) / np.float32(REF[1] * REF[2])
    if case == "self_matching":
        ref_hist = np.asarray(jax_hm.hm_fit(jnp.asarray(src)))
    elif case == "plateaued_reference":
        ref_hist[:, 1::2] = 0.0  # every odd bin empty
        ref_hist[:, 100:140] = 0.0
    elif case == "empty_source_channel":
        counts[1] = 0.0
    elif case == "empty_reference_channel":
        ref_hist[2] = 0.0
    return counts, ref_hist, num


class TestBuildLut:
    @pytest.mark.parametrize(
        "case",
        ["random", "self_matching", "plateaued_reference", "empty_source_channel",
         "empty_reference_channel"],
    )
    def test_matches_jax(self, case):
        counts, ref_hist, num = _lut_case(case)
        want = np.asarray(jax_hm.hm_build_lut(jnp.asarray(counts), jnp.asarray(ref_hist), num))
        got = hm.hm_build_lut(_t(counts), _t(ref_hist), num).numpy()
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
        for pin in (0.0, 255.0):
            np.testing.assert_array_equal(got == pin, want == pin)
        if case == "empty_source_channel":
            assert (got[1] == 0.0).all()
        if case == "empty_reference_channel":
            assert (got[2] == 255.0).all()


class TestTransform:
    @pytest.mark.parametrize("channel_axis", [1, -3, -1, 3])
    @pytest.mark.parametrize("dtype", ["uint8", "float32"])
    def test_fit_and_transform_match_jax(self, dtype, channel_axis):
        layout = "nhwc" if channel_axis in (-1, 3) else "nchw"
        ref = _images(dtype, *REF, seed=41, layout=layout)
        src = _images(dtype, *SRC, seed=42, layout=layout)
        hist_j = jax_hm.hm_fit(jnp.asarray(ref), channel_axis=channel_axis)
        hist = hm.hm_fit(_t(ref), channel_axis=channel_axis)
        np.testing.assert_allclose(hist.numpy(), np.asarray(hist_j), rtol=1e-6, atol=0)
        got = hm.hm_transform(_t(src), hist, channel_axis=channel_axis)
        assert got.dtype == getattr(torch, dtype) and tuple(got.shape) == src.shape
        for use_pallas in (True, False):
            want = jax_hm.hm_transform(
                jnp.asarray(src), hist_j, channel_axis=channel_axis, use_pallas=use_pallas
            )
            _assert_close(got, want, GREY[dtype])

    @pytest.mark.parametrize("c", [1, 4])
    def test_any_channel_count(self, c):
        ref = _images("uint8", *REF, seed=43, c=c)
        src = _images("uint8", *SRC, seed=44, c=c)
        hist_j = jax_hm.hm_fit(jnp.asarray(ref))
        got = hm.hm_transform(_t(src), hm.hm_fit(_t(ref)))
        assert tuple(got.shape) == src.shape
        for use_pallas in (True, False):
            _assert_close(got, jax_hm.hm_transform(jnp.asarray(src), hist_j, use_pallas=use_pallas),
                          GREY["uint8"])


def _jax_lut(counts, hist, num_pixels: float):
    """``hm_build_lut`` as ``hm_transform`` compiles it, the pixel count a
    constant of the program (XLA folds the division by it into a product
    with its float32 reciprocal; called eagerly, the function divides)."""
    build = jax.jit(jax_hm.hm_build_lut, static_argnums=2)
    return build(jnp.asarray(counts), jnp.asarray(hist), num_pixels)


def _quantized(images):
    """The uint8 values the port's HM path counts, (N, C, H·W)."""
    x = torch.as_tensor(np.array(images))
    if x.dtype != torch.uint8:
        x = torch.clamp(x * 255.0, 0.0, 255.0).to(torch.uint8)
    return x.reshape(x.shape[0], x.shape[1], -1)


class TestFusedEntryPoints:
    """The fit's and the transform's one C call each (B8a with its finalize,
    then B8b at transform) through their plain versions on the CPU, against
    the JAX package's hm_fit, hm_transform and hm_build_lut on the same
    inputs. Rows of 899 and 3034 pixels a channel: odd P."""

    @pytest.mark.parametrize("c", [1, 3, 12])
    @pytest.mark.parametrize("dtype", ["uint8", "float32"])
    def test_reference_matches_jax_fit(self, c, dtype):
        ref = _images(dtype, *REF, seed=61, c=c)
        want = np.asarray(jax_hm.hm_fit(jnp.asarray(ref)))
        got = hk.hm_reference(_quantized(ref))
        assert got.dtype == torch.float32 and tuple(got.shape) == (c, 256)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
        assert torch.equal(hm.hm_fit(_t(ref)), got)

    @pytest.mark.parametrize("case", ["random", "self_match", "empty_reference_channel"])
    @pytest.mark.parametrize("c", [1, 3, 12])
    @pytest.mark.parametrize("dtype", ["uint8", "float32"])
    def test_transfer_matches_jax(self, case, c, dtype):
        src = _images(dtype, *SRC, seed=62, c=c)
        ref = src if case == "self_match" else _images(dtype, *REF, seed=63, c=c)
        hist = np.array(jax_hm.hm_fit(jnp.asarray(ref)))
        if case == "empty_reference_channel":
            hist[c - 1] = 0.0
        values = _quantized(src)
        out_dtype = torch.uint8 if dtype == "uint8" else torch.float32
        out, lut, table = hk.hm_transfer(values, _t(hist), out_dtype)
        counts = _counts(values.numpy().reshape(src.shape[0], c, SRC[1], SRC[2]))
        lut_j = np.asarray(_jax_lut(counts, hist, float(SRC[0] * SRC[1] * SRC[2])))
        np.testing.assert_allclose(lut.numpy(), lut_j, atol=1e-4, rtol=0)
        for pin in (0.0, 255.0):
            np.testing.assert_array_equal(lut.numpy() == pin, lut_j == pin)
        if case == "empty_reference_channel":
            assert (lut[c - 1] == 255.0).all()
        assert torch.equal(table, hk.lut_table(lut, out_dtype))
        got = hm.hm_transform(_t(src), _t(hist))
        assert torch.equal(got.reshape(out.shape), out)
        for use_pallas in (True, False):
            want = jax_hm.hm_transform(jnp.asarray(src), jnp.asarray(hist), use_pallas=use_pallas)
            _assert_close(got, want, GREY[dtype])

    @pytest.mark.parametrize("c", [1, 3, 12])
    @pytest.mark.parametrize("out_dtype", [torch.uint8, torch.float32])
    def test_finalize_alone_on_an_empty_source_channel(self, c, out_dtype):
        """An empty source channel cannot come from images: the finalize
        alone (hm_lut) takes counts with one channel emptied."""
        src = _images("uint8", *SRC, seed=64, c=c)
        ref = _images("uint8", *REF, seed=65, c=c)
        counts = _counts(src)
        counts[c // 2] = 0.0
        hist = np.asarray(jax_hm.hm_fit(jnp.asarray(ref)))
        num = SRC[0] * SRC[1] * SRC[2]
        lut, table = hk.hm_lut(_t(counts).to(torch.int32), _t(hist), num, out_dtype)
        want = np.asarray(_jax_lut(counts, hist, float(num)))
        np.testing.assert_allclose(lut.numpy(), want, atol=1e-4, rtol=0)
        np.testing.assert_array_equal(lut.numpy() == 0.0, want == 0.0)
        assert (lut[c // 2] == 0.0).all()
        assert torch.equal(lut, hm.hm_build_lut(_t(counts), _t(hist), float(num)))
        assert torch.equal(table, hk.lut_table(lut, out_dtype))

    def test_float_table_is_a_true_division(self):
        """The float table's division by 255 is taken as the JAX package's
        compiled transform takes it, and the finalize too: a product with
        the float32 reciprocal of 255, bit for bit what numpy computes so."""
        lut = np.random.default_rng(9).random((3, 256)).astype(np.float32) * 260.0 - 2.0
        inverse = np.float32(1.0) / np.float32(255.0)
        want = np.clip(lut * inverse, np.float32(0.0), np.float32(1.0))
        np.testing.assert_array_equal(hk.lut_table(_t(lut), torch.float32).numpy(), want)

    @pytest.mark.parametrize("n, c, p", [(64, 3, 512 * 512), (1, 12, 5001), (3, 1, 1), (0, 3, 10),
                                         (2, 130, 257)])
    def test_hist_split_covers_each_channel(self, n, c, p):
        bpc, chunk = hk.hist_split(n, c, p, 132)
        assert chunk % 16 == 0 and bpc >= 1
        assert bpc * chunk >= n * p and (bpc - 1) * chunk < max(n * p, 1)
        assert bpc <= max(1, -(-4 * 132 // c))
        if n * p >= hk.MIN_BLOCK_VALUES:
            assert chunk >= hk.MIN_BLOCK_VALUES


@pytest.fixture(scope="module")
def ref_u8():
    return _images("uint8", *REF, seed=51)


@pytest.fixture(scope="module")
def src_u8():
    return _images("uint8", *SRC, seed=52)


@pytest.fixture(scope="module")
def jax_normalizer(ref_u8):
    return stainx_tpu.HistogramMatching(device="cpu").fit(ref_u8)


class TestPublicAPI:
    @pytest.mark.parametrize("dtype", ["uint8", "float32"])
    def test_matches_jax_and_oracle(self, dtype):
        ref, src = _images(dtype, *REF, seed=53), _images(dtype, *SRC, seed=54)
        got = HistogramMatching(device="cpu").fit(ref).transform(src)
        assert got.device.type == "cpu" and got.dtype == getattr(torch, dtype)
        want = stainx_tpu.HistogramMatching(device="cpu").fit(ref).transform(src)
        _assert_close(got, want, GREY[dtype])
        _assert_close(got, oracle.hm_transform(src, oracle.hm_fit(ref)), GREY[dtype])

    def test_nhwc_matches_oracle(self):
        ref = _images("uint8", *REF, seed=55, layout="nhwc")
        src = _images("uint8", *SRC, seed=56, layout="nhwc")
        got = HistogramMatching(device="cpu", channel_axis=-1).fit(ref).transform(src)
        assert tuple(got.shape) == src.shape
        _assert_close(got, oracle.hm_transform(src, oracle.hm_fit(ref, -1), -1), GREY["uint8"])

    def test_derived_views_match_jax(self, ref_u8, jax_normalizer):
        port = HistogramMatching(device="cpu").fit(ref_u8)
        np.testing.assert_allclose(port._ref_histograms_256.numpy(),
                                   np.asarray(jax_normalizer._ref_histograms_256), rtol=1e-6)
        np.testing.assert_allclose(port._reference_histogram.numpy(),
                                   np.asarray(jax_normalizer._reference_histogram), rtol=1e-5)
        for name in ("_ref_cdf", "_ref_vals"):
            got, want = getattr(port, name), getattr(jax_normalizer, name)
            assert len(got) == len(want) == 3
            for g, w in zip(got, want):
                np.testing.assert_allclose(g, w, rtol=1e-5)
        empty = HistogramMatching(device="cpu")
        assert empty._ref_cdf is None and empty._ref_vals is None and empty._reference_histogram is None

    @pytest.mark.parametrize("form", ["short_list", "long_list", "one_histogram"])
    def test_reference_coercion_matches_jax(self, form, ref_u8, src_u8, jax_normalizer):
        hists = np.asarray(jax_normalizer._ref_histograms_256)
        ref = {"short_list": [hists[0], hists[1]],
               "long_list": [hists[2], hists[1], hists[0], hists[0]],
               "one_histogram": hists[1]}[form]
        jax_m = stainx_tpu.HistogramMatching(device="cpu").fit(ref_u8)
        port = HistogramMatching(device="cpu").fit(ref_u8)
        jax_m._ref_histograms_256 = ref
        port._ref_histograms_256 = ref
        got = port.transform(src_u8)
        assert tuple(got.shape) == src_u8.shape
        _assert_close(got, jax_m.transform(src_u8), GREY["uint8"])

    @pytest.mark.parametrize("source", ["npz", "state_dict"])
    def test_jax_state_carries_over(self, source, tmp_path, jax_normalizer, src_u8):
        if source == "npz":
            path = tmp_path / "ref.npz"
            jax_normalizer.save_state(str(path))
            ported = HistogramMatching(device="cpu").load_state(state_from_jax(path, device="cpu"))
            direct = HistogramMatching(device="cpu").load_state_file(str(path))
            assert torch.equal(direct.transform(src_u8), ported.transform(src_u8))
        else:
            state = {k: np.asarray(v) for k, v in jax_normalizer.state.items()}
            ported = HistogramMatching(device="cpu").load_state(state_from_jax(state, device="cpu"))
        assert ported._is_fitted
        _assert_close(ported.transform(src_u8), jax_normalizer.transform(src_u8), GREY["uint8"])

    def test_identity_matching(self, src_u8):
        out = HistogramMatching(device="cpu").fit(src_u8).transform(src_u8)
        _assert_close(out, src_u8, GREY["uint8"])


class TestErrors:
    @pytest.mark.parametrize("axis", [0, 2, -2])
    def test_bad_channel_axis_raises_like_jax(self, axis):
        for cls in (HistogramMatching, stainx_tpu.HistogramMatching):
            with pytest.raises(ValueError, match="channel_axis must be one of"):
                cls(device="cpu", channel_axis=axis)

    @pytest.mark.parametrize("stage", ["fit", "transform"])
    def test_layout_error_matches_jax(self, stage, ref_u8):
        bad = np.zeros((3, 16, 16), np.uint8)
        for m in (HistogramMatching(device="cpu"), stainx_tpu.HistogramMatching(device="cpu")):
            if stage == "transform":
                m.fit(ref_u8)
            with pytest.raises(ValueError, match="HistogramMatching expects 4D batches"):
                getattr(m, stage)(bad)

    def test_transform_before_fit(self):
        with pytest.raises(ValueError, match="Must call fit"):
            HistogramMatching(device="cpu").transform(np.zeros((1, 3, 8, 8), np.uint8))

    def test_cpu_path_never_builds(self, monkeypatch, ref_u8, src_u8):
        def no_build():
            raise AssertionError("the CPU path must not build the CUDA kernels")

        monkeypatch.setattr(kernels, "build_all", no_build)
        before = (hk.histogram_256.launches, hk.apply_lut.launches)
        HistogramMatching(device="cpu").fit(ref_u8).transform(src_u8)
        assert (hk.histogram_256.launches, hk.apply_lut.launches) == before
