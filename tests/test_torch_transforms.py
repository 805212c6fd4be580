"""The port's ``StainNormalizerTransform`` against the JAX package's, on the CPU.

The same seeded numpy batches go through ``stainx_tpu.StainNormalizerTransform``
and ``stainx_tpu_torch.StainNormalizerTransform`` (both ``device="cpu"``).
Tolerances are the repo's cross-implementation gates: within 1 grey level
(Macenko's default output is divided by 255, so 1/255 there, plus float32
rounding of the division). The guards mirror ``tests/test_transforms.py``.
"""

import numpy as np
import pytest
import torch

import stainx_tpu
from stainx_tpu_torch import HistogramMatching, Macenko, Reinhard, StainNormalizerTransform

from tests.oracles import numpy_reference as oracle

METHODS = ["macenko", "reinhard", "histogram_matching"]


def _tol(method):
    return 1.0 / 255.0 + 1e-6 if method == "macenko" else 1.0


def _close(got, want, method):
    assert torch.is_tensor(got) and got.device.type == "cpu"
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape and str(got.dtype).split(".")[1] == str(want.dtype)
    np.testing.assert_allclose(
        got.float().numpy(), want.astype(np.float32), atol=_tol(method), rtol=0
    )


@pytest.fixture
def he_ref():
    return oracle.synthetic_he_tile(64, 64, seed=42)


@pytest.fixture
def he_batch():
    """Three 61×67 tiles: 12 261 pixels against the reference's 4 096, so no
    source CDF value equals a reference quantile in exact arithmetic (at
    3×64² they coincide, float32 rounding then picks the side of a plateau,
    and the JAX routes themselves differ from the oracle by 6 grey levels)."""
    tiles = [oracle.synthetic_he_tile(61, 67, seed=s, he_scale=1.1) for s in (1, 2, 3)]
    return np.concatenate(tiles, axis=0)


class TestMatchesJax:
    @pytest.mark.parametrize("method", METHODS)
    @pytest.mark.parametrize(
        "mode,idx", [("reference", 0), ("batch", 0), ("batch", None)],
        ids=["reference", "batch-index-0", "batch-whole"],
    )
    def test_forward(self, method, mode, idx, he_ref, he_batch):
        kw = {"reference": he_ref} if mode == "reference" else {"batch_ref_index": idx}
        port = StainNormalizerTransform(method, mode=mode, device="cpu", **kw)
        ref = stainx_tpu.StainNormalizerTransform(method, mode=mode, device="cpu", **kw)
        _close(port(he_batch), ref(he_batch), method)

    @pytest.mark.parametrize("method", METHODS)
    def test_float_input(self, method, he_ref, he_batch):
        x = he_batch.astype(np.float32) / 255.0
        port = StainNormalizerTransform(method, reference=he_ref, device="cpu")
        ref = stainx_tpu.StainNormalizerTransform(method, reference=he_ref, device="cpu")
        # float outputs are in [0, 1]: one grey level is 1/255 there
        got, want = port(x), np.asarray(ref(x))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, atol=1.0 / 255.0 + 1e-6, rtol=0)

    def test_hm_channels_last(self, he_ref, he_batch):
        nhwc_ref = np.transpose(he_ref, (0, 2, 3, 1))
        nhwc_batch = np.transpose(he_batch, (0, 2, 3, 1))
        kw = {"channel_axis": -1, "reference": nhwc_ref, "device": "cpu"}
        port = StainNormalizerTransform("histogram_matching", **kw)
        ref = stainx_tpu.StainNormalizerTransform("histogram_matching", **kw)
        _close(port(nhwc_batch), ref(nhwc_batch), "histogram_matching")

    @pytest.mark.parametrize("method", METHODS)
    def test_single_image_squeeze(self, method, he_ref):
        chw = oracle.synthetic_he_tile(64, 64, seed=9)[0]
        port = StainNormalizerTransform(method, reference=he_ref, device="cpu")
        ref = stainx_tpu.StainNormalizerTransform(method, reference=he_ref, device="cpu")
        got = port(chw)
        assert got.shape == chw.shape
        _close(got, ref(chw), method)


class TestConstruction:
    def test_reference_mode_requires_reference(self):
        with pytest.raises(ValueError, match="reference"):
            StainNormalizerTransform(method="reinhard", mode="reference", device="cpu")

    def test_invalid_mode(self, he_ref):
        with pytest.raises(ValueError, match="mode"):
            StainNormalizerTransform(mode="bogus", reference=he_ref, device="cpu")

    def test_invalid_method(self, he_ref):
        with pytest.raises(ValueError, match="method"):
            StainNormalizerTransform(method="bogus", reference=he_ref, device="cpu")

    def test_channel_axis_only_for_hm(self, he_ref):
        with pytest.raises(ValueError, match="channel_axis"):
            StainNormalizerTransform(method="reinhard", channel_axis=-1, reference=he_ref, device="cpu")

    def test_n01_only_for_macenko(self, he_ref):
        with pytest.raises(ValueError, match="normalize_to_0_1"):
            StainNormalizerTransform(method="reinhard", normalize_to_0_1=True, reference=he_ref, device="cpu")

    def test_n01_only_for_prebuilt_macenko(self):
        with pytest.raises(ValueError, match="normalize_to_0_1"):
            StainNormalizerTransform(
                normalizer=Reinhard(device="cpu"), mode="batch", normalize_to_0_1=True, device="cpu"
            )

    def test_prefitted_normalizer_skips_reference(self, he_ref):
        norm = Reinhard(device="cpu").fit(he_ref)
        t = StainNormalizerTransform(normalizer=norm, mode="reference", device="cpu")
        assert t.normalizer is norm

    def test_prebuilt_hm_axis_conflict(self):
        hm = HistogramMatching(device="cpu", channel_axis=-1)
        with pytest.raises(ValueError, match="conflicts"):
            StainNormalizerTransform(normalizer=hm, mode="batch", channel_axis=-3, device="cpu")

    def test_prebuilt_hm_axis_sync(self):
        hm = HistogramMatching(device="cpu", channel_axis=-1)
        t = StainNormalizerTransform(normalizer=hm, mode="batch", device="cpu")
        assert t.channel_axis == -1

    def test_prebuilt_macenko_rejects_channels_last(self):
        with pytest.raises(ValueError, match="channel_axis"):
            StainNormalizerTransform(
                normalizer=Macenko(device="cpu"), mode="batch", channel_axis=-1, device="cpu"
            )


class TestNormalizeTo01Default:
    def test_macenko_defaults_true(self, he_ref, he_batch):
        t = StainNormalizerTransform(method="macenko", reference=he_ref, device="cpu")
        out = t(he_batch.astype(np.float32) / 255.0)
        assert out.max() <= 1.0 + 1e-5

    def test_macenko_explicit_false(self, he_ref, he_batch):
        t = StainNormalizerTransform(
            method="macenko", reference=he_ref, normalize_to_0_1=False, device="cpu"
        )
        assert t(he_batch).max() > 1.0

    def test_prebuilt_macenko_flag_synced(self, he_ref):
        norm = Macenko(device="cpu", normalize_to_0_1=False).fit(he_ref)
        StainNormalizerTransform(normalizer=norm, normalize_to_0_1=True, device="cpu")
        assert norm.normalize_to_0_1 is True

    def test_prebuilt_macenko_flag_untouched_when_unset(self, he_ref):
        norm = Macenko(device="cpu", normalize_to_0_1=False).fit(he_ref)
        StainNormalizerTransform(normalizer=norm, device="cpu")
        assert norm.normalize_to_0_1 is False


class TestForward:
    def test_reference_mode_matches_manual(self, he_ref, he_batch):
        t = StainNormalizerTransform(method="reinhard", reference=he_ref, device="cpu")
        manual = Reinhard(device="cpu").fit(he_ref).transform(he_batch)
        assert torch.equal(t(he_batch), manual)

    def test_batch_mode_refits_every_call(self, he_batch):
        t = StainNormalizerTransform(method="reinhard", mode="batch", device="cpu")
        t(he_batch)
        first = t.normalizer._reference_mean.clone()
        other = np.concatenate(
            [oracle.synthetic_he_tile(61, 67, seed=s, he_scale=0.8) for s in (7, 8)], axis=0
        )
        t(other)
        assert not torch.allclose(first, t.normalizer._reference_mean)

    def test_batch_mode_whole_batch_matches_manual(self, he_batch):
        t = StainNormalizerTransform(method="macenko", mode="batch", batch_ref_index=None, device="cpu")
        manual = Macenko(device="cpu", normalize_to_0_1=True).fit(he_batch).transform(he_batch)
        assert torch.equal(t(he_batch), manual)

    def test_batch_ref_index_out_of_range(self, he_batch):
        t = StainNormalizerTransform(method="reinhard", mode="batch", batch_ref_index=10, device="cpu")
        with pytest.raises(IndexError, match="batch_ref_index"):
            t(he_batch)
        t = StainNormalizerTransform(method="reinhard", mode="batch", batch_ref_index=-1, device="cpu")
        with pytest.raises(IndexError, match="batch_ref_index"):
            t(he_batch)

    def test_nhwc_rejected_for_macenko(self, he_ref):
        t = StainNormalizerTransform(method="macenko", reference=he_ref, device="cpu")
        with pytest.raises(ValueError, match="NCHW"):
            t(np.transpose(he_ref, (0, 2, 3, 1)))

    def test_hm_channels_last_shape(self, he_ref):
        t = StainNormalizerTransform(
            method="histogram_matching", channel_axis=-1,
            reference=np.transpose(he_ref, (0, 2, 3, 1)), device="cpu",
        )
        with pytest.raises(ValueError, match="channels-last"):
            t(he_ref)

    @pytest.mark.parametrize("shape", [(64, 64), (1, 1, 3, 8, 8)])
    def test_rank_is_checked(self, shape, he_ref):
        t = StainNormalizerTransform(method="reinhard", reference=he_ref, device="cpu")
        with pytest.raises(ValueError, match="image tensor"):
            t(np.zeros(shape, np.uint8))

    def test_float_above_one_not_rescaled(self, he_ref):
        """Float inputs beyond 1 (colour jitter) stay on the [0, 1]-float path."""
        t = StainNormalizerTransform(method="reinhard", reference=he_ref, device="cpu")
        jittered = np.clip(he_ref.astype(np.float32) / 255.0 * 1.2, 0, 1.2)
        out = t(jittered)
        assert out.dtype == torch.float32 and out.max() <= 1.0 + 1e-5

    def test_forward_and_call_agree(self, he_ref, he_batch):
        t = StainNormalizerTransform(method="reinhard", reference=he_ref, device="cpu")
        assert torch.equal(t.forward(he_batch), t(he_batch))

    def test_single_image_as_nested_list_squeezes(self, he_ref):
        t = StainNormalizerTransform(method="reinhard", reference=he_ref, device="cpu")
        img = he_ref[0]
        assert t(img).shape == t(img.tolist()).shape == img.shape


class TestModuleAndDevice:
    def test_fitted_parameters_not_in_state_dict(self, he_ref):
        t = StainNormalizerTransform(method="macenko", reference=he_ref, device="cpu")
        assert isinstance(t, torch.nn.Module)
        assert t.normalizer.state["_stain_matrix"] is not None
        assert len(t.state_dict()) == 0
        assert not list(t.parameters()) and not list(t.buffers())

    def test_default_device_raises_without_cuda(self, monkeypatch, he_ref):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA"):
            StainNormalizerTransform(method="reinhard", mode="batch")
        with pytest.raises(RuntimeError, match="CUDA"):
            StainNormalizerTransform(method="macenko", reference=he_ref)

    def test_host_input_goes_to_the_normalizer_device(self, he_ref):
        """With ``device=None`` a numpy array or a CPU tensor is a host input:
        it goes to the (here prebuilt, CPU) normalizer's device, which stays."""
        norm = Reinhard(device="cpu").fit(he_ref)
        t = StainNormalizerTransform(normalizer=norm)
        for x in (he_ref, torch.as_tensor(he_ref)):
            out = t(x)
            assert out.device.type == "cpu" and norm.device == torch.device("cpu")

    def test_explicit_device_moves_a_prebuilt_normalizer(self, he_ref):
        norm = Reinhard(device="cpu").fit(he_ref)
        t = StainNormalizerTransform(normalizer=norm, device="cpu")
        assert t.device == torch.device("cpu") and t(he_ref).device.type == "cpu"
