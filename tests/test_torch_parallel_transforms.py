"""The port's ``StainNormalizerTransform(mesh=...)`` against the JAX
package's on virtual CPU devices: a ``("batch",)`` mesh of 4 ranks, a
(2, 2) ``("batch", "pixel")`` mesh and a (1, 2, 2) ``("batch", "pixel",
"model")`` mesh (suite "nn").

One ``gloo`` group runs every case of ``tests/torch_parallel_cases.py``
while this process runs the JAX transform on the same seeded inputs; each
case is its own test. The counterparts of ``tests/test_transforms.py``'s
mesh classes, in both modes: reference mode, batch mode with a whole-batch
distributed fit and with ``batch_ref_index`` (also fitted pixel-sharded,
and taken from a ``DTensor`` batch), the fitted state usable on one device
afterwards, a malformed restored state, a restored 1D HM histogram, uneven
N and a single image, and the layout and argument errors. Every rank's
result, and a second run of each case, must be the same bits.
"""

import jax
import numpy as np
import pytest

from stainx_tpu import HistogramMatching, Macenko, StainNormalizerTransform
from stainx_tpu import parallel as jp
from tests import torch_parallel_cases as cases
from tests.oracles import numpy_reference as oracle

SUITE = "nn"
NAMES = cases.suite_case_names(SUITE)



def _jax_cases(m1, m2, m3):
    ref = oracle.synthetic_he_tile(64, 64, seed=42)
    big = np.concatenate([oracle.synthetic_he_tile(32, 32, seed=s, he_scale=1.1) for s in range(8)])

    def out(t, x):
        return {"out": np.asarray(t(x))}

    def T(*args, **kw):  # noqa: N802
        return StainNormalizerTransform(*args, device="cpu", **kw)

    def state_usable():
        t = T("macenko", mode="batch", batch_ref_index=None, mesh=m1)
        t(big)
        return {"out": np.asarray(t.normalizer.transform(big[:1])),
                "p0": np.asarray(t.normalizer._stain_matrix)}

    def malformed():
        m = Macenko(device="cpu")
        m.load_state({"_stain_matrix": np.full((3, 2), 0.5, np.float32),
                      "_target_max_conc": np.ones(3, np.float32)})
        return cases.error_of(lambda: T(normalizer=m, mesh=m1)(big))

    def hm_1d_state():
        hist_1d = np.zeros(256, np.float32)
        hist_1d[80:180] = 1.0 / 100.0
        norm = HistogramMatching(device="cpu")
        norm.load_state({"_ref_histograms_256": hist_1d})
        return out(T(normalizer=norm, mesh=m1), big)

    return {
        "reference_reinhard": (lambda: out(T("reinhard", reference=ref, mesh=m1), big), None, None),
        "batch_whole_macenko": (lambda: out(
            T("macenko", mode="batch", batch_ref_index=None, mesh=m1), big), None, None),
        "batch_index_macenko": (lambda: out(
            T("macenko", mode="batch", batch_ref_index=3, mesh=m1), big), None, None),
        "batch_whole_hm": (lambda: out(
            T("histogram_matching", mode="batch", batch_ref_index=None, mesh=m1), big), None, None),
        "state_usable": (state_usable, "macenko", None),
        "error_malformed_state": (malformed, None, "target_max_conc"),
        "hm_1d_state": (hm_1d_state, None, None),
        "uneven_reinhard": (lambda: out(T("reinhard", reference=ref, mesh=m1), big[:5]), None,
                            None),
        "single_3d_reinhard": (lambda: out(T("reinhard", reference=ref, mesh=m1), big[0]), None,
                               None),
        "error_layout_c4": (lambda: cases.error_of(lambda: T("macenko", reference=ref, mesh=m1)(
            np.zeros((8, 4, 32, 32), np.uint8))), None, "C=3"),
        "error_layout_5d": (lambda: cases.error_of(lambda: T("macenko", reference=ref, mesh=m1)(
            np.zeros((8, 4, 3, 32, 32), np.uint8))), None, "image tensor"),
        "error_channels_last": (lambda: cases.error_of(lambda: T(
            normalizer=HistogramMatching(device="cpu", channel_axis=-1),
            reference=np.zeros((1, 16, 16, 3), np.uint8), mesh=m1)), None, "NCHW"),
        "error_pixel_axis_without_mesh": (lambda: cases.error_of(lambda: T(
            "macenko", reference=ref, pixel_axis="pixel")), None, "pixel_axis requires mesh"),
        "px_reference_macenko": (lambda: out(
            T("macenko", reference=ref, mesh=m2, pixel_axis="pixel"), big), None, None),
        "px_batch_whole_macenko": (lambda: out(
            T("macenko", mode="batch", batch_ref_index=None, mesh=m2, pixel_axis="pixel"), big),
            None, None),
        "px_batch_index_macenko": (lambda: out(
            T("macenko", mode="batch", batch_ref_index=0, mesh=m2, pixel_axis="pixel"), big),
            None, None),
        # The port takes these batches as DTensors; JAX as host arrays.
        "dtensor_batch_index_macenko": (lambda: out(
            T("macenko", mode="batch", batch_ref_index=5, mesh=m1), big), None, None),
        "dtensor_px_batch_index_reinhard": (lambda: out(
            T("reinhard", mode="batch", batch_ref_index=6, mesh=m2, pixel_axis="pixel"), big),
            None, None),
        "dtensor_batch_index_hm": (lambda: out(
            T("histogram_matching", mode="batch", batch_ref_index=2, mesh=m2), big), None, None),
        "mesh3d_px_reference_macenko": (lambda: out(
            T("macenko", reference=ref, mesh=m3, pixel_axis="pixel"), big), None, None),
        "mesh3d_px_batch_whole_reinhard": (lambda: out(
            T("reinhard", mode="batch", batch_ref_index=None, mesh=m3, pixel_axis="pixel"), big),
            None, None),
        "mesh3d_px_batch_index_hm": (lambda: out(
            T("histogram_matching", mode="batch", batch_ref_index=1, mesh=m3,
              pixel_axis="pixel"), big), None, None),
        # The port's batch is a DTensor of the ("batch",) mesh, called on the 2D one.
        "dtensor_other_mesh_batch_index_macenko": (lambda: out(
            T("macenko", mode="batch", batch_ref_index=4, mesh=m2, pixel_axis="pixel"), big),
            None, None),
    }


@pytest.fixture(scope="module")
def suite(tmp_path_factory):
    """Start the group, compute the JAX side meanwhile, return both."""
    group = cases.Group(SUITE, tmp_path_factory.mktemp(SUITE))
    devices = jax.devices()[:4]
    m1 = jp.make_mesh(shape=(4,), axis_names=("batch",), devices=devices)
    m2 = jp.make_mesh(shape=(2, 2), axis_names=("batch", "pixel"), devices=devices)
    m3 = jp.make_mesh(shape=(1, 2, 2), axis_names=("batch", "pixel", "model"), devices=devices)
    refs = {}
    for name, (fn, fit, error) in _jax_cases(m1, m2, m3).items():
        try:
            refs[name] = (fn(), fit, error)
        except Exception as exc:  # reported by the case's own test
            refs[name] = (exc, fit, error)
    return group, refs


def test_every_case_has_a_jax_side(suite):
    assert sorted(suite[1]) == sorted(NAMES)


@pytest.mark.parametrize("name", NAMES)
def test_case(suite, name):
    group, refs = suite
    want, fit, error = refs[name]
    if isinstance(want, Exception):
        raise want
    cases.check(group.case(name), want, fit=fit, error=error)
