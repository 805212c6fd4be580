"""Batch mode's Macenko fit fused into B4's cluster launch.

On the CPU: the route's predicate (``ops.macenko.fuses_fit`` and
``kernels.macenko_stream.fused_shape``) with an H100's occupancy standing in
for the card, which calls reach the fused wrapper (a CPU tensor that reports
itself as a CUDA tensor stands in for a card's batch, the wrapper running
its plain version), the index checks, the spans, and the fused C call's
arguments and fitted state with the C library replaced by a recorder. On
the card (marker ``cuda``): the fused launch's row statistics against B4's
own bit for bit, its fit against B5's, its output against the two-launch
route, reference tiles with under 3 beta-masked pixels, the launch counts of
the training forward and of a 256-row batch, a stale fused state caught by
the training cell's check, and the SASS of the transform-only instantiations.

Imports no JAX, so that on a card's machine it runs as
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_fused_fit.py``.
"""

from __future__ import annotations

import contextlib
import ctypes
import importlib.util
import re
import subprocess
import time
from pathlib import Path

import pytest
import torch

from stainx_tpu_torch import (
    HistogramMatching,
    Macenko,
    Reinhard,
    StainNormalizerTransform,
    kernels,
    profiling,
)
from stainx_tpu_torch.kernels import macenko_stream as ms
from stainx_tpu_torch.ops import macenko as mk
from stainx_tpu_torch.testing import synthetic_he_batch

ROOT = Path(__file__).resolve().parent.parent
SOURCE = (kernels.CSRC / "macenko_stream.cu").read_text()
H100_SMEM = 232_448
H100_ACTIVE = {1: 132, 2: 66, 4: 30, 8: 15, 16: 7}  # clusters of c blocks the H100 holds at once
TRAIN = (128, 256, 256)  # the batch-mode training batch


def h100_active(c, resident):
    return H100_ACTIVE[c]


class _CudaTyped(torch.Tensor):
    """A CPU tensor that reports itself as a CUDA tensor: the route's input
    without a card. Where it reaches a kernel wrapper, the wrapper runs its
    plain version (the tensor's device is the CPU)."""

    @property
    def is_cuda(self):
        return True


def _tiles(shape, seed: int, dtype=torch.float32, dev="cpu") -> torch.Tensor:
    n, h, w = shape
    x = torch.as_tensor(synthetic_he_batch(n, h, w, seed=seed, he_scale=1.1)).to(dev)
    return x if dtype == torch.uint8 else x.to(torch.float32) / 255.0


@pytest.fixture
def h100(monkeypatch):
    """An H100's shared memory and cluster occupancy in place of the card's."""
    monkeypatch.setattr(kernels, "device_limits", lambda index: (132, H100_SMEM))
    monkeypatch.setattr(ms, "_active_clusters", lambda index, dtype, c, r: H100_ACTIVE[c])


# ------------------------------------------------------------------ route
class TestRoute:
    @pytest.mark.parametrize("dtype", [torch.uint8, torch.float32], ids=["uint8", "float32"])
    @pytest.mark.parametrize("rows,csize", [(1, 16), (4, 16), (7, 16), (8, 8), (64, 2),
                                            (67, 1), (128, 1), (132, 1)])
    def test_fused_where_every_row_is_resident(self, h100, dtype, rows, csize):
        """Rows of 256^2 take clusters of 16 up to 7 rows, down to one block
        past 66 rows (the H100 holds 66 clusters of 2): up to 132 rows, one
        block a SM, in one wave."""
        shape = ms.fused_shape(rows, 256 * 256, dtype.itemsize, H100_SMEM, h100_active)
        assert shape == ms.cluster_shape(rows, 256 * 256, dtype.itemsize, H100_SMEM,
                                         h100_active)
        assert shape[0] == csize
        x = torch.empty((rows, 3, 256, 256), dtype=dtype).as_subclass(_CudaTyped)
        assert mk.fuses_fit(x)

    @pytest.mark.parametrize(
        "shape,dtype",
        [((256, 256, 256), torch.float32),  # 256 rows: two waves of one-block clusters
         ((133, 256, 256), torch.uint8),
         ((4, 1024, 1024), torch.uint8),  # streamed rows, past 8 blocks' shared memory
         ((4, 512, 512), torch.float32),
         ((256, 64, 64), torch.uint8),  # B1's tiles
         ((256, 64, 64), torch.float32),
         ((512, 224, 224), torch.uint8),  # the ladder's most rows, two waves
         ((257, 256, 256), torch.float32)],  # past the ladder's 256 float32 rows: B1
        ids=["f32-256-rows", "u8-133-rows", "u8-streamed", "f32-streamed", "u8-B1", "f32-B1",
             "u8-512-rows", "f32-257-rows"])
    def test_two_launches_elsewhere(self, h100, shape, dtype):
        n, h, w = shape
        x = torch.empty((n, 3, h, w), dtype=dtype).as_subclass(_CudaTyped)
        assert not mk.fuses_fit(x)
        if mk.transform_route(n, h * w, dtype) == "stream":
            assert ms.fused_shape(n, h * w, dtype.itemsize, H100_SMEM, h100_active) is None

    @pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float64])
    def test_staged_dtypes_take_two_calls(self, h100, dtype):
        x = torch.empty((128, 3, 256, 256), dtype=dtype).as_subclass(_CudaTyped)
        assert not mk.fuses_fit(x)

    def test_the_cpu_takes_two_calls(self, h100):
        assert not mk.fuses_fit(torch.empty((128, 3, 256, 256), dtype=torch.float32))

    def test_fused_shape_is_the_cluster_shape_where_all_rows_are_resident(self, h100):
        for rows in range(1, 300, 7):
            for row_len in (160 * 160, 224 * 224, 256 * 256, 126_336, 400_000):
                for itemsize in (1, 4):
                    want = ms.cluster_shape(rows, row_len, itemsize, H100_SMEM, h100_active)
                    got = ms.fused_shape(rows, row_len, itemsize, H100_SMEM, h100_active)
                    resident = want is not None and H100_ACTIVE[want[0]] >= rows
                    assert got == (want if resident else None)


# ------------------------------------------------------------- API level
@pytest.fixture
def spies(monkeypatch):
    """Calls of the fused wrapper and of ``Macenko.fit``."""
    seen = {"fused": [], "fit": []}
    fused, fit = ms.macenko_fit_transform_stream, Macenko.fit

    def fused_spy(images, idx, **kwargs):
        seen["fused"].append(idx)
        return fused(images, idx, **kwargs)

    def fit_spy(self, images):
        seen["fit"].append(tuple(images.shape))
        return fit(self, images)

    monkeypatch.setattr(ms, "macenko_fit_transform_stream", fused_spy)
    monkeypatch.setattr(Macenko, "fit", fit_spy)
    return seen


@pytest.fixture
def fusing(monkeypatch, spies):
    """Every batch fuses (``fuses_fit`` stands in for a card that holds it),
    so CPU tensors reach the fused wrapper's plain version; B4's route opens
    at 32^2, so that small tiles take it, as on the card."""
    monkeypatch.setattr(mk, "fuses_fit", lambda images: True)
    monkeypatch.setattr(mk, "STREAM_MIN_ELEMS", 32 * 32)
    monkeypatch.setattr(mk, "STREAM_MIN_ELEMS_F32", 32 * 32)
    return spies


@pytest.mark.parametrize("dtype", [torch.uint8, torch.float32], ids=["uint8", "float32"])
@pytest.mark.parametrize("idx", [0, 2])
def test_batch_mode_forward_takes_the_fused_call(fusing, dtype, idx):
    """Batch mode with an image index: one fused call and no ``fit``; the
    output and the state are the two-step's (at 144^2 both fits are B5's),
    bit for bit."""
    x = _tiles((3, 144, 144), 1, dtype)
    forward = StainNormalizerTransform("macenko", mode="batch", batch_ref_index=idx, device="cpu")
    out = forward(x)
    assert fusing == {"fused": [idx], "fit": []}
    norm = forward.normalizer
    assert norm._is_fitted and not norm._range_folded
    want_norm = Macenko(device="cpu", normalize_to_0_1=True).fit(x[idx:idx + 1])
    assert torch.equal(out, want_norm.transform(x))
    for name in ("_stain_matrix", "_target_max_conc"):
        assert torch.equal(getattr(norm, name), getattr(want_norm, name))


@pytest.mark.parametrize(
    "make",
    [lambda: StainNormalizerTransform("macenko", mode="batch", batch_ref_index=None,
                                      device="cpu"),
     lambda: StainNormalizerTransform("macenko", mode="reference",
                                      reference=_tiles((1, 32, 32), 9), device="cpu"),
     lambda: StainNormalizerTransform("reinhard", mode="batch", device="cpu"),
     lambda: StainNormalizerTransform("histogram_matching", mode="batch", device="cpu")],
    ids=["batch_ref_index-None", "reference-mode", "reinhard", "histogram_matching"])
def test_other_forwards_take_no_fused_call(fusing, make):
    """Even where every batch would fuse, the forwards that fit the whole
    batch, fit once, or are not Macenko take no fused call."""
    forward = make()
    fits = len(fusing["fit"])
    forward(_tiles((4, 32, 32), 2))
    assert fusing["fused"] == []
    is_macenko = isinstance(forward.normalizer, Macenko)
    assert len(fusing["fit"]) - fits == int(is_macenko and forward.mode == "batch")


def test_a_mesh_forward_takes_no_fused_call(fusing, monkeypatch):
    """With a mesh, every forward goes to the mesh path, which fits through
    ``fit`` or the distributed fits and never through the fused call."""
    forward = StainNormalizerTransform("macenko", mode="batch", device="cpu", mesh=object())
    monkeypatch.setattr(StainNormalizerTransform, "_forward_on_mesh", lambda self, img: "mesh")
    assert forward(_tiles((4, 32, 32), 3)) == "mesh"
    assert fusing["fused"] == []


def test_the_cpu_forward_calls_fit_once(spies):
    """On a CPU batch the template's two steps run: ``fit`` once on the
    chosen image, then the transform."""
    forward = StainNormalizerTransform("macenko", mode="batch", batch_ref_index=1, device="cpu")
    forward(_tiles((4, 32, 32), 4))
    assert spies == {"fused": [], "fit": [(1, 3, 32, 32)]}


@pytest.mark.parametrize("method", [Reinhard, HistogramMatching])
def test_the_template_step_is_fit_then_transform(method):
    x = _tiles((3, 32, 32), 5, torch.uint8)
    out = method(device="cpu")._fit_transform_at(x, 2)
    assert torch.equal(out, method(device="cpu").fit(x[2:3]).transform(x))


def test_fused_spans(fusing):
    """The fused forward's spans: ``stainx.fit`` with no child, then
    ``stainx.transform`` holding B4's span, whose arguments name the fit's
    row."""
    forward = StainNormalizerTransform("macenko", mode="batch", batch_ref_index=3, device="cpu",
                                       normalize_to_0_1=False)
    x = _tiles((4, 32, 32), 6)
    with profiling.annotate("stainx.test.off"):
        pass
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        forward(x)
    spans = profiling.session().spans
    assert [s.name for s in spans] == ["stainx.forward", "stainx.fit", "stainx.transform",
                                       "stainx.kernel.B4"]
    fit, transform, b4 = spans[1:]
    assert fit.parent == transform.parent == 0 and b4.parent == 2
    assert b4.args == {"fit_row": 3}


# ------------------------------------------------------------- indices
@pytest.mark.parametrize("idx", [4, -1, 100])
def test_out_of_range_rows_raise(idx):
    x = _tiles((4, 32, 32), 7)
    with pytest.raises(IndexError, match="out of range"):
        ms.macenko_fit_transform_stream(x, idx)
    with pytest.raises(IndexError, match="out of range"):
        mk.macenko_fit_transform(x, idx)
    with pytest.raises(IndexError, match="batch_ref_index"):
        StainNormalizerTransform("macenko", mode="batch", batch_ref_index=idx, device="cpu")(x)


@pytest.mark.parametrize("idx", [1.0, "1", None])
def test_a_row_is_an_integer(idx):
    with pytest.raises(TypeError):
        ms.check_fit_row(idx, 4)


def test_ops_pair_is_the_fit_then_the_transform():
    """Off the fused route, ``macenko_fit_transform`` is ``macenko_fit`` on
    the image and ``macenko_transform`` on the batch, bit for bit."""
    x = _tiles((3, 40, 40), 8)
    out, he, mc = mk.macenko_fit_transform(x, 1, scale=mk.UNIT_SCALE)
    he2, mc2 = mk.macenko_fit(x[1:2])
    assert torch.equal(he, he2) and torch.equal(mc, mc2)
    assert torch.equal(out, mk.macenko_transform(x, he2, mc2, scale=mk.UNIT_SCALE))


def test_the_plain_version_is_b5_then_b4():
    x = _tiles((3, 40, 40), 10)
    out, he, mc = ms.macenko_fit_transform_stream(x, 2, scale=mk.UNIT_SCALE)
    he5, mc5 = ms.macenko_fit_stream_plain(x[2:3])
    assert torch.equal(he, he5) and torch.equal(mc, mc5)
    assert torch.equal(out, ms.macenko_transform_stream_plain(x, he5, mc5, mk.UNIT_SCALE))


# --------------------------------------------------- the C call, recorded
NAMES = ("x", "out", "n", "p", "is_uint8", "vec", "csize", "slice", "resident", "idx99",
         "ref_row", "out_scale", "prm", "fit_prm", "keys", "stream", "launch_start", "launch_end")


def _fused_call(monkeypatch, images, idx, scale=1.0):
    """``ms._fit_transform`` with the card's parts replaced by H100
    stand-ins and a C library that records its call's arguments by name."""
    calls = []

    class Lib:
        _stainx_declared = True

        @staticmethod
        def stainx_cluster_fit_transform(*args):
            calls.append(dict(zip(NAMES, args, strict=True)))
            return 0

    monkeypatch.setattr(kernels, "device_limits", lambda index: (132, H100_SMEM))
    monkeypatch.setattr(kernels, "current_stream", lambda dev: None)
    monkeypatch.setattr(kernels, "on_device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(ms, "_lib", lambda: Lib)
    monkeypatch.setattr(ms, "_active_clusters", lambda index, dtype, c, r: H100_ACTIVE[c])
    out, he, mc = ms._fit_transform(images, idx, scale)
    (call,) = calls
    return out, he, mc, call


@pytest.mark.parametrize("dtype", [torch.uint8, torch.float32], ids=["uint8", "float32"])
def test_fused_call_arguments_and_state(monkeypatch, dtype):
    """The training batch: one C call on clusters of one block, the fit's row
    and its own 32-float RowParams; the state is a (3, 2) and a (2,) view of
    those 128 bytes, not of the RowParams and key field of the rows."""
    images = torch.empty((128, 3, 256, 256), dtype=dtype)
    before = profiling.counters()
    scale = 1.0 if dtype == torch.uint8 else mk.UNIT_SCALE
    out, he, mc, call = _fused_call(monkeypatch, images, 5, scale)
    resident = 63_168 if dtype == torch.uint8 else 15_792
    assert (call["csize"], call["slice"], call["resident"]) == (1, 65_536, resident)
    assert (call["n"], call["p"], call["ref_row"], call["out_scale"]) == (128, 65_536, 5, scale)
    assert call["idx99"] == mk.static_nearest_rank_index(99, 65_536)
    assert call["x"] == images.data_ptr() and call["out"] == out.data_ptr()
    assert out.shape == images.shape and out.dtype == dtype
    assert he.shape == (3, 2) and mc.shape == (2,)
    assert he.dtype == mc.dtype == torch.float32
    assert call["fit_prm"] == he.data_ptr() - 8 * 4 == mc.data_ptr() - 22 * 4
    assert he.untyped_storage().nbytes() == mc.untyped_storage().nbytes() == 128
    assert call["prm"] not in (he.data_ptr(), call["fit_prm"])
    assert (call["keys"] is None) == (dtype == torch.uint8)
    after = profiling.counters()
    delta = {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)}
    want = {"launch.B4.cluster": 1, "fit.fused": 1}
    if dtype == torch.float32:
        want["keyfield.B4"] = 1
    assert delta == want


def test_fused_call_refuses_rows_the_card_does_not_hold(monkeypatch):
    with pytest.raises(ValueError, match="not held by the card at once"):
        _fused_call(monkeypatch, torch.empty((256, 3, 256, 256), dtype=torch.float32), 0)


def test_c_interface_takes_every_argument(monkeypatch):
    """The ctypes declaration has one type a parameter of the fused C entry
    point, in the order the wrapper passes them."""

    class Fn:
        pass

    class Lib:
        pass

    for name in ("stainx_cluster_run", "stainx_stream_run", "stainx_stream_fields",
                 "stainx_cluster_fit_transform", "stainx_cluster_occupancy"):
        setattr(Lib, name, Fn())
    monkeypatch.setattr(kernels, "library", lambda stem: Lib)
    lib = ms._lib()
    params = re.search(r"int stainx_cluster_fit_transform\((.*?)\) \{", SOURCE, re.S).group(1)
    names = [q.strip().split()[-1].lstrip("*") for q in params.split(",")]
    assert names == ["x", "out", "n", "p", "is_uint8", "vec", "csize", "S", "R", "idx99",
                     "ref_row", "out_scale", "prm", "fit_prm", "keys", "stream", "launch_start",
                     "launch_end"]
    argtypes = lib.stainx_cluster_fit_transform.argtypes
    assert len(argtypes) == len(names) and argtypes[names.index("out_scale")] is ctypes.c_float
    assert all(argtypes[names.index(k)] is ctypes.c_longlong for k in ("idx99", "ref_row"))


def test_only_the_fused_mode_waits_on_the_grid():
    """The grid barrier and the reads of the fit are the fused mode's alone;
    the transform-only kernel keeps its early return for a fit."""
    kernel = re.search(r"cluster_kernel\(const T\* __restrict__ x.*?\n\}\n", SOURCE,
                       re.S).group(0)
    assert SOURCE.count("cg::this_grid().sync()") == 1
    assert "if constexpr (Fused) {\n    cg::this_grid().sync();" in kernel
    assert "if constexpr (!Fused) {\n    if (out == nullptr) return;" in kernel
    assert kernel.count("*fit_prm = sh.row;") == 2


# ------------------------------------------------------------------ card
def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the fused launch runs in the CUDA kernel")
    return torch.device("cuda", 0)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int32)


WRITTEN = list(range(0, 7)) + list(range(8, 24))  # RowParams columns a kernel writes


def _fused_params(x, idx, scale):
    """The fused call's RowParams, fit and output, and B4's own RowParams on
    the same shape (its stain and maxC from a plain fit of another tile)."""
    dev = x.device
    shape = ms.fused_shape(x.shape[0], x.shape[2] * x.shape[3], x.element_size(),
                           kernels.device_limits(dev.index)[1],
                           ms.active_clusters(dev.index, x.dtype))
    assert shape is not None
    out, fit_prm = torch.empty_like(x), torch.empty(ms.PARAMS_WIDTH, device=dev)
    prm = ms._run(x, out, None, None, fit=False, force="cluster", shape=shape, scale=scale,
                  fit_into=fit_prm, fit_row=idx)[:x.shape[0]].clone()
    he, mc = ms.macenko_fit_stream_plain(_tiles((1, 64, 64), 99))
    own = ms._run(x, torch.empty_like(x), he.to(dev), mc.to(dev), fit=False, force="cluster",
                  shape=shape, scale=scale)[:x.shape[0]].clone()
    return prm, own, fit_prm, out


# (batch shape, fit row): the training batch (clusters of one block), then
# clusters of 16, 2 and 4 blocks (ragged rows past the resident part).
CARD_CASES = [(TRAIN, 0), (TRAIN, 5), (TRAIN, 127), ((4, 256, 256), 3), ((64, 256, 256), 63),
              ((20, 331, 331), 7)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.uint8, torch.float32], ids=["uint8", "float32"])
@pytest.mark.parametrize("shape,idx", CARD_CASES,
                         ids=[f"{n}x{h}x{w}-row{i}" for (n, h, w), i in CARD_CASES])
def test_fused_launch_on_the_card(dtype, shape, idx):
    """Every row's statistics equal B4's own bit for bit, the fit is the
    reference row's statistics, within 2e-5 of B5's fit of that image alone
    (maxC relative), and the output is within one grey level of the
    two-launch route and equal, bit for bit, to B4 on the fused fit."""
    dev = _card()
    x = _tiles(shape, 11 + idx, dtype, dev)
    scale = mk.UNIT_SCALE if dtype == torch.float32 else 1.0
    prm, own, fit_prm, out = _fused_params(x, idx, scale)
    torch.cuda.synchronize(dev)
    assert torch.equal(_bits(prm[:, WRITTEN]), _bits(own[:, WRITTEN]))
    assert torch.equal(_bits(fit_prm[WRITTEN]), _bits(prm[idx, WRITTEN]))
    he, mc = fit_prm[ms.HE_COLUMNS].view(3, 2), fit_prm[ms.MAXC_COLUMNS]
    he5, mc5 = ms.macenko_fit_stream(x[idx:idx + 1])
    assert float((he - he5).abs().max()) <= 2e-5
    assert float(((mc - mc5).abs() / mc5.abs()).max()) <= 2e-5
    two = ms.macenko_transform_stream(x, he5, mc5, scale=scale)
    grey = 255.0 if dtype == torch.float32 else 1.0
    assert float((out.float() - two.float()).abs().max()) * grey <= 1.0
    assert torch.equal(out, ms.macenko_transform_stream(x, he, mc, scale=scale))
    again = ms.macenko_fit_transform_stream(x, idx, scale=scale)
    assert torch.equal(again[0], out) and torch.equal(_bits(again[1]), _bits(he))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.uint8, torch.float32], ids=["uint8", "float32"])
@pytest.mark.parametrize("members", [0, 2])
def test_reference_tile_under_three_beta_pixels(dtype, members):
    """A reference tile whose beta-mask keeps under 3 pixels: its own row
    takes the transform's fallback, the fit does not. The fit equals B5's
    no-fallback fit of the tile alone bit for bit (sums of at most two
    pixels do not depend on their order), NaN where B5 gives NaN, and the
    batch is B4 on that fit."""
    dev = _card()
    x = _tiles(TRAIN, 21, torch.uint8, dev)
    idx = 5
    x[idx] = 255
    for k in range(members):
        x[idx, :, 100 + k, 37] = torch.tensor([90, 40, 110], dtype=torch.uint8)
    if dtype == torch.float32:
        x = x.to(torch.float32) / 255.0
    scale = mk.UNIT_SCALE if dtype == torch.float32 else 1.0
    prm, own, fit_prm, out = _fused_params(x, idx, scale)
    he5, mc5 = ms.macenko_fit_stream(x[idx:idx + 1])
    torch.cuda.synchronize(dev)
    assert prm[idx, 6] == 1.0 and fit_prm[6] == 0.0  # the row's fallback, not the fit's
    assert torch.equal(_bits(prm[:, WRITTEN]), _bits(own[:, WRITTEN]))
    he, mc = fit_prm[ms.HE_COLUMNS].view(3, 2), fit_prm[ms.MAXC_COLUMNS]
    assert torch.equal(_bits(he), _bits(he5)) and torch.equal(_bits(mc), _bits(mc5))
    assert bool(torch.isnan(he).any()) == (members == 0)
    want = ms.macenko_transform_stream(x, he, mc, scale=scale)
    assert torch.equal(out.isnan(), want.isnan())
    assert torch.equal(torch.nan_to_num(out), torch.nan_to_num(want))


def _launches(call):
    before = profiling.counters()
    result = call()
    torch.cuda.synchronize()
    after = profiling.counters()
    return result, {k: v - before.get(k, 0) for k, v in after.items()
                    if v != before.get(k, 0) and k.startswith(("launch.", "fit.", "keyfield."))}


@pytest.mark.cuda
def test_the_training_forward_is_one_launch():
    """The batch-mode forward on 128x3x256^2 float32: one cluster launch and
    one ``fit.fused``; its state is a fit of the first tile within 2e-5 of
    B5's; its output equals B4 on that state then ``/ 255.0``, bit for bit.
    On 256 float32 rows and 200 uint8 rows of 224^2 (two waves of one-block
    clusters) the forward keeps B5 and B4."""
    dev = _card()
    forward = StainNormalizerTransform("macenko", mode="batch", device=dev)
    batch = _tiles(TRAIN, 31, torch.float32, dev)
    forward(batch)
    out, counted = _launches(lambda: forward(batch))
    assert counted == {"launch.B4.cluster": 1, "fit.fused": 1, "keyfield.B4": 1}
    norm = forward.normalizer
    he5, mc5 = ms.macenko_fit_stream(batch[:1])
    assert float((norm._stain_matrix - he5).abs().max()) <= 2e-5
    unscaled = Macenko(device=dev).load_state(norm.state).transform(batch)
    assert torch.equal(out, unscaled / 255.0)

    for shape, dtype in (((256, 256, 256), torch.float32), ((200, 224, 224), torch.uint8)):
        x = _tiles(shape, 32, dtype, dev)
        assert not mk.fuses_fit(x)
        _, counted = _launches(lambda x=x: forward(x))
        assert counted.get("fit.fused", 0) == 0
        assert {k: v for k, v in counted.items() if k.startswith("launch.")} == {
            "launch.B5.cluster": 1, "launch.B4.cluster": 1}


@pytest.mark.cuda
def test_a_stale_fused_state_fails_the_training_check(monkeypatch):
    """The training cell's own run, its window shortened: as it is, correct;
    with the fused launch running but the normalizer's state left as the
    set-up's last forward fitted it, not correct. The check still catches
    a stale fit on the fused route."""
    from portbench import harness, spec

    dev = _card()
    cell = spec.cell("macenko-batchmode-f32-256.train")
    seed = 2**32 + 27
    fused = mk.macenko_fit_transform
    calls = []

    def count(*args, **kwargs):
        calls.append(1)
        return fused(*args, **kwargs)

    monkeypatch.setattr(mk, "macenko_fit_transform", count)
    good = harness.run_cell(cell, seed, 1.0, False, dev, time.perf_counter())
    assert good["correct"], good["checks"]
    assert calls

    def stale(job):
        norm = job.system.normalizer
        held = (norm._stain_matrix, norm._target_max_conc)

        def fused_stale(batch, idx, **kwargs):
            out, _, _ = fused(batch, idx, **kwargs)
            return out, *held

        monkeypatch.setattr(mk, "macenko_fit_transform", fused_stale)

    bad = harness.run_cell(cell, seed, 1.0, False, dev, time.perf_counter(), stale)
    assert not bad["correct"]
    failed = {k for k, c in bad["checks"].items() if c["value"] > c["limit"]}
    assert {"he_gap", "maxc_gap"} <= failed, bad["checks"]


# The transform-only cluster kernels' SASS instruction counts (cuobjdump
# -sass, CUDA 12.9 on an H100 machine), by a fragment of each kernel's
# mangled name (``Lb0E``: Fused false): the fused mode is a template
# parameter, so each must compile to the instructions it has without it
# (counted since the first pass of the angle selections counts two digits).
SASS_NVCC = "V12.9"
TRANSFORM_ONLY_SASS = {"14cluster_kernelIhLb0E": 17_472, "14cluster_kernelIfLb0E": 43_200}


@pytest.mark.cuda
def test_transform_only_kernels_compile_as_before():
    _card()
    nvcc = kernels.nvcc_path()
    version = subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                             check=True).stdout
    if SASS_NVCC not in version:
        pytest.skip(f"the counts are nvcc {SASS_NVCC}'s; this card's is {version!r}")
    spec_ = importlib.util.spec_from_file_location("probe_sass", ROOT / "tools/probe_sass.py")
    probe = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(probe)
    cuobjdump = str(Path(nvcc).parent / "cuobjdump")
    mixes = probe.sass_mix(cuobjdump, kernels.library("macenko_stream")._name)
    got = {frag: [m["all"] for fn, m in mixes.items() if frag in fn]
           for frag in TRANSFORM_ONLY_SASS}
    assert got == {frag: [count] for frag, count in TRANSFORM_ONLY_SASS.items()}
    fused = [fn for fn in mixes if "14cluster_kernel" in fn and "Lb1E" in fn]
    assert len(fused) == 2
