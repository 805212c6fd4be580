"""``normalize_to_0_1``'s ÷255 folded into the float32 Macenko transform
kernels' store.

On the CPU: which calls fold (float32 input on CUDA with
``normalize_to_0_1``; a CPU tensor that reports itself as a CUDA tensor
stands in for the card), the scale each wrapper is given, the
``finalize.folded`` counter and the ``stainx.finalize`` span, and each
wrapper's plain version given a scale. On the card (marker ``cuda``): every
float32 transform route's folded store against the unscaled kernel output
divided by 255 as PyTorch divides on the card, bit for bit; the public
forward at the batch-mode training shape; the uint8 kernels as compiled
before the float32 store took a scale.

Imports no JAX, so that on a card's machine it runs as
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_fold_range.py``.
"""

from __future__ import annotations

import ctypes
import importlib.util
import re
import subprocess
from pathlib import Path

import pytest
import torch

from stainx_tpu_torch import Macenko, StainNormalizerTransform, kernels, profiling
from stainx_tpu_torch.kernels import macenko_fused as mf
from stainx_tpu_torch.kernels import macenko_stream as ms
from stainx_tpu_torch.ops import macenko as mk
from stainx_tpu_torch.testing import synthetic_he_batch

ROOT = Path(__file__).resolve().parent.parent
RECIPROCAL = torch.tensor(1.0, dtype=torch.float32) / torch.tensor(255.0, dtype=torch.float32)


class _CudaTyped(torch.Tensor):
    """A CPU tensor that reports itself as a CUDA tensor: the fold
    decision's input without a card. The kernels it would reach are
    replaced by recorders that run their plain versions."""

    @property
    def is_cuda(self):
        return True


def _tiles(n: int, side: int, seed: int, dtype=torch.float32) -> torch.Tensor:
    x = torch.as_tensor(synthetic_he_batch(n, side, side, seed=seed, he_scale=1.1))
    return x if dtype == torch.uint8 else (x.to(torch.float32) / 255.0).to(dtype)


def _off():
    """A span with no profiler running: the next one seen with a profiler
    opens a new session."""
    with profiling.annotate("stainx.test.off"):
        pass


@pytest.fixture
def recorded(monkeypatch):
    """The scale each call hands ``ops.macenko_transform`` and each kernel
    wrapper, the wrappers running their plain versions."""
    seen = {"ops": [], "B1": [], "B4": []}
    ops_transform = mk.macenko_transform

    def ops_spy(*args, **kwargs):
        seen["ops"].append(kwargs.get("scale", 1.0))
        return ops_transform(*args, **kwargs)

    def wrapper_spy(name, plain):
        def wrapped(images, stain_matrix, target_max_conc, *args, scale=1.0, **kwargs):
            seen[name].append(scale)
            return plain(images.as_subclass(torch.Tensor), stain_matrix, target_max_conc, scale)
        return wrapped

    monkeypatch.setattr(mk, "macenko_transform", ops_spy)
    monkeypatch.setattr(mf, "macenko_transform_mega",
                        wrapper_spy("B1", mf.macenko_transform_mega_plain))
    monkeypatch.setattr(ms, "macenko_transform_stream",
                        wrapper_spy("B4", ms.macenko_transform_stream_plain))
    return seen


# (dtype, a CUDA-typed input, normalize_to_0_1, folds)
DECISIONS = [
    (torch.float32, True, True, True),
    (torch.float32, True, False, False),
    (torch.float32, False, True, False),
    (torch.uint8, True, True, False),
    (torch.bfloat16, True, True, False),
    (torch.float16, True, True, False),
    (torch.float64, True, True, False),
]


@pytest.mark.parametrize("route", ["mega", "stream"])
@pytest.mark.parametrize("dtype,cuda_typed,unit,folds", DECISIONS,
                         ids=lambda v: str(v).replace("torch.", ""))
def test_fold_decision(monkeypatch, recorded, route, dtype, cuda_typed, unit, folds):
    """A float32 call on CUDA with ``normalize_to_0_1`` hands the kernel
    wrapper ``UNIT_SCALE``, counts ``finalize.folded`` once and opens no
    ``stainx.finalize``; every other call hands 1 (or, for the staged
    dtypes, reaches no wrapper), counts nothing, and divides in
    ``stainx.finalize`` where ``normalize_to_0_1`` asks for it."""
    if route == "stream":
        monkeypatch.setattr(mk, "STREAM_MIN_ELEMS", 32 * 32)
        monkeypatch.setattr(mk, "STREAM_MIN_ELEMS_F32", 32 * 32)
    normalizer = Macenko(device="cpu", normalize_to_0_1=unit).fit(_tiles(1, 32, 1, dtype))
    x = _tiles(4, 32, 2, dtype)
    if cuda_typed:
        x = x.as_subclass(_CudaTyped)
    before = profiling.counters("finalize.").get("finalize.folded", 0)
    _off()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        out = normalizer.transform(x)
    spans = [s.name for s in profiling.session().spans]

    scale = mk.UNIT_SCALE if folds else 1.0
    assert recorded["ops"] == [scale]
    wrapper = "B1" if route == "mega" else "B4"
    kernel_dtype = dtype in (torch.uint8, torch.float32)
    assert recorded[wrapper] == ([scale] if kernel_dtype else [])
    assert recorded["B4" if wrapper == "B1" else "B1"] == []
    assert profiling.counters("finalize.").get("finalize.folded", 0) - before == int(folds)
    assert ("stainx.finalize" in spans) == (unit and not folds)
    assert spans[0] == "stainx.transform"
    want_dtype = torch.float32 if unit and dtype == torch.uint8 else dtype
    assert out.dtype == want_dtype and out.shape == x.shape


def test_folded_output_is_the_unscaled_output_times_the_reciprocal(recorded):
    """Through the public call, a folded transform's output is the unscaled
    transform's output times float32(1/255), bit for bit."""
    ref, x = _tiles(1, 32, 3), _tiles(3, 32, 4)
    folded = Macenko(device="cpu", normalize_to_0_1=True).fit(ref).transform(
        x.as_subclass(_CudaTyped))
    unscaled = Macenko(device="cpu").fit(ref).transform(x.as_subclass(_CudaTyped))
    assert torch.equal(folded.as_subclass(torch.Tensor),
                       unscaled.as_subclass(torch.Tensor) * RECIPROCAL)


def test_unit_scale_is_the_float32_reciprocal():
    """The ÷255 as PyTorch's CUDA division by a Python scalar computes it:
    ``opmath_t(1.0) / 255.0`` in float32."""
    assert mk.UNIT_SCALE == RECIPROCAL.item()
    assert torch.tensor(mk.UNIT_SCALE, dtype=torch.float32).view(torch.int32).item() == 0x3B808081


@pytest.mark.parametrize("plain", [mf.macenko_transform_mega_plain,
                                   ms.macenko_transform_stream_plain])
def test_plain_versions_scale_their_float32_store(plain):
    """Each wrapper's plain version, given the scale, equals its unscaled
    output times float32(1/255) bit for bit; 1 leaves the output as it was;
    uint8 output takes no other scale."""
    x = _tiles(3, 40, 5)
    he, mc = mf.macenko_fit_mega_plain(_tiles(1, 40, 6))
    unscaled = plain(x, he, mc)
    assert torch.equal(plain(x, he, mc, mk.UNIT_SCALE), unscaled * RECIPROCAL)
    assert torch.equal(plain(x, he, mc, 1.0), unscaled)
    with pytest.raises(ValueError, match="float32 output only"):
        plain(_tiles(1, 40, 7, torch.uint8), he, mc, mk.UNIT_SCALE)


@pytest.mark.parametrize("wrapper", [mf.macenko_transform_mega, ms.macenko_transform_stream])
def test_wrappers_pass_the_scale_to_their_plain_versions(wrapper):
    x = _tiles(2, 40, 8)
    he, mc = mf.macenko_fit_mega_plain(_tiles(1, 40, 9))
    assert torch.equal(wrapper(x, he, mc, scale=mk.UNIT_SCALE), wrapper(x, he, mc) * RECIPROCAL)
    with pytest.raises(ValueError, match="float32 output only"):
        wrapper(_tiles(1, 40, 10, torch.uint8), he, mc, scale=mk.UNIT_SCALE)


def test_the_staged_route_takes_no_scale():
    he, mc = mf.macenko_fit_mega_plain(_tiles(1, 32, 11))
    with pytest.raises(ValueError, match="float32 output only"):
        mk.macenko_transform(_tiles(1, 32, 12, torch.bfloat16), he, mc, scale=mk.UNIT_SCALE)


def test_the_c_interfaces_take_the_scale_after_tmc(monkeypatch):
    """Each transform C entry point takes ``float out_scale`` right after
    ``tmc``, and its ctypes declaration a ``c_float`` there."""

    class Fn:
        pass

    class Lib:
        pass

    for name in ("stainx_cluster_run", "stainx_stream_run", "stainx_stream_fields",
                 "stainx_cluster_fit_transform", "stainx_cluster_occupancy",
                 "stainx_macenko_transform_mega", "stainx_macenko_fit_mega"):
        setattr(Lib, name, Fn())
    monkeypatch.setattr(kernels, "library", lambda stem: Lib)
    for module, source, entries in (
            (ms, "macenko_stream.cu", ("stainx_cluster_run", "stainx_stream_run")),
            (mf, "macenko_fused.cu", ("stainx_macenko_transform_mega",))):
        Lib._stainx_declared = False
        lib = module._lib()
        text = (kernels.CSRC / source).read_text()
        for entry in entries:
            params = [p.strip() for p in
                      re.search(rf"int {entry}\((.*?)\) \{{", text, re.S).group(1).split(",")]
            at = params.index("float out_scale")
            assert params[at - 1] == "const void* tmc"
            argtypes = getattr(lib, entry).argtypes
            assert len(argtypes) == len(params) and argtypes[at] is ctypes.c_float


# ------------------------------------------------------------------ card
def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the folded store runs in the CUDA kernels")
    return torch.device("cuda", 0)


# (label, wrapper, shape, keyword arguments): every float32 transform route
# and store of B1 and B4, the training shape among them.
ROUTES = [
    ("B1 resident 16x3x64^2", mf.macenko_transform_mega, (16, 64, 64), {}),
    ("B1 resident ragged 4x3x71x73", mf.macenko_transform_mega, (4, 71, 73), {}),
    ("B1 L2 body 4x3x128^2", mf.macenko_transform_mega, (4, 128, 128), {"body": "l2"}),
    ("B1 L2 body ragged 2x3x131x127", mf.macenko_transform_mega, (2, 131, 127), {"body": "l2"}),
    ("B4 cluster 128x3x256^2", ms.macenko_transform_stream, (128, 256, 256),
     {"force": "cluster"}),
    ("B4 cluster ragged 4x3x331^2", ms.macenko_transform_stream, (4, 331, 331),
     {"force": "cluster"}),
    ("B4 stream 128x3x256^2", ms.macenko_transform_stream, (128, 256, 256), {"force": "stream"}),
    ("B4 stream ragged 2x3x331^2", ms.macenko_transform_stream, (2, 331, 331),
     {"force": "stream"}),
]


def _batch(shape, seed: int, dev, dtype=torch.float32) -> torch.Tensor:
    n, h, w = shape
    x = torch.as_tensor(synthetic_he_batch(n, h, w, seed=seed, he_scale=1.1)).to(dev)
    return x if dtype == torch.uint8 else x.to(torch.float32) / 255.0


@pytest.mark.cuda
@pytest.mark.parametrize("label,wrapper,shape,kwargs", ROUTES, ids=[r[0] for r in ROUTES])
def test_folded_store_is_the_division_on_the_card(label, wrapper, shape, kwargs):
    """The folded store's output equals the unscaled kernel output divided
    by 255 on the card (the eager ÷255 it replaces), bit for bit; uint8 on
    the same route takes no scale and repeats its bits."""
    dev = _card()
    he, mc = mf.macenko_fit_mega_plain(_batch((1, 64, 64), 1, torch.device("cpu")))
    x = _batch(shape, 2, dev)
    unscaled = wrapper(x, he, mc, **kwargs)
    folded = wrapper(x, he, mc, scale=mk.UNIT_SCALE, **kwargs)
    torch.cuda.synchronize(dev)
    assert folded.dtype == torch.float32 and folded.shape == x.shape
    assert torch.equal(folded, unscaled / 255.0), label
    assert torch.equal(folded, unscaled * RECIPROCAL.to(dev)), label
    u8 = _batch(shape, 3, dev, torch.uint8)
    assert torch.equal(wrapper(u8, he, mc, **kwargs), wrapper(u8, he, mc, **kwargs))
    with pytest.raises(ValueError, match="float32 output only"):
        wrapper(u8, he, mc, scale=mk.UNIT_SCALE, **kwargs)


@pytest.mark.cuda
def test_the_training_forward_folds_on_the_card():
    """The batch-mode forward on 128x3x256^2 float32 gives the bits of the
    two-step form (an unscaled transform on the forward's fit, then
    ``/ 255.0``), counts one ``finalize.folded`` a forward and opens no
    ``stainx.finalize``; a uint8 transform with ``normalize_to_0_1`` still
    divides eagerly."""
    dev = _card()
    batch = _batch((128, 256, 256), 4, dev)
    forward = StainNormalizerTransform("macenko", mode="batch", device=dev)
    before = profiling.counters("finalize.").get("finalize.folded", 0)
    out = forward(batch)
    two_step = Macenko(device=dev).load_state(forward.normalizer.state).transform(batch) / 255.0
    torch.cuda.synchronize(dev)
    assert torch.equal(out, two_step)
    assert profiling.counters("finalize.")["finalize.folded"] - before == 1
    _off()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        forward(batch)
        forward(batch)
    names = [s.name for s in profiling.session().spans]
    assert names.count("stainx.forward") == 2 and "stainx.finalize" not in names
    assert profiling.session().counts["finalize.folded"] == 2

    u8 = _batch((16, 256, 256), 5, dev, torch.uint8)
    n01 = Macenko(device=dev, normalize_to_0_1=True).fit(u8[:1])
    folded = profiling.counters("finalize.")["finalize.folded"]
    got = n01.transform(u8)
    assert profiling.counters("finalize.")["finalize.folded"] == folded
    assert torch.equal(got, Macenko(device=dev).fit(u8[:1]).transform(u8) / 255.0)


# The uint8 transform kernels' SASS instruction counts as nvcc compiled them
# before the float32 store took a scale (``cuobjdump -sass``, CUDA 12.9 on an
# H100 machine; the resident kernels' since their histogram copies were
# packed, one word a bin for both selections; the cluster kernel's since the
# first pass of its angle selections counts two digits), by a fragment of each
# kernel's mangled name (its length, so ``resident_kernel`` is not
# ``fit_resident_kernel``; ``Ih`` the uint8 instantiation, ``Lb0E`` the
# cluster kernel without the fused fit): the uint8 store takes no scale, so
# each must compile to the same instructions.
UINT8_SASS_NVCC = "V12.9"
UINT8_SASS = {
    "macenko_stream": {"14cluster_kernelIhLb0E": 17_472, "18stream_reconstructIhLi1E": 504,
                       "18stream_reconstructIhLi4E": 712},
    "macenko_fused": {"16transform_kernelIhLi1E": 5_088, "16transform_kernelIhLi4E": 5_880,
                      "15resident_kernelIhLi1ELb0E": 7_552, "15resident_kernelIhLi1ELb1E": 7_880,
                      "15resident_kernelIhLi4ELb0E": 7_112, "15resident_kernelIhLi4ELb1E": 7_416},
}


@pytest.mark.cuda
def test_uint8_kernels_compile_as_before_the_scale():
    _card()
    nvcc = kernels.nvcc_path()
    version = subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                             check=True).stdout
    if UINT8_SASS_NVCC not in version:
        pytest.skip(f"the counts are nvcc {UINT8_SASS_NVCC}'s; this card's is {version!r}")
    spec = importlib.util.spec_from_file_location("probe_sass", ROOT / "tools/probe_sass.py")
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    cuobjdump = str(Path(nvcc).parent / "cuobjdump")
    for stem, want in UINT8_SASS.items():
        mixes = probe.sass_mix(cuobjdump, kernels.library(stem)._name)
        got = {frag: [m["all"] for fn, m in mixes.items() if frag in fn] for frag in want}
        assert got == {frag: [count] for frag, count in want.items()}, stem
