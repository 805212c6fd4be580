"""The port's auxiliaries against their ``stainx_tpu`` counterparts on the
CPU: ``utils.ChannelFormatConverter`` (tensors and arrays), ``__version__``,
``ops.percentile.masked_nearest_rank_percentile`` and ``percentile_all``
(bit for bit, also on rows with −inf, NaN and no valid element), and
``profiling`` (``time_fn``, ``trace``, ``annotate``). Also: no module of the
port, ``chip_smoke.py`` or the port's example imports JAX, ``stainx_tpu`` or
``triton``.
"""

import json
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stainx_tpu
import stainx_tpu_torch
from stainx_tpu.ops import percentile as jax_pct
from stainx_tpu.utils import ChannelFormatConverter as JaxConverter
from stainx_tpu_torch import profiling
from stainx_tpu_torch.ops import percentile as pct
from stainx_tpu_torch.utils import ChannelFormatConverter

ROOT = Path(__file__).resolve().parent.parent


# ------------------------------------------------------- ChannelFormatConverter
def _images(ndim: int, channels_first: bool) -> np.ndarray:
    shape = {(3, True): (3, 5, 7), (3, False): (5, 7, 3),
             (4, True): (2, 3, 5, 7), (4, False): (2, 5, 7, 3)}[ndim, channels_first]
    return np.random.default_rng(ndim).integers(0, 256, shape, dtype=np.uint8)


@pytest.mark.parametrize("axis", [1, -3, -1, 3])
@pytest.mark.parametrize("ndim", [3, 4])
@pytest.mark.parametrize("as_tensor", [False, True], ids=["array", "tensor"])
def test_converter_matches_jax(axis, ndim, as_tensor):
    conv, want_conv = ChannelFormatConverter(axis), JaxConverter(axis)
    assert (conv.is_channels_first, conv.permute_to_hwc) == (
        want_conv.is_channels_first, want_conv.permute_to_hwc)
    x = _images(ndim, conv.is_channels_first)
    given = torch.as_tensor(x) if as_tensor else x

    got = conv.prepare_for_normalizer(given)
    want = np.asarray(want_conv.prepare_for_normalizer(x))
    assert torch.is_tensor(got) is as_tensor  # a tensor stays a tensor, an array an array
    got_np = got.numpy() if as_tensor else np.asarray(got)
    assert got_np.shape == want.shape and got_np.dtype == want.dtype
    np.testing.assert_array_equal(got_np, want)
    if conv.is_channels_first:
        assert got is given  # channels-first passes through unchanged

    squeeze = ndim == 4
    single = x[:1] if squeeze else x
    got_hwc = conv.to_hwc(torch.as_tensor(single) if as_tensor else single, squeeze_batch=squeeze)
    want_hwc = want_conv.to_hwc(single, squeeze_batch=squeeze)
    assert isinstance(got_hwc, np.ndarray)
    assert got_hwc.shape[-1] == 3
    np.testing.assert_array_equal(got_hwc, want_hwc)


@pytest.mark.parametrize("axis", [0, 2, -2, 4])
def test_converter_rejects_axis_as_jax(axis):
    with pytest.raises(ValueError) as got:
        ChannelFormatConverter(axis)
    with pytest.raises(ValueError) as want:
        JaxConverter(axis)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("shape", [(5, 3), (1, 2, 5, 7, 3)])
@pytest.mark.parametrize("as_tensor", [False, True], ids=["array", "tensor"])
def test_converter_rejects_rank_as_jax(shape, as_tensor):
    x = np.zeros(shape, np.uint8)
    with pytest.raises(ValueError, match="3D or 4D") as got:
        ChannelFormatConverter(-1).prepare_for_normalizer(torch.as_tensor(x) if as_tensor else x)
    with pytest.raises(ValueError) as want:
        JaxConverter(-1).prepare_for_normalizer(x)
    assert str(got.value) == str(want.value)


def test_converter_to_hwc_bfloat16_tensor():
    x = torch.rand(3, 4, 5).to(torch.bfloat16)
    got = ChannelFormatConverter(1).to_hwc(x)
    assert got.dtype == np.float32 and got.shape == (4, 5, 3)
    np.testing.assert_array_equal(got, x.float().permute(1, 2, 0).numpy())


# ----------------------------------------------------------------- __version__
def test_version_matches_jax():
    assert stainx_tpu_torch.__version__ == stainx_tpu.__version__
    assert stainx_tpu_torch.__version__ != "0.0.0+unknown"
    assert "__version__" in stainx_tpu_torch.__all__ and "profiling" in stainx_tpu_torch.__all__


# ------------------------------------------------------------------ percentiles
def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.int32)


def _masked_fields():
    """(name, x, mask, cnt, q): the fields of tests/test_percentile_unit.py
    and tests/test_macenko.py, and rows with −inf, NaN and no valid entry."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 500)).astype(np.float32)
    m = rng.random((2, 500)) < 0.7
    yield "unit_q99", x, m, m.sum(1).astype(np.int32), 99
    for q in (1, 50, 99):
        rng = np.random.default_rng(5)
        x = rng.standard_normal((3, 1000)).astype(np.float32)
        m = rng.random((3, 1000)) < 0.7
        yield f"macenko_q{q}", x, m, m.sum(1), q
    rng = np.random.default_rng(21)
    x = rng.standard_normal((5, 300)).astype(np.float32)
    m = rng.random((5, 300)) < 0.8
    x[0, :7] = -np.inf
    x[1, 3:40] = np.nan
    x[2, ::3] = np.inf
    m[3] = False  # a row with no valid element: +inf
    x[4, :] = np.nan  # a row of only NaN: +inf
    # cnt counts the mask, as callers pass it: invalid values are left out
    # of the selection, and a rank past the valid count takes the largest.
    for q in (1, 50, 99):
        yield f"nonfinite_q{q}", x, m, m.sum(1), q
    yield "nonfinite_mask_none", x, None, np.full(5, 300), 50


@pytest.mark.parametrize("field", list(_masked_fields()), ids=lambda f: f[0])
def test_masked_percentile_matches_jax(field):
    _, x, m, cnt, q = field
    got = pct.masked_nearest_rank_percentile(
        torch.as_tensor(x), None if m is None else torch.as_tensor(m), torch.as_tensor(cnt), q)
    want = jax_pct.masked_nearest_rank_percentile(
        jnp.asarray(x), None if m is None else jnp.asarray(m), jnp.asarray(cnt), q)
    assert got.dtype == torch.float32 and tuple(got.shape) == np.asarray(want).shape
    np.testing.assert_array_equal(_bits(got), _bits(want))


def _all_fields():
    yield "arange_q99", np.arange(101, dtype=np.float32)[None], 99
    yield "macenko_q99", np.random.default_rng(6).standard_normal((4, 513)).astype(np.float32), 99
    x = np.random.default_rng(22).standard_normal((2, 3, 257)).astype(np.float32)
    x[0, 0, :5] = -np.inf
    x[0, 1, :] = np.nan
    x[1, 2, ::2] = np.inf
    for q in (0, 1, 50, 99, 100):
        yield f"nonfinite_3d_q{q}", x, q


@pytest.mark.parametrize("field", list(_all_fields()), ids=lambda f: f[0])
def test_percentile_all_matches_jax(field):
    _, x, q = field
    got = pct.percentile_all(torch.as_tensor(x), q)
    want = jax_pct.percentile_all(jnp.asarray(x), q)
    assert tuple(got.shape) == np.asarray(want).shape == x.shape[:-1]
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("route", ["rows", "stream"])
def test_card_route_on_the_plain_versions(monkeypatch, route):
    """What the wrappers run on a CUDA tensor (invalid entries made +inf
    sentinels, then B3 or B6 by the staged route's threshold), here on
    those kernels' plain versions: the same bits as the CPU route."""
    monkeypatch.setattr(pct, "SELECT_STREAM_MIN_ELEMS", 1 if route == "stream" else 1 << 40)
    assert pct.select_route(5, 300) == route
    for _, x, m, cnt, q in _masked_fields():
        xt, mt = torch.as_tensor(x), None if m is None else torch.as_tensor(m)
        rank = pct.nearest_rank_index(q, torch.as_tensor(cnt))
        got = pct._select_on_card(xt, rank, mt)
        np.testing.assert_array_equal(_bits(got), _bits(pct.kth_smallest(xt, rank, mt)))


def test_percentile_wrappers_reject_fractional_q():
    with pytest.raises(ValueError, match="integer percentage"):
        pct.masked_nearest_rank_percentile(torch.zeros(1, 4), None, torch.tensor([4]), 2.5)


# ------------------------------------------------------------------- profiling
def test_time_fn_on_cpu_tensors():
    x = torch.rand(128, 128)
    seconds = profiling.time_fn(lambda v: torch.tanh(v @ v / 128), x, iters=5)
    assert isinstance(seconds, float) and seconds > 0


def test_trace_writes_a_trace_with_nested_annotations(tmp_path):
    log_dir = tmp_path / "trace"
    x = torch.rand(64, 64)
    with profiling.trace(str(log_dir)) as yielded:
        with profiling.annotate("stainx_outer"):
            with profiling.annotate("stainx_inner"):
                (x @ x).sum()
    assert yielded == str(log_dir)
    files = list(log_dir.glob("*.pt.trace.json"))
    assert len(files) == 1 and files[0].stat().st_size > 0
    events = json.loads(files[0].read_text())["traceEvents"]
    spans = {e["name"]: e for e in events if e.get("name") in ("stainx_outer", "stainx_inner")}
    assert set(spans) == {"stainx_outer", "stainx_inner"}
    outer, inner = spans["stainx_outer"], spans["stainx_inner"]
    assert outer["ts"] <= inner["ts"] and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]


# ------------------------------------------------------------- no JAX in the port
_FORBIDDEN = re.compile(r"^\s*(?:import|from)\s+(?:jax|stainx_tpu|triton)(?:\.|\s|$)", re.M)


def test_port_imports_no_jax_stainx_tpu_or_triton():
    sources = sorted((ROOT / "stainx_tpu_torch").rglob("*.py"))
    sources += sorted((ROOT / "benchmarks_torch").glob("*.py"))
    sources += [ROOT / "chip_smoke.py", ROOT / "bench_torch.py",
                ROOT / "examples" / "torch_wsi_ingest_example.py"]
    offenders = [f"{p.relative_to(ROOT)}: {m.group(0).strip()}"
                 for p in sources for m in _FORBIDDEN.finditer(p.read_text())]
    assert len(sources) > 20 and not offenders, offenders
