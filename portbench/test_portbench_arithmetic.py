"""The generator from the seed, and the metric arithmetic: bytes and operations
from shapes, the rate over the whole window, and the reading of a profiler
trace."""

from __future__ import annotations

import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType

from portbench import counts, gen, spec, trace
from portbench.records import Run, Window

ROOT = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")


def _tiles(seed, n=3, tile=(3, 16, 16), dtype="uint8"):
    stream = gen.seed_streams(seed, 1)[0]
    return gen.tiles(n, tile, dtype, (0.85, 1.15), gen.torch_generator(stream, CPU))


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5, 2**40 + 3, -9])
def test_tiles_repeat_from_the_seed(seed):
    a, b = _tiles(seed), _tiles(seed)
    assert a.dtype == torch.uint8 and a.shape == (3, 3, 16, 16)
    assert torch.equal(a, b)
    assert not torch.equal(a, _tiles(seed + 1))


def test_float_tiles_are_the_uint8_tiles_over_255():
    u8 = _tiles(11, dtype="uint8")
    f32 = _tiles(11, dtype="float32")
    assert f32.dtype == torch.float32 and float(f32.max()) <= 1.0
    assert torch.equal(f32, u8.to(torch.float32) / 255.0)


def test_tiles_are_stained_and_differ_by_tile():
    t = _tiles(3, n=8, tile=(3, 32, 32)).float()
    od = -torch.log((t + 1) / 240)
    assert float(od.min(dim=1).values.mean()) > 0.15  # most pixels pass beta
    per_tile = od.mean(dim=(1, 2, 3))
    assert float(per_tile.std()) > 0.01  # a stain scale per tile


def test_sample_is_distinct_and_sorted():
    s = gen.sample(100, 10, gen.seed_streams(2, 1)[0])
    assert len(set(s.tolist())) == 10 and np.all(np.diff(s) > 0)
    assert gen.sample(5, 10, gen.seed_streams(2, 1)[0]).tolist() == [0, 1, 2, 3, 4]


def _config(name):
    return json.loads((ROOT / "portbench/configs" / f"{name}.json").read_text())


def test_cost_of_the_store_call():
    ref = spec.load_module("reference", "macenko")
    cost = counts.call_cost(_config("macenko-u8-256"), 128, ref.OPS_PER_PIXEL)
    assert cost.bytes == 2 * 128 * 3 * 256 * 256 == 50_331_648
    assert cost.ops == 128 * 256 * 256 * 69
    assert cost.bound == "bytes"
    assert cost.least_s == pytest.approx(50_331_648 / 3.35e12)
    assert cost.least_s * 1e3 == pytest.approx(0.0150, abs=1e-4)


def test_cost_of_the_batch_mode_forward_counts_its_batch_once():
    """The fit on the batch's first image reads no byte more than the
    transform of the batch; its operations are those of one image."""
    ref = spec.load_module("reference", "macenko")
    config = _config("macenko-batchmode-f32-256")
    cost = counts.call_cost(config, 128, ref.OPS_PER_PIXEL)
    assert cost.bytes == 2 * 128 * 3 * 256 * 256 * 4 == 201_326_592
    assert cost.ops == 128 * 256 * 256 * (69 + 3 + 3) + 256 * 256 * 52
    assert cost.bound == "bytes" and cost.least_s * 1e3 == pytest.approx(0.0601, abs=1e-4)
    pooled = counts.call_cost({**config, "fit_index": None}, 128, ref.OPS_PER_PIXEL)
    assert pooled.bytes == cost.bytes and pooled.ops == 128 * 256 * 256 * (69 + 52 + 3 + 3)


def test_cost_bound_by_operations():
    cost = counts.Cost(bytes=10, ops=10**12)
    assert cost.bound == "operations" and cost.least_s == pytest.approx(1e12 / 67e12)


def _run(window, trace_record=None, cost=counts.Cost(335_000_000, 0), setup_s=3.0):
    return Run(cell=None, setup_s=setup_s, window=window, trace=trace_record, cost=cost)


def test_rate_is_all_pixels_over_the_whole_window():
    mpix = spec.load_module("metrics", "mpix_per_s")
    w = Window(calls=1000, failed=0, seconds=10.0, pixels=1000 * 128 * 65536,
               host_call_s=np.ones(3))
    assert mpix.read(_run(w)) == pytest.approx(1000 * 128 * 65536 / 10.0 / 1e6)
    assert mpix.read(_run(Window(0, 0, 0.0, 0, np.ones(1)))) is None


def test_setup_metric():
    assert spec.load_module("metrics", "setup_s").read(_run(None, setup_s=8.5)) == 8.5


class _Event:
    """A profiler event as the trace reader sees it; ``kind`` is for the
    tests' own filtering."""

    def __init__(self, kind, name, start, end, device=DeviceType.CPU, annotation=False):
        self.kind, self._n, self._s, self._e = kind, name, start, end
        self._d, self._a = device, annotation

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def device_type(self):
        return self._d

    def is_user_annotation(self):
        return self._a


def _events():
    cuda = DeviceType.CUDA
    return [
        _Event("user_annotation", "stretch", 0, 1000, annotation=True),
        _Event("user_annotation", "api.transform", 0, 100, annotation=True),
        _Event("user_annotation", "loop.wait", 100, 600, annotation=True),
        _Event("user_annotation", "api.transform", 600, 700, annotation=True),
        _Event("gpu_user_annotation", "api.transform", 50, 400, device=cuda, annotation=True),
        _Event("kernel", "B4", 50, 400, device=cuda),
        _Event("gpu_memset", "Memset (Device)", 400, 410, device=cuda),
        _Event("kernel", "B4", 650, 950, device=cuda),
        _Event("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 620, 640, device=cuda),
        _Event("cpu_op", "aten::empty", 10, 20),
    ]


def test_trace_reads_kernels_copies_and_idle_gaps():
    rec = trace.parse(_events(), calls=2)
    assert rec.stretch_s == pytest.approx(1000e-9)
    assert rec.kernel_s == pytest.approx(650e-9)
    assert rec.busy_s == pytest.approx((350 + 10 + 20 + 300) * 1e-9)
    assert rec.device_ops[0] == ["B4", pytest.approx(650e-9)]
    idle = dict(rec.idle_gaps)
    # 0-50 under api.transform, 410-620 under loop.wait, 640-650 under the
    # second api.transform, 950-1000 under none of the benchmark's spans.
    assert idle["api.transform"] == pytest.approx(60e-9)
    assert idle["loop.wait"] == pytest.approx(210e-9)
    assert idle["host"] == pytest.approx(50e-9)


def test_per_layer_metrics_from_a_trace():
    rec = trace.parse(_events(), calls=2)
    w = Window(10, 0, 1.0, 10, np.array([1e-4, 2e-4, 3e-4]))
    run = _run(w, rec, cost=counts.Cost(bytes=335, ops=0))  # least 1e-10 s a call
    roof = spec.load_module("metrics", "roofline_share").read(run)
    assert roof == pytest.approx(100 * 1e-10 / (650e-9 / 2))
    idle = spec.load_module("metrics", "idle_share").read(run)
    assert idle == pytest.approx(100 * (1 - 680 / 1000))
    assert spec.load_module("metrics", "api_host_ms").read(run) == pytest.approx(0.2)


def test_a_trace_without_kernels_gives_no_per_layer_metric():
    device = ("kernel", "gpu_memcpy", "gpu_memset")
    events = [e for e in _events() if e.kind not in device]
    rec = trace.parse(events, calls=2)
    run = _run(Window(10, 0, 1.0, 10, np.array([1e-4])), rec)
    for name in ("roofline_share", "idle_share"):
        assert spec.load_module("metrics", name).read(run) is None
    assert spec.load_module("metrics", "api_host_ms").read(_run(run.window, None)) is None


def test_stretch_keeps_retrying_and_then_has_no_record():
    """A stretch that records no kernel opens again, and at the end has
    no record, so the traced run fails."""
    s = trace.Stretch(0.0, 0.0, sync=lambda: None)
    s._close = lambda calls, elapsed: setattr(s, "state", "done")  # no profiler here
    s.state = "on"
    s.first, s.opened = 0, 0.0
    s.tick(1.0, calls=trace.MIN_CALLS)
    assert s.record is None and s.state == "done"


def test_untraced_spans_are_free():
    t = trace.NoTrace()
    with t.span("api.transform"):
        pass
    assert t.record is None and not t.in_stretch()


def test_closed_loop_keeps_the_window_calls_outputs():
    cell = SimpleNamespace(traffic={"batch": 2, "pool_batches": 3, "in_flight": 2, "check_batches": 1,
                                    "check_rows": 3},
                           config={"tile": [3, 8, 8], "dtype": "uint8", "stain_scale": [1, 1]})
    driver = spec.load_module("drivers", "closed_loop")
    calls = []
    job = SimpleNamespace(device=CPU, fits_per_batch=False, span="api.transform",
                          config=cell.config, sync=lambda: None, events=lambda n: [],
                          call=lambda x: calls.append(x) or x + 1)
    st = driver.prepare(job, cell, {"inputs": gen.seed_streams(1, 1)[0]}, 1.0)
    driver.warm(job, st)
    assert len(calls) == 3 and st.last_call == [-1, -1, -1]
    w = driver.run(job, st, 0.05, trace.NoTrace())
    assert w.calls >= 3 and w.pixels == w.calls * 2 * 64 and len(w.host_call_s) == w.calls
    assert all(c >= 0 for c in st.last_call)
    assert all(torch.equal(st.last[s], st.pool[s] + 1) for s in range(3))
