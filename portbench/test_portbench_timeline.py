"""The readers of the program's call timeline (``portbench/timeline.py``
and ``idle_share.window``, ``call_device_ms``, ``wrapper_host_ms.window``)
on made-up timelines: their values, what they count per call, the calls
they take (the cell's root, after the last one under a profiler) and the
runs that give nothing to read."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from portbench import spec, timeline
from stainx_tpu_torch.profiling import Sampled

READERS = ("idle_share.window", "call_device_ms", "wrapper_host_ms.window")
CELLS = ["macenko-u8-256.store", "macenko-batchmode-f32-256.train", "reinhard-u8-512.store",
         "hm-u8-512.store-b256", "macenko-u8-96.store-b512"]
MS = 1_000_000  # ns


def _pair(seq, t0, launch=0.25, gap=0.01, wrapper=(0.02, 0.03), root="stainx.transform",
          profiled=False, hold=0.003):
    """A sampled pair from ``t0`` ms and the call after it, as the program
    records them: the pair's first call's launch end alone, the second
    call's launch interval of ``launch`` ms, the gap between them and the
    period (the gap and that interval), each with the events' ``hold`` ms;
    the third call no event. The pair's
    calls have a kernel span of 1 ms (their C calls' event records); the
    third one of ``wrapper[0]`` ms, then a nested plain kernel span of
    ``wrapper[1]`` ms, which counts inside it."""
    def one(i, start):
        long = i < 2
        ms = 1.0 if long else wrapper[0]
        spans = [("stainx.kernel.B4", int((start + 0.01) * MS), int((start + 0.01 + ms) * MS),
                  None)]
        if not long:
            spans += [("stainx.stats", int((start + 0.011) * MS), int((start + 0.012) * MS), 0),
                      ("stainx.kernel.B7b", int((start + 0.012) * MS),
                       int((start + 0.012 + wrapper[1]) * MS), 0)]
        launch_pair = {0: (None, (start + launch) * MS), 1: (start * MS, (start + launch) * MS)}
        return Sampled(seq + i, seq // 3, i, root, profiled, int(start * MS),
                       int((start + 0.05) * MS), spans,
                       int((start + 0.02) * MS) if long else None, launch_pair.get(i),
                       launch if i == 1 else None, hold_ms=hold if long else None)

    calls = [one(i, t0 + 0.1 * i) for i in range(3)]
    calls[1].gap_ms, calls[1].period_ms = gap, gap + launch
    return calls


def _run(call="transform"):
    return SimpleNamespace(cell=SimpleNamespace(config={"call": call}), trace=object())


def _read(monkeypatch, name, calls, run=None):
    monkeypatch.setattr(timeline, "_program_timeline", lambda: calls)
    return spec.load_module("metrics", name).read(run or _run())


def _window():
    """Two pairs under the profiler (the stretch), then two after it."""
    return (_pair(0, 0, profiled=True) + _pair(3, 1, profiled=True)
            + _pair(6, 2, launch=0.3, gap=0.005)
            + _pair(9, 3, launch=0.1, gap=0.015, wrapper=(0.03, 0.01)))


def test_idle_share_window_is_the_gaps_over_the_periods(monkeypatch):
    # (0.005 + 0.015 - 2 holds) / (0.305 + 0.115 - 4 holds): the stretch's
    # pairs are left out; a gap holds one event, a period two
    assert _read(monkeypatch, "idle_share.window", _window()) == pytest.approx(
        100 * 0.014 / 0.408)


def test_call_device_ms_is_the_mean_launch_interval(monkeypatch):
    # the second calls' intervals after the stretch, less their end event's
    # hold; a first call records none
    assert _read(monkeypatch, "call_device_ms", _window()) == pytest.approx(0.197)


def test_wrapper_host_ms_window_counts_outermost_kernel_spans_per_call(monkeypatch):
    """The calls with no launch event alone, 0.02 and 0.03 ms: the pairs'
    calls (their event records) and the nested B7b span count nothing."""
    found = _read(monkeypatch, "wrapper_host_ms.window", _window())
    assert found == pytest.approx(0.025, abs=1e-5)


def test_only_the_cells_own_root_after_the_last_profiled_call(monkeypatch):
    calls = _window()
    calls[6].profiled = True  # the first call after the stretch: its pair is cut
    forward = _pair(12, 4, launch=1.0, root="stainx.forward")
    assert _read(monkeypatch, "call_device_ms", calls + forward) == pytest.approx(0.197)
    assert _read(monkeypatch, "idle_share.window", calls + forward) == pytest.approx(
        100 * 0.012 / 0.109)
    train = _run("__call__")
    assert _read(monkeypatch, "call_device_ms", calls + forward, train) == pytest.approx(0.997)
    assert timeline.root_of({"call": "__call__"}) == "stainx.forward"


def test_calls_without_a_launch_interval(monkeypatch):
    """A CPU call, or one whose events had not completed: no interval, no
    gap; the host time of the call after the pair still counts."""
    calls = _pair(0, 0)
    for c in calls:
        c.launch = c.launch_ms = None
    calls[1].gap_ms = calls[1].period_ms = None
    assert _read(monkeypatch, "call_device_ms", calls) is None
    assert _read(monkeypatch, "idle_share.window", calls) is None
    found = _read(monkeypatch, "wrapper_host_ms.window", calls)
    assert found == pytest.approx(0.02, abs=1e-5)


@pytest.mark.parametrize("name", READERS)
def test_nothing_to_read(monkeypatch, name):
    assert _read(monkeypatch, name, None) is None  # a program with no timeline
    assert _read(monkeypatch, name, []) is None  # no sampled call
    stretch_only = _pair(0, 0, profiled=True) + _pair(3, 1, profiled=True)
    assert _read(monkeypatch, name, stretch_only) is None  # none after the stretch
    other_root = _pair(0, 0, root="stainx.forward")
    assert _read(monkeypatch, name, other_root) is None  # not the cell's call


def test_a_program_without_the_timeline_gives_nothing(monkeypatch):
    """The parent's port has ``profiling`` but no ``timeline``."""
    import stainx_tpu_torch.profiling as profiling

    monkeypatch.delattr(profiling, "timeline")
    assert timeline._program_timeline() is None


def test_the_timeline_is_read_once_a_run(monkeypatch):
    reads = []
    monkeypatch.setattr(timeline, "_program_timeline", lambda: reads.append(1) or _window())
    run = _run()
    for name in READERS:
        assert spec.load_module("metrics", name).read(run) is not None
    assert len(reads) == 1


def test_the_readers_are_entries_of_the_benchmark():
    per_layer = {m["name"]: m for m in spec.load_benchmark()["per_layer"]}
    layers = {"idle_share.window": "device", "call_device_ms": "kernels (kernels/*.py, csrc/*.cu)",
              "wrapper_host_ms.window": "wrappers (kernels/*.py)"}
    for name in READERS:
        assert per_layer[name] == {"name": name, "unit": "%" if name.startswith("idle") else "ms",
                                   "better": "lower", "source": "program_span",
                                   "layer": layers[name], "moves": "mpix_per_s",
                                   "workloads": CELLS}
        for cell in CELLS:
            assert name in {m["name"] for m in spec.cell(cell).per_layer}
