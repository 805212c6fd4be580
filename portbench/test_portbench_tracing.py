"""The readers of the program's own spans and counters (``portbench/
session.py`` and the metrics that read it) on made-up sessions: their
values, their per-call division and the runs that give nothing to read."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from portbench import session, spec
from stainx_tpu_torch.profiling import Session, Span

READERS = ("fit_device_ms", "wrapper_host_ms", "launches_per_call")
MS = 1_000_000  # ns


def _span(name, parent, start_ms, end_ms, device_ms=None):
    return Span(name, parent, 0, {}, int(start_ms * MS), int(end_ms * MS), device_ms)


def _forward(base: int, t0: float, fit_dev: float, kernel_ms=(0.01, 0.02)):
    """One batch-mode forward's spans: forward, fit, B5, transform, B4,
    finalize (parents by index, ``base`` the forward's own index)."""
    return [
        _span("stainx.forward", None, t0, t0 + 0.2),
        _span("stainx.fit", base, t0 + 0.01, t0 + 0.05, fit_dev),
        _span("stainx.kernel.B5", base + 1, t0 + 0.02, t0 + 0.02 + kernel_ms[0]),
        _span("stainx.transform", base, t0 + 0.06, t0 + 0.15, 0.6),
        _span("stainx.kernel.B4", base + 3, t0 + 0.07, t0 + 0.07 + kernel_ms[1]),
        _span("stainx.finalize", base, t0 + 0.16, t0 + 0.18, 0.07),
    ]


def _session(spans, counts=None):
    return Session(spans, counts or {})


def _read(monkeypatch, name, sess, traced=True):
    monkeypatch.setattr(session, "_program_session", lambda: sess)
    run = SimpleNamespace(trace=object() if traced else None)
    return spec.load_module("metrics", name).read(run)


def _two_forwards():
    return _session(_forward(0, 0.0, 0.05) + _forward(6, 1.0, 0.07, (0.03, 0.04)),
                    {"launch.B5.cluster": 2, "launch.B4.cluster": 2, "route.staged": 5,
                     "occupancy.query": 1})


def test_fit_device_ms_is_the_fits_device_time_per_call(monkeypatch):
    assert _read(monkeypatch, "fit_device_ms", _two_forwards()) == pytest.approx(0.06)


def test_wrapper_host_ms_sums_the_kernel_spans_per_call(monkeypatch):
    # (0.01 + 0.02 + 0.03 + 0.04) ms over two calls
    assert _read(monkeypatch, "wrapper_host_ms", _two_forwards()) == pytest.approx(0.05)


def test_launches_per_call_counts_launch_counters_only(monkeypatch):
    assert _read(monkeypatch, "launches_per_call", _two_forwards()) == 2.0


def test_store_calls_have_no_fit_and_one_launch(monkeypatch):
    """A transform-only cell: the transform is the root span."""
    spans = []
    for i in range(4):
        spans += [_span("stainx.transform", None, i, i + 0.3, 0.26),
                  _span("stainx.kernel.B4", 2 * i, i + 0.01, i + 0.03)]
    sess = _session(spans, {"launch.B4.cluster": 4})
    assert _read(monkeypatch, "fit_device_ms", sess) is None
    assert _read(monkeypatch, "launches_per_call", sess) == 1.0
    assert _read(monkeypatch, "wrapper_host_ms", sess) == pytest.approx(0.02)


def test_nested_kernel_spans_count_once(monkeypatch):
    """A kernel span inside another (a plain version that calls a wrapper)
    adds nothing: its time is inside its parent's."""
    sess = _session([_span("stainx.transform", None, 0, 1),
                     _span("stainx.kernel.B7", 0, 0.1, 0.5),
                     _span("stainx.kernel.B7b", 1, 0.2, 0.3)])
    assert _read(monkeypatch, "wrapper_host_ms", sess) == pytest.approx(0.4)


@pytest.mark.parametrize("name", READERS)
def test_nothing_to_read(monkeypatch, name):
    assert _read(monkeypatch, name, None) is None  # a program with no session
    assert _read(monkeypatch, name, _session([])) is None  # no call
    assert _read(monkeypatch, name, _two_forwards(), traced=False) is None  # no stretch
    only_children = _session([_span("stainx.kernel.B4", 3, 0, 1)])
    assert _read(monkeypatch, name, only_children) is None  # no root span


def test_a_program_without_the_table_gives_nothing(monkeypatch):
    """The parent's port has ``profiling`` but no ``session``."""
    import stainx_tpu_torch.profiling as profiling

    monkeypatch.delattr(profiling, "session")
    assert session._program_session() is None


def test_the_readers_are_entries_of_the_benchmark():
    per_layer = {m["name"]: m for m in spec.load_benchmark()["per_layer"]}
    for name in READERS:
        m = per_layer[name]
        assert m["moves"] == "mpix_per_s" and m["better"] == "lower"
        assert m["source"] in ("program_span", "program_counter")
    assert per_layer["fit_device_ms"]["workloads"] == ["macenko-batchmode-f32-256.train"]
