"""The patch cell's parts: its discovery, the cost of its call, and the
``b1_device_ms`` reader on made-up sessions."""

from __future__ import annotations

import json
from pathlib import Path
from types import SimpleNamespace

import pytest

from portbench import counts, session, spec
from stainx_tpu_torch.profiling import Session, Span

ROOT = Path(__file__).resolve().parent.parent
NAME = "macenko-u8-96.store-b512"
MS = 1_000_000  # ns


def test_the_cell_finds_its_parts():
    cell = spec.cell(NAME)
    assert cell.chips == 1 and cell.traffic == json.loads(
        (ROOT / "portbench/traffic/store-b512.json").read_text())
    assert cell.traffic == {"driver": "closed_loop", "batch": 512, "pool_batches": 16,
                            "in_flight": 16, "check_batches": 1, "check_rows": 512}
    assert cell.config["tile"] == [3, 96, 96] and cell.config["dtype"] == "uint8"
    assert cell.config["system"] == {"class": "Macenko", "kwargs": {}}
    assert (cell.config["call"], cell.config["fit"]) == ("transform", "reference")
    reference = spec.load_module("reference", cell.config["reference"])
    assert reference.STATISTICS == "image"
    for m in cell.end_to_end + cell.per_layer:
        assert callable(spec.load_module("metrics", m["name"]).read)
    assert {m["name"] for m in cell.end_to_end} == {"setup_s", "mpix_per_s"}
    assert {m["name"] for m in cell.per_layer} == {
        "api_host_ms", "roofline_share", "idle_share", "wrapper_host_ms", "launches_per_call",
        "b1_device_ms"}
    assert set(cell.config["limits"]) == {"he_gap", "maxc_gap", "out_mae", "out_max"}
    assert cell.config["limits"]["out_max"] < 7  # one altered answer shows


def test_the_configuration_is_an_entry_with_nothing_reduced():
    bench = spec.load_benchmark()
    entry = next(c for c in bench["configs"] if c["name"] == "macenko-u8-96")
    config = json.loads((ROOT / entry["file"]).read_text())
    assert entry["reduced"] == config["reduced"] == [] and entry["source"] == config["source"]
    assert len(entry["source"]) <= 200 and "basveeling/pcam" in entry["source"]


def test_the_call_is_bounded_by_its_bytes():
    """512 patches of 3x96² uint8, read once and written once: 28 311 552
    bytes, 8.45 µs at 3.35 TB/s, against 69 operations a pixel, 4.86 µs at
    67 TFLOP/s."""
    cell = spec.cell(NAME)
    reference = spec.load_module("reference", cell.config["reference"])
    cost = counts.call_cost(cell.config, cell.traffic["batch"], reference.OPS_PER_PIXEL)
    assert cost.bytes == 28_311_552 and cost.ops == 512 * 96 * 96 * 69
    assert cost.bound == "bytes"
    assert cost.least_s == pytest.approx(28_311_552 / 3.35e12)


def _span(name, parent, call, start_ms, end_ms, device_ms=None):
    return Span(name, parent, call, {}, int(start_ms * MS), int(end_ms * MS), device_ms)


def _calls(device_ms):
    """One transform a call, each with a B1 span of the given interval."""
    spans = []
    for i, dev in enumerate(device_ms):
        spans += [_span("stainx.transform", None, 2 * i, i, i + 0.1, 0.2),
                  _span("stainx.kernel.B1", 2 * i, 2 * i, i + 0.01, i + 0.05, dev)]
    return Session(spans, {"launch.B1": len(device_ms), "resident.B1": len(device_ms)})


def _read(monkeypatch, sess, traced=True):
    monkeypatch.setattr(session, "_program_session", lambda: sess)
    run = SimpleNamespace(trace=object() if traced else None)
    return spec.load_module("metrics", "b1_device_ms").read(run)


def test_b1_device_ms_is_the_b1_spans_device_time_per_call(monkeypatch):
    assert _read(monkeypatch, _calls([0.12, 0.14, 0.16])) == pytest.approx(0.14)


def test_resident_and_l2_counts_are_no_launches(monkeypatch):
    """``resident.B1`` and ``l2.B1`` count B1's launches again by body:
    ``launches_per_call`` reads ``launch.*`` alone."""
    monkeypatch.setattr(session, "_program_session", lambda: _calls([0.1, 0.1]))
    run = SimpleNamespace(trace=object())
    assert spec.load_module("metrics", "launches_per_call").read(run) == 1.0


def test_b1_device_ms_has_nothing_to_read(monkeypatch):
    assert _read(monkeypatch, None) is None  # a program with no session
    assert _read(monkeypatch, Session([], {})) is None  # no call
    assert _read(monkeypatch, _calls([0.1]), traced=False) is None  # no stretch
    # The parent's port: a B1 span with no device interval.
    assert _read(monkeypatch, _calls([None, None])) is None
    b4 = Session([_span("stainx.transform", None, 0, 0, 1, 0.3),
                  _span("stainx.kernel.B4", 0, 0, 0.1, 0.2)], {})
    assert _read(monkeypatch, b4) is None  # a call that never reaches B1


def test_b1_device_ms_is_an_entry_of_the_benchmark():
    m = next(m for m in spec.load_benchmark()["per_layer"] if m["name"] == "b1_device_ms")
    assert m == {"name": "b1_device_ms", "unit": "ms", "better": "lower",
                 "source": "program_span", "layer": "kernels (kernels/*.py, csrc/*.cu)",
                 "moves": "mpix_per_s", "workloads": [NAME]}
