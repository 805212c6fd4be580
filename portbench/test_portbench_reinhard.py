"""The Reinhard cell's parts: its discovery, its reference's imports, a
Reinhard cell on the CPU checked against the committed ``"call"``
reference (``reference/reinhard.py``), and the ``stats_device_ms`` reader
on made-up sessions."""

from __future__ import annotations

import ast
import json
import time
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from portbench import control, faults, harness, session, spec
from stainx_tpu_torch.profiling import Session, Span

ROOT = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
NAME = "reinhard-u8-512.store"
MS = 1_000_000  # ns


def test_the_cell_finds_its_parts():
    cell = spec.cell(NAME)
    assert cell.chips == 1 and cell.traffic == json.loads(
        (ROOT / "portbench/traffic/store.json").read_text())
    reference = spec.load_module("reference", cell.config["reference"])
    assert reference.STATISTICS == "call"
    for m in cell.end_to_end + cell.per_layer:
        assert callable(spec.load_module("metrics", m["name"]).read)
    assert {m["name"] for m in cell.end_to_end} == {"setup_s", "mpix_per_s"}
    assert "stats_device_ms" in {m["name"] for m in cell.per_layer}
    assert "fit_device_ms" not in {m["name"] for m in cell.per_layer}
    assert set(cell.config["limits"]) == {"stat_gap", "out_mae", "out_max"}
    assert cell.config["limits"]["out_max"] < 7  # one altered answer shows


def test_the_reference_imports_nothing_of_the_program():
    names = set()
    for node in ast.walk(ast.parse((ROOT / "portbench/reference/reinhard.py").read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
    assert names <= {"__future__", "numpy", "torch"}, names


SMALL = {
    "name": "reinhard-u8-32", "method": "reinhard",
    "system": {"class": "Reinhard", "kwargs": {}}, "call": "transform", "fit": "reference",
    "tile": [3, 32, 32], "dtype": "uint8", "out_full_scale": 255.0, "stain_scale": [0.85, 1.15],
    "reference": "reinhard",
    # From 12 seeds of this cell (program, worst / bf16 control, least): stat_gap
    # 2.2e-6 / 1.1e-2, out_mae 2.0e-5 / 0.67, out_max 1 / 5.
    "limits": {"stat_gap": 1e-4, "out_mae": 0.02, "out_max": 1.5},
}


@pytest.fixture
def small_cell():
    """A Reinhard cell on the CPU at a small tile, checked against the
    committed ``"call"`` reference."""
    traffic = {"driver": "closed_loop", "batch": 32, "pool_batches": 2, "in_flight": 2,
               "check_batches": 1, "check_rows": 32}
    return spec.Cell("reinhard-u8-32.store", 1, json.loads(json.dumps(SMALL)), traffic)


def test_a_sound_run_is_correct(small_cell):
    result = harness.run_cell(small_cell, 2**32 + 17, 0.3, False, CPU, time.perf_counter())
    assert result["correct"] is True and result["attempted"] > 0, result["checks"]


def test_the_bf16_control_is_not_correct(small_cell):
    readings = control.readings(small_cell, 2**33 + 1, 0.3, CPU)
    assert readings["correct"] is False
    limits = small_cell.config["limits"]
    assert sum(readings["found"][k] > v for k, v in limits.items()) >= 2


@pytest.mark.parametrize("fault", [f for f in sorted(faults.FAULTS) if faults.applies(
    f, spec.Cell("reinhard-u8-32.store", 1, SMALL, {}))])
def test_a_fault_is_not_correct(small_cell, fault):
    result = harness.run_cell(small_cell, 2**32 + 17, 0.3, False, CPU, time.perf_counter(),
                              faults.FAULTS[fault])
    assert result["correct"] is False, result["checks"]


def _span(name, parent, start_ms, end_ms, device_ms=None):
    return Span(name, parent, 0, {}, int(start_ms * MS), int(end_ms * MS), device_ms)


def _read(monkeypatch, name, sess, traced=True):
    monkeypatch.setattr(session, "_program_session", lambda: sess)
    run = SimpleNamespace(trace=object() if traced else None)
    return spec.load_module("metrics", name).read(run)


def _reinhard_calls(stats_dev=(0.09, 0.11)):
    """Reinhard transforms: transform, B7 and the statistics pass inside it,
    one a call, each with the given device interval."""
    spans = []
    for i, dev in enumerate(stats_dev):
        spans += [_span("stainx.transform", None, i, i + 0.3, 0.25),
                  _span("stainx.kernel.B7", 3 * i, i + 0.01, i + 0.05),
                  _span("stainx.stats", 3 * i + 1, i + 0.02, i + 0.04, dev)]
    return Session(spans, {"launch.B7b": len(stats_dev), "launch.B7a": len(stats_dev)})


def test_stats_device_ms_is_the_statistics_pass_per_call(monkeypatch):
    sess = _reinhard_calls()
    assert _read(monkeypatch, "stats_device_ms", sess) == pytest.approx(0.1)
    assert _read(monkeypatch, "launches_per_call", sess) == 2.0
    # the statistics span is not a kernel span: B7's host time counts once
    assert _read(monkeypatch, "wrapper_host_ms", sess) == pytest.approx(0.04)
    assert _read(monkeypatch, "fit_device_ms", sess) is None


def test_stats_device_ms_without_the_span_or_its_interval(monkeypatch):
    """The parent's port opens no ``stainx.stats`` span; a span whose
    interval was never read gives nothing either."""
    macenko = Session([_span("stainx.transform", None, 0, 0.3, 0.26),
                       _span("stainx.kernel.B4", 0, 0.01, 0.03)], {"launch.B4.cluster": 1})
    assert _read(monkeypatch, "stats_device_ms", macenko) is None
    assert _read(monkeypatch, "stats_device_ms", _reinhard_calls((None, None))) is None


def test_stats_device_ms_with_nothing_to_read(monkeypatch):
    assert _read(monkeypatch, "stats_device_ms", None) is None  # a program with no session
    assert _read(monkeypatch, "stats_device_ms", Session([], {})) is None  # no call
    assert _read(monkeypatch, "stats_device_ms", _reinhard_calls(), traced=False) is None
    only_children = Session([_span("stainx.stats", 3, 0, 1, 0.1)], {})
    assert _read(monkeypatch, "stats_device_ms", only_children) is None  # no root span


def test_stats_device_ms_is_an_entry_of_the_benchmark():
    m = {m["name"]: m for m in spec.load_benchmark()["per_layer"]}["stats_device_ms"]
    assert m["moves"] == "mpix_per_s" and m["better"] == "lower" and m["unit"] == "ms"
    assert m["source"] == "program_span" and m["workloads"] == [NAME]
