"""BENCHMARK.json against the contract, and discovery of every part by name.

A configuration, a traffic mix, a cell and a metric added as new files and
new BENCHMARK.json entries, in a copy of the benchmark, are found and run
without an edit of any file that is there.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import spec

ROOT = Path(__file__).resolve().parent.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(not w.startswith("/") and ".." not in w for w in BENCH["command"])
    assert BENCH["paths"] == ["portbench"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert 1 <= len(BENCH["configs"]) <= 24 and 1 <= len(BENCH["workloads"]) <= 24
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_entries_have_only_the_contract_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/") and (ROOT / c["file"]).is_file()
        assert c["reduced"] == [] and 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


def test_names_units_and_uniqueness():
    kinds = ("configs", "workloads", "end_to_end", "per_layer")
    names = [x["name"] for k in kinds for x in BENCH[k]]
    assert all(NAME.match(n) for n in names)
    for k in ("configs", "workloads", "end_to_end", "per_layer"):
        assert len({x["name"] for x in BENCH[k]}) == len(BENCH[k])
    assert all(UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
               for m in BENCH["end_to_end"] + BENCH["per_layer"])
    assert len({(w["config"], w["traffic"]) for w in BENCH["workloads"]}) == len(CELLS)
    assert {w["config"] for w in BENCH["workloads"]} == {c["name"] for c in BENCH["configs"]}


def test_setup_bound_and_every_cell_reports_enough():
    setup = next(m for m in BENCH["end_to_end"] if m["name"] == "setup_s")
    assert setup["bound"] == 0.25 and "workloads" not in setup
    for name in CELLS:
        cell = spec.cell(name)
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
        assert all(m["moves"] in e2e for m in cell.per_layer)


@pytest.mark.parametrize("name", CELLS)
def test_each_cell_finds_its_parts(name):
    cell = spec.cell(name)
    driver = spec.load_module("drivers", cell.traffic["driver"])
    assert all(hasattr(driver, f) for f in ("prepare", "warm", "run", "check_items"))
    reference = spec.load_module("reference", cell.config["reference"])
    assert hasattr(reference, "fit") and hasattr(reference, "transform")
    assert reference.STATISTICS in ("image", "call")
    for m in cell.end_to_end + cell.per_layer:
        assert callable(spec.load_module("metrics", m["name"]).read)
    assert set(cell.config["limits"]) <= {"he_gap", "maxc_gap", "out_mae", "out_max"}


@pytest.mark.parametrize("path", sorted((ROOT / "portbench/reference").glob("*.py")),
                         ids=lambda p: p.stem)
def test_every_reference_states_how_its_transform_reads_a_call(path):
    assert spec.load_module("reference", path.stem).STATISTICS in ("image", "call")


@pytest.mark.parametrize("stated", [None, "batch"])
def test_a_reference_that_states_no_statistics_is_refused(tmp_path, stated):
    """``spec.cell`` refuses a cell whose reference does not say whether its
    transform reads each image alone or the whole call."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    source = (ROOT / "portbench/reference/macenko.py").read_text()
    source = source.replace('STATISTICS = "image"\n', "" if stated is None else
                            f"STATISTICS = {stated!r}\n")
    assert 'STATISTICS = "image"' not in source
    (tmp_path / "portbench/reference/dummy.py").write_text(source)
    config = json.loads((ROOT / "portbench/configs/macenko-u8-256.json").read_text())
    config.update(name="dummy-u8-256", reference="dummy")
    (tmp_path / "portbench/configs/dummy-u8-256.json").write_text(json.dumps(config))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "dummy-u8-256", "source": "https://example.org/dummy",
                             "file": "portbench/configs/dummy-u8-256.json", "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": "dummy-u8-256.store", "config": "dummy-u8-256",
                               "traffic": "store", "chips": 1, "why": "a test"})
    with pytest.raises(ValueError, match="STATISTICS"):
        spec.cell("dummy-u8-256.store", bench, tmp_path, tmp_path / "portbench")
    assert spec.cell("macenko-u8-256.store", bench, tmp_path, tmp_path / "portbench").chips == 1


def test_a_dummy_config_cell_and_metric_are_found_as_new_files(tmp_path):
    """New files and entries only: the copy's harness finds and runs them."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    config = json.loads((ROOT / "portbench/configs/macenko-u8-256.json").read_text())
    config.update(name="dummy-u8-32", tile=[3, 32, 32])
    (tmp_path / "portbench/configs/dummy-u8-32.json").write_text(json.dumps(config))
    (tmp_path / "portbench/traffic/tiny.json").write_text(json.dumps(
        {"driver": "closed_loop", "batch": 4, "pool_batches": 2, "in_flight": 2, "check_batches": 1,
         "check_rows": 4}))
    (tmp_path / "portbench/metrics/calls_made.py").write_text(
        '"""calls_made (calls): the window\'s calls."""\n\n\ndef read(run):\n'
        '    return float(run.window.calls)\n')
    bench["configs"].append({"name": "dummy-u8-32", "source": "https://example.org/dummy",
                             "file": "portbench/configs/dummy-u8-32.json", "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": "dummy-u8-32.tiny", "config": "dummy-u8-32",
                               "traffic": "tiny", "chips": 1, "why": "a test"})
    bench["end_to_end"].append({"name": "calls_made", "unit": "calls", "better": "higher",
                                "bound": 0.01, "source": "host_clock",
                                "workloads": ["dummy-u8-32.tiny"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = (
        "import json, time, torch\n"
        "from portbench import harness, spec\n"
        "assert spec.HERE.parent.resolve() == __import__('pathlib').Path.cwd().resolve()\n"
        "cell = spec.cell('dummy-u8-32.tiny')\n"
        "r = harness.run_cell(cell, 5, 0.3, False, torch.device('cpu'), time.perf_counter())\n"
        "print(json.dumps(harness._finite(r)))\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(tmp_path), str(ROOT)]))
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True
    assert result["metrics"]["calls_made"]["value"] == result["attempted"] > 0
    assert set(result["metrics"]) == {"setup_s", "calls_made"}
