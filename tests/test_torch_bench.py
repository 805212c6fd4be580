"""The port's measuring harness (``bench_torch.py``, ``benchmarks_torch/``)
on the CPU, at tiny sizes: each script's ``main`` runs on ``--device cpu``
and prints JSON lines with the expected keys (``bench_torch``'s last line
is ``bench.py``'s four keys and metric); without ``--device cpu`` each
raises (no fallback from the card); the timing protocol re-processes the
same fresh input and never an output; no module of the harness imports
JAX, ``stainx_tpu`` or ``benchmarks``; and the port's correctness report at
64² (uint8 and float32) has the rows of JAX's ``_case_rows``, each within
its gate and near JAX's measurement.
"""

import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import bench_torch
from benchmarks.correctness_report import _case_rows
from benchmarks_torch import (
    bench_batch_mode,
    bench_serving,
    benchmark_grid,
    correctness_report,
    utils,
)
from stainx_tpu import HistogramMatching as JaxHM
from stainx_tpu import Macenko as JaxMacenko
from stainx_tpu import Reinhard as JaxReinhard

ROOT = Path(__file__).resolve().parent.parent
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline"}


def _json_lines(text: str) -> list[dict]:
    return [json.loads(line) for line in text.splitlines() if line.startswith("{")]


# ------------------------------------------------------------------ bench_torch
def test_bench_torch_last_line_is_bench_py_line(capsys):
    result = bench_torch.main(["--device", "cpu", "--batch", "2", "--size", "48", "--runs", "1"])
    lines = capsys.readouterr().out.strip().splitlines()
    last = json.loads(lines[-1])
    assert set(last) == BENCH_KEYS and last == result["line"]
    bench_py = (ROOT / "bench.py").read_text()
    assert re.search(r'"metric": "([a-z0-9_]+)"', bench_py).group(1) == last["metric"]
    assert re.search(r'"unit": "([^"]+)"', bench_py).group(1) == last["unit"]
    assert f"BASELINE_MPIX_PER_S = {bench_torch.BASELINE_MPIX_PER_S}" in bench_py
    # value from the time as called; vs_baseline against bench.py's denominator
    assert result["called_ms"] > 0
    mpix_per_s = 2 * 48 * 48 / 1e6 / (result["called_ms"] / 1e3)
    assert last["value"] == round(mpix_per_s, 2)
    assert last["vs_baseline"] == round(mpix_per_s / 291.0, 3)
    assert lines[0].startswith("cpu") and result["device"] == "cpu"
    assert result["launches"] == {}  # the CPU runs the plain versions: no kernel launches
    assert result["mae"] <= bench_torch.MAE_GATE


# ------------------------------------------------------ benchmarks_torch scripts
TIMING_KEYS = {"called_ms", "busy_ms", "idle_share", "device"}
SCRIPTS = {
    "batch_mode": (bench_batch_mode, ["--batch", "3", "--size", "24", "--json"], 3,
                   {"mode", "method", "dtype", "batch", "size", "img_per_s", "mpix_per_s",
                    "launches"} | TIMING_KEYS),
    "batch_mode_pooled": (bench_batch_mode, ["--batch", "3", "--size", "24", "--dtype",
                                             "float32", "--pooled", "--json"], 1,
                          {"mode", "method", "dtype", "batch", "size", "img_per_s",
                           "mpix_per_s", "launches"} | TIMING_KEYS),
    "serving": (bench_serving, ["--size", "32", "--tiles", "2", "--json"], 1,
                {"mode", "size", "tiles", "called_ms_per_tile", "busy_ms_per_tile",
                 "idle_share", "mpix_per_s", "launches", "kernel", "b4_route",
                 "repeat_bit_identical", "device"}),
    "grid": (benchmark_grid, ["--method", "hm", "--batch-size", "2", "3", "--image-size", "24",
                              "--json"], 2,
             {"method", "dtype", "batch", "size", "img_per_s", "mpix_per_s",
              "mae_vs_oracle"} | TIMING_KEYS),
    "correctness_report": (correctness_report, ["--sizes", "16", "--json"], 4,
                           {"algorithm", "case", "metric", "measured", "gate", "ok", "device"}),
}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_script_json_lines(name, capsys):
    module, argv, n_rows, keys = SCRIPTS[name]
    rows = module.main([*argv, "--device", "cpu", "--runs", "1"]
                       if module is not correctness_report else [*argv, "--device", "cpu"])
    printed = _json_lines(capsys.readouterr().out)
    assert len(rows) == len(printed) == n_rows
    for row in printed:
        assert set(row) == keys and row["device"] == "cpu"
        for key in ("called_ms", "busy_ms", "called_ms_per_tile", "img_per_s", "mpix_per_s"):
            if key in row:
                assert np.isfinite(row[key]) and row[key] > 0
    if module is correctness_report:
        assert correctness_report.failures(rows) == 0 and all(r["ok"] for r in printed)
    else:
        assert printed == rows


def test_serving_routes_and_repeats(capsys):
    rows = bench_serving.main(["--size", "32", "256", "--tiles", "2", "--runs", "1",
                               "--device", "cpu"])
    # 32^2 goes to B1, 256^2 to B4 on its cluster route (the H100's ladder,
    # which the CPU follows with the plain versions)
    assert [(r["size"], r["kernel"], r["b4_route"]) for r in rows] == [
        (32, "B1", None), (256, "B4", "cluster")]
    assert all(r["repeat_bit_identical"] and r["tiles"] == 2 for r in rows)


@pytest.mark.parametrize("module", [bench_torch, bench_batch_mode, bench_serving, benchmark_grid,
                                    correctness_report],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_no_fallback_without_cuda(module):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device does not raise")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        module.main(["--runs", "1"] if module is not correctness_report else ["--sizes", "16"])


# ---------------------------------------------------------------- the protocol
class Recorder:
    """A step that records every input it is given and returns a new tensor."""

    def __init__(self):
        self.seen = []

    def __call__(self, x):
        self.seen.append(x)
        return x + 1


@pytest.mark.parametrize("timer", ["called_ms", "busy_ms"])
def test_protocol_reprocesses_the_fresh_input(timer):
    x = torch.zeros(4)
    step = Recorder()
    if timer == "called_ms":
        ms, calls = utils.called_ms(step, x, 5, rounds=2), 1 + 2 * 6
    else:
        ms, calls = utils.busy_ms(step, x, 5), 6
    assert ms > 0 and len(step.seen) == calls
    assert all(seen is x for seen in step.seen)  # never its own output


def test_protocol_cycles_distinct_inputs_in_order():
    tiles = [torch.full((2,), float(k)) for k in range(3)]
    step = Recorder()
    utils.called_ms(step, tiles, 7, rounds=1, warmup=0)
    # a warm-up call on each tile, then 7 calls cycling the tiles in order
    order = [next(k for k, t in enumerate(tiles) if s is t) for s in step.seen]
    assert order == [0, 1, 2] + [i % 3 for i in range(7)]  # each a tile, never an output


def test_idle_share_and_mae():
    assert utils.idle_share(0.25, 1.0) == 0.75
    a = torch.tensor([[0, 2, 255]], dtype=torch.uint8)
    assert utils.mae(a, np.array([[1, 2, 253]], np.uint8)) == pytest.approx(1.0)
    assert utils.canonical_method("hm") == "histogram_matching"


# ------------------------------------------------------------- no JAX imported
def test_harness_imports_no_jax():
    code = ("import sys, bench_torch, chip_smoke\n"
            "from benchmarks_torch import utils, bench_batch_mode, bench_serving, "
            "benchmark_grid, correctness_report\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} "
            "& {'jax', 'jaxlib', 'stainx_tpu', 'benchmarks'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120, check=True).stdout
    assert out.strip() == "[]"


# ------------------------------------------ the correctness report against JAX's
@pytest.fixture(scope="module")
def report_rows():
    """The port's report at 64² (uint8 then float32) and JAX's ``_case_rows``
    on the same draws, on the CPU."""
    port = correctness_report.main(["--sizes", "64", "--dtypes", "uint8", "float32",
                                    "--device", "cpu"])
    oracle, rng = utils.load_oracle(), np.random.default_rng(42)
    jax_rows = []
    for as_float in (False, True):
        jax_rows += _case_rows(oracle, JaxMacenko, JaxReinhard, JaxHM, rng, 64, 64, as_float)
    return port, jax_rows


@pytest.mark.parametrize("i", range(8))
def test_correctness_report_matches_jax(report_rows, i):
    port, jax_rows = report_rows
    assert len(port) == len(jax_rows) == 8
    (algo, case, metric, value, gate), jax_row = port[i], jax_rows[i]
    assert (algo, case, metric, gate) == (jax_row[0], jax_row[1], jax_row[2], jax_row[4])
    assert value <= gate
    # one grey level (1/255 for float input) of JAX's max|diff|; MAE rows
    # within 0.05; the stain matrix within the port's HE tolerance, 2e-5
    grey = 1.0 / 255.0 if case.endswith("f") else 1.0
    tol = {"MAE": 0.05, "HE max|diff|": 2e-5}.get(metric, grey)
    assert abs(value - jax_row[3]) <= tol, (port[i], jax_row)
