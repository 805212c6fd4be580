"""What a run may load, and the command's refusal to run without a card.

No loaded module may have the top-level name ``jax``, ``jaxlib``, ``flax``,
``stainx_tpu`` (the JAX package), ``benchmarks`` (its harness), ``bench``
or ``benchmarks_torch``, nor be ``stainx_tpu_torch.testing``; names are
compared whole, so ``stainx_tpu_torch`` (the port) passes.
"""

from __future__ import annotations

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import guard

ROOT = Path(__file__).resolve().parent.parent


def test_names_are_compared_whole():
    loaded = ["stainx_tpu_torch", "stainx_tpu_torch.ops.macenko", "benchmarks_x", "jaxtyping",
              "portbench.metrics.mpix_per_s", "numpy"]
    assert guard.forbidden(loaded) == []
    bad = ["jax", "jax.numpy", "jaxlib.xla_client", "flax", "stainx_tpu", "stainx_tpu.ops",
           "benchmarks.utils", "bench", "benchmarks_torch.utils", "stainx_tpu_torch.testing"]
    assert guard.forbidden(bad + loaded) == sorted(bad)


def test_a_cell_loads_nothing_forbidden():
    """A fresh interpreter runs every cell's imports, set-up path and a
    short window on the CPU, then looks at ``sys.modules``."""
    code = (
        "import sys, time, torch\n"
        "from portbench import guard, harness, spec\n"
        "for name in [w['name'] for w in spec.load_benchmark()['workloads']]:\n"
        "    cell = spec.cell(name)\n"
        "    cell.config['tile'] = [3, 16, 16]\n"
        "    cell.traffic.update(batch=2, pool_batches=2, in_flight=2, check_rows=2)\n"
        "    r = harness.run_cell(cell, 3, 0.1, False, torch.device('cpu'), time.perf_counter())\n"
        "    assert r['correct'], r\n"
        "print(guard.forbidden())\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0].startswith(('stainx', 'jax'))))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=240, env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert out.returncode == 0, out.stderr[-3000:]
    found, stainx = out.stdout.strip().splitlines()[-2:]
    assert found == "[]"
    assert "stainx_tpu_torch" in stainx and "'stainx_tpu'" not in stainx


def _imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
    return names


def test_reference_and_yardstick_import_nothing_of_the_program():
    for path in (ROOT / "portbench").rglob("*.py"):
        assert guard.forbidden(_imports(path)) == [], path
    for name in ("reference/macenko.py", "gen.py", "counts.py", "check.py", "records.py",
                 "trace.py", "spec.py", "guard.py"):
        assert not any(m.split(".")[0] == "stainx_tpu_torch"
                       for m in _imports(ROOT / "portbench" / name)), name


def _cli(cwd: Path, *args: str):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env["PYTHONPATH"] = str(cwd)
    return subprocess.run([sys.executable, "-m", "portbench", *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=240)


def test_without_a_card_the_command_fails_and_prints_no_result():
    out = _cli(ROOT, "--workload", "macenko-u8-256.store", "--seed", "5", "--seconds", "1",
               "--trace", "0")
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_with_only_the_benchmark_the_command_fails(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = _cli(tmp_path, "--workload", "macenko-u8-256.store", "--seed", "5", "--seconds", "1",
               "--trace", "0")
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("traced", ["0", "1"])
def test_each_cell_runs_on_the_card(card, traced):
    """On the card: every cell, briefly, traced and not, prints a correct
    line with its metrics, and loads nothing forbidden."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        out = subprocess.run([sys.executable, "-m", "portbench", "--workload", w["name"],
                              "--seed", "2147483651", "--seconds", "2", "--trace", traced],
                             cwd=ROOT, capture_output=True, text=True, timeout=900)
        assert out.returncode == 0, out.stderr[-3000:]
        result = json.loads(out.stdout.strip().splitlines()[-1])
        assert result["correct"] and result["device"]["platform"] == "gpu"
        kinds = "per_layer" if traced == "1" else "end_to_end"
        wanted = {m["name"] for m in bench[kinds] if w["name"] in m.get("workloads", [w["name"]])}
        assert set(result["metrics"]) == wanted
