"""The port's user programs on the CPU (``--device cpu``, the kernels' plain
versions), at their smallest arguments, against the JAX scripts where both
compute the same thing:

- ``examples_torch/simple_example.py``, ``visualize_example.py``,
  ``pipeline_example.py`` and ``serving_example.py``: each ``main``, its
  data and its outputs against the JAX example's (within one grey level,
  1/255 on float output), its PNG read back;
- ``benchmarks_torch/pareto_time_mae.py`` at 4×3×64² (its batch and size
  patched on both scripts), its series and their MAE against
  ``benchmarks/pareto_time_mae.py``'s;
- ``examples_torch/quickstart_notebook.ipynb``: its code cells in order with
  ``DEVICE`` set to ``"cpu"`` after the first, against the JAX notebook's
  results; its outputs cleared and every call given ``device=DEVICE``;
- without ``--device`` each program raises where there is no CUDA (no
  fallback to the CPU), each runs as a script, and none imports JAX,
  ``stainx_tpu``, PIL, matplotlib or triton.
"""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import stainx_tpu
from benchmarks.utils import synthetic_he_batch
from benchmarks_torch import pareto_time_mae
from examples_torch import pipeline_example, serving_example, simple_example, visualize_example
from examples_torch._common import DATA_DIR, NOTEBOOK, load_nchw, run_notebook
from examples_torch._png import read_png, write_png
from stainx_tpu.ops import macenko as jax_mk

ROOT = Path(__file__).resolve().parent.parent
JAX_NOTEBOOK = ROOT / "examples" / "quickstart_notebook.ipynb"
GREY, GREY_F = 1.0, 1.0 / 255.0 + 1e-6  # one grey level; on float [0, 1] output as elsewhere
METHODS = ["macenko", "reinhard", "histogram_matching"]
JAX_CLASSES = {"macenko": stainx_tpu.Macenko, "reinhard": stainx_tpu.Reinhard,
               "histogram_matching": stainx_tpu.HistogramMatching}
FORBIDDEN = {"jax", "jaxlib", "stainx_tpu", "PIL", "matplotlib", "triton"}
# The port's series on the CPU and the JAX script's off the TPU.
JAX_MODES = {"cpu_stable": "tpu_stable", "cpu": "tpu"}


@pytest.fixture
def jax_config_kept(monkeypatch):
    """The JAX examples and benchmark point JAX's compilation cache at a
    directory of their own when imported or run; the suite keeps its own
    settings, so those updates are dropped."""
    update = jax.config.update
    keys = {"jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs"}
    monkeypatch.setattr(jax.config, "update",
                        lambda key, value: None if key in keys else update(key, value))


def _grey(got, want) -> float:
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    return float(np.abs(got.astype(np.float64) - np.asarray(want).astype(np.float64)).max())


# -------------------------------------------------------------- simple_example
@pytest.mark.parametrize("method", METHODS)
def test_simple_example_matches_jax(method, tmp_path, monkeypatch, jax_config_kept):
    from examples import simple_example as jax_simple

    port = simple_example.main(["--method", method, "--size", "64", "--out",
                                str(tmp_path / "port.png"), "--device", "cpu"])
    # The JAX script writes its panel as .npy where matplotlib does not import.
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setattr(sys, "argv", ["simple_example.py", "--method", method, "--size", "64",
                                      "--out", str(tmp_path / "jax.png")])
    jax_simple.main()
    jax_panel = np.load(tmp_path / "jax.png.npy")
    assert port["panel"].dtype == np.uint8
    assert port["panel"].shape == jax_panel.shape == (64, 192, 3)
    assert _grey(port["panel"], jax_panel) <= GREY
    np.testing.assert_array_equal(read_png(str(tmp_path / "port.png")), port["panel"])
    for seed, scale in [(42, 1.0), (123, 1.3)]:
        np.testing.assert_array_equal(simple_example.synthetic_tile(40, 48, seed, scale),
                                      jax_simple.synthetic_tile(40, 48, seed, scale))


# ----------------------------------------------------------- visualize_example
@pytest.mark.parametrize("method", METHODS)
def test_visualize_example_matches_jax(method, tmp_path, jax_config_kept):
    pytest.importorskip("PIL")  # the JAX example reads its tiles with PIL
    from examples import visualize_example as jax_vis

    port = visualize_example.main([method, "--runs", "1", "--save-plots", "--output-dir",
                                   str(tmp_path), "--device", "cpu"])
    ref, sources, names, origin = jax_vis.discover_data(None)
    assert origin == DATA_DIR and port["names"] == names == [f"test_{i}.png" for i in range(1, 6)]
    np.testing.assert_array_equal(port["reference"], ref)
    for got, want in zip(port["sources"], sources):
        np.testing.assert_array_equal(got, want)
    jax_norm = JAX_CLASSES[method]().fit(ref)
    for got, src in zip(port["results"], sources):
        assert _grey(got, np.asarray(jax_norm.transform(src))) <= GREY
    assert port["ms_per_run"] > 0
    assert port["panel"] == str(tmp_path / f"normalization_results_{method}.png")
    grid = read_png(port["panel"])
    np.testing.assert_array_equal(grid, visualize_example.panel(ref, sources, port["results"]))
    assert grid.shape == (2 * 384, 6 * 384, 3)


def test_visualize_discovery(tmp_path, jax_config_kept):
    """A directory without target.png falls back to the JAX example's
    synthetic tiles; a directory with one is read in sorted order."""
    from examples import visualize_example as jax_vis

    got, want = visualize_example.discover_data(str(tmp_path)), jax_vis.discover_data(str(tmp_path))
    assert got[2:] == want[2:] == (["synthetic_0", "synthetic_1"], "synthetic")
    np.testing.assert_array_equal(got[0], want[0])
    for a, b in zip(got[1], want[1]):
        np.testing.assert_array_equal(a, b)
    tiles = [np.full((8, 6, 3), v, np.uint8) for v in (10, 20, 30)]
    for name, tile in zip(["target.png", "b.png", "a.png"], tiles):
        write_png(str(tmp_path / name), tile)
    ref, sources, names, origin = visualize_example.discover_data(str(tmp_path))
    assert names == ["a.png", "b.png"] and origin == str(tmp_path)
    assert ref.shape == (1, 3, 8, 6) and [int(s[0, 0, 0, 0]) for s in sources] == [30, 20]


def test_visualize_panel_pads_other_sizes():
    ref = np.zeros((1, 3, 4, 5), np.uint8)
    src = [np.full((1, 3, 6, 3), 7, np.uint8)]
    grid = visualize_example.panel(ref, src, [np.full((1, 3, 6, 3), 9, np.uint8)])
    assert grid.shape == (12, 10, 3)
    assert (grid[:4, :5] == 0).all() and (grid[4:6, :5] == 255).all()
    assert (grid[:6, 5:8] == 7).all() and (grid[6:, 5:8] == 9).all() and (grid[:, 8:] == 255).all()


# ------------------------------------------------------------ pipeline_example
@pytest.mark.parametrize("method", METHODS)
def test_pipeline_example_matches_jax(method):
    port = pipeline_example.main(["--method", method, "--epochs", "1", "--device", "cpu"])
    batch = port["last_batch"]
    assert batch.dtype == torch.uint8 and tuple(batch.shape) == (4, 3, 384, 384)
    assert port["images"] == 20 and port["img_per_s"] > 0
    target = load_nchw(os.path.join(DATA_DIR, "target.png")).astype(np.float32) / 255.0
    x = batch.numpy().astype(np.float32) / 255.0
    want = np.asarray(stainx_tpu.StainNormalizerTransform(method=method, reference=target)(x))
    out = port["out"]
    assert out.dtype == torch.float32 and 0.0 <= float(out.min()) and float(out.max()) <= 1.0
    assert _grey(out, want) <= GREY_F
    want_b = np.asarray(stainx_tpu.StainNormalizerTransform(method="reinhard", mode="batch")(x))
    assert _grey(port["batch_mode_out"], want_b) <= GREY_F


def test_pipeline_dataset_collates_uint8_nchw():
    loader = torch.utils.data.DataLoader(pipeline_example.TilesDataset(repeat=1), batch_size=2)
    batches = list(loader)
    assert [tuple(b.shape) for b in batches] == [(2, 3, 384, 384)] * 2 + [(1, 3, 384, 384)]
    assert all(b.dtype == torch.uint8 for b in batches)
    np.testing.assert_array_equal(batches[0][1].numpy(),
                                  load_nchw(os.path.join(DATA_DIR, "test_2.png"))[0])


# ------------------------------------------------------------- serving_example
def test_serving_example_matches_jax():
    from examples import serving_example as jax_serving

    port = serving_example.main(["--tiles", "3", "--size", "48", "--device", "cpu"])
    assert len(port["times_ms"]) == 3 and all(t > 0 for t in port["times_ms"])
    for seed in range(4):
        np.testing.assert_array_equal(serving_example.synthetic_tile(48, seed),
                                      jax_serving.synthetic_tile(48, seed))
    jax_norm = stainx_tpu.Macenko().fit(jax_serving.synthetic_tile(48, seed=0)[None])
    for i, out in enumerate(port["outputs"]):
        tile = jax_serving.synthetic_tile(48, seed=1 + i)[None]
        np.testing.assert_array_equal(port["tiles"][i].numpy(), tile)
        assert out.dtype == torch.uint8 and _grey(out, np.asarray(jax_norm.transform(tile))) <= GREY


@pytest.mark.parametrize("size", [64, 384])
def test_serving_tile_is_make_data_tile(size):
    from examples.make_data import make_tile

    np.testing.assert_array_equal(serving_example.synthetic_tile(size, 7),
                                  np.transpose(make_tile(7, size, size), (2, 0, 1)))


# -------------------------------------------------------------- pareto_time_mae
def test_pareto_protocol_is_jax_s():
    from benchmarks import pareto_time_mae as jax_pareto

    assert (pareto_time_mae.BATCH, pareto_time_mae.SIZE) == (jax_pareto.BATCH, jax_pareto.SIZE)


@pytest.mark.parametrize("method", METHODS)
def test_pareto_matches_jax(method, monkeypatch, capsys, jax_config_kept):
    from benchmarks import pareto_time_mae as jax_pareto

    for module in (pareto_time_mae, jax_pareto):
        monkeypatch.setattr(module, "BATCH", 4)
        monkeypatch.setattr(module, "SIZE", 64)
    rows = pareto_time_mae.main(["--method", method, "--runs", "1", "--json", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("cpu")
    assert [json.loads(line) for line in lines[1:]] == rows
    monkeypatch.setattr(sys, "argv", ["pareto_time_mae.py", "--method", method, "--runs", "1",
                                      "--json"])
    jax_pareto.main()
    jax_rows = {r["mode"]: r for r in map(json.loads, capsys.readouterr().out.splitlines())}

    peer = ["reference-torch-cpu"] if pareto_time_mae._reference_torch().available() else []
    series = ["_stable", "_fast"] if method == "macenko" else [""]
    assert [r["mode"] for r in rows] == ["numpy_oracle_cpu"] + [f"cpu{s}" for s in series] + peer
    gate = 0.35 if method == "macenko" else 1.0
    for row in rows:
        assert row["method"] == method and row["device"] == "cpu" and row["launches"] == {}
        assert np.isfinite(row["img_per_s"]) and row["img_per_s"] > 0 and row["mae"] <= gate
        if row["mode"] != "cpu_fast":
            jax_row = jax_rows[JAX_MODES.get(row["mode"], row["mode"])]
            assert abs(row["mae"] - jax_row["mae"]) <= 0.05, (row, jax_row)
    if method == "macenko":
        # On uint8 the port's "fast" runs the same exact kernels as "stable",
        # as JAX's Pallas kernels do; the JAX script off the TPU takes its
        # XLA route, whose "fast" reconstructs in bfloat16.
        assert rows[1]["mae"] == rows[2]["mae"]
        ref = jnp.asarray(synthetic_he_batch(1, 64, 64, seed=42))
        src = jnp.asarray(synthetic_he_batch(4, 64, 64, seed=123, he_scale=1.15))
        params = jax_mk.macenko_fit(ref, use_pallas=True)
        np.testing.assert_array_equal(
            np.asarray(jax_mk.macenko_transform(src, *params, precision="fast", use_pallas=True)),
            np.asarray(jax_mk.macenko_transform(src, *params, use_pallas=True)))


# ------------------------------------------------------------------- notebook
def _code_cells(path) -> list[str]:
    with open(path) as f:
        return ["".join(c["source"]) for c in json.load(f)["cells"] if c["cell_type"] == "code"]


def test_notebook_cells_on_cpu_match_jax_notebook(jax_config_kept):
    shown = []
    port = run_notebook(after_first={"DEVICE": "cpu"}, out=shown.append)
    ref = run_notebook(str(JAX_NOTEBOOK), out=lambda _: None)
    assert port["DEVICE"] == "cpu" and len(shown) == 5
    np.testing.assert_array_equal(port["reference"], ref["reference"])
    np.testing.assert_array_equal(port["batch"], ref["batch"])
    for name in ("normalized", "out_reinhard", "out_hm"):
        assert port[name].device.type == "cpu" and port[name].dtype == torch.uint8
        assert _grey(port[name], ref[name]) <= GREY, name
    assert _grey(port["model_input"], ref["model_input"]) <= GREY_F
    np.testing.assert_allclose(port["normalizer"]._stain_matrix.numpy(),
                               np.asarray(ref["normalizer"]._stain_matrix), atol=2e-5, rtol=0)


def test_notebook_form():
    with open(NOTEBOOK) as f:
        cells = json.load(f)["cells"]
    code = [c for c in cells if c["cell_type"] == "code"]
    assert all(c["outputs"] == [] and c["execution_count"] is None for c in code)
    assert 'DEVICE = "cuda:0"' in "".join(code[0]["source"])
    calls = 0
    for source in _code_cells(NOTEBOOK)[1:]:
        for node in ast.walk(ast.parse(source)):
            if isinstance(node, ast.Call) and getattr(node.func, "id", None) in (
                    "Macenko", "Reinhard", "HistogramMatching", "StainNormalizerTransform"):
                calls += 1
                assert any(k.arg == "device" and getattr(k.value, "id", None) == "DEVICE"
                           for k in node.keywords), ast.unparse(node)
    assert calls == 5

    def headings(path):
        with open(path) as f:
            return [line for c in json.load(f)["cells"] if c["cell_type"] == "markdown"
                    for line in "".join(c["source"]).splitlines() if line.startswith("## ")]

    assert headings(NOTEBOOK) == headings(JAX_NOTEBOOK)
    scaling = "".join(cells[-1]["source"])
    assert cells[-1]["cell_type"] == "markdown" and scaling.startswith("## Scaling out")
    assert "stainx_tpu_torch.parallel" in scaling and "fit_on_mesh" in scaling
    assert "transform_on_mesh" in scaling


# ------------------------------------------------- no fallback, scripts, imports
PROGRAMS = {
    "simple_example": lambda: simple_example.main(["--size", "16"]),
    "visualize_example": lambda: visualize_example.main(["macenko"]),
    "pipeline_example": lambda: pipeline_example.main([]),
    "serving_example": lambda: serving_example.main([]),
    "pareto_time_mae": lambda: pareto_time_mae.main(["--runs", "1"]),
    "quickstart_notebook": lambda: run_notebook(out=lambda _: None),
}


@pytest.mark.parametrize("program", sorted(PROGRAMS))
def test_no_fallback_without_cuda(program, tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device does not raise")
    monkeypatch.chdir(tmp_path)  # nothing is written there: the device check comes first
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PROGRAMS[program]()
    assert list(tmp_path.iterdir()) == []


SCRIPTS = {
    "simple_example": ["examples_torch/simple_example.py", "--size", "16", "--out", "{tmp}/s.png"],
    "visualize_example": ["examples_torch/visualize_example.py", "histogram_matching", "--runs",
                          "1"],
    "pipeline_example": ["examples_torch/pipeline_example.py", "--method", "histogram_matching",
                         "--epochs", "1"],
    "serving_example": ["examples_torch/serving_example.py", "--tiles", "2", "--size", "16"],
    "pareto_time_mae": ["-m", "benchmarks_torch.pareto_time_mae", "--method", "hm", "--runs",
                        "1"],
}


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_runs_as_a_script(script, tmp_path):
    argv = [a.format(tmp=tmp_path) for a in SCRIPTS[script]]
    done = subprocess.run([sys.executable, *argv, "--device", "cpu"], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert done.returncode == 0, done.stderr
    assert done.stdout.strip()


def _imports(source: str) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


PROGRAM_FILES = sorted(str(p.relative_to(ROOT)) for p in (ROOT / "examples_torch").iterdir()
                       if p.suffix in (".py", ".ipynb")) + ["benchmarks_torch/pareto_time_mae.py"]


@pytest.mark.parametrize("path", PROGRAM_FILES)
def test_imports_torch_numpy_stdlib_and_the_port_only(path):
    full = ROOT / path
    sources = _code_cells(full) if full.suffix == ".ipynb" else [full.read_text()]
    names = set().union(*(_imports(s) for s in sources))
    assert not names & FORBIDDEN, names & FORBIDDEN
    allowed = {"torch", "numpy", "stainx_tpu_torch", "examples_torch", "benchmarks_torch"}
    assert names <= allowed | set(sys.stdlib_module_names), names - allowed


def test_programs_load_no_jax():
    code = ("import sys\n"
            "from benchmarks_torch import pareto_time_mae\n"
            "from examples_torch import pipeline_example, serving_example, simple_example, "
            "visualize_example, _common, _png\n"
            f"print(sorted({{m.split('.')[0] for m in sys.modules}} & {FORBIDDEN!r}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120, check=True).stdout
    assert out.strip() == "[]"
