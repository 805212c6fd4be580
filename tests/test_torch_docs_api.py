"""Sync gate of the port's generated API reference.

The counterpart of ``tests/test_docs_api.py`` for ``docs_torch/api/*.md``,
which ``docs_torch/gen_api.py`` renders from the live docstrings of
``stainx_tpu_torch``: the pages are regenerated in memory and every
committed page must be there, current, and generated (no orphan). The
generator is also run in a fresh interpreter, which must end with neither
JAX nor ``stainx_tpu`` imported.
"""

from __future__ import annotations

import importlib.util
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GENERATOR = os.path.join(ROOT, "docs_torch", "gen_api.py")


def _generator():
    """The generator as a module of its own name (``tests/test_docs_api.py``
    imports ``docs/gen_api.py`` as ``gen_api``)."""
    spec = importlib.util.spec_from_file_location("docs_torch_gen_api", GENERATOR)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_api_pages_in_sync():
    gen_api = _generator()
    pages = gen_api.build_pages()
    assert pages, "generator produced no pages"
    missing, stale = [], []
    for name, body in pages.items():
        path = os.path.join(gen_api.OUT_DIR, name)
        if not os.path.isfile(path):
            missing.append(name)
            continue
        with open(path) as f:
            if f.read() != body:
                stale.append(name)
    orphans = sorted(set(os.listdir(gen_api.OUT_DIR)) - set(pages))
    assert not (missing or stale or orphans), (
        f"docs_torch/api out of sync — regenerate with `python docs_torch/gen_api.py`. "
        f"missing={missing} stale={stale} orphans={orphans}"
    )


def test_pages_cover_the_port_and_inherit_nothing_from_torch():
    pages = _generator().build_pages()
    assert sorted(pages) == sorted(
        ["index.md", "macenko.md", "reinhard.md", "histogram_matching.md", "base.md",
         "transform.md", "parallel.md", "ops.md", "kernels.md", "io.md", "utils.md"])
    index = " ".join(pages["index.md"].split())
    assert "backends.md" not in index and "the device decides the route" in index
    for name in ("masked_nearest_rank_percentile", "percentile_all"):
        assert f"stainx_tpu_torch.ops.percentile.{name}(" in pages["ops.md"]
    for wrapper in ("macenko_transform_mega", "macenko_fit_stream", "kth_smallest_pallas",
                    "kth_smallest_streaming", "reinhard_apply", "histogram_256", "apply_lut"):
        assert f"Kernel wrapper `{wrapper}`" in pages["kernels.md"]
        assert f"Its plain version: `{wrapper}_plain(" in pages["kernels.md"]
    for member in ("register_buffer", "state_dict", "zero_grad", "### `train("):
        assert member not in pages["transform.md"]
    assert "### `forward(self, img: Any) -> torch.Tensor`" in pages["transform.md"]
    assert all("*(no docstring)*" not in body for body in pages.values())


def test_generator_imports_neither_jax_nor_stainx_tpu():
    code = (
        "import runpy, sys\n"
        f"module = runpy.run_path({GENERATOR!r})\n"
        "assert module['build_pages']()\n"
        "roots = ('jax', 'jaxlib', 'stainx_tpu')\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in roots))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    done = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=ROOT,
                          env=env, timeout=300)
    assert done.returncode == 0, done.stderr[-4000:]
    assert done.stdout.strip().splitlines()[-1] == "[]", done.stdout[-2000:]
