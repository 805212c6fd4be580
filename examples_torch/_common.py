"""What the port's examples share: the committed tiles, the device option,
a timer that reads the card's clock, and a runner for the notebook's code
cells. Example support code, not a package API.
"""

from __future__ import annotations

import ast
import json
import os
import time

import numpy as np
import torch

from examples_torch._png import read_png

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA_DIR = os.path.join(ROOT, "examples", "data")  # the committed tiles (examples/make_data.py)
NOTEBOOK = os.path.join(ROOT, "examples_torch", "quickstart_notebook.ipynb")


def load_nchw(path: str) -> np.ndarray:
    """A PNG tile as a contiguous (1, 3, H, W) uint8 array."""
    return np.ascontiguousarray(np.transpose(read_png(path), (2, 0, 1))[None])


def add_device_argument(parser) -> None:
    parser.add_argument("--device", default="cuda:0",
                        help="cuda[:i] (default cuda:0; raises without CUDA) or cpu, which runs "
                             "the kernels' plain PyTorch versions")


def timed_ms(call, device: torch.device):
    """``(call(), ms)``: on the card, CUDA events recorded on the current
    stream around the call, waited for; on the CPU, the host's clock."""
    if device.type != "cuda":
        t0 = time.perf_counter()
        result = call()
        return result, (time.perf_counter() - t0) * 1e3
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    result = call()
    end.record()
    end.synchronize()
    return result, start.elapsed_time(end)


def run_notebook(path: str = NOTEBOOK, after_first: dict | None = None, out=print) -> dict:
    """Run a notebook's code cells in order in one namespace, as a kernel
    does, and return the namespace. ``after_first`` updates the namespace
    after the first code cell (a host without a card sets ``DEVICE`` to
    ``"cpu"`` there). A cell that ends in an expression has its value's
    ``repr`` passed to ``out``, as a notebook displays it."""
    with open(path) as f:
        cells = [c for c in json.load(f)["cells"] if c["cell_type"] == "code"]
    namespace = {"__name__": "__main__"}
    for i, cell in enumerate(cells):
        tree = ast.parse("".join(cell["source"]))
        last = tree.body.pop() if tree.body and isinstance(tree.body[-1], ast.Expr) else None
        exec(compile(tree, f"<cell {i + 1}>", "exec"), namespace)
        if last is not None:
            value = eval(compile(ast.Expression(last.value), f"<cell {i + 1}>", "eval"), namespace)
            if value is not None:
                out(repr(value))
        if i == 0 and after_first:
            namespace.update(after_first)
    return namespace
