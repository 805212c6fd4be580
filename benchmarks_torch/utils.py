"""The port's measuring protocol: timing, the card's stamp, data, MAE.

Counterpart of ``benchmarks/utils.py`` for eager PyTorch. Every timed call
re-processes the same fresh input (or cycles a list of distinct inputs);
an output is never fed back as the next input, since re-normalized tiles
change the selections' work (``bench.py`` says why), and the multi-block
Macenko kernels start their selections from the extremes' common prefix,
so the input's distribution sets their time.

- ``called_ms``: the time a caller sees, CUDA events on the current stream
  around eager calls, the median of a few rounds;
- ``busy_ms``: the device's time for the same call, replayed from a CUDA
  graph, without the host's cost of issuing it;
- ``idle_share = 1 - busy / called``.

On a CPU tensor the same functions time with ``time.perf_counter`` and
capture no graph: there the host is the device, and ``busy_ms`` is the
called time of one round. Every result names the device it ran on
(``device_name``).
"""

from __future__ import annotations

import functools
import importlib.util
import statistics
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from stainx_tpu_torch.kernels import (
    histogram,
    macenko_fused,
    macenko_stream,
    reinhard_fused,
    selection,
    selection_stream,
)
from stainx_tpu_torch.testing import synthetic_he_batch

ROOT = Path(__file__).resolve().parent.parent

# Each kernel's short name and its wrapper, whose ``launches`` attribute
# counts the launches it makes.
KERNELS = {
    "B1": macenko_fused.macenko_transform_mega,
    "B2": macenko_fused.macenko_fit_mega,
    "B3": selection.kth_smallest_pallas,
    "B4": macenko_stream.macenko_transform_stream,
    "B5": macenko_stream.macenko_fit_stream,
    "B6": selection_stream.kth_smallest_streaming,
    "B7a": reinhard_fused.reinhard_apply,
    "B7b": reinhard_fused.reinhard_moments,
    "B8a": histogram.histogram_256,
    "B8b": histogram.apply_lut,
}
METHODS = ("macenko", "reinhard", "histogram_matching")


def _inputs(inputs) -> list:
    """One tensor, re-processed every call, or a list cycled in order."""
    return [inputs] if torch.is_tensor(inputs) else list(inputs)


def event_ms(fn, inputs, iters: int) -> float:
    """Mean ms per call of ``fn`` over ``iters`` calls cycling ``inputs``,
    after one warm-up call on each input, timed with CUDA events."""
    for x in inputs:
        fn(x)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(inputs[i % len(inputs)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def capture_graphs(fn, inputs) -> list:
    """One CUDA graph of ``fn`` per input, captured after a warm-up call."""
    for x in inputs:
        fn(x)
    torch.cuda.synchronize()
    graphs = []
    for x in inputs:
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            fn(x)
        graphs.append(graph)
    return graphs


def replay_ms(graphs, iters: int) -> float:
    """Mean ms per replay over ``iters`` replays cycling ``graphs``, after
    one replay of each."""
    for graph in graphs:
        graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        graphs[i % len(graphs)].replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, inputs, iters: int) -> float:
    """Mean ms per call of ``fn`` replayed from CUDA graphs, one captured
    per input: the device's time for the call's launches, without the
    host's cost of issuing them."""
    return replay_ms(capture_graphs(fn, inputs), iters)


def _host_ms(fn, inputs: list, runs: int) -> float:
    """Mean ms per call over ``runs`` calls cycling ``inputs``, on the
    host's clock, after one warm-up call on each input."""
    for x in inputs:
        fn(x)
    t0 = time.perf_counter()
    for i in range(runs):
        fn(inputs[i % len(inputs)])
    return (time.perf_counter() - t0) * 1e3 / runs


def called_ms(fn, inputs, runs: int, rounds: int = 3, warmup: int = 1) -> float:
    """Median over ``rounds`` of the mean ms per eager call of ``fn``, each
    round ``runs`` calls on ``inputs`` (a tensor re-processed every call, or
    a list cycled) after a warm-up call on each input; before the first
    round, ``warmup`` more calls on each (the first builds the kernels)."""
    inputs = _inputs(inputs)
    for _ in range(warmup):
        for x in inputs:
            fn(x)
    timed = event_ms if inputs[0].is_cuda else _host_ms
    return statistics.median(timed(fn, inputs, runs) for _ in range(rounds))


def busy_ms(fn, inputs, runs: int) -> float:
    """The device's ms per call of ``fn``: on the card, ``runs`` replays of
    CUDA graphs captured after a warm-up (one a distinct input); on the CPU,
    ``runs`` eager calls on the host's clock."""
    inputs = _inputs(inputs)
    return (graph_ms if inputs[0].is_cuda else _host_ms)(fn, inputs, runs)


def idle_share(busy: float, called: float) -> float:
    """The share of the called time in which the device did no work."""
    return 1.0 - busy / called


def device_name(device: torch.device) -> str:
    """The card's name (``torch.cuda.get_device_name``), or ``"cpu"``."""
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def card_stamp(device: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` prints them, and torch's and CUDA's
    versions; on the CPU, a line that says no card was used."""
    if device.type != "cuda":
        return f"cpu (no card; the kernels' plain versions), torch {torch.__version__}"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip().splitlines()
    return (f"{smi[min(device.index or 0, len(smi) - 1)]}; torch {torch.__version__}, "
            f"CUDA {torch.version.cuda}")


def to_numpy(x) -> np.ndarray:
    """A tensor (on any device) or array-like as a numpy array."""
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def mae(a, b) -> float:
    """Mean absolute difference of two arrays or tensors, in float32."""
    return float(np.abs(to_numpy(a).astype(np.float32) - to_numpy(b).astype(np.float32)).mean())


def he_batch(n: int, h: int, w: int, seed: int, device: torch.device, dtype: str = "uint8",
             he_scale: float = 1.0) -> torch.Tensor:
    """``synthetic_he_batch`` on ``device``: uint8, or float32 in [0, 1]."""
    x = torch.from_numpy(synthetic_he_batch(n, h, w, seed=seed, he_scale=he_scale))
    x = x.to(device)
    return x.float() / 255.0 if dtype == "float32" else x


@functools.cache
def load_oracle():
    """The numpy oracle, ``tests/oracles/numpy_reference.py`` (numpy only),
    loaded from its file: ``tests`` is no package, and an installed one of
    that name may shadow it."""
    path = ROOT / "tests" / "oracles" / "numpy_reference.py"
    spec = importlib.util.spec_from_file_location("stainx_numpy_oracle", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def count_launches(call):
    """``(call(), {kernel: launches})``: every wrapper's count set to 0 just
    before the call and read just after it (the card synchronized). Kernels
    that did not launch are left out; on the CPU, where the wrappers run
    their plain versions, nothing launches."""
    for wrapper in KERNELS.values():
        wrapper.launches = 0
    result = call()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return result, {name: w.launches for name, w in KERNELS.items() if w.launches}


def canonical_method(name: str) -> str:
    """argparse ``type=``: ``hm`` names histogram matching."""
    return "histogram_matching" if name == "hm" else name


def add_device_argument(parser) -> None:
    parser.add_argument("--device", default="cuda:0",
                        help="cuda[:i] (default cuda:0; raises without CUDA) or cpu, which runs "
                             "the kernels' plain PyTorch versions")
