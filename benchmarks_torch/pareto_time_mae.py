"""Fidelity against throughput: each series' (img/s, MAE against the numpy
oracle) on the reference protocol, a 128×3×256² uint8 batch.

The counterpart of ``benchmarks/pareto_time_mae.py``, with the same
protocol: a fit on a 1×3×256² uint8 reference (seed 42) through the public
API, then the transform of a 128×3×256² uint8 batch (seed 123,
``he_scale`` 1.15) already on the card, timed as called (CUDA events around
eager calls on the same fresh batch, the median of 3 rounds of ``--runs``
calls), and its MAE in grey levels against the numpy oracle
(``tests/oracles/numpy_reference.py``) on the whole batch. Series:

- ``numpy_oracle_cpu``: the oracle's transform on the host (single-threaded
  float64 numpy, the CPU floor), timed once; its MAE is 0 by definition;
- Macenko ``cuda_stable`` and ``cuda_fast`` (``precision="fast"``); on
  uint8 input both run the same exact kernels (B5 for the fit, B4 for the
  transform), so the two series differ only by the run's noise;
- Reinhard ``cuda`` and histogram matching ``cuda``. The JAX script's
  ``tpu_pallas`` series has no counterpart: the port's HM transform is one
  C call on the card (B8a, its finalize, B8b), whatever the caller asks.

On ``--device cpu`` the series are named after the CPU (``cpu_stable``,
``cpu_fast``, ``cpu``): the kernels' plain versions, no card.

The JAX script's external peer series, ``reference-torch-cpu`` (the
reference package itself on torch's CPU, through
``tests/oracles/reference_torch.py``), runs here on the same condition as
there: only where that module finds the reference package. The repository
does not hold that package, so the series is absent wherever the
repository alone is checked out, the card's machine included.

    python -m benchmarks_torch.pareto_time_mae --method macenko --runs 10 [--json]
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import time

import numpy as np

from benchmarks_torch import utils
from stainx_tpu_torch import HistogramMatching, Macenko, Reinhard
from stainx_tpu_torch.utils import get_device

BATCH = 128
SIZE = 256
PEER_RUNS = 3  # the peer series' timed calls, as in the JAX script


def _oracle(method: str, ref: np.ndarray):
    """The numpy oracle's transform under a fit on ``ref``."""
    oracle = utils.load_oracle()
    if method == "macenko":
        he, mc = oracle.macenko_fit(ref)
        return lambda s: oracle.macenko_transform(s, he, mc)
    if method == "reinhard":
        params = oracle.reinhard_fit(ref)
        return lambda s: oracle.reinhard_transform(s, *params)
    hists = oracle.hm_fit(ref)
    return lambda s: oracle.hm_transform(s, hists)


def _reference_torch():
    """``tests/oracles/reference_torch.py``, loaded from its file (``tests``
    is no package)."""
    path = utils.ROOT / "tests" / "oracles" / "reference_torch.py"
    spec = importlib.util.spec_from_file_location("stainx_reference_torch", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _peer(method: str, ref: np.ndarray, src: np.ndarray):
    """The reference package's transform of ``src`` (fit done here, outside
    the timed calls), or None where the package is not found."""
    ref_torch = _reference_torch()
    if not ref_torch.available():
        return None
    if method == "macenko":
        he_r, mc_r = ref_torch.macenko_fit(ref)
        return lambda: ref_torch.macenko_transform(src, he_r, mc_r)
    fitted = (ref_torch.reinhard_fitted if method == "reinhard"
              else ref_torch.histogram_matching_fitted)(ref)
    return lambda: fitted(src)


def main(argv=None) -> list[dict]:
    """Print one row a series; returns the rows."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--method", default="macenko", type=utils.canonical_method,
                   choices=utils.METHODS)
    p.add_argument("--runs", type=int, default=10)
    p.add_argument("--json", action="store_true", help="one JSON line a series")
    utils.add_device_argument(p)
    args = p.parse_args(argv)
    dev = get_device(args.device)
    print(utils.card_stamp(dev), flush=True)

    ref = utils.he_batch(1, SIZE, SIZE, 42, dev)
    src = utils.he_batch(BATCH, SIZE, SIZE, 123, dev, he_scale=1.15)
    ref_np, src_np = utils.to_numpy(ref), utils.to_numpy(src)

    oracle_fn = _oracle(args.method, ref_np)
    t0 = time.perf_counter()
    expected = oracle_fn(src_np)
    oracle_secs = time.perf_counter() - t0
    rows = [{"mode": "numpy_oracle_cpu", "img_per_s": BATCH / oracle_secs,
             "ms_per_batch": oracle_secs * 1e3, "mae": 0.0, "launches": {}, "device": "cpu"}]

    def device_mode(name, normalizer):
        out, launches = utils.count_launches(lambda: normalizer.transform(src))
        ms = utils.called_ms(normalizer.transform, src, args.runs)
        rows.append({"mode": f"{dev.type}{name}", "img_per_s": BATCH / ms * 1e3,
                     "ms_per_batch": ms, "mae": utils.mae(out, expected), "launches": launches,
                     "device": utils.device_name(dev)})

    if args.method == "macenko":
        device_mode("_stable", Macenko(device=dev).fit(ref))
        device_mode("_fast", Macenko(device=dev, precision="fast").fit(ref))
    else:
        cls = Reinhard if args.method == "reinhard" else HistogramMatching
        device_mode("", cls(device=dev).fit(ref))

    peer = _peer(args.method, ref_np, src_np)
    if peer is not None:
        peer_out = peer()  # first-call effects, outside the timed calls
        t0 = time.perf_counter()
        for _ in range(PEER_RUNS):
            peer_out = peer()
        peer_secs = (time.perf_counter() - t0) / PEER_RUNS
        rows.append({"mode": "reference-torch-cpu", "img_per_s": BATCH / peer_secs,
                     "ms_per_batch": peer_secs * 1e3, "mae": utils.mae(peer_out, expected),
                     "launches": {}, "device": "cpu"})

    for row in rows:
        row["method"] = args.method
        if args.json:
            print(json.dumps(row), flush=True)
        else:
            print(f"{row['method']:<20} {row['mode']:<20} {row['img_per_s']:>14.2f} img/s "
                  f"({row['ms_per_batch']:.4f} ms a batch of {BATCH})  MAE {row['mae']:.6f}  "
                  f"launches {row['launches']}", flush=True)
    return rows


if __name__ == "__main__":
    main()
