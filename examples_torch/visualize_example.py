"""Fit / transform / visualize on H&E tiles: one method, timed on the card.

The port's counterpart of ``examples/visualize_example.py`` (argparse method
choice, ``--data-dir`` with ``target.png`` and source tiles, a timed
transform, a panel saved per method).

Data: ``--data-dir`` names a directory with a ``target.png`` reference tile
and source tiles (``*.png``: 8-bit RGB or RGBA, read by
``examples_torch/_png.py``, which reads no other format). By default the
committed tiles under ``examples/data/`` (synthetic H&E renders with
background and nuclei, ``examples/make_data.py``) are used; where they are
absent, two in-memory synthetic tiles, so the example always runs.

The transform of every source tile, already on the card, is timed by CUDA
events over ``--runs`` passes (on ``--device cpu``, by the host's clock,
the kernels' plain versions). ``--save-plots`` writes the panel, the
reference and the sources on the top row and the normalized tiles below,
as ``normalization_results_<method>.png`` in ``--output-dir`` (default
``examples_torch/output/``).

Run::

    python examples_torch/visualize_example.py macenko --save-plots
    python examples_torch/visualize_example.py reinhard --data-dir /path/to/tiles
"""

from __future__ import annotations

import argparse
import glob
import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np
import torch

from examples_torch._common import DATA_DIR, ROOT, add_device_argument, load_nchw, timed_ms
from examples_torch._png import write_png
from examples_torch.simple_example import synthetic_tile, to_u8
from stainx_tpu_torch import HistogramMatching, Macenko, Reinhard
from stainx_tpu_torch.utils import get_device

_METHODS = {"reinhard": Reinhard, "macenko": Macenko, "histogram_matching": HistogramMatching}


def discover_data(data_dir: str | None) -> tuple[np.ndarray, list[np.ndarray], list[str], str]:
    """Return (reference, [sources...], names, origin): ``data_dir``, else
    the committed tiles, else two synthetic tiles."""
    if data_dir is None and os.path.isfile(os.path.join(DATA_DIR, "target.png")):
        data_dir = DATA_DIR
    if data_dir and os.path.isfile(os.path.join(data_dir, "target.png")):
        ref = load_nchw(os.path.join(data_dir, "target.png"))
        paths = sorted(p for p in glob.glob(os.path.join(data_dir, "*.png"))
                       if os.path.basename(p) != "target.png")
        if paths:
            names = [os.path.basename(p) for p in paths]
            return ref, [load_nchw(p) for p in paths], names, data_dir

    ref = synthetic_tile(256, 256, seed=42)
    srcs = [synthetic_tile(256, 256, seed=s, he_scale=1.2) for s in (7, 8)]
    return ref, srcs, [f"synthetic_{i}" for i in range(len(srcs))], "synthetic"


def panel(ref: np.ndarray, sources: list[np.ndarray], results: list[np.ndarray]) -> np.ndarray:
    """(2H, (n + 1)W, 3) uint8: the reference and the sources on the top row,
    the normalized tiles below them; tiles of other sizes padded white."""
    h = max(t.shape[2] for t in [ref, *sources])
    w = max(t.shape[3] for t in [ref, *sources])
    grid = np.full((2 * h, (len(sources) + 1) * w, 3), 255, np.uint8)
    for row, tiles in enumerate([[ref, *sources], [None, *results]]):
        for col, tile in enumerate(tiles):
            if tile is not None:
                hwc = np.transpose(tile[0], (1, 2, 0))
                grid[row * h:row * h + hwc.shape[0], col * w:col * w + hwc.shape[1]] = hwc
    return grid


def main(argv=None) -> dict:
    """Fit, time the transforms, optionally write the panel; returns the
    results and the time."""
    parser = argparse.ArgumentParser(description="Fit/transform/visualize one stainx_tpu_torch "
                                                 "method")
    parser.add_argument("method", choices=["reinhard", "macenko", "histogram_matching"])
    parser.add_argument("--data-dir", default=None, help="directory with target.png + source tiles")
    parser.add_argument("--runs", type=int, default=5)
    parser.add_argument("--save-plots", action="store_true")
    parser.add_argument("--output-dir", default=None)
    add_device_argument(parser)
    args = parser.parse_args(argv)
    dev = get_device(args.device)

    ref, sources, names, origin = discover_data(args.data_dir)
    print(f"data: {os.path.relpath(origin, ROOT) if origin != 'synthetic' else origin} — "
          f"reference {ref.shape}, {len(sources)} source tile(s)")

    normalizer = _METHODS[args.method](device=dev)
    print(f"method: {args.method}  device: {dev}"
          + (f" ({torch.cuda.get_device_name(dev)})" if dev.type == "cuda" else ""))
    normalizer.fit(ref)
    on_device = [torch.from_numpy(s).to(dev) for s in sources]

    def transform_all():
        return [normalizer.transform(s) for s in on_device]

    transform_all()  # the first call on the card builds the kernels
    _, ms = timed_ms(lambda: [transform_all() for _ in range(args.runs)], dev)
    per_run = ms / args.runs
    results = [to_u8(r) for r in transform_all()]
    total_px = sum(s.shape[2] * s.shape[3] for s in sources)
    clock = "CUDA events" if dev.type == "cuda" else "the host's clock"
    print(f"transform: {per_run:.4f} ms/run ({total_px / per_run / 1e3:.1f} MPix/s; {clock}, "
          f"tiles already on the {dev.type}, {args.runs} runs)")

    out_path = None
    if args.save_plots:
        out_dir = args.output_dir or os.path.join(ROOT, "examples_torch", "output")
        os.makedirs(out_dir, exist_ok=True)
        out_path = os.path.join(out_dir, f"normalization_results_{args.method}.png")
        write_png(out_path, panel(ref, sources, results))
        print(f"saved panel: {out_path} (top: reference, {', '.join(names)}; below: "
              f"{args.method})")
    return {"reference": ref, "sources": sources, "names": names, "results": results,
            "ms_per_run": per_run, "panel": out_path}


if __name__ == "__main__":
    main()
