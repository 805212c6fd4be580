"""Fit / transform on synthetic H&E tiles, and a side-by-side panel as PNG.

The port's counterpart of ``examples/simple_example.py``: fit a normalizer
on a synthetic reference tile, transform a source tile whose staining
drifted, and write the panel source | reference | normalized as an RGB PNG
(``examples_torch/_png.py``; no matplotlib). Runs on ``cuda:0`` by default
and raises without CUDA; ``--device cpu`` runs the kernels' plain versions.

Run: ``python examples_torch/simple_example.py [--method macenko] [--size 256]
[--out normalized.png] [--device cuda:0]``
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np

from examples_torch._common import add_device_argument
from examples_torch._png import write_png
from stainx_tpu_torch import HistogramMatching, Macenko, Reinhard
from stainx_tpu_torch.utils import get_device

_METHODS = {"macenko": Macenko, "reinhard": Reinhard, "histogram_matching": HistogramMatching}


def synthetic_tile(h: int, w: int, seed: int, he_scale: float = 1.0) -> np.ndarray:
    """(1, 3, h, w) uint8 Beer–Lambert H&E tile with 8×8-pixel concentration
    blocks (the JAX example's own tile, made from the same seed)."""
    rng = np.random.default_rng(seed)
    he = np.array([[0.5626, 0.2159], [0.7201, 0.8012], [0.4062, 0.5581]], np.float32) * he_scale
    gh, gw = h // 8, w // 8
    coarse = rng.random((2, gh, gw), np.float32)
    conc = np.stack(
        [
            0.3 + 1.8 * np.kron(coarse[0], np.ones((8, 8), np.float32)),
            0.2 + 1.0 * np.kron(coarse[1], np.ones((8, 8), np.float32)),
        ]
    ).reshape(2, -1)
    od = he @ conc
    return np.clip(240.0 * np.exp(-od), 0, 255).astype(np.uint8).reshape(1, 3, h, w)


def to_u8(images) -> np.ndarray:
    """A tensor or array of grey levels as uint8 (a float result clipped)."""
    a = images.detach().cpu().numpy() if hasattr(images, "detach") else np.asarray(images)
    return a if a.dtype == np.uint8 else np.clip(a, 0, 255).astype(np.uint8)


def main(argv=None) -> dict:
    """Fit, transform and write the panel; returns the result and the panel."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--method", default="macenko", choices=sorted(_METHODS))
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--out", default="normalized.png")
    add_device_argument(p)
    args = p.parse_args(argv)
    dev = get_device(args.device)

    reference = synthetic_tile(args.size, args.size, seed=42)
    source = synthetic_tile(args.size, args.size, seed=123, he_scale=1.3)

    normalizer = _METHODS[args.method](device=dev)
    print(f"{args.method}: device={normalizer.device}")
    result = to_u8(normalizer.fit(reference).transform(source))
    print(f"fitted state: { {k: tuple(v.shape) for k, v in normalizer.state.items()} }")

    panel = np.concatenate([source[0], reference[0], result[0]], axis=2)  # (3, H, 3W)
    hwc = np.ascontiguousarray(np.transpose(panel, (1, 2, 0)))
    write_png(args.out, hwc)
    print(f"wrote {args.out} (source | reference | {args.method}-normalized)")
    return {"result": result, "panel": hwc, "out": args.out}


if __name__ == "__main__":
    main()
