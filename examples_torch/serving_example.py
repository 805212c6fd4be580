"""Sequential-tile serving: one tile a ``Macenko.transform`` call.

The port's counterpart of ``examples/serving_example.py``. The
training-side examples batch tiles; a serving endpoint usually gets them
one at a time. Here a normalizer is fitted once, then ``--tiles`` distinct
tiles (deterministic Beer–Lambert renders with background and nuclei, the
generator of ``examples/make_data.py``) are normalized in turn, one tile a
call, each already on the card, and each call is timed by CUDA events on
the current stream (on ``--device cpu``, by the host's clock, the kernels'
plain versions). A process's first call builds the kernels; the steady
median leaves out the first two calls, as the JAX example does.

Each call runs the whole per-tile transform as one C call on the card
(B1 or B4 by the tile's size, ``stainx_tpu_torch/ops/macenko.py``). The
JAX package's ``pallas`` backend carries a descent-seed state from call to
call; the port keeps that ``(7,)`` int32 ``seed_state`` argument and passes
it through unchanged (its selections are exact and start from each row's
own extremes), so no call depends on the one before.

Run: ``python examples_torch/serving_example.py [--tiles N] [--size S] [--device cuda:0]``
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np
import torch

from examples_torch._common import add_device_argument, timed_ms
from stainx_tpu_torch import Macenko
from stainx_tpu_torch.utils import get_device

IO = 240.0
HE_REF = np.array([[0.5626, 0.2159], [0.7201, 0.8012], [0.4062, 0.5581]], dtype=np.float64)


def _smooth(h: int, w: int, rng: np.random.Generator, cells: int) -> np.ndarray:
    """Low-frequency [0, 1] field: coarse noise, bilinearly upsampled."""
    gh, gw = max(h // cells, 2), max(w // cells, 2)
    coarse = rng.random((gh, gw)).astype(np.float64)
    yy = np.linspace(0, gh - 1, h)
    xx = np.linspace(0, gw - 1, w)
    y0 = np.clip(np.floor(yy).astype(int), 0, gh - 2)
    x0 = np.clip(np.floor(xx).astype(int), 0, gw - 2)
    fy = (yy - y0)[:, None]
    fx = (xx - x0)[None, :]
    return (
        coarse[np.ix_(y0, x0)] * (1 - fy) * (1 - fx)
        + coarse[np.ix_(y0 + 1, x0)] * fy * (1 - fx)
        + coarse[np.ix_(y0, x0 + 1)] * (1 - fy) * fx
        + coarse[np.ix_(y0 + 1, x0 + 1)] * fy * fx
    )


def synthetic_tile(size: int, seed: int) -> np.ndarray:
    """(3, size, size) uint8 H&E tile with stroma, nuclei and background:
    ``examples/make_data.py::make_tile(seed, size, size)`` with its default
    stain scale, background share and no rotation, made from the same seed."""
    rng = np.random.default_rng(seed)
    c_e = 0.25 + 1.1 * _smooth(size, size, rng, 48) + 0.25 * _smooth(size, size, rng, 12)
    c_h = 0.15 + 0.5 * _smooth(size, size, rng, 48)
    nuc = _smooth(size, size, rng, 6)
    nuc_mask = nuc > np.quantile(nuc, 0.82)
    c_h = np.where(nuc_mask, c_h + 1.4 + 0.8 * _smooth(size, size, rng, 6), c_h)
    c_e = np.where(nuc_mask, c_e * 0.45, c_e)
    c_h *= 1.0 + 0.12 * (rng.standard_normal((size, size)) * 0.5)
    c_e *= 1.0 + 0.12 * (rng.standard_normal((size, size)) * 0.5)
    c_h = np.clip(c_h, 0.0, None)
    c_e = np.clip(c_e, 0.0, None)
    bg = _smooth(size, size, rng, 96)
    t = np.clip((bg - np.quantile(bg, 0.15)) / 0.08, 0.0, 1.0)
    fade = t * t * (3 - 2 * t)
    od = np.einsum("ij,jhw->ihw", HE_REF, np.stack([c_h * fade, c_e * fade]))
    rgb = np.clip(IO * np.exp(-od) + rng.standard_normal((3, size, size)) * 0.8, 0, 255)
    return rgb.round().astype(np.uint8)


def main(argv=None) -> dict:
    """Serve the tiles; returns each call's ms and output."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--tiles", type=int, default=8)
    p.add_argument("--size", type=int, default=96)
    add_device_argument(p)
    args = p.parse_args(argv)
    dev = get_device(args.device)

    norm = Macenko(device=dev)
    norm.fit(synthetic_tile(args.size, seed=0)[None])
    tiles = [torch.from_numpy(synthetic_tile(args.size, seed=1 + i)[None]).to(dev)
             for i in range(args.tiles)]

    times, outputs = [], []
    for tile in tiles:  # one tile a transform() call
        out, ms = timed_ms(lambda t=tile: norm.transform(t), dev)
        if out.shape != tile.shape or out.dtype != tile.dtype:
            raise RuntimeError(f"a tile came back {tuple(out.shape)} {out.dtype}")
        times.append(ms)
        outputs.append(out)

    steady = times[2:] or times
    clock = "CUDA events" if dev.type == "cuda" else "the host's clock"
    print(f"served {args.tiles} {args.size}x{args.size} tiles on {dev}: first {times[0]:.3f} ms "
          f"(the first call; it builds the kernels if none are built yet), steady median "
          f"{np.median(steady):.4f} ms/tile ({clock})")
    return {"times_ms": times, "outputs": outputs, "tiles": tiles}


if __name__ == "__main__":
    main()
