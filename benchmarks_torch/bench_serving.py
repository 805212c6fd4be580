"""One tile a call: the port's serving throughput on distinct tiles.

The counterpart of ``benchmarks/bench_serving.py``. A serving endpoint
normalizes one tile a request: one public ``Macenko.transform`` call on a
(1, 3, S, S) uint8 tile already on the card, after a fit on a 512²
reference (seed 42). ``--tiles`` distinct tiles (seeds 100, 101, ...)
cycle through the calls, as a slide's tile stream does; each is a fresh
input, never an output fed back. Reported a size: ms a tile as called
(CUDA events around the eager calls, the median of 3 rounds), busy ms a
tile (CUDA graphs of one call a tile, replayed), the idle share, MPix/s as
called, the kernel the call launches (B4 or B1 by the route ladder; on the
card it must launch that kernel once and nothing else) and, for B4, its
route (``kernels/macenko_stream.py::route``: a thread-block cluster a row,
or the streamed route). Every tile's output must repeat bit for bit on the
next pass through the cycle; the script exits 1 if one does not.

    python -m benchmarks_torch.bench_serving --size 512 2048 4096 --tiles 8 --runs 16 [--json]

The JAX script's ``--he-step`` and its seed-carry arm are not ported: the
port carries no seed state from call to call.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from benchmarks_torch import utils
from stainx_tpu_torch import Macenko, kernels
from stainx_tpu_torch.kernels import macenko_stream
from stainx_tpu_torch.ops.macenko import CPU_ROUTE_SMEM, transform_route
from stainx_tpu_torch.utils import get_device


def tile_route(size: int, device: torch.device) -> tuple[str, str | None]:
    """The kernel one uint8 tile of ``size``² pixels goes to (B4 or B1, by
    the route ladder of ``ops/macenko.py``) and, for B4, its route. The CPU
    takes an H100's routes and runs their plain versions."""
    if transform_route(1, size * size, torch.uint8) != "stream":
        return "B1", None
    smem = kernels.device_limits(device.index)[1] if device.type == "cuda" else CPU_ROUTE_SMEM
    return "B4", macenko_stream.route(size * size, torch.uint8, smem)


def main(argv=None) -> list[dict]:
    """Time one tile a call at each size; returns one row a size."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--size", nargs="+", type=int, default=[4096])
    p.add_argument("--tiles", type=int, default=8, help="distinct tiles in the cycle")
    p.add_argument("--runs", type=int, default=16)
    p.add_argument("--json", action="store_true")
    utils.add_device_argument(p)
    args = p.parse_args(argv)
    dev = get_device(args.device)
    print(utils.card_stamp(dev), flush=True)

    normalizer = Macenko(device=dev).fit(utils.he_batch(1, 512, 512, 42, dev))
    rows = []
    for size in args.size:
        tiles = [utils.he_batch(1, size, size, 100 + k, dev) for k in range(args.tiles)]
        kernel, route = tile_route(size, dev)
        _, launches = utils.count_launches(lambda t=tiles[0]: normalizer.transform(t))
        if dev.type == "cuda" and launches != {kernel: 1}:
            raise RuntimeError(f"a {size}^2 tile launched {launches}, not {kernel} once")
        first = [normalizer.transform(t) for t in tiles]
        repeats = all(torch.equal(normalizer.transform(t), out) for t, out in zip(tiles, first))
        del first
        called = utils.called_ms(normalizer.transform, tiles, args.runs)
        busy = utils.busy_ms(normalizer.transform, tiles, args.runs)
        row = {
            "mode": "serving(distinct-tile cycle)", "size": size, "tiles": args.tiles,
            "called_ms_per_tile": called, "busy_ms_per_tile": busy,
            "idle_share": utils.idle_share(busy, called),
            "mpix_per_s": size * size / 1e3 / called, "launches": launches,
            "kernel": kernel, "b4_route": route,
            "repeat_bit_identical": repeats, "device": utils.device_name(dev),
        }
        rows.append(row)
        del tiles
        if args.json:
            print(json.dumps(row), flush=True)
        else:
            print(f"serving 1x3x{size}^2 u8 over {args.tiles} distinct tiles: {called:.4f} ms/tile "
                  f"called, {busy:.4f} ms busy, idle share {row['idle_share']:.3f}, "
                  f"{row['mpix_per_s']:.1f} MPix/s, {kernel} ({route or 'one block a row'}), "
                  f"launches {launches}, repeats bit for bit: {repeats}", flush=True)
    return rows


if __name__ == "__main__":
    sys.exit(0 if all(row["repeat_bit_identical"] for row in main()) else 1)
