"""Throughput grid of the port over method × batch × size, each row with its
fidelity.

The counterpart of ``benchmarks/benchmark_grid.py``: for each image size, a
fit on a (1, 3, S, S) uint8 reference (seed 42) through the public API, then for
each batch size the transform of a batch already on the card (seed 123),
timed as called (CUDA events around eager calls on the same fresh batch)
and on the device (a CUDA-graph replay), and the MAE in grey levels against
the numpy oracle on a probe batch of 2 (seed 7), so every speed number
carries its fidelity.

    python -m benchmarks_torch.benchmark_grid --method macenko --batch-size 32 64 128 \\
        --image-size 128 256 512 --runs 10 [--dtype float32] [--json]
"""

from __future__ import annotations

import argparse
import json

from benchmarks_torch import utils
from stainx_tpu_torch import HistogramMatching, Macenko, Reinhard
from stainx_tpu_torch.utils import get_device

NORMALIZERS = {"macenko": Macenko, "reinhard": Reinhard, "histogram_matching": HistogramMatching}


def oracle_probe(method: str, ref, src):
    """The numpy oracle's output for ``src`` under a fit on ``ref``."""
    oracle = utils.load_oracle()
    if method == "macenko":
        return oracle.macenko_transform(src, *oracle.macenko_fit(ref))
    if method == "reinhard":
        return oracle.reinhard_transform(src, *oracle.reinhard_fit(ref))
    return oracle.hm_transform(src, oracle.hm_fit(ref))


def main(argv=None) -> list[dict]:
    """Time each (batch, size) configuration; returns one row each."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--method", default="macenko", type=utils.canonical_method,
                   choices=utils.METHODS)
    p.add_argument("--batch-size", nargs="+", type=int, default=[32, 64, 128])
    p.add_argument("--image-size", nargs="+", type=int, default=[128, 256, 512])
    p.add_argument("--runs", type=int, default=10)
    p.add_argument("--dtype", default="uint8", choices=["uint8", "float32"],
                   help="input dtype: uint8 [0, 255] or float32 [0, 1]")
    p.add_argument("--json", action="store_true", help="one JSON line a configuration")
    utils.add_device_argument(p)
    args = p.parse_args(argv)
    dev = get_device(args.device)
    print(utils.card_stamp(dev), flush=True)

    rows = []
    for size in args.image_size:
        ref = utils.he_batch(1, size, size, 42, dev)  # uint8 whatever the dtype, as in JAX's
        normalizer = NORMALIZERS[args.method](device=dev).fit(ref)
        probe = utils.he_batch(2, size, size, 7, dev, args.dtype, he_scale=1.1)
        probe_out = utils.to_numpy(normalizer.transform(probe))
        expect = oracle_probe(args.method, utils.to_numpy(ref), utils.to_numpy(probe))
        # Grey levels whatever the dtype: float Reinhard and HM give [0, 1].
        scale = 255.0 if args.dtype == "float32" and probe_out.max() <= 1.5 else 1.0
        probe_mae = utils.mae(probe_out * scale, expect * scale)

        for batch_size in args.batch_size:
            src = utils.he_batch(batch_size, size, size, 123, dev, args.dtype, he_scale=1.15)
            called = utils.called_ms(normalizer.transform, src, args.runs)
            busy = utils.busy_ms(normalizer.transform, src, args.runs)
            row = {
                "method": args.method, "dtype": args.dtype, "batch": batch_size, "size": size,
                "img_per_s": batch_size / called * 1e3,
                "mpix_per_s": batch_size * size * size / 1e3 / called,
                "called_ms": called, "busy_ms": busy,
                "idle_share": utils.idle_share(busy, called),
                "mae_vs_oracle": probe_mae, "device": utils.device_name(dev),
            }
            rows.append(row)
            if args.json:
                print(json.dumps(row), flush=True)
            else:
                print(f"{args.method}[{args.dtype}] {batch_size}x3x{size}x{size}: "
                      f"{row['img_per_s']:.1f} img/s {row['mpix_per_s']:.1f} MPix/s, "
                      f"{called:.4f} ms called, {busy:.4f} ms busy, idle share "
                      f"{row['idle_share']:.3f} (MAE {probe_mae:.4f})", flush=True)
    return rows


if __name__ == "__main__":
    main()
