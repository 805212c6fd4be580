"""Batch-mode (fit every forward) throughput of the port, all three methods.

The counterpart of ``benchmarks/bench_batch_mode.py``. In batch mode the
training transform re-fits on the batch's designated reference image every
forward, then transforms the batch: here
``StainNormalizerTransform(method, mode="batch")`` on a batch already on
the card, timed as called (CUDA events around eager forwards, each on the
same fresh batch) and on the device (a CUDA-graph replay of one forward),
with the idle share and the kernels one forward launches. ``--pooled``
fits Macenko on the whole batch (``batch_ref_index=None``); the other
methods have no pooled row.

    python -m benchmarks_torch.bench_batch_mode --batch 256 --size 224 \\
        --dtype float32 --runs 20 [--method macenko] [--pooled] [--json]

The JAX script's ``--no-carry`` is not ported: the port's kernels run a
batch's images in parallel and carry no seed state from call to call.
"""

from __future__ import annotations

import argparse
import json

from benchmarks_torch import utils
from stainx_tpu_torch import StainNormalizerTransform
from stainx_tpu_torch.utils import get_device


def main(argv=None) -> list[dict]:
    """Time each method's batch-mode forward; returns one row a method."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--method", default=None, type=utils.canonical_method, choices=utils.METHODS,
                   help="default: all three")
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--size", type=int, default=224)
    p.add_argument("--dtype", default="uint8", choices=["uint8", "float32"])
    p.add_argument("--runs", type=int, default=20)
    p.add_argument("--pooled", action="store_true",
                   help="macenko only: the fit pooled over the whole batch (batch_ref_index=None)")
    p.add_argument("--json", action="store_true")
    utils.add_device_argument(p)
    args = p.parse_args(argv)
    dev = get_device(args.device)
    print(utils.card_stamp(dev), flush=True)

    batch = utils.he_batch(args.batch, args.size, args.size, 123, dev, args.dtype, he_scale=1.15)
    methods = [args.method] if args.method else list(utils.METHODS)
    rows = []
    for method in methods:
        if args.pooled and method != "macenko":
            continue
        forward = StainNormalizerTransform(method, mode="batch", device=dev,
                                           batch_ref_index=None if args.pooled else 0)
        _, launches = utils.count_launches(lambda f=forward: f(batch))
        called = utils.called_ms(forward, batch, args.runs)
        busy = utils.busy_ms(forward, batch, args.runs)
        row = {
            "mode": "batch(fit-per-forward)" + (" pooled" if args.pooled else ""),
            "method": method, "dtype": args.dtype, "batch": args.batch, "size": args.size,
            "img_per_s": args.batch / called * 1e3,
            "mpix_per_s": args.batch * args.size * args.size / 1e3 / called,
            "called_ms": called, "busy_ms": busy, "idle_share": utils.idle_share(busy, called),
            "launches": launches, "device": utils.device_name(dev),
        }
        rows.append(row)
        if args.json:
            print(json.dumps(row), flush=True)
        else:
            print(f"{method}{'[pooled fit]' if args.pooled else ''}[{args.dtype}] "
                  f"{args.batch}x3x{args.size}^2 fit-per-forward: {row['img_per_s']:.1f} img/s "
                  f"{row['mpix_per_s']:.1f} MPix/s, {called:.4f} ms called, {busy:.4f} ms busy, "
                  f"idle share {row['idle_share']:.3f}, launches {launches}", flush=True)
    return rows


if __name__ == "__main__":
    main()
