"""Headline benchmark of the PyTorch / CUDA port: batched 512² Macenko
transform throughput on one card.

The counterpart of ``bench.py``, which times the JAX package on a TPU. The
same configuration: a Macenko fit on a 1×3×512² uint8 reference (seed 42)
through the public ``Macenko`` API, then the transform of a 64×3×512² uint8
batch (seed 123), both already on the card; 5 warm-up calls, then 3 rounds
of 40 timed calls (the median round), each call on the same fresh batch
(never its own output). Earlier lines print the card's ``nvidia-smi`` name
and power limit, the seconds of the first fit and transform (which build
any kernel not built yet), the transform's ms as called and on the device
(a CUDA-graph replay) with the idle share, the kernels one transform
launches (B4 once and nothing else on the card) and the MAE against the
numpy oracle on the first 2 images, beside its 0.35 gate. A failed check
raises before the last line.

The last line of standard output is ``bench.py``'s JSON object:
``{"metric", "value", "unit", "vs_baseline"}``; ``value`` is MPix/s from the
time as called. ``vs_baseline`` divides it by ``bench.py``'s 291.0 MPix/s,
itself an estimate: the reference's published Macenko ``torch_cuda`` rate
on an RTX A6000 (5177 img/s at 64×150², about 116.5 MPix/s) scaled by 2.5
for an H100. No H100 figure of the reference is published.

    python bench_torch.py [--device cuda:0] [--runs 40]

``--device cpu`` runs the kernels' plain versions (no number of a card);
``--batch`` and ``--size`` shrink the run for a quick check and keep the
metric's name.
"""

from __future__ import annotations

import argparse
import json
import math
import time

import torch

from benchmarks_torch import utils
from stainx_tpu_torch import Macenko
from stainx_tpu_torch.utils import get_device

METRIC = "macenko_transform_512px_mpix_per_s_per_chip"
BASELINE_MPIX_PER_S = 291.0  # bench.py's estimate (see the module docstring)
BATCH = 64
SIZE = 512
WARMUP = 5
RUNS = 40
MAE_IMAGES = 2
MAE_GATE = 0.35


def main(argv=None) -> dict:
    """Run the benchmark; returns what it measured, the last line's object
    under ``"line"``."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    utils.add_device_argument(p)
    p.add_argument("--runs", type=int, default=RUNS)
    p.add_argument("--batch", type=int, default=BATCH)
    p.add_argument("--size", type=int, default=SIZE)
    args = p.parse_args(argv)
    dev = get_device(args.device)
    print(utils.card_stamp(dev), flush=True)

    ref = utils.he_batch(1, args.size, args.size, 42, dev)
    batch = utils.he_batch(args.batch, args.size, args.size, 123, dev)
    t0 = time.perf_counter()
    normalizer = Macenko(device=dev).fit(ref)
    out = normalizer.transform(batch)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    print(f"first fit and transform: {time.perf_counter() - t0:.3f} s (building any kernel not "
          f"built yet)")

    _, launches = utils.count_launches(lambda: normalizer.transform(batch))
    print(f"launches of one transform: {launches}")
    if dev.type == "cuda" and launches != {"B4": 1}:
        raise RuntimeError(f"the transform launched {launches}, not B4 once and nothing else")

    called = utils.called_ms(normalizer.transform, batch, args.runs, warmup=WARMUP)
    busy = utils.busy_ms(normalizer.transform, batch, args.runs)
    mpix = args.batch * args.size * args.size / 1e6
    print(f"macenko {args.batch}x3x{args.size}^2 u8 on {utils.device_name(dev)}: {called:.4f} ms "
          f"called, {busy:.4f} ms busy, idle share {utils.idle_share(busy, called):.3f}, "
          f"{args.batch / called * 1e3:.1f} img/s")

    oracle = utils.load_oracle()
    n = min(MAE_IMAGES, args.batch)
    he_o, mc_o = oracle.macenko_fit(utils.to_numpy(ref))
    err = utils.mae(out[:n], oracle.macenko_transform(utils.to_numpy(batch[:n]), he_o, mc_o))
    print(f"oracle MAE on {n} images: {err:.4f} (gate {MAE_GATE})")
    if not err <= MAE_GATE:
        raise RuntimeError(f"oracle MAE {err} above {MAE_GATE}")

    value = mpix / (called / 1e3)
    if not (math.isfinite(value) and value > 0):
        raise RuntimeError(f"throughput {value} MPix/s is not a positive number")
    line = {"metric": METRIC, "value": round(value, 2), "unit": "MPix/s/chip",
            "vs_baseline": round(value / BASELINE_MPIX_PER_S, 3)}
    print(json.dumps(line), flush=True)
    return {"line": line, "launches": launches, "called_ms": called, "busy_ms": busy,
            "idle_share": utils.idle_share(busy, called), "mae": err,
            "device": utils.device_name(dev)}


if __name__ == "__main__":
    main()
