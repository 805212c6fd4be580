"""Faults planted in the timed path, and their readings at a cell's own size:
``python3 -m portbench.faults --workload <cell> --seeds <n> [<n> ...]
[--seconds <s>]``.

Each fault breaks the program underneath a run after its set-up, as a
later change could, and the run has to come out not correct. The tests in
``test_portbench_check.py`` hold each at a small size on the CPU; this
command drives whole runs of the cell on the card, one a fault and seed,
and prints each run's compared numbers beside their limits, as the control
(``portbench.control``) prints its own. The benchmark's own runs never run
it.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from portbench import harness, spec


def returns_its_input(job):
    job.call = lambda x: x.to(job.device)


def half_the_batch(job):
    """The first half of the batch transformed, the rest left as zeros."""
    call = job.call

    def half(x):
        x = x.to(job.device)
        out = torch.zeros_like(x)
        keep = max(1, len(x) // 2)
        out[:keep] = call(x[:keep])
        return out

    job.call = half


def one_answer_altered(job):
    """The first value of every output moved by 7 grey levels."""
    call = job.call

    def altered(x):
        out = call(x)
        step = 7 if out.dtype == torch.uint8 else 7 / 255
        first = out.view(-1)[0]
        out.view(-1)[0] = torch.clamp(first + step, max=255) if first < 200 else first - step
        return out

    job.call = altered


def stale_fit(job):
    """A per-batch fit that never runs again: every forward of the window
    transforms with the state the set-up's last forward fitted."""
    normalizer = job.system.normalizer
    normalizer.fit = lambda images: normalizer


FAULTS = {"returns_its_input": returns_its_input, "half_the_batch": half_the_batch,
          "one_answer_altered": one_answer_altered, "stale_fit": stale_fit}


def applies(fault: str, cell: spec.Cell) -> bool:
    """Whether ``cell`` can have ``fault``: a stale fit only where the entry
    fits every batch."""
    return fault != "stale_fit" or cell.config["fit"] == "per_batch"


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="python3 -m portbench.faults")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args(argv)
    cell = spec.cell(args.workload)
    if not torch.cuda.is_available():
        raise SystemExit("the faults are read on a CUDA card, at the cell's own size")
    device = torch.device("cuda", 0)
    for seed in args.seeds:
        for name in [f for f in FAULTS if applies(f, cell)]:
            result = harness.run_cell(cell, seed, args.seconds, False, device,
                                      time.perf_counter(), FAULTS[name])
            print(json.dumps({"seed": seed, "fault": name, "correct": result["correct"],
                              "found": {k: c["value"] for k, c in result["checks"].items()}}),
                  flush=True)


if __name__ == "__main__":
    main()
