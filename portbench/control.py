"""The control of the check: ``python3 -m portbench.control --workload <cell>
--seeds <n> [<n> ...]``.

Puts the reference, computed in bfloat16 (every stored intermediate
rounded to it: the precision below the configurations' float32), in the
program's place, on the same inputs and the same sample a run of that seed
checks, and prints the numbers the check compares. It has to come out as
not correct: every limit in a configuration lies below the control's
readings. Run on the card at the cell's own size (the inputs are made
there); the benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from portbench import check, harness, spec


def control_items(items: list, reference, full_scale: float) -> list:
    """``items`` with the program's parts made by the bfloat16 reference,
    its checked rows transformed as the check transforms them."""
    for item in items:
        state = reference.fit(item.fit_input, rounding=reference.bf16)
        blocks = [out for _, out in check.reference_rows(item, reference, state,
                                                         rounding=reference.bf16)]
        rows = np.concatenate(blocks) if blocks else item.call_input[:0]
        item.program_state = state
        item.program_rows = rows.astype(np.float32) * (full_scale / 255.0)
    return items


def readings(cell: spec.Cell, seed: int, seconds: float, device: torch.device) -> dict:
    job, driver, st, streams = harness.setup(cell, seed, seconds, device)
    items = driver.check_items(job, st, streams["check"], program=False)
    reference = spec.load_module("reference", cell.config["reference"])
    full_scale = cell.config.get("out_full_scale", 255.0)
    found = check.gaps(control_items(items, reference, full_scale), reference, full_scale)
    ok, checks = check.judge(found, cell.config["limits"])
    return {"seed": seed, "correct": ok, "found": found}


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="python3 -m portbench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    cell = spec.cell(args.workload)
    if not torch.cuda.is_available():
        raise SystemExit("the control makes the cell's inputs on a CUDA card")
    seconds = spec.load_benchmark()["run_seconds"]
    for seed in args.seeds:
        print(json.dumps(readings(cell, seed, seconds, torch.device("cuda", 0))), flush=True)


if __name__ == "__main__":
    main()
