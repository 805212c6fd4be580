"""``python3 -m portbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>``

Runs one cell of ``BENCHMARK.json`` once on the CUDA card(s) of this
machine and prints one JSON line last on standard output: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1``
a ``breakdown``, and last ``checks``, each compared number with its limit.
Without a CUDA card, or with fewer cards than the cell asks for, it exits
non-zero and prints no result: it never falls back to the CPU.

Build and kernel caches stay inside the checkout (the port's nvcc builds
in ``build/stainx_tpu_torch/``), so only a checkout's first run builds.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from portbench import STARTED, spec

_CACHE = spec.ROOT / "build" / "portbench"
os.environ["TORCH_EXTENSIONS_DIR"] = str(_CACHE / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(_CACHE / "triton")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="python3 -m portbench", description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    cell = spec.cell(args.workload)
    import torch

    marks = {"torch_import_s": time.perf_counter() - STARTED}
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        raise SystemExit(f"{cell.name} needs {cell.chips} CUDA card(s); this machine has {found}")
    torch.empty(1, device="cuda:0")  # the CUDA context
    marks["cuda_context_s"] = time.perf_counter() - STARTED
    from portbench import harness

    # One process with few threads: the window drives the card from this
    # thread, and the host's own tensor work is a copy or a slice a call.
    torch.set_num_threads(1)
    result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                              torch.device("cuda", 0), STARTED)
    print(f"card {harness.card()}", file=sys.stderr)
    for key, value in {**marks, **result["notes"]}.items():
        print(f"note {key} {value!r}", file=sys.stderr)
    harness.emit(result)


if __name__ == "__main__":
    main()
