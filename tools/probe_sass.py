#!/usr/bin/env python3
"""Static SASS instruction mix of the port's CUDA kernels, on a machine with nvcc.

Run from the root of a checkout:

    python3 tools/probe_sass.py [SOURCE.cu ...]

Builds each source (by default every ``stainx_tpu_torch/csrc/*.cu``) with
the flags the port builds with (``kernels.NVCC_FLAGS``, headers from
``stainx_tpu_torch/csrc``) and ``-Xptxas -v`` into ``build/probe_sass/``
(git-ignored), then prints, for every kernel of each source, its count of
SASS instructions (``cuobjdump -sass``) by opcode family, and ptxas's
registers, shared memory and spills. An earlier version of a source (one
unpacked from git, say) can be given beside the current one to compare
them. Needs no card. Imports no JAX and nothing of ``stainx_tpu``.
"""

from __future__ import annotations

import collections
import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Opcode families printed for every kernel; "all" counts every instruction.
FAMILIES = ("ATOMS", "ATOMG", "RED", "LDS", "STS", "LDG", "STG", "SHFL", "MATCH", "REDUX",
            "BAR", "BRA", "IMAD", "IADD3", "LOP3", "SHF", "ISETP", "FFMA", "FMUL", "FADD",
            "DADD", "MUFU", "CALL")


def sass_mix(cuobjdump: str, lib: str) -> dict[str, collections.Counter]:
    """Static instruction counts of each kernel of ``lib`` by opcode family."""
    text = subprocess.run([cuobjdump, "-sass", lib], check=True, capture_output=True,
                          text=True).stdout
    mixes, current = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            current = mixes.setdefault(m.group(1), collections.Counter())
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if m and current is not None:
            current[m.group(1).split(".")[0]] += 1
            current["all"] += 1
    return mixes


def main() -> int:
    sys.path.insert(0, ROOT)
    from stainx_tpu_torch import kernels

    sources = [Path(a) for a in sys.argv[1:]] or sorted(kernels.CSRC.glob("*.cu"))
    nvcc = kernels.nvcc_path()
    cuobjdump = str(Path(nvcc).parent / "cuobjdump")
    out_dir = Path(ROOT, "build", "probe_sass")
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for i, src in enumerate(sources):
        lib = out_dir / f"v{i}_{src.stem}.so"
        cmd = [nvcc, *kernels.NVCC_FLAGS, "-I", str(kernels.CSRC), "-Xptxas", "-v", "-o", str(lib),
               str(src)]
        procs.append((src, lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                 stderr=subprocess.STDOUT, text=True)))
    for src, lib, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{log}")
        print(f"{src}:")
        for fn, mix in sorted(sass_mix(cuobjdump, str(lib)).items()):
            counts = ", ".join(f"{k} {mix[k]}" for k in FAMILIES if mix[k])
            print(f"  SASS {fn}: all {mix['all']}; {counts}")
        for line in log.splitlines():
            if "Compiling entry function" in line or "registers" in line or "spill" in line:
                print("  ptxas " + line.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
