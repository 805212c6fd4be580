#!/usr/bin/env python3
"""Where the time of B2 (the resident Macenko fit) goes, on a CUDA card.

Run from the root of a checkout on a machine with one CUDA card and nvcc:

    python3 tools/probe_b2.py

Builds ``stainx_tpu_torch/csrc/macenko_fused.cu`` as it is, in variants
whose resident fit kernel (``fit_resident_kernel``) stops after one phase
more each (launched; the pool loaded; the moments; the covariance, eigh
and ranks; the angle keys; the angle selections; H/E and the normal rows;
the concentration keys), writing one value so that nothing before the
stop is dropped; as built with the other block size (512 or 1024
threads, ``kFThreads``); and as built with uint8 OD computed by ``logf``
a value (the same formula, so the same bits) in place of the 256-entry
table, whose lookups can conflict on shared-memory banks. Times each
build's kernel (``macenko_fit_mega``) from CUDA-graph
replays on 1x3x64^2 uint8 (a small patch as reference), 1x3x128^2 uint8
and the largest uint8 pool B2 holds, cycling two pools:
the difference between two stops is the time of a phase, and the full
build's time less the last stop's is the concentration selections'. The
stopped variants compute wrong outputs on purpose and are not checked;
the other block size is held against the plain version (HE atol 2e-5,
maxC rtol 1e-4) and raced against the build as it is, in six alternating
rounds. Builds go to ``build/probe_b2/`` (git-ignored). Imports no JAX and
nothing of ``stainx_tpu``.
"""

from __future__ import annotations

import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

STOP = ("  if (threadIdx.x == 0) out8[0] = sh.sums[0] + sh.prefix[0] + sh.prefix[1] + "
        "sh.evs[0] + sh.m0[0] + keys0[0] + keys1[0];\n  return;\n")
# (phase ended, source text the stop goes before)
PHASES = [
    ("launch", "  load_resident<T, kFThreads>(x, n, p, planes, sh);\n"),
    ("load", "  rmoments<T, V, kFThreads>(planes, P, false, sh);\n"),
    ("moments", "  angle_setup(sh);\n"),
    ("covariance, eigh, ranks", "  angle_keys<T, V, kFThreads>("),
    ("angle keys", "  if constexpr (kCheck) copy_keys<kFThreads>(keys0, keys, P);\n"),
    ("angle selections", "  if (kCheck && threadIdx.x == 0) {\n    sel[0]"),
    ("H/E, normal rows", "  conc_keys<T, V, kFThreads>("),
    ("concentration keys",
     "  if constexpr (kCheck) copy_keys<kFThreads>(keys0, keys + P, 2 * P);\n"),
]
PARTIAL_SUM_BYTES = 80  # a warp's row of the block sum: 10 doubles


def main() -> int:
    import ctypes

    import torch

    if not torch.cuda.is_available():
        print("probe_b2: this needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from stainx_tpu_torch import kernels
    from stainx_tpu_torch.kernels import macenko_fused as mf
    from stainx_tpu_torch.testing import synthetic_he_batch

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card.splitlines()[0])
    source = (kernels.CSRC / "macenko_fused.cu").read_text()
    threads = int(re.search(r"constexpr int kFThreads = (\d+);", source).group(1))
    other = 512 if threads == 1024 else 1024
    other_fixed = mf.FIT_FIXED_BYTES + (other - threads) // 32 * PARTIAL_SUM_BYTES
    start = source.index("fit_resident_kernel(const T* __restrict__ x")
    builds = []
    for name, anchor in PHASES:
        at = source.index(anchor, start)
        builds.append((f"stops after {name}", source[:at] + STOP + source[at:], mf.FIT_FIXED_BYTES))
    builds.append(("as built", source, mf.FIT_FIXED_BYTES))
    variant = (source.replace(f"constexpr int kFThreads = {threads};",
                              f"constexpr int kFThreads = {other};")
               .replace(f"constexpr int kFitFixed = {mf.FIT_FIXED_BYTES};",
                        f"constexpr int kFitFixed = {other_fixed};"))
    builds.append((f"as built with {other} threads", variant, other_fixed))
    table = ("__device__ __forceinline__ float stored_od(uint8_t v, const float* lut) "
             "{ return lut[v]; }")
    builds.append(("as built, uint8 OD by logf a value, not the table",
                   source.replace(table, table.replace("lut[v]", "od_u8(static_cast<float>(v))")),
                   mf.FIT_FIXED_BYTES))
    nvcc = kernels.nvcc_path()
    procs = []
    for i, (name, text, fixed) in enumerate(builds):
        out_dir = Path(ROOT, "build", "probe_b2", f"v{i}")
        out_dir.mkdir(parents=True, exist_ok=True)
        (out_dir / "macenko_fused.cu").write_text(text)
        lib = out_dir / "variant.so"
        cmd = [nvcc, *kernels.NVCC_FLAGS, "-I", str(kernels.CSRC), "-o", str(lib),
               str(out_dir / "macenko_fused.cu")]
        procs.append((name, fixed, lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                         stderr=subprocess.STDOUT, text=True)))
    libs = []
    for name, fixed, lib, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name!r}:\n{log}")
        cdll = ctypes.CDLL(str(lib))
        cdll.stainx_error_string.argtypes = [ctypes.c_int]
        cdll.stainx_error_string.restype = ctypes.c_char_p
        libs.append((name, fixed, cdll))

    dev = torch.device("cuda", 0)
    smem = kernels.device_limits(dev.index)[1]
    built_fixed = mf.FIT_FIXED_BYTES

    def launch_with(fixed, lib, fn):
        """Runs fn with the wrapper launching this build."""
        kernels._libs["macenko_fused"] = lib
        mf.FIT_FIXED_BYTES = fixed
        try:
            return fn()
        finally:
            mf.FIT_FIXED_BYTES = built_fixed

    def replay_ms(fn, xs, iters=50):
        for x in xs:
            fn(x)
        torch.cuda.synchronize()
        graphs = []
        for x in xs:
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                fn(x)
            graphs.append(g)
        for g in graphs:
            g.replay()
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for i in range(iters):
            graphs[i % len(graphs)].replay()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / iters

    lo, hi = 1, 1 << 20
    while lo < hi:  # the largest uint8 pool both block sizes hold
        mid = (lo + hi + 1) // 2
        fits = mf.fit_resident_bytes(mid, torch.uint8) <= smem
        mf.FIT_FIXED_BYTES = other_fixed
        fits = fits and mf.fit_resident_bytes(mid, torch.uint8) <= smem
        mf.FIT_FIXED_BYTES = built_fixed
        lo, hi = (mid, hi) if fits else (lo, mid - 1)

    shapes = [("1x3x64^2 u8", (1, 64, 64)), ("1x3x128^2 u8", (1, 128, 128)),
              (f"1x3x1x{lo} u8 (the largest resident pool)", (1, 1, lo))]
    for label, shape in shapes:
        xs = [torch.as_tensor(synthetic_he_batch(*shape, seed=s)).to(dev) for s in (2, 3)]
        prev = 0.0
        for name, fixed, lib in libs:
            ms = launch_with(fixed, lib, lambda: replay_ms(mf.macenko_fit_mega, xs))
            step = f" (+{ms - prev:.4f})" if name.startswith("stops") or name == "as built" else ""
            print(f"{label}, resident fit {name}: {ms:.4f} ms on the device{step}")
            prev = ms
        (_, fixed_a, lib_a), (name_b, fixed_b, lib_b) = libs[-3], libs[-2]
        he_p, mc_p = mf.macenko_fit_mega_plain(xs[0])
        he_b, mc_b = launch_with(fixed_b, lib_b, lambda: mf.macenko_fit_mega(xs[0]))
        torch.testing.assert_close(he_b, he_p, atol=2e-5, rtol=0)
        torch.testing.assert_close(mc_b, mc_p, atol=0, rtol=1e-4)
        rounds = []
        for r in range(6):
            pair = [(f"{threads} threads", fixed_a, lib_a), (f"{other} threads", fixed_b, lib_b)]
            if r % 2:
                pair.reverse()
            rounds.append({n: launch_with(f, lb, lambda: replay_ms(mf.macenko_fit_mega, xs))
                           for n, f, lb in pair})
        spans = "; ".join(f"{n} {min(t[n] for t in rounds):.4f}-{max(t[n] for t in rounds):.4f} ms"
                          for n in (f"{threads} threads", f"{other} threads"))
        wins = sum(t[f"{threads} threads"] < t[f"{other} threads"] for t in rounds)
        print(f"{label}: {spans} over 6 alternating rounds; {threads} threads faster in {wins} "
              f"of 6; {other} threads within HE atol 2e-5 and maxC rtol 1e-4 of the plain version")
    return 0


if __name__ == "__main__":
    sys.exit(main())
