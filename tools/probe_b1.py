#!/usr/bin/env python3
"""Where the time of B1's resident body goes, on a CUDA card.

Run from the root of a checkout on a machine with one CUDA card and nvcc:

    python3 tools/probe_b1.py

Builds ``stainx_tpu_torch/csrc/macenko_fused.cu`` as it is and in variants
whose resident kernel stops after one phase more each (the image loaded;
the moments; the covariance and eigh; the angle keys; the angle
selections; H/E and the normal rows; the concentration keys; the
concentration selections), writing one value so that nothing before the
stop is dropped. Times each build's kernel (``body="resident"``) from
CUDA-graph replays on 4x3x64^2 uint8 (one image's chain of dependent
phases: the card is nearly idle) and 256x3x64^2 uint8 (the small-patch
path), cycling two batches: the difference between two variants is the
time of a phase. Builds go to ``build/probe_b1/`` (git-ignored). Variants
compute wrong outputs on purpose; none is checked. Last, the small-patch
``Macenko().transform`` on 256x3x64^2 uint8 as called (CUDA events around
eager calls), with the wrappers' stream and device helpers as built
(``kernels.current_stream``, ``kernels.on_device``) and with
``torch.cuda.current_stream(device).cuda_stream`` and
``torch.cuda.device(device)`` in their place, in ten alternating rounds.
Imports no JAX and nothing of ``stainx_tpu``.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

STOP = ("  if (threadIdx.x == 0) out[offset] = static_cast<T>(sh.sums[0] + sh.prefix[0] + "
        "sh.prefix[1] + sh.evs[0] + sh.m0[0] + keys0[0] + keys1[0]);\n  return;\n")
# (phase ended, source text the stop goes before)
PHASES = [
    ("load", "  rmoments<T, V>(planes, p, false, sh);\n"),
    ("moments", "  if (threadIdx.x == 0) {\n    float a[6];\n"),
    ("covariance, eigh, ranks", "  // The angle keys, once:"),
    ("angle keys", "  if constexpr (kCheck) copy_keys(keys0, keys, blockIdx.x, 0, 1, p);\n"),
    ("angle selections", "  if (threadIdx.x == 0) {\n    if constexpr (kCheck) {\n"),
    ("H/E, normal rows", "  // The two concentration keys, once;"),
    ("concentration keys",
     "  if constexpr (kCheck) copy_keys(keys0, keys, blockIdx.x, 1, 2, p);\n"),
    ("concentration selections", "  float st[6];\n  for (int k = 0; k < 6; ++k) st[k] = stain[k];\n"
     "  const float sc0 = maxc_scale(tmc[0], unkey(sh.prefix[0]));\n"),
]


def main() -> int:
    import ctypes

    import torch

    if not torch.cuda.is_available():
        print("probe_b1: this needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from stainx_tpu_torch import kernels
    from stainx_tpu_torch.kernels import macenko_fused as mf
    from stainx_tpu_torch.testing import synthetic_he_batch

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card.splitlines()[0])
    source = (kernels.CSRC / "macenko_fused.cu").read_text()
    start = source.index("resident_kernel(const T* __restrict__ x")
    builds = []
    for i, (name, anchor) in enumerate(PHASES):
        at = source.index(anchor, start)
        builds.append((f"stops after {name}", source[:at] + STOP + source[at:]))
    builds.append(("as built", source))
    nvcc = kernels.nvcc_path()
    procs = []
    for i, (name, text) in enumerate(builds):
        out_dir = Path(ROOT, "build", "probe_b1", f"v{i}")
        out_dir.mkdir(parents=True, exist_ok=True)
        (out_dir / "macenko_fused.cu").write_text(text)
        lib = out_dir / "variant.so"
        cmd = [nvcc, *kernels.NVCC_FLAGS, "-I", str(kernels.CSRC), "-o", str(lib),
               str(out_dir / "macenko_fused.cu")]
        procs.append((name, lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                  stderr=subprocess.STDOUT, text=True)))
    libs = []
    for name, lib, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name!r}:\n{log}")
        libs.append((name, ctypes.CDLL(str(lib))))

    dev = torch.device("cuda", 0)
    ref = torch.as_tensor(synthetic_he_batch(1, 64, 64, seed=1)).to(dev)
    he, mc = mf.macenko_fit_mega_plain(ref)

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

    for n in (4, 256):
        xs = [torch.as_tensor(synthetic_he_batch(n, 64, 64, seed=s)).to(dev) for s in (2, 3)]
        prev = 0.0
        for name, lib in libs:
            lib.stainx_error_string.argtypes = [ctypes.c_int]
            lib.stainx_error_string.restype = ctypes.c_char_p
            kernels._libs["macenko_fused"] = lib  # the wrapper launches this build
            ms = replay_ms(lambda x: mf.macenko_transform_mega(x, he, mc, body="resident"), xs)
            print(f"{n}x3x64^2 u8, resident body {name}: {ms:.4f} ms on the device "
                  f"(+{ms - prev:.4f})")
            prev = ms

    from stainx_tpu_torch import Macenko

    xs = [torch.as_tensor(synthetic_he_batch(256, 64, 64, seed=s)).to(dev) for s in (4, 5)]
    norm = Macenko().fit(xs[0][:1])
    built = (kernels.current_stream, kernels.on_device)
    older = (lambda d: torch.cuda.current_stream(d).cuda_stream, torch.cuda.device)

    def called_ms(helpers, iters=50):
        kernels.current_stream, kernels.on_device = helpers
        try:
            for x in xs:
                norm.transform(x)
            torch.cuda.synchronize()
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            for i in range(iters):
                norm.transform(xs[i % 2])
            b.record()
            b.synchronize()
            return a.elapsed_time(b) / iters
        finally:
            kernels.current_stream, kernels.on_device = built

    rounds = []
    for r in range(10):
        pair = [("as built", built), ("torch.cuda stream and device", older)]
        if r % 2:
            pair.reverse()
        rounds.append({name: called_ms(h) for name, h in pair})
    for name in ("as built", "torch.cuda stream and device"):
        ms = sorted(t[name] for t in rounds)
        print(f"small-patch Macenko().transform as called, {name}: median {ms[5]:.4f} ms "
              f"(range {ms[0]:.4f}-{ms[-1]:.4f})")
    wins = sum(t["as built"] < t["torch.cuda stream and device"] for t in rounds)
    print(f"as built faster in {wins} of {len(rounds)} rounds")
    return 0


if __name__ == "__main__":
    sys.exit(main())
