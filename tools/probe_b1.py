#!/usr/bin/env python3
"""Where the time of B1's resident body goes, on a CUDA card.

Run from the root of a checkout on a machine with one CUDA card and nvcc:

    python3 tools/probe_b1.py [--against OTHER.cu]

Builds ``stainx_tpu_torch/csrc/macenko_fused.cu`` as it is and in variants
whose resident kernel stops after one phase more each (the image loaded;
the moments; the covariance and eigh; the angle keys; the angle
selections; H/E and the normal rows; the concentration keys; the
concentration selections), writing one value so that nothing before the
stop is dropped. Times each build's kernel (``body="resident"``) from
CUDA-graph replays on 4x3x64^2 uint8 (one image's chain of dependent
phases: the card is nearly idle), 256x3x64^2 uint8 (the small-patch
path) and 512x3x96^2 uint8 (the patch cell's call), cycling two batches:
the difference between two variants is the time of a phase. Each shape's
first line names the blocks an SM the card holds of it. Builds go to
``build/probe_b1/`` (git-ignored). Variants compute wrong outputs on
purpose; none is checked. Last, the small-patch
``Macenko().transform`` on 256x3x64^2 uint8 as called (CUDA events around
eager calls), with the wrappers' stream and device helpers as built
(``kernels.current_stream``, ``kernels.on_device``) and with
``torch.cuda.current_stream(device).cuda_stream`` and
``torch.cuda.device(device)`` in their place, in ten alternating rounds.
With ``--against``, also builds another source of ``macenko_fused.cu``
(such as an older one unpacked from git into ``build/``), launched with
the shared memory its own ``kResidentFixed`` gives, holds B1's outputs of
both builds bit for bit on small patches (uint8 and float32), the patch
cell's 96^2 patches, ragged rows, a tile that takes the <3-pixel
fallback, a uniform tile and the largest resident rows of each build (the
larger of the two may take the other build's L2 body: its line gives the
largest difference too), prints the blocks an SM each build holds at
96^2, and times both at 256x3x64^2 and 512x3x96^2 uint8 in six
alternating rounds. Imports no JAX and nothing of ``stainx_tpu``.
"""

from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

STOP = ("  if (threadIdx.x == 0) out[offset] = static_cast<T>(sh.sums[0] + sh.prefix[0] + "
        "sh.prefix[1] + sh.evs[0] + sh.m0[0] + keys0[0] + keys1[0]);\n  return;\n")
# (phase ended, source text the stop goes before)
PHASES = [
    ("load", "  rmoments<T, V, kRThreads>(planes, p, false, sh);\n"),
    ("moments", "  angle_setup(sh);\n"),
    ("covariance, eigh, ranks", "  angle_keys<T, V, kRThreads>("),
    ("angle keys", "  if constexpr (kCheck) copy_keys<kRThreads>(keys0, keys + offset, p);\n"),
    ("angle selections", "  if (kCheck && threadIdx.x == 0) {\n    sel[4 * blockIdx.x] ="),
    ("H/E, normal rows", "  conc_keys<T, V, kRThreads>("),
    ("concentration keys",
     "  if constexpr (kCheck) copy_keys<kRThreads>(keys0, keys + offset + p, 2 * p);\n"),
    ("concentration selections", "  float st[6];\n  for (int k = 0; k < 6; ++k) st[k] = stain[k];\n"
     "  const float sc0 = maxc_scale(tmc[0], unkey(sh.prefix[0]));\n"),
]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--against", help="another source of macenko_fused.cu to hold B1 against")
    args = parser.parse_args()
    import ctypes

    import torch

    if not torch.cuda.is_available():
        print("probe_b1: this needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from stainx_tpu_torch import kernels
    from stainx_tpu_torch.kernels import macenko_fused as mf
    from stainx_tpu_torch.ops.percentile import static_nearest_rank_index
    from stainx_tpu_torch.testing import largest, synthetic_he_batch

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
    if args.against:
        builds.append(("against", Path(args.against).read_text()))
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
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    for name, lib, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name!r}:\n{log}")
        cdll = ctypes.CDLL(str(lib))
        cdll.stainx_error_string.argtypes = [ctypes.c_int]
        cdll.stainx_error_string.restype = ctypes.c_char_p
        cdll.stainx_macenko_transform_mega.argtypes = [ptr, ptr, ptr, ptr, ctypes.c_float, i64, i64,
                                                       i32, i32, i64, i64, ptr, ptr, ptr, ptr, ptr]
        cdll.stainx_macenko_transform_mega.restype = i32
        cdll.stainx_macenko_transform_occupancy.argtypes = [i32, i32, i64, ptr]
        cdll.stainx_macenko_transform_occupancy.restype = i32
        libs.append((name, cdll))

    dev = torch.device("cuda", 0)
    ref = torch.as_tensor(synthetic_he_batch(1, 64, 64, seed=1)).to(dev)
    he, mc = (t.contiguous() for t in mf.macenko_fit_mega_plain(ref))
    smem_optin = kernels.device_limits(dev.index)[1]
    built_fixed = mf.RESIDENT_FIXED_BYTES

    def block_bytes(p, dtype, fixed):
        """A resident block's shared memory for p-pixel images in a build
        whose fixed head takes ``fixed`` bytes (the wrapper's rule)."""
        return mf.resident_bytes(p, dtype) - mf.RESIDENT_FIXED_BYTES + fixed

    def launch(lib, x, fixed, body=None):
        """B1 of lib's build on x, as the wrapper launches it, given the
        build's fixed head: the resident body where the image fits (or
        ``body``), else the L2 body."""
        n, _, h, w = x.shape
        p = h * w
        smem = block_bytes(p, x.dtype, fixed)
        body = body or ("resident" if smem <= smem_optin else "l2")
        out = torch.empty_like(x)
        code = lib.stainx_macenko_transform_mega(
            x.data_ptr(), out.data_ptr(), he.data_ptr(), mc.data_ptr(), 1.0, n, p,
            int(x.dtype == torch.uint8), int(mf._vec4(p, x, out)), static_nearest_rank_index(99, p),
            smem if body == "resident" else 0, None, None, kernels.current_stream(dev), None, None)
        kernels.check(lib, code, "macenko_transform_mega")
        return out

    def per_sm(lib, p, fixed):
        """Blocks of lib's resident uint8 launch of p-pixel images an SM
        holds (the wrapper's occupancy query, asked of that build)."""
        found = ctypes.c_int(0)
        code = lib.stainx_macenko_transform_occupancy(1, int(p % 4 == 0),
                                                      block_bytes(p, torch.uint8, fixed),
                                                      ctypes.addressof(found))
        kernels.check(lib, code, "cudaOccupancyMaxActiveBlocksPerMultiprocessor")
        return found.value

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

    if args.against:
        (_, built), (_, other) = libs[-2], libs.pop()
        other_fixed = int(re.search(r"constexpr int kResidentFixed = (\d+);",
                                    builds[-1][1]).group(1))
        fixed = {id(built): built_fixed, id(other): other_fixed}

        def b1_with(lib, x):
            return launch(lib, x, fixed[id(lib)])  # the shared memory that build lays out

        def u8(n, h, w, seed):
            return torch.as_tensor(synthetic_he_batch(n, h, w, seed=seed)).to(dev)

        fallback = u8(2, 64, 64, 11).clone()
        fallback[:, 0] = torch.clamp(fallback[:, 0], min=215)
        fallback[:, :, 5, 7] = torch.tensor([120, 60, 150], dtype=torch.uint8, device=dev)[None]
        fallback[:, :, 40, 3] = torch.tensor([90, 70, 130], dtype=torch.uint8, device=dev)[None]
        edges = {name: largest(lambda p, f=f: block_bytes(p, torch.uint8, f) <= smem_optin)
                 for name, f in (("as built", built_fixed), ("against", other_fixed))}
        cases = [("256x3x64^2 u8", u8(256, 64, 64, 7)),
                 ("256x3x64^2 f32", u8(256, 64, 64, 7).float() / 255.0),
                 ("512x3x96^2 u8", u8(512, 96, 96, 10)),
                 ("2x3x71x73 u8", u8(2, 71, 73, 8)), ("the <3-pixel fallback", fallback),
                 ("uniform 250", torch.full((2, 3, 64, 64), 250, dtype=torch.uint8, device=dev))]
        cases += [(f"3x3x1x{p} u8 (the largest resident rows {name})", u8(3, 1, p, 9))
                  for name, p in sorted(edges.items(), key=lambda e: e[1])]
        for label, x in cases:
            a, b = b1_with(built, x), b1_with(other, x)
            same = torch.equal(a.view(torch.int32) if a.is_floating_point() else a,
                               b.view(torch.int32) if b.is_floating_point() else b)
            diff = (a.float() - b.float()).abs().max().item()
            print(f"B1 {label}: as built and {args.against} bit for bit {same} "
                  f"(max|d| {diff:.3g})")
        print(f"B1 512x3x96^2 u8 blocks an SM: as built {per_sm(built, 96 * 96, built_fixed)}, "
              f"{args.against} {per_sm(other, 96 * 96, other_fixed)}")
        for n, side in ((256, 64), (512, 96)):
            xs = [u8(n, side, side, 20 + k) for k in range(2)]
            rounds = []
            for r in range(6):
                pair = [("as built", built), ("against", other)]
                if r % 2:
                    pair.reverse()
                rounds.append({name: replay_ms(lambda x, lb=lib: b1_with(lb, x), xs)
                               for name, lib in pair})
            for name in ("as built", "against"):
                t = [r[name] for r in rounds]
                print(f"B1 {n}x3x{side}^2 u8 {name}: {min(t):.4f}-{max(t):.4f} ms on the "
                      f"device, 6 rounds")

    for n, side in ((4, 64), (256, 64), (512, 96)):
        xs = [torch.as_tensor(synthetic_he_batch(n, side, side, seed=s)).to(dev) for s in (2, 3)]
        print(f"{n}x3x{side}^2 u8: {per_sm(libs[-1][1], side * side, built_fixed)} blocks an SM")
        prev = 0.0
        for name, lib in libs:
            ms = replay_ms(lambda x, lb=lib: launch(lb, x, built_fixed, body="resident"), xs)
            print(f"{n}x3x{side}^2 u8, resident body {name}: {ms:.4f} ms on the device "
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
