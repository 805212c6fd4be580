#!/usr/bin/env python3
"""Where the time of the Reinhard kernels (B7b moments, B7a apply) goes, on a CUDA card.

Run from the root of a checkout on a machine with one CUDA card and nvcc:

    python3 tools/probe_reinhard.py [--sass-of OTHER.cu ...] [--rounds 3]

Builds ``stainx_tpu_torch/csrc/reinhard_fused.cu`` as it is and in variants
with one design step undone (powers through libm's ``powf``, no explicit
FMAs, float64 conversions a pixel, no powers at all). For each build it
prints the static SASS instruction mix of every kernel (``cuobjdump
-sass``: FFMA, FMUL, FADD, MUFU, F2F.F64.F32, DADD, CALL and all
instructions; every opcode for the source as it is) and ptxas's
registers, then times each kernel at 64x3x512^2 uint8 and float32 from
CUDA-graph replays, cycling two batches, and the source as it is also
with one pixel a thread. A variant patches the source's text and stops
with the line it no longer finds. Variants compute results that may
differ from the plain versions; each build's largest difference from them
is printed. ``--sass-of`` prints the same instruction mix of another
source of these kernels (an earlier version, say), built with the same
flags and not run. Last, ``Reinhard().transform`` as called, as built
(one C call for both kernels), with B7b and B7a launched by their two
wrappers, and with the eager ``moments_to_mean_std`` between the kernels,
alternating over ten rounds. Builds go to
``build/probe_reinhard/`` (git-ignored). Imports no JAX and nothing of
``stainx_tpu``.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import os
import re
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# pow_pos's body, which takes a power on the special-function unit.
POW_POS = (
    '  float l, y;\n  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(l) : "f"(x));\n'
    '  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(l * e));\n  return y;\n'
)
# What is changed: [(source text, replacement)].
VARIANTS = {
    "as built": [],
    "powers through libm powf (step 1 undone)": [(POW_POS, "  return powf(x, e);\n")],
    "no explicit FMA (step 2 undone)": [
        ("{ return __fmaf_rn(a, b, c); }", "{ return a * b + c; }")],
    "float64 conversions a pixel (step 3 undone)": [
        ("float part[kMoments] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};",
         "double part[kMoments] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0};"),
        ("part[c] += y[c];", "part[c] += static_cast<double>(y[c]);"),
        ("part[3 + c] = fma_rn(y[c], y[c], part[3 + c]);",
         "part[3 + c] += static_cast<double>(y[c] * y[c]);"),
        ("acc[k] += static_cast<double>(part[k]);", "acc[k] += part[k];")],
    "no powers (MUFU taken out)": [(POW_POS, "  return x * e;\n")],
}
COUNTED = ("FFMA", "FMUL", "FADD", "MUFU", "F2F.F64.F32", "DADD", "CALL", "F2I", "I2F", "LDS")


def sass_mix(cuobjdump: str, lib: str) -> dict[str, collections.Counter]:
    """Static instruction counts of each kernel of ``lib``, by opcode (MUFU
    by its function, F2F by its types)."""
    text = subprocess.run([cuobjdump, "-sass", lib], check=True, capture_output=True,
                          text=True).stdout
    mixes, current = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            kind = re.search(r"(moments_kernel|moments_finalize|apply_kernel)(I\w+?Li\d+E)?", name)
            current = mixes.setdefault(kind.group(0) if kind else name, collections.Counter())
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if m and current is not None:
            op = m.group(1)
            base = op.split(".")[0]
            current[op if base == "MUFU" else
                    "F2F.F64.F32" if op.startswith("F2F.F64.F32") else base] += 1
            current["all"] += 1
    return mixes


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--sass-of", action="append", default=[],
                        help="another reinhard_fused.cu whose SASS mix to print")
    parser.add_argument("--rounds", type=int, default=3)
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("probe_reinhard: this needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from stainx_tpu_torch import Reinhard, kernels
    from stainx_tpu_torch.kernels import reinhard_fused as rf
    from stainx_tpu_torch.ops import reinhard as rh
    from stainx_tpu_torch.testing import synthetic_he_batch

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card.splitlines()[0])
    nvcc = kernels.nvcc_path()
    cuobjdump = str(Path(nvcc).parent / "cuobjdump")
    source = (kernels.CSRC / "reinhard_fused.cu").read_text()
    builds = []  # (name, source text, run it)
    for name, edits in VARIANTS.items():
        text = source
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"variant {name!r}: the source no longer has {old.strip()!r}")
            text = text.replace(old, new)
        builds.append((name, text, True))
    builds += [(f"{other} as it is", Path(other).read_text(), False) for other in args.sass_of]
    procs = []
    for i, (name, text, run) in enumerate(builds):
        out_dir = Path(ROOT, "build", "probe_reinhard", f"v{i}")
        out_dir.mkdir(parents=True, exist_ok=True)
        (out_dir / "reinhard_fused.cu").write_text(text)
        lib = str(out_dir / "variant.so")
        cmd = [nvcc, *kernels.NVCC_FLAGS, "-Xptxas", "-v", "-o", lib,
               str(out_dir / "reinhard_fused.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        procs.append((name, run, proc, lib))
    kernels.build_all()
    libs = {}
    for name, run, proc, lib in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name!r}:\n{log}")
        print(f"{name}: built")
        every = name == "as built" or not run
        for fn, mix in sorted(sass_mix(cuobjdump, lib).items()):
            counts = ", ".join(f"{k} {mix[k]}" for k in sorted(mix) if k != "all" and (
                every or k.split(".")[0] in {c.split(".")[0] for c in COUNTED}))
            print(f"  SASS {fn}: all {mix['all']}; {counts}")
        for line in log.splitlines():
            if "entry function" in line or "registers" in line:
                print("  ptxas " + line.strip())
        if run:
            libs[name] = ctypes.CDLL(lib)

    dev = torch.device("cuda", 0)
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    for lib in libs.values():
        lib.stainx_reinhard_moments.argtypes = [ptr, ptr, ptr, ptr, i64, i64, i32, i32, i32, ptr]
        lib.stainx_reinhard_apply.argtypes = [ptr] * 6 + [i64, i64, i32, i32, i32, ptr]

    def launch(lib, x, what, stats=None, vec=None):
        n, _, h, w = x.shape
        stream = torch.cuda.current_stream(dev).cuda_stream
        u8 = int(x.dtype == torch.uint8)
        v = vec or rf.group_pixels(x.dtype, h * w, x.data_ptr() % 16 == 0)
        blocks = kernels.grid_blocks(n * (h * w // v), dev)
        shape = (n, h * w, u8, v, blocks, stream)
        if what == "moments":
            partials = torch.empty((blocks, 6), dtype=torch.float64, device=dev)
            out = torch.empty(12, dtype=torch.float32, device=dev)
            code = lib.stainx_reinhard_moments(x.data_ptr(), partials.data_ptr(), out.data_ptr(),
                                               out.data_ptr() + 6 * 4, *shape)
            out = out[:6]
        else:
            out = torch.empty_like(x)
            code = lib.stainx_reinhard_apply(x.data_ptr(), out.data_ptr(),
                                             *(s.data_ptr() for s in stats), *shape)
        if code != 0:
            raise RuntimeError(f"{what}: CUDA error {code}")
        return out

    def replay_ms(fn, xs, iters=30):
        for x in xs:
            fn(x)
        torch.cuda.synchronize()
        graphs = []
        for x in xs:
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                fn(x)
            graphs.append(graph)
        for graph in graphs * 3:
            graph.replay()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(iters):
            graphs[i % len(graphs)].replay()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters

    def batch(seed, scale):
        return torch.as_tensor(synthetic_he_batch(64, 512, 512, seed=seed, he_scale=scale)).to(dev)

    pairs = {"u8": [batch(123, 1.0), batch(124, 1.1)]}
    pairs["f32"] = [x.float() / 255.0 for x in pairs["u8"]]
    ref = torch.as_tensor(synthetic_he_batch(1, 512, 512, seed=42)).to(dev)
    ref_mean, ref_std = rh.moments_to_mean_std(512 * 512, *rf.reinhard_moments_plain(ref))
    stats = {}
    for dt, xs in pairs.items():
        s1, s2 = rf.reinhard_moments_plain(xs[0])
        stats[dt] = [t.contiguous() for t in (*rh.moments_to_mean_std(64 * 512 * 512, s1, s2),
                                              ref_mean, ref_std)]
    # (label, kernel, dtype, group pixels): None is the wrapper's choice;
    # one pixel a thread only for the sources as they are.
    cases = [(f"B7{'b' if what == 'moments' else 'a'} {what} 64x3x512^2 {dt}", what, dt, None)
             for what in ("moments", "apply") for dt in ("u8", "f32")]
    cases += [(f"B7{'b' if what == 'moments' else 'a'} {what} 64x3x512^2 u8, one pixel a thread",
               what, "u8", 1) for what in ("moments", "apply")]

    for name, lib in libs.items():
        for label, what, dt, vec in cases:
            if vec and name != "as built":
                continue
            x = pairs[dt][0]
            got = launch(lib, x, what, stats[dt], vec)
            if what == "moments":
                want = torch.cat(rf.reinhard_moments_plain(x))
                err = ((got - want).abs() / want.abs().clamp(min=1.0)).max().item()
                err_txt = f"max rel {err:.3g}"
            else:
                want = rf.reinhard_apply_plain(x, *stats[dt])
                err = (got.float() - want.float()).abs().max().item()
                err_txt = f"max|d| {err:.3g}"
            t = [replay_ms(lambda x: launch(lib, x, what, stats[dt], vec), pairs[dt])
                 for _ in range(args.rounds)]
            print(f"{name} | {label}: {min(t):.4f}-{max(t):.4f} ms on the device over "
                  f"{args.rounds} rounds; vs plain {err_txt}")

    # Design step 5, through the public API: the transform as built (one C
    # call launching B7b, its finalize and B7a), with B7b and B7a launched
    # by their two wrappers on the finalize's statistics, and with the
    # statistics turned from the sums by eager ops between the kernels;
    # the forms alternate, ten rounds.
    def with_device_stats(x, reference_mean, reference_std):
        x = rh._kernel_input(x)
        mean, std = rf.reinhard_mean_std(x)
        return rf.reinhard_apply(x, mean, std, reference_mean, reference_std)

    def with_eager_stats(x, reference_mean, reference_std):
        x = rh._kernel_input(x)
        s1, s2 = rf.reinhard_moments(x)
        mean, std = rh.moments_to_mean_std(x.shape[0] * x.shape[2] * x.shape[3], s1, s2)
        return rf.reinhard_apply(x, mean, std, reference_mean, reference_std)

    def event_ms(fn, xs, iters=50):
        for x in xs:
            fn(x)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(iters):
            fn(xs[i % len(xs)])
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters

    forms = {"one C call (as built)": rh.reinhard_transform,
             "two wrapper launches": with_device_stats,
             "eager moments_to_mean_std between": with_eager_stats}
    normalizer = Reinhard().fit(ref)
    times = {name: [] for name in forms}
    for r in range(10):
        for name in (list(forms) if r % 2 == 0 else list(forms)[::-1]):
            rh.reinhard_transform = forms[name]
            times[name].append(event_ms(normalizer.transform, pairs["u8"]))
    rh.reinhard_transform = forms["one C call (as built)"]
    built = times["one C call (as built)"]
    for name, t in times.items():
        wins = sum(a < b for a, b in zip(built, t))
        print(f"Reinhard().transform 64x3x512^2 u8 as called, {name}: median "
              f"{statistics.median(t):.4f} ms ({min(t):.4f}-{max(t):.4f}); as built faster in "
              f"{wins} of 10 rounds")
    return 0


if __name__ == "__main__":
    sys.exit(main())
