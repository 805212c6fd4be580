#!/usr/bin/env python3
"""The histogram-matching LUT apply (B8b) against a copy of its bytes, on a CUDA card.

Run from the root of a checkout on a machine with one CUDA card and nvcc:

    python3 tools/probe_b8b.py [--against DIR] [--variant FILE ...]
                               [--block-values V ...] [--rounds 5]
                               [--sass-out FILE]

Builds ``stainx_tpu_torch/csrc/histogram.cu`` as it is, each
``--variant`` FILE (another ``histogram.cu`` with the same C interface:
an edited copy, with another ``kApplyUnroll``, say), and, with
``--against``, the ``histogram.cu`` of an
earlier tree (unpacked with ``git archive``, say) whose apply walks the
flat input grid-stride, all with the port's flags and ``-Xptxas -v`` into
``build/probe_b8b/`` (git-ignored). Prints each build's SASS instruction
mix of every ``apply_kernel``, the instructions of each loop that stores
(the vector loop: its count is the instructions a 16-byte vector takes)
and ptxas's registers; ``--sass-out`` writes the whole SASS of those
kernels to FILE. Then, at the histogram-matching cell's shape (256x3x512^2
uint8 tiles of ``portbench/gen.py``, a LUT fitted on one more tile),
cycling a pool of 4 input batches (805 MB, 16x the 50 MB L2) into 2
output buffers, times from CUDA events over 24 calls a round, in
alternating rounds: each build's B8b alone (``stainx_apply_lut``, uint8
and float32 output; each plane-walk build at each ``--block-values`` V
in place of ``APPLY_BLOCK_VALUES``), each build's whole transform
(``stainx_hm_transform``: B8a, the LUT finalize, B8b), and
``Tensor.copy_`` of the same 201 MB into a preallocated uint8 buffer and
into a float32 one: the yardsticks of a kernel that reads once and writes
once, the same bytes as B8b's uint8 and float32 output (the port never
calls them). Each build's output is held against ``apply_lut_plain`` byte
for byte. Imports no JAX and nothing of ``stainx_tpu``.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OP = re.compile(r"/\*([0-9a-f]+)\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)([^;]*)")


def sass_of(cuobjdump: str, lib: str) -> dict[str, list[tuple[int, str, str]]]:
    """(address, opcode, operands) of each ``apply_kernel`` of ``lib``."""
    text = subprocess.run([cuobjdump, "-sass", lib], check=True, capture_output=True,
                          text=True).stdout
    kernels, current = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            current = kernels.setdefault(m.group(1), []) if "apply_kernel" in m.group(1) else None
            continue
        m = OP.match(line.strip())
        if current is not None and m:
            current.append((int(m.group(1), 16), m.group(2), m.group(3)))
    return kernels


def mix(ops) -> str:
    counts: dict[str, int] = {}
    for _, op, _ in ops:
        counts[op] = counts.get(op, 0) + 1
    top = sorted(counts.items(), key=lambda kv: -kv[1])
    return f"all {len(ops)}; " + ", ".join(f"{k} {v}" for k, v in top)


def store_loops(ops) -> list[str]:
    """Each loop (a backward branch and its target) whose body stores:
    its instruction count and its loads, stores, shared loads and calls."""
    addrs = [a for a, _, _ in ops]
    loops = []
    for i, (addr, op, args) in enumerate(ops):
        m = re.search(r"0x([0-9a-f]+)", args) if op == "BRA" else None
        if m and int(m.group(1), 16) <= addr and int(m.group(1), 16) in addrs:
            body = ops[addrs.index(int(m.group(1), 16)):i + 1]
            count = {k: sum(o == k for _, o, _ in body) for k in ("LDG", "STG", "LDS", "CALL")}
            if count["STG"]:
                loops.append(f"{len(body)} instructions, " +
                             ", ".join(f"{k} {v}" for k, v in count.items()))
    return loops


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--against", help="an earlier checkout whose grid-stride B8b to build")
    parser.add_argument("--variant", action="append", default=[],
                        help="another histogram.cu with this checkout's C interface")
    parser.add_argument("--block-values", type=int, nargs="*", default=[],
                        help="values a block of each plane-walk build (default: the wrapper's)")
    parser.add_argument("--rounds", type=int, default=5)
    parser.add_argument("--sass-out", help="file for the whole SASS of the apply kernels")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("probe_b8b: this needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from portbench import gen
    from stainx_tpu_torch import HistogramMatching, kernels
    from stainx_tpu_torch.kernels import histogram as hk

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    print(card.splitlines()[0])

    nvcc = kernels.nvcc_path()
    cuobjdump = str(Path(nvcc).parent / "cuobjdump")
    source = (kernels.CSRC / "histogram.cu").read_text()
    builds = [("as built", source, True)]  # (name, source, walks planes)
    builds += [(f"variant {v}", Path(v).read_text(), True) for v in args.variant]
    if args.against:
        other = Path(args.against, "stainx_tpu_torch", "csrc", "histogram.cu")
        builds.append((f"{args.against} (grid-stride)", other.read_text(), False))
    procs = []
    for i, (name, text, planes) in enumerate(builds):
        out_dir = Path(ROOT, "build", "probe_b8b", f"v{i}")
        out_dir.mkdir(parents=True, exist_ok=True)
        (out_dir / "histogram.cu").write_text(text)
        lib = str(out_dir / "variant.so")
        cmd = [nvcc, *kernels.NVCC_FLAGS, "-I", str(kernels.CSRC), "-Xptxas", "-v", "-o", lib,
               str(out_dir / "histogram.cu")]
        procs.append((name, planes, lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                          stderr=subprocess.STDOUT, text=True)))
    main_lib = hk._lib()
    ptr, i64, i32, f32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
    libs = {}
    sass_text = []
    for name, planes, lib, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name!r}:\n{log}")
        print(f"{name}:")
        for fn, ops in sorted(sass_of(cuobjdump, lib).items()):
            print(f"  SASS {fn}: {mix(ops)}")
            for loop in store_loops(ops):
                print(f"    loop that stores: {loop}")
            sass_text += [f"// {name}: {fn}", *(f"/*{a:04x}*/ {o}{r}" for a, o, r in ops), ""]
        entry = False
        for line in log.splitlines():
            if "entry function" in line:
                entry = "apply_kernel" in line
            if entry and ("entry function" in line or "registers" in line or "spill" in line):
                print("  ptxas " + line.strip())
        handle = ctypes.CDLL(lib)
        if planes:
            for fn in ("stainx_apply_lut", "stainx_hm_transform"):
                getattr(handle, fn).argtypes = getattr(main_lib, fn).argtypes
        else:
            handle.stainx_apply_lut.argtypes = [ptr, ptr, ptr, i64, i64, i32, i32, i32, i32, ptr]
            handle.stainx_hm_transform.argtypes = (
                [ptr] * 6 + [i64, i64, i32, i32, i64, f32, i32, i32, i32, ptr, ptr, ptr])
        libs[name] = (handle, planes)
    if args.sass_out:
        Path(args.sass_out).write_text("\n".join(sass_text))

    dev = torch.device("cuda", 0)
    sms = kernels.device_limits(0)[0]
    stream = torch.cuda.current_stream(dev).cuda_stream
    n, c, h, w = 256, 3, 512, 512
    p = h * w
    g = gen.torch_generator(gen.seed_streams(2**33 + 29, 1)[0], dev)
    pool = [gen.tiles(n, (c, h, w), "uint8", (0.85, 1.15), g).reshape(n, c, p) for _ in range(4)]
    ref = gen.tiles(1, (c, h, w), "uint8", (0.85, 1.15), g)
    hist = HistogramMatching(device=dev).fit(ref)._ref_histograms_256
    _, lut, _ = hk.hm_transfer(pool[0], hist, torch.uint8)
    tables = {dt: hk.lut_table(lut, dt) for dt in (torch.uint8, torch.float32)}
    outs = {dt: [torch.empty((n, c, p), dtype=dt, device=dev) for _ in range(2)]
            for dt in tables}
    bpc, chunk = hk._hist_args(pool[0], "probe")[4:]
    partials = torch.empty((c * bpc, 256), dtype=torch.int32, device=dev)
    lut_out = torch.empty((c, 256), dtype=torch.float32, device=dev)
    table_out = torch.empty((c, 256), dtype=torch.uint8, device=dev)

    block_values = hk.APPLY_BLOCK_VALUES

    def apply_shape(planes, x, out, values=block_values):
        """The launch arguments after (n, p, c) or (total, p, c)."""
        is_float = int(out.dtype == torch.float32)
        if planes:
            hk.APPLY_BLOCK_VALUES = values
            split = hk.apply_split(n, c, p, sms)
            hk.APPLY_BLOCK_VALUES = block_values
            return (*split, is_float, int(hk.vector_aligned(x, out)))
        return is_float, 1, kernels.grid_blocks(x.numel() // 16, dev)

    def apply_call(build, x, out, table, values=block_values):
        lib, planes = libs[build]
        code = lib.stainx_apply_lut(x.data_ptr(), out.data_ptr(), table.data_ptr(),
                                    n if planes else x.numel(), p, c,
                                    *apply_shape(planes, x, out, values), stream)
        if code != 0:
            raise RuntimeError(f"stainx_apply_lut: CUDA error {code}")

    def nulls(lib):
        """Null event handles for every one the build's transform takes
        after its stream (two before the launch interval's, four after)."""
        return (None,) * (len(lib.stainx_hm_transform.argtypes) - 17)

    def transform_call(build, x, out):
        lib, planes = libs[build]
        shape = apply_shape(planes, x, out)
        if planes:  # (bpc, chunk, is_float, vec) -> is_float, vec, bpc, chunk
            shape = (shape[2], shape[3], shape[0], shape[1])
        code = lib.stainx_hm_transform(x.data_ptr(), out.data_ptr(), partials.data_ptr(),
                                       hist.data_ptr(), lut_out.data_ptr(), table_out.data_ptr(),
                                       n, p, c, bpc, chunk, hk._reciprocal(float(n * p) + 1e-8),
                                       *shape, stream, *nulls(lib))
        if code != 0:
            raise RuntimeError(f"stainx_hm_transform: CUDA error {code}")

    def event_ms(fn, iters=24):
        for i in range(3):
            fn(i)
        torch.cuda.synchronize(dev)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(iters):
            fn(i)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters

    cases = {}
    shapes = args.block_values or [block_values]
    for build, (_, planes) in libs.items():
        for dt, table in tables.items():
            out = outs[dt][0]
            apply_call(build, pool[1], out, table)
            transform_call(build, pool[2], outs[torch.uint8][1])
            torch.cuda.synchronize(dev)
            same = torch.equal(out, hk.apply_lut_plain(pool[1], lut, dt))
            same_t = torch.equal(outs[torch.uint8][1],
                                 hk.hm_transfer_plain(pool[2], hist, torch.uint8)[0])
            label = f"{build} | B8b {'uint8' if dt == torch.uint8 else 'float32'} out"
            print(f"{label}: equal to apply_lut_plain {same}; transform equal to its plain "
                  f"version {same_t}")
            for k in shapes if planes else [block_values]:
                shaped = label.replace(" |", f", {k} values a block |") if planes else label
                cases[shaped] = (lambda i, b=build, dt=dt, table=table, k=k:
                                 apply_call(b, pool[i % 4], outs[dt][i % 2], table, k))
        cases[f"{build} | transform (B8a, LUT finalize, B8b)"] = (
            lambda i, b=build: transform_call(b, pool[i % 4], outs[torch.uint8][i % 2]))
    cases["copy_ of the 201 MB input"] = lambda i: outs[torch.uint8][i % 2].copy_(pool[i % 4])
    cases["copy_ of the 201 MB input into float32"] = (
        lambda i: outs[torch.float32][i % 2].copy_(pool[i % 4]))
    times = {label: [] for label in cases}
    for _ in range(args.rounds):
        for label, fn in cases.items():
            times[label].append(event_ms(fn))
    copy_ms = {"uint8": statistics.median(times["copy_ of the 201 MB input"]),
               "float32": statistics.median(times["copy_ of the 201 MB input into float32"])}
    for label, t in times.items():
        med = statistics.median(t)
        moved = n * c * p * (5 if "float32" in label else 2)
        rate = f"; {moved / med / 1e9:.3f} TB/s, {moved / med / 1e9 / 3.35 * 100:.1f} % of 3.35"
        dt = "float32" if "float32" in label else "uint8"
        rate += f", {med / copy_ms[dt]:.3f}x the copy_" if "B8b" in label else ""
        print(f"{label}: median {med:.4f} ms ({min(t):.4f}-{max(t):.4f}, {args.rounds} rounds)"
              f"{rate if 'transform' not in label else ''}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
