#!/usr/bin/env python3
"""Where the time of B4/B5's cluster route goes, on a CUDA card.

Run from the root of a checkout on a machine with one CUDA card and nvcc:

    python3 tools/probe_cluster_kernel.py [--rounds 3]

Builds ``stainx_tpu_torch/csrc/macenko_stream.cu`` as it is and in variants
with one part of the cluster kernel taken out (the angle selections, the
concentration selections, the reconstruction, digit passes 2 and 3 of both
selections, the histogram atomics, the uint8 OD table, the float32 OD's
division and accurate logarithm), then times each from CUDA-graph replays
on the main path's shapes, B4 on 64x3x512^2 and 256x3x224^2 uint8 and B5 on
the 1x3x512^2 reference, and on the batch-mode training shapes, B4 on
128x3x256^2 float32 and B5 on its first 1x3x256^2 tile. A variant's time
against the full kernel's is what that part costs. The variants compute
wrong results on purpose; only the full kernel's are checked, against the
streamed route. Builds go to ``build/probe_cluster/`` (git-ignored).
Imports no JAX and nothing of ``stainx_tpu``.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

F32_OD = "__device__ __forceinline__ float od_f32(float v) { return -logf((v * 255.0f + 1.0f) / kIo); }"

# (what is taken out, the source text, its replacement)
VARIANTS = {
    "full kernel": [],
    "no angle selections": [("  cluster_select2<T, kAngle>(sl, w, use_all, sh, cluster);\n", "")],
    "no concentration selections": [("  cluster_select2<T, kConc>(sl, w, use_all, sh, cluster);\n", "")],
    "no reconstruction": [("  if (out == nullptr) return;\n", "  return;\n")],
    "no digit passes 2 and 3": [("  for (int d = 0; d < 4; ++d) {\n    const int buf = d & 1, shift = 24 - 8 * d;",
                                 "  for (int d = 0; d < 2; ++d) {\n    const int buf = d & 1, shift = 24 - 8 * d;")],
    # A flag that is never set keeps the keys computed but skips the atomics.
    "no histogram atomics": [("using namespace stainx;\n", "using namespace stainx;\n__device__ int g_never;\n"),
                             ("  if (bin < kBins) atomicAdd(rep +", "  if (bin < kBins && g_never) atomicAdd(rep +")],
    "no OD table (uint8)": [("__device__ __forceinline__ float od_of(uint8_t v, const float* lut) { return lut[v]; }",
                             "__device__ __forceinline__ float od_of(uint8_t v, const float* lut) "
                             "{ return 2.5f - static_cast<float>(v) * 0.0095f; }")],
    # float32 OD with the division and the accurate logf replaced: by the
    # special-function unit's approximate logarithm (nearly the same values,
    # so the selections take the same paths), or by no logarithm at all.
    "float32 OD by __logf": [(F32_OD, "__device__ __forceinline__ float od_f32(float v) "
                                      "{ return -__logf((v * 255.0f + 1.0f) * (1.0f / kIo)); }")],
    "float32 OD linear (no log)": [(F32_OD, "__device__ __forceinline__ float od_f32(float v) "
                                            "{ return 5.48f - v * 5.54f; }")],
}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--rounds", type=int, default=3)
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("probe_cluster_kernel: this needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from stainx_tpu_torch import kernels
    from stainx_tpu_torch.kernels import macenko_fused as mf
    from stainx_tpu_torch.kernels import macenko_stream as ms
    from stainx_tpu_torch.testing import synthetic_he_batch

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card.splitlines()[0])
    source = (kernels.CSRC / "macenko_stream.cu").read_text()
    common = "macenko_common.cuh"
    procs = {}
    for i, (name, edits) in enumerate(VARIANTS.items()):
        out_dir = os.path.join(ROOT, "build", "probe_cluster", str(i))
        os.makedirs(out_dir, exist_ok=True)
        texts = {"macenko_stream.cu": source}
        for header in kernels.CSRC.glob("*.cuh"):
            texts[header.name] = header.read_text()
        for old, new in edits:
            where = common if "od_of" in old or "od_f32" in old else "macenko_stream.cu"
            if texts[where].count(old) != 1:
                raise RuntimeError(f"variant {name!r}: the source no longer has {old.strip()!r}")
            texts[where] = texts[where].replace(old, new)
        for file_name, text in texts.items():
            with open(os.path.join(out_dir, file_name), "w") as f:
                f.write(text)
        lib = os.path.join(out_dir, "variant.so")
        procs[name] = (subprocess.Popen(
            [kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-o", lib, os.path.join(out_dir, "macenko_stream.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    kernels.build_all()
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name!r}:\n{log}")
        libs[name] = ctypes.CDLL(lib)
        libs[name].stainx_error_string.argtypes = [ctypes.c_int]
        libs[name].stainx_error_string.restype = ctypes.c_char_p

    dev = torch.device("cuda", 0)

    def u8(n, side, seed, scale=1.0):
        return torch.as_tensor(synthetic_he_batch(n, side, side, seed=seed, he_scale=scale)).to(dev)

    ref = [u8(1, 512, 42), u8(1, 512, 43)]
    he, mc = mf.macenko_fit_mega_plain(ref[0])
    batch = [u8(64, 512, 123), u8(64, 512, 124, 1.1)]
    tiles = [u8(256, 224, 227), u8(256, 224, 228, 1.1)]
    train = [u8(128, 256, 125).float() / 255.0, u8(128, 256, 126, 1.1).float() / 255.0]

    def transform(x):
        return ms.macenko_transform_stream(x, he, mc, force="cluster")

    def fit(x):
        return ms.macenko_fit_stream(x, force="cluster")

    cases = [("B4 64x3x512^2 u8", transform, batch), ("B4 256x3x224^2 u8", transform, tiles),
             ("B5 1x3x512^2 u8", fit, ref), ("B4 128x3x256^2 f32", transform, train),
             ("B5 1x3x256^2 f32", fit, [t[:1] for t in train])]

    def replay_ms(fn, xs, iters=30):
        graphs = []
        for x in xs:
            fn(x)
        torch.cuda.synchronize()
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

    times = {(name, label): [] for name in VARIANTS for label, _, _ in cases}
    for _ in range(args.rounds):
        for name, lib in libs.items():
            kernels._libs["macenko_stream"] = lib
            ms._active_clusters.cache_clear()
            for label, fn, xs in cases:
                times[name, label].append(replay_ms(fn, xs))
    kernels._libs["macenko_stream"] = libs["full kernel"]
    ms._active_clusters.cache_clear()
    same = torch.equal(transform(batch[0]), ms.macenko_transform_stream(batch[0], he, mc, force="stream"))
    print(f"full kernel equal to the streamed route on 64x3x512^2: {same}")
    for label, _, _ in cases:
        full = min(times["full kernel", label])
        for name in VARIANTS:
            t = times[name, label]
            print(f"{label}, {name}: {min(t):.4f}-{max(t):.4f} ms on the device over {args.rounds} "
                  f"rounds; the part taken out costs {full - min(t):+.4f} ms")
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
