#!/usr/bin/env python3
"""On-card check of the PyTorch / CUDA port (``stainx_tpu_torch``).

Run from the root of a checkout on a machine with one CUDA card and nvcc:

    python3 chip_smoke.py [--seed N]

Phases, in order; any failure ends the run with a non-zero exit:

1. the card (``nvidia-smi`` name and power limit), torch, CUDA and nvcc;
2. build every kernel from ``stainx_tpu_torch/csrc`` (timed);
3. each kernel against its plain PyTorch version on the same CUDA tensors:
   the fit (B2) on the 1×3×512² uint8 reference (HE atol 2e-5, maxC
   rtol 1e-4); the transform (B1) on the 64×3×512² uint8 batch, an
   8×3×512² float32 batch, a ragged 2×3×71×73 batch and a 2×3×1024² batch
   (≤ 1 grey level); the fit also on float32 and on a pooled 4×3×256² batch;
   all-white and uniform tiles; two runs of each kernel bit-identical;
4. the main path through the public API, ``Macenko().fit(ref).transform(
   batch)`` at 64×3×512² uint8, with the launch counts set to 0 just before
   and read just after; the output must be on the card and within MAE 0.35
   of the numpy oracle on 8 of the images;
5. timing with CUDA events after warm-up, cycling two distinct inputs:
   each kernel, its plain version, and the public-API fit and transform.

Prints a ``{"kernels": [...]}`` line, then as its last line
``{"ok": true, "device": {...}}``. Data is synthetic, made from ``--seed``.
Imports no JAX and nothing of ``stainx_tpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

BATCH, SIZE = 64, 512  # the main path: bench.py's configuration
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
# float32 operations a pixel needs, each formula evaluated once: OD 9,
# β-mask 3, moments 19, projection 10, pseudo-angle 8, concentrations 10,
# one compare per selection 4; the transform adds the rescale and
# reconstruction, 26.
OPS_PER_PIXEL_FIT = 63
OPS_PER_PIXEL_TRANSFORM = 89
TPU_SOURCE = "stainx_tpu/kernels/macenko_fused.py"


def bound_ms(bytes_moved: float, ops: float) -> tuple[float, str]:
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def require(ok: bool, what: str) -> None:
    """Fail the run when a check does not hold (kept under ``python -O``)."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def run(cmd: list[str]) -> str:
    return subprocess.run(cmd, check=True, capture_output=True, text=True).stdout.strip()


def event_ms(fn, inputs, iters: int) -> float:
    """Mean ms per call of ``fn`` over ``iters`` calls cycling ``inputs``,
    after one warm-up call on each input, timed with CUDA events."""
    import torch

    for x in inputs:
        fn(x)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(inputs[i % len(inputs)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check needs a card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    # tests/ has no __init__.py, and an installed package named `tests`
    # would shadow it: load the numpy oracle from its own directory.
    sys.path.insert(0, os.path.join(ROOT, "tests", "oracles"))
    import numpy as np
    import numpy_reference as oracle

    from stainx_tpu_torch import Macenko, kernels
    from stainx_tpu_torch.kernels import macenko_fused as mf
    from stainx_tpu_torch.testing import synthetic_he_batch

    dev = torch.device("cuda", 0)

    # 1. The card and the toolchain.
    card = run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    print(card.splitlines()[0])
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"nvcc {run([kernels.nvcc_path(), '--version']).splitlines()[-1]}")

    # 2. Build.
    t0 = time.perf_counter()
    libs = kernels.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s for {sorted(libs)}")

    def dev_u8(a):
        return torch.as_tensor(np.ascontiguousarray(a)).to(dev)

    ref = dev_u8(synthetic_he_batch(1, SIZE, SIZE, seed=args.seed + 42))
    ref_b = dev_u8(synthetic_he_batch(1, SIZE, SIZE, seed=args.seed + 43))
    batch = dev_u8(synthetic_he_batch(BATCH, SIZE, SIZE, seed=args.seed + 123))
    batch_b = dev_u8(synthetic_he_batch(BATCH, SIZE, SIZE, seed=args.seed + 124, he_scale=1.1))

    # 3. Each kernel against its plain version on the same tensors.
    he_k, mc_k = mf.macenko_fit_mega(ref)
    he_p, mc_p = mf.macenko_fit_mega_plain(ref)
    torch.cuda.synchronize()
    fit_err = max((he_k - he_p).abs().max().item(), (mc_k - mc_p).abs().max().item())
    mc_rel = ((mc_k - mc_p).abs() / mc_p.abs()).max().item()
    print(f"B2 fit 1x3x{SIZE}^2 u8: HE max|d| {(he_k - he_p).abs().max().item():.3g} "
          f"(atol 2e-5), maxC max rel {mc_rel:.3g} (rtol 1e-4)")
    torch.testing.assert_close(he_k, he_p, atol=2e-5, rtol=0)
    torch.testing.assert_close(mc_k, mc_p, atol=0, rtol=1e-4)
    he2, mc2 = mf.macenko_fit_mega(ref)
    require(torch.equal(he2, he_k) and torch.equal(mc2, mc_k), "two B2 runs differ")
    for label, x in [("1x3x512^2 f32", ref.float() / 255.0),
                     ("pooled 4x3x256^2 u8", dev_u8(synthetic_he_batch(4, 256, 256, seed=args.seed + 5)))]:
        he_x, mc_x = mf.macenko_fit_mega(x)
        he_xp, mc_xp = mf.macenko_fit_mega_plain(x)
        torch.cuda.synchronize()
        print(f"B2 fit {label}: HE max|d| {(he_x - he_xp).abs().max().item():.3g}")
        torch.testing.assert_close(he_x, he_xp, atol=2e-5, rtol=0)
        torch.testing.assert_close(mc_x, mc_xp, atol=0, rtol=1e-4)

    def check_transform(label, x, he, mc):
        out_k = mf.macenko_transform_mega(x, he, mc)
        out_p = mf.macenko_transform_mega_plain(x, he, mc)
        again = mf.macenko_transform_mega(x, he, mc)
        torch.cuda.synchronize()
        err = (out_k.float() - out_p.float()).abs().max().item()
        print(f"B1 transform {label}: max|d| {err:.3g} grey levels (tolerance 1)")
        require(out_k.dtype == x.dtype and out_k.shape == x.shape, f"{label}: dtype or shape")
        require(torch.isfinite(out_k.float()).all(), f"{label}: non-finite output")
        require(err <= 1.0, f"{label}: kernel and plain differ by {err}")
        require(torch.equal(again, out_k), f"{label}: two runs differ")
        return out_k, err

    _, b1_err = check_transform(f"{BATCH}x3x{SIZE}^2 u8", batch, he_k, mc_k)
    check_transform(f"8x3x{SIZE}^2 f32", batch[:8].float() / 255.0, he_k, mc_k)
    ragged = dev_u8(synthetic_he_batch(2, 71, 73, seed=args.seed + 7))
    check_transform("2x3x71x73 u8 (ragged, scalar loads)", ragged, he_k, mc_k)
    large = dev_u8(synthetic_he_batch(2, 1024, 1024, seed=args.seed + 8))
    check_transform("2x3x1024^2 u8", large, he_k, mc_k)
    white = torch.full((1, 3, SIZE, SIZE), 255, dtype=torch.uint8, device=dev)
    check_transform("all-white (fallback)", white, he_k, mc_k)
    uniform, _ = check_transform("uniform 250", torch.full_like(white, 250), he_k, mc_k)
    flat = uniform.reshape(3, -1)
    require((flat.amax(1) == flat.amin(1)).all(), "uniform tile did not stay uniform per channel")

    # 4. The main path through the public API.
    mf.macenko_fit_mega.launches = mf.macenko_transform_mega.launches = 0
    normalizer = Macenko()
    out = normalizer.fit(ref).transform(batch)
    torch.cuda.synchronize()
    launches = {"macenko_fit_mega": mf.macenko_fit_mega.launches,
                "macenko_transform_mega": mf.macenko_transform_mega.launches}
    print(f"main path launches: {launches}")
    require(all(n > 0 for n in launches.values()), "a kernel of the main path never launched")
    require(out.is_cuda and out.dtype == torch.uint8 and out.shape == batch.shape,
            "main path output is not a uint8 batch of the input shape on the card")
    ref_np, sub = ref.cpu().numpy(), batch[:8].cpu().numpy()
    he_o, mc_o = oracle.macenko_fit(ref_np)
    expect = oracle.macenko_transform(sub, he_o, mc_o).astype(np.float32)
    mae = float(np.abs(out[:8].cpu().numpy().astype(np.float32) - expect).mean())
    print(f"oracle MAE on 8 images: {mae:.4f} (gate 0.35)")
    require(mae <= 0.35, f"oracle MAE {mae} above 0.35")

    # 5. Timing: CUDA events, warm-up first, two distinct inputs cycled.
    ms_t = event_ms(lambda x: mf.macenko_transform_mega(x, he_k, mc_k), [batch, batch_b], 20)
    ms_tp = event_ms(lambda x: mf.macenko_transform_mega_plain(x, he_k, mc_k), [batch, batch_b], 3)
    ms_f = event_ms(mf.macenko_fit_mega, [ref, ref_b], 20)
    ms_fp = event_ms(mf.macenko_fit_mega_plain, [ref, ref_b], 5)
    ms_api_t = event_ms(normalizer.transform, [batch, batch_b], 20)
    ms_api_f = event_ms(lambda x: Macenko().fit(x), [ref, ref_b], 20)
    mpix = BATCH * SIZE * SIZE / 1e6
    print(f"public API: transform {ms_api_t:.4f} ms/batch ({mpix / ms_api_t * 1e3:.1f} MPix/s), "
          f"fit {ms_api_f:.4f} ms")

    n_px = BATCH * SIZE * SIZE
    b1_bound, b1_by = bound_ms(2 * 3 * n_px, OPS_PER_PIXEL_TRANSFORM * n_px)
    b2_bound, b2_by = bound_ms(3 * SIZE * SIZE + 8 * 4, OPS_PER_PIXEL_FIT * SIZE * SIZE)
    rows = [
        {"name": "macenko_transform_mega", "route": "cuda",
         "source": "stainx_tpu_torch/csrc/macenko_fused.cu", "replaces": f"{TPU_SOURCE}:529",
         "launches": launches["macenko_transform_mega"], "max_abs_err": b1_err,
         "ms": ms_t, "plain_ms": ms_tp, "bound_ms": b1_bound, "bound_by": b1_by,
         "library_ms": None},
        {"name": "macenko_fit_mega", "route": "cuda",
         "source": "stainx_tpu_torch/csrc/macenko_fused.cu", "replaces": f"{TPU_SOURCE}:748",
         "launches": launches["macenko_fit_mega"], "max_abs_err": fit_err,
         "ms": ms_f, "plain_ms": ms_fp, "bound_ms": b2_bound, "bound_by": b2_by,
         "library_ms": None},
    ]
    for r in rows:
        print(f"{r['name']}: {r['ms']:.4f} ms (bound {r['bound_ms']:.4f} ms by {r['bound_by']}), "
              f"plain {r['plain_ms']:.4f} ms")
    print(json.dumps({"kernels": rows}))
    print(card.splitlines()[0])
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
