#!/usr/bin/env python3
"""On-card check of the PyTorch / CUDA port (``stainx_tpu_torch``).

Run from the root of a checkout on a machine with one CUDA card and nvcc:

    python3 chip_smoke.py [--seed N]

Phases, in order; any failure ends the run with a non-zero exit:

1. the card (``nvidia-smi`` name and power limit), torch, CUDA and nvcc;
2. build every kernel from ``stainx_tpu_torch/csrc`` (timed);
3. each kernel against its plain PyTorch version on the same CUDA tensors:
   the Macenko fit (B2) on the 1×3×512² uint8 reference (HE atol 2e-5, maxC
   rtol 1e-4); the Macenko transform (B1) on the 64×3×512² uint8 batch, an
   8×3×512² float32 batch, a ragged 2×3×71×73 batch and a 2×3×1024² batch
   (≤ 1 grey level); the fit also on float32 and on a pooled 4×3×256² batch;
   all-white and uniform tiles; the Reinhard LAB moments (B7b, rtol 1e-4,
   atol 1e-2) and apply (B7a, ≤ 1 grey level or 1/255) on the batch, the
   float32 batch and (apply) the ragged batch; the 256-bin histogram (B8a,
   and B8c on a (C, P) input) on the batch, a ragged batch and an all-white
   tile, an unaligned and a 130-channel input, and the LUT apply (B8b,
   uint8 and float32 output) with a sorted and an out-of-range LUT and on
   the unaligned and 130-channel inputs, all exact; two runs of each kernel
   bit-identical;
4. each path through the public API at 64×3×512² uint8, with the launch
   counts set to 0 just before it and read just after:
   ``Macenko().fit(ref).transform(batch)`` (oracle MAE ≤ 0.35 on 8 of the
   images), ``Reinhard().fit(ref).transform(batch)`` and
   ``HistogramMatching().fit(ref).transform(batch)``; the Reinhard and
   histogram-matching oracle gates (≤ 1 grey level) run the public API on
   the first 8 images, since both take batch-global statistics; one NHWC
   ``HistogramMatching(channel_axis=-1)`` run;
5. timing with CUDA events after warm-up, cycling two distinct inputs:
   each kernel (replayed from CUDA graphs, the device's time, and called
   eagerly), its plain version and, where one PyTorch call computes the
   same function, that call; the public-API fit and transform of each
   normalizer (the transform also replayed, for the device's busy time and
   idle share); the histogram on an all-white batch.

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
TPU_REINHARD = "stainx_tpu/kernels/reinhard_fused.py"
TPU_HISTOGRAM = "stainx_tpu/kernels/histogram.py"
# float32 operations of one accurate powf on its common path as nvcc 12.9
# compiles it for sm_90a (cuobjdump -sass of a kernel that only calls
# powf): 11 FADD, 9 FMUL and 19 FFMA, an FFMA counted as two, beside one
# MUFU.RCP; the logarithm and the exponential are polynomials, not
# special-function instructions.
POWF_OPS = 58
# float32 operations a uint8 pixel needs beside its powf calls (the sRGB
# linearization is a table): RGB→XYZ 15, white point 2, f(t) 6, L/a/b 9;
# the moments add the centring and squares, 6; the apply adds the affine
# 12, LAB→XYZ 8, f⁻¹ 6, white point 3, XYZ→RGB 15, gamma 6, the ×255
# store 3. powf calls a pixel: 3 cube roots (moments), and 3 cube roots and
# 3 inverse gammas (apply).
OPS_PER_PIXEL_MOMENTS_U8 = 38 + 3 * POWF_OPS
OPS_PER_PIXEL_APPLY_U8 = 85 + 6 * POWF_OPS


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


def graph_ms(fn, inputs, iters: int) -> float:
    """Mean ms per call of ``fn`` replayed from CUDA graphs, one captured
    per input after a warm-up call: the device's time for the call's
    launches, without the host's cost of issuing them."""
    import torch

    for x in inputs:
        fn(x)
    torch.cuda.synchronize()
    graphs = []
    for x in inputs:
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            fn(x)
        graphs.append(graph)
    for graph in graphs:
        graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        graphs[i % len(graphs)].replay()
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

    from stainx_tpu_torch import HistogramMatching, Macenko, Reinhard, kernels
    from stainx_tpu_torch.kernels import histogram as hk
    from stainx_tpu_torch.kernels import macenko_fused as mf
    from stainx_tpu_torch.kernels import reinhard_fused as rf
    from stainx_tpu_torch.ops.reinhard import moments_to_mean_std
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

    # Reinhard: the LAB moments (B7b) and the fused apply (B7a).
    def check_moments(label, x):
        s_k = torch.cat(rf.reinhard_moments(x))
        s_p = torch.cat(rf.reinhard_moments_plain(x))
        again = torch.cat(rf.reinhard_moments(x))
        torch.cuda.synchronize()
        err = (s_k - s_p).abs().max().item()
        rel = ((s_k - s_p).abs() / s_p.abs()).max().item()
        print(f"B7b moments {label}: max|d| {err:.6g}, max rel {rel:.3g} (rtol 1e-4, atol 1e-2)")
        torch.testing.assert_close(s_k, s_p, rtol=1e-4, atol=1e-2)
        require(torch.equal(again, s_k), f"{label}: two B7b runs differ")
        n_px = x.shape[0] * x.shape[2] * x.shape[3]
        return err, moments_to_mean_std(float(n_px), s_k[:3], s_k[3:])

    _, (ref_mean, ref_std) = check_moments(f"1x3x{SIZE}^2 u8 (reference)", ref)
    b7b_err, stats_u8 = check_moments(f"{BATCH}x3x{SIZE}^2 u8", batch)
    batch_f32 = batch[:8].float() / 255.0
    _, stats_f32 = check_moments(f"8x3x{SIZE}^2 f32", batch_f32)
    _, stats_ragged = check_moments("2x3x71x73 u8 (ragged)", ragged)

    def check_apply(label, x, stats, tol):
        params = (*stats, ref_mean, ref_std)
        out_k = rf.reinhard_apply(x, *params)
        out_p = rf.reinhard_apply_plain(x, *params)
        again = rf.reinhard_apply(x, *params)
        torch.cuda.synchronize()
        err = (out_k.float() - out_p.float()).abs().max().item()
        print(f"B7a apply {label}: max|d| {err:.3g} (tolerance {tol:.4g})")
        require(out_k.dtype == x.dtype and out_k.shape == x.shape, f"{label}: dtype or shape")
        require(torch.isfinite(out_k.float()).all(), f"{label}: non-finite output")
        require(err <= tol, f"{label}: kernel and plain differ by {err}")
        require(torch.equal(again, out_k), f"{label}: two B7a runs differ")
        return err

    b7a_err = check_apply(f"{BATCH}x3x{SIZE}^2 u8", batch, stats_u8, 1.0)
    check_apply(f"8x3x{SIZE}^2 f32", batch_f32, stats_f32, 1.0 / 255.0)
    check_apply("2x3x71x73 u8 (ragged, scalar loads)", ragged, stats_ragged, 1.0)

    # Histogram matching: the 256-bin histogram (B8a, B8c) and the LUT apply (B8b).
    def check_hist(label, values):
        h_k = hk.histogram_256(values)
        h_p = hk.histogram_256_plain(values)
        again = hk.histogram_256(values)
        torch.cuda.synchronize()
        print(f"B8a histogram {label}: max|d| {(h_k - h_p).abs().max().item()} (exact), "
              f"{int(h_k.sum().item())} of {values.numel()} values counted")
        require(torch.equal(h_k, h_p), f"{label}: histogram differs from plain")
        require(torch.equal(again, h_k), f"{label}: two B8a runs differ")

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    values = batch.reshape(BATCH, 3, -1)
    # Not 16-byte aligned: the scalar loops. 130 channels: the counts and the
    # tables no longer fit shared memory, so the kernels use device memory.
    offset = values.reshape(-1)[3:3 + 3 * 100_003].reshape(1, 3, 100_003)
    many = torch.randint(0, 256, (2, 130, 257), generator=gen, device=dev, dtype=torch.uint8)
    check_hist(f"{BATCH}x3x{SIZE}^2", values)
    check_hist("2x3x(71*73) (ragged)", ragged.reshape(2, 3, -1))
    check_hist(f"all-white 1x3x{SIZE}^2", white.reshape(1, 3, -1))
    check_hist(f"(C, P) = (3, {SIZE}^2), the B8c form", batch[0].reshape(3, -1))
    check_hist("1x3x100003 at a 3-byte offset (scalar loads)", offset)
    check_hist("2x130x257 (130 channels)", many)

    def sorted_lut(c):
        return torch.sort(torch.rand(c, 256, generator=gen, device=dev) * 255.0, dim=1).values

    lut_sorted = sorted_lut(3)
    lut_extreme = torch.linspace(-5.0, 260.0, 256, device=dev).expand(3, 256).contiguous()
    for label, vals, lut in [
        (f"{BATCH}x3x{SIZE}^2, sorted LUT", values, lut_sorted),
        (f"{BATCH}x3x{SIZE}^2, LUT linspace(-5, 260)", values, lut_extreme),
        ("1x3x100003 at a 3-byte offset (scalar loads)", offset, lut_sorted),
        ("2x130x257 (130 channels)", many, sorted_lut(130)),
    ]:
        for out_dtype in (torch.uint8, torch.float32):
            a_k = hk.apply_lut(vals, lut, out_dtype)
            a_p = hk.apply_lut_plain(vals, lut, out_dtype)
            again = hk.apply_lut(vals, lut, out_dtype)
            torch.cuda.synchronize()
            print(f"B8b apply {label} -> {out_dtype}: max|d| "
                  f"{(a_k.float() - a_p.float()).abs().max().item()} (exact)")
            require(torch.equal(a_k, a_p), f"{label}: apply_lut differs from plain")
            require(torch.equal(again, a_k), f"{label}: two B8b runs differ")

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

    def drive(label, wrappers, path):
        for w in wrappers:
            w.launches = 0
        result = path()
        torch.cuda.synchronize()
        counts = {w.__name__: w.launches for w in wrappers}
        print(f"{label} path launches: {counts}")
        require(all(n > 0 for n in counts.values()), f"a kernel of the {label} path never launched")
        require(result.is_cuda and result.dtype == torch.uint8 and result.shape == batch.shape,
                f"{label} output is not a uint8 batch of the input shape on the card")
        return result, counts

    reinhard = Reinhard()
    _, r_launches = drive("Reinhard", [rf.reinhard_moments, rf.reinhard_apply],
                          lambda: reinhard.fit(ref).transform(batch))
    hist_match = HistogramMatching()
    hm_out, h_launches = drive("HistogramMatching", [hk.histogram_256, hk.apply_lut],
                               lambda: hist_match.fit(ref).transform(batch))

    def grey_gate(label, got, expect):
        err = float(np.abs(got.cpu().numpy().astype(np.float32) - expect.astype(np.float32)).max())
        print(f"{label} vs oracle on 8 images: max|d| {err} grey levels (gate 1)")
        require(err <= 1.0, f"{label}: {err} grey levels from the oracle")

    mean_o, std_o = oracle.reinhard_fit(ref_np)
    grey_gate("Reinhard", Reinhard().fit(ref).transform(batch[:8]),
              oracle.reinhard_transform(sub, mean_o, std_o))
    grey_gate("HistogramMatching", HistogramMatching().fit(ref).transform(batch[:8]),
              oracle.hm_transform(sub, oracle.hm_fit(ref_np)))
    nhwc = HistogramMatching(channel_axis=-1).fit(ref.permute(0, 2, 3, 1))
    nhwc_out = nhwc.transform(batch.permute(0, 2, 3, 1))
    torch.cuda.synchronize()
    print(f"HistogramMatching NHWC: shape {tuple(nhwc_out.shape)}, "
          f"equal to NCHW {torch.equal(nhwc_out.permute(0, 3, 1, 2), hm_out)}")
    require(torch.equal(nhwc_out.permute(0, 3, 1, 2), hm_out), "NHWC and NCHW outputs differ")

    # 5. Timing: CUDA events, warm-up first, two distinct inputs cycled. A
    # kernel's time is its wrapper replayed from CUDA graphs, the device's
    # time (the wrapper's own small ops, such as the LUT table, included);
    # called eagerly, a short kernel is timed by the host's launch cost. The
    # public API is timed as a user calls it, and replayed for the time the
    # device is busy in it: the rest is the device's idle share.
    def kernel_ms(label, fn, inputs):
        on_device, eager = graph_ms(fn, inputs, 20), event_ms(fn, inputs, 20)
        print(f"{label}: {on_device:.4f} ms on the device (graph replay), "
              f"{eager:.4f} ms called eagerly")
        return on_device

    def api_ms(label, fn, inputs):
        eager, busy = event_ms(fn, inputs, 20), graph_ms(fn, inputs, 20)
        print(f"public API {label}: {eager:.4f} ms/batch ({BATCH * SIZE * SIZE / eager / 1e3:.1f} "
              f"MPix/s), device busy {busy:.4f} ms, idle share {1.0 - busy / eager:.3f}")
        return eager

    pair = [batch, batch_b]
    ms_t = kernel_ms("B1 macenko_transform_mega", lambda x: mf.macenko_transform_mega(x, he_k, mc_k), pair)
    ms_tp = event_ms(lambda x: mf.macenko_transform_mega_plain(x, he_k, mc_k), pair, 3)
    ms_f = kernel_ms("B2 macenko_fit_mega", mf.macenko_fit_mega, [ref, ref_b])
    ms_fp = event_ms(mf.macenko_fit_mega_plain, [ref, ref_b], 5)
    api_ms("Macenko transform", normalizer.transform, pair)
    print(f"public API Macenko fit 1x3x{SIZE}^2: "
          f"{event_ms(lambda x: Macenko().fit(x), [ref, ref_b], 20):.4f} ms")

    values_b = batch_b.reshape(BATCH, 3, -1)
    params = (*stats_u8, ref_mean, ref_std)
    ms_b7b = kernel_ms("B7b reinhard_moments", rf.reinhard_moments, pair)
    ms_b7b_p = event_ms(rf.reinhard_moments_plain, pair, 3)
    ms_b7a = kernel_ms("B7a reinhard_apply", lambda x: rf.reinhard_apply(x, *params), pair)
    ms_b7a_p = event_ms(lambda x: rf.reinhard_apply_plain(x, *params), pair, 3)
    ms_b8a = kernel_ms("B8a histogram_256", hk.histogram_256, [values, values_b])
    ms_b8a_p = event_ms(hk.histogram_256_plain, [values, values_b], 5)
    ms_b8a_lib = event_ms(
        lambda v: torch.stack([torch.bincount(v[:, c].reshape(-1), minlength=256) for c in range(3)]),
        [values, values_b], 5)
    whites = [torch.full_like(values, 255), torch.full_like(values, 255)]
    kernel_ms(f"B8a histogram_256 on an all-white {BATCH}x3x{SIZE}^2 batch", hk.histogram_256, whites)
    ms_b8b = kernel_ms("B8b apply_lut", lambda v: hk.apply_lut(v, lut_sorted), [values, values_b])
    ms_b8b_p = event_ms(lambda v: hk.apply_lut_plain(v, lut_sorted), [values, values_b], 5)
    table, c_idx = hk.lut_table(lut_sorted, torch.uint8), torch.arange(3, device=dev).view(1, 3, 1)
    ms_b8b_lib = event_ms(lambda v: table[c_idx, v.long()], [values, values_b], 5)

    for name, norm_cls, fitted, kernels_ms in [
        ("Reinhard", Reinhard, reinhard, ms_b7b + ms_b7a),
        ("HistogramMatching", HistogramMatching, hist_match, ms_b8a + ms_b8b),
    ]:
        ms_t_api = api_ms(f"{name} transform", fitted.transform, pair)
        print(f"public API {name}: its kernels alone {kernels_ms:.4f} ms, the rest "
              f"{ms_t_api - kernels_ms:.4f} ms; fit 1x3x{SIZE}^2 "
              f"{event_ms(lambda x, cls=norm_cls: cls().fit(x), [ref, ref_b], 20):.4f} ms, "
              f"fit {BATCH}x3x{SIZE}^2 "
              f"{event_ms(lambda x, cls=norm_cls: cls().fit(x), pair, 10):.4f} ms")

    n_px = BATCH * SIZE * SIZE
    b1_bound, b1_by = bound_ms(2 * 3 * n_px, OPS_PER_PIXEL_TRANSFORM * n_px)
    b2_bound, b2_by = bound_ms(3 * SIZE * SIZE + 8 * 4, OPS_PER_PIXEL_FIT * SIZE * SIZE)
    b7b_bound, b7b_by = bound_ms(3 * n_px + 6 * 4, OPS_PER_PIXEL_MOMENTS_U8 * n_px)
    b7a_bound, b7a_by = bound_ms(2 * 3 * n_px + 12 * 4, OPS_PER_PIXEL_APPLY_U8 * n_px)
    b8a_bound, b8a_by = bound_ms(3 * n_px + 3 * 256 * 4, 0)
    b8b_bound, b8b_by = bound_ms(2 * 3 * n_px + 3 * 256 * 4, 0)
    print(f"B7b bound: bytes {3 * n_px / HBM_BYTES_PER_S * 1e3:.4f} ms, float32 operations "
          f"{OPS_PER_PIXEL_MOMENTS_U8 * n_px / F32_OPS_PER_S * 1e3:.4f} ms; B7a bound: bytes "
          f"{6 * n_px / HBM_BYTES_PER_S * 1e3:.4f} ms, float32 operations "
          f"{OPS_PER_PIXEL_APPLY_U8 * n_px / F32_OPS_PER_S * 1e3:.4f} ms")
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
        {"name": "reinhard_moments", "route": "cuda",
         "source": "stainx_tpu_torch/csrc/reinhard_fused.cu", "replaces": f"{TPU_REINHARD}:192",
         "launches": r_launches["reinhard_moments"], "max_abs_err": b7b_err,
         "ms": ms_b7b, "plain_ms": ms_b7b_p, "bound_ms": b7b_bound, "bound_by": b7b_by,
         "library_ms": None},
        {"name": "reinhard_apply", "route": "cuda",
         "source": "stainx_tpu_torch/csrc/reinhard_fused.cu", "replaces": f"{TPU_REINHARD}:124",
         "launches": r_launches["reinhard_apply"], "max_abs_err": b7a_err,
         "ms": ms_b7a, "plain_ms": ms_b7a_p, "bound_ms": b7a_bound, "bound_by": b7a_by,
         "library_ms": None},
        {"name": "histogram_256", "route": "cuda",
         "source": "stainx_tpu_torch/csrc/histogram.cu", "replaces": f"{TPU_HISTOGRAM}:191",
         "launches": h_launches["histogram_256"], "max_abs_err": 0.0,
         "ms": ms_b8a, "plain_ms": ms_b8a_p, "bound_ms": b8a_bound, "bound_by": b8a_by,
         "library_ms": ms_b8a_lib},
        {"name": "apply_lut", "route": "cuda",
         "source": "stainx_tpu_torch/csrc/histogram.cu", "replaces": f"{TPU_HISTOGRAM}:261",
         "launches": h_launches["apply_lut"], "max_abs_err": 0.0,
         "ms": ms_b8b, "plain_ms": ms_b8b_p, "bound_ms": b8b_bound, "bound_by": b8b_by,
         "library_ms": ms_b8b_lib},
    ]
    for r in rows:
        lib_ms = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
        print(f"{r['name']}: {r['ms']:.4f} ms (bound {r['bound_ms']:.4f} ms by {r['bound_by']}), "
              f"plain {r['plain_ms']:.4f} ms, library {lib_ms}")
    print(json.dumps({"kernels": rows}))
    print(card.splitlines()[0])
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
