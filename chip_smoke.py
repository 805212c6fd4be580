#!/usr/bin/env python3
"""On-card check of the PyTorch / CUDA port (``stainx_tpu_torch``).

Run from the root of a checkout on a machine with one CUDA card and nvcc:

    python3 chip_smoke.py [--seed N]

Phases, in order; any failure ends the run with a non-zero exit:

1. the card (``nvidia-smi`` name and power limit), torch, CUDA and nvcc;
2. build every kernel from ``stainx_tpu_torch/csrc`` (timed);
3. each kernel against its plain PyTorch version on the same CUDA tensors:
   the Macenko transform (B1) on the 64×3×512² uint8 batch, an 8×3×512²
   float32 batch, a ragged 2×3×71×73 batch and a 2×3×1024² batch (≤ 1 grey
   level), all-white and uniform tiles; the Reinhard LAB moments (B7b, rtol 1e-4,
   atol 1e-2) and apply (B7a, ≤ 1 grey level or 1/255, with the share of
   outputs that differ at all) on the batch, the float32 batch, the
   ragged batch, the colour cube (every RGB triple once, 1×3×4096² uint8;
   the apply under its own statistics and the reference's) and float32
   values 64 ulps either side of the colour formulas' branch points, the
   mean and std B7b's finalize writes against their plain version
   ``moments_to_mean_std`` (bit for bit), and the transform (B7b, B7a on
   the finalize's statistics) against the plain steps on the batch, the
   float32 batch and the ragged batch (≤ 1 grey level or 1/255, two runs
   bit-identical); the 256-bin histogram (B8a,
   and B8c on a (C, P) input) on the batch, a ragged batch and an all-white
   tile, an unaligned and a 130-channel input, and the LUT apply (B8b,
   uint8 and float32 output) with a sorted and an out-of-range LUT and on
   the unaligned and 130-channel inputs, all exact; the HM fit (B8a and a
   finalize that normalizes) and transform (B8a, a finalize that builds the
   LUT and its table on the card, B8b; one C call) bit for bit against
   ``normalized_histogram``, ``hm_build_lut``, ``lut_table`` and the plain
   steps on the main batch (uint8 and float32 tables), the batch matched to
   itself, an empty reference channel, an odd unaligned P, a ragged batch,
   C = 1 and C = 12, and the finalize alone on counts with an empty source
   channel, two runs bit-identical; B1's resident body (an image in one
   block's shared memory) on small patches (uint8 and float32), uniform
   tiles, a tile that takes the <3-pixel fallback, ragged rows, and the
   largest rows it keeps resident and the first it does not, within 1 grey
   level of its plain version, its four selections bit for bit against
   ``kth_smallest`` on the keys it selected on; the Macenko fit (B2: the
   pool in one block's shared memory) on a 64² patch (uint8 and float32),
   a ragged 71×73 patch (uint8 and float32, also at an odd byte and a
   4-byte offset, as ``batch_ref_index=1`` hands it), pools of 4×64²,
   8×48² and a ragged 3×71×73, the largest pools it holds (uint8 and
   float32), uniform pools (one past the β-mask, one with no pixel past
   it, whose HE is NaN as the plain version's is) and a white float32
   patch, within HE atol 2e-5 and maxC rtol 1e-4 of its plain version and
   repeated bit for bit, its four selections bit for bit against
   ``kth_smallest`` on the keys it selected on; the first pool past the
   largest, which B2 refuses and B5 fits; the streaming tier: the
   exact selection (B6) bit for bit on (1, 2²⁴), (512, 224²) and ragged
   (3, 1 000 003) fields, K = 2, with and without init, with sentinels,
   ranks past the count and an empty row, K = 10 (two launches),
   (65 536, 64) K = 1, more rows than a grid's y extent, and randn rows of
   2²² at (32, K = 1) and (16, K = 2), where a block appends its staged
   candidates more than once a pass; the
   multi-block fit (B5) against B2's plain version on the 256×3×224²
   float32 pool of path (a), the 64×3×512² batch and the reference (HE atol
   2e-5, maxC rtol 1e-4), and through ``Macenko().fit`` on a pool of
   65 536×3×16² uint8, past the streamed grid's old 65 535-image limit,
   against B5's plain version; the multi-block transform (B4) against B1's plain
   version on 4×3×2048² and 1×3×4096² uint8, 1×3×2048² float32, a ragged
   1×3×1999×2011, an all-white 2048² tile, 1×3×8192² uint8, the 64×3×512²
   batch and path (a)'s 256×3×224² float32 batch, and B1 on 256×3×64²
   and 256×3×224² uint8 and 256×3×224² float32 (≤ 1 grey level); B4 and B5 on both their routes
   (cluster and streamed) wherever the rows fit a cluster; the selections
   fused into B4 and B5 bit for bit against B6's plain version on the keys
   the call selected on (written by a check-only entry with the kernels'
   own device functions) for the main path's fit and transform, path (a)'s
   pool and batch, path (b), a float32 2048² image and WSI tiles, on each
   route; B4 and B5 on float32 rows, which take each pixel's OD once a
   call (resident planes as OD, a key field for the rest), bit for bit
   against the same source built with OD taken on every pass
   (``per_pass_build``) at the batch-mode training shapes (128×3×256² and
   1×3×256²), ragged rows past the resident part on clusters of 2 and 4,
   forced cluster shapes with few pixels resident (a pooled fit, a white
   batch that takes the fallback) and the tile store's uint8 rows, with
   each call's ``keyfield.*`` count and the batch-mode forward's launches
   (one B4, its fit fused in: ``fit.fused``);
   ``normalize_to_0_1``'s ÷255 folded into the float32 transform kernels'
   store (the card tests of ``tests/test_torch_fold_range.py``, in a pytest
   process: every float32 route of B1 and B4 against its unscaled output
   divided by 255 bit for bit, the batch-mode training forward against the
   two-step form on its own fit with one ``finalize.folded`` a forward, the
   uint8 kernels' SASS instruction counts); batch mode's fit fused into B4's
   cluster launch (the card tests of ``tests/test_torch_fused_fit.py``: row
   statistics bit for bit B4's, the fit within 2e-5 of B5's, outputs within
   a grey level of the two launches and bit for bit B4's on the fused fit,
   reference tiles with 0 and 2 beta-masked pixels, launch counts, a stale
   fused state failing the training cell's check, the transform-only
   kernels' SASS counts); the exact row select (B3) bit for bit on the staged fit's
   (1, 512²) K=2 and (2, 512²) K=1, (64, 512²) K=2, (128, 512²) K=1,
   (256, 224²) K=2, (512, 224²) K=1, ragged (3, 1 000 003) and (5, 50 001)
   fields with sentinels, ties, ranks past the count and an empty row, a
   crowded angle-like field (one top key byte), rows whose min equals their
   max and rows of only +inf, on a row of ±0.0, with K = 10 (two
   launches), on every cluster size the wrapper can pick, and on every
   field that paths (c) and (d) feed B3 and B6 (recorded as the calls make
   them; B6 also with an init); two runs of each kernel bit-identical;
4. each path through the public API, with the launch counts set to 0 just
   before it and read just after:
   ``Macenko().fit(ref).transform(batch)`` at 64×3×512² uint8 (oracle MAE
   ≤ 0.35 on 8 of the images), ``Reinhard().fit(ref).transform(batch)`` and
   ``HistogramMatching().fit(ref).transform(batch)``, the Reinhard
   transform's device work read from ``torch.profiler`` (B7b, its
   finalize, B7a, nothing between), its output held against the plain
   steps (≤ 1 grey level) and against a second transform (bit for bit);
   the same for the HM transform (B8a, its finalize, B8b; bit for bit);
   at the benchmark cells' shapes (Reinhard 128×3×512², HM 256×3×512²
   uint8), each transform in a profiler session holds one ``stainx.stats``
   span a call with a device interval and launches B7b + B7a or B8a + B8b,
   with outputs equal to an unprofiled call's (``stats_span_checks``);
   the Reinhard and
   histogram-matching oracle gates (≤ 1 grey level) run the public API on
   the first 8 images, since both take batch-global statistics; one NHWC
   ``HistogramMatching(channel_axis=-1)`` run; path (a), the batch-mode
   ``StainNormalizerTransform("macenko", mode="batch", batch_ref_index=None)``
   on 256×3×224² float32 (oracle fitted on the same pool, MAE ≤ 0.35 on 8
   images), also with ``batch_ref_index=0``, and Reinhard and histogram
   matching in batch mode once each; WSI tiles, ``Macenko().fit(tile)
   .transform(tiles)`` on 256×3×224² uint8 with one of the tiles as the
   reference (MAE ≤ 0.35 on 8 tiles); small patches, the same on
   256×3×64² uint8 with a 64² reference patch; small-patch batch mode,
   ``StainNormalizerTransform("macenko", mode="batch")`` with its default
   ``batch_ref_index=0`` on 256×3×64² uint8 and float32 (B2 and B1 once
   each; oracle fitted on the first patch, MAE ≤ 0.35 on 8 patches); path
   (b), ``Macenko().fit(ref)
   .transform(batch)`` on 4×3×2048² and 1×3×4096² uint8 (MAE ≤ 0.35 on one
   image); path (c), the staged route, ``Macenko(precision=...).fit(ref)
   .transform(batch)`` at 64×3×512² bfloat16 under "stable" and "fast" and
   at float16, and path (d), the batch-mode transform on 256×3×224²
   float16 (oracle MAE ≤ 0.35 on 8 images, the oracle run on the float32
   values of the same low-precision input). Each Macenko path must launch
   the kernels written beside it;
4b. in a spawned process of its own (its process groups and profiler
   runs leave this process's later timings as they were; inputs made
   from the same seeds), the distributed layer (``stainx_tpu_torch.
   parallel``) on a 1-rank group (NCCL for the card, gloo for the CPU; the
   card count printed):
   ``fit_on_mesh`` and ``transform_on_mesh`` of every method on the main
   batch against the single-device port on the card (JAX's mesh
   tolerances: HE atol 2e-3, maxC rtol 1e-2, transforms 1 grey level) and,
   driven with the launch counters read before and after, against the
   same calls on the CPU through the plain versions (Reinhard mean and std
   rtol 1e-4 atol 1e-3, HM histograms atol 1e-6, Macenko HE atol 2e-5 and
   maxC rtol 1e-4, transforms 1 grey level): the fits launch B7b, B8a and
   no kernel (the eager Macenko fit), the transforms B7b and B7a, B8a and
   B8b, B4; the batch-mode ``StainNormalizerTransform(mesh=...)`` on
   256×3×64² patches launches B2 and B1; the pixel-sharded Macenko
   transform of 1×3×4096² on a (1, 1) ``("batch", "pixel")`` mesh (eager)
   against the CPU and against B4; then each path timed as called, with
   its device busy time (``torch.profiler``) and idle share, beside the
   single-device call, and the pixel-sharded transform split on the
   device between the collectives that end its steps. With two cards or
   more, the fits and transforms also run on a group of two ranks, one
   card each, against the single-device port;
4c. the tile-ingest path (``stainx_tpu_torch.io``): 512 tiles of 3×512²
   uint8 written one a file under the temporary directory, then
   ``RawTileLoader(files, (3, 512, 512), 64, drop_remainder=True)`` on the
   card (the native readers, built under ``build/stainx_tpu_torch/``, and
   the page-locked copy) into ``StainNormalizerTransform("macenko",
   reference=ref)``, with the launch counters read before and after
   (B5 once, B4 once a batch, nothing else); its output bit for bit the
   same transform's of the batches read with ``np.fromfile`` and copied to
   the card, and a CPU-device loader's batches byte for byte those; the
   JAX package's ``stainx_tpu/io/_tilepipe.so`` left as it was;
   ``masked_nearest_rank_percentile`` and ``percentile_all`` on the card
   (B3 on (64, 512²), B6 on (1, 2²⁴) float32 rows with a random mask, −inf
   and NaN entries and an empty row) bit for bit their CPU versions;
   ``profiling.time_fn`` on the Macenko transform within 10 % of
   ``event_ms`` and a trace written by ``profiling.trace``; then the times
   of ``examples/torch_wsi_ingest_example.py``'s legs (ingest-only,
   copy-only, compute-only, end to end; the host link's rate; the overlap
   efficiency) and the device's busy time a batch by graph replay of the
   transform (the idle share of the end-to-end loop);
5. timing with CUDA events after warm-up, cycling two distinct inputs:
   each kernel (replayed from CUDA graphs, the device's time, and called
   eagerly), its plain version and, where one PyTorch call computes the
   same function, that call (B7b and B7a also on float32); B4 and B5 at
   every path shape on their routes,
   with their bounds, and B4 and B5 at the main path's shapes on every
   cluster size; the public-API fit and transform of each
   normalizer and the Macenko paths (also replayed, for the device's busy
   time and idle share, which the kernel time ``torch.profiler`` records
   cross-checks); the histogram on an all-white batch; the HM finalize
   alone and each kernel of the HM fit and transform by ``torch.profiler``;
   B1 at small patches on both its bodies; B2 at a 64² patch (uint8,
   float32), a 128² reference and the largest pool it holds; the
   small-patch batch-mode forwards; the sweep of B1's resident body
   against its L2 body up to the resident limit; the sweep of B1 against
   B4 over sizes and of B2 against B5 over the pools B2 holds, in three
   rounds with their spread, that sets the route ladder of
   ``stainx_tpu_torch/ops/macenko.py``; B3 at the shapes of paths (c)
   (its fit and transform) and (d), on their own fields, and on short
   rows (224² and 64², as a staged fit of such a reference gives), on every
   cluster size, and B6 at path (d)'s two fields, with ``torch.kthvalue`` as the
   library call; the staged paths (c) and (d) and the staged 512² fit; and
   the sweep of B3 against B6 over rows and row lengths, in three rounds,
   that sets ``SELECT_STREAM_MIN_ELEMS`` and ``SELECT_STREAM_MAX_ROWS``.
6. the measuring scripts (``bench_torch.py``, ``benchmarks_torch/``), each
   ``main`` called in this process at reduced runs: the bench's last line
   has ``bench.py``'s four keys and a finite positive value, and a call
   launches B4 once; one tile a call at 512², 2048² and 4096², each tile
   bit-identical on its next pass; batch mode for the three methods on
   256×3×224² uint8, each launching kernels, and the pooled Macenko fit on
   float32; the correctness report on uint8 and float32 with the 321×199
   probe (32 rows), every gate passed; one grid row a method at 64×3×512²
   uint8 within its MAE gate. Their full output goes to
   ``build/harness.log``;
7. the committed structured tiles (``examples/data/``: target.png and
   test_1..5.png, 384² RGB with white background, nuclei and texture, read
   by ``examples_torch/_png.py``): the Macenko fit of the target (B5, on its
   route and the other where the row fits a cluster) within HE atol 2e-5
   and maxC rtol 1e-4 of B2's plain version, the transform of the five
   sources as one 5×3×384² batch (B4 on both routes) within 1 grey level of
   B1's plain version, the selections fused into B5 and B4 bit for bit
   against B6's plain version on their keys; B7b's moments (rtol 1e-4,
   atol 1e-2) and its finalize (bit for bit) on the target and the
   sources, the Reinhard transform within 1 grey level of the plain steps;
   the HM fit, counts, LUT, table and transform bit for bit; the public
   calls launching exactly B5, B4; B7b, B7b + B7a; B8a, B8a + B8b, each
   transform bit-identical on a second call, and timed (called and busy);
   the numpy oracle on each tile at ``tests/test_real_data.py``'s
   tolerances; then the port's user programs, each ``main`` called in this
   process: ``benchmarks_torch/pareto_time_mae.py`` for the three methods
   at ``--runs 3`` (every series a finite rate, its MAE under the gate, its
   launches), ``examples_torch/simple_example.py``,
   ``visualize_example.py macenko --runs 1 --save-plots``,
   ``pipeline_example.py --epochs 1``, ``serving_example.py`` and the
   quickstart notebook's code cells on ``cuda:0``. Their full output goes
   to ``build/user_programs.log``, their panels to ``build/examples_torch/``;
8. the API pages ``docs_torch/gen_api.py`` renders under this machine's
   torch, equal to the committed ``docs_torch/api/*.md``; then seeded
   random shapes (from ``--seed``) on both sides of every kernel's route
   edge, each edge read on this card: ``tests/test_fuzz_parity.py``'s 24
   cases (odd extents of 17-96, uint8 and float32, the numpy oracle at
   that sweep's gates too), B1's resident body or its L2 body, B1 or B4 by
   pixels and by rows (512 and 513 rows of 224² uint8, 256 and 257 of 160²
   float32), B2 or B5 (pools of one to three images), the cluster or the
   streamed route, each at the size on either side of the edge and
   ``EDGE_DRAWS`` sizes drawn within 1 % of it on each side; a batch view
   at an odd byte offset and an NHWC-strided batch (uint8 and float32),
   the histogram's split at 32 768 values a channel, a tile with two
   pixels past β and the negative-maxC tile; B3 or B6 through
   ``ops/percentile._select`` at 32 and 33 rows of 2²² − 1 and 2²² elements,
   and the public staged route on bfloat16 2048² and float16 2047×2049.
   Every case runs Macenko, Reinhard and histogram matching fit ->
   transform through the public API with the launches the route ladder
   names for its sizes, each kernel against its plain version at phase 3's
   gates (the selections fused into B4 and B5 and B1's and B2's on their
   own keys bit for bit), and a second run's bits; one line a case, then
   the routes seen on each side of each edge and the worst error a kernel.

Prints a ``{"kernels": [...]}`` line, then as its last line
``{"ok": true, "device": {...}}``. Data is synthetic, made from ``--seed``.
Imports no JAX and nothing of ``stainx_tpu``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time
from pathlib import Path

from benchmarks_torch.utils import (
    KERNELS,
    capture_graphs,
    event_ms,
    graph_ms,
    launches_since,
    replay_ms,
)
from stainx_tpu_torch import profiling

ROOT = os.path.dirname(os.path.abspath(__file__))

BATCH, SIZE = 64, 512  # the main path: bench.py's configuration
P_SIZE = 64  # small patches: the one-block kernels' sizes on the ladder
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
# float32 operations a pixel needs, each formula evaluated once: OD 9,
# β-mask 3, moments 19, projection 10, pseudo-angle 8, concentrations 10,
# one compare per selection 4; the transform adds the rescale and
# reconstruction, 26.
OPS_PER_PIXEL_FIT = 63
OPS_PER_PIXEL_TRANSFORM = 89
SWEEP_ROUNDS = 3  # rounds of the B1/B4 and B2/B5 sweep that sets the route ladder
TPU_SOURCE = "stainx_tpu/kernels/macenko_fused.py"
TPU_STREAM = "stainx_tpu/kernels/macenko_stream.py"
TPU_SELECT = "stainx_tpu/kernels/selection_stream.py"
TPU_REINHARD = "stainx_tpu/kernels/reinhard_fused.py"
TPU_HISTOGRAM = "stainx_tpu/kernels/histogram.py"
TPU_ROWS = "stainx_tpu/kernels/selection.py"
# The selections paths (c) and (d) make, in order, under the threshold
# SELECT_STREAM_MIN_ELEMS of stainx_tpu_torch/ops/percentile.py: (c) fits a
# 512^2 reference (angles (1, 512^2) K=2, concentrations (2, 512^2) K=1)
# and transforms 64 images ((64, 512^2) K=2, (128, 512^2) K=1); (d) fits
# the 256x224^2 pool (1, 12 845 056) and transforms its 256 images
# ((256, 224^2) K=2, (512, 224^2) K=1).
PATH_C_SELECTS = ["B3", "B3", "B3", "B3"]
PATH_D_SELECTS = ["B6", "B6", "B3", "B3"]
# float32 operations a uint8 pixel needs (the sRGB linearization is a
# table), a cube root or a power counted as one operation of the work:
# RGB→XYZ 15, white point 2, f(t) 9 (3 × the cube root and the linear
# side's multiply-add), L/a/b 9; the moments add the centring and squares,
# 6: 41. The apply adds to the 35 of the forward side the affine 12,
# LAB→XYZ 8, f⁻¹ 6, white point 3, XYZ→RGB 15, gamma 9 (3 × the power and
# its multiply-add), the ×255 store 3: 91. float32 input adds the forward
# gamma, 3 × the power and its multiply-add: 9.
OPS_PER_PIXEL_MOMENTS_U8 = 41
OPS_PER_PIXEL_APPLY_U8 = 91
OPS_PER_PIXEL_FORWARD_GAMMA = 9


def bound_ms(bytes_moved: float, ops: float) -> tuple[float, str]:
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def launch_counts(wrappers, before: dict) -> dict:
    """``{wrapper name: launches}`` of each of ``wrappers`` since ``before``,
    a snapshot of ``profiling.counters("launch.")``."""
    got = launches_since(before)
    short = {w: k for k, w in KERNELS.items()}
    return {w.__name__: got.get(short[w], 0) for w in wrappers}


def require(ok: bool, what: str) -> None:
    """Fail the run when a check does not hold (kept under ``python -O``)."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def _int_bits(t):
    import torch

    return t.contiguous().view(torch.int32)


def fused_selections(x, he, mc, fit: bool, force: str) -> dict:
    """Check only: a B4 (``fit`` False) or B5 call on ``force``'s route, run
    twice. Whether the pseudo-angles and maxC it selected (its RowParams)
    equal, bit for bit, B6's plain version on the keys the call selected on
    (which a check-only entry of the kernel source writes with the kernels'
    own device functions), and whether the second run's statistics are the
    same bits; with the fields' shapes and the pixels past beta a row."""
    import torch

    from stainx_tpu_torch.kernels import macenko_stream as ms
    from stainx_tpu_torch.kernels import selection_stream as ss
    from stainx_tpu_torch.ops import macenko as mk
    from stainx_tpu_torch.ops.percentile import nearest_rank_index, static_nearest_rank_index

    def call():
        out = None if fit else torch.empty_like(x)
        return ms._run(x, out, he.contiguous(), mc.contiguous(), fit=fit, force=force)

    params, again = call(), call()
    angles, conc = ms.kernel_keys(x, params, fit)
    cnt = (angles < torch.inf).sum(1)
    ranks = torch.stack([nearest_rank_index(mk.ALPHA, cnt),
                         nearest_rank_index(100 - mk.ALPHA, cnt)], 1)
    top = torch.where(angles < torch.inf, angles, -torch.inf).amax(1)
    phi = ss.kth_smallest_streaming_plain(angles, ranks, (angles.amin(1), top, cnt))
    idx99 = torch.full((conc.shape[0], 1), static_nearest_rank_index(99, angles.shape[1]),
                       device=x.device)
    maxc = ss.kth_smallest_streaming_plain(conc, idx99).reshape(-1, 2)
    torch.cuda.synchronize()
    stats = lambda t: t[:, :24]  # noqa: E731 (no padding)
    return {"phi": torch.equal(_int_bits(phi), _int_bits(params[:, ms.PHI_COLUMNS])),
            "maxc": torch.equal(_int_bits(maxc), _int_bits(params[:, ms.MAXC_COLUMNS])),
            "repeat": torch.equal(_int_bits(stats(params)), _int_bits(stats(again))),
            "angles": tuple(angles.shape), "conc": tuple(conc.shape),
            "past_beta": (int(cnt.min()), int(cnt.max()))}


PER_PASS_DIR = os.path.join(ROOT, "build", "per_pass")  # phase 3's per-pass build of B4/B5
OD_ONCE = "constexpr bool kOdOnce = sizeof(T) == 4;"


def per_pass_build():
    """Start ``nvcc`` on ``csrc/macenko_stream.cu`` with its float32 rows'
    OD taken on every pass, as B4 and B5 did before they took it once a call
    (``kOdOnce`` false: raw float32 planes, no key field), into
    ``build/per_pass/``. Returns ``(process, library path)``."""
    from stainx_tpu_torch import kernels

    source = (kernels.CSRC / "macenko_stream.cu").read_text()
    require(source.count(OD_ONCE) == 1, f"macenko_stream.cu no longer has {OD_ONCE!r}")
    os.makedirs(PER_PASS_DIR, exist_ok=True)
    for header in kernels.CSRC.glob("*.cuh"):
        Path(PER_PASS_DIR, header.name).write_text(header.read_text())
    src = Path(PER_PASS_DIR, "macenko_stream.cu")
    src.write_text(source.replace(OD_ONCE, OD_ONCE.replace("sizeof(T) == 4", "false")))
    lib = os.path.join(PER_PASS_DIR, "libmacenko_stream_per_pass.so")
    proc = subprocess.Popen([kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-o", lib, str(src)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, lib


def od_once_checks(dev, seed: int, build) -> None:
    """B4 and B5 on float32 rows take each pixel's OD once a call: resident
    planes as OD, the other pixels' keys in a key field. Each call here is
    held bit for bit (its RowParams' statistics and its output) against the
    per-pass build (:func:`per_pass_build`) on the same cluster shape: the
    batch-mode training transform and fit (128x3x256^2 and 1x3x256^2
    float32), ragged float32 rows past the resident part on clusters of 2
    and 4 (also a pooled fit, and a white batch that takes the <3-pixel
    fallback), and the tile store's uint8 rows, which the change leaves as
    they were. Each float32 call with pixels past the resident part counts
    one ``keyfield.B4`` or ``keyfield.B5``; the others none."""
    import torch

    from stainx_tpu_torch import StainNormalizerTransform, kernels
    from stainx_tpu_torch.kernels import macenko_fused as mf
    from stainx_tpu_torch.kernels import macenko_stream as ms
    from stainx_tpu_torch.testing import synthetic_he_batch

    proc, path = build
    log, _ = proc.communicate()
    require(proc.returncode == 0, f"nvcc failed on the per-pass build:\n{log}")
    per_pass = ctypes.CDLL(path)
    per_pass.stainx_error_string.argtypes = [ctypes.c_int]
    per_pass.stainx_error_string.restype = ctypes.c_char_p

    def u8(n, h, w, s, scale=1.0):
        return torch.as_tensor(synthetic_he_batch(n, h, w, seed=seed + s, he_scale=scale)).to(dev)

    ref = u8(1, 256, 256, 520)
    he, mc = (t.contiguous() for t in mf.macenko_fit_mega_plain(ref))
    smem = kernels.device_limits(dev.index)[1]

    def call(x, fit, shape, lib=None):
        saved = kernels.library("macenko_stream")
        if lib is not None:
            kernels._libs["macenko_stream"] = lib
        try:
            out = None if fit else torch.empty_like(x)
            params = ms._run(x, out, he, mc, fit=fit, force="cluster", shape=shape)
        finally:
            kernels._libs["macenko_stream"] = saved
        torch.cuda.synchronize()
        stats = params[:, :24]  # no padding
        return stats, out

    def bits(t):
        return t.contiguous().view(torch.int32 if t.element_size() == 4 else torch.uint8)

    train = u8(128, 256, 256, 521, 1.1).float() / 255.0
    cases = [
        ("the training transform 128x3x256^2 f32", train, False, None),
        ("the training fit 1x3x256^2 f32", train[:1], True, None),
        ("40x3x331^2 f32 (ragged, scalar loads)", u8(40, 331, 331, 522).float() / 255.0, False,
         None),
        ("20x3x253x257 f32 (ragged)", u8(20, 253, 257, 523).float() / 255.0, False, None),
        ("pool 3x3x71x73 f32, clusters of 2, 2 048 resident", u8(3, 71, 73, 524).float() / 255.0,
         True, (2, 7_776, 2_048)),
        ("2x3x71x73 f32, clusters of 4, 256 resident", u8(2, 71, 73, 525).float() / 255.0, False,
         (4, 1_296, 256)),
        ("white 2x3x256^2 f32 (fallback), 4 096 resident",
         torch.ones((2, 3, 256, 256), device=dev), False, (1, 65_536, 4_096)),
        ("the tile store 128x3x256^2 u8", u8(128, 256, 256, 526), False, None),
    ]
    for label, x, fit, shape in cases:
        n, _, h, w = x.shape
        rows, row_len = (1, n * h * w) if fit else (n, h * w)
        itemsize = x.element_size()
        if shape is None:
            active = lambda c, r, t=x.dtype: ms._active_clusters(dev.index, t, c, r)  # noqa: E731
            shape = ms.cluster_shape(rows, row_len, itemsize, smem, active)
        csize, slice_, resident = shape
        keyfield = ms.cluster_scratch(rows, *shape, itemsize)[1]
        before = profiling.counters("keyfield.")
        stats, out = call(x, fit, shape)
        counted = {k: v - before.get(k, 0) for k, v in profiling.counters("keyfield.").items()
                   if v != before.get(k, 0)}
        want_stats, want_out = call(x, fit, shape, per_pass)
        again_stats, again_out = call(x, fit, shape)
        same = torch.equal(bits(stats), bits(want_stats)) and (
            fit or torch.equal(bits(out), bits(want_out)))
        print(f"{'B5' if fit else 'B4'} {label}: clusters of {csize}, slice {slice_}, {resident} "
              f"resident, key field {keyfield} bytes, counted {counted}; RowParams"
              f"{'' if fit else ' and output'} bit-identical to the per-pass build: {same}")
        require(same, f"{label}: differs from the per-pass build")
        require(torch.equal(bits(stats), bits(again_stats))
                 and (fit or torch.equal(bits(out), bits(again_out))), f"{label}: two runs differ")
        want = {f"keyfield.{'B5' if fit else 'B4'}": 1} if keyfield else {}
        require(counted == want, f"{label}: key fields counted {counted}, not {want}")
        require(bool(keyfield) == (itemsize == 4 and resident < slice_),
                f"{label}: key field {keyfield} bytes")
        if label.startswith("the training transform") or label.startswith("40x"):
            require(keyfield > 0, f"{label}: no key field")
        if label.startswith("40x") or label.startswith("20x"):
            require(csize > 1, f"{label}: clusters of {csize}")
    # The batch-mode forward at the training shape: one B4 transform with its
    # key field, the fit of the first tile fused into its launch.
    forward = StainNormalizerTransform("macenko", mode="batch")
    forward(train)
    torch.cuda.synchronize()
    before = profiling.counters()
    forward(train)
    torch.cuda.synchronize()
    counted = {k: v - before.get(k, 0) for k, v in profiling.counters().items()
               if v != before.get(k, 0) and k.startswith(("launch.", "keyfield.", "fit."))}
    print(f"batch-mode forward 128x3x256^2 f32: {counted}")
    require(counted == {"launch.B4.cluster": 1, "keyfield.B4": 1, "fit.fused": 1},
            f"the batch-mode forward counted {counted}")


def card_tests(label: str, test_file: str) -> None:
    """The card tests (marker ``cuda``) of ``tests/<test_file>``, run by
    pytest in a process of its own on the libraries this run built."""
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "--noconftest", "-p", "no:cacheprovider", "-q", "-rs",
         "-m", "cuda", os.path.join("tests", test_file)],
        capture_output=True, text=True, cwd=ROOT)
    lines = proc.stdout.strip().splitlines()
    print(f"{label}: {lines[-1] if lines else proc.stderr.strip()[-300:]}")
    require(proc.returncode == 0, f"the {label} card tests failed:\n{proc.stdout[-4000:]}")


def fold_checks() -> None:
    """``tests/test_torch_fold_range.py`` on the card: the ÷255 of
    ``normalize_to_0_1`` in the float32 transform kernels' store."""
    card_tests("folded ÷255", "test_torch_fold_range.py")


def fused_fit_checks() -> None:
    """``tests/test_torch_fused_fit.py`` on the card: batch mode's fit fused
    into B4's cluster launch against B4's row statistics, B5's fit and the
    two-launch route, its launch counts, and the training cell's check on a
    stale fused state."""
    card_tests("fused fit", "test_torch_fused_fit.py")


def resident_checks() -> None:
    """``tests/test_torch_patch_reference.py`` on the card: B1 at the patch
    cell's 512x3x96² uint8 call (two blocks an SM on an H100), its span and
    counters, the selections of B1's resident body and of B2 at 96² and at
    the largest row and pool a block holds, and B1 on phase 8's <3-pixel
    fallback tile against its plain version."""
    card_tests("patch cell and resident edges", "test_torch_patch_reference.py")


def one_block_selections(x, he, mc, fit: bool):
    """Check only: B2's selections (``fit``) or those of B1's resident body
    against ``kth_smallest`` on the keys the kernel selected on, which a
    check-only launch of the same kernel keeps. Returns ``(exact,
    (fewest, most) pixels in the angle selections, the checked launch's
    output or (HE, maxC))``."""
    import torch

    from stainx_tpu_torch.kernels import macenko_fused as mf
    from stainx_tpu_torch.testing import selections_exact

    if fit:
        he_s, mc_s, keys, got = mf.fit_selections(x)
        keys, got, result = keys[None], got[None], (he_s, mc_s)
        p = x.shape[0] * x.shape[2] * x.shape[3]
    else:
        result, keys, got = mf.resident_selections(x, he, mc)
        p = x.shape[2] * x.shape[3]
    cnt = ((keys[:, 0].to(torch.int64) & 0xFFFFFFFF) < 0xFF800000).sum(-1)
    exact = selections_exact(keys, got, p)
    torch.cuda.synchronize()
    return exact, (int(cnt.min()), int(cnt.max())), result


def run(cmd: list[str]) -> str:
    return subprocess.run(cmd, check=True, capture_output=True, text=True).stdout.strip()


def profiled_ms(fn, inputs, iters: int):
    """Mean device time per call of ``fn``: the sum of the CUDA kernel and
    memset times ``torch.profiler`` records over ``iters`` eager calls, or
    None when the profiler records no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for x in inputs:
        fn(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            fn(inputs[i % len(inputs)])
        torch.cuda.synchronize()
    device_us = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA)
    return device_us / 1e3 / iters if device_us > 0 else None


def device_steps(call, steps: tuple[str, ...], sessions: int = 3):
    """``call()``'s device work in order, as ``torch.profiler`` records it:
    each kernel's name shortened to the first of ``steps`` it holds. A
    marker kernel (a fill) runs and finishes first inside the same session
    and every event up to it is dropped, since the first launch of a
    session can go unrecorded while the tracer starts (the process's first
    CUDA session lost B7b this way once). A session that recorded nothing
    after the marker (late in this process the profiler has recorded no
    device event at all) is run again, up to ``sessions`` sessions; the
    names are those of the first session that recorded any. Returns
    ``(call(), names)``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(sessions):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.empty(1, device="cuda").fill_(0)
            torch.cuda.synchronize()
            result = call()
            torch.cuda.synchronize()
        names = [name for _, name in sorted((e.time_range.start, e.name) for e in prof.events()
                                            if e.device_type == torch.autograd.DeviceType.CUDA)]
        marker = next((i for i, name in enumerate(names) if "FillFunctor" in name), -1)
        names = names[marker + 1:]
        if names:
            break
        print(f"device_steps: the profiler recorded no device work after the marker "
              f"({marker + 1} event(s) before it); another session")
    return result, [next((k for k in steps if k in name), name) for name in names]


# The methods whose transform takes statistics over the whole call, at their
# benchmark cells' shapes (portbench: reinhard-u8-512.store,
# hm-u8-512.store-b256): class, tiles a call of 3x512^2 uint8, the launches
# of a transform, and the kernel span its ``stainx.stats`` span opens in.
STATS_CELLS = (
    ("Reinhard", 128, {"launch.B7b": 1, "launch.B7a": 1}, "stainx.kernel.B7"),
    ("HistogramMatching", 256, {"launch.B8a": 1, "launch.B8b": 1}, "stainx.kernel.B8"),
)


def stats_span_checks(dev, calls: int = 5) -> None:
    """The ``stainx.stats`` span of each of :data:`STATS_CELLS`' transforms
    at its cell's shape, on the benchmark's tiles: inside a profiler session
    one span a call, a child of the method's kernel span, with a device
    interval; the launches a call; and every output of the session equal, bit
    for bit, to a call made outside one (where the C call gets null events)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import stainx_tpu_torch
    from portbench import gen

    g = gen.torch_generator(gen.seed_streams(2800000001, 1)[0], dev)
    for name, batch, want, parent in STATS_CELLS:
        ref = gen.tiles(1, (3, 512, 512), "uint8", (0.85, 1.15), g)
        x = gen.tiles(batch, (3, 512, 512), "uint8", (0.85, 1.15), g)
        system = getattr(stainx_tpu_torch, name)(device=dev).fit(ref)
        unprofiled = system.transform(x)
        torch.cuda.synchronize(dev)
        before = profiling.counters("launch.")
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            outs = [system.transform(x) for _ in range(calls)]
            torch.cuda.synchronize(dev)
        after = profiling.counters("launch.")
        launched = {k: (v - before.get(k, 0)) / calls for k, v in after.items()
                    if v != before.get(k, 0)}
        sess = profiling.session()
        stats = [s for s in sess.spans if s.name == "stainx.stats"]
        dev_ms = sorted(s.device_ms for s in stats if s.device_ms is not None)
        print(f"{name} transform {batch}x3x512^2 u8 in a session: "
              f"{len(stats) / calls} stainx.stats span(s) a call under "
              f"{sorted({sess.spans[s.parent].name for s in stats})}, launches a call {launched}, "
              f"stats device ms {[round(v, 4) for v in dev_ms]}")
        require(len(sess.roots()) == calls and len(stats) == calls and len(dev_ms) == calls,
                f"{name}: {len(stats)} stainx.stats spans with {len(dev_ms)} device intervals "
                f"over {len(sess.roots())} calls, not one a call")
        require(all(sess.spans[s.parent].name == parent for s in stats),
                f"{name}: a stainx.stats span outside {parent}")
        require(launched == {k: float(v) for k, v in want.items()},
                f"{name}: launches a call {launched}, not {want}")
        require(all(torch.equal(o, unprofiled) for o in outs),
                f"{name}: a profiled transform differs from an unprofiled one")
        del x, outs, unprofiled
        torch.cuda.empty_cache()


MESH_TIMING_ITERS = 10  # calls a mesh path is timed over, two inputs cycled


class CollectiveMarks:
    """Records a CUDA event on the current stream after every
    ``all_reduce`` and ``all_gather`` while active (the functions of
    ``torch.distributed`` are wrapped, nothing of the port is changed): the
    device-time boundaries of a mesh call's steps, each step ending in its
    collective."""

    def __init__(self):
        import torch.distributed as dist

        self.dist, self.marks = dist, []

    def __enter__(self):
        import torch

        self.saved = self.dist.all_reduce, self.dist.all_gather
        self.marks = [("start", torch.cuda.Event(enable_timing=True))]
        self.marks[0][1].record()

        def wrap(name, fn):
            def call(*a, **k):
                out = fn(*a, **k)
                event = torch.cuda.Event(enable_timing=True)
                event.record()
                self.marks.append((name, event))
                return out
            return call

        self.dist.all_reduce = wrap("all_reduce", self.saved[0])
        self.dist.all_gather = wrap("all_gather", self.saved[1])
        return self

    def __exit__(self, *exc):
        import torch

        self.dist.all_reduce, self.dist.all_gather = self.saved
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        self.marks.append(("end", end))
        end.synchronize()

    def spans(self) -> list[float]:
        """ms between consecutive marks on the device."""
        return [a[1].elapsed_time(b[1]) for a, b in zip(self.marks, self.marks[1:])]


def mesh_checks(mesh, mesh_px, dev, batch, ref, out=print):
    """The mesh paths held against the single-device port on the same card
    (JAX's mesh tolerances: HE atol 2e-3, maxC rtol 1e-2, transforms 1 grey
    level): the fits and transforms of every method on ``batch``, the
    pixel-sharded Macenko transform of two images and the batch-mode
    training transform. Returns the fitted reference parameters."""
    import torch

    from stainx_tpu_torch import (HistogramMatching, Macenko, Reinhard,
                                  StainNormalizerTransform, parallel)

    single = {"reinhard": Reinhard(dev), "histogram_matching": HistogramMatching(dev),
              "macenko": Macenko(dev)}
    fitted = {}
    for method, norm in single.items():
        got = parallel.fit_on_mesh(method, batch, mesh)
        got = got if isinstance(got, tuple) else (got,)
        norm.fit(batch)
        want = tuple(norm.state.values())
        tol = {"reinhard": [(1e-4, 1e-3)] * 2, "histogram_matching": [(0.0, 1e-6)],
               "macenko": [(0.0, 2e-3), (1e-2, 0.0)]}[method]
        for g, w, (rtol, atol) in zip(got, want, tol):
            err = ((g - w).abs() - rtol * w.abs()).max().item()
            out(f"fit_on_mesh {method} vs the single-device fit: max(|d| - rtol|w|) {err:.3g} "
                f"(atol {atol})")
            require(g.device == dev and err <= atol, f"fit_on_mesh {method}: {err} past {atol}")
        fitted[method] = tuple(norm.fit(ref).state.values())
        params = fitted[method] if method != "histogram_matching" else fitted[method][0]
        got = parallel.transform_on_mesh(method, batch, params, mesh)
        err = (got.float() - norm.transform(batch).float()).abs().max().item()
        out(f"transform_on_mesh {method} vs the single-device transform: max|d| {err} grey "
            f"levels (tolerance 1)")
        require(got.shape == batch.shape and got.dtype == batch.dtype and err <= 1.0,
                f"transform_on_mesh {method}: {err} grey levels")
    pair = batch[:2]
    got = parallel.transform_on_mesh("macenko", pair, fitted["macenko"], mesh_px,
                                     pixel_axis="pixel")
    err = (got.float() - single["macenko"].transform(pair).float()).abs().max().item()
    out(f"transform_on_mesh macenko, pixel_axis, 2 images vs the single-device transform: "
        f"max|d| {err} grey levels (tolerance 1)")
    require(err <= 1.0, f"pixel-sharded transform: {err} grey levels")
    forward = StainNormalizerTransform("macenko", mode="batch", batch_ref_index=None, mesh=mesh)
    got = forward(batch)
    fit_all = Macenko(dev).fit(batch)
    err = (got.float() * 255.0 - fit_all.transform(batch).float()).abs().max().item()
    out(f"StainNormalizerTransform(mesh=..., mode='batch', batch_ref_index=None) vs the "
        f"single-device fit and transform: max|d| {err:.3g} grey levels (tolerance 1)")
    require(err <= 1.0 + 1e-3, f"mesh batch-mode forward: {err} grey levels")
    return fitted


def _mesh_rank(rank: int, world: int, init_file: str, seed: int) -> None:
    """One rank of the multi-card mesh check (run when the machine has
    two cards or more): a (world,) batch mesh and a (1, world) pixel mesh
    on NCCL, each rank on its own card, the batch of 8×3×512² uint8 images
    made from ``seed`` on every rank."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, ROOT)
    from stainx_tpu_torch import parallel
    from stainx_tpu_torch.testing import synthetic_he_batch

    torch.cuda.set_device(rank)
    dist.init_process_group("nccl", init_method=f"file://{init_file}", rank=rank,
                            world_size=world)
    try:
        dev = torch.device("cuda", rank)
        mesh = parallel.make_mesh(axis_names=("batch",))
        mesh_px = parallel.make_mesh((1, world), ("batch", "pixel"))
        batch = torch.as_tensor(synthetic_he_batch(8, SIZE, SIZE, seed=seed + 123)).to(dev)
        ref = torch.as_tensor(synthetic_he_batch(1, SIZE, SIZE, seed=seed + 42)).to(dev)
        mesh_checks(mesh, mesh_px, dev, batch, ref,
                    out=(lambda m: print(f"[rank {rank}] {m}")) if rank == 0 else (lambda m: None))
    finally:
        dist.destroy_process_group()


def mesh_phase(seed: int) -> None:
    """Phase 4b, run in a process of its own (its process groups and its
    profiler runs leave the other phases' process as it was): the
    distributed layer (``stainx_tpu_torch.parallel``) on a 1-rank group
    whose CUDA collectives go through NCCL (CPU ones through gloo), then,
    where the machine has two cards or more, on a group of two ranks
    (module docstring). The inputs are the main process's, made from the
    same seeds."""
    import tempfile

    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    sys.path.insert(0, ROOT)
    from stainx_tpu_torch import (HistogramMatching, Macenko, Reinhard,
                                  StainNormalizerTransform, parallel)
    from stainx_tpu_torch.testing import synthetic_he_batch

    dev = torch.device("cuda", 0)

    def dev_u8(n, side, seed_k, **kw):
        return torch.as_tensor(synthetic_he_batch(n, side, side, seed=seed + seed_k, **kw)).to(dev)

    ref = dev_u8(1, SIZE, 42)
    batch, batch_b = dev_u8(BATCH, SIZE, 123), dev_u8(BATCH, SIZE, 124, he_scale=1.1)
    big1, big1_b = dev_u8(1, 4096, 4096), dev_u8(1, 4096, 4097, he_scale=1.1)
    patches = dev_u8(256, P_SIZE, 64)  # phase 4's small patches
    from stainx_tpu_torch.kernels import histogram as hk
    from stainx_tpu_torch.kernels import macenko_fused as mf
    from stainx_tpu_torch.kernels import macenko_stream as ms
    from stainx_tpu_torch.kernels import reinhard_fused as rf
    from stainx_tpu_torch.kernels import selection as sel
    from stainx_tpu_torch.kernels import selection_stream as ss

    cards = torch.cuda.device_count()
    print(f"mesh phase: {cards} card(s); a 1-rank group (NCCL for the card, gloo for the CPU), "
          f"{'then a group of 2 ranks on 2 cards' if cards >= 2 else 'no multi-card group'}")
    tmp = tempfile.mkdtemp(prefix="stainx_mesh_")
    dist.init_process_group("cpu:gloo,cuda:nccl", init_method=f"file://{tmp}/init", rank=0,
                            world_size=1)
    try:
        mesh = parallel.make_mesh(axis_names=("batch",))
        mesh_px = parallel.make_mesh((1, 1), ("batch", "pixel"))
        cpu_mesh = parallel.make_mesh(axis_names=("batch",), device_type="cpu")
        cpu_px = parallel.make_mesh((1, 1), ("batch", "pixel"), device_type="cpu")
        fitted = mesh_checks(mesh, mesh_px, dev, batch, ref)

        wrappers = [rf.reinhard_moments, rf.reinhard_apply, hk.histogram_256, hk.apply_lut,
                    mf.macenko_fit_mega, mf.macenko_transform_mega, ms.macenko_fit_stream,
                    ms.macenko_transform_stream, sel.kth_smallest_pallas,
                    ss.kth_smallest_streaming]

        def drive(label, fn, want):
            """Run a mesh path with the launch counters read just before and
            just after; exactly the wrappers in ``want`` must launch."""
            before = profiling.counters("launch.")
            result = fn()
            torch.cuda.synchronize()
            counts = {k: n for k, n in launch_counts(wrappers, before).items() if n}
            print(f"mesh path {label} launches: {counts}")
            require(set(counts) == set(want), f"mesh path {label}: launches {counts}, "
                    f"the path must launch {sorted(want)}")
            return result

        def cpu_param(p):
            return tuple(t.cpu() for t in p) if isinstance(p, tuple) else p.cpu()

        def hold_fit(label, got, want, tol):
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            for g, w, (rtol, atol) in zip(got, want, tol):
                g = g.cpu()
                err = ((g - w).abs() - rtol * w.abs()).max().item()
                print(f"{label} vs the same call on the CPU (plain versions): "
                      f"max(|d| - rtol|w|) {err:.3g} (rtol {rtol}, atol {atol})")
                require(bool(torch.isfinite(g).all()) and err <= atol,
                        f"{label}: {err} from the CPU past {atol}")

        def hold_out(label, got, want):
            require(got.is_cuda and got.shape == want.shape and got.dtype == want.dtype,
                    f"{label}: output shape or dtype")
            err = (got.cpu().float() - want.float()).abs().max().item()
            print(f"{label} vs the same call on the CPU (plain versions): max|d| {err} grey "
                  f"levels (tolerance 1)")
            require(err <= 1.0, f"{label}: {err} grey levels from the CPU")

        # The Numbers table's paths on the (1,) batch mesh: each driven with
        # its launch counts, held against the CPU, then timed.
        cpu_batch = batch.cpu()
        fit_tol = {"reinhard": [(1e-4, 1e-3)] * 2, "histogram_matching": [(0.0, 1e-6)],
                   "macenko": [(0.0, 2e-5), (1e-4, 0.0)]}
        fit_want = {"reinhard": ["reinhard_moments"], "histogram_matching": ["histogram_256"],
                    "macenko": []}
        tr_want = {"reinhard": ["reinhard_moments", "reinhard_apply"],
                   "histogram_matching": ["histogram_256", "apply_lut"],
                   "macenko": ["macenko_transform_stream"]}
        classes = {"reinhard": Reinhard, "histogram_matching": HistogramMatching,
                   "macenko": Macenko}
        rows = []
        for method in ("reinhard", "histogram_matching", "macenko"):
            got = drive(f"fit_on_mesh {method} {BATCH}x3x{SIZE}^2 u8",
                        lambda m=method: parallel.fit_on_mesh(m, batch, mesh), fit_want[method])
            hold_fit(f"fit_on_mesh {method}", got,
                     parallel.fit_on_mesh(method, cpu_batch, cpu_mesh), fit_tol[method])
            rows.append((f"fit_on_mesh {method}", lambda x, m=method: parallel.fit_on_mesh(m, x, mesh),
                         f"single-device {method} fit",
                         lambda x, cls=classes[method]: cls(dev).fit(x)))
            params = fitted[method] if method != "histogram_matching" else fitted[method][0]
            got = drive(f"transform_on_mesh {method} {BATCH}x3x{SIZE}^2 u8",
                        lambda m=method, p=params: parallel.transform_on_mesh(m, batch, p, mesh),
                        tr_want[method])
            hold_out(f"transform_on_mesh {method}", got,
                     parallel.transform_on_mesh(method, cpu_batch, cpu_param(params), cpu_mesh))
            rows.append((f"transform_on_mesh {method}",
                         lambda x, m=method, p=params: parallel.transform_on_mesh(m, x, p, mesh),
                         None, None))
        del cpu_batch
        # Small patches through the training transform in batch mode: the
        # reference patch fitted on one device (B2), the batch on the mesh (B1).
        forward = StainNormalizerTransform("macenko", mode="batch", mesh=mesh)
        got = drive(f"StainNormalizerTransform(mesh=..., mode='batch') {patches.shape[0]}x3x"
                    f"{patches.shape[2]}^2 u8", lambda: forward(patches),
                    ["macenko_fit_mega", "macenko_transform_mega"])
        want = StainNormalizerTransform("macenko", mode="batch", device="cpu")(patches.cpu())
        err = (got.cpu() - want).abs().max().item() * 255.0
        print(f"mesh batch-mode forward on small patches vs the CPU: max|d| {err:.3g} grey levels "
              f"(tolerance 1)")
        require(err <= 1.0 + 1e-3, f"mesh batch-mode forward on small patches: {err} grey levels")

        # The pixel-sharded Macenko transform of one 4096^2 image on the
        # (1, 1) mesh: eager, no kernel of the port.
        mc_params = fitted["macenko"]
        got = drive("transform_on_mesh macenko, pixel_axis, 1x3x4096^2 u8",
                    lambda: parallel.transform_on_mesh("macenko", big1, mc_params, mesh_px,
                                                       pixel_axis="pixel"), [])
        hold_out("transform_on_mesh macenko, pixel_axis, 1x3x4096^2",
                 got, parallel.transform_on_mesh("macenko", big1.cpu(), cpu_param(mc_params),
                                                 cpu_px, pixel_axis="pixel"))
        single = Macenko(dev)
        single.load_state(dict(zip(("_stain_matrix", "_target_max_conc"), mc_params)))
        err = (got.float() - single.transform(big1).float()).abs().max().item()
        print(f"pixel-sharded 1x3x4096^2 vs the single-device transform (B4): max|d| {err} grey "
              f"levels (tolerance 1)")
        require(err <= 1.0, f"pixel-sharded 4096^2 vs B4: {err} grey levels")

        # Times: as called (CUDA events), the device's busy time by
        # torch.profiler and the idle share, beside the single-device call.
        def timed(label, fn, xs, n_px):
            eager = event_ms(fn, xs, MESH_TIMING_ITERS)
            busy = profiled_ms(fn, xs, 3)
            busy_txt = ("device busy not measured" if busy is None else
                        f"device busy {busy:.4f} ms, idle share {1.0 - busy / eager:.3f}")
            print(f"{label}: {eager:.4f} ms as called ({n_px / eager / 1e3:.1f} MPix/s), "
                  f"{busy_txt}")
            return eager

        pair = [batch, batch_b]
        for label, fn, other, other_fn in rows:
            timed(f"mesh {label} {BATCH}x3x{SIZE}^2 u8 on the (1,) mesh", fn, pair,
                  BATCH * SIZE * SIZE)
            if other is not None:
                timed(f"{other} {BATCH}x3x{SIZE}^2 u8", other_fn, pair, BATCH * SIZE * SIZE)
        for method, cls in classes.items():
            norm = cls(dev).fit(ref)
            timed(f"single-device {method} transform {BATCH}x3x{SIZE}^2 u8", norm.transform, pair,
                  BATCH * SIZE * SIZE)
        big_pair = [big1, big1_b]
        px = lambda x: parallel.transform_on_mesh("macenko", x, mc_params, mesh_px,  # noqa: E731
                                                  pixel_axis="pixel")
        timed("mesh transform_on_mesh macenko, pixel_axis, 1x3x4096^2 u8 on the (1, 1) mesh", px,
              big_pair, 4096 * 4096)
        timed("single-device Macenko transform (B4) 1x3x4096^2 u8", single.transform, big_pair,
              4096 * 4096)
        # Its split on the device, between the collectives that end each
        # step: the first-pass and second-pass moments (each an all_gather),
        # the eigh, projection and angles (to the count all_reduce), the
        # four key levels of the angle descent (the first with the keys), the
        # concentrations (to the second count), the four levels of the
        # concentration descent, the reconstruction, and the all_gather of
        # the output.
        names = (["moments pass 1", "moments pass 2", "eigh, projection, atan2"]
                 + [f"angle descent level {k}" for k in range(4)] + ["concentrations"]
                 + [f"concentration descent level {k}" for k in range(4)]
                 + ["reconstruction", "output gather"])
        splits = []
        for i in range(4):
            with CollectiveMarks() as marks:
                px(big_pair[i % 2])
            splits.append(marks.spans())
        require(all(len(s) == len(names) for s in splits),
                f"pixel-sharded split: {[len(s) for s in splits]} spans, expected {len(names)}")
        mean = [sum(s[k] for s in splits[1:]) / (len(splits) - 1) for k in range(len(names))]
        print("pixel-sharded 1x3x4096^2 split on the device (ms, mean of 3 calls): "
              + "; ".join(f"{n} {t:.4f}" for n, t in zip(names, mean))
              + f"; total {sum(mean):.4f}")
    finally:
        dist.destroy_process_group()

    if cards >= 2:
        init = os.path.join(tmp, "init2")
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=_mesh_rank, args=(r, 2, init, seed)) for r in range(2)]
        for proc in procs:
            proc.start()
        for proc in procs:
            proc.join(timeout=600)
        for proc in procs:
            if proc.is_alive():
                proc.kill()
                proc.join()
        codes = [proc.exitcode for proc in procs]
        print(f"mesh phase on 2 ranks (2 cards): exit codes {codes}")
        require(codes == [0, 0], f"the 2-rank mesh phase failed: exit codes {codes}")


INGEST_TILES = 512  # phase 4c: 8 batches of the main path's 64 tiles of 3x512^2 uint8
INGEST_DRIFT = 0.10  # profiling.time_fn against event_ms


def _load_example():
    """``examples/torch_wsi_ingest_example.py`` loaded from its path (an
    installed package named ``examples`` would shadow the directory)."""
    import importlib.util

    path = os.path.join(ROOT, "examples", "torch_wsi_ingest_example.py")
    spec = importlib.util.spec_from_file_location("torch_wsi_ingest_example", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def ingest_phase(seed: int, dev, ref, batch, normalizer, wrappers, tilepipe_jax_so) -> None:
    """Phase 4c, the tile-ingest path (module docstring): 512 tiles of
    3x512^2 uint8 written one a file, ``RawTileLoader`` on the card (the
    native readers, the page-locked copy) into
    ``StainNormalizerTransform("macenko", reference=ref)``, its launches,
    its output bit for bit against the same transform of batches read with
    ``np.fromfile``, a CPU-device loader byte for byte, the percentile
    wrappers on the card against their CPU versions, ``profiling``, and the
    path's times. ``tilepipe_jax_so``: the (exists, mtime) of the JAX
    package's reader library before the run, which this phase must leave
    as it was."""
    import tempfile

    import numpy as np
    import torch

    from stainx_tpu_torch import StainNormalizerTransform, kernels
    from stainx_tpu_torch.io import RawTileLoader, tilepipe, tilepipe_available
    from stainx_tpu_torch.kernels import selection as sel
    from stainx_tpu_torch.kernels import selection_stream as ss
    from stainx_tpu_torch.ops.percentile import masked_nearest_rank_percentile, percentile_all

    example = _load_example()
    require(tilepipe_available(), f"the native tile reader did not build ({tilepipe._loaded})")
    lib = tilepipe.lib_path()
    require(lib.is_file() and lib.parent == kernels.BUILD_DIR,
            f"the reader library is not under {kernels.BUILD_DIR}: {lib}")
    print(f"ingest: native reader {lib}")
    shape = (3, SIZE, SIZE)
    n_batches = INGEST_TILES // BATCH
    with tempfile.TemporaryDirectory(prefix="stainx_ingest_") as td:
        t0 = time.perf_counter()
        files = example.write_tile_store(Path(td), INGEST_TILES, SIZE, seed=seed + 500)
        store_mb = INGEST_TILES * SIZE * SIZE * 3 / 1e6
        print(f"ingest: wrote {INGEST_TILES} tiles of 3x{SIZE}^2 u8 ({store_mb:.1f} MB) in "
              f"{time.perf_counter() - t0:.1f} s")

        # The path, with the launch counters read before and after:
        # the fit of the reference is B5, each batch B4, nothing else.
        before = profiling.counters("launch.")
        transform = StainNormalizerTransform("macenko", reference=ref)
        loaded, outs = [], []
        for b in RawTileLoader(files, shape, BATCH, drop_remainder=True):
            loaded.append(b)
            outs.append(transform(b))
        torch.cuda.synchronize()
        counts = launch_counts(wrappers, before)
        print(f"ingest path launches: {counts}")
        want = {w.__name__: 0 for w in wrappers}
        want.update(macenko_fit_stream=1, macenko_transform_stream=n_batches)
        require(counts == want, f"ingest path: launches {counts}, the path must launch {want}")
        require(len(loaded) == n_batches and all(
            b.is_cuda and b.dtype == torch.uint8 and tuple(b.shape) == (BATCH,) + shape
            for b in loaded), "the loader did not yield uint8 batches of the card")

        # Held bit for bit against the same transform of the batches read
        # directly (np.fromfile) and copied to the card; a CPU-device loader
        # gives the same bytes.
        direct = [np.stack([np.fromfile(f, np.uint8, count=3 * SIZE * SIZE).reshape(shape)
                            for f in files[i * BATCH:(i + 1) * BATCH]]) for i in range(n_batches)]
        for i, arr in enumerate(direct):
            require(torch.equal(loaded[i].cpu(), torch.from_numpy(arr)),
                    f"ingest batch {i}: the card's batch differs from np.fromfile")
            got = transform(torch.from_numpy(arr).to(dev))
            require(torch.equal(got, outs[i]), f"ingest batch {i}: output differs from the "
                    "transform of the directly read batch")
        require(all(torch.isfinite(o).all() and o.dtype == torch.float32 and o.min() >= 0
                    and o.max() <= 1 for o in outs), "ingest output not finite float in [0, 1]")
        for i, b in enumerate(RawTileLoader(files, shape, BATCH, drop_remainder=True,
                                            device="cpu")):
            require(b.device.type == "cpu" and torch.equal(b, torch.from_numpy(direct[i])),
                    f"ingest batch {i}: the CPU-device loader's bytes differ")
        print(f"ingest path: {n_batches} batches, output bit for bit the directly read batches'; "
              f"the CPU-device loader byte for byte")
        resident = loaded[0]
        del loaded, outs, direct

        # The percentile wrappers on the card (B3 for 64 rows of 512^2, B6
        # for one row of 2^24, the staged route's threshold) against their
        # CPU versions, bit for bit.
        rng = np.random.default_rng(seed + 501)
        fields = []
        for rows, p in ((BATCH, SIZE * SIZE), (1, 1 << 24)):
            x = rng.standard_normal((rows, p), dtype=np.float32)
            mask = rng.random((rows, p)) < 0.8
            x[:, :11] = -np.inf
            x[:, 11:29] = np.nan
            if rows > 1:
                mask[3] = False  # an empty row: +inf
            fields.append((torch.from_numpy(x), torch.from_numpy(mask)))
        before = profiling.counters("launch.")
        checks = []
        for x, mask in fields:
            cnt = mask.sum(-1)
            for q in (1, 99) if x.shape[0] > 1 else (50,):
                checks.append((f"masked q={q} {tuple(x.shape)}",
                               masked_nearest_rank_percentile(x.to(dev), mask.to(dev),
                                                              cnt.to(dev), q),
                               masked_nearest_rank_percentile(x, mask, cnt, q)))
            q = 99 if x.shape[0] > 1 else 1
            checks.append((f"percentile_all q={q} {tuple(x.shape)}",
                           percentile_all(x.to(dev), q), percentile_all(x, q)))
        torch.cuda.synchronize()
        b3, b6 = launch_counts([sel.kth_smallest_pallas, ss.kth_smallest_streaming],
                               before).values()
        for label, got, cpu in checks:
            require(got.is_cuda and torch.equal(got.cpu().view(torch.int32),
                                                cpu.view(torch.int32)),
                    f"percentile {label}: the card's result differs from the CPU's")
        print(f"percentile wrappers on the card: {len(checks)} calls bit for bit the CPU "
              f"versions; B3 launched {b3}, B6 {b6}")
        require(b3 > 0 and b6 > 0, "the percentile wrappers did not select on the card")
        del fields, checks

        # profiling: time_fn (chained, CUDA events) against event_ms, and a trace.
        t_fn = profiling.time_fn(normalizer.transform, batch, iters=20) * 1e3
        t_ev = event_ms(normalizer.transform, [batch], 20)
        print(f"profiling.time_fn Macenko transform {BATCH}x3x{SIZE}^2 u8: {t_fn:.4f} ms, "
              f"event_ms {t_ev:.4f} ms ({t_fn / t_ev - 1:+.1%}, tolerance "
              f"{INGEST_DRIFT:.0%})")
        require(abs(t_fn / t_ev - 1) <= INGEST_DRIFT, "profiling.time_fn disagrees with event_ms")
        with profiling.trace(os.path.join(td, "trace")) as log_dir:
            with profiling.annotate("stainx_transform"):
                normalizer.transform(batch)
        traces = list(Path(log_dir).glob("*.pt.trace.json"))
        require(len(traces) == 1 and traces[0].stat().st_size > 0,
                f"profiling.trace wrote {traces}")
        print(f"profiling.trace: {traces[0].name}, {traces[0].stat().st_size} bytes")

        # The times: ingest-only, copy-only, compute-only and end to end;
        # the device's busy time a batch by graph replay of the transform
        # (the profiler undercounts late in the run, PERF.md section 7).
        result = example.measure(files, shape, BATCH, transform)
        example.report(result, BATCH, SIZE, out=lambda m: print(f"ingest {m}"))
        t0 = time.perf_counter()
        for _ in RawTileLoader(files, shape, BATCH, drop_remainder=True, device="cpu"):
            pass
        print(f"ingest a CPU-device loader's pass (its slots allocated and faulted in anew): "
              f"{(time.perf_counter() - t0) * 1e3 / n_batches:.4f} ms/batch")
        busy = graph_ms(transform, [resident], 20)
        copy_ms = result["seconds"]["copy-only"] * 1e3 / n_batches
        t_e2e = result["seconds"]["end-to-end"] * 1e3
        print(f"ingest end to end: device busy {busy:.4f} ms/batch in the transform (graph "
              f"replay), {copy_ms:.4f} ms/batch in the copy (copy-only leg); idle share "
              f"{1 - n_batches * busy / t_e2e:.3f} (kernels), "
              f"{1 - n_batches * (busy + copy_ms) / t_e2e:.3f} (kernels and copies, summed) of "
              f"{t_e2e:.3f} ms")
    require((os.path.exists(tilepipe_jax_so[0]),
             os.path.exists(tilepipe_jax_so[0]) and os.stat(tilepipe_jax_so[0]).st_mtime_ns)
            == tilepipe_jax_so[1:], "the run wrote the JAX package's stainx_tpu/io/_tilepipe.so")


HARNESS_LOG = os.path.join(ROOT, "build", "harness.log")  # phase 6's full output
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline"}  # bench.py's last line


def harness_phase() -> None:
    """Phase 6, the port's measuring scripts (``bench_torch.py`` and
    ``benchmarks_torch/``), each ``main`` called in this process at reduced
    runs; their full output goes to :data:`HARNESS_LOG`, a few lines each to
    standard output."""
    import contextlib
    import io
    import math

    import bench_torch
    from benchmarks_torch import bench_batch_mode, bench_serving, benchmark_grid, correctness_report

    os.makedirs(os.path.dirname(HARNESS_LOG), exist_ok=True)
    with open(HARNESS_LOG, "w") as log:
        def call(script, main, argv):
            out = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                result = main(argv)
            secs = time.perf_counter() - t0
            log.write(f"$ {script} {' '.join(argv)} ({secs:.1f} s)\n{out.getvalue()}\n")
            log.flush()
            return result, out.getvalue().strip().splitlines()

        bench, lines = call("bench_torch.py", bench_torch.main, ["--runs", "5"])
        last = json.loads(lines[-1])
        print(f"harness: {lines[0]}")
        print(f"harness: bench_torch {bench['called_ms']:.4f} ms called, {bench['busy_ms']:.4f} "
              f"busy, idle share {bench['idle_share']:.3f}, launches {bench['launches']}, oracle "
              f"MAE {bench['mae']:.4f}; last line {lines[-1]}")
        require(set(last) == BENCH_KEYS and last["metric"] == bench_torch.METRIC,
                f"bench_torch's last line {lines[-1]} is not bench.py's four keys")
        require(isinstance(last["value"], float) and math.isfinite(last["value"])
                and last["value"] > 0, f"bench_torch's value {last['value']} is not positive")
        require(bench["launches"] == {"B4": 1}, f"bench_torch launched {bench['launches']}")

        serving, _ = call("benchmarks_torch.bench_serving", bench_serving.main,
                          ["--size", "512", "2048", "4096", "--tiles", "4", "--runs", "4",
                           "--json"])
        for row in serving:
            print(f"harness: serving 1x3x{row['size']}^2 u8: {row['called_ms_per_tile']:.4f} ms "
                  f"called, {row['busy_ms_per_tile']:.4f} busy, idle share "
                  f"{row['idle_share']:.3f}, {row['mpix_per_s']:.1f} MPix/s, {row['kernel']} "
                  f"({row['b4_route']}), repeats bit for bit {row['repeat_bit_identical']}")
            require(row["repeat_bit_identical"], f"serving {row['size']}^2: a tile did not repeat")
        require([row["size"] for row in serving] == [512, 2048, 4096], "serving sizes")

        batch_rows = []
        for argv in (["--dtype", "uint8"], ["--dtype", "float32", "--pooled"]):
            rows, _ = call("benchmarks_torch.bench_batch_mode", bench_batch_mode.main,
                           ["--batch", "256", "--size", "224", "--runs", "5", "--json", *argv])
            batch_rows += rows
        for row in batch_rows:
            print(f"harness: batch mode {row['method']} {row['mode']} {row['batch']}x3x"
                  f"{row['size']}^2 {row['dtype']}: "
                  f"{row['called_ms']:.4f} ms called ({row['img_per_s']:.0f} img/s), "
                  f"{row['busy_ms']:.4f} busy, idle share {row['idle_share']:.3f}, "
                  f"launches {row['launches']}")
            require(row["launches"], f"batch mode {row['method']} launched no kernel")
        require([r["method"] for r in batch_rows] == ["macenko", "reinhard", "histogram_matching",
                                                      "macenko"], "batch mode rows")

        report, _ = call("benchmarks_torch.correctness_report", correctness_report.main,
                         ["--dtypes", "uint8", "float32", "--non-square"])
        failed = correctness_report.failures(report)
        print(f"harness: correctness report, {len(report)} rows, {failed} above their gate; the "
              f"row nearest its gate: {max(report, key=lambda row: row[3] / row[4])}")
        require(len(report) == 32 and failed == 0, f"the correctness report failed {failed} gates")

        for method in ("macenko", "reinhard", "histogram_matching"):
            (row,), _ = call("benchmarks_torch.benchmark_grid", benchmark_grid.main,
                             ["--method", method, "--batch-size", "64", "--image-size", "512",
                              "--runs", "5", "--json"])
            gate = 0.35 if method == "macenko" else 1.0
            print(f"harness: grid {method} 64x3x512^2 u8: {row['called_ms']:.4f} ms called "
                  f"({row['mpix_per_s']:.1f} MPix/s), {row['busy_ms']:.4f} busy, idle share "
                  f"{row['idle_share']:.3f}, MAE vs oracle {row['mae_vs_oracle']:.4f} (≤ {gate})")
            require(row["mae_vs_oracle"] <= gate and row["mpix_per_s"] > 0,
                    f"grid {method}: MAE {row['mae_vs_oracle']} or rate {row['mpix_per_s']}")
    print(f"harness: full output in {os.path.relpath(HARNESS_LOG, ROOT)}")


USER_LOG = os.path.join(ROOT, "build", "user_programs.log")  # phase 7's full output
EXAMPLES_OUT = os.path.join(ROOT, "build", "examples_torch")  # the examples' panels
# tests/test_real_data.py's oracle tolerances on the committed tiles
REAL_HE_RTOL, REAL_HE_ATOL, REAL_MC_RTOL, REAL_MC_ATOL = 1e-4, 1e-5, 1e-3, 1e-4
REAL_MACENKO_MAX, REAL_MACENKO_MAE, REAL_GREY = 2.0, 0.35, 1.0


def user_programs_phase(dev) -> None:
    """Phase 7: the kernels on the committed structured tiles
    (``examples/data/``: a 384² target and five 384² sources with white
    background, nuclei and texture) against their plain versions and the
    oracle, then the port's user programs (``benchmarks_torch/
    pareto_time_mae.py``, ``examples_torch/``) called in this process; their
    full output goes to :data:`USER_LOG`."""
    import contextlib
    import glob
    import io
    import math

    import numpy as np
    import numpy_reference as oracle
    import torch

    from benchmarks_torch import pareto_time_mae
    from benchmarks_torch.utils import count_launches
    from examples_torch import (
        pipeline_example,
        serving_example,
        simple_example,
        visualize_example,
    )
    from examples_torch._common import DATA_DIR, load_nchw, run_notebook
    from examples_torch._png import read_png
    from stainx_tpu_torch import HistogramMatching, Macenko, Reinhard, kernels
    from stainx_tpu_torch.kernels import histogram as hk
    from stainx_tpu_torch.kernels import macenko_fused as mf
    from stainx_tpu_torch.kernels import macenko_stream as ms
    from stainx_tpu_torch.kernels import reinhard_fused as rf
    from stainx_tpu_torch.ops.reinhard import moments_to_mean_std

    # 7a. The kernels against their plain versions on the same CUDA tensors,
    # at phase 3's gates, and the launches of each public call.
    t0 = time.perf_counter()
    names = sorted(os.path.basename(p) for p in glob.glob(os.path.join(DATA_DIR, "test_*.png")))
    target_np = load_nchw(os.path.join(DATA_DIR, "target.png"))
    sources_np = np.concatenate([load_nchw(os.path.join(DATA_DIR, n)) for n in names])
    require(target_np.shape == (1, 3, 384, 384) and sources_np.shape == (5, 3, 384, 384),
            f"the committed tiles: target {target_np.shape}, sources {sources_np.shape}")
    target, sources = torch.from_numpy(target_np).to(dev), torch.from_numpy(sources_np).to(dev)
    tiles = f"the five 384^2 test tiles ({', '.join(names)})"
    print(f"structured tiles: target {tuple(target.shape)}, sources {tuple(sources.shape)} u8; "
          f"background (every channel ≥ 230) {float((sources >= 230).all(1).float().mean()):.4f} "
          f"of the sources' pixels, {float((target >= 230).all(1).float().mean()):.4f} of the "
          f"target's")
    smem = kernels.device_limits(dev.index)[1]

    def routes(x, fit):
        n, _, h, w = x.shape
        row_len = n * h * w if fit else h * w
        default = ms.route(row_len, x.dtype, smem)
        fits = ms.fits_cluster(row_len, x.element_size(), smem)
        return [default] + [r for r in ("cluster", "stream") if r != default and fits]

    def bits(t):
        return t.contiguous().view(torch.int32)

    def check_fused(label, x, he, mc, fit, force):
        """The selections fused into B4 or B5, bit for bit against B6's plain
        version on the keys the call selected on; two calls the same bits."""
        r = fused_selections(x, he, mc, fit, force)
        print(f"fused selections of {'B5' if fit else 'B4'} {label}, {force} route: "
              f"{r['past_beta'][0]}-{r['past_beta'][1]} of {r['angles'][1]} pixels past beta; "
              f"phi, maxC bit-exact {(r['phi'], r['maxc'])}")
        require(r["phi"] and r["maxc"],
                f"{label}: a fused selection differs from B6's plain version")
        require(r["repeat"], f"{label}: two runs' statistics differ")

    def launched(label, call, want):
        result, got = count_launches(call)
        print(f"{label}: launches {got}")
        require(got == want, f"{label}: launched {got}, not {want}")
        return result

    # Macenko: the fit (B5) and the transform (B4).
    macenko = Macenko(device=dev)
    launched("Macenko().fit(target)", lambda: macenko.fit(target), {"B5": 1})
    he, mc = macenko._stain_matrix, macenko._target_max_conc
    he_p, mc_p = mf.macenko_fit_mega_plain(target)
    fit_routes = routes(target, True)
    for force in fit_routes:
        he5, mc5 = ms.macenko_fit_stream(target, force=force)
        again = ms.macenko_fit_stream(target, force=force)
        torch.cuda.synchronize()
        he_err = (he5 - he_p).abs().max().item()
        mc_rel = ((mc5 - mc_p).abs() / mc_p.abs()).max().item()
        print(f"B5 fit target 1x3x384^2 u8, {force} route: HE max|d| {he_err:.3g} (atol 2e-5), "
              f"maxC max rel {mc_rel:.3g} (rtol 1e-4)")
        torch.testing.assert_close(he5, he_p, atol=2e-5, rtol=0)
        torch.testing.assert_close(mc5, mc_p, atol=0, rtol=1e-4)
        require(torch.equal(again[0], he5) and torch.equal(again[1], mc5),
                f"the target's B5 fit ({force} route): two runs differ")
        if force == fit_routes[0]:  # the route the public fit took
            require(torch.equal(he5, he) and torch.equal(mc5, mc),
                    "Macenko().fit(target) differs from B5 on its own route")
        check_fused("target 1x3x384^2 u8", target, he, mc, True, force)
    out_m = launched(f"Macenko.transform of {tiles}", lambda: macenko.transform(sources),
                     {"B4": 1})
    plain_m = mf.macenko_transform_mega_plain(sources, he, mc)
    for force in routes(sources, False):
        out_k = ms.macenko_transform_stream(sources, he, mc, force=force)
        torch.cuda.synchronize()
        err = (out_k.float() - plain_m.float()).abs().max().item()
        print(f"B4 transform 5x3x384^2 u8, {force} route: max|d| {err:.3g} grey levels from B1's "
              f"plain version (tolerance 1), {(out_k != plain_m).float().mean().item():.6f} differ")
        require(err <= 1.0, f"B4 ({force} route) on the tiles: {err} grey levels from plain")
        check_fused("5x3x384^2 u8", sources, he, mc, False, force)
    require(torch.equal(macenko.transform(sources), out_m), "two Macenko transforms differ")

    # Reinhard: the fit (B7b and its finalize) and the transform (B7b, B7a).
    for label, x in [("target 1x3x384^2", target), ("sources 5x3x384^2", sources)]:
        s_k, s_p = torch.cat(rf.reinhard_moments(x)), torch.cat(rf.reinhard_moments_plain(x))
        mean_k, std_k = rf.reinhard_mean_std(x)
        mean_f, std_f = moments_to_mean_std(x.shape[0] * x.shape[2] * x.shape[3],
                                            *rf.reinhard_moments(x))
        torch.cuda.synchronize()
        rel = ((s_k - s_p).abs() / s_p.abs()).max().item()
        exact = torch.equal(mean_k, mean_f) and torch.equal(std_k, std_f)
        print(f"B7b moments {label} u8: max|d| {(s_k - s_p).abs().max().item():.6g}, max rel "
              f"{rel:.3g} (rtol 1e-4, atol 1e-2); the finalize's mean and std equal to "
              f"moments_to_mean_std {exact}")
        torch.testing.assert_close(s_k, s_p, rtol=1e-4, atol=1e-2)
        require(exact, f"{label}: B7b's finalize differs from moments_to_mean_std")
    reinhard = Reinhard(device=dev)
    launched("Reinhard().fit(target)", lambda: reinhard.fit(target), {"B7b": 1})
    ref_mean, ref_std = reinhard._reference_mean, reinhard._reference_std
    out_r = launched(f"Reinhard.transform of {tiles}", lambda: reinhard.transform(sources),
                     {"B7b": 1, "B7a": 1})
    n_px = sources.shape[0] * sources.shape[2] * sources.shape[3]
    src_stats = moments_to_mean_std(n_px, *rf.reinhard_moments_plain(sources))
    plain_r = rf.reinhard_apply_plain(sources, *src_stats, ref_mean, ref_std)
    apply_k = rf.reinhard_apply(sources, *rf.reinhard_mean_std(sources), ref_mean, ref_std)
    torch.cuda.synchronize()
    err_r = (out_r.float() - plain_r.float()).abs().max().item()
    err_a = (apply_k.float() - plain_r.float()).abs().max().item()
    print(f"Reinhard transform (B7b, B7a) of the tiles: max|d| {err_r:.3g} from the plain steps "
          f"(tolerance 1), {(out_r != plain_r).float().mean().item():.6f} differ; B7a alone on "
          f"B7b's statistics {err_a:.3g}")
    require(err_r <= 1.0 and err_a <= 1.0, f"Reinhard on the tiles: {err_r}, {err_a} grey levels")
    require(torch.equal(reinhard.transform(sources), out_r), "two Reinhard transforms differ")

    # Histogram matching: the fit (B8a, its finalize) and the transform (B8a,
    # the finalize that builds the LUT and its table, B8b): bit for bit.
    hist_match = HistogramMatching(device=dev)
    launched("HistogramMatching().fit(target)", lambda: hist_match.fit(target), {"B8a": 1})
    ref_hist = hist_match._ref_histograms_256
    values = sources.reshape(5, 3, -1)
    counts_p = hk.histogram_256_plain(values)
    same_fit = torch.equal(ref_hist, hk.normalized_histogram(
        hk.histogram_256_plain(target.reshape(1, 3, -1))))
    same_hist = torch.equal(hk.histogram_256(values), counts_p)
    out_h = launched(f"HistogramMatching.transform of {tiles}",
                     lambda: hist_match.transform(sources), {"B8a": 1, "B8b": 1})
    _, lut_k, table_k = hk.hm_transfer(values, ref_hist, torch.uint8)
    lut_p = hk.hm_build_lut(counts_p, ref_hist, float(values.shape[0] * values.shape[2]))
    plain_h = hk.apply_lut_plain(values, lut_p, torch.uint8).reshape(sources.shape)
    torch.cuda.synchronize()
    same = (same_fit, same_hist, torch.equal(lut_k, lut_p),
            torch.equal(table_k, hk.lut_table(lut_p, torch.uint8)), torch.equal(out_h, plain_h))
    print(f"HM on the tiles: fit histogram, B8a counts, LUT, table, output equal to the plain "
          f"steps {same}; pinned LUT entries {int((lut_p == 0).sum())} at 0, "
          f"{int((lut_p == 255).sum())} at 255")
    require(all(same), "HM on the tiles differs from its plain steps")
    require(torch.equal(hist_match.transform(sources), out_h), "two HM transforms differ")

    pair = [sources, sources.flip(0).contiguous()]
    for label, call in [("Macenko", macenko.transform), ("Reinhard", reinhard.transform),
                        ("HistogramMatching", hist_match.transform)]:
        called, busy = event_ms(call, pair, 20), graph_ms(call, pair, 20)
        print(f"{label}.transform of the five 384^2 tiles: {called:.4f} ms called "
              f"({5 * 384 * 384 / called / 1e3:.1f} MPix/s), {busy:.4f} busy, idle share "
              f"{1.0 - busy / called:.3f}")
    print(f"phase 7a: {time.perf_counter() - t0:.1f} s")

    # 7b. The oracle on each tile, at tests/test_real_data.py's tolerances.
    t0 = time.perf_counter()
    he_o, mc_o = oracle.macenko_fit(target_np)
    np.testing.assert_allclose(he.cpu().numpy(), he_o, rtol=REAL_HE_RTOL, atol=REAL_HE_ATOL)
    np.testing.assert_allclose(mc.cpu().numpy(), mc_o, rtol=REAL_MC_RTOL, atol=REAL_MC_ATOL)
    params_o, hists_o = oracle.reinhard_fit(target_np), oracle.hm_fit(target_np)
    worst = {"macenko max": 0.0, "macenko MAE": 0.0, "reinhard": 0.0, "histogram_matching": 0.0}
    for i, name in enumerate(names):
        tile_np, tile = sources_np[i:i + 1], sources[i:i + 1]
        d_m = np.abs(macenko.transform(tile).cpu().numpy().astype(np.float32)
                     - oracle.macenko_transform(tile_np, he_o, mc_o).astype(np.float32))
        d_r = np.abs(Reinhard(device=dev).fit(target).transform(tile).cpu().numpy()
                     .astype(np.float32)
                     - oracle.reinhard_transform(tile_np, *params_o).astype(np.float32)).max()
        d_h = np.abs(HistogramMatching(device=dev).fit(target).transform(tile).cpu().numpy()
                     .astype(np.float32)
                     - oracle.hm_transform(tile_np, hists_o).astype(np.float32)).max()
        print(f"oracle {name}: Macenko max|d| {d_m.max()} (gate 2), MAE {d_m.mean():.6f} "
              f"(gate 0.35); Reinhard max|d| {d_r}, HM max|d| {d_h} (gate 1)")
        require(d_m.max() <= REAL_MACENKO_MAX and d_m.mean() <= REAL_MACENKO_MAE,
                f"{name}: Macenko {d_m.max()} / {d_m.mean()} from the oracle")
        require(d_r <= REAL_GREY and d_h <= REAL_GREY, f"{name}: Reinhard {d_r}, HM {d_h}")
        worst = {"macenko max": max(worst["macenko max"], float(d_m.max())),
                 "macenko MAE": max(worst["macenko MAE"], float(d_m.mean())),
                 "reinhard": max(worst["reinhard"], float(d_r)),
                 "histogram_matching": max(worst["histogram_matching"], float(d_h))}
    print(f"oracle on the tiles: fit HE and maxC within rtol {REAL_HE_RTOL} / {REAL_MC_RTOL}; "
          f"worst tile {worst}")
    print(f"phase 7b: {time.perf_counter() - t0:.1f} s")

    # 7c. The user programs, each main called in this process.
    t0 = time.perf_counter()
    os.makedirs(EXAMPLES_OUT, exist_ok=True)
    with open(USER_LOG, "w") as log:
        def call(script, main, argv):
            out = io.StringIO()
            t1 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                result = main(argv)
            log.write(f"$ {script} {' '.join(argv)} ({time.perf_counter() - t1:.1f} s)\n"
                      f"{out.getvalue()}\n")
            log.flush()
            lines = out.getvalue().strip().splitlines()
            require(bool(lines), f"{script} printed nothing")
            return result, lines

        modes = {"macenko": ["numpy_oracle_cpu", "cuda_stable", "cuda_fast"],
                 "reinhard": ["numpy_oracle_cpu", "cuda"],
                 "histogram_matching": ["numpy_oracle_cpu", "cuda"]}
        pareto_launches = {"macenko": {"B4": 1}, "reinhard": {"B7b": 1, "B7a": 1},
                           "histogram_matching": {"B8a": 1, "B8b": 1}}
        for method, want in modes.items():
            rows, lines = call("benchmarks_torch.pareto_time_mae", pareto_time_mae.main,
                               ["--method", method, "--runs", "3", "--json"])
            if method == "macenko":
                print(f"programs: {lines[0]}")
            for row in rows:
                print(f"programs: pareto {method} {row['mode']}: {row['img_per_s']:.2f} img/s "
                      f"({row['ms_per_batch']:.4f} ms a batch of {pareto_time_mae.BATCH}), MAE "
                      f"{row['mae']:.6f}, launches {row['launches']}")
                require(math.isfinite(row["img_per_s"]) and row["img_per_s"] > 0,
                        f"pareto {method} {row['mode']}: rate {row['img_per_s']}")
                require(row["mae"] <= (0.35 if method == "macenko" else 1.0),
                        f"pareto {method} {row['mode']}: MAE {row['mae']}")
                if row["mode"].startswith("cuda"):
                    require(row["launches"] == pareto_launches[method],
                            f"pareto {method} {row['mode']} launched {row['launches']}")
            require([row["mode"] for row in rows] == want, f"pareto {method} series {rows}")

        panel_path = os.path.join(EXAMPLES_OUT, "normalized.png")
        simple, lines = call("examples_torch/simple_example.py", simple_example.main,
                             ["--out", panel_path])
        require(np.array_equal(read_png(panel_path), simple["panel"]),
                "simple_example's PNG does not read back as its panel")
        print(f"programs: simple_example: {lines[-1]}")

        vis, lines = call("examples_torch/visualize_example.py", visualize_example.main,
                          ["macenko", "--runs", "1", "--save-plots", "--output-dir",
                           EXAMPLES_OUT])
        require(vis["names"] == names and len(vis["results"]) == 5,
                f"visualize_example read {vis['names']}")
        require(np.array_equal(read_png(vis["panel"]), visualize_example.panel(
            vis["reference"], vis["sources"], vis["results"])), "visualize_example's panel")
        print(f"programs: visualize_example: {lines[-2]}")

        pipe, lines = call("examples_torch/pipeline_example.py", pipeline_example.main,
                           ["--epochs", "1"])
        for key in ("out", "batch_mode_out"):
            y = pipe[key]
            require(y.is_cuda and y.dtype == torch.float32 and bool(torch.isfinite(y).all())
                    and 0.0 <= float(y.min()) and float(y.max()) <= 1.0,
                    f"pipeline_example's {key} is not float [0, 1] on the card")
        print(f"programs: pipeline_example: {lines[0]}")

        serve, lines = call("examples_torch/serving_example.py", serving_example.main, [])
        require(len(serve["outputs"]) == 8 and all(o.is_cuda for o in serve["outputs"]),
                "serving_example's outputs")
        print(f"programs: serving_example: {lines[-1]}")

        notebook, lines = call("examples_torch/quickstart_notebook.ipynb",
                               lambda _argv: run_notebook(), [])
        y = notebook["model_input"]
        require(notebook["DEVICE"] == "cuda:0" and notebook["normalized"].is_cuda
                and y.is_cuda and 0.0 <= float(y.min()) and float(y.max()) <= 1.0,
                "the notebook's cells did not run on the card")
        print(f"programs: quickstart_notebook: {len(lines)} lines of output; last {lines[-1]}")
    print(f"programs: full output in {os.path.relpath(USER_LOG, ROOT)}")
    print(f"phase 7c: {time.perf_counter() - t0:.1f} s")


# Phase 8: seeded random shapes on both sides of every kernel's route edge.
SWEEP_SEEDS = 12  # tests/test_fuzz_parity.py's cases
EDGE_DRAWS = 2  # random draws a side of an edge, beside the size at the edge


def _sweep_case(oracle, seed: int):
    """``(ref, batch)`` of ``tests/test_fuzz_parity.py::_random_case`` (that
    file imports the JAX package): odd sizes of 17-96, batches of 1-4, a
    white patch in half the cases."""
    import numpy as np

    rng = np.random.default_rng(seed)
    h, w, n = int(rng.integers(17, 97)), int(rng.integers(17, 97)), int(rng.integers(1, 5))
    ref = oracle.synthetic_he_tile(h, w, seed=seed * 7 + 1, he_scale=float(rng.uniform(0.9, 1.1)))
    tiles = [oracle.synthetic_he_tile(h, w, seed=seed * 31 + i,
                                      he_scale=float(rng.uniform(0.85, 1.2))) for i in range(n)]
    batch = np.concatenate(tiles, axis=0)
    if rng.random() < 0.5 and h > 8 and w > 8:
        batch[0, :, : h // 4, : w // 4] = 255
    return ref, batch


def negative_maxc_tile(seed: int):
    """(1, 3, 64, 64) uint8: the OD design of ``tests/test_kernels.py::
    test_negative_max_concentration_tile`` (seed 0 is its tile; numpy only):
    a bulk cluster, an anchor and a satellite clump more than pi away in
    the stain plane over a diluted background, so the tile's fit gives a
    negative maxC."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n_bg, n_sat, n_anchor = 2560, 20, 16
    n_bulk = 64 * 64 - n_bg - n_sat - n_anchor
    d = np.ones(3) / np.sqrt(3)
    t1 = np.array([1.0, -1.0, 0.0]) / np.sqrt(2)
    t2 = np.array([1.0, 1.0, -2.0]) / np.sqrt(6)

    def v(psi):
        return np.cos(psi)[..., None] * t1 + np.sin(psi)[..., None] * t2

    psis, rs = rng.uniform(0.05, 0.2, n_bulk), rng.uniform(0.06, 0.10, n_bulk)
    od = np.concatenate([0.5 * d + rs[:, None] * v(psis),
                         0.5 * d + 0.08 * v(np.full(n_anchor, -0.2)),
                         0.5 * d + 0.09 * v(-2.8 + rng.uniform(-0.02, 0.02, n_sat)),
                         np.tile(0.17 * (0.5 * d + 0.08 * v(np.array(0.125))), (n_bg, 1))])
    tile = np.clip(np.round(240.0 * np.exp(-od) - 1.0), 0, 255).astype(np.uint8)
    rng.shuffle(tile, axis=0)
    return np.ascontiguousarray(tile.T.reshape(1, 3, 64, 64))


def docs_pages_check() -> None:
    """The port's API pages (``docs_torch/gen_api.py``) regenerated with this
    machine's torch must equal the committed ``docs_torch/api/*.md``."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "docs_torch_gen_api", os.path.join(ROOT, "docs_torch", "gen_api.py"))
    gen_api = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen_api)
    pages = gen_api.build_pages()
    differ = []
    for name, body in sorted(pages.items()):
        path = os.path.join(gen_api.OUT_DIR, name)
        if not os.path.isfile(path) or Path(path).read_text() != body:
            differ.append(name)
    orphans = sorted(set(os.listdir(gen_api.OUT_DIR)) - set(pages))
    print(f"API pages: {len(pages)} regenerated here, differ from the committed: {differ}, "
          f"orphans: {orphans}")
    require(not differ and not orphans,
            f"docs_torch/api differs on this machine: {differ} {orphans}")


def random_shapes_phase(seed: int, dev) -> None:
    """Phase 8: seeded random shapes on both sides of every kernel's route
    edge (module docstring). Every case is held at phase 3's gates, its
    launches are those the ladder names for its size, and two runs give
    the same bits; each prints one line."""
    import math

    import numpy as np
    import numpy_reference as oracle
    import torch

    from benchmarks_torch.utils import count_launches
    from stainx_tpu_torch import HistogramMatching, Macenko, Reinhard, kernels
    from stainx_tpu_torch.kernels import histogram as hk
    from stainx_tpu_torch.kernels import macenko_fused as mf
    from stainx_tpu_torch.kernels import macenko_stream as ms
    from stainx_tpu_torch.kernels import reinhard_fused as rf
    from stainx_tpu_torch.kernels import selection as sel
    from stainx_tpu_torch.kernels import selection_stream as ss
    from stainx_tpu_torch.ops import color
    from stainx_tpu_torch.ops import macenko as mk
    from stainx_tpu_torch.ops import percentile as pct
    from stainx_tpu_torch.ops.percentile import nearest_rank_index
    from stainx_tpu_torch.ops.reinhard import moments_to_mean_std
    from stainx_tpu_torch.testing import HE_REF, largest

    t_start = time.perf_counter()
    docs_pages_check()
    smem = kernels.device_limits(dev.index)[1]
    rng = np.random.default_rng(seed + 8000)
    u8, f32 = torch.uint8, torch.float32

    # The edges, read on this card (the ladder's constants where they are
    # constants, the shared memory's limits where the card sets them).
    resident = {dt: largest(lambda p, dt=dt: mf.transform_body(p, dt, smem) == "resident")
                for dt in (u8, f32)}
    b2_pool = {dt: largest(lambda p, dt=dt: mk.fit_route(p, dt, smem) == "mega")
               for dt in (u8, f32)}
    cluster = {dt: largest(lambda p, dt=dt: ms.fits_cluster(p, 1 if dt == u8 else 4, smem))
               for dt in (u8, f32)}
    stream_min = {u8: mk.STREAM_MIN_ELEMS, f32: mk.STREAM_MIN_ELEMS_F32}
    stream_rows = {u8: mk.STREAM_MAX_ROWS, f32: mk.STREAM_MAX_ROWS_F32}
    print(f"phase 8 edges on this card ({smem} bytes of shared memory a block): B1 resident up to "
          f"{resident[u8]} u8 / {resident[f32]} f32 pixels; B1 or B4 from {stream_min[u8]} u8 / "
          f"{stream_min[f32]} f32 pixels a row, up to {stream_rows[u8]} / {stream_rows[f32]} rows; "
          f"B2 up to {b2_pool[u8]} u8 / {b2_pool[f32]} f32 pooled pixels; the cluster route up to "
          f"{cluster[u8]} u8 / {cluster[f32]} f32 pixels a row; B3 or B6 from "
          f"{pct.SELECT_STREAM_MIN_ELEMS} elements, up to {pct.SELECT_STREAM_MAX_ROWS} rows")

    def tiles(n, h, w, dtype, case_seed):
        """(n, 3, h, w) Beer-Lambert H&E tiles made on the card."""
        g = torch.Generator(device=dev).manual_seed(case_seed)
        scale = 0.9 + 0.3 * torch.rand((), generator=g, device=dev)
        he = torch.tensor(HE_REF, device=dev) * scale
        conc = torch.stack([0.3 + 1.8 * torch.rand((n, h * w), generator=g, device=dev),
                            0.2 + torch.rand((n, h * w), generator=g, device=dev)], 1)
        x = torch.clamp(240.0 * torch.exp(-torch.einsum("cs,nsp->ncp", he, conc)), 0.0, 255.0)
        x = x.to(u8).reshape(n, 3, h, w)
        return x if dtype == u8 else x.to(f32) / 255.0

    def shape_of(size: int, per: int) -> tuple[int, int]:
        """A random H (from 2/3 to 3/2 of the square's side) and the W that
        brings H * W * per nearest ``size``."""
        target = size // per
        side = math.isqrt(target)
        h = int(rng.integers(max(1, side * 2 // 3), side * 3 // 2 + 2))
        return h, max(1, round(target / h))

    def exact_shape(p: int) -> tuple[int, int]:
        """The most square H x W of exactly p pixels (1 x p for a prime)."""
        h = math.isqrt(p)
        while p % h:
            h -= 1
        return h, p // h

    def within(edge: int, side: str, per: int = 1):
        """H and W of a random draw with H * W * per within 1 % of ``edge``
        (the first size above it) on ``side``."""
        lo, hi = ((math.ceil(0.99 * edge), edge - 1) if side == "below"
                  else (edge, math.floor(1.01 * edge)))
        while True:
            h, w = shape_of(int(rng.integers(lo, hi + 1)), per)
            if lo <= h * w * per <= hi:
                return h, w

    # ----------------------------------------------------------- checks
    def bits(t):
        return t.contiguous().view(torch.int32)

    def launched(label, call, want):
        result, got = count_launches(call)
        require(got == want, f"phase 8, {label}: launched {got}, not {want}")
        return result, got

    worst = {k: 0.0 for k in ("B1", "B2", "B4", "B5", "B7b", "B7a", "B8a", "B8b", "B3", "B6")}
    sides: dict[str, dict[str, set]] = {}

    def record(edge, side, route):
        if edge:
            sides.setdefault(edge, {"below": set(), "above": set()})[side].add(route)

    def run_case(label, ref, batch, edge=None, side=None, hm_pair=None, oracle_np=None,
                 ill_posed=False):
        """Macenko, Reinhard and histogram matching fit -> transform on one
        case, each against its plain version. ``ill_posed``: a tile whose
        Macenko percentile picks flip with the last ulp of a key (the
        negative-maxC design), held as ``tests/test_kernels.py`` holds it:
        the kernels' selections exact on their own keys, the fit's maxC
        negative, the transform finite and under half of it saturated."""
        n, _, h, w = batch.shape
        dt = batch.dtype
        grey = 1.0 if dt == u8 else 1.0 / 255.0
        pool = ref.shape[0] * ref.shape[2] * ref.shape[3]
        fit_k = "B2" if pool <= b2_pool[dt] else "B5"
        tr_k = "B4" if h * w >= stream_min[dt] and n <= stream_rows[dt] else "B1"
        fit_route = "resident" if fit_k == "B2" else ms.route(pool, dt, smem)
        tr_route = ms.route(h * w, dt, smem) if tr_k == "B4" else mf.transform_body(h * w, dt, smem)
        ref_c, x_c = ref.contiguous(), batch.contiguous()
        # Macenko: the fit, then the transform.
        macenko = Macenko(device=dev)
        launched(f"{label} Macenko fit", lambda: macenko.fit(ref), {fit_k: 1})
        he, mc = macenko._stain_matrix, macenko._target_max_conc
        he_p, mc_p = mf.macenko_fit_mega_plain(ref_c)
        again = Macenko(device=dev).fit(ref)
        fit_err = (he - he_p).abs().nan_to_num(0.0).max().item()
        mc_rel = ((mc - mc_p).abs() / mc_p.abs()).nan_to_num(0.0).max().item()
        if ill_posed:
            require(float(mc.min()) < 0.0 and float(mc_p.min()) < 0.0,
                    f"phase 8, {label}: maxC {mc.tolist()}, plain {mc_p.tolist()}, not negative")
        else:
            require(torch.equal(he.isnan(), he_p.isnan()) and torch.equal(mc.isnan(), mc_p.isnan())
                    and fit_err <= 2e-5 and mc_rel <= 1e-4,
                    f"phase 8, {label}: {fit_k} HE {fit_err}, maxC relative {mc_rel} from its "
                    f"plain version (HE atol 2e-5, maxC rtol 1e-4)")
        require(torch.equal(bits(he), bits(again._stain_matrix))
                and torch.equal(bits(mc), bits(again._target_max_conc)),
                f"phase 8, {label}: two fits differ")
        if fit_k == "B5":
            r = fused_selections(ref_c, he, mc, True, fit_route)
            fit_sel = r["phi"] and r["maxc"] and r["repeat"]
        else:
            fit_sel = one_block_selections(ref_c, he, mc, True)[0]
        require(fit_sel, f"phase 8, {label}: {fit_k}'s selections differ from the plain select")
        out, _ = launched(f"{label} Macenko transform", lambda: macenko.transform(batch), {tr_k: 1})
        plain = mf.macenko_transform_mega_plain(x_c, he, mc)
        err = (out.float() - plain.float()).abs().max().item()
        require(out.dtype == dt and out.shape == batch.shape
                and bool(torch.isfinite(out.float()).all()),
                f"phase 8, {label}: Macenko output {out.dtype} {tuple(out.shape)}")
        if ill_posed:
            saturated = ((out == 0) | (out == 255)).float().mean().item()
            require(saturated < 0.5, f"phase 8, {label}: {saturated} of the output saturated")
        else:
            require(err <= 1.0,
                    f"phase 8, {label}: {tr_k} {err} grey levels from its plain version")
        require(torch.equal(macenko.transform(batch), out),
                f"phase 8, {label}: two transforms differ")
        if tr_k == "B4":
            r = fused_selections(x_c, he, mc, False, tr_route)
            tr_sel = r["phi"] and r["maxc"] and r["repeat"]
        else:
            tr_sel = tr_route != "resident" or one_block_selections(x_c, he, mc, False)[0]
        require(tr_sel, f"phase 8, {label}: {tr_k}'s selections differ from the plain select")
        if not ill_posed:
            worst[fit_k] = max(worst[fit_k], fit_err)
            worst[tr_k] = max(worst[tr_k], err)
        # Reinhard: B7b at fit, B7b + B7a at transform.
        reinhard = Reinhard(device=dev)
        launched(f"{label} Reinhard fit", lambda: reinhard.fit(ref), {"B7b": 1})
        out_r, _ = launched(f"{label} Reinhard transform", lambda: reinhard.transform(batch),
                            {"B7b": 1, "B7a": 1})
        s_k, s_p = torch.cat(rf.reinhard_moments(x_c)), torch.cat(rf.reinhard_moments_plain(x_c))
        require(bool(((s_k - s_p).abs() <= 1e-2 + 1e-4 * s_p.abs()).all()),
                f"phase 8, {label}: B7b's moments {s_k.tolist()} against {s_p.tolist()}")
        stats = moments_to_mean_std(n * h * w, *rf.reinhard_moments_plain(x_c))
        plain_r = rf.reinhard_apply_plain(x_c, *stats, reinhard._reference_mean,
                                          reinhard._reference_std)
        err_r = (out_r.float() - plain_r.float()).abs().max().item()
        require(err_r <= grey * (1.0 + 1e-5),
                f"phase 8, {label}: Reinhard {err_r} from the plain steps")
        require(torch.equal(reinhard.transform(batch), out_r),
                f"phase 8, {label}: two Reinhard transforms differ")
        worst["B7a"] = max(worst["B7a"], err_r / grey)
        rel_b7b = ((s_k - s_p).abs() / s_p.abs().clamp(min=1e-2)).max().item()
        worst["B7b"] = max(worst["B7b"], rel_b7b)
        # Histogram matching, bit for bit.
        ref_h, x_h = hm_pair if hm_pair is not None else (ref, batch)
        hist_match = HistogramMatching(device=dev)
        launched(f"{label} HM fit", lambda: hist_match.fit(ref_h), {"B8a": 1})
        out_h, _ = launched(f"{label} HM transform", lambda: hist_match.transform(x_h),
                            {"B8a": 1, "B8b": 1})
        ref_values = color.images_to_uint8(ref_h.contiguous())[0].reshape(
            ref_h.shape[0], 3, -1)
        hist_p = hk.normalized_histogram(hk.histogram_256_plain(ref_values))
        x_u8, scale_back = color.images_to_uint8(x_h.contiguous())
        plain_h, _, _ = hk.hm_transfer_plain(x_u8.reshape(x_h.shape[0], 3, -1), hist_p,
                                             f32 if scale_back else u8)
        require(torch.equal(hist_match._ref_histograms_256, hist_p)
                and torch.equal(out_h, plain_h.to(x_h.dtype).reshape(x_h.shape)),
                f"phase 8, {label}: HM differs from its plain version")
        require(torch.equal(hist_match.transform(x_h), out_h),
                f"phase 8, {label}: two HM transforms differ")
        oracle_line = ""
        if oracle_np is not None:  # the JAX sweep's gates against the numpy oracle
            ref_np, x_np, ref_hn, x_hn = oracle_np
            he_o, mc_o = oracle.macenko_fit(ref_np)
            mae = np.abs(out.cpu().numpy().astype(np.float32)
                         - oracle.macenko_transform(x_np, he_o, mc_o).astype(np.float32)).mean()
            d_r = np.abs(out_r.cpu().numpy().astype(np.float32) - oracle.reinhard_transform(
                x_np, *oracle.reinhard_fit(ref_np)).astype(np.float32)).max()
            d_h = np.abs(out_h.cpu().numpy().astype(np.float32) - oracle.hm_transform(
                x_hn, oracle.hm_fit(ref_hn)).astype(np.float32)).max()
            require(mae <= 0.35 and d_r <= grey * (1.0 + 1e-5) and d_h <= grey * (1.0 + 1e-5),
                    f"phase 8, {label}: oracle Macenko MAE {mae}, Reinhard {d_r}, HM {d_h}")
            oracle_line = f"; oracle MAE {mae:.4f}, Reinhard {d_r:.4g}, HM {d_h:.4g}"
        if edge and edge.startswith("fit"):
            record(edge, side, f"{fit_k} {fit_route}")
        elif edge and edge.startswith("cluster"):
            record(edge, side, f"{tr_k} {tr_route}, {fit_k} {fit_route}")
        else:
            record(edge, side, f"{tr_k} {tr_route}")
        print(f"phase 8 {label}: ref {tuple(ref.shape)}, batch {tuple(batch.shape)} "
              f"{str(dt).replace('torch.', '')}; launches: fit {fit_k} x1 ({fit_route}) HE |d| "
              f"{fit_err:.3g}, transform {tr_k} x1 ({tr_route}) {err:.3g}, Reinhard B7b, B7b + B7a "
              f"{err_r:.3g}, HM B8a, B8a + B8b 0; selections exact{oracle_line}"
              + (f"; ill-posed: maxC {mc.tolist()} against plain {mc_p.tolist()}, not gated"
                 if ill_posed else ""))

    cases = 0
    # (a) The JAX sweep's band, both dtypes, against the oracle too.
    for case_seed in range(SWEEP_SEEDS):
        ref_np, batch_np = _sweep_case(oracle, case_seed)
        hrng = np.random.default_rng(case_seed * 101 + 13)
        hh, wh = max(ref_np.shape[2], 64), max(ref_np.shape[3], 64)
        ref_hn = hrng.integers(0, 256, size=(1, 3, hh, wh), dtype=np.uint8)
        batch_hn = hrng.integers(0, 256, size=(batch_np.shape[0], 3, hh, wh), dtype=np.uint8)
        for as_float in (False, True):
            arrays = [ref_np, batch_np, ref_hn, batch_hn]
            if as_float:
                arrays = [a.astype(np.float32) / 255.0 for a in arrays]
            ref_t, x_t, ref_ht, x_ht = (torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                                        for a in arrays)
            run_case(f"sweep {case_seed} {'f32' if as_float else 'u8'}", ref_t, x_t,
                     hm_pair=(ref_ht, x_ht), oracle_np=arrays)
            cases += 1

    # (b) Both sides of every Macenko edge: the size at the edge and the
    # first past it, then EDGE_DRAWS random sizes within 1 % on each side.
    def sizes(edge_at: int):
        for side, exact in (("below", edge_at - 1), ("above", edge_at)):
            yield side, exact_shape(exact)
            for _ in range(EDGE_DRAWS):
                yield side, within(edge_at, side)

    for dt, name in ((u8, "u8"), (f32, "f32")):
        for side, (h, w) in sizes(resident[dt] + 1):
            n = int(rng.integers(1, 5))
            x = tiles(n, h, w, dt, int(rng.integers(1 << 30)))
            run_case(f"B1 body {name} {side}", x[:1], x, f"B1 resident/L2 {name}", side)
            cases += 1
        for side, (h, w) in sizes(stream_min[dt]):
            n = int(rng.integers(1, 5))
            x = tiles(n, h, w, dt, int(rng.integers(1 << 30)))
            run_case(f"B1/B4 pixels {name} {side}", x[:1], x, f"B1/B4 pixels {name}", side)
            cases += 1
        row_h, row_w = exact_shape(stream_min[dt])
        for side in ("below", "above"):
            cap = stream_rows[dt]
            lo, hi = ((math.ceil(0.99 * cap), cap) if side == "below"
                      else (cap + 1, math.floor(1.01 * cap) + 1))
            counts = [cap if side == "below" else cap + 1] + [
                int(rng.integers(lo, hi + 1)) for _ in range(EDGE_DRAWS)]
            for n in counts:
                x = tiles(n, row_h, row_w, dt, int(rng.integers(1 << 30)))
                run_case(f"B1/B4 rows {name} {side}", x[:1], x, f"B1/B4 rows {name}", side)
                cases += 1
        for side, (h, w) in sizes(b2_pool[dt] + 1):
            x = tiles(1, h, w, dt, int(rng.integers(1 << 30)))
            run_case(f"B2/B5 pool {name} {side}", x, x, f"fit B2/B5 {name}", side)
            cases += 1
        for per, what in ((2, "two images"), (3, "three images")):
            for side in ("below", "above"):
                h, w = within(b2_pool[dt] + 1, side, per)
                x = tiles(per, h, w, dt, int(rng.integers(1 << 30)))
                run_case(f"B2/B5 pool of {what} {name} {side}", x, x, f"fit B2/B5 {name}", side)
                cases += 1
        for side, (h, w) in sizes(cluster[dt] + 1):
            x = tiles(int(rng.integers(1, 3)), h, w, dt, int(rng.integers(1 << 30)))
            run_case(f"cluster/stream {name} {side}", x[:1], x, f"cluster/stream {name}", side)
            cases += 1

    # (c) Odd strides and offsets: P % 16 != 0, a batch view at an odd byte
    # offset (the one-pixel branches of _vec4 and group_pixels), NHWC strides.
    for dt, name in ((u8, "u8"), (f32, "f32")):
        h, w = 2 * int(rng.integers(20, 60)) + 1, 2 * int(rng.integers(20, 60)) + 1
        x = tiles(4, h, w, dt, int(rng.integers(1 << 30)))
        view = x[1:]
        require(view.data_ptr() % 16 != 0, f"phase 8: the {name} view is aligned")
        run_case(f"offset view {name} (data_ptr % 16 = {view.data_ptr() % 16})", x[:1], view)
        big = tiles(2, 227, 229, dt, int(rng.integers(1 << 30)))
        run_case(f"offset view {name} past B4's edge", big[:1], big[1:])
        nhwc = x.contiguous(memory_format=torch.channels_last)
        require(not nhwc.is_contiguous(), "phase 8: the NHWC-strided batch is contiguous")
        run_case(f"NHWC strides {name}", nhwc[:1], nhwc)
        cases += 3
    # The histogram's split: one block a channel up to MIN_BLOCK_VALUES values.
    for total in (hk.MIN_BLOCK_VALUES - 1, hk.MIN_BLOCK_VALUES, hk.MIN_BLOCK_VALUES + 1,
                  hk.MIN_BLOCK_VALUES * 5 + 7):
        h, w = exact_shape(total)
        x = tiles(1, h, w, u8, int(rng.integers(1 << 30)))
        run_case(f"histogram split, {total} values a channel "
                 f"({hk.hist_split(1, 3, total, kernels.device_limits(dev.index)[0])})", x, x)
        cases += 1
    # Degenerate tiles: fewer than 3 pixels past beta (the transform's
    # fallback) and a tile whose fit gives a negative maxC (the sign guard).
    two_px = tiles(2, 67, 71, u8, int(rng.integers(1 << 30)))
    two_px[:, 0] = torch.clamp(two_px[:, 0], min=215)
    two_px[:, :, 5, 7] = torch.tensor([120, 60, 150], dtype=u8, device=dev)[None, :]
    two_px[:, :, 40, 3] = torch.tensor([90, 70, 130], dtype=u8, device=dev)[None, :]
    run_case("two pixels past beta (fallback)", tiles(1, 64, 64, u8, 3), two_px)
    neg = torch.from_numpy(negative_maxc_tile(0)).to(dev)
    run_case("negative maxC tile", neg, neg, ill_posed=True)
    cases += 2

    # (d) B3 or B6, the staged route's selections: rows of 2^22 - 1 and 2^22
    # elements, 32 and 33 rows, each bit for bit against its plain version.
    def select_case(rows, p, label, expect):
        g = torch.Generator(device=dev).manual_seed(int(rng.integers(1 << 30)))
        field = torch.randn((rows, p), generator=g, device=dev)
        field[torch.rand((rows, p), generator=g, device=dev) < 0.1] = torch.inf
        cnt = (field < torch.inf).sum(1)
        ranks = torch.stack([nearest_rank_index(1, cnt), nearest_rank_index(99, cnt)], 1)
        got, _ = launched(label, lambda: pct._select(field, ranks), {expect: 1})
        again = pct._select(field, ranks)
        plain = (ss.kth_smallest_streaming_plain if expect == "B6"
                 else sel.kth_smallest_pallas_plain)(field, ranks)
        require(torch.equal(bits(got), bits(plain)) and torch.equal(bits(again), bits(got)),
                f"phase 8, {label}: {expect} differs from its plain version or its repeat")
        side = "above" if expect == "B6" else "below"
        record("B3/B6", side, f"{expect} ({rows}, {p})")
        print(f"phase 8 {label}: ({rows}, {p}) float32 K=2, {int(cnt.min())}-{int(cnt.max())} "
              f"finite a row; {expect} x1, bit for bit its plain version, repeat the same bits")

    edge_e, edge_r = pct.SELECT_STREAM_MIN_ELEMS, pct.SELECT_STREAM_MAX_ROWS
    select_case(edge_r, edge_e, "select at the edge", "B6")
    select_case(edge_r, edge_e - 1, "select one element short", "B3")
    select_case(edge_r + 1, edge_e, "select one row past", "B3")
    for _ in range(EDGE_DRAWS):
        select_case(int(rng.integers(edge_r - 3, edge_r + 1)),
                    int(rng.integers(edge_e, math.floor(1.01 * edge_e))), "select inside", "B6")
        select_case(int(rng.integers(edge_r - 3, edge_r + 1)),
                    int(rng.integers(math.ceil(0.99 * edge_e), edge_e)), "select short", "B3")
    cases += 3 + 2 * EDGE_DRAWS
    # The public staged route on bf16 and f16 on each side of the length.
    for dtype, (h, w), expect in ((torch.bfloat16, (2048, 2048), "B6"),
                                  (torch.float16, (2047, 2049), "B3")):
        x = tiles(2, h, w, f32, int(rng.integers(1 << 30))).to(dtype)
        macenko = Macenko(device=dev)
        launched(f"staged fit {dtype} {h}x{w}", lambda: macenko.fit(x[:1]), {expect: 2})
        out, _ = launched(f"staged transform {dtype} {h}x{w}", lambda: macenko.transform(x),
                          {expect: 2})
        require(out.dtype == dtype and bool(torch.isfinite(out.float()).all())
                and torch.equal(macenko.transform(x), out),
                f"phase 8: the staged {dtype} transform is not finite or not repeatable")
        record("B3/B6", "above" if expect == "B6" else "below", f"{expect} staged {dtype}")
        print(f"phase 8 staged {str(dtype).replace('torch.', '')} 2x3x{h}x{w}: fit and transform "
              f"{expect} x2 each, repeat the same bits")
        cases += 1

    for edge, seen in sorted(sides.items()):
        require(bool(seen["below"]) and bool(seen["above"]), f"phase 8, {edge}: a side has no case")
        print(f"phase 8 edge {edge}: below {sorted(seen['below'])}; above {sorted(seen['above'])}")
    print(f"phase 8: {cases} cases; worst error against the plain version: B1 {worst['B1']:.3g}, "
          f"B4 {worst['B4']:.3g} grey levels; B2 {worst['B2']:.3g}, B5 {worst['B5']:.3g} HE; "
          f"B7b {worst['B7b']:.3g} relative; B7a {worst['B7a']:.3g} grey levels; B8a, B8b, B3, "
          f"B6 and the fused selections bit for bit")
    print(f"phase 8: {time.perf_counter() - t_start:.1f} s")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check needs a card",
              file=sys.stderr)
        return 2
    # The JAX package builds its reader library beside its source; this run
    # must not (phase 4c checks it is as it was).
    jax_so = os.path.join(ROOT, "stainx_tpu", "io", "_tilepipe.so")
    tilepipe_jax_so = (jax_so, os.path.exists(jax_so),
                       os.path.exists(jax_so) and os.stat(jax_so).st_mtime_ns)
    sys.path.insert(0, ROOT)
    # tests/ has no __init__.py, and an installed package named `tests`
    # would shadow it: load the numpy oracle from its own directory.
    sys.path.insert(0, os.path.join(ROOT, "tests", "oracles"))
    import numpy as np
    import numpy_reference as oracle

    from stainx_tpu_torch import (
        HistogramMatching,
        Macenko,
        Reinhard,
        StainNormalizerTransform,
        kernels,
    )
    from stainx_tpu_torch.kernels import histogram as hk
    from stainx_tpu_torch.kernels import macenko_fused as mf
    from stainx_tpu_torch.kernels import macenko_stream as ms
    from stainx_tpu_torch.kernels import reinhard_fused as rf
    from stainx_tpu_torch.kernels import selection as sel
    from stainx_tpu_torch.kernels import selection_stream as ss
    from stainx_tpu_torch.ops import macenko as mk
    from stainx_tpu_torch.ops import percentile as pct
    from stainx_tpu_torch.ops.eigh3 import eigh3_top2
    from stainx_tpu_torch.ops.percentile import nearest_rank_index, static_nearest_rank_index
    from stainx_tpu_torch.ops.reinhard import moments_to_mean_std, reinhard_transform
    from stainx_tpu_torch.testing import (
        branch_point_field,
        colour_cube,
        largest,
        synthetic_he_batch,
    )

    dev = torch.device("cuda", 0)

    # 1. The card and the toolchain.
    card = run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    print(card.splitlines()[0])
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"nvcc {run([kernels.nvcc_path(), '--version']).splitlines()[-1]}")

    # 2. Build (and, beside it, phase 3's per-pass build of B4/B5).
    t0 = time.perf_counter()
    per_pass = per_pass_build()
    libs = kernels.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s for {sorted(libs)}")

    def dev_u8(a):
        return torch.as_tensor(np.ascontiguousarray(a)).to(dev)

    ref = dev_u8(synthetic_he_batch(1, SIZE, SIZE, seed=args.seed + 42))
    ref_b = dev_u8(synthetic_he_batch(1, SIZE, SIZE, seed=args.seed + 43))
    batch = dev_u8(synthetic_he_batch(BATCH, SIZE, SIZE, seed=args.seed + 123))
    batch_b = dev_u8(synthetic_he_batch(BATCH, SIZE, SIZE, seed=args.seed + 124, he_scale=1.1))

    # 3. Each kernel against its plain version on the same tensors. The
    # transforms normalize to the reference's plain fit (B5's fit of it is
    # checked below, B2's fits at the pools it holds).
    he_k, mc_k = mf.macenko_fit_mega_plain(ref)

    def check_transform(label, x, he, mc, kernel=mf.macenko_transform_mega, name="B1"):
        out_k = kernel(x, he, mc)
        out_p = mf.macenko_transform_mega_plain(x, he, mc)
        again = kernel(x, he, mc)
        torch.cuda.synchronize()
        err = (out_k.float() - out_p.float()).abs().max().item()
        print(f"{name} transform {label}: max|d| {err:.3g} grey levels (tolerance 1)")
        require(out_k.dtype == x.dtype and out_k.shape == x.shape, f"{label}: dtype or shape")
        require(torch.isfinite(out_k.float()).all(), f"{label}: non-finite output")
        require(err <= 1.0, f"{label}: kernel and plain differ by {err}")
        require(torch.equal(again, out_k), f"{label}: two runs differ")
        return out_k, err

    check_transform(f"{BATCH}x3x{SIZE}^2 u8", batch, he_k, mc_k)
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

    def check_apply(label, x, stats, tol, reference=None):
        params = (*stats, *(reference or (ref_mean, ref_std)))
        out_k = rf.reinhard_apply(x, *params)
        out_p = rf.reinhard_apply_plain(x, *params)
        again = rf.reinhard_apply(x, *params)
        torch.cuda.synchronize()
        err = (out_k.float() - out_p.float()).abs().max().item()
        differ = (out_k != out_p).float().mean().item()
        print(f"B7a apply {label}: max|d| {err:.3g} (tolerance {tol:.4g}), "
              f"{differ:.6f} of the outputs differ from the plain version")
        require(out_k.dtype == x.dtype and out_k.shape == x.shape, f"{label}: dtype or shape")
        require(torch.isfinite(out_k.float()).all(), f"{label}: non-finite output")
        require(err <= tol, f"{label}: kernel and plain differ by {err}")
        require(torch.equal(again, out_k), f"{label}: two B7a runs differ")
        return err

    b7a_err = check_apply(f"{BATCH}x3x{SIZE}^2 u8", batch, stats_u8, 1.0)
    check_apply(f"8x3x{SIZE}^2 f32", batch_f32, stats_f32, 1.0 / 255.0)
    check_apply("2x3x71x73 u8 (ragged, scalar loads)", ragged, stats_ragged, 1.0)

    # The statistics B7b's finalize writes for the transform: bit for bit
    # their plain version, moments_to_mean_std, on the kernel's own sums.
    def check_mean_std(label, x):
        n_px = x.shape[0] * x.shape[2] * x.shape[3]
        mean_k, std_k = rf.reinhard_mean_std(x)
        mean_p, std_p = moments_to_mean_std(n_px, *rf.reinhard_moments(x))
        torch.cuda.synchronize()
        exact = torch.equal(mean_k, mean_p) and torch.equal(std_k, std_p)
        print(f"B7b finalize mean and std {label}: equal to moments_to_mean_std {exact}")
        require(exact, f"{label}: the finalize's mean and std differ from moments_to_mean_std")

    check_mean_std(f"{BATCH}x3x{SIZE}^2 u8", batch)
    check_mean_std(f"8x3x{SIZE}^2 f32", batch_f32)
    check_mean_std("2x3x71x73 u8 (ragged)", ragged)

    # The transform as the main path runs it (B7b, its finalize, B7a on the
    # statistics the finalize wrote) against the plain versions end to end:
    # plain moments, moments_to_mean_std, plain apply.
    def plain_transfer(x, reference_mean, reference_std):
        n_px = x.shape[0] * x.shape[2] * x.shape[3]
        stats = moments_to_mean_std(n_px, *rf.reinhard_moments_plain(x))
        return rf.reinhard_apply_plain(x, *stats, reference_mean, reference_std)

    def check_transfer(label, x, tol):
        out_k = reinhard_transform(x, ref_mean, ref_std)
        out_p = plain_transfer(x, ref_mean, ref_std)
        again = reinhard_transform(x, ref_mean, ref_std)
        torch.cuda.synchronize()
        err = (out_k.float() - out_p.float()).abs().max().item()
        differ = (out_k != out_p).float().mean().item()
        print(f"Reinhard transform (B7b, B7a) {label}: max|d| {err:.3g} from the plain versions "
              f"(tolerance {tol:.4g}), {differ:.6f} of the outputs differ")
        require(out_k.dtype == x.dtype and out_k.shape == x.shape, f"{label}: dtype or shape")
        require(err <= tol, f"{label}: the transform and its plain version differ by {err}")
        require(torch.equal(again, out_k), f"{label}: two transforms differ")

    check_transfer(f"{BATCH}x3x{SIZE}^2 u8", batch, 1.0)
    check_transfer(f"8x3x{SIZE}^2 f32", batch_f32, 1.0 / 255.0)
    check_transfer("2x3x71x73 u8 (ragged, scalar loads)", ragged, 1.0)

    # Every RGB triple once, 1x3x4096^2 uint8: the moments, and the apply
    # under the cube's own statistics (the identity transfer) and under the
    # main path's reference statistics.
    cube = dev_u8(colour_cube())
    _, stats_cube = check_moments("colour cube 1x3x4096^2 u8", cube)
    check_apply("colour cube, its own statistics (identity)", cube, stats_cube, 1.0, stats_cube)
    check_apply("colour cube, the reference's statistics", cube, stats_cube, 1.0)
    del cube

    # float32 values 64 ulps either side of the points where the colour
    # formulas branch (testing.BRANCH_POINTS), grey and mixed across channels.
    knee_field = torch.as_tensor(branch_point_field(64, 64, seed=args.seed + 11)).to(dev)
    _, stats_knee = check_moments(f"branch points 1x3x64x{knee_field.shape[3]} f32", knee_field)
    check_apply("branch points, their own statistics", knee_field, stats_knee, 1.0 / 255.0,
                stats_knee)
    check_apply("branch points, the reference's statistics", knee_field, stats_knee, 1.0 / 255.0)

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

    # The fit and the transform as one C call each: B8a, then its finalize
    # (the normalized reference histogram, or the LUT and its table built on
    # the card), then at transform B8b on that table. The finalize is held
    # bit for bit against its plain versions on the same counts
    # (normalized_histogram, hm_build_lut, lut_table), and the transform
    # against the plain steps: counts, hm_build_lut, the lookup.
    def check_hm_fit(label, vals):
        got = hk.hm_reference(vals)
        want = hk.normalized_histogram(hk.histogram_256_plain(vals))
        again = hk.hm_reference(vals)
        torch.cuda.synchronize()
        exact = torch.equal(got, want)
        print(f"HM fit (B8a, finalize) {label}: equal to the plain steps {exact}")
        require(exact, f"{label}: the fit's histogram differs from its plain version")
        require(torch.equal(again, got), f"{label}: two fits differ")
        return got

    def check_hm(label, vals, ref_hist, out_dtype):
        out, lut, table = hk.hm_transfer(vals, ref_hist, out_dtype)
        again = hk.hm_transfer(vals, ref_hist, out_dtype)[0]
        n_v, _c, p_v = vals.shape
        lut_p = hk.hm_build_lut(hk.histogram_256_plain(vals), ref_hist, float(n_v * p_v))
        table_p = hk.lut_table(lut_p, out_dtype)
        out_p = hk.apply_lut_plain(vals, lut_p, out_dtype)
        torch.cuda.synchronize()
        same = (torch.equal(lut, lut_p), torch.equal(table, table_p), torch.equal(out, out_p))
        print(f"HM transform (B8a, finalize, B8b) {label} -> {out_dtype}: LUT, table, output equal "
              f"to hm_build_lut, lut_table, the plain steps: {same}; pinned entries "
              f"{int((lut_p == 0).sum())} at 0, {int((lut_p == 255).sum())} at 255")
        require(all(same), f"{label}: the HM transform differs from its plain steps")
        require(torch.equal(again, out), f"{label}: two HM transforms differ")
        return out

    hm_ref = check_hm_fit(f"1x3x{SIZE}^2 (the main path's reference)", ref.reshape(1, 3, -1))
    check_hm_fit(f"{BATCH}x3x{SIZE}^2", values)
    check_hm(f"{BATCH}x3x{SIZE}^2 (the main batch)", values, hm_ref, torch.uint8)
    check_hm(f"{BATCH}x3x{SIZE}^2 (the main batch)", values, hm_ref, torch.float32)
    check_hm(f"{BATCH}x3x{SIZE}^2 matched to itself", values, check_hm_fit("the batch", values),
             torch.uint8)
    empty_ref = hm_ref.clone()
    empty_ref[1] = 0.0
    check_hm(f"{BATCH}x3x{SIZE}^2, an empty reference channel", values, empty_ref, torch.uint8)
    check_hm("1x3x100003 at a 3-byte offset (odd, unaligned P)", offset, hm_ref, torch.uint8)
    check_hm("2x3x(71*73) (ragged)", ragged.reshape(2, 3, -1), hm_ref, torch.float32)
    grey1 = values[:, 1:2]
    check_hm(f"{BATCH}x1x{SIZE}^2 (C = 1)", grey1.contiguous(), hm_ref[1:2], torch.uint8)
    twelve = torch.randint(0, 256, (4, 12, 5001), generator=gen, device=dev, dtype=torch.uint8)
    ref12 = check_hm_fit("4x12x5001 (C = 12)", twelve.flip(0).contiguous())
    check_hm("4x12x5001 (C = 12)", twelve, ref12, torch.uint8)
    check_hm("4x12x5001 (C = 12)", twelve, ref12, torch.float32)
    # An empty source channel cannot come from images; the finalize alone
    # takes the main batch's counts with one channel emptied.
    counts_e = hk.histogram_256_plain(values)
    counts_e[2] = 0.0
    for out_dtype in (torch.uint8, torch.float32):
        lut_e, table_e = hk.hm_lut(counts_e, hm_ref, BATCH * SIZE * SIZE, out_dtype)
        lut_ep = hk.hm_build_lut(counts_e, hm_ref, float(BATCH * SIZE * SIZE))
        torch.cuda.synchronize()
        same = torch.equal(lut_e, lut_ep) and torch.equal(table_e, hk.lut_table(lut_ep, out_dtype))
        print(f"HM finalize, an empty source channel -> {out_dtype}: LUT and table equal to "
              f"hm_build_lut and lut_table {same}")
        require(same, "the finalize differs from hm_build_lut on an empty source channel")

    # The streaming tier. B6, the exact selection, bit for bit.
    def select_case(rows, p, seed):
        """A field with duplicates, +inf sentinels, a rank past the count
        and, when there are several rows, an empty last row."""
        g = torch.Generator(device=dev).manual_seed(seed)
        x = torch.round(torch.randn(rows, p, generator=g, device=dev) * 64.0) / 64.0
        x = torch.where(x > 1.5, torch.inf, x)
        if rows > 1:
            x[-1] = torch.inf
        ranks = torch.randint(0, p, (rows, 2), generator=g, device=dev, dtype=torch.int32)
        ranks[0, 1] = p + 7
        valid = x < torch.inf
        return x, ranks, (x.amin(1), torch.where(valid, x, -torch.inf).amax(1), valid.sum(1))

    def check_select(label, x, ranks, init):
        s_k = ss.kth_smallest_streaming(x, ranks, init)
        s_p = ss.kth_smallest_streaming_plain(x, ranks, init)
        again = ss.kth_smallest_streaming(x, ranks, init)
        torch.cuda.synchronize()
        same = torch.equal(s_k.view(torch.int32), s_p.view(torch.int32))
        print(f"B6 select {label}: bit-exact {same}")
        require(same, f"{label}: B6 differs from its plain version")
        require(torch.equal(again.view(torch.int32), s_k.view(torch.int32)),
                f"{label}: two B6 runs differ")

    def select_inputs(rows, p, k, seed):
        """Two fields of randn values: K=2 angle-like (30 % sentinels, the
        alpha and 100-alpha ranks), K=1 concentration-like (no sentinel, the
        99th percentile); each with its exact init."""
        out = []
        for j in range(2):
            g = torch.Generator(device=dev).manual_seed(seed + j)
            x = torch.randn(rows, p, generator=g, device=dev)
            if k == 2:
                x = torch.where(torch.rand(rows, p, generator=g, device=dev) < 0.3, torch.inf, x)
                cnt = (x < torch.inf).sum(1)
                ranks = torch.stack([nearest_rank_index(mk.ALPHA, cnt),
                                     nearest_rank_index(100 - mk.ALPHA, cnt)], 1)
            else:
                cnt = torch.full((rows,), p, device=dev)
                ranks = torch.full((rows, 1), static_nearest_rank_index(99, p), device=dev)
            valid = x < torch.inf
            init = (x.amin(1), torch.where(valid, x, -torch.inf).amax(1), cnt)
            out.append((x, ranks.to(torch.int32), init))
        return out

    for rows, p in [(1, 1 << 24), (512, 224 * 224), (3, 1_000_003)]:
        x, ranks, init = select_case(rows, p, args.seed + rows)
        check_select(f"({rows}, {p}) K=2", x, ranks, None)
        check_select(f"({rows}, {p}) K=2 with init", x, ranks, init)
    # More ranks than one launch serves: two launches, 8 ranks and 2.
    many = torch.cat([ranks] * 5, dim=1) // torch.arange(1, 11, device=dev, dtype=torch.int32)
    check_select(f"({rows}, {p}) K=10 with init", x, many, init)
    # More rows than a grid's y extent (65 535): B6 folds its rows into x.
    x, ranks, init = select_case(65536, 64, args.seed + 64)
    check_select("(65536, 64) K=1", x, ranks[:, :1], None)
    check_select("(65536, 64) K=1 with init", x, ranks[:, :1], init)
    # Rows of 2^22 randn values as the select threshold gives B6: a block
    # stages more candidates than half its buffer and appends them to the
    # row's buffer more than once a pass.
    for rows, k in [(32, 1), (16, 2)]:
        x, ranks, init = select_inputs(rows, 1 << 22, k, args.seed + 600)[0]
        check_select(f"({rows}, 2^22) K={k} randn", x, ranks, None)
        check_select(f"({rows}, 2^22) K={k} randn with init", x, ranks, init)
    del x, init

    # B5, the multi-block fit, against B2's plain version, on the route the
    # wrapper takes and on the other where the rows fit a cluster.
    def routes(x, fit):
        n, _, h, w = x.shape
        rows, row_len = (1, n * h * w) if fit else (n, h * w)
        smem = kernels.device_limits(dev.index)[1]
        default = ms.route(row_len, x.dtype, smem)
        fits = ms.fits_cluster(row_len, x.element_size(), smem)
        return [default] + [r for r in ("cluster", "stream") if r != default and fits]

    def check_fit_stream(label, x):
        err = 0.0
        for force in routes(x, True):
            he5, mc5 = ms.macenko_fit_stream(x, force=force)
            he2, mc2 = mf.macenko_fit_mega_plain(x)
            again = ms.macenko_fit_stream(x, force=force)
            torch.cuda.synchronize()
            he_err = (he5 - he2).abs().max().item()
            rel = ((mc5 - mc2).abs() / mc2.abs()).max().item()
            print(f"B5 fit {label}, {force} route: HE max|d| {he_err:.3g} (atol 2e-5), maxC max "
                  f"rel {rel:.3g} (rtol 1e-4)")
            torch.testing.assert_close(he5, he2, atol=2e-5, rtol=0)
            torch.testing.assert_close(mc5, mc2, atol=0, rtol=1e-4)
            require(torch.equal(again[0], he5) and torch.equal(again[1], mc5),
                    f"{label}: two B5 runs differ")
            err = max(err, he_err, (mc5 - mc2).abs().max().item())
        return err

    def dev_f32(a):
        return dev_u8(a).float() / 255.0

    # Path (a): the README's batch-mode configuration (bench_batch_mode.py).
    A_BATCH, A_SIZE = 256, 224
    a_px = A_SIZE * A_SIZE
    pool_a = dev_f32(synthetic_he_batch(A_BATCH, A_SIZE, A_SIZE, seed=args.seed + 224))
    pool_a_b = dev_f32(synthetic_he_batch(A_BATCH, A_SIZE, A_SIZE, seed=args.seed + 225,
                                          he_scale=1.1))
    b5_err = check_fit_stream(f"{A_BATCH}x3x{A_SIZE}^2 f32 (path (a))", pool_a)
    # A pool of more than 65 535 images, through the public API: B5's
    # streamed route runs its images in launches of at most 65 535 (its
    # grid's y extent, which was the limit).
    many_imgs = dev_u8(synthetic_he_batch(65536, 16, 16, seed=args.seed + 16))
    before = profiling.counters("launch.")
    fitted_many = Macenko().fit(many_imgs)
    he_m, mc_m = fitted_many._stain_matrix, fitted_many._target_max_conc
    he_mp, mc_mp = ms.macenko_fit_stream_plain(many_imgs)
    torch.cuda.synchronize()
    b5_many = launch_counts([ms.macenko_fit_stream], before)["macenko_fit_stream"]
    print(f"B5 fit 65536x3x16^2 u8 via Macenko().fit ({b5_many} B5 "
          f"launch, route {ms.route(65536 * 256, torch.uint8, kernels.device_limits(dev.index)[1])}): "
          f"HE max|d| {(he_m - he_mp).abs().max().item():.3g} (atol 2e-5), maxC max rel "
          f"{((mc_m - mc_mp).abs() / mc_mp.abs()).max().item():.3g} (rtol 1e-4)")
    require(b5_many == 1, "the 65 536-image fit did not launch B5 once")
    torch.testing.assert_close(he_m, he_mp, atol=2e-5, rtol=0)
    torch.testing.assert_close(mc_m, mc_mp, atol=0, rtol=1e-4)
    del many_imgs
    check_fit_stream(f"{BATCH}x3x{SIZE}^2 u8", batch)
    check_fit_stream(f"1x3x{SIZE}^2 u8 (the reference)", ref)

    # B4, the multi-block transform, against B1's plain version, on both
    # routes where the rows fit a cluster.
    def check_b4(label, x):
        out, err = None, 0.0
        for force in routes(x, False):
            o, e = check_transform(f"{label}, {force} route", x, he_k, mc_k,
                                   lambda *a, f=force: ms.macenko_transform_stream(*a, force=f),
                                   "B4")
            out, err = (o, e) if out is None else (out, max(err, e))
        return out, err

    big4 = dev_u8(synthetic_he_batch(4, 2048, 2048, seed=args.seed + 2048))
    big4_b = dev_u8(synthetic_he_batch(4, 2048, 2048, seed=args.seed + 2049, he_scale=1.1))
    big1 = dev_u8(synthetic_he_batch(1, 4096, 4096, seed=args.seed + 4096))
    big1_b = dev_u8(synthetic_he_batch(1, 4096, 4096, seed=args.seed + 4097, he_scale=1.1))
    check_b4("4x3x2048^2 u8 (path (b))", big4)
    check_b4("1x3x4096^2 u8 (path (b))", big1)
    check_b4("1x3x2048^2 f32", big4[:1].float() / 255.0)
    check_b4("1x3x1999x2011 u8 (ragged, scalar loads)",
             dev_u8(synthetic_he_batch(1, 1999, 2011, seed=args.seed + 1999)))
    white_out, _ = check_b4("all-white 1x3x2048^2 (fallback)",
                            torch.full((1, 3, 2048, 2048), 255, dtype=torch.uint8, device=dev))
    flat = white_out.reshape(3, -1)
    require((flat.amax(1) == flat.amin(1)).all(), "B4: the white tile did not stay uniform")
    huge = dev_u8(synthetic_he_batch(1, 8192, 8192, seed=args.seed + 8192))
    check_b4("1x3x8192^2 u8", huge)
    del huge, white_out, flat
    _, b4_main_err = check_b4(f"{BATCH}x3x{SIZE}^2 u8 (the main path)", batch)
    check_b4(f"{A_BATCH}x3x{A_SIZE}^2 f32 (path (a)'s batch)", pool_a)
    torch.cuda.empty_cache()

    # B1 at the shape of the small-patch path (256x3x64^2 uint8), which the
    # ladder gives it, and at those of WSI tiles (256x3x224^2 uint8) and
    # path (a)'s float32 batch, which it gives B4. B2's checks follow.
    tiles_b = dev_u8(synthetic_he_batch(A_BATCH, A_SIZE, A_SIZE, seed=args.seed + 227,
                                        he_scale=1.1))
    patches = dev_u8(synthetic_he_batch(A_BATCH, P_SIZE, P_SIZE, seed=args.seed + 64))
    patches_b = dev_u8(synthetic_he_batch(A_BATCH, P_SIZE, P_SIZE, seed=args.seed + 65,
                                          he_scale=1.1))
    _, b1_err = check_transform(f"{A_BATCH}x3x{P_SIZE}^2 u8 (small patches)", patches_b, he_k, mc_k)

    # B1's resident body (the image in one 512-thread block's shared memory,
    # read once) on the cases its size rule and its fallback decide, each
    # within 1 grey level of the plain version and repeated bit for bit. Its
    # four selections are held bit for bit against kth_smallest on the keys
    # it selected on, which a check-only launch of the same kernel keeps.
    smem_optin = kernels.device_limits(dev.index)[1]

    def check_b1_selections(label, x):
        exact, (fewest, most), out_k = one_block_selections(x, he_k, mc_k, False)
        same_out = torch.equal(out_k, mf.macenko_transform_mega(x, he_k, mc_k))
        print(f"B1 resident selections {label}: angles and maxC equal to kth_smallest on the "
              f"kernel's keys {exact} ({fewest}-{most} of {x.shape[2] * x.shape[3]} pixels in the "
              f"angle selections); the checked launch's output equal to the wrapper's {same_out}")
        require(exact, f"{label}: B1's selections differ from kth_smallest on its keys")
        require(same_out, f"{label}: the checked launch and the wrapper's differ")

    def check_b1(label, x):
        p_x = x.shape[2] * x.shape[3]
        body = mf.transform_body(p_x, x.dtype, smem_optin)
        _, err = check_transform(f"{label}, {body} body", x, he_k, mc_k)
        if body == "resident":
            check_b1_selections(label, x)
        return body, err

    def largest_resident(dtype):
        return largest(lambda p: mf.transform_body(p, dtype, smem_optin) == "resident")

    check_b1(f"{A_BATCH}x3x{P_SIZE}^2 u8 (small patches)", patches_b)
    check_b1(f"{A_BATCH}x3x{P_SIZE}^2 f32 (4096-pixel float32 rows)", patches_b.float() / 255.0)
    for value in (255, 250):
        tile_u = torch.full((2, 3, P_SIZE, P_SIZE), value, dtype=torch.uint8, device=dev)
        out_u, _ = check_transform(f"uniform {value} 2x3x{P_SIZE}^2, resident body", tile_u,
                                   he_k, mc_k)
        check_b1_selections(f"uniform {value} 2x3x{P_SIZE}^2", tile_u)
        flat_u = out_u.reshape(2, 3, -1)
        require((flat_u.amax(-1) == flat_u.amin(-1)).all(),
                f"uniform {value}: the resident body's tile did not stay uniform per channel")
    # Light red planes (OD below beta) but for two pixels an image: fewer
    # than 3 survive the beta-mask, so the fallback takes every pixel.
    two_px = patches_b[:2].clone()
    two_px[:, 0] = torch.clamp(two_px[:, 0], min=215)
    two_px[:, :, 5, 7] = torch.tensor([120, 60, 150], dtype=torch.uint8, device=dev)[None, :]
    two_px[:, :, 40, 3] = torch.tensor([90, 70, 130], dtype=torch.uint8, device=dev)[None, :]
    check_b1(f"2x3x{P_SIZE}^2, two pixels past the beta-mask (the <3-pixel fallback)", two_px)
    check_b1(f"2x3x71x73 u8 (ragged, one pixel a thread)", ragged)
    for dtype_name, dtype in (("u8", torch.uint8), ("f32", torch.float32)):
        p_max = largest_resident(dtype)
        for p_x in (p_max, p_max + 1):
            x = dev_u8(synthetic_he_batch(3, 1, p_x, seed=args.seed + p_x))
            x = x if dtype == torch.uint8 else x.float() / 255.0
            body, _ = check_b1(f"3x3x1x{p_x} {dtype_name} (the largest resident rows and the "
                               f"next)", x)
            require(body == ("resident" if p_x == p_max else "l2"), f"{p_x}: body {body}")
    check_transform(f"{A_BATCH}x3x{A_SIZE}^2 u8 (WSI tiles)", tiles_b, he_k, mc_k)
    check_transform(f"{A_BATCH}x3x{A_SIZE}^2 f32 (path (a))", pool_a, he_k, mc_k)

    # B2 (the pool in one block's shared memory, read once) on the pools it
    # holds, each within HE atol 2e-5 and maxC rtol 1e-4 of the plain
    # version (NaN where the plain version gives NaN, as on a pool with no
    # pixel past the beta-mask) and repeated bit for bit. Its four
    # selections are held bit for bit against kth_smallest on the keys it
    # selected on, which a check-only launch of the same kernel keeps.
    # Larger pools are B5's: B2 refuses them.
    def bits(t):
        return t.contiguous().view(torch.int32)

    def check_fit_selections(label, x, he_x, mc_x):
        exact, (past, _), (he_s, mc_s) = one_block_selections(x, None, None, True)
        same_fit = torch.equal(bits(he_s), bits(he_x)) and torch.equal(bits(mc_s), bits(mc_x))
        print(f"B2 selections {label}: angles and maxC equal to kth_smallest on the "
              f"kernel's keys {exact} ({past} of {x.shape[0] * x.shape[2] * x.shape[3]} pixels in "
              f"the angle selections); the checked launch's fit equal to the wrapper's {same_fit}")
        require(exact, f"{label}: B2's selections differ from kth_smallest on its keys")
        require(same_fit, f"{label}: the checked launch and the wrapper's differ")

    def check_fit_mega(label, x):
        he_x, mc_x = mf.macenko_fit_mega(x)
        he_xp, mc_xp = mf.macenko_fit_mega_plain(x)
        he_2, mc_2 = mf.macenko_fit_mega(x)
        torch.cuda.synchronize()
        he_err = (he_x - he_xp).abs().nan_to_num(0.0).max().item()
        mc_err = (mc_x - mc_xp).abs().nan_to_num(0.0).max().item()
        rel = ((mc_x - mc_xp).abs() / mc_xp.abs()).nan_to_num(0.0).max().item()
        print(f"B2 fit {label}: HE max|d| {he_err:.3g} (atol 2e-5), maxC max rel "
              f"{rel:.3g} (rtol 1e-4); HE {he_x.flatten().tolist()[:2]}..., maxC {mc_x.tolist()}")
        torch.testing.assert_close(he_x, he_xp, atol=2e-5, rtol=0, equal_nan=True)
        torch.testing.assert_close(mc_x, mc_xp, atol=0, rtol=1e-4, equal_nan=True)
        require(torch.equal(bits(he_2), bits(he_x)) and torch.equal(bits(mc_2), bits(mc_x)),
                f"{label}: two B2 runs differ")
        check_fit_selections(label, x, he_x, mc_x)
        return max(he_err, mc_err)

    def largest_fit_pool(dtype):
        return largest(lambda p: mk.fit_route(p, dtype, smem_optin) == "mega")

    patch_f32 = patches_b[:1].float() / 255.0
    fit_err = check_fit_mega(f"1x3x{P_SIZE}^2 u8 (a small patch as reference)", patches_b[:1])
    check_fit_mega(f"1x3x{P_SIZE}^2 f32 (a small patch as reference)", patch_f32)
    check_fit_mega("1x3x71x73 u8 (ragged, one pixel a thread)", ragged[:1])
    check_fit_mega("1x3x71x73 f32 (ragged)", ragged[:1].float() / 255.0)
    # The second image of a batch, as batch_ref_index=1 hands it over: an
    # odd byte offset (byte copies) and, in float32, a 4-byte one.
    check_fit_mega("1x3x71x73 u8 at an odd byte offset", ragged[1:2])
    check_fit_mega("1x3x71x73 f32 at a 4-byte offset", (ragged.float() / 255.0)[1:2])
    check_fit_mega(f"4x3x{P_SIZE}^2 u8 (a pool of patches)", patches_b[:4])
    check_fit_mega("8x3x48^2 u8 (a pool of patches)",
                   dev_u8(synthetic_he_batch(8, 48, 48, seed=args.seed + 48)))
    check_fit_mega("3x3x71x73 u8 (a ragged pool, byte copies)",
                   dev_u8(synthetic_he_batch(3, 71, 73, seed=args.seed + 73)))
    # The largest pool B2 holds, and the next: the route sends it to B5,
    # and B2 refuses it rather than fall back.
    for dtype_name, dtype in (("u8", torch.uint8), ("f32", torch.float32)):
        p_max = largest_fit_pool(dtype)
        xs = [dev_u8(synthetic_he_batch(1, 1, p_x, seed=args.seed + p_x))
              for p_x in (p_max, p_max + 1)]
        xs = xs if dtype == torch.uint8 else [x.float() / 255.0 for x in xs]
        check_fit_mega(f"1x3x1x{p_max} {dtype_name} (the largest pool B2 holds)", xs[0])
        route = mk.fit_route(p_max + 1, dtype, smem_optin)
        require(route == "stream", f"fit of {p_max + 1} pixels: route {route}")
        check_fit_stream(f"1x3x1x{p_max + 1} {dtype_name} (the first pool past B2)", xs[1])
        try:
            mf.macenko_fit_mega(xs[1])
            refused = ""
        except ValueError as e:
            refused = str(e)
        print(f"B2 on 1x3x1x{p_max + 1} {dtype_name}: refused ({refused})")
        require("shared memory" in refused, f"B2 took a pool of {p_max + 1} pixels")
    for value in (100, 250):
        uniform_pool = torch.full((2, 3, P_SIZE, P_SIZE), value, dtype=torch.uint8, device=dev)
        check_fit_mega(f"uniform {value} 2x3x{P_SIZE}^2 u8"
                       + (" (no pixel past the beta-mask)" if value == 250 else ""), uniform_pool)
    check_fit_mega(f"white 1x3x{P_SIZE}^2 f32 (no pixel past the beta-mask)",
                   torch.ones_like(patch_f32))

    # The selections fused into B4 and B5, bit for bit: a call's selected
    # pseudo-angles and maxC (its RowParams) against B6's plain version on
    # the keys that call selected on, which a check-only entry of the kernel
    # source writes with the kernels' own device functions; the call run
    # again must give the same bits.
    def check_fused(label, x, fit, force):
        r = fused_selections(x, he_k, mc_k, fit, force)
        print(f"fused selections of {'B5' if fit else 'B4'} {label}, {force} route: angles "
              f"{r['angles']} and concentrations {r['conc']}: phi bit-exact {r['phi']}, maxC "
              f"bit-exact {r['maxc']}")
        require(r["phi"] and r["maxc"],
                f"{label}: a fused selection differs from B6's plain version")
        require(r["repeat"], f"{label}: two runs' statistics differ")

    for label, x, fit in [
        (f"1x3x{SIZE}^2 u8 (the main path's reference)", ref, True),
        (f"{BATCH}x3x{SIZE}^2 u8 (the main path)", batch, False),
        (f"{A_BATCH}x3x{A_SIZE}^2 f32 (path (a)'s pool)", pool_a, True),
        (f"{A_BATCH}x3x{A_SIZE}^2 f32 (path (a)'s batch)", pool_a, False),
        ("4x3x2048^2 u8 (path (b))", big4, False),
        ("1x3x2048^2 f32", big4[:1].float() / 255.0, False),
        (f"{A_BATCH}x3x{A_SIZE}^2 u8 (WSI tiles)", dev_u8(synthetic_he_batch(
            A_BATCH, A_SIZE, A_SIZE, seed=args.seed + 226)), False),
    ]:
        for force in routes(x, fit):
            check_fused(label, x, fit, force)
    torch.cuda.empty_cache()
    od_once_checks(dev, args.seed, per_pass)
    torch.cuda.empty_cache()
    fold_checks()
    fused_fit_checks()
    resident_checks()

    # B3, the exact row select, bit for bit against its plain version.
    def check_b3(label, x, ranks, cluster=None):
        s_k = sel._select(x, ranks, cluster)
        s_p = sel.kth_smallest_pallas_plain(x, ranks)
        again = sel._select(x, ranks, cluster)
        torch.cuda.synchronize()
        same = torch.equal(s_k.view(torch.int32), s_p.view(torch.int32))
        taken = "the wrapper's cluster" if cluster is None else f"clusters of {cluster}"
        print(f"B3 select {label}, {taken}: bit-exact {same}")
        require(same, f"{label}: B3 differs from its plain version")
        require(torch.equal(again.view(torch.int32), s_k.view(torch.int32)),
                f"{label}: two B3 runs differ")
        return s_k

    smem = kernels.device_limits(dev.index)[1]
    print(f"B3 keeps up to {sel.resident_budget(1, smem)} keys of its slice a block in shared "
          f"memory at K=1, {sel.resident_budget(2, smem)} at K=2")
    px = SIZE * SIZE
    for rows, p, k in [(1, px, 2), (2, px, 1), (64, px, 2), (2 * BATCH, px, 1), (A_BATCH, a_px, 2),
                       (2 * A_BATCH, a_px, 1), (3, 1_000_003, 2), (5, 50_001, 1)]:
        x, ranks, _ = select_case(rows, p, args.seed + 11 * rows + k)
        check_b3(f"({rows}, {p}) K={k}", x, ranks[:, 2 - k:])
    many = torch.cat([ranks] * 5, dim=1) // torch.arange(1, 11, device=dev, dtype=torch.int32)
    check_b3(f"({rows}, {p}) K=10 (two launches)", x, many)

    def crowded_case(rows, p, seed):
        """An angle-like field: values in [-1.63, -1.34] rad, 30 % sentinels,
        the alpha and 100-alpha ranks: one top key byte, few second bytes."""
        g = torch.Generator(device=dev).manual_seed(seed)
        x = torch.empty(rows, p, device=dev).uniform_(-1.63, -1.34, generator=g)
        x = torch.where(torch.rand(rows, p, generator=g, device=dev) < 0.3, torch.inf, x)
        cnt = (x < torch.inf).sum(1)
        ranks = torch.stack([nearest_rank_index(mk.ALPHA, cnt),
                             nearest_rank_index(100 - mk.ALPHA, cnt)], 1).to(torch.int32)
        return x, ranks

    crowd, crowd_r = crowded_case(64, px, args.seed + 31)
    keys = sel.monotone_key(crowd[crowd < torch.inf])
    print(f"crowded field: {len(torch.unique(keys >> 24))} distinct top key bytes, "
          f"{len(torch.unique(keys >> 16))} distinct 16-bit prefixes")
    check_b3(f"crowded (64, {px}) K=2", crowd, crowd_r)
    equal = torch.full((3, 70_001), 0.375, device=dev)
    equal[0, ::7] = torch.inf
    equal[1] = torch.inf
    equal_r = torch.tensor([[0, 70_000], [0, 3], [5, 70_000]], device=dev, dtype=torch.int32)
    check_b3("min equal to max, and a row of only +inf (3, 70 001)", equal, equal_r)
    x, ranks, _ = select_case(3, 1_000_003, args.seed + 3)
    for c in sel.CLUSTER_SIZES:  # every cluster size the wrapper can pick
        check_b3(f"crowded (2, {px}) K=2", crowd[:2], crowd_r[:2], c)
        check_b3("(3, 1 000 003) K=2, ragged", x, ranks, c)
        check_b3("min equal to max, and a row of only +inf", equal, equal_r, c)
    del x, crowd, keys
    inf = float("inf")
    edge = check_b3("[3, 1, inf, -0, 0, 2] and an all-+inf row",
                    torch.tensor([[3.0, 1.0, inf, -0.0, 0.0, 2.0], [inf] * 6], device=dev),
                    torch.tensor([[0, 5, 1, 2], [0, 1, 2, 3]], device=dev, dtype=torch.int32))
    require(bool(torch.signbit(edge[0, 0])) and edge[0, 0] == 0 and edge[0, 1] == 3
            and edge[0, 3] == 1 and bool(torch.isinf(edge[1]).all()),
            f"B3 conventions: -0.0 first, a rank past the count the largest, +inf rows: {edge}")

    # B3 and B6 on every field the staged paths feed them, recorded as the
    # calls make them.
    def field_init(x):
        """B6's optional (min, max, count) init of a field, exact."""
        valid = x < torch.inf
        return x.amin(1), torch.where(valid, x, -torch.inf).amax(1), valid.sum(1)

    def record_selects(call):
        """Run ``call`` with the staged route's selection recorded; returns
        its result and, per selection in order, (kernel, field, ranks,
        output)."""
        select, seen = mk._select, []  # the staged route's name for pct._select

        def record(x, ranks):
            out = select(x, ranks)
            seen.append(("B6" if pct.select_route(*x.shape) == "stream" else "B3", x, ranks, out))
            return out

        mk._select = record
        try:
            result = call()
        finally:
            mk._select = select
        return result, seen

    def check_staged_fields(label, call, want):
        _, seen = record_selects(call)
        kinds = [name for name, *_ in seen]
        require(kinds == want, f"{label}: selections {kinds}, the path makes {want}")
        for name, x, ranks, out in seen:
            if name == "B3":
                plain = sel.kth_smallest_pallas_plain(x, ranks)
                again = sel.kth_smallest_pallas(x, ranks)
            else:  # as the route calls it (no init), and again with an exact init
                plain = ss.kth_smallest_streaming_plain(x, ranks)
                again = ss.kth_smallest_streaming(x, ranks)
                with_init = ss.kth_smallest_streaming(x, ranks, field_init(x))
                require(torch.equal(with_init.view(torch.int32), out.view(torch.int32)),
                        f"{label}: B6 with an init differs on the path's field")
            torch.cuda.synchronize()
            same = torch.equal(out.view(torch.int32), plain.view(torch.int32))
            print(f"{name} on {label}: field {tuple(x.shape)} K={ranks.shape[1]}: bit-exact {same}"
                  f"{' (also with an init)' if name == 'B6' else ''}")
            require(same, f"{label}: {name} differs from its plain version on the path's field")
            require(torch.equal(again.view(torch.int32), out.view(torch.int32)),
                    f"{label}: two {name} runs differ on the path's field")

    def low(x, dtype):
        """A uint8 batch as float [0, 1] in ``dtype``."""
        return (x.float() / 255.0).to(dtype)

    bf16, f16 = torch.bfloat16, torch.float16
    ref_bf, batch_bf, batch_bf_b = low(ref, bf16), low(batch, bf16), low(batch_b, bf16)
    pool_h, pool_h_b = pool_a.to(f16), pool_a_b.to(f16)
    check_staged_fields(f"path (c)'s fit and transform, {BATCH}x3x{SIZE}^2 bf16",
                        lambda: Macenko().fit(ref_bf).transform(batch_bf), PATH_C_SELECTS)
    check_staged_fields(f"path (d)'s forward, {A_BATCH}x3x{A_SIZE}^2 f16",
                        lambda: StainNormalizerTransform("macenko", mode="batch",
                                                         batch_ref_index=None)(pool_h),
                        PATH_D_SELECTS)
    torch.cuda.empty_cache()

    # 4. The paths through the public API. Each Macenko path must launch
    # exactly the kernels written beside it: B2 or B5 and B1 or B4 (the H100
    # ladder of stainx_tpu_torch/ops/macenko.py), B4 and B5 with no B6
    # launch (they select inside their own kernels); the staged route B3 and
    # B6 directly (its select threshold).
    macenko_wrappers = [mf.macenko_fit_mega, mf.macenko_transform_mega, ms.macenko_fit_stream,
                        ms.macenko_transform_stream, ss.kth_smallest_streaming,
                        sel.kth_smallest_pallas]

    def launches(b2=0, b1=0, b5=0, b4=0, b3=0, b6=0):
        return {"macenko_fit_mega": b2, "macenko_transform_mega": b1, "macenko_fit_stream": b5,
                "macenko_transform_stream": b4, "kth_smallest_streaming": b6,
                "kth_smallest_pallas": b3}

    def drive_macenko(label, path, want):
        before = profiling.counters("launch.")
        result = path()
        torch.cuda.synchronize()
        counts = launch_counts(macenko_wrappers, before)
        print(f"{label} launches: {counts}")
        require(counts == want, f"{label}: launches {counts}, the path must launch {want}")
        return result, counts

    normalizer = Macenko()
    out, main_launches = drive_macenko(f"main path, Macenko {BATCH}x3x{SIZE}^2 u8",
                           lambda: normalizer.fit(ref).transform(batch),
                                       launches(b5=1, b4=1))  # B6: 0
    require(out.is_cuda and out.dtype == torch.uint8 and out.shape == batch.shape,
            "main path output is not a uint8 batch of the input shape on the card")
    ref_np, sub = ref.cpu().numpy(), batch[:8].cpu().numpy()
    he_o, mc_o = oracle.macenko_fit(ref_np)
    expect = oracle.macenko_transform(sub, he_o, mc_o).astype(np.float32)
    mae = float(np.abs(out[:8].cpu().numpy().astype(np.float32) - expect).mean())
    print(f"oracle MAE on 8 images: {mae:.4f} (gate 0.35)")
    require(mae <= 0.35, f"oracle MAE {mae} above 0.35")

    def drive(label, wrappers, path):
        before = profiling.counters("launch.")
        result = path()
        torch.cuda.synchronize()
        counts = launch_counts(wrappers, before)
        print(f"{label} path launches: {counts}")
        require(all(n > 0 for n in counts.values()), f"a kernel of the {label} path never launched")
        require(result.is_cuda and result.dtype == torch.uint8 and result.shape == batch.shape,
                f"{label} output is not a uint8 batch of the input shape on the card")
        return result, counts

    reinhard = Reinhard()
    r_out, r_launches = drive("Reinhard", [rf.reinhard_moments, rf.reinhard_apply],
                              lambda: reinhard.fit(ref).transform(batch))
    r_plain = plain_transfer(batch, reinhard._reference_mean, reinhard._reference_std)
    r_err = (r_out.float() - r_plain.float()).abs().max().item()
    print(f"Reinhard main path vs the plain versions (the fitted statistics): max|d| {r_err:.3g} "
          f"grey levels (tolerance 1)")
    require(r_err <= 1.0, f"the Reinhard main path is {r_err} grey levels from its plain version")
    # The transform's device work is B7b (and its finalize, which writes the
    # mean and std), then B7a: no other kernel between them. Its output
    # repeats the main path's bit for bit.
    r_again, steps = device_steps(lambda: reinhard.transform(batch),
                                  ("moments_kernel", "moments_finalize", "apply_kernel"))
    require(torch.equal(r_again, r_out), "two Reinhard transforms of the main path differ")
    print(f"Reinhard transform, device work in order: {steps}")
    require(steps == ["moments_kernel", "moments_finalize", "apply_kernel"],
            f"the Reinhard transform ran {steps} on the device, not B7b then B7a alone")
    hist_match = HistogramMatching()
    hm_out, h_launches = drive("HistogramMatching", [hk.histogram_256, hk.apply_lut],
                               lambda: hist_match.fit(ref).transform(batch))
    # The transform as the plain steps give it on the fitted histograms, bit
    # for bit; its device work is B8a, the finalize that builds the LUT and
    # its table, then B8b: no other kernel between them, one C call.
    hm_plain = hk.hm_transfer_plain(batch.reshape(BATCH, 3, -1), hist_match._ref_histograms_256,
                                    torch.uint8)[0].reshape(batch.shape)
    require(torch.equal(hm_out, hm_plain), "the HM main path differs from its plain steps")
    hm_again, hm_steps = device_steps(lambda: hist_match.transform(batch),
                                      ("hist_kernel", "hist_finalize", "apply_kernel"))
    require(torch.equal(hm_again, hm_out), "two HM transforms of the main path differ")
    print(f"HistogramMatching transform, device work in order: {hm_steps}; equal to the plain "
          f"steps and to a second transform")
    require(hm_steps == ["hist_kernel", "hist_finalize", "apply_kernel"],
            f"the HM transform ran {hm_steps} on the device, not B8a, its finalize, B8b alone")
    stats_span_checks(dev)

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

    # Path (a): the batch-mode training transform, a fit of the whole pooled
    # batch every forward, on float32 in [0, 1] (output in [0, 1]).
    def mae_255(got01, expect255):
        return float(np.abs(got01.cpu().numpy() * 255.0 - expect255).mean())

    pool_np = pool_a.cpu().numpy()
    transform_a = StainNormalizerTransform("macenko", mode="batch", batch_ref_index=None)
    out_a, a_launches = drive_macenko(
        f"path (a), batch mode {A_BATCH}x3x{A_SIZE}^2 f32", lambda: transform_a(pool_a),
        launches(b5=1, b4=1))  # B6: 0
    require(out_a.is_cuda and out_a.dtype == torch.float32 and out_a.shape == pool_a.shape,
            "path (a) output is not a float32 batch of the input shape on the card")
    require(bool(torch.isfinite(out_a).all()) and 0.0 <= out_a.min() and out_a.max() <= 1.0,
            "path (a) output is not finite in [0, 1]")
    he_a, mc_a = oracle.macenko_fit(pool_np)
    mae_a = mae_255(out_a[:8], oracle.macenko_transform(pool_np[:8], he_a, mc_a))
    print(f"path (a) oracle MAE on 8 images (oracle fitted on the same {A_BATCH}-image pool): "
          f"{mae_a:.4f} (gate 0.35)")
    require(mae_a <= 0.35, f"path (a): oracle MAE {mae_a} above 0.35")

    transform_a0 = StainNormalizerTransform("macenko", mode="batch", batch_ref_index=0)
    out_a0, _ = drive_macenko(
        "path (a), batch_ref_index=0", lambda: transform_a0(pool_a), launches(b5=1, b4=1))  # B6: 0
    he_a0, mc_a0 = oracle.macenko_fit(pool_np[:1])
    mae_a0 = mae_255(out_a0[:8], oracle.macenko_transform(pool_np[:8], he_a0, mc_a0))
    print(f"path (a), batch_ref_index=0: oracle MAE on 8 images {mae_a0:.4f} (gate 0.35)")
    require(mae_a0 <= 0.35, f"path (a), batch_ref_index=0: oracle MAE {mae_a0} above 0.35")

    for method, wrappers in [("reinhard", [rf.reinhard_moments, rf.reinhard_apply]),
                             ("histogram_matching", [hk.histogram_256, hk.apply_lut])]:
        before = profiling.counters("launch.")
        res = StainNormalizerTransform(method, mode="batch", batch_ref_index=None)(pool_a)
        torch.cuda.synchronize()
        counts = launch_counts(wrappers, before)
        print(f"{method} batch mode {A_BATCH}x3x{A_SIZE}^2 f32 launches: {counts}")
        require(all(n > 0 for n in counts.values()), f"a kernel of {method} batch mode never launched")
        require(res.shape == pool_a.shape and bool(torch.isfinite(res).all()),
                f"{method} batch mode output")

    # WSI tiles: 256x3x224^2 uint8 tiles normalized to a 224^2 reference tile.
    tiles_np = synthetic_he_batch(A_BATCH, A_SIZE, A_SIZE, seed=args.seed + 226)
    tiles, tile_ref = dev_u8(tiles_np), dev_u8(tiles_np[:1])
    norm_t = Macenko()
    out_t, _ = drive_macenko(
        f"WSI tiles, Macenko {A_BATCH}x3x{A_SIZE}^2 u8 with a {A_SIZE}^2 reference",
        lambda: norm_t.fit(tile_ref).transform(tiles), launches(b5=1, b4=1))  # B6: 0
    require(out_t.is_cuda and out_t.dtype == torch.uint8 and out_t.shape == tiles.shape,
            "WSI tiles: output is not a uint8 batch of the input shape on the card")
    he_t, mc_t = oracle.macenko_fit(tiles_np[:1])
    expect_t = oracle.macenko_transform(tiles_np[:8], he_t, mc_t).astype(np.float32)
    mae_t = float(np.abs(out_t[:8].cpu().numpy().astype(np.float32) - expect_t).mean())
    print(f"WSI tiles: oracle MAE on 8 tiles {mae_t:.4f} (gate 0.35)")
    require(mae_t <= 0.35, f"WSI tiles: oracle MAE {mae_t} above 0.35")

    # Small patches: 256x3x64^2 uint8 patches normalized to a 64^2 reference
    # patch, the sizes the ladder leaves to the one-block kernels.
    patches_np = patches.cpu().numpy()
    norm_p = Macenko()
    out_p, p_launches = drive_macenko(
        f"small patches, Macenko {A_BATCH}x3x{P_SIZE}^2 u8 with a {P_SIZE}^2 reference",
        lambda: norm_p.fit(patches[:1]).transform(patches), launches(b2=1, b1=1))  # B6: 0
    require(out_p.is_cuda and out_p.dtype == torch.uint8 and out_p.shape == patches.shape,
            "small patches: output is not a uint8 batch of the input shape on the card")
    he_pt, mc_pt = oracle.macenko_fit(patches_np[:1])
    expect_p = oracle.macenko_transform(patches_np[:8], he_pt, mc_pt).astype(np.float32)
    mae_p = float(np.abs(out_p[:8].cpu().numpy().astype(np.float32) - expect_p).mean())
    print(f"small patches: oracle MAE on 8 patches {mae_p:.4f} (gate 0.35)")
    require(mae_p <= 0.35, f"small patches: oracle MAE {mae_p} above 0.35")

    # Small-patch batch mode: the training transform with its default
    # batch_ref_index=0 re-fits on the first patch every forward (B2, the
    # resident body) and transforms the batch (B1); output float32 in [0, 1].
    patch_batch = {"u8": patches, "f32": patches.float() / 255.0}
    transform_s = {}
    for dtype_name, x in patch_batch.items():
        transform_s[dtype_name] = StainNormalizerTransform("macenko", mode="batch")
        out_s, _ = drive_macenko(
            f"small-patch batch mode, {A_BATCH}x3x{P_SIZE}^2 {dtype_name}, batch_ref_index=0",
            lambda t=transform_s[dtype_name], x=x: t(x), launches(b2=1, b1=1))  # B6: 0
        require(out_s.is_cuda and out_s.dtype == torch.float32 and out_s.shape == x.shape,
                f"small-patch batch mode {dtype_name}: output is not a float32 batch of the "
                f"input shape on the card")
        require(bool(torch.isfinite(out_s).all()) and 0.0 <= out_s.min() and out_s.max() <= 1.0,
                f"small-patch batch mode {dtype_name}: output is not finite in [0, 1]")
        x_np = x.cpu().numpy()
        he_s, mc_s = oracle.macenko_fit(x_np[:1])
        mae_s = mae_255(out_s[:8], oracle.macenko_transform(x_np[:8], he_s, mc_s))
        print(f"small-patch batch mode {dtype_name}: oracle MAE on 8 patches (oracle fitted on the "
              f"first) {mae_s:.4f} (gate 0.35)")
        require(mae_s <= 0.35, f"small-patch batch mode {dtype_name}: oracle MAE {mae_s} above 0.35")
    del out_s

    # Path (b): whole-slide regions, a 512^2 reference fit then large rows.
    b_normalizers = {}
    b_launches = {}
    for label, x in [("4x3x2048^2", big4), ("1x3x4096^2", big1)]:
        norm_b = Macenko()
        out_b, b_launches[label] = drive_macenko(
            f"path (b), Macenko {label} u8", lambda: norm_b.fit(ref).transform(x),
            launches(b5=1, b4=1))  # B6: 0
        require(out_b.is_cuda and out_b.dtype == torch.uint8 and out_b.shape == x.shape,
                f"path (b) {label}: output is not a uint8 batch of the input shape on the card")
        expect_b = oracle.macenko_transform(x[:1].cpu().numpy(), he_o, mc_o).astype(np.float32)
        mae_b = float(np.abs(out_b[:1].cpu().numpy().astype(np.float32) - expect_b).mean())
        print(f"path (b) {label}: oracle MAE on 1 image {mae_b:.4f} (gate 0.35)")
        require(mae_b <= 0.35, f"path (b) {label}: oracle MAE {mae_b} above 0.35")
        b_normalizers[label] = norm_b
    del out_a0, out_b

    # Path (c): the staged route (bfloat16 and float16 input) on the main
    # path's configuration. The oracle runs on the float32 values of the
    # same low-precision input, fit and transform; outputs are float [0, 255].
    def oracle_mae(out, ref_x, batch_x, n=8):
        he_x, mc_x = oracle.macenko_fit(ref_x.float().cpu().numpy())
        expect_x = oracle.macenko_transform(batch_x[:n].float().cpu().numpy(), he_x, mc_x)
        return float(np.abs(out[:n].float().cpu().numpy() - expect_x).mean())

    c_normalizers, c_launches = {}, {}
    ref_h, batch_h = low(ref, f16), low(batch, f16)
    c_want = launches(b3=PATH_C_SELECTS.count("B3"), b6=PATH_C_SELECTS.count("B6"))
    for label, dtype, precision, ref_x, batch_x in [
        ("bf16 stable", bf16, "stable", ref_bf, batch_bf),
        ("bf16 fast", bf16, "fast", ref_bf, batch_bf),
        ("f16 stable", f16, "stable", ref_h, batch_h),
    ]:
        norm_c = Macenko(precision=precision)
        out_c, c_launches[label] = drive_macenko(
            f"path (c), Macenko(precision={precision!r}) {BATCH}x3x{SIZE}^2 {label.split()[0]}",
            lambda: norm_c.fit(ref_x).transform(batch_x), c_want)
        require(out_c.is_cuda and out_c.dtype == dtype and out_c.shape == batch.shape,
                f"path (c) {label}: output is not a {dtype} batch of the input shape on the card")
        require(bool(torch.isfinite(out_c).all()), f"path (c) {label}: non-finite output")
        mae_c = oracle_mae(out_c, ref_x, batch_x)
        print(f"path (c) {label}: oracle MAE on 8 images {mae_c:.4f} (gate 0.35)")
        require(mae_c <= 0.35, f"path (c) {label}: oracle MAE {mae_c} above 0.35")
        c_normalizers[label] = norm_c
    fast_moved = (c_normalizers["bf16 fast"].transform(batch_bf).float()
                  != c_normalizers["bf16 stable"].transform(batch_bf).float()).float().mean().item()
    print(f"path (c): bfloat16 reconstruction under 'fast' moves {fast_moved:.3f} of the outputs")
    require(fast_moved > 0.05, "path (c): 'fast' did not reconstruct in bfloat16")
    del out_c

    # Path (d): the batch-mode training transform on float16, the pool fit
    # every forward (output float16 in [0, 1]).
    transform_d = StainNormalizerTransform("macenko", mode="batch", batch_ref_index=None)
    out_d, d_launches = drive_macenko(
        f"path (d), batch mode {A_BATCH}x3x{A_SIZE}^2 f16", lambda: transform_d(pool_h),
        launches(b3=PATH_D_SELECTS.count("B3"), b6=PATH_D_SELECTS.count("B6")))
    require(out_d.is_cuda and out_d.dtype == f16 and out_d.shape == pool_h.shape,
            "path (d) output is not a float16 batch of the input shape on the card")
    require(bool(torch.isfinite(out_d).all()) and 0.0 <= out_d.min() and out_d.max() <= 1.0,
            "path (d) output is not finite in [0, 1]")
    mae_d = oracle_mae(out_d.float() * 255.0, pool_h, pool_h)
    print(f"path (d) oracle MAE on 8 images (oracle fitted on the same {A_BATCH}-image pool): "
          f"{mae_d:.4f} (gate 0.35)")
    require(mae_d <= 0.35, f"path (d): oracle MAE {mae_d} above 0.35")
    del out_d

    # 4b. The distributed layer, in a process of its own.
    sys.stdout.flush()
    import torch.multiprocessing as mp

    mesh_proc = mp.get_context("spawn").Process(target=mesh_phase, args=(args.seed,))
    mesh_proc.start()
    mesh_proc.join(timeout=900)
    if mesh_proc.is_alive():
        mesh_proc.kill()
        mesh_proc.join()
    require(mesh_proc.exitcode == 0, f"the mesh phase failed (exit code {mesh_proc.exitcode})")

    # 4c. The tile-ingest path, from files on disk to the card.
    all_wrappers = [mf.macenko_fit_mega, mf.macenko_transform_mega, ms.macenko_fit_stream,
                    ms.macenko_transform_stream, ss.kth_smallest_streaming,
                    sel.kth_smallest_pallas, rf.reinhard_moments, rf.reinhard_apply,
                    hk.histogram_256, hk.apply_lut]
    t0 = time.perf_counter()
    ingest_phase(args.seed, dev, ref, batch, normalizer, all_wrappers, tilepipe_jax_so)
    print(f"phase 4c: {time.perf_counter() - t0:.1f} s")

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
        prof = profiled_ms(fn, inputs, 5)
        prof_txt = "not measured" if prof is None else f"{prof:.4f} ms (idle {1.0 - prof / eager:.3f})"
        print(f"public API {label}: {eager:.4f} ms/batch ({BATCH * SIZE * SIZE / eager / 1e3:.1f} "
              f"MPix/s), device busy {busy:.4f} ms, idle share {1.0 - busy / eager:.3f}; "
              f"kernel time in torch.profiler {prof_txt}")
        return eager

    pair = [batch, batch_b]
    kernel_ms(f"B1 macenko_transform_mega {BATCH}x3x{SIZE}^2 u8",
              lambda x: mf.macenko_transform_mega(x, he_k, mc_k), pair)
    print(f"B1 plain {BATCH}x3x{SIZE}^2 u8: "
          f"{event_ms(lambda x: mf.macenko_transform_mega_plain(x, he_k, mc_k), pair, 3):.4f} ms")
    api_ms("Macenko transform", normalizer.transform, pair)
    print(f"public API Macenko fit 1x3x{SIZE}^2: "
          f"{event_ms(lambda x: Macenko().fit(x), [ref, ref_b], 20):.4f} ms")

    values_b = batch_b.reshape(BATCH, 3, -1)
    params = (*stats_u8, ref_mean, ref_std)
    ms_b7b = kernel_ms("B7b reinhard_moments", rf.reinhard_moments, pair)
    ms_b7b_p = event_ms(rf.reinhard_moments_plain, pair, 3)
    ms_b7a = kernel_ms("B7a reinhard_apply", lambda x: rf.reinhard_apply(x, *params), pair)
    ms_b7a_p = event_ms(lambda x: rf.reinhard_apply_plain(x, *params), pair, 3)
    pair_f = [batch.float() / 255.0, batch_b.float() / 255.0]
    ms_b7b_f = kernel_ms(f"B7b reinhard_moments {BATCH}x3x{SIZE}^2 f32", rf.reinhard_moments, pair_f)
    ms_b7a_f = kernel_ms(f"B7a reinhard_apply {BATCH}x3x{SIZE}^2 f32",
                         lambda x: rf.reinhard_apply(x, *params), pair_f)
    del pair_f
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
    # The finalize alone (the LUT and its uint8 table from the main batch's
    # int32 counts), and each kernel of the HM transform's one C call as
    # torch.profiler records it on the device.
    counts_i = [hk.histogram_256_plain(v).to(torch.int32) for v in (values, values_b)]
    ms_fin = kernel_ms("HM finalize (LUT and table from counts)",
                       lambda c: hk.hm_lut(c, hm_ref, BATCH * SIZE * SIZE, torch.uint8), counts_i)
    ms_fin_p = event_ms(
        lambda c: hk.lut_table(hk.hm_build_lut(c, hm_ref, float(BATCH * SIZE * SIZE)), torch.uint8),
        counts_i, 5)
    # The finalize alone reads the (3, 256) int32 counts and float32
    # reference and writes the float32 LUT and the uint8 table; its float32
    # work is about 30 operations a bin (two divisions, the sums and scans,
    # 8 search compares, the interpolation, the pins and the clamps).
    fin_bound, fin_by = bound_ms(3 * 256 * (4 + 4 + 4 + 1), 3 * 256 * 30)
    print(f"HM finalize plain (hm_build_lut, lut_table): {ms_fin_p:.4f} ms; the finalize's bound "
          f"{fin_bound:.6f} ms by {fin_by}")
    from torch.profiler import ProfilerActivity, profile

    for label, call in [("transform", hist_match.transform), ("fit", HistogramMatching().fit)]:
        for x in pair:
            call(x)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for i in range(10):
                call(pair[i % 2])
            torch.cuda.synchronize()
        per = {e.key: e.self_device_time_total / 10 / 1e3 for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA}
        print(f"HM {label} {BATCH}x3x{SIZE}^2 u8, device time a call by kernel (torch.profiler): "
              + "; ".join(f"{k.split('(')[0]} {v:.4f} ms" for k, v in sorted(per.items())))

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

    # The streaming tier, B1 and B2 at the shapes their paths give them.
    pair_a, pair_t = [pool_a, pool_a_b], [tiles, tiles_b]
    pair_p = [patches, patches_b]
    ms_b1 = kernel_ms(f"B1 macenko_transform_mega {A_BATCH}x3x{P_SIZE}^2 u8 (small patches)",
                      lambda x: mf.macenko_transform_mega(x, he_k, mc_k), pair_p)
    ms_b1_p = event_ms(lambda x: mf.macenko_transform_mega_plain(x, he_k, mc_k), pair_p, 3)
    ms_f = kernel_ms(f"B2 macenko_fit_mega 1x3x{P_SIZE}^2 u8 (a small patch as reference)",
                     mf.macenko_fit_mega, [patches[:1], patches_b[:1]])
    ms_fp = event_ms(mf.macenko_fit_mega_plain, [patches[:1], patches_b[:1]], 5)
    # B2 at the aims' shapes and at the largest pool it holds.
    refs_128 = [dev_u8(synthetic_he_batch(1, 128, 128, seed=args.seed + 128 + k)) for k in range(2)]
    p_fit = largest_fit_pool(torch.uint8)
    refs_max = [dev_u8(synthetic_he_batch(1, 1, p_fit, seed=args.seed + 900 + k)) for k in range(2)]
    for label, xs in [(f"1x3x{P_SIZE}^2 f32", [patches[:1].float() / 255.0, patch_f32]),
                      ("1x3x128^2 u8", refs_128),
                      (f"1x3x1x{p_fit} u8 (the largest pool B2 holds)", refs_max)]:
        kernel_ms(f"B2 macenko_fit_mega {label}", mf.macenko_fit_mega, xs)
    del refs_128, refs_max
    kernel_ms(f"B1 macenko_transform_mega {A_BATCH}x3x{P_SIZE}^2 u8 (small patches), the body "
              f"that re-reads L2",
              lambda x: mf.macenko_transform_mega(x, he_k, mc_k, body="l2"), pair_p)
    kernel_ms(f"B1 macenko_transform_mega {A_BATCH}x3x{P_SIZE}^2 f32 (4096-pixel float32 rows)",
              lambda x: mf.macenko_transform_mega(x, he_k, mc_k),
              [patches.float() / 255.0, patches_b.float() / 255.0])
    kernel_ms(f"B1 macenko_transform_mega {A_BATCH}x3x{A_SIZE}^2 u8 (the WSI tiles' shape)",
              lambda x: mf.macenko_transform_mega(x, he_k, mc_k), pair_t)
    kernel_ms(f"B1 macenko_transform_mega {A_BATCH}x3x{A_SIZE}^2 f32 (path (a)'s batch shape)",
              lambda x: mf.macenko_transform_mega(x, he_k, mc_k), pair_a)
    # B4 and B5 at every path shape, on the route the wrapper takes (and the
    # other one where the rows fit a cluster), with their byte bounds.
    pair_b = [big4, big4_b]

    def b4_ms(label, xs, force=None):
        n, _, h, w = xs[0].shape
        take = force or ms.route(h * w, xs[0].dtype, kernels.device_limits(dev.index)[1])
        t = kernel_ms(f"B4 macenko_transform_stream {label}, {take} route",
                      lambda x: ms.macenko_transform_stream(x, he_k, mc_k, force=force), xs)
        bound, by = bound_ms(2 * xs[0].numel() * xs[0].element_size(),
                             OPS_PER_PIXEL_TRANSFORM * n * h * w)
        print(f"B4 {label}, {take} route: bound {bound:.4f} ms by {by}")
        return t

    def b5_ms(label, xs, force=None):
        n, _, h, w = xs[0].shape
        take = force or ms.route(n * h * w, xs[0].dtype, kernels.device_limits(dev.index)[1])
        t = kernel_ms(f"B5 macenko_fit_stream {label}, {take} route",
                      lambda x: ms.macenko_fit_stream(x, force=force), xs)
        bound, by = bound_ms(xs[0].numel() * xs[0].element_size() + 8 * 4,
                             OPS_PER_PIXEL_FIT * n * h * w)
        print(f"B5 {label}, {take} route: bound {bound:.4f} ms by {by}")
        return t

    ms_b4 = b4_ms(f"{BATCH}x3x{SIZE}^2 u8 (the main path)", pair)
    ms_b4_p = event_ms(lambda x: ms.macenko_transform_stream_plain(x, he_k, mc_k), pair, 2)
    b4_ms(f"{BATCH}x3x{SIZE}^2 u8 (the main path)", pair, "stream")
    b4_ms("4x3x2048^2 u8 (path (b))", pair_b)
    b4_ms("1x3x4096^2 u8 (path (b))", [big1, big1_b])
    b4_ms(f"{A_BATCH}x3x{A_SIZE}^2 u8 (WSI tiles)", pair_t)
    b4_ms(f"{A_BATCH}x3x{A_SIZE}^2 f32 (path (a)'s batch)", pair_a)
    b4_ms("1x3x2048^2 f32", [big4[:1].float() / 255.0, big4_b[:1].float() / 255.0])
    ms_b5 = b5_ms(f"{A_BATCH}x3x{A_SIZE}^2 f32 (path (a))", pair_a)
    ms_b5_p = event_ms(ms.macenko_fit_stream_plain, pair_a, 2)
    b5_ms(f"1x3x{SIZE}^2 u8 (the main path's reference)", [ref, ref_b])
    b5_ms(f"1x3x{SIZE}^2 u8 (the main path's reference)", [ref, ref_b], "stream")
    b5_ms(f"{BATCH}x3x{SIZE}^2 u8", pair)

    # The cluster shapes of the main path's transform and fit: every cluster
    # size, with the slice's resident part as large as fits, and how many
    # such clusters the card holds at once.
    shape_of = ms.cluster_shape
    smem = kernels.device_limits(dev.index)[1]
    budget = ms.resident_budget(1, smem)
    active = lambda c, r: ms._active_clusters(dev.index, torch.uint8, c, r)  # noqa: E731
    for name, rows, call, xs in [
        ("B4", BATCH, lambda x: ms.macenko_transform_stream(x, he_k, mc_k, force="cluster"), pair),
        ("B5", 1, lambda x: ms.macenko_fit_stream(x, force="cluster"), [ref, ref_b]),
    ]:
        taken = shape_of(rows, SIZE * SIZE, 1, smem, active)[0]
        for c in ms.CLUSTER_SIZES:
            slice_ = -(-SIZE * SIZE // c)
            slice_ += -slice_ % ms.SLICE_QUANTUM
            resident = min(slice_, budget)
            ms.cluster_shape = lambda *_a, c=c, s_=slice_, r=resident: (c, s_, r)
            try:
                t = graph_ms(call, xs, 10)
            finally:
                ms.cluster_shape = shape_of
            print(f"{name} {rows}x3x{SIZE}^2 u8 on clusters of {c}: slice {slice_}, {resident} "
                  f"resident, {active(c, resident)} clusters at once: {t:.4f} ms on the device"
                  f"{' (the route takes it)' if taken == c else ''}")

    def angle_field(images):
        """The pooled pseudo-angle field B5 selects on (+inf off the beta-
        mask), its alpha and 100-alpha ranks and its (min, max, count) init,
        from the plain steps."""
        n, _, h, w = images.shape
        od = mf.od_from_planes(images.reshape(n, 3, h * w), images.dtype == torch.uint8)
        od = od.transpose(0, 1).reshape(1, 3, n * h * w)
        member = od.amin(1) >= mk.BETA
        cnt, sums = mf.masked_moments(od, member)
        evecs = eigh3_top2(mf.cov_from_moments(cnt, sums))
        field = torch.where(member, mf.pseudo_angle(mf._project(od, evecs[..., 0]),
                                                    mf._project(od, evecs[..., 1])), torch.inf)
        ranks = torch.stack([nearest_rank_index(mk.ALPHA, cnt),
                             nearest_rank_index(100 - mk.ALPHA, cnt)], -1)
        top = torch.where(member, field, -torch.inf).amax(-1)
        return field.contiguous(), ranks, (field.amin(-1), top, cnt)

    fields = [angle_field(x) for x in pair_a]
    kernel_ms(f"B6 kth_smallest_streaming (1, {A_BATCH * a_px}) K=2 with init "
              "(the angle field of path (a)'s pool, path (d)'s shape)",
              lambda t: ss.kth_smallest_streaming(*t), fields)
    del fields

    # B3 at the shapes of paths (c) and (d), on the fields those paths give
    # it for their two inputs. The library call is torch.kthvalue: one call
    # where every row has the same rank and no sentinel (the concentration
    # fields), else one a row and rank.
    def staged_fields(call, kernel="B3"):
        return [(x, ranks) for name, x, ranks, _out in record_selects(call)[1] if name == kernel]

    norm_cf = Macenko().fit(ref_bf)
    fit_fields = [staged_fields(lambda x=x: Macenko().fit(x)) for x in (ref_bf, low(ref_b, bf16))]
    c_fields = [staged_fields(lambda x=x: norm_cf.transform(x)) for x in (batch_bf, batch_bf_b)]
    d_run = [lambda x=x: StainNormalizerTransform("macenko", mode="batch", batch_ref_index=None)(x)
             for x in (pool_h, pool_h_b)]
    d_fields = [staged_fields(run) for run in d_run]
    b3_ms = {}
    active_b3 = lambda k: lambda c, r: sel._active_clusters(dev.index, k, c, r)  # noqa: E731

    def cluster_table(label, pair_f):
        """B3 on every cluster size at this shape, on the device."""
        rows_f, p_f = pair_f[0][0].shape
        k_f = pair_f[0][1].shape[1]
        taken = sel.cluster_shape(rows_f, p_f, k_f, smem, active_b3(k_f))[0]
        for c in sel.CLUSTER_SIZES:
            resident = sel.cluster_slice(p_f, c, sel.resident_budget(k_f, smem))[1]
            t = graph_ms(lambda t_, c=c: sel._select(*t_, c), pair_f, 10)
            print(f"{label} on clusters of {c}: {resident} resident a block, "
                  f"{active_b3(k_f)(c, resident)} clusters at once: {t:.4f} ms on the device"
                  f"{' (the wrapper takes it)' if taken == c else ''}")

    for path, fields in [("c fit", fit_fields), ("c", c_fields), ("d", d_fields)]:
        for i in range(len(fields[0])):
            pair_f = [f[i] for f in fields]
            rows_f, p_f = pair_f[0][0].shape
            k_f = pair_f[0][1].shape[1]
            label = f"B3 kth_smallest_pallas ({rows_f}, {p_f}) K={k_f} (path ({path}))"
            on_card = kernel_ms(label, lambda t: sel.kth_smallest_pallas(*t), pair_f)
            cluster_table(label, pair_f)
            plain = event_ms(lambda t: sel.kth_smallest_pallas_plain(*t), pair_f, 3)
            host = [t[1].tolist() for t in pair_f]
            if k_f == 1:
                lib = event_ms(lambda j: torch.kthvalue(pair_f[j][0], host[j][0][0] + 1, dim=1),
                               [0, 1], 5)
            else:
                lib = event_ms(lambda j: [torch.kthvalue(pair_f[j][0][r], q + 1)
                                          for r, qs in enumerate(host[j]) for q in qs], [0, 1], 1)
            print(f"{label}: plain {plain:.4f} ms, library (torch.kthvalue) {lib:.4f} ms")
            b3_ms[path, i] = (on_card, plain, lib, rows_f, p_f, k_f)
    del c_fields, d_fields, fit_fields
    # Short rows on every cluster size: the staged fit of a 224^2 or a 64^2
    # reference (K=2 angles, K=1 concentrations) and a few 224^2 rows. How
    # far the wrapper spreads a short row rests on these.
    for rows_f, p_f, k_f in [(1, a_px, 2), (2, a_px, 1), (8, a_px, 1),
                             (1, P_SIZE * P_SIZE, 2), (2, P_SIZE * P_SIZE, 1)]:
        pair_f = [t[:2] for t in select_inputs(rows_f, p_f, k_f, args.seed + 700)]
        cluster_table(f"B3 kth_smallest_pallas ({rows_f}, {p_f}) K={k_f} randn", pair_f)
    # B6 at path (d)'s two fields, as the route calls it (no init: the
    # kernel finds each row's extremes and count), and the first one with
    # an init; torch.kthvalue is one call for the K=1 concentration rows.
    d6 = [staged_fields(run, "B6") for run in d_run]
    b6_ms = {}
    for i in range(len(d6[0])):
        pair_f = [f[i] for f in d6]
        rows_f, p_f = pair_f[0][0].shape
        k_f = pair_f[0][1].shape[1]
        label = f"B6 kth_smallest_streaming ({rows_f}, {p_f}) K={k_f} (path (d))"
        on_card = kernel_ms(label, lambda t: ss.kth_smallest_streaming(*t), pair_f)
        plain = event_ms(lambda t: ss.kth_smallest_streaming_plain(*t), pair_f, 3)
        host = [t[1].tolist() for t in pair_f]
        if k_f == 1:
            lib = event_ms(lambda j: torch.kthvalue(pair_f[j][0], host[j][0][0] + 1, dim=1),
                           [0, 1], 3)
        else:
            lib = event_ms(lambda j: [torch.kthvalue(pair_f[j][0][r], q + 1)
                                      for r, qs in enumerate(host[j]) for q in qs], [0, 1], 1)
            inits = [(t[0], t[1], field_init(t[0])) for t in pair_f]
            kernel_ms(f"{label} with an init", lambda t: ss.kth_smallest_streaming(*t), inits)
            del inits
        print(f"{label}: plain {plain:.4f} ms, library (torch.kthvalue) {lib:.4f} ms")
        b6_ms[i] = (on_card, plain, lib, rows_f, p_f, k_f)
    del d6

    def path_ms(label, fn, inputs, n_img, n_px):
        fn(inputs[0])
        segments = torch.cuda.memory_stats()["segment.all.allocated"]
        eager = event_ms(fn, inputs, 10)
        segments = torch.cuda.memory_stats()["segment.all.allocated"] - segments
        busy = graph_ms(fn, inputs, 10)
        prof = profiled_ms(fn, inputs, 5)
        prof_txt = "not measured" if prof is None else f"{prof:.4f} ms (idle {1.0 - prof / eager:.3f})"
        print(f"{label}: {eager:.4f} ms called ({n_px / eager / 1e3:.1f} MPix/s, "
              f"{n_img / eager * 1e3:.0f} img/s), device busy {busy:.4f} ms, idle share "
              f"{1.0 - busy / eager:.3f}; kernel time in torch.profiler {prof_txt}; "
              f"{segments} device allocations by the caching allocator while called")

    path_ms(f"path (a) forward, batch mode {A_BATCH}x3x{A_SIZE}^2 f32", transform_a, pair_a,
            A_BATCH, A_BATCH * a_px)
    path_ms("path (a) forward, batch_ref_index=0", transform_a0, pair_a, A_BATCH, A_BATCH * a_px)
    path_ms(f"WSI tiles Macenko.transform {A_BATCH}x3x{A_SIZE}^2 u8", norm_t.transform, pair_t,
            A_BATCH, A_BATCH * a_px)
    path_ms(f"small patches Macenko.transform {A_BATCH}x3x{P_SIZE}^2 u8", norm_p.transform, pair_p,
            A_BATCH, A_BATCH * P_SIZE * P_SIZE)
    for dtype_name, scale in (("u8", None), ("f32", 255.0)):
        xs = pair_p if scale is None else [x.float() / scale for x in pair_p]
        path_ms(f"small-patch batch mode forward {A_BATCH}x3x{P_SIZE}^2 {dtype_name}, "
                f"batch_ref_index=0", transform_s[dtype_name], xs, A_BATCH,
                A_BATCH * P_SIZE * P_SIZE)
    path_ms(f"main path Macenko.transform {BATCH}x3x{SIZE}^2 u8", normalizer.transform, pair,
            BATCH, BATCH * SIZE * SIZE)
    path_ms("path (b) Macenko.transform 4x3x2048^2 u8", b_normalizers["4x3x2048^2"].transform,
            pair_b, 4, 4 * 2048 * 2048)
    path_ms("path (b) Macenko.transform 1x3x4096^2 u8", b_normalizers["1x3x4096^2"].transform,
            [big1, big1_b], 1, 4096 * 4096)
    for label, x_pair in [("bf16 stable", [batch_bf, batch_bf_b]),
                          ("bf16 fast", [batch_bf, batch_bf_b]),
                          ("f16 stable", [batch_h, low(batch_b, f16)])]:
        path_ms(f"path (c) Macenko.transform {BATCH}x3x{SIZE}^2 {label}",
                c_normalizers[label].transform, x_pair, BATCH, BATCH * SIZE * SIZE)
    path_ms(f"staged fit Macenko().fit 1x3x{SIZE}^2 bf16", lambda x: Macenko().fit(x),
            [ref_bf, low(ref_b, bf16)], 1, SIZE * SIZE)
    path_ms(f"path (d) forward, batch mode {A_BATCH}x3x{A_SIZE}^2 f16", transform_d,
            [pool_h, pool_h_b], A_BATCH, A_BATCH * a_px)

    # The route ladder: B1 against B4 and B2 against B5 over sizes, in
    # SWEEP_ROUNDS rounds, each kernel called as a user calls it and
    # replayed from the same CUDA graphs for its device time. A kernel wins a
    # size only where its slowest round, as called, beats the other's
    # fastest; where the rounds overlap there is no winner, and the ladder
    # (ops/macenko.py) keeps the one-block kernel there.
    print(f"route ladder: STREAM_MIN_ELEMS {mk.STREAM_MIN_ELEMS}, STREAM_MAX_ROWS "
          f"{mk.STREAM_MAX_ROWS}, STREAM_MIN_ELEMS_F32 {mk.STREAM_MIN_ELEMS_F32}, "
          f"STREAM_MAX_ROWS_F32 {mk.STREAM_MAX_ROWS_F32}; fit_route sends B5 pools from "
          f"{largest_fit_pool(torch.uint8) + 1} uint8 pixels and "
          f"{largest_fit_pool(torch.float32) + 1} float32 up (past the largest B2 holds)")

    def sweep_inputs(n, side, dtype, seed):
        h, w = side if isinstance(side, tuple) else (side, side)
        xs = [dev_u8(synthetic_he_batch(n, h, w, seed=seed + k)) for k in range(2)]
        return [x.float() / 255.0 for x in xs] if dtype == "f32" else xs

    unearned, kept = [], []

    def race(label, contenders, xs, route):
        it = 3 if (xs[0][0] if isinstance(xs[0], tuple) else xs[0]).numel() > 3e7 else 10
        graphs = {name: capture_graphs(fn, xs) for name, fn in contenders}
        called = {name: [] for name, _ in contenders}
        device = {name: [] for name, _ in contenders}
        for _ in range(SWEEP_ROUNDS):
            for name, fn in contenders:
                called[name].append(event_ms(fn, xs, it))
                device[name].append(replay_ms(graphs[name], it))
        del graphs
        (one, _), (multi, _) = contenders
        winner = ("none" if max(called[one]) >= min(called[multi])
                  and max(called[multi]) >= min(called[one])
                  else one if max(called[one]) < min(called[multi]) else multi)
        routed = multi if route == "stream" else one
        if routed == multi and winner != multi:
            unearned.append(label)
        elif routed == one and winner == multi:
            kept.append(label)
        spans = "; ".join(
            f"{name} {min(called[name]):.4f}-{max(called[name]):.4f} ms called, "
            f"{min(device[name]):.4f}-{max(device[name]):.4f} on the device"
            for name, _ in contenders)
        print(f"sweep {label}: {spans}; faster in every round: {winner}; route: {routed}")

    types = {"u8": torch.uint8, "f32": torch.float32}
    for n, side, dtype in [(4, 64, "u8"), (4, 128, "u8"), (64, 64, "u8"), (64, 128, "u8"),
                           (256, 96, "u8"), (4, 224, "u8"), (4, 256, "u8"), (4, 320, "u8"), (4, 352, "u8"),
                           (4, 384, "u8"), (4, 512, "u8"), (4, 2048, "u8"), (16, 224, "u8"),
                           (16, 256, "u8"), (16, 320, "u8"), (16, 384, "u8"), (16, 512, "u8"),
                           (16, 1024, "u8"), (64, 224, "u8"), (64, 256, "u8"), (64, 320, "u8"),
                           (64, 384, "u8"), (64, 512, "u8"), (80, 512, "u8"), (96, 512, "u8"),
                           (112, 512, "u8"), (128, 256, "u8"), (128, 512, "u8"), (256, 64, "u8"),
                           (256, 128, "u8"), (64, 136, "u8"), (256, 136, "u8"),
                           (256, 224, "u8"), (256, 256, "u8"), (512, 224, "u8"),
                           (4, 96, "f32"), (4, 128, "f32"), (64, 96, "f32"), (64, 102, "f32"),
                           (256, 102, "f32"), (64, 128, "f32"),
                           (4, 160, "f32"),
                           (4, 224, "f32"), (4, 256, "f32"), (4, 288, "f32"), (16, 160, "f32"),
                           (16, 224, "f32"), (16, 288, "f32"), (64, 160, "f32"), (64, 224, "f32"),
                           (64, 256, "f32"), (64, 288, "f32"), (96, 224, "f32"), (128, 224, "f32"),
                           (192, 224, "f32"), (256, 128, "f32"), (256, 160, "f32"),
                           (256, 192, "f32"), (256, 224, "f32")]:
        race(f"transform {n}x3x{side}^2 {dtype}",
             [("B1", lambda x: mf.macenko_transform_mega(x, he_k, mc_k)),
              ("B4", lambda x: ms.macenko_transform_stream(x, he_k, mc_k))],
             sweep_inputs(n, side, dtype, args.seed + 300),
             mk.transform_route(n, side * side, types[dtype]))
    # B2 against B5 at pools B2 holds; every larger pool is B5's.
    for n, side, dtype in [(1, 64, "u8"), (1, 96, "u8"), (1, 96, "f32"), (1, 128, "u8"),
                           (1, 136, "u8"), (2, 96, "u8"), (4, 64, "u8"), (8, 48, "u8"),
                           (1, 64, "f32"), (1, 80, "f32"), (2, 64, "f32"), (1, 102, "f32")] + [
            # the largest pool B2 holds
            (1, (1, largest_fit_pool(types[d])), d) for d in ("u8", "f32")]:
        h, w = side if isinstance(side, tuple) else (side, side)
        race(f"fit {n}x3x{h}x{w} {dtype}",
             [("B2", mf.macenko_fit_mega), ("B5", ms.macenko_fit_stream)],
             sweep_inputs(n, side, dtype, args.seed + 400),
             mk.fit_route(n * h * w, types[dtype], smem_optin))
    print(f"sweep: the ladder gives the multi-block kernel a size it did not win in every "
          f"round at {unearned or 'no size'}; it keeps the one-block kernel where the "
          f"multi-block one won (host-cost margin, row cap) at {kept or 'no size'}")

    # B1's size rule: the resident body wherever the image fits a block's
    # shared memory, else the body that re-reads L2 (mf.transform_body),
    # timed against each other where both can run.
    unearned.clear()
    kept.clear()
    for n, side, dtype in [(4, 64, "u8"), (256, 64, "u8"), (64, 96, "u8"), (256, 96, "u8"),
                           (512, 96, "u8"), (16, 128, "u8"), (256, 128, "u8"), (4, 136, "u8"),
                           (256, 136, "u8"), (256, 64, "f32"), (16, 96, "f32"), (256, 96, "f32"),
                           (4, 102, "f32"), (256, 102, "f32")] + [
            # the largest rows the resident body holds
            (4, (1, largest_resident(types[d])), d) for d in ("u8", "f32")]:
        h, w = side if isinstance(side, tuple) else (side, side)
        xs = sweep_inputs(n, side, dtype, args.seed + 600)
        body = mf.transform_body(h * w, types[dtype], smem_optin)
        race(f"B1 body {n}x3x{h}x{w} {dtype}",
             [("resident", lambda x: mf.macenko_transform_mega(x, he_k, mc_k, body="resident")),
              ("l2", lambda x: mf.macenko_transform_mega(x, he_k, mc_k, body="l2"))],
             xs, "mega" if body == "resident" else "stream")
    print(f"B1 body sweep: the resident body is taken where the L2 body won every round at "
          f"{kept or 'no size'}; the L2 body where it did not win at {unearned or 'no size'}")

    # The staged route's select threshold: B3 (a cluster a row) against B6
    # as the route calls it (no init: B6 finds the rows' extremes), on angle-like
    # fields (30 % sentinels, the alpha and 100-alpha ranks) and
    # concentration-like ones (no sentinel, the 99th percentile).
    print(f"select threshold: SELECT_STREAM_MIN_ELEMS {pct.SELECT_STREAM_MIN_ELEMS}, "
          f"SELECT_STREAM_MAX_ROWS {pct.SELECT_STREAM_MAX_ROWS}")
    unearned.clear()
    kept.clear()

    for p in [a_px, SIZE * SIZE, 1 << 19, 1 << 20, 1 << 22, A_BATCH * a_px, 1 << 24]:
        for rows in [1, 2, 8, 16, 32, 64, 128, 256, 512]:
            if rows * p > 1 << 28:
                continue
            for k in (2, 1):
                race(f"select ({rows}, {p}) K={k}",
                     [("B3", lambda t: sel.kth_smallest_pallas(t[0], t[1])),
                      ("B6", lambda t: ss.kth_smallest_streaming(t[0], t[1]))],
                     select_inputs(rows, p, k, args.seed + 500), pct.select_route(rows, p))
    print(f"select sweep: the threshold gives B6 a size it did not win in every round at "
          f"{unearned or 'no size'}; it keeps B3 where B6 won at {kept or 'no size'}")

    n_px = BATCH * SIZE * SIZE
    n_a = A_BATCH * a_px
    n_p = A_BATCH * P_SIZE * P_SIZE
    b1_bound, b1_by = bound_ms(2 * 3 * n_p, OPS_PER_PIXEL_TRANSFORM * n_p)
    b2_bound, b2_by = bound_ms(3 * P_SIZE * P_SIZE + 8 * 4, OPS_PER_PIXEL_FIT * P_SIZE * P_SIZE)
    b4_bound, b4_by = bound_ms(2 * 3 * n_px, OPS_PER_PIXEL_TRANSFORM * n_px)
    b5_bound, b5_by = bound_ms(3 * 4 * n_a + 8 * 4, OPS_PER_PIXEL_FIT * n_a)
    # B6 reads the field once, the ranks and the init, and writes K values;
    # it needs one compare an element for each of its K ranks. Printed for
    # path (d)'s two fields; the kernel line carries the first, as the route
    # calls it (no init).
    for i, (on_card, plain, lib, rows_f, p_f, k_f) in sorted(b6_ms.items()):
        bound, by = bound_ms(4 * rows_f * p_f + 2 * 4 * rows_f * k_f, k_f * rows_f * p_f)
        print(f"B6 ({rows_f}, {p_f}) K={k_f} (path (d)): {on_card:.4f} ms on the device, "
              f"bound {bound:.4f} ms by {by}, plain {plain:.4f} ms, torch.kthvalue {lib:.4f} ms")
    ms_b6, ms_b6_p, ms_b6_lib, rows_6, p_6, k_6 = b6_ms[0]
    b6_bound, b6_by = bound_ms(4 * rows_6 * p_6 + 2 * 4 * rows_6 * k_6, k_6 * rows_6 * p_6)
    # B7b reads the batch once and writes its six sums; B7a reads the batch
    # and its twelve statistics and writes the batch.
    b7b_bound, b7b_by = bound_ms(3 * n_px + 6 * 4, OPS_PER_PIXEL_MOMENTS_U8 * n_px)
    b7a_bound, b7a_by = bound_ms(2 * 3 * n_px + 12 * 4, OPS_PER_PIXEL_APPLY_U8 * n_px)
    for name, ms_u8, ms_f32, bytes_px, ops_px in [
        ("B7b", ms_b7b, ms_b7b_f, 3, OPS_PER_PIXEL_MOMENTS_U8),
        ("B7a", ms_b7a, ms_b7a_f, 6, OPS_PER_PIXEL_APPLY_U8),
    ]:
        for dt, t, width, extra in [("u8", ms_u8, 1, 0), ("f32", ms_f32, 4, OPS_PER_PIXEL_FORWARD_GAMMA)]:
            bound, by = bound_ms(width * bytes_px * n_px, (ops_px + extra) * n_px)
            print(f"{name} {BATCH}x3x{SIZE}^2 {dt}: {t:.4f} ms on the device, bound {bound:.4f} ms "
                  f"by {by} (bytes {width * bytes_px * n_px / HBM_BYTES_PER_S * 1e3:.4f} ms, "
                  f"float32 operations {(ops_px + extra) * n_px / F32_OPS_PER_S * 1e3:.4f} ms)")
    b8a_bound, b8a_by = bound_ms(3 * n_px + 3 * 256 * 4, 0)
    b8b_bound, b8b_by = bound_ms(2 * 3 * n_px + 3 * 256 * 4, 0)
    # B3 reads its field and ranks once and writes K values a row; one
    # compare an element for each rank. Printed for every timed shape; the
    # kernel line carries path (d)'s concentration field.
    for (path, i), (on_card, plain, lib, rows_f, p_f, k_f) in sorted(b3_ms.items()):
        bound, by = bound_ms(4 * rows_f * p_f + 2 * 4 * rows_f * k_f, k_f * rows_f * p_f)
        print(f"B3 ({rows_f}, {p_f}) K={k_f} (path ({path})): {on_card:.4f} ms on the device, "
              f"bound {bound:.4f} ms by {by}, plain {plain:.4f} ms, torch.kthvalue {lib:.4f} ms")
    ms_b3, ms_b3_p, ms_b3_lib, rows_3, p_3, k_3 = b3_ms["d", 1]
    b3_bound, b3_by = bound_ms(4 * rows_3 * p_3 + 2 * 4 * rows_3 * k_3, k_3 * rows_3 * p_3)
    rows = [
        {"name": "macenko_transform_mega", "route": "cuda",
         "source": "stainx_tpu_torch/csrc/macenko_fused.cu", "replaces": f"{TPU_SOURCE}:529",
         "launches": p_launches["macenko_transform_mega"], "max_abs_err": b1_err,
         "ms": ms_b1, "plain_ms": ms_b1_p, "bound_ms": b1_bound, "bound_by": b1_by,
         "library_ms": None},
        {"name": "macenko_fit_mega", "route": "cuda",
         "source": "stainx_tpu_torch/csrc/macenko_fused.cu", "replaces": f"{TPU_SOURCE}:748",
         "launches": p_launches["macenko_fit_mega"], "max_abs_err": fit_err,
         "ms": ms_f, "plain_ms": ms_fp, "bound_ms": b2_bound, "bound_by": b2_by,
         "library_ms": None},
        {"name": "macenko_transform_stream", "route": "cuda",
         "source": "stainx_tpu_torch/csrc/macenko_stream.cu", "replaces": f"{TPU_STREAM}:769",
         "launches": main_launches["macenko_transform_stream"], "max_abs_err": b4_main_err,
         "ms": ms_b4, "plain_ms": ms_b4_p, "bound_ms": b4_bound, "bound_by": b4_by,
         "library_ms": None},
        {"name": "macenko_fit_stream", "route": "cuda",
         "source": "stainx_tpu_torch/csrc/macenko_stream.cu", "replaces": f"{TPU_STREAM}:872",
         "launches": a_launches["macenko_fit_stream"], "max_abs_err": b5_err,
         "ms": ms_b5, "plain_ms": ms_b5_p, "bound_ms": b5_bound, "bound_by": b5_by,
         "library_ms": None},
        {"name": "kth_smallest_streaming", "route": "cuda",
         "source": "stainx_tpu_torch/csrc/selection.cu", "replaces": f"{TPU_SELECT}:381",
         "launches": d_launches["kth_smallest_streaming"], "max_abs_err": 0.0,
         "ms": ms_b6, "plain_ms": ms_b6_p, "bound_ms": b6_bound, "bound_by": b6_by,
         "library_ms": ms_b6_lib},
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
        {"name": "kth_smallest_pallas", "route": "cuda",
         "source": "stainx_tpu_torch/csrc/select_rows.cu", "replaces": f"{TPU_ROWS}:1222",
         "launches": d_launches["kth_smallest_pallas"], "max_abs_err": 0.0,
         "ms": ms_b3, "plain_ms": ms_b3_p, "bound_ms": b3_bound, "bound_by": b3_by,
         "library_ms": ms_b3_lib},
    ]
    for r in rows:
        lib_ms = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
        print(f"{r['name']}: {r['ms']:.4f} ms (bound {r['bound_ms']:.4f} ms by {r['bound_by']}), "
              f"plain {r['plain_ms']:.4f} ms, library {lib_ms}")

    # 6. The harness: the port's measuring scripts, in this process.
    t0 = time.perf_counter()
    harness_phase()
    print(f"phase 6: {time.perf_counter() - t0:.1f} s")

    # 7. The committed structured tiles, and the port's user programs.
    t0 = time.perf_counter()
    user_programs_phase(dev)
    print(f"phase 7: {time.perf_counter() - t0:.1f} s")

    # 8. Seeded random shapes on both sides of every kernel's route edge.
    random_shapes_phase(args.seed, dev)
    print(json.dumps({"kernels": rows}))
    print(card.splitlines()[0])
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
