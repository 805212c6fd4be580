"""Plain PyTorch histogram matching: the reference that decides an HM cell's ``correct``.

A frozen copy, in plain ``torch`` on the CPU and in float32, of the numpy
oracle's ``hm_fit`` and ``hm_transform``, term by term (upstream stainx's
``torch_backend.py`` HistogramMatching: at fit, per-channel 256-bin
histograms of the reference, each normalized by ``counts / (sum + 1e-8)``;
at transform, each channel's CDF over the call's whole N*H*W pixels,
``searchsorted`` (left) into the reference's CDF, the index clipped to
[1, 255], linear interpolation between its two bins where their quantiles
differ by more than 1e-10, bin 0 where the CDF lies at or below the
reference's first quantile, bin 255 past the last occupied bin, a 256-entry
LUT a channel, and every pixel looked up in it; uint8 stores
``trunc(clip(lut[v], 0, 255))``, float32 ``clip(lut[v] / 255, 0, 1)``). It
takes numpy in and gives numpy out, imports nothing of the program, and
takes nothing the program made: it is handed the benchmark's own inputs and
works the histograms out again.

Departures, each of which only makes the reference more exact or leaves its
bits as they are:

- the above-max pin is structural, as in the oracle and the port: a bin
  pins to 255 where no occupied bin of the call follows it, in place of
  upstream's float compare ``source_cdf >= rq[-1]``, which rounds either
  way at the last occupied bin (exact arithmetic pins it there);
- the counts and the fit's pixel count are int64, where the oracle counts
  in float32 (exact below 2^24 a bin);
- the reference histogram's row sum and both cumulative sums add their 256
  float32 terms in the order the JAX package's compiled transform fixes
  (XLA's rewrite of a 256-long reduce: eight windows of 32 in sequence,
  then the eight; of a 256-long cumsum: blocks of 16 in sequence, the
  block totals in sequence, each block's prefix added), where the oracle
  adds in sequence. The LUT is not continuous in the CDF: where the
  reference histogram has empty bins its CDF is flat, and a source CDF
  value one float32 ulp either side of that level moves its LUT entry by
  the width of the flat stretch (63 grey levels, on one seed of 24 on the
  card, between the port and these sums taken in float64). Two float32
  programs that add in different orders may both be right there, so the
  reference takes the order the port's contract names, and the check
  measures everything else;
- a call is counted and looked up in blocks of ``BLOCK_ROWS`` images, so
  that the int64 temporaries stay a few hundred MB at 256x3x512^2: first
  the counts of the whole call, then the LUT, then the lookup, block by
  block. Counts are integers and the lookup is elementwise, so the
  blocking leaves each output value's bits as they are.

``rounding`` is applied to every stored float32 intermediate (the
normalized histograms, the CDFs, the interpolation weights and the LUT).
The benchmark runs with it off; the control (``portbench.control``) passes
:func:`bf16`, the reference computed in the precision below the
configuration's float32, and must come out as not correct.
"""

from __future__ import annotations

import numpy as np
import torch

# Nothing here multiplies matrices; set as the other references set it.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

STATISTICS = "call"
BLOCK_ROWS = 16
BINS = 256

# Floating-point operations a pixel (3 channels) needs. None at fit or at
# transform: the counts and the lookup are integer work, and the CDFs and the
# LUT are per bin, not per pixel. A float input is quantized to uint8 first
# (a product by 255 a channel, the clip counted as none) and a float output
# is the LUT over 255 (a product a channel): 3 each.
OPS_PER_PIXEL = {"fit": 0, "transform": 0, "float_input": 3, "unit_output": 3}


def _same(a):
    return a


def bf16(a: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to the nearest bfloat16 (ties to even)."""
    return a.to(torch.bfloat16).to(torch.float32)


def _blocks(images: np.ndarray):
    """``(lo, block)``: each block of ``BLOCK_ROWS`` images as a uint8
    tensor; a float block in [0, 1] is quantized as the oracle's
    ``_to_uint8``, ``trunc(clip(x*255, 0, 255))``."""
    for lo in range(0, len(images), BLOCK_ROWS):
        block = torch.from_numpy(np.ascontiguousarray(images[lo:lo + BLOCK_ROWS]))
        if block.dtype != torch.uint8:
            block = torch.clamp(block.to(torch.float32) * 255.0, 0.0, 255.0).to(torch.uint8)
        yield lo, block


def counts(images: np.ndarray) -> torch.Tensor:
    """(C, 256) int64 counts of each channel's values over all of
    ``images`` (N, C, H, W)."""
    c = images.shape[1]
    total = torch.zeros((c, BINS), dtype=torch.int64)
    for _, block in _blocks(images):
        flat = block.transpose(0, 1).reshape(c, -1).to(torch.int64)
        total += torch.stack([torch.bincount(flat[i], minlength=BINS) for i in range(c)])
    return total


def _row_sums(x: torch.Tensor) -> torch.Tensor:
    """float32 sums of the rows of (R, 256) ``x``, (R, 1): each window of 32
    added in sequence, then the eight window sums in sequence."""
    windows = x.reshape(len(x), 8, 32)
    part = windows[..., 0]
    for j in range(1, 32):
        part = part + windows[..., j]
    total = part[:, 0]
    for k in range(1, 8):
        total = total + part[:, k]
    return total[:, None]


def _cdf(x: torch.Tensor, r) -> torch.Tensor:
    """Inclusive float32 cumulative sums of the rows of (R, 256) ``x``:
    within each block of 16 in sequence, the block totals in sequence, then
    each block's exclusive prefix added to its sums."""
    blocks = x.reshape(len(x), 16, 16)
    inner = [blocks[..., 0]]
    for j in range(1, 16):
        inner.append(inner[-1] + blocks[..., j])
    inner = torch.stack(inner, dim=-1)
    prefix = [torch.zeros_like(inner[:, 0, -1])]
    for k in range(1, 16):
        prefix.append(prefix[-1] + inner[:, k - 1, -1])
    return r((inner + torch.stack(prefix, dim=-1)[..., None]).reshape(x.shape))


def fit(images: np.ndarray, rounding=_same) -> dict[str, np.ndarray]:
    """The reference histograms (C, 256) of ``images`` (N, C, H, W), each
    row ``counts / (sum + 1e-8)`` in float32."""
    found = counts(images)
    total = found.sum(dim=1, keepdim=True).to(torch.float32)
    hist = rounding(found.to(torch.float32) / (total + 1e-8))
    return {"_ref_histograms_256": hist.numpy()}


def lut(source_counts: torch.Tensor, ref_hist: torch.Tensor, pixels: int,
        r=_same) -> torch.Tensor:
    """The (C, 256) float32 LUT in [0, 255] that maps a call with these
    counts (``pixels`` values a channel) onto ``ref_hist``."""
    source_cdf = _cdf(r(source_counts.to(torch.float32) / np.float32(pixels + 1e-8)), r)
    ref_hist = ref_hist.to(torch.float32)
    rq = _cdf(r(ref_hist / (_row_sums(ref_hist) + 1e-8)), r)
    idx = torch.clamp(torch.searchsorted(rq, source_cdf, side="left"), 1, BINS - 1)
    q_left, q_right = torch.gather(rq, 1, idx - 1), torch.gather(rq, 1, idx)
    diff = q_right - q_left
    alpha = r(torch.where(diff > 1e-10, (source_cdf - q_left) / diff, 0.0))
    out = r((idx - 1).to(torch.float32) + alpha)
    out = torch.where(source_cdf <= rq[:, :1], 0.0, out)
    occupied = (source_counts > 0).to(torch.int64)
    after = torch.flip(torch.cumsum(torch.flip(occupied, [1]), dim=1), [1]) - occupied
    out = torch.where(after == 0, float(BINS - 1), out)
    return torch.clamp(out, 0.0, 255.0)


def transform(images: np.ndarray, state: dict[str, np.ndarray], rounding=_same) -> np.ndarray:
    """``images`` (N, C, H, W) matched onto ``state``'s histograms with the
    CDF of the whole call, in the input's dtype (uint8 in [0, 255], float in
    [0, 1])."""
    n, c, h, w = images.shape
    table = lut(counts(images), torch.as_tensor(state["_ref_histograms_256"]), n * h * w,
                rounding)
    if images.dtype == np.uint8:
        flat = torch.clamp(table, 0.0, 255.0).to(torch.uint8).reshape(-1)
    else:
        flat = torch.clamp(table / 255.0, 0.0, 1.0).reshape(-1)
    shift = (torch.arange(c, dtype=torch.int64) * BINS).reshape(1, c, 1, 1)
    out = np.empty(images.shape, images.dtype)
    for lo, block in _blocks(images):
        out[lo:lo + len(block)] = flat[block.to(torch.int64) + shift].numpy()
    return out


def state_gaps(program: dict, reference: dict) -> dict[str, float]:
    """How far the program's fit lies from the reference's: the largest
    absolute gap of the (C, 256) normalized reference histograms."""
    ref = np.asarray(reference["_ref_histograms_256"], np.float64)
    prog = np.asarray(program["_ref_histograms_256"], np.float64).reshape(ref.shape)
    return {"hist_gap": float(np.abs(prog - ref).max())}
