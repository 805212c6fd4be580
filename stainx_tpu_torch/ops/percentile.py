"""Exact nearest-rank percentiles on tensors.

Counterpart of ``stainx_tpu/ops/percentile.py``. The rank formula is ported
bit for bit: the 0-based index ``round(0.01·q·(n−1))`` with
round-half-to-even, clamped at 0, in integer arithmetic that cannot overflow
int32. Selection itself is the plain version of the CUDA kernels' radix
select: sort the monotone integer keys of each row and read the key at the
rank. The result is always an actual element of the row.

On a CUDA tensor the selections run B3 or B6 as :func:`select_route`
chooses, for these wrappers and the staged Macenko route alike.
"""

from __future__ import annotations

import torch

from stainx_tpu_torch.kernels import selection, selection_stream
from stainx_tpu_torch.kernels.selection import monotone_key, unkey


def nearest_rank_index(q: int, n: torch.Tensor) -> torch.Tensor:
    """0-based nearest-rank index ``round(0.01·q·(n−1))`` (half-to-even),
    clamped at 0, for an integer tensor of counts ``n``. ``q`` is an integer
    percentage. The product ``q·(n−1)`` wraps int32 above ~21.7M elements at
    q=99, so it is decomposed as ``q·(m//100)·100 + q·(m%100)``: both terms
    stay far inside int32."""
    if not float(q).is_integer():
        raise ValueError(f"q must be an integer percentage, got {q}")
    q = int(q)
    m = n.to(torch.int32) - 1
    hi = torch.div(m, 100, rounding_mode="floor")
    lo = torch.remainder(m, 100)
    t_lo = q * lo
    quotient = q * hi + torch.div(t_lo, 100, rounding_mode="floor")
    rem = torch.remainder(t_lo, 100)
    round_up = (rem > 50) | ((rem == 50) & (torch.remainder(quotient, 2) == 1))
    return torch.clamp(quotient + round_up.to(torch.int32), min=0)


def static_nearest_rank_index(q: int, n: int) -> int:
    """Python-int version of :func:`nearest_rank_index` for static counts."""
    quotient, rem = divmod(int(q) * (int(n) - 1), 100)
    round_up = rem > 50 or (rem == 50 and quotient % 2 == 1)
    return max(quotient + int(round_up), 0)


def kth_smallest(
    x: torch.Tensor, rank: torch.Tensor, mask: torch.Tensor | None = None
) -> torch.Tensor:
    """Value of 0-based ascending ``rank`` among the valid elements of each
    row of ``x`` (R, P). Valid means finite and, when given, ``mask``-true,
    so +inf entries act as sentinels. ``rank`` is (R,) or (R, K); the
    result has its shape.

    Conventions of ``stainx_tpu.ops.percentile.kth_smallest``: a rank past
    the valid count clamps to the row's largest valid element, and a row
    with no valid element gives +inf."""
    xf = x.to(torch.float32)
    valid = torch.isfinite(xf) if mask is None else mask & torch.isfinite(xf)
    keys = monotone_key(torch.where(valid, xf, torch.inf))
    last = (valid.sum(-1) - 1).clamp(min=0)
    r = rank.to(torch.int64)
    flat = r.dim() == x.dim() - 1
    if flat:
        r = r.unsqueeze(-1)
    r = torch.minimum(r.clamp(min=0), last.unsqueeze(-1))
    out = unkey(torch.sort(keys, dim=-1).values.gather(-1, r))
    return out.squeeze(-1) if flat else out


# B3 or B6 for a selection, from the three-round sweep of B3 against B6 in
# chip_smoke.py phase 5 (H100 80GB HBM3, 700 W), by the rule of the ladder
# in ops/macenko.py, after both were redesigned (B3: a thread-block cluster
# a row in shared memory; B6: one C call that finds each row's extremes
# itself and finishes on a candidate buffer); three runs on the same
# kernels agreed, and the figures here are the last run's. B6 won no
# size of up to 262 144 elements (B3 at (512, 224^2) K=1 0.132-0.135 ms
# called against 0.237-0.241; at (64, 512^2) K=2 0.117-0.119 against
# 0.187-0.195); at 524 288 and 1 048 576 elements it won some K=2 cells of
# 8 to 32 rows and (32, 1 048 576) K=1, and lost or tied the rest, so B3
# keeps them (the route does not tell K apart). From 4 194 304 elements B6
# won every round for 1 to 32 rows (at (32, 4 194 304) K=2 0.947-0.953 ms
# against 1.405-1.413; at path (d)'s (1, 12 845 056) K=2 0.138 against
# 0.481-0.487), and B3 from 64 rows on (1.63-1.67 against 2.08-2.13 at
# (64, 4 194 304) K=2).
# So B6 takes rows of at least SELECT_STREAM_MIN_ELEMS elements when there
# are at most SELECT_STREAM_MAX_ROWS of them: path (d)'s pool fit, and no
# field of path (c).
SELECT_STREAM_MIN_ELEMS = 4_194_304
SELECT_STREAM_MAX_ROWS = 32


def select_route(rows: int, p: int) -> str:
    """``"stream"`` (B6) or ``"rows"`` (B3) for a selection on ``rows``
    rows of ``p`` elements: the staged Macenko route's selections and, on a
    CUDA tensor, the percentile wrappers'."""
    few_long_rows = p >= SELECT_STREAM_MIN_ELEMS and rows <= SELECT_STREAM_MAX_ROWS
    return "stream" if few_long_rows else "rows"


def _select(xs: torch.Tensor, ranks: torch.Tensor) -> torch.Tensor:
    """(R, K) values at ``ranks`` among the elements below +inf of each row
    of ``xs`` (R, P), through B3 or B6 by :func:`select_route`. B6 finds
    each row's extremes and count in its own first read."""
    if select_route(*xs.shape) == "stream":
        return selection_stream.kth_smallest_streaming(xs, ranks)
    return selection.kth_smallest_pallas(xs, ranks)


def _select_rows(x: torch.Tensor, rank: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
    """:func:`kth_smallest` of ``x`` (..., P) at one rank a row (...,): the
    plain version on a CPU tensor, :func:`_select_on_card` on a CUDA one."""
    if x.device.type == "cpu":
        return kth_smallest(x, rank, mask)
    return _select_on_card(x, rank, mask)


def _select_on_card(x: torch.Tensor, rank: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
    """B3 or B6 on the rows of ``x`` with every invalid entry (masked, NaN
    or ±inf) made a +inf sentinel, which those kernels leave out of the
    count; on a CPU tensor their plain versions run."""
    xf = x.to(torch.float32)
    valid = torch.isfinite(xf) if mask is None else mask.to(x.device) & torch.isfinite(xf)
    rows = torch.where(valid, xf, torch.inf).reshape(-1, x.shape[-1]).contiguous()
    ranks = rank.to(device=x.device, dtype=torch.int32).reshape(-1, 1)
    return _select(rows, ranks).reshape(x.shape[:-1])


def masked_nearest_rank_percentile(
    x: torch.Tensor, mask: torch.Tensor | None, cnt: torch.Tensor, q: int
) -> torch.Tensor:
    """Nearest-rank ``q``-th percentile of the masked elements of ``x``
    (last axis), with ``cnt`` the number of valid elements of each row.
    Conventions of :func:`kth_smallest`: a masked or non-finite entry is not
    valid, a rank past the valid count takes the row's largest valid
    element, and a row with none gives +inf."""
    return _select_rows(x, nearest_rank_index(q, torch.as_tensor(cnt).to(x.device)), mask)


def percentile_all(x: torch.Tensor, q: int) -> torch.Tensor:
    """Nearest-rank ``q``-th percentile over the full last axis (a static
    rank; the clamp to each row's valid count as :func:`kth_smallest`'s)."""
    idx = static_nearest_rank_index(q, x.shape[-1])
    return _select_rows(x, torch.full(x.shape[:-1], idx, dtype=torch.int32, device=x.device), None)
