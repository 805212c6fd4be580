"""Exact nearest-rank percentiles on tensors.

Counterpart of ``stainx_tpu/ops/percentile.py``. The rank formula is ported
bit for bit: the 0-based index ``round(0.01·q·(n−1))`` with
round-half-to-even, clamped at 0, in integer arithmetic that cannot overflow
int32. Selection itself is the plain version of the CUDA kernels' radix
select: sort the monotone integer keys of each row and read the key at the
rank. The result is always an actual element of the row.
"""

from __future__ import annotations

import torch

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
    # ops.macenko imports this module: import it at the call.
    from stainx_tpu_torch.ops import macenko

    xf = x.to(torch.float32)
    valid = torch.isfinite(xf) if mask is None else mask.to(x.device) & torch.isfinite(xf)
    rows = torch.where(valid, xf, torch.inf).reshape(-1, x.shape[-1]).contiguous()
    ranks = rank.to(device=x.device, dtype=torch.int32).reshape(-1, 1)
    return macenko._select(rows, ranks).reshape(x.shape[:-1])


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
