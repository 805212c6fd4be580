"""Exact distributed nearest-rank percentile: a key-space radix descent
with ``all_reduce``-d byte histograms.

Counterpart of ``stainx_tpu/parallel/percentile.py``. float32 values map
to their order-isomorphic uint32 keys
(:func:`~stainx_tpu_torch.kernels.selection.monotone_key`), and each of
exactly four levels counts the survivors' next key byte into 256 bins on
every rank, adds the counts over the group with one int32 ``all_reduce``
(integers: exact in any order), descends into the byte bucket that holds
the target rank and extends the carried prefix. After four levels the
prefix is the whole 32-bit key of the rank's element, and the value is its
inverse mapping: exact for any float32 data, ±inf and denormals included,
with no gather and no cap.

Several percentiles run together: ``x`` may be (K, P_local) with one rank
per row (flat ``q``), or each row may carry M ranks (nested ``q``) sharing
one descent over the same field, so a level costs one (K, M, 256) int32
``all_reduce``. Communication is one count ``all_reduce`` and four of the
level histograms, whatever the pixel count, the shard count and the data.

Each level's counts come from one ``index_add_`` over ``(row·M + m)·256 +
byte`` of the (K, M, P_local) survivor plane, so the (K, M, 256, P_local)
compare plane of the JAX expression is never written; nothing in the four
levels reads a value back to the host.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from stainx_tpu_torch.kernels.selection import monotone_key, unkey
from stainx_tpu_torch.ops.percentile import nearest_rank_index

_LEVELS = 4


def _rows_of_q(q, k_rows: int):
    """``(rows of M percentiles, M, nested)`` of a scalar, flat or nested ``q``."""
    if isinstance(q, (tuple, list)) and len(q) and isinstance(q[0], (tuple, list)):
        rows = tuple(tuple(row) for row in q)
        m_ranks = len(rows[0])
        if any(len(row) != m_ranks for row in rows):
            raise ValueError("nested q rows must all have the same length")
        nested = True
    else:
        rows = tuple((v,) for v in (tuple(q) if isinstance(q, (tuple, list)) else (q,)))
        m_ranks, nested = 1, False
    if len(rows) != k_rows:
        raise ValueError(f"{len(rows)} percentile rows for {k_rows} data rows")
    return rows, m_ranks, nested


def distributed_masked_percentile(
    x: torch.Tensor, mask: torch.Tensor | None, q, group=None
) -> torch.Tensor:
    """Global nearest-rank percentile(s) of the masked union of every
    rank's ``x`` over the process ``group`` (``None``: the default group).
    ``x`` and ``mask`` are this rank's shards, 1D (one field) or (K, P)
    rows. ``q`` forms:

    - a scalar (1D ``x``) → a scalar result;
    - a length-K flat sequence, one percentile per row → (K,);
    - a length-K sequence of equal-length-M sequences, M percentiles of
      EACH row sharing one descent → (K, M), or (M,) when ``x`` is 1D with
      one nested row (the Macenko α and 100−α pair of one angle field).

    ``mask=None`` means every element is valid. A row with no valid
    element anywhere in the group gives NaN. Counts and ranks are int32:
    exact up to 2³¹ − 1 pooled valid elements a row; past that the count
    wraps negative and the result is NaN, the documented ceiling.
    """
    single = x.dim() == 1
    x2 = (x[None] if single else x).to(torch.float32)
    m2 = None if mask is None else (mask[None] if single else mask).to(torch.bool)
    k_rows, p = x2.shape
    rows, m_ranks, nested = _rows_of_q(q, k_rows)
    dev = x2.device

    keys = monotone_key(x2)  # (K, P) int64 holding uint32 keys
    if m2 is None:
        cnt = torch.full((k_rows,), p, dtype=torch.int32, device=dev)
    else:
        cnt = m2.sum(-1, dtype=torch.int32)
    dist.all_reduce(cnt, group=group)
    qs = torch.tensor(rows, dtype=torch.float64, device=dev)  # (K, M)
    r = torch.zeros((k_rows, m_ranks), dtype=torch.int64, device=dev)
    for value in sorted({v for row in rows for v in row}):
        r = torch.where(qs == float(value), nearest_rank_index(value, cnt).to(torch.int64)[:, None], r)

    bins = k_rows * m_ranks * 256
    base = torch.arange(k_rows * m_ranks, dtype=torch.int64, device=dev).reshape(k_rows, m_ranks, 1)
    base = base * 256
    prefix = torch.zeros((k_rows, m_ranks), dtype=torch.int64, device=dev)
    for level in range(_LEVELS):
        shift = 24 - 8 * level
        top = (0xFFFFFFFF << (32 - 8 * level)) & 0xFFFFFFFF  # the bits chosen so far
        survivor = (keys & top)[:, None, :] == prefix[..., None]  # (K, M, P)
        if m2 is not None:
            survivor &= m2[:, None, :]
        byte = (keys >> shift) & 255
        idx = base + byte[:, None, :]
        hist = torch.zeros(bins, dtype=torch.int32, device=dev)
        hist.index_add_(0, idx.reshape(-1), survivor.reshape(-1).to(torch.int32))
        hist = hist.reshape(k_rows, m_ranks, 256)
        dist.all_reduce(hist, group=group)  # one (K, M, 256) collective a level
        c = torch.cumsum(hist, dim=-1, dtype=torch.int64)
        bsel = torch.clamp((c <= r[..., None]).sum(-1), max=255)
        below = torch.where(bsel > 0, c.gather(-1, (bsel - 1).clamp(min=0)[..., None])[..., 0], 0)
        prefix = prefix | (bsel << shift)
        r = r - below

    # Four byte levels consumed all 32 key bits: the prefix is the key.
    result = torch.where((cnt > 0)[:, None], unkey(prefix), torch.nan)
    if nested:
        return result[0] if single else result
    return result[0, 0] if single else result[:, 0]
