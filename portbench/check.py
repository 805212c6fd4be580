"""The comparison that decides ``correct``.

Each item is one fit the program made and some of the outputs it produced
on that fit, at the timed sizes. The reference works the fit out again
from the same input and transforms the same rows; the numbers are the
largest gaps over all items, and each is held to its limit from the
configuration (``limits``). A number that is not finite fails.

The reference module's ``STATISTICS`` says how its transform reads a call:
``"image"``, each output row depends on its own input row and the fit
alone (Macenko), so the checked rows are transformed by themselves;
``"call"``, the transform takes statistics over the call's whole input
(Reinhard, histogram matching), so the reference transforms the whole call
and its checked rows are compared.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

# Rows an ``"image"`` reference transforms at a time, so that its float32
# temporaries stay a few hundred MB at the largest tiles.
BLOCK_ROWS = 16


@dataclass
class Item:
    fit_input: np.ndarray  # the images the fit read, (N, 3, H, W)
    program_state: dict  # the program's fitted state, as numpy arrays
    call_input: np.ndarray  # the whole input of the checked call, (B, 3, H, W)
    rows: np.ndarray  # the indices of the checked rows in it, sorted
    program_rows: np.ndarray  # the program's outputs for them


def reference_rows(item: Item, reference, state: dict, **kwargs):
    """The reference's outputs of ``item``'s checked rows on ``state``, as
    ``(where, outputs)`` pairs, ``where`` the slice of the checked rows they
    are: an ``"image"`` reference transforms blocks of ``BLOCK_ROWS`` rows by
    themselves, a ``"call"`` reference the call's whole input at once.
    ``kwargs`` go to its ``transform``."""
    if reference.STATISTICS == "call":
        if len(item.rows):
            yield slice(None), reference.transform(item.call_input, state, **kwargs)[item.rows]
        return
    for lo in range(0, len(item.rows), BLOCK_ROWS):
        where = slice(lo, lo + BLOCK_ROWS)
        yield where, reference.transform(item.call_input[item.rows[where]], state, **kwargs)


def gaps(items: list[Item], reference, full_scale: float) -> dict[str, float]:
    """The largest gaps between the program and the reference: those of the
    fit (the reference module's ``state_gaps``), and of the outputs in grey
    levels of 255 (``out_max``, and ``out_mae`` over every checked value)."""
    found: dict[str, float] = {}
    total, count, worst = 0.0, 0, 0.0
    for item in items:
        ref_state = reference.fit(item.fit_input)
        for name, value in reference.state_gaps(item.program_state, ref_state).items():
            found[name] = max(found.get(name, 0.0), value) if math.isfinite(value) else math.nan
        for where, ref in reference_rows(item, reference, ref_state):
            prog = item.program_rows[where].astype(np.float64) * (255.0 / full_scale)
            diff = np.abs(prog - ref.astype(np.float64))
            total += float(diff.sum())
            count += diff.size
            worst = max(worst, float(diff.max())) if np.isfinite(diff).all() else math.nan
    found["out_max"] = worst
    found["out_mae"] = total / count if count else math.nan
    return found


def judge(found: dict[str, float], limits: dict[str, float]) -> tuple[bool, dict]:
    """(every limited number within its limit, ``{name: {"value", "limit"}}``
    for the limited numbers, in the order of ``limits``)."""
    checks = {name: {"value": found.get(name, math.nan), "limit": limit}
              for name, limit in limits.items()}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks


def lines(checks: dict) -> list[str]:
    """One line a number: its name, value, limit and verdict."""
    return [f"check {name} {c['value']!r} limit {c['limit']!r} "
            f"{'ok' if math.isfinite(c['value']) and c['value'] <= c['limit'] else 'FAIL'}"
            for name, c in checks.items()]
