"""The program's own call timeline, read over the traced run's window after
its profiled stretch.

The port samples one pair of consecutive calls in every few with no
profiler running, and the call after it (``stainx_tpu_torch.profiling.timeline()``):
each sampled call's root span, its spans' host times and whether a profiler
session was running; a pair's second call also its launch interval,
recorded by its C calls on CUDA events, the card's idle gap since the first
call's launches ended, and the period (that gap and the interval). The
call after the pair records no event, so its host times are the
wrappers' own. The readers here take the sampled calls of the cell's own root span
(``stainx.transform``, or ``stainx.forward`` for a cell that calls the
module) after the last one recorded under a profiler: in a traced run, the
part of the window after the stretch. A program without that timeline, or a
run with no such call, gives nothing to read.
"""

from __future__ import annotations

KERNEL = "stainx.kernel."
_last: tuple = (None, None)  # (run, the program's timeline), read once a run


def root_of(config: dict) -> str:
    """The program's root span of the call a configuration drives."""
    call = config["call"]
    return "stainx.forward" if call == "__call__" else f"stainx.{call}"


def _program_timeline():
    try:
        from stainx_tpu_torch import profiling
    except ImportError:
        return None
    read = getattr(profiling, "timeline", None)
    return read() if read is not None else None


def of(run):
    """The sampled calls of the cell's root after the last profiled sampled
    call, oldest first, or None."""
    global _last
    if _last[0] is not run:
        _last = (run, _program_timeline())
    calls = _last[1]
    if not calls:
        return None
    last = max((i for i, c in enumerate(calls) if c.profiled), default=-1)
    root = root_of(run.cell.config)
    mine = [c for c in calls[last + 1:] if c.root == root]
    return mine or None


def pairs(calls: list) -> list:
    """The second calls of the pairs whose both calls are in ``calls`` and
    whose gap and period were read."""
    firsts = {c.pair for c in calls if c.phase == 0}
    return [c for c in calls if c.phase == 1 and c.pair in firsts
            and c.gap_ms is not None and c.period_ms is not None]


def unmarked(calls: list) -> list:
    """The calls that recorded no launch event (each after a pair)."""
    return [c for c in calls if c.phase == 2]


def wrapper_ms(call) -> float:
    """Host ms in a sampled call's outermost kernel spans."""
    spans = call.spans
    return sum((close - opened) / 1e6 for name, opened, close, parent in spans
               if name.startswith(KERNEL)
               and (parent is None or not spans[parent][0].startswith(KERNEL)))
