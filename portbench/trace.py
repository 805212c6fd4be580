"""The traced run: one steady stretch of the window under ``torch.profiler``.

The stretch opens ``start_after`` seconds into the window and lasts
``length`` seconds and at least ``MIN_CALLS`` calls; a profiler session at
set-up (:meth:`Stretch.prime`) has loaded CUPTI before. The device is
drained (synchronised) as it opens and as it closes, so every kernel and
copy inside it belongs to a call issued inside it, and the device time per
call is attributed exactly. The host's
spans are the benchmark's own ``record_function`` annotations around its
calls into the program (``api.transform``, ``api.forward``) and its waits
(``loop.wait``), on the profiler's clock.

A stretch whose profile holds no device kernel is taken again, up to
``ATTEMPTS`` times in the window (a profiler session late in a long
process has been seen to record nothing); :attr:`Stretch.record` stays
``None`` if none holds one, and the run fails.
"""

from __future__ import annotations

import bisect
import contextlib
import time
from collections import defaultdict
from dataclasses import dataclass

from torch.autograd import DeviceType

ATTEMPTS = 3
MIN_CALLS = 8
TOP = 10
_NULL = contextlib.nullcontext()


@dataclass
class Record:
    calls: int  # timed calls issued inside the stretch
    stretch_s: float  # the stretch's wall time, on the profiler's clock
    busy_s: float  # union of the device's kernel, copy and memset intervals
    kernel_s: float  # sum of kernel durations
    device_ops: list  # [[name, seconds], ...], the most time first
    idle_gaps: list  # [[host span, seconds of device idle under it], ...]


class NoTrace:
    """The untraced run's stand-in: no profiler, no spans."""

    record = None

    def tick(self, elapsed: float, calls: int) -> None:
        pass

    def span(self, name: str):
        return _NULL

    def in_stretch(self) -> bool:
        return False

    def close(self, calls: int) -> None:
        pass


class Stretch(NoTrace):
    def __init__(self, start_after: float, length: float, sync):
        self.start_after, self.length, self.sync = start_after, length, sync
        self.state, self.attempts = "before", 0
        self.record = None

    def tick(self, elapsed: float, calls: int) -> None:
        if self.state == "before" and elapsed >= self.start_after:
            self._open(calls)
        elif (self.state == "on" and calls - self.first >= MIN_CALLS
              and time.perf_counter() - self.opened >= self.length):
            self._close(calls, elapsed)

    def span(self, name: str):
        if self.state != "on":
            return _NULL
        from torch.profiler import record_function

        return record_function(name)

    def in_stretch(self) -> bool:
        return self.state == "on"

    def close(self, calls: int) -> None:
        if self.state == "on":
            self._close(calls, None)

    def prime(self, work) -> None:
        """Run ``work`` under a profiler session at set-up: the first session
        of a process loads CUPTI, which takes seconds, and would otherwise
        land in the window."""
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            work()
            self.sync()

    def _open(self, calls: int) -> None:
        from torch.profiler import ProfilerActivity, profile, record_function

        self.sync()
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.outer = record_function("stretch")
        self.outer.__enter__()
        self.first, self.opened, self.state = calls, time.perf_counter(), "on"
        self.attempts += 1

    def _close(self, calls: int, elapsed: float | None) -> None:
        self.sync()
        self.outer.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        record = parse(self.prof.profiler.kineto_results.events(), calls - self.first)
        self.prof = self.outer = None
        if record.kernel_s > 0 and record.calls > 0:
            self.record, self.state = record, "done"
        elif elapsed is not None and self.attempts < ATTEMPTS:
            self.start_after, self.state = elapsed + 0.2, "before"
        else:
            self.state = "done"


def _union(intervals: list, lo: int, hi: int) -> tuple[int, list]:
    """Total covered ns of ``intervals`` clipped to [lo, hi], and the gaps."""
    covered, gaps, cursor = 0, [], lo
    for start, end in sorted(intervals):
        start, end = max(start, lo), min(end, hi)
        if end <= cursor:
            continue
        if start > cursor:
            gaps.append((cursor, start))
            cursor = start
        covered += end - cursor
        cursor = end
    if cursor < hi:
        gaps.append((cursor, hi))
    return covered, gaps


def _host_span(spans: list, starts: list, t: int) -> str:
    """The innermost benchmark span that holds host time ``t``."""
    best, i = None, bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - 8, -1), -1):
        name, start, end = spans[j]
        if start <= t <= end and (best is None or end - start < best[1]):
            best = (name, end - start)
    return best[0] if best else "host"


def _kind(e, annotations: set) -> str:
    """``annotation``, ``kernel``, ``memcpy``, ``memset`` or ``other``: the
    device's events are told apart by name, and the device-side copies of
    the benchmark's annotations are left out."""
    if e.device_type() == DeviceType.CPU:
        return "annotation" if e.is_user_annotation() else "other"
    name = e.name()
    if e.is_user_annotation() or name in annotations:
        return "other"
    if name.startswith("Memcpy"):
        return "memcpy"
    return "memset" if name.startswith("Memset") else "kernel"


def parse(events, calls: int) -> Record:
    """A :class:`Record` from the profiler's raw (kineto) events."""
    events = list(events)
    annotations = {e.name() for e in events
                   if e.device_type() == DeviceType.CPU and e.is_user_annotation()}
    stretch, spans, device = None, [], []
    for e in events:
        kind = _kind(e, annotations)
        if kind == "annotation":
            if e.name() == "stretch":
                stretch = (e.start_ns(), e.end_ns())
            else:
                spans.append((e.name(), e.start_ns(), e.end_ns()))
        elif kind != "other":
            device.append((kind, e.name(), e.start_ns(), e.end_ns()))
    if stretch is None:
        return Record(calls, 0.0, 0.0, 0.0, [], [])
    lo, hi = stretch
    busy, gaps = _union([(s, t) for _, _, s, t in device], lo, hi)
    by_name: dict[str, int] = defaultdict(int)
    kernel_ns = 0
    for kind, name, s, t in device:
        by_name[name] += t - s
        kernel_ns += (t - s) if kind == "kernel" else 0
    spans.sort(key=lambda s: s[1])
    starts = [s[1] for s in spans]
    idle: dict[str, int] = defaultdict(int)
    for a, b in gaps:
        idle[_host_span(spans, starts, (a + b) // 2)] += b - a
    return Record(calls, (hi - lo) / 1e9, busy / 1e9, kernel_ns / 1e9, _top(by_name), _top(idle))


def _top(ns_by_name: dict) -> list:
    """The ``TOP`` largest entries, as [name, seconds], the largest first."""
    ranked = sorted(ns_by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return [[name, ns / 1e9] for name, ns in ranked]
