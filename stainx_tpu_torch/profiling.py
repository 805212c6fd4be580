"""Profiling and timing hooks: the port's one table of spans and counters.

Counterpart of ``stainx_tpu/profiling.py`` on ``torch.profiler`` and CUDA
events:

- :func:`trace`: a context manager around ``torch.profiler.profile`` that
  writes a trace of the block, which TensorBoard and Chrome's trace viewer
  load, into a directory;
- :func:`annotate`: a named span. With no profiler session running it
  reads one flag and returns a shared no-op; inside a session (:func:`trace`
  or any ``torch.profiler.profile``) it is a ``record_function`` on the
  profiler's clock, and it is also kept in memory (:func:`session`), with
  its parent, its call and, given a CUDA ``device``, its device interval;
- :func:`caller_timed`: a span whose device interval the caller's C code
  records, for an interval inside one C call;
- :func:`note`: adds arguments to the innermost open span, for what a span
  learns after it opened (a kernel's route);
- :func:`count`: adds to a process-wide counter (:func:`counters`), always
  on; inside a profiler session the count also lands in the session;
- :func:`session`: the most recent profiler session's spans and counts;
- :func:`time_fn`: seconds per iteration of a shape-preserving step, its
  iterations chained through their data. On a CUDA tensor it times with
  CUDA events on the current stream, on a CPU tensor with
  ``time.perf_counter``; it never uses the profiler, whose kernel times
  late in a long run fall below graph replay's, or to none.

A session starts at the first span or count seen with a profiler running
after one seen with none, and drops the previous session's records. A
call's spans share a call id, the index of its root span (the outermost
span of the port, which has no parent).

Spans of the port (a kernel span wraps the wrapper's checks, scratch,
route and cluster shape, and its C call; on a CPU tensor, the plain
version):

============================  ============================================  ===============
Span                          Where                                         Device interval
============================  ============================================  ===============
``stainx.forward``            ``StainNormalizerTransform.forward``          no
``stainx.fit``                ``fit`` of every normalizer; a batch-mode     yes
                              Macenko fit fused into the transform's
                              launch (``fit.fused``) opens it around
                              nothing on the card
``stainx.transform``          ``transform`` of every normalizer, before     yes
                              the ÷255 of ``normalize_to_0_1``
``stainx.finalize``           the eager ÷255 of ``normalize_to_0_1``, a     yes
                              sibling of ``stainx.transform``; absent
                              where the kernels' store does it
                              (``finalize.folded``)
``stainx.kernel.<K>``         each kernel wrapper, ``<K>`` one of B1, B2,   B1 only: its
                              B3, B4, B5, B6, B7a, B7b, B8a, B8b; ``B7``    launch alone,
                              (``reinhard_transfer``: B7b, B7a) and ``B8``  recorded inside
                              (``hm_transfer``: B8a, B8b) for one C call    the C call
                              that launches both; B1's is a
                              :func:`caller_timed` span
``stainx.stats``              the call-wide statistics a transform takes    yes, recorded
                              before it writes any output, in one C call    inside the C
                              on a CUDA tensor (:func:`caller_timed`):      call
                              Reinhard's B7b and its finalize in
                              ``reinhard_transfer``'s (a child of
                              ``stainx.kernel.B7``); histogram matching's
                              B8a and its LUT finalize in
                              ``hm_transfer``'s (a child of
                              ``stainx.kernel.B8``)
============================  ============================================  ===============

A kernel span's arguments name its ``route`` (B1: ``resident`` or ``l2``,
with ``blocks_per_sm``, the blocks of the launch one SM holds at once;
B4, B5: ``cluster``, with ``csize``, ``slice``, ``resident`` and
``keyfield``, the bytes of its key field (0 for uint8 rows and float32
rows held whole in shared memory), or ``stream``; B4 with the fit fused
in also ``fit_row``; B3: the cluster shape of its last launch).

Counters:

======================  ========================================================
Counter                 Counts
======================  ========================================================
``launch.<K>``          a wrapper's C calls that launch kernel ``<K>`` (B1, B2,
                        B3, B6, B7a, B7b, B8a, B8b); ``launch.B4.cluster``,
                        ``launch.B4.stream``, ``launch.B5.cluster`` and
                        ``launch.B5.stream`` by route. A CPU tensor runs the
                        plain versions and counts none.
``resident.B1``,        B1's launches by body: the image in a block's shared
``l2.B1``               memory, or re-read from L2 each pass (the same launches
                        as ``launch.B1``)
``keyfield.<K>``        B4's or B5's cluster-route C calls on float32 rows that
                        wrote a key field (pixels past the resident part of a
                        block's slice): ``keyfield.B4``, ``keyfield.B5``
``route.staged``        Macenko fits and transforms that took the staged route
                        (every dtype but uint8 and float32)
``finalize.folded``     transforms whose ÷255 of ``normalize_to_0_1`` the
                        kernels' store did (Macenko on float32 input on CUDA),
                        with no ``stainx.finalize`` span
``fit.fused``           batch-mode Macenko fits done inside the transform's
                        launch (``macenko_fit_transform_stream``: B4's cluster
                        route, every row resident at once); the forward's
                        ``stainx.fit`` span then holds no kernel
``lut.vector``          B8b launches (``apply_lut``, ``hm_transfer``) whose
                        planes run vectors (one 16-byte store of output each):
                        input and output line up and P ≥ 32
                        (``kernels.histogram.vector_aligned``); none for a
                        launch that goes byte by byte
``build.nvcc``          sources ``kernels.build_all`` compiled
``occupancy.query``     occupancies asked of the card, once a shape: B3's, B4's
                        and B5's clusters, B1's blocks an SM
======================  ========================================================

``build.nvcc`` and ``occupancy.query`` are for a slow set-up: read
:func:`counters` after the first calls to see which kernels were built or
asked again; a warm process adds to neither.

The launches of one call, from the counter deltas:

>>> before = profiling.counters("launch.")
>>> normalizer.transform(batch)
>>> {k: v - before.get(k, 0) for k, v in profiling.counters("launch.").items()
...  if v != before.get(k, 0)}
{'launch.B4.cluster': 1}

The spans of a call, inside any profiler session:

>>> with torch.profiler.profile():
...     transform(batch)
>>> [s.name for s in profiling.session().spans]
['stainx.forward', 'stainx.fit', 'stainx.kernel.B5', 'stainx.transform', ...]
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import threading
import time
from collections.abc import Callable
from dataclasses import dataclass, field

import torch
import torch.autograd.profiler as _autograd_profiler


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """Record the block's CPU activity (and the card's, where CUDA is
    available) and write it on exit as a ``*.pt.trace.json`` file into
    ``log_dir`` (default: ``stainx_trace`` under the temporary directory).
    Yields ``log_dir``. The port's spans are on inside it, as in any
    profiler session.

    >>> with profiling.trace("/path/to/trace"):
    ...     normalizer.transform(batch)
    """
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    log_dir = os.path.join(tempfile.gettempdir(), "stainx_trace") if log_dir is None else log_dir
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield log_dir
        if torch.cuda.is_available():
            torch.cuda.synchronize()


# ------------------------------------------------------------ spans, counts
@dataclass
class Span:
    """One span of a session. Times are ``time.perf_counter_ns``; ``parent``
    and ``call`` are indices into :attr:`Session.spans` (``call`` the root
    span's); ``device_ms`` is the device interval, where one was asked
    for, resolved when :func:`session` reads it."""

    name: str
    parent: int | None
    call: int
    args: dict
    start_ns: int = 0
    end_ns: int = 0
    device_ms: float | None = None

    @property
    def host_ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6


@dataclass
class Session:
    """The spans (in the order they opened) and counts of one profiler
    session."""

    spans: list = field(default_factory=list)
    counts: dict = field(default_factory=dict)
    events: list = field(default_factory=list)  # (span index, start, end) unresolved

    def roots(self) -> list:
        """The calls: the spans that have no parent."""
        return [s for s in self.spans if s.parent is None]

    def resolve(self) -> None:
        """Read each device interval whose end event has been recorded."""
        for i, start, end in self.events:
            end.synchronize()
            self.spans[i].device_ms = start.elapsed_time(end)
        self.events.clear()


_counters: dict[str, int] = {}
_count_lock = threading.Lock()
_session: Session | None = None
_session_on = False  # whether the last span or count saw a profiler running
_open = threading.local()  # .stack: the (session, index) of each open span


class _Off:
    """The span of a call with no profiler running: nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()


class _OffTimed(_Off):
    """The span of :func:`caller_timed` with no profiler running: enters as
    ``None``, so the caller makes its call untimed."""

    __slots__ = ()

    def __enter__(self):
        return None


_OFF_TIMED = _OffTimed()


def _current() -> Session:
    """The session a span or count seen with a profiler running lands in."""
    global _session, _session_on
    if not _session_on or _session is None:
        _session, _session_on = Session(), True
    return _session


def _stack() -> list:
    stack = getattr(_open, "stack", None)
    if stack is None:
        stack = _open.stack = []
    return stack


class _On:
    """A span inside a profiler session."""

    __slots__ = ("name", "args", "device", "caller", "record", "session", "index", "events")

    def __init__(self, name: str, args: dict | None, device, caller: bool = False):
        self.name, self.args, self.device = name, args, device
        self.caller = caller  # the caller records the device interval's events

    def __enter__(self):
        sess = _current()
        stack = _stack()
        parent = stack[-1][1] if stack and stack[-1][0] is sess else None
        self.session, self.index = sess, len(sess.spans)
        call = self.index if parent is None else sess.spans[parent].call
        span = Span(self.name, parent, call, dict(self.args or {}))
        sess.spans.append(span)
        stack.append((sess, self.index))
        text = ",".join(f"{k}={v}" for k, v in self.args.items()) if self.args else None
        self.record = torch.profiler.record_function(self.name, text)
        self.record.__enter__()
        self.events = None
        if self.device is not None and torch.device(self.device).type == "cuda":
            stream = torch.cuda.current_stream(self.device)
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True), stream)
            self.events[0].record(stream)
            if self.caller:
                self.events[1].record(stream)
        span.start_ns = time.perf_counter_ns()
        if self.caller:
            return None if self.events is None else (self.events[0].cuda_event,
                                                     self.events[1].cuda_event)
        return self

    def __exit__(self, *exc) -> bool:
        span = self.session.spans[self.index]
        span.end_ns = time.perf_counter_ns()
        if self.events is not None:
            start, end, stream = self.events
            if not self.caller:
                end.record(stream)
            self.session.events.append((self.index, start, end))
        self.record.__exit__(*exc)
        stack = _stack()
        if stack and stack[-1] == (self.session, self.index):
            stack.pop()
        return False


def annotate(name: str, *, args: dict | None = None, device=None):
    """A named span (context manager). With no profiler session running it
    reads one flag and returns a shared no-op, so a span costs well under a
    microsecond. Inside one it enters ``record_function(name)`` (``args``
    rendered as ``k=v,...``), on the profiler's clock, and keeps the span in
    :func:`session`: name, host start and end, parent span, call id and
    ``args``. With ``device`` a CUDA device it also records a CUDA event on
    that device's current stream as it opens and as it closes: the span's
    device interval, from the stream reaching the first event to the second,
    which covers the span's kernels wherever the stream is kept fed."""
    global _session_on
    if not _autograd_profiler._is_profiler_enabled:
        _session_on = False
        return _OFF
    return _On(name, args, device)


def caller_timed(name: str, device):
    """A span whose device interval the caller's own code records, for an
    interval that lies inside one C call, where no Python runs between the
    launches it holds. With no profiler session running it reads one flag
    and returns a shared no-op that enters as ``None``: the caller makes its
    call untimed. Inside one it opens the span ``name`` as :func:`annotate`
    does and, on a CUDA ``device``, enters as ``(start, end)``: the raw
    handles of two CUDA timing events of that device, made by recording each
    once on its current stream. The caller records both again on that stream,
    where the interval starts and where it ends, before the span closes; the
    span's device interval is read between them. On a CPU device it enters
    as ``None``."""
    global _session_on
    if not _autograd_profiler._is_profiler_enabled:
        _session_on = False
        return _OFF_TIMED
    return _On(name, None, device, caller=True)


def note(**args) -> None:
    """Add ``args`` to the innermost open span of this thread, inside a
    profiler session; nothing otherwise."""
    if _autograd_profiler._is_profiler_enabled:
        stack = _stack()
        if stack:
            sess, index = stack[-1]
            sess.spans[index].args.update(args)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the process-wide counter ``name``; inside a profiler
    session, to the session's count as well."""
    global _session_on
    with _count_lock:
        _counters[name] = _counters.get(name, 0) + n
        if _autograd_profiler._is_profiler_enabled:
            counts = _current().counts
            counts[name] = counts.get(name, 0) + n
        else:
            _session_on = False


def counters(prefix: str = "") -> dict[str, int]:
    """A copy of the process-wide counters whose names start with ``prefix``."""
    with _count_lock:
        return {k: v for k, v in _counters.items() if k.startswith(prefix)}


def session() -> Session | None:
    """The most recent profiler session (None before the first), its device
    intervals resolved: reading them waits for their end events."""
    if _session is not None:
        _session.resolve()
    return _session


def time_fn(step: Callable, init, iters: int = 10, warmup: int = 1) -> float:
    """Seconds per iteration of a shape-preserving ``step``.

    Iterations are chained through their data (each takes the previous
    one's output), and the result is ``min(run(1 + iters)) − min(run(1))``
    over ``iters``: the cost of starting and ending a run cancels. A run on
    a CUDA ``init`` is timed by CUDA events recorded on the current stream
    around it, so it covers all the device work it enqueued; on a CPU
    tensor by ``time.perf_counter``.
    """
    on_card = torch.is_tensor(init) and init.is_cuda
    y = init
    for _ in range(max(warmup, 1)):
        y = step(y)
    if on_card:
        torch.cuda.synchronize(init.device)

    def run(n: int) -> float:
        if on_card:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        else:
            t0 = time.perf_counter()
        v = init
        for _ in range(n):
            v = step(v)
        if on_card:
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / 1e3
        return time.perf_counter() - t0

    base = min(run(1) for _ in range(3))
    total = min(run(1 + iters) for _ in range(2))
    return max(total - base, 1e-12) / iters
