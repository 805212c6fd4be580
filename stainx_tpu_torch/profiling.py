"""Profiling and timing hooks: the port's one table of spans and counters.

Counterpart of ``stainx_tpu/profiling.py`` on ``torch.profiler`` and CUDA
events:

- :func:`trace`: a context manager around ``torch.profiler.profile`` that
  writes a trace of the block, which TensorBoard and Chrome's trace viewer
  load, into a directory;
- :func:`call`: the root span of a public call (``transform``,
  ``forward``), which also samples the call timeline;
- :func:`annotate`: a named span. With no profiler session running it
  reads one flag and returns a shared no-op (in a sampled call it keeps its
  host times in the timeline); inside a session (:func:`trace` or any
  ``torch.profiler.profile``) it is a ``record_function`` on the
  profiler's clock, and it is also kept in memory (:func:`session`), with
  its parent, its call and, given a CUDA ``device``, its device interval;
- :func:`caller_timed`: a span whose device interval the caller's C code
  records, for an interval inside one C call;
- :func:`launch_events`: the events a C call records around its launches
  in a sampled call;
- :func:`timeline`: the sampled calls, their launch intervals on the host's
  clock and the card's idle gaps between them, with no profiler;
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

A session span's device interval is read from two CUDA timing events made
for it; the timeline's launch intervals from the events of one pool a
device, made once at the first sampled call that launches and recorded
again :data:`EVENT_PAIRS` pairs later.

Spans of the port (a kernel span wraps the wrapper's checks, scratch,
route and cluster shape, and its C call; on a CPU tensor, the plain
version):

============================  ============================================  ===============
Span                          Where                                         Device interval
============================  ============================================  ===============
``stainx.forward``            ``StainNormalizerTransform.forward``, a       no
                              :func:`call`
``stainx.fit``                ``fit`` of every normalizer; a batch-mode     yes
                              Macenko fit fused into the transform's
                              launch (``fit.fused``) opens it around
                              nothing on the card
``stainx.transform``          ``transform`` of every normalizer, before     no
                              the ÷255 of ``normalize_to_0_1``; a
                              :func:`call` (outside a forward, the root)
``stainx.finalize``           the eager ÷255 of ``normalize_to_0_1``, a     no
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

The call timeline, always on: :func:`call` counts a thread's root calls,
and calls 0, 1 and 2 of every :data:`SAMPLE_EVERY` are sampled. A sampled
call keeps, in a ring of :data:`RING` calls made once, its root name, the
host open and close of its root span and of each span inside it
(``time.perf_counter_ns``) and whether a profiler session was running.
Calls 0 and 1, a pair, also keep launch events of the pool that their C
calls record just before their first launch and just after their last
(:func:`launch_events`): the card's idle between them and the second
call's launch interval. Call 2 records no event, so its host times are
free of their cost. The C calls that take the pair are
B1's (``stainx_macenko_transform_mega``), B4's cluster route and the
fused fit and transform (``stainx_cluster_run``,
``stainx_cluster_fit_transform``), Reinhard's transform
(``stainx_reinhard_transform``) and histogram matching's
(``stainx_hm_transform``). An unsampled call adds a counter step to the
root span and one flag read to each span inside it.

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

# Calls 0, 1 and 2 of every SAMPLE_EVERY root calls of a thread are sampled:
# over 300 pairs in the 7 300 or more calls of the slowest benchmark cell
# (2.8 s and more of 2 600 a second) that a traced run has after its
# profiled stretch; a ring of RING calls holds 10 s of the fastest cell's
# (14 500 sampled of 9 700 a second).
SAMPLE_EVERY = 20
RING = 15360  # sampled calls the ring keeps
RING_SPANS = 8  # spans inside a sampled call that the ring keeps
# Sampled pairs whose launch events a device's pool holds, three events each:
# the newest 1 024 pairs are read (2 s of the fastest benchmark cell, 8 s of
# the slowest); an older pair's events have been recorded again.
EVENT_PAIRS = 1024


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

    __slots__ = ("name", "args", "device", "caller", "launch", "record", "session", "index",
                 "events", "kept")

    def __init__(self, name: str, args: dict | None, device, caller: bool = False,
                 launch: bool = False):
        self.name, self.args, self.device = name, args, device
        self.caller = caller  # the caller records the device interval's events
        self.launch = launch  # ... around its launches: in a sampled pair also the timeline's

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
        self.kept = _keep_open(self.name) if _sampling and _calls.slot >= 0 else None
        self.events = None
        if self.device is not None and torch.device(self.device).type == "cuda":
            stream = torch.cuda.current_stream(self.device)
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True), stream)
            self.events[0].record(stream)
            if self.caller:
                self.events[1].record(stream)
                if self.launch:
                    _keep_launch(self.device, self.events)
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
        if self.kept is not None:
            _keep_close(self.kept)
        self.record.__exit__(*exc)
        stack = _stack()
        if stack and stack[-1] == (self.session, self.index):
            stack.pop()
        return False


def annotate(name: str, *, args: dict | None = None, device=None):
    """A named span (context manager). With no profiler session running it
    reads one flag and returns a shared no-op, so a span costs well under a
    microsecond; inside a sampled call (:func:`call`) it keeps its host open
    and close in the timeline. Inside a session it enters
    ``record_function(name)`` (``args`` rendered as ``k=v,...``), on the
    profiler's clock, and keeps the span in :func:`session`: name, host
    start and end, parent span, call id and ``args``. With ``device`` a CUDA
    device it also records a CUDA event on that device's current stream as
    it opens and as it closes: the span's device interval, from the stream
    reaching the first event to the second, which covers the span's kernels
    wherever the stream is kept fed."""
    global _session_on
    if not _autograd_profiler._is_profiler_enabled:
        _session_on = False
        if _sampling and _calls.slot >= 0:
            return _Kept(name)
        return _OFF
    return _On(name, args, device)


def caller_timed(name: str, device, launch: bool = False):
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
    as ``None``.

    ``launch`` True: the interval is the call's launches, in one C call.
    Inside a session in a sampled pair (:func:`call`) the timeline then
    keeps the span's events as the call's launch events; with no session
    the caller asks :func:`launch_events` itself."""
    global _session_on
    if not _autograd_profiler._is_profiler_enabled:
        _session_on = False
        if _sampling and _calls.slot >= 0:
            return _Kept(name, False)
        return _OFF_TIMED
    return _On(name, None, device, caller=True, launch=launch)


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


# -------------------------------------------------------- the event pools
class _Pool:
    """The timing events of one CUDA device: three a sampled pair, for
    :data:`EVENT_PAIRS` pairs (the first call's launch end, the second's
    launch start and end; their raw handles in ``handles``), made (recorded
    once, so they exist) when the pool is. ``hold_ms``: the card time one
    event adds between two kernels, measured at the first :func:`timeline`
    read."""

    def __init__(self, index: int):
        self.index = index
        with torch.cuda.device(index):
            stream = torch.cuda.current_stream(index)
            self.ring = [_made(stream) for _ in range(3 * EVENT_PAIRS)]
        self.handles = [e.cuda_event for e in self.ring]
        self.hold_ms = None


def _made(stream) -> torch.cuda.Event:
    e = torch.cuda.Event(enable_timing=True)
    e.record(stream)
    return e


_pools: dict[int, _Pool] = {}
_pool_lock = threading.Lock()

# The hold's measurement: a chain of HOLD_KERNELS kernels that fill the
# card, queued behind a spin of HOLD_SPIN cycles (~2 ms) so the card never
# waits for the host inside it.
HOLD_KERNELS = 64
HOLD_SPIN = 4_000_000


def _event_hold_ms(index: int) -> float:
    """The card time (ms) one timing event recorded between two kernels
    adds on a fed stream of device ``index``: a chain of kernels that fill
    the card (a 16 MiB fill each), timed with an event recorded after each
    kernel and without, the least of three runs each, the difference over
    the chain's length."""
    with torch.cuda.device(index):
        stream = torch.cuda.current_stream(index)
        x = torch.empty(1 << 22, device=torch.device("cuda", index))
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(HOLD_KERNELS)]

        def chain(marked: bool) -> float:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(HOLD_SPIN)
            start.record(stream)
            for e in marks:
                x.zero_()
                if marked:
                    e.record(stream)
            end.record(stream)
            end.synchronize()
            return start.elapsed_time(end)

        chain(True)  # the events made, the fill loaded
        plain = min(chain(False) for _ in range(3))
        marked = min(chain(True) for _ in range(3))
    return (marked - plain) / HOLD_KERNELS


def _cuda_index(device) -> int | None:
    """The index of a CUDA ``device`` (the current one where it names
    none), None for another device."""
    if device.__class__ is not torch.device:
        device = torch.device(device)
    if device.type != "cuda":
        return None
    return torch.cuda.current_device() if device.index is None else device.index


def _pool(index: int) -> _Pool:
    pool = _pools.get(index)
    if pool is None:
        with _pool_lock:
            pool = _pools.get(index)
            if pool is None:
                pool = _pools[index] = _Pool(index)
    return pool


# ------------------------------------------------------------ the timeline
class _Calls(threading.local):
    """A thread's root calls: ``state`` is their count modulo SAMPLE_EVERY
    plus _NEST for each root span open that may hold others, one number so
    that an unsampled call reads and writes it once; ``slot`` the ring slot
    of the open sampled call (-1: none); ``pair`` the number of the sampled
    pair its last call 0 began."""

    state = 0
    slot = -1
    pair = 0


class _Ring:
    """The sampled calls, slot ``seq % RING`` for the ``seq``-th; a slot's
    spans at ``slot * RING_SPANS`` on, ``inner`` the innermost open one."""

    def __init__(self, n: int, spans: int):
        self.next = self.pairs = 0  # calls and pairs sampled so far
        self.seq, self.root, self.pair = [-1] * n, [None] * n, [0] * n
        self.phase, self.profiled = [0] * n, [False] * n
        self.open_ns, self.close_ns, self.c_open_ns = [0] * n, [0] * n, [0] * n
        self.device, self.launches, self.nspans, self.inner = [-1] * n, [0] * n, [0] * n, [-1] * n
        self.held = [None] * n  # a launch span's own (start, end) in a session
        self.span_name, self.span_parent = [None] * (n * spans), [-1] * (n * spans)
        self.span_open, self.span_close = [0] * (n * spans), [0] * (n * spans)


_calls = _Calls()
_ring: _Ring | None = None
_ring_lock = threading.Lock()
_sampling = 0  # sampled calls open, over all threads
_now = time.perf_counter_ns

_NEST = 64  # a power of two above SAMPLE_EVERY


class _Depth:
    """The root span of an unsampled call with no profiler running that may
    hold other calls' root spans: the thread's depth, nothing else."""

    __slots__ = ()

    def __enter__(self):
        _calls.state += _NEST
        return self

    def __exit__(self, *exc) -> bool:
        _calls.state -= _NEST
        return False


_DEPTH = _Depth()


class _Root:
    """The root span of a sampled call (``phase``: 0 and 1 the sampled
    pair, 2 the call after it), or of any call inside a profiler session."""

    __slots__ = ("name", "phase", "on", "slot")

    def __init__(self, name: str, phase: int | None):
        self.name, self.phase = name, phase

    def __enter__(self):
        global _ring, _sampling
        th = _calls
        th.state += _NEST
        on = self.on = None
        if _autograd_profiler._is_profiler_enabled:
            on = self.on = _On(self.name, None, None)
            on.__enter__()
        if self.phase is None:
            return self
        with _ring_lock:
            ring = _ring
            if ring is None:
                ring = _ring = _Ring(RING, RING_SPANS)
            seq = ring.next
            ring.next = seq + 1
            if self.phase == 0:
                th.pair = ring.pairs
                ring.pairs += 1
            _sampling += 1
        k = self.slot = th.slot = seq % RING
        ring.seq[k], ring.root[k], ring.pair[k] = seq, self.name, th.pair
        ring.phase[k], ring.profiled[k] = self.phase, on is not None
        ring.device[k] = ring.inner[k] = -1
        ring.launches[k] = ring.nspans[k] = ring.close_ns[k] = 0
        ring.held[k] = None
        ring.open_ns[k] = _now()
        return self

    def __exit__(self, *exc) -> bool:
        global _sampling
        if self.phase is not None:
            _ring.close_ns[self.slot] = _now()
            _calls.slot = -1
            with _ring_lock:
                _sampling -= 1
        if self.on is not None:
            self.on.__exit__(*exc)
        _calls.state -= _NEST
        return False


def call(name: str, *, outer: bool = False):
    """The root span of a public call (``transform``, ``forward``): a span
    as :func:`annotate`'s, which also counts the thread's calls for the
    timeline (:func:`timeline`). Calls 0, 1 and 2 of every
    :data:`SAMPLE_EVERY` are sampled: kept in the ring with their spans'
    host times; 0 and 1, a pair, with their launch events, 2 with none. ``outer``: the call may make
    other public calls (``forward`` calls ``fit`` and ``transform``), whose
    root spans are then plain spans and count nothing; a sampled call and
    any call in a profiler session are outer anyway. An unsampled call with
    no profiler running steps a counter and returns a shared no-op."""
    global _session_on
    th = _calls
    state = th.state
    if state >= _NEST:
        return annotate(name)
    th.state = state + 1 if state < SAMPLE_EVERY - 1 else 0
    if not _autograd_profiler._is_profiler_enabled:
        _session_on = False
        if state > 2:
            return _DEPTH if outer else _OFF
    elif state > 2:
        return _Root(name, None)
    return _Root(name, state)


def _keep_open(name: str) -> int:
    """Keep a span that opens inside this thread's sampled call; returns its
    place in the ring (-1 past RING_SPANS)."""
    k = _calls.slot
    ring = _ring
    i = ring.nspans[k]
    if i >= RING_SPANS:
        return -1
    j = k * RING_SPANS + i
    ring.nspans[k] = i + 1
    ring.span_name[j], ring.span_parent[j], ring.span_close[j] = name, ring.inner[k], 0
    ring.inner[k] = i
    ring.span_open[j] = _now()
    return j


def _keep_close(j: int) -> None:
    if j >= 0:
        ring = _ring
        ring.span_close[j] = _now()
        ring.inner[j // RING_SPANS] = ring.span_parent[j]


class _Kept:
    """A span inside a sampled call with no profiler running: its host
    times kept in the slot. Enters as itself, or as None
    (:func:`caller_timed`)."""

    __slots__ = ("name", "enters", "j")

    def __init__(self, name: str, enters: bool = True):
        self.name, self.enters = name, enters

    def __enter__(self):
        self.j = _keep_open(self.name)
        return self if self.enters else None

    def __exit__(self, *exc) -> bool:
        _keep_close(self.j)
        return False


def _launch(device):
    """``(pool, start, end)`` for a C call on ``device`` in this thread's
    sampled call: the places in the pool's ring of the events it records,
    ``start`` -1 for none (all but the first C call of a pair's second
    call); None outside a pair, on a device other than CUDA, or on another
    device than the call's first C call's."""
    k = _calls.slot
    if k < 0:
        return None
    ring = _ring
    phase = ring.phase[k]
    if phase == 2:
        return None
    index = _cuda_index(device)
    if index is None:
        return None
    launches = ring.launches[k]
    if launches == 0:
        ring.device[k] = index
        ring.c_open_ns[k] = _now()
    elif ring.device[k] != index:
        return None
    ring.launches[k] = launches + 1
    q = 3 * (ring.pair[k] % EVENT_PAIRS)
    if phase == 0:
        return _pool(index), -1, q
    return _pool(index), q + 1 if launches == 0 else -1, q + 2


def _keep_launch(device, events) -> None:
    """In a sampled pair inside a session: the two events of a launch span
    (:func:`caller_timed`), which its one C call records, are the call's
    launch events. They stay the session's, so no lap of the pool records
    them again before the session is read."""
    if _sampling and _launch(device) is not None:
        _ring.held[_calls.slot] = events[:2]


def launch_events(device):
    """The two event handles a C call on CUDA ``device`` records around its
    launches: ``launch_start`` on its stream just before its first launch
    and ``launch_end`` just after its last, each where not null; None with
    no sampled call open (one flag read), and the C call gets two nulls.

    A sampled pair records three events: the first call's ``launch_end``,
    the second call's ``launch_start`` and ``launch_end``; the call after
    the pair records none, so its host times hold none of their cost. Each
    event on the stream holds the card up for about 3 µs (it waits for the
    work before it; :attr:`Sampled.hold_ms`); the first call's start would
    add a third wait a pair and tells nothing the second call's interval
    does not. So the first call's C
    calls get ``(None, end)``; the second call's first C call gets
    ``(start, end)``, a later one ``(None, end)``: the interval runs from
    the first C call's launches to the last's."""
    if not _sampling:
        return None
    found = _launch(device)
    if found is None:
        return None
    pool, start, end = found
    return pool.handles[start] if start >= 0 else None, pool.handles[end]


def _anchor(index: int, tries: int = 5) -> tuple:
    """``(event, host_ns)``: an event on device ``index``'s current stream
    and the host time it completed. The host polls it (a wait would wake
    tens of µs late) and keeps, of ``tries``, the one whose record and
    completion lay closest together."""
    with torch.cuda.device(index):
        stream = torch.cuda.current_stream(index)
        stream.synchronize()
        best = None
        for _ in range(tries):
            anchor = torch.cuda.Event(enable_timing=True)
            before = _now()
            anchor.record(stream)
            while not anchor.query():
                pass
            after = _now()
            if best is None or after - before < best[2] - best[1]:
                best = (anchor, before, after)
    return best[0], best[2]


@dataclass
class Sampled:
    """One sampled call of :func:`timeline`. Host times are
    ``time.perf_counter_ns``; ``launch`` is the launch interval put on that
    clock, ``(start_ns, end_ns)`` (a pair's first call records its end
    alone: ``(None, end_ns)``); ``launch_ms``, ``gap_ms`` and ``period_ms``
    are read between the events themselves. ``spans``: ``(name, open_ns,
    close_ns, parent)``, ``parent`` the index of the enclosing span in the
    list or None."""

    seq: int  # the process's sampled calls before it
    pair: int  # the number of its sampled pair (phase 2: the pair before it)
    phase: int  # 0 and 1: the pair's first and second call; 2: the call after it
    root: str
    profiled: bool  # a profiler session was running as it opened
    open_ns: int
    close_ns: int
    spans: list
    c_open_ns: int | None = None  # host time its first C call with launch events was entered
    launch: tuple | None = None
    launch_ms: float | None = None  # a pair's second call: its launch interval
    gap_ms: float | None = None  # second call: the card idle from the first's launch end
    period_ms: float | None = None  # second call: gap_ms + launch_ms, launch end to launch end
    hold_ms: float | None = None  # with a launch: the card time one of its events adds


def timeline() -> list:
    """The sampled calls in the ring, oldest first: :class:`Sampled` each.

    A call's ``phase`` is 0 or 1 in a sampled pair, 2 for the call after
    it, which records no event: its spans' host times are the wrappers'
    own (a pair's C calls each record one or two events, about 15 µs of
    host each on a busy stream).

    Call it after draining the card (``torch.cuda.synchronize``): it
    records an anchor event on each pool's device, polls it until it has
    completed, reads ``time.perf_counter_ns``, and puts every launch event
    on that host clock, the clock of the spans (``torch.profiler``'s trace
    is on the Unix clock: a constant apart, which a root span, in both,
    gives). A pair's second call carries its launch interval (``launch``,
    ``launch_ms``), from its first C call's ``launch_start`` to its last
    one's ``launch_end``: its kernels on a stream kept fed; ``gap_ms``, the
    card's idle between the two calls (from the first call's ``launch_end``
    to its own ``launch_start``); and ``period_ms``, the gap and its launch
    interval (launch end to launch end: one call's cycle). A call still
    open, one whose events have not completed or have been recorded again
    (its pair older than the newest :data:`EVENT_PAIRS`), and a CPU call
    have no interval.

    The events' own cost is in what they read: on a fed stream each event
    holds the card for ``hold_ms`` (about 3 µs), measured on the device at
    its first read (a chain of kernels with an event after each and
    without, ~20 ms). A gap holds one event (the second call's start) and
    an interval one (its end): ``gap_ms - hold_ms`` is the idle the events
    did not make, ``launch_ms - hold_ms`` the kernels with their launches,
    and over many pairs the sum of ``gap_ms - hold_ms`` over the sum of
    ``period_ms - 2 * hold_ms`` is the card's idle share with no profiler
    running and no events.

    What the host did in a gap: the gap's midpoint on the host clock
    against the pair's host times: between the first call's root close and
    the second's root open the caller ran (no span of the port open); in a
    root span, its kernel span (``stainx.kernel.*``, wrapper), or from the
    kernel span's C call (``c_open_ns``) to its close.
    ``tools/probe_tracing.py window`` prints that split for a benchmark
    cell.

    Cost: a sampled pair (in every :data:`SAMPLE_EVERY` calls) records
    three events on the stream (:func:`launch_events`) and three calls keep
    a few dozen numbers each; an unsampled call steps a counter. The pool's
    3 × :data:`EVENT_PAIRS` events are made at the first sampled call that
    launches, never later."""
    ring = _ring
    if ring is None:
        return []
    for index, pool in list(_pools.items()):
        if pool.hold_ms is None:
            pool.hold_ms = _event_hold_ms(index)
    anchors = {index: _anchor(index) for index in list(_pools)}
    out, firsts = [], {}
    for seq in range(max(ring.next - RING, 0), ring.next):
        k = seq % RING
        if ring.seq[k] != seq or ring.close_ns[k] == 0:
            continue
        base = k * RING_SPANS
        spans = [(ring.span_name[base + i], ring.span_open[base + i], ring.span_close[base + i],
                  None if ring.span_parent[base + i] < 0 else ring.span_parent[base + i])
                 for i in range(ring.nspans[k])]
        call = Sampled(seq, ring.pair[k], ring.phase[k], ring.root[k], ring.profiled[k],
                       ring.open_ns[k], ring.close_ns[k], spans)
        start = end = None
        if ring.launches[k] and ring.device[k] in anchors and call.phase < 2:
            pool = _pools[ring.device[k]]
            q = 3 * (call.pair % EVENT_PAIRS)
            if ring.held[k] is not None:
                start, end = ring.held[k]
            elif call.pair >= ring.pairs - EVENT_PAIRS:
                start, end = pool.ring[q + 1], pool.ring[q + 2 * call.phase]
            if call.phase == 0:
                start = None
            if end is not None and end.query():
                anchor, host_ns = anchors[ring.device[k]]
                call.c_open_ns, call.hold_ms = ring.c_open_ns[k], pool.hold_ms
                call.launch = (None if start is None
                               else host_ns - start.elapsed_time(anchor) * 1e6,
                               host_ns - end.elapsed_time(anchor) * 1e6)
                if start is not None:
                    call.launch_ms = start.elapsed_time(end)
            else:
                start = end = None
        if call.phase == 0:
            firsts[call.pair] = end
        elif start is not None and firsts.get(call.pair) is not None:
            call.gap_ms = firsts[call.pair].elapsed_time(start)
            call.period_ms = call.gap_ms + call.launch_ms
        out.append(call)
    return out


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
