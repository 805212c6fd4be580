"""Closed loop: batches from a device-resident pool, issued back to back.

Traffic parameters: ``batch`` (tiles a call), ``pool_batches`` (distinct
batches made at set-up and cycled in order), ``in_flight`` (calls issued
ahead of the device: before call i the host waits for call i - in_flight to
finish, as a pipeline with that many output buffers would; the host never
blocks inside a launch, so its time in the program is its own),
``check_batches`` and ``check_rows`` (the sample the reference checks).

The program's output of each pool batch's last call, and in configurations
that fit every batch its fitted state, are kept for the check. The window
ends with the device drained; its rate is all pixels of all calls over all
of its time.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

from portbench import check, gen
from portbench.records import Window


@dataclass
class State:
    pool: list
    batch: int
    in_flight: int
    check_rows: int
    check_batches: int
    last: list = field(default_factory=list)
    last_call: list = field(default_factory=list)
    states: list = field(default_factory=list)


def prepare(job, cell, streams, seconds: float) -> State:
    t, c = cell.traffic, cell.config
    g = gen.torch_generator(streams["inputs"], job.device)
    pool = gen.tile_batches(t["pool_batches"], t["batch"], c["tile"], c["dtype"],
                            c["stain_scale"], g)
    n = len(pool)
    return State(pool, t["batch"], t["in_flight"], t["check_rows"], t["check_batches"],
                 [None] * n, [-1] * n, [None] * n)


def _issue(job, st: State, i: int) -> None:
    slot = i % len(st.pool)
    st.last[slot] = job.call(st.pool[slot])
    st.last_call[slot] = i
    if job.fits_per_batch:
        st.states[slot] = job.state()


def warm(job, st: State) -> None:
    """One pass over the pool, keeping outputs as the window does, so the
    allocator holds every block the window uses."""
    for i in range(len(st.pool)):
        _issue(job, st, i)
    job.sync()
    st.last_call = [-1] * len(st.pool)


def run(job, st: State, seconds: float, tracer) -> Window:
    events = job.events(st.in_flight)
    host = []
    calls = 0
    t0 = time.perf_counter()
    while True:
        elapsed = time.perf_counter() - t0
        if elapsed >= seconds:
            break
        tracer.tick(elapsed, calls)
        if events and calls >= st.in_flight:
            with tracer.span("loop.wait"):
                events[calls % st.in_flight].synchronize()
        with tracer.span(job.span):
            a = time.perf_counter()
            _issue(job, st, calls)
            b = time.perf_counter()
        if not tracer.in_stretch():
            host.append(b - a)
        if events:
            events[calls % st.in_flight].record()
        calls += 1
    tracer.close(calls)
    job.sync()
    took = time.perf_counter() - t0
    _, h, w = job.config["tile"]
    return Window(calls, 0, took, calls * st.batch * h * w, np.array(host))


def check_items(job, st: State, stream, program: bool = True) -> list:
    """The sample the reference checks, drawn from ``stream``: the last
    calls in the window of ``check_batches`` pool batches, each with the fit
    it used, and ``check_rows`` rows of the first of them (every row where
    that is the batch, so a fault in any one answer of a call shows). Each
    item carries its call's whole input and the indices of its checked rows
    in it (none for the other batches, which are checked by their fits). With
    ``program`` False, the inputs alone, for the control."""
    slots = [s for s in range(len(st.pool)) if st.last_call[s] >= 0 or not program]
    pick_slots, pick_rows = stream.spawn(2)
    chosen = np.asarray(slots)[gen.sample(len(slots), st.check_batches, pick_slots)]
    rows = gen.sample(st.batch, st.check_rows, pick_rows)
    to_np = lambda t: t.detach().cpu().numpy()  # noqa: E731
    items = []
    for i, s in enumerate(chosen):
        take = rows if i == 0 else rows[:0]
        if job.fits_per_batch:
            fit_input = to_np(job.fit_rows(st.pool[s]))
            state = {k: to_np(v) for k, v in st.states[s].items()} if program else None
        else:
            fit_input, state = job.fit_input, job.fit_state if program else None
        items.append(check.Item(fit_input, state, to_np(st.pool[s]), take,
                                to_np(st.last[s][take]) if program else None))
    return items
