"""The port's call timeline (``stainx_tpu_torch/profiling.py``: ``call``,
``launch_events``, ``timeline``): on the CPU, which calls are sampled, the
ring's fixed size, an unsampled call's cost in memory, the profiler flag and
a CPU call's record; on the card, each benchmark cell's call shape under a
profiler against the profiler's own trace (the shared clock) and each C call
that records launch events giving the same outputs with them and without.

The card tests run on a card's machine with ``pytest --noconftest -p
no:cacheprovider -m cuda tests/test_torch_timeline.py``, where JAX is absent."""

from __future__ import annotations

import bisect
import statistics
import threading
import time
import tracemalloc

import pytest
import torch
from torch.autograd import DeviceType

from stainx_tpu_torch import Macenko, StainNormalizerTransform, profiling
from stainx_tpu_torch.testing import synthetic_he_batch

EVERY = profiling.SAMPLE_EVERY


def _sampled_since(seq: int) -> list:
    return [c for c in profiling.timeline() if c.seq >= seq]


def _next_seq() -> int:
    ring = profiling._ring
    return 0 if ring is None else ring.next


def _empty_call():
    with profiling.call("stainx.transform"):
        with profiling.annotate("stainx.kernel.B4"):
            pass


@pytest.fixture
def batch():
    return torch.as_tensor(synthetic_he_batch(2, 16, 16, seed=3))


# ------------------------------------------------------------------- CPU
def test_three_in_every_sample_every_root_calls():
    """4·SAMPLE_EVERY root calls from a fresh thread: calls 0, 1 and 2 of
    each SAMPLE_EVERY are kept: a pair of consecutive calls, then one more."""
    seq0, found = _next_seq(), []

    def run():
        for i in range(4 * EVERY):
            with profiling.call("stainx.transform"):
                found.append(i)

    t = threading.Thread(target=run)
    t.start()
    t.join()
    calls = _sampled_since(seq0)
    assert len(calls) == 12 and len(found) == 4 * EVERY
    assert [c.phase for c in calls] == [0, 1, 2] * 4
    pairs = [c.pair for c in calls]
    assert pairs == [pairs[0] + i // 3 for i in range(12)]
    assert all(c.root == "stainx.transform" and c.open_ns <= c.close_ns for c in calls)


def test_calls_inside_a_forward_are_not_counted(batch):
    """A batch-mode forward calls fit and transform: only ``stainx.forward``
    counts, and its sampled record holds the inner spans."""
    module = StainNormalizerTransform("macenko", mode="batch", device="cpu")
    profiling._calls.state = 0
    seq0 = _next_seq()
    for _ in range(EVERY + 3):
        module(batch)
    calls = _sampled_since(seq0)
    assert [c.root for c in calls] == ["stainx.forward"] * 6
    assert [c.phase for c in calls] == [0, 1, 2] * 2
    names = [s[0] for s in calls[0].spans]
    assert names[:2] == ["stainx.fit", "stainx.kernel.B2"] and "stainx.transform" in names
    assert profiling._calls.state == 3  # no depth left open, three calls into the cycle


def test_the_ring_stays_the_same_size_past_its_length():
    profiling._calls.state = 0
    for _ in range(profiling.RING // 3 * EVERY + 3 * EVERY):
        _empty_call()
    ring = profiling._ring
    calls = profiling.timeline()
    assert len(calls) == profiling.RING
    assert [c.seq for c in calls] == list(range(ring.next - profiling.RING, ring.next))
    assert len(ring.seq) == len(ring.open_ns) == profiling.RING
    assert len(ring.span_open) == profiling.RING * profiling.RING_SPANS
    assert all(len(c.spans) == 1 for c in calls)


def test_an_unsampled_call_allocates_nothing():
    _empty_call()  # the ring is made
    where = [tracemalloc.Filter(True, profiling.__file__)]
    profiling._calls.state = 3
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot().filter_traces(where)
        for _ in range(EVERY - 3):
            _empty_call()
        after = tracemalloc.take_snapshot().filter_traces(where)
    finally:
        tracemalloc.stop()
    assert profiling._calls.state == 0
    grown = [d for d in after.compare_to(before, "lineno") if d.size_diff > 0]
    assert grown == []


def test_calls_under_a_profiler_are_flagged(batch):
    normalizer = Macenko(device="cpu").fit(batch[:1])
    profiling._calls.state = 0
    seq0 = _next_seq()
    normalizer.transform(batch)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        normalizer.transform(batch)
    normalizer.transform(batch)
    profiling._calls.state = 0
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        normalizer.transform(batch)
    normalizer.transform(batch)
    assert [c.profiled for c in _sampled_since(seq0)] == [False, True, False, True, False]
    # A call ran between the two sessions: the second one holds its call alone.
    assert [s.name for s in profiling.session().roots()] == ["stainx.transform"]


def test_a_cpu_call_records_host_times_and_no_events(batch):
    normalizer = Macenko(device="cpu").fit(batch[:1])
    profiling._calls.state = 0
    seq0 = _next_seq()
    for _ in range(3):
        normalizer.transform(batch)
    first, second, third = _sampled_since(seq0)
    for c in (first, second, third):
        assert c.launch is None and c.launch_ms is None and c.c_open_ns is None
        (name, opened, closed, parent), = [s for s in c.spans if s[0].startswith("stainx.kernel")]
        assert name == "stainx.kernel.B1" and c.open_ns < opened <= closed < c.close_ns
    assert second.gap_ms is None and second.period_ms is None
    assert profiling._pools == {}


def test_a_profiled_span_has_no_device_interval_off_the_card(batch):
    """The session's transform and finalize spans hold no device interval
    any more: on the CPU no span asks the pool for events."""
    module = StainNormalizerTransform("macenko", mode="batch", device="cpu")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        module(batch.float() / 255.0)
    sess = profiling.session()
    assert all(s.device_ms is None for s in sess.spans) and sess.events == []
    assert profiling.launch_events("cpu") is None and profiling._pools == {}


# ------------------------------------------------------------------ card
def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the launch events are recorded by the C calls")
    return torch.device("cuda", 0)


def _cells(dev):
    """Each benchmark cell's call on two batches of its shape, and the
    kernels a call launches: ``(name, call, batches, kernels)``."""
    from portbench import gen
    from stainx_tpu_torch import HistogramMatching, Reinhard

    g = gen.torch_generator(gen.seed_streams(3200000001, 1)[0], dev)

    def tiles(n, s, dtype="uint8"):
        return gen.tiles(n, (3, s, s), dtype, (0.85, 1.15), g)

    yield "store", Macenko(device=dev).fit(tiles(1, 256)).transform, [tiles(128, 256)
                                                                      for _ in range(2)], 1
    train = StainNormalizerTransform("macenko", mode="batch", batch_ref_index=0, device=dev)
    yield "train", train, [tiles(128, 256, "float32") for _ in range(2)], 1
    yield "reinhard", Reinhard(device=dev).fit(tiles(1, 512)).transform, [tiles(128, 512)
                                                                          for _ in range(2)], 3
    yield "hm", HistogramMatching(device=dev).fit(tiles(1, 512)).transform, [
        tiles(256, 512) for _ in range(2)], 3
    yield "patch", Macenko(device=dev).fit(tiles(1, 96)).transform, [tiles(512, 96)
                                                                     for _ in range(2)], 1


def _run(call, batches, seconds: float, dev, least: int = 0) -> int:
    """Calls back to back for ``seconds`` and at least ``least`` calls, at
    most 16 ahead of the card."""
    marks = [torch.cuda.Event() for _ in range(16)]
    i, t0 = 0, time.perf_counter()
    while time.perf_counter() - t0 < seconds or i < least:
        if i >= 16:
            marks[i % 16].synchronize()
        call(batches[i % len(batches)])
        marks[i % 16].record()
        i += 1
    torch.cuda.synchronize(dev)
    return i


def _against_trace(name, call, batches, per_call: int, dev) -> dict:
    """0.3 s of ``call`` under a profiler, and at least 64 sampled pairs:
    the sampled calls against the trace.

    A call's kernels are the trace's kernels whose launch (by the trace's
    correlation) lies in the call's root span as the trace has it: the
    session's roots and the trace's in order, so no clock decides it. The
    trace is on the Unix clock; the median over the root spans, in both,
    gives its offset from ``perf_counter_ns``."""
    from torch.profiler import ProfilerActivity, profile

    call(batches[0])  # a call off the profiler: the session below starts anew
    torch.cuda.synchronize(dev)
    seq0 = _next_seq()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        ran = _run(call, batches, 0.3, dev, least=64 * EVERY)
    sampled = [c for c in _sampled_since(seq0) if c.profiled]
    calls = [c for c in sampled if c.launch is not None]
    roots = profiling.session().roots()
    events = list(prof.profiler.kineto_results.events())
    marks = sorted((e.start_ns(), e.end_ns()) for e in events
                   if e.device_type() == DeviceType.CPU and e.is_user_annotation()
                   and e.name() == roots[0].name)
    assert len(marks) == len(roots), (len(marks), len(roots))
    clock = statistics.median(m[0] - s.start_ns for m, s in zip(marks, roots))
    launched = {e.correlation_id(): e.start_ns() for e in events
                if e.device_type() == DeviceType.CPU and e.name().startswith("cudaLaunch")}
    kernels = sorted((launched[e.correlation_id()], e.start_ns(), e.end_ns())
                     for e in events if e.device_type() == DeviceType.CUDA
                     and not e.is_user_annotation() and e.correlation_id() in launched)
    hosts = [k[0] for k in kernels]
    starts = [s.start_ns for s in roots]
    # The trace's own clocks, a call at a time: its kernels' least latency
    # from their launch calls, and how long after its last kernel ended the
    # host's wait for it (``_run``'s event wait 16 calls on) returned.
    waits = sorted(e.end_ns() for e in events if e.device_type() == DeviceType.CPU
                   and e.name() == "cudaEventSynchronize")
    paired = len(waits) == len(marks) - 16
    bracket = []
    for j, (lo, hi) in enumerate(marks):
        own = kernels[bisect.bisect_left(hosts, lo):bisect.bisect_right(hosts, hi)]
        if own:
            done = max(k[2] for k in own)
            wake = (waits[j] - done) / 1e3 if paired and j < len(waits) else None
            bracket.append((min(k[1] - k[0] for k in own) / 1e3, wake))
    half = len(bracket) // 2
    bracket = [(min(b[0] for b in part), min((b[1] for b in part if b[1] is not None),
                                             default=None))
               for part in (bracket[:half], bracket[half:]) if part]
    offsets, ends, entered = [], [], []
    for c in calls:
        lo, hi = marks[bisect.bisect_right(starts, c.open_ns) - 1]
        own = kernels[bisect.bisect_left(hosts, lo):bisect.bisect_right(hosts, hi)]
        assert len(own) == per_call, (name, c.seq, len(own))
        ends.append((c.launch[1] + clock - max(t for _, _, t in own)) / 1e3)
        first = c.launch[0] if c.launch[0] is not None else c.launch[1]
        entered.append((first - c.c_open_ns) / 1e3)
        if c.launch[0] is not None:
            offsets.append((min(s for _, s, _ in own) - (c.launch[0] + clock)) / 1e3)
    assert len(offsets) >= 8, (name, ran, len(sampled), len(calls), len(offsets))
    q, r, e = max(len(offsets) // 4, 1), max(len(ends) // 4, 1), max(len(entered) // 4, 1)
    return {"trace_bracket_us": bracket,
            "end_median_us": statistics.median(ends),
            "end_drift_us": statistics.median(ends[-r:]) - statistics.median(ends[:r]),
            "median_us": statistics.median(offsets),
            "drift_us": statistics.median(offsets[-q:]) - statistics.median(offsets[:q]),
            "entry_drift_us": statistics.median(entered[-e:]) - statistics.median(entered[:e]),
            "n": len(offsets),
            "start_to_first_kernel_us_p10": statistics.quantiles(offsets, n=10)[0],
            "end_after_last_kernel_us_p10": statistics.quantiles(ends, n=10)[0],
            "c_call_to_first_event_us_min": min(entered)}


def _agrees(f: dict) -> bool:
    return (f["start_to_first_kernel_us_p10"] > -20 and f["end_after_last_kernel_us_p10"] > -20
            and abs(f["end_median_us"]) < 20 and abs(f["end_drift_us"]) < 20)


def _trace_holds(f: dict) -> bool:
    """The trace's card times agree with its own host times, whatever the
    timeline reads. In each half of the session: no kernel starts before
    its launch call began, and no wait for a call's kernels returns before
    the last of them ended (10 µs spare each); and one of the two is tight,
    within 50 µs: where the card waits for the host a kernel starts soon
    after its launch call, where the host waits for the card its wait
    returns soon after the kernel's end. A trace whose card times sit off
    its host times, or drift so over the session, fails one half."""
    halves = f["trace_bracket_us"]
    return len(halves) == 2 and all(
        launch >= -10 and (wake is None or wake >= -10)
        and (launch <= 50 or (wake is not None and wake <= 50)) for launch, wake in halves)


@pytest.mark.cuda
def test_the_timeline_and_the_profilers_trace_share_a_clock():
    """Each cell's call, 0.3 s of calls under a profiler. On the host's
    clock every sampled call's first launch event comes after the host
    entered the C call, in every session. Against the profiler's trace, in
    every session whose trace holds together by its own clocks
    (:func:`_trace_holds`, which reads nothing of the timeline): nine in
    ten sampled pairs' launch events hold the kernels their calls launched
    (to 20 µs), the median offset from a sampled call's ``launch_end`` to
    its last kernel's end is under 20 µs, and it drifts by under 20 µs
    from the first quarter of the session to the last. The end event is
    queued behind the kernels, so its offset is the clocks' alone; the
    start offset (printed) also holds, on a starved stream, the launch
    call's own time, which the profiler's callbacks lengthen: the card
    reaches ``launch_start`` before the host has launched the kernel. Sessions run until
    two hold together, at most six a cell; the ones dropped are printed."""
    dev = _card()
    found = {}
    for name, call, batches, per_call in _cells(dev):
        tries = found[name] = []
        while len(tries) < 6 and sum(map(_trace_holds, tries)) < 2:
            tries.append(_against_trace(name, call, batches, per_call, dev))
            assert tries[-1]["c_call_to_first_event_us_min"] > 0, (name, tries[-1])
    for name, tries in found.items():
        dropped = sum(not _trace_holds(f) for f in tries)
        print(name, f"{dropped} of {len(tries)} sessions dropped", tries)
    for name, tries in found.items():
        kept = [f for f in tries if _trace_holds(f)]
        assert kept, (name, tries)
        assert all(_agrees(f) for f in kept), (name, kept)


@pytest.mark.cuda
def test_the_c_calls_give_the_same_outputs_with_launch_events_and_without():
    """Each C call that takes the launch events: a sampled pair (events
    recorded), the call after it and an unsampled call (nulls) write the
    same bits; the pair's second call reads its interval, its gap and its
    period; the call after the pair records no event."""
    dev = _card()
    for name, call, batches, _ in _cells(dev):
        x = batches[0]
        profiling._calls.state = 3
        plain = call(x)
        profiling._calls.state = 0
        seq0 = _next_seq()
        outs = [call(x) for _ in range(3)]
        torch.cuda.synchronize(dev)
        a, b, c = _sampled_since(seq0)
        assert all(torch.equal(out, plain) for out in outs), name
        assert a.launch_ms is None and a.launch[0] is None and b.launch_ms > 0, name
        assert 0 <= b.gap_ms < b.period_ms and a.launch[1] <= b.launch[0] < b.launch[1], name
        assert c.launch is None and c.c_open_ns is None, name
        del plain, outs
