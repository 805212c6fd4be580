"""The port's table of spans and counters (``stainx_tpu_torch/profiling.py``)
on the CPU: the gate that keeps a span free with no profiler running, the
spans and counts a profiler session keeps, and the spans of the public
calls. The device intervals need a card; here their resolution is held on
stand-in events."""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType

from stainx_tpu_torch import Macenko, StainNormalizerTransform, profiling
from stainx_tpu_torch.kernels import selection as sel
from stainx_tpu_torch.testing import synthetic_he_batch

# The spans of one batch-mode Macenko forward, in the order they open, and
# each one's parent (by index).
FORWARD_SPANS = ["stainx.forward", "stainx.fit", "stainx.kernel.B2", "stainx.transform",
                 "stainx.kernel.B1", "stainx.finalize"]
FORWARD_PARENTS = [None, 0, 1, 0, 3, 0]


@pytest.fixture
def batch():
    return torch.as_tensor(synthetic_he_batch(4, 64, 64, seed=3)).to(torch.float32) / 255.0


@pytest.fixture
def transform():
    return StainNormalizerTransform("macenko", mode="batch", device="cpu")


def _off():
    """A span with no profiler running: the next one seen with a profiler
    opens a new session."""
    with profiling.annotate("stainx.test.off"):
        pass


def _profiled(fn):
    _off()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    return prof, profiling.session()


def test_off_annotate_is_one_shared_no_op_and_leaves_the_session(transform, batch):
    _profiled(lambda: transform(batch))
    sess = profiling.session()
    spans = list(sess.spans)
    a, b = profiling.annotate("stainx.a"), profiling.annotate("stainx.b", device="cpu")
    assert a is b
    with a as entered:
        assert entered is a
    transform(batch)
    assert profiling.session() is sess and sess.spans == spans


def test_spans_are_user_annotations_with_parents_and_call_ids(transform, batch):
    prof, sess = _profiled(lambda: (transform(batch), transform(batch)))
    names = [s.name for s in sess.spans]
    assert names == FORWARD_SPANS * 2
    assert [s.parent for s in sess.spans] == FORWARD_PARENTS + [
        None if p is None else p + 6 for p in FORWARD_PARENTS]
    assert [s.call for s in sess.spans] == [0] * 6 + [6] * 6
    assert [s.name for s in sess.roots()] == ["stainx.forward"] * 2
    for s in sess.spans:
        assert 0 < s.start_ns <= s.end_ns and s.device_ms is None  # no card: no interval
        if s.parent is not None:
            parent = sess.spans[s.parent]
            assert parent.start_ns <= s.start_ns and s.end_ns <= parent.end_ns
    events = prof.profiler.kineto_results.events()
    user = [e.name() for e in events
            if e.device_type() == DeviceType.CPU and e.is_user_annotation()]
    assert sorted(user) == sorted(names)


def test_a_second_session_clears_the_first(transform, batch):
    _, first = _profiled(lambda: transform(batch))
    _, second = _profiled(lambda: Macenko(device="cpu").fit(batch[:1]))
    assert second is not first and profiling.session() is second
    assert [s.name for s in second.spans] == ["stainx.fit", "stainx.kernel.B2"]


def test_counts_land_in_the_process_table_and_in_the_session():
    before = profiling.counters("stainx.test.")
    profiling.count("stainx.test.off", 2)
    _, sess = _profiled(lambda: (profiling.count("stainx.test.on"),
                                 profiling.count("stainx.test.on", 3)))
    assert sess.counts == {"stainx.test.on": 4}
    after = profiling.counters("stainx.test.")
    assert after["stainx.test.off"] - before.get("stainx.test.off", 0) == 2
    assert after["stainx.test.on"] - before.get("stainx.test.on", 0) == 4
    assert set(profiling.counters("stainx.test.on")) == {"stainx.test.on"}


def test_note_adds_to_the_innermost_open_span():
    def work():
        with profiling.annotate("stainx.outer", args={"a": 1}):
            with profiling.annotate("stainx.inner"):
                profiling.note(route="cluster", csize=8)
            profiling.note(b=2)

    profiling.note(ignored=True)  # no profiler, no open span: nothing
    _, sess = _profiled(work)
    assert [(s.name, s.args) for s in sess.spans] == [
        ("stainx.outer", {"a": 1, "b": 2}), ("stainx.inner", {"route": "cluster", "csize": 8})]


def test_device_intervals_resolve_when_the_session_is_read():
    class Event:
        def __init__(self, t):
            self.t, self.waited = t, False

        def synchronize(self):
            self.waited = True

        def elapsed_time(self, end):
            return end.t - self.t

    sess = profiling.Session()
    sess.spans.append(profiling.Span("stainx.fit", None, 0, {}))
    start, end = Event(1.0), Event(1.25)
    sess.events.append((0, start, end))
    sess.resolve()
    assert end.waited and sess.spans[0].device_ms == 0.25 and sess.events == []


def test_kernel_span_of_a_wrapper_on_the_cpu():
    x = torch.rand(3, 300)
    ranks = torch.tensor([[1], [7], [299]], dtype=torch.int32)
    before = profiling.counters("launch.")
    _, sess = _profiled(lambda: sel.kth_smallest_pallas(x, ranks))
    assert [s.name for s in sess.spans] == ["stainx.kernel.B3"]
    assert profiling.counters("launch.") == before  # the plain version launches nothing


def test_staged_route_is_counted():
    x = torch.as_tensor(synthetic_he_batch(2, 32, 32, seed=4)).to(torch.bfloat16) / 255.0
    before = profiling.counters("route.").get("route.staged", 0)
    normalizer = Macenko(device="cpu").fit(x[:1])
    assert profiling.counters("route.")["route.staged"] == before + 1
    normalizer.transform(x)
    assert profiling.counters("route.")["route.staged"] == before + 2
    u8 = (x.float() * 255).to(torch.uint8)
    Macenko(device="cpu").fit(u8[:1]).transform(u8)  # the kernels' route
    assert profiling.counters("route.")["route.staged"] == before + 2


def test_trace_turns_the_spans_on(tmp_path, transform, batch):
    _off()
    with profiling.trace(str(tmp_path / "trace")):
        transform(batch)
    assert [s.name for s in profiling.session().spans] == FORWARD_SPANS


def test_annotate_off_costs_under_a_microsecond():
    """The gate: one flag read and a shared no-op, against the ~8 µs of a
    ``record_function`` with no profiler."""
    n = 20_000

    def per_span() -> float:
        t0 = time.perf_counter()
        for _ in range(n):
            with profiling.annotate("stainx.kernel.B4"):
                pass
        t1 = time.perf_counter()
        for _ in range(n):
            pass
        return ((t1 - t0) - (time.perf_counter() - t1)) / n

    best = min(per_span() for _ in range(5))
    assert best < 1e-6, f"annotate with no profiler took {best * 1e6:.2f} us a span"


def test_outputs_do_not_change_under_the_profiler(transform, batch):
    off = transform(batch)
    _, _ = _profiled(lambda: None)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        on = transform(batch)
    np.testing.assert_array_equal(off.numpy(), on.numpy())
