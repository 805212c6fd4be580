#!/usr/bin/env python3
"""The port's spans, counters and call timeline on a CUDA card: what a traced
run's session and timeline hold, the host's time a call by layer, and what
a span and the timeline's sampling cost.

Run from the root of a checkout on a machine with one CUDA card and nvcc:

    python3 tools/probe_tracing.py session CELL SEED SECONDS
    python3 tools/probe_tracing.py window CELL SEED SECONDS [BIN_S]
    python3 tools/probe_tracing.py split [SECONDS]
    python3 tools/probe_tracing.py cost
    python3 tools/probe_tracing.py off [ROUNDS]

- ``session``: one traced ``portbench`` run of the cell in this process,
  then ``stainx_tpu_torch.profiling.session()`` beside the run's notes: the
  root spans against ``traced_calls``, each span's host time and device
  interval per call (means, and the device intervals' quartiles with the
  first call left out), the session's counts, its ``launch.*`` counts per
  call and the kernel spans' route arguments, the ``finalize.folded`` count
  per call (the ÷255 of ``normalize_to_0_1`` done in the kernels' store)
  and, for the cells whose transform takes statistics over the call
  (``reinhard-u8-512.store``: B7b and its finalize;
  ``hm-u8-512.store-b256``: B8a and its LUT finalize), the ``stainx.stats``
  spans per call under ``per_call``: one a call, with a device interval;
  and for B4 and B5, the share of rows whose cluster-route angle selections
  settled two digits in their first pass (``RowParams.two_digit``) in the
  last call of each kind (``two_digit``: ``B4`` its rows, ``B4.fit`` the
  fused fit's row, ``B5`` the pool's row; null where none ran), read after
  the run and a sync of its own.
- ``window``: one traced ``portbench`` run of the cell in this process,
  then ``stainx_tpu_torch.profiling.timeline()``: the run's metrics and
  notes; the sampled pairs after the stretch and the events' hold; the
  card's idle in their gaps (as read, the events' hold in each)
  split by what the host was doing at each gap's midpoint (``caller``: no
  span of the port open, between the pair's calls; ``root span``: the
  public API's own code; ``kernel wrapper``: a ``stainx.kernel.*`` span
  before its C call; ``C call``: from the C call's entry to the kernel
  span's close; ``host ahead``: after the pair's second call returned, the
  host in later calls or waiting on the card); and the whole window's
  sampled calls in bins of ``BIN_S`` seconds (default 0.25): calls, how
  many under the profiler, mean launch interval, gap and period, and the
  rate the periods give.
- ``split``: no profiler. The host's time a call in each layer of the two
  cells' calls (the API call, ``fit``, ``Macenko.transform``,
  ``Macenko._finalize_range``, the B4 and B5 wrappers and B4 with the fit
  fused in, which a ``.train`` forward calls in place of both), each timed by
  ``perf_counter_ns`` around the layer's function, in a closed loop over
  the cells' batches with their calls in flight (16 and 4); medians in ms.
  A layer's time holds its children's: ``transform`` holds the B4 wrapper
  and the ÷255 where it divides (``_finalize_range``; none where the
  kernels' store does it).
- ``cost``: the time the first sampled call takes to make the event pool
  (s), the card time an event holds (``hold_ms``, three readings), and the
  host's cost, in µs, of a span (with and without a device
  interval), a ``caller_timed`` span, a root span (``profiling.call``) with
  a kernel span and ``launch_events`` inside, in a sampled pair and
  unsampled, a count, a ``record_function``, a CUDA event pair and
  ``torch.cuda.current_stream``, with no profiler running and inside a
  ``torch.profiler`` session; then the patch cell's call (512×3×96² uint8,
  16 in flight, 3 s) timed on the host call by call: the median of the
  pairs' calls, of the calls after them and of the others, and the means
  of all and of the unsampled ones, in ms.
- ``off``: what the spans and counts cost the cells' calls with no profiler,
  in one process: 1 s rounds (default 10) that alternate the real
  ``annotate``, ``note`` and ``count`` with stubs that do nothing (each
  still a call); the median host time a call of each, per round.

Each prints one JSON line a result, then the card's name. Imports no JAX and
nothing of ``stainx_tpu``.
"""

from __future__ import annotations

import functools
import json
import os
import statistics
import sys
import time
from types import SimpleNamespace

STARTED = time.perf_counter()
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from stainx_tpu_torch import profiling  # noqa: E402

DEV = torch.device("cuda", 0)


def _keep_row_params(ms) -> tuple[dict, object]:
    """Wraps ``ms._run`` so that it keeps, by reference, the RowParams of
    the last call of each kind (``B4``, ``B4.fit``: a fused fit's own row,
    ``B5``), for :func:`two_digit_shares`; returns them and the original."""
    run, kept = ms._run, {}

    def keeping(images, out, *args, fit_into=None, **kwargs):
        params = run(images, out, *args, fit_into=fit_into, **kwargs)
        kept["B4" if out is not None else "B5"] = params
        if fit_into is not None:
            kept["B4.fit"] = fit_into[None]
        return params

    ms._run = keeping
    return kept, run


def two_digit_shares(kept: dict, ms) -> dict:
    """The share of each kept call's rows with ``two_digit`` set."""
    torch.cuda.synchronize()
    return {kind: (float(kept[kind][:, ms.TWO_DIGIT_COLUMN].mean()) if kind in kept else None)
            for kind in ("B4", "B4.fit", "B5")}


def session(cell_name: str, seed: int, seconds: float) -> dict:
    from portbench import harness, spec
    from stainx_tpu_torch.kernels import macenko_stream as ms

    torch.set_num_threads(1)
    kept, run = _keep_row_params(ms)
    try:
        res = harness.run_cell(spec.cell(cell_name), seed, seconds, True, DEV, STARTED)
    finally:
        ms._run = run
    sess = profiling.session()
    calls = len(sess.roots())
    per_call, quartiles = {}, {}
    for name in dict.fromkeys(s.name for s in sess.spans):
        spans = [s for s in sess.spans if s.name == name]
        dev = [s.device_ms for s in spans if s.device_ms is not None]
        per_call[name] = {"spans": len(spans) / calls,
                          "host_ms": sum(s.host_ms for s in spans) / calls,
                          "device_ms": sum(dev) / calls if dev else None}
        if len(dev) > 4:
            quartiles[name] = statistics.quantiles(dev[1:], n=4)
    return {"cell": cell_name, "seed": seed, "correct": res["correct"], "roots": calls,
            "traced_calls": res["notes"].get("traced_calls"),
            "busy_ms_per_call": res["notes"].get("busy_ms_per_call"),
            "finalize_folded_per_call": sess.counts.get("finalize.folded", 0) / calls,
            "launches_per_call": {k: v / calls for k, v in sess.counts.items()
                                  if k.startswith("launch.")},
            "per_call": per_call, "device_ms_quartiles": quartiles, "counts": sess.counts,
            "kernel_args": sorted({json.dumps(s.args, sort_keys=True) for s in sess.spans
                                   if s.name.startswith("stainx.kernel.") and s.args}),
            "two_digit": two_digit_shares(kept, ms),
            "metrics": {k: v["value"] for k, v in res["metrics"].items()},
            "idle_gaps": res.get("breakdown", {}).get("idle_gaps"),
            "traced_mpix_per_s": res["notes"].get("traced_mpix_per_s")}


def _doing(first, second, t: float) -> str:
    """What the host was doing at host time ``t`` in the gap between a
    sampled pair's launches."""
    if first.close_ns < t < second.open_ns:
        return "caller"
    for c in (first, second):
        if c.open_ns <= t <= c.close_ns:
            for name, opened, closed, parent in c.spans:
                if name.startswith("stainx.kernel.") and opened <= t <= closed:
                    c_call = c.c_open_ns is not None and opened <= c.c_open_ns <= t
                    return "C call" if c_call else "kernel wrapper"
            return "root span"
    return "host ahead" if t > second.close_ns else "before the pair"


def window(cell_name: str, seed: int, seconds: float, bin_s: float) -> dict:
    from portbench import harness, spec
    from portbench import timeline as readers

    torch.set_num_threads(1)
    cell = spec.cell(cell_name)
    res = harness.run_cell(cell, seed, seconds, True, DEV, STARTED)
    calls = profiling.timeline()
    after = readers.of(SimpleNamespace(cell=cell)) or []
    firsts = {c.pair: c for c in after if c.phase == 0}
    idle: dict[str, float] = {}
    for c in readers.pairs(after):
        first = firsts[c.pair]
        mid = (first.launch[1] + c.launch[0]) / 2
        kind = _doing(first, c, mid)
        idle[kind] = idle.get(kind, 0.0) + c.gap_ms
    gaps = sum(idle.values())
    _, h, w = cell.config["tile"]
    pixels = cell.traffic["batch"] * h * w
    t0 = min(c.open_ns for c in calls) if calls else 0
    bins: dict[int, list] = {}
    for c in calls:
        bins.setdefault(int((c.open_ns - t0) / 1e9 / bin_s), []).append(c)

    def mean(values):
        values = [v for v in values if v is not None]
        return statistics.fmean(values) if values else None

    series = []
    for b, found in sorted(bins.items()):
        period = mean(c.period_ms for c in found)
        series.append({"t_s": b * bin_s, "calls": len(found),
                       "profiled": sum(c.profiled for c in found),
                       "launch_ms": mean(c.launch_ms for c in found),
                       "gap_ms": mean(c.gap_ms for c in found), "period_ms": period,
                       "mpix_per_s": pixels / period / 1e3 if period else None})
    return {"window": cell_name, "seed": seed, "correct": res["correct"],
            "metrics": {k: v["value"] for k, v in res["metrics"].items()},
            "notes": {k: res["notes"].get(k) for k in ("kernel_ms_per_call", "busy_ms_per_call",
                                                       "traced_calls", "traced_mpix_per_s")},
            "sampled": len(calls), "after_stretch": len(after),
            "pairs_after_stretch": len(readers.pairs(after)),
            "hold_ms": next((c.hold_ms for c in after if c.hold_ms is not None), None),
            "idle_ms_by_host": idle,
            "idle_share_by_host": {k: v / gaps for k, v in idle.items()} if gaps else {},
            "series": series}


def _cells():
    """The two cells' calls on their pools of batches: ``(cell, call,
    pool, in_flight)``."""
    from portbench import gen
    from stainx_tpu_torch import Macenko, StainNormalizerTransform

    g = gen.torch_generator(gen.seed_streams(4100000001, 1)[0], DEV)
    for cell, dtype, in_flight in (("store", "uint8", 16), ("train", "float32", 4)):
        pool = gen.tile_batches(in_flight, 128, (3, 256, 256), dtype, (0.85, 1.15), g)
        if cell == "store":
            ref = gen.tiles(1, (3, 256, 256), dtype, (0.85, 1.15), g)
            call = Macenko(device=DEV).fit(ref).transform
        else:
            call = StainNormalizerTransform("macenko", mode="batch", batch_ref_index=0, device=DEV)
        yield cell, call, pool, in_flight


def _loop(call, pool, in_flight: int, seconds: float, times: dict) -> int:
    """Calls back to back for ``seconds``, ``in_flight`` ahead of the card,
    after one warm pass; each call's host time lands in ``times``."""
    events = [torch.cuda.Event() for _ in range(in_flight)]
    for batch in pool:
        call(batch)
    torch.cuda.synchronize()
    times.clear()
    i, t0 = 0, time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        if i >= in_flight:
            events[i % in_flight].synchronize()
        a = time.perf_counter_ns()
        call(pool[i % in_flight])
        times.setdefault("API call", []).append(time.perf_counter_ns() - a)
        events[i % in_flight].record()
        i += 1
    torch.cuda.synchronize()
    return i


def _medians_ms(times: dict) -> dict:
    return {k: statistics.median(v) / 1e6 for k, v in times.items()}


def split(seconds: float) -> list[dict]:
    from stainx_tpu_torch import Macenko
    from stainx_tpu_torch.kernels import macenko_stream as ms

    times: dict[str, list] = {}

    def timed(name, fn):
        @functools.wraps(fn)
        def layer(*args, **kwargs):
            t0 = time.perf_counter_ns()
            try:
                return fn(*args, **kwargs)
            finally:
                times.setdefault(name, []).append(time.perf_counter_ns() - t0)
        return layer

    ms.macenko_transform_stream = timed("B4 wrapper", ms.macenko_transform_stream)
    ms.macenko_fit_stream = timed("B5 wrapper", ms.macenko_fit_stream)
    ms.macenko_fit_transform_stream = timed("fused B4 wrapper", ms.macenko_fit_transform_stream)
    Macenko.fit = timed("fit", Macenko.fit)
    Macenko.transform = timed("transform", Macenko.transform)
    Macenko._finalize_range = timed("finalize_range", Macenko._finalize_range)
    torch.set_num_threads(1)
    out = []
    for cell, call, pool, in_flight in _cells():
        calls = _loop(call, pool, in_flight, seconds, times)
        out.append({"split": cell, "calls": calls, "median_ms": _medians_ms(times)})
    return out


def off(rounds: int, seconds: float = 1.0) -> list[dict]:
    """The spans' and counts' cost with no profiler, in one process: rounds
    that alternate the real ``annotate``, ``note`` and ``count`` with stubs
    that do nothing (each still a call), median host time a call of each."""
    import contextlib

    real = (profiling.annotate, profiling.note, profiling.count)
    null = contextlib.nullcontext()
    stubs = (lambda *a, **k: null, lambda *a, **k: None, lambda *a, **k: None)
    torch.set_num_threads(1)
    out = []
    for cell, call, pool, in_flight in _cells():
        found: dict[str, list] = {"real": [], "stub": []}
        times: dict[str, list] = {}
        for r in range(rounds):
            for variant in (("real", "stub") if r % 2 == 0 else ("stub", "real")):
                (profiling.annotate, profiling.note,
                 profiling.count) = real if variant == "real" else stubs
                _loop(call, pool, in_flight, seconds, times)
                found[variant].append(_medians_ms(times)["API call"])
        profiling.annotate, profiling.note, profiling.count = real
        out.append({"off": cell, "rounds": rounds, "api_ms": found,
                    "median_ms": {k: statistics.median(v) for k, v in found.items()}})
    return out


def cost(n: int = 2000) -> dict:
    from torch.profiler import ProfilerActivity, profile, record_function

    stream = torch.cuda.current_stream(DEV)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    profiling._pool(0)  # what the first sampled call of a process makes
    torch.cuda.synchronize()
    made = {"pool_s": time.perf_counter() - t0, "pool_events": 3 * profiling.EVENT_PAIRS,
            "hold_ms": [profiling._event_hold_ms(0) for _ in range(3)]}

    def span():
        with profiling.annotate("stainx.probe"):
            pass

    def device_span():
        with profiling.annotate("stainx.probe", device=DEV):
            pass

    def rf():
        with record_function("stainx.probe"):
            pass

    def event_pair():
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record(stream)
        b.record(stream)

    def caller_timed():  # the events handed out, left as they were recorded last
        with profiling.caller_timed("stainx.probe", DEV):
            pass

    def root(state):
        def run():
            profiling._calls.state = state
            with profiling.call("stainx.probe"):
                with profiling.annotate("stainx.kernel.probe"):
                    profiling.launch_events(DEV)
        return run

    parts = {"span": span, "span_with_device": device_span, "caller_timed": caller_timed,
             "root_unsampled": root(3), "root_sampled": root(1),
             "count": lambda: profiling.count("stainx.probe"), "record_function": rf,
             "event_pair": event_pair, "current_stream": lambda: torch.cuda.current_stream(DEV)}

    def us(fn) -> float:
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            best = min(best, (time.perf_counter() - t0) / n * 1e6)
        return best

    off = {k: us(f) for k, f in parts.items()}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        on = {k: us(f) for k, f in parts.items()}
    return {**made, "cost_us": {"off": off, "on": on}, "patch_call_ms": _sampled_calls()}


def _sampled_calls(seconds: float = 3.0) -> dict:
    """The patch cell's call timed on the host call by call, 16 in flight:
    median of the sampled pairs' calls (calls 0 and 1 of every
    SAMPLE_EVERY), of the call after each pair and of the others, mean of
    all, in ms."""
    from portbench import gen
    from stainx_tpu_torch import Macenko

    g = gen.torch_generator(gen.seed_streams(4100000002, 1)[0], DEV)
    pool = gen.tile_batches(16, 512, (3, 96, 96), "uint8", (0.85, 1.15), g)
    call = Macenko(device=DEV).fit(gen.tiles(1, (3, 96, 96), "uint8", (0.85, 1.15), g)).transform
    events = [torch.cuda.Event() for _ in range(16)]
    for batch in pool:
        call(batch)
    torch.cuda.synchronize()
    times: dict[int, list] = {0: [], 1: [], 2: [], 3: []}
    i, t0 = 0, time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        if i >= 16:
            events[i % 16].synchronize()
        phase = min(profiling._calls.state, 3)
        a = time.perf_counter_ns()
        call(pool[i % 16])
        times[phase].append(time.perf_counter_ns() - a)
        events[i % 16].record()
        i += 1
    torch.cuda.synchronize()
    every = [t for found in times.values() for t in found]
    return {"calls": i, "pair_median": statistics.median(times[0] + times[1]) / 1e6,
            "after_pair_median": statistics.median(times[2]) / 1e6,
            "unsampled_median": statistics.median(times[3]) / 1e6,
            "mean": statistics.fmean(every) / 1e6,
            "unsampled_mean": statistics.fmean(times[3]) / 1e6}


def main(argv: list[str]) -> None:
    if not torch.cuda.is_available():
        raise SystemExit("tools/probe_tracing.py needs a CUDA card")
    mode = argv[0] if argv else ""
    if mode == "session" and len(argv) == 4:
        results = [session(argv[1], int(argv[2]), float(argv[3]))]
    elif mode == "window" and len(argv) in (4, 5):
        results = [window(argv[1], int(argv[2]), float(argv[3]),
                          float(argv[4]) if len(argv) == 5 else 0.25)]
    elif mode == "split" and len(argv) <= 2:
        results = split(float(argv[1]) if len(argv) == 2 else 4.0)
    elif mode == "cost" and len(argv) == 1:
        results = [cost()]
    elif mode == "off" and len(argv) <= 2:
        results = off(int(argv[1]) if len(argv) == 2 else 10)
    else:
        raise SystemExit(__doc__)
    for r in results:
        print(json.dumps(r), flush=True)
    print(torch.cuda.get_device_name(0))


if __name__ == "__main__":
    main(sys.argv[1:])
