#!/usr/bin/env python3
"""The port's spans and counters on a CUDA card: what a traced run's session
holds, the host's time a call by layer, and what a span costs.

Run from the root of a checkout on a machine with one CUDA card and nvcc:

    python3 tools/probe_tracing.py session CELL SEED SECONDS
    python3 tools/probe_tracing.py split [SECONDS]
    python3 tools/probe_tracing.py cost
    python3 tools/probe_tracing.py off [ROUNDS]

- ``session``: one traced ``portbench`` run of the cell in this process,
  then ``stainx_tpu_torch.profiling.session()`` beside the run's notes: the
  root spans against ``traced_calls``, each span's host time and device
  interval per call (means, and the device intervals' quartiles with the
  first call left out), the device intervals' sum against
  ``busy_ms_per_call``, the session's counts, its ``launch.*`` counts per
  call and the kernel spans' route arguments, the ``finalize.folded`` count
  per call (the ÷255 of ``normalize_to_0_1`` done in the kernels' store),
  the device spans the session lacks (``stainx.finalize`` wherever the
  division was folded) and, for the cells whose transform takes statistics
  over the call (``reinhard-u8-512.store``: B7b and its finalize;
  ``hm-u8-512.store-b256``: B8a and its LUT finalize), the ``stainx.stats``
  spans per call under ``per_call``: one a call, with a device interval.
- ``split``: no profiler. The host's time a call in each layer of the two
  cells' calls (the API call, ``fit``, ``Macenko.transform``,
  ``Macenko._finalize_range``, the B4 and B5 wrappers and B4 with the fit
  fused in, which a ``.train`` forward calls in place of both), each timed by
  ``perf_counter_ns`` around the layer's function, in a closed loop over
  the cells' batches with their calls in flight (16 and 4); medians in ms.
  A layer's time holds its children's: ``transform`` holds the B4 wrapper
  and the ÷255 where it divides (``_finalize_range``; none where the
  kernels' store does it).
- ``cost``: the host's cost, in µs, of a span (with and without a device
  interval), a count, a ``record_function``, a CUDA event pair and
  ``torch.cuda.current_stream``, with no profiler running and inside a
  ``torch.profiler`` session.
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

STARTED = time.perf_counter()
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from stainx_tpu_torch import profiling  # noqa: E402

DEV = torch.device("cuda", 0)
DEVICE_SPANS = ("stainx.fit", "stainx.transform", "stainx.finalize")


def session(cell_name: str, seed: int, seconds: float) -> dict:
    from portbench import harness, spec

    torch.set_num_threads(1)
    res = harness.run_cell(spec.cell(cell_name), seed, seconds, True, DEV, STARTED)
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
    busy = res["notes"].get("busy_ms_per_call")
    dev_sum = sum(per_call[n]["device_ms"] for n in DEVICE_SPANS
                  if n in per_call and per_call[n]["device_ms"] is not None)
    return {"cell": cell_name, "seed": seed, "correct": res["correct"], "roots": calls,
            "traced_calls": res["notes"].get("traced_calls"), "busy_ms_per_call": busy,
            "device_ms_sum": dev_sum, "device_ms_sum_over_busy": dev_sum / busy if busy else None,
            "finalize_folded_per_call": sess.counts.get("finalize.folded", 0) / calls,
            "launches_per_call": {k: v / calls for k, v in sess.counts.items()
                                  if k.startswith("launch.")},
            "absent_device_spans": [n for n in DEVICE_SPANS if n not in per_call],
            "per_call": per_call, "device_ms_quartiles": quartiles, "counts": sess.counts,
            "kernel_args": sorted({json.dumps(s.args, sort_keys=True) for s in sess.spans
                                   if s.name.startswith("stainx.kernel.") and s.args}),
            "metrics": {k: v["value"] for k, v in res["metrics"].items()},
            "idle_gaps": res.get("breakdown", {}).get("idle_gaps"),
            "traced_mpix_per_s": res["notes"].get("traced_mpix_per_s")}


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

    parts = {"span": span, "span_with_device": device_span,
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
    return {"cost_us": {"off": off, "on": on}}


def main(argv: list[str]) -> None:
    if not torch.cuda.is_available():
        raise SystemExit("tools/probe_tracing.py needs a CUDA card")
    mode = argv[0] if argv else ""
    if mode == "session" and len(argv) == 4:
        results = [session(argv[1], int(argv[2]), float(argv[3]))]
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
