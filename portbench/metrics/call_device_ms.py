"""call_device_ms (ms), kernels: the mean launch interval of a sampled
pair's second call (the first records its launch end alone) from the
program's call timeline over the traced run's window after its stretch
(``portbench/timeline.py``): from its C calls' first launch start to their
last launch end, on CUDA events recorded inside the C calls, with no
profiler running, less the card time its end event holds (the timeline's
``hold_ms``, measured on the card); a call's kernels on a stream kept
fed."""

from portbench import timeline


def read(run):
    calls = timeline.of(run)
    if calls is None:
        return None
    found = [c.launch_ms - c.hold_ms for c in calls if c.launch_ms is not None]
    return sum(found) / len(found) if found else None
