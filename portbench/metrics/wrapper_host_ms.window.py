"""wrapper_host_ms.window (ms), wrappers: the host's time in the program's
kernel wrappers (``stainx.kernel.*`` spans, the outermost only, as
``wrapper_host_ms`` counts them) per sampled call that recorded no launch
event (the call after each pair), from the program's call timeline over
the traced run's window after its stretch (``portbench/timeline.py``),
with no profiler running."""

from portbench import timeline


def read(run):
    calls = timeline.of(run)
    found = timeline.unmarked(calls) if calls is not None else []
    if not found:
        return None
    return sum(timeline.wrapper_ms(c) for c in found) / len(found)
