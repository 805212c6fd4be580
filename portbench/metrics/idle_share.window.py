"""idle_share.window (%), device: the card's idle share with no profiler
running, from the program's call timeline over the traced run's window
after its stretch (``portbench/timeline.py``): the sampled pairs' gaps (the
second call's first launch start minus the first call's last launch end,
on the card's events) over their periods (the gap and the second call's
launch interval: launch end to launch end, one call's cycle), each less
what the events themselves hold the card (the timeline's ``hold_ms``
each, measured on the card): one in a gap, two in a period."""

from portbench import timeline


def read(run):
    calls = timeline.of(run)
    if calls is None:
        return None
    found = timeline.pairs(calls)
    period = sum(c.period_ms - 2 * c.hold_ms for c in found)
    if not found or period <= 0:
        return None
    return 100.0 * sum(c.gap_ms - c.hold_ms for c in found) / period
