"""idle_share (%), device: the share of the traced stretch's wall time in
which no kernel, copy or memset ran on the device (the profiler's trace)."""


def read(run):
    t = run.trace
    if t is None or t.stretch_s <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.stretch_s)
