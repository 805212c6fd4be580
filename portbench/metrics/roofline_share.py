"""roofline_share (%), kernels: the least time the card needs for one call
(``portbench/counts.py``: its bytes over the peak bandwidth or its
operations over the float32 peak, the larger) over the device's kernel time
per call in the traced stretch."""


def read(run):
    t = run.trace
    if t is None or t.kernel_s <= 0 or t.calls <= 0:
        return None
    return 100.0 * run.cost.least_s / (t.kernel_s / t.calls)
