"""api_host_ms (ms), public API: the host's time inside each timed call
into the program (``transform`` or ``forward``), without a sync; the median
over the traced run's calls outside its profiled stretch, where the
profiler would add its own cost."""

import numpy as np


def read(run):
    host = run.window.host_call_s
    if run.trace is None or host.size == 0:
        return None
    return float(np.median(host)) * 1e3
