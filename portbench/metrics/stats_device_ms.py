"""stats_device_ms (ms), kernels: the device interval of the program's
``stainx.stats`` spans per call in the traced stretch (``portbench/
session.py``): the call-wide statistics a transform takes before it writes
any output (Reinhard: B7b and its finalize), from the stream reaching their
start to their end. A program without that span gives nothing to read."""

from portbench import session


def read(run):
    found = session.of(run)
    if found is None:
        return None
    sess, calls = found
    stats = [s.device_ms for s in sess.spans
             if s.name == "stainx.stats" and s.device_ms is not None]
    return sum(stats) / calls if stats else None
