"""fit_device_ms (ms), kernels: the device interval of the program's
``stainx.fit`` spans per call in the traced stretch (``portbench/
session.py``): from the stream reaching the fit's start to its end, the
fit's kernels on a stream kept fed. Only cells that fit in the window have
a fit span."""

from portbench import session


def read(run):
    found = session.of(run)
    if found is None:
        return None
    sess, calls = found
    fits = [s.device_ms for s in sess.spans if s.name == "stainx.fit" and s.device_ms is not None]
    return sum(fits) / calls if fits else None
