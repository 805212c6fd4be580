"""b1_device_ms (ms), kernels: the device interval of the program's
``stainx.kernel.B1`` spans per call in the traced stretch (``portbench/
session.py``). The program records its events inside the span's one C
call, just before and just after B1's launch, so the interval holds the
kernel and not the wrapper's host time before it. A program whose B1 span
records no device interval gives nothing to read."""

from portbench import session


def read(run):
    found = session.of(run)
    if found is None:
        return None
    sess, calls = found
    b1 = [s.device_ms for s in sess.spans
          if s.name == "stainx.kernel.B1" and s.device_ms is not None]
    return sum(b1) / calls if b1 else None
