"""wrapper_host_ms (ms), wrappers: the host's time inside the program's
kernel wrappers (``stainx.kernel.*`` spans: checks, scratch, route and
cluster shape, the C call) per call in the traced stretch (``portbench/
session.py``). Kernel spans are leaves on the card; one nested in another
(the CPU's plain versions) is left out, so no time counts twice."""

from portbench import session

PREFIX = "stainx.kernel."


def read(run):
    found = session.of(run)
    if found is None:
        return None
    sess, calls = found
    spans = sess.spans
    ms = [s.host_ms for s in spans if s.name.startswith(PREFIX)
          and (s.parent is None or not spans[s.parent].name.startswith(PREFIX))]
    return sum(ms) / calls if ms else None
