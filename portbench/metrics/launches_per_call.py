"""launches_per_call (launches), ops and route ladder: the program's
``launch.*`` counts per call in the traced stretch (``portbench/
session.py``): the C calls the route ladder chose for each call."""

from portbench import session


def read(run):
    found = session.of(run)
    if found is None:
        return None
    sess, calls = found
    return sum(n for name, n in sess.counts.items() if name.startswith("launch.")) / calls
