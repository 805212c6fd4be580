"""The program's own spans and counters of the traced stretch.

The port keeps, for the most recent ``torch.profiler`` session, each span
it opened (name, parent, host start and end, device interval) and each
count it made (``stainx_tpu_torch.profiling.session()``). The traced
stretch is such a session, and the calls before and after it run with no
profiler, so the session holds the stretch's calls alone. A call is one
root span of the session (a span with no parent). A program without that
table, or a run with no traced stretch, gives nothing to read.
"""

from __future__ import annotations


def _program_session():
    try:
        from stainx_tpu_torch import profiling
    except ImportError:
        return None
    read = getattr(profiling, "session", None)
    return read() if read is not None else None


def of(run):
    """``(session, calls)`` of the run's traced stretch, or None where the
    run has no stretch or the program no session, or no call in it."""
    if run.trace is None:
        return None
    sess = _program_session()
    if sess is None:
        return None
    calls = len(sess.roots())
    return (sess, calls) if calls else None
