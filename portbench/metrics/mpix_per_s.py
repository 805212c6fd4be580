"""mpix_per_s (MPix/s): all pixels normalized in the window over all of its
time, the device drained at its end (host clock)."""


def read(run):
    w = run.window
    if w.seconds <= 0:
        return None
    return w.pixels / w.seconds / 1e6
