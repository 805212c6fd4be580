"""Profiling and timing hooks.

Counterpart of ``stainx_tpu/profiling.py`` on ``torch.profiler`` and CUDA
events:

- :func:`trace`: a context manager around ``torch.profiler.profile`` that
  writes a trace of the block, which TensorBoard and Chrome's trace viewer
  load, into a directory;
- :func:`annotate`: a named span inside a trace;
- :func:`time_fn`: seconds per iteration of a shape-preserving step, its
  iterations chained through their data. On a CUDA tensor it times with
  CUDA events on the current stream, on a CPU tensor with
  ``time.perf_counter``; it never uses the profiler, whose kernel times
  late in a long run fall below graph replay's, or to none.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from collections.abc import Callable

import torch


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """Record the block's CPU activity (and the card's, where CUDA is
    available) and write it on exit as a ``*.pt.trace.json`` file into
    ``log_dir`` (default: ``stainx_trace`` under the temporary directory).
    Yields ``log_dir``.

    >>> with profiling.trace("/path/to/trace"):
    ...     normalizer.transform(batch)
    """
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    log_dir = os.path.join(tempfile.gettempdir(), "stainx_trace") if log_dir is None else log_dir
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield log_dir
        if torch.cuda.is_available():
            torch.cuda.synchronize()


def annotate(name: str):
    """Named span inside a :func:`trace` block (context manager)."""
    return torch.profiler.record_function(name)


def time_fn(step: Callable, init, iters: int = 10, warmup: int = 1) -> float:
    """Seconds per iteration of a shape-preserving ``step``.

    Iterations are chained through their data (each takes the previous
    one's output), and the result is ``min(run(1 + iters)) − min(run(1))``
    over ``iters``: the cost of starting and ending a run cancels. A run on
    a CUDA ``init`` is timed by CUDA events recorded on the current stream
    around it, so it covers all the device work it enqueued; on a CPU
    tensor by ``time.perf_counter``.
    """
    on_card = torch.is_tensor(init) and init.is_cuda
    y = init
    for _ in range(max(warmup, 1)):
        y = step(y)
    if on_card:
        torch.cuda.synchronize(init.device)

    def run(n: int) -> float:
        if on_card:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        else:
            t0 = time.perf_counter()
        v = init
        for _ in range(n):
            v = step(v)
        if on_card:
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / 1e3
        return time.perf_counter() - t0

    base = min(run(1) for _ in range(3))
    total = min(run(1 + iters) for _ in range(2))
    return max(total - base, 1e-12) / iters
