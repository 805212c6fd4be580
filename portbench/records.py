"""What one run hands to the metric readers (``metrics/<name>.py``)."""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class Window:
    calls: int  # timed calls (requests) attempted in the window
    failed: int  # of them, those that raised
    seconds: float  # from the window's start to the device drained at its end
    pixels: int  # pixels of all calls of the window
    host_call_s: np.ndarray  # host time of each call into the program, outside the traced stretch
    notes: dict = field(default_factory=dict)  # printed on standard error, not metrics


@dataclass
class Run:
    cell: object  # spec.Cell
    setup_s: float
    window: Window
    trace: object | None  # trace.Record of the traced stretch, or None
    cost: object  # counts.Cost of one timed call
