"""The modules a run may not hold: JAX, and the JAX package and its harness.

Names are compared whole, by the part before the first dot, so
``stainx_tpu_torch`` (the port) is not ``stainx_tpu`` (the JAX package).
The port's ``testing`` module and ``benchmarks_torch`` are the program's
and not the yardstick's, so the benchmark does not load them either.
"""

from __future__ import annotations

import sys

FORBIDDEN_TOP = frozenset({"jax", "jaxlib", "flax", "stainx_tpu", "benchmarks", "bench",
                           "benchmarks_torch"})
FORBIDDEN = frozenset({"stainx_tpu_torch.testing"})


def forbidden(modules=None) -> list[str]:
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".")[0] in FORBIDDEN_TOP or m in FORBIDDEN)
