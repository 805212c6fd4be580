"""The work a call needs, from its shapes, and the least time the card needs for it.

Bytes count the call's input read once and its output written once,
whatever the kernels read again: a batch-mode forward that fits and then
transforms one batch counts that batch once. Operations count the
floating-point arithmetic the inputs need, per pixel, as the method's
reference module lists it (``OPS_PER_PIXEL``). So the bound is the work of
the call, not of the kernels that implement it today.
"""

from __future__ import annotations

from dataclasses import dataclass

# NVIDIA H100 SXM (data sheet, dense, at the 700 W limit): HBM3 bandwidth and
# float32 outside the tensor cores, the precision the configurations state.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12

ITEMSIZE = {"uint8": 1, "float32": 4}


@dataclass(frozen=True)
class Cost:
    bytes: int
    ops: int

    @property
    def least_s(self) -> float:
        return max(self.bytes / PEAK_BYTES_PER_S, self.ops / PEAK_F32_FLOPS)

    @property
    def bound(self) -> str:
        by_bytes = self.bytes / PEAK_BYTES_PER_S >= self.ops / PEAK_F32_FLOPS
        return "bytes" if by_bytes else "operations"


def call_cost(config: dict, batch: int, ops_per_pixel: dict[str, int]) -> Cost:
    """The cost of one timed call on ``batch`` tiles of ``config``: a
    transform, preceded where the configuration fits every batch
    (``"fit": "per_batch"``) by a fit on the batch's image ``fit_index``, or
    on all of its pixels where that is null. The output has the input's
    dtype."""
    channels, h, w = config["tile"]
    pixels = batch * h * w
    in_bytes = batch * channels * h * w * ITEMSIZE[config["dtype"]]
    per_pixel = ops_per_pixel["transform"]
    if config["dtype"] != "uint8":
        per_pixel += ops_per_pixel["float_input"]
    if config.get("out_full_scale", 255.0) != 255.0:
        per_pixel += ops_per_pixel["unit_output"]
    ops = pixels * per_pixel
    if config["fit"] == "per_batch":
        ops += (pixels if config.get("fit_index") is None else h * w) * ops_per_pixel["fit"]
    return Cost(2 * in_bytes, ops)
