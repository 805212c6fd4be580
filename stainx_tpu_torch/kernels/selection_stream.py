"""Exact multi-block rank selection (B6): wrapper, plain version, count.

Counterpart of ``stainx_tpu/kernels/selection_stream.py``.
:func:`kth_smallest_streaming` takes an (R, P) float32 field with +inf
sentinels and (R, K) int32 ranks and returns the (R, K) float32 values at
those nearest ranks among each row's elements below +inf. A rank past the
count takes the row's largest element; a row with no element gives +inf.
On a CUDA tensor it launches the radix select of ``csrc/selection.cu``
(one C call: a memset, a read for each row's extremes unless an init is
given, and 4 passes; built at first use) or raises; on a CPU tensor it
runs the plain version, which sorts the monotone keys of each row. Both
give the JAX package's ``kth_smallest_streaming`` bit for bit.

``init`` is per row ``(min_vals, max_vals, counts)`` over the elements
below +inf, the conventions of the JAX ``_init_keys``: a count of 0 gives
+inf, and the kernel starts its descent below the common leading key bits
of min and max. It must be exact where it is given; without it the kernel
finds them in its first read. The ranks and the init may be tensors on
the card: the wrapper reads nothing back to the host. The wrapper is the
span ``stainx.kernel.B6`` and counts its C calls in ``launch.B6``
(:mod:`stainx_tpu_torch.profiling`).
"""

from __future__ import annotations

import ctypes

import torch

from stainx_tpu_torch import kernels, profiling
from stainx_tpu_torch.kernels.selection import kth_smallest_pallas_plain

MAX_RANKS = 8  # ranks one launch serves (csrc/selection.cu kMaxK)
STATE_BYTES = 176  # csrc/selection.cu SelRow, a row's descent
COUNTER_BYTES = 32  # csrc/selection.cu RowCount, a row's counters
CAND_CAP = 1 << 20  # keys of a row's candidate buffer in device memory (4 MB)
ALIGN = 256  # bytes between the scratch regions


def scratch_layout(rows: int, p: int, k: int):
    """B6's scratch in one byte buffer: ``{name: (offset, nbytes)}`` and the
    total. ``counts`` (rows, 32 bytes) with the (rows, k, 256) uint32
    histograms right after them (the kernel zeroes both with one memset),
    ``state`` (rows, 176 bytes) and ``cand``, the rows' uint32 candidate
    buffers of :func:`candidate_cap` keys each. Regions start
    :data:`ALIGN` apart."""
    sizes = [("counts", rows * COUNTER_BYTES + rows * k * 256 * 4),
             ("state", rows * STATE_BYTES), ("cand", rows * candidate_cap(p) * 4)]
    layout, off = {}, 0
    for name, nbytes in sizes:
        layout[name] = (off, nbytes)
        off = kernels.ceil_to(off + nbytes, ALIGN)
    return layout, off


def candidate_cap(p: int) -> int:
    """Keys a row's candidate buffer holds: the row's length, up to
    :data:`CAND_CAP`. Where a rank's bin holds more keys, the next pass
    reads the field again instead."""
    return max(1, min(p, CAND_CAP))


def init_keys(min_vals, max_vals, counts) -> torch.Tensor:
    """(R, 3) int32 of a value-space init: the uint32 bits of the min and
    max monotone keys, and the count."""
    def key_bits(v: torch.Tensor) -> torch.Tensor:
        bits = v.to(torch.float32).contiguous().view(torch.int32)
        return bits ^ torch.where(bits < 0, -1, -(2**31)).to(torch.int32)

    return torch.stack([key_bits(min_vals), key_bits(max_vals), counts.to(torch.int32)], dim=1)


def kth_smallest_streaming_plain(x: torch.Tensor, ranks: torch.Tensor, init=None) -> torch.Tensor:
    """Plain PyTorch version of B6: B3's plain version (sort each row's
    monotone keys, read the key at the clamped rank), with +inf for a row
    whose init count is 0."""
    out = kth_smallest_pallas_plain(x, ranks)
    if init is None:
        return out
    return torch.where((init[2].to(x.device) == 0)[:, None], torch.inf, out)


# --------------------------------------------------------------- wrappers
def _lib() -> ctypes.CDLL:
    lib = kernels.library("selection")
    if not getattr(lib, "_stainx_declared", False):
        ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.stainx_kth_smallest_streaming.argtypes = [
            ptr, i64, i64, ptr, i32, ptr, ptr, ptr, ptr, i64, ptr, i32, i32, ptr
        ]
        lib.stainx_kth_smallest_streaming.restype = i32
        lib._stainx_declared = True
    return lib


def kth_smallest_streaming(x: torch.Tensor, ranks: torch.Tensor, init=None) -> torch.Tensor:
    """Exact nearest-rank selection (B6): (R, P) float32 with +inf
    sentinels, ranks (R, K) int32 → (R, K) float32, any number of rows.
    ``init`` is an optional tuple of (R,) ``(min_vals, max_vals, counts)``.
    One C call a call (per 8 ranks)."""
    with profiling.annotate("stainx.kernel.B6"):
        return _streaming(x, ranks, init)


def _streaming(x: torch.Tensor, ranks: torch.Tensor, init) -> torch.Tensor:
    if x.dim() != 2 or ranks.dim() != 2 or ranks.shape[0] != x.shape[0]:
        raise ValueError(
            f"kth_smallest_streaming expects x (R, P) and ranks (R, K), got "
            f"{tuple(x.shape)} and {tuple(ranks.shape)}"
        )
    if x.device.type == "cpu":
        return kth_smallest_streaming_plain(x, ranks, init)
    if x.dtype != torch.float32:
        raise TypeError(f"kth_smallest_streaming takes a float32 field, got {x.dtype}")
    kernels.check_cuda(x, "kth_smallest_streaming")
    dev = x.device
    ranks = ranks.to(device=dev, dtype=torch.int32)
    init3 = None
    if init is not None:
        init3 = init_keys(*(torch.as_tensor(v).to(dev) for v in init)).contiguous()
    rows, p = x.shape
    k_all = ranks.shape[1]
    if rows == 0 or p == 0 or k_all == 0:
        return torch.full((rows, k_all), torch.inf, dtype=torch.float32, device=dev)
    if p >= 2**31:
        raise ValueError(f"kth_smallest_streaming takes rows below 2^31 elements, got {p}")
    vec = 4 if p % 4 == 0 and x.data_ptr() % 16 == 0 else 1
    blocks_x = kernels.row_blocks(rows, p // vec, dev)
    kernels.folded_grid(rows, blocks_x, "kth_smallest_streaming")
    lib = _lib()
    stream = kernels.current_stream(dev)
    outs = []
    for k0 in range(0, k_all, MAX_RANKS):
        r = ranks[:, k0:k0 + MAX_RANKS].contiguous()
        k = r.shape[1]
        out = torch.empty((rows, k), dtype=torch.float32, device=dev)
        layout, total = scratch_layout(rows, p, k)
        scratch = torch.empty(total, dtype=torch.uint8, device=dev)
        base = scratch.data_ptr()
        with kernels.on_device(dev):
            code = lib.stainx_kth_smallest_streaming(
                x.data_ptr(), rows, p, r.data_ptr(), k,
                None if init3 is None else init3.data_ptr(), base + layout["counts"][0],
                base + layout["state"][0], base + layout["cand"][0], candidate_cap(p),
                out.data_ptr(), vec, blocks_x, stream,
            )
        kernels.check(lib, code, "kth_smallest_streaming")
        profiling.count("launch.B6")
        outs.append(out)
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)

