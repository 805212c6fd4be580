"""Monotone integer keys of float32 values, and the exact row select (B3).

Counterpart of ``stainx_tpu/kernels/selection.py``.

:func:`monotone_key` and :func:`unkey` are ``_monotone_key`` and ``_unkey``:
``key = bits XOR (sign ? 0xFFFFFFFF : 0x80000000)`` orders exactly like the
floats (+inf above every finite value, −0.0 just below +0.0). PyTorch has no
full uint32 arithmetic, so the uint32 key is held in an int64 tensor with
values in [0, 2³²). Their device versions live in ``csrc/keys.cuh``, beside
the radix selections that run on these keys.

:func:`kth_smallest_pallas` is B3, ``kth_smallest_pallas``: an (R, P)
float32 field with +inf sentinels and (R, K) int32 ranks give the (R, K)
float32 values at those nearest ranks among each row's elements below +inf.
A rank past the count takes the row's largest element; a row with no
element gives +inf. On a CUDA tensor it launches ``csrc/select_rows.cu``
(one thread-block cluster a row, built at first use) or raises; on a CPU
tensor it runs :func:`kth_smallest_pallas_plain`, which sorts the monotone
keys of each row. Both give the JAX kernel's result bit for bit. The
wrapper is the span ``stainx.kernel.B3`` and counts its launches in
``launch.B3`` (:mod:`stainx_tpu_torch.profiling`).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from stainx_tpu_torch import kernels, profiling

_U32 = 0xFFFFFFFF
_SIGN = 0x80000000
SENTINEL_KEY = 0xFF800000  # monotone_key(+inf)
MAX_RANKS = 8  # ranks one launch serves (csrc/select_rows.cu kMaxK)


def monotone_key(x: torch.Tensor) -> torch.Tensor:
    """int64 tensor of the uint32 monotone keys of float32 ``x``."""
    bits = x.to(torch.float32).view(torch.int32).to(torch.int64) & _U32
    return torch.where(bits >= _SIGN, bits ^ _U32, bits ^ _SIGN)


def unkey(key: torch.Tensor) -> torch.Tensor:
    """float32 values whose monotone keys are ``key`` (inverse of
    :func:`monotone_key`)."""
    bits = torch.where(key >= _SIGN, key ^ _SIGN, key ^ _U32)
    signed = torch.where(bits >= _SIGN, bits - (1 << 32), bits)
    return signed.to(torch.int32).view(torch.float32)


def kth_smallest_pallas_plain(x: torch.Tensor, ranks: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of B3 (and the core of B6's): sort each row's
    monotone keys and read the key at the rank clamped to [0, count − 1],
    where the count is the row's elements below +inf; +inf for a row
    without one."""
    rows, p = x.shape
    k = ranks.shape[1]
    if p == 0:
        return torch.full((rows, k), torch.inf, dtype=torch.float32, device=x.device)
    keys = monotone_key(x)
    n = (keys < SENTINEL_KEY).sum(-1)
    r = torch.minimum(ranks.to(torch.int64).clamp(min=0), (n - 1).clamp(min=0)[:, None])
    out = unkey(torch.sort(keys, dim=-1).values.gather(-1, r))
    return torch.where((n == 0)[:, None], torch.inf, out)


# ------------------------------------------------------------ host logic
STATE_BYTES = 192  # csrc/select_rows.cu RowsShared, the head of a block's shared memory
HIST_COPIES = 8  # histogram copies a block counts into
CAND_KEYS = 4096  # candidates a block stores in shared memory
CLUSTER_SIZES = (1, 2, 4, 8, 16)  # 16 is past the portable 8, allowed by the kernel
# Waves of clusters a shape may take. Measured on the H100 (chip_smoke.py's
# cluster table, 700 W): at (128, 512^2) K=1 clusters of 2 in two waves
# (0.164 ms) beat one wave of single blocks (0.182), which read 80 % of
# their rows from device memory at every pass; at (256, 224^2) K=2 single
# blocks in two waves (0.073) beat four waves of clusters of 2 (0.090).
WAVES = 2
# Elements a block of a cluster larger than 1 must get. Measured on the H100
# (chip_smoke.py's short-row table, 700 W): a 224^2 row is fastest on
# clusters of 4 (12 544 a block: 0.0216 ms at K=2) and slower on 8 (6 272:
# 0.0227) and 16 (3 136: 0.0279); a 64^2 row on a single block (0.0160)
# or 2 (2 048 a block: 0.0160), slower on 4 and more.
MIN_SLICE = 8192


def fixed_words(k: int) -> int:
    """32-bit words of a block's shared memory between its state and its
    resident keys, for ``k`` ranks: the histogram copies (a word of padding
    each, rounded to 4 words), the block's two histograms and the merged
    one, and the candidates."""
    return kernels.ceil_to(HIST_COPIES * (k * 256 + 1), 4) + 3 * k * 256 + CAND_KEYS


def resident_budget(k: int, smem_per_block: int) -> int:
    """Keys of its slice a block keeps in shared memory beside its fixed
    part, for ``k`` ranks: a multiple of 4."""
    words = (smem_per_block - STATE_BYTES) // 4 - fixed_words(k)
    return words - words % 4


def cluster_slice(p: int, c: int, budget: int) -> tuple[int, int]:
    """``(slice, resident)`` of a row of ``p`` elements on a cluster of
    ``c`` blocks: each block takes a slice of the row (a multiple of 4
    elements) and keeps up to ``budget`` of its keys in shared memory,
    reading the rest from device memory each pass."""
    if c not in CLUSTER_SIZES:
        raise ValueError(f"kth_smallest_pallas: no cluster of {c} blocks (sizes {CLUSTER_SIZES})")
    slice_ = kernels.ceil_to(-(-p // c), 4)
    return slice_, min(slice_, budget)


def cluster_shape(rows: int, p: int, k: int, smem_per_block: int, active
                  ) -> tuple[int, int, int]:
    """``(cluster size, slice, resident)`` of B3 for ``rows`` rows of ``p``
    elements and ``k`` ranks (:func:`cluster_slice`). ``active(c,
    resident)`` is the number of clusters of ``c`` blocks the card holds at
    once. The cluster is the largest whose clusters for all the rows run in
    at most :data:`WAVES` waves and whose blocks each get at least
    :data:`MIN_SLICE` elements, else 1: a lone or few long rows spread
    over the card, many rows take a block each."""
    budget = resident_budget(k, smem_per_block)
    for c in reversed(CLUSTER_SIZES):
        slice_, resident = cluster_slice(p, c, budget)
        if c == 1 or (-(-p // c) >= MIN_SLICE and WAVES * active(c, resident) >= rows):
            return c, slice_, resident
    raise AssertionError("unreachable: a cluster of 1 always fits")


# --------------------------------------------------------------- wrapper
def _lib() -> ctypes.CDLL:
    lib = kernels.library("select_rows")
    if not getattr(lib, "_stainx_declared", False):
        ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.stainx_kth_smallest_rows.argtypes = [ptr, i64, i64, ptr, i32, ptr, i32, i32, i64, i64,
                                                 ptr]
        lib.stainx_kth_smallest_rows.restype = i32
        lib.stainx_kth_smallest_rows_occupancy.argtypes = [i32, i32, i64, ptr]
        lib.stainx_kth_smallest_rows_occupancy.restype = i32
        lib._stainx_declared = True
    return lib


@functools.cache
def _active_clusters(index: int, k: int, csize: int, resident: int) -> int:
    """Clusters of ``csize`` blocks with ``k`` ranks and ``resident`` keys
    a block that CUDA device ``index`` holds at once
    (``cudaOccupancyMaxActiveClusters``), asked once a shape (each ask
    counted in ``occupancy.query``)."""
    profiling.count("occupancy.query")
    lib, found = _lib(), ctypes.c_int(0)
    with kernels.on_device(index):
        code = lib.stainx_kth_smallest_rows_occupancy(csize, k, resident, ctypes.addressof(found))
    kernels.check(lib, code, "cudaOccupancyMaxActiveClusters")
    return found.value


def kth_smallest_pallas(x: torch.Tensor, ranks: torch.Tensor) -> torch.Tensor:
    """Exact nearest-rank selection (B3): (R, P) float32 with +inf
    sentinels, ranks (R, K) int32 → (R, K) float32. One launch a call (per
    8 ranks), one thread-block cluster a row (:func:`cluster_shape`); the
    ranks may stay on the card."""
    with profiling.annotate("stainx.kernel.B3"):
        return _select(x, ranks, None)


def _select(x: torch.Tensor, ranks: torch.Tensor, csize: int | None) -> torch.Tensor:
    """B3 on clusters of ``csize`` blocks, or of :func:`cluster_shape`'s
    size where it is None (``chip_smoke.py`` forces each size)."""
    if x.dim() != 2 or ranks.dim() != 2 or ranks.shape[0] != x.shape[0]:
        raise ValueError(
            f"kth_smallest_pallas expects x (R, P) and ranks (R, K), got "
            f"{tuple(x.shape)} and {tuple(ranks.shape)}"
        )
    if x.device.type == "cpu":
        return kth_smallest_pallas_plain(x, ranks)
    if x.dtype != torch.float32:
        raise TypeError(f"kth_smallest_pallas takes a float32 field, got {x.dtype}")
    kernels.check_cuda(x, "kth_smallest_pallas")
    rows, p = x.shape
    k_all = ranks.shape[1]
    dev = x.device
    if rows == 0 or p == 0 or k_all == 0:
        return torch.full((rows, k_all), torch.inf, dtype=torch.float32, device=dev)
    if p >= 2**31:
        raise ValueError(f"kth_smallest_pallas takes rows below 2^31 elements, got {p}")
    ranks = ranks.to(device=dev, dtype=torch.int32)
    vec = 4 if p % 4 == 0 and x.data_ptr() % 16 == 0 else 1
    smem = kernels.device_limits(dev.index)[1]
    lib = _lib()
    stream = kernels.current_stream(dev)
    outs = []
    for k0 in range(0, k_all, MAX_RANKS):
        r = ranks[:, k0:k0 + MAX_RANKS].contiguous()
        k = r.shape[1]
        if csize is None:
            active = functools.partial(_active_clusters, dev.index, k)
            c, slice_, resident = cluster_shape(rows, p, k, smem, active)
        else:
            c, (slice_, resident) = csize, cluster_slice(p, csize, resident_budget(k, smem))
        kernels.folded_grid(rows, c, "kth_smallest_pallas")
        profiling.note(route="cluster", csize=c, slice=slice_, resident=resident)
        out = torch.empty((rows, k), dtype=torch.float32, device=dev)
        with kernels.on_device(dev):
            code = lib.stainx_kth_smallest_rows(
                x.data_ptr(), rows, p, r.data_ptr(), k, out.data_ptr(), vec, c, slice_,
                resident, stream
            )
        kernels.check(lib, code, "kth_smallest_pallas")
        profiling.count("launch.B3")
        outs.append(out)
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)

