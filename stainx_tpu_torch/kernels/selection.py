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
(one thread block a row, built at first use) or raises; on a CPU tensor it
runs :func:`kth_smallest_pallas_plain`, which sorts the monotone keys of
each row. Both give the JAX kernel's result bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from stainx_tpu_torch import kernels

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


# --------------------------------------------------------------- wrapper
def _lib() -> ctypes.CDLL:
    lib = kernels.library("select_rows")
    if not getattr(lib, "_stainx_declared", False):
        ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.stainx_kth_smallest_rows.argtypes = [ptr, i64, i64, ptr, i32, ptr, i32, ptr]
        lib.stainx_kth_smallest_rows.restype = i32
        lib.stainx_kth_smallest_rows_resident_max.argtypes = [ctypes.POINTER(i64)]
        lib.stainx_kth_smallest_rows_resident_max.restype = i32
        lib._stainx_declared = True
    return lib


def resident_max(device: torch.device) -> int:
    """The longest row, in elements, whose keys B3 keeps in one block's
    shared memory on ``device`` (longer rows are read again each pass)."""
    lib, out = _lib(), ctypes.c_longlong()
    with torch.cuda.device(device):
        kernels.check(lib, lib.stainx_kth_smallest_rows_resident_max(ctypes.byref(out)),
                      "kth_smallest_pallas")
    return out.value


def kth_smallest_pallas(x: torch.Tensor, ranks: torch.Tensor) -> torch.Tensor:
    """Exact nearest-rank selection (B3): (R, P) float32 with +inf
    sentinels, ranks (R, K) int32 → (R, K) float32. One launch a call (per
    8 ranks), one thread block a row; the ranks may stay on the card."""
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
    if p >= 2**31 or rows >= 2**31:
        raise ValueError(
            f"kth_smallest_pallas takes fewer than 2^31 rows and elements, got {tuple(x.shape)}"
        )
    ranks = ranks.to(device=dev, dtype=torch.int32)
    vec = 4 if p % 4 == 0 and x.data_ptr() % 16 == 0 else 1
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    outs = []
    for k0 in range(0, k_all, MAX_RANKS):
        r = ranks[:, k0:k0 + MAX_RANKS].contiguous()
        k = r.shape[1]
        out = torch.empty((rows, k), dtype=torch.float32, device=dev)
        with torch.cuda.device(dev):
            code = lib.stainx_kth_smallest_rows(
                x.data_ptr(), rows, p, r.data_ptr(), k, out.data_ptr(), vec, stream
            )
        kernels.check(lib, code, "kth_smallest_pallas")
        kth_smallest_pallas.launches += 1
        outs.append(out)
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)


kth_smallest_pallas.launches = 0
