"""Monotone integer keys of float32 values.

Counterpart of ``stainx_tpu/kernels/selection.py::_monotone_key`` and
``_unkey``: ``key = bits XOR (sign ? 0xFFFFFFFF : 0x80000000)`` orders
exactly like the floats (+inf above every finite value). PyTorch has no
full uint32 arithmetic, so the uint32 key is held in an int64 tensor with
values in [0, 2³²). The device versions of both functions, and the radix
select that runs on these keys, live in ``csrc/macenko_fused.cu``.
"""

from __future__ import annotations

import torch

_U32 = 0xFFFFFFFF
_SIGN = 0x80000000


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
