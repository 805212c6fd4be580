"""The histogram-matching kernels: wrappers, plain versions, counts.

Counterpart of ``stainx_tpu/kernels/histogram.py``. On a CUDA tensor each
wrapper launches its hand-written kernel from ``csrc/histogram.cu`` (built
at first use) or raises; on a CPU tensor it runs its plain PyTorch version.
Each wrapper counts its launches in its ``launches`` attribute. Any channel
count C ≥ 1 is accepted.

- :func:`histogram_256`: per-channel 256-bin counts of (N, C, P) or (C, P)
  uint8 as (C, 256) float32. The kernel counts in int32 (exact, the same on
  every run); the counts become float32 once, at the end. One kernel serves
  both TPU kernels, ``histogram_256_mxu`` and ``histogram_256_pallas``.
- :func:`apply_lut`: a per-channel 256-entry lookup of (N, C, P) uint8
  through a (C, 256) float32 LUT: ``⌊clip(lut[c, v], 0, 255)⌋`` as uint8, or
  ``clip(lut[c, v] / 255, 0, 1)`` as float32. The (C, 256) table of either
  form is made here, on the device, and the kernel only looks it up.
"""

from __future__ import annotations

import ctypes

import torch

from stainx_tpu_torch import kernels

_OUT_DTYPES = (torch.uint8, torch.float32)


# --------------------------------------------------------- plain versions
def _as_ncp(values_u8: torch.Tensor, what: str) -> torch.Tensor:
    if values_u8.dtype != torch.uint8:
        raise TypeError(f"{what} takes uint8 values, got {values_u8.dtype}")
    if values_u8.dim() == 2:
        return values_u8[None]
    if values_u8.dim() != 3:
        raise ValueError(f"{what} expects (N, C, P) or (C, P) values, got shape {tuple(values_u8.shape)}")
    return values_u8


def _flat_index(values: torch.Tensor) -> torch.Tensor:
    """c·256 + v for every element of (N, C, P) uint8, as int64."""
    chan = torch.arange(values.shape[1], device=values.device).reshape(1, -1, 1)
    return chan * 256 + values.long()


def histogram_256_plain(values_u8: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the histogram kernel (B8a/B8c): one
    ``bincount`` over c·256 + v."""
    values = _as_ncp(values_u8, "histogram_256")
    c = values.shape[1]
    counts = torch.bincount(_flat_index(values).reshape(-1), minlength=c * 256)
    return counts.reshape(c, 256).to(torch.float32)


def lut_table(lut: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """The (C, 256) table the apply kernel looks up: ``⌊clip(lut, 0, 255)⌋``
    as uint8, or ``clip(lut / 255, 0, 1)`` as float32."""
    lut = lut.to(torch.float32)
    if out_dtype == torch.uint8:
        return torch.floor(torch.clamp(lut, 0.0, 255.0)).to(torch.uint8).contiguous()
    return torch.clamp(lut / 255.0, 0.0, 1.0).contiguous()


def apply_lut_plain(values_u8, lut, out_dtype: torch.dtype = torch.uint8) -> torch.Tensor:
    """Plain PyTorch version of the LUT-apply kernel (B8b): a gather from
    the flattened table."""
    _check_apply(values_u8, lut, out_dtype)
    table = lut_table(torch.as_tensor(lut).to(values_u8.device), out_dtype)
    return table.reshape(-1)[_flat_index(values_u8)]


# --------------------------------------------------------------- wrappers
def _check_apply(values_u8, lut, out_dtype) -> None:
    if values_u8.dtype != torch.uint8:
        raise TypeError(f"apply_lut takes uint8 values, got {values_u8.dtype}")
    if values_u8.dim() != 3:
        raise ValueError(f"apply_lut expects (N, C, P) values, got shape {tuple(values_u8.shape)}")
    if tuple(lut.shape) != (values_u8.shape[1], 256):
        raise ValueError(f"apply_lut needs a ({values_u8.shape[1]}, 256) LUT, got {tuple(lut.shape)}")
    if out_dtype not in _OUT_DTYPES:
        raise TypeError(f"apply_lut writes uint8 or float32, not {out_dtype}")


def _lib() -> ctypes.CDLL:
    lib = kernels.library("histogram")
    if not getattr(lib, "_stainx_declared", False):
        ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.stainx_histogram_256.argtypes = [ptr, ptr, i64, i64, i32, i32, i32, ptr]
        lib.stainx_histogram_256.restype = i32
        lib.stainx_apply_lut.argtypes = [ptr, ptr, ptr, i64, i64, i32, i32, i32, i32, ptr]
        lib.stainx_apply_lut.restype = i32
        lib._stainx_declared = True
    return lib


def _vector_blocks(values: torch.Tensor) -> int:
    """Grid of a launch that reads 16 bytes a thread."""
    return kernels.grid_blocks(-(-values.numel() // 16), values.device)


def histogram_256(values_u8: torch.Tensor) -> torch.Tensor:
    """Per-channel 256-bin counts (B8a, and B8c for a (C, P) input): (N, C,
    P) or (C, P) uint8 → (C, 256) float32. One launch a call."""
    values = _as_ncp(values_u8, "histogram_256")
    if values.device.type == "cpu":
        return histogram_256_plain(values)
    kernels.check_cuda(values, "histogram_256")
    n, c, p = values.shape
    if n * p >= 2**31:
        raise ValueError(f"histogram_256 counts in int32: at most 2^31 - 1 values a channel, got {n * p}")
    counts = torch.zeros((c, 256), dtype=torch.int32, device=values.device)
    if values.numel() == 0:
        return counts.to(torch.float32)
    lib = _lib()
    with torch.cuda.device(values.device):
        code = lib.stainx_histogram_256(
            values.data_ptr(), counts.data_ptr(), values.numel(), p, c,
            int(values.data_ptr() % 16 == 0), _vector_blocks(values),
            torch.cuda.current_stream(values.device).cuda_stream,
        )
    kernels.check(lib, code, "histogram_256")
    histogram_256.launches += 1
    return counts.to(torch.float32)


def apply_lut(values_u8: torch.Tensor, lut: torch.Tensor, out_dtype: torch.dtype = torch.uint8):
    """Per-channel LUT apply (B8b): (N, C, P) uint8 and a (C, 256) LUT →
    (N, C, P) ``out_dtype``: uint8 ``⌊clip(lut[c, v], 0, 255)⌋`` or float32
    ``clip(lut[c, v] / 255, 0, 1)``. One launch a call."""
    _check_apply(values_u8, lut, out_dtype)
    if values_u8.device.type == "cpu":
        return apply_lut_plain(values_u8, lut, out_dtype)
    kernels.check_cuda(values_u8, "apply_lut")
    table = lut_table(torch.as_tensor(lut).to(values_u8.device), out_dtype)
    out = torch.empty(values_u8.shape, dtype=out_dtype, device=values_u8.device)
    if out.numel() == 0:
        return out
    n, c, p = values_u8.shape
    lib = _lib()
    with torch.cuda.device(values_u8.device):
        code = lib.stainx_apply_lut(
            values_u8.data_ptr(), out.data_ptr(), table.data_ptr(), values_u8.numel(), p, c,
            int(out_dtype == torch.float32),
            int(values_u8.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0),
            _vector_blocks(values_u8),
            torch.cuda.current_stream(values_u8.device).cuda_stream,
        )
    kernels.check(lib, code, "apply_lut")
    apply_lut.launches += 1
    return out


histogram_256.launches = 0
apply_lut.launches = 0
