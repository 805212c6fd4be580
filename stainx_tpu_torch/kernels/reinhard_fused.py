"""The Reinhard kernels: wrappers, plain versions, counts.

Counterpart of ``stainx_tpu/kernels/reinhard_fused.py``. Both wrappers take
an (N, 3, H, W) uint8 or float32 tensor. On a CUDA tensor each launches its
hand-written kernel from ``csrc/reinhard_fused.cu`` (built at first use) or
raises; on a CPU tensor it runs its plain PyTorch version. Each wrapper
counts its launches in its ``launches`` attribute.

- :func:`reinhard_moments`: the batch-global centred LAB sums Σ(LAB−128)
  and Σ(LAB−128)² per channel, read straight from the raw values. The
  kernel sums in float64 in a fixed order, so two runs give the same bits.
- :func:`reinhard_apply`: RGB→LAB, ``(lab − μ)/(σ + 1e-8)·σ_ref + μ_ref``,
  LAB→RGB and the clip to [0, 1] in one pass; uint8 stores
  ``trunc(clip(x·255, 0, 255))``. The four (3,) statistics are device
  tensors read by the kernel, so nothing returns to the host between the
  two kernels.

The plain versions are built on :mod:`stainx_tpu_torch.ops.color`, whose
plane functions evaluate the colour formulas in the kernels' order.
"""

from __future__ import annotations

import ctypes

import torch

from stainx_tpu_torch import kernels
from stainx_tpu_torch.ops.color import lab_planes_to_rgb, normalize_to_float, rgb_planes_to_lab
from stainx_tpu_torch.ops.reinhard import LAB_MOMENT_CENTER


# --------------------------------------------------------- plain versions
def _planes(images: torch.Tensor):
    n, _, h, w = images.shape
    x = normalize_to_float(images).reshape(n, 3, h * w)
    return [x[:, 0], x[:, 1], x[:, 2]]


def reinhard_moments_plain(images: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the moments kernel (B7b): centred LAB sums
    in float32 terms, summed in float64, returned as two (3,) float32."""
    kernels.check_rgb_batch(images, "reinhard_moments")
    ys = [lab - LAB_MOMENT_CENTER for lab in rgb_planes_to_lab(_planes(images))]
    s1 = torch.stack([y.to(torch.float64).sum() for y in ys])
    s2 = torch.stack([(y * y).to(torch.float64).sum() for y in ys])
    return s1.to(torch.float32), s2.to(torch.float32)


def reinhard_apply_plain(images, lab_mean, lab_std, reference_mean, reference_std) -> torch.Tensor:
    """Plain PyTorch version of the fused apply kernel (B7a)."""
    kernels.check_rgb_batch(images, "reinhard_apply")
    mean, std, ref_mean, ref_std = _stats(
        images.device, lab_mean, lab_std, reference_mean, reference_std
    )
    lab = rgb_planes_to_lab(_planes(images))
    lab = [((lab[c] - mean[c]) / (std[c] + 1e-8)) * ref_std[c] + ref_mean[c] for c in range(3)]
    rgb = torch.stack([torch.clamp(p, 0.0, 1.0) for p in lab_planes_to_rgb(lab)], dim=1)
    if images.dtype == torch.uint8:
        rgb = torch.clamp(rgb * 255.0, 0.0, 255.0).to(torch.int32).to(torch.uint8)
    return rgb.reshape(images.shape)


# --------------------------------------------------------------- wrappers
def _stats(device, *stats) -> list[torch.Tensor]:
    """The four (3,) statistics (LAB mean, std, reference mean, std) as
    contiguous float32 tensors on ``device``."""
    names = ("lab_mean", "lab_std", "reference_mean", "reference_std")
    out = []
    for name, t in zip(names, stats):
        t = torch.as_tensor(t).to(device=device, dtype=torch.float32).contiguous()
        if t.numel() != 3:
            raise ValueError(f"{name} must have 3 entries, got shape {tuple(t.shape)}")
        out.append(t.reshape(3))
    return out


def _lib() -> ctypes.CDLL:
    lib = kernels.library("reinhard_fused")
    if not getattr(lib, "_stainx_declared", False):
        ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.stainx_reinhard_moments.argtypes = [ptr, ptr, ptr, i64, i64, i32, i32, i32, ptr]
        lib.stainx_reinhard_moments.restype = i32
        lib.stainx_reinhard_apply.argtypes = [
            ptr, ptr, ptr, ptr, ptr, ptr, i64, i64, i32, i32, i32, ptr
        ]
        lib.stainx_reinhard_apply.restype = i32
        lib._stainx_declared = True
    return lib


def _launch_shape(images: torch.Tensor) -> tuple[int, int]:
    """(pixels a thread reads at once, blocks) of a launch: 4 pixels when
    rows are 16-byte aligned, one otherwise."""
    n, _, h, w = images.shape
    p = h * w
    vec = 4 if p % 4 == 0 and images.data_ptr() % 16 == 0 else 1
    return vec, kernels.grid_blocks(n * p // vec, images.device)


def reinhard_moments(images: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Batch-global centred LAB moments (B7b): (N, 3, H, W) uint8/float32 →
    ``(Σ(LAB−128), Σ(LAB−128)²)``, each (3,) float32. One launch a call."""
    kernels.check_rgb_batch(images, "reinhard_moments")
    if images.device.type == "cpu":
        return reinhard_moments_plain(images)
    kernels.check_cuda(images, "reinhard_moments")
    n, _, h, w = images.shape
    dev = images.device
    if images.numel() == 0:
        out = torch.zeros(6, dtype=torch.float32, device=dev)
        return out[:3], out[3:]
    out = torch.empty(6, dtype=torch.float32, device=dev)
    vec, blocks = _launch_shape(images)
    partials = torch.empty((blocks, 6), dtype=torch.float64, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        code = lib.stainx_reinhard_moments(
            images.data_ptr(), partials.data_ptr(), out.data_ptr(), n, h * w,
            int(images.dtype == torch.uint8), vec, blocks,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    kernels.check(lib, code, "reinhard_moments")
    reinhard_moments.launches += 1
    return out[:3], out[3:]


def reinhard_apply(images, lab_mean, lab_std, reference_mean, reference_std) -> torch.Tensor:
    """Fused Reinhard apply (B7a): (N, 3, H, W) uint8/float32 and four (3,)
    statistics → the normalized batch in the input's shape and dtype (uint8
    in [0, 255], float32 in [0, 1]). One launch a call."""
    kernels.check_rgb_batch(images, "reinhard_apply")
    if images.device.type == "cpu":
        return reinhard_apply_plain(images, lab_mean, lab_std, reference_mean, reference_std)
    kernels.check_cuda(images, "reinhard_apply")
    dev = images.device
    stats = _stats(dev, lab_mean, lab_std, reference_mean, reference_std)
    out = torch.empty_like(images)
    if out.numel() == 0:
        return out
    n, _, h, w = images.shape
    vec, blocks = _launch_shape(images)
    lib = _lib()
    with torch.cuda.device(dev):
        code = lib.stainx_reinhard_apply(
            images.data_ptr(), out.data_ptr(), *(s.data_ptr() for s in stats), n, h * w,
            int(images.dtype == torch.uint8), vec, blocks,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    kernels.check(lib, code, "reinhard_apply")
    reinhard_apply.launches += 1
    return out


reinhard_moments.launches = 0
reinhard_apply.launches = 0
