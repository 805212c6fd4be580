"""The Reinhard kernels: wrappers, plain versions, counts.

Counterpart of ``stainx_tpu/kernels/reinhard_fused.py``. Both wrappers take
an (N, 3, H, W) uint8 or float32 tensor. On a CUDA tensor each launches its
hand-written kernel from ``csrc/reinhard_fused.cu`` (built at first use) or
raises; on a CPU tensor it runs its plain PyTorch version. Each wrapper is
a span, ``stainx.kernel.B7b``, ``stainx.kernel.B7a`` or, for
:func:`reinhard_transfer`, ``stainx.kernel.B7``, and counts the launches of
each kernel in ``launch.B7b`` and ``launch.B7a``
(:mod:`stainx_tpu_torch.profiling`).

- :func:`reinhard_moments`: the batch-global centred LAB sums Σ(LAB−128)
  and Σ(LAB−128)² per channel, read straight from the raw values. The
  kernel sums in float64 in a fixed order, so two runs give the same bits.
- :func:`reinhard_mean_std`: the same launch, whose finalize also writes
  the LAB mean and std from those sums (plain version
  :func:`moments_to_mean_std`).
- :func:`reinhard_apply`: RGB→LAB, ``(lab − μ)/(σ + 1e-8)·σ_ref + μ_ref``,
  LAB→RGB and the clip to [0, 1] in one pass; uint8 stores
  ``trunc(clip(x·255, 0, 255))``. The four (3,) statistics are device
  tensors read by the kernel.
- :func:`reinhard_transfer`: the transform, B7b then B7a on the statistics
  its finalize wrote, in one C call: nothing is issued between them.

Inside a profiler session, :func:`reinhard_transfer` on a CUDA tensor also
opens the span ``stainx.stats``, the call-wide statistics pass, as a child
of ``stainx.kernel.B7``. No Python runs between the C call's launches, so
the C call records the span's device interval itself: the wrapper passes
``stainx_reinhard_transform`` two CUDA timing events from
:func:`~stainx_tpu_torch.profiling.caller_timed`, and the C call records one
on the stream before the moments launch and one after their finalize, then
launches the apply. With no session running the wrapper passes two nulls
and nothing is recorded; the launches, their order and the outputs are the
same either way.

``LAB_MOMENT_CENTER`` and :func:`moments_to_mean_std` are shared with
:mod:`stainx_tpu_torch.ops.reinhard` and :mod:`stainx_tpu_torch.parallel`.

The plain versions are built on :mod:`stainx_tpu_torch.ops.color`, the JAX
package's formulas term by term. The kernels fold constants, fuse
multiply-adds and take powers on the special-function unit, so they differ
from them by a few ulps (gates: moments rtol 1e-4, atol 1e-2; apply 1 grey
level or 1/255).
"""

from __future__ import annotations

import ctypes

import torch

from stainx_tpu_torch import kernels, profiling
from stainx_tpu_torch.ops.color import lab_planes_to_rgb, normalize_to_float, rgb_planes_to_lab

# Moments accumulate about this shift (the middle of the 8-bit LAB encoding)
# so that Σx² − (Σx)²/n does not cancel; the centre does not change the
# mean and std algebraically.
LAB_MOMENT_CENTER = 128.0


# --------------------------------------------------------- plain versions
def moments_to_mean_std(n, s: torch.Tensor, sq: torch.Tensor):
    """Bessel-corrected mean and std from centred additive moments: the
    variance is ``max(sq − n·mean², 0) / max(n − 1, 1)``. ``n`` (a number
    or a float64 tensor) and ``max(n − 1, 1)``, taken in float64, enter as
    float32 tensors, so each step is one rounded float32 operation and both
    divisions are true divisions on any device: the plain version of what
    the moments kernel's finalize writes."""
    n64 = torch.as_tensor(n, dtype=torch.float64).to(s.device)
    nf = n64.to(torch.float32)
    den = torch.clamp(n64 - 1.0, min=1.0).to(torch.float32)
    mean_c = s / nf
    var = torch.clamp(sq - nf * mean_c * mean_c, min=0.0) / den
    return mean_c + LAB_MOMENT_CENTER, torch.sqrt(var)


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
def _stat(device, name: str, t) -> torch.Tensor:
    """A (3,) statistic as a contiguous float32 tensor on ``device``; such a
    tensor passes as it is."""
    if not (torch.is_tensor(t) and t.dtype == torch.float32 and t.device == device
            and t.dim() == 1 and t.is_contiguous()):
        t = torch.as_tensor(t).to(device=device, dtype=torch.float32).contiguous()
    if t.numel() != 3:
        raise ValueError(f"{name} must have 3 entries, got shape {tuple(t.shape)}")
    return t.reshape(3)


def _stats(device, *stats) -> list[torch.Tensor]:
    """The four (3,) statistics: LAB mean, std, reference mean, std."""
    names = ("lab_mean", "lab_std", "reference_mean", "reference_std")
    return [_stat(device, name, t) for name, t in zip(names, stats)]


def _lib() -> ctypes.CDLL:
    lib = kernels.library("reinhard_fused")
    if not getattr(lib, "_stainx_declared", False):
        ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.stainx_reinhard_moments.argtypes = [ptr, ptr, ptr, ptr, i64, i64, i32, i32, i32, ptr]
        lib.stainx_reinhard_moments.restype = i32
        lib.stainx_reinhard_apply.argtypes = [ptr] * 6 + [i64, i64, i32, i32, i32, ptr]
        lib.stainx_reinhard_apply.restype = i32
        lib.stainx_reinhard_transform.argtypes = [ptr] * 7 + [i64, i64, i32, i32, i32,
                                                              ptr, ptr, ptr]
        lib.stainx_reinhard_transform.restype = i32
        lib._stainx_declared = True
    return lib


# Groups an image: a thread steps its group in 32 bits, by at most twice
# the image's groups.
MAX_GROUPS = 2**31


def group_pixels(dtype: torch.dtype, pixels: int, aligned: bool) -> int:
    """Pixels a thread reads at once: 16 bytes of each channel plane (16
    uint8 or 4 float32 pixels) when every plane of the batch starts on a
    16-byte boundary, else one."""
    vec = 16 if dtype == torch.uint8 else 4
    return vec if aligned and pixels % vec == 0 else 1


def _launch_args(images: torch.Tensor) -> tuple[int, int, int, int, int, int]:
    """The arguments every C entry ends with, for a grid-stride launch over
    all groups of all images: (images, pixels an image, 1 for uint8, group
    pixels, blocks, stream)."""
    n, _, h, w = images.shape
    p = h * w
    vec = group_pixels(images.dtype, p, images.data_ptr() % 16 == 0)
    if p // vec > MAX_GROUPS:
        raise ValueError(f"an image of {p} pixels is more than the kernels' {MAX_GROUPS} "
                         f"groups of {vec}")
    blocks = kernels.grid_blocks(n * (p // vec), images.device)
    return (n, p, int(images.dtype == torch.uint8), vec, blocks,
            kernels.current_stream(images.device))


def _moments_scratch(device, blocks: int) -> tuple[torch.Tensor, torch.Tensor]:
    """B7b's (blocks, 6) float64 partials and its (12,) float32 output: the
    six sums, then the LAB mean (3) and std (3) the finalize writes."""
    return (torch.empty((blocks, 6), dtype=torch.float64, device=device),
            torch.empty(12, dtype=torch.float32, device=device))


def _moments(images: torch.Tensor) -> torch.Tensor:
    """One B7b launch: its (12,) float32 output."""
    kernels.check_cuda(images, "reinhard_moments")
    dev = images.device
    args = _launch_args(images)
    partials, out = _moments_scratch(dev, args[4])
    lib = _lib()
    with kernels.on_device(dev):
        code = lib.stainx_reinhard_moments(
            images.data_ptr(), partials.data_ptr(), out.data_ptr(), out.data_ptr() + 6 * 4, *args
        )
    kernels.check(lib, code, "reinhard_moments")
    profiling.count("launch.B7b")
    return out


def reinhard_moments(images: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Batch-global centred LAB moments (B7b): (N, 3, H, W) uint8/float32 →
    ``(Σ(LAB−128), Σ(LAB−128)²)``, each (3,) float32. One launch a call."""
    with profiling.annotate("stainx.kernel.B7b"):
        kernels.check_rgb_batch(images, "reinhard_moments")
        if images.device.type == "cpu":
            return reinhard_moments_plain(images)
        if images.numel() == 0:
            kernels.check_cuda(images, "reinhard_moments")
            out = torch.zeros(6, dtype=torch.float32, device=images.device)
            return out[:3], out[3:]
        out = _moments(images)
        return out[:3], out[3:6]


def reinhard_mean_std(images: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Batch-global LAB mean and std of (N, 3, H, W) uint8/float32, each
    (3,) float32: the B7b launch, whose finalize writes them on the device,
    or on the CPU :func:`reinhard_moments_plain` and ``moments_to_mean_std``."""
    with profiling.annotate("stainx.kernel.B7b"):
        kernels.check_rgb_batch(images, "reinhard_moments")
        n_px = images.shape[0] * images.shape[2] * images.shape[3]
        if images.device.type == "cpu" or images.numel() == 0:
            return moments_to_mean_std(n_px, *reinhard_moments(images))
        out = _moments(images)
        return out[6:9], out[9:]


def reinhard_apply(images, lab_mean, lab_std, reference_mean, reference_std) -> torch.Tensor:
    """Fused Reinhard apply (B7a): (N, 3, H, W) uint8/float32 and four (3,)
    statistics → the normalized batch in the input's shape and dtype (uint8
    in [0, 255], float32 in [0, 1]). One launch a call."""
    with profiling.annotate("stainx.kernel.B7a"):
        kernels.check_rgb_batch(images, "reinhard_apply")
        if images.device.type == "cpu":
            return reinhard_apply_plain(images, lab_mean, lab_std, reference_mean,
                                        reference_std)
        kernels.check_cuda(images, "reinhard_apply")
        dev = images.device
        stats = _stats(dev, lab_mean, lab_std, reference_mean, reference_std)
        out = torch.empty_like(images)
        if out.numel() == 0:
            return out
        lib = _lib()
        with kernels.on_device(dev):
            code = lib.stainx_reinhard_apply(images.data_ptr(), out.data_ptr(),
                                             *(s.data_ptr() for s in stats), *_launch_args(images))
        kernels.check(lib, code, "reinhard_apply")
        profiling.count("launch.B7a")
        return out


def reinhard_transfer(images: torch.Tensor, reference_mean, reference_std) -> torch.Tensor:
    """The Reinhard transform of (N, 3, H, W) uint8/float32 to the reference
    LAB statistics: B7b, whose finalize writes the batch's mean and std,
    then B7a on them, launched by one C call (one launch of each kernel);
    one host call keeps the host's issue time below the card's. On a CPU
    tensor, the plain versions."""
    with profiling.annotate("stainx.kernel.B7"):
        kernels.check_rgb_batch(images, "reinhard_transfer")
        if images.device.type == "cpu" or images.numel() == 0:
            mean, std = reinhard_mean_std(images)
            return reinhard_apply(images, mean, std, reference_mean, reference_std)
        kernels.check_cuda(images, "reinhard_transfer")
        dev = images.device
        ref_mean = _stat(dev, "reference_mean", reference_mean)
        ref_std = _stat(dev, "reference_std", reference_std)
        args = _launch_args(images)
        partials, small = _moments_scratch(dev, args[4])
        out = torch.empty_like(images)
        lib = _lib()
        call = (images.data_ptr(), out.data_ptr(), partials.data_ptr(), small.data_ptr(),
                small.data_ptr() + 6 * 4, ref_mean.data_ptr(), ref_std.data_ptr(), *args)
        with kernels.on_device(dev), profiling.caller_timed("stainx.stats", dev) as events:
            code = lib.stainx_reinhard_transform(*call, *(events or (None, None)))
        kernels.check(lib, code, "reinhard_transfer")
        profiling.count("launch.B7b")
        profiling.count("launch.B7a")
        return out

