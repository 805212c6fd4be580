"""Macenko stain normalization on tensors: fit and transform.

Counterpart of ``stainx_tpu/ops/macenko.py`` (constants Io=240, β=0.15,
α=1). Both entry points route by size to the kernel wrappers of
:mod:`stainx_tpu_torch.kernels.macenko_fused` (B1, B2: one thread block per
image or pool) or :mod:`stainx_tpu_torch.kernels.macenko_stream` (B4, B5:
a row split across many blocks): a CUDA tensor launches the hand-written
kernel, a CPU tensor runs its plain PyTorch version. The
kernels take uint8 and float32; other float dtypes are cast to float32
[0, 1] around the kernel and cast back, so bf16, f16 and f64 run on the
card too.

``seed_state`` is the (7,) int32 cross-call state of the JAX kernels. The
CUDA kernels run the images of a batch in parallel and need no probe seeds,
so the state is passed through unchanged, as the JAX non-kernel routes do
(``stainx_tpu/ops/macenko.py:345-353,514-515``).
"""

from __future__ import annotations

import torch

from stainx_tpu_torch.ops import color

IO = 240.0
BETA = 0.15
ALPHA = 1  # integer percent: percentile ranks are computed exactly

_KERNEL_DTYPES = (torch.uint8, torch.float32)

# The H100's size ladder, from the sweep of B1 against B4 and B2 against B5
# in chip_smoke.py phase 5 (H100 80GB HBM3, 700 W). B1 and B2 run one
# thread block per image or pool, so up to a wave of images B1 costs the
# time of one image; B4 and B5 spread a row over the card, and below about
# 0.13 ms on the device their call is bound by its host cost, which varied
# from 0.20 to 0.76 ms between rounds and runs. A multi-block kernel takes a
# size only where the one-block kernel's device time exceeds that slowest
# host-bound call (0.76 ms) and the multi-block kernel was faster as called
# in every round; elsewhere, and where rounds overlapped, the one-block
# kernel keeps it.
# Transform (B4): rows of at least 147 456 uint8 pixels (384²; B1 0.79 ms)
# or 82 944 float32 (288²; B1 0.78 ms, three logf a pixel a pass), and at
# most 64 rows: B4's time grows with the rows while B1's stays one wave.
# Past 64 rows B4's wins were thin or did not repeat: 96 rows of 512²
# uint8 by 7 %, 112 lost; 256 rows of 224² float32 overlapped in one run.
STREAM_MIN_ELEMS = 147_456
STREAM_MIN_ELEMS_F32 = 82_944
STREAM_MAX_ROWS = 64
# Fit (B5): pools of at least 200 704 uint8 pixels (448²; B2 0.96 ms) or
# 102 400 float32 (320²; B2 0.83 ms).
FIT_STREAM_MIN_ELEMS = 200_704
FIT_STREAM_MIN_ELEMS_F32 = 102_400


def transform_route(n: int, p: int, dtype: torch.dtype) -> str:
    """``"stream"`` (B4) or ``"mega"`` (B1) for N rows of P pixels of the
    kernel input ``dtype`` (uint8 or float32)."""
    floor = STREAM_MIN_ELEMS if dtype == torch.uint8 else STREAM_MIN_ELEMS_F32
    return "stream" if p >= floor and n <= STREAM_MAX_ROWS else "mega"


def fit_route(pixels: int, dtype: torch.dtype) -> str:
    """``"stream"`` (B5) or ``"mega"`` (B2) for a pool of that many pixels."""
    floor = FIT_STREAM_MIN_ELEMS if dtype == torch.uint8 else FIT_STREAM_MIN_ELEMS_F32
    return "stream" if pixels >= floor else "mega"


def optical_density(images_float: torch.Tensor) -> torch.Tensor:
    """OD = −log((I·255 + 1) / Io) for float [0, 1] images."""
    return -torch.log((images_float * 255.0 + 1.0) / IO)


def maxc_scale(tmc: torch.Tensor, maxc: torch.Tensor) -> torch.Tensor:
    """``tmc / maxC`` with the sign-preserving floor: a uniform tile's maxC
    of 0 becomes 1e-30 (finite scale), while a negative 99th-percentile
    concentration divides through unchanged, like the reference."""
    return tmc / torch.where(maxc.abs() > 1e-30, maxc, 1e-30)


def rescale_and_reconstruct(
    c0: torch.Tensor,
    c1: torch.Tensor,
    max_c0: torch.Tensor,
    max_c1: torch.Tensor,
    target_max_conc: torch.Tensor,
    stain_matrix: torch.Tensor,
) -> torch.Tensor:
    """maxC guard, concentration rescale and Beer–Lambert reconstruction.
    ``c0``/``c1`` are (N, P) concentration planes, ``max_c*`` their (N,)
    99th percentiles; returns clipped RGB (N, 3, P) float32 in [0, 255]."""
    tmc = target_max_conc.reshape(-1).to(device=c0.device, dtype=torch.float32)
    cn0 = c0 * maxc_scale(tmc[0], max_c0)[:, None]
    cn1 = c1 * maxc_scale(tmc[1], max_c1)[:, None]
    stain = stain_matrix.to(device=c0.device, dtype=torch.float32)
    od_recon = torch.stack([cn0 * stain[i, 0] + cn1 * stain[i, 1] for i in range(3)], dim=1)
    return torch.clamp(IO * torch.exp(-od_recon), 0.0, 255.0)


def _kernel_input(images: torch.Tensor) -> torch.Tensor:
    if images.dtype in _KERNEL_DTYPES:
        return images.contiguous()
    return color.normalize_to_float(images).contiguous()


def macenko_transform(
    images: torch.Tensor,
    stain_matrix: torch.Tensor,
    target_max_conc: torch.Tensor,
    seed_state: torch.Tensor | None = None,
):
    """Normalize an (N, 3, H, W) batch to the fitted stain matrix (3, 2) and
    max concentrations (2,). Output range [0, 255] in the input dtype. With
    ``seed_state`` the return is ``(out, seed_state)``."""
    from stainx_tpu_torch.kernels import macenko_fused, macenko_stream

    x = _kernel_input(images)
    if transform_route(x.shape[0], x.shape[2] * x.shape[3], x.dtype) == "stream":
        kernel = macenko_stream.macenko_transform_stream
    else:
        kernel = macenko_fused.macenko_transform_mega
    out = kernel(x, stain_matrix, target_max_conc)
    if images.dtype not in _KERNEL_DTYPES:
        out = color.preserve_dtype(out, images.dtype, result_in_0_255_range=True)
    return (out, seed_state) if seed_state is not None else out


def macenko_fit(images: torch.Tensor, seed_state: torch.Tensor | None = None):
    """Fit the reference stain matrix (3, 2) and max concentrations (2,) on
    the pooled pixels of all N images: β-filter without the <3-pixel
    fallback, covariance and angle percentiles over the filtered pixels,
    concentration 99th percentiles over all pooled pixels. With
    ``seed_state`` the return is ``(he, maxc, seed_state)``."""
    from stainx_tpu_torch.kernels import macenko_fused, macenko_stream

    x = _kernel_input(images)
    n, _, h, w = x.shape
    if fit_route(n * h * w, x.dtype) == "stream":
        kernel = macenko_stream.macenko_fit_stream
    else:
        kernel = macenko_fused.macenko_fit_mega
    he, maxc = kernel(x)
    return (he, maxc, seed_state) if seed_state is not None else (he, maxc)
