"""Macenko stain normalization on tensors: fit and transform.

Counterpart of ``stainx_tpu/ops/macenko.py`` (constants Io=240, β=0.15,
α=1). Both entry points route to the kernel wrappers of
:mod:`stainx_tpu_torch.kernels.macenko_fused`: a CUDA tensor launches the
hand-written kernel, a CPU tensor runs its plain PyTorch version. The
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
    from stainx_tpu_torch.kernels.macenko_fused import macenko_transform_mega

    out = macenko_transform_mega(_kernel_input(images), stain_matrix, target_max_conc)
    if images.dtype not in _KERNEL_DTYPES:
        out = color.preserve_dtype(out, images.dtype, result_in_0_255_range=True)
    return (out, seed_state) if seed_state is not None else out


def macenko_fit(images: torch.Tensor, seed_state: torch.Tensor | None = None):
    """Fit the reference stain matrix (3, 2) and max concentrations (2,) on
    the pooled pixels of all N images: β-filter without the <3-pixel
    fallback, covariance and angle percentiles over the filtered pixels,
    concentration 99th percentiles over all pooled pixels. With
    ``seed_state`` the return is ``(he, maxc, seed_state)``."""
    from stainx_tpu_torch.kernels.macenko_fused import macenko_fit_mega

    he, maxc = macenko_fit_mega(_kernel_input(images))
    return (he, maxc, seed_state) if seed_state is not None else (he, maxc)
