"""Reinhard stain normalization on tensors: fit and transform.

Counterpart of ``stainx_tpu/ops/reinhard.py``: batch-global LAB mean and
std (Bessel-corrected), z-score against the source statistics with a
``+1e-8`` eps, rescale to the reference statistics, LAB→RGB, clamp, dtype
restore. Both entry points route to the kernel wrappers of
:mod:`stainx_tpu_torch.kernels.reinhard_fused`, the JAX package's
``use_pallas=True`` route: the fit is the LAB-moments kernel, whose
finalize also turns the sums into the mean and std as
:func:`moments_to_mean_std` does (the additive form of
``reinhard_fit_sharded``); the transform is the moments kernel, then the
fused apply kernel on the statistics the finalize wrote on the device, one
C call with nothing issued between them. A CUDA tensor launches the
kernels, a CPU tensor runs their plain PyTorch versions. The kernels take
uint8 and float32; other float dtypes are cast to float32 [0, 1] around
them and cast back.

Source statistics are **batch-global**: mean and std over N·H·W at once.
"""

from __future__ import annotations

import torch

from stainx_tpu_torch.kernels import reinhard_fused
from stainx_tpu_torch.kernels.reinhard_fused import LAB_MOMENT_CENTER, moments_to_mean_std
from stainx_tpu_torch.ops import color

_KERNEL_DTYPES = (torch.uint8, torch.float32)


def lab_moments(
    images: torch.Tensor,
    weights: torch.Tensor | None = None,
    valid_rows: torch.Tensor | None = None,
) -> tuple[float, torch.Tensor, torch.Tensor]:
    """Per-channel CENTERED LAB pixel count, sum and sum of squares of an
    (N, 3, H, W) batch: ``(n, (3,), (3,))``, the additive statistics the
    distributed fit reduces. Consume with :func:`moments_to_mean_std`.

    ``weights`` ((N,) 0/1, optional) marks the real batch rows and
    ``valid_rows`` ((H,) bool, optional) the real pixel rows; ``n`` is the
    exact product of the factor sums. Unweighted, the sums come from the
    moments kernel (B7b, :func:`~stainx_tpu_torch.kernels.reinhard_fused.
    reinhard_moments`; its plain version on the CPU). Weighted on the CPU,
    the weight stays factored as an (N, 1, H, 1) broadcast into float64
    sums; weighted on CUDA, B7b runs on the rows the weights keep, picked
    by a boolean index (which reads the weights back to the host)."""
    if weights is None and valid_rows is None:
        s, sq = reinhard_fused.reinhard_moments(_kernel_input(images))
        return float(images.shape[0] * images.shape[2] * images.shape[3]), s, sq
    rw = torch.ones(images.shape[0]) if weights is None else (weights > 0).to(torch.float32)
    rv = torch.ones(images.shape[2]) if valid_rows is None else valid_rows.to(torch.float32)
    rw, rv = rw.to(images.device), rv.to(images.device)
    if images.is_cuda:
        kept = images[rw > 0][:, :, rv > 0]
        s, sq = reinhard_fused.reinhard_moments(_kernel_input(kept))
        return float(kept.shape[0] * kept.shape[2] * kept.shape[3]), s, sq
    lab = color.rgb_to_lab(images, channel_axis=1) - LAB_MOMENT_CENTER
    wpx = (rw[:, None, None, None] * rv[None, None, :, None]).to(torch.float64)
    n = float(rw.sum()) * float(rv.sum()) * float(images.shape[3])
    s = (lab.to(torch.float64) * wpx).sum(dim=(0, 2, 3))
    sq = ((lab * lab).to(torch.float64) * wpx).sum(dim=(0, 2, 3))
    return n, s.to(torch.float32), sq.to(torch.float32)


def _kernel_input(images: torch.Tensor) -> torch.Tensor:
    if images.dtype in _KERNEL_DTYPES:
        return images.contiguous()
    return color.normalize_to_float(images).contiguous()


def reinhard_fit(images: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Reference LAB mean and std over the whole (N, 3, H, W) batch, each (3,)."""
    return reinhard_fused.reinhard_mean_std(_kernel_input(images))


def reinhard_transform(
    images: torch.Tensor, reference_mean: torch.Tensor, reference_std: torch.Tensor
) -> torch.Tensor:
    """Transform an (N, 3, H, W) batch to the reference LAB statistics. The
    output has the input's dtype: uint8 in [0, 255] (truncated), floats in
    [0, 1]."""
    out = reinhard_fused.reinhard_transfer(_kernel_input(images), reference_mean, reference_std)
    if images.dtype not in _KERNEL_DTYPES:
        out = color.preserve_dtype(out, images.dtype)
    return out


def reinhard_fit_sharded(
    images: torch.Tensor,
    *,
    group=None,
    weights: torch.Tensor | None = None,
    valid_rows: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Distributed fit: the LAB moments of :func:`lab_moments` on this
    rank's shard, reduced over the process ``group`` (``None``: the
    default group) exactly, as
    :func:`stainx_tpu_torch.parallel.distributed.rank_sum` adds them: the
    same mean and std on every rank. ``weights`` and ``valid_rows`` are
    :func:`lab_moments`'s."""
    # parallel.distributed imports this module, and the name mirrors the
    # JAX package's ops API: import it at the call.
    from stainx_tpu_torch.parallel.distributed import rank_sum

    n, s, sq = lab_moments(images, weights, valid_rows)
    n, sums = rank_sum(n, torch.cat([s, sq]), group)
    return moments_to_mean_std(n, sums[:3], sums[3:])
