"""Sharded fits and transforms over a process group, and the mesh-level
wrappers.

Counterpart of ``stainx_tpu/parallel/distributed.py`` on
``torch.distributed``. Every ``*_sharded`` function takes this rank's NCHW
shard and the process ``group`` covering every rank the data is sharded
over (``None``: the default group), and returns the same fitted
parameters on every rank. Their local statistics run on the port's
kernels on a CUDA tensor (their plain versions on the CPU): the LAB sums
on B7b and the Reinhard apply on B7a, the 256-bin counts on B8a, the LUT
build on the histogram finalize and its apply on B8b. What JAX leaves to
XLA stays eager PyTorch: the masked OD moments, ``atan2``, the key-level
byte counts of :mod:`~stainx_tpu_torch.parallel.percentile` and the
pixel-sharded reconstruction.

Reductions follow one rule. Integers (histogram counts, key-level counts,
pixel counts) go through ``all_reduce``: exact in any order. Float
partials (LAB sums, masked OD moments, the pixel-sharded transform's two
passes) go through ``all_gather`` of each rank's small vector, and every
rank adds the vectors in rank order (:func:`rank_sum`): the same bits on
every rank and every run, whatever the number of ranks. The sums stay
float32, as in JAX; only their order is fixed.

The mesh wrappers :func:`fit_on_mesh` and :func:`transform_on_mesh` take
either a plain tensor (or array), the single-controller case: every rank
holds the global batch, N is zero-padded to the batch axis and H to the
pixel axis, and each rank takes the shard of its mesh coordinate; or a
``DTensor`` already sharded ``Shard(0)`` on the batch axis (and
``Shard(2)`` on the pixel axis), the multi-controller case, whose local
shard is used as it is (a ``DTensor`` of another mesh is first brought
onto the call's, :func:`onto_mesh`). Such a ``DTensor`` needs N divisible
by the batch axis and H by the pixel axis, since padding is a global
operation.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from stainx_tpu_torch.kernels import histogram as hist_kernels
from stainx_tpu_torch.kernels.reinhard_fused import reinhard_apply
from stainx_tpu_torch.ops import color
from stainx_tpu_torch.ops import macenko as macenko_ops
from stainx_tpu_torch.ops import reinhard as reinhard_ops
from stainx_tpu_torch.ops.eigh3 import eigh3_top2
from stainx_tpu_torch.parallel.mesh import axis_group, check_axis, mesh_device, placements
from stainx_tpu_torch.parallel.percentile import distributed_masked_percentile


def _gather(t: torch.Tensor, group) -> list[torch.Tensor]:
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return parts


def rank_sum(count, values: torch.Tensor, group=None):
    """``(Σ count, Σ values)`` over the ranks of ``group``: each rank's
    ``count`` (a number of pixels, exact in float64) and float32
    ``values`` travel in one ``all_gather``, and every rank adds them in
    rank order, so every rank gets the same bits on every run. Returns a
    float64 0-d count and float32 sums of ``values``' shape."""
    flat = values.reshape(-1)
    packed = torch.cat([torch.as_tensor([count], dtype=torch.float64).to(flat.device),
                        flat.to(torch.float64)])
    parts = _gather(packed, group)
    n, acc = parts[0][0], parts[0][1:].to(torch.float32)
    for part in parts[1:]:
        n = n + part[0]
        acc = acc + part[1:].to(torch.float32)
    return n, acc.reshape(values.shape)


# --------------------------------------------------------------- Reinhard


def reinhard_fit_sharded(images, *, group=None, weights=None, valid_rows=None):
    """Exact distributed Reinhard fit: the LAB moments of this rank's
    shard (B7b) added over ``group`` (:func:`stainx_tpu_torch.ops.
    reinhard.reinhard_fit_sharded`). ``weights`` ((N_local,) 0/1) and
    ``valid_rows`` ((H_local,) bool) mark real rows when the batch or H
    was zero-padded; on CUDA a weighted shard runs B7b on the rows a
    boolean index keeps, which reads the masks back to the host."""
    return reinhard_ops.reinhard_fit_sharded(
        images, group=group, weights=weights, valid_rows=valid_rows
    )


def _reinhard_apply(images, mean, std, reference_mean, reference_std):
    """B7a on the shard with the global statistics, in the input's dtype."""
    out = reinhard_apply(reinhard_ops._kernel_input(images), mean, std, reference_mean,
                         reference_std)
    if images.dtype not in reinhard_ops._KERNEL_DTYPES:
        out = color.preserve_dtype(out, images.dtype)
    return out


def reinhard_transform_sharded(
    images, reference_mean, reference_std, *, group=None, weights=None, valid_rows=None
):
    """Sharded Reinhard transform with **batch-global** source statistics:
    the shard's LAB sums (B7b) added over ``group``, then B7a on the shard.
    ``weights`` and ``valid_rows`` (as :func:`reinhard_fit_sharded`'s) keep
    padded rows out of the statistics; their outputs are garbage and the
    caller slices them off."""
    mean, std = reinhard_fit_sharded(images, group=group, weights=weights, valid_rows=valid_rows)
    return _reinhard_apply(images, mean, std, reference_mean, reference_std)


# ------------------------------------------------------- Histogram matching


def _local_histogram(images_u8, weights=None, valid_rows=None):
    """Per-channel 256-bin counts of the local (N, C, H, W) uint8 shard
    (B8a) as int64, with rows of weight 0 and, with ``valid_rows``, padded
    pixel rows left out: they are zeroed, land in bin 0, and bin 0 loses
    exactly their number. Returns ``(counts (C, 256), valid pixels)``, the
    latter an int, or an int64 tensor when masks are given."""
    n, c, h, w = images_u8.shape
    n_valid, h_valid = n, h
    if weights is not None:
        keep = (weights > 0).to(images_u8.device)
        images_u8 = images_u8 * keep.to(torch.uint8)[:, None, None, None]
        n_valid = keep.sum(dtype=torch.int64)
    if valid_rows is not None:
        rows = valid_rows.to(device=images_u8.device, dtype=torch.bool)
        images_u8 = images_u8 * rows.to(torch.uint8)[None, None, :, None]
        h_valid = rows.sum(dtype=torch.int64)
    counts = hist_kernels.histogram_256(images_u8.contiguous().reshape(n, c, h * w))
    counts = counts.to(torch.int64)
    valid_px = n_valid * h_valid * w
    if weights is not None or valid_rows is not None:
        counts[:, 0] -= n * h * w - valid_px
    return counts, valid_px


def hm_fit_sharded(images, *, group=None, channel_axis: int = 1, weights=None, valid_rows=None):
    """Exact distributed HM fit: the shard's 256-bin counts (B8a) added
    over ``group`` as integers, normalized as the single-device fit does.
    ``weights`` and ``valid_rows`` as :func:`_local_histogram`'s."""
    images_cf, _ = color._nchw(images, channel_axis)
    images_u8, _ = color.images_to_uint8(images_cf)
    counts, _ = _local_histogram(images_u8, weights, valid_rows)
    dist.all_reduce(counts, group=group)
    return hist_kernels.normalized_histogram(counts.to(torch.float32))


def _hm_lut(stats_u8, ref_histograms, group, out_dtype, num_pixels=None,
            weights=None, valid_rows=None):
    """The LUT of the batch-global source counts: the shard's counts (B8a)
    and valid pixels added over ``group`` in one integer ``all_reduce``,
    then the finalize on the card (:func:`~stainx_tpu_torch.kernels.
    histogram.hm_lut`). ``num_pixels``, the global count, when the caller
    knows it; else it is read back from the reduced counts."""
    counts, valid_px = _local_histogram(stats_u8, weights, valid_rows)
    c = counts.shape[0]
    packed = torch.cat([counts.reshape(-1), torch.as_tensor(valid_px).reshape(1).to(counts)])
    dist.all_reduce(packed, group=group)
    total = int(packed[-1]) if num_pixels is None else num_pixels
    ref = torch.as_tensor(ref_histograms).to(device=counts.device, dtype=torch.float32)
    return hist_kernels.hm_lut(packed[:-1].reshape(c, 256), ref.contiguous(), total, out_dtype)[0]


def _hm_apply(images_u8, lut, out_dtype, original_dtype, needs_permute):
    """B8b: the LUT applied to the (N, C, H, W) uint8 shard, in the input's
    dtype and layout."""
    n, c, h, w = images_u8.shape
    out = hist_kernels.apply_lut(images_u8.contiguous().reshape(n, c, h * w), lut, out_dtype)
    out = out.to(original_dtype).reshape(n, c, h, w)
    return out.permute(0, 2, 3, 1) if needs_permute else out


def hm_transform_sharded(
    images, ref_histograms, *, group=None, channel_axis: int = 1, weights=None, valid_rows=None
):
    """Sharded HM transform with **batch-global** source CDFs: the shard's
    counts (B8a) added over ``group``, the LUT built on the card from them,
    then B8b on the shard. ``weights`` and ``valid_rows`` keep padded rows
    out of the counts; their outputs are garbage and the caller slices them
    off. The global pixel count is read back to the host once, for the
    LUT build."""
    original_dtype = images.dtype
    images_cf, needs_permute = color._nchw(images, channel_axis)
    images_u8, scale_back = color.images_to_uint8(images_cf)
    out_dtype = torch.float32 if scale_back else torch.uint8
    lut = _hm_lut(images_u8, ref_histograms, group, out_dtype, weights=weights,
                  valid_rows=valid_rows)
    return _hm_apply(images_u8, lut, out_dtype, original_dtype, needs_permute)


# ----------------------------------------------------------------- Macenko


def macenko_fit_sharded(images, *, group=None, weights=None, valid_rows=None):
    """Distributed Macenko fit over the pooled pixels of every rank's
    shard: the β-masked OD moments added over ``group`` in rank order, the
    covariance from them (:func:`~stainx_tpu_torch.ops.macenko.
    cov_from_moments`), ``eigh3_top2``, ``atan2`` of the stain-plane
    projection, the α and 100−α angle percentiles in one nested descent and
    the two concentration 99th percentiles, all exact
    (:func:`~stainx_tpu_torch.parallel.percentile.
    distributed_masked_percentile`). ``weights`` ((N_local,) 0/1) and
    ``valid_rows`` ((H_local,) bool) leave padded rows out of every mask.
    Returns ``(HE (3, 2), maxC (2,))``, the same on every rank."""
    images_float = color.normalize_to_float(images)
    n, _, h, w = images_float.shape
    p_local = n * h * w
    od = macenko_ops.optical_density(images_float)
    od_c = tuple(od[:, i].reshape(1, p_local) for i in range(3))

    valid = None
    if weights is not None or valid_rows is not None:
        dev = od.device
        bv = torch.ones(n, dtype=torch.bool, device=dev) if weights is None else (
            (weights > 0).to(dev))
        rv = torch.ones(h, dtype=torch.bool, device=dev) if valid_rows is None else (
            valid_rows.to(device=dev, dtype=torch.bool))
        valid = (bv[:, None, None] & rv[None, :, None]).expand(n, h, w).reshape(1, p_local)

    mask = torch.minimum(torch.minimum(od_c[0], od_c[1]), od_c[2]) >= macenko_ops.BETA
    if valid is not None:
        mask = mask & valid
    cnt, s1, s2 = macenko_ops.masked_od_moments(od_c, mask.to(torch.float32))
    _, moments = rank_sum(0, torch.cat([cnt, s1.reshape(-1), s2.reshape(-1)]), group)
    cov = macenko_ops.cov_from_moments(moments[:1], moments[1:4].reshape(1, 3),
                                       moments[4:].reshape(1, 3, 3))
    evecs = eigh3_top2(cov)  # (1, 3, 2), the same on every rank

    t0, t1 = macenko_ops._project_plane(od_c, evecs, torch.float32)
    phi = torch.atan2(t1, t0)[0]
    alpha = macenko_ops.ALPHA
    phi_pair = distributed_masked_percentile(phi[None], mask, ((alpha, 100 - alpha),), group)[0]
    he = macenko_ops._he_from_phi_extremes(evecs, phi_pair[:1], phi_pair[1:])  # (1, 3, 2)
    c0, c1 = macenko_ops._concentrations_2x2(he, od_c)
    c_mask = None if valid is None else torch.cat([valid, valid])
    max_conc = distributed_masked_percentile(torch.cat([c0, c1]), c_mask, (99, 99), group)
    return he[0], max_conc


def macenko_transform_sharded(
    images, stain_matrix, target_max_conc, *, group=None, precision: str = "stable", valid=None
):
    """Pixel-sharded Macenko transform: per-image statistics of images
    whose pixel rows are spread over the ranks of ``group``, which covers
    ONLY the mesh axes the pixels are sharded over (a batch axis holds
    other images and must not be reduced here).

    The semantics of :func:`stainx_tpu_torch.ops.macenko.macenko_transform`:
    the β-mask with the all-pixels fallback when fewer than 3 pixels
    survive, decided on the GLOBAL count; a two-pass covariance (the
    means, then the centred moments, each an (N, ≤ 9) ``rank_sum``, as a
    uniform background tile needs); nearest-rank percentiles; the 2×2
    normal equations and the sign-preserving maxC guard. The
    reconstruction is local, in bfloat16 under ``precision="fast"``.
    ``valid`` ((N, H_local, W) or (N, P_local) bool) marks real pixels when
    H was padded to the pixel axis."""
    original_dtype = images.dtype
    images_float = color.normalize_to_float(images)
    n, c, h, w = images_float.shape
    p_local = h * w
    od = macenko_ops.optical_density(images_float).reshape(n, 3, p_local)
    od_c = (od[:, 0], od[:, 1], od[:, 2])
    all_mask = torch.ones((n, p_local), dtype=torch.bool, device=od.device) if valid is None else (
        valid.reshape(n, p_local).to(device=od.device, dtype=torch.bool))
    mask = (torch.minimum(torch.minimum(od_c[0], od_c[1]), od_c[2]) >= macenko_ops.BETA) & all_mask

    w_m, w_a = mask.to(torch.float32), all_mask.to(torch.float32)
    pass1 = torch.stack([w_m.sum(-1), w_a.sum(-1)] + [(w_m * od_c[i]).sum(-1) for i in range(3)]
                        + [(w_a * od_c[i]).sum(-1) for i in range(3)], dim=-1)  # (N, 8)
    _, pass1 = rank_sum(0, pass1, group)
    cnt, cnt_a, s1, s1_a = pass1[:, 0], pass1[:, 1], pass1[:, 2:5], pass1[:, 5:8]
    use_all = cnt < 3
    cnt_eff = torch.where(use_all, cnt_a, cnt)
    mu = torch.where(use_all[:, None], s1_a, s1) / torch.clamp(cnt_eff, min=1.0)[:, None]
    eff_mask = (mask | use_all[:, None]) & all_mask
    w_eff = eff_mask.to(torch.float32)
    centred = [od_c[i] - mu[:, i, None] for i in range(3)]
    s2c = torch.stack([torch.stack([(w_eff * centred[i] * centred[j]).sum(-1) for j in range(3)],
                                   dim=-1) for i in range(3)], dim=-2)  # (N, 3, 3)
    _, s2c = rank_sum(0, s2c, group)
    cov = torch.where((cnt_eff > 1.0)[:, None, None],
                      s2c / torch.clamp(cnt_eff - 1.0, min=1.0)[:, None, None], 0.0)
    evecs = eigh3_top2(cov)  # (N, 3, 2), the same on every pixel shard

    t0, t1 = macenko_ops._project_plane(od_c, evecs, torch.float32)
    phi = torch.atan2(t1, t0)  # (N, P_local)
    alpha = macenko_ops.ALPHA
    phi_pair = distributed_masked_percentile(phi, eff_mask, ((alpha, 100 - alpha),) * n, group)
    he = macenko_ops._he_from_phi_extremes(evecs, phi_pair[:, 0], phi_pair[:, 1])
    c0, c1 = macenko_ops._concentrations_2x2(he, od_c)
    all2 = None if valid is None else torch.cat([all_mask, all_mask])
    max_c = distributed_masked_percentile(torch.cat([c0, c1]), all2, (99,) * (2 * n), group)

    recon_dtype = torch.bfloat16 if precision == "fast" else torch.float32
    rgb = macenko_ops.rescale_and_reconstruct(
        c0, c1, max_c[:n], max_c[n:], target_max_conc, stain_matrix, recon_dtype
    ).reshape(n, c, h, w)
    return color.preserve_dtype(rgb, original_dtype, result_in_0_255_range=True)


# ------------------------------------------------------- mesh-level wrappers

FIT_SHARDED = {
    "reinhard": reinhard_fit_sharded,
    "histogram_matching": hm_fit_sharded,
    "macenko": macenko_fit_sharded,
}


class _Local(NamedTuple):
    """This rank's shard of a mesh call: the (N_local, C, H_local, W)
    tensor, how many of its leading batch and pixel rows are real, the
    global N and H, and the input's placements when it was a DTensor."""

    x: torch.Tensor
    n_real: int
    h_real: int
    n: int
    h: int
    placements: tuple | None

    @property
    def real(self) -> torch.Tensor:
        return self.x[: self.n_real, :, : self.h_real]


def _check_method(method: str) -> None:
    if method not in FIT_SHARDED:
        raise ValueError(f"Unknown method '{method}'. Choose from {sorted(FIT_SHARDED)}")


def _check_pixel_axis(mesh, pixel_axis: str | None, batch_axis: str) -> None:
    if pixel_axis is None:
        return
    check_axis(mesh, pixel_axis, "pixel_axis")
    if pixel_axis == batch_axis:
        raise ValueError(
            f"pixel_axis must differ from batch_axis (both '{batch_axis}'): a batch "
            "axis shards different images; a pixel axis shards each image's rows."
        )


def onto_mesh(images, mesh, batch_axis: str = "batch", pixel_axis: str | None = None):
    """``images`` as the mesh calls take it: a ``DTensor`` that lives on
    another mesh is brought onto ``mesh`` from its full tensor, with the
    call's placements (JAX's ``_put_unless_committed`` moves an array
    committed elsewhere onto the call's sharding); anything else is
    returned as it is. Every rank of both meshes calls it."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    if not isinstance(images, DTensor) or images.device_mesh == mesh:
        return images
    return distribute_tensor(images.full_tensor(), mesh, placements(mesh, batch_axis, pixel_axis))


def _local_shard(images, mesh, batch_axis: str, pixel_axis: str | None) -> _Local:
    """This rank's shard of ``images`` on ``mesh`` (module docstring: a
    plain tensor is padded and cut here, a DTensor gives its local shard)."""
    from torch.distributed.tensor import DTensor

    n_b = check_axis(mesh, batch_axis, "batch_axis")
    _check_pixel_axis(mesh, pixel_axis, batch_axis)
    n_p = 1 if pixel_axis is None else check_axis(mesh, pixel_axis, "pixel_axis")
    images = onto_mesh(images, mesh, batch_axis, pixel_axis)
    if isinstance(images, DTensor):
        want = placements(mesh, batch_axis, pixel_axis)
        if tuple(images.placements) != want:
            images = images.redistribute(mesh, want)
        n, _, h, _ = images.shape
        if n % n_b or h % n_p:
            raise ValueError(
                f"a DTensor input needs N divisible by the batch axis ({n} by {n_b}) and H by "
                f"the pixel axis ({h} by {n_p}): padding is a global operation; pass the "
                f"global batch as a plain tensor on every rank instead")
        local = images.to_local()
        return _Local(local, local.shape[0], local.shape[2], n, h, want)

    x = images if torch.is_tensor(images) else torch.as_tensor(np.asarray(images))
    if x.dim() != 4:
        raise ValueError(f"mesh calls take NCHW batches, got shape {tuple(x.shape)}")
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError(f"rank {dist.get_rank()} is not in the mesh")
    names = mesh.mesh_dim_names
    b = coord[names.index(batch_axis)]
    p = 0 if pixel_axis is None else coord[names.index(pixel_axis)]
    n, c, h, w = x.shape
    n_loc, h_loc = -(-n // n_b), -(-h // n_p)
    n0, h0 = b * n_loc, p * h_loc
    n_real, h_real = max(0, min(n_loc, n - n0)), max(0, min(h_loc, h - h0))
    part = x[n0 : n0 + n_real, :, h0 : h0 + h_real]
    dev = mesh_device(mesh)
    if (n_real, h_real) == (n_loc, h_loc):
        local = part.to(dev).contiguous()
    else:
        local = torch.zeros((n_loc, c, h_loc, w), dtype=x.dtype, device=dev)
        local[:n_real, :, :h_real] = part.to(dev)
    return _Local(local, n_real, h_real, n, h, None)


def _stat_axes(batch_axis: str, pixel_axis: str | None):
    return (batch_axis, pixel_axis) if pixel_axis else batch_axis


def fit_on_mesh(method: str, images, mesh, batch_axis: str = "batch",
                pixel_axis: str | None = None):
    """A distributed fit over ``mesh`` with N sharded on ``batch_axis``
    and, with ``pixel_axis``, each image's rows sharded over that axis; the
    statistics reduce over the axes the data is sharded on. Any N and H
    are accepted: padded rows are left out of every statistic. Returns the
    fitted parameters on every rank (a tuple for reinhard and macenko, a
    (C, 256) tensor for histogram_matching). Every rank of the mesh calls
    it (module docstring: a plain global batch on every rank, or a
    DTensor)."""
    _check_method(method)
    loc = _local_shard(images, mesh, batch_axis, pixel_axis)
    group = axis_group(mesh, _stat_axes(batch_axis, pixel_axis))
    return FIT_SHARDED[method](loc.real, group=group)


def _assemble(out: torch.Tensor, mesh, batch_axis: str, pixel_axis: str | None, n: int, h: int):
    """The global output on every rank: each rank's output shard gathered
    over the sharded axes, placed by its mesh coordinate, padding cut off."""
    group = axis_group(mesh, _stat_axes(batch_axis, pixel_axis))
    names = mesh.mesh_dim_names
    n_b = mesh.size(names.index(batch_axis))
    n_p = 1 if pixel_axis is None else mesh.size(names.index(pixel_axis))
    grid = [[None] * n_p for _ in range(n_b)]
    for part, rank in zip(_gather(out, group), dist.get_process_group_ranks(group)):
        coord = (mesh.mesh == rank).nonzero()[0].tolist()
        p = 0 if pixel_axis is None else coord[names.index(pixel_axis)]
        grid[coord[names.index(batch_axis)]][p] = part
    full = torch.cat([torch.cat(row, dim=2) for row in grid], dim=0)
    return full[:n, :, :h]


def transform_on_mesh(method: str, images, params, mesh, batch_axis: str = "batch",
                      pixel_axis: str | None = None, precision: str = "stable"):
    """Batch-parallel transform over ``mesh``: N sharded on ``batch_axis``
    and, with ``pixel_axis``, each image's rows on that axis. Reinhard and
    HM take batch-global statistics, reduced over the sharded axes; the
    batch-only Macenko transform needs no communication (each rank runs
    :func:`stainx_tpu_torch.ops.macenko.macenko_transform` on its shard, B1
    or B4 on the card), and with ``pixel_axis`` Macenko routes to
    :func:`macenko_transform_sharded` (per-image statistics over the pixel
    axis only). Any N and H are accepted: padding is left out of the
    statistics and cut off the output. ``precision`` reaches Macenko only.

    A plain input gives the global output on every rank; a DTensor input
    gives a DTensor of the same placements. Every rank of the mesh calls
    it."""
    _check_method(method)
    loc = _local_shard(images, mesh, batch_axis, pixel_axis)
    dev = loc.x.device
    if method == "reinhard":
        group = axis_group(mesh, _stat_axes(batch_axis, pixel_axis))
        mean, std = reinhard_fit_sharded(loc.real, group=group)
        out = _reinhard_apply(loc.x, mean, std, *params)
    elif method == "histogram_matching":
        group = axis_group(mesh, _stat_axes(batch_axis, pixel_axis))
        images_u8, scale_back = color.images_to_uint8(loc.x)
        out_dtype = torch.float32 if scale_back else torch.uint8
        n_px = loc.n * loc.h * loc.x.shape[3]
        lut = _hm_lut(images_u8[: loc.n_real, :, : loc.h_real], params, group, out_dtype,
                      num_pixels=n_px)
        out = _hm_apply(images_u8, lut, out_dtype, loc.x.dtype, False)
    else:
        he, max_c = (torch.as_tensor(p).to(device=dev, dtype=torch.float32) for p in params)
        if pixel_axis is None:
            out = macenko_ops.macenko_transform(loc.x, he, max_c, precision=precision)
        else:
            valid = None
            if loc.h_real < loc.x.shape[2]:
                rows = torch.arange(loc.x.shape[2], device=dev) < loc.h_real
                valid = rows[None, :, None].expand(loc.x.shape[0], -1, loc.x.shape[3])
            out = macenko_transform_sharded(loc.x, he, max_c, group=axis_group(mesh, pixel_axis),
                                            precision=precision, valid=valid)
    if loc.placements is not None:
        from torch.distributed.tensor import DTensor

        return DTensor.from_local(out, mesh, loc.placements)
    return _assemble(out, mesh, batch_axis, pixel_axis, loc.n, loc.h)


def image_from_mesh(images, index: int, mesh, batch_axis: str = "batch") -> torch.Tensor:
    """This rank's slab of image ``index`` of a DTensor batch sharded on
    ``batch_axis``: (1, C, H_local, W), broadcast over the batch axis from
    the rank that holds it (no other image moves)."""
    local = images.to_local()
    n_loc = local.shape[0]
    owner = index // n_loc
    group = mesh.get_group(batch_axis)
    if mesh.get_local_rank(batch_axis) == owner:
        slab = local[index % n_loc : index % n_loc + 1].contiguous()
    else:
        slab = torch.empty_like(local[:1])
    dist.broadcast(slab, src=dist.get_global_rank(group, owner), group=group)
    return slab
