"""Distributed execution over a ``torch.distributed`` device mesh.

Counterpart of ``stainx_tpu.parallel``, ported whole: :func:`make_mesh` and
:func:`shard_batch` (a ``DeviceMesh`` and a ``DTensor`` where JAX has a
``Mesh`` and a sharded array), the exact distributed percentile
:func:`distributed_masked_percentile`, the six ``*_sharded`` fits and
transforms, and the mesh wrappers :func:`fit_on_mesh` and
:func:`transform_on_mesh`:

- batch-parallel transforms: stain normalization is image-independent, so
  the batch-only Macenko transform needs no communication;
- pixel-sharded transforms (``pixel_axis=``) for images larger than one
  card: each rank holds a slab of rows, per-image statistics reduce with
  O(N·256)-sized collectives;
- exact batch-mode fits: LAB moments (Reinhard) and 256-bin histograms (HM)
  add across ranks; so do Macenko's OD moments, and its percentiles use a
  key-space descent with integer byte histograms.

Importing this package creates no process group: groups exist once the
caller (or :func:`make_mesh` under ``torchrun``) initializes
``torch.distributed``.
"""

from stainx_tpu_torch.parallel.distributed import (
    fit_on_mesh,
    hm_fit_sharded,
    hm_transform_sharded,
    macenko_fit_sharded,
    macenko_transform_sharded,
    reinhard_fit_sharded,
    reinhard_transform_sharded,
    transform_on_mesh,
)
from stainx_tpu_torch.parallel.mesh import make_mesh, shard_batch
from stainx_tpu_torch.parallel.percentile import distributed_masked_percentile

__all__ = [
    "make_mesh",
    "shard_batch",
    "distributed_masked_percentile",
    "reinhard_fit_sharded",
    "reinhard_transform_sharded",
    "hm_fit_sharded",
    "hm_transform_sharded",
    "macenko_fit_sharded",
    "macenko_transform_sharded",
    "fit_on_mesh",
    "transform_on_mesh",
]
