"""Device meshes, batch placement and the process group of mesh axes.

Counterpart of ``stainx_tpu/parallel/mesh.py`` on ``torch.distributed``: a
:class:`~torch.distributed.device_mesh.DeviceMesh` where JAX has a
``jax.sharding.Mesh``, a ``DTensor`` where it has a sharded ``jax.Array``.
A mesh spans the ranks of the default process group it is given (all of
them by default); under ``torchrun`` :func:`make_mesh` creates that group
from the launcher's environment.
"""

from __future__ import annotations

import itertools
import math
import os

import numpy as np
import torch
import torch.distributed as dist


def make_mesh(
    shape: tuple[int, ...] | None = None,
    axis_names: tuple[str, ...] = ("batch",),
    device_type: str | None = None,
    devices: list[int] | None = None,
):
    """A :class:`~torch.distributed.device_mesh.DeviceMesh` over ``devices``
    (ranks of the default process group; default: all of them), on
    ``"cuda"`` (the default; each rank on its own card, ``LOCAL_RANK`` or
    the rank modulo the cards) or on ``"cpu"`` when asked for.

    With ``shape=None`` all of ``devices`` go on the first axis; with a
    shape, the mesh takes the first prod(shape) of them, as JAX's
    ``make_mesh`` takes the first prod(shape) devices. Every rank of the
    world calls it (a rank outside the mesh gets a mesh it is not in, and
    a ``ValueError`` from the mesh calls). For tile throughput the natural
    layout is a 1D ``("batch",)`` mesh (transforms are image-independent);
    a 2D ``("batch", "pixel")`` mesh also shards each image's rows. When no
    process group exists yet, one is created from the environment
    ``torchrun`` sets (NCCL for ``"cuda"``, gloo for ``"cpu"``). The
    process groups of every set of two or more axes are created here, by
    every rank in the same order (:func:`axis_group`)."""
    from torch.distributed.device_mesh import DeviceMesh

    device_type = "cuda" if device_type is None else device_type
    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported mesh device type {device_type!r}: use 'cuda' or 'cpu'")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "a 'cuda' mesh needs CUDA and none is available; pass device_type='cpu' for a "
            "mesh of CPU ranks (gloo)"
        )
    if not dist.is_initialized():
        dist.init_process_group("nccl" if device_type == "cuda" else "gloo")
    world = dist.get_world_size()
    ranks = list(range(world)) if devices is None else [int(r) for r in devices]
    if len(set(ranks)) != len(ranks) or not all(0 <= r < world for r in ranks):
        raise ValueError(f"devices {ranks} must be distinct ranks of the world of {world}")
    axis_names = tuple(axis_names)
    if shape is None:
        shape = (len(ranks),) + (1,) * (len(axis_names) - 1)
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {shape} and axis names {axis_names} differ in length")
    n = math.prod(shape)
    if n > len(ranks):
        raise ValueError(f"mesh shape {shape} needs {n} ranks, have {len(ranks)}")
    if device_type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank() % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    mesh = DeviceMesh(device_type, torch.tensor(ranks[:n]).reshape(shape),
                      mesh_dim_names=axis_names)
    _axis_groups(mesh)
    return mesh


def mesh_device(mesh) -> torch.device:
    """This rank's device on ``mesh``: its current card, or the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def check_axis(mesh, name: str, what: str) -> int:
    """The size of mesh axis ``name``; raises ``ValueError`` when the mesh
    has no such axis."""
    names = mesh.mesh_dim_names or ()
    if name not in names:
        raise ValueError(f"{what} '{name}' is not an axis of the mesh (mesh axes: {names}).")
    return mesh.size(names.index(name))


def _axis_groups(mesh) -> dict:
    """The process groups of every set of two or more axes of ``mesh``,
    keyed by the set of axis indices: for each set, this rank's group of
    the ranks that share its coordinates on every other axis. Each such
    group is created on every rank in the same order, as ``new_group``
    asks, once per mesh (:func:`make_mesh` does it when it builds the mesh;
    for a mesh built elsewhere, the first :func:`axis_group` call of two or
    more axes, which every rank of the world must then make). A group of
    every rank of the world is the default group."""
    groups = getattr(mesh, "_stainx_groups", None)
    if groups is not None:
        return groups
    groups = {}
    world, me = dist.get_world_size(), dist.get_rank()
    ndim = mesh.mesh.dim()
    for k in range(2, ndim + 1):
        for dims in itertools.combinations(range(ndim), k):
            others = [d for d in range(ndim) if d not in dims]
            rows = mesh.mesh.permute(*others, *dims).reshape(-1, math.prod(
                mesh.mesh.shape[d] for d in dims))
            for row in rows.tolist():
                ranks = sorted(row)
                group = dist.group.WORLD if ranks == list(range(world)) else (
                    dist.new_group(ranks=ranks))
                if me in ranks:
                    groups[frozenset(dims)] = group
    mesh._stainx_groups = groups
    return groups


def axis_group(mesh, axes):
    """The process group that reduces over ``axes`` of ``mesh``: one axis
    name (or a 1-tuple) gives that axis's group; two or more give the group
    of the ranks that share this rank's coordinates on every other axis of
    the mesh (all the mesh's ranks when ``axes`` are every axis), as JAX
    reduces over a tuple of mesh axes. Reduce only over the axes the data
    is sharded on: over a replicated axis the counts would scale."""
    names = (axes,) if isinstance(axes, str) else tuple(axes)
    for name in names:
        check_axis(mesh, name, "axis")
    if len(set(names)) != len(names):
        raise ValueError(f"axes {names} name an axis twice")
    if len(names) == 1:
        return mesh.get_group(names[0])
    groups = _axis_groups(mesh)
    dims = frozenset(mesh.mesh_dim_names.index(name) for name in names)
    if dims not in groups:
        raise ValueError(f"rank {dist.get_rank()} is not in the mesh")
    return groups[dims]


def placements(mesh, batch_axis: str = "batch", pixel_axis: str | None = None):
    """``Shard(0)`` on ``batch_axis``, ``Shard(2)`` on ``pixel_axis``,
    ``Replicate()`` on every other axis of the mesh."""
    from torch.distributed.tensor import Replicate, Shard

    return tuple(Shard(0) if name == batch_axis else Shard(2) if name == pixel_axis
                 else Replicate() for name in mesh.mesh_dim_names)


def shard_batch(images, mesh, batch_axis: str = "batch"):
    """Place an NCHW batch on ``mesh`` as a ``DTensor`` with N sharded over
    ``batch_axis`` and replicated on every other axis (every rank passes
    the same global batch; rank 0's is scattered)."""
    from torch.distributed.tensor import distribute_tensor

    check_axis(mesh, batch_axis, "batch_axis")
    x = images if torch.is_tensor(images) else torch.as_tensor(np.asarray(images))
    return distribute_tensor(x, mesh, placements(mesh, batch_axis))
