"""Device meshes, batch placement and the process group of mesh axes.

Counterpart of ``stainx_tpu/parallel/mesh.py`` on ``torch.distributed``: a
:class:`~torch.distributed.device_mesh.DeviceMesh` where JAX has a
``jax.sharding.Mesh``, a ``DTensor`` where it has a sharded ``jax.Array``.
A mesh spans every rank of the default process group; under ``torchrun``
:func:`make_mesh` creates that group from the launcher's environment.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch
import torch.distributed as dist


def make_mesh(
    shape: tuple[int, ...] | None = None,
    axis_names: tuple[str, ...] = ("batch",),
    device_type: str | None = None,
):
    """A :class:`~torch.distributed.device_mesh.DeviceMesh` over every rank
    of the default process group, on ``"cuda"`` (the default; each rank on
    its own card, ``LOCAL_RANK`` or the rank modulo the cards) or on
    ``"cpu"`` when asked for.

    With ``shape=None`` all ranks go on the first axis. For tile throughput
    the natural layout is a 1D ``("batch",)`` mesh (transforms are
    image-independent); a 2D ``("batch", "pixel")`` mesh also shards each
    image's rows. When no process group exists yet, one is created from
    the environment ``torchrun`` sets (NCCL for ``"cuda"``, gloo for
    ``"cpu"``)."""
    from torch.distributed.device_mesh import init_device_mesh

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
    axis_names = tuple(axis_names)
    if shape is None:
        shape = (world,) + (1,) * (len(axis_names) - 1)
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {shape} and axis names {axis_names} differ in length")
    if math.prod(shape) != world:
        raise ValueError(f"mesh shape {shape} needs {math.prod(shape)} ranks, the world has {world}")
    if device_type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank() % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    return init_device_mesh(device_type, shape, mesh_dim_names=axis_names)


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


def axis_group(mesh, axes):
    """The process group that reduces over ``axes`` of ``mesh``: one axis
    name (or a 1-tuple) gives that axis's group; a tuple of every axis
    gives a group of all the mesh's ranks, created once per mesh (every
    rank must ask for it, in the same order, as for any new group)."""
    names = (axes,) if isinstance(axes, str) else tuple(axes)
    for name in names:
        check_axis(mesh, name, "axis")
    if len(names) == 1:
        return mesh.get_group(names[0])
    if sorted(names) != sorted(mesh.mesh_dim_names):
        raise ValueError(f"axes {names} must be one axis or every axis of the mesh "
                         f"{mesh.mesh_dim_names}")
    group = getattr(mesh, "_stainx_whole_group", None)
    if group is None:
        ranks = sorted(mesh.mesh.flatten().tolist())
        group = dist.group.WORLD if ranks == list(range(dist.get_world_size())) else (
            dist.new_group(ranks=ranks))
        mesh._stainx_whole_group = group
    return group


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
