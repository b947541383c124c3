"""Device meshes over torch.distributed for multi-GPU bundle adjustment.

The port of `gf_orb_slam2_tpu/parallel/mesh.py`. One process drives one
device; a mesh names the axes of the process group that is already up
(`init_world`): `DP_AXIS` for the map points and observations, `HOST_AXIS`
as the outer axis of a hosts × devices-per-host layout. A mesh always spans
the whole world, so a reduction over every axis of a mesh is a reduction
over the default group.

Placement replaces `jax.device_put` with a sharding: `shard_points` keeps
this rank's contiguous slice of a point-major array (ranks in mesh order, as
`PartitionSpec(axes)` lays the shards out), `replicate` a full copy.
"""
from __future__ import annotations

import datetime

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

DP_AXIS = "dp"      # map points / observations sharded over this axis
HOST_AXIS = "host"  # outer axis for multi-host layouts

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def init_world(device: str, rank: int, world_size: int, init_method: str,
               timeout: float = 120.0) -> None:
    """Bring up the default process group: NCCL for `cuda` (one device per
    rank, rank i on device i mod count), gloo for `cpu`. `timeout` (seconds)
    bounds the rendezvous and every collective."""
    if device not in BACKENDS:
        raise ValueError(f"device must be one of {sorted(BACKENDS)}, got {device!r}")
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_world('cuda', ...) needs a CUDA device; none is available")
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(BACKENDS[device], init_method=init_method, rank=rank,
                            world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout))


def _whole_world(n: int) -> None:
    if n != dist.get_world_size():
        raise ValueError(f"a mesh spans the whole world: {n} devices asked for, "
                         f"world size {dist.get_world_size()}")


def make_mesh(n_devices: int | None = None, axis: str = DP_AXIS,
              device: str = "cuda") -> DeviceMesh:
    """One-axis mesh over the world (`n_devices`, if given, must equal the
    world size: one process per device)."""
    n = dist.get_world_size() if n_devices is None else n_devices
    _whole_world(n)
    return init_device_mesh(device, (n,), mesh_dim_names=(axis,))


def make_mesh2d(n_hosts: int, n_chips: int, axes=(HOST_AXIS, DP_AXIS),
                device: str = "cuda") -> DeviceMesh:
    """Two-axis mesh (hosts × devices per host), ranks in row-major order.
    Collectives are laid on the axis they name: the camera-system scatter on
    HOST_AXIS, the dense point reductions on DP_AXIS."""
    _whole_world(n_hosts * n_chips)
    return init_device_mesh(device, (n_hosts, n_chips), mesh_dim_names=tuple(axes))


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """This rank's device on the mesh."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def axis_group(mesh: DeviceMesh, axes):
    """The process group spanning `axes` of the mesh: one axis, or all of
    them (the default group, since a mesh spans the world)."""
    axes = tuple(axes)
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    if sorted(axes) == sorted(mesh.mesh_dim_names):
        return dist.group.WORLD
    raise ValueError(f"axes {axes} of a mesh with axes {mesh.mesh_dim_names}: "
                     "a group spans one axis or all of them")


def shard_index(mesh: DeviceMesh) -> int:
    """This rank's position in the mesh, row-major over all axes."""
    return int((mesh.mesh.flatten() == dist.get_rank()).nonzero()[0, 0])


def shard_points(mesh: DeviceMesh, arr: torch.Tensor) -> torch.Tensor:
    """This rank's contiguous slice of a point-major array along dim 0, on
    this rank's device. The leading dim must divide by the mesh size."""
    n = mesh.size()
    if arr.shape[0] % n:
        raise ValueError(f"leading dim {arr.shape[0]} does not divide by the mesh size {n}")
    step = arr.shape[0] // n
    i = shard_index(mesh)
    return arr[i * step:(i + 1) * step].to(mesh_device(mesh)).contiguous()


def replicate(mesh: DeviceMesh, arr: torch.Tensor) -> torch.Tensor:
    """A full copy of `arr` on this rank's device."""
    return arr.to(mesh_device(mesh)).contiguous()
