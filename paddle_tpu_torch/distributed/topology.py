"""Mesh topology over torch.distributed.

Counterpart of `paddle_tpu/distributed/topology.py`: `AXIS_ORDER`,
`build_mesh` (:83-115) and `batch_partition_spec` (:361).  The
reference's mesh is a `jax.sharding.Mesh` over the devices one process
drives; here each rank is a process with one device, and `Mesh` wraps a
`torch.distributed.device_mesh.DeviceMesh` over the ranks of the
process group, with the reference's five named axes, outermost first.
Rank r sits at the mesh coordinate of r in row-major order over
`AXIS_ORDER`, as device r does in the reference's enumeration-order
mesh.

`Mesh.shape` maps each axis name to its size, and `.size` and
`.axis_names` read as the reference's do.  With no process group the
mesh is one device and holds no DeviceMesh (bench.py's
`build_mesh(devices=[dev])`): a trainer on it runs no collective.

Only the data axes are ported: `mp`, `pp` or `sep` above 1 raises
NotImplementedError (ROADMAP queue 1 item 8, with `Group` and
`HybridCommunicateGroup`).  A mesh larger than the devices raises the
reference's ValueError; under a process group the mesh spans every
rank.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist

from ..framework.device import resolve_device

__all__ = ["AXIS_ORDER", "Mesh", "build_mesh", "batch_partition_spec"]

# axis canonical order, outermost -> innermost
AXIS_ORDER = ("pp", "sep", "sharding", "dp", "mp")


class Mesh:
    axis_names = AXIS_ORDER

    def __init__(self, sizes, device, device_mesh=None):
        self.shape = {a: int(sizes[a]) for a in AXIS_ORDER}
        self.device = device            # this rank's device
        self.device_mesh = device_mesh  # None: one device, no group

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def group(self, axis):
        """The process group of this rank's line along `axis` (None
        without a process group)."""
        if self.device_mesh is None:
            return None
        return self.device_mesh.get_group(axis)

    def coordinate(self, axis) -> int:
        """This rank's index along `axis`."""
        if self.device_mesh is None:
            return 0
        return self.device_mesh.get_local_rank(axis)

    def __repr__(self):
        axes = ", ".join(f"{a}={n}" for a, n in self.shape.items())
        return f"Mesh({axes}, device={self.device})"


def build_mesh(dp=1, mp=1, pp=1, sep=1, sharding=1, devices=None) -> Mesh:
    """The hybrid mesh over the ranks of the process group.  `devices`
    lists the ranks' devices in rank order (default: one per rank, or
    with no process group the one CUDA device, raising without one)."""
    sizes = {"pp": pp, "sep": sep, "sharding": sharding, "dp": dp,
             "mp": mp}
    wide = {a: sizes[a] for a in ("mp", "pp", "sep") if sizes[a] > 1}
    if wide:
        raise NotImplementedError(
            f"mesh axes {wide}: tensor, pipeline and sequence parallelism "
            f"are not ported yet (ROADMAP queue 1 item 8); the port's "
            f"mesh has the data axes dp and sharding")
    need = math.prod(sizes.values())
    grouped = dist.is_initialized()
    rank = dist.get_rank() if grouped else 0
    if devices is None:
        if not grouped:
            devices = [resolve_device(None)]
        else:
            dev = torch.device("cuda", torch.cuda.current_device()) \
                if dist.get_backend() == "nccl" else torch.device("cpu")
            devices = [dev] * dist.get_world_size()
    devices = [resolve_device(d) for d in devices]
    if need > len(devices):
        raise ValueError(
            f"mesh requires {need} devices, have {len(devices)}")
    if not grouped:
        return Mesh(sizes, devices[0])
    world = dist.get_world_size()
    if need != world:
        raise ValueError(
            f"the mesh ({need} devices) must span the process group's "
            f"{world} ranks")
    from torch.distributed.device_mesh import DeviceMesh
    shape = [sizes[a] for a in AXIS_ORDER]
    dm = DeviceMesh(devices[rank].type, torch.arange(need).reshape(shape),
                    mesh_dim_names=AXIS_ORDER)
    return Mesh(sizes, devices[rank], dm)


def batch_partition_spec(mesh: Mesh, shape, batch_axes=("dp", "sharding")):
    """PartitionSpec entries for a host batch: dim 0 split over the
    present data-parallel axes (a tuple in mesh order) when the size
    divides evenly, else replicated (None)."""
    axes = tuple(a for a in mesh.axis_names
                 if a in batch_axes and mesh.shape[a] > 1)
    spec = [None] * len(shape)
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    if axes and shape and shape[0] % n == 0:
        spec[0] = axes
    return spec
