"""Meshes: the production layouts and the host mesh of a ``torch.distributed`` world.

Counterpart of ``repro/launch/mesh.py``.

Single pod: 16x16 = 256 chips, axes ("data", "model").
Multi-pod:  2x16x16 = 512 chips, axes ("pod", "data", "model") — the "pod"
axis crosses hosts; batch shards over ("pod", "data").

``make_production_mesh`` describes those layouts as a ``MeshShape`` (axis
names and sizes), which the partition rules read like a mesh; building
one takes a world of 256 (512) ranks, and ``build`` does that when the
world is that large. ``make_host_mesh`` builds the ("data", "model") mesh
of the world ``torch.distributed`` was started with.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

AXES = ("data", "model")


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's axis names and sizes, without devices."""
    axes: Tuple[str, ...]
    sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axes, self.sizes))

    @property
    def size(self) -> int:
        n = 1
        for s in self.sizes:
            n *= s
        return n


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return MeshShape(axes, shape)


def data_axes(multi_pod: bool) -> Tuple[str, ...]:
    return ("pod", "data") if multi_pod else ("data",)


def build(shape: MeshShape, device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` over the ranks of the started world, in
    rank order (the last axis fastest). Raises unless the world has exactly
    ``shape.size`` ranks. Every rank may share one card: the mesh sets no
    device, the caller picks it."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    world = dist.get_world_size()
    if world != shape.size:
        raise ValueError(f"a {'x'.join(map(str, shape.sizes))} mesh needs {shape.size} ranks; "
                         f"the world has {world}")
    return DeviceMesh(device_type, torch.arange(world).reshape(shape.sizes),
                      mesh_dim_names=shape.axes)


def make_host_mesh(model: int = 1, device_type: str = "cuda"):
    """The ("data", "model") mesh over every rank of the started world, the
    model axis capped at the world size."""
    import torch.distributed as dist

    n = dist.get_world_size()
    model = min(model, n)
    return build(MeshShape(AXES, (n // model, model)), device_type)
