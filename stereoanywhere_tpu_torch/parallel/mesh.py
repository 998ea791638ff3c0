"""The ranks' mesh: the JAX package's `make_mesh(data, tile)` on
`torch.distributed`.

JAX lays its devices out as a `Mesh` with two axes, `data` (batch
parallelism) and `tile` (image rows sharded for high-resolution inference),
and its collectives follow from the sharding.  Here the mesh is the
process group's ranks laid out data-major, as JAX reshapes its devices
(`reshape(data, tile)`): rank = d * tile + t.  `make_mesh` returns this
rank's coordinates and one process group per axis, holding the ranks of
this rank's row (`tile`) or column (`data`) of the grid, so that a
collective over an axis reaches only those.

JAX's `data_sharding` and `replicated` are sharding annotations for its
partitioner; they have no counterpart here.  Every rank holds its own
slice of a batch (`multihost`) or of the image rows (`halo`, `spatial`)
and calls the collectives itself.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

AXES = ("data", "tile")


def check_mesh(data: int, tile: int, device: str | torch.device) -> None:
    """A data x tile mesh on the card needs data * tile visible cards, one
    a rank (NCCL refuses two ranks on one device)."""
    n = data * tile
    if data < 1 or tile < 1:
        raise ValueError(f"mesh {data}x{tile}: both axes need at least one rank")
    if torch.device(device).type == "cuda" and n > torch.cuda.device_count():
        raise ValueError(f"mesh {data}x{tile} needs {n} devices, have {torch.cuda.device_count()}")


def check_data_axis(n: int, device: str | torch.device) -> None:
    """The data axis alone: n ranks on the card need n visible cards."""
    check_mesh(n, 1, device)


@dataclass(frozen=True)
class Mesh:
    """This rank's place in a data x tile grid of ranks.

    shape, coords: {axis: size}, {axis: this rank's index along it};
    ranks: {axis: the global ranks of this rank's group along the axis, in
    order}; groups: {axis: its process group, None for an axis of one rank
    (whose collectives are the identity)}."""

    shape: dict
    coords: dict
    ranks: dict
    groups: dict

    @property
    def size(self) -> int:
        return int(np.prod(list(self.shape.values())))


def make_mesh(data: int = 1, tile: int = 1) -> Mesh:
    """The mesh of the process group's ranks (data-major).  Every rank of
    the group calls it, in the same order as its other group creations:
    `torch.distributed.new_group` is collective.  Without a process group
    only a 1x1 mesh exists."""
    initialized = dist.is_available() and dist.is_initialized()
    rank, world = (dist.get_rank(), dist.get_world_size()) if initialized else (0, 1)
    n = data * tile
    if data < 1 or tile < 1 or n != world:
        raise ValueError(f"mesh {data}x{tile} needs {n} ranks, the process group has {world}")
    grid = np.arange(n).reshape(data, tile)
    d, t = divmod(rank, tile)
    lines = {"data": [grid[:, j].tolist() for j in range(tile)], "tile": [grid[i].tolist() for i in range(data)]}
    mine = {"data": grid[:, t].tolist(), "tile": grid[d].tolist()}
    groups = {}
    for axis in AXES:
        groups[axis] = None
        if len(mine[axis]) > 1:
            for members in lines[axis]:  # every rank makes every group, in one order
                g = dist.new_group(members)
                if members == mine[axis]:
                    groups[axis] = g
    for axis in AXES:
        # a first collective with every member: NCCL wants all of a group's
        # ranks in its first batched point-to-point call, which a band fetch
        # that some ranks sit out would not give it
        if groups[axis] is not None:
            dist.barrier(group=groups[axis])
    return Mesh(shape={"data": data, "tile": tile}, coords={"data": d, "tile": t},
                ranks={axis: tuple(mine[axis]) for axis in AXES}, groups=groups)
