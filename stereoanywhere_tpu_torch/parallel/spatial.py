"""Exact row-sharded inference: the JAX package's `parallel/spatial.py`.

The third way to run a large image, beside batch parallelism and the row
tiles of `tiles.py`.  Tiles are approximate at their seams by construction:
each tile is an independent forward and the overlaps are sin^2-blended.
Here the image rows of every activation, the (B, H/4, W2, W3) volumes
included, are split over the ranks of the mesh's `tile` axis and the model
runs once over the whole image: no seams, no blend, the one-process
forward's numbers up to the order of float reductions, and about 1/N of
the activation memory on each rank.

JAX gets this from its partitioner: one program with a `NamedSharding`
over H, the halos and reductions inserted by XLA.  Here each rank runs the
same layers on its own rows and the row-aware layers exchange halos and
reduce over the group themselves (`halo.py`); the rows are cut at the
model's coarsest row stride (`halo.row_block`), so shards may be uneven.
The forward runs eagerly (no CUDA graph: graphs of collectives over NCCL
are a later item).  The stereo model's test-mode forward, with either
refinement loop (`fused_level0="on"` runs its K7, K8 and K9 launches on
bands of rows: `models/update.py` `on_band`) and any aggregation variant;
train mode refuses a row group.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from stereoanywhere_tpu_torch.parallel.halo import RowGroup, RowPlan, plan_rows, row_block, row_group
from stereoanywhere_tpu_torch.parallel.mesh import Mesh


@dataclass
class RowShard:
    """This rank's rows [start, stop) of a (B, H, W, 1) disparity, and the
    plan that cut them."""

    disparity: torch.Tensor
    plan: RowPlan
    index: int

    @property
    def start(self) -> int:
        return self.plan.starts[self.index]

    @property
    def stop(self) -> int:
        return self.plan.stops[self.index]


class RowShardedInference:
    """Stereo inference with the image rows sharded over the mesh's `axis`.

    model: a `StereoAnywhere` (each rank holds the same weights); mesh:
    `mesh.make_mesh(...)`.  `infer` takes the whole padded inputs on every
    rank and returns this rank's rows of the disparity (`RowShard`);
    `gather_rows` rebuilds the whole map on one rank or on all of them.
    `group` is the `halo.RowGroup` of the last `infer`: its `traffic`
    counts the bytes this rank handed to the collectives."""

    def __init__(self, model, mesh: Mesh, axis: str = "tile", iters: int = 32):
        self.model = model
        self.iters = iters
        self.index = mesh.coords[axis]
        self.size = mesh.shape[axis]
        self.process_group = mesh.groups[axis]
        self.block = row_block(model.cfg)
        self.group: RowGroup | None = None

    def plan(self, height: int) -> RowPlan:
        """The rows of each rank for a padded height."""
        return plan_rows(height, self.size, self.block)

    def _device_tensor(self, x) -> torch.Tensor:
        if not torch.is_tensor(x):
            x = torch.from_numpy(np.asarray(x, dtype=np.float32))
        return x.to(next(self.model.parameters()).device, torch.float32)

    def infer(self, im2, im3, mde2, mde3) -> RowShard:
        """im* (B,H,W,3), mde* (B,H,W,1), H a multiple of the row block,
        whole on every rank.  Returns this rank's rows of the positive
        disparity, (B, stop - start, W, 1)."""
        plan = self.plan(im2.shape[1])
        a, b = plan.starts[self.index], plan.stops[self.index]
        rows = [self._device_tensor(x[:, a:b]) for x in (im2, im3, mde2, mde3)]
        self.group = RowGroup(plan, self.index, self.process_group)
        with row_group(self.group):
            disparity = self.model(*rows, iters=self.iters, test_mode=True)["disparity"]
        return RowShard(disparity, plan, self.index)

    def gather_rows(self, shard: RowShard, dst: int | None = 0) -> torch.Tensor | None:
        """The whole (B, H, W, 1) disparity from every rank's shard: on the
        axis's rank `dst` (None on the others), or on every rank with
        dst=None."""
        if shard.plan.n == 1:
            return shard.disparity
        group = self.group  # its traffic counts the gather with the forward
        if group is None or group.plan != shard.plan:
            group = RowGroup(shard.plan, shard.index, self.process_group)
        return group.gather_rows(shard.disparity, 1, dst)
