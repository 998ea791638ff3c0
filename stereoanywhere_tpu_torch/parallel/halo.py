"""Row-sharded activations: the halo exchange, and what the model needs
around it to run on a rank's own image rows.

The JAX package gets its halos and global reductions from XLA's SPMD
partitioner: it puts a `NamedSharding` over H on the inputs and the
partitioner inserts the collectives (`stereoanywhere_tpu/parallel/
spatial.py`).  PyTorch has no such partitioner for conv3d, align-corners
resizes or quantiles, so the port does it by hand: every rank runs the same
layers on its own rows and calls the collectives itself.

- `halo_exchange` / `drop_halo`: the JAX package's primitive (its
  `halo.py`): `halo` rows from each ring neighbour, zeros at the edge ranks.
- `plan_rows` / `RowPlan`: the stereo input's padded height cut into
  blocks of the model's coarsest row stride (`row_block`), the blocks
  dealt to the ranks as evenly as possible, so shards may be uneven
  (Booster's 3008 rows are 94 blocks of 32: 24/24/23/23 on 4 ranks).  A
  rank's rows at a scale s are its full-resolution range divided by s.
- `RowGroup` and `row_group`: the group of ranks that shard the rows of
  the forward running inside the block.  `RowGroup.fetch` gives a rank
  any band of global rows of a sharded tensor (its own, its neighbours'
  through `torch.distributed.batch_isend_irecv`, and zero or edge rows
  past a global edge); `gather_rows`, `all_reduce` the rest.
- `conv_rows` / `row_conv`: a convolution on sharded rows: the rows its
  kernel and stride need from the interior neighbours, then the
  convolution with no padding along H.  At a global edge the fetched rows
  are zeros, the convolution's own padding; no rank extends its shard past
  a global edge, which would be wrong before a stack of convolutions
  (bias and ReLU make pad rows nonzero).  A band keeps its tensor's
  memory format (channels-last in the stereo stage on the card).

The row-aware ops (`models/layers.py` instance norm, `ops/interp.py`
align-corners and nearest resizes and `pool2x`, `ops/geometry.py`
normals, warps and min-max, `ops/lsq.py`, `ops/upsample.py`) and the
helpers here are the identity, running the same ops bit for bit, when no
group of two ranks or more is active.

Over gloo, CUDA tensors are staged through host memory (gloo's
point-to-point and gathers take CPU tensors); over NCCL they stay on the
card.  `RowGroup.traffic` counts the bytes this rank hands to each kind of
collective.
"""
from __future__ import annotations

import contextvars
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Iterator, Sequence

import torch
import torch.distributed as dist
import torch.nn.functional as F

from stereoanywhere_tpu_torch.device import channels_last_format

_ACTIVE: contextvars.ContextVar = contextvars.ContextVar("row_group", default=None)


# ---------------------------------------------------------------------------
# point-to-point


def send_recv(group, sends, recvs, stage: bool) -> list[torch.Tensor]:
    """Point-to-point over `group`: post every send [(peer global rank,
    tensor)] and receive [(peer global rank, template tensor)] at once and
    wait for them; the received tensors, in recvs' order, on the
    templates' device."""
    ops, bufs = [], []
    for peer, t in sends:
        t = t.contiguous()
        ops.append(dist.P2POp(dist.isend, t.cpu() if stage else t, peer, group))
    for peer, like in recvs:
        buf = torch.empty(like.shape, dtype=like.dtype, device="cpu" if stage else like.device)
        bufs.append((buf, like.device))
        ops.append(dist.P2POp(dist.irecv, buf, peer, group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return [buf.to(dev) for buf, dev in bufs]


def staged(group, t: torch.Tensor) -> bool:
    """Whether t goes through host memory for a collective of `group`
    (gloo's point-to-point and gathers take CPU tensors)."""
    return t.device.type == "cuda" and dist.get_backend(group) == "gloo"


def group_ranks(group) -> list[int]:
    """The global ranks of a process group (None: all ranks), in order."""
    return dist.get_process_group_ranks(group if group is not None else dist.group.WORLD)


def halo_exchange(x: torch.Tensor, halo: int, group=None, spatial_axis: int = 1) -> torch.Tensor:
    """Pad a sharded tensor with `halo` rows from its ring neighbours in
    `group` (default: all ranks; the shards in rank order).  x: the local
    shard, e.g. (B, H_local, W, C) with spatial_axis=1.  Edge shards get zero
    rows, as a convolution's zero padding at an image border.  Returns
    (B, H_local + 2 * halo, W, C)."""
    n = x.shape[spatial_axis]
    zeros = torch.zeros_like(x.narrow(spatial_axis, 0, halo))
    if not (dist.is_available() and dist.is_initialized()):
        return torch.cat([zeros, x, zeros], dim=spatial_axis)
    ranks = group_ranks(group)
    i = ranks.index(dist.get_rank())
    sends, recvs = [], []
    if i > 0:  # my first rows -> the previous shard's bottom halo; its last rows -> my top halo
        sends.append((ranks[i - 1], x.narrow(spatial_axis, 0, halo)))
        recvs.append((ranks[i - 1], zeros))
    if i < len(ranks) - 1:
        sends.append((ranks[i + 1], x.narrow(spatial_axis, n - halo, halo)))
        recvs.append((ranks[i + 1], zeros))
    got = send_recv(group, sends, recvs, staged(group, x))
    top = got.pop(0) if i > 0 else zeros
    bottom = got.pop(0) if i < len(ranks) - 1 else zeros
    return torch.cat([top, x, bottom], dim=spatial_axis)


def drop_halo(x: torch.Tensor, halo: int, spatial_axis: int = 1) -> torch.Tensor:
    return x.narrow(spatial_axis, halo, x.shape[spatial_axis] - 2 * halo)


# ---------------------------------------------------------------------------
# the row plan


@dataclass(frozen=True)
class RowPlan:
    """Rows [starts[i], stops[i]) of a padded height go to rank i."""

    height: int
    block: int
    starts: tuple[int, ...]
    stops: tuple[int, ...]

    @property
    def n(self) -> int:
        return len(self.starts)

    def ranges(self, scale: int = 1) -> list[tuple[int, int]]:
        """Each rank's global rows at 1/scale of the full resolution."""
        return [(a // scale, b // scale) for a, b in zip(self.starts, self.stops)]


def plan_rows(height: int, n: int, block: int) -> RowPlan:
    """Cut `height` rows into blocks of `block` and deal them to n ranks,
    the first ranks taking one more where they do not divide evenly."""
    if height % block:
        raise ValueError(f"row sharding: height {height} is no multiple of the model's row block {block}")
    blocks = height // block
    if not 1 <= n <= blocks:
        raise ValueError(f"row sharding: {n} ranks for {blocks} blocks of {block} rows (height {height})")
    sizes = [(blocks // n + (i < blocks % n)) * block for i in range(n)]
    starts = tuple(sum(sizes[:i]) for i in range(n))
    return RowPlan(height, block, starts, tuple(a + s for a, s in zip(starts, sizes)))


def row_block(cfg) -> int:
    """The model's coarsest row stride in full-resolution rows: the
    hourglass reaches 1/8 of the volume's scale, 2^(n_downsample +
    vol_downsample), and the context encoder and the depth pyramids 1/32."""
    return 2 ** (max(cfg.n_downsample, 2) + 3 + cfg.vol_downsample)


# ---------------------------------------------------------------------------
# the group of a row-sharded forward


@dataclass
class RowGroup:
    """The ranks that shard the rows of one forward.  index: this rank's
    position in the plan; group: their process group (its ranks in plan
    order).  traffic: bytes this rank handed to the collectives, by kind
    ("p2p": rows sent to other ranks; "gather": its rows in a gather;
    "reduce": all-reduced tensors)."""

    plan: RowPlan
    index: int
    group: object = None
    traffic: dict = field(default_factory=lambda: {"p2p": 0, "gather": 0, "reduce": 0})

    def __post_init__(self):
        self.ranks = group_ranks(self.group) if dist.is_available() and dist.is_initialized() else [0]
        if len(self.ranks) != self.plan.n:
            raise ValueError(f"row plan of {self.plan.n} ranks for a group of {len(self.ranks)}")

    def span(self, n: int) -> tuple[int, list[tuple[int, int]]]:
        """(global rows, every rank's global row range) at the scale where
        this rank holds n rows."""
        a, b = self.plan.starts[self.index], self.plan.stops[self.index]
        scale = (b - a) // n if n else 0
        if not n or scale * n != b - a or self.plan.block % scale:
            raise ValueError(f"row sharding: {n} local rows of a shard of {b - a} are at no scale of the plan "
                             f"(block {self.plan.block})")
        return self.plan.height // scale, self.plan.ranges(scale)

    def fetch(self, x: torch.Tensor, axis: int, needs: Sequence[tuple[int, int]], pad: str = "zeros") -> torch.Tensor:
        """Global rows [lo, hi) = needs[self.index] of x, sharded along
        `axis`, where every rank asks for its needs[i] (all ranks call this
        with the same needs).  Rows outside the image are zeros
        (`pad="zeros"`) or the edge row (`"edge"`)."""
        axis %= x.ndim
        height, ranges = self.span(x.shape[axis])
        me, (a, b) = self.index, ranges[self.index]
        lo, hi = needs[me]
        sends, recvs, parts = [], [], []
        for q, ((qa, qb), (qlo, qhi)) in enumerate(zip(ranges, needs)):
            if q == me:
                continue
            s0, s1 = max(a, qlo), min(b, qhi)
            if s0 < s1:
                sends.append((self.ranks[q], x.narrow(axis, s0 - a, s1 - s0)))
            r0, r1 = max(qa, lo), min(qb, hi)
            if r0 < r1:
                shape = list(x.shape)
                shape[axis] = r1 - r0
                recvs.append((self.ranks[q], x.new_empty(shape)))
        self.traffic["p2p"] += sum(t.numel() * t.element_size() for _, t in sends)
        # the rows travel contiguous; the received ones and the pads take x's
        # memory format, so that the band keeps it (a channels-last x gives a
        # channels-last band)
        fmt = channels_last_format(x)
        like = (lambda t: t) if fmt is None else (lambda t: t.contiguous(memory_format=fmt))  # noqa: E731
        got = iter(send_recv(self.group, sends, recvs, staged(self.group, x)))
        for q, (qa, qb) in enumerate(ranges):
            r0, r1 = max(qa, lo, 0), min(qb, hi, height)
            if r0 < r1:
                parts.append(x.narrow(axis, r0 - a, r1 - r0) if q == me else like(next(got)))
        body = torch.cat(parts, dim=axis) if len(parts) > 1 else parts[0]
        before, after = max(0, -lo), max(0, hi - height)
        if not (before or after):
            return body
        shape = lambda k: [k if d == axis else s for d, s in enumerate(body.shape)]  # noqa: E731
        if pad == "edge":
            top = body.narrow(axis, 0, 1).expand(shape(before))
            bottom = body.narrow(axis, body.shape[axis] - 1, 1).expand(shape(after))
        elif pad == "zeros":
            top, bottom = body.new_zeros(shape(before)), body.new_zeros(shape(after))
        else:
            raise ValueError(f"unknown pad {pad!r}")
        return torch.cat([like(top), body, like(bottom)], dim=axis)

    def halo(self, x: torch.Tensor, axis: int, top: int, bottom: int, pad: str = "zeros") -> torch.Tensor:
        """x with `top` rows above and `bottom` rows below its own, from
        the neighbours (`fetch` with every rank's range widened alike)."""
        _, ranges = self.span(x.shape[axis])
        return self.fetch(x, axis, [(a - top, b + bottom) for a, b in ranges], pad)

    def gather_rows(self, x: torch.Tensor, axis: int, dst: int | None = None) -> torch.Tensor | None:
        """The whole tensor from every rank's rows along `axis`: on every
        rank (dst None) or on the plan's rank dst only (None elsewhere).
        Uneven shards are padded to the largest for the collective."""
        axis %= x.ndim
        _, ranges = self.span(x.shape[axis])
        sizes = [b - a for a, b in ranges]
        stage = staged(self.group, x)
        pad = [0] * (2 * x.ndim)
        pad[2 * (x.ndim - 1 - axis) + 1] = max(sizes) - x.shape[axis]
        mine = F.pad(x, pad).contiguous()
        mine = mine.cpu() if stage else mine
        self.traffic["gather"] += x.numel() * x.element_size()
        bufs = [torch.empty_like(mine) for _ in sizes]
        if dst is None:
            dist.all_gather(bufs, mine, group=self.group)
        else:
            dist.gather(mine, bufs if self.index == dst else None, dst=self.ranks[dst], group=self.group)
            if self.index != dst:
                return None
        return torch.cat([t.narrow(axis, 0, s) for t, s in zip(bufs, sizes)], dim=axis).to(x.device)

    def all_reduce(self, t: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
        """The reduction of t over the group's ranks (a new tensor)."""
        stage = staged(self.group, t)
        out = t.detach().cpu() if stage else t.detach().clone()
        self.traffic["reduce"] += t.numel() * t.element_size()
        dist.all_reduce(out, op=op, group=self.group)
        return out.to(t.device)


def active() -> RowGroup | None:
    """The row group of the forward running on this thread, if any."""
    return _ACTIVE.get()


@contextmanager
def row_group(group: RowGroup | None) -> Iterator[RowGroup | None]:
    """Run the block's forward on this rank's rows of `group`'s plan.  A
    group of one rank (or None) leaves every op as it is."""
    token = _ACTIVE.set(group if group is not None and group.plan.n > 1 else None)
    try:
        yield group
    finally:
        _ACTIVE.reset(token)


# ---------------------------------------------------------------------------
# convolutions


def conv_rows(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None, stride=1, padding=0,
              row_axis: int = -2) -> torch.Tensor:
    """`F.conv2d` / `F.conv3d` (by weight's rank) with zero padding, dilation
    1 and one group; with a row group active, x's `row_axis` holds this
    rank's rows and the result does too."""
    conv = F.conv2d if weight.ndim == 4 else F.conv3d
    g = active()
    if g is None:
        return conv(x, weight, bias, stride, padding)
    nd = weight.ndim - 2
    k = row_axis % x.ndim - 2  # the row axis among the spatial ones
    stride = (stride,) * nd if isinstance(stride, int) else tuple(stride)
    padding = [padding] * nd if isinstance(padding, int) else list(padding)
    kh, s, p = weight.shape[2 + k], stride[k], padding[k]
    # output rows [a/s, b/s) read input rows [a - p, b - s - p + kh)
    band = g.halo(x, row_axis, p, max(0, kh - s - p))
    padding[k] = 0
    return conv(band, weight, bias, stride, padding)


def row_conv(conv: torch.nn.Module, x: torch.Tensor, row_axis: int = -2) -> torch.Tensor:
    """`conv(x)` for an `nn.Conv2d` / `nn.Conv3d` of zero padding, on
    sharded rows when a row group is active."""
    if conv.padding_mode != "zeros" or conv.groups != 1 or any(d != 1 for d in conv.dilation):
        raise ValueError(f"row_conv: {conv} (zero padding, one group, dilation 1 only)")
    return conv_rows(x, conv.weight, conv.bias, conv.stride, conv.padding, row_axis)
