"""All-pairs correlation with the image width sharded over a ring of ranks:
the JAX package's `parallel/ring_corr.py`.

The (B, H, W2, W3) all-pairs volume is the quadratic "attention matrix" of
dense stereo.  Its exact blockwise decomposition is the one ring attention
uses: each of N ranks holds a W2 band of the left features and a W3 block
of the right ones, computes the (W2/N, W3/N) block against the right block
it holds, and passes that block on to the next rank of the ring
(`torch.distributed.batch_isend_irecv`); after N steps every rank holds the
full disparity rows of its band, (B, H, W2/N, W3).  The block product is a
plain `torch.matmul` in f32, as JAX computes it with an `einsum` outside
any Pallas kernel.

A standalone primitive, as in the JAX package: nothing on the model path
calls it.  Under row sharding (`spatial.py`) every data-dependent operation
of the model (the K5 lookups, the LRC warps, the soft-argmax, the mirror
truncation) reads along the W axes, which stay on the rank, so rows
dominate columns for this model; the ring is the primitive for a
W-dominant geometry (panoramic strips with H/4 < N).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from stereoanywhere_tpu_torch.parallel.halo import group_ranks, send_recv, staged
from stereoanywhere_tpu_torch.parallel.mesh import Mesh


def ring_all_pairs_correlation(feat_left: torch.Tensor, feat_right: torch.Tensor, group=None) -> torch.Tensor:
    """The per-rank body over the ranks of `group` (default: all ranks).

    feat_left  (B, H, W2/N, C): this rank's band of volume rows
    feat_right (B, H, W3/N, C): this rank's starting right block
    returns    (B, H, W2/N, W3): the band's full disparity rows, scaled by
               1/sqrt(C), in feat_left's dtype.

    At ring step s a rank computes against the right block that started on
    rank (i - s) mod N and forwards it to rank i + 1."""
    initialized = dist.is_available() and dist.is_initialized()
    ranks = group_ranks(group) if initialized else [0]
    n, my = len(ranks), ranks.index(dist.get_rank()) if initialized else 0
    b, h, w2_blk, c = feat_left.shape
    w3_blk = feat_right.shape[2]
    scale = float(np.float32(1) / np.sqrt(np.float32(c)))
    left = feat_left.float()
    out = feat_left.new_empty((b, h, w2_blk, n * w3_blk))
    block = feat_right
    for s in range(n):
        src = (my - s) % n
        vol = torch.matmul(left, block.float().transpose(-1, -2)) * scale
        out[..., src * w3_blk:(src + 1) * w3_blk] = vol.to(out.dtype)
        if s < n - 1:  # the last block needs no forward
            block, = send_recv(group, [(ranks[(my + 1) % n], block)], [(ranks[(my - 1) % n], block)],
                               staged(group, block))
    return out


def sharded_correlation_volume(feat_left: torch.Tensor, feat_right: torch.Tensor, mesh: Mesh,
                               axis: str = "tile") -> torch.Tensor:
    """The all-pairs volume with W2 sharded over the mesh's `axis`, through
    the ring.  Inputs: the whole (B, H, W, C) features on every rank, W a
    multiple of the axis's size; returns this rank's band (B, H, W/N, W)."""
    n, i = mesh.shape[axis], mesh.coords[axis]
    w = feat_left.shape[2]
    if w % n:
        raise ValueError(f"sharded_correlation_volume: width {w} is no multiple of {n} ranks")
    k = w // n
    return ring_all_pairs_correlation(feat_left[:, :, i * k:(i + 1) * k], feat_right[:, :, i * k:(i + 1) * k],
                                      mesh.groups[axis])
