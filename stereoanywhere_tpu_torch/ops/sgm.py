"""Semi-global matching, the classical baseline (the JAX package's
`ops/sgm.py`; the reference shells out to OpenCV's StereoSGBM): a 5x5
census transform, the Hamming matching cost over `max_disp` disparities,
and dynamic-programming aggregation along four paths (left to right, right
to left, top to bottom, bottom to top), then the first disparity of least
total cost.

The census bits are kept in int64 (torch has little uint32 arithmetic);
the 24 bits of a 5x5 window fit either way.  The costs are small integers
held in f32, and every DP step adds, subtracts and takes minima of such
integers with the integer-valued penalties, so the arithmetic is exact and
the result is the JAX package's bit for bit.  Not on the model's path.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

INVALID_COST = 24.0  # a column with no match at a disparity: the most bits a 5x5 census differs in


def census_transform(gray: torch.Tensor, window: int = 5) -> torch.Tensor:
    """(B,H,W) grayscale -> (B,H,W) int64 census bit strings: bit i is set
    where the i-th neighbour of the window (row-major, the centre skipped;
    edge-replicated) is darker than the centre."""
    r = window // 2
    pad = F.pad(gray[:, None], (r, r, r, r), mode="replicate")[:, 0]
    h, w = gray.shape[1:]
    out = torch.zeros(gray.shape, dtype=torch.int64, device=gray.device)
    i = 0
    for dy in range(window):
        for dx in range(window):
            if dy == r and dx == r:
                continue
            out = out | ((pad[:, dy:dy + h, dx:dx + w] < gray).long() << i)
            i += 1
    return out


def _hamming(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Bits set in a ^ b, as f32 (a SWAR popcount of 32-bit words)."""
    x = a ^ b
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (((x * 0x01010101) & 0xFFFFFFFF) >> 24).float()


def matching_cost(left: torch.Tensor, right: torch.Tensor, max_disp: int) -> torch.Tensor:
    """(B,H,W) pair -> (B,H,W,D) census Hamming costs; columns x < d have no
    match at disparity d and cost INVALID_COST."""
    cl, cr = census_transform(left), census_transform(right)
    w = cl.shape[2]
    costs = []
    for d in range(max_disp):
        shifted = F.pad(cr, (d, 0))[:, :, :w]
        c = _hamming(cl, shifted)
        invalid = torch.arange(w, device=cl.device) < d
        costs.append(torch.where(invalid[None, None, :], torch.full_like(c, INVALID_COST), c))
    return torch.stack(costs, dim=-1)


def _dp_sweep(cost: torch.Tensor, p1: float, p2: float) -> torch.Tensor:
    """Aggregation along axis 1 of (B,L,N,D): L(p, d) = C(p, d) + min(L(p-1,
    d), L(p-1, d +- 1) + p1, min_k L(p-1, k) + p2) - min_k L(p-1, k)."""
    inf = torch.tensor(float("inf"), dtype=cost.dtype, device=cost.device)
    prev = cost[:, 0]
    out = [prev]
    for i in range(1, cost.shape[1]):
        prev_min = prev.min(dim=-1, keepdim=True).values
        lower = torch.cat([inf.expand(*prev.shape[:-1], 1), prev[..., :-1]], dim=-1) + p1
        upper = torch.cat([prev[..., 1:], inf.expand(*prev.shape[:-1], 1)], dim=-1) + p1
        best = torch.minimum(torch.minimum(prev, lower), torch.minimum(upper, prev_min + p2))
        prev = cost[:, i] + best - prev_min
        out.append(prev)
    return torch.stack(out, dim=1)


def sgm_disparity(
    left_gray: torch.Tensor,
    right_gray: torch.Tensor,
    max_disp: int = 64,
    p1: float = 2.0,
    p2: float = 32.0,
) -> torch.Tensor:
    """(B,H,W) grayscale in [0,1] -> (B,H,W) f32 disparity by 4-path SGM."""
    cost = matching_cost(left_gray, right_gray, max_disp)  # (B,H,W,D)
    total = _dp_sweep(cost.transpose(1, 2), p1, p2).transpose(1, 2)  # left to right
    total = total + _dp_sweep(cost.flip(2).transpose(1, 2), p1, p2).transpose(1, 2).flip(2)
    total = total + _dp_sweep(cost, p1, p2)  # top to bottom
    total = total + _dp_sweep(cost.flip(1), p1, p2).flip(1)
    return torch.argmin(total, dim=-1).float()
