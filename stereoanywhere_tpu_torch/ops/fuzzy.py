"""Fuzzy-logic confidence combinators: the product t-norm and its
probabilistic sum, and Zadeh's min / max smoothed by a log-sum-exp of
temperature `eps` (the JAX package's `ops/fuzzy.py`)."""
from __future__ import annotations

import torch


def fuzzy_and(x, y):
    return x * y


def fuzzy_or(x, y):
    return x + y - x * y


def fuzzy_not(x):
    return 1.0 - x


def fuzzy_and_zadeh(x: torch.Tensor, y: torch.Tensor, eps: float = 1e-3, dim: int = 1) -> torch.Tensor:
    """Smooth min of x and y: -eps * logsumexp(-[x, y] / eps) over their
    concatenation along `dim` (the channels of NCHW maps), kept as an axis
    of size one."""
    return -eps * torch.logsumexp(-torch.cat([x, y], dim=dim) / eps, dim=dim, keepdim=True)


def fuzzy_or_zadeh(x: torch.Tensor, y: torch.Tensor, eps: float = 1e-3, dim: int = 1) -> torch.Tensor:
    """Smooth max of x and y: eps * logsumexp([x, y] / eps) along `dim`."""
    return eps * torch.logsumexp(torch.cat([x, y], dim=dim) / eps, dim=dim, keepdim=True)
