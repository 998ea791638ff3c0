"""The reference's products: every convolution, linear layer and matrix
product of the reference goes through these functions.

They compute in float32, with TF32 off inside `strict_f32()`.  Inside
`rounded_operands(dtype)` both operands of each product are first rounded
to `dtype` and the product taken in f32: to bfloat16, the yardstick of the
output check (how far rounding alone moves the reference for this seed's
weights and inputs), or to float8 e4m3 with one scale a tensor (its
largest magnitude onto e4m3's 448), the step below the bf16 that the
configurations serve in: the benchmark's control, which the check has to
refuse.
"""
from __future__ import annotations

import contextvars
from contextlib import contextmanager

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0
_ROUND = contextvars.ContextVar("rounded_operands", default=None)


@contextmanager
def strict_f32():
    """Float32 products in float32 (no TF32) inside the block."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


@contextmanager
def rounded_operands(dtype: torch.dtype | None):
    """Round every product's operands to `dtype` (bfloat16 or
    float8_e4m3fn; None: not at all) inside the block."""
    if dtype not in (None, torch.bfloat16, torch.float8_e4m3fn):
        raise ValueError(f"operands are rounded to bfloat16 or float8_e4m3fn, not {dtype}")
    token = _ROUND.set(dtype)
    try:
        yield
    finally:
        _ROUND.reset(token)


def q(x: torch.Tensor) -> torch.Tensor:
    """x as a product sees it under `rounded_operands`."""
    dt = _ROUND.get()
    if dt is None:
        return x
    if dt == torch.bfloat16:
        return x.to(dt).float()
    scale = E4M3_MAX / x.detach().abs().amax().float().clamp(min=1e-30)
    return (x.float() * scale).to(torch.float8_e4m3fn).float() / scale


def conv2d(x, w, b=None, stride=1, padding=0):
    return F.conv2d(q(x), q(w), b, stride, padding)


def conv3d(x, w, b=None, stride=1, padding=0):
    return F.conv3d(q(x), q(w), b, stride, padding)


def conv_transpose2d(x, w, b=None, stride=1, padding=0):
    return F.conv_transpose2d(q(x), q(w), b, stride, padding)


def linear(x, w, b=None):
    return F.linear(q(x), q(w), b)


def matmul(a, b):
    return torch.matmul(q(a), q(b))


def conv(m, x):
    """The conv module m (its weight, bias, stride, padding) applied to x."""
    fn = {torch.nn.Conv2d: conv2d, torch.nn.Conv3d: conv3d, torch.nn.ConvTranspose2d: conv_transpose2d}[type(m)]
    return fn(x, m.weight, m.bias, m.stride, m.padding)
