"""Layers with the reference model's semantics and parameter names.

Tensors are (B,C,H,W) and (B,C,D,H,W) in shape; on the card the stereo
stage holds its 2-D ones channels-last in memory, as its 2-D convolution
weights (`channels_last_weights`), so that cuDNN's NHWC kernels read and
write them as they are; the hourglass's volumes stay NCDHW.  Every layer
here keeps its input's memory format.

- `InstanceNorm`: per-sample, per-channel over the spatial axes, no affine;
  statistics in f32, applied in the input dtype.
- `BatchNorm`: running statistics (the reference freezes BatchNorm at
  every training step), or, inside `batch_statistics`, the batch's
  (flax's `use_running_average=False`: over the global batch under several
  ranks); torch's parameter/buffer names minus `num_batches_tracked`.
- `ResidualBlock`, `BasicConv`: the reference blocks.

With a row group active (`parallel/halo.py`) the convolutions run on the
rank's rows with halos from its neighbours, and the instance norm's sums
are taken over the group's ranks; BatchNorm on running statistics needs
nothing, and on the batch's is for training, which a row group refuses.
- `channels_last_weights`: the 2-D convolutions' weights held
  channels-last, in place (a module may keep its own contiguous:
  `channels_last = False`).
- `init_weights`: random initialization with the JAX package's initializer
  families (truncated-normal He fan-out for convs, LeCun for dense layers),
  drawn from an explicit `torch.Generator`.
"""
from __future__ import annotations

import math
from contextlib import contextmanager

import torch
import torch.nn as nn
import torch.nn.functional as F

from stereoanywhere_tpu_torch.device import channels_last_format
from stereoanywhere_tpu_torch.parallel import halo
from stereoanywhere_tpu_torch.parallel.halo import conv_rows, row_conv
from stereoanywhere_tpu_torch.parallel.multihost import sum_over_ranks


def _space_sums(t: torch.Tensor) -> torch.Tensor:
    """t summed over its spatial axes: (B, C).  A channels-last t is summed
    in its memory order (B, spatial axes, C), each row first, then the
    rows: over the whole plane at once the reduction runs 1.5-2x slower on
    the card (NVIDIA H100, the feature encoder's bf16 maps at KITTI size)."""
    dims = tuple(range(2, t.ndim))
    if channels_last_format(t) is None:
        return t.sum(dim=dims)
    rows = t.permute(0, *dims, 1).sum(dim=t.ndim - 2)  # (B, spatial axes but the last, C)
    return rows.sum(dim=tuple(range(1, rows.ndim - 1)))


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Normalize each (sample, channel) over the spatial axes of a
    (B,C,H,W) / (B,C,D,H,W) tensor: mean and var = E[x^2] - E[x]^2 from the
    sums of x and x^2 in f32 (`_space_sums`) over their count, applied in
    x's dtype.  With a row group active, the sums and the count are the
    group's."""
    b, c = x.shape[:2]
    xf = x.float()
    s1, s2, n = _space_sums(xf), _space_sums(xf * xf), xf[0, 0].numel()
    g = halo.active()
    if g is not None:
        total = g.all_reduce(torch.cat([s1.flatten(), s2.flatten(), xf.new_full((1,), n)]))
        s1, s2, n = total[:b * c], total[b * c:2 * b * c], total[-1]
    shape = (b, c) + (1,) * (x.ndim - 2)
    mean = (s1 / n).view(shape)
    var = (s2 / n).view(shape) - mean * mean
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return (x - mean.to(x.dtype)) * inv


class InstanceNorm(nn.Module):
    """Parameter-free instance norm (torch InstanceNorm{2,3}d, affine=False)."""

    def forward(self, x):
        return instance_norm(x)


class BatchNorm(nn.Module):
    """BatchNorm2d with torch's defaults (eps 1e-5, momentum 0.1), applied
    in the input's dtype.  It normalizes with its running statistics unless
    `batch_statistics` is set: then with the batch's mean and biased
    variance E[x^2] - mean^2 in f32 over (B, H, W), summed over the ranks
    with autograd through the sum, and it updates the running statistics as
    flax does (0.9 ra + 0.1 batch, the variance unbiased by n / (n - 1), n
    the global count)."""

    momentum = 0.9  # flax's convention: the weight of the running value

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.batch_statistics = False
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x):
        shape = (1, -1) + (1,) * (x.ndim - 2)
        mean, var = self._batch_moments(x) if self.batch_statistics else (self.running_mean, self.running_var)
        inv = torch.rsqrt(var.float() + self.eps).to(x.dtype) * self.weight.to(x.dtype)
        return (x - mean.to(x.dtype).view(shape)) * inv.view(shape) + self.bias.to(x.dtype).view(shape)

    def _batch_moments(self, x):
        c = x.shape[1]
        dims = (0, *range(2, x.ndim))
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        sums = sum_over_ranks(torch.cat([xf.sum(dims), (xf * xf).sum(dims), xf.new_full((1,), x.numel() // c)]))
        n = sums[-1]
        mean = sums[:c] / n
        var = sums[c:2 * c] / n - mean * mean
        with torch.no_grad():
            unbiased = var * (n / (n - 1).clamp(min=1.0))
            self.running_mean.copy_(self.momentum * self.running_mean + (1 - self.momentum) * mean)
            self.running_var.copy_(self.momentum * self.running_var + (1 - self.momentum) * unbiased)
        return mean, var


@contextmanager
def batch_statistics(model: nn.Module, on: bool):
    """Every BatchNorm of `model` on the batch's statistics inside the block
    (when `on`), on its running ones after it."""
    norms = [m for m in model.modules() if isinstance(m, BatchNorm)]
    for m in norms:
        m.batch_statistics = on
    try:
        yield
    finally:
        for m in norms:
            m.batch_statistics = False


def _norm(kind: str, features: int) -> nn.Module:
    if kind == "batch":
        return BatchNorm(features)
    if kind == "instance":
        return InstanceNorm()
    if kind == "none":
        return nn.Identity()
    raise ValueError(f"unknown norm {kind!r}")


class ResidualBlock(nn.Module):
    """Two 3x3 convs with norm + ReLU and a (1x1 conv + norm) shortcut when
    the shape changes (reference extractor ResidualBlock)."""

    def __init__(self, in_planes: int, planes: int, norm_fn: str = "instance", stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_planes, planes, 3, stride=stride, padding=1)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1)
        self.norm1 = _norm(norm_fn, planes)
        self.norm2 = _norm(norm_fn, planes)
        self.downsample = None
        if stride != 1 or in_planes != planes:
            self.norm3 = _norm(norm_fn, planes)
            # the reference registers norm3 twice (as norm3 and downsample.1)
            self.downsample = nn.Sequential(nn.Conv2d(in_planes, planes, 1, stride=stride), self.norm3)

    def forward(self, x):
        y = F.relu(self.norm1(row_conv(self.conv1, x)))
        y = F.relu(self.norm2(row_conv(self.conv2, y)))
        if self.downsample is not None:
            x = self.downsample[1](row_conv(self.downsample[0], x))
        return F.relu(x + y)


def conv_in_dtype(conv: nn.Module, x: torch.Tensor, row_axis: int = -2) -> torch.Tensor:
    """conv(x) in x's dtype: the parameters are cast to it at the call, as
    the JAX package's convs cast their kernel to the input's dtype (an f32
    input of a bf16 model runs in f32).  `row_axis`: x's image rows, which a
    row group shards."""
    bias = None if conv.bias is None else conv.bias.to(x.dtype)
    return conv_rows(x, conv.weight.to(x.dtype), bias, conv.stride, conv.padding, row_axis)


class BasicConv(nn.Module):
    """conv (no bias) -> instance norm -> leaky ReLU(0.01), 2-D or 3-D, or a
    2-D transposed conv (`deconv`, torch's ConvTranspose2d; not row-aware),
    in the input's dtype."""

    def __init__(self, in_ch: int, out_ch: int, is_3d: bool = False, kernel_size: int = 3,
                 stride: int = 1, padding: int = 1, deconv: bool = False):
        super().__init__()
        if deconv and is_3d:
            raise ValueError("BasicConv: a 3-D transposed conv is not used by any model")
        conv = nn.ConvTranspose2d if deconv else nn.Conv3d if is_3d else nn.Conv2d
        self.conv = conv(in_ch, out_ch, kernel_size, stride=stride, padding=padding, bias=False)

    def forward(self, x):
        if isinstance(self.conv, nn.ConvTranspose2d):
            y = F.conv_transpose2d(x, self.conv.weight.to(x.dtype), None, self.conv.stride, self.conv.padding)
        else:
            y = conv_in_dtype(self.conv, x)
        return F.leaky_relu(instance_norm(y), negative_slope=0.01)


def channels_last_weights(model: nn.Module) -> nn.Module:
    """Hold the weight of every `nn.Conv2d` of `model` channels-last, in
    place of its contiguous one, but inside a module that says
    `channels_last = False`.  A convolution's output then comes
    channels-last, whatever its input's format (a one-channel input fits
    both).  Loads that copy into the parameters (`load_state_dict`,
    `compat.from_jax`) keep the format."""
    if getattr(model, "channels_last", True):
        for mod in model.children():
            channels_last_weights(mod)
        if isinstance(model, nn.Conv2d):
            model.weight.data = model.weight.data.clone(memory_format=torch.channels_last)
    return model


# ---------------------------------------------------------------------------
# Initialization


def _trunc_normal_(t: torch.Tensor, std: float, generator: torch.Generator) -> None:
    """Truncated normal at +-2 std, the variance-preserving form flax uses
    (stddev / 0.8796... so that the truncated variance is std^2)."""
    s = std / 0.87962566103423978
    with torch.no_grad():
        draw = torch.empty(t.shape, device=t.device, dtype=torch.float32)  # drawn in f32, then cast to t's dtype
        t.copy_(torch.nn.init.trunc_normal_(draw, 0.0, s, -2 * s, 2 * s, generator=generator))


LECUN = "lecun"


def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Random weights with the JAX package's initializer families: convs He
    fan-out, `nn.Linear` and modules tagged `init_kind = LECUN` LeCun fan-in
    (both truncated normal), biases zero, norms identity.  Parameters of
    other shapes are left to their owning module's `reset_parameters`."""
    for mod in model.modules():
        kind = getattr(mod, "init_kind", None)
        if isinstance(mod, (nn.Conv2d, nn.Conv3d, nn.ConvTranspose2d, nn.Linear)):
            w = mod.weight
            rf = math.prod(w.shape[2:]) if w.ndim > 2 else 1
            if isinstance(mod, nn.Linear) or kind == LECUN:
                _trunc_normal_(w, math.sqrt(1.0 / (w.shape[1] * rf)), generator)
            else:
                _trunc_normal_(w, math.sqrt(2.0 / (w.shape[0] * rf)), generator)
            if mod.bias is not None:
                nn.init.zeros_(mod.bias)
        elif isinstance(mod, (BatchNorm, nn.LayerNorm)):
            nn.init.ones_(mod.weight)
            nn.init.zeros_(mod.bias)
        if hasattr(mod, "reset_parameters_from") and callable(mod.reset_parameters_from):
            mod.reset_parameters_from(generator)
    return model
