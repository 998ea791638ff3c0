"""Random weights from a seed, drawn by the benchmark and loaded alike into
the port and into the reference.

Every parameter's distribution follows from the module that owns it and
the parameter's name (`param_law`), never from the owner's own
initialiser, so that the port and the reference, whose modules share
class names and parameter names, get the same tensors for one seed:

- convolutions: He fan-in, N(0, 2 / fan_in); a transposed convolution
  whose stride equals its kernel gives each output one tap of each input
  channel, so its fan-in is its input channels;
- `nn.Linear`: LeCun fan-in, N(0, 1 / fan_in);
- biases N(0, 0.02^2); norms' weights 1, their biases 0; LayerScale a
  constant; the position embedding and class token N(0, 0.02^2);
- a configuration's `weight_scales` multiply the spread of the named
  parameters (the refinement loop's flow head, whose trained weights make
  small steps: see `PERF.md`).

The draw is one `normal_` over the parameters' total length on the
model's device, from a generator on that device seeded with the seed;
each parameter takes its slice in the order of the sorted names, scaled
and rounded to the served dtype.  The reference takes the same rounded
values in f32.
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn

BIAS_STD = 0.02
EMBED_STD = 0.02


def param_law(module: nn.Module, leaf: str, shape: tuple[int, ...], layer_scale: float) -> tuple[float, float]:
    """(mean, std) of the parameter `leaf` of `module`."""
    kind = type(module).__name__
    if leaf == "bias":
        return (0.0, 0.0) if kind in ("LayerNorm", "BatchNorm") else (0.0, BIAS_STD)
    if leaf == "weight" and kind in ("Conv2d", "Conv3d"):
        return 0.0, math.sqrt(2.0 / (shape[1] * math.prod(shape[2:])))
    if leaf == "weight" and kind == "ConvTranspose2d":
        return 0.0, math.sqrt(2.0 / shape[0])
    if leaf == "weight" and kind == "Linear":
        return 0.0, math.sqrt(1.0 / shape[1])
    if leaf == "weight" and kind in ("LayerNorm", "BatchNorm"):
        return 1.0, 0.0
    if leaf == "gamma" and kind == "LayerScale":
        return layer_scale, 0.0
    if leaf in ("pos_embed", "cls_token"):
        return 0.0, EMBED_STD
    raise ValueError(f"no law for {kind}.{leaf} {shape}")


def spec(model: nn.Module, layer_scale: float, scales: dict[str, float]) -> list[tuple[str, tuple, float, float]]:
    """[(name, shape, mean, std)] of every parameter of `model`, sorted by
    name; `scales` multiplies the std of the parameters it names (each
    name must exist)."""
    modules = dict(model.named_modules())
    out = []
    for name, p in sorted(model.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        mean, std = param_law(modules[owner], leaf, tuple(p.shape), layer_scale)
        out.append((name, tuple(p.shape), mean, std * scales.get(name, 1.0)))
    missing = set(scales) - {n for n, *_ in out}
    if missing:
        raise ValueError(f"weight_scales name no parameter: {sorted(missing)}")
    return out


@torch.no_grad()
def draw_into(model: nn.Module, seed: int, dtype: torch.dtype, layer_scale: float,
              scales: dict[str, float] | None = None) -> int:
    """Fill every parameter of `model` in place with its draw from `seed`
    (the values rounded to `dtype`, then to the parameter's own dtype);
    returns the number of values drawn."""
    laws = spec(model, layer_scale, scales or {})
    params = dict(model.named_parameters())
    device = next(iter(params.values())).device
    total = sum(math.prod(shape) for _, shape, _, _ in laws)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.empty(total, device=device, dtype=torch.float32).normal_(generator=gen)
    at = 0
    for name, shape, mean, std in laws:
        n = math.prod(shape)
        params[name].copy_(flat[at:at + n].view(shape).mul_(std).add_(mean).to(dtype))
        at += n
    return total
