"""DINOv2 vision transformer, the Depth-Anything-V2 backbone, in PyTorch.

Each block runs its attention sub-block through three hand-written kernels
(`ops/cuda/`): K1 LN1 + QKV, K2 attention, K3 proj + LayerScale + residual.
The FFN of ViT-S/B/L runs in the fourth, K4 LN2 + MLP, and only the
LayerScale-2 residual add stays in PyTorch, as in the JAX block.  ViT-G's
SwiGLU FFN (LN2, `w12`, SiLU gate, `w3`, LayerScale-2) is plain PyTorch:
the JAX block runs it in XLA, outside every Pallas kernel.  The modules
hold the parameters under the reference names (norm1, attn.qkv, attn.proj,
ls1, norm2, mlp.fc1 / mlp.fc2 or mlp.w12 / mlp.w3, ls2) without running
their own forward.

Shipped config: patch 14, pos-embed grid 37 (518/14), LayerScale on, no
registers, interpolate_offset 0.1.  ViT-S/B/L/G.
"""
from __future__ import annotations

import functools
import math
from typing import Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from stereoanywhere_tpu_torch.device import device_constant
from stereoanywhere_tpu_torch.models.layers import LECUN
from stereoanywhere_tpu_torch.ops.cuda.vit_attention import vit_attention
from stereoanywhere_tpu_torch.ops.cuda.vit_dense import dense_scale_residual, ln_dense
from stereoanywhere_tpu_torch.ops.cuda.vit_mlp import vit_mlp

VIT_CONFIGS = {
    "vits": dict(embed_dim=384, depth=12, num_heads=6),
    "vitb": dict(embed_dim=768, depth=12, num_heads=12),
    "vitl": dict(embed_dim=1024, depth=24, num_heads=16),
    "vitg": dict(embed_dim=1536, depth=40, num_heads=24, ffn_layer="swiglufused"),
}


@functools.lru_cache(maxsize=None)
def _bicubic_scale_matrix(in_size: int, out_size: int, scale: float) -> np.ndarray:
    """(out, in) bicubic (a=-0.75) weights with an explicit scale factor:
    src = (dst + 0.5) / scale - 0.5, border taps clamped (torch
    `F.interpolate(scale_factor=..., mode='bicubic')`)."""
    a = -0.75
    dst = np.arange(out_size, dtype=np.float32)
    src = (dst + np.float32(0.5)) / np.float32(scale) - np.float32(0.5)
    i0 = np.floor(src).astype(np.int64)
    t = (src - i0.astype(np.float32)).astype(np.float32)
    m = np.zeros((out_size, in_size), np.float32)
    rows = np.arange(out_size)
    for k in range(-1, 3):
        at = np.abs(t - k)
        w1 = (a + 2) * at ** 3 - (a + 3) * at ** 2 + 1
        w2 = a * at ** 3 - 5 * a * at ** 2 + 8 * a * at - 4 * a
        wk = np.where(at <= 1, w1, np.where(at < 2, w2, 0.0)).astype(np.float32)
        np.add.at(m, (rows, np.clip(i0 + k, 0, in_size - 1)), wk)
    return m


def interpolate_pos_embed(pos_embed: torch.Tensor, patch_h: int, patch_w: int, offset: float = 0.1) -> torch.Tensor:
    """(1, 1+N, D) -> (1, 1+patch_h*patch_w, D): bicubic scale-factor
    interpolation of the square position grid, with the reference's 0.1
    offset on the scale."""
    n = pos_embed.shape[1] - 1
    side = int(math.sqrt(n))
    if patch_h * patch_w == n and patch_h == patch_w:
        return pos_embed
    grid = pos_embed[:, 1:].reshape(side, side, -1).float()
    mh = device_constant(_bicubic_scale_matrix, (side, patch_h, (patch_h + offset) / side), grid.device, grid.dtype)
    mw = device_constant(_bicubic_scale_matrix, (side, patch_w, (patch_w + offset) / side), grid.device, grid.dtype)
    grid = torch.einsum("ph,hwd->pwd", mh, grid)
    grid = torch.einsum("qw,pwd->pqd", mw, grid)
    return torch.cat([pos_embed[:, :1], grid.reshape(1, patch_h * patch_w, -1).to(pos_embed.dtype)], dim=1)


class LayerScale(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(dim))

    def reset_parameters_from(self, generator: torch.Generator) -> None:
        nn.init.ones_(self.gamma)


class Attention(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)


class SwiGLUFFN(nn.Module):
    """ViT-G's fused SwiGLU FFN (reference dinov2_layers SwiGLUFFNFused):
    hidden = align8(4 D * 2/3), out = w3(silu(x1) * x2) with [x1 | x2] =
    w12(x)."""

    def __init__(self, dim: int, mlp_ratio: float = 4.0):
        super().__init__()
        hidden = (int(dim * mlp_ratio) * 2 // 3 + 7) // 8 * 8
        self.w12 = nn.Linear(dim, 2 * hidden)
        self.w3 = nn.Linear(hidden, dim)

    def forward(self, x):
        x1, x2 = self.w12(x).chunk(2, dim=-1)
        return self.w3(F.silu(x1) * x2)


class Block(nn.Module):
    """Pre-norm transformer block with LayerScale: the attention sub-block
    through K1-K3, the FFN through K4 (`ffn_layer="mlp"`) or in plain
    PyTorch (`"swiglufused"`, ViT-G)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0, ffn_layer: str = "mlp"):
        super().__init__()
        if ffn_layer not in ("mlp", "swiglufused"):
            raise ValueError(f"unknown ffn_layer {ffn_layer!r}")
        self.num_heads = num_heads
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim)
        self.ls1 = LayerScale(dim)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, int(dim * mlp_ratio)) if ffn_layer == "mlp" else SwiGLUFFN(dim, mlp_ratio)
        self.ls2 = LayerScale(dim)

    def forward(self, x):
        qkv = ln_dense(x, self.norm1.weight, self.norm1.bias, self.attn.qkv.weight, self.attn.qkv.bias)
        o = vit_attention(qkv, self.num_heads)
        x = dense_scale_residual(x, o, self.attn.proj.weight, self.attn.proj.bias, self.ls1.gamma)
        if isinstance(self.mlp, SwiGLUFFN):
            ffn = self.mlp(self.norm2(x))
        else:
            ffn = vit_mlp(x, self.norm2.weight, self.norm2.bias, self.mlp.fc1.weight, self.mlp.fc1.bias,
                          self.mlp.fc2.weight, self.mlp.fc2.bias)
        return x + ffn * self.ls2.gamma


class PatchEmbed(nn.Module):
    def __init__(self, dim: int, patch: int):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, patch, stride=patch)
        self.proj.init_kind = LECUN


class DinoVisionTransformer(nn.Module):
    """Returns the (patch tokens, cls token) pairs of the taken layers, each
    after the final norm.  Input NCHW with H, W multiples of 14."""

    def __init__(self, embed_dim: int = 1024, depth: int = 24, num_heads: int = 16, patch_size: int = 14,
                 pos_embed_size: int = 37, interpolate_offset: float = 0.1, ffn_layer: str = "mlp"):
        super().__init__()
        self.patch_size = patch_size
        self.interpolate_offset = interpolate_offset
        self.patch_embed = PatchEmbed(embed_dim, patch_size)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, pos_embed_size ** 2 + 1, embed_dim))
        self.blocks = nn.ModuleList(Block(embed_dim, num_heads, ffn_layer=ffn_layer) for _ in range(depth))
        self.norm = nn.LayerNorm(embed_dim, eps=1e-6)

    def reset_parameters_from(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            dev = generator.device
            self.cls_token.copy_(torch.randn(self.cls_token.shape, generator=generator, device=dev) * 1e-6)
            self.pos_embed.copy_(torch.randn(self.pos_embed.shape, generator=generator, device=dev) * 0.02)

    def forward(self, x: torch.Tensor, take_layers: Sequence[int]):
        b, _, h, w = x.shape
        ph, pw = h // self.patch_size, w // self.patch_size
        x = self.patch_embed.proj(x).flatten(2).transpose(1, 2)  # (B, ph*pw, D)
        x = torch.cat([self.cls_token.expand(b, -1, -1).to(x.dtype), x], dim=1)
        x = x + interpolate_pos_embed(self.pos_embed, ph, pw, self.interpolate_offset).to(x.dtype)
        outputs = []
        for i, blk in enumerate(self.blocks):
            x = blk(x)
            if i in take_layers:
                outputs.append(x)
        outputs = [F.layer_norm(o, o.shape[-1:], self.norm.weight, self.norm.bias, self.norm.eps) for o in outputs]
        return [(o[:, 1:], o[:, 0]) for o in outputs]
