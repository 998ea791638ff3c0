"""Depth-Anything-V2 in plain PyTorch, f32: DINOv2 (patch embedding,
bicubic position-embedding interpolation, pre-norm blocks with
LayerScale, softmax attention, GELU MLP or ViT-G's SwiGLU) and the DPT
head.

A frozen copy of the semantics of `stereoanywhere_tpu_torch/models/
dinov2.py` and `dpt.py` with the plain versions of the K1-K4 kernels,
under the same module classes' names and parameter names.  Every product
runs through `arith`; the attention runs head by head so that its score
matrix fits at 4552 tokens.
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from port_bench.reference import arith
from port_bench.reference import ops

VIT_CONFIGS = {
    "vits": dict(embed_dim=384, depth=12, num_heads=6, features=64, out_channels=(48, 96, 192, 384),
                 layers=(2, 5, 8, 11)),
    "vitb": dict(embed_dim=768, depth=12, num_heads=12, features=128, out_channels=(96, 192, 384, 768),
                 layers=(2, 5, 8, 11)),
    "vitl": dict(embed_dim=1024, depth=24, num_heads=16, features=256, out_channels=(256, 512, 1024, 1024),
                 layers=(4, 11, 17, 23)),
    "vitg": dict(embed_dim=1536, depth=40, num_heads=24, features=384, out_channels=(1536, 1536, 1536, 1536),
                 layers=(9, 19, 29, 39), ffn="swiglu"),
}
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


class LayerScale(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(dim))


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

    def forward(self, x):
        a = arith.linear(x, self.fc1.weight, self.fc1.bias)
        return arith.linear(F.gelu(a), self.fc2.weight, self.fc2.bias)


class SwiGLUFFN(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        hidden = (int(dim * 4.0) * 2 // 3 + 7) // 8 * 8
        self.w12 = nn.Linear(dim, 2 * hidden)
        self.w3 = nn.Linear(hidden, dim)

    def forward(self, x):
        x1, x2 = arith.linear(x, self.w12.weight, self.w12.bias).chunk(2, dim=-1)
        return arith.linear(F.silu(x1) * x2, self.w3.weight, self.w3.bias)


def attention(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """softmax(q k^T / sqrt(hd)) v of each head of a fused (B, T, 3D)
    projection -> (B, T, D)."""
    b, t, three_d = qkv.shape
    d = three_d // 3
    hd = d // num_heads
    q, k, v = qkv.view(b, t, 3, num_heads, hd).permute(2, 0, 3, 1, 4)
    out = torch.empty((b, num_heads, t, hd), device=qkv.device, dtype=qkv.dtype)
    for h in range(num_heads):
        s = arith.matmul(q[:, h], k[:, h].transpose(-1, -2)) * (hd ** -0.5)
        out[:, h] = arith.matmul(torch.softmax(s, dim=-1), v[:, h])
    return out.transpose(1, 2).reshape(b, t, d)


class Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, ffn: str):
        super().__init__()
        self.num_heads = num_heads
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim)
        self.ls1 = LayerScale(dim)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = SwiGLUFFN(dim) if ffn == "swiglu" else Mlp(dim, 4 * dim)
        self.ls2 = LayerScale(dim)

    def forward(self, x):
        h = F.layer_norm(x, x.shape[-1:], self.norm1.weight, self.norm1.bias, self.norm1.eps)
        o = attention(arith.linear(h, self.attn.qkv.weight, self.attn.qkv.bias), self.num_heads)
        x = x + self.ls1.gamma * arith.linear(o, self.attn.proj.weight, self.attn.proj.bias)
        h = F.layer_norm(x, x.shape[-1:], self.norm2.weight, self.norm2.bias, self.norm2.eps)
        return x + self.ls2.gamma * self.mlp(h)


class PatchEmbed(nn.Module):
    def __init__(self, dim: int, patch: int):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, patch, stride=patch)


class DinoVisionTransformer(nn.Module):
    def __init__(self, embed_dim: int, depth: int, num_heads: int, ffn: str = "mlp", patch_size: int = 14,
                 pos_embed_size: int = 37):
        super().__init__()
        self.patch_size = patch_size
        self.patch_embed = PatchEmbed(embed_dim, patch_size)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, pos_embed_size ** 2 + 1, embed_dim))
        self.blocks = nn.ModuleList(Block(embed_dim, num_heads, ffn) for _ in range(depth))
        self.norm = nn.LayerNorm(embed_dim, eps=1e-6)

    def pos_embed_at(self, ph: int, pw: int, offset: float = 0.1) -> torch.Tensor:
        n = self.pos_embed.shape[1] - 1
        side = int(math.sqrt(n))
        if ph * pw == n and ph == pw:
            return self.pos_embed
        grid = self.pos_embed[:, 1:].reshape(side, side, -1)
        dev = grid.device
        mh = torch.from_numpy(ops.bicubic_scale_matrix(side, ph, (ph + offset) / side)).to(dev)
        mw = torch.from_numpy(ops.bicubic_scale_matrix(side, pw, (pw + offset) / side)).to(dev)
        grid = torch.einsum("qw,pwd->pqd", mw, torch.einsum("ph,hwd->pwd", mh, grid))
        return torch.cat([self.pos_embed[:, :1], grid.reshape(1, ph * pw, -1)], dim=1)

    def forward(self, x, take_layers):
        b, _, h, w = x.shape
        ph, pw = h // self.patch_size, w // self.patch_size
        x = arith.conv(self.patch_embed.proj, x).flatten(2).transpose(1, 2)
        x = torch.cat([self.cls_token.expand(b, -1, -1), x], dim=1) + self.pos_embed_at(ph, pw)
        outputs = []
        for i, blk in enumerate(self.blocks):
            x = blk(x)
            if i in take_layers:
                outputs.append(F.layer_norm(x, x.shape[-1:], self.norm.weight, self.norm.bias, self.norm.eps))
        return [o[:, 1:] for o in outputs]


class ResidualConvUnit(nn.Module):
    def __init__(self, features: int):
        super().__init__()
        self.conv1 = nn.Conv2d(features, features, 3, padding=1)
        self.conv2 = nn.Conv2d(features, features, 3, padding=1)

    def forward(self, x):
        return arith.conv(self.conv2, F.relu(arith.conv(self.conv1, F.relu(x)))) + x


class FeatureFusionBlock(nn.Module):
    def __init__(self, features: int, with_skip: bool = True):
        super().__init__()
        if with_skip:
            self.resConfUnit1 = ResidualConvUnit(features)
        self.resConfUnit2 = ResidualConvUnit(features)
        self.out_conv = nn.Conv2d(features, features, 1)

    def forward(self, x, res=None, size=None):
        if res is not None:
            x = x + self.resConfUnit1(res)
        x = self.resConfUnit2(x)
        if size is None:
            size = (x.shape[2] * 2, x.shape[3] * 2)
        return arith.conv(self.out_conv, ops.resize_bilinear_align_corners(x, tuple(size)))


class _Scratch(nn.Module):
    def __init__(self, features: int, out_channels):
        super().__init__()
        for i, oc in enumerate(out_channels):
            setattr(self, f"layer{i + 1}_rn", nn.Conv2d(oc, features, 3, padding=1, bias=False))
        for i in range(1, 5):
            setattr(self, f"refinenet{i}", FeatureFusionBlock(features, with_skip=i != 4))
        self.output_conv1 = nn.Conv2d(features, features // 2, 3, padding=1)
        self.output_conv2 = nn.Sequential(
            nn.Conv2d(features // 2, 32, 3, padding=1), nn.ReLU(True), nn.Conv2d(32, 1, 1), nn.ReLU(True))


class DPTHead(nn.Module):
    def __init__(self, in_dim: int, features: int, out_channels):
        super().__init__()
        oc = tuple(out_channels)
        self.projects = nn.ModuleList(nn.Conv2d(in_dim, c, 1) for c in oc)
        self.resize_layers = nn.ModuleList([
            nn.ConvTranspose2d(oc[0], oc[0], 4, stride=4), nn.ConvTranspose2d(oc[1], oc[1], 2, stride=2),
            nn.Identity(), nn.Conv2d(oc[3], oc[3], 3, stride=2, padding=1)])
        self.scratch = _Scratch(features, oc)

    def forward(self, feats, ph: int, pw: int):
        outs = []
        for i, tokens in enumerate(feats):
            x = tokens.transpose(1, 2).reshape(tokens.shape[0], tokens.shape[2], ph, pw)
            x = arith.conv(self.projects[i], x)
            outs.append(x if i == 2 else arith.conv(self.resize_layers[i], x))
        s = self.scratch
        l1, l2, l3, l4 = (arith.conv(getattr(s, f"layer{i + 1}_rn"), o) for i, o in enumerate(outs))
        p4 = s.refinenet4(l4, size=l3.shape[2:])
        p3 = s.refinenet3(p4, l3, size=l2.shape[2:])
        p2 = s.refinenet2(p3, l2, size=l1.shape[2:])
        p1 = s.refinenet1(p2, l1)
        out = ops.resize_bilinear_halfpix(arith.conv(s.output_conv1, p1), (ph * 14, pw * 14))
        out = F.relu(arith.conv(s.output_conv2[0], out))
        return F.relu(arith.conv(s.output_conv2[2], out))


class DepthAnythingV2(nn.Module):
    """ImageNet-normalized NCHW image (H, W multiples of 14) -> (B,1,H,W)."""

    def __init__(self, encoder: str = "vitl"):
        super().__init__()
        c = VIT_CONFIGS[encoder]
        self.layers = c["layers"]
        self.pretrained = DinoVisionTransformer(c["embed_dim"], c["depth"], c["num_heads"], c.get("ffn", "mlp"))
        self.depth_head = DPTHead(c["embed_dim"], c["features"], c["out_channels"])

    def forward(self, x):
        ph, pw = x.shape[2] // 14, x.shape[3] // 14
        return self.depth_head(self.pretrained(x, self.layers), ph, pw)


def imagenet_normalize(image01: torch.Tensor) -> torch.Tensor:
    """NCHW [0,1] -> ImageNet-normalized."""
    mean = torch.tensor(IMAGENET_MEAN, device=image01.device, dtype=image01.dtype).view(1, 3, 1, 1)
    std = torch.tensor(IMAGENET_STD, device=image01.device, dtype=image01.dtype).view(1, 3, 1, 1)
    return (image01 - mean) / std


def dav2_input_size(h: int, w: int, size_w: int = 518, size_h: int = 518) -> tuple[int, int]:
    """Keep-aspect 'lower_bound' multiple-of-14 target (h, w)."""
    if h > w:
        size_w, size_h = size_h, size_w
    s = max(size_h / h, size_w / w)

    def constrain(x, min_val):
        y = int(round(x / 14) * 14)
        return int(math.ceil(x / 14) * 14) if y < min_val else y

    return constrain(s * h, size_h), constrain(s * w, size_w)
