"""Operations and bytes that the shapes need, and the card's peaks.

The rooflines divide the least time these give by a measured device time:
the least time of a product is the larger of its FLOPs over the bf16
tensor peak and its bytes over the HBM bandwidth, each input read once
and each output written once.  The model's FLOPs a pair are counted by
running the configuration's plain reference on the meta device under
PyTorch's FLOP counter: every product, convolution and resize contraction
that the shapes need, whatever implements them.
"""
from __future__ import annotations

from pathlib import Path

import torch

from port_bench import reference

# NVIDIA H100 SXM, dense (data sheet): bf16 tensor FLOP/s, HBM bytes/s; at its 700 W limit
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
BF16 = 2  # bytes a value as served


def least_ms(flops: float, moved: float) -> float:
    return max(flops / PEAK_BF16_FLOPS, moved / PEAK_HBM_BYTES) * 1e3


def ln_dense(b: int, t: int, d: int) -> tuple[float, float]:
    """K1, LN1 + QKV: (FLOPs, bytes)."""
    m = b * t
    return 2.0 * m * d * 3 * d, BF16 * (m * d + 2 * d + 3 * d * d + 3 * d + m * 3 * d)


def attention_core(b: int, t: int, heads: int, hd: int) -> tuple[float, float]:
    """K2, softmax(q k^T / sqrt(hd)) v from the fused qkv: (FLOPs, bytes)."""
    d = heads * hd
    return 4.0 * b * heads * t * t * hd, BF16 * (b * t * 3 * d + b * t * d)


def dense_residual(b: int, t: int, d: int) -> tuple[float, float]:
    """K3, proj + LayerScale + residual: (FLOPs, bytes)."""
    m = b * t
    return 2.0 * m * d * d, BF16 * (2 * m * d + d * d + 2 * d + m * d)


def mlp(b: int, t: int, d: int, hidden: int) -> tuple[float, float]:
    """K4, LN2 + fc1 + GELU + fc2: (FLOPs, bytes)."""
    m = b * t
    return 4.0 * m * d * hidden, BF16 * (m * d + 2 * d + 2 * d * hidden + hidden + d + m * d)


def swiglu(b: int, t: int, d: int, hidden: int) -> tuple[float, float]:
    """ViT-G's FFN, LN2 + w12 + SiLU gate + w3: (FLOPs, bytes)."""
    m = b * t
    return 6.0 * m * d * hidden, BF16 * (m * d + 2 * d + 3 * d * hidden + 2 * hidden + d + m * d)


def swiglu_hidden(d: int) -> int:
    return (int(d * 4.0) * 2 // 3 + 7) // 8 * 8


def vit_least_ms(b: int, t: int, d: int, heads: int, depth: int, ffn: str) -> float:
    """The least time of the ViT blocks' work at B views of T tokens: each
    product and the attention core at its own roofline, summed."""
    hd = d // heads
    ffn_cost = swiglu(b, t, d, swiglu_hidden(d)) if ffn == "swiglu" else mlp(b, t, d, 4 * d)
    parts = (ln_dense(b, t, d), attention_core(b, t, heads, hd), dense_residual(b, t, d), ffn_cost)
    return depth * sum(least_ms(f, m) for f, m in parts)


def attention_least_ms(b: int, t: int, d: int, heads: int, depth: int) -> float:
    return depth * least_ms(*attention_core(b, t, heads, d // heads))


def pair_flops(cfg: dict, h: int, w: int, root: Path = reference.REPO) -> float:
    """The configuration's model's FLOPs for one (H, W) pair: its plain
    reference (`reference.build`, the one that decides `correct`) run on
    the meta device under `torch.utils.flop_counter.FlopCounterMode`."""
    from torch.utils.flop_counter import FlopCounterMode

    ref = reference.build(cfg, root)
    with torch.device("meta"):
        view = torch.empty((1, h, w, 3))
    with FlopCounterMode(display=False) as counter:
        ref(view, view)
    return float(counter.get_total_flops())


def tokens(h: int, w: int, mono_size: tuple[int, int] = (518, 518)) -> int:
    """DAv2's tokens a view (with the class token) at (H, W)."""
    from port_bench.reference.dav2 import dav2_input_size

    fh, fw = dav2_input_size(h, w, *mono_size)
    return (fh // 14) * (fw // 14) + 1
