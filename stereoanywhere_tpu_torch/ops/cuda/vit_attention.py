"""K2 `vit_attention`: multi-head softmax attention read straight from the
fused QKV projection.

    qkv (B, T, 3D), columns [q heads | k heads | v heads]  ->  o (B, T, D)
    o[:, :, h] = softmax(q_h k_h^T * hd^-0.5) v_h, heads concatenated.

Replaces the Pallas TPU kernel `stereoanywhere_tpu/ops/pallas/vit_attention.py`
`vit_attention` (`_attn_kernel`).  Source: `csrc/vit_attention.cu`.

Bound on the H100 at the ViT-L 512^2 request (B=2, T=1370, H=16, hd=64):
15.4 GFLOP of QK^T and PV against 22 MB of qkv read and 5.6 MB written, so
the products bound it.  The TPU kernel held a whole (BQ, T) score row in
VMEM; on Hopper a block has at most 227 KB of shared memory, so this is
flash-style: each block owns 64 query rows of one (batch, head), streams
64-row K/V tiles through shared memory and keeps an online softmax (running
max and sum) in registers, so the (T, T) scores never reach device memory.
q, k and v are read from the (B, T, 3D) layout by stride and the output is
written in (B, T, D) directly; the ragged T tail (1370, 4552 are no tile
multiple) is masked to -inf on the keys and left unwritten on the queries.
In bf16 (the deployed type) QK^T and PV run on the tensor cores through
`mma.sync` m16n8k16 (4 warps of 16 query rows, FlashAttention-2 style: K/V
tiles stream in with cp.async two stages deep, scores, P and the running
output stay in registers); in f32 they run as FP32 FMA tiles.  `wgmma`/TMA
and warp specialisation are later work.
"""
from __future__ import annotations

import torch

from stereoanywhere_tpu_torch.ops.cuda.build import bind, check_operands, check_status, current_stream

_LIB = "vit_attention"


def vit_attention_ref(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Plain version of K2 in f32, output in qkv's dtype."""
    b, t, three_d = qkv.shape
    d = three_d // 3
    hd = d // num_heads
    q, k, v = qkv.float().view(b, t, 3, num_heads, hd).permute(2, 0, 3, 1, 4)  # (B,H,T,hd) each
    s = (q @ k.transpose(-1, -2)) * (hd ** -0.5)
    o = torch.softmax(s, dim=-1) @ v
    return o.transpose(1, 2).reshape(b, t, d).to(qkv.dtype)


def vit_attention(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Attention over a fused-QKV tensor (B, T, 3D) -> (B, T, D); hd 64 or 128."""
    if qkv.device.type == "cpu":
        return vit_attention_ref(qkv, num_heads)
    code = check_operands("vit_attention", qkv)
    b, t, three_d = qkv.shape
    d = three_d // 3
    hd = d // num_heads
    if three_d != 3 * d or d != num_heads * hd or hd not in (64, 128):
        raise ValueError(f"vit_attention: qkv {tuple(qkv.shape)} with {num_heads} heads (hd must be 64 or 128)")
    out = torch.empty((b, t, d), device=qkv.device, dtype=qkv.dtype)
    fn = bind(_LIB, "sa_vit_attention", 2, 5)
    status = fn(qkv.data_ptr(), out.data_ptr(), b, t, num_heads, hd, code, current_stream())
    check_status(_LIB, "vit_attention", status)
    vit_attention.launches += 1
    return out


vit_attention.launches = 0
