"""K2 `vit_attention`: multi-head softmax attention read straight from the
fused QKV projection.

    qkv (B, T, 3D), columns [q heads | k heads | v heads]  ->  o (B, T, D)
    o[:, :, h] = softmax(q_h k_h^T * hd^-0.5) v_h, heads concatenated.

Replaces the Pallas TPU kernel `stereoanywhere_tpu/ops/pallas/vit_attention.py`
`vit_attention` (`_attn_kernel`).  Source: `csrc/vit_attention.cu`.

Bound on the H100 at the ViT-L 512^2 request (B=2, T=1370, H=16, hd=64):
15.4 GFLOP of QK^T and PV against 22 MB of qkv read and 5.6 MB written,
and 60 M exponentials, one a score.  At hd 64 a score costs 4 hd = 256
tensor-core FLOPs and one `ex2` on the SFU, which issues 16 a clock on an
SM: the exponentials need about as much time as the products (0.014 against
0.0155 ms here, 0.16 against 0.17 ms at T = 4552), so a kernel that runs
softmax and products one after the other cannot get under about twice the
tensor bound.

The TPU kernel held a whole (BQ, T) score row in VMEM; on Hopper a block
has at most 227 KB of shared memory, so this is flash-style: each block
owns the query rows of one (batch, head), streams K/V tiles through shared
memory and keeps an online softmax (running max and sum) in registers, so
the (T, T) scores never reach device memory.  q, k and v are read from the
(B, T, 3D) layout and the output is written in (B, T, D) directly; the
ragged T tail (1370, 4552 are no tile multiple) is masked to -inf on the
keys and left unwritten on the queries.

Two bodies, picked by dtype:
- bf16 (the deployed type), FlashAttention-3 shape: 128 query rows a block
  in two consumer warpgroups; a producer warpgroup (its registers given to
  the consumers with `setmaxnreg`) keeps 128-key K/V tiles coming by TMA
  (one 3-D tensor map over qkv, 128-byte swizzle) into a ring of mbarrier-
  guarded stages; S = Q K^T and O += P V are `wgmma`, P fed from registers;
  the two warpgroups take turns at the tensor cores through named barriers,
  so one's softmax runs under the other's products, and within a
  warpgroup tile j's softmax runs under tile j-1's PV product;
- f32 (the check type): FP32 FMA tiles of 64 query rows.
"""
from __future__ import annotations

import ctypes

import torch

from stereoanywhere_tpu_torch.ops.cuda.build import bind, check_operands, check_status, current_stream, library

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


def launch_geometry(b: int, t: int, num_heads: int, hd: int) -> dict:
    """The bf16 body's launch at these shapes, as the library computes it:
    grid, threads, dynamic shared memory and resident blocks an SM."""
    lib = library(_LIB)
    fn = lib.sa_vit_attention_geometry
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 6)()
    check_status(_LIB, "vit_attention geometry", fn(b, t, num_heads, hd, out))
    return dict(grid=tuple(out[:3]), threads=out[3], smem=out[4], blocks_per_sm=out[5])
