#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result line):
1. build the hand-written kernels from `stereoanywhere_tpu_torch/csrc/`
   (one nvcc per source, in parallel);
   The wgmma + TMA libraries (K2, K4) must show HGMMA and UTMALDG in their
   SASS (`cuobjdump -sass`), counted and printed;
2. kernels: each of K1-K4 at the shapes of the ViT-L 512^2 and 375x1242
   requests (T = 1370 and 4552 tokens a view), in bf16 and f32, against its
   plain PyTorch version on the card (TF32 off), timed with CUDA events
   beside one PyTorch call for the same function where one exists, with
   its TFLOP/s; K2's bound also counts its exponentials against the SFU;
   K2 also on inputs where only the mask of the ragged key tail keeps it
   right; the launch geometry (grid, waves) of K2's and K4's bf16 bodies;
   then the refinement-step kernels (K5 dual lookup, K7 flow head, K8
   motion encoder, K9 ConvGRU at its three scales, and K9 behind the K6
   interface) at the quarter-resolution planes of the same requests, in
   both dtypes, against their plain versions, also on inputs where only
   the zero padding keeps them right, timed beside the port's unfused
   modules for the same function (cuDNN convolutions, the plain lookup);
3. pipelines: DAv2 ViT-L + StereoAnywhere (bf16, 32 GRU iterations,
   seeded random weights) behind `serve_http` on 127.0.0.1, answering two
   512x512 pairs and two 375x1242 pairs, first in the default
   configuration, then with `fused_level0="on"`; each kernel's launches a
   request are asserted (K1-K4 24; K5, K7, K8 31 and K9 93 on the fused
   path, none on the default one); then, per configuration and shape, the
   warm request and its mono and stereo stages timed in interleaved
   rounds, and one request traced with `torch.profiler` for the device's
   busy time, idle share and time by kernel family;
4. whole-model checks in f32: DAv2 ViT-L at 140x140 (backbone tokens and
   depth), the whole pipeline (ViT-S, 64x96) on the card against the CPU
   through the plain versions, in the default and the fused configuration,
   and the fused pipeline against the default one on the card.
It prints a `{"kernels": [...]}` line, the card's name and power limit,
and last `{"ok": true, "device": {...}}`.  It imports nothing of JAX.
"""
from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
import threading
import time
from collections import defaultdict

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

import stereoanywhere_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)
from stereoanywhere_tpu_torch.config import MonoConfig, StereoAnywhereConfig
from stereoanywhere_tpu_torch.models.dpt import INTERMEDIATE_LAYER_IDX, DepthAnythingV2, dav2_input_size
from stereoanywhere_tpu_torch.models.layers import init_weights
from stereoanywhere_tpu_torch.models.update import ConvGRU, FlowHead, MotionEncoder
from stereoanywhere_tpu_torch.ops import step_fused as sf
from stereoanywhere_tpu_torch.ops.cuda import build, corr_lookup, step_fused, vit_attention, vit_dense, vit_mlp
from stereoanywhere_tpu_torch.serve.pipeline import build_pipeline, infer_remote, make_http_server

# H100 SXM peaks (NVIDIA data sheet, dense): FLOP/s by operand type, HBM bytes/s
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12
# max |kernel - plain| allowed, relative to max |plain|: f32 sums are only
# reordered; a bf16 output's rounding is at most 2^-8 of its value (one ulp
# at most 2^-7), and the LN / gelu intermediates are rounded to bf16 on
# both sides
REL_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
VIT_L = dict(d=1024, heads=16, hidden=4096, depth=24)
KITTI = (375, 1242)
# quarter-resolution planes (H4, W4) of the two requests: 512^2, and
# 375x1242 padded to 384x1248, then width-aligned to 1280
STEP_PLANES = {"512x512": (128, 128), "375x1242": (96, 320)}
ITERS = 32


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def bound_ms(flops: float, moved: int, dtype) -> tuple[float, str]:
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], moved / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes")


def exp_rate() -> tuple[float, str]:
    """exp2 a second: the SFU issues 16 a clock on an SM.  SM count and
    clock from the device properties (clock_rate in kHz)."""
    props = torch.cuda.get_device_properties(0)
    clock_hz = getattr(props, "clock_rate", 0) * 1e3
    if not clock_hz:
        raise RuntimeError("the device properties give no clock rate")
    return 16.0 * props.multi_processor_count * clock_hz, (
        f"16 x {props.multi_processor_count} SMs x {clock_hz / 1e6:.0f} MHz")


def attention_bound_ms(flops: float, exps: float, moved: int, dtype) -> tuple[float, str, str]:
    """max(FLOP / tensor peak, exponentials / SFU rate, bytes / HBM rate):
    (ms, "operations" or "bytes", the term that binds)."""
    terms = {"tensor FLOPs": flops / PEAK_FLOPS[dtype], "exp2 on the SFU": exps / exp_rate()[0],
             "bytes": moved / PEAK_BYTES}
    term = max(terms, key=terms.get)
    return terms[term] * 1e3, "bytes" if term == "bytes" else "operations", term


def tokens_of(h: int, w: int) -> int:
    fh, fw = dav2_input_size(h, w)
    return (fh // 14) * (fw // 14) + 1


def kernel_cases(dtype, t: int, g: torch.Generator):
    """(name, wrapper, plain, library call or None, args, flops, output-free input list) at B=2, T=t."""
    d, hd, heads, hidden = VIT_L["d"], VIT_L["d"] // VIT_L["heads"], VIT_L["heads"], VIT_L["hidden"]
    m = 2 * t
    dev = "cuda"

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=g) * scale).to(dev, dtype)

    x = rnd(2, t, d)
    ln_g, ln_b = rnd(d, scale=0.5) + 1, rnd(d, scale=0.1)
    wq, bq = rnd(3 * d, d, scale=d ** -0.5), rnd(3 * d, scale=0.1)
    qkv = rnd(2, t, 3 * d)
    o, wp, bp, gam = rnd(2, t, d), rnd(d, d, scale=d ** -0.5), rnd(d, scale=0.1), rnd(d, scale=0.5)
    w1, b1 = rnd(hidden, d, scale=d ** -0.5), rnd(hidden, scale=0.1)
    w2, b2 = rnd(d, hidden, scale=hidden ** -0.5), rnd(d, scale=0.1)
    q, k, v = (qkv.view(2, t, 3, heads, hd)[:, :, i].transpose(1, 2) for i in range(3))
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v)  # noqa: E731
    return [
        ("ln_dense", vit_dense.ln_dense, vit_dense.ln_dense_ref, None, (x, ln_g, ln_b, wq, bq),
         2.0 * m * d * 3 * d, nbytes(x, ln_g, ln_b, wq, bq) + m * 3 * d * x.element_size(),
         lambda: torch.nn.functional.linear(x, wq, bq)),
        ("vit_attention", vit_attention.vit_attention, vit_attention.vit_attention_ref, sdpa, (qkv, heads),
         4.0 * 2 * heads * t * t * hd, nbytes(qkv) + m * d * qkv.element_size(), None),
        ("dense_scale_residual", vit_dense.dense_scale_residual, vit_dense.dense_scale_residual_ref, None,
         (x, o, wp, bp, gam), 2.0 * m * d * d, nbytes(x, o, wp, bp, gam) + m * d * x.element_size(),
         lambda: torch.nn.functional.linear(o, wp, bp)),
        ("vit_mlp", vit_mlp.vit_mlp, vit_mlp.vit_mlp_ref, None, (x, ln_g, ln_b, w1, b1, w2, b2),
         4.0 * m * d * hidden, nbytes(x, ln_g, ln_b, w1, b1, w2, b2) + m * d * x.element_size(),
         lambda: torch.nn.functional.linear(torch.nn.functional.linear(x, w1, b1), w2, b2)),
    ]


def key_tail_qkv(dtype, t: int, g: torch.Generator) -> torch.Tensor:
    """qkv at B=2 whose real keys all score about -32 against every query
    ((q + 2) . (k - 2) hd^-0.5 over hd = 64).  A key past T, zero-filled in
    its tile, scores 0: unmasked, the ragged tail would take nearly all the
    softmax weight and the output would collapse towards 0."""
    d = VIT_L["d"]
    qkv = torch.randn((2, t, 3 * d), generator=g)
    qkv[..., :d] += 2.0
    qkv[..., d : 2 * d] -= 2.0
    return qkv.to("cuda", dtype)


def check(name: str, got: torch.Tensor, want: torch.Tensor, dtype) -> tuple[float, float]:
    """max |got - want| and max |want|; raises past REL_TOL * max |want|."""
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    if not (scale > 0 and err <= REL_TOL[dtype] * scale and bool(torch.isfinite(got).all())):
        raise AssertionError(f"{name} disagrees with its plain version: {err} (max|plain| {scale})")
    return err, scale


SOURCE = {
    "ln_dense": ("stereoanywhere_tpu_torch/csrc/vit_dense.cu", "stereoanywhere_tpu/ops/pallas/vit_dense.py:68"),
    "vit_attention": ("stereoanywhere_tpu_torch/csrc/vit_attention.cu",
                      "stereoanywhere_tpu/ops/pallas/vit_attention.py:110"),
    "dense_scale_residual": ("stereoanywhere_tpu_torch/csrc/vit_dense.cu",
                             "stereoanywhere_tpu/ops/pallas/vit_dense.py:117"),
    "vit_mlp": ("stereoanywhere_tpu_torch/csrc/vit_mlp.cu", "stereoanywhere_tpu/ops/pallas/vit_mlp.py:100"),
    "dual_lookup": ("stereoanywhere_tpu_torch/csrc/corr_lookup.cu", ", ".join(
        f"stereoanywhere_tpu/ops/pallas/{f}" for f in (
            "corr_kernel.py:96", "corr_tent.py:111", "corr_gather.py:156", "corr_lagged.py:120", "corr_mxu.py:121",
            "corr_barrel.py:210", "corr_barrel.py:256", "step_fused.py:462"))),
    "flow_head": ("stereoanywhere_tpu_torch/csrc/step_fused.cu", "stereoanywhere_tpu/ops/pallas/step_fused.py:505"),
    "motion_encoder": ("stereoanywhere_tpu_torch/csrc/step_fused.cu",
                       "stereoanywhere_tpu/ops/pallas/step_fused.py:646"),
    "conv_gru": ("stereoanywhere_tpu_torch/csrc/step_fused.cu", "stereoanywhere_tpu/ops/pallas/step_fused.py:763, "
                 "stereoanywhere_tpu/ops/pallas/gru_fused.py:203, stereoanywhere_tpu/ops/pallas/gru_fused.py:228"),
}


def sass_counts(paths: dict) -> None:
    """HGMMA (wgmma) and UTMALDG (TMA load) instructions in the SASS of the
    libraries whose bf16 bodies are built on them; each must be there."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    for name in ("vit_attention", "vit_mlp"):
        sass = subprocess.run([cuobjdump, "-sass", str(paths[name])], capture_output=True, text=True,
                              check=True).stdout
        counts = {op: len(re.findall(rf"\b{op}\b", sass)) for op in ("HGMMA", "UTMALDG", "UTMASTG")}
        print(f"sass {name}: " + ", ".join(f"{op} {n}" for op, n in counts.items()), flush=True)
        if not (counts["HGMMA"] and counts["UTMALDG"]):
            raise AssertionError(f"{name}: no wgmma or no TMA load in its SASS: {counts}")


def kernel_phase() -> dict:
    """Check and time K1-K4 against their plain versions.  Returns the
    per-kernel record of the main path's dtype (bf16) at T=1370."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator().manual_seed(0)
    t512, tkitti = tokens_of(512, 512), tokens_of(*KITTI)
    records = {}
    for dtype in (torch.bfloat16, torch.float32):
        for t in (t512, tkitti):
            for name, fn, ref, lib, args, flops, moved, product in kernel_cases(dtype, t, g):
                got = fn(*args)
                torch.cuda.synchronize()
                err, scale = check(f"{name} ({dtype}, T={t})", got, ref(*args), dtype)
                row = dict(
                    ms=cuda_ms(lambda: fn(*args)),
                    plain_ms=cuda_ms(lambda: ref(*args)),
                    library_ms=cuda_ms(lib) if lib is not None else None,
                    cublas_product_ms=cuda_ms(product) if product is not None else None,
                    max_abs_err=err,
                )
                row["bound_ms"], row["bound_by"] = bound_ms(flops, moved, dtype)
                term = row["bound_by"]
                if name == "vit_attention":  # one exponential a score
                    row["bound_ms"], row["bound_by"], term = attention_bound_ms(
                        flops, 2 * VIT_L["heads"] * t * t, moved, dtype)
                row["tflops"] = flops / row["ms"] / 1e9
                print(f"kernel {name} {str(dtype)[6:]} T={t}: max_abs_err {err:.3e} (max|plain| {scale:.3e}, "
                      f"tol {REL_TOL[dtype]:.0e} rel) ms {row['ms']:.4f} ({row['tflops']:.1f} TFLOP/s) "
                      f"plain_ms {row['plain_ms']:.4f} library_ms {row['library_ms']} "
                      f"cublas_product_ms {row['cublas_product_ms']} bound_ms {row['bound_ms']:.4f} ({term})",
                      flush=True)
                if dtype == torch.bfloat16 and t == t512:
                    records[name] = row
            qkv = key_tail_qkv(dtype, t, g)
            got = vit_attention.vit_attention(qkv, VIT_L["heads"])
            torch.cuda.synchronize()
            err, scale = check(f"vit_attention key tail ({dtype}, T={t})", got,
                               vit_attention.vit_attention_ref(qkv, VIT_L["heads"]), dtype)
            print(f"kernel vit_attention {str(dtype)[6:]} T={t} key tail (real keys score about -32): "
                  f"max_abs_err {err:.3e} (max|plain| {scale:.3e}, tol {REL_TOL[dtype]:.0e} rel)", flush=True)
    rate, how = exp_rate()
    print(f"SFU exp2 rate {rate / 1e12:.2f} T/s ({how})", flush=True)
    launch_geometry(t512, tkitti)
    return records


def launch_geometry(*token_counts: int) -> None:
    """Grid and waves of the bf16 wgmma launches at the ViT-L requests (B = 2)."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    d, heads, hidden = VIT_L["d"], VIT_L["heads"], VIT_L["hidden"]
    for t in token_counts:
        a = vit_attention.launch_geometry(2, t, heads, d // heads)
        blocks = a["grid"][0] * a["grid"][1] * a["grid"][2]
        print(f"geometry vit_attention T={t}: grid {a['grid']} = {blocks} blocks of {a['threads']} threads, "
              f"{a['smem']} B shared, {a['blocks_per_sm']} resident an SM: "
              f"{blocks / (sms * a['blocks_per_sm']):.2f} waves on {sms} SMs", flush=True)
        m = vit_mlp.launch_geometry(2 * t, d, hidden)
        for i, p in enumerate(m["products"], 1):
            print(f"geometry vit_mlp T={t} product {i}: 128x{p['bn']} tiles, {p['tiles']} of them on a persistent "
                  f"grid of {p['blocks']} blocks ({m['threads']} threads, {p['smem']} B shared, one an SM): "
                  f"{p['tiles'] / sms:.2f} waves of tiles; LN pass {m['ln_blocks']} blocks of {m['ln_threads']}",
                  flush=True)


# ---------------------------------------------------------------------------
# the refinement-step kernels


def _border(x: torch.Tensor, value: float) -> torch.Tensor:
    """x (B,H,W,C) with its first and last rows and columns set to value:
    a conv that read anything but zeros past the plane's edge would be off
    by about value times its weights there."""
    x = x.clone()
    x[:, [0, -1]] = value
    x[:, :, [0, -1]] = value
    return x


def _window_bytes(coords: torch.Tensor, wls, radius: int, itemsize: int) -> int:
    """Bytes of both pyramids' levels the lookup must read for these
    coordinates: the entries of [floor(c / 2^l) - r, floor(c / 2^l) + r + 1]
    inside [0, Wl - 1], at every level."""
    total = 0
    for lvl, wl in enumerate(wls):
        x0 = torch.floor(coords / 2 ** lvl) - radius
        total += int((x0 + 2 * radius + 2).clamp(0, wl).sub(x0.clamp(0, wl)).sum().item())
    return 2 * total * itemsize


def step_cases(dtype, h4: int, w4: int, g: torch.Generator, border: bool):
    """(name, wrapper, plain, args, flops, bytes moved, operand dtype of the
    flops, the unfused module's call or None) at one quarter-res plane, B=1.
    border: inputs where only the zero padding keeps the result right."""
    dev = "cuda"
    m4 = h4 * w4

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=g) * scale).to(dev, dtype)

    def module(mod, seed):
        init_weights(mod, torch.Generator().manual_seed(seed))
        return mod.to(dev, dtype)

    def nchw(x):
        return x.permute(0, 3, 1, 2).contiguous()

    xs = torch.arange(w4, dtype=torch.float32, device=dev)
    es = torch.finfo(dtype).bits // 8
    cases = []

    # K5: both pyramids (widths W4 / 2^l) at coords x - disparity; border:
    # coordinates far outside every level
    wls = [w4 // 2 ** i for i in range(4)]
    la, lb = [rnd(1, h4, w4, wl) for wl in wls], [rnd(1, h4, w4, wl) for wl in wls]
    if border:
        c = (torch.randn((1, h4, w4), generator=g) * 3 * w4).to(dev)
        c[0, 0, :4] = torch.tensor([-1e4, 1e4, -0.5, w4 - 0.5])
    else:
        c = xs - (torch.randn((1, h4, w4), generator=g).abs() * w4 / 8).to(dev)
    moved = _window_bytes(c, wls, 4, es) + nbytes(c) + 2 * m4 * 36 * es
    cases.append(("dual_lookup", corr_lookup.dual_lookup, corr_lookup.dual_lookup_ref, (la, lb, c, 4),
                  2 * m4 * 4 * 9 * 4.0, moved, torch.float32, None))

    # K7: flow head + coords (small coords, so the output is the delta)
    fh = module(FlowHead(128, 256, 2), 11)
    hw = sf.pack_head_weights(fh.conv1, fh.conv2, dtype)
    h = rnd(1, h4, w4, 128)
    if border:
        h = _border(h, 30.0)
    c7 = (torch.randn((1, h4, w4), generator=g) * 0.1).to(dev)
    h_n, c7_n = nchw(h), c7[:, None]
    cases.append(("flow_head", step_fused.flow_head, sf.flow_head_ref, (h, c7, hw),
                  2.0 * m4 * 9 * 256 * (128 + 1), nbytes(h, c7, c7, *hw), dtype,
                  lambda: c7_n + fh.forward_x(h_n).float()))

    # K8: motion encoder on the two lookups' outputs and flow-x
    enc = module(MotionEncoder(36), 12)
    mw = sf.pack_motion_weights(enc, dtype)
    ca, cb = rnd(1, h4, w4, 36), rnd(1, h4, w4, 36)
    c8 = xs + (torch.randn((1, h4, w4), generator=g) * 2).to(dev)
    if border:
        ca, cb = _border(ca, 30.0), _border(cb, 30.0)
        c8[:, [0, -1]] += 25.0
        c8[:, :, [0, -1]] -= 25.0
    flow = torch.stack([c8 - xs, torch.zeros_like(c8)], dim=1).to(dtype)
    ca_n, cb_n = nchw(ca), nchw(cb)
    flops8 = 2.0 * m4 * (2 * 36 * 64 + 49 * 64 + 9 * 3 * 64 * 64 + 9 * 192 * 126)
    cases.append(("motion_encoder", step_fused.motion_encoder, sf.motion_encoder_ref, (ca, cb, c8, mw), flops8,
                  nbytes(ca, cb, c8, *mw) + m4 * 128 * es, dtype, lambda: enc(flow, ca_n, cb_n)))

    # K9 at its three scales (gru08, gru16: two x streams; gru32: one).  The
    # f32 gate sums run over 3456 terms, and their rounding in two summation
    # orders reaches 1e-5 of the output with x of unit scale: x at half
    # scale, and border values of 4 (at 8 the border case read 0.97 of the
    # limit), keep it at about half the limit
    for name, scale, nx in (("conv_gru/08", 1, 2), ("conv_gru/16", 2, 2), ("conv_gru/32", 4, 1)):
        gru = module(ConvGRU(128, 128 * nx), 13 + scale)
        gw = sf.pack_gru_weights(gru, dtype)
        hh, ww = h4 // scale, w4 // scale
        hg, xg = torch.tanh(rnd(1, hh, ww, 128)), [rnd(1, hh, ww, 128, scale=0.5) for _ in range(nx)]
        if border:
            hg, xg = _border(hg, 4.0), [_border(x, 4.0) for x in xg]
        czrq = rnd(1, hh, ww, 384, scale=0.3)
        hg_n, xg_n = nchw(hg), [nchw(x) for x in xg]
        inj_n = [nchw(czrq[..., i * 128:(i + 1) * 128]) for i in range(3)]
        cases.append((name, step_fused.conv_gru, sf.conv_gru_ref, (hg, xg, czrq, gw),
                      2.0 * hh * ww * 9 * (1 + nx) * 128 * 384, nbytes(hg, *xg, czrq, hg, *gw), dtype,
                      lambda gru=gru, hg_n=hg_n, inj_n=inj_n, xg_n=xg_n: gru(hg_n, *inj_n, *xg_n)))

    # the K6 interface (one 256-channel x stream, HWIO kernels) on the K9 kernel
    gru = module(ConvGRU(128, 256), 20)
    hwio = lambda w: w.permute(2, 3, 1, 0).contiguous()  # noqa: E731
    wts = (hwio(torch.cat([gru.convz.weight, gru.convr.weight])), torch.cat([gru.convz.bias, gru.convr.bias]),
           hwio(gru.convq.weight), gru.convq.bias)
    h6, x6 = torch.tanh(rnd(1, h4, w4, 128)), rnd(1, h4, w4, 256, scale=0.5)
    if border:
        h6, x6 = _border(h6, 4.0), _border(x6, 4.0)
    inj6 = [rnd(1, h4, w4, 128, scale=0.3) for _ in range(3)]
    h6_n, x6_n, inj6_n = nchw(h6), nchw(x6), [nchw(t) for t in inj6]
    cases.append(("gru_fused (K6 interface)", step_fused.gru_fused, step_fused.gru_fused_ref,
                  (h6, x6, *inj6, *wts), 2.0 * m4 * 9 * 384 * 384, nbytes(h6, x6, *inj6, h6, *wts), dtype,
                  lambda: gru(h6_n, *inj6_n, x6_n)))
    return cases


def step_kernel_phase() -> dict:
    """Check and time K5, K7, K8 and K9 (and the K6 interface) against
    their plain versions and the unfused modules.  Returns the records of
    the main path's dtype (bf16) at 512^2; conv_gru's is the sum of its
    three scales, as one iteration runs each once."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator().manual_seed(1)
    records = {}
    for dtype in (torch.bfloat16, torch.float32):
        for plane, (h4, w4) in STEP_PLANES.items():
            for border in (False, True):
                for name, fn, ref, args, flops, moved, op_dtype, unfused in step_cases(dtype, h4, w4, g, border):
                    got = fn(*args)
                    torch.cuda.synchronize()
                    want = ref(*args)
                    pairs = zip(got, want) if isinstance(got, tuple) else [(got, want)]
                    err, scale = map(max, zip(*[check(f"{name} ({dtype}, {plane}, border={border})", a, b, dtype)
                                               for a, b in pairs]))
                    what = f"kernel {name} {str(dtype)[6:]} {plane}"
                    if border:
                        print(f"{what} border case: max_abs_err {err:.3e} (max|plain| {scale:.3e}, "
                              f"tol {REL_TOL[dtype]:.0e} rel)", flush=True)
                        continue
                    row = dict(ms=cuda_ms(lambda: fn(*args)), plain_ms=cuda_ms(lambda: ref(*args)),
                               unfused_ms=cuda_ms(unfused) if unfused is not None else None,
                               library_ms=None, max_abs_err=err)
                    if row["unfused_ms"] is None:  # the unfused path's lookup is the plain version
                        row["unfused_ms"] = row["plain_ms"]
                    row["bound_ms"], row["bound_by"] = bound_ms(flops, moved, op_dtype)
                    print(f"{what}: max_abs_err {err:.3e} (max|plain| {scale:.3e}, tol {REL_TOL[dtype]:.0e} rel) "
                          f"ms {row['ms']:.4f} plain_ms {row['plain_ms']:.4f} unfused_ms {row['unfused_ms']:.4f} "
                          f"bound_ms {row['bound_ms']:.4f} ({row['bound_by']}; {flops / 1e9:.3f} GFLOP, "
                          f"{moved / 1e6:.2f} MB)", flush=True)
                    if dtype == torch.bfloat16 and plane == "512x512":
                        key = name.split("/")[0]
                        if key in records:  # conv_gru: sum the scales
                            prev = records[key]
                            for k in ("ms", "plain_ms", "unfused_ms", "bound_ms"):
                                prev[k] += row[k]
                            prev["max_abs_err"] = max(prev["max_abs_err"], err)
                        else:
                            records[key] = row
    records.pop("gru_fused (K6 interface)")
    return records


COUNTERS = {
    "ln_dense": vit_dense.ln_dense,
    "vit_attention": vit_attention.vit_attention,
    "dense_scale_residual": vit_dense.dense_scale_residual,
    "vit_mlp": vit_mlp.vit_mlp,
    "dual_lookup": corr_lookup.dual_lookup,
    "flow_head": step_fused.flow_head,
    "motion_encoder": step_fused.motion_encoder,
    "conv_gru": step_fused.conv_gru,
}
# launches a request: the ViT's kernels once a block; on the fused path the
# step kernels once a rotated body (K9 at three scales), ITERS - 1 bodies
VIT_LAUNCHES = {n: VIT_L["depth"] for n in ("ln_dense", "vit_attention", "dense_scale_residual", "vit_mlp")}
EXPECTED = {
    "default": {n: VIT_LAUNCHES.get(n, 0) for n in COUNTERS},
    "fused": {**{n: VIT_LAUNCHES.get(n, 0) for n in COUNTERS}, "dual_lookup": ITERS - 1, "flow_head": ITERS - 1,
              "motion_encoder": ITERS - 1, "conv_gru": 3 * (ITERS - 1)},
}


class _Recorder:
    """Pipeline wrapper that keeps each request's float disparity and the
    kernel launches it made."""

    def __init__(self, pipeline):
        self.pipeline, self.outputs, self.launches, self.seconds = pipeline, [], [], []

    def __call__(self, im2, im3):
        before = {n: f.launches for n, f in COUNTERS.items()}
        t0 = time.perf_counter()
        out = self.pipeline(im2, im3)
        torch.cuda.synchronize()
        self.seconds.append(time.perf_counter() - t0)
        self.launches.append({n: f.launches - before[n] for n, f in COUNTERS.items()})
        self.outputs.append(out.cpu())
        return out


SPLIT_ROUNDS = 10
# kernel name -> family, first match wins
FAMILIES = (
    ("ViT K1-K4", r"gemm_kernel_bf16|gemm_kernel_f32|attn_kernel|wgmma_gemm_kernel|ln_rows_kernel"),
    ("step K5/K7-K9", r"conv_kernel_|dual_lookup_kernel|flow_delta_kernel|motion_c1f1_kernel"),
    ("convolution", r"conv|cudnn|implicit|winograd|fprop|dgrad|nhwc|nchw"),
    ("matmul", r"gemm|cutlass|cublas|sm90_xmma|ampere_"),
    ("reduction / softmax", r"reduce|softmax|norm"),
    ("copy / layout", r"copy|cat|transpose|permute|pad"),
    ("elementwise", r"elementwise|vectorized|unrolled|pointwise"),
)


def sync_ms(fn) -> float:
    """Host-clock time of fn() ending in a device synchronize."""
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0)


def busy_us(intervals: list[tuple[float, float]]) -> float:
    """Length of the union of the intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def split_and_trace(pipe, label: str, h: int, w: int, im2, im3) -> None:
    """The warm request and its two stages alone, timed in interleaved
    rounds so that drift of the shared host hits all three alike; then one
    traced request: the device's busy time (union of its kernels'
    intervals), its idle share of the untraced median, and time by family."""
    # the requests ran on the server's thread; the first call on this one
    # is timed apart, as it may repeat cuDNN's per-thread algorithm search
    first = sync_ms(lambda: pipe(im2, im3))
    mde2, mde3 = pipe.mono_depth(im2, im3)
    times = {"pipeline": [], "mono stage": [], "stereo stage": []}
    for _ in range(SPLIT_ROUNDS):
        times["pipeline"].append(sync_ms(lambda: pipe(im2, im3)))
        times["mono stage"].append(sync_ms(lambda: pipe.mono_depth(im2, im3)))
        times["stereo stage"].append(sync_ms(lambda: pipe(im2, im3, mde2, mde3)))
    print(f"split {label} {h}x{w}, ms, first call on this thread {first:.1f}; median [min-max] of {SPLIT_ROUNDS} "
          "interleaved rounds after it: " + "; ".join(f"{k} {np.median(v):.1f} [{min(v):.1f}-{max(v):.1f}]" for k, v in times.items()), flush=True)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        traced = sync_ms(lambda: pipe(im2, im3))
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        print(f"trace {label} {h}x{w}: device busy time not measured (the profiler saw no device events)", flush=True)
        return
    busy = busy_us([(e.time_range.start, e.time_range.end) for e in kernels]) / 1e3
    wall = float(np.median(times["pipeline"]))
    # launches of each stage alone
    stage_kernels = {}
    for stage, fn in (("mono", lambda: pipe.mono_depth(im2, im3)), ("stereo", lambda: pipe(im2, im3, mde2, mde3))):
        with profile(activities=[ProfilerActivity.CUDA]) as p:
            sync_ms(fn)
        stage_kernels[stage] = sum(1 for e in p.events() if e.device_type == DeviceType.CUDA)
    print(f"trace {label} {h}x{w}: device busy {busy:.1f} ms, idle share {1 - busy / wall:.3f} of the untraced "
          f"median {wall:.1f} ms (traced wall {traced:.1f} ms); {len(kernels)} kernels (alone: mono stage "
          f"{stage_kernels['mono']}, stereo stage {stage_kernels['stereo']})", flush=True)
    counts = defaultdict(int)
    for e in kernels:
        counts[re.sub(r"[<(].*", "", e.name.replace("(anonymous namespace)::", ""))[-48:]] += 1
    top = sorted(counts.items(), key=lambda kv: -kv[1])[:14]
    print("  launches by kernel: " + ", ".join(f"{n} {c}" for n, c in top), flush=True)
    by_family = defaultdict(float)
    for e in kernels:
        fam = next((f for f, pat in FAMILIES if re.search(pat, e.name, re.IGNORECASE)), "other")
        by_family[fam] += (e.time_range.end - e.time_range.start) / 1e3
    print("  device ms by family: " +", ".join(f"{f} {ms:.2f}" for f, ms in
                                                 sorted(by_family.items(), key=lambda kv: -kv[1])), flush=True)


def pipeline_phase(label: str, cfg: StereoAnywhereConfig) -> dict:
    """Serve the full-width pipeline over HTTP, then split a warm request
    into its mono and stereo stages.  Returns launches per kernel over the
    served requests, counted from 0 just before them."""
    torch.backends.cudnn.benchmark = True
    t0 = time.perf_counter()
    pipe = build_pipeline(cfg, MonoConfig.for_encoder("vitl"), iters=ITERS, device="cuda", seed=0)
    print(f"pipeline {label} built in {time.perf_counter() - t0:.1f} s (ViT-L + StereoAnywhere, bf16, iters {ITERS}, "
          f"{cfg})", flush=True)
    rec = _Recorder(pipe)
    server = make_http_server(rec, "127.0.0.1", 0)
    url = f"http://127.0.0.1:{server.server_address[1]}"
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    rng = np.random.default_rng(0)
    # the first request of a shape includes cuDNN's algorithm search
    shapes = [(512, 512), (512, 512), KITTI, KITTI]
    images = {}
    for f in COUNTERS.values():
        f.launches = 0
    try:
        for h, w in shapes:
            im2, im3 = (rng.uniform(0, 1, (h, w, 3)).astype(np.float32) for _ in range(2))
            images[(h, w)] = (im2[None], im3[None])
            t0 = time.perf_counter()
            disp = infer_remote(url, im2, im3)
            print(f"request {label} {h}x{w}: {1e3 * (time.perf_counter() - t0):.1f} ms end to end "
                  f"({1e3 * rec.seconds[-1]:.1f} ms in the pipeline), launches {rec.launches[-1]}", flush=True)
            out = rec.outputs[-1]
            if disp.shape != (h, w) or tuple(out.shape) != (1, h, w, 1) or not torch.isfinite(out).all():
                raise AssertionError(f"bad disparity for {h}x{w}: {tuple(out.shape)}, finite={bool(torch.isfinite(out).all())}")
            print(f"  disparity range [{out.min().item():.3f}, {out.max().item():.3f}] px", flush=True)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    totals = {n: f.launches for n, f in COUNTERS.items()}
    for n, want in EXPECTED[label].items():
        per = [launch[n] for launch in rec.launches]
        if per != [want] * len(shapes):
            raise AssertionError(f"{label}: {n} launched {per} times per request, expected {want} each")

    for (h, w), (im2, im3) in images.items():
        split_and_trace(pipe, label, h, w, im2, im3)
    return totals


def compare_phase() -> None:
    """f32 on the card (kernels, TF32 off) against the CPU (plain versions)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    cfg = MonoConfig.for_encoder("vitl")
    cpu = DepthAnythingV2(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
    gpu = DepthAnythingV2(cfg, device="cuda", generator=torch.Generator().manual_seed(4))
    gpu.load_state_dict(cpu.state_dict())
    x = torch.from_numpy(np.random.default_rng(1).normal(0, 1, (2, 140, 140, 3)).astype(np.float32))
    layers = INTERMEDIATE_LAYER_IDX["vitl"]
    with torch.no_grad():
        # the taken layers' tokens: the output of the four kernels, 24 blocks deep
        want = torch.cat([t for t, _ in cpu.pretrained(x.permute(0, 3, 1, 2), layers)])
        got = torch.cat([t for t, _ in gpu.pretrained(x.cuda().permute(0, 3, 1, 2), layers)]).cpu()
    err, scale = (got - want).abs().max().item(), want.abs().max().item()
    print(f"DAv2 ViT-L 140x140 f32 backbone tokens, card vs CPU: max_abs_err {err:.3e} (max|cpu| {scale:.3e})",
          flush=True)
    if not (scale > 0 and err <= 1e-4 * scale):
        raise AssertionError(f"the ViT-L backbone on the card disagrees with the CPU: {err} (scale {scale})")
    # a random head's final ReLU can clamp the whole depth map to zero, which
    # would make the comparison empty: compare the head before it
    for m in (cpu, gpu):
        m.depth_head.scratch.output_conv2[3] = torch.nn.Identity()
    want, got = cpu(x), gpu(x.cuda()).cpu()
    err, scale = (got - want).abs().max().item(), want.abs().max().item()
    print(f"DAv2 ViT-L 140x140 f32 depth before the last ReLU, card vs CPU: max_abs_err {err:.3e} "
          f"(max|cpu| {scale:.3e})", flush=True)
    if not (scale > 0 and err <= 1e-4 * scale):
        raise AssertionError(f"DAv2 ViT-L on the card disagrees with the CPU: {err} (scale {scale})")

    # the whole pipeline, default and fused (H4 16, W4 24: the fused gate
    # holds); pixel tolerance 1e-2 plus 1e-4 of the disparity's magnitude
    rng = np.random.default_rng(2)
    im2, im3 = (rng.uniform(0, 1, (1, 64, 96, 3)).astype(np.float32) for _ in range(2))
    on_card = {}
    for label, cfg in (("default", StereoAnywhereConfig()), ("fused", StereoAnywhereConfig(fused_level0="on"))):
        kw = dict(stereo_cfg=cfg, mono_cfg=MonoConfig.for_encoder("vits"), iters=4, mono_size=(56, 56), seed=5)
        pc, pg = build_pipeline(device="cpu", **kw), build_pipeline(device="cuda", **kw)
        want = pc(im2, im3)
        before = step_fused.flow_head.launches
        on_card[label] = got = pg(im2, im3).cpu()
        if label == "fused" and step_fused.flow_head.launches - before != 3:
            raise AssertionError("the fused pipeline did not run its rotated bodies through the kernels")
        err, scale = (got - want).abs().max().item(), want.abs().max().item()
        print(f"pipeline {label} ViT-S 64x96 f32 iters 4, card vs CPU: max_abs_err {err:.3e} px "
              f"(max|cpu| {scale:.3e})", flush=True)
        if not err <= 1e-2 + 1e-4 * scale:
            raise AssertionError(f"{label} pipeline on the card disagrees with the CPU: {err}")
    err = (on_card["fused"] - on_card["default"]).abs().max().item()
    scale = on_card["default"].abs().max().item()
    print(f"pipeline ViT-S 64x96 f32 iters 4, fused vs default on the card: max_abs_err {err:.3e} px "
          f"(max|default| {scale:.3e})", flush=True)
    if not err <= 1e-2 + 1e-4 * scale:
        raise AssertionError(f"the fused pipeline disagrees with the default one on the card: {err}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    card = card_line()
    print(f"card: {card}", flush=True)
    t0 = time.perf_counter()
    paths = build.build()
    print(f"kernels built in {time.perf_counter() - t0:.1f} s: {sorted(p.name for p in paths.values())}", flush=True)
    for p in paths.values():
        log = p.with_suffix(".log")
        # the compiler's resource report: registers, shared memory, spills, serialized wgmma
        for line in log.read_text().splitlines() if log.exists() else []:
            if ("Compiling entry" in line or "Used" in line or "Performance Loss" in line
                    or ("spill" in line and " 0 bytes spill stores" not in line)):
                print(f"  {p.stem}: {line.strip()}", flush=True)
    sass_counts(paths)
    records = {**kernel_phase(), **step_kernel_phase()}
    launches = pipeline_phase("default", StereoAnywhereConfig(compute_dtype="bfloat16"))
    torch.cuda.empty_cache()
    fused = pipeline_phase("fused", StereoAnywhereConfig(compute_dtype="bfloat16", fused_level0="on"))
    compare_phase()
    kernels = []
    for name, row in records.items():
        src, replaces = SOURCE[name]
        # each kernel's launches on the path that runs it
        n = launches[name] if name in VIT_LAUNCHES else fused[name]
        kernels.append(dict(name=name, route="cuda", source=src, replaces=replaces, launches=n,
                            max_abs_err=row["max_abs_err"], ms=row["ms"], plain_ms=row["plain_ms"],
                            bound_ms=row["bound_ms"], bound_by=row["bound_by"], library_ms=row["library_ms"],
                            unfused_ms=row.get("unfused_ms")))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
