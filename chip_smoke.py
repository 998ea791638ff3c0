#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result line):
1. build the hand-written kernels from `stereoanywhere_tpu_torch/csrc/`
   (one nvcc per source, in parallel);
2. kernels: each of K1-K4 at the shapes of the ViT-L 512^2 and 375x1242
   requests (T = 1370 and 4552 tokens a view), in bf16 and f32, against its
   plain PyTorch version on the card (TF32 off), timed with CUDA events
   beside one PyTorch call for the same function where one exists; K2 also
   on inputs where only the mask of the ragged key tail keeps it right;
3. pipeline: DAv2 ViT-L + StereoAnywhere (default config, bf16, 32 GRU
   iterations, seeded random weights) behind `serve_http` on 127.0.0.1,
   answering two 512x512 pairs and two 375x1242 pairs; each kernel must run
   24 times per request; then, per shape, the warm request and its mono and
   stereo stages timed in interleaved rounds, and one request traced with
   `torch.profiler` for the device's busy time, idle share and time by
   kernel family;
4. whole-model checks in f32: DAv2 ViT-L at 140x140 (backbone tokens and
   depth), and the whole pipeline (ViT-S, 64x96) on the card against the
   CPU through the plain versions.
It prints a `{"kernels": [...]}` line, the card's name and power limit,
and last `{"ok": true, "device": {...}}`.  It imports nothing of JAX.
"""
from __future__ import annotations

import json
import re
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
from stereoanywhere_tpu_torch.ops.cuda import build, vit_attention, vit_dense, vit_mlp
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
}


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
                print(f"kernel {name} {str(dtype)[6:]} T={t}: max_abs_err {err:.3e} (max|plain| {scale:.3e}, "
                      f"tol {REL_TOL[dtype]:.0e} rel) ms {row['ms']:.4f} plain_ms {row['plain_ms']:.4f} "
                      f"library_ms {row['library_ms']} cublas_product_ms {row['cublas_product_ms']} "
                      f"bound_ms {row['bound_ms']:.4f} ({row['bound_by']})", flush=True)
                if dtype == torch.bfloat16 and t == t512:
                    records[name] = row
            qkv = key_tail_qkv(dtype, t, g)
            got = vit_attention.vit_attention(qkv, VIT_L["heads"])
            torch.cuda.synchronize()
            err, scale = check(f"vit_attention key tail ({dtype}, T={t})", got,
                               vit_attention.vit_attention_ref(qkv, VIT_L["heads"]), dtype)
            print(f"kernel vit_attention {str(dtype)[6:]} T={t} key tail (real keys score about -32): "
                  f"max_abs_err {err:.3e} (max|plain| {scale:.3e}, tol {REL_TOL[dtype]:.0e} rel)", flush=True)
    return records


COUNTERS = {
    "ln_dense": vit_dense.ln_dense,
    "vit_attention": vit_attention.vit_attention,
    "dense_scale_residual": vit_dense.dense_scale_residual,
    "vit_mlp": vit_mlp.vit_mlp,
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
    ("ViT K1-K4", r"gemm_kernel_bf16|gemm_kernel_f32|attn_kernel"),
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


def split_and_trace(pipe, h: int, w: int, im2, im3) -> None:
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
    print(f"split {h}x{w}, ms, first call on this thread {first:.1f}; median [min-max] of {SPLIT_ROUNDS} "
          "interleaved rounds after it: " + "; ".join(f"{k} {np.median(v):.1f} [{min(v):.1f}-{max(v):.1f}]" for k, v in times.items()), flush=True)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        traced = sync_ms(lambda: pipe(im2, im3))
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        print(f"trace {h}x{w}: device busy time not measured (the profiler saw no device events)", flush=True)
        return
    busy = busy_us([(e.time_range.start, e.time_range.end) for e in kernels]) / 1e3
    wall = float(np.median(times["pipeline"]))
    print(f"trace {h}x{w}: device busy {busy:.1f} ms, idle share {1 - busy / wall:.3f} of the untraced "
          f"median {wall:.1f} ms (traced wall {traced:.1f} ms); {len(kernels)} kernels", flush=True)
    by_family = defaultdict(float)
    for e in kernels:
        fam = next((f for f, pat in FAMILIES if re.search(pat, e.name, re.IGNORECASE)), "other")
        by_family[fam] += (e.time_range.end - e.time_range.start) / 1e3
    print("  device ms by family: " +", ".join(f"{f} {ms:.2f}" for f, ms in
                                                 sorted(by_family.items(), key=lambda kv: -kv[1])), flush=True)


def pipeline_phase() -> dict:
    """Serve the full-width pipeline over HTTP, then split a warm request
    into its mono and stereo stages.  Returns launches per kernel over the
    served requests."""
    torch.backends.cudnn.benchmark = True
    cfg = StereoAnywhereConfig(compute_dtype="bfloat16")
    t0 = time.perf_counter()
    pipe = build_pipeline(cfg, MonoConfig.for_encoder("vitl"), iters=32, device="cuda", seed=0)
    print(f"pipeline built in {time.perf_counter() - t0:.1f} s (ViT-L + StereoAnywhere, bf16, iters 32)", flush=True)
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
            print(f"request {h}x{w}: {1e3 * (time.perf_counter() - t0):.1f} ms end to end "
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
    for n in COUNTERS:
        per = [launch[n] for launch in rec.launches]
        if per != [VIT_L["depth"]] * len(shapes):
            raise AssertionError(f"{n} launched {per} times per request, expected {VIT_L['depth']} each")

    for (h, w), (im2, im3) in images.items():
        split_and_trace(pipe, h, w, im2, im3)
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

    kw = dict(stereo_cfg=StereoAnywhereConfig(), mono_cfg=MonoConfig.for_encoder("vits"), iters=4,
              mono_size=(56, 56), seed=5)
    pc, pg = build_pipeline(device="cpu", **kw), build_pipeline(device="cuda", **kw)
    rng = np.random.default_rng(2)
    im2, im3 = (rng.uniform(0, 1, (1, 64, 96, 3)).astype(np.float32) for _ in range(2))
    want = pc(im2, im3)
    got = pg(im2, im3).cpu()
    err, scale = (got - want).abs().max().item(), want.abs().max().item()
    print(f"pipeline ViT-S 64x96 f32 iters 4, card vs CPU: max_abs_err {err:.3e} px (max|cpu| {scale:.3e})",
          flush=True)
    if not err <= 1e-2 + 1e-4 * scale:
        raise AssertionError(f"pipeline on the card disagrees with the CPU: {err}")


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
        # the compiler's resource report: registers, shared memory, spills
        for line in log.read_text().splitlines() if log.exists() else []:
            if "Compiling entry" in line or "Used" in line or ("spill" in line and " 0 bytes spill stores" not in line):
                print(f"  {p.stem}: {line.strip()}", flush=True)
    records = kernel_phase()
    launches = pipeline_phase()
    compare_phase()
    kernels = []
    for name, row in records.items():
        src, replaces = SOURCE[name]
        kernels.append(dict(name=name, route="cuda", source=src, replaces=replaces, launches=launches[name],
                            max_abs_err=row["max_abs_err"], ms=row["ms"], plain_ms=row["plain_ms"],
                            bound_ms=row["bound_ms"], bound_by=row["bound_by"], library_ms=row["library_ms"]))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
