#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py                # the smoke run below
    python3 chip_smoke.py --tiles        # K9's, K8's and K7's tile candidates, each forced, timed
    python3 chip_smoke.py --ab OTHER     # K1, K3, K7, K8 and K9 of this checkout and OTHER, in turns
    python3 chip_smoke.py --rowshard-cards  # row sharding over NCCL, one card a rank (2 or 4 cards)
    python3 chip_smoke.py --spans OTHER  # the benchmark's cells on this checkout and OTHER: the port's spans

Phases of the smoke run (any failure exits non-zero before the result line):
1. build the hand-written kernels from `stereoanywhere_tpu_torch/csrc/`
   (one nvcc per source, in parallel);
   The wgmma + TMA libraries (K1 and K3's `vit_dense`, K2, K4, and the
   step kernels' `step_fused` for K8 and K9) must show HGMMA and UTMALDG in
   their SASS (`cuobjdump -sass`), counted and printed;
2. kernels: each of K1-K4 at the shapes of the ViT-L 512^2 and 375x1242
   requests (T = 1370 and 4552 tokens a view) and of the eval's largest
   (T = 8141), in bf16 and f32, against its
   plain PyTorch version on the card (TF32 off), timed beside one PyTorch
   call for the same function where one exists, with its TFLOP/s (every
   `ms` is CUDA-event time over 20 calls back to back; beside a kernel's
   are its `device_ms`, from torch.profiler, the union of the device's
   kernel intervals over 20 such calls, which leaves out the gaps while
   the host prepares the next call, and its `host_ms`, the host's least
   time to issue a call); K2's bound also counts its exponentials against the SFU;
   K2 also on inputs where only the mask of the ragged key tail keeps it
   right; the launch geometry (grid, waves) of K1's to K4's bf16 bodies;
   then the refinement-step kernels (K5 dual lookup, K7 flow head, K8
   motion encoder, K9 ConvGRU at its three scales, and K9 behind the K6
   interface) at the quarter-resolution planes of the same requests, in
   both dtypes, against their plain versions, also on inputs where only
   the zero padding keeps them right (K5: coordinates far outside every
   level, and level rows whose stride is no multiple of 16 bytes, B = 2,
   an odd pixel count; held to 0, bit for bit), timed beside the port's
   unfused modules for the same function (cuDNN convolutions; for K5 the
   plain gather, which the port no longer runs on the card), K5 with its
   sector-granular bound beside the window's;
   K9's time, TFLOP/s and bound per scale and plane; K8's device time by
   launch (c1/f1, the grouped 3x3 stage, the merge conv); the launch
   geometry (tile, pixel patch, grid) of K9 per scale and plane and of K8's
   two 3x3 stages per plane; then K10, the fused hourglass, at the KITTI
   (8x320x96x320) and OAK-D (8x160x104x160) volumes of a bf16 model with
   TF32 on: against the modules (cuDNN) in bf16 units, each of its 15
   launches against its plain version, timed beside the modules with its
   bound from its launches' operations and bytes;
3. CUDA graphs: the runtime and driver versions; K1-K4 and the step
   kernels captured in one graph, its edges by type (the launchers'
   programmatic launches should capture as programmatic edges) and its
   replay against the eager calls, held to 0;
4. pipelines: DAv2 ViT-L + StereoAnywhere (bf16, 32 GRU iterations,
   seeded random weights) behind `serve_http` on 127.0.0.1 on its CUDA
   graphs, answering two 512x512 pairs and two 375x1242 pairs (the first
   of a shape runs eagerly and captures, the second replays), first in the
   default configuration, then with `fused_level0="on"`; the kernel
   wrappers' calls are asserted (twice a forward's on a shape's first
   request: the warm-up and the capture; none on a replay), and each
   capture's time and the graph pool printed; then per configuration and
   shape the replay against an eager call held to max |delta| = 0: (1) on
   the served images, (2) on other images, (3) the first result intact
   after the second request; the warm graph request, the warm eager
   request and the eager mono and stereo stages timed in interleaved
   rounds; one replayed request traced with `torch.profiler` (busy time,
   idle share, launches, and each kernel's launches read from its kernels'
   names: K1-K4 24 and K5 32 in both configurations; K7, K8 31 and K9 93
   on the fused path, none on the default one); one eager request traced
   (the same, time by kernel family, aten::conv3d's device time and device
   time by module: the model's parts wrapped in `record_function` ranges
   for that request only, which a replay would not show: DAv2's ViT and
   DPT head, the extractors, the volumes, the hourglass and classifiers,
   the refinement loop and, inside it, its pool/interp glue); (4) the
   two-stage graphs against eager two-stage, with the graph pools of one
   graph and of the two-stage pair at each shape; (5) after every
   parameter is loaded anew, and (6) after the device constants' cache
   has evicted every constant the graphs read, replay against eager again;
   K10's launches in one eager request (every hourglass call fused, 15
   launches each) and in the traced replay and eager request;
5. whole-model checks: DAv2 ViT-L at 140x140 in f32 (backbone tokens and
   depth), the whole pipeline (ViT-S, 64x96) on the card against the CPU
   through the plain versions, in the default and the fused configuration,
   in f32 and in bf16 (eagerly: the card's graphs are held to its eager
   path above), and the fused pipeline against the default one on the card
   in f32;
6. the zero-shot evaluation path: `cli eval` as a user runs it, at ViT-L
   (random weights written as a `.pth` and read through
   `--mono-checkpoint`) and the default stereo widths, bf16, 32 GRU
   iterations, `--tries 2` and `--csv`, over a synthetic Middlebury
   directory (3 scenes: two stereo buckets, three mono shapes, T up to
   8141) and a synthetic KITTI 2015 one (4 pairs: one bucket, four mono
   shapes), each written from a seed into a temporary directory.  Each
   dataset runs four times in turns: eagerly (the process's first visit of
   these shapes, the reference), on its graphs (a program captures at its
   key's second call; the kernel wrappers' calls counted from 0 over this
   run and asserted: K1-K4 24 and K5 32 a body run, two body runs a key),
   eagerly again, and with every key captured at its first call; every
   program output of the later runs is held to the first's (max |delta| =
   0) and so are the metrics.  Printed: per-sample wall ms of the
   first visit and the repeat, pairs a second over the second try, the
   stereo buckets and mono shapes with their T and capture ms, the pool,
   and one more visit of a sample on the warm graphs traced (device busy,
   idle share, host ms of decode, resize and normalise, programs,
   metrics).  Then `cli eval` on the card (f32, TF32 off, ViT-S, 4
   iterations, one scene at 96x160) against the CPU: avgerr and rms within
   1e-3 relative, disparity within 1e-2 px + 1e-4 relative or twice the
   CPU's own move under one rounding of its stereo inputs, the larger.  The kernel
   phase holds K1-K4 at the eval's largest T too.
7. DAv2 ViT-G (40 blocks, D 1536, 24 heads of 64, the SwiGLU FFN in
   PyTorch): K1-K3 at its widths and T = 1370, 4552 in bf16 and f32
   against their plain versions, timed beside the cuBLAS product and SDPA
   with their bounds and launch geometry (after phase 2's kernels); the
   ViT-G pipeline (random weights drawn on the card, bf16, 32 iterations)
   served over HTTP on its graphs like phase 4's (two 512^2 and two
   375x1242 pairs; wrapper calls K1-K3 40 a forward, K4 0, K5 32; replay
   = eager; the split, one traced replay and eager request, the pool and
   the device memory peak), without the two-stage and reload checks;
   ViT-G at depth 40 in f32 on the card against a CPU copy (after phase
   5's checks);
8. high-resolution inference (after phase 7's comparison, before phase
   6's eval): ViT-L and the default stereo widths in bf16, 32 iterations,
   cuDNN's heuristics, TF32 off.  At 1024^2 the stereo branch over
   `tools/profile_highres.py`'s paths: direct (the pipeline's stereo
   stage), tiles2 and tiles4 (sequential row tiles, overlap 64), tiles2
   batched, and voldown (`vol_downsample=1`), each on its CUDA graph and
   eagerly: replay = eager (0), the first call and capture, the eager
   request's memory peak, the graph pool, K5's launches in a replay's
   trace (asserted), the warm request in interleaved rounds, printed
   beside the reference's published 0.61 s / 6.31 GB on an A100;
   batched vs sequential tiles within 1e-3 px at 128x64 (f32, 2
   iterations, as JAX's own test), and at 1024^2 in f32 with the same
   weights, within 1e-3 px at 1 iteration and within 10x the move of
   one ulp of the left view at 1, 2 and 4 (the gaps at 1, 2, 4, 8 and 32
   iterations printed, bf16 and f32), one tile against the direct path within
   1e-3 px + 5e-5 rel.; one eager request with the mono stage and 2
   tiles (wrapper calls counted from 0 and asserted: K1-K4 24, K5 64).
   Then Booster's 3008x4112: a synthetic pair through the mono
   stage at Booster's DAv2 size (T = 3997), joint min-max, pad, the
   booster preset's 8 sequential tiles of 544 rows, the stitch and unpad,
   eagerly (wrapper calls asserted: K1-K4 24, K5 256; stage latencies,
   memory peak) and with the tiles on their graph (capture, pool, replay
   held to the eager result, K5 in a replay's trace), and what `select_tiling_parameters` picks from the free
   memory; `vol_downsample=1` card vs CPU (f32, 64x128, 2 iterations, 1e-3
   px + 5e-5 rel.).  The kernel phases also hold K1-K4 at Booster's T =
   3997 and K5 at a Booster tile's plane (136 x 1040, B = 1 and 2, bit for
   bit, timed);
9. training (after phase 6): a synthetic FlyingThings-layout directory
   (8 pairs at 540x960) and a Middlebury one get their mono depth from
   `cli precompute-mono` (ViT-L), then `cli train` at the reference
   configuration (f32, crop 320x640, batch 2, 12 iterations, fnet frozen,
   gt-as-mono and corruption 0.3) for 20 steps with validation on 2
   samples every 10 and `latest` every 10, then `--resume latest` to step
   24: losses finite, fnet unchanged and the other groups moved, no
   kernel wrapper in a train step and K5 32 a validation sample, the
   step counter continued, `best` written; s/step, pairs/s, the memory
   peak and one traced step (busy, idle, device ms by phase); then one
   train step at 64x128 on the card against the CPU (loss, every
   gradient, every parameter after the step);
10. training over processes, in mixed precision and with batch
   statistics (after phase 9, on its data): `cli train` at the reference
   configuration for 4 steps as one process and as rank 0 of a world of 1
   over NCCL (`--multihost` under torchrun's environment), in a process of
   its own in PyTorch's deterministic mode, equal bit for bit in every log
   and every parameter; then 8 steps of each twice, in turns, timed; two ranks on the one
   card over gloo with CUDA tensors (spawned; NCCL refuses two ranks on
   one device) against one process on the whole batch, 2 steps at 64x128,
   2 iterations, f32, the noise corruption and gt-as-mono forced, within
   phase 9's card-vs-CPU bounds; `cli train --dtype bfloat16` at the
   reference configuration for 10 steps with a validation at step 10
   (K5), s/step, pairs/s, the memory peak and one traced step, the masters
   f32; one bf16 step on the card against the CPU's within twice the
   CPU's own bf16-vs-f32 gap; 5 steps with `freeze_bn=False` at the
   reference configuration beside 5 with `freeze_bn=True` on the same
   batches, s/step, every running statistic moved;
11. row-sharded inference (after phase 8): the stereo branch at 1024^2
   with its rows split over ranks (`parallel/spatial.py`), seeded random
   weights: in f32 (TF32 off) at 1 iteration, a mesh of one rank over NCCL
   (world size 1) against the direct forward bit for bit, and 2 and 4
   ranks over gloo on cuda:0 (spawned; NCCL refuses two ranks on one
   device) within twice the direct forward's move under one rounding of
   its inputs; then in bf16 at 32 iterations on 2 and 4 ranks, each rank's
   memory peak above what was resident beside the direct path's (measured
   in the same call, and PERF.md's earlier figure), ms a request (gloo
   staged through the host: a correctness run, not a speed), K5's calls on
   each rank (asserted: 32), the bytes each rank hands to the halo exchanges and band
   fetches, the gathers and the all-reduces a forward beside
   ARCHITECTURE.md's estimate; and one request of the pipeline with the
   ViT-L mono stage and `mesh=` (wrapper calls asserted on every rank:
   K1-K4 24, K5 32); then the fused loop (`fused_level0="on"`, its K7, K8
   and K9 launches on bands of rows) on the same ranks: f32 at 2
   iterations against the fused direct forward within twice its
   one-rounding move, bf16 at 32 iterations with each rank's memory peak,
   bytes a forward, ms a request and wrapper calls (asserted: K5 32, K7 and
   K8 31, K9 93 a rank), beside the fused direct forward's peak and ms.
   One card runs every rank: no scaling over cards is measured;
12. the live capture loop of `cli camera` at the OAK-D's 400P (after phase
   6): K1-K4 at the camera's T = 2184 (bf16, B = 2) and K5 at its 104 x 160
   plane (bf16 and f32, bit for bit) against their plain versions; 24
   synthetic 640x400 grey-as-RGB PNG pairs replayed by `DirectorySource`
   through `CaptureLoop` on the ViT-L pipeline (default configuration,
   bf16, 32 iterations, random weights read from a reference `.tar` and
   `.pth`, PyTorch's defaults as the CLI runs them) on its CUDA graph: the
   loop's fps, the warm frame's ms, the capture, the wrapper calls a frame
   (asserted: twice a forward's on the first, none after; one eager frame
   K1-K4 24, K5 32), one traced warm frame (device busy, idle share, the
   host's ms by part, launches from the trace asserted); the same loop
   through `infer_remote` against `make_http_server` (every remote
   disparity within the protocol's quantisation of the local one); `cli
   camera` on 8 frames with `--clip-top 8` from the `.tar` and from the
   `.msgpack` that `cli convert` writes of it (8 PNGs of 392x640 each, the
   disparities equal bit for bit); `chained_timer` of the 512^2 request
   beside its `cuda_ms`.  The native library (`native/stereodata.cc`) is
   built with g++ after the kernels, and the decoders each path takes are
   printed (the eval phase's traced sample too);
13. the variants no shipped model uses: the aggregation variant
   (`use_aggregate_stereo_vol=True`, `n_additional_hourglass=2`; ViT-L,
   default widths, bf16, 32 iterations) served like phase 4's pipelines
   after the ViT-G one (two 512^2 and two 375x1242 pairs on its graphs;
   wrapper calls K1-K4 24 and K5 32, its lookups reading the aggregated
   stereo volume's pyramid; replay = eager; the split, one traced replay
   and eager request, the stereo hourglasses in the module ranges), without
   the two-stage and reload checks; then, after phase 7's comparison, the
   variant's ViT-S pipeline card vs CPU (f32 and bf16) and its coarse
   outputs, and the standalone modules card vs CPU in f32:
   `DeformableConv2d`, the MobileNet extractors `Feature` and `FeatureV4`,
   `MultiUpdateScalerBlock`, `sgm_disparity` (bit for bit), the
   scale/shift estimators, `upflow` and the Zadeh combinators.  Every phase
   prints its wall seconds (`phase <name>: <s> s`).
It prints a `{"kernels": [...]}` line (with each kernel's wrapper calls on
the eval path, `eval_launches`, in the ViT-G pipeline's served requests,
`vitg_launches`, in the train steps, `train_launches`, in the
trainer's validations (f32 and bf16), `validation_launches`, in the 1024^2 request with
the mono stage and 2 tiles, `highres_launches`, in the Booster
request, `booster_launches`, and in the row-sharded pipeline request on
rank 0 of 2, `rowshard_launches`, and in one eager camera frame,
`camera_launches`, in the aggregation variant's served requests,
`variant_launches`, and its replayed request, `variant_replay_launches`,
and in the fused row-sharded stereo request on rank 0 of 2,
`rowshard_fused_launches`; K1-K3 also their ViT-G
rows, `vitg_*`), the card's name and power limit, and last
`{"ok": true, "device": {...}}`.  It imports nothing of JAX.

--tiles: K9's bf16 body at each scale of both planes with each of its five
tile candidates forced on both launches, K8's with each candidate its
grouped stage or its merge conv may take forced on that stage, and K7's
with each candidate forced on conv1 (diagnostic entry points of the
library), checked against the plain version and timed in device ms,
launch by launch: the readings `pick_plan`'s cost model is fitted to.

--ab OTHER: K1's, K3's, K7's, K8's and K9's bf16 bodies (and K9 behind the
K6 interface) of this checkout and of OTHER, another checkout of the
repository (for instance an earlier commit unpacked with `git archive
<commit> | tar -x -C build/other`), on the inputs above.  Each checkout
runs in a process of its own, in the order OTHER, this, this, OTHER, so
that drift of the card hits both alike; a run builds its checkout's
`vit_dense` and `step_fused` and prints, a kernel and shape, CUDA-event
ms, device ms and host ms (K8 also its device ms by launch).

--rowshard-cards: row-sharded inference over NCCL, one card a rank, on 2
and, where 4 cards are visible, 4 cards (one card refuses it): K5 at each
rank's plane bit for bit; at 1024^2 phase 11's checks and numbers with the
ranks on cards of their own (f32 at 1 iteration within twice the direct
forward's one-rounding move, bf16 at 32 iterations: memory a rank, bytes a
forward, ms a request over NCCL, K5 32 a rank, the pipeline request);
`cli infer --shard-rows N` (each in a process of its own, f32, TF32 off, 1
iteration) against `--shard-rows 1` within twice the one-process
pipeline's one-rounding move; Booster's full 3008x4112 through the
pipeline with the mono stage over the most cards (memory a rank, ms,
wrapper calls; a rank out of memory is printed, not failed).
"""
from __future__ import annotations

import argparse
import bisect
import ctypes
import functools
import gc
import glob
import io
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
from collections import defaultdict
from contextlib import contextmanager, redirect_stdout
from pathlib import Path

import numpy as np
import torch
from PIL import Image
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

import stereoanywhere_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)
from stereoanywhere_tpu_torch import cli
from stereoanywhere_tpu_torch import device as port_device
from stereoanywhere_tpu_torch import native as port_native
from stereoanywhere_tpu_torch.config import MonoConfig, StereoAnywhereConfig
from stereoanywhere_tpu_torch.data.frame_utils import write_pfm
from stereoanywhere_tpu_torch.eval import harness
from stereoanywhere_tpu_torch.eval import programs as eval_programs
from stereoanywhere_tpu_torch.models import stereoanywhere as sa_model
from stereoanywhere_tpu_torch.models import update as sa_update
from stereoanywhere_tpu_torch.models.dpt import INTERMEDIATE_LAYER_IDX, DepthAnythingV2, dav2_input_size
from stereoanywhere_tpu_torch.models.layers import conv_in_dtype, init_weights
from stereoanywhere_tpu_torch.models.stereoanywhere import StereoAnywhere
from stereoanywhere_tpu_torch.models.update import ConvGRU, FlowHead, MotionEncoder
from stereoanywhere_tpu_torch.ops import step_fused as sf
from stereoanywhere_tpu_torch.ops.interp import resize_jax_image
from stereoanywhere_tpu_torch.ops.cuda import build, corr_lookup, step_fused, vit_attention, vit_dense, vit_mlp
from stereoanywhere_tpu_torch.parallel.presets import get_preset_for_dataset, select_tiling_parameters
from stereoanywhere_tpu_torch.parallel.tiles import TileParallelInference, plan_row_tiles
from stereoanywhere_tpu_torch.serve import camera as port_camera
from stereoanywhere_tpu_torch.serve.client import infer_remote
from stereoanywhere_tpu_torch.serve.pipeline import StereoAnywherePipeline, build_pipeline, make_http_server
from stereoanywhere_tpu_torch.utils.profiling import chained_timer

# H100 SXM peaks (NVIDIA data sheet, dense): FLOP/s by operand type, HBM bytes/s
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12
# max |kernel - plain| allowed, relative to max |plain|: f32 sums are only
# reordered; a bf16 output's rounding is at most 2^-8 of its value (one ulp
# at most 2^-7), and the LN / gelu intermediates are rounded to bf16 on
# both sides
REL_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
# kernels held tighter: K5 computes each tap with the plain gather's f32
# operations in the same order and rounds to bf16 where it rounds, so the
# two agree bit for bit
KERNEL_TOL = {"dual_lookup": 0.0}
VIT_L = dict(d=1024, heads=16, hidden=4096, depth=24)
VIT_G = dict(d=1536, heads=24, hidden=None, depth=40)  # hidden None: the SwiGLU FFN runs in PyTorch, not K4
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


def host_ms(fn, iters: int = 20, rounds: int = 5) -> float:
    """Host time to issue one call of fn: the least over `rounds` rounds of
    `iters` calls back to back, not waiting for the device (its launch
    queue holds them), so that the shared host's interruptions drop out."""
    best = float("inf")
    for _ in range(rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        best = min(best, time.perf_counter() - t0)
    torch.cuda.synchronize()
    return best * 1e3 / iters


def device_profile(fn, iters: int = 20, warmup: int = 3) -> tuple[float, dict] | None:
    """Device time a call of fn, from torch.profiler over `iters` calls
    back to back: the busy time (union of the device's kernel intervals,
    so the gaps while the host prepares the next call do not count) and
    each kernel name's summed duration, both in ms over iters.  None if no
    try of six saw a whole trace: the profiler now and then returns no
    device events, or drops some (a call launches the same kernels each
    time, so their count must be a multiple of iters)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    seen = []
    for _ in range(6):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        if events and len(events) % iters == 0:
            break
        seen.append(len(events))
    else:
        print(f"  device_profile: no whole trace in 6 tries (device events a try: {seen}, {iters} calls)", flush=True)
        return None
    if seen:
        print(f"  device_profile: a whole trace at try {len(seen) + 1} (the earlier kept {seen} events)", flush=True)
    by_name = defaultdict(float)
    for e in events:
        by_name[e.name] += (e.time_range.end - e.time_range.start) / 1e3 / iters
    return busy_us([(e.time_range.start, e.time_range.end) for e in events]) / 1e3 / iters, dict(by_name)


def graph_ms(fn) -> float:
    """fn captured in a CUDA graph after a warm-up call, ms a replay (CUDA
    events over replays back to back): the device's time for the call with
    no host gap inside it, where the profiler may return no whole trace."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    ms = cuda_ms(graph.replay)
    del graph
    torch.cuda.empty_cache()
    return ms


def device_ms(fn) -> float | None:
    """device_profile's busy time; None where the profiler saw nothing."""
    got = device_profile(fn)
    return None if got is None else got[0]


def fmt(ms: float | None, flops: float | None = None, none: str = "not measured") -> str:
    """ms to 4 places, with its TFLOP/s when flops is given; `none` for
    None."""
    if ms is None:
        return none
    return f"{ms:.4f}" + (f" ({flops / ms / 1e9:.1f} TFLOP/s)" if flops else "")


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


def tokens_of(h: int, w: int, size: tuple[int, int] = (518, 518)) -> int:
    """DAv2's tokens a view at (h, w) for the DAv2 size (width, height)."""
    fh, fw = dav2_input_size(h, w, *size)
    return (fh // 14) * (fw // 14) + 1


def kernel_cases(dtype, t: int, g: torch.Generator, vit: dict = VIT_L):
    """(name, wrapper, plain, library call or None, args, flops, bytes moved, the cuBLAS product or None) at
    B=2, T=t and the widths of `vit`; K4 only where the model has it (ViT-G's FFN is SwiGLU, in PyTorch)."""
    d, hd, heads, hidden = vit["d"], vit["d"] // vit["heads"], vit["heads"], vit["hidden"]
    m = 2 * t
    dev = "cuda"

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=g) * scale).to(dev, dtype)

    x = rnd(2, t, d)
    ln_g, ln_b = rnd(d, scale=0.5) + 1, rnd(d, scale=0.1)
    wq, bq = rnd(3 * d, d, scale=d ** -0.5), rnd(3 * d, scale=0.1)
    qkv = rnd(2, t, 3 * d)
    o, wp, bp, gam = rnd(2, t, d), rnd(d, d, scale=d ** -0.5), rnd(d, scale=0.1), rnd(d, scale=0.5)
    q, k, v = (qkv.view(2, t, 3, heads, hd)[:, :, i].transpose(1, 2) for i in range(3))
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v)  # noqa: E731
    cases = [
        ("ln_dense", vit_dense.ln_dense, vit_dense.ln_dense_ref, None, (x, ln_g, ln_b, wq, bq),
         2.0 * m * d * 3 * d, nbytes(x, ln_g, ln_b, wq, bq) + m * 3 * d * x.element_size(),
         lambda: torch.nn.functional.linear(x, wq, bq)),
        ("vit_attention", vit_attention.vit_attention, vit_attention.vit_attention_ref, sdpa, (qkv, heads),
         4.0 * 2 * heads * t * t * hd, nbytes(qkv) + m * d * qkv.element_size(), None),
        ("dense_scale_residual", vit_dense.dense_scale_residual, vit_dense.dense_scale_residual_ref, None,
         (x, o, wp, bp, gam), 2.0 * m * d * d, nbytes(x, o, wp, bp, gam) + m * d * x.element_size(),
         lambda: torch.nn.functional.linear(o, wp, bp)),
    ]
    if hidden:
        w1, b1 = rnd(hidden, d, scale=d ** -0.5), rnd(hidden, scale=0.1)
        w2, b2 = rnd(d, hidden, scale=hidden ** -0.5), rnd(d, scale=0.1)
        cases.append(("vit_mlp", vit_mlp.vit_mlp, vit_mlp.vit_mlp_ref, None, (x, ln_g, ln_b, w1, b1, w2, b2),
                      4.0 * m * d * hidden, nbytes(x, ln_g, ln_b, w1, b1, w2, b2) + m * d * x.element_size(),
                      lambda: torch.nn.functional.linear(torch.nn.functional.linear(x, w1, b1), w2, b2)))
    return cases


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


def check(name: str, got: torch.Tensor, want: torch.Tensor, dtype, tol: float | None = None) -> tuple[float, float]:
    """max |got - want| and max |want|; raises past tol * max |want| (by
    default REL_TOL of the dtype)."""
    tol = REL_TOL[dtype] if tol is None else tol
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    if not (scale > 0 and err <= tol * scale and bool(torch.isfinite(got).all())):
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
    "hourglass3d": ("stereoanywhere_tpu_torch/csrc/hourglass3d.cu",
                    "none: the JAX package leaves the hourglass to XLA's convolutions"),
}


def sass_counts(paths: dict) -> None:
    """HGMMA (wgmma) and UTMALDG (TMA load) instructions in the SASS of the
    libraries whose bf16 bodies are built on them; each must be there."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    for name in ("vit_dense", "vit_attention", "vit_mlp", "step_fused"):
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
    # the eval's largest: Middlebury's scenes at its DAv2 size
    teval = max(tokens_of(h, w, harness.DAV2_SIZES["middlebury"]) for h, w in EVAL_SCENES["middlebury"])
    # Booster's 3008 x 4112 at its DAv2 size (1036, 756): 54 x 74 patches and the class token
    tbooster = tokens_of(*BOOSTER, harness.DAV2_SIZES["booster"])
    records = {}
    for dtype in (torch.bfloat16, torch.float32):
        for t in (t512, tkitti, teval, tbooster):
            rows = vit_kernel_rows(dtype, t, g, VIT_L)
            if dtype == torch.bfloat16 and t == t512:
                records = rows
            qkv = key_tail_qkv(dtype, t, g)
            got = vit_attention.vit_attention(qkv, VIT_L["heads"])
            torch.cuda.synchronize()
            err, scale = check(f"vit_attention key tail ({dtype}, T={t})", got,
                               vit_attention.vit_attention_ref(qkv, VIT_L["heads"]), dtype)
            print(f"kernel vit_attention {str(dtype)[6:]} T={t} key tail (real keys score about -32): "
                  f"max_abs_err {err:.3e} (max|plain| {scale:.3e}, tol {REL_TOL[dtype]:.0e} rel)", flush=True)
    rate, how = exp_rate()
    print(f"SFU exp2 rate {rate / 1e12:.2f} T/s ({how})", flush=True)
    launch_geometry(t512, tkitti, teval, tbooster)
    return records


def vit_kernel_rows(dtype, t: int, g: torch.Generator, vit: dict, label: str = "") -> dict:
    """Each ViT kernel of `vit`'s widths at B = 2, T = t: held against its
    plain version, timed (CUDA events, device, host) beside the plain
    version, the library call and the cuBLAS product, with its bound.
    Returns the rows by kernel name."""
    rows = {}
    for name, fn, ref, lib, args, flops, moved, product in kernel_cases(dtype, t, g, vit):
        got = fn(*args)
        torch.cuda.synchronize()
        err, scale = check(f"{label}{name} ({dtype}, T={t})", got, ref(*args), dtype)
        row = dict(
            ms=cuda_ms(lambda: fn(*args)),
            device_ms=device_ms(lambda: fn(*args)),
            host_ms=host_ms(lambda: fn(*args)),
            plain_ms=cuda_ms(lambda: ref(*args)),
            library_ms=cuda_ms(lib) if lib is not None else None,
            cublas_product_ms=cuda_ms(product) if product is not None else None,
            max_abs_err=err,
        )
        row["bound_ms"], row["bound_by"] = bound_ms(flops, moved, dtype)
        term = row["bound_by"]
        if name == "vit_attention":  # one exponential a score
            row["bound_ms"], row["bound_by"], term = attention_bound_ms(flops, 2 * vit["heads"] * t * t, moved, dtype)
        print(f"kernel {label}{name} {str(dtype)[6:]} T={t}: max_abs_err {err:.3e} (max|plain| {scale:.3e}, "
              f"tol {REL_TOL[dtype]:.0e} rel) ms {fmt(row['ms'], flops)} device_ms "
              f"{fmt(row['device_ms'], flops)} host_ms {row['host_ms']:.4f} "
              f"plain_ms {row['plain_ms']:.4f} library_ms {fmt(row['library_ms'], none='none')} "
              f"cublas_product_ms {fmt(row['cublas_product_ms'], none='none')} bound_ms {row['bound_ms']:.4f} ({term})",
              flush=True)
        rows[name] = row
    return rows


def launch_geometry(*token_counts: int, vit: dict = VIT_L, label: str = "") -> None:
    """Grid and waves of the bf16 wgmma launches at the requests' token counts (B = 2) and `vit`'s widths."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    d, heads, hidden = vit["d"], vit["heads"], vit["hidden"]
    for t in token_counts:
        a = vit_attention.launch_geometry(2, t, heads, d // heads)
        blocks = a["grid"][0] * a["grid"][1] * a["grid"][2]
        print(f"geometry {label}vit_attention T={t}: grid {a['grid']} = {blocks} blocks of {a['threads']} threads, "
              f"{a['smem']} B shared, {a['blocks_per_sm']} resident an SM: "
              f"{blocks / (sms * a['blocks_per_sm']):.2f} waves on {sms} SMs", flush=True)
        k1 = vit_dense.launch_geometry(2 * t, 3 * d)
        print(f"geometry {label}ln_dense T={t}: 128x{k1['bn']} tiles, {k1['tiles']} of them on a persistent grid of "
              f"{k1['blocks']} blocks ({k1['threads']} threads, {k1['smem']} B shared, one an SM): "
              f"{k1['tiles'] / sms:.2f} waves of tiles; LN pass {k1['ln_blocks']} blocks of {k1['ln_threads']}",
              flush=True)
        k3 = vit_dense.residual_geometry(2 * t, d)
        print(f"geometry {label}dense_scale_residual T={t}: 128x{k3['bn']} tiles, {k3['tiles']} of them on a persistent "
              f"grid of {k3['blocks']} blocks ({k3['threads']} threads, {k3['smem']} B shared, one an SM): "
              f"{k3['tiles'] / sms:.2f} waves of tiles", flush=True)
        if not hidden:
            continue
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


def _window_sector_bytes(coords: torch.Tensor, wls, radius: int, itemsize: int) -> int:
    """The same windows counted in the card's 32-byte sectors: each sector
    of a level that holds an entry of some window, once (a 20-byte bf16
    window spans one or two)."""
    total = 0
    rows = torch.arange(coords.numel(), device=coords.device, dtype=torch.int64)
    for lvl, wl in enumerate(wls):
        x0 = (torch.floor(coords.reshape(-1) / 2 ** lvl) - radius).clamp(-2 * radius - 2, wl).long()
        inside = (x0 + 2 * radius + 1 >= 0) & (x0 <= wl - 1)
        row, x0 = rows[inside] * wl, x0[inside]
        s0 = (row + x0.clamp(0, wl - 1)) * itemsize // 32
        s1 = (row + (x0 + 2 * radius + 1).clamp(0, wl - 1)) * itemsize // 32
        span = int((s1 - s0).max().item()) + 1 if s0.numel() else 0
        ids = torch.cat([torch.where(s0 + k <= s1, s0 + k, s0) for k in range(span)]) if span else s0
        total += int(ids.unique().numel())
    return 2 * total * 32


def lookup_host_split(pyr, c: torch.Tensor, r: int) -> dict:
    """The host's least time (ms) for the parts of a K5 call: the output's
    allocation, the launch (the stream query, ctypes and
    cudaLaunchKernelEx) and the split into the two pyramids' views; what
    the wrapper takes beyond them is its checks and Python."""
    shape = (2, *pyr.shape, len(pyr.widths) * (2 * r + 1))
    out = torch.empty(shape, device="cuda", dtype=pyr.dtype)
    parts = {"torch.empty": lambda: torch.empty(shape, device="cuda", dtype=pyr.dtype),
             "launch": lambda: pyr._call(c.data_ptr(), out.data_ptr(), r),
             "unbind": lambda: out.unbind(0)}
    return {name: host_ms(fn, iters=100) for name, fn in parts.items()}


def lookup_edge_cases(dtype, g: torch.Generator):
    """K5 where only its edge handling keeps it right, not timed: level
    widths 40/20/10/5 (bf16 rows of 80, 40, 20 and 10 bytes, only the
    first a multiple of 16) at B = 2, near and far outside every level;
    and 33/16/8/4 with an odd pixel count (in bf16 the second pyramid's
    output then starts mid-chunk)."""
    for label, (b, h, w), far in (("B=2 widths 40-5", (2, 24, 40), False), ("B=2 widths 40-5 far", (2, 24, 40), True),
                                  ("odd pixel count, widths 33-4", (1, 3, 33), True)):
        wls = [w // 2 ** i for i in range(4)]
        la, lb = ([torch.randn((b, h, w, wl), generator=g).to("cuda", dtype) for wl in wls] for _ in range(2))
        spread = 30.0 if far else 3.0
        c = (torch.arange(w, dtype=torch.float32) + torch.randn((b, h, w), generator=g) * spread).cuda()
        if far:
            c[0, 0, :4] = torch.tensor([-1e4, 1e4, -0.5, w - 0.5])
        yield label, (corr_lookup.DualPyramid(la, lb), c, 4)


def step_cases(dtype, h4: int, w4: int, g: torch.Generator, border: bool, lookup: bool = True):
    """(name, wrapper, plain, args, flops, bytes moved, operand dtype of the
    flops, the unfused module's call or None) at one quarter-res plane, B=1.
    border: inputs where only the zero padding keeps the result right.
    lookup: with K5 (--ab leaves it out: an older checkout's K5 took the
    two lists of levels, not a DualPyramid)."""
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
    cases += [] if not lookup else [("dual_lookup", corr_lookup.dual_lookup, corr_lookup.dual_lookup_ref,
                  (corr_lookup.DualPyramid(la, lb), c, 4), 2 * m4 * 4 * 9 * 4.0, moved, torch.float32, None)]

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


TILES = ("128x256", "128x128", "64x128", "64x64", "128x64")  # the library's candidates 1..5
# the candidates K8's bf16 3x3 stages may take: the grouped one's BN is a
# group's 64 channels; the merge conv (N 128) is built without 128 x 256
MOTION_TILES = {"c2/f2": (4, 5), "merge": (2, 3, 4, 5)}


def motion_stages(by_name: dict) -> dict:
    """K8's device ms a call by launch, from device_profile's kernel names:
    c1/f1 (mma.sync in bf16, the CUDA cores in earlier checkouts), the
    grouped 3x3 stage (epilogue 0, ReLU) and the merge conv (epilogue 3),
    on the wgmma core or on the mma.sync tile of earlier checkouts (its
    epilogue the first template argument)."""
    out = {"c1/f1": 0.0, "c2/f2": 0.0, "merge": 0.0}
    for name, ms in by_name.items():
        if "motion_c1f1" in name:
            out["c1/f1"] += ms
            continue
        m = re.search(r"conv_kernel_bf16<(\d+)|conv_wgmma_kernel<\d+,\s*\d+,\s*(\d+)>", name)
        if m:
            out["c2/f2" if int(m.group(1) or m.group(2)) == 0 else "merge"] += ms
    return out


def stages_text(stages: dict) -> str:
    return ", ".join(f"{k} {v:.4f}" for k, v in stages.items())


def forced_motion_call(args, tile2: int, tile3: int):
    """A call of K8's bf16 body with candidate tile2 on its grouped stage
    and tile3 on its merge conv (0: picked), through the library's
    diagnostic entry point (no launch count), and the tensor it writes
    into."""
    ca, cb, c, w = args
    b, h, wd, kc = ca.shape
    a1 = torch.empty((b, h, wd, 192), device=ca.device, dtype=ca.dtype)
    a2, out = torch.empty_like(a1), torch.empty((b, h, wd, 128), device=ca.device, dtype=ca.dtype)
    fn = build.bind("step_fused", "sa_motion_forced_tile", 14, 6)
    ptrs = [t.data_ptr() for t in (ca, cb, c, *w, a1, a2, out)]

    def call():
        build.check_status("step_fused", f"motion_encoder with tiles {tile2}, {tile3}",
                           fn(*ptrs, b, h, wd, kc, tile2, tile3, build.current_stream()))
    return call, out


def forced_tile_call(args, tile: int):
    """A call of K9's bf16 body with tile candidate `tile` (1..5, TILES)
    forced on both launches, through the library's diagnostic entry point
    (no launch count), and the tensor it writes h' into."""
    h, xs, czrq, w = args
    hd, cs = h.shape[-1], [x.shape[-1] for x in xs]
    z, rh, out = (torch.empty_like(h) for _ in range(3))
    fn = build.bind("step_fused", "sa_conv_gru_forced_tile", 13, 8)
    ptrs = (h.data_ptr(), xs[0].data_ptr(), xs[1].data_ptr() if len(xs) == 2 else None, czrq.data_ptr(),
            czrq[..., hd:].data_ptr(), czrq[..., 2 * hd:].data_ptr(), w.w_zr.data_ptr(), w.b_zr.data_ptr(),
            w.w_q.data_ptr(), w.b_q.data_ptr(), z.data_ptr(), rh.data_ptr(), out.data_ptr())
    ints = (*h.shape, cs[0], cs[1] if len(cs) == 2 else 0, 3 * hd, tile)

    def call():
        build.check_status("step_fused", f"conv_gru with tile {TILES[tile - 1]}",
                           fn(*ptrs, *ints, build.current_stream()))
    return call, out


def tiles_main() -> int:
    """K9's bf16 body at each scale of both planes with each tile candidate
    forced on both launches: checked against the plain version, then device
    ms a call and of its z/r and q launches (kernel template arguments
    <BM, BN, epilogue>: 1 z/r, 2 q); then K8's, each candidate of one 3x3
    stage forced, the other picked, device ms a call and by launch; then
    K7's, each candidate forced on conv1, device ms a call and of conv1."""
    build.build(("step_fused",))
    g = torch.Generator().manual_seed(1)
    for plane, (h4, w4) in STEP_PLANES.items():
        for name, _, ref, args, *_ in step_cases(torch.bfloat16, h4, w4, g, border=False):
            if name == "flow_head":
                want, parts = ref(*args), []
                for tile, label in [(0, "picked")] + list(enumerate(TILES, 1)):
                    call = ((lambda: step_fused.flow_head(*args)) if tile == 0 else
                            (lambda tile=tile: step_fused.flow_head_forced_tile(*args, tile)))
                    got = call()
                    torch.cuda.synchronize()
                    check(f"{name} {plane} {label}", got, want, torch.bfloat16)
                    prof = device_profile(call)
                    conv1 = None if prof is None else sum(v for k, v in prof[1].items() if "conv_wgmma_kernel" in k)
                    parts.append(f"{label} " + ("not measured" if prof is None else
                                                f"{prof[0]:.4f} (conv1 {conv1:.4f})"))
                print(f"tiles {name} {plane}, device ms a call: " + "; ".join(parts), flush=True)
            if name == "motion_encoder":
                want, parts = ref(*args), []
                forced = [("picked", 0, 0)] + [(f"c2/f2 {TILES[t - 1]}", t, 0) for t in MOTION_TILES["c2/f2"]] + [
                    (f"merge {TILES[t - 1]}", 0, t) for t in MOTION_TILES["merge"]]
                for label, tile2, tile3 in forced:
                    call, out = forced_motion_call(args, tile2, tile3)
                    call()
                    torch.cuda.synchronize()
                    check(f"{name} {plane} {label}", out, want, torch.bfloat16)
                    got = device_profile(call)
                    parts.append(f"{label} " + ("not measured" if got is None else
                                                f"{got[0]:.4f} ({stages_text(motion_stages(got[1]))})"))
                print(f"tiles {name} {plane}, device ms a call: " + "; ".join(parts), flush=True)
            if not name.startswith("conv_gru/"):
                continue
            want, parts = ref(*args), []
            for tile, label in enumerate(TILES, 1):
                call, out = forced_tile_call(args, tile)
                call()
                torch.cuda.synchronize()
                check(f"{name} {plane} tile {label}", out, want, torch.bfloat16)
                got = device_profile(call)
                if got is None:
                    parts.append(f"{label} not measured (no whole trace from the profiler)")
                    continue
                busy, by_name = got
                zr = sum(v for k, v in by_name.items() if "conv_wgmma_kernel" in k and re.search(r",\s*1>", k))
                q = sum(v for k, v in by_name.items() if "conv_wgmma_kernel" in k and re.search(r",\s*2>", k))
                parts.append(f"{label} {busy:.4f} (z/r {zr:.4f}, q {q:.4f})")
            print(f"tiles {name} {plane}, device ms a call: " + "; ".join(parts), flush=True)
    step_geometry()
    print(card_line())
    return 0


def step_geometry() -> None:
    """K9's bf16 launches (z/r, then q) at each scale of both planes, and
    K7's conv1 and K8's two 3x3 launches at both planes (B = 1)."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for plane, (h4, w4) in STEP_PLANES.items():
        for scale in (1, 2, 4):
            hh, ww = h4 // scale, w4 // scale
            for what, g in zip(("z/r", "q"), step_fused.launch_geometry(1, hh, ww)):
                print(f"geometry conv_gru/{8 * scale:02d} {plane} ({hh}x{ww}) {what}: {g['bm']}x{g['bn']} tiles of "
                      f"{g['bw']}x{g['bh']}-pixel patches, {g['tiles']} of them on a persistent grid of {g['blocks']} "
                      f"blocks ({g['threads']} threads, {g['stages']} stages, {g['smem']} B shared): "
                      f"{g['tiles'] / sms:.2f} waves of tiles", flush=True)
        g = step_fused.flow_head_geometry(1, h4, w4)
        print(f"geometry flow_head {plane} ({h4}x{w4}) conv1: {g['bm']}x{g['bn']} tiles of {g['bw']}x{g['bh']}-pixel "
              f"patches, {g['tiles']} of them on a persistent grid of {g['blocks']} blocks ({g['threads']} threads, "
              f"{g['stages']} stages, {g['smem']} B shared): {g['tiles'] / sms:.2f} waves of tiles", flush=True)
        for what, g in zip(("c2/f2 (3 groups)", "merge"), step_fused.motion_geometry(1, h4, w4)):
            print(f"geometry motion_encoder {plane} ({h4}x{w4}) {what}: {g['bm']}x{g['bn']} tiles of "
                  f"{g['bw']}x{g['bh']}-pixel patches, {g['tiles']} of them on a persistent grid of {g['blocks']} "
                  f"blocks ({g['threads']} threads, {g['stages']} stages, {g['smem']} B shared): "
                  f"{g['tiles'] / sms:.2f} waves of tiles", flush=True)


def step_kernel_phase() -> dict:
    """Check and time K5, K7, K8 and K9 (and the K6 interface) against
    their plain versions and the unfused modules.  Returns the records of
    the main path's dtype (bf16) at 512^2; conv_gru's is the sum of its
    three scales, as one iteration runs each once."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator().manual_seed(1)
    records = {}

    def checked(name, what, fn, ref, args, dtype):
        got = fn(*args)
        torch.cuda.synchronize()
        want = ref(*args)
        pairs = zip(got, want) if isinstance(got, tuple) else [(got, want)]
        tol = KERNEL_TOL.get(name, REL_TOL[dtype])
        err, scale = map(max, zip(*[check(what, a, b, dtype, tol) for a, b in pairs]))
        return err, f"max_abs_err {err:.3e} (max|plain| {scale:.3e}, tol {tol:.0e} rel)"

    for dtype in (torch.bfloat16, torch.float32):
        for label, args in lookup_edge_cases(dtype, torch.Generator().manual_seed(2)):
            _, text = checked("dual_lookup", f"dual_lookup {dtype} {label}", corr_lookup.dual_lookup,
                              corr_lookup.dual_lookup_ref, args, dtype)
            print(f"kernel dual_lookup {str(dtype)[6:]} {label}: {text}", flush=True)
        for plane, (h4, w4) in STEP_PLANES.items():
            for border in (False, True):
                for name, fn, ref, args, flops, moved, op_dtype, unfused in step_cases(dtype, h4, w4, g, border):
                    what = f"kernel {name} {str(dtype)[6:]} {plane}"
                    err, text = checked(name, f"{name} ({dtype}, {plane}, border={border})", fn, ref, args, dtype)
                    if border:
                        print(f"{what} border case: {text}", flush=True)
                        continue
                    prof = device_profile(lambda: fn(*args))
                    row = dict(ms=cuda_ms(lambda: fn(*args)), device_ms=None if prof is None else prof[0],
                               host_ms=host_ms(lambda: fn(*args)), plain_ms=cuda_ms(lambda: ref(*args)),
                               unfused_ms=cuda_ms(unfused) if unfused is not None else None,
                               library_ms=None, max_abs_err=err)
                    if row["unfused_ms"] is None:  # the lookup the unfused loop ran before K5: the plain gather
                        row["unfused_ms"] = row["plain_ms"]
                    row["bound_ms"], row["bound_by"] = bound_ms(flops, moved, op_dtype)
                    if name == "dual_lookup":  # the windows in whole 32-byte sectors
                        pyr, c, r = args
                        es = pyr.levels_a[0].element_size()
                        sectors = moved - _window_bytes(c, pyr.widths, r, es) + _window_sector_bytes(c, pyr.widths, r, es)
                        row["sector_bound_ms"] = sectors / PEAK_BYTES * 1e3
                        print(f"{what}: sector bound_ms {row['sector_bound_ms']:.4f} ({sectors / 1e6:.2f} MB in "
                              "32-byte sectors)", flush=True)
                        split = lookup_host_split(*args)
                        print(f"{what}: host ms a call by part: " + ", ".join(f"{k} {v:.4f}" for k, v in split.items())
                              + f"; checks and Python {row['host_ms'] - sum(split.values()):.4f}", flush=True)
                    print(f"{what}: {text} "
                          f"ms {fmt(row['ms'], flops)} device_ms {fmt(row['device_ms'], flops)} "
                          f"host_ms {row['host_ms']:.4f} plain_ms {row['plain_ms']:.4f} "
                          f"unfused_ms {row['unfused_ms']:.4f} "
                          f"bound_ms {row['bound_ms']:.4f} ({row['bound_by']}; {flops / 1e9:.3f} GFLOP, "
                          f"{moved / 1e6:.2f} MB)", flush=True)
                    if name == "motion_encoder" and dtype == torch.bfloat16:
                        print(f"{what}: device ms by launch " + ("not measured" if prof is None else
                                                                 stages_text(motion_stages(prof[1]))), flush=True)
                    if dtype == torch.bfloat16 and plane == "512x512":
                        key = name.split("/")[0]
                        if key in records:  # conv_gru: sum the scales
                            prev = records[key]
                            for k in ("ms", "host_ms", "plain_ms", "unfused_ms", "bound_ms"):
                                prev[k] += row[k]
                            prev["device_ms"] = (None if None in (prev["device_ms"], row["device_ms"])
                                                 else prev["device_ms"] + row["device_ms"])
                            prev["max_abs_err"] = max(prev["max_abs_err"], err)
                        else:
                            records[key] = row
    records.pop("gru_fused (K6 interface)")
    step_geometry()
    booster_lookup_rows()
    return records


def booster_lookup_rows() -> None:
    """K5 at a Booster tile's quarter-resolution plane: 544 rows of 4112
    padded to 4128 and width-aligned to 4160, so 136 x 1040 (level widths
    1040 / 520 / 260 / 130), B = 1 (a sequential tile) and 2."""
    plane_lookup_rows("booster tile plane", 136, 1040, (1, 2), 50)


def plane_lookup_rows(label: str, h4: int, w4: int, batches: tuple[int, ...], seed: int) -> None:
    """K5 at one quarter-resolution plane (level widths w4 / 2^i), both
    dtypes, coordinates over the whole row and past both ends: held to the
    plain gather bit for bit, timed with its window bound."""
    wls = [w4 // 2 ** i for i in range(4)]
    for dtype in (torch.bfloat16, torch.float32):
        for b in batches:
            g = torch.Generator(device="cuda").manual_seed(seed + b)
            la, lb = ([torch.randn((b, h4, w4, wl), generator=g, device="cuda").to(dtype) for wl in wls]
                      for _ in range(2))
            xs = torch.arange(w4, device="cuda", dtype=torch.float32)
            c = xs - torch.rand((b, h4, w4), generator=g, device="cuda") * (w4 / 8) + 2.0
            c[0, 0, :4] = torch.tensor([-1e4, 1e4, -0.5, w4 - 0.5])
            args = (corr_lookup.DualPyramid(la, lb), c, 4)
            got = corr_lookup.dual_lookup(*args)
            torch.cuda.synchronize()
            pairs = zip(got, corr_lookup.dual_lookup_ref(*args))
            err = max(check(f"dual_lookup {label} {dtype} B={b}", x, y, dtype, 0.0)[0] for x, y in pairs)
            es = torch.finfo(dtype).bits // 8
            m4 = b * h4 * w4
            flops, moved = 2 * m4 * 4 * 9 * 4.0, _window_bytes(c, wls, 4, es) + nbytes(c) + 2 * m4 * 36 * es
            bound, by = bound_ms(flops, moved, torch.float32)
            print(f"kernel dual_lookup {str(dtype)[6:]} {label} {h4}x{w4} B={b}: max_abs_err {err:.3e} "
                  f"(tol 0) ms {cuda_ms(lambda: corr_lookup.dual_lookup(*args)):.4f} device_ms "
                  f"{fmt(device_ms(lambda: corr_lookup.dual_lookup(*args)))} plain_ms "
                  f"{cuda_ms(lambda: corr_lookup.dual_lookup_ref(*args)):.4f} bound_ms {bound:.4f} ({by}; "
                  f"{moved / 1e6:.2f} MB)", flush=True)
            del la, lb, args, got


def capture_phase() -> None:
    """The CUDA runtime and driver versions, then one ViT-L block's K1-K4
    and one rotated step's K5, K7, K8 and K9 (bf16, the 512^2 request's
    shapes) captured in one graph, after a warm-up call: the types of its
    dependency edges (the launchers ask for programmatic stream
    serialisation, which a capture should keep as programmatic edges), and
    its replay against the eager calls, held to 0."""
    lib = build.library("corr_lookup")
    versions = (ctypes.c_int * 3)()
    build.check_status("corr_lookup", "sa_cuda_versions", lib.sa_cuda_versions(versions))
    driver = subprocess.run(["nvidia-smi", "--query-gpu=driver_version", "--format=csv,noheader"],
                            capture_output=True, text=True, check=True).stdout.strip()
    print(f"CUDA: kernels built against runtime {versions[0]}, running on runtime {versions[1]}, driver CUDA "
          f"{versions[2]} (driver {driver}); torch {torch.__version__} built for CUDA {torch.version.cuda}", flush=True)
    g = torch.Generator().manual_seed(7)
    vit = [(fn, args) for _, fn, _, _, args, *_ in kernel_cases(torch.bfloat16, tokens_of(512, 512), g)]
    step = [(fn, args) for name, fn, _, args, *_ in step_cases(torch.bfloat16, *STEP_PLANES["512x512"], g, False)
            if name in ("dual_lookup", "flow_head", "motion_encoder", "conv_gru/08")]
    calls = vit + step

    def run():
        return [fn(*args) for fn, args in calls]

    want = run()  # the warm-up
    torch.cuda.synchronize()
    try:
        graph = torch.cuda.CUDAGraph(keep_graph=True)
    except TypeError:
        graph = None
        print("capture: this torch keeps no captured graph (no keep_graph); edge types not measured", flush=True)
    if graph is not None:
        with torch.cuda.graph(graph):
            outs = run()
        graph.instantiate()
        counts = (ctypes.c_longlong * 3)()
        lib.sa_graph_edge_types.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        status = lib.sa_graph_edge_types(ctypes.c_void_p(graph.raw_cuda_graph()), counts)
        print(f"capture of {len(calls)} kernel calls (K1-K4, K5, K7, K8, K9): " + (
            f"{counts[0]} edges, {counts[1]} programmatic, {counts[2]} from a launch-completion port"
            if status == 0 else f"edge types not measured ({lib.sa_error_string(status).decode()})"), flush=True)
        graph.replay()
        torch.cuda.synchronize()
        for (fn, _), a, b in zip(calls, outs, want):
            for x, y in zip(*((a, b) if isinstance(a, tuple) else ((a,), (b,)))):
                if not torch.equal(x, y):
                    raise AssertionError(f"{fn.__name__}: the replay differs from the eager call")
        print("capture: the replay equals the eager calls bit for bit", flush=True)


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
# launches a request: the ViT's kernels once a block; K5 once an iteration
# in both configurations (the fused one: its pre-step and ITERS - 1
# rotated bodies); on the fused path the other step kernels once a rotated
# body (K9 at three scales)
MAIN_PATH = {**{n: VIT_L["depth"] for n in ("ln_dense", "vit_attention", "dense_scale_residual", "vit_mlp")},
             "dual_lookup": ITERS}
EXPECTED = {
    "default": {n: MAIN_PATH.get(n, 0) for n in COUNTERS},
    # DAv2 ViT-G: K1-K3 once a block, its SwiGLU FFN in PyTorch (no K4)
    "vitg": {**{n: 0 for n in COUNTERS}, **{n: VIT_G["depth"] for n in ("ln_dense", "vit_attention",
                                                                         "dense_scale_residual")},
             "dual_lookup": ITERS},
    "fused": {**{n: MAIN_PATH.get(n, 0) for n in COUNTERS}, "flow_head": ITERS - 1,
              "motion_encoder": ITERS - 1, "conv_gru": 3 * (ITERS - 1)},
    # the aggregation variant: the stereo volume's hourglasses and classifier
    # are cuDNN convolutions; K5 reads the aggregated volume's pyramid
    "variant": {n: MAIN_PATH.get(n, 0) for n in COUNTERS},
}
# the aggregation variant no shipped model uses, at the default widths: the
# stereo volume through its own hourglass, one stacked hourglass after each
# volume's first (the reference's identity-first stack of n = 2)
VARIANT = dict(use_aggregate_stereo_vol=True, n_additional_hourglass=2)


class _Recorder:
    """Pipeline wrapper that keeps each request's float disparity and the
    kernel wrappers' calls it made."""

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


def trace_launches(names) -> dict:
    """Each wrapper's calls in a trace, from its bf16 body's kernels: K2 its
    attention kernel, K3 the products with the residual epilogue (2), K4
    those with the GELU epilogue (1), K1 the bias-epilogue products (0) less
    K4's second product; K5 its lookup kernel; K7, K8 and K9 the convolutions
    of their epilogues 4 (flow head), 3 (motion merge) and 1 (GRU z/r).  A
    replayed graph calls no wrapper, so its launches are read here."""
    gemm, conv, other = defaultdict(int), defaultdict(int), defaultdict(int)
    for n in names:
        if m := re.search(r"wgmma_gemm_kernel<\d+,\s*(\d+)>", n):
            gemm[int(m.group(1))] += 1
        elif m := re.search(r"conv_wgmma_kernel<\d+,\s*\d+,\s*(\d+)>", n):
            conv[int(m.group(1))] += 1
        elif "attn_kernel_wgmma" in n:
            other["attention"] += 1
        elif "dual_lookup_kernel" in n:
            other["lookup"] += 1
    return {"ln_dense": gemm[0] - gemm[1], "vit_attention": other["attention"], "dense_scale_residual": gemm[2],
            "vit_mlp": gemm[1], "dual_lookup": other["lookup"], "flow_head": conv[4], "motion_encoder": conv[3],
            "conv_gru": conv[1]}


SPLIT_ROUNDS = 10
# kernel name -> family, first match wins
FAMILIES = (
    ("ViT K1-K4", r"gemm_kernel_f32|attn_kernel|wgmma_gemm_kernel|ln_rows_kernel"),
    ("step K5/K7-K9", r"conv_kernel_|conv_wgmma_kernel|dual_lookup_kernel|flow_(z9|tapsum)_kernel|motion_c1f1"),
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


def _device_us(avg) -> float:
    """A profiler average's device time in us (its name differs between
    torch versions)."""
    return getattr(avg, "device_time_total", None) or getattr(avg, "cuda_time_total", 0.0)


HOURGLASS_VOLUMES = {"kitti": (320, 96, 320), "oakd": (160, 104, 160)}
# H100 SXM dense TF32 tensor-core peak (NVIDIA data sheet): K10's 3x3x3 products
PEAK_TF32 = 494.7e12
K10_LAUNCHES = 15  # a fused hourglass: 10 3x3x3, 2 1x1x1, 2 projections, 1 finalize
BF16_UNIT = 2.0 ** -8


def hourglasses(pipe) -> int:
    """The `Hourglass` calls a forward of the pipeline's model makes."""
    from stereoanywhere_tpu_torch.models.hourglass import Hourglass

    return sum(isinstance(m, Hourglass) for m in pipe.stereo.modules())


def k10_in_a_request(pipe, label: str, im2, im3) -> int:
    """K10's launches in one eager request, counted from 0 just before it:
    every `Hourglass` call of the forward on the fused path, 15 launches
    each."""
    from stereoanywhere_tpu_torch.ops.cuda import hourglass3d  # here: --spans and --ab run older checkouts too

    n = hourglasses(pipe)
    calls, launched = hourglass3d.calls(), hourglass3d.launches()
    eager(pipe, im2, im3)
    by_path = {k: v - calls[k] for k, v in hourglass3d.calls().items()}
    launched = hourglass3d.launches() - launched
    print(f"pipeline {label}: K10 in one eager request {tuple(im2.shape[1:3])}: {launched} launches, hourglass calls by "
          f"path {by_path}", flush=True)
    if by_path != {"fused": n, "plain": 0} or launched != K10_LAUNCHES * n:
        raise AssertionError(f"{label}: an eager request ran the hourglass {by_path} with {launched} K10 launches, "
                             f"expected {n} fused calls and {K10_LAUNCHES * n} launches")
    return launched


def k10_kernels(names) -> int:
    """K10's launches among kernel names (its kernels live in sa::hg)."""
    return sum(1 for n in names if "sa::hg::" in n)


def _k10_launch_cost(name: str, args: tuple, out) -> tuple[float, int, float]:
    """A recorded K10 launch's FLOP, bytes (its operands read once, its
    output written once) and the FLOP/s its FLOP run at."""
    v = args[0]
    gate = nbytes(*(v.gate or ()))
    if name == "conv3":
        w = args[1]
        return 2 * out.x.numel() * 27 * v.channels, nbytes(v.x, w, out.x) + gate, PEAK_TF32
    if name == "conv1":
        up, w = args[2], args[3]
        return 2 * out.x.numel() * v.channels, nbytes(v.x, up, w, out.x) + gate, PEAK_FLOPS[torch.float32]
    if name == "upsampled_share":
        return 2 * out.numel() * v.channels, nbytes(v.x, args[1], out) + gate, PEAK_FLOPS[torch.float32]
    return 0.0, nbytes(v.x, out) + gate, PEAK_FLOPS[torch.float32]


def hourglass_kernel_phase() -> dict:
    """K10, the fused hourglass (`ops/cuda/hourglass3d.py`), at the KITTI
    and OAK-D volumes of a bf16 model with TF32 on, as the port serves it:
    the hourglass against its modules (cuDNN, TF32) within one bf16 unit of
    the output's largest value and a mean under a twentieth of one; each of
    its 15 launches against its plain version (`*_ref`, on the card in full
    f32) at the card tests' tolerances (a 3x3x3 launch one bf16 unit, two
    for a bf16 store; the rest 1e-5; a launch's sums within 1e-5 of its
    stored output's); then timed beside the modules (CUDA events eager and
    on a CUDA graph, the profiler's device time, host), its bound the launches' own operations and bytes (each launch's
    max of FLOP at the TF32 or f32 peak and bytes at 3.35 TB/s, summed).
    Returns the KITTI volume's record, the OAK-D one's under `oakd_`."""
    from stereoanywhere_tpu_torch.ops.cuda import hourglass3d as hg3  # here: --spans and --ab run older checkouts

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cudnn.benchmark = True
    model = StereoAnywhere(StereoAnywhereConfig(compute_dtype="bfloat16"), device="cuda")
    hg = model.hourglass_mono
    g = torch.Generator().manual_seed(6)
    record = {}
    for label, dims in HOURGLASS_VOLUMES.items():
        vol = torch.randn((1, 8, *dims), generator=g).to("cuda", torch.bfloat16)
        levels = [dims]
        for _ in range(3):
            levels.append(tuple((s - 1) // 2 + 1 for s in levels[-1]))
        fl = [torch.rand((1, 1, d[1], d[2]), generator=g).cuda() for d in levels]
        fr = [torch.rand((1, 1, d[1], d[0]), generator=g).cuda() for d in levels]
        run = functools.partial(hg, vol, fl, fr)
        seen = []
        wrapped = {n: getattr(hg3, n) for n in ("conv3", "conv1", "upsampled_share", "finalize")}

        def recorder(name):
            def call(*args):
                out = wrapped[name](*args)
                seen.append((name, args, out))
                return out
            return call

        with torch.no_grad():
            want = hg.forward_modules(vol, fl, fr)
            calls, n0 = hg3.calls(), hg3.launches()
            for n in wrapped:
                setattr(hg3, n, recorder(n))
            try:
                got = run()
            finally:
                for n, f in wrapped.items():
                    setattr(hg3, n, f)
            torch.cuda.synchronize()
            by_path = {k: v - calls[k] for k, v in hg3.calls().items()}
            launched = hg3.launches() - n0
            if by_path != {"fused": 1, "plain": 0} or launched != K10_LAUNCHES or len(seen) != K10_LAUNCHES:
                raise AssertionError(f"K10 {label}: calls by path {by_path}, {launched} launches, {len(seen)} recorded")
            gap = (got - want).abs()
            unit = BF16_UNIT * want.abs().max()
            units, mean_units = float(gap.max() / unit), float(gap.mean() / unit)
            if not (units <= 1.0 and mean_units <= 0.05 and bool(torch.isfinite(got).all())):
                raise AssertionError(f"K10 {label}: {units:.3f} bf16 units from the modules (mean {mean_units:.4f})")
            # each launch against its plain version in full f32
            torch.backends.cudnn.allow_tf32 = False
            worst = defaultdict(float)
            flops = moved = bound = 0.0
            for i, (name, args, out) in enumerate(seen):
                ref = getattr(hg3, f"{name}_ref")
                if name == "conv3":
                    v, w, stride = args[:3]
                    want_out, tol = ref(v, w, stride), (2.0 if out.x.dtype == torch.bfloat16 else 1.0) * BF16_UNIT
                elif name == "conv1":
                    want_out, tol = ref(*args[:4]), 1e-5
                else:
                    want_out, tol = ref(*args), 1e-5
                a, b = (out.x, want_out.x) if name in ("conv3", "conv1") else (out, want_out)
                rel = float((a.float() - b.float()).abs().max() / b.float().abs().max())
                if not rel <= tol:
                    raise AssertionError(f"K10 {label} launch {i} ({name}): {rel:.3e} of its plain version's largest "
                                         f"value, tolerance {tol:.3e}")
                if name in ("conv3", "conv1"):
                    own, scale = hg3.sums(out.x), hg3.sums(out.x.abs())
                    if not bool(((out.stats - own).abs() <= 1e-5 * scale + 1e-30).all()):
                        raise AssertionError(f"K10 {label} launch {i} ({name}): its sums are not its output's")
                worst[name] = max(worst[name], rel)
                f, m, peak = _k10_launch_cost(name, args, out)
                flops, moved, bound = flops + f, moved + m, bound + max(f / peak, m / PEAK_BYTES)
            torch.backends.cudnn.allow_tf32 = True
            del seen, got, want
            ms, plain_ms = cuda_ms(run), cuda_ms(lambda: hg.forward_modules(vol, fl, fr))
            on_graph, plain_on_graph = graph_ms(run), graph_ms(lambda: hg.forward_modules(vol, fl, fr))
            prof = device_profile(run)
            kernel_ms = None if prof is None else sum(t for n, t in prof[1].items() if "sa::hg::" in n)
            row = dict(max_bf16_units=units, mean_bf16_units=mean_units, launch_max_rel_err=dict(worst), ms=ms,
                       device_ms=None if prof is None else prof[0], kernels_device_ms=kernel_ms,
                       graph_ms=on_graph, host_ms=host_ms(run), plain_ms=plain_ms, plain_graph_ms=plain_on_graph,
                       plain_device_ms=device_ms(
                           lambda: hg.forward_modules(vol, fl, fr)),
                       bound_ms=bound * 1e3, bound_by="bytes" if moved / PEAK_BYTES >= flops / PEAK_TF32 else
                       "operations", flops=flops, bytes=moved, launches_a_call=launched)
        print(f"kernel hourglass3d (K10) bf16 model, volume 8x{dims[0]}x{dims[1]}x{dims[2]}, TF32: "
              f"{units:.3f} bf16 units from the modules (mean {mean_units:.4f}); launches against their plain "
              f"versions (max rel.) " + ", ".join(f"{n} {e:.2e}" for n, e in worst.items())
              + f"; ms {fmt(ms, flops)} graph_ms {fmt(on_graph, flops)} device_ms {fmt(row['device_ms'], flops)} "
              f"(K10's launches {fmt(kernel_ms)}) host_ms {row['host_ms']:.4f}; the modules (cuDNN) ms {plain_ms:.4f} "
              f"graph_ms {plain_on_graph:.4f} device_ms {fmt(row['plain_device_ms'])}; bound_ms {row['bound_ms']:.4f} ({row['bound_by']}; "
              f"{flops / 1e9:.2f} GFLOP, {moved / 1e9:.3f} GB in {launched} launches)", flush=True)
        record.update(row if label == "kitti" else {f"{label}_{k}": v for k, v in row.items()})
    del model, hg
    torch.cuda.empty_cache()
    return record


# the model's parts, each wrapped in a record_function range of this name
# for a traced request: (owner, attribute) pairs, an nn.Module's forward
# or a function the forward calls by its module-level name.  The loop's
# functions are the ones the forward calls (refinement_step calls its own
# module's update_nets, which stays unwrapped, so no range nests in one of
# its own name); the glue ranges lie inside the loop's
def module_parts(pipe) -> dict:
    st, mono = pipe.stereo, pipe.mono
    return {
        "DAv2 ViT": [(mono.pretrained, "forward")],
        "DAv2 DPT head": [(mono.depth_head, "forward")],
        "extractors": [(st.cnet, "forward"), (st.fnet, "forward")],
        "volumes": [(sa_model, n) for n in ("all_pairs_correlation", "generate_masks", "masked_volume",
                                            "truncate_corr_volume", "build_corr_pyramid")],
        # the aggregation variant's stereo hourglass and the stacks too
        "hourglass and classifiers": [(m, "forward") for m in (
            [st.hourglass_mono, getattr(st, "hourglass_stereo", None)]
            + [m for n in ("hourglass_mono_stack", "hourglass_stereo_stack") for m in list(getattr(st, n, []))[1:]])
            if m is not None] + [(sa_model, "conv_in_dtype")],
        "refinement loop": [(sa_model, n) for n in ("update_nets", "refinement_step", "fused_refinement_step",
                                                    "refinement_tail")],
        "loop glue (pool/interp)": [(sa_update, n) for n in ("pool2x", "interp_like", "pool2x_nhwc",
                                                             "interp_like_nhwc")],
    }


@contextmanager
def module_ranges(parts: dict):
    """Wrap each (owner, attribute) of `parts` (a range name -> its pairs,
    as module_parts gives them) in a record_function range of that name;
    restored after."""
    saved = []
    for range_name, pairs in parts.items():
        for owner, attr in pairs:
            fn = getattr(owner, attr)

            def ranged(*a, _fn=fn, _name=range_name, **k):
                with record_function(_name):
                    return _fn(*a, **k)
            saved.append((owner, attr, attr in vars(owner), fn))
            setattr(owner, attr, ranged)
    try:
        yield
    finally:
        for owner, attr, own, fn in reversed(saved):
            if own:
                setattr(owner, attr, fn)
            else:  # a module's forward: back to its class's
                delattr(owner, attr)


def kernels_within(kernels, spans) -> float:
    """Busy ms of the kernels that lie inside one of the spans (which do
    not overlap one another)."""
    spans = sorted(spans)
    starts = [s for s, _ in spans]
    inside = []
    for e in kernels:
        i = bisect.bisect_right(starts, e.time_range.start) - 1
        if i >= 0 and e.time_range.end <= spans[i][1]:
            inside.append((e.time_range.start, e.time_range.end))
    return busy_us(inside) / 1e3


def eagerly(owner, fn):
    """fn() with owner's graphs off (kernel by kernel), on again after."""
    owner.graphs = False
    try:
        return fn()
    finally:
        owner.graphs = True


def eager(pipe, *args):
    """One eager call of the pipeline."""
    return eagerly(pipe, lambda: pipe(*args))


def traced(fn) -> tuple:
    """(profiler, device kernels, the traced call's wall ms) of one call."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall = sync_ms(fn)
    return prof, [e for e in prof.events() if e.device_type == DeviceType.CUDA], wall


def time_and_trace(pipe, label: str, h: int, w: int, im2, im3) -> dict:
    """The warm graph request, the warm eager request and the eager mono and
    stereo stages alone, timed in interleaved rounds so that drift of the
    shared host hits all alike; then one traced graph request (its replay's
    kernels: busy time, idle share, launches, each wrapper's launches, which
    must be the expected ones) and one traced eager request (the same, time
    by family, aten::conv3d, device time by module).  Returns the graph
    request's launches by wrapper."""
    # the first eager call is timed apart: a capture empties the caching
    # allocator, whose blocks the eager call then allocates anew
    first = sync_ms(lambda: eager(pipe, im2, im3))
    mde2, mde3 = pipe.mono_stage(im2, im3)
    times = {"graph request": [], "eager request": [], "mono stage": [], "stereo stage": []}
    for _ in range(SPLIT_ROUNDS):
        times["graph request"].append(sync_ms(lambda: pipe(im2, im3)))
        times["eager request"].append(sync_ms(lambda: eager(pipe, im2, im3)))
        times["mono stage"].append(sync_ms(lambda: pipe.mono_stage(im2, im3)))
        times["stereo stage"].append(sync_ms(lambda: pipe.stereo_stage(im2, im3, mde2, mde3)))
    print(f"split {label} {h}x{w}, ms, first eager call on this thread {first:.1f}; median [min-max] of "
          f"{SPLIT_ROUNDS} interleaved rounds after it: " + "; ".join(
              f"{k} {np.median(v):.1f} [{min(v):.1f}-{max(v):.1f}]" for k, v in times.items()), flush=True)

    want = EXPECTED[label]
    want_k10 = K10_LAUNCHES * hourglasses(pipe)
    # the profiler now and then drops a replay's events: three traces, the
    # one that kept the most kernels read
    tries = [traced(lambda: pipe(im2, im3)) for _ in range(3)]
    _, kernels, wall = max(tries, key=lambda t: len(t[1]))
    graph_counts = None
    if kernels:
        busy = busy_us([(e.time_range.start, e.time_range.end) for e in kernels]) / 1e3
        median = float(np.median(times["graph request"]))
        graph_counts = trace_launches(e.name for e in kernels)
        print(f"trace {label} {h}x{w} graph: device busy {busy:.1f} ms, idle share {1 - busy / median:.3f} of the "
              f"untraced median {median:.1f} ms (traced wall {wall:.1f} ms); {len(kernels)} kernels (the three "
              f"traces: {[len(k) for _, k, _ in tries]}); launches by wrapper from the trace {graph_counts}", flush=True)
        if graph_counts != want:
            raise AssertionError(f"{label} {h}x{w}: the replayed graph launched {graph_counts}, expected {want}")
        graph_counts["hourglass3d"] = k10_kernels(e.name for e in kernels)
        print(f"trace {label} {h}x{w} graph: K10's launches {graph_counts['hourglass3d']}", flush=True)
        if graph_counts["hourglass3d"] != want_k10:
            raise AssertionError(f"{label} {h}x{w}: the replay launched K10 {graph_counts['hourglass3d']} times, "
                                 f"expected {want_k10}")
    else:
        print(f"trace {label} {h}x{w} graph: not measured (the profiler saw no device events in the replay); "
              "launches by wrapper are the capture's", flush=True)

    prof, device_events, traced_wall = None, None, None
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof, module_ranges(module_parts(pipe)):
        traced_wall = sync_ms(lambda: eager(pipe, im2, im3))
    # the ranges show on the device too, as spans from their first kernel
    # to their last: kept apart from the kernels
    parts = module_parts(pipe)
    device_events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    kernels = [e for e in device_events if e.name not in parts]
    spans = defaultdict(list)
    for e in device_events:
        if e.name in parts:
            spans[e.name].append((e.time_range.start, e.time_range.end))
    if not kernels:
        print(f"trace {label} {h}x{w} eager: device busy time not measured (the profiler saw no device events)",
              flush=True)
        return graph_counts
    busy = busy_us([(e.time_range.start, e.time_range.end) for e in kernels]) / 1e3
    median = float(np.median(times["eager request"]))
    eager_counts = trace_launches(e.name for e in kernels)
    if eager_counts != want:
        raise AssertionError(f"{label} {h}x{w}: the eager request launched {eager_counts}, expected {want}")
    if k10_kernels(e.name for e in kernels) != want_k10:
        raise AssertionError(f"{label} {h}x{w}: the eager request launched K10 "
                             f"{k10_kernels(e.name for e in kernels)} times, expected {want_k10}")
    # launches of each stage alone
    stage_kernels = {}
    for stage, fn in (("mono", lambda: pipe.mono_stage(im2, im3)),
                      ("stereo", lambda: pipe.stereo_stage(im2, im3, mde2, mde3))):
        with profile(activities=[ProfilerActivity.CUDA]) as p:
            sync_ms(fn)
        stage_kernels[stage] = sum(1 for e in p.events() if e.device_type == DeviceType.CUDA)
    conv3d = sum(_device_us(e) for e in prof.key_averages() if e.key == "aten::conv3d") / 1e3
    print(f"trace {label} {h}x{w} eager: device busy {busy:.1f} ms, idle share {1 - busy / median:.3f} of the "
          f"untraced median {median:.1f} ms (traced wall {traced_wall:.1f} ms); {len(kernels)} kernels (alone: mono "
          f"stage {stage_kernels['mono']}, stereo stage {stage_kernels['stereo']}); launches by wrapper from the "
          f"trace {eager_counts}, K10 {want_k10}; aten::conv3d (the classifiers) {conv3d:.2f} device ms", flush=True)
    counts = defaultdict(int)
    for e in kernels:
        counts[re.sub(r"[<(].*", "", e.name.replace("(anonymous namespace)::", ""))[-48:]] += 1
    top = sorted(counts.items(), key=lambda kv: -kv[1])[:14]
    print("  launches by kernel: " + ", ".join(f"{n} {c}" for n, c in top), flush=True)
    by_family = defaultdict(float)
    for e in kernels:
        fam = next((f for f, pat in FAMILIES if re.search(pat, e.name, re.IGNORECASE)), "other")
        by_family[fam] += (e.time_range.end - e.time_range.start) / 1e3
    print("  device ms by family: " + ", ".join(f"{f} {ms:.2f}" for f, ms in
                                                sorted(by_family.items(), key=lambda kv: -kv[1])), flush=True)
    by_module = {name: kernels_within(kernels, spans[name]) for name in parts}
    if not any(spans.values()):
        print("  device ms by module: not measured (the profiler showed no ranges on the device)", flush=True)
        return graph_counts
    outer = sum(ms for name, ms in by_module.items() if name != "loop glue (pool/interp)")
    print("  device ms by module (busy time of the kernels inside each range): "
          + ", ".join(f"{n} {ms:.2f}" for n, ms in by_module.items())
          + f"; the rest {busy - outer:.2f} (the glue lies inside the loop)", flush=True)
    return graph_counts


GRAPH_FAILURES: list[str] = []


def same(what: str, got: torch.Tensor, want: torch.Tensor) -> bool:
    """Replay against eager: the same kernels and cuDNN algorithms on the
    same inputs, so max |delta| must be 0.  A difference is recorded and
    the run goes on, so that one call shows every phase; the run fails at
    its end."""
    err = (got.float() - want.float()).abs().max().item()
    ok = err == 0 and bool(torch.isfinite(got).all())
    print(f"  {what}: max |graph - eager| {err:.3e} px (held to 0), disparity max {want.abs().max().item():.3f}"
          + ("" if ok else "  MISMATCH"), flush=True)
    if not ok:
        GRAPH_FAILURES.append(f"{what}: the graph's disparity differs from eager's by {err}")
    return ok


def graph_phase(pipe, label: str, images: dict, rng) -> None:
    """Replay against eager at each shape: (1) the served request's images;
    (2) a second request of the shape with other images; (3) the first
    result intact after it."""
    for (h, w), (im2, im3) in images.items():
        first = pipe(im2, im3)
        kept = first.clone()
        if not same(f"graph {label} {h}x{w} (1) replay", first, eager(pipe, im2, im3)):
            # the same on a new pipeline over the same models, with cuDNN's
            # heuristics instead of its benchmarked algorithms
            torch.backends.cudnn.benchmark = False
            p = StereoAnywherePipeline(pipe.stereo, pipe.mono, ITERS, device="cuda")
            p(im2, im3)
            same(f"graph {label} {h}x{w} (1) replay, cuDNN heuristics (diagnostic)", p(im2, im3), eager(p, im2, im3))
            torch.backends.cudnn.benchmark = True
            del p
        other = [rng.uniform(0, 1, (1, h, w, 3)).astype(np.float32) for _ in range(2)]
        same(f"graph {label} {h}x{w} (2) second request, other images", pipe(*other), eager(pipe, *other))
        if not torch.equal(first, kept):
            raise AssertionError(f"{label} {h}x{w}: request 2 overwrote the result of request 1")
        print(f"  graph {label} {h}x{w} (3) request 1's result intact after request 2", flush=True)


def two_stage_phase(pipe, label: str, images: dict) -> None:
    """(4) two-stage mode on the same models: its two graphs on one pool
    against eager two-stage; and the device memory that a pipeline's graphs
    hold at one shape, one graph against the two-stage pair."""
    for (h, w), (im2, im3) in images.items():
        pools = {}
        for mode in ("one graph", "two-stage"):
            torch.cuda.empty_cache()
            p = StereoAnywherePipeline(pipe.stereo, pipe.mono, ITERS, device="cuda", two_stage=mode == "two-stage")
            p(im2, im3)
            got = p(im2, im3)
            programs = p._build_two_stage(1, h, w) if p.two_stage else (p._build(1, h, w),)
            pools[mode] = p.graph_pool_bytes()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            want = eager(p, im2, im3)
            peak = torch.cuda.max_memory_allocated() - base
            print(f"graph {label} {h}x{w} {mode}: pool {pools[mode] / 2 ** 30:.2f} GiB, capture "
                  + ", ".join(f"{g.capture_ms:.0f}" for g in programs) + f" ms; eager peak above the models "
                  f"{peak / 2 ** 30:.2f} GiB", flush=True)
            if p.two_stage:
                same(f"graph {label} {h}x{w} (4) two-stage replay", got, want)
            del p, programs
        print(f"graph {label} {h}x{w}: two-stage pool / one-graph pool {pools['two-stage'] / pools['one graph']:.3f}",
              flush=True)
    torch.cuda.empty_cache()


def reload_phase(pipe, label: str, images: dict) -> None:
    """(5) every parameter loaded anew (each scaled by 1 + 2% noise) with
    `load_state_dict`, then replay against eager at the new weights, which
    must also have moved the disparity; (6) then the device constants'
    cache filled with more than 128 other resize sizes, evicting every
    constant the graphs read, and replay against eager once more: after both."""
    before = {shape: pipe(*ims) for shape, ims in images.items()}
    g = torch.Generator(device="cuda").manual_seed(9)
    for model in (pipe.stereo, pipe.mono):
        state = {k: v * (1 + 0.02 * torch.randn(v.shape, device=v.device, generator=g)).to(v.dtype)
                 if v.is_floating_point() else v for k, v in model.state_dict().items()}
        model.load_state_dict(state)
    for (h, w), ims in images.items():
        got = pipe(*ims)
        moved = (got - before[h, w]).abs().max().item()
        print(f"  graph {label} {h}x{w} (5) after a weight load: the disparity moved by up to {moved:.3f} px", flush=True)
        if not moved > 0:
            raise AssertionError(f"{label} {h}x{w}: the replay did not see the new weights")
        same(f"graph {label} {h}x{w} (5) replay after a weight load", got, eager(pipe, *ims))
    x = torch.zeros((1, 1, 4, 4), device="cuda")
    for n in range(5, 5 + 130):
        resize_jax_image(x, (4, n), "bilinear")
    print(f"  constants' cache after 130 other sizes: {port_device._copied.cache_info()}", flush=True)
    for (h, w), ims in images.items():
        same(f"graph {label} {h}x{w} (6) replay after the cache evicted its constants", pipe(*ims), eager(pipe, *ims))


def pipeline_phase(label: str, cfg: StereoAnywhereConfig, encoder: str = "vitl",
                   extras: bool = True) -> tuple[dict, dict]:
    """Serve the full-width pipeline (DAv2 `encoder` + StereoAnywhere) over
    HTTP on its graphs, check the replays against eager, time the warm
    graph request against the eager one and trace both; with `extras`, the
    two-stage and weight-reload checks too.  Returns the wrappers' calls
    over the served requests, counted from 0 just before them, and the
    launches a replayed request makes, from its trace (None where the
    profiler saw none)."""
    torch.backends.cudnn.benchmark = True
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    pipe = build_pipeline(cfg, MonoConfig.for_encoder(encoder), iters=ITERS, device="cuda", seed=0)
    mono_bytes = sum(p.numel() * p.element_size() for p in pipe.mono.parameters())
    print(f"pipeline {label} built in {time.perf_counter() - t0:.1f} s (DAv2 {encoder} "
          f"({mono_bytes / 1e9:.2f} GB of weights) + StereoAnywhere, bf16, iters {ITERS}, graphs {pipe.graphs}, "
          f"{cfg})", flush=True)
    if not pipe.graphs:
        raise AssertionError("the pipeline does not take its graphs on the card")
    rec = _Recorder(pipe)
    server = make_http_server(rec, "127.0.0.1", 0)
    server.timeout = 900
    url = f"http://127.0.0.1:{server.server_address[1]}"
    rng = np.random.default_rng(0)
    # the first request of a shape runs eagerly (cuDNN's algorithm search
    # included) and captures the shape's graph; the second replays it.  The
    # server answers on this thread and the client asks from another, so
    # that every call of the pipeline runs on this thread: cuDNN keeps its
    # benchmarked algorithms a thread, and the eager calls held against the
    # replays below must find the algorithms the capture took
    shapes = [(512, 512), (512, 512), KITTI, KITTI]
    images = {}
    for f in COUNTERS.values():
        f.launches = 0
    try:
        for h, w in shapes:
            im2, im3 = (rng.uniform(0, 1, (h, w, 3)).astype(np.float32) for _ in range(2))
            images[(h, w)] = (im2[None], im3[None])
            answer = {}
            client = threading.Thread(target=lambda: answer.update(disp=infer_remote(url, im2, im3)))
            t0 = time.perf_counter()
            client.start()
            server.handle_request()
            client.join(timeout=60)
            if "disp" not in answer:
                raise AssertionError(f"{label} {h}x{w}: the HTTP request got no answer")
            disp = answer["disp"]
            program = pipe._build(1, h, w)
            print(f"request {label} {h}x{w}: {1e3 * (time.perf_counter() - t0):.1f} ms end to end "
                  f"({1e3 * rec.seconds[-1]:.1f} ms in the pipeline), wrapper calls {rec.launches[-1]}; capture "
                  f"{program.capture_ms:.0f} ms, the pipeline's graph pool {pipe.graph_pool_bytes() / 2 ** 30:.2f} GiB",
                  flush=True)
            out = rec.outputs[-1]
            if disp.shape != (h, w) or tuple(out.shape) != (1, h, w, 1) or not torch.isfinite(out).all():
                raise AssertionError(f"bad disparity for {h}x{w}: {tuple(out.shape)}, finite={bool(torch.isfinite(out).all())}")
            print(f"  disparity range [{out.min().item():.3f}, {out.max().item():.3f}] px", flush=True)
    finally:
        server.server_close()
    totals = {n: f.launches for n, f in COUNTERS.items()}
    # wrapper calls: the first request of a shape runs the forward twice
    # (the warm-up, then the capture), the replay calls no wrapper
    for n, want in EXPECTED[label].items():
        per = [launch[n] for launch in rec.launches]
        if per != [2 * want, 0] * 2:
            raise AssertionError(f"{label}: {n}'s wrapper ran {per} times per request, expected {[2 * want, 0] * 2}")

    print(f"pipeline {label}: device memory peak over the served requests {torch.cuda.max_memory_allocated() / 1e9:.2f} "
          f"GB (models, activations and the graphs' pool)", flush=True)
    totals["hourglass3d"] = k10_in_a_request(pipe, label, *images[KITTI])
    graph_phase(pipe, label, images, np.random.default_rng(1))
    replayed = {}
    for (h, w), (im2, im3) in images.items():
        replayed[h, w] = time_and_trace(pipe, label, h, w, im2, im3)
    if extras:
        two_stage_phase(pipe, label, images)
        reload_phase(pipe, label, images)
    print(f"pipeline {label}: device memory peak over the phase {torch.cuda.max_memory_allocated() / 1e9:.2f} GB",
          flush=True)
    return totals, next(iter(replayed.values()))


def compare_phase() -> None:
    """The card (kernels, TF32 off) against the CPU (plain versions): DAv2
    ViT-L in f32, the ViT-S pipelines in f32 and bf16."""
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
    # holds), f32 then bf16.  f32: pixel tolerance 1e-2 plus 1e-4 of the
    # disparity's magnitude.  bf16: the card and the CPU round at the same
    # points, from sums taken in other orders, and 4 GRU iterations carry
    # a bf16 ulp's difference far; the card's answer must lie within twice
    # bf16's own distance from the f32 answer (the larger of the card's and
    # the CPU's)
    rng = np.random.default_rng(2)
    im2, im3 = (rng.uniform(0, 1, (1, 64, 96, 3)).astype(np.float32) for _ in range(2))
    on_card, on_cpu = {}, {}
    for dtype in ("float32", "bfloat16"):
        for label, fused in (("default", "off"), ("fused", "on")):
            cfg = StereoAnywhereConfig(compute_dtype=dtype, fused_level0=fused)
            kw = dict(stereo_cfg=cfg, mono_cfg=MonoConfig.for_encoder("vits"), iters=4, mono_size=(56, 56), seed=5)
            pc, pg = build_pipeline(device="cpu", **kw), build_pipeline(device="cuda", graphs=False, **kw)
            on_cpu[label, dtype] = want = pc(im2, im3)
            before = step_fused.flow_head.launches
            on_card[label, dtype] = got = pg(im2, im3).cpu()
            if label == "fused" and step_fused.flow_head.launches - before != 3:
                raise AssertionError("the fused pipeline did not run its rotated bodies through the kernels")
            err, scale = (got - want).abs().max().item(), want.abs().max().item()
            if dtype == "float32":
                tol, how = 1e-2 + 1e-4 * scale, "1e-2 px + 1e-4 rel."
            else:
                gap = max((got - on_card[label, "float32"]).abs().max().item(),
                          (want - on_cpu[label, "float32"]).abs().max().item())
                tol, how = 2 * gap, f"2 x bf16's distance from f32, {gap:.3e}"
            print(f"pipeline {label} ViT-S 64x96 {dtype} iters 4, card vs CPU: max_abs_err {err:.3e} px "
                  f"(max|cpu| {scale:.3e}, tol {how})", flush=True)
            if not (torch.isfinite(got).all() and err <= tol):
                raise AssertionError(f"{label} {dtype} pipeline on the card disagrees with the CPU: {err}")
    err = (on_card["fused", "float32"] - on_card["default", "float32"]).abs().max().item()
    scale = on_card["default", "float32"].abs().max().item()
    print(f"pipeline ViT-S 64x96 f32 iters 4, fused vs default on the card: max_abs_err {err:.3e} px "
          f"(max|default| {scale:.3e})", flush=True)
    if not err <= 1e-2 + 1e-4 * scale:
        raise AssertionError(f"the fused pipeline disagrees with the default one on the card: {err}")


def _held(what: str, got: torch.Tensor, want: torch.Tensor, rel: float) -> None:
    """The card's result against the CPU's, within `rel` of max |CPU| (0:
    bit for bit), printed."""
    got, want = got.detach().float().cpu(), want.detach().float()
    err, scale = (got - want).abs().max().item(), want.abs().max().item()
    print(f"  {what}, card vs CPU: max_abs_err {err:.3e} (max|cpu| {scale:.3e}, tol "
          f"{'0, bit for bit' if rel == 0 else f'{rel:g} rel.'})", flush=True)
    if not (got.shape == want.shape and torch.isfinite(got).all() and err <= rel * scale):
        raise AssertionError(f"{what}: the card disagrees with the CPU by {err} (scale {scale})")


def variants_compare_phase() -> None:
    """The variants no shipped model uses, on the card against the CPU
    (TF32 off): the aggregation variant's ViT-S pipeline at 64x96 in f32
    (1e-2 px + 1e-4 rel., as phase 5's) and bf16 (twice bf16's own distance
    from f32); its mono stack and stereo hourglass alone in f32 (1e-4);
    then the standalone modules in f32 with seeded weights copied to the
    CPU: `DeformableConv2d` (offsets of a few pixels), `Feature`,
    `FeatureV4`, `MultiUpdateScalerBlock`, the scale/shift estimators,
    `upflow`, the Zadeh combinators (1e-4 for the networks and the deformable
    conv, 1e-5 for the rest), and `sgm_disparity` bit for bit (integer costs
    in f32)."""
    from stereoanywhere_tpu_torch.models.dcn import DeformableConv2d
    from stereoanywhere_tpu_torch.models.mobile_extractors import Feature, FeatureV4
    from stereoanywhere_tpu_torch.models.update import MultiUpdateScalerBlock
    from stereoanywhere_tpu_torch.ops import fuzzy, lsq, sgm
    from stereoanywhere_tpu_torch.ops.upsample import upflow

    strict_f32()
    rng = np.random.default_rng(70)
    im2, im3 = (rng.uniform(0, 1, (1, 64, 96, 3)).astype(np.float32) for _ in range(2))
    results = {}
    for dtype in ("float32", "bfloat16"):
        cfg = StereoAnywhereConfig(compute_dtype=dtype, **VARIANT)
        kw = dict(stereo_cfg=cfg, mono_cfg=MonoConfig.for_encoder("vits"), iters=4, mono_size=(56, 56), seed=71)
        pc, pg = build_pipeline(device="cpu", **kw), build_pipeline(device="cuda", graphs=False, **kw)
        want, (got, calls) = pc(im2, im3), counted(lambda: pg(im2, im3))
        results[dtype] = (got.cpu(), want)
        err, scale = (got.cpu() - want).abs().max().item(), want.abs().max().item()
        if dtype == "float32":
            tol, how = 1e-2 + 1e-4 * scale, "1e-2 px + 1e-4 rel."
        else:
            gap = max((got.cpu() - results["float32"][0]).abs().max().item(),
                      (want - results["float32"][1]).abs().max().item())
            tol, how = 2 * gap, f"2 x bf16's distance from f32, {gap:.3e}"
        print(f"pipeline variant ({VARIANT}) ViT-S 64x96 {dtype} iters 4, card vs CPU: max_abs_err {err:.3e} px "
              f"(max|cpu| {scale:.3e}, tol {how}); wrapper calls {calls}", flush=True)
        if not (torch.isfinite(got).all() and err <= tol):
            raise AssertionError(f"variant {dtype} pipeline on the card disagrees with the CPU: {err}")
        if calls["dual_lookup"] != 4 or calls["ln_dense"] != 12:
            raise AssertionError(f"variant {dtype}: wrapper calls {calls}, expected K1-K4 12 (ViT-S), K5 4")
    # the stereo model's variant outputs alone, f32
    cfg = StereoAnywhereConfig(**VARIANT)
    mc = StereoAnywhere(cfg, device="cpu", generator=torch.Generator().manual_seed(72))
    mg = StereoAnywhere(cfg, device="cuda", generator=torch.Generator().manual_seed(72))
    mg.load_state_dict(mc.state_dict())
    xs = [torch.from_numpy(rng.uniform(0, 1, (1, 64, 96, c)).astype(np.float32)) for c in (3, 3, 1, 1)]
    oc, og = mc(*xs, iters=1), mg(*[x.cuda() for x in xs], iters=1)
    for k in ("coarse_dispstereo2", "coarse_dispstereo3", "coarse_dispmono2"):
        _held(f"variant stereo model 64x96 f32 {k}", og[k], oc[k], 1e-4)
    del pc, pg, mc, mg

    g = torch.Generator().manual_seed(73)
    x = torch.randn(2, 32, 96, 128, generator=g)
    dcn = DeformableConv2d(32, 48, stride=1, bias=True)
    with torch.no_grad():
        dcn.offset_modulator_conv.weight.normal_(0, 0.1, generator=g)
        dcn.offset_modulator_conv.bias.normal_(0, 1.0, generator=g)
    dcn_g = DeformableConv2d(32, 48, stride=1, bias=True).cuda()
    dcn_g.load_state_dict(dcn.state_dict())
    with torch.no_grad():
        # 1e-4 as the networks': its sample positions come out of a conv
        # whose f32 sums the card orders otherwise, and a position's rounding
        # moves its sample by the image's gradient
        _held("DeformableConv2d 32->48 at 96x128, B 2", dcn_g(x.cuda()), dcn(x), 1e-4)
        img = torch.rand(1, 3, 128, 192, generator=g) * 2 - 1
        for name, make in (("Feature (MobileNetV2)", Feature), ("FeatureV4 (MobileNetV4-S)", FeatureV4)):
            # He fan-out weights, as the port's models draw theirs: the
            # outputs keep their scale through the trunk
            mc = init_weights(make(), torch.Generator().manual_seed(74))
            mg = make().cuda()
            mg.load_state_dict(mc.state_dict())
            for i, (a, b) in enumerate(zip(mg(img.cuda()), mc(img))):
                _held(f"{name} 128x192 output {i}", a, b, 1e-4)
        hd, (h, w) = 128, (64, 96)
        block = MultiUpdateScalerBlock((hd, hd, hd), 3, 36)
        block_g = MultiUpdateScalerBlock((hd, hd, hd), 3, 36).cuda()
        block_g.load_state_dict(block.state_dict())
        net = [torch.randn(1, hd, h // 2 ** i, w // 2 ** i, generator=g) for i in range(3)]
        inp = [tuple(torch.randn(1, hd, h // 2 ** i, w // 2 ** i, generator=g) for _ in range(3)) for i in range(3)]
        args = [torch.randn(1, 36, h, w, generator=g), torch.randn(1, 36, h, w, generator=g),
                torch.randn(1, 2, h, w, generator=g), torch.rand(1, 1, h, w, generator=g)]
        oc = block(net, inp, *args)
        og = block_g([n.cuda() for n in net], [tuple(t.cuda() for t in tr) for tr in inp], *[a.cuda() for a in args])
        for i, (a, b) in enumerate(zip(og[0], oc[0])):
            _held(f"MultiUpdateScalerBlock 64x96 net[{i}]", a, b, 1e-5)
        for name, a, b in zip(("lscale", "gscale", "gshift", "conf"), og[1:], oc[1:]):
            _held(f"MultiUpdateScalerBlock 64x96 delta_{name}", a, b, 1e-5)
        left = torch.rand(2, 96, 160, generator=g)
        right = torch.roll(left, -7, dims=2) + 0.02 * torch.randn(2, 96, 160, generator=g)
        t0 = time.perf_counter()
        dg = sgm.sgm_disparity(left.cuda(), right.cuda(), 48)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        dc = sgm.sgm_disparity(left, right, 48)
        _held(f"sgm_disparity 96x160, 48 disparities, B 2 ({ms:.0f} ms on the card, the first call; median "
              f"{dc[:, :, 48:].median().item():.0f} px)", dg, dc, 0)
        mde, conf = torch.rand(2, 2, 96, 128, generator=g), torch.rand(2, 2, 96, 128, generator=g)
        disp = mde * 40 + 3 + torch.randn(2, 2, 96, 128, generator=g)
        for name, fn, tol in (("normalized_scale_and_shift", lsq.normalized_scale_and_shift, 1e-4),
                              ("naive_scale_shift", lsq.naive_scale_shift, 1e-5)):
            for a, b in zip(fn(mde.cuda(), disp.cuda(), conf.cuda()), fn(mde, disp, conf)):
                _held(name, a, b, tol)
        flow = torch.randn(1, 1, 96, 128, generator=g)
        _held("upflow x4", upflow(flow.cuda()), upflow(flow), 1e-5)
        _held("fuzzy_and_zadeh", fuzzy.fuzzy_and_zadeh(mde.cuda(), conf.cuda()), fuzzy.fuzzy_and_zadeh(mde, conf), 1e-5)
        _held("fuzzy_or_zadeh", fuzzy.fuzzy_or_zadeh(mde.cuda(), conf.cuda()), fuzzy.fuzzy_or_zadeh(mde, conf), 1e-5)
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# The zero-shot evaluation path: `cli eval` on synthetic benchmark directories

# raw sizes of the synthetic scenes, in the readers' order: Middlebury's give
# two stereo buckets, (384, 512) and (512, 768) shared by the last two (a
# sample takes the smallest bucket that fits it, so the small scene comes
# first); KITTI's one, (384, 1280)
EVAL_SCENES = {"middlebury": [(375, 450), (497, 741), (486, 720)],
               "kitti2015": [(375, 1242), (370, 1224), (376, 1241), (374, 1238)]}
EVAL_TRIES = 2


def _scene(rng, h: int, w: int, max_disp: float):
    """A textured left view, the right view that sees it shifted by a smooth
    positive disparity, and that disparity."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    disp = (0.2 + 0.6 * xx / w + 0.1 * np.sin(yy / 17.0)) * max_disp
    coarse = rng.uniform(0, 255, (h // 6 + 2, w // 6 + 2, 3)).astype(np.uint8)
    left = np.asarray(Image.fromarray(coarse).resize((w, h), Image.BICUBIC), np.float32)
    left = np.clip(left + rng.normal(0, 8, left.shape), 0, 255).astype(np.uint8)
    src = np.clip(np.round(xx + disp).astype(np.int64), 0, w - 1)
    right = left[yy.astype(np.int64), src]
    return left, right, disp


def write_eval_dirs(root: Path, rng) -> dict[str, Path]:
    """Synthetic Middlebury and KITTI 2015 directories in the readers'
    layouts, with plausible gt, validity and occlusion masks."""
    out = {}
    d = root / "middlebury"
    for i, (h, w) in enumerate(EVAL_SCENES["middlebury"]):
        scene = d / f"scene{i}"
        scene.mkdir(parents=True)
        left, right, disp = _scene(rng, h, w, 120.0)
        gt = disp.copy()
        gt[:24, : w // 5] = np.inf  # no gt: the reader zeroes it
        mask = np.full((h, w), 255, np.uint8)
        mask[:, :40] = 128  # occluded at the left border
        mask[~np.isfinite(gt)] = 0
        Image.fromarray(left).save(scene / "im0.png")
        Image.fromarray(right).save(scene / "im1.png")
        Image.fromarray(mask).save(scene / "mask0nocc.png")
        write_pfm(str(scene / "disp0GT.pfm"), gt)
    out["middlebury"] = d
    d = root / "kitti2015"
    for sub in ("image_2", "image_3", "disp_occ_0", "disp_noc_0"):
        (d / sub).mkdir(parents=True)
    for i, (h, w) in enumerate(EVAL_SCENES["kitti2015"]):
        left, right, disp = _scene(rng, h, w, 90.0)
        lidar = (rng.uniform(size=(h, w)) < 0.3) & (np.arange(h)[:, None] > 0.4 * h)  # sparse, lower part
        occ = np.where(lidar, np.round(disp * 256), 0).astype(np.uint16)
        noc = occ.copy()
        noc[:, :30] = 0
        name = f"{i:06d}_10.png"
        Image.fromarray(left).save(d / "image_2" / name)
        Image.fromarray(right).save(d / "image_3" / name)
        Image.fromarray(occ).save(d / "disp_occ_0" / name)
        Image.fromarray(noc).save(d / "disp_noc_0" / name)
    out["kitti2015"] = d
    return out


class _EvalRecorder:
    """Instruments one `cli eval` run: the programs object it builds (with
    the graphs on or off and a capture policy), each program call's output,
    each sample's and each try's wall time, and the evaluator."""

    def __init__(self, graphs: bool, capture_at: int = 2):
        self.graphs, self.capture_at = graphs, capture_at
        self.programs = self.evaluator = None
        self.outputs: list[tuple[str, np.ndarray]] = []
        self.stereo_inputs: list[tuple] = []
        self.sample_ms: list[list[float]] = []
        self.try_s: list[float] = []

    @contextmanager
    def installed(self):
        rec = self
        base = eval_programs.EvalPrograms

        class Recording(base):
            def __init__(self, *a, **k):
                super().__init__(*a, **{**k, "graphs": rec.graphs, "capture_at": rec.capture_at})
                rec.programs = self

            def stereo_fn(self, *a):
                out = super().stereo_fn(*a)
                rec.outputs.append(("stereo", out))
                rec.stereo_inputs.append(a)
                return out

            def mono_fn(self, *a):
                out = super().mono_fn(*a)
                rec.outputs.append(("mono", out))
                return out

        run, run_sample = harness.Evaluator.run, harness.Evaluator.run_sample

        def timed_run(ev, *a, **k):
            rec.evaluator = ev
            rec.sample_ms.append([])
            t0 = time.perf_counter()
            try:
                return run(ev, *a, **k)
            finally:
                rec.try_s.append(time.perf_counter() - t0)

        def timed_sample(ev, sample):
            t0 = time.perf_counter()
            try:
                return run_sample(ev, sample)
            finally:
                rec.sample_ms[-1].append(1e3 * (time.perf_counter() - t0))

        eval_programs.EvalPrograms = Recording
        harness.Evaluator.run, harness.Evaluator.run_sample = timed_run, timed_sample
        try:
            yield self
        finally:
            eval_programs.EvalPrograms = base
            harness.Evaluator.run, harness.Evaluator.run_sample = run, run_sample


def run_cli_eval(argv: list[str], rec: _EvalRecorder, show: bool = False) -> dict:
    """`cli.main(argv)` with the recorder installed; returns its means.  Its
    printout is shown only with `show`."""
    with rec.installed(), redirect_stdout(sys.stdout if show else io.StringIO()):
        return cli.main(argv)


def same_metrics(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(a[k] == b[k] or (np.isnan(a[k]) and np.isnan(b[k])) for k in a)


# the host's parts of one sample, each a range in the trace (decode and the
# programs are ranged where they are called)
HOST_PARTS = {
    "resize and normalise": [(harness, n) for n in ("resize_np", "joint_minmax_np", "pad_to_shape", "unpad")],
    "metrics": [(harness, "guided_metrics"), (harness, "depth_metrics")],
}


def trace_repeat_sample(rec: _EvalRecorder, ds, index: int, label: str) -> None:
    """One more visit of a sample on the warm programs, traced: device busy
    ms and idle share of its wall time, and the host ms of its parts:
    decode, resize and normalise, the programs (their host work, the copies
    and the wait for the card), metrics."""
    ev = rec.evaluator
    stereo_fn, mono_fn = ev.stereo_fn, ev.mono_fn

    def in_range(fn):
        def call(*a):
            with record_function("programs"):
                return fn(*a)
        return call

    ev.stereo_fn, ev.mono_fn = in_range(stereo_fn), in_range(mono_fn)
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof, module_ranges(HOST_PARTS):
            t0 = time.perf_counter()
            with record_function("decode"):
                sample = ds[index]
            ev.run_sample(sample)
            torch.cuda.synchronize()
            wall = 1e3 * (time.perf_counter() - t0)
    finally:
        ev.stereo_fn, ev.mono_fn = stereo_fn, mono_fn
    events = prof.events()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA and e.name not in
               ("decode", "programs", *HOST_PARTS)]
    host = defaultdict(float)
    for e in events:
        if e.device_type == DeviceType.CPU and e.name in ("decode", "programs", *HOST_PARTS):
            host[e.name] += (e.time_range.end - e.time_range.start) / 1e3
    busy = busy_us([(e.time_range.start, e.time_range.end) for e in kernels]) / 1e3 if kernels else None
    idle = "not measured" if busy is None else f"{1 - busy / wall:.3f}"
    print(f"eval trace {label} sample {index} (a repeat, graphs; decoder {decoders()}): wall {wall:.1f} ms, "
          f"device busy ms "
          f"{fmt(busy)}, idle share {idle}, {len(kernels)} kernels; host ms by part: "
          + ", ".join(f"{k} {host.get(k, 0.0):.1f}" for k in ("decode", "resize and normalise", "programs", "metrics"))
          + f"; the rest {wall - sum(host.values()):.1f}", flush=True)


def eval_phase() -> dict:
    """`cli eval` at ViT-L and the default stereo widths, bf16, 32 GRU
    iterations, 2 tries, over the synthetic Middlebury and KITTI 2015
    directories, as a user runs it: eagerly (the reference), on its graphs
    (a key captures at its second call; the kernel wrappers' calls counted
    from 0 over this run), eagerly again, then with every key captured at
    its first call, in turns a dataset.  Checks every program output of the
    later runs against the first's (max |delta| = 0) and the metrics alike;
    prints the
    per-sample first-visit and repeat ms, the buckets, mono shapes and
    captures, the pool, and one traced repeat sample a dataset.  Returns
    the wrappers' calls over the main runs."""
    from stereoanywhere_tpu_torch.data.datasets import fetch_dataset

    # what the CLI runs: PyTorch's defaults (convolutions in TF32, products in f32; the bf16 model runs its
    # hourglass past the first gate in f32), cuDNN's heuristics
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cudnn.benchmark = False
    tmp = Path(tempfile.mkdtemp(prefix="sa_eval_"))
    launches = {n: 0 for n in COUNTERS}
    try:
        dirs = write_eval_dirs(tmp, np.random.default_rng(0))
        dav2 = tmp / "dav2_vitl.pth"
        torch.save(DepthAnythingV2(MonoConfig.for_encoder("vitl"), device="cpu",
                                   generator=torch.Generator().manual_seed(11)).state_dict(), dav2)
        for dataset, root in dirs.items():
            size = harness.DAV2_SIZES[dataset]
            argv = ["eval", "--dataset", dataset, "--datapath", str(root), "--mono-checkpoint", str(dav2),
                    "--dtype", "bfloat16", "--iters", str(ITERS), "--tries", str(EVAL_TRIES),
                    "--csv", str(tmp / f"{dataset}.csv")]
            reference = None
            # the first run, eager, takes the process's first costs at these shapes (allocations, cuDNN's
            # heuristics); it is the reference every later run's outputs are held to
            for label, graphs, capture_at in (("cold, eager", False, 2), ("graphs", True, 2), ("eager", False, 2),
                                              ("graphs, capture at 1st", True, 1)):
                rec = _EvalRecorder(graphs, capture_at)
                for f in COUNTERS.values():
                    f.launches = 0
                t0 = time.perf_counter()
                means = run_cli_eval(argv, rec, show=label == "graphs")
                total = time.perf_counter() - t0
                calls = {n: f.launches for n, f in COUNTERS.items()}
                n = len(EVAL_SCENES[dataset])
                first, repeat = rec.sample_ms[0], rec.sample_ms[-1]
                print(f"eval {dataset} ({label}): {total:.1f} s in cli.main (models loaded and built included); "
                      f"per-sample ms, first visit {[round(x, 1) for x in first]}, repeat "
                      f"{[round(x, 1) for x in repeat]}; tries {[round(s, 2) for s in rec.try_s]} s; "
                      f"pairs a second over try {EVAL_TRIES}: {n / rec.try_s[-1]:.2f}; wrapper calls {calls}",
                      flush=True)
                p = rec.programs
                if graphs:
                    keys = sorted(p.programs, key=str)
                    print(f"  programs: " + "; ".join(
                        f"{k[0]} {k[-3]}x{k[-2]}"
                        + (f" (T {tokens_of(k[-3], k[-2], size)})" if k[0] == "mono" else "")
                        + f": capture {p.programs[k].capture_ms:.0f} ms" for k in keys)
                        + f"; pool {p.graph_pool_bytes() / 2 ** 30:.2f} GiB", flush=True)
                    stereo_keys = sorted({k[-3:-1] for k in keys if k[0] == "stereo"})
                    want_keys = sorted(set(rec.evaluator.bucketer.buckets))
                    if stereo_keys != want_keys or not all(p.programs[k].graph is not None for k in keys):
                        raise AssertionError(f"eval {dataset}: stereo programs {stereo_keys}, buckets {want_keys}")
                if label == "graphs":
                    # the main path: every key runs its body twice (the warm-up, the capture), every later call
                    # replays; DAv2 (K1-K4) once a block, the stereo loop K5 once an iteration
                    n_mono = sum(k[0] == "mono" for k in p.programs)
                    n_stereo = sum(k[0] == "stereo" for k in p.programs)
                    want = {**{k: 2 * n_mono * VIT_L["depth"] for k in ("ln_dense", "vit_attention",
                                                                          "dense_scale_residual", "vit_mlp")},
                            "dual_lookup": 2 * n_stereo * ITERS}
                    want = {k: want.get(k, 0) for k in COUNTERS}
                    if calls != want:
                        raise AssertionError(f"eval {dataset}: the wrappers ran {calls}, expected {want}")
                    for k, v in calls.items():
                        launches[k] += v
                    print(f"  metrics: " + ", ".join(f"{k} {v:.4f}" for k, v in means.items()
                                                     if k in ("bad 2.0", "bad 3.0", "avgerr", "rms", "noc avgerr",
                                                              "occ avgerr")), flush=True)
                    if not all(np.isfinite(means[k]) for k in ("avgerr", "rms", "bad 2.0")):
                        raise AssertionError(f"eval {dataset}: non-finite metrics {means}")
                    outputs = len(rec.outputs)  # the eval's program calls, the traced one left out
                    trace_repeat_sample(rec, fetch_dataset(dataset, str(root)), 0, dataset)
                    del rec.outputs[outputs:]
                if reference is None:
                    reference = (rec.outputs, means)
                else:
                    if [k for k, _ in rec.outputs] != [k for k, _ in reference[0]]:
                        raise AssertionError(f"eval {dataset} ({label}): another sequence of program calls")
                    err = max(float(np.abs(a - b).max()) for (_, a), (_, b) in zip(rec.outputs, reference[0]))
                    same = same_metrics(means, reference[1])
                    ok = err == 0 and same
                    print(f"  against the first run: max |delta| over {len(rec.outputs)} program outputs {err:.3e} "
                          f"(held to 0); metrics {'equal' if same else 'DIFFER'}" + ("" if ok else "  MISMATCH"),
                          flush=True)
                    if not ok:
                        GRAPH_FAILURES.append(f"eval {dataset} {label}: outputs differ by {err}")
                rec.programs = rec.evaluator = None
                del p
                torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return launches


def one_rounding(x: np.ndarray, rng) -> np.ndarray:
    """x with every element moved by one rounding: scaled by 1 +- 2^-24 in
    f64, rounded back to f32."""
    return (x.astype(np.float64) * (1 + rng.choice([-1.0, 1.0], x.shape) * 2.0 ** -24)).astype(np.float32)


# one scene since the camera phase came (two before): the CPU's DAv2 at Middlebury's DAv2 size is most of the
# phase's time
EVAL_COMPARE_SCENES = 1


def eval_compare_phase() -> None:
    """`cli eval` on the card against the CPU: f32 with TF32 off, ViT-S,
    4 GRU iterations, a one-scene 96x160 Middlebury directory (the CPU runs
    the kernels' plain versions).  avgerr and rms within 1e-3 relative;
    disparity within 1e-2 px + 1e-4 of its magnitude, or within twice the
    CPU's own move when its stereo inputs take one rounding, if that is
    larger (measured here: the model amplifies f32 rounding past that
    bound).  Printed beside: the mono depth's error, and the stereo
    program's on the CPU run's inputs."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    tmp = Path(tempfile.mkdtemp(prefix="sa_eval_cmp_"))
    try:
        rng = np.random.default_rng(1)
        for i in range(EVAL_COMPARE_SCENES):
            scene = tmp / "mb" / f"scene{i}"
            scene.mkdir(parents=True)
            left, right, disp = _scene(rng, 96, 160, 30.0)
            Image.fromarray(left).save(scene / "im0.png")
            Image.fromarray(right).save(scene / "im1.png")
            write_pfm(str(scene / "disp0GT.pfm"), disp)
        torch.save(DepthAnythingV2(MonoConfig.for_encoder("vits"), device="cpu",
                                   generator=torch.Generator().manual_seed(12)).state_dict(), tmp / "dav2.pth")
        argv = ["eval", "--dataset", "middlebury", "--datapath", str(tmp / "mb"), "--mono-checkpoint",
                str(tmp / "dav2.pth"), "--mono-encoder", "vits", "--iters", "4"]
        recs, means = {}, {}
        for device in ("cuda", "cpu"):
            recs[device] = _EvalRecorder(graphs=device == "cuda")
            t0 = time.perf_counter()
            means[device] = run_cli_eval(argv + ["--device", device], recs[device])
            print(f"eval card vs CPU: {device} run {time.perf_counter() - t0:.1f} s", flush=True)
        mc, mp = means["cuda"], means["cpu"]
        out = {d: {k: [o for kk, o in r.outputs if kk == k] for k in ("mono", "stereo")} for d, r in recs.items()}
        dc, dp = out["cuda"]["stereo"], out["cpu"]["stereo"]
        err = max(float(np.abs(a - b).max()) for a, b in zip(dc, dp))
        scale = max(float(np.abs(b).max()) for b in dp)
        # the parts: the mono program alone, and the stereo program alone on the CPU run's inputs
        mono_rel = max(float(np.abs(a - b).max() / np.abs(b).max()) for a, b in zip(out["cuda"]["mono"],
                                                                                  out["cpu"]["mono"]))
        alone = [recs["cuda"].programs.stereo_fn(*a) for a in recs["cpu"].stereo_inputs]
        alone_err = max(float(np.abs(a - b).max()) for a, b in zip(alone, dp))
        # the CPU's own distance when every input element moves by one rounding, over three draws: the stereo
        # model with random weights carries an ulp of its inputs to about 1e-4 of the disparity here, so a
        # bound under it holds no f32 implementation, the CPU's included
        floor = 0.0
        for k in range(3):
            r = np.random.default_rng(100 + k)
            for a, b in zip(recs["cpu"].stereo_inputs, dp):
                moved = recs["cpu"].programs.stereo_fn(*[one_rounding(x, r) for x in a])
                floor = max(floor, float(np.abs(moved - b).max()))
        print(f"eval card vs CPU, the parts: mono depth max_abs_err / max|cpu| {mono_rel:.3e}; the stereo program "
              f"on the CPU run's inputs: max_abs_err {alone_err:.3e} px; the CPU's own move under one rounding of "
              f"its stereo inputs: {floor:.3e} px", flush=True)
        tol = max(1e-2 + 1e-4 * scale, 2 * floor)
        rel = {k: abs(mc[k] - mp[k]) / max(abs(mp[k]), 1e-12) for k in ("avgerr", "rms")}
        print(f"eval card vs CPU, ViT-S f32 TF32 off, {EVAL_COMPARE_SCENES} scene(s) 96x160, iters 4: disparity "
              f"max_abs_err {err:.3e} px "
              f"(max|cpu| {scale:.3e}; tol {tol:.3e}, the larger of 1e-2 px + 1e-4 rel. and twice the CPU's own "
              f"move); avgerr {mc['avgerr']:.5f} / {mp['avgerr']:.5f}, rms {mc['rms']:.5f} / {mp['rms']:.5f} "
              f"(rel. {rel['avgerr']:.2e}, {rel['rms']:.2e}, tol 1e-3)", flush=True)
        if not (len(dc) == len(dp) == EVAL_COMPARE_SCENES and err <= tol and max(rel.values()) <= 1e-3):
            raise AssertionError("cli eval on the card disagrees with the CPU")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# DAv2 ViT-G: K1-K3 at D 1536, 24 heads of 64


def vitg_kernel_phase() -> dict:
    """K1-K3 at ViT-G's widths (D 1536, QKV N 4608, 24 heads of 64) and the
    token counts of the 512^2 and 375x1242 requests, in bf16 and f32,
    against their plain versions, timed beside the cuBLAS product and SDPA
    with their bounds; and the bf16 launch geometry.  Returns the bf16 rows
    at T = 1370."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator().manual_seed(20)
    t512, tkitti = tokens_of(512, 512), tokens_of(*KITTI)
    records = {}
    for dtype in (torch.bfloat16, torch.float32):
        for t in (t512, tkitti):
            rows = vit_kernel_rows(dtype, t, g, VIT_G, "ViT-G ")
            if dtype == torch.bfloat16 and t == t512:
                records = rows
    launch_geometry(t512, tkitti, vit=VIT_G, label="ViT-G ")
    return records


def vitg_compare_phase() -> None:
    """DAv2 ViT-G (depth 40, random weights drawn on the card) in f32 with
    TF32 off at 140x140, on the card against a CPU copy of the same
    weights: the taken layers' tokens and the depth before the head's last
    ReLU, each within 1e-4 of its magnitude (as ViT-L in compare_phase)."""
    import copy

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    t0 = time.perf_counter()
    gpu = DepthAnythingV2(MonoConfig.for_encoder("vitg"), device="cuda", generator=torch.Generator().manual_seed(13))
    torch.cuda.synchronize()
    built = time.perf_counter() - t0
    cpu = copy.deepcopy(gpu).cpu()
    x = torch.from_numpy(np.random.default_rng(5).normal(0, 1, (2, 140, 140, 3)).astype(np.float32))
    layers = INTERMEDIATE_LAYER_IDX["vitg"]
    t0 = time.perf_counter()
    with torch.no_grad():
        want = torch.cat([t for t, _ in cpu.pretrained(x.permute(0, 3, 1, 2), layers)])
        cpu_s = time.perf_counter() - t0
        got = torch.cat([t for t, _ in gpu.pretrained(x.cuda().permute(0, 3, 1, 2), layers)]).cpu()
    err, scale = (got - want).abs().max().item(), want.abs().max().item()
    print(f"DAv2 ViT-G 140x140 f32 backbone tokens (40 blocks; built on the card in {built:.1f} s, the CPU's "
          f"backbone {cpu_s:.1f} s), card vs CPU: max_abs_err {err:.3e} (max|cpu| {scale:.3e})", flush=True)
    if not (scale > 0 and err <= 1e-4 * scale):
        raise AssertionError(f"the ViT-G backbone on the card disagrees with the CPU: {err} (scale {scale})")
    for m in (cpu, gpu):
        m.depth_head.scratch.output_conv2[3] = torch.nn.Identity()
    want, got = cpu(x), gpu(x.cuda()).cpu()
    err, scale = (got - want).abs().max().item(), want.abs().max().item()
    print(f"DAv2 ViT-G 140x140 f32 depth before the last ReLU, card vs CPU: max_abs_err {err:.3e} "
          f"(max|cpu| {scale:.3e})", flush=True)
    if not (scale > 0 and err <= 1e-4 * scale):
        raise AssertionError(f"DAv2 ViT-G on the card disagrees with the CPU: {err} (scale {scale})")
    del gpu, cpu
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# high-resolution inference on one card: row tiles and vol_downsample at
# 1024^2 (the paths of tools/profile_highres.py), and Booster's full
# 3008 x 4112 through the mono stage and the booster preset's 8 row tiles

HIGHRES = (1024, 1024)
BOOSTER = (3008, 4112)
HIGHRES_ROUNDS, BOOSTER_ROUNDS = 5, 2
# checks that fail the run at the end of the phase, so that one call shows them all
HIGHRES_FAILURES: list[str] = []
A100_REFERENCE = ("the reference's published figure (paper Table 7, one A100, 1024x1024): stereo branch 0.61 s "
                  "(0.63 s with DAv2), peak 6.31 GB")


def k5_in_a_replay(fn) -> int | None:
    """K5's launches in one traced call of fn, read from the kernels' names
    (the trace that kept the most kernels of three); None if the profiler
    saw no device events."""
    tries = [traced(fn) for _ in range(3)]
    _, kernels, _ = max(tries, key=lambda t: len(t[1]))
    return trace_launches(e.name for e in kernels)["dual_lookup"] if kernels else None


def mono_and_lookup_calls(k5: int) -> dict:
    """The wrapper calls of a request with ViT-L's mono stage (K1-K4 once a
    block) and k5 lookups."""
    return {**{n: 0 for n in COUNTERS}, **{n: VIT_L["depth"] for n in ("ln_dense", "vit_attention",
                                                                      "dense_scale_residual", "vit_mlp")},
            "dual_lookup": k5}


def counted(fn):
    """(fn(), each wrapper's calls during it), the counts set to 0 just
    before and read just after."""
    for f in COUNTERS.values():
        f.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {n: f.launches for n, f in COUNTERS.items()}


def highres_phase() -> tuple[dict, dict]:
    """The high-resolution paths, ViT-L and the default stereo widths in
    bf16, 32 iterations, seeded random weights, cuDNN's heuristics, TF32
    off.  Returns the wrappers' calls in one eager 1024^2 request (the mono
    stage, then 2 sequential row tiles) and in one Booster request."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    torch.cuda.empty_cache()
    cfg = StereoAnywhereConfig(compute_dtype="bfloat16")
    full = build_pipeline(cfg, MonoConfig.for_encoder("vitl"), iters=ITERS, device="cuda", seed=0)
    stereo, mono = full.stereo, full.mono
    voldown = StereoAnywhere(StereoAnywhereConfig(compute_dtype="bfloat16", vol_downsample=1), device="cuda")
    voldown.load_state_dict(stereo.state_dict())
    print(f"highres: {card_line()}; ViT-L + StereoAnywhere bf16, iters {ITERS}, cuDNN heuristics, TF32 off; "
          f"beside {A100_REFERENCE}", flush=True)
    launches = highres_1024(full, voldown)
    # the 1024^2 programs' graphs live in reference cycles (a program's body
    # refers to its owner): collected here, so that their pools go
    del voldown
    gc.collect()
    torch.cuda.empty_cache()
    booster = booster_request(stereo, mono)
    del full, stereo, mono
    gc.collect()
    torch.cuda.empty_cache()
    print(f"highres: device memory reserved after the phase, its graphs dropped: {torch.cuda.memory_reserved() / 1e9:.2f} "
          "GB", flush=True)
    voldown_compare()
    if HIGHRES_FAILURES:
        raise AssertionError("high-resolution checks failed: " + "; ".join(HIGHRES_FAILURES))
    return launches, booster


def highres_1024(full, voldown) -> dict:
    """tools/profile_highres.py's paths at 1024^2 on the stereo branch:
    direct (the pipeline's stereo stage), tiles2 and tiles4 (sequential row
    tiles, overlap 64), tiles2 batched, and voldown (vol_downsample=1); each
    on its graph and eagerly.  Checks: replay = eager (0) on every path,
    batched vs sequential tiles (`batched_vs_sequential`), one tile against
    the direct path within 1e-3 px + 5e-5 rel.  Returns the wrappers' calls of one
    eager request with the mono stage and 2 sequential tiles."""
    h, w = HIGHRES
    rng = np.random.default_rng(40)
    im2, im3 = (torch.from_numpy(rng.uniform(0, 1, (1, h, w, 3)).astype(np.float32)).cuda() for _ in range(2))
    mde2, mde3 = (torch.from_numpy(rng.uniform(0, 1, (1, h, w, 1)).astype(np.float32)).cuda() for _ in range(2))
    stereo = full.stereo
    pipes = {"direct": StereoAnywherePipeline(stereo, None, ITERS, device="cuda"),
             "voldown": StereoAnywherePipeline(voldown, None, ITERS, device="cuda")}
    tiles = {"tiles2": TileParallelInference(stereo, 2, 64, ITERS, sequential=True, device="cuda"),
             "tiles4": TileParallelInference(stereo, 4, 64, ITERS, sequential=True, device="cuda"),
             "tiles2 batched": TileParallelInference(stereo, 2, 64, ITERS, sequential=False, device="cuda")}
    paths = {}  # name -> (owner, the request, K5 launches a request)
    for name, p in pipes.items():
        paths[name] = (p, lambda p=p: p(im2, im3, mde2, mde3), ITERS)
    for name, tp in tiles.items():
        n = tp.n_tiles if tp.sequential else 1
        paths[name] = (tp, lambda tp=tp: tp.stereo_stage(im2, im3, mde2, mde3), ITERS * n)
    for name, tp in tiles.items():
        plan = plan_row_tiles(h, tp.n_tiles, tp.overlap)
        print(f"highres {name}: tile_h {plan.tile_h}, starts {plan.starts}, overlap {plan.overlap}; a tile's plane "
              f"{plan.tile_h // 4} x {w // 4}", flush=True)

    outputs = {}
    for name, (owner, request, k5) in paths.items():
        torch.cuda.reset_peak_memory_stats()
        first = sync_ms(request)  # warm-up, capture, replay
        program = owner._build(1, h, w) if name in pipes else owner._build(plan_row_tiles(h, owner.n_tiles,
                                                                                          owner.overlap), w)
        got = request()
        want = eagerly(owner, request)
        outputs[name] = want
        same(f"highres {name} replay", got, want)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        eagerly(owner, request)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        replayed = k5_in_a_replay(request)
        print(f"highres {name} {h}x{w}: first call {first:.1f} ms (capture {program.capture_ms:.0f} ms); eager "
              f"request's device memory peak {peak / 1e9:.2f} GB ({(peak - base) / 1e9:.2f} GB above what was "
              f"resident, {base / 1e9:.2f} GB); graph pool {owner.graph_pool_bytes() / 1e9:.2f} GB; K5 in a "
              f"replay's trace {replayed if replayed is not None else 'not measured'} (expected {k5})", flush=True)
        if replayed is not None and replayed != k5:
            raise AssertionError(f"highres {name}: the replay launched K5 {replayed} times, expected {k5}")
        print(f"  disparity range [{want.min().item():.3f}, {want.max().item():.3f}] px", flush=True)
        if tuple(want.shape) != (1, h, w, 1) or not torch.isfinite(want).all():
            raise AssertionError(f"highres {name}: bad disparity {tuple(want.shape)}")

    times = {f"{name} {mode}": [] for name in paths for mode in ("graph", "eager")}
    for _ in range(HIGHRES_ROUNDS):
        for name, (owner, request, _) in paths.items():
            times[f"{name} graph"].append(sync_ms(request))
            times[f"{name} eager"].append(sync_ms(lambda: eagerly(owner, request)))
    print(f"highres {h}x{w} stereo branch, warm request ms, median [min-max] of {HIGHRES_ROUNDS} interleaved "
          "rounds: " + "; ".join(f"{k} {np.median(v):.1f} [{min(v):.1f}-{max(v):.1f}]" for k, v in times.items()),
          flush=True)

    # JAX's own check of the two modes (tests/test_parallel.py): f32, 2
    # iterations, (1, 128, 64), 2 tiles of 96 rows, 1e-3 px; then at 1024^2
    small = StereoAnywhere(StereoAnywhereConfig(), device="cuda", generator=torch.Generator().manual_seed(44))
    xs = [torch.from_numpy(rng.uniform(0, 1, (1, 128, 64, c)).astype(np.float32)).cuda() for c in (3, 3, 1, 1)]
    out = [TileParallelInference(small, 2, 32, 2, sequential=s, device="cuda", graphs=False).infer(*xs)
           for s in (False, True)]
    err = (out[0] - out[1]).abs().max().item()
    print(f"highres tiles2 batched vs sequential, f32, 2 iterations, 128x64: max |delta| {err:.3e} px "
          f"(max {out[1].abs().max().item():.1f} px; tol 1e-3)", flush=True)
    if not err <= 1e-3:
        HIGHRES_FAILURES.append(f"batched and sequential tiles disagree by {err} px (f32, 2 iterations, 128x64)")
    batched_vs_sequential(stereo, (im2, im3, mde2, mde3))
    one = TileParallelInference(stereo, 1, 0, ITERS, device="cuda", graphs=False)
    got = one.stereo_stage(im2, im3, mde2, mde3)
    want = outputs["direct"]
    err = (got - want).abs().max().item()
    excess = ((got - want).abs() - (1e-3 + 5e-5 * want.abs())).max().item()
    print(f"highres one tile vs direct: max |delta| {err:.3e} px (tol 1e-3 px + 5e-5 rel.)", flush=True)
    if excess > 0:
        HIGHRES_FAILURES.append(f"one tile disagrees with the direct path by {err} px")

    # the slice's path at 1024^2, counted: the mono stage, then 2 sequential tiles
    tp = tiles["tiles2"]

    def request():
        return tp.stereo_stage(im2, im3, *full.mono_stage(im2, im3))
    _, launches = counted(lambda: eagerly(tp, request))
    want = mono_and_lookup_calls(2 * ITERS)
    print(f"highres {h}x{w} request with the mono stage and 2 sequential tiles, eager: wrapper calls {launches}",
          flush=True)
    if launches != want:
        raise AssertionError(f"highres request: wrapper calls {launches}, expected {want}")
    ms = [(sync_ms(lambda: full.mono_stage(im2, im3)), sync_ms(request)) for _ in range(3)]
    print(f"highres {h}x{w} request with the mono stage (tiles2 on its graph): mono stage "
          f"{np.median([m for m, _ in ms]):.1f} ms, whole request {np.median([r for _, r in ms]):.1f} ms (median of 3)",
          flush=True)
    return launches


BATCHED_ITERS = (1, 2, 4, 8, 32)


def batched_vs_sequential(stereo, request) -> None:
    """tiles2 batched against tiles2 sequential at 1024^2, eagerly, in bf16
    and in f32 (the same weights; TF32 off) at each of BATCHED_ITERS
    iterations.  At B = 2 cuDNN may take other algorithms than at B = 1,
    so the two modes round differently, and the forward of random weights
    carries that difference far.  The witness that it is rounding and not
    a tile defect: in f32, the sequential output's move when the left view
    moves by one ulp (`nextafter`).  Held: in f32 at 1 iteration within
    1e-3 px (JAX's bound, tests/test_parallel.py), and at 1, 2 and 4
    iterations within 10x the one-ulp move."""
    f32 = StereoAnywhere(StereoAnywhereConfig(), device="cuda")
    f32.load_state_dict(stereo.state_dict())
    ulp = (torch.nextafter(request[0], torch.full_like(request[0], 2.0)), *request[1:])

    def tiles(model, iters, sequential, views):
        return TileParallelInference(model, 2, 64, iters, sequential=sequential, device="cuda",
                                     graphs=False).stereo_stage(*views)
    gaps = {}
    for label, model in (("bf16", stereo), ("f32", f32)):
        for iters in BATCHED_ITERS:
            seq = tiles(model, iters, True, request)
            moved = (tiles(model, iters, True, ulp) - seq).abs().max().item() if label == "f32" else None
            gaps[label, iters] = ((tiles(model, iters, False, request) - seq).abs().max().item(), moved,
                                  seq.abs().max().item())
    print(f"highres tiles2 batched vs sequential {HIGHRES[0]}x{HIGHRES[1]}, eager, by iterations: max |delta| px "
          "[the sequential output's move for one ulp of the left view] (max |sequential| px): " + "; ".join(
              f"{label} {iters}: {d:.3e}" + (f" [{m:.3e}]" if m is not None else "") + f" ({big:.1f})"
              for (label, iters), (d, m, big) in gaps.items()), flush=True)
    err = gaps["f32", 1][0]
    print(f"highres tiles2 batched vs sequential, f32, 1 iteration: max |delta| {err:.3e} px (tol 1e-3)", flush=True)
    if not err <= 1e-3:
        HIGHRES_FAILURES.append(f"batched and sequential tiles disagree by {err} px (f32, 1 iteration, 1024^2)")
    for iters in (1, 2, 4):
        d, m, _ = gaps["f32", iters]
        if not d <= 10 * m:
            HIGHRES_FAILURES.append(f"batched vs sequential {d} px at {iters} iterations, beyond 10x the one-ulp "
                                    f"move {m} px (f32, 1024^2)")
    del f32

def booster_request(stereo, mono) -> dict:
    """Booster at full resolution: a synthetic 3008 x 4112 pair through the
    mono stage at Booster's DAv2 size, joint min-max, pad, the booster
    preset's 8 sequential row tiles, the stitch and unpad.  Eager first
    (stage latencies, the memory peak, the wrappers' calls, counted), then
    on its graph (capture, replays held to the eager result).  Returns the
    wrappers' calls in one request."""
    h, w = BOOSTER
    free, total = torch.cuda.mem_get_info()
    print(f"booster: device memory before the request: {torch.cuda.memory_allocated() / 1e9:.2f} GB allocated, "
          f"{torch.cuda.memory_reserved() / 1e9:.2f} GB reserved", flush=True)
    picked = select_tiling_parameters(h, w)
    preset = get_preset_for_dataset("booster")
    plan = plan_row_tiles(h, preset.n_tiles, preset.overlap)
    size = harness.DAV2_SIZES["booster"]
    fh, fw = dav2_input_size(h, w, *size)
    print(f"booster {h}x{w}: preset {preset.n_tiles} tiles, overlap {preset.overlap} -> tile_h {plan.tile_h}, "
          f"starts {plan.starts}; select_tiling_parameters picks {picked.n_tiles} tiles, overlap {picked.overlap} "
          f"from {free / 2 ** 30:.1f} GiB free of {total / 2 ** 30:.1f}; DAv2 at {fh}x{fw} "
          f"(T = {tokens_of(h, w, size)} tokens a view)", flush=True)
    pipe = StereoAnywherePipeline(stereo, mono, ITERS, mono_size=size, device="cuda", graphs=False)
    tp = TileParallelInference(stereo, preset.n_tiles, preset.overlap, ITERS, sequential=True, device="cuda",
                               graphs=False)
    g = torch.Generator(device="cuda").manual_seed(41)
    im2 = torch.rand((1, h, w, 3), generator=g, device="cuda")
    im3 = torch.roll(im2, -24, dims=2) * 0.9 + 0.1 * torch.rand((1, h, w, 3), generator=g, device="cuda")

    def request():
        mde = pipe.mono_stage(im2, im3)
        return tp.stereo_stage(im2, im3, *mde)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    first, launches = counted(request)
    first_ms = 1e3 * (time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    want = mono_and_lookup_calls(preset.n_tiles * ITERS)
    print(f"booster request, eager, first call {first_ms:.0f} ms; wrapper calls {launches}; device memory peak "
          f"{peak / 1e9:.2f} GB", flush=True)
    if launches != want:
        raise AssertionError(f"booster: wrapper calls {launches}, expected {want}")
    if tuple(first.shape) != (1, h, w, 1) or not torch.isfinite(first).all():
        raise AssertionError(f"booster: bad disparity {tuple(first.shape)}")
    print(f"  disparity range [{first.min().item():.3f}, {first.max().item():.3f}] px", flush=True)
    mde = pipe.mono_stage(im2, im3)
    stages = {"mono stage": [], "tiles (eager)": []}
    for _ in range(BOOSTER_ROUNDS):
        stages["mono stage"].append(sync_ms(lambda: pipe.mono_stage(im2, im3)))
        stages["tiles (eager)"].append(sync_ms(lambda: tp.stereo_stage(im2, im3, *mde)))
    # then on their graph: one capture of the 8 tile forwards; its pool
    # (about 1.3x a tile's eager peak) fits beside the models
    tp.graphs = True
    torch.cuda.reset_peak_memory_stats()
    capture = sync_ms(lambda: tp.stereo_stage(im2, im3, *mde))
    program = tp._build(plan, w + (-w % 32))
    print(f"booster tiles on their graph: first call {capture:.0f} ms (warm-up and capture of {preset.n_tiles} tile "
          f"forwards; capture {program.capture_ms:.0f} ms), graph pool {tp.graph_pool_bytes() / 1e9:.2f} GB, device "
          f"memory peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB", flush=True)
    # held to the first eager request's result: an eager tile forward
    # beside the graph's pool would not fit
    same("booster tiles replay", tp.stereo_stage(im2, im3, *mde), first)
    stages["tiles (graph)"] = [sync_ms(lambda: tp.stereo_stage(im2, im3, *mde)) for _ in range(BOOSTER_ROUNDS)]
    replayed = k5_in_a_replay(lambda: tp.stereo_stage(im2, im3, *mde))
    print(f"booster K5 in a replay's trace: {replayed if replayed is not None else 'not measured'} "
          f"(expected {preset.n_tiles * ITERS})", flush=True)
    if replayed is not None and replayed != preset.n_tiles * ITERS:
        raise AssertionError(f"booster: the replay launched K5 {replayed} times")
    print(f"booster {h}x{w} ms, median [min-max] of {BOOSTER_ROUNDS}: " + "; ".join(
        f"{k} {np.median(v):.0f} [{min(v):.0f}-{max(v):.0f}]" for k, v in stages.items()), flush=True)
    return launches


def voldown_compare() -> None:
    """vol_downsample=1 on the card against the CPU: f32, TF32 off, 64 x 128,
    2 iterations, within 1e-3 px + 5e-5 rel."""
    cpu = StereoAnywhere(StereoAnywhereConfig(vol_downsample=1), device="cpu",
                         generator=torch.Generator().manual_seed(42))
    gpu = StereoAnywhere(StereoAnywhereConfig(vol_downsample=1), device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(43)
    xs = [torch.from_numpy(rng.uniform(0, 1, (1, 64, 128, c)).astype(np.float32)) for c in (3, 3, 1, 1)]
    want = cpu(*xs, iters=2)["disparity"]
    got = gpu(*(x.cuda() for x in xs), iters=2)["disparity"].cpu()
    err = (got - want).abs().max().item()
    excess = ((got - want).abs() - (1e-3 + 5e-5 * want.abs())).max().item()
    print(f"voldown 64x128 f32 iters 2, card vs CPU: max_abs_err {err:.3e} px (max|cpu| {want.abs().max().item():.3e}, "
          "tol 1e-3 px + 5e-5 rel.)", flush=True)
    if not (torch.isfinite(got).all() and excess <= 0):
        HIGHRES_FAILURES.append(f"vol_downsample on the card disagrees with the CPU: {err}")


# ---------------------------------------------------------------------------
# row-sharded inference: the stereo branch's rows over ranks (parallel/spatial.py)

ROWSHARD = (1024, 1024)
ROWSHARD_RANKS = (2, 4)
ROWSHARD_ROUNDS = 3
# the direct stereo branch at 1024^2, bf16, 32 iterations, eager, as PERF.md's
# high-resolution table records it: the memory peak and its part above what
# was resident (DAv2 then resident too)
DIRECT_PEAK_GB = "9.68 (5.79 above resident)"
# ARCHITECTURE.md's estimate of the halo traffic a forward at 1024^2 over 2 devices
HALO_ESTIMATE = "about 100 MB a forward at 1024^2 with N = 2 (ARCHITECTURE.md)"


def strict_f32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = False


def rowshard_model(dtype: str, fused: bool = False) -> StereoAnywhere:
    """The phase's stereo model (seeded: the same weights in either loop)."""
    return StereoAnywhere(StereoAnywhereConfig(compute_dtype=dtype, fused_level0="on" if fused else "off"),
                          device="cuda", generator=torch.Generator().manual_seed(50))


# the fused loop's rows are held against its direct forward at 2 iterations
# (1 runs no rotated body: K7-K9 launch once a body)
FUSED_CHECK_ITERS = 2


def rowshard_inputs() -> list[np.ndarray]:
    """The seeded (1, 1024, 1024, *) views and depth maps of the phase."""
    rng = np.random.default_rng(51)
    h, w = ROWSHARD
    return [rng.uniform(0, 1, (1, h, w, c)).astype(np.float32) for c in (3, 3, 1, 1)]


def rowshard_rank(rank: int, world: int, init_method: str, out: str, cards: bool = False) -> None:
    """One of `world` ranks on cuda:0 over gloo (NCCL refuses two ranks on
    one device; gloo stages the CUDA tensors through the host), or with
    `cards` on cuda:rank over NCCL, one card a rank.  Runs the
    stereo branch row-sharded at 1024^2: in f32 (TF32 off) at 1 iteration,
    gathered on rank 0; then in bf16 at 32 iterations (a warm-up, then one
    counted request with its memory peak and the bytes its collectives
    moved, then ROWSHARD_ROUNDS timed); then the pipeline with ViT-L's mono
    stage and `mesh=` (one counted request).  Writes its numbers to
    `{out}.{rank}`."""
    from stereoanywhere_tpu_torch.parallel import multihost as mh
    from stereoanywhere_tpu_torch.parallel.mesh import make_mesh
    from stereoanywhere_tpu_torch.parallel.spatial import RowShardedInference

    strict_f32()
    device = f"cuda:{rank}" if cards else "cuda:0"
    mh.initialize_distributed(device, rank=rank, world_size=world, init_method=init_method,
                              backend="nccl" if cards else "gloo")
    try:
        mesh = make_mesh(1, world)
        xs = [torch.from_numpy(x).cuda() for x in rowshard_inputs()]
        res = {}
        rs = RowShardedInference(rowshard_model("float32"), mesh, iters=1)
        full = rs.gather_rows(rs.infer(*xs), dst=0)
        res["f32"] = None if full is None else full.cpu()
        del rs, full
        torch.cuda.empty_cache()

        stereo = rowshard_model("bfloat16")
        rs = RowShardedInference(stereo, mesh, iters=ITERS)

        def request():
            return rs.gather_rows(rs.infer(*xs), dst=0)
        first = sync_ms(request)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        full, calls = counted(request)
        peak = torch.cuda.max_memory_allocated()
        shard_rows = (rs.plan(ROWSHARD[0]).starts[rs.index], rs.plan(ROWSHARD[0]).stops[rs.index])
        res["bf16"] = dict(first_ms=first, peak=peak, base=base, calls=calls, traffic=dict(rs.group.traffic),
                           rows=shard_rows, ms=[sync_ms(request) for _ in range(ROWSHARD_ROUNDS)],
                           out=None if full is None else full.cpu())
        mono = DepthAnythingV2(MonoConfig.for_encoder("vitl"), device="cuda",
                               generator=torch.Generator().manual_seed(52), dtype=torch.bfloat16)
        pipe = StereoAnywherePipeline(stereo, mono, ITERS, device=device, mesh=mesh)
        im2, im3 = xs[0], xs[1]
        disp, calls = counted(lambda: pipe(im2, im3))
        res["pipeline"] = dict(calls=calls, ms=[sync_ms(lambda: pipe(im2, im3)) for _ in range(2)],
                               out=None if disp is None else disp.cpu())
        del pipe, mono, stereo, rs
        gc.collect()
        torch.cuda.empty_cache()
        # the fused loop on the same rows: its K7, K8 and K9 launches on bands
        rs = RowShardedInference(rowshard_model("float32", fused=True), mesh, iters=FUSED_CHECK_ITERS)
        full = rs.gather_rows(rs.infer(*xs), dst=0)
        res["fused_f32"] = None if full is None else full.cpu()
        rs = RowShardedInference(rowshard_model("bfloat16", fused=True), mesh, iters=ITERS)
        first = sync_ms(request)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        full, calls = counted(request)
        peak = torch.cuda.max_memory_allocated()
        res["fused_bf16"] = dict(first_ms=first, peak=peak, base=base, calls=calls, traffic=dict(rs.group.traffic),
                                 rows=shard_rows, ms=[sync_ms(request) for _ in range(ROWSHARD_ROUNDS)],
                                 out=None if full is None else full.cpu())
        torch.save(res, f"{out}.{rank}")
    finally:
        mh.destroy_distributed()


def rowshard_world1(xs, want: torch.Tensor) -> None:
    """A mesh of one rank over NCCL (world size 1) against the direct
    forward, bit for bit; the disparity also all-reduced over the NCCL
    group, which a sum over one rank leaves as it is."""
    import torch.distributed as dist

    from stereoanywhere_tpu_torch.parallel import multihost as mh
    from stereoanywhere_tpu_torch.parallel.mesh import make_mesh
    from stereoanywhere_tpu_torch.parallel.spatial import RowShardedInference

    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{mh.free_port()}", rank=0, world_size=1)
    try:
        model = rowshard_model("float32")
        rs = RowShardedInference(model, make_mesh(1, 1), iters=1)
        got = rs.gather_rows(rs.infer(*xs))
        summed = got.clone()
        dist.all_reduce(summed)
        backend = dist.get_backend()
    finally:
        dist.destroy_process_group()
    ok = torch.equal(got, want) and torch.equal(summed, want)
    print(f"rowshard world size 1 over {backend}: RowShardedInference on make_mesh(1, 1) vs the direct forward "
          f"(f32, TF32 off, 1 iteration, {ROWSHARD[0]}x{ROWSHARD[1]}): equal bit for bit {ok}", flush=True)
    if not ok:
        raise AssertionError("row sharding at world size 1 over NCCL differs from the direct forward")


def rowshard_lookup_rows() -> None:
    """K5 at each rank's own quarter-resolution plane of the row-sharded
    1024^2 request (B = 1; 2 ranks: 128 x 256, 4 ranks: 64 x 256), held to
    the plain gather bit for bit in both dtypes and timed, as at Booster's
    tile plane."""
    from stereoanywhere_tpu_torch.parallel.halo import plan_rows, row_block

    h, w = ROWSHARD
    block = row_block(StereoAnywhereConfig())
    for world in ROWSHARD_RANKS:
        for h4 in sorted({b - a for a, b in plan_rows(h, world, block).ranges(4)}, reverse=True):
            plane_lookup_rows(f"row shard of {world} ranks", h4, w // 4, (1,), 60 + world)


def rowshard_direct() -> tuple[torch.Tensor, float, torch.Tensor, float]:
    """The direct stereo branch at 1024^2 on cuda:0: its f32 disparity at 1
    iteration (TF32 off) and the most one rounding of its inputs moves it
    (the yardstick of the sharded forwards), then its bf16 memory peak and
    ms a request at 32 iterations, printed; then the same for the fused
    loop (f32 at FUSED_CHECK_ITERS), whose disparity and move it returns
    too."""
    strict_f32()
    torch.cuda.empty_cache()
    h, w = ROWSHARD
    arrays = rowshard_inputs()
    xs = [torch.from_numpy(x).cuda() for x in arrays]
    direct = rowshard_model("float32")
    want = direct(*xs, iters=1)["disparity"]
    rng = np.random.default_rng(53)
    floor = max(float((direct(*[torch.from_numpy(one_rounding(x, rng)).cuda() for x in arrays],
                               iters=1)["disparity"] - want).abs().max()) for _ in range(2))
    print(f"rowshard: {card_line()}; stereo branch {h}x{w}, f32 TF32 off, 1 iteration: the direct forward's move "
          f"under one rounding of its inputs {floor:.3e} px (max |disparity| {want.abs().max().item():.1f} px)",
          flush=True)
    del direct
    # the direct bf16 stereo branch's memory peak in this call, beside PERF.md's
    bf16 = rowshard_model("bfloat16")
    bf16(*xs, iters=ITERS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    direct_out = bf16(*xs, iters=ITERS)["disparity"]
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    direct_ms = [sync_ms(lambda: bf16(*xs, iters=ITERS)) for _ in range(ROWSHARD_ROUNDS)]
    print(f"rowshard direct bf16 {ITERS} iterations: memory peak {peak / 1e9:.2f} GB ({(peak - base) / 1e9:.2f} GB "
          f"above resident, {base / 1e9:.2f} GB) beside PERF.md's earlier {DIRECT_PEAK_GB} GB; "
          f"{np.median(direct_ms):.1f} ms a request (median of {ROWSHARD_ROUNDS})", flush=True)
    del bf16, direct_out
    # the fused loop's direct forward: f32 at FUSED_CHECK_ITERS (the rotated
    # body runs) with its one-rounding move, then bf16 at 32 iterations
    fused = rowshard_model("float32", fused=True)
    fused_want = fused(*xs, iters=FUSED_CHECK_ITERS)["disparity"]
    fused_floor = max(float((fused(*[torch.from_numpy(one_rounding(x, rng)).cuda() for x in arrays],
                                   iters=FUSED_CHECK_ITERS)["disparity"] - fused_want).abs().max()) for _ in range(2))
    unfused = float((rowshard_model("float32")(*xs, iters=FUSED_CHECK_ITERS)["disparity"] - fused_want).abs().max())
    print(f"rowshard fused direct f32 {FUSED_CHECK_ITERS} iterations: the move under one rounding of its inputs "
          f"{fused_floor:.3e} px; fused vs unfused direct {unfused:.3e} px", flush=True)
    del fused
    fused = rowshard_model("bfloat16", fused=True)
    fused(*xs, iters=ITERS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    _, calls = counted(lambda: fused(*xs, iters=ITERS))
    peak = torch.cuda.max_memory_allocated()
    fused_ms = [sync_ms(lambda: fused(*xs, iters=ITERS)) for _ in range(ROWSHARD_ROUNDS)]
    print(f"rowshard fused direct bf16 {ITERS} iterations: memory peak {peak / 1e9:.2f} GB ({(peak - base) / 1e9:.2f} "
          f"GB above resident); {np.median(fused_ms):.1f} ms a request (median of {ROWSHARD_ROUNDS}); wrapper calls "
          f"{calls}", flush=True)
    del fused, xs
    gc.collect()
    torch.cuda.empty_cache()
    return want, floor, fused_want, fused_floor


def rowshard_phase() -> dict:
    """Exact row-sharded inference of the stereo branch at 1024^2 on the
    one card (`rowshard_rank`): K5 at each rank's plane; world size 1 over
    NCCL bit for bit against the direct forward; 2 and 4 ranks over gloo on
    cuda:0 against it in f32 at 1 iteration, within twice the move one
    rounding of the inputs gives the direct forward here; bf16 at 32
    iterations: each rank's memory peak above what was resident beside the
    direct path's (measured here, and PERF.md's earlier figure), ms a
    request (gloo staged through the host: a correctness run, not a
    speed), K5 on each rank, the bytes each rank's collectives moved.  One
    card runs every rank: this measures no scaling over cards.  Returns the
    wrappers' calls of one pipeline request (the mono stage whole, the
    stereo branch on 2 ranks) on rank 0."""
    rowshard_lookup_rows()
    direct = rowshard_direct()
    rowshard_world1([torch.from_numpy(x).cuda() for x in rowshard_inputs()], direct[0])
    failures, pipeline_calls, fused_calls = rowshard_ranks(ROWSHARD_RANKS, direct, cards=False)
    if failures:
        raise AssertionError("row-sharded inference: " + "; ".join(failures))
    return pipeline_calls, fused_calls


def rowshard_ranks(worlds, direct, cards: bool) -> tuple[list[str], dict | None, dict | None]:
    """`rowshard_rank` spawned at each world size (gloo on cuda:0, or NCCL
    one card a rank with `cards`), its results held to the direct forwards
    (`rowshard_direct`: the unfused one at 1 iteration, the fused one at
    FUSED_CHECK_ITERS, each within twice its one-rounding move) and
    printed.  Returns the failures, the wrapper calls of the pipeline
    request on rank 0 of the first world size, and those of its fused
    stereo request."""
    want, floor, fused_want, fused_floor = direct
    from stereoanywhere_tpu_torch.parallel.multihost import free_port

    h, w = ROWSHARD
    how = "over NCCL, one card a rank" if cards else "over gloo on cuda:0"
    staged = "" if cards else " (gloo staged through the host: a correctness run, not a speed)"
    failures, pipeline_calls, fused_calls = [], None, None
    tmp = Path(tempfile.mkdtemp(prefix="sa_rowshard_"))
    try:
        for world in worlds:
            out = str(tmp / f"world{world}")
            t0 = time.perf_counter()
            ctx = torch.multiprocessing.start_processes(
                rowshard_rank, args=(world, f"tcp://127.0.0.1:{free_port()}", out, cards), nprocs=world,
                join=False, start_method="spawn")
            join_within(ctx, 300, f"rowshard: the {world} ranks")
            res = [torch.load(f"{out}.{r}", weights_only=False) for r in range(world)]
            got = res[0]["f32"].cuda()
            err = float((got - want).abs().max())
            print(f"rowshard {world} ranks {how} ({time.perf_counter() - t0:.0f} s with the spawn): "
                  f"f32 1 iteration vs the direct forward max |delta| {err:.3e} px (tol {2 * floor:.3e}, twice the "
                  f"one-rounding move)", flush=True)
            if not (got.shape == want.shape and err <= 2 * floor):
                failures.append(f"{world} ranks f32: max |delta| {err} px > {2 * floor}")
            traffic = [r["bf16"]["traffic"] for r in res]
            for r, rr in enumerate(res):
                b = rr["bf16"]
                print(f"rowshard {world} ranks bf16 {ITERS} iterations, rank {r} rows {b['rows']}: memory peak "
                      f"{b['peak'] / 1e9:.2f} GB ({(b['peak'] - b['base']) / 1e9:.2f} GB above resident, "
                      f"{b['base'] / 1e9:.2f} GB); K5 {b['calls']['dual_lookup']} (expected {ITERS}); bytes handed "
                      f"to the collectives a forward: halo and band rows {b['traffic']['p2p'] / 1e6:.2f} MB, "
                      f"gathers {b['traffic']['gather'] / 1e6:.2f} MB, all-reduces "
                      f"{b['traffic']['reduce'] / 1e6:.3f} MB; ms a request{staged} first {b['first_ms']:.0f}, then "
                      f"{', '.join(f'{m:.0f}' for m in b['ms'])}", flush=True)
                want_calls = {n: ITERS if n == "dual_lookup" else 0 for n in COUNTERS}
                if b["calls"] != want_calls:
                    failures.append(f"{world} ranks, rank {r}: wrapper calls {b['calls']}, expected {want_calls}")
                p = rr["pipeline"]
                if p["calls"] != EXPECTED["default"]:
                    failures.append(f"{world} ranks, rank {r}: pipeline calls {p['calls']}, expected "
                                    f"{EXPECTED['default']}")
            total = sum(t["p2p"] + t["gather"] + t["reduce"] for t in traffic)
            print(f"rowshard {world} ranks: all ranks' collectives moved {total / 1e6:.1f} MB a forward, beside "
                  f"{HALO_ESTIMATE}", flush=True)
            out_b, out_p = res[0]["bf16"]["out"], res[0]["pipeline"]["out"]
            pipe_ms = ", ".join(f"{m:.0f}" for m in res[0]["pipeline"]["ms"])
            print(f"rowshard {world} ranks: pipeline request with the ViT-L mono stage and mesh=, bf16: wrapper "
                  f"calls on rank 0 {res[0]['pipeline']['calls']}; ms {pipe_ms}; disparity range "
                  f"[{out_p.min().item():.2f}, {out_p.max().item():.2f}] px", flush=True)
            for name, o in (("stereo branch", out_b), ("pipeline", out_p)):
                if tuple(o.shape) != (1, h, w, 1) or not torch.isfinite(o).all():
                    failures.append(f"{world} ranks {name}: bad disparity {tuple(o.shape)}")
            if any(r["f32"] is not None or r["bf16"]["out"] is not None or r["pipeline"]["out"] is not None
                   for r in res[1:]):
                failures.append(f"{world} ranks: a rank other than 0 got the gathered disparity")
            if pipeline_calls is None:
                pipeline_calls = res[0]["pipeline"]["calls"]
            failures += rowshard_fused_rows(world, res, fused_want, fused_floor, how, staged)
            if fused_calls is None:
                fused_calls = res[0]["fused_bf16"]["calls"]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return failures, pipeline_calls, fused_calls


def rowshard_fused_rows(world: int, res: list[dict], want: torch.Tensor, floor: float, how: str,
                        staged: str) -> list[str]:
    """The fused loop's row-sharded forwards of `world` ranks, held to the
    fused direct forward and printed: f32 within twice its one-rounding
    move; bf16 at 32 iterations, each rank's memory peak, bytes a forward
    and wrapper calls (asserted: K5 32, K7 and K8 31, K9 93 a rank)."""
    h, w = ROWSHARD
    failures = []
    got = res[0]["fused_f32"].cuda()
    err = float((got - want).abs().max())
    print(f"rowshard fused {world} ranks {how}: f32 {FUSED_CHECK_ITERS} iterations vs the fused direct forward max "
          f"|delta| {err:.3e} px (tol {2 * floor:.3e}, twice the one-rounding move)", flush=True)
    if not (got.shape == want.shape and err <= 2 * floor):
        failures.append(f"{world} ranks fused f32: max |delta| {err} px > {2 * floor}")
    for r, rr in enumerate(res):
        b = rr["fused_bf16"]
        print(f"rowshard fused {world} ranks bf16 {ITERS} iterations, rank {r} rows {b['rows']}: memory peak "
              f"{b['peak'] / 1e9:.2f} GB ({(b['peak'] - b['base']) / 1e9:.2f} GB above resident, "
              f"{b['base'] / 1e9:.2f} GB); wrapper calls {b['calls']}; bytes handed to the collectives a forward: "
              f"halo and band rows {b['traffic']['p2p'] / 1e6:.2f} MB, gathers {b['traffic']['gather'] / 1e6:.2f} MB, "
              f"all-reduces {b['traffic']['reduce'] / 1e6:.3f} MB; ms a request{staged} first {b['first_ms']:.0f}, "
              f"then {', '.join(f'{m:.0f}' for m in b['ms'])}", flush=True)
        want_calls = {n: ITERS if n == "dual_lookup" else 0 for n in COUNTERS}
        want_calls.update({n: EXPECTED["fused"][n] for n in ("flow_head", "motion_encoder", "conv_gru")})
        if b["calls"] != want_calls:
            failures.append(f"{world} ranks fused, rank {r}: wrapper calls {b['calls']}, expected {want_calls}")
    total = sum(sum(rr["fused_bf16"]["traffic"].values()) for rr in res)
    print(f"rowshard fused {world} ranks: all ranks' collectives moved {total / 1e6:.1f} MB a forward", flush=True)
    out = res[0]["fused_bf16"]["out"]
    if tuple(out.shape) != (1, h, w, 1) or not torch.isfinite(out).all():
        failures.append(f"{world} ranks fused bf16: bad disparity {tuple(out.shape)}")
    if any(rr["fused_f32"] is not None or rr["fused_bf16"]["out"] is not None for rr in res[1:]):
        failures.append(f"{world} ranks fused: a rank other than 0 got the gathered disparity")
    return failures


def join_within(ctx, seconds: float, what: str) -> None:
    """Join spawned processes, killing them and raising after `seconds`."""
    try:
        deadline = time.monotonic() + seconds
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                raise AssertionError(f"{what} did not finish within {seconds:.0f} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()


def run_own_group(cmd: list[str], seconds: float, env: dict) -> str:
    """Run cmd in a session of its own from the repository's root; after
    `seconds` kill it with every process it started (the ranks it spawns)
    and raise.  Returns its output; raises on a non-zero exit."""
    proc = subprocess.Popen(cmd, cwd=Path(__file__).resolve().parent, env=env, start_new_session=True,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        out, _ = proc.communicate(timeout=seconds)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise AssertionError(f"{' '.join(cmd[3:6])}... did not finish within {seconds:.0f} s") from None
    if proc.returncode:
        raise AssertionError(f"{' '.join(cmd[3:])} exited {proc.returncode}: {out[-3000:]}")
    return out


def rowshard_cli_check(worlds) -> list[str]:
    """`cli infer --shard-rows N` as a user runs it, on a seeded 1024^2 pair
    (ViT-L's random weights written as a .pth and read through
    `--mono-checkpoint`, the CLI's seeded stereo weights, f32 at 1
    iteration, TF32 off through NVIDIA_TF32_OVERRIDE=0), each in a process
    of its own: N = 1 and each world size over NCCL, one card a rank.  The
    .npy of N ranks is held to N = 1's within twice the move one rounding
    of the inputs gives the one-process pipeline (measured here, in this
    process, TF32 off).  Returns the failures."""
    from types import SimpleNamespace

    strict_f32()
    h, w = ROWSHARD
    tmp = Path(tempfile.mkdtemp(prefix="sa_rowshard_cli_"))
    failures = []
    try:
        left, right, _ = _scene(np.random.default_rng(54), h, w, 120.0)
        views = [str(tmp / "left.png"), str(tmp / "right.png")]
        Image.fromarray(left).save(views[0])
        Image.fromarray(right).save(views[1])
        dav2 = tmp / "dav2_vitl.pth"
        torch.save(DepthAnythingV2(MonoConfig.for_encoder("vitl"), device="cpu",
                                   generator=torch.Generator().manual_seed(11)).state_dict(), dav2)
        pipe = cli._pipeline(SimpleNamespace(device="cuda", dtype="float32", checkpoint=None,
                                             mono_checkpoint=str(dav2), mono_encoder="vitl", iters=1))
        pipe.graphs = False
        ims = [np.asarray(Image.open(v).convert("RGB"), np.float32)[None] / 255.0 for v in views]
        here = pipe(*ims).cpu().numpy()[0, ..., 0]
        rng = np.random.default_rng(55)
        move = max(float(np.abs(pipe(*[one_rounding(x, rng) for x in ims]).cpu().numpy()[0, ..., 0] - here).max())
                   for _ in range(2))
        del pipe
        gc.collect()
        torch.cuda.empty_cache()
        env = {**os.environ, "NVIDIA_TF32_OVERRIDE": "0"}
        outs = {}
        for n in (1, *worlds):
            t0 = time.perf_counter()
            run_own_group([sys.executable, "-c", "import sys; from stereoanywhere_tpu_torch import cli; "
                           "cli.main(sys.argv[1:])", "infer", *views, "-o", str(tmp / f"out{n}"), "--mono-checkpoint",
                           str(dav2), "--dtype", "float32", "--iters", "1", "--shard-rows", str(n)], 300, env)
            outs[n] = np.load(tmp / f"out{n}" / "left_disp.npy")
            print(f"rowshard cli infer --shard-rows {n}: {time.perf_counter() - t0:.1f} s with the process start; "
                  f"shape {outs[n].shape}, finite {bool(np.isfinite(outs[n]).all())}; max |delta| against this "
                  f"process's pipeline {np.abs(outs[n] - here).max():.3e} px", flush=True)
            if outs[n].shape != (h, w) or not np.isfinite(outs[n]).all():
                failures.append(f"cli --shard-rows {n}: bad disparity {outs[n].shape}")
        for n in worlds:
            err = float(np.abs(outs[n] - outs[1]).max())
            print(f"rowshard cli infer --shard-rows {n} over NCCL vs --shard-rows 1 (f32, TF32 off, 1 iteration): "
                  f"max |delta| {err:.3e} px (tol {2 * move:.3e}, twice the one-process pipeline's one-rounding "
                  f"move)", flush=True)
            if not err <= 2 * move:
                failures.append(f"cli --shard-rows {n}: max |delta| {err} px > {2 * move}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return failures


def rowshard_booster_rank(rank: int, world: int, init_method: str, out: str) -> None:
    """One of `world` ranks over NCCL on cuda:rank: Booster's 3008 x 4112
    through the pipeline with ViT-L's mono stage at Booster's DAv2 size and
    `mesh=` (bf16, 32 iterations, eager): the first request's ms, memory
    peak above resident and wrapper calls, then BOOSTER_ROUNDS requests
    timed.  Writes its numbers to `{out}.{rank}`, or the out-of-memory
    error before it raises it."""
    from stereoanywhere_tpu_torch.parallel import multihost as mh
    from stereoanywhere_tpu_torch.parallel.mesh import make_mesh

    strict_f32()
    device = f"cuda:{rank}"
    mh.initialize_distributed(device, rank=rank, world_size=world, init_method=init_method, backend="nccl")
    try:
        h, w = BOOSTER
        mono = DepthAnythingV2(MonoConfig.for_encoder("vitl"), device="cuda",
                               generator=torch.Generator().manual_seed(52), dtype=torch.bfloat16)
        pipe = StereoAnywherePipeline(rowshard_model("bfloat16"), mono, ITERS, mono_size=harness.DAV2_SIZES["booster"],
                                      device=device, mesh=make_mesh(1, world))
        g = torch.Generator(device="cuda").manual_seed(41)
        im2 = torch.rand((1, h, w, 3), generator=g, device="cuda")
        im3 = torch.roll(im2, -24, dims=2) * 0.9 + 0.1 * torch.rand((1, h, w, 3), generator=g, device="cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        try:
            t0 = time.perf_counter()
            disp, calls = counted(lambda: pipe(im2, im3))
            first_ms = 1e3 * (time.perf_counter() - t0)
        except torch.cuda.OutOfMemoryError as e:
            torch.save(dict(oom=str(e).splitlines()[0], base=base), f"{out}.{rank}")
            raise
        peak = torch.cuda.max_memory_allocated()
        rows = pipe.rows.group.plan.ranges(1)[rank]
        traffic = dict(pipe.rows.group.traffic)
        stats = None if disp is None else dict(shape=tuple(disp.shape), finite=bool(torch.isfinite(disp).all()),
                                               lo=disp.min().item(), hi=disp.max().item())
        ms = [sync_ms(lambda: pipe(im2, im3)) for _ in range(BOOSTER_ROUNDS)]
        torch.save(dict(first_ms=first_ms, peak=peak, base=base, calls=calls, rows=rows, traffic=traffic, ms=ms,
                        out=stats), f"{out}.{rank}")
    finally:
        mh.destroy_distributed()


def rowshard_booster(world: int) -> list[str]:
    """Booster's 3008 x 4112 over `world` cards (`rowshard_booster_rank`),
    printed; a rank out of memory is printed as the finding that the shard
    does not fit, not counted as a failure.  Returns the failures."""
    from stereoanywhere_tpu_torch.parallel.multihost import free_port

    h, w = BOOSTER
    tmp = Path(tempfile.mkdtemp(prefix="sa_rowshard_booster_"))
    failures = []
    try:
        out = str(tmp / "booster")
        ctx = torch.multiprocessing.start_processes(
            rowshard_booster_rank, args=(world, f"tcp://127.0.0.1:{free_port()}", out), nprocs=world, join=False,
            start_method="spawn")
        try:
            join_within(ctx, 300, f"rowshard booster: the {world} ranks")
        except Exception as e:  # noqa: BLE001  (an out-of-memory rank is a finding; anything else fails)
            ooms = {r: torch.load(f"{out}.{r}")["oom"] for r in range(world) if os.path.exists(f"{out}.{r}")}
            if not ooms:
                raise
            print(f"rowshard booster {h}x{w} over {world} cards: did not fit: " + "; ".join(
                f"rank {r}: {m}" for r, m in ooms.items()) + f" ({type(e).__name__})", flush=True)
            return failures
        res = [torch.load(f"{out}.{r}", weights_only=False) for r in range(world)]
        for r, b in enumerate(res):
            print(f"rowshard booster {h}x{w} over {world} cards, NCCL, bf16 {ITERS} iterations, pipeline with the "
                  f"ViT-L mono stage, rank {r} rows {b['rows']}: memory peak {b['peak'] / 1e9:.2f} GB "
                  f"({(b['peak'] - b['base']) / 1e9:.2f} GB above resident, {b['base'] / 1e9:.2f} GB); wrapper calls "
                  f"{b['calls']}; collectives a request: halo and band rows {b['traffic']['p2p'] / 1e6:.1f} MB, "
                  f"gathers {b['traffic']['gather'] / 1e6:.1f} MB, all-reduces {b['traffic']['reduce'] / 1e6:.3f} "
                  f"MB; ms a request first {b['first_ms']:.0f}, then {', '.join(f'{m:.0f}' for m in b['ms'])}",
                  flush=True)
            if b["calls"] != mono_and_lookup_calls(ITERS):
                failures.append(f"booster rank {r}: wrapper calls {b['calls']}")
        o = res[0]["out"]
        print(f"rowshard booster: rank 0's gathered disparity {o}", flush=True)
        if o is None or o["shape"] != (1, h, w, 1) or not o["finite"] or any(b["out"] for b in res[1:]):
            failures.append(f"booster: bad gathered disparity {o}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return failures


def rowshard_cards_main() -> int:
    """`--rowshard-cards`: row-sharded inference over NCCL, one card a rank,
    at each world size of ROWSHARD_RANKS the visible cards allow (needs 2 or
    more): K5 at each rank's plane; the direct forward's yardstick on
    cuda:0; `rowshard_rank` at each world size (f32 against the direct
    forward within twice its one-rounding move; bf16 memory, bytes, ms a
    request over NCCL, K5; the pipeline request; the fused loop's rows, f32
    against its direct forward, bf16 memory, bytes, ms and K5, K7, K8, K9 a
    rank); `cli infer --shard-rows
    N` against `--shard-rows 1`; Booster's full 3008 x 4112 over the most
    cards.  Any failure exits non-zero."""
    n = torch.cuda.device_count()
    worlds = [k for k in ROWSHARD_RANKS if k <= n]
    if not worlds:
        print(f"chip_smoke --rowshard-cards: needs {ROWSHARD_RANKS[0]} cards or more, has {n}", file=sys.stderr)
        return 2
    cards = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True, check=True).stdout.strip().splitlines()
    print(f"cards ({n}): " + "; ".join(cards), flush=True)
    t0 = time.perf_counter()
    build.build()
    print(f"kernels built in {time.perf_counter() - t0:.1f} s", flush=True)
    rowshard_lookup_rows()
    direct = rowshard_direct()
    failures, _, _ = rowshard_ranks(worlds, direct, cards=True)
    del direct
    torch.cuda.empty_cache()
    failures += rowshard_cli_check(worlds)
    failures += rowshard_booster(worlds[-1])
    if failures:
        raise AssertionError("row sharding over cards: " + "; ".join(failures))
    print(f"rowshard over cards: all checks met on {worlds} cards; {card_line()}", flush=True)
    return 0


# ---------------------------------------------------------------------------
# training: `cli train` at the reference configuration, and one step card vs CPU

TRAIN_PAIRS, TRAIN_SIZE, TRAIN_STEPS, TRAIN_RESUMED = 8, (540, 960), 20, 24
TRAIN_GROUPS = {"cnet": ("cnet", "context_zqr_convs"),
                "monoagg": ("hourglass_mono", "classifier_mono", "classifier_monoconf"),
                "update_block": ("update_block",)}
TRAIN_PHASES = ("sa.train.forward", "sa.train.loss", "sa.train.backward", "sa.train.optimizer")


def write_flyingthings(root: Path, rng, n: int, size: tuple[int, int]) -> Path:
    """A FlyingThings3D-layout directory (image_clean/{left,right}/*.png,
    disparity/{left,right}/*.pfm, the left disparity negated as the
    reader expects) of n synthetic pairs."""
    h, w = size
    for side in ("left", "right"):
        (root / "image_clean" / side).mkdir(parents=True)
        (root / "disparity" / side).mkdir(parents=True)
    for i in range(n):
        left, right, disp = _scene(rng, h, w, 120.0)
        Image.fromarray(left).save(root / "image_clean" / "left" / f"{i:04d}.png")
        Image.fromarray(right).save(root / "image_clean" / "right" / f"{i:04d}.png")
        write_pfm(str(root / "disparity" / "left" / f"{i:04d}.pfm"), -disp)
        write_pfm(str(root / "disparity" / "right" / f"{i:04d}.pfm"), disp)
    return root


class _TrainRecorder:
    """Counts the kernel wrappers' calls inside `Trainer.step` and
    `Trainer.validate`, and stamps each step's start on the host clock."""

    def __init__(self):
        self.step_launches = {n: 0 for n in COUNTERS}
        self.validations: list[tuple[dict, dict]] = []  # (wrapper calls, metrics)
        self.step_starts: list[tuple[int, float]] = []
        self.validate_starts: list[float] = []

    @contextmanager
    def installed(self):
        from stereoanywhere_tpu_torch.train.trainer import Trainer

        step, validate, rec = Trainer.step, Trainer.validate, self

        def counted(fn, sink):
            def run(trainer, *a, **k):
                before = {n: f.launches for n, f in COUNTERS.items()}
                out = fn(trainer, *a, **k)
                sink({n: f.launches - before[n] for n, f in COUNTERS.items()}, out)
                return out
            return run

        def step_sink(calls, _):
            for n, c in calls.items():
                rec.step_launches[n] += c

        def stamped(trainer, *a, **k):
            rec.step_starts.append((trainer.step_count, time.perf_counter()))
            return counted(step, step_sink)(trainer, *a, **k)

        def validated(trainer, *a, **k):
            rec.validate_starts.append(time.perf_counter())
            return counted(validate, lambda calls, out: rec.validations.append((calls, out)))(trainer, *a, **k)

        Trainer.step, Trainer.validate = stamped, validated
        try:
            yield self
        finally:
            Trainer.step, Trainer.validate = step, validate


def traced_train_step(trainer, batch) -> None:
    """One train step traced: device busy, idle share of its wall time, and
    device ms by phase (the trainer's `sa.train.*` spans: each kernel under
    the phase in which the host launched it, the backward's too, which the
    autograd engine launches from its own thread)."""
    from stereoanywhere_tpu_torch.utils.profiling import device_by_span

    trainer.step(batch)  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall = sync_ms(lambda: trainer.step(batch))
    by_phase = device_by_span(prof.events(), "sa.train.")
    kernels = [k for ks in by_phase.values() for k in ks]
    if not kernels:
        print("train trace: not measured (the profiler saw no device events)", flush=True)
        return
    busy = busy_us([(s, e) for _, s, e in kernels]) / 1e3
    parts = {name: busy_us([(s, e) for _, s, e in by_phase[name]]) / 1e3 if name in by_phase else None
             for name in TRAIN_PHASES}
    print(f"train trace, one step: wall {wall:.1f} ms, device busy {busy:.1f} ms, idle share {1 - busy / wall:.3f}, "
          f"{len(kernels)} kernels; device ms by phase: " + ", ".join(
              f"{n.split('.')[-1]} {fmt(ms)}" for n, ms in parts.items())
          + f"; outside every phase {fmt(busy_us([(s, e) for _, s, e in by_phase.get('', [])]) / 1e3)}", flush=True)
    counts = defaultdict(int)
    for name, _, _ in kernels:
        counts[re.sub(r"[<(].*", "", name.replace("(anonymous namespace)::", ""))[-48:]] += 1
    print("  launches by kernel: " + ", ".join(f"{n} {c}" for n, c in sorted(counts.items(), key=lambda kv: -kv[1])[:12]),
          flush=True)
    # the host ops whose launches include a device-to-host copy (each one waits for the device)
    syncs = defaultdict(int)
    for e in prof.events():
        if e.device_type == DeviceType.CPU and any("DtoH" in k.name for k in getattr(e, "kernels", [])):
            parent = e.cpu_parent.name if e.cpu_parent is not None else "-"
            syncs[f"{parent} > {e.name}"] += 1
    print("  device-to-host copies by host op (parent > op): " + (", ".join(
        f"{n} {c}" for n, c in sorted(syncs.items(), key=lambda kv: -kv[1])[:8]) or "none seen"), flush=True)


def write_train_data(tmp: Path) -> tuple[str, Path]:
    """A synthetic FlyingThings-layout directory (8 pairs at 540x960) and a
    synthetic Middlebury one, with their mono depth from `cli
    precompute-mono` (ViT-L, random weights in a .pth): the sceneflow
    datapath and the Middlebury root."""
    rng = np.random.default_rng(3)
    t0 = time.perf_counter()
    ft = write_flyingthings(tmp / "ft", rng, TRAIN_PAIRS, TRAIN_SIZE)
    (tmp / "empty").mkdir()
    path = f"{ft};{tmp / 'empty'};{tmp / 'empty'}"
    mb = write_eval_dirs(tmp / "val", rng)["middlebury"]
    dav2 = tmp / "dav2_vitl.pth"
    torch.save(DepthAnythingV2(MonoConfig.for_encoder("vitl"), device="cpu",
                               generator=torch.Generator().manual_seed(11)).state_dict(), dav2)
    for dataset, root in (("sceneflow", path), ("middlebury", str(mb))):
        with redirect_stdout(io.StringIO()):
            cli.main(["precompute-mono", "--dataset", dataset, "--datapath", root, "--mono-checkpoint", str(dav2),
                      "--dtype", "bfloat16"])
    print(f"train data: {TRAIN_PAIRS} FlyingThings-layout pairs at {TRAIN_SIZE[0]}x{TRAIN_SIZE[1]} and 3 "
          f"Middlebury scenes written, their mono depth by cli precompute-mono (ViT-L bf16) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return path, mb


def train_argv(path: str, save: Path, dtype: str = "float32") -> list[str]:
    """`cli train` at the reference configuration (run_train.sh: crop
    320x640, batch 2, 12 iterations, fnet frozen, gt-as-mono 0.3,
    corruption 0.3) on the card."""
    return ["train", "--dataset", "sceneflow", "--datapath", path, "--mono-precomputed", "DAv2",
            "--device", "cuda", "--dtype", dtype, "--crop-h", "320", "--crop-w", "640", "--batch-size", "2",
            "--iters", "12", "--freeze", "fnet", "--gt-mono-prob", "0.3", "--corruption-prob", "0.3",
            "--savedir", str(save)]


def train_phase(tmp: Path, path: str, mb: Path) -> tuple[dict, dict]:
    """`cli train` as a user runs it: `cli train --dataset sceneflow
    --mono-precomputed DAv2` at the reference configuration (default
    stereo widths, f32, crop 320x640, batch 2, 12 iterations, fnet frozen,
    gt-as-mono 0.3, corruption 0.3) for 20 steps, saving every 10 and
    logging every 5, validating on 2 Middlebury samples every 10 (the
    test-mode forward: K5), then `--resume latest` to step 24.  Asserts
    finite losses at every log, fnet bit-identical to its seeded start and
    every other group moved, no kernel wrapper called in a train step and
    K5 32 times a validation sample, the resumed step counter, the `best`
    checkpoint.  Returns the wrapper calls of the train steps and of the
    validations."""
    from stereoanywhere_tpu_torch.data.augmentor import DisparityAugmentor
    from stereoanywhere_tpu_torch.data.datasets import fetch_dataset
    from stereoanywhere_tpu_torch.data.loader import default_collate

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True  # PyTorch's default, as the CLI runs
    torch.backends.cudnn.benchmark = False
    save = tmp / "run"
    argv = train_argv(path, save) + ["--save-every", "10", "--log-every", "5", "--val-datapath", str(mb),
                                     "--val-dataset", "middlebury", "--val-every", "10", "--val-samples", "2"]
    rec = _TrainRecorder()
    torch.cuda.reset_peak_memory_stats()
    log = io.StringIO()
    with rec.installed():
        t0 = time.perf_counter()
        with redirect_stdout(log):
            trainer = cli.main(argv + ["--num-steps", str(TRAIN_STEPS)])
        first_s = time.perf_counter() - t0
        first_starts = list(rec.step_starts)
        with redirect_stdout(log):
            resumed = cli.main(argv + ["--num-steps", str(TRAIN_RESUMED), "--resume", "latest"])
    peak = torch.cuda.max_memory_allocated()
    for line in log.getvalue().splitlines():
        print(f"  cli train: {line}", flush=True)
    rows = [json.loads(line) for line in open(save / "metrics.jsonl")]
    losses = [r["loss/total"] for r in rows if "loss/total" in r]
    if not (len(losses) == TRAIN_STEPS // 5 + (TRAIN_RESUMED - TRAIN_STEPS) // 5 and np.isfinite(losses).all()):
        raise AssertionError(f"cli train: losses at the logs {losses}")
    if rec.step_starts[len(first_starts)][0] != TRAIN_STEPS or resumed.step_count != TRAIN_RESUMED:
        raise AssertionError("the resumed run did not continue from the checkpoint's step")
    if not (save / "best.pt").exists() or not (save / "final.pt").exists():
        raise AssertionError("cli train wrote no best or final checkpoint")
    # fnet frozen: bit-identical to the seeded start; every other group moved
    start = StereoAnywhere(StereoAnywhereConfig(volume_corruption_prob=0.3), device="cpu",
                           generator=torch.Generator().manual_seed(1337)).state_dict()
    now = {k: v.cpu() for k, v in resumed.model.state_dict().items()}
    if not all(torch.equal(now[k], v) for k, v in start.items() if k.startswith("fnet.")):
        raise AssertionError("a frozen fnet parameter moved")
    for group, tops in TRAIN_GROUPS.items():
        if not any(not torch.equal(now[k], v) for k, v in start.items() if k.split(".")[0] in tops):
            raise AssertionError(f"no parameter of the unfrozen group {group} moved")
    if any(rec.step_launches.values()):
        raise AssertionError(f"a kernel wrapper ran inside a train step: {rec.step_launches}")
    val_calls = {n: 0 for n in COUNTERS}
    for calls, metrics in rec.validations:
        want = {n: 0 for n in COUNTERS} | {"dual_lookup": ITERS * 2}
        if calls != want:
            raise AssertionError(f"a validation of 2 samples called {calls}, expected {want}")
        for n, c in calls.items():
            val_calls[n] += c
        print("train validation (2 Middlebury samples, 32 iterations): " + ", ".join(
            f"{k} {metrics[k]:.4f}" for k in ("avgerr", "rms", "bad 2.0", "is_best")), flush=True)
    # steady state: steps 16-20 of the first run, between two syncs: the log's float() after step 15
    # (then step 16 starts) and the log's after step 20 (then the validation starts)
    sps = (rec.validate_starts[1] - dict(first_starts)[15]) / 5
    print(f"train {TRAIN_STEPS} + {TRAIN_RESUMED - TRAIN_STEPS} steps (crop 320x640, batch 2, 12 iterations, f32): "
          f"first run {first_s:.1f} s in cli.main; {sps:.3f} s/step over steps 16-20 ({2 / sps:.2f} pairs/s), "
          f"host clock between the logs' syncs at steps 15 and 20; device memory peak "
          f"{peak / 1e9:.2f} GB; losses at the logs {[round(x, 3) for x in losses]}; wrapper calls in the "
          f"train steps {rec.step_launches}", flush=True)
    aug = DisparityAugmentor(crop_size=(320, 640), seed=0)
    ds = fetch_dataset("sceneflow", path, test=False, mono="DAv2", augmentor=aug)
    traced_train_step(resumed, default_collate([ds[0], ds[1]]))
    return dict(rec.step_launches), val_calls


def train_compare_phase() -> None:
    """One train step at 64x128, 2 iterations, f32 (TF32 off), corruption
    and gt-as-mono off, on the card and on the CPU from the same weights:
    the loss within 1e-4 relative; each parameter's gradient within 4e-2 of
    its L2 norm and all of them within 5e-3 (`tests/test_torch_train.py`
    holds the CPU against JAX so: the gather's backward sums with atomics
    in another order, and a ReLU at f32 round-off from zero can fall
    either way); each parameter after the step within 2 lr + 1e-6 of its
    magnitude (Adam's first step moves an entry by about lr, in the sign
    of its gradient, which an entry near 0 may differ in)."""
    from stereoanywhere_tpu_torch.config import TrainConfig
    from stereoanywhere_tpu_torch.train.trainer import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    cfg, tc = StereoAnywhereConfig(volume_corruption_prob=0.0), TrainConfig(train_iters=2, gt_mono_prob=0.0)
    cpu, card = Trainer(cfg, tc, 10, device="cpu"), Trainer(cfg, tc, 10, device="cuda")
    card.model.load_state_dict(cpu.model.state_dict())
    lr = card.lr
    rng = np.random.default_rng(8)
    b, h, w = 2, 64, 128
    batch = {"im2_aug": rng.uniform(0, 1, (b, h, w, 3)), "im3_aug": rng.uniform(0, 1, (b, h, w, 3)),
             "mono2": rng.uniform(0, 1, (b, h, w, 1)), "mono3": rng.uniform(0, 1, (b, h, w, 1)),
             "gt": rng.uniform(1, 10, (b, h, w, 1)), "validgt": np.ones((b, h, w, 1)),
             "gt_right": rng.uniform(1, 10, (b, h, w, 1)), "validgt_right": np.ones((b, h, w, 1))}
    batch = {k: v.astype(np.float32) for k, v in batch.items()}
    want, got = step_record(cpu, cpu.step(batch)), step_record(card, card.step(batch))
    loss_rel, worst_grad, glob, worst_param = step_gaps(got, want, 2 * lr)
    print(f"train step card vs CPU (64x128, 2 iterations, f32, TF32 off): loss {got['loss']:.6f} / "
          f"{want['loss']:.6f} (rel. {loss_rel:.2e}, tol 1e-4); gradients: worst parameter {worst_grad[1]} at "
          f"{worst_grad[0]:.2e} of its norm (tol 4e-2), all together {glob:.2e} (tol 5e-3); parameters after the "
          f"step: worst {worst_param[1]} at {worst_param[0]:.3f} of its bound (2 lr + 1e-6 rel., lr {lr:.2e})",
          flush=True)
    if not (loss_rel <= 1e-4 and worst_grad[0] <= 4e-2 and glob <= 5e-3 and worst_param[0] <= 1.0):
        raise AssertionError("the train step on the card disagrees with the CPU")


def step_record(trainer, logs: dict) -> dict:
    """A step's loss, and each trainable parameter's gradient (as the
    optimizer took it) and value after the step, on the host."""
    return {"loss": float(logs["loss/total"]),
            "grads": {n: p.grad.detach().to("cpu", torch.float32, copy=True) for n, p in trainer.named_trainable},
            "params": {n: p.detach().to("cpu", copy=True) for n, p in trainer.named_trainable}}


def step_gaps(got: dict, want: dict, bound: float) -> tuple[float, tuple, float, tuple]:
    """`train_compare_phase`'s measures between two `step_record`s: the
    loss's relative gap; the worst parameter's gradient gap over its norm
    and the gap of all of them together; the worst parameter's gap after
    the step over `bound` + 1e-6 of its magnitude."""
    num = den = 0.0
    worst_grad, worst_param = (0.0, ""), (0.0, "")
    for name, g in want["grads"].items():
        d, n = (got["grads"][name] - g).norm().item(), g.norm().item()
        num, den = num + d * d, den + n * n
        worst_grad = max(worst_grad, (d / max(n, 1e-30), name))
        p = want["params"][name]
        moved = (got["params"][name] - p).abs().max().item()
        worst_param = max(worst_param, (moved / (bound + 1e-6 * p.abs().max().item()), name))
    return abs(got["loss"] - want["loss"]) / abs(want["loss"]), worst_grad, (num / den) ** 0.5, worst_param


# ---------------------------------------------------------------------------
# training over processes, in mixed precision and with batch statistics

DP_STEPS, TWO_RANK_STEPS, BF16_STEPS, BN_STEPS = 4, 2, 10, 5


def train_dp_run(path: str, tmp: str) -> int:
    """In a process of its own (`train_dp_phase`): `cli train` at the
    reference configuration (synchronous loading, a log every step) as one
    process and as rank 0 of a world of 1 under torchrun's environment
    (`--multihost`: an NCCL group, its gradient all-reduce, the loss's and
    the host's collectives).  First DP_STEPS steps of each in PyTorch's
    deterministic mode: their losses, logs and every parameter and buffer
    after the run must be equal bit for bit.  Then, out of that mode and
    with 4 loader threads, 2 * DP_STEPS steps of each twice, in turns:
    s/step over steps DP_STEPS + 1 to 2 DP_STEPS - 1 (host clock between
    the logs' syncs), the difference being the cost of the collectives."""
    from stereoanywhere_tpu_torch.parallel.multihost import free_port

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cudnn.benchmark = False
    rec = _TrainRecorder()

    def run(multihost: bool, steps: int, loader_threads: int) -> dict:
        extra = ["--multihost"] if multihost else []
        if multihost:
            os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
                              MASTER_PORT=str(free_port()))
        save = Path(tempfile.mkdtemp(dir=tmp))
        argv = train_argv(path, save) + ["--num-steps", str(steps), "--log-every", "1", "--save-every", "100",
                                         "--loader-threads", str(loader_threads), *extra]
        first = len(rec.step_starts)
        with rec.installed(), redirect_stdout(io.StringIO()):
            trainer = cli.main(argv)
        starts = [t for _, t in rec.step_starts[first:]]
        rows = [{k: v for k, v in json.loads(line).items() if k != "time"} for line in open(save / "metrics.jsonl")]
        return dict(sps=(starts[-1] - starts[-DP_STEPS]) / (DP_STEPS - 1), rows=rows,
                    state={k: v.cpu() for k, v in trainer.model.state_dict().items()})

    torch.use_deterministic_algorithms(True)
    a, b = run(False, DP_STEPS, 0), run(True, DP_STEPS, 0)  # synchronous loading: the same augmentation draws
    torch.use_deterministic_algorithms(False)
    # timed as cli train runs (4 loader threads), in turns: rank 0 of 1, one process, one process, rank 0 of 1
    timed = [run(multihost, 2 * DP_STEPS, 4) for multihost in (True, False, False, True)]
    timed_dp, timed_plain = [timed[0]["sps"], timed[3]["sps"]], [timed[1]["sps"], timed[2]["sps"]]
    same_logs = a["rows"] == b["rows"]
    same_state = a["state"].keys() == b["state"].keys() and all(torch.equal(v, b["state"][k])
                                                                   for k, v in a["state"].items())
    print(f"train dp: cli train at the reference configuration, {DP_STEPS} steps each in deterministic mode, one "
          f"process and --multihost as rank 0 of 1 over NCCL: losses {[round(r['loss/total'], 4) for r in a['rows']]}; "
          f"every log equal: {same_logs}; every parameter and buffer equal bit for bit: {same_state} (steps 1-3: "
          f"{a['sps']:.3f} / {b['sps']:.3f} s/step).  Out of that mode, 4 loader threads, {2 * DP_STEPS} steps a "
          f"run, in turns, s/step over steps {DP_STEPS + 1}-{2 * DP_STEPS - 1}: rank 0 of 1 over NCCL "
          f"{timed_dp[0]:.4f}, {timed_dp[1]:.4f}; one process {timed_plain[0]:.4f}, {timed_plain[1]:.4f} (the "
          f"difference of the means, {1e3 * (sum(timed_dp) - sum(timed_plain)) / 2:.1f} ms, is the gradient "
          f"all-reduce and the loss's and host's collectives)", flush=True)
    return 0 if same_logs and same_state else 1


def train_dp_phase(tmp: Path, path: str) -> None:
    """`train_dp_run` in a process of its own: deterministic mode needs
    cuBLAS's workspace configured before the process's first product."""
    env = {**os.environ, "CUBLAS_WORKSPACE_CONFIG": ":4096:8"}
    code = f"import sys, chip_smoke; sys.exit(chip_smoke.train_dp_run({path!r}, {str(tmp)!r}))"
    out = subprocess.run([sys.executable, "-c", code], cwd=Path(__file__).resolve().parent, env=env,
                         capture_output=True, text=True, timeout=600)
    for line in out.stdout.splitlines():
        print(line, flush=True)
    if out.returncode != 0:
        print(out.stderr[-4000:], file=sys.stderr, flush=True)
        raise AssertionError("the data-parallel trainer at world size 1 over NCCL differs from the plain one")


def two_rank_steps(rank: int, world: int) -> list[dict]:
    """TWO_RANK_STEPS steps at 64x128, 2 iterations, f32 with TF32 off,
    the volume corruption's noise branch forced and gt-as-mono on, of this
    rank's slice of a global batch of 4 (its samples' valid densities
    unequal), on cuda:0: each step's `step_record`, with the lr it took."""
    from stereoanywhere_tpu_torch.config import TrainConfig
    from stereoanywhere_tpu_torch.train.trainer import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    sa_model.draw_corruption = lambda *a: (1, 1, 3)  # stereo noise, mask 1
    tr = Trainer(StereoAnywhereConfig(volume_corruption_prob=1.0), TrainConfig(train_iters=2, gt_mono_prob=1.0), 10,
                 device="cuda:0")
    rng = np.random.default_rng(9)
    b, h, w, n = 4, 64, 128, 4 // world
    records = []
    for _ in range(TWO_RANK_STEPS):
        batch = {k: rng.uniform(0, 1, (b, h, w, c)) for k, c in (("im2_aug", 3), ("im3_aug", 3), ("mono2", 1),
                                                                   ("mono3", 1))}
        density = np.array([0.9, 0.9, 0.2, 0.2])[:, None, None, None]
        batch.update(gt=rng.uniform(1, 10, (b, h, w, 1)), gt_right=rng.uniform(1, 10, (b, h, w, 1)),
                     validgt=rng.uniform(0, 1, (b, h, w, 1)) < density,
                     validgt_right=rng.uniform(0, 1, (b, h, w, 1)) < density)
        batch = {k: v[rank * n:(rank + 1) * n].astype(np.float32) for k, v in batch.items()}
        lr = tr.lr
        records.append({**step_record(tr, tr.step(batch)), "lr": lr})
    return records


def _two_rank_worker(rank: int, world: int, init_method: str, out: str) -> None:
    from stereoanywhere_tpu_torch.parallel import multihost as mh

    mh.initialize_distributed("cuda:0", rank=rank, world_size=world, init_method=init_method, backend="gloo")
    try:
        torch.save(two_rank_steps(rank, world), f"{out}.{rank}")
    finally:
        mh.destroy_distributed()


def train_two_rank_phase(tmp: Path) -> None:
    """Two ranks on the one card over gloo with CUDA tensors (NCCL refuses
    two ranks on one device), spawned, against one process on the whole
    batch (`two_rank_steps`), each step within `train_compare_phase`'s
    bounds (the parameters within 2 lr a step so far)."""
    from stereoanywhere_tpu_torch.parallel.multihost import free_port

    out = str(tmp / "two_rank")
    ctx = torch.multiprocessing.start_processes(
        _two_rank_worker, args=(2, f"tcp://127.0.0.1:{free_port()}", out), nprocs=2, join=False,
        start_method="spawn")
    try:
        want = two_rank_steps(0, 1)
        deadline = time.monotonic() + 300
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                raise AssertionError("the two ranks did not finish within 300 s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    ok = True
    for rank in range(2):
        got = torch.load(f"{out}.{rank}", weights_only=False)
        for step in range(TWO_RANK_STEPS):
            bound = 2 * sum(r["lr"] for r in want[:step + 1])
            loss_rel, worst_grad, glob, worst_param = step_gaps(got[step], want[step], bound)
            print(f"train 2 ranks over gloo on cuda:0 vs one process, rank {rank} step {step + 1} (64x128, global "
                  f"batch 4, 2 iterations, f32, TF32 off, noise corruption and gt-as-mono forced): loss "
                  f"{got[step]['loss']:.6f} / {want[step]['loss']:.6f} (rel. {loss_rel:.2e}, tol 1e-4); gradients: "
                  f"worst {worst_grad[1]} at {worst_grad[0]:.2e} of its norm (tol 4e-2), all together {glob:.2e} "
                  f"(tol 5e-3); parameters: worst {worst_param[1]} at {worst_param[0]:.3f} of its bound", flush=True)
            ok &= loss_rel <= 1e-4 and worst_grad[0] <= 4e-2 and glob <= 5e-3 and worst_param[0] <= 1.0
    if not ok:
        raise AssertionError("two ranks on the card disagree with one process on the global batch")


def train_bf16_phase(tmp: Path, path: str, mb: Path) -> dict:
    """`cli train --dtype bfloat16` at the reference configuration for
    BF16_STEPS steps, logging every 5, validating on 2 Middlebury samples
    at step 10 (a bf16 copy of the masters; K5 32 a sample): losses finite,
    the masters f32, no kernel in a step; s/step over steps 6-10 (host
    clock between the log's sync at step 5 and the validation), pairs/s,
    the memory peak and one traced step.  Returns the validations' wrapper
    calls."""
    from stereoanywhere_tpu_torch.data.augmentor import DisparityAugmentor
    from stereoanywhere_tpu_torch.data.datasets import fetch_dataset
    from stereoanywhere_tpu_torch.data.loader import default_collate

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cudnn.benchmark = False
    save = tmp / "run_bf16"
    argv = train_argv(path, save, "bfloat16") + [
        "--num-steps", str(BF16_STEPS), "--save-every", "100", "--log-every", "5", "--val-datapath", str(mb),
        "--val-dataset", "middlebury", "--val-every", "10", "--val-samples", "2"]
    rec = _TrainRecorder()
    torch.cuda.reset_peak_memory_stats()
    log = io.StringIO()
    with rec.installed(), redirect_stdout(log):
        trainer = cli.main(argv)
    peak = torch.cuda.max_memory_allocated()
    for line in log.getvalue().splitlines():
        print(f"  cli train --dtype bfloat16: {line}", flush=True)
    losses = [r["loss/total"] for r in map(json.loads, open(save / "metrics.jsonl")) if "loss/total" in r]
    if not (len(losses) == BF16_STEPS // 5 and np.isfinite(losses).all()):
        raise AssertionError(f"cli train --dtype bfloat16: losses at the logs {losses}")
    if any(p.dtype != torch.float32 for p in trainer.model.parameters()) or any(rec.step_launches.values()):
        raise AssertionError("bf16 training: a master parameter left f32, or a kernel wrapper ran in a step")
    val_calls = {n: 0 for n in COUNTERS}
    for calls, metrics in rec.validations:
        if calls != {n: 0 for n in COUNTERS} | {"dual_lookup": ITERS * 2}:
            raise AssertionError(f"a bf16 validation of 2 samples called {calls}")
        val_calls = {n: val_calls[n] + c for n, c in calls.items()}
        print(f"train bf16 validation (2 Middlebury samples, 32 iterations, the bf16 copy): avgerr "
              f"{metrics['avgerr']:.4f}, bad 2.0 {metrics['bad 2.0']:.4f}", flush=True)
    sps = (rec.validate_starts[0] - dict(rec.step_starts)[5]) / 5
    print(f"train bf16 {BF16_STEPS} steps (crop 320x640, batch 2, 12 iterations, bf16 on f32 masters): {sps:.3f} "
          f"s/step over steps 6-10 ({2 / sps:.2f} pairs/s); device memory peak {peak / 1e9:.2f} GB; losses at the "
          f"logs {[round(x, 3) for x in losses]}", flush=True)
    ds = fetch_dataset("sceneflow", path, test=False, mono="DAv2",
                       augmentor=DisparityAugmentor(crop_size=(320, 640), seed=0))
    traced_train_step(trainer, default_collate([ds[0], ds[1]]))
    return val_calls


def train_bf16_compare_phase() -> None:
    """One mixed-precision step at 64x128, 2 iterations (TF32 off), on the
    card and on the CPU, and an f32 step on the CPU, from the same weights:
    the card's clipped bf16 gradient within twice the CPU's own gap between
    its bf16 and f32 gradients of the CPU's bf16 gradient, norm-wise (the
    rule `tests/test_torch_trainer.py` holds the CPU to against JAX), and
    the loss within twice the CPU's own bf16-vs-f32 gap or 1e-4
    relative."""
    import dataclasses

    from stereoanywhere_tpu_torch.config import TrainConfig
    from stereoanywhere_tpu_torch.train.trainer import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    cfg, tc = StereoAnywhereConfig(volume_corruption_prob=0.0), TrainConfig(train_iters=2, gt_mono_prob=0.0)
    bf16 = dataclasses.replace(cfg, compute_dtype="bfloat16")
    rng = np.random.default_rng(8)
    b, h, w = 2, 64, 128
    batch = {k: rng.uniform(0, 1, (b, h, w, c)).astype(np.float32)
             for k, c in (("im2_aug", 3), ("im3_aug", 3), ("mono2", 1), ("mono3", 1))}
    batch.update({k: rng.uniform(1, 10, (b, h, w, 1)).astype(np.float32) for k in ("gt", "gt_right")},
                 validgt=np.ones((b, h, w, 1), np.float32), validgt_right=np.ones((b, h, w, 1), np.float32))
    rec = {}
    for label, c, dev in (("cpu f32", cfg, "cpu"), ("cpu bf16", bf16, "cpu"), ("card bf16", bf16, "cuda")):
        tr = Trainer(c, tc, 10, device=dev)
        rec[label] = step_record(tr, tr.step(batch))
    flat = {k: torch.cat([g.reshape(-1) for g in r["grads"].values()]) for k, r in rec.items()}
    ref = flat["cpu f32"].norm().item()
    own = (flat["cpu bf16"] - flat["cpu f32"]).norm().item() / ref
    gap = (flat["card bf16"] - flat["cpu bf16"]).norm().item() / ref
    loss_own = abs(rec["cpu bf16"]["loss"] - rec["cpu f32"]["loss"]) / abs(rec["cpu f32"]["loss"])
    loss_gap = abs(rec["card bf16"]["loss"] - rec["cpu bf16"]["loss"]) / abs(rec["cpu f32"]["loss"])
    print(f"train bf16 step card vs CPU (64x128, 2 iterations, TF32 off): loss {rec['card bf16']['loss']:.5f} / "
          f"{rec['cpu bf16']['loss']:.5f} (f32 {rec['cpu f32']['loss']:.5f}; gap {loss_gap:.2e}, tol "
          f"{max(2 * loss_own, 1e-4):.2e}); clipped gradients, norm-wise: card vs CPU {gap:.3e}, the CPU's own "
          f"bf16 vs f32 {own:.3e} (tol 2x)", flush=True)
    if not (0 < own and gap <= 2 * own and loss_gap <= max(2 * loss_own, 1e-4)):
        raise AssertionError("the bf16 train step on the card disagrees with the CPU's")


def train_batch_stats_phase(path: str) -> None:
    """`freeze_bn=False` at the reference configuration (crop 320x640,
    batch 2, 12 iterations, fnet frozen, corruption 0.3) through `Trainer`
    (the CLI has no switch for it, as the JAX CLI has none), beside the
    same trainer with `freeze_bn=True`: BN_STEPS steps each on the same
    batches, loaded beforehand, a sync after each; s/step over the last
    three, losses finite, every running statistic moved with batch
    statistics and none without."""
    from stereoanywhere_tpu_torch.config import TrainConfig
    from stereoanywhere_tpu_torch.data.augmentor import DisparityAugmentor
    from stereoanywhere_tpu_torch.data.datasets import fetch_dataset
    from stereoanywhere_tpu_torch.data.loader import default_collate
    from stereoanywhere_tpu_torch.train.trainer import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cudnn.benchmark = False
    ds = fetch_dataset("sceneflow", path, test=False, mono="DAv2",
                       augmentor=DisparityAugmentor(crop_size=(320, 640), seed=0))
    batches = [default_collate([ds[2 * i % len(ds)], ds[(2 * i + 1) % len(ds)]]) for i in range(BN_STEPS)]
    runs = {}
    for freeze_bn in (True, False):
        tr = Trainer(StereoAnywhereConfig(freeze_bn=freeze_bn, volume_corruption_prob=0.3), TrainConfig(), 100,
                     device="cuda")
        stats = {k: v.clone() for k, v in tr.model.state_dict().items() if k.endswith(("running_mean", "running_var"))}
        starts, losses = [], []
        for batch in batches:
            starts.append(time.perf_counter())
            losses.append(float(tr.step(batch)["loss/total"]))
        now = tr.model.state_dict()
        runs[freeze_bn] = dict(sps=(time.perf_counter() - starts[-3]) / 3, losses=losses, stats=len(stats),
                               moved=sum(not torch.equal(now[k], v) for k, v in stats.items()))
    on, off = runs[False], runs[True]
    print(f"train freeze_bn=False ({BN_STEPS} steps, crop 320x640, batch 2, 12 iterations, f32): {on['sps']:.3f} "
          f"s/step over the last 3, against {off['sps']:.3f} with freeze_bn=True on the same batches (loaded "
          f"beforehand, a sync a step); losses {[round(x, 3) for x in on['losses']]}; running statistics moved: "
          f"{on['moved']} of {on['stats']} (freeze_bn=True: {off['moved']})", flush=True)
    if not (np.isfinite(on["losses"]).all() and on["moved"] == on["stats"] and off["moved"] == 0):
        raise AssertionError("freeze_bn=False: a loss is not finite, or the running statistics moved wrongly")


# ---------------------------------------------------------------------------
# the live capture loop at the OAK-D's 400P (phase 12)

CAMERA = (400, 640)  # the OAK-D's 400P, H x W
CAMERA_PLANE = (104, 160)  # K5's quarter-resolution plane: 400 padded to 416, over 4
CAMERA_FRAMES, CAMERA_CLI_FRAMES = 24, 8
# the host's parts of one frame, each a record_function range in the trace
CAMERA_PARTS = ("PNG decode", "pipeline call", ".cpu()", "EMA", "on_frame")


def decoders() -> str:
    """Which decoder the readers take: the native library where it built, PIL otherwise."""
    if port_native.available():
        return f"native ({port_native.library_path().name}: libpng, libjpeg)"
    return f"PIL (the native library did not build: {port_native.build_error()})"


def write_camera_frames(root: Path, rng) -> tuple[str, str]:
    """CAMERA_FRAMES synthetic 640x400 pairs as PNGs under root/left and
    root/right: grey, repeated to RGB, as OakDSource delivers a mono
    camera's rectified frames.  Returns the two globs."""
    for side in ("left", "right"):
        (root / side).mkdir(parents=True)
    for i in range(CAMERA_FRAMES):
        left, right, _ = _scene(rng, *CAMERA, 48.0)
        for side, view in (("left", left), ("right", right)):
            grey = np.round(view.astype(np.float32).mean(-1)).astype(np.uint8)
            Image.fromarray(np.repeat(grey[..., None], 3, axis=-1)).save(root / side / f"{i:05d}.png")
    return str(root / "left" / "*.png"), str(root / "right" / "*.png")


def recording_loop(seen: list, base=None):
    """port_camera.CaptureLoop that also keeps each frame's result dict and
    the host clock at its on_frame call in `seen`."""
    base = base or port_camera.CaptureLoop

    class Recording(base):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            on_frame = self.on_frame

            def both(res):
                seen.append(dict(res, at=time.perf_counter()))
                return on_frame(res) if on_frame is not None else None

            self.on_frame = both

    return Recording


def frame_ms(seen: list, t0: float) -> list[float]:
    """Each frame's wall ms: from the previous frame's on_frame call (the
    loop's start for the first) to its own."""
    at = [t0] + [r["at"] for r in seen]
    return [1e3 * (b - a) for a, b in zip(at, at[1:])]


def camera_kernel_rows() -> None:
    """K1-K4 at the camera's T (DAv2 at 518 x 826 for 400 x 640, B = 2
    views) and K5 at its 104 x 160 plane, bf16 and f32, against their plain
    versions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t = tokens_of(*CAMERA)
    if t != 2184:
        raise AssertionError(f"the camera's DAv2 tokens a view: {t}, expected 2184")
    vit_kernel_rows(torch.bfloat16, t, torch.Generator().manual_seed(40), VIT_L, label="camera ")
    plane_lookup_rows("camera plane", *CAMERA_PLANE, (1,), 60)


def traced_frame(pipe, source, on_frame) -> None:
    """The second frame of a two-frame CaptureLoop (warm: a replay, and the
    EMA's first real step), read from a trace of the loop, its host parts in
    ranges: device busy ms, idle share of the frame's wall time (its decode's
    start to its on_frame's end), host ms by part, and the replay's launches
    by wrapper (asserted: K1-K4 24, K5 32).  The profiler now and then drops
    a replay's events: three loops are traced and the one that kept the most
    kernels read."""
    def infer(left, right):
        with record_function("pipeline call"):
            out = pipe(left[None], right[None])
        with record_function(".cpu()"):
            return out.cpu().numpy()[0, ..., 0]

    ema = port_camera.ema_filter

    def ranged_ema(alpha):
        step = ema(alpha)

        def call(x):
            with record_function("EMA"):
                return step(x)
        return call

    def ranged_on_frame(res):
        with record_function("on_frame"):
            return on_frame(res)

    def ranged_source():
        frames = iter(source)
        for _ in range(2):
            with record_function("PNG decode"):
                frame = next(frames)
            yield frame

    def one_try():
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            port_camera.CaptureLoop(infer, on_frame=ranged_on_frame).run(ranged_source(), max_frames=2)
            torch.cuda.synchronize()
        events = prof.events()
        # the second frame starts at its decode; the first frame's kernels all ended before its .cpu() returned
        start = sorted(e.time_range.start for e in events
                       if e.device_type == DeviceType.CPU and e.name == "PNG decode")[1]
        frame = [e for e in events if e.time_range.start >= start]
        kernels = [e for e in frame if e.device_type == DeviceType.CUDA and e.name not in CAMERA_PARTS]
        host = defaultdict(float)
        end = start
        for e in frame:
            if e.device_type == DeviceType.CPU and e.name in CAMERA_PARTS:
                host[e.name] += (e.time_range.end - e.time_range.start) / 1e3
                end = max(end, e.time_range.end)
        return kernels, host, (end - start) / 1e3

    port_camera.ema_filter = ranged_ema
    try:
        tries = [one_try() for _ in range(3)]
    finally:
        port_camera.ema_filter = ema
    kernels, host, wall = max(tries, key=lambda t: len(t[0]))
    parts = ", ".join(f"{k} {host.get(k, 0.0):.2f}" for k in CAMERA_PARTS)
    if not kernels:
        print(f"camera trace: wall {wall:.1f} ms; device busy not measured (the profiler saw no device events); "
              f"host ms by part: {parts}", flush=True)
        return
    busy = busy_us([(e.time_range.start, e.time_range.end) for e in kernels]) / 1e3
    counts = trace_launches(e.name for e in kernels)
    print(f"camera trace, a warm frame (the second of a loop, a graph replay): wall {wall:.1f} ms, device busy "
          f"{busy:.1f} ms, idle share {1 - busy / wall:.3f}, {len(kernels)} kernels (the three traces: "
          f"{[len(t[0]) for t in tries]}); host ms by part: {parts}, the rest {wall - sum(host.values()):.2f} (the "
          f"pipeline call and .cpu() include the wait for the card); launches by wrapper from the trace {counts}",
          flush=True)
    if counts != EXPECTED["default"]:
        raise AssertionError(f"camera: the replayed frame launched {counts}, expected {EXPECTED['default']}")


def camera_phase() -> dict:
    """`cli camera`'s path at the OAK-D's 400P: ViT-L and the default
    stereo configuration, bf16, 32 iterations, random weights written as a
    reference `.tar` (stereo) and `.pth` (DAv2), PyTorch's defaults as the
    CLI runs them.  The local CaptureLoop over a DirectorySource of 24
    frames on the pipeline's graph (fps, warm frame ms, capture, wrapper
    calls a frame, one traced frame); the same loop through `infer_remote`
    against `make_http_server` (every remote disparity within the
    protocol's quantisation of the local one); `cli camera` on 8 frames
    with `--clip-top 8` from the `.tar` and from the `.msgpack` that `cli
    convert` writes (the PNGs, the disparities equal bit for bit);
    `chained_timer` of the 512^2 request beside `cuda_ms`; the decoders.
    Returns the wrapper calls of one eager frame, counted from 0."""
    print(f"native library: {'built' if port_native.available() else 'NOT built'}; the readers decode with "
          f"{decoders()}; the camera's DirectorySource decodes with PIL (as the JAX package's)", flush=True)
    camera_kernel_rows()
    # what the CLI runs: convolutions in TF32, products in f32, cuDNN's heuristics
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cudnn.benchmark = False
    tmp = Path(tempfile.mkdtemp(prefix="sa_camera_"))
    try:
        t0 = time.perf_counter()
        left_glob, right_glob = write_camera_frames(tmp / "frames", np.random.default_rng(14))
        tar, pth = tmp / "stereo.tar", tmp / "dav2_vitl.pth"
        stereo = StereoAnywhere(StereoAnywhereConfig(), device="cuda", generator=torch.Generator().manual_seed(41))
        torch.save({"state_dict": {f"module.{k}": v.cpu() for k, v in stereo.state_dict().items()}}, tar)
        mono = DepthAnythingV2(MonoConfig.for_encoder("vitl"), device="cuda", generator=torch.Generator().manual_seed(42))
        torch.save({k: v.cpu() for k, v in mono.state_dict().items()}, pth)
        del stereo, mono
        t1 = time.perf_counter()
        args = argparse.Namespace(checkpoint=str(tar), mono_checkpoint=str(pth), mono_encoder="vitl",
                                  dtype="bfloat16", iters=ITERS, device="cuda")
        pipe = cli._pipeline(args)
        print(f"camera: {CAMERA_FRAMES} frame pairs and the weights ({tar.stat().st_size / 1e6:.0f} + "
              f"{pth.stat().st_size / 1e6:.0f} MB) written in {t1 - t0:.1f} s; the CLI's pipeline loaded in "
              f"{time.perf_counter() - t1:.1f} s", flush=True)
        source = port_camera.DirectorySource(sorted(glob.glob(left_glob)), sorted(glob.glob(right_glob)))

        written_ms = defaultdict(list)

        def writer(out: Path):
            out.mkdir()

            def on_frame(res):  # what cli camera writes a frame
                t = time.perf_counter()
                Image.fromarray(port_camera.disparity_frame(res["smoothed"])).save(
                    out / f"frame_{res['index']:05d}.png")
                written_ms[out.name].append(1e3 * (time.perf_counter() - t))
            return on_frame

        calls = []

        def infer(left, right):
            before = {n: f.launches for n, f in COUNTERS.items()}
            disp = pipe(left[None], right[None]).cpu().numpy()[0, ..., 0]
            calls.append({n: f.launches - before[n] for n, f in COUNTERS.items()})
            return disp

        # the local loop: the first frame runs eagerly and captures the shape's graph, the others replay it; each
        # frame's on_frame writes its PNG, as cli camera's does
        local = []
        t0 = time.perf_counter()
        loop = recording_loop(local)(infer, on_frame=writer(tmp / "local"))
        n = loop.run(source)
        ms = frame_ms(local, t0)
        warm = ms[1:]
        program = pipe._build(1, *CAMERA)
        print(f"camera local loop, {n} frames of {CAMERA[1]}x{CAMERA[0]} (ViT-L, bf16, {ITERS} iterations, CUDA "
              f"graph, a JET PNG written a frame): {loop.stats['fps']:.2f} fps over the loop (the first frame's "
              f"warm-up and capture included); first frame {ms[0]:.1f} ms; warm frame median {np.median(warm):.1f} "
              f"ms [{min(warm):.1f}-{max(warm):.1f}] over {len(warm)} frames ({1e3 / np.median(warm):.2f} fps), of "
              f"which on_frame (JET and PNG) {np.median(written_ms['local']):.1f}; capture {program.capture_ms:.0f} "
              f"ms; graph pool {pipe.graph_pool_bytes() / 2 ** 30:.2f} GiB", flush=True)
        want = {k: 2 * v for k, v in EXPECTED["default"].items()}
        zero = {k: 0 for k in COUNTERS}
        if calls[0] != want or any(c != zero for c in calls[1:]):
            raise AssertionError(f"camera: wrapper calls a frame {calls[:3]}..., expected {want} then none")
        for f in COUNTERS.values():
            f.launches = 0
        from stereoanywhere_tpu_torch.ops.cuda import hourglass3d  # here: --spans and --ab run older checkouts too

        hourglass_before = hourglass3d.calls()
        eager_frame = eagerly(pipe, lambda: infer(*next(iter(source))))
        one = {n: f.launches for n, f in COUNTERS.items()}
        hourglass_calls = {k: v - hourglass_before[k] for k, v in hourglass3d.calls().items()}
        if hourglass_calls != {"fused": 1, "plain": 0}:  # the fused hourglass serves the frame
            raise AssertionError(f"camera: one eager frame's hourglass calls by path {hourglass_calls}")
        print(f"camera wrapper calls: the first frame {calls[0]} (warm-up and capture), each later frame none "
              f"(replays); one eager frame {one}", flush=True)
        if one != EXPECTED["default"]:
            raise AssertionError(f"camera: one eager frame ran the wrappers {one}, expected {EXPECTED['default']}")
        if not (np.isfinite(eager_frame).all() and all(np.isfinite(r["disparity"]).all() for r in local)
                and local[0]["disparity"].shape == CAMERA):
            raise AssertionError("camera: non-finite or misshapen disparity")
        t0 = time.perf_counter()
        traced_frame(pipe, source, writer(tmp / "traced"))
        print(f"camera: the traced loops took {time.perf_counter() - t0:.1f} s", flush=True)

        # the remote loop: the server answers on this thread (where the graph was captured), the loop asks from
        # another and writes its PNGs as the local one does
        remote = []
        server = make_http_server(pipe, "127.0.0.1", 0)
        server.timeout = 0.25  # handle_request returns when idle this long, so the loop below sees the client end
        url = f"http://127.0.0.1:{server.server_address[1]}"
        box = {}

        def client():
            try:
                t = time.perf_counter()
                rl = recording_loop(remote)(functools.partial(infer_remote, url), on_frame=writer(tmp / "remote"))
                box["n"], box["loop"], box["t0"] = rl.run(source), rl, t
            except BaseException as e:  # noqa: BLE001 - reported on this thread
                box["error"] = e
        thread = threading.Thread(target=client)
        thread.start()
        try:
            while thread.is_alive():
                server.handle_request()
            thread.join()
        finally:
            server.server_close()
        if "error" in box:
            raise box["error"]
        rms = frame_ms(remote, box["t0"])
        print(f"camera remote loop (infer_remote against make_http_server on 127.0.0.1, the same pipeline, a JET "
              f"PNG written a frame): {box['n']} frames, {box['loop'].stats['fps']:.2f} fps over the loop; frame "
              f"median {np.median(rms):.1f} ms [{min(rms):.1f}-{max(rms):.1f}], of which on_frame (JET and PNG) "
              f"{np.median(written_ms['remote']):.1f}", flush=True)
        worst = 0.0
        for a, b in zip((r["disparity"] for r in local), (r["disparity"] for r in remote)):
            inside = (a >= 0) & (a < 256)  # the protocol's range: uint16 / 256, negatives clipped to 0
            gap = a[inside] - b[inside]
            worst = max(worst, float(gap.max()))
            if not (gap.min() >= 0 and gap.max() < 1 / 256 and (b[a < 0] == 0).all()):
                raise AssertionError(f"camera: a remote disparity lies outside the protocol's quantisation of the "
                                     f"local one: gap in [{gap.min()}, {gap.max()}]")
        print(f"camera remote vs local: 0 <= local - remote < 1/256 px where 0 <= local < 256 (largest gap "
              f"{worst:.3e} px), remote 0 where local < 0, over {len(remote)} frames", flush=True)

        # chained_timer of the default 512^2 request beside cuda_ms of the same request, on the same pipeline
        g = torch.Generator(device="cuda").manual_seed(43)
        im2, im3 = (torch.rand((1, 512, 512, 3), generator=g, device="cuda") for _ in range(2))
        pipe(im2, im3)
        chained, samples = chained_timer(pipe, im2, im3, return_samples=True)
        events = cuda_ms(lambda: pipe(im2, im3), iters=10)
        print(f"camera tools: chained_timer of the 512x512 request (graph) {1e3 * chained:.2f} ms (runs "
              f"{[round(1e3 * s, 2) for s in samples]}) beside cuda_ms {events:.2f} ms: ratio "
              f"{1e3 * chained / events:.3f}", flush=True)
        del pipe, program
        gc.collect()
        torch.cuda.empty_cache()

        # cli camera, from the .tar and from the .msgpack cli convert writes, in this process and thread (so
        # cuDNN's heuristics pick the same algorithms)
        packed = tmp / "stereo.msgpack"
        with redirect_stdout(io.StringIO()) as said:
            cli.main(["convert", "--input", str(tar), "--output", str(packed)])
        print(f"camera: cli convert: {said.getvalue().strip()}", flush=True)
        runs = {}
        for label, ckpt in (("tar", tar), ("msgpack", packed)):
            seen = runs[label] = []
            port_camera.CaptureLoop, base = recording_loop(seen), port_camera.CaptureLoop
            try:
                t0 = time.perf_counter()
                with redirect_stdout(io.StringIO()):
                    cli.main(["camera", "--left-glob", left_glob, "--right-glob", right_glob, "-o",
                              str(tmp / f"cli_{label}"), "--checkpoint", str(ckpt), "--mono-checkpoint", str(pth),
                              "--dtype", "bfloat16", "--iters", str(ITERS), "--max-frames", str(CAMERA_CLI_FRAMES),
                              "--clip-top", "8"])
                wall = time.perf_counter() - t0
            finally:
                port_camera.CaptureLoop = base
            pngs = sorted((tmp / f"cli_{label}").iterdir())
            shapes = {np.asarray(Image.open(p)).shape for p in pngs}
            print(f"camera: cli camera --checkpoint {ckpt.name}: {len(pngs)} PNGs of {shapes} in {wall:.1f} s "
                  f"(models loaded, the capture included)", flush=True)
            if [p.name for p in pngs] != [f"frame_{i:05d}.png" for i in range(CAMERA_CLI_FRAMES)] or shapes != {
                    (CAMERA[0] - 8, CAMERA[1], 3)}:
                raise AssertionError(f"cli camera wrote {[p.name for p in pngs]} of {shapes}")
            gc.collect()
            torch.cuda.empty_cache()
        same = all(np.array_equal(a["smoothed"], b["smoothed"]) and np.array_equal(a["disparity"], b["disparity"])
                   for a, b in zip(runs["tar"], runs["msgpack"]))
        print(f"camera: cli camera from the .msgpack equals the .tar run bit for bit: {same} "
              f"({len(runs['tar'])} frames)", flush=True)
        if not (same and len(runs["tar"]) == len(runs["msgpack"]) == CAMERA_CLI_FRAMES):
            raise AssertionError("cli camera from the .msgpack differs from the .tar run")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return one


def ab_rows() -> list[dict]:
    """One --ab run over the package this process imported: K1 and K3 at
    both token counts, K7, K8 (with its device ms by launch), K9 at each
    scale and the K6 interface on both planes, bf16."""
    pkg = Path(stereoanywhere_tpu_torch.__file__).resolve().parents[1]
    if pkg != Path.cwd().resolve():
        raise RuntimeError(f"imported the package of {pkg}, not that of the checkout {Path.cwd()}")
    build.build(("vit_dense", "step_fused"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bf16, rows = torch.bfloat16, []

    def measure(name, shape, fn, ref, args, flops):
        got = fn(*args)
        torch.cuda.synchronize()
        err, _ = check(f"{name} {shape}", got, ref(*args), bf16)
        prof = device_profile(lambda: fn(*args))
        rows.append(dict(kernel=name, shape=shape, ms=cuda_ms(lambda: fn(*args)),
                         device_ms=None if prof is None else prof[0], host_ms=host_ms(lambda: fn(*args)),
                         flops=flops, max_abs_err=err,
                         stages=motion_stages(prof[1]) if name == "motion_encoder" and prof else None))

    g = torch.Generator().manual_seed(0)
    for t in (tokens_of(512, 512), tokens_of(*KITTI)):
        for name, fn, ref, _, args, flops, *_ in kernel_cases(bf16, t, g):
            if name in ("ln_dense", "dense_scale_residual"):
                measure(name, f"T={t}", fn, ref, args, flops)
    g = torch.Generator().manual_seed(1)
    for plane, (h4, w4) in STEP_PLANES.items():
        for name, fn, ref, args, flops, *_ in step_cases(bf16, h4, w4, g, border=False, lookup=False):
            if name.startswith(("flow_head", "motion_encoder", "conv_gru/", "gru_fused")):
                measure(name, plane, fn, ref, args, flops)
    return rows


def ab_main(other: Path) -> int:
    """--ab: this checkout's and other's K1, K3, K7, K8 and K9, in turns, each
    run in a process of its own whose working directory (first on its
    import path) is the checkout, running this file's code."""
    runs: dict[str, list[list[dict]]] = {"other": [], "this": []}
    here = Path(__file__).resolve()
    code = ("import runpy, sys; sys.argv = [sys.argv[1], '--ab-run']; "
            "runpy.run_path(sys.argv[0], run_name='__main__')")
    for label, root in (("other", other), ("this", here.parent), ("this", here.parent), ("other", other)):
        out = subprocess.run([sys.executable, "-c", code, str(here)], cwd=root, capture_output=True, text=True)
        if out.returncode != 0:
            print(out.stdout[-4000:], out.stderr[-4000:], file=sys.stderr)
            return 1
        rows = json.loads(out.stdout.strip().splitlines()[-1])
        for r in rows:
            print(f"{label} ({root}) run {len(runs[label]) + 1}: {r['kernel']} {r['shape']}: ms "
                  f"{fmt(r['ms'], r['flops'])} device_ms {fmt(r['device_ms'], r['flops'])} "
                  f"host_ms {r['host_ms']:.4f} max_abs_err {r['max_abs_err']:.3e}"
                  + (f"; device ms by launch {stages_text(r['stages'])}" if r["stages"] else ""), flush=True)
        runs[label].append(rows)
    print(card_line())
    print("CUDA-event ms a call [device ms; host ms], each checkout's two runs:")
    keys = [(r["kernel"], r["shape"]) for r in runs["this"][0]]
    for i, (kernel, shape) in enumerate(keys):
        print(f"  {kernel} {shape}: " + "; ".join(f"{lab} " + ", ".join(
            f"{rows[i]['ms']:.4f} [{fmt(rows[i]['device_ms'])}; {rows[i]['host_ms']:.4f}]" for rows in runs[lab])
            for lab in runs))
    for shape in sorted({s for k, s in keys if k.startswith("conv_gru/")}):
        print(f"  conv_gru, three scales summed, {shape}: " + "; ".join(f"{lab} " + ", ".join(
            f"{sum(r['ms'] for r in rows if r['kernel'].startswith('conv_gru/') and r['shape'] == shape):.4f}"
            for rows in runs[lab]) for lab in runs))
    return 0



# ---------------------------------------------------------------------------
# --spans: the port's spans and counters over the benchmark's cells

STAGES = ("sa.mono.", "sa.stereo.")
REQUEST_SPANS = ("request.call", "request.to_host", "sa.request", "sa.to_device", "sa.stage_inputs", "sa.replay",
                 "sa.copy_out")
KERNEL_CLASSES = {"elementwise": re.compile(r"elementwise_kernel"),
                  "layout transposes": re.compile(r"nchwToNhwc|nhwcToNchw|[Tt]ranspose")}


def _is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset"))


def _within(intervals, lo: float, hi: float) -> float:
    """us of the (merged) intervals inside [lo, hi]."""
    return sum(min(e, hi) - max(s, lo) for s, e in intervals if s < hi and e > lo)


def _merged(intervals) -> list[tuple[float, float]]:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def idle_by_host_span(pairs, host: dict, kernels) -> list[dict[str, float]]:
    """Each traced pair's idle device time (no kernel running; copies count
    as idle, as `port_bench` counts them), split by the innermost host span
    open at each moment of it (`pair` where no other is), ms."""
    busy = _merged((s, e) for _, s, e in kernels)
    out = []
    for ps, pe in pairs:
        spans = [(s, e, n) for n, lst in host.items() for s, e in lst if s >= ps and e <= pe]
        cuts = sorted({ps, pe, *(t for s, e, _ in spans for t in (s, e))})
        split = defaultdict(float)
        for a, b in zip(cuts, cuts[1:]):
            mid = (a + b) / 2
            inner = max(((s, n) for s, e, n in spans if s <= mid < e), default=(ps, "pair"))[1]
            split[inner] += ((b - a) - _within(busy, a, b)) / 1e3
        out.append(dict(split))
    return out


def graph_split(events, row: dict, pairs_traced: int) -> None:
    """Adds one traced stretch of graph pairs to `row`: each pair's host ms
    in the benchmark's ranges and the port's request spans, its idle device
    ms by innermost host span, and device ms a pair by span (kernels and
    copies apart)."""
    from stereoanywhere_tpu_torch.utils.profiling import device_by_span, spans_of

    pairs = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == DeviceType.CPU and e.name == "pair")
    host = {n: [(e.time_range.start, e.time_range.end) for e in events
                if e.device_type == DeviceType.CPU and e.name == n] for n in REQUEST_SPANS[:2]}
    host.update({k: v for k, v in spans_of(events).items() if k in REQUEST_SPANS})
    for name, lst in host.items():
        row["host_ms"][name] += [_within(lst, s, e) / 1e3 for s, e in pairs]
    by_span = device_by_span(events)
    for name, ks in by_span.items():
        for kind, copies in (("kernels", False), ("copies", True)):
            row["graph_device_ms"][f"{name or '-'} {kind}"] += busy_us(
                [(s, e) for k, s, e in ks if _is_copy(k) == copies]) / 1e3 / pairs_traced
    kernels = [k for ks in by_span.values() for k in ks if not _is_copy(k[0])]
    for split in idle_by_host_span(pairs, host, kernels):
        for name, ms in split.items():
            row["idle_ms"][name].append(ms)


def eager_split(events, pairs: int) -> dict:
    """The eager pass's device busy ms a pair, each stage's (`sa.mono.*`,
    `sa.stereo.*`), what lies outside every stage, and each stage's kernel
    classes (kernel ms and kernels a pair) and top three kernels (copies
    count as idle)."""
    from stereoanywhere_tpu_torch.utils.profiling import device_by_span

    by_span = {k: [x for x in v if not _is_copy(x[0])] for k, v in device_by_span(events).items()}
    stages = {k: v for k, v in by_span.items() if k.startswith(STAGES)}
    top = {}
    for k, v in stages.items():
        ms = defaultdict(float)
        for name, s, e in v:
            ms[re.sub(r"[<(].*", "", name.replace("(anonymous namespace)::", ""))[-60:]] += (e - s) / 1e3 / pairs
        top[k] = sorted(ms.items(), key=lambda kv: -kv[1])[:3]
    return {"eager_busy_ms": busy_us([(s, e) for v in by_span.values() for _, s, e in v]) / 1e3 / pairs,
            "eager_stage_ms": {k: busy_us([(s, e) for _, s, e in v]) / 1e3 / pairs for k, v in stages.items()},
            "eager_unspanned_ms": busy_us([(s, e) for k, v in by_span.items() if k not in stages
                                           for _, s, e in v]) / 1e3 / pairs,
            "eager_classes_ms": {k: {c: sum(e - s for name, s, e in v if rx.search(name)) / 1e3 / pairs
                                     for c, rx in KERNEL_CLASSES.items()} for k, v in stages.items()},
            "eager_classes_n": {k: {c: sum(1 for name, _, _ in v if rx.search(name)) / pairs
                                    for c, rx in KERNEL_CLASSES.items()} for k, v in stages.items()},
            "eager_top": top}


def spans_rows() -> list[dict]:
    """One --spans run over the checkout this process imported: for each of
    the benchmark's cells, its program built and warmed as `port_bench`
    builds it (seed 11), three traced stretches of the cell's graph pairs in
    the benchmark's own ranges (`pair`, `request.call`, `request.to_host`),
    and where the port has spans and counters (not in a checkout older than
    them), the split of each (`graph_split`) and of an eager pass
    (`eager_split`)."""
    from port_bench import harness, traffic

    pkg = Path(stereoanywhere_tpu_torch.__file__).resolve().parents[1]
    if pkg != Path.cwd().resolve():
        raise RuntimeError(f"imported the package of {pkg}, not that of the checkout {Path.cwd()}")
    build.build()
    dev, seed, rows = torch.device("cuda"), 11, []
    bench = harness.load_benchmark(Path.cwd())
    for cell in bench["workloads"]:
        cfg, mix = harness.config_of(bench, cell["config"]), harness.traffic_of(cell["traffic"])
        pipe = harness.build_program(cfg, dev, seed)
        pool = traffic.make_pool(mix, seed, dev)
        for left, right in pool:
            pipe(left, right).cpu()
        torch.cuda.synchronize()
        spans = hasattr(pipe, "counters")
        row = {"cell": cell["name"], "counters_setup": pipe.counters() if spans else None, "pair_ms": [],
               "host_ms": defaultdict(list), "idle_ms": defaultdict(list), "graph_device_ms": defaultdict(float)}
        n, stretches = mix["trace_pairs"], 3
        for _ in range(stretches):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for i in range(n):
                    left, right = pool[i % len(pool)]
                    with record_function("pair"):
                        with record_function("request.call"):
                            out = pipe(left, right)
                        with record_function("request.to_host"):
                            out.cpu().numpy()
                torch.cuda.synchronize()
            events = prof.events()
            row["pair_ms"] += [(e - s) / 1e3 for s, e in sorted(
                (e.time_range.start, e.time_range.end) for e in events
                if e.device_type == DeviceType.CPU and e.name == "pair")]
            if spans:
                graph_split(events, row, n * stretches)
        if spans:
            row["counters_end"] = pipe.counters()
            m = mix["eager_trace_pairs"]
            pipe.graphs = False
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for i in range(m):
                    left, right = pool[i % len(pool)]
                    with record_function("pair"):
                        pipe(left, right).cpu().numpy()
                torch.cuda.synchronize()
            pipe.graphs = True
            row.update(eager_split(prof.events(), m))
        rows.append(row)
        del pipe, pool
        gc.collect()
        torch.cuda.empty_cache()
    return rows


def spans_main(other: Path) -> int:
    """--spans: the benchmark's cells on this checkout and other, in turns
    (other, this, this, other), each a process of its own run from its
    checkout: the traced graph pair's mean (the cost of the spans when a
    profiler records), and each run's split by span."""
    here = Path(__file__).resolve()
    code = ("import runpy, sys; sys.argv = [sys.argv[1], '--spans-run']; "
            "runpy.run_path(sys.argv[0], run_name='__main__')")
    runs = defaultdict(list)
    for label, root in (("other", other), ("this", here.parent), ("this", here.parent), ("other", other)):
        out = subprocess.run([sys.executable, "-c", code, str(here)], cwd=root, capture_output=True, text=True)
        if out.returncode != 0:
            print(out.stdout[-4000:], out.stderr[-4000:], file=sys.stderr)
            return 1
        runs[label].append(json.loads(out.stdout.strip().splitlines()[-1]))
    print(card_line())
    for i, cell in enumerate(r["cell"] for r in runs["this"][0]):
        print(f"{cell}: traced graph pair ms, mean [median] of {len(runs['this'][0][i]['pair_ms'])} a run: " + "; ".join(
            f"{lab} " + ", ".join(f"{np.mean(rows[i]['pair_ms']):.3f} [{np.median(rows[i]['pair_ms']):.3f}]"
                                   for rows in runs[lab]) for lab in ("other", "this")), flush=True)
        for lab, k, row in ((lab, k, rows[i]) for lab in ("other", "this") for k, rows in enumerate(runs[lab])):
            print(f"  {lab} run {k + 1}: counters after set-up {row['counters_setup']}, at the end {row['counters_end']}")
            print("    host ms a graph pair, median [mean]: " + ", ".join(
                f"{n} {np.median(v):.3f} [{np.mean(v):.3f}]" for n, v in row["host_ms"].items()))
            print("    idle device ms a graph pair by innermost host span, median [mean]: " + ", ".join(
                f"{n} {np.median(v):.3f} [{np.mean(v):.3f}]" for n, v in sorted(row["idle_ms"].items())))
            print("    graph pair device ms by span: " + ", ".join(
                f"{n} {ms:.3f}" for n, ms in sorted(row["graph_device_ms"].items()) if ms))
            stages = row["eager_stage_ms"]
            print(f"    eager pair: busy {row['eager_busy_ms']:.3f} ms, stages sum {sum(stages.values()):.3f} "
                  f"({100 * sum(stages.values()) / row['eager_busy_ms']:.2f}%), outside every stage "
                  f"{row['eager_unspanned_ms']:.3f} ({100 * row['eager_unspanned_ms'] / row['eager_busy_ms']:.2f}%)")
            for n, ms in stages.items():
                cls, count = row["eager_classes_ms"][n], row["eager_classes_n"][n]
                print(f"      {n} {ms:.3f} ms; " + ", ".join(f"{c} {v:.3f} ({count[c]:g} a pair)" for c, v in cls.items())
                      + "; top " + ", ".join(f"{name} {v:.3f}" for name, v in row["eager_top"][n]))
    return 0

START = time.perf_counter()


def timed(name: str, fn, *args):
    """fn(*args), with its wall seconds printed on a line of their own."""
    t0 = time.perf_counter()
    try:
        return fn(*args)
    finally:
        print(f"phase {name}: {time.perf_counter() - t0:.1f} s", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    args = sys.argv[1:]
    if args == ["--tiles"]:
        return tiles_main()
    if args == ["--rowshard-cards"]:
        return rowshard_cards_main()
    if args == ["--ab-run"]:  # one run of --ab, in the checkout this process imported
        print(json.dumps(ab_rows()))
        return 0
    if len(args) == 2 and args[0] == "--ab":
        return ab_main(Path(args[1]).resolve())
    if args == ["--spans-run"]:  # one run of --spans, in the checkout this process imported
        print(json.dumps(spans_rows()))
        return 0
    if len(args) == 2 and args[0] == "--spans":
        return spans_main(Path(args[1]).resolve())
    if args:
        print(__doc__, file=sys.stderr)
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
    t0 = time.perf_counter()
    built = port_native.available()
    print(f"native library (native/stereodata.cc, g++): {'built' if built else 'NOT built'} in "
          f"{time.perf_counter() - t0:.1f} s" + (f" at {port_native.library_path()}" if built else
                                               f": {port_native.build_error()}"), flush=True)
    sass_counts(paths)
    records = {**timed("kernels K1-K4", kernel_phase), **timed("kernels K5-K9", step_kernel_phase)}
    hourglass_record = timed("kernels K10", hourglass_kernel_phase)
    vitg_records = timed("kernels ViT-G", vitg_kernel_phase)
    timed("capture", capture_phase)
    launches, replayed = timed("pipeline default", pipeline_phase, "default",
                               StereoAnywhereConfig(compute_dtype="bfloat16"))
    torch.cuda.empty_cache()
    fused, fused_replayed = timed("pipeline fused", pipeline_phase, "fused",
                                  StereoAnywhereConfig(compute_dtype="bfloat16", fused_level0="on"))
    torch.cuda.empty_cache()
    vitg, _ = timed("pipeline vitg", pipeline_phase, "vitg", StereoAnywhereConfig(compute_dtype="bfloat16"), "vitg",
                    False)
    torch.cuda.empty_cache()
    variant, variant_replayed = timed("pipeline variant", pipeline_phase, "variant",
                                      StereoAnywhereConfig(compute_dtype="bfloat16", **VARIANT), "vitl", False)
    torch.cuda.empty_cache()
    timed("compare", compare_phase)
    timed("compare vitg", vitg_compare_phase)
    timed("variants card vs cpu", variants_compare_phase)
    highres, booster = timed("highres", highres_phase)
    rowshard, rowshard_fused = timed("rowshard", rowshard_phase)
    evaluated = timed("eval", eval_phase)
    timed("eval card vs cpu", eval_compare_phase)
    camera = timed("camera", camera_phase)
    tmp = Path(tempfile.mkdtemp(prefix="sa_train_"))
    try:
        path, mb = write_train_data(tmp)
        trained, validated = timed("train", train_phase, tmp, path, mb)
        timed("train card vs cpu", train_compare_phase)
        timed("train dp", train_dp_phase, tmp, path)
        timed("train two ranks", train_two_rank_phase, tmp)
        bf16_validated = timed("train bf16", train_bf16_phase, tmp, path, mb)
        timed("train bf16 card vs cpu", train_bf16_compare_phase)
        timed("train batch stats", train_batch_stats_phase, path)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"phase all: {time.perf_counter() - START:.1f} s since the script started", flush=True)
    validated = {n: c + bf16_validated[n] for n, c in validated.items()}
    if GRAPH_FAILURES:
        raise AssertionError("replays differ from eager: " + "; ".join(GRAPH_FAILURES))
    kernels = []
    for name, row in records.items():
        src, replaces = SOURCE[name]
        # each kernel's wrapper calls on the main path (the default
        # configuration) where it runs there, else on the fused one; beside
        # them its launches in one replayed 512^2 request, from the trace;
        # its calls in the ViT-G pipeline's served requests, in the train
        # steps and in the trainer's validations
        n, per_replay = (launches[name], replayed) if name in MAIN_PATH else (fused[name], fused_replayed)
        g = vitg_records.get(name)
        kernels.append(dict(name=name, route="cuda", source=src, replaces=replaces, launches=n,
                            replay_launches=None if per_replay is None else per_replay[name],
                            eval_launches=evaluated[name], vitg_launches=vitg[name], train_launches=trained[name],
                            validation_launches=validated[name], highres_launches=highres[name],
                            booster_launches=booster[name], rowshard_launches=rowshard[name],
                            camera_launches=camera[name], variant_launches=variant[name],
                            variant_replay_launches=None if variant_replayed is None else variant_replayed[name],
                            rowshard_fused_launches=rowshard_fused[name],
                            max_abs_err=row["max_abs_err"], ms=row["ms"], device_ms=row["device_ms"],
                            host_ms=row["host_ms"], plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
                            bound_by=row["bound_by"], library_ms=row["library_ms"], unfused_ms=row.get("unfused_ms"),
                            **({"sector_bound_ms": row["sector_bound_ms"]} if "sector_bound_ms" in row else {}),
                            **({f"vitg_{k}": g[k] for k in ("max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms",
                                                             "bound_by", "library_ms", "cublas_product_ms")}
                               if g else {})))
    # K10: its launches in one eager request of each pipeline and in one
    # replayed request (traced), its checks and times at the KITTI volume
    # (the OAK-D one's under `oakd_`)
    src, replaces = SOURCE["hourglass3d"]
    kernels.append(dict(name="hourglass3d", route="cuda", source=src, replaces=replaces,
                        launches=launches["hourglass3d"],
                        replay_launches=None if replayed is None else replayed.get("hourglass3d"),
                        fused_launches=fused["hourglass3d"], vitg_launches=vitg["hourglass3d"],
                        variant_launches=variant["hourglass3d"],
                        variant_replay_launches=None if variant_replayed is None else variant_replayed.get("hourglass3d"),
                        library_ms=None, **hourglass_record))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
