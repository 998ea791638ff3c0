"""Serving pipeline: image pair in [0,1] -> positive disparity.

The port of the JAX package's `serve/pipeline.py`:
1. resize both views to the DAv2 input size with `jax.image.resize`'s
   antialiased Keys cubic (a=-0.5) and run DAv2 on them as one batch;
2. resize the depth back (antialiased bilinear), joint min-max normalize;
3. edge-pad to a multiple of 32, run StereoAnywhere, unpad.

Where the JAX pipeline compiles one XLA program per input shape (`_build`,
and the mono and stereo programs of two-stage mode, `_build_two_stage`),
the port captures one CUDA graph per input shape and batch: the first call
of a shape runs eagerly, which warms everything a capture must find ready
(cuDNN's algorithm search, the resize matrices, the kernels' TMA maps and
shared-memory limits, the fused loop's packed weights), then captures the
same call; every later call of the shape copies the request into the
graph's static inputs, replays it and returns a copy of its output.  All
the graphs of a pipeline share one memory pool, so the two graphs of
two-stage mode, which replay in turn with the depth moved through host
memory between them, hold the activations of one branch at a time.  A
capture or replay that fails raises; nothing falls back to eager.  On the
CPU, and with `graphs=False`, the same calls run eagerly.

With a `mesh` (`parallel/mesh.py`), as the JAX pipeline's `mesh=`, the
stereo branch's image rows are sharded over the mesh's `shard_axis`
(`parallel/spatial.py`): each rank runs the mono stage whole, the joint
min-max and the padding, then its rows of the stereo forward, and the
axis's first rank gets the gathered, unpadded disparity (the others get
None).  Such a pipeline runs eagerly.

`serve_http` keeps the JAX request format: POST /infer with an
X-Meta-Length JSON header ({"h", "w"}) and float32 (2, H, W, 3) pixels,
answered with uint16 disparity x256; `serve/client.py` is its client.

While a profiler records, a request's phases are spans of
`utils/profiling.py` (`sa.request`, `sa.to_device`, and a program's
`sa.warmup`, `sa.capture`, `sa.stage_inputs`, `sa.replay`, `sa.copy_out`),
and the mono and stereo stages name theirs.  `GraphOwner.counters()` says
at any time how many requests came and how many calls warmed up, captured
or replayed: a capture of a new shape shows there.
"""
from __future__ import annotations

import gc
import json
import time
from contextlib import contextmanager
from http.server import BaseHTTPRequestHandler, HTTPServer
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from stereoanywhere_tpu_torch.config import MonoConfig, StereoAnywhereConfig
from stereoanywhere_tpu_torch.device import holding_constants, resolve_device
from stereoanywhere_tpu_torch.models.dpt import DepthAnythingV2, dav2_input_size, imagenet_normalize
from stereoanywhere_tpu_torch.models.stereoanywhere import StereoAnywhere
from stereoanywhere_tpu_torch.ops.geometry import joint_minmax_normalize
from stereoanywhere_tpu_torch.ops.interp import resize_jax_image
from stereoanywhere_tpu_torch.parallel.spatial import RowShardedInference
from stereoanywhere_tpu_torch.utils.profiling import span


def _pad_sizes(h: int, w: int, multiple: int = 32):
    ph = (multiple - h % multiple) % multiple
    pw = (multiple - w % multiple) % multiple
    return ph // 2, ph - ph // 2, pw // 2, pw - pw // 2


def normalize_and_pad(im2, im3, mde2, mde3) -> tuple[list[torch.Tensor], tuple[int, int]]:
    """The stereo stage's input preparation: joint min-max normalize the
    depth pair, edge-pad the views and the depth to a multiple of 32.
    (B,H,W,3) views and (B,H,W,1) depth (device tensors) -> the four padded
    NHWC inputs of the model, and the (top, left) offset of the image in
    them."""
    _, h, w, _ = im2.shape
    t, bot, l, r = _pad_sizes(h, w)
    mde2, mde3 = joint_minmax_normalize([m.permute(0, 3, 1, 2) for m in (mde2, mde3)])
    pad = lambda x: F.pad(x, (l, r, t, bot), mode="replicate").permute(0, 2, 3, 1)  # noqa: E731
    return [pad(im2.permute(0, 3, 1, 2)), pad(im3.permute(0, 3, 1, 2)), pad(mde2), pad(mde3)], (t, l)


@contextmanager
def _collector_paused():
    """No cyclic garbage collection inside the block.  A collection during
    a capture may free a dropped program's graph (a pipeline and its
    programs' bodies refer to each other, so only the cyclic collector
    frees them), and destroying a graph is not permitted while a stream
    captures: the capture would be invalidated."""
    enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if enabled:
            gc.enable()


def _copy(out):
    return tuple(o.clone() for o in out) if isinstance(out, tuple) else out.clone()


class _Program:
    """One input shape's program: `body` (a tensor or a tuple of tensors
    from device tensors) and, once captured, its CUDA graph.

    `capture_at=1` (the serving pipeline's): the first call runs the body
    eagerly (the warm-up) and then captures it; later calls replay.
    `capture_at=2`: the first call runs the body eagerly only; the second
    captures and replays, so a key called once never pays a capture.  A
    capture that fails raises, keeps no graph and warms up again at the
    next call.  The graph reads its static inputs, the parameters, the
    packed weights (refreshed in place by a load) and the device constants
    it was handed during the capture, which it holds (`held`), so that the
    constants' cache may evict them.  `capture_ms` is the capture's host
    time.  `counts` holds the program's calls, warm-ups, captures (that
    succeeded), replays and the captures' summed host ms.  The cyclic
    garbage collector is paused while a graph captures (`_collector_paused`)."""

    COUNTS = ("calls", "warmups", "captures", "replays", "capture_ms")

    def __init__(self, body: Callable, pool, capture_at: int = 1):
        if capture_at not in (1, 2):
            raise ValueError(f"capture_at {capture_at}: 1 (with the warm-up) or 2 (at the second call)")
        self.body, self.pool, self.capture_at = body, pool, capture_at
        self.graph, self.warmed = None, False
        self.counts = dict.fromkeys(self.COUNTS, 0)

    def __call__(self, *inputs):
        self.counts["calls"] += 1
        if self.graph is None:
            if not self.warmed:
                with span("sa.warmup"):
                    out = self.body(*inputs)
                self.warmed = True
                self.counts["warmups"] += 1
                if self.capture_at == 1:
                    self._capture(inputs)
                return out
            self._capture(inputs)
        else:
            with span("sa.stage_inputs"):
                for static, x in zip(self.inputs, inputs):
                    static.copy_(x)
        with span("sa.replay"):
            self.graph.replay()
        self.counts["replays"] += 1
        with span("sa.copy_out"):
            return _copy(self.output)

    def _capture(self, inputs) -> None:
        t0 = time.perf_counter()
        with span("sa.capture"):
            static = [x.clone() for x in inputs]
            graph = torch.cuda.CUDAGraph()
            try:
                with _collector_paused(), holding_constants() as held, torch.cuda.graph(graph, pool=self.pool):
                    output = self.body(*static)
            except BaseException:
                self.warmed = False
                raise
        self.graph, self.inputs, self.output, self.held = graph, static, output, held
        self.capture_ms = 1e3 * (time.perf_counter() - t0)
        self.counts["captures"] += 1
        self.counts["capture_ms"] += self.capture_ms


def pool_bytes(pool) -> int:
    """Device memory held in a graph pool (0 for None, the CPU's)."""
    if pool is None:
        return 0
    return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
               if tuple(s["segment_pool_id"]) == tuple(pool))


class GraphOwner:
    """What an owner of `_Program`s shares: its device (the card unless
    "cpu" is asked for), whether its calls take their graphs (`graphs`, on
    by default on the card; the CPU runs only eagerly and refuses it), one
    graph pool for all its programs (made by `_program`), the count of its
    requests, and the move of a request's tensors or arrays to the device in
    f32."""

    def __init__(self, device: str | torch.device, graphs: bool | None):
        self.device = resolve_device(device)
        self.graphs = self.device.type == "cuda" if graphs is None else graphs
        self._pool = torch.cuda.graph_pool_handle() if self.device.type == "cuda" else None
        self._programs_made: list[_Program] = []
        self.requests = 0

    def _program(self, body: Callable, capture_at: int = 1) -> _Program:
        program = _Program(body, self._pool, capture_at)
        self._programs_made.append(program)
        return program

    def counters(self) -> dict[str, float]:
        """The owner's `requests` and its programs' `counts` summed: calls,
        warm-ups, captures, replays and the captures' host ms.  Polled over
        time, a rise in `captures` is a new shape (or batch) captured."""
        return {"requests": self.requests, **{k: sum(p.counts[k] for p in self._programs_made)
                                              for k in _Program.COUNTS}}

    @property
    def graphs(self) -> bool:
        return self._graphs

    @graphs.setter
    def graphs(self, on: bool) -> None:
        if on and self.device.type != "cuda":
            raise ValueError(f"CUDA graphs need the card: this {type(self).__name__} runs on the CPU")
        self._graphs = bool(on)

    def graph_pool_bytes(self) -> int:
        """Device memory that the owner's graphs hold (their one pool)."""
        return pool_bytes(self._pool)

    def _tensor(self, x) -> torch.Tensor:
        if not torch.is_tensor(x):
            x = torch.from_numpy(np.array(x, dtype=np.float32))
        return x.to(self.device, torch.float32)


class StereoAnywherePipeline(GraphOwner):
    """(B,H,W,3) pair in [0,1] -> (B,H,W,1) positive disparity (f32).

    `mono=None` runs stereo-only with mono depth given by the caller (or
    zeros); with a mono model loaded, depth is always computed and the
    caller's is ignored, as in the JAX pipeline.  `two_stage=True` runs the
    mono stage and the stereo stage as two programs, with the depth moved
    through host memory between them.  `device` defaults to the card and
    raises without one unless "cpu" is asked for; the models are moved
    there.  `graphs` (default: on the card) serves each (B, H, W) from its
    CUDA graph; `graphs=False` runs every call eagerly (kernel by kernel,
    as a profiler's module ranges need), and the CPU runs only so.
    A load of weights into the models is seen by the graphs: parameters
    are filled in place and the fused loop's packed weights packed anew in
    place; a load that replaces the parameter tensors (`assign=True`)
    needs a new pipeline.  `mesh` shards the stereo branch's rows over
    its `shard_axis` (eager only; None on all but the axis's first rank).
    """

    def __init__(
        self,
        stereo: StereoAnywhere,
        mono: DepthAnythingV2 | None = None,
        iters: int = 32,
        mono_size: tuple[int, int] = (518, 518),
        device: str | torch.device = "cuda",
        two_stage: bool = False,
        graphs: bool | None = None,
        mesh=None,
        shard_axis: str = "tile",
    ):
        self.rows = None
        super().__init__(device, False if mesh is not None else graphs)
        self.stereo = stereo.to(self.device)
        self.mono = mono.to(self.device) if mono is not None else None
        self.iters = iters
        self.mono_size = mono_size
        self.two_stage = two_stage
        if mesh is not None:
            self.rows = RowShardedInference(self.stereo, mesh, shard_axis, iters)
            self.graphs = bool(graphs)
        self._cache: dict = {}

    @GraphOwner.graphs.setter
    def graphs(self, on: bool) -> None:
        if on and self.rows is not None:
            raise ValueError("a row-sharded pipeline (mesh=...) runs eagerly: CUDA graphs of its collectives "
                             "are not supported")
        GraphOwner.graphs.fset(self, on)

    def _build(self, b: int, h: int, w: int) -> _Program:
        """The one-graph program of (b, h, w): mono (when loaded), pad and
        stereo; stereo-only, it takes the depth pair as inputs."""
        key = (b, h, w)
        if key not in self._cache:
            if self.mono is not None:
                body = lambda im2, im3: self.stereo_stage(im2, im3, *self.mono_stage(im2, im3))  # noqa: E731
            else:
                body = lambda *views: self.stereo_stage(*views)  # noqa: E731
            self._cache[key] = self._program(body)
        return self._cache[key]

    def _build_two_stage(self, b: int, h: int, w: int) -> tuple[_Program, _Program]:
        """The mono and the stereo program of (b, h, w), on the one pool."""
        key = ("2s", b, h, w)
        if key not in self._cache:
            self._cache[key] = (self._program(lambda im2, im3: self.mono_stage(im2, im3)),
                                self._program(lambda *views: self.stereo_stage(*views)))
        return self._cache[key]

    def _run(self, program: _Program, *inputs):
        if not self.graphs:
            return program.body(*inputs)
        return program(*(self._tensor(x) for x in inputs))

    @torch.inference_mode()
    def mono_stage(self, im2, im3) -> tuple[torch.Tensor, torch.Tensor]:
        """DAv2 on both views as one batch, at the DAv2 input size, resized
        back.  (B,H,W,3) -> two (B,H,W,1), f32.  Runs eagerly."""
        im2, im3 = self._tensor(im2), self._tensor(im3)
        b, h, w, _ = im2.shape
        fh, fw = dav2_input_size(h, w, self.mono_size[0], self.mono_size[1])
        with span("sa.mono.resize_in"):
            both = torch.cat([im2, im3], dim=0).permute(0, 3, 1, 2)
            x = imagenet_normalize(resize_jax_image(both, (fh, fw), "cubic").permute(0, 2, 3, 1))
        depth = self.mono(x)
        with span("sa.mono.resize_out"):
            depth = resize_jax_image(depth.float().permute(0, 3, 1, 2), (h, w), "bilinear").permute(0, 2, 3, 1)
        return depth[:b], depth[b:]

    @torch.inference_mode()
    def stereo_stage(self, im2, im3, mde2, mde3) -> torch.Tensor:
        """Joint min-max normalize the depth pair, edge-pad to a multiple of
        32, run StereoAnywhere, unpad.  (B,H,W,3) views and (B,H,W,1) depth
        -> (B,H,W,1) disparity, f32 (None on a row-sharded pipeline's
        other ranks).  Runs eagerly."""
        im2, im3, mde2, mde3 = (self._tensor(x) for x in (im2, im3, mde2, mde3))
        _, h, w, _ = im2.shape
        with span("sa.stereo.prepare"):
            inputs, (t, l) = normalize_and_pad(im2, im3, mde2, mde3)
        if self.rows is None:
            disparity = self.stereo(*inputs, iters=self.iters)["disparity"]
        else:
            self.rows.iters = self.iters
            disparity = self.rows.gather_rows(self.rows.infer(*inputs), dst=0)
            if disparity is None:
                return None
        with span("sa.stereo.upsample"):
            return disparity[:, t : t + h, l : l + w].float()

    @torch.inference_mode()
    def __call__(self, im2, im3, mde2=None, mde3=None) -> torch.Tensor:
        n = self.requests
        self.requests += 1
        with span("sa.request", {"n": n}):
            with span("sa.to_device"):
                im2, im3 = self._tensor(im2), self._tensor(im3)
            b, h, w, _ = im2.shape
            if self.mono is None:
                if mde2 is None:
                    mde2 = mde3 = torch.zeros((b, h, w, 1), device=self.device)
                return self._run(self._build(b, h, w), im2, im3, mde2, mde3)
            if self.two_stage and mde2 is None:  # JAX's rule: given depth takes the one-graph path
                mono, stereo = self._build_two_stage(b, h, w)
                mde2, mde3 = (d.cpu().numpy() for d in self._run(mono, im2, im3))  # the host round trip
                return self._run(stereo, im2, im3, mde2, mde3)
            return self._run(self._build(b, h, w), im2, im3)


def build_pipeline(
    stereo_cfg: StereoAnywhereConfig = StereoAnywhereConfig(),
    mono_cfg: MonoConfig | None = MonoConfig(),
    iters: int = 32,
    mono_size: tuple[int, int] = (518, 518),
    device: str | torch.device = "cuda",
    seed: int = 0,
    stereo_variables=None,
    mono_variables=None,
    two_stage: bool = False,
    graphs: bool | None = None,
) -> StereoAnywherePipeline:
    """A pipeline with fresh models: random weights from `seed`, or the JAX
    package's variable trees (nested dicts of numpy arrays) when given.
    `mono_cfg=None` builds it stereo-only.  DAv2 runs in the stereo compute
    dtype, activations included, where the JAX pipeline keeps the image's
    f32; in bf16 the port's depth stays within twice JAX's own bf16 error
    (`tests/test_torch_bf16.py`)."""
    from stereoanywhere_tpu_torch.compat.from_jax import load_dav2_variables, load_stereo_variables
    from stereoanywhere_tpu_torch.device import torch_dtype

    dev = resolve_device(device)
    stereo = StereoAnywhere(stereo_cfg, device=dev, generator=torch.Generator().manual_seed(seed))
    if stereo_variables is not None:
        load_stereo_variables(stereo, stereo_variables)
    mono = None
    if mono_cfg is not None:
        mono = DepthAnythingV2(
            mono_cfg, device=dev, generator=torch.Generator().manual_seed(seed + 1),
            dtype=torch_dtype(stereo_cfg.compute_dtype),
        )
        if mono_variables is not None:
            load_dav2_variables(mono, mono_variables)
    return StereoAnywherePipeline(stereo, mono, iters, mono_size, dev, two_stage, graphs)


def make_http_server(pipeline: StereoAnywherePipeline, host: str = "0.0.0.0", port: int = 8008) -> HTTPServer:
    """An HTTPServer answering POST /infer with the pipeline (port 0 picks a
    free port); the caller runs `serve_forever` and `shutdown`/`server_close`."""

    class Handler(BaseHTTPRequestHandler):
        def do_POST(self):
            if self.path != "/infer":
                self.send_error(404)
                return
            length = int(self.headers["Content-Length"])
            meta_len = int(self.headers.get("X-Meta-Length", 0))
            raw = self.rfile.read(length)
            meta = json.loads(raw[:meta_len])
            h, w = meta["h"], meta["w"]
            arr = np.frombuffer(raw[meta_len:], np.float32).reshape(2, h, w, 3)
            disp = pipeline(arr[:1], arr[1:]).cpu().numpy()
            out = np.clip(disp[0, ..., 0] * 256.0, 0, 65535).astype(np.uint16).tobytes()
            self.send_response(200)
            self.send_header("Content-Type", "application/octet-stream")
            self.send_header("Content-Length", str(len(out)))
            self.end_headers()
            self.wfile.write(out)

        def log_message(self, *a):
            pass

    return HTTPServer((host, port), Handler)


def serve_http(pipeline: StereoAnywherePipeline, host: str = "0.0.0.0", port: int = 8008) -> None:
    """Serve the pipeline over HTTP until interrupted."""
    server = make_http_server(pipeline, host, port)
    try:
        server.serve_forever()
    finally:
        server.server_close()

