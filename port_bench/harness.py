"""The benchmark of `stereoanywhere_tpu_torch`'s served pipeline, driven by
data.

`BENCHMARK.json` at the checkout's root names the cells; everything that
belongs to one configuration, traffic mix, metric or cell lives in a file
of its own that the harness finds by that name:

- `port_bench/configs/<config>.json`: the model's widths, dtype, loop
  length, graphs switch and the law of its random weights, and optionally
  `"reference"`, its plain reference `port_bench/reference/<name>.py`
  (`port_bench/reference/__init__.py`; the shipped model's without it);
- `port_bench/traffic/<traffic>.json`: a mix for `traffic.make_pool`;
- `port_bench/metrics/<metric>.py`: `read(ctx) -> float | None` over a
  `RunContext` (None: nothing to read, and the metric is left out);
- `port_bench/checks/<workload>.json`: the limits of the output check.

One run (`run_cell`): build the port's pipeline with the configuration's
widths, draw its weights from the seed on the device, draw the pool of
pairs, warm up on every pair of the pool (the first call of the shape runs
eagerly and captures the CUDA graph), then drive `__call__` in a closed
loop of one client for the window: host float32 arrays in, the host
disparity out, the next pair sent when the last answer is back.  A traced
run then profiles a few more pairs on the graph and an eager pass with
ranges around the port's modules, which also keeps the port's own `sa.*`
spans with the kernels launched inside each.  Last, with the program
freed, the configuration's plain reference recomputes the pairs drawn for
the check from the same seeded weights and inputs, and `check.compare`
judges every answer that the window served for them.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import re
import sys
import time
from collections import defaultdict
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable

import numpy as np
import torch

from port_bench import check, reference, traffic
from port_bench import trace as tr
from port_bench.weights import draw_into

REPO = Path(__file__).resolve().parents[1]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "stereoanywhere_tpu")
HOST_SPANS = ("pair", "request.call", "request.to_host")


@dataclass
class RunContext:
    """What a metric's reader may read: the window's host clock, the
    memory peak, the traced segments and the program's counters; `root`
    is the checkout whose files the run reads."""

    config: dict
    mix: dict
    root: Path = REPO
    latencies_s: list[float] = field(default_factory=list)
    window_s: float = 0.0
    setup_s: float = 0.0
    peak_bytes: int = 0
    graph: tr.Segment | None = None
    eager: tr.Segment | None = None
    pool_bytes: int | None = None


# ---------------------------------------------------------------------------
# the data


def load_benchmark(root: Path = REPO) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _json(path: Path) -> dict:
    return json.loads(path.read_text())


def config_of(bench: dict, name: str, root: Path = REPO) -> dict:
    entry = next(c for c in bench["configs"] if c["name"] == name)
    return _json(root / entry["file"])


def traffic_of(name: str, root: Path = REPO) -> dict:
    return _json(root / "port_bench" / "traffic" / f"{name}.json")


def reader_path(metric: str, root: Path = REPO) -> Path:
    return root / "port_bench" / "metrics" / f"{metric}.py"


def load_reader(metric: str, root: Path = REPO) -> Callable[[RunContext], float | None]:
    spec = importlib.util.spec_from_file_location(f"port_bench_metric_{metric.replace('.', '_')}",
                                                  reader_path(metric, root))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def validate(bench: dict, root: Path = REPO) -> list[str]:
    """Check the benchmark's names, units and files; returns the cells'
    names.  Raises ValueError listing every fault."""
    faults = []

    def name_ok(what: str, value) -> None:
        if not isinstance(value, str) or not NAME.match(value):
            faults.append(f"{what} {value!r}: a name is 1-64 of [A-Za-z0-9_.-], not starting with . or -")

    configs = {c["name"]: c for c in bench["configs"]}
    for c in bench["configs"]:
        name_ok("config", c["name"])
        for key in c["reduced"]:
            name_ok(f"config {c['name']} reduced key", key)
        if not (root / c["file"]).is_file():
            faults.append(f"config {c['name']}: no file {c['file']}")
        else:
            data = _json(root / c["file"])
            if data.get("name") != c["name"]:
                faults.append(f"config {c['name']}: its file names itself {data.get('name')!r}")
            faults += reference_faults(c["name"], data, root)
    metrics = bench["end_to_end"] + bench["per_layer"]
    e2e = {m["name"] for m in bench["end_to_end"]}
    cells = []
    for w in bench["workloads"]:
        name_ok("workload", w["name"])
        name_ok(f"workload {w['name']} traffic", w["traffic"])
        if w["config"] not in configs:
            faults.append(f"workload {w['name']}: unknown config {w['config']!r}")
        if w["chips"] not in (1, 4):
            faults.append(f"workload {w['name']}: chips {w['chips']} (1 or 4)")
        mix = root / "port_bench" / "traffic" / f"{w['traffic']}.json"
        if not mix.is_file():
            faults.append(f"workload {w['name']}: no traffic file {mix.relative_to(root)}")
        else:
            try:
                traffic.validate(_json(mix))
            except ValueError as e:
                faults.append(str(e))
        if not (root / "port_bench" / "checks" / f"{w['name']}.json").is_file():
            faults.append(f"workload {w['name']}: no limits file port_bench/checks/{w['name']}.json")
        cells.append(w["name"])
    for c in configs:
        if not any(w["config"] == c for w in bench["workloads"]):
            faults.append(f"config {c}: used by no workload")
    if "setup_s" not in e2e:
        faults.append("end_to_end has no setup_s")
    for m in metrics:
        name_ok("metric", m["name"])
        if not isinstance(m.get("unit"), str) or not UNIT.match(m["unit"]):
            faults.append(f"metric {m['name']}: unit {m.get('unit')!r} (1-16 of [A-Za-z0-9_/%.-])")
        if m.get("better") not in ("lower", "higher"):
            faults.append(f"metric {m['name']}: better must be lower or higher")
        if not reader_path(m["name"], root).is_file():
            faults.append(f"metric {m['name']}: no reader port_bench/metrics/{m['name']}.py")
        for w in m.get("workloads", []):
            if w not in cells:
                faults.append(f"metric {m['name']}: unknown workload {w!r}")
    for m in bench["end_to_end"]:
        if not 0.01 <= m.get("bound", -1) <= 0.25:
            faults.append(f"metric {m['name']}: bound {m.get('bound')} outside [0.01, 0.25]")
    for m in bench["per_layer"]:
        if m.get("moves") not in e2e:
            faults.append(f"metric {m['name']}: moves {m.get('moves')!r}, no end-to-end metric")
    if len({m["name"] for m in metrics}) != len(metrics) or len(set(cells)) != len(cells):
        faults.append("two metrics or two workloads share a name")
    if faults:
        raise ValueError("BENCHMARK.json: " + "; ".join(faults))
    return cells


def reference_faults(config: str, data: dict, root: Path = REPO) -> list[str]:
    """A configuration's reference has to exist and to model every key of
    its `stereo` block that is no implementation switch: a key is never
    dropped without a word."""
    name = reference.name_of(data)
    if not isinstance(name, str) or not NAME.match(name) or not reference.path_of(name, root).is_file():
        return [f"config {config}: no reference module port_bench/reference/{name}.py"]
    modelled = reference.load(name, root).STEREO_KEYS | reference.SWITCHES
    return [f"config {config}: stereo key {key!r} is not modelled by its reference {name!r}"
            for key in data.get("stereo", {}) if key not in modelled]


def metrics_of(bench: dict, workload: str, traced: bool) -> list[dict]:
    """The cell's end-to-end metrics (untraced) or per-layer ones (traced)."""
    kind = bench["per_layer"] if traced else bench["end_to_end"]
    return [m for m in kind if workload in m.get("workloads", [workload])]


# ---------------------------------------------------------------------------
# the program and the reference


def build_program(cfg: dict, device: torch.device, seed: int):
    """The port's pipeline at the configuration's widths, with the
    benchmark's weights drawn from the seed on the device."""
    from stereoanywhere_tpu_torch.config import MonoConfig, StereoAnywhereConfig
    from stereoanywhere_tpu_torch.models.dinov2 import VIT_CONFIGS
    from stereoanywhere_tpu_torch.serve.pipeline import build_pipeline

    mono = cfg["mono"]
    vit = VIT_CONFIGS[mono["encoder"]]
    if (vit["embed_dim"], vit["depth"], vit["num_heads"]) != (mono["embed_dim"], mono["depth"], mono["num_heads"]):
        raise ValueError(f"config {cfg['name']}: the port's {mono['encoder']} is {vit}, the file says otherwise")
    stereo = {k: tuple(v) if isinstance(v, list) else v for k, v in cfg["stereo"].items()}
    mono_cfg = MonoConfig(mono["encoder"], mono["features"], tuple(mono["out_channels"]), mono["input_size"])
    graphs = cfg["graphs"] and device.type == "cuda"
    t = time.perf_counter()
    pipe = build_pipeline(StereoAnywhereConfig(**stereo), mono_cfg, iters=cfg["iters"],
                          mono_size=(mono["input_size"],) * 2, device=device, graphs=graphs)
    _sync(device)
    t1 = time.perf_counter()
    draw_weights(pipe.stereo, pipe.mono, cfg, seed)
    _sync(device)
    log(f"the port's models (its own initialiser) {t1 - t:.3f} s, "
        f"the benchmark's weights {time.perf_counter() - t1:.3f} s")
    return pipe


def draw_weights(stereo: torch.nn.Module, mono: torch.nn.Module, cfg: dict, seed: int) -> None:
    """The configuration's weight law (`weights.py`) drawn into both models
    from two streams of the seed."""
    law = cfg["weights"]
    dtype = getattr(torch, law["dtype"])
    draw_into(stereo, traffic.stream(seed, 2), dtype, law["layer_scale"], law["stereo_scales"])
    draw_into(mono, traffic.stream(seed, 3), dtype, law["layer_scale"])


def build_reference(cfg: dict, device: torch.device, seed: int, root: Path = REPO):
    """The configuration's plain reference pipeline in f32, with the same
    weights as the program (drawn anew from the seed)."""
    ref = reference.build(cfg, root).to_empty(device=device)
    for name, buf in ref.named_buffers():
        buf.fill_(1.0 if name.endswith("running_var") else 0.0)
    draw_weights(ref.stereo, ref.mono, cfg, seed)
    return ref.eval()


def reference_answers(cfg: dict, pool, pairs: list[int], device: torch.device, seed: int,
                      operands: torch.dtype | None = None, root: Path = REPO) -> dict[int, np.ndarray]:
    """The reference's disparity for each pool pair in `pairs`: f32 with
    TF32 off, or with every product's operands rounded to `operands`
    (bfloat16: the check's yardstick; float8_e4m3fn: the control)."""
    from port_bench.reference import arith

    ref = build_reference(cfg, device, seed, root)
    out = {}
    with torch.no_grad(), arith.strict_f32(), arith.rounded_operands(operands):
        for p in pairs:
            left, right = (torch.from_numpy(v).to(device) for v in pool[p])
            out[p] = ref(left, right).cpu().numpy()
    del ref
    _free(device)
    return out


def _free(device: torch.device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# one run


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def trace_graph(call, pool, n: int, device) -> tr.Segment:
    """n pairs of the closed loop under the profiler, each in a `pair`
    span; three tries when the profiler drops events (the kept kernels are
    then no multiple of n), the fullest kept."""
    from torch.autograd.profiler import record_function
    from torch.profiler import ProfilerActivity, profile

    best = None
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for i in range(n):
                left, right = pool[i % len(pool)]
                with record_function("pair"):
                    with record_function("request.call"):
                        out = call(left, right)
                    with record_function("request.to_host"):
                        out.cpu().numpy()
            _sync(device)
        seg = tr.segment(prof, HOST_SPANS)
        seg.pairs = n
        if best is None or len(seg.kernels) > len(best.kernels):
            best = seg
        if seg.kernels and len(seg.kernels) % n == 0:
            break
    return best


def trace_eager(pipe, pool, n: int, device) -> tr.Segment:
    """n pairs run eagerly (kernel by kernel) with ranges around the
    port's parts."""
    from torch.autograd.profiler import record_function
    from torch.profiler import ProfilerActivity, profile

    parts = tr.port_parts(pipe)
    pipe.graphs = False
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof, tr.ranges(parts):
            for i in range(n):
                left, right = pool[i % len(pool)]
                with record_function("pair"):
                    pipe(left, right).cpu().numpy()
            _sync(device)
    finally:
        pipe.graphs = device.type == "cuda"
    seg = tr.segment(prof, ("pair",), parts)
    seg.pairs = n
    return seg


def run_cell(workload: str, seed: int, seconds: float, traced: bool, *, device: str = "cuda",
             root: Path = REPO, t0: float | None = None, patch: Callable | None = None,
             bench: dict | None = None) -> dict:
    """One run of a cell: the result line as a dict (see the module's
    docstring).  `t0`: the process's start on the host clock, from which
    `setup_s` counts.  `patch(pipe, cfg, mix, seed)` may return a callable
    that serves in the program's place (tests plant faults with it)."""
    t0 = time.perf_counter() if t0 is None else t0
    bench = load_benchmark(root) if bench is None else bench
    validate(bench, root)
    cell = next(w for w in bench["workloads"] if w["name"] == workload)
    cfg, mix = config_of(bench, cell["config"], root), traffic_of(cell["traffic"], root)
    dev = torch.device(device)
    phases = [("imports", time.perf_counter())]
    if dev.type == "cuda":
        from stereoanywhere_tpu_torch.ops.cuda import build

        build.build()  # every kernel's library at once, into build/torch_kernels/ of the checkout
    phases.append(("kernel build or cache", time.perf_counter()))
    pipe = build_program(cfg, dev, seed)
    call = (patch(pipe, cfg, mix, seed) if patch else None) or pipe
    pool = traffic.make_pool(mix, seed, dev)
    checked = traffic.check_indices(mix, seed)
    _sync(dev)
    phases.append(("models, weights, pool", time.perf_counter()))
    for i, (left, right) in enumerate(pool):  # the shape's eager call and capture, then a replay of each pair
        call(left, right).cpu()
        if i == 0:
            phases.append(("first call (eager, capture)", time.perf_counter()))
    _sync(dev)
    phases.append(("replays of the pool", time.perf_counter()))
    ctx = RunContext(cfg, mix, root, setup_s=time.perf_counter() - t0)
    log(f"set-up {ctx.setup_s:.3f} s: " + ", ".join(
        f"{name} {b - a:.3f}" for (_, a), (name, b) in zip([("start", t0)] + phases, phases)) + f"; window {seconds} s")

    answers, attempted, failed = defaultdict(list), 0, 0
    start = time.perf_counter()
    while True:
        p = attempted % len(pool)
        left, right = pool[p]
        begin = time.perf_counter()
        try:
            out = call(left, right).cpu().numpy()
        except Exception as e:  # a failed request counts against the run, and the loop goes on
            out = None
            failed += 1
            log(f"request {attempted} (pair {p}) failed: {type(e).__name__}: {e}")
        end = time.perf_counter()
        attempted += 1
        if out is not None:
            ctx.latencies_s.append(end - begin)
            if p in checked:
                answers[p].append(out)
        if end - start >= seconds:
            break
    ctx.window_s = end - start
    log("slowest pairs, ms: " + " ".join(f"{1e3 * v:.2f}" for v in sorted(ctx.latencies_s)[-8:]))
    if dev.type == "cuda":
        ctx.peak_bytes = torch.cuda.max_memory_allocated(dev)
        ctx.pool_bytes = pipe.graph_pool_bytes()

    breakdown = None
    if traced:
        ctx.graph = trace_graph(call, pool, mix["trace_pairs"], dev)
        ctx.eager = trace_eager(pipe, pool, mix["eager_trace_pairs"], dev)
        if ctx.graph.kernels:
            ops = defaultdict(float)
            for name, s, e in ctx.graph.kernels:
                ops[name] += (e - s) / 1e6
            breakdown = {"device_ops": sorted(([k, v] for k, v in ops.items()), key=lambda kv: -kv[1])[:10],
                         "idle_gaps": [list(g) for g in tr.longest_gaps(ctx.graph)]}
    del pipe, call
    _free(dev)

    values = {}
    for m in metrics_of(bench, workload, traced):
        v = load_reader(m["name"], root)(ctx)
        if v is not None:
            values[m["name"]] = {"value": float(v), "unit": m["unit"]}

    references = reference_answers(cfg, pool, checked, dev, seed, root=root)
    yardsticks = reference_answers(cfg, pool, checked, dev, seed, torch.bfloat16, root)
    numbers = check.compare(answers, references, yardsticks)
    for p in checked:
        served = max((check.epe_px(a, references[p]) for a in answers.get(p, [])), default=float("inf"))
        unit = check.epe_px(yardsticks[p], references[p])
        log(f"pair {p}: served gap {served:.4f} px, bf16 yardstick's {unit:.4f} px")
    limits = check.load_limits(workload, root)
    correct = check.verdict(numbers, limits, failed)
    result = {"correct": correct, "attempted": attempted, "failed": failed, "metrics": values,
              "device": device_info(dev, ctx)}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["check"] = {k: {"value": numbers[k] if np.isfinite(numbers[k]) else None, "limit": limits.get(k)}
                       for k in numbers}
    return result


def device_info(dev: torch.device, ctx: RunContext) -> dict:
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": 1,
            "memory_peak_bytes": int(ctx.peak_bytes)}
    if ctx.graph is not None and ctx.graph.host["pair"]:
        lo = min(s for s, _ in ctx.graph.host["pair"])
        hi = max(e for _, e in ctx.graph.host["pair"])
        info["busy_s"] = tr.busy_us(tr.clipped([(s, e) for _, s, e in ctx.graph.kernels], lo, hi)) / 1e6
        info["window_s"] = (hi - lo) / 1e6
    return info


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN_MODULES})
