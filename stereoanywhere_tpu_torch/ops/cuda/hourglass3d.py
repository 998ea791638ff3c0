"""The 3-D hourglass (`models/hourglass.py` `Hourglass`) as fused kernels
over NDHWC volumes, and the count of its calls by path.

Replaces no TPU kernel: the JAX package leaves the hourglass to XLA.  Source:
`csrc/hourglass3d.cu`.

Each `BasicConv` (conv -> instance norm -> LeakyReLU) of the hourglass is
one launch that reads its producer's raw conv output, applies the
producer's instance norm (from the f32 sums of that output), the LeakyReLU
and, where a `DoubleFeatureAtt` sits between the two, the gate
sigmoid(left)[b,c,h,w2] * sigmoid(right)[b,c,h,w3] on load, and stores
its own raw output with the sums of the stored values.  The two 1x1x1
blocks read their two inputs as two segments of K, so neither
concatenation is written; the upsampled segment's share of the product
is taken at its low resolution (`upsampled_share`: the convolution and the
trilinear resize are linear and commute) and interpolated on load, so no
upsampled volume is written either.  A normalised volume is written only
where it must exist: the hourglass's output (`finalize`).

Bound (NVIDIA H100, the KITTI volume 8x320x96x320, a bf16 model): the
arithmetic is small (3x3x3 convs with K = 27 Cin <= 1296 and N = Cout <= 48,
146.5 GFLOP an hourglass, 0.30 ms at the TF32 peak), so bytes bound it:
each volume is written once and read once or twice, 3.39 GB an hourglass,
1.03 ms at 3.35 TB/s.  Measured: 4.57 ms on its CUDA graph, against 19.7
for the modules on cuDNN, which wrote and read each full-size tensor several
times (conv, NCDHW<->NDHWC transposes, the norm's unfused passes, the
activation, the gate, the concatenation, the upsample).  What is left is
mostly the full-size 8 -> 8 blocks (0.65 ms each), bound by their staging
loads' latency.

Precision: a 3x3x3 block multiplies on the tensor cores with f32 sums,
in TF32 where cuDNN may use TF32 (`torch.backends.cudnn.allow_tf32`, the
port's default), else in full f32 (each f32 operand split into two TF32
parts, three products: what cuDNN's f32 convolution computes, to f32
rounding); a bf16 block stores bf16 and its bf16 operands are exact in
TF32.  The 1x1x1 blocks, the interpolation and the norms run in full f32.
So no convolution runs in less precision than the modules give it.

Where it runs (`serve`): every `Hourglass` call on the card, except under
autograd (the kernels have no backward) and inside a row group (the
modules' row-aware ops exchange halos); those, and every call on the CPU,
run the modules (`Hourglass.forward_modules`, the plain path).  A call on
the card that the kernels cannot take (a volume neither f32 nor bf16,
depth features not f32, other widths than the published 8 -> 16 -> 32 ->
48 channels over four levels) raises.  A gate whose depth features' grid
is not the volume's is resized as `DoubleFeatureAtt` resizes it.  The
`*_ref` functions are each launch's plain PyTorch version, for the tests
and `chip_smoke.py`.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as F

from stereoanywhere_tpu_torch.device import device_constant
from stereoanywhere_tpu_torch.ops.cuda.build import bind, check_status, current_stream
from stereoanywhere_tpu_torch.ops.interp import resize_bilinear_align_corners, resize_trilinear_align_corners
from stereoanywhere_tpu_torch.parallel import halo

_LIB = "hourglass3d"
_EPS = 1e-5
_SLOPE = 0.01
_SEG_NCDHW, _SEG_RAW = 0, 1
_MAX_BLOCKS = 528

_CALLS = {"fused": 0, "plain": 0}
_LAUNCHES = [0]


def calls() -> dict[str, int]:
    """`Hourglass` calls so far by path: `fused` (the kernels here) and
    `plain` (the modules)."""
    return dict(_CALLS)


def launches() -> int:
    """The kernels' launches so far (15 a fused hourglass)."""
    return _LAUNCHES[0]


@dataclasses.dataclass
class Vol:
    """A volume as its consumer reads it.  `x`: raw NDHWC (B, D, H, W, C),
    or the hourglass's input NCDHW (B, C, D, H, W) with `ncdhw`; `stats`
    (B, 2, C) f32: Σx and Σx² over the volume, applied on load as the
    instance norm and LeakyReLU (None: x as it is); `gate`: f32 factors
    applied on load after them, (gl (B, H, W, C), gr (B, H, D, C)) for
    gl * gr, or four, (gl, gr, gl2, gr2), for gl * gr + gl2 * gr2 (a
    resized gate, `_gate`)."""

    x: torch.Tensor
    stats: torch.Tensor | None = None
    gate: tuple[torch.Tensor, ...] | None = None
    ncdhw: bool = False

    @property
    def dims(self) -> tuple[int, int, int]:
        return tuple(self.x.shape[2:] if self.ncdhw else self.x.shape[1:4])

    @property
    def channels(self) -> int:
        return self.x.shape[1] if self.ncdhw else self.x.shape[-1]

    @property
    def dtype(self) -> torch.dtype:
        """The type of the values its consumer reads: a gate promotes to f32."""
        return torch.float32 if self.gate is not None else self.x.dtype

    def gate_ptrs(self) -> list:
        """gl, gr, gl2, gr2 as the launchers take them (None: absent)."""
        g = [t.data_ptr() for t in self.gate or ()]
        return g + [None] * (4 - len(g))


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def _check(what: str, v: Vol, *tensors: torch.Tensor, f32: tuple = ()) -> None:
    """What the kernels take: contiguous operands on v's device, the volume
    and `tensors` (weights) f32 or bf16, its sums and gates and `f32` f32.
    (`_on_card` says whether that device is a card.)"""
    ts = [v.x, *tensors]
    fs = [*f32, *(t for t in (v.stats, *(v.gate or ())) if t is not None)]
    if (any(not t.is_contiguous() or t.device != v.x.device for t in ts + fs)
            or any(t.dtype not in (torch.float32, torch.bfloat16) for t in ts)
            or any(t.dtype != torch.float32 for t in fs) or len(v.gate or ()) not in (0, 2, 4)):
        raise ValueError(f"{what}: operands must be contiguous on one card, volumes and weights f32 or bf16, "
                         "sums and gates f32, a gate of 2 or 4 factors")


def _on_card(what: str, v: Vol) -> None:
    if v.x.device.type != "cuda":
        raise ValueError(f"{what}: the kernels run on the card; the plain version is `{what.split()[-1]}_ref`")


def _bf16(t: torch.Tensor) -> int:
    return int(t.dtype == torch.bfloat16)


# ---------------------------------------------------------------------------
# each launch's plain version (any device)


def sums(raw: torch.Tensor) -> torch.Tensor:
    """(B, 2, C) Σx, Σx² of an NDHWC volume in f32."""
    xf = raw.float()
    return torch.stack([xf.sum(dim=(1, 2, 3)), (xf * xf).sum(dim=(1, 2, 3))], dim=1)


def values(v: Vol) -> torch.Tensor:
    """What a consumer reads of v, NCDHW: layers.instance_norm's arithmetic
    from v's sums, the LeakyReLU, then the gate (DoubleFeatureAtt's)."""
    x = v.x if v.ncdhw else v.x.permute(0, 4, 1, 2, 3)
    if v.stats is not None:
        n = x[0, 0].numel()
        mean = v.stats[:, 0] / n
        var = v.stats[:, 1] / n - mean * mean
        inv = torch.rsqrt(var + _EPS).to(x.dtype)
        x = F.leaky_relu((x - mean.to(x.dtype)[..., None, None, None]) * inv[..., None, None, None], _SLOPE)
    if v.gate is not None:
        gate = 0
        for gl, gr in zip(v.gate[::2], v.gate[1::2]):
            gate = gate + gl.permute(0, 3, 1, 2).unsqueeze(2) * gr.permute(0, 3, 2, 1).unsqueeze(-1)
        x = gate * x
    return x


def _raw(y: torch.Tensor) -> Vol:
    raw = y.permute(0, 2, 3, 4, 1).contiguous()
    return Vol(raw, sums(raw))


def conv3_ref(v: Vol, weight: torch.Tensor, stride: int) -> Vol:
    """`conv3`'s plain version (F.conv3d of `values(v)`)."""
    return _raw(F.conv3d(values(v), weight.to(v.dtype), None, stride, 1))


def conv1_ref(direct: Vol, col: int, up: torch.Tensor, weight: torch.Tensor) -> Vol:
    """`conv1`'s plain version."""
    y = F.conv3d(values(direct).float(), weight[:, col:col + direct.channels].float())
    return _raw(y + resize_trilinear_align_corners(up.permute(0, 4, 1, 2, 3), tuple(direct.dims)))


def upsampled_share_ref(v: Vol, weight: torch.Tensor, col: int) -> torch.Tensor:
    """`upsampled_share`'s plain version."""
    y = F.conv3d(values(v).float(), weight[:, col:col + v.channels].float())
    return y.permute(0, 2, 3, 4, 1).contiguous()


def finalize_ref(v: Vol) -> torch.Tensor:
    """`finalize`'s plain version."""
    return values(v).contiguous()


# ---------------------------------------------------------------------------
# the kernels' wrappers (CUDA tensors)


def scratch(like: torch.Tensor, max_cout: int) -> torch.Tensor:
    """The statistics' scratch of a forward's launches: a counter (zero;
    each launch's last block resets it) and room for the per-block partial
    sums of one launch, at most `_MAX_BLOCKS` blocks (csrc's MAX_BLOCKS) of
    2 cout sums.  The launches run in stream order, so they share it."""
    return torch.zeros(4 + _MAX_BLOCKS * 2 * max_cout, device=like.device, dtype=torch.float32)


def _stats_ptrs(buf: torch.Tensor) -> tuple[int, int]:
    """(partial sums, counter) pointers into a `scratch` buffer."""
    return buf.data_ptr() + 16, buf.data_ptr()


def _launched(what: str, status: int) -> None:
    check_status(_LIB, what, status)
    _LAUNCHES[0] += 1


def conv3(v: Vol, weight: torch.Tensor, stride: int, buf: torch.Tensor, precise: bool = False) -> Vol:
    """A 3x3x3 BasicConv's convolution (padding 1) of what v's consumer
    reads, in that dtype -> its raw output (NDHWC) and sums.  f32 operands
    multiply in TF32, or with `precise` in full f32."""
    _on_card("hourglass3d conv3", v)
    _check("hourglass3d conv3", v, weight)
    dt = v.dtype
    b, cin = v.x.shape[0], v.channels
    cout = weight.shape[0]
    di, hi, wi = v.dims
    do, ho, wo = ((s - 1) // stride + 1 for s in (di, hi, wi))
    out = torch.empty((b, do, ho, wo, cout), device=v.x.device, dtype=dt)
    stats = torch.empty((b, 2, cout), device=v.x.device, dtype=torch.float32)
    fn = bind(_LIB, "sa_hg_conv3", 11, 12)
    status = fn(v.x.data_ptr(), _ptr(v.stats), *v.gate_ptrs(), weight.data_ptr(), out.data_ptr(),
                stats.data_ptr(), *_stats_ptrs(buf), b, di, hi, wi, cin, cout, stride,
                int(v.ncdhw), _bf16(v.x), _bf16(weight), _bf16(out), int(precise), current_stream())
    _launched("hourglass3d conv3", status)
    return Vol(out, stats)


def conv1(direct: Vol, col: int, up: torch.Tensor, weight: torch.Tensor, buf: torch.Tensor) -> Vol:
    """A 1x1x1 BasicConv's convolution of [the two segments] in f32 -> its
    raw output (NDHWC) at direct's volume and sums: the direct segment
    through weight's columns [col, col + its channels), plus `up`, the other
    segment's share (`upsampled_share`), resized there (trilinear, align
    corners)."""
    _on_card("hourglass3d conv1", direct)
    _check("hourglass3d conv1", direct, weight, f32=(up,))
    cd, dims = direct.channels, direct.dims
    b, cout = up.shape[0], weight.shape[0]
    out = torch.empty((b, *dims, cout), device=up.device, dtype=torch.float32)
    stats = torch.empty((b, 2, cout), device=up.device, dtype=torch.float32)
    fn = bind(_LIB, "sa_hg_conv1", 12, 14)
    status = fn(direct.x.data_ptr(), _ptr(direct.stats), *direct.gate_ptrs(), up.data_ptr(), weight.data_ptr(),
                out.data_ptr(), stats.data_ptr(), *_stats_ptrs(buf), b, *dims, cd,
                _SEG_NCDHW if direct.ncdhw else _SEG_RAW, _bf16(direct.x), *up.shape[1:4], cout, _bf16(weight),
                weight.shape[1], col, current_stream())
    _launched("hourglass3d conv1", status)
    return Vol(out, stats)


def upsampled_share(v: Vol, weight: torch.Tensor, col: int) -> torch.Tensor:
    """What v's consumer reads (v raw f32 with its sums and gate), through
    a 1x1x1 weight's columns [col, col + its channels), at v's own (low)
    resolution: (B, D, H, W, Cout) f32, for `conv1` to resize and add (the
    two are linear and commute)."""
    _on_card("hourglass3d upsampled_share", v)
    _check("hourglass3d upsampled_share", v, weight, f32=(v.x,))
    b, (d, h, w), np_ = v.x.shape[0], v.dims, weight.shape[0]
    out = torch.empty((b, d, h, w, np_), device=v.x.device, dtype=torch.float32)
    fn = bind(_LIB, "sa_hg_finalize", 8, 9)
    status = fn(v.x.data_ptr(), _ptr(v.stats), *v.gate_ptrs(), weight.data_ptr(), out.data_ptr(),
                b, d, h, w, v.channels, np_, _bf16(weight), weight.shape[1], col, current_stream())
    _launched("hourglass3d upsampled_share", status)
    return out


def finalize(v: Vol) -> torch.Tensor:
    """What v's consumer reads, written NCDHW (B, C, D, H, W) f32 (v's raw
    volume f32 with its sums and gate): the hourglass's output."""
    _on_card("hourglass3d finalize", v)
    _check("hourglass3d finalize", v, f32=(v.x,))
    b, c = v.x.shape[0], v.channels
    d, h, w = v.dims
    out = torch.empty((b, c, d, h, w), device=v.x.device, dtype=torch.float32)
    fn = bind(_LIB, "sa_hg_finalize", 8, 9)
    status = fn(v.x.data_ptr(), _ptr(v.stats), *v.gate_ptrs(), None, out.data_ptr(), b, d, h, w,
                c, 0, 0, 0, 0, current_stream())
    _launched("hourglass3d finalize", status)
    return out


# ---------------------------------------------------------------------------
# the hourglass

# (Cout, Cin, k) of every BasicConv that runs, in order: down_layers[0..2]
# (stride 2, then 1), agg_layers[1] (1x1x1, then 3x3x3 twice), final_agg
_WIDTHS = ((16, 8, 3), (16, 16, 3), (32, 16, 3), (32, 32, 3), (48, 32, 3), (48, 48, 3),
           (16, 48, 1), (16, 16, 3), (16, 16, 3), (8, 24, 1), (8, 8, 3), (8, 8, 3))


def _blocks(hg) -> list:
    i = hg.ns - 3
    return [*(blk for level in hg.down_layers for blk in level), *hg.agg_layers[i], *hg.final_agg]


def check_takes(hg, x: torch.Tensor, features_left, features_right) -> None:
    """Raises ValueError where the kernels cannot run this call of `hg`:
    a volume neither f32 nor bf16, depth features not f32 on x's device
    (or whose left and right rows differ, which the modules refuse too),
    other widths than the published ones."""
    feats = [*features_left, *features_right]
    if (x.dtype not in (torch.float32, torch.bfloat16) or x.ndim != 5
            or any(f.dtype != torch.float32 or f.device != x.device or f.ndim != 4 for f in feats)):
        raise ValueError(f"hourglass3d: a volume of {x.dtype} and depth features of "
                         f"{sorted({str(f.dtype) for f in feats})}: the kernels take an f32 or bf16 volume and f32 "
                         "features")
    if hg.ns != 4 or tuple(tuple(b.conv.weight.shape[:3]) for b in _blocks(hg)) != _WIDTHS:
        raise ValueError("hourglass3d: the kernels take the published widths (8 -> 16 -> 32 -> 48 channels, "
                         "four levels)")
    if any(fl.shape[-2] != fr.shape[-2] for fl, fr in zip(features_left, features_right)):
        raise ValueError("hourglass3d: the left and right depth features of a level differ in rows")


def plain_reason(hg, x: torch.Tensor, features_left, features_right) -> str | None:
    """Why the modules run this call of `hg` ("autograd": a volume, feature
    or parameter requires grad; "row group"; "cpu"), the first that holds,
    or None: the kernels run it."""
    if torch.is_grad_enabled() and (any(t.requires_grad for t in (x, *features_left, *features_right))
                                    or any(p.requires_grad for p in hg.parameters())):
        return "autograd"
    if halo.active() is not None:
        return "row group"
    return None if x.device.type == "cuda" else "cpu"


def serve(hg, x: torch.Tensor, features_left, features_right) -> torch.Tensor | None:
    """`Hourglass.forward` on the kernels, or None where the modules run
    the call (`plain_reason`).  Counts the call by path; raises
    (`check_takes`) on a call on the card that the kernels cannot take."""
    if plain_reason(hg, x, features_left, features_right) is not None:
        _CALLS["plain"] += 1
        return None
    check_takes(hg, x, features_left, features_right)
    _CALLS["fused"] += 1
    return forward(hg, x, features_left, features_right)


@functools.lru_cache(maxsize=None)
def _row_taps(in_size: int, out_size: int, k: int, weighted: bool) -> np.ndarray:
    """(out, in): row i of an align-corners resize along H picks its k-th
    source row (k = 0 the lower, 1 the upper), with that row's weight
    (`weighted`) or 1."""
    src = (np.zeros((1,), np.float32) if out_size == 1
           else np.arange(out_size, dtype=np.float32) * np.float32((in_size - 1) / (out_size - 1)))
    x0 = np.clip(np.floor(src), 0, in_size - 1).astype(np.int64)
    w = (src - x0.astype(np.float32)).astype(np.float32)
    col, wt = (x0, 1.0 - w) if k == 0 else (np.minimum(x0 + 1, in_size - 1), w)
    m = np.zeros((out_size, in_size), np.float32)
    m[np.arange(out_size), col] = wt if weighted else 1.0
    return m


def _gate(att, feat_left, feat_right, dims) -> tuple[torch.Tensor, ...]:
    """A DoubleFeatureAtt's gate at the volume's dims (W3, H, W2), as the
    factors the kernels read, channel-last: gl (B, H, W2, C) and gr (B, H,
    W3, C).  Where the depth features' grid is not the volume's, the module
    resizes gl * gr (trilinear, align corners); that is gl and gr each
    resized along its own width, and along H two rank-1 terms, one for each
    of an output row's two source rows: (gl, gr, gl2, gr2)."""
    d, h, w = dims
    gl = torch.sigmoid(att.feat_att_left(feat_left))  # (B, C, Hf, W2f)
    gr = torch.sigmoid(att.feat_att_right(feat_right))  # (B, C, Hf, W3f)
    hf = gl.shape[2]
    gl = resize_bilinear_align_corners(gl, (hf, w))
    gr = resize_bilinear_align_corners(gr, (hf, d))
    factors = [gl, gr]
    if hf != h:
        factors = [torch.matmul(device_constant(_row_taps, (hf, h, k, weighted), f.device, f.dtype), f)
                   for k in (0, 1) for f, weighted in ((gl, True), (gr, False))]
    return tuple(f.permute(0, 2, 3, 1).contiguous() for f in factors)


def _down(dims) -> tuple[int, int, int]:
    return tuple((s - 1) // 2 + 1 for s in dims)


def forward(hg, x: torch.Tensor, features_left, features_right) -> torch.Tensor:
    """`Hourglass.forward` on the kernels: x (B, 8, W3, H, W2) -> (B, 8, W3,
    H, W2) f32 (a bf16 volume is promoted at the first gate, as there).
    Computes what the modules compute, `down_layers[2]` included."""
    ns = hg.ns
    precise = not torch.backends.cudnn.allow_tf32
    buf = scratch(x, 48)
    original = Vol(x.contiguous(), ncdhw=True)
    cur, down = original, []
    for i in range(ns - 1):
        y = conv3(cur, hg.down_layers[i][0].conv.weight, 2, buf, precise)
        y = conv3(y, hg.down_layers[i][1].conv.weight, 1, buf, precise)
        cur = dataclasses.replace(y, gate=_gate(hg.feature_atts[i], features_left[i + 1], features_right[i + 1],
                                                y.dims))
        down.append(cur)
    # only the last aggregation level reaches the output (the modules' note);
    # the aggregation reads [upsampled low, skip], the final level [original,
    # upsampled aggregation]
    i = ns - 3
    skip, low = down[ns - 3 - i], down[ns - 2 - i]
    agg = hg.agg_layers[i]
    w = agg[0].conv.weight
    y = conv1(skip, low.channels, upsampled_share(low, w, 0), w, buf)
    y = conv3(y, agg[1].conv.weight, 1, buf, precise)
    y = conv3(y, agg[2].conv.weight, 1, buf, precise)
    up = dataclasses.replace(y, gate=_gate(hg.feature_atts_up[i], features_left[ns - 2 - i],
                                           features_right[ns - 2 - i], y.dims))
    w = hg.final_agg[0].conv.weight
    y = conv1(original, 0, upsampled_share(up, w, original.channels), w, buf)
    y = conv3(y, hg.final_agg[1].conv.weight, 1, buf, precise)
    y = conv3(y, hg.final_agg[2].conv.weight, 1, buf, precise)
    y.gate = _gate(hg.final_feature_atts_up, features_left[0], features_right[0], y.dims)
    return finalize(y)
