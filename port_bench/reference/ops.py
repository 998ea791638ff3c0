"""The stereo pipeline's operations in plain PyTorch, on one device and
without row sharding: resizes (as constant interpolation matrices),
pooling, joint min-max, normals, warps, soft LRC, the fuzzy gates, the
cost volumes and their estimators, the weighted least squares, the
correlation pyramid and its gather lookup, and convex upsampling.

A frozen copy of the semantics of `stereoanywhere_tpu_torch.ops` (and of
the plain versions of its kernels), which it does not import.  Everything
runs in the input's dtype, f32 in the benchmark; the all-pairs
correlation is a product (`arith.matmul`).
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from port_bench.reference import arith

# ---------------------------------------------------------------------------
# resize matrices


@functools.lru_cache(maxsize=None)
def _align_corners_matrix(in_size: int, out_size: int) -> np.ndarray:
    if out_size == 1:
        src = np.zeros((1,), np.float32)
    else:
        scale = np.float32((in_size - 1) / (out_size - 1))
        src = np.arange(out_size, dtype=np.float32) * scale
    x0 = np.clip(np.floor(src), 0, max(in_size - 1, 0)).astype(np.int64)
    x1 = np.minimum(x0 + 1, in_size - 1)
    w = (src - x0.astype(np.float32)).astype(np.float32)
    m = np.zeros((out_size, in_size), np.float32)
    rows = np.arange(out_size)
    np.add.at(m, (rows, x0), 1.0 - w)
    np.add.at(m, (rows, x1), w)
    return m


@functools.lru_cache(maxsize=None)
def _halfpix_matrix(in_size: int, out_size: int) -> np.ndarray:
    src = (np.arange(out_size, dtype=np.float32) + 0.5) * np.float32(in_size / out_size) - 0.5
    x0 = np.floor(src)
    w = (src - x0).astype(np.float32)
    x0i = np.clip(x0, 0, in_size - 1).astype(np.int64)
    x1i = np.clip(x0 + 1, 0, in_size - 1).astype(np.int64)
    m = np.zeros((out_size, in_size), np.float32)
    rows = np.arange(out_size)
    np.add.at(m, (rows, x0i), 1.0 - w)
    np.add.at(m, (rows, x1i), w)
    return m


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out).astype(np.float32)


def _triangle(x: np.ndarray) -> np.ndarray:
    return np.maximum(0.0, 1.0 - np.abs(x)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax_image_matrix(in_size: int, out_size: int, method: str) -> np.ndarray:
    """`jax.image.resize` along one axis: half-pixel centres, Keys cubic
    (a=-0.5) or the tent, antialiased when downsampling."""
    kernel = {"cubic": _keys_cubic, "bilinear": _triangle}[method]
    inv_scale = np.float32(1.0 / (out_size / in_size))
    kernel_scale = np.maximum(inv_scale, np.float32(1.0))
    sample_f = ((np.arange(out_size) + 0.5) * np.float64(inv_scale) - 0.5).astype(np.float32)
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=np.float32)[:, None]) / kernel_scale
    w = kernel(x)
    total = np.sum(w, axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1), 0)
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    w = np.where(inside[None, :], w, 0)
    return np.ascontiguousarray(w.T.astype(np.float32))


@functools.lru_cache(maxsize=None)
def bicubic_scale_matrix(in_size: int, out_size: int, scale: float) -> np.ndarray:
    """torch's bicubic (a=-0.75) with an explicit scale factor, border taps
    clamped: DINOv2's position-embedding interpolation."""
    a = -0.75
    dst = np.arange(out_size, dtype=np.float32)
    src = (dst + np.float32(0.5)) / np.float32(scale) - np.float32(0.5)
    i0 = np.floor(src).astype(np.int64)
    t = (src - i0.astype(np.float32)).astype(np.float32)
    m = np.zeros((out_size, in_size), np.float32)
    rows = np.arange(out_size)
    for k in range(-1, 3):
        at = np.abs(t - k)
        w1 = (a + 2) * at ** 3 - (a + 3) * at ** 2 + 1
        w2 = a * at ** 3 - 5 * a * at ** 2 + 8 * a * at - 4 * a
        wk = np.where(at <= 1, w1, np.where(at < 2, w2, 0.0)).astype(np.float32)
        np.add.at(m, (rows, np.clip(i0 + k, 0, in_size - 1)), wk)
    return m


_MATRICES = {
    "align_corners": _align_corners_matrix,
    "halfpix": _halfpix_matrix,
    "jax_cubic": lambda i, o: _jax_image_matrix(i, o, "cubic"),
    "jax_bilinear": lambda i, o: _jax_image_matrix(i, o, "bilinear"),
}


def matrix(kind: str, in_size: int, out_size: int, like: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(_MATRICES[kind](in_size, out_size)).to(like.device, like.dtype)


def _resize(x: torch.Tensor, sizes: tuple[int, ...], kind: str, order=None) -> torch.Tensor:
    nd = len(sizes)
    for i in range(nd) if order is None else order:
        axis = x.ndim - nd + i
        if x.shape[axis] != sizes[i]:
            m = matrix(kind, x.shape[axis], sizes[i], x)
            x = torch.movedim(torch.tensordot(x, m, dims=([axis], [1])), -1, axis)
    return x


def resize_bilinear_align_corners(x, out_hw):
    return _resize(x, tuple(out_hw), "align_corners")


def resize_trilinear_align_corners(x, out_dhw):
    return _resize(x, tuple(out_dhw), "align_corners")


def resize_bilinear_halfpix(x, out_hw):
    return _resize(x, tuple(out_hw), "halfpix", order=(1, 0))


def resize_jax_image(x, out_hw, method: str):
    return _resize(x, tuple(out_hw), f"jax_{method}")


def interp_like(x, ref):
    return resize_bilinear_align_corners(x, (ref.shape[-2], ref.shape[-1]))


def pool2x(x):
    return F.avg_pool2d(x, 3, stride=2, padding=1, count_include_pad=True)


def avg_pool_last_axis_2(x):
    m = (x.shape[-1] // 2) * 2
    x = x[..., :m]
    return 0.5 * (x[..., 0::2] + x[..., 1::2])


# ---------------------------------------------------------------------------
# geometry


def joint_minmax_normalize(xs, eps: float = 1e-4):
    lo = torch.stack([x.amin(dim=(2, 3), keepdim=True) for x in xs]).amin(dim=0)
    hi = torch.stack([x.amax(dim=(2, 3), keepdim=True) for x in xs]).amax(dim=0)
    return [(x - lo) / (hi - lo + eps) for x in xs]


def estimate_normals(depth, normal_gain: float):
    xp = F.pad(depth * normal_gain, (1, 1, 1, 1), mode="replicate")
    gx = xp[:, :, 1:-1, 2:] - xp[:, :, 1:-1, :-2]
    gy = xp[:, :, 2:, 1:-1] - xp[:, :, :-2, 1:-1]
    n = torch.cat([-gx, -gy, torch.ones_like(gx)], dim=1)
    return n / torch.linalg.vector_norm(n, dim=1, keepdim=True)


def _sample_rows_linear(values, src_x):
    w = values.shape[-1]
    x0 = torch.floor(src_x)
    frac = (src_x - x0).to(values.dtype)
    x0i = x0.long()

    def tap(idx, weight):
        valid = ((idx >= 0) & (idx <= w - 1)).to(values.dtype)
        safe = idx.clamp(0, w - 1).expand(-1, values.shape[1], -1, -1)
        return torch.gather(values, 3, safe) * weight * valid

    return tap(x0i, 1.0 - frac) + tap(x0i + 1, frac)


def disp_warping(disp, img, right_disp: bool = False):
    """The reference model's warp: source x (x -+ d)(W-1)/W, source y
    y(H-1)/H, bilinear, zeros outside."""
    _, _, h, w = img.shape
    xs = torch.arange(w, device=img.device, dtype=disp.dtype).view(1, 1, 1, w)
    src_x = ((xs + disp) if right_disp else (xs - disp)) * ((w - 1) / w)
    ys = torch.arange(h, device=img.device, dtype=torch.float32) * ((h - 1) / h)
    y0 = torch.floor(ys)
    fy = (ys - y0).to(img.dtype).view(1, 1, h, 1)
    y0i = y0.long()
    y1i = (y0i + 1).clamp(max=h - 1)
    return _sample_rows_linear(img[:, :, y0i], src_x) * (1.0 - fy) + _sample_rows_linear(img[:, :, y1i], src_x) * fy


def softlrc(disp2, disp3, lrc_th: float = 1.0):
    div_const = math.log(1 + math.exp(lrc_th))
    warped_disp2 = disp_warping(F.relu(disp3), disp2, right_disp=True)
    warped_disp3 = disp_warping(F.relu(disp2), disp3, right_disp=False)
    s2 = F.softplus(-torch.abs(disp2 - warped_disp3) + lrc_th) / div_const
    s3 = F.softplus(-torch.abs(disp3 - warped_disp2) + lrc_th) / div_const
    return s2, s3


def fuzzy_and(x, y):
    return x * y


def fuzzy_or(x, y):
    return x + y - x * y


def fuzzy_not(x):
    return 1.0 - x


# ---------------------------------------------------------------------------
# volumes (B, H, W2, W3): left pixel W2, right hypothesis W3


def all_pairs_correlation(feat_left, feat_right):
    c = feat_left.shape[1]
    vol = arith.matmul(feat_left.permute(0, 2, 3, 1), feat_right.permute(0, 2, 1, 3))
    return vol / math.sqrt(c)


def generate_masks(mde, n: int):
    edges = (torch.arange(n, device=mde.device, dtype=mde.dtype) / n).view(1, n, 1, 1)
    return ((mde >= edges) & (mde < edges + 1.0 / n)).to(mde.dtype)


def masked_volume(volume, left_masks, right_masks):
    """-> (B, N, W3, H, W2), the hourglass's layout."""
    vol = volume.permute(0, 3, 1, 2).unsqueeze(1)
    return vol * left_masks.unsqueeze(2) * right_masks.permute(0, 1, 3, 2).unsqueeze(-1)


def _softmax_expectation(volume, dim: int):
    prob = torch.softmax(volume, dim=dim)
    shape = [1] * volume.ndim
    shape[dim] = volume.shape[dim]
    idx = torch.arange(volume.shape[dim], device=volume.device, dtype=volume.dtype).view(shape)
    return torch.sum(prob * idx, dim=dim)


def estimate_left_disparity(volume):
    xs = torch.arange(volume.shape[2], device=volume.device, dtype=volume.dtype)
    return (xs - _softmax_expectation(volume, 3)).unsqueeze(1)


def estimate_right_disparity(volume):
    xs = torch.arange(volume.shape[3], device=volume.device, dtype=volume.dtype)
    return (_softmax_expectation(volume, 2) - xs).unsqueeze(1)


def _entropy_confidence(volume, dim: int):
    prob = torch.softmax(volume, dim=dim)
    ent = -torch.sum(prob * torch.log2(prob + 1e-6), dim=dim)
    return 1.0 - ent / math.log2(volume.shape[dim])


def estimate_left_confidence(volume):
    return _entropy_confidence(volume, 3).unsqueeze(1)


def estimate_right_confidence(volume):
    return _entropy_confidence(volume, 2).unsqueeze(1)


def truncate_corr_volume(disp_left, conf_left, attenuation_gain: float):
    w = disp_left.shape[-1]
    xs = torch.arange(w, device=disp_left.device, dtype=disp_left.dtype)
    conf = conf_left[:, 0, :, :, None]
    ramp = xs.view(1, 1, w, 1) - disp_left[:, 0, :, :, None] - xs.view(1, 1, 1, w)
    att = torch.sigmoid(ramp) * (1.0 - attenuation_gain) + attenuation_gain
    return (1.0 - conf) + conf * att


def handcrafted_mirror_detector(stereo_disp, mono_disp, stereo_conf, mono_conf, conf_th: float,
                                step_gain: float = 20.0):
    both_conf = fuzzy_and(stereo_conf, mono_conf)
    mono_near = torch.sigmoid(step_gain * (mono_disp - stereo_disp))
    mono_better = fuzzy_or(fuzzy_and(both_conf, mono_near), fuzzy_and(fuzzy_not(stereo_conf), mono_conf))
    return torch.sigmoid(step_gain * (mono_better - conf_th))


def weighted_lsq(mde, disp, conf, min_quantile: float = 0.2, max_quantile: float = 0.9):
    """scale * |mde| + shift ~ relu(disp), weighted by 0.9 |conf| + 0.1 over
    the elements of relu(disp) within its [q20, q90], per sample; the 2x2
    normal equations in closed form.  -> (scale, shift), (B,1,1,1)."""
    b = mde.shape[0]
    m = torch.abs(mde.reshape(b, -1))
    d = F.relu(disp.reshape(b, -1))
    c = torch.abs(conf.reshape(b, -1))
    lo = torch.quantile(d, min_quantile, dim=1, keepdim=True)
    hi = torch.quantile(d, max_quantile, dim=1, keepdim=True)
    w = (c * 0.9 + 0.1) * ((d >= lo) & (d <= hi)).to(d.dtype)
    a00, a01, a11 = (w * m * m).sum(1), (w * m).sum(1), w.sum(1)
    b0, b1 = (w * m * d).sum(1), (w * d).sum(1)
    det = a00 * a11 - a01 * a01
    ok = torch.abs(det) > 1e-12
    safe = torch.where(ok, det, torch.ones_like(det))
    scale = torch.where(ok, (a11 * b0 - a01 * b1) / safe, torch.zeros_like(det))
    shift = torch.where(ok, (a00 * b1 - a01 * b0) / safe, torch.zeros_like(det))
    return scale.view(b, 1, 1, 1), shift.view(b, 1, 1, 1)


# ---------------------------------------------------------------------------
# the refinement loop's lookup and the output's upsampling


def build_corr_pyramid(volume, num_levels: int):
    levels = [volume]
    for _ in range(num_levels - 1):
        levels.append(avg_pool_last_axis_2(levels[-1]))
    return levels


def _lookup_level(level, coords, radius: int):
    wl = level.shape[-1]
    taps = torch.arange(-radius, radius + 1, device=coords.device, dtype=coords.dtype)
    pos = coords.unsqueeze(-1) + taps
    x0 = torch.floor(pos)
    frac = (pos - x0).to(level.dtype)
    x0i = x0.long()

    def tap(idx, weight):
        valid = ((idx >= 0) & (idx <= wl - 1)).to(level.dtype)
        return torch.gather(level, -1, idx.clamp(0, wl - 1)) * weight * valid

    return tap(x0i, 1.0 - frac) + tap(x0i + 1, frac)


def lookup_corr_pyramid(levels, coords, radius: int):
    """Every level i at coords / 2^i + [-r..r], linear, zeros outside ->
    (B, H, W2, levels (2r+1)), level-major."""
    return torch.cat([_lookup_level(lv, coords / (2 ** i), radius) for i, lv in enumerate(levels)], dim=-1)


def convex_upsample(flow, mask, n_downsample: int):
    b, d, h, w = flow.shape
    f = 2 ** n_downsample
    m = torch.softmax(mask.view(b, 1, 9, f, f, h, w), dim=2)
    neigh = F.unfold(flow * f, kernel_size=3, padding=1).view(b, d, 9, 1, 1, h, w)
    up = torch.sum(m * neigh, dim=2)
    return up.permute(0, 1, 4, 2, 5, 3).reshape(b, d, h * f, w * f)
