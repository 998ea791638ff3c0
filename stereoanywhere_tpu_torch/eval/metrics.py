"""Numpy metric suites, a copy of the JAX package's `eval/metrics.py`: the
twins of the reference's `losses.py:199-342`.  They run on the host, on
each sample's full-resolution output.
"""
from __future__ import annotations

import numpy as np


def middlebury_metrics(disp, gt, valid):
    """reference losses.py:199-212."""
    error = np.abs(disp - gt)
    error[valid == 0] = 0
    sel = error[valid > 0]
    rms = float(np.sqrt(((disp - gt) ** 2)[valid > 0].mean()))
    out = {
        "bad 0.5": float((sel > 0.5).mean()),
        "bad 1.0": float((sel > 1.0).mean()),
        "bad 2.0": float((sel > 2.0).mean()),
        "bad 4.0": float((sel > 4.0).mean()),
        "avgerr": float(sel.mean()),
        "rms": rms,
        "A50": float(np.percentile(error, 50)),
        "A90": float(np.percentile(error, 90)),
        "A95": float(np.percentile(error, 95)),
        "A99": float(np.percentile(error, 99)),
        "errormap": error * (valid > 0),
    }
    return out


def booster_metrics(disp, gt, valid):
    """reference losses.py:214-225."""
    error = np.abs(disp - gt)
    error[valid == 0] = 0
    sel = error[valid > 0]
    out = {f"bad {t}.0": float((sel > t).mean()) for t in (2, 4, 6, 8)}
    out["avgerr"] = float(sel.mean())
    out["rms"] = float(np.sqrt(((disp - gt) ** 2)[valid > 0].mean()))
    out["errormap"] = error * (valid > 0)
    return out


def kitti_metrics(disp, gt, valid):
    """reference losses.py:227-232: bad3 = err>3 AND err/gt>0.05."""
    error = np.abs(disp - gt)
    sel = error[valid > 0]
    gts = gt[valid > 0]
    bad3 = float(((sel > 3) * (sel / gts > 0.05)).astype(np.float32).mean())
    return {"bad 3": bad3, "epe": float(sel.mean()), "errormap": error * (valid > 0)}


def depth_metrics(depth, gt_depth, valid):
    """delta-threshold depth metrics (reference losses.py:241-270)."""
    error = np.abs(depth - gt_depth)
    rms = (depth - gt_depth) ** 2
    error[valid == 0] = 0
    rms[valid == 0] = 0
    thresh = np.maximum(gt_depth / depth, depth / gt_depth)
    sel = thresh[valid > 0]
    out = {}
    for base, tag in ((1.05, "105"), (1.15, "115"), (1.25, "125")):
        for p in (1, 2, 3):
            out[f"a{p}_{tag}"] = float((sel < base ** p).astype(np.float32).mean()) * 100
    out["avgerr"] = float(error[valid > 0].mean())
    out["rms"] = float(np.sqrt(rms[valid > 0].mean()))
    out["avgrelerr"] = float((error[valid > 0] / gt_depth[valid > 0]).mean()) * 100
    out["errormap"] = error * (valid > 0)
    return out


def guided_metrics(disp, gt, valid, maskocc=None):
    """bad1-8 + occ/noc splits (reference losses.py:273-342)."""
    error = np.abs(disp - gt)
    rms = (disp - gt) ** 2
    error[valid == 0] = 0
    rms[valid == 0] = 0

    def suite(err_sel, rms_sel, prefix=""):
        d = {f"{prefix}bad {t}.0": float((err_sel > t).astype(np.float32).mean()) for t in range(1, 9)}
        d[f"{prefix}avgerr"] = float(err_sel.mean()) if err_sel.size else float("nan")
        d[f"{prefix}rms"] = float(np.sqrt(rms_sel.mean())) if rms_sel.size else float("nan")
        return d

    out = suite(error[valid > 0], rms[valid > 0])
    out["errormap"] = error * (valid > 0)

    if maskocc is not None and maskocc.sum() != 0:
        occ_sel = (maskocc > 0) & (valid > 0)
        noc_sel = (maskocc == 0) & (valid > 0)
        out.update(suite(error[occ_sel], rms[occ_sel], "occ "))
        out.update(suite(error[noc_sel], rms[noc_sel], "noc "))
    else:
        for t in range(1, 9):
            out[f"occ bad {t}.0"] = float("nan")
        out["occ avgerr"] = float("nan")
        out["occ rms"] = 0.0
        # noc falls back to the all-pixel stats (reference losses.py:334-336)
        out.update({f"noc {k}": v for k, v in suite(error[valid > 0], rms[valid > 0]).items()})
    return out
