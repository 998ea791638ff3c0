"""Training loss stack (reference train.py:281-379), a copy of the JAX
package's `train/loss.py`.

Every selection is a masked mean; NaN guards are `where` clauses, so the
loss stays on the device (no host sync).  Sign convention: the model's
outputs and gt are both POSITIVE disparity (the reference compares negative
flow to -gt, train.py:298: the same math).  Maps are NHWC, as the model
returns them.

Over several ranks (`parallel/multihost.py`) each rank holds a slice of the
global batch, and the JAX package's masked means are over the global
batch's valid pixels.  So every denominator, the right view's gate and the
finiteness guard are the global batch's (SUM all-reduces, no gradient), a
rank's loss is its numerators over those denominators, and the ranks' losses
(and their gradients) SUM to the one-process loss on the whole batch.  The
logs are the global values.  Without a process group the reductions are
the identity, and the arithmetic is the one-process arithmetic.
"""
from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from stereoanywhere_tpu_torch.config import TrainConfig
from stereoanywhere_tpu_torch.ops.geometry import estimate_normals, joint_minmax_normalize
from stereoanywhere_tpu_torch.parallel.multihost import all_reduce_sum


def masked_mean(x: torch.Tensor, mask: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """sum(x over mask) / max(count, 1), `count` the mask's count over the
    global batch."""
    return (x * mask.to(x.dtype)).sum() / count.clamp(min=1.0)


def correlation_score(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-pixel dot product of NHWC normal maps (reference utils/utils.py:285-293)."""
    return (a * b).sum(dim=-1, keepdim=True)


def _normals(disp: torch.Tensor, normal_gain: float) -> torch.Tensor:
    """NHWC (B,H,W,1) depth -> NHWC (B,H,W,3) unit normals at gain W / normal_gain."""
    nchw = disp.permute(0, 3, 1, 2)
    return estimate_normals(nchw, disp.shape[2] / normal_gain).permute(0, 2, 3, 1)


def _normal_loss(disp: torch.Tensor, normals_ref: torch.Tensor, mask: torch.Tensor, normal_gain: float,
                 count: torch.Tensor):
    d = joint_minmax_normalize([disp.permute(0, 3, 1, 2)])[0].permute(0, 2, 3, 1)
    return masked_mean(1.0 - correlation_score(_normals(d, normal_gain), normals_ref), mask, count)


def stereoanywhere_loss(
    outputs: dict[str, Any],
    gt: torch.Tensor,
    validgt: torch.Tensor,
    gt_right: torch.Tensor,
    validgt_right: torch.Tensor,
    mono2: torch.Tensor,
    mono3: torch.Tensor,
    cfg: TrainConfig,
    max_disp: float | None = None,
    normal_gain: float = 10.0,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Full loss: gamma-weighted iterative L1, optional per-iteration normal
    and confidence terms, coarse L1 terms with border masks, optional coarse
    normal-correlation losses, coarse confidence BCE.

    outputs: the train-mode forward's dict: 'disparities' (I,B,H,W,1),
    coarse_dispmono2/3, coarse_scaled_mde2/3, coarse_conf2/3 (B,H,W,1);
    optionally 'confidences' (I,B,H,W,1) and coarse_dispstereo2/3.
    gt/gt_right: positive disparity (B,H,W,1); validgt*: {0,1}.  Returns
    (total, logs), all tensors on the outputs' device."""
    logs = {}
    if max_disp is None:
        max_disp = cfg.max_disp
    preds = outputs["disparities"]
    n_pred = preds.shape[0]
    th = cfg.lrc_th
    div_const = math.log(1 + math.exp(th))

    # the masks (border masks: reference train.py:319-321,349-350), and their
    # counts over the global batch (one all-reduce; the right view's terms
    # count only when some right gt is valid there)
    mask = (validgt > 0) & (gt < max_disp)
    mask_right = (validgt_right > 0) & (gt_right < max_disp)
    w = gt.shape[2]
    xx = torch.arange(w, dtype=gt.dtype, device=gt.device).view(1, 1, w, 1)
    left_border = (xx - gt >= 0) if cfg.use_border_mask else torch.ones_like(gt, dtype=torch.bool)
    right_border = (xx + gt_right < w) if cfg.use_border_mask else torch.ones_like(gt, dtype=torch.bool)
    masks = {"left": mask, "left_border": mask & left_border, "right": mask_right,
             "right_border": mask_right & right_border}
    counts = all_reduce_sum(torch.stack([m.sum(dtype=torch.float32) for m in masks.values()]
                                        + [validgt_right.sum(dtype=torch.float32)]))
    count = dict(zip(masks, counts))
    has_right = (counts[-1] > 0).to(preds.dtype)

    def mean(x, key):
        return masked_mean(x, masks[key], count[key])

    def conf_bce(conf, disp, gt_, key):
        # BCE against softplus(th - |err|) / log(1 + e^th), the target detached (train.py:340-347)
        err = (disp - gt_).abs()
        target = (F.softplus(th - err) / div_const).detach()
        a = conf.clamp(1e-6, 1 - 1e-6)
        t = target.clamp(0.0, 1.0)
        bce = -(t * torch.log(a) + (1 - t) * torch.log(1 - a))
        return mean(bce, key)

    # iterative L1 with adjusted gamma (reference train.py:290-299)
    adj_gamma = cfg.gamma ** (15.0 / max(n_pred - 1, 1))
    weights = adj_gamma ** torch.arange(n_pred - 1, -1, -1, dtype=torch.float32, device=preds.device)
    per_iter = torch.stack([mean((p - gt).abs(), "left") for p in preds])
    loss = (weights * per_iter).sum()
    logs["loss/iterative"] = loss
    logs["epe/final"] = per_iter[-1]

    if cfg.use_normal_loss:
        # per-iteration normal-correlation loss x10 (reference train.py:302-306)
        normals2_full = _normals(mono2, normal_gain)
        iter_normals = torch.stack([_normal_loss(p, normals2_full, mask, normal_gain, count["left"]) for p in preds])
        norm_term = 10.0 * (weights * iter_normals).sum()
        loss = loss + norm_term
        logs["loss/iter_normal"] = norm_term

    if outputs.get("confidences") is not None:
        # predict-confidence variant (reference train.py:308-316), with the
        # consistent |pred - gt| target (the reference's unused path flips a sign)
        iter_confs = torch.stack([conf_bce(c, p, gt, "left") for c, p in zip(outputs["confidences"], preds)])
        conf_term = (weights * iter_confs).sum()
        loss = loss + conf_term
        logs["loss/iter_conf"] = conf_term

    normals2 = _normals(mono2, normal_gain)
    normals3 = _normals(mono3, normal_gain)

    def coarse_terms(disp_list, gt_, side, normals_ref):
        # [stereo or None, mono coarse, scaled mde]: the scaler is trained
        # full-frame (reference train.py:325-330), the others under the border mask
        d_stereo, d_mono, d_scaled = disp_list
        border = f"{side}_border"
        total = mean((d_mono - gt_).abs(), border)
        total = total + mean((d_scaled - gt_).abs(), side)
        if cfg.use_normal_loss_on_coarse:
            total = total + cfg.normal_loss_gain * _normal_loss(d_mono, normals_ref, masks[border], normal_gain,
                                                                count[border])
        if d_stereo is not None:  # use_aggregate_stereo_vol variant
            total = total + mean((d_stereo - gt_).abs(), border)
            if cfg.use_normal_loss_on_coarse:
                total = total + cfg.normal_loss_gain * _normal_loss(
                    d_stereo, normals_ref, masks[border], normal_gain, count[border])
        return total

    coarse_left = coarse_terms(
        [outputs.get("coarse_dispstereo2"), outputs["coarse_dispmono2"], outputs["coarse_scaled_mde2"]],
        gt, "left", normals2,
    )
    coarse_right = coarse_terms(
        [outputs.get("coarse_dispstereo3"), outputs["coarse_dispmono3"], outputs["coarse_scaled_mde3"]],
        gt_right, "right", normals3,
    )
    logs["loss/coarse_left"] = coarse_left
    logs["loss/coarse_right"] = coarse_right

    # coarse mono confidence BCE (reference train.py:340-347)
    conf_left = conf_bce(outputs["coarse_conf2"], outputs["coarse_dispmono2"], gt, "left")
    conf_right = conf_bce(outputs["coarse_conf3"], outputs["coarse_dispmono3"], gt_right, "right")
    logs["loss/conf"] = conf_left + conf_right

    total = loss + coarse_left + conf_left + has_right * (coarse_right + conf_right)
    # the logs and the finiteness guard from the global sums (one all-reduce)
    names = list(logs)
    reduced = all_reduce_sum(torch.stack([logs[k].detach() for k in names] + [total.detach()]))
    logs = dict(zip(names, reduced))
    finite = torch.isfinite(reduced[-1])
    total = torch.where(finite, total, torch.zeros_like(total))
    logs["loss/total"] = torch.where(finite, reduced[-1], torch.zeros_like(reduced[-1]))
    return total, logs
