"""The port's training math held against the JAX package on the CPU in f32:
the train-mode forward (`test_mode=False`), the gradient of the loss with
respect to every trainable parameter, the loss with all its terms, the
auxiliary losses and the volume corruption.

Inputs are made with numpy from a seed; the JAX model's variables come from
its own `init` and reach the port through `compat.from_jax`.  The JAX side
runs its default layout (the folded, blocked hourglass; the windowed XLA
lookup); the port its NCHW modules and the plain gather.
"""
import re

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from stereoanywhere_tpu_torch.compat import from_jax

torch.set_num_threads(2)
B, H, W, ITERS = 1, 32, 64, 2  # the smallest size the hourglass admits


def close(got, want, tol):
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= tol * max(1.0, float(np.abs(want).max())), err


@pytest.fixture(scope="module")
def train_case():
    """JAX variables, inputs, JAX's train-mode outputs, and the gradient of
    JAX's loss over that forward with fnet frozen (its trainer's
    stop_gradient), computed once."""
    from stereoanywhere_tpu.config import StereoAnywhereConfig as JCfg, TrainConfig as JTrain
    from stereoanywhere_tpu.models import StereoAnywhere as JSA
    from stereoanywhere_tpu.train.loss import stereoanywhere_loss as jloss
    from stereoanywhere_tpu.train.trainer import freeze_mask

    rng = np.random.default_rng(21)
    ins = [rng.uniform(0, 1, (B, H, W, c)).astype(np.float32) for c in (3, 3, 1, 1)]
    gt = rng.uniform(0.5, 12, (B, H, W, 1)).astype(np.float32)
    valid = (rng.uniform(0, 1, (B, H, W, 1)) > 0.2).astype(np.float32)
    gt_r = rng.uniform(0.5, 12, (B, H, W, 1)).astype(np.float32)
    valid_r = (rng.uniform(0, 1, (B, H, W, 1)) > 0.2).astype(np.float32)
    model = JSA(JCfg(volume_corruption_prob=0.0))
    v = jax.tree.map(np.asarray, jax.jit(lambda k: model.init(k, *ins, iters=1, test_mode=True))(
        jax.random.PRNGKey(0)))

    def forward(params):
        out, _ = model.apply({"params": params, "batch_stats": v["batch_stats"]}, *ins, iters=ITERS,
                             test_mode=False, train=True, mutable=["batch_stats"])
        return out

    def loss_fn(params):
        mask = freeze_mask(params, ("fnet",))
        params = jax.tree.map(lambda p, t: p if t else jax.lax.stop_gradient(p), params, mask)
        return jloss(forward(params), gt, valid, gt_r, valid_r, ins[2], ins[3], JTrain())

    outputs = jax.tree.map(np.asarray, jax.jit(forward)(v["params"]))
    (total, logs), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(v["params"])
    return dict(v=v, ins=ins, gt=(gt, valid, gt_r, valid_r), outputs=outputs, total=float(total),
                logs=jax.tree.map(np.asarray, logs), grads=jax.tree.map(np.asarray, grads))


def _port(train_case):
    from stereoanywhere_tpu_torch.config import StereoAnywhereConfig
    from stereoanywhere_tpu_torch.models import StereoAnywhere

    model = StereoAnywhere(StereoAnywhereConfig(volume_corruption_prob=0.0), device="cpu")
    return from_jax.load_stereo_variables(model, train_case["v"])


def test_train_forward_matches_jax(train_case):
    """Every train-mode output: the per-iteration disparities, the final
    one, the coarse maps, scale and shift.  Tolerance 1e-4 of each
    output's magnitude (the f32 sums in another order, as in
    test_torch_modules.py)."""
    model = _port(train_case)
    out = model(*(torch.from_numpy(a) for a in train_case["ins"]), iters=ITERS, test_mode=False)
    want = train_case["outputs"]
    assert out["disparities"].shape == (ITERS, B, H, W, 1)
    for k in ("disparities", "disparity", "coarse_dispmono2", "coarse_dispmono3", "coarse_scaled_mde2",
              "coarse_scaled_mde3", "coarse_conf2", "coarse_conf3"):
        close(out[k].detach().numpy(), want[k], 1e-4)
    for k in ("scale", "shift"):
        close(out[k].detach().reshape(-1).numpy(), np.reshape(want[k], -1), 1e-4)


def test_train_loss_gradients_match_jax(train_case):
    """The loss over the train-mode forward, and its gradient with respect
    to every trainable parameter (fnet frozen), against jax.grad.  The loss
    and its logs to 1e-4 relative.  Gradients: a parameter's gradient within
    4e-2 of its L2 norm, all of them together within 5e-3.  Most parameters
    agree to 1e-4; the largest gap on these inputs, 3.1e-2, is in the
    context encoder upstream of one ReLU whose input lies 1e-7 of its
    layer's scale from zero, where the two f32 forwards fall on opposite
    sides of the kink.  Removing one of the JAX package's stop-gradient
    points from the port moves at least one parameter to between 5.4e-2
    (the truncation mask) and 2.8 (the coordinates); the min-max
    statistics' stop-gradient has its own test below."""
    from stereoanywhere_tpu_torch.config import TrainConfig
    from stereoanywhere_tpu_torch.train.loss import stereoanywhere_loss

    model = _port(train_case)
    for name, p in model.named_parameters():
        p.requires_grad_(not name.startswith("fnet."))
    ins = [torch.from_numpy(a) for a in train_case["ins"]]
    out = model(*ins, iters=ITERS, test_mode=False)
    total, logs = stereoanywhere_loss(out, *(torch.from_numpy(a) for a in train_case["gt"]), ins[2], ins[3],
                                      TrainConfig())
    np.testing.assert_allclose(float(total.detach()), train_case["total"], rtol=1e-4)
    for k, v in train_case["logs"].items():
        np.testing.assert_allclose(float(logs[k].detach()), float(v), rtol=1e-4, atol=1e-6, err_msg=k)
    total.backward()
    grads = train_case["grads"]
    num = den = 0.0
    checked = 0
    for name, p in model.named_parameters():
        if name.startswith("fnet."):
            assert p.grad is None
            continue
        path, kind = from_jax._stereo_rename(name)
        if kind == "bn":
            path, kind = path[:-1] + [{"weight": "scale", "bias": "bias"}[path[-1]]], "raw"
        want = from_jax._TO_TORCH[kind](from_jax._get(grads, tuple(path)))
        got = np.zeros_like(want) if p.grad is None else p.grad.numpy()
        d, n = float(np.linalg.norm(got - want)), float(np.linalg.norm(want))
        assert d <= 4e-2 * n + 1e-9, (name, d, n)
        num, den = num + d * d, den + n * n
        checked += 1
    assert checked > 100 and np.sqrt(num) <= 5e-3 * np.sqrt(den)


def _grad_gaps(model, grads, skip=()) -> tuple[dict, float]:
    """Each trainable parameter's gradient gap to JAX's over its norm (but
    the parameters in `skip`), and the gap of all of them together."""
    gaps, num, den = {}, 0.0, 0.0
    for name, p in model.named_parameters():
        if name.startswith("fnet."):
            continue
        path, kind = from_jax._stereo_rename(name)
        if kind == "bn":
            path, kind = path[:-1] + [{"weight": "scale", "bias": "bias"}[path[-1]]], "raw"
        want = from_jax._TO_TORCH[kind](from_jax._get(grads, tuple(path)))
        got = np.zeros_like(want) if p.grad is None else p.grad.float().numpy()
        d, n = float(np.linalg.norm(got - want)), float(np.linalg.norm(want))
        if name not in skip:
            gaps[name] = d / (n + 1e-30)
        num, den = num + d * d, den + n * n
    return gaps, float(np.sqrt(num / den))


@pytest.fixture(scope="module")
def batch_stats_case(train_case):
    """JAX's train step with batch-statistic BatchNorm (`freeze_bn=False`,
    `mutable=["batch_stats"]`) from random running statistics: the
    outputs, the updated statistics, the loss and its gradient (fnet
    frozen)."""
    from stereoanywhere_tpu.config import StereoAnywhereConfig as JCfg, TrainConfig as JTrain
    from stereoanywhere_tpu.models import StereoAnywhere as JSA
    from stereoanywhere_tpu.train.loss import stereoanywhere_loss as jloss
    from stereoanywhere_tpu.train.trainer import freeze_mask

    rng = np.random.default_rng(5)
    v = train_case["v"]
    stats = jax.tree.map(lambda a: rng.uniform(0.5, 1.5, a.shape).astype(np.float32), v["batch_stats"])
    ins = train_case["ins"]
    model = JSA(JCfg(volume_corruption_prob=0.0, freeze_bn=False))

    def loss_fn(params):
        mask = freeze_mask(params, ("fnet",))
        params = jax.tree.map(lambda p, t: p if t else jax.lax.stop_gradient(p), params, mask)
        out, mutated = model.apply({"params": params, "batch_stats": stats}, *ins, iters=ITERS, test_mode=False,
                                   train=True, mutable=["batch_stats"])
        total, logs = jloss(out, *train_case["gt"], ins[2], ins[3], JTrain())
        return total, (out, mutated["batch_stats"], logs)

    (total, (out, new_stats, logs)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(v["params"])
    as_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return dict(v={"params": v["params"], "batch_stats": stats}, outputs=as_np(out), stats=as_np(new_stats),
                total=float(total), logs=as_np(logs), grads=as_np(grads))


def test_batch_statistics_train_step_matches_jax(train_case, batch_stats_case):
    """`freeze_bn=False`: the port's train forward, loss and gradients
    against JAX's `mutable=["batch_stats"]` step (outputs 1e-4 of their
    magnitude, the loss and its logs 1e-4 relative; gradients 4e-2 of a
    parameter's norm, 5e-3 all together, as above), and every updated
    running statistic (0.9 ra + 0.1 of the batch's, the variance unbiased)
    to 1e-5 of its magnitude."""
    from stereoanywhere_tpu_torch.config import StereoAnywhereConfig, TrainConfig
    from stereoanywhere_tpu_torch.models import StereoAnywhere
    from stereoanywhere_tpu_torch.models.layers import BatchNorm
    from stereoanywhere_tpu_torch.train.loss import stereoanywhere_loss

    case = batch_stats_case
    model = StereoAnywhere(StereoAnywhereConfig(volume_corruption_prob=0.0, freeze_bn=False), device="cpu")
    from_jax.load_stereo_variables(model, case["v"])
    for name, p in model.named_parameters():
        p.requires_grad_(not name.startswith("fnet."))
    ins = [torch.from_numpy(a) for a in train_case["ins"]]
    out = model(*ins, iters=ITERS, test_mode=False)
    for k in ("disparities", "coarse_dispmono2", "coarse_scaled_mde3", "coarse_conf2"):
        close(out[k].detach().numpy(), case["outputs"][k], 1e-4)
    total, logs = stereoanywhere_loss(out, *(torch.from_numpy(a) for a in train_case["gt"]), ins[2], ins[3],
                                      TrainConfig())
    np.testing.assert_allclose(float(total.detach()), case["total"], rtol=1e-4)
    for k, v in case["logs"].items():
        np.testing.assert_allclose(float(logs[k]), float(v), rtol=1e-4, atol=1e-6, err_msg=k)
    total.backward()
    # a conv bias ahead of a batch-statistic BatchNorm has a zero gradient
    # (the batch mean takes it out): both sides hold round-off there
    ahead_of_bn = {n for n, _ in model.named_parameters() if re.match(r"cnet\..*(conv\d|downsample\.0)\.bias$", n)}
    assert len(ahead_of_bn) == 33
    gaps, overall = _grad_gaps(model, case["grads"], skip=ahead_of_bn)
    assert max(gaps.values()) <= 4e-2 and overall <= 5e-3, (max(gaps.items(), key=lambda kv: kv[1]), overall)
    largest = max(float(p.grad.norm()) for _, p in model.named_parameters() if p.grad is not None)
    assert all(float(p.grad.norm()) <= 1e-5 * largest for n, p in model.named_parameters() if n in ahead_of_bn)
    checked = 0
    for name, m in model.named_modules():
        if isinstance(m, BatchNorm):
            path, _ = from_jax._stereo_rename(f"{name}.running_mean")
            for buf, key in ((m.running_mean, "mean"), (m.running_var, "var")):
                close(buf.numpy(), from_jax._get(case["stats"], tuple(path[:-1] + [key])), 1e-5)
            checked += 1
    assert checked == 33


def test_minmax_statistics_carry_no_gradient(rng):
    """`joint_minmax_normalize`'s gradient against jax.grad of the JAX
    package's, whose min and max are stop-gradient: 1e-6 relative."""
    from stereoanywhere_tpu.ops.geometry import joint_minmax_normalize as jnorm

    from stereoanywhere_tpu_torch.ops.geometry import joint_minmax_normalize

    a, b, w = (rng.uniform(0, 5, (2, 7, 9, 1)).astype(np.float32) for _ in range(3))
    want = jax.grad(lambda x, y: sum(jnp.sum(o * w) for o in jnorm([x, y])), argnums=(0, 1))(a, b)
    ta, tb = (torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_() for x in (a, b))
    tw = torch.from_numpy(w).permute(0, 3, 1, 2)
    sum((o * tw).sum() for o in joint_minmax_normalize([ta, tb])).backward()
    for t, g in zip((ta, tb), want):
        close(t.grad.permute(0, 2, 3, 1).numpy(), np.asarray(g), 1e-6)


def test_loss_matches_jax_every_term(rng):
    """`stereoanywhere_loss` against JAX's on random outputs, every log key:
    the default terms, the per-iteration normal and confidence terms, the
    stereo-aggregation terms, and the right view gated out when no right gt
    is valid.  1e-5 relative (the same f32 expressions)."""
    from stereoanywhere_tpu.config import TrainConfig as JTrain
    from stereoanywhere_tpu.train.loss import stereoanywhere_loss as jloss

    from stereoanywhere_tpu_torch.config import TrainConfig
    from stereoanywhere_tpu_torch.train.loss import stereoanywhere_loss

    iters, b, h, w = 3, 2, 16, 24

    def field(lo, hi, n=(b,)):
        return rng.uniform(lo, hi, (*n, h, w, 1)).astype(np.float32)

    outputs = {
        "disparities": field(0, 20, (iters, b)), "confidences": field(0.05, 0.95, (iters, b)),
        "coarse_dispmono2": field(0, 20), "coarse_dispmono3": field(0, 20),
        "coarse_scaled_mde2": field(0, 20), "coarse_scaled_mde3": field(0, 20),
        "coarse_dispstereo2": field(0, 20), "coarse_dispstereo3": field(0, 20),
        "coarse_conf2": field(0.05, 0.95), "coarse_conf3": field(0.05, 0.95),
    }
    gt, gt_r = field(0, 30), field(0, 30)
    valid = (rng.uniform(0, 1, gt.shape) > 0.3).astype(np.float32)
    for valid_r in ((rng.uniform(0, 1, gt.shape) > 0.3).astype(np.float32), np.zeros_like(gt)):
        for kw in (dict(), dict(use_normal_loss=True, use_border_mask=False, use_normal_loss_on_coarse=False)):
            for drop in ((), ("confidences", "coarse_dispstereo2", "coarse_dispstereo3")):
                outs = {k: v for k, v in outputs.items() if k not in drop}
                args = (gt, valid, gt_r, valid_r, field(0.05, 0.95), field(0.05, 0.95))
                jt, jl = jloss({k: jnp.asarray(v) for k, v in outs.items()}, *map(jnp.asarray, args), JTrain(**kw))
                pt, pl = stereoanywhere_loss({k: torch.from_numpy(v) for k, v in outs.items()},
                                             *map(torch.from_numpy, args), TrainConfig(**kw))
                assert sorted(jl) == sorted(pl)
                np.testing.assert_allclose(float(pt), float(jt), rtol=1e-5)
                for k in jl:
                    np.testing.assert_allclose(float(pl[k]), float(jl[k]), rtol=1e-5, atol=1e-7, err_msg=k)


def test_loss_extras_match_jax(rng):
    """Every auxiliary loss and the RANSAC fit against the JAX package's,
    1e-5 relative (RANSAC: the same numpy code, equal)."""
    from stereoanywhere_tpu.train import loss_extras as J

    from stereoanywhere_tpu_torch.train import loss_extras as P

    b, h, w = 2, 12, 20
    im_l, im_r = (rng.uniform(0, 1, (b, h, w, 3)).astype(np.float32) for _ in range(2))
    disp = rng.uniform(-1, 6, (b, h, w, 1)).astype(np.float32)
    pred, target = (rng.uniform(0.1, 5, (b, h, w, 1)).astype(np.float32) for _ in range(2))
    valid = (rng.uniform(0, 1, (b, h, w, 1)) > 0.3).astype(np.float32)
    conf = rng.uniform(0, 1, (b, h, w, 1)).astype(np.float32)
    cases = [
        ("ssim", (im_l, im_r)), ("csim", (im_l, im_r)), ("photometric_loss", (im_l, im_r)),
        ("smoothness_loss", (disp, im_l)), ("self_supervised_loss", (im_l, im_r, disp)),
        ("triplet_photometric_loss", (im_l, im_r, disp)), ("sparsity_loss", (conf,)),
        ("total_variation_loss", (im_l,)), ("silog_loss", (pred, target, valid)),
        ("affine_invariant_mae", (pred, target, valid)),
    ]
    for name, args in cases:
        want = np.asarray(getattr(J, name)(*map(jnp.asarray, args)))
        got = getattr(P, name)(*map(torch.from_numpy, args)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6, err_msg=name)
    mde = rng.uniform(0, 1, (h, w)).astype(np.float32)
    d = 3 * mde + 1 + rng.normal(0, 0.1, (h, w)).astype(np.float32)
    assert P.ransac_scale_shift(mde, d, valid[0, ..., 0]) == J.ransac_scale_shift(mde, d, valid[0, ..., 0])


# ---------------------------------------------------------------------------
# volume corruption


def test_corrupt_volume_branches_match_jax_arithmetic(rng):
    """Each corruption, given the same mask, shift and noise, against the JAX
    package's branch arithmetic (`_corrupt_volumes`) built from its own
    `generate_masks` and `gauss_corr_volume`; f32 and bf16 volumes, 1e-6
    relative in f32 and equal rounding points in bf16 (one bf16 ulp)."""
    from stereoanywhere_tpu.ops.volume import gauss_corr_volume as jgauss, generate_masks as jmasks

    from stereoanywhere_tpu_torch.models.stereoanywhere import corrupt_volume
    from stereoanywhere_tpu_torch.ops.volume import generate_masks

    b, h, w, n = 2, 6, 16, 4
    mde = rng.uniform(0, 1, (b, h, w, 1)).astype(np.float32)
    noise = rng.uniform(0, 1, (b, h, w, 1)).astype(np.float32)
    for dtype, jdt, tol in ((torch.float32, jnp.float32, 1e-6), (torch.bfloat16, jnp.bfloat16, 8e-3)):
        vol = rng.standard_normal((b, h, w, w)).astype(np.float32)
        jvol = jnp.asarray(vol).astype(jdt)
        pvol = torch.from_numpy(vol).to(dtype)
        for mi in range(n):
            jm = jmasks(jnp.asarray(mde), n)[..., mi][..., None].astype(jdt)
            pm = generate_masks(torch.from_numpy(mde).permute(0, 3, 1, 2), n)[:, mi, :, :, None]
            np.testing.assert_array_equal(pm.numpy(), np.asarray(jm, np.float32))
            for shift in (1, 5, w):
                want = {
                    "roll": jvol * (1 - jm) + jnp.roll(jvol, shift, axis=2) * jm,
                    "noise": jvol * (1 - jm) + jvol * jnp.asarray(noise).astype(jdt) * jm,
                    "zero": jvol * (1 - jm) + jvol * jgauss(jnp.zeros((b, h, w, 1)), jnp.max(jvol)).astype(jdt) * jm,
                }
                for kind, wv in want.items():
                    got = corrupt_volume(pvol, kind, pm, shift, torch.from_numpy(noise))
                    assert got.dtype == dtype
                    close(got.float().numpy(), np.asarray(wv, np.float32), tol)


def test_corruption_branch_frequencies():
    """Branch i of six fires with probability (1-p)^i p and none with
    (1-p)^6, over 20000 draws from the host generator: each frequency
    within 4.5 standard deviations of its binomial (a false alarm about one
    run in 10^5 a branch); the mask index and shift uniform over their
    ranges."""
    from stereoanywhere_tpu_torch.models.stereoanywhere import draw_corruption

    p, n, w = 0.3, 4, 16
    g = torch.Generator().manual_seed(0)
    draws = [draw_corruption(p, n, w, g) for _ in range(20000)]
    counts = np.bincount([d[0] for d in draws], minlength=7)
    want = np.array([(1 - p) ** i * p for i in range(6)] + [(1 - p) ** 6])
    sd = np.sqrt(len(draws) * want * (1 - want))
    assert np.all(np.abs(counts - len(draws) * want) <= 4.5 * sd), (counts, len(draws) * want)
    assert sorted({d[1] for d in draws}) == list(range(n))
    assert sorted({d[2] for d in draws}) == list(range(1, w + 1))


def test_corruption_detaches_only_the_corrupted_volume():
    """In train mode, whichever volume a branch corrupts carries no gradient
    and the other keeps its gradient: a stereo branch leaves fnet's
    gradient at None (fnet reaches the loss only through the stereo
    volume), a mono branch leaves it nonzero and cuts the mono
    aggregation's path through the lookups."""
    from stereoanywhere_tpu_torch.config import StereoAnywhereConfig
    from stereoanywhere_tpu_torch.models import StereoAnywhere
    from stereoanywhere_tpu_torch.models import stereoanywhere as sa

    rng = np.random.default_rng(3)
    ins = [torch.from_numpy(rng.uniform(0, 1, (1, 32, 64, c)).astype(np.float32)) for c in (3, 3, 1, 1)]
    model = StereoAnywhere(StereoAnywhereConfig(volume_corruption_prob=1.0), device="cpu")
    seen = {}
    real_draw = sa.draw_corruption
    for branch in range(7):
        sa.draw_corruption = lambda *a, _b=branch: (_b, 1, 3)
        try:
            model.zero_grad(set_to_none=True)
            out = model(*ins, iters=1, test_mode=False, generator=torch.Generator().manual_seed(0))
            out["disparities"].sum().backward()
        finally:
            sa.draw_corruption = real_draw
        seen[branch] = model.fnet.conv1.weight.grad
    for branch in range(3):  # the stereo volume corrupted: no gradient reaches fnet
        assert seen[branch] is None, branch
    for branch in range(3, 7):
        assert seen[branch] is not None and seen[branch].abs().max() > 0, branch
