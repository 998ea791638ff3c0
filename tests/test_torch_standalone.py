"""The standalone variants against their JAX functions, on the CPU in f32:
modules no shipped model uses, and the rest of the JAX package's `ops/`.

Weights come from each JAX module's own `init` (moved off their init
values where those are zeros or ones, so that a leaf left behind cannot
match by chance) and reach the port through `compat.from_jax`
`load_module_variables`; inputs are made with numpy from a seed.  NHWC in
JAX, NCHW in the port.  Tolerances, relative to max(1, max |JAX|):
- `DeformableConv2d`: 1e-5, with nonzero offset weights (its offset conv
  starts at zero, which would test a regular conv only), stride 1 and 2,
  samples falling outside the image included; the gather and JAX's dense
  tent contraction weigh the same four pixels.
- The mobile extractors (`ConvBnAct`, `InvertedResidual`,
  `UniversalInvertedResidual`, `Conv2x` with and without the nearest
  resize, `FeatureAtt`, `Feature`, `FeatureV4` at every `n_downsample`):
  1e-4 (their outputs reach 10^2 through a dozen convolutions and
  BatchNorms summed in another order), on running statistics and, in
  train mode, on the batch's, the updated running statistics within the
  same 1e-4 (a deep layer's variance, E[x^2] - mean^2 in f32, carries its
  input's gap).
- `MultiUpdateScalerBlock`, its heads and its encoder: 1e-5.
- `sgm_disparity`, `census_transform`, `matching_cost`: bit for bit.
- `normalized_scale_and_shift`: 1e-4 (five f32 sums over ~600 elements,
  taken in another order, meet in a 2x2 solve whose determinant cancels:
  1.1e-5 of the shift here); `naive_scale_shift` (order statistics, no
  sums): 1e-5, the empty mask's NaN as JAX gives it.  `upflow`: 1e-6.
  `fuzzy_and_zadeh` / `fuzzy_or_zadeh`: 1e-6.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from stereoanywhere_tpu_torch.compat.from_jax import load_module_variables

torch.set_num_threads(2)


def close(got, want, tol):
    want = np.asarray(want, np.float32)
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= tol * max(1.0, float(np.abs(want).max())), err


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32).transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _init(module, *args, seed=0, **kw):
    """JAX variables of `module`, every leaf moved by a seeded draw."""
    v = jax.jit(lambda k: module.init(k, *args, **kw))(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    moved = {}
    for col, tree in v.items():
        if col == "batch_stats":  # positive variances
            moved[col] = jax.tree.map(lambda a: np.asarray(a) + rng.uniform(0.1, 0.5, a.shape).astype(np.float32),
                                      tree)
        else:
            moved[col] = jax.tree.map(lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape).astype(np.float32),
                                      tree)
    return moved


# ---------------------------------------------------------------------------
# deformable conv


@pytest.mark.parametrize("stride", [1, 2])
def test_deformable_conv_matches_jax(stride):
    from stereoanywhere_tpu.models.dcn import DeformableConv2d as JD

    from stereoanywhere_tpu_torch.models.dcn import DeformableConv2d

    rng = np.random.default_rng(stride)
    x = rng.standard_normal((2, 11, 13, 5)).astype(np.float32)
    jm = JD(6, stride=stride, use_bias=True)
    v = _init(jm, x)
    # offsets of a few pixels: samples between pixels and past the edges
    off = v["params"]["offset_modulator_conv"]
    off["kernel"] = (rng.standard_normal(off["kernel"].shape) * 0.6).astype(np.float32)
    want = np.asarray(jm.apply(v, x))
    port = load_module_variables(DeformableConv2d(5, 6, stride=stride, bias=True), v)
    got = port(nchw(x))
    close(nhwc(got), want, 1e-5)
    offs = jax.lax.conv_general_dilated(x, off["kernel"], (stride, stride), ((1, 1), (1, 1)),
                                        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    assert float(jnp.abs(offs[..., :18]).max()) > 2.0  # the taps move by more than a pixel


def test_deformable_conv_with_zero_offsets_is_a_regular_conv():
    import torch.nn.functional as F

    from stereoanywhere_tpu_torch.models.dcn import DeformableConv2d

    torch.manual_seed(0)
    m = DeformableConv2d(4, 3)
    x = torch.randn(1, 4, 9, 7)
    torch.testing.assert_close(m(x), F.conv2d(x, m.weight, None, 1, 1), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# mobile extractors


def _mobile_case(jm, pm, x, train=False, tol=1e-4):
    v = _init(jm, x, train=False)
    port = load_module_variables(pm, v)
    if train:
        want, new = jm.apply(v, x, train=True, mutable=["batch_stats"])
    else:
        want = jm.apply(v, x, train=False)
    got = port(nchw(x), train=train)
    want = want if isinstance(want, (list, tuple)) else [want]
    got = got if isinstance(got, (list, tuple)) else [got]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        close(nhwc(g), w, tol)
    if train:
        from stereoanywhere_tpu_torch.compat.from_jax import _module_rename

        rename = _module_rename(port)
        for name, t in port.state_dict().items():
            if name.endswith(("running_mean", "running_var")):
                path, _ = rename(name)
                leaf = {"running_mean": "mean", "running_var": "var"}[path[-1]]
                node = new["batch_stats"]
                for p in path[:-1]:
                    node = node[p]
                close(t, node[leaf], tol)
    return port


@pytest.mark.parametrize("train", [False, True])
def test_mobile_blocks_match_jax(train):
    from stereoanywhere_tpu.models import mobile_extractors as jme

    from stereoanywhere_tpu_torch.models import mobile_extractors as pme

    x = np.random.default_rng(3).standard_normal((2, 12, 10, 16)).astype(np.float32)
    _mobile_case(jme.ConvBnAct(24, 3, 2), pme.ConvBnAct(16, 24, 3, 2), x, train)
    _mobile_case(jme.ConvBnAct(8, 1, 1, act="none"), pme.ConvBnAct(16, 8, 1, 1, act="none"), x, train)
    _mobile_case(jme.InvertedResidual(16, 1, 6), pme.InvertedResidual(16, 16, 1, 6), x, train)
    _mobile_case(jme.InvertedResidual(24, 2, 1), pme.InvertedResidual(16, 24, 2, 1), x, train)
    _mobile_case(jme.UniversalInvertedResidual(16, 3, 5, 1, 2.0), pme.UniversalInvertedResidual(16, 16, 3, 5, 1, 2.0),
                 x, train)
    _mobile_case(jme.UniversalInvertedResidual(32, 5, 0, 2, 3.0), pme.UniversalInvertedResidual(16, 32, 5, 0, 2, 3.0),
                 x, train)


@pytest.mark.parametrize("deconv,rem_hw", [(True, (8, 10)), (True, (7, 9)), (False, (3, 2))])
def test_conv2x_matches_jax(deconv, rem_hw):
    """Conv2x up (transposed conv) and down, with the skip at the conv's
    size and at another one (JAX's nearest resize)."""
    from stereoanywhere_tpu.models.mobile_extractors import Conv2x as JC

    from stereoanywhere_tpu_torch.models.mobile_extractors import Conv2x

    rng = np.random.default_rng(4)
    x = rng.standard_normal((1, 4, 5, 12)).astype(np.float32)
    rem = rng.standard_normal((1, *rem_hw, 6)).astype(np.float32)
    for concat in (True, False):
        jm = JC(6, deconv=deconv, concat=concat)
        v = _init(jm, x, rem)
        port = load_module_variables(Conv2x(12, 6, 6, deconv=deconv, concat=concat), v)
        close(nhwc(port(nchw(x), nchw(rem))), jm.apply(v, x, rem), 1e-5)


def test_feature_att_matches_jax():
    from stereoanywhere_tpu.models.mobile_extractors import FeatureAtt as JF

    from stereoanywhere_tpu_torch.models.mobile_extractors import FeatureAtt

    rng = np.random.default_rng(5)
    cv = rng.standard_normal((2, 6, 8, 10, 4)).astype(np.float32)  # (B, D, H, W, C)
    feat = rng.standard_normal((2, 8, 10, 12)).astype(np.float32)
    jm = JF(4)
    v = _init(jm, cv, feat)
    port = load_module_variables(FeatureAtt(4, 12), v)
    got = port(torch.from_numpy(cv).permute(0, 4, 1, 2, 3), nchw(feat))
    close(got.permute(0, 2, 3, 4, 1), jm.apply(v, cv, feat), 1e-5)


@pytest.mark.parametrize("train", [False, True])
def test_feature_mobilenet_v2_matches_jax(train):
    from stereoanywhere_tpu.models.mobile_extractors import Feature as JF

    from stereoanywhere_tpu_torch.models.mobile_extractors import Feature

    x = np.random.default_rng(6).uniform(-1, 1, (2, 64, 96, 3)).astype(np.float32)
    port = _mobile_case(JF(), Feature(), x, train)
    outs = port(nchw(x))
    assert [tuple(o.shape[1:]) for o in outs] == [(48, 16, 24), (64, 8, 12), (192, 4, 6), (160, 2, 3)]


@pytest.mark.parametrize("n_downsample", [0, 1, 2, 3])
def test_feature_v4_matches_jax(n_downsample):
    from stereoanywhere_tpu.models.mobile_extractors import FeatureV4 as JF

    from stereoanywhere_tpu_torch.models.mobile_extractors import FeatureV4

    x = np.random.default_rng(7).uniform(-1, 1, (1, 64, 64, 3)).astype(np.float32)
    _mobile_case(JF(3, n_downsample), FeatureV4(3, n_downsample), x, train=n_downsample == 2)


# ---------------------------------------------------------------------------
# the scaler update block


def test_scaler_heads_and_encoder_match_jax():
    from stereoanywhere_tpu.models import update as ju

    from stereoanywhere_tpu_torch.models import update as pu

    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 8, 12, 32)).astype(np.float32)
    for jm, pm, tol in ((ju.SigmoidUpdateHead(16, 1), pu.SigmoidUpdateHead(32, 16, 1), 1e-5),
                        (ju.ScaleShiftUpdateHead(16, 2), pu.ScaleShiftUpdateHead(32, 16, 2), 1e-5)):
        v = _init(jm, x)
        close(nhwc(load_module_variables(pm, v)(nchw(x))), jm.apply(v, x), tol)
    flow = rng.standard_normal((2, 8, 12, 2)).astype(np.float32)
    conf = rng.uniform(0, 1, (2, 8, 12, 1)).astype(np.float32)
    corr, corr_mono = (rng.standard_normal((2, 8, 12, 36)).astype(np.float32) for _ in range(2))
    jm = ju.ConfidenceAwareMotionEncoder()
    v = _init(jm, flow, conf, corr, corr_mono)
    pm = load_module_variables(pu.ConfidenceAwareMotionEncoder(36), v)
    close(nhwc(pm(*map(nchw, (flow, conf, corr, corr_mono)))), jm.apply(v, flow, conf, corr, corr_mono), 1e-5)


def test_multi_update_scaler_block_matches_jax():
    from stereoanywhere_tpu.models.update import MultiUpdateScalerBlock as JB

    from stereoanywhere_tpu_torch.models.update import MultiUpdateScalerBlock

    rng = np.random.default_rng(9)
    hd, (h, w) = 32, (16, 16)
    net = [rng.standard_normal((1, h // 2 ** i, w // 2 ** i, hd)).astype(np.float32) for i in range(3)]
    inp = [tuple(rng.standard_normal((1, h // 2 ** i, w // 2 ** i, hd)).astype(np.float32) for _ in range(3))
           for i in range(3)]
    corr, corr_mono = (rng.standard_normal((1, h, w, 36)).astype(np.float32) for _ in range(2))
    flow = rng.standard_normal((1, h, w, 2)).astype(np.float32)
    conf = rng.uniform(0, 1, (1, h, w, 1)).astype(np.float32)
    jm = JB((hd, hd, hd), 3)
    v = _init(jm, net, inp, corr, corr_mono, flow, conf)
    want = jm.apply(v, net, inp, corr, corr_mono, flow, conf)
    pm = load_module_variables(MultiUpdateScalerBlock((hd, hd, hd), 3, 36), v)
    got = pm([nchw(n) for n in net], [tuple(nchw(t) for t in tr) for tr in inp], nchw(corr), nchw(corr_mono),
             nchw(flow), nchw(conf))
    for g, wnt in zip(got[0], want[0]):
        close(nhwc(g), wnt, 1e-5)
    for g, wnt in zip(got[1:], want[1:]):
        close(nhwc(g), wnt, 1e-5)
    assert got[2].shape == (1, 1, 1, 1) and got[1].shape == (1, 1, h, w)


# ---------------------------------------------------------------------------
# SGM and the rest of ops/


@pytest.mark.parametrize("h,w,max_disp", [(12, 40, 16), (20, 33, 24)])
def test_sgm_matches_jax_bit_for_bit(h, w, max_disp):
    from stereoanywhere_tpu.ops import sgm as jsgm

    from stereoanywhere_tpu_torch.ops import sgm

    rng = np.random.default_rng(h)
    left = rng.uniform(0, 1, (2, h, w)).astype(np.float32)
    right = np.roll(left, -5, axis=2) + rng.normal(0, 0.02, left.shape).astype(np.float32)
    np.testing.assert_array_equal(sgm.census_transform(torch.from_numpy(left)).numpy(),
                                  np.asarray(jsgm.census_transform(jnp.asarray(left))).astype(np.int64))
    np.testing.assert_array_equal(sgm.matching_cost(torch.from_numpy(left), torch.from_numpy(right), max_disp).numpy(),
                                  np.asarray(jsgm.matching_cost(jnp.asarray(left), jnp.asarray(right), max_disp)))
    got = sgm.sgm_disparity(torch.from_numpy(left), torch.from_numpy(right), max_disp)
    want = np.asarray(jsgm.sgm_disparity(jnp.asarray(left), jnp.asarray(right), max_disp))
    assert got.dtype == torch.float32 and got.shape == (2, h, w)
    np.testing.assert_array_equal(got.numpy(), want)
    assert np.median(want[:, :, max_disp:]) == 5.0  # it finds the shift


def test_scale_shift_estimators_match_jax():
    from stereoanywhere_tpu.ops import lsq as jlsq

    from stereoanywhere_tpu_torch.ops import lsq

    rng = np.random.default_rng(10)
    mde = rng.uniform(0, 1, (3, 9, 11, 2)).astype(np.float32)
    disp = (mde * 30 + 4 + rng.normal(0, 1, mde.shape)).astype(np.float32)
    conf = rng.uniform(0, 1, mde.shape).astype(np.float32)
    conf[2] = 0.1  # an empty mask: NaN in both
    mask = (rng.uniform(0, 1, mde.shape) > 0.3).astype(np.float32)
    for q in ((0.2, 0.9), (0.0, 1.0)):
        want = jlsq.normalized_scale_and_shift(jnp.asarray(mde), jnp.asarray(disp), jnp.asarray(mask), *q)
        got = lsq.normalized_scale_and_shift(nchw(mde), nchw(disp), nchw(mask), *q)
        for g, wnt in zip(got, want):
            assert g.shape == (3, 1, 1, 1)
            close(g, wnt, 1e-4)
    want = jlsq.naive_scale_shift(jnp.asarray(mde), jnp.asarray(disp), jnp.asarray(conf))
    got = lsq.naive_scale_shift(nchw(mde), nchw(disp), nchw(conf))
    for g, wnt in zip(got, want):
        g, wnt = g.numpy().reshape(-1), np.asarray(wnt).reshape(-1)
        np.testing.assert_array_equal(np.isnan(g), np.isnan(wnt))
        assert np.isnan(g[2])
        np.testing.assert_allclose(g[:2], wnt[:2], rtol=1e-5, atol=1e-5)


def test_upflow_and_zadeh_ops_match_jax():
    from stereoanywhere_tpu.ops import fuzzy as jfz
    from stereoanywhere_tpu.ops.upsample import upflow as jupflow

    from stereoanywhere_tpu_torch.ops import fuzzy
    from stereoanywhere_tpu_torch.ops.upsample import upflow

    rng = np.random.default_rng(11)
    flow = rng.standard_normal((2, 5, 7, 1)).astype(np.float32)
    for factor, scaled in ((2, True), (1, False)):
        close(nhwc(upflow(nchw(flow), factor, scaled)), jupflow(jnp.asarray(flow), factor, scaled), 1e-6)
    x, y = (rng.uniform(0, 1, (2, 6, 8, 1)).astype(np.float32) for _ in range(2))
    for jf, pf in ((jfz.fuzzy_and_zadeh, fuzzy.fuzzy_and_zadeh), (jfz.fuzzy_or_zadeh, fuzzy.fuzzy_or_zadeh)):
        for eps in (1e-3, 0.1):
            close(nhwc(pf(nchw(x), nchw(y), eps)), jf(jnp.asarray(x), jnp.asarray(y), eps), 1e-6)
    assert np.allclose(nhwc(fuzzy.fuzzy_and_zadeh(nchw(x), nchw(y))), np.minimum(x, y), atol=1e-3)
