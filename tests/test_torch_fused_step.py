"""The fused refinement configuration (`fused_level0="on"`) and the dual
lookup, held against the JAX package on the CPU in f32.

Module by module, the plain versions of the port's K5, K7, K8 and K9
kernels (and the K6 interface) against the JAX package's Pallas kernels
run in interpret mode and against its XLA references (`step_*_ref`); then
the whole slice: the port's fused forward against the JAX forward with
`fused_level0="off"`.  Inputs are made with numpy from a seed.

Tolerances: 1e-5 for the lookup (the same products and sums; relative to
max |output|), 1e-4 for the convolutional kernels and the forward (the
same f32 arithmetic with sums in another order: XLA's dots against
MKL-DNN's convolutions), as `tests/test_pallas_kernel.py` and
`tests/test_model_forward.py` hold the JAX package's own kernels.  In bf16
(the `_bf16` tests, K5, K7, K8 and K9): max |port - JAX| <= 1e-2 max |JAX|,
the card's bf16 tolerance (`test_torch_kernels.py`): both round at the
same points from f32 sums taken in another order, so a rounded
intermediate may differ by one bf16 ulp.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from stereoanywhere_tpu_torch.compat import from_jax
from stereoanywhere_tpu_torch.ops import step_fused as P
from stereoanywhere_tpu_torch.ops.cuda.corr_lookup import DualPyramid, dual_lookup

torch.set_num_threads(2)


def close(got, want, tol):
    want = np.asarray(want, dtype=np.float32)
    got = np.asarray(got, dtype=np.float32)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * max(1.0, float(np.abs(want).max())))


def t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def conv_module(kernel, bias):
    """A torch Conv2d holding the HWIO kernel and bias."""
    kh, kw, i, o = kernel.shape
    m = torch.nn.Conv2d(i, o, (kh, kw), padding=kh // 2)
    with torch.no_grad():
        m.weight.copy_(t(np.asarray(kernel).transpose(3, 2, 0, 1)))
        m.bias.copy_(t(bias))
    return m


# ---------------------------------------------------------------------------
# K5: the dual lookup


def _levels(rng, b, h, w2, wl0, n=4):
    wls = [wl0 // 2 ** i for i in range(n)]
    return ([rng.standard_normal((b, h, w2, wl)).astype(np.float32) for wl in wls],
            [rng.standard_normal((b, h, w2, wl)).astype(np.float32) for wl in wls])


def _coords_past_both_ends(rng, b, h, w2, wl0, n=4):
    """Coordinates inside every level and far past both of its ends: level
    n-1 (width wl0 / 2^(n-1)) is read at coords / 2^(n-1)."""
    top = 2 ** (n - 1)
    c = rng.uniform(-12 * top, (wl0 // top + 12) * top, (b, h, w2)).astype(np.float32)
    c.flat[:4] = [-1e4, 1e4, -0.5, wl0 - 0.5]  # far outside, and straddling each end
    return c


@pytest.mark.parametrize("impl", ["mxu", "barrel", "window", "inline", "lagged"])
def test_dual_lookup_matches_jax(rng, impl):
    from stereoanywhere_tpu.ops.corr_lookup import CorrPyramid, lookup_corr_pyramid
    from stereoanywhere_tpu.ops.pallas.corr_barrel import dual_lookup_barrel
    from stereoanywhere_tpu.ops.pallas.corr_mxu import dual_lookup_mxu

    from stereoanywhere_tpu_torch.ops.corr_lookup import lookup_corr_pyramid_pair

    b, h, w2, wl0, r = 1, 8, 16, 32, 4
    la, lb = _levels(rng, b, h, w2, wl0)
    c = _coords_past_both_ends(rng, b, h, w2, wl0)
    if impl == "mxu":
        want = dual_lookup_mxu(tuple(map(jnp.asarray, la)), tuple(map(jnp.asarray, lb)), jnp.asarray(c), r,
                               interpret=True)
    elif impl == "barrel":
        want = dual_lookup_barrel(tuple(map(jnp.asarray, la)), tuple(map(jnp.asarray, lb)), jnp.asarray(c), r,
                                  interpret=True)
    else:
        want = tuple(lookup_corr_pyramid(CorrPyramid(tuple(map(jnp.asarray, lv)), r), jnp.asarray(c))
                     for lv in (la, lb))
    got = lookup_corr_pyramid_pair(DualPyramid([t(x) for x in la], [t(x) for x in lb]), t(c), r, impl)
    for g, wnt in zip(got, want):
        assert g.shape == (b, h, w2, 4 * (2 * r + 1))
        close(g.numpy(), wnt, 1e-5)
    # the zero padding: a coordinate far outside reads nothing at any level
    assert float(got[0][0, 0, 0].abs().max()) == 0.0 and float(got[1][0, 0, 1].abs().max()) == 0.0


def test_dual_lookup_rejects_unknown_impl():
    from stereoanywhere_tpu_torch.ops.corr_lookup import lookup_corr_pyramid_pair

    with pytest.raises(ValueError, match="unknown lookup impl"):
        lookup_corr_pyramid_pair(DualPyramid([torch.zeros(1, 1, 1, 4)], [torch.zeros(1, 1, 1, 4)]),
                                 torch.zeros(1, 1, 1), 1, "x")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lookup_pair_gives_one_result_for_every_impl(rng, dtype):
    """Every `lookup_impl` is one function: on the CPU each gives the plain
    gather's result, bit for bit, and that result is JAX's
    `lookup_corr_pyramid_pair` for each of its impls and JAX's XLA pair
    formulations (the TPU's window, inline-tent and lagged forms, here
    evaluated on the CPU) level by level.  f32: 1e-5 (the tent forms sum
    the same products with zero-weight terms added); bf16: 1e-2 of max
    |JAX| (the tent forms round the weight 1 - |j - pos| to bf16 from f32,
    the gather 1 - f from bf16 f: one bf16 ulp apart at most)."""
    from stereoanywhere_tpu.ops import corr_lookup as J

    from stereoanywhere_tpu_torch.config import LOOKUP_IMPLS
    from stereoanywhere_tpu_torch.ops.corr_lookup import lookup_corr_pyramid_pair

    b, h, w2, wl0, r = 1, 4, 16, 64, 4
    la, lb = _levels(rng, b, h, w2, wl0)
    c = _coords_past_both_ends(rng, b, h, w2, wl0)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    pyr = DualPyramid([t(x).to(tdt) for x in la], [t(x).to(tdt) for x in lb])
    got = {impl: lookup_corr_pyramid_pair(pyr, t(c), r, impl) for impl in LOOKUP_IMPLS}
    for impl in LOOKUP_IMPLS:
        for g, ref in zip(got[impl], got["window"]):
            assert g.dtype == tdt and torch.equal(g, ref), impl
    check = close if dtype == "float32" else _bf16_close
    tol = 1e-5 if dtype == "float32" else 1e-2
    ja, jb = (J.CorrPyramid(tuple(jnp.asarray(x, jdt) for x in lv), r) for lv in (la, lb))
    for impl in ("lagged", "inline", "window", "mxu"):
        for g, wnt in zip(got["window"], J.lookup_corr_pyramid_pair(ja, jb, jnp.asarray(c), impl)):
            check(g.float().numpy(), np.asarray(wnt.astype(jnp.float32)), tol)
    for pair_fn in (J._lookup_level_window_pair, J._lookup_level_inline_tent_pair, J._lookup_level_lagged_pair):
        outs = [pair_fn(x, y, jnp.asarray(c) / 2 ** i, r) for i, (x, y) in enumerate(zip(ja.levels, jb.levels))]
        for p in range(2):
            want = np.concatenate([np.asarray(o[p].astype(jnp.float32)) for o in outs], -1)
            check(got["window"][p].float().numpy(), want, tol)


def test_dual_lookup_refuses_grad():
    """K5 has no backward pass, and its plain version stands in for it on
    the CPU: both refuse a tensor that requires grad (a differentiable
    forward calls the gather itself)."""
    lv = [torch.zeros(1, 2, 4, 8)]
    with pytest.raises(RuntimeError, match="no backward"):
        DualPyramid([torch.zeros(1, 2, 4, 8, requires_grad=True)], lv)
    with pytest.raises(RuntimeError, match="no backward"):
        dual_lookup(DualPyramid(lv, lv), torch.zeros(1, 2, 4, requires_grad=True), 4)


def test_update_nets_takes_the_expanded_coords0(rng):
    """With init_disparity_zero the loop starts from coords1 = coords0, an
    expanded view whose x-plane is not contiguous: update_nets gives the
    result of a contiguous copy (on the card K5 reads a contiguous plane)."""
    from stereoanywhere_tpu_torch.models.layers import init_weights
    from stereoanywhere_tpu_torch.models.update import MultiUpdateBlock, update_nets

    b, h, w = 2, 8, 16
    block = MultiUpdateBlock()
    init_weights(block, torch.Generator().manual_seed(0))
    net = [torch.tanh(t(rng.standard_normal((b, 128, h // 2 ** i, w // 2 ** i)))) for i in range(3)]
    inp = [tuple(t(rng.standard_normal((b, 128, h // 2 ** i, w // 2 ** i))) for _ in range(3)) for i in range(3)]
    la, lb = _levels(rng, b, h, w, w)
    pyr = DualPyramid([t(x) for x in la], [t(x) for x in lb])
    coords0 = torch.arange(w, dtype=torch.float32).view(1, 1, 1, w).expand(b, 1, h, w)
    assert not coords0[:, 0].is_contiguous()
    with torch.no_grad():
        want = update_nets(block, net, inp, pyr, coords0.contiguous(), coords0, 4)
        got = update_nets(block, net, inp, pyr, coords0, coords0, 4)
    for g, wnt in zip(got, want):
        assert torch.equal(g, wnt)


# ---------------------------------------------------------------------------
# K7 / K8 / K9 against the JAX step kernels (interpret mode) and references


def _sf_inputs(rng, b=1, h=32, w2=64):
    hcar = rng.standard_normal((b, h, w2, 128)).astype(np.float32)
    coords0 = np.broadcast_to(np.arange(w2, dtype=np.float32)[None, None, :], (b, h, w2))
    coords = (coords0 - np.abs(rng.standard_normal((b, h, w2)) * 5.0)).astype(np.float32)
    la, lb = _levels(rng, b, h, w2, w2)
    return hcar, coords0, coords, la, lb


def _arr(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def test_flow_head_matches_jax(rng):
    from stereoanywhere_tpu.ops.pallas import step_fused as sf

    from stereoanywhere_tpu_torch.ops.cuda.step_fused import flow_head

    h, _, coords, la, lb = _sf_inputs(rng)
    kf1, bf1 = _arr(rng, 3, 3, 128, 256, scale=0.05), _arr(rng, 256, scale=0.1)
    k2, b2 = _arr(rng, 3, 3, 256, 2, scale=0.05), _arr(rng, 2, scale=0.1)
    hw = sf.pack_head_weights(*map(jnp.asarray, (kf1, bf1, k2, b2)), jnp.float32)
    jl, jb = list(map(jnp.asarray, la)), list(map(jnp.asarray, lb))
    cn, cf = sf.fused_step_head(jnp.asarray(h), jnp.asarray(coords), jl, jb, hw, interpret=True)
    cn_r, cf_r = sf.step_head_ref(jnp.asarray(h), jnp.asarray(coords), jl, jb, kf1, bf1, k2, b2)

    pw = P.pack_head_weights(conv_module(kf1, bf1), conv_module(k2, b2), torch.float32)
    got = flow_head(t(h), t(coords), pw)
    close(got.numpy(), cn, 1e-4)
    close(got.numpy(), cn_r, 1e-4)
    # the head's lookup half (K5g), in the TPU kernel's interleaved layout
    ca, cb = dual_lookup(DualPyramid([t(x) for x in la], [t(x) for x in lb]), got, 4)
    inter = np.concatenate([np.concatenate([ca[..., 9 * i: 9 * i + 9], cb[..., 9 * i: 9 * i + 9]], -1)
                            for i in range(4)], -1)
    close(inter, np.asarray(cf)[..., :72], 1e-4)
    close(inter, np.asarray(cf_r)[..., :72], 1e-4)


def _bf16_close(got, want, rel=1e-2):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert np.isfinite(got).all()
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert scale > 0 and err <= rel * scale, (err, scale)


def test_flow_head_matches_jax_bf16(rng):
    """K7 in bf16: fh1 rounded to bf16 as the TPU kernel's slab, the tap
    columns and their sum in f32; the x-delta (coords' - coords) against
    the TPU kernel's.  Then K5's bf16 plain version against the head's
    lookup half (the TPU kernel `step_fused.py:462`), at the TPU kernel's
    new coordinates."""
    from stereoanywhere_tpu.ops.pallas import step_fused as sf

    from stereoanywhere_tpu_torch.ops.cuda.step_fused import flow_head

    h, _, coords, la, lb = _sf_inputs(rng)
    kf1, bf1 = _arr(rng, 3, 3, 128, 256, scale=0.05), _arr(rng, 256, scale=0.1)
    k2, b2 = _arr(rng, 3, 3, 256, 2, scale=0.05), _arr(rng, 2, scale=0.1)
    hw = sf.pack_head_weights(*map(jnp.asarray, (kf1, bf1, k2, b2)), jnp.bfloat16)
    jl, jb = [jnp.asarray(x, jnp.bfloat16) for x in la], [jnp.asarray(x, jnp.bfloat16) for x in lb]
    cn, cf = sf.fused_step_head(jnp.asarray(h, jnp.bfloat16), jnp.asarray(coords), jl, jb, hw, interpret=True)

    pw = P.pack_head_weights(conv_module(kf1, bf1), conv_module(k2, b2), torch.bfloat16)
    got = flow_head(t(h).bfloat16(), t(coords), pw)
    assert got.dtype == torch.float32
    _bf16_close(got.numpy() - coords, np.asarray(cn) - coords)
    ca, cb = dual_lookup(DualPyramid([t(x).bfloat16() for x in la], [t(x).bfloat16() for x in lb]),
                         t(np.asarray(cn)), 4)
    assert ca.dtype == torch.bfloat16
    inter = np.concatenate([np.concatenate([ca[..., 9 * i: 9 * i + 9].float(), cb[..., 9 * i: 9 * i + 9].float()], -1)
                            for i in range(4)], -1)
    _bf16_close(inter, np.asarray(cf.astype(jnp.float32))[..., :72])


@pytest.mark.parametrize("impl", ["mxu", "barrel"])
def test_dual_lookup_matches_jax_bf16(rng, impl):
    """K5 in bf16 against the TPU lookups `corr_mxu.py` and `corr_barrel.py`
    (interpret mode), coordinates inside every level and past both ends."""
    from stereoanywhere_tpu.ops.pallas.corr_barrel import dual_lookup_barrel
    from stereoanywhere_tpu.ops.pallas.corr_mxu import dual_lookup_mxu

    from stereoanywhere_tpu_torch.ops.corr_lookup import lookup_corr_pyramid_pair

    b, h, w2, wl0, r = 1, 8, 16, 32, 4
    la, lb = _levels(rng, b, h, w2, wl0)
    c = _coords_past_both_ends(rng, b, h, w2, wl0)
    fn = dual_lookup_mxu if impl == "mxu" else dual_lookup_barrel
    want = fn(tuple(jnp.asarray(x, jnp.bfloat16) for x in la), tuple(jnp.asarray(x, jnp.bfloat16) for x in lb),
              jnp.asarray(c), r, interpret=True)
    got = lookup_corr_pyramid_pair(DualPyramid([t(x).bfloat16() for x in la], [t(x).bfloat16() for x in lb]), t(c),
                                   r, impl)
    for g, wnt in zip(got, want):
        assert g.dtype == torch.bfloat16
        _bf16_close(g.float().numpy(), wnt.astype(jnp.float32))


@pytest.mark.parametrize("nx", [1, 2], ids=["gru32-nx1", "gru08-gru16-nx2"])
def test_conv_gru_matches_jax_bf16(rng, nx):
    """K9 in bf16: z and r*h rounded to bf16 as the TPU kernel's slabs, h'
    rounded once."""
    from stereoanywhere_tpu.ops.pallas import step_fused as sf

    from stereoanywhere_tpu_torch.models.update import ConvGRU
    from stereoanywhere_tpu_torch.ops.cuda.step_fused import conv_gru

    h = np.tanh(_arr(rng, 1, 32, 64, 128))
    xs = [_arr(rng, 1, 32, 64, 128, scale=0.5) for _ in range(nx)]
    czrq = _arr(rng, 1, 32, 64, 384, scale=0.3)
    cin = 128 * (1 + nx)
    kz, bz = _arr(rng, 3, 3, cin, 128, scale=0.05), _arr(rng, 128, scale=0.1)
    kr, br = _arr(rng, 3, 3, cin, 128, scale=0.05), _arr(rng, 128, scale=0.1)
    kq, bq = _arr(rng, 3, 3, cin, 128, scale=0.05), _arr(rng, 128, scale=0.1)
    gw = sf.pack_gru_weights(*map(jnp.asarray, (kz, bz, kr, br, kq, bq)), jnp.bfloat16)
    bf = lambda a: jnp.asarray(a, jnp.bfloat16)  # noqa: E731
    want = sf.fused_step_gru(bf(h), [bf(x) for x in xs], bf(czrq), gw, interpret=True)

    gru = ConvGRU(128, 128 * nx)
    gru.convz, gru.convr, gru.convq = conv_module(kz, bz), conv_module(kr, br), conv_module(kq, bq)
    got = conv_gru(t(h).bfloat16(), [t(x).bfloat16() for x in xs], t(czrq).bfloat16(),
                   P.pack_gru_weights(gru, torch.bfloat16))
    assert got.dtype == torch.bfloat16
    _bf16_close(got.float().numpy(), want.astype(jnp.float32))


def _motion_weights(rng):
    return dict(
        k1=_arr(rng, 1, 1, 36, 64, scale=0.1), b1=_arr(rng, 64, scale=0.1),
        k2c=_arr(rng, 3, 3, 64, 64, scale=0.05), b2c=_arr(rng, 64, scale=0.1),
        kf1=_arr(rng, 7, 7, 2, 64, scale=0.05), bf1=_arr(rng, 64, scale=0.1),
        kf2=_arr(rng, 3, 3, 64, 64, scale=0.05), bf2=_arr(rng, 64, scale=0.1),
        kmc=_arr(rng, 3, 3, 192, 126, scale=0.05), bmc=_arr(rng, 126, scale=0.1),
    )


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_motion_encoder_matches_jax(rng, dtype):
    """K8.  In bf16, the rounding points the card's kernel keeps (c1/f1 and
    c2/f2 rounded to bf16, flow-x rounded before convf1 and for its lane,
    the output rounded once) against the TPU kernel's, within 1e-2 of
    max |JAX| (`test_torch_kernels.py`'s bf16 tolerance: one bf16 ulp at
    each rounding point, from f32 sums taken in another order)."""
    from stereoanywhere_tpu.ops.pallas import step_fused as sf

    from stereoanywhere_tpu_torch.models.update import MotionEncoder
    from stereoanywhere_tpu_torch.ops.cuda.step_fused import motion_encoder

    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    _, coords0, coords, _, _ = _sf_inputs(rng)
    cf = _arr(rng, 1, 32, 64, 128, scale=0.5)
    cf[..., 72:] = 0.0
    wts = _motion_weights(rng)
    order = ("k1", "b1", "k2c", "b2c", "kf1", "bf1", "kf2", "bf2", "kmc", "bmc")
    mw = sf.pack_motion_weights(*[jnp.asarray(wts[k]) for k in order], 4, 4, jdt)
    flowcols = sf.make_flowcols(jnp.asarray(coords - coords0).astype(jdt))
    want = sf.fused_step_motion(jnp.asarray(cf, jdt), flowcols, mw, interpret=True)

    enc = MotionEncoder(36)
    for name, (k, bk) in {"convc1": ("k1", "b1"), "convc2": ("k2c", "b2c"), "convf1": ("kf1", "bf1"),
                          "convf2": ("kf2", "bf2"), "_conv": ("kmc", "bmc")}.items():
        setattr(enc, name, conv_module(wts[k], wts[bk]))
    ca = np.concatenate([cf[..., 18 * i: 18 * i + 9] for i in range(4)], -1)
    cb = np.concatenate([cf[..., 18 * i + 9: 18 * i + 18] for i in range(4)], -1)
    got = motion_encoder(t(ca).to(tdt), t(cb).to(tdt), t(coords), P.pack_motion_weights(enc, tdt))
    assert got.shape == (1, 32, 64, 128) and got.dtype == tdt
    if dtype == "bfloat16":
        got, want = got.float().numpy(), np.asarray(want.astype(jnp.float32))
        assert np.isfinite(got).all()
        assert np.abs(got - want).max() <= 1e-2 * np.abs(want).max()
        return
    want_r = sf.step_motion_ref(jnp.asarray(cf), jnp.asarray(coords), *[wts[k] for k in order])
    close(got.numpy(), want, 1e-4)
    close(got.numpy(), want_r, 1e-4)


@pytest.mark.parametrize("nx", [1, 2], ids=["gru32-nx1", "gru08-gru16-nx2"])
def test_conv_gru_matches_jax(rng, nx):
    from stereoanywhere_tpu.ops.pallas import step_fused as sf

    from stereoanywhere_tpu_torch.models.update import ConvGRU
    from stereoanywhere_tpu_torch.ops.cuda.step_fused import conv_gru

    h = _arr(rng, 1, 32, 64, 128)
    xs = [_arr(rng, 1, 32, 64, 128) for _ in range(nx)]
    czrq = _arr(rng, 1, 32, 64, 384, scale=0.3)
    cin = 128 * (1 + nx)
    kz, bz = _arr(rng, 3, 3, cin, 128, scale=0.05), _arr(rng, 128, scale=0.1)
    kr, br = _arr(rng, 3, 3, cin, 128, scale=0.05), _arr(rng, 128, scale=0.1)
    kq, bq = _arr(rng, 3, 3, cin, 128, scale=0.05), _arr(rng, 128, scale=0.1)
    gw = sf.pack_gru_weights(*map(jnp.asarray, (kz, bz, kr, br, kq, bq)), jnp.float32)
    want = sf.fused_step_gru(jnp.asarray(h), [jnp.asarray(x) for x in xs], jnp.asarray(czrq), gw, interpret=True)

    gru = ConvGRU(128, 128 * nx)
    gru.convz, gru.convr, gru.convq = conv_module(kz, bz), conv_module(kr, br), conv_module(kq, bq)
    got = conv_gru(t(h), [t(x) for x in xs], t(czrq), P.pack_gru_weights(gru, torch.float32))
    close(got.numpy(), want, 1e-4)
    if nx == 2:  # the JAX reference takes exactly two x streams
        want_r = sf.step_gru_ref(h, xs[0], xs[1], czrq, kz, bz, kr, br, kq, bq)
        close(got.numpy(), want_r, 1e-4)


def test_gru_fused_interface_matches_jax(rng):
    """The K6 interface (one x stream, separate injections, HWIO kernels)."""
    from stereoanywhere_tpu.ops.pallas.gru_fused import gru_fused as jax_gru_fused

    from stereoanywhere_tpu_torch.ops.cuda.step_fused import gru_fused

    b, h, w, ch, cx = 1, 16, 24, 8, 16
    hid, x = _arr(rng, b, h, w, ch), _arr(rng, b, h, w, cx)
    cz, cr, cq = (_arr(rng, b, h, w, ch) for _ in range(3))
    wzr, bzr = _arr(rng, 3, 3, ch + cx, 2 * ch, scale=0.05), _arr(rng, 2 * ch)
    wq, bq = _arr(rng, 3, 3, ch + cx, ch, scale=0.05), _arr(rng, ch)
    args = (hid, x, cz, cr, cq, wzr, bzr, wq, bq)
    want = jax_gru_fused(*map(jnp.asarray, args), interpret=True)
    close(gru_fused(*map(t, args)).numpy(), want, 1e-4)


@pytest.mark.parametrize("shape", [(1, 16, 24, 128), (1, 8, 24, 128), (1, 16, 20, 128), (2, 24, 320, 128),
                                   (1, 16, 24, 64), (1, 12, 16, 128)])
def test_shape_gate_is_the_jax_gate(shape):
    from stereoanywhere_tpu.ops.pallas.step_fused import fused_step_supported

    assert P.fused_step_supported(shape) == fused_step_supported(np.zeros(shape, np.float32))


# ---------------------------------------------------------------------------
# the whole slice


@pytest.fixture(scope="module")
def stereo64():
    """A JAX stereo model's variables at 64x64, its fused_level0="off"
    forward (iters 3) and the inputs."""
    from stereoanywhere_tpu.config import StereoAnywhereConfig as JCfg
    from stereoanywhere_tpu.models import StereoAnywhere as JSA

    rng = np.random.default_rng(7)
    ins = tuple(rng.uniform(0, 1, (1, 64, 64, c)).astype(np.float32) for c in (3, 3, 1, 1))
    model = JSA(JCfg(fused_level0="off"))
    variables = jax.jit(lambda k: model.init(k, *ins, iters=1, test_mode=True))(jax.random.PRNGKey(0))
    variables = jax.tree.map(np.asarray, variables)
    want = jax.jit(lambda v, *a: model.apply(v, *a, iters=3, test_mode=True)["disparity"])(variables, *ins)
    return variables, ins, np.asarray(want)


def _port(variables, **cfg):
    from stereoanywhere_tpu_torch.config import StereoAnywhereConfig
    from stereoanywhere_tpu_torch.models.stereoanywhere import StereoAnywhere

    return from_jax.load_stereo_variables(StereoAnywhere(StereoAnywhereConfig(**cfg), device="cpu"), variables)


def _count_fused_bodies(monkeypatch):
    from stereoanywhere_tpu_torch.models import stereoanywhere as mod

    calls = []
    body = mod.fused_refinement_step
    monkeypatch.setattr(mod, "fused_refinement_step", lambda *a, **k: calls.append(1) or body(*a, **k))
    return calls


def test_fused_forward_matches_jax_unfused(stereo64, monkeypatch):
    """One JAX tree loads into a fused_level0="on" model (the fused path
    shares every parameter with the unfused one), and its rotated schedule
    gives the JAX forward's disparity."""
    variables, ins, want = stereo64
    calls = _count_fused_bodies(monkeypatch)
    got = _port(variables, fused_level0="on")(*map(t, ins), iters=3)["disparity"]
    assert len(calls) == 2  # a pre-step, two rotated bodies, the tail
    close(got.numpy(), want, 1e-4)


@pytest.mark.parametrize("cfg", [dict(fused_level0="on"), dict(lookup_impl="barrel"), dict(lookup_impl="mxu"),
                                 dict(fused_level0="on", lookup_impl="mxu")],
                         ids=["fused", "barrel", "mxu", "fused-mxu"])
def test_port_configurations_agree(stereo64, cfg):
    """The fused loop and the kernel lookups against the port's default
    configuration, same weights."""
    variables, ins, _ = stereo64
    want = _port(variables)(*map(t, ins), iters=3)["disparity"]
    got = _port(variables, **cfg)(*map(t, ins), iters=3)["disparity"]
    close(got.numpy(), want.numpy(), 1e-4)


def test_fused_forward_batch_two():
    """B = 2 through the rotated loop (the NHWC hidden states, the shared
    coordinates and the pyramids carry the batch) against the default loop."""
    from stereoanywhere_tpu_torch.config import StereoAnywhereConfig
    from stereoanywhere_tpu_torch.models.stereoanywhere import StereoAnywhere

    rng = np.random.default_rng(3)
    ins = [t(rng.uniform(0, 1, (2, 64, 64, c))) for c in (3, 3, 1, 1)]
    plain = StereoAnywhere(StereoAnywhereConfig(), device="cpu")
    fused = StereoAnywhere(StereoAnywhereConfig(fused_level0="on"), device="cpu")
    fused.load_state_dict(plain.state_dict())
    want = plain(*ins, iters=3)["disparity"]
    got = fused(*ins, iters=3)["disparity"]
    assert got.shape == (2, 64, 64, 1)
    close(got.numpy(), want.numpy(), 1e-4)
    # the two images differ, and so do their answers
    assert float((want[0] - want[1]).abs().max()) > 1e-2


def test_barrel_turns_the_fused_loop_off(stereo64, monkeypatch):
    """As in the JAX gate: the barrel lookup and the fused loop exclude
    each other."""
    variables, ins, _ = stereo64
    calls = _count_fused_bodies(monkeypatch)
    _port(variables, fused_level0="on", lookup_impl="barrel")(*map(t, ins), iters=2)
    assert calls == []


def test_packed_weights_follow_a_reload(stereo64):
    """The fused loop's packed weights are cached per model and packed
    anew after load_state_dict and load_stereo_variables, into the same
    tensors (a CUDA graph that read them sees the new weights)."""
    from stereoanywhere_tpu_torch.models.update import _leaves

    variables, ins, _ = stereo64
    fused, plain = _port(variables, fused_level0="on"), _port(variables)
    fused(*map(t, ins), iters=2)
    packed = fused.update_block.fused_weights(torch.float32)
    assert fused.update_block.fused_weights(torch.float32) is packed
    for scale, load in ((1.01, from_jax.load_stereo_variables),
                        (1.02, lambda m, v: m.load_state_dict(_port(v).state_dict()))):
        moved = jax.tree.map(lambda a: (a * scale).astype(np.float32), variables)
        load(fused, moved)
        assert fused.update_block.fused_weights(torch.float32) is packed
        fresh = _port(moved, fused_level0="on").update_block.fused_weights(torch.float32)
        assert all(torch.equal(a, b) for a, b in zip(_leaves(packed), _leaves(fresh)))
    from_jax.load_stereo_variables(plain, moved)
    close(fused(*map(t, ins), iters=2)["disparity"].numpy(), plain(*map(t, ins), iters=2)["disparity"].numpy(), 1e-4)


def test_fused_pipeline_serves_a_request(monkeypatch):
    """A fused_level0="on" pipeline on the CPU answers one HTTP request
    through the rotated loop."""
    import threading

    from stereoanywhere_tpu_torch.config import StereoAnywhereConfig
    from stereoanywhere_tpu_torch.serve.client import infer_remote
    from stereoanywhere_tpu_torch.serve.pipeline import build_pipeline, make_http_server

    calls = _count_fused_bodies(monkeypatch)
    pipe = build_pipeline(StereoAnywhereConfig(fused_level0="on"), mono_cfg=None, iters=3, device="cpu")
    server = make_http_server(pipe, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        rng = np.random.default_rng(0)
        im2, im3 = (rng.uniform(0, 1, (60, 70, 3)).astype(np.float32) for _ in range(2))
        disp = infer_remote(f"http://127.0.0.1:{server.server_address[1]}", im2, im3, timeout=120)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    assert disp.shape == (60, 70) and np.isfinite(disp).all()
    assert len(calls) == 2


def test_config_switches():
    from stereoanywhere_tpu_torch.config import StereoAnywhereConfig

    assert StereoAnywhereConfig().resolved_lookup_impl == "window"
    assert StereoAnywhereConfig(lookup_impl="barrel").resolved_lookup_impl == "barrel"
    with pytest.raises(ValueError, match="interpret mode"):
        StereoAnywhereConfig(fused_level0="interpret")
    for bad in (dict(fused_level0="yes"), dict(lookup_impl="tent")):
        with pytest.raises(ValueError):
            StereoAnywhereConfig(**bad)
