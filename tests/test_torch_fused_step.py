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
`tests/test_model_forward.py` hold the JAX package's own kernels.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from stereoanywhere_tpu_torch.compat import from_jax
from stereoanywhere_tpu_torch.ops import step_fused as P

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
    got = lookup_corr_pyramid_pair([t(x) for x in la], [t(x) for x in lb], t(c), r, impl)
    for g, wnt in zip(got, want):
        assert g.shape == (b, h, w2, 4 * (2 * r + 1))
        close(g.numpy(), wnt, 1e-5)
    # the zero padding: a coordinate far outside reads nothing at any level
    assert float(got[0][0, 0, 0].abs().max()) == 0.0 and float(got[1][0, 0, 1].abs().max()) == 0.0


def test_dual_lookup_rejects_unknown_impl():
    from stereoanywhere_tpu_torch.ops.corr_lookup import lookup_corr_pyramid_pair

    with pytest.raises(ValueError, match="unknown lookup impl"):
        lookup_corr_pyramid_pair([torch.zeros(1, 1, 1, 4)], [torch.zeros(1, 1, 1, 4)], torch.zeros(1, 1, 1), 1, "x")


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

    from stereoanywhere_tpu_torch.ops.cuda.corr_lookup import dual_lookup
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
    ca, cb = dual_lookup([t(x) for x in la], [t(x) for x in lb], got, 4)
    inter = np.concatenate([np.concatenate([ca[..., 9 * i: 9 * i + 9], cb[..., 9 * i: 9 * i + 9]], -1)
                            for i in range(4)], -1)
    close(inter, np.asarray(cf)[..., :72], 1e-4)
    close(inter, np.asarray(cf_r)[..., :72], 1e-4)


def _motion_weights(rng):
    return dict(
        k1=_arr(rng, 1, 1, 36, 64, scale=0.1), b1=_arr(rng, 64, scale=0.1),
        k2c=_arr(rng, 3, 3, 64, 64, scale=0.05), b2c=_arr(rng, 64, scale=0.1),
        kf1=_arr(rng, 7, 7, 2, 64, scale=0.05), bf1=_arr(rng, 64, scale=0.1),
        kf2=_arr(rng, 3, 3, 64, 64, scale=0.05), bf2=_arr(rng, 64, scale=0.1),
        kmc=_arr(rng, 3, 3, 192, 126, scale=0.05), bmc=_arr(rng, 126, scale=0.1),
    )


def test_motion_encoder_matches_jax(rng):
    from stereoanywhere_tpu.ops.pallas import step_fused as sf

    from stereoanywhere_tpu_torch.models.update import MotionEncoder
    from stereoanywhere_tpu_torch.ops.cuda.step_fused import motion_encoder

    _, coords0, coords, _, _ = _sf_inputs(rng)
    cf = _arr(rng, 1, 32, 64, 128, scale=0.5)
    cf[..., 72:] = 0.0
    wts = _motion_weights(rng)
    order = ("k1", "b1", "k2c", "b2c", "kf1", "bf1", "kf2", "bf2", "kmc", "bmc")
    mw = sf.pack_motion_weights(*[jnp.asarray(wts[k]) for k in order], 4, 4, jnp.float32)
    flowcols = sf.make_flowcols(jnp.asarray(coords - coords0))
    want = sf.fused_step_motion(jnp.asarray(cf), flowcols, mw, interpret=True)
    want_r = sf.step_motion_ref(jnp.asarray(cf), jnp.asarray(coords), *[wts[k] for k in order])

    enc = MotionEncoder(36)
    for name, (k, bk) in {"convc1": ("k1", "b1"), "convc2": ("k2c", "b2c"), "convf1": ("kf1", "bf1"),
                          "convf2": ("kf2", "bf2"), "_conv": ("kmc", "bmc")}.items():
        setattr(enc, name, conv_module(wts[k], wts[bk]))
    ca = np.concatenate([cf[..., 18 * i: 18 * i + 9] for i in range(4)], -1)
    cb = np.concatenate([cf[..., 18 * i + 9: 18 * i + 18] for i in range(4)], -1)
    got = motion_encoder(t(ca), t(cb), t(coords), P.pack_motion_weights(enc, torch.float32))
    assert got.shape == (1, 32, 64, 128)
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
    anew after load_state_dict and load_stereo_variables."""
    variables, ins, _ = stereo64
    fused, plain = _port(variables, fused_level0="on"), _port(variables)
    fused(*map(t, ins), iters=2)
    packed = fused.update_block.fused_weights(torch.float32)
    assert fused.update_block.fused_weights(torch.float32) is packed
    moved = jax.tree.map(lambda a: (a * 1.01).astype(np.float32), variables)
    for load in (lambda m: from_jax.load_stereo_variables(m, moved),
                 lambda m: m.load_state_dict(_port(moved).state_dict())):
        load(fused)
        assert fused.update_block.fused_weights(torch.float32) is not packed
        packed = fused.update_block.fused_weights(torch.float32)
    from_jax.load_stereo_variables(plain, moved)
    close(fused(*map(t, ins), iters=2)["disparity"].numpy(), plain(*map(t, ins), iters=2)["disparity"].numpy(), 1e-4)


def test_fused_pipeline_serves_a_request(monkeypatch):
    """A fused_level0="on" pipeline on the CPU answers one HTTP request
    through the rotated loop."""
    import threading

    from stereoanywhere_tpu_torch.config import StereoAnywhereConfig
    from stereoanywhere_tpu_torch.serve.pipeline import build_pipeline, infer_remote, make_http_server

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
