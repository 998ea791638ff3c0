"""The hand-written CUDA kernels (K1-K4, and K5, K7, K8, K9 with the K6
interface) against their plain PyTorch versions, and the launch geometry of
the wgmma + TMA bodies (K1-K4, K7, K8, K9), on the card.  Every test
here needs an NVIDIA GPU and skips without one.

This file imports neither JAX nor the test conftest's fixtures, so that it
runs on a machine with the card and no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Shapes are ragged on purpose: token counts, widths and depths that are no
multiple of any tile, so the kernels' edge masks are exercised; the
refinement-step kernels run on a 24 x 40 plane, and again with large values
in the first and last rows and columns of every convolution input (and,
for the lookup, coordinates far outside every level), where only the zero
padding keeps the result right.  Tolerance:
max |kernel - plain| <= tol * max |plain|, tol 1e-5 in f32 (the same f32
arithmetic, sums in another order) and 1e-2 in bf16 (one bf16 rounding of
the output, at most 2^-8 of it, and the bf16 operands of the tensor-core
products).  K5 (the dual lookup) is held to 0 in both dtypes: it computes
each tap with the plain gather's f32 operations in the same order and
rounds to bf16 where the plain version does (the weights f and 1 - f,
each product, the sum), so the two agree bit for bit; so does the small
model whose lookups it serves, against the same model with the plain
lookup.
"""
import numpy as np
import pytest
import torch

from stereoanywhere_tpu_torch.ops import step_fused as port_sf
from stereoanywhere_tpu_torch.ops.cuda import build as port_build
from stereoanywhere_tpu_torch.ops.cuda import corr_lookup as port_lookup
from stereoanywhere_tpu_torch.ops.cuda import step_fused as port_step
from stereoanywhere_tpu_torch.ops.cuda import vit_attention as port_attn
from stereoanywhere_tpu_torch.ops.cuda import vit_dense as port_dense
from stereoanywhere_tpu_torch.ops.cuda import vit_mlp as port_mlp

TOL = {"float32": 1e-5, "bfloat16": 1e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rand(rng, dtype, *shape, scale=1.0, shift=0.0):
    a = (rng.standard_normal(shape) * scale + shift).astype(np.float32)
    return torch.from_numpy(a).cuda().to(getattr(torch, dtype))


def _check(fn, ref, args, dtype, tol=None):
    tol = TOL[dtype] if tol is None else tol
    launches = fn.launches
    got = fn(*args)
    torch.cuda.synchronize()
    assert fn.launches == launches + 1
    want = ref(*args)
    for g, w in zip(*((got, want) if isinstance(got, tuple) else ((got,), (want,)))):
        assert g.shape == w.shape and g.dtype == w.dtype
        err = (g.float() - w.float()).abs().max().item()
        scale = w.float().abs().max().item()
        assert scale > 0 and err <= tol * scale, (fn.__name__, err, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,t,d,f", [(2, 37, 128, 384), (1, 150, 200, 264), (2, 101, 384, 1152), (1, 50, 768, 2304)])
def test_dense_kernels(cuda, dtype, b, t, d, f):
    rng = np.random.default_rng(t)
    x = _rand(rng, dtype, b, t, d)
    g, be = _rand(rng, dtype, d, scale=0.5, shift=1.0), _rand(rng, dtype, d, scale=0.1)
    w, bias = _rand(rng, dtype, f, d, scale=d ** -0.5), _rand(rng, dtype, f, scale=0.1)
    _check(port_dense.ln_dense, port_dense.ln_dense_ref, (x, g, be, w, bias), dtype)
    o, wp = _rand(rng, dtype, b, t, d), _rand(rng, dtype, d, d, scale=d ** -0.5)
    _check(port_dense.dense_scale_residual, port_dense.dense_scale_residual_ref, (x, o, wp, be, g), dtype)
    w2 = _rand(rng, dtype, d, f, scale=f ** -0.5)
    _check(port_mlp.vit_mlp, port_mlp.vit_mlp_ref, (x, g, be, w, bias, w2, be), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,t", [(1, 37), (2, 1370)], ids=["M37", "M2740"])
@pytest.mark.parametrize("d", [384, 768, 1024], ids=["vits", "vitb", "vitl"])
def test_ln_dense_kernel_vit_widths(cuda, dtype, b, t, d):
    """K1 at the shipped ViT widths (the QKV projection, F = 3D) and M = 37,
    2740: no multiple of the 128-row tile."""
    rng = np.random.default_rng(d + t + 1)
    x = _rand(rng, dtype, b, t, d)
    g, be = _rand(rng, dtype, d, scale=0.5, shift=1.0), _rand(rng, dtype, d, scale=0.1)
    w, bias = _rand(rng, dtype, 3 * d, d, scale=d ** -0.5), _rand(rng, dtype, 3 * d, scale=0.1)
    _check(port_dense.ln_dense, port_dense.ln_dense_ref, (x, g, be, w, bias), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,t", [(1, 1370), (2, 1370), (1, 4552), (2, 4552), (1, 129)],
                         ids=["M1370", "M2740", "M4552", "M9104", "M129"])
def test_dense_scale_residual_kernel_vit_l(cuda, dtype, b, t):
    """K3 at ViT-L's width (D 1024) and the token counts of the 512^2 and
    375x1242 requests, B 1 and 2: M is no multiple of the 128-row tile, and
    129 leaves one row in the last; the residual of the rows past M must
    not be read."""
    rng = np.random.default_rng(b * t)
    d = 1024
    x, o = _rand(rng, dtype, b, t, d), _rand(rng, dtype, b, t, d)
    w, bias = _rand(rng, dtype, d, d, scale=d ** -0.5), _rand(rng, dtype, d, scale=0.1)
    gamma = _rand(rng, dtype, d, scale=0.5)
    _check(port_dense.dense_scale_residual, port_dense.dense_scale_residual_ref, (x, o, w, bias, gamma), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,t,heads,hd", [(2, 37, 2, 64), (1, 200, 3, 128), (1, 64, 1, 64), (2, 101, 6, 64),
                                          (1, 50, 12, 64)])
def test_attention_kernel(cuda, dtype, b, t, heads, hd):
    rng = np.random.default_rng(t)
    qkv = _rand(rng, dtype, b, t, 3 * heads * hd, scale=2.0)
    _check(port_attn.vit_attention, port_attn.vit_attention_ref, (qkv, heads), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t,hd", [(37, 64), (101, 64), (200, 128)])
def test_attention_kernel_masks_the_key_tail(cuda, dtype, t, hd):
    # every real key scores about -4 * hd^0.5 against every query, while a
    # zero-filled key past T would score 0: without the tail mask the output
    # would collapse towards 0
    rng = np.random.default_rng(t)
    heads = 2
    d = heads * hd
    shift = np.concatenate([np.full(d, 2.0), np.full(d, -2.0), np.zeros(d)]).astype(np.float32)
    qkv = _rand(rng, dtype, 2, t, 3 * d) + torch.from_numpy(shift).cuda().to(getattr(torch, dtype))
    _check(port_attn.vit_attention, port_attn.vit_attention_ref, (qkv, heads), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t,heads,hd", [(1370, 16, 64), (4552, 16, 64), (5, 16, 64), (300, 8, 128)])
def test_attention_kernel_vit_l_shapes(cuda, dtype, t, heads, hd):
    """ViT-L's token counts at 512^2 and 375x1242 (B = 1, 16 heads of 64),
    T below one 128-row tile, and hd 128 (two 64-column panels a tile)."""
    rng = np.random.default_rng(t)
    qkv = _rand(rng, dtype, 1, t, 3 * heads * hd, scale=2.0)
    _check(port_attn.vit_attention, port_attn.vit_attention_ref, (qkv, heads), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t", [5, 129, 1370])
def test_attention_kernel_masks_the_key_tail_at_vit_l_width(cuda, dtype, t):
    rng = np.random.default_rng(t)
    heads, hd = 16, 64
    d = heads * hd
    shift = np.concatenate([np.full(d, 2.0), np.full(d, -2.0), np.zeros(d)]).astype(np.float32)
    qkv = _rand(rng, dtype, 2, t, 3 * d) + torch.from_numpy(shift).cuda().to(getattr(torch, dtype))
    _check(port_attn.vit_attention, port_attn.vit_attention_ref, (qkv, heads), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,t", [(1, 37), (2, 1370)], ids=["M37", "M2740"])
@pytest.mark.parametrize("d", [384, 768, 1024], ids=["vits", "vitb", "vitl"])
def test_mlp_kernel_vit_widths(cuda, dtype, b, t, d):
    """K4 at the shipped ViT widths (hidden 4D) and M = 37, 2740: no
    multiple of the 128-row tile; D = 384 no multiple of 256."""
    rng = np.random.default_rng(d + t)
    x = _rand(rng, dtype, b, t, d)
    g, be = _rand(rng, dtype, d, scale=0.5, shift=1.0), _rand(rng, dtype, d, scale=0.1)
    w1, b1 = _rand(rng, dtype, 4 * d, d, scale=d ** -0.5), _rand(rng, dtype, 4 * d, scale=0.1)
    w2, b2 = _rand(rng, dtype, d, 4 * d, scale=(4 * d) ** -0.5), _rand(rng, dtype, d, scale=0.1)
    _check(port_mlp.vit_mlp, port_mlp.vit_mlp_ref, (x, g, be, w1, b1, w2, b2), dtype)


@pytest.mark.cuda
def test_wgmma_kernels_launch_geometry(cuda):
    """The bf16 bodies' launches at ViT-L 512^2: the grids the design
    states, and the card keeps them resident."""
    att = port_attn.launch_geometry(2, 1370, 16, 64)
    assert att["grid"] == (11, 16, 2) and att["threads"] == 384 and att["blocks_per_sm"] == 1
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mlp = port_mlp.launch_geometry(2740, 1024, 4096)
    assert mlp["threads"] == 384 and mlp["ln_blocks"] == 2740 // 8 + 1
    for p, n in zip(mlp["products"], (4096, 1024)):
        assert p["bn"] in (256, 208, 176) and p["tiles"] == 22 * -(-n // p["bn"])
        assert p["blocks"] == min(sms, p["tiles"]) and p["smem"] <= 232448
    if sms == 132:  # the H100's count: the second product's 22 x 6 tiles of 176 fill it once
        assert mlp["products"][1]["bn"] == 176 and mlp["products"][1]["tiles"] == 132
    # K1, the QKV projection at 512^2 and 375x1242 (M = 2 x 1370, 2 x 4552)
    for m, row_tiles in ((2740, 22), (9104, 72)):
        k1 = port_dense.launch_geometry(m, 3072)
        assert k1["threads"] == 384 and k1["ln_blocks"] == -(-m // 8) and k1["bn"] in (256, 208, 176)
        assert k1["tiles"] == row_tiles * -(-3072 // k1["bn"]) and k1["blocks"] == min(sms, k1["tiles"])
        assert k1["smem"] <= 232448
    if sms == 132:  # 264 tiles of 256 in two full rounds; 1296 of 176 in 9.8
        assert (port_dense.launch_geometry(2740, 3072)["bn"], port_dense.launch_geometry(9104, 3072)["bn"]) == (256, 176)
    # K3, the projection (N = D = 1024) at both requests: the product of K1 and K4
    for m, row_tiles in ((2740, 22), (9104, 72)):
        k3 = port_dense.residual_geometry(m, 1024)
        assert k3["threads"] == 384 and k3["bn"] in (256, 208, 176) and k3["smem"] <= 232448
        assert k3["tiles"] == row_tiles * -(-1024 // k3["bn"]) and k3["blocks"] == min(sms, k3["tiles"])
    if sms == 132:  # 22 x 6 tiles of 176 fill the card once; 72 x 5 of 208 in 2.7 rounds
        assert [port_dense.residual_geometry(m, 1024)["bn"] for m in (2740, 9104)] == [176, 208]
    # K9 at the three scales of both planes: patches of BM pixels cover the plane
    for h, w in ((128, 128), (64, 64), (32, 32), (96, 320), (48, 160), (24, 80), (13, 6)):
        for g, n in zip(port_step.launch_geometry(1, h, w), (256, 128)):
            assert g["bw"] * g["bh"] == g["bm"] and g["bm"] in (64, 128) and g["bn"] in (64, 128, 256)
            assert g["tiles"] == -(-w // g["bw"]) * -(-h // g["bh"]) * -(-n // g["bn"])
            assert g["blocks"] == min(sms, g["tiles"]) and g["threads"] == 128 * (g["bm"] // 64 + 1)
            assert g["smem"] <= 232448 and g["stages"] >= 2
    assert port_step.launch_geometry(1, 24, 80)[0]["bw"] == 16  # 5 patches a row, none wasted
    # K8's 3x3 stages: the grouped one (N 192 in groups of 64) on tiles whose
    # BN is one group's; the merge conv (N 128)
    for h, w in ((128, 128), (96, 320), (24, 80), (13, 6)):
        c2, mc = port_step.motion_geometry(1, h, w)
        assert c2["bn"] == 64 and mc["bn"] in (64, 128)
        for g, n in ((c2, 192), (mc, 128)):
            assert g["bw"] * g["bh"] == g["bm"] and g["bm"] in (64, 128)
            assert g["tiles"] == -(-w // g["bw"]) * -(-h // g["bh"]) * (n // g["bn"])
            assert g["blocks"] == min(sms, g["tiles"]) and g["threads"] == 128 * (g["bm"] // 64 + 1)
            assert g["smem"] <= 232448 and g["stages"] >= 2
    # K7's conv1 (N 256)
    for h, w in ((128, 128), (96, 320), (24, 80), (13, 6)):
        g = port_step.flow_head_geometry(1, h, w)
        assert g["bw"] * g["bh"] == g["bm"] and g["bm"] in (64, 128) and g["bn"] in (64, 128, 256)
        assert g["tiles"] == -(-w // g["bw"]) * -(-h // g["bh"]) * (256 // g["bn"])
        assert g["blocks"] == min(sms, g["tiles"]) and g["smem"] <= 232448 and g["stages"] >= 2
    if sms == 132:  # all 256 channels of a pixel in one tile at both requests' planes: 1 and 1.8 rounds
        assert [(g["bm"], g["bn"], g["tiles"]) for g in (port_step.flow_head_geometry(1, 128, 128),
                                                         port_step.flow_head_geometry(1, 96, 320))] == [
            (128, 256, 128), (128, 256, 240)]
    if sms == 132:  # 128-pixel patches at both requests' planes
        assert [(g["bm"], g["bn"]) for g in port_step.motion_geometry(1, 128, 128)] == [(128, 64), (128, 128)]
        assert [(g["bm"], g["bn"]) for g in port_step.motion_geometry(1, 96, 320)] == [(128, 64), (128, 128)]
    if sms == 132:  # 64-row tiles on the small planes of the 512^2 request
        assert [(g["bm"], g["bn"]) for g in port_step.launch_geometry(1, 128, 128)] == [(128, 256), (128, 128)]
        assert [(g["bm"], g["bn"]) for g in port_step.launch_geometry(1, 64, 64)] == [(64, 128), (64, 64)]
        assert [(g["bm"], g["bn"]) for g in port_step.launch_geometry(1, 32, 32)] == [(64, 64), (64, 64)]


@pytest.mark.cuda
def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    x = torch.zeros(1, 5, 64, device="cuda", dtype=torch.float16)
    with pytest.raises(TypeError):
        port_attn.vit_attention(torch.zeros(1, 5, 192, device="cuda", dtype=torch.float16), 1)
    w = torch.zeros(64, 64, device="cuda")
    with pytest.raises(TypeError):
        port_dense.dense_scale_residual(x, x, w, w[0], w[0])
    with pytest.raises(ValueError):
        port_attn.vit_attention(torch.zeros(1, 5, 96, device="cuda"), 1)  # hd 32


# ---------------------------------------------------------------------------
# the refinement-step kernels, on a 24 x 40 plane (no multiple of a tile)

H4, W4 = 24, 40


def _border(x, value=30.0):
    """x (B,H,W,C) with its first and last rows and columns set to value.
    The ConvGRU cases take 4: their gates amplify the f32 sums' rounding
    with the value, and 30 put it past the 1e-5 limit."""
    x = x.clone()
    for sl in ((slice(None), 0), (slice(None), -1), (slice(None), slice(None), 0), (slice(None), slice(None), -1)):
        x[sl] = value
    return x


def _coords(rng, b, h, w, spread=2.0):
    """x-coordinates near their own column (flow-x of a few pixels)."""
    c = np.arange(w, dtype=np.float32)[None, None] + rng.standard_normal((b, h, w)).astype(np.float32) * spread
    return torch.from_numpy(c).cuda()


def _packed(module, pack, dtype, seed):
    from stereoanywhere_tpu_torch.models.layers import init_weights

    init_weights(module, torch.Generator().manual_seed(seed))
    return pack(module.cuda(), getattr(torch, dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("far", [False, True], ids=["near", "far-outside"])
@pytest.mark.parametrize("b,h,w", [(1, H4, W4), (2, H4, W4), (1, 7, 320), (1, 3, 33)],
                         ids=["wl40-5", "wl40-5-b2", "wl320-40", "wl33-4-odd"])
def test_dual_lookup_kernel(cuda, dtype, far, b, h, w):
    """Level widths w / 2^l: 40/20/10/5 (bf16 rows of 80, 40, 20 and 10
    bytes: only the first a multiple of 16), the 375x1242 plane's
    320/160/80/40, and 33/16/8/4 with an odd pixel count (the second
    pyramid's output starts mid-chunk in bf16).  Coordinates straddle both
    ends of every level, and far outside it."""
    rng = np.random.default_rng(5)
    wls = [w // 2 ** i for i in range(4)]
    la = [_rand(rng, dtype, b, h, w, wl) for wl in wls]
    lb = [_rand(rng, dtype, b, h, w, wl) for wl in wls]
    c = _coords(rng, b, h, w, spread=30.0 if far else 3.0) - (0.0 if far else 4.0)
    if far:  # every level read past both ends, and far outside
        c[0, 0, :4] = torch.tensor([-1e4, 1e4, -0.5, w - 0.5])
    _check(port_lookup.dual_lookup, port_lookup.dual_lookup_ref, (port_lookup.DualPyramid(la, lb), c, 4), dtype,
           tol=0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("radius", [0, 1, 3, 8])
def test_dual_lookup_kernel_radii(cuda, dtype, radius):
    """Every radius the kernel is built for, coordinates just below an
    integer (where c / 2^l + t rounds up to the next one) among them."""
    rng = np.random.default_rng(radius)
    wls = [W4 // 2 ** i for i in range(4)]
    la, lb = ([_rand(rng, dtype, 1, H4, W4, wl) for wl in wls] for _ in range(2))
    c = _coords(rng, 1, H4, W4, spread=6.0)
    c[0, 1, :8] = torch.from_numpy(np.nextafter(np.arange(8, 16, dtype=np.float32), np.float32(0)) * 8).cuda()
    _check(port_lookup.dual_lookup, port_lookup.dual_lookup_ref, (port_lookup.DualPyramid(la, lb), c, radius),
           dtype, tol=0.0)


@pytest.mark.cuda
def test_dual_lookup_refuses_grad_and_other_inputs(cuda):
    """No backward pass: a level or coordinates that require grad raise,
    as does what the kernel does not take."""
    lv = [torch.zeros(1, 4, 8, 8, device="cuda")]
    c = torch.zeros(1, 4, 8, device="cuda")
    with pytest.raises(RuntimeError, match="no backward"):
        port_lookup.DualPyramid([lv[0].requires_grad_()], lv)
    pyr = port_lookup.DualPyramid([torch.zeros(1, 4, 8, 8, device="cuda")], [torch.zeros(1, 4, 8, 8, device="cuda")])
    with pytest.raises(RuntimeError, match="no backward"):
        port_lookup.dual_lookup(pyr, c.clone().requires_grad_(), 4)
    with pytest.raises(TypeError):  # coords not contiguous
        port_lookup.dual_lookup(pyr, torch.zeros(1, 8, 4, device="cuda").transpose(1, 2), 4)
    with pytest.raises(ValueError):
        port_lookup.dual_lookup(pyr, c, 9)  # radius past the kernel's 8
    with pytest.raises(TypeError):  # a level that is a view at an odd offset
        port_lookup.DualPyramid([torch.zeros(1 * 4 * 8 * 8 + 1, device="cuda")[1:].view(1, 4, 8, 8)],
                                [torch.zeros(1, 4, 8, 8, device="cuda")])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("zero_init", [False, True], ids=["mono-init", "zero-init"])
@pytest.mark.parametrize("fused", ["off", "on"])
def test_model_runs_k5_every_iteration(cuda, monkeypatch, dtype, zero_init, fused):
    """A small stereo model (no mono network; 64x96, so the fused gate
    holds) on the card launches K5 once an iteration, in the default loop
    and in the fused one (its pre-step and rotated bodies), also where
    coords1 is the expanded coords0 view (init_disparity_zero); and gives
    the disparity of the same model whose lookups take the plain gather on
    the card (tolerance 0: see the module's note)."""
    from stereoanywhere_tpu_torch.config import StereoAnywhereConfig
    from stereoanywhere_tpu_torch.models import update as update_mod
    from stereoanywhere_tpu_torch.models.stereoanywhere import StereoAnywhere

    cfg = StereoAnywhereConfig(compute_dtype=dtype, init_disparity_zero=zero_init, fused_level0=fused)
    model = StereoAnywhere(cfg, device="cuda", generator=torch.Generator().manual_seed(8))
    rng = np.random.default_rng(9)
    ins = [torch.from_numpy(rng.uniform(0, 1, (1, 64, 96, ch)).astype(np.float32)).cuda() for ch in (3, 3, 1, 1)]
    iters = 3
    before = port_lookup.dual_lookup.launches
    got = model(*ins, iters=iters)["disparity"]
    torch.cuda.synchronize()
    assert port_lookup.dual_lookup.launches - before == iters
    monkeypatch.setattr(port_lookup, "dual_lookup", port_lookup.dual_lookup_ref)
    monkeypatch.setattr(update_mod, "dual_lookup", port_lookup.dual_lookup_ref)
    want = model(*ins, iters=iters)["disparity"]
    assert got.shape == want.shape == (1, 64, 96, 1) and bool(torch.isfinite(got).all())
    err = (got - want).abs().max().item()
    assert err == 0.0, (err, want.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("border", [False, True], ids=["random", "border"])
def test_flow_head_kernel(cuda, dtype, border):
    from stereoanywhere_tpu_torch.models.update import FlowHead

    rng = np.random.default_rng(7)
    fh = FlowHead(128, 256, 2)
    w = _packed(fh, lambda m, dt: port_sf.pack_head_weights(m.conv1, m.conv2, dt), dtype, 1)
    h = _rand(rng, dtype, 1, H4, W4, 128)
    if border:
        h = _border(h)
    c = torch.from_numpy(rng.standard_normal((1, H4, W4)).astype(np.float32) * 0.1).cuda()
    _check(port_step.flow_head, port_sf.flow_head_ref, (h, c, w), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,hh,ww", [(1, 128, 128), (1, 96, 320), (1, 24, 80), (2, 24, 80), (1, 13, 6)],
                         ids=["512-plane", "kitti-plane", "narrow", "batch-two", "narrower-than-a-patch"])
def test_flow_head_kernel_planes(cuda, dtype, b, hh, ww):
    """K7 at the quarter-resolution planes of the 512^2 and 375x1242
    requests, a narrow one, B = 2 and a plane narrower than a patch, with
    border values: conv1's zero padding, and conv2's, the tap columns of
    pixels outside the plane, keep the answer right."""
    from stereoanywhere_tpu_torch.models.update import FlowHead

    rng = np.random.default_rng(hh * ww + b + 1)
    w = _packed(FlowHead(128, 256, 2), lambda m, dt: port_sf.pack_head_weights(m.conv1, m.conv2, dt), dtype, 5)
    h = _border(_rand(rng, dtype, b, hh, ww, 128))
    c = torch.from_numpy(rng.standard_normal((b, hh, ww)).astype(np.float32) * 0.1).cuda()
    _check(port_step.flow_head, port_sf.flow_head_ref, (h, c, w), dtype)


@pytest.mark.cuda
def test_flow_head_keeps_fh1_out_of_device_memory(cuda):
    """The bf16 body allocates no fh1 (M x 256 bf16, 8.4 MB at the 512^2
    request's plane): what a call allocates is the tap columns' scratch
    (at most 4 sets of 9 f32 a pixel) and the coordinates."""
    from stereoanywhere_tpu_torch.models.update import FlowHead

    rng = np.random.default_rng(13)
    w = _packed(FlowHead(128, 256, 2), lambda m, dt: port_sf.pack_head_weights(m.conv1, m.conv2, dt), "bfloat16", 5)
    h = _rand(rng, "bfloat16", 1, 128, 128, 128)
    c = torch.zeros((1, 128, 128), device="cuda")
    port_step.flow_head(h, c, w)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    port_step.flow_head(h, c, w)
    torch.cuda.synchronize()
    m = 128 * 128
    assert torch.cuda.max_memory_allocated() - base <= 4 * 9 * m * 4 + m * 4 + 4096 < m * 256 * 2


@pytest.mark.cuda
def test_flow_head_forced_tiles_agree(cuda):
    """Every tile K7's bf16 conv1 may take (forced through the library's
    diagnostic entry point, uncounted), on a plane no patch divides: tiles
    narrower than 256 channels write partial tap-column sets that the tap
    sum adds."""
    from stereoanywhere_tpu_torch.models.update import FlowHead

    rng = np.random.default_rng(14)
    b, hh, ww = 2, 20, 36
    w = _packed(FlowHead(128, 256, 2), lambda m, dt: port_sf.pack_head_weights(m.conv1, m.conv2, dt), "bfloat16", 6)
    h = _border(_rand(rng, "bfloat16", b, hh, ww, 128))
    c = torch.from_numpy(rng.standard_normal((b, hh, ww)).astype(np.float32)).cuda()
    want = port_sf.flow_head_ref(h, c, w)
    launches = port_step.flow_head.launches
    for tile in range(1, 6):  # 128x256, 128x128, 64x128, 64x64, 128x64
        got = port_step.flow_head_forced_tile(h, c, w, tile)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        assert err <= 1e-2 * want.abs().max().item(), (tile, err)
    assert port_step.flow_head.launches == launches
    with pytest.raises(ValueError):
        port_step.flow_head_forced_tile(h, c, w, 6)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("border", [False, True], ids=["random", "border"])
def test_motion_encoder_kernel(cuda, dtype, border):
    from stereoanywhere_tpu_torch.models.update import MotionEncoder

    rng = np.random.default_rng(8)
    w = _packed(MotionEncoder(36), port_sf.pack_motion_weights, dtype, 2)
    ca, cb = _rand(rng, dtype, 1, H4, W4, 36), _rand(rng, dtype, 1, H4, W4, 36)
    c = _coords(rng, 1, H4, W4)
    if border:
        ca, cb = _border(ca), _border(cb)
        c[:, [0, -1]] += 25.0
        c[:, :, [0, -1]] -= 25.0
    _check(port_step.motion_encoder, port_sf.motion_encoder_ref, (ca, cb, c, w), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,hh,ww", [(1, 128, 128), (1, 96, 320), (1, 24, 80), (2, 24, 80), (1, 13, 6)],
                         ids=["512-plane", "kitti-plane", "narrow", "batch-two", "narrower-than-a-patch"])
def test_motion_encoder_kernel_planes(cuda, dtype, b, hh, ww):
    """K8 at the quarter-resolution planes of the 512^2 and 375x1242
    requests, a narrow one (24 x 80: 16-wide patches), B = 2 and a plane
    narrower than a patch, with border values in both correlation streams
    and coordinates whose flow-x is large near the plane's edges: the 7x7
    flow conv then reads past them, and flow-x fills its lane."""
    from stereoanywhere_tpu_torch.models.update import MotionEncoder

    rng = np.random.default_rng(hh * ww + b)
    w = _packed(MotionEncoder(36), port_sf.pack_motion_weights, dtype, 5)
    ca, cb = _border(_rand(rng, dtype, b, hh, ww, 36)), _border(_rand(rng, dtype, b, hh, ww, 36))
    c = _coords(rng, b, hh, ww)
    c[:, :3] += 40.0  # the top rows and the right columns look far to the right,
    c[:, :, -3:] -= 40.0  # the right columns far to the left
    _check(port_step.motion_encoder, port_sf.motion_encoder_ref, (ca, cb, c, w), dtype)


@pytest.mark.cuda
def test_motion_encoder_forced_tiles_agree(cuda):
    """Every tile K8's bf16 3x3 stages may take (forced through the
    library's diagnostic entry point) gives the plain version's answer on a
    plane no patch divides; a tile that would straddle two groups of the
    grouped stage is refused."""
    from stereoanywhere_tpu_torch.models.update import MotionEncoder

    rng = np.random.default_rng(12)
    b, hh, ww = 2, 20, 36
    w = _packed(MotionEncoder(36), port_sf.pack_motion_weights, "bfloat16", 6)
    ca, cb = _border(_rand(rng, "bfloat16", b, hh, ww, 36)), _rand(rng, "bfloat16", b, hh, ww, 36)
    c = _coords(rng, b, hh, ww)
    want = port_sf.motion_encoder_ref(ca, cb, c, w)
    fn = port_build.bind("step_fused", "sa_motion_forced_tile", 14, 6)
    a1 = torch.empty((b, hh, ww, 192), device="cuda", dtype=torch.bfloat16)
    a2, out = torch.empty_like(a1), torch.empty((b, hh, ww, 128), device="cuda", dtype=torch.bfloat16)
    ptrs = [t.data_ptr() for t in (ca, cb, c, w.w_c1, w.b_c1, w.w_f1, w.b_f1, w.w_c2f2, w.b_c2f2, w.w_mc, w.b_mc,
                                   a1, a2, out)]
    # candidates 1..5: 128x256, 128x128, 64x128, 64x64, 128x64 (0: picked)
    for tile2, tile3 in ((0, 0), (4, 0), (5, 0), (0, 2), (0, 3), (0, 4), (0, 5), (4, 3)):
        out.zero_()
        assert fn(*ptrs, b, hh, ww, 36, tile2, tile3, port_build.current_stream()) == 0
        torch.cuda.synchronize()
        err = (out.float() - want.float()).abs().max().item()
        assert err <= 1e-2 * want.float().abs().max().item(), (tile2, tile3, err)
    for tile2 in (1, 2, 3):  # BN 256 or 128 across the 64-wide groups
        assert fn(*ptrs, b, hh, ww, 36, tile2, 0, port_build.current_stream()) != 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("nx,scale", [(2, 1), (2, 2), (1, 4)], ids=["gru08", "gru16", "gru32"])
@pytest.mark.parametrize("border", [False, True], ids=["random", "border"])
def test_conv_gru_kernel(cuda, dtype, nx, scale, border):
    from stereoanywhere_tpu_torch.models.update import ConvGRU

    rng = np.random.default_rng(9)
    w = _packed(ConvGRU(128, 128 * nx), port_sf.pack_gru_weights, dtype, 3)
    hh, ww = H4 // scale, W4 // scale
    h = torch.tanh(_rand(rng, dtype, 1, hh, ww, 128))
    xs = [_rand(rng, dtype, 1, hh, ww, 128) for _ in range(nx)]
    if border:
        h, xs = _border(h, 4.0), [_border(x, 4.0) for x in xs]
    czrq = _rand(rng, dtype, 1, hh, ww, 384, scale=0.3)
    _check(port_step.conv_gru, port_sf.conv_gru_ref, (h, xs, czrq, w), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,hh,ww,nx", [(1, 96, 320, 2), (1, 48, 160, 2), (1, 24, 80, 1), (1, 16, 6, 2),
                                        (1, 13, 40, 1), (2, 11, 20, 2)],
                         ids=["kitti-gru08", "kitti-gru16", "kitti-gru32", "narrower-than-a-patch",
                              "H-not-a-patch-multiple", "batch-two"])
def test_conv_gru_kernel_planes(cuda, dtype, b, hh, ww, nx):
    """K9 with border values at the 375x1242 request's three planes (W 320,
    160, 80: 64-, 32- and 16-wide patches), a plane narrower than the
    narrowest patch (8), a height no multiple of the patch's, and B = 2."""
    from stereoanywhere_tpu_torch.models.update import ConvGRU

    rng = np.random.default_rng(hh * ww + b)
    w = _packed(ConvGRU(128, 128 * nx), port_sf.pack_gru_weights, dtype, 4)
    h = _border(torch.tanh(_rand(rng, dtype, b, hh, ww, 128)), 4.0)
    xs = [_border(_rand(rng, dtype, b, hh, ww, 128, scale=0.5), 4.0) for _ in range(nx)]
    czrq = _rand(rng, dtype, b, hh, ww, 384, scale=0.3)
    _check(port_step.conv_gru, port_sf.conv_gru_ref, (h, xs, czrq, w), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("border", [False, True], ids=["random", "border"])
def test_gru_fused_interface(cuda, dtype, border):
    rng = np.random.default_rng(10)
    ch, cx = 128, 96
    h, x = _rand(rng, dtype, 1, H4, W4, ch), _rand(rng, dtype, 1, H4, W4, cx)
    if border:
        h, x = _border(h, 4.0), _border(x, 4.0)
    cz, cr, cq = (_rand(rng, dtype, 1, H4, W4, ch, scale=0.3) for _ in range(3))
    wzr, wq = _rand(rng, dtype, 3, 3, ch + cx, 2 * ch, scale=0.03), _rand(rng, dtype, 3, 3, ch + cx, ch, scale=0.03)
    bzr, bq = _rand(rng, dtype, 2 * ch, scale=0.1), _rand(rng, dtype, ch, scale=0.1)
    _check(port_step.gru_fused, port_step.gru_fused_ref, (h, x, cz, cr, cq, wzr, bzr, wq, bq), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_step_kernels_batch_two(cuda, dtype):
    """B = 2: the kernels' pixel index runs across the batch, and a tap
    must not read the other image's rows."""
    from stereoanywhere_tpu_torch.models.update import ConvGRU, FlowHead, MotionEncoder

    rng = np.random.default_rng(11)
    c = _coords(rng, 2, H4, W4)
    wls = [W4 // 2 ** i for i in range(4)]
    la, lb = ([_rand(rng, dtype, 2, H4, W4, wl) for wl in wls] for _ in range(2))
    _check(port_lookup.dual_lookup, port_lookup.dual_lookup_ref, (port_lookup.DualPyramid(la, lb), c - 3.0, 4),
           dtype, tol=0.0)
    hw = _packed(FlowHead(128, 256, 2), lambda m, dt: port_sf.pack_head_weights(m.conv1, m.conv2, dt), dtype, 1)
    h = _border(_rand(rng, dtype, 2, H4, W4, 128))
    _check(port_step.flow_head, port_sf.flow_head_ref, (h, c - torch.arange(W4, device="cuda"), hw), dtype)
    mw = _packed(MotionEncoder(36), port_sf.pack_motion_weights, dtype, 2)
    ca, cb = _border(_rand(rng, dtype, 2, H4, W4, 36)), _rand(rng, dtype, 2, H4, W4, 36)
    _check(port_step.motion_encoder, port_sf.motion_encoder_ref, (ca, cb, c, mw), dtype)
    gw = _packed(ConvGRU(128, 256), port_sf.pack_gru_weights, dtype, 3)
    hg = _border(torch.tanh(_rand(rng, dtype, 2, H4, W4, 128)), 4.0)
    xs = [_border(_rand(rng, dtype, 2, H4, W4, 128, scale=0.5), 4.0) for _ in range(2)]
    _check(port_step.conv_gru, port_sf.conv_gru_ref, (hg, xs, _rand(rng, dtype, 2, H4, W4, 384, scale=0.3), gw),
           dtype)


@pytest.mark.cuda
def test_step_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    from stereoanywhere_tpu_torch.models.update import ConvGRU

    w = _packed(ConvGRU(128, 128), port_sf.pack_gru_weights, "float32", 3)
    h = torch.zeros(1, 16, 16, 128, device="cuda")
    czrq = torch.zeros(1, 16, 16, 384, device="cuda")
    with pytest.raises(ValueError):  # x channels not a multiple of 32
        port_step.conv_gru(h, [torch.zeros(1, 16, 16, 100, device="cuda")], czrq, w)
    with pytest.raises(TypeError):  # mixed dtypes
        port_step.conv_gru(h.half(), [h], czrq, w)
    with pytest.raises(TypeError):  # levels must be contiguous
        port_lookup.DualPyramid([h[..., :8]], [h[..., :8]])
    pyr = port_lookup.DualPyramid([h[..., :8].contiguous()], [h[..., :8].contiguous()])
    with pytest.raises(TypeError):  # coords must be float32
        port_lookup.dual_lookup(pyr, torch.zeros(1, 16, 16, device="cuda").half(), 4)


# ---------------------------------------------------------------------------
# the serving pipeline's CUDA graphs: DAv2 ViT-S + StereoAnywhere in bf16 at
# 256x128 (quarter-resolution plane 64 x 32, which the fused gate takes), 4
# GRU iterations, with cuDNN's heuristics and with its benchmarked
# algorithms (which it keeps a thread: the eager calls run on the thread of
# the capture).  A replay runs the kernels and cuDNN algorithms of the
# eager call on the same inputs, so the two are held to max |delta| = 0.

GRAPH_HW = (256, 128)


@pytest.fixture(scope="module", params=[("off", False), ("on", False), ("off", True), ("on", True)],
                ids=["default", "fused", "default-benchmark", "fused-benchmark"])
def graphed(request):
    """A pipeline on its graphs, and two requests' images."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs run only on the card")
    from stereoanywhere_tpu_torch.config import MonoConfig, StereoAnywhereConfig
    from stereoanywhere_tpu_torch.serve.pipeline import build_pipeline

    fused, benchmark = request.param
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = benchmark
    pipe = build_pipeline(StereoAnywhereConfig(compute_dtype="bfloat16", fused_level0=fused),
                          MonoConfig.for_encoder("vits"), iters=4, mono_size=(56, 56), device="cuda", seed=5)
    rng = np.random.default_rng(12)
    images = [[rng.uniform(0, 1, (1, *GRAPH_HW, 3)).astype(np.float32) for _ in range(2)] for _ in range(2)]
    yield pipe, images
    torch.backends.cudnn.benchmark = False


def _eager(pipe, *args):
    pipe.graphs = False
    try:
        return pipe(*args)
    finally:
        pipe.graphs = True


def _same(got, want):
    assert got.shape == want.shape == (1, *GRAPH_HW, 1)
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() == 0


@pytest.mark.cuda
def test_graph_replay_equals_eager(graphed):
    pipe, (a, _) = graphed
    assert pipe.graphs
    warm = pipe(*a)  # the warm-up, then the capture
    program = pipe._build(1, *GRAPH_HW)
    assert program.graph is not None and program.held
    _same(warm, _eager(pipe, *a))
    _same(pipe(*a), _eager(pipe, *a))


@pytest.mark.cuda
def test_graph_second_request_equals_eager(graphed):
    pipe, (a, b) = graphed
    pipe(*a)
    _same(pipe(*b), _eager(pipe, *b))


@pytest.mark.cuda
def test_graph_does_not_overwrite_an_earlier_result(graphed):
    pipe, (a, b) = graphed
    first = pipe(*a)
    kept = first.clone()
    second = pipe(*b)
    assert torch.equal(first, kept) and not torch.equal(first, second)


@pytest.mark.cuda
def test_two_stage_graphs_equal_eager_two_stage(graphed):
    from stereoanywhere_tpu_torch.serve.pipeline import StereoAnywherePipeline

    pipe, (a, b) = graphed
    two = StereoAnywherePipeline(pipe.stereo, pipe.mono, pipe.iters, pipe.mono_size, "cuda", two_stage=True)
    two(*a)
    mono, stereo = two._build_two_stage(1, *GRAPH_HW)
    assert mono.graph is not None and stereo.graph is not None and mono.pool == stereo.pool
    _same(two(*b), _eager(two, *b))
    _same(two(*a), _eager(two, *a))


@pytest.mark.cuda
def test_graph_replay_after_a_weight_load_equals_eager(graphed):
    pipe, (a, _) = graphed
    before = pipe(*a)
    g = torch.Generator(device="cuda").manual_seed(3)
    for model in (pipe.stereo, pipe.mono):
        model.load_state_dict({k: v * (1 + 0.05 * torch.randn(v.shape, device="cuda", generator=g)).to(v.dtype)
                               if v.is_floating_point() else v for k, v in model.state_dict().items()})
    got = pipe(*a)
    assert not torch.equal(got, before)
    _same(got, _eager(pipe, *a))


@pytest.mark.cuda
def test_graph_replay_after_the_constants_cache_evicts_equals_eager(graphed):
    """More than 128 other resize sizes evict every constant the graph read,
    after the weight load of the test above: both have happened."""
    from stereoanywhere_tpu_torch import device as port_device
    from stereoanywhere_tpu_torch.ops.interp import resize_jax_image

    pipe, (a, b) = graphed
    pipe(*a)
    x = torch.zeros((1, 1, 4, 4), device="cuda")
    for n in range(5, 5 + 130):
        resize_jax_image(x, (4, n), "bilinear")
    assert port_device._copied.cache_info().currsize == 128
    _same(pipe(*a), _eager(pipe, *a))
    _same(pipe(*b), _eager(pipe, *b))


@pytest.mark.cuda
def test_a_failed_capture_raises(cuda):
    """A body that reads a value back to the host cannot be captured: the
    call raises, and the program keeps no graph and runs nothing eagerly
    in its place."""
    from stereoanywhere_tpu_torch.serve.pipeline import _Program

    program = _Program(lambda x: x * x.sum().item(), torch.cuda.graph_pool_handle())
    x = torch.ones(8, device="cuda")
    try:
        with pytest.raises(RuntimeError):
            program(x)
        assert program.graph is None
    finally:
        torch.cuda.set_stream(torch.cuda.default_stream())
        torch.cuda.synchronize()


@pytest.mark.cuda
def test_a_capture_survives_a_dropped_program_in_cyclic_garbage(cuda):
    """A program that holds a graph and sits in a reference cycle is freed
    only by the cyclic collector; with the collector set to run at every
    allocation, a capture of another program still succeeds (the collector
    is paused there: destroying a graph while a stream captures would
    invalidate the capture) and its replay is its eager result."""
    import gc

    from stereoanywhere_tpu_torch.serve.pipeline import _Program

    pool = torch.cuda.graph_pool_handle()
    x = torch.arange(8.0, device="cuda")
    dropped = _Program(lambda t: t * 2, pool)
    dropped(x)
    assert dropped.graph is not None
    dropped.cycle = dropped
    del dropped
    thresholds = gc.get_threshold()
    gc.set_threshold(1, 1, 1)
    try:
        program = _Program(lambda t: torch.cat([t + i for i in range(64)]), pool)
        first = program(x)
        assert program.graph is not None
        assert torch.equal(program(x), first)
    finally:
        gc.set_threshold(*thresholds)
        gc.collect()


# The evaluator's programs (eval/programs.py) on the card: ViT-S DAv2 and the
# stereo model in bf16, 4 iterations.  A key's first call runs eagerly, its
# second captures and replays; the replays are held to the eager programs'
# answers (graphs=False, the same models) with max |delta| = 0.

@pytest.fixture(scope="module")
def eval_programs():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs run only on the card")
    from stereoanywhere_tpu_torch.config import MonoConfig, StereoAnywhereConfig
    from stereoanywhere_tpu_torch.eval.programs import EvalPrograms
    from stereoanywhere_tpu_torch.models.dpt import DepthAnythingV2
    from stereoanywhere_tpu_torch.models.stereoanywhere import StereoAnywhere

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    stereo = StereoAnywhere(StereoAnywhereConfig(compute_dtype="bfloat16"), device="cuda",
                            generator=torch.Generator().manual_seed(5))
    mono = DepthAnythingV2(MonoConfig.for_encoder("vits"), device="cuda", dtype=torch.bfloat16,
                           generator=torch.Generator().manual_seed(6))
    kw = dict(iters=4, dav2_size=(70, 70), device="cuda")
    return EvalPrograms(stereo, mono, **kw), EvalPrograms(stereo, mono, graphs=False, **kw)


def _eval_inputs(rng, h, w):
    return [rng.uniform(0, 1, (1, h, w, c)).astype(np.float32) for c in (3, 3, 1, 1)]


@pytest.mark.cuda
def test_eval_stereo_program_replays_equal_eager(eval_programs):
    graphed, eager = eval_programs
    rng = np.random.default_rng(20)
    a, b = _eval_inputs(rng, 64, 128), _eval_inputs(rng, 64, 128)
    first = graphed.stereo_fn(*a)
    program = graphed.programs[("stereo", 1, 64, 128, 3)]
    assert program.graph is None  # the first call only warms up
    second = graphed.stereo_fn(*a)  # captures, then replays
    assert program.graph is not None and program.held is not None
    want = eager.stereo_fn(*a)
    assert first.shape == want.shape == (1, 64, 128, 1) and np.isfinite(want).all()
    assert np.abs(second - want).max() == 0 and np.abs(first - want).max() == 0
    assert np.abs(graphed.stereo_fn(*b) - eager.stereo_fn(*b)).max() == 0
    assert graphed.graph_pool_bytes() > 0 and eager.graph_pool_bytes() == 0 and not eager.programs


@pytest.mark.cuda
def test_eval_mono_programs_of_two_shapes_replay_equal_eager(eval_programs):
    graphed, eager = eval_programs
    rng = np.random.default_rng(21)
    for h, w in ((40, 60), (45, 67)):
        x = rng.uniform(0, 1, (2, h, w, 3)).astype(np.float32)
        got = [graphed.mono_fn(x, "middlebury") for _ in range(3)]
        want = eager.mono_fn(x, "middlebury")
        assert want.shape == (2, h, w, 1) and np.isfinite(want).all()
        assert all(np.abs(g - want).max() == 0 for g in got)
        assert graphed.programs[("mono", (70, 70), 2, h, w, 3)].graph is not None


def _eval_samples(rng, sizes):
    out = []
    for h, w in sizes:
        gt = rng.uniform(1, 30, (h, w, 1)).astype(np.float32)
        out.append({"im2": rng.uniform(0, 1, (h, w, 3)).astype(np.float32),
                    "im3": rng.uniform(0, 1, (h, w, 3)).astype(np.float32), "gt": gt,
                    "validgt": np.ones_like(gt), "maskocc": (rng.uniform(size=(h, w, 1)) > 0.8).astype(np.float32)})
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("cap", [3, 1], ids=["buckets", "bucket-grows"])
def test_evaluator_on_the_card_matches_its_eager_run(eval_programs, cap):
    """Two tries of `Evaluator.run` on the graphed programs against two on
    the eager ones: every per-sample metric equal, try by try.  With one
    bucket allowed, the third sample grows it to a shape no sample had (a
    new stereo key), which the second try then runs every sample at."""
    from stereoanywhere_tpu_torch.eval.harness import Evaluator, ShapeBucketer

    graphed, eager = eval_programs
    samples = _eval_samples(np.random.default_rng(22), [(60, 100), (50, 90), (90, 40)])
    runs = {}
    for label, programs in (("graphed", graphed), ("eager", eager)):
        ev = Evaluator(programs.stereo_fn, programs.mono_fn, "middlebury", bucketer=ShapeBucketer(max_buckets=cap))
        runs[label] = [ev.run(samples).per_sample for _ in range(2)]
    assert runs["graphed"] == runs["eager"]
    grown = ("stereo", 1, 96, 128, 3)  # 64x128 and 96x64 joined
    assert (grown in graphed.programs and graphed.programs[grown].graph is not None) == (cap == 1)


# ---------------------------------------------------------------------------
# ViT-G widths: K1-K3 at D 1536, 24 heads of 64


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,t", [(2, 1370), (2, 4552), (1, 129)], ids=["M2740", "M9104", "M129"])
def test_vitg_kernels(cuda, dtype, b, t):
    """K1 (LN + QKV, N 4608, K 1536), K2 (24 heads of 64) and K3 (proj,
    LayerScale and residual, D 1536) at ViT-G's width and the token counts
    of the 512^2 and 375x1242 requests, and one row past a 128-row tile."""
    rng = np.random.default_rng(b * t + 7)
    d, heads = 1536, 24
    x = _rand(rng, dtype, b, t, d)
    g, be = _rand(rng, dtype, d, scale=0.5, shift=1.0), _rand(rng, dtype, d, scale=0.1)
    w, bias = _rand(rng, dtype, 3 * d, d, scale=d ** -0.5), _rand(rng, dtype, 3 * d, scale=0.1)
    _check(port_dense.ln_dense, port_dense.ln_dense_ref, (x, g, be, w, bias), dtype)
    qkv = _rand(rng, dtype, b, t, 3 * d, scale=2.0)
    _check(port_attn.vit_attention, port_attn.vit_attention_ref, (qkv, heads), dtype)
    o, wp = _rand(rng, dtype, b, t, d), _rand(rng, dtype, d, d, scale=d ** -0.5)
    _check(port_dense.dense_scale_residual, port_dense.dense_scale_residual_ref, (x, o, wp, be, g), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vitg_block_matches_the_cpu(cuda, dtype):
    """One ViT-G block (SwiGLU FFN) on the card (K1-K3, the FFN in PyTorch)
    against the same block on the CPU (the plain versions): f32 to 1e-4 of
    the output's scale (TF32 off); bf16 to 2e-2 (bf16 products rounded at
    other points)."""
    from stereoanywhere_tpu_torch.models.dinov2 import Block

    torch.manual_seed(0)
    cpu = Block(1536, 24, ffn_layer="swiglufused").to(getattr(torch, dtype))
    card = Block(1536, 24, ffn_layer="swiglufused").to(getattr(torch, dtype)).cuda()
    card.load_state_dict(cpu.state_dict())
    x = torch.randn(2, 301, 1536).to(getattr(torch, dtype))
    counts = [f.launches for f in (port_dense.ln_dense, port_attn.vit_attention, port_dense.dense_scale_residual,
                                   port_mlp.vit_mlp)]
    with torch.no_grad():
        want, got = cpu(x).float(), card(x.cuda()).float().cpu()
    after = [f.launches for f in (port_dense.ln_dense, port_attn.vit_attention, port_dense.dense_scale_residual,
                                  port_mlp.vit_mlp)]
    assert [a - c for a, c in zip(after, counts)] == [1, 1, 1, 0]
    tol = 1e-4 if dtype == "float32" else 2e-2
    assert (got - want).abs().max().item() <= tol * want.abs().max().item()


# ---------------------------------------------------------------------------
# training on the card


def _train_batch(seed, b=2, h=64, w=128):
    rng = np.random.default_rng(seed)
    f = lambda *s, lo=0.0, hi=1.0: rng.uniform(lo, hi, s).astype(np.float32)  # noqa: E731
    return {"im2_aug": f(b, h, w, 3), "im3_aug": f(b, h, w, 3), "mono2": f(b, h, w, 1), "mono3": f(b, h, w, 1),
            "gt": f(b, h, w, 1, lo=1, hi=10), "validgt": np.ones((b, h, w, 1), np.float32),
            "gt_right": f(b, h, w, 1, lo=1, hi=10), "validgt_right": np.ones((b, h, w, 1), np.float32)}


@pytest.mark.cuda
def test_train_step_matches_the_cpu(cuda):
    """One train step at 64x128, 2 iterations, f32 (TF32 off), corruption
    and gt-as-mono off, from the same weights on the card and on the CPU:
    the loss to 1e-4 relative; each parameter's gradient within 4e-2 of
    its L2 norm and all of them within 5e-3, as `tests/test_torch_train.py`
    holds the CPU against JAX (the gather's backward sums with atomics in
    another order, and a ReLU whose input sits at f32 round-off from zero
    can fall the other way); no kernel wrapper runs in the step."""
    from stereoanywhere_tpu_torch.config import StereoAnywhereConfig, TrainConfig
    from stereoanywhere_tpu_torch.train.trainer import Trainer

    cfg, tc = StereoAnywhereConfig(volume_corruption_prob=0.0), TrainConfig(train_iters=2, gt_mono_prob=0.0)
    cpu, card = Trainer(cfg, tc, 10, device="cpu"), Trainer(cfg, tc, 10, device="cuda")
    card.model.load_state_dict(cpu.model.state_dict())
    wrappers = (port_dense.ln_dense, port_attn.vit_attention, port_dense.dense_scale_residual, port_mlp.vit_mlp,
                port_lookup.dual_lookup, port_step.flow_head, port_step.motion_encoder, port_step.conv_gru)
    before = [f.launches for f in wrappers]
    batch = _train_batch(0)
    want, got = cpu.step(batch), card.step(batch)
    torch.cuda.synchronize()
    assert [f.launches for f in wrappers] == before
    np.testing.assert_allclose(float(got["loss/total"]), float(want["loss/total"]), rtol=1e-4)
    num = den = 0.0
    for (name, p), q in zip(cpu.named_trainable, card.params):
        d, n = (q.grad.cpu() - p.grad).norm().item(), p.grad.norm().item()
        assert d <= 4e-2 * n + 1e-12, name
        num, den = num + d * d, den + n * n
    assert num ** 0.5 <= 5e-3 * den ** 0.5


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pool2x_gradient_on_the_card_matches_the_cpu(cuda, dtype):
    """`ops/interp.py` `pool2x` of a channels-last tensor under autograd:
    the card's gradient is the CPU's (CUDA's own channels-last avg_pool2d
    backward is wrong by the gradient's size), at the loop's 1/4 and 1/16
    planes and a ragged one."""
    from stereoanywhere_tpu_torch.ops.interp import pool2x

    dt = getattr(torch, dtype)
    for shape in [(1, 128, 96, 312), (2, 128, 6, 10), (1, 128, 5, 9)]:
        g = torch.Generator().manual_seed(shape[2])
        x = torch.randn(shape, generator=g).to(dt).contiguous(memory_format=torch.channels_last)
        grad = torch.randn((shape[0], shape[1], (shape[2] + 1) // 2, (shape[3] + 1) // 2), generator=g).to(dt)
        grads = []
        for dev in ("cpu", "cuda"):
            xi = x.to(dev).detach().requires_grad_(True)
            y = pool2x(xi)
            assert y.is_contiguous(memory_format=torch.channels_last)
            y.backward(grad.to(dev).contiguous(memory_format=torch.channels_last))
            grads.append(xi.grad.float().cpu())
        assert (grads[1] - grads[0]).abs().max().item() <= TOL[dtype] * grads[0].abs().max().item(), shape


@pytest.mark.cuda
def test_train_restore_keeps_optimizer_steps_on_the_host(cuda, tmp_path):
    """A restored trainer's AdamW step counts stay on the host, as a fresh
    one's: on the card each would be read back (a sync) twice a parameter
    a step.  Its moments are on the card, and the loss of a step after the
    restore is the saved trainer's (1e-6 relative)."""
    from stereoanywhere_tpu_torch.config import StereoAnywhereConfig, TrainConfig
    from stereoanywhere_tpu_torch.train.trainer import Trainer

    cfg, tc = StereoAnywhereConfig(volume_corruption_prob=0.0), TrainConfig(train_iters=1, gt_mono_prob=0.0)
    a = Trainer(cfg, tc, 10, device="cuda", checkpoint_dir=str(tmp_path))
    a.step(_train_batch(1, b=1, h=32, w=64))
    a.save("latest")
    b = Trainer(cfg, tc, 10, device="cuda", checkpoint_dir=str(tmp_path))
    b.restore("latest")
    for st in b.optimizer.state.values():
        assert not st["step"].is_cuda and st["exp_avg"].is_cuda
    batch = _train_batch(2, b=1, h=32, w=64)
    la, lb = a.step(batch), b.step(batch)
    np.testing.assert_allclose(float(lb["loss/total"]), float(la["loss/total"]), rtol=1e-6)


# ---------------------------------------------------------------------------
# High-resolution inference: row tiles (parallel/tiles.py) and vol_downsample.
# The tile programs on their CUDA graphs against their eager calls (max
# |delta| = 0, as the pipeline's), the tiled path and the vol_downsample
# model on the card against the CPU (f32, TF32 off, 2 iterations: 1e-3 px +
# 5e-5 rel., the pipeline tests' bound), and K5 at a Booster tile's plane
# (136 x 1040: 544 rows of 4160 after the width alignment) bit for bit.

TILES_HW = (256, 128)


def _stereo_inputs(rng, h, w, device="cuda"):
    return [torch.from_numpy(rng.uniform(0, 1, (1, h, w, c)).astype(np.float32)).to(device) for c in (3, 3, 1, 1)]


@pytest.fixture(scope="module", params=[False, True], ids=["batched", "sequential"])
def tiles_graphed(request):
    """2 row tiles of 160 rows (overlap 64) of a bf16 stereo model on their
    graphs, 4 iterations, and two requests' inputs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs run only on the card")
    from stereoanywhere_tpu_torch.config import StereoAnywhereConfig
    from stereoanywhere_tpu_torch.models.stereoanywhere import StereoAnywhere
    from stereoanywhere_tpu_torch.parallel import TileParallelInference

    torch.backends.cudnn.benchmark = False
    model = StereoAnywhere(StereoAnywhereConfig(compute_dtype="bfloat16"), device="cuda",
                           generator=torch.Generator().manual_seed(6))
    tp = TileParallelInference(model, 2, overlap=64, iters=4, sequential=request.param, device="cuda")
    rng = np.random.default_rng(13)
    return tp, [_stereo_inputs(rng, *TILES_HW) for _ in range(2)]


def _tiles_eager(tp, *xs):
    tp.graphs = False
    try:
        return tp.infer(*xs)
    finally:
        tp.graphs = True


@pytest.mark.cuda
def test_tiles_replay_equals_eager(tiles_graphed):
    """The first call warms up and captures, later calls replay: each equals
    the eager call bit for bit, K5 runs 4 times a tile forward eagerly
    (a batched forward takes both tiles) and never in a replay, and the
    first result survives the second request (a fresh accumulator a
    replay)."""
    from stereoanywhere_tpu_torch.parallel.tiles import plan_row_tiles

    tp, (a, b) = tiles_graphed
    assert tp.graphs
    first = tp.infer(*a)
    program = tp._build(plan_row_tiles(TILES_HW[0], 2, 64), TILES_HW[1])
    assert program.graph is not None and tp.graph_pool_bytes() > 0
    kept = first.clone()
    launches = port_lookup.dual_lookup.launches
    want = _tiles_eager(tp, *a)
    assert port_lookup.dual_lookup.launches - launches == 4 * (2 if tp.sequential else 1)
    assert first.shape == want.shape == (1, *TILES_HW, 1) and bool(torch.isfinite(want).all())
    assert (first - want).abs().max().item() == 0
    launches = port_lookup.dual_lookup.launches
    again, second = tp.infer(*a), tp.infer(*b)
    assert port_lookup.dual_lookup.launches == launches
    assert (again - want).abs().max().item() == 0
    assert (second - _tiles_eager(tp, *b)).abs().max().item() == 0
    assert torch.equal(first, kept) and not torch.equal(first, second)


def _card_and_cpu(cfg, seed):
    from stereoanywhere_tpu_torch.models.stereoanywhere import StereoAnywhere

    cpu = StereoAnywhere(cfg, device="cpu", generator=torch.Generator().manual_seed(seed))
    card = StereoAnywhere(cfg, device="cuda")
    card.load_state_dict(cpu.state_dict())
    return card, cpu


def _close_to_cpu(got, want):
    got = got.cpu()
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    excess = ((got - want).abs() - (1e-3 + 5e-5 * want.abs())).max().item()
    assert excess <= 0, ((got - want).abs().max().item(), want.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("sequential", [False, True], ids=["batched", "sequential"])
def test_tiles_card_matches_cpu(cuda, sequential):
    """2 tiles of 96 rows (overlap 32) at (1, 128, 64), f32, on the card
    (eager and on the graph) and on the CPU."""
    from stereoanywhere_tpu_torch.config import StereoAnywhereConfig
    from stereoanywhere_tpu_torch.parallel import TileParallelInference

    card, cpu = _card_and_cpu(StereoAnywhereConfig(), 7)
    xs = _stereo_inputs(np.random.default_rng(14), 128, 64, "cpu")
    want = TileParallelInference(cpu, 2, overlap=32, iters=2, sequential=sequential, device="cpu").infer(*xs)
    tp = TileParallelInference(card, 2, overlap=32, iters=2, sequential=sequential, device="cuda")
    _close_to_cpu(tp.infer(*xs), want)
    _close_to_cpu(tp.infer(*xs), want)  # the replay


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b", [1, 2])
def test_dual_lookup_kernel_booster_tile_plane(cuda, dtype, b):
    """K5 at a Booster tile's quarter-resolution plane, 136 x 1040 (level
    widths 1040 / 520 / 260 / 130), B = 1 (sequential tiles) and 2,
    coordinates spread over the whole row and past both ends: bit for bit
    the plain gather."""
    h4, w4 = 136, 1040
    g = torch.Generator(device="cuda").manual_seed(b)
    dt = getattr(torch, dtype)
    wls = [w4 // 2 ** i for i in range(4)]
    la, lb = ([torch.randn((b, h4, w4, wl), generator=g, device="cuda").to(dt) for wl in wls] for _ in range(2))
    xs = torch.arange(w4, device="cuda", dtype=torch.float32)
    c = xs - torch.rand((b, h4, w4), generator=g, device="cuda") * (w4 / 2) + 8.0
    c[0, 0, :4] = torch.tensor([-1e4, 1e4, -0.5, w4 - 0.5])
    _check(port_lookup.dual_lookup, port_lookup.dual_lookup_ref, (port_lookup.DualPyramid(la, lb), c, 4), dtype,
           tol=0.0)


@pytest.mark.cuda
def test_voldown_card_matches_cpu(cuda):
    """vol_downsample=1 at 64 x 128, f32, card against CPU (the card's
    hourglass on its fused kernels, in full f32 as TF32 is off; the CPU's
    on its modules); and the card's graph of it (a tile program of one
    tile) against its eager call."""
    from stereoanywhere_tpu_torch.config import StereoAnywhereConfig
    from stereoanywhere_tpu_torch.ops.cuda import hourglass3d
    from stereoanywhere_tpu_torch.parallel import TileParallelInference

    card, cpu = _card_and_cpu(StereoAnywhereConfig(vol_downsample=1), 8)
    xs = _stereo_inputs(np.random.default_rng(15), 64, 128, "cpu")
    want = cpu(*xs, iters=2)["disparity"]
    before = hourglass3d.calls()
    got = card(*(x.cuda() for x in xs), iters=2)["disparity"]
    assert hourglass3d.calls()["fused"] == before["fused"] + 1
    _close_to_cpu(got, want)
    tp = TileParallelInference(card, 1, iters=2, device="cuda")
    first, replay = tp.infer(*xs), tp.infer(*xs)
    assert (replay - _tiles_eager(tp, *xs)).abs().max().item() == 0
    _close_to_cpu(first, want)


@pytest.mark.cuda
@pytest.mark.parametrize("fused", ["off", "on"])
def test_stereo_stage_runs_no_layout_transposes(cuda, fused):
    """The stereo stage holds its 2-D activations and weights channels-last,
    so cuDNN's NHWC kernels run its 2-D convolutions with no nchwToNhwc /
    nhwcToNchw transposes around them.  cuDNN still runs one such kernel
    to widen an input of one or two channels for its tensor cores (the
    context encoder's depth map, twice; the flow, once a refinement step):
    those are all that may remain outside the hourglass span (its
    classifiers run cuDNN on NCDHW volumes), where the NCHW stage ran
    hundreds a request.  A bf16 pipeline at 384 x 640,
    with cuDNN's TF32 on as the CLI runs; its graph is warmed (the warm-up,
    the capture and a replay), then one request is traced on the same
    kernels run eagerly, where the stage spans name them (a replay runs no
    Python: its kernels fall under `sa.replay`; the graph tests above hold
    a replay to its eager call bit for bit)."""
    import re

    from torch.profiler import ProfilerActivity, profile

    from stereoanywhere_tpu_torch.config import MonoConfig, StereoAnywhereConfig
    from stereoanywhere_tpu_torch.serve.pipeline import build_pipeline
    from stereoanywhere_tpu_torch.utils.profiling import device_by_span

    iters = 4
    torch.backends.cudnn.allow_tf32 = True
    try:
        pipe = build_pipeline(StereoAnywhereConfig(compute_dtype="bfloat16", fused_level0=fused),
                              MonoConfig.for_encoder("vits"), iters=iters, mono_size=(56, 56), device="cuda", seed=5)
        rng = np.random.default_rng(19)
        views = [rng.uniform(0, 1, (1, 384, 640, 3)).astype(np.float32) for _ in range(2)]
        pipe(*views)
        pipe(*views)
        pipe.graphs = False
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            pipe(*views).cpu()
            torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.allow_tf32 = False
    stereo = {k: v for k, v in device_by_span(prof.events()).items() if k.startswith("sa.stereo.")}
    assert {"sa.stereo.context", "sa.stereo.features", "sa.stereo.hourglass", "sa.stereo.loop"} <= set(stereo)
    assert all(stereo[k] for k in ("sa.stereo.context", "sa.stereo.hourglass", "sa.stereo.loop"))
    found = {k: sum(1 for name, _, _ in v if re.search(r"nchwToNhwc|nhwcToNchw", name)) for k, v in stereo.items()}
    allowed = {"sa.stereo.context": 2, "sa.stereo.loop": iters}
    assert all(n <= allowed.get(k, 0) for k, n in found.items() if k != "sa.stereo.hourglass"), found
