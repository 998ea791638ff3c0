"""The hand-written CUDA kernels (K1-K4, and K5, K7, K8, K9 with the K6
interface) against their plain PyTorch versions, on the card.  Every test
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
products).
"""
import numpy as np
import pytest
import torch

from stereoanywhere_tpu_torch.ops import step_fused as port_sf
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


def _check(fn, ref, args, dtype):
    launches = fn.launches
    got = fn(*args)
    torch.cuda.synchronize()
    assert fn.launches == launches + 1
    want = ref(*args)
    for g, w in zip(*((got, want) if isinstance(got, tuple) else ((got,), (want,)))):
        assert g.shape == w.shape and g.dtype == w.dtype
        err = (g.float() - w.float()).abs().max().item()
        scale = w.float().abs().max().item()
        assert scale > 0 and err <= TOL[dtype] * scale, (fn.__name__, err, scale)


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
def test_dual_lookup_kernel(cuda, dtype, far):
    rng = np.random.default_rng(5)
    wls = [W4 // 2 ** i for i in range(4)]  # 40, 20, 10, 5
    la = [_rand(rng, dtype, 1, H4, W4, wl) for wl in wls]
    lb = [_rand(rng, dtype, 1, H4, W4, wl) for wl in wls]
    c = _coords(rng, 1, H4, W4, spread=30.0 if far else 3.0) - (0.0 if far else 4.0)
    if far:  # every level read past both ends, and far outside
        c[0, 0, :4] = torch.tensor([-1e4, 1e4, -0.5, W4 - 0.5])
    _check(port_lookup.dual_lookup, port_lookup.dual_lookup_ref, (la, lb, c, 4), dtype)


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
    _check(port_lookup.dual_lookup, port_lookup.dual_lookup_ref, (la, lb, c - 3.0, 4), dtype)
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
    with pytest.raises(TypeError):  # coords must be float32
        port_lookup.dual_lookup([h[..., :8]], [h[..., :8]], torch.zeros(1, 16, 16, device="cuda").half(), 4)
