"""The 3-D hourglass's fused kernels (`ops/cuda/hourglass3d.py`,
`csrc/hourglass3d.cu`) and the choice of path in `Hourglass.forward`.

On the CPU (tier 1): importing the module needs no card; the CPU, a call
under autograd and a call inside a row group take the plain path (read
from `hourglass3d.calls()` and `plain_reason`; the row-group call itself
runs in `tests/test_torch_rowshard.py`'s ranks); what the kernels cannot
take is refused, not rerouted; the wrappers' refusals; and
`hourglass3d.forward` on each launch's plain version (`*_ref`) against the
modules, in a bf16 and an f32 model at B = 1 and 2 and with gates the
modules resize, within 1e-5 of the output's largest value (the same f32
arithmetic; the sums of the instance norms taken over NDHWC in another
order, the upsampled segment's product taken before its resize, a resized
gate's axes in another order).

On the card (skipped without one; this file imports no JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_hourglass3d.py

- each kernel against its plain version: a 3x3x3 launch in TF32 within one
  bf16 unit (2^-8 of the plain output's largest value: TF32 operands,
  2^-11 each) in f32, two in bf16 (the two stores may round a value of the
  top binade apart by one bf16 ulp, up to two units); in full f32 (TF32
  off) within 1e-5 of it; its sums within 1e-5 of the sums of its own
  stored output; the 1x1x1 and finalize launches (full f32) within 1e-5;
- the fused hourglass against the modules on the card at the KITTI
  (8x320x96x320) and OAK-D (8x160x104x160) volumes, a small volume odd at
  every stride-2 level, and an f32 input as a stacked hourglass sees it, in
  bf16 and f32 models at B = 1 and 2.  With TF32 (cuDNN too, as the port
  runs), or in a bf16 model: within `HOURGLASS_UNITS` bf16 units of the
  output's largest value, and a mean gap under a twentieth of a unit (both
  sides multiply in TF32, in other orders and tiles, through twelve
  convolutions and their norms: measured at most 0.21 units, mean 0.006, on
  an NVIDIA H100).  Without TF32 in an f32 model (both in full f32): within
  `PRECISE_REL` of it;
- gates the modules resize (depth features on a grid other than the
  volume's), fused against the modules, as above;
- a replayed CUDA graph of the fused hourglass equals its eager call bit
  for bit (the sums' order is fixed);
- the whole `StereoAnywhere` forward with `sa_vitl_agg`'s stereo settings
  (bf16, stereo-volume aggregation, one stacked hourglass a volume), fused
  against the modules, 2 iterations: the coarse disparities and the
  disparity within `FORWARD_UNITS` bf16 units of their largest value.
"""
import numpy as np
import pytest
import torch

from stereoanywhere_tpu_torch.models.hourglass import Hourglass
from stereoanywhere_tpu_torch.models.layers import init_weights
from stereoanywhere_tpu_torch.ops.cuda import hourglass3d as hg3
from stereoanywhere_tpu_torch.parallel import halo

BF16_UNIT = 2.0 ** -8
HOURGLASS_UNITS = 1.0
PRECISE_REL = 1e-4
FORWARD_UNITS = 4.0


def _hourglass(dtype=torch.float32, device="cpu", seed=0) -> Hourglass:
    hg = init_weights(Hourglass(8, 8), torch.Generator().manual_seed(seed)).eval()
    return hg.to(device=device, dtype=dtype)


def _level_dims(dims, floor=False):
    """The volume's dims at each level (the stride-2 convolutions round up),
    or with `floor` the depth features' grid as the model builds it from a
    size that is not a multiple of 8 (halved, rounded down)."""
    out = [tuple(dims)]
    for _ in range(3):
        out.append(tuple(s // 2 if floor else (s - 1) // 2 + 1 for s in out[-1]))
    return out


def _inputs(b, dims, dtype=torch.float32, device="cpu", seed=0, resized=False):
    """A volume (B, 8, W3, H, W2) and the four levels' depth features; with
    `resized` the features' grid differs from the volume's at the levels
    where halving rounds, so the modules resize those gates."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(b, 8, *dims, generator=g).to(device=device, dtype=dtype)
    levels = _level_dims(dims, floor=resized)
    fl = [torch.rand(b, 1, d[1], d[2], generator=g).to(device) for d in levels]
    fr = [torch.rand(b, 1, d[1], d[0], generator=g).to(device) for d in levels]
    return x, fl, fr


def _calls_during(fn):
    before = hg3.calls()
    fn()
    after = hg3.calls()
    return {k: after[k] - before[k] for k in after}


# ---------------------------------------------------------------------------
# the CPU


def test_importing_the_module_needs_no_card():
    calls = hg3.calls()
    assert set(calls) == {"fused", "plain"} and all(isinstance(v, int) for v in calls.values())
    assert isinstance(hg3.launches(), int)
    with pytest.raises(ValueError, match="conv3_ref"):  # the wrappers take card tensors only
        hg3.conv3(hg3.Vol(torch.zeros(1, 4, 4, 4, 8)), torch.zeros(8, 8, 3, 3, 3), 1, hg3.scratch(torch.zeros(1), 8))


class _FakeGroup:
    class plan:  # noqa: N801 - what halo.row_group reads
        n = 2


def _run(case, hg, x, fl, fr):
    """The hourglass called as `case` says; returns plain_reason at the call."""
    seen = {}

    def call():
        seen["reason"] = hg3.plain_reason(hg, x, fl, fr)
        if case == "row group":  # the modules' row-aware ops need real ranks: tests/test_torch_rowshard.py
            assert hg3.serve(hg, x, fl, fr) is None
        else:
            hg(x, fl, fr)

    if case == "autograd":
        with torch.enable_grad():
            call()
    elif case == "row group":
        with torch.no_grad(), halo.row_group(_FakeGroup()):
            call()
    else:
        with torch.no_grad():
            call()
    return seen["reason"]


@pytest.mark.parametrize("case,reason", [("device", "cpu"), ("autograd", "autograd"), ("row group", "row group")])
def test_the_cpu_autograd_and_a_row_group_take_the_plain_path(case, reason):
    hg = _hourglass()
    x, fl, fr = _inputs(1, (16, 8, 16))
    box = []
    calls = _calls_during(lambda: box.append(_run(case, hg, x, fl, fr)))
    assert box == [reason]
    assert calls == {"fused": 0, "plain": 1}


@pytest.mark.parametrize("case", ["dtype", "features", "widths", "rows"])
def test_the_card_refuses_what_the_kernels_cannot_take(case):
    """`serve` raises on a card call the kernels cannot take (here through
    `check_takes`, which looks at no device) rather than run the modules."""
    hg = _hourglass()
    x, fl, fr = _inputs(1, (16, 8, 16))
    hg3.check_takes(hg, x, fl, fr)
    hg3.check_takes(hg, x, fl[:2] + [torch.rand(1, 1, 3, 4)] + fl[3:], fr[:2] + [torch.rand(1, 1, 3, 5)] + fr[3:])
    if case == "dtype":
        x = x.double()
    elif case == "features":
        fl = [f.bfloat16() for f in fl]
    elif case == "widths":
        hg = init_weights(Hourglass(8, 4), torch.Generator().manual_seed(0)).eval()
    else:
        fl[2] = torch.rand(1, 1, 3, 4)
    with pytest.raises(ValueError, match="hourglass3d"):
        hg3.check_takes(hg, x, fl, fr)


@pytest.mark.parametrize("bad", ["strided volume", "f64 weight", "bf16 sums", "bf16 gate", "three gate factors"])
def test_the_wrappers_refuse_what_the_kernels_do_not_take(bad):
    raw, w = torch.zeros(1, 4, 4, 4, 8), torch.zeros(8, 8, 3, 3, 3)
    v = hg3.Vol(raw, torch.zeros(1, 2, 8), (torch.zeros(1, 4, 4, 8), torch.zeros(1, 4, 4, 8)))
    hg3._check("ok", v, w)
    if bad == "strided volume":
        v.x = torch.zeros(1, 4, 4, 8, 4).transpose(3, 4)
    elif bad == "f64 weight":
        w = w.double()
    elif bad == "bf16 sums":
        v.stats = v.stats.bfloat16()
    elif bad == "bf16 gate":
        v.gate = (v.gate[0].bfloat16(), v.gate[1])
    else:
        v.gate = (*v.gate, v.gate[0])
    with pytest.raises(ValueError):
        hg3._check(bad, v, w)


@pytest.fixture
def plain_launches(monkeypatch):
    """`hourglass3d.forward` with each launch's plain version in its place."""
    monkeypatch.setattr(hg3, "conv3", lambda v, w, stride, buf, precise: hg3.conv3_ref(v, w, stride))
    monkeypatch.setattr(hg3, "conv1", lambda d, col, up, w, buf: hg3.conv1_ref(d, col, up, w))
    monkeypatch.setattr(hg3, "upsampled_share", hg3.upsampled_share_ref)
    monkeypatch.setattr(hg3, "finalize", hg3.finalize_ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("b,dims,resized", [(1, (24, 16, 24), False), (2, (21, 13, 19), False),
                                            (1, (23, 15, 17), True)], ids=["b1", "b2_odd", "b1_resized"])
def test_fused_forward_on_the_plain_versions_matches_the_modules(plain_launches, dtype, b, dims, resized):
    hg = _hourglass(dtype)
    x, fl, fr = _inputs(b, dims, dtype, resized=resized)
    if resized:  # the features' grid is the volume's at level 0 only: the gates read at levels 0-2 are resized
        assert all(f.shape[-2:] != d[1:] for f, d in zip(fl[1:], _level_dims(dims)[1:]))
    with torch.no_grad():
        want = hg.forward_modules(x, fl, fr)
        got = hg3.forward(hg, x, fl, fr)
    assert got.dtype == want.dtype == torch.float32 and got.shape == want.shape == (b, 8, *dims)
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


def test_a_resized_gate_is_the_modules_gate():
    """`_gate`'s factors (two rank-1 terms along H) give what
    `DoubleFeatureAtt` gives a volume of ones, growing and shrinking."""
    hg = _hourglass()
    att = hg.feature_atts[1]
    g = torch.Generator().manual_seed(3)
    for feat_hw, dims in (((5, 7), (6, 9, 11)), ((9, 12), (10, 4, 7)), ((1, 1), (3, 2, 2))):
        fl = torch.rand(2, 1, *feat_hw, generator=g)
        fr = torch.rand(2, 1, feat_hw[0], 8, generator=g)
        with torch.no_grad():
            want = att(torch.ones(2, 32, *dims), fl, fr)
            factors = hg3._gate(att, fl, fr, dims)
        assert len(factors) == 4 and factors[0].shape == (2, dims[1], dims[2], 32)
        got = hg3.values(hg3.Vol(torch.ones(2, 32, *dims), gate=factors, ncdhw=True))
        assert (got - want).abs().max() <= 1e-6


# ---------------------------------------------------------------------------
# the card


@pytest.fixture(params=[True, False], ids=["tf32", "f32"])
def cuda(request):
    """The card, with cuDNN's TF32 as the port runs (the default) or off."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = request.param
    yield torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = True


def _rand_vol(g, b, dims, c, dtype, stats=True, gate=2, device="cuda"):
    """A raw NDHWC volume with sums of its own values and a gate of `gate`
    factors."""
    raw = (torch.randn(b, *dims, c, generator=g) * 2 + 0.5).to(dtype)
    v = hg3.Vol(raw)
    if stats:
        v.stats = hg3.sums(raw)
    if gate:
        d, h, w = dims
        v.gate = tuple(torch.rand(b, h, n, c, generator=g) for _ in range(gate // 2) for n in (w, d))
    return v, _to(v, device)


def _to(v, device):
    return hg3.Vol(v.x.to(device), None if v.stats is None else v.stats.to(device),
                   None if v.gate is None else tuple(t.to(device) for t in v.gate), v.ncdhw)


def _units(got, want):
    return float((got.float().cpu() - want.float()).abs().max() / (BF16_UNIT * want.float().abs().max()))


CONV3_CASES = [  # (cin, cout, stride, input as the hourglass's NCDHW input, bf16 raw, gate factors)
    (8, 16, 2, True, True, 0), (8, 16, 2, True, False, 0),
    (16, 16, 1, False, True, 0), (16, 16, 1, False, False, 0),
    (16, 32, 2, False, True, 2), (16, 32, 2, False, False, 2), (16, 32, 2, False, False, 4),
    (32, 32, 1, False, False, 0), (32, 48, 2, False, False, 2),
    (48, 48, 1, False, False, 0), (8, 8, 1, False, False, 0),
]


@pytest.mark.cuda
@pytest.mark.parametrize("cin,cout,stride,ncdhw,bf16,gate", CONV3_CASES)
def test_conv3_kernel_matches_its_plain_version(cuda, cin, cout, stride, ncdhw, bf16, gate):
    g = torch.Generator().manual_seed(cin * 100 + cout + stride + gate)
    dt = torch.bfloat16 if bf16 else torch.float32
    dims = (13, 10, 21)
    if ncdhw:
        x = torch.randn(2, cin, *dims, generator=g).to(dt)
        cpu, dev = hg3.Vol(x, ncdhw=True), hg3.Vol(x.to(cuda), ncdhw=True)
    else:
        cpu, dev = _rand_vol(g, 2, dims, cin, dt, gate=gate)
    w = (torch.randn(cout, cin, 3, 3, 3, generator=g) / (27 * cin) ** 0.5).to(dt)
    precise = not torch.backends.cudnn.allow_tf32
    want = hg3.conv3_ref(cpu, w, stride)
    got = hg3.conv3(dev, w.to(cuda), stride, hg3.scratch(dev.x, 48), precise)
    torch.cuda.synchronize()
    assert got.x.dtype == want.x.dtype == cpu.dtype and got.x.shape == want.x.shape
    if bf16 and not gate:  # a bf16 store: two units, with TF32 or not (bf16 operands are exact in TF32)
        assert _units(got.x, want.x) <= 2.0
    else:
        assert _units(got.x, want.x) <= (1e-5 / BF16_UNIT if precise else 1.0)
    own = hg3.sums(got.x.cpu()).double()
    scale = hg3.sums(got.x.cpu().abs()).double()
    assert ((got.stats.cpu().double() - own).abs() <= 1e-5 * scale + 1e-30).all()


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["agg", "final", "agg_resized_gates"])
def test_conv1_and_finalize_kernels_match_their_plain_versions(cuda, case):
    g = torch.Generator().manual_seed(7)
    dims = (23, 14, 27)
    low_dims = tuple((s - 1) // 2 + 1 for s in dims)
    low_c, cd, cout = (16, 8, 8) if case == "final" else (32, 16, 16)
    factors = 4 if case == "agg_resized_gates" else 2
    low_cpu, low_dev = _rand_vol(g, 2, low_dims, low_c, torch.float32, gate=factors)
    if case == "final":  # [the hourglass's bf16 input as it is, upsampled]
        x = torch.randn(2, cd, *dims, generator=g).to(torch.bfloat16)
        direct_cpu, direct_dev = hg3.Vol(x, ncdhw=True), hg3.Vol(x.to(cuda), ncdhw=True)
        up_col, col = cd, 0
    else:  # [upsampled, raw bf16 skip with its norm and gate]
        direct_cpu, direct_dev = _rand_vol(g, 2, dims, cd, torch.bfloat16, gate=factors)
        up_col, col = 0, low_c
    w = (torch.randn(cout, cd + low_c, 1, 1, 1, generator=g) / 5).to(torch.bfloat16)
    up_cpu = hg3.upsampled_share_ref(low_cpu, w, up_col)
    up_dev = hg3.upsampled_share(low_dev, w.to(cuda), up_col)
    assert _units(up_dev, up_cpu) <= 1e-5 / BF16_UNIT
    want = hg3.conv1_ref(direct_cpu, col, up_cpu, w)
    got = hg3.conv1(direct_dev, col, up_dev, w.to(cuda), hg3.scratch(up_dev, 48))
    torch.cuda.synchronize()
    assert got.x.shape == want.x.shape == (2, *dims, cout)
    assert _units(got.x, want.x) <= 1e-5 / BF16_UNIT
    assert ((got.stats.cpu() - want.stats).abs() <= 1e-5 * hg3.sums(want.x.abs())).all()
    gate = tuple(torch.rand(2, dims[1], n, cout, generator=g) for _ in range(factors // 2) for n in (dims[2], dims[0]))
    want.gate, got.gate = gate, tuple(t.to(cuda) for t in gate)
    assert _units(hg3.finalize(got), hg3.finalize_ref(want)) <= 1e-5 / BF16_UNIT


VOLUMES = {"kitti": (320, 96, 320), "oakd": (160, 104, 160), "odd": (45, 27, 53)}


def _held_to_the_modules(got, want, bf16_model):
    """In bf16 units where either side runs in TF32 or stores bf16 (the first
    blocks of a bf16 model: the two stores may round a value apart by an
    ulp), else (full f32 on both sides) within PRECISE_REL."""
    gap = (got - want).abs()
    if torch.backends.cudnn.allow_tf32 or bf16_model:
        unit = BF16_UNIT * want.abs().max()
        assert gap.max() <= HOURGLASS_UNITS * unit, float(gap.max() / unit)
        assert gap.mean() <= 0.05 * unit, float(gap.mean() / unit)
    else:
        assert gap.max() <= PRECISE_REL * want.abs().max(), float(gap.max() / want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16_model", "f32_model"])
@pytest.mark.parametrize("volume,b,resized", [("kitti", 1, False), ("oakd", 1, False), ("odd", 1, False),
                                              ("odd", 2, False), ("kitti", 2, False), ("odd", 1, True)],
                         ids=["kitti-1", "oakd-1", "odd-1", "odd-2", "kitti-2", "odd_resized-1"])
def test_fused_hourglass_matches_the_modules(cuda, dtype, volume, b, resized):
    hg = _hourglass(dtype, cuda)
    x, fl, fr = _inputs(b, VOLUMES[volume], dtype, cuda, resized=resized)
    with torch.no_grad():
        want = hg.forward_modules(x, fl, fr)
        box = []
        calls = _calls_during(lambda: box.append(hg(x, fl, fr)))
        got = box[0]
        stacked = hg(got, fl, fr)  # an f32 input, as a stacked hourglass sees it
        stacked_want = hg.forward_modules(got, fl, fr)
    torch.cuda.synchronize()
    assert calls == {"fused": 1, "plain": 0}
    assert got.dtype == want.dtype == torch.float32 and got.shape == want.shape and got.is_contiguous()
    _held_to_the_modules(got, want, dtype == torch.bfloat16)
    _held_to_the_modules(stacked, stacked_want, False)


@pytest.mark.cuda
def test_fused_hourglass_replays_its_eager_call_bit_for_bit(cuda):
    hg = _hourglass(torch.bfloat16, cuda)
    x, fl, fr = _inputs(1, VOLUMES["odd"], torch.bfloat16, cuda)
    with torch.no_grad():
        eager = hg(x, fl, fr)
        again = hg(x, fl, fr)
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            hg(x, fl, fr)  # warm-up on the side stream
        torch.cuda.current_stream().wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            captured = hg(x, fl, fr)
        graph.replay()
        graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(eager, again) and torch.equal(eager, captured)


@pytest.mark.cuda
def test_the_aggregation_variant_forward_fused_matches_the_modules(cuda, monkeypatch):
    from stereoanywhere_tpu_torch.config import StereoAnywhereConfig
    from stereoanywhere_tpu_torch.models.stereoanywhere import StereoAnywhere

    cfg = StereoAnywhereConfig(compute_dtype="bfloat16", use_aggregate_stereo_vol=True, n_additional_hourglass=2)
    model = StereoAnywhere(cfg, device="cuda", generator=torch.Generator().manual_seed(3))
    rng = np.random.default_rng(4)
    h, w = 192, 384
    ims = [torch.from_numpy(rng.uniform(0, 1, (1, h, w, c)).astype(np.float32)).cuda() for c in (3, 3, 1, 1)]
    fused = {}
    calls = _calls_during(lambda: fused.update(model(*ims, iters=2)))
    assert calls == {"fused": 4, "plain": 0}
    monkeypatch.setattr(hg3, "serve", lambda *a: None)
    plain = model(*ims, iters=2)
    torch.cuda.synchronize()
    for key in ("coarse_dispstereo2", "coarse_dispmono2", "coarse_dispmono3", "disparity"):
        a, b = fused[key].float(), plain[key].float()
        units = float((a - b).abs().max() / (BF16_UNIT * b.abs().max()))
        print(f"{key}: fused against the modules, {units:.4f} bf16 units")
        assert units <= FORWARD_UNITS, key
