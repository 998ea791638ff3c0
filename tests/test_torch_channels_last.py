"""The stereo stage in channels-last memory (`models/stereoanywhere.py`,
`models/layers.py` `channels_last_weights`), on the CPU, where a model
holds it once `channels_last_weights` has made its 2-D convolution weights
channels-last, as a model built on the card has them (a model built for
the CPU keeps them contiguous, and the CPU tests of the port against the
JAX package run that): a tiny `StereoAnywhere` test-mode forward with
every `F.conv2d` / `F.conv3d` call recorded under a `TorchFunctionMode`:
its operands' memory formats and the innermost `sa.stereo.*` span open at
it.  Every 2-D convolution of more than one input channel outside the
hourglass gets channels-last operands; the hourglass's convolutions and
the classifiers get NCHW / NCDHW ones, as at the card.  The forward's NHWC
outputs keep their shapes and dtypes, and a caller's strides do not move
the answer by a bit.  The channels-last forward is held to the NCHW one
of the same weights, and its train-mode gradient too, as the port is held
to the JAX package (`test_torch_variants.py`), whose tests hold the NCHW
model; on the card, `tests/test_torch_cuda.py` checks that no layout
transpose runs in the stage outside the hourglass."""
from contextlib import contextmanager

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

from stereoanywhere_tpu_torch.config import StereoAnywhereConfig
from stereoanywhere_tpu_torch.models import stereoanywhere as port_model
from stereoanywhere_tpu_torch.models.layers import channels_last_weights
from stereoanywhere_tpu_torch.models.stereoanywhere import StereoAnywhere

torch.set_num_threads(2)

CL = {4: torch.channels_last, 5: torch.channels_last_3d}
CASES = {  # name: (config, H, W)
    "default": (StereoAnywhereConfig(), 32, 64),
    "aggregate_stereo": (StereoAnywhereConfig(use_aggregate_stereo_vol=True), 32, 64),
    "fused": (StereoAnywhereConfig(fused_level0="on"), 64, 64),
}


def _inputs(h: int, w: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    im2, im3 = (torch.from_numpy(rng.uniform(0, 1, (1, h, w, 3)).astype(np.float32)) for _ in range(2))
    mde2, mde3 = (torch.from_numpy(rng.uniform(0, 1, (1, h, w, 1)).astype(np.float32)) for _ in range(2))
    return im2, im3, mde2, mde3


def _model(cfg: StereoAnywhereConfig, channels_last: bool = True) -> StereoAnywhere:
    model = StereoAnywhere(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
    return channels_last_weights(model) if channels_last else model


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    cfg, h, w = CASES[request.param]
    return request.param, _model(cfg), _inputs(h, w)


class _Convs(TorchFunctionMode):
    """Records (dim, span, input channels, output channels, input in the
    channels-last format, weight in it, input contiguous, weight
    contiguous) of every `F.conv2d` / `F.conv3d` call."""

    def __init__(self, spans):
        super().__init__()
        self.spans, self.calls = spans, []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func in (F.conv2d, F.conv3d):
            x, weight = args[0], args[1]
            fmt = CL[weight.ndim]
            self.calls.append((weight.ndim - 2, self.spans[-1] if self.spans else "", x.shape[1], weight.shape[0],
                               x.is_contiguous(memory_format=fmt), weight.is_contiguous(memory_format=fmt),
                               x.is_contiguous(), weight.is_contiguous()))
        return func(*args, **(kwargs or {}))


def _recorded(monkeypatch, model, inputs):
    """The forward's output, and its convolutions as `_Convs` records them."""
    spans = []

    @contextmanager
    def span(name, args=None):
        spans.append(name)
        try:
            yield
        finally:
            spans.pop()

    monkeypatch.setattr(port_model, "span", span)
    with _Convs(spans) as convs:
        out = model(*inputs, iters=2)
    return out, convs.calls


def test_the_weights_are_channels_last(case):
    """Every 2-D convolution weight outside the hourglasses channels-last;
    the hourglasses' and every 3-D one (the classifiers') contiguous."""
    _, model, _ = case
    nchw = {id(m) for name, h in model.named_modules() if name.startswith("hourglass_") for m in h.modules()}
    convs = [m for m in model.modules() if isinstance(m, (torch.nn.Conv2d, torch.nn.Conv3d))]
    assert convs and nchw
    for m in convs:
        w = m.weight
        fmt = torch.channels_last if isinstance(m, torch.nn.Conv2d) and id(m) not in nchw else torch.contiguous_format
        assert w.stride() == torch.empty_like(w, memory_format=fmt).stride(), (m, w.stride())


def test_every_convolution_gets_channels_last_operands(case, monkeypatch):
    name, model, inputs = case
    _, calls = _recorded(monkeypatch, model, inputs)
    spans = {s for _, s, *_ in calls}
    assert {"sa.stereo.context", "sa.stereo.features", "sa.stereo.hourglass", "sa.stereo.loop"} <= spans
    assert ("sa.stereo.aggregate" in spans) == (name == "aggregate_stereo")
    assert all(s.startswith("sa.stereo.") for s in spans), spans
    volume = ("sa.stereo.hourglass", "sa.stereo.aggregate")
    two_d = [c for c in calls if c[0] == 2 and c[1] not in volume]
    in_volume = [c for c in calls if c[1] in volume]
    assert two_d and in_volume and all(c[0] == 2 for c in calls if c[1] not in volume)
    assert {c[0] for c in in_volume} == {2, 3} and len([c for c in in_volume if c[3] == 1]) == (
        3 if name == "aggregate_stereo" else 2)
    assert all(c[5] for c in two_d), [c for c in two_d if not c[5]]
    assert all(c[4] for c in two_d if c[2] > 1), [c for c in two_d if c[2] > 1 and not c[4]]
    # the hourglass and the classifiers: the operands of an NCHW model
    cfg, h, w = CASES[name]
    _, nchw_calls = _recorded(monkeypatch, _model(cfg, channels_last=False), inputs)
    assert in_volume == [c for c in nchw_calls if c[1] in volume]
    assert all(c[7] for c in in_volume)


def test_outputs_keep_their_nhwc_shapes_and_dtypes(case):
    name, model, inputs = case
    _, h, w = CASES[name]
    out = model(*inputs, iters=2)
    assert out["disparity"].shape == (1, h, w, 1) and out["disparity"].dtype == torch.float32
    for key in ("coarse_dispmono2", "coarse_dispmono3", "coarse_scaled_mde2", "coarse_conf2"):
        assert out[key].shape == (1, h, w, 1) and out[key].dtype == torch.float32, key
    assert out["scale"].shape == out["shift"].shape == (1, 1, 1, 1)
    assert torch.isfinite(out["disparity"]).all()


def test_the_callers_strides_do_not_move_the_answer(case):
    name, model, inputs = case
    want = model(*inputs, iters=2)["disparity"]
    # each view (B,H,W,C) over memory in another order: channels first, and
    # rows and columns swapped
    channels_first = [t.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1) for t in inputs]
    transposed = [t.transpose(1, 2).contiguous().transpose(1, 2) for t in inputs]
    for views in (channels_first, transposed):
        assert any(not t.is_contiguous() for t in views)
        got = model(*views, iters=2)["disparity"]
        assert torch.equal(got, want), name


def test_a_cpu_model_holds_nchw_by_default(monkeypatch):
    """Built for the CPU, the model keeps every weight contiguous and hands
    every convolution a contiguous weight; `channels_last_weights` makes it
    channels-last."""
    cfg, h, w = CASES["default"]
    model = _model(cfg, channels_last=False)
    assert model.memory_format == torch.contiguous_format
    assert _model(cfg).memory_format == torch.channels_last
    convs = [m for m in model.modules() if isinstance(m, (torch.nn.Conv2d, torch.nn.Conv3d))]
    assert convs and all(m.weight.is_contiguous() for m in convs)
    _, calls = _recorded(monkeypatch, model, _inputs(h, w))
    assert calls and all(c[7] for c in calls)


@pytest.mark.parametrize("name", list(CASES))
def test_channels_last_forward_matches_nchw(name):
    """The same weights held channels-last and NCHW give the same test-mode
    outputs up to rounding: each output within 2e-4 of its largest
    magnitude (the two read at most 1.8e-5 apart in the disparity, 6.9e-5
    in the scale, over six input seeds; a layout fault moves a map by its
    own size)."""
    cfg, h, w = CASES[name]
    inputs = _inputs(h, w, seed=1)
    with torch.inference_mode():
        want = _model(cfg, channels_last=False)(*inputs, iters=3)
        got = _model(cfg)(*inputs, iters=3)
    for key in ("disparity", "coarse_dispmono2", "coarse_dispmono3", "coarse_scaled_mde2", "coarse_conf2", "scale",
                "shift"):
        assert got[key].shape == want[key].shape, key
        gap = float((got[key] - want[key]).abs().max())
        assert gap <= 2e-4 * float(want[key].abs().max()), (key, gap)


@pytest.mark.parametrize("name", ["default", "aggregate_stereo"])
def test_channels_last_gradient_matches_nchw(name):
    """A train-mode forward's loss and its gradient, channels-last against
    NCHW: the gradient to 5e-3 norm-wise, the bound the port's train step
    meets against the JAX package's.  The lookups' interpolation makes the
    gradient piecewise, so rounding moves it more than the forward."""
    cfg, h, w = CASES[name]
    inputs = _inputs(h, w, seed=2)
    losses, grads = [], []
    for channels_last in (False, True):
        model = _model(cfg, channels_last).train()
        out = model(*inputs, iters=2, test_mode=False, generator=torch.Generator().manual_seed(1))
        loss = out["disparities"].abs().mean() + out["coarse_dispmono2"].abs().mean()
        loss.backward()
        losses.append(float(loss.detach()))
        grads.append(torch.cat([p.grad.reshape(-1) for p in model.parameters() if p.grad is not None]))
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-5)
    assert grads[0].shape == grads[1].shape and grads[0].norm() > 0
    assert (grads[1] - grads[0]).norm() <= 5e-3 * grads[0].norm()
