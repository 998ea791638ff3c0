"""What the pipeline's CUDA graphs rest on, checked on the CPU: a forward
copies nothing from the host once a shape has been seen (a capture cannot
take such a copy), `_build` keeps one program a (batch, height, width) as
the JAX pipeline's `_build` keeps one a shape, a load of weights keeps
what a graph reads valid (parameters and the fused loop's packed weights
are filled in place), a program holds the device constants it read when
their cache evicts them, and graphs are refused on the CPU.  The graphs
themselves run only on the card (`tests/test_torch_cuda.py`)."""
import numpy as np
import pytest
import torch

from stereoanywhere_tpu_torch import device as port_device
from stereoanywhere_tpu_torch.config import MonoConfig, StereoAnywhereConfig
from stereoanywhere_tpu_torch.models import dinov2, dpt
from stereoanywhere_tpu_torch.models.stereoanywhere import StereoAnywhere
from stereoanywhere_tpu_torch.serve.pipeline import StereoAnywherePipeline, build_pipeline

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def pipes():
    kw = dict(mono_cfg=MonoConfig.for_encoder("vits"), iters=1, mono_size=(56, 56), device="cpu")
    return build_pipeline(**kw), build_pipeline(mono_cfg=None, iters=1, device="cpu")


@pytest.fixture
def host_copies(monkeypatch):
    """Counts the calls that copy host data into a tensor: torch.tensor,
    torch.from_numpy, and Tensor.to given a device."""
    count = {"n": 0}

    def counted(fn, is_copy=lambda *a, **k: True):
        def wrapper(*a, **k):
            count["n"] += bool(is_copy(*a, **k))
            return fn(*a, **k)
        return wrapper

    monkeypatch.setattr(torch, "tensor", counted(torch.tensor))
    monkeypatch.setattr(torch, "from_numpy", counted(torch.from_numpy))
    monkeypatch.setattr(torch.Tensor, "to", counted(
        torch.Tensor.to, lambda self, *a, **k: "device" in k or any(isinstance(x, (str, torch.device)) for x in a)))
    port_device._copied.cache_clear()
    return count


def test_imagenet_normalize_copies_from_the_host_once(host_copies):
    x = torch.rand(2, 14, 28, 3)
    got = dpt.imagenet_normalize(x)
    assert host_copies["n"] > 0
    host_copies["n"] = 0
    assert torch.equal(dpt.imagenet_normalize(x), got)
    assert host_copies["n"] == 0
    want = (x - torch.tensor(dpt.IMAGENET_MEAN)) / torch.tensor(dpt.IMAGENET_STD)
    assert torch.equal(got, want)


def test_interpolate_pos_embed_copies_from_the_host_once(host_copies):
    pos = torch.randn(1, 1 + 37 * 37, 16)
    got = dinov2.interpolate_pos_embed(pos, 23, 41)
    assert host_copies["n"] > 0
    host_copies["n"] = 0
    assert torch.equal(dinov2.interpolate_pos_embed(pos, 23, 41), got)
    assert host_copies["n"] == 0
    assert got.shape == (1, 1 + 23 * 41, 16)


def test_the_models_copy_from_the_host_once_a_shape(pipes, host_copies):
    """DAv2 and the stereo model, second call at a shape: no host copy."""
    pipe, _ = pipes
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.uniform(0, 1, (2, 56, 84, 3)).astype(np.float32))
    views = [torch.from_numpy(rng.uniform(0, 1, (1, 32, 64, c)).astype(np.float32)) for c in (3, 3, 1, 1)]

    def forward():
        with torch.inference_mode():
            return pipe.mono(x), pipe.stereo(*views, iters=1)["disparity"]

    first = forward()
    assert host_copies["n"] > 0
    host_copies["n"] = 0
    second = forward()
    assert host_copies["n"] == 0
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_build_keeps_one_program_a_shape(pipes):
    """Like the JAX pipeline's `_cache`: the same program for the same key,
    a new one for another batch or shape, and two-stage programs apart from
    the one-graph program of the same shape."""
    pipe, _ = pipes
    one = pipe._build(1, 64, 96)
    assert pipe._build(1, 64, 96) is one
    assert pipe._build(2, 64, 96) is not one and pipe._build(1, 64, 128) is not one
    mono, stereo = pipe._build_two_stage(1, 64, 96)
    assert pipe._build_two_stage(1, 64, 96) == (mono, stereo)
    assert one not in (mono, stereo) and mono is not stereo
    assert pipe._build_two_stage(1, 32, 96)[0] is not mono
    assert all(p.graph is None for p in (one, mono, stereo))  # nothing is captured on the CPU


def test_calls_go_through_the_programs(pipes):
    _, stereo_only = pipes
    stereo_only._cache.clear()
    rng = np.random.default_rng(1)
    im2, im3 = (rng.uniform(0, 1, (1, 32, 64, 3)).astype(np.float32) for _ in range(2))
    ran = []
    body = stereo_only._build(1, 32, 64).body
    stereo_only._build(1, 32, 64).body = lambda *a: ran.append(len(a)) or body(*a)
    out = stereo_only(im2, im3)
    assert ran == [4] and out.shape == (1, 32, 64, 1)  # the views and the zero depth pair
    stereo_only(im2[:, :, :32], im3[:, :, :32])
    assert sorted(stereo_only._cache) == [(1, 32, 32), (1, 32, 64)]


def test_graphs_are_refused_on_the_cpu(pipes):
    pipe, _ = pipes
    assert pipe.graphs is False
    with pytest.raises(ValueError, match="CUDA graphs"):
        pipe.graphs = True
    assert pipe.graphs is False
    with pytest.raises(ValueError, match="CUDA graphs"):
        StereoAnywherePipeline(pipe.stereo, device="cpu", graphs=True)


def _packed_fused(model, dtype=torch.float32):
    from stereoanywhere_tpu_torch.models.update import _leaves

    return _leaves(model.update_block.fused_weights(dtype))


def _fresh_pack(model, dtype=torch.float32):
    from stereoanywhere_tpu_torch.models.update import _leaves

    return _leaves(model.update_block._pack(dtype))


@pytest.mark.parametrize("how", ["load_state_dict", "from_jax"])
def test_a_weight_load_repacks_the_fused_weights_in_place(how):
    """The packed tensors a graph read stay the same tensors and hold the
    new weights; they were packed inside inference mode, as a served
    forward packs them."""
    model = StereoAnywhere(StereoAnywhereConfig(), device="cpu", generator=torch.Generator().manual_seed(0))
    other = StereoAnywhere(StereoAnywhereConfig(), device="cpu", generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        before = _packed_fused(model)
    ptrs = [t.data_ptr() for t in before]
    if how == "load_state_dict":
        model.load_state_dict(other.state_dict())
    else:
        from stereoanywhere_tpu.compat.torch_convert import convert_stereo_checkpoint

        from stereoanywhere_tpu_torch.compat.from_jax import load_stereo_variables

        load_stereo_variables(model, convert_stereo_checkpoint(
            {k: v.detach().numpy() for k, v in other.state_dict().items()}))
    after = _packed_fused(model)
    assert [t.data_ptr() for t in after] == ptrs and all(a is b for a, b in zip(after, before))
    for got, want in zip(after, _fresh_pack(other)):
        assert torch.equal(got, want)


def test_a_program_holds_the_constants_it_read():
    """Evicted from the constants' cache (more than 128 other constants),
    a constant that a program read while it was captured stays alive and
    unchanged; a later call builds a new copy."""
    port_device._copied.cache_clear()
    x = torch.rand(1, 3, 20, 30)
    with port_device.holding_constants() as held:
        from stereoanywhere_tpu_torch.ops.interp import resize_jax_image

        resize_jax_image(x, (11, 17), "cubic")
    assert len(held) == 2
    snapshot = [t.clone() for t in held]
    for n in range(130):
        port_device.device_constant(np.eye, (n + 2,), torch.device("cpu"), torch.float32)
    with port_device.holding_constants() as again:
        resize_jax_image(x, (11, 17), "cubic")
    assert all(a is not b for a, b in zip(again, held))  # evicted, copied anew
    for h, s, a in zip(held, snapshot, again):
        assert torch.equal(h, s) and torch.equal(h, a)


def test_held_constants_and_a_weight_load_together():
    """Both at once: a forward's constants held, the cache filled past its
    size, the weights loaded anew.  The held constants keep their values,
    the packed weights their tensors, which now hold the new weights, and
    the forward at the new weights equals a fresh model's."""
    cfg = StereoAnywhereConfig(fused_level0="on")
    model = StereoAnywhere(cfg, device="cpu", generator=torch.Generator().manual_seed(2))
    other = StereoAnywhere(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
    pipe = StereoAnywherePipeline(model, device="cpu", iters=2)
    rng = np.random.default_rng(2)
    im2, im3 = (rng.uniform(0, 1, (1, 64, 128, 3)).astype(np.float32) for _ in range(2))
    port_device._copied.cache_clear()
    with port_device.holding_constants() as held:
        pipe(im2, im3)
    assert held
    snapshot = [t.clone() for t in held]
    packed = _packed_fused(model)
    for n in range(130):
        port_device.device_constant(np.eye, (n + 2,), torch.device("cpu"), torch.float32)
    model.load_state_dict(other.state_dict())
    assert all(torch.equal(h, s) for h, s in zip(held, snapshot))
    assert all(a is b for a, b in zip(_packed_fused(model), packed))
    want = StereoAnywherePipeline(other, device="cpu", iters=2)(im2, im3)
    assert torch.equal(pipe(im2, im3), want)


def test_a_failed_capture_raises_and_runs_nothing_in_its_place(monkeypatch):
    """`_Program`'s first call runs its body (the warm-up), then captures;
    a capture that fails raises, keeps no graph and computes nothing more
    eagerly; a later call tries the warm-up and the capture again.  (The
    capture is a stand-in here: CUDA graphs exist only on the card.)"""
    from contextlib import contextmanager

    from stereoanywhere_tpu_torch.serve.pipeline import _Program

    calls = []

    @contextmanager
    def failing_capture(graph, pool=None):
        yield
        raise RuntimeError("operation not permitted when stream is capturing")

    monkeypatch.setattr(torch.cuda, "CUDAGraph", lambda: object())
    monkeypatch.setattr(torch.cuda, "graph", failing_capture)
    program = _Program(lambda x: calls.append("body") or x + 1, pool=None)
    for _ in range(2):
        with pytest.raises(RuntimeError, match="capturing"):
            program(torch.zeros(3))
        assert program.graph is None
    assert calls == ["body", "body"] * 2  # each try: the warm-up and the captured call, nothing more


@pytest.mark.parametrize("fails", [False, True], ids=["captured", "failed"])
def test_a_capture_runs_with_the_cyclic_collector_paused(monkeypatch, fails):
    """No cyclic collection runs inside a capture (it could destroy a
    dropped program's graph there, which invalidates the capture); the
    collector is on again after it, whether the capture succeeded or not.
    (The capture is a stand-in here, as above.)"""
    import gc
    from contextlib import contextmanager

    from stereoanywhere_tpu_torch.serve.pipeline import _Program

    seen = []

    @contextmanager
    def capture(graph, pool=None):
        seen.append(gc.isenabled())
        yield
        seen.append(gc.isenabled())
        if fails:
            raise RuntimeError("operation not permitted when stream is capturing")

    monkeypatch.setattr(torch.cuda, "CUDAGraph", lambda: object())
    monkeypatch.setattr(torch.cuda, "graph", capture)
    assert gc.isenabled()
    program = _Program(lambda x: x + 1, pool=None)
    if fails:
        with pytest.raises(RuntimeError, match="capturing"):
            program(torch.zeros(3))
    else:  # the capture alone: a replay needs a real graph
        program._capture((torch.zeros(3),))
    assert seen == [False, False] and gc.isenabled()
