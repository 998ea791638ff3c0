"""The frozen reference against the port's plain path on the CPU: same
weights (`port_bench/weights.py`), ViT-S, f32, a few iterations, a size
the CPU holds; and the two hold the same parameters, so that one draw
fills both alike."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from port_bench import harness, traffic
from port_bench.reference.dav2 import Block as RefBlock
from port_bench.weights import draw_into, spec
from stereoanywhere_tpu_torch.models.dinov2 import Block as PortBlock

CFG = {
    "name": "sa_vits_f32",
    "stereo": {"corr_radius": 4, "corr_levels": 4, "n_gru_layers": 3, "n_downsample": 2,
               "context_dims": [128, 128, 128], "fnet_dim": 256, "volume_channels": 8, "vol_n_masks": 8,
               "compute_dtype": "float32", "fused_level0": "off"},
    "mono": {"encoder": "vits", "embed_dim": 384, "depth": 12, "num_heads": 6, "ffn": "mlp", "mlp_hidden": 1536,
             "features": 64, "out_channels": [48, 96, 192, 384], "input_size": 140},
    "iters": 3,
    "graphs": False,
    "weights": {"dtype": "float32", "layer_scale": 1.0,
                "stereo_scales": {"update_block.flow_head.conv2.weight": 0.3}},
}
MIX = {"name": "cpu", "height": 96, "width": 320, "pool_pairs": 1, "loop": "closed", "clients": 1, "batch": 1,
       "min_shift": 8, "max_shift": 32, "check_pairs": 1, "trace_pairs": 1, "eager_trace_pairs": 1, "why": "test"}
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def pair():
    seed = 2 ** 31 + 77
    program = harness.build_program(CFG, CPU, seed)
    reference = harness.build_reference(CFG, CPU, seed)
    return program, reference, traffic.make_pool(MIX, seed, CPU)[0]


def test_same_parameters(pair):
    program, reference, _ = pair
    for port_model, ref_model in ((program.stereo, reference.stereo), (program.mono, reference.mono)):
        assert [s[:2] for s in spec(port_model, 1.0, {})] == [s[:2] for s in spec(ref_model, 1.0, {})]
        port_params = dict(port_model.named_parameters())
        for name, p in ref_model.named_parameters():
            assert torch.equal(port_params[name], p), name


def test_mono_stage(pair):
    program, reference, (left, right) = pair
    got = program.mono_stage(left, right)
    want = reference.mono_stage(*(torch.from_numpy(v) for v in (left, right)))
    for g, w in zip(got, want):
        w = w.permute(0, 2, 3, 1)
        # f32 sums in another order through 12 blocks and the head
        assert (g - w).abs().max() <= 1e-4 * w.abs().max()


def test_pipeline(pair):
    program, reference, (left, right) = pair
    got = program(left, right).numpy()
    want = reference(*(torch.from_numpy(v) for v in (left, right))).numpy()
    # f32 round-off through three refinement steps: the two agree to about
    # 1e-5 px; a lost term or a wrong tap moves the map by pixels
    assert got.shape == want.shape == (1, 96, 320, 1)
    assert np.abs(got - want).max() < 2e-3


def previous_build_reference(cfg, device, seed):
    """`harness.build_reference` as it was before a configuration could
    name its reference: the shipped model's, built in place."""
    from port_bench.reference.dav2 import DepthAnythingV2
    from port_bench.reference.pipeline import ReferencePipeline
    from port_bench.reference.stereo import StereoAnywhere, StereoConfig

    mono = cfg["mono"]
    fields = StereoConfig.__dataclass_fields__
    stereo_cfg = StereoConfig(**{k: tuple(v) if isinstance(v, list) else v
                                 for k, v in cfg["stereo"].items() if k in fields})
    with torch.device("meta"):
        ref = ReferencePipeline(StereoAnywhere(stereo_cfg), DepthAnythingV2(mono["encoder"]), cfg["iters"],
                                (mono["input_size"],) * 2)
    ref = ref.to_empty(device=device)
    for name, buf in ref.named_buffers():
        buf.fill_(1.0 if name.endswith("running_var") else 0.0)
    harness.draw_weights(ref.stereo, ref.mono, cfg, seed)
    return ref.eval()


def test_default_build_as_before(pair):
    _, reference, _ = pair
    before = previous_build_reference(CFG, CPU, 2 ** 31 + 77)
    assert (reference.iters, reference.mono_size) == (before.iters, before.mono_size)
    for now, then in ((reference.named_parameters(), before.named_parameters()),
                      (reference.named_buffers(), before.named_buffers())):
        now, then = dict(now), dict(then)
        assert list(now) == list(then)
        for name, t in then.items():
            assert now[name].dtype == t.dtype and torch.equal(now[name], t), name


@pytest.mark.parametrize("ffn", ["mlp", "swiglu"])
def test_vit_block(ffn):
    dim, heads = 128, 2
    port = PortBlock(dim, heads, ffn_layer="mlp" if ffn == "mlp" else "swiglufused")
    ref = RefBlock(dim, heads, ffn)
    for m in (port, ref):
        draw_into(m, 5, torch.float32, 1.0)
    x = torch.randn((2, 37, dim), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        torch.testing.assert_close(port(x), ref(x), rtol=1e-5, atol=1e-5)
