"""DAv2 ViT-G in the port against the JAX package, on the CPU: one block at
full width (D 1536, 24 heads of 64, the SwiGLU FFN), the whole model at a
reduced depth (both packages' `VIT_CONFIGS` / `INTERMEDIATE_LAYER_IDX`
patched inside the test), and `cli infer --mono-encoder vitg` against the
JAX CLI.  The attention sub-block runs through K1-K3's plain versions here,
the FFN in plain PyTorch, as the JAX block runs it in XLA."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from PIL import Image

from stereoanywhere_tpu_torch.compat import from_jax

torch.set_num_threads(2)
DEPTH = 4


def gap(a, b) -> float:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / np.abs(b).max())


def bf16_vars(tree):
    return jax.tree.map(lambda a: jnp.asarray(a).astype(jnp.bfloat16), tree)


@pytest.fixture
def shallow_vitg(monkeypatch):
    """ViT-G at DEPTH blocks, taking all of them, in both packages."""
    from stereoanywhere_tpu.models import dinov2 as jdino, dpt as jdpt

    from stereoanywhere_tpu_torch.models import dinov2 as pdino, dpt as pdpt

    for dino, dpt in ((jdino, jdpt), (pdino, pdpt)):
        monkeypatch.setitem(dino.VIT_CONFIGS, "vitg", {**dino.VIT_CONFIGS["vitg"], "depth": DEPTH})
        monkeypatch.setitem(dpt.INTERMEDIATE_LAYER_IDX, "vitg", tuple(range(DEPTH)))


def test_mono_config_for_vitg():
    from stereoanywhere_tpu.config import MonoConfig as JMono

    from stereoanywhere_tpu_torch.config import MonoConfig
    from stereoanywhere_tpu_torch.models.dinov2 import VIT_CONFIGS
    from stereoanywhere_tpu_torch.models.dpt import INTERMEDIATE_LAYER_IDX

    assert MonoConfig.for_encoder("vitg") == MonoConfig(**vars(JMono.for_encoder("vitg")))
    assert MonoConfig.for_encoder("vitg").out_channels == (1536,) * 4
    assert VIT_CONFIGS["vitg"] == dict(embed_dim=1536, depth=40, num_heads=24, ffn_layer="swiglufused")
    assert INTERMEDIATE_LAYER_IDX["vitg"] == (9, 19, 29, 39)


def test_vitg_block_at_full_width_matches_jax():
    """One ViT-G block (T = 21, B = 2): f32 to 1e-5 of the output's scale;
    bf16 (weights and activations) within twice JAX's own bf16-vs-f32 gap."""
    from stereoanywhere_tpu.models.dinov2 import Block as JBlock

    from stereoanywhere_tpu_torch.models.dinov2 import Block, SwiGLUFFN

    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 21, 1536)).astype(np.float32)
    jb = JBlock(num_heads=24, ffn_layer="swiglufused")
    v = jax.tree.map(np.asarray, jax.jit(jb.init)(jax.random.PRNGKey(0), x))
    # LayerScale and the norms start at ones / zeros: move them so they count
    v = jax.tree.map(lambda a: a + rng.uniform(-0.5, 0.5, a.shape).astype(np.float32) if a.ndim == 1 else a, v)
    assert v["params"]["mlp"]["w12"]["kernel"].shape == (1536, 8192)
    assert v["params"]["mlp"]["w3"]["kernel"].shape == (4096, 1536)
    want32 = np.asarray(jax.jit(jb.apply)(v, x))
    want16 = np.asarray(jax.jit(jb.apply)(bf16_vars(v), jnp.asarray(x, jnp.bfloat16)), np.float32)

    block = Block(1536, 24, ffn_layer="swiglufused")
    assert isinstance(block.mlp, SwiGLUFFN)
    wrapped = {"params": {"pretrained": {"blocks_0": v["params"]}}}
    from_jax._load(block, wrapped, lambda n: from_jax._dav2_rename("pretrained.blocks.0." + n), "test")
    with torch.no_grad():
        got32 = block(torch.from_numpy(x)).numpy()
        got16 = block.to(torch.bfloat16)(torch.from_numpy(x).to(torch.bfloat16)).float().numpy()
    assert gap(got32, want32) <= 1e-5
    assert gap(got16, want16) <= 2 * gap(want16, want32)


def test_dav2_vitg_at_reduced_depth_matches_jax(shallow_vitg):
    """DAv2 ViT-G with 4 blocks, all four taken, at 42 x 56 (f32): the
    backbone, the 384-feature DPT head with its 1536-channel projections;
    1e-4 of the depth's scale, as test_torch_modules.py holds ViT-S."""
    from stereoanywhere_tpu.config import MonoConfig as JMono
    from stereoanywhere_tpu.models.dpt import DepthAnythingV2 as JD

    from stereoanywhere_tpu_torch.config import MonoConfig
    from stereoanywhere_tpu_torch.models.dpt import DepthAnythingV2

    x = np.random.default_rng(1).standard_normal((1, 42, 56, 3)).astype(np.float32)
    jm = JD(JMono.for_encoder("vitg"))
    v = jax.tree.map(np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(0), x))
    want = np.asarray(jax.jit(jm.apply)(v, x))
    pm = DepthAnythingV2(MonoConfig.for_encoder("vitg"), device="cpu")
    assert len(pm.pretrained.blocks) == DEPTH
    pm = from_jax.load_dav2_variables(pm, v)
    got = pm(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (1, 42, 56, 1)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * max(1.0, float(np.abs(want).max())))


def test_vitg_is_built_in_place_from_the_seed(shallow_vitg):
    """ViT-G's weights are drawn where the model lives, from a generator
    there seeded with the given one's seed: the same seed gives the same
    weights, every parameter finite and the LayerScales at one."""
    from stereoanywhere_tpu_torch.config import MonoConfig
    from stereoanywhere_tpu_torch.models.dpt import DepthAnythingV2

    a, b = (DepthAnythingV2(MonoConfig.for_encoder("vitg"), device="cpu", generator=torch.Generator().manual_seed(3),
                            dtype=torch.bfloat16) for _ in range(2))
    for (n, p), q in zip(a.named_parameters(), b.parameters()):
        assert p.dtype == torch.bfloat16 and torch.equal(p, q) and torch.isfinite(p).all(), n
    assert torch.equal(a.pretrained.blocks[0].ls2.gamma, torch.ones(1536, dtype=torch.bfloat16))


def test_cli_infer_vitg_matches_the_jax_cli(shallow_vitg, tmp_path, monkeypatch):
    """`infer --mono-encoder vitg` with a reference-named ViT-G `.pth` (the
    port's state_dict, 4 blocks), read by both CLIs, 2 GRU iterations on a
    64x64 pair: the disparity within the pipeline's tolerance (1e-3 px +
    5e-5 relative, `tests/test_torch_cli.py`).  The JAX CLI's `infer`
    loads the mono weights of `--mono-encoder` but builds its pipeline with
    the default (ViT-L) mono config (its `cli.py:414`), so this test hands
    that pipeline ViT-G's config; nothing of the JAX package changes."""
    import functools

    from stereoanywhere_tpu import cli as jax_cli
    from stereoanywhere_tpu.config import MonoConfig as JMono
    from stereoanywhere_tpu.serve import pipeline as jpipeline

    from stereoanywhere_tpu_torch import cli
    from stereoanywhere_tpu_torch.config import MonoConfig, StereoAnywhereConfig
    from stereoanywhere_tpu_torch.models.dpt import DepthAnythingV2
    from stereoanywhere_tpu_torch.models.stereoanywhere import StereoAnywhere

    stereo = StereoAnywhere(StereoAnywhereConfig(), device="cpu", generator=torch.Generator().manual_seed(7))
    torch.save({"state_dict": stereo.state_dict()}, tmp_path / "stereo.pth")
    mono = DepthAnythingV2(MonoConfig.for_encoder("vitg"), device="cpu", generator=torch.Generator().manual_seed(8))
    state = mono.state_dict()
    state["pretrained.mask_token"] = torch.zeros(1, 1536)  # a reference file's extra, which both CLIs skip
    torch.save(state, tmp_path / "vitg.pth")
    rng = np.random.default_rng(0)
    views = []
    for name in ("left.png", "right.png"):
        Image.fromarray(rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)).save(tmp_path / name)
        views.append(str(tmp_path / name))
    monkeypatch.setattr(jpipeline, "StereoAnywherePipeline", functools.partial(
        jpipeline.StereoAnywherePipeline, mono_cfg=JMono.for_encoder("vitg")))
    for label, main, extra in (("jax", jax_cli.main, []), ("port", cli.main, ["--device", "cpu"])):
        main(["infer", *views, "-o", str(tmp_path / label), "--checkpoint", str(tmp_path / "stereo.pth"),
              "--mono-checkpoint", str(tmp_path / "vitg.pth"), "--mono-encoder", "vitg", "--iters", "2", *extra])
    want, got = (np.load(tmp_path / k / "left_disp.npy") for k in ("jax", "port"))
    assert got.shape == want.shape == (64, 64) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=5e-5, atol=1e-3)


def test_precompute_mono_vitg_matches_the_jax_cli(shallow_vitg, tmp_path):
    """`precompute-mono --mono-encoder vitg --outdir`: the same files as the
    JAX CLI's (`<index>_<view>_DAv2_vitg.png`), whose 16-bit depth agrees
    within 2 of its 65535 steps (one rounding either side)."""
    from stereoanywhere_tpu import cli as jax_cli

    from stereoanywhere_tpu_torch import cli
    from stereoanywhere_tpu_torch.config import MonoConfig
    from stereoanywhere_tpu_torch.data.frame_utils import read_mono16, write_pfm
    from stereoanywhere_tpu_torch.models.dpt import DepthAnythingV2

    rng = np.random.default_rng(3)
    scene = tmp_path / "mb" / "scene0"
    scene.mkdir(parents=True)
    for name in ("im0", "im1"):
        Image.fromarray(rng.integers(0, 256, (42, 42, 3), dtype=np.uint8)).save(scene / f"{name}.png")
    write_pfm(str(scene / "disp0GT.pfm"), rng.uniform(1, 9, (42, 42)).astype(np.float32))
    pth = tmp_path / "vitg.pth"
    torch.save(DepthAnythingV2(MonoConfig.for_encoder("vitg"), device="cpu").state_dict(), pth)
    for label, main, extra in (("jax", jax_cli.main, []), ("port", cli.main, ["--device", "cpu"])):
        main(["precompute-mono", "--dataset", "middlebury", "--datapath", str(tmp_path / "mb"), "--mono-checkpoint",
              str(pth), "--mono-encoder", "vitg", "--outdir", str(tmp_path / label), *extra])
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "port").iterdir()) == [
        "000000_im2_DAv2_vitg.png", "000000_im3_DAv2_vitg.png"]
    for n in names:
        want, got = (read_mono16(str(tmp_path / k / n)) for k in ("jax", "port"))
        np.testing.assert_allclose(got, want, atol=2 / 65535)
