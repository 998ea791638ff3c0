"""The port's command line against the JAX package's, on the CPU in f32.

`infer` runs in both CLIs on the same two random 64x96 PNGs with the same
stereo checkpoint: the port's seeded f32 model saved as a reference-style
`.pth`, which the JAX CLI converts to its variables and the port loads
under the same parameter names.  No mono checkpoint: both CLIs then run
stereo-only on zero depth.  Disparity tolerance: the pipeline's, 1e-3 px
plus 5e-5 of its magnitude (`tests/test_torch_pipeline.py` gives the
reasons).  `serve` is driven up to `serve_http`, which is replaced so the
test does not block; a flax `.msgpack` cut short or lacking a leaf, and a
`--shard-rows` of no rank, are refused (whole `.msgpack` files run:
`tests/test_torch_msgpack.py`; `--shard-rows N`: `tests/test_torch_rowshard.py`).
"""
import numpy as np
import pytest
import torch
from PIL import Image

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    from stereoanywhere_tpu_torch.config import StereoAnywhereConfig
    from stereoanywhere_tpu_torch.models.stereoanywhere import StereoAnywhere

    root = tmp_path_factory.mktemp("cli")
    model = StereoAnywhere(StereoAnywhereConfig(), device="cpu", generator=torch.Generator().manual_seed(7))
    pth = root / "stereo.pth"
    torch.save({"state_dict": {f"module.{k}": v for k, v in model.state_dict().items()}}, pth)
    rng = np.random.default_rng(0)
    views = []
    for name in ("left.png", "right.png"):
        Image.fromarray(rng.integers(0, 256, (64, 96, 3), dtype=np.uint8)).save(root / name)
        views.append(str(root / name))
    return root, str(pth), views, model


@pytest.mark.parametrize("iscale", ["1", "2"])
def test_infer_matches_the_jax_cli(files, iscale):
    from stereoanywhere_tpu import cli as jax_cli

    from stereoanywhere_tpu_torch import cli

    root, pth, (left, right), _ = files
    out = {}
    for label, main, extra in (("jax", jax_cli.main, []), ("port", cli.main, ["--device", "cpu"])):
        out[label] = root / f"{label}-{iscale}"
        main(["infer", left, right, "-o", str(out[label]), "--checkpoint", pth, "--iters", "2",
              "--iscale", iscale, *extra])
    want, got = (np.load(out[k] / "left_disp.npy") for k in ("jax", "port"))
    h, w = 64 // int(iscale), 96 // int(iscale)
    assert got.shape == want.shape == (h, w)
    np.testing.assert_allclose(got, want, rtol=5e-5, atol=1e-3)
    pngs = [np.asarray(Image.open(out[k] / "left_disp.png")) for k in ("jax", "port")]
    assert pngs[0].shape == pngs[1].shape == (h, w, 3)


def test_serve_builds_the_pipeline_and_starts_the_server(files, monkeypatch):
    from stereoanywhere_tpu_torch import cli
    from stereoanywhere_tpu_torch.serve import pipeline

    _, pth, _, model = files
    started = []
    monkeypatch.setattr(pipeline, "serve_http", lambda pipe, port: started.append((pipe, port)))
    cli.main(["serve", "--checkpoint", pth, "--device", "cpu", "--iters", "3", "--port", "8123"])
    (pipe, port), = started
    assert port == 8123 and pipe.iters == 3 and pipe.mono is None
    assert pipe.graphs is False  # the CPU runs eagerly; on the card the pipeline serves from its graphs
    for k, v in model.state_dict().items():
        assert torch.equal(pipe.stereo.state_dict()[k], v), k


def test_loaders_read_reference_names_and_leave_out_what_the_converter_does(files, tmp_path):
    """A DAv2 checkpoint with the reference's unused tensors (mask_token,
    refinenet4.resConfUnit1) loads; an unknown name does not."""
    from stereoanywhere_tpu_torch import cli
    from stereoanywhere_tpu_torch.config import MonoConfig
    from stereoanywhere_tpu_torch.models.dpt import DepthAnythingV2

    src = DepthAnythingV2(MonoConfig.for_encoder("vits"), device="cpu", generator=torch.Generator().manual_seed(4))
    state = dict(src.state_dict())
    state["pretrained.mask_token"] = torch.zeros(1, 384)
    state["depth_head.scratch.refinenet4.resConfUnit1.conv1.weight"] = torch.zeros(64, 64, 3, 3)
    torch.save(state, tmp_path / "dav2.pth")
    mono = cli._load_mono(str(tmp_path / "dav2.pth"), "vits", "cpu")
    for k, v in src.state_dict().items():
        assert torch.equal(mono.state_dict()[k], v), k
    state["pretrained.not_a_parameter"] = torch.zeros(1)
    torch.save(state, tmp_path / "bad.pth")
    with pytest.raises(RuntimeError, match="not_a_parameter"):
        cli._load_mono(str(tmp_path / "bad.pth"), "vits", "cpu")


def _refused_inputs(root):
    """A stereo .msgpack cut short, and a DAv2 ViT-S .msgpack whose tree
    lacks one leaf (both as `cli convert` writes them otherwise)."""
    from stereoanywhere_tpu_torch.compat import msgpack
    from stereoanywhere_tpu_torch.compat.from_jax import dav2_tree
    from stereoanywhere_tpu_torch.config import MonoConfig
    from stereoanywhere_tpu_torch.models.dpt import DepthAnythingV2

    data = msgpack.serialize({"params": {"w": np.ones((4, 4), np.float32)}})
    (root / "cut.msgpack").write_bytes(data[:-5])
    tree = dav2_tree(DepthAnythingV2(MonoConfig.for_encoder("vits"), device="cpu").state_dict())
    del tree["params"]["depth_head"]["scratch_output_conv2_2"]["bias"]
    msgpack.write(root / "missing.msgpack", tree)


@pytest.mark.parametrize("argv, error, match", [
    (["--checkpoint", "{root}/cut.msgpack"], ValueError, "cut.msgpack: not a whole flax msgpack checkpoint"),
    (["--mono-checkpoint", "{root}/missing.msgpack", "--mono-encoder", "vits"], ValueError,
     "load_dav2_variables: port tensors left unfilled .*scratch.output_conv2.2.bias"),
    (["--shard-rows", "0"], SystemExit, None)], ids=["msgpack", "mono-msgpack", "shard-rows"])
def test_unported_options_are_refused(files, argv, error, match):
    """What the CLI refuses: a `.msgpack` cut short, a `.msgpack` tree that
    lacks a leaf the model has (`compat/from_jax.py` is strict both ways),
    and a `--shard-rows` of no rank.  Nothing is written."""
    from stereoanywhere_tpu_torch import cli

    root, _, (left, right), _ = files
    if not (root / "missing.msgpack").exists():
        _refused_inputs(root)
    with pytest.raises(error, match=match) as e:
        cli.main(["infer", left, right, "-o", str(root / "refused"), "--device", "cpu",
                  *(a.format(root=root) for a in argv)])
    if error is SystemExit:
        assert e.value.code != 0
    assert not (root / "refused").exists()
