"""The port's flax msgpack reader and writer (`compat/msgpack.py`), its tree
builders (`compat/from_jax.py` `stereo_tree` / `dav2_tree`) and `cli
convert` against flax and the JAX package's CLI, on the CPU.

Both directions are held bit for bit: the port's bytes equal flax's
`msgpack_serialize` of the same tree, and the port's reader gives the leaves
of flax's `msgpack_restore` (bfloat16 as torch tensors with the same bits).
The trees reach every msgpack width flax can write: each int, str, bin,
array, map and ext header, Python floats, None and bools, numpy scalars,
complex numbers, and chunked arrays (flax's `MAX_CHUNK_SIZE` lowered).
"""
import jax
import ml_dtypes
import numpy as np
import pytest
import torch
from flax import serialization
from PIL import Image

from stereoanywhere_tpu.compat import convert_dav2_checkpoint, convert_stereo_checkpoint, load_torch_state_dict

from stereoanywhere_tpu_torch.compat import from_jax
from stereoanywhere_tpu_torch.compat import msgpack as pm

torch.set_num_threads(2)


def _widths_tree():
    """Every header width: int (fix, 8, 16, 32, 64 bits, both signs), str
    (fix, 8, 16, 32), bin (8, 16, 32), array and map (fix, 16, 32)."""
    ints = [0, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32, 2 ** 64 - 1,
            -1, -32, -33, -128, -129, -32768, -32769, -2 ** 31, -2 ** 31 - 1, -2 ** 63]
    return {
        "ints": ints,
        "floats": [0.0, -1.5, 1e300, float("inf")],
        "strs": ["", "a" * 31, "b" * 32, "c" * 255, "d" * 256, "é" * 40000],
        "bins": [b"", b"x" * 255, b"y" * 256, b"z" * 70000],
        "arrays": [list(range(15)), list(range(16)), list(range(70000))],
        "maps": {"fix": {f"k{i}": i for i in range(15)}, "m16": {f"k{i}": i for i in range(16)},
                 "m32": {f"k{i:05d}": i for i in range(70000)}},
        "none": None, "yes": True, "no": False,
        "nested": {"b": {"a": [1, {"z": 2, "y": [3.5]}]}, "a": "first"},
    }


def _ext_tree():
    """Ext payloads of each length class flax writes (fixext 16, ext 8, 16
    and 32), numpy scalars of several dtypes (ext 3) and complex numbers
    (ext 2); arrays of several dtypes and shapes."""
    rng = np.random.default_rng(0)
    return {
        "fixext16": np.arange(6, dtype=np.int8),
        "ext8": rng.standard_normal((3, 4)).astype(np.float32),
        "ext16": rng.standard_normal((40, 50)).astype(np.float32),
        "ext32": rng.standard_normal((130, 130)).astype(np.float32),
        "dtypes": {d: rng.integers(0, 100, (2, 3)).astype(d) for d in
                   ("float16", "float64", "int8", "int16", "int32", "int64", "uint8", "uint16", "uint32", "bool",
                    "complex64")},
        "shapes": {"scalar": np.array(2.5, np.float32), "empty": np.zeros((0, 3), np.float32),
                   "4d": rng.standard_normal((2, 1, 3, 2)).astype(np.float32)},
        "npscalars": [np.float32(1.25), np.int64(-7), np.float64(3.0), np.bool_(True), np.uint8(200)],
        "complex": [1 + 2j, -0.5j],
    }


def _bf16(x: np.ndarray):
    """(flax's leaf, the port's leaf) of the bfloat16 rounding of x."""
    return x.astype(ml_dtypes.bfloat16), torch.from_numpy(x).to(torch.bfloat16)


def _bf16_trees():
    rng = np.random.default_rng(1)
    fx, px = _bf16(rng.standard_normal((5, 7)).astype(np.float32))
    fs, ps = _bf16(np.array(-3.25, np.float32))
    flax_tree = {"w": fx, "s": fs, "f32": np.ones(3, np.float32)}
    port_tree = {"w": px, "s": ps, "f32": np.ones(3, np.float32)}
    return flax_tree, port_tree


def _same_leaf(got, want, where=""):
    """got (the port's) against want (flax's): type, dtype, shape and bits."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), where
        for k in want:
            _same_leaf(got[k], want[k], f"{where}/{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _same_leaf(g, w, f"{where}[{i}]")
    elif isinstance(want, (np.ndarray, np.generic)) and want.dtype == ml_dtypes.bfloat16:
        assert isinstance(got, torch.Tensor) and got.dtype == torch.bfloat16, where
        assert tuple(got.shape) == np.shape(want), where
        np.testing.assert_array_equal(got.view(torch.int16).numpy().view(np.uint16),
                                      np.asarray(want).view(np.uint16), err_msg=where)
    elif isinstance(want, (np.ndarray, np.generic)):
        assert type(got) is type(want) and got.dtype == want.dtype and np.shape(got) == np.shape(want), where
        np.testing.assert_array_equal(got, want, err_msg=where)
    else:
        assert type(got) is type(want) and got == want, where


@pytest.mark.parametrize("make", [_widths_tree, _ext_tree], ids=["widths", "ext"])
def test_bytes_and_leaves_equal_flax_both_ways(make):
    tree = make()
    data = serialization.msgpack_serialize(tree)
    assert pm.serialize(tree) == data
    _same_leaf(pm.restore(data), serialization.msgpack_restore(data))


def test_bfloat16_without_ml_dtypes():
    flax_tree, port_tree = _bf16_trees()
    data = serialization.msgpack_serialize(flax_tree)
    assert pm.serialize(port_tree) == data
    got = pm.restore(data)
    _same_leaf(got, serialization.msgpack_restore(data))
    assert got["s"].shape == () and got["s"].item() == -3.25
    # a bfloat16 numpy scalar (ext 3) reads as a 0-d tensor
    scalar = serialization.msgpack_serialize({"s": flax_tree["s"][()]})
    assert pm.restore(scalar)["s"].dtype == torch.bfloat16 and pm.restore(scalar)["s"].item() == -3.25


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunked_arrays(monkeypatch, dtype):
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(pm, "MAX_CHUNK_SIZE", 64)
    rng = np.random.default_rng(2)
    big = rng.standard_normal((5, 23)).astype(np.float32)  # 460 bytes: 8 chunks of 16 f32, 4 of 32 bf16
    small = rng.standard_normal(16).astype(np.float32)  # 64 bytes: not chunked
    if dtype == "bfloat16":
        (fbig, pbig), (fsmall, psmall) = _bf16(big), _bf16(small)
    else:
        fbig = pbig = big
        fsmall = psmall = small
    flax_tree = {"params": {"big": fbig, "small": fsmall}, "top": fbig}
    data = serialization.msgpack_serialize(flax_tree)
    assert b"__msgpack_chunked_array__" in data
    assert pm.serialize({"params": {"big": pbig, "small": psmall}, "top": pbig}) == data
    _same_leaf(pm.restore(data), serialization.msgpack_restore(data))
    assert pm.serialize(pbig) == serialization.msgpack_serialize(fbig)  # a chunked array at the root
    _same_leaf(pm.restore(serialization.msgpack_serialize(fbig)), fbig)


def test_truncated_and_trailing_bytes_are_refused(tmp_path):
    data = serialization.msgpack_serialize(_ext_tree())
    for bad in (data[:-1], data[: len(data) // 2], data + b"\x00"):
        with pytest.raises(ValueError):
            pm.restore(bad)
    (tmp_path / "cut.msgpack").write_bytes(data[:100])
    with pytest.raises(ValueError, match="cut.msgpack: not a whole flax msgpack checkpoint"):
        pm.read(tmp_path / "cut.msgpack")


# ---------------------------------------------------------------------------
# Checkpoints: the trees, `cli convert`, and loading


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """The port's seeded stereo model and DAv2 ViT-S as reference-style
    files (DataParallel prefixes; DAv2 with the reference's unused
    tensors)."""
    from stereoanywhere_tpu_torch.config import MonoConfig, StereoAnywhereConfig
    from stereoanywhere_tpu_torch.models.dpt import DepthAnythingV2
    from stereoanywhere_tpu_torch.models.stereoanywhere import StereoAnywhere

    root = tmp_path_factory.mktemp("msgpack")
    stereo = StereoAnywhere(StereoAnywhereConfig(), device="cpu", generator=torch.Generator().manual_seed(31))
    torch.save({"state_dict": {f"module.{k}": v for k, v in stereo.state_dict().items()}}, root / "stereo.tar")
    dav2 = DepthAnythingV2(MonoConfig.for_encoder("vits"), device="cpu", generator=torch.Generator().manual_seed(32))
    state = dict(dav2.state_dict())
    state["pretrained.mask_token"] = torch.zeros(1, 384)
    state["depth_head.scratch.refinenet4.resConfUnit1.conv1.weight"] = torch.zeros(64, 64, 3, 3)
    torch.save(state, root / "dav2.pth")
    return root, {"stereo": (stereo, str(root / "stereo.tar")), "dav2": (dav2, str(root / "dav2.pth"))}


CONVERT = {"stereo": convert_stereo_checkpoint, "dav2": convert_dav2_checkpoint}


@pytest.mark.parametrize("kind", ["stereo", "dav2"])
def test_convert_writes_the_jax_clis_file(checkpoints, kind):
    from stereoanywhere_tpu import cli as jax_cli

    from stereoanywhere_tpu_torch import cli

    root, models = checkpoints
    model, path = models[kind]
    out = {}
    for label, main in (("jax", jax_cli.main), ("port", cli.main)):
        out[label] = root / f"{kind}-{label}.msgpack"
        main(["convert", "--input", path, "--output", str(out[label]), "--kind", kind])
    data = out["port"].read_bytes()
    assert data == out["jax"].read_bytes()
    want = CONVERT[kind](load_torch_state_dict(path))
    got = serialization.msgpack_restore(data)
    want_leaves = jax.tree_util.tree_leaves_with_path(want)
    got_leaves = jax.tree_util.tree_leaves_with_path(got)
    assert [p for p, _ in got_leaves] == [p for p, _ in want_leaves]
    for (p, g), (_, w) in zip(got_leaves, want_leaves):
        assert g.dtype == w.dtype == np.float32 and g.shape == w.shape, p
        np.testing.assert_array_equal(g.view(np.uint32), w.view(np.uint32), err_msg=str(p))
    # the tree builder on the port's own state dict (tensors, not the file's arrays) gives the same bytes
    tree = from_jax.stereo_tree(model.state_dict()) if kind == "stereo" else from_jax.dav2_tree(model.state_dict())
    assert pm.serialize(tree) == data


def test_mixed_tree_through_flax(checkpoints, monkeypatch):
    """The port's bytes for a stereo tree with a bf16 leaf, a numpy scalar
    and a chunked array: flax restores every leaf (path, dtype, shape,
    bits)."""
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 4096)
    monkeypatch.setattr(pm, "MAX_CHUNK_SIZE", 4096)
    _, models = checkpoints
    tree = from_jax.stereo_tree(models["stereo"][0].state_dict())
    big = tree["params"]["update_block"]["gru08"]["convz"]["kernel"]
    assert big.nbytes > 4096
    fbf, pbf = _bf16(np.linspace(-2, 2, 10, dtype=np.float32))
    flax_tree = {**tree, "extra": {"bf16": fbf, "step": np.int32(7)}}
    port_tree = {**tree, "extra": {"bf16": pbf, "step": np.int32(7)}}
    data = pm.serialize(port_tree)
    assert data == serialization.msgpack_serialize(flax_tree)
    restored = serialization.msgpack_restore(data)
    got = dict(jax.tree_util.tree_leaves_with_path(restored))
    want = dict(jax.tree_util.tree_leaves_with_path(flax_tree))
    assert got.keys() == want.keys()
    for p, w in want.items():
        g = got[p]
        assert np.asarray(g).dtype == np.asarray(w).dtype and np.shape(g) == np.shape(w), p
        np.testing.assert_array_equal(np.asarray(g).reshape(-1).view(np.uint8), np.asarray(w).reshape(-1).view(np.uint8),
                                      err_msg=str(p))


@pytest.mark.parametrize("kind", ["stereo", "dav2"])
def test_the_port_reads_flax_files_into_the_same_tensors(checkpoints, kind):
    from stereoanywhere_tpu_torch import cli

    root, models = checkpoints
    model, path = models[kind]
    flax_file = root / f"{kind}-flax.msgpack"
    flax_file.write_bytes(serialization.msgpack_serialize(CONVERT[kind](load_torch_state_dict(path))))
    if kind == "stereo":
        from stereoanywhere_tpu_torch.config import StereoAnywhereConfig

        got = cli._load_stereo(str(flax_file), StereoAnywhereConfig(), "cpu")
        other = cli._load_stereo(None, StereoAnywhereConfig(), "cpu")
        from_jax.load_stereo_variables(other, serialization.msgpack_restore(flax_file.read_bytes()))
    else:
        got = cli._load_mono(str(flax_file), "vits", "cpu")
        other = cli._load_mono(path, "vits", "cpu")
        from_jax.load_dav2_variables(other, jax.tree.map(np.asarray, serialization.msgpack_restore(
            flax_file.read_bytes())))
    for k, v in model.state_dict().items():
        assert torch.equal(got.state_dict()[k], v), k
        assert torch.equal(other.state_dict()[k], v), k


def test_bfloat16_leaves_load(checkpoints):
    """A DAv2 tree with bf16 leaves, read without ml_dtypes, loads to the
    bf16 rounding of the f32 weights."""
    from stereoanywhere_tpu_torch.config import MonoConfig
    from stereoanywhere_tpu_torch.models.dpt import DepthAnythingV2

    _, models = checkpoints
    model = models["dav2"][0]
    tree = jax.tree.map(lambda a: a.astype(ml_dtypes.bfloat16), from_jax.dav2_tree(model.state_dict()))
    restored = pm.restore(serialization.msgpack_serialize(tree))
    leaf = restored["params"]["pretrained"]["blocks_0"]["attn"]["qkv"]["kernel"]
    assert isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16
    fresh = DepthAnythingV2(MonoConfig.for_encoder("vits"), device="cpu", generator=torch.Generator().manual_seed(1))
    from_jax.load_dav2_variables(fresh, restored)
    for k, v in model.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v.to(torch.bfloat16).float()), k


def test_cli_infer_reads_msgpack_like_the_tar(checkpoints):
    """`cli infer --checkpoint x.msgpack` (made by `cli convert`) equals
    `--checkpoint x.tar` bit for bit, f32."""
    from stereoanywhere_tpu_torch import cli

    root, models = checkpoints
    tar = models["stereo"][1]
    rng = np.random.default_rng(3)
    views = []
    for name in ("l.png", "r.png"):
        Image.fromarray(rng.integers(0, 256, (64, 96, 3), dtype=np.uint8)).save(root / name)
        views.append(str(root / name))
    msgpack_file = root / "infer.msgpack"
    cli.main(["convert", "--input", tar, "--output", str(msgpack_file)])
    out = {}
    for label, ckpt in (("tar", tar), ("msgpack", str(msgpack_file))):
        cli.main(["infer", *views, "-o", str(root / label), "--checkpoint", ckpt, "--iters", "2", "--device", "cpu"])
        out[label] = np.load(root / label / "l_disp.npy")
    assert out["tar"].shape == (64, 96)
    np.testing.assert_array_equal(out["msgpack"], out["tar"])
