"""The port's EXR codec (`data/exr.py`), its EXR and generic readers
(`data/frame_utils.py` `read_depth_exr`, `read_gen`) and its reprojection
utilities (`data/warps.py`) against the JAX package's, on the CPU.

Every case is bit for bit: the codec and the utilities are copies, the warps
dispatch to the same native source where it is built, and their numpy forms
(taken with the library switched off in both packages) are held to each
other and to the native results.
"""
import numpy as np
import pytest

from stereoanywhere_tpu import native as jnative
from stereoanywhere_tpu.data import exr as jexr
from stereoanywhere_tpu.data import frame_utils as jfu
from stereoanywhere_tpu.data import warps as jwarps

from stereoanywhere_tpu_torch import native as pnative
from stereoanywhere_tpu_torch.data import exr as pexr
from stereoanywhere_tpu_torch.data import frame_utils as pfu
from stereoanywhere_tpu_torch.data import warps as pwarps


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("compression", ["none", "zips", "zip"])
def test_exr_roundtrip_equals_jax(tmp_path, rng, compression):
    """The JAX roundtrip case (`tests/test_datasets.py` test_exr_codec_roundtrip)
    in both packages: the files byte for byte, each read by both readers."""
    z = rng.uniform(0.5, 10, (33, 50)).astype(np.float32)
    chans = {"Z": z, "C": (z * 2).astype(np.float16), "A": rng.standard_normal((33, 50)).astype(np.float32)}
    paths = {}
    for label, mod in (("port", pexr), ("jax", jexr)):
        paths[label] = str(tmp_path / f"{label}.exr")
        mod.write_exr(paths[label], chans, compression=compression)
    assert open(paths["port"], "rb").read() == open(paths["jax"], "rb").read()
    for p in paths.values():
        got, want = pexr.read_exr(p), jexr.read_exr(p)
        assert sorted(got) == sorted(want) == ["A", "C", "Z"]
        for k in want:
            _same(got[k], want[k])
            _same(got[k], chans[k])


def test_exr_predictor_pair_equals_jax(rng):
    for n in (0, 1, 2, 7, 64, 1001):
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        assert pexr._predict(data) == jexr._predict(data)
        assert pexr._unpredict(pexr._predict(data)) == data
        assert pexr._unpredict(data) == jexr._unpredict(data)


def test_read_depth_exr_and_read_gen_equal_jax(tmp_path, rng):
    z = rng.uniform(0.5, 10, (33, 50)).astype(np.float32)
    z[0, :5] = 0
    p = str(tmp_path / "d.exr")
    pexr.write_exr(p, {"Z": z})
    for got, want in zip(pfu.read_depth_exr(p, 450.0, 0.075), jfu.read_depth_exr(p, 450.0, 0.075)):
        _same(got, want)
    disp, valid = pfu.read_depth_exr(p, 450.0, 0.075)
    assert disp.shape == valid.shape == (33, 50, 1) and (valid[0, :5, 0] == 0).all() and disp[0, 0, 0] == 0
    _same(pfu.read_gen(p), jfu.read_gen(p))
    _same(pfu.read_gen(p), z)
    # the depth channel's fallbacks: Y, then R, then the first
    for name in ("Y", "R", "Q"):
        q = str(tmp_path / f"{name}.exr")
        pexr.write_exr(q, {name: z, "zz": z + 1})
        for got, want in zip(pfu.read_depth_exr(q, 2.0, 0.5), jfu.read_depth_exr(q, 2.0, 0.5)):
            _same(got, want)
        _same(pfu.read_gen(q), jfu.read_gen(q))
    arr = rng.standard_normal((4, 5)).astype(np.float32)
    np.save(tmp_path / "a.npy", arr)
    _same(pfu.read_gen(str(tmp_path / "a.npy")), jfu.read_gen(str(tmp_path / "a.npy")))
    pfu.write_pfm(str(tmp_path / "a.pfm"), arr)
    _same(pfu.read_gen(str(tmp_path / "a.pfm")), jfu.read_gen(str(tmp_path / "a.pfm")))
    with pytest.raises(ValueError, match="unsupported extension"):
        pfu.read_gen(str(tmp_path / "a.txt"))


def test_exr_refuses_what_it_does_not_read(tmp_path):
    bad = tmp_path / "bad.exr"
    bad.write_bytes(b"\x00" * 16)
    with pytest.raises(ValueError, match="not an EXR file"):
        pexr.read_exr(str(bad))


def _warp_inputs(rng):
    disp = ((rng.uniform(0, 1, (30, 50)) > 0.4) * rng.uniform(1, 15, (30, 50))).astype(np.float32)
    depth = ((rng.uniform(0, 1, (30, 50)) > 0.3) * rng.uniform(0.5, 10, (30, 50))).astype(np.float32)
    holes = ((rng.uniform(0, 1, (25, 45)) > 0.5) * rng.uniform(1, 30, (25, 45))).astype(np.float32)
    holes[3] = 0  # a row with no valid pixel stays as it is
    return disp, depth, holes


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
def test_warps_equal_jax(rng, monkeypatch, native):
    if native:
        from tests.test_torch_native import need_jax_native

        need_jax_native(monkeypatch)
        if not pnative.available():
            pytest.skip(f"the port's native library cannot be built here: {pnative.build_error()}")
    if not native:
        monkeypatch.setattr(pnative, "available", lambda: False)
        monkeypatch.setattr(jnative, "available", lambda: False)
    disp, depth, holes = _warp_inputs(rng)
    _same(pwarps.fast_warp_disparity(disp), jwarps.fast_warp_disparity(disp))
    _same(pwarps.fast_warp_depth(depth, disp), jwarps.fast_warp_depth(depth, disp))
    _same(pwarps.interpolate_background(holes), jwarps.interpolate_background(holes))
    # the JAX package's case (`tests/test_extras.py` test_fast_warps)
    plane = np.full((6, 20), 4.0, np.float32)
    warped = pwarps.fast_warp_disparity(plane)
    assert (warped[:, :16] == 4.0).all() and (warped[:, 16:] == 0).all()
    plane[:, 5:9] = 0
    assert (pwarps.interpolate_background(plane) > 0).all()


def test_native_and_numpy_warps_agree(rng, monkeypatch):
    if not pnative.available():
        pytest.skip("the native library is not built")
    disp, depth, holes = _warp_inputs(rng)
    calls = (lambda: pwarps.fast_warp_disparity(disp), lambda: pwarps.fast_warp_depth(depth, disp),
             lambda: pwarps.interpolate_background(holes))
    native = [f() for f in calls]
    monkeypatch.setattr(pnative, "available", lambda: False)
    for got, f in zip(native, calls):
        _same(got, f())


def test_pointcloud_and_3d_resize_equal_jax(rng):
    disp = ((rng.uniform(0, 1, (24, 32)) > 0.3) * rng.uniform(1, 40, (24, 32))).astype(np.float32)
    for kw in ({}, {"cx": 10.5, "cy": 7.0}):
        got, want = pwarps.disparity_to_pointcloud(disp, 500.0, 0.12, **kw), jwarps.disparity_to_pointcloud(
            disp, 500.0, 0.12, **kw)
        _same(got, want)
        assert got.shape == ((disp > 0).sum(), 3)
    for out_hw, scale in (((12, 16), None), ((48, 80), None), ((24, 50), 0.5)):
        _same(pwarps.resize_disparity_3d(disp, out_hw, scale), jwarps.resize_disparity_3d(disp, out_hw, scale))
