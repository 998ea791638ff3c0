"""The port's benchmark readers and decoders against the JAX package's, on
synthetic trees in the reference layouts (the trees of
`tests/test_datasets.py`, one for every reader).

Every key of every sample must be equal bit for bit, with the same dtype and
shape: the readers and decoders are copies, and each package decodes
through its own build of the native C++ decoder where it is built (through
PIL otherwise), so 16-bit PNGs (KITTI disparity, mono16, depth in
millimetres) are where the two could part.
"""
import os
import pickle

import numpy as np
import pytest
from PIL import Image

from stereoanywhere_tpu.data import datasets as jds
from stereoanywhere_tpu.data import frame_utils as jfu

from stereoanywhere_tpu_torch.data import datasets as pds
from stereoanywhere_tpu_torch.data import frame_utils as pfu

H, W = 24, 40


def _png(path, arr):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(arr).save(path)


def _pfm(path, arr):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    jfu.write_pfm(path, arr)


def _rgb(rng, h=H, w=W):
    return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)


def _u16(rng, lo, hi, scale, h=H, w=W, holes=True):
    a = (rng.uniform(lo, hi, (h, w)) * scale).astype(np.uint16)
    if holes:
        a[rng.uniform(size=(h, w)) < 0.2] = 0
    return a


def _flyingthings(root, rng):
    for name in ("0000000", "0000001"):
        _png(f"{root}/image_clean/left/{name}.png", _rgb(rng))
        _png(f"{root}/image_clean/right/{name}.png", _rgb(rng))
        gt = rng.uniform(-40, 300, (H, W)).astype(np.float32)
        _pfm(f"{root}/disparity/left/{name}.pfm", -gt)
        if name == "0000000":  # the second has no right disparity
            _pfm(f"{root}/disparity/right/{name}.pfm", gt)


def _cleanpass(scene_dir):
    """Monkaa (frames_cleanpass/<scene>/left) or Driving
    (frames_cleanpass/<focal>/<scene>/slow/left); |disparity| is read."""
    def write(root, rng):
        for scene in ("a", "b"):
            d = scene_dir.format(scene=scene)
            for name in ("0001", "0002"):
                for side in ("left", "right"):
                    _png(f"{root}/frames_cleanpass/{d}/{side}/{name}.png", _rgb(rng))
                    gt = rng.uniform(-10, 6000, (H, W)).astype(np.float32)
                    _pfm(f"{root}/disparity/{d}/{side}/{name}.pfm", gt)
    return write


def _middlebury(gt0, gt1):
    def write(root, rng):
        for scene, right in (("sceneA", "im1"), ("sceneB", "im1E")):
            _png(f"{root}/{scene}/im0.png", _rgb(rng))
            _png(f"{root}/{scene}/{right}.png", _rgb(rng))
            gt = rng.uniform(0.5, 60, (H, W)).astype(np.float32)
            gt[0, :3] = np.inf  # non-finite gt is zeroed
            gt[1, :2] = -1.0
            _pfm(f"{root}/{scene}/{gt0}", gt)
            if scene == "sceneA":
                _pfm(f"{root}/{scene}/{gt1}", gt[:, ::-1].copy())
                mask = rng.choice(np.array([0, 128, 255], np.uint8), (H, W))
                _png(f"{root}/{scene}/mask0nocc.png", mask)
    return write


def _kitti(root, rng):
    for name in ("000000_10", "000001_10"):
        _png(f"{root}/image_2/{name}.png", _rgb(rng))
        _png(f"{root}/image_3/{name}.png", _rgb(rng, w=W))
        if name == "000000_10":  # the second has no gt
            occ = _u16(rng, 1, 200, 256)
            noc = occ.copy()
            noc[:, :7] = 0
            _png(f"{root}/disp_occ_0/{name}.png", occ)
            _png(f"{root}/disp_noc_0/{name}.png", noc)


def _booster(root, rng):
    for scene in ("s1", "s2"):
        _png(f"{root}/balanced/{scene}/camera_00/0000.png", _rgb(rng))
        _png(f"{root}/balanced/{scene}/camera_02/0000.png", _rgb(rng))
        np.save(f"{root}/balanced/{scene}/disp_00.npy", rng.uniform(0, 80, (H, W)).astype(np.float32))
        if scene == "s1":
            _png(f"{root}/balanced/{scene}/mask_00.png", rng.choice(np.array([0, 255], np.uint8), (H, W)))


def _layeredflow(root, rng):
    for i in range(2):
        scene = f"{root}/{i}"
        for name in ("0_0", "0_1", "3_0", "3_1"):
            _png(f"{scene}/{name}.png", _rgb(rng))
        pts = {k: [(0, 0, (float(10 + k + i), float(5 + k)))] for k in range(4)}
        pts[1] = [(0, 0, (4.0 + i, 5.5))]
        with open(f"{scene}/gt.pickle", "wb") as f:
            pickle.dump({"stereo_points": pts, "annotations": {(0, 0): (None, None, 0)}}, f)


def _monotrap(root, rng):
    _png(f"{root}/scene/left_rect/0.png", _rgb(rng))
    _png(f"{root}/scene/right_rect/0.png", _rgb(rng))
    _png(f"{root}/scene/gt_disp/0.png", _u16(rng, 1, 50, 256))
    _png(f"{root}/scene/gt_depth/0.png", _u16(rng, 0.2, 3, 1000))
    gmask = np.full((H, W), 255, np.uint8)
    gmask[-4:] = 0
    gmask[:, :3] = 127
    _png(f"{root}/scene/gt_mask/0.png", gmask)


WRITERS = {
    "flyingthings": _flyingthings,
    "monkaa": _cleanpass("{scene}"),
    "driving": _cleanpass("15mm/{scene}/slow"),
    "middlebury": _middlebury("disp0GT.pfm", "disp1GT.pfm"),
    "eth3d": _middlebury("disp0GT.pfm", "disp1GT.pfm"),
    "middlebury2021": _middlebury("disp0.pfm", "disp1.pfm"),
    "kitti2015": _kitti,
    "kitti2012": _kitti,
    "booster": _booster,
    "layeredflow": _layeredflow,
    "monotrap": _monotrap,
}
WITH_MONO = ("flyingthings", "monkaa", "driving", "middlebury", "eth3d", "middlebury2021", "kitti2015",
             "kitti2012", "booster")


def _write(name, root, rng):
    WRITERS[name](root, rng)


def _same_samples(a, b):
    assert len(a) == len(b) > 0
    for i in range(len(a)):
        sa, sb = a[i], b[i]
        assert sorted(sa) == sorted(sb), i
        for k, va in sa.items():
            vb = sb[k]
            if isinstance(va, np.ndarray):
                assert va.dtype == vb.dtype and va.shape == vb.shape, (i, k, va.dtype, vb.dtype, va.shape, vb.shape)
                np.testing.assert_array_equal(vb, va, err_msg=f"sample {i} key {k}")
            else:
                assert va == vb, (i, k)


@pytest.mark.parametrize("name", sorted(WRITERS))
def test_readers_match_jax(tmp_path, name):
    root = str(tmp_path / "data")
    _write(name, root, np.random.default_rng(len(name)))
    _same_samples(jds.fetch_dataset(name, root, test=True), pds.fetch_dataset(name, root, test=True))


@pytest.mark.parametrize("name", ["middlebury", "kitti2015", "booster", "monotrap"])
def test_readers_match_jax_at_scale_factor_2(tmp_path, name):
    """`scale_factor=2`: PIL's bilinear for the images, nearest for gt and
    the masks, gt values halved; also `overfit`, `multiplier` and KITTI's
    `top_crop`."""
    root = str(tmp_path / "data")
    _write(name, root, np.random.default_rng(3))
    kw = dict(scale_factor=2, multiplier=2)
    if name == "kitti2015":
        kw["top_crop"] = 5
    _same_samples(jds.fetch_dataset(name, root, **kw), pds.fetch_dataset(name, root, **kw))
    _same_samples(jds.fetch_dataset(name, root, overfit=True), pds.fetch_dataset(name, root, overfit=True))


@pytest.mark.parametrize("name", WITH_MONO)
def test_precomputed_mono_is_read_where_mono_paths_names_it(tmp_path, name):
    """`mono=tag`: each reader opens the 16-bit mono PNGs at the paths that
    the port's `mono_paths` gives (where `cli precompute-mono` writes
    them), and reads them as the JAX reader does."""
    root = str(tmp_path / "data")
    rng = np.random.default_rng(9)
    _write(name, root, rng)
    plain = pds.fetch_dataset(name, root)
    for i in range(len(plain)):
        for path in plain.mono_paths(i, "DAv2"):
            os.makedirs(os.path.dirname(path), exist_ok=True)
            pfu.write_mono16(path, rng.uniform(0, 1, (H, W)))
    got = pds.fetch_dataset(name, root, mono="DAv2")
    _same_samples(jds.fetch_dataset(name, root, mono="DAv2"), got)
    assert all("im2_mono" in got[i] and "im3_mono" in got[i] for i in range(len(got)))


def test_sceneflow_concatenates_three_readers(tmp_path):
    rng = np.random.default_rng(4)
    roots = [str(tmp_path / n) for n in ("ft", "monkaa", "driving")]
    for name, root in zip(("flyingthings", "monkaa", "driving"), roots):
        _write(name, root, rng)
    path = ";".join(roots)
    a, b = jds.fetch_dataset("sceneflow", path), pds.fetch_dataset("sceneflow", path)
    assert len(b) == 2 + 4 + 4
    _same_samples(a, b)
    assert b.mono_paths(2, "DAv2")[0].endswith(os.path.join("a", "left_DAv2", "0001.png"))


def test_layeredflow_and_monotrap_read_no_precomputed_mono(tmp_path):
    for name in ("layeredflow", "monotrap"):
        root = str(tmp_path / name)
        _write(name, root, np.random.default_rng(5))
        with pytest.raises(NotImplementedError, match="no precomputed mono"):
            pds.fetch_dataset(name, root).mono_paths(0, "DAv2")


def test_the_training_augmentor_is_refused(tmp_path):
    """The readers take the training augmentor now (the name is the slice
    that refused it): in test mode it is never called; in train mode every
    sample, its images in uint8 scale, goes through it, as in the JAX
    readers (`tests/test_torch_train_data.py` holds the two bit for bit)."""
    root = str(tmp_path / "data")
    _write("middlebury", root, np.random.default_rng(6))
    seen = []

    def augmentor(d):
        seen.append(float(d["im2"].max()))
        return {**d, "im2_aug": d["im2"] / 255.0, "im3_aug": d["im3"] / 255.0}

    test_ds = pds.fetch_dataset("middlebury", root, test=True, augmentor=augmentor)
    assert test_ds[0]["im2"].max() <= 1.0 and not seen
    train_ds = pds.fetch_dataset("middlebury", root, test=False, augmentor=augmentor)
    sample = train_ds[0]
    assert len(seen) == 1 and seen[0] > 1.0 and sample["im2_aug"].max() <= 1.0


def test_decoders_match_jax(tmp_path, monkeypatch):
    """Each decoder on the formats it reads, against the JAX package's,
    which decodes PNGs natively when its library loads: the library is
    built and loaded here whatever other processes do
    (`tests/test_torch_native.py`), and the port takes the decoder JAX
    took (PIL and the native decoder differ on a 16-bit PNG read as RGB)."""
    from stereoanywhere_tpu import native as jnative

    from stereoanywhere_tpu_torch import native as pnative
    from tests.test_torch_native import complete_jax_native

    if not complete_jax_native(monkeypatch):
        monkeypatch.setattr(pnative, "available", lambda: False)
    assert pnative.available() == jnative.available(), pnative.build_error()
    rng = np.random.default_rng(7)
    files = {
        "rgb.png": _rgb(rng),
        "rgba.png": rng.integers(0, 256, (H, W, 4), dtype=np.uint8),
        "gray.png": rng.integers(0, 256, (H, W), dtype=np.uint8),
        "u16.png": rng.integers(0, 65536, (H, W), dtype=np.uint16),
    }
    for name, arr in files.items():
        _png(str(tmp_path / name), arr)
    for name in files:
        p = str(tmp_path / name)
        for fn in ("read_image",) + (("read_gray16", "read_kitti_disparity", "read_depth_mm", "read_mono16")
                                     if name == "u16.png" else ()):
            want, got = getattr(jfu, fn)(p), getattr(pfu, fn)(p)
            assert got.dtype == want.dtype and got.shape == want.shape, (name, fn)
            np.testing.assert_array_equal(got, want, err_msg=f"{fn}({name})")
    np.testing.assert_array_equal(pfu.read_gray16(str(tmp_path / "u16.png")), files["u16.png"].astype(np.float32))
    for shape in ((H, W), (H, W, 3)):
        x = rng.normal(0, 50, shape).astype(np.float32)
        pfu.write_pfm(str(tmp_path / "p.pfm"), x)
        jfu.write_pfm(str(tmp_path / "j.pfm"), x)
        assert (tmp_path / "p.pfm").read_bytes() == (tmp_path / "j.pfm").read_bytes()
        np.testing.assert_array_equal(pfu.read_pfm(str(tmp_path / "p.pfm")), jfu.read_pfm(str(tmp_path / "p.pfm")))
        np.testing.assert_array_equal(pfu.read_pfm(str(tmp_path / "p.pfm")), x)
    mono = rng.uniform(-0.1, 1.1, (H, W))
    pfu.write_mono16(str(tmp_path / "pm.png"), mono)
    jfu.write_mono16(str(tmp_path / "jm.png"), mono)
    np.testing.assert_array_equal(jfu.read_mono16(str(tmp_path / "pm.png")), jfu.read_mono16(str(tmp_path / "jm.png")))
    np.testing.assert_array_equal(pfu.read_mono16(str(tmp_path / "pm.png")), jfu.read_mono16(str(tmp_path / "pm.png")))
