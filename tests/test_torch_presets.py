"""Tile presets, the memory-driven tiling and the non-Lambertian mask: the
port's `parallel/presets.py` and `parallel/non_lambertian.py` against the
JAX package's, on the CPU.  Every comparison is exact (the same integer
and float64 arithmetic), except `non_lambertian_mask`, whose float32 mean
is taken the same way on both sides and is held equal too."""
import numpy as np
import pytest

from stereoanywhere_tpu.parallel import presets as jp

from stereoanywhere_tpu_torch.parallel import presets as pp

GIB = 1 << 30


def test_tile_presets_match_jax():
    assert pp.TILE_PRESETS.keys() == jp.TILE_PRESETS.keys()
    for k, v in jp.TILE_PRESETS.items():
        got = pp.TILE_PRESETS[k]
        assert (got.n_tiles, got.overlap, got.iscale) == (v.n_tiles, v.overlap, v.iscale), k


@pytest.mark.parametrize("name", sorted(jp.TILE_PRESETS) + ["Booster_balanced", "middlebury2021_H", "kitti_2015",
                                                            "ETH3D", "unknown", "sceneflow"])
def test_get_preset_for_dataset_matches_jax(name):
    got, want = pp.get_preset_for_dataset(name), jp.get_preset_for_dataset(name)
    assert (got.n_tiles, got.overlap) == (want.n_tiles, want.overlap)


def test_preset_overlap_must_be_a_multiple_of_32():
    with pytest.raises(ValueError):
        pp.TilePreset(n_tiles=2, overlap=48)
    with pytest.raises(ValueError):
        jp.TilePreset(n_tiles=2, overlap=48)


@pytest.mark.parametrize("h,w", [(375, 1242), (1024, 1024), (2016, 2976), (3008, 4112), (480, 640), (256, 256)])
@pytest.mark.parametrize("free,n_devices", [(80 * GIB, 1), (16 * GIB, 1), (4 * GIB, 1), (12 * GIB, 4), (GIB, 1)])
def test_select_tiling_parameters_matches_jax(h, w, free, n_devices):
    got = pp.select_tiling_parameters(h, w, hbm_bytes_free=free, n_devices=n_devices)
    want = jp.select_tiling_parameters(h, w, hbm_bytes_free=free, n_devices=n_devices)
    assert (got.n_tiles, got.overlap) == (want.n_tiles, want.overlap)


def test_select_tiling_parameters_needs_the_card_or_the_bytes(monkeypatch):
    """Without a card and without free bytes given it raises: no guess."""
    monkeypatch.setattr(pp.torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        pp.select_tiling_parameters(3008, 4112)


def test_otsu_threshold_matches_jax():
    """The bimodal case of `tests/test_extras.py::test_otsu_bimodal`."""
    from stereoanywhere_tpu.parallel.non_lambertian import otsu_threshold as jotsu

    from stereoanywhere_tpu_torch.parallel.non_lambertian import otsu_threshold

    rng = np.random.default_rng(0)
    a = np.clip(rng.normal(0.2, 0.03, 5000), 0, 1)
    b = np.clip(rng.normal(0.8, 0.03, 5000), 0, 1)
    x = np.concatenate([a, b])
    th = otsu_threshold(x)
    assert th == jotsu(x)
    assert ((a < th).mean() + (b > th).mean()) / 2 > 0.97
    assert otsu_threshold(np.zeros((0,))) == jotsu(np.zeros((0,))) == 0.5


def _u8_cases():
    rng = np.random.default_rng(4)
    return {
        "uniform": rng.integers(0, 256, (96, 128)).astype(np.uint8),
        "bimodal": np.clip(np.where(rng.random((80, 60)) < 0.3, rng.normal(40, 12, (80, 60)),
                                    rng.normal(190, 20, (80, 60))), 0, 255).astype(np.uint8),
        "narrow": np.clip(rng.normal(60, 3, (50, 70)), 0, 255).astype(np.uint8),
        "constant": np.full((32, 48), 7, np.uint8),
        "two values": np.where(rng.random((40, 40)) < 0.7, 10, 200).astype(np.uint8),
        "extremes": np.where(rng.random((16, 16)) < 0.5, 0, 255).astype(np.uint8),
    }


@pytest.mark.parametrize("case", sorted(_u8_cases()))
def test_uint8_otsu_matches_the_native_library(case, monkeypatch):
    """`otsu_threshold_u8` against `native/stereodata.cc`'s
    `sd_otsu_threshold`, threshold and mask equal (the library built and
    loaded whatever other processes do: `tests/test_torch_native.py`)."""
    from stereoanywhere_tpu import native

    from stereoanywhere_tpu_torch.parallel.non_lambertian import otsu_threshold_u8
    from tests.test_torch_native import need_jax_native

    need_jax_native(monkeypatch)
    img = _u8_cases()[case]
    thr, mask = native.otsu_mask(img)
    assert otsu_threshold_u8(img) == thr
    np.testing.assert_array_equal((img > otsu_threshold_u8(img)).astype(np.uint8) * 255, mask)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_non_lambertian_mask_matches_jax(seed, monkeypatch):
    """JAX takes the native uint8 Otsu when the library is built and its
    float histogram otherwise; the port always takes the uint8 one, so the
    two are held equal where JAX has the library (built and loaded here
    unless it cannot be built), and the port's mask is checked against its
    own definition either way."""
    from stereoanywhere_tpu import native
    from stereoanywhere_tpu.parallel.non_lambertian import non_lambertian_mask as jmask

    from stereoanywhere_tpu_torch.parallel.non_lambertian import non_lambertian_mask, otsu_threshold_u8
    from tests.test_torch_native import complete_jax_native

    complete_jax_native(monkeypatch)

    rng = np.random.default_rng(seed)
    im2 = rng.uniform(0, 1, (48, 64, 3)).astype(np.float32)
    im3 = im2.copy()
    im3[10:30, 20:50] = rng.uniform(0, 1, (20, 30, 3))  # a photometrically inconsistent patch
    got = non_lambertian_mask(im2, im3)
    assert got.dtype == np.float32 and got.shape == (48, 64)
    diff = np.abs(im2.mean(-1) - im3.mean(-1))
    u8 = np.round(diff / max(diff.max(), 1e-6) * 255).astype(np.uint8)
    np.testing.assert_array_equal(got, (u8 > otsu_threshold_u8(u8)).astype(np.float32))
    assert got[10:30, 20:50].mean() > 0.5 and got[30:].sum() == 0
    if native.available():
        np.testing.assert_array_equal(got, jmask(im2, im3))


def test_non_lambertian_processor_analyze():
    from stereoanywhere_tpu_torch.models import StereoAnywhere
    from stereoanywhere_tpu_torch.parallel.non_lambertian import NonLambertianProcessor, non_lambertian_mask

    rng = np.random.default_rng(7)
    im2, im3 = (rng.uniform(0, 1, (32, 40, 3)).astype(np.float32) for _ in range(2))
    proc = NonLambertianProcessor(StereoAnywhere(device="cpu"), 2, overlap=32, iters=1, device="cpu")
    out = proc.analyze(im2, im3)
    np.testing.assert_array_equal(out["mask"], non_lambertian_mask(im2, im3))
    assert out["coverage"] == float(out["mask"].mean())
