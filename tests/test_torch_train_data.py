"""The port's training data path against the JAX package's, on the CPU:
the augmentor, the prefetch loader and the train-mode readers with an
augmentor, each held equal bit for bit (they are copies: the same numpy and
PIL operations on the same draws)."""
import os

import numpy as np
import pytest
from PIL import Image

from stereoanywhere_tpu.data import augmentor as jaug
from stereoanywhere_tpu.data import datasets as jds
from stereoanywhere_tpu.data import frame_utils as jfu
from stereoanywhere_tpu.data import loader as jloader

from stereoanywhere_tpu_torch.data import augmentor as paug
from stereoanywhere_tpu_torch.data import datasets as pds
from stereoanywhere_tpu_torch.data import loader as ploader


def _equal(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k, va in a.items():
        if isinstance(va, np.ndarray):
            assert va.dtype == b[k].dtype and va.shape == b[k].shape, k
            np.testing.assert_array_equal(b[k], va, err_msg=k)
        else:
            assert va == b[k], k


def _sample(rng, h, w, mono=True):
    s = {
        "im2": rng.integers(0, 256, (h, w, 3)).astype(np.float32),
        "im3": rng.integers(0, 256, (h, w, 3)).astype(np.float32),
        "gt": rng.uniform(0, 40, (h, w, 1)).astype(np.float32),
        "validgt": (rng.uniform(0, 1, (h, w, 1)) > 0.2).astype(np.float32),
        "gt_right": rng.uniform(0, 40, (h, w, 1)).astype(np.float32),
        "validgt_right": (rng.uniform(0, 1, (h, w, 1)) > 0.2).astype(np.float32),
    }
    if mono:
        s["im2_mono"] = rng.uniform(0, 1, (h, w, 1)).astype(np.float32)
        s["im3_mono"] = rng.uniform(0, 1, (h, w, 1)).astype(np.float32)
    return s


@pytest.mark.parametrize("seed,shape,crop,mono", [
    (0, (72, 120), (48, 96), True), (1, (96, 96), (64, 64), False), (7, (60, 150), (40, 128), True),
    (1337, (100, 140), (64, 96), True),
])
def test_augmentor_matches_jax_bit_for_bit(seed, shape, crop, mono):
    """Eight samples through each package's augmentor, same seed: every
    output array equal (spatial zoom and stretch, flips with the view swap,
    the crop, the photometric jitter, symmetric or not)."""
    rng = np.random.default_rng(seed + 100)
    a, b = jaug.DisparityAugmentor(crop_size=crop, seed=seed), paug.DisparityAugmentor(crop_size=crop, seed=seed)
    for _ in range(8):
        s = _sample(rng, *shape, mono=mono)
        _equal(a(dict(s)), b(dict(s)))


class _Toy:
    """A dataset whose samples depend only on their index."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        s = _sample(np.random.default_rng(i), 6, 8, mono=i % 2 == 0)
        return {**s, "im2_aug": s["im2"] / 255.0, "im3_aug": s["im3"] / 255.0}


@pytest.mark.parametrize("threads", [0, 2])
@pytest.mark.parametrize("start,shards", [(0, 1), (3, 1), (2, 2)])
def test_prefetch_loader_matches_jax(threads, start, shards):
    """The same steps and batches from `start_step`, and with two input
    shards each shard's slice of the global batch; 0 and 2 worker threads."""
    ds = _Toy(7)
    for shard in range(shards):
        kw = dict(batch_size=4, total_steps=6, seed=5, start_step=start, num_threads=threads,
                  shard_index=shard, shard_count=shards)
        with jloader.PrefetchLoader(ds, **kw) as a, ploader.PrefetchLoader(ds, **kw) as b:
            got, want = list(b), list(a)
        assert [s for s, _ in got] == [s for s, _ in want] == list(range(start, 6))
        for (_, x), (_, y) in zip(got, want):
            _equal(y, x)
            assert x["im2_aug"].shape[0] == 4 // shards


def _flyingthings(root, rng, n=3, h=80, w=112):
    for i in range(n):
        name = f"{i:07d}"
        for side in ("left", "right"):
            path = f"{root}/image_clean/{side}/{name}.png"
            os.makedirs(os.path.dirname(path), exist_ok=True)
            Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(path)
            mono = f"{root}/image_clean/{side}_DAv2/{name}.png"
            os.makedirs(os.path.dirname(mono), exist_ok=True)
            jfu.write_mono16(mono, rng.uniform(0, 1, (h, w)))
            gt = rng.uniform(0, 60, (h, w)).astype(np.float32)
            os.makedirs(f"{root}/disparity/{side}", exist_ok=True)
            jfu.write_pfm(f"{root}/disparity/{side}/{name}.pfm", -gt if side == "left" else gt)


@pytest.mark.parametrize("mono", [None, "DAv2"])
def test_train_readers_with_the_augmentor_match_jax(tmp_path, mono):
    """`sceneflow` in train mode (uint8-scale images) through each package's
    augmentor with the same seed, and through the collate the trainer's
    loader uses: equal bit for bit."""
    rng = np.random.default_rng(2)
    roots = [str(tmp_path / n) for n in ("ft", "monkaa", "driving")]
    _flyingthings(roots[0], rng)
    path = ";".join(roots)
    kw = dict(test=False, mono=mono)
    a = jds.fetch_dataset("sceneflow", path, augmentor=jaug.DisparityAugmentor(crop_size=(48, 96), seed=3), **kw)
    b = pds.fetch_dataset("sceneflow", path, augmentor=paug.DisparityAugmentor(crop_size=(48, 96), seed=3), **kw)
    assert len(a) == len(b) == 3
    samples = []
    for i in range(3):
        sa, sb = a[i], b[i]
        _equal(sa, sb)
        assert sb["im2_aug"].shape == (48, 96, 3) and sb["im2_aug"].max() <= 1.0
        samples.append((sa, sb))
    _equal(jloader.default_collate([s for s, _ in samples]), ploader.default_collate([s for _, s in samples]))


def test_flyingthings_training_needs_the_right_disparity(tmp_path):
    rng = np.random.default_rng(4)
    root = str(tmp_path / "ft")
    _flyingthings(root, rng, n=1)
    os.remove(f"{root}/disparity/right/0000000.pfm")
    ds = pds.FlyingThingsDataset(root, test=False, augmentor=paug.DisparityAugmentor(crop_size=(48, 96), seed=0))
    with pytest.raises(ValueError, match="No right disparity"):
        ds[0]
