"""Dataset readers of the 9 benchmark datasets, numpy only: a copy of the
JAX package's `data/datasets.py`.

Sample dict contract (HWC numpy float32, the reference's
`dataloaders/*:load_sample` with the channels last):
  im2, im3           (H,W,3) in [0,1] at test time / uint8-scale at train
  im2_aug, im3_aug   the same arrays at test time
  gt, validgt        (H,W,1) positive disparity + validity
  gt_right, validgt_right
  maskocc            (H,W,1) 1 = occluded (optional)
  im2_mono, im3_mono (H,W,1) precomputed mono depth in [0,1] (optional)
  gt_depth           (H,W,1) metric depth (monotrap only)
  extra_info         str

Path layouts are the reference's (file:line cited per class), so the same
on-disk datasets work unchanged.  `mono_paths` names the files a reader
takes its precomputed mono depth from (`cli precompute-mono` writes them).
In train mode (`test=False`) images stay in uint8 scale and a reader given
an augmentor (`data/augmentor.py`) hands it each sample.
"""
from __future__ import annotations

import os
import pickle
from dataclasses import dataclass, field
from glob import glob
from os import path as osp
from typing import Any, Callable, Iterator, Sequence

import numpy as np
from PIL import Image

from stereoanywhere_tpu_torch.data import frame_utils as fu


Sample = dict[str, Any]


class BaseDataset:
    """Record-list dataset (reference base_dataset.py:11-81)."""

    def __init__(
        self,
        datapath: str,
        test: bool = True,
        overfit: bool = False,
        mono: str | None = None,
        multiplier: int = 1,
        scale_factor: float = 1.0,
        top_crop: int = 0,
        augmentor: Callable | None = None,
    ):
        self.augmentor = augmentor
        self.is_test = test
        self.mono = mono
        self.scale_factor = scale_factor
        self.top_crop = top_crop
        self.image_list: list = []
        self.extra_info: list = []
        self.load_data(datapath)
        if overfit:
            self.image_list = self.image_list[:1]
            self.extra_info = self.extra_info[:1]
        if multiplier > 1:
            self.image_list *= int(multiplier)
            self.extra_info *= int(multiplier)

    def load_data(self, datapath: str):
        raise NotImplementedError

    def load_sample(self, index: int) -> Sample:
        raise NotImplementedError

    def mono_paths(self, index: int, tag: str) -> tuple[str, str]:
        """The left and right precomputed mono-depth files of sample `index`
        that the reader opens with `mono=tag`."""
        raise NotImplementedError(f"{type(self).__name__} reads no precomputed mono depth")

    def __len__(self) -> int:
        return len(self.image_list)

    def __getitem__(self, index: int) -> Sample:
        return self.load_sample(index)

    def __add__(self, other: "BaseDataset") -> "ConcatDataset":
        return ConcatDataset([self, other])

    # -- helpers ---------------------------------------------------------
    @staticmethod
    def _gray2rgb(im: np.ndarray) -> np.ndarray:
        if im.ndim == 2:
            return np.tile(im[..., None], (1, 1, 3))
        return im[..., :3]

    def _img(self, path: str) -> np.ndarray:
        im = self._gray2rgb(fu.read_image(path).astype(np.float32))
        return im / 255.0 if self.is_test else im

    def _finalize(self, data: Sample, extra: str) -> Sample:
        data = self._rescale(data)
        if self.is_test or self.augmentor is None:
            data.setdefault("im2_aug", data["im2"])
            data.setdefault("im3_aug", data["im3"])
        else:
            data = self.augmentor(data)
        for k, v in list(data.items()):
            if isinstance(v, np.ndarray):
                data[k] = np.ascontiguousarray(v, dtype=np.float32)
        data["extra_info"] = extra
        return data

    def _rescale(self, data: Sample) -> Sample:
        """Divide resolution (and gt values) by scale_factor
        (reference base_dataset.py:44-59), linear for images / nearest for gt."""
        if self.scale_factor == 1:
            return data
        s = float(self.scale_factor)
        for k, v in list(data.items()):
            if not isinstance(v, np.ndarray):
                continue
            h, w = v.shape[:2]
            nw, nh = int(w / s), int(h / s)
            nearest = k in ("gt", "gt_right", "validgt", "validgt_right", "maskocc", "maskcat")
            sq = v[..., 0] if v.ndim == 3 and v.shape[2] == 1 else v
            mode = Image.NEAREST if nearest else Image.BILINEAR
            out = np.asarray(
                Image.fromarray(sq.astype(np.float32), mode="F").resize((nw, nh), mode)
            ) if sq.ndim == 2 else np.stack(
                [
                    np.asarray(Image.fromarray(sq[..., c].astype(np.float32), mode="F").resize((nw, nh), mode))
                    for c in range(sq.shape[2])
                ],
                axis=-1,
            )
            if out.ndim == 2:
                out = out[..., None]
            if k in ("gt", "gt_right"):
                out = out / s
            data[k] = out
        return data


class ConcatDataset:
    def __init__(self, datasets: Sequence):
        self.datasets = list(datasets)

    def __len__(self):
        return sum(len(d) for d in self.datasets)

    def __getitem__(self, index):
        for d in self.datasets:
            if index < len(d):
                return d[index]
            index -= len(d)
        raise IndexError

    def __add__(self, other):
        return ConcatDataset(self.datasets + [other])

    def mono_paths(self, index, tag):
        for d in self.datasets:
            if index < len(d):
                return d.mono_paths(index, tag)
            index -= len(d)
        raise IndexError


# ---------------------------------------------------------------------------
# SceneFlow family


class FlyingThingsDataset(BaseDataset):
    """reference flyingthings_dataset.py:10-80; gt = -PFM (negated at load)."""

    def load_data(self, datapath):
        for img in sorted(glob(osp.join(datapath, "image_clean/left/*.png"))):
            rec = [
                img.replace("image_clean", "disparity").replace("png", "pfm"),
                img,
                img.replace("left", "right"),
                img.replace("image_clean", "disparity").replace("png", "pfm").replace("left", "right"),
            ]
            if self.mono is not None:
                rec += list(self._mono_paths(img, self.mono))
            self.image_list.append(rec)
            self.extra_info.append(img.split("/")[-1])

    @staticmethod
    def _mono_paths(img, tag):
        return img.replace("left", f"left_{tag}"), img.replace("left", f"right_{tag}")

    def mono_paths(self, index, tag):
        return self._mono_paths(self.image_list[index][1], tag)

    def load_sample(self, index):
        rec = self.image_list[index]
        data: Sample = {"im2": self._img(rec[1]), "im3": self._img(rec[2])}
        if self.mono is not None:
            data["im2_mono"] = fu.read_mono16(rec[4])[..., None]
            data["im3_mono"] = fu.read_mono16(rec[5])[..., None]
        gt = -fu.read_pfm(rec[0])[..., None]
        data["gt"] = gt.astype(np.float32)
        data["validgt"] = ((gt > 0) & (gt < 5000)).astype(np.float32)
        if os.path.exists(rec[3]):
            gtr = fu.read_pfm(rec[3])[..., None]
        elif self.is_test:
            gtr = np.zeros_like(gt)
        else:
            raise ValueError("No right disparity available for training")
        data["gt_right"] = gtr.astype(np.float32)
        data["validgt_right"] = ((gtr > 0) & (gtr < 5000)).astype(np.float32)
        return self._finalize(data, self.extra_info[index])


class _CleanpassDataset(BaseDataset):
    """Shared Monkaa/Driving logic (reference monkaa_dataset.py, driving_dataset.py)."""

    GLOBS = ("", "", "", "")  # (im2, im3, gt2, gt3)

    def load_data(self, datapath):
        g = self.GLOBS
        im2 = sorted(glob(osp.join(datapath, g[0])))
        im3 = sorted(glob(osp.join(datapath, g[1])))
        gt2 = sorted(glob(osp.join(datapath, g[2])))
        gt3 = sorted(glob(osp.join(datapath, g[3])))
        assert len(im2) == len(im3) == len(gt2) == len(gt3)
        mono2 = mono3 = [None] * len(im2)
        if self.mono is not None:
            mono2 = sorted(glob(osp.join(datapath, g[0].replace("left", f"left_{self.mono}"))))
            mono3 = sorted(glob(osp.join(datapath, g[1].replace("right", f"right_{self.mono}"))))
            assert len(im2) == len(mono2) == len(mono3)
        for rec in zip(im2, im3, gt2, gt3, mono2, mono3):
            self.image_list.append(list(rec))
            self.extra_info.append(rec[0].split("/")[-1])

    def mono_paths(self, index, tag):
        """In `left_<tag>/` and `right_<tag>/` beside the views' folders,
        under the views' names, which the reader's globs sort alike."""
        rec = self.image_list[index]
        return tuple(osp.join(osp.dirname(osp.dirname(p)), f"{side}_{tag}", osp.basename(p))
                     for p, side in ((rec[0], "left"), (rec[1], "right")))

    def load_sample(self, index):
        rec = self.image_list[index]
        data: Sample = {"im2": self._img(rec[0]), "im3": self._img(rec[1])}
        if self.mono is not None:
            data["im2_mono"] = fu.read_mono16(rec[4])[..., None]
            data["im3_mono"] = fu.read_mono16(rec[5])[..., None]
        gt = np.abs(fu.read_pfm(rec[2]))[..., None]
        data["gt"] = gt.astype(np.float32)
        data["validgt"] = ((gt > 0) & (gt < 5000)).astype(np.float32)
        if os.path.exists(rec[3]):
            gtr = np.abs(fu.read_pfm(rec[3]))[..., None]
        else:
            gtr = np.zeros_like(gt)
        data["gt_right"] = gtr.astype(np.float32)
        data["validgt_right"] = ((gtr > 0) & (gtr < 5000)).astype(np.float32)
        return self._finalize(data, self.extra_info[index])


class MonkaaDataset(_CleanpassDataset):
    GLOBS = (
        "frames_cleanpass/*/left/*.png",
        "frames_cleanpass/*/right/*.png",
        "disparity/*/left/*.pfm",
        "disparity/*/right/*.pfm",
    )


class DrivingDataset(_CleanpassDataset):
    GLOBS = (
        "frames_cleanpass/*/*/slow/left/*.png",
        "frames_cleanpass/*/*/slow/right/*.png",
        "disparity/*/*/slow/left/*.pfm",
        "disparity/*/*/slow/right/*.pfm",
    )


# ---------------------------------------------------------------------------
# Benchmarks


class MiddleburyDataset(BaseDataset):
    """Middlebury 2014 / ETH3D layout (reference middlebury_dataset.py:10-88)."""

    GT0, GT1 = "disp0GT.pfm", "disp1GT.pfm"

    def load_data(self, datapath):
        for img in sorted(glob(osp.join(datapath, "*/im0.png"))):
            for im1 in ("im1", "im1E", "im1L"):
                right = img.replace("im0", im1)
                if os.path.exists(right):
                    rec = [
                        img.replace("im0.png", self.GT0),
                        img,
                        right,
                        img.replace("im0.png", "mask0nocc.png"),
                        img.replace("im0.png", self.GT1),
                    ]
                    if self.mono is not None:
                        rec += list(self._mono_paths(img, im1, self.mono))
                    self.image_list.append(rec)
                    self.extra_info.append(img.split("/")[-2])

    @staticmethod
    def _mono_paths(img, im1, tag):
        return img.replace("im0.png", f"im0_{tag}.png"), img.replace("im0.png", f"{im1}_{tag}.png")

    def mono_paths(self, index, tag):
        rec = self.image_list[index]
        return self._mono_paths(rec[1], osp.basename(rec[2])[: -len(".png")], tag)

    def load_sample(self, index):
        rec = self.image_list[index]
        data: Sample = {"im2": self._img(rec[1]), "im3": self._img(rec[2])}
        if self.mono is not None:
            data["im2_mono"] = fu.read_mono16(rec[5])[..., None]
            data["im3_mono"] = fu.read_mono16(rec[6])[..., None]
        gt = fu.read_pfm(rec[0])[..., None]
        gt[~np.isfinite(gt)] = 0
        data["gt"] = gt.astype(np.float32)
        data["validgt"] = ((gt > 0) & (gt < 5000)).astype(np.float32)
        if os.path.exists(rec[4]):
            gtr = fu.read_pfm(rec[4])[..., None]
            gtr[~np.isfinite(gtr)] = 0
        else:
            gtr = np.zeros_like(gt)
        data["gt_right"] = gtr.astype(np.float32)
        data["validgt_right"] = ((gtr > 0) & (gtr < 5000)).astype(np.float32)
        if self.is_test and os.path.exists(rec[3]):
            m = fu.read_image(rec[3])[..., :1]
            data["maskocc"] = (m == 128).astype(np.float32)
        return self._finalize(data, self.extra_info[index])


class Middlebury2021Dataset(MiddleburyDataset):
    """disp0/disp1.pfm layout (reference middlebury2021_dataset.py:10-40)."""

    GT0, GT1 = "disp0.pfm", "disp1.pfm"


class KITTIStereoDataset(BaseDataset):
    """KITTI 2012/2015 (reference kittistereo_dataset.py:10-102).

    maskocc = occluded-but-valid = validgt(occ) minus noc."""

    def load_data(self, datapath):
        for img in sorted(glob(osp.join(datapath, "image_2/*_10.png"))):
            rec = [
                img.replace("image_2", "disp_occ_0"),
                img,
                img.replace("image_2", "image_3"),
                img.replace("image_2", "disp_noc_0"),
            ]
            if self.mono is not None:
                rec += list(self._mono_paths(img, self.mono))
            self.image_list.append(rec)
            self.extra_info.append(img.split("/")[-1])

    @staticmethod
    def _mono_paths(img, tag):
        return img.replace("image_2", f"{tag}_2"), img.replace("image_2", f"{tag}_3")

    def mono_paths(self, index, tag):
        return self._mono_paths(self.image_list[index][1], tag)

    def load_sample(self, index):
        rec = self.image_list[index]
        data: Sample = {"im2": self._img(rec[1]), "im3": self._img(rec[2])}
        if self.mono is not None:
            data["im2_mono"] = fu.read_mono16(rec[4])[..., None]
            data["im3_mono"] = fu.read_mono16(rec[5])[..., None]
        if os.path.exists(rec[0]):
            gt = fu.read_kitti_disparity(rec[0])[..., None]
        else:
            gt = np.zeros_like(data["im2"][..., :1])
        valid = (gt > 0).astype(np.float32)
        if os.path.exists(rec[3]):
            noc = (fu.read_kitti_disparity(rec[3])[..., None] > 0).astype(np.float32)
        else:
            noc = np.zeros_like(valid)
        data["gt"] = gt.astype(np.float32)
        data["validgt"] = valid
        if self.is_test:
            data["maskocc"] = ((valid > 0) & (valid - noc > 0)).astype(np.float32)
        data["gt_right"] = np.zeros_like(gt)
        data["validgt_right"] = np.zeros_like(valid)
        if self.top_crop > 0:
            for k, v in list(data.items()):
                if isinstance(v, np.ndarray):
                    data[k] = v[self.top_crop :]
        return self._finalize(data, self.extra_info[index])


class BoosterDataset(BaseDataset):
    """Booster balanced split (reference booster_dataset.py:10-88)."""

    def load_data(self, datapath):
        im2 = sorted(glob(osp.join(datapath, "balanced/*/camera_00/*.png")))
        im3 = sorted(glob(osp.join(datapath, "balanced/*/camera_02/*.png")))
        assert len(im2) == len(im3), "Different number of images"
        for a, b in zip(im2, im3):
            d = osp.dirname(a).replace("camera_00", "")
            rec = [a, b, osp.join(d, "disp_00.npy"), osp.join(d, "disp_02.npy"), osp.join(d, "mask_00.png"), osp.join(d, "mask_cat.png")]
            if self.mono is not None:
                rec += list(self._mono_paths(a, b, self.mono))
            self.image_list.append(rec)
            self.extra_info.append(a)

    @staticmethod
    def _mono_paths(a, b, tag):
        return a.replace("camera_00", f"camera_00_{tag}"), b.replace("camera_02", f"camera_02_{tag}")

    def mono_paths(self, index, tag):
        return self._mono_paths(*self.image_list[index][:2], tag)

    def load_sample(self, index):
        rec = self.image_list[index]
        data: Sample = {"im2": self._img(rec[0]), "im3": self._img(rec[1])}
        if self.mono is not None:
            data["im2_mono"] = fu.read_mono16(rec[6])[..., None]
            data["im3_mono"] = fu.read_mono16(rec[7])[..., None]
        gt = np.load(rec[2])[..., None].astype(np.float32)
        data["gt"] = gt
        data["validgt"] = (gt > 0).astype(np.float32)
        data["gt_right"] = np.zeros_like(gt)
        data["validgt_right"] = np.zeros_like(gt)
        if self.is_test and os.path.exists(rec[4]):
            m = np.asarray(fu.read_image(rec[4]))[..., :1]
            data["maskocc"] = (m == 0).astype(np.float32)  # 0 = occluded
        return self._finalize(data, self.extra_info[index])


class LayeredFlowDataset(BaseDataset):
    """Sparse annotated point pairs, first layer only, |dy|<=2
    (reference layeredflow_dataset.py:10-76)."""

    def load_data(self, datapath):
        scenes = sorted(glob(osp.join(datapath) + "/*"), key=lambda x: int(x.split("/")[-1]))
        for i, scene in enumerate(scenes):
            gt = f"{scene}/gt.pickle"
            self.image_list.append([f"{scene}/0_0.png", f"{scene}/0_1.png", gt, (0, 1)])
            self.extra_info.append(f"{i}_0")
            self.image_list.append([f"{scene}/3_0.png", f"{scene}/3_1.png", gt, (2, 3)])
            self.extra_info.append(f"{i}_3")

    def load_sample(self, index):
        rec = self.image_list[index]
        data: Sample = {"im2": self._img(rec[0]), "im3": self._img(rec[1])}
        gt = np.zeros(data["im2"].shape[:2], np.float32)
        ann = pickle.load(open(rec[2], "rb"))
        pts, annots = ann["stereo_points"], ann["annotations"]
        i0, i1 = rec[3]
        for p1, p2 in zip(pts[i0], pts[i1]):
            if (p1[0], p1[1]) == (p2[0], p2[1]) and annots[(p1[0], p1[1])][2] == 0:
                (x1, y1), (x2, y2) = p1[2], p2[2]
                if abs(y2 - y1) <= 2:
                    gt[int(y1), int(x1)] = np.linalg.norm([x2 - x1, y2 - y1])
        data["gt"] = gt[..., None]
        data["validgt"] = (gt > 0).astype(np.float32)[..., None]
        data["gt_right"] = np.zeros_like(data["gt"])
        data["validgt_right"] = np.zeros_like(data["validgt"])
        return self._finalize(data, self.extra_info[index])


class MonoTrapDataset(BaseDataset):
    """MonoTrap mirror benchmark (reference monotrap_dataset.py:10-81).

    Depth conversion constants for eval: baseline=0.075 m, focal=450.0488 px
    (reference test_monotrap.py:246-250)."""

    BASELINE = 0.075
    FOCAL = 450.0488

    def load_data(self, datapath):
        for img in sorted(glob(osp.join(datapath, "*/left_rect/*.png"))):
            self.image_list.append(
                [
                    img,
                    img.replace("left_rect", "right_rect"),
                    img.replace("left_rect", "gt_disp"),
                    img.replace("left_rect", "gt_depth"),
                    img.replace("left_rect", "gt_mask"),
                ]
            )
            self.extra_info.append(img.split("/")[-1])

    def load_sample(self, index):
        rec = self.image_list[index]
        data: Sample = {"im2": self._img(rec[0]), "im3": self._img(rec[1])}
        mask = fu.read_image(rec[4])[..., 0]
        gt = fu.read_kitti_disparity(rec[2])[..., None]
        depth = fu.read_depth_mm(rec[3])[..., None]
        keep = (mask >= 128)[..., None]
        data["gt"] = np.where(keep, gt, 0).astype(np.float32)
        data["validgt"] = ((gt > 0) & keep).astype(np.float32)
        data["gt_depth"] = np.where(keep, depth, 0).astype(np.float32)
        data["validgt_depth"] = ((depth > 0) & keep).astype(np.float32)
        data["gt_right"] = np.zeros_like(data["gt"])
        data["validgt_right"] = np.zeros_like(data["gt"])
        return self._finalize(data, self.extra_info[index])


# ---------------------------------------------------------------------------

DATASETS = {
    "kitti_stereo": KITTIStereoDataset,
    "kitti2012": KITTIStereoDataset,
    "kitti2015": KITTIStereoDataset,
    "middlebury": MiddleburyDataset,
    "eth3d": MiddleburyDataset,
    "middlebury2021": Middlebury2021Dataset,
    "booster": BoosterDataset,
    "layeredflow": LayeredFlowDataset,
    "monotrap": MonoTrapDataset,
    "flyingthings": FlyingThingsDataset,
    "monkaa": MonkaaDataset,
    "driving": DrivingDataset,
}


def fetch_dataset(
    name: str,
    datapath: str,
    test: bool = True,
    overfit: bool = False,
    mono: str | None = None,
    augmentor: Callable | None = None,
    **kw,
):
    """Dataset dispatch (reference dataloaders/__init__.py:23-72).

    `sceneflow` concatenates FlyingThings+Monkaa+Driving over ';'-separated
    datapaths; any other name accepts ';'-separated paths too.
    """
    if name == "sceneflow":
        paths = datapath.split(";")
        parts = [
            FlyingThingsDataset(paths[0], test=test, overfit=overfit, mono=mono, augmentor=augmentor, **kw),
            MonkaaDataset(paths[1], test=test, overfit=overfit, mono=mono, augmentor=augmentor, **kw),
            DrivingDataset(paths[2], test=test, overfit=overfit, mono=mono, augmentor=augmentor, **kw),
        ]
        ds = parts[0]
        for p in parts[1:]:
            ds = ds + p
        return ds
    cls = DATASETS[name]
    paths = datapath.split(";")
    ds = cls(paths[0], test=test, overfit=overfit, mono=mono, augmentor=augmentor, **kw)
    for p in paths[1:]:
        ds = ds + cls(p, test=test, overfit=overfit, mono=mono, augmentor=augmentor, **kw)
    return ds
