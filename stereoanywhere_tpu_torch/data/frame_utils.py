"""Image and disparity decoders of the readers, on the host: a copy of the
JAX package's `data/frame_utils.py`.

Formats: PFM (reference `dataloaders/frame_utils.py:33-68`), KITTI 16-bit
disparity /256 (:109-112), 16-bit depth in millimetres /1000 (:114-117),
16-bit mono-depth PNG /65535 (:137-138), npy, EXR depth to disparity
(:124-129, through the scanline codec of `data/exr.py`) and the generic
`read_gen`.

Decoding goes through the native library (`stereoanywhere_tpu_torch.native`:
libpng, libjpeg, no GIL) where it is built, as the JAX package's does, and
through PIL and numpy otherwise.  A 16-bit grey PNG opens in PIL as mode
"I;16" (or "I" in older releases); both give its integer values unchanged,
which the native decoder gives too.  Read as an RGB image, such a PNG gives
its high byte, as the native decoder does; PIL's `convert("RGB")`, which the
JAX package's own fallback takes, clips it to 255 instead.
"""
from __future__ import annotations

import re
from pathlib import Path

import numpy as np
from PIL import Image

from stereoanywhere_tpu_torch import native


def read_pfm(path: str) -> np.ndarray:
    """Read a PFM file to float32 (H,W) or (H,W,3); PFM rows are bottom-up."""
    if native.available():
        return native.read_pfm(path)
    with open(path, "rb") as f:
        header = f.readline().rstrip()
        if header == b"PF":
            color = True
        elif header == b"Pf":
            color = False
        else:
            raise ValueError(f"Not a PFM file: {path}")

        dims = f.readline()
        while dims.startswith(b"#"):
            dims = f.readline()
        m = re.match(rb"^(\d+)\s(\d+)\s*$", dims)
        if not m:
            raise ValueError(f"Malformed PFM header: {path}")
        width, height = int(m.group(1)), int(m.group(2))

        scale = float(f.readline().rstrip())
        endian = "<" if scale < 0 else ">"

        data = np.fromfile(f, endian + "f")
    shape = (height, width, 3) if color else (height, width)
    return np.reshape(data, shape)[::-1].astype(np.float32).copy()


def write_pfm(path: str, image: np.ndarray, scale: float = 1.0) -> None:
    image = np.asarray(image, np.float32)
    color = image.ndim == 3 and image.shape[2] == 3
    with open(path, "wb") as f:
        f.write(b"PF\n" if color else b"Pf\n")
        f.write(f"{image.shape[1]} {image.shape[0]}\n".encode())
        endian = image.dtype.byteorder
        if endian == "<" or (endian == "=" and np.little_endian):
            scale = -scale
        f.write(f"{scale}\n".encode())
        image[::-1].tofile(f)


_GREY16 = ("I;16", "I;16B", "I;16L", "I")


def read_image(path: str) -> np.ndarray:
    """RGB uint8 (H,W,3); a 16-bit grey image gives its high byte."""
    ext = Path(path).suffix.lower()
    if native.available() and ext in (".png", ".jpg", ".jpeg"):
        arr = native.read_png(path) if ext == ".png" else native.read_jpeg(path)
        if arr.dtype == np.uint16:
            arr = (arr >> 8).astype(np.uint8)
        if arr.ndim == 2:
            arr = np.repeat(arr[..., None], 3, axis=-1)
        if arr.shape[-1] == 4:  # drop alpha, as PIL's convert("RGB")
            arr = arr[..., :3]
        return np.ascontiguousarray(arr)
    im = Image.open(path)
    if im.mode in _GREY16:
        high = (np.asarray(im).astype(np.uint32) >> 8).astype(np.uint8)
        return np.repeat(high[..., None], 3, axis=-1)
    return np.asarray(im.convert("RGB"))


def read_gray16(path: str) -> np.ndarray:
    """16-bit PNG as float32."""
    if native.available() and str(path).lower().endswith(".png"):
        arr = native.read_png(path)
        if arr.ndim == 3:
            arr = arr[..., 0]
        return arr.astype(np.float32)
    return np.asarray(Image.open(path), dtype=np.float32)


def read_kitti_disparity(path: str) -> np.ndarray:
    """KITTI 16-bit disparity PNG: value/256, 0 = invalid (reference :109-112)."""
    return read_gray16(path) / 256.0


def read_depth_mm(path: str) -> np.ndarray:
    """16-bit depth PNG in millimeters -> meters (reference :114-117)."""
    return read_gray16(path) / 1000.0


def read_mono16(path: str) -> np.ndarray:
    """16-bit normalized mono-depth PNG -> [0,1] (reference :137-138)."""
    return read_gray16(path) / 65535.0


def write_mono16(path: str, mono01: np.ndarray) -> None:
    arr = np.clip(mono01 * 65535.0, 0, 65535).astype(np.uint16)
    Image.fromarray(arr).save(path)


def read_depth_exr(path: str, focal: float, baseline: float):
    """EXR depth -> (disparity, valid) via disp = f*b/z (reference
    frame_utils.py:124-129 readDepthEXR)."""
    from stereoanywhere_tpu_torch.data.exr import read_depth_exr as _impl

    return _impl(path, focal, baseline)


def read_gen(path: str) -> np.ndarray:
    """Generic reader by extension (reference frame_utils.py:140-155)."""
    ext = Path(path).suffix.lower()
    if ext in (".png", ".jpeg", ".ppm", ".jpg", ".bmp"):
        return read_image(path)
    if ext == ".pfm":
        return read_pfm(path)
    if ext == ".npy":
        return np.load(path)
    if ext == ".exr":
        from stereoanywhere_tpu_torch.data.exr import read_exr

        chans = read_exr(path)
        key = "Z" if "Z" in chans else sorted(chans)[0]
        return chans[key].astype(np.float32)
    raise ValueError(f"unsupported extension: {path}")
