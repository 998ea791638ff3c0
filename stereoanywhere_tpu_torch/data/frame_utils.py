"""Image and disparity decoders for the test-mode readers, on the host with
PIL and numpy: a copy of the JAX package's `data/frame_utils.py` without its
native C++ decoder, which the port has not yet.

Formats: PFM (reference `dataloaders/frame_utils.py:33-68`), KITTI 16-bit
disparity /256 (:109-112), 16-bit depth in millimetres /1000 (:114-117) and
16-bit mono-depth PNG /65535 (:137-138).  A 16-bit grey PNG opens in PIL as
mode "I;16" (or "I" in older releases); both give its integer values
unchanged, which the native decoder gives too.  Read as an RGB image, such
a PNG gives its high byte, as the native decoder does; PIL's
`convert("RGB")`, which the JAX package's own fallback takes, clips it to
255 instead.
"""
from __future__ import annotations

import re

import numpy as np
from PIL import Image


def read_pfm(path: str) -> np.ndarray:
    """Read a PFM file to float32 (H,W) or (H,W,3); PFM rows are bottom-up."""
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
    im = Image.open(path)
    if im.mode in _GREY16:
        high = (np.asarray(im).astype(np.uint32) >> 8).astype(np.uint8)
        return np.repeat(high[..., None], 3, axis=-1)
    return np.asarray(im.convert("RGB"))


def read_gray16(path: str) -> np.ndarray:
    """16-bit PNG as float32."""
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
