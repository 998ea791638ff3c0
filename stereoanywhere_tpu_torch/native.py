"""ctypes bindings of the native host-side data library, `native/stereodata.cc`
at the root of the repository: PNG, JPEG and PFM decoding (libpng, libjpeg),
a PFM writer, the z-buffer warps, the background infill and the uint8 Otsu
threshold, all without the GIL.

The port's own copy of the JAX package's loader.  It compiles the same
source with the same g++ line into `build/torch_native/` at the root of the
checkout, under a name that carries a digest of the source and the flags
(an edited source builds anew), and never writes beside the source.  The
build runs at the first use, once a process.  `available()` is False only
when the build (or the load) failed; `build_error()` then holds the
compiler's message.  The readers in `data/frame_utils.py` and the warps in
`data/warps.py` take this library where it is available and their numpy /
PIL forms otherwise, as the JAX package's do.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
SOURCE = REPO / "native" / "stereodata.cc"
BUILD_DIR = REPO / "build" / "torch_native"
CXX_FLAGS = ("-O2", "-fPIC", "-shared", "-fvisibility=hidden")
LIBS = ("-lpng", "-ljpeg", "-lz")

_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None
_ERROR: str | None = None
_TRIED = False


class _SDImage(ctypes.Structure):
    _fields_ = [
        ("data", ctypes.c_void_p),
        ("h", ctypes.c_int64),
        ("w", ctypes.c_int64),
        ("c", ctypes.c_int64),
        ("dtype", ctypes.c_int32),
    ]


_DTYPES = {0: np.uint8, 1: np.uint16, 2: np.float32}


def library_path() -> Path:
    h = hashlib.sha1(" ".join(CXX_FLAGS + LIBS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libstereodata-{h.hexdigest()[:12]}.so"


def _build() -> Path:
    """The built library's path; raises RuntimeError with the compiler's
    message when it cannot be built."""
    if not SOURCE.exists():
        raise RuntimeError(f"the native source {SOURCE} is not in this checkout")
    so = library_path()
    if so.exists():
        return so
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    out = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE), *LIBS],
                         capture_output=True, text=True, timeout=120)
    if out.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed (exit {out.returncode}):\n{out.stderr.strip()}")
    os.replace(tmp, so)
    return so


def _bind(L: ctypes.CDLL) -> ctypes.CDLL:
    L.sd_last_error.argtypes = []
    L.sd_last_error.restype = ctypes.c_char_p
    L.sd_free.argtypes = [ctypes.c_void_p]
    L.sd_free.restype = None
    for name in ("sd_read_pfm", "sd_read_png", "sd_read_jpeg"):
        fn = getattr(L, name)
        fn.argtypes = [ctypes.c_char_p, ctypes.POINTER(_SDImage)]
        fn.restype = ctypes.c_int
    f32p = ctypes.POINTER(ctypes.c_float)
    L.sd_write_pfm.argtypes = [ctypes.c_char_p, f32p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64]
    L.sd_write_pfm.restype = ctypes.c_int
    L.sd_warp_depth.argtypes = [f32p, f32p, f32p, ctypes.c_int64, ctypes.c_int64]
    L.sd_warp_disparity.argtypes = [f32p, f32p, ctypes.c_int64, ctypes.c_int64]
    L.sd_interpolate_background.argtypes = [f32p, ctypes.c_int64, ctypes.c_int64]
    for name in ("sd_warp_depth", "sd_warp_disparity", "sd_interpolate_background"):
        getattr(L, name).restype = None
    L.sd_otsu_threshold.argtypes = [ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.POINTER(ctypes.c_uint8)]
    L.sd_otsu_threshold.restype = ctypes.c_int
    return L


def lib() -> ctypes.CDLL | None:
    """The loaded library, built at the first call; None if it could not be
    built or loaded (`build_error()` says why)."""
    global _LIB, _ERROR, _TRIED
    if _TRIED:
        return _LIB
    with _LOCK:
        if not _TRIED:
            try:
                _LIB = _bind(ctypes.CDLL(str(_build())))
            except (RuntimeError, OSError, subprocess.TimeoutExpired) as e:
                _ERROR = str(e)
            _TRIED = True
    return _LIB


def available() -> bool:
    return lib() is not None


def build_error() -> str | None:
    """Why the library is not available (the compiler's or the loader's
    message); None when it is."""
    lib()
    return _ERROR


def _need() -> ctypes.CDLL:
    L = lib()
    if L is None:
        raise RuntimeError(f"the native library is not available: {_ERROR}")
    return L


def _take_image(L: ctypes.CDLL, im: _SDImage) -> np.ndarray:
    """Copy a decoded SDImage into a numpy array and free the C buffer."""
    dt = _DTYPES[im.dtype]
    n = im.h * im.w * im.c
    buf = (ctypes.c_char * (n * np.dtype(dt).itemsize)).from_address(im.data)
    arr = np.frombuffer(buf, dtype=dt).reshape(im.h, im.w, im.c).copy()
    L.sd_free(im.data)
    if im.c == 1:
        arr = arr[..., 0]
    return arr


def _decode(fn_name: str, path: str) -> np.ndarray:
    L = _need()
    im = _SDImage()
    rc = getattr(L, fn_name)(str(path).encode(), ctypes.byref(im))
    if rc != 0:
        raise ValueError(L.sd_last_error().decode(errors="replace"))
    return _take_image(L, im)


def read_pfm(path: str) -> np.ndarray:
    return _decode("sd_read_pfm", path)


def read_png(path: str) -> np.ndarray:
    return _decode("sd_read_png", path)


def read_jpeg(path: str) -> np.ndarray:
    return _decode("sd_read_jpeg", path)


def _f32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def write_pfm(path: str, image: np.ndarray) -> None:
    L = _need()
    img = np.ascontiguousarray(image, np.float32)
    c = 1 if img.ndim == 2 else img.shape[2]
    rc = L.sd_write_pfm(str(path).encode(), _f32p(img), img.shape[0], img.shape[1], c)
    if rc != 0:
        raise ValueError(L.sd_last_error().decode(errors="replace"))


def _plane(a: np.ndarray, what: str) -> np.ndarray:
    """a as a C-contiguous f32 (H, W) array; the library reads H * W floats."""
    a = np.ascontiguousarray(a, np.float32)
    if a.ndim != 2:
        raise ValueError(f"{what}: an (H, W) array, not {a.shape}")
    return a


def warp_depth(depth: np.ndarray, disparity: np.ndarray) -> np.ndarray:
    L = _need()
    d, s = _plane(depth, "depth"), _plane(disparity, "disparity")
    if d.shape != s.shape:
        raise ValueError(f"depth {d.shape} and disparity {s.shape} differ in shape")
    out = np.empty_like(d)
    L.sd_warp_depth(_f32p(d), _f32p(s), _f32p(out), d.shape[0], d.shape[1])
    return out


def warp_disparity(disparity: np.ndarray) -> np.ndarray:
    L = _need()
    s = _plane(disparity, "disparity")
    out = np.empty_like(s)
    L.sd_warp_disparity(_f32p(s), _f32p(out), s.shape[0], s.shape[1])
    return out


def interpolate_background(disparity: np.ndarray) -> np.ndarray:
    L = _need()
    d = _plane(disparity, "disparity").copy()
    L.sd_interpolate_background(_f32p(d), d.shape[0], d.shape[1])
    return d


def otsu_mask(img_u8: np.ndarray) -> tuple[int, np.ndarray]:
    """Otsu threshold of a uint8 array; returns (threshold, mask>thr as u8*255)."""
    L = _need()
    a = np.ascontiguousarray(img_u8, np.uint8)
    mask = np.empty_like(a)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    thr = L.sd_otsu_threshold(a.ctypes.data_as(u8p), a.size, mask.ctypes.data_as(u8p))
    return thr, mask.reshape(a.shape)
