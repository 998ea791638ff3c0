"""The port's native library loader (`stereoanywhere_tpu_torch/native.py`)
and the decoders' dispatch (`data/frame_utils.py`) against the JAX
package's `native` and `frame_utils`, on the CPU.

Both packages build `native/stereodata.cc` with the same g++ line (the port
into `build/torch_native/`, the JAX package beside the source), so every
case is held bit for bit: the decoders of `tests/test_native.py` (PNG RGB8,
RGBA and grey16, JPEG, PFM), the warps, the background infill and the Otsu
threshold.  Without the library the port decodes through PIL and numpy,
as the JAX package does; the failed build keeps the compiler's message.

The JAX package builds its library lazily, in place, with `g++ -o`, and
caches a failed load for the whole process; processes that start together
(pytest-xdist's workers on a fresh checkout) race for that build, and the
losers load a half-written file.  `complete_jax_native` takes the race out
of the tests: the other test files that need the JAX package's library
import it from here.
"""
import ctypes
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from stereoanywhere_tpu import native as jnative
from stereoanywhere_tpu.data import frame_utils as jfu

from stereoanywhere_tpu_torch import native as pnative
from stereoanywhere_tpu_torch.data import frame_utils as pfu

# this process's own complete build of the JAX package's library: its path,
# or the reason it cannot be built here
_JAX_BUILD: dict = {}


def _build_jax_native() -> Path:
    """The JAX package's library, built once a process with its loader's
    own compile line (`stereoanywhere_tpu/native/__init__.py` `_build`)
    into a directory of this process, then copied beside the source under
    a name of this process's and moved over `native/libstereodata.so`, so
    that no process ever reads a half-written file there.  Raises
    RuntimeError with the compiler's message when it cannot be built."""
    if "path" in _JAX_BUILD:
        return _JAX_BUILD["path"]
    if "error" in _JAX_BUILD:
        raise RuntimeError(_JAX_BUILD["error"])
    src = jnative._REPO_NATIVE / "stereodata.cc"
    cxx = shutil.which("g++")
    try:
        if cxx is None:
            raise RuntimeError("g++ not found")
        if not src.exists():
            raise RuntimeError(f"{src} is not in this checkout")
        so = Path(tempfile.mkdtemp(prefix="jax_native_")) / "libstereodata.so"
        out = subprocess.run([cxx, "-O2", "-fPIC", "-shared", "-fvisibility=hidden", "-o", str(so), str(src),
                              "-lpng", "-ljpeg", "-lz"], capture_output=True, text=True, timeout=120)
        if out.returncode != 0:
            raise RuntimeError(f"g++ failed (exit {out.returncode}):\n{out.stderr.strip()}")
        ctypes.CDLL(str(so))
    except (RuntimeError, OSError, subprocess.TimeoutExpired) as e:
        _JAX_BUILD["error"] = str(e)
        raise RuntimeError(str(e)) from e
    tmp = jnative._REPO_NATIVE / f".libstereodata.{os.getpid()}.tmp"
    try:
        shutil.copyfile(so, tmp)
        os.replace(tmp, jnative._REPO_NATIVE / "libstereodata.so")
    finally:
        tmp.unlink(missing_ok=True)
    _JAX_BUILD["path"] = so
    return so


def complete_jax_native(monkeypatch) -> bool:
    """Load the JAX package's native library into this process whatever
    its loader cached before (a failed load of another process's
    half-written build included): the loader's state is reset through
    `monkeypatch` and its `_build` returns this process's own complete
    build.  True when the library is loaded; False only when it cannot be
    built here (no g++, or no libpng / libjpeg headers)."""
    try:
        so = _build_jax_native()
    except RuntimeError:
        return False
    monkeypatch.delenv("STEREOANYWHERE_NO_NATIVE", raising=False)
    monkeypatch.setattr(jnative, "_build", lambda: so)
    monkeypatch.setattr(jnative, "_LIB", None)
    monkeypatch.setattr(jnative, "_TRIED", False)
    return jnative.available()


def need_jax_native(monkeypatch) -> None:
    """`complete_jax_native`, skipping the test only when the library
    cannot be built here (the compiler's message is the reason)."""
    if not complete_jax_native(monkeypatch):
        pytest.skip(f"the JAX package's native library cannot be built here: {_JAX_BUILD.get('error')}")


@pytest.fixture(autouse=True)
def _jax_native(monkeypatch):
    need_jax_native(monkeypatch)


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def test_the_port_builds_its_own_library():
    assert pnative.available(), pnative.build_error()
    assert pnative.build_error() is None
    path = pnative.library_path()
    assert path.exists() and path.parent.name == "torch_native" and path.parent.parent.name == "build"
    assert path != (pnative.REPO / "native" / "libstereodata.so")


def test_a_failed_build_keeps_the_compilers_message(tmp_path, monkeypatch):
    bad = tmp_path / "stereodata.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(pnative, "SOURCE", bad)
    monkeypatch.setattr(pnative, "BUILD_DIR", tmp_path / "build")
    for name, value in (("_LIB", None), ("_ERROR", None), ("_TRIED", False)):
        monkeypatch.setattr(pnative, name, value)
    assert not pnative.available()
    assert "g++ failed" in pnative.build_error() and "stereodata.cc" in pnative.build_error()
    with pytest.raises(RuntimeError, match="not available: g\\+\\+ failed"):
        pnative.read_png(str(bad))
    # the readers fall back to PIL, as the JAX package's do without its library
    rgb = np.random.default_rng(0).integers(0, 256, (5, 7, 3), dtype=np.uint8)
    Image.fromarray(rgb).save(tmp_path / "x.png")
    _same(pfu.read_image(str(tmp_path / "x.png")), rgb)


@pytest.mark.parametrize("kind", ["rgb8", "rgba8", "gray8", "gray16"])
def test_png_decoders_equal_jax(tmp_path, rng, kind):
    shapes = {"rgb8": ((21, 33, 3), np.uint8), "rgba8": ((11, 13, 4), np.uint8), "gray8": ((9, 10), np.uint8),
              "gray16": ((17, 19), np.uint16)}
    shape, dtype = shapes[kind]
    arr = rng.integers(0, np.iinfo(dtype).max, shape, dtype=dtype)
    p = str(tmp_path / f"{kind}.png")
    Image.fromarray(arr).save(p)
    _same(pnative.read_png(p), jnative.read_png(p))
    _same(pnative.read_png(p), arr)
    _same(pfu.read_image(p), jfu.read_image(p))
    _same(pfu.read_gray16(p), jfu.read_gray16(p))


def test_jpeg_decoder_equals_jax(tmp_path, rng):
    arr = rng.integers(0, 255, (32, 48, 3), dtype=np.uint8)
    p = str(tmp_path / "x.jpg")
    Image.fromarray(arr).save(p, quality=95)
    _same(pnative.read_jpeg(p), jnative.read_jpeg(p))
    _same(pfu.read_image(p), jfu.read_image(p))
    pil = np.asarray(Image.open(p).convert("RGB")).astype(np.int32)
    assert np.abs(pnative.read_jpeg(p).astype(np.int32) - pil).max() <= 2


def test_pfm_roundtrip_equals_jax(tmp_path, rng):
    for shape in ((13, 29), (7, 9, 3)):
        arr = rng.standard_normal(shape).astype(np.float32)
        for label, write in (("port", pnative.write_pfm), ("jax", jnative.write_pfm), ("python", pfu.write_pfm)):
            p = str(tmp_path / f"{label}{len(shape)}.pfm")
            write(p, arr.copy())
            _same(pnative.read_pfm(p), jnative.read_pfm(p))
            _same(pfu.read_pfm(p), arr)
            _same(jfu.read_pfm(p), arr)
        assert (tmp_path / f"port{len(shape)}.pfm").read_bytes() == (tmp_path / f"jax{len(shape)}.pfm").read_bytes()
    with pytest.raises(ValueError):
        pnative.read_pfm(str(tmp_path / "missing.pfm"))


def test_warps_and_infill_equal_jax(rng):
    disp = ((rng.uniform(0, 1, (40, 60)) > 0.4) * rng.uniform(1, 20, (40, 60))).astype(np.float32)
    depth = ((rng.uniform(0, 1, (40, 60)) > 0.3) * rng.uniform(0.5, 10, (40, 60))).astype(np.float32)
    _same(pnative.warp_disparity(disp), jnative.warp_disparity(disp))
    _same(pnative.warp_depth(depth, disp), jnative.warp_depth(depth, disp))
    holes = ((rng.uniform(0, 1, (25, 45)) > 0.5) * rng.uniform(1, 30, (25, 45))).astype(np.float32)
    _same(pnative.interpolate_background(holes), jnative.interpolate_background(holes))
    # the port checks the shapes before it hands the library pointers
    with pytest.raises(ValueError, match="differ in shape"):
        pnative.warp_depth(depth, disp[:, :-1])
    with pytest.raises(ValueError, match="an \\(H, W\\) array"):
        pnative.warp_disparity(disp[None])


def test_otsu_equals_jax(rng):
    a = np.concatenate([rng.normal(60, 5, 4000), rng.normal(190, 5, 4000)]).clip(0, 255).astype(np.uint8)
    for img in (a, a.reshape(80, 100), rng.integers(0, 256, (33, 17), dtype=np.uint8)):
        (pt, pm), (jt, jm) = pnative.otsu_mask(img), jnative.otsu_mask(img)
        assert pt == jt
        _same(pm, jm)
    thr, mask = pnative.otsu_mask(a)
    assert 73 <= thr <= 180 and ((a > thr) == (mask > 0)).all()
