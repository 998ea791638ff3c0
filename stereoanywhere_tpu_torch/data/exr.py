"""A small OpenEXR scanline codec in Python and zlib: the port's copy of the
JAX package's `data/exr.py`.

It stands in for the reference's `cv2.imread(..., IMREAD_ANYDEPTH)` EXR
depth path (reference frame_utils.py:124-129 readDepthEXR) without OpenCV or
OpenEXR.  It reads and writes what depth maps use: single-part scanline
files, NONE / ZIPS / ZIP compression, HALF / FLOAT / UINT channels,
increasing-y line order.  Tiled, deep and multi-part files and the PIZ,
PXR24, B44 and DWA codecs raise ValueError.

ZIP blocks are deflate streams of a byte "predictor" encoding: the raw bytes
are split into two interleaved halves, then delta-coded with bias 128.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

_MAGIC = 20000630
_PIXEL_DTYPES = {0: np.uint32, 1: np.float16, 2: np.float32}
_LINES_PER_BLOCK = {0: 1, 1: 1, 2: 16, 3: 16}  # NONE, RLE(n/a), ZIPS, ZIP


def _read_cstring(buf: memoryview, pos: int) -> tuple[bytes, int]:
    end = pos
    while buf[end] != 0:
        end += 1
    return bytes(buf[pos:end]), end + 1


def _unpredict(data: bytes) -> bytes:
    """Invert the EXR ZIP predictor: delta-decode, then un-interleave."""
    # delta decode d[i] = d[i-1] + raw[i] - 128 == cumsum(raw - 128*[i>0]) mod 256
    acc = np.frombuffer(data, np.uint8).astype(np.int64).copy()
    acc[1:] -= 128
    out = np.cumsum(acc, dtype=np.int64).astype(np.uint8)
    # un-interleave: first half -> even positions, second half -> odd
    n = len(out)
    half = (n + 1) // 2
    res = np.empty(n, np.uint8)
    res[0::2] = out[:half]
    res[1::2] = out[half:]
    return res.tobytes()


def _predict(data: bytes) -> bytes:
    """Forward EXR ZIP predictor (for the writer): interleave, delta-encode."""
    src = np.frombuffer(data, np.uint8)
    n = len(src)
    half = (n + 1) // 2
    inter = np.empty(n, np.uint8)
    inter[:half] = src[0::2]
    inter[half:] = src[1::2]
    out = inter.astype(np.int16)
    out[1:] = out[1:] - inter[:-1].astype(np.int16) + 128
    return out.astype(np.uint8).tobytes()


def read_exr(path: str) -> dict[str, np.ndarray]:
    """Read a scanline EXR into {channel_name: (H,W) array}."""
    raw = memoryview(open(path, "rb").read())
    magic, version = struct.unpack_from("<ii", raw, 0)
    if magic != _MAGIC:
        raise ValueError(f"not an EXR file: {path}")
    if version & 0x200:
        raise ValueError("tiled EXR not supported")
    if version & (0x800 | 0x1000):
        raise ValueError("deep/multi-part EXR not supported")
    pos = 8

    channels: list[tuple[str, int]] = []
    compression = 0
    data_window = (0, 0, 0, 0)
    while True:
        name, pos = _read_cstring(raw, pos)
        if name == b"":
            break
        _type, pos = _read_cstring(raw, pos)
        (size,) = struct.unpack_from("<i", raw, pos)
        pos += 4
        val = raw[pos : pos + size]
        pos += size
        if name == b"channels":
            cpos = 0
            while val[cpos] != 0:
                cname_end = cpos
                while val[cname_end] != 0:
                    cname_end += 1
                cname = bytes(val[cpos:cname_end]).decode()
                ptype, _xs, _ys = struct.unpack_from("<i4xii", val, cname_end + 1)
                channels.append((cname, ptype))
                cpos = cname_end + 1 + 16
        elif name == b"compression":
            compression = val[0]
        elif name == b"dataWindow":
            data_window = struct.unpack_from("<iiii", val, 0)
        elif name == b"lineOrder":
            if val[0] != 0:
                raise ValueError("only increasing-y line order supported")

    if compression not in _LINES_PER_BLOCK:
        raise ValueError(f"unsupported EXR compression {compression}")
    xmin, ymin, xmax, ymax = data_window
    w, h = xmax - xmin + 1, ymax - ymin + 1
    lpb = _LINES_PER_BLOCK[compression]
    n_blocks = (h + lpb - 1) // lpb
    # channels are stored sorted by name within each scanline
    channels.sort(key=lambda c: c[0])
    bytes_per_px = {0: 4, 1: 2, 2: 4}
    line_bytes = sum(bytes_per_px[t] * w for _, t in channels)

    pos += 8 * n_blocks  # skip the line-offset table (blocks are in order)
    out = {c: np.empty((h, w), _PIXEL_DTYPES[t]) for c, t in channels}
    for _ in range(n_blocks):
        y, size = struct.unpack_from("<ii", raw, pos)
        pos += 8
        block = bytes(raw[pos : pos + size])
        pos += size
        ny = min(lpb, ymax - y + 1)
        expect = line_bytes * ny
        if compression in (2, 3):
            if size < expect:
                block = _unpredict(zlib.decompress(block))
            # (openexr stores raw if compression didn't help)
        data = block
        off = 0
        for line in range(ny):
            for cname, ptype in channels:
                nb = bytes_per_px[ptype] * w
                arr = np.frombuffer(data[off : off + nb], _PIXEL_DTYPES[ptype])
                out[cname][y - ymin + line] = arr
                off += nb
    return out


def read_depth_exr(path: str, focal: float, baseline: float) -> tuple[np.ndarray, np.ndarray]:
    """EXR depth -> (disparity (H,W,1), valid (H,W,1)) via disp = f*b/z
    (reference frame_utils.py:124-129)."""
    chans = read_exr(path)
    for key in ("Z", "Y", "R"):
        if key in chans:
            z = chans[key].astype(np.float32)
            break
    else:
        z = next(iter(chans.values())).astype(np.float32)
    z = z[..., None]
    valid = (z > 0).astype(np.float32)
    disp = np.zeros_like(z)
    disp[z > 0] = focal * baseline / z[z > 0]
    return disp, valid


def write_exr(
    path: str, channels: dict[str, np.ndarray], compression: str = "zip"
) -> None:
    """Write a scanline EXR; float32 arrays become FLOAT channels, float16
    become HALF.  compression: none|zips|zip."""
    comp = {"none": 0, "zips": 2, "zip": 3}[compression]
    names = sorted(channels)
    channels = {
        n: np.ascontiguousarray(channels[n])
        if channels[n].dtype == np.float16
        else np.ascontiguousarray(channels[n], np.float32)
        for n in names
    }
    h, w = channels[names[0]].shape
    lpb = _LINES_PER_BLOCK[comp]

    def attr(name: bytes, typ: bytes, val: bytes) -> bytes:
        return name + b"\0" + typ + b"\0" + struct.pack("<i", len(val)) + val

    chlist = b""
    for n in names:
        ptype = 1 if channels[n].dtype == np.float16 else 2
        chlist += n.encode() + b"\0" + struct.pack("<i4xii", ptype, 1, 1)
    chlist += b"\0"
    box = struct.pack("<iiii", 0, 0, w - 1, h - 1)
    header = (
        struct.pack("<ii", _MAGIC, 2)
        + attr(b"channels", b"chlist", chlist)
        + attr(b"compression", b"compression", bytes([comp]))
        + attr(b"dataWindow", b"box2i", box)
        + attr(b"displayWindow", b"box2i", box)
        + attr(b"lineOrder", b"lineOrder", b"\0")
        + attr(b"pixelAspectRatio", b"float", struct.pack("<f", 1.0))
        + attr(b"screenWindowCenter", b"v2f", struct.pack("<ff", 0, 0))
        + attr(b"screenWindowWidth", b"float", struct.pack("<f", 1.0))
        + b"\0"
    )
    n_blocks = (h + lpb - 1) // lpb
    blocks = []
    for bi in range(n_blocks):
        y0 = bi * lpb
        ny = min(lpb, h - y0)
        data = b"".join(
            channels[n][y0 + line].tobytes() for line in range(ny) for n in names
        )
        if comp in (2, 3):
            z = zlib.compress(_predict(data))
            data = z if len(z) < len(data) else data
        blocks.append(struct.pack("<ii", y0, len(data)) + data)
    table_start = len(header) + 8 * n_blocks
    offsets = []
    acc = table_start
    for blk in blocks:
        offsets.append(acc)
        acc += len(blk)
    with open(path, "wb") as f:
        f.write(header)
        for off in offsets:
            f.write(struct.pack("<Q", off))
        for blk in blocks:
            f.write(blk)
