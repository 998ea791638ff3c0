"""Reader and writer of flax's msgpack checkpoints, without the `msgpack`
package, flax or `ml_dtypes`.

The layout is the one `flax.serialization.msgpack_serialize` writes and
`msgpack_restore` reads:
- a tree of maps with string keys, written with the keys of every map in
  sorted order (flax copies the tree through a JAX tree map first, which
  sorts them);
- an array leaf as ext type 1, whose payload is itself msgpack: the array
  (shape, dtype name, C-order bytes);
- a numpy scalar as ext type 3 with the same payload at shape (), and a
  Python complex as ext type 2 holding the array (real, imag);
- an array of more than `MAX_CHUNK_SIZE` bytes as the map
  {'__msgpack_chunked_array__': True, 'shape': {'0': ...}, 'chunks':
  {'0': ..., ...}} of flat pieces of at most that many bytes.

`serialize` gives flax's bytes for the same tree (numpy arrays and torch
tensors alike; a torch tensor, 0-d included, is written as an array).
`restore` gives numpy leaves, except for bfloat16, which numpy lacks: such
a leaf (array or scalar) comes back as a `torch.bfloat16` tensor, decoded
through an int16 view of its bytes.  The loaders in `compat/from_jax.py`
take both.
"""
from __future__ import annotations

import struct
from pathlib import Path
from typing import Any

import numpy as np
import torch

MAX_CHUNK_SIZE = 2 ** 30
CHUNKED = "__msgpack_chunked_array__"
EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3


# ---------------------------------------------------------------------------
# Writing


def _array_bytes(x) -> tuple[tuple[int, ...], str, bytes]:
    """(shape, dtype name, C-order bytes) of a numpy array or torch tensor."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return tuple(t.shape), "bfloat16", t.view(torch.int16).numpy().tobytes()
        x = t.numpy()
    if x.dtype.hasobject or x.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes cannot be serialized")
    return x.shape, x.dtype.name, x.tobytes("C")


def _nbytes(x) -> int:
    return x.numel() * x.element_size() if isinstance(x, torch.Tensor) else x.size * x.dtype.itemsize


def _chunked(x) -> dict:
    """flax's chunked form of an oversized array (insertion order, as flax
    builds it after its sort)."""
    itemsize = x.element_size() if isinstance(x, torch.Tensor) else x.dtype.itemsize
    size = max(1, int(MAX_CHUNK_SIZE / itemsize))
    flat = x.reshape(-1)
    n = flat.numel() if isinstance(x, torch.Tensor) else flat.size
    return {CHUNKED: True, "shape": {str(i): d for i, d in enumerate(x.shape)},
            "chunks": {str(i): flat[s:s + size] for i, s in enumerate(range(0, n, size))}}


class _Writer:
    def __init__(self):
        self.out: list[bytes] = []

    def head(self, n: int, fix: int | None, fix_max: int, codes: tuple[int, int, int]):
        """A length header: the fix form below fix_max, else the 8/16/32-bit
        form (codes, None where the format has no 8-bit form)."""
        if fix is not None and n < fix_max:
            self.out.append(bytes([fix | n]))
        elif codes[0] is not None and n < 1 << 8:
            self.out.append(struct.pack(">BB", codes[0], n))
        elif n < 1 << 16:
            self.out.append(struct.pack(">BH", codes[1], n))
        elif n < 1 << 32:
            self.out.append(struct.pack(">BI", codes[2], n))
        else:
            raise ValueError(f"msgpack holds at most 2**32 - 1 items or bytes, not {n}")

    def int(self, v: int):
        if 0 <= v < 128:
            self.out.append(bytes([v]))
        elif v >= 0:
            for code, fmt, top in ((0xCC, ">BB", 1 << 8), (0xCD, ">BH", 1 << 16), (0xCE, ">BI", 1 << 32),
                                   (0xCF, ">BQ", 1 << 64)):
                if v < top:
                    self.out.append(struct.pack(fmt, code, v))
                    return
            raise OverflowError(f"integer {v} does not fit msgpack's 64 bits")
        elif v >= -32:
            self.out.append(struct.pack(">b", v))
        else:
            for code, fmt, low in ((0xD0, ">Bb", -(1 << 7)), (0xD1, ">Bh", -(1 << 15)), (0xD2, ">Bi", -(1 << 31)),
                                   (0xD3, ">Bq", -(1 << 63))):
                if v >= low:
                    self.out.append(struct.pack(fmt, code, v))
                    return
            raise OverflowError(f"integer {v} does not fit msgpack's 64 bits")

    def str(self, s: str):
        b = s.encode("utf-8")
        self.head(len(b), 0xA0, 32, (0xD9, 0xDA, 0xDB))
        self.out.append(b)

    def bin(self, b: bytes):
        self.head(len(b), None, 0, (0xC4, 0xC5, 0xC6))
        self.out.append(b)

    def ext(self, code: int, data: bytes):
        fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}.get(len(data))
        if fixed is not None:
            self.out.append(struct.pack(">Bb", fixed, code))
        else:
            self.head(len(data), None, 0, (0xC7, 0xC8, 0xC9))
            self.out.append(struct.pack(">b", code))
        self.out.append(data)

    def value(self, v, sort: bool = True):
        if v is None:
            self.out.append(b"\xc0")
        elif v is True or v is False:
            self.out.append(b"\xc3" if v else b"\xc2")
        elif type(v) is int:
            self.int(v)
        elif type(v) is float:
            self.out.append(struct.pack(">Bd", 0xCB, v))
        elif type(v) is str:
            self.str(v)
        elif type(v) in (bytes, bytearray, memoryview):
            self.bin(bytes(v))
        elif isinstance(v, dict):
            if CHUNKED in v:
                sort = False
            items = sorted(v.items()) if sort else list(v.items())
            self.head(len(items), 0x80, 16, (None, 0xDE, 0xDF))
            for k, x in items:
                self.value(k)
                self.value(x, sort)
        elif type(v) in (list, tuple):
            self.head(len(v), 0x90, 16, (None, 0xDC, 0xDD))
            for x in v:
                self.value(x, sort)
        elif isinstance(v, (np.ndarray, torch.Tensor)):
            if _nbytes(v) > MAX_CHUNK_SIZE:
                self.value(_chunked(v), sort=False)
            else:
                self.ext(EXT_NDARRAY, _payload(v))
        elif isinstance(v, np.generic):
            self.ext(EXT_NPSCALAR, _payload(np.asarray(v)))
        elif isinstance(v, complex):
            inner = _Writer()
            inner.value([v.real, v.imag])
            self.ext(EXT_COMPLEX, b"".join(inner.out))
        else:
            raise TypeError(f"cannot serialize {type(v).__name__}")


def _payload(x) -> bytes:
    shape, name, data = _array_bytes(x)
    w = _Writer()
    w.head(3, 0x90, 16, (None, 0xDC, 0xDD))
    w.value([int(d) for d in shape])
    w.str(name)
    w.bin(data)
    return b"".join(w.out)


def serialize(tree: Any) -> bytes:
    """flax's `msgpack_serialize(tree)`: the same bytes for the same tree."""
    w = _Writer()
    w.value(tree)
    return b"".join(w.out)


def write(path: str | Path, tree: Any) -> int:
    """Write `serialize(tree)` to path; returns the byte count."""
    data = serialize(tree)
    Path(path).write_bytes(data)
    return len(data)


# ---------------------------------------------------------------------------
# Reading


class _Reader:
    def __init__(self, data, raw: bool = False):
        self.buf, self.pos, self.raw = memoryview(data), 0, raw

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError(f"msgpack data ends early: {n} bytes wanted at offset {self.pos} of {len(self.buf)}")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def str(self, n: int):
        b = bytes(self.take(n))
        return b if self.raw else b.decode("utf-8")

    def value(self):
        c = self.unpack(">B")
        if c < 0x80:
            return c
        if c >= 0xE0:
            return c - 0x100
        if c < 0x90:
            return self.map(c & 0x0F)
        if c < 0xA0:
            return [self.value() for _ in range(c & 0x0F)]
        if c < 0xC0:
            return self.str(c & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if c in simple:
            return simple[c]
        sized = {0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
                 0xC7: ("ext", ">B"), 0xC8: ("ext", ">H"), 0xC9: ("ext", ">I"),
                 0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
                 0xDC: ("array", ">H"), 0xDD: ("array", ">I"), 0xDE: ("map", ">H"), 0xDF: ("map", ">I")}
        if c in sized:
            kind, fmt = sized[c]
            n = self.unpack(fmt)
            if kind == "bin":
                return bytes(self.take(n))
            if kind == "str":
                return self.str(n)
            if kind == "array":
                return [self.value() for _ in range(n)]
            if kind == "map":
                return self.map(n)
            return self.ext(self.unpack(">b"), n)
        numbers = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                   0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if c in numbers:
            return self.unpack(numbers[c])
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if c in fixext:
            return self.ext(self.unpack(">b"), fixext[c])
        raise ValueError(f"not a msgpack type byte: 0x{c:02x} at offset {self.pos - 1}")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out

    def ext(self, code: int, n: int):
        data = self.take(n)
        if code == EXT_NDARRAY:
            return _array_from(data)
        if code == EXT_NPSCALAR:
            a = _array_from(data)
            return a.reshape(()) if isinstance(a, torch.Tensor) else a[()]
        if code == EXT_COMPLEX:
            re_, im = _Reader(data).value()
            return complex(re_, im)
        raise ValueError(f"unknown msgpack ext type {code}")


def _array_from(data: memoryview):
    shape, name, buf = _Reader(data, raw=True).value()
    name = name.decode()
    if name == "bfloat16":
        bits = np.frombuffer(buf, np.int16).copy().reshape(shape)
        return torch.from_numpy(bits).view(torch.bfloat16)
    try:
        dtype = np.dtype(name)
    except TypeError as e:
        raise ValueError(f"array of dtype {name!r}, which numpy does not know without ml_dtypes") from e
    return np.frombuffer(buf, dtype).reshape(shape)


def _unchunk(node: dict):
    shape = tuple(node["shape"][str(i)] for i in range(len(node["shape"])))
    chunks = [node["chunks"][str(i)] for i in range(len(node["chunks"]))]
    if any(isinstance(c, torch.Tensor) for c in chunks):
        return torch.cat([c.reshape(-1) for c in chunks]).reshape(shape)
    return np.concatenate(chunks).reshape(shape)


def _unchunk_tree(node):
    if isinstance(node, dict):
        if CHUNKED in node:
            return _unchunk(node)
        for k, v in node.items():
            node[k] = _unchunk_tree(v)
    return node


def restore(data: bytes | bytearray | memoryview) -> Any:
    """flax's `msgpack_restore(data)`, with bfloat16 leaves as torch tensors.
    Raises ValueError on data that ends early or holds bytes past its
    tree."""
    r = _Reader(data)
    tree = r.value()
    if r.pos != len(r.buf):
        raise ValueError(f"msgpack data holds {len(r.buf) - r.pos} bytes past its tree")
    return _unchunk_tree(tree)


def read(path: str | Path) -> Any:
    """`restore` of a file's bytes."""
    try:
        return restore(Path(path).read_bytes())
    except ValueError as e:
        raise ValueError(f"{path}: not a whole flax msgpack checkpoint ({e})") from e
