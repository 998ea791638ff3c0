"""Build and bind the hand-written CUDA kernels.

Each `csrc/<name>.cu` compiles with nvcc into a shared library with a plain
C interface under `build/torch_kernels/` at the repository root, loaded
with ctypes.  The build happens at first use, from the sources in the
checkout only; the library name carries a digest of the sources and flags,
so an edited source builds anew.  `build()` starts one nvcc per source, all
at once, and waits for them together.

Every exported launcher takes device pointers and the CUDA stream as
`void*`, launches on that stream, and returns `cudaGetLastError()`; the
Python wrapper raises if it is not 0.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "torch_kernels"
SOURCES = ("vit_dense", "vit_attention", "vit_mlp", "corr_lookup", "step_fused")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")
    return path


def _digest(name: str) -> str:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for path in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:12]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{_digest(name)}.so"


def build(names: tuple[str, ...] = SOURCES) -> dict[str, Path]:
    """Compile the named sources that are not built yet, in parallel.
    Returns {name: library path}; raises with nvcc's output on failure.
    The compiler's report (registers, shared memory, spills) is kept in a
    `.log` beside each library."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: library_path(n) for n in names}
    jobs = {}
    for n, out in paths.items():
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(CSRC / f"{n}.cu")]
        jobs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmp)
    failures = []
    for n, (proc, tmp) in jobs.items():
        log, _ = proc.communicate()
        paths[n].with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {n}.cu (exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, paths[n])
    if failures:
        raise RuntimeError("\n".join(failures))
    return paths


@functools.lru_cache(maxsize=None)
def library(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built on first use."""
    lib = ctypes.CDLL(str(build((name,))[name]))
    lib.sa_error_string.argtypes = [ctypes.c_int]
    lib.sa_error_string.restype = ctypes.c_char_p
    return lib


def bind(name: str, symbol: str, n_ptrs: int, n_ints: int, n_floats: int = 0):
    """ctypes function `symbol` of library `name` taking n_ptrs pointers,
    n_ints ints, n_floats floats and the stream, returning an int status."""
    fn = getattr(library(name), symbol)
    fn.argtypes = (
        [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints + [ctypes.c_float] * n_floats + [ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return fn


def check_status(name: str, what: str, status: int) -> None:
    if status != 0:
        msg = library(name).sa_error_string(status).decode()
        raise RuntimeError(f"{what}: CUDA error {status} ({msg})")


def current_stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def check_operands(what: str, *tensors: torch.Tensor) -> int:
    """All operands on one CUDA device, one supported dtype, contiguous and
    16-byte aligned (the kernels copy 16 bytes at a time).  Returns the
    kernel's dtype code."""
    dev, dt = tensors[0].device, tensors[0].dtype
    if dt not in DTYPE_CODES:
        raise TypeError(f"{what}: dtype {dt} not supported (float32 or bfloat16)")
    for t in tensors:
        if t.device != dev or t.dtype != dt:
            raise TypeError(f"{what}: operands must share device and dtype, got {t.device}/{t.dtype} vs {dev}/{dt}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{what}: operands must be contiguous and 16-byte aligned")
    return DTYPE_CODES[dt]


def check_depth(what: str, dtype: torch.dtype, *depths: int) -> None:
    """The bf16 tensor-core products read rows 8 values at a time."""
    if dtype == torch.bfloat16 and any(k % 8 for k in depths):
        raise ValueError(f"{what}: bf16 product depths {depths} must be multiples of 8")
