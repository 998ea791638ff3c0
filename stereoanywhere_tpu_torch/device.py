"""Device selection for the port's entry points, the device-resident
constants (resize matrices, normalisation statistics) that the forward
reads, and the channels-last memory formats the stereo stage holds its
activations and convolution weights in."""
from __future__ import annotations

import functools
import threading
from contextlib import contextmanager
from typing import Callable, Iterator

import numpy as np
import torch


def resolve_device(device: str | torch.device | None = "cuda") -> torch.device:
    """The device an entry point runs on.

    The port runs on a CUDA card unless the caller asks for the CPU by name.
    Without a card it raises: it never carries on on the CPU quietly.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the port on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def torch_dtype(name: str) -> torch.dtype:
    """'float32' | 'bfloat16' -> torch dtype."""
    table = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    if name not in table:
        raise ValueError(f"unsupported compute dtype {name!r}")
    return table[name]


# the channels-last format of a 4-D (B,C,H,W) and a 5-D (B,C,D,H,W) tensor
CHANNELS_LAST = {4: torch.channels_last, 5: torch.channels_last_3d}


def channels_last_format(x: torch.Tensor) -> torch.memory_format | None:
    """The channels-last format x is held in, or None: for a contiguous x,
    for a tensor of another rank, and where the two formats hold the same
    memory (one channel, or a single pixel), which is contiguous too."""
    fmt = CHANNELS_LAST.get(x.ndim)
    if fmt is None or x.is_contiguous() or not x.is_contiguous(memory_format=fmt):
        return None
    return fmt


@functools.lru_cache(maxsize=128)
def _copied(make: Callable[..., np.ndarray], args: tuple, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    # a normal tensor even when made inside inference mode (a served or
    # evaluated forward): a training forward may save it for backward
    with torch.inference_mode(False):
        return torch.from_numpy(make(*args)).to(device=device, dtype=dtype)


_holders = threading.local()


def device_constant(make: Callable[..., np.ndarray], args: tuple, device: torch.device,
                    dtype: torch.dtype) -> torch.Tensor:
    """`make(*args)`, a numpy array, copied to `device` in `dtype` once and
    handed out again after.  A copy from pageable host memory waits for the
    device to drain, and a CUDA graph cannot capture one, so a forward
    makes none after its first call at a shape.  The cache keeps the 128
    constants used last, so that a server fed many request sizes does not
    grow without limit; a graph that reads a constant holds it
    (`holding_constants`), so an eviction does not free it under the
    graph."""
    t = _copied(make, args, torch.device(device), dtype)
    for held in getattr(_holders, "lists", ()):
        held.append(t)
    return t


@contextmanager
def holding_constants() -> Iterator[list]:
    """Collect every constant that `device_constant` hands out on this
    thread inside the block into the list it yields."""
    held: list = []
    lists = _holders.__dict__.setdefault("lists", [])
    lists.append(held)
    try:
        yield held
    finally:
        lists.remove(held)
