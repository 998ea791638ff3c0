"""The evaluator's card programs: the counterpart of `tpu_jit` in the JAX
package's `cli.py` `cmd_eval`, which compiles one XLA program per stereo
bucket and per mono input shape.

`EvalPrograms.stereo_fn` runs the stereo forward at a bucket shape and
`mono_fn` runs `infer_mono_depth` at a raw image shape and the dataset's
DAv2 size.  Each key (the function and its input shape) is a `_Program` of
`serve/pipeline.py`, all on one graph pool: safe, since the evaluator calls
them one at a time from one thread and copies every output out.  They
capture at a key's second call (`capture_at=2`): an eval visits many mono
shapes once a try, and a key called once then pays no capture; a key
called twice pays the same either way.  `graphs=False` runs every call
eagerly, and the CPU runs only so.  Both functions take and give numpy
arrays, as the harness does.
"""
from __future__ import annotations

import numpy as np
import torch

from stereoanywhere_tpu_torch.models.dpt import DepthAnythingV2, infer_mono_depth
from stereoanywhere_tpu_torch.models.stereoanywhere import StereoAnywhere
from stereoanywhere_tpu_torch.serve.pipeline import GraphOwner, _Program


class EvalPrograms(GraphOwner):
    """`stereo_fn(im2, im3, mono2, mono3)` -> (1,H,W,1) positive disparity
    and `mono_fn(images01, dataset)` -> (2,H,W,1) raw mono depth (`dataset`
    is ignored: the DAv2 size is this object's `dav2_size`, (width,
    height) as `DAV2_SIZES` gives it)."""

    def __init__(
        self,
        stereo: StereoAnywhere,
        mono: DepthAnythingV2 | None = None,
        iters: int = 32,
        dav2_size: tuple[int, int] = (518, 518),
        device: str | torch.device = "cuda",
        graphs: bool | None = None,
        capture_at: int = 2,
    ):
        super().__init__(device, graphs)
        self.stereo = stereo.to(self.device)
        self.mono = mono.to(self.device) if mono is not None else None
        self.iters, self.dav2_size, self.capture_at = iters, tuple(dav2_size), capture_at
        self.programs: dict[tuple, _Program] = {}

    def _run(self, key: tuple, body, *arrays: np.ndarray) -> np.ndarray:
        self.requests += 1
        xs = [torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(self.device) for a in arrays]
        key = key + tuple(xs[0].shape)
        with torch.inference_mode():
            if not self.graphs:
                out = body(*xs)
            else:
                if key not in self.programs:
                    self.programs[key] = self._program(body, self.capture_at)
                out = self.programs[key](*xs)
        return out.cpu().numpy()

    def _stereo(self, im2, im3, mono2, mono3) -> torch.Tensor:
        return self.stereo(im2, im3, mono2, mono3, iters=self.iters)["disparity"].float()

    def _mono(self, images01) -> torch.Tensor:
        return infer_mono_depth(self.mono, images01, *self.dav2_size)

    def stereo_fn(self, im2, im3, mono2, mono3) -> np.ndarray:
        return self._run(("stereo",), self._stereo, im2, im3, mono2, mono3)

    def mono_fn(self, images01, dataset: str | None = None) -> np.ndarray:
        if self.mono is None:
            raise ValueError("no mono model: give the evaluator precomputed mono depth instead")
        return self._run(("mono", self.dav2_size), self._mono, images01)
