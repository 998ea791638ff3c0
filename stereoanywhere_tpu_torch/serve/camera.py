"""The live stereo capture loop: the port's copy of the JAX package's
`serve/camera.py`, the counterpart of the reference's OAK-D demo (reference
demo/fast_demo_oak.py).

The reference demo couples three things in one script: (1) a depthai camera
pipeline giving rectified stereo and the camera's on-board SGM disparity
(fast_demo_oak.py:146-205), (2) a frame loop that clips, infers, and
EMA-smooths the model's disparity (fast_demo_oak.py:40-49, :225-299), and
(3) cv2 display windows.  Here they are apart:

- a frame source yields (left, right[, sgm]) frames: `OakDSource` builds the
  reference's depthai pipeline where the depthai SDK is installed (elsewhere
  its construction raises ImportError), `DirectorySource` replays captured
  frames from disk, and any iterable of pairs serves too;
- `CaptureLoop` owns the loop: optional border clipping (the demo's
  clip_top/bottom/left/right), inference through any `(left, right) ->
  disparity` callable (a local `StereoAnywherePipeline` on the card, or
  `serve/client.py`'s `infer_remote`), the EMA temporal filter (alpha 0.15,
  fast_demo_oak.py:40-49), and frames a second.  Display is a callback
  (`on_frame`) instead of cv2 windows; `cli camera` writes colormapped PNGs;
- `disparity_frame` reproduces the demo's JET colormap with zero pixels
  black (fast_demo_oak.py:212-214, getDisparityFrame), in numpy (no cv2).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Iterable, Iterator, Sequence

import numpy as np

__all__ = [
    "CaptureLoop",
    "DirectorySource",
    "OakDSource",
    "disparity_frame",
    "rolling_max",
    "ema_filter",
]


# ---------------------------------------------------------------------------
# Colormap (reference fast_demo_oak.py:212-214: cv2.COLORMAP_JET with the
# zero entry forced to black, applied to disp * 255 / maxDisp)


def _jet(u: np.ndarray) -> np.ndarray:
    """OpenCV-style JET on u in [0,1] -> float RGB in [0,1] (piecewise
    linear ramps; matches cv2.COLORMAP_JET to within quantization)."""
    v = 4.0 * np.clip(u, 0.0, 1.0)
    r = np.clip(np.minimum(v - 1.5, -v + 4.5), 0.0, 1.0)
    g = np.clip(np.minimum(v - 0.5, -v + 3.5), 0.0, 1.0)
    b = np.clip(np.minimum(v + 0.5, -v + 2.5), 0.0, 1.0)
    return np.stack([r, g, b], axis=-1)


def disparity_frame(disp: np.ndarray, max_disp: float | None = None) -> np.ndarray:
    """(H,W) disparity -> (H,W,3) uint8 JET frame, zero-disparity black.

    Mirrors the reference demo's getDisparityFrame: scale to [0,255] by
    `max_disp` (pass a `rolling_max()` value for the reference's 10-frame
    running mean of maxima, fast_demo_oak.py maxDisp deque; with None the
    per-frame max is used, which can flicker across frames)."""
    d = np.asarray(disp, np.float32)
    m = float(max_disp) if max_disp else float(d.max()) or 1.0
    rgb = (_jet(d / m) * 255.0).astype(np.uint8)
    rgb[d <= 0] = 0
    return rgb


def rolling_max(window: int = 10):
    """Stateful color-scale stabilizer: returns step(disp) -> mean of the
    last `window` frame maxima (the reference demo's maxDisp deque,
    fast_demo_oak.py:244-248) — feeds disparity_frame's max_disp so the JET
    scale does not flicker frame to frame."""
    from collections import deque

    hist: deque = deque(maxlen=window)

    def step(disp: np.ndarray) -> float:
        hist.append(float(np.asarray(disp).max()))
        return float(np.mean(hist)) or 1.0

    return step


# ---------------------------------------------------------------------------
# EMA temporal filter (reference fast_demo_oak.py:40-49)


def ema_filter(alpha: float = 0.15):
    """Stateful smoother: new = alpha * x + (1 - alpha) * prev."""
    state = {}

    def step(x: np.ndarray) -> np.ndarray:
        prev = state.get("s")
        state["s"] = x if prev is None else alpha * x + (1.0 - alpha) * prev
        return state["s"]

    return step


# ---------------------------------------------------------------------------
# Frame sources


class DirectorySource:
    """Replays (left, right) pairs from two sorted file lists: the headless
    stand-in for a camera."""

    def __init__(self, left: Sequence[str], right: Sequence[str], loop: bool = False):
        assert len(left) == len(right) and left, "need equal, non-empty file lists"
        self.left, self.right, self.loop = list(left), list(right), loop

    def __iter__(self) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        from PIL import Image

        while True:
            for lp, rp in zip(self.left, self.right):
                l = np.asarray(Image.open(lp).convert("RGB"), np.float32) / 255.0
                r = np.asarray(Image.open(rp).convert("RGB"), np.float32) / 255.0
                yield l, r
            if not self.loop:
                return


class OakDSource:
    """Rectified stereo (+ on-board SGM disparity) from an OAK-D camera.

    Builds the reference demo's exact depthai pipeline when the SDK exists
    (reference fast_demo_oak.py:146-205): mono cameras into a StereoDepth
    node, HIGH_DENSITY preset, 7x7 median, left-right check, subpixel with
    3 fractional bits, temporal + spatial post-filters, threshold filter
    400-15000 mm, rectified L/R + disparity XLink outputs.  Yields
    (left_rgb[0,1], right_rgb[0,1], sgm_disparity) — the SGM map is the
    reference demo's side-by-side comparison stream, already divided by 2^3
    for the subpixel bits (fast_demo_oak.py:232).

    Without depthai, construction raises ImportError saying so.
    """

    def __init__(self, resolution: str = "400", queue_size: int = 8):
        try:
            import depthai  # noqa: F401
        except ImportError as e:  # pragma: no cover - SDK absent in CI
            raise ImportError(
                "OakDSource needs the depthai SDK (reference demo/fast_demo_oak.py), which is not installed. "
                "Use DirectorySource to replay captured frames, or run the capture on a machine with the camera "
                "attached and stream to `cli serve` through serve/client.py."
            ) from e
        self._dai = depthai
        self.resolution = resolution
        self.queue_size = queue_size

    def _build(self):  # pragma: no cover - requires camera hardware
        dai = self._dai
        pipeline = dai.Pipeline()
        cam_l = pipeline.create(dai.node.MonoCamera)
        cam_r = pipeline.create(dai.node.MonoCamera)
        stereo = pipeline.create(dai.node.StereoDepth)
        cam_l.setBoardSocket(dai.CameraBoardSocket.LEFT)
        cam_r.setBoardSocket(dai.CameraBoardSocket.RIGHT)
        res = {
            "400": dai.MonoCameraProperties.SensorResolution.THE_400_P,
            "720": dai.MonoCameraProperties.SensorResolution.THE_720_P,
            "800": dai.MonoCameraProperties.SensorResolution.THE_800_P,
        }[self.resolution]
        for cam in (cam_l, cam_r):
            cam.setResolution(res)
        stereo.setDefaultProfilePreset(dai.node.StereoDepth.PresetMode.HIGH_DENSITY)
        stereo.initialConfig.setMedianFilter(
            dai.StereoDepthProperties.MedianFilter.KERNEL_7x7
        )
        stereo.setRectifyEdgeFillColor(0)
        stereo.setLeftRightCheck(True)
        stereo.setExtendedDisparity(False)
        stereo.setSubpixel(True)
        stereo.setSubpixelFractionalBits(3)
        cfg = stereo.initialConfig.get()
        cfg.postProcessing.speckleFilter.enable = False
        cfg.postProcessing.temporalFilter.enable = True
        cfg.postProcessing.spatialFilter.enable = True
        cfg.postProcessing.spatialFilter.holeFillingRadius = 2
        cfg.postProcessing.spatialFilter.numIterations = 1
        cfg.postProcessing.thresholdFilter.minRange = 400
        cfg.postProcessing.thresholdFilter.maxRange = 15000
        stereo.initialConfig.set(cfg)
        cam_l.out.link(stereo.left)
        cam_r.out.link(stereo.right)
        outs = {}
        for name, src in (
            ("rectifiedLeft", stereo.rectifiedLeft),
            ("rectifiedRight", stereo.rectifiedRight),
            ("disparity", stereo.disparity),
        ):
            x = pipeline.create(dai.node.XLinkOut)
            x.setStreamName(name)
            src.link(x.input)
            outs[name] = x
        return pipeline

    def __iter__(self):  # pragma: no cover - requires camera hardware
        dai = self._dai
        with dai.Device() as device:
            device.startPipeline(self._build())
            qs = [
                device.getOutputQueue(n, self.queue_size, blocking=False)
                for n in ("rectifiedLeft", "rectifiedRight", "disparity")
            ]
            pending: dict[str, dict[int, np.ndarray]] = {
                n: {} for n in ("rectifiedLeft", "rectifiedRight", "disparity")
            }
            while True:
                # pair the three non-blocking XLink streams by sequence
                # number — under host stalls the queues drop frames
                # independently, so naive q.get() triples drift out of sync
                # (a weakness the reference demo shares)
                for q in qs:
                    msg = q.get()
                    pending[q.getName()][msg.getSequenceNum()] = msg.getCvFrame()
                common = set.intersection(
                    *(set(d.keys()) for d in pending.values())
                )
                if not common:
                    for d in pending.values():  # bound buffering
                        while len(d) > 8:
                            d.pop(min(d))
                    continue
                seq = max(common)
                frames = {n: d.pop(seq) for n, d in pending.items()}
                for d in pending.values():  # drop frames older than the pair
                    for k in [k for k in d if k < seq]:
                        d.pop(k)
                l = np.repeat(
                    frames["rectifiedLeft"][..., None], 3, axis=-1
                ).astype(np.float32) / 255.0
                r = np.repeat(
                    frames["rectifiedRight"][..., None], 3, axis=-1
                ).astype(np.float32) / 255.0
                sgm = frames["disparity"].astype(np.float32) / (2**3)
                yield l, r, sgm


# ---------------------------------------------------------------------------
# The loop


@dataclass
class CaptureLoop:
    """Clip -> infer -> EMA-smooth each stereo frame (reference
    fast_demo_oak.py:225-299 loop body, display decoupled into `on_frame`).

    infer: (left, right) float [0,1] RGB -> (H,W) disparity, numpy.  Use a
    `StereoAnywherePipeline` locally (`cli camera` wraps its call) or
    `functools.partial(serve.client.infer_remote, server)` remotely.
    clip: (top, bottom, left, right) border crop applied to the OUTPUT
    disparity and the frames in the result dict — the reference demo
    infers on the full frame and clips only what it displays
    (fast_demo_oak.py:250-311 --clip_* args), and so does this loop.
    on_frame: called with a result dict per frame; return False to stop.
    """

    infer: Callable[[np.ndarray, np.ndarray], np.ndarray]
    ema_alpha: float = 0.15
    clip: tuple[int, int, int, int] = (0, 0, 0, 0)
    on_frame: Callable[[dict], bool | None] | None = None
    stats: dict = field(default_factory=dict)

    def _clip(self, x: np.ndarray) -> np.ndarray:
        t, b, l, r = self.clip
        h, w = x.shape[:2]
        return x[t : h - b if b else h, l : w - r if r else w]

    def run(self, source: Iterable, max_frames: int | None = None) -> int:
        smooth = ema_filter(self.ema_alpha)
        n, t0 = 0, time.perf_counter()
        for frame in source:
            left, right, sgm = (*frame, None)[:3]
            disp = np.asarray(self.infer(left, right), np.float32)
            left, right, disp = self._clip(left), self._clip(right), self._clip(disp)
            smoothed = smooth(disp)
            n += 1
            fps = n / (time.perf_counter() - t0)
            self.stats = {"frames": n, "fps": fps}
            if self.on_frame is not None:
                res = self.on_frame(
                    {
                        "index": n - 1,
                        "left": left,
                        "right": right,
                        "disparity": disp,
                        "smoothed": smoothed,
                        "sgm": None if sgm is None else self._clip(sgm),
                        "fps": fps,
                    }
                )
                if res is False:
                    break
            if max_frames is not None and n >= max_frames:
                break
        return n
