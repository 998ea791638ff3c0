"""The port's capture loop (`serve/camera.py`), its client (`serve/client.py`)
and `cli camera` against the JAX package's, on the CPU.

The loop and its helpers are copies: on the same frames, with one shared
numpy `infer`, the port's `CaptureLoop`, `ema_filter`, `rolling_max` and
`disparity_frame` give JAX's results bit for bit, the SGM stream included.
`cli camera` runs in both CLIs on the same three 64x96 PNG pairs with the
same stereo checkpoint (the port's seeded model as a reference `.tar`, which
the JAX CLI converts), 1 iteration, f32, stereo-only: the smoothed
disparities at the API within the pipeline's bound (1e-3 px + 5e-5 of the
magnitude, `tests/test_torch_cli.py`), the written frames within one level a
channel (the uint8 cast truncates, so a gap far below a level still moves a
channel by one where it sits at a level's edge).  Through `--server`
the loop's disparities are the local ones quantised by the protocol
(uint16 x256, truncated, negative disparity clipped to 0).
"""
import os
import sys
import threading

import numpy as np
import pytest
import torch
from PIL import Image

from stereoanywhere_tpu.serve import camera as jcam

from stereoanywhere_tpu_torch.serve import camera as pcam

torch.set_num_threads(2)


def _frames(seed, n=5, h=10, w=12, sgm=False):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        f = (rng.rand(h, w, 3).astype(np.float32), rng.rand(h, w, 3).astype(np.float32))
        out.append(f + ((rng.rand(h, w).astype(np.float32) * 9,) if sgm else ()))
    return out


def _infer(left, right):
    # a shared numpy stand-in of the model: the loop and the helpers are what is held here
    return left[..., 0] * 2.0 + right[..., 1] - 0.25


def _same_results(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        for k in ("index", "left", "right", "disparity", "smoothed", "sgm"):
            if x[k] is None or y[k] is None:
                assert x[k] is None and y[k] is None, k
            else:
                np.testing.assert_array_equal(x[k], y[k], err_msg=k)
                assert np.asarray(x[k]).dtype == np.asarray(y[k]).dtype, k


def test_ema_filter_equals_jax():
    rng = np.random.RandomState(0)
    xs = [rng.rand(4, 5).astype(np.float32) for _ in range(6)]
    for alpha in (0.15, 0.5):
        ps, js = pcam.ema_filter(alpha), jcam.ema_filter(alpha)
        for x in xs:
            np.testing.assert_array_equal(ps(x), js(x))


@pytest.mark.parametrize("clip", [(0, 0, 0, 0), (1, 2, 3, 0), (0, 3, 0, 4)])
def test_capture_loop_equals_jax(clip):
    frames = _frames(1, sgm=True)
    got, want = [], []
    for mod, seen in ((pcam, got), (jcam, want)):
        loop = mod.CaptureLoop(_infer, ema_alpha=0.3, clip=clip, on_frame=seen.append)
        assert loop.run(frames, max_frames=4) == 4 and loop.stats["frames"] == 4
    _same_results(got, want)
    t, b, left, r = clip
    assert got[0]["left"].shape == (10 - t - b, 12 - left - r, 3)  # the clip applies to the outputs
    assert got[0]["sgm"].shape == got[0]["disparity"].shape


def test_capture_loop_infers_on_the_whole_frame_and_stops_like_jax():
    frames = _frames(2)
    shapes = []

    def infer(left, right):
        shapes.append((left.shape, right.shape))
        return _infer(left, right)

    for mod in (pcam, jcam):
        shapes.clear()
        assert mod.CaptureLoop(infer, clip=(1, 2, 3, 0), on_frame=lambda res: False).run(frames) == 1
        assert shapes == [((10, 12, 3), (10, 12, 3))]
        seen = []
        assert mod.CaptureLoop(infer, on_frame=seen.append).run(iter(frames)) == 5
        assert seen[-1]["sgm"] is None and 0 < seen[-1]["fps"]


def test_capture_loop_passes_the_sgm_stream_like_jax():
    frames = [(np.ones((6, 6, 3)), np.ones((6, 6, 3)), np.full((6, 6), 7.0))]
    got, want = [], []
    for mod, seen in ((pcam, got), (jcam, want)):
        mod.CaptureLoop(lambda left, right: left[..., 0], on_frame=seen.append).run(frames)
    _same_results(got, want)
    np.testing.assert_array_equal(got[0]["sgm"], np.full((6, 6), 7.0))


@pytest.mark.parametrize("max_disp", [None, 64.0, 3.0])
def test_disparity_frame_equals_jax(max_disp):
    rng = np.random.default_rng(3)
    d = rng.uniform(-1, 80, (9, 13)).astype(np.float32)
    d[0, :3] = 0
    got, want = pcam.disparity_frame(d, max_disp), jcam.disparity_frame(d, max_disp)
    assert got.dtype == np.uint8 and got.shape == (9, 13, 3)
    np.testing.assert_array_equal(got, want)
    assert (got[d <= 0] == 0).all()


def test_rolling_max_equals_jax():
    ps, js = pcam.rolling_max(window=3), jcam.rolling_max(window=3)
    for x in ([1.0, 4.0], [8.0], [0.0], [1.0], [2.5, -1.0]):
        assert ps(np.array(x)) == js(np.array(x))


def test_directory_source_equals_jax(tmp_path):
    rng = np.random.default_rng(4)
    for side in ("left", "right"):
        os.makedirs(tmp_path / side)
        for i in range(3):
            Image.fromarray(rng.integers(0, 256, (8, 10, 3), dtype=np.uint8)).save(tmp_path / side / f"{i}.png")
    lists = [sorted(str(p) for p in (tmp_path / s).iterdir()) for s in ("left", "right")]
    got, want = list(pcam.DirectorySource(*lists)), list(jcam.DirectorySource(*lists))
    assert len(got) == 3
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype == np.float32
    looped = pcam.DirectorySource(*lists, loop=True)
    assert len([f for _, f in zip(range(7), looped)]) == 7
    with pytest.raises(AssertionError):
        pcam.DirectorySource([], [])


def test_oak_source_is_gated_without_depthai():
    if "depthai" in sys.modules:  # pragma: no cover
        pytest.skip("depthai installed")
    for mod in (pcam, jcam):
        with pytest.raises(ImportError, match="depthai"):
            mod.OakDSource()


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    from stereoanywhere_tpu_torch.config import StereoAnywhereConfig
    from stereoanywhere_tpu_torch.models.stereoanywhere import StereoAnywhere

    root = tmp_path_factory.mktemp("camera")
    model = StereoAnywhere(StereoAnywhereConfig(), device="cpu", generator=torch.Generator().manual_seed(21))
    tar = root / "stereo.tar"
    torch.save({"state_dict": {f"module.{k}": v for k, v in model.state_dict().items()}}, tar)
    rng = np.random.default_rng(5)
    for side in ("left", "right"):
        os.makedirs(root / side)
        for i in range(3):
            Image.fromarray(rng.integers(0, 256, (64, 96, 3), dtype=np.uint8)).save(root / side / f"{i:02d}.png")
    return root, str(tar)


def _camera_argv(root, tar, out, *extra):
    return ["camera", "--left-glob", str(root / "left" / "*.png"), "--right-glob", str(root / "right" / "*.png"),
            "-o", str(out), "--checkpoint", tar, "--iters", "1", "--ema-alpha", "0.4", *extra]


def test_cli_camera_matches_the_jax_cli(scene, monkeypatch):
    from stereoanywhere_tpu import cli as jax_cli

    from stereoanywhere_tpu_torch import cli

    root, tar = scene
    smoothed = {}
    for label, main, mod, extra in (("jax", jax_cli.main, jcam, []), ("port", cli.main, pcam, ["--device", "cpu"])):
        seen = smoothed[label] = []
        frame = mod.disparity_frame

        def recording(disp, max_disp=None, _seen=seen, _frame=frame):
            _seen.append(np.array(disp))
            return _frame(disp, max_disp)

        monkeypatch.setattr(mod, "disparity_frame", recording)
        main(_camera_argv(root, tar, root / label, "--clip-left", "5", *extra))
    assert len(smoothed["port"]) == len(smoothed["jax"]) == 3
    for got, want in zip(smoothed["port"], smoothed["jax"]):
        assert got.shape == want.shape == (64, 91)
        np.testing.assert_allclose(got, want, rtol=5e-5, atol=1e-3)
    names = sorted(os.listdir(root / "port"))
    assert names == sorted(os.listdir(root / "jax")) == [f"frame_{i:05d}.png" for i in range(3)]
    for name in names:
        got, want = (np.asarray(Image.open(root / k / name)).astype(int) for k in ("port", "jax"))
        assert got.shape == want.shape == (64, 91, 3)
        assert np.abs(got - want).max() <= 1


def _recording(seen, base=pcam.CaptureLoop):
    """CaptureLoop that also keeps each frame's result dict in `seen`."""

    class Recording(base):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            on_frame = self.on_frame

            def both(res):
                seen.append(res)
                return on_frame(res)

            self.on_frame = both

    return Recording


def test_cli_camera_through_a_server_is_the_local_loop_quantised(scene, monkeypatch):
    from stereoanywhere_tpu_torch import cli
    from stereoanywhere_tpu_torch.config import StereoAnywhereConfig
    from stereoanywhere_tpu_torch.serve import client
    from stereoanywhere_tpu_torch.serve.pipeline import StereoAnywherePipeline, make_http_server

    root, tar = scene
    pipe = StereoAnywherePipeline(cli._load_stereo(tar, StereoAnywhereConfig(), "cpu"), None, iters=1, device="cpu")
    server = make_http_server(pipe, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    runs = {}
    try:
        for label, extra in (("local", []), ("remote", ["--server", url])):
            runs[label] = []
            monkeypatch.setattr(pcam, "CaptureLoop", _recording(runs[label]))
            cli.main(_camera_argv(root, tar, root / label, "--max-frames", "2", "--clip-top", "8", "--device", "cpu",
                                  *extra))
        pair = [np.asarray(Image.open(root / s / "00.png"), np.float32) / 255.0 for s in ("left", "right")]
        direct = client.infer_remote(url, *pair)
    finally:
        server.shutdown()
        server.server_close()
    local, remote = ([r["disparity"] for r in runs[k]] for k in ("local", "remote"))
    assert len(local) == len(remote) == 2 and local[0].shape == (56, 96)
    for a, b in zip(local, remote):
        gap = a - b
        inside = (a >= 0) & (a < 256)  # the protocol clips to [0, 65535 / 256]
        assert inside.any() and (gap[inside] >= 0).all() and (gap[inside] < 1 / 256).all()
        assert (b[a < 0] == 0).all()
    np.testing.assert_array_equal(remote[0], direct[8:])
    assert sorted(os.listdir(root / "remote")) == ["frame_00000.png", "frame_00001.png"]


def test_stream_pairs_and_file_pair_source_equal_jax(scene, monkeypatch):
    """The client's helpers against JAX's, with the HTTP call replaced by
    one shared numpy function."""
    from stereoanywhere_tpu.serve import client as jclient

    from stereoanywhere_tpu_torch.serve import client as pclient

    root, _ = scene
    lists = [sorted(str(p) for p in (root / s).iterdir()) for s in ("left", "right")]
    frames = {k: list(m.file_pair_source(*lists)) for k, m in (("port", pclient), ("jax", jclient))}
    for g, w in zip(*frames.values()):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
    out = {}
    for k, m in (("port", pclient), ("jax", jclient)):
        monkeypatch.setattr(m, "infer_remote", lambda server, im2, im3, timeout=120.0: _infer(im2, im3))
        out[k] = list(m.stream_pairs("http://unused", frames[k], ema_alpha=0.25))
    assert len(out["port"]) == 3
    for a, b in zip(out["port"], out["jax"]):
        np.testing.assert_array_equal(a, b)
