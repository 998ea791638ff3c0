"""The port's evaluation path against the JAX package's, on the CPU in f32.

Module by module, on seeded numpy inputs:
- metrics and report: equal to 1e-6 (copies of the same numpy code);
- `resize_np` (`jax.image.resize`'s nearest and antialiased bilinear) and
  `resize_bicubic_halfpix` (torch's a=-0.75 bicubic): nearest exact, the
  others to 1e-6;
- `infer_mono_depth`: DAv2 ViT-S with the same weights, within 1e-4 of the
  depth's magnitude (the f32 ViT's sums in another order);
- the harness's protocol with one deterministic numpy `stereo_fn` and
  `mono_fn` shared by both packages: per-sample metrics equal to 1e-6;
- the model through the harness and `cli eval` against the JAX CLI, with
  the same stereo weights and 2 GRU iterations: disparity within 1e-3 px
  plus 5e-5 of its magnitude (the pipeline's tolerance,
  `tests/test_torch_pipeline.py` gives the reasons), continuous metrics
  within 1e-4 relative, bad-pixel fractions within one pixel's share;
- `precompute-mono` writing what `eval --mono-precomputed` reads.
"""
import csv
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from stereoanywhere_tpu.eval import harness as jh
from stereoanywhere_tpu.eval import metrics as jm
from stereoanywhere_tpu.eval import report as jr

from stereoanywhere_tpu_torch.eval import harness as ph
from stereoanywhere_tpu_torch.eval import metrics as pm
from stereoanywhere_tpu_torch.eval import report as pr

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _same_dict(got: dict, want: dict, rtol: float = 1e-6):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        if isinstance(w, np.ndarray):
            np.testing.assert_array_equal(g, w, err_msg=k)
        elif np.isnan(w):
            assert np.isnan(g), k
        else:
            assert abs(g - w) <= rtol * max(1.0, abs(w)), (k, g, w)


def _maps(seed, h=30, w=44, valid="some", occ="some"):
    rng = np.random.default_rng(seed)
    gt = rng.uniform(0.5, 40, (h, w)).astype(np.float32)
    disp = (gt + rng.normal(0, 3, (h, w))).astype(np.float32)
    v = {"some": rng.uniform(size=(h, w)) > 0.3, "none": np.zeros((h, w), bool)}[valid].astype(np.float32)
    m = {"some": rng.uniform(size=(h, w)) > 0.7, "empty": np.zeros((h, w), bool)}[occ].astype(np.float32)
    return disp, gt, v, m


@pytest.mark.parametrize("valid,occ", [("some", "some"), ("some", "empty"), ("none", "some"), ("some", None)],
                         ids=["maskocc", "empty-maskocc", "all-invalid", "no-maskocc"])
@pytest.mark.filterwarnings("ignore::RuntimeWarning")
def test_metrics_match_jax(valid, occ):
    disp, gt, v, m = _maps(1, valid=valid, occ=occ or "empty")
    _same_dict(pm.guided_metrics(disp, gt, v, None if occ is None else m),
               jm.guided_metrics(disp, gt, v, None if occ is None else m))
    depth = np.abs(disp) + 0.1
    for name in ("depth_metrics", "kitti_metrics", "middlebury_metrics", "booster_metrics"):
        a = depth if name == "depth_metrics" else disp
        _same_dict(getattr(pm, name)(a, gt, v), getattr(jm, name)(a, gt, v))


def test_report_matches_jax(tmp_path):
    rows = [{"bad 2.0": 0.1 * i, "avgerr": 1.5 + i, "rms": 2.0 / (i + 1)} for i in range(3)]
    tries = {}
    for mod in (jr, pr):
        it = iter(rows)
        tries[mod] = mod.run_tries(lambda: next(it), 3)
    assert tries[pr] == tries[jr]
    for keys, pct in ((("bad 2.0", "avgerr"), None), (("avgerr", "rms", "missing"), [False, True, False])):
        assert pr.latex_row(rows[1], keys, pct, 3) == jr.latex_row(rows[1], keys, pct, 3)
    for mod, name in ((jr, "j.csv"), (pr, "p.csv")):
        for r in rows[:2]:
            mod.append_csv(str(tmp_path / name), {**r, "dataset": "middlebury"})
    assert (tmp_path / "p.csv").read_text() == (tmp_path / "j.csv").read_text()
    assert pr.BENCHMARK_HEADLINE_KEYS == jr.BENCHMARK_HEADLINE_KEYS


@pytest.mark.parametrize("src,dst", [((375, 20), (93, 20)), ((8, 8), (3, 3)), ((8, 5), (3, 13)), ((40, 56), (80, 111)),
                                     ((82, 7), (41, 7)), ((3, 8), (8, 21))])
def test_resize_np_matches_jax(src, dst):
    x = np.random.default_rng(sum(src)).uniform(0, 1, (2, *src, 3)).astype(np.float32)
    np.testing.assert_array_equal(ph.resize_np(x, dst, nearest=True), jh.resize_np(x, dst, nearest=True))
    np.testing.assert_allclose(ph.resize_np(x, dst), jh.resize_np(x, dst), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("src,dst", [((40, 60), (70, 98)), ((375, 450), (93, 121)), ((9, 31), (23, 7))])
def test_resize_bicubic_halfpix_matches_jax(src, dst):
    from stereoanywhere_tpu.ops.interp import resize_bicubic_halfpix as jresize

    from stereoanywhere_tpu_torch.ops.interp import resize_bicubic_halfpix

    x = np.random.default_rng(src[0]).uniform(0, 1, (2, *src, 3)).astype(np.float32)
    want = np.asarray(jresize(jnp.asarray(x), dst))
    got = resize_bicubic_halfpix(torch.from_numpy(x).permute(0, 3, 1, 2), dst).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def _dav2_pair(seed=4):
    """The port's seeded ViT-S DAv2 and the same weights as a JAX tree."""
    from stereoanywhere_tpu.compat.torch_convert import convert_dav2_checkpoint
    from stereoanywhere_tpu.config import MonoConfig as JMono
    from stereoanywhere_tpu.models.dpt import DepthAnythingV2 as JD

    from stereoanywhere_tpu_torch.config import MonoConfig
    from stereoanywhere_tpu_torch.models.dpt import DepthAnythingV2

    model = DepthAnythingV2(MonoConfig.for_encoder("vits"), device="cpu", generator=torch.Generator().manual_seed(seed))
    variables = convert_dav2_checkpoint({k: v.numpy() for k, v in model.state_dict().items()})
    return model, JD(JMono.for_encoder("vits")), jax.tree.map(jnp.asarray, variables)


def test_infer_mono_depth_matches_jax():
    from stereoanywhere_tpu.models.dpt import dav2_input_size, infer_mono_depth as jinfer

    from stereoanywhere_tpu_torch.models.dpt import infer_mono_depth

    model, jmodel, jvars = _dav2_pair()
    assert dav2_input_size(40, 60, 98, 56) == (70, 98)
    x = np.random.default_rng(0).uniform(0, 1, (2, 40, 60, 3)).astype(np.float32)
    want = np.asarray(jax.jit(lambda v, x: jinfer(jmodel, v, x, 98, 56))(jvars, x))
    got = infer_mono_depth(model, torch.from_numpy(x), 98, 56).numpy()
    assert got.shape == want.shape == (2, 40, 60, 1) and np.abs(want).max() > 0
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def test_padding_and_buckets_match_jax():
    x = np.random.default_rng(0).uniform(0, 1, (1, 37, 53, 3)).astype(np.float32)
    for got, want in ((ph.pad_to_shape(x, (64, 128)), jh.pad_to_shape(x, (64, 128))),
                      (ph.pad_to_multiple(x, 32), jh.pad_to_multiple(x, 32))):
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]
        np.testing.assert_array_equal(ph.unpad(got[0], got[1]), x)
    sizes = [(375, 1242), (370, 1224), (497, 741), (486, 720), (375, 450), (100, 2000), (600, 300), (30, 40),
             (720, 1280), (497, 741)]
    pb, jb = ph.ShapeBucketer(max_buckets=3), jh.ShapeBucketer(max_buckets=3)
    assert [pb.bucket_for(*s) for s in sizes] == [jb.bucket_for(*s) for s in sizes]
    assert pb.buckets == jb.buckets and len(pb.buckets) == 3
    assert ph.DAV2_SIZES == jh.DAV2_SIZES and ph.EVAL_SCALES == jh.EVAL_SCALES
    assert all(ph.eval_preset(d) == jh.eval_preset(d) for d in ("booster", "layeredflow", "kitti2015"))


# one deterministic numpy model for both harnesses: the protocol alone
def _stereo_fn(im2, im3, m2, m3):
    im2, im3, m2, m3 = (np.asarray(a) for a in (im2, im3, m2, m3))
    return (20 * m2 + 5 * im2.mean(-1, keepdims=True) - 3 * im3[..., :1] + 2 * m3 + 1).astype(np.float32)


def _mono_fn(images01, dataset):
    x = np.asarray(images01)
    return (1 + 4 * x[..., :1] + x[..., 1:2] ** 2).astype(np.float32)


def _sample(rng, h, w, zero_gt=False, depth=False, mono=False):
    gt = np.where(rng.uniform(size=(h, w, 1)) > 0.2, rng.uniform(1, 30, (h, w, 1)), 0).astype(np.float32)
    if zero_gt:
        gt[:] = 0
    s = {"im2": rng.uniform(0, 1, (h, w, 3)).astype(np.float32), "im3": rng.uniform(0, 1, (h, w, 3)).astype(np.float32),
         "gt": gt, "validgt": (gt > 0).astype(np.float32),
         "maskocc": (rng.uniform(size=(h, w, 1)) > 0.8).astype(np.float32)}
    if depth:
        s["gt_depth"] = np.where(gt > 0, rng.uniform(0.3, 5, (h, w, 1)), 0).astype(np.float32)
    if mono:
        s["im2_mono"], s["im3_mono"] = (rng.uniform(0, 1, (h, w, 1)).astype(np.float32) for _ in range(2))
    return s


CASES = {
    "iscale=oscale=2": dict(kw=dict(iscale=2.0, oscale=2.0), samples=[(45, 67), (38, 51)]),
    "iscale 2, oscale 1": dict(kw=dict(iscale=2.0, oscale=1.0), samples=[(45, 67), (38, 51)]),
    "all-zero gt": dict(kw={}, samples=[(40, 50)], zero_gt=True),
    "monotrap": dict(kw=dict(dataset_name="monotrap"), samples=[(33, 47), (30, 40)], depth=True),
    "precomputed mono, pad-32": dict(kw=dict(bucketer=None), samples=[(33, 70), (65, 31)], mono=True),
    "buckets overflow": dict(kw=dict(bucketer="cap1"), samples=[(33, 70), (65, 31), (20, 20)]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_evaluator_protocol_matches_jax(case, tmp_path):
    c = CASES[case]
    rng = np.random.default_rng(len(case))
    samples = [_sample(rng, h, w, c.get("zero_gt", False), c.get("depth", False), c.get("mono", False))
               for h, w in c["samples"]]
    results = {}
    for label, mod in (("jax", jh), ("port", ph)):
        kw = dict(c["kw"])
        if kw.get("bucketer") == "cap1":
            kw["bucketer"] = mod.ShapeBucketer(max_buckets=1)
        ev = mod.Evaluator(_stereo_fn, None if c.get("mono") else _mono_fn,
                           save_images_dir=str(tmp_path / label) if case == "iscale=oscale=2" else None, **kw)
        results[label] = ev.run(samples)
    assert len(results["port"].per_sample) == len(samples)
    for got, want in zip(results["port"].per_sample, results["jax"].per_sample):
        _same_dict(got, want)
    if case == "monotrap":
        assert "depth/avgrelerr" in results["port"].per_sample[0]
    _same_dict(results["port"].mean(), results["jax"].mean())
    if case == "iscale=oscale=2":  # --save-images: the same panels, pixel for pixel
        names = sorted(os.listdir(tmp_path / "jax"))
        assert names == sorted(os.listdir(tmp_path / "port")) and len(names) == 12
        for n in names:
            np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "port" / n)),
                                          np.asarray(Image.open(tmp_path / "jax" / n)), err_msg=n)


def _close_metrics(got: dict, want: dict, pixels: int):
    """Continuous metrics within 1e-4 relative; a bad-pixel fraction within
    one pixel's share of the smallest selection."""
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        if np.isnan(w):
            assert np.isnan(g), k
        elif "bad" in k:
            assert abs(g - w) <= 1.0 / pixels + 1e-9, (k, g, w)
        else:
            assert abs(g - w) <= 1e-4 * max(abs(w), 1e-6), (k, g, w)


@pytest.fixture(scope="module")
def stereo_pair():
    """The port's seeded stereo model (default widths) and the JAX model
    with the same weights, through the JAX package's converter."""
    from stereoanywhere_tpu.compat.torch_convert import convert_stereo_checkpoint
    from stereoanywhere_tpu.config import StereoAnywhereConfig as JCfg
    from stereoanywhere_tpu.models import StereoAnywhere as JSA

    from stereoanywhere_tpu_torch.config import StereoAnywhereConfig
    from stereoanywhere_tpu_torch.models.stereoanywhere import StereoAnywhere

    model = StereoAnywhere(StereoAnywhereConfig(), device="cpu", generator=torch.Generator().manual_seed(7))
    variables = convert_stereo_checkpoint({k: v.numpy() for k, v in model.state_dict().items()})
    return model, JSA(JCfg()), {k: jax.tree.map(jnp.asarray, v) for k, v in variables.items()}


def test_the_model_through_the_harness_matches_jax(stereo_pair):
    """`EvalPrograms.stereo_fn` (eager on the CPU) against the JAX model's
    forward, both through their harness, on samples of two sizes that share
    the bucket 64x128, with precomputed mono."""
    from stereoanywhere_tpu_torch.eval.programs import EvalPrograms

    model, jmodel, jvars = stereo_pair
    jfwd = jax.jit(lambda *a: jmodel.apply(jvars, *a, iters=2, test_mode=True)["disparity"])
    programs = EvalPrograms(model, None, iters=2, device="cpu")
    disps = {"jax": [], "port": []}

    def recording(label, fn):
        def call(*a):
            out = np.asarray(fn(*a))
            disps[label].append(out)
            return out
        return call

    rng = np.random.default_rng(11)
    samples = [_sample(rng, h, w, mono=True) for h, w in ((60, 90), (64, 96))]
    res = {label: mod.Evaluator(recording(label, fn), None).run(samples)
           for label, mod, fn in (("jax", jh, lambda *a: jfwd(*map(jnp.asarray, a))), ("port", ph, programs.stereo_fn))}
    assert [d.shape for d in disps["port"]] == [(1, 64, 128, 1)] * 2 and not programs.programs  # eager on the CPU
    for got, want in zip(disps["port"], disps["jax"]):
        np.testing.assert_allclose(got, want, rtol=5e-5, atol=1e-3)
    occ = min(int(((s["maskocc"] > 0) & (s["validgt"] > 0)).sum()) for s in samples)
    for got, want in zip(res["port"].per_sample, res["jax"].per_sample):
        _close_metrics(got, want, pixels=occ)


@pytest.fixture(scope="module")
def middlebury(tmp_path_factory, stereo_pair):
    """A 2-scene 64x96 Middlebury directory with precomputed mono ("DAv2"),
    the stereo model as a reference-style .pth, and a ViT-S DAv2 .pth."""
    from stereoanywhere_tpu_torch.data.frame_utils import write_mono16, write_pfm

    root = tmp_path_factory.mktemp("eval")
    rng = np.random.default_rng(0)
    for scene in ("sceneA", "sceneB"):
        d = root / "mb" / scene
        d.mkdir(parents=True)
        for name in ("im0", "im1"):
            Image.fromarray(rng.integers(0, 256, (64, 96, 3), dtype=np.uint8)).save(d / f"{name}.png")
            write_mono16(str(d / f"{name}_DAv2.png"), rng.uniform(0, 1, (64, 96)))
        write_pfm(str(d / "disp0GT.pfm"), rng.uniform(1, 60, (64, 96)).astype(np.float32))
        Image.fromarray(rng.choice(np.array([0, 128, 255], np.uint8), (64, 96))).save(d / "mask0nocc.png")
    model = stereo_pair[0]
    pth = root / "stereo.pth"
    torch.save({"state_dict": {f"module.{k}": v for k, v in model.state_dict().items()}}, pth)
    dav2 = _dav2_pair()[0]
    torch.save(dav2.state_dict(), root / "dav2_vits.pth")
    return root, str(pth), str(root / "dav2_vits.pth")


def test_cli_eval_matches_the_jax_cli(middlebury, capsys):
    """`eval` with --tries 2, --csv and --save-images in both CLIs."""
    from stereoanywhere_tpu import cli as jax_cli

    from stereoanywhere_tpu_torch import cli
    from stereoanywhere_tpu_torch.data.datasets import fetch_dataset

    root, pth, _ = middlebury
    means, outs = {}, {}
    for label, main, extra in (("jax", jax_cli.main, []), ("port", cli.main, ["--device", "cpu"])):
        means[label] = main(["eval", "--dataset", "middlebury", "--datapath", str(root / "mb"), "--checkpoint", pth,
                             "--iters", "2", "--mono-precomputed", "DAv2", "--tries", "2",
                             "--csv", str(root / f"{label}.csv"), "--save-images", str(root / f"{label}-images"),
                             *extra])
        outs[label] = capsys.readouterr().out
    samples = fetch_dataset("middlebury", str(root / "mb"))
    _close_metrics(means["port"], means["jax"], pixels=min(int(samples[i]["maskocc"].sum()) for i in range(2)))
    assert '"std:avgerr": 0.0,' in outs["port"]  # two tries, the same answers
    assert "paper 0.9400" in outs["port"] and "random init" not in outs["port"]
    rows = {k: list(csv.DictReader(open(root / f"{k}.csv"))) for k in ("jax", "port")}
    assert list(rows["port"][0]) == list(rows["jax"][0]) and len(rows["port"]) == 1
    assert rows["port"][0]["dataset"] == "middlebury" and rows["port"][0]["tries"] == "2"
    names = sorted(os.listdir(root / "jax-images"))
    assert names == sorted(os.listdir(root / "port-images")) and len(names) == 4 * 6  # 2 tries x 2 samples x 6
    for n in names:
        got, want = (np.asarray(Image.open(root / f"{k}-images" / n)) for k in ("port", "jax"))
        assert got.shape == want.shape == (64, 96, 3), n
        if n.endswith(("_left.png", "_gt.png", "_mono.png")):
            np.testing.assert_array_equal(got, want, err_msg=n)


def test_cli_eval_finds_a_dropped_in_checkpoint(middlebury, capsys, monkeypatch):
    from stereoanywhere_tpu_torch import cli

    root, pth, _ = middlebury
    argv = ["eval", "--dataset", "middlebury", "--datapath", str(root / "mb"), "--iters", "1",
            "--mono-precomputed", "DAv2", "--device", "cpu", "--max-samples", "1"]
    monkeypatch.setenv("SA_CHECKPOINT", pth)
    found = cli.main(argv)
    assert f"auto-detected checkpoint: {pth}" in capsys.readouterr().out
    assert found == cli.main(argv + ["--checkpoint", pth])
    monkeypatch.setenv("SA_CHECKPOINT", str(root / "absent.tar"))
    cli.main(argv)
    assert "[random init" in capsys.readouterr().out


def test_precompute_mono_feeds_eval(middlebury, tmp_path, capsys):
    """`precompute-mono` (ViT-S) writes each view's depth beside the images
    under the tag it prints, and `eval --mono-precomputed <tag>` reads it.
    With --outdir it writes the JAX CLI's files instead: the same names, and
    each view's `infer_mono_depth` at DAv2's default size, normalised to
    [0,1] and stored in 16 bits (`infer_mono_depth` is held against JAX
    above)."""
    from stereoanywhere_tpu_torch import cli
    from stereoanywhere_tpu_torch.data.datasets import fetch_dataset
    from stereoanywhere_tpu_torch.data.frame_utils import write_pfm
    from stereoanywhere_tpu_torch.models.dpt import infer_mono_depth

    root, pth, dav2 = middlebury
    mb = tmp_path / "mb"
    scene = mb / "sceneA"
    scene.mkdir(parents=True)
    rng = np.random.default_rng(3)
    for name in ("im0", "im1"):
        Image.fromarray(rng.integers(0, 256, (32, 32, 3), dtype=np.uint8)).save(scene / f"{name}.png")
    write_pfm(str(scene / "disp0GT.pfm"), rng.uniform(1, 20, (32, 32)).astype(np.float32))
    common = ["--dataset", "middlebury", "--datapath", str(mb), "--mono-checkpoint", dav2, "--mono-encoder", "vits",
              "--device", "cpu"]
    cli.main(["precompute-mono", *common])
    assert "--mono-precomputed DAv2_vits" in capsys.readouterr().out
    ds = fetch_dataset("middlebury", str(mb), mono="DAv2_vits")
    assert ds[0]["im2_mono"].shape == (32, 32, 1) and 0 <= ds[0]["im2_mono"].min() and ds[0]["im2_mono"].max() <= 1
    means = cli.main(["eval", "--dataset", "middlebury", "--datapath", str(mb), "--checkpoint", pth, "--iters", "1",
                      "--mono-precomputed", "DAv2_vits", "--device", "cpu"])
    assert np.isfinite(means["avgerr"])

    cli.main(["precompute-mono", *common, "--outdir", str(tmp_path / "out")])
    assert sorted(os.listdir(tmp_path / "out")) == ["000000_im2_DAv2_vits.png", "000000_im3_DAv2_vits.png"]
    model = cli._load_mono(dav2, "vits", "cpu")
    for key, view in (("im2", "im2_mono"), ("im3", "im3_mono")):
        d = infer_mono_depth(model, torch.from_numpy(ds[0][key][None])).numpy()[0, ..., 0]
        want = np.clip((d - d.min()) / max(d.max() - d.min(), 1e-6) * 65535.0, 0, 65535).astype(np.uint16)
        np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "out" / f"000000_{key}_DAv2_vits.png")), want)
        np.testing.assert_array_equal(ds[0][view][..., 0], want.astype(np.float32) / 65535.0)


def test_the_new_modules_import_no_jax():
    """The eval path's modules and the CLI load in a process where JAX and
    the JAX package cannot be imported."""
    code = ("import sys; sys.modules.update({m: None for m in ('jax', 'jaxlib', 'flax', 'stereoanywhere_tpu')}); "
            "import stereoanywhere_tpu_torch.eval.harness, stereoanywhere_tpu_torch.eval.programs, "
            "stereoanywhere_tpu_torch.eval.metrics, stereoanywhere_tpu_torch.eval.report, "
            "stereoanywhere_tpu_torch.data.datasets, stereoanywhere_tpu_torch.data.frame_utils, "
            "stereoanywhere_tpu_torch.utils.logging, stereoanywhere_tpu_torch.cli as c; "
            "c.main(['eval', '--help'])")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         env={**os.environ, "PYTHONPATH": ROOT})
    assert out.returncode == 0, out.stderr
    assert "--mono-precomputed" in out.stdout and "TF32" in out.stdout


@pytest.mark.parametrize("capture_at", [1, 2])
def test_programs_capture_at_their_first_or_second_call(monkeypatch, capture_at):
    """`_Program(capture_at=2)`, the evaluator's: the first call only warms
    up, the second captures and replays, later calls replay; with 1, the
    serving pipeline's, the first call warms up and captures.  (A stand-in
    graph here: CUDA graphs exist only on the card.)"""
    from contextlib import contextmanager

    from stereoanywhere_tpu_torch.eval.programs import EvalPrograms
    from stereoanywhere_tpu_torch.serve.pipeline import _Program

    events = []

    class Graph:
        def replay(self):
            events.append("replay")

    @contextmanager
    def capture(graph, pool=None):
        events.append("capture")
        yield

    monkeypatch.setattr(torch.cuda, "CUDAGraph", Graph)
    monkeypatch.setattr(torch.cuda, "graph", capture)
    program = _Program(lambda x: events.append("body") or x + 1, pool=None, capture_at=capture_at)
    calls = []
    for _ in range(3):
        assert torch.equal(program(torch.zeros(2)), torch.ones(2))
        calls.append(list(events))
        events.clear()
    assert calls == {1: [["body", "capture", "body"], ["replay"], ["replay"]],
                     2: [["body"], ["capture", "body", "replay"], ["replay"]]}[capture_at]
    assert program.graph is not None
    with pytest.raises(ValueError, match="capture_at"):
        _Program(lambda x: x, pool=None, capture_at=3)
    with pytest.raises(ValueError, match="CUDA graphs need the card"):
        EvalPrograms(torch.nn.Module(), device="cpu", graphs=True)


def test_cli_eval_needs_the_card_unless_asked_for_the_cpu(middlebury, monkeypatch):
    """No fallback: without a CUDA device `eval` and `precompute-mono`
    raise unless `--device cpu` is given."""
    from stereoanywhere_tpu_torch import cli

    root, pth, dav2 = middlebury
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["eval", "--dataset", "middlebury", "--datapath", str(root / "mb"), "--checkpoint", pth,
                  "--mono-precomputed", "DAv2"],
                 ["precompute-mono", "--dataset", "middlebury", "--datapath", str(root / "mb"),
                  "--mono-checkpoint", dav2, "--mono-encoder", "vits", "--outdir", str(root / "never")]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(argv)
    assert not (root / "never").exists()
