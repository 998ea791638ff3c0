"""Command-line entry points of the port: `eval`, `train`,
`precompute-mono`, `convert`, `infer`, `serve` and `camera`.

The counterparts of the JAX package's `cli.py` subcommands of those names,
with its flags and a `--device` (default the card; "cpu" runs eagerly
there; `convert` runs on the host):

  python -m stereoanywhere_tpu_torch.cli eval --dataset middlebury --datapath ... \\
      --checkpoint sceneflow.tar --mono-checkpoint depth_anything_v2_vitl.pth
  python -m stereoanywhere_tpu_torch.cli train --dataset sceneflow --datapath "ft;monkaa;driving" \\
      --mono-precomputed DAv2 --savedir runs/sf
  python -m stereoanywhere_tpu_torch.cli precompute-mono --dataset middlebury --datapath ... \\
      --mono-checkpoint depth_anything_v2_vitl.pth
  python -m stereoanywhere_tpu_torch.cli infer left.png right.png -o out \\
      --checkpoint sceneflow.tar --mono-checkpoint depth_anything_v2_vitl.pth
  python -m stereoanywhere_tpu_torch.cli serve --checkpoint ... --port 8008
  python -m stereoanywhere_tpu_torch.cli convert --input sceneflow.tar --output sceneflow.msgpack
  python -m stereoanywhere_tpu_torch.cli camera --left-glob "left/*.png" --right-glob "right/*.png" \\
      --checkpoint sceneflow.msgpack --mono-checkpoint depth_anything_v2_vitl.pth -o camera_out

Checkpoints are the reference's PyTorch files (`.pth` / `.tar`), read
straight into the port's modules under the reference parameter names, or
the JAX package's flax `.msgpack` files, which `convert` writes from a
reference file (`--kind stereo|dav2`) and which load through the same name
table (`compat/msgpack.py`, `compat/from_jax.py`), in place.
Without `--checkpoint` the stereo model gets seeded random weights (`eval`
first looks for `$SA_CHECKPOINT`, else `sceneflow.tar` in the working
directory); without `--mono-checkpoint` `infer` and `serve` run stereo-only
on zero depth and `eval` reads the dataset's precomputed mono depth
(`--mono-precomputed`), as the JAX CLI does.  On the card `infer` and
`serve` serve each input shape from its CUDA graph, and `eval` runs its
programs on graphs too (`eval/programs.py`).  With `--dtype float32` the
card runs cuDNN's convolutions in TF32 (PyTorch's default,
`torch.backends.cudnn.allow_tf32`) and the matrix products in f32.
`--mono-encoder` takes vits, vitb, vitl or vitg.  `train` starts from
`--checkpoint` when one is given (the JAX CLI ignores it there); with
`--dtype bfloat16` it trains in mixed precision on f32 master weights.
`train --data-parallel N` spawns N processes, one a card (`cuda:0..N-1`;
gloo processes with `--device cpu`), with a local rendezvous; `train
--multihost` is one process of a launch by torchrun (or by hand, with
torchrun's environment: RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR,
MASTER_PORT):

  torchrun --nproc-per-node 4 -m stereoanywhere_tpu_torch.cli train --multihost \
      --dataset sceneflow --datapath "ft;monkaa;driving" --mono-precomputed DAv2 --batch-size 8

Either way `--batch-size` is the global batch, which each process loads a
slice of.  `infer --shard-rows N` spawns N ranks the same way and shards
the stereo branch's image rows over them (`parallel/spatial.py`: exact, no
tile seams); each rank runs the mono stage whole, and rank 0 writes the
outputs.  On the card it takes N cards over NCCL, one a rank, and refuses
with fewer; with `--device cpu` the ranks are gloo processes.  `camera` is
the live capture loop (`serve/camera.py`): frames from an OAK-D (`--source
oak`, which needs the depthai SDK) or replayed from two globs, inferred by
the pipeline on its CUDA graphs (or by a `serve` endpoint, `--server`),
EMA-smoothed and written as `frame_%05d.png` (and the camera's SGM stream
as `frame_%05d_sgm.png`); it returns the `CaptureLoop`.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import torch

from stereoanywhere_tpu_torch.config import MonoConfig, StereoAnywhereConfig
from stereoanywhere_tpu_torch.device import resolve_device, torch_dtype


def _load_stereo(checkpoint: str | None, cfg: StereoAnywhereConfig, device: str = "cuda",
                 param_dtype: torch.dtype | None = None):
    """The stereo model on `device`, its parameters in `param_dtype` (by
    default the compute dtype): the checkpoint's weights, or seeded random
    ones (seed 0) without one."""
    from stereoanywhere_tpu_torch.compat.torch_checkpoint import load_state_dict_into, load_torch_state_dict
    from stereoanywhere_tpu_torch.models.stereoanywhere import StereoAnywhere

    model = StereoAnywhere(cfg, device=resolve_device(device), generator=torch.Generator().manual_seed(0),
                           param_dtype=param_dtype)
    if checkpoint and checkpoint.endswith(".msgpack"):
        from stereoanywhere_tpu_torch.compat import msgpack
        from stereoanywhere_tpu_torch.compat.from_jax import load_stereo_variables

        load_stereo_variables(model, msgpack.read(checkpoint))
    elif checkpoint:
        load_state_dict_into(model, load_torch_state_dict(checkpoint))
    return model


def _load_mono(checkpoint: str | None, encoder: str = "vitl", device: str = "cuda",
               dtype: torch.dtype = torch.float32):
    """DAv2 with the checkpoint's weights, in `dtype` (the pipeline runs it
    in the stereo compute dtype); None without a checkpoint."""
    if not checkpoint:
        return None
    from stereoanywhere_tpu_torch.compat.torch_checkpoint import load_state_dict_into, load_torch_state_dict
    from stereoanywhere_tpu_torch.models.dpt import DepthAnythingV2

    model = DepthAnythingV2(MonoConfig.for_encoder(encoder), device=resolve_device(device), dtype=dtype)
    if checkpoint.endswith(".msgpack"):
        from stereoanywhere_tpu_torch.compat import msgpack
        from stereoanywhere_tpu_torch.compat.from_jax import load_dav2_variables

        return load_dav2_variables(model, msgpack.read(checkpoint))
    return load_state_dict_into(model, load_torch_state_dict(checkpoint))


def _pipeline(args, two_stage: bool = False, device=None, mesh=None):
    from stereoanywhere_tpu_torch.serve.pipeline import StereoAnywherePipeline

    device = args.device if device is None else device
    cfg = StereoAnywhereConfig(compute_dtype=args.dtype)
    stereo = _load_stereo(args.checkpoint, cfg, device)
    mono = _load_mono(args.mono_checkpoint, args.mono_encoder, device, torch_dtype(args.dtype))
    return StereoAnywherePipeline(stereo, mono, iters=args.iters, device=device, two_stage=two_stage, mesh=mesh)


def cmd_eval(args):
    from stereoanywhere_tpu_torch.data.datasets import fetch_dataset
    from stereoanywhere_tpu_torch.eval.harness import DAV2_SIZES, Evaluator, eval_preset
    from stereoanywhere_tpu_torch.eval.programs import EvalPrograms

    preset = eval_preset(args.dataset)
    iscale = preset["iscale"] if args.iscale is None else args.iscale
    oscale = preset["oscale"] if args.oscale is None else args.oscale
    cfg = StereoAnywhereConfig(compute_dtype=args.dtype)
    ckpt = args.checkpoint
    if ckpt is None:
        # a released checkpoint dropped in ($SA_CHECKPOINT, or sceneflow.tar
        # in the working directory) runs the published-weights eval
        cand = os.environ.get("SA_CHECKPOINT", "sceneflow.tar")
        if os.path.exists(cand):
            print(f"auto-detected checkpoint: {cand}")
            ckpt = cand
    stereo = _load_stereo(ckpt, cfg, args.device)
    mono = _load_mono(args.mono_checkpoint, args.mono_encoder, args.device, torch_dtype(args.dtype))
    programs = EvalPrograms(stereo, mono, iters=args.iters, dav2_size=DAV2_SIZES.get(args.dataset, (518, 518)),
                            device=args.device)

    # iscale/oscale run inside the evaluator (nearest image downscale, gt
    # downscale and /oscale, metrics at the reduced resolution), not through
    # the readers' scale_factor, which the published tables do not use
    ds = fetch_dataset(args.dataset, args.datapath, test=True, overfit=args.overfit, mono=args.mono_precomputed)
    print(f"evaluating {args.dataset}: {len(ds)} pairs")
    ev = Evaluator(programs.stereo_fn, programs.mono_fn if mono is not None else None, args.dataset,
                   iscale=iscale, oscale=oscale, save_images_dir=args.save_images)
    t0 = time.time()
    if args.tries > 1:
        # repeatability loop with mean/std reporting (reference test.py:287-392)
        from stereoanywhere_tpu_torch.eval.report import run_tries

        res = None

        def once():
            nonlocal res
            res = ev.run(ds, max_samples=args.max_samples)
            return res.mean()

        means, stds = run_tries(once, args.tries)
        dt = time.time() - t0
        print(json.dumps({k: round(v, 4) for k, v in means.items()}, indent=2))
        print(json.dumps({f"std:{k}": round(v, 4) for k, v in stds.items()}, indent=2))
    else:
        res = ev.run(ds, max_samples=args.max_samples)
        dt = time.time() - t0
        means = res.mean()
        print(json.dumps({k: round(v, 4) for k, v in means.items()}, indent=2))
    print(f"({len(res.per_sample)} samples in {dt:.1f}s)")
    if args.csv:
        res.to_csv(args.csv, {"dataset": args.dataset, "iters": args.iters, "tries": args.tries})
    _print_published_comparison(args.dataset, means, bool(ckpt))
    return means


# Published zero-shot tables for the released SceneFlow checkpoint (the
# JAX CLI's copy of the paper's Tables 2-4), printed beside an eval
PUBLISHED = {
    "middlebury": {"bad 2.0": 0.0696, "avgerr": 0.94},
    "middlebury2021": {"bad 2.0": 0.0797, "avgerr": 1.08},
    "eth3d": {"bad 1.0": 0.0166, "avgerr": 0.24},
    "kitti2012": {"bad 3.0": 0.0390, "avgerr": 0.83},
    "kitti2015": {"bad 3.0": 0.0393, "avgerr": 0.97},
    "booster": {"bad 2.0": 0.0901, "bad 4.0": 0.0540, "bad 6.0": 0.0412,
                "bad 8.0": 0.0334, "avgerr": 1.21},
    "layeredflow": {"bad 1.0": 0.8183, "bad 3.0": 0.5766, "bad 5.0": 0.4512,
                    "avgerr": 11.20},
    "monotrap": {"depth/absrel": 0.0350, "depth/rmse": 0.06},
}


def _print_published_comparison(dataset: str, means: dict, have_ckpt: bool):
    pub = PUBLISHED.get(dataset)
    if not pub:
        return
    tag = "" if have_ckpt else "  [random init — comparison meaningless]"
    print(f"published ({dataset}, SceneFlow ckpt, paper Tables 2-4):{tag}")
    for k, v in pub.items():
        got = means.get(k)
        got_s = f"{got:.4f}" if got is not None else "-"
        print(f"  {k:14s} paper {v:.4f}   ours {got_s}")


def cmd_train(args):
    """The JAX CLI's `cmd_train`: the readers with the augmentor, the
    prefetch loader, `Trainer` steps, logs every `--log-every` steps (the
    only host syncs), validation with best-checkpoint selection, `latest`
    every `--save-every` steps and `final` (or `stopped` after SIGTERM /
    SIGUSR1) at the end.  With `--data-parallel N` it spawns N ranks and
    returns None; otherwise it returns the trainer."""
    from stereoanywhere_tpu_torch.parallel import multihost as mh
    from stereoanywhere_tpu_torch.parallel.mesh import check_data_axis

    if args.data_parallel > 1:
        check_data_axis(args.data_parallel, args.device)
        torch.multiprocessing.start_processes(
            _data_parallel_rank, args=(args, f"tcp://127.0.0.1:{mh.free_port()}"), nprocs=args.data_parallel,
            start_method="spawn")
        return None
    if not args.multihost:
        return _train(args, resolve_device(args.device))
    device = mh.initialize_distributed(args.device)
    try:
        return _train(args, resolve_device(device))
    finally:
        mh.destroy_distributed()


def _data_parallel_rank(rank: int, args, init_method: str) -> None:
    """One rank of `train --data-parallel N`, in a spawned process; on the
    CPU with its share of the cores (N processes of all cores' threads
    each would wait on one another, as torchrun's OMP_NUM_THREADS=1
    avoids)."""
    from stereoanywhere_tpu_torch.parallel import multihost as mh

    if torch.device(args.device).type == "cpu":
        torch.set_num_threads(max(1, torch.get_num_threads() // args.data_parallel))

    device = mh.initialize_distributed(args.device, rank=rank, world_size=args.data_parallel,
                                       init_method=init_method)
    try:
        _train(args, resolve_device(device))
    finally:
        mh.destroy_distributed()


def _train(args, device: torch.device):
    """`cmd_train`'s loop as one rank (or the only process): each rank loads
    its slice of the global batch; rank 0 alone writes the provenance, the
    metric log and the checkpoints and validates while the others wait;
    the stop flag is agreed on every step."""
    from stereoanywhere_tpu_torch.config import TrainConfig
    from stereoanywhere_tpu_torch.data.augmentor import DisparityAugmentor
    from stereoanywhere_tpu_torch.data.datasets import fetch_dataset
    from stereoanywhere_tpu_torch.data.loader import PrefetchLoader
    from stereoanywhere_tpu_torch.parallel import multihost as mh
    from stereoanywhere_tpu_torch.train.trainer import Trainer

    rank, world = mh.rank_and_world()
    tc = TrainConfig(
        lr=args.lr, batch_size=args.batch_size, epochs=args.epochs,
        crop_h=args.crop_h, crop_w=args.crop_w, train_iters=args.iters,
        num_steps=args.num_steps, seed=args.seed, debug_grad=args.debug_grad,
        gt_mono_prob=args.gt_mono_prob,
        things_to_freeze=tuple(filter(None, args.freeze.split(","))),
    )
    mh.host_local_batch_size(tc.batch_size)
    aug = DisparityAugmentor(crop_size=(tc.crop_h, tc.crop_w), seed=tc.seed)
    ds = fetch_dataset(args.dataset, args.datapath, test=False, mono=args.mono_precomputed, augmentor=aug)
    steps_per_epoch = max(len(ds) // tc.batch_size, 1)
    total = tc.num_steps if tc.num_steps > 0 else steps_per_epoch * tc.epochs
    model_cfg = StereoAnywhereConfig(compute_dtype=args.dtype, volume_corruption_prob=args.corruption_prob)
    model = _load_stereo(args.checkpoint, model_cfg, device, torch.float32) if args.checkpoint else None
    trainer = Trainer(model_cfg, tc, total, device=device, checkpoint_dir=args.savedir, model=model)
    if args.resume:
        trainer.restore(args.resume)

    logger = None
    if args.savedir and rank == 0:
        from stereoanywhere_tpu_torch.utils.logging import MetricLogger, save_run_provenance

        save_run_provenance(args.savedir, {"model": trainer.model.cfg, "train": tc})
        logger = MetricLogger(args.savedir)
    val_ds = None
    if args.val_datapath and rank == 0:
        val_ds = fetch_dataset(args.val_dataset, args.val_datapath, test=True, mono=args.mono_precomputed)

    step = trainer.step_count
    say = print if rank == 0 else (lambda *a, **k: None)
    say(f"training: {len(ds)} pairs, {total} steps, starting at {step} ({device}"
        + (f", {world} ranks)" if world > 1 or mh.distributed() else ")"))
    t0 = time.time()
    with PrefetchLoader(ds, tc.batch_size, total, seed=tc.seed, start_step=step,
                        num_threads=args.loader_threads, shard_index=rank, shard_count=world) as loader:
        for step0, batch in loader:
            if mh.stop_consensus(trainer.stop_requested):
                break
            logs = trainer.step(batch)
            step = step0 + 1
            if step % args.log_every == 0:
                say(f"step {step}/{total} loss {float(logs['loss/total']):.4f} "
                    f"epe {float(logs['epe/final']):.3f} ({(time.time() - t0) / args.log_every:.2f}s/step)")
                t0 = time.time()
                if logger is not None:
                    logger.log(step, logs)
            if args.val_datapath and step % args.val_every == 0:
                if val_ds is not None:
                    vm = trainer.validate(val_ds, metric=args.val_metric, dataset_name=args.val_dataset,
                                          max_samples=args.val_samples)
                    say(f"val @ {step}: " + " ".join(f"{k}={v:.4f}" for k, v in sorted(vm.items())))
                    if logger is not None:
                        logger.log(step, {f"val/{k}": v for k, v in vm.items()})
                mh.barrier()
            if args.savedir and step % args.save_every == 0:
                trainer.save("latest")
    stopped = mh.stop_consensus(trainer.stop_requested)  # every rank picks the same tag
    if args.savedir:
        trainer.save("stopped" if stopped else "final")
    if logger is not None:
        logger.close()
    mh.barrier()
    return trainer


def cmd_precompute_mono(args):
    """Offline DAv2 (reference mono_sceneflow.py:85-106): each view's depth
    at DAv2's default size, normalised to [0,1], as a 16-bit PNG.  Without
    `--outdir` the files go where the dataset's reader opens them with
    `--mono-precomputed <tag>` (the tag is printed); with it, as the JAX
    CLI writes them: `<outdir>/<index>_<view>_<tag>.png`."""
    import numpy as np

    from stereoanywhere_tpu_torch.data.datasets import fetch_dataset
    from stereoanywhere_tpu_torch.data.frame_utils import write_mono16
    from stereoanywhere_tpu_torch.models.dpt import infer_mono_depth

    mono = _load_mono(args.mono_checkpoint, args.mono_encoder, args.device, torch_dtype(args.dtype))
    if mono is None:
        raise SystemExit("precompute-mono: --mono-checkpoint required")
    ds = fetch_dataset(args.dataset, args.datapath, test=True)
    tag = f"DAv2_{args.mono_encoder}" if args.mono_encoder != "vitl" else "DAv2"
    dev = next(mono.parameters()).device
    for i in range(len(ds)):
        s = ds[i]
        targets = ds.mono_paths(i, tag) if args.outdir is None else [
            os.path.join(args.outdir, f"{i:06d}_{key}_{tag}.png") for key in ("im2", "im3")]
        for img, out in zip((s["im2"], s["im3"]), targets):
            with torch.inference_mode():
                d = infer_mono_depth(mono, torch.from_numpy(img[None]).to(dev)).cpu().numpy()[0, ..., 0]
            d = (d - d.min()) / max(d.max() - d.min(), 1e-6)
            os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
            write_mono16(out, d)
        if i % 50 == 0:
            print(f"{i}/{len(ds)}")
    print(f"wrote the mono depth of {len(ds)} pairs: eval reads it with --mono-precomputed {tag}"
          if args.outdir is None else f"wrote the mono depth of {len(ds)} pairs to {args.outdir}")


def cmd_convert(args):
    """A reference PyTorch checkpoint (`.tar` / `.pth`, DataParallel's
    `module.` prefixes stripped) -> the flax `.msgpack` file the JAX CLI's
    `convert` writes, byte for byte: the JAX package's variable tree (f32
    leaves in the flax layouts) in flax's msgpack layout."""
    from stereoanywhere_tpu_torch.compat import msgpack
    from stereoanywhere_tpu_torch.compat.from_jax import dav2_tree, stereo_tree
    from stereoanywhere_tpu_torch.compat.torch_checkpoint import load_torch_state_dict

    state = load_torch_state_dict(args.input)
    tree = stereo_tree(state) if args.kind == "stereo" else dav2_tree(state)
    size = msgpack.write(args.output, tree)

    def leaves(node):
        for v in node.values():
            yield from leaves(v) if isinstance(v, dict) else (v,)

    n = sum(leaf.size for leaf in leaves(tree))
    print(f"wrote {args.output}: {n / 1e6:.1f}M params ({size / 1e6:.1f} MB)")


def cmd_infer(args):
    """File-pair inference: left/right images -> disparity .npy + colormapped
    PNG.  With `--shard-rows N` it spawns N ranks and returns None."""
    if args.shard_rows > 1:
        from stereoanywhere_tpu_torch.parallel import multihost as mh
        from stereoanywhere_tpu_torch.parallel.mesh import check_mesh

        check_mesh(1, args.shard_rows, args.device)
        torch.multiprocessing.start_processes(
            _shard_rows_rank, args=(args, f"tcp://127.0.0.1:{mh.free_port()}"), nprocs=args.shard_rows,
            start_method="spawn")
        return None
    return _infer(args)


def _shard_rows_rank(rank: int, args, init_method: str) -> None:
    """One rank of `infer --shard-rows N`, in a spawned process (on the CPU
    with its share of the cores)."""
    from stereoanywhere_tpu_torch.parallel import multihost as mh
    from stereoanywhere_tpu_torch.parallel.mesh import make_mesh

    if torch.device(args.device).type == "cpu":
        torch.set_num_threads(max(1, torch.get_num_threads() // args.shard_rows))
    device = mh.initialize_distributed(args.device, rank=rank, world_size=args.shard_rows, init_method=init_method)
    try:
        _infer(args, device, make_mesh(1, args.shard_rows))
    finally:
        mh.destroy_distributed()


def _infer(args, device=None, mesh=None):
    """`cmd_infer` as one process, or as one rank of a row-sharded run
    (rank 0 writes the outputs)."""
    import numpy as np
    from PIL import Image

    from stereoanywhere_tpu_torch.utils.visualization import colorize_disparity

    pipe = _pipeline(args, two_stage=args.two_stage, device=device, mesh=mesh)

    def load(path):
        im = np.asarray(Image.open(path).convert("RGB"), np.float32) / 255.0
        if args.iscale != 1.0:
            h, w = im.shape[:2]
            im = np.asarray(
                Image.fromarray((im * 255).astype(np.uint8)).resize(
                    (int(w / args.iscale), int(h / args.iscale)), Image.BILINEAR
                ),
                np.float32,
            ) / 255.0
        return im[None]

    disp = pipe(load(args.left), load(args.right))
    if disp is None:  # a row-sharded run's other ranks
        return
    disp = disp.cpu().numpy()[0, ..., 0] * args.iscale

    os.makedirs(args.output, exist_ok=True)
    stem = os.path.splitext(os.path.basename(args.left))[0]
    np.save(os.path.join(args.output, f"{stem}_disp.npy"), disp)
    Image.fromarray(colorize_disparity(disp)).save(os.path.join(args.output, f"{stem}_disp.png"))
    print(f"disparity range [{disp.min():.2f}, {disp.max():.2f}] -> {args.output}")


def cmd_serve(args):
    from stereoanywhere_tpu_torch.serve.pipeline import serve_http

    pipe = _pipeline(args)
    print(f"serving on :{args.port} ({'CUDA graphs' if pipe.graphs else 'eager'}, {pipe.device})")
    serve_http(pipe, port=args.port)


def cmd_camera(args):
    """The live capture loop (reference demo/fast_demo_oak.py): frames from
    an OAK-D (needs depthai) or replayed from two globs, inferred locally
    (the pipeline, on its CUDA graphs on the card) or by a remote `serve`
    endpoint, EMA-smoothed and written as colormapped PNGs.  Returns the
    `CaptureLoop` (its `stats`: frames, fps)."""
    import functools
    import glob

    from PIL import Image

    from stereoanywhere_tpu_torch.serve.camera import CaptureLoop, DirectorySource, OakDSource, disparity_frame

    if args.source == "oak":
        source = OakDSource(resolution=args.resolution)
    else:
        source = DirectorySource(sorted(glob.glob(args.left_glob)), sorted(glob.glob(args.right_glob)),
                                 loop=args.loop)

    if args.server:
        from stereoanywhere_tpu_torch.serve.client import infer_remote

        infer = functools.partial(infer_remote, args.server)
    else:
        pipe = _pipeline(args)

        def infer(left, right):
            return pipe(left[None], right[None]).cpu().numpy()[0, ..., 0]

    os.makedirs(args.output, exist_ok=True)

    def on_frame(res):
        Image.fromarray(disparity_frame(res["smoothed"])).save(
            os.path.join(args.output, f"frame_{res['index']:05d}.png"))
        if res["sgm"] is not None:  # the OAK's on-board SGM stream, for comparison
            Image.fromarray(disparity_frame(res["sgm"])).save(
                os.path.join(args.output, f"frame_{res['index']:05d}_sgm.png"))
        print(f"frame {res['index']}  {res['fps']:.1f} fps")

    loop = CaptureLoop(infer, ema_alpha=args.ema_alpha,
                       clip=(args.clip_top, args.clip_bottom, args.clip_left, args.clip_right), on_frame=on_frame)
    n = loop.run(source, max_frames=args.max_frames)
    print(f"{n} frames -> {args.output}")
    return loop


def main(argv=None):
    p = argparse.ArgumentParser(prog="stereoanywhere_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp):
        sp.add_argument("--checkpoint", default=None)
        sp.add_argument("--mono-checkpoint", default=None)
        sp.add_argument("--mono-encoder", default="vitl")
        sp.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"],
                        help="compute dtype; float32 on the card runs cuDNN's convolutions in TF32")
        sp.add_argument("--iters", type=int, default=32)
        sp.add_argument("--device", default="cuda", help="cuda (CUDA graphs) or cpu (eager)")

    pe = sub.add_parser("eval", help="zero-shot benchmark evaluation (the reference's test.py protocol)")
    common(pe)
    pe.add_argument("--dataset", required=True)
    pe.add_argument("--datapath", required=True)
    pe.add_argument("--iscale", type=float, default=None,
                    help="input downscale; default = the dataset's shipped "
                    "bundle (booster 4, layeredflow 8, others 1)")
    pe.add_argument("--oscale", type=float, default=None,
                    help="output/eval scale; default = the dataset's shipped bundle")
    pe.add_argument("--overfit", action="store_true")
    pe.add_argument("--max-samples", type=int, default=None)
    pe.add_argument("--mono-precomputed", default=None,
                    help="tag of the precomputed mono files to read (precompute-mono prints it)")
    pe.add_argument("--tries", type=int, default=1,
                    help="repeat the whole eval N times, report mean/std")
    pe.add_argument("--save-images", default=None,
                    help="dump qualitative PNG grids per sample to this dir")
    pe.add_argument("--csv", default=None)
    pe.set_defaults(fn=cmd_eval)

    pt = sub.add_parser("train", help="train on a dataset (the reference's train.py)")
    common(pt)
    pt.add_argument("--dataset", default="sceneflow")
    pt.add_argument("--datapath", required=True)
    pt.add_argument("--lr", type=float, default=1e-4)
    pt.add_argument("--batch-size", type=int, default=2)
    pt.add_argument("--epochs", type=int, default=3)
    pt.add_argument("--crop-h", type=int, default=320)
    pt.add_argument("--crop-w", type=int, default=640)
    pt.add_argument("--data-parallel", type=int, default=1,
                    help="spawn N ranks, one a card (gloo processes with --device cpu)")
    pt.add_argument("--num-steps", type=int, default=0,
                    help="override total steps (0 = epochs * dataset/batch)")
    pt.add_argument("--seed", type=int, default=1337)
    pt.add_argument("--debug-grad", action="store_true",
                    help="per-parameter NaN/Inf gradient census to json")
    pt.add_argument("--gt-mono-prob", type=float, default=0.3)
    pt.add_argument("--corruption-prob", type=float, default=0.3,
                    help="volume-corruption augmentation probability")
    pt.add_argument("--freeze", default="fnet",
                    help="comma list of groups to freeze: fnet,cnet,monoagg")
    pt.add_argument("--val-dataset", default="middlebury")
    pt.add_argument("--val-datapath", default=None,
                    help="enable periodic validation + best-checkpoint "
                         "(val samples need precomputed mono via --mono-precomputed)")
    pt.add_argument("--val-every", type=int, default=1000)
    pt.add_argument("--val-metric", default="bad 2.0")
    pt.add_argument("--val-samples", type=int, default=None)
    pt.add_argument("--multihost", action="store_true",
                    help="one rank of a torchrun launch (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT)")
    pt.add_argument("--savedir", default=None)
    pt.add_argument("--resume", default=None, help="a checkpoint tag saved in --savedir: latest, best, ...")
    pt.add_argument("--log-every", type=int, default=20)
    pt.add_argument("--save-every", type=int, default=500)
    pt.add_argument("--mono-precomputed", default=None)
    pt.add_argument("--loader-threads", type=int, default=4,
                    help="prefetch worker threads (0 = synchronous loading)")
    pt.set_defaults(fn=cmd_train, iters=12)

    pm = sub.add_parser("precompute-mono", help="DAv2 depth of every view as 16-bit PNGs")
    common(pm)
    pm.add_argument("--dataset", required=True)
    pm.add_argument("--datapath", required=True)
    pm.add_argument("--outdir", default=None,
                    help="write <index>_<view>_<tag>.png here (the JAX CLI's names); "
                         "default: beside the images, where --mono-precomputed reads them")
    pm.set_defaults(fn=cmd_precompute_mono)

    pc = sub.add_parser("convert", help="reference .tar/.pth checkpoint -> flax .msgpack")
    pc.add_argument("--input", required=True, help="torch .tar/.pth checkpoint")
    pc.add_argument("--output", required=True, help="output .msgpack path")
    pc.add_argument("--kind", choices=["stereo", "dav2"], default="stereo")
    pc.set_defaults(fn=cmd_convert)

    pi = sub.add_parser("infer", help="file-pair inference -> .npy + colormap PNG")
    common(pi)
    pi.add_argument("left")
    pi.add_argument("right")
    pi.add_argument("-o", "--output", default=".")
    pi.add_argument("--iscale", type=float, default=1.0)
    pi.add_argument("--shard-rows", type=int, default=1,
                    help="shard the stereo branch's image rows over N ranks, one a card (gloo processes with "
                         "--device cpu)")
    pi.add_argument("--two-stage", action="store_true",
                    help="mono/stereo as separate programs (lower peak device memory)")
    pi.set_defaults(fn=cmd_infer)

    ps = sub.add_parser("serve", help="HTTP inference server (POST /infer; serve/client.py is its client)")
    common(ps)
    ps.add_argument("--port", type=int, default=8008)
    ps.set_defaults(fn=cmd_serve)

    pcam = sub.add_parser("camera", help="live capture loop (OAK-D or replay)")
    common(pcam)
    pcam.add_argument("--source", default="dir", choices=["dir", "oak"])
    pcam.add_argument("--left-glob", default="left/*.png")
    pcam.add_argument("--right-glob", default="right/*.png")
    pcam.add_argument("--loop", action="store_true", help="replay forever")
    pcam.add_argument("--resolution", default="400", choices=["400", "720", "800"])
    pcam.add_argument("--server", default=None, help="remote serve endpoint")
    pcam.add_argument("-o", "--output", default="camera_out")
    pcam.add_argument("--ema-alpha", type=float, default=0.15)
    pcam.add_argument("--max-frames", type=int, default=None)
    for side in ("top", "bottom", "left", "right"):
        pcam.add_argument(f"--clip-{side}", type=int, default=0)
    pcam.set_defaults(fn=cmd_camera)

    args = p.parse_args(argv)
    if getattr(args, "shard_rows", 1) < 1:
        p.error("--shard-rows: at least 1 rank")
    if getattr(args, "data_parallel", 1) > 1 and args.multihost:
        p.error("--data-parallel spawns its own ranks and --multihost joins a launch's: give one")
    return args.fn(args)


if __name__ == "__main__":
    main()
