"""Command-line entry points of the port: `infer` and `serve`.

The counterparts of the JAX package's `cli.py` `infer` and `serve`, with
its flags and a `--device` (default the card; "cpu" runs eagerly there):

  python -m stereoanywhere_tpu_torch.cli infer left.png right.png -o out \\
      --checkpoint sceneflow.tar --mono-checkpoint depth_anything_v2_vitl.pth
  python -m stereoanywhere_tpu_torch.cli serve --checkpoint ... --port 8008

Checkpoints are the reference's PyTorch files (`.pth` / `.tar`), read
straight into the port's modules under the reference parameter names.
Without `--checkpoint` the stereo model gets seeded random weights; without
`--mono-checkpoint` the pipeline runs stereo-only on zero depth, as the JAX
CLI does.  On the card both commands serve each input shape from its CUDA
graph.  Not ported yet, and refused: flax `.msgpack` checkpoints and
`--shard-rows` (row sharding over several cards).
"""
from __future__ import annotations

import argparse
import os

import torch

from stereoanywhere_tpu_torch.config import MonoConfig, StereoAnywhereConfig
from stereoanywhere_tpu_torch.device import resolve_device, torch_dtype


def _load_stereo(checkpoint: str | None, cfg: StereoAnywhereConfig, device: str = "cuda"):
    """The stereo model on `device`: the checkpoint's weights, or seeded
    random ones (seed 0) without one."""
    from stereoanywhere_tpu_torch.compat.torch_checkpoint import load_state_dict_into, load_torch_state_dict
    from stereoanywhere_tpu_torch.models.stereoanywhere import StereoAnywhere

    model = StereoAnywhere(cfg, device=resolve_device(device), generator=torch.Generator().manual_seed(0))
    if checkpoint:
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
    return load_state_dict_into(model, load_torch_state_dict(checkpoint))


def _pipeline(args, two_stage: bool = False):
    from stereoanywhere_tpu_torch.serve.pipeline import StereoAnywherePipeline

    cfg = StereoAnywhereConfig(compute_dtype=args.dtype)
    stereo = _load_stereo(args.checkpoint, cfg, args.device)
    mono = _load_mono(args.mono_checkpoint, args.mono_encoder, args.device, torch_dtype(args.dtype))
    return StereoAnywherePipeline(stereo, mono, iters=args.iters, device=args.device, two_stage=two_stage)


def cmd_infer(args):
    """File-pair inference: left/right images -> disparity .npy + colormapped
    PNG."""
    import numpy as np
    from PIL import Image

    from stereoanywhere_tpu_torch.utils.visualization import colorize_disparity

    pipe = _pipeline(args, two_stage=args.two_stage)

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

    disp = pipe(load(args.left), load(args.right)).cpu().numpy()[0, ..., 0] * args.iscale

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


def main(argv=None):
    p = argparse.ArgumentParser(prog="stereoanywhere_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp):
        sp.add_argument("--checkpoint", default=None)
        sp.add_argument("--mono-checkpoint", default=None)
        sp.add_argument("--mono-encoder", default="vitl")
        sp.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
        sp.add_argument("--iters", type=int, default=32)
        sp.add_argument("--device", default="cuda", help="cuda (CUDA graphs) or cpu (eager)")

    pi = sub.add_parser("infer", help="file-pair inference -> .npy + colormap PNG")
    common(pi)
    pi.add_argument("left")
    pi.add_argument("right")
    pi.add_argument("-o", "--output", default=".")
    pi.add_argument("--iscale", type=float, default=1.0)
    pi.add_argument("--shard-rows", type=int, default=1, help="not ported yet: only 1")
    pi.add_argument("--two-stage", action="store_true",
                    help="mono/stereo as separate programs (lower peak device memory)")
    pi.set_defaults(fn=cmd_infer)

    ps = sub.add_parser("serve")
    common(ps)
    ps.add_argument("--port", type=int, default=8008)
    ps.set_defaults(fn=cmd_serve)

    args = p.parse_args(argv)
    for checkpoint in (args.checkpoint, args.mono_checkpoint):
        if checkpoint and checkpoint.endswith(".msgpack"):
            p.error(f"{checkpoint}: flax .msgpack checkpoints are not read by the port yet; "
                    "give the reference's PyTorch .pth / .tar file")
    if getattr(args, "shard_rows", 1) != 1:
        p.error("--shard-rows: row sharding over several cards (parallel/spatial.py) is not ported yet")
    return args.fn(args)


if __name__ == "__main__":
    main()
