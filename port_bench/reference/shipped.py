"""The shipped model's reference: `pipeline.ReferencePipeline` over
`stereo.StereoAnywhere` and `dav2.DepthAnythingV2`, at the configuration's
widths.  The reference of every configuration that names none."""
from __future__ import annotations

import torch

from port_bench.reference.dav2 import VIT_CONFIGS, DepthAnythingV2
from port_bench.reference.pipeline import ReferencePipeline
from port_bench.reference.stereo import StereoAnywhere, StereoConfig

STEREO_KEYS = frozenset(StereoConfig.__dataclass_fields__)


def build(cfg: dict) -> ReferencePipeline:
    """The f32 pipeline on the meta device."""
    mono = cfg["mono"]
    vit = VIT_CONFIGS[mono["encoder"]]
    widths = (vit["embed_dim"], vit["depth"], vit["num_heads"], vit["features"], tuple(vit["out_channels"]))
    if widths != (mono["embed_dim"], mono["depth"], mono["num_heads"], mono["features"], tuple(mono["out_channels"])):
        raise ValueError(f"config {cfg['name']}: the reference's {mono['encoder']} differs from the file")
    stereo_cfg = StereoConfig(**{k: tuple(v) if isinstance(v, list) else v
                                 for k, v in cfg["stereo"].items() if k in STEREO_KEYS})
    with torch.device("meta"):
        return ReferencePipeline(StereoAnywhere(stereo_cfg), DepthAnythingV2(mono["encoder"]), cfg["iters"],
                                 (mono["input_size"],) * 2)
