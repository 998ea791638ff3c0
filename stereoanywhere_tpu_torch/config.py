"""Model configuration for the PyTorch port.

A copy of the JAX package's `StereoAnywhereConfig` and `MonoConfig`, keeping
the fields that change the inference math, and the two switches that
select the kernels of the refinement loop:
- `lookup_impl` (the correlation lookup: every value computes one
  function, which the K5 kernel runs on the card and its plain version,
  the gather, on the CPU);
- `fused_level0` (the rotated refinement loop whose quarter-resolution
  plane runs in the K7, K5, K8 and K9 kernels).
Their values and defaults are the JAX package's; its CPU-test mode
`fused_level0="interpret"` has no counterpart and is refused.  The training
fields (`freeze_bn`, `vol_aug_n_masks`, `volume_corruption_prob`) and
`TrainConfig` are the JAX package's too, and so are the aggregation
variants that no shipped model uses: `use_aggregate_stereo_vol` (the
stereo volume through its own hourglass and classifier, whose output
replaces the raw volume in the refinement loop) and
`n_additional_hourglass` (stacked hourglasses after each volume's first,
with the reference's identity-first quirk: n - 1 of them run).  Left out:
the other TPU layout switches (`hourglass_folded`, `hourglass_blocked`,
`scan_unroll`): each selects between formulations of the same function
there, and the port has one.
`vol_downsample` (the reference's `--vol_downsample`: the mono volume and
its hourglass at 1/2^v of the quarter-resolution volume on each axis) is
kept: it is how the JAX package fits high-resolution inputs on one device.
"""
from __future__ import annotations

from dataclasses import dataclass

LOOKUP_IMPLS = ("auto", "inline", "lagged", "window", "mxu", "barrel")
FUSED_LEVEL0 = ("off", "on", "auto")


@dataclass(frozen=True)
class StereoAnywhereConfig:
    """Stereo model hyperparameters (defaults: the shipped reference model)."""

    # Iterative refinement
    corr_radius: int = 4
    corr_levels: int = 4
    n_gru_layers: int = 3
    n_downsample: int = 2
    context_dims: tuple[int, ...] = (128, 128, 128)
    fnet_dim: int = 256

    # Volume aggregation
    n_additional_hourglass: int = 0
    volume_channels: int = 8
    vol_n_masks: int = 8
    vol_downsample: int = 0
    use_aggregate_stereo_vol: bool = False
    use_aggregate_mono_vol: bool = True

    # Mirror handling
    use_truncate_vol: bool = True
    mirror_conf_th: float = 0.98
    mirror_attenuation: float = 0.9

    # Misc
    lrc_th: float = 1.0
    normal_gain: float = 10.0
    init_disparity_zero: bool = False

    # Training: BatchNorm on its running statistics (the reference calls
    # freeze_bn() every step; False: on the batch's), the number of masks
    # the volume corruption picks one from, and the corruption's
    # per-branch probability
    freeze_bn: bool = True
    vol_aug_n_masks: int = 4
    volume_corruption_prob: float = 0.33

    # Numerics: "float32" | "bfloat16"
    compute_dtype: str = "float32"
    # Test-mode width alignment: replicate-pad W to a multiple of
    # `width_pad_align` when W >= width_pad_min and crop the disparity back.
    # It changes the output near the right edge, so the port keeps it.
    width_pad_align: int = 64
    width_pad_min: int = 640
    # GRU-loop correlation lookup: "auto" resolves to the windowed XLA
    # formulation in the JAX package; "inline", "lagged", "window" are XLA
    # formulations of the same function there, "mxu" and "barrel" Pallas
    # kernels.  Here every value runs the K5 kernel on the card and the
    # plain gather on the CPU (ops/corr_lookup.py).
    lookup_impl: str = "auto"
    # Rotated, fused refinement loop (models/stereoanywhere.py): "on" runs
    # its quarter-resolution plane in the K7/K5/K8/K9 kernels; "auto"
    # resolves to "off", as in the JAX package.
    fused_level0: str = "off"

    def __post_init__(self):
        if self.vol_downsample < 0:
            raise ValueError(f"vol_downsample {self.vol_downsample}: the volume is resized by 2^-v, v >= 0")
        if self.n_additional_hourglass < 0:
            raise ValueError(f"n_additional_hourglass {self.n_additional_hourglass}: a count, >= 0")
        if self.lookup_impl not in LOOKUP_IMPLS:
            raise ValueError(f"lookup_impl {self.lookup_impl!r}: use one of {LOOKUP_IMPLS}")
        if self.fused_level0 == "interpret":
            raise ValueError(
                "fused_level0='interpret' is the JAX package's Pallas interpret mode for CPU tests; the port "
                "has no interpret mode: use 'on' (its kernels on the card, their plain versions on the CPU)"
            )
        if self.fused_level0 not in FUSED_LEVEL0:
            raise ValueError(f"fused_level0 {self.fused_level0!r}: use one of {FUSED_LEVEL0}")

    @property
    def resolved_lookup_impl(self) -> str:
        return "window" if self.lookup_impl == "auto" else self.lookup_impl

    @property
    def downsample_factor(self) -> int:
        return 2 ** self.n_downsample

    @property
    def corr_channels(self) -> int:
        """Per-volume channels fed to the motion encoder: (2r+1) * levels."""
        return self.corr_levels * (2 * self.corr_radius + 1)


@dataclass(frozen=True)
class MonoConfig:
    """Depth-Anything-V2 branch config."""

    encoder: str = "vitl"  # vits | vitb | vitl | vitg
    features: int = 256
    out_channels: tuple[int, ...] = (256, 512, 1024, 1024)
    input_size: int = 518

    @staticmethod
    def for_encoder(encoder: str) -> "MonoConfig":
        cfgs = {
            "vits": dict(features=64, out_channels=(48, 96, 192, 384)),
            "vitb": dict(features=128, out_channels=(96, 192, 384, 768)),
            "vitl": dict(features=256, out_channels=(256, 512, 1024, 1024)),
            "vitg": dict(features=384, out_channels=(1536, 1536, 1536, 1536)),
        }
        if encoder not in cfgs:
            raise ValueError(f"unsupported encoder {encoder!r}; the port has {sorted(cfgs)}")
        return MonoConfig(encoder=encoder, **cfgs[encoder])


@dataclass(frozen=True)
class TrainConfig:
    """Training hyperparameters (reference run_train.sh + train.py:209-213),
    a copy of the JAX package's."""

    lr: float = 1e-4
    weight_decay: float = 1e-5
    adam_eps: float = 1e-8
    epochs: int = 3
    batch_size: int = 2
    crop_h: int = 320
    crop_w: int = 640
    train_iters: int = 12
    valid_iters: int = 32
    gamma: float = 0.9  # per-iteration loss decay, exponent-adjusted (train.py:295)
    grad_clip: float = 1.0
    pct_start: float = 0.001
    gt_mono_prob: float = 0.3
    use_border_mask: bool = True
    use_normal_loss_on_coarse: bool = True
    use_normal_loss: bool = False  # per-iteration normal loss (train.py:302-306)
    normal_loss_gain: float = 10.0
    lrc_th: float = 1.0  # confidence-BCE threshold (reference --lrc_th)
    max_disp: float = 700.0  # gt validity cap (reference run_train.sh MAXDISP=700)
    things_to_freeze: tuple[str, ...] = ("fnet",)
    num_steps: int = 0  # 0 = derive from dataset length * epochs
    seed: int = 1337
    debug_grad: bool = False  # per-parameter NaN/Inf gradient census (reference --debug_grad)
