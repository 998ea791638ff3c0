"""Model configuration for the PyTorch port.

A copy of the JAX package's `StereoAnywhereConfig` and `MonoConfig`, keeping
the fields that change the inference math, and the two switches that
select the kernels of the refinement loop:
- `lookup_impl` (the correlation lookup: "auto" and the XLA formulations
  run the plain gather, "mxu" and "barrel" the K5 kernel);
- `fused_level0` (the rotated refinement loop whose quarter-resolution
  plane runs in the K7, K5, K8 and K9 kernels).
Their values and defaults are the JAX package's; its CPU-test mode
`fused_level0="interpret"` has no counterpart and is refused.  Left out:
- the other TPU layout switches (`hourglass_folded`, `hourglass_blocked`,
  `scan_unroll`): each selects between formulations of the same function
  there, and the port has one;
- the training-only fields (`freeze_bn`, `vol_aug_n_masks`,
  `volume_corruption_prob`): the port has no training yet;
- the non-default aggregation variants (`use_aggregate_stereo_vol`,
  `n_additional_hourglass`, `vol_downsample`), which no shipped model uses.
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
    volume_channels: int = 8
    vol_n_masks: int = 8
    use_aggregate_mono_vol: bool = True

    # Mirror handling
    use_truncate_vol: bool = True
    mirror_conf_th: float = 0.98
    mirror_attenuation: float = 0.9

    # Misc
    lrc_th: float = 1.0
    normal_gain: float = 10.0
    init_disparity_zero: bool = False

    # Numerics: "float32" | "bfloat16"
    compute_dtype: str = "float32"
    # Test-mode width alignment: replicate-pad W to a multiple of
    # `width_pad_align` when W >= width_pad_min and crop the disparity back.
    # It changes the output near the right edge, so the port keeps it.
    width_pad_align: int = 64
    width_pad_min: int = 640
    # GRU-loop correlation lookup: "auto" resolves to the windowed XLA
    # formulation in the JAX package, the plain gather here; "inline",
    # "lagged", "window" are XLA formulations of the same function (the
    # gather here); "mxu" and "barrel" are Pallas kernels there and the K5
    # kernel here (ops/corr_lookup.py).
    lookup_impl: str = "auto"
    # Rotated, fused refinement loop (models/stereoanywhere.py): "on" runs
    # its quarter-resolution plane in the K7/K5/K8/K9 kernels; "auto"
    # resolves to "off", as in the JAX package.
    fused_level0: str = "off"

    def __post_init__(self):
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

    encoder: str = "vitl"  # vits | vitb | vitl
    features: int = 256
    out_channels: tuple[int, ...] = (256, 512, 1024, 1024)
    input_size: int = 518

    @staticmethod
    def for_encoder(encoder: str) -> "MonoConfig":
        cfgs = {
            "vits": dict(features=64, out_channels=(48, 96, 192, 384)),
            "vitb": dict(features=128, out_channels=(96, 192, 384, 768)),
            "vitl": dict(features=256, out_channels=(256, 512, 1024, 1024)),
        }
        if encoder not in cfgs:
            raise ValueError(f"unsupported encoder {encoder!r}; the port has {sorted(cfgs)}")
        return MonoConfig(encoder=encoder, **cfgs[encoder])
