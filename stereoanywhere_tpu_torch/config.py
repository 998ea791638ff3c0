"""Model configuration for the PyTorch port.

A copy of the JAX package's `StereoAnywhereConfig` and `MonoConfig`, keeping
the fields that change the inference math.  Left out:
- the TPU layout switches (`hourglass_folded`, `hourglass_blocked`,
  `lookup_impl`, `fused_level0`, `scan_unroll`): each selects between
  formulations of the same function there, and the port has one;
- the training-only fields (`freeze_bn`, `vol_aug_n_masks`,
  `volume_corruption_prob`): the port has no training yet;
- the non-default aggregation variants (`use_aggregate_stereo_vol`,
  `n_additional_hourglass`, `vol_downsample`), which no shipped model uses.
"""
from __future__ import annotations

from dataclasses import dataclass


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
