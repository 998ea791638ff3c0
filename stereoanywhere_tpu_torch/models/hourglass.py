"""3-D hourglass over the masked cost volume with dual feature attention.

Volumes are NCDHW (B, C, W3, H, W2): the reference permutes its volume to
the spatial order (W3, H, W2) before the 3-D convs.  Feature maps (the mono
depth pyramids) are NCHW (B, 1, H', W').  The JAX package runs the same
network on lane-folded and blocked layouts; the port runs plain cuDNN
conv3d and is held against that default.

Dtypes as in the JAX package: every conv runs in its input's dtype.  The
depth pyramids stay f32 in a bf16 model, so the attention branches and
their sigmoid gates are f32, and `gate * cv` promotes the volume to f32 at
the first gate: in a bf16 model only `down_layers[0]` runs in bf16, the
rest of the hourglass (and the classifiers after it) in f32.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from stereoanywhere_tpu_torch.models.layers import BasicConv, conv_in_dtype
from stereoanywhere_tpu_torch.ops.cuda import hourglass3d
from stereoanywhere_tpu_torch.ops.interp import resize_trilinear_align_corners


class _AttBranch(nn.Sequential):
    """BasicConv(1 -> mid) then a 1x1 conv to the volume's channels
    (reference names feat_att_left.0 / feat_att_left.1), in the feature
    map's dtype."""

    def __init__(self, feat_ch: int, cv_ch: int, kernel_size: int, stride: int, padding: int):
        mid = max(32, feat_ch // 2)
        super().__init__(
            BasicConv(feat_ch, mid, kernel_size=kernel_size, stride=stride, padding=padding),
            nn.Conv2d(mid, cv_ch, 1),
        )

    def forward(self, x):
        return conv_in_dtype(self[1], self[0](x))


class DoubleFeatureAtt(nn.Module):
    """Gate the volume by sigmoid(left attention) x sigmoid(right attention):
    the left gate broadcasts over W3, the right over W2.  The product takes
    the wider of the two dtypes (an f32 gate promotes a bf16 volume)."""

    def __init__(self, cv_ch: int, feat_ch: int = 1, kernel_size: int = 3, stride: int = 1, padding: int = 1):
        super().__init__()
        self.feat_att_left = _AttBranch(feat_ch, cv_ch, kernel_size, stride, padding)
        self.feat_att_right = _AttBranch(feat_ch, cv_ch, kernel_size, stride, padding)

    def forward(self, cv, feat_left, feat_right):
        gl = torch.sigmoid(self.feat_att_left(feat_left))  # (B,C,H,W2)
        gr = torch.sigmoid(self.feat_att_right(feat_right))  # (B,C,H,W3)
        gate = gl.unsqueeze(2) * gr.permute(0, 1, 3, 2).unsqueeze(-1)  # (B,C,W3,H,W2)
        if gate.shape[2:] != cv.shape[2:]:
            gate = resize_trilinear_align_corners(gate, tuple(cv.shape[2:]))
        return gate * cv


class Hourglass(nn.Module):
    """3-level 3-D encoder-decoder (8 -> 16 -> 32 -> 48 channels and back).
    On the card, `ops/cuda/hourglass3d.py`'s fused kernels run it over
    NDHWC volumes, except under autograd and in a row group
    (`hourglass3d.serve`); there and on the CPU its modules run it, NCDHW,
    its attention convolutions' weights contiguous (`channels_last =
    False`, read by `layers.channels_last_weights`).  Either way the output
    is NCDHW; `hourglass3d.calls()` counts the calls by path."""

    channels_last = False

    def __init__(self, in_ch: int = 8, out_ch: int = 8, feature_channels: Sequence[int] = (1, 1, 1, 1)):
        super().__init__()
        ns = len(feature_channels)
        self.ns = ns
        fc = feature_channels
        self.down_layers = nn.ModuleList()
        self.feature_atts = nn.ModuleList()
        cin = in_ch
        for i in range(ns - 1):
            cout = in_ch * 2 * (i + 1)
            self.down_layers.append(nn.Sequential(
                BasicConv(cin, cout, is_3d=True, stride=2),
                BasicConv(cout, cout, is_3d=True),
            ))
            self.feature_atts.append(DoubleFeatureAtt(cout, fc[i + 1]))
            cin = cout
        down_ch = [in_ch * 2 * (i + 1) for i in range(ns - 1)]
        self.agg_layers = nn.ModuleList()
        self.feature_atts_up = nn.ModuleList()
        for i in range(ns - 2):
            cout = in_ch * 2 * (ns - i - 2)
            cin = down_ch[ns - 2 - i] + down_ch[ns - 3 - i]
            self.agg_layers.append(nn.Sequential(
                BasicConv(cin, cout, is_3d=True, kernel_size=1, padding=0),
                BasicConv(cout, cout, is_3d=True),
                BasicConv(cout, cout, is_3d=True),
            ))
            self.feature_atts_up.append(DoubleFeatureAtt(cout, fc[ns - 2 - i]))
        last = in_ch * 2
        self.final_agg = nn.Sequential(
            BasicConv(in_ch + last, in_ch, is_3d=True, kernel_size=1, padding=0),
            BasicConv(in_ch, in_ch, is_3d=True),
            BasicConv(in_ch, out_ch, is_3d=True),
        )
        self.final_feature_atts_up = DoubleFeatureAtt(out_ch, fc[0])

    def forward(self, x, features_left, features_right):
        out = hourglass3d.serve(self, x, features_left, features_right)
        return self.forward_modules(x, features_left, features_right) if out is None else out

    def forward_modules(self, x, features_left, features_right):
        """The plain path: the modules, NCDHW, whatever the device."""
        ns = self.ns
        original = x
        down = []
        for i in range(ns - 1):
            x = self.down_layers[i](x)
            x = self.feature_atts[i](x, features_left[i + 1], features_right[i + 1])
            down.append(x)
        # Reference quirk: every aggregation level reads the STORED down
        # features, not the previous level's result, so only the last level
        # reaches the output.  The earlier levels' weights are kept (they are
        # in every checkpoint) but their dead compute is skipped.
        i = ns - 3
        skip = down[ns - 3 - i]
        x_up = resize_trilinear_align_corners(down[ns - 2 - i], tuple(skip.shape[2:]))
        x = self.agg_layers[i](torch.cat([x_up, skip], dim=1))
        x = self.feature_atts_up[i](x, features_left[ns - 2 - i], features_right[ns - 2 - i])

        x_up = resize_trilinear_align_corners(x, tuple(original.shape[2:]))
        x = self.final_agg(torch.cat([original, x_up], dim=1))
        return self.final_feature_atts_up(x, features_left[0], features_right[0])
