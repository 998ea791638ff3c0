"""Load the JAX package's flax variable trees into the port's modules.

The port's parameters carry the reference PyTorch names, and the JAX
package's converter maps those names onto its flax paths.  This module is
the port's own copy of that name table, run in the other direction: for
every tensor of the port's `state_dict()` it finds the flax leaf, undoes the
layout change, and copies it in.

Layouts (flax -> torch):
  Conv2d   (kh,kw,I,O)    -> (O,I,kh,kw)
  Conv3d   (kd,kh,kw,I,O) -> (O,I,kd,kh,kw)
  ConvT2d  (kh,kw,O,I)    -> (I,O,kh,kw)
  Linear   (I,O)          -> (O,I)
  norm scale/bias, LayerScale gamma, tokens: as they are.

`load_*_variables` raise on a flax leaf left unused and on a port parameter
or buffer left unfilled.
"""
from __future__ import annotations

import re
from typing import Any, Mapping

import numpy as np
import torch

_WB = {"weight": "kernel", "bias": "bias"}


def _wb(path: list[str], leaf: str, kind: str):
    return path + [_WB[leaf]], (kind if leaf == "weight" else "raw")


# ---------------------------------------------------------------------------
# Stereo model names


def _stereo_rename(name: str):
    """torch name -> (flax path, kind); kind in {conv2d, conv3d, raw, bn}."""
    m = re.match(r"(fnet|cnet)\.(.*)", name)
    if m:
        root, r = m.group(1), m.group(2).split(".")
        if r[0] in ("conv1", "conv2"):
            return _wb([root, r[0]], r[1], "conv2d")
        if r[0] == "norm1":
            return [root, "norm1", r[1]], "bn"
        if re.match(r"layer\d", r[0]):
            base = [root, f"{r[0]}_{r[1]}"]
            if r[2] in ("conv1", "conv2"):
                return _wb(base + [r[2]], r[3], "conv2d")
            if r[2] == "downsample":
                if r[3] == "0":
                    return _wb(base + ["downsample_0"], r[4], "conv2d")
                return base + ["norm3", r[4]], "bn"
            if r[2].startswith("norm"):
                return base + [r[2], r[3]], "bn"
        if r[0].startswith("outputs"):
            scale, i = r[0], r[1]
            if scale == "outputs32":
                return _wb([root, f"outputs32_{i}"], r[2], "conv2d")
            base = [root, f"{scale}_{i}_{r[2]}"]
            if len(r) == 4:
                return _wb(base, r[3], "conv2d")
            if r[3] in ("conv1", "conv2"):
                return _wb(base + [r[3]], r[4], "conv2d")
            if r[3] == "downsample":
                return _wb(base + ["downsample_0"], r[5], "conv2d")
            if r[3].startswith("norm"):
                return base + [r[3], r[4]], "bn"
    m = re.match(r"context_zqr_convs\.(\d)\.(weight|bias)", name)
    if m:
        return _wb([f"context_zqr_convs_{m.group(1)}"], m.group(2), "conv2d")
    m = re.match(r"(classifier_mono|classifier_monoconf)\.weight", name)
    if m:
        return [m.group(1), "conv", "kernel"], "conv3d"
    m = re.match(r"(hourglass_mono)\.(.*)", name)
    if m:
        return _hourglass_rename(m.group(1), m.group(2).split("."))
    m = re.match(r"update_block\.(.*)", name)
    if m:
        r = m.group(1).split(".")
        if r[0] in ("encoder", "gru08", "gru16", "gru32", "flow_head"):
            return _wb(["update_block", r[0], r[1]], r[2], "conv2d")
        if r[0] == "mask":
            return _wb(["update_block", f"mask_{r[1]}"], r[2], "conv2d")
    return None


def _hourglass_rename(root: str, r: list[str]):
    if r[0] in ("down_layers", "agg_layers", "final_agg"):
        base, i = ([root, f"final_agg_{r[1]}"], 2) if r[0] == "final_agg" else ([root, f"{r[0]}_{r[1]}_{r[2]}"], 3)
        if r[i] == "conv" and r[i + 1] == "weight":
            return base + ["conv", "kernel"], "conv3d"
        return None
    if r[0] in ("feature_atts", "feature_atts_up", "final_feature_atts_up"):
        if r[0] == "final_feature_atts_up":
            base, r2 = [root, "final_feature_atts_up"], r[1:]
        else:
            base, r2 = [root, f"{r[0]}_{r[1]}"], r[2:]
        side = r2[0]
        if r2[1] == "0" and r2[2] == "conv":
            return base + [f"{side}_0", "conv", "kernel"], "conv2d"
        if r2[1] == "1":
            return _wb(base + [f"{side}_1"], r2[2], "conv2d")
    return None


# ---------------------------------------------------------------------------
# Depth-Anything-V2 names


def _dav2_rename(name: str):
    r = name.split(".")
    if r[0] == "pretrained":
        base, rest = ["pretrained"], r[1:]
        if rest[0] in ("cls_token", "pos_embed"):
            return base + [rest[0]], "raw"
        if rest[0] == "patch_embed":
            return _wb(base + ["patch_embed_proj"], rest[2], "conv2d")
        if rest[0] == "blocks":
            bb, sub = base + [f"blocks_{rest[1]}"], rest[2:]
            if sub[0] in ("norm1", "norm2"):
                return bb + [sub[0], {"weight": "scale", "bias": "bias"}[sub[1]]], "raw"
            if sub[0] in ("attn", "mlp"):
                return _wb(bb + [sub[0], sub[1]], sub[2], "linear")
            if sub[0] in ("ls1", "ls2"):
                return bb + [sub[0], "gamma"], "raw"
        if rest[0] == "norm":
            return base + ["norm", {"weight": "scale", "bias": "bias"}[rest[1]]], "raw"
        return None
    if r[0] == "depth_head":
        base, rest = ["depth_head"], r[1:]
        if rest[0] == "projects":
            return _wb(base + [f"projects_{rest[1]}"], rest[2], "conv2d")
        if rest[0] == "resize_layers":
            i = int(rest[1])
            kind = {0: "convT2d", 1: "convT2d", 3: "conv2d"}.get(i)
            return None if kind is None else _wb(base + [f"resize_layers_{i}"], rest[2], kind)
        if rest[0] == "scratch":
            sub = rest[1:]
            if sub[0].endswith("_rn"):
                return base + [f"scratch_{sub[0]}", "kernel"], "conv2d"
            if sub[0].startswith("refinenet"):
                rb = base + [f"scratch_{sub[0]}"]
                if sub[1] == "out_conv":
                    return _wb(rb + ["out_conv"], sub[2], "conv2d")
                if sub[1].startswith("resConfUnit"):
                    return _wb(rb + [sub[1], sub[2]], sub[3], "conv2d")
            if sub[0] == "output_conv1":
                return _wb(base + ["scratch_output_conv1"], sub[1], "conv2d")
            if sub[0] == "output_conv2" and sub[1] in ("0", "2"):
                return _wb(base + [f"scratch_output_conv2_{sub[1]}"], sub[2], "conv2d")
    return None


# ---------------------------------------------------------------------------
# Loading

_TO_TORCH = {
    "conv2d": lambda a: a.transpose(3, 2, 0, 1),
    "conv3d": lambda a: a.transpose(4, 3, 0, 1, 2),
    "convT2d": lambda a: a.transpose(3, 2, 0, 1),
    "linear": lambda a: a.T,
    "raw": lambda a: a,
}
_BN_LEAF = {
    "running_mean": ("batch_stats", "mean"),
    "running_var": ("batch_stats", "var"),
    "weight": ("params", "scale"),
    "bias": ("params", "bias"),
}


def _leaves(tree: Mapping, prefix: tuple = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,)


def _get(tree: Mapping, path: tuple):
    node = tree
    for p in path:
        node = node[p]
    return node


def _load(model: torch.nn.Module, variables: Mapping[str, Any], rename, what: str) -> None:
    used = set()
    unmapped = []
    with torch.no_grad():
        for name, tensor in model.state_dict(keep_vars=True).items():
            mapped = rename(name)
            if mapped is None:
                unmapped.append(name)
                continue
            path, kind = mapped
            if kind == "bn":
                collection, leaf = _BN_LEAF[path[-1]]
                full, kind = (collection, *path[:-1], leaf), "raw"
            else:
                full = ("params", *path)
            try:
                value = np.asarray(_get(variables, full), dtype=np.float32)
            except KeyError:
                unmapped.append(name)
                continue
            value = _TO_TORCH[kind](value)
            if tuple(value.shape) != tuple(tensor.shape):
                raise ValueError(f"{what}: {name} has shape {tuple(tensor.shape)}, flax {'/'.join(full)} {value.shape}")
            tensor.copy_(torch.tensor(value))
            used.add(full)
    if unmapped:
        raise ValueError(f"{what}: port tensors left unfilled ({len(unmapped)}): {unmapped[:10]}")
    unused = sorted("/".join(p) for p in _leaves(variables) if p not in used)
    if unused:
        raise ValueError(f"{what}: flax leaves left unused ({len(unused)}): {unused[:10]}")


def load_stereo_variables(model: torch.nn.Module, variables: Mapping[str, Any]) -> torch.nn.Module:
    """Fill a port `StereoAnywhere` from the JAX model's {'params',
    'batch_stats'} tree (nested dicts of arrays).  The fused loop's packed
    weights are packed anew at its next use."""
    _load(model, variables, _stereo_rename, "load_stereo_variables")
    for m in model.modules():
        if hasattr(m, "clear_fused_cache"):
            m.clear_fused_cache()
    return model


def load_dav2_variables(model: torch.nn.Module, variables: Mapping[str, Any]) -> torch.nn.Module:
    """Fill a port `DepthAnythingV2` from the JAX model's {'params'} tree."""
    _load(model, variables, _dav2_rename, "load_dav2_variables")
    return model
