"""Released PyTorch checkpoints, read for the port's modules.

`load_torch_state_dict` is a copy of the JAX package's
`compat/torch_convert.py` function: a `.pth` / `.tar` file, a state dict or
a {state_dict | model | model_state_dict: ...} wrapper, its tensors as f32
numpy arrays under names without the `module.` prefix of
`nn.DataParallel`.  The port's modules carry the reference's parameter
names, so `load_state_dict_into` fills them with no renaming; it leaves out
what the JAX package's converters leave out (the batch counters of the
stereo model's norms; DAv2's `mask_token`, and the `resize_layers.2` and
`refinenet4.resConfUnit1` that the reference builds and never runs, and
the last hourglass of a stacked variant's `hourglass_{mono,stereo}_stack`,
which the reference builds and never runs either: `models/stereoanywhere.py`
`hourglass_stack`) and raises on any other name that does not match.
"""
from __future__ import annotations

import numpy as np
import torch

SKIPPED = ("num_batches_tracked", "mask_token", "resize_layers.2", "refinenet4.resConfUnit1")


def load_torch_state_dict(path: str) -> dict[str, np.ndarray]:
    """Load a torch checkpoint to a flat {name: np.ndarray} dict."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict):
        for key in ("state_dict", "model", "model_state_dict"):
            if key in obj and isinstance(obj[key], dict):
                obj = obj[key]
                break
    out = {}
    for k, v in obj.items():
        if hasattr(v, "numpy"):
            out[k.removeprefix("module.")] = v.detach().cpu().float().numpy()
    return out


def load_state_dict_into(model: torch.nn.Module, state: dict[str, np.ndarray]) -> torch.nn.Module:
    """Copy `state` (from `load_torch_state_dict`) into `model`, in place
    and in the model's dtypes; strict but for `SKIPPED`."""
    cfg = getattr(model, "cfg", None)
    unused = ()
    if cfg is not None and hasattr(cfg, "n_additional_hourglass"):
        from stereoanywhere_tpu_torch.models.stereoanywhere import unused_stack_entries

        unused = unused_stack_entries(cfg)
    kept = {k: torch.from_numpy(v) for k, v in state.items()
            if not any(s in k for s in SKIPPED) and not k.startswith(unused)}
    model.load_state_dict(kept)
    return model
