"""The plain references that decide `correct` and whose FLOPs `pair_mfu`
counts.

A configuration names its reference with the top-level key `"reference"`:
the name of a module `port_bench/reference/<name>.py` that exposes

- `build(cfg) -> torch.nn.Module`: the f32 pipeline on the meta device,
  `(1,H,W,3)` views in, the `(1,H,W,1)` disparity out, with `.stereo` and
  `.mono` submodules under the port's parameter names, so that one draw of
  `port_bench.weights` fills both alike;
- `STEREO_KEYS`: the keys of the configuration's `stereo` block that the
  module models.

Without the key the reference is `shipped`, the shipped model.  A module
is loaded by its file from the checkout at `root`, under the name
`port_bench_reference_<name>` in `sys.modules`, so that a variant's
reference is a new file only.  Nothing here imports the port.
"""
from __future__ import annotations

import importlib.util
import sys
from pathlib import Path
from types import ModuleType

REPO = Path(__file__).resolve().parents[2]
DEFAULT = "shipped"
# implementation switches of the port's `stereo` block: each computes the
# same function, so no reference models them
SWITCHES = frozenset({"compute_dtype", "fused_level0", "lookup_impl"})


def name_of(cfg: dict) -> str:
    return cfg.get("reference", DEFAULT)


def path_of(name: str, root: Path = REPO) -> Path:
    return root / "port_bench" / "reference" / f"{name}.py"


def load(name: str, root: Path = REPO) -> ModuleType:
    spec = importlib.util.spec_from_file_location(f"port_bench_reference_{name}", path_of(name, root))
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module  # a dataclass in it looks its module up there
    spec.loader.exec_module(module)
    return module


def build(cfg: dict, root: Path = REPO):
    """The configuration's reference pipeline on the meta device."""
    return load(name_of(cfg), root).build(cfg)
