"""The port stands alone: no file of `stereoanywhere_tpu_torch/`, nor
`chip_smoke.py`, imports JAX, flax or the JAX package, nor the `msgpack` and
`ml_dtypes` packages, which the card's machine lacks (the port reads and
writes flax's msgpack files itself); and its entry points
refuse to run without a CUDA device unless the caller asks for the CPU."""
import ast
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "stereoanywhere_tpu", "msgpack", "ml_dtypes"}


def _port_files():
    return sorted((ROOT / "stereoanywhere_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]


def test_port_imports_nothing_of_jax():
    files = _port_files()
    assert len(files) > 20
    assert {"dcn.py", "mobile_extractors.py", "sgm.py", "update.py"} <= {p.name for p in files}
    bad = {str(p.relative_to(ROOT)): sorted(set(_imported_roots(p)) & FORBIDDEN) for p in files}
    assert {k: v for k, v in bad.items() if v} == {}
    # the name check is exact: the port's own package is allowed
    assert "stereoanywhere_tpu_torch" in set(_imported_roots(ROOT / "chip_smoke.py"))


def test_entry_points_need_cuda_unless_asked_for_cpu(monkeypatch):
    from stereoanywhere_tpu_torch.config import MonoConfig
    from stereoanywhere_tpu_torch.models import DepthAnythingV2, StereoAnywhere
    from stereoanywhere_tpu_torch.serve.pipeline import StereoAnywherePipeline, build_pipeline

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    small = MonoConfig.for_encoder("vits")
    for make in (StereoAnywhere, lambda: DepthAnythingV2(small), lambda: build_pipeline(mono_cfg=None)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    stereo = StereoAnywhere(device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StereoAnywherePipeline(stereo)
    pipe = StereoAnywherePipeline(stereo, device="cpu", iters=1)
    assert next(pipe.stereo.parameters()).device.type == "cpu"
