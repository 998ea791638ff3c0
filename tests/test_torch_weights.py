"""Weights carried across: `load_*_variables` fills every parameter and
buffer of the port from the JAX package's variable trees, and the JAX
package's own converter maps the port's `state_dict()` back onto exactly the
JAX `model.init` tree (same leaf paths, same values)."""
import numpy as np
import pytest

import jax
import torch
from flax.traverse_util import flatten_dict

from stereoanywhere_tpu.compat.torch_convert import convert_dav2_checkpoint, convert_stereo_checkpoint

from stereoanywhere_tpu_torch.compat.from_jax import load_dav2_variables, load_stereo_variables

torch.set_num_threads(2)


def _perturbed(tree, seed):
    """The init tree with every leaf moved, so a leaf that is not carried
    across cannot match by coincidence (zeros biases, ones scales)."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: (np.asarray(a) + rng.uniform(0.1, 1.0, np.shape(a))).astype(np.float32), tree)


def _roundtrip(model, variables, convert):
    state = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    back = flatten_dict(convert(state))
    want = flatten_dict(jax.tree.map(np.asarray, dict(variables)))
    assert sorted(back) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(back[k], want[k], err_msg="/".join(k))


@pytest.fixture(scope="module")
def stereo_variables():
    from stereoanywhere_tpu.config import StereoAnywhereConfig as JCfg
    from stereoanywhere_tpu.models import StereoAnywhere as JSA

    z3, z1 = np.zeros((1, 32, 64, 3), np.float32), np.zeros((1, 32, 64, 1), np.float32)
    v = jax.eval_shape(lambda: JSA(JCfg()).init(jax.random.PRNGKey(0), z3, z3, z1, z1, iters=1, test_mode=True))
    rng = np.random.default_rng(0)
    return jax.tree.map(lambda s: rng.standard_normal(s.shape).astype(np.float32), v)


def test_stereo_weights_roundtrip(stereo_variables):
    from stereoanywhere_tpu_torch.models import StereoAnywhere

    model = load_stereo_variables(StereoAnywhere(device="cpu"), stereo_variables)
    _roundtrip(model, stereo_variables, convert_stereo_checkpoint)


def test_dav2_weights_roundtrip():
    from stereoanywhere_tpu.config import MonoConfig as JMono
    from stereoanywhere_tpu.models.dpt import DepthAnythingV2 as JD

    from stereoanywhere_tpu_torch.config import MonoConfig
    from stereoanywhere_tpu_torch.models import DepthAnythingV2

    v = jax.jit(JD(JMono.for_encoder("vits")).init)(jax.random.PRNGKey(0), np.zeros((1, 28, 28, 3), np.float32))
    v = _perturbed(v, 1)
    model = load_dav2_variables(DepthAnythingV2(MonoConfig.for_encoder("vits"), device="cpu"), v)
    _roundtrip(model, v, convert_dav2_checkpoint)


def test_load_raises_on_unused_and_missing_leaves(stereo_variables):
    from stereoanywhere_tpu_torch.models import StereoAnywhere

    model = StereoAnywhere(device="cpu")
    extra = jax.tree.map(lambda a: a, stereo_variables)
    extra["params"]["not_a_module"] = {"kernel": np.zeros((1,), np.float32)}
    with pytest.raises(ValueError, match="left unused"):
        load_stereo_variables(model, extra)
    missing = jax.tree.map(lambda a: a, stereo_variables)
    del missing["params"]["update_block"]["mask_2"]
    with pytest.raises(ValueError, match="left unfilled"):
        load_stereo_variables(model, missing)


def test_dav2_vitg_weights_roundtrip(monkeypatch):
    """ViT-G (at 2 blocks, both packages' configs patched in the test): the
    SwiGLU FFN's `mlp.w12` / `mlp.w3` and the 384-feature head with its
    1536-channel projections map onto the JAX tree and back."""
    from stereoanywhere_tpu.config import MonoConfig as JMono
    from stereoanywhere_tpu.models import dinov2 as jdino, dpt as jdpt
    from stereoanywhere_tpu.models.dpt import DepthAnythingV2 as JD

    from stereoanywhere_tpu_torch.config import MonoConfig
    from stereoanywhere_tpu_torch.models import DepthAnythingV2, dinov2, dpt

    for d, p in ((jdino, jdpt), (dinov2, dpt)):
        monkeypatch.setitem(d.VIT_CONFIGS, "vitg", {**d.VIT_CONFIGS["vitg"], "depth": 4})
        monkeypatch.setitem(p.INTERMEDIATE_LAYER_IDX, "vitg", (0, 1, 2, 3))
    v = jax.eval_shape(lambda: JD(JMono.for_encoder("vitg")).init(jax.random.PRNGKey(0),
                                                                   np.zeros((1, 28, 28, 3), np.float32)))
    rng = np.random.default_rng(2)
    v = jax.tree.map(lambda s: rng.standard_normal(s.shape).astype(np.float32), v)
    assert v["params"]["pretrained"]["blocks_0"]["mlp"]["w12"]["kernel"].shape == (1536, 8192)
    model = load_dav2_variables(DepthAnythingV2(MonoConfig.for_encoder("vitg"), device="cpu"), v)
    _roundtrip(model, v, convert_dav2_checkpoint)
