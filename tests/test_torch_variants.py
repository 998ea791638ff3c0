"""The aggregation variants no shipped model uses, on the CPU, against the
JAX package: `use_aggregate_stereo_vol` (the masked stereo volume through
`hourglass_stereo`, its stack and `classifier_stereo`, whose volume replaces
the raw one in the loop and whose coarse disparities are outputs and loss
terms) with `n_additional_hourglass=2` (one stacked hourglass after each
volume's first: the reference's identity-first quirk runs n - 1).

The JAX model's variables come from its own `init` (default layout: the
folded, blocked hourglasses) and reach the port through `compat.from_jax`;
inputs are made with numpy from a seed, at 32 x 64 (the smallest size the
hourglass admits).
- Test mode in f32, 2 iterations: the disparity within 1e-3 px + 5e-5
  rel. (PERF.md §2's end-to-end bound), the coarse stereo and mono
  disparities within 1e-4 + 1e-5 rel. (`tests/test_torch_voldown.py`'s).
- bf16, 4 iterations: the port's output at most twice as far from JAX's
  bf16 output as that lies from JAX's f32 output (`tests/test_torch_bf16.py`).
- Train mode: the loss and its logs (the coarse stereo terms included)
  within 1e-4 rel., and every trainable parameter's gradient within 4e-2 of
  its norm, all of them within 5e-3 (`tests/test_torch_train.py`'s bounds).
- Weights: the JAX tree has `hourglass_{mono,stereo}_stack_1` and no entry
  0 or 2; the port's `state_dict` maps onto it exactly through the JAX
  package's converter; a reference-named checkpoint (the never-applied
  `stack.2` and the batch counters included) loads through `.tar` and
  through `cli convert`'s `.msgpack`.
- `vol_downsample > 0` with the stereo aggregation fails in the JAX
  package (it downsamples the masks and not the stereo volume); the port
  refuses it.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from flax.traverse_util import flatten_dict

from stereoanywhere_tpu_torch.compat import from_jax

torch.set_num_threads(2)
B, H, W = 1, 32, 64
VARIANT = dict(use_aggregate_stereo_vol=True, n_additional_hourglass=2)
KEYS = ("disparity", "coarse_dispstereo2", "coarse_dispstereo3", "coarse_dispmono2")


def _inputs(seed=11):
    rng = np.random.default_rng(seed)
    return [rng.uniform(0, 1, (B, H, W, c)).astype(np.float32) for c in (3, 3, 1, 1)]


def _gap(a, b) -> float:
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.fixture(scope="module")
def variables():
    from stereoanywhere_tpu.config import StereoAnywhereConfig as JCfg
    from stereoanywhere_tpu.models import StereoAnywhere as JSA

    m = JSA(JCfg(**VARIANT, volume_corruption_prob=0.0))
    v = jax.jit(lambda k: m.init(k, *_inputs(), iters=1, test_mode=True))(jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, v)


def _jax(variables, ins, iters, **kw):
    from stereoanywhere_tpu.config import StereoAnywhereConfig as JCfg
    from stereoanywhere_tpu.models import StereoAnywhere as JSA

    m = JSA(JCfg(**VARIANT, **kw))
    out = jax.jit(lambda v, *a: m.apply(v, *a, iters=iters, test_mode=True))(variables, *ins)
    return {k: np.asarray(out[k], np.float32) for k in KEYS}


def _port_model(variables, **kw):
    from stereoanywhere_tpu_torch.config import StereoAnywhereConfig
    from stereoanywhere_tpu_torch.models import StereoAnywhere

    return from_jax.load_stereo_variables(StereoAnywhere(StereoAnywhereConfig(**VARIANT, **kw), device="cpu"),
                                          variables)


def _port(variables, ins, iters, **kw):
    out = _port_model(variables, **kw)(*map(torch.from_numpy, ins), iters=iters)
    return {k: out[k].float().numpy() for k in KEYS}


def test_variant_tree_holds_the_applied_stack_entries_only(variables):
    from stereoanywhere_tpu.compat.torch_convert import convert_stereo_checkpoint

    params = variables["params"]
    for v in ("mono", "stereo"):
        assert f"hourglass_{v}_stack_1" in params
        assert f"hourglass_{v}_stack_0" not in params and f"hourglass_{v}_stack_2" not in params
    assert "classifier_stereo" in params and "hourglass_stereo" in params
    model = _port_model(variables)
    names = list(model.state_dict())
    assert any(n.startswith("hourglass_stereo_stack.1.") for n in names)
    assert not any(n.startswith(("hourglass_mono_stack.0.", "hourglass_mono_stack.2.")) for n in names)
    # the port's state dict maps onto exactly the JAX tree, value for value
    back = flatten_dict(convert_stereo_checkpoint({k: t.numpy() for k, t in model.state_dict().items()}))
    want = flatten_dict(variables)
    assert sorted(back) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(back[k], want[k], err_msg="/".join(k))


def test_variant_forward_matches_jax(variables):
    ins = _inputs()
    want = _jax(variables, ins, 2)
    got = _port(variables, ins, 2)
    assert got["disparity"].shape == (B, H, W, 1) and np.isfinite(got["disparity"]).all()
    np.testing.assert_allclose(got["disparity"], want["disparity"], rtol=5e-5, atol=1e-3)
    for k in KEYS[1:]:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-4, err_msg=k)


def test_variant_bf16_within_twice_jax_gap(variables):
    ins = _inputs(12)
    want32 = _jax(variables, ins, 4)
    bf16 = jax.tree.map(lambda a: jnp.asarray(a).astype(jnp.bfloat16) if a.dtype == np.float32 else a, variables)
    want16 = _jax(bf16, ins, 4, compute_dtype="bfloat16")
    got = _port(variables, ins, 4, compute_dtype="bfloat16")
    for k in ("disparity", "coarse_dispstereo2", "coarse_dispmono2"):
        assert np.isfinite(got[k]).all()
        assert _gap(got[k], want16[k]) <= 2 * _gap(want16[k], want32[k]), k


def test_variant_stereo_hourglass_runs_in_f32_past_its_first_gate(variables):
    """In a bf16 model the stereo hourglass's output is f32, as the mono
    one's: the f32 depth pyramids' gates promote the volume."""
    model = _port_model(variables, compute_dtype="bfloat16")
    seen = {}
    for name in ("hourglass_stereo", "hourglass_stereo_stack"):
        mod = getattr(model, name)
        mod = mod[1] if isinstance(mod, torch.nn.ModuleList) else mod

        def hook(m, args, out, name=name):
            seen.setdefault(name, (args[0].dtype, out.dtype))

        mod.register_forward_hook(hook)
    model(*map(torch.from_numpy, _inputs()), iters=1)
    assert seen == {"hourglass_stereo": (torch.bfloat16, torch.float32),
                    "hourglass_stereo_stack": (torch.float32, torch.float32)}


def test_variant_train_loss_gradients_match_jax(variables):
    from stereoanywhere_tpu.config import StereoAnywhereConfig as JCfg, TrainConfig as JTrain
    from stereoanywhere_tpu.models import StereoAnywhere as JSA
    from stereoanywhere_tpu.train.loss import stereoanywhere_loss as jloss
    from stereoanywhere_tpu.train.trainer import freeze_mask

    from stereoanywhere_tpu_torch.config import TrainConfig
    from stereoanywhere_tpu_torch.train.loss import stereoanywhere_loss

    rng = np.random.default_rng(21)
    ins = _inputs(21)
    gt, gt_r = (rng.uniform(0.5, 12, (B, H, W, 1)).astype(np.float32) for _ in range(2))
    valid, valid_r = ((rng.uniform(0, 1, (B, H, W, 1)) > 0.2).astype(np.float32) for _ in range(2))
    jm = JSA(JCfg(**VARIANT, volume_corruption_prob=0.0))

    def loss_fn(params):
        mask = freeze_mask(params, ("fnet",))
        params = jax.tree.map(lambda p, t: p if t else jax.lax.stop_gradient(p), params, mask)
        out, _ = jm.apply({"params": params, "batch_stats": variables["batch_stats"]}, *ins, iters=2,
                          test_mode=False, train=True, mutable=["batch_stats"])
        return jloss(out, gt, valid, gt_r, valid_r, ins[2], ins[3], JTrain())

    (jtotal, jlogs), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(variables["params"])
    grads = jax.tree.map(np.asarray, grads)

    model = _port_model(variables, volume_corruption_prob=0.0)
    for name, p in model.named_parameters():
        p.requires_grad_(not name.startswith("fnet."))
    tins = [torch.from_numpy(a) for a in ins]
    out = model(*tins, iters=2, test_mode=False)
    assert "coarse_dispstereo2" in out and out["coarse_dispstereo2"].requires_grad
    total, logs = stereoanywhere_loss(out, *map(torch.from_numpy, (gt, valid, gt_r, valid_r)), tins[2], tins[3],
                                      TrainConfig())
    np.testing.assert_allclose(float(total.detach()), float(jtotal), rtol=1e-4)
    for k, v in jlogs.items():
        np.testing.assert_allclose(float(logs[k].detach()), float(v), rtol=1e-4, atol=1e-6, err_msg=k)
    total.backward()
    num = den = 0.0
    checked = set()
    for name, p in model.named_parameters():
        if name.startswith("fnet."):
            continue
        path, kind = from_jax._stereo_rename(name)
        if kind == "bn":
            path, kind = path[:-1] + [{"weight": "scale", "bias": "bias"}[path[-1]]], "raw"
        want = from_jax._TO_TORCH[kind](from_jax._get(grads, tuple(path)))
        got = np.zeros_like(want) if p.grad is None else p.grad.numpy()
        d, n = float(np.linalg.norm(got - want)), float(np.linalg.norm(want))
        assert d <= 4e-2 * n + 1e-9, (name, d, n)
        num, den = num + d * d, den + n * n
        checked.add(name.split(".")[0])
    assert {"hourglass_stereo", "hourglass_stereo_stack", "classifier_stereo", "hourglass_mono_stack"} <= checked
    assert np.sqrt(num) <= 5e-3 * np.sqrt(den)


def test_variant_reference_checkpoint_loads_through_tar_and_msgpack(variables, tmp_path):
    from stereoanywhere_tpu.compat.torch_convert import convert_stereo_checkpoint

    from stereoanywhere_tpu_torch import cli
    from stereoanywhere_tpu_torch.compat import msgpack
    from stereoanywhere_tpu_torch.config import StereoAnywhereConfig

    model = _port_model(variables)
    state = {k: t.clone() for k, t in model.state_dict().items()}
    # what a reference checkpoint adds: the stacks' never-applied last
    # hourglass (copies of stack.1's, moved) and the norms' batch counters
    for k, t in model.state_dict().items():
        for v in ("mono", "stereo"):
            if k.startswith(f"hourglass_{v}_stack.1."):
                state[k.replace("_stack.1.", "_stack.2.")] = t + 1.0
        if k.endswith("running_mean"):
            state[k.replace("running_mean", "num_batches_tracked")] = torch.tensor(7)
    torch.save({"state_dict": {f"module.{k}": t for k, t in state.items()}}, tmp_path / "variant.tar")
    cfg = StereoAnywhereConfig(**VARIANT)
    loaded = cli._load_stereo(str(tmp_path / "variant.tar"), cfg, device="cpu")
    assert cli.main(["convert", "--input", str(tmp_path / "variant.tar"), "--output",
                     str(tmp_path / "variant.msgpack")]) is None
    from_msgpack = cli._load_stereo(str(tmp_path / "variant.msgpack"), cfg, device="cpu")
    for k, t in model.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], t), k
        assert torch.equal(from_msgpack.state_dict()[k], t), k
    # the msgpack tree is the JAX converter's, the never-applied entry included
    numpy_state = {k: t.numpy() for k, t in state.items()}
    tree = flatten_dict(msgpack.read(tmp_path / "variant.msgpack"))
    want = flatten_dict(convert_stereo_checkpoint(numpy_state))
    assert sorted(tree) == sorted(want) and ("params", "hourglass_stereo_stack_2", "final_agg_0", "conv",
                                             "kernel") in want
    for k in want:
        np.testing.assert_array_equal(np.asarray(tree[k]), want[k], err_msg="/".join(k))


def test_variant_refuses_vol_downsample_as_jax_fails():
    from stereoanywhere_tpu.config import StereoAnywhereConfig as JCfg
    from stereoanywhere_tpu.models import StereoAnywhere as JSA

    from stereoanywhere_tpu_torch.config import StereoAnywhereConfig
    from stereoanywhere_tpu_torch.models import StereoAnywhere

    ins = [np.zeros((1, 64, 64, c), np.float32) for c in (3, 3, 1, 1)]
    with pytest.raises(TypeError, match="incompatible shapes"):
        jax.eval_shape(lambda: JSA(JCfg(**VARIANT, vol_downsample=1)).init(jax.random.PRNGKey(0), *ins, iters=1))
    with pytest.raises(ValueError, match="vol_downsample"):
        StereoAnywhere(StereoAnywhereConfig(**VARIANT, vol_downsample=1), device="cpu")
    with pytest.raises(ValueError, match="n_additional_hourglass"):
        StereoAnywhereConfig(n_additional_hourglass=-1)
    assert StereoAnywhereConfig().use_aggregate_stereo_vol is False
    assert StereoAnywhereConfig().n_additional_hourglass == 0
