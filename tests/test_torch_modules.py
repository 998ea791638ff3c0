"""The port's modules held against the JAX package's, module by module, on
the CPU in f32.

Inputs are made with numpy from a seed and fed to both; the JAX side runs
NHWC, the port NCHW where its modules do, and the outputs are compared in
the JAX layout.  Tolerance 1e-4 (relative to the output's scale where the
random-weight outputs are large): the same f32 arithmetic with sums in
another order -- XLA's banded conv3d and im2col matmuls against MKL-DNN's
convolutions.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from stereoanywhere_tpu_torch.compat import from_jax

torch.set_num_threads(2)
TOL = 1e-4


def nchw(a):
    return torch.from_numpy(np.array(a, dtype=np.float32)).permute(0, 3, 1, 2)


def nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def close(got, want, tol=TOL):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * max(1.0, float(np.abs(want).max())))


def load_sub(module, variables, prefix, rename):
    """Load a JAX submodule's tree into a port submodule whose names the
    full model prefixes with `prefix`."""
    root = prefix.rstrip(".")
    wrapped = {col: {root: tree} for col, tree in variables.items()}
    from_jax._load(module, wrapped, lambda n: rename(prefix + n), "test")
    return module


# ---------------------------------------------------------------------------
# interp


@pytest.mark.parametrize("method,src,dst", [
    ("cubic", (13, 17), (29, 40)),   # upsampling
    ("cubic", (40, 50), (13, 17)),   # antialiased downsampling
    ("bilinear", (40, 50), (13, 17)),  # antialiased downsampling
    ("bilinear", (13, 17), (29, 40)),
    ("cubic", (518, 518), (512, 512)),  # the pipeline's depth resize back
])
def test_resize_jax_image(rng, method, src, dst):
    from stereoanywhere_tpu_torch.ops.interp import resize_jax_image

    x = rng.uniform(0, 1, (2, *src, 3)).astype(np.float32)
    want = jax.image.resize(jnp.asarray(x), (2, *dst, 3), method)
    close(nhwc(resize_jax_image(nchw(x), dst, method)), want, 1e-5)


def test_align_corners_halfpix_and_pools(rng):
    from stereoanywhere_tpu.ops import interp as J

    from stereoanywhere_tpu_torch.ops import interp as P

    x = rng.standard_normal((2, 9, 14, 3)).astype(np.float32)
    close(nhwc(P.resize_bilinear_align_corners(nchw(x), (17, 5))), J.resize_bilinear_align_corners(x, (17, 5)))
    close(nhwc(P.resize_bilinear_halfpix(nchw(x), (31, 40))), J.resize_bilinear_halfpix(x, (31, 40)))
    v = rng.standard_normal((1, 4, 6, 8, 2)).astype(np.float32)  # NDHWC
    got = P.resize_trilinear_align_corners(torch.from_numpy(v).permute(0, 4, 1, 2, 3), (7, 3, 16))
    close(got.permute(0, 2, 3, 4, 1).numpy(), J.resize_trilinear_align_corners(v, (7, 3, 16)))
    close(nhwc(P.pool2x(nchw(x))), J.pool2x(x))
    close(nhwc(P.pool4x(nchw(x))), J.pool4x(x))
    close(P.avg_pool_last_axis_2(torch.from_numpy(x[..., 0].copy())).numpy(), J.avg_pool_last_axis_2(x[..., 0]))


# ---------------------------------------------------------------------------
# volume / lsq / geometry / upsample / lookup


def test_volume_ops(rng):
    from stereoanywhere_tpu.ops import volume as J

    from stereoanywhere_tpu_torch.ops import volume as P

    fl, fr = (rng.standard_normal((2, 6, 10, 16)).astype(np.float32) for _ in range(2))
    close(P.all_pairs_correlation(nchw(fl), nchw(fr)).numpy(), J.all_pairs_correlation(fl, fr))
    mde = rng.uniform(0, 1, (2, 6, 10, 1)).astype(np.float32)
    close(nhwc(P.generate_masks(nchw(mde), 8)), J.generate_masks(mde, 8))
    vol = (3 * rng.standard_normal((2, 6, 10, 10))).astype(np.float32)
    vt = torch.from_numpy(vol)
    for name in ("estimate_left_disparity", "estimate_right_disparity",
                 "estimate_left_confidence", "estimate_right_confidence"):
        close(nhwc(getattr(P, name)(vt)), getattr(J, name)(vol))
    disp = rng.uniform(0, 8, (2, 6, 10, 1)).astype(np.float32)
    conf = rng.uniform(0, 1, (2, 6, 10, 1)).astype(np.float32)
    close(P.truncate_corr_volume(nchw(disp), nchw(conf), None, 0.9).numpy(),
          J.truncate_corr_volume(disp, conf, None, 0.9))
    a, b, c, d = (rng.uniform(0, 1, (2, 6, 10, 1)).astype(np.float32) for _ in range(4))
    close(nhwc(P.handcrafted_mirror_detector(*map(nchw, (a, b, c, d)), conf_th=0.98)),
          J.handcrafted_mirror_detector(a, b, c, d, conf_th=0.98))


def test_lsq_geometry_upsample(rng):
    from stereoanywhere_tpu.ops import geometry as JG, lsq as JL, upsample as JU

    from stereoanywhere_tpu_torch.ops import geometry as PG, lsq as PL, upsample as PU

    m, c = (rng.uniform(0, 1, (2, 8, 16, 2)).astype(np.float32) for _ in range(2))
    d = rng.normal(10, 5, (2, 8, 16, 2)).astype(np.float32)
    # closed-form 2x2 solve: det cancels, so relative 1e-4 on the solution
    for got, want in zip(PL.weighted_lsq(nchw(m), nchw(d), nchw(c)), JL.weighted_lsq(m, d, c)):
        np.testing.assert_allclose(got.numpy().ravel(), np.asarray(want).ravel(), rtol=1e-4)

    x1, x2 = (rng.normal(3, 2, (2, 8, 16, 1)).astype(np.float32) for _ in range(2))
    for got, want in zip(PG.joint_minmax_normalize([nchw(x1), nchw(x2)]), JG.joint_minmax_normalize([x1, x2])):
        close(nhwc(got), want)
    close(nhwc(PG.estimate_normals(nchw(x1), 1.6)), JG.estimate_normals(x1, 1.6))
    img = rng.standard_normal((2, 8, 16, 3)).astype(np.float32)
    dsp = rng.uniform(-2, 6, (2, 8, 16, 1)).astype(np.float32)
    for right in (False, True):
        close(nhwc(PG.disp_warping(nchw(dsp), nchw(img), right)), JG.disp_warping(dsp, img, right))
    for got, want in zip(PG.softlrc(nchw(x1), nchw(x2)), JG.softlrc(x1, x2)):
        close(nhwc(got), want)

    flow = rng.standard_normal((2, 5, 7, 1)).astype(np.float32)
    mask = rng.standard_normal((2, 5, 7, 144)).astype(np.float32)
    close(nhwc(PU.convex_upsample(nchw(flow), nchw(mask), 2)), JU.convex_upsample(flow, mask, 2))


def test_corr_pyramid_lookup(rng):
    from stereoanywhere_tpu.ops.corr_lookup import build_corr_pyramid, lookup_corr_pyramid

    from stereoanywhere_tpu_torch.ops import corr_lookup as P

    vol = rng.standard_normal((1, 8, 16, 32)).astype(np.float32)
    coords = rng.uniform(-6, 38, (1, 8, 16)).astype(np.float32)
    want = lookup_corr_pyramid(build_corr_pyramid(jnp.asarray(vol), 4, 4), jnp.asarray(coords))
    got = P.lookup_corr_pyramid(P.build_corr_pyramid(torch.from_numpy(vol), 4), torch.from_numpy(coords), 4)
    close(got.numpy(), want)


# ---------------------------------------------------------------------------
# networks


def test_extractors(rng):
    from stereoanywhere_tpu.models.extractor import ContextEncoder as JC, FeatureEncoder as JF

    from stereoanywhere_tpu_torch.models.extractor import ContextEncoder, FeatureEncoder
    from stereoanywhere_tpu_torch.models.layers import init_weights

    img = rng.uniform(-1, 1, (2, 32, 48, 3)).astype(np.float32)
    jf = JF(256)
    vf = jax.tree.map(np.asarray, jax.jit(jf.init)(jax.random.PRNGKey(0), img))
    pf = load_sub(FeatureEncoder(256), vf, "fnet.", from_jax._stereo_rename)
    close(nhwc(pf(nchw(img)).detach()), jax.jit(jf.apply)(vf, img))

    mde = rng.uniform(0, 1, (1, 32, 48, 1)).astype(np.float32)
    jc = JC(((128,) * 3, (128,) * 3))
    vc = jax.tree.map(np.asarray, jax.jit(jc.init)(jax.random.PRNGKey(1), mde))
    # non-trivial running statistics
    vc["batch_stats"] = jax.tree.map(lambda a: a + rng.uniform(0.1, 0.5, a.shape).astype(np.float32),
                                     vc["batch_stats"])
    pc = init_weights(ContextEncoder(((128,) * 3, (128,) * 3)), torch.Generator().manual_seed(0))
    load_sub(pc, vc, "cnet.", from_jax._stereo_rename)
    with torch.no_grad():
        got = pc(nchw(mde))
    want = jax.jit(jc.apply)(vc, mde)
    for gs, ws in zip(got, want):
        for g, w in zip(gs, ws):
            close(nhwc(g), w)


def test_hourglass_matches_jax_blocked_default(rng):
    """The port's plain NCDHW hourglass against the JAX default: folded AND
    blocked (W2 = 32 splits into nb = 2 blocks)."""
    from stereoanywhere_tpu.models.hourglass import Hourglass as JH
    from stereoanywhere_tpu.ops.folded import build_masked_volume_blocked, from_blocks, pick_nb, unfold
    from stereoanywhere_tpu.ops.volume import generate_masks

    from stereoanywhere_tpu_torch.models.hourglass import Hourglass
    from stereoanywhere_tpu_torch.ops.volume import masked_volume

    b, h, w2 = 1, 8, 32
    vol = rng.standard_normal((b, h, w2, w2)).astype(np.float32)
    mde2, mde3 = (rng.uniform(0, 1, (b, h, w2, 1)).astype(np.float32) for _ in range(2))
    fl = [rng.uniform(0, 1, (b, h // 2 ** i, w2 // 2 ** i, 1)).astype(np.float32) for i in range(4)]
    fr = [rng.uniform(0, 1, (b, h // 2 ** i, w2 // 2 ** i, 1)).astype(np.float32) for i in range(4)]
    nb = pick_nb(w2)
    assert nb >= 2
    lm, rm = generate_masks(jnp.asarray(mde2), 8), generate_masks(jnp.asarray(mde3), 8)
    masked = build_masked_volume_blocked(jnp.asarray(vol), lm, rm, jnp.float32, nb)
    jh = JH(8, 8, folded=True, blocked=True)
    v = jax.tree.map(np.asarray, jax.jit(jh.init)(jax.random.PRNGKey(0), masked, fl, fr))
    want = unfold(from_blocks(jax.jit(jh.apply)(v, masked, fl, fr)), 8)  # (B, W3, H, W2, C)

    ph = load_sub(Hourglass(8, 8), v, "hourglass_mono.", from_jax._stereo_rename)
    pmasked = masked_volume(torch.from_numpy(vol), nchw(np.asarray(lm)), nchw(np.asarray(rm)))
    with torch.no_grad():
        got = ph(pmasked, [nchw(f) for f in fl], [nchw(f) for f in fr])
    close(got.permute(0, 2, 3, 4, 1).numpy(), want)


def test_refinement_step(rng):
    """One GRU iteration (lookups, motion encoder, 3-scale cascade, flow and
    mask heads, coords update) against the JAX RefinementStep."""
    from stereoanywhere_tpu.models.update import RefinementStep
    from stereoanywhere_tpu.ops.corr_lookup import build_corr_pyramid

    from stereoanywhere_tpu_torch.models.update import MultiUpdateBlock, refinement_step
    from stereoanywhere_tpu_torch.ops.corr_lookup import build_corr_pyramid as pyr
    from stereoanywhere_tpu_torch.ops.cuda.corr_lookup import DualPyramid

    b, h, w = 1, 8, 16
    net = [np.tanh(rng.standard_normal((b, h // 2 ** i, w // 2 ** i, 128))).astype(np.float32) for i in range(3)]
    inp = [tuple(rng.standard_normal((b, h // 2 ** i, w // 2 ** i, 128)).astype(np.float32) for _ in range(3))
           for i in range(3)]
    svol, mvol = (rng.standard_normal((b, h, w, w)).astype(np.float32) for _ in range(2))
    coords0 = np.broadcast_to(np.arange(w, dtype=np.float32)[None, None, :, None], (b, h, w, 1)).copy()
    coords1 = coords0 - rng.uniform(0, 6, (b, h, w, 1)).astype(np.float32)
    consts = (build_corr_pyramid(jnp.asarray(svol), 4, 4).levels, build_corr_pyramid(jnp.asarray(mvol), 4, 4).levels,
              inp, coords0)
    step = RefinementStep(emit_outputs=False, compute_mask=True, lookup_impl="window")
    v = jax.tree.map(np.asarray, jax.jit(step.init)(jax.random.PRNGKey(0), (tuple(net), coords1), consts))
    (jnet, jc1), jmask = jax.jit(step.apply)(v, (tuple(net), coords1), consts)

    block = load_sub(MultiUpdateBlock(), {"params": v["params"]}, "update_block.", from_jax._stereo_rename)
    with torch.no_grad():
        pnet, pc1, pmask = refinement_step(
            block, [nchw(n) for n in net], [tuple(nchw(t) for t in tr) for tr in inp],
            DualPyramid(pyr(torch.from_numpy(svol), 4), pyr(torch.from_numpy(mvol), 4)), nchw(coords1), nchw(coords0),
            4, True,
        )
    for g, wnt in zip(pnet, jnet):
        close(nhwc(g), wnt)
    close(nhwc(pc1), jc1)
    close(nhwc(pmask), jmask)


def test_dav2_vits(rng):
    """DAv2 ViT-S at 56x56 (pos-embed interpolation, the ViT blocks through
    the kernels' plain versions, the DPT head)."""
    from stereoanywhere_tpu.config import MonoConfig as JMono
    from stereoanywhere_tpu.models.dpt import DepthAnythingV2 as JD

    from stereoanywhere_tpu_torch.config import MonoConfig
    from stereoanywhere_tpu_torch.models.dpt import DepthAnythingV2

    x = rng.standard_normal((2, 56, 56, 3)).astype(np.float32)
    jm = JD(JMono.for_encoder("vits"))
    v = jax.tree.map(np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(0), x))
    want = jax.jit(jm.apply)(v, x)
    pm = from_jax.load_dav2_variables(DepthAnythingV2(MonoConfig.for_encoder("vits"), device="cpu"), v)
    close(pm(torch.from_numpy(x)).numpy(), want)
