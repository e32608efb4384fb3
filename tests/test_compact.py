"""Domain-compaction correctness: compact pipeline must reproduce the
dense pipeline (images and parameter gradients)."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from bhnerf_jax import units
from bhnerf_jax.geodesics import image_plane_geos
from bhnerf_jax.models import NeRFPredictor
from bhnerf_jax.ops import gr
from bhnerf_jax.train import raytracing_args
from bhnerf_jax.train.step import (compact_raytracing_args,
                                   image_plane_prediction)


@pytest.fixture(scope='module')
def setup():
    geos = image_plane_geos(spin=0.0, inclination=np.deg2rad(60),
                            alpha_range=(-8, 8), beta_range=(-8, 8),
                            ngeo=32, num_alpha=16, num_beta=16,
                            n_fine=2048)
    Omega = geos.keplerian_omega()
    umu = gr.azimuthal_velocity_vector(geos, Omega)
    g = gr.doppler_factor(geos, umu)
    b = gr.magnetic_field_fluid_frame(geos, umu, 0, 1, 0)
    J = np.nan_to_num(np.asarray(gr.parallel_transport(
        geos, umu, g, b, Q_frac=0.5, V_frac=0.0)), nan=0.0)
    rt = raytracing_args(geos, Omega, -float(geos.r_o + 4),
                         units.Quantity(0.0, 'hr'), J=J)
    rt_scalar = raytracing_args(geos, Omega, -float(geos.r_o + 4),
                                units.Quantity(0.0, 'hr'))
    predictor = NeRFPredictor(scale=8.0, rmin=3.0, rmax=8.0, z_width=2.0,
                              net_depth=3, net_width=32)
    params = predictor.init_params(seed=0)
    t_frames_M = jnp.asarray([0.0, 50.0, 120.0], jnp.float32)
    return predictor, params, rt, rt_scalar, t_frames_M


def test_compact_matches_dense_polarized(setup):
    predictor, params, rt, _, t_frames_M = setup
    crt = compact_raytracing_args(rt, predictor)
    dense = np.asarray(image_plane_prediction(params, predictor,
                                              t_frames_M, rt))
    compact = np.asarray(image_plane_prediction(params, predictor,
                                                t_frames_M, crt))
    assert compact.shape == dense.shape == (3, 3, 16, 16)
    scale = np.abs(dense).max()
    np.testing.assert_allclose(compact / scale, dense / scale, atol=2e-5)
    # compaction keeps only the in-domain fraction
    assert crt.coords.shape[-1] < 0.6 * 16 * 16 * 32


def test_compact_matches_dense_unpolarized(setup):
    predictor, params, _, rt_scalar, t_frames_M = setup
    crt = compact_raytracing_args(rt_scalar, predictor)
    dense = np.asarray(image_plane_prediction(params, predictor,
                                              t_frames_M, rt_scalar))
    compact = np.asarray(image_plane_prediction(params, predictor,
                                                t_frames_M, crt))
    assert compact.shape == dense.shape == (3, 16, 16)
    scale = np.abs(dense).max() + 1e-12
    np.testing.assert_allclose(compact / scale, dense / scale, atol=2e-5)


def test_compact_gradients_match(setup):
    predictor, params, rt, _, t_frames_M = setup
    crt = compact_raytracing_args(rt, predictor)
    target = jnp.asarray(np.random.default_rng(0).random((3, 3, 16, 16)),
                         jnp.float32)

    def loss(p, args):
        img = image_plane_prediction(p, predictor, t_frames_M, args)
        return jnp.sum((img - target) ** 2)

    l_d, g_d = jax.value_and_grad(loss)(params, rt)
    l_c, g_c = jax.value_and_grad(loss)(params, crt)
    np.testing.assert_allclose(float(l_c), float(l_d), rtol=1e-4)

    def compare(path, a, b):
        scale = np.abs(np.asarray(a)).max() + 1e-8
        np.testing.assert_allclose(np.asarray(b) / scale,
                                   np.asarray(a) / scale, atol=1e-4,
                                   err_msg=str(path))

    jax.tree_util.tree_map_with_path(compare, g_d, g_c)


def test_grouped_reduction_matches_direct_scatter(setup):
    """The grouped per-pixel reduction (static gather + group sums + 8x
    smaller scatter, custom VJP) must equal the direct segment_sum path
    in both values and input gradients."""
    import dataclasses
    from bhnerf_jax.train.step import _reduce_to_images
    predictor, params, rt, _, t_frames_M = setup
    crt = compact_raytracing_args(rt, predictor, layout='gather')
    assert crt.red_gather is not None
    n = crt.coords.shape[-1]
    em = jnp.asarray(np.random.default_rng(1).random((3, n)), jnp.float32)
    crt_direct = dataclasses.replace(crt, red_gather=None,
                                     red_weights=None, red_group_ids=None)

    grouped = np.asarray(_reduce_to_images(em, crt))
    direct = np.asarray(_reduce_to_images(em, crt_direct))
    scale = np.abs(direct).max() + 1e-12
    np.testing.assert_allclose(grouped / scale, direct / scale, atol=2e-6)

    # linear, nonuniform cotangent: a nonlinear one (e.g. sin) would
    # amplify the legitimate f32 reassociation difference of the two
    # forward sums into the gradients
    cot = jnp.asarray(np.random.default_rng(2).normal(
        size=(3, crt.num_stokes, crt.npix)), jnp.float32)

    def total(e, args):
        img = _reduce_to_images(e, args)
        return jnp.sum(img * cot)

    g_grouped = np.asarray(jax.grad(total)(em, crt))
    g_direct = np.asarray(jax.grad(total)(em, crt_direct))
    gs = np.abs(g_direct).max() + 1e-12
    np.testing.assert_allclose(g_grouped / gs, g_direct / gs, atol=2e-6)


def test_compact_bf16_matches_dense_f32(setup):
    """compute_dtype='bfloat16' (bf16 MLP operands, float32
    accumulation) on the compact path stays within bf16 rounding of the
    float32 dense reference."""
    import dataclasses
    predictor, params, rt, _, t_frames_M = setup
    crt = compact_raytracing_args(rt, predictor)
    ref = np.asarray(image_plane_prediction(params, predictor,
                                            t_frames_M, rt))
    bf16 = dataclasses.replace(predictor, compute_dtype='bfloat16')
    out = np.asarray(image_plane_prediction(params, bf16, t_frames_M, crt))
    scale = np.abs(ref).max()
    np.testing.assert_allclose(out / scale, ref / scale, atol=2e-2)
    assert np.abs(out - ref).max() > 0      # bf16 really engaged


def test_grouped_reduction_fuzz_segment_distributions():
    """Property test: the grouped layout must reproduce direct
    segment_sum for adversarial pixel-id distributions — empty pixels,
    1-sample pixels, one huge segment, all sizes mod G."""
    import dataclasses
    from bhnerf_jax.train.step import (CompactRayArgs, _reduce_to_images,
                                       compact_raytracing_args, _REDUCE_G)
    rng = np.random.default_rng(7)
    npix = 37
    # segment sizes: zeros, ones, every residue mod G, one huge
    sizes = np.zeros(npix, int)
    sizes[1] = 1
    sizes[3:3 + 10] = np.arange(1, 11)
    sizes[20] = 113
    sizes[30:34] = rng.integers(0, 25, 4)
    pixel_ids = np.repeat(np.arange(npix), sizes)
    n_eff = pixel_ids.size
    tile = 64
    n_pad = (n_eff + tile - 1) // tile * tile

    # hand-build a CompactRayArgs with this distribution (2 stokes)
    W = rng.normal(size=(2, n_eff))
    crt = _build_compact_for_test(pixel_ids, W, npix, n_pad, tile)

    em = jnp.asarray(rng.normal(size=(3, n_pad)), jnp.float32)
    got = np.asarray(_reduce_to_images(em, crt))
    direct = np.asarray(_reduce_to_images(
        em, dataclasses.replace(crt, red_gather=None, red_weights=None,
                                red_group_ids=None)))
    scale = np.abs(direct).max() + 1e-12
    np.testing.assert_allclose(got / scale, direct / scale, atol=3e-6)


def _build_compact_for_test(pixel_ids, W, npix, n_pad, tile):
    """Mirror compact_raytracing_args' grouped-layout construction for a
    synthetic (pixel_ids, weights) pair."""
    import jax.numpy as _jnp
    from bhnerf_jax.train.step import CompactRayArgs, _REDUCE_G
    n_eff = pixel_ids.size
    G = _REDUCE_G
    W_pad = np.concatenate(
        [W, np.zeros((W.shape[0], n_pad - n_eff))], axis=1)
    pix_pad = np.concatenate(
        [pixel_ids, np.full(n_pad - n_eff, npix, np.int64)])
    counts = np.bincount(pixel_ids, minlength=npix)
    nz = np.flatnonzero(counts)
    c_nz = counts[nz]
    seg_starts = np.concatenate([[0], np.cumsum(c_nz)])[:-1]
    ng = -(-c_nz // G)
    slots = ng * G
    tot = int(slots.sum())
    pix_of_slot = np.repeat(np.arange(nz.size), slots)
    off = np.concatenate([[0], np.cumsum(slots)])[:-1]
    sl_in = np.arange(tot) - off[pix_of_slot]
    valid = sl_in < c_nz[pix_of_slot]
    red_gather = np.where(valid, seg_starts[pix_of_slot] + sl_in, 0)
    red_w = np.where(valid[None], W_pad[:, red_gather], 0.0)
    red_gid = np.repeat(nz, ng)
    g_pad = (red_gid.size + 7) // 8 * 8 - red_gid.size
    if g_pad:
        red_gather = np.concatenate([red_gather,
                                     np.zeros(g_pad * G, np.int64)])
        red_w = np.concatenate(
            [red_w, np.zeros((red_w.shape[0], g_pad * G))], axis=1)
        red_gid = np.concatenate([red_gid,
                                  np.full(g_pad, npix, np.int64)])
    return CompactRayArgs(
        coords=_jnp.zeros((3, n_pad), _jnp.float32),
        Omega=0.0,
        weights=_jnp.asarray(W_pad, _jnp.float32),
        t_geos_rel=_jnp.zeros((n_pad,), _jnp.float32),
        pixel_ids=_jnp.asarray(pix_pad, _jnp.int32),
        t_injection=_jnp.zeros(()),
        red_gather=_jnp.asarray(red_gather, _jnp.int32),
        red_weights=_jnp.asarray(red_w, _jnp.float32),
        red_group_ids=_jnp.asarray(red_gid, _jnp.int32),
        image_shape=(npix, 1), polarized=True)


def test_native_layout_selection_and_equality(setup):
    """layout='auto' picks 'native' (no gather tables) for multi-Stokes
    weights and 'gather' for unpolarized; both layouts agree with each
    other in images AND parameter gradients, at float32 and bfloat16
    MLP operands."""
    predictor, params, rt, rt_scalar, t_frames_M = setup
    crt_nat = compact_raytracing_args(rt, predictor)
    crt_gat = compact_raytracing_args(rt, predictor, layout='gather')
    assert crt_nat.red_gather is None
    assert crt_nat.red_group_ids is not None
    assert crt_gat.red_gather is not None
    crt_u = compact_raytracing_args(rt_scalar, predictor)
    assert crt_u.red_gather is not None  # unpolarized default: gather
    # native slots are a padded superset of the samples
    assert crt_nat.coords.shape[-1] >= crt_gat.coords.shape[-1]

    import dataclasses

    def loss(params, crt, pred):
        img = image_plane_prediction(params, pred, t_frames_M, crt)
        return jnp.sum(img ** 2)

    for dtype in ('float32', 'bfloat16'):
        pred = dataclasses.replace(predictor, compute_dtype=dtype)
        v_nat, g_nat = jax.value_and_grad(loss)(params, crt_nat, pred)
        v_gat, g_gat = jax.value_and_grad(loss)(params, crt_gat, pred)
        np.testing.assert_allclose(float(v_nat), float(v_gat), rtol=2e-5)
        for k in g_nat:
            np.testing.assert_allclose(
                np.asarray(g_nat[k]['kernel']),
                np.asarray(g_gat[k]['kernel']), rtol=5e-4, atol=5e-7,
                err_msg=f'{k} {dtype}')


def test_native_layout_ensemble_uniform(setup):
    """compact_ensemble_args produces uniformly-shaped native-layout
    variants (pad_groups path)."""
    from bhnerf_jax.train.step import compact_ensemble_args, stack_ensemble
    predictor, params, rt, _, t_frames_M = setup
    import dataclasses
    # perturb weights to mimic distinct sub-pixel variants with
    # different in-domain counts is hard here; just check the API on
    # identical variants
    crt_list = compact_ensemble_args([rt, rt], predictor)
    assert len({c.coords.shape for c in crt_list}) == 1
    stacked = stack_ensemble(crt_list)
    assert stacked.coords.shape[0] == 2


def test_compact_lightcurve_matmul_matches_image_sum(setup):
    """The direct lc = em @ W^T path equals summing the per-pixel images
    (values and parameter gradients), polarized and unpolarized."""
    from bhnerf_jax.train.step import compact_lightcurve
    predictor, params, rt, rt_scalar, t_frames_M = setup
    for rt_i in (rt, rt_scalar):
        crt = compact_raytracing_args(rt_i, predictor)

        def lc_images(params):
            img = image_plane_prediction(params, predictor, t_frames_M,
                                         crt)
            return img.sum(axis=(-1, -2))

        def lc_direct(params):
            return compact_lightcurve(params, predictor, t_frames_M, crt)

        a = np.asarray(lc_images(params))
        b = np.asarray(lc_direct(params))
        scale = np.abs(a).max() + 1e-12
        np.testing.assert_allclose(b / scale, a / scale, atol=2e-5)

        g_a = jax.grad(lambda p: jnp.sum(lc_images(p) ** 2))(params)
        g_b = jax.grad(lambda p: jnp.sum(lc_direct(p) ** 2))(params)
        for k in g_a:
            ga, gb = np.asarray(g_a[k]['kernel']), \
                np.asarray(g_b[k]['kernel'])
            gs = np.abs(ga).max() + 1e-12
            np.testing.assert_allclose(gb / gs, ga / gs, atol=1e-4,
                                       err_msg=k)
