"""XLA compact path vs the dense reference path, at float32 and bfloat16
MLP operands (compute_dtype): forward, gradients, the learnable
injection offset, architecture variants and long movies."""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from bhnerf_jax import units
from bhnerf_jax.geodesics import image_plane_geos
from bhnerf_jax.models import NeRFPredictor
from bhnerf_jax.models.fields import apply_mlp, init_mlp_params
from bhnerf_jax.train import raytracing_args
from bhnerf_jax.train.step import (_compact_emission, compact_lightcurve,
                                   compact_raytracing_args,
                                   image_plane_prediction)

# bf16 operands keep 8 mantissa bits: images within 2% of their peak,
# per-matrix gradient cosine above 0.999 against the float32 reference
BF16_ATOL = 2e-2
BF16_COS = 0.999


@pytest.fixture(scope='module')
def setup():
    fov = 16.0
    geos = image_plane_geos(spin=0.0, inclination=np.deg2rad(60),
                            alpha_range=(-8, 8), beta_range=(-8, 8),
                            ngeo=16, num_alpha=8, num_beta=8, n_fine=1024)
    rt = raytracing_args(geos, geos.keplerian_omega(),
                         -float(geos.r_o + fov / 4),
                         units.Quantity(0.0, 'hr'))
    predictor = NeRFPredictor(scale=8.0, rmin=3.0, rmax=8.0, z_width=2.0,
                              net_depth=4, net_width=32, posenc_deg=3)
    params = predictor.init_params(seed=0)
    # lift the output bias so emission has structure (sigmoid(x - 10)
    # is ~5e-5 at init)
    params['dense_4']['bias'] = params['dense_4']['bias'] + 9.0
    t_frames_M = jnp.asarray([0.0, 40.0, 90.0], jnp.float32)
    return predictor, params, rt, t_frames_M


def _cosine(a, b):
    a, b = np.ravel(a), np.ravel(b)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


@pytest.mark.parametrize('compute_dtype', ['float32', 'bfloat16'])
def test_compact_forward_matches_dense(setup, compute_dtype):
    predictor, params, rt, t_frames_M = setup
    pred = dataclasses.replace(predictor, compute_dtype=compute_dtype)
    ref = np.asarray(image_plane_prediction(params, predictor, t_frames_M,
                                            rt))
    crt = compact_raytracing_args(rt, pred)
    out = np.asarray(image_plane_prediction(params, pred, t_frames_M, crt))
    assert out.shape == ref.shape == (3, 8, 8)
    scale = np.abs(ref).max()
    atol = 2e-6 if compute_dtype == 'float32' else BF16_ATOL
    np.testing.assert_allclose(out / scale, ref / scale, atol=atol)


@pytest.mark.parametrize('compute_dtype', ['float32', 'bfloat16'])
def test_compact_gradients_match_dense(setup, compute_dtype):
    predictor, params, rt, t_frames_M = setup
    pred = dataclasses.replace(predictor, compute_dtype=compute_dtype)
    crt = compact_raytracing_args(rt, pred)
    target = jnp.asarray(np.random.default_rng(0).random((3, 8, 8)),
                         jnp.float32)

    def loss(p, pr, args):
        img = image_plane_prediction(p, pr, t_frames_M, args)
        return jnp.sum((img - target) ** 2)

    l_ref, g_ref = jax.value_and_grad(loss)(params, predictor, rt)
    l_c, g_c = jax.value_and_grad(loss)(params, pred, crt)
    for k in g_ref:
        a = np.asarray(g_ref[k]['kernel'])
        b = np.asarray(g_c[k]['kernel'])
        if compute_dtype == 'float32':
            np.testing.assert_allclose(float(l_c), float(l_ref), rtol=1e-5)
            scale = np.abs(a).max()
            np.testing.assert_allclose(b / scale, a / scale, atol=5e-5,
                                       err_msg=k)
        else:
            np.testing.assert_allclose(float(l_c), float(l_ref), rtol=0.01)
            assert _cosine(a, b) > BF16_COS, (k, _cosine(a, b))


def test_compact_no_skip_depth2(setup):
    """A non-default architecture (no skip, depth 2, width 16)."""
    _, _, rt, t_frames_M = setup
    pred = NeRFPredictor(scale=8.0, rmin=3.0, rmax=8.0, z_width=2.0,
                         net_depth=2, net_width=16, posenc_deg=2,
                         do_skip=False)
    params = pred.init_params(seed=2)
    ref = np.asarray(image_plane_prediction(params, pred, t_frames_M, rt))
    crt = compact_raytracing_args(rt, pred)
    out = np.asarray(image_plane_prediction(params, pred, t_frames_M, crt))
    scale = np.abs(ref).max()
    np.testing.assert_allclose(out / scale, ref / scale, atol=2e-5)


@pytest.mark.parametrize('compute_dtype', ['float32', 'bfloat16'])
def test_compact_learn_injection_grad_matches_dense(setup, compute_dtype):
    """The learnable injection offset's gradient (autodiff through the
    velocity warp) agrees between the compact and the dense path."""
    predictor, _, rt, t_frames_M = setup
    pred = dataclasses.replace(predictor, learn_injection=True)
    params = pred.init_params(seed=1)
    params['dense_4']['bias'] = params['dense_4']['bias'] + 9.0
    params['t_injection'] = jnp.float32(3.0)
    crt = compact_raytracing_args(rt, pred)
    pred_c = dataclasses.replace(pred, compute_dtype=compute_dtype)

    def loss(p, pr, args):
        return jnp.sum(image_plane_prediction(p, pr, t_frames_M, args) ** 2)

    g_ref = float(jax.grad(loss)(params, pred, rt)['t_injection'])
    g_c = float(jax.grad(loss)(params, pred_c, crt)['t_injection'])
    assert abs(g_ref) > 1e-4, 'degenerate test: zero warp gradient'
    rtol = 2e-4 if compute_dtype == 'float32' else 0.05
    np.testing.assert_allclose(g_c, g_ref, rtol=rtol)


def test_compact_many_frames(setup):
    """A full-movie frame count renders and differentiates in one call."""
    predictor, params, rt, _ = setup
    nt = 40
    t_frames_M = jnp.asarray(np.linspace(0.0, 90.0, nt), jnp.float32)
    crt = compact_raytracing_args(rt, predictor)
    ref = np.asarray(image_plane_prediction(params, predictor, t_frames_M,
                                            rt))
    out = np.asarray(image_plane_prediction(params, predictor, t_frames_M,
                                            crt))
    assert out.shape == ref.shape == (nt, 8, 8)
    scale = np.abs(ref).max()
    np.testing.assert_allclose(out / scale, ref / scale, atol=2e-6)

    def loss(p, args):
        return jnp.sum(image_plane_prediction(p, predictor, t_frames_M,
                                              args) ** 2)

    g_c = jax.grad(loss)(params, crt)
    g_ref = jax.grad(loss)(params, rt)
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=5e-4, atol=1e-6),
        g_c, g_ref)


@pytest.mark.parametrize('compute_dtype', ['float32', 'bfloat16'])
def test_compact_lightcurve_matches_dense_sum(setup, compute_dtype):
    """The lightcurve as one em @ W^T matmul equals the dense images
    summed over pixels."""
    predictor, params, rt, t_frames_M = setup
    pred = dataclasses.replace(predictor, compute_dtype=compute_dtype)
    crt = compact_raytracing_args(rt, pred)
    ref = np.asarray(image_plane_prediction(params, predictor, t_frames_M,
                                            rt)).sum(axis=(-1, -2))
    lc = np.asarray(compact_lightcurve(params, pred, t_frames_M, crt))
    assert lc.shape == ref.shape == (3,)
    rtol = 1e-5 if compute_dtype == 'float32' else BF16_ATOL
    np.testing.assert_allclose(lc, ref, rtol=rtol)


def test_apply_mlp_bf16_operands():
    """compute_dtype='bfloat16' rounds every dense layer's operands to
    bf16 and accumulates in float32 — exactly the explicit computation —
    while 'float32' stays plain float32."""
    key = jax.random.PRNGKey(0)
    params = init_mlp_params(key, 21, net_depth=2, net_width=16,
                             do_skip=False)
    x = jax.random.normal(jax.random.PRNGKey(1), (64, 21))

    def manual(h):
        for i in range(2):
            p = params[f'dense_{i}']
            h = jax.nn.relu(jnp.matmul(
                h.astype(jnp.bfloat16), p['kernel'].astype(jnp.bfloat16),
                preferred_element_type=jnp.float32) + p['bias'])
        p = params['dense_2']
        return jnp.matmul(h.astype(jnp.bfloat16),
                          p['kernel'].astype(jnp.bfloat16),
                          preferred_element_type=jnp.float32) + p['bias']

    out = apply_mlp(params, x, net_depth=2, do_skip=False,
                    compute_dtype='bfloat16')
    assert out.dtype == jnp.float32
    np.testing.assert_array_equal(np.asarray(out), np.asarray(manual(x)))
    f32 = apply_mlp(params, x, net_depth=2, do_skip=False)
    assert float(jnp.abs(f32 - out).max()) > 0


def test_compact_emission_padding_rows_are_zero(setup):
    """Compaction pads the sample axis to the tile with never-valid
    samples: their emission is exactly zero at every frame."""
    predictor, params, rt, t_frames_M = setup
    crt = compact_raytracing_args(rt, predictor, tile=256)
    n = crt.coords.shape[-1]
    assert n % 256 == 0
    em = np.asarray(_compact_emission(params, predictor, t_frames_M, crt))
    pad = np.asarray(crt.t_geos_rel) < -1e29
    assert pad.any()
    assert em.shape == (3, n)
    assert (em[:, pad] == 0).all()
