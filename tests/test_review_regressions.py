"""Regression tests for code-review findings (round 1)."""
import numpy as np
import pytest

import jax

from bhnerf_jax import emission, observation as obs_lib, units, utils


def test_2d_hotspot_field():
    """Grid3D must support 2D fields (generate_hotspot 2D branch)."""
    hs = emission.generate_hotspot((32, 32), [0, 0, 1], 0.3, 6.5, 0.8,
                                   6.0, 20.0)
    assert hs.data.shape == (32, 32)
    total = float(np.asarray(hs.integrate()))
    assert abs(total - 1.0) < 1e-5  # normalized
    assert len(hs.meshgrid()) == 2


def test_chisqdata_single_frame_keeps_nt_axis():
    array = obs_lib.load_txt('eht_arrays/EHT2017.txt')
    obs0 = obs_lib.empty_eht_obs(array, nt=4, tint=60.0)
    movie = np.zeros((1, 16, 16))
    movie[:, 8, 8] = 1.0
    obs = obs_lib.observe_same(movie, np.array([8.0]), 1e-10, obs0,
                               thermal_noise=False)
    target, sigma, A = obs.chisqdata(units.Quantity([8.0], 'hr'), 'vis',
                                     1.6e-9, 16)
    assert target.ndim == 2 and target.shape[0] == 1
    assert A.ndim == 3 and A.shape[0] == 1


def test_total_movie_loss_exact_tail():
    """Ragged nt % batchsize tail must contribute its exact loss."""
    from bhnerf_jax import constants
    from bhnerf_jax.geodesics import image_plane_geos
    from bhnerf_jax.models import NeRFPredictor
    from bhnerf_jax.train import (TrainState, TrainStep, make_optimizer,
                                  raytracing_args, total_movie_loss)

    geos = image_plane_geos(0.0, np.deg2rad(60), (-8, 8), (-8, 8),
                            ngeo=16, num_alpha=8, num_beta=8, n_fine=1024)
    rt = raytracing_args(geos, geos.keplerian_omega(),
                         -float(geos.r_o + 4), units.Quantity(0.0, 'hr'))
    predictor = NeRFPredictor(scale=8.0, rmax=8.0, z_width=2.0,
                              net_depth=2, net_width=16)
    state = TrainState.create(predictor.init_params(), make_optimizer(10))
    nt = 13
    t_frames = units.Quantity(np.linspace(0, 0.3, nt), 'hr')
    # strongly frame-dependent target so tail bias would show
    target = np.linspace(0, 5, nt)[:, None, None] * np.ones((nt, 8, 8))
    step = TrainStep.image(t_frames, target, predictor, dtype='full')

    loss_batched = total_movie_loss(5, state, step, rt)
    loss_exact = total_movie_loss(nt, state, step, rt)
    np.testing.assert_allclose(loss_batched, loss_exact, rtol=1e-5)


def test_grf_statistics():
    key = jax.random.PRNGKey(0)
    f = np.asarray(utils.gaussian_random_field(key, (64, 64), slope=3.0))
    assert abs(f.std() - 1.0) < 1e-3
    # real/imag noise must differ: the field should not be point-symmetric
    corr = np.corrcoef(f.ravel(), np.flip(f).ravel())[0, 1]
    assert abs(corr) < 0.9
    # temporal AR(1) correlation between consecutive movie frames
    m = np.asarray(utils.gaussian_random_field(key, (6, 32, 32),
                                               temporal_corr=0.95))
    cc = [np.corrcoef(m[i].ravel(), m[i + 1].ravel())[0, 1]
          for i in range(5)]
    assert np.mean(cc) > 0.7
    m0 = np.asarray(utils.gaussian_random_field(key, (6, 32, 32),
                                                temporal_corr=0.0))
    cc0 = [np.corrcoef(m0[i].ravel(), m0[i + 1].ravel())[0, 1]
           for i in range(5)]
    assert np.mean(cc0) < 0.3


def test_cphase_padded_triangles_no_nan_grad():
    """Ragged triangle counts pad rows with A=0, sigma=inf; the cphase
    gradient must stay finite (arctan2 at the origin has a NaN vjp)."""
    import jax.numpy as jnp
    from bhnerf_jax.geodesics import image_plane_geos
    from bhnerf_jax.models import NeRFPredictor
    from bhnerf_jax.train import raytracing_args
    from bhnerf_jax.train.step import loss_fn_eht

    geos = image_plane_geos(0.0, np.deg2rad(60), (-8, 8), (-8, 8),
                            ngeo=16, num_alpha=8, num_beta=8, n_fine=512)
    rt = raytracing_args(geos, geos.keplerian_omega(),
                         -float(geos.r_o + 4), units.Quantity(0.0, 'hr'))
    predictor = NeRFPredictor(scale=8.0, rmax=8.0, z_width=2.0,
                              net_depth=2, net_width=16)
    params = predictor.init_params()

    nt, ntri, npix2 = 2, 3, 64
    A = np.zeros((nt, 3, 2, ntri, npix2), np.float32)
    A[..., :2, :] = 1.0  # two real triangles; the last row stays padded
    target = np.zeros((nt, ntri), np.float32)
    sigma = np.where(np.arange(ntri) < 2, 1.0, np.inf).astype(np.float32)
    sigma = np.broadcast_to(sigma, (nt, ntri)).copy()
    t_frames_M = jnp.asarray([0.0, 50.0], jnp.float32)

    def loss(p):
        val, _ = loss_fn_eht(p, predictor, jnp.asarray(target),
                             jnp.asarray(sigma), jnp.asarray(A),
                             t_frames_M, rt, 1.0, 'cphase')
        return val

    val, grads = jax.value_and_grad(loss)(params)
    assert np.isfinite(float(val))
    for leaf in jax.tree_util.tree_leaves(grads):
        assert np.isfinite(np.asarray(leaf)).all()


def test_rho_of_req_unreachable_returns_nan():
    from bhnerf_jax.geodesics import equatorial
    _, rho = equatorial.rho_of_req(0.0, np.deg2rad(20), req=50.0,
                                   mbar=0, varphis=np.array([0.0]),
                                   rho_max=10.0, ngeo=200)
    assert np.isnan(rho).all()


def test_step_fns_cached():
    from bhnerf_jax.models import NeRFPredictor
    from bhnerf_jax.train.step import make_step_fns
    p1 = NeRFPredictor(net_depth=2, net_width=16)
    p2 = NeRFPredictor(net_depth=2, net_width=16)
    a = make_step_fns(p1, 'image', 'lc')
    b = make_step_fns(p2, 'image', 'lc')
    assert a[0] is b[0]  # identical configs share jit caches


def test_warp_adopts_quantity_unit_with_plain_start():
    """Quantity t_frames + plain-float t_start_obs must not silently
    drop the time unit (0.1 hr read as 0.1 M renders a frozen movie)."""
    import jax.numpy as jnp
    from bhnerf_jax import emission, units
    coords = jnp.asarray(np.array([[3.0], [0.0], [0.0]]))
    kw = dict(coords=coords, Omega=0.05, t_geos=0.0, t_injection=-10.0,
              return_mask=True)
    w_mixed, _ = emission.velocity_warp_coords(
        t_frames=units.Quantity(10.1, 'hr'), t_start_obs=10.0, **kw)
    w_united, _ = emission.velocity_warp_coords(
        t_frames=units.Quantity(10.1, 'hr'),
        t_start_obs=units.Quantity(10.0, 'hr'), **kw)
    np.testing.assert_allclose(np.asarray(w_mixed), np.asarray(w_united),
                               rtol=1e-6)


def test_config_tolerates_empty_yaml_sections():
    """A bare 'model:' header parses as None; from_dict must treat it
    as all-defaults instead of crashing."""
    from bhnerf_jax.config import RunConfig
    cfg = RunConfig.from_dict({'model': None, 'optimization': None,
                               'preprocess': None})
    assert cfg.model is not None
    cfg2 = RunConfig.from_dict({'optimization': {'hparams': None}})
    assert cfg2.optimization.hparams is not None


def test_generate_tube_rejects_empty_range():
    from bhnerf_jax import emission
    with pytest.raises(ValueError, match='empty tube range'):
        emission.generate_tube((8, 8, 8), [0, 0, 1], phi_start=5.5,
                               phi_end=0.5, orbit_radius=6.0, std=0.5,
                               r_isco=6.0, fov=16.0)


def test_rotation_axis_degenerate_poles_finite():
    from bhnerf_jax import utils
    for theta in (0.0, np.pi):
        axis, _ = utils.spherical_coords_to_rotation_axis(theta, 0.3)
        assert np.isfinite(axis).all(), (theta, axis)


def test_image_plane_dynamics_movie_length_mismatch_raises():
    from bhnerf_jax import emission, utils
    from bhnerf_jax.geodesics import trace_geodesics
    b = np.linspace(3, 8, 4)
    geos = trace_geodesics(b, np.zeros_like(b), 0.0, np.deg2rad(60),
                           ngeo=16, n_fine=512)
    movie = utils.Grid3D(np.zeros((3, 8, 8, 8)), (-8.0,) * 3, (8.0,) * 3)
    with pytest.raises(ValueError, match='movie emission'):
        emission.image_plane_dynamics(movie, geos, 0.05,
                                      np.array([0.0, 1.0]), -10.0)


def test_sample_3d_grid_ignores_learned_injection_offset():
    """The canonical-frame volume must not be masked out by a positive
    trained injection offset (valid = t - t_inj >= 0 at t = 0)."""
    import jax.numpy as jnp
    from bhnerf_jax.models import NeRFPredictor, sample_3d_grid
    pred = NeRFPredictor(scale=8.0, net_width=16, net_depth=2,
                         learn_injection=True)
    params = pred.init_params(seed=0)
    params['t_injection'] = jnp.float32(0.5)
    vol = sample_3d_grid(pred, params, fov=16.0, resolution=8)
    assert np.asarray(vol).max() > 0.0, 'volume masked to zero'


def test_quantity_reflected_numpy_ops_keep_unit():
    """numpy left operands must not strip the unit (ndarray - Quantity
    was returning a raw array, laundering hours into M units)."""
    from bhnerf_jax import units
    q = units.Quantity(30.0, 'min')
    for left in (np.float64(1.0), np.array([1.0, 2.0])):
        out = left - q
        assert isinstance(out, units.Quantity), type(out)
        assert out.unit == units.Unit('min')
    with pytest.raises(TypeError):
        np.subtract(np.float64(1.0), q)  # direct ufunc fails loudly


def test_tv_reg_accepts_component_leading_coords():
    """tv_reg must treat the codebase-standard (3, N) layout the same as
    (N, 3) instead of interleaving components into fake points."""
    from bhnerf_jax import network
    from bhnerf_jax.models import NeRFPredictor
    pred = NeRFPredictor(scale=8.0, net_width=16, net_depth=2)
    params = pred.init_params(seed=0)
    pts = np.random.default_rng(0).uniform(-4, 4, (17, 3))
    a = float(network.tv_reg(pred, params, pts))
    b = float(network.tv_reg(pred, params, pts.T))
    np.testing.assert_allclose(a, b, rtol=1e-6)
