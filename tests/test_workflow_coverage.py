"""Coverage for composite workflows: multi-pol EHT fitting, loss
composition (TrainStep.__add__), optimizer checkpoint-resume, amp/cphase
losses."""
import numpy as np
import pytest

import jax

from bhnerf_jax import constants, emission, observation as obs_lib, units
from bhnerf_jax.geodesics import image_plane_geos
from bhnerf_jax.models import NeRFPredictor
from bhnerf_jax.ops import gr
from bhnerf_jax.train import (Optimizer, TrainState, TrainStep,
                              make_optimizer, raytracing_args,
                              total_movie_loss)

FOV = 16.0


@pytest.fixture(scope='module')
def polarized_problem():
    geos = image_plane_geos(spin=0.0, inclination=np.deg2rad(60),
                            alpha_range=(-FOV / 2, FOV / 2),
                            beta_range=(-FOV / 2, FOV / 2), ngeo=32,
                            num_alpha=16, num_beta=16, n_fine=2048)
    Omega = geos.keplerian_omega()
    umu = gr.azimuthal_velocity_vector(geos, Omega)
    g = gr.doppler_factor(geos, umu)
    b = gr.magnetic_field_fluid_frame(geos, umu, 0, 1, 0)
    J = np.nan_to_num(np.asarray(gr.parallel_transport(
        geos, umu, g, b, Q_frac=0.5, V_frac=0.0)), nan=0.0)
    rt = raytracing_args(geos, Omega, -float(geos.r_o + 4),
                         units.Quantity(4.0, 'hr'), J=J)
    rt_scalar = raytracing_args(geos, Omega, -float(geos.r_o + 4),
                                units.Quantity(4.0, 'hr'))

    hotspot = emission.generate_hotspot(
        (32, 32, 32), [0, 0, 1], 0.0, 6.5, 0.7, 6.0, FOV)
    t_frames = units.Quantity(np.linspace(4.0, 15.5, 8), 'hr')
    movie = np.asarray(emission.image_plane_dynamics(
        hotspot, geos, Omega, t_frames, -float(geos.r_o + 4), J=J,
        t_start_obs=t_frames[0]))  # (nt, 3, na, nb)

    array = obs_lib.load_txt('eht_arrays/EHT2017.txt')
    obs0 = obs_lib.empty_eht_obs(array, nt=8, tint=60.0)
    obs = obs_lib.observe_same(movie, np.asarray(t_frames.value), 1e-10,
                               obs0, thermal_noise=False)
    return dict(rt=rt, rt_scalar=rt_scalar, movie=movie, obs=obs,
                t_frames=t_frames)


def test_multipol_eht_step(polarized_problem):
    """pol=['I','Q','U'] chisqdata + polarized rt: the per-pol DFT
    operators act on the matching Stokes image components."""
    pb = polarized_problem
    predictor = NeRFPredictor(scale=FOV / 2, rmax=FOV / 2, z_width=2.0,
                              net_depth=2, net_width=16)
    step = TrainStep.eht(pb['t_frames'], pb['obs'], 1e-10 * 16, 16,
                         predictor, dtype='vis', pol=['I', 'Q', 'U'])
    state = TrainState.create(predictor.init_params(),
                              make_optimizer(20, lr_init=1e-3))
    loss0, state, images = step(state, pb['rt'], np.arange(4))
    assert np.isfinite(np.asarray(loss0))
    assert np.asarray(images).shape == (4, 3, 16, 16)
    for _ in range(20):
        loss, state, _ = step(state, pb['rt'], np.arange(4))
    assert float(np.asarray(loss)) < float(np.asarray(loss0))


@pytest.mark.parametrize('dtype', ['amp', 'cphase'])
def test_amp_cphase_losses(polarized_problem, dtype):
    pb = polarized_problem
    predictor = NeRFPredictor(scale=FOV / 2, rmax=FOV / 2, z_width=2.0,
                              net_depth=2, net_width=16)
    step = TrainStep.eht(pb['t_frames'], pb['obs'], 1e-10 * 16, 16,
                         predictor, dtype=dtype, pol='I')
    state = TrainState.create(predictor.init_params(),
                              make_optimizer(10, lr_init=1e-3))
    # single-pol measurements pair with unpolarized (scalar-J) images
    loss, state2, _ = step(state, pb['rt_scalar'], np.arange(4))
    assert np.isfinite(np.asarray(loss))
    # gradient actually flows
    leaves0 = jax.tree_util.tree_leaves(state.params)
    leaves1 = jax.tree_util.tree_leaves(state2.params)
    assert any(not np.allclose(a, b) for a, b in zip(leaves0, leaves1))


def test_composed_losses(polarized_problem):
    """TrainStep.__add__ composes lightcurve + EHT losses
    (reference optimization.py:181-187)."""
    pb = polarized_problem
    predictor = NeRFPredictor(scale=FOV / 2, rmax=FOV / 2, z_width=2.0,
                              net_depth=2, net_width=16)
    lc = pb['movie'].sum(axis=(-1, -2))
    step_lc = TrainStep.image(pb['t_frames'], lc, predictor, dtype='lc')
    step_eht = TrainStep.eht(pb['t_frames'], pb['obs'], 1e-10 * 16, 16,
                             predictor, dtype='vis', scale=0.5,
                             pol=['I', 'Q', 'U'])
    combined = step_lc + step_eht
    assert combined.num_losses == 2
    state = TrainState.create(predictor.init_params(),
                              make_optimizer(10, lr_init=1e-3))
    loss, state, images = combined(state, pb['rt'], np.arange(4))
    assert np.isfinite(np.asarray(loss))


def test_optimizer_checkpoint_resume(tmp_path, polarized_problem):
    """Stopping and restarting an Optimizer continues from the saved
    step (reference resume semantics, optimization.py:125)."""
    pb = polarized_problem
    predictor = NeRFPredictor(scale=FOV / 2, rmax=FOV / 2, z_width=2.0,
                              net_depth=2, net_width=16)
    lc = pb['movie'].sum(axis=(-1, -2))
    step = TrainStep.image(pb['t_frames'], lc, predictor, dtype='lc')
    ckpt = str(tmp_path / 'run')

    opt1 = Optimizer({'num_iters': 10, 'lr_init': 1e-3}, predictor,
                     pb['rt'], checkpoint_dir=ckpt, save_period=5)
    opt1.run(4, step, pb['rt'], verbose=False)
    step1 = int(np.asarray(jax.device_get(opt1.state.step)))
    assert step1 == 10

    opt2 = Optimizer({'num_iters': 5, 'lr_init': 1e-3}, predictor,
                     pb['rt'], checkpoint_dir=ckpt, save_period=5)
    assert int(np.asarray(jax.device_get(opt2.state.step))) >= 5
    opt2.run(4, step, pb['rt'], verbose=False)
    assert int(np.asarray(jax.device_get(opt2.state.step))) > step1 - 5
