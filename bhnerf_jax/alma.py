"""ALMA polarized-lightcurve workflow.

Rebuild of reference bhnerf/alma.py:1-118: data preprocessing for the
Apr-11-2017 Sgr A* flare, the polarized image-plane model (Keplerian flow
+ fluid-frame B field + parallel transport), sub-pixel ray ensembles, and
chi-square checkpoint-grid scans.
"""
from __future__ import annotations

import os

import numpy as np

import bhnerf_jax as bh
from bhnerf_jax import constants, emission, units
from bhnerf_jax.geodesics import image_plane_geos
from bhnerf_jax.ops import gr
from bhnerf_jax.train import step as step_lib


def preprocess_data(data_path, window_size, I_hs_mean, P_sha, chi_sha,
                    de_rot_angle, t_start=9.33, t_end=11.05):
    """Load + window-average the ALMA lightcurve CSV, subtract the constant
    shadow polarization, de-rotate Faraday rotation, prepend the intensity
    prior (reference alma.py:9-25)."""
    import pandas as pd
    alma_lc = pd.read_csv(data_path, index_col=0)
    loops = alma_lc.loc[np.bitwise_and(alma_lc['time'] >= t_start,
                                       alma_lc['time'] <= t_end)]
    means = loops.rolling(window_size).mean().loc[::window_size].dropna()
    # drop points averaged across scan gaps
    means = means.where(
        means['time'].diff().fillna(0.0) < 160 / 3600).dropna()
    t_frames = units.Quantity(means['time'].values, 'hr')

    qu_sha = P_sha * np.array([np.cos(2 * np.deg2rad(chi_sha)),
                               np.sin(2 * np.deg2rad(chi_sha))])
    target = emission.rotate_evpa(
        np.array(means[['Q', 'U']]) - qu_sha, np.deg2rad(de_rot_angle),
        axis=1)
    target = np.pad(np.asarray(target), ([0, 0], [1, 0]),
                    constant_values=I_hs_mean)
    return target, t_frames


def image_plane_model(inc, spin, params, rot_angle=0.0,
                      randomize_subpixel_rays=False, rng=None,
                      backend='cpu', mesh=None):
    """Geodesics + Keplerian velocity + normalized fluid-frame B field +
    polarized transport factors (reference alma.py:27-63).

    backend='device' traces the geodesics on the accelerator in float32
    (geodesics.trace_geodesics) — the chi^2 grid scans re-trace per grid
    point and per sub-pixel variant (measured ~10x per table vs the f64
    host trace even on CPU; see trace_geodesics)."""
    num_alpha, num_beta = params['num_alpha'], params['num_beta']
    fov_M = params['fov_M']

    geos = image_plane_geos(
        spin, inc, num_alpha=num_alpha, num_beta=num_beta,
        alpha_range=[-fov_M / 2, fov_M / 2],
        beta_range=[-fov_M / 2, fov_M / 2],
        randomize_subpixel_rays=randomize_subpixel_rays, rng=rng,
        backend=backend, mesh=mesh)
    return _model_physics(geos, params, rot_angle)


def _model_physics(geos, params, rot_angle):
    """Velocity + B-field + transport factors for an already-traced
    image plane (the non-trace half of image_plane_model)."""
    rot_sign = {'cw': -1, 'ccw': 1}
    fov_M, z_width = params['fov_M'], params['z_width']
    Q_frac, b_consts = params['Q_frac'], params['b_consts']
    Omega_dir = params['Omega_dir']
    rmin = (float(constants.isco_pro(geos.spin))
            if params['rmin'] == 'ISCO' else params['rmin'])
    rmax = fov_M / 2

    Omega_frac = params.get('Omega_frac', 1.0)
    Omega = geos.keplerian_omega(direction=rot_sign[Omega_dir],
                                 frac=Omega_frac)
    umu = gr.azimuthal_velocity_vector(geos, Omega)
    g = gr.doppler_factor(geos, umu)

    # B field magnitude-normalized over the supervised domain
    b = np.asarray(gr.magnetic_field_fluid_frame(geos, umu, **b_consts))
    domain = ((np.abs(geos.z) < z_width) & (geos.r > rmin)
              & (geos.r < rmax))
    b_mean = np.nanmean(np.sqrt(np.sum(b[domain] ** 2, axis=-1)))
    b = b / b_mean

    J = np.nan_to_num(np.asarray(gr.parallel_transport(
        geos, umu, g, b, Q_frac=Q_frac, V_frac=0)), nan=0.0)
    J = np.asarray(emission.rotate_evpa(J, rot_angle))
    return geos, Omega, J


def _trace_subpixel_ensemble(inc, spin, params, num_variants, rng,
                             backend, mesh=None):
    """Trace ALL sub-pixel-ray variants in ONE trace_geodesics call
    (stacked (V, na, nb) screen grids -> one device dispatch instead of
    V), then split back into per-variant Geodesics. Randomization
    semantics match image_plane_geos (per-axis uniform jitter within a
    pixel, same rng consumption order)."""
    import dataclasses

    from bhnerf_jax.geodesics import trace_geodesics
    from bhnerf_jax.geodesics.dataset import (Geodesics,
                                              subpixel_jittered_axes)

    num_alpha, num_beta = params['num_alpha'], params['num_beta']
    fov_M = params['fov_M']
    rng = np.random.default_rng() if rng is None else rng
    ranges = ((-fov_M / 2, fov_M / 2), (-fov_M / 2, fov_M / 2))

    alphas, betas = [], []
    for _ in range(num_variants):
        a1, b1 = subpixel_jittered_axes(*ranges, num_alpha, num_beta, rng)
        a, b = np.meshgrid(a1, b1, indexing='ij')
        alphas.append(a)
        betas.append(b)

    geos_all = trace_geodesics(np.stack(alphas), np.stack(betas), spin,
                               inc, backend=backend, mesh=mesh)
    return [dataclasses.replace(
        geos_all, **{f: getattr(geos_all, f)[v]
                     for f in Geodesics._FIELDS})
        for v in range(num_variants)]


def get_raytracing_args(inc, spin, params, stokes=('I', 'Q', 'U'),
                        rot_angle=0.0, num_subpixel_rays=1, rng=None,
                        backend='cpu', mesh=None):
    """Sub-pixel ray ensemble of RayTracingArgs (reference alma.py:65-81).

    With backend='device' the whole ensemble is traced in a single
    device dispatch (the per-variant loop otherwise pays one trace per
    variant); mesh= additionally shards the pixel axis across the
    device mesh (rays are independent — zero collectives)."""
    args_list = []
    J_inds = [['I', 'Q', 'U'].index(s) for s in stokes]
    randomize = num_subpixel_rays > 1
    geos_list = (_trace_subpixel_ensemble(inc, spin, params,
                                          num_subpixel_rays, rng, backend,
                                          mesh=mesh)
                 if backend == 'device' and randomize else None)
    for i in range(num_subpixel_rays):
        if geos_list is None:
            geos, Omega, J = image_plane_model(inc, spin, params,
                                               rot_angle, randomize,
                                               rng=rng, backend=backend,
                                               mesh=mesh)
        else:
            geos, Omega, J = _model_physics(geos_list[i], params,
                                            rot_angle)
        t_injection = -float(geos.r_o + params['fov_M'] / 4)
        args = step_lib.raytracing_args(
            geos, Omega, t_injection,
            units.Quantity(params['t_start_obs'], 'hr'), J[J_inds])
        args_list.append(args)
    return args_list


def image_plane_checkpoint(raytracing_args, checkpoint_dir, t, rmin=0.0,
                           rmax=np.inf, batchsize=20):
    """Re-render the image-plane movie from a checkpoint
    (reference network.py:896-906)."""
    import dataclasses

    from bhnerf_jax.models import NeRFPredictor
    from bhnerf_jax.train import (TrainState, TrainStep, make_optimizer,
                                  restore_checkpoint, total_movie_loss)

    predictor = NeRFPredictor.from_yml(checkpoint_dir)
    predictor = dataclasses.replace(
        predictor, rmax=min(rmax, predictor.rmax),
        rmin=max(rmin, predictor.rmin))
    params = predictor.init_params()
    state = TrainState.create(params, make_optimizer(10))
    state = restore_checkpoint(checkpoint_dir, state)

    # evaluate over the FULL sub-pixel-ray ensemble: test-mode TrainStep
    # averages all variants (reference network.py:905 passes the whole
    # raytracing_args list into total_movie_loss)
    rt_list = list(np.atleast_1d(raytracing_args))
    num_stokes = rt_list[0].num_stokes
    train_step = TrainStep.image(t, np.zeros((len(t), num_stokes)),
                                 predictor, dtype='lc')
    _, image_plane = total_movie_loss(batchsize, state, train_step, rt_list,
                                      return_frames=True)
    return image_plane


def chi2_lightcurves(raytracing_args, checkpoint_dir, t, data, sigma=1.0,
                     rmin=0.0, rmax=np.inf, batchsize=20):
    """Lightcurve chi^2 of a trained checkpoint (reference alma.py:83-86)."""
    image_plane = image_plane_checkpoint(raytracing_args, checkpoint_dir,
                                         t, rmin, rmax, batchsize)
    chi2 = np.sum(((image_plane.sum(axis=(-1, -2)) - np.asarray(data))
                   / sigma) ** 2) / len(t)
    return chi2


def chi2_df(inclinations, spins, seeds, params, checkpoint_fmt, t, data,
            stokes=('I', 'Q', 'U'), sigma=1.0, rot_angle=0.0,
            num_subpixel_rays=1, checkpoint_name='checkpoint_50000',
            backend='cpu', mesh=None):
    """chi^2(inclination-or-spin x seed) DataFrame over a checkpoint grid
    (reference alma.py:88-117). backend='device' traces each grid
    point's geodesic tables on the accelerator (float32) instead of the
    host — the dominant cost of a fresh scan; mesh= shards each trace's
    pixel axis across the device mesh (trace_geodesics)."""
    import pandas as pd

    inclinations = np.atleast_1d(inclinations)
    spins = np.atleast_1d(spins)
    if len(inclinations) == 1 and len(spins) > 1:
        indices, index_name = spins, 'spin'
        # np.full (not full_like): full_like inherits the grid dtype and
        # truncates a fractional scalar against an integer grid
        inclinations = np.full(len(spins), float(inclinations[0]))
    elif len(inclinations) >= 1 and len(spins) == 1:
        indices, index_name = inclinations, 'inc'
        spins = np.full(len(inclinations), float(spins[0]))
    else:
        raise ValueError('only 1D grids (inc or spin) are supported')

    inc_prev = spin_prev = np.nan
    rt_args = None
    data_fit = np.full((len(indices), len(seeds)), np.nan)
    for i, (inc, spin) in enumerate(zip(inclinations, spins)):
        for j, seed in enumerate(seeds):
            checkpoint_dir = checkpoint_fmt.format(indices[i], seed)
            if os.path.exists(os.path.join(checkpoint_dir,
                                           checkpoint_name)):
                if (inc_prev != inc) or (spin_prev != spin):
                    rt_args = get_raytracing_args(
                        np.deg2rad(inc), spin, params, stokes, rot_angle,
                        num_subpixel_rays, backend=backend, mesh=mesh)
                    inc_prev, spin_prev = inc, spin
                data_fit[i, j] = chi2_lightcurves(
                    rt_args, checkpoint_dir, t, data, sigma)

    df = pd.DataFrame(data_fit, index=indices,
                      columns=[f'seed {s}' for s in seeds])
    df.index.name = index_name
    return df
