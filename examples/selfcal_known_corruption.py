"""Self-calibration against known station corruption.

The reference's ehtim `observe_same` writes a *caltable* of the gains it
drew (reference observation.py:121,133), so experiments can calibrate
the corruption back out and fit "as if" the array were ideal. This
example closes the same loop natively:

1. synthesize an orbiting-hotspot movie and observe it with the EHT2017
   array, applying station gain errors, D-term leakage and uncalibrated
   field rotation (`observe_same(station_noise=True, dterm_noise=True,
   frcal=False)`);
2. read the ground-truth tables off the returned observation
   (`obs.applied_jones` — gains (nscan, nstation), D-terms, feed
   angles);
3. calibrate fully (`obs.calibrate()`) and partially
   (`calibrate(gains=False)`: known D-terms + feed rotation only, the
   ehtim inv_jones workflow) and compare visibility residuals;
4. fit the emission on the corrupted vs the calibrated data and show
   the chi^2 gap.

Run:  python examples/selfcal_known_corruption.py [--small]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..'))

import numpy as np


def main(out_dir='example_outputs', small=False):
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt

    from bhnerf_jax import constants, emission, observation, units
    from bhnerf_jax.geodesics import image_plane_geos
    from bhnerf_jax.models import NeRFPredictor
    from bhnerf_jax.train import (TrainState, TrainStep, make_optimizer,
                                  raytracing_args)

    os.makedirs(out_dir, exist_ok=True)
    spin, inc = 0.2, np.deg2rad(60.0)
    fov_M = 16.0
    num = 16 if small else 32
    ngeo = 24 if small else 64
    nt = 8 if small else 16
    num_iters = 150 if small else 1000

    geos = image_plane_geos(spin, inc, (-fov_M / 2, fov_M / 2),
                            (-fov_M / 2, fov_M / 2), ngeo=ngeo,
                            num_alpha=num, num_beta=num)
    Omega = geos.keplerian_omega()
    r_isco = float(constants.isco_pro(spin))
    hotspot = emission.generate_hotspot(
        resolution=(32, 32, 32), rot_axis=[0, 0, 1], rot_angle=0.0,
        orbit_radius=1.2 * r_isco, std=0.7, r_isco=r_isco, fov=fov_M)
    t_frames = units.Quantity(np.linspace(4.0, 15.5, nt), 'hr')
    t_injection = -float(geos.r_o + fov_M / 4)
    movie_I = np.asarray(emission.image_plane_dynamics(
        hotspot, geos, Omega, t_frames, t_injection,
        t_start_obs=t_frames[0]))
    # full-Stokes container (30% linear polarization): D-term leakage
    # moves power between RR/LL and RL/LR — an I-only observation would
    # truncate the leaked cross-hands and no calibration could be exact
    movie = np.stack([movie_I, 0.3 * movie_I, 0.1 * movie_I,
                      np.zeros_like(movie_I)], axis=1)

    array = observation.load_txt('eht_arrays/EHT2017.txt')
    obs_empty = observation.empty_eht_obs(array, nt=nt, tint=60.0)
    fov_rad = float(fov_M * constants.GM_c2(constants.sgra_mass).value
                    / constants.sgra_distance.to('m').value)
    psize = fov_rad / num

    # ideal (thermal-noise-free) reference + fully corrupted observation
    obs_ideal = observation.observe_same(
        movie, np.asarray(t_frames.value), psize, obs_empty,
        thermal_noise=False)
    obs_corr = observation.observe_same(
        movie, np.asarray(t_frames.value), psize, obs_empty,
        thermal_noise=False, station_noise=True, dterm_noise=True,
        frcal=False, seed=7)
    aj = obs_corr.applied_jones
    print(f'recorded corruption: gains {aj.g_R.shape}, D-terms '
          f'{aj.d_R.shape}, field angles '
          f'{"yes" if aj.phi is not None else "no"}')

    m = obs_corr.mask
    ref = obs_ideal.vis[m]

    def vis_err(o):
        return np.nanmedian(np.abs(o.vis[m] - ref) / (np.abs(ref) + 1e-9))

    obs_cal = obs_corr.calibrate()                      # full truth tables
    obs_part = obs_corr.calibrate(gains=False)          # D-terms + feeds
    print(f'median |vis error| / |vis|: corrupted {vis_err(obs_corr):.3f}'
          f' -> D+feed calibrated {vis_err(obs_part):.3f}'
          f' -> fully calibrated {vis_err(obs_cal):.2e}')
    assert vis_err(obs_cal) < 1e-9, 'truth-table calibration must be exact'

    # fit the emission on corrupted vs calibrated data
    predictor = NeRFPredictor(scale=fov_M / 2, rmin=r_isco,
                              rmax=fov_M / 2, z_width=2.0,
                              net_depth=2, net_width=32)
    rt = raytracing_args(geos, Omega, t_injection, t_frames[0])
    chi2 = {}
    for name, o in (('corrupted', obs_corr), ('calibrated', obs_cal)):
        ts = TrainStep.eht(t_frames, o, fov_rad, num, predictor,
                           dtype='vis')
        state = TrainState.create(predictor.init_params(seed=1),
                                  make_optimizer(num_iters, lr_init=1e-3))
        losses = []
        for i in range(num_iters):
            inds = ts.args[0].sample(min(6, nt))
            loss, state, _ = ts(state, rt, inds)
            losses.append(float(np.asarray(loss)))
        chi2[name] = losses
        print(f'{name}: final loss {losses[-1]:.1f}')

    fig, axes = plt.subplots(1, 2, figsize=(9, 3.5))
    axes[0].hist(np.abs(obs_corr.vis[m] - ref).ravel(), bins=40,
                 alpha=0.6, label='corrupted')
    axes[0].hist(np.abs(obs_cal.vis[m] - ref).ravel(), bins=40,
                 alpha=0.6, label='calibrated')
    axes[0].set_yscale('log')
    axes[0].set_xlabel('|vis residual| [Jy]')
    axes[0].legend()
    for name, losses in chi2.items():
        axes[1].semilogy(losses, label=name)
    axes[1].set_xlabel('iteration')
    axes[1].set_ylabel('vis chi^2')
    axes[1].legend()
    fig.tight_layout()
    fig.savefig(os.path.join(out_dir, 'selfcal_known_corruption.png'),
                dpi=120)
    print('wrote', out_dir)


if __name__ == '__main__':
    p = argparse.ArgumentParser()
    p.add_argument('--out', default='example_outputs')
    p.add_argument('--small', action='store_true')
    args = p.parse_args()
    main(args.out, args.small)
