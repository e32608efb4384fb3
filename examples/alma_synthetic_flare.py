"""ALMA polarized-flare workflow on synthetic Apr-11-like data.

End-to-end equivalent of the reference "ALMA lightcurves 0/1" notebooks
without the proprietary Apr11_HI.dat file: synthesize an ALMA-format
lightcurve CSV from an orbiting hotspot (4s cadence, shadow
polarization, Faraday rotation), run the full preprocessing + fitting +
chi-square inclination scan of bhnerf_jax.alma.

Run:  python examples/alma_synthetic_flare.py [--small]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..'))

import numpy as np


def synthesize_alma_csv(path, inc_true=60.0, t_start=9.33, t_end=11.0,
                        cadence_s=4.0, P_sha=0.16, chi_sha=-37.0,
                        faraday_deg=32.2, seed=0, num=24, rot_angle=0.0):
    """Render a polarized hotspot lightcurve and dress it up like the
    ALMA data product (shadow polarization + Faraday rotation + noise)."""
    import pandas as pd

    from bhnerf_jax import alma, emission, units

    model_params = {
        'spin': 0.0, 'fov_M': 40.0, 'z_width': 4.0, 'rmin': 'ISCO',
        'Q_frac': 0.85, 'b_consts': {'arad': 0, 'avert': 1, 'ator': 0},
        'Omega_dir': 'cw', 'Omega_frac': 1.0,
        'num_alpha': num, 'num_beta': num, 't_start_obs': t_start,
    }
    # the same EVPA model rotation the fit below uses: data and model
    # must share the Q/U frame or the chi^2 scan is systematically skewed
    geos, Omega, J = alma.image_plane_model(np.deg2rad(inc_true), 0.0,
                                            model_params,
                                            rot_angle=rot_angle)
    hotspot = emission.generate_hotspot((48,) * 3, [0, 0, 1], 0.0, 9.0,
                                        1.2, 6.0, 40.0)
    t = np.arange(t_start, t_end, cadence_s / 3600.0)
    t_frames = units.Quantity(t, 'hr')
    # chunk the ~1500-frame render: one call materializes (nt, na, nb,
    # ngeo) warp tensors (~5 GB at 32x32) and exhausts device memory
    movie = np.concatenate([
        np.asarray(emission.image_plane_dynamics(
            hotspot, geos, Omega, units.Quantity(t[i:i + 64], 'hr'),
            t_injection=-float(geos.r_o + 10.0), J=J,
            t_start_obs=t_frames[0]))
        for i in range(0, len(t), 64)])
    movie = np.asarray(emission.normalize_stokes(movie, 2.4, 0.1))
    lc = movie.sum(axis=(-1, -2))

    # undo the preprocessing transforms so preprocess_data recovers them:
    # re-rotate Faraday, add shadow polarization, add noise
    qu = np.asarray(emission.rotate_evpa(lc[:, 1:3],
                                         -np.deg2rad(faraday_deg), axis=1))
    qu_sha = P_sha * np.array([np.cos(2 * np.deg2rad(chi_sha)),
                               np.sin(2 * np.deg2rad(chi_sha))])
    rng = np.random.default_rng(seed)
    qu = qu + qu_sha + rng.normal(0, 2e-3, qu.shape)
    pd.DataFrame({'time': t, 'I': lc[:, 0], 'Q': qu[:, 0],
                  'U': qu[:, 1]}).to_csv(path)
    return model_params


def main(out_dir='example_outputs', small=False):
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt

    from bhnerf_jax import alma, units
    from bhnerf_jax.models import NeRFPredictor
    from bhnerf_jax.train import (TrainState, TrainStep, make_optimizer,
                                  save_checkpoint)

    os.makedirs(out_dir, exist_ok=True)
    csv = os.path.join(out_dir, 'alma_synthetic.csv')
    # --small must fit the 1200 s smoke budget on the 1-core CPU box:
    # the per-step fit loop and the 2-inclination chi2 scan dominate, so
    # shrink iterations AND the fit window (fewer scans -> cheaper fit
    # batches and chi2 renders). The scan still picks the true 60 deg.
    num = 16 if small else 32
    iters = 250 if small else 1000
    rot_angle = np.deg2rad(32.2 + 20.0)
    model_params = synthesize_alma_csv(csv, num=num, rot_angle=rot_angle)

    # 1. preprocessing (window average, shadow subtraction, de-rotation)
    target, t_frames = alma.preprocess_data(
        csv, window_size=8, I_hs_mean=0.3, P_sha=0.16, chi_sha=-37.0,
        de_rot_angle=32.2, t_start=9.33, t_end=10.4 if small else 11.0)
    print(f'preprocessed: {target.shape[0]} scans, stokes I/Q/U')

    # 2. fit at a few inclinations, score with chi2
    predictor = NeRFPredictor(scale=20.0, rmin=6.0, rmax=20.0, z_width=4.0,
                              net_depth=3, net_width=64)
    sigma = np.array([0.15, 1e-2, 1e-2])
    chi2 = {}
    inclinations = [30.0, 60.0] if small else [20.0, 40.0, 60.0, 80.0]
    for inc in inclinations:
        rt_args = alma.get_raytracing_args(np.deg2rad(inc), 0.0,
                                           model_params,
                                           rot_angle=rot_angle)
        step = TrainStep.image(t_frames, target, predictor, sigma=sigma,
                               dtype='lc')
        state = TrainState.create(predictor.init_params(seed=1),
                                  make_optimizer(iters, lr_init=2e-3))
        np.random.seed(0)
        for _ in range(iters):
            inds = step.args[0].sample(min(6, len(target)))
            loss, state, _ = step(state, rt_args[0], inds)
        ckpt = os.path.join(out_dir, f'alma_inc{inc:.0f}')
        predictor.save_params(ckpt)
        save_checkpoint(ckpt, state, iters)
        chi2[inc] = alma.chi2_lightcurves(rt_args, ckpt, t_frames, target,
                                          sigma=sigma, batchsize=6)
        print(f'inc {inc:.0f} deg: chi2 = {chi2[inc]:.2f}', flush=True)

    best = min(chi2, key=chi2.get)
    print(f'best-fit inclination: {best:.0f} deg (true 60)')
    plt.figure(figsize=(4, 3))
    plt.plot(list(chi2.keys()), list(chi2.values()), 'o-')
    plt.axvline(60.0, color='k', ls='--', label='true')
    plt.xlabel('inclination [deg]')
    plt.ylabel(r'$\chi^2$')
    plt.legend()
    plt.tight_layout()
    plt.savefig(os.path.join(out_dir, 'alma_chi2_scan.png'), dpi=130)
    print('wrote', out_dir)


if __name__ == '__main__':
    p = argparse.ArgumentParser()
    p.add_argument('--out', default='example_outputs')
    p.add_argument('--small', action='store_true')
    args = p.parse_args()
    main(args.out, args.small)
