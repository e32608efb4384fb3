"""Generate synthetic polarized lightcurve datasets.

JAX port of the reference "Synthetic lightcurves 0 - Generate
data" notebook: render polarized lightcurves of an orbiting hotspot (or
flux tube) through the GR forward model, add noise, and save the CSV +
ground-truth flare volume consumed by scripts/fit_synthetic_lp_flares.py.

Example:
  python scripts/generate_synthetic_lightcurves.py --name hotspot_i60 \
      --inc 60 --source hotspot --out ../data
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..'))
from pathlib import Path

import numpy as np


def main():
    p = argparse.ArgumentParser()
    p.add_argument('--name', default='synthetic_hotspot')
    p.add_argument('--out', default='data')
    p.add_argument('--inc', type=float, default=60.0, help='deg')
    p.add_argument('--spin', type=float, default=0.0)
    p.add_argument('--source', default='hotspot',
                   choices=['hotspot', 'tube', 'double'])
    p.add_argument('--fov_M', type=float, default=40.0)
    p.add_argument('--num_alpha', type=int, default=64)
    p.add_argument('--num_beta', type=int, default=64)
    p.add_argument('--ngeo', type=int, default=100)
    p.add_argument('--nt', type=int, default=123)
    p.add_argument('--t_start', type=float, default=9.34, help='hr')
    p.add_argument('--duration', type=float, default=1.67, help='hr')
    p.add_argument('--Q_frac', type=float, default=0.85)
    p.add_argument('--I_flux', type=float, default=0.3, help='Jy')
    p.add_argument('--P_flux', type=float, default=0.1, help='Jy')
    p.add_argument('--noise', type=float, default=0.0,
                   help='gaussian noise std on Q/U [Jy]')
    p.add_argument('--seed', type=int, default=0)
    args = p.parse_args()

    import pandas as pd
    import yaml

    from bhnerf_jax import alma, constants, emission, units
    from bhnerf_jax.train import step as step_lib

    inc = np.deg2rad(args.inc)
    model_params = {
        'spin': args.spin, 'fov_M': args.fov_M, 'z_width': 4.0,
        'rmin': 'ISCO', 'Q_frac': args.Q_frac,
        'b_consts': {'arad': 0, 'avert': 1, 'ator': 0},
        'Omega_dir': 'cw', 'Omega_frac': 1.0,
        'num_alpha': args.num_alpha, 'num_beta': args.num_beta,
        't_start_obs': args.t_start,
    }
    geos, Omega, J = alma.image_plane_model(inc, args.spin, model_params)
    r_isco = float(constants.isco_pro(args.spin))

    res = (64, 64, 64)
    orbit_r = 1.5 * r_isco
    if args.source == 'hotspot':
        vol = emission.generate_hotspot(res, [0, 0, 1], 0.0, orbit_r, 1.2,
                                        r_isco, args.fov_M)
    elif args.source == 'tube':
        vol = emission.generate_tube(res, [0, 0, 1], 0.0, np.pi / 2,
                                     orbit_r, 1.2, r_isco, args.fov_M)
    else:  # double hotspot
        v1 = emission.generate_hotspot(res, [0, 0, 1], 0.0, orbit_r, 1.2,
                                       r_isco, args.fov_M)
        v2 = emission.generate_hotspot(res, [0, 0, 1], np.pi, 1.3 * orbit_r,
                                       1.0, r_isco, args.fov_M)
        import bhnerf_jax.utils as utils
        vol = utils.Grid3D(v1.data + 0.6 * v2.data, v1.start, v1.stop)

    t_frames = units.Quantity(
        args.t_start + np.linspace(0, args.duration, args.nt), 'hr')
    t_injection = -float(geos.r_o + args.fov_M / 4)
    movie = np.asarray(emission.image_plane_dynamics(
        vol, geos, Omega, t_frames, t_injection, J=J,
        t_start_obs=t_frames[0]))  # (nt, nstokes, na, nb)
    movie = np.asarray(emission.normalize_stokes(movie, args.I_flux,
                                                 args.P_flux))
    lc = movie.sum(axis=(-1, -2))  # (nt, nstokes)

    rng = np.random.default_rng(args.seed)
    if args.noise > 0:
        lc[:, 1:] += rng.normal(0, args.noise, lc[:, 1:].shape)

    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    csv_path = out_dir / f'{args.name}_lightcurves.csv'
    pd.DataFrame({'t': np.asarray(t_frames.value), 'I': lc[:, 0],
                  'Q': lc[:, 1], 'U': lc[:, 2]}).to_csv(csv_path,
                                                        index=False)
    flare_path = out_dir / f'{args.name}_flare.npz'
    np.savez(flare_path, data=np.asarray(vol.data),
             start=np.asarray(vol.start), stop=np.asarray(vol.stop))

    sim_yaml = out_dir / f'{args.name}.yaml'
    with open(sim_yaml, 'w') as f:
        yaml.dump({
            'name': args.name,
            'lightcurve_path': str(csv_path),
            'flare_path': str(flare_path),
            'model': model_params | {'emission_scale': 1.0},
        }, f, default_flow_style=False)
    print(f'wrote {csv_path}, {flare_path}, {sim_yaml}')
    print('fit with: python scripts/fit_synthetic_lp_flares.py '
          f'{sim_yaml} <inc>')


if __name__ == '__main__':
    main()
