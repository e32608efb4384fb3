"""Tutorial 2 — synthesize ngEHT observations of an orbiting hotspot.

JAX port of "Tutorial2 - synthesize ngEHT observations.ipynb":
forward-model an orbiting hotspot movie through the GR renderer, then
observe it with the ngEHT array (uv coverage, thermal noise).

Run:  python tutorials/tutorial2_synthesize_ngeht_observations.py
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..'))

import numpy as np


def main(out_dir='tutorial_outputs', small=False):
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt

    from bhnerf_jax import constants, emission, observation, units
    from bhnerf_jax.geodesics import image_plane_geos

    os.makedirs(out_dir, exist_ok=True)
    spin, inc = 0.2, np.deg2rad(60.0)
    fov_M = 16.0
    num = 16 if small else 64
    ngeo = 32 if small else 100
    nt = 8 if small else 64

    geos = image_plane_geos(spin, inc, (-fov_M / 2, fov_M / 2),
                            (-fov_M / 2, fov_M / 2), ngeo=ngeo,
                            num_alpha=num, num_beta=num)
    Omega = geos.keplerian_omega()
    r_isco = float(constants.isco_pro(spin))
    hotspot = emission.generate_hotspot(
        resolution=(64, 64, 64), rot_axis=[0, 0, 1], rot_angle=0.0,
        orbit_radius=1.1 * r_isco, std=0.7, r_isco=r_isco, fov=fov_M)

    t_frames = units.Quantity(np.linspace(0.0, 1.0, nt), 'hr')
    t_injection = -float(geos.r_o + fov_M / 4)
    movie = np.asarray(emission.image_plane_dynamics(
        hotspot, geos, Omega, t_frames, t_injection))
    print('movie:', movie.shape, 'flux range',
          movie.sum((-1, -2)).min(), movie.sum((-1, -2)).max())

    # observe with ngEHT: uv coverage + thermal noise
    array = observation.load_txt('eht_arrays/ngEHT.txt')
    obs_empty = observation.empty_eht_obs(array, nt=nt, tint=30.0,
                                          tstart=4.0, tstop=15.5)
    fov_rad = (fov_M * constants.GM_c2(constants.sgra_mass).value
               / constants.sgra_distance.to('m').value)
    psize = fov_rad / num
    obs = observation.observe_same(movie, np.asarray(t_frames.value) + 4.0,
                                   psize, obs_empty, thermal_noise=True,
                                   seed=0)
    print('observation: nscan', obs.nscan, 'valid baselines',
          int(obs.mask.sum()))

    ax = observation.plot_uv_coverage(obs)
    ax.get_figure().savefig(os.path.join(out_dir, 'tutorial2_uv.png'),
                            dpi=120)
    plt.close('all')

    fig, axes = plt.subplots(1, 4, figsize=(12, 3))
    for k, ax in enumerate(axes):
        ax.imshow(movie[k * (nt // 4)], cmap='afmhot')
        ax.set_title(f't = {float(t_frames.value[k * (nt // 4)]):.2f} hr')
        ax.axis('off')
    fig.savefig(os.path.join(out_dir, 'tutorial2_frames.png'), dpi=120)
    np.savez(os.path.join(out_dir, 'tutorial2_data.npz'), movie=movie,
             t_frames=np.asarray(t_frames.value))
    print('wrote', out_dir)


if __name__ == '__main__':
    p = argparse.ArgumentParser()
    p.add_argument('--out', default='tutorial_outputs')
    p.add_argument('--small', action='store_true')
    args = p.parse_args()
    main(args.out, args.small)
