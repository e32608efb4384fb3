"""Recovery animations: movie comparison + rotating volume render.

Runnable equivalent of the animation cells of the reference's
"Synthetic lightcurves 2.1" / "ALMA lightcurves 1.1" notebooks: train (or
load) a hotspot recovery, then write

* a synced true-vs-recovered-vs-difference movie GIF
  (visualization.animate_movies_synced), and
* a rotating-camera volume-render GIF of the recovered 3D emission with
  the bounding-cube wireframe + black-hole sphere overlays
  (visualization.VolumeVisualizer, reference visualization.py:491-755).

Run:  python examples/recovery_animation.py [--small]
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

    from bhnerf_jax import constants, emission, units
    from bhnerf_jax.geodesics import image_plane_geos
    from bhnerf_jax.models import NeRFPredictor, sample_3d_grid
    from bhnerf_jax.train import (Optimizer, TrainStep, raytracing_args,
                                  total_movie_loss)
    from bhnerf_jax.train.step import compact_raytracing_args
    from bhnerf_jax.visualization import (VolumeVisualizer,
                                          animate_movies_synced)

    os.makedirs(out_dir, exist_ok=True)
    spin, inc = 0.2, np.deg2rad(60.0)
    fov_M = 16.0
    num = 16 if small else 64
    ngeo = 32 if small else 100
    nt = 12 if small else 64
    num_iters = 200 if small else 1000

    geos = image_plane_geos(spin, inc, (-fov_M / 2, fov_M / 2),
                            (-fov_M / 2, fov_M / 2), ngeo=ngeo,
                            num_alpha=num, num_beta=num,
                            n_fine=2048 if small else 8192)
    Omega = geos.keplerian_omega()
    r_isco = float(constants.isco_pro(spin))
    hotspot = emission.generate_hotspot(
        resolution=(64, 64, 64), rot_axis=[0, 0, 1], rot_angle=0.0,
        orbit_radius=1.1 * r_isco, std=0.7, r_isco=r_isco, fov=fov_M)
    t_frames = units.Quantity(np.linspace(0.0, 1.0, nt), 'hr')
    t_injection = -float(geos.r_o + fov_M / 4)
    movie = np.asarray(emission.image_plane_dynamics(
        hotspot, geos, Omega, t_frames, t_injection))

    predictor = NeRFPredictor(scale=fov_M / 2, rmin=0.0, rmax=fov_M / 2,
                              z_width=2.0)
    rt = raytracing_args(geos, Omega, t_injection, t_frames[0])
    crt = compact_raytracing_args(rt, predictor)
    train_step = TrainStep.image(t_frames, movie, predictor, dtype='full')
    optimizer = Optimizer({'num_iters': num_iters, 'lr_init': 1e-3,
                           'lr_final': 1e-5}, predictor, crt)
    optimizer.run(batchsize=min(6, nt), train_step=train_step,
                  raytracing_args=crt, verbose=not small,
                  scan_chunk=100)

    # --- synced movie animation (true / recovered / difference) ----------
    _, frames = total_movie_loss(min(8, nt), optimizer.state, train_step,
                                 crt, return_frames=True)
    frames = np.asarray(frames)
    fig, axes = plt.subplots(1, 3, figsize=(9, 3))
    anim = animate_movies_synced(
        [movie, frames, movie - frames], axes, fps=10,
        cmaps=['afmhot', 'afmhot', 'RdBu_r'],
        vmin=[0, 0, -movie.max() / 5], vmax=[movie.max(), movie.max(),
                                             movie.max() / 5],
        titles=['true', 'recovered', 'difference'],
        output=os.path.join(out_dir, 'recovery_movie.gif'))
    del anim

    # --- rotating volume render with cube + BH overlays ------------------
    vol = sample_3d_grid(predictor, optimizer.params, fov=fov_M,
                         resolution=48 if small else 64)
    res = (96, 96) if small else (256, 256)
    vis = VolumeVisualizer(resolution=res, fov=35.0,
                           samples=48 if small else 160)
    n_views = 6 if small else 24
    renders = [vis.render(vol, extent=fov_M / 2, azimuth=az,
                          zenith=np.pi / 3, sigma_scale=300.0,
                          bh_radius=1.0 + np.sqrt(1 - spin**2),
                          draw_cube=True)
               for az in np.linspace(0, 2 * np.pi, n_views, endpoint=False)]
    fig2, ax2 = plt.subplots(figsize=(4, 4))
    anim2 = animate_movies_synced(
        [np.stack(renders)], [ax2], fps=8, titles=['recovered volume'],
        vmin=[0.0], vmax=[1.0],
        output=os.path.join(out_dir, 'recovery_volume_rotation.gif'))
    del anim2
    print('wrote', os.path.join(out_dir, 'recovery_movie.gif'), 'and',
          os.path.join(out_dir, 'recovery_volume_rotation.gif'))


if __name__ == '__main__':
    p = argparse.ArgumentParser()
    p.add_argument('--out', default='example_outputs')
    p.add_argument('--small', action='store_true')
    args = p.parse_args()
    main(args.out, args.small)
