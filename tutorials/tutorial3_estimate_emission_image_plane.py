"""Tutorial 3 — estimate 3D emission from image-plane measurements.

JAX port of "Tutorial3 - estimate 3D emission from image plane":
closed-loop recovery of an orbiting hotspot from its rendered movie.

Run:  python tutorials/tutorial3_estimate_emission_image_plane.py
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

    from bhnerf_jax import constants, emission, units, utils
    from bhnerf_jax.geodesics import image_plane_geos
    from bhnerf_jax.models import NeRFPredictor, sample_3d_grid
    from bhnerf_jax.train import Optimizer, TrainStep, raytracing_args
    from bhnerf_jax.train.step import compact_raytracing_args

    os.makedirs(out_dir, exist_ok=True)
    spin, inc = 0.2, np.deg2rad(60.0)
    fov_M = 16.0
    num = 16 if small else 64
    ngeo = 32 if small else 100
    nt = 16 if small else 64
    num_iters = 200 if small else 1000

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

    # recovery
    predictor = NeRFPredictor(scale=fov_M / 2, rmin=0.0, rmax=fov_M / 2,
                              z_width=2.0)
    rt = raytracing_args(geos, Omega, t_injection, t_frames[0])
    rt = compact_raytracing_args(rt, predictor)
    train_step = TrainStep.image(t_frames, movie, predictor, dtype='full')
    checkpoint_dir = os.path.join(out_dir, 'tutorial3_checkpoint')
    optimizer = Optimizer({'num_iters': num_iters, 'lr_init': 1e-3,
                           'lr_final': 1e-5}, predictor, rt,
                          checkpoint_dir=checkpoint_dir)
    optimizer.run(batchsize=min(6, nt), train_step=train_step,
                  raytracing_args=rt)
    print('final loss:', float(np.asarray(optimizer.loss)))

    # compare recovered volume to truth
    vol = sample_3d_grid(predictor, optimizer.params, fov=fov_M,
                         resolution=64)
    truth = np.asarray(hotspot.data)
    print(f'3D recovery: PSNR {utils.psnr(truth, vol):.2f} dB, '
          f'corr {np.corrcoef(vol.ravel(), truth.ravel())[0, 1]:.3f}')

    fig, axes = plt.subplots(1, 2, figsize=(8, 4))
    axes[0].imshow(truth.sum(-1), cmap='hot')
    axes[0].set_title('true emission (z-sum)')
    axes[1].imshow(vol.sum(-1), cmap='hot')
    axes[1].set_title('recovered')
    for ax in axes:
        ax.axis('off')
    fig.savefig(os.path.join(out_dir, 'tutorial3_recovery.png'), dpi=120)
    print('wrote', out_dir)


if __name__ == '__main__':
    p = argparse.ArgumentParser()
    p.add_argument('--out', default='tutorial_outputs')
    p.add_argument('--small', action='store_true')
    args = p.parse_args()
    main(args.out, args.small)
