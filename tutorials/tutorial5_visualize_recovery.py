"""Tutorial 5 — visualize recovery results.

JAX port of "Tutorial5 - visualize recovery results": render the
recovered 3D emission volume with the flat-space pinhole-camera
VolumeVisualizer (jit-compiled alpha compositing).

Run after tutorial 3:
    python tutorials/tutorial5_visualize_recovery.py
(loads tutorial_outputs/tutorial3_checkpoint; falls back to a synthetic
hotspot volume when no checkpoint exists)
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

    from bhnerf_jax import emission
    from bhnerf_jax.visualization import VolumeVisualizer

    os.makedirs(out_dir, exist_ok=True)
    fov_M = 16.0
    ckpt = os.path.join(out_dir, 'tutorial3_checkpoint')
    if os.path.isdir(ckpt):
        from bhnerf_jax.network import sample_checkpoint_3d
        vol = sample_checkpoint_3d(ckpt, fov=fov_M, resolution=64)
        print('rendering recovered volume from', ckpt)
    else:
        hotspot = emission.generate_hotspot(
            resolution=(64, 64, 64), rot_axis=[0, 0, 1], rot_angle=0.0,
            orbit_radius=6.6, std=0.7, r_isco=6.0, fov=fov_M)
        vol = np.asarray(hotspot.data)
        print('no checkpoint found; rendering synthetic hotspot volume')

    res = (96, 96) if small else (384, 384)
    vis = VolumeVisualizer(resolution=res, fov=35.0,
                           samples=64 if small else 192)
    fig, axes = plt.subplots(1, 3, figsize=(12, 4))
    for ax, az in zip(axes, (0.0, 0.8, 1.6)):
        rgb = vis.render(vol, extent=fov_M / 2, azimuth=az,
                         zenith=np.pi / 3, sigma_scale=300.0,
                         bh_radius=2.0, draw_cube=True)
        ax.imshow(rgb)
        ax.set_title(f'azimuth {az:.1f} rad')
        ax.axis('off')
    path = os.path.join(out_dir, 'tutorial5_volume_render.png')
    fig.savefig(path, dpi=120)
    print('wrote', path)


if __name__ == '__main__':
    p = argparse.ArgumentParser()
    p.add_argument('--out', default='tutorial_outputs')
    p.add_argument('--small', action='store_true')
    args = p.parse_args()
    main(args.out, args.small)
