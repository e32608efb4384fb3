"""Tutorial 1 — Kerr geodesics.

JAX port of the reference "Tutorial1 - Kerr geodesics.ipynb":
trace null geodesics of a spinning black hole for the full image plane,
inspect the dataset, and visualize rays in 3D.

Run:  python tutorials/tutorial1_kerr_geodesics.py [--out out_dir]
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

    from bhnerf_jax import constants, visualization
    from bhnerf_jax.geodesics import image_plane_geos

    os.makedirs(out_dir, exist_ok=True)
    spin = 0.2
    inclination = np.deg2rad(60.0)
    num = 16 if small else 64
    ngeo = 32 if small else 100

    # trace geodesics across the image plane (JAX integrator, f64 host)
    geos = image_plane_geos(spin, inclination, alpha_range=(-10, 10),
                            beta_range=(-10, 10), ngeo=ngeo,
                            num_alpha=num, num_beta=num)
    print('geodesics:', geos.r.shape, 'fields: r,theta,phi,t,mino,dtau,...')
    print(f'ISCO (prograde): {float(constants.isco_pro(spin)):.3f} M')
    print(f't range along rays: [{geos.t.min():.1f}, {geos.t.max():.1f}] M')

    # 3D ray visualization with the event horizon
    ax = visualization.plot_geodesic_3D(geos)
    ax.get_figure().savefig(os.path.join(out_dir, 'tutorial1_rays.png'),
                            dpi=120)
    plt.close('all')

    # black-hole shadow: minimum radius per ray
    rmin = geos.r.min(axis=-1)
    plt.figure(figsize=(4, 4))
    plt.imshow(rmin < 2.5, extent=[-10, 10, -10, 10], cmap='gray_r')
    plt.xlabel(r'$\beta$ [M]')
    plt.ylabel(r'$\alpha$ [M]')
    plt.title('captured rays (shadow)')
    plt.savefig(os.path.join(out_dir, 'tutorial1_shadow.png'), dpi=120)
    print('wrote', out_dir)


if __name__ == '__main__':
    p = argparse.ArgumentParser()
    p.add_argument('--out', default='tutorial_outputs')
    p.add_argument('--small', action='store_true')
    args = p.parse_args()
    main(args.out, args.small)
