"""Polarized synchrotron radiation for simple geometries (Gelles 2021).

JAX port of the reference validation notebook "Polarized
synchrotron radiation for simple geometries (Gelles2021).ipynb": renders
the EVPA tick pattern around the lensed image of an equatorial ring and
the Q-U loop of an orbiting point source, for a boosted-ZAMO emitter with
a prescribed magnetic field (Gelles et al. 2021, arXiv:2105.09440).

Run:  python examples/gelles2021_polarized_ring.py
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..'))

import numpy as np


def ring_stokes(spin, inc_deg, req, beta_v, chi_deg, b_field, mbar=0,
                nphi=64, spectral_index=1):
    """Per-azimuth Stokes (I, Q, U) of the lensed equatorial ring image.

    For each screen azimuth varphi: find the screen radius whose mbar-th
    equatorial crossing lands at r=req, trace that single ray, and
    evaluate the boosted-ZAMO parallel-transported Stokes factors at the
    crossing sample.
    """
    from bhnerf_jax.geodesics import equatorial, trace_geodesics
    from bhnerf_jax.ops import gr

    inc = np.deg2rad(inc_deg)
    chi = np.deg2rad(chi_deg)
    varphis = np.linspace(-np.pi, np.pi, nphi, endpoint=False)
    varphis, rho = equatorial.rho_of_req(spin, inc, req, mbar=mbar,
                                         varphis=varphis, ngeo=400)
    alpha = rho * np.cos(varphis)
    beta = rho * np.sin(varphis)
    geos = trace_geodesics(alpha, beta, spin, inc, ngeo=400)

    g = gr.doppler_factor(geos, gr.zamo_frame_velocity(geos, beta_v, chi))
    bvec = np.broadcast_to(np.asarray(b_field, float), (*geos.r.shape, 3))
    J = np.asarray(gr.parallel_transport_zamo(
        geos, beta_v, chi, g, bvec, Q_frac=1.0,
        spectral_index=spectral_index))

    # pick the sample at the mbar-th equatorial crossing of each ray
    _, _, idx = equatorial.crossing_index(geos, mbar)
    it = np.arange(len(varphis))
    stokes = np.stack([J[k][it, idx] for k in range(3)])
    return varphis, alpha, beta, np.nan_to_num(stokes, nan=0.0)


def main(out_dir='example_outputs', small=False):
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt

    from bhnerf_jax.visualization import plot_evpa_ticks

    os.makedirs(out_dir, exist_ok=True)
    nphi = 16 if small else 64

    configs = [
        # (label, beta_v, chi_deg, b=[br, bth, bph])  Gelles2021 cases
        ('static, vertical B', 0.0, 0.0, [0.0, 1.0, 0.0]),
        ('static, radial B', 0.0, 0.0, [1.0, 0.0, 0.0]),
        ('boosted, toroidal B', 0.3, -90.0, [0.0, 0.0, 1.0]),
    ]
    fig, axes = plt.subplots(1, len(configs), figsize=(4 * len(configs), 4))
    for ax, (label, bv, chi, b) in zip(np.atleast_1d(axes), configs):
        varphis, alpha, beta, J = ring_stokes(
            spin=0.0, inc_deg=20.0, req=6.0, beta_v=bv, chi_deg=chi,
            b_field=b, nphi=nphi)
        I, Q, U = J
        lp = np.sqrt(Q**2 + U**2)
        ax.scatter(alpha, beta, c=I, cmap='afmhot', s=14)
        plot_evpa_ticks(Q, U, alpha, beta, ax=ax, color='royalblue',
                        scale=np.maximum(lp.max() * 8, 1e-8))
        ax.set_aspect('equal')
        ax.set_title(label, fontsize=10)
        ax.set_xlabel(r'$\alpha$ [M]')
        print(f'{label}: DoLP mean {np.mean(lp / np.maximum(I, 1e-12)):.3f},'
              f' I contrast {I.max() / max(I.min(), 1e-12):.2f}')
    fig.tight_layout()
    path = os.path.join(out_dir, 'gelles2021_ring_evpa.png')
    fig.savefig(path, dpi=130)

    # Q-U loop of the orbiting point source (one orbital period)
    varphis, alpha, beta, J = ring_stokes(
        spin=0.0, inc_deg=20.0, req=6.0, beta_v=0.4, chi_deg=-90.0,
        b_field=[0.0, 0.71, 0.71], nphi=nphi)
    fig2, ax2 = plt.subplots(figsize=(4, 4))
    ax2.plot(J[1], J[2], '.-')
    ax2.set_xlabel('Q')
    ax2.set_ylabel('U')
    ax2.set_title('Q-U loop of orbiting point source')
    ax2.set_aspect('equal')
    fig2.savefig(os.path.join(out_dir, 'gelles2021_qu_loop.png'), dpi=130)

    # ---- golden validation (analytic face-on limits of the Gelles2021
    # configurations; see tests/test_polarization_physics.py for the full
    # version): radial B -> azimuthal ticks (EVPA = varphi East-of-North),
    # toroidal B -> radial ticks, vertical B suppressed by sin^2(theta_B)
    common = dict(spin=0.0, inc_deg=1.0, req=6.0, beta_v=0.0, chi_deg=0.0,
                  nphi=nphi)
    vv, _, _, J_rad = ring_stokes(b_field=[1.0, 0.0, 0.0], **common)
    _, _, _, J_tor = ring_stokes(b_field=[0.0, 0.0, 1.0], **common)
    _, _, _, J_ver = ring_stokes(b_field=[0.0, 1.0, 0.0], **common)
    ang = lambda a, b: np.abs((a - b + np.pi / 2) % np.pi - np.pi / 2)
    evpa = lambda J: 0.5 * np.arctan2(J[2], J[1])
    assert ang(evpa(J_rad), vv).max() < np.deg2rad(3)
    assert ang(evpa(J_tor), vv + np.pi / 2).max() < np.deg2rad(3)
    assert J_ver[0].max() < 0.2 * J_rad[0].max()
    print('golden face-on EVPA patterns: OK')
    print('wrote', out_dir)


if __name__ == '__main__':
    p = argparse.ArgumentParser()
    p.add_argument('--out', default='example_outputs')
    p.add_argument('--small', action='store_true')
    args = p.parse_args()
    main(args.out, args.small)
