"""Drive: on-device (f32) geodesic tracing vs host (f64).

Validates accuracy and measures the speedup of
`trace_geodesics(backend='device')` for the chi^2-scan table workload
(64x64 rays x ngeo=100, the production ALMA shape is 128x128).

Run: python scripts/drive_device_geos.py [npix]
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def main():
    import jax

    from bhnerf_jax.utils import enable_compilation_cache
    enable_compilation_cache()
    from bhnerf_jax.geodesics import image_plane_geos

    n = int(sys.argv[1]) if len(sys.argv) > 1 else 64
    kw = dict(spin=0.94, inclination=np.deg2rad(60), alpha_range=(-8, 8),
              beta_range=(-8, 8), ngeo=100, num_alpha=n, num_beta=n)
    print(f'backend={jax.default_backend()} grid={n}x{n}x100', flush=True)

    t0 = time.time()
    g64 = image_plane_geos(**kw)
    t_host = time.time() - t0
    print(f'host f64 trace: {t_host:.1f} s', flush=True)

    t0 = time.time()
    g32 = image_plane_geos(**kw, backend='device')
    t_dev_cold = time.time() - t0
    t0 = time.time()
    g32 = image_plane_geos(**kw, backend='device')
    t_dev = time.time() - t0
    print(f'device f32 trace: {t_dev:.2f} s (cold {t_dev_cold:.1f} s) '
          f'-> {t_host / t_dev:.0f}x host', flush=True)

    dr = np.abs(g32.r - g64.r) / np.maximum(g64.r, 1.0)
    dt = np.abs(g32.t - g64.t)
    dth = np.abs(g32.theta - g64.theta)
    for name, d in (('r_rel', dr), ('theta', dth), ('t', dt)):
        print(f'{name}: median {np.median(d):.2e}  p90 '
              f'{np.quantile(d, 0.9):.2e}  max {d.max():.2e}', flush=True)

    # The acceptance enforces TWO bounds (VERDICT r4 weak #2):
    # 1. bulk quantiles (p90) over all samples — integrator health;
    # 2. the IN-DOMAIN max: every sample the CONSUMERS would keep must
    #    track t to < 1 M. The gate uses the f32 table's OWN radii —
    #    exactly the mask CompactRayArgs / the rmax interpolation cut
    #    apply in the device-trace workflow — so a diverged f32 sample
    #    whose f32 r wandered back under rmax is covered by the bound,
    #    not excluded by an f64-truth mask the pipeline never sees.
    #    The global max can still be huge (up to ~5e1 M observed):
    #    far-field segments (r ~ 700+) of near-critical rays diverge
    #    exponentially in f32 but sit outside the gate by their own
    #    f32 radii — quantified in tests/test_geodesics.py.
    fov = 16.0
    in_dom = np.asarray(g32.r) <= fov
    reentry = in_dom & (np.asarray(g64.r) > 2 * fov)
    dt_dom_max = float(dt[in_dom].max())
    dt_dom_p99 = float(np.quantile(dt[in_dom], 0.99))
    print(f't (in-domain f32 r<={fov:.0f}M, n={int(in_dom.sum())}, '
          f'divergent re-entries {int(reentry.sum())}): '
          f'p99 {dt_dom_p99:.2e}  max {dt_dom_max:.2e}', flush=True)
    ok = (np.quantile(dr, 0.9) < 1e-4 and np.quantile(dth, 0.9) < 1e-3
          and np.quantile(dt, 0.9) < 1e-3
          and dt_dom_max < 1.0 and dt_dom_p99 < 1e-2
          and not reentry.any())
    print('ACCURACY OK' if ok else 'ACCURACY REGRESSION', flush=True)
    return 0 if ok else 1


if __name__ == '__main__':
    sys.exit(main())
