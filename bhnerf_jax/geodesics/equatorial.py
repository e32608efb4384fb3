"""Equatorial lensing helpers (kgeo.equatorial_lensing equivalents).

The reference uses the external kgeo package's equatorial-lensing module
for two things: locating the Mino time of the mbar-th equatorial crossing
per ray (`r_equatorial`, used by emission.equatorial_ring —
reference emission.py:136) and inverting for the screen radius that maps
to a given equatorial emission radius (`rho_of_req`, used by the
Gelles2021 validation notebook). Here both are built directly on the
JAX ray tracer: crossings are found on densely sampled rays; the
inversion is a vectorized bisection on screen radius.
"""
from __future__ import annotations

import numpy as np

from bhnerf_jax.geodesics import dataset as dataset_lib


def crossing_index(geos, mbar):
    """Locate the (mbar+1)-th equatorial crossing of each ray.

    The single source of truth for equatorial-crossing detection (also
    used by emission.equatorial_ring and the Gelles2021 example).

    Returns (found, idx, idx_nearest): `idx` is the sample before the
    crossing (crossing lies in [idx, idx+1]); `idx_nearest` is whichever
    of the two samples has the smaller |cos(theta)|.
    """
    ct = np.cos(geos.theta)
    sign_change = np.signbit(ct[..., 1:]) != np.signbit(ct[..., :-1])
    order = np.cumsum(sign_change, axis=-1)
    is_mth = (order == mbar + 1) & sign_change
    found = is_mth.any(axis=-1)
    idx = np.argmax(is_mth, axis=-1)
    it = np.indices(idx.shape)
    nearer_next = np.abs(ct[(*it, idx)]) > np.abs(ct[(*it, idx + 1)])
    idx_nearest = np.where(nearer_next, idx + 1, idx)
    return found, idx, idx_nearest


def equatorial_crossing_quantities(geos, mbar):
    """Interpolated (r, mino, t, phi) of the (mbar+1)-th equatorial
    crossing of each ray; NaN where the ray has fewer crossings."""
    ct = np.cos(geos.theta)
    found, idx, _ = crossing_index(geos, mbar)
    it = np.indices(idx.shape)

    # linear interpolation in cos(theta) across the crossing interval:
    # c0 + w (c1 - c0) = 0  =>  w = c0 / (c0 - c1)
    c0 = ct[(*it, idx)]
    c1 = ct[(*it, idx + 1)]
    denom = np.where(np.abs(c0 - c1) > 0, c0 - c1, 1.0)
    w = np.clip(c0 / denom, 0.0, 1.0)

    def interp(arr):
        a0 = arr[(*it, idx)]
        a1 = arr[(*it, idx + 1)]
        val = a0 + w * (a1 - a0)
        return np.where(found, val, np.nan)

    return {
        'found': found,
        'r': interp(geos.r),
        'mino': interp(geos.mino),
        't': interp(geos.t),
        'phi': interp(geos.phi),
    }


def r_equatorial(spin, r_o, inc, mbar, alpha, beta, ngeo=400,
                 distance=1000.0):
    """Equatorial-crossing radius + Mino time for screen points
    (kgeo.equatorial_lensing.r_equatorial parity; reference
    emission.py:136 consumes index [1] = Mino time).

    Returns (r, mino) arrays shaped like alpha.
    """
    del r_o
    alpha = np.atleast_1d(np.asarray(alpha, float))
    beta = np.atleast_1d(np.asarray(beta, float))
    geos = dataset_lib.trace_geodesics(alpha, beta, spin, inc, ngeo=ngeo,
                                       distance=distance)
    q = equatorial_crossing_quantities(geos, mbar)
    return q['r'], q['mino']


def rho_of_req(spin, inc, req, mbar=0, varphis=None, rho_min=1.0,
               rho_max=12.0, iters=40, ngeo=400, distance=1000.0):
    """Screen radius rho(varphi) whose mbar-th equatorial crossing lands
    at Boyer-Lindquist radius req (Gelles2021 point-source placement).

    Vectorized bisection: each iteration traces len(varphis) rays.
    Returns (varphis, rho) arrays.
    """
    if varphis is None:
        varphis = np.linspace(-np.pi, np.pi, 64)
    varphis = np.atleast_1d(np.asarray(varphis, float))
    nphi = varphis.size

    def crossing_r(rho):
        alpha = rho * np.cos(varphis if rho.ndim == 1 else
                             varphis[None, :])
        beta = rho * np.sin(varphis if rho.ndim == 1 else
                            varphis[None, :])
        r, _ = r_equatorial(spin, np.inf, inc, mbar, alpha.ravel(),
                            beta.ravel(), ngeo=ngeo, distance=distance)
        return r.reshape(rho.shape)

    # 1) coarse scan to bracket: the mbar-th crossing only exists inside a
    # finite rho window (below it the ray plunges first, above it the ray
    # never winds enough), and r(rho) increases within that window
    n_scan = 48
    rho_grid = np.linspace(rho_min, rho_max, n_scan)
    rho_2d = np.broadcast_to(rho_grid[:, None], (n_scan, nphi)).copy()
    r_scan = crossing_r(rho_2d)  # (n_scan, nphi)
    # first grid point whose crossing exists with r >= req brackets the
    # solution from above (NaN exists both below and above the window)
    ok = np.isfinite(r_scan) & (r_scan >= req)
    bracketed = ok.any(axis=0)
    idx_hi = np.clip(np.argmax(ok, axis=0), 1, n_scan - 1)
    hi = rho_grid[idx_hi]
    lo = rho_grid[idx_hi - 1]

    # 2) bisection inside the bracket
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        r_mid = crossing_r(mid)
        too_small = np.isnan(r_mid) | (r_mid < req)
        lo = np.where(too_small, mid, lo)
        hi = np.where(too_small, hi, mid)
    rho = 0.5 * (lo + hi)
    # validate: a bracket can also form at the existence-window edge when
    # req is outside the reachable crossing-radius range (e.g. req below
    # every ray's first-crossing radius); the bisection then converges on
    # the window boundary, not on r == req. NaN out anything whose
    # re-traced crossing misses req.
    r_final = crossing_r(rho)
    good = (bracketed & np.isfinite(r_final)
            & (np.abs(r_final - req) <= 1e-2 * max(abs(req), 1.0)))
    return varphis, np.where(good, rho, np.nan)
