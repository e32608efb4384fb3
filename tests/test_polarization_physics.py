"""Polarized-radiation physics validation (Gelles2021-style checks,
SURVEY.md §4 'physics validation against published results').
"""
import numpy as np
import pytest

from bhnerf_jax import emission, kgeo
from bhnerf_jax.geodesics import equatorial, trace_geodesics
from bhnerf_jax.ops import gr


def test_equatorial_crossing_self_consistency():
    """rho_of_req output rays must actually cross the equator at req."""
    req = 6.0
    varphis = np.linspace(-np.pi, np.pi, 8, endpoint=False)
    varphis, rho = equatorial.rho_of_req(0.0, np.deg2rad(20.0), req,
                                         mbar=0, varphis=varphis,
                                         ngeo=300)
    r_cross, _ = equatorial.r_equatorial(
        0.0, np.inf, np.deg2rad(20.0), 0, rho * np.cos(varphis),
        rho * np.sin(varphis), ngeo=300)
    np.testing.assert_allclose(r_cross, req, rtol=5e-3)


def test_face_on_ring_is_circular():
    """Nearly face-on Schwarzschild: the lensed ring must be circular."""
    varphis = np.linspace(-np.pi, np.pi, 8, endpoint=False)
    # inc ~ 0: at finite inclination the ring center shifts by ~2M sin(i),
    # which is real physics, not discretization error
    _, rho = equatorial.rho_of_req(0.0, np.deg2rad(0.01), 6.0, mbar=0,
                                   varphis=varphis, ngeo=300)
    assert rho.std() / rho.mean() < 1e-3
    # weak lensing pushes the image outside the emission radius
    assert (rho > 6.0).all() and (rho < 9.0).all()


def test_first_order_ring_near_critical_curve():
    """mbar=1 image of any equatorial radius hugs the photon ring
    (b_c = sqrt(27) ~ 5.196 for Schwarzschild)."""
    varphis = np.linspace(-np.pi, np.pi, 4, endpoint=False)
    _, rho = equatorial.rho_of_req(0.0, np.deg2rad(0.01), 6.0, mbar=1,
                                   varphis=varphis, ngeo=600)
    assert np.abs(rho - np.sqrt(27.0)).max() < 0.35


def test_equatorial_ring_emission_map():
    """emission.equatorial_ring marks exactly one sample per crossing
    ray and zero elsewhere."""
    b = np.linspace(2.0, 9.0, 12)
    geos = trace_geodesics(b, np.zeros_like(b), spin=0.0,
                           inclination=np.deg2rad(30.0), ngeo=128)
    ring = emission.equatorial_ring(geos, mbar=0)
    per_ray = ring.sum(axis=-1)
    assert set(np.unique(per_ray)) <= {0.0, 1.0}
    assert per_ray.sum() >= 10  # most of these rays cross the equator


def test_zamo_polarization_finite_and_bounded():
    """ZAMO-frame parallel transport (Gelles2021 path): J finite, linear
    polarization bounded by Q_frac."""
    b = np.linspace(4.0, 9.0, 8)
    geos = trace_geodesics(b, np.ones_like(b) * 0.5, spin=0.5,
                           inclination=np.deg2rad(45.0), ngeo=64)
    umu = gr.zamo_frame_velocity(geos, beta=0.3, chi=np.deg2rad(-90.0))
    g = gr.doppler_factor(geos, umu)
    bvec = kgeo.magnetic_field_spherical(geos, 0.0, 0.0, 1.0)
    J = np.asarray(gr.parallel_transport_zamo(
        geos, 0.3, np.deg2rad(-90.0), g, bvec, Q_frac=0.7))
    finite = np.isfinite(J).all(axis=0)
    assert finite.mean() > 0.9
    P = np.sqrt(J[1] ** 2 + J[2] ** 2)[finite]
    assert (P <= 0.7 * J[0][finite] * (1 + 1e-4) + 1e-9).all()


def test_evpa_rotation_preserves_dolp():
    """Screen EVPA rotation chi2 preserves the polarization fraction:
    |J_QU| must equal Q_frac * I everywhere (rotation is orthogonal)."""
    b = np.linspace(4.0, 9.0, 8)
    geos = trace_geodesics(b, np.zeros_like(b) + 1.0, spin=0.0,
                           inclination=np.deg2rad(60.0), ngeo=64)
    Omega = geos.keplerian_omega()
    umu = gr.azimuthal_velocity_vector(geos, Omega)
    g = gr.doppler_factor(geos, umu)
    bf = gr.magnetic_field_fluid_frame(geos, umu, 0.0, 1.0, 0.0)
    J = np.asarray(gr.parallel_transport(geos, umu, g, bf, Q_frac=0.4,
                                         V_frac=0.0))
    finite = np.isfinite(J).all(axis=0) & (np.asarray(J[0]) > 1e-12)
    P = np.sqrt(J[1] ** 2 + J[2] ** 2)
    np.testing.assert_allclose(P[finite] / J[0][finite], 0.4, rtol=1e-4)


def test_kgeo_facade_parity():
    """Reference-named API surface resolves through bhnerf_jax.kgeo."""
    for name in ('image_plane_geos', 'wave_vector', 'spacetime_metric',
                 'spacetime_inv_metric', 'raise_or_lower_indices',
                 'azimuthal_velocity_vector', 'doppler_factor',
                 'magnetic_field_spherical', 'magnetic_field_fluid_frame',
                 'fluid_frame_tetrad', 'zamo_frame_tetrad',
                 'zamo_frame_velocity', 'parallel_transport',
                 'parallel_transport_zamo', 'radiative_trasfer',
                 'equatorial_lensing'):
        assert hasattr(kgeo, name), name
    import bhnerf_jax
    for name in ('network', 'optimization', 'emission', 'utils',
                 'constants', 'observation', 'alma', 'visualization'):
        assert hasattr(bhnerf_jax, name), name
    assert hasattr(bhnerf_jax.network, 'NeRF_Predictor')
    assert hasattr(bhnerf_jax.optimization, 'Optimizer')
    assert hasattr(bhnerf_jax.optimization, 'TrainStep')


def _ring_stokes(**kw):
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(__file__), '..', 'examples',
                        'gelles2021_polarized_ring.py')
    spec = importlib.util.spec_from_file_location('gelles_example', path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.ring_stokes(**kw)


def test_gelles_face_on_evpa_patterns():
    """Golden EVPA patterns of the Gelles2021 validation geometry in the
    face-on Schwarzschild limit, where they are analytic (synchrotron
    polarization ~ k x B): a radial B field gives azimuthal ticks
    (EVPA = varphi + 90 deg), a toroidal B field gives radial ticks
    (EVPA = varphi), and a vertical B field gives vanishing intensity
    (photon momentum parallel to B). Reference validates the same
    configurations against Gelles et al. 2021 figures (notebook cells
    4-26; VERDICT r1 weak #6)."""
    common = dict(spin=0.0, inc_deg=1.0, req=6.0, beta_v=0.0, chi_deg=0.0,
                  nphi=16)
    varphis, _, _, J_rad = _ring_stokes(b_field=[1.0, 0.0, 0.0], **common)
    _, _, _, J_tor = _ring_stokes(b_field=[0.0, 0.0, 1.0], **common)
    _, _, _, J_ver = _ring_stokes(b_field=[0.0, 1.0, 0.0], **common)

    def evpa(J):
        return 0.5 * np.arctan2(J[2], J[1])

    def ang_diff(a, b):
        """Distance modulo pi (EVPA is a half-turn quantity)."""
        return np.abs((a - b + np.pi / 2) % np.pi - np.pi / 2)

    # EVPA is measured East-of-North (0 = +beta axis), so a tick at
    # screen position angle psi (from +alpha, CCW) has EVPA = psi - pi/2.
    # radial B -> azimuthal ticks (psi = varphi + pi/2 -> EVPA = varphi);
    # toroidal B -> radial ticks (psi = varphi -> EVPA = varphi - pi/2).
    assert ang_diff(evpa(J_rad), varphis).max() < np.deg2rad(3)
    assert ang_diff(evpa(J_tor), varphis + np.pi / 2).max() < np.deg2rad(3)
    # vertical B: k nearly parallel to B face-on -> intensity suppressed
    # by sin^2(theta_B). Bending leaves a ~20 deg local emission angle at
    # r=6, so suppression is ~tan^2(delta) ~ 0.13, not exact zero; the
    # residual polarization is still azimuthal (k x z ~ phi-hat).
    assert J_ver[0].max() < 0.2 * J_rad[0].max()
    assert ang_diff(evpa(J_ver), varphis).max() < np.deg2rad(4)
    # fully polarized source (Q_frac=1): DoLP = 1 where I > 0
    dolp = np.sqrt(J_rad[1]**2 + J_rad[2]**2) / np.maximum(J_rad[0], 1e-30)
    assert np.allclose(dolp[J_rad[0] > 1e-12 * J_rad[0].max()], 1.0,
                       atol=1e-3)
    # EVPA winds around the ring: angle(Q + iU) unwraps by 4 pi over one
    # turn (the half-turn EVPA makes two full turns -> double QU loop)
    ang = np.unwrap(np.arctan2(J_rad[2], J_rad[1]))
    wind = (ang[-1] - ang[0]) + (ang[1] - ang[0])  # close the circle
    assert abs(abs(wind) - 4 * np.pi) < 0.5, wind


def test_gelles_schwarzschild_static_symmetry():
    """a=0, static emitter: no frame dragging, so the lensed ring image
    is LEFT-RIGHT symmetric (alpha -> -alpha, varphi -> pi - varphi):
    I and Q even, U odd. (It is NOT up-down symmetric at inc != 0 — the
    far side of the ring lenses to larger apparent radius.)"""
    varphis, _, _, J = _ring_stokes(
        spin=0.0, inc_deg=20.0, req=6.0, beta_v=0.0, chi_deg=0.0,
        b_field=[0.0, 1.0, 0.0], nphi=16)
    order = np.argsort(varphis)
    v, I, Q, U = varphis[order], J[0][order], J[1][order], J[2][order]
    wrap = lambda a: (a + np.pi) % (2 * np.pi) - np.pi
    checked = 0
    for k in range(len(v)):
        mirror = wrap(np.pi - v[k])
        m = np.argmin(np.abs(wrap(v - mirror)))
        if abs(wrap(v[m] - mirror)) > 1e-6 or m == k:
            continue
        checked += 1
        ref = max(abs(I).max(), 1e-12)
        assert abs(I[k] - I[m]) < 5e-3 * ref, (v[k], I[k], I[m])
        assert abs(Q[k] - Q[m]) < 5e-3 * ref
        assert abs(U[k] + U[m]) < 5e-3 * ref
    assert checked >= 8, checked
