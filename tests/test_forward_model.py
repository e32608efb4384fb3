"""Forward-model physics tests: Doppler, velocity warp, hotspot lightcurve.

Closed-loop checks modeled on the reference's notebook-driven validation
(SURVEY.md §4): an orbiting hotspot must produce a periodically-modulated
lightcurve with Doppler asymmetry.
"""
import numpy as np
import pytest

from bhnerf_jax import constants, emission, units, utils
from bhnerf_jax.geodesics import image_plane_geos
from bhnerf_jax.ops import gr


@pytest.fixture(scope='module')
def geos():
    return image_plane_geos(spin=0.2, inclination=np.deg2rad(60),
                            alpha_range=(-10, 10), beta_range=(-10, 10),
                            ngeo=64, num_alpha=32, num_beta=32, n_fine=4096)


def test_doppler_factor_asymmetry(geos):
    """Approaching side blue-shifted (g > 1), receding side red-shifted."""
    Omega = geos.keplerian_omega()
    umu = gr.azimuthal_velocity_vector(geos, Omega)
    g = np.asarray(gr.doppler_factor(geos, umu))
    assert np.isfinite(g).all()
    # equatorial samples at r ~ 6-8 M on both sides of the spin axis
    mask = (np.abs(geos.z) < 0.5) & (geos.r > 6) & (geos.r < 8)
    g_pos = g[mask & (geos.y > 3)]
    g_neg = g[mask & (geos.y < -3)]
    assert g_pos.size and g_neg.size
    # one side boosted above 1, the other suppressed below
    hi, lo = max(g_pos.mean(), g_neg.mean()), min(g_pos.mean(), g_neg.mean())
    assert hi > 1.02 and lo < 0.98


def test_doppler_static_observer_gravitational_redshift(geos):
    """Omega=0: pure gravitational redshift, g < 1 everywhere, g -> 1 far."""
    umu = gr.azimuthal_velocity_vector(geos, 0.0)
    g = np.asarray(gr.doppler_factor(geos, umu))
    inner = (geos.r > 3) & (geos.r < 5)
    outer = geos.r > 500
    assert (g[inner] < 0.95).all()
    assert np.allclose(g[outer], 1.0, atol=5e-3)


def test_wave_vector_null(geos):
    """k_mu must be null: g^munu k_mu k_nu = 0."""
    k = np.asarray(gr.wave_vector(geos))
    ginv = gr.inv_metric_components(geos.r, geos.theta, geos.spin)
    k_up = np.asarray(gr.raise_or_lower_indices(
        {k2: np.asarray(v) for k2, v in ginv.items()}, k))
    norm = (k * k_up).sum(-1)
    scale = (np.abs(k) * np.abs(k_up)).sum(-1)
    mask = geos.r < 100
    assert np.median(np.abs(norm[mask]) / scale[mask]) < 1e-4


def test_velocity_warp_rotates_back():
    """A point at angle Omega*t must warp back to its t=0 position."""
    coords = np.zeros((3, 1)); coords[:, 0] = [6.0, 0.0, 0.0]
    Omega = 0.1
    t = 5.0
    # rotate the point forward by Omega*t, warp should rotate it back
    ang = Omega * t
    pt = np.array([[6 * np.cos(ang)], [6 * np.sin(ang)], [0.0]])
    warped = emission.velocity_warp_coords(
        pt, Omega, t_frames=t, t_start_obs=0.0, t_geos=0.0, t_injection=0.0)
    np.testing.assert_allclose(np.asarray(warped)[..., :2].ravel(),
                               [6.0, 0.0], atol=1e-4)


def test_velocity_warp_pre_injection_masked():
    coords = np.ones((3, 4))
    warped, valid = emission.velocity_warp_coords(
        coords, 0.1, t_frames=1.0, t_start_obs=0.0, t_geos=0.0,
        t_injection=5.0, return_mask=True)
    assert not np.asarray(valid).any()
    assert np.isfinite(np.asarray(warped)).all()
    warped_nan = emission.velocity_warp_coords(
        coords, 0.1, t_frames=1.0, t_start_obs=0.0, t_geos=0.0,
        t_injection=5.0)
    assert np.isnan(np.asarray(warped_nan)).all()


def test_hotspot_lightcurve_modulation(geos):
    """Orbiting hotspot produces a periodic, Doppler-asymmetric lightcurve
    (the reference Tutorial2 / Synthetic-lightcurves-0 workflow)."""
    spin = geos.spin
    r_isco = float(constants.isco_pro(spin))
    hotspot = emission.generate_hotspot(
        resolution=(48, 48, 48), rot_axis=[0, 0, 1], rot_angle=0.0,
        orbit_radius=6.5, std=0.6, r_isco=r_isco, fov=20.0)
    # constant Omega (rigid rotation): the differential Keplerian field
    # shears the blob, so only rigid rotation gives exact periodicity
    Omega = float(np.sqrt(1.0) / (6.5 ** 1.5 + spin))
    T_M = 2 * np.pi / Omega
    GM_c3_hr = constants.GM_c3(constants.sgra_mass).to('hr').value
    t_frames = units.Quantity(np.linspace(0, T_M * GM_c3_hr, 16), 'hr')

    # injection far before the earliest retarded time of any emission-region
    # sample, so the whole scene is causally connected from frame 0 (the
    # reference convention -(r_o + fov/4) instead produces a physical
    # slow-light switch-on transient, which would confound the periodicity
    # check below)
    movie = np.asarray(emission.image_plane_dynamics(
        hotspot, geos, Omega, t_frames, t_injection=-float(geos.r_o + 200.0),
        t_start_obs=t_frames[0]))
    assert movie.shape == (16, 32, 32)
    assert np.isfinite(movie).all() and (movie >= 0).all()
    lc = movie.sum(axis=(-1, -2))
    assert lc.min() > 0
    # Doppler beaming: significant modulation over the orbit
    assert lc.max() / lc.min() > 1.5
    # periodicity: first and last frame (full orbit apart) nearly equal
    assert abs(lc[0] - lc[-1]) / lc.max() < 0.12


def test_fill_unsupervised_emission():
    coords = np.mgrid[-4:4:9j, -4:4:9j, -4:4:9j]
    em = np.ones(coords.shape[1:])
    out = np.asarray(emission.fill_unsupervised_emission(
        em, coords, rmin=2.0, rmax=3.5, z_width=1.0))
    r = np.sqrt((coords**2).sum(0))
    assert (out[r < 2.0] == 0).all()
    assert (out[r > 3.5] == 0).all()
    assert (out[np.abs(coords[2]) > 1.0] == 0).all()
    keep = (r > 2.0) & (r < 3.5) & (np.abs(coords[2]) <= 1.0)
    assert (out[keep] == 1).all()


def test_rotate_evpa_invariants():
    rng = np.random.default_rng(0)
    stokes = rng.normal(size=(3, 10))
    rot = np.asarray(emission.rotate_evpa(stokes, 0.3))
    # I unchanged, P magnitude preserved
    np.testing.assert_allclose(rot[0], stokes[0], rtol=1e-6)
    np.testing.assert_allclose(rot[1] ** 2 + rot[2] ** 2,
                               stokes[1] ** 2 + stokes[2] ** 2, rtol=1e-5)
    # rotation by pi is identity (EVPA is mod pi)
    full = np.asarray(emission.rotate_evpa(stokes, np.pi))
    np.testing.assert_allclose(full, stokes, atol=1e-5)


def test_parallel_transport_shapes_and_finiteness(geos):
    Omega = geos.keplerian_omega()
    umu = gr.azimuthal_velocity_vector(geos, Omega)
    g = gr.doppler_factor(geos, umu)
    b = gr.magnetic_field_fluid_frame(geos, umu, arad=0.0, avert=1.0,
                                      ator=0.0)
    J = np.nan_to_num(np.asarray(gr.parallel_transport(
        geos, umu, g, b, Q_frac=0.85, V_frac=0.0)), nan=0.0)
    assert J.shape == (3, 32, 32, 64)
    # linear polarization fraction respects Q_frac
    P = np.sqrt(J[1] ** 2 + J[2] ** 2)
    assert (P <= 0.85 * J[0] * (1 + 1e-5) + 1e-12).all()


def test_radiative_transfer_linearity(geos):
    em = np.ones_like(geos.r)
    img1 = np.asarray(gr.radiative_transfer(em, 1.0, geos.dtau, geos.Sigma))
    img2 = np.asarray(gr.radiative_transfer(2 * em, 1.0, geos.dtau,
                                            geos.Sigma))
    np.testing.assert_allclose(2 * img1, img2, rtol=1e-6)
    assert img1.shape == (32, 32)


def test_image_plane_dynamics_frame_chunking_equality(geos):
    """Eager frame-chunked movie renders (the OOM guard for production
    npix: the un-jitted warp materializes (3, 3, nt, N) temporaries)
    match the single-shot path exactly, for both a static 3D field and
    a movie-valued emission, including the t_start_obs pinning."""
    r_isco = float(constants.isco_pro(geos.spin))
    field = emission.generate_hotspot(
        resolution=(24, 24, 24), rot_axis=[0, 0, 1], rot_angle=0.0,
        orbit_radius=1.2 * r_isco, std=0.7, r_isco=r_isco, fov=20.0)
    Omega = geos.keplerian_omega()
    t_frames = units.Quantity(np.linspace(0.0, 0.7, 5), 'hr')
    t_inj = -float(geos.r_o + 5.0)

    one = np.asarray(emission.image_plane_dynamics(
        field, geos, Omega, t_frames, t_inj, frame_chunk=5))
    chunked = np.asarray(emission.image_plane_dynamics(
        field, geos, Omega, t_frames, t_inj, frame_chunk=2))
    assert one.shape == chunked.shape == (5, 32, 32)
    np.testing.assert_array_equal(one, chunked)

    # movie emission: each frame interpolates its own 3D field slice
    movie_field = utils.Grid3D(
        np.stack([field.data * (1 + 0.1 * i) for i in range(5)]),
        field.start, field.stop)
    one_m = np.asarray(emission.image_plane_dynamics(
        movie_field, geos, Omega, t_frames, t_inj, frame_chunk=5))
    chunked_m = np.asarray(emission.image_plane_dynamics(
        movie_field, geos, Omega, t_frames, t_inj, frame_chunk=2))
    np.testing.assert_array_equal(one_m, chunked_m)
    assert not np.array_equal(one_m, one)
