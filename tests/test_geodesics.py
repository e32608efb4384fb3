"""Golden physics tests for the Kerr geodesic engine.

The reference has no test suite (SURVEY.md §4); these are the closed-form
checks the survey recommends: photon-ring criticality, radial turning
points, Schwarzschild light travel time, conserved-quantity consistency.
"""
import numpy as np
import pytest

from bhnerf_jax import constants
from bhnerf_jax.geodesics import kerr, image_plane_geos, trace_geodesics


@pytest.fixture(scope='module')
def schwarzschild_edge_rays():
    b = np.array([4.0, 5.0, 5.19, 5.21, 6.0, 10.0])
    return b, trace_geodesics(b, np.zeros_like(b), spin=0.0,
                              inclination=np.pi / 2, ngeo=100,
                              distance=1000.0)


def test_photon_ring_critical_impact(schwarzschild_edge_rays):
    """Schwarzschild critical impact parameter is sqrt(27) ~ 5.196."""
    b, geos = schwarzschild_edge_rays
    rmin = geos.r.min(axis=-1)
    captured = rmin < 2.5
    np.testing.assert_array_equal(captured, b < np.sqrt(27.0))


def test_radial_turning_point_matches_R_root(schwarzschild_edge_rays):
    """Turning radius of b=6 ray equals the largest root of R(r)."""
    b, geos = schwarzschild_edge_rays
    roots = np.roots([1, 0, -b[4] ** 2, 2 * b[4] ** 2, 0])
    r_turn = np.max(np.real(roots[np.isreal(roots)]))
    assert abs(geos.r.min(axis=-1)[4] - r_turn) < 2e-3


def test_equatorial_ray_stays_equatorial(schwarzschild_edge_rays):
    _, geos = schwarzschild_edge_rays
    assert np.abs(geos.theta - np.pi / 2).max() < 1e-10


def test_light_travel_time_tortoise():
    """t along a near-radial ray matches the Schwarzschild tortoise coord."""
    geos = trace_geodesics(np.array([0.1]), np.array([0.0]), 0.0,
                           np.pi / 2, ngeo=200, distance=1000.0)
    r, t = geos.r[0], geos.t[0]

    def tortoise(r):
        return r + 2 * np.log(r / 2 - 1)

    t_analytic = -(tortoise(1000.0) - tortoise(r))
    mask = r > 2.5
    assert np.abs(t[mask] - t_analytic[mask]).max() < 0.05


def test_theta_potential_consistency():
    """beta^2 equals Theta(theta_o): screen coords <-> conserved quantities."""
    rng = np.random.default_rng(0)
    alpha = rng.uniform(-10, 10, 16)
    beta = rng.uniform(-10, 10, 16)
    spin, inc = 0.7, np.deg2rad(60)
    import jax
    with jax.enable_x64(True):
        lam, eta = kerr.conserved_quantities(alpha, beta, spin, inc)
        theta_pot = kerr.Theta_potential(np.full(16, inc), spin, lam, eta)
        # the accelerator backend lowers trig at float32 precision even in
        # x64 mode, so the identity only holds to ~1e-6 relative
        np.testing.assert_allclose(np.asarray(theta_pot), beta**2, rtol=1e-5)
        # the trig-free C potential used by the integrator is exact
        c_pot = kerr.C_potential(np.cos(inc), spin,
                                 -alpha * np.sin(inc),
                                 (alpha**2 - spin**2) * np.cos(inc)**2 + beta**2)
        np.testing.assert_allclose(np.asarray(c_pot),
                                   beta**2 * np.sin(inc)**2, rtol=1e-12)


def test_energy_constraint_preserved():
    """(dr/dtau)^2 = R(r) must hold along rays (integrator drift check)."""
    b = np.array([5.5, 7.0])
    geos = trace_geodesics(b, np.array([2.0, -3.0]), spin=0.9,
                           inclination=np.deg2rad(45), ngeo=100,
                           distance=1000.0)
    # finite-difference dr/dtau vs sqrt(R): interior samples, away from stop
    dr = np.gradient(geos.r, axis=-1)
    dm = np.gradient(geos.mino, axis=-1)
    lhs = (dr / dm) ** 2
    rhs = geos.R
    mask = (geos.r > 2.2) & (rhs > 1.0)
    rel = np.abs(lhs[mask] - rhs[mask]) / rhs[mask]
    # central-difference error dominates; median must be small
    assert np.median(rel) < 5e-3


def test_image_plane_geos_shapes():
    geos = image_plane_geos(spin=0.3, inclination=np.deg2rad(30),
                            alpha_range=(-8, 8), beta_range=(-8, 8),
                            ngeo=64, num_alpha=8, num_beta=8, n_fine=2048)
    assert geos.r.shape == (8, 8, 64)
    assert geos.coords.shape == (3, 8, 8, 64)
    assert geos.alpha.shape == (8, 8)
    # mino increases along rays; dtau positive
    assert (np.diff(geos.mino, axis=-1) > 0).all()
    assert (geos.dtau > 0).all()
    # t decreases (backward trace), starts at 0
    np.testing.assert_allclose(geos.t[..., 0], 0.0)
    assert (geos.t[..., -1] < 0.0).all()
    # Sigma/Delta sane
    assert (geos.Sigma > 0).all()


def test_subpixel_randomization_stays_in_pixel():
    rng = np.random.default_rng(3)
    g1 = image_plane_geos(0.0, np.deg2rad(60), (-8, 8), (-8, 8), ngeo=16,
                          num_alpha=8, num_beta=8, n_fine=1024,
                          randomize_subpixel_rays=True, rng=rng)
    g2 = image_plane_geos(0.0, np.deg2rad(60), (-8, 8), (-8, 8), ngeo=16,
                          num_alpha=8, num_beta=8, n_fine=1024)
    psize = 16 / 7
    assert np.abs(g1.alpha - g2.alpha).max() <= psize / 2
    assert not np.allclose(g1.alpha, g2.alpha)


def test_geodesics_fuzz_invariants():
    """Random (spin, inclination, screen points): basic invariants hold
    for every traced ray."""
    rng = np.random.default_rng(42)
    for _ in range(4):
        spin = rng.uniform(0.0, 0.95)
        inc = rng.uniform(np.deg2rad(5), np.deg2rad(85))
        alpha = rng.uniform(-12, 12, 24)
        beta = rng.uniform(-12, 12, 24)
        geos = trace_geodesics(alpha, beta, spin, inc, ngeo=48,
                               n_fine=2048)
        r_h = 1 + np.sqrt(1 - spin**2)
        assert np.isfinite(geos.r).all() and np.isfinite(geos.t).all()
        assert np.isfinite(geos.phi).all()
        assert (geos.r >= r_h).all()
        assert (geos.r <= geos.r_o * (1 + 1e-6)).all()
        assert (geos.t <= 1e-9).all()
        assert (np.diff(geos.mino, axis=-1) > 0).all()
        assert (geos.Sigma > 0).all() and (geos.Xi > 0).all()
        # theta stays within a hemisphere band around the initial value
        # only for equatorial-symmetric potentials; just require validity
        assert np.isfinite(geos.theta).all()


def test_geodesics_save_load(tmp_path):
    geos = trace_geodesics(np.array([5.0, 7.0]), np.array([1.0, -2.0]),
                           0.5, np.deg2rad(45), ngeo=16, n_fine=512)
    path = tmp_path / 'geos.npz'
    geos.save(path)
    from bhnerf_jax.geodesics import Geodesics
    loaded = Geodesics.load(path)
    np.testing.assert_array_equal(loaded.r, geos.r)
    np.testing.assert_array_equal(loaded.t, geos.t)
    assert loaded.spin == geos.spin and loaded.inc == geos.inc


def test_isco_closed_forms():
    """Bardeen ISCO formulas (reference constants.py:7-10)."""
    assert abs(constants.isco_pro(0.0) - 6.0) < 1e-12
    assert abs(constants.isco_retro(0.0) - 6.0) < 1e-12
    assert abs(constants.isco_pro(1.0) - 1.0) < 1e-6
    assert abs(constants.isco_retro(1.0) - 9.0) < 1e-6
    assert abs(constants.isco_pro(0.5) - 4.233) < 1e-3


def test_weak_field_deflection():
    """Large-impact-parameter rays bend by the Einstein angle 4M/b."""
    b = np.array([50.0, 100.0, 200.0])
    geos = trace_geodesics(b, np.zeros_like(b), spin=0.0,
                           inclination=np.pi / 2, ngeo=400,
                           distance=1000.0, tau_max=0.1, n_fine=8192)
    # the turn of the (x, y) propagation direction between the two
    # asymptotic ends is the Einstein deflection angle
    x, y = geos.x, geos.y
    v_in = np.stack([x[:, 1] - x[:, 0], y[:, 1] - y[:, 0]], -1)
    v_out = np.stack([x[:, -1] - x[:, -2], y[:, -1] - y[:, -2]], -1)
    cross = v_in[:, 0] * v_out[:, 1] - v_in[:, 1] * v_out[:, 0]
    dot = (v_in * v_out).sum(-1)
    deflection = np.abs(np.arctan2(cross, dot))
    np.testing.assert_allclose(deflection, 4.0 / b, rtol=0.15)


def test_kerr_frame_dragging_direction():
    """Spin drags prograde photon-ring asymmetry: rays at alpha>0 and
    alpha<0 see different effective potentials for a>0."""
    b = np.array([-5.5, 5.5])
    geos = trace_geodesics(b, np.zeros(2), spin=0.9,
                           inclination=np.pi / 2, ngeo=64, distance=1000.0)
    rmin = geos.r.min(axis=-1)
    # one side captured, other side escapes for a=0.9 at |b|=5.5
    assert (rmin < 2.0).any() and (rmin > 2.5).any()


def gl2019_critical_curve(spin, inc, n=24):
    """Analytic Kerr critical curve (Gralla & Lupsasca 2019, eqs. 38-40),
    computed independently in numpy: spherical-photon-orbit conserved
    quantities lambda(r~), eta(r~) mapped to screen coordinates.

    Returns (alpha, beta) arrays (upper half; the curve is beta-symmetric).
    """
    a = spin
    r_minus = 2.0 * (1.0 + np.cos(2.0 / 3.0 * np.arccos(-a)))  # prograde
    r_plus = 2.0 * (1.0 + np.cos(2.0 / 3.0 * np.arccos(a)))    # retrograde
    rt = np.linspace(r_minus + 1e-9, r_plus - 1e-9, 400)
    Delta = rt**2 - 2.0 * rt + a**2
    lam = a + rt / a * (rt - 2.0 * Delta / (rt - 1.0))
    eta = rt**3 / a**2 * (4.0 * Delta / (rt - 1.0)**2 - rt)
    sin_i, cos_i = np.sin(inc), np.cos(inc)
    alpha = -lam / sin_i
    beta_sq = eta + a**2 * cos_i**2 - lam**2 * cos_i**2 / sin_i**2
    keep = beta_sq > 1e-6
    alpha, beta = alpha[keep], np.sqrt(beta_sq[keep])
    # resample uniformly in curve angle about the centroid
    a0 = alpha.mean()
    ang = np.arctan2(beta, alpha - a0)
    order = np.argsort(ang)
    pick = np.linspace(0, len(alpha) - 1, n).astype(int)
    return alpha[order][pick], beta[order][pick]


def test_kerr_critical_curve_a094():
    """Golden cross-validation of the a=0.94 Kerr engine: rays 1% inside
    the analytic GL2019 critical curve are captured, rays 1% outside
    escape — pinning the spin-dependent critical impact parameters of the
    RK4 integrator against independent analytic values (VERDICT r1
    missing #3; reference rides the analytic kgeo engine, kgeo.py:61-62).
    """
    spin, inc = 0.94, np.deg2rad(60.0)
    alpha_c, beta_c = gl2019_critical_curve(spin, inc, n=16)
    a0 = alpha_c.mean()  # scale about the shadow centroid

    def scaled(s):
        return a0 + s * (alpha_c - a0), s * beta_c

    ain, bin_ = scaled(0.99)
    aout, bout = scaled(1.01)
    geos = trace_geodesics(
        np.concatenate([ain, aout]), np.concatenate([bin_, bout]),
        spin, inc, ngeo=64, n_fine=16384, tau_max=6.0)
    r_min = np.asarray(geos.r).min(axis=-1)
    r_hor = 1.0 + np.sqrt(1.0 - spin**2)
    captured = r_min < 1.2 * r_hor
    n = len(alpha_c)
    assert captured[:n].all(), (
        f'inside-critical rays escaped: r_min={r_min[:n]}')
    assert not captured[n:].any(), (
        f'outside-critical rays captured: r_min={r_min[n:]}')


def test_kerr_photon_shell_radii_a094():
    """Near-critical rays linger at the analytic spherical-photon-orbit
    radius: for the two equatorial-plane crossings of the critical curve,
    the minimum radius approaches the prograde/retrograde photon radii
    2M(1 + cos(2/3 arccos(-/+ a)))."""
    spin, inc = 0.94, np.deg2rad(90.0)  # edge-on: beta=0 points equatorial
    a = spin
    r_pro = 2.0 * (1.0 + np.cos(2.0 / 3.0 * np.arccos(-a)))
    r_ret = 2.0 * (1.0 + np.cos(2.0 / 3.0 * np.arccos(a)))
    # equatorial photon orbits: eta=0 -> beta=0; lambda at r~
    for r_ph, direction in ((r_pro, 'pro'), (r_ret, 'ret')):
        Delta = r_ph**2 - 2.0 * r_ph + a**2
        lam = a + r_ph / a * (r_ph - 2.0 * Delta / (r_ph - 1.0))
        alpha_crit = -lam / np.sin(inc)
        # just outside critical: the radial turning point approaches the
        # photon radius from above like sqrt(s - 1)
        r_mins = []
        for s in (1.0005, 1.002, 1.01):
            geos = trace_geodesics(
                np.array([alpha_crit * s]), np.array([1e-6]), spin, inc,
                ngeo=64, n_fine=16384, tau_max=6.0)
            r_mins.append(float(np.asarray(geos.r).min()))
        assert r_mins[0] > r_ph, (direction, r_mins, r_ph)      # from above
        assert r_mins[0] < r_mins[1] < r_mins[2], (direction, r_mins)
        assert abs(r_mins[0] - r_ph) / r_ph < 0.03, (direction, r_mins,
                                                     r_ph)


def test_rho_of_req_unreachable_radius_is_nan():
    """req outside the reachable crossing-radius window must come back
    NaN, not the existence-window boundary (the bisection bracket also
    forms at the window edge)."""
    from bhnerf_jax.geodesics.equatorial import rho_of_req
    varphis = np.linspace(-np.pi, np.pi, 4)
    # req inside the Schwarzschild horizon: no first crossing lands there
    _, rho_bad = rho_of_req(0.0, np.deg2rad(80), req=1.0, mbar=0,
                            varphis=varphis, ngeo=128)
    assert np.isnan(rho_bad).all(), rho_bad
    # a reachable radius still solves
    _, rho_ok = rho_of_req(0.0, np.deg2rad(80), req=6.0, mbar=0,
                           varphis=varphis, ngeo=128)
    assert np.isfinite(rho_ok).all(), rho_ok


def test_geodesics_properties_stay_float64_host():
    """Derived metric properties are host numpy float64 (a jnp call on
    f64 input silently becomes f32 on the default backend)."""
    from bhnerf_jax.geodesics import trace_geodesics
    b = np.linspace(3, 8, 4)
    geos = trace_geodesics(b, np.zeros_like(b), 0.5, np.deg2rad(60),
                           ngeo=16, n_fine=512)
    for name in ('Sigma', 'Delta', 'Xi', 'omega', 'Theta', 'R'):
        val = getattr(geos, name)
        assert isinstance(val, np.ndarray), name
        assert val.dtype == np.float64, (name, val.dtype)
    assert geos.keplerian_omega().dtype == np.float64


def test_trace_rejects_nonunit_mass():
    from bhnerf_jax.geodesics import trace_geodesics
    with pytest.raises(ValueError, match='M=E=1'):
        trace_geodesics(np.array([5.0]), np.array([0.0]), 0.0,
                        np.deg2rad(60), M=2.0)


@pytest.mark.parametrize('spin,inc_deg', [(0.94, 60), (0.5, 20),
                                          (0.0, 85)])
def test_device_backend_f32_trace_matches_f64(spin, inc_deg):
    """backend='device' (f32, accelerator path — CPU backend under the
    test config) tracks the f64 host trace across the spin/inclination
    envelope: geometry to ~1e-3 M away from the critical curve, and the
    Kahan-corrected coordinate time to ~1e-3 M even though t itself
    reaches O(r_o)."""
    from bhnerf_jax.geodesics import image_plane_geos

    kw = dict(spin=spin, inclination=np.deg2rad(inc_deg),
              alpha_range=(-8, 8), beta_range=(-8, 8), ngeo=24,
              num_alpha=12, num_beta=12, n_fine=2048)
    g64 = image_plane_geos(**kw)
    g32 = image_plane_geos(**kw, backend='device')
    assert g32.r.dtype == np.float32
    assert g32.t.dtype == np.float64        # Kahan-corrected, folded f64

    # rays near the critical curve are exponentially sensitive — a few
    # may diverge in f32; the bulk must agree tightly
    dr = np.abs(g32.r - g64.r) / np.maximum(g64.r, 1.0)
    dth = np.abs(g32.theta - g64.theta)
    dt = np.abs(g32.t - g64.t)
    assert np.quantile(dr, 0.9) < 1e-4, np.quantile(dr, 0.9)
    assert np.quantile(dth, 0.9) < 1e-3, np.quantile(dth, 0.9)
    assert np.quantile(dt, 0.9) < 1e-3, np.quantile(dt, 0.9)
    assert np.median(dt) < 2e-4, np.median(dt)

    # IN-DOMAIN guarantee (the bound consumers actually rely on): every
    # sample inside the emission domain (r <= fov) tracks t to < 1 M.
    # The raw max over ALL samples can be enormous (observed 5e1 on
    # chip, 5e2 on CPU at 48^2): far-field segments (r ~ 700+) of
    # near-critical rays diverge exponentially in f32, but the domain
    # mask (CompactRayArgs / emission interpolation cut at rmax) kills
    # them before t_geos is ever used in the warp.
    # The mask MUST be the f32 table's own radii — that is the gate the
    # consumers apply in the device-trace workflow. A diverged f32
    # sample whose f32 r wandered back under rmax WOULD be consumed, so
    # it must be covered by (and fail) this bound, not excluded by an
    # f64-truth mask it never sees.
    in_dom = np.asarray(g32.r) <= 16.0
    assert dt[in_dom].max() < 1.0, dt[in_dom].max()
    assert np.quantile(dt[in_dom], 0.99) < 1e-2
    # and the f32 gate must not admit samples that are truly far-field
    # (divergent re-entry): f32-in-domain while f64 says r > 2*rmax
    reentry = in_dom & (np.asarray(g64.r) > 32.0)
    assert not reentry.any(), (
        f'{int(reentry.sum())} diverged f32 samples re-entered the '
        f'domain gate (true r > 32 M)')


def test_device_backend_f32_lightcurve_matches():
    """End-to-end criterion for chi^2 scans on device-traced tables: the
    forward hotspot lightcurve from the f32 table matches the f64 one
    to well under the scan's discriminating power (<1%)."""
    from bhnerf_jax import constants, emission, units
    from bhnerf_jax.geodesics import image_plane_geos

    fov = 16.0
    kw = dict(spin=0.2, inclination=np.deg2rad(60),
              alpha_range=(-fov / 2, fov / 2),
              beta_range=(-fov / 2, fov / 2), ngeo=24,
              num_alpha=16, num_beta=16, n_fine=2048)
    g64 = image_plane_geos(**kw)
    g32 = image_plane_geos(**kw, backend='device')

    hs = emission.generate_hotspot(
        resolution=(24, 24, 24), rot_axis=[0, 0, 1], rot_angle=0.0,
        orbit_radius=6.0, std=0.7,
        r_isco=float(constants.isco_pro(0.2)), fov=fov)
    GM_hr = constants.GM_c3(constants.sgra_mass).to('hr').value
    t_frames = units.Quantity(
        np.linspace(0, 150 * GM_hr, 8).astype(np.float32), 'hr')
    t_inj = -float(g64.r_o + fov / 4)

    lcs = []
    for g in (g64, g32):
        Omega = float(1 / 6.0 ** 1.5)
        movie = np.asarray(emission.image_plane_dynamics(
            hs, g, Omega, t_frames, t_injection=t_inj))
        lcs.append(movie.sum(axis=(-1, -2)))
    rel = np.abs(lcs[1] - lcs[0]).max() / np.abs(lcs[0]).mean()
    assert rel < 1e-2, rel
