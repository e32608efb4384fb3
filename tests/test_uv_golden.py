"""Independent golden checks of the uv-coverage synthesis geometry.

The reference delegates uv generation to ehtim (observation.py:79-119);
ehtim is not in this image, so `empty_eht_obs` is cross-checked against
an INDEPENDENTLY formulated computation (VERDICT r2 next #7):

* GMST from the IAU 1982 polynomial in Julian centuries (vs the USNO
  day-based approximation in observation.gmst_hours);
* (u, v) by rotating the ECEF baseline into the celestial frame with an
  explicit R_z(GST) and projecting onto the RA/dec tangent basis at the
  source (vs the hour-angle trigonometric projection matrix of
  empty_eht_obs).

A conventions bug (hour-angle sign, gmst scaling, baseline orientation,
axis ordering) breaks the agreement; matching to ~arcsecond-level GMST
accuracy pins the geometry.
"""
import numpy as np
import pytest

from bhnerf_jax import observation as obs_lib

ARRAY_PATH = 'eht_arrays/EHT2017.txt'


def gmst_iau1982_hours(mjd, ut_hours):
    """IAU 1982 GMST polynomial (Aoki et al. 1982), independent of
    observation.gmst_hours' USNO day-count form."""
    jd0 = np.floor(mjd) + 2400000.5          # midnight UT
    T = (jd0 - 2451545.0) / 36525.0
    gmst0_sec = (24110.54841 + 8640184.812866 * T + 0.093104 * T**2
                 - 6.2e-6 * T**3)
    gmst_sec = gmst0_sec + 1.00273790935 * ut_hours * 3600.0
    return (gmst_sec / 3600.0) % 24.0


def uv_celestial_frame(xyz_i, xyz_j, gst_rad, ra_rad, dec_rad, lam):
    """(u, v) via the celestial-frame route: rotate the ECEF baseline to
    ECI with R_z(GST), then project onto the (e_RA, e_dec) tangent basis
    of the source direction."""
    B = xyz_j - xyz_i
    c, s = np.cos(gst_rad), np.sin(gst_rad)
    # ECEF -> ECI: a point fixed on Earth at ECEF longitude L sits at
    # right ascension L + GST, i.e. rotate by +GST about z
    B_cel = np.array([c * B[0] - s * B[1],
                      s * B[0] + c * B[1],
                      B[2]])
    e_ra = np.array([-np.sin(ra_rad), np.cos(ra_rad), 0.0])
    e_dec = np.array([-np.sin(dec_rad) * np.cos(ra_rad),
                      -np.sin(dec_rad) * np.sin(ra_rad),
                      np.cos(dec_rad)])
    return np.dot(B_cel, e_ra) / lam, np.dot(B_cel, e_dec) / lam


@pytest.fixture(scope='module')
def obs():
    array = obs_lib.load_txt(ARRAY_PATH)
    return obs_lib.empty_eht_obs(array, nt=6, tint=60.0, tstart=4.0,
                                 tstop=15.5)


def test_gmst_against_iau1982(obs):
    """The two GMST formulations agree to < 0.1 s of time over the
    observation window."""
    for t in obs.times:
        g1 = obs_lib.gmst_hours(obs.mjd, t)
        g2 = gmst_iau1982_hours(obs.mjd, t)
        diff = (g1 - g2 + 12.0) % 24.0 - 12.0
        assert abs(diff) * 3600.0 < 0.1, (t, g1, g2)


def test_uv_against_celestial_frame_projection(obs):
    """Every valid (scan, baseline) uv point matches the independent
    celestial-frame computation to < 1e-6 of the uv radius."""
    lam = obs_lib.C_LIGHT / obs.rf
    ra_rad = obs.ra * 2 * np.pi / 24.0
    dec_rad = np.deg2rad(obs.dec)
    checked = 0
    for s, t in enumerate(obs.times):
        gst = gmst_iau1982_hours(obs.mjd, t) * 2 * np.pi / 24.0
        for b, (i, j) in enumerate(obs.baselines):
            if not obs.mask[s, b]:
                continue
            u_ref, v_ref = uv_celestial_frame(
                obs.array.xyz[i], obs.array.xyz[j], gst, ra_rad, dec_rad,
                lam)
            scale = max(np.hypot(u_ref, v_ref), 1e3)
            assert abs(obs.u[s, b] - u_ref) / scale < 1e-6
            assert abs(obs.v[s, b] - v_ref) / scale < 1e-6
            checked += 1
    assert checked > 50


def test_polar_baseline_invariants():
    """A purely polar baseline has u = 0 always and v = |B| cos(dec)/lam
    — closed-form special case both routes must satisfy."""
    xyz = np.array([[1e6, 2e6, 0.0], [1e6, 2e6, 3e6]])
    array = obs_lib.ArrayConfig(['A', 'B'], xyz, np.array([100.0, 100.0]))
    o = obs_lib.empty_eht_obs(array, nt=4, tint=60.0, tstart=2.0,
                              tstop=20.0, elevmin=-90.0, elevmax=90.01)
    lam = obs_lib.C_LIGHT / o.rf
    np.testing.assert_allclose(o.u, 0.0, atol=1e-6)
    np.testing.assert_allclose(
        o.v, 3e6 * np.cos(np.deg2rad(o.dec)) / lam, rtol=1e-12)
