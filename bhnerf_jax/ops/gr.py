"""General-relativistic physics operators on geodesic bundles.

JAX rebuild of the tensor-algebra layer of the reference
(bhnerf/kgeo.py:65-622). The math is identical physics; the implementation
differs structurally:

* vectors are stacked jnp arrays with a trailing mu axis (shape (..., 4))
  instead of xarray concat objects; tetrads are (..., 4, 4) with layout
  [mu_coordinate, a_frame] = (e_a)^mu — matching the reference's effective
  memory layout (kgeo.py:355);
* momentum signs come exactly from the integrator state (Geodesics.pm_r /
  pm_th) rather than finite-differencing r and affine along the stored ray
  (reference kgeo.py:107-108), which is noisy at turning points;
* everything is jit-compatible and dtype-polymorphic.

These run once per model configuration (host or device) to freeze the
ray-tracing constants consumed by the training hot loop.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from bhnerf_jax import utils


def metric_components(r, theta, spin, M=1.0):
    """Boyer-Lindquist metric g_munu non-zero components
    (reference kgeo.py:118-143)."""
    Sigma = r**2 + spin**2 * jnp.cos(theta) ** 2
    Delta = r**2 - 2 * M * r + spin**2
    Xi = (r**2 + spin**2) ** 2 - spin**2 * Delta * jnp.sin(theta) ** 2
    return {
        'tt': -(1 - 2 * M * r / Sigma),
        'rr': Sigma / Delta,
        'thth': Sigma,
        'phph': Xi * jnp.sin(theta) ** 2 / Sigma,
        'tph': -2 * M * spin * r * jnp.sin(theta) ** 2 / Sigma,
    }


def inv_metric_components(r, theta, spin, M=1.0):
    """Inverse metric g^munu non-zero components (reference kgeo.py:145-171)."""
    Sigma = r**2 + spin**2 * jnp.cos(theta) ** 2
    Delta = r**2 - 2 * M * r + spin**2
    return {
        'tt': -((r**2 + spin**2) ** 2
                - spin**2 * Delta * jnp.sin(theta) ** 2) / (Delta * Sigma),
        'rr': Delta / Sigma,
        'thth': 1 / Sigma,
        'phph': (Delta - spin**2 * jnp.sin(theta) ** 2)
                / (Delta * Sigma * jnp.sin(theta) ** 2),
        'tph': -2 * M * spin * r / (Delta * Sigma),
    }


def raise_or_lower_indices(g, u):
    """Contract a 4-vector with (inverse) metric components
    (reference kgeo.py:173-197). u shape (..., 4)."""
    return jnp.stack([
        g['tt'] * u[..., 0] + g['tph'] * u[..., 3],
        g['rr'] * u[..., 1],
        g['thth'] * u[..., 2],
        g['phph'] * u[..., 3] + g['tph'] * u[..., 0],
    ], axis=-1)


def wave_vector(geos):
    """Covariant photon momentum k_mu along rays (reference kgeo.py:91-116).

    Uses the integrator's exact momentum signs instead of gradient-based
    sign recovery. Returns shape (..., 4): [k_t, k_r, k_th, k_ph].
    """
    E = geos.E
    R = jnp.clip(jnp.asarray(geos.R), 0.0, None)
    Th = jnp.clip(jnp.asarray(geos.Theta), 0.0, None)
    Delta = jnp.asarray(geos.Delta)
    k_t = jnp.broadcast_to(jnp.asarray(-E, Delta.dtype), Delta.shape)
    k_r = E * jnp.sqrt(R) * jnp.asarray(geos.pm_r) / Delta
    k_th = E * jnp.sqrt(Th) * jnp.asarray(geos.pm_th)
    k_ph = E * jnp.broadcast_to(jnp.asarray(geos.lam)[..., None], Delta.shape)
    return jnp.stack([k_t, k_r, k_th, k_ph], axis=-1)


def azimuthal_velocity_vector(geos, Omega):
    """Contravariant u^mu for circular azimuthal flow with angular velocity
    Omega (reference kgeo.py:199-223). Returns (..., 4)."""
    g = metric_components(jnp.asarray(geos.r), jnp.asarray(geos.theta),
                          geos.spin, geos.M)
    Omega = jnp.asarray(Omega)
    denom = -(g['tt'] + 2 * Omega * g['tph'] + g['phph'] * Omega**2)
    # denom <= 0 outside the allowed circular-orbit region (e.g. inside the
    # ergosphere for large Omega): mark with ut = nan like the reference's
    # sqrt of a negative, then let doppler_factor fillna
    ut = 1.0 / jnp.sqrt(denom)
    zeros = jnp.zeros_like(ut)
    return jnp.stack([ut, zeros, zeros, ut * Omega], axis=-1)


def doppler_factor(geos, umu, fillna=0.0):
    """Doppler boost g = E / (-k.u)  (reference kgeo.py:225-248)."""
    k_mu = wave_vector(geos)
    kdotu = jnp.sum(k_mu * umu, axis=-1)
    g = geos.E / -kdotu
    if fillna is not None and fillna is not False:
        g = jnp.nan_to_num(g, nan=fillna, posinf=fillna, neginf=fillna)
    return g


def zamo_frame_velocity(geos, beta, chi):
    """Boosted-ZAMO velocity parameterization (reference kgeo.py:408-436,
    Gelles et al. 2021). Returns contravariant u^mu, shape (..., 4)."""
    r = jnp.asarray(geos.r)
    Xi = jnp.asarray(geos.Xi)
    Delta = jnp.asarray(geos.Delta)
    om = jnp.asarray(geos.omega)
    gamma = 1 / jnp.sqrt(1 - beta**2)
    ut = (gamma / r) * jnp.sqrt(Xi / Delta)
    ur = (beta * gamma * jnp.cos(chi) / r) * jnp.sqrt(Delta)
    uth = jnp.zeros_like(ut)
    uph = ut * om + r * beta * gamma * jnp.sin(chi) / jnp.sqrt(Xi)
    return jnp.stack([ut, ur, uth, uph], axis=-1)


def fluid_frame_tetrad(geos, umu):
    """Orthonormal tetrad comoving with u^mu (reference kgeo.py:320-356).

    Returns (..., 4, 4) with [mu, a] layout: column a holds the coordinate
    components (e_a)^mu of frame vector a in (t, r, th, ph) order.
    """
    g = metric_components(jnp.asarray(geos.r), jnp.asarray(geos.theta),
                          geos.spin, geos.M)
    u_mu = raise_or_lower_indices(g, umu)
    uu = u_mu * umu  # componentwise, (..., 4)

    u0u0, u1u1, u2u2, u3u3 = (uu[..., i] for i in range(4))
    N_r = jnp.sqrt(-g['rr'] * (u0u0 + u3u3) * (1 + u2u2))
    N_th = jnp.sqrt(g['thth'] * (1 + u2u2))
    N_ph = jnp.sqrt(-(u0u0 + u3u3) * jnp.asarray(geos.Delta)
                    * jnp.sin(jnp.asarray(geos.theta)) ** 2)

    zeros = jnp.zeros_like(u0u0)
    e_t = -umu
    e_r = jnp.stack([u_mu[..., 1] * umu[..., 0], -(u0u0 + u3u3), zeros,
                     u_mu[..., 1] * umu[..., 3]], axis=-1) / N_r[..., None]
    e_th = jnp.stack([u_mu[..., 2] * umu[..., 0], u_mu[..., 2] * umu[..., 1],
                      1 + u2u2, u_mu[..., 2] * umu[..., 3]],
                     axis=-1) / N_th[..., None]
    e_ph = jnp.stack([u_mu[..., 3], zeros, zeros, -u_mu[..., 0]],
                     axis=-1) / N_ph[..., None]
    return jnp.stack([e_t, e_r, e_th, e_ph], axis=-1)


def zamo_frame_tetrad(geos, beta, chi):
    """Boosted-ZAMO tetrad, Gelles2021 Eq. A4 with the reference's
    right-handed theta-down convention (reference kgeo.py:358-406).
    Returns (..., 4, 4) in [mu, a] layout."""
    r = jnp.asarray(geos.r)
    Xi = jnp.asarray(geos.Xi)
    Delta = jnp.asarray(geos.Delta)
    om = jnp.asarray(geos.omega)
    gamma = 1 / jnp.sqrt(1 - beta**2)
    cos_c, sin_c = jnp.cos(chi), jnp.sin(chi)
    sqXD = jnp.sqrt(Xi / Delta)
    sqD = jnp.sqrt(Delta)
    zeros = jnp.zeros_like(r)

    e_t = jnp.stack([
        (gamma / r) * sqXD,
        (beta * gamma * cos_c / r) * sqD,
        zeros,
        (gamma * om / r) * sqXD + r * beta * gamma * sin_c / jnp.sqrt(Xi),
    ], axis=-1)
    e_r = jnp.stack([
        (beta * gamma * cos_c / r) * sqXD,
        ((1 + (gamma - 1) * cos_c**2) / r) * sqD,
        zeros,
        beta * gamma * om * cos_c / r * sqXD
        + r * (gamma - 1) * cos_c * sin_c / jnp.sqrt(Xi),
    ], axis=-1)
    e_th = jnp.stack([zeros, zeros, 1 / r, zeros], axis=-1)
    e_ph = jnp.stack([
        (beta * gamma * sin_c / r) * sqXD,
        ((gamma - 1) * cos_c * sin_c / r) * sqD,
        zeros,
        beta * om * sin_c * (gamma / r) * sqXD
        + r * ((gamma - 1) * sin_c**2 + 1) / jnp.sqrt(Xi),
    ], axis=-1)
    return jnp.stack([e_t, e_r, e_th, e_ph], axis=-1)


def transform_coordinates(v, tetrad, contraction):
    """Frame <-> coordinate transformation (reference kgeo.py:65-89).

    tetrad layout (..., mu, a). 'upper': v'_a = sum_mu (e_a)^mu v_mu
    (coordinate covector -> frame components). 'lower': v^mu = sum_a
    v_a (e_a)^mu (frame components -> coordinate vector).
    """
    if contraction == 'upper':
        return jnp.einsum('...ma,...m->...a', tetrad, v)
    if contraction == 'lower':
        return jnp.einsum('...ma,...a->...m', tetrad, v)
    raise ValueError("contraction must be 'upper' or 'lower'")


def magnetic_field_fluid_frame(geos, umu, arad, avert, ator):
    """Lab-frame constant-geometry B-field boosted to the fluid frame
    (reference kgeo.py:274-318). Returns spatial frame components (..., 3)."""
    theta = jnp.asarray(geos.theta)
    Br = arad * jnp.sin(theta) + avert * jnp.cos(theta)
    Bth = avert * (-jnp.sin(theta))
    Bph = ator * jnp.ones_like(theta)

    g = metric_components(jnp.asarray(geos.r), theta, geos.spin, geos.M)
    u_mu = raise_or_lower_indices(g, umu)
    e_mu = fluid_frame_tetrad(geos, umu)

    b0 = Br * u_mu[..., 1] + Bth * u_mu[..., 2] + Bph * u_mu[..., 3]
    b1 = (Br + b0 * u_mu[..., 1]) / u_mu[..., 0]
    b2 = (Bth + b0 * u_mu[..., 2]) / u_mu[..., 0]
    b3 = (Bph + b0 * u_mu[..., 3]) / u_mu[..., 0]
    b_mu = jnp.stack([
        g['tt'] * b0 + g['tph'] * b3,
        g['rr'] * b1,
        g['thth'] * b2,
        g['phph'] * b3 + g['tph'] * b0,
    ], axis=-1)
    return transform_coordinates(b_mu, e_mu, 'upper')[..., 1:]


def _parallel_transport_core(geos, e_mu, g, b, Q_frac, V_frac, spectral_index):
    """Shared core of the fluid-frame / ZAMO parallel transport paths
    (reference kgeo.py:438-519 and kgeo.py:521-593)."""
    theta = jnp.asarray(geos.theta)
    r = jnp.asarray(geos.r)
    spin = geos.spin

    k_mu = wave_vector(geos)
    k_prime = transform_coordinates(k_mu, e_mu, 'upper')[..., 1:]
    k_mag = jnp.sqrt(jnp.sum(k_prime**2, axis=-1))
    f_local = jnp.cross(k_prime, b, axis=-1) / k_mag[..., None]

    # local EVPA vector back to global (contravariant) coordinates
    f_padded = jnp.concatenate(
        [jnp.zeros_like(f_local[..., :1]), f_local], axis=-1)
    f_global = transform_coordinates(f_padded, e_mu, 'lower')
    ft, fr, fth, fph = (f_global[..., i] for i in range(4))

    # synchrotron emissivity scalings (power-law, spectral index alpha)
    b_mag = jnp.sqrt(jnp.sum(b**2, axis=-1))
    sin_th_b = jnp.sqrt(jnp.sum(f_local**2, axis=-1)) / k_mag
    I = (g**spectral_index * b_mag ** (spectral_index + 1)
         * sin_th_b ** (spectral_index + 1))
    Q = Q_frac * I
    U = jnp.zeros_like(Q)

    # Penrose-Walker constant kappa -> screen rotation chi2 (Himwich2020).
    # All in real arithmetic (whether complex64 pays is not measured):
    # kappa = (r - i a cos(th)) (A - i B); the reference's
    # angle(((beta + i mu) conj(kappa)) / ((beta - i mu) kappa)) is
    # angle(z / conj(z)) = 2 angle(z) for z = (beta + i mu) conj(kappa),
    # and only cos/sin of chi2 enter the Stokes rotation.
    gmunu = inv_metric_components(r, theta, spin, geos.M)
    kmu = raise_or_lower_indices(gmunu, k_mu)
    sin_t = jnp.sin(theta)
    A = ((kmu[..., 0] * fr - kmu[..., 1] * ft)
         + spin * sin_t**2 * (kmu[..., 1] * fph - kmu[..., 3] * fr))
    B = (((r**2 + spin**2) * (kmu[..., 3] * fth - kmu[..., 2] * fph)
          - spin * (kmu[..., 0] * fth - kmu[..., 2] * ft)) * sin_t)
    ac = spin * jnp.cos(theta)
    kappa_re = r * A - ac * B
    kappa_im = -(r * B + ac * A)
    alpha_px = jnp.asarray(geos.alpha)[..., None]
    beta_px = jnp.asarray(geos.beta)[..., None]
    mu_s = -(alpha_px + spin * np.sin(geos.inc))
    z_re = beta_px * kappa_re + mu_s * kappa_im
    z_im = mu_s * kappa_re - beta_px * kappa_im
    chi2 = 2.0 * jnp.arctan2(z_im, z_re)

    J_q = jnp.cos(chi2) * Q - jnp.sin(chi2) * U
    J_u = jnp.sin(chi2) * Q + jnp.cos(chi2) * U

    if V_frac:
        cot_th_b = jnp.sqrt(jnp.clip(1 - sin_th_b**2, 0.0, None)) / sin_th_b
        V = (V_frac * g ** (-spectral_index - 0.5)
             * b_mag ** (spectral_index + 1.5)
             * sin_th_b ** (spectral_index + 1.5) * cot_th_b)
        return jnp.stack([I, J_q, J_u, V], axis=0)
    return jnp.stack([I, J_q, J_u], axis=0)


def parallel_transport(geos, umu, g, b, Q_frac=0.2, V_frac=0.01,
                       spectral_index=1):
    """Stokes transport factors J = (I, Q, U[, V]) for fluid-frame emission
    (reference kgeo.py:438-519). b: fluid-frame spatial B, (..., 3)."""
    if not 0.0 <= Q_frac <= 1.0:
        raise ValueError('Q_frac should be in [0, 1]')
    e_mu = fluid_frame_tetrad(geos, umu)
    return _parallel_transport_core(geos, e_mu, g, b, Q_frac, V_frac,
                                    spectral_index)


def parallel_transport_zamo(geos, beta_v, chi, g, b, Q_frac=0.2,
                            spectral_index=1):
    """ZAMO-frame variant (reference kgeo.py:521-593); no V component."""
    if not 0.0 <= Q_frac <= 1.0:
        raise ValueError('Q_frac should be in [0, 1]')
    e_mu = zamo_frame_tetrad(geos, beta_v, chi)
    return _parallel_transport_core(geos, e_mu, g, b, Q_frac, 0.0,
                                    spectral_index)


def radiative_transfer(emission, g, dtau, Sigma):
    """Ray integral: pixel = sum_geo g^2 * emission * dtau * Sigma
    (reference kgeo.py:595-622, where it is spelled `radiative_trasfer`)."""
    ndim = jnp.ndim(emission)
    g = utils.expand_dims(g, ndim)
    dtau = utils.expand_dims(dtau, ndim)
    Sigma = utils.expand_dims(Sigma, ndim)
    return jnp.sum(g**2 * emission * dtau * Sigma, axis=-1)


# API-parity alias (the reference function name carries a typo)
radiative_trasfer = radiative_transfer
