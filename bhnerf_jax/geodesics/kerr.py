"""Kerr null-geodesic potentials and conserved quantities.

This module is the mathematical core that replaces the external `kgeo`
raytracer the reference depends on (reference: bhnerf/kgeo.py:1,
.gitmodules:1-3 — the submodule is not vendored, so the physics here is
implemented from the standard Kerr geodesic formalism; Gralla & Lupsasca
2019 conventions for screen coordinates).

Conventions (G = c = M = 1, photon energy E = 1):
    * Boyer-Lindquist coordinates (t, r, theta, phi), spin 0 <= a < 1.
    * Screen coordinates (alpha, beta):  alpha = -lambda / sin(theta_o),
      beta = p_theta at the observer, so
          lambda = -alpha sin(theta_o)
          eta    = (alpha^2 - a^2) cos^2(theta_o) + beta^2
    * Radial potential  R(r) = (r^2 + a^2 - a lam)^2 - Delta(r) [eta + (lam - a)^2]
    * Angular potential Theta(th) = eta + a^2 cos^2(th) - lam^2 cot^2(th)
    * Mino time tau:   d(coordinate)/dtau = Sigma * d(coordinate)/dsigma.

For accelerator-friendly integration the radial equation is rewritten in u = 1/r:
    (du/dtau)^2 = U(u) = u^4 R(1/u)
which is a quartic polynomial in u, O(1) over the whole domain — uniform
Mino steps then resolve both the far field (r ~ 1000) and the near-horizon
region without adaptive stepping.
"""
from __future__ import annotations

import jax.numpy as jnp


def horizon(spin):
    """Outer event horizon r_+ in M units."""
    return 1.0 + jnp.sqrt(1.0 - spin**2)


def conserved_quantities(alpha, beta, spin, inc):
    """Energy-rescaled angular momentum lambda and Carter constant eta.

    alpha/beta: screen coordinates [M]; inc: observer inclination [rad].
    """
    lam = -alpha * jnp.sin(inc)
    eta = (alpha**2 - spin**2) * jnp.cos(inc) ** 2 + beta**2
    return lam, eta


def Delta(r, spin):
    return r**2 - 2.0 * r + spin**2


def Sigma(r, theta, spin):
    return r**2 + spin**2 * jnp.cos(theta) ** 2


def Xi(r, theta, spin):
    """Metric function  Xi = (r^2+a^2)^2 - a^2 Delta sin^2(theta)."""
    return (r**2 + spin**2) ** 2 - spin**2 * Delta(r, spin) * jnp.sin(theta) ** 2


def omega(r, theta, spin):
    """Frame-dragging angular velocity  omega = 2 a r / Xi."""
    return 2.0 * spin * r / Xi(r, theta, spin)


def R_potential(r, spin, lam, eta):
    return ((r**2 + spin**2 - spin * lam) ** 2
            - Delta(r, spin) * (eta + (lam - spin) ** 2))


def Theta_potential(theta, spin, lam, eta):
    cos2 = jnp.cos(theta) ** 2
    sin2 = jnp.sin(theta) ** 2
    return eta + spin**2 * cos2 - lam**2 * cos2 / sin2


def U_potential(u, spin, lam, eta):
    """u^4 R(1/u): quartic radial potential in inverse radius u = 1/r."""
    c2 = spin**2 - spin * lam          # coefficient of u^2 inside the square
    k = eta + (lam - spin) ** 2        # impact constant
    a_ = 1.0 + c2 * u**2
    return a_**2 - (1.0 - 2.0 * u + spin**2 * u**2) * u**2 * k


def dU_du(u, spin, lam, eta):
    """d/du of U_potential (drives the smooth 2nd-order radial ODE)."""
    c2 = spin**2 - spin * lam
    k = eta + (lam - spin) ** 2
    a_ = 1.0 + c2 * u**2
    # d/du [a_^2] = 4 c2 u a_ ;  d/du [(1-2u+a^2u^2) u^2] = 2u - 6u^2 + 4 a^2 u^3
    return 4.0 * c2 * u * a_ - k * (2.0 * u - 6.0 * u**2 + 4.0 * spin**2 * u**3)


# --- polar dynamics in c = cos(theta) --------------------------------------
# The integrator runs entirely on these trig-free forms: with c = cos(theta),
# (dc/dtau)^2 = C(c) = eta + (a^2 - eta - lam^2) c^2 - a^2 c^4, the standard
# Gralla-Lupsasca angular quartic. A polynomial RHS needs no device
# transcendentals, so the f32 device trace carries no trig rounding (trig
# then only happens on host, in exact numpy).
def C_potential(c, spin, lam, eta):
    return eta + (spin**2 - eta - lam**2) * c**2 - spin**2 * c**4


def dC_dc(c, spin, lam, eta):
    return 2.0 * (spin**2 - eta - lam**2) * c - 4.0 * spin**2 * c**3


def phi_rate(u, c, spin, lam):
    """d(phi)/dtau for the forward (emission -> observer) photon.

    Written in (u = 1/r, c = cos(theta)); rational, no trig. The
    lam/sin^2(theta) term is guarded for polar rays (lam -> 0 as
    sin(theta_o) -> 0, so the limit is 0, not NaN).
    """
    r = 1.0 / u
    delta = Delta(r, spin)
    sin2 = jnp.maximum(1.0 - c**2, 1e-12)
    return (spin / delta * (r**2 + spin**2 - spin * lam)
            + lam / sin2 - spin)


def t_rate(u, c, spin, lam):
    """d(t)/dtau for the forward photon, in (u, c) variables."""
    r = 1.0 / u
    delta = Delta(r, spin)
    return ((r**2 + spin**2) / delta * (r**2 + spin**2 - spin * lam)
            + spin * (lam - spin * (1.0 - c**2)))


def keplerian_omega(r, spin, M=1.0, direction=1.0, frac=1.0):
    """Keplerian angular velocity Omega = sqrt(M)/(r^{3/2} + a sqrt(M))
    (reference: bhnerf/alma.py:49, Tutorial2)."""
    return direction * frac * jnp.sqrt(M) / (r ** (3 / 2) + spin * jnp.sqrt(M))
