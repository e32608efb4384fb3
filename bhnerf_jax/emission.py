"""Emission models and the velocity-warp forward physics.

JAX rebuild of reference bhnerf/emission.py:1-407. Structural
differences: all device math is jnp-only (no numpy/jax dual paths), 3D
fields are `utils.Grid3D` pytrees instead of xarray DataArrays, and the
velocity warp exposes a NaN-free (coords, mask) path so gradients stay
clean (the reference's NaN-injection at emission.py:204-205 is kept
only as an API-parity wrapper).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from bhnerf_jax import constants as consts
from bhnerf_jax import units, utils
from bhnerf_jax.ops import gr


# ---------------------------------------------------------------------------
# synthetic emission generators (reference emission.py:10-141)
# ---------------------------------------------------------------------------
def _orbit_rotation(rot_axis):
    rot_axis = np.asarray(rot_axis, dtype=np.float64)
    rot_axis = rot_axis / np.sqrt(np.sum(rot_axis**2))
    z_axis = np.array([0.0, 0.0, 1.0])
    rot_axis_prime = np.cross(z_axis, rot_axis)
    if np.sqrt(np.sum(rot_axis_prime**2)) < 1e-5:
        rot_axis_prime = z_axis
    rot_angle_prime = np.arccos(np.dot(rot_axis, z_axis))
    return np.asarray(utils.rotation_matrix(rot_axis_prime, rot_angle_prime))


def generate_hotspot(resolution, rot_axis, rot_angle, orbit_radius, std,
                     r_isco, fov, std_clip=np.inf, normalize=True):
    """Gaussian hotspot on a circular orbit (reference emission.py:10-60)."""
    if orbit_radius < r_isco:
        raise ValueError(
            f'hotspot center ({orbit_radius}) is within r_isco: {r_isco}')
    resolution = tuple(int(n) for n in np.atleast_1d(resolution))
    center_2d = orbit_radius * np.array([np.cos(rot_angle), np.sin(rot_angle)])
    if len(resolution) == 2:
        center = center_2d
    else:
        rot_matrix = _orbit_rotation(rot_axis)
        center = rot_matrix @ np.append(center_2d, 0.0)

    emission = utils.gaussian_field(resolution, center, std, fov=fov,
                                    std_clip=std_clip)
    if normalize:
        emission = emission / emission.integrate()
    return emission


def generate_tube(resolution, rot_axis, phi_start, phi_end, orbit_radius, std,
                  r_isco, fov, std_clip=np.inf, normalize=True):
    """Azimuthal flux-tube arc with Gaussian cross-section
    (reference emission.py:62-117)."""
    if orbit_radius < r_isco:
        raise ValueError(
            f'tube radius ({orbit_radius}) is within r_isco: {r_isco}')
    resolution = tuple(int(n) for n in np.atleast_1d(resolution))
    if phi_end <= phi_start:
        raise ValueError(
            f'empty tube range [{phi_start}, {phi_end}): for an arc '
            f'wrapping through 2*pi pass phi_end = phi_start + extent '
            f'(angles beyond 2*pi wrap naturally)')
    rot_matrix = _orbit_rotation(rot_axis)
    data = 0.0
    grid = None
    for phi in np.arange(phi_start, phi_end, 0.015):
        center_2d = orbit_radius * np.array([np.cos(phi), np.sin(phi)])
        center = rot_matrix @ np.append(center_2d, 0.0)
        grid = utils.gaussian_field(resolution, center, std, fov=fov,
                                    std_clip=std_clip)
        data = data + grid.data
    emission = utils.Grid3D(data, grid.start, grid.stop)
    if normalize:
        emission = emission / emission.integrate()
    return emission


def equatorial_ring(geos, mbar):
    """Unit emission at the mbar-th equatorial crossing of each ray
    (reference emission.py:119-141, which uses kgeo.equatorial_lensing).

    Crossing detection lives in geodesics.equatorial.crossing_index.
    """
    from bhnerf_jax.geodesics import equatorial
    found, _, idx_nearest = equatorial.crossing_index(geos, mbar)
    emission = np.zeros_like(geos.r)
    it = np.indices(idx_nearest.shape)
    emission[(*it, idx_nearest)] = np.where(found, 1.0, 0.0)
    return emission


# ---------------------------------------------------------------------------
# velocity warp — the learned-model time coordinate (reference 143-211)
# ---------------------------------------------------------------------------
def velocity_warp_matrix(coords_ndim, Omega, t_frames, t_start_obs, t_geos,
                         t_injection, rot_axis=(0, 0, 1),
                         M=consts.sgra_mass, t_units=None):
    """Rotation angles + validity mask for the velocity warp.

    Returns (theta_rot, valid) where theta_rot is the rigid-rotation angle
    mapping frame-time samples back to the canonical t0 frame and valid
    marks samples after the injection time. NaN-free by construction.
    """
    Omega = jnp.asarray(Omega)

    if isinstance(t_start_obs, units.Quantity):
        t_units = t_start_obs.unit
        t_start_obs = t_start_obs.value
    elif t_units is None and isinstance(t_frames, units.Quantity):
        # a unit-carrying t_frames with a plain-float t_start_obs must
        # not silently drop its unit (0.1 hr would be read as 0.1 M and
        # the movie would render essentially frozen; the reference
        # raises here)
        t_units = t_frames.unit

    GM_c3 = 1.0
    if t_units is not None:
        GM_c3 = consts.GM_c3(M).to(t_units).value

    if isinstance(t_frames, units.Quantity):
        t_frames = t_frames.to(t_units).value if t_units is not None \
            else t_frames.value
    t_frames = jnp.asarray(t_frames)

    if Omega.ndim == 0:
        Omega = Omega[None]
        while Omega.ndim < coords_ndim - 1:
            Omega = Omega[..., None]

    # broadcast frame times against ray-sample dims
    if t_frames.ndim != 0:
        t_frames = utils.expand_dims(t_frames, t_frames.ndim + Omega.ndim, -1)

    t_geos = (t_frames - t_start_obs) / GM_c3 + jnp.asarray(t_geos)
    t_M = t_geos - t_injection
    valid = t_M >= 0.0
    theta_rot = jnp.where(valid, t_M, 0.0) * Omega
    return theta_rot, valid


def velocity_warp_coords(coords, Omega, t_frames, t_start_obs, t_geos,
                         t_injection, rot_axis=(0, 0, 1),
                         M=consts.sgra_mass, t_units=None,
                         fill_nan=True, return_mask=False):
    """Warp sampling coordinates back to the canonical frame
    (reference emission.py:143-211).

    coords: stacked [x, y, z] with axis 0 the component axis, matching the
    reference calling convention (emission.py:270-279). With
    `return_mask=True` the clean NaN-free path is returned: (coords, valid) with
    zeros instead of NaN in invalid slots. With `fill_nan=True` (default)
    the reference's NaN-marking behavior is reproduced.
    """
    coords = jnp.asarray(coords)
    theta_rot, valid = velocity_warp_matrix(
        coords.ndim, Omega, t_frames, t_start_obs, t_geos, t_injection,
        rot_axis, M, t_units)

    inv_rot = utils.rotation_matrix(rot_axis, -theta_rot)
    # inv_rot: (3, 3, *batch); coords: (3, *spatial). contract axis 1 of the
    # matrix against the component axis of coords with broadcasting
    if theta_rot.ndim >= coords.ndim:  # frame axis prepended
        coords = utils.expand_dims(coords, theta_rot.ndim + 1, 1)
    warped = jnp.sum(inv_rot * coords[None], axis=1)
    warped = jnp.moveaxis(warped, 0, -1)

    if return_mask:
        return warped, valid
    if fill_nan:
        warped = jnp.where(valid[..., None], warped,
                           jnp.full_like(warped, jnp.nan))
    return warped


def interpolate_coords(emission, coords):
    """Trilinear sample of a 3D field at world coords
    (reference emission.py:213-233). emission: Grid3D or raw array with
    grid spanning the Grid3D extents; coords: (..., 3)."""
    from jax.scipy.ndimage import map_coordinates
    if isinstance(emission, utils.Grid3D):
        fov = emission.fov
        npix = emission.spatial_shape
        data = emission.data
    else:
        raise TypeError('interpolate_coords requires a Grid3D field')
    image_coords = jnp.moveaxis(
        utils.world_to_image_coords(coords, fov=fov, npix=npix), -1, 0)
    return map_coordinates(data, list(image_coords), order=1, cval=0.0)


def domain_mask(coords, rmin=0.0, rmax=np.inf, z_width=np.inf):
    """Boolean mask of the supervised emission shell: rmin <= r <= rmax
    and |z| <= z_width. The single source of truth for the domain
    predicate shared by the dense and compacted pipelines.

    coords: stacked [x, y, z] with axis 0 the component axis.
    """
    coords = jnp.asarray(coords)
    r_sq = jnp.sum(jnp.square(coords), axis=0)
    mask = jnp.ones_like(r_sq, dtype=bool)
    if rmin > 0:
        mask &= r_sq >= rmin**2
    if np.isfinite(rmax):
        mask &= r_sq <= rmax**2
    if np.isfinite(z_width):
        mask &= jnp.abs(coords[2]) <= z_width
    return mask


def fill_unsupervised_emission(emission, coords, rmin=0.0, rmax=np.inf,
                               z_width=2.0, fill_value=0.0):
    """Zero emission outside the supervised shell
    (reference emission.py:343-374). coords: stacked [x, y, z], axis 0."""
    keep = domain_mask(coords, rmin, rmax, z_width)
    return jnp.where(keep, emission,
                     jnp.full_like(emission, fill_value))


# ---------------------------------------------------------------------------
# full (non-learned) forward model (reference emission.py:235-341)
# ---------------------------------------------------------------------------
def apply_stokes_factors(emission, J):
    """Multiply per-sample Stokes factors J ((nstokes, ...sample dims))
    onto emission ((*frame_dims, ...sample dims)), inserting the Stokes
    axis after the frame dims. Explicit rather than expand+squeeze: the
    reference's pattern drops the frame axis when nt == 1
    (network.py:415-418). Scalar / 0-d J is a plain intensity scale."""
    if jnp.ndim(J) > 0:
        nt_dims = emission.ndim - 3
        J_b = jnp.asarray(J).reshape((1,) * nt_dims + np.shape(J))
        return J_b * jnp.expand_dims(emission, axis=nt_dims)
    if np.isscalar(J) and J == 1.0:
        return emission
    return emission * J


def image_plane_dynamics(emission_0, geos, Omega, t_frames, t_injection,
                         J=1.0, t_start_obs=None, slow_light=True,
                         doppler=True, rot_axis=(0, 0, 1),
                         M=consts.sgra_mass, frame_chunk=None):
    """Render the image-plane movie of a rigidly-rotating 3D emission field
    (reference emission.py:235-303). Pure jnp: runs on any backend under jit.

    frame_chunk: frames per eager dispatch for large movies (None =
    auto-size to a ~1 GB warp-temporary budget; see the chunking note
    in the body)."""
    t_geos = jnp.asarray(geos.t) if slow_light else 0.0
    if t_start_obs is None:
        if isinstance(t_frames, units.Quantity):
            t_start_obs = t_frames[0] if t_frames.ndim else t_frames
        else:
            # jnp (not np): t_frames may be a tracer under jit
            t_start_obs = jnp.atleast_1d(jnp.asarray(t_frames))[0]

    # Auto-chunk large EAGER movie renders over frames: outside jit every
    # warp intermediate materializes in device memory — the rotation
    # tensor alone is (3, 3, nt, N) = 36*nt*N bytes, 3.8 GB at the
    # production npix=128, ngeo=100, nt=64 ground-truth render. Chunks
    # recurse with t_start_obs pinned to the GLOBAL first frame so the
    # warp phase is unchanged. Inside jit (tracer t_frames) XLA fuses the
    # chain, so the single-shot path is kept.
    nt = np.shape(t_frames)[0] if np.ndim(t_frames) else 0
    if nt > 1 and not isinstance(t_frames, jax.core.Tracer):
        if frame_chunk is None:
            n = int(np.prod(np.shape(geos.x)))
            frame_chunk = max(1, int(2 ** 30) // max(36 * n, 1))
        if frame_chunk < nt:
            is_movie = (isinstance(emission_0, utils.Grid3D)
                        and emission_0.data.ndim != 3)
            outs = []
            for i in range(0, nt, frame_chunk):
                em_i = (utils.Grid3D(emission_0.data[i:i + frame_chunk],
                                     emission_0.start, emission_0.stop)
                        if is_movie else emission_0)
                outs.append(image_plane_dynamics(
                    em_i, geos, Omega, t_frames[i:i + frame_chunk],
                    t_injection, J, t_start_obs=t_start_obs,
                    slow_light=slow_light, doppler=doppler,
                    rot_axis=rot_axis, M=M, frame_chunk=nt))
            return jnp.concatenate(outs, axis=0)

    warped, valid = velocity_warp_coords(
        coords=jnp.asarray(np.stack([geos.x, geos.y, geos.z], axis=0)),
        Omega=Omega, t_frames=t_frames, t_start_obs=t_start_obs,
        t_geos=t_geos, t_injection=t_injection, rot_axis=rot_axis, M=M,
        return_mask=True)

    g = 1.0
    if doppler:
        umu = gr.azimuthal_velocity_vector(geos, Omega)
        g = gr.doppler_factor(geos, umu)

    if isinstance(emission_0, utils.Grid3D) and emission_0.data.ndim == 3:
        emission = interpolate_coords(emission_0, warped)
    elif isinstance(emission_0, utils.Grid3D):  # movie: leading time axis
        n_em = emission_0.data.shape[0]
        nt = np.shape(t_frames)[0] if np.ndim(t_frames) else 1
        if n_em != nt:
            raise ValueError(
                f'movie emission has {n_em} frames but t_frames has '
                f'{nt}: frame i is rendered at time i (interpolate or '
                f'resample one of them first)')
        frames = [interpolate_coords(
            utils.Grid3D(emission_0.data[i], emission_0.start,
                         emission_0.stop), warped[i] if warped.ndim > 4 else warped)
            for i in range(n_em)]
        emission = jnp.stack(frames)
    else:
        raise TypeError('emission_0 must be a Grid3D')
    emission = jnp.where(valid, emission, 0.0)

    emission = apply_stokes_factors(emission, J)

    return gr.radiative_transfer(emission, jnp.asarray(g),
                                 jnp.asarray(geos.dtau),
                                 jnp.asarray(geos.Sigma))


def propogate_flatspace_emission(emission_0, Omega_3D, t_frames,
                                 t_start_obs=None, rot_axis=(0, 0, 1),
                                 M=consts.sgra_mass):
    """Advect a flat-space 3D field through time (reference 305-341)."""
    x, y, z = emission_0.meshgrid()
    if t_start_obs is None:
        t_start_obs = np.atleast_1d(np.asarray(t_frames))[0]
    warped, valid = velocity_warp_coords(
        coords=jnp.asarray(np.stack([x, y, z], axis=0)), Omega=Omega_3D,
        t_frames=t_frames, t_start_obs=t_start_obs, t_geos=0.0,
        t_injection=0.0, rot_axis=rot_axis, M=M, return_mask=True)
    out = interpolate_coords(emission_0, warped)
    return jnp.where(valid, out, 0.0)


def grf_to_image_plane(grf, geos, Omega, J, diameter_M, alpha=2.0,
                       H_r=0.075):
    """Gaussian-random-field accretion disk -> image plane movie
    (reference emission.py:376-385)."""
    fov_M = float(geos.alpha[-1, 0] - geos.alpha[0, 0])
    gaussian = utils.gaussian_field(
        [grf.shape[-2], grf.shape[-1]], [0, 0], std=diameter_M / 2.355,
        fov=fov_M)
    movie = jnp.exp(alpha * jnp.asarray(grf)) * gaussian.data
    if movie.ndim == 2:
        movie = movie[None]
    emission = utils.expand_3d(movie, fov_xy=fov_M, fov_z=fov_M, H_r=H_r)
    frames = [image_plane_dynamics(
        utils.Grid3D(emission.data[i], emission.start, emission.stop),
        geos, Omega, 0.0, 0.0, J, slow_light=False)
        for i in range(emission.data.shape[0])]
    out = jnp.stack(frames)
    return out[0] if out.shape[0] == 1 else out


def normalize_stokes(movie, I_flux, P_flux, V_flux=None):
    """Normalize a Stokes movie to target fluxes (reference 387-393).
    movie shape (nt, nstokes, ny, nx)."""
    movie = jnp.asarray(movie)
    dolp = jnp.sqrt(jnp.sum(movie[:, 1:3].sum(axis=(-1, -2)) ** 2,
                            axis=1)).mean()
    parts = [movie[:, 0:1] * (I_flux / movie[:, 0].sum(axis=(-1, -2)).mean()),
             movie[:, 1:3] * (P_flux / dolp)]
    if V_flux is not None and movie.shape[1] > 3:
        parts.append(movie[:, 3:4]
                     * (V_flux / movie[:, 3].sum(axis=(-1, -2)).mean()))
    elif movie.shape[1] > 3:
        parts.append(movie[:, 3:])
    return jnp.concatenate(parts, axis=1)


def rotate_evpa(stokes, angle, axis=0):
    """Rotate the EVPA of a Stokes vector by `angle`
    (reference emission.py:395-407). Real arithmetic: e^{2i angle}(Q + iU)
    is just a rotation."""
    stokes = jnp.asarray(stokes)
    n = stokes.shape[axis]
    c, s = jnp.cos(2 * angle), jnp.sin(2 * angle)

    def rot(q, u):
        return c * q - s * u, s * q + c * u

    if n == 2:
        q, u = rot(jnp.take(stokes, 0, axis), jnp.take(stokes, 1, axis))
        parts = [q, u]
    elif n in (3, 4):
        q, u = rot(jnp.take(stokes, 1, axis), jnp.take(stokes, 2, axis))
        parts = [jnp.take(stokes, 0, axis), q, u]
        if n == 4:
            parts.append(jnp.take(stokes, 3, axis))
    else:
        raise ValueError(f'stokes axis size {n} not supported')
    return jnp.stack(parts, axis=axis)
