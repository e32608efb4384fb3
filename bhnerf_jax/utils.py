"""Array utilities (grids, rotations, metrics, FFT helpers).

JAX rebuild of reference bhnerf/utils.py:1-296. Differences from the
reference: everything is plain jax.numpy (no numpy/jax dual paths — XLA runs
these on any backend), grids are lightweight `Grid3D` containers instead of
xarray objects (xarray is not a dependency), and all functions are
jit-safe with static shapes.
"""
from __future__ import annotations

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np


def compilation_cache_dir():
    """Persistent compile-cache directory: $JAX_COMPILATION_CACHE_DIR when
    set, else the fixed `<repo>/.jax_cache` (git-ignored). The path is
    part of the cache key, so it must not move between processes."""
    import os
    from pathlib import Path
    env = os.environ.get('JAX_COMPILATION_CACHE_DIR')
    if env:
        return env
    return str(Path(__file__).resolve().parents[1] / '.jax_cache')


def enable_compilation_cache():
    """Turn on JAX's persistent compile cache at compilation_cache_dir().

    When $JAX_COMPILATION_CACHE_DIR is set JAX already reads it, and no
    other directory is set here."""
    import os
    if not os.environ.get('JAX_COMPILATION_CACHE_DIR'):
        jax.config.update('jax_compilation_cache_dir',
                          compilation_cache_dir())
    jax.config.update('jax_persistent_cache_min_entry_size_bytes', -1)
    jax.config.update('jax_persistent_cache_min_compile_time_secs', 0.3)


def mse(true, est):
    """Mean squared error (reference: utils.py:9)."""
    return float(np.mean((np.asarray(true) - np.asarray(est)) ** 2))


def psnr(true, est):
    """Peak SNR in dB (reference: utils.py:11)."""
    return float(10.0 * np.log10(np.max(np.asarray(true)) ** 2 / mse(true, est)))


def normalize(vector):
    vector = np.asarray(vector, dtype=np.float64)
    return vector / np.sqrt(np.dot(vector, vector))


# ---------------------------------------------------------------------------
# Grid containers — the xarray stand-ins
# ---------------------------------------------------------------------------
@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class Grid3D:
    """A scalar field sampled on a regular (x, y, z) grid.

    Replaces the reference's xr.DataArray emission fields
    (reference: utils.py:48-95). `data` has shape (nx, ny, nz) — or
    (nt, nx, ny, nz) for movies — and the grid spans [start, stop] along
    each axis with linspace coordinates (endpoint included).
    """

    data: jnp.ndarray
    start: tuple
    stop: tuple

    def tree_flatten(self):
        return (self.data,), (self.start, self.stop)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0], aux[0], aux[1])

    @property
    def spatial_ndim(self):
        return len(self.start)

    @property
    def spatial_shape(self):
        return self.data.shape[-self.spatial_ndim:]

    @property
    def fov(self):
        return tuple(sp - st for st, sp in zip(self.start, self.stop))

    def coord_1d(self, axis: int):
        n = self.spatial_shape[axis]
        return np.linspace(self.start[axis], self.stop[axis], n)

    @property
    def x(self):
        return self.coord_1d(0)

    @property
    def y(self):
        return self.coord_1d(1)

    @property
    def z(self):
        return self.coord_1d(2)

    def meshgrid(self):
        axes = [self.coord_1d(i) for i in range(self.spatial_ndim)]
        return np.meshgrid(*axes, indexing='ij')

    def integrate(self):
        """Volume integral via the trapezoid rule (xr .integrate parity)."""
        out = self.data
        for axis in reversed(range(self.spatial_ndim)):
            coord = jnp.asarray(self.coord_1d(axis))
            out = jnp.trapezoid(out, coord, axis=-1)
        return out

    def __mul__(self, other):
        return Grid3D(self.data * other, self.start, self.stop)

    __rmul__ = __mul__

    def __truediv__(self, other):
        return Grid3D(self.data / other, self.start, self.stop)


def linspace_grid(num, start=-0.5, stop=0.5):
    """N-d meshgrid coordinates (reference linspace_xr, utils.py:15-46).

    Returns list of len(num) coordinate arrays, each shaped like `num`.
    """
    num = np.atleast_1d(num)
    axes = [np.linspace(start, stop, int(n)) for n in num]
    return np.meshgrid(*axes, indexing='ij')


def gaussian_field(resolution, center, std, fov=1.0, std_clip=np.inf) -> Grid3D:
    """Gaussian blob on a regular grid (reference gaussian_xr, utils.py:48-95)."""
    resolution = tuple(int(n) for n in np.atleast_1d(resolution))
    if np.isscalar(std):
        std = (std,) * len(resolution)
    if len(resolution) != len(center):
        raise ValueError('resolution and center must have the same length')
    coords = linspace_grid(resolution, -fov / 2.0, fov / 2.0)
    r2 = sum(((c - mu) / s) ** 2 for c, mu, s in zip(coords, center, std))
    data = np.exp(-0.5 * r2)
    data = np.where(data > np.exp(-0.5 * std_clip**2), data, 0.0)
    start = (-fov / 2.0,) * len(resolution)
    stop = (fov / 2.0,) * len(resolution)
    return Grid3D(jnp.asarray(data), start, stop)


# ---------------------------------------------------------------------------
# Rotations
# ---------------------------------------------------------------------------
def rotation_matrix(axis, angle):
    """Euler-Rodrigues rotation matrix (reference utils.py:97-132).

    angle may be an array; the matrix has shape (3, 3, *angle.shape).
    """
    axis = jnp.asarray(axis, dtype=jnp.result_type(float))
    axis = axis / jnp.sqrt(jnp.dot(axis, axis))
    angle = jnp.asarray(angle)

    a = jnp.cos(angle / 2.0)
    b = -axis[0] * jnp.sin(angle / 2.0)
    c = -axis[1] * jnp.sin(angle / 2.0)
    d = -axis[2] * jnp.sin(angle / 2.0)
    aa, bb, cc, dd = a * a, b * b, c * c, d * d
    bc, ad, ac, ab, bd, cd = b * c, a * d, a * c, a * b, b * d, c * d
    row0 = jnp.stack([aa + bb - cc - dd, 2 * (bc + ad), 2 * (bd - ac)])
    row1 = jnp.stack([2 * (bc - ad), aa + cc - bb - dd, 2 * (cd + ab)])
    row2 = jnp.stack([2 * (bd + ac), 2 * (cd - ab), aa + dd - bb - cc])
    return jnp.stack([row0, row1, row2])


def spherical_coords_to_rotation_axis(theta, phi):
    """Spherical direction -> (rot_axis, rot_angle) (reference utils.py:134-158)."""
    z_axis = np.array([0.0, 0.0, 1.0])
    r_vector = np.array([np.cos(phi) * np.sin(theta),
                         np.sin(phi) * np.sin(theta),
                         np.cos(theta)])
    rot_axis_prime = np.cross(r_vector, z_axis)
    if np.linalg.norm(rot_axis_prime) < 1e-12:
        # degenerate pole directions (theta = 0 or pi): the cross
        # product vanishes and normalizing it would return NaNs (the
        # reference shares this flaw); the orbit plane is the equator,
        # any consistent axis works
        return np.array([0.0, 0.0, np.sign(np.cos(theta)) or 1.0]), phi
    rot = np.asarray(rotation_matrix(rot_axis_prime, np.pi / 2))
    rot_axis = rot @ r_vector
    return rot_axis, phi


def world_to_image_coords(coords, fov, npix):
    """World coords -> fractional grid indices (reference utils.py:160-166)."""
    image_coords = [
        (coords[..., i] + fov[i] / 2.0) / fov[i] * (npix[i] - 1)
        for i in range(coords.shape[-1])
    ]
    return jnp.stack(image_coords, axis=-1)


def expand_dims(x, ndim, axis=0):
    """Insert size-1 dims until x.ndim == ndim (reference utils.py:215-219)."""
    x = jnp.asarray(x)
    for _ in range(ndim - x.ndim):
        x = jnp.expand_dims(x, axis=min(axis, x.ndim) if axis >= 0 else axis)
    return x


def expand_3d(movie, fov_xy, fov_z, H_r=0.05, std=0.2, std_clip=3, nz=64):
    """Inflate a 2D movie into 3D with H/r scale-height profile
    (reference utils.py:221-251). movie shape (nt, nx, ny)."""
    movie = jnp.asarray(movie)
    nt, nx, ny = movie.shape
    x = np.linspace(-fov_xy / 2, fov_xy / 2, nx)
    y = np.linspace(-fov_xy / 2, fov_xy / 2, ny)
    z = np.linspace(-fov_z / 2, fov_z / 2, nz)
    X, Y = np.meshgrid(x, y, indexing='ij')
    H = H_r * np.sqrt(X**2 + Y**2) if H_r != 0 else np.full_like(X, std)
    gauss = np.exp(-0.5 * z[None, None, :] ** 2 / H[..., None] ** 2)
    gauss = np.where(gauss > np.exp(-0.5 * std_clip**2), gauss, 0.0)
    data = movie[..., None] * jnp.asarray(gauss)[None]
    return Grid3D(data, (-fov_xy / 2, -fov_xy / 2, -fov_z / 2),
                  (fov_xy / 2, fov_xy / 2, fov_z / 2))


def intensity_to_nchw(intensity, cmap='viridis', gamma=0.5):
    """Grayscale volume -> NCHW image stack for tensorboard
    (reference utils.py:168-193)."""
    import matplotlib.pyplot as plt
    cm = plt.get_cmap(cmap)
    intensity = np.asarray(intensity)
    lo, hi = np.min(intensity), np.max(intensity)
    norm = ((intensity - lo) / max(hi - lo, 1e-30)) ** gamma
    return np.moveaxis(cm(norm)[..., :3], (0, 1, 2, 3), (3, 2, 0, 1))


def anti_aliasing_filter(image_plane, window):
    """FFT blur with a window (reference utils.py:195-213)."""
    fourier = (jnp.fft.fft2(jnp.fft.ifftshift(image_plane, axes=(-2, -1)))
               * jnp.fft.fft2(jnp.fft.ifftshift(window)))
    return jnp.fft.ifftshift(jnp.fft.ifft2(fourier), axes=(-2, -1)).real


def gaussian_random_field(key, shape, slope=3.0, std=1.0,
                          temporal_corr=0.9):
    """Isotropic power-law Gaussian random field (the accretion-disk GRF
    driver of the reference's Synthetic-lightcurves notebooks, which used
    an external generator). P(k) ~ k^-slope; zero-mean, unit std.

    key: jax PRNGKey; shape: 2D (ny, nx), or 3D (nt, ny, nx) for a movie
    whose spectral noise follows an AR(1) process with coefficient
    `temporal_corr` along the leading axis (stationary in time).
    """
    import jax.random as jr
    shape = tuple(shape)
    spatial = shape[-2:]
    kfreq = [np.fft.fftfreq(n) for n in spatial]
    kgrid = np.meshgrid(*kfreq, indexing='ij')
    knorm = np.sqrt(sum(k**2 for k in kgrid))
    knorm[0, 0] = np.inf
    amplitude = knorm ** (-slope / 2.0)

    def complex_noise(key):
        # normals drawn with jax (real dtype, any backend); the complex
        # FFT runs in host numpy (a one-off synthesis step)
        k_re, k_im = jr.split(key)
        return (np.asarray(jr.normal(k_re, spatial))
                + 1j * np.asarray(jr.normal(k_im, spatial)))

    def to_field(noise):
        field = np.fft.ifft2(amplitude * noise).real
        return field / (np.std(field) + 1e-12) * std

    if len(shape) == 2:
        return jnp.asarray(to_field(complex_noise(key)))

    keys = jr.split(key, shape[0])
    rho = temporal_corr
    noise = complex_noise(keys[0])
    frames = [to_field(noise)]
    for k in keys[1:]:
        noise = rho * noise + np.sqrt(1 - rho**2) * complex_noise(k)
        frames.append(to_field(noise))
    return jnp.asarray(np.stack(frames))


def next_power_of_two(x):
    return 2 ** int(math.ceil(math.log2(x)))


def fft_transform(movies, fft_pad_factor=2):
    """Padded, shifted per-frame FFT (reference utils.py:270-296)."""
    movies = jnp.asarray(movies)
    ny, nx = movies.shape[-2:]
    npad = next_power_of_two(fft_pad_factor * max(nx, ny))
    padx1 = padx2 = int(np.floor((npad - nx) / 2.0))
    pady1 = pady2 = int(np.floor((npad - ny) / 2.0))
    padx2 += 1 if nx % 2 else 0
    pady2 += 1 if ny % 2 else 0
    pad_width = [(0, 0)] * (movies.ndim - 2) + [(pady1, pady2), (padx1, padx2)]
    padded = jnp.pad(movies, pad_width)
    return jnp.fft.fftshift(jnp.fft.fft2(jnp.fft.ifftshift(padded)))
