"""Geodesics container + image-plane trace driver.

Provides the dataset contract that every downstream layer of the reference
consumes from the external raytracer (inferred contract documented in
SURVEY.md §2.3; usage sites: reference bhnerf/kgeo.py:107-141,
bhnerf/emission.py:269-271, bhnerf/network.py:874-880, bhnerf/alma.py:78).

Instead of an xarray.Dataset (xarray is not a dependency, and device
code wants raw arrays), geodesics live in a frozen dataclass pytree whose
leaves are host numpy float64 arrays (precompute precision) with derived
metric quantities computed on demand. `network.raytracing_args` freezes the
needed subset into float32 device arrays for the training hot loop.

Array layout matches the reference: (num_alpha, num_beta, ngeo).
"""
from __future__ import annotations

import dataclasses

import jax
import numpy as np

from bhnerf_jax.geodesics import integrator, kerr


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class Geodesics:
    """Bundle of ray samples + conserved quantities for one image plane."""

    # per-sample arrays, shape (num_alpha, num_beta, ngeo)
    r: np.ndarray
    theta: np.ndarray
    phi: np.ndarray
    t: np.ndarray
    mino: np.ndarray
    dtau: np.ndarray
    pm_r: np.ndarray          # sign of (forward) radial momentum
    pm_th: np.ndarray         # sign of (forward) polar momentum
    # per-pixel arrays, shape (num_alpha, num_beta)
    alpha: np.ndarray
    beta: np.ndarray
    lam: np.ndarray
    eta: np.ndarray
    tau_final: np.ndarray
    # scalars
    spin: float
    inc: float
    M: float = 1.0
    E: float = 1.0
    r_o: float = 1000.0

    _FIELDS = ('r', 'theta', 'phi', 't', 'mino', 'dtau', 'pm_r', 'pm_th',
               'alpha', 'beta', 'lam', 'eta', 'tau_final')
    _AUX = ('spin', 'inc', 'M', 'E', 'r_o')

    def tree_flatten(self):
        return (tuple(getattr(self, f) for f in self._FIELDS),
                tuple(getattr(self, f) for f in self._AUX))

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, *aux)

    # ---- shapes ---------------------------------------------------------
    @property
    def num_alpha(self):
        return self.r.shape[0]

    @property
    def num_beta(self):
        return self.r.shape[1]

    @property
    def ngeo(self):
        return self.r.shape[2]

    @property
    def npix(self):
        return self.num_alpha * self.num_beta

    # ---- cartesian coordinates (reference emission.py:271) --------------
    @property
    def x(self):
        return self.r * np.sin(self.theta) * np.cos(self.phi)

    @property
    def y(self):
        return self.r * np.sin(self.theta) * np.sin(self.phi)

    @property
    def z(self):
        return self.r * np.cos(self.theta)

    # ---- metric functions (reference kgeo.py:118-171 usage) -------------
    # computed with numpy here, NOT kerr.py's jnp forms: on np.float64
    # inputs a jnp call silently dispatches to the default (accelerator)
    # backend in f32, breaking the float64-host precompute contract and
    # paying a device round-trip per property access (kerr.py's jnp
    # versions serve the jitted integrator, where they belong)
    @property
    def Sigma(self):
        return self.r**2 + self.spin**2 * np.cos(self.theta) ** 2

    @property
    def Delta(self):
        return np.asarray(kerr.Delta(self.r, self.spin))  # polynomial

    @property
    def Xi(self):
        return ((self.r**2 + self.spin**2) ** 2
                - self.spin**2 * self.Delta * np.sin(self.theta) ** 2)

    @property
    def omega(self):
        return 2.0 * self.spin * self.r / self.Xi

    # ---- geodesic potentials (reference kgeo.py:112-113) -----------------
    @property
    def R(self):
        lam = self.lam[..., None]
        eta = self.eta[..., None]
        return np.asarray(kerr.R_potential(self.r, self.spin, lam, eta))

    @property
    def Theta(self):
        lam = self.lam[..., None]
        eta = self.eta[..., None]
        cos2 = np.cos(self.theta) ** 2
        sin2 = np.sin(self.theta) ** 2
        return eta + self.spin**2 * cos2 - lam**2 * cos2 / sin2

    @property
    def affine(self):
        """Affine parameter: cumulative trapezoid of Sigma over Mino time."""
        sig = self.Sigma
        dm = np.diff(self.mino, axis=-1)
        seg = 0.5 * (sig[..., 1:] + sig[..., :-1]) * dm
        return np.concatenate(
            [np.zeros_like(sig[..., :1]), np.cumsum(seg, axis=-1)], axis=-1)

    @property
    def coords(self):
        """Stacked [x, y, z] (axis 0), the NeRF sampling coordinates."""
        return np.stack([self.x, self.y, self.z], axis=0)

    def fillna(self, value=0.0):
        """xarray-API parity; this implementation produces no NaNs."""
        return self

    def save(self, path):
        """Serialize to .npz (the xr.Dataset.to_netcdf affordance)."""
        arrays = {f: np.asarray(getattr(self, f)) for f in self._FIELDS}
        scalars = {f: getattr(self, f) for f in self._AUX}
        np.savez_compressed(path, **arrays,
                            _aux=np.array([scalars[f] for f in self._AUX]))

    @classmethod
    def load(cls, path):
        blob = np.load(path)
        aux = blob['_aux']
        return cls(*(blob[f] for f in cls._FIELDS),
                   **dict(zip(cls._AUX, (float(a) for a in aux))))

    def keplerian_omega(self, direction=1.0, frac=1.0):
        """Keplerian angular velocity field along the rays
        (reference alma.py:49, Tutorial2 usage). numpy on host — see
        the metric-functions note above."""
        return (direction * frac * np.sqrt(self.M)
                / (self.r ** 1.5 + self.spin * np.sqrt(self.M)))


def subpixel_jittered_axes(alpha_range, beta_range, num_alpha, num_beta,
                           rng):
    """One sub-pixel-randomized draw of the screen grid axes: per-axis
    uniform jitter within a pixel (reference kgeo.py:51-55 semantics).
    THE single source of the randomization rule — the batched ensemble
    tracer (alma._trace_subpixel_ensemble) must consume rng identically
    to the per-variant image_plane_geos loop."""
    alpha_1d = np.linspace(*alpha_range, num_alpha)
    beta_1d = np.linspace(*beta_range, num_beta)
    psize_alpha = (alpha_range[1] - alpha_range[0]) / (num_alpha - 1)
    psize_beta = (beta_range[1] - beta_range[0]) / (num_beta - 1)
    alpha_1d = alpha_1d + (rng.random(num_alpha) - 0.5) * psize_alpha
    beta_1d = beta_1d + (rng.random(num_beta) - 0.5) * psize_beta
    return alpha_1d, beta_1d


def image_plane_geos(spin, inclination, alpha_range, beta_range, ngeo=100,
                     num_alpha=64, num_beta=64, distance=1000.0, E=1.0, M=1.0,
                     randomize_subpixel_rays=False, rng=None, tau_max=4.0,
                     n_fine=8192, substeps=8, dtype=None,
                     backend='cpu', mesh=None, verbose=False) -> Geodesics:
    """Trace Kerr geodesics for a full image plane.

    API mirrors the reference driver (bhnerf/kgeo.py:6-63) including
    sub-pixel randomization (kgeo.py:51-55); the implementation is the JAX
    integrator of `bhnerf_jax.geodesics.integrator` run in float64 on the
    host by default, or in float32 on the accelerator with
    backend='device' (see trace_geodesics).
    """
    del verbose
    if randomize_subpixel_rays:
        rng = np.random.default_rng() if rng is None else rng
        alpha_1d, beta_1d = subpixel_jittered_axes(
            alpha_range, beta_range, num_alpha, num_beta, rng)
    else:
        alpha_1d = np.linspace(*alpha_range, num_alpha)
        beta_1d = np.linspace(*beta_range, num_beta)

    alpha, beta = np.meshgrid(alpha_1d, beta_1d, indexing='ij')
    return trace_geodesics(alpha, beta, spin, inclination, ngeo=ngeo,
                           distance=distance, E=E, M=M, tau_max=tau_max,
                           n_fine=n_fine, substeps=substeps, dtype=dtype,
                           backend=backend, mesh=mesh)


def trace_geodesics(alpha, beta, spin, inclination, ngeo=100, distance=1000.0,
                    E=1.0, M=1.0, tau_max=4.0, n_fine=8192, substeps=8,
                    dtype=None, backend='cpu', mesh=None) -> Geodesics:
    """Trace geodesics for arbitrary (alpha, beta) screen points.

    alpha/beta may be any (matching) shape; output arrays get a trailing
    ngeo axis.

    mesh (requires backend='device'): shard the flat pixel axis over
    EVERY axis of a jax.sharding.Mesh — rays are independent, so the
    integrator partitions with zero collectives and table generation
    scales with the device count (the bulk-tracing story for multi-device
    chi^2 grid scans).

    backend='cpu' (default) pins the integration to the host CPU in
    exact float64 — the reference's host/device split. backend='device'
    runs it on the default JAX backend (the GPU when one is attached) in
    float32: the integrator's RHS is pure polynomial (no accelerator
    trig — module docstring of geodesics.integrator) and coordinate time
    carries its Kahan compensation out of the kernel, so the f32 trace
    tracks the f64 one to ~1e-3 M in position and ~1e-4 M in retarded
    time (pinned by tests/test_geodesics.py). GUARANTEE SCOPE: those
    bounds hold per-sample for every sample INSIDE the emission domain
    (r <= fov; in-domain max |dt| < 1 M asserted by the tests and
    scripts/drive_device_geos.py). Far-field segments (r >> fov) of
    near-critical rays can diverge exponentially in f32 (up to ~5e1 M
    observed), but the domain mask drops them before t_geos is
    consumed, so chi^2 scans and training never see them. Use it when
    tables are
    needed in bulk — e.g. chi^2 inclination/spin grid scans re-trace per
    grid point and per sub-pixel variant (bench.py tracks
    geos_device_trace_s), and ensembles batch into one dispatch
    (alma._trace_subpixel_ensemble).
    """
    import contextlib
    if not 0.0 <= spin < 1.0:
        raise ValueError(f'spin must be in [0, 1), got {spin}')
    if not (E == 1.0 and M == 1.0):
        # rays are integrated in G = c = M = E = 1 units (kerr.py
        # hardcodes Delta = r^2 - 2r + a^2); accepting another M here
        # while ops/gr honors geos.M would silently mix two spacetimes.
        # Physical mass scaling enters through constants.GM_c3 time
        # units instead (train.step.raytracing_args).
        raise ValueError(
            f'geodesics are traced in M=E=1 units (got M={M}, E={E}); '
            f'scale times/lengths via constants.GM_c3 / GM_c2')
    if backend not in ('cpu', 'device'):
        raise ValueError(f"backend must be 'cpu' or 'device', got "
                         f'{backend!r}')
    if backend == 'device':
        # the on-device trace is a float32 product. Refuse an explicit
        # f64 request rather than silently degrading it (the GPU runs
        # f64 natively; a device-f64 trace is not measured yet).
        if dtype is not None and np.dtype(dtype) == np.float64:
            raise ValueError(
                "backend='device' traces in float32; drop the dtype "
                "argument or use backend='cpu' for the float64 host "
                'trace')
        dtype = np.float32
    elif dtype is None:
        dtype = np.float64

    # exactly polar observers hit the phi coordinate singularity; nudge off
    # the axis (physically indistinguishable at 1e-6 rad)
    inclination = float(np.clip(inclination, 1e-6, np.pi - 1e-6))
    shape = np.shape(alpha)
    alpha_flat = np.ravel(np.asarray(alpha, dtype=dtype))
    beta_flat = np.ravel(np.asarray(beta, dtype=dtype))

    if mesh is not None and backend != 'device':
        raise ValueError("mesh-sharded tracing requires backend='device' "
                         "(the host f64 path is single-process numpy)")

    # pad the ray count to a power-of-two bucket so jitted integrator
    # executables are reused across image sizes (compile amortization)
    npix = alpha_flat.size
    bucket = max(256, 1 << (npix - 1).bit_length())
    if mesh is not None and bucket % mesh.size:
        bucket += mesh.size - bucket % mesh.size   # equal shards
    alpha_pad = np.concatenate(
        [alpha_flat, np.full(bucket - npix, alpha_flat[-1], dtype=dtype)])
    beta_pad = np.concatenate(
        [beta_flat, np.full(bucket - npix, beta_flat[-1], dtype=dtype)])
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P
        pixel_sharding = NamedSharding(mesh, P(mesh.axis_names))
        alpha_pad = jax.device_put(alpha_pad, pixel_sharding)
        beta_pad = jax.device_put(beta_pad, pixel_sharding)

    use_x64 = dtype == np.float64
    ctx = jax.enable_x64(True) if use_x64 else contextlib.nullcontext()
    # precompute runs on the host CPU backend by default: exact float64
    # and it leaves the accelerator free. This is the same host/device
    # split as the reference (numpy precompute -> device training),
    # except the precompute is still jit-compiled JAX.
    if backend == 'cpu':
        try:
            cpu = jax.devices('cpu')[0]
        except RuntimeError as e:
            raise RuntimeError(
                "backend='cpu' traces on the host CPU backend, which this "
                "process has not enabled (JAX_PLATFORMS must include "
                "'cpu'); or use backend='device'") from e
        dev_ctx = jax.default_device(cpu)
    else:
        dev_ctx = contextlib.nullcontext()
    with ctx, dev_ctx:
        state0, lam, eta = integrator.initial_state(
            alpha_pad, beta_pad, spin, inclination, distance, dtype)
        tau_final = integrator.terminal_mino_time(
            state0, spin, lam, eta, distance, tau_max=tau_max, n_fine=n_fine)
        samples = integrator.sample_rays(
            state0, tau_final, spin, lam, eta, r_o=distance, ngeo=ngeo,
            substeps=substeps)
        samples = jax.tree_util.tree_map(
            lambda x: np.asarray(x)[:, :npix], samples)
        tau_final = np.asarray(tau_final)[:npix]
        lam, eta = np.asarray(lam)[:npix], np.asarray(eta)[:npix]

    def per_sample(arr):
        # (ngeo, npix) -> (*shape, ngeo)
        return np.moveaxis(arr, 0, -1).reshape(*shape, ngeo)

    r = per_sample(1.0 / samples['u'])
    # host-side exact trig: integrator works in c = cos(theta)
    theta = per_sample(np.arccos(np.clip(samples['c'], -1.0, 1.0)))
    phi = per_sample(samples['phi'])
    # fold the integrator's running Kahan error back in, in f64: for the
    # float32 on-device trace this recovers the low-order bits of the one
    # quantity that grows to O(r_o) (downstream subtracts t_injection and
    # needs O(1) differences — train.step.raytracing_args)
    t = per_sample(np.asarray(samples['t'], np.float64)
                   - np.asarray(samples['t_c'], np.float64))
    pm_r = per_sample(samples['pm_r'])
    pm_th = per_sample(samples['pm_th'])

    tau_final = tau_final.reshape(shape)
    h = tau_final / (ngeo - 1)
    mino = h[..., None] * np.arange(ngeo)
    dtau = np.broadcast_to(h[..., None], mino.shape).copy()

    return Geodesics(
        r=r, theta=theta, phi=phi, t=t, mino=mino, dtau=dtau,
        pm_r=pm_r, pm_th=pm_th,
        alpha=np.asarray(alpha, dtype=dtype).reshape(shape),
        beta=np.asarray(beta, dtype=dtype).reshape(shape),
        lam=lam.reshape(shape), eta=eta.reshape(shape),
        tau_final=tau_final,
        spin=float(spin), inc=float(inclination), M=float(M), E=float(E),
        r_o=float(distance))
