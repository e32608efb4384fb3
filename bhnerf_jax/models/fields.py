"""Neural emission-field predictors (NeRF MLP + voxel grid).

JAX rebuild of the model layer (reference bhnerf/network.py:18-370).
Structural differences from the reference:

* parameters are plain pytrees (dicts of jnp arrays) instead of flax
  modules — the training stack shards/replicates the pytree directly;
* the velocity-warp masking is NaN-free (`emission.velocity_warp_coords`
  with return_mask=True), so gradients stay clean including the
  learnable-t_injection path (the reference relies on NaN propagation at
  network.py:226-232, SURVEY hard-part #4);
* time-unit handling happens on host; the jitted path sees only floats.

API-parity: field hyperparameters, the sigmoid(x - 10) activation
(network.py:230), posenc with the sin-identity trick (network.py:98-122),
he_uniform init and skip connection (network.py:49-61), YAML round-trip
(network.py:239-252).
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from bhnerf_jax import emission as emission_lib
from bhnerf_jax import units


def safe_sin(x):
    """Sine with range reduction (reference network.py:16)."""
    return jnp.sin(x % (100 * jnp.pi))


def posenc(x, deg):
    """NeRF positional encoding of degree `deg` (reference network.py:98-122).

    Returns concat([x, sin(2^i x), cos(2^i x)]) via one fused sin call.
    """
    if deg == 0:
        return x
    scales = jnp.asarray([2**i for i in range(deg)], x.dtype)
    xb = jnp.reshape(x[..., None, :] * scales[:, None],
                     list(x.shape[:-1]) + [-1])
    four_feat = safe_sin(jnp.concatenate([xb, xb + 0.5 * jnp.pi], axis=-1))
    return jnp.concatenate([x, four_feat], axis=-1)


def integrated_posenc(x, x_cov, max_deg, min_deg=0):
    """mip-NeRF integrated positional encoding (reference network.py:66-96)."""
    if jnp.ndim(x_cov) == 0:
        x_cov = jnp.full_like(x, x_cov)
    scales = 2 ** jnp.arange(min_deg, max_deg)
    shape = list(x.shape[:-1]) + [-1]
    y = jnp.reshape(x[..., None, :] * scales[:, None], shape)
    y_var = jnp.reshape(x_cov[..., None, :] * scales[:, None] ** 2, shape)
    return expected_sin(jnp.concatenate([y, y + 0.5 * jnp.pi], axis=-1),
                        jnp.concatenate([y_var] * 2, axis=-1))


def expected_sin(x, x_var):
    return jnp.exp(-0.5 * x_var) * safe_sin(x)


def posenc_feature_dim(in_dim, deg):
    return in_dim * (1 + 2 * deg)


def has_learned_injection(params):
    """True when params carry the learnable injection-time offset
    (NeRFPredictor(learn_injection=True)) — the single definition of
    the predicate used by the warp paths."""
    return isinstance(params, dict) and 't_injection' in params


def learned_t_injection(params, t_injection):
    """Injection time plus the learnable offset, when trained
    (NeRFPredictor(learn_injection=True) + make_optimizer(lr_inject=...);
    the reference's commented-out t_injection param, network.py:235)."""
    if has_learned_injection(params):
        return t_injection + params['t_injection']
    return t_injection


# ---------------------------------------------------------------------------
# MLP core
# ---------------------------------------------------------------------------
def init_mlp_params(key, in_dim, net_depth=4, net_width=128, out_channel=1,
                    do_skip=True, dtype=jnp.float32):
    """he_uniform-initialized MLP parameters (reference network.py:49-50)."""
    init = jax.nn.initializers.he_uniform()
    params = {}
    dim = in_dim
    skip_layer = net_depth // 2 if do_skip else None
    for i in range(net_depth):
        key, sub = jax.random.split(key)
        params[f'dense_{i}'] = {
            'kernel': init(sub, (dim, net_width), dtype),
            'bias': jnp.zeros((net_width,), dtype),
        }
        dim = net_width
        if do_skip and i > 0 and i % skip_layer == 0:
            dim += in_dim
    key, sub = jax.random.split(key)
    params[f'dense_{net_depth}'] = {
        'kernel': init(sub, (dim, out_channel), dtype),
        'bias': jnp.zeros((out_channel,), dtype),
    }
    return params


def apply_mlp(params, x, net_depth=4, activation=jax.nn.relu, do_skip=True,
              compute_dtype='float32'):
    """MLP with mid-network skip connection (reference network.py:18-64).

    compute_dtype='bfloat16' runs every dense layer on bf16 operands with
    float32 accumulation; 'float32' keeps plain float32 matmuls."""
    dtype = jnp.bfloat16 if compute_dtype == 'bfloat16' else None

    def dense(p, h):
        if dtype is None:
            return h @ p['kernel'] + p['bias']
        return jnp.matmul(h.astype(dtype), p['kernel'].astype(dtype),
                          preferred_element_type=jnp.float32) + p['bias']

    inputs = x
    skip_layer = net_depth // 2 if do_skip else None
    for i in range(net_depth):
        x = activation(dense(params[f'dense_{i}'], x))
        if do_skip and i > 0 and i % skip_layer == 0:
            x = jnp.concatenate([x, inputs], axis=-1)
    return dense(params[f'dense_{net_depth}'], x)


# ---------------------------------------------------------------------------
# Predictors
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class NeRFPredictor:
    """Coordinate-based emission field with velocity-warp time model
    (reference NeRF_Predictor, network.py:124-252)."""

    scale: float = 1.0
    rmin: float = 0.0
    rmax: float = float(np.inf)
    z_width: float = float(np.inf)
    posenc_deg: int = 3
    posenc_var: float = 2e-5
    net_depth: int = 4
    net_width: int = 128
    out_channel: int = 1
    do_skip: bool = True
    activation: Any = jax.nn.relu
    # matmul operand dtype of the MLP: 'bfloat16' runs the tensor cores
    # at their bf16 rate with float32 accumulation. Parameters stay
    # float32.
    compute_dtype: str = 'float32'
    # learnable injection-time offset (working form of the reference's
    # commented-out t_injection param, network.py:235): adds a trained
    # scalar params['t_injection'] to the configured injection time.
    # Train with make_optimizer(lr_inject=...). Gradients flow through
    # the velocity warp.
    learn_injection: bool = False

    # -- parameters -------------------------------------------------------
    def init_params(self, seed=1, dtype=jnp.float32):
        key = jax.random.PRNGKey(seed)
        in_dim = posenc_feature_dim(3, self.posenc_deg)
        params = init_mlp_params(key, in_dim, self.net_depth,
                                 self.net_width, self.out_channel,
                                 self.do_skip, dtype)
        if self.learn_injection:
            params['t_injection'] = jnp.zeros((), dtype)
        return params

    # -- forward ----------------------------------------------------------
    def emission_at(self, params, warped_coords, valid, coords):
        """Emission from already-warped coordinates + validity mask.

        warped_coords: (..., 3) canonical-frame sample positions;
        valid: (...) bool; coords: (3, ...) unwarped positions for the
        supervision-domain mask.
        """
        net_input = jnp.where(valid[..., None], warped_coords, 0.0)
        features = posenc(net_input / self.scale, self.posenc_deg)
        out = apply_mlp(params, features, self.net_depth, self.activation,
                        self.do_skip, self.compute_dtype)
        em = jax.nn.sigmoid(out[..., 0] - 10.0)
        em = emission_lib.fill_unsupervised_emission(
            em, coords, self.rmin, self.rmax, self.z_width)
        return jnp.where(valid, em, 0.0)

    def __call__(self, params, t_frames, t_units, coords, Omega, t_start_obs,
                 t_geos, t_injection):
        """Reference-signature forward pass (network.py:191-237)."""
        t_injection = learned_t_injection(params, t_injection)
        warped, valid = emission_lib.velocity_warp_coords(
            coords, Omega, t_frames, t_start_obs, t_geos, t_injection,
            t_units=t_units, return_mask=True)
        return self.emission_at(params, warped, valid, coords)

    apply = __call__

    # -- persistence ------------------------------------------------------
    _YAML_KEYS = ('scale', 'rmin', 'rmax', 'z_width', 'posenc_deg',
                  'posenc_var', 'net_depth', 'net_width', 'out_channel',
                  'do_skip', 'compute_dtype', 'learn_injection')

    def save_params(self, directory, filename='NeRF_Predictor_params.yml'):
        directory = Path(directory)
        directory.mkdir(parents=True, exist_ok=True)
        cfg = {k: getattr(self, k) for k in self._YAML_KEYS}
        cfg = {k: (float(v) if isinstance(v, (int, float, np.floating))
                   and k not in ('posenc_deg', 'net_depth', 'net_width',
                                 'out_channel', 'do_skip',
                                 'learn_injection') else v)
               for k, v in cfg.items()}
        import yaml
        with open(directory / filename, 'w') as f:
            yaml.dump(cfg, f)

    @classmethod
    def from_yml(cls, directory, filename='NeRF_Predictor_params.yml'):
        import yaml
        cfg = yaml.safe_load((Path(directory) / filename).read_text())
        # hand-edited files sometimes quote infinities as strings
        inf_forms = {'.inf': np.inf, 'inf': np.inf,
                     '-.inf': -np.inf, '-inf': -np.inf}
        cfg = {k: inf_forms.get(v, v) if isinstance(v, str) else v
               for k, v in cfg.items()}
        return cls(**cfg)


@dataclasses.dataclass(frozen=True)
class GridPredictor:
    """Voxel-grid emission field with trilinear lookup
    (reference GRID_Predictor, network.py:254-370)."""

    scale: float = 1.0
    rmin: float = 0.0
    rmax: float = float(np.inf)
    z_width: float = float(np.inf)
    grid_res: int = 64

    def init_params(self, seed=1, dtype=jnp.float32):
        del seed
        return {'grid': jnp.full((self.grid_res,) * 3, -10.0, dtype)}

    def emission_at(self, params, warped_coords, valid, coords):
        from jax.scipy.ndimage import map_coordinates
        net_input = jnp.where(valid[..., None], warped_coords, 0.0)
        idx = (jnp.moveaxis(net_input, -1, 0) + self.scale) / (
            2 * self.scale) * (self.grid_res - 1.0)
        out = map_coordinates(params['grid'], list(idx), order=1, cval=0.0)
        em = jax.nn.sigmoid(out - 10.0)
        em = emission_lib.fill_unsupervised_emission(
            em, coords, self.rmin, self.rmax, self.z_width)
        return jnp.where(valid, em, 0.0)

    def __call__(self, params, t_frames, t_units, coords, Omega, t_start_obs,
                 t_geos, t_injection):
        warped, valid = emission_lib.velocity_warp_coords(
            coords, Omega, t_frames, t_start_obs, t_geos, t_injection,
            t_units=t_units, return_mask=True)
        return self.emission_at(params, warped, valid, coords)

    apply = __call__

    _YAML_KEYS = ('scale', 'rmin', 'rmax', 'z_width', 'grid_res')

    def save_params(self, directory, filename='GRID_Predictor_params.yml'):
        directory = Path(directory)
        directory.mkdir(parents=True, exist_ok=True)
        import yaml
        with open(directory / filename, 'w') as f:
            yaml.dump({k: getattr(self, k) for k in self._YAML_KEYS}, f)

    @classmethod
    def from_yml(cls, directory, filename='GRID_Predictor_params.yml'):
        import yaml
        cfg = yaml.safe_load((Path(directory) / filename).read_text())
        return cls(**cfg)


# API-parity aliases (reference class names)
NeRF_Predictor = NeRFPredictor
GRID_Predictor = GridPredictor


def sample_3d_grid(predictor, params, t_frame=0.0, t_start_obs=0.0,
                   Omega=0.0, fov=None, coords=None, resolution=64,
                   chunk=-1):
    """Sample the trained field on a regular 3D grid
    (reference network.py:797-840)."""
    if coords is None and fov is not None:
        grid_1d = np.linspace(-fov / 2, fov / 2, resolution)
        coords = np.stack(np.meshgrid(grid_1d, grid_1d, grid_1d,
                                      indexing='ij'))
    elif coords is None:
        raise ValueError('Either coords or fov+resolution must be provided')

    t_units = t_frame.unit if isinstance(t_frame, units.Quantity) else None
    resolution = coords.shape[1]
    chunk = resolution if chunk < 0 else chunk
    # the grid is sampled in the canonical frame, where the injection
    # time is irrelevant — but the learnable offset would shift the
    # t >= t_injection validity mask and (for a positive offset) zero
    # the whole volume; drop it for sampling
    if isinstance(params, dict) and 't_injection' in params:
        params = {k: v for k, v in params.items() if k != 't_injection'}

    out = []
    for c in range(int(np.ceil(resolution / chunk))):
        sl = slice(c * chunk, (c + 1) * chunk)
        coords_chunk = jnp.asarray(coords[:, sl])
        Omega_chunk = Omega if np.isscalar(Omega) else jnp.asarray(Omega[sl])
        out.append(np.asarray(predictor(
            params, t_frame, t_units, coords_chunk, Omega_chunk,
            t_start_obs, 0.0, 0.0)))
    return np.concatenate(out, axis=0)
