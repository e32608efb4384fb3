"""Reference-API compatibility facade for the model/losses layer.

The reference exposes models, losses and jitted steps under
`bhnerf.network` (reference bhnerf/network.py). Implementations live in
`bhnerf_jax.models.fields` and `bhnerf_jax.train.step`; this module
re-exports them under the reference names, plus the few small utilities
that have no better home.
"""
import jax
import jax.numpy as jnp
import numpy as np

from bhnerf_jax.models.fields import (GRID_Predictor, GridPredictor,
                                      NeRF_Predictor, NeRFPredictor,
                                      apply_mlp, expected_sin,
                                      init_mlp_params, integrated_posenc,
                                      posenc, safe_sin, sample_3d_grid)
from bhnerf_jax.train.step import (image_plane_prediction, loss_fn_eht,
                                   loss_fn_image, raytracing_args)


def sample_checkpoint_3d(checkpoint_dir, t_frame=0, t_start_obs=0, Omega=0,
                         fov=None, coords=None, resolution=64, chunk=-1):
    """Sample a trained checkpoint's 3D emission volume
    (reference network.py:842-848)."""
    from bhnerf_jax.train.state import restore_params
    predictor = NeRFPredictor.from_yml(checkpoint_dir)
    params = restore_params(checkpoint_dir)
    return sample_3d_grid(predictor, params, t_frame, t_start_obs, Omega,
                          fov, coords, resolution, chunk)


def image_plane_checkpoint(raytracing_args, checkpoint_dir, t, rmin=0.0,
                           rmax=np.inf, batchsize=20):
    """Re-render the image plane from a checkpoint
    (reference network.py:896-906)."""
    from bhnerf_jax import alma
    return alma.image_plane_checkpoint(raytracing_args, checkpoint_dir, t,
                                       rmin, rmax, batchsize)


def tv_reg(predictor, params, coords, lam=1.0):
    """Total-variation-style regularizer: mean |grad_x emission| at the
    given coordinates (reference network.py:908-933 — which is broken
    upstream by an undefined `lam`; here lam is an explicit argument)."""
    def predict(c):
        warped = c[None, :]
        valid = jnp.ones((1,), bool)
        return predictor.emission_at(params, warped, valid, c[:, None])[0]

    coords = jnp.asarray(coords)
    if coords.shape[0] == 3 and coords.shape[-1] != 3:
        # accept the codebase-standard component-leading (3, ...) layout
        # (velocity_warp_coords / domain_mask convention); reshape(-1, 3)
        # on it would interleave components into fake 3D points
        coords = jnp.moveaxis(coords, 0, -1)
    grad_fn = jax.vmap(jax.grad(predict))
    grads = grad_fn(coords.reshape(-1, 3))
    return lam * jnp.sum(jnp.abs(grads))


def flattened_traversal(fn):
    """Parameter-path mask builder (reference network.py:935-939)."""
    from bhnerf_jax.train.state import _flatten_dict, _unflatten_dict

    def mask(data):
        flat = _flatten_dict(data)
        return _unflatten_dict({k: fn(k, v) for k, v in flat.items()})

    return mask
