"""Coverage for facade-level utilities: tv_reg, flattened_traversal,
lr_inject masking, sample_checkpoint_3d, units edge cases."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from bhnerf_jax import network, units
from bhnerf_jax.models import NeRFPredictor
from bhnerf_jax.train import TrainState, make_optimizer, save_checkpoint


def test_tv_reg_finite_and_scales():
    predictor = NeRFPredictor(net_depth=2, net_width=16, rmax=np.inf,
                              z_width=np.inf)
    params = predictor.init_params(seed=0)
    coords = np.random.default_rng(0).uniform(-1, 1, (32, 3)).astype(
        np.float32)
    r1 = float(network.tv_reg(predictor, params, coords, lam=1.0))
    r2 = float(network.tv_reg(predictor, params, coords, lam=2.0))
    assert np.isfinite(r1) and r1 > 0
    np.testing.assert_allclose(r2, 2 * r1, rtol=1e-6)


def test_flattened_traversal_mask():
    tree = {'a': {'t_injection': 1.0, 'w': 2.0}, 'b': {'w': 3.0}}
    mask = network.flattened_traversal(
        lambda path, _: path[-1] == 't_injection')(tree)
    assert mask == {'a': {'t_injection': True, 'w': False},
                    'b': {'w': False}}


def test_lr_inject_masked_optimizer():
    """lr_inject builds a masked two-rate optimizer that updates
    t_injection params with its own learning rate."""
    tx = make_optimizer(100, lr_init=1e-3, lr_inject=1e-1)
    params = {'t_injection': jnp.zeros(()), 'w': jnp.zeros(())}
    state = tx.init(params)
    grads = {'t_injection': jnp.ones(()), 'w': jnp.ones(())}
    updates, _ = tx.update(grads, state, params)
    # adam normalizes, so |update| ~ lr for each group
    assert abs(float(updates['t_injection'])) > 10 * abs(
        float(updates['w']))


def test_sample_checkpoint_3d(tmp_path):
    predictor = NeRFPredictor(net_depth=2, net_width=16, scale=4.0)
    params = predictor.init_params(seed=0)
    state = TrainState.create(params, make_optimizer(10))
    predictor.save_params(tmp_path)
    save_checkpoint(tmp_path, state, 10)
    vol = network.sample_checkpoint_3d(tmp_path, fov=8.0, resolution=16)
    assert vol.shape == (16, 16, 16)
    ref = network.sample_3d_grid(predictor, params, fov=8.0, resolution=16)
    np.testing.assert_allclose(vol, ref, atol=1e-6)


def test_units_edge_cases():
    q = units.Quantity(2.0, 'hr')
    assert q.to('min').value == 120.0
    assert (3.0 * units.hr).unit == units.hr
    t = units.Quantity(np.array([1.0, 2.0]), 'hr')
    assert len(t) == 2 and t[1].value == 2.0
    assert (t + units.Quantity(30.0, 'min')).value[0] == 1.5
    with pytest.raises(ValueError):
        q.to('kg')
    # division of like quantities gives a plain ratio
    assert units.Quantity(1.0, 'hr') / units.Quantity(30.0, 'min') == 2.0
