"""The port's losses (``gordo_tpu_torch/ops/losses.py``) against the JAX
package's (``gordo_tpu/ops/losses.py``) on the same seeded inputs.

Tolerance: rtol 1e-6, atol 1e-7 (f32 sums of a few dozen terms, taken in
another order). An all-zero weight vector must give NaN on both sides.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gordo_tpu.ops import losses as jax_losses
from gordo_tpu_torch.ops import losses

RTOL, ATOL = 1e-6, 1e-7


def _inputs(seed, members=4, rows=17, width=5):
    rng = np.random.RandomState(seed)
    pred = rng.randn(members, rows, width).astype(np.float32)
    target = rng.randn(members, rows, width).astype(np.float32)
    weights = (rng.rand(members, rows) > 0.3).astype(np.float32)
    weights[1] = 0.0  # a member without data
    return pred, target, weights


@pytest.mark.parametrize("name", ["mse", "mean_squared_error", "mae", "mean_absolute_error"])
def test_per_sample_loss_matches_jax(name):
    pred, target, _ = _inputs(0)
    expected = np.asarray(jax_losses.resolve_loss(name)(jnp.asarray(pred), jnp.asarray(target)))
    got = losses.resolve_loss(name)(torch.from_numpy(pred), torch.from_numpy(target)).numpy()
    np.testing.assert_allclose(got, expected, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("name", ["mse", "mae"])
def test_weighted_mean_loss_matches_jax(name, seed):
    pred, target, weights = _inputs(seed)
    per_sample = jax_losses.resolve_loss(name)(jnp.asarray(pred), jnp.asarray(target))
    expected = np.stack([
        np.asarray(jax_losses.weighted_mean_loss(per_sample[m], jnp.asarray(weights[m])))
        for m in range(len(weights))
    ])
    got = losses.weighted_mean_loss(
        losses.resolve_loss(name)(torch.from_numpy(pred), torch.from_numpy(target)), torch.from_numpy(weights)
    ).numpy()
    np.testing.assert_allclose(got, expected, rtol=RTOL, atol=ATOL)
    assert np.isnan(got[1]) and np.isnan(expected[1])  # no data is not a loss of 0
    assert np.isfinite(np.delete(got, 1)).all()


def test_all_zero_weights_give_nan_not_zero():
    per_sample = torch.zeros(3)
    assert torch.isnan(losses.weighted_mean_loss(per_sample, torch.zeros(3)))
    assert float(losses.weighted_mean_loss(per_sample, torch.ones(3))) == 0.0
    assert bool(jnp.isnan(jax_losses.weighted_mean_loss(jnp.zeros(3), jnp.zeros(3))))


def test_unknown_loss_raises():
    with pytest.raises(ValueError, match="Unknown loss"):
        losses.resolve_loss("huber")
