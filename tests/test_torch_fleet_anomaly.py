"""K2, the fused fleet anomaly scores, against the JAX package.

On the CPU the wrapper runs its plain version (``fleet_anomaly_scores_reference``).
It is held against ``fleet_anomaly_scores_pallas(..., interpret=True)`` at the
cases of ``tests/ops/test_pallas_dense.py`` plus an hourglass(20) and two wide
specs, and, for the gather and ingest the store uses, against the JAX
``fleet_forward_gather`` followed by the JAX store's ``mse_vs_raw`` rule
(``gordo_tpu/server/fleet_store.py:554-560``): the error over the first
``min(F_out, F_y)`` columns. Tolerance: rtol 1e-5, atol 1e-6, the JAX
package's own for its kernel (``tests/ops/test_pallas_dense.py:28``). Inputs
and params are made with seeded numpy and JAX and given to both packages.
"""

import jax
import numpy as np
import pytest
import torch

import gordo_tpu.ops.pallas_dense as pallas_dense
from gordo_tpu.models import factories as jax_factories
from gordo_tpu.models.nn import init_feedforward as jax_init
from gordo_tpu.server.fleet_store import fleet_forward_gather as jax_forward_gather
from gordo_tpu_torch.models import factories
from gordo_tpu_torch.models.nn import init_feedforward, params_from_jax
from gordo_tpu_torch.ops.fleet_dense import (
    fleet_anomaly_scores,
    fleet_anomaly_scores_reference,
    fleet_feedforward,
)
from gordo_tpu_torch.parallel.fleet import stack_member_params

RTOL, ATOL = 1e-5, 1e-6


def _jax_bucket(spec, n, seed):
    keys = jax.random.split(jax.random.PRNGKey(seed), n)
    return jax.vmap(lambda k: jax_init(k, spec))(keys)


def _port(bucket):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, bucket))


def _both(factory, *args, **kwargs):
    return getattr(jax_factories, factory)(*args, **kwargs), getattr(factories, factory)(*args, **kwargs)


def _mse_vs_raw(recon, raw):
    """The JAX store's rule, in numpy float32."""
    width = min(recon.shape[-1], raw.shape[-1])
    return ((recon[..., :width] - raw[..., :width]) ** 2).mean(axis=-1)


def _close(got, expected):
    np.testing.assert_allclose(got.numpy(), np.asarray(expected), rtol=RTOL, atol=ATOL)


SPECS = {
    "hourglass12": ("feedforward_hourglass", (12,), {}),
    "hourglass5": ("feedforward_hourglass", (5,), {}),
    "hourglass20": ("feedforward_hourglass", (20,), {}),
    "relu-explicit": ("feedforward_model", (6, 6), dict(
        encoding_dim=(8, 4), decoding_dim=(4, 8),
        encoding_func=("relu", "relu"), decoding_func=("relu", "relu"))),
    "wide-hourglass40": ("feedforward_hourglass", (40,), {}),
    "wide-48": ("feedforward_model", (6,), dict(
        encoding_dim=(48,), decoding_dim=(40,), encoding_func=("tanh",), decoding_func=("relu",))),
    "wide-64-128": ("feedforward_model", (24,), dict(
        encoding_dim=(128, 64), decoding_dim=(64, 128), encoding_func=("tanh", "relu"), decoding_func=("tanh", "tanh"))),
    "wide-64-relu": ("feedforward_model", (20,), dict(
        encoding_dim=(64,), decoding_dim=(64,), encoding_func=("relu",), decoding_func=("elu",))),
}


#: (spec, members, rows): the JAX file's cases, then the added specs
CASES = [
    ("hourglass12", 1, 8),
    ("hourglass12", 4, 32),
    ("relu-explicit", 3, 16),
    ("hourglass5", 2, 10),
    ("hourglass20", 4, 32),
    ("wide-hourglass40", 2, 16),
    ("wide-48", 2, 16),
    ("wide-hourglass40", 3, 24),
    ("wide-64-128", 2, 16),
    ("wide-64-relu", 2, 16),
]


@pytest.mark.parametrize("y_is_x", [True, False], ids=["y=X", "separate-y"])
@pytest.mark.parametrize("name,m,b", CASES)
def test_scores_match_pallas(name, m, b, y_is_x):
    factory, args, kwargs = SPECS[name]
    jax_spec, spec = _both(factory, *args, **kwargs)
    bucket = _jax_bucket(jax_spec, m, 0)
    rng = np.random.RandomState(0)
    X = rng.rand(m, b, spec.n_features).astype(np.float32)
    y = X if y_is_x else rng.rand(m, b, spec.n_features_out).astype(np.float32)
    expected_recon, expected_mse = pallas_dense.fleet_anomaly_scores_pallas(jax_spec, bucket, X, y, interpret=True)
    x = torch.from_numpy(X)
    launches = fleet_anomaly_scores.launches
    recon, mse = fleet_anomaly_scores(spec, _port(bucket), x, x if y_is_x else torch.from_numpy(y))
    assert fleet_anomaly_scores.launches == launches  # CPU runs are plain runs
    assert mse.shape == (m, b) and mse.dtype == torch.float32
    _close(recon, expected_recon)
    _close(mse, expected_mse)


def test_scores_ragged_batch_match_pallas(monkeypatch):
    """50 rows: the JAX kernel pads to its 16-row blocks and trims."""
    monkeypatch.setattr(pallas_dense, "BLOCK_B", 16)
    jax_spec, spec = _both("feedforward_hourglass", 7)
    bucket = _jax_bucket(jax_spec, 2, 3)
    X = np.random.RandomState(3).rand(2, 50, 7).astype(np.float32)
    expected_recon, expected_mse = pallas_dense.fleet_anomaly_scores_pallas(jax_spec, bucket, X, X, interpret=True)
    x = torch.from_numpy(X)
    recon, mse = fleet_anomaly_scores(spec, _port(bucket), x, x)
    _close(recon, expected_recon)
    _close(mse, expected_mse)


@pytest.mark.parametrize("n_features", [9, 40], ids=["narrow", "wide"])
def test_gather_ingest_scores_match_jax_store_rule(n_features):
    """The store's launch: gather indices with repeats and the ingest
    prologue, y the raw rows; against JAX ``fleet_forward_gather`` and
    ``mse_vs_raw``."""
    jax_spec, spec = _both("feedforward_hourglass", n_features)
    bucket = _jax_bucket(jax_spec, 5, 4)
    rng = np.random.RandomState(4)
    indices = np.array([3, 0, 3, 4], np.int32)
    X = (rng.rand(4, 21, n_features) * 50).astype(np.float32)
    plan = ((rng.rand(5, n_features) / 50).astype(np.float32), (rng.rand(5, n_features) - 0.5).astype(np.float32))
    expected = np.asarray(jax_forward_gather(jax_spec, bucket, indices, X, ingest=tuple(jax.numpy.asarray(a) for a in plan)))
    x = torch.from_numpy(X)
    recon, mse = fleet_anomaly_scores(
        spec, _port(bucket), x, x, indices=indices, ingest=tuple(torch.from_numpy(a) for a in plan)
    )
    _close(recon, expected)
    _close(mse, _mse_vs_raw(expected, X))


@pytest.mark.parametrize("width_delta", [-3, 2], ids=["F_y<F_out", "F_y>F_out"])
def test_scores_with_other_target_width(width_delta):
    """w = min(F_out, F_y): a model whose targets differ from its inputs."""
    jax_spec, spec = _both("feedforward_hourglass", 8)
    bucket = _jax_bucket(jax_spec, 3, 5)
    rng = np.random.RandomState(5)
    X = rng.rand(3, 17, 8).astype(np.float32)
    y = rng.rand(3, 17, 8 + width_delta).astype(np.float32)
    expected = np.asarray(pallas_dense.fleet_feedforward_pallas(jax_spec, bucket, X, interpret=True))
    recon, mse = fleet_anomaly_scores(spec, _port(bucket), torch.from_numpy(X), torch.from_numpy(y))
    _close(recon, expected)
    _close(mse, _mse_vs_raw(expected, y))


@pytest.mark.parametrize("where", ["X", "y"])
def test_nan_row_propagates(where):
    """A NaN makes its row's mse NaN and no other: no NaN skipping here."""
    jax_spec, spec = _both("feedforward_hourglass", 6)
    bucket = _jax_bucket(jax_spec, 2, 6)
    rng = np.random.RandomState(6)
    X = rng.rand(2, 12, 6).astype(np.float32)
    y = X.copy()
    (X if where == "X" else y)[1, 4, 2] = np.nan
    expected_recon, expected_mse = pallas_dense.fleet_anomaly_scores_pallas(jax_spec, bucket, X, y, interpret=True)
    recon, mse = fleet_anomaly_scores(spec, _port(bucket), torch.from_numpy(X), torch.from_numpy(y))
    assert np.isnan(np.asarray(expected_mse)[1, 4])
    assert torch.isnan(mse).nonzero().tolist() == [[1, 4]]
    _close(recon, expected_recon)
    _close(mse, expected_mse)


def test_reference_is_k1_then_the_mean():
    spec = factories.feedforward_hourglass(5)
    bucket = stack_member_params([init_feedforward(spec, torch.Generator().manual_seed(i)) for i in range(2)])
    X = torch.rand(2, 9, 5, generator=torch.Generator().manual_seed(1))
    y = torch.rand(2, 9, 4, generator=torch.Generator().manual_seed(2))
    recon, mse = fleet_anomaly_scores_reference(spec, bucket, X, y)
    torch.testing.assert_close(recon, fleet_feedforward(spec, bucket, X), rtol=0, atol=0)
    torch.testing.assert_close(mse, ((recon[..., :4] - y) ** 2).sum(-1) / 4, rtol=1e-6, atol=0)


def test_scores_arguments_are_checked():
    spec = factories.feedforward_hourglass(4)
    bucket = stack_member_params([init_feedforward(spec, torch.Generator().manual_seed(0))])
    X = torch.zeros(1, 3, 4)
    with pytest.raises(ValueError):
        fleet_anomaly_scores(spec, bucket, X, torch.zeros(1, 2, 4))  # rows differ
    with pytest.raises(ValueError):
        fleet_anomaly_scores(spec, bucket, X, torch.zeros(3, 4))  # not [M, B, F_y]
    with pytest.raises(ValueError):
        fleet_anomaly_scores(spec, bucket, X, torch.zeros(1, 3, 0))  # no columns
    with pytest.raises(TypeError):
        fleet_anomaly_scores(spec, bucket, X, torch.zeros(1, 3, 4, dtype=torch.float64))
    with pytest.raises(ValueError):
        fleet_anomaly_scores(spec, bucket, X, torch.zeros(1, 3, 4, device="meta"))
