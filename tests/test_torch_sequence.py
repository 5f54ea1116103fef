"""The port's time-axis ring predict (``gordo_tpu_torch/parallel/sequence.py``)
against the JAX package's (``gordo_tpu/parallel/sequence.py``) on a 2-4
device virtual mesh, on the CPU, the cases of
``tests/parallel/test_sequence.py:36-124``: series of 200 and 203 rows
(whole and ragged chunks), lookahead 0 and 1, chunks shorter than the halo,
a series too short for a window, anomaly scores aligned with their
targets, and the LSTM estimator's routing under
``GORDO_TPU_RING_PREDICT_ROWS``. The port's ring runs over ``["cpu"] * k``;
JAX's params cross with ``params_from_jax``. Tolerance rtol 1e-5, atol
1e-6, the JAX test's.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from gordo_tpu.models.factories import lstm_model as jax_lstm_model
from gordo_tpu.models.nn import init_fn_for
from gordo_tpu.models.training import predict_fn
from gordo_tpu.parallel.sequence import ring_windowed_anomaly_scores as jax_ring_scores
from gordo_tpu.parallel.sequence import ring_windowed_predict as jax_ring_predict
from gordo_tpu_torch.models.estimators import TorchLSTMAutoEncoder
from gordo_tpu_torch.models.factories import lstm_model
from gordo_tpu_torch.models.nn import forward_lstm_windows, params_from_jax
from gordo_tpu_torch.parallel import sequence

RTOL, ATOL = 1e-5, 1e-6
DIMS = dict(encoding_dim=(8,), encoding_func=("tanh",), decoding_dim=(8,), decoding_func=("tanh",))


def _setup(lookback, lookahead=0):
    """The JAX spec and params, and the port's of the same model."""
    kwargs = dict(lookback_window=lookback, **DIMS)
    if lookahead:
        kwargs["n_features_out"] = 3
    jax_spec = jax_lstm_model(3, **kwargs)
    params = init_fn_for(jax_spec)(jax.random.PRNGKey(0), jax_spec)
    return jax_spec, params, lstm_model(3, **kwargs), params_from_jax(jax.device_get(params))


def _mesh(devices):
    return Mesh(np.array(jax.devices()[:devices]), ("data",))


@pytest.mark.parametrize("devices", [2, 4])
@pytest.mark.parametrize("lookahead", [0, 1])
@pytest.mark.parametrize("n", [200, 203])
def test_ring_predict_matches_jax(n, lookahead, devices):
    lookback = 12
    jax_spec, params, spec, port_params = _setup(lookback, lookahead)
    X = np.random.RandomState(0).rand(n, 3).astype(np.float32)
    expected = jax_ring_predict(predict_fn(jax_spec), params, X, lookback, lookahead, mesh=_mesh(devices))
    got = sequence.ring_windowed_predict(spec, port_params, X, lookback, lookahead, ["cpu"] * devices)
    assert got.shape == expected.shape == (n - (lookback + lookahead - 1), 3)
    np.testing.assert_allclose(got, expected, rtol=RTOL, atol=ATOL)
    # the port's own windowed forward on one device, to the bit
    single = {k: {name: t[None] for name, t in layer.items()} for k, layer in port_params.items()}
    one = forward_lstm_windows(spec, single, torch.from_numpy(X)[None], torch.arange(len(got))[None], 256)[0]
    np.testing.assert_array_equal(got, one.numpy())


def test_ring_short_chunks_still_correct():
    """Chunks shorter than the halo take the chunk floor."""
    lookback = 40
    jax_spec, params, spec, port_params = _setup(lookback)
    X = np.random.RandomState(1).rand(90, 3).astype(np.float32)
    expected = jax_ring_predict(predict_fn(jax_spec), params, X, lookback, 0, mesh=_mesh(4))
    got = sequence.ring_windowed_predict(spec, port_params, X, lookback, 0, ["cpu"] * 4)
    np.testing.assert_allclose(got, expected, rtol=RTOL, atol=ATOL)


def test_ring_too_short_raises_jax_message():
    jax_spec, params, spec, port_params = _setup(12)
    X = np.random.RandomState(2).rand(5, 3).astype(np.float32)
    with pytest.raises(ValueError, match="too short") as jax_error:
        jax_ring_predict(predict_fn(jax_spec), params, X, 12, 0, mesh=_mesh(2))
    with pytest.raises(ValueError, match="too short") as port_error:
        sequence.ring_windowed_predict(spec, port_params, X, 12, 0, ["cpu"] * 2)
    assert str(port_error.value) == str(jax_error.value)


def test_ring_anomaly_scores_align_targets():
    lookback = 8
    jax_spec, params, spec, port_params = _setup(lookback)
    X = np.random.RandomState(3).rand(120, 3).astype(np.float32)
    expected = jax_ring_scores(predict_fn(jax_spec), params, X, None, lookback, 0, mesh=_mesh(2))
    got = sequence.ring_windowed_anomaly_scores(spec, port_params, X, None, lookback, 0, ["cpu"] * 2)
    np.testing.assert_allclose(got, expected, rtol=RTOL, atol=ATOL)
    y = X[:, ::-1].copy()
    np.testing.assert_allclose(
        sequence.ring_windowed_anomaly_scores(spec, port_params, X, y, lookback, 0, ["cpu"] * 2),
        jax_ring_scores(predict_fn(jax_spec), params, X, y, lookback, 0, mesh=_mesh(2)), rtol=RTOL, atol=ATOL)


def test_ring_predict_enabled(monkeypatch):
    monkeypatch.setenv(sequence.RING_PREDICT_ROWS_ENV, "100")
    assert sequence.ring_predict_enabled(100, ["cpu", "cpu"])
    assert not sequence.ring_predict_enabled(99, ["cpu", "cpu"])
    assert not sequence.ring_predict_enabled(10**6, ["cpu"])  # one device: nothing to cut over
    assert sequence.ring_devices("cpu") == [torch.device("cpu")]
    monkeypatch.setenv(sequence.RING_PREDICT_ROWS_ENV, "0")
    assert not sequence.ring_predict_enabled(10**6, ["cpu", "cpu"])
    monkeypatch.delenv(sequence.RING_PREDICT_ROWS_ENV)
    assert not sequence.ring_predict_enabled(65_535, ["cpu", "cpu"])
    assert sequence.ring_predict_enabled(65_536, ["cpu", "cpu"])


@pytest.fixture(scope="module")
def estimator():
    rng = np.random.RandomState(0)
    train = rng.rand(64, 3).astype(np.float32)
    return TorchLSTMAutoEncoder(kind="lstm_model", lookback_window=4, epochs=1, batch_size=16, device="cpu").fit(
        train, train)


def test_lstm_estimator_routes_long_series_through_ring(estimator, monkeypatch):
    """Past the row threshold, with two devices to cut over, ``predict``
    takes the ring, with the windowed forward's output."""
    series = np.random.RandomState(1).rand(400, 3).astype(np.float32)
    monkeypatch.setattr(sequence, "ring_devices", lambda device: [torch.device("cpu")] * 2)
    monkeypatch.setenv(sequence.RING_PREDICT_ROWS_ENV, "0")
    direct = estimator.predict(series)
    monkeypatch.setenv(sequence.RING_PREDICT_ROWS_ENV, "300")
    calls = []
    original = sequence.ring_windowed_predict
    monkeypatch.setattr(sequence, "ring_windowed_predict", lambda *a, **k: calls.append(a[-1]) or original(*a, **k))
    ringed = estimator.predict(series)
    assert calls == [[torch.device("cpu")] * 2]
    np.testing.assert_allclose(ringed, direct, rtol=RTOL, atol=ATOL)


def test_lstm_estimator_short_series_stays_on_window_path(estimator, monkeypatch):
    monkeypatch.setattr(sequence, "ring_devices", lambda device: [torch.device("cpu")] * 2)
    monkeypatch.setenv(sequence.RING_PREDICT_ROWS_ENV, "1000")

    def boom(*args, **kwargs):
        raise AssertionError("ring path must not trigger below threshold")

    monkeypatch.setattr(sequence, "ring_windowed_predict", boom)
    out = estimator.predict(np.random.RandomState(2).rand(50, 3).astype(np.float32))
    assert out.shape == (47, 3)
