"""The port's LSTM path on the card against the same on the CPU: the
windowed forward (``forward_lstm_windows``: windows gathered on the
device, 256 a batch) of lstm_model's defaults and of the hourglass, one
windowed fit, an LSTM estimator's fit and predict, and a served LSTM
bucket's fleet scores.

Every test here needs an NVIDIA GPU; on a machine without one each
skips. The file imports neither JAX nor the JAX package, so it runs on
the card's machine (``tests/conftest.py`` imports JAX, hence
``--noconftest``)::

    python -m pytest --noconftest -q -m cuda tests/test_torch_lstm_cuda.py

Tolerances, TF32 off: forwards rtol 1e-5, atol 1e-5 (f32 sums in another
order, cuBLAS against the CPU's BLAS, through 10 steps of recurrence).
The fit, card against CPU: losses rtol 1e-5, params atol 1e-4 after two
epochs (Adam divides each gradient by its own running scale, so a
last-bit difference of a near-zero gradient moves a parameter by a
fraction of the learning rate).
"""

import numpy as np
import pytest
import torch

from gordo_tpu_torch import serializer
from gordo_tpu_torch.models.anomaly.diff import DiffBasedAnomalyDetector
from gordo_tpu_torch.models.estimators import TorchLSTMForecast
from gordo_tpu_torch.models.factories import lstm_hourglass, lstm_model
from gordo_tpu_torch.models.nn import forward_lstm_windows, init_lstm, params_to_numpy
from gordo_tpu_torch.models.training import FitConfig
from gordo_tpu_torch.ops.windows import window_targets
from gordo_tpu_torch.parallel.fleet import FleetTrainer, WindowedFleetMember, stack_member_params
from gordo_tpu_torch.server.fleet_store import RevisionFleet

RTOL, ATOL = 1e-5, 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _series(members, rows, features, seed=0):
    return np.random.RandomState(seed).rand(members, rows, features).astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("spec", [lstm_model(20, lookback_window=10),
                                  lstm_hourglass(20, lookback_window=10, encoding_layers=2)],
                         ids=["lstm_model", "lstm_hourglass"])
@pytest.mark.parametrize("members", [1, 4])
def test_windowed_forward_on_card_matches_cpu(cuda, spec, members):
    params = stack_member_params([init_lstm(spec, torch.Generator().manual_seed(s)) for s in range(members)])
    series = torch.from_numpy(_series(members, 600, 20))
    order = torch.arange(600 - 9).repeat(members, 1)
    expected = forward_lstm_windows(spec, params, series, order)
    on_card = {k: {n: t.to(cuda) for n, t in layer.items()} for k, layer in params.items()}
    got = forward_lstm_windows(spec, on_card, series.to(cuda), order.to(cuda))
    assert got.device.type == "cuda" and got.shape == (members, 591, 20)
    np.testing.assert_allclose(got.cpu().numpy(), expected.numpy(), rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
def test_windowed_fit_on_card_matches_cpu(cuda):
    spec = lstm_hourglass(20, lookback_window=10, encoding_layers=2)
    series = _series(3, 300, 20, seed=1)
    config = FitConfig(epochs=2, batch_size=32, validation_split=0.2, shuffle=False)

    def members():
        return [WindowedFleetMember(f"m-{i}", spec, series[i, : 300 - 20 * i],
                                    window_targets(series[i, : 300 - 20 * i], 10), seed=5 + i) for i in range(3)]

    on_cpu = FleetTrainer("cpu").train(members(), config)
    on_card = FleetTrainer(cuda).train(members(), config)
    for want, got in zip(on_cpu, on_card):
        for key in ("loss", "val_loss"):
            np.testing.assert_allclose(got.history.history[key], want.history.history[key], rtol=RTOL)
        for key, layer in want.params.items():
            for name, leaf in layer.items():
                np.testing.assert_allclose(got.params[key][name], leaf, atol=1e-4, err_msg=f"{key}/{name}")


@pytest.mark.cuda
def test_lstm_estimator_on_card_matches_cpu(cuda, tmp_path):
    X = _series(1, 400, 20, seed=2)[0]
    kwargs = dict(kind="lstm_symmetric", lookback_window=10, dims=[64, 32], funcs=["tanh", "tanh"], epochs=1)
    card = TorchLSTMForecast(device=cuda, **kwargs).fit(X, X)
    serializer.dump(card, str(tmp_path / "m"))
    cpu = serializer.load(str(tmp_path / "m"), "cpu")
    assert card.predict(X).shape == (390, 20)
    np.testing.assert_allclose(card.predict(X), cpu.predict(X), rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
def test_served_lstm_bucket_on_card_matches_cpu(cuda, tmp_path):
    spec = lstm_model(20, lookback_window=10)
    for i, name in enumerate(("ae", "fc")):
        detector = DiffBasedAnomalyDetector.from_state({
            "spec": spec.to_dict(), "lookahead": i,
            "params": params_to_numpy(init_lstm(spec, torch.Generator().manual_seed(i))),
            "pipeline": [{"scale_": np.full(20, 0.5), "min_": np.full(20, -0.1)}],
            "scaler": {"scale_": np.ones(20), "min_": np.zeros(20)},
        }, device="cpu")
        serializer.dump(detector, str(tmp_path / name))
    inputs = {"ae": _series(1, 1008, 20, 3)[0], "fc": _series(1, 700, 20, 4)[0]}
    scores = [RevisionFleet(str(tmp_path), device).fleet_scores(inputs) for device in (torch.device("cpu"), cuda)]
    assert scores[0][1] == scores[1][1] == {}
    for name in inputs:
        for want, got in zip(scores[0][0][name], scores[1][0][name]):
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert len(scores[1][0]["ae"][0]) == 999 and len(scores[1][0]["fc"][0]) == 690
