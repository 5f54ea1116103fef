"""The port's LSTM modules against the JAX package's, one by one, on the CPU.

- ``ops/windows.py``: window counts, offsets, windows and targets over
  (lookback, lookahead), numpy and torch, and the device gather;
- ``models/factories/lstm_autoencoder.py``: the three factories' specs,
  field by field, and the specs' dict form both ways;
- ``models/nn.py``: ``init_lstm``'s shapes, forget-gate bias and
  orthonormal ``Wh`` rows; ``forward_lstm`` for tanh, relu and sigmoid
  specs, JAX's params injected, rtol 1e-5, atol 1e-6 (f32, sums in
  another order); the stacked forward and the batched window forward;
- ``models/training.py::WindowedFit`` through both packages' fleet
  trainers (JAX's runs ``build_raw_windowed_fit_fn`` under ``jit(vmap)``):
  ragged series, an explicit window order, fold-like train weights, a
  validation split, ``EarlyStopping`` with restore-best, and a shuffled
  fit; JAX's init and permutations injected. Histories rtol 1e-5, params
  atol 1e-6 (measured: params within 3e-8, histories 1.8e-7 relative).
  And the windowed fit equal to the dense fit on the same windows made
  beforehand, as the JAX package holds its own
  (``tests/parallel/test_fleet_windowed.py:53-72``);
- the planner's geometric ladder and windowed buckets;
- the LSTM estimators, the definition reader's LSTM paths, the
  detector's tail-aligned ``score`` and the fleet store's LSTM bucket.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gordo_tpu.models.callbacks import EarlyStopping as JaxEarlyStopping
from gordo_tpu.models.factories import lstm_autoencoder as jax_factories
from gordo_tpu.models.nn import forward_lstm as jax_forward_lstm, init_lstm as jax_init_lstm
from gordo_tpu.models.training import FitConfig as JaxFitConfig
from gordo_tpu.ops import windows as jax_windows
from gordo_tpu.parallel.fleet import FleetTrainer as JaxFleetTrainer, WindowedFleetMember as JaxWindowedMember
from gordo_tpu.planner import ladder as jax_ladder
from gordo_tpu_torch import serializer
from gordo_tpu_torch.models import factories
from gordo_tpu_torch.models.anomaly.diff import DiffBasedAnomalyDetector
from gordo_tpu_torch.models.callbacks import EarlyStopping
from gordo_tpu_torch.models.estimators import TorchLSTMAutoEncoder, TorchLSTMForecast
from gordo_tpu_torch.models.nn import (
    forward_lstm,
    forward_lstm_stacked,
    forward_lstm_windows,
    init_lstm,
    params_from_jax,
    params_to_numpy,
)
from gordo_tpu_torch.models.spec import FeedForwardSpec, LSTMSpec, spec_from_dict
from gordo_tpu_torch.models.training import FitConfig, StackedFit, WindowedFit
from gordo_tpu_torch.ops import windows
from gordo_tpu_torch.parallel.fleet import FleetTrainer, WindowedFleetMember, stack_member_params
from gordo_tpu_torch.planner import packing
from gordo_tpu_torch.server.fleet_store import RevisionFleet

RTOL, ATOL = 1e-5, 1e-6
LOOKBACK = 4


@functools.partial(jax.jit, static_argnums=1)
def _jax_init_params(seed, spec):
    _, init = jax.random.split(jax.random.PRNGKey(seed))
    return jax_init_lstm(init, spec)


@functools.partial(jax.jit, static_argnums=(1, 2))
def _jax_permutations(seed, epochs, n_total):
    fit, _ = jax.random.split(jax.random.PRNGKey(seed))
    return jax.vmap(lambda key: jax.random.permutation(key, n_total))(jax.random.split(fit, epochs))


class JaxRandom:
    """The JAX fleet trainer's randomness for an LSTM bucket: init from the
    second half of ``split(PRNGKey(seed))``, one permutation an epoch from
    the first."""

    def init_params(self, spec, seed):
        return jax.tree_util.tree_map(np.array, _jax_init_params(seed, spec))

    def permutations(self, seed, epochs, n_total):
        return np.array(_jax_permutations(seed, epochs, n_total))


def _series(rows, features, seed):
    return np.random.RandomState(seed).rand(rows, features).astype(np.float32)


# -- ops/windows.py ------------------------------------------------------------------


@pytest.mark.parametrize("lookback,lookahead", [(1, 0), (4, 0), (4, 1), (6, 1)])
def test_window_helpers_match_jax(lookback, lookahead):
    X = _series(20, 3, 0)
    y = _series(20, 2, 1)
    assert windows.num_windows(20, lookback, lookahead) == jax_windows.num_windows(20, lookback, lookahead)
    assert windows.model_offset(lookback, lookahead) == jax_windows.model_offset(lookback, lookahead)
    expected = jax_windows.sliding_windows(X, lookback, lookahead)
    np.testing.assert_array_equal(windows.sliding_windows(X, lookback, lookahead), expected)
    np.testing.assert_array_equal(windows.sliding_windows(torch.from_numpy(X), lookback, lookahead).numpy(), expected)
    targets = jax_windows.window_targets(y, lookback, lookahead)
    np.testing.assert_array_equal(windows.window_targets(y, lookback, lookahead), targets)
    got_w, got_t = windows.windowed_dataset(X, y, lookback, lookahead)
    np.testing.assert_array_equal(got_w, expected)
    np.testing.assert_array_equal(got_t, targets)
    assert windows.windowed_dataset(X, None, lookback, lookahead)[1] is None
    # the device gather: window k of each member, time major
    starts = torch.tensor([[0, 3, len(expected) - 1], [2, 2, 0]])
    series = torch.from_numpy(np.stack([X, X[::-1].copy()]))
    gathered = windows.gather_windows(series, starts, lookback)
    assert tuple(gathered.shape) == (2, lookback, 3, 3)
    for m in range(2):
        member = jax_windows.sliding_windows(series[m].numpy(), lookback, lookahead)
        for b in range(3):
            np.testing.assert_array_equal(gathered[m, :, b].numpy(), member[starts[m, b]])


def test_too_short_series_raises_as_jax():
    with pytest.raises(ValueError, match="too short"):
        windows.sliding_windows(_series(4, 2, 0), 4, 1)
    with pytest.raises(ValueError, match="too short"):
        jax_windows.sliding_windows(_series(4, 2, 0), 4, 1)


# -- factories and specs ------------------------------------------------------------

FACTORY_CASES = [
    ("lstm_model", {}),
    ("lstm_model", {"encoding_dim": (5, 3), "encoding_func": ("relu", "tanh"), "decoding_dim": (3,),
                    "decoding_func": ("sigmoid",), "out_func": "tanh", "optimizer": "RMSprop",
                    "optimizer_kwargs": {"lr": 0.01}, "compile_kwargs": {"loss": "mae"}}),
    ("lstm_symmetric", {"dims": (64, 32), "funcs": ("tanh", "tanh")}),
    ("lstm_hourglass", {"encoding_layers": 2, "compression_factor": 0.5}),
    ("lstm_hourglass", {"compression_factor": 0.2, "func": "relu"}),
]


@pytest.mark.parametrize("kind,kwargs", FACTORY_CASES)
@pytest.mark.parametrize("n_features", [3, 20])
def test_factories_match_jax(kind, kwargs, n_features):
    spec = getattr(factories, kind)(n_features, lookback_window=10, **kwargs)
    jax_spec = getattr(jax_factories, kind)(n_features, lookback_window=10, **kwargs)
    assert spec.to_dict() == jax_spec.to_dict()
    assert LSTMSpec.from_dict(jax_spec.to_dict()) == spec
    assert spec_from_dict(spec.to_dict()) == spec
    assert hash(spec) == hash(LSTMSpec.from_dict(spec.to_dict()))


def test_spec_dicts_name_their_kind():
    ff = factories.feedforward_hourglass(4)
    assert spec_from_dict(ff.to_dict()) == ff
    with pytest.raises(ValueError, match="Not a LSTMSpec"):
        LSTMSpec.from_dict(ff.to_dict())
    with pytest.raises(ValueError, match="at least one layer"):
        LSTMSpec(3, 3, 4, (), ())
    with pytest.raises(ValueError, match="Unknown spec_type"):
        spec_from_dict({"spec_type": "ConvSpec"})
    assert isinstance(spec_from_dict({k: v for k, v in ff.to_dict().items() if k != "spec_type"}), FeedForwardSpec)


# -- models/nn.py --------------------------------------------------------------------


def test_init_lstm_layout():
    """Shapes as JAX's, Glorot-bounded ``Wx``, orthonormal ``Wh`` rows, the
    forget slice of ``b`` at 1 and the rest 0, drawn the same from a seed."""
    spec = factories.lstm_symmetric(3, lookback_window=LOOKBACK, dims=(5, 2), funcs=("tanh", "tanh"))
    params = init_lstm(spec, torch.Generator().manual_seed(3))
    jax_params = jax_init_lstm(jax.random.PRNGKey(0), spec)
    assert list(params) == ["lstm_0", "lstm_1", "lstm_2", "lstm_3", "out"]
    for key, layer in jax_params.items():
        assert {n: tuple(t.shape) for n, t in params[key].items()} == {n: a.shape for n, a in layer.items()}
    in_dim = spec.n_features
    for i, units in enumerate(spec.dims):
        layer = params[f"lstm_{i}"]
        limit = np.sqrt(6.0 / (in_dim + 4 * units))
        assert float(layer["Wx"].abs().max()) <= limit
        np.testing.assert_allclose((layer["Wh"] @ layer["Wh"].T).numpy(), np.eye(units), atol=1e-6)
        expected_b = np.zeros(4 * units, np.float32)
        expected_b[units:2 * units] = 1.0
        np.testing.assert_array_equal(layer["b"].numpy(), expected_b)
        in_dim = units
    np.testing.assert_array_equal(params["out"]["b"].numpy(), 0.0)
    again = init_lstm(spec, torch.Generator().manual_seed(3))
    for key, layer in params.items():
        for name, leaf in layer.items():
            assert torch.equal(leaf, again[key][name])


@pytest.mark.parametrize("activation", ["tanh", "relu", "sigmoid"])
def test_forward_lstm_matches_jax(activation):
    spec = factories.lstm_hourglass(3, lookback_window=LOOKBACK, encoding_layers=2, func=activation,
                                    out_func="linear")
    jax_params = jax_init_lstm(jax.random.PRNGKey(1), spec)
    x = _series(7 * LOOKBACK, 3, 2).reshape(7, LOOKBACK, 3)
    expected = np.asarray(jax_forward_lstm(spec, jax_params, jnp.asarray(x))[0])
    out, penalty = forward_lstm(spec, params_from_jax(jax_params), torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), expected, rtol=RTOL, atol=ATOL)
    assert float(penalty) == 0.0
    # two members stacked: each its own
    other = jax_init_lstm(jax.random.PRNGKey(2), spec)
    stacked = stack_member_params([params_from_jax(jax_params), params_from_jax(other)])
    both, _ = forward_lstm_stacked(spec, stacked, torch.from_numpy(np.stack([x, x[::-1].copy()])))
    np.testing.assert_allclose(both[0].numpy(), expected, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(both[1].numpy(), np.asarray(jax_forward_lstm(spec, other, jnp.asarray(x[::-1]))[0]),
                               rtol=RTOL, atol=ATOL)
    round_trip = params_to_numpy(params_from_jax(jax_params))
    assert round_trip.keys() == jax_params.keys() and round_trip["lstm_0"].keys() == {"Wx", "Wh", "b"}


def test_windowed_forward_in_batches():
    """``forward_lstm_windows`` in batches of 7 equals one forward of the
    windows made beforehand."""
    spec = factories.lstm_symmetric(3, lookback_window=LOOKBACK, dims=(4,), funcs=("tanh",))
    params = init_lstm(spec, torch.Generator().manual_seed(0))
    X = _series(40, 3, 5)
    count = windows.num_windows(40, LOOKBACK, 0)
    single = {k: {n: t[None] for n, t in layer.items()} for k, layer in params.items()}
    got = forward_lstm_windows(spec, single, torch.from_numpy(X)[None], torch.arange(count)[None], batch_size=7)
    expected, _ = forward_lstm(spec, params, torch.from_numpy(windows.sliding_windows(X, LOOKBACK)))
    np.testing.assert_allclose(got[0].numpy(), expected.numpy(), rtol=RTOL, atol=ATOL)


# -- models/training.py: the windowed fit --------------------------------------------


def _members(cls, spec, lookahead=0):
    """Three windowed members: a 70-row series with a tail validation
    split, a 52-row one in an explicit window order, and a 61-row one
    trained on its first 30 windows and validated on the next 15."""
    out = []
    for i, rows in enumerate((70, 52, 61)):
        X = _series(rows, 3, 10 + i)
        targets = jax_windows.window_targets(X, LOOKBACK, lookahead)
        nw = len(targets)
        kwargs = {}
        if i == 1:
            kwargs["order"] = np.random.RandomState(4).permutation(nw).astype(np.int32)
        if i == 2:
            kwargs["train_weights"] = (np.arange(nw) < 30).astype(np.float32)
            kwargs["val_weights"] = ((np.arange(nw) >= 30) & (np.arange(nw) < 45)).astype(np.float32)
        out.append(cls(name=f"m{i}", spec=spec, series=X, targets=targets, seed=7 + i, **kwargs))
    return out


def _fit_configs(jax_side):
    stop = (JaxEarlyStopping if jax_side else EarlyStopping)(
        monitor="val_loss", patience=1, min_delta=0.0, restore_best_weights=True)
    es = (stop.monitor, stop.patience, stop.min_delta, stop.restore_best_weights)
    config = JaxFitConfig if jax_side else FitConfig
    return {
        "plain": config(epochs=2, batch_size=16, validation_split=0.25, shuffle=False),
        "early-stopping": config(epochs=2, batch_size=16, validation_split=0.25, shuffle=False, early_stopping=es),
        "shuffled": config(epochs=2, batch_size=16, shuffle=True),
    }


@pytest.mark.parametrize("case", ["plain", "early-stopping", "shuffled"])
def test_windowed_fit_matches_jax(case):
    """Both fleet trainers on the same three windowed members (the JAX one
    through ``jit(vmap(build_raw_windowed_fit_fn))``): loss and val_loss
    histories rtol 1e-5, final params atol 1e-6."""
    jax_spec = jax_factories.lstm_hourglass(3, lookback_window=LOOKBACK, encoding_layers=1)
    spec = factories.lstm_hourglass(3, lookback_window=LOOKBACK, encoding_layers=1)
    jax_results = JaxFleetTrainer().train(_members(JaxWindowedMember, jax_spec), _fit_configs(True)[case])
    results = FleetTrainer("cpu", JaxRandom()).train(_members(WindowedFleetMember, spec), _fit_configs(False)[case])
    for jax_result, result in zip(jax_results, results, strict=True):
        assert result.history.history.keys() == jax_result.history.history.keys()
        for key, values in jax_result.history.history.items():
            np.testing.assert_allclose(result.history.history[key], values, rtol=RTOL, err_msg=key)
        assert result.history.params == jax_result.history.params
        for key, layer in jax_result.params.items():
            for name, value in layer.items():
                np.testing.assert_allclose(result.params[key][name], np.asarray(value), atol=ATOL,
                                           err_msg=f"{key}/{name}")


@pytest.mark.parametrize("lookahead", [0, 1])
def test_windowed_fit_equals_dense_fit(lookahead):
    """The windowed fit on a series equals the dense fit on its windows made
    beforehand in the same order (shuffled by the same permutations, with a
    validation split): losses rtol 1e-5, params atol 1e-6."""
    spec = factories.lstm_symmetric(3, lookback_window=LOOKBACK, dims=(4,), funcs=("tanh",))
    config = FitConfig(epochs=2, batch_size=16, validation_split=0.25, shuffle=True)
    X = _series(70, 3, 3)
    targets = windows.window_targets(X, LOOKBACK, lookahead)
    wins = windows.sliding_windows(X, LOOKBACK, lookahead)
    nw = len(targets)
    nv = -(-nw // 16) * 16
    wtr = np.zeros((1, nv), np.float32)
    wval = np.zeros((1, nv), np.float32)
    wtr[0, : nw - int(nw * 0.25)] = 1.0
    wval[0, nw - int(nw * 0.25): nw] = 1.0
    perms = torch.from_numpy(np.stack([np.random.RandomState(e).permutation(nv) for e in range(2)]))[None]
    init = init_lstm(spec, torch.Generator().manual_seed(1))

    def fresh():
        return stack_member_params([init])

    windowed = WindowedFit(spec, config).run(
        fresh(), torch.from_numpy(X)[None], torch.from_numpy(targets)[None],
        torch.arange(nv).clamp(max=nw - 1)[None], torch.from_numpy(wtr), torch.from_numpy(wval), perms)
    dense_X = np.zeros((1, nv, LOOKBACK, 3), np.float32)
    dense_y = np.zeros((1, nv, 3), np.float32)
    dense_X[0, :nw], dense_y[0, :nw] = wins, targets
    dense_X[0, nw:], dense_y[0, nw:] = wins[-1], targets[-1]
    dense = StackedFit(spec, config).run(
        fresh(), torch.from_numpy(dense_X), torch.from_numpy(dense_y), torch.from_numpy(wtr),
        torch.from_numpy(wval), perms)
    np.testing.assert_allclose(windowed.losses.numpy(), dense.losses.numpy(), rtol=RTOL)
    np.testing.assert_allclose(windowed.val_losses.numpy(), dense.val_losses.numpy(), rtol=RTOL)
    for key, layer in dense.params.items():
        for name, leaf in layer.items():
            np.testing.assert_allclose(windowed.params[key][name].numpy(), leaf.numpy(), atol=ATOL)


def test_all_padding_batches_change_nothing():
    """A member whose train weights cover no batch of an epoch trains not at
    all: its params stay as drawn and its loss is 0; the batches every
    member pads are left out of the loop."""
    spec = factories.lstm_symmetric(2, lookback_window=LOOKBACK, dims=(3,), funcs=("tanh",))
    members = [
        WindowedFleetMember("a", spec, _series(50, 2, 0), windows.window_targets(_series(50, 2, 0), LOOKBACK)),
        WindowedFleetMember("b", spec, _series(50, 2, 1), windows.window_targets(_series(50, 2, 1), LOOKBACK),
                            train_weights=np.zeros(47, np.float32)),
    ]
    result = FleetTrainer("cpu").train(members, FitConfig(epochs=2, batch_size=16, shuffle=False))
    drawn = FleetTrainer("cpu").random.init_params(spec, 42)
    for key, layer in drawn.items():
        for name, leaf in layer.items():
            np.testing.assert_array_equal(result[1].params[key][name], leaf.numpy())
    assert result[1].history.history["loss"] == [0.0, 0.0]
    assert np.all(np.isfinite(result[0].history.history["loss"]))


# -- planner --------------------------------------------------------------------------


@pytest.mark.parametrize("ratio", [1.25, 1.5, 2.0])
def test_ladder_matches_jax(ratio, monkeypatch):
    for n in (1, 2, 7, 64, 181, 1100, 2000, 2467, 52_560):
        for multiple in (1, 16):
            assert packing.round_up_ladder(n, ratio, multiple) == jax_ladder.round_up_ladder(n, ratio, multiple)
    monkeypatch.setenv("GORDO_TPU_SERIES_PAD_RATIO", str(ratio))
    assert packing.series_pad_ratio() == jax_ladder.series_pad_ratio() == ratio
    monkeypatch.setenv("GORDO_TPU_SERIES_PAD_RATIO", "0.5")
    assert packing.series_pad_ratio() == jax_ladder.series_pad_ratio() == 1.25


def test_windowed_buckets_are_keyed_by_offset():
    """An autoencoder and a forecaster of one spec train apart (their
    window counts differ); the pad target is the series ladder's."""
    spec = factories.lstm_symmetric(3, lookback_window=LOOKBACK, dims=(4,), funcs=("tanh",))
    X = _series(181, 3, 0)
    members = [
        WindowedFleetMember("ae", spec, X, windows.window_targets(X, LOOKBACK, 0)),
        WindowedFleetMember("fc", spec, X, windows.window_targets(X, LOOKBACK, 1)),
        WindowedFleetMember("ae2", spec, X[:175], windows.window_targets(X[:175], LOOKBACK, 0)),
    ]
    buckets = packing.naive_buckets(members, 32)
    assert [(b.n_padded, b.offset, b.windowed, [m.name for m in b.members]) for b in buckets] == [
        (jax_ladder.round_up_ladder(181, 1.25), 3, True, ["ae", "ae2"]),
        (jax_ladder.round_up_ladder(181, 1.25), 4, True, ["fc"]),
    ]
    with pytest.raises(ValueError, match="too short"):
        WindowedFleetMember("x", spec, X[:3], windows.window_targets(X[:3], LOOKBACK, 0))


# -- estimators, definitions, the detector, the store ----------------------------------


@pytest.mark.parametrize("cls,offset", [(TorchLSTMAutoEncoder, LOOKBACK - 1), (TorchLSTMForecast, LOOKBACK)])
def test_lstm_estimator(cls, offset, tmp_path):
    """Fit and predict on the CPU: ``len(X) - offset`` rows, the windows
    forwarded in batches (300 windows, batch 256) as one forward would;
    ``forecast_steps``; a lookback not under the rows raises; a pickled
    estimator predicts alike once placed."""
    X = _series(60, 3, 8)
    estimator = cls(device="cpu", kind="lstm_symmetric", lookback_window=LOOKBACK, dims=[4], funcs=["tanh"],
                    epochs=1, batch_size=16)
    assert list(estimator.kwargs) == ["dims", "funcs", "epochs", "lookback_window", "batch_size"]
    estimator.fit(X, X)
    assert estimator.history.history["loss"] and estimator.get_metadata()["forecast_steps"] == cls.lookahead
    long = _series(300 + offset, 3, 9)
    out = estimator.predict(long)
    assert out.shape == (300, 3)
    expected, _ = forward_lstm(estimator.spec_, estimator.params_,
                               torch.from_numpy(windows.sliding_windows(long, LOOKBACK, cls.lookahead)))
    np.testing.assert_allclose(out, expected.numpy(), rtol=RTOL, atol=ATOL)
    with pytest.raises(ValueError, match="lookback_window must be < size of X"):
        estimator.predict(long[:LOOKBACK])
    serializer.dump(estimator, str(tmp_path / "m"))
    loaded = serializer.load(str(tmp_path / "m"), "cpu")
    np.testing.assert_array_equal(loaded.predict(long), out)
    assert loaded.lookback_window == LOOKBACK and loaded.offset == offset


def test_lstm_definitions():
    path = "gordo.machine.model.models.KerasLSTMForecast"
    model = serializer.from_definition({path: {"kind": "lstm_hourglass", "lookback_window": 10}}, device="cpu")
    assert type(model) is TorchLSTMForecast and model.lookback_window == 10
    for path in ("gordo_tpu.models.JaxLSTMAutoEncoder", "gordo_tpu.models.estimators.JaxLSTMAutoEncoder",
                 "gordo.machine.model.models.KerasLSTMAutoEncoder"):
        assert type(serializer.from_definition({path: {"kind": "lstm_model"}}, device="cpu")) is TorchLSTMAutoEncoder
    with pytest.raises(NotImplementedError, match="feedforward_model"):
        serializer.from_definition({"gordo_tpu.models.JaxLSTMForecast": {"kind": "feedforward_model"}}, device="cpu")


def _lstm_detector(estimator, lookahead):
    spec = factories.lstm_symmetric(3, lookback_window=LOOKBACK, dims=(4,), funcs=("tanh",))
    params = params_to_numpy(init_lstm(spec, torch.Generator().manual_seed(lookahead)))
    return DiffBasedAnomalyDetector.from_state({
        "spec": spec.to_dict(), **estimator, "params": params,
        "pipeline": [{"scale_": [0.5, 2.0, 1.0], "min_": [0.1, -0.2, 0.0]}],
        "scaler": {"scale_": [1.0, 1.0, 1.0], "min_": [0.0, 0.0, 0.0]},
        "feature_thresholds": [1.0, 1.0, 1.0], "aggregate_threshold": 1.0,
    }, device="cpu")


def test_detector_from_state_and_score():
    ae = _lstm_detector({"estimator": "JaxLSTMAutoEncoder"}, 0)
    fc = _lstm_detector({"lookahead": 1}, 1)
    assert type(ae.base_estimator.estimator) is TorchLSTMAutoEncoder
    assert type(fc.base_estimator.estimator) is TorchLSTMForecast
    with pytest.raises(ValueError, match="estimator or lookahead"):
        _lstm_detector({}, 0)
    X = _series(30, 3, 1)
    out = fc.predict(X)
    assert out.shape == (30 - LOOKBACK, 3)
    from gordo_tpu_torch.models.metrics import explained_variance_score

    expected = explained_variance_score(np.asarray(X, np.float64)[LOOKBACK:], out)
    assert fc.score(X, X) == pytest.approx(float(np.mean(expected)), rel=1e-12)


def test_store_scores_an_lstm_bucket(tmp_path):
    """An autoencoder and a forecaster of one spec share a bucket; its fleet
    scores equal each member's own predict (ragged series), the mse is
    against the raw rows' tail, and a series without a window is that
    machine's error alone (``tests/server/test_fleet_serving_lstm.py``)."""
    for name, detector in (("ae", _lstm_detector({"lookahead": 0}, 0)), ("fc", _lstm_detector({"lookahead": 1}, 1))):
        serializer.dump(detector, str(tmp_path / name))
    fleet = RevisionFleet(str(tmp_path), torch.device("cpu"))
    assert sorted(fleet.warm()) == ["ae", "fc"]
    specs = fleet.loaded_specs()
    assert specs["ae"] == specs["fc"] and fleet.spec_bucket(specs["ae"])[0] == ["ae", "fc"]
    inputs = {"ae": _series(17, 3, 2), "fc": _series(12, 3, 3)}
    scores, errors = fleet.fleet_scores(inputs)
    assert errors == {}
    for name, X in inputs.items():
        expected = fleet.model(name).predict(X)
        recon, mse = scores[name]
        np.testing.assert_allclose(recon, expected, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(fleet.predict(name, X), expected, rtol=RTOL, atol=ATOL)
        tail = X[len(X) - len(expected):]
        np.testing.assert_allclose(mse, ((recon - tail) ** 2).mean(-1), rtol=RTOL, atol=ATOL)
    assert len(scores["ae"][0]) == 17 - (LOOKBACK - 1) and len(scores["fc"][0]) == 12 - LOOKBACK
    scores, errors = fleet.fleet_scores({"ae": _series(LOOKBACK - 1, 3, 4), "fc": _series(9, 3, 5)})
    assert list(errors) == ["ae"] and isinstance(errors["ae"], ValueError) and list(scores) == ["fc"]
    with pytest.raises(ValueError, match="lookback_window"):
        fleet.predict("ae", _series(LOOKBACK, 3, 6))


def test_lstm_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default is taken")
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchLSTMAutoEncoder(kind="lstm_model")
