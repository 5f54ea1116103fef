"""The port's segmented (stateful-scan) LSTM fit against the JAX package's,
on the CPU.

- ``models/nn.py::forward_lstm_sequence``: the head at every step of a
  stacked, time-major sequence, JAX's params injected, rtol 1e-5 / atol
  1e-6 (f32, sums in another order);
- ``models/training.py::SegmentedFit`` against JAX's
  ``build_raw_segmented_fit_fn`` under ``jit(vmap)`` from the same initial
  params: losses, val losses and params after two epochs, rtol 1e-5 / atol
  1e-6; at G = B (one window a segment) equal to the port's ``WindowedFit``,
  as JAX's own test holds its two fits (``tests/parallel/test_fleet_segmented.py``);
- the fleet trainer against JAX's on a one-device mesh with
  ``GORDO_TPU_LSTM_SEGMENTED`` set, JAX's randomness injected: the
  segmented buckets and every fallback to the windowed fit (a shuffle, a
  member's own order or weights, segments that do not divide the batch),
  and bucket padding that changes no member's fit;
- the LSTM estimators against JAX's: the segmented path with and without a
  validation split, ``History.params``, the fallback for host callbacks
  and for too few windows, and ``fit_single_segmented``'s refusals.
"""

import logging

import jax
import numpy as np
import pytest
import torch

from gordo_tpu.models import training as jax_training
from gordo_tpu.models.estimators import JaxLSTMAutoEncoder, JaxLSTMForecast
from gordo_tpu.models.factories import lstm_autoencoder as jax_factories
from gordo_tpu.models.nn import forward_lstm_sequence as jax_forward_sequence, init_lstm as jax_init_lstm
from gordo_tpu.models.training import FitConfig as JaxFitConfig
from gordo_tpu.ops import windows as jax_windows
from gordo_tpu.parallel.fleet import FleetTrainer as JaxFleetTrainer, WindowedFleetMember as JaxWindowedMember
from gordo_tpu.parallel.mesh import make_mesh as jax_make_mesh
from gordo_tpu_torch.models import factories
from gordo_tpu_torch.models.callbacks import ReduceLROnPlateau
from gordo_tpu_torch.models.estimators import TorchLSTMAutoEncoder, TorchLSTMForecast
from gordo_tpu_torch.models.nn import forward_lstm_sequence, forward_lstm_stacked
from gordo_tpu_torch.models.training import (
    FitConfig,
    SegmentedFit,
    WindowedFit,
    fit_single_segmented,
    segmented_config,
)
from gordo_tpu_torch.parallel.fleet import FleetTrainer, WindowedFleetMember, stack_member_params
from tests.test_torch_lstm import JaxRandom

RTOL, ATOL = 1e-5, 1e-6
LOOKBACK = 4
TAGS = 3


def _series(rows, seed, features=TAGS):
    return np.random.RandomState(seed).rand(rows, features).astype(np.float32)


def _jax_params(spec, seed):
    return jax.tree_util.tree_map(np.array, jax_init_lstm(jax.random.PRNGKey(seed), spec))


def _assert_params(got, expected, atol=ATOL):
    for key, layer in expected.items():
        for name, value in layer.items():
            np.testing.assert_allclose(np.asarray(got[key][name]), np.asarray(value), rtol=RTOL, atol=atol,
                                       err_msg=f"{key}/{name}")


def _specs(kind, **kwargs):
    return (getattr(jax_factories, kind)(TAGS, lookback_window=LOOKBACK, **kwargs),
            getattr(factories, kind)(TAGS, lookback_window=LOOKBACK, **kwargs))


# -- models/nn.py -------------------------------------------------------------------


@pytest.mark.parametrize("kind,kwargs", [
    ("lstm_hourglass", {"encoding_layers": 2}),
    ("lstm_symmetric", {"dims": (5,), "funcs": ("relu",)}),
    ("lstm_model", {"encoding_dim": (4, 3), "encoding_func": ("tanh", "sigmoid"), "decoding_dim": (3,),
                    "decoding_func": ("tanh",), "out_func": "tanh"}),
])
def test_forward_sequence_matches_jax(kind, kwargs):
    """Each member's sequence through both forwards: ``[M, T, G, F_out]``
    equal to JAX's ``[T, G, F_out]`` a member; the last step equals the
    many-to-one forward of the span's last window."""
    jax_spec, spec = _specs(kind, **kwargs)
    members = [_jax_params(jax_spec, seed) for seed in (0, 1)]
    x = np.random.RandomState(2).randn(2, 9, 5, TAGS).astype(np.float32)
    got = forward_lstm_sequence(spec, stack_member_params(members), torch.from_numpy(x))
    assert got.shape == (2, 9, 5, spec.n_features_out) and got.dtype == torch.float32
    for m, params in enumerate(members):
        expected = np.asarray(jax_forward_sequence(jax_spec, params, x[m]))
        np.testing.assert_allclose(got[m].numpy(), expected, rtol=RTOL, atol=ATOL)
    windows = torch.from_numpy(x[:, -LOOKBACK:].transpose(0, 2, 1, 3).copy())  # [M, G, lookback, F]
    tail = forward_lstm_sequence(spec, stack_member_params(members), torch.from_numpy(x[:, -LOOKBACK:].copy()))
    many_to_one = forward_lstm_stacked(spec, stack_member_params(members), windows)[0]
    np.testing.assert_allclose(tail[:, -1].numpy(), many_to_one.numpy(), rtol=RTOL, atol=ATOL)


# -- models/training.py: SegmentedFit -------------------------------------------------


def _weights(nw, nv, validation_split):
    n_val = int(nw * validation_split)
    wtr, wval = np.zeros(nv, np.float32), np.zeros(nv, np.float32)
    wtr[: nw - n_val] = 1.0
    wval[nw - n_val: nw] = 1.0
    return wtr, wval


FIT_CASES = {
    "g4-val": dict(segments=4, batch=16, lookahead=0, split=0.25, es=None),
    "g2-forecast": dict(segments=2, batch=8, lookahead=1, split=0.0, es=None),
    "g4-early-stopping": dict(segments=4, batch=8, lookahead=0, split=0.3, es=("val_loss", 1, 0.0, True)),
}


@pytest.mark.parametrize("case", list(FIT_CASES))
def test_segmented_fit_matches_jax(case):
    """Three members of 70, 52 and 61 rows padded to 72 rows, through
    ``jit(vmap(build_raw_segmented_fit_fn))`` and the port's fit from the
    same params: two epochs' losses and val losses rtol 1e-5, params atol
    1e-6."""
    c = FIT_CASES[case]
    jax_spec, spec = _specs("lstm_hourglass", encoding_layers=1)
    B, n_padded = c["batch"], 72
    offset = jax_windows.model_offset(LOOKBACK, c["lookahead"])
    nw_padded = n_padded - offset
    nv = -(-nw_padded // B) * B
    series = np.zeros((3, n_padded, TAGS), np.float32)
    targets = np.zeros((3, nw_padded, TAGS), np.float32)
    wtr, wval = np.zeros((3, nv), np.float32), np.zeros((3, nv), np.float32)
    for i, rows in enumerate((70, 52, 61)):
        X = _series(rows, 10 + i)
        t = jax_windows.window_targets(X, LOOKBACK, c["lookahead"])
        series[i, :rows], targets[i, : len(t)] = X, t
        wtr[i], wval[i] = _weights(len(t), nv, c["split"])
    init = [_jax_params(jax_spec, seed) for seed in (3, 4, 5)]
    jax_config = JaxFitConfig(epochs=2, batch_size=B, validation_split=c["split"], shuffle=False,
                              early_stopping=c["es"])
    tx = jax_spec.optimizer.to_optax()
    stacked = jax.tree_util.tree_map(lambda *leaves: np.stack(leaves), *init)
    fit = jax.jit(jax.vmap(jax_training.build_raw_segmented_fit_fn(jax_spec, jax_config, c["segments"])))
    rngs = jax.random.split(jax.random.PRNGKey(0), 3)
    jax_params, _, losses, val_losses, ran = fit(stacked, jax.vmap(tx.init)(stacked), series, targets, wtr, wval,
                                                 rngs)
    config = FitConfig(epochs=2, batch_size=B, validation_split=c["split"], shuffle=False, early_stopping=c["es"])
    out = SegmentedFit(spec, config, c["segments"]).run(
        stack_member_params(init), *(torch.from_numpy(a) for a in (series, targets, wtr, wval)))
    np.testing.assert_allclose(out.losses.numpy(), np.asarray(losses), rtol=RTOL)
    np.testing.assert_allclose(out.val_losses.numpy(), np.asarray(val_losses), rtol=RTOL)
    np.testing.assert_array_equal(out.epochs_ran.numpy(), np.asarray(ran))
    _assert_params(out.params, jax_params)


def test_one_window_segments_equal_the_windowed_fit():
    """G = B: every window starts cold, in the windowed fit's order, so the
    two fits agree (rtol 1e-5, atol 1e-6), validation included."""
    jax_spec, spec = _specs("lstm_symmetric", dims=(4,), funcs=("tanh",))
    X = _series(70, 3)
    targets = jax_windows.window_targets(X, LOOKBACK, 0)
    nw, B = len(targets), 16
    nv = -(-nw // B) * B
    wtr, wval = _weights(nw, nv, 0.25)
    config = FitConfig(epochs=3, batch_size=B, validation_split=0.25, shuffle=False)
    init = _jax_params(jax_spec, 1)
    data = [torch.from_numpy(a)[None] for a in (X, targets)]
    weights = [torch.from_numpy(a)[None] for a in (wtr, wval)]
    segmented = SegmentedFit(spec, config, B).run(stack_member_params([init]), *data, *weights)
    order = torch.arange(nv).clamp(max=nw - 1)[None]
    windowed = WindowedFit(spec, config).run(stack_member_params([init]), *data, order, *weights, None)
    np.testing.assert_allclose(segmented.losses.numpy(), windowed.losses.numpy(), rtol=RTOL)
    np.testing.assert_allclose(segmented.val_losses.numpy(), windowed.val_losses.numpy(), rtol=RTOL)
    _assert_params({k: {n: t[0] for n, t in layer.items()} for k, layer in segmented.params.items()},
                   {k: {n: t[0].numpy() for n, t in layer.items()} for k, layer in windowed.params.items()})


@pytest.mark.parametrize("shuffle,batch,segments,message", [
    (True, 16, 4, "segmented LSTM training requires shuffle=False"),
    (False, 16, 3, "batch_size 16 not divisible by segments 3"),
])
def test_segmented_fit_refusals_match_jax(shuffle, batch, segments, message):
    jax_spec, spec = _specs("lstm_symmetric", dims=(4,), funcs=("tanh",))
    with pytest.raises(ValueError, match=message):
        jax_training.build_raw_segmented_fit_fn(jax_spec, JaxFitConfig(batch_size=batch, shuffle=shuffle), segments)
    with pytest.raises(ValueError, match=message):
        SegmentedFit(spec, FitConfig(batch_size=batch, shuffle=shuffle), segments)


@pytest.mark.parametrize("raw,expected", [(None, None), ("0", None), ("4", 4), ("-2", None), ("x", None)])
def test_segmented_config_reads_the_knob_as_jax(raw, expected, monkeypatch):
    if raw is None:
        monkeypatch.delenv("GORDO_TPU_LSTM_SEGMENTED", raising=False)
    else:
        monkeypatch.setenv("GORDO_TPU_LSTM_SEGMENTED", raw)
    assert segmented_config() == jax_training.segmented_config() == expected


# -- parallel/fleet.py ---------------------------------------------------------------


def _one_device():
    return jax_make_mesh(jax.devices()[:1])


def _fleet_members(cls, spec, case, lookahead=0):
    """Three members of 70, 52 and 61 rows (one bucket); ``case`` gives one
    of them an explicit order or train weights."""
    out = []
    for i, rows in enumerate((70, 52, 61)):
        X = _series(rows, 20 + i)
        targets = jax_windows.window_targets(X, LOOKBACK, lookahead)
        kwargs = {}
        if i == 1 and case == "order":
            kwargs["order"] = np.arange(len(targets), dtype=np.int32)
        if i == 2 and case == "weights":
            kwargs["train_weights"] = (np.arange(len(targets)) < 30).astype(np.float32)
        out.append(cls(name=f"m{i}", spec=spec, series=X, targets=targets, seed=7 + i, **kwargs))
    return out


FLEET_CASES = {
    "segmented": (dict(batch_size=16, validation_split=0.25, shuffle=False), 4),
    "forecast": (dict(batch_size=8, shuffle=False), 2),
    "shuffled": (dict(batch_size=16, shuffle=True), None),
    "order": (dict(batch_size=16, shuffle=False), 4),
    "weights": (dict(batch_size=16, shuffle=False), 4),
    "indivisible": (dict(batch_size=10, shuffle=False), None),
}


@pytest.mark.parametrize("case", list(FLEET_CASES))
def test_fleet_segmented_matches_jax(case, monkeypatch, caplog):
    """Both fleet trainers with ``GORDO_TPU_LSTM_SEGMENTED=4`` (2 for the
    forecast case) on the same bucket: histories rtol 1e-5, params atol
    1e-6, the same ``History.params``; the port logs JAX's line and
    records the segments where JAX runs the segmented program, and falls
    back to the windowed fit where JAX does."""
    kwargs, segments = FLEET_CASES[case]
    monkeypatch.setenv("GORDO_TPU_LSTM_SEGMENTED", "2" if case == "forecast" else "4")
    lookahead = 1 if case == "forecast" else 0
    jax_spec, spec = _specs("lstm_hourglass", encoding_layers=1)
    config = dict(kwargs, epochs=2)
    jax_results = JaxFleetTrainer(mesh=_one_device()).train(
        _fleet_members(JaxWindowedMember, jax_spec, case, lookahead), JaxFitConfig(**config))
    trainer = FleetTrainer("cpu", JaxRandom())
    with caplog.at_level(logging.INFO, logger="gordo_tpu_torch.parallel.fleet"):
        results = trainer.train(_fleet_members(WindowedFleetMember, spec, case, lookahead), FitConfig(**config))
    # a bucket holding the member with its own order or weights keeps the windowed fit
    own = {"order": "m1", "weights": "m2"}.get(case)
    expected = [None if segments is None or own in fit["names"] else segments for fit in trainer.fits]
    assert [fit["segmented"] for fit in trainer.fits] == expected and len(expected) == 2
    logged = [r.getMessage() for r in caplog.records if r.getMessage().startswith("Segmented LSTM training")]
    line = f"Segmented LSTM training: {segments} segments/update (L={kwargs['batch_size'] // (segments or 1)})"
    assert logged == [line] * sum(g is not None for g in expected)
    for jax_result, result in zip(jax_results, results, strict=True):
        assert result.history.params == jax_result.history.params
        assert result.history.history.keys() == jax_result.history.history.keys()
        for key, values in jax_result.history.history.items():
            np.testing.assert_allclose(result.history.history[key], values, rtol=RTOL, err_msg=key)
        _assert_params(result.params, jax_result.params)


def test_fleet_segmented_ignores_bucket_padding(monkeypatch):
    """A 61-row member trains the same alone and padded into a 70-row
    bucket beside a 70-row one: its padding rows and windows carry no
    weight (``test_segmented_ignores_bucket_padding`` in JAX)."""
    monkeypatch.setenv("GORDO_TPU_LSTM_SEGMENTED", "4")
    spec = factories.lstm_symmetric(TAGS, lookback_window=LOOKBACK, dims=(4,), funcs=("tanh",))
    config = FitConfig(epochs=2, batch_size=8, shuffle=False)

    def member(rows, seed):
        X = _series(rows, seed)
        return WindowedFleetMember(f"r{rows}", spec, X, jax_windows.window_targets(X, LOOKBACK, 0), seed=1)

    alone = FleetTrainer("cpu").train([member(61, 0)], config)
    trainer = FleetTrainer("cpu")
    mixed = trainer.train([member(61, 0), member(70, 1)], config)
    assert [(fit["members"], fit["segmented"]) for fit in trainer.fits] == [(2, 4)]
    np.testing.assert_allclose(mixed[0].history.history["loss"], alone[0].history.history["loss"], rtol=RTOL)
    _assert_params(mixed[0].params, alone[0].params)


# -- models/estimators.py ------------------------------------------------------------


ESTIMATOR_CASES = {
    "autoencoder-val": (JaxLSTMAutoEncoder, TorchLSTMAutoEncoder, dict(validation_split=0.25), 60),
    "forecast": (JaxLSTMForecast, TorchLSTMForecast, {}, 60),
    "callbacks": (JaxLSTMAutoEncoder, TorchLSTMAutoEncoder, dict(callbacks="plateau"), 60),
    "few-windows": (JaxLSTMAutoEncoder, TorchLSTMAutoEncoder, {}, 10),
}


@pytest.mark.parametrize("case", list(ESTIMATOR_CASES))
def test_estimator_segmented_matches_jax(case, monkeypatch):
    """Both LSTM estimators with ``GORDO_TPU_LSTM_SEGMENTED=4``: the
    segmented path where JAX takes it (``History.params`` with
    ``segmented``), the dense one for host callbacks or fewer windows than
    a batch; histories rtol 1e-5, params atol 1e-6."""
    jax_cls, cls, fit_kwargs, rows = ESTIMATOR_CASES[case]
    monkeypatch.setenv("GORDO_TPU_LSTM_SEGMENTED", "4")
    X = _series(rows, 30)
    kwargs = dict(kind="lstm_symmetric", lookback_window=LOOKBACK, dims=[4], funcs=["tanh"], epochs=2,
                  batch_size=8, **fit_kwargs)
    if case == "callbacks":
        from gordo_tpu.models.callbacks import ReduceLROnPlateau as JaxReduceLROnPlateau

        jax_est = jax_cls(**{**kwargs, "callbacks": [JaxReduceLROnPlateau(monitor="loss", patience=1)]})
        est = cls(device="cpu", **{**kwargs, "callbacks": [ReduceLROnPlateau(monitor="loss", patience=1)]})
    else:
        jax_est, est = jax_cls(**kwargs), cls(device="cpu", **kwargs)
    jax_est.fit(X, X)
    est.fit(X, X, random=JaxRandom())
    assert est.history.params == jax_est._history.params
    assert ("segmented" in est.history.params) == (case in ("autoencoder-val", "forecast"))
    for key, values in jax_est._history.history.items():
        np.testing.assert_allclose(est.history.history[key], values, rtol=RTOL, err_msg=key)
    _assert_params({k: {n: t.numpy() for n, t in layer.items()} for k, layer in est.params_.items()},
                   jax_est.params_)


def test_fit_single_segmented_matches_jax():
    """The one-model twin directly: the history, its params and the
    final params as JAX's ``fit_single_segmented``; its refusals."""
    jax_spec, spec = _specs("lstm_symmetric", dims=(4,), funcs=("tanh",))
    X = _series(50, 31)
    targets = jax_windows.window_targets(X, LOOKBACK, 0)
    config = dict(epochs=2, batch_size=8, validation_split=0.2, shuffle=False)
    jax_params, jax_history = jax_training.fit_single_segmented(jax_spec, X, targets, JaxFitConfig(**config),
                                                                seed=5, segments=2)
    params, history = fit_single_segmented(spec, X, targets, FitConfig(**config), 5, 2, "cpu", JaxRandom())
    assert history.params == jax_history.params and history.epoch == jax_history.epoch
    for key, values in jax_history.history.items():
        np.testing.assert_allclose(history.history[key], values, rtol=RTOL, err_msg=key)
    _assert_params({k: {n: t.numpy() for n, t in layer.items()} for k, layer in params.items()}, jax_params)
    for bad, message in [(dict(config, shuffle=True), "requires shuffle=False"),
                         (dict(config, batch_size=64), "at least one full batch"),
                         (dict(config, batch_size=9), "needs batch_size divisible")]:
        with pytest.raises(ValueError, match=message):
            jax_training.fit_single_segmented(jax_spec, X, targets, JaxFitConfig(**bad), segments=2)
        with pytest.raises(ValueError, match=message):
            fit_single_segmented(spec, X, targets, FitConfig(**bad), segments=2)


def test_fleet_segmented_program_span(monkeypatch):
    """The segmented bucket is a ``fleet_segmented_fit`` ``device_program``
    span with the windowed span's attributes."""
    from gordo_tpu_torch import telemetry

    monkeypatch.setenv("GORDO_TPU_LSTM_SEGMENTED", "4")
    spec = factories.lstm_symmetric(TAGS, lookback_window=LOOKBACK, dims=(4,), funcs=("tanh",))
    X = _series(40, 1)
    member = WindowedFleetMember("a", spec, X, jax_windows.window_targets(X, LOOKBACK, 0))
    recorder = telemetry.SpanRecorder()
    with telemetry.activate(recorder):
        FleetTrainer("cpu").train([member], FitConfig(epochs=1, batch_size=8, shuffle=False))
    spans = recorder.finished("device_program")
    assert [s["attributes"]["program"] for s in spans] == ["fleet_segmented_fit"]
    assert {"members", "shape", "spec", "bytes", "flops_per_sample", "stacked_samples"} <= set(spans[0]["attributes"])
