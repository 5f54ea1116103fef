"""The port's LSTM family through ``build-fleet`` and the server, against
the JAX package's, end to end on the CPU.

One YAML project config holds an LSTM autoencoder (``JaxLSTMAutoEncoder``,
lstm_hourglass, lookback 5), an LSTM forecaster under the reference's
class path (``KerasLSTMForecast``, lstm_symmetric, lookback 4), a second
autoencoder under ``KerasLSTMAutoEncoder`` sharing the first's spec,
whose detector shuffles (its window order becomes the member's
``order``), and a feedforward machine, each a ``DiffBasedAnomalyDetector`` over MinMax,
~180 ``RandomDataProvider`` rows of 3 tags, 2 epochs, TimeSeriesSplit(3).
The JAX package builds it with ``fleet_build``; the port runs
``python -m gordo_tpu_torch build-fleet`` in process on the same shard,
drawing JAX's randomness (``JaxRandom``: the JAX trainer's init keys; the
LSTMs never shuffle). Compared: thresholds, per fold too, every CV score,
``model_offset`` (4 for both LSTM kinds here, 0 for the feedforward
machine), final params, the metadata's keys and ``forecast_steps``. A
KFCV detector over an LSTM fails in both builders (scattered folds have
no window mapping).

Then the JAX-built detectors cross into the port through
``DiffBasedAnomalyDetector.from_state`` and both apps answer the same
requests: ``/anomaly/prediction`` (rows shortened by the offset; too few
rows is 400 on both), ``/prediction``, ``/metadata``, the fleet route over
the mixed fleet (lean and ``?full``) and one stream.

Tolerances, measured on the CPU (torch 2.13, jax 0.9): params atol 1e-5
(measured within 6e-8), thresholds rtol 1e-5 (measured 1.3e-7), CV
scores rtol/atol 1e-5 (measured |d| / (1 + |jax|) 1.5e-6: the JAX
package's metrics run in float32 on a float32 scaler's output, the
port's in float64), served cells rtol 1e-5, atol 1e-6: the
recurrence sums in another order in XLA and in torch, a few ulps that the
scaled errors carry.
"""

import functools
import io
import json
import os

import jax
import numpy as np
import pytest
from werkzeug.test import Client

from gordo_tpu.cli.cli import _load_fleet_machines as jax_load_fleet_machines
from gordo_tpu.cli.workflow_generator import _machines_yaml as jax_machines_yaml
from gordo_tpu.models.nn import init_feedforward as jax_init_feedforward, init_lstm as jax_init_lstm
from gordo_tpu.parallel import fleet_build as jax_fleet_build
from gordo_tpu.parallel.fleet_build import FleetBuilder as JaxFleetBuilder
from gordo_tpu.server import build_app as jax_build_app
from gordo_tpu.workflow.config_elements.normalized_config import NormalizedConfig as JaxNormalizedConfig
from gordo_tpu.workflow.workflow_generator.workflow_generator import get_dict_from_yaml as jax_get_dict
from gordo_tpu_torch import serializer
from gordo_tpu_torch.cli.cli import main as port_main
from gordo_tpu_torch.machine import Machine
from gordo_tpu_torch.models.anomaly.diff import DiffBasedAnomalyDetector
from gordo_tpu_torch.models.estimators import TorchLSTMAutoEncoder, TorchLSTMForecast
from gordo_tpu_torch.models.spec import LSTMSpec
from gordo_tpu_torch.parallel import fleet as port_fleet
from gordo_tpu_torch.parallel.fleet_build import FleetBuilder
from gordo_tpu_torch.server import build_app
from gordo_tpu_torch.workflow.workflow_generator import normalize

PROJECT = "lstm-fleet"
REVISION = "1700000000000"
PARAM_ATOL, RTOL, ATOL, SERVE_ATOL = 1e-5, 1e-5, 1e-5, 1e-6

_DETECTOR = """
    model:
      gordo_tpu.models.anomaly.diff.DiffBasedAnomalyDetector:{shuffle}
        base_estimator:
          sklearn.pipeline.Pipeline:
            steps:
              - sklearn.preprocessing.MinMaxScaler
              - {path}:
{kwargs}"""
_MACHINES = [
    ("lstm-ae", "t1, t2, t3", "gordo_tpu.models.JaxLSTMAutoEncoder",
     {"kind": "lstm_hourglass", "lookback_window": 5, "encoding_layers": 1}),
    ("lstm-fc", "t4, t5, t6", "gordo.machine.model.models.KerasLSTMForecast",
     {"kind": "lstm_symmetric", "lookback_window": 4, "dims": "[3]", "funcs": "[tanh]"}),
    ("lstm-ae-2", "t7, t8, t9", "gordo.machine.model.models.KerasLSTMAutoEncoder",
     {"kind": "lstm_hourglass", "lookback_window": 5, "encoding_layers": 1}),
    ("ff", "t1, t2, t3", "gordo_tpu.models.JaxAutoEncoder", {"kind": "feedforward_hourglass", "encoding_layers": 1}),
]
CONFIG = "machines:\n" + "".join(
    f"  - name: {name}\n    dataset:\n      tag_list: [{tags}]\n"
    + _DETECTOR.format(path=path, shuffle="\n        shuffle: true" if name == "lstm-ae-2" else "",
                       kwargs="".join(f"                  {k}: {v}\n" for k, v in {**kw, "epochs": 2}.items()))
    for name, tags, path, kw in _MACHINES
) + """globals:
  dataset:
    train_start_date: 2020-01-01T00:00:00+00:00
    train_end_date: 2020-01-02T06:00:00+00:00
    data_provider:
      type: RandomDataProvider
"""
NAMES = [m[0] for m in _MACHINES]
TAGS = {name: [t.strip() for t in tags.split(",")] for name, tags, *_ in _MACHINES}
OFFSETS = {"lstm-ae": 4, "lstm-fc": 4, "lstm-ae-2": 4, "ff": 0}


@functools.partial(jax.jit, static_argnums=1)
def _jax_init_params(seed, spec):
    _, init = jax.random.split(jax.random.PRNGKey(seed))
    return (jax_init_lstm if isinstance(spec, LSTMSpec) else jax_init_feedforward)(init, spec)


@functools.partial(jax.jit, static_argnums=(1, 2))
def _jax_permutations(seed, epochs, n_total):
    fit, _ = jax.random.split(jax.random.PRNGKey(seed))
    return jax.vmap(lambda key: jax.random.permutation(key, n_total))(jax.random.split(fit, epochs))


class JaxRandom:
    """The JAX fleet trainer's randomness (init from the second half of
    ``split(PRNGKey(seed))``, LSTMs included), for the port's trainer."""

    def init_params(self, spec, seed):
        return jax.tree_util.tree_map(np.array, _jax_init_params(seed, spec))

    def permutations(self, seed, epochs, n_total):
        return np.array(_jax_permutations(seed, epochs, n_total))


@pytest.fixture(scope="module")
def builds(tmp_path_factory):
    """Both builds of CONFIG: ``{name: (jax model, jax metadata.json, port
    model, port metadata.json)}``, the JAX directory and the port's."""
    root = tmp_path_factory.mktemp("lstm-fleet")
    jax_dir, port_dir = root / "jax" / REVISION, root / "port" / REVISION
    jax_shard = jax_machines_yaml(JaxNormalizedConfig(jax_get_dict(io.StringIO(CONFIG)), PROJECT).machines)
    jax_results = jax_fleet_build(jax_load_fleet_machines(jax_shard), output_dir=str(jax_dir))
    shard = root / "shard.json"
    shard.write_text(normalize(io.StringIO(CONFIG), PROJECT))
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(port_fleet, "TorchRandom", JaxRandom)
        assert port_main(["build-fleet", str(shard), str(port_dir), "--device", "cpu"]) == 0
    out = {}
    for jax_model, machine in jax_results:
        with open(jax_dir / machine.name / "metadata.json") as f:
            jax_meta = json.load(f)
        model = serializer.load(str(port_dir / machine.name), "cpu")
        out[machine.name] = (jax_model, jax_meta, model, serializer.load_metadata(str(port_dir / machine.name)))
    assert sorted(out) == sorted(NAMES)
    return out, jax_dir, port_dir


@pytest.mark.parametrize("name", NAMES)
def test_lstm_build_matches_jax(builds, name):
    """Thresholds (and per fold) rtol 1e-5, every CV score rtol/atol 1e-5,
    the splits equal, ``model_offset`` the window offset, final params atol
    1e-5, ``model_meta``'s keys (``forecast_steps`` for an LSTM)."""
    jax_model, jax_meta, model, meta = builds[0][name]
    np.testing.assert_allclose(model.feature_thresholds_, jax_model.feature_thresholds_.to_numpy(float), rtol=RTOL)
    np.testing.assert_allclose(model.aggregate_threshold_, jax_model.aggregate_threshold_, rtol=RTOL)
    np.testing.assert_allclose(list(model.aggregate_thresholds_per_fold_.values()),
                               list(jax_model.aggregate_thresholds_per_fold_.values()), rtol=RTOL)
    jax_build, build = (m["metadata"]["build_metadata"]["model"] for m in (jax_meta, meta))
    assert build["model_offset"] == jax_build["model_offset"] == OFFSETS[name]
    assert build["cross_validation"]["splits"] == jax_build["cross_validation"]["splits"]
    scores, jax_scores = build["cross_validation"]["scores"], jax_build["cross_validation"]["scores"]
    assert list(scores) == list(jax_scores)
    for key, folds in jax_scores.items():
        assert list(scores[key]) == list(folds), key
        np.testing.assert_allclose(list(scores[key].values()), list(folds.values()), rtol=RTOL, atol=ATOL,
                                   err_msg=key)
    jax_params = jax_model.base_estimator.steps[-1][1].params_
    params = model.base_estimator.estimator.params_
    assert list(params) == list(jax_params)
    for key, layer in jax_params.items():
        assert sorted(params[key]) == sorted(layer)  # JAX pytrees sort the leaf keys
        for leaf, value in layer.items():
            np.testing.assert_allclose(params[key][leaf].numpy(), np.asarray(value), atol=PARAM_ATOL,
                                       err_msg=f"{key}/{leaf}")
    assert set(build["model_meta"]) == set(jax_build["model_meta"])
    assert build["model_meta"].get("forecast_steps") == jax_build["model_meta"].get("forecast_steps")
    assert build["model_meta"]["history"]["params"] == jax_build["model_meta"]["history"]["params"]
    assert build["training"]["epochs_run"] == jax_build["training"]["epochs_run"] == 2


def test_lstm_machines_are_windowed_estimators(builds):
    """The reference's class paths became the port's LSTM estimators, with
    the lookahead of their kind; lstm-ae-2's detector shuffled in both."""
    estimators = {name: builds[0][name][2].base_estimator.estimator for name in NAMES}
    assert type(estimators["lstm-ae"]) is TorchLSTMAutoEncoder and estimators["lstm-ae"].lookahead == 0
    assert type(estimators["lstm-ae-2"]) is TorchLSTMAutoEncoder
    assert type(estimators["lstm-fc"]) is TorchLSTMForecast and estimators["lstm-fc"].lookahead == 1
    assert estimators["lstm-ae"].spec_ == estimators["lstm-ae-2"].spec_
    _, jax_meta, model, meta = builds[0]["lstm-ae-2"]
    assert model.shuffle and all(m["metadata"]["build_metadata"]["model"]["model_meta"]["shuffle"]
                                 for m in (meta, jax_meta))


def _kfcv_lstm_machine():
    return {
        "name": "kfcv-lstm",
        "model": {"gordo_tpu.models.anomaly.diff.DiffBasedKFCVAnomalyDetector": {"base_estimator": {
            "gordo_tpu.models.JaxLSTMAutoEncoder": {"kind": "lstm_symmetric", "dims": [3], "funcs": ["tanh"],
                                                    "lookback_window": 4, "epochs": 1}}}},
        "dataset": {"type": "RandomDataset", "tag_list": ["t1", "t2"],
                    "train_start_date": "2020-01-01T00:00:00+00:00",
                    "train_end_date": "2020-01-02T00:00:00+00:00"},
    }


def test_kfcv_lstm_machine_fails_in_both():
    """KFold's scattered folds have no window mapping: both fleet builders
    hand the machine on to their sequential builder, which fails in the
    detector's ``cross_validate`` (an LSTM's prediction is shorter than
    its fold's test rows), so both record it as failed with a
    ``ValueError`` and build nothing."""
    from gordo_tpu.machine import Machine as JaxMachine

    config = _kfcv_lstm_machine()
    jax_builder = JaxFleetBuilder([JaxMachine.from_config(config, project_name=PROJECT)])
    assert jax_builder.build() == []
    assert isinstance(jax_builder.build_errors["kfcv-lstm"], ValueError)
    X = np.random.RandomState(0).rand(100, 2)
    builder = FleetBuilder([Machine.from_config(config, PROJECT, data=(X, None))], device="cpu")
    assert builder.build() == []
    assert isinstance(builder.build_errors["kfcv-lstm"], ValueError)
    assert "shape mismatch" in str(builder.build_errors["kfcv-lstm"])


# -- serving JAX-built LSTM detectors --------------------------------------------


def _scaler_state(scaler):
    return {"scale_": np.asarray(scaler.scale_), "min_": np.asarray(scaler.min_)}


def port_detector(model) -> DiffBasedAnomalyDetector:
    """A JAX-built detector as the port's, through its plain-state
    constructor (an LSTM's estimator named by its class)."""
    pipeline = model.base_estimator
    estimator = pipeline.steps[-1][1]
    return DiffBasedAnomalyDetector.from_state(
        {
            "spec": estimator.spec_.to_dict(),
            "estimator": type(estimator).__name__,
            "params": {k: {n: np.asarray(v) for n, v in layer.items()} for k, layer in estimator.params_.items()},
            "pipeline": [_scaler_state(step) for _, step in pipeline.steps[:-1]],
            "scaler": _scaler_state(model.scaler),
            "feature_thresholds": np.asarray(model.feature_thresholds_.values),
            "aggregate_threshold": model.aggregate_threshold_,
        },
        device="cpu",
    )


@pytest.fixture(scope="module")
def crossed(builds, tmp_path_factory):
    """The JAX-built detectors crossed into the port through ``from_state``,
    dumped with the JAX ``metadata.json``."""
    crossed = tmp_path_factory.mktemp("crossed") / REVISION
    for name, (jax_model, jax_meta, _, _) in builds[0].items():
        serializer.dump(port_detector(jax_model), str(crossed / name), metadata=jax_meta)
    return str(crossed)


@pytest.fixture(scope="module")
def clients(builds, crossed):
    """The JAX app over the JAX build, and the port's app over the same
    detectors crossed in."""
    jax_dir = builds[1]
    previous = os.environ.get("MODEL_COLLECTION_DIR")
    os.environ["MODEL_COLLECTION_DIR"] = str(jax_dir)
    try:
        yield Client(jax_build_app(config={"EXPECTED_MODELS": []})), Client(build_app(crossed, device="cpu"))
    finally:
        if previous is None:
            os.environ.pop("MODEL_COLLECTION_DIR", None)
        else:
            os.environ["MODEL_COLLECTION_DIR"] = previous


def _frame(tags, rows, seed, start_minute=0):
    rng = np.random.RandomState(seed)
    index = [
        f"2020-03-01T{(start_minute + 10 * i) // 60:02d}:{(start_minute + 10 * i) % 60:02d}:00+00:00"
        for i in range(rows)
    ]
    values = rng.rand(len(tags), rows)
    return {tag: dict(zip(index, values[t].tolist())) for t, tag in enumerate(tags)}


def _assert_same(expected, got, path="data"):
    if isinstance(expected, dict):
        assert isinstance(got, dict) and list(got) == list(expected), path
        for key in expected:
            _assert_same(expected[key], got[key], f"{path}/{key}")
    elif isinstance(expected, float) and isinstance(got, float):
        np.testing.assert_allclose(got, expected, rtol=RTOL, atol=SERVE_ATOL, err_msg=path)
    else:
        assert got == expected, path


def _post(client, url, payload):
    response = client.post(url, data=json.dumps(payload), content_type="application/json")
    return response.status_code, json.loads(response.get_data())


@pytest.mark.parametrize("name", NAMES)
def test_anomaly_route_matches_jax(clients, name):
    """30 rows in, ``30 - offset`` rows out, tail aligned, on both."""
    X, y = _frame(TAGS[name], 30, seed=1), _frame(TAGS[name], 30, seed=2)
    url = f"/gordo/v0/{PROJECT}/{name}/anomaly/prediction"
    (jax_status, jax_body), (status, body) = (_post(c, url, {"X": X, "y": y}) for c in clients)
    assert (status, jax_status) == (200, 200)
    assert list(body) == list(jax_body)
    rows = body["data"]["total-anomaly-scaled"]["total-anomaly-scaled"]
    assert len(rows) == 30 - OFFSETS[name]
    assert min(rows) == sorted(X[TAGS[name][0]])[OFFSETS[name]].replace("T", " ")
    _assert_same(jax_body["data"], body["data"])


@pytest.mark.parametrize("rows", [2, 4, 5])
def test_too_few_rows_answer_alike(clients, rows):
    """A lookback of 5 needs 6 rows at the anomaly and prediction routes:
    both servers answer 400 with fewer."""
    for route in ("anomaly/prediction", "prediction"):
        url = f"/gordo/v0/{PROJECT}/lstm-ae/{route}"
        X = _frame(TAGS["lstm-ae"], rows, seed=3)
        statuses = [_post(c, url, {"X": X, "y": X})[0] for c in clients]
        assert statuses == [400, 400], route


@pytest.mark.parametrize("name", NAMES)
def test_prediction_route_matches_jax(clients, name):
    X = _frame(TAGS[name], 25, seed=4)
    url = f"/gordo/v0/{PROJECT}/{name}/prediction"
    (jax_status, jax_body), (status, body) = (_post(c, url, {"X": X}) for c in clients)
    assert (status, jax_status) == (200, 200)
    assert len(body["data"]["model-output"][TAGS[name][0]]) == 25 - OFFSETS[name]
    _assert_same(jax_body["data"], body["data"])


def test_metadata_route_matches_jax(clients):
    """The served ``metadata.json`` (its ``model_offset``) alike; the
    checksum is each package's own pickle's."""
    url = f"/gordo/v0/{PROJECT}/lstm-fc/metadata"
    jax_body, body = (json.loads(c.get(url).get_data()) for c in clients)
    assert body["metadata"] == jax_body["metadata"]
    assert body["metadata"]["metadata"]["build_metadata"]["model"]["model_offset"] == 4


@pytest.mark.parametrize("full", [False, True], ids=["lean", "full"])
def test_mixed_fleet_route_matches_jax(clients, full):
    """One request over the mixed fleet (the two LSTM autoencoders share a
    bucket with the forecaster's spec apart), a too-short series and an
    unknown machine among them."""
    X = {name: _frame(TAGS[name], 20 + 3 * i, seed=10 + i) for i, name in enumerate(NAMES)}
    X["lstm-ae-2"] = _frame(TAGS["lstm-ae-2"], 3, seed=9)  # no whole window
    X["no-such-machine"] = X["ff"]
    url = f"/gordo/v0/{PROJECT}/prediction/fleet" + ("?full" if full else "")
    (jax_status, jax_body), (status, body) = (_post(c, url, {"X": X}) for c in clients)
    assert (status, jax_status) == (200, 200)
    assert body["errors"] == jax_body["errors"]
    assert sorted(body["errors"]) == ["lstm-ae-2", "no-such-machine"]
    assert sorted(body["data"]) == ["ff", "lstm-ae", "lstm-fc"]
    lean = body["data"]["lstm-fc"]["total-anomaly-unscaled"] if not full else \
        body["data"]["lstm-fc"]["total-anomaly-unscaled"]["total-anomaly-unscaled"]
    assert len(lean) == 20 + 3 - OFFSETS["lstm-fc"]
    _assert_same(jax_body["data"], body["data"])


@pytest.fixture
def stream_clients(clients, crossed, monkeypatch):
    """The JAX client with a fresh process-global plane and no engine, and
    a fresh port app over the crossed detectors: 8-row windows."""
    from gordo_tpu import serve as jax_serve
    from gordo_tpu.stream import reset_plane

    monkeypatch.setenv("GORDO_TPU_STREAM_WINDOW_ROWS", "8")
    monkeypatch.setenv("GORDO_TPU_STREAM_HEARTBEAT_S", "0.05")
    engine = jax_serve.get_engine()
    jax_serve.install_engine(None)
    jax_serve.reset_stream_breakers()
    reset_plane()
    try:
        yield clients[0], Client(build_app(crossed, device="cpu"))
    finally:
        reset_plane()
        jax_serve.reset_stream_breakers()
        jax_serve.install_engine(engine)


def _sse(body: bytes):
    frames = []
    for frame in body.decode().split("\n\n"):
        if frame and not frame.startswith(":"):
            fields = dict(line.split(": ", 1) for line in frame.split("\n"))
            frames.append((fields.get("id"), fields["event"], json.loads(fields["data"])))
    return frames


def test_stream_over_mixed_fleet_matches_jax(stream_clients):
    """Two ingests over the mixed fleet: every ack and every event alike,
    the LSTM windows scored on their offset-shortened outputs."""
    url = f"/gordo/v0/{PROJECT}/stream/s1"
    batches = [
        {name: _frame(TAGS[name], 13 + i, seed=30 + i) for i, name in enumerate(NAMES)},
        {name: _frame(TAGS[name], 9, seed=40 + i, start_minute=300) for i, name in enumerate(NAMES[:2])},
    ]
    for X in batches:
        (jax_status, jax_ack), (status, ack) = (_post(c, url + "/ingest", {"X": X}) for c in stream_clients)
        assert (status, jax_status) == (200, 200)
        assert ack == jax_ack
    assert sum(ack["scored"].values()) > 0
    events_url = f"/gordo/v0/{PROJECT}/stream/s1/events?max_events=12&idle_timeout_s=0.1"
    jax_events, events = (_sse(c.get(events_url).get_data()) for c in stream_clients)
    assert [(i, k) for i, k, _ in events] == [(i, k) for i, k, _ in jax_events]
    assert [k for _, k, _ in events].count("anomaly") >= 4
    for (_, _, want), (_, _, have) in zip(jax_events, events):
        _assert_same(want, have)
