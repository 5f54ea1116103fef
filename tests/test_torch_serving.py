"""The port's serving slice against the JAX server, end to end on the CPU.

A two-machine detector config (a MinMaxScaler pipeline ahead of an
hourglass autoencoder, thresholds from cross-validation; machine-2
smooths with a window of 6) is built once with the JAX package's
``local_build``. Each detector crosses into the port through
``DiffBasedAnomalyDetector.from_state``, and a third, bare-pipeline
machine (not a detector) rides along. Both apps then get the same
requests on every route the port serves, over two revisions beside each
other (the second holds copies of machine-2 and machine-3), and the
statuses and parsed bodies must agree.

Tolerance: rtol 1e-5, atol 1e-6 on every numeric cell. The
reconstruction is f32 with sums taken in another order by XLA and by
torch, and the scaled errors subtract nearly equal numbers, so a few
ulps of the reconstruction carry into them; keys, column order, strings
and nulls must match exactly.
"""

import io
import json
import os
import pickle
import shutil
from urllib.parse import urlsplit

import numpy as np
import pytest
import torch
from werkzeug.test import Client

from gordo_tpu import serializer as jax_serializer
from gordo_tpu.builder import local_build
from gordo_tpu.server import build_app as jax_build_app
from gordo_tpu_torch import resolve_device, serializer
from gordo_tpu_torch.models.anomaly.diff import DiffBasedAnomalyDetector
from gordo_tpu_torch.models.estimators import TorchAutoEncoder
from gordo_tpu_torch.models.preprocessing import MinMaxScaler, Pipeline
from gordo_tpu_torch.ops.fleet_dense import fleet_feedforward
from gordo_tpu_torch.server import build_app
from gordo_tpu_torch.server.fleet_store import parse_resolution
from gordo_tpu_torch.server.wire import decode_frame, index_wire_keys, verify_frame

PROJECT = "test-project"
REVISION = "1602324482000"
#: the sibling revision: copies of machine-2 and machine-3
REVISION_2 = "1602324483000"
RTOL, ATOL = 1e-5, 1e-6

_MACHINE = """
  - name: {name}
    dataset:
      type: RandomDataset
      train_start_date: "2020-01-01T00:00:00+00:00"
      train_end_date: "2020-01-05T00:00:00+00:00"
      tag_list: [{tags}]
    model:
      gordo_tpu.models.anomaly.diff.DiffBasedAnomalyDetector:{detector}
        base_estimator:
          sklearn.pipeline.Pipeline:
            steps:
              - sklearn.preprocessing.MinMaxScaler
              - gordo_tpu.models.JaxAutoEncoder:
                  kind: feedforward_hourglass
                  epochs: 1
"""
CONFIG = "machines:" + "".join(
    _MACHINE.format(name=name, tags=tags, detector=detector)
    for name, tags, detector in (
        ("machine-1", "tag-1, tag-2, tag-3, tag-4", ""),
        ("machine-2", "tag-5, tag-6, tag-7, tag-8", "\n        window: 6"),
    )
)


def _scaler_state(scaler):
    return {"scale_": np.asarray(scaler.scale_), "min_": np.asarray(scaler.min_)}


def _estimator_state(pipeline):
    estimator = pipeline.steps[-1][1]
    params = {k: {n: np.asarray(v) for n, v in layer.items()} for k, layer in estimator.params_.items()}
    pipeline_scalers = [_scaler_state(step) for _, step in pipeline.steps[:-1]]
    return estimator.spec_.to_dict(), params, pipeline_scalers


def port_detector(model) -> DiffBasedAnomalyDetector:
    """A JAX-built detector as the port's, through its plain-state constructor."""
    spec, params, pipeline = _estimator_state(model.base_estimator)
    return DiffBasedAnomalyDetector.from_state(
        {
            "spec": spec,
            "params": params,
            "pipeline": pipeline,
            "scaler": _scaler_state(model.scaler),
            "feature_thresholds": np.asarray(model.feature_thresholds_.values),
            "aggregate_threshold": model.aggregate_threshold_,
            "require_thresholds": model.require_thresholds,
            "window": model.window,
            "smoothing_method": model.smoothing_method,
        },
        device="cpu",
    )


def port_pipeline(pipeline) -> Pipeline:
    spec, params, scalers = _estimator_state(pipeline)
    from gordo_tpu_torch.models.spec import FeedForwardSpec

    steps = [(f"step_{i}", MinMaxScaler(s["scale_"], s["min_"])) for i, s in enumerate(scalers)]
    return Pipeline(steps + [("ae", TorchAutoEncoder(FeedForwardSpec.from_dict(spec), params, device="cpu"))])


@pytest.fixture(scope="module")
def collections(tmp_path_factory):
    """``(jax_dir, port_dir)``: the same three machines served by both,
    each dir beside a REVISION_2 that holds copies of machine-2 and
    machine-3."""
    root = tmp_path_factory.mktemp("torch-serving")
    jax_dir, port_dir = root / "jax" / REVISION, root / "port" / REVISION
    builds = list(local_build(CONFIG, project_name=PROJECT))
    models = {machine.name: (model, machine.to_dict()) for model, machine in builds}
    # a bare pipeline of machine-1's spec: scores, but is not a detector
    models["machine-3"] = (models["machine-1"][0].base_estimator, models["machine-1"][1])
    for name, (model, metadata) in models.items():
        jax_serializer.dump(model, str(jax_dir / name), metadata=metadata)
        with open(jax_dir / name / "metadata.json") as f:
            metadata_json = json.load(f)
        port_model = port_pipeline(model) if name == "machine-3" else port_detector(model)
        serializer.dump(port_model, str(port_dir / name), metadata=metadata_json)
    for served in (jax_dir, port_dir):
        for name in ("machine-2", "machine-3"):
            shutil.copytree(served / name, served.parent / REVISION_2 / name)
    return str(jax_dir), str(port_dir)


@pytest.fixture(scope="module")
def clients(collections):
    jax_dir, port_dir = collections
    previous = os.environ.get("MODEL_COLLECTION_DIR")
    os.environ["MODEL_COLLECTION_DIR"] = jax_dir
    try:
        jax_client = Client(jax_build_app(config={"EXPECTED_MODELS": []}))
        yield jax_client, Client(build_app(port_dir, device="cpu"))
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
    values = rng.rand(len(tags), rows) * 2 - 0.5
    values[0, 3] = np.nan  # a missing reading
    # keys shuffled: the decoder must sort rows by time
    order = rng.permutation(rows)
    return {tag: {index[i]: (None if np.isnan(values[t, i]) else float(values[t, i])) for i in order}
            for t, tag in enumerate(tags)}


TAGS = {
    "machine-1": ["tag-1", "tag-2", "tag-3", "tag-4"],
    "machine-2": ["tag-5", "tag-6", "tag-7", "tag-8"],
    "machine-3": ["tag-1", "tag-2", "tag-3", "tag-4"],
}


def _assert_same(expected, got, path="data"):
    """Nested JSON objects equal: same keys in the same order, numbers
    within tolerance, everything else exact."""
    if isinstance(expected, dict):
        assert isinstance(got, dict), path
        assert list(got) == list(expected), path
        for key in expected:
            _assert_same(expected[key], got[key], f"{path}/{key}")
    elif isinstance(expected, float) and isinstance(got, float):
        np.testing.assert_allclose(got, expected, rtol=RTOL, atol=ATOL, err_msg=path)
    else:
        assert got == expected, path


def _post(client, url, payload):
    response = client.post(url, data=json.dumps(payload), content_type="application/json")
    return response.status_code, json.loads(response.get_data())


@pytest.mark.parametrize("name", ["machine-1", "machine-2"])
def test_anomaly_route_matches_jax(clients, name):
    jax_client, port_client = clients
    X = _frame(TAGS[name], 30, seed=1)
    y = _frame(TAGS[name], 30, seed=2)
    url = f"/gordo/v0/{PROJECT}/{name}/anomaly/prediction"
    launches = fleet_feedforward.launches
    jax_status, jax_body = _post(jax_client, url, {"X": X, "y": y})
    status, body = _post(port_client, url, {"X": X, "y": y})
    assert (status, jax_status) == (200, 200)
    assert list(body) == ["data", "time-seconds", "revision"] == list(jax_body)
    assert body["revision"] == jax_body["revision"] == REVISION
    assert list(body["data"]) == [
        "start", "end", "model-input", "model-output", "tag-anomaly-scaled",
        "total-anomaly-scaled", "tag-anomaly-unscaled", "total-anomaly-unscaled",
        "anomaly-confidence", "total-anomaly-confidence",
    ]
    _assert_same(jax_body["data"], body["data"])
    assert fleet_feedforward.launches == launches  # the CPU runs the plain version


@pytest.mark.parametrize("full", [False, True], ids=["lean", "full"])
def test_fleet_route_matches_jax(clients, full):
    jax_client, port_client = clients
    X = {name: _frame(tags, 25 + 5 * i, seed=10 + i) for i, (name, tags) in enumerate(TAGS.items())}
    X["no-such-machine"] = X["machine-1"]
    payload = {"X": X, "y": {"machine-2": _frame(TAGS["machine-2"], 35, seed=20)}}
    url = f"/gordo/v0/{PROJECT}/prediction/fleet" + ("?full" if full else "")
    jax_status, jax_body = _post(jax_client, url, payload)
    status, body = _post(port_client, url, payload)
    assert (status, jax_status) == (200, 200)
    assert list(body) == ["data", "errors", "revision"] == list(jax_body)
    assert body["errors"] == jax_body["errors"]
    assert sorted(body["data"]) == ["machine-1", "machine-2", "machine-3"]
    assert list(body["data"]["machine-3"]) == ["model-output", "total-anomaly-unscaled"]
    if full:
        assert "anomaly-confidence" in body["data"]["machine-1"]
    _assert_same({k: jax_body["data"][k] for k in body["data"]}, body["data"])


@pytest.mark.parametrize(
    "name,payload,status",
    [
        ("no-such-machine", {"X": {}, "y": {}}, 404),
        ("machine-1", {"X": {"tag-1": {"2020-01-01T00:00:00+00:00": 1.0}}}, 400),
        ("machine-1", {"y": {}}, 400),
        ("_bad_name", {"X": {}}, 422),
    ],
)
def test_error_statuses_match_jax(clients, name, payload, status):
    jax_client, port_client = clients
    url = f"/gordo/v0/{PROJECT}/{name}/anomaly/prediction"
    assert _post(jax_client, url, payload)[0] == status
    assert _post(port_client, url, payload)[0] == status


@pytest.mark.parametrize(
    "frame",
    [
        {"tag-1": {"not-a-time": 1.0}},
        {"tag-1": {"2020-01-01T00:00:00+00:00": "high"}},
        {"tag-1": {"2020-01-01T00:00:00+00:00": {"nested": 1.0}}},
        [1.0, 2.0],
    ],
)
def test_bad_frames_are_bad_requests(clients, frame):
    """Unreadable frames answer 400 (the JAX server answers some of these
    with a 500 from an unhandled parse error)."""
    _, port_client = clients
    url = f"/gordo/v0/{PROJECT}/machine-1/anomaly/prediction"
    status, body = _post(port_client, url, {"X": frame, "y": frame})
    assert status == 400, body


def test_non_detector_is_unprocessable(clients):
    jax_client, port_client = clients
    X = _frame(TAGS["machine-3"], 10, seed=5)
    url = f"/gordo/v0/{PROJECT}/machine-3/anomaly/prediction"
    assert _post(jax_client, url, {"X": X, "y": X})[0] == 422
    assert _post(port_client, url, {"X": X, "y": X})[0] == 422


def test_healthcheck_and_unknown_route(clients):
    _, port_client = clients
    assert port_client.get("/healthcheck").status_code == 200
    assert port_client.get("/nope").status_code == 404
    assert port_client.get(f"/gordo/v0/{PROJECT}/prediction/fleet").status_code == 405


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            resolve_device()
    assert resolve_device("cpu").type == "cpu"


def test_artifact_is_device_independent(collections):
    _, port_dir = collections
    model = serializer.load(os.path.join(port_dir, "machine-1"), device="cpu")
    assert model.base_estimator.estimator.params_["out"]["W"].device.type == "cpu"
    state = pickle.loads(pickle.dumps(model))
    params = state.base_estimator.estimator.__getstate__()["params_"]
    assert isinstance(params["out"]["W"], np.ndarray)
    if not torch.cuda.is_available():
        # the default device is cuda: no quiet move to the CPU
        with pytest.raises(RuntimeError, match="CUDA"):
            serializer.load(os.path.join(port_dir, "machine-1"))
    assert serializer.list_model_dirs(port_dir) == ["machine-1", "machine-2", "machine-3"]
    assert serializer.load_metadata(os.path.join(port_dir, "machine-1"))["dataset"]["resolution"] == "10min"


def test_store_bucket_and_ingest_plan_match_jax(collections):
    """One bucket per spec, names sorted, and the compiled ingest plan row
    for row with it, as the JAX store builds them."""
    from gordo_tpu.server.fleet_store import RevisionFleet as JaxRevisionFleet
    from gordo_tpu_torch.server.fleet_store import RevisionFleet, find_estimator

    jax_dir, port_dir = collections
    jax_fleet, fleet = JaxRevisionFleet(jax_dir), RevisionFleet(port_dir, torch.device("cpu"))
    for name in ("machine-1", "machine-2", "machine-3"):
        jax_fleet.model(name)
        fleet.model(name)
    spec = find_estimator(fleet.model("machine-1")).spec_
    jax_spec = jax_fleet.model("machine-1").base_estimator.steps[-1][1].spec_
    names, stacked = fleet.spec_bucket(spec)
    jax_names, jax_stacked = jax_fleet.spec_bucket(jax_spec)
    assert names == jax_names == ["machine-1", "machine-2", "machine-3"]
    np.testing.assert_array_equal(stacked["out"]["W"].numpy(), np.asarray(jax_stacked["out"]["W"]))
    scale, offset = fleet.ingest_plan(spec)
    jax_plan = jax_fleet.ingest_plan(jax_spec)
    assert jax_plan.names == names
    np.testing.assert_allclose(scale.numpy(), np.asarray(jax_plan.scale), rtol=1e-7)
    np.testing.assert_allclose(offset.numpy(), np.asarray(jax_plan.offset), rtol=1e-7, atol=1e-7)


@pytest.mark.parametrize("names", [["machine-1", "machine-2", "machine-3"], ["machine-3", "machine-1"]],
                         ids=["whole-bucket", "gather"])
def test_fleet_scores_match_jax(collections, names):
    """The store's K2 launch (its plain version here) against the JAX
    store's forward and ``mse_vs_raw``: raw rows in, the mse against them;
    a NaN reading makes its row's mse NaN on both."""
    from gordo_tpu.server.fleet_store import RevisionFleet as JaxRevisionFleet
    from gordo_tpu_torch.server.fleet_store import RevisionFleet

    jax_dir, port_dir = collections
    rng = np.random.RandomState(8)
    inputs = {name: (rng.rand(11 + 3 * i, 4) * 2 - 0.5).astype(np.float32) for i, name in enumerate(names)}
    inputs[names[0]][5, 1] = np.nan
    expected, jax_errors = JaxRevisionFleet(jax_dir).fleet_scores(inputs)
    got, errors = RevisionFleet(port_dir, torch.device("cpu")).fleet_scores(inputs)
    assert errors == jax_errors == {}
    assert list(got) == sorted(names)
    for name in names:
        recon, mse = got[name]
        np.testing.assert_allclose(recon, expected[name][0], rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(mse, expected[name][1], rtol=RTOL, atol=ATOL)
        assert mse.dtype == np.float32 and np.isnan(mse).sum() == (name == names[0])


@pytest.mark.parametrize(
    "keys",
    [
        ["2020-03-01T00:10:00+00:00", "2020-03-01T00:00:00+00:00"],
        ["2020-03-01T00:00:00Z", "2020-03-01T00:00:00.5Z"],
        ["2020-03-02", "2020-03-01"],
        ["2020-03-01T00:00:00+01:00", "2020-03-01T01:30:00+01:00"],
        ["3", "1", "2"],
    ],
)
def test_frame_decoding_matches_pandas(keys):
    from gordo_tpu.server.utils import dataframe_from_dict, index_wire_keys as jax_keys

    data = {"a": {k: float(i) for i, k in enumerate(keys)}, "b": {keys[0]: None}}
    expected = dataframe_from_dict(json.loads(json.dumps(data)))
    frame = decode_frame(data)
    np.testing.assert_array_equal(frame.values, expected[["a", "b"]].to_numpy(dtype=float))
    assert index_wire_keys(frame.index) == jax_keys(expected.index)


def test_verify_frame_aligns_columns():
    frame = decode_frame({"b": [1.0, 2.0], "a": [3.0, 4.0], "c": [0.0, 0.0]})
    assert verify_frame(frame, ["a", "b"]).values.tolist() == [[3.0, 1.0], [4.0, 2.0]]
    renamed = verify_frame(decode_frame({"x": [1.0], "y": [2.0]}), ["a", "b"])
    assert renamed.columns == ["a", "b"] and renamed.values.tolist() == [[1.0, 2.0]]
    with pytest.raises(ValueError):
        verify_frame(frame, ["a", "z"])


def test_prediction_table_matches_jax():
    import pandas as pd

    from gordo_tpu.server.wire.assemble import prediction_table as jax_table
    from gordo_tpu.server.wire.json_codec import encode_table as jax_encode_table
    from gordo_tpu_torch.server.wire import encode_table, prediction_table

    data = _frame(["t-1", "t-2"], 12, seed=7)
    frame = decode_frame(data)
    df = pd.DataFrame(frame.values, columns=frame.columns, index=pd.DatetimeIndex(frame.index))
    output = np.random.RandomState(7).rand(10, 2).astype(np.float32)
    expected = jax_table(["t-1", "t-2"], df, output, frequency=pd.tseries.frequencies.to_offset("10min"))
    got = prediction_table(frame, output, ["t-1", "t-2"], frequency=parse_resolution("10min"))
    _assert_same(json.loads("".join(jax_encode_table(expected))), json.loads("".join(encode_table(got))))


def test_port_app_runs_over_a_socket(collections):
    """The WSGI app behind the threaded wsgiref server, as ``run_server`` uses it."""
    import threading
    import urllib.request

    from gordo_tpu_torch.server.app import make_wsgi_server

    _, port_dir = collections
    server = make_wsgi_server(build_app(port_dir, device="cpu"), "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        url = f"http://127.0.0.1:{server.server_port}"
        X = _frame(TAGS["machine-2"], 8, seed=3)
        request = urllib.request.Request(
            f"{url}/gordo/v0/{PROJECT}/machine-2/anomaly/prediction",
            data=json.dumps({"X": X, "y": X}).encode(),
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(request, timeout=30) as response:
            assert response.status == 200
            assert response.headers["revision"] == REVISION
            body = json.load(io.TextIOWrapper(response))
        assert len(body["data"]["model-output"]["tag-5"]) == 8
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()


# -- the streaming plane -----------------------------------------------------------


@pytest.fixture
def stream_clients(clients, collections, monkeypatch):
    """The JAX client with a fresh process-global plane and standalone
    breaker board (no engine), and a fresh port app: window 8 rows,
    breakers that trip on one failure and cool down for 3 s."""
    from gordo_tpu import serve as jax_serve
    from gordo_tpu.stream import reset_plane

    for name, value in [
        ("GORDO_TPU_STREAM_WINDOW_ROWS", "8"),
        ("GORDO_TPU_STREAM_HEARTBEAT_S", "0.05"),
        ("GORDO_TPU_BREAKER_THRESHOLD", "1"),
        ("GORDO_TPU_BREAKER_COOLDOWN_S", "3.0"),
        ("GORDO_TPU_BREAKER_BACKOFF", "1.0"),
    ]:
        monkeypatch.setenv(name, value)
    engine = jax_serve.get_engine()
    jax_serve.install_engine(None)
    jax_serve.reset_stream_breakers()
    reset_plane()
    try:
        yield clients[0], Client(build_app(collections[1], device="cpu"))
    finally:
        reset_plane()
        jax_serve.reset_stream_breakers()
        jax_serve.install_engine(engine)


def _sse(body: bytes):
    """``(id, event, data)`` of every event frame; heartbeats left out."""
    frames = []
    for frame in body.decode().split("\n\n"):
        if not frame or frame.startswith(":"):
            continue
        fields = dict(line.split(": ", 1) for line in frame.split("\n"))
        frames.append((fields.get("id"), fields["event"], json.loads(fields["data"])))
    return frames


def _events(client, stream, max_events):
    url = f"/gordo/v0/{PROJECT}/stream/{stream}/events?max_events={max_events}&idle_timeout_s=0.1"
    response = client.get(url)
    assert response.status_code == 200
    assert response.headers["Content-Type"].startswith("text/event-stream")
    return _sse(response.get_data())


def _same_events(expected, got, drop=()):
    assert [(i, k) for i, k, _ in got] == [(i, k) for i, k, _ in expected]
    for (_, _, want), (_, _, have) in zip(expected, got):
        _assert_same({k: v for k, v in want.items() if k not in drop},
                     {k: v for k, v in have.items() if k not in drop})


def test_stream_matches_jax(stream_clients):
    """Ingest, watermark flushes (snapped to the row ladder), the SSE feed,
    status and close: the same acks and events from both servers."""
    jax_client, port_client = stream_clients
    url = f"/gordo/v0/{PROJECT}/stream/s1"
    batches = [
        {"machine-1": _frame(TAGS["machine-1"], 20, seed=30), "machine-2": _frame(TAGS["machine-2"], 13, seed=31),
         "machine-3": _frame(TAGS["machine-3"], 5, seed=32), "no-such-machine": _frame(TAGS["machine-1"], 4, seed=33)},
        {"machine-1": _frame(TAGS["machine-1"], 9, seed=34, start_minute=200),
         "machine-3": _frame(TAGS["machine-3"], 40, seed=35, start_minute=50)},
    ]
    launches = fleet_feedforward.launches
    for X in batches:
        jax_status, jax_ack = _post(jax_client, url + "/ingest", {"X": X})
        status, ack = _post(port_client, url + "/ingest", {"X": X})
        assert (status, jax_status) == (200, 200)
        assert ack == jax_ack
    assert ack["scored"] == {"machine-1": 8, "machine-3": 32}  # 45 pending rows snap to 32
    assert fleet_feedforward.launches == launches  # the CPU runs the plain version
    expected = _events(jax_client, "s1", 8)
    got = _events(port_client, "s1", 8)
    _same_events(expected, got)
    assert [k for _, k, _ in got] == ["open"] + ["anomaly"] * 4
    assert got[1][2]["mse_mean"] is not None and got[1][2]["revision"] == REVISION
    status_url = f"/gordo/v0/{PROJECT}/stream/status"
    jax_status = json.loads(jax_client.get(status_url).get_data())
    status = json.loads(port_client.get(status_url).get_data())
    assert status["sessions"][f"{PROJECT}/s1"]["accounting"] == jax_status["sessions"][f"{PROJECT}/s1"]["accounting"]
    for client in (jax_client, port_client):
        assert client.delete(url).status_code == 200
        assert client.delete(f"/gordo/v0/{PROJECT}/stream/nope").status_code == 404
    assert _events(port_client, "s1", 100)[-1][1] == "end"
    assert _post(port_client, url + "/ingest", {"X": batches[0]})[0] == 410
    assert _post(jax_client, url + "/ingest", {"X": batches[0]})[0] == 410


def test_stream_quarantine_and_recovery_match_jax(stream_clients):
    """A member poisoned at the ``stream_score`` fault site errors, is
    quarantined while the others keep scoring, and recovers with its
    backlog as one span, on both servers."""
    import time

    from gordo_tpu.utils import faults as jax_faults
    from gordo_tpu_torch.utils import faults

    jax_client, port_client = stream_clients
    url = f"/gordo/v0/{PROJECT}/stream/s2/ingest"

    def ingest(step):
        X = {name: _frame(tags, 8, seed=40 + step, start_minute=80 * step) for name, tags in TAGS.items()}
        jax_ack, ack = _post(jax_client, url, {"X": X})[1], _post(port_client, url, {"X": X})[1]
        assert ack.keys() == jax_ack.keys()
        assert list(ack.pop("quarantined")) == list(jax_ack.pop("quarantined"))  # values: the cooldown left
        assert ack == jax_ack
        return ack

    rules = (jax_faults.FaultRule("stream_score", match="s2:machine-2", times=None),
             faults.FaultRule("stream_score", match="s2:machine-2", times=None))
    with jax_faults.inject(rules[0]), faults.inject(rules[1]):
        assert ingest(0)["score_errors"] == {"machine-2": "FaultInjected"}
        assert "machine-2" not in ingest(1)["scored"]  # quarantined: buffered, not cut
    time.sleep(3.1)  # past the cooldown: the next flush is the probe
    assert ingest(2)["scored"] == {"machine-1": 8, "machine-2": 16, "machine-3": 8}
    expected, got = _events(jax_client, "s2", 20), _events(port_client, "s2", 20)
    _same_events(expected, got, drop=("retry_after_s",))
    kinds = [(k, d.get("machine")) for _, k, d in got]
    assert ("error", "machine-2") in kinds and ("quarantined", "machine-2") in kinds
    assert ("recovered", "machine-2") in kinds
    backlog = [d for _, k, d in got if k == "anomaly" and d["machine"] == "machine-2"]
    assert [(d["first_seq"], d["last_seq"], d["windows"]) for d in backlog] == [(9, 24, 2)]


def test_stream_statuses(stream_clients, monkeypatch):
    _, port_client = stream_clients
    base = f"/gordo/v0/{PROJECT}/stream"
    assert _post(port_client, f"{base}/bad id!/ingest", {"X": {}})[0] == 400
    assert _post(port_client, f"{base}/s3/ingest", {"X": {}})[0] == 400
    response = port_client.post(f"{base}/s3/ingest", data=b"ARROW1\x00", content_type="application/vnd.apache.arrow.stream")
    assert response.status_code == 400  # not a GDTAF1 container
    assert port_client.get(f"{base}/s3/events?cursor=x").status_code == 400
    monkeypatch.setenv("GORDO_TPU_STREAM_MAX_SESSIONS", "1")
    capped = Client(build_app(port_client.application.store.collection_dir, device="cpu"))
    assert _post(capped, f"{base}/a/ingest", {"X": {"machine-1": _frame(TAGS["machine-1"], 4, seed=1)}})[0] == 200
    response = capped.post(f"{base}/b/ingest", data=json.dumps({"X": {}}), content_type="application/json")
    assert response.status_code == 429 and response.headers["Retry-After"] == "1"
    capped.application.plane.drain()
    response = capped.post(f"{base}/c/ingest", data=json.dumps({"X": {}}), content_type="application/json")
    assert response.status_code == 503 and response.headers["Retry-After"] == "1"
    monkeypatch.setenv("GORDO_TPU_STREAM_ENABLED", "0")
    off = Client(build_app(port_client.application.store.collection_dir, device="cpu"))
    assert _post(off, f"{base}/a/ingest", {"X": {}})[0] == 503
    assert json.loads(off.get(f"{base}/status").get_data())["enabled"] is False


# -- routes, revisions and negotiation ----------------------------------------------


def _call(client, method, url, payload=None, **kwargs):
    """``(status, parsed JSON body or None, revision header)``."""
    if payload is not None:
        kwargs.update(data=json.dumps(payload), content_type="application/json")
    response = client.open(url, method=method, **kwargs)
    data = response.get_data()
    body = json.loads(data) if response.mimetype == "application/json" else None
    return response.status_code, body, response.headers.get("revision")


def _same_call(clients, method, url, payload=None, drop=(), **kwargs):
    """The same request to both apps: statuses and revision headers equal,
    bodies equal but for the keys in ``drop``; returns the port's."""
    expected, got = (_call(client, method, url, payload, **kwargs) for client in clients)
    assert got[0] == expected[0], (url, got, expected)
    assert got[2] == expected[2], url
    if expected[1] is None:
        assert got[1] is None
    else:
        _assert_same({k: v for k, v in expected[1].items() if k not in drop},
                     {k: v for k, v in got[1].items() if k not in drop}, url)
    return got


def _pin(how, revision):
    """The keyword arguments that pin ``revision``, by query or by header."""
    return {"query_string": {"revision": revision}} if how == "query" else {"headers": {"revision": revision}}


@pytest.mark.parametrize("how", ["query", "header"])
def test_revision_pin(clients, how):
    """A pinned revision answers from its own directory and stamps itself;
    a missing one answers 410 with its name, a malformed one 410 with no
    revision at all."""
    base = f"/gordo/v0/{PROJECT}"
    X = _frame(TAGS["machine-2"], 12, seed=60)
    anomaly = f"{base}/machine-2/anomaly/prediction"
    status, body, header = _same_call(clients, "POST", anomaly, {"X": X, "y": X}, drop=("time-seconds",),
                                      **_pin(how, REVISION_2))
    assert (status, body["revision"], header) == (200, REVISION_2, REVISION_2)
    assert _same_call(clients, "GET", f"{base}/models", **_pin(how, REVISION_2))[1]["models"] == [
        "machine-2", "machine-3"]
    status, body, _ = _same_call(clients, "POST", f"{base}/machine-1/anomaly/prediction", {"X": X, "y": X},
                                 **_pin(how, REVISION_2))
    assert (status, body) == (404, {"message": "No such model found: 'machine-1'", "revision": REVISION_2})
    fleet = {"X": {"machine-1": X, "machine-2": X}}
    status, body, _ = _same_call(clients, "POST", f"{base}/prediction/fleet", fleet, **_pin(how, REVISION_2))
    assert status == 200 and list(body["data"]) == ["machine-2"] and body["errors"]["machine-1"]["status"] == 404
    status, body, header = _same_call(clients, "POST", anomaly, {"X": X, "y": X}, **_pin(how, "999"))
    assert (status, body, header) == (410, {"error": "Revision '999' not found.", "revision": "999"}, "999")
    status, body, header = _same_call(clients, "GET", f"{base}/models", **_pin(how, "12a"))
    assert (status, body, header) == (410, {"error": "Revision should only contains numbers."}, None)


def test_all_columns_smooth(clients):
    """``?all_columns`` adds the four ``smooth-*`` groups for a detector
    with a window (machine-2, window 6, rolling median), on the anomaly
    route and in the fleet route's full entries; NaN heads are nulls."""
    base = f"/gordo/v0/{PROJECT}"
    X, y = _frame(TAGS["machine-2"], 30, seed=61), _frame(TAGS["machine-2"], 30, seed=62)
    url = f"{base}/machine-2/anomaly/prediction"
    _, body, _ = _same_call(clients, "POST", url, {"X": X, "y": y}, drop=("time-seconds",),
                            query_string={"all_columns": ""})
    assert list(body["data"]) == [
        "start", "end", "model-input", "model-output", "tag-anomaly-scaled", "total-anomaly-scaled",
        "tag-anomaly-unscaled", "total-anomaly-unscaled", "smooth-tag-anomaly-scaled",
        "smooth-total-anomaly-scaled", "smooth-tag-anomaly-unscaled", "smooth-total-anomaly-unscaled",
        "anomaly-confidence", "total-anomaly-confidence",
    ]
    smooth = list(body["data"]["smooth-total-anomaly-unscaled"]["smooth-total-anomaly-unscaled"].values())
    assert smooth[:5] == [None] * 5 and all(isinstance(v, float) for v in smooth[-10:])
    _, plain, _ = _same_call(clients, "POST", url, {"X": X, "y": y}, drop=("time-seconds",))
    assert len(plain["data"]) == 10
    fleet = {"X": {"machine-1": X, "machine-2": X}}
    # the smooth groups come from the query only (a JSON body's all_columns is ignored, as there)
    _, body, _ = _same_call(clients, "POST", f"{base}/prediction/fleet", {**fleet, "all_columns": True},
                            query_string={"full": ""})
    assert "smooth-tag-anomaly-scaled" not in body["data"]["machine-2"]
    _, body, _ = _same_call(clients, "POST", f"{base}/prediction/fleet", fleet,
                            query_string={"full": "", "all_columns": ""})
    assert len(body["data"]["machine-2"]) == 14 and len(body["data"]["machine-1"]) == 10


ARROW = "application/vnd.apache.arrow.stream"


@pytest.mark.parametrize(
    "route,kwargs,status",
    [
        ("anomaly", {"headers": {"Accept": "text/csv"}}, 406),
        ("anomaly", {"headers": {"Accept": ARROW}}, 406),
        ("prediction", {"headers": {"Accept": "text/html, text/csv;q=0.5"}}, 406),
        ("fleet", {"headers": {"Accept": ARROW}}, 406),
        ("anomaly", {"headers": {"Accept": f"{ARROW}, application/json;q=0.5"}}, 200),
        ("prediction", {"headers": {"Accept": "*/*"}}, 200),
        ("fleet", {"headers": {"Accept": "application/*;q=0.3, application/x-parquet;q=0.2"}}, 200),
        ("anomaly", {"content_type": ARROW}, 415),
        ("prediction", {"content_type": ARROW}, 415),
        ("fleet", {"content_type": ARROW}, 415),
    ],
)
def test_negotiation_statuses(clients, monkeypatch, route, kwargs, status):
    """The JAX server without pyarrow and the port answer the same status
    and error body for each ``Accept`` header, ``?format`` and body type."""
    import gordo_tpu.server.utils

    monkeypatch.setenv("GORDO_TPU_WIRE_ARROW", "0")
    monkeypatch.setattr(gordo_tpu.server.utils, "pa", None)
    X = _frame(TAGS["machine-1"], 8, seed=63)
    url, payload = {
        "anomaly": (f"/gordo/v0/{PROJECT}/machine-1/anomaly/prediction", {"X": X, "y": X}),
        "prediction": (f"/gordo/v0/{PROJECT}/machine-1/prediction", {"X": X}),
        "fleet": (f"/gordo/v0/{PROJECT}/prediction/fleet", {"X": {"machine-1": X}}),
    }[route]
    kwargs = dict(kwargs, data=json.dumps(payload))
    kwargs.setdefault("content_type", "application/json")
    responses = [client.post(url, **kwargs) for client in clients]
    assert [r.status_code for r in responses] == [status, status]
    assert responses[1].mimetype == "application/json"
    if status != 200:
        assert json.loads(responses[1].get_data()) == json.loads(responses[0].get_data())


@pytest.mark.parametrize(
    "route,kwargs,status",
    [
        ("anomaly", {"headers": {"Accept": "application/x-parquet"}}, 200),
        ("anomaly", {"query_string": {"format": "parquet"}}, 200),
        ("prediction", {"query_string": {"format": "parquet"}}, 200),
        ("fleet", {"query_string": {"format": "parquet"}}, 406),
        ("prediction", {"content_type": "application/x-parquet"}, 200),
    ],
)
def test_parquet_negotiation_statuses(clients, route, kwargs, status):
    """The parquet rows of ``test_negotiation_statuses``, now against the
    JAX server with pyarrow: both answer 200 with a parquet file (a raw
    parquet body answered as JSON), and 406 with the same body on the fleet
    route."""
    import pandas as pd

    from gordo_tpu.server.utils import dataframe_into_parquet_bytes

    X = _frame(TAGS["machine-1"], 8, seed=63)
    url, payload = {
        "anomaly": (f"/gordo/v0/{PROJECT}/machine-1/anomaly/prediction", {"X": X, "y": X}),
        "prediction": (f"/gordo/v0/{PROJECT}/machine-1/prediction", {"X": X}),
        "fleet": (f"/gordo/v0/{PROJECT}/prediction/fleet", {"X": {"machine-1": X}}),
    }[route]
    if kwargs.get("content_type") == "application/x-parquet":
        frame = pd.DataFrame(X)
        frame.index = pd.to_datetime(frame.index, format="ISO8601")
        kwargs = dict(kwargs, data=dataframe_into_parquet_bytes(frame.sort_index()))
    else:
        kwargs = dict(kwargs, data=json.dumps(payload), content_type="application/json")
    responses = [client.post(url, **kwargs) for client in clients]
    assert [r.status_code for r in responses] == [status, status]
    assert responses[1].mimetype == responses[0].mimetype
    if status != 200:
        assert json.loads(responses[1].get_data()) == json.loads(responses[0].get_data())
    elif kwargs["content_type"] == "application/json":
        assert responses[1].mimetype == "application/octet-stream"
        assert pd.read_parquet(io.BytesIO(responses[1].get_data())).columns.get_level_values(0)[0] == "start"


@pytest.mark.parametrize("name", ["machine-1", "machine-2", "machine-3"])
def test_prediction_route_matches_jax(clients, name):
    """``POST .../<name>/prediction`` for two detectors and the bare
    pipeline machine-3: the same frame; on the CPU no kernel launches."""
    X = _frame(TAGS[name], 20, seed=64)
    url = f"/gordo/v0/{PROJECT}/{name}/prediction"
    launches = fleet_feedforward.launches
    status, body, header = _same_call(clients, "POST", url, {"X": X})
    assert (status, header) == (200, REVISION)
    assert list(body) == ["data", "revision"]
    assert list(body["data"]) == ["start", "end", "model-input", "model-output"]
    assert list(body["data"]["model-output"]) == TAGS[name]
    assert fleet_feedforward.launches == launches
    bad = {"X": {"tag-1": {"2020-01-01T00:00:00+00:00": 1.0}}}
    assert _call(clients[1], "POST", url, bad)[0] == _call(clients[0], "POST", url, bad)[0] == 400
    assert _same_call(clients, "POST", url, {"y": X})[0] == 400


@pytest.fixture
def fresh_clients(collections, monkeypatch):
    """Both apps built anew (after the caller's environment changes)."""

    def make():
        monkeypatch.setenv("MODEL_COLLECTION_DIR", collections[0])
        return Client(jax_build_app()), Client(build_app(collections[1], device="cpu"))

    return make


@pytest.mark.parametrize("expected", ['["machine-1", "machine-9"]', "[machine-1, machine-9]", None],
                         ids=["json", "yaml-flow", "unset"])
def test_listing_routes_match_jax(clients, fresh_clients, monkeypatch, expected):
    """``/models``, ``/revisions``, ``/expected-models``, ``/server-version``,
    ``/<name>/metadata`` and ``/<name>/healthcheck``. One difference, by
    design: ``info.json``'s ``checksum`` is of each package's own pickle."""
    if expected is None:
        monkeypatch.delenv("EXPECTED_MODELS", raising=False)
    else:
        monkeypatch.setenv("EXPECTED_MODELS", expected)
    both = fresh_clients()
    base = f"/gordo/v0/{PROJECT}"
    body = _same_call(both, "GET", f"{base}/expected-models")[1]
    assert body["expected-models"] == ([] if expected is None else ["machine-1", "machine-9"])
    assert _same_call(clients, "GET", f"{base}/models")[1]["models"] == ["machine-1", "machine-2", "machine-3"]
    status, body, header = _same_call(clients, "GET", "/server-version")
    assert (status, list(body), header) == (200, ["version"], None)
    revisions = [_call(client, "GET", f"{base}/revisions")[1] for client in clients]
    for body in revisions:
        assert body["latest"] == REVISION and sorted(body["available-revisions"]) == [REVISION, REVISION_2]
    for route in ("metadata", "healthcheck"):
        status, body, header = _same_call(clients, "GET", f"{base}/machine-2/{route}", drop=("checksum",))
        assert (status, header) == (200, REVISION)
        assert list(body) == ["checksum", "gordo-server-version", "metadata", "env", "revision"]
        assert body["metadata"]["name"] == "machine-2"
    assert _same_call(clients, "GET", f"{base}/no-such-machine/metadata")[0] == 404
    assert _same_call(clients, "GET", f"{base}/_bad/metadata")[0] == 422


def test_delete_revision(collections, monkeypatch, tmp_path):
    """422 for a malformed revision, 409 for the served one, 404 for a
    model the revision lacks; 200, after which the model is gone from its
    pinned revision, and the revision directory once only a builder's
    journal is left in it."""
    trees = []
    for served in collections:
        copy = tmp_path / os.path.basename(os.path.dirname(served))
        shutil.copytree(os.path.dirname(served), copy)
        trees.append(copy)
    monkeypatch.setenv("MODEL_COLLECTION_DIR", str(trees[0] / REVISION))
    both = (Client(jax_build_app()), Client(build_app(str(trees[1] / REVISION), device="cpu")))
    base = f"/gordo/v0/{PROJECT}"
    X = _frame(TAGS["machine-2"], 8, seed=65)
    pinned = {"query_string": {"revision": REVISION_2}}
    assert _same_call(both, "POST", f"{base}/machine-2/prediction", {"X": X}, **pinned)[0] == 200
    for name, revision, status in [("machine-2", "1x", 422), ("machine-2", REVISION, 409),
                                   ("machine-1", REVISION_2, 404)]:
        assert _same_call(both, "DELETE", f"{base}/{name}/revision/{revision}")[0] == status
    status, body, _ = _same_call(both, "DELETE", f"{base}/machine-2/revision/{REVISION_2}")
    assert (status, body) == (200, {"ok": True, "revision": REVISION})
    assert _same_call(both, "POST", f"{base}/machine-2/prediction", {"X": X}, **pinned)[0] == 404
    assert _same_call(both, "GET", f"{base}/models", **pinned)[1]["models"] == ["machine-3"]
    for tree in trees:
        (tree / REVISION_2 / "build_state.json").write_text("{}")
    assert _same_call(both, "DELETE", f"{base}/machine-3/revision/{REVISION_2}")[0] == 200
    assert not any((tree / REVISION_2).exists() for tree in trees)
    assert _same_call(both, "GET", f"{base}/models", **pinned)[0] == 410
    assert _same_call(both, "POST", f"{base}/machine-2/prediction", {"X": X})[0] == 200


def test_download_model_roundtrip(clients):
    """The downloaded bytes load with ``serializer.loads`` and predict what
    the served model predicts."""
    url = f"/gordo/v0/{PROJECT}/machine-1"
    for client in clients:
        response = client.get(f"{url}/download-model")
        assert response.status_code == 200 and response.mimetype == "application/octet-stream"
        assert response.headers["Content-Disposition"] == "attachment; filename=model.pickle"
    model = serializer.loads(response.get_data(), device="cpu")
    assert isinstance(model, DiffBasedAnomalyDetector)
    X = _frame(TAGS["machine-1"], 9, seed=66)
    X["tag-1"] = {k: (0.5 if v is None else v) for k, v in X["tag-1"].items()}
    served = _call(clients[1], "POST", f"{url}/prediction", {"X": X})[1]["data"]["model-output"]
    frame = verify_frame(decode_frame(X), TAGS["machine-1"])
    np.testing.assert_allclose(
        model.predict(frame.values),
        np.array([list(served[tag].values()) for tag in TAGS["machine-1"]]).T,
        rtol=1e-6, atol=1e-7,
    )
    assert _call(clients[1], "GET", f"/gordo/v0/{PROJECT}/nope/download-model")[0] == 404


def test_store_evicts_oldest_revision(collections, monkeypatch):
    """With ``N_CACHED_REVISIONS=1`` a pinned request evicts the served
    revision's fleet and the next served request loads it again; a fleet
    a caller already holds keeps scoring after it is evicted or
    invalidated."""
    monkeypatch.setenv("N_CACHED_REVISIONS", "1")
    app = build_app(collections[1], device="cpu")
    client, store = Client(app), app.store
    base = f"/gordo/v0/{PROJECT}/machine-2/prediction"
    X = _frame(TAGS["machine-2"], 8, seed=67)
    first = _call(client, "POST", base, {"X": X})
    served = store.fleet()
    assert _call(client, "POST", base, {"X": X}, query_string={"revision": REVISION_2})[0] == 200
    assert list(store._revisions) == [os.path.realpath(os.path.join(collections[1], "..", REVISION_2))]
    again = _call(client, "POST", base, {"X": X})
    assert store.fleet() is not served
    _assert_same(first[1], again[1])
    rows = decode_frame(X).values
    store.invalidate(collections[1])
    np.testing.assert_array_equal(served.predict("machine-2", rows), store.fleet().predict("machine-2", rows))


class _WSGIResponse:
    """A werkzeug test response as the ``requests.Response`` the JAX
    client reads."""

    def __init__(self, response):
        self.status_code = response.status_code
        self.headers = response.headers
        self.content = response.get_data()
        self.text = self.content.decode(errors="replace")

    def json(self):
        return json.loads(self.content)


class WSGISession:
    """The ``requests.Session`` surface the JAX client uses, answered by a
    WSGI app in this process (``tests/client/conftest.py``'s adapter)."""

    def __init__(self, app):
        self.client = Client(app)

    def get(self, url, params=None, **kwargs):
        return _WSGIResponse(self.client.get(urlsplit(url).path, query_string=params or {}))

    def post(self, url, params=None, json=None, **kwargs):
        return _WSGIResponse(self.client.post(urlsplit(url).path, query_string=params or {}, json=json))


@pytest.mark.parametrize("revision", [None, REVISION_2])
def test_jax_client_reads_the_port(collections, revision):
    """The JAX package's client lists revisions and models and reads a
    machine's metadata from the port's app, unpinned and pinned."""
    from gordo_tpu.client.client import Client as GordoClient

    session = WSGISession(build_app(collections[1], device="cpu"))
    client = GordoClient(PROJECT, revision=revision, session=session)
    revisions = client.get_revisions()
    assert revisions["latest"] == REVISION and sorted(revisions["available-revisions"]) == [REVISION, REVISION_2]
    names = client.get_machine_names()
    assert names == (["machine-2", "machine-3"] if revision else ["machine-1", "machine-2", "machine-3"])
    metadata = client.machine_metadata("machine-2")
    assert metadata["revision"] == (revision or REVISION)
    with open(os.path.join(collections[1], "machine-2", "metadata.json")) as f:
        assert metadata["metadata"] == json.load(f)
