"""The port's client (``gordo_tpu_torch/client/``) against the JAX
package's, on the CPU.

The crossed collection of ``tests/test_torch_serving.py`` (two detectors
built by the JAX package, a bare pipeline, a sibling revision) is served
by both apps in this process: the JAX client reads the JAX app through a
``requests``-shaped session, the port's client reads the port's app
through :class:`~gordo_tpu_torch.client.WSGITransport`. Both fetch each
machine's window through its own ``RandomDataset`` config. Held:

- discovery: revisions, model names, metadata (``checksum`` excepted, as
  in ``test_listing_routes_match_jax``), the machines, revision pinning
  and a gone revision (410);
- ``predict`` over JSON, parquet and Arrow, in one batch and in batches
  of 7 rows: the same machines, errors, column labels (the JSON answer's
  scalar groups as ``(group, group)``, the files' as ``(group, "")``, as
  the JAX client frames them), index; ``model-input`` within rtol 1e-5,
  atol 1e-6; every column the reconstruction reaches within rtol 1e-5 and
  the forward's error carried through, ``tests/test_torch_engine.py``'s
  bound: ``atol = (1e-6 + 1e-5 * max |model-output|) * max(1, largest
  scale_ of the error scaler)`` (the windows here are the machines' own
  sensor rows, tens of units wide, where the f32 reconstruction's error
  is set by its largest outputs, not by each cell);
- ``fleet_anomaly_scores``, lean and full, the same way;
- ``download-model``: the models predict the same rows within rtol 1e-5,
  atol 1e-6; ``_handle_response``'s statuses; a data fetch's failure
  recorded per machine;
- the forwarders: the parquet sink's file reads back as the JAX sink's
  (flat pipe-joined columns, appended); the Influx forwarder's line
  protocol, as a local ``/write`` stub records it (not held to
  ``influxdb.DataFrameClient``, which is not installed where these tests
  run);
- the ``client`` command group over a socket, its lines as the JAX
  group's.
"""

import io
import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlsplit

import numpy as np
import pandas as pd
import pytest
from werkzeug.test import Client as WerkzeugClient

from gordo_tpu.client import Client as JaxClient
from gordo_tpu.client import ForwardPredictionsToDisk as JaxForwardPredictionsToDisk
from gordo_tpu.client.io import _handle_response as jax_handle_response
from gordo_tpu.server import build_app as jax_build_app
from gordo_tpu_torch.client import Client, ForwardPredictionsIntoInflux, ForwardPredictionsToDisk, WSGITransport
from gordo_tpu_torch.client import io as port_io
from gordo_tpu_torch.cli.cli import main
from gordo_tpu_torch.server import build_app
from gordo_tpu_torch.server.app import make_wsgi_server

from tests.test_torch_serving import PROJECT, REVISION, REVISION_2, collections  # noqa: F401 - a fixture

RTOL, ATOL = 1e-5, 1e-6
START, END = "2020-01-02T00:00:00+00:00", "2020-01-02T06:00:00+00:00"
NAMES = ["machine-1", "machine-2", "machine-3"]
#: the machines' names in their metadata: machine-3's is machine-1's (the fixture's bare pipeline)
MACHINES = ["machine-1", "machine-2", "machine-1"]


class _Response:
    def __init__(self, response):
        self.status_code = response.status_code
        self.headers = response.headers
        self.content = response.get_data()
        self.text = self.content.decode(errors="replace")

    def json(self):
        return json.loads(self.content)


class JaxSession:
    """The ``requests.Session`` surface the JAX client uses (JSON, parquet
    files, raw bodies with headers), answered by a WSGI app in process."""

    def __init__(self, app):
        self.client = WerkzeugClient(app)

    def get(self, url, params=None, **kwargs):
        return _Response(self.client.get(urlsplit(url).path, query_string=params or {}))

    def post(self, url, params=None, json=None, files=None, data=None, headers=None, **kwargs):
        path, query = urlsplit(url).path, params or {}
        if files is not None:
            form = {name: (io.BytesIO(payload), f"{name}.parquet") for name, payload in files.items()}
            return _Response(self.client.post(path, query_string=query, data=form))
        if data is not None:
            return _Response(self.client.post(path, query_string=query, data=data, headers=headers or {}))
        return _Response(self.client.post(path, query_string=query, json=json))


@pytest.fixture(scope="module")
def apps(collections):  # noqa: F811
    jax_dir, port_dir = collections
    previous = os.environ.get("MODEL_COLLECTION_DIR")
    os.environ["MODEL_COLLECTION_DIR"] = jax_dir
    try:
        yield jax_build_app(config={"EXPECTED_MODELS": []}), build_app(port_dir, device="cpu")
    finally:
        if previous is None:
            os.environ.pop("MODEL_COLLECTION_DIR", None)
        else:
            os.environ["MODEL_COLLECTION_DIR"] = previous


def clients(apps, **kwargs):
    jax_app, port_app = apps
    return (JaxClient(PROJECT, session=JaxSession(jax_app), **kwargs),
            Client(PROJECT, transport=WSGITransport(port_app), device="cpu", **kwargs))


def _label(column):
    """A column label as one string: ``group|sub`` (trailing pipes stripped)."""
    if isinstance(column, tuple):
        return "|".join(map(str, column)).rstrip("|")
    return str(column)


def _flat(column):
    return _label((column.group, column.sub))


def same_predictions(expected, got, scale=1.0):
    """A JAX client's frame and the port client's table: the same labels
    in order, index and strings; the inputs within RTOL/ATOL, the rest
    within RTOL and the forward's error carried through."""
    assert [_flat(c) for c in got.columns] == [_label(c) for c in expected.columns]
    assert list(got.index) == list(expected.index.to_pydatetime())
    outputs = [i for i, c in enumerate(expected.columns) if _label(c).startswith(("model-output", "0"))]
    largest = float(np.nanmax(np.abs(expected.iloc[:, outputs].to_numpy(np.float64)))) if outputs else 0.0
    derived = (ATOL + RTOL * largest) * max(1.0, scale)
    for i, column in enumerate(got.columns):
        want = expected.iloc[:, i]
        if want.dtype.kind not in "fc":
            assert [None if pd.isna(v) else v for v in column.values] == [None if pd.isna(v) else v for v in want]
            continue
        np.testing.assert_allclose(np.asarray(column.values, np.float64), want.to_numpy(np.float64), rtol=RTOL,
                                   atol=ATOL if column.group == "model-input" else derived, err_msg=_flat(column))


def _scale(collections, name):  # noqa: F811
    from gordo_tpu_torch import serializer

    scaler = getattr(serializer.load(os.path.join(collections[1], name), device="cpu"), "scaler", None)
    return float(np.max(scaler.scale_)) if scaler is not None else 1.0


def test_discovery_matches_jax(apps):
    jax_client, client = clients(apps)
    assert client.get_revisions() == jax_client.get_revisions()
    assert client.get_machine_names() == jax_client.get_machine_names() == NAMES
    for name in NAMES:
        expected, got = jax_client.machine_metadata(name), client.machine_metadata(name)
        expected.pop("checksum"), got.pop("checksum")
        assert got == expected
    assert client.get_metadata() == jax_client.get_metadata()
    assert [m.name for m in client.get_available_machines(["machine-2"])] == ["machine-2"]
    for c in (client, jax_client):
        with pytest.raises(Exception, match="not deployed") as info:
            c.get_available_machines(["not-deployed"])
        assert type(info.value).__name__ == "NotFound"


@pytest.mark.parametrize("wire", ["json", "parquet", "arrow"])
@pytest.mark.parametrize("batch_size", [100000, 7], ids=["whole", "batches"])
def test_predict_matches_jax(apps, collections, wire, batch_size):  # noqa: F811
    options = {"use_parquet": wire == "parquet", "use_arrow": wire == "arrow", "batch_size": batch_size}
    jax_client, client = clients(apps, **options)
    expected = {r.name: r for r in jax_client.predict(START, END, targets=["machine-1", "machine-2"])}
    got = {r.name: r for r in client.predict(START, END, targets=["machine-1", "machine-2"])}
    assert sorted(got) == sorted(expected) == ["machine-1", "machine-2"]
    for name, result in got.items():
        assert result.error_messages == expected[name].error_messages == []
        same_predictions(expected[name].predictions, result.predictions, _scale(collections, name))
        assert len(result.predictions.index) == 37


def test_predict_is_the_same_in_batches(apps):
    _, whole = clients(apps)
    _, batched = clients(apps, batch_size=7)
    a = whole.predict(START, END, targets=["machine-2"])[0].predictions
    b = batched.predict(START, END, targets=["machine-2"])[0].predictions
    assert a.index == b.index
    for x, y in zip(a.columns, b.columns):
        assert (x.group, x.sub) == (y.group, y.sub)
        if np.asarray(x.values).dtype.kind == "f":  # the forward of 7 rows sums in another order than of 37
            np.testing.assert_allclose(np.asarray(y.values), np.asarray(x.values), rtol=RTOL, atol=ATOL)
        else:
            assert list(x.values) == list(y.values)


def test_a_data_fetch_failure_is_recorded_per_machine(apps):
    """A naive window fails the dataset: each machine records it, as the
    JAX client does."""
    jax_client, client = clients(apps)
    expected = jax_client.predict("2020-01-02 00:00:00", "2020-01-02 06:00:00")
    got = client.predict("2020-01-02 00:00:00", "2020-01-02 06:00:00")
    assert [r.name for r in got] == [r.name for r in expected] == MACHINES
    for result, jax_result in zip(got, expected):
        assert result.predictions is None and jax_result.predictions is None
        assert len(result.error_messages) == 1 and "Failed to fetch data" in result.error_messages[0]


@pytest.mark.parametrize("full", [False, True], ids=["lean", "full"])
def test_fleet_anomaly_scores_match_jax(apps, collections, full):  # noqa: F811
    jax_client, client = clients(apps, batch_size=20)
    expected = jax_client.fleet_anomaly_scores(START, END, full=full)
    got = client.fleet_anomaly_scores(START, END, full=full)
    assert list(got) == list(expected) == ["machine-1", "machine-2"]
    for name, result in got.items():
        assert result.error_messages == expected[name].error_messages == []
        same_predictions(expected[name].predictions, result.predictions, _scale(collections, name))
    labels = [_flat(c) for c in got["machine-1"].predictions.columns]
    if not full:
        assert labels == ["0", "1", "2", "3", "total-anomaly-unscaled"]
    assert any(label.startswith("anomaly-confidence") for label in labels) == full


def test_revision_pinning_matches_jax(apps):
    jax_client, client = clients(apps, revision=REVISION_2)
    assert client.get_machine_names() == jax_client.get_machine_names() == ["machine-2", "machine-3"]
    assert client.machine_metadata("machine-2")["revision"] == REVISION_2
    jax_gone, gone = clients(apps, revision="123456")
    for c in (jax_gone, gone):
        with pytest.raises(Exception) as info:
            c.get_machine_names()
        assert type(info.value).__name__ == "ResourceGone"
    jax_pinned, pinned = clients(apps, revision=REVISION)
    assert pinned.get_machine_names() == jax_pinned.get_machine_names() == NAMES


def test_download_model_matches_jax(apps):
    jax_client, client = clients(apps)
    expected, got = jax_client.download_model(["machine-1"]), client.download_model(["machine-1"])
    assert list(got) == list(expected) == ["machine-1"]
    X = np.random.RandomState(3).rand(9, 4)
    np.testing.assert_allclose(got["machine-1"].predict(X), np.asarray(expected["machine-1"].predict(X)),
                               rtol=RTOL, atol=ATOL)
    assert got["machine-1"].base_estimator.estimator.params_["out"]["W"].device.type == "cpu"


class _FakeResp:
    def __init__(self, status_code, payload=b"", headers=None):
        self.status_code = status_code
        self.content = payload
        self.headers = headers or {}
        self.text = payload.decode()

    def json(self):
        return json.loads(self.content)


@pytest.mark.parametrize("status,payload,headers", [
    (200, b"raw-bytes", {}), (200, b'{"ok": true}', {"content-type": "application/json"}),
    (422, b"", {}), (410, b"", {}), (404, b"", {}), (403, b"", {}), (500, b"oops", {}),
])
def test_handle_response_matches_jax(status, payload, headers):
    results = []
    for handle in (jax_handle_response, port_io._handle_response):
        try:
            results.append(("ok", handle(_FakeResp(status, payload, headers), "thing")))
        except Exception as exc:  # noqa: BLE001 - the typed exceptions are what is compared
            results.append((type(exc).__name__, str(exc)))
    assert results[0] == results[1]


# -- the forwarders ----------------------------------------------------------------


def test_disk_forwarder_writes_the_jax_sinks_file(apps, tmp_path):
    jax_client, client = clients(apps)
    jax_client.prediction_forwarder = JaxForwardPredictionsToDisk(str(tmp_path / "jax"))
    client.prediction_forwarder = ForwardPredictionsToDisk(str(tmp_path / "port"))
    for _ in range(2):  # the second call appends
        jax_client.predict(START, END, targets=["machine-1"])
        client.predict(START, END, targets=["machine-1"])
    expected = pd.read_parquet(tmp_path / "jax" / "machine-1.parquet")
    got = pd.read_parquet(tmp_path / "port" / "machine-1.parquet")
    assert list(got.columns) == [_label(c) for c in expected.columns]
    assert len(got) == len(expected) == 2 * 37  # appended, not sorted
    assert list(got.index.to_pydatetime()) == list(expected.index.to_pydatetime())
    numeric = [c for c in got.columns if got[c].dtype.kind == "f"]
    np.testing.assert_allclose(got[numeric].to_numpy(), expected[numeric].to_numpy(np.float64), rtol=1e-4,
                               atol=1e-4)


class _InfluxStub(BaseHTTPRequestHandler):
    """Records each POST's path, query, headers and body; answers 204."""

    records = []

    def do_POST(self):
        body = self.rfile.read(int(self.headers.get("Content-Length", 0)))
        split = urlsplit(self.path)
        self.records.append((split.path, parse_qs(split.query), dict(self.headers), body.decode()))
        self.send_response(204)
        self.end_headers()

    def log_message(self, *args):
        pass


def test_influx_forwarder_posts_line_protocol(apps):
    _InfluxStub.records = []
    server = ThreadingHTTPServer(("127.0.0.1", 0), _InfluxStub)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        forwarder = ForwardPredictionsIntoInflux(f"user:pw@127.0.0.1:{server.server_port}/preds",
                                                 destination_influx_api_key="k-1",
                                                 destination_influx_recreate=True)
        _, client = clients(apps)
        client.prediction_forwarder = forwarder
        table = client.predict(START, END, targets=["machine-1"])[0].predictions
    finally:
        server.shutdown()
        server.server_close()
    (drop, create, write) = _InfluxStub.records
    assert (drop[0], drop[1]["q"]) == ("/query", ['DROP DATABASE "preds"'])
    assert (create[0], create[1]["q"]) == ("/query", ['CREATE DATABASE "preds"'])
    path, params, headers, body = write
    assert (path, params) == ("/write", {"db": ["preds"], "precision": ["n"]})
    assert headers["Ocp-Apim-Subscription-Key"] == "k-1" and headers["Authorization"].startswith("Basic ")
    lines = body.split("\n")
    assert len(lines) == len(table.index) == 37
    columns = {_flat(c): np.asarray(c.values) for c in table.columns}
    for row, line in enumerate(lines):
        head, fields, stamp = line.split(" ")
        assert head == "predictions,machine=machine-1"
        assert int(stamp) == int(pd.Timestamp(table.index[row]).value)
        parsed = dict(field.split("=", 1) for field in fields.split(","))
        # the JSON answer's scalar groups, flattened
        assert parsed["start|start"] == f'"{columns["start|start"][row]}"'
        value = columns["total-anomaly-scaled|total-anomaly-scaled"][row]
        assert float(parsed["total-anomaly-scaled|total-anomaly-scaled"]) == value
        assert len(parsed) == sum(1 for v in columns.values() if v[row] is not None and v[row] == v[row])


# -- the command group ---------------------------------------------------------------


@pytest.fixture
def served(apps):
    """Both apps on localhost sockets: ``(jax port, port's port)``."""
    from werkzeug.serving import make_server

    jax_app, port_app = apps
    servers = [make_server("127.0.0.1", 0, jax_app, threaded=True), make_wsgi_server(port_app, "127.0.0.1", 0)]
    threads = [threading.Thread(target=s.serve_forever, daemon=True) for s in servers]
    for thread in threads:
        thread.start()
    yield [s.server_port for s in servers]
    for server in servers:
        server.shutdown()
        server.server_close()


def _group(port):
    return ["--project", PROJECT, "--host", "127.0.0.1", "--port", str(port), "--scheme", "http"]


def test_client_commands_match_jax(served, tmp_path, capsys):
    from click.testing import CliRunner

    from gordo_tpu.client.cli import client_cli

    jax_port, port = served
    runner = CliRunner()
    jax_meta = runner.invoke(client_cli, [*_group(jax_port), "metadata", "--target", "machine-2"])
    assert jax_meta.exit_code == 0, jax_meta.output
    assert main(["client", *_group(port), "metadata", "--target", "machine-2"]) == 0
    assert json.loads(capsys.readouterr().out) == json.loads(jax_meta.output)

    (tmp_path / "models").mkdir()
    assert main(["client", *_group(port), "--device", "cpu", "download-model", str(tmp_path / "models"),
                 "--target", "machine-1"]) == 0
    assert capsys.readouterr().out.strip() == f"Saved machine-1 to {tmp_path / 'models'}/machine-1"
    assert os.path.isfile(tmp_path / "models" / "machine-1" / "model.pkl")

    for wire in (["--parquet"], ["--no-parquet"]):
        options = ["predict", START, END, "--target", "machine-1", "--target", "machine-3", *wire, "--batch-size",
                   "10", "--destination", str(tmp_path / "sink")]
        jax_result = runner.invoke(client_cli, [*_group(jax_port), *options])
        code = main(["client", *_group(port), *options])
        assert code == jax_result.exit_code == 0
        assert capsys.readouterr().out == jax_result.output == "machine-1: 37 rows, 0 errors\n" * 2
    assert sorted(os.listdir(tmp_path / "sink")) == ["machine-1.parquet"]
    fleet = ["predict", START, END, "--fleet"]
    jax_result = runner.invoke(client_cli, [*_group(jax_port), *fleet])
    assert main(["client", *_group(port), *fleet]) == jax_result.exit_code == 0
    assert sorted(capsys.readouterr().out.splitlines()) == sorted(jax_result.output.splitlines())


def test_line_protocol_skips_nulls_and_escapes_keys():
    from datetime import datetime, timezone

    from gordo_tpu_torch.client.forwarders import line_protocol
    from gordo_tpu_torch.server.wire import WireColumn, WireTable

    index = [datetime(2020, 1, 1, tzinfo=timezone.utc), datetime(2020, 1, 1, 0, 10, tzinfo=timezone.utc)]
    table = WireTable(index, [
        WireColumn("model-output", "tag a", np.array([1.5, np.nan])),
        WireColumn("end", "", [None, "2020-01-01T00:20:00+00:00"]),
        WireColumn("count", "", np.array([3, 4])),
    ])
    assert line_protocol(table, "predictions", {"machine": "m 1"}) == [
        "predictions,machine=m\\ 1 model-output|tag\\ a=1.5,count=3i 1577836800000000000",
        'predictions,machine=m\\ 1 end="2020-01-01T00:20:00+00:00",count=4i 1577837400000000000',
    ]
