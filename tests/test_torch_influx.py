"""The port's InfluxDB reads (``gordo_tpu_torch/dataset/influx.py`` and
``data_provider.InfluxDataProvider``, InfluxDB 1.x ``GET /query`` over
``urllib``) against the JAX provider over its in-memory
``DataFrameClient`` (``tests/dataset/test_influx_provider.py``), on the CPU.

A stdlib ``http.server`` on 127.0.0.1 answers the port's queries as
InfluxDB 1.x does (``results[0].series``, ``epoch=ns`` stamps), reading
the same fake client the JAX provider queries directly; it records each
query's text, parameters and headers. Held:

- the InfluxQL both providers write, byte for byte, in the sensor layout
  and the field layout (``fields_are_tags``), with ``where_tags``, and with
  quotes and backslashes to escape in tag names and values;
- the series each provider reads: the same ns stamps and values, NaN for
  a null;
- ``db``, ``epoch=ns``, basic auth from the URI and the API key header;
- an Influx ``error``, an HTTP error, a host that does not answer and an
  empty result raise ``ValueError`` naming the measurement (the first
  three without the password), as the JAX provider raises for no data;
- the JAX dataset and the port's give the same ``X`` and index over it;
- ``examples/config-influx-callbacks.yaml``, its URI pointed at the local
  server, builds its machine on the port on the CPU (epochs cut from 30
  to 2, the month's window cut to four days of 10-minute rows).
"""

import base64
import json
import socket
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from urllib.parse import parse_qs, urlsplit

import numpy as np
import pandas as pd
import pytest

from gordo_tpu.dataset.data_provider import InfluxDataProvider as JaxInfluxDataProvider
from gordo_tpu.dataset.datasets import GordoBaseDataset as JaxDataset
from gordo_tpu.dataset.sensor_tag import SensorTag as JaxSensorTag
from gordo_tpu_torch.dataset import GordoBaseDataset, InfluxDataProvider, SensorTag
from gordo_tpu_torch.dataset.influx import InfluxQueryClient, parse_uri
from gordo_tpu_torch.dataset.series import datetime_ns, parse_datetime
from tests.dataset.test_influx_provider import FakeDataFrameClient

REPO = Path(__file__).resolve().parents[1]
START, END = "2020-01-01T00:00:00+00:00", "2020-01-05T00:00:00+00:00"


class InfluxServer:
    """InfluxDB 1.x's ``/query`` over a ``FakeDataFrameClient``: the
    answers, the query texts and the headers it saw; ``answer`` replaces
    the next answers with ``(status, JSON document)``."""

    def __init__(self, fake):
        self.fake, self.queries, self.headers, self.params, self.answer = fake, [], [], [], None
        server = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):
                url = urlsplit(self.path)
                params = {k: v[0] for k, v in parse_qs(url.query).items()}
                server.queries.append(params.get("q"))
                server.params.append(params)
                server.headers.append(dict(self.headers))
                status, document = server.answer or (200, server.respond(params.get("q")))
                body = json.dumps(document).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):
                pass

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.port = self.httpd.server_port
        self.thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self.thread.start()

    def respond(self, q):
        result = self.fake.query(q)
        series = []
        for measurement, frame in result.items():
            field = frame.columns[0]
            values = [[int(ts), None if np.isnan(v) else float(v)]
                      for ts, v in zip(frame.index.as_unit("ns").asi8, frame[field].to_numpy())]
            series.append({"name": measurement, "columns": ["time", field], "values": values})
        return {"results": [{"statement_id": 0, **({"series": series} if series else {})}]}

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join(timeout=10)


class RecordingClient(FakeDataFrameClient):
    """The JAX side's client: the fake, recording each query's text."""

    def __init__(self):
        super().__init__()
        self.queries = []

    def query(self, q):
        self.queries.append(q)
        return super().query(q)


def _seed(client, tags, n=4 * 144, nan_at=()):
    index = pd.date_range("2019-12-31T12:00:00", periods=n, freq="10min", tz="UTC")
    rng = np.random.RandomState(7)
    for i, tag in enumerate(tags):
        values = 20 + 5 * np.sin(np.linspace(0, 12, n) + i) + rng.standard_normal(n)
        values[list(nan_at)] = np.nan
        client.write_points(pd.DataFrame({"Value": values}, index=index), measurement="sensors",
                            tags={"tag": tag, "site": "north"})
    fields = pd.DataFrame({tag: rng.standard_normal(n) for tag in tags}, index=index)
    client.write_points(fields, measurement="predictions", tags={"machine": "m-1"})
    return index


@pytest.fixture
def influx():
    fake = RecordingClient()
    server = InfluxServer(fake)
    yield fake, server
    server.close()


def _uri(server, password="s3cr3t"):
    return f"reader:{password}@127.0.0.1:{server.port}/sensordb"


LAYOUTS = {
    "sensor": {"measurement": "sensors"},
    "sensor-where": {"measurement": "sensors", "where_tags": {"site": "north"}},
    "field": {"measurement": "predictions", "fields_are_tags": True, "where_tags": {"machine": "m-1"}},
}


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_port_reads_what_jax_reads(influx, layout):
    fake, server = influx
    tags = ["t1", "tag b", "ctag-07"]
    _seed(fake, tags, nan_at=(5, 6))
    jax = JaxInfluxDataProvider(client=fake, **LAYOUTS[layout])
    port = InfluxDataProvider(uri=_uri(server), **LAYOUTS[layout])
    start, end = parse_datetime("2020-01-01T00:00:00+00:00"), parse_datetime("2020-01-02T06:30:00+00:00")
    want = list(jax.load_series(pd.Timestamp(start), pd.Timestamp(end), [JaxSensorTag(t) for t in tags]))
    jax_queries = list(fake.queries)
    got = list(port.load_series(start, end, [SensorTag(t) for t in tags]))
    assert server.queries == jax_queries and len(jax_queries) == len(tags)
    for w, g in zip(want, got):
        assert g.name == w.name
        np.testing.assert_array_equal(g.stamps, w.index.as_unit("ns").asi8)
        np.testing.assert_array_equal(g.values, w.to_numpy(np.float64))
        assert len(g) == 6 * 24 + 6 * 6 + 3


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_influxql_byte_for_byte(influx, layout):
    """Both providers' query text for the same tags and window, escaping
    included (``'`` and ``\\`` in a tag name and a ``where_tags`` value);
    where a tag name is the field's identifier, the port escapes its
    backslash (fault 5)."""
    fake, server = influx
    config = dict(LAYOUTS[layout])
    if "where_tags" in config:
        config["where_tags"] = {**config["where_tags"], "owner": "o'brien\\lab"}
    tags = ["t1", "it's", "back\\slash'"]
    start, end = parse_datetime("2020-01-01T00:00:00+00:00"), parse_datetime("2020-01-03T00:00:00+00:00")
    jax = JaxInfluxDataProvider(client=fake, **config)
    port = InfluxDataProvider(client=fake, **config)
    for tag in tags:
        with pytest.raises(ValueError, match="No data"):
            list(jax.load_series(pd.Timestamp(start), pd.Timestamp(end), [JaxSensorTag(tag)]))
        expected = fake.queries[-1]
        if config.get("fields_are_tags") and "\\" in tag:
            # fault 5, fixed on the port's side: the field's identifier escapes its backslash
            expected = expected.replace(f'"{tag}"', '"' + tag.replace("\\", "\\\\") + '"', 1)
        with pytest.raises(ValueError, match="No data"):
            list(port.load_series(start, end, [SensorTag(tag)]))
        assert fake.queries[-1] == expected
        assert port.query_text(SensorTag(tag), datetime_ns(start), datetime_ns(end)) == expected
    assert "\\\\" in expected and "\\'" in expected


def test_request_parameters_auth_and_api_key(influx):
    fake, server = influx
    _seed(fake, ["t1"])
    port = InfluxDataProvider(measurement="sensors", uri=_uri(server), api_key="k-123", api_key_header="X-Api-Key")
    list(port.load_series(parse_datetime(START), parse_datetime(END), [SensorTag("t1")]))
    params, headers = server.params[-1], server.headers[-1]
    assert params["db"] == "sensordb" and params["epoch"] == "ns"
    assert headers["X-Api-Key"] == "k-123"
    assert base64.b64decode(headers["Authorization"].split()[1]).decode() == "reader:s3cr3t"


def test_parse_uri_splits_as_jax():
    assert parse_uri("gordo:secret@influxdb:8086/sensordb") == ("gordo", "secret", "influxdb", 8086, "sensordb")
    client = InfluxQueryClient.from_uri("u:p@h:1234/db")
    assert (client.base_url, client.database, client.username) == ("http://h:1234/query", "db", "u")


@pytest.mark.parametrize("case", ["influx-error", "http-error", "empty", "unreachable"])
def test_failures_raise_value_error(influx, case):
    fake, server = influx
    _seed(fake, ["t1"])
    uri = _uri(server)
    if case == "influx-error":
        server.answer = (200, {"results": [{"statement_id": 0, "error": "database not found: sensordb"}]})
    elif case == "http-error":
        server.answer = (401, {"error": "authorization failed"})
    elif case == "empty":
        server.answer = (200, {"results": [{"statement_id": 0}]})
    else:  # a port nothing listens on
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            closed = sock.getsockname()[1]
        uri = f"reader:s3cr3t@127.0.0.1:{closed}/sensordb"
    port = InfluxDataProvider(measurement="sensors", uri=uri)
    with pytest.raises(ValueError) as info:
        list(port.load_series(parse_datetime(START), parse_datetime(END), [SensorTag("t1")]))
    message = str(info.value)
    assert "sensors" in message and "s3cr3t" not in message
    expected = {"influx-error": "database not found", "http-error": "HTTP 401", "empty": "No data for tag 't1'",
                "unreachable": "no answer"}[case]
    assert expected in message


def test_dataset_over_influx_matches_jax(influx):
    fake, server = influx
    tags = ["plant-tag-1", "plant-tag-2", "plant-tag-3"]
    _seed(fake, tags, n=6 * 144)
    config = {"train_start_date": "2020-01-01T00:00:00+00:00", "train_end_date": "2020-01-05T00:00:00+00:00",
              "tag_list": tags, "resolution": "10min"}
    jax_dataset = JaxDataset.from_dict({**config, "data_provider": JaxInfluxDataProvider(measurement="sensors",
                                                                                         client=fake)})
    dataset = GordoBaseDataset.from_dict({**config, "data_provider": {
        "type": "InfluxDataProvider", "measurement": "sensors", "uri": _uri(server)}})
    X, y = jax_dataset.get_data()
    PX, Py, index = dataset.get_data()
    np.testing.assert_array_equal([datetime_ns(i) for i in index], X.index.as_unit("ns").asi8)
    np.testing.assert_allclose(PX, X.to_numpy(np.float64), rtol=1e-12)
    np.testing.assert_allclose(Py, y.to_numpy(np.float64), rtol=1e-12)
    assert dataset.get_metadata()["row_count"] == jax_dataset.get_metadata()["row_count"] == len(X)


def test_influx_callbacks_example_builds_on_the_port(influx, tmp_path):
    """``examples/config-influx-callbacks.yaml`` against the local server:
    its machine (three tags, host-loop callbacks, so ``ModelBuilder``) built
    on the CPU. Cuts: epochs 30 to 2; the window 2020-01-01..02-01 to
    2020-01-01..01-05 (576 rows)."""
    from gordo_tpu_torch.cli import cli

    fake, server = influx
    _seed(fake, ["plant-tag-1", "plant-tag-2", "plant-tag-3"], n=5 * 144)
    text = (REPO / "examples" / "config-influx-callbacks.yaml").read_text()
    text = (text.replace("@influxdb:8086/", f"@127.0.0.1:{server.port}/").replace("epochs: 30", "epochs: 2")
            .replace("train_end_date: 2020-02-01T00:00:00+00:00", "train_end_date: 2020-01-05T00:00:00+00:00"))
    assert f"127.0.0.1:{server.port}" in text and "epochs: 2" in text and "2020-01-05T00:00:00" in text
    config_path = tmp_path / "config.yaml"
    config_path.write_text(text)
    shard = tmp_path / "shard.json"
    assert cli.main(["normalize", str(config_path), "proj", "--output", str(shard)]) == 0
    out = tmp_path / "out" / "1"
    code, builder = cli.build_fleet(str(shard), str(out), "cpu")
    assert code == 0 and not builder.build_errors
    with open(out / "plant-b-compressor" / "metadata.json") as f:
        metadata = json.load(f)
    assert metadata["metadata"]["build_metadata"]["dataset"]["dataset_meta"]["row_count"] == 576
    assert len(server.queries) >= 3 and all('FROM "sensors"' in q for q in server.queries)
    assert base64.b64decode(server.headers[-1]["Authorization"].split()[1]).decode() == "gordo:secret"


def _influxql_tokens(query):
    """The query's tokens: ``("ident", name)`` for a double-quoted
    identifier and ``("str", text)`` for a single-quoted literal, each
    with InfluxQL's backslash escapes undone, and ``("word", w)`` for the
    rest split on spaces."""
    tokens, i = [], 0
    while i < len(query):
        ch = query[i]
        if ch in "\"'":
            text, i = [], i + 1
            while query[i] != ch:
                if query[i] == "\\":
                    i += 1
                text.append(query[i])
                i += 1
            tokens.append(("ident" if ch == '"' else "str", "".join(text)))
            i += 1
        elif ch == " ":
            i += 1
        else:
            end = query.find(" ", i)
            end = len(query) if end < 0 else end
            tokens.append(("word", query[i:end]))
            i = end
    return tokens


@pytest.mark.parametrize("config,tag", [
    ({"measurement": "m", "tag_key": "tag\" = 'x' OR \"tag"}, "T1"),
    ({"measurement": "m\" OR \"x", "fields_are_tags": True}, "ab\"c"),
    ({"measurement": "m\\", "where_tags": {"k\\\" OR \"j": "v"}}, "T\\1"),
], ids=["tag-key", "measurement-and-field", "backslashes"])
def test_hostile_identifiers_stay_one_identifier(config, tag):
    """``ROADMAP.md`` fault 5, fixed on the port's side: a name holding
    ``"`` or ``\\`` is escaped inside its quotes, so it reads back as one
    identifier, and no ``OR`` escapes the time window."""
    port = InfluxDataProvider(client=RecordingClient(), **config)
    tokens = _influxql_tokens(port.query_text(SensorTag(tag), 0, 10))
    field = tag if config.get("fields_are_tags") else "Value"
    expected = [("word", "SELECT"), ("ident", field), ("word", "FROM"), ("ident", config["measurement"]),
                ("word", "WHERE"), ("word", "time"), ("word", ">="), ("word", "0"), ("word", "AND"),
                ("word", "time"), ("word", "<"), ("word", "10")]
    if not config.get("fields_are_tags"):
        expected += [("word", "AND"), ("ident", config.get("tag_key", "tag")), ("word", "="), ("str", tag)]
    for key, value in config.get("where_tags", {}).items():
        expected += [("word", "AND"), ("ident", key), ("word", "="), ("str", value)]
    assert tokens == expected


def test_ordinary_names_stay_the_jax_query():
    """The JAX provider's query of ordinary names, pinned: the escaping
    changes no byte of it."""
    fake = RecordingClient()
    config = {"measurement": "sensors", "where_tags": {"site": "north"}}
    start, end = parse_datetime("2020-01-01T00:00:00+00:00"), parse_datetime("2020-01-02T00:00:00+00:00")
    with pytest.raises(ValueError, match="No data"):
        list(JaxInfluxDataProvider(client=fake, **config).load_series(
            pd.Timestamp(start), pd.Timestamp(end), [JaxSensorTag("ctag-07")]))
    expected = ('SELECT "Value" FROM "sensors" WHERE time >= 1577836800000000000 AND time < 1577923200000000000 '
                'AND "tag" = \'ctag-07\' AND "site" = \'north\'')
    assert fake.queries[-1] == expected
    port = InfluxDataProvider(client=fake, **config)
    assert port.query_text(SensorTag("ctag-07"), datetime_ns(start), datetime_ns(end)) == expected
