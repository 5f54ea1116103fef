"""What the port's server records about its own traffic, held to the JAX
server on the CPU: W3C trace context, each response's ``Server-Timing``
stages, the spans exported to ``serve_trace.jsonl`` (requests, the
engine's batches linked to their riders, the stream's ingests and
flushes), and the asynchronous trace sink.

Two detectors are built once with the JAX package's ``local_build`` and
cross into the port through ``from_state`` (as ``tests/test_torch_serving.py``
does); both apps serve them on the CPU, the JAX one through XLA as its
own tests run it. Each case resets the JAX package's process-wide state
around itself (the serve recorder, the health ledgers, the engine, the
stream plane and its breakers) and the port's serve recorder.

Spans differ in ids and times, so traces are compared by name, parent
name, kind, status code, attribute keys and the attribute values that are
not times (route, status code, model name, revision).
"""

import json
import os
import threading

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from werkzeug.test import Client

from gordo_tpu import serve as jax_serve
from gordo_tpu import serializer as jax_serializer
from gordo_tpu.builder import local_build
from gordo_tpu.server import app as jax_app_module
from gordo_tpu.server import build_app as jax_build_app
from gordo_tpu.server.fleet_store import STORE as JAX_STORE
from gordo_tpu.stream import reset_plane as jax_reset_plane
from gordo_tpu.telemetry import aggregate as jax_aggregate
from gordo_tpu.telemetry import fleet_health as jax_fleet_health
from gordo_tpu.telemetry import recorder as jax_recorder
from gordo_tpu.telemetry import serving as jax_serving
from gordo_tpu.telemetry import tracing as jax_tracing
from gordo_tpu_torch import serializer
from gordo_tpu_torch.models.anomaly.diff import DiffBasedAnomalyDetector
from gordo_tpu_torch.server import build_app
from gordo_tpu_torch.serve.engine import ServeConfig
from gordo_tpu_torch.telemetry import SpanRecorder, recorder, serving, tracing
from gordo_tpu_torch.telemetry import fleet_health
from gordo_tpu_torch.telemetry.fleet_health import FLEET_HEALTH_FILE, FleetHealthLedger

TRACE = "0af7651916cd43dd8448eb211c80319c"
SPAN = "b7ad6b7169203331"
NAMES = ("machine-1", "machine-2")
PROJECT = "test-project"
REVISION = "1602324482000"
TAGS = {"machine-1": ["tag-1", "tag-2", "tag-3", "tag-4"], "machine-2": ["tag-5", "tag-6", "tag-7", "tag-8"]}
_MACHINE = """
  - name: {name}
    dataset:
      type: RandomDataset
      train_start_date: "2020-01-01T00:00:00+00:00"
      train_end_date: "2020-01-05T00:00:00+00:00"
      tag_list: [{tags}]
    model:
      gordo_tpu.models.anomaly.diff.DiffBasedAnomalyDetector:
        base_estimator:
          sklearn.pipeline.Pipeline:
            steps:
              - sklearn.preprocessing.MinMaxScaler
              - gordo_tpu.models.JaxAutoEncoder:
                  kind: feedforward_hourglass
                  epochs: 1
"""
CONFIG = "machines:" + "".join(_MACHINE.format(name=n, tags=", ".join(TAGS[n])) for n in NAMES)


def port_detector(model) -> DiffBasedAnomalyDetector:
    """A JAX-built detector as the port's, through its plain-state constructor."""
    pipeline = model.base_estimator
    estimator = pipeline.steps[-1][1]

    def scaler(step):
        return {"scale_": np.asarray(step.scale_), "min_": np.asarray(step.min_)}

    return DiffBasedAnomalyDetector.from_state({
        "spec": estimator.spec_.to_dict(),
        "params": {k: {n: np.asarray(v) for n, v in layer.items()} for k, layer in estimator.params_.items()},
        "pipeline": [scaler(step) for _, step in pipeline.steps[:-1]],
        "scaler": scaler(model.scaler),
        "feature_thresholds": np.asarray(model.feature_thresholds_.values),
        "aggregate_threshold": model.aggregate_threshold_,
        "require_thresholds": model.require_thresholds,
        "window": model.window,
        "smoothing_method": model.smoothing_method,
    }, device="cpu")


def _frame(tags, rows, seed, start_minute=0):
    """``rows`` 10-minute rows of ``tags`` from ``start_minute`` on, one
    reading missing, the keys shuffled."""
    rng = np.random.RandomState(seed)
    index = [f"2020-03-01T{(start_minute + 10 * i) // 60:02d}:{(start_minute + 10 * i) % 60:02d}:00+00:00"
             for i in range(rows)]
    values = rng.rand(len(tags), rows) * 2 - 0.5
    values[0, min(3, rows - 1)] = np.nan
    order = rng.permutation(rows)
    return {tag: {index[i]: (None if np.isnan(values[t, i]) else float(values[t, i])) for i in order}
            for t, tag in enumerate(tags)}


@pytest.fixture(scope="module")
def collections(tmp_path_factory):
    """``(jax_dir, port_dir)``: the same two detectors in both packages."""
    root = tmp_path_factory.mktemp("torch-tracing")
    jax_dir, port_dir = root / "jax" / REVISION, root / "port" / REVISION
    for model, machine in local_build(CONFIG, project_name=PROJECT):
        jax_serializer.dump(model, str(jax_dir / machine.name), metadata=machine.to_dict())
        with open(jax_dir / machine.name / "metadata.json") as f:
            metadata = json.load(f)
        serializer.dump(port_detector(model), str(port_dir / machine.name), metadata=metadata)
    return str(jax_dir), str(port_dir)


def _reset_globals():
    jax_serving.reset_serve_recorder()
    serving.reset_serve_recorder()
    jax_fleet_health.reset_ledgers()
    fleet_health.reset_serving_ledgers()
    jax_serve.install_engine(None)
    jax_reset_plane()
    jax_serve.reset_stream_breakers()


@pytest.fixture
def traced(collections, tmp_path, monkeypatch):
    """Both apps exporting every request, each to its own telemetry dir:
    ``(jax_client, port_client, jax_trace_dir, port_trace_dir)``. The
    JAX app reads its environment on every request, so its telemetry dir
    is swapped in around each of its calls (:func:`call`)."""
    jax_dir, port_dir = collections
    for name in ("GORDO_TPU_BATCHING", "GORDO_TPU_TELEMETRY", "GORDO_TPU_WORKER_SINKS", "PROMETHEUS_MULTIPROC_DIR",
                 "GORDO_TPU_PROFILE_SAMPLE_RATE", "GORDO_TPU_PROFILE_DIR"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("GORDO_TPU_TRACE_SAMPLE_RATE", "1.0")
    monkeypatch.setenv("GORDO_TPU_STREAM_WINDOW_ROWS", "8")
    monkeypatch.setenv("GORDO_TPU_SERVE_WARMUP", "0")
    monkeypatch.setenv("MODEL_COLLECTION_DIR", jax_dir)
    _reset_globals()
    JAX_STORE.invalidate(jax_dir)
    dirs = str(tmp_path / "jax-telemetry"), str(tmp_path / "port-telemetry")
    yield Client(jax_build_app(config={"EXPECTED_MODELS": []})), build_app(port_dir, device="cpu"), dirs
    _reset_globals()
    for directory in collections:
        path = os.path.join(directory, FLEET_HEALTH_FILE)
        if os.path.exists(path):
            os.remove(path)


def call(client_or_app, trace_dir, method, path, body=None, headers=None):
    """One request with ``GORDO_TPU_TELEMETRY_DIR`` pointing at
    ``trace_dir``: ``(status, headers, body bytes)``."""
    previous = os.environ.get("GORDO_TPU_TELEMETRY_DIR")
    os.environ["GORDO_TPU_TELEMETRY_DIR"] = trace_dir
    try:
        client = client_or_app if isinstance(client_or_app, Client) else Client(client_or_app)
        data = None if body is None else json.dumps(body)
        response = client.open(path, method=method, data=data, content_type="application/json", headers=headers)
        return response.status_code, response.headers, response.get_data()
    finally:
        if previous is None:
            os.environ.pop("GORDO_TPU_TELEMETRY_DIR", None)
        else:
            os.environ["GORDO_TPU_TELEMETRY_DIR"] = previous


def read_trace(trace_dir, jax=False):
    """The spans in ``trace_dir``'s serving trace, after a flush."""
    module = jax_serving if jax else serving
    previous = os.environ.get("GORDO_TPU_TELEMETRY_DIR")
    os.environ["GORDO_TPU_TELEMETRY_DIR"] = trace_dir
    try:
        module.serve_recorder().flush()
    finally:
        if previous is None:
            os.environ.pop("GORDO_TPU_TELEMETRY_DIR", None)
        else:
            os.environ["GORDO_TPU_TELEMETRY_DIR"] = previous
    path = os.path.join(trace_dir, serving.SERVE_TRACE_FILE)
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(line) for line in f]


def stage_names(headers):
    return [entry.split(";")[0] for entry in headers["Server-Timing"].split(", ")]


def shape(spans):
    """Each span as (name, kind, parent's name, status, attribute keys,
    the request span's non-time attribute values, link count), in order."""
    names = {s["context"]["span_id"]: s["name"] for s in spans}
    out = []
    for s in spans:
        parent = s["parent_id"]
        values = {k: v for k, v in s["attributes"].items() if k.startswith("http.") or k in ("gordo_name", "revision")}
        out.append((s["name"], s["kind"], names.get(parent, parent and "remote"), s["status"]["status_code"],
                    sorted(s["attributes"]), values, len(s.get("links", []))))
    return out


def url(rest):
    return f"/gordo/v0/{PROJECT}/{rest}"


def requests_of(route):
    X, y = _frame(TAGS["machine-1"], 30, seed=1), _frame(TAGS["machine-1"], 30, seed=2)
    return {
        "anomaly": ("POST", url("machine-1/anomaly/prediction"), {"X": X, "y": y}),
        "prediction": ("POST", url("machine-1/prediction"), {"X": X}),
        "fleet": ("POST", url("prediction/fleet"), {"X": {n: _frame(TAGS[n], 30, seed=3) for n in NAMES}}),
        "stream": ("POST", url("stream/s1/ingest"), {"X": {n: _frame(TAGS[n], 30, seed=4) for n in NAMES}}),
        "metadata": ("GET", url("machine-1/metadata"), None),
    }[route]


# -- W3C trace context -----------------------------------------------------------

HEADERS = [
    f"00-{TRACE}-{SPAN}-01",
    f"00-{TRACE}-{SPAN}-00",
    f"00-{TRACE}-{SPAN}-03",
    f"  00-{TRACE.upper()}-{SPAN}-01  ",
    f"00-{'0' * 32}-{SPAN}-01",
    f"00-{TRACE}-{'0' * 16}-01",
    f"01-{TRACE}-{SPAN}-01",
    f"00-{TRACE[:-1]}-{SPAN}-01",
    f"00-{TRACE}-{SPAN}",
    f"00-{TRACE}-{SPAN}-zz",
    "not-a-traceparent",
    "",
    None,
]


@pytest.mark.parametrize("header", HEADERS, ids=range(len(HEADERS)))
def test_parse_traceparent_matches_jax(header):
    assert tracing.parse_traceparent(header) == jax_tracing.parse_traceparent(header)


@settings(max_examples=200, deadline=None)
@given(st.one_of(st.text(max_size=70), st.builds(lambda t, s, f: f"00-{t}-{s}-{f}",
                                                  st.text("0123456789abcdefABCDEF", min_size=31, max_size=33),
                                                  st.text("0123456789abcdef", min_size=15, max_size=17),
                                                  st.text("0123456789abcdefg", min_size=1, max_size=3))))
def test_parse_traceparent_matches_jax_on_any_text(header):
    assert tracing.parse_traceparent(header) == jax_tracing.parse_traceparent(header)


@pytest.mark.parametrize("sampled", [True, False])
def test_format_traceparent_matches_jax(sampled):
    assert tracing.format_traceparent(TRACE, SPAN, sampled) == jax_tracing.format_traceparent(TRACE, SPAN, sampled)
    context = tracing.new_trace_context()
    assert len(context.trace_id) == 32 and len(context.span_id) == 16
    assert tracing.parse_traceparent(tracing.format_traceparent(*context)) == context


def test_trace_id_stamps_log_records():
    tracing.install_trace_log_stamping()
    import logging

    token = tracing.bind(TRACE)
    try:
        record = logging.getLogRecordFactory()("x", logging.INFO, "f", 1, "msg", (), None)
    finally:
        tracing.unbind(token)
    assert record.trace_id == TRACE and f"trace_id={TRACE}" in record.msg
    assert tracing.TraceIdFilter().filter(record) and record.trace_id == "-"
    assert tracing.current_trace_id() == ""


def test_trace_id_stamping_keeps_a_wrapped_factorys_stamp(monkeypatch):
    """In a process that runs both packages, the JAX package's factory may
    lie beneath the port's: outside a port request the port keeps the
    ``trace_id`` it stamped."""
    import logging

    saved = logging.getLogRecordFactory()

    def other(*args, **kwargs):
        record = logging.LogRecord(*args, **kwargs)
        record.trace_id = "other"
        return record

    monkeypatch.setattr(tracing, "_factory_installed", False)
    logging.setLogRecordFactory(other)
    try:
        tracing.install_trace_log_stamping()
        make = logging.getLogRecordFactory()
        assert make("x", logging.INFO, "f", 1, "msg", (), None).trace_id == "other"
        token = tracing.bind(TRACE)
        try:
            record = make("x", logging.INFO, "f", 1, "msg", (), None)
        finally:
            tracing.unbind(token)
        assert record.trace_id == TRACE and record.msg == f"msg trace_id={TRACE}"
    finally:
        logging.setLogRecordFactory(saved)


# -- Server-Timing and the exported request spans --------------------------------


@pytest.mark.parametrize("route", ["anomaly", "prediction", "fleet", "stream", "metadata"])
def test_stage_names_and_spans_match_jax(traced, route):
    jax_client, port_app, (jax_dir, port_dir) = traced
    method, path, body = requests_of(route)
    jax_status, jax_headers, _ = call(jax_client, jax_dir, method, path, body)
    status, headers, _ = call(port_app, port_dir, method, path, body)
    assert status == jax_status == 200
    assert stage_names(headers) == stage_names(jax_headers)
    assert stage_names(headers)[-1] == "request_walltime_s"
    assert shape(read_trace(port_dir)) == shape(read_trace(jax_dir, jax=True))


@pytest.mark.parametrize("route", ["anomaly", "prediction"])
def test_engine_stage_names_and_batch_links_match_jax(traced, route, monkeypatch):
    """Two concurrent riders coalesce into one batch in each server: each
    rider's ``Server-Timing`` holds its share of the batch, and the
    ``serve_batch`` span links both request spans of the same trace file."""
    jax_client, _, (jax_dir, port_dir) = traced
    config = dict(max_size=2, max_delay_ms=20000.0, deadline_ms=40000.0, queue_depth=64, row_ladder=(32, 128))
    jax_engine = jax_serve.ServeEngine(jax_serve.ServeConfig(**config))
    jax_serve.install_engine(jax_engine)
    port_app = build_app(traced[1].store.collection_dir, device="cpu", serve_config=ServeConfig(**config))
    try:
        for client, trace_dir, jax in ((jax_client, jax_dir, True), (port_app, port_dir, False)):
            monkeypatch.setenv("GORDO_TPU_TELEMETRY_DIR", trace_dir)
            answers = {}

            def hit(name):
                X, y = _frame(TAGS[name], 30, seed=5), _frame(TAGS[name], 30, seed=6)
                target = client if isinstance(client, Client) else Client(client)
                path = url(f"{name}/{'anomaly/prediction' if route == 'anomaly' else 'prediction'}")
                response = target.post(path, data=json.dumps({"X": X, "y": y}), content_type="application/json")
                answers[name] = (response.status_code, response.headers)

            threads = [threading.Thread(target=hit, args=(name,)) for name in NAMES]
            for thread in threads:
                thread.start()
            for thread in threads:
                thread.join()
            spans = read_trace(trace_dir, jax=jax)
            answers["spans"] = spans
            if jax:
                jax_answers = answers
            else:
                port_answers = answers
        for name in NAMES:
            assert port_answers[name][0] == jax_answers[name][0] == 200
            stages = stage_names(port_answers[name][1])
            assert stages == stage_names(jax_answers[name][1])
            assert {"queue_wait", "batch_stack", "batch_device", "batch_scatter"} <= set(stages)
        for answers in (port_answers, jax_answers):
            spans = answers["spans"]
            batches = [s for s in spans if s["name"] == "serve_batch"]
            requests = {(s["context"]["trace_id"], s["context"]["span_id"]): s for s in spans if s["name"] == "request"}
            assert len(batches) == 1 and len(requests) == 2
            links = {(link["context"]["trace_id"], link["context"]["span_id"]): link for link in batches[0]["links"]}
            assert set(links) == set(requests)
            for key, link in links.items():
                assert link["attributes"]["name"] == requests[key]["attributes"]["gordo_name"]
                assert link["attributes"]["queue_wait_ms"] >= 0
        key = lambda item: (item[0], item[2], item[3])  # noqa: E731 - name, parent, status
        assert sorted(map(key, shape(port_answers["spans"]))) == sorted(map(key, shape(jax_answers["spans"])))
        port_batch = next(s for s in port_answers["spans"] if s["name"] == "serve_batch")
        jax_batch = next(s for s in jax_answers["spans"] if s["name"] == "serve_batch")
        assert sorted(port_batch["attributes"]) == sorted(jax_batch["attributes"])
        for attribute in ("coalesced", "padded_rows", "precision", "spec", "n_features", "size"):
            assert port_batch["attributes"][attribute] == jax_batch["attributes"][attribute], attribute
    finally:
        jax_serve.install_engine(None)
        jax_engine.shutdown(drain=True)
        port_app.shutdown()


def test_incoming_traceparent_continues_the_trace(traced):
    jax_client, port_app, (jax_dir, port_dir) = traced
    incoming = {"traceparent": f"00-{TRACE}-{SPAN}-01"}
    for client, trace_dir, jax in ((jax_client, jax_dir, True), (port_app, port_dir, False)):
        _, headers, _ = call(client, trace_dir, "GET", url("machine-1/metadata"), headers=incoming)
        echoed = tracing.parse_traceparent(headers["traceparent"])
        assert echoed.trace_id == TRACE and echoed.span_id != SPAN and echoed.sampled
        request_span = next(s for s in read_trace(trace_dir, jax) if s["name"] == "request")
        assert request_span["parent_id"] == SPAN
        assert request_span["context"] == {"trace_id": TRACE, "span_id": echoed.span_id}


def test_unsampled_upstream_is_not_exported(traced):
    jax_client, port_app, (jax_dir, port_dir) = traced
    other = "c" * 32
    for client, trace_dir, jax in ((jax_client, jax_dir, True), (port_app, port_dir, False)):
        _, headers, _ = call(client, trace_dir, "GET", url("machine-1/metadata"),
                             headers={"traceparent": f"00-{other}-{SPAN}-00"})
        assert headers["traceparent"].startswith(f"00-{other}-") and headers["traceparent"].endswith("-00")
        assert read_trace(trace_dir, jax) == []


def test_healthcheck_and_version_are_never_exported(traced):
    jax_client, port_app, (jax_dir, port_dir) = traced
    for client, trace_dir, jax in ((jax_client, jax_dir, True), (port_app, port_dir, False)):
        flags = [call(client, trace_dir, "GET", path)[1]["traceparent"][-2:] for path in ("/healthcheck",
                                                                                           "/server-version")]
        assert flags == ["00", "00"]
        assert read_trace(trace_dir, jax) == []


def test_sample_rate_zero_exports_nothing(traced, monkeypatch):
    monkeypatch.setenv("GORDO_TPU_TRACE_SAMPLE_RATE", "0")
    jax_client, port_app, (jax_dir, port_dir) = traced
    for client, trace_dir, jax in ((jax_client, jax_dir, True), (port_app, port_dir, False)):
        _, headers, _ = call(client, trace_dir, "POST", *requests_of("prediction")[1:])
        assert tracing.parse_traceparent(headers["traceparent"]) is not None
        assert read_trace(trace_dir, jax) == []


def test_server_error_marks_the_request_span(traced, monkeypatch):
    """A 5xx (a view that raises) is an ``ERROR`` request span in both."""
    jax_client, port_app, (jax_dir, port_dir) = traced

    def broken(*args, **kwargs):
        raise RuntimeError("broken view")

    monkeypatch.setitem(jax_app_module.HANDLERS, "models", broken)
    port_app.routes = [(m, p, broken if e == "models" else v, e) for m, p, v, e in port_app.routes]
    spans = []
    for client, trace_dir, jax in ((jax_client, jax_dir, True), (port_app, port_dir, False)):
        status, _, _ = call(client, trace_dir, "GET", url("models"))
        assert status == 500
        spans.append(next(s for s in read_trace(trace_dir, jax) if s["name"] == "request"))
    assert spans[1]["status"] == spans[0]["status"] == {"status_code": "ERROR", "description": "HTTP 500"}
    assert shape(spans[1:]) == shape(spans[:1])


def test_profile_attaches_a_profile_span(traced):
    """``?profile=1`` in both servers, sampled at the same interval; a
    request without it is not profiled (the JAX default sample rate, 0)."""
    jax_client, port_app, (jax_dir, port_dir) = traced
    method, path, body = requests_of("prediction")
    intervals = []
    for client, trace_dir, jax in ((jax_client, jax_dir, True), (port_app, port_dir, False)):
        call(client, trace_dir, method, path + "?profile=1", body)
        call(client, trace_dir, method, path, body)
        spans = read_trace(trace_dir, jax)
        profiles = [s for s in spans if s["name"] == "profile"]
        request_span = next(s for s in spans if s["name"] == "request")
        assert len(profiles) == 1 and profiles[0]["parent_id"] == request_span["context"]["span_id"]
        assert isinstance(profiles[0]["attributes"]["frames"], list)
        intervals.append(profiles[0]["attributes"]["interval_ms"])
    assert intervals[1] == intervals[0] == 5.0


def test_profile_device_writes_a_torch_profiler_trace(traced, tmp_path, monkeypatch):
    """``?profile=device`` with ``GORDO_TPU_PROFILE_DIR``: a Chrome trace of
    the request under ``<dir>/request-<trace id prefix>/``."""
    _, port_app, (_, port_dir) = traced
    monkeypatch.setenv("GORDO_TPU_PROFILE_DIR", str(tmp_path / "profiles"))
    method, path, body = requests_of("prediction")
    status, headers, _ = call(port_app, port_dir, method, path + "?profile=device", body)
    assert status == 200
    trace_id = tracing.parse_traceparent(headers["traceparent"]).trace_id
    with open(tmp_path / "profiles" / f"request-{trace_id[:16]}" / "trace.json") as f:
        assert json.load(f)["traceEvents"]


def test_telemetry_off_writes_nothing_and_keeps_server_timing(traced, monkeypatch):
    """``GORDO_TPU_TELEMETRY=0``: no trace, no ledger snapshot, no file at
    all under the telemetry directory, the same body, and the stages still
    in ``Server-Timing`` (equal to the JAX server's)."""
    jax_client, port_app, (jax_dir, port_dir) = traced
    method, path, body = requests_of("prediction")
    on = call(port_app, port_dir, method, path, body)
    os.remove(os.path.join(port_app.store.collection_dir, FLEET_HEALTH_FILE))
    monkeypatch.setenv("GORDO_TPU_TELEMETRY", "0")
    serving.reset_serve_recorder()
    jax_serving.reset_serve_recorder()
    assert serving.serve_recorder() is recorder.NULL_RECORDER
    off_dirs = port_dir + "-off", jax_dir + "-off"
    off = call(port_app, off_dirs[0], method, path + "?profile=1", body)
    jax_off = call(jax_client, off_dirs[1], method, path + "?profile=1", body)
    assert off[0] == on[0] == 200 and off[2] == on[2]
    assert stage_names(off[1]) == stage_names(jax_off[1])
    assert "inference" in stage_names(off[1])
    assert not os.path.exists(off_dirs[0]) and not os.path.exists(off_dirs[1])
    assert not os.path.exists(os.path.join(port_app.store.collection_dir, FLEET_HEALTH_FILE))


# -- the stream's spans --------------------------------------------------------------


def test_stream_spans_link_ingests_and_match_jax(traced):
    """Two ingests, the second reaching the watermark again: each
    ``stream_score`` links the ``stream_ingest`` spans it drained, as the
    JAX plane's do, with the same attribute keys."""
    jax_client, port_app, (jax_dir, port_dir) = traced
    traces = []
    for client, trace_dir, jax in ((jax_client, jax_dir, True), (port_app, port_dir, False)):
        for seed, rows in ((7, 5), (8, 20)):
            X = {n: _frame(TAGS[n], rows, seed=seed, start_minute=0 if seed == 7 else 50) for n in NAMES}
            assert call(client, trace_dir, "POST", url("stream/s1/ingest"), {"X": X})[0] == 200
        traces.append(read_trace(trace_dir, jax))
    for spans in traces:
        ingests = {s["context"]["span_id"] for s in spans if s["name"] == "stream_ingest"}
        scores = [s for s in spans if s["name"] == "stream_score"]
        assert len(ingests) == 2 and scores
        linked = {link["context"]["span_id"] for s in scores for link in s.get("links", [])}
        assert linked == ingests
    keys = [[(s["name"], sorted(s["attributes"]), len(s.get("links", []))) for s in spans
             if s["name"].startswith("stream_")] for spans in traces]
    assert keys[1] == keys[0]
    for port_span, jax_span in zip(*[[s for s in spans if s["name"] == "stream_score"] for spans in traces[::-1]]):
        for attribute in ("machines", "rows", "windows", "shed", "rows_scored", "rows_failed", "lag_hist"):
            if attribute == "lag_hist":
                assert sum(port_span["attributes"][attribute]) == sum(jax_span["attributes"][attribute])
            else:
                assert port_span["attributes"][attribute] == jax_span["attributes"][attribute], attribute


# -- the trace sink ----------------------------------------------------------------


def _fill(rec, n, name="s"):
    for i in range(n):
        with rec.span(name, i=i, pad="x" * 200):
            pass


def _lines(directory, base="trace.jsonl"):
    spans = []
    for entry in sorted(os.listdir(directory)):
        if entry.startswith(base):
            with open(os.path.join(directory, entry)) as f:
                spans.extend(json.loads(line) for line in f)
    return spans


def test_async_sink_rotates_under_concurrent_writers_and_loses_nothing(tmp_path):
    """Eight threads, spans and deferred builders, rotation at 16 KiB with
    every generation kept: after ``flush`` and ``close`` every span is on
    disk exactly once, and no writer thread is left."""
    rec = SpanRecorder(sink_path=str(tmp_path / "trace.jsonl"), max_bytes=16384, keep=1000, async_sink=True)

    def write(worker):
        for i in range(50):
            with rec.span("s", worker=worker, i=i, pad="x" * 100):
                pass
            rec.emit_deferred(lambda worker=worker, i=i: [rec._span_dict("d", "0" * 16, None, 0.0, 0.0,
                                                                          {"worker": worker, "i": i}, None)])

    threads = [threading.Thread(target=write, args=(w,)) for w in range(8)]
    for thread in threads:
        thread.start()
    for thread in threads:
        thread.join()
    rec.flush()
    assert any(entry.startswith("trace.jsonl.") for entry in os.listdir(tmp_path))
    rec.close()
    assert rec._writer is None
    spans = _lines(tmp_path)
    for name in ("s", "d"):
        seen = sorted((s["attributes"]["worker"], s["attributes"]["i"]) for s in spans if s["name"] == name)
        assert seen == [(w, i) for w in range(8) for i in range(50)]


def test_async_sink_close_writes_what_is_queued(tmp_path):
    """The JAX async case: rotation and flush; then spans queued after the
    flush reach the disk through ``close`` alone, and a broken deferred
    builder loses only its own spans."""
    rec = SpanRecorder(sink_path=str(tmp_path / "trace.jsonl"), max_bytes=4096, keep=2, async_sink=True)
    jax_rec = jax_recorder.SpanRecorder(sink_path=str(tmp_path / "jax.jsonl"), max_bytes=4096, keep=2,
                                        async_sink=True)
    for r in (rec, jax_rec):
        _fill(r, 80)
        r.flush()
    for base in ("trace.jsonl.", "jax.jsonl."):
        assert any(f.startswith(base) for f in os.listdir(tmp_path)), base
    for r in (rec, jax_rec):
        r.emit_deferred(lambda: 1 / 0)
        _fill(r, 5, name="late")
        r.close()
    assert [s["attributes"]["i"] for s in _lines(tmp_path) if s["name"] == "late"] == list(range(5))


def test_sink_reopens_a_file_another_process_moved(tmp_path):
    """A sink whose file was renamed away writes to a fresh file at its path."""
    path = tmp_path / "trace.jsonl"
    for async_sink in (False, True):
        rec = SpanRecorder(sink_path=str(path), max_bytes=0, async_sink=async_sink)
        _fill(rec, 2)
        rec.flush()
        os.replace(path, tmp_path / "moved.jsonl")
        _fill(rec, 3, name="after")
        rec.close()
        with open(path) as f:
            assert [json.loads(line)["name"] for line in f] == ["after"] * 3
        os.remove(path)


def test_worker_sinks_match_jax(tmp_path, monkeypatch):
    """Workers (``GORDO_TPU_WORKER_SINKS=1``) write ``serve_trace-<pid>.jsonl``
    and ``fleet_health-<pid>.json``, the port's as the JAX package's; a
    one-process server (``GORDO_TPU_WORKER_SINKS=0``) keeps the plain names,
    and the port's readers merge both as the JAX readers do."""
    monkeypatch.delenv("PROMETHEUS_MULTIPROC_DIR", raising=False)
    monkeypatch.setenv("GORDO_TPU_TELEMETRY_DIR", str(tmp_path))
    monkeypatch.setenv("GORDO_TPU_WORKER_SINKS", "1")
    jax_trace, jax_ledger = jax_serving.serve_trace_path(), jax_fleet_health.FleetHealthLedger(str(tmp_path))
    assert jax_trace == str(tmp_path / f"serve_trace-{os.getpid()}.jsonl")
    assert jax_ledger.path == str(tmp_path / f"fleet_health-{os.getpid()}.json")
    assert serving.serve_trace_path() == jax_trace
    assert FleetHealthLedger(directory=str(tmp_path)).path == jax_ledger.path
    monkeypatch.setenv("GORDO_TPU_WORKER_SINKS", "0")
    port_ledger = FleetHealthLedger(directory=str(tmp_path))
    assert serving.serve_trace_path() == str(tmp_path / "serve_trace.jsonl")
    assert port_ledger.path == str(tmp_path / FLEET_HEALTH_FILE)
    for name, base in ((os.path.basename(jax_trace), "serve_trace.jsonl"),
                       (os.path.basename(jax_ledger.path), FLEET_HEALTH_FILE), (FLEET_HEALTH_FILE, FLEET_HEALTH_FILE),
                       ("fleet_health.d", FLEET_HEALTH_FILE)):
        assert recorder.is_worker_variant(name, base) == jax_aggregate.is_worker_variant(name, base)
    for ledger in (jax_ledger, port_ledger):
        ledger.record_request("m-1", error=ledger is jax_ledger)
        ledger.record_scores("m-1", 10, 0.5)
        ledger.flush()
    assert fleet_health.health_snapshot_paths(str(tmp_path)) == jax_fleet_health.health_snapshot_paths(str(tmp_path))
    assert len(fleet_health.health_snapshot_paths(str(tmp_path))) == 2
    merged = [module.load_merged_health(str(tmp_path)) for module in (jax_fleet_health, fleet_health)]
    assert merged[1]["machines"]["m-1"]["serving"]["requests"] == 2
    assert {k: v for k, v in merged[1].items() if k != "updated_at"} == \
        {k: v for k, v in merged[0].items() if k != "updated_at"}
