"""The port's fleet health ledger and fleet-status surface, held to the
JAX package on the CPU: the ledger's six feeds, the merged view of many
workers' snapshots, the breaker nomination, the ``slo`` section, the
``GET /fleet-health`` route of both apps after the same traffic (the
request, fleet, stream and breaker feeds), ``render_fleet_status`` and
the ``fleet-status`` command.

Documents are compared with their timestamps taken out, and the
sections a server injects (``device``, ``programs``, ``serving``,
``stream``) by their keys: they describe each process. Residual means
are compared at rtol 1e-5, atol 1e-6 (the forward's tolerance; they are
means of K2's row errors). Each case resets the JAX package's
process-wide ledgers, engine, plane, breakers and program counters
around itself.
"""

import copy
import json
import os
import shutil

import numpy as np
import pytest
from click.testing import CliRunner
from werkzeug.test import Client

from gordo_tpu import serve as jax_serve
from gordo_tpu import serializer as jax_serializer
from gordo_tpu.builder import local_build
from gordo_tpu.cli.cli import fleet_status as jax_fleet_status_command
from gordo_tpu.server import build_app as jax_build_app
from gordo_tpu.server.fleet_store import STORE as JAX_STORE
from gordo_tpu.stream import reset_plane as jax_reset_plane
from gordo_tpu.telemetry import device as jax_device
from gordo_tpu.telemetry import fleet_health as jax_fleet_health
from gordo_tpu.telemetry import serving as jax_serving
from gordo_tpu.telemetry import slo as jax_slo
from gordo_tpu.utils import faults as jax_faults
from gordo_tpu_torch import serializer, telemetry
from gordo_tpu_torch.cli.cli import main as port_cli
from gordo_tpu_torch.models.anomaly.diff import DiffBasedAnomalyDetector
from gordo_tpu_torch.server import build_app
from gordo_tpu_torch.serve.engine import ServeConfig
from gordo_tpu_torch.telemetry import fleet_health, slo
from gordo_tpu_torch.utils import faults

PROJECT = "test-project"
REVISION = "1602324482000"
NAMES = ("machine-1", "machine-2")
TAGS = {"machine-1": ["tag-1", "tag-2", "tag-3", "tag-4"], "machine-2": ["tag-5", "tag-6", "tag-7", "tag-8"]}
RTOL, ATOL = 1e-5, 1e-6
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
#: keys whose values are times
TIME_KEYS = {"updated_at", "last_request_at", "evaluated_at", "built_at", "since", "generated_at"}


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
    rng = np.random.RandomState(seed)
    index = [f"2020-03-01T{(start_minute + 10 * i) // 60:02d}:{(start_minute + 10 * i) % 60:02d}:00+00:00"
             for i in range(rows)]
    values = rng.rand(len(tags), rows) * 2 - 0.5
    return {tag: {index[i]: float(values[t, i]) for i in range(rows)} for t, tag in enumerate(tags)}


def untimed(doc):
    """``doc`` with every time value taken out."""
    if isinstance(doc, dict):
        return {k: untimed(v) for k, v in doc.items() if k not in TIME_KEYS}
    if isinstance(doc, list):
        return [untimed(v) for v in doc]
    return doc


def assert_same(expected, got, path="doc"):
    """Equal documents, numbers within RTOL/ATOL."""
    if isinstance(expected, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(expected), path
        for key in expected:
            assert_same(expected[key], got[key], f"{path}/{key}")
    elif isinstance(expected, list):
        assert isinstance(got, list) and len(got) == len(expected), path
        for i, (e, g) in enumerate(zip(expected, got)):
            assert_same(e, g, f"{path}/{i}")
    elif isinstance(expected, float) and isinstance(got, (int, float)):
        np.testing.assert_allclose(got, expected, rtol=RTOL, atol=ATOL, err_msg=path)
    else:
        assert got == expected, path


@pytest.fixture(autouse=True)
def clean_globals(monkeypatch):
    # the JAX package also reads the settings the port keeps as constants
    for name in ("GORDO_TPU_TELEMETRY", "GORDO_TPU_FLEET_HEALTH", "GORDO_TPU_WORKER_SINKS", "PROMETHEUS_MULTIPROC_DIR",
                 "GORDO_TPU_HEALTH_SHARDS", "GORDO_TPU_TELEMETRY_DIR", "GORDO_TPU_BATCHING", "GORDO_TPU_HEALTH_WINDOW",
                 "GORDO_TPU_FLEET_STATUS_MAX_MACHINES", "GORDO_TPU_FLEET_STATUS_TOP_K", "GORDO_TPU_DEVICE_TELEMETRY"):
        monkeypatch.delenv(name, raising=False)
    reset = (jax_fleet_health.reset_ledgers, telemetry.reset_serving_ledgers, jax_serving.reset_serve_recorder,
             telemetry.reset_serve_recorder,
             lambda: jax_serve.install_engine(None), jax_reset_plane, jax_serve.reset_stream_breakers,
             jax_slo.reset_statuses, jax_device.reset_program_counters, telemetry.reset_program_counters)
    for step in reset:
        step()
    yield
    for step in reset:
        step()


# -- the ledger's feeds -------------------------------------------------------------

FEEDS = {
    "serving": [
        ("record_request", ("m-1",), {}),
        ("record_request", ("m-1",), {"error": True, "count": 3}),
        ("record_scores", ("m-1", 40, 0.25), {}),
        ("record_scores", ("m-1", 10, 1.0), {"write": False}),
        ("record_scores", ("m-2", 7, float("nan")), {}),
        ("record_scores", ("m-2", 0, 0.5), {}),
    ],
    "drift": [
        ("record_drift", ("m-1", True, ["feature-shift tag-1 (3.00σ)"], {"feature_shift_max": 3.0, "window_rows": 9}),
         {}),
        ("record_drift", ("m-2", False), {"write": False}),
    ],
    "quarantine": [
        ("record_quarantine", (["m-1", "m-3"],), {"revision": "123", "reasons": [f"r{i}" for i in range(7)]}),
    ],
    "breaker": [
        ("record_breaker", ("m-1", "open"), {"trips": 2, "cooldown_s": 5.0, "reason": "x" * 300}),
        ("record_breaker", ("m-2", "half_open"), {}),
        ("record_breaker", ("m-2", "closed"), {"trips": 1}),
    ],
    "promotion": [
        ("record_build", ("m-1",), {"revision": "1", "degraded": True, "error": "boom", "final_loss": 0.5}),
        ("record_quarantine", (["m-1"],), {"revision": "1"}),
        ("record_breaker", ("m-1", "open"), {}),
        ("record_drift", ("m-1", True, ["d"]), {}),
        ("record_promotion", ("2", ["m-1"]), {}),
        ("record_plan_accuracy", ({"actual_compiles": 3},), {}),
    ],
}


@pytest.mark.parametrize("feed", sorted(FEEDS))
def test_ledger_feeds_match_jax(feed, tmp_path):
    """The same calls on both ledgers: equal documents, summaries,
    offenders and machine records; the same listener calls."""
    ledgers = (jax_fleet_health.FleetHealthLedger(str(tmp_path / "jax"), project="p"),
               fleet_health.FleetHealthLedger(str(tmp_path / "port"), project="p"))
    heard = ([], [])
    for ledger, sink in zip(ledgers, heard):
        ledger.add_listener(lambda summary, sink=sink: sink.append(summary))
        for method, args, kwargs in FEEDS[feed]:
            getattr(ledger, method)(*copy.deepcopy(args), **kwargs)
    jax_ledger, port_ledger = ledgers
    assert untimed(port_ledger.document()) == untimed(jax_ledger.document())
    assert port_ledger.offenders() == jax_ledger.offenders()
    assert untimed(port_ledger.bounded_document(top_k=1)) == untimed(jax_ledger.bounded_document(top_k=1))
    assert untimed(port_ledger.machine("m-1")) == untimed(jax_ledger.machine("m-1"))
    assert port_ledger.machine("nobody") is jax_ledger.machine("nobody") is None
    assert heard[1] == heard[0]
    with open(tmp_path / "jax" / "fleet_health.json") as a, open(tmp_path / "port" / "fleet_health.json") as b:
        assert untimed(json.load(b)) == untimed(json.load(a))
    for method, args, kwargs in FEEDS[feed]:  # the null ledger takes every feed
        getattr(fleet_health.NULL_LEDGER, method)(*args, **kwargs)


def test_residual_window_matches_jax():
    """Past ``HEALTH_WINDOW_ROWS`` (the JAX default window) the rolling
    mean halves its weight, in both."""
    assert fleet_health.HEALTH_WINDOW_ROWS == jax_fleet_health.FleetHealthLedger().window_rows == 100_000
    ledgers = jax_fleet_health.FleetHealthLedger(), fleet_health.FleetHealthLedger()
    means = []
    for ledger in ledgers:
        for i in range(6):
            ledger.record_scores("m", 40_000, 0.1 * (i + 1))
        means.append(ledger.document()["machines"]["m"]["serving"]["residual_mean"])
    assert means[1] == means[0]
    assert means[0] != round(sum(0.1 * (i + 1) for i in range(6)) / 6, 8)  # the window decayed


# -- many workers' snapshots --------------------------------------------------------


def _workers(directory, monkeypatch):
    """Snapshots of three JAX "workers" in ``directory``: a sharded shared
    one, a single-file worker variant and another with a tripped breaker."""
    monkeypatch.setenv("GORDO_TPU_HEALTH_SHARDS", "2")
    shared = jax_fleet_health.FleetHealthLedger(directory)
    for i in range(5):
        shared.record_request(f"m-{i}")
        shared.record_scores(f"m-{i}", 10 + i, 0.1 * i)
    shared.record_build("m-0", revision="7", failed=True, error="boom")
    shared.flush()
    monkeypatch.delenv("GORDO_TPU_HEALTH_SHARDS")
    for pid, tripped in ((111, False), (222, True)):
        worker = jax_fleet_health.FleetHealthLedger()
        worker.record_request("m-1", error=True, count=2)
        worker.record_scores("m-1", 5, 0.7)
        worker.record_request("m-9")
        if tripped:
            worker.record_breaker("m-3", "open", trips=1, reason="device")
            worker.record_drift("m-2", True, ["later"])
        with open(os.path.join(directory, f"fleet_health-{pid}.json"), "w") as f:
            json.dump(worker.document(), f)


def test_merged_health_matches_jax(tmp_path, monkeypatch):
    directory = str(tmp_path)
    _workers(directory, monkeypatch)
    units = [(u["stem"], u["kind"], u["paths"], u["dir"]) for u in fleet_health.health_snapshot_units(directory)]
    assert units == [(u["stem"], u["kind"], u["paths"], u["dir"])
                     for u in jax_fleet_health.health_snapshot_units(directory)]
    assert [u[1] for u in units] == ["shards", "file", "file"]
    assert fleet_health.health_snapshot_paths(directory) == jax_fleet_health.health_snapshot_paths(directory)
    merged = fleet_health.load_merged_health(directory)
    assert merged["workers_merged"] == 3
    assert_same(untimed(jax_fleet_health.load_merged_health(directory)), untimed(merged))
    docs = [json.load(open(p)) for p in fleet_health.health_snapshot_paths(directory)]
    assert_same(untimed(jax_fleet_health.merge_health_documents(docs)),
                untimed(fleet_health.merge_health_documents(docs)))
    excluded = fleet_health.load_merged_health(directory, live_documents=[docs[0]],
                                               exclude_paths=[os.path.join(directory, "fleet_health-111.json")])
    assert_same(untimed(jax_fleet_health.load_merged_health(
        directory, live_documents=[docs[0]], exclude_paths=[os.path.join(directory, "fleet_health-111.json")])),
        untimed(excluded))
    tripped = fleet_health.breaker_tripped_machines(directory)
    assert list(tripped) == ["m-3"]
    assert untimed(tripped) == untimed(jax_fleet_health.breaker_tripped_machines(directory))
    assert fleet_health.breaker_tripped_machines(str(tmp_path / "empty")) == {}


@pytest.mark.parametrize("machines, limit, offset", [
    (None, None, 0), ("none", None, 0), ("all", 2, 1), ("unhealthy", None, 0), ("degraded", None, 0),
    ("m-1,m-4,bogus", None, 0), ("all", None, 0),
])
def test_fleet_status_document_matches_jax(tmp_path, monkeypatch, machines, limit, offset):
    directory = str(tmp_path / REVISION)
    os.makedirs(directory)
    _workers(directory, monkeypatch)
    with open(os.path.join(directory, "fleet_plan.json"), "w") as f:
        json.dump({"strategy": "naive", "totals": {"buckets": 2, "compiles": 4, "padding_waste": 0.25}}, f)
    os.makedirs(tmp_path / ".lifecycle")
    with open(tmp_path / ".lifecycle" / "state.json", "w") as f:
        json.dump({"phase": "serving", "serving_revision": REVISION, "history": list(range(9))}, f)
    with open(tmp_path / ".lifecycle" / "quarantine.json", "w") as f:
        json.dump([{"machine": "m-1"}], f)
    docs = [module.fleet_status_document(directory, machines=machines, limit=limit, offset=offset)
            for module in (jax_fleet_health, fleet_health)]
    assert_same(untimed(docs[0]), untimed(docs[1]))
    assert fleet_health.render_fleet_status(docs[1]) == jax_fleet_health.render_fleet_status(docs[0])


def test_fleet_status_bounds_match_jax(tmp_path, monkeypatch):
    """``FLEET_STATUS_MAX_MACHINES`` and ``FLEET_STATUS_TOP_K`` (the JAX
    defaults): the health section bounded in both, with and without a
    live ledger."""
    assert (fleet_health.FLEET_STATUS_MAX_MACHINES, fleet_health.FLEET_STATUS_TOP_K) == (500, 10)
    directory = str(tmp_path)
    _workers(directory, monkeypatch)
    many = jax_fleet_health.FleetHealthLedger()
    for i in range(510):
        many.record_request(f"w-{i:03d}")
        if i % 3 == 0:
            many.record_drift(f"w-{i:03d}", True, [f"shift {i}"], write=False)
    with open(os.path.join(directory, "fleet_health-333.json"), "w") as f:
        json.dump(many.document(), f)
    docs = [module.fleet_status_document(directory) for module in (jax_fleet_health, fleet_health)]
    assert docs[1]["health"]["machines"] is None and len(docs[1]["health"]["top_offenders"]) == 10
    assert_same(untimed(docs[0]), untimed(docs[1]))
    paged = [module.fleet_status_document(directory, machines="all", limit=600) for module in (jax_fleet_health,
                                                                                             fleet_health)]
    assert len(paged[1]["health"]["machines"]) == 500
    assert_same(untimed(paged[0]), untimed(paged[1]))
    live = str(tmp_path / "live")
    jax_live = jax_fleet_health.ledger_for(live)
    port_live = fleet_health.ledger_for(live)
    for ledger in (jax_live, port_live):
        for i in range(504):
            ledger.record_request(f"x-{i}", error=i == 0)
    jax_doc = jax_fleet_health.fleet_status_document(live)
    port_doc = fleet_health.fleet_status_document(live, ledger=port_live)
    assert port_doc["health"]["machines_truncated"] and port_doc["health"]["summary"]["requests"] == 504
    assert_same(untimed(jax_doc), untimed(port_doc))


def test_slo_section_matches_jax(tmp_path):
    """The persisted alerts of ``slo_state.json``, read as the JAX section
    reads them when its process has not evaluated."""
    assert slo.slo_section(str(tmp_path)) is jax_slo.slo_section(str(tmp_path)) is None
    with open(tmp_path / "slo_state.json", "w") as f:
        json.dump({"version": 1, "updated_at": "2026-01-01T00:00:00+00:00", "alerts": {
            "availability:fast": {"state": "firing", "severity": "page"},
            "latency:slow": {"state": "pending", "severity": "ticket"},
            "x:y": {"state": "inactive"}}}, f)
    assert slo.slo_section(str(tmp_path)) == jax_slo.slo_section(str(tmp_path))
    rendered = fleet_health.render_fleet_status({"slo": slo.slo_section(str(tmp_path))})
    assert "BURNING — 1 firing, 1 pending" in rendered


# -- the route on both apps ---------------------------------------------------------


@pytest.fixture(scope="module")
def collections(tmp_path_factory):
    """``(jax_dir, port_dir)``: the same two detectors in both packages,
    each directory's ``fleet_health.json`` a build's record of them."""
    root = tmp_path_factory.mktemp("torch-fleet-health")
    jax_dir, port_dir = root / "jax" / REVISION, root / "port" / REVISION
    for model, machine in local_build(CONFIG, project_name=PROJECT):
        jax_serializer.dump(model, str(jax_dir / machine.name), metadata=machine.to_dict())
        with open(jax_dir / machine.name / "metadata.json") as f:
            metadata = json.load(f)
        serializer.dump(port_detector(model), str(port_dir / machine.name), metadata=metadata)
    build = jax_fleet_health.FleetHealthLedger()
    for name in NAMES:
        build.record_build(name, revision=REVISION, final_loss=0.125)
    for directory in (jax_dir, port_dir):
        with open(directory / "build.json", "w") as f:
            json.dump(build.document(), f)
    return str(jax_dir), str(port_dir)


@pytest.fixture
def apps(collections, monkeypatch):
    """Both apps, each directory holding only its build's health snapshot."""
    jax_dir, port_dir = collections
    for directory in collections:
        shutil.copy(os.path.join(directory, "build.json"), os.path.join(directory, "fleet_health.json"))
    monkeypatch.setenv("MODEL_COLLECTION_DIR", jax_dir)
    monkeypatch.setenv("GORDO_TPU_STREAM_WINDOW_ROWS", "8")
    monkeypatch.setenv("GORDO_TPU_SERVE_WARMUP", "0")
    JAX_STORE.invalidate(jax_dir)
    yield jax_build_app(config={"EXPECTED_MODELS": []}), build_app(port_dir, device="cpu")
    for directory in collections:
        os.remove(os.path.join(directory, "fleet_health.json"))


def url(rest):
    return f"/gordo/v0/{PROJECT}/{rest}"


def traffic(app):
    """The same requests to ``app``: two anomaly requests, a ``/prediction``,
    a fleet request, a stream ingest that flushes, and a request for a
    model that does not exist."""
    client = Client(app)
    statuses = []
    for path, body in (
        (url("machine-1/anomaly/prediction"), {"X": _frame(TAGS["machine-1"], 20, 1),
                                                "y": _frame(TAGS["machine-1"], 20, 2)}),
        (url("machine-1/anomaly/prediction"), {"X": _frame(TAGS["machine-1"], 20, 3),
                                                "y": _frame(TAGS["machine-1"], 20, 3)}),
        (url("machine-2/prediction"), {"X": _frame(TAGS["machine-2"], 20, 4)}),
        (url("prediction/fleet"), {"X": {n: _frame(TAGS[n], 30, 5) for n in NAMES}}),
        (url("stream/s1/ingest"), {"X": {n: _frame(TAGS[n], 20, 6) for n in NAMES}}),
        (url("nobody/prediction"), {"X": _frame(TAGS["machine-2"], 20, 4)}),
    ):
        statuses.append(client.post(path, data=json.dumps(body), content_type="application/json").status_code)
    return statuses


def fleet_health_doc(app, query=""):
    response = Client(app).get(url("fleet-health") + query)
    assert response.status_code == 200
    return json.loads(response.get_data())


#: the JAX engine's counters of its wire-column ingest, which the port's
#: engine does not have (every request queues raw rows there)
JAX_ONLY_ENGINE_STATS = {"ingest", "ingest_requests", "ingest_replans"}


def assert_route_docs_equal(jax_doc, port_doc):
    for section in ("device", "programs", "serving", "stream"):
        jax_section, port_section = jax_doc.pop(section), port_doc.pop(section)
        assert (jax_section is None) == (port_section is None), section
        if isinstance(jax_section, dict):
            assert set(jax_section) - JAX_ONLY_ENGINE_STATS <= set(port_section), section
    for doc in (jax_doc, port_doc):
        doc.pop("directory")
    assert_same(untimed(jax_doc), untimed(port_doc))


@pytest.mark.parametrize("query", ["", "?machines=none", "?machines=all&limit=1&offset=1", "?machines=healthy",
                                   "?machines=machine-2,bogus", "?machines=all&limit=zap&offset=zap"])
def test_fleet_health_route_matches_jax(apps, query):
    """After the same traffic: the build's records and the serving counts
    in one document (the app's ledger adopted the build's snapshot and is
    not counted twice), equal to the JAX app's."""
    statuses = [traffic(app) for app in apps]
    assert statuses[0] == statuses[1] == [200, 200, 200, 200, 200, 404]
    docs = [fleet_health_doc(app, query) for app in apps]
    if query == "":
        machine = docs[1]["health"]["machines"]["machine-1"]
        assert machine["build"]["revision"] == REVISION and machine["build"]["final_loss"] == 0.125
        assert machine["serving"]["requests"] == 4 and machine["serving"]["rows"] == 30 + 16
        assert docs[1]["health"]["summary"]["requests"] == 7
        assert "nobody" not in docs[1]["health"]["machines"]
    assert_route_docs_equal(*docs)
    rendered = [fleet_health.render_fleet_status(docs[1]), jax_fleet_health.render_fleet_status(docs[0])]
    assert rendered[0] == rendered[1]


def test_fleet_health_route_with_an_engine_and_a_tripped_breaker(apps, monkeypatch):
    """A poisoned member through each server's engine: a 500, its breaker
    open in the ledger (the engine's breaker feed), the machine
    quarantined, and ``serving.breaker`` counting it; the same in both."""
    jax_app, port_app = apps
    monkeypatch.setenv("GORDO_TPU_BREAKER_THRESHOLD", "1")
    monkeypatch.setenv("GORDO_TPU_BREAKER_COOLDOWN_S", "60")
    config = dict(max_size=1, max_delay_ms=1.0, deadline_ms=40000.0, queue_depth=64, row_ladder=(32, 128))
    jax_engine = jax_serve.ServeEngine(jax_serve.ServeConfig(**config))
    jax_serve.install_engine(jax_engine)
    port_app = build_app(port_app.store.collection_dir, device="cpu", serve_config=ServeConfig(**config))
    match = "*:f32:machine-2"
    try:
        with jax_faults.inject(jax_faults.FaultRule("serve_device_program", match=match, times=None,
                                                    exc=jax_faults.InjectedDeviceError)), \
                faults.inject(faults.FaultRule("serve_device_program", match=match, times=None,
                                               exc=faults.InjectedDeviceError)):
            for app in (jax_app, port_app):
                client = Client(app)
                body = {"X": _frame(TAGS["machine-2"], 20, 7)}
                assert client.post(url("machine-2/prediction"), data=json.dumps(body),
                                   content_type="application/json").status_code == 500
                assert client.post(url("machine-2/prediction"), data=json.dumps(body),
                                   content_type="application/json").status_code == 503
        docs = [fleet_health_doc(app) for app in (jax_app, port_app)]
        machine = docs[1]["health"]["machines"]["machine-2"]
        assert machine["breaker"]["state"] == "open" and machine["health"]["state"] == "quarantined"
        assert machine["serving"] == {**machine["serving"], "requests": 2, "errors": 1}
        assert docs[1]["serving"]["breaker"]["open"] == docs[0]["serving"]["breaker"]["open"] == 1
        assert docs[1]["health"]["summary"]["breaker_tripped"] == 1
        port_serving = docs[1]["serving"]
        assert port_serving["gates"] == [] and port_serving["store"][REVISION]["models"] == 1
        assert_route_docs_equal(*docs)
        port_app.live_ledger.flush()
        assert list(fleet_health.breaker_tripped_machines(port_app.store.collection_dir)) == ["machine-2"]
    finally:
        jax_serve.install_engine(None)
        jax_engine.shutdown(drain=True)
        port_app.shutdown()


def test_fleet_status_command_matches_jax(apps, capsys):
    """``fleet-status DIR`` in both packages over each app's snapshot,
    as text and as JSON; a missing directory exits 1."""
    for app in apps:
        traffic(app)
    jax_dir, port_dir = os.environ["MODEL_COLLECTION_DIR"], apps[1].store.collection_dir
    apps[1].live_ledger.flush()
    jax_fleet_health.ledger_for(jax_dir).flush()
    # the command reads the snapshots and no live plane, as a process of its own does
    jax_fleet_health.reset_ledgers()
    jax_reset_plane()
    for as_json in (False, True):
        flag = ["--as-json"] if as_json else []
        jax_out = CliRunner().invoke(jax_fleet_status_command, [jax_dir, *flag])
        assert jax_out.exit_code == 0
        assert port_cli(["fleet-status", port_dir, *flag]) == 0
        port_out = capsys.readouterr().out
        if as_json:
            jax_doc, port_doc = json.loads(jax_out.output), json.loads(port_out)
            assert port_doc["health"]["summary"]["requests"] == 7
            assert_route_docs_equal(jax_doc, port_doc)
        else:
            assert port_out.replace(port_dir, "D") == jax_out.output.replace(jax_dir, "D")
    assert port_cli(["fleet-status", port_dir + "-missing"]) == 1
    assert CliRunner().invoke(jax_fleet_status_command, [jax_dir + "-missing"]).exit_code != 0


def test_device_telemetry_switch(apps, monkeypatch):
    """``GORDO_TPU_TELEMETRY=0``: the device section keeps its counters and
    loses its memory reading, in both (the port has no switch of the
    reading alone; the JAX package's ``GORDO_TPU_DEVICE_TELEMETRY`` is on
    by default)."""
    docs = [fleet_health_doc(app)["device"] for app in apps]
    assert "memory" in docs[0] and "memory" in docs[1]
    monkeypatch.setenv("GORDO_TPU_TELEMETRY", "0")
    docs = [fleet_health_doc(app)["device"] for app in apps]
    assert docs[1] == docs[0] == {"compile_cache": {}}
    assert telemetry.memory_snapshot("cpu") is None
