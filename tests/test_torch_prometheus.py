"""The port's Prometheus exposition (``gordo_tpu_torch/server/prometheus/``)
against the JAX package's (``gordo_tpu/server/prometheus/``, on
``prometheus_client``), on the CPU.

The same observations go to the JAX metric objects and to the port's, each
on a fresh registry, and both texts are compared: parsed with
``prometheus_client.parser.text_string_to_metric_families`` (families'
names, types and HELP; samples' names, labels and values, ``_created`` by
presence) and as text with the ``_created`` values masked. The scrape-time
collectors read one fixed state on both sides: the JAX package's one store,
stream plane and device counters, and two port apps whose stores and
planes add up to the same; the health ledgers and SLO statuses are made
alike in both packages. Through the real apps, timed values (latency
buckets and sums) cannot agree, so those compare counts and label sets.

The fleet build's series come from a two-machine JAX ``FleetBuilder`` and
the port's ``build-fleet`` on the same config: the difference of each
process registry across the build (other tests feed the JAX registry), in
counts and label sets, not durations.
"""

import gc
import io
import json
import math
import os
import re
import subprocess
import sys
import threading
import time
import urllib.request

import jax
import numpy as np
import prometheus_client
import prometheus_client.multiprocess
import pytest
from prometheus_client.parser import text_string_to_metric_families
from werkzeug.test import Client

from gordo_tpu import serializer as jax_serializer
from gordo_tpu import stream as jax_stream
from gordo_tpu.builder import local_build
from gordo_tpu.server import build_app as jax_build_app
from gordo_tpu.server import fleet_store as jax_fleet_store
from gordo_tpu.server.prometheus import metrics as jax_metrics
from gordo_tpu.telemetry import aggregate as jax_aggregate
from gordo_tpu.telemetry import device as jax_device
from gordo_tpu.telemetry import fleet_health as jax_fleet_health
from gordo_tpu.telemetry import slo as jax_slo
from gordo_tpu_torch import serializer
from gordo_tpu_torch.serve.engine import ServeConfig
from gordo_tpu_torch.server import app as port_app_module
from gordo_tpu_torch.server import build_app
from gordo_tpu_torch.server.prometheus import metrics as port_metrics
from gordo_tpu_torch.server.prometheus import registry as port_registry
from gordo_tpu_torch.server.prometheus.server import build_metrics_app
from gordo_tpu_torch.telemetry import aggregate, fleet_health
from gordo_tpu_torch.telemetry import device as port_device
from gordo_tpu_torch.telemetry import slo as port_slo

from gordo_tpu_torch.models.anomaly.diff import DiffBasedAnomalyDetector

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
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


def _frame(tags, rows, seed):
    """``rows`` 10-minute rows of ``tags``."""
    rng = np.random.RandomState(seed)
    index = [f"2020-03-01T{(10 * i) // 60:02d}:{(10 * i) % 60:02d}:00+00:00" for i in range(rows)]
    values = rng.rand(len(tags), rows) * 2 - 0.5
    return {tag: {index[i]: float(values[t, i]) for i in range(rows)} for t, tag in enumerate(tags)}


def families(text):
    """``[(name, type, help, [(sample, labels, value)])]``, ``_created``
    values as None and NaN as the string ``nan``."""
    out = []
    for family in text_string_to_metric_families(text):
        samples = []
        for s in family.samples:
            value = None if s.name.endswith("_created") else ("nan" if math.isnan(s.value) else s.value)
            samples.append((s.name, tuple(sorted(s.labels.items())), value))
        out.append((family.name, family.type, family.documentation, samples))
    return out


def masked(text):
    return re.sub(r"^(\S*_created(?:\{.*\})?) \S+$", r"\1 T", text, flags=re.M)


def jax_text(registry):
    return prometheus_client.generate_latest(registry).decode()


def port_text(registry):
    return port_registry.generate_latest(registry).decode()


def sample_value(registry, name, labels):
    """The value of one sample of the port's ``registry``, or None."""
    for metric in registry.collect():
        for sample in metric.samples:
            if sample.name == name and sample.labels == labels:
                return sample.value
    return None


def assert_same(jax_registry, port_reg):
    expected, got = jax_text(jax_registry), port_text(port_reg)
    assert families(got) == families(expected)
    assert masked(got) == masked(expected)


# -- the fixed state both packages' collectors read -----------------------------------

MEMORY = {"devices": 1, "measured_devices": 1, "available": True, "bytes_in_use": 123456789,
          "peak_bytes_in_use": 987654321, "bytes_limit": 85520809984}
COUNTERS = {"build": {"compiles": 3, "cache_hits": 11, "hit_rate": 0.7857}, "serve": {"compiles": 1, "cache_hits": 0,
                                                                                      "hit_rate": 0.0}}
#: (revision stats, program cache stats, stream sessions, stream telemetry's counts) of each port app
APP_PARTS = [
    ({"1700000000000": {"model_bytes": 100, "stacked_bytes": 200, "cast_bytes": 0}},
     {"programs": 2, "signatures": 3, "by_precision": {"f32": 2}},
     {"p/s1": {"closed": False, "subscribers": 2, "events_dropped_outbox": 1, "events_dropped_emit": 0,
               "machines": {"m-1": {"rows_pending": 5, "quarantined": False},
                            "m-2": {"rows_pending": 0, "quarantined": True}}}},
     (100, 90, 2, 3, 7, [1, 0, 2], 12.5, [0, 4, 1], 30.25)),
    ({"1700000000000": {"model_bytes": 1, "stacked_bytes": 2, "cast_bytes": 3},
      "1690000000000": {"model_bytes": 10, "stacked_bytes": 0, "cast_bytes": 7}},
     {"programs": 1, "signatures": 0, "by_precision": {"bf16": 1}},
     {"p/s2": {"closed": True, "subscribers": 0, "events_dropped_outbox": 0, "events_dropped_emit": 4,
               "machines": {"m-3": {"rows_pending": 2, "quarantined": False}}}},
     (20, 10, 0, 0, 1, [0, 1, 0], 4.0, [0, 0, 9], 1.5)),
]


def _histogram(counts, sum_ms, edges):
    full = list(counts) + [0] * (len(edges) + 1 - len(counts))
    return {"buckets_ms": list(edges), "counts": full, "count": sum(full), "sum_ms": sum_ms}


def _telemetry(parts, edges):
    rows_in, scored, failed, shed, flushes, flush_counts, flush_sum, lag_counts, lag_sum = parts
    return {"rows_in": rows_in, "rows_scored": scored, "rows_failed": failed, "rows_shed": shed, "flushes": flushes,
            "ingest_batches": 0, "flush_ms": _histogram(flush_counts, flush_sum, edges),
            "lag_ms": _histogram(lag_counts, lag_sum, edges)}


class FakeStore:
    def __init__(self, revisions, programs):
        self.revisions, self.programs = revisions, programs

    def revision_stats(self):
        return self.revisions

    def program_cache_stats(self, engine=None):
        return self.programs


class FakePlane:
    def __init__(self, sessions, telemetry):
        self.sessions, self.telemetry = sessions, telemetry

    def stats(self):
        return {"sessions": self.sessions, "telemetry": self.telemetry}


class FakeTelemetry:
    def __init__(self, snapshot):
        self._snapshot = snapshot

    def snapshot(self):
        return self._snapshot


class FakeApp:
    def __init__(self, part):
        revisions, programs, sessions, counts = part
        self.store = FakeStore(revisions, programs)
        self.engine = None
        self.plane = FakePlane(sessions, _telemetry(counts, aggregate.LATENCY_BUCKETS_MS))


def _summed():
    """The two apps' parts as the JAX package's one store and plane hold them."""
    revisions, programs, sessions = {}, {"programs": 0, "signatures": 0, "by_precision": {}}, {}
    counts = None
    for part_revisions, part_programs, part_sessions, part_counts in APP_PARTS:
        for revision, stats in part_revisions.items():
            merged = revisions.setdefault(revision, {"model_bytes": 0, "stacked_bytes": 0, "cast_bytes": 0})
            for key in merged:
                merged[key] += stats[key]
        programs["programs"] += part_programs["programs"]
        programs["signatures"] += part_programs["signatures"]
        for prec, n in part_programs["by_precision"].items():
            programs["by_precision"][prec] = programs["by_precision"].get(prec, 0) + n
        sessions.update(part_sessions)
        counts = part_counts if counts is None else tuple(
            [x + y for x, y in zip(a, b)] if isinstance(a, list) else a + b for a, b in zip(counts, part_counts))
    return revisions, programs, sessions, counts


def _record_ledger(ledger, seed):
    """The same records into a ledger of either package."""
    rng = np.random.RandomState(seed)
    for i in range(5):
        name = f"m-{seed}-{i}"
        ledger.record_build(name, final_loss=float(rng.rand()), revision=REVISION, failed=i == 3)
        for _ in range(3):
            ledger.record_request(name, error=bool(i == 1))


SLO_DOC = {
    "slos": [{"name": "availability", "budget": {"remaining_ratio": 0.25}, "burn_rates": {"1h": 14.5, "6h": 3.25}},
             {"name": "full-route-p95", "budget": {"remaining_ratio": 1.0}, "burn_rates": {"1h": 0.0, "6h": 0.0}}],
    "alerts": [{"slo": "availability", "state": "firing"}, {"slo": "availability", "state": "pending"},
               {"slo": "full-route-p95", "state": "resolved"}],
}


@pytest.fixture
def same_state(monkeypatch, tmp_path):
    """Both packages' collectors over one state (see the module docstring)."""
    assert tuple(jax_aggregate.LATENCY_BUCKETS_MS) == tuple(aggregate.LATENCY_BUCKETS_MS)
    revisions, programs, sessions, counts = _summed()
    monkeypatch.setattr(jax_fleet_store, "STORE", FakeStore(revisions, programs))
    monkeypatch.setattr(jax_fleet_store, "program_cache_stats", lambda: programs)
    jax_telemetry = _telemetry(counts, jax_aggregate.LATENCY_BUCKETS_MS)
    monkeypatch.setattr(jax_stream, "get_plane", lambda: FakePlane(sessions, jax_telemetry))
    monkeypatch.setattr(jax_stream, "stream_telemetry", lambda: FakeTelemetry(jax_telemetry))
    apps = [FakeApp(part) for part in APP_PARTS]
    monkeypatch.setattr(port_app_module, "live_apps", lambda: apps)
    for module in (jax_device, port_device):
        monkeypatch.setattr(module, "memory_snapshot", lambda *a, **k: dict(MEMORY))
        monkeypatch.setattr(module, "program_cache_counters", lambda: {k: dict(v) for k, v in COUNTERS.items()})
    # the health ledgers: two directories, alike in both packages
    monkeypatch.setattr(jax_fleet_health, "_ledgers", {})
    monkeypatch.setattr(fleet_health, "_made_ledgers", {})
    monkeypatch.setattr(fleet_health, "_serving_ledgers", {})
    monkeypatch.setenv("GORDO_TPU_HEALTH_HEARTBEAT", "3600")
    kept = []
    for seed, kind in ((1, "build"), (2, "serving")):
        # a directory each: a ledger adopts the snapshot it finds
        _record_ledger(jax_fleet_health.ledger_for(str(tmp_path / "jax" / f"ledger-{seed}")), seed)
        directory = str(tmp_path / f"ledger-{seed}")
        kept.append(fleet_health.ledger_for(directory) if kind == "build" else fleet_health.serving_ledger(directory))
        _record_ledger(kept[-1], seed)
    # the SLO statuses
    monkeypatch.setenv("GORDO_TPU_SLO_SCRAPE_REFRESH", "0")
    for module in (jax_slo, port_slo):
        monkeypatch.setattr(module, "_statuses", {})
        monkeypatch.setattr(module, "_watched", set())
        module.note_status(str(tmp_path / "telemetry"), json.loads(json.dumps(SLO_DOC)))
    yield kept


COLLECTORS = ["ProgramCacheCollector", "StoreResidencyCollector", "FleetHealthCollector",
              "DeviceUtilizationCollector", "SloCollector", "StreamPlaneCollector"]


@pytest.mark.parametrize("name", COLLECTORS)
def test_collector_matches_jax(same_state, name):
    jax_registry, port_reg = prometheus_client.CollectorRegistry(), port_registry.CollectorRegistry()
    jax_registry.register(getattr(jax_metrics, name)())
    port_reg.register(getattr(port_metrics, name)())
    assert_same(jax_registry, port_reg)


def test_collectors_of_an_empty_process_match_jax(monkeypatch):
    """No store, plane, ledger or SLO status on either side."""
    monkeypatch.setattr(jax_fleet_store, "STORE", FakeStore({}, None))
    monkeypatch.setattr(jax_fleet_store, "program_cache_stats", lambda: {"programs": 0, "signatures": 0})
    monkeypatch.setattr(jax_stream, "get_plane", lambda: None)
    empty = _telemetry((0, 0, 0, 0, 0, [], 0.0, [], 0.0), jax_aggregate.LATENCY_BUCKETS_MS)
    monkeypatch.setattr(jax_stream, "stream_telemetry", lambda: FakeTelemetry(empty))
    monkeypatch.setattr(port_app_module, "live_apps", lambda: [])
    for module in (jax_device, port_device):
        monkeypatch.setattr(module, "memory_snapshot", lambda *a, **k: {"available": False})
        monkeypatch.setattr(module, "program_cache_counters", lambda: {})
    monkeypatch.setattr(jax_fleet_health, "_ledgers", {})
    monkeypatch.setattr(fleet_health, "_made_ledgers", {})
    monkeypatch.setattr(fleet_health, "_serving_ledgers", {})
    for module in (jax_slo, port_slo):
        monkeypatch.setattr(module, "_statuses", {})
        monkeypatch.setattr(module, "_watched", set())
    jax_registry, port_reg = prometheus_client.CollectorRegistry(), port_registry.CollectorRegistry()
    jax_metrics.register_program_cache_collector(jax_registry)
    jax_metrics.register_fleet_console_collectors(jax_registry)
    port_metrics.register_program_cache_collector(port_reg)
    port_metrics.register_fleet_console_collectors(port_reg)
    assert_same(jax_registry, port_reg)


def test_ledger_summaries_cover_live_builders_and_serving(same_state, tmp_path):
    """A directory's build ledger counts until the serving ledger of the
    directory takes its place; both stay, whatever the collector does,
    until ``reset_ledgers``, as the JAX package keeps its ledgers."""
    summaries = fleet_health.ledger_summaries()
    assert sorted(summaries) == sorted(str(tmp_path / f"ledger-{s}") for s in (1, 2))
    build_dir = str(tmp_path / "ledger-1")
    assert summaries[build_dir] == jax_fleet_health.ledger_summaries()[str(tmp_path / "jax" / "ledger-1")]
    serving = fleet_health.serving_ledger(build_dir)
    assert fleet_health.ledger_summaries()[build_dir] == serving.summary()
    same_state.clear()
    del serving
    gc.collect()
    assert sorted(fleet_health.ledger_summaries()) == sorted(summaries)
    fleet_health.reset_ledgers()
    assert fleet_health.ledger_summaries() == {}


# -- the request RED set and the stages --------------------------------------------------

class Observed:
    """A request and its response as each package's observer reads them."""

    def __init__(self, method, path, status, stages, endpoint):
        self.method, self.path = method, path
        self.status = self.status_code = status
        self.stage_durations = self.gordo_stage_durations = stages
        self.endpoint = self.gordo_endpoint = endpoint


AWKWARD = 'we"ird\\pro\nject'
OBSERVATIONS = {
    "model": [("POST", f"/gordo/v0/{PROJECT}/machine-1/anomaly/prediction", 200,
               {"model_resolve": 0.0004, "data_decode": 0.003, "inference": 0.02, "serialize": 0.07},
               "anomaly-prediction", 0.1)] * 2,
    "project-level": [("GET", f"/gordo/v0/{PROJECT}/models", 200, {"serialize": 0.0001}, "models", 0.002),
                      ("GET", f"/gordo/v0/{PROJECT}/slo", 404, {"serialize": 0.0002}, "slo", 0.004)],
    "revision": [("DELETE", f"/gordo/v0/{PROJECT}/machine-1/revision/1602324482000", 409, {"serialize": 0.0003},
                  "delete-revision", 0.003)],
    "unmatched": [("GET", "/wp-admin/setup.php", 404, {"serialize": 0.0001}, None, 0.001),
                  ("GET", "/.env", 404, {}, None, 0.001)],
    "healthcheck": [("GET", "/healthcheck", 200, {}, "healthcheck", 0.0001),
                    ("GET", "/server-version", 200, {}, "server-version", 0.0002)],
    "errors": [("POST", f"/gordo/v0/{PROJECT}/machine-2/prediction", 500, {"inference": 1.5}, "prediction", 2.0),
               ("POST", f"/gordo/v0/{PROJECT}/machine-2/prediction", 504, {"queue_wait": 31.0}, "prediction", 40.0)],
    "awkward": [("GET", f"/gordo/v0/{PROJECT}/machine-1/metadata", 200, {'st"a\\ge\n': 0.01}, 'end"point\\',
                 0.02)],
}


@pytest.mark.parametrize("case", sorted(OBSERVATIONS))
@pytest.mark.parametrize("project", [PROJECT, None, AWKWARD])
def test_request_metrics_match_jax(same_state, case, project):
    jax_registry, port_reg = prometheus_client.CollectorRegistry(), port_registry.CollectorRegistry()
    jax_red = jax_metrics.GordoServerPrometheusMetrics(project=project, registry=jax_registry)
    port_red = port_metrics.GordoServerPrometheusMetrics(project=project, registry=port_reg)
    for method, path, status, stages, endpoint, seconds in OBSERVATIONS[case]:
        observed = Observed(method, path, status, stages, endpoint)
        jax_red.observe(observed, observed, seconds)
        port_red.observe(observed, observed, seconds)
    assert_same(jax_registry, port_reg)


def test_stage_series_count_under_each_project(same_state):
    """With no PROJECT the project label comes from each request's URL. The
    JAX package caches its stage children by (endpoint, stage), so a second
    project's stages count under the first one's (the reference's series,
    still pinned here); the port keys them by project too and counts each
    project's stages under its own label (ROADMAP queue 3, fault 4, fixed
    on the port side). Every other family is the JAX package's."""
    jax_registry, port_reg = prometheus_client.CollectorRegistry(), port_registry.CollectorRegistry()
    jax_red = jax_metrics.GordoServerPrometheusMetrics(project=None, registry=jax_registry)
    port_red = port_metrics.GordoServerPrometheusMetrics(project=None, registry=port_reg)
    for project in ("first", "second"):
        observed = Observed("POST", f"/gordo/v0/{project}/machine-1/anomaly/prediction", 200, {"inference": 0.02},
                            "anomaly-prediction")
        jax_red.observe(observed, observed, 0.1)
        port_red.observe(observed, observed, 0.1)
    stage_family = "gordo_server_stage_duration_seconds"
    assert ([f for f in families(port_text(port_reg)) if not f[0].startswith(stage_family)]
            == [f for f in families(jax_text(jax_registry)) if not f[0].startswith(stage_family)])
    requests = {"method": "POST", "path": "/gordo/v0/{project}/{name}/anomaly/prediction", "status_code": "200",
                "gordo_name": "machine-1"}
    stage = {"endpoint": "anomaly-prediction", "stage": "inference"}
    assert jax_registry.get_sample_value("gordo_server_requests_total", {**requests, "project": "second"}) == 1
    assert jax_registry.get_sample_value(f"{stage_family}_count", {**stage, "project": "first"}) == 2
    assert jax_registry.get_sample_value(f"{stage_family}_count", {**stage, "project": "second"}) is None
    assert sample_value(port_reg, "gordo_server_requests_total", {**requests, "project": "second"}) == 1
    for project in ("first", "second"):
        assert sample_value(port_reg, f"{stage_family}_count", {**stage, "project": project}) == 1
        assert sample_value(port_reg, f"{stage_family}_sum", {**stage, "project": project}) == 0.02


def test_two_apps_share_one_registry(tmp_path):
    """A second app's metric set on the same registry registers nothing
    twice, and both count into the same families."""
    registry = port_registry.CollectorRegistry()
    first = port_metrics.create_prometheus_metrics("a", registry)
    second = port_metrics.create_prometheus_metrics("b", registry)
    assert first.request_count is second.request_count
    port_metrics.ServeMetrics("a", registry)
    port_metrics.ServeMetrics("b", registry)
    text = port_text(registry)
    assert text.count("# TYPE gordo_server_requests_total counter") == 1
    assert 'gordo_server_info{project="a",version=' in text and 'gordo_server_info{project="b",version=' in text
    with pytest.raises(ValueError, match="Duplicated timeseries"):
        port_registry.Counter("gordo_server_requests_total", "again", registry=registry)


def test_concurrent_observations_lose_nothing():
    """More threads than cores on the same and new label children, with a
    short switch interval: every increment and observation counted, one
    child a label set."""
    registry = port_registry.CollectorRegistry()
    counter = port_registry.Counter("stress_total", "stress", labelnames=["k"], registry=registry)
    histogram = port_registry.Histogram("stress_seconds", "stress", labelnames=["k"], registry=registry)
    threads, rounds = 4 * (os.cpu_count() or 2), 300
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(i):
            for j in range(rounds):
                key = str(j % 7)
                counter.labels(k=key).inc()
                histogram.labels(k=key).observe(0.01 * (i % 3))

        workers = [threading.Thread(target=work, args=(i,)) for i in range(threads)]
        for worker in workers:
            worker.start()
        for worker in workers:
            worker.join(timeout=60)
        assert not any(worker.is_alive() for worker in workers)
    finally:
        sys.setswitchinterval(interval)
    samples = {(s.name, s.labels.get("k")): s.value for m in registry.collect() for s in m.samples}
    assert sum(v for (name, _), v in samples.items() if name == "stress_total") == threads * rounds
    assert sum(v for (name, _), v in samples.items() if name == "stress_seconds_count") == threads * rounds
    assert sum(1 for name, _ in samples if name == "stress_total") == 7


@pytest.mark.parametrize("name", port_metrics.MULTIPROC_ENV)
def test_multiprocess_dir_is_refused(monkeypatch, tmp_path, name):
    """The directory the one-process server once refused now selects the
    multi-process exposition, as in JAX: ``build_app`` makes it, the app's
    metrics count into this process's files there on a registry of their
    own (not ``REGISTRY``), and ``build_metrics_app()`` serves the fan-in,
    which equals ``prometheus_client``'s reading of the same files."""
    directory = tmp_path / "mp"
    for other in port_metrics.MULTIPROC_ENV:
        monkeypatch.delenv(other, raising=False)
    monkeypatch.setenv(name, str(directory))
    monkeypatch.setenv("ENABLE_PROMETHEUS", "true")
    monkeypatch.setenv("GORDO_TPU_TELEMETRY", "0")
    app = build_app(str(tmp_path), device="cpu")
    assert directory.is_dir()
    assert app.prometheus_metrics.registry is not port_registry.REGISTRY
    Client(app).get("/server-version")
    metrics = port_metrics.create_prometheus_metrics("p", port_registry.CollectorRegistry())
    metrics.request_count.labels(method="GET", path="/x", status_code="200", gordo_name="", project="p").inc(3)
    pid = os.getpid()
    assert {f"counter_{pid}.db", f"histogram_{pid}.db", f"gauge_max_{pid}.db"} <= set(os.listdir(directory))
    text = Client(build_metrics_app()).get("/metrics").get_data().decode()
    fan_in = {name: samples for name, _, _, samples in families(text) if name.startswith("gordo_server_request")}
    theirs = prometheus_client.CollectorRegistry()
    prometheus_client.multiprocess.MultiProcessCollector(theirs, path=str(directory))
    assert fan_in == {name: samples for name, _, _, samples in families(jax_text(theirs)) if name in fan_in}
    assert sum(value for _, labels, value in fan_in["gordo_server_requests"]) == 4.0


# -- the engine's sink ---------------------------------------------------------------------

def _serve_calls(sink):
    sink.observe_batch(size=3, occupancy=0.75, padding_waste=0.4)
    sink.observe_batch(size=32, occupancy=1.0, padding_waste=0.0)
    sink.observe_shed("queue_full")
    sink.observe_shed("deadline", 4)
    sink.observe_breaker("open")
    sink.observe_breaker("half_open")
    sink.set_breaker_open(1)
    sink.set_queue_depth(17)


@pytest.mark.parametrize("project", ["p", None])
def test_serve_metrics_match_jax(same_state, project):
    jax_registry, port_reg = prometheus_client.CollectorRegistry(), port_registry.CollectorRegistry()
    _serve_calls(jax_metrics.ServeMetrics(project=project, registry=jax_registry))
    _serve_calls(port_metrics.ServeMetrics(project=project, registry=port_reg))
    assert_same(jax_registry, port_reg)


# -- through the apps ------------------------------------------------------------------------

@pytest.fixture(scope="module")
def collections(tmp_path_factory):
    """``(jax_dir, port_dir)``: the same two detectors in both packages."""
    root = tmp_path_factory.mktemp("torch-prometheus")
    jax_dir, port_dir = root / "jax" / REVISION, root / "port" / REVISION
    for model, machine in local_build(CONFIG, project_name=PROJECT):
        jax_serializer.dump(model, str(jax_dir / machine.name), metadata=machine.to_dict())
        with open(jax_dir / machine.name / "metadata.json") as f:
            metadata = json.load(f)
        serializer.dump(port_detector(model), str(port_dir / machine.name), metadata=metadata)
    return str(jax_dir), str(port_dir)


@pytest.fixture
def prometheus_env(monkeypatch):
    for name in ("GORDO_TPU_BATCHING", "GORDO_TPU_TELEMETRY", "GORDO_TPU_TRACE_SAMPLE_RATE",
                 *port_metrics.MULTIPROC_ENV):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("ENABLE_PROMETHEUS", "true")
    monkeypatch.setenv("PROJECT", PROJECT)
    monkeypatch.setenv("GORDO_TPU_SERVE_WARMUP", "0")
    monkeypatch.setenv("GORDO_TPU_FLEET_HEALTH", "0")


def _request(method, path, body=None):
    return method, path, body


APP_REQUESTS = {
    "model": _request("POST", f"/gordo/v0/{PROJECT}/machine-1/anomaly/prediction",
                      {"X": _frame(TAGS["machine-1"], 20, 1), "y": _frame(TAGS["machine-1"], 20, 2)}),
    "metadata": _request("GET", f"/gordo/v0/{PROJECT}/machine-1/metadata"),
    "project-level": _request("GET", f"/gordo/v0/{PROJECT}/models"),
    "fleet": _request("POST", f"/gordo/v0/{PROJECT}/prediction/fleet",
                      {"X": {n: _frame(TAGS[n], 20, 3) for n in NAMES}}),
    "revision": _request("DELETE", f"/gordo/v0/{PROJECT}/machine-1/revision/{REVISION}"),
    "unmatched": _request("GET", "/wp-admin/setup.php"),
    "healthcheck": _request("GET", "/healthcheck"),
    "bad-request": _request("POST", f"/gordo/v0/{PROJECT}/machine-1/prediction", {"no": "X"}),
}
#: the families the apps' requests feed; their time-valued samples are compared by count
RED = ("gordo_server_requests", "gordo_server_request_duration_seconds", "gordo_server_request_errors",
       "gordo_server_stage_duration_seconds", "gordo_server_info")


def red_series(text):
    """The RED families, a timed histogram's buckets and sum left out."""
    out = []
    for name, typ, doc, samples in families(text):
        if not name.startswith(RED):
            continue
        timed = name.startswith(("gordo_server_request_duration", "gordo_server_stage_duration"))
        out.append((name, typ, doc, [(s, labels, value) for s, labels, value in samples
                                     if not (timed and s.endswith(("_bucket", "_sum")))]))
    return out


@pytest.mark.parametrize("case", sorted(APP_REQUESTS))
def test_app_requests_feed_the_same_series(collections, prometheus_env, monkeypatch, case):
    jax_dir, port_dir = collections
    monkeypatch.setenv("MODEL_COLLECTION_DIR", jax_dir)
    jax_fleet_store.STORE.invalidate(jax_dir)
    jax_registry, port_reg = prometheus_client.CollectorRegistry(), port_registry.CollectorRegistry()
    jax_client = Client(jax_build_app(config={"EXPECTED_MODELS": [], "ENABLE_PROMETHEUS": True, "PROJECT": PROJECT},
                                      prometheus_registry=jax_registry))
    port_client = Client(build_app(port_dir, device="cpu", prometheus_registry=port_reg))
    method, path, body = APP_REQUESTS[case]
    statuses = []
    for client in (jax_client, port_client):
        for _ in range(2):
            data = None if body is None else json.dumps(body)
            statuses.append(client.open(path, method=method, data=data, content_type="application/json").status_code)
    assert len(set(statuses)) == 1, statuses
    assert red_series(port_text(port_reg)) == red_series(jax_text(jax_registry))


def test_engine_batches_counted(collections, prometheus_env, monkeypatch):
    """The engine's batches, each observed once; a failing sink changes no answer."""
    _, port_dir = collections
    registry = port_registry.CollectorRegistry()
    app = build_app(port_dir, device="cpu", serve_config=ServeConfig(max_delay_ms=20.0, deadline_ms=30000.0),
                    prometheus_registry=registry)
    try:
        client = Client(app)
        body = {"X": _frame(TAGS["machine-1"], 20, 1), "y": _frame(TAGS["machine-1"], 20, 2)}
        answers = []

        def post(name):
            frame = {"X": _frame(TAGS[name], 20, 5), "y": _frame(TAGS[name], 20, 6)}
            answers.append(Client(app).post(f"/gordo/v0/{PROJECT}/{name}/anomaly/prediction", json=frame).status_code)

        threads = [threading.Thread(target=post, args=(NAMES[i % 2],)) for i in range(6)]
        for thread in threads:
            thread.start()
        for thread in threads:
            thread.join(timeout=60)
        assert answers == [200] * 6
        stats = app.engine.stats()
        assert sample_value(registry, "gordo_server_batch_size_count", {"project": PROJECT}) == stats["batches"]
        assert sample_value(registry, "gordo_server_batch_size_sum", {"project": PROJECT}) == stats["coalesced"]
        assert sample_value(registry, "gordo_server_batch_queue_depth", {"project": PROJECT}) == 0
        served = sample_value(registry, "gordo_server_requests_total", {
            "method": "POST", "path": "/gordo/v0/{project}/{name}/anomaly/prediction", "status_code": "200",
            "gordo_name": NAMES[0], "project": PROJECT})
        assert served == 3

        def broken(*args, **kwargs):
            raise RuntimeError("a metric failed")

        monkeypatch.setattr(app.prometheus_metrics, "observe", broken)
        monkeypatch.setattr(app.engine.metrics, "observe_batch", broken)
        assert client.post(f"/gordo/v0/{PROJECT}/machine-1/anomaly/prediction", json=body).status_code == 200
    finally:
        app.shutdown()


def test_engine_sheds_counted(collections, prometheus_env):
    """A one-deep queue held for a second sheds the burst's late arrivals
    with 429; the shed counter grows by the engine's own shed counts."""
    _, port_dir = collections
    registry = port_registry.CollectorRegistry()
    app = build_app(port_dir, device="cpu", prometheus_registry=registry,
                    serve_config=ServeConfig(max_delay_ms=1000.0, queue_depth=1, deadline_ms=30000.0))
    try:
        answers = []

        def post(name):
            frame = {"X": _frame(TAGS[name], 20, 5), "y": _frame(TAGS[name], 20, 6)}
            answers.append(Client(app).post(f"/gordo/v0/{PROJECT}/{name}/anomaly/prediction", json=frame).status_code)

        threads = [threading.Thread(target=post, args=(NAMES[i % 2],)) for i in range(6)]
        for thread in threads:
            thread.start()
        for thread in threads:
            thread.join(timeout=60)
        stats = app.engine.stats()
        assert sorted(set(answers)) == [200, 429] and answers.count(429) == stats["shed_queue_full"]
        for reason in ("queue_full", "deadline", "runner_error"):
            counted = sample_value(registry, "gordo_server_batch_shed_total", {"project": PROJECT, "reason": reason})
            assert (counted or 0) == stats.get(f"shed_{reason}", 0), reason
    finally:
        app.shutdown()


def test_metrics_app_answers_scrapes(prometheus_env):
    registry = port_registry.CollectorRegistry()
    port_metrics.create_prometheus_metrics(PROJECT, registry)
    client = Client(build_metrics_app(registry))
    for path in ("/metrics", "/", "/metrics/"):
        response = client.get(path)
        assert response.status_code == 200
        assert response.headers["Content-Type"] == "text/plain; version=0.0.4; charset=utf-8"
        assert response.get_data() == port_registry.generate_latest(registry)
    assert client.get("/nope").status_code == 404


def test_server_command_serves_metrics(collections, tmp_path):
    """``python -m gordo_tpu_torch.server --port 0 --metrics-port 0`` with
    ``ENABLE_PROMETHEUS``: a request to the server, then a scrape of the
    second port, which counts it."""
    _, port_dir = collections
    env = {k: v for k, v in os.environ.items() if k not in port_metrics.MULTIPROC_ENV}
    env.update(ENABLE_PROMETHEUS="true", MODEL_COLLECTION_DIR=port_dir, PROJECT=PROJECT, GORDO_TPU_FLEET_HEALTH="0",
               GORDO_TPU_TELEMETRY_DIR=str(tmp_path), PYTHONPATH=REPO)
    process = subprocess.Popen([sys.executable, "-m", "gordo_tpu_torch.server", "--host", "127.0.0.1", "--port", "0",
                                "--metrics-port", "0", "--device", "cpu"], env=env, stderr=subprocess.PIPE,
                               stdout=subprocess.DEVNULL, text=True)
    try:
        ports, deadline = {}, time.time() + 120
        while len(ports) < 2 and time.time() < deadline:
            line = process.stderr.readline()
            if not line:
                break
            found = re.search(r"(Prometheus metrics|listening) on http://127\.0\.0\.1:(\d+)", line)
            if found:
                ports[found.group(1)] = int(found.group(2))
        assert len(ports) == 2, f"the server logged {ports}"
        base = f"http://127.0.0.1:{ports['listening']}"
        with urllib.request.urlopen(f"{base}/gordo/v0/{PROJECT}/machine-1/metadata", timeout=30) as response:
            assert response.status == 200
        with urllib.request.urlopen(f"http://127.0.0.1:{ports['Prometheus metrics']}/metrics", timeout=30) as response:
            assert response.headers["Content-Type"] == "text/plain; version=0.0.4; charset=utf-8"
            text = response.read().decode()
        assert ('gordo_server_requests_total{gordo_name="machine-1",method="GET",path="/gordo/v0/{project}/{name}/'
                f'metadata",project="{PROJECT}",status_code="200"}} 1.0') in text
    finally:
        process.terminate()
        process.wait(timeout=30)
        process.stderr.close()


# -- the fleet build's series ------------------------------------------------------------------

BUILD_PROJECT = "metrics-parity"
DATASET = {"type": "RandomDataset", "train_start_date": "2020-01-01T00:00:00+00:00",
           "train_end_date": "2020-01-04T00:00:00+00:00"}
BUILD_CONFIG = {"machines": [
    {"name": f"mp-{i}", "dataset": {**DATASET, "tag_list": [f"t{i}-{j}" for j in range(3)]},
     "model": {"gordo_tpu.models.anomaly.diff.DiffBasedAnomalyDetector": {"base_estimator": {
         "sklearn.pipeline.Pipeline": {"steps": ["sklearn.preprocessing.MinMaxScaler", {
             "gordo_tpu.models.JaxAutoEncoder": {"kind": "feedforward_hourglass", "epochs": 1}}]}}}}}
    for i in range(2)]}
#: gauges whose values are times: compared by presence
TIMED_GAUGES = ("gordo_fleet_plan_actual_seconds",)


def build_series(text):
    """``{(sample, labels): value}`` of the ``gordo_fleet_*`` families:
    counters, gauges and histogram counts (no buckets or sums)."""
    out = {}
    for name, typ, _, samples in families(text):
        if not name.startswith("gordo_fleet_") or "health" in name:
            continue
        for sample, labels, value in samples:
            if sample.endswith(("_bucket", "_sum", "_created")):
                continue
            out[(sample, labels)] = None if sample.startswith(TIMED_GAUGES) else value
    return out


def series_delta(before, after):
    """What a build added: counters and counts as differences, gauges as read."""
    delta = {}
    for key, value in after.items():
        if key[0].endswith(("_total", "_count")):
            change = value - before.get(key, 0.0)
            if change:
                delta[key] = change
        elif before.get(key, "absent") != value or key[0].startswith(("gordo_fleet_build_machines",
                                                                     "gordo_fleet_plan")):
            delta[key] = value
    return delta


@pytest.fixture(scope="module")
def build_deltas(tmp_path_factory):
    from gordo_tpu.cli.workflow_generator import _machines_yaml as jax_machines_yaml
    from gordo_tpu.machine import Machine as JaxMachine
    from gordo_tpu.parallel import fleet as jax_fleet
    from gordo_tpu.parallel.fleet_build import FleetBuilder as JaxFleetBuilder
    from gordo_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from gordo_tpu.telemetry import reset_seen_programs as jax_reset_seen_programs
    from gordo_tpu.workflow.config_elements.normalized_config import NormalizedConfig as JaxNormalizedConfig
    from gordo_tpu.workflow.workflow_generator.workflow_generator import get_dict_from_yaml as jax_get_dict
    from gordo_tpu_torch import telemetry
    from gordo_tpu_torch.cli import cli
    from gordo_tpu_torch.workflow.workflow_generator import normalize

    root = tmp_path_factory.mktemp("build-metrics")
    text = json.dumps(BUILD_CONFIG)
    machines = JaxNormalizedConfig(jax_get_dict(io.StringIO(text)), BUILD_PROJECT).machines
    assert jax_machines_yaml(machines)
    (root / "port-shard.json").write_text(normalize(io.StringIO(text), BUILD_PROJECT))
    patch = pytest.MonkeyPatch()
    patch.setattr(jax_fleet, "make_mesh", lambda *a, **k: jax_make_mesh(jax.devices()[:1]))
    try:
        jax_reset_seen_programs()
        before = build_series(jax_text(prometheus_client.REGISTRY))
        JaxFleetBuilder([JaxMachine.from_config(m.to_dict(), project_name=BUILD_PROJECT) for m in machines]).build(
            output_dir=str(root / "jax" / REVISION))
        jax_delta = series_delta(before, build_series(jax_text(prometheus_client.REGISTRY)))
        telemetry.reset_seen_programs()
        before = build_series(port_text(port_registry.REGISTRY))
        code = cli.main(["build-fleet", str(root / "port-shard.json"), str(root / "port" / REVISION),
                         "--device", "cpu"])
        assert code == 0
        port_delta = series_delta(before, build_series(port_text(port_registry.REGISTRY)))
    finally:
        patch.undo()
    return jax_delta, port_delta, root


def _project_only(delta):
    return {key: value for key, value in delta.items() if ("project", BUILD_PROJECT) in key[1]}


def test_build_series_match_jax(build_deltas):
    jax_delta, port_delta, _ = build_deltas
    jax_delta, port_delta = _project_only(jax_delta), _project_only(port_delta)
    assert port_delta == jax_delta
    by_name = {key[0] for key in port_delta}
    assert {"gordo_fleet_build_phase_duration_seconds_count", "gordo_fleet_compile_duration_seconds_count",
            "gordo_fleet_member_final_loss_count", "gordo_fleet_build_machines_total",
            "gordo_fleet_plan_predicted_seconds", "gordo_fleet_plan_actual_compiles"} <= by_name
    assert port_delta[("gordo_fleet_member_final_loss_count", (("project", BUILD_PROJECT),))] == 2
    assert port_delta[("gordo_fleet_build_machines_completed", (("project", BUILD_PROJECT),))] == 2


def test_build_series_follow_the_files(build_deltas):
    """The port's series against what its build wrote: the phases of
    ``build_status.json``, the trace's first calls, the plan's prediction."""
    _, port_delta, root = build_deltas
    directory = root / "port" / REVISION
    status = json.loads((directory / "build_status.json").read_text())
    with open(directory / "build_trace.jsonl") as f:
        spans = [json.loads(line) for line in f]
    plan = json.loads((directory / "fleet_plan.json").read_text())
    phases = {dict(labels)["phase"]: value for (sample, labels), value in port_delta.items()
              if sample == "gordo_fleet_build_phase_duration_seconds_count"}
    assert set(phases) == set(status["phases"])
    assert phases == {p: sum(1 for s in spans if s["name"] == "build_phase" and s["attributes"]["phase"] == p)
                      for p in phases}
    compiles = sum(value for (sample, _), value in port_delta.items()
                   if sample == "gordo_fleet_compile_duration_seconds_count")
    assert compiles == sum(1 for s in spans if s["name"] == "device_program" and s["attributes"]["compile"])
    predicted = port_delta[("gordo_fleet_plan_predicted_seconds",
                            (("project", BUILD_PROJECT), ("strategy", "naive")))]
    assert predicted == plan["totals"]["predicted_wall_s"]


def test_a_failing_metric_never_fails_a_build(tmp_path, monkeypatch):
    from gordo_tpu_torch.cli import cli
    from gordo_tpu_torch.workflow.workflow_generator import normalize

    def broken(*args, **kwargs):
        raise RuntimeError("a metric failed")

    for helper in ("record_fleet_build_phase", "record_fleet_compile", "record_member_final_loss",
                   "set_fleet_build_progress", "set_fleet_plan_prediction", "set_fleet_plan_actuals"):
        monkeypatch.setattr(port_metrics, helper, broken)
    config = {"machines": BUILD_CONFIG["machines"][:1]}
    (tmp_path / "shard.json").write_text(normalize(io.StringIO(json.dumps(config)), BUILD_PROJECT))
    assert cli.main(["build-fleet", str(tmp_path / "shard.json"), str(tmp_path / REVISION), "--device", "cpu"]) == 0
    assert os.path.exists(tmp_path / REVISION / "mp-0" / "model.pkl")
