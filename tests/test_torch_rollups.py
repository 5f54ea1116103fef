"""The port's rollups (``gordo_tpu_torch/telemetry/aggregate.py``) held to
the JAX package's on the CPU: the same span files, in separate copies of
one directory, aggregated by ``RollupStore(dir).aggregate()`` of each
package.

The spans come from a numpy seed: requests with statuses, latencies,
stages (one nested) and machines, events, profile and engine
``serve_batch`` spans, stream ingests and flushes (lag histograms, shed
and failed rows, a flush without the scored split), build phases and
device programs, and lines that do not parse, duplicates across files,
a span without ids, one without a time and a torn tail. Also the
``serve_trace.jsonl`` the port's own app wrote for a few CPU requests.

Window files are compared byte for byte, ``rollup_state.json`` and the
manifest as JSON with the directory's path and the manifest's write time
taken out, the summaries and merged windows exactly: every number is a
count, a bucket count or a sum both packages add in the same order, so
no tolerance is needed.
"""

import datetime
import json
import os
import shutil

import numpy as np
import pytest
from werkzeug.test import Client

from gordo_tpu.server import build_app as jax_build_app
from gordo_tpu.server.fleet_store import STORE as JAX_STORE
from gordo_tpu.telemetry import aggregate as jax_aggregate
from gordo_tpu_torch.server import build_app
from gordo_tpu_torch.stream import telemetry as stream_telemetry
from gordo_tpu_torch.telemetry import aggregate
from gordo_tpu_torch.telemetry import slo
from tests.test_torch_request_tracing import (  # noqa: F401 - the fixture is used by name
    TAGS,
    _frame,
    _reset_globals,
    call,
    collections,
    read_trace,
    url,
)

NOW = 1_754_000_000.0
#: the pid of a worker that no longer runs (beyond any pid of this host)
DEAD_PID = 2**22 + 11
#: the settings the port keeps as constants, which the JAX package reads
JAX_ONLY_SETTINGS = ("GORDO_TPU_SLO_ROLLUP_KEEP", "GORDO_TPU_SLO_SINK_GC_AGE", "GORDO_TPU_ROLLUP_MANIFEST")


def iso(ts: float) -> str:
    return datetime.datetime.fromtimestamp(ts, datetime.timezone.utc).isoformat()


def _span(name, ts, ms, trace_id, span_id, parent_id=None, kind="internal", attributes=None, **extra):
    return {"name": name, "context": {"trace_id": trace_id, "span_id": span_id}, "parent_id": parent_id,
            "kind": kind, "start_time": iso(ts - ms / 1e3), "end_time": iso(ts), "duration_ms": ms,
            "status": {"status_code": "OK"}, "attributes": attributes or {}, "resource": {"service.name": "test"},
            **extra}


def serve_spans(seed, requests, t0=NOW, seconds=600.0, prefix=0):
    """A serving trace from ``seed``: ``requests`` request spans with their
    stages, one batch and one stream session a five requests, a profile."""
    rng = np.random.RandomState(seed)
    spans = []
    statuses = [200, 200, 200, 200, 201, 302, 404, 422, 500, 503, "oops"]
    machines = ["m-1", "m-2", "m-3", "", None]
    for i in range(requests):
        ts = t0 + float(np.round(rng.uniform(0.0, seconds), 3))
        wall = float(np.round(rng.lognormal(3.0, 1.5), 3))
        trace_id, span_id = f"{prefix:08x}{i:024x}", f"{prefix:04x}{i:012x}"
        status = statuses[rng.randint(len(statuses))]
        spans.append(_span("request", ts, wall, trace_id, span_id, kind="server", attributes={
            "http.status_code": status, "http.route": ["anomaly-prediction", "fleet-prediction"][i % 2],
            "gordo_name": machines[rng.randint(len(machines))]}))
        shares = rng.dirichlet(np.ones(4)) * wall
        for j, stage in enumerate(("data_decode", "inference", "serialize")):
            spans.append(_span(stage, ts, float(np.round(shares[j], 3)), trace_id, f"{span_id[:-1]}{j}",
                               parent_id=span_id))
        if i % 3 == 0:  # the engine's share, inside inference
            spans.append(_span("queue_wait", ts, float(np.round(shares[1] / 2, 3)), trace_id, f"{span_id[:-1]}q",
                               parent_id=f"{span_id[:-1]}1"))
        if i % 7 == 0:
            spans.append(_span("breaker_open", ts, 0.0, trace_id, f"{span_id[:-1]}e", parent_id=span_id,
                               kind="event"))
        if i % 5 == 0:
            batch = f"{prefix:04x}{i:011x}b"
            spans.append(_span("serve_batch", ts, float(np.round(wall / 3, 3)), f"{batch:0>32}", batch,
                               attributes={"program": "fleet_forward", "device_ms": float(np.round(wall / 4, 3)),
                                           "predicted_device_ms": [-1.0, float(np.round(wall / 5, 3))][i % 2]},
                               links=[{"context": {"trace_id": trace_id, "span_id": span_id}}]))
            rows = int(rng.randint(1, 200))
            stream = f"s-{i % 2}"
            spans.append(_span("stream_ingest", ts, 1.5, f"{batch:0>31}i", f"{batch[:-1]}i",
                               attributes={"stream": stream, "rows": rows}))
            lag = rng.multinomial(rows, np.ones(len(aggregate.LATENCY_BUCKETS_MS) + 1) / 19).tolist()
            score = {"stream": stream, "rows": rows, "windows": int(rng.randint(1, 4)), "lag_hist": lag,
                     "lag_sum_ms": float(np.round(rng.uniform(0, 1e4), 3)), "device_ms": 2.5,
                     "predicted_device_ms": 2.0, "lag_p50_ms": float(np.round(rng.uniform(0, 900), 3)),
                     "lag_max_ms": float(np.round(rng.uniform(900, 9000), 3))}
            if i % 10:  # a flush that ended early stamps no split
                shed, failed = int(rng.randint(0, 3)), int(rng.randint(0, 3))
                score.update(rows_scored=rows - shed - failed, rows_failed=failed, shed=shed)
            spans.append(_span("stream_score", ts + 0.01, 3.25, f"{batch:0>31}s", f"{batch[:-1]}s", attributes=score,
                               links=[{"context": {"trace_id": f"{batch:0>31}i", "span_id": f"{batch[:-1]}i"}}]))
            spans.append(_span("stream_emit", ts + 0.02, 0.5, f"{batch:0>31}s", f"{batch[:-1]}m",
                               parent_id=f"{batch[:-1]}s", attributes={"stream": stream, "events": 2}))
    spans.append(_span("profile", t0 + 1, 50.0, f"{prefix:08x}{0:024x}", f"{prefix:04x}{0:011x}p",
                       parent_id=f"{prefix:04x}{0:012x}", attributes={"frames": [
                           {"stage": "inference", "function": "a.py:f", "samples": 8, "self_ms": 40.0},
                           {"stage": "serialize", "function": "b.py:g", "samples": 2, "self_ms": 10.0}]}))
    no_ids = _span("request", t0 + 2, 5.0, "", "", kind="server", attributes={"http.status_code": 200})
    del no_ids["context"]
    untimed = _span("request", t0 + 3, 5.0, f"{prefix:08x}{'f' * 24}", f"{prefix:04x}{'f' * 12}", kind="server")
    untimed["end_time"] = "not a time"
    return spans + [no_ids, untimed]


def build_spans(seed, t0=NOW, prefix=0):
    rng = np.random.RandomState(seed)
    spans = []
    for i in range(40):
        ts = t0 + float(np.round(rng.uniform(0, 300), 3))
        trace_id, span_id = f"{prefix:08x}{i:024x}", f"{prefix:04x}b{i:011x}"
        if i % 2:
            spans.append(_span("device_program", ts, 12.0, trace_id, span_id,
                               attributes={"program": "fleet_fit", "compile": bool(i % 3)}))
        else:
            spans.append(_span("build_phase", ts, 100.0, trace_id, span_id,
                               attributes={"phase": ["data_fetch", "fit", "dump"][i % 3]}))
    spans.append(_span("machine_landed", t0, 0.0, f"{prefix:08x}{'e' * 24}", f"{prefix:04x}{'e' * 12}", kind="event"))
    return spans


def write_jsonl(path, spans, mode="w", junk=True, torn=False):
    """``spans`` as JSON lines, with lines that do not parse among them
    and, with ``torn``, a last line without its newline."""
    with open(path, mode) as f:
        for i, span in enumerate(spans):
            f.write(json.dumps(span) + "\n")
            if junk and i == 3:
                f.write("\nnot json\n[1, 2]\n{\"no\": \"name\"}\n")
        if torn:
            f.write(json.dumps(spans[0])[:40])


def rotate(path):
    """The recorder's rotation: ``p.1`` -> ``p.2``, ``p`` -> ``p.1``."""
    for n in (2, 1):
        if os.path.exists(f"{path}.{n}"):
            os.replace(f"{path}.{n}", f"{path}.{n + 1}")
    os.replace(path, f"{path}.1")


def layout(directory, kind, seed):
    """Sinks of ``kind`` in ``directory``: one serve and one build trace;
    a rotated chain; or worker variants (this process, a dead worker's
    day-old chain, a dead worker's fresh one) holding duplicates."""
    os.makedirs(directory, exist_ok=True)
    serve, build = serve_spans(seed, 120), build_spans(seed)
    serve_path = os.path.join(directory, "serve_trace.jsonl")
    if kind in ("single", "window"):
        write_jsonl(serve_path, serve, torn=True)
        write_jsonl(os.path.join(directory, "build_trace.jsonl"), build)
    elif kind == "rotated":
        for part in np.array_split(np.arange(len(serve)), 3):
            if os.path.exists(serve_path):
                rotate(serve_path)
            write_jsonl(serve_path, [serve[i] for i in part])
        write_jsonl(os.path.join(directory, "build_trace.jsonl.1"), build[:20])
        write_jsonl(os.path.join(directory, "build_trace.jsonl"), build[20:])
    else:
        live = os.path.join(directory, f"serve_trace-{os.getpid()}.jsonl")
        dead = os.path.join(directory, f"serve_trace-{DEAD_PID}.jsonl")
        fresh = os.path.join(directory, f"serve_trace-{DEAD_PID + 1}.jsonl")
        write_jsonl(live, serve[:60])
        write_jsonl(dead + ".1", serve[60:80])
        write_jsonl(dead, serve[80:100] + serve[:10])  # ten duplicates of the live worker's
        write_jsonl(fresh, serve[100:])
        write_jsonl(os.path.join(directory, f"build_trace-{DEAD_PID}.jsonl"), build)
        old = NOW - 2 * 86400  # a day past the garbage collector's age
        for path in (dead, dead + ".1"):
            os.utime(path, (old, old))
        with open(os.path.join(directory, f"fleet_health-{DEAD_PID}.json"), "w") as f:
            f.write("{}")


def grow(directory, kind, seed):
    """More spans, a later window, and a rotation between passes."""
    more = serve_spans(seed + 100, 40, t0=NOW + 900, prefix=1)
    name = f"serve_trace-{os.getpid()}.jsonl" if kind == "workers" else "serve_trace.jsonl"
    path = os.path.join(directory, name)
    if kind == "rotated":
        rotate(path)
        write_jsonl(path, more)
    elif kind in ("single", "window"):
        with open(path) as f:
            torn = f.read().rsplit("\n", 1)[1]
        with open(path, "a") as f:  # the torn line completed
            f.write(json.dumps(serve_spans(seed, 120)[0])[len(torn):] + "\n")
        write_jsonl(path, more, mode="a")
    else:
        write_jsonl(path, more, mode="a")


def copies(tmp_path, make):
    """``make(directory)`` once, copied (times kept) for each package."""
    source = str(tmp_path / "source")
    make(source)
    dirs = str(tmp_path / "jax"), str(tmp_path / "port")
    for directory in dirs:
        shutil.copytree(source, directory)
    return dirs


def rollup_files(directory):
    rollups = os.path.join(directory, aggregate.ROLLUP_DIR)
    return {name: open(os.path.join(rollups, name), "rb").read() for name in sorted(os.listdir(rollups))
            if name[: -len(".json")].isdigit()}


def state(directory):
    """``rollup_state.json`` and the manifest, the directory's path and
    the manifest's write time taken out."""
    rollups = os.path.join(directory, aggregate.ROLLUP_DIR)
    with open(os.path.join(rollups, aggregate.ROLLUP_STATE_FILE)) as f:
        files = json.loads(f.read().replace(directory, "D"))
    with open(os.path.join(rollups, aggregate.ROLLUP_MANIFEST_FILE)) as f:
        manifest = json.load(f)
    assert isinstance(manifest.pop("updated_at"), float)
    return files, manifest


def offsets(directory):
    files, _ = state(directory)
    return sum(entry["offset"] for entry in files["files"].values())


def assert_same_rollups(dirs):
    jax_dir, port_dir = dirs
    assert rollup_files(port_dir) == rollup_files(jax_dir)
    assert state(port_dir) == state(jax_dir)
    assert sorted(os.listdir(port_dir)) == sorted(os.listdir(jax_dir))


def stores(dirs):
    """A store of each directory, the window length read from the
    setting (60 s unless a test sets it)."""
    return jax_aggregate.RollupStore(dirs[0]), aggregate.RollupStore(dirs[1])


@pytest.fixture(autouse=True)
def clean_settings(monkeypatch):
    for name in JAX_ONLY_SETTINGS + ("GORDO_TPU_SLO_WINDOW_SECONDS", "GORDO_TPU_TELEMETRY_DIR"):
        monkeypatch.delenv(name, raising=False)


@pytest.mark.parametrize("kind", ["single", "rotated", "workers", "window"])
def test_rollups_match_jax(tmp_path, monkeypatch, kind):
    """Two passes with more spans (and a rotation) between them: equal
    window files, state, manifest and summaries; a pass over nothing new
    reads no byte in either; merged windows equal at several bounds."""
    if kind == "window":
        monkeypatch.setenv("GORDO_TPU_SLO_WINDOW_SECONDS", "300")
    dirs = copies(tmp_path, lambda d: layout(d, kind, seed=7))
    jax_store, port_store = stores(dirs)
    assert port_store.seconds == jax_store.seconds == (300 if kind == "window" else 60)
    assert aggregate.discover_sinks(dirs[1]) == [(k, p.replace(dirs[0], dirs[1]))
                                                 for k, p in jax_aggregate.discover_sinks(dirs[0])]
    first = jax_store.aggregate(), port_store.aggregate()
    assert first[1] == first[0] and first[1]["spans_read"] > 0
    if kind == "workers":  # the dead worker's day-old chain, read whole, is deleted; the fresh one stays
        assert first[1]["worker_sinks_pruned"] == 2
    assert_same_rollups(dirs)

    read = [offsets(d) for d in dirs]
    again = jax_store.aggregate(), port_store.aggregate()
    assert again[1] == again[0] and again[1]["spans_read"] == 0 and not again[1]["windows_updated"]
    assert [offsets(d) for d in dirs] == read  # no byte read
    assert_same_rollups(dirs)

    for directory in dirs:
        grow(directory, kind, seed=7)
    second = jax_store.aggregate(), port_store.aggregate()
    assert second[1] == second[0] and second[1]["spans_read"] > 0
    assert_same_rollups(dirs)
    for since, until in ((None, None), (NOW + 120, NOW + 500), (NOW + 600, None), (None, NOW)):
        merged = jax_store.merged(since, until), port_store.merged(since, until)
        assert merged[1] == merged[0]
        assert aggregate.summarize_rollup(merged[1]) == jax_aggregate.summarize_rollup(merged[0])
    assert [w["window"] for w in port_store.windows()] == [w["window"] for w in jax_store.windows()]
    fresh = stores(dirs)
    assert fresh[1].merged() == fresh[0].merged()  # another process, reading the manifest
    assert aggregate.sink_window_index(dirs[1]) == jax_aggregate.sink_window_index(dirs[0])


@pytest.mark.parametrize("first, then", [("jax", "port"), ("port", "jax")])
def test_directory_continued_by_the_other_package(tmp_path, first, then):
    """A directory aggregated by one package, then continued by the other
    after more spans and a rotation, ends as the JAX package leaves it
    doing both passes."""
    dirs = copies(tmp_path, lambda d: layout(d, "rotated", seed=3))
    modules = {"jax": jax_aggregate, "port": aggregate}
    reference, mixed = dirs
    for step, directory in ((first, mixed), ("jax", reference)):
        modules[step].RollupStore(directory).aggregate()
    for directory in dirs:
        grow(directory, "rotated", seed=3)
    summaries = (jax_aggregate.RollupStore(reference).aggregate(),
                 modules[then].RollupStore(mixed).aggregate())
    assert summaries[1] == summaries[0]
    assert_same_rollups(dirs)


def test_pruning_matches_jax(tmp_path, monkeypatch):
    """The oldest windows past the kept count are deleted, from the files
    and the manifest, in both (the port's count is a constant, set here as
    the JAX package's setting is)."""
    monkeypatch.setenv("GORDO_TPU_SLO_ROLLUP_KEEP", "3")
    monkeypatch.setattr(aggregate, "ROLLUP_KEEP", 3)
    dirs = copies(tmp_path, lambda d: layout(d, "single", seed=11))
    jax_store, port_store = stores(dirs)
    summaries = jax_store.aggregate(), port_store.aggregate()
    assert summaries[1] == summaries[0] and summaries[1]["rollups_pruned"] > 0
    assert len(rollup_files(dirs[1])) == 3
    assert_same_rollups(dirs)
    assert port_store.merged() == jax_store.merged()


def test_histograms_and_sinks_match_jax(tmp_path):
    """The helpers: the fixed buckets (the stream plane's too), a
    histogram's adds, merges (another edge set is binned again) and
    percentiles, span times, signatures and sink discovery."""
    assert aggregate.LATENCY_BUCKETS_MS == jax_aggregate.LATENCY_BUCKETS_MS
    assert stream_telemetry.LATENCY_BUCKETS_MS is aggregate.LATENCY_BUCKETS_MS
    rng = np.random.RandomState(0)
    values = np.round(rng.lognormal(3.0, 2.0, 500), 3).tolist() + [0.0, 1.0, 60000.0, 1e9]
    histograms = []
    for module in (jax_aggregate, aggregate):
        histogram, other = module.new_histogram(), module.new_histogram()
        for v in values:
            module.histogram_add(histogram, v)
        module.histogram_merge(other, histogram)
        module.histogram_merge(other, {"buckets_ms": [3.0, 40.0], "counts": [5, 2, 1], "count": 8, "sum_ms": 77.5})
        histograms.append((histogram, other, [module.histogram_percentile(h, q) for h in (histogram, other)
                                              for q in (0.0, 0.5, 0.95, 0.99, 1.0)]))
    assert histograms[1] == histograms[0]
    for text in ("2026-01-01T00:00:00+00:00", "2026-01-01T00:00:00", "2026-01-01T00:00:00.5+02:00", "x", "", None, 5):
        assert aggregate.parse_span_time(text) == jax_aggregate.parse_span_time(text)
    layout(str(tmp_path), "workers", seed=1)
    write_jsonl(str(tmp_path / "serve_trace.jsonl.3"), build_spans(2))
    with open(tmp_path / "short.jsonl", "w") as f:
        f.write('{"name": "a"}')  # a first line still being written
    for name in sorted(os.listdir(tmp_path)) + ["missing"]:
        path = str(tmp_path / name)
        assert aggregate.file_signature(path) == jax_aggregate.file_signature(path)
    for base in ("serve_trace.jsonl", "build_trace.jsonl", "fleet_health.json"):
        assert aggregate.sink_bases(str(tmp_path), base) == jax_aggregate.sink_bases(str(tmp_path), base)
    assert aggregate.discover_sinks(str(tmp_path)) == jax_aggregate.discover_sinks(str(tmp_path))
    assert aggregate.store_for(str(tmp_path)) is aggregate.store_for(str(tmp_path) + "/")


@pytest.fixture
def port_trace(collections, tmp_path, monkeypatch):
    """The ``serve_trace.jsonl`` the port's app (CPU) wrote for anomaly,
    ``/prediction``, fleet and stream requests, an unknown model, a model
    whose artifact is broken (a 500), ``/fleet-health`` and ``/slo``; and
    the ``(route, status)`` of each request sent."""
    _, port_dir = collections
    monkeypatch.setenv("GORDO_TPU_TRACE_SAMPLE_RATE", "1.0")
    monkeypatch.setenv("GORDO_TPU_STREAM_WINDOW_ROWS", "8")
    monkeypatch.setenv("GORDO_TPU_SERVE_WARMUP", "0")
    for name in ("GORDO_TPU_BATCHING", "GORDO_TPU_TELEMETRY", "GORDO_TPU_WORKER_SINKS", "PROMETHEUS_MULTIPROC_DIR"):
        monkeypatch.delenv(name, raising=False)
    _reset_globals()
    served = str(tmp_path / "served")
    shutil.copytree(port_dir, served)
    with open(os.path.join(served, "machine-2", "model.pkl"), "wb") as f:
        f.write(b"not a pickle")
    trace_dir = str(tmp_path / "telemetry")
    app = build_app(served, device="cpu")
    sent = []
    for method, path, body in (
        ("POST", url("machine-1/anomaly/prediction"), {"X": _frame(TAGS["machine-1"], 20, 1),
                                                        "y": _frame(TAGS["machine-1"], 20, 2)}),
        ("POST", url("machine-1/prediction"), {"X": _frame(TAGS["machine-1"], 30, 3)}),
        ("POST", url("prediction/fleet"), {"X": {"machine-1": _frame(TAGS["machine-1"], 30, 4)}}),
        ("POST", url("stream/s1/ingest"), {"X": {"machine-1": _frame(TAGS["machine-1"], 20, 5)}}),
        ("POST", url("stream/s1/ingest"), {"X": {"machine-1": _frame(TAGS["machine-1"], 12, 6, 200)}}),
        ("POST", url("nobody/prediction"), {"X": _frame(TAGS["machine-1"], 20, 4)}),
        ("POST", url("machine-2/anomaly/prediction"), {"X": _frame(TAGS["machine-2"], 20, 7),
                                                        "y": _frame(TAGS["machine-2"], 20, 7)}),
        ("GET", url("fleet-health"), None),
        ("GET", url("slo"), None),
    ):
        status, _, _ = call(app, trace_dir, method, path, body)
        sent.append((path.rsplit("/gordo/v0/", 1)[1], status))
    spans = read_trace(trace_dir)
    app.shutdown()
    _reset_globals()
    yield trace_dir, sent, spans
    _reset_globals()
    slo.reset_statuses()


def test_port_app_trace_rollups_match_jax(port_trace, tmp_path):
    """The port server's own trace: the rollups of both packages are
    equal and hold every request sent, its errors and its stream rows."""
    trace_dir, sent, spans = port_trace
    assert [status for _, status in sent] == [200, 200, 200, 200, 200, 404, 500, 200, 200]
    dirs = str(tmp_path / "jax"), str(tmp_path / "port")
    for directory in dirs:
        shutil.copytree(trace_dir, directory)
    jax_store, port_store = stores(dirs)
    summaries = jax_store.aggregate(), port_store.aggregate()
    assert summaries[1] == summaries[0]
    assert_same_rollups(dirs)
    summary = aggregate.summarize_rollup(port_store.merged())
    assert summary == jax_aggregate.summarize_rollup(jax_store.merged())
    # /slo evaluated before its own request span was written
    assert summary["requests"] == len(sent) and summary["errors"] == 1
    assert summary["machines"]["machine-2"] == {"requests": 1, "errors": 1, "error_rate": 1.0}
    stream = [s for s in spans if s["name"] in ("stream_ingest", "stream_score")]
    assert summary["stream"]["rows_in"] == 32
    assert summary["stream"]["rows_scored"] == sum(s["attributes"]["rows_scored"] for s in stream
                                                   if s["name"] == "stream_score") > 0
    assert summary["spans"] == len(spans)
    assert {"data_decode", "inference", "serialize"} <= set(summary["stages"])


def test_port_app_trace_rollups_after_jax_app(collections, port_trace, tmp_path, monkeypatch):
    """One telemetry directory written by the JAX app and then the port's:
    aggregated by either package in two passes, equal."""
    jax_dir, _ = collections
    trace_dir, _, _ = port_trace
    mixed = str(tmp_path / "mixed")
    monkeypatch.setenv("MODEL_COLLECTION_DIR", jax_dir)
    JAX_STORE.invalidate(jax_dir)
    client = Client(jax_build_app(config={"EXPECTED_MODELS": []}))
    for seed in range(3):
        status, _, _ = call(client, mixed, "POST", url("machine-1/anomaly/prediction"),
                            {"X": _frame(TAGS["machine-1"], 20, seed), "y": _frame(TAGS["machine-1"], 20, seed)})
        assert status == 200
    read_trace(mixed, jax=True)
    dirs = str(tmp_path / "jax"), str(tmp_path / "port")
    for directory in dirs:
        shutil.copytree(mixed, directory)
    first = [store.aggregate() for store in stores(dirs)]
    assert first[1] == first[0] and first[1]["spans_read"] > 0
    for directory in dirs:
        with open(os.path.join(trace_dir, "serve_trace.jsonl")) as src, \
                open(os.path.join(directory, "serve_trace.jsonl"), "a") as dst:
            dst.write(src.read())
    second = [store.aggregate() for store in stores(dirs)]
    assert second[1] == second[0]
    assert_same_rollups(dirs)
    assert aggregate.summarize_rollup(aggregate.RollupStore(dirs[1]).merged())["requests"] == 3 + 9
