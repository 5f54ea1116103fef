"""The port's build telemetry and plan (``gordo_tpu_torch/telemetry/``,
``gordo_tpu_torch/planner/``) against the JAX package's
(``gordo_tpu/telemetry/``, ``gordo_tpu/planner/``) on the same inputs, on
the CPU:

- a span's, an event's and an externally timed interval's keys (the
  schema ``tests/telemetry/test_trace_schema.py`` holds the JAX
  recorder to) and compile attribution of one sequence of programs;
- sink rotation at a small ``GORDO_TPU_TELEMETRY_MAX_BYTES``;
- ``render_status`` and ``eta_seconds`` of fixed documents;
- the health ledger's documents after the same ``record_build`` calls,
  in one file and in forced shards, on disk and restored;
- ``fleet_plan.json``'s bytes and ``plan_hash`` over the same buckets.

Equal means equal, except the wall-clock stamps (``built_at``,
``updated_at``), which are read at each call.
"""

import json
import os
import zlib
from types import SimpleNamespace

import numpy as np
import pytest

from gordo_tpu import planner as jax_planner
from gordo_tpu import telemetry as jax_telemetry
from gordo_tpu.models.spec import FeedForwardSpec as JaxFeedForwardSpec
from gordo_tpu.models.spec import LSTMSpec as JaxLSTMSpec
from gordo_tpu.models.training import FitConfig as JaxFitConfig
from gordo_tpu.telemetry import fleet_health as jax_fleet_health
from gordo_tpu_torch import planner, telemetry
from gordo_tpu_torch.models.spec import FeedForwardSpec, LSTMSpec
from gordo_tpu_torch.models.training import FitConfig
from gordo_tpu_torch.telemetry import fleet_health

# -- the recorder -----------------------------------------------------------------


def _record(recorder, kind):
    if kind == "span":
        with recorder.span("build_phase", phase="cv_train", machines=3) as handle:
            handle.set(extra=1)
    elif kind == "error span":
        with pytest.raises(ValueError):
            with recorder.span("device_program", program="fleet_fit"):
                raise ValueError("boom")
    elif kind == "nested span":
        with recorder.span("outer"):
            with recorder.span("inner", members=4):
                recorder.event("machine_failed", machine="m-2", error="boom")
    else:
        recorder.event("machine_built", machine="m-1")
    return recorder.finished()


def _shape(value):
    """Keys, nested: a span's schema without its values."""
    if isinstance(value, dict):
        return {k: _shape(v) for k, v in value.items()}
    if isinstance(value, list):
        return [_shape(v) for v in value]
    return type(value).__name__


@pytest.mark.parametrize("kind", ["span", "error span", "nested span", "event"])
def test_span_schema_matches_jax(kind):
    port = _record(telemetry.SpanRecorder(), kind)
    jax = _record(jax_telemetry.SpanRecorder(), kind)
    assert [_shape(s) for s in port] == [_shape(s) for s in jax]
    assert [(s["name"], s["kind"], s["status"], s["attributes"]) for s in port] == [
        (s["name"], s["kind"], s["status"], s["attributes"]) for s in jax]
    # nesting: each span's parent by name, in both
    for spans in (port, jax):
        ids = {s["context"]["span_id"]: s["name"] for s in spans}
        assert [ids.get(s["parent_id"]) for s in spans] == [
            {"inner": "outer", "machine_failed": "inner"}.get(s["name"]) for s in spans]


def test_compile_attribution_matches_jax(monkeypatch):
    """One sequence of program calls: first call of a key compiles, in
    both packages; the counters agree."""
    telemetry.reset_seen_programs()
    jax_telemetry.reset_seen_programs()
    telemetry.reset_program_counters()
    jax_telemetry.device.reset_program_counters()
    calls = [("fleet_fit", (1, (9, 64, 3))), ("fleet_predict", (1, (9, 20, 3))), ("fleet_fit", (1, (3, 64, 3))),
             ("fleet_fit", (1, (9, 64, 3))), ("fleet_predict", (1, (9, 20, 3)))]
    port_recorder, jax_recorder = telemetry.SpanRecorder(), jax_telemetry.SpanRecorder()
    with telemetry.activate(port_recorder):
        for program, key in calls:
            with telemetry.program_span(program, key, members=3):
                pass
    with jax_telemetry.activate(jax_recorder):
        for program, key in calls:
            with jax_telemetry.program_span(program, key, members=3):
                pass
    flags = [s["attributes"]["compile"] for s in port_recorder.finished()]
    assert flags == [s["attributes"]["compile"] for s in jax_recorder.finished()] == [True, True, True, False, False]
    port_counts = telemetry.program_cache_counters()["build"]
    assert port_counts == jax_telemetry.program_cache_counters()["build"]
    assert telemetry.get_recorder() is telemetry.NULL_RECORDER


@pytest.mark.parametrize("keep", [0, 1, 2])
def test_rotation_matches_jax(tmp_path, monkeypatch, keep):
    """At a 1200-byte limit both sinks rotate into the same generations."""
    monkeypatch.setenv("GORDO_TPU_TELEMETRY_MAX_BYTES", "1200")
    monkeypatch.setenv("GORDO_TPU_TELEMETRY_KEEP", str(keep))
    layouts = []
    for package, name in ((telemetry, "port"), (jax_telemetry, "jax")):
        directory = tmp_path / name
        directory.mkdir()
        recorder = package.SpanRecorder(sink_path=str(directory / "build_trace.jsonl"), service="svc")
        assert recorder.max_bytes == 1200 and recorder.keep == keep and not recorder.retain_spans
        for i in range(12):
            recorder.event("machine_built", machine=f"m-{i:03d}")
        recorder.close()
        lines = {entry: len((directory / entry).read_text().splitlines()) for entry in sorted(os.listdir(directory))}
        assert all(os.path.getsize(directory / entry) < 1200 + 600 for entry in lines)
        layouts.append(lines)
    assert layouts[0] == layouts[1]
    assert keep <= len(layouts[0]) <= keep + 1  # the base file is gone when the last write rotated it


# -- the status -------------------------------------------------------------------

STATUS_DOCS = {
    "running": {"project": "p", "state": "running", "phase": "cv_train", "started_at": "2026-01-01T00:00:00+00:00",
                "elapsed_sec": 42.4, "machines": {"total": 10, "completed": 3, "failed": 1, "resumed": 2,
                                                  "cached": 0, "degraded": 1},
                "phases": {"plan": {"seconds": 0.01, "status": "done"},
                           "cv_train": {"seconds": 12.3456, "status": "running"}}},
    "complete": {"project": "p", "state": "complete", "phase": None, "elapsed_sec": 90.0,
                 "machines": {"total": 2, "completed": 2}, "phases": {"dump": {"seconds": 1.5, "status": "done"}}},
    "nothing done": {"state": "running", "elapsed_sec": 5.0, "machines": {"total": 4, "completed": 0}},
    "all accounted": {"state": "running", "elapsed_sec": 5.0, "machines": {"total": 3, "completed": 2, "failed": 1}},
    "empty": {},
}


@pytest.mark.parametrize("name", sorted(STATUS_DOCS))
def test_render_status_matches_jax(name):
    doc = STATUS_DOCS[name]
    assert telemetry.render_status(doc) == jax_telemetry.render_status(doc)
    assert telemetry.eta_seconds(doc) == jax_telemetry.eta_seconds(doc)


def test_progress_document_matches_jax(tmp_path):
    """The same calls leave documents that differ only in their clock
    readings; a re-entered phase does not force a write."""
    docs = []
    for package, name in ((telemetry, "port"), (jax_telemetry, "jax")):
        seconds = {"plan": 0.5, "cv_train": 2.0}
        progress = package.BuildProgress(str(tmp_path / name), project="p", total=3, phase_seconds=seconds,
                                         heartbeat_seconds=0.0)
        progress.phase("plan")
        progress.phase("cv_train")
        progress.machine_completed("a")
        progress.machine_failed("b")
        progress.resumed = 1
        progress.finish("complete")
        doc = package.load_status(str(tmp_path / name))
        for key in ("started_at", "updated_at", "elapsed_sec"):
            doc.pop(key)
        docs.append(doc)
    assert docs[0] == docs[1]
    assert telemetry.load_status(str(tmp_path / "nowhere")) is None


def test_device_snapshot_on_the_cpu():
    snapshot = telemetry.memory_snapshot("cpu")
    assert snapshot["available"] is False and snapshot["measured_devices"] == 0
    recorder = telemetry.SpanRecorder()
    telemetry.emit_device_utilization(recorder, device="cpu", phase="stage")
    (event,) = recorder.finished()
    assert event["name"] == "device_utilization" and event["attributes"]["memory_available"] is False


# -- the health ledger --------------------------------------------------------------

BUILD_RECORDS = [
    ("m-a", dict(final_loss=0.25, retries=0)),
    ("m-a", dict(revision="1700", failed=False, degraded=False)),
    ("m-b", dict(failed=True, error="FaultInjected('data')")),
    ("m-c", dict(final_loss=float("nan"), retries=1)),
    ("m-c", dict(degraded=True, error="CUDA error: out of memory")),
    ("m-c", dict(revision="1700", failed=False, degraded=None)),
    ("m-d", dict(final_loss=0.5)),
    ("m-b", dict(revision="1701", failed=False, degraded=False)),
    ("m-e", dict(failed=True, error="x" * 40)),
]
ACCURACY = {"plan_hash": "abc", "strategy": "naive", "predicted_compiles": 1, "actual_compiles": 1}


def _strip_stamps(value):
    if isinstance(value, dict):
        return {k: _strip_stamps(v) for k, v in value.items() if k not in ("built_at", "updated_at")}
    if isinstance(value, list):
        return [_strip_stamps(v) for v in value]
    return value


@pytest.mark.parametrize("shards", [0, 4])
def test_ledger_matches_jax(tmp_path, monkeypatch, shards):
    monkeypatch.setenv("GORDO_TPU_HEALTH_SHARDS", str(shards))
    views, layouts, restored = [], [], []
    for ledger_class, loader, name in ((fleet_health.FleetHealthLedger, fleet_health.load_health, "port"),
                                       (jax_fleet_health.FleetHealthLedger, jax_fleet_health.load_health, "jax")):
        directory = tmp_path / name
        ledger = ledger_class(directory=str(directory), project="p", heartbeat_seconds=0.0)
        for machine, fields in BUILD_RECORDS:
            ledger.record_build(machine, **fields)
        ledger.record_plan_accuracy(ACCURACY)
        ledger.flush()
        views.append(_strip_stamps(dict(document=ledger.document(), summary=ledger.summary(),
                                        offenders=ledger.offenders(3), bounded=ledger.bounded_document(2))))
        layouts.append(sorted(os.path.relpath(os.path.join(root, f), directory)
                              for root, _, files in os.walk(directory) for f in files))
        restored.append(_strip_stamps(loader(str(directory))))
    assert views[0] == views[1]
    assert layouts[0] == layouts[1]
    shard_files = {f"fleet_health.d/shard-{zlib.crc32(m.encode()) % 4:03d}of004.json" for m, _ in BUILD_RECORDS}
    sharded = sorted(shard_files) + ["fleet_health.d/summary.json"]
    assert layouts[0] == (["fleet_health.json"] if shards == 0 else sharded)
    assert restored[0] == restored[1]
    assert views[0]["summary"]["degraded"] == 2  # m-b recovered, m-c keeps the degradation its build carried


def test_ledger_restores_its_snapshot(tmp_path):
    """A new builder's ledger adopts the directory's last snapshot, as the
    JAX package's process-wide ledger keeps its records."""
    first = fleet_health.ledger_for(str(tmp_path), project="p")
    first.record_build("m-a", failed=True, error="boom")
    first.record_plan_accuracy(ACCURACY)
    first.flush()
    second = fleet_health.ledger_for(str(tmp_path), project="p")
    assert second.document()["machines"]["m-a"]["build"]["failed"] is True
    assert second.document()["plan_accuracy"] == ACCURACY
    second.record_build("m-a", failed=False, degraded=False, revision="2")
    assert second.document()["machines"]["m-a"]["health"] == {"score": 1.0, "state": "healthy"}


# -- the plan ----------------------------------------------------------------------


def _members(package_spec, kind, count, rows):
    members = []
    for i in range(count):
        n = rows + 37 * i
        if kind == "lstm":
            spec = package_spec["lstm"](4, 4, 6, (8, 4), ("tanh", "tanh"))
            members.append(SimpleNamespace(name=f"l-{rows}-{i}", spec=spec, series=range(n), n_windows=n - 5))
        else:
            spec = package_spec["ff"](3, 3, (2,), ("tanh",))
            x = object()
            members.append(SimpleNamespace(name=f"d-{kind}-{rows}-{i}", spec=spec, n=n, X=x,
                                           y=x if kind == "aliased" else object()))
    return members


PLAN_CASES = {
    "aliased": [("aliased", 3, 300, dict(epochs=2))],
    "separate y": [("separate", 2, 200, dict(epochs=1, validation_split=0.1))],
    "lstm": [("lstm", 3, 400, dict(epochs=2, batch_size=64, shuffle=False))],
    "two configs": [("aliased", 2, 500, dict(epochs=1)),
                    ("aliased", 3, 90, dict(epochs=3, early_stopping=("val_loss", 1, 0.0, True)))],
}


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_plan_matches_jax(case, tmp_path):
    jax_specs = {"ff": JaxFeedForwardSpec, "lstm": JaxLSTMSpec}
    port_specs = {"ff": FeedForwardSpec, "lstm": LSTMSpec}
    keys = [f"hash-{i}" for i in range(7)]
    port_groups, jax_groups = [], []
    for kind, count, rows, config in PLAN_CASES[case]:
        port_config, jax_config = FitConfig(**config), JaxFitConfig(**config)
        port_groups.append((port_config, planner.plan_train_buckets(_members(port_specs, kind, count, rows),
                                                                    port_config)))
        jax_groups.append((jax_config, jax_planner.plan_train_buckets(
            _members(jax_specs, kind, count, rows), jax_config, strategy="naive",
            cost_model=jax_planner.CostModel())))
    port = planner.build_plan_doc(port_groups, "naive", planner.config_fingerprint(keys))
    jax = jax_planner.build_plan_doc(jax_groups, "naive", (1, 1), jax_planner.CostTable(),
                                     jax_planner.config_fingerprint(keys))
    assert port.to_json() == jax.to_json()
    assert port.plan_hash == jax.plan_hash
    port.save(str(tmp_path / planner.PLAN_FILE))
    assert planner.FleetPlan.load(str(tmp_path / planner.PLAN_FILE)).plan_hash == jax.plan_hash
    assert port.member_names == jax.member_names
    assert np.isclose(port.totals["predicted_wall_s"],
                      port.totals["predicted_compile_s"] + port.totals["predicted_run_s"])


@pytest.mark.parametrize("spec_kind", ["ff", "lstm"])
def test_cost_features_match_jax(spec_kind):
    from gordo_tpu.planner import costmodel as jax_costmodel
    from gordo_tpu_torch.planner import costmodel

    args = (5, 5, (8, 3, 8), ("tanh", "relu", "tanh")) if spec_kind == "ff" else (5, 5, 12, (16, 4), ("tanh", "tanh"))
    port_spec = (FeedForwardSpec if spec_kind == "ff" else LSTMSpec)(*args)
    jax_spec = (JaxFeedForwardSpec if spec_kind == "ff" else JaxLSTMSpec)(*args)
    assert costmodel.spec_param_count(port_spec) == jax_costmodel.spec_param_count(jax_spec)
    assert costmodel.spec_flops_per_sample(port_spec) == jax_costmodel.spec_flops_per_sample(jax_spec)
    port_model, jax_model = costmodel.CostModel(), jax_costmodel.CostModel()
    assert port_model.predict_hbm_bytes(port_spec, 3, 512, 32, y_aliased=False) == jax_model.predict_hbm_bytes(
        jax_spec, 3, 512, 32, y_aliased=False)
    assert port_model.predict_run_s("fleet_fit", port_spec, 3, 512, 2) == jax_model.predict_run_s(
        "fleet_fit", jax_spec, 3, 512, 2)
    assert json.dumps(port_spec.to_dict()) == json.dumps(jax_spec.to_dict())


@pytest.mark.parametrize("spec_kind", ["ff", "lstm"])
@pytest.mark.parametrize("validation_split", [0.0, 0.25])
def test_fit_single_span_matches_jax(spec_kind, validation_split):
    """The sequential fit (``FleetTrainer.fit_single``) is one
    ``device_program`` span ``fit_single`` under its caller's span, with the
    JAX fit's attributes: the padded train array's shape (an LSTM's
    materialized windows) and the spec; a second call of the same key is
    no compile."""
    from gordo_tpu.models.training import fit_single as jax_fit_single
    from gordo_tpu.ops.windows import sliding_windows as jax_sliding_windows
    from gordo_tpu.ops.windows import window_targets as jax_window_targets
    from gordo_tpu_torch.parallel.fleet import FleetMember, FleetTrainer, WindowedFleetMember

    rng = np.random.RandomState(3)
    X = rng.rand(45, 5).astype(np.float32)
    args = (5, 5, (8, 3, 8), ("tanh", "relu", "tanh")) if spec_kind == "ff" else (5, 5, 6, (4,), ("tanh",))
    port_spec = (FeedForwardSpec if spec_kind == "ff" else LSTMSpec)(*args)
    jax_spec = (JaxFeedForwardSpec if spec_kind == "ff" else JaxLSTMSpec)(*args)
    settings = dict(epochs=1, batch_size=8, validation_split=validation_split, shuffle=False)
    if spec_kind == "ff":
        jax_X, jax_y = X, X
        member = FleetMember("m", port_spec, X, X, seed=1)
    else:
        jax_X, jax_y = jax_sliding_windows(X, 6, 0), jax_window_targets(X, 6, 0)
        member = WindowedFleetMember("m", port_spec, X, np.asarray(jax_y), seed=1)
    telemetry.reset_seen_programs()
    jax_telemetry.reset_seen_programs()
    port_recorder, jax_recorder = telemetry.SpanRecorder(), jax_telemetry.SpanRecorder()
    trainer = FleetTrainer(device="cpu")
    with telemetry.activate(port_recorder), port_recorder.span("sequential_build"):
        for _ in range(2):
            trainer.fit_single(member, FitConfig(**settings))
    with jax_telemetry.activate(jax_recorder), jax_recorder.span("sequential_build"):
        for _ in range(2):
            jax_fit_single(jax_spec, np.asarray(jax_X), np.asarray(jax_y), JaxFitConfig(**settings), seed=1)

    def programs(spans):
        names = {s["context"]["span_id"]: s["name"] for s in spans}
        return [(s["name"], s["attributes"], names.get(s["parent_id"])) for s in spans if s["name"] == "device_program"]

    port, jax = programs(port_recorder.finished()), programs(jax_recorder.finished())
    assert port == jax
    assert [a["compile"] for _, a, _ in port] == [True, False]
    assert port[0][1]["program"] == "fit_single" and port[0][2] == "sequential_build"
