"""What the port's ``build-fleet`` writes beside its machines
(``build_trace.jsonl``, ``build_status.json``, ``fleet_health.json``,
``fleet_plan.json``) against the JAX package's ``build-fleet`` on the same
config, on the CPU, and the ``build-status`` command and route.

One YAML config of four machines: three feedforward detectors (two of one
spec), one epoch, and one machine whose data fetch always fails (both
packages' ``data_fetch`` fault site, no retries). Both commands run in
this process; the JAX one on a one-device mesh (the port's trainer plans
for one card) and the port's trainer with JAX's random numbers, so the
final losses are comparable. Compared: the four files; the status' state,
counts and phases; the count of ``build_phase`` spans a phase, of events
a name and of ``device_program`` spans a (program, compile) pair; the
ledger's machines and build fields (final losses to rtol 1e-5, the fleet
build parity of ``tests/test_torch_fleet_build.py``); ``fleet_plan.json``
byte for byte. ``device_utilization`` events are throttled to one a
second (a ``final_fit`` always samples), so their count is held to that
rule in each build instead of to each other. Then the port alone, as
``tests/parallel/test_fleet_telemetry.py:205-294`` drives the JAX build:
a kill mid-dump and the resume, a failed machine counted, telemetry off.
"""

import collections
import functools
import io
import json
import os

import jax
import numpy as np
import pytest
from click.testing import CliRunner
from werkzeug.test import Client

from gordo_tpu import telemetry as jax_telemetry
from gordo_tpu.models.nn import init_feedforward as jax_init
from gordo_tpu.parallel import fleet as jax_fleet
from gordo_tpu.parallel.mesh import make_mesh as jax_make_mesh
from gordo_tpu.server import build_app as jax_build_app
from gordo_tpu.utils import faults as jax_faults
from gordo_tpu_torch import telemetry
from gordo_tpu_torch.cli import cli
from gordo_tpu_torch.machine import Machine
from gordo_tpu_torch.parallel import fleet as port_fleet
from gordo_tpu_torch.parallel.fleet_build import FleetBuilder
from gordo_tpu_torch.parallel.journal import BuildJournal
from gordo_tpu_torch.server import build_app
from gordo_tpu_torch.utils import faults
from gordo_tpu_torch.utils.faults import FaultRule, inject

PROJECT = "telemetry-parity"
REVISION = "1700000000000"
DATASET = {"type": "RandomDataset", "train_start_date": "2020-01-01T00:00:00+00:00",
           "train_end_date": "2020-01-04T00:00:00+00:00"}


def _detector(layers):
    return {"gordo_tpu.models.anomaly.diff.DiffBasedAnomalyDetector": {"base_estimator": {
        "sklearn.pipeline.Pipeline": {"steps": ["sklearn.preprocessing.MinMaxScaler", {
            "gordo_tpu.models.JaxAutoEncoder": {"kind": "feedforward_hourglass", "encoding_layers": layers,
                                                "epochs": 1}}]}}}}


CONFIG = {"machines": [
    {"name": "tp-a", "model": _detector(1), "dataset": {**DATASET, "tag_list": ["a1", "a2", "a3"]}},
    {"name": "tp-b", "model": _detector(1), "dataset": {**DATASET, "tag_list": ["b1", "b2", "b3"]}},
    {"name": "tp-c", "model": _detector(2), "dataset": {**DATASET, "tag_list": ["c1", "c2"]}},
    {"name": "dead-m", "model": _detector(1), "dataset": {**DATASET, "tag_list": ["d1", "d2", "d3"]}},
]}
FILES = ("build_status.json", "build_trace.jsonl", "fleet_health.json", "fleet_plan.json")
SAMPLED_PHASES = {"stage", "cv_train", "final_fit", "assemble", "dump"}


@functools.partial(jax.jit, static_argnums=1)
def _jax_init_params(seed, spec):
    _, init = jax.random.split(jax.random.PRNGKey(seed))
    return jax_init(init, spec)


@functools.partial(jax.jit, static_argnums=(1, 2))
def _jax_permutations(seed, epochs, n_total):
    fit, _ = jax.random.split(jax.random.PRNGKey(seed))
    return jax.vmap(lambda key: jax.random.permutation(key, n_total))(jax.random.split(fit, epochs))


class JaxRandom:
    """The JAX fleet trainer's randomness, for the port's trainer."""

    def init_params(self, spec, seed):
        return jax.tree_util.tree_map(np.array, _jax_init_params(seed, spec))

    def permutations(self, seed, epochs, n_total):
        return np.array(_jax_permutations(seed, epochs, n_total))


def read_trace(directory):
    with open(os.path.join(directory, telemetry.BUILD_TRACE_FILE)) as f:
        return [json.loads(line) for line in f]


def read_json(directory, name):
    with open(os.path.join(directory, name)) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def builds(tmp_path_factory):
    """The two output directories, and each command's exit code."""
    from gordo_tpu.cli.cli import gordo_tpu_cli
    from gordo_tpu.cli.workflow_generator import _machines_yaml as jax_machines_yaml
    from gordo_tpu.workflow.config_elements.normalized_config import NormalizedConfig as JaxNormalizedConfig
    from gordo_tpu.workflow.workflow_generator.workflow_generator import get_dict_from_yaml as jax_get_dict
    from gordo_tpu_torch.workflow.workflow_generator import normalize

    root = tmp_path_factory.mktemp("fleet-telemetry")
    text = json.dumps(CONFIG)
    (root / "jax-shard.yaml").write_text(
        jax_machines_yaml(JaxNormalizedConfig(jax_get_dict(io.StringIO(text)), PROJECT).machines))
    (root / "port-shard.json").write_text(normalize(io.StringIO(text), PROJECT))
    jax_dir, port_dir = root / "jax" / REVISION, root / "port" / REVISION
    patch = pytest.MonkeyPatch()
    patch.setenv("GORDO_TPU_DATA_RETRIES", "0")
    patch.setattr(jax_fleet, "make_mesh", lambda *a, **k: jax_make_mesh(jax.devices()[:1]))
    patch.setattr(port_fleet, "TorchRandom", JaxRandom)
    rule = "dead-*"
    try:
        jax_telemetry.reset_seen_programs()
        with jax_faults.inject(jax_faults.FaultRule("data_fetch", match=rule, times=None)):
            jax_run = CliRunner().invoke(gordo_tpu_cli, ["build-fleet", str(root / "jax-shard.yaml"), str(jax_dir)])
        telemetry.reset_seen_programs()
        with inject(FaultRule("data_fetch", match=rule, times=None)):
            port_code = cli.main(["build-fleet", str(root / "port-shard.json"), str(port_dir), "--device", "cpu"])
    finally:
        patch.undo()
    return str(jax_dir), str(port_dir), jax_run.exit_code, port_code


def test_same_files_and_status(builds):
    jax_dir, port_dir, jax_code, port_code = builds
    assert jax_code == port_code == 1  # the failed machine's FaultInjected
    for directory in (jax_dir, port_dir):
        assert set(FILES) <= set(os.listdir(directory))
    assert sorted(e for e in os.listdir(port_dir) if not e.startswith(".")) == sorted(
        e for e in os.listdir(jax_dir) if not e.startswith("."))
    jax_doc, port_doc = (read_json(d, "build_status.json") for d in (jax_dir, port_dir))
    for doc in (jax_doc, port_doc):
        assert doc["state"] == "complete" and doc["phase"] is None
        assert doc["machines"] == {"total": 4, "completed": 3, "failed": 1, "resumed": 0, "cached": 0,
                                   "degraded": 0}
    assert list(port_doc["phases"]) == list(jax_doc["phases"])
    assert {e["status"] for e in port_doc["phases"].values()} == {"done"}
    assert port_doc["project"] == jax_doc["project"] == PROJECT


def _counts(spans):
    phases = collections.Counter(s["attributes"]["phase"] for s in spans if s["name"] == "build_phase")
    events = collections.Counter(s["name"] for s in spans if s["kind"] == "event" and s["name"] != "device_utilization")
    programs = collections.Counter((s["attributes"]["program"], s["attributes"]["compile"])
                                   for s in spans if s["name"] == "device_program")
    names = collections.Counter(s["name"] for s in spans if s["kind"] != "event")
    return phases, events, programs, names


def test_same_spans_and_events(builds):
    jax_dir, port_dir, _, _ = builds
    jax_spans, port_spans = read_trace(jax_dir), read_trace(port_dir)
    assert _counts(port_spans) == _counts(jax_spans)
    phases, events, programs, _ = _counts(port_spans)
    assert events == {"fleet_plan": 1, "machine_failed": 1, "member_trained": 3, "machine_built": 3,
                      "fleet_plan_accuracy": 1}
    # the CV and final fits are of other shapes: every program call is its first
    assert programs == {("fleet_fit", True): 4, ("fleet_predict", True): 2}  # two specs, CV and final
    for spans in (jax_spans, port_spans):
        assert len({s["context"]["trace_id"] for s in spans}) == 1
        samples = sum(s["name"] == "device_utilization" for s in spans)
        assert phases["final_fit"] <= samples <= sum(phases[p] for p in SAMPLED_PHASES)
        failed = [s["attributes"] for s in spans if s["name"] == "machine_failed"]
        assert [a["machine"] for a in failed] == ["dead-m"]
    key_sets = {}
    for name, spans in (("jax", jax_spans), ("port", port_spans)):
        key_sets[name] = {(s["name"], s["attributes"].get("program")): sorted(s["attributes"])
                          for s in spans if s["name"] != "device_utilization"}
    assert key_sets["port"] == key_sets["jax"]


def test_same_ledger(builds):
    jax_dir, port_dir, _, _ = builds
    jax_doc, port_doc = (telemetry.load_health(d) for d in (jax_dir, port_dir))
    assert sorted(port_doc["machines"]) == sorted(jax_doc["machines"]) == ["dead-m", "tp-a", "tp-b", "tp-c"]
    for name, jax_record in jax_doc["machines"].items():
        port_record = port_doc["machines"][name]
        jax_build, port_build = dict(jax_record["build"]), dict(port_record["build"])
        for build in (jax_build, port_build):
            build.pop("built_at")
        jax_loss, port_loss = jax_build.pop("final_loss"), port_build.pop("final_loss")
        assert port_build == jax_build
        assert (jax_loss is None) == (port_loss is None) == (name == "dead-m")
        if jax_loss is not None:
            np.testing.assert_allclose(port_loss, jax_loss, rtol=1e-5)
        assert port_record["health"] == jax_record["health"]
    assert port_doc["machines"]["dead-m"]["build"]["failed"] is True
    assert port_doc["machines"]["tp-a"]["build"]["revision"] == REVISION
    assert port_doc["summary"] == jax_doc["summary"]
    accuracy = port_doc["plan_accuracy"]
    assert accuracy["plan_hash"] == jax_doc["plan_accuracy"]["plan_hash"]
    assert accuracy["actual_compiles"] == jax_doc["plan_accuracy"]["actual_compiles"] == 2
    assert accuracy["measured_hbm_peak_bytes"] is None  # the CPU has no allocator stats
    # JAX reads the precision off a bucket attribute its plan documents lack
    assert accuracy["precisions"] == ["f32"] and jax_doc["plan_accuracy"]["precisions"] is None


def test_same_plan(builds):
    jax_dir, port_dir, _, _ = builds
    with open(os.path.join(jax_dir, "fleet_plan.json")) as f:
        jax_text = f.read()
    with open(os.path.join(port_dir, "fleet_plan.json")) as f:
        port_text = f.read()
    assert port_text == jax_text
    plan = json.loads(port_text)
    assert plan["totals"]["members"] == 3 and plan["totals"]["buckets"] == 2
    plan_hash = read_trace(port_dir)
    plan_hash = next(s["attributes"]["plan_hash"] for s in plan_hash if s["name"] == "fleet_plan")
    assert BuildJournal.load(port_dir).plan() == {"plan_hash": plan_hash, "strategy": "naive"}


def test_build_status_command_and_route(builds, monkeypatch, capsys, tmp_path):
    """The port's command prints JAX's rendering and document; both apps
    answer the route alike, 404 without a document."""
    from gordo_tpu.cli.cli import gordo_tpu_cli

    jax_dir, port_dir, _, _ = builds
    runner = CliRunner()
    for args in ([], ["--as-json"]):
        assert cli.main(["build-status", port_dir, *args]) == 0
        printed = capsys.readouterr().out
        jax_printed = runner.invoke(gordo_tpu_cli, ["build-status", port_dir, *args]).output
        assert printed == jax_printed
    assert json.loads(printed) == read_json(port_dir, "build_status.json")
    assert cli.main(["build-status", str(tmp_path)]) == 1
    assert "No build status found" in capsys.readouterr().err
    assert runner.invoke(gordo_tpu_cli, ["build-status", str(tmp_path)]).exit_code == 1

    empty = tmp_path / "empty" / REVISION
    empty.mkdir(parents=True)
    for directory, status in ((port_dir, 200), (str(empty), 404)):
        monkeypatch.setenv("MODEL_COLLECTION_DIR", directory)
        url = f"/gordo/v0/{PROJECT}/build-status"
        jax_response = Client(jax_build_app(config={"EXPECTED_MODELS": []})).get(url)
        port_response = Client(build_app(directory, device="cpu")).get(url)
        assert port_response.status_code == jax_response.status_code == status
        assert json.loads(port_response.get_data()) == json.loads(jax_response.get_data())
    assert json.loads(port_response.get_data()) == {"error": "No build status for this revision.",
                                                    "revision": REVISION}


# -- the port alone, as the JAX package's telemetry tests drive the JAX build ------------

MODEL = {"gordo_tpu.models.anomaly.diff.DiffBasedAnomalyDetector": {"base_estimator": {
    "gordo_tpu.models.JaxAutoEncoder": {"kind": "feedforward_hourglass", "encoding_layers": 1, "epochs": 1}}}}


def make_machine(name):
    return Machine.from_config({"name": name, "model": MODEL, "dataset": {**DATASET, "tag_list": ["t1", "t2"]}},
                               PROJECT)


@pytest.fixture(autouse=True)
def _clean_rules():
    faults.clear()
    yield
    faults.clear()


def test_kill_leaves_running_status_and_resume_completes(tmp_path, monkeypatch, capsys):
    """A death once the second artifact landed leaves the status
    ``running`` with both counted (heartbeat 0: never behind the journal)
    and the dump phase running; the command renders it; the resume ends
    ``complete``."""
    monkeypatch.setenv(telemetry.HEARTBEAT_ENV, "0")
    out = tmp_path / "out"
    names = [f"ks-{i}" for i in range(3)]
    with inject(FaultRule("process_kill_after_n_machines", after=1, times=None)):
        with pytest.raises(SystemExit):
            FleetBuilder([make_machine(n) for n in names], device="cpu").build(output_dir=str(out))
    doc = telemetry.load_status(str(out))
    assert doc["state"] == "running"
    built = [n for n, e in BuildJournal.load(str(out)).machines().items() if e["status"] == "built"]
    # every landed machine counted (the dump threads land one at a time, each
    # counted before its kill site; the raising site lets in-flight ones land)
    assert doc["machines"]["completed"] == len(built) >= 2
    assert doc["machines"]["total"] == 3 and doc["phases"]["dump"]["status"] == "running"
    assert "running" in telemetry.render_status(doc) and "/3 done" in telemetry.render_status(doc)
    assert cli.main(["build-status", str(out)]) == 0 and "running" in capsys.readouterr().out
    assert cli.main(["build-status", str(out), "--as-json"]) == 0
    assert json.loads(capsys.readouterr().out)["state"] == "running"
    landed = [s["attributes"]["machine"] for s in read_trace(str(out)) if s["name"] == "machine_built"]
    assert sorted(landed) == sorted(built)

    resumer = FleetBuilder([make_machine(n) for n in names], device="cpu")
    resumer.build(output_dir=str(out), resume=True)
    doc = telemetry.load_status(str(out))
    assert doc["state"] == "complete" and doc["machines"]["resumed"] == len(resumer.resumed) == len(built)
    assert doc["machines"]["completed"] + doc["machines"]["resumed"] == doc["machines"]["total"]
    health = telemetry.load_health(str(out))["machines"]
    assert sorted(health) == names and all(r["build"]["revision"] == "out" for r in health.values())


def test_failed_machines_counted_and_status_completes(tmp_path, monkeypatch):
    monkeypatch.setenv("GORDO_TPU_DATA_RETRIES", "0")
    out = tmp_path / "out"
    builder = FleetBuilder([make_machine("ok-m"), make_machine("dead-m")], device="cpu")
    with inject(FaultRule("data_fetch", match="dead-*", times=None)):
        results = builder.build(output_dir=str(out))
    assert [m.name for _, m in results] == ["ok-m"]
    doc = telemetry.load_status(str(out))
    assert doc["state"] == "complete" and doc["machines"]["failed"] == 1 and doc["machines"]["completed"] == 1
    assert [s["attributes"]["machine"] for s in read_trace(str(out)) if s["name"] == "machine_failed"] == ["dead-m"]


def _lstm_model(lookback, shuffle=False):
    return {"gordo_tpu.models.anomaly.diff.DiffBasedAnomalyDetector": {"shuffle": shuffle, "base_estimator": {
        "gordo_tpu.models.JaxLSTMAutoEncoder": {"kind": "lstm_hourglass", "lookback_window": lookback,
                                                "encoding_layers": 1, "epochs": 1}}}}


def test_plan_buckets_are_the_final_fits(tmp_path):
    """``fleet_plan.json`` holds the buckets the final fit trains: ids
    and members against the trainer's fits, for a mixed fleet of LSTM
    buckets (two specs, one detector shuffling its windows) and a
    feedforward one, with a ``cross_val_only`` machine the plan and the
    final fit both leave out."""
    def machine(name, model, tags, **extra):
        return Machine.from_config({"name": name, "model": model, "dataset": {**DATASET, "tag_list": tags},
                                    **extra}, PROJECT)

    machines = [
        machine("lstm-a", _lstm_model(5), ["a1", "a2"]),
        machine("lstm-b", _lstm_model(5, shuffle=True), ["b1", "b2"]),
        machine("lstm-c", _lstm_model(3), ["c1", "c2"]),
        machine("ff-a", MODEL, ["d1", "d2"]),
        machine("cv-only", MODEL, ["e1", "e2"], evaluation={"cv_mode": "cross_val_only"}),
    ]
    builder = FleetBuilder(machines, device="cpu")
    out = tmp_path / "out"
    assert len(builder.build(output_dir=str(out))) == 5
    plan = json.loads((out / "fleet_plan.json").read_text())
    planned = {b["id"]: b["members"] for b in plan["buckets"]}
    final = {f["bucket"]: f["names"] for f in builder.trainer.fits if not any("::" in n for n in f["names"])}
    assert final == planned
    assert sorted(n for names in planned.values() for n in names) == ["ff-a", "lstm-a", "lstm-b", "lstm-c"]
    assert {b["id"]: b["windowed"] for b in plan["buckets"]} == {
        b: b.endswith("-o4") or b.endswith("-o2") for b in planned}
    assert sorted(len(names) for names in planned.values()) == [1, 1, 2]


def test_telemetry_off_leaves_no_trace(tmp_path, monkeypatch):
    """With ``GORDO_TPU_TELEMETRY=0`` neither package writes a trace, a
    status or a ledger; both write ``fleet_plan.json``."""
    from gordo_tpu.machine import Machine as JaxMachine
    from gordo_tpu.parallel import FleetBuilder as JaxFleetBuilder

    monkeypatch.setenv("GORDO_TPU_TELEMETRY", "0")
    monkeypatch.setattr(jax_fleet, "make_mesh", lambda *a, **k: jax_make_mesh(jax.devices()[:1]))
    config = {"name": "off-m", "model": MODEL, "dataset": {**DATASET, "tag_list": ["t1", "t2"]}}
    listings = []
    for build, name in (
        (lambda out: FleetBuilder([make_machine("off-m")], device="cpu").build(output_dir=out), "port"),
        (lambda out: JaxFleetBuilder([JaxMachine.from_config(config, project_name=PROJECT)]).build(output_dir=out),
         "jax"),
    ):
        out = tmp_path / name
        assert len(build(str(out))) == 1
        listings.append(sorted(e for e in os.listdir(out) if not e.startswith(".")))
    assert listings[0] == listings[1] == ["build_state.json", "fleet_plan.json", "off-m"]
    assert telemetry.load_status(str(tmp_path / "port")) is None
