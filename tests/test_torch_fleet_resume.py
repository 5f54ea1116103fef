"""The port's fleet build survives a crash (``gordo_tpu_torch/parallel/``),
as ``tests/parallel/test_fleet_faults.py`` holds the JAX builder to it, on
the CPU: atomic dumps, the build journal and ``resume``, the
``data_fetch``/``dump_artifact``/``process_kill_after_n_machines`` fault
sites, the sequential rebuild of a machine whose device program fails
alone, and a journal that either package's builder wrote loading in the
other's."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
from werkzeug.test import Client

from gordo_tpu.machine import Machine as JaxMachine
from gordo_tpu.parallel import FleetBuilder as JaxFleetBuilder
from gordo_tpu.parallel.journal import BuildJournal as JaxBuildJournal
from gordo_tpu.utils import faults as jax_faults
from gordo_tpu_torch import serializer
from gordo_tpu_torch.builder import ModelBuilder
from gordo_tpu_torch.machine import Machine
from gordo_tpu_torch.parallel.fleet_build import FleetBuilder
from gordo_tpu_torch.parallel.journal import (
    JOURNAL_FILE,
    STATUSES,
    BuildJournal,
    artifact_complete,
    clean_staging_dirs,
    resumable_names,
)
from gordo_tpu_torch.server import build_app
from gordo_tpu_torch.utils import faults
from gordo_tpu_torch.utils.faults import FaultRule, inject

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROJECT = "fault-test"
DATASET = {
    "type": "RandomDataset",
    "train_start_date": "2020-01-01T00:00:00+00:00",
    "train_end_date": "2020-01-03T00:00:00+00:00",
}
MODEL = {"gordo_tpu.models.anomaly.diff.DiffBasedAnomalyDetector": {"base_estimator": {
    "gordo_tpu.models.JaxAutoEncoder": {"kind": "feedforward_hourglass", "encoding_layers": 1, "epochs": 1}}}}


def machine_config(name, model=None):
    return {"name": name, "model": model or MODEL, "dataset": {**DATASET, "tag_list": ["t1", "t2"]}}


def make_machine(name, model=None):
    return Machine.from_config(machine_config(name, model), PROJECT)


@pytest.fixture(autouse=True)
def _clean_rules():
    faults.clear()
    jax_faults.clear()
    yield
    faults.clear()
    jax_faults.clear()


def artifact_dirs(output_dir):
    return serializer.list_model_dirs(str(output_dir))


def staging_dirs(output_dir):
    return [e for e in os.listdir(output_dir) if serializer.is_staging_dir(e)]


def model_files(output_dir, names):
    return {name: ((output_dir / name / "model.pkl").read_bytes(), (output_dir / name / "model.pkl").stat().st_mtime_ns)
            for name in names}


# -- a death mid-fleet, then resume -------------------------------------------------


def test_kill_mid_fleet_then_resume_builds_only_the_rest(tmp_path):
    """Two dumps land, every later one dies mid-write (``SystemExit``, which
    a build never records as one machine's failure): two complete
    artifacts, no staging directory, the rest journaled at their last
    phase. A resume skips the two (their files untouched) and builds the
    other two; the result has an uninterrupted build's layout."""
    out = tmp_path / "out"
    names = [f"mk-{i}" for i in range(4)]
    with inject(FaultRule("dump_artifact", after=2, times=None, exc=SystemExit)):
        with pytest.raises(SystemExit):
            FleetBuilder([make_machine(n) for n in names], device="cpu").build(output_dir=str(out))
    done = artifact_dirs(out)
    assert len(done) == 2 and staging_dirs(out) == []
    state = BuildJournal.load(str(out)).machines()
    assert sorted(n for n, e in state.items() if e["status"] == "built") == done
    for name in set(names) - set(done):
        assert state[name]["status"] in ("planned", "data_loaded", "cv_done")
    assert all(artifact_complete(str(out / name)) for name in done)
    before = model_files(out, done)

    resumer = FleetBuilder([make_machine(n) for n in names], device="cpu")
    results = resumer.build(output_dir=str(out), resume=True)
    assert sorted(resumer.resumed) == done
    assert sorted(m.name for _, m in results) == sorted(set(names) - set(done))
    assert resumer.build_errors == {} and resumer.trainer.fits[-1]["members"] == 2
    assert artifact_dirs(out) == names and staging_dirs(out) == []
    assert model_files(out, done) == before
    assert all(e["status"] == "built" for e in BuildJournal.load(str(out)).machines().values())
    assert not (out / ".build_state.json.events").exists()  # folded into the base file
    uninterrupted = tmp_path / "uninterrupted"
    FleetBuilder([make_machine(n) for n in names], device="cpu").build(output_dir=str(uninterrupted))
    assert sorted(os.listdir(uninterrupted)) == sorted(os.listdir(out))
    for name in names:
        assert sorted(os.listdir(out / name)) == sorted(os.listdir(uninterrupted / name))
        assert serializer.load(str(out / name), "cpu").aggregate_threshold_ is not None


def test_process_kill_site_fires_after_its_machine_landed(tmp_path):
    """``process_kill_after_n_machines`` (raising form) fires after the
    machine's artifact landed and was journaled: the journal is never
    behind the artifacts, and the firing machine is resumed too."""
    out = tmp_path / "out"
    names = [f"pk-{i}" for i in range(3)]
    with inject(FaultRule("process_kill_after_n_machines", after=1, times=None)):
        with pytest.raises(SystemExit):
            FleetBuilder([make_machine(n) for n in names], device="cpu").build(output_dir=str(out))
    done = artifact_dirs(out)
    assert len(done) >= 2
    state = BuildJournal.load(str(out)).machines()
    assert all(state[name]["status"] == "built" for name in done)
    resumer = FleetBuilder([make_machine(n) for n in names], device="cpu")
    resumer.build(output_dir=str(out), resume=True)
    assert sorted(resumer.resumed) == done and artifact_dirs(out) == names


def test_kill_drill_in_a_subprocess(tmp_path):
    """The real kill: ``build-fleet`` with
    ``GORDO_TPU_FAULTS=process_kill_after_n_machines:*:after=1:kill`` ends
    with ``os._exit(137)`` after exactly two machines landed (the dump
    lands one artifact at a time); ``--resume`` builds the third."""
    shard = tmp_path / "shard.json"
    shard.write_text(json.dumps({"project_name": PROJECT, "machines": [machine_config(f"kd-{i}") for i in range(3)]}))
    out = tmp_path / "out"
    command = [sys.executable, "-m", "gordo_tpu_torch", "build-fleet", str(shard), str(out), "--device", "cpu"]
    env = {**os.environ, "GORDO_TPU_FAULTS": "process_kill_after_n_machines:*:after=1:kill"}
    killed = subprocess.run(command, cwd=REPO, env=env, capture_output=True, timeout=300)
    assert killed.returncode == 137, killed.stderr.decode()[-2000:]
    done = artifact_dirs(out)
    assert len(done) == 2 and all(artifact_complete(str(out / name)) for name in done)
    assert sorted(n for n, e in BuildJournal.load(str(out)).machines().items() if e["status"] == "built") == done
    env.pop("GORDO_TPU_FAULTS")
    resumed = subprocess.run(command + ["--resume"], cwd=REPO, env=env, capture_output=True, timeout=300)
    assert resumed.returncode == 0, resumed.stderr.decode()[-2000:]
    assert artifact_dirs(out) == ["kd-0", "kd-1", "kd-2"]
    assert "1 built, 2 resumed, 0 failed" in resumed.stderr.decode()


def test_resume_rebuilds_on_config_hash_mismatch(tmp_path):
    out = tmp_path / "out"
    FleetBuilder([make_machine("cfg-m")], device="cpu").build(output_dir=str(out))
    mtime = (out / "cfg-m" / "model.pkl").stat().st_mtime_ns
    changed = json.loads(json.dumps(MODEL).replace('"epochs": 1', '"epochs": 2'))
    resumer = FleetBuilder([make_machine("cfg-m", model=changed)], device="cpu")
    resumer.build(output_dir=str(out), resume=True)
    assert resumer.resumed == []
    assert (out / "cfg-m" / "model.pkl").stat().st_mtime_ns != mtime


def test_resume_rebuilds_a_corrupt_artifact(tmp_path):
    """The journal is never trusted over the artifact: a truncated
    ``model.pkl`` fails its checksum and is rebuilt."""
    out = tmp_path / "out"
    FleetBuilder([make_machine("cor-m")], device="cpu").build(output_dir=str(out))
    model_path = out / "cor-m" / "model.pkl"
    model_path.write_bytes(model_path.read_bytes()[:10])
    assert not artifact_complete(str(out / "cor-m"))
    resumer = FleetBuilder([make_machine("cor-m")], device="cpu")
    assert [m.name for _, m in resumer.build(output_dir=str(out), resume=True)] == ["cor-m"]
    assert resumer.resumed == [] and artifact_complete(str(out / "cor-m"))


def test_resumable_names_is_the_builders_filter(tmp_path):
    out = tmp_path / "out"
    names = [f"mh-{i}" for i in range(3)]
    FleetBuilder([make_machine(n) for n in names[:2]], device="cpu").build(output_dir=str(out))
    machines = [make_machine(n) for n in names]
    helper_view = resumable_names(str(out), machines)
    resumer = FleetBuilder(machines, device="cpu")
    resumer.build(output_dir=str(out), resume=True)
    assert sorted(helper_view) == sorted(resumer.resumed) == names[:2]


# -- faults that fail one machine -------------------------------------------------------


def test_dump_fault_leaves_no_partial_artifact(tmp_path):
    out = tmp_path / "out"
    builder = FleetBuilder([make_machine("dump-ok"), make_machine("dump-bad")], device="cpu")
    with inject(FaultRule("dump_artifact", match="dump-bad", times=None, exc=OSError)):
        results = builder.build(output_dir=str(out))
    assert [m.name for _, m in results] == ["dump-ok"]
    assert set(builder.build_errors) == {"dump-bad"} and isinstance(builder.build_errors["dump-bad"], OSError)
    assert artifact_dirs(out) == ["dump-ok"] and staging_dirs(out) == []
    assert BuildJournal.load(str(out)).machines()["dump-bad"]["status"] == "failed"


def test_data_fetch_faults(tmp_path, monkeypatch):
    """Two failed attempts are retried through; a fetch that always fails
    fails its machine alone."""
    monkeypatch.setenv("GORDO_TPU_DATA_BACKOFF", "0")
    builder = FleetBuilder([make_machine("flaky-m"), make_machine("dead-m"), make_machine("live-m")], device="cpu")
    with inject(FaultRule("data_fetch", match="flaky-*", times=2), FaultRule("data_fetch", match="dead-*", times=None)):
        results = builder.build(output_dir=str(tmp_path))
    assert [m.name for _, m in results] == ["flaky-m", "live-m"]
    assert set(builder.build_errors) == {"dead-m"}
    assert isinstance(builder.build_errors["dead-m"], faults.FaultInjected)
    assert builder.robustness["data_fetch_retries"] == 4  # 2 for flaky-m, 2 for dead-m
    robustness = serializer.load_metadata(str(tmp_path / "flaky-m"))["metadata"]["build_metadata"]["robustness"]
    assert robustness["data_fetch_retries"] == 2


def test_app_ignores_journal_and_staging_entries(tmp_path):
    FleetBuilder([make_machine("served-m")], device="cpu").build(output_dir=str(tmp_path))
    assert (tmp_path / JOURNAL_FILE).is_file()
    (tmp_path / ".leftover.tmp-123abc").mkdir()  # as a killed builder leaves it
    (tmp_path / ".leftover.tmp-123abc" / "model.pkl").write_bytes(b"partial")
    client = Client(build_app(str(tmp_path), device="cpu"))
    assert json.loads(client.get(f"/gordo/v0/{PROJECT}/models").get_data())["models"] == ["served-m"]
    assert clean_staging_dirs(str(tmp_path)) == []  # young: maybe a live builder's
    assert clean_staging_dirs(str(tmp_path), min_age_seconds=0) == [".leftover.tmp-123abc"]


def test_member_failing_alone_on_the_device_is_rebuilt_sequentially(tmp_path):
    """A device error that follows one member through every bisection
    degrades its machine to ``ModelBuilder``, whose build it equals; the
    others stay on the fleet path."""
    builder = FleetBuilder([make_machine("good-a"), make_machine("poison-x"), make_machine("good-b")], device="cpu")
    with inject(FaultRule("device_program", match="poison-*", times=None)):
        results = builder.build(output_dir=str(tmp_path))
    assert builder.build_errors == {} and set(builder.degraded) == {"poison-x"}
    assert isinstance(builder.degraded["poison-x"], faults.InjectedDeviceError)
    assert builder.robustness["sequential_degraded"] == 1 and builder.robustness["bucket_bisects"] >= 1
    assert [m.name for _, m in results] == ["good-a", "poison-x", "good-b"]
    assert artifact_dirs(tmp_path) == ["good-a", "good-b", "poison-x"]
    degraded = dict((m.name, model) for model, m in results)["poison-x"]
    direct, _ = ModelBuilder(make_machine("poison-x"), device="cpu").build()
    np.testing.assert_array_equal(degraded.feature_thresholds_, direct.feature_thresholds_)
    for key, layer in direct.base_estimator.params_.items():
        for leaf, value in layer.items():
            np.testing.assert_array_equal(degraded.base_estimator.params_[key][leaf].numpy(), value.numpy())


# -- the journal across packages ------------------------------------------------------


def test_journal_written_by_jax_loads_in_the_port(tmp_path):
    """A journal the JAX builder left after a death mid-dump (event overlay
    and base file) loads in the port's ``BuildJournal`` with the same
    entries, and the port's loads in the JAX one."""
    out = tmp_path / "jax"
    machines = [JaxMachine.from_config(machine_config(f"jx-{i}"), project_name=PROJECT) for i in range(3)]
    with jax_faults.inject(jax_faults.FaultRule("dump_artifact", after=1, times=None, exc=SystemExit)):
        with pytest.raises(SystemExit):
            JaxFleetBuilder(machines).build(output_dir=str(out))
    expected = JaxBuildJournal.load(str(out)).machines()
    assert {e["status"] for e in expected.values()} >= {"built"}
    assert BuildJournal.load(str(out)).machines() == expected
    assert all(e["status"] in STATUSES for e in expected.values())

    port_out = tmp_path / "port"
    journal = BuildJournal(str(port_out))
    journal.record("a", "planned", config_hash="h", flush=False)
    journal.record("b", "failed", error="ValueError('x')", flush=False)
    journal.flush()
    journal.record("a", "built")  # in the overlay
    with open(port_out / ".build_state.json.events", "a") as f:
        f.write('{"name": "c", "sta')  # a torn last line
    assert JaxBuildJournal.load(str(port_out)).machines() == BuildJournal.load(str(port_out)).machines() == {
        "a": {"status": "built", "config_hash": "h"}, "b": {"status": "failed", "error": "ValueError('x')"}}
