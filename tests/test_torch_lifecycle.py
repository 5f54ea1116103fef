"""The port's lifecycle modules (``gordo_tpu_torch/lifecycle/``, the store's
routing, plan replay, ``rebuild_stale``, the SLO hold) against the JAX
package's (``gordo_tpu/lifecycle/``), one module at a time, on the CPU.

One base revision a package, built once for the module: three machines of
``RandomDataset`` rows (3 tags each, one hourglass spec, 2 epochs), the
JAX one with the naive planner on a one-device mesh (so its
``fleet_plan.json`` is byte-equal to the port's), the port one drawing
JAX's randomness (``JaxRandom``). Every rebuild injects JAX's randomness
the same way.

Tolerances: drift statistics within 1e-12 relative (the same float64
sums in the same order); gate ratios within 2e-5 relative, plus one unit
of the fourth decimal the gate report rounds them to (the two packages'
forwards differ by f32 sums in another order).
"""

import copy
import json
import logging
import os
import shutil
from datetime import datetime, timedelta, timezone
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from gordo_tpu import lifecycle as jax_lifecycle
from gordo_tpu import serializer as jax_serializer
from gordo_tpu.dataset.datasets import RandomDataset as JaxRandomDataset
from gordo_tpu.lifecycle import drift as jax_drift
from gordo_tpu.lifecycle import gates as jax_gates
from gordo_tpu.machine import Machine as JaxMachine
from gordo_tpu.parallel import fleet as jax_fleet
from gordo_tpu.parallel.fleet_build import FleetBuilder as JaxFleetBuilder
from gordo_tpu.parallel.fleet_build import rebuild_stale as jax_rebuild_stale
from gordo_tpu.parallel.mesh import make_mesh as jax_make_mesh
from gordo_tpu.planner import FleetPlan as JaxFleetPlan
from gordo_tpu.server.fleet_store import FleetModelStore as JaxFleetModelStore
from gordo_tpu.telemetry import slo as jax_slo
from gordo_tpu_torch import lifecycle, serializer
from gordo_tpu_torch.lifecycle import drift, gates
from gordo_tpu_torch.machine import Machine
from gordo_tpu_torch.parallel.fleet import FleetTrainer
from gordo_tpu_torch.parallel.fleet_build import FleetBuilder, rebuild_stale
from gordo_tpu_torch.parallel.journal import BuildJournal
from gordo_tpu_torch.planner import FleetPlan
from gordo_tpu_torch.server.fleet_store import FleetModelStore
from gordo_tpu_torch.telemetry import slo
from tests.test_torch_fleet_build import JaxRandom

PROJECT = "lifecycle-port"
BASE = "100"
NAMES = ["lc-0", "lc-1", "lc-2"]
DATASET = {
    "type": "RandomDataset",
    "train_start_date": "2020-01-01T00:00:00+00:00",
    "train_end_date": "2020-01-05T00:00:00+00:00",
}
DETECTOR = {
    "gordo_tpu.models.anomaly.diff.DiffBasedAnomalyDetector": {
        "base_estimator": {"sklearn.pipeline.Pipeline": {"steps": [
            "sklearn.preprocessing.MinMaxScaler",
            {"gordo_tpu.models.JaxAutoEncoder": {"kind": "feedforward_hourglass", "encoding_layers": 1, "epochs": 2}},
        ]}}
    }
}
CONFIGS = [{"name": name, "model": DETECTOR, "dataset": {**DATASET, "tag_list": [f"t{3 * i + j}" for j in range(3)]}}
           for i, name in enumerate(NAMES)]
RATIO_RTOL, REPORT_UNIT = 2e-5, 1e-4
STATS_RTOL = 1e-12


def jax_machines():
    return [JaxMachine.from_config(c, project_name=PROJECT) for c in CONFIGS]


def port_machines():
    return [Machine.from_config(c, PROJECT) for c in CONFIGS]


def jax_trainer_patch():
    """The JAX builds on a one-device mesh, as the port plans."""
    patch = pytest.MonkeyPatch()
    patch.setattr(jax_fleet, "make_mesh", lambda *a, **k: jax_make_mesh(jax.devices()[:1]))
    return patch


def port_trainer():
    return FleetTrainer("cpu", JaxRandom())


@pytest.fixture(scope="module")
def bases(tmp_path_factory):
    """``(jax base dir, port base dir)``: each package's base revision."""
    root = tmp_path_factory.mktemp("lifecycle-bases")
    patch = jax_trainer_patch()
    try:
        JaxFleetBuilder(jax_machines(), plan_strategy="naive").build(output_dir=str(root / "jax" / BASE))
    finally:
        patch.undo()
    builder = FleetBuilder(port_machines(), trainer=port_trainer())
    builder.build(output_dir=str(root / "port" / BASE))
    assert builder.build_errors == {}
    return str(root / "jax" / BASE), str(root / "port" / BASE)


def models_root(base_dir, path):
    """A models root at ``path`` holding a copy of ``base_dir`` as its base revision."""
    os.makedirs(path, exist_ok=True)
    shutil.copytree(base_dir, os.path.join(path, BASE))
    return str(path)


@pytest.fixture(scope="module")
def windows():
    """(healthy, drifted) probe rows of each machine: a stride sample of
    its training rows, and the same rows shifted by 10 training stds."""
    out = {}
    for config in CONFIGS:
        dataset = JaxRandomDataset(**{k: v for k, v in config["dataset"].items() if k != "type"})
        X, _ = dataset.get_data()
        healthy = X.to_numpy()[::24]
        out[config["name"]] = (healthy, healthy + 10.0 * X.to_numpy().std(axis=0))
    return out


def frames(windows, drifted=()):
    return {name: windows[name][1 if name in drifted else 0] for name in NAMES}


# -- drift ------------------------------------------------------------------------------------------

BASELINE = {"feature_means": [0.0, 1.0, None, 3.0], "feature_stds": [0.3, 0.3, 1.0, 0.3], "tags": ["a", "b", "c", "d"],
            "n_samples": 500}
#: tag d was constant in training: its std is floored, so any noise shifts it
CONSTANT_TAG = {**BASELINE, "feature_stds": [0.3, 0.3, 1.0, 0.0]}
#: (config, baseline, batches of (X offset, NaN share, residual scale, rows)) of each drift case
DRIFT_CASES = {
    "healthy": (dict(min_samples=16, calibration_batches=1), BASELINE, [(0.0, 0.0, 1.0, 24), (0.0, 0.0, 1.0, 24)]),
    "shifted": (dict(min_samples=16, calibration_batches=1), BASELINE, [(0.0, 0.0, 1.0, 24), (5.0, 0.0, 1.0, 24)]),
    "nan cells": (dict(min_samples=16, sigma=1.0), BASELINE, [(0.0, 0.3, 1.0, 40), (2.0, 0.5, 1.0, 40)]),
    "residual": (dict(min_samples=8, calibration_batches=2), None,
                 [(0.0, 0.0, 1.0, 10), (0.0, 0.0, 1.0, 10), (0.0, 0.0, 3.5, 10), (0.0, 0.0, 1.1, 10)]),
    "too few rows": (dict(min_samples=64, calibration_batches=1), BASELINE,
                     [(4.0, 0.0, 1.0, 20), (4.0, 0.0, 1.0, 20), (4.0, 0.0, 1.0, 30)]),
    "tags changed": (dict(min_samples=4), {**BASELINE, "feature_means": [0.0, 1.0]}, [(9.0, 0.0, 1.0, 8)]),
    "quorum": (dict(min_samples=4, feature_quorum=0.75, sigma=1.5), BASELINE, [(0.6, 0.0, 1.0, 12)]),
    "constant tag": (dict(min_samples=4), CONSTANT_TAG, [(0.0, 0.0, 1.0, 12)]),
}


def _batches(batches, seed):
    rng = np.random.RandomState(seed)
    for offset, nan_share, scale, rows in batches:
        X = rng.standard_normal((rows, 4)) * 0.3 + np.array([0.0, 1.0, 2.0, 3.0]) + offset
        X[rng.rand(rows, 4) < nan_share] = np.nan
        X[:, 2] = np.nan if nan_share > 0.4 else X[:, 2]
        residuals = np.abs(rng.standard_normal(rows)) * scale
        residuals[rng.rand(rows) < nan_share] = np.nan
        yield X, residuals


def assert_same_verdict(port_verdict, jax_verdict):
    assert port_verdict.machine == jax_verdict.machine
    assert port_verdict.drifted == jax_verdict.drifted
    assert port_verdict.reasons == jax_verdict.reasons
    assert sorted(port_verdict.stats) == sorted(jax_verdict.stats)
    for key, value in jax_verdict.stats.items():
        if isinstance(value, float):
            assert port_verdict.stats[key] == pytest.approx(value, rel=STATS_RTOL)
        else:
            assert port_verdict.stats[key] == value


@pytest.mark.parametrize("case", sorted(DRIFT_CASES))
def test_machine_drift_matches_jax(case):
    """The same batches through both packages' ``MachineDrift``: equal
    verdicts after every batch, and snapshots each package restores from
    the other's JSON and goes on from alike."""
    config, baseline, batches = DRIFT_CASES[case]
    port = drift.MachineDrift("m", baseline=copy.deepcopy(baseline), config=drift.DriftConfig(**config))
    ref = jax_drift.MachineDrift("m", baseline=copy.deepcopy(baseline), config=jax_drift.DriftConfig(**config))
    verdicts = []
    for X, residuals in _batches(batches, seed=len(case)):
        port.observe(X, residuals)
        ref.observe(X, residuals)
        assert json.dumps(port.snapshot()) == json.dumps(ref.snapshot())
        verdict = port.evaluate()
        assert_same_verdict(verdict, ref.evaluate())
        verdicts.append(verdict.drifted)
    if case in ("shifted", "residual", "quorum", "constant tag"):
        assert any(verdicts)
    if case in ("healthy", "tags changed"):
        assert not any(verdicts)
    if case == "too few rows":  # the windows add up across evaluations until one is testable
        assert verdicts == [False, False, True]
    # mid-window snapshots cross over: each side restores the other's and agrees
    X, residuals = next(_batches(batches[:1], seed=99))
    port.observe(X, residuals)
    ref.observe(X, residuals)
    crossed_port = drift.MachineDrift("m", baseline=copy.deepcopy(baseline), config=drift.DriftConfig(**config))
    crossed_ref = jax_drift.MachineDrift("m", baseline=copy.deepcopy(baseline), config=jax_drift.DriftConfig(**config))
    crossed_port.restore(json.loads(json.dumps(ref.snapshot())))
    crossed_ref.restore(json.loads(json.dumps(port.snapshot())))
    assert crossed_port.snapshot() == crossed_ref.snapshot() == port.snapshot()
    assert_same_verdict(crossed_port.evaluate(reset=False), crossed_ref.evaluate(reset=False))


def test_drift_monitor_matches_jax(bases, windows):
    """Both monitors from the port's base revision (the builder's
    ``drift_baseline``s), fed the same frames and seeded residuals; the
    JAX base's baselines are the port's; snapshots cross over."""
    jax_base, port_base = bases
    for name in NAMES:
        want, got = jax_drift._load_baseline(jax_base, name), drift._load_baseline(port_base, name)
        assert got["tags"] == want["tags"] and got["n_samples"] == want["n_samples"]
        np.testing.assert_allclose(got["feature_means"], want["feature_means"], rtol=1e-6)
        np.testing.assert_allclose(got["feature_stds"], want["feature_stds"], rtol=1e-6)
    config = dict(min_samples=8, calibration_batches=1)
    port = drift.DriftMonitor.from_revision(port_base, drift.DriftConfig(**config))
    ref = jax_drift.DriftMonitor.from_revision(port_base, jax_drift.DriftConfig(**config))
    assert port.machines() == ref.machines() == NAMES
    rng = np.random.RandomState(3)
    for drifted in ((), ("lc-1",), ("lc-1", "lc-2")):
        window = frames(windows, drifted)
        scores = {name: (None, np.abs(rng.standard_normal(len(rows))) * (4.0 if name in drifted else 1.0))
                  for name, rows in window.items() if name != "lc-0"}  # lc-0's scoring failed
        port.observe_scores(window, scores)
        ref.observe_scores(window, scores)
        got, want = port.evaluate(), ref.evaluate()
        assert sorted(got) == sorted(want)
        for name in want:
            assert_same_verdict(got[name], want[name])
        assert sorted(n for n, v in got.items() if v.drifted) == sorted(drifted)
    port.observe_scores(frames(windows), {})
    crossed = drift.DriftMonitor(drift.DriftConfig(**config))
    crossed.restore(json.loads(json.dumps(port.snapshot())))
    ref_crossed = jax_drift.DriftMonitor(jax_drift.DriftConfig(**config))
    ref_crossed.restore(json.loads(json.dumps(crossed.snapshot())))
    assert ref_crossed.snapshot() == port.snapshot()


def test_drift_config_from_env_matches_jax(monkeypatch):
    for name, value in (("GORDO_TPU_DRIFT_SIGMA", "3.5"), ("GORDO_TPU_DRIFT_FEATURE_QUORUM", "0.5"),
                        ("GORDO_TPU_DRIFT_RESIDUAL_RATIO", "1.5"), ("GORDO_TPU_DRIFT_MIN_SAMPLES", "12"),
                        ("GORDO_TPU_DRIFT_CALIBRATION", "bogus")):
        monkeypatch.setenv(name, value)
    assert vars(drift.DriftConfig.from_env()) == vars(jax_drift.DriftConfig.from_env())
    assert vars(gates.GateConfig.from_env()) == vars(jax_gates.GateConfig.from_env())
    port, ref = lifecycle.LifecycleConfig.from_env(), jax_lifecycle.LifecycleConfig.from_env()
    assert {k: v for k, v in vars(port).items() if k not in ("drift", "gates")} == {
        k: v for k, v in vars(ref).items() if k not in ("drift", "gates")}


# -- state ------------------------------------------------------------------------------------------


def _untimed(value):
    if isinstance(value, dict):
        return {k: _untimed(v) for k, v in value.items() if k != "time"}
    if isinstance(value, list):
        return [_untimed(v) for v in value]
    return value


def _drive_state(module, root):
    state = module.LifecycleState.load(root)
    state.update(anchor_revision=BASE, serving_revision=BASE)
    state.transition("canary_building", event="drift_detected", stale=["lc-1"], canary_revision="101",
                     drift={"lc-1": {"n": 3, "sum": [1.0, 2.0]}})
    state.transition("canary_serving", event="canary_serving", rebuilt=["lc-1"])
    state.transition("idle", event="promoted", serving_revision="101", canary_revision=None, stale=[], rebuilt=[])
    state.transition("canary_building", event="drift_detected", stale=["lc-2"], canary_revision="102")
    state.transition("rolling_back", event="canary_rejected", reasons=["lc-2: canary residual 3.00x"])
    state.quarantine({"canary_revision": "102", "machines": ["lc-2"], "reasons": ["lc-2: canary residual 3.00x"]})
    state.transition("idle", event="rolled_back", canary_revision=None, stale=[], rebuilt=[], reasons=[])
    for i in range(module.MAX_HISTORY - 3):  # the history keeps its last MAX_HISTORY entries
        state.transition("idle", event=f"tick-{i}")
    with pytest.raises(ValueError, match="unknown lifecycle phase"):
        state.transition("promoted")
    return state


def test_lifecycle_state_matches_jax(tmp_path):
    """The same transitions give the same ``state.json`` and
    ``quarantine.json`` apart from times; each package loads the other's;
    a torn file or an unknown phase loads idle in both."""
    from gordo_tpu.lifecycle import state as jax_state
    from gordo_tpu_torch.lifecycle import state as port_state

    assert (port_state.PHASES, port_state.MAX_HISTORY, port_state.LIFECYCLE_DIR, port_state.STATE_FILE,
            port_state.QUARANTINE_FILE) == (jax_state.PHASES, jax_state.MAX_HISTORY, jax_state.LIFECYCLE_DIR,
                                            jax_state.STATE_FILE, jax_state.QUARANTINE_FILE)
    port = _drive_state(port_state, str(tmp_path / "port"))
    ref = _drive_state(jax_state, str(tmp_path / "jax"))
    assert _untimed(port.doc) == _untimed(ref.doc)
    assert [e["event"] for e in port.doc["history"][:3]] == ["drift_detected", "canary_rejected", "rolled_back"]
    assert len(port.doc["history"]) == port_state.MAX_HISTORY
    assert _untimed(port.quarantined()) == _untimed(ref.quarantined())
    for name in (port_state.STATE_FILE, port_state.QUARANTINE_FILE):
        with open(os.path.join(port.directory, name)) as f, open(os.path.join(ref.directory, name)) as g:
            assert _untimed(json.load(f)) == _untimed(json.load(g))
    assert port_state.LifecycleState.load(str(tmp_path / "jax")).doc == ref.doc
    assert jax_state.LifecycleState.load(str(tmp_path / "port")).doc == port.doc
    for text in ("{torn", json.dumps({"version": 1, "phase": "exploding"}), json.dumps({"version": 2})):
        for root in ("port", "jax"):
            with open(tmp_path / root / ".lifecycle" / "state.json", "w") as f:
                f.write(text)
        got, want = port_state.LifecycleState.load(str(tmp_path / "port")), jax_state.LifecycleState.load(
            str(tmp_path / "jax"))
        assert got.doc == want.doc and got.phase == "idle"


# -- revisions ---------------------------------------------------------------------------------------


def _tree(root):
    out = {}
    for dirpath, _dirs, files in os.walk(root):
        for name in files:
            path = os.path.join(dirpath, name)
            out[os.path.relpath(path, root)] = os.stat(path).st_ino
    return out


def test_publish_canary_matches_jax(bases, tmp_path):
    """Both packages' ``publish_canary`` over copies of one base and one
    rebuilt artifact: the same tree, inherited files hardlinked to the
    base's, the rebuilt one to the build directory's, the plan carried;
    a second call returns the revision untouched; an incomplete revision
    or rebuilt artifact is refused alike."""
    _, port_base = bases
    results = {}
    for package, module in (("port", lifecycle), ("jax", jax_lifecycle)):
        root = models_root(port_base, tmp_path / package)
        build = os.path.join(root, ".lifecycle", "build-101")
        shutil.copytree(os.path.join(root, BASE, "lc-1"), os.path.join(build, "lc-1"))
        assert module.list_revisions(root) == [BASE] and module.next_revision(root) == "101"
        target = module.publish_canary(root, BASE, build, ["lc-1"], "101")
        assert target == os.path.join(root, "101") and module.revision_complete(target)
        tree = _tree(target)
        base_tree, build_tree = _tree(os.path.join(root, BASE)), _tree(build)
        for path, inode in tree.items():
            source = build_tree.get(path) if path.startswith("lc-1") else base_tree.get(path)
            assert inode == source, path
        assert module.publish_canary(root, BASE, build, ["lc-1"], "101") == target
        assert _tree(target) == tree
        assert module.list_revisions(root) == [BASE, "101"] and module.next_revision(root) == "102"
        os.makedirs(os.path.join(root, "102", "lc-0"))
        with pytest.raises(RuntimeError) as refused:
            module.publish_canary(root, BASE, build, ["lc-1"], "102")
        os.remove(os.path.join(build, "lc-1", "model.pkl"))
        with pytest.raises(RuntimeError) as incomplete:
            module.publish_canary(root, BASE, build, ["lc-1"], "103")
        assert not [e for e in os.listdir(root) if e.startswith(".103")]
        assert module.delete_revision_dir(root, "102") == os.path.join(root, "102")
        assert module.delete_revision_dir(root, "102") is None
        results[package] = (sorted(tree), str(refused.value), str(incomplete.value))
    assert results["port"] == results["jax"]
    assert "fleet_plan.json" in results["port"][0]


# -- the store's routing -----------------------------------------------------------------------------


def _routing(store, base, canary):
    seq = []
    store.set_canary(base, canary, 0.25, warm=False)
    seq.append(store.canary_status())
    seq.append([store.route(base) for _ in range(12)])
    seq.append([store.route(base + "/") for _ in range(4)])  # the slice's key is the normalized path
    store.clear_canary(canary)  # another directory's canary: nothing
    seq.append(store.canary_status())
    store.set_canary(base + "/", canary, 1.0, warm=False)
    seq.append([store.route(base) for _ in range(3)])
    store.swap(base, canary, warm=False)
    seq.append((store.canary_status(), store.route(base), store.route(base + "/"), store.route(canary)))
    store.swap(base + "/", base, warm=False)  # onto itself: the redirect goes
    seq.append(store.route(base))
    store.swap(base, canary, warm=False)
    store.set_canary(base, base, 0.5, warm=False)
    seq.append([store.route(base) for _ in range(4)])
    store.invalidate(canary)  # a forgotten revision takes no more traffic
    seq.append((store.route(base), store.canary_status()))
    with pytest.raises(ValueError):
        store.set_canary(base, canary, 0.0, warm=False)
    store.set_canary(base, canary, 0.5, warm=False)
    store.clear_canary()
    seq.append(store.canary_status())
    return seq


def test_store_routing_matches_jax(bases, tmp_path):
    """``route``, ``swap``, ``set_canary``, ``clear_canary`` and
    ``invalidate`` in the same order on both stores give the same routing:
    every 4th request to the canary at 0.25, every one at 1.0, a swap onto
    itself dropping the redirect, keys with a trailing slash alike."""
    _, port_base = bases
    root = models_root(port_base, tmp_path)
    base, canary = os.path.join(root, BASE), os.path.join(root, "101")
    shutil.copytree(base, canary)
    got = _routing(FleetModelStore(base, torch.device("cpu")), base, canary)
    want = _routing(JaxFleetModelStore(max_revisions=4), base, canary)
    assert got == want
    assert got[1] == [canary if i % 4 == 3 else base for i in range(12)]


def test_warm_canary_makes_its_buckets_resident(bases, tmp_path):
    """``set_canary(warm=True)`` loads the canary's models and stacks its
    buckets before the slice lands; ``warm=False`` loads nothing."""
    _, port_base = bases
    root = models_root(port_base, tmp_path)
    base = os.path.join(root, BASE)
    store = FleetModelStore(base, torch.device("cpu"))
    cold = store.set_canary(base, base, 0.5, warm=False)
    assert cold.loaded_specs() == {} and cold._buckets == {}
    shutil.copytree(base, os.path.join(root, "101"))
    fleet = store.set_canary(base, os.path.join(root, "101"), 0.5)
    assert sorted(fleet.loaded_specs()) == NAMES and len(fleet._buckets) == 1
    assert fleet.spec_bucket(next(iter(fleet._buckets)))[0] == NAMES


# -- plan replay ----------------------------------------------------------------------------------


def _members(collection, load, rows):
    out = []
    for name, n in rows.items():
        estimator = load(os.path.join(collection, name))
        estimator = getattr(estimator.base_estimator, "steps", [[None, estimator.base_estimator]])[-1][1]
        out.append(SimpleNamespace(name=name, spec=estimator.spec_, n=n, X=None, y=None))
    return out


def test_materialize_buckets_matches_jax(bases):
    """The same naive plan replayed in both packages: the same bucket ids,
    rosters, pad targets and programs, and the same members left to pack
    live (unknown to the plan, or grown past its pad target)."""
    jax_base, port_base = bases
    with open(os.path.join(port_base, "fleet_plan.json")) as f:
        doc = json.load(f)
    n_padded = doc["buckets"][0]["n_padded"]
    rows = {"lc-2": 300, "lc-0": 280, "lc-1": n_padded + 1}
    port_members = _members(port_base, lambda p: serializer.load(p, "cpu"), rows)
    jax_members = _members(jax_base, jax_serializer.load, rows)
    port_members.append(SimpleNamespace(name="lc-9", spec=port_members[0].spec, n=10, X=None, y=None))
    jax_members.append(SimpleNamespace(name="lc-9", spec=jax_members[0].spec, n=10, X=None, y=None))
    got = FleetPlan(doc).materialize_buckets(port_members)
    want = JaxFleetPlan(doc).materialize_buckets(jax_members)

    def shape(result):
        buckets, uncovered = result
        return ([(b.bucket_id, b.program, [m.name for m in b.members], b.n_padded, b.offset, b.windowed)
                 for b in buckets], [m.name for m in uncovered])

    assert shape(got) == shape(want)
    assert shape(got) == ([(doc["buckets"][0]["id"], "fleet_fit", ["lc-2", "lc-0"], n_padded, 0, False)],
                          ["lc-1", "lc-9"])


def test_rebuild_stale_replays_the_base_plan(bases, tmp_path, caplog):
    """``rebuild_stale`` trains the stale member at the base plan's pad
    target (here one the live packer would not choose); a ``packed`` base
    plan replays as planned too, its strategy journaled."""
    _, port_base = bases
    with open(os.path.join(port_base, "fleet_plan.json")) as f:
        doc = json.load(f)
    live = doc["buckets"][0]["n_padded"]
    doc["buckets"][0]["n_padded"] = 2 * live
    path = str(tmp_path / "plan.json")
    with open(path, "w") as f:
        json.dump(doc, f)
    builder = rebuild_stale(port_machines(), ["lc-1"], str(tmp_path / "replayed"), base_plan_path=path,
                            trainer=port_trainer())
    assert builder.build_errors == {} and sorted(serializer.list_model_dirs(str(tmp_path / "replayed"))) == ["lc-1"]
    final = [fit for fit in builder.trainer.fits if fit["names"] == ["lc-1"]]
    assert [fit["rows"] for fit in final] == [2 * live]
    assert final[0]["bucket"] == doc["buckets"][0]["id"]
    with open(tmp_path / "replayed" / "fleet_plan.json") as f:
        assert json.load(f) == doc  # the base plan travels with the rebuild
    doc["strategy"] = "packed"
    with open(path, "w") as f:
        json.dump(doc, f)
    with caplog.at_level(logging.WARNING):
        builder = rebuild_stale(port_machines(), ["lc-1"], str(tmp_path / "packed"), base_plan_path=path,
                                trainer=port_trainer())
    assert "pack live" not in caplog.text and builder.build_errors == {}
    assert [fit["rows"] for fit in builder.trainer.fits if fit["names"] == ["lc-1"]] == [2 * live]
    assert BuildJournal.load(str(tmp_path / "packed")).plan() == {"plan_hash": FleetPlan(doc).plan_hash,
                                                                   "strategy": "packed"}
    assert builder.trainer.plan_strategy is None  # the build's strategy does not outlive it
    with pytest.raises(Exception, match="not in the machine set"):
        rebuild_stale(port_machines(), ["lc-7"], str(tmp_path / "unknown"))


# -- gates --------------------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def canaries(bases, tmp_path_factory):
    """Each package's models root with its base and a canary revision
    ``101`` rebuilding ``lc-1`` (JAX's randomness on both sides)."""
    jax_base, port_base = bases
    roots = {}
    tmp = tmp_path_factory.mktemp("canaries")
    patch = jax_trainer_patch()
    try:
        for package, base_dir in (("jax", jax_base), ("port", port_base)):
            root = models_root(base_dir, tmp / package)
            build = os.path.join(root, ".lifecycle", "build-101")
            plan = os.path.join(root, BASE, "fleet_plan.json")
            if package == "jax":
                builder = jax_rebuild_stale(jax_machines(), ["lc-1"], build, base_plan_path=plan)
                jax_lifecycle.publish_canary(root, BASE, build, ["lc-1"], "101")
            else:
                builder = rebuild_stale(port_machines(), ["lc-1"], build, base_plan_path=plan, trainer=port_trainer())
                lifecycle.publish_canary(root, BASE, build, ["lc-1"], "101")
            assert builder.build_errors == {}
            # a copy whose rebuilt model.pkl is garbage
            shutil.copytree(os.path.join(root, "101"), os.path.join(root, "102"), copy_function=shutil.copy2)
            os.remove(os.path.join(root, "102", "lc-1", "model.pkl"))
            with open(os.path.join(root, "102", "lc-1", "model.pkl"), "wb") as f:
                f.write(b"not a pickle")
            roots[package] = root
    finally:
        patch.undo()
    return roots


def _gate(package, root, canary, probe, case):
    if package == "port":
        store, module = FleetModelStore(os.path.join(root, BASE), torch.device("cpu")), gates
    else:
        store, module = JaxFleetModelStore(max_revisions=4), jax_gates
    base_fleet, canary_fleet = store.fleet(os.path.join(root, BASE)), store.fleet(os.path.join(root, canary))
    if case == "lost threshold":
        canary_fleet.model("lc-1").aggregate_threshold_ = float("nan")
    return module.evaluate_canary(base_fleet, canary_fleet, probe, ["lc-1"], module.GateConfig())


GATE_CASES = {"clean": "101", "garbage model.pkl": "102", "lost threshold": "101", "bf16": "101"}


@pytest.mark.parametrize("case", sorted(GATE_CASES))
def test_evaluate_canary_matches_jax(canaries, windows, case, monkeypatch):
    """Both packages' gates over their own base and canary fleets (built
    alike) on the same probe window: the same verdict and failures, and
    threshold and residual ratios within 2e-5 relative (plus one unit of
    the report's rounding)."""
    if case == "bf16":
        monkeypatch.setenv("GORDO_TPU_SERVE_PRECISION", "bf16")
    probe = frames(windows, drifted=("lc-1",))
    got = _gate("port", canaries["port"], GATE_CASES[case], probe, case)
    want = _gate("jax", canaries["jax"], GATE_CASES[case], probe, case)
    assert (got.passed, got.failures) == (want.passed, want.failures)
    assert got.passed == (case in ("clean", "bf16"))
    assert sorted(got.checks) == sorted(want.checks)
    for key in ("rebuilt", "probed", "error_rate"):
        assert got.checks[key] == want.checks[key]
    for key in ("threshold_parity", "residual_parity"):
        assert sorted(got.checks[key]) == sorted(want.checks[key])
        for name, ratio in want.checks[key].items():
            assert abs(got.checks[key][name] - ratio) <= RATIO_RTOL * abs(ratio) + REPORT_UNIT
    if case == "bf16":
        (key, parity), = got.checks["precision_parity"].items()
        assert list(want.checks["precision_parity"]) == [key] and key == "bf16:FeedForwardSpec[3]"
        assert parity["agreement_min"] >= parity["agreement_threshold"] == 0.98
    if case == "clean":
        assert set(got.checks["residual_parity"]) == {"lc-1"}


def test_gate_without_probe_rows_matches_jax(canaries):
    """A rebuilt member with no probe rows still takes the load and
    threshold gates, and is listed unprobed."""
    got = _gate("port", canaries["port"], "101", {}, "clean")
    want = _gate("jax", canaries["jax"], "101", {}, "clean")
    assert (got.passed, got.failures, got.checks["unprobed"]) == (want.passed, want.failures, ["lc-1"])
    assert got.checks["residual_parity"] == want.checks["residual_parity"] == {}


# -- the SLO hold -------------------------------------------------------------------------------------


def _write_slo_state(directory, updated):
    os.makedirs(directory, exist_ok=True)
    doc = {"version": 1, "updated_at": updated, "alerts": {
        "serve-availability:fast": {"state": "firing", "severity": "page", "since": updated},
        "serve-latency:slow": {"state": "firing", "severity": "ticket", "since": updated},
        "stream-freshness:fast": {"state": "resolved", "severity": "page", "since": updated},
    }}
    with open(os.path.join(directory, "slo_state.json"), "w") as f:
        json.dump(doc, f)


def test_slo_hold_matches_jax(bases, tmp_path, monkeypatch):
    """``load_alert_states`` and ``firing_alerts`` under the stale-alert
    hold agree, and both supervisors hold a promotion on the same firing
    page alerts: a fresh state holds, one older than ``STALE_ALERT_HOLD_S``
    does not, nor does a switched-off gate."""
    jax_base, port_base = bases
    assert slo.STALE_ALERT_HOLD_S == jax_slo.STALE_ALERT_HOLD_S == 7200.0
    telemetry_dir = str(tmp_path / "telemetry")
    monkeypatch.setenv("GORDO_TPU_TELEMETRY_DIR", telemetry_dir)
    assert slo.load_alert_states(telemetry_dir) == jax_slo.load_alert_states(telemetry_dir) == {}
    port_root, jax_root = models_root(port_base, tmp_path / "port"), models_root(jax_base, tmp_path / "jax")
    supervisors = (
        lifecycle.LifecycleSupervisor(port_machines(), os.path.join(port_root, BASE),
                                      FleetModelStore(os.path.join(port_root, BASE), torch.device("cpu"))),
        jax_lifecycle.LifecycleSupervisor(jax_machines(), os.path.join(jax_root, BASE),
                                          store=JaxFleetModelStore(max_revisions=4)),
    )
    now = datetime.now(timezone.utc)
    for age, held in ((timedelta(minutes=5), ["serve-availability:fast"]), (timedelta(hours=3), [])):
        _write_slo_state(telemetry_dir, (now - age).isoformat())
        assert slo.load_alert_states(telemetry_dir) == jax_slo.load_alert_states(telemetry_dir)
        for kwargs in ({}, {"severity": "page"}, {"severity": "page", "max_age_s": slo.STALE_ALERT_HOLD_S}):
            assert slo.firing_alerts(telemetry_dir, **kwargs) == jax_slo.firing_alerts(telemetry_dir, **kwargs)
        assert [s._slo_hold() for s in supervisors] == [held, held]
    _write_slo_state(telemetry_dir, now.isoformat())
    for supervisor in supervisors:
        supervisor.config.slo_gate = False
        assert supervisor._slo_hold() == []
        supervisor.close()


# -- guards --------------------------------------------------------------------------------------------


def _recalibration_cycle(supervisor_of, root, corpus, monkeypatch):
    """One idle cycle of a supervisor whose telemetry directory is
    ``corpus``: its report's ``details`` and the ``cost_table.json`` beside
    the corpus afterwards (None: no table)."""
    monkeypatch.setenv("GORDO_TPU_TELEMETRY_DIR", corpus)
    supervisor = supervisor_of(root)
    try:
        report = supervisor.run_cycle()
    finally:
        supervisor.close()
    path = os.path.join(corpus, "cost_table.json")
    table = None
    if os.path.exists(path):
        with open(path) as f:
            table = json.load(f)
        table["learned"]["corpus"]["directory"] = os.path.relpath(table["learned"]["corpus"]["directory"], corpus)
    events = []
    trace = os.path.join(corpus, lifecycle.LIFECYCLE_TRACE_FILE)
    if os.path.exists(trace):
        with open(trace) as f:
            events = [json.loads(line) for line in f if "perfmodel_recalibrated" in line]
    return report.details.get("perfmodel"), table, len(events)


@pytest.mark.parametrize("case", ["off", "promoting corpus", "unchanged corpus"])
def test_perfmodel_recalibration_matches_jax(bases, tmp_path, monkeypatch, case):
    """``GORDO_TPU_PERFMODEL_RECAL``: off, a cycle fits nothing; on, it fits
    the telemetry directory's corpus and promotes it into the table beside
    it; on over a corpus the table was fitted on, it skips the refit. The
    cycle report's ``details["perfmodel"]``, the event and the table on disk
    equal the JAX supervisor's."""
    from gordo_tpu.perfmodel import fit_and_promote as jax_fit_and_promote
    from gordo_tpu_torch.perfmodel import fit_and_promote
    from tests.perfmodel.conftest import grid_spans, write_corpus

    jax_base, port_base = bases
    monkeypatch.delenv("GORDO_TPU_PERFMODEL_TABLE", raising=False)
    if case == "off":
        monkeypatch.delenv("GORDO_TPU_PERFMODEL_RECAL", raising=False)
    else:
        monkeypatch.setenv("GORDO_TPU_PERFMODEL_RECAL", "1")
    port_root, jax_root = models_root(port_base, tmp_path / "port"), models_root(jax_base, tmp_path / "jax")
    runs = {
        "port": (lambda root: lifecycle.LifecycleSupervisor(
            port_machines(), os.path.join(root, BASE), FleetModelStore(os.path.join(root, BASE), torch.device("cpu"))),
            port_root, fit_and_promote),
        "jax": (lambda root: jax_lifecycle.LifecycleSupervisor(jax_machines(), os.path.join(root, BASE),
                                                               store=JaxFleetModelStore(max_revisions=4)),
                jax_root, jax_fit_and_promote),
    }
    results = {}
    for package, (supervisor_of, root, fit) in runs.items():
        corpus = str(tmp_path / f"{package}-telemetry")
        write_corpus(corpus, grid_spans(jitter=0.02))
        if case == "unchanged corpus":
            assert fit(corpus)["promoted"]
        results[package] = _recalibration_cycle(supervisor_of, root, corpus, monkeypatch)
    assert results["port"] == results["jax"]
    details, table, events = results["port"]
    if case == "off":
        assert (details, table, events) == (None, None, 0)
    elif case == "promoting corpus":
        assert details == {"promoted": True, "reason": "promoted", "models": 2} and events == 1
        assert sorted(table["learned"]["targets"]) == ["compile_ms", "device_ms"]
    else:
        assert details == {"promoted": False, "reason": "corpus unchanged since incumbent fit", "models": 0}
        assert events == 1 and table["learned"]["corpus"]["rows"] == 108


def test_lifecycle_exports_jax_names():
    assert lifecycle.__all__ == jax_lifecycle.__all__
    assert lifecycle.LIFECYCLE_TRACE_FILE == jax_lifecycle.LIFECYCLE_TRACE_FILE
