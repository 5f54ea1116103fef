"""The port's lifecycle loop (``gordo_tpu_torch/lifecycle/loop.py``, the
``lifecycle`` commands, the app's routing and restore, the stream's drift
feed) against the JAX package's, on the CPU.

Both supervisors run the same cycles over each package's base revision
(``tests/test_torch_lifecycle.py``'s three machines, built once for this
module; JAX's randomness injected into every port build): a healthy
window, a window in which ``lc-1`` has drifted 10 training stds (rebuilt,
canaried, gated, promoted), a healthy one, and one in which ``lc-2`` has
drifted under a gate no canary passes (rolled back, quarantined). Held:
the cycle reports, ``state.json`` and ``quarantine.json`` apart from
times, the health ledger's drift, quarantine and build records, the
``gordo_fleet_lifecycle_*`` counters, and the rebuilt artifacts within
``scripts/build_tolerance.py``'s ``BUILD_LIMITS`` (params 1e-6 absolute,
thresholds 3e-6 relative, CV scores 2e-5 of ``1 + |jax|``). The drift
windows' residual sums come from each package's own forward, so they are
held within 1e-5 relative; every row sum is exact.

The port alone: the quarantine cooldown, the three fault sites resuming,
the app's routing through a promotion (no 5xx, the canary's answers
stamped with its revision, a new app restoring the promotion) and the
stream's drift feed, each against what the JAX tests of the same name
(``tests/lifecycle/``) hold the JAX package to.
"""

import json
import os
import threading
from datetime import datetime, timedelta, timezone

import numpy as np
import prometheus_client
import pytest
import torch
from click.testing import CliRunner
from werkzeug.test import Client

from gordo_tpu import lifecycle as jax_lifecycle
from gordo_tpu import serializer as jax_serializer
from gordo_tpu.cli.cli import gordo_tpu_cli
from gordo_tpu.lifecycle.drift import DriftConfig as JaxDriftConfig
from gordo_tpu.lifecycle.gates import GateConfig as JaxGateConfig
from gordo_tpu.server.fleet_store import FleetModelStore as JaxFleetModelStore
from gordo_tpu_torch import lifecycle, serializer
from gordo_tpu_torch.cli.cli import main as port_cli
from gordo_tpu_torch.lifecycle.drift import DriftConfig
from gordo_tpu_torch.lifecycle.gates import GateConfig
from gordo_tpu_torch.parallel import fleet as port_fleet
from gordo_tpu_torch.server import build_app
from gordo_tpu_torch.server.fleet_store import FleetModelStore
from gordo_tpu_torch.server.prometheus import registry as port_registry
from gordo_tpu_torch.utils import faults
from tests.test_torch_fleet_build import JaxRandom
from tests.test_torch_lifecycle import (  # noqa: F401 - module fixtures, made again for this module
    BASE,
    CONFIGS,
    NAMES,
    PROJECT,
    bases,
    frames,
    jax_machines,
    jax_trainer_patch,
    models_root,
    port_machines,
    port_trainer,
    windows,
)
from tests.test_torch_prometheus import sample_value

PARAM_ATOL, THRESHOLD_RTOL, SCORE_TOL = 1e-6, 3e-6, 2e-5
RESIDUAL_RTOL = 1e-5
COUNTERS = ("rebuilds", "promotions", "rollbacks")


def config(package, **overrides):
    """The JAX lifecycle tests' settings: small windows, calibration in one
    batch, no cooldown, half the traffic to the canary."""
    module, drift_config, gate_config = ((lifecycle, DriftConfig, GateConfig) if package == "port"
                                         else (jax_lifecycle, JaxDriftConfig, JaxGateConfig))
    values = dict(canary_fraction=0.5, quarantine_cooldown_s=0.0,
                  drift=drift_config(min_samples=8, calibration_batches=1), gates=gate_config())
    values.update(overrides)
    return module.LifecycleConfig(**values)


def supervisor_for(package, root, store=None, **overrides):
    collection = os.path.join(root, BASE)
    if package == "port":
        store = store if store is not None else FleetModelStore(collection, torch.device("cpu"))
        return lifecycle.LifecycleSupervisor(port_machines(), collection, store, config=config("port", **overrides),
                                             trainer=port_trainer())
    return jax_lifecycle.LifecycleSupervisor(jax_machines(), collection,
                                             store=store if store is not None else JaxFleetModelStore(max_revisions=4),
                                             config=config("jax", **overrides))


def counters(package):
    if package == "port":
        return {event: sample_value(port_registry.REGISTRY, f"gordo_fleet_lifecycle_{event}_total",
                                    {"project": PROJECT}) or 0.0 for event in COUNTERS}
    return {event: prometheus_client.REGISTRY.get_sample_value(f"gordo_fleet_lifecycle_{event}_total",
                                                               {"project": PROJECT}) or 0.0 for event in COUNTERS}


def gauges(package):
    names = ("drifted_machines", "stale_machines", "canary_fraction")
    if package == "port":
        return [sample_value(port_registry.REGISTRY, f"gordo_fleet_lifecycle_{n}", {"project": PROJECT}) for n in names]
    return [prometheus_client.REGISTRY.get_sample_value(f"gordo_fleet_lifecycle_{n}", {"project": PROJECT})
            for n in names]


def report_doc(report):
    details = {k: v for k, v in report.details.items() if k != "swap_seconds"}
    gate = None if report.gate is None else {k: v for k, v in report.gate.items() if k != "checks"}
    return dict(phase=report.phase, drifted=report.drifted, stale=report.stale, canary=report.canary_revision,
                promoted=report.promoted, rolled_back=report.rolled_back, gate=gate, details=details)


def untimed(value):
    if isinstance(value, dict):
        return {k: untimed(v) for k, v in value.items() if k not in ("time", "evaluated_at", "since", "built_at",
                                                                     "updated_at", "last_request_at")}
    if isinstance(value, list):
        return [untimed(v) for v in value]
    return value


def ledger_records(collection):
    with open(os.path.join(collection, "fleet_health.json")) as f:
        doc = json.load(f)
    return {name: {section: untimed(record.get(section)) for section in ("drift", "quarantine")}
            | {"revision": record["build"].get("revision")} for name, record in doc["machines"].items()}


@pytest.fixture(scope="module")
def cycles(bases, windows, tmp_path_factory):
    """Each package's run of the four cycles: ``{package: (reports, root,
    store, counter deltas, gauges)}``."""
    tmp = tmp_path_factory.mktemp("cycles")
    out = {}
    patch = jax_trainer_patch()
    try:
        for package, base_dir in (("jax", bases[0]), ("port", bases[1])):
            root = models_root(base_dir, tmp / package)
            before = counters(package)
            supervisor = supervisor_for(package, root)
            reports = [supervisor.run_cycle(frames(windows))]
            reports.append(supervisor.run_cycle(frames(windows, ("lc-1",))))
            reports.append(supervisor.run_cycle(frames(windows)))
            supervisor.config.gates = (GateConfig if package == "port" else JaxGateConfig)(residual_ratio=1e-6)
            reports.append(supervisor.run_cycle(frames(windows, ("lc-2",))))
            supervisor.close()
            after = counters(package)
            out[package] = (reports, root, supervisor.store, {k: after[k] - before[k] for k in COUNTERS},
                            gauges(package))
    finally:
        patch.undo()
    return out


def test_cycles_match_jax(cycles):
    """The same verdicts, stale sets, canaries, gate outcomes and
    promotions: healthy never canaries; the drifted lc-1 alone is rebuilt
    and promoted; the drifted lc-2 is rolled back."""
    got, want = [report_doc(r) for r in cycles["port"][0]], [report_doc(r) for r in cycles["jax"][0]]
    assert got == want
    healthy, promoted, steady, rolled_back = got
    assert healthy["phase"] == steady["phase"] == "idle" and not healthy["stale"] and not steady["drifted"]
    assert promoted["stale"] == ["lc-1"] and promoted["details"]["rebuilt"] == ["lc-1"] and promoted["promoted"]
    assert promoted["canary"] == "101" and promoted["gate"]["passed"]
    assert rolled_back["rolled_back"] and rolled_back["canary"] == "102" and not rolled_back["gate"]["passed"]
    assert any("residual" in failure for failure in rolled_back["gate"]["failures"])


def test_state_and_quarantine_match_jax(cycles):
    """``state.json`` and ``quarantine.json`` alike apart from times (the
    drift windows' residual sums within 1e-5); the events in order."""
    port_root, jax_root = cycles["port"][1], cycles["jax"][1]
    got, want = lifecycle.LifecycleState.load(port_root), jax_lifecycle.LifecycleState.load(jax_root)
    drift_got, drift_want = got.doc.pop("drift"), want.doc.pop("drift")
    assert untimed(got.doc) == untimed(want.doc)
    assert [e["event"] for e in got.doc["history"]] == ["drift_detected", "canary_serving", "promoted",
                                                        "drift_detected", "canary_serving", "canary_rejected",
                                                        "rolled_back"]
    assert got.serving_revision == "101" and got.phase == "idle"
    assert sorted(drift_got) == sorted(drift_want)
    for name, snapshot in drift_want.items():
        for key, value in snapshot.items():
            if key in ("res_sum", "cal_sum"):
                assert drift_got[name][key] == pytest.approx(value, rel=RESIDUAL_RTOL)
            else:
                assert drift_got[name][key] == value, (name, key)
    assert untimed(got.quarantined()) == untimed(want.quarantined())
    assert [r["machines"] for r in got.quarantined()] == [["lc-2"]]


def test_routing_after_the_cycles_matches_jax(cycles):
    for package in ("port", "jax"):
        root, store = cycles[package][1], cycles[package][2]
        assert store.route(os.path.join(root, BASE)) == os.path.join(root, "101")
        assert store.canary_status() is None
        # the rolled-back canary was published, but takes no traffic
        assert sorted(e for e in os.listdir(root) if e.isdigit()) == [BASE, "101", "102"]


def test_ledger_and_counters_match_jax(cycles):
    """The anchor's health ledger holds the same drift, quarantine and
    build-revision records, and the lifecycle counters and gauges moved
    alike: 2 rebuilds, 1 promotion, 1 rollback."""
    got = ledger_records(os.path.join(cycles["port"][1], BASE))
    want = ledger_records(os.path.join(cycles["jax"][1], BASE))
    assert sorted(got) == sorted(want) == NAMES
    for name in NAMES:
        for key in ("feature_shift_max", "residual_ratio"):
            if key in want[name]["drift"]:
                assert got[name]["drift"].pop(key) == pytest.approx(want[name]["drift"].pop(key), rel=1e-5)
    assert got == want
    assert got["lc-2"]["quarantine"]["active"] and got["lc-2"]["quarantine"]["revision"] == "102"
    assert got["lc-1"]["revision"] == "101" and not got["lc-1"]["quarantine"]["active"]
    assert cycles["port"][3] == cycles["jax"][3] == {"rebuilds": 2.0, "promotions": 1.0, "rollbacks": 1.0}
    # the last cycle: lc-2 drifted, nothing stale, no canary serving
    assert cycles["port"][4] == cycles["jax"][4] == [1.0, 0.0, 0.0]


def test_rebuilt_member_matches_jax(cycles):
    """The promoted revision's rebuilt ``lc-1``: params, thresholds and CV
    scores within ``BUILD_LIMITS`` of the JAX rebuild's; the untouched
    members are the base's files (hardlinks)."""
    port_dir, jax_dir = os.path.join(cycles["port"][1], "101"), os.path.join(cycles["jax"][1], "101")
    port_model = serializer.load(os.path.join(port_dir, "lc-1"), "cpu")
    jax_model = jax_serializer.load(os.path.join(jax_dir, "lc-1"))
    port_params = port_model.base_estimator.steps[-1][1].params_
    jax_params = jax_model.base_estimator.steps[-1][1].params_
    for key, layer in jax_params.items():
        for leaf, value in layer.items():
            np.testing.assert_allclose(port_params[key][leaf].detach().numpy(), np.asarray(value), rtol=0,
                                       atol=PARAM_ATOL)
    np.testing.assert_allclose(port_model.feature_thresholds_, np.asarray(jax_model.feature_thresholds_),
                               rtol=THRESHOLD_RTOL)
    assert port_model.aggregate_threshold_ == pytest.approx(jax_model.aggregate_threshold_, rel=THRESHOLD_RTOL)
    scores = []
    for directory in (port_dir, jax_dir):
        with open(os.path.join(directory, "lc-1", "metadata.json")) as f:
            scores.append(json.load(f)["metadata"]["build_metadata"]["model"]["cross_validation"]["scores"])
    assert sorted(scores[0]) == sorted(scores[1])
    for key, folds in scores[1].items():
        for fold, value in folds.items():
            assert abs(scores[0][key][fold] - value) <= SCORE_TOL * (1 + abs(value)), (key, fold)
    for name in ("lc-0", "lc-2"):
        assert (os.stat(os.path.join(port_dir, name, "model.pkl")).st_ino
                == os.stat(os.path.join(cycles["port"][1], BASE, name, "model.pkl")).st_ino)


# -- the port alone, as the JAX lifecycle tests hold the JAX package ----------------------------------


def test_quarantine_cooldown_suppresses_a_canary_storm(bases, windows, tmp_path):
    root = models_root(bases[1], tmp_path)
    supervisor = supervisor_for("port", root, gates=GateConfig(residual_ratio=1e-6), quarantine_cooldown_s=3600.0)
    supervisor.run_cycle(frames(windows))
    first = supervisor.run_cycle(frames(windows, ("lc-2",)))
    assert first.rolled_back
    again = supervisor.run_cycle(frames(windows, ("lc-2",)))
    assert again.phase == "idle" and not again.stale and again.details["cooldown"] == ["lc-2"]
    assert list(again.drifted) == ["lc-2"]
    supervisor.close()


@pytest.mark.parametrize("breaker_rebuild", [True, False], ids=["feed-on", "feed-off"])
def test_breaker_feed_matches_jax(bases, windows, tmp_path, breaker_rebuild):
    """An open serving breaker in the anchor's health ledger, recorded as
    each package's engine records it, nominates its member for a rebuild
    in a healthy cycle as the JAX supervisor nominates it (rebuilt,
    canaried and promoted; the same report and ``state.json``); with
    ``breaker_rebuild`` off nothing is stale."""
    from gordo_tpu import telemetry as jax_telemetry
    from gordo_tpu.telemetry.fleet_health import reset_ledgers as jax_reset_ledgers
    from gordo_tpu_torch import telemetry as port_telemetry

    got = {}
    jax_reset_ledgers()
    port_telemetry.reset_ledgers()
    patch = jax_trainer_patch()
    try:
        for package, base_dir, telemetry in (("jax", bases[0], jax_telemetry), ("port", bases[1], port_telemetry)):
            root = models_root(base_dir, tmp_path / package)
            supervisor = supervisor_for(package, root, breaker_rebuild=breaker_rebuild)
            ledger = (telemetry.serving_ledger if package == "port" else telemetry.ledger_for)(
                supervisor.collection_dir)
            ledger.record_breaker("lc-2", "open", trips=1, cooldown_s=30.0, reason="device error")
            ledger.flush()
            try:
                report = supervisor.run_cycle(frames(windows))
            finally:
                supervisor.close()
            state = (lifecycle if package == "port" else jax_lifecycle).LifecycleState.load(root)
            state.doc.pop("drift")
            got[package] = (report_doc(report), untimed(state.doc))
    finally:
        patch.undo()
        jax_reset_ledgers()
        port_telemetry.reset_ledgers()
    assert got["port"] == got["jax"]
    report, _ = got["port"]
    if breaker_rebuild:
        assert report["details"]["breaker_tripped"] == ["lc-2"] and report["stale"] == ["lc-2"]
        assert report["details"]["rebuilt"] == ["lc-2"] and report["canary"] == "101" and report["promoted"]
    else:
        assert "breaker_tripped" not in report["details"] and report["stale"] == [] and report["phase"] == "idle"


def test_manual_promote_and_rollback(bases, windows, tmp_path):
    """With auto-promotion off a passing canary keeps its slice until
    ``promote``; ``rollback`` ends a canary; neither runs without one."""
    root = models_root(bases[1], tmp_path)
    supervisor = supervisor_for("port", root, auto_promote=False)
    supervisor.run_cycle(frames(windows))
    report = supervisor.run_cycle(frames(windows, ("lc-1",)))
    assert report.phase == "canary_serving" and report.details["gate"] == "passed; awaiting manual promote"
    assert supervisor.store.canary_status()["fraction"] == 0.5
    promoted = supervisor.promote()
    assert promoted.promoted and promoted.phase == "idle" and supervisor.serving_revision == "101"
    with pytest.raises(RuntimeError, match="no canary to promote"):
        supervisor.promote()
    with pytest.raises(RuntimeError, match="no canary to roll back"):
        supervisor.rollback()
    supervisor.run_cycle(frames(windows, ("lc-2",)))
    rolled = supervisor.rollback("operator says no")
    assert rolled.rolled_back and rolled.canary_revision == "102"
    assert supervisor.store.route(os.path.join(root, BASE)) == os.path.join(root, "101")
    assert lifecycle.LifecycleState.load(root).quarantined()[-1]["reasons"] == ["operator says no"]
    supervisor.close()


def _calibrated(root, windows, **overrides):
    supervisor = supervisor_for("port", root, **overrides)
    supervisor.run_cycle(frames(windows))
    return supervisor


def _serving_last_good(supervisor, root):
    assert supervisor.store._redirects == {}
    assert lifecycle.LifecycleState.load(root).serving_revision == BASE


def test_crash_at_canary_build_resumes_the_same_canary(bases, windows, tmp_path):
    root = models_root(bases[1], tmp_path)
    supervisor = _calibrated(root, windows)
    drifted = frames(windows, ("lc-1",))
    with faults.inject(faults.FaultRule("canary_build", exc=SystemExit)):
        with pytest.raises(SystemExit):
            supervisor.run_cycle(drifted)
    _serving_last_good(supervisor, root)
    state = lifecycle.LifecycleState.load(root)
    assert state.phase == "canary_building" and state.canary_revision == "101"
    assert "101" not in os.listdir(root)
    supervisor.close()
    resumed = supervisor_for("port", root, store=supervisor.store)
    report = resumed.run_cycle(drifted)
    assert report.canary_revision == "101" and report.promoted
    resumed.close()


def test_crash_at_promote_swap_leaves_the_canary_serving(bases, windows, tmp_path):
    root = models_root(bases[1], tmp_path)
    supervisor = _calibrated(root, windows)
    with faults.inject(faults.FaultRule("promote_swap", exc=SystemExit)):
        with pytest.raises(SystemExit):
            supervisor.run_cycle(frames(windows, ("lc-1",)))
    _serving_last_good(supervisor, root)
    assert lifecycle.LifecycleState.load(root).phase == "canary_serving"
    supervisor.close()
    resumed = supervisor_for("port", root, store=supervisor.store)
    assert resumed.run_cycle(frames(windows)).promoted
    assert lifecycle.LifecycleState.load(root).serving_revision == "101"
    resumed.close()


def test_crash_at_rollback_finishes_on_restart(bases, windows, tmp_path):
    root = models_root(bases[1], tmp_path)
    supervisor = _calibrated(root, windows, gates=GateConfig(residual_ratio=1e-6))
    with faults.inject(faults.FaultRule("rollback", exc=SystemExit)):
        with pytest.raises(SystemExit):
            supervisor.run_cycle(frames(windows, ("lc-2",)))
    _serving_last_good(supervisor, root)
    assert lifecycle.LifecycleState.load(root).phase == "rolling_back"
    supervisor.close()
    resumed = supervisor_for("port", root, store=supervisor.store, gates=GateConfig(residual_ratio=1e-6))
    assert resumed.run_cycle().rolled_back
    after = lifecycle.LifecycleState.load(root)
    assert after.phase == "idle" and after.serving_revision == BASE and after.quarantined()
    resumed.close()


def test_drift_eval_faults(bases, windows, tmp_path):
    """A crash at ``drift_eval`` leaves serving and the loop intact; an
    error there spares the other machines."""
    root = models_root(bases[1], tmp_path)
    supervisor = _calibrated(root, windows)
    with faults.inject(faults.FaultRule("drift_eval", match="lc-1", exc=SystemExit)):
        with pytest.raises(SystemExit):
            supervisor.run_cycle(frames(windows, ("lc-1",)))
    _serving_last_good(supervisor, root)
    assert lifecycle.LifecycleState.load(root).phase == "idle"
    with faults.inject(faults.FaultRule("drift_eval", match="lc-0", times=None)):
        report = supervisor.run_cycle(frames(windows, ("lc-1",)))
    assert "lc-0" not in report.drifted and report.details["rebuilt"] == ["lc-1"] and report.promoted
    supervisor.close()


def _frame_json(name, rows):
    """``rows`` of machine ``name`` as a JSON frame at 10-minute stamps."""
    stamps = [(datetime(2020, 3, 1, tzinfo=timezone.utc) + timedelta(minutes=10 * i)).isoformat()
              for i in range(len(rows))]
    return {f"t{3 * NAMES.index(name) + j}": dict(zip(stamps, map(float, rows[:, j]))) for j in range(3)}


def _post(client, name, rows, revision=None):
    payload = {"X": _frame_json(name, rows), "y": _frame_json(name, rows)}
    query = f"?revision={revision}" if revision else ""
    return client.post(f"/gordo/v0/{PROJECT}/{name}/anomaly/prediction{query}", json=payload)


def test_app_routes_through_a_promotion(bases, windows, tmp_path, monkeypatch):
    """The app's unpinned requests follow the store's routing: half go to
    the canary (stamped with its revision), none answers 5xx while the
    canary is promoted, later ones are served by it, a pinned one still
    goes where it pins, and an app made afterwards restores the promotion."""
    root = models_root(bases[1], tmp_path)
    collection = os.path.join(root, BASE)
    monkeypatch.setenv("GORDO_TPU_SERVE_WARMUP", "0")
    app = build_app(collection, device="cpu")
    client = Client(app)
    supervisor = lifecycle.LifecycleSupervisor(port_machines(), collection, app.store,
                                               config=config("port", auto_promote=False), engine=app.engine,
                                               trainer=port_trainer())
    supervisor.run_cycle(frames(windows))
    assert supervisor.run_cycle(frames(windows, ("lc-1",))).phase == "canary_serving"
    rows = windows["lc-1"][0]
    served = []
    for _ in range(8):
        response = _post(client, "lc-1", rows)
        assert response.status_code == 200, response.json
        assert response.json["revision"] == response.headers["revision"]
        served.append(response.headers["revision"])
    assert served == [BASE, "101"] * 4
    statuses, stop = [], threading.Event()

    def hammer():
        while not stop.is_set():
            statuses.append(_post(Client(app), "lc-0", windows["lc-0"][0]).status_code)

    thread = threading.Thread(target=hammer)
    thread.start()
    try:
        assert supervisor.promote().promoted
    finally:
        stop.set()
        thread.join(timeout=60)
    assert statuses and all(status < 500 for status in statuses)
    assert {_post(client, "lc-1", rows).headers["revision"] for _ in range(3)} == {"101"}
    assert _post(client, "lc-1", rows, revision=BASE).headers["revision"] == BASE
    supervisor.close()
    restarted = build_app(collection, device="cpu")
    assert restarted.store.route(collection) == os.path.join(root, "101")
    assert Client(restarted).get(f"/gordo/v0/{PROJECT}/models").json["revision"] == "101"
    # a torn state file is logged, and the server serves its own directory
    with open(os.path.join(root, ".lifecycle", "state.json"), "w") as f:
        f.write("{torn")
    torn = build_app(collection, device="cpu")
    assert torn.store.route(collection) == collection


def test_stream_flushes_feed_the_drift_monitor(bases, windows, tmp_path, monkeypatch):
    """An attached supervisor's monitor takes every flush's rows and mse;
    a drifted stream alone trips the machine."""
    root = models_root(bases[1], tmp_path)
    collection = os.path.join(root, BASE)
    monkeypatch.setenv("GORDO_TPU_STREAM_WINDOW_ROWS", "8")
    app = build_app(collection, device="cpu")
    supervisor = lifecycle.LifecycleSupervisor(port_machines(), collection, app.store,
                                               config=config("port", auto_promote=False), trainer=port_trainer())
    supervisor.attach_stream(app.ensure_plane())
    client = Client(app)

    def ingest(drifted):
        window = frames(windows, drifted)
        payload = {"X": {name: _frame_json(name, rows) for name, rows in window.items()}}
        response = client.post(f"/gordo/v0/{PROJECT}/stream/s1/ingest", json=payload)
        assert response.status_code == 200, response.json
        return window

    window = ingest(())
    # 25 rows a machine: three 8-row windows are cut and scored, one row waits
    window = {name: rows[:24] for name, rows in window.items()}
    scores, _ = app.store.fleet().fleet_scores(window)
    for name in NAMES:
        snapshot = supervisor.monitor.snapshot()[name]
        assert snapshot["n"] == 24
        np.testing.assert_array_equal(snapshot["sum"], window[name].sum(axis=0))
        assert snapshot["cal_sum"] == pytest.approx(float(scores[name][1].sum()), rel=1e-6)
    ingest(("lc-2",))
    report = supervisor.run_cycle()
    assert list(report.drifted) == ["lc-2"] and report.stale == ["lc-2"]
    supervisor.close()


# -- the commands -----------------------------------------------------------------------------------


def run_both(capsys, args, jax_root, port_root):
    capsys.readouterr()
    jax = CliRunner().invoke(gordo_tpu_cli, [a.format(jax_root) for a in args])
    code = port_cli([a.format(port_root) for a in args] + (["--device", "cpu"] if args[1] in (
        "run", "promote", "rollback") else []))
    out = capsys.readouterr()
    return (jax.exit_code, jax.stdout, jax.stderr), (code, out.out, out.err)


def masked(result):
    code, out, err = result
    return code, "\n".join("  promoted (swap Ts)" if line.startswith("  promoted (swap") else line
                           for line in out.splitlines()), err


def test_lifecycle_commands_match_jax(bases, windows, tmp_path, capsys, monkeypatch):
    """``status`` (text and ``--as-json``), ``promote`` (refused without a
    probe, gated with ``--machines-config``, ``--force``), ``rollback`` and
    ``run --once`` print and exit as the JAX commands do on the same
    state."""
    monkeypatch.setattr(port_fleet, "TorchRandom", JaxRandom)
    shard = tmp_path / "machines.json"
    shard.write_text(json.dumps({"project_name": PROJECT, "machines": CONFIGS}))
    roots = {}
    patch = jax_trainer_patch()
    try:
        for package, base_dir in (("jax", bases[0]), ("port", bases[1])):
            roots[package] = models_root(base_dir, tmp_path / package)
            supervisor = supervisor_for(package, roots[package], auto_promote=False)
            supervisor.run_cycle(frames(windows))
            assert supervisor.run_cycle(frames(windows, ("lc-1",))).phase == "canary_serving"
            supervisor.close()
        results = []

        def both(*args):
            jax, port = run_both(capsys, list(args), roots["jax"], roots["port"])
            results.append(args)
            return masked(jax), masked(port)

        status = both("lifecycle", "status", "{}", "--as-json")
        assert status[0][0] == status[1][0] == 0
        assert untimed(json.loads(status[1][1])) == untimed(json.loads(status[0][1]))
        jax, port = both("lifecycle", "status", "{}")
        assert port == jax and "phase:    canary_serving" in port[1]
        jax, port = both("lifecycle", "promote", "{}/" + BASE)
        assert port == jax and port[0] == 1 and "gates could not run" in port[2]
        jax, port = both("lifecycle", "rollback", "{}/" + BASE, "--reason", "drill")
        assert port == jax and port[0] == 0 and "rolled back" in port[1]
        jax, port = both("lifecycle", "rollback", "{}/" + BASE)
        assert port == jax and port[0] == 1 and "no canary to roll back (phase idle)" in port[2]
        for package in ("jax", "port"):
            supervisor = supervisor_for(package, roots[package], auto_promote=False)
            assert supervisor.run_cycle(frames(windows, ("lc-1",))).phase == "canary_serving"
            supervisor.close()
        jax, port = both("lifecycle", "promote", "{}/" + BASE, "--machines-config", str(shard))
        assert port == jax and port[0] == 0 and "  gates: PASSED" in port[1] and "  promoted (swap Ts)" in port[1]
        jax, port = both("lifecycle", "promote", "{}/" + BASE, "--force")
        assert port == jax and port[0] == 1
        jax, port = both("lifecycle", "run", str(shard), "{}/" + BASE, "--once")
        assert port == jax and port[0] == 0 and port[1] == "phase: idle"
        jax, port = both("lifecycle", "run", str(shard), "{}/" + BASE, "--dry-run", "--cycles", "1")
        assert port == jax and port[1].splitlines() == [f"{name}: ok " for name in NAMES]
        jax, port = both("lifecycle", "status", "{}")
        assert port == jax and "serving:  102" in port[1] and "quarantined canaries: 1" in port[1]
    finally:
        patch.undo()
