"""The port's packed fleet fit (``gordo_tpu_torch/models/packing.py``,
``FleetTrainer(packing=)``) against the JAX package's
``build_packed_fit_fn`` through its trainer (``gordo_tpu/parallel/fleet.py``
on a one-device mesh), and the packed planner's replay in the fleet
build, on the CPU, JAX's init and permutations injected
(``tests/test_torch_fleet_build.py::JaxRandom``).

Tolerances as ``tests/test_torch_training.py`` holds the unpacked fit:
per-epoch losses rtol 1e-5, params atol 1e-5. Measured on the CPU (torch
2.13, jax 0.9): params within 3e-8, losses within 2e-7 relative; the f32
sums run in another order (``baddbmm`` over members against a
block-diagonal matmul). The shared Adam count is what moves a ragged
member away from its unpacked fit (by ~1e-4 here), so the parity is a
test of the packed semantics, not of the unpacked ones.
"""

import json
import os

import jax
import numpy as np
import pytest

from gordo_tpu import serializer as jax_serializer
from gordo_tpu.machine import Machine as JaxMachine
from gordo_tpu.models.factories.feedforward_autoencoder import feedforward_hourglass as jax_hourglass
from gordo_tpu.models.training import FitConfig as JaxFitConfig
from gordo_tpu.parallel import fleet as jax_fleet
from gordo_tpu.parallel.fleet import FleetMember as JaxFleetMember
from gordo_tpu.parallel.fleet import FleetTrainer as JaxFleetTrainer
from gordo_tpu.parallel.fleet_build import FleetBuilder as JaxFleetBuilder
from gordo_tpu.parallel.mesh import make_mesh as jax_make_mesh
from gordo_tpu_torch import planner, serializer
from gordo_tpu_torch.machine import Machine
from gordo_tpu_torch.models.factories import feedforward_hourglass
from gordo_tpu_torch.models.packing import PackedFit, auto_packing, unpack_params
from gordo_tpu_torch.models.training import FitConfig
from gordo_tpu_torch.parallel.fleet import FleetMember, FleetTrainer
from gordo_tpu_torch.parallel.fleet_build import FleetBuilder, packing_from_env, rebuild_stale
from gordo_tpu_torch.parallel.journal import BuildJournal
from gordo_tpu_torch.utils.faults import FaultRule, inject
from tests.test_torch_fleet_build import JaxRandom

LOSS_RTOL, PARAM_ATOL = 1e-5, 1e-5
ROWS = (64, 40, 57, 64, 33, 50, 64)


def _one_device():
    return jax_make_mesh(jax.devices()[:1])


def _members(cls, spec, separate_y=False, weights=False):
    """Seven members of one spec, rows ``ROWS`` (one pad target, 64, at
    batch 16: a ragged bucket), member 4 with explicit train weights
    when ``weights``, ``y`` apart from ``X`` when ``separate_y``."""
    rng = np.random.RandomState(17)
    members = []
    for i, n in enumerate(ROWS):
        X = rng.rand(n, 6).astype(np.float32)
        y = (0.5 * X + 0.1).astype(np.float32) if separate_y else X
        train_weights = None
        if weights and i == 4:
            train_weights = np.zeros(n, np.float32)
            train_weights[:20] = 1.0
        members.append(cls(f"m-{i}", spec, X, y, train_weights=train_weights, seed=300 + i))
    return members


CASES = {
    "ragged, shuffle, g=3": dict(packing=3, config=dict(epochs=3, batch_size=16)),
    "ragged, no shuffle, validation split, auto": dict(
        packing="auto", config=dict(epochs=3, batch_size=16, shuffle=False, validation_split=0.25)),
    "y apart from X, train weights, g=4": dict(packing=4, config=dict(epochs=2, batch_size=16), separate_y=True,
                                               weights=True),
}


@pytest.mark.parametrize("name", list(CASES))
def test_packed_fit_matches_jax(name):
    """Packs of consecutive members, the last one short; members shorter
    than the bucket (their last batches padding while a packmate's are
    not: the shared Adam count), hourglass(6)'s L1 activity term,
    validation rows, explicit train weights, ``y`` apart from ``X``."""
    case = CASES[name]
    opts = dict(separate_y=case.get("separate_y", False), weights=case.get("weights", False))
    jax_spec, spec = jax_hourglass(6), feedforward_hourglass(6)
    assert spec.l1_activity
    want = JaxFleetTrainer(mesh=_one_device(), packing=case["packing"]).train(
        _members(JaxFleetMember, jax_spec, **opts), JaxFitConfig(**case["config"]))
    trainer = FleetTrainer("cpu", JaxRandom(), packing=case["packing"])
    got = trainer.train(_members(FleetMember, spec, **opts), FitConfig(**case["config"]))
    g = auto_packing(spec, len(ROWS)) if case["packing"] == "auto" else case["packing"]
    assert [(f["packed"], f["members"]) for f in trainer.fits] == [(g, len(ROWS))]
    for result, expected in zip(got, want):
        assert result.name == expected.name
        assert result.history.params == expected.history.params and result.history.params["packed"] == g
        assert list(result.history.history) == list(expected.history.history)
        for key, values in expected.history.history.items():
            np.testing.assert_allclose(result.history.history[key], values, rtol=LOSS_RTOL, err_msg=key)
        for key, layer in expected.params.items():
            for leaf, value in layer.items():
                np.testing.assert_allclose(result.params[key][leaf], np.asarray(value), atol=PARAM_ATOL)
    if case["config"].get("shuffle", True) is False:
        # unshuffled, a member of full length trains as it would alone; a ragged one does not
        alone = FleetTrainer("cpu", JaxRandom()).train(_members(FleetMember, spec, **opts),
                                                       FitConfig(**case["config"]))
        np.testing.assert_allclose(alone[0].params["out"]["W"], got[0].params["out"]["W"], atol=1e-6)
        assert np.abs(alone[1].params["out"]["W"] - got[1].params["out"]["W"]).max() > 1e-6


def test_unpack_params_and_the_pack_spec():
    spec = feedforward_hourglass(6)
    fit = PackedFit(spec, FitConfig(), 4)
    assert (fit.packed.base, fit.packed.g) == (spec, 4)
    packed = {"out": {"W": np.arange(8).reshape(4, 2), "b": np.arange(4)}}
    assert unpack_params(packed, fit.packed, 2)["out"]["W"].tolist() == [4, 5]
    with pytest.raises(ValueError, match="early stopping"):
        PackedFit(spec, FitConfig(early_stopping=("loss", 1, 0.0, False)), 4)


def test_early_stopping_falls_back_to_the_unpacked_fit():
    """A bucket with early stopping trains unpacked, packing on or off,
    in both packages."""
    config = dict(epochs=3, batch_size=16, validation_split=0.25, early_stopping=("val_loss", 1, 0.0, False))
    trainer = FleetTrainer("cpu", JaxRandom(), packing="auto")
    packed = trainer.train(_members(FleetMember, feedforward_hourglass(6)), FitConfig(**config))
    plain = FleetTrainer("cpu", JaxRandom()).train(_members(FleetMember, feedforward_hourglass(6)), FitConfig(**config))
    want = JaxFleetTrainer(mesh=_one_device(), packing="auto").train(
        _members(JaxFleetMember, jax_hourglass(6)), JaxFitConfig(**config))
    assert trainer.fits[0]["packed"] == 1
    for a, b, w in zip(packed, plain, want):
        assert "packed" not in a.history.params and "packed" not in w.history.params
        assert a.history.history == b.history.history
        np.testing.assert_array_equal(a.params["out"]["W"], b.params["out"]["W"])


@pytest.mark.parametrize("raw,want", [("auto", "auto"), ("4", 4), ("four", None), ("", None)])
def test_packing_knob_matches_jax(raw, want, monkeypatch, caplog):
    monkeypatch.setattr(jax_fleet, "make_mesh", lambda *a, **k: _one_device())
    monkeypatch.setenv("GORDO_TPU_PACKING", raw)
    assert packing_from_env() == want
    assert FleetBuilder([], device="cpu").trainer.packing == JaxFleetBuilder([]).trainer.packing == want
    if raw == "four":
        assert "Invalid GORDO_TPU_PACKING='four'" in caplog.text and "packing disabled" in caplog.text


# -- the build: packed plans, packed fits, replay -------------------------------------------------------------

PROJECT = "packing-test"


def _config(name, days, tags):
    return {"name": name, "dataset": {
        "type": "RandomDataset", "train_start_date": "2020-01-01T00:00:00+00:00",
        "train_end_date": f"2020-01-{1 + days:02d}T00:00:00+00:00", "tag_list": tags},
        "model": {"gordo_tpu.models.anomaly.diff.DiffBasedAnomalyDetector": {"base_estimator": {
            "sklearn.pipeline.Pipeline": {"steps": ["sklearn.preprocessing.MinMaxScaler", {
                "gordo_tpu.models.JaxAutoEncoder": {"kind": "feedforward_hourglass", "encoding_layers": 1,
                                                    "epochs": 2}}]}}}}}


#: four machines of one spec (145 to 721 rows) and one of another
CONFIGS = [_config("pk-a", 1, ["a", "b", "c"]), _config("pk-b", 2, ["d", "e", "f"]),
           _config("pk-c", 4, ["g", "h", "i"]), _config("pk-d", 5, ["j", "k", "l"]), _config("pk-e", 2, ["m", "n"])]


def _port_machines(jax_machines):
    out = []
    for config, machine in zip(CONFIGS, jax_machines):
        X, y = machine.dataset.get_data()
        out.append(Machine.from_config({**config, "dataset": machine.dataset.to_dict()}, PROJECT,
                                       data=(X.to_numpy(), y.to_numpy()), index=list(X.index)))
    return out


@pytest.fixture(scope="module")
def packed_builds(tmp_path_factory):
    """Both packages' packed build of ``CONFIGS`` with
    ``GORDO_TPU_PACKING=auto``: ``(jax dir, port dir, port builder, port
    machines)``."""
    root = tmp_path_factory.mktemp("packed-builds")
    patch = pytest.MonkeyPatch()
    patch.setattr(jax_fleet, "make_mesh", lambda *a, **k: _one_device())
    patch.setenv("GORDO_TPU_PACKING", "auto")
    try:
        jax_machines = [JaxMachine.from_config(c, project_name=PROJECT) for c in CONFIGS]
        JaxFleetBuilder(jax_machines, plan_strategy="packed").build(output_dir=str(root / "jax"))
        machines = _port_machines(jax_machines)
        builder = FleetBuilder(machines, device="cpu", random=JaxRandom(), plan_strategy="packed")
        builder.build(output_dir=str(root / "port"))
    finally:
        patch.undo()
    assert builder.build_errors == {}
    return str(root / "jax"), str(root / "port"), builder, machines


def test_packed_build_matches_jax(packed_builds):
    """The slice as a whole: ``fleet_plan.json`` byte for byte, the CV
    folds packed live under the strategy, the final fit packed, and every
    machine's params, thresholds and CV scores within tolerance."""
    jax_dir, port_dir, builder, _ = packed_builds
    with open(os.path.join(jax_dir, "fleet_plan.json")) as f, open(os.path.join(port_dir, "fleet_plan.json")) as g:
        assert g.read() == f.read()
    plan = planner.FleetPlan.load(os.path.join(port_dir, "fleet_plan.json"))
    assert plan.strategy == "packed" and plan.doc["cost_table"]["calibrated"] is False
    packed = [(f["members"], f["packed"]) for f in builder.trainer.fits]
    assert all(g > 1 for m, g in packed if m > 1) and any(g == 4 for _, g in packed)
    assert BuildJournal.load(port_dir).plan() == {"plan_hash": plan.plan_hash, "strategy": "packed"}
    with open(os.path.join(port_dir, "fleet_health.json")) as f, open(os.path.join(jax_dir, "fleet_health.json")) as g:
        accuracy, jax_accuracy = json.load(f)["plan_accuracy"], json.load(g)["plan_accuracy"]
    assert accuracy["strategy"] == jax_accuracy["strategy"] == "packed"
    assert accuracy["plan_hash"] == jax_accuracy["plan_hash"] == plan.plan_hash
    for config in CONFIGS:
        name = config["name"]
        model = serializer.load(os.path.join(port_dir, name), "cpu")
        jax_model = jax_serializer.load(os.path.join(jax_dir, name))
        np.testing.assert_allclose(model.feature_thresholds_, jax_model.feature_thresholds_.to_numpy(float),
                                   rtol=1e-5)
        np.testing.assert_allclose(model.aggregate_threshold_, jax_model.aggregate_threshold_, rtol=1e-5)
        params = model.base_estimator.estimator.params_
        for key, layer in jax_model.base_estimator.steps[-1][1].params_.items():
            for leaf, value in layer.items():
                np.testing.assert_allclose(params[key][leaf].numpy(), np.asarray(value), atol=PARAM_ATOL)
        scores = serializer.load_metadata(os.path.join(port_dir, name))["metadata"]["build_metadata"]["model"]
        with open(os.path.join(jax_dir, name, "metadata.json")) as f:
            jax_scores = json.load(f)["metadata"]["build_metadata"]["model"]
        for key, folds in jax_scores["cross_validation"]["scores"].items():
            np.testing.assert_allclose(list(scores["cross_validation"]["scores"][key].values()), list(folds.values()),
                                       rtol=1e-5, atol=1e-5, err_msg=key)
        assert scores["training"]["epochs_run"] == 2


def test_replayed_packed_plan_reaches_the_cv_folds(packed_builds, tmp_path):
    """A packed plan handed to a default trainer: its strategy rides onto
    the trainer, so the CV fold members (which no plan covers) pack on
    the packed ladder, not pow2; the final fit replays the plan's
    buckets; the trainer keeps no strategy afterwards."""
    _, port_dir, _, machines = packed_builds
    plan = planner.FleetPlan.load(os.path.join(port_dir, "fleet_plan.json"))
    builder = FleetBuilder(machines, device="cpu", random=JaxRandom(), fleet_plan=plan)
    builder.build(output_dir=str(tmp_path / "replay"))
    ladder = {planner.round_up_ladder(max(r, 32), 1.25, 32) for r in (145, 289, 577, 721)}
    cv = [f for f in builder.trainer.fits if "::fold" in f["names"][0]]
    final = [f for f in builder.trainer.fits if "::fold" not in f["names"][0]]
    assert cv and {f["rows"] for f in cv} <= ladder
    planned = {b["id"]: (b["members"], b["n_padded"]) for b in plan.buckets}
    assert {f["bucket"]: (f["names"], f["rows"]) for f in final} == planned
    assert builder.trainer.plan_strategy is None and builder.trainer.fleet_plan is plan


def test_plan_from_across_a_kill_and_resume(packed_builds, tmp_path):
    """``--plan-from``'s plan replayed by a build killed once two artifacts
    landed (the later dumps die mid-write), then by its resume: every
    final fit at its planned bucket and rows, the journal keeping the
    plan's hash."""
    _, port_dir, _, machines = packed_builds
    plan = planner.FleetPlan.load(os.path.join(port_dir, "fleet_plan.json"))
    out = str(tmp_path / "out")
    with inject(FaultRule("dump_artifact", after=2, times=None, exc=SystemExit)):
        with pytest.raises(SystemExit):
            FleetBuilder(machines, device="cpu", fleet_plan=plan).build(output_dir=out)
    landed = serializer.list_model_dirs(out)
    assert len(landed) == 2
    resumer = FleetBuilder(machines, device="cpu", fleet_plan=plan)
    resumer.build(output_dir=out, resume=True)
    assert sorted(resumer.resumed) == landed and serializer.list_model_dirs(out) == sorted(c["name"] for c in CONFIGS)
    planned = {b["id"]: (b["members"], b["n_padded"]) for b in plan.buckets}
    for fit in resumer.trainer.fits:
        if "::fold" not in fit["names"][0]:
            members, rows = planned[fit["bucket"]]
            assert set(fit["names"]) <= set(members) and fit["rows"] == rows
    assert BuildJournal.load(out).plan() == {"plan_hash": plan.plan_hash, "strategy": "packed"}


def test_rebuild_stale_replays_a_packed_base_plan(packed_builds, tmp_path, monkeypatch):
    _, port_dir, _, machines = packed_builds
    monkeypatch.setenv("GORDO_TPU_PACKING", "auto")
    builder = rebuild_stale(machines, ["pk-b", "pk-c"], str(tmp_path / "rebuild"),
                            base_plan_path=os.path.join(port_dir, "fleet_plan.json"), device="cpu")
    assert builder.build_errors == {} and serializer.list_model_dirs(str(tmp_path / "rebuild")) == ["pk-b", "pk-c"]
    plan = planner.FleetPlan.load(os.path.join(port_dir, "fleet_plan.json"))
    entries = {name: b for b in plan.buckets for name in b["members"]}
    for fit in builder.trainer.fits:
        if "::fold" not in fit["names"][0]:
            assert all(entries[n]["id"] == fit["bucket"] and entries[n]["n_padded"] == fit["rows"]
                       for n in fit["names"])
    assert BuildJournal.load(str(tmp_path / "rebuild")).plan()["strategy"] == "packed"


def test_m_padded_bucket_is_not_block_packed(packed_builds, tmp_path, monkeypatch):
    """Under an HBM cap that splits a rung, the sibling buckets share a
    member rung and train unpacked (JAX: their one compile needs the
    member axis); a bisected half drops the planned rung. These members
    are a few KiB each, so the cap is set below the knob's 1 MiB floor."""
    _, _, _, machines = packed_builds
    with monkeypatch.context() as patch:
        patch.setattr(planner.packing, "hbm_cap_bytes", lambda: 60_000)
        plan = FleetBuilder(machines, device="cpu", plan_strategy="packed").plan_only()
    split = [b for b in plan.buckets if b["m_padded"]]
    assert split and all(b["m_padded"] >= len(b["members"]) for b in split)
    target = max(split, key=lambda b: len(b["members"]))
    assert len(target["members"]) >= 2
    trainer = FleetTrainer("cpu", packing="auto", plan_strategy="packed")
    trainer.fleet_plan = plan
    builder = FleetBuilder(machines, trainer=trainer)
    with inject(FaultRule("device_program", match=target["members"][0], times=1)):
        builder.build()
    assert builder.build_errors == {}
    final = [f for f in trainer.fits if "::fold" not in f["names"][0]]
    by_bucket = {}
    for fit in final:
        by_bucket.setdefault(fit["bucket"], []).append(fit)
    for bucket in split:
        fits = by_bucket[bucket["id"]]
        assert all(f["packed"] == 1 for f in fits)
        if len(fits) == 1:
            assert fits[0]["m_padded"] == bucket["m_padded"]
        else:  # the bisected halves
            assert all(f["m_padded"] is None for f in fits)
    # packing was on: the CV folds, packed live without a member rung, were block-packed
    assert any(f["packed"] > 1 for f in trainer.fits if "::fold" in f["names"][0])
    assert trainer.bucket_bisects >= 1
