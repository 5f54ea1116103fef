"""The port's packing planner (``gordo_tpu_torch/planner/``) against the
JAX package's (``gordo_tpu/planner/``), on the CPU: the geometric ladder,
the cost table's round trip and version refusal, ``calibrate`` over one
synthetic trace, the ``packed`` strategy's buckets and predictions bucket
for bucket (with and without a compile budget and an HBM cap, dense and
windowed members mixed), ``plan --as-json`` byte for byte and the text
table of ``plan`` on one config on a one-device JAX mesh, and the texts
for an unusable plan or table. Members are duck-typed stand-ins, as the
JAX planner's own tests use them (``tests/planner/test_packing.py``)."""

import json
from types import SimpleNamespace

import jax
import numpy as np
import pytest
from click.testing import CliRunner

from gordo_tpu import planner as jax_planner
from gordo_tpu.cli.cli import gordo_tpu_cli
from gordo_tpu.models.spec import FeedForwardSpec as JaxFeedForwardSpec
from gordo_tpu.models.spec import LSTMSpec as JaxLSTMSpec
from gordo_tpu.models.training import FitConfig as JaxFitConfig
from gordo_tpu.parallel import fleet as jax_fleet
from gordo_tpu.parallel.mesh import make_mesh as jax_make_mesh
from gordo_tpu.planner import packing as jax_packing
from gordo_tpu_torch import planner
from gordo_tpu_torch.cli.cli import main
from gordo_tpu_torch.models.spec import FeedForwardSpec, LSTMSpec
from gordo_tpu_torch.models.training import FitConfig
from gordo_tpu_torch.planner import packing

SPECS = {"port": {"ff": FeedForwardSpec, "lstm": LSTMSpec}, "jax": {"ff": JaxFeedForwardSpec, "lstm": JaxLSTMSpec}}
SPEC_ARGS = [("ff", (20, 20, (15, 10, 15), ("tanh",) * 3)), ("ff", (40, 40, (30, 20, 30), ("tanh",) * 3)),
             ("lstm", (4, 4, 6, (8, 4), ("tanh", "tanh")))]


def _members(package, seed, count=30, kinds=(0, 1, 2)):
    """Seeded stand-ins: dense members (``n``, ``X``, ``y`` aliased or not)
    of two feedforward specs, windowed members (``series``, ``n_windows``)
    of an LSTM spec at two model offsets, 100 to 3000 rows."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(count):
        kind, args = SPEC_ARGS[kinds[rng.randint(len(kinds))]]
        spec, n = SPECS[package][kind](*args), int(rng.randint(100, 3000))
        if kind == "lstm":
            out.append(SimpleNamespace(name=f"m{i}", spec=spec, series=range(n), n_windows=n - int(rng.choice([5, 6]))))
        else:
            x = object()
            out.append(SimpleNamespace(name=f"m{i}", spec=spec, n=n, X=x, y=x if rng.rand() < 0.7 else object()))
    return out


def _shape(buckets):
    return [(b.bucket_id, b.program, b.member_names, b.n_padded, b.m_padded, b.offset, b.windowed, b.predicted)
            for b in buckets]


@pytest.mark.parametrize("ratio", [1.25, 1.6, 2.0])
def test_ladder_matches_jax(ratio, monkeypatch):
    for lo, hi, multiple in ((1, 50, 1), (600, 2000, 32), (100, 52_560, 16)):
        assert planner.geometric_rungs(lo, hi, ratio, multiple) == jax_planner.geometric_rungs(lo, hi, ratio, multiple)
    monkeypatch.setenv("GORDO_TPU_PLAN_PAD_RATIO", str(ratio))
    assert planner.sample_pad_ratio() == jax_planner.sample_pad_ratio() == ratio
    monkeypatch.setenv("GORDO_TPU_PLAN_PAD_RATIO", "1.0")
    assert planner.sample_pad_ratio() == jax_planner.sample_pad_ratio() == 1.25


def test_cost_table_round_trip_and_wrong_version(tmp_path):
    learned = {"version": 1, "features": list(jax_planner.LEARNED_FEATURES), "targets": {"device_ms": {
        "fleet_fit": {"coef": [0.1] * 7, "lo": [0.0] * 6, "hi": [1.0] * 6}}}}
    fields = dict(throughput=3e9, run_factors={"fleet_fit": 0.5, "fleet_packed_fit": 0.25},
                  compile_factors={"fleet_fit": 2.0}, samples={"fleet_fit": 7}, learned=learned)
    table, jax_table = planner.CostTable(**fields), jax_planner.CostTable(**fields)
    assert table.to_dict() == jax_table.to_dict() and table.calibrated and table.learned == learned
    table.precision_factors["bf16"] = 0.5
    table.save(str(tmp_path / "t.json"))
    assert planner.CostTable.load(str(tmp_path / "t.json")) == table
    assert jax_planner.CostTable.load(str(tmp_path / "t.json")).to_dict() == table.to_dict()
    assert not planner.CostTable().calibrated and planner.CostTable().to_dict() == jax_planner.CostTable().to_dict()
    bad = dict(table.to_dict(), learned={"version": 9})
    assert planner.CostTable.from_dict(bad).learned is None  # a bad section degrades, the table loads
    for version in (0, 2):
        with pytest.raises(ValueError) as port_error:
            planner.CostTable.from_dict(dict(table.to_dict(), version=version))
        with pytest.raises(ValueError) as jax_error:
            jax_planner.CostTable.from_dict(dict(table.to_dict(), version=version))
        assert str(port_error.value) == str(jax_error.value)
    (tmp_path / "torn.json").write_text('{"version": 1, "run_f')
    assert planner.load_table_safe(str(tmp_path / "torn.json")) == planner.CostTable()
    assert planner.load_table_safe(str(tmp_path / "missing.json")) == planner.CostTable()


def test_calibrate_matches_jax(tmp_path):
    """Compile and run spans of three programs, a device-timed span, a
    zero ``device_ms`` (skipped), spans without the features, a torn last
    line."""
    rng = np.random.RandomState(5)
    lines = []
    for i in range(25):
        program = ("fleet_fit", "fleet_packed_fit", "fleet_windowed_fit")[i % 3]
        attrs = dict(program=program, flops_per_sample=float(rng.choice([1800.0, 7000.0])), epochs=5,
                     stacked_members=int(rng.randint(1, 64)), stacked_samples=int(rng.choice([608, 1152, 2048])),
                     compile=bool(i < 6))
        if i % 5 == 4:
            attrs["device_ms"] = 0.0 if i == 9 else float(rng.uniform(1, 500))
        lines.append(json.dumps({"name": "device_program", "duration_ms": float(rng.uniform(5, 3000)),
                                 "attributes": attrs}))
    lines.append(json.dumps({"name": "device_program", "duration_ms": 3.0, "attributes": {"program": "fleet_predict"}}))
    lines.append(json.dumps({"name": "build_phase", "duration_ms": 9.0, "attributes": {"phase": "cv_train"}}))
    lines.append('{"name": "device_program", "dura')
    trace = tmp_path / "build_trace.jsonl"
    trace.write_text("\n".join(lines))
    base = dict(throughput=1e9, dispatch_s=0.02)
    table = planner.calibrate(str(trace), planner.CostTable(**base))
    want = jax_planner.calibrate(str(trace), jax_planner.CostTable(**base))
    assert table.to_dict() == want.to_dict()
    assert table.samples == {"fleet_fit": 8, "fleet_packed_fit": 8, "fleet_windowed_fit": 8}
    assert set(table.compile_factors) == set(table.run_factors) == set(table.samples)


PACKED_CASES = {
    "mixed, no budget": dict(budget=0, hbm_cap=None),
    "mixed, budget 3": dict(budget=3, hbm_cap=None),
    "mixed, HBM cap 2 MiB": dict(budget=0, hbm_cap=2 << 20),
    "mixed, budget 4 and HBM cap 1 MiB": dict(budget=4, hbm_cap=1 << 20),
    "dense, budget 2 and HBM cap 1 MiB": dict(budget=2, hbm_cap=1 << 20, kinds=(0, 1)),
}


@pytest.mark.parametrize("case", list(PACKED_CASES))
@pytest.mark.parametrize("seed", [0, 1])
def test_packed_buckets_match_jax(case, seed):
    """Bucket for bucket and in order: rosters, pad targets, member rungs
    (a split rung's siblings share one), ids and the predictions."""
    opts = dict(PACKED_CASES[case])
    kinds = opts.pop("kinds", (0, 1, 2))
    config, jax_config = FitConfig(epochs=5, batch_size=32), JaxFitConfig(epochs=5, batch_size=32)
    got = planner.plan_train_buckets(_members("port", seed, kinds=kinds), config, strategy="packed", **opts)
    want = jax_planner.plan_train_buckets(_members("jax", seed, kinds=kinds), jax_config, strategy="packed",
                                          cost_model=jax_planner.CostModel(), **opts)
    assert _shape(got) == _shape(want)
    assert len(got) < len(planner.plan_train_buckets(_members("port", seed, kinds=kinds), config, strategy="naive")) \
        or opts["hbm_cap"]
    if opts["hbm_cap"]:
        assert any(b.m_padded for b in got)


def test_annotate_predictions_with_a_calibrated_table_match_jax():
    """``annotate_predictions`` counts ``m_padded`` into the stacked shape and
    gives each signature's compile to its first bucket, under factors."""
    fields = dict(run_factors={"fleet_fit": 0.3, "fleet_windowed_fit": 2.0}, compile_factors={"fleet_fit": 4.0})
    config, jax_config = FitConfig(epochs=3, batch_size=64), JaxFitConfig(epochs=3, batch_size=64)
    buckets = packing._packed_buckets(_members("port", 3), config, planner.CostModel(planner.CostTable(**fields)),
                                      budget=0, hbm_cap=1 << 20)
    jax_buckets = jax_packing._packed_buckets(_members("jax", 3), jax_config,
                                              jax_planner.CostModel(jax_planner.CostTable(**fields)), budget=0,
                                              hbm_cap=1 << 20)
    packing.annotate_predictions(buckets, config, planner.CostModel(planner.CostTable(**fields)))
    jax_packing.annotate_predictions(jax_buckets, jax_config, jax_planner.CostModel(jax_planner.CostTable(**fields)))
    assert _shape(buckets) == _shape(jax_buckets)
    assert sum(b.predicted["compiles"] for b in buckets) < len(buckets)  # siblings share a signature


def test_strategy_and_perfmodel_knobs(monkeypatch, caplog):
    monkeypatch.setenv("GORDO_TPU_PLAN_STRATEGY", "PACKED")
    assert planner.default_strategy() == jax_planner.default_strategy() == "packed"
    monkeypatch.setenv("GORDO_TPU_PLAN_STRATEGY", "best")
    assert planner.default_strategy() == jax_planner.default_strategy() == "naive"
    assert "Invalid GORDO_TPU_PLAN_STRATEGY" in caplog.text
    monkeypatch.setenv("GORDO_TPU_PLAN_HBM_CAP_BYTES", "10")
    assert packing.hbm_cap_bytes() == jax_packing.hbm_cap_bytes() == 1 << 20
    with pytest.raises(ValueError, match="unknown plan strategy"):
        planner.plan_train_buckets(_members("port", 0, 2), FitConfig(), strategy="best")
    # GORDO_TPU_PERFMODEL: on, the packer costs through the table's learned section bucket for bucket as JAX's,
    # and the plan records it; off, the section is inert
    learned = {"version": 1, "features": list(jax_planner.LEARNED_FEATURES), "targets": {
        "device_ms": {"fleet_fit": {"coef": [-9.0, 0.5, 0.9, 0.8, 0.7, -0.3, -0.2], "lo": [0.0] * 6,
                                    "hi": [12.0] * 6}},
        "compile_ms": {"fleet_fit": {"coef": [6.0, 0.1, 0.0, 0.0, 0.0, 0.0, 0.0], "lo": [0.0] * 6,
                                     "hi": [12.0] * 6}}}}
    config, jax_config = FitConfig(epochs=5, batch_size=32), JaxFitConfig(epochs=5, batch_size=32)
    predictions = []
    for knob in ("0", "1"):
        monkeypatch.setenv("GORDO_TPU_PERFMODEL", knob)
        table, jax_table = planner.CostTable(learned=learned), jax_planner.CostTable(learned=learned)
        got = planner.plan_train_buckets(_members("port", 0, 12), config, strategy="packed",
                                         cost_model=planner.CostModel(table), budget=2)
        want = jax_planner.plan_train_buckets(_members("jax", 0, 12), jax_config, strategy="packed",
                                              cost_model=jax_planner.CostModel(jax_table), budget=2)
        assert _shape(got) == _shape(want)
        doc = planner.build_plan_doc([(config, got)], "packed", "fingerprint", cost_table=table).doc
        jax_doc = jax_planner.build_plan_doc([(jax_config, want)], "packed", (1, 1), jax_table, "fingerprint").doc
        assert doc["cost_table"]["learned"] is jax_doc["cost_table"]["learned"] is (knob == "1")
        predictions.append([b.predicted for b in got])
    assert predictions[0] != predictions[1]


# -- the plan command ------------------------------------------------------------------------------------------

PROJECT = "plan-test"


def _machine(name, days, tags, encoding_layers=1):
    model = {"gordo_tpu.models.anomaly.diff.DiffBasedAnomalyDetector": {"base_estimator": {
        "sklearn.pipeline.Pipeline": {"steps": ["sklearn.preprocessing.MinMaxScaler", {
            "gordo_tpu.models.JaxAutoEncoder": {"kind": "feedforward_hourglass", "encoding_layers": encoding_layers,
                                                "epochs": 2}}]}}}}
    return {"name": name, "project_name": PROJECT, "model": model, "dataset": {
        "train_start_date": "2020-01-01T00:00:00+00:00", "train_end_date": f"2020-01-{1 + days:02d}T00:00:00+00:00",
        "tag_list": tags, "data_provider": {"type": "RandomDataProvider"}}}


#: rows 145 to 865 (10-minute rows over 1 to 6 days), two specs
SHARD = {"machines": [_machine(f"p-{i}", days, ["a", "b", "c"]) for i, days in enumerate((1, 2, 2, 3, 5, 6))]
         + [_machine(f"q-{i}", days, ["a", "b"], 2) for i, days in enumerate((1, 4))]}


@pytest.fixture
def shard(tmp_path, monkeypatch):
    monkeypatch.setattr(jax_fleet, "make_mesh", lambda *a, **k: jax_make_mesh(jax.devices()[:1]))
    path = tmp_path / "shard.json"
    path.write_text(json.dumps(SHARD))
    return str(path)


def _port_plan(capsys, *args):
    code = main(["plan", *args, "--device", "cpu"])
    out = capsys.readouterr()
    return code, out.out, out.err


@pytest.mark.parametrize("knobs", [{}, {"GORDO_TPU_PLAN_COMPILE_BUDGET": "1", "GORDO_TPU_PLAN_HBM_CAP_BYTES": "1"}])
def test_plan_command_matches_jax(shard, tmp_path, capsys, monkeypatch, knobs):
    """``plan --strategy packed --as-json`` gives JAX's bytes, ``-o`` writes
    them, and the text table equals JAX's; with a compile budget of one
    program the two specs' rungs merge to one rung each."""
    for name, value in knobs.items():
        monkeypatch.setenv(name, value)
    jax_json = CliRunner().invoke(gordo_tpu_cli, ["plan", shard, "--strategy", "packed", "--as-json"])
    assert jax_json.exit_code == 0, jax_json.output
    code, out, _ = _port_plan(capsys, shard, "--strategy", "packed", "--as-json", "-o", str(tmp_path / "plan.json"))
    assert code == 0 and out == jax_json.stdout
    assert (tmp_path / "plan.json").read_text() == out
    doc = json.loads(out)
    assert doc["strategy"] == "packed" and doc["totals"]["members"] == 8
    assert doc["totals"]["buckets"] == (2 if knobs else len({(b["spec"]["dims"][0], b["n_padded"])
                                                             for b in doc["buckets"]}))
    jax_text = CliRunner().invoke(gordo_tpu_cli, ["plan", shard, "--strategy", "packed"])
    code, text, _ = _port_plan(capsys, shard, "--strategy", "packed")
    assert code == 0 and text == jax_text.stdout
    assert planner.render_plan(planner.FleetPlan(doc)) + "\n" == text


def test_plan_calibrates_and_refuses_unusable_inputs(shard, tmp_path, capsys):
    """``--calibrate-from`` saves the table beside the trace and plans with
    it as JAX does; an unusable table or plan fails with JAX's text."""
    trace = tmp_path / "trace" / "build_trace.jsonl"
    trace.parent.mkdir()
    trace.write_text("\n".join(json.dumps({"name": "device_program", "duration_ms": ms, "attributes": {
        "program": "fleet_fit", "flops_per_sample": 120.0, "stacked_members": 6, "stacked_samples": 896,
        "epochs": 2, "compile": compile_}}) for ms, compile_ in ((900.0, True), (40.0, False), (60.0, False))))
    jax_out = tmp_path / "jax-table.json"
    want = CliRunner().invoke(gordo_tpu_cli, ["plan", shard, "--strategy", "packed", "--as-json", "--calibrate-from",
                                              str(trace), "--cost-table-out", str(jax_out)])
    code, out, _ = _port_plan(capsys, shard, "--strategy", "packed", "--as-json", "--calibrate-from", str(trace))
    assert code == 0 and out == want.stdout
    saved = trace.parent / planner.COST_TABLE_FILE
    assert saved.read_text() == jax_out.read_text()
    assert json.loads(out)["cost_table"] == {"version": 1, "calibrated": True, "samples": {"fleet_fit": 3},
                                             "learned": False}
    code, with_table, _ = _port_plan(capsys, shard, "--strategy", "packed", "--as-json", "--cost-table", str(saved))
    assert code == 0 and with_table == out

    bad_table = tmp_path / "bad-table.json"
    bad_table.write_text(json.dumps({"version": 0}))
    jax_error = CliRunner().invoke(gordo_tpu_cli, ["plan", shard, "--cost-table", str(bad_table)])
    code, _, err = _port_plan(capsys, shard, "--cost-table", str(bad_table))
    assert (code, err) == (jax_error.exit_code, jax_error.output) == (1, "Error: --cost-table: cost table version 0 "
                                                                         "!= supported 1; re-run calibration\n")
    bad_plan = tmp_path / "bad-plan.json"
    bad_plan.write_text(json.dumps({"version": 7, "buckets": []}))
    jax_run = CliRunner().invoke(gordo_tpu_cli, ["build-fleet", shard, str(tmp_path / "jax"), "--plan-from",
                                                 str(bad_plan)])
    code = main(["build-fleet", shard, str(tmp_path / "port"), "--device", "cpu", "--plan-from", str(bad_plan)])
    err = capsys.readouterr().err
    text = "--plan-from: fleet plan version 7 != supported 1; re-run `gordo-tpu plan`"
    assert code == jax_run.exit_code == 1
    assert text in err and text in "".join(__import__("traceback").format_exception(*jax_run.exc_info))
    (tmp_path / "torn-plan.json").write_text('{"version": 1, "buck')
    code = main(["build-fleet", shard, str(tmp_path / "port"), "--device", "cpu", "--plan-from",
                 str(tmp_path / "torn-plan.json")])
    assert code == 1 and "--plan-from: unreadable fleet plan" in capsys.readouterr().err


def test_plan_exits_when_a_machine_cannot_be_planned(tmp_path, capsys):
    broken = dict(_machine("p-bad", 1, ["a"]), dataset={**_machine("p-bad", 1, ["a"])["dataset"],
                                                        "n_samples_threshold": 10**6})
    path = tmp_path / "shard.json"
    path.write_text(json.dumps({"machines": [_machine("p-0", 1, ["a", "b"]), broken]}))
    jax_run = CliRunner().invoke(gordo_tpu_cli, ["plan", str(path)])
    code, out, err = _port_plan(capsys, str(path))
    assert code == jax_run.exit_code == 1 and out == ""
    assert err.startswith("Error: 1 machine(s) could not be planned (first: p-bad: InsufficientDataError(")
    assert jax_run.output.startswith("Error: 1 machine(s) could not be planned (first: p-bad: InsufficientDataError(")
