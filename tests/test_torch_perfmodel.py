"""The port's learned performance model (``gordo_tpu_torch/perfmodel/`` and its
consumers) against the JAX package's (``gordo_tpu/perfmodel/``), on the CPU.

Both packages read the same corpora, written with ``tests/perfmodel``'s
span builders (a grid of serve and compile spans following a known
log-linear law, with and without a memory peak on each span), and every
comparison is exact (``==``): harvested rows, fingerprints, holdout
splits, ridge coefficients, fitted sections, promotion reports and the
tables they write, status documents, predictions through tables each
package wrote for the other, the engine's caps, demotions, warmup order
and precision nomination, the stream scorer's flush prediction, the
packed plan's JSON with the knob off, and the ``perfmodel`` commands'
documents, lines and exit codes.
"""

import json
import math
import os
import shutil
from types import SimpleNamespace

import pytest
import torch
from click.testing import CliRunner

from gordo_tpu import perfmodel as jax_perfmodel
from gordo_tpu import planner as jax_planner
from gordo_tpu.cli.cli import gordo_tpu_cli
from gordo_tpu.models.spec import FeedForwardSpec as JaxFeedForwardSpec
from gordo_tpu.perfmodel import model as jax_model
from gordo_tpu.serve import ServeConfig as JaxServeConfig
from gordo_tpu.serve import ServeEngine as JaxServeEngine
from gordo_tpu.serve import precision as jax_precision
from gordo_tpu.stream.scorer import WindowScorer as JaxWindowScorer
from gordo_tpu_torch import perfmodel, planner
from gordo_tpu_torch.cli.cli import main
from gordo_tpu_torch.models.spec import FeedForwardSpec
from gordo_tpu_torch.perfmodel import model
from gordo_tpu_torch.serve import precision
from gordo_tpu_torch.serve.engine import ServeConfig, ServeEngine
from gordo_tpu_torch.stream.scorer import WindowScorer

from tests.perfmodel.conftest import grid_spans, serve_span, true_device_ms, write_corpus

#: (n_features, dims): the corpus's own spec (in the learned domain) and a
#: 20-tag hourglass outside it (answered analytic)
SPEC_ARGS = ((3, (6, 3)), (20, (15, 10, 15)), (4, (2,)))


def specs(package):
    kind = FeedForwardSpec if package == "port" else JaxFeedForwardSpec
    return [kind(n, n, dims, ("tanh",) * len(dims)) for n, dims in SPEC_ARGS]


def hbm_spans(jitter=0.02):
    """The grid with a measured memory peak on every serve span (the
    ``hbm_bytes`` target), three run spans of a training program (a
    population under most floors), and two spans that give no row (no
    features; a zero target)."""
    spans = []
    for span in grid_spans(jitter):
        span = json.loads(json.dumps(span))
        attrs = span["attributes"]
        if span["name"] == "serve_batch":
            attrs["hbm_bytes"] = 4000.0 * attrs["padded_members"] * attrs["padded_rows"] + 9000.0
        spans.append(span)
    for i, (m, r) in enumerate(((8, 512), (16, 1024), (32, 2048))):
        spans.append({"name": "device_program", "context": {"trace_id": "t", "span_id": f"r-{i}"},
                      "attributes": {"program": "fleet_fit", "flops_per_sample": 100.0, "stacked_members": m,
                                     "stacked_samples": r, "epochs": 5, "device_ms": 3.0 * m}})
    spans.append({"name": "serve_batch", "attributes": {"padded_members": 4, "padded_rows": 8, "device_ms": 1.0}})
    spans.append({"name": "serve_batch", "attributes": {**serve_span(0, 4, 8)["attributes"], "device_ms": 0.0}})
    return spans


def write_sinks(directory, spans):
    """``spans`` over a rotated generation, the live file and a worker's
    ``-<pid>`` sink (the worker repeating a span the merge drops)."""
    write_corpus(directory, spans[: len(spans) // 2])
    os.replace(os.path.join(directory, "serve_trace.jsonl"), os.path.join(directory, "serve_trace.jsonl.1"))
    write_corpus(directory, spans[len(spans) // 2:])
    with open(os.path.join(directory, "serve_trace-4242.jsonl"), "w") as f:
        f.write(json.dumps(spans[0]) + "\n" + "{torn\n")


def test_harvest_and_fit_match_jax(tmp_path, monkeypatch):
    corpus = str(tmp_path / "corpus")
    write_sinks(corpus, hbm_spans())
    rows, stats = perfmodel.harvest_corpus(corpus)
    jax_rows, jax_stats = jax_perfmodel.harvest_corpus(corpus)
    assert rows == jax_rows and stats == jax_stats
    assert stats["rows_by_model"] == {"compile_ms/fleet_forward": 36, "device_ms/fleet_fit": 3,
                                      "device_ms/fleet_forward": 72, "hbm_bytes/fleet_forward": 72}
    assert stats["traces"] == [{"base": "serve_trace.jsonl", "sinks": 2}]
    assert perfmodel.rows_from_spans(hbm_spans()) == jax_perfmodel.rows_from_spans(hbm_spans())
    assert perfmodel.harvest_trace(os.path.join(corpus, "serve_trace.jsonl")) == \
        jax_perfmodel.harvest_trace(os.path.join(corpus, "serve_trace.jsonl"))
    assert perfmodel.corpus_fingerprint(rows) == jax_perfmodel.corpus_fingerprint(jax_rows) == \
        perfmodel.corpus_fingerprint(reversed(rows))
    populations = {}
    for row in rows:
        populations.setdefault((row.target, row.program), []).append(row)
    for population in populations.values():
        split = perfmodel.holdout_split(population)
        assert split == jax_perfmodel.holdout_split(population) and split[1]
        xs, ys = [r.features for r in split[0]], [math.log(r.y) for r in split[0]]
        for l2 in (1e-3, 1.0):
            assert perfmodel.fit_ridge(xs, ys, l2) == jax_perfmodel.fit_ridge(xs, ys, l2)
        assert model.min_samples_floor(None) == jax_model.min_samples_floor(None) == 32
    for floor in (None, 2, 8, 40, 100):
        assert perfmodel.fit_section(rows, min_samples=floor) == jax_perfmodel.fit_section(rows, min_samples=floor)
    monkeypatch.setenv("GORDO_TPU_PERFMODEL_MIN_SAMPLES", "4")
    assert perfmodel.fit_section(rows) == jax_perfmodel.fit_section(rows)
    assert perfmodel.fit_section(rows)["skipped"] == {"device_ms/fleet_fit": 3}
    for row in rows[:40]:
        for target in ("device_ms", "compile_ms", "hbm_bytes"):
            table = planner.CostTable(run_factors={"fleet_forward": 0.5})
            jax_table = jax_planner.CostTable(run_factors={"fleet_forward": 0.5})
            assert perfmodel.analytic_prediction(table, target, row.program, row.features) == \
                jax_perfmodel.analytic_prediction(jax_table, target, row.program, row.features)
    with pytest.raises(ValueError, match="singular"):
        perfmodel.fit_ridge([[1.0], [1.0]], [0.0, 1.0], l2=0.0)


def exact_corpus(directory):
    """Serve spans whose device ms is the analytic model's own prediction:
    a fit cannot beat it (the gate's losing side)."""
    spans = []
    for i, (m, r) in enumerate((m, r) for m in (1, 2, 4, 8, 16) for r in (16, 64, 256, 1024) for _ in range(2)):
        spans.append(serve_span(i, m, r, device_ms=(100.0 * m * r / 2.0e9 + 0.01) * 1000.0))
    write_corpus(directory, spans)


def shifted(directory):
    """Serve spans only, three times the grid's law: an incumbent fitted
    on the grid loses to a refit, and its compile model is carried."""
    spans = [s for s in grid_spans(0.02) if s["name"] == "serve_batch"]
    for span in spans:
        span["attributes"]["device_ms"] *= 3.0
    write_corpus(directory, spans)


#: each case: (corpus writer, the incumbent's corpus writer or None, fit_and_promote's keywords)
PROMOTE_CASES = {
    "promoted": (lambda d: write_corpus(d, hbm_spans()), None, dict(min_samples=8)),
    "loses to analytic": (exact_corpus, None, dict(min_samples=8)),
    "forced": (exact_corpus, None, dict(min_samples=8, force=True)),
    "against an incumbent, carried forward": (shifted, lambda d: write_corpus(d, grid_spans(0.02)),
                                              dict(min_samples=8)),
    "under the floor": (lambda d: write_corpus(d, grid_spans()), None, dict(min_samples=100)),
    "empty": (lambda d: os.makedirs(d), None, {}),
    "unchanged": (lambda d: write_corpus(d, grid_spans(0.02)), lambda d: write_corpus(d, grid_spans(0.02)),
                  dict(min_samples=8)),
}


def _masked(report, root):
    return json.loads(json.dumps(report).replace(root, "<root>"))


@pytest.mark.parametrize("case", list(PROMOTE_CASES))
def test_fit_and_promote_matches_jax(tmp_path, case):
    write, incumbent, kwargs = PROMOTE_CASES[case]
    reports, tables, statuses = {}, {}, {}
    for package, module in (("port", perfmodel), ("jax", jax_perfmodel)):
        root = str(tmp_path / package)
        corpus, table = os.path.join(root, "corpus"), os.path.join(root, "cost_table.json")
        write(corpus)
        if incumbent is not None:
            first = corpus if case == "unchanged" else os.path.join(root, "first")
            if first != corpus:
                incumbent(first)
            assert module.fit_and_promote(first, table_path=table, min_samples=8)["promoted"]
        reports[package] = _masked(module.fit_and_promote(corpus, table_path=table, **kwargs), root)
        tables[package] = open(table).read().replace(root, "<root>") if os.path.exists(table) else None
        statuses[package] = _masked(module.section_status(table), root)
    assert reports["port"] == reports["jax"] and tables["port"] == tables["jax"]
    assert statuses["port"] == statuses["jax"]
    report = reports["port"]
    expected = {"promoted": "promoted", "loses to analytic": "no candidate beat the incumbent rulers",
                "forced": "promoted", "against an incumbent, carried forward": "promoted",
                "under the floor": "no (target, program) population clears the sample floor",
                "empty": "empty corpus; analytic fallback stays pinned",
                "unchanged": "corpus unchanged since incumbent fit"}[case]
    assert report["reason"] == expected
    if case == "forced":
        assert [m["reason"] for m in report["models"]] == ["forced"]
    if case == "against an incumbent, carried forward":
        assert report["models"][0]["incumbent_mae_log"] > report["models"][0]["holdout_mae_log"]
        assert sorted(json.loads(tables["port"])["learned"]["targets"]) == ["compile_ms", "device_ms"]


def test_tables_cross_between_packages(tmp_path, monkeypatch):
    """Each package loads the table the other wrote and predicts the same,
    in and out of the domain box, through every estimate."""
    corpus = str(tmp_path / "corpus")
    write_corpus(corpus, hbm_spans())
    written = {}
    for package, module in (("port", perfmodel), ("jax", jax_perfmodel)):
        written[package] = str(tmp_path / f"{package}.json")
        assert module.fit_and_promote(corpus, table_path=written[package], min_samples=8)["promoted"]
    assert open(written["port"]).read() == open(written["jax"]).read()
    port_table, jax_table = planner.CostTable.load(written["jax"]), jax_planner.CostTable.load(written["port"])
    assert port_table.to_dict() == jax_table.to_dict() and port_table.has_learned is jax_table.has_learned is True
    entry = port_table.learned_entry("device_ms", "fleet_forward")
    assert entry == jax_table.learned_entry("device_ms", "fleet_forward") and entry["lo"][1] == 0.0
    slack = planner.costmodel.LEARNED_DOMAIN_SLACK
    for x in (entry["lo"][2] - slack, entry["lo"][2] - slack - 1e-9, entry["hi"][2] + slack,
              entry["hi"][2] + slack + 1e-9, 3.0):
        features = [entry["lo"][0], 1.0, x, 0.0, 1.0, 0.0]
        for target, program in (("device_ms", "fleet_forward"), ("hbm_bytes", "fleet_forward"),
                                ("compile_ms", "fleet_forward"), ("device_ms", "fleet_fit")):
            got = port_table.learned_predict(target, program, features)
            assert got == jax_table.learned_predict(target, program, features)
            if (target, program) == ("device_ms", "fleet_forward"):
                assert (got is None) == (x < entry["lo"][2] - slack or x > entry["hi"][2] + slack)
    for knob in ("0", "1"):
        monkeypatch.setenv("GORDO_TPU_PERFMODEL", knob)
        ours, theirs = planner.CostModel(port_table), jax_planner.CostModel(jax_table)
        assert ours.use_learned is theirs.use_learned is (knob == "1")
        for spec, jax_spec in zip(specs("port"), specs("jax")):
            for members, rows in ((1, 16), (8, 128), (16, 32), (64, 4096)):
                for prec in ("f32", "bf16", "int8"):
                    assert ours.predict_serve_step_s(spec, members, rows, prec) == \
                        theirs.predict_serve_step_s(jax_spec, members, rows, prec)
                    assert ours.predict_serve_hbm_bytes(spec, members, rows, prec) == \
                        theirs.predict_serve_hbm_bytes(jax_spec, members, rows, prec)
                    assert ours.serve_weight_bytes(spec, members, prec) == \
                        theirs.serve_weight_bytes(jax_spec, members, prec)
                assert ours.predict_run_s("fleet_forward", spec, members, rows, 2) == \
                    theirs.predict_run_s("fleet_forward", jax_spec, members, rows, 2)
                assert ours.predict_hbm_bytes(spec, members, rows, 32) == \
                    theirs.predict_hbm_bytes(jax_spec, members, rows, 32)
            assert ours.predict_compile_s("fleet_forward", spec) == theirs.predict_compile_s("fleet_forward", jax_spec)
    learned = planner.CostModel(port_table, use_learned=True).predict_serve_step_s(specs("port")[0], 8, 128)
    assert learned * 1000.0 == pytest.approx(true_device_ms(8, 128), rel=0.1)
    shutil.copy(written["port"], str(tmp_path / "torn.json"))
    with open(str(tmp_path / "torn.json"), "a") as f:
        f.write("{")
    assert planner.load_table_safe(str(tmp_path / "torn.json")).to_dict() == planner.CostTable().to_dict()


class Fleet:
    """A fleet that records the order warmup asks for its buckets in, and
    has none (so nothing runs)."""

    def __init__(self, specs_):
        self.specs, self.asked, self.device = specs_, [], torch.device("cpu")

    def loaded_specs(self):
        return {f"m{i}": spec for i, spec in enumerate(self.specs)}

    def _ask(self, spec, prec="f32"):
        self.asked.append((spec.n_features, prec))
        raise KeyError(spec)

    spec_bucket = serving_bucket = _ask


def test_engine_consumers_match_jax(tmp_path, monkeypatch):
    corpus = str(tmp_path / "corpus")
    write_corpus(corpus, hbm_spans())
    table = str(tmp_path / "cost_table.json")
    assert perfmodel.fit_and_promote(corpus, table_path=table, min_samples=8)["promoted"]
    monkeypatch.setenv("GORDO_TPU_PERFMODEL_TABLE", table)
    monkeypatch.setenv("GORDO_TPU_PERFMODEL", "1")
    ladders = dict(max_size=8, row_ladder=(8, 32, 128), warmup_max_rows=128)
    engine, jax_engine = ServeEngine(None, ServeConfig(**ladders)), JaxServeEngine(JaxServeConfig(**ladders))
    try:
        assert engine.member_ladder == jax_engine.member_ladder
        assert engine._cost_model().table.to_dict() == jax_engine._cost_model().table.to_dict()
        for spec, jax_spec in zip(specs("port"), specs("jax")):
            for prec in ("f32", "bf16", "int8"):
                for members, rows in ((1, 8), (8, 32), (3, 128)):
                    assert engine._predicted_step_ms(spec, members, rows, prec) == \
                        jax_engine._predicted_step_ms(jax_spec, members, rows, prec)
                model = engine._cost_model()
                top = [model.predict_serve_hbm_bytes(spec, 8, rung, prec) for rung in ladders["row_ladder"]]
                for budget in (0, top[0] - 1, top[0], (top[0] + top[1]) // 2, top[2], 10 * top[2]):
                    monkeypatch.setenv("GORDO_TPU_PERFMODEL_BATCH_CAP_BYTES", str(budget))
                    engine._model_row_caps.clear()
                    jax_engine._model_row_caps.clear()
                    assert engine._model_row_cap(spec, prec) == jax_engine._model_row_cap(jax_spec, prec)
                for breaker in ("0", "1"):
                    monkeypatch.setenv("GORDO_TPU_PERFMODEL_BREAKER", breaker)
                    for safety in ("0.8", "0.3", "0.05"):
                        monkeypatch.setenv("GORDO_TPU_PERFMODEL_BREAKER_SAFETY", safety)
                        for args in ((8, 128, "members"), (8, 32, "members"), (1, 128, "rows"), (1, 8, "rows")):
                            assert engine._hbm_aware_cap(spec, prec, *args) == \
                                jax_engine._hbm_aware_cap(jax_spec, prec, *args)
                        # a demotion on both engines: the same caps and the same model_informed
                        exc = RuntimeError("RESOURCE_EXHAUSTED: out of memory")
                        for members, rows in ((8, 128), (1, 128)):
                            engine._note_resource_exhausted(Fleet([]), spec, prec, members, rows, exc)
                            jax_engine._note_resource_exhausted(jax_spec, prec, members, rows, exc)
                            key, jax_key = (spec, prec), (jax_spec, prec)
                            assert engine._member_caps.get(key) == jax_engine._member_caps.get(jax_key)
                            assert engine._row_caps.get(key) == jax_engine._row_caps.get(jax_key)
                        for caps in (engine._member_caps, engine._row_caps, jax_engine._member_caps,
                                     jax_engine._row_caps):
                            caps.clear()
            for knob in ("0", "1"):
                monkeypatch.setenv("GORDO_TPU_PERFMODEL_PRECISION", knob)
                for rows in (8, 128, 1 << 20):
                    assert precision.model_preferred(spec, 8, rows, engine._cost_model()) == \
                        jax_precision.model_preferred(jax_spec, 8, rows, jax_engine._cost_model())
        monkeypatch.setenv("GORDO_TPU_PRECISION_GATE", "0")  # a nominated rung serves ungated
        nominated = set()
        for warmup in ("0", "1"):
            monkeypatch.setenv("GORDO_TPU_PERFMODEL_WARMUP", warmup)
            for knob in ("0", "1"):
                monkeypatch.setenv("GORDO_TPU_PERFMODEL_PRECISION", knob)
                fleet, jax_fleet = Fleet(specs("port")), Fleet(specs("jax"))
                engine.warmup_fleet(fleet)
                jax_engine.warmup_fleet(jax_fleet)
                assert fleet.asked == jax_fleet.asked
                order = [spec.n_features for spec in engine.warmup_order(fleet.specs, 128)]
                assert order == [n for n, _ in fleet.asked]
                assert (order == [20, 3, 4]) is (warmup == "0")  # repr order, else the costliest first
                nominated |= {prec for _, prec in fleet.asked}
        assert nominated == {"f32", "bf16"}
    finally:
        engine.shutdown()
        jax_engine.shutdown()


def test_stream_flush_prediction_matches_jax(tmp_path, monkeypatch):
    corpus = str(tmp_path / "corpus")
    write_corpus(corpus, hbm_spans())
    table = str(tmp_path / "cost_table.json")
    assert jax_perfmodel.fit_and_promote(corpus, table_path=table, min_samples=8)["promoted"]
    port_specs, jax_specs = specs("port"), specs("jax")
    inputs = {"a": [0] * 16, "b": [0] * 40, "c": [0] * 16, "d": [0] * 7, "e": [0] * 3}
    for knob, path in (("0", None), ("1", table), ("1", str(tmp_path / "missing.json")), ("0", table)):
        monkeypatch.setenv("GORDO_TPU_PERFMODEL", knob)
        if path:
            monkeypatch.setenv("GORDO_TPU_PERFMODEL_TABLE", path)
        else:
            monkeypatch.delenv("GORDO_TPU_PERFMODEL_TABLE", raising=False)
        scorer, jax_scorer = WindowScorer(8, None, None, None), JaxWindowScorer(8)
        for chosen in ((0, 0, 1, 2, "stream"), (0, 0, 0, 0, 0), ("stream",) * 5):
            ours = {n: (s if s == "stream" else port_specs[s]) for n, s in zip(inputs, chosen)}
            theirs = {n: (s if s == "stream" else jax_specs[s]) for n, s in zip(inputs, chosen)}
            assert scorer._predicted_flush_ms(ours, inputs) == jax_scorer._predicted_flush_ms(theirs, inputs)


def test_knob_off_packed_plan_is_byte_identical(monkeypatch):
    """With ``GORDO_TPU_PERFMODEL`` off, a table with a learned section
    plans byte for byte as one without it, and as JAX's; on, the plan
    names the learned ruler as JAX's does."""
    entry = {"coef": [5.0, 0.1, 1.5, 1.2, 1.0, 0.0, 0.0], "lo": [0.0] * 6, "hi": [30.0] * 6, "n": 64,
             "holdout_mae_log": 0.05}
    section = {"version": 1, "features": list(planner.LEARNED_FEATURES), "targets": {
        "device_ms": {"fleet_fit": dict(entry), "fleet_forward": dict(entry)},
        "compile_ms": {"fleet_fit": dict(entry)}, "hbm_bytes": {"fleet_fit": dict(entry)}}}
    config = SimpleNamespace(epochs=2, batch_size=16, validation_split=0.1, shuffle=False, early_stopping=None)

    def plan(package, learned):
        lib, spec = (planner, specs("port")[0]) if package == "port" else (jax_planner, specs("jax")[0])
        members = []
        for name, n in (("a", 50), ("b", 120), ("c", 700), ("d", 90)):
            x = object()
            members.append(SimpleNamespace(name=name, spec=spec, n=n, X=x, y=x))
        table = lib.CostTable(learned=json.loads(json.dumps(learned)) if learned else None)
        cost_model = lib.CostModel(table)
        buckets = lib.plan_train_buckets(members, config, strategy="packed", cost_model=cost_model)
        fingerprint = lib.config_fingerprint(["k1", "k2", "k3"])
        if package == "port":
            return lib.build_plan_doc([(config, buckets)], "packed", fingerprint, cost_table=table).to_json()
        return lib.build_plan_doc([(config, buckets)], "packed", (1, 1), table, fingerprint).to_json()

    for knob in ("0", "1"):
        monkeypatch.setenv("GORDO_TPU_PERFMODEL", knob)
        texts = {(package, bool(learned)): plan(package, learned) for package in ("port", "jax")
                 for learned in (None, section)}
        assert texts[("port", True)] == texts[("jax", True)] and texts[("port", False)] == texts[("jax", False)]
        assert (texts[("port", True)] == texts[("port", False)]) is (knob == "0")
        assert json.loads(texts[("port", True)])["cost_table"]["learned"] is (knob == "1")


def _port_cli(argv, capsys):
    try:
        code = main(argv)
    except SystemExit as exc:
        code = exc.code
    out = capsys.readouterr()
    return code, out.out


@pytest.mark.parametrize("command", ["fit", "status", "eval", "empty corpus", "missing paths"])
def test_perfmodel_commands_match_jax(tmp_path, capsys, monkeypatch, command):
    """Each command's document (``--as-json``), its text lines and its exit
    code, against the JAX command's on the same corpus and table."""
    monkeypatch.delenv("GORDO_TPU_PERFMODEL_TABLE", raising=False)
    runner = CliRunner()
    results = {}
    for package in ("port", "jax"):
        root = str(tmp_path / package)
        corpus, table = os.path.join(root, "corpus"), os.path.join(root, "cost_table.json")
        if command == "empty corpus":
            os.makedirs(corpus)
        else:
            write_corpus(corpus, hbm_spans())
        if command in ("status", "eval"):
            assert perfmodel.fit_and_promote(corpus, table_path=table, min_samples=8)["promoted"]
        argv = {"fit": [["fit", corpus, "--table", table, "--min-samples", "8", "--as-json"],
                        ["fit", corpus, "--table", table, "--min-samples", "8", "--force"],
                        ["fit", corpus, "--table", table, "--min-samples", "8"]],
                "status": [["status", "--table", table, "--as-json"], ["status", "--table", table],
                           ["status", "--table", os.path.join(root, "none.json")]],
                "eval": [["eval", corpus, "--table", table, "--as-json"], ["eval", corpus, "--table", table],
                         ["eval", corpus, "--as-json"]],
                "empty corpus": [["fit", corpus, "--as-json"], ["fit", corpus], ["eval", corpus]],
                "missing paths": [["fit", os.path.join(root, "nowhere")], ["eval", corpus, "--table",
                                  os.path.join(root, "none.json")], ["fit", corpus, "--table", root]]}[command]
        outputs = []
        for args in argv:
            if package == "port":
                code, out = _port_cli(["perfmodel", *args], capsys)
            else:
                result = runner.invoke(gordo_tpu_cli, ["perfmodel", *args])
                code, out = result.exit_code, result.output
            outputs.append((code, out.replace(root, "<root>") if code == 0 else None))
        results[package] = outputs
    assert results["port"] == results["jax"]
    codes = [code for code, _ in results["port"]]
    assert codes == ([2, 2, 2] if command == "missing paths" else [0, 0, 0])
    if command == "fit":
        assert json.loads(results["port"][0][1])["promoted"] is True
        assert "corpus unchanged" in results["port"][2][1]
    if command == "empty corpus":
        assert "the analytic model remains the active fallback" in results["port"][1][1]


def test_engine_consumers_under_threads(tmp_path, monkeypatch):
    """The engine's cost model is built once and its caches answer alike
    when many request threads ask at once (a short switch interval makes
    lost updates likely)."""
    import sys
    import threading

    corpus = str(tmp_path / "corpus")
    write_corpus(corpus, hbm_spans())
    table = str(tmp_path / "cost_table.json")
    assert perfmodel.fit_and_promote(corpus, table_path=table, min_samples=8)["promoted"]
    monkeypatch.setenv("GORDO_TPU_PERFMODEL_TABLE", table)
    monkeypatch.setenv("GORDO_TPU_PERFMODEL", "1")
    monkeypatch.setenv("GORDO_TPU_PERFMODEL_BATCH_CAP_BYTES", "600000")
    engine = ServeEngine(None, ServeConfig(max_size=8, row_ladder=(8, 32, 128)))
    spec = specs("port")[0]
    seen, threads = [], 4 * (os.cpu_count() or 2)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for rows in (8, 32, 128) * 20:
                seen.append((id(engine._cost_model()), engine._model_row_cap(spec, "f32"),
                             engine._predicted_step_ms(spec, 8, rows, "f32") > 0.0))

        workers = [threading.Thread(target=work) for _ in range(threads)]
        for worker in workers:
            worker.start()
        for worker in workers:
            worker.join(timeout=60)
        assert not any(worker.is_alive() for worker in workers)
    finally:
        sys.setswitchinterval(interval)
        engine.shutdown()
    assert len(seen) == threads * 60 and len(set(seen)) == 1
    assert set(engine._model_row_caps) == {(spec, "f32")} and len(engine._step_predictions) == 3
