"""The port's ``bench-check`` (``gordo_tpu_torch/telemetry/benchgate.py``
and the command) against the JAX package's, on the CPU: for every
committed ``BENCH_*.json``, the comparison and its report of the document
against itself, against a candidate that regresses each gated number in
turn, at a looser ``--tolerance``; then the command's baseline lookup, its
output and its exit codes, each held to the JAX command's."""

import copy
import glob
import json
import os
import shutil

import pytest
from click.testing import CliRunner

from gordo_tpu.cli.cli import gordo_tpu_cli
from gordo_tpu.telemetry import benchgate as jax_benchgate
from gordo_tpu_torch.cli import cli
from gordo_tpu_torch.telemetry import benchgate

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCHES = sorted(os.path.basename(p) for p in glob.glob(os.path.join(REPO, "BENCH_*.json")))


def load(name):
    with open(os.path.join(REPO, name)) as f:
        return json.load(f)


def set_path(doc, path, value):
    node = doc
    parts = path.split(".")
    for part in parts[:-1]:
        node = node.setdefault(part, {})
    node[parts[-1]] = value


def regressed(doc, spec):
    """``doc`` with the gated number of ``spec`` made to fail its gate."""
    value = benchgate.get_path(doc, spec.path)
    if spec.kind == "truthy":
        bad = False
    elif spec.kind in ("max_bound", "min_bound"):
        bad = spec.bound * 10 + 1 if spec.kind == "max_bound" else spec.bound / 10 - 1
    else:
        number = float(value) if isinstance(value, (int, float)) else 1.0
        bad = number * 0.01 - 1 if spec.kind == "higher" else number * 100 + 1
    out = copy.deepcopy(doc)
    set_path(out, spec.path, bad)
    return out


def test_gates_are_the_jax_packages():
    assert benchgate.GATES == jax_benchgate.GATES
    assert benchgate.BASELINE_FILES == jax_benchgate.BASELINE_FILES
    assert sorted(benchgate.BASELINE_FILES.values()) == sorted(set(BENCHES) & set(benchgate.BASELINE_FILES.values()))


@pytest.mark.parametrize("tolerance", [1.0, 2.0, 0.5])
@pytest.mark.parametrize("name", BENCHES)
def test_report_of_each_gated_number_matches_jax(name, tolerance):
    doc = load(name)
    candidates = [doc] + [regressed(doc, spec) for spec in benchgate.GATES[doc["bench"]]]
    for candidate in candidates:
        port = benchgate.compare(doc, candidate, tolerance_scale=tolerance)
        jax = jax_benchgate.compare(doc, candidate, tolerance_scale=tolerance)
        assert port == jax
        assert benchgate.render_report(port) == jax_benchgate.render_report(jax)
    assert all(not benchgate.compare(doc, c)["ok"] for c in candidates[1:])


def test_mismatched_and_unknown_benches_raise_as_in_jax():
    serve, route = load("BENCH_SERVE.json"), load("BENCH_ROUTE.json")
    for baseline, candidate in ((serve, route), ({"bench": "nope"}, {"bench": "nope"})):
        with pytest.raises(ValueError) as port:
            benchgate.compare(baseline, candidate)
        with pytest.raises(ValueError) as jax:
            jax_benchgate.compare(baseline, candidate)
        assert str(port.value) == str(jax.value)


def _run_both(args, capsys):
    """``(port exit code, port output, JAX exit code, JAX output)``; the
    port's stderr joins its stdout, as the click runner's does."""
    capsys.readouterr()
    try:
        code = cli.main(["bench-check", *args])
    except SystemExit as exc:
        code = exc.code
    captured = capsys.readouterr()
    result = CliRunner().invoke(gordo_tpu_cli, ["bench-check", *args])
    return code, captured.out + captured.err, result.exit_code, result.output


@pytest.mark.parametrize("case", ["beside", "cwd", "regressed", "report-only", "as-json", "tolerance", "explicit",
                                  "unknown-bench", "no-baseline", "unreadable", "mismatch"])
def test_command_matches_jax(case, tmp_path, monkeypatch, capsys):
    """The baseline lookup (beside the candidate, then the current
    directory), the output and the exit codes."""
    monkeypatch.chdir(tmp_path)
    fresh = tmp_path / "runs" / "fresh.json"
    fresh.parent.mkdir()
    doc = load("BENCH_SERVE.json")
    spec = benchgate.GATES["serve-micro-batching"][0]
    candidate = regressed(doc, spec) if case in ("regressed", "report-only", "tolerance") else doc
    fresh.write_text(json.dumps(candidate))
    args = [str(fresh)]
    if case == "cwd":
        shutil.copy(os.path.join(REPO, "BENCH_SERVE.json"), tmp_path / "BENCH_SERVE.json")
    elif case != "no-baseline":
        shutil.copy(os.path.join(REPO, "BENCH_SERVE.json"), fresh.parent / "BENCH_SERVE.json")
    if case == "report-only":
        args.append("--report-only")
    elif case == "as-json":
        args.append("--as-json")
    elif case == "tolerance":
        args += ["--tolerance", "1000"]
    elif case == "explicit":
        args += ["--baseline", os.path.join(REPO, "BENCH_SERVE.json")]
    elif case == "unknown-bench":
        fresh.write_text(json.dumps({"bench": "nope"}))
    elif case == "unreadable":
        fresh.write_text("{not json")
    elif case == "mismatch":
        args += ["--baseline", os.path.join(REPO, "BENCH_ROUTE.json")]
    port_code, port_out, jax_code, jax_out = _run_both(args, capsys)
    expected_code = {"regressed": 1, "unknown-bench": 1, "no-baseline": 1, "unreadable": 1, "mismatch": 1}.get(case, 0)
    assert port_code == jax_code == expected_code
    if case == "as-json":
        assert json.loads(port_out) == json.loads(jax_out)
    else:
        assert port_out == jax_out


@pytest.mark.parametrize("missing", ["candidate", "baseline"])
def test_missing_files_are_usage_errors(missing, tmp_path, capsys):
    candidate = os.path.join(REPO, "BENCH_SERVE.json")
    args = [str(tmp_path / "nope.json")] if missing == "candidate" else [candidate, "--baseline",
                                                                         str(tmp_path / "nope.json")]
    port_code, port_out, jax_code, _ = _run_both(args, capsys)
    assert port_code == jax_code == 2
    assert "does not exist" in port_out
