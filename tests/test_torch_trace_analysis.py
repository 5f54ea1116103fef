"""The port's trace analysis (``gordo_tpu_torch/telemetry/trace_analysis.py``)
and its ``trace`` command, held to the JAX package's on the CPU: the
same traces, in separate copies of one directory, through
``analyze_trace`` and ``render_analysis`` of each package, and through
both commands with ``--as-json``, ``--since`` and ``--last``.

The traces: the seeded span corpus of ``tests/test_torch_rollups.py``
(requests with nested stages, profile, engine batch and stream spans)
as one file, as a rotated chain, and as worker variants holding
duplicates; and the ``serve_trace.jsonl`` the port's own app wrote on the
CPU. Analyses are compared exactly: percentiles are nearest-rank picks of
the same recorded durations, and every sum runs in the same order.
"""

import json
import os
import shutil
import time

import pytest
from click.testing import CliRunner

from gordo_tpu.cli.cli import gordo_tpu_cli
from gordo_tpu.telemetry import aggregate as jax_aggregate
from gordo_tpu.telemetry import trace_analysis as jax_trace_analysis
from gordo_tpu_torch.cli.cli import main as port_cli
from gordo_tpu_torch.telemetry import aggregate, trace_analysis
from tests.test_torch_request_tracing import collections  # noqa: F401 - the fixture is used by name
from tests.test_torch_rollups import (  # noqa: F401 - the fixtures are used by name
    NOW,
    clean_settings,
    copies,
    layout,
    port_trace,
)

#: the time windows' ``since_ts`` (the trace command bounds no end)
WINDOWS = [None, NOW + 100, NOW + 200, NOW + 250]


def bases(directory, find_bases):
    return [find_bases(directory, name) for name in ("serve_trace.jsonl", "build_trace.jsonl")]


def same_paths(port_doc, jax_doc, dirs):
    """The documents as text, each directory's path written ``D``."""
    return json.dumps(port_doc).replace(dirs[1], "D"), json.dumps(jax_doc).replace(dirs[0], "D")


@pytest.mark.parametrize("window", range(len(WINDOWS)), ids=["all", "since-100", "since-200", "since-250"])
@pytest.mark.parametrize("kind", ["single", "rotated", "workers"])
def test_analysis_matches_jax(tmp_path, kind, window):
    """Each logical trace of the directory (the serve trace's files merged,
    then the build trace's): equal documents and renderings, with and
    without a time window; the rotated generations skipped by mtime."""
    dirs = copies(tmp_path, lambda d: layout(d, kind, seed=5))
    if kind == "rotated":  # the oldest generation last written between the windows: kept by some, skipped by others
        for directory in dirs:
            os.utime(os.path.join(directory, "serve_trace.jsonl.2"), (NOW + 150, NOW + 150))
    since = WINDOWS[window]
    groups = bases(dirs[0], jax_trace_analysis.trace_bases), bases(dirs[1], aggregate.sink_bases)
    assert [[p.replace(dirs[1], "D") for p in g] for g in groups[1]] == [[p.replace(dirs[0], "D") for p in g]
                                                                         for g in groups[0]]
    for jax_group, group in zip(*groups):
        if not group:
            continue
        docs = (jax_trace_analysis.analyze_trace(jax_group, since_ts=since),
                trace_analysis.analyze_trace(group, since_ts=since))
        assert docs[1]["spans_read"] > 0
        assert same_paths(docs[1], docs[0], dirs)[0] == same_paths(docs[1], docs[0], dirs)[1]
        rendered = trace_analysis.render_analysis(docs[1]), jax_trace_analysis.render_analysis(docs[0])
        assert rendered[0].replace(dirs[1], "D") == rendered[1].replace(dirs[0], "D")
        spans = list(trace_analysis.read_traces(group))
        assert trace_analysis.summarize_spans(spans) == jax_trace_analysis.summarize_spans(spans)
        assert trace_analysis.request_breakdown(spans) == jax_trace_analysis.request_breakdown(spans)
        assert trace_analysis.stream_breakdown(spans) == jax_trace_analysis.stream_breakdown(spans)
        assert trace_analysis.prediction_accuracy(spans) == jax_trace_analysis.prediction_accuracy(spans)
        assert trace_analysis.top_profile_frames(spans) == jax_trace_analysis.top_profile_frames(spans)
    for path in (os.path.join(dirs[1], "serve_trace.jsonl"), os.path.join(dirs[1], "missing")):
        assert trace_analysis.iter_trace_files(path, since) == jax_trace_analysis.iter_trace_files(path, True, since)


def test_generations_skipped_by_the_manifest_window(tmp_path):
    """With the rollups' manifest, a rotated generation whose spans all end
    before ``--since`` is skipped unread, even when written later."""
    dirs = copies(tmp_path, lambda d: layout(d, "rotated", seed=9))
    for directory, module in zip(dirs, (jax_aggregate, aggregate)):
        module.RollupStore(directory).aggregate()
        late = time.time()
        for name in ("serve_trace.jsonl.1", "serve_trace.jsonl.2"):
            os.utime(os.path.join(directory, name), (late, late))
    indexes = jax_aggregate.sink_window_index(dirs[0]), aggregate.sink_window_index(dirs[1])
    assert indexes[1] == indexes[0]
    since = max(indexes[1][f"serve_trace.jsonl.{n}"]["max_ts"] for n in (1, 2)) + 1e-3
    files = (jax_trace_analysis.iter_trace_files(os.path.join(dirs[0], "serve_trace.jsonl"), since_ts=since,
                                                 window_index=indexes[0]),
             trace_analysis.iter_trace_files(os.path.join(dirs[1], "serve_trace.jsonl"), since_ts=since,
                                             window_index=indexes[1]))
    assert [os.path.basename(p) for p in files[1]] == [os.path.basename(p) for p in files[0]] == ["serve_trace.jsonl"]
    docs = (jax_trace_analysis.analyze_trace(files[0][0], since_ts=since, window_index=indexes[0]),
            trace_analysis.analyze_trace(files[1][0], since_ts=since, window_index=indexes[1]))
    assert same_paths(docs[1], docs[0], dirs)[0] == same_paths(docs[1], docs[0], dirs)[1]


def run_both(capsys, args, dirs):
    """``args`` (``{}`` the directory) through both ``trace`` commands:
    ``[(exit code, stdout, stderr)]``, JAX first."""
    capsys.readouterr()
    jax = CliRunner().invoke(gordo_tpu_cli, [a.format(dirs[0]) for a in args])
    code = port_cli([a.format(dirs[1]) for a in args])
    out = capsys.readouterr()
    return (jax.exit_code, jax.stdout.replace(dirs[0], "D"), jax.stderr.replace(dirs[0], "D")), \
        (code, out.out.replace(dirs[1], "D"), out.err.replace(dirs[1], "D"))


@pytest.mark.parametrize("args", [
    ["trace", "{}"], ["trace", "{}", "--as-json"], ["trace", "{}/serve_trace.jsonl", "--as-json"],
    ["trace", "{}", "--as-json", "--since", str(NOW + 200)], ["trace", "{}", "--since", "2025-07-31T22:20:00+00:00"],
    ["trace", "{}", "--as-json", "--last", "{last}"], ["trace", "{}", "--since", "soon"],
    ["trace", "{}", "--since", "1", "--last", "1h"], ["trace", "{}/missing"], ["trace", "{}/empty"],
], ids=["text", "json", "file", "since-epoch", "since-iso", "last", "bad-since", "both", "missing", "no-trace"])
def test_trace_command_matches_jax(tmp_path, capsys, args):
    """The serve and build traces of a directory (rotated, with the
    rollups' manifest), a file, the time windows and the errors: equal
    output and exit codes. ``--last`` reads the clock, so its cutoff is
    left out of the comparison."""
    def make(directory):
        layout(directory, "rotated", seed=13)
        os.makedirs(os.path.join(directory, "empty"))
        aggregate.RollupStore(directory).aggregate()

    dirs = copies(tmp_path, make)
    last = f"{int(time.time() - NOW - 300)}s"  # keeps the spans after NOW + 300
    (jax_code, jax_out, jax_err), (code, out, err) = run_both(capsys, [a.replace("{last}", last) for a in args], dirs)
    assert code == jax_code
    if code:
        assert out == jax_out == ""
        assert err == jax_err and err.startswith("Error: ")
        return
    if "--last" in args:
        jax_docs, docs = json.loads(jax_out), json.loads(out)
        assert len(docs) == len(jax_docs) == 2  # the serve trace, then the build trace
        for jax_doc, doc in zip(jax_docs, docs):
            assert abs(doc.pop("window")["since_ts"] - jax_doc.pop("window")["since_ts"]) < 60
            assert doc == jax_doc
        assert docs[0]["spans_read"] > 0
        return
    assert out == jax_out


def test_port_app_trace_analysis_matches_jax(port_trace, tmp_path, capsys):
    """The port server's own trace: equal analyses and ``trace`` output in
    both packages; it counts every request sent, each stage of the
    scoring requests, and the stream's rows."""
    trace_dir, sent, spans = port_trace
    dirs = str(tmp_path / "jax"), str(tmp_path / "port")
    for directory in dirs:
        shutil.copytree(trace_dir, directory)
    (jax_code, jax_out, _), (code, out, _) = run_both(capsys, ["trace", "{}", "--as-json"], dirs)
    assert code == jax_code == 0 and out == jax_out
    doc = json.loads(out)
    breakdown = doc["request_breakdown"]
    assert breakdown["requests"] == len(sent) == doc["span_summary"]["request"]["count"]
    by_route = {}
    for span in trace_analysis.read_traces(aggregate.sink_bases(dirs[1], "serve_trace.jsonl")):
        if span["name"] == "request":
            attributes = span["attributes"]
            key = (attributes["http.route"], attributes["http.status_code"])
            by_route[key] = by_route.get(key, 0) + 1
    assert sum(by_route.values()) == len(sent) and by_route[("anomaly-prediction", 500)] == 1
    assert {"model_resolve", "data_decode", "inference", "serialize"} <= set(breakdown["stages"])
    assert 0.0 < breakdown["attribution_coverage"] <= 1.0
    stream = doc["stream_breakdown"]["totals"]
    assert stream["rows_in"] == 32 and stream["rows_scored"] == sum(
        s["attributes"]["rows_scored"] for s in spans if s["name"] == "stream_score")
    (_, jax_text, _), (_, text, _) = run_both(capsys, ["trace", "{}"], dirs)
    assert text == jax_text and "attribution coverage" in text
    assert trace_analysis.render_analysis(doc).replace(dirs[1], "D") == text.rstrip("\n")
