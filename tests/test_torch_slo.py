"""The port's SLO engine (``gordo_tpu_torch/telemetry/slo.py``), its
``/slo`` route and its ``slo status|check`` commands, held to the JAX
package's on the CPU.

- Configs: the packaged ``slos.toml``, a drill file, the resolution
  order, and malformed files (the same ``ValueError`` messages).
- ``evaluate(dir, now=t)`` over a sequence of times, in separate copies of
  one span corpus: equal documents (budgets, burn rates, alert states and
  their transitions) apart from ``generated_at`` and the directory's path,
  equal ``slo_state.json``, equal ``firing_alerts`` and an equal ``slo``
  section of ``fleet_status_document`` whether this process evaluated or
  not.
- The drill end to end: a JAX app and a port app (``device="cpu"``), each
  with its own telemetry directory, every request exported, a drill
  ``slos.toml``: clean anomaly requests, a burst of real 500s (a model
  whose artifact is broken on disk), then twenty times as many clean
  requests. After each stage ``slo check``'s exit code, ``slo status
  --as-json``, ``/slo`` and ``/fleet-health``'s ``slo`` section agree
  across the packages. The route's 404, 422 and 503 are the JAX route's.

Every value compared is a count or a ratio of counts, so they are
compared exactly; in the drill the latencies (each app's own timing) and
the times are taken out.
"""

import json
import os
import re
import shutil
import time

import pytest
from click.testing import CliRunner
from werkzeug.test import Client

from gordo_tpu.cli.cli import gordo_tpu_cli
from gordo_tpu.server import build_app as jax_build_app
from gordo_tpu.server.fleet_store import STORE as JAX_STORE
from gordo_tpu.telemetry import aggregate as jax_aggregate
from gordo_tpu.telemetry import fleet_health as jax_fleet_health
from gordo_tpu.telemetry import slo as jax_slo
from gordo_tpu_torch.cli.cli import main as port_cli
from gordo_tpu_torch.server import build_app
from gordo_tpu_torch.telemetry import aggregate, fleet_health, slo
from tests.test_torch_request_tracing import (  # noqa: F401 - the fixture is used by name
    REVISION,
    TAGS,
    _frame,
    _reset_globals,
    call,
    collections,
    read_trace,
    url,
)
from tests.test_torch_rollups import NOW, serve_spans, write_jsonl

DRILL_SLOS = """
[[slo]]
name = "availability"
objective = "availability"
target = 0.99
window = "30d"

[burn]
fast_window = "1h"
fast_threshold = 10.0
fast_severity = "page"
slow_window = "6h"
slow_threshold = 6.0
slow_severity = "ticket"
confirmation_divisor = 12
"""
MALFORMED = {
    "objective": '[[slo]]\nname = "x"\nobjective = "nope"\ntarget = 0.9\n',
    "target": '[[slo]]\nname = "x"\nobjective = "availability"\ntarget = 1.5\n',
    "threshold": '[[slo]]\nname = "x"\nobjective = "latency"\ntarget = 0.9\n',
    "duplicate": '[[slo]]\nname = "x"\nobjective = "availability"\ntarget = 0.9\n' * 2,
    "window": '[[slo]]\nname = "x"\nobjective = "availability"\ntarget = 0.9\nwindow = "soon"\n',
    "toml": '[[slo]]\nname = "x"\ntarget = 0..99\n',
}
#: keys whose values are times, or paths of each copy
TIME_KEYS = {"generated_at", "since", "last_transition", "updated_at", "evaluated_at"}
ISO = re.compile(r"\d{4}-\d\d-\d\dT[\d:.]+\+00:00")


@pytest.fixture(autouse=True)
def clean(monkeypatch):
    for name in ("GORDO_TPU_SLO_CONFIG", "GORDO_TPU_SLO_WINDOW_SECONDS", "GORDO_TPU_SLO_SCRAPE_REFRESH",
                 "GORDO_TPU_SLO_ROLLUP_KEEP", "GORDO_TPU_SLO_SINK_GC_AGE", "GORDO_TPU_ROLLUP_MANIFEST",
                 "GORDO_TPU_TELEMETRY_DIR", "GORDO_TPU_TELEMETRY", "GORDO_TPU_WORKER_SINKS", "PROMETHEUS_MULTIPROC_DIR"):
        monkeypatch.delenv(name, raising=False)
    for reset in (jax_slo.reset_statuses, slo.reset_statuses):
        reset()
    yield
    for reset in (jax_slo.reset_statuses, slo.reset_statuses):
        reset()


def untimed(doc, paths=()):
    """``doc`` without time values, each of ``paths`` written ``D``."""
    if isinstance(doc, dict):
        return {k: untimed(v, paths) for k, v in doc.items() if k not in TIME_KEYS}
    if isinstance(doc, list):
        return [untimed(v, paths) for v in doc]
    if isinstance(doc, str):
        for path in paths:
            doc = doc.replace(path, "D")
    return doc


def write_config(directory, text):
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, "slos.toml"), "w") as f:
        f.write(text)


# -- configs ------------------------------------------------------------------


@pytest.mark.parametrize("where", ["packaged", "local", "setting", "path"])
def test_config_matches_jax(tmp_path, monkeypatch, where):
    """The resolution order (setting, the directory's file, the packaged
    file) and the parsed objectives and rules, in both."""
    directory = str(tmp_path / "telemetry")
    os.makedirs(directory)
    path = None
    if where == "local":
        write_config(directory, DRILL_SLOS)
    elif where == "setting":
        write_config(str(tmp_path / "elsewhere"), DRILL_SLOS.replace("0.99", "0.95"))
        monkeypatch.setenv("GORDO_TPU_SLO_CONFIG", str(tmp_path / "elsewhere" / "slos.toml"))
    elif where == "path":
        write_config(str(tmp_path / "given"), DRILL_SLOS.replace('"1h"', '"30m"'))
        path = str(tmp_path / "given" / "slos.toml")
    configs = jax_slo.load_slo_config(directory, path=path), slo.load_slo_config(directory, path=path)
    if where == "packaged":
        assert configs[1].source == slo.DEFAULT_SLOS_PATH and configs[0].source == jax_slo.DEFAULT_SLOS_PATH
        with open(slo.DEFAULT_SLOS_PATH) as a, open(jax_slo.DEFAULT_SLOS_PATH) as b:
            assert a.read() == b.read()
        assert [s.name for s in configs[1].slos] == ["availability", "full-route-p95", "stream-freshness",
                                                     "stream-integrity"]
    else:
        assert configs[1].source == configs[0].source
    assert [vars(s) for s in configs[1].slos] == [vars(s) for s in configs[0].slos]
    assert [vars(r) for r in configs[1].rules] == [vars(r) for r in configs[0].rules]
    assert [s.budget for s in configs[1].slos] == [s.budget for s in configs[0].slos]
    with open(slo.DEFAULT_SLOS_PATH) as f:
        text = f.read()
    assert slo._parse_toml_subset(text) == jax_slo._parse_toml_subset(text)


@pytest.mark.parametrize("body", sorted(MALFORMED))
def test_malformed_config_raises_like_jax(tmp_path, body):
    """The same ``ValueError`` for each malformed file, from the reader
    Python has and from the subset reader."""
    path = str(tmp_path / "slos.toml")
    with open(path, "w") as f:
        f.write(MALFORMED[body])
    errors = []
    for module in (jax_slo, slo):
        with pytest.raises(ValueError) as error:
            module.load_slo_config(path=path)
        errors.append(str(error.value))
    assert errors[1] == errors[0]
    subset = []
    for module in (jax_slo, slo):
        try:
            subset.append(module._parse_toml_subset(MALFORMED[body]))
        except ValueError as exc:
            subset.append(str(exc))
    assert subset[1] == subset[0]


def test_math_matches_jax():
    """Durations, the fraction over a threshold, burn rates and the state
    machine's every step."""
    for value in ("30d", "1h", "90m", "2w", " 5 s ", 45, 2.5):
        assert slo.parse_duration(value) == jax_slo.parse_duration(value)
    for value in ("soon", True, "5y"):
        with pytest.raises(ValueError):
            slo.parse_duration(value)
    histogram = aggregate.new_histogram()
    for value in (0.5, 3.0, 80.0, 120.0, 999.0, 2000.0, 1e6):
        aggregate.histogram_add(histogram, value)
    for threshold in (0.0, 1.0, 100.0, 1000.0, 5000.0, 1e9):
        assert slo.histogram_fraction_over(histogram, threshold) == jax_slo.histogram_fraction_over(histogram,
                                                                                                   threshold)
    spec = slo.SloSpec("a", "availability", 0.999, "30d", 30 * 86400.0)
    jax_spec = jax_slo.SloSpec("a", "availability", 0.999, "30d", 30 * 86400.0)
    assert [slo.burn_rate(spec, f) for f in (0.0, 0.0144, 0.5)] == [jax_slo.burn_rate(jax_spec, f)
                                                                   for f in (0.0, 0.0144, 0.5)]
    for previous in (None, *slo.ALERT_STATES):
        for exceeded in (True, False):
            assert slo.advance_alert_state(previous, exceeded) == jax_slo.advance_alert_state(previous, exceeded)


# -- evaluation over a corpus ---------------------------------------------------

#: the evaluation times: before the traffic, inside it, an hour on, a day on
TIMES = (NOW - 60, NOW + 300, NOW + 610, NOW + 620, NOW + 3600, NOW + 4000, NOW + 90000)


def corpus(directory, config):
    """Two bursts of mixed traffic (the seeded corpus, a fifth errors) and
    a clean stretch, with the config beside them."""
    os.makedirs(directory)
    if config == "drill":
        write_config(directory, DRILL_SLOS)
    spans = serve_spans(21, 300) + serve_spans(22, 200, t0=NOW + 3000, prefix=1)
    write_jsonl(os.path.join(directory, "serve_trace.jsonl"), spans)


@pytest.mark.parametrize("config", ["packaged", "drill"])
def test_evaluation_sequence_matches_jax(tmp_path, config):
    """``evaluate(dir, now=t)`` over :data:`TIMES`, with more spans landing
    between two evaluations: each document, ``slo_state.json`` after each,
    ``firing_alerts`` and the fleet-status ``slo`` section are equal."""
    dirs = str(tmp_path / "jax"), str(tmp_path / "port")
    paths = (dirs[0], jax_slo.DEFAULT_SLOS_PATH), (dirs[1], slo.DEFAULT_SLOS_PATH)
    for directory in dirs:
        corpus(directory, config)
    transitions = []
    for i, now in enumerate(TIMES):
        if i == 3:  # late spans of the first burst, read by the next evaluation
            for directory in dirs:
                write_jsonl(os.path.join(directory, "serve_trace.jsonl"), serve_spans(23, 50, prefix=2), mode="a")
        docs = jax_slo.evaluate(dirs[0], now=now), slo.evaluate(dirs[1], now=now)
        assert docs[1]["generated_at"] == docs[0]["generated_at"]
        assert untimed(docs[1], paths[1]) == untimed(docs[0], paths[0])
        assert [a["since"] for a in docs[1]["alerts"]] == [a["since"] for a in docs[0]["alerts"]]
        states = []
        for directory, own in zip(dirs, paths):
            with open(os.path.join(directory, "slo_state.json")) as f:
                state = json.load(f)
            states.append({**state, "config_source": untimed(state["config_source"], own)})
        assert states[1] == states[0]
        assert slo.firing_alerts(dirs[1]) == jax_slo.firing_alerts(dirs[0])
        assert slo.firing_alerts(dirs[1], severity="page") == jax_slo.firing_alerts(dirs[0], severity="page")
        assert slo.slo_section(dirs[1]) == jax_slo.slo_section(dirs[0])
        assert slo.render_slo_status(docs[1]).replace(dirs[1], "D") == jax_slo.render_slo_status(docs[0]).replace(
            dirs[0], "D")
        transitions.append({a["id"]: a["state"] for a in docs[1]["alerts"]})
    # the sequence walks the whole machine
    seen = {state for step in transitions for state in step.values()}
    assert {"inactive", "pending", "firing", "resolved"} <= seen
    assert slo.firing_alerts(dirs[1], max_age_s=60.0) == jax_slo.firing_alerts(dirs[0], max_age_s=60.0) == []
    # the fleet-status section: this process's evaluation, then the persisted alerts alone
    for evaluated in (True, False):
        if not evaluated:
            jax_slo.reset_statuses()
            slo.reset_statuses()
        sections = [module.fleet_status_document(d)["slo"] for module, d in zip((jax_fleet_health, fleet_health), dirs)]
        assert (sections[1]["budgets"] is not None) == evaluated
        assert sections[1] == sections[0]
        rendered = [m.render_fleet_status({"slo": s}) for m, s in zip((jax_fleet_health, fleet_health), sections)]
        assert rendered[1] == rendered[0]


def test_evaluate_cached_watch_and_scrape(tmp_path, monkeypatch, collections):
    """``evaluate_cached`` re-serves a young status and evaluates an old
    one; ``build_app`` watches its telemetry directory (none with
    telemetry off); ``scrape_statuses`` evaluates the watched ones."""
    directory = str(tmp_path / "telemetry")
    corpus(directory, "drill")
    first = slo.evaluate_cached(directory)
    assert slo.evaluate_cached(directory) is first
    monkeypatch.setenv("GORDO_TPU_SLO_SCRAPE_REFRESH", "0")
    assert slo.evaluate_cached(directory) is not first
    slo.reset_statuses()
    monkeypatch.setenv("GORDO_TPU_TELEMETRY_DIR", directory)
    monkeypatch.setenv("GORDO_TPU_SERVE_WARMUP", "0")
    build_app(collections[1], device="cpu")
    assert slo._watched == {directory}
    monkeypatch.setenv("GORDO_TPU_SLO_SCRAPE_REFRESH", "60")
    statuses = slo.scrape_statuses()
    assert list(statuses) == [directory] and statuses[directory]["slos"][0]["name"] == "availability"
    slo.reset_statuses()
    monkeypatch.setenv("GORDO_TPU_TELEMETRY", "0")
    build_app(collections[1], device="cpu")
    assert slo._watched == set()


# -- the commands ---------------------------------------------------------------


def run_both(capsys, args, jax_dir, port_dir):
    """``args`` (with ``{}`` for the directory) through both CLIs:
    ``[(exit code, stdout, stderr)]``, JAX first."""
    capsys.readouterr()
    jax = CliRunner().invoke(gordo_tpu_cli, [a.format(jax_dir) for a in args])
    code = port_cli([a.format(port_dir) for a in args])
    out = capsys.readouterr()
    return [(jax.exit_code, jax.stdout, jax.stderr), (code, out.out, out.err)]


@pytest.mark.parametrize("args", [["slo", "status", "{}"], ["slo", "status", "{}", "--as-json"],
                                  ["slo", "check", "{}"], ["slo", "check", "{}", "--as-json"],
                                  ["slo", "check", "{}-missing"], ["slo", "status", "{}/bad"]])
def test_slo_commands_match_jax(tmp_path, capsys, args):
    """Text and JSON, ``check`` exiting 1 while an alert fires, a missing
    directory and a bad config: the JAX commands' output and exit codes."""
    dirs = str(tmp_path / "jax"), str(tmp_path / "port")
    for directory in dirs:
        corpus(directory, "drill")
        write_config(os.path.join(directory, "bad"), MALFORMED["objective"])
        write_jsonl(os.path.join(directory, "serve_trace.jsonl"),
                    serve_spans(5, 40, t0=time.time() - 290, seconds=240.0, prefix=3), mode="a")
    results = run_both(capsys, args, *dirs)
    results += run_both(capsys, args, *dirs)  # a second evaluation steps the alerts
    jax_codes = [r[0] for r in results[::2]]
    assert [r[0] for r in results[1::2]] == jax_codes
    if args[2].endswith("-missing") or args[2].endswith("/bad"):
        assert jax_codes == [1, 1]
        for (_, jax_out, jax_err), (_, out, err) in zip(results[::2], results[1::2]):
            assert out == jax_out == ""
            assert err.replace(dirs[1], "D") == jax_err.replace(dirs[0], "D")
        return
    if args[1] == "check":
        assert jax_codes == [0, 1]  # pending, then firing
    for (_, jax_out, _), (_, out, _) in zip(results[::2], results[1::2]):
        if "--as-json" in args:
            jax_doc, doc = json.loads(jax_out), json.loads(out)
            assert doc["aggregation"].pop("spans_read") == jax_doc["aggregation"].pop("spans_read")
            assert untimed(doc, dirs[1:]) == untimed(jax_doc, dirs[:1])
        else:
            assert ISO.sub("T", out.replace(dirs[1], "D")) == ISO.sub("T", jax_out.replace(dirs[0], "D"))


# -- the route and the drill ------------------------------------------------------


@pytest.fixture
def drill(collections, tmp_path, monkeypatch):
    """Both apps over copies of the collection, every request exported,
    each with its own telemetry directory holding the drill config:
    ``(jax_client, port_app, (jax_served, port_served), (jax_tel, port_tel))``."""
    served = str(tmp_path / "jax" / REVISION), str(tmp_path / "port" / REVISION)
    for source, copy in zip(collections, served):
        shutil.copytree(source, copy, ignore=shutil.ignore_patterns("fleet_health*"))
    telemetry = str(tmp_path / "jax-telemetry"), str(tmp_path / "port-telemetry")
    for directory in telemetry:
        write_config(directory, DRILL_SLOS)
    for name in ("GORDO_TPU_BATCHING", "GORDO_TPU_PROFILE_SAMPLE_RATE", "GORDO_TPU_PROFILE_DIR"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("GORDO_TPU_TRACE_SAMPLE_RATE", "1.0")
    monkeypatch.setenv("GORDO_TPU_SERVE_WARMUP", "0")
    # the route serves the status the commands left (the JAX default refresh, 60 s, could lapse mid-drill)
    monkeypatch.setenv("GORDO_TPU_SLO_SCRAPE_REFRESH", "3600")
    monkeypatch.setenv("MODEL_COLLECTION_DIR", served[0])
    _reset_globals()
    JAX_STORE.invalidate(served[0])
    yield Client(jax_build_app(config={"EXPECTED_MODELS": []})), build_app(served[1], device="cpu"), served, telemetry
    _reset_globals()
    JAX_STORE.invalidate(served[0])


def drill_view(doc):
    """What both packages' drill documents share: every count, ratio,
    state and threshold; not the latencies (each app's own), times or
    paths."""
    doc = untimed(doc)
    recent = doc["recent"]
    return {
        "slos": doc["slos"], "alerts": doc["alerts"], "firing": doc["firing"], "pending": doc["pending"],
        "ok": doc["ok"], "rules": doc["config"]["rules"],
        "recent": {k: recent[k] for k in ("requests", "errors", "error_rate", "machines")},
    }


def test_slo_drill_matches_jax(drill, capsys):
    """Clean traffic, a burst of real 500s, then twenty times as many
    clean requests, to both apps; after each stage the check's exit code,
    the status, ``/slo`` and ``/fleet-health``'s section agree across the
    packages, and walk inactive, pending, firing, resolved."""
    jax_client, port_app, served, telemetry = drill
    clients = (jax_client, port_app)

    def send(name, count, expected):
        for i in range(count):
            body = {"X": _frame(TAGS[name], 10, i), "y": _frame(TAGS[name], 10, i)}
            for client, trace_dir in zip(clients, telemetry):
                status, _, _ = call(client, trace_dir, "POST", url(f"{name}/anomaly/prediction"), body)
                assert status == expected
        read_trace(telemetry[0], jax=True)
        read_trace(telemetry[1])

    def check():
        results = run_both(capsys, ["slo", "check", "{}", "--as-json"], *telemetry)
        assert results[1][0] == results[0][0]
        docs = [json.loads(out) for _, out, _ in results]
        assert drill_view(docs[1]) == drill_view(docs[0])
        return results[1][0], {a["id"]: a["state"] for a in docs[1]["alerts"]}

    def agree():
        """``slo status --as-json``, then ``/slo`` and ``/fleet-health``
        (the status just evaluated, cached): equal in each package and
        across them."""
        results = run_both(capsys, ["slo", "status", "{}", "--as-json"], *telemetry)
        statuses = [json.loads(out) for _, out, _ in results]
        assert drill_view(statuses[1]) == drill_view(statuses[0])
        for client, trace_dir, status in zip(clients, telemetry, statuses):
            code, _, body = call(client, trace_dir, "GET", url("slo"))
            assert code == 200
            route = json.loads(body)
            route.pop("revision", None)
            assert route == status
            code, _, body = call(client, trace_dir, "GET", url("fleet-health"))
            section = json.loads(body)["slo"]
            assert code == 200 and section["alerts"] == status["alerts"]
            assert section["budgets"] == {s["name"]: s["budget"]["remaining_ratio"] for s in status["slos"]}
            assert section["evaluated_at"] == status["generated_at"]
        sections = [slo.slo_section(telemetry[1]), jax_slo.slo_section(telemetry[0])]
        assert untimed(sections[0]) == untimed(sections[1])
        return {a["id"]: a["state"] for a in statuses[1]["alerts"]}

    send("machine-1", 6, 200)
    assert check() == (0, {"availability:fast": "inactive", "availability:slow": "inactive"})
    assert agree() == {"availability:fast": "inactive", "availability:slow": "inactive"}

    # the burst: machine-2's artifact broken on disk, its requests answer 500
    originals = []
    for directory, store in zip(served, (JAX_STORE, port_app.store)):
        path = os.path.join(directory, "machine-2", "model.pkl")
        with open(path, "rb") as f:
            originals.append(f.read())
        with open(path, "wb") as f:
            f.write(b"not a pickle")
        store.invalidate(directory)
    send("machine-2", 6, 500)
    assert check() == (0, {"availability:fast": "pending", "availability:slow": "pending"})
    assert check() == (1, {"availability:fast": "firing", "availability:slow": "firing"})
    assert agree() == {"availability:fast": "firing", "availability:slow": "firing"}
    assert [a["id"] for a in slo.firing_alerts(telemetry[1], severity="page")] == ["availability:fast"]

    for directory, store, original in zip(served, (JAX_STORE, port_app.store), originals):
        with open(os.path.join(directory, "machine-2", "model.pkl"), "wb") as f:
            f.write(original)
        store.invalidate(directory)
    send("machine-2", 120, 200)
    assert check() == (0, {"availability:fast": "resolved", "availability:slow": "resolved"})
    assert agree() == {"availability:fast": "inactive", "availability:slow": "inactive"}
    summary = aggregate.summarize_rollup(aggregate.RollupStore(telemetry[1]).merged())
    jax_summary = jax_aggregate.summarize_rollup(jax_aggregate.RollupStore(telemetry[0]).merged())
    assert summary["errors"] == jax_summary["errors"] == 6
    assert summary["requests"] == jax_summary["requests"]


@pytest.mark.parametrize("case", ["404", "422", "503", "anchor"])
def test_slo_route_statuses_match_jax(drill, tmp_path, monkeypatch, case):
    """No directory (404), a bad config (422), a directory that cannot
    hold the rollups (503), and the served directory when no telemetry
    directory is set (200, no traffic)."""
    jax_client, port_app, _, telemetry = drill
    if case == "422":
        for directory in telemetry:
            write_config(directory, MALFORMED["target"])
    elif case == "503":
        for directory in telemetry:
            with open(os.path.join(directory, "rollups"), "w") as f:
                f.write("a file where the rollups go")
    elif case == "404":  # a directory no exported request can make: its parent is a file
        with open(tmp_path / "file", "w") as f:
            f.write("not a directory")
    answers = []
    for client, trace_dir in zip((jax_client, port_app), telemetry):
        if case == "404":
            trace_dir = str(tmp_path / "file" / "telemetry")
        monkeypatch.setenv("GORDO_TPU_TELEMETRY_DIR", trace_dir)
        if case == "anchor":
            monkeypatch.delenv("GORDO_TPU_TELEMETRY_DIR")
        client = client if isinstance(client, Client) else Client(client)
        response = client.get(url("slo"))
        answers.append((response.status_code, json.loads(response.get_data())))
    (jax_status, jax_doc), (status, doc) = answers
    assert status == jax_status == {"404": 404, "422": 422, "503": 503, "anchor": 200}[case]
    if case == "anchor":
        assert doc["ok"] and doc["recent"]["requests"] == 0
        assert untimed(doc)["slos"] == untimed(jax_doc)["slos"]
    else:
        assert re.sub(r"'[^']*'", "P", doc["error"]) == re.sub(r"'[^']*'", "P", jax_doc["error"])
