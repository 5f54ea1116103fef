"""The port's deploy pod commands against the JAX package's, on the CPU.

- ``run-server``: a ``python -m gordo_tpu_torch run-server --device cpu
  --batching`` subprocess with engine requests queued gets SIGTERM: every
  accepted request is answered (sooner than its batching window, so the
  drain flushed it), ``/healthcheck`` answers 503 while it drains, and it
  exits 0 (its own time limit: 120 s). In process, the JAX drain tests'
  assertions (``tests/serve/test_graceful_shutdown.py``,
  ``tests/serve/test_shutdown_threads.py``,
  ``tests/server/test_stream_routes.py::test_drain_and_stop_terminates_concurrent_subscribers``)
  held on the port.
- ``score``: a JAX-built detector crossed into the port
  (``DiffBasedAnomalyDetector.from_state``), both packages' ``score`` over
  one CSV: the same columns and index; ``model-output`` within rtol 1e-5,
  atol 1e-6, the anomaly columns after it within rtol 1e-5 and the
  forward's error carried through, as ``tests/test_torch_engine.py``
  holds them: ``atol = (1e-6 + 1e-5 * max |model-output|) * max(1,
  largest scale_ of the error scaler)``.
- ``wait-for-models``, ``cleanup-revisions`` and
  ``ensure-single-workflow``: the JAX commands' outputs and exit codes on
  the cases of ``tests/cli/test_cli.py``; a guard re-acquired between the
  stale check and the break is never disposed of.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import pandas as pd
import pytest
from click.testing import CliRunner
from werkzeug.test import Client

from gordo_tpu.cli.cli import cleanup_revisions as jax_cleanup_revisions
from gordo_tpu.cli.cli import ensure_single_workflow as jax_ensure_single_workflow
from gordo_tpu.cli.cli import score as jax_score
from gordo_tpu.cli.cli import wait_for_models as jax_wait_for_models
from gordo_tpu_torch.cli import deploy
from gordo_tpu_torch.cli.cli import main
from gordo_tpu_torch.serve.engine import ServeConfig
from gordo_tpu_torch.server import build_app
from gordo_tpu_torch.server.app import drain_and_stop, install_graceful_shutdown
from gordo_tpu_torch.telemetry import serving as serve_trace

from tests.test_torch_serving import PROJECT, TAGS, _frame, _sse, collections  # noqa: F401 - a fixture

RTOL, ATOL = 1e-5, 1e-6
SERVER_LIMIT_S = 120


def _free_port():
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _get(url, timeout=5.0):
    try:
        with urllib.request.urlopen(url, timeout=timeout) as response:
            return response.status, response.read()
    except urllib.error.HTTPError as exc:
        return exc.code, exc.read()


def _post_json(url, payload, timeout=60.0):
    request = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                     headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(request, timeout=timeout) as response:
        return response.status, json.loads(response.read())


# -- run-server and the drain ------------------------------------------------------------


def test_run_server_drains_queued_requests_on_sigterm(collections, tmp_path):  # noqa: F811
    _, port_dir = collections
    port = _free_port()
    env = {**os.environ, "MODEL_COLLECTION_DIR": port_dir, "GORDO_TPU_TELEMETRY_DIR": str(tmp_path),
           "PYTHONPATH": os.getcwd()}
    log = open(tmp_path / "server.log", "w+")
    proc = subprocess.Popen(
        [sys.executable, "-m", "gordo_tpu_torch", "run-server", "--device", "cpu", "--batching", "--host",
         "127.0.0.1", "--port", str(port), "--batch-max-size", "64", "--batch-max-delay-ms", "8000",
         "--no-serve-warmup", "--drain-grace-s", "3", "--log-level", "info", "--workers", "3"],
        env=env, stdout=log, stderr=subprocess.STDOUT)
    base = f"http://127.0.0.1:{port}"
    try:
        deadline = time.monotonic() + SERVER_LIMIT_S / 2
        while True:
            try:
                if _get(f"{base}/healthcheck", timeout=1.0)[0] == 200:
                    break
            except OSError:
                pass
            assert proc.poll() is None and time.monotonic() < deadline, (tmp_path / "server.log").read_text()
            time.sleep(0.2)
        X = _frame(TAGS["machine-1"], 12, seed=4)
        reference = Client(build_app(port_dir, device="cpu"))
        expected = json.loads(reference.post(f"/gordo/v0/{PROJECT}/machine-1/prediction", json={"X": X}).get_data())
        answers, spent = [None] * 4, [None] * 4

        def hit(i):
            sent = time.monotonic()
            answers[i] = _post_json(f"{base}/gordo/v0/{PROJECT}/machine-{1 + i % 3}/prediction", {"X": X})
            spent[i] = time.monotonic() - sent

        threads = [threading.Thread(target=hit, args=(i,)) for i in range(4)]
        for thread in threads:
            thread.start()
        time.sleep(1.0)  # the requests wait in the engine: its window is 8 s
        proc.send_signal(signal.SIGTERM)
        statuses = []
        while proc.poll() is None and not statuses:
            try:
                status, body = _get(f"{base}/healthcheck", timeout=1.0)
                if status == 503:
                    statuses.append(body)
            except OSError:
                break
            time.sleep(0.05)
        for thread in threads:
            thread.join(timeout=SERVER_LIMIT_S / 2)
        assert proc.wait(timeout=SERVER_LIMIT_S / 2) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.close()
    text = (tmp_path / "server.log").read_text()
    assert statuses == [b"draining"], text
    assert [status for status, _ in answers] == [200] * 4, text
    assert max(spent) < 7.0, spent  # answered by the drain, not by the batching window
    assert answers[0][1]["data"]["model-output"] == expected["data"]["model-output"]
    assert "--workers, --worker-connections, --threads, --worker-class, --server-app, --with-prometheus-config " \
           "are ignored" in text
    assert "drained in" in text and "kernel launches: K1 0, K2 0" in text


@pytest.fixture
def engine_app(collections):  # noqa: F811
    """The port's app with an engine whose flush window (5 s) is far past
    any thread start, so a drain lands mid-queue."""
    _, port_dir = collections
    app = build_app(port_dir, device="cpu",
                    serve_config=ServeConfig(max_size=64, max_delay_ms=5000.0, deadline_ms=60000.0))
    yield app
    app.engine.shutdown(drain=False)


def _prediction(app, name, X):
    response = Client(app).post(f"/gordo/v0/{PROJECT}/{name}/prediction", json={"X": X})
    return response.status_code, json.loads(response.get_data())


def test_drain_resolves_queued_batches_with_concurrent_clients(engine_app, monkeypatch):
    monkeypatch.setenv("GORDO_TPU_SERVE_WARMUP", "0")
    X = _frame(TAGS["machine-1"], 10, seed=6)
    statuses = [None] * 4

    def hit(i):
        statuses[i] = _prediction(engine_app, f"machine-{1 + i % 3}", X)[0]

    threads = [threading.Thread(target=hit, args=(i,)) for i in range(4)]
    for thread in threads:
        thread.start()
    deadline = time.monotonic() + 10.0
    while engine_app.engine._batcher.pending() < 4:
        assert time.monotonic() < deadline, engine_app.engine.stats()
        time.sleep(0.005)
    drain_and_stop(engine_app, server=None)
    for thread in threads:
        thread.join(timeout=30)
    assert statuses == [200, 200, 200, 200]
    assert engine_app.engine._batcher.pending() == 0
    # draining: the healthcheck answers 503, a request still scores (unbatched)
    response = Client(engine_app).get("/healthcheck")
    assert (response.status_code, response.get_data()) == (503, b"draining")
    status, body = _prediction(engine_app, "machine-1", X)
    assert status == 200 and "model-output" in body["data"]


def test_drain_without_engine_still_flips_healthcheck(collections):  # noqa: F811
    app = build_app(collections[1], device="cpu")
    assert Client(app).get("/healthcheck").status_code == 200
    drain_and_stop(app, server=None)
    assert Client(app).get("/healthcheck").status_code == 503


def test_install_graceful_shutdown_registers_sigterm(collections):  # noqa: F811
    app = build_app(collections[1], device="cpu")
    previous = signal.getsignal(signal.SIGTERM), signal.getsignal(signal.SIGINT)
    try:
        handler = install_graceful_shutdown(app, server=None)
        assert handler is not None
        assert signal.getsignal(signal.SIGTERM) is handler and signal.getsignal(signal.SIGINT) is handler
        handler(signal.SIGTERM, None)
        handler.thread.join(timeout=10)
        assert app.draining
    finally:
        signal.signal(signal.SIGTERM, previous[0])
        signal.signal(signal.SIGINT, previous[1])
    result = []
    thread = threading.Thread(target=lambda: result.append(install_graceful_shutdown(app)))
    thread.start()
    thread.join()
    assert result == [None]  # off the main thread: nothing installed


class _FakeServer:
    def __init__(self):
        self.shutdowns = 0
        self.joins = []

    def shutdown(self):
        self.shutdowns += 1

    def join_requests(self, timeout):
        self.joins.append(timeout)
        return 0


def test_drain_and_stop_leaves_zero_non_daemon_threads(collections, monkeypatch, tmp_path):  # noqa: F811
    monkeypatch.setenv("GORDO_TPU_TELEMETRY_DIR", str(tmp_path))
    monkeypatch.setenv("GORDO_TPU_TRACE_SAMPLE_RATE", "1")
    serve_trace.reset_serve_recorder()
    engine_app = build_app(collections[1], device="cpu", serve_config=ServeConfig())
    try:
        status, _ = _prediction(engine_app, "machine-1", _frame(TAGS["machine-1"], 8, seed=2))
        assert status == 200
        writer = serve_trace.serve_recorder()._writer
        assert writer is not None and writer.is_alive()
        server = _FakeServer()
        drain_and_stop(engine_app, server=server)
        assert server.shutdowns == 1 and len(server.joins) == 1
        assert not writer.is_alive()  # joined, not left behind
        leftovers = [t for t in threading.enumerate() if t.name.startswith("gordo-") and t.is_alive()]
        assert all(t.daemon for t in leftovers), leftovers
        assert [t for t in threading.enumerate()
                if t.is_alive() and not t.daemon and t is not threading.main_thread()] == []
    finally:
        serve_trace.reset_serve_recorder()


def test_drain_and_stop_terminates_concurrent_subscribers(collections, monkeypatch):  # noqa: F811
    monkeypatch.setenv("GORDO_TPU_STREAM_WINDOW_ROWS", "8")
    app = build_app(collections[1], device="cpu")
    url = f"/gordo/v0/{PROJECT}/stream"
    ingest = {"X": {"machine-1": _frame(TAGS["machine-1"], 4, seed=1)}}
    assert Client(app).post(f"{url}/s1/ingest", json=ingest).status_code == 200
    results = [None, None]

    def subscribe(i):
        response = Client(app).get(f"{url}/s1/events", buffered=False)
        results[i] = _sse(b"".join(part if isinstance(part, bytes) else part.encode()
                                   for part in response.response))

    threads = [threading.Thread(target=subscribe, args=(i,), daemon=True) for i in range(2)]
    for thread in threads:
        thread.start()
    deadline = time.monotonic() + 5.0
    while app.plane.session(PROJECT, "s1", create=False).subscribers < 2:
        assert time.monotonic() < deadline
        time.sleep(0.01)
    drain_and_stop(app, server=None)
    for thread in threads:
        thread.join(timeout=10)
    assert not any(thread.is_alive() for thread in threads)
    for frames in results:
        assert frames[-1][1] == "drain", frames
        assert frames[-1][2]["reason"] == "server draining"
    # the drained plane refuses new sessions (503 where the JAX route answers 429: ROADMAP.md, differences),
    # and a second drain does nothing
    assert Client(app).post(f"{url}/s2/ingest", json=ingest).status_code == 503
    assert app.plane.drain() == 0


def test_threaded_server_waits_for_answers_in_flight(collections):  # noqa: F811
    """A request still being answered when the accept loop stops is waited
    for, within the bound, before the drain returns."""
    from gordo_tpu_torch.server.app import make_wsgi_server

    started, release = threading.Event(), threading.Event()

    def slow_app(environ, start_response):
        started.set()
        release.wait(10)
        start_response("200 OK", [("Content-Type", "text/plain")])
        return [b"done"]

    server = make_wsgi_server(slow_app, "127.0.0.1", 0)
    loop = threading.Thread(target=server.serve_forever, daemon=True)
    loop.start()
    answer = []
    client = threading.Thread(target=lambda: answer.append(_get(f"http://127.0.0.1:{server.server_port}/x")))
    client.start()
    assert started.wait(10)
    server.shutdown()
    assert server.join_requests(0.2) == 1  # still answering: the bound is kept
    release.set()
    assert server.join_requests(10) == 0
    client.join(10)
    server.server_close()
    assert answer == [(200, b"done")]


# -- score -----------------------------------------------------------------------------


def _write_csv(path, tags, rows, seed):
    rng = np.random.RandomState(seed)
    index = pd.date_range("2020-03-01", periods=rows, freq="10min", tz="UTC")
    frame = pd.DataFrame(rng.rand(rows, len(tags)) * 2 - 0.5, columns=tags, index=index)
    frame.iloc[5, 0] = np.nan
    frame.to_csv(path)


def _same_scores(got, expected, scale):
    """The same columns and index; strings exact, the forward's columns
    within RTOL/ATOL, the anomaly columns within RTOL and the forward's
    error carried through (the module's docstring); ``scale`` is the
    error scaler's largest ``scale_``."""
    assert list(got.columns) == list(expected.columns)
    pd.testing.assert_index_equal(got.index, expected.index)
    outputs = [c for c in expected.columns if c.startswith("model-output|")]
    derived = (ATOL + RTOL * float(np.nanmax(np.abs(expected[outputs].to_numpy())))) * max(1.0, scale)
    for column in expected.columns:
        want, have = expected[column], got[column]
        if want.dtype.kind not in "fc":
            assert [None if pd.isna(v) else v for v in have] == [None if pd.isna(v) else v for v in want], column
            continue
        forward = column.startswith(("model-input|", "model-output|"))
        np.testing.assert_allclose(have, want, rtol=RTOL, atol=ATOL if forward else derived, err_msg=column)
    return bool(outputs)


def _error_scale(model_dir):
    from gordo_tpu_torch import serializer

    return float(np.max(serializer.load(model_dir, device="cpu").scaler.scale_))


@pytest.mark.parametrize("name,predict_only", [("machine-1", False), ("machine-2", False),
                                               ("machine-1", True), ("machine-3", False)],
                         ids=["detector", "smoothing-detector", "predict-only", "pipeline"])
def test_score_matches_jax(collections, tmp_path, capsys, name, predict_only):  # noqa: F811
    jax_dir, port_dir = collections
    csv_path = tmp_path / "window.csv"
    _write_csv(csv_path, TAGS[name], 40, seed=11)
    options = ["--input", str(csv_path)] + (["--predict-only"] if predict_only else [])
    jax_out, port_out = tmp_path / "jax.parquet", tmp_path / "port.parquet"
    result = CliRunner().invoke(jax_score, [os.path.join(jax_dir, name), str(jax_out), *options])
    assert result.exit_code == 0, result.output
    assert main(["score", os.path.join(port_dir, name), str(port_out), *options, "--device", "cpu"]) == 0
    assert capsys.readouterr().out.strip() == result.output.strip().replace(str(jax_out), str(port_out))
    expected, got = pd.read_parquet(jax_out), pd.read_parquet(port_out)
    if predict_only or name == "machine-3":
        assert list(got.columns) == ["0", "1", "2", "3"]
        np.testing.assert_allclose(got.to_numpy(), expected.to_numpy(), rtol=RTOL, atol=ATOL)
        pd.testing.assert_index_equal(got.index, expected.index)
    else:
        assert _same_scores(got, expected, _error_scale(os.path.join(port_dir, name)))
        assert any(c.startswith("smooth-") for c in got.columns) == (name == "machine-2")


def test_score_without_input_or_window_fails_as_jax(collections, tmp_path, capsys):  # noqa: F811
    jax_dir, port_dir = collections
    result = CliRunner().invoke(jax_score, [os.path.join(jax_dir, "machine-1"), str(tmp_path / "a.parquet")])
    code = main(["score", os.path.join(port_dir, "machine-1"), str(tmp_path / "b.parquet"), "--device", "cpu",
                 "--start", "2020-01-01T00:00:00+00:00"])
    assert (code, result.exit_code) == (1, 1)
    assert capsys.readouterr().err.strip() == result.output.strip() == "Error: Provide --input or both --start/--end"


def test_score_reads_the_machines_own_dataset(collections, tmp_path):  # noqa: F811
    """``--start``/``--end`` re-point the dataset of the model's metadata:
    the same rows as the JAX command's."""
    jax_dir, port_dir = collections
    window = ["--start", "2020-01-02T00:00:00+00:00", "--end", "2020-01-03T00:00:00+00:00"]
    result = CliRunner().invoke(jax_score, [os.path.join(jax_dir, "machine-1"), str(tmp_path / "jax.parquet"),
                                            *window])
    assert result.exit_code == 0, result.output
    assert main(["score", os.path.join(port_dir, "machine-1"), str(tmp_path / "port.parquet"), *window,
                 "--device", "cpu"]) == 0
    assert _same_scores(pd.read_parquet(tmp_path / "port.parquet"), pd.read_parquet(tmp_path / "jax.parquet"),
                        _error_scale(os.path.join(port_dir, "machine-1")))


# -- the host commands ---------------------------------------------------------------------


def _both(jax_command, args, port_args, capsys):
    """``(port code, port stdout+stderr, JAX code, JAX output)``."""
    result = CliRunner().invoke(jax_command, args)
    code = main(port_args)
    captured = capsys.readouterr()
    return code, captured.out + captured.err, result.exit_code, result.output


def _models(root, names):
    for name in names:
        (root / name).mkdir(parents=True)
        (root / name / "metadata.json").write_text("{}")


@pytest.mark.parametrize("case", ["present", "timeout", "env"])
def test_wait_for_models_matches_jax(tmp_path, capsys, monkeypatch, case):
    _models(tmp_path, ["w-a", "w-b"] if case == "present" else ["w-a"])
    options = {"present": ["--name", "w-a", "--name", "w-b", "--timeout", "5"],
               "timeout": ["--name", "w-a", "--name", "w-missing", "--timeout", "1", "--poll-interval", "1"],
               "env": ["--timeout", "5"]}[case]
    if case == "env":
        monkeypatch.setenv("EXPECTED_MODELS", '["w-a"]')
    code, out, jax_code, jax_out = _both(jax_wait_for_models, [str(tmp_path), *options],
                                         ["wait-for-models", str(tmp_path), *options], capsys)
    assert (code, out) == (jax_code, jax_out)
    assert code == (1 if case == "timeout" else 0)
    assert ("w-missing" in out) == (case == "timeout")


def test_wait_for_models_without_names_fails_as_jax(tmp_path, capsys, monkeypatch):
    monkeypatch.delenv("EXPECTED_MODELS", raising=False)
    code, out, jax_code, jax_out = _both(jax_wait_for_models, [str(tmp_path)], ["wait-for-models", str(tmp_path)],
                                         capsys)
    assert (code, out) == (jax_code, jax_out) == (1, "Error: No model names given (--name / EXPECTED_MODELS)\n")


@pytest.mark.parametrize("revisions,current,options,kept", [
    (["100", "200", "300", "400", "500", "register"], "200", ["--keep", "2"], ["200", "400", "500", "register"]),
    (["100", "200"], "200", ["--keep", "1", "--dry-run"], ["100", "200"]),
    (["999", "1000"], "1000", ["--keep", "1"], ["1000"]),
], ids=["keeps-newest-and-current", "dry-run", "numeric-order"])
def test_cleanup_revisions_matches_jax(tmp_path, capsys, revisions, current, options, kept):
    roots = tmp_path / "jax", tmp_path / "port"
    for root in roots:
        for revision in revisions:
            (root / revision).mkdir(parents=True)
    code, out, jax_code, jax_out = _both(jax_cleanup_revisions, [str(roots[0]), current, *options],
                                         ["cleanup-revisions", str(roots[1]), current, *options], capsys)
    assert (code, jax_code) == (0, 0)
    assert out == jax_out.replace(str(roots[0]), str(roots[1]))
    assert sorted(p.name for p in roots[1].iterdir()) == sorted(p.name for p in roots[0].iterdir()) == kept


def test_cleanup_revisions_fails_when_a_delete_fails(tmp_path, capsys, monkeypatch):
    for revision in ("1", "2", "3"):
        (tmp_path / revision).mkdir()

    def refuse(path, *args, **kwargs):
        raise PermissionError(f"read-only: {path}")

    monkeypatch.setattr(deploy.shutil, "rmtree", refuse)
    assert main(["cleanup-revisions", str(tmp_path), "3", "--keep", "1"]) == 1
    captured = capsys.readouterr()
    assert "Revisions: 1 kept, 0 deleted" in captured.out
    assert captured.err.strip() == "Error: Failed to delete 2 revision(s): 1, 2"
    assert main(["cleanup-revisions", str(tmp_path / "nope"), "3"]) == 1
    assert capsys.readouterr().err.strip() == f"Error: No such models root: {tmp_path / 'nope'}"


LOCK_CASES = {
    "fresh": [("1600000000000",)],
    "idempotent": [("1600000000000",), ("1600000000000",)],
    "newer-takes-over": [("1600000000000",), ("1600000000001",)],
    "stale": [("1600000000001",), ("1600000000000",)],
    "check-only": [("1600000000000", "--check-only")],
    "check-only-stale": [("1600000000005",), ("1600000000004", "--check-only")],
    "non-numeric": [("not-a-revision",)],
}


@pytest.mark.parametrize("case", list(LOCK_CASES))
def test_ensure_single_workflow_matches_jax(tmp_path, capsys, case):
    roots = tmp_path / "jax", tmp_path / "port"
    for step in LOCK_CASES[case]:
        code, out, jax_code, jax_out = _both(jax_ensure_single_workflow, [str(roots[0]), *step],
                                             ["ensure-single-workflow", str(roots[1]), *step], capsys)
        assert code == jax_code
        assert out == jax_out.replace(str(roots[0]), str(roots[1]))
    locks = [json.loads((root / "deploy.lock").read_text())["revision"] if (root / "deploy.lock").exists()
             else None for root in roots]
    assert locks[0] == locks[1]
    assert roots[1].exists() == roots[0].exists()
    if roots[1].exists():
        assert [p.name for p in roots[1].iterdir() if p.name.startswith(".deploy.guard")] == []


def test_corrupt_lock_is_overwritten(tmp_path, capsys):
    (tmp_path / "deploy.lock").write_text("{not json")
    assert main(["ensure-single-workflow", str(tmp_path), "1600000000000"]) == 0
    assert json.loads((tmp_path / "deploy.lock").read_text())["revision"] == "1600000000000"


def test_a_stale_guard_is_broken(tmp_path, capsys):
    guard = tmp_path / ".deploy.guard"
    (guard / "owner-1-dead").mkdir(parents=True)
    old = time.time() - 3600
    os.utime(guard / "owner-1-dead", (old, old))
    assert main(["ensure-single-workflow", str(tmp_path), "1600000000000"]) == 0
    assert not guard.exists()
    assert json.loads((tmp_path / "deploy.lock").read_text())["revision"] == "1600000000000"


def test_a_guard_reacquired_between_the_stat_and_the_rename_is_kept(tmp_path, capsys, monkeypatch):
    """The JAX command's stale-break race (``ADVICE.md``): while this
    deploy stats a stale guard, another waiter breaks it and acquires a
    fresh one. The break that follows must not touch the fresh guard; this
    deploy then waits until that holder releases it."""
    guard = tmp_path / ".deploy.guard"
    (guard / "owner-1-dead").mkdir(parents=True)
    old = time.time() - 3600
    os.utime(guard / "owner-1-dead", (old, old))
    real_stat, real_rename = os.stat, os.rename
    renames, state = [], {"swapped": False}

    def stat(path, *args, **kwargs):
        result = real_stat(path, *args, **kwargs)
        if str(path).endswith("owner-1-dead") and not state["swapped"]:
            # another waiter breaks the stale guard and acquires its own, right after this stat
            state["swapped"] = True
            os.rmdir(guard / "owner-1-dead")
            os.rmdir(guard)
            (tmp_path / "staging" / "owner-2-live").mkdir(parents=True)
            real_rename(tmp_path / "staging", guard)
        return result

    def rename(src, dst, *args, **kwargs):
        renames.append((str(src), str(dst)))
        try:
            return real_rename(src, dst, *args, **kwargs)
        finally:
            if str(src).endswith("owner-1-dead"):
                # the break failed: the fresh guard stands, untouched; its holder then releases it
                assert (guard / "owner-2-live").is_dir()
                os.rmdir(guard / "owner-2-live")
                os.rmdir(guard)

    monkeypatch.setattr(deploy.os, "stat", stat)
    monkeypatch.setattr(deploy.os, "rename", rename)
    assert main(["ensure-single-workflow", str(tmp_path), "1600000000000"]) == 0
    assert state["swapped"]
    assert not any("owner-2-live" in src for src, _ in renames)
    assert not guard.exists()
