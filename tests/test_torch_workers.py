"""``run-server``'s worker processes on the CPU, against the JAX package.

- **Files in both directions.** The port's app observes requests in two
  forked processes; the JAX package's ``multiprocess_registry()``
  (``prometheus_client``'s collector) reads their files and gives the same
  samples as the port's own fan-in. Files that the JAX package's metrics
  write in two processes read back equal through the port's collector.
  Each gauge mode merges as ``prometheus_client`` merges it, and
  ``mark_process_dead`` removes a dead pid's live gauges only.
- **Worker sinks.** ``worker_sinks_enabled``, ``worker_sink_path``, the
  serving trace's path and a ledger's snapshot path equal the JAX
  package's across the environment combinations of
  ``tests/telemetry/test_worker_sinks.py``.
- **Post-fork resets.** After ``run_postfork_resets()`` the recorder, the
  ledgers, the launch counters, the loaded libraries, the live apps and
  the process registry are fresh; every reset JAX registers has its
  counterpart.
- **A real pre-fork server.** ``run-server --device cpu --workers 2
  --threads 2 --port 0`` over the serving tests' collection: its anomaly
  answers equal the one-process port app's to the bit and the JAX app's
  within rtol 1e-5, atol 1e-6; two pids answer; the master's ``/metrics``
  counts every request; a SIGKILLed worker is replaced; SIGTERM drains
  every worker and exits 0.
  A boot that cannot succeed (``--device cuda`` here, a collection that
  is not a directory) exits non-zero and leaves no worker.

The forked children and the server's workers run torch on one intra-op
thread; every wait carries its own bound.
"""

import json
import os
import re
import signal
import subprocess
import sys
import threading
import time
import urllib.request

import prometheus_client
import pytest
import torch
from prometheus_client import multiprocess as jax_multiprocess
from prometheus_client.mmap_dict import MmapedDict as JaxMmapedDict
from prometheus_client.mmap_dict import mmap_key as jax_mmap_key
from werkzeug.test import Client

from gordo_tpu.server.prometheus import metrics as jax_metrics
from gordo_tpu.telemetry import fleet_health as jax_fleet_health
from gordo_tpu.telemetry import recorder as jax_recorder
from gordo_tpu.telemetry import serving as jax_serving
from gordo_tpu.utils import postfork as jax_postfork
from gordo_tpu_torch.ops import _build
from gordo_tpu_torch.ops import fleet_dense
from gordo_tpu_torch.server import app as port_app
from gordo_tpu_torch.server import build_app
from gordo_tpu_torch.server.app import ThreadingWSGIServer, serve_socket
from gordo_tpu_torch.server.prefork import bind_socket
from gordo_tpu_torch.server.prometheus import metrics as port_metrics
from gordo_tpu_torch.server.prometheus import multiprocess
from gordo_tpu_torch.server.prometheus import registry as port_registry
from gordo_tpu_torch.telemetry import fleet_health, recorder
from gordo_tpu_torch.telemetry import serving as serve_trace
from gordo_tpu_torch.utils import postfork

from tests.test_torch_prometheus import families
from tests.test_torch_serving import PROJECT, RTOL, ATOL, TAGS, _frame, clients, collections  # noqa: F401 - fixtures

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the bound on every wait for a child process or the server
LIMIT_S = 120
MULTIPROC = ("PROMETHEUS_MULTIPROC_DIR", "prometheus_multiproc_dir")


@pytest.fixture
def no_multiproc(monkeypatch):
    for name in (*MULTIPROC, "GORDO_TPU_WORKER_SINKS"):
        monkeypatch.delenv(name, raising=False)
    return monkeypatch


def _samples(collected):
    """``{family: {(sample, labels): value}}`` of a collector's families."""
    return {m.name: {(s.name, tuple(sorted(s.labels.items()))): s.value for s in m.samples} for m in collected}


def _text_samples(text, names):
    """``{family: sorted samples}`` of an exposition's families in ``names``."""
    return {name: sorted(samples, key=repr) for name, _, _, samples in families(text) if name in names}


def _wait_children(pids):
    """Each child's exit code, waiting at most LIMIT_S in all (a child still
    running then is killed and counts as failed)."""
    deadline, codes = time.monotonic() + LIMIT_S, {}
    while len(codes) < len(pids) and time.monotonic() < deadline:
        for pid in pids:
            if pid not in codes:
                done, status = os.waitpid(pid, os.WNOHANG)
                if done:
                    codes[pid] = os.waitstatus_to_exitcode(status)
        time.sleep(0.05)
    for pid in pids:
        if pid not in codes:
            os.kill(pid, signal.SIGKILL)
            os.waitpid(pid, 0)
            codes[pid] = -9
    return codes


# -- the files, both directions -----------------------------------------------------------------


def _observe_in_child(port_dir, paths, X):
    """The child's side: the port's app on the CPU, one intra-op thread,
    the requests of ``paths`` (POSTs carry ``X``); exits 0 when every
    answer was 200."""
    code = 1
    try:
        torch.set_num_threads(1)
        client = Client(build_app(port_dir, device="cpu"))
        ok = True
        for method, path in paths:
            if method == "POST":
                response = client.post(path, json={"X": X, "y": X} if "anomaly" in path else {"X": X})
            else:
                response = client.get(path)
            ok = ok and response.status_code == 200
        code = 0 if ok else 2
    finally:
        os._exit(code)


def test_port_files_read_through_the_jax_fan_in(collections, no_multiproc, tmp_path):  # noqa: F811
    _, port_dir = collections
    directory = tmp_path / "mp"
    no_multiproc.setenv("PROMETHEUS_MULTIPROC_DIR", str(directory))
    no_multiproc.setenv("ENABLE_PROMETHEUS", "true")
    no_multiproc.setenv("GORDO_TPU_TELEMETRY", "0")
    no_multiproc.setenv("GORDO_TPU_SERVE_WARMUP", "0")
    no_multiproc.delenv("GORDO_TPU_BATCHING", raising=False)
    X = _frame(TAGS["machine-1"], 12, seed=3)
    base = f"/gordo/v0/{PROJECT}"
    work = [
        [("POST", f"{base}/machine-1/anomaly/prediction"), ("GET", f"{base}/machine-1/metadata"),
         ("GET", f"{base}/models")],
        [("POST", f"{base}/machine-1/anomaly/prediction"), ("POST", f"{base}/machine-1/prediction"),
         ("GET", f"{base}/machine-2/metadata")],
    ]
    os.makedirs(directory)
    pids = []
    for paths in work:
        pid = os.fork()
        if pid == 0:
            _observe_in_child(port_dir, paths, X)
        pids.append(pid)
    codes = _wait_children(pids)
    assert codes == {pid: 0 for pid in pids}
    assert {f"counter_{pid}.db" for pid in pids} <= set(os.listdir(directory))

    ours = _samples(multiprocess.MultiProcessCollector(None, str(directory)).collect())
    assert sum(ours["gordo_server_requests"].values()) == sum(map(len, work))
    # the JAX package's fan-in: prometheus_client's collector beside the JAX scrape-time collectors
    jax_text = prometheus_client.generate_latest(jax_metrics.multiprocess_registry()).decode()
    port_text = port_registry.generate_latest(port_metrics.multiprocess_registry()).decode()
    names = set(ours)
    assert names >= {"gordo_server_requests", "gordo_server_request_duration_seconds",
                     "gordo_server_stage_duration_seconds", "gordo_server_info"}
    assert _text_samples(jax_text, names) == _text_samples(port_text, names)
    # and prometheus_client's collector alone against the port's
    theirs = _samples(jax_multiprocess.MultiProcessCollector(None, path=str(directory)).collect())
    assert theirs == ours


_JAX_WRITER = """
import sys, types
from prometheus_client import CollectorRegistry
from gordo_tpu.server.prometheus import metrics as m
registry = CollectorRegistry()
app = m.GordoServerPrometheusMetrics(project="p", registry=registry)
serve = m.ServeMetrics(project="p", registry=registry)
n = int(sys.argv[1])
for i in range(n):
    request = types.SimpleNamespace(method="POST", path=f"/gordo/v0/p/machine-{i % 2}/anomaly/prediction")
    response = types.SimpleNamespace(status_code=200 if i % 3 else 500, gordo_endpoint="anomaly",
                                     gordo_stage_durations={"inference": 0.002 * i, "serialize": 0.01})
    app.observe(request, response, 0.05 * i)
serve.observe_batch(size=n, occupancy=0.5, padding_waste=0.25)
serve.set_queue_depth(n)
serve.set_breaker_open(n % 2)
"""


def test_jax_files_read_back_through_the_port(no_multiproc, tmp_path):
    directory = tmp_path / "mp"
    os.makedirs(directory)
    env = {**os.environ, "PROMETHEUS_MULTIPROC_DIR": str(directory), "JAX_PLATFORMS": "cpu", "PYTHONPATH": REPO}
    procs = [subprocess.Popen([sys.executable, "-c", _JAX_WRITER, str(n)], env=env, stdout=subprocess.DEVNULL,
                              stderr=subprocess.PIPE, text=True) for n in (4, 7)]
    for proc in procs:
        _, err = proc.communicate(timeout=LIMIT_S)
        assert proc.returncode == 0, err
    files = sorted(os.listdir(directory))
    assert [f.split("_")[0] for f in files].count("counter") == 2 and any(f.startswith("gauge_max_") for f in files)
    theirs = _samples(jax_multiprocess.MultiProcessCollector(None, path=str(directory)).collect())
    ours = _samples(multiprocess.MultiProcessCollector(None, str(directory)).collect())
    assert ours == theirs
    assert sum(ours["gordo_server_requests"].values()) == 11
    assert ours["gordo_server_batch_queue_depth"] == {("gordo_server_batch_queue_depth", (("project", "p"),)): 7.0}
    # and the texts, the port's exposition against prometheus_client's
    their_registry = prometheus_client.CollectorRegistry()
    jax_multiprocess.MultiProcessCollector(their_registry, path=str(directory))
    our_registry = port_registry.CollectorRegistry()
    multiprocess.MultiProcessCollector(our_registry, str(directory))
    names = set(ours)
    assert _text_samples(prometheus_client.generate_latest(their_registry).decode(), names) == _text_samples(
        port_registry.generate_latest(our_registry).decode(), names)


@pytest.mark.parametrize("mode", multiprocess.GAUGE_MODES)
def test_gauge_modes_merge_as_prometheus_client(mode, tmp_path):
    """Two processes' files of one gauge in ``mode`` (written with
    ``prometheus_client``'s own ``MmapedDict``), beside a counter and a
    histogram, merged by both collectors; then ``mark_process_dead``."""
    for pid, value, stamp in ((101, 3.0, 20.0), (202, 5.0, 10.0)):
        gauge = JaxMmapedDict(str(tmp_path / f"gauge_{mode}_{pid}.db"))
        gauge.write_value(jax_mmap_key("g", "g", ["k"], ["a"], "a gauge"), value, stamp)
        gauge.write_value(jax_mmap_key("g", "g", ["k"], ["b"], "a gauge"), -value, stamp)
        gauge.close()
        counter = JaxMmapedDict(str(tmp_path / f"counter_{pid}.db"))
        counter.write_value(jax_mmap_key("c", "c_total", ["k"], ["a"], "a counter"), value, 0.0)
        counter.close()
        histogram = JaxMmapedDict(str(tmp_path / f"histogram_{pid}.db"))
        histogram.write_value(jax_mmap_key("h", "h_sum", [], [], "a histogram"), value, 0.0)
        for bound, count in (("0.5", 1.0), ("1.0", value), ("+Inf", 2.0)):
            histogram.write_value(jax_mmap_key("h", "h_bucket", ["le"], [bound], "a histogram"), count, 0.0)
        histogram.close()
    theirs = _samples(jax_multiprocess.MultiProcessCollector(None, path=str(tmp_path)).collect())
    ours = _samples(multiprocess.MultiProcessCollector(None, str(tmp_path)).collect())
    assert ours == theirs
    removed = multiprocess.mark_process_dead(101, str(tmp_path))
    jax_left = sorted(os.listdir(tmp_path))
    assert removed == ([str(tmp_path / f"gauge_{mode}_101.db")] if mode.startswith("live") else [])
    assert ("counter_101.db" in jax_left) and ("histogram_101.db" in jax_left)
    assert _samples(multiprocess.MultiProcessCollector(None, str(tmp_path)).collect()) == _samples(
        jax_multiprocess.MultiProcessCollector(None, path=str(tmp_path)).collect())


def test_port_values_write_prometheus_client_files(no_multiproc, tmp_path):
    """The port's counters, gauges and histograms in the directory: one
    file a kind, read entry for entry by ``prometheus_client``'s
    ``MmapedDict``; a value that outgrows the first 64 KiB map still reads."""
    no_multiproc.setenv("PROMETHEUS_MULTIPROC_DIR", str(tmp_path))
    registry = port_registry.CollectorRegistry()
    counter = port_registry.Counter("c_total", "a counter", ["k"], registry=registry)
    gauge = port_registry.Gauge("g", "a gauge", ["k"], registry=registry, multiprocess_mode="max")
    histogram = port_registry.Histogram("h", "a histogram", ["k"], registry=registry, buckets=(0.5, 1.0))
    for i in range(1500):  # past the first map of the counter's file
        counter.labels(k=f"key-{i}").inc(i)
    gauge.labels(k="a").set(2.5)
    for amount in (0.25, 0.75, 4.0, float("nan")):
        histogram.labels(k="a").observe(amount)
    pid = os.getpid()
    assert sorted(os.listdir(tmp_path)) == [f"counter_{pid}.db", f"gauge_max_{pid}.db", f"histogram_{pid}.db"]
    read = {key: value for key, value, _ in JaxMmapedDict(str(tmp_path / f"counter_{pid}.db"),
                                                          read_mode=True).read_all_values()}
    assert read[jax_mmap_key("c", "c_total", ["k"], ["key-1499"], "a counter")] == 1499.0
    assert len(read) == 1500
    histogram_values = {json.loads(k)[1:3].__repr__(): v for k, v, _ in JaxMmapedDict(
        str(tmp_path / f"histogram_{pid}.db"), read_mode=True).read_all_values()}
    assert histogram_values[repr(["h_bucket", {"k": "a", "le": "1.0"}])] == 1.0
    assert histogram_values[repr(["h_bucket", {"k": "a", "le": "+Inf"}])] == 1.0
    # the child's own samples read its file
    assert port_registry.generate_latest(registry).decode().count('h_bucket{k="a",le="+Inf"} 3.0') == 1


# -- worker sinks ------------------------------------------------------------------------------

SINK_ENVS = [
    {},
    {"PROMETHEUS_MULTIPROC_DIR": "{mp}"},
    {"prometheus_multiproc_dir": "{mp}"},
    {"PROMETHEUS_MULTIPROC_DIR": "{mp}", "GORDO_TPU_WORKER_SINKS": "0"},
    {"GORDO_TPU_WORKER_SINKS": "1"},
    {"GORDO_TPU_WORKER_SINKS": "off", "prometheus_multiproc_dir": "{mp}"},
    {"GORDO_TPU_WORKER_SINKS": "maybe", "PROMETHEUS_MULTIPROC_DIR": "{mp}"},
]


@pytest.mark.parametrize("env", SINK_ENVS, ids=lambda env: ",".join(f"{k}={v}" for k, v in env.items()) or "none")
def test_worker_sinks_equal_the_jax_switch(env, no_multiproc, tmp_path):
    for name, value in env.items():
        no_multiproc.setenv(name, value.format(mp=tmp_path / "mp"))
    no_multiproc.setenv("GORDO_TPU_TELEMETRY_DIR", str(tmp_path / "telemetry"))
    no_multiproc.delenv("GORDO_TPU_TELEMETRY", raising=False)
    assert recorder.worker_sinks_enabled() == jax_recorder.worker_sinks_enabled()
    for path in ("/x/serve_trace.jsonl", "/x/fleet_health.json", "/x/fleet_health.d"):
        assert recorder.worker_sink_path(path) == jax_recorder.worker_sink_path(path)
    assert serve_trace.serve_trace_path() == jax_serving.serve_trace_path()
    assert fleet_health.FleetHealthLedger(directory=str(tmp_path)).path == \
        jax_fleet_health.FleetHealthLedger(directory=str(tmp_path)).path
    suffixed = recorder.worker_sinks_enabled()
    assert serve_trace.serve_trace_path().endswith(f"serve_trace-{os.getpid()}.jsonl" if suffixed
                                                   else "serve_trace.jsonl")


# -- post-fork resets ------------------------------------------------------------------------


def test_postfork_resets_leave_fresh_state(collections, no_multiproc, tmp_path):  # noqa: F811
    _, port_dir = collections
    no_multiproc.setenv("GORDO_TPU_TELEMETRY_DIR", str(tmp_path))
    no_multiproc.delenv("GORDO_TPU_TELEMETRY", raising=False)
    serve_trace.reset_serve_recorder()
    inherited_recorder = serve_trace.serve_recorder()
    assert inherited_recorder.enabled
    ledger = fleet_health.serving_ledger(str(tmp_path / "served"))
    assert fleet_health.live_serving_ledger(str(tmp_path / "served")) is ledger
    app = build_app(port_dir, device="cpu")
    assert app in port_app.live_apps()
    fleet_dense.fleet_feedforward.launches, fleet_dense.fleet_anomaly_scores.launches = 5, 2
    fleet_dense.fleet_feedforward.shapes[(1, 2, 3)] += 1
    _build._loaded["inherited"] = object()
    port_registry.Counter("inherited_total", "from the parent", registry=port_registry.REGISTRY)
    saved = (fleet_dense.fleet_feedforward.launches, fleet_dense.fleet_anomaly_scores.launches,
             dict(fleet_dense.fleet_feedforward.shapes), dict(_build._loaded))
    try:
        postfork.run_postfork_resets()
        assert serve_trace._recorder is None
        assert fleet_health._serving_ledgers == {} and fleet_health._made_ledgers == {}
        assert fleet_health.live_serving_ledger(str(tmp_path / "served")) is None
        assert fleet_dense.fleet_feedforward.launches == fleet_dense.fleet_anomaly_scores.launches == 0
        assert not fleet_dense.fleet_feedforward.shapes
        assert _build._loaded == {}
        assert port_app.live_apps() == []
        assert list(port_registry.REGISTRY.collect()) == []
        # the metric objects are made anew on the emptied registry
        assert port_metrics.fleet_build_metrics()["phase_duration"] is not None
        # a ledger from another pid (a fork without the reset) is made again
        mine = fleet_health.serving_ledger(str(tmp_path / "served"))
        mine._pid = -1
        assert fleet_health.serving_ledger(str(tmp_path / "served")) is not mine
    finally:
        inherited_recorder.close()
        serve_trace.reset_serve_recorder()
        fleet_health.reset_ledgers()
        fleet_dense.fleet_feedforward.launches, fleet_dense.fleet_anomaly_scores.launches = saved[:2]
        fleet_dense.fleet_feedforward.shapes.update(saved[2])
        _build._loaded.update({k: v for k, v in saved[3].items() if k != "inherited"})
    # every reset JAX registers has its counterpart, by name
    assert set(jax_postfork.registered_resets()) <= set(postfork.registered_resets())
    assert {"ops.fleet_dense.launches", "ops._build.loaded", "server.app.live_apps",
            "server.prometheus.metrics.caches"} <= set(postfork.registered_resets())


# -- the worker's thread cap -------------------------------------------------------------------


def test_a_worker_answers_at_most_its_threads_at_once():
    """``serve_socket(max_threads=1)``: while one request holds the only
    thread, the next waits; it is answered once the first is released."""
    release, entered = threading.Event(), []

    def app(environ, start_response):
        entered.append(environ["PATH_INFO"])
        if environ["PATH_INFO"] == "/hold":
            release.wait(LIMIT_S)
        start_response("200 OK", [("Content-Length", "2")])
        return [b"ok"]

    sock = bind_socket("127.0.0.1", 0)
    server = serve_socket(app, sock, max_threads=1)
    assert isinstance(server, ThreadingWSGIServer)
    loop = threading.Thread(target=server.serve_forever, daemon=True)
    loop.start()
    base = f"http://127.0.0.1:{sock.getsockname()[1]}"
    answers = {}

    def get(path):
        with urllib.request.urlopen(base + path, timeout=LIMIT_S) as response:
            answers[path] = response.read()

    try:
        held = threading.Thread(target=get, args=("/hold",))
        held.start()
        deadline = time.monotonic() + LIMIT_S
        while entered != ["/hold"]:
            assert time.monotonic() < deadline
            time.sleep(0.01)
        waiting = threading.Thread(target=get, args=("/next",))
        waiting.start()
        time.sleep(0.5)
        assert entered == ["/hold"] and "/next" not in answers
        release.set()
        for thread in (held, waiting):
            thread.join(LIMIT_S)
        assert answers == {"/hold": b"ok", "/next": b"ok"} and entered == ["/hold", "/next"]
    finally:
        release.set()
        server.shutdown()
        server.server_close()


# -- a real pre-fork server on the CPU -----------------------------------------------------------


class _Server:
    """``python -m gordo_tpu_torch run-server`` in a process of its own,
    its log in a file."""

    def __init__(self, tmp_path, args, env):
        self.log_path = tmp_path / "server.log"
        self.log = open(self.log_path, "w+")
        self.proc = subprocess.Popen([sys.executable, "-m", "gordo_tpu_torch", "run-server", *args],
                                     env=env, stdout=self.log, stderr=subprocess.STDOUT)

    def text(self):
        return self.log_path.read_text()

    def wait_for(self, pattern, count=1):
        """The matches of ``pattern`` once the log holds ``count`` of them."""
        deadline = time.monotonic() + LIMIT_S
        while True:
            found = re.findall(pattern, self.text())
            if len(found) >= count:
                return found
            assert self.proc.poll() is None and time.monotonic() < deadline, self.text()[-4000:]
            time.sleep(0.1)

    def stop(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        self.log.close()


def _server_env(port_dir, tmp_path, **extra):
    env = {k: v for k, v in os.environ.items() if k not in MULTIPROC and not k.startswith("GORDO_TPU_BATCH")}
    env.update(MODEL_COLLECTION_DIR=port_dir, PYTHONPATH=REPO, OMP_NUM_THREADS="1", PROJECT=PROJECT,
               GORDO_TPU_TELEMETRY_DIR=str(tmp_path / "telemetry"), GORDO_TPU_TRACE_SAMPLE_RATE="1.0", **extra)
    return env


def _post(url, payload):
    request = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                     headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(request, timeout=LIMIT_S) as response:
        return response.status, response.read()


def _alive(pid):
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    return True


def _trace_pids(directory):
    """The pids whose worker sinks hold request spans."""
    pids = set()
    for name in os.listdir(directory) if os.path.isdir(directory) else ():
        found = re.fullmatch(r"serve_trace-(\d+)\.jsonl", name)
        if found and '"name": "request"' in (directory / name).read_text():
            pids.add(int(found.group(1)))
    return pids


def _timeless(body):
    """An answer without its ``time-seconds``, the one wall-clock number in it."""
    answer = json.loads(body)
    answer.pop("time-seconds")
    return answer


def _close(value, expected):
    if isinstance(expected, dict):
        return list(value) == list(expected) and all(_close(value[k], expected[k]) for k in expected)
    if isinstance(expected, list):
        return len(value) == len(expected) and all(_close(v, e) for v, e in zip(value, expected))
    if isinstance(expected, float) and isinstance(value, float):
        return abs(value - expected) <= ATOL + RTOL * abs(expected)
    return value == expected


def test_prefork_server_on_the_cpu(collections, clients, tmp_path):  # noqa: F811
    _, port_dir = collections
    jax_client = clients[0]
    env = _server_env(port_dir, tmp_path, ENABLE_PROMETHEUS="true",
                      PROMETHEUS_MULTIPROC_DIR=str(tmp_path / "mp"))
    server = _Server(tmp_path, ["--device", "cpu", "--workers", "2", "--threads", "2", "--port", "0", "--host",
                                "127.0.0.1", "--metrics-port", "0", "--with-prometheus-config", "--log-level", "info"],
                     env)
    try:
        port = int(server.wait_for(r"listening on http://127\.0\.0\.1:(\d+)")[0])
        metrics_port = int(server.wait_for(r"Prometheus metrics on http://127\.0\.0\.1:(\d+)")[0])
        booted = server.wait_for(r"worker \d+ booted \(pid (\d+)\)", 2)
        workers = {int(pid) for pid in booted}
        master = server.proc.pid
        assert master not in workers and len(workers) == 2
        base = f"http://127.0.0.1:{port}/gordo/v0/{PROJECT}"
        frames = {name: _frame(TAGS[name], 14, seed=11 + i) for i, name in enumerate(("machine-1", "machine-2"))}
        previous = torch.get_num_threads()
        torch.set_num_threads(1)  # the workers' intra-op threads, for answers equal to the bit
        try:
            one_process = Client(build_app(port_dir, device="cpu"))
            expected = {name: _timeless(one_process.post(f"/gordo/v0/{PROJECT}/{name}/anomaly/prediction",
                                                         json={"X": X, "y": X}).get_data())
                        for name, X in frames.items()}
        finally:
            torch.set_num_threads(previous)
        jax_expected = {name: json.loads(jax_client.post(f"/gordo/v0/{PROJECT}/{name}/anomaly/prediction",
                                                         json={"X": X, "y": X}).get_data())
                        for name, X in frames.items()}
        sent, answers, deadline = 0, [], time.monotonic() + LIMIT_S
        while _trace_pids(tmp_path / "telemetry") != workers:
            assert time.monotonic() < deadline, (_trace_pids(tmp_path / "telemetry"), workers)
            names = [("machine-1", "machine-2")[i % 2] for i in range(8)]
            results = [None] * len(names)

            def hit(i):
                results[i] = _post(f"{base}/{names[i]}/anomaly/prediction",
                                   {"X": frames[names[i]], "y": frames[names[i]]})

            threads = [threading.Thread(target=hit, args=(i,)) for i in range(len(names))]
            for thread in threads:
                thread.start()
            for thread in threads:
                thread.join(LIMIT_S)
            sent += len(names)
            answers += list(zip(names, results))
            time.sleep(1.5)  # the sinks' writer polls every 50 ms, idles up to 1 s
        for name, (status, body) in answers:
            assert status == 200
            assert _timeless(body) == expected[name]  # the one-process app's answer, to the bit
            assert _close(json.loads(body)["data"], jax_expected[name]["data"])
        with urllib.request.urlopen(f"http://127.0.0.1:{metrics_port}/metrics", timeout=LIMIT_S) as response:
            text = response.read().decode()
        counted = sum(value for name, _, _, samples in families(text) if name == "gordo_server_requests"
                      for sample, _, value in samples if sample == "gordo_server_requests_total")
        assert counted == sent

        victim = sorted(workers)[0]
        os.kill(victim, signal.SIGKILL)
        server.wait_for(rf"worker \d+ \(pid {victim}\) exited -9 after [0-9.]+ s: forking a replacement")
        replacement = {int(p) for p in server.wait_for(r"worker \d+ booted \(pid (\d+)\)", 3)} - workers
        assert len(replacement) == 1 and not _alive(victim)
        for name, X in frames.items():
            status, body = _post(f"{base}/{name}/anomaly/prediction", {"X": X, "y": X})
            assert status == 200 and _timeless(body) == expected[name]
        sent += len(frames)
        assert not [f for f in os.listdir(tmp_path / "mp") if f.startswith("gauge_live") and f"_{victim}." in f]
        with urllib.request.urlopen(f"http://127.0.0.1:{metrics_port}/metrics", timeout=LIMIT_S) as response:
            text = response.read().decode()
        assert sum(value for name, _, _, samples in families(text) if name == "gordo_server_requests"
                   for _, _, value in samples) == sent  # the dead worker's counts stay counted

        server.proc.send_signal(signal.SIGTERM)
        assert server.proc.wait(timeout=LIMIT_S) == 0
        text = server.text()
        drained = re.findall(r"kernel launches: K1 (\d+), K2 (\d+) \(pid (\d+)\)", text)
        assert {int(pid) for _, _, pid in drained} == (workers - {victim}) | replacement
        assert "all workers stopped: exit 0" in text
        assert not any(_alive(pid) for pid in workers | replacement)
    finally:
        server.stop()


@pytest.mark.parametrize("case", ["cuda-without-a-card", "not-a-collection"])
def test_a_boot_that_cannot_succeed_exits_nonzero(case, collections, tmp_path):  # noqa: F811
    _, port_dir = collections
    if case == "cuda-without-a-card":
        if torch.cuda.is_available():
            pytest.skip("this machine has a card")
        args, env = ["--device", "cuda"], _server_env(port_dir, tmp_path)
    else:
        args, env = ["--device", "cpu"], _server_env(str(tmp_path / "absent"), tmp_path)
    server = _Server(tmp_path, [*args, "--workers", "2", "--port", "0", "--host", "127.0.0.1", "--log-level",
                                "info"], env)
    try:
        code = server.proc.wait(timeout=LIMIT_S)
        text = server.text()
        assert code != 0, text
        forked = [int(pid) for pid in re.findall(r"worker \d+ forked: pid (\d+)", text)]
        assert not any(_alive(pid) for pid in forked)
        if case == "not-a-collection":
            assert code == 3 and forked and "failed to boot" in text
    finally:
        server.stop()
