"""The port's serving engine against the JAX engine, end to end on the CPU.

One collection is built with the JAX package's ``local_build``: a 20-tag
detector (a MinMaxScaler pipeline ahead of an hourglass autoencoder) and a
40-tag one; three more 20-tag detectors are copies of the first with its
weights perturbed (seeded), so four machines share one spec bucket. Each
crosses into the port through ``DiffBasedAnomalyDetector.from_state``,
and a port-only LSTM detector rides along. The JAX app runs with a JAX
engine installed (the pattern of ``tests/serve/conftest.py``), the port's
app with an engine of the same configuration, and the same requests go to
both: answers within rtol 1e-5, atol 1e-6 (the port's f32 tolerance), the
same statuses and ``Retry-After`` headers, the same containment counters.
The anomaly columns past the reconstruction subtract the reconstruction
from ``y`` (through the detector's error scaler for the scaled ones), so
they are held to the forward's error carried through:
``atol = (1e-6 + 1e-5 * max |model-output|) * max(1, largest scale_)``.
The port's batched answers equal its unbatched ones exactly.

Coalescing is made deterministic: ``max_size`` equals the number of
concurrent clients and the filling request flushes its batch inline, with
a flush delay far past any thread start; a test that must see requests
queued waits on the batcher's depth hook, never on the clock.
"""

import contextlib
import copy
import json
import os
import shutil
import threading

import numpy as np
import pytest
from werkzeug.test import Client

from gordo_tpu import serializer as jax_serializer
from gordo_tpu import serve as jax_serve
from gordo_tpu.builder import local_build
from gordo_tpu.models.spec import FeedForwardSpec as JaxFeedForwardSpec
from gordo_tpu.serve import breaker as jax_breaker
from gordo_tpu.server import build_app as jax_build_app
from gordo_tpu.server.fleet_store import STORE as JAX_STORE
from gordo_tpu.utils import faults as jax_faults
from gordo_tpu_torch import serializer
from gordo_tpu_torch.models import factories
from gordo_tpu_torch.models.anomaly.diff import DiffBasedAnomalyDetector
from gordo_tpu_torch.models.nn import init_lstm, params_to_numpy
from gordo_tpu_torch.serve import breaker
from gordo_tpu_torch.serve.engine import ServeConfig, batching_enabled
from gordo_tpu_torch.server import build_app
from gordo_tpu_torch.utils import faults

from tests.test_torch_serving import _frame, port_detector

PROJECT = "engine-project"
REVISION = "1700000000000"
#: a sibling revision, a copy of REVISION, for the pinned and deletion races
OTHER = "1700000000001"
NARROW = ["narrow-0", "narrow-1", "narrow-2", "narrow-3"]
WIDE = "wide-0"
LSTM = "lstm-0"
TAGS20 = [f"tag-{i}" for i in range(20)]
TAGS40 = [f"tag-{i}" for i in range(40)]
ROWS = 30  # one rung of the test ladder (32)
RTOL, ATOL = 1e-5, 1e-6
#: the columns held at RTOL/ATOL; the others at the forward's error carried through
FORWARD_COLUMNS = ("start", "end", "model-input", "model-output")


def _machine(name, tags):
    return f"""
  - name: {name}
    dataset:
      type: RandomDataset
      train_start_date: "2020-01-01T00:00:00+00:00"
      train_end_date: "2020-01-03T00:00:00+00:00"
      tag_list: [{", ".join(tags)}]
    model:
      gordo_tpu.models.anomaly.diff.DiffBasedAnomalyDetector:
        base_estimator:
          sklearn.pipeline.Pipeline:
            steps:
              - sklearn.preprocessing.MinMaxScaler
              - gordo_tpu.models.JaxAutoEncoder:
                  kind: feedforward_hourglass
                  epochs: 1
"""


CONFIG = "machines:" + _machine(NARROW[0], TAGS20) + _machine(WIDE, TAGS40)


def perturbed(model, seed):
    """A copy of a JAX-built detector with its autoencoder's weights
    scaled by ``1 + 0.05 * N(0, 1)``, seeded: another member of the bucket."""
    model = copy.deepcopy(model)
    estimator = model.base_estimator.steps[-1][1]
    rng = np.random.default_rng(seed)
    estimator.params_ = {
        key: {n: (np.asarray(v) * (1 + 0.05 * rng.standard_normal(np.shape(v)))).astype(np.float32)
              for n, v in layer.items()}
        for key, layer in estimator.params_.items()
    }
    return model


def lstm_detector():
    """A port-only LSTM detector on the 20 tags: the engine serves it
    unbatched."""
    spec = factories.lstm_symmetric(20, lookback_window=4, dims=(6,), funcs=("tanh",))
    import torch

    params = params_to_numpy(init_lstm(spec, torch.Generator().manual_seed(3)))
    ones, zeros = [1.0] * 20, [0.0] * 20
    return DiffBasedAnomalyDetector.from_state({
        "spec": spec.to_dict(), "estimator": "JaxLSTMAutoEncoder", "params": params,
        "pipeline": [{"scale_": [0.5] * 20, "min_": [0.1] * 20}], "scaler": {"scale_": ones, "min_": zeros},
        "feature_thresholds": ones, "aggregate_threshold": 1.0,
    }, device="cpu")


def build_collections(root):
    """``(jax_dir, port_dir)``: the machines of the module docstring, each
    dir beside an OTHER revision that copies it."""
    jax_dir, port_dir = root / "jax" / REVISION, root / "port" / REVISION
    models = {machine.name: (model, machine.to_dict()) for model, machine in local_build(CONFIG, project_name=PROJECT)}
    for i, name in enumerate(NARROW[1:], start=1):
        models[name] = (perturbed(models[NARROW[0]][0], seed=i), models[NARROW[0]][1])
    for name, (model, metadata) in models.items():
        jax_serializer.dump(model, str(jax_dir / name), metadata=metadata)
        with open(jax_dir / name / "metadata.json") as f:
            metadata_json = json.load(f)
        serializer.dump(port_detector(model), str(port_dir / name), metadata=metadata_json)
        if name == NARROW[0]:
            serializer.dump(lstm_detector(), str(port_dir / LSTM), metadata=metadata_json)
    for served in (jax_dir, port_dir):
        shutil.copytree(served, served.parent / OTHER)
    return str(jax_dir), str(port_dir)


@pytest.fixture(scope="module")
def collections(tmp_path_factory):
    return build_collections(tmp_path_factory.mktemp("torch-engine"))


@pytest.fixture(autouse=True)
def serving_env(monkeypatch):
    """No background warmup, no batching switch, breaker defaults; the JAX
    engine uninstalled afterwards whatever happened."""
    monkeypatch.setenv("GORDO_TPU_SERVE_WARMUP", "0")
    for name in ("GORDO_TPU_BATCHING", "GORDO_TPU_BREAKER_THRESHOLD", "GORDO_TPU_BREAKER_COOLDOWN_S",
                 "GORDO_TPU_FAULTS", "GORDO_TPU_SERVE_PRECISION"):
        monkeypatch.delenv(name, raising=False)
    yield
    jax_serve.install_engine(None)


@pytest.fixture(scope="module")
def jax_app(collections):
    """The JAX app on the collection (it reads ``MODEL_COLLECTION_DIR`` on
    every request, so the variable stays set for the module)."""
    previous = os.environ.get("MODEL_COLLECTION_DIR")
    os.environ["MODEL_COLLECTION_DIR"] = collections[0]
    try:
        yield jax_build_app(config={"EXPECTED_MODELS": []})
    finally:
        if previous is None:
            os.environ.pop("MODEL_COLLECTION_DIR", None)
        else:
            os.environ["MODEL_COLLECTION_DIR"] = previous


#: a test engine: the batch flushed inline by the request that fills it, a
#: flush delay far past any thread start (and a deadline past it, so a test
#: that goes wrong ends in seconds instead of hanging), a two-rung ladder
BASE = dict(max_size=4, max_delay_ms=20000.0, deadline_ms=40000.0, queue_depth=64, row_ladder=(32, 128))


@contextlib.contextmanager
def engines(port_dir, **overrides):
    """``(jax_engine, port_app)``: a JAX engine installed for the JAX app
    and a port app on ``port_dir`` with an engine of the same knobs."""
    config = {**BASE, **overrides}
    jax_engine = jax_serve.ServeEngine(jax_serve.ServeConfig(**config))
    jax_serve.install_engine(jax_engine)
    port_app = build_app(port_dir, device="cpu", serve_config=ServeConfig(**config))
    try:
        yield jax_engine, port_app
    finally:
        jax_serve.install_engine(None)
        jax_engine.shutdown(drain=True)
        port_app.shutdown()


def url(name, route="prediction"):
    return f"/gordo/v0/{PROJECT}/{name}/{route}"


def payload(name, seed, rows=ROWS, nan=True):
    tags = TAGS40 if name == WIDE else TAGS20
    X, y = _frame(tags, rows, seed=seed), _frame(tags, rows, seed=seed + 100)
    if not nan:
        for frame in (X, y):
            for column in frame.values():
                for key, value in column.items():
                    if value is None:
                        column[key] = 0.25
    return {"X": X, "y": y}


def call(app, path, body, query=None):
    response = Client(app).post(path, data=json.dumps(body), content_type="application/json", query_string=query)
    return response.status_code, dict(response.headers), json.loads(response.get_data())


def concurrent(app, requests):
    """``requests`` (``(path, body)``) posted at once, one thread each;
    the answers in order."""
    answers = [None] * len(requests)

    def hit(i):
        try:
            answers[i] = call(app, *requests[i])
        except Exception as exc:  # noqa: BLE001 - surfaced below
            answers[i] = exc

    threads = [threading.Thread(target=hit, args=(i,)) for i in range(len(requests))]
    for thread in threads:
        thread.start()
    for thread in threads:
        thread.join(timeout=120)
    assert not any(isinstance(a, Exception) or a is None for a in answers), answers
    return answers


def close(expected, got, atol, path="data"):
    """Nested JSON equal: the same keys in the same order, numbers within
    RTOL and ``atol``, everything else exact."""
    if isinstance(expected, dict):
        assert isinstance(got, dict) and list(got) == list(expected), path
        for key in expected:
            close(expected[key], got[key], atol, f"{path}/{key}")
    elif isinstance(expected, float) and isinstance(got, float):
        np.testing.assert_allclose(got, expected, rtol=RTOL, atol=atol, err_msg=path)
    else:
        assert got == expected, path


_scales = {}


def error_scale(port_dir, name):
    """The largest ``scale_`` of a detector's error scaler (1 without one)."""
    if name not in _scales:
        scaler = getattr(serializer.load(os.path.join(port_dir, name), "cpu"), "scaler", None)
        _scales[name] = float(np.max(scaler.scale_)) if scaler is not None else 1.0
    return _scales[name]


def same_data(jax_answer, port_answer, scale=1.0):
    """Both answers 200 with the same data: the forward's columns within
    RTOL/ATOL, the derived ones within the forward's error carried through
    (the module docstring); ``scale`` is the error scaler's largest."""
    assert port_answer[0] == jax_answer[0] == 200, (jax_answer, port_answer)
    expected, got = jax_answer[2]["data"], port_answer[2]["data"]
    assert list(got) == list(expected)
    largest = max(abs(v) for column in expected["model-output"].values() for v in column.values() if v is not None)
    derived = (ATOL + RTOL * largest) * max(1.0, scale)
    for column in expected:
        close(expected[column], got[column], ATOL if column in FORWARD_COLUMNS else derived, column)


def same_answer(alone, batched):
    """The port's batched answer is its unbatched one, cell for cell."""
    assert batched[0] == alone[0] == 200
    assert batched[2]["data"] == alone[2]["data"]


def depth_event(engine, depth):
    """An event set once ``engine``'s queue holds ``depth`` requests (the
    batcher's depth hook, the same attribute in both packages)."""
    event = threading.Event()
    engine._batcher._on_depth = lambda d: event.set() if d >= depth else None
    return event


@pytest.mark.parametrize("route", ["prediction", "anomaly/prediction"])
def test_concurrent_clients_coalesce_and_match_jax(collections, jax_app, route):
    """Four clients, one machine each, on one spec: one batch, one forward
    in each engine; the port's answers equal the JAX engine's and the
    port's own unbatched ones."""
    jax_dir, port_dir = collections
    requests = [(url(name, route), payload(name, seed=i)) for i, name in enumerate(NARROW)]
    unbatched = [call(build_app(port_dir, device="cpu"), *r) for r in requests]
    with engines(port_dir) as (jax_engine, port_app):
        jax_answers = concurrent(jax_app, requests)
        port_answers = concurrent(port_app, requests)
        stats, jax_stats = port_app.engine.stats(), jax_engine.stats()
    for name, jax_answer, port_answer, alone in zip(NARROW, jax_answers, port_answers, unbatched):
        same_data(jax_answer, port_answer, error_scale(port_dir, name))
        same_answer(alone, port_answer)
    assert (stats["requests"], stats["batches"], stats["launches"], stats["coalesced"]) == (4, 1, 1, 4)
    assert (jax_stats["requests"], jax_stats["batches"], jax_stats["coalesced"]) == (4, 1, 4)
    assert stats["padded_members"] == 4 and stats["ingest_batches"] == 1
    assert stats["precision"] == {"config": "f32", "coalesced": {"f32": 4}}


def test_wide_bucket_coalesces(collections, jax_app):
    """The 40-tag machine beside a 20-tag one: two specs, two batches."""
    jax_dir, port_dir = collections
    requests = [(url(WIDE, "anomaly/prediction"), payload(WIDE, seed=7)),
                (url(NARROW[0], "anomaly/prediction"), payload(NARROW[0], seed=8))]
    with engines(port_dir, max_size=1) as (jax_engine, port_app):
        for (path, body), name in zip(requests, (WIDE, NARROW[0])):
            same_data(call(jax_app, path, body), call(port_app, path, body), error_scale(port_dir, name))
        assert port_app.engine.stats()["batches"] == 2
        assert [shape[3:] for shape in port_app.engine.program_shapes()] == [(1, 32, "f32")] * 2


def test_unbatchable_requests_fall_back(collections, jax_app):
    """Too tall for the ladder, empty, an LSTM, an unknown model: served
    as without the engine (or refused as there), counted as fallbacks."""
    jax_dir, port_dir = collections
    plain = build_app(port_dir, device="cpu")
    tall = (url(NARROW[0], "anomaly/prediction"), payload(NARROW[0], seed=11, rows=140))
    lstm = (url(LSTM, "anomaly/prediction"), payload(LSTM, seed=12))
    with engines(port_dir, max_size=1) as (jax_engine, port_app):
        same_data(call(jax_app, *tall), call(port_app, *tall), error_scale(port_dir, NARROW[0]))
        same_answer(call(plain, *tall), call(port_app, *tall))
        same_answer(call(plain, *lstm), call(port_app, *lstm))
        same_answer(call(plain, url(LSTM), lstm[1]), call(port_app, url(LSTM), lstm[1]))
        nope = (url("no-such-machine"), payload(NARROW[0], seed=13))
        assert call(jax_app, *nope)[0] == call(port_app, *nope)[0] == 404
        fleet = port_app.store.fleet()
        model = fleet.model(NARROW[0])
        empty = np.zeros((0, 20), np.float32)
        assert port_app.engine.batched_predict(fleet, NARROW[0], model, empty) is None
        assert port_app.engine.batched_predict(fleet, "no-such-machine", model, empty[:1]) is None
        jax_model = JAX_STORE.fleet(jax_dir).model(NARROW[0])
        assert jax_engine.batched_predict(jax_dir, NARROW[0], jax_model, empty) is None
        stats = port_app.engine.stats()
    assert stats["batches"] == 0 and stats["requests"] == 0
    assert stats["fallback"] == 6  # tall twice, the LSTM on both routes, empty, unknown
    assert jax_engine.stats()["fallback"] >= 2


def test_admission_statuses_match_jax(collections, jax_app):
    """429 with ``Retry-After`` when the queue is full, then the queued
    request drains to 200 at shutdown; 504 past the deadline."""
    jax_dir, port_dir = collections
    first = (url(NARROW[0]), payload(NARROW[0], seed=20))
    second = (url(NARROW[1]), payload(NARROW[1], seed=21))
    answers = {}
    with engines(port_dir, max_size=8, queue_depth=1) as (jax_engine, port_app):
        for side, app, engine in (("jax", jax_app, jax_engine), ("port", port_app, port_app.engine)):
            queued = depth_event(engine, 1)
            thread = threading.Thread(target=lambda app=app, side=side: answers.__setitem__(side, call(app, *first)))
            thread.start()
            assert queued.wait(timeout=60)
            answers[side + " full"] = call(app, *second)
            engine.shutdown(drain=True)  # the queued request still scores
            thread.join(timeout=60)
    for side in ("jax", "port"):
        status, headers, body = answers[side + " full"]
        assert status == 429 and "retry" in body["error"].lower()
        assert headers["Retry-After"] == answers["jax full"][1]["Retry-After"] == "80"
    same_data(answers["jax"], answers["port"], error_scale(port_dir, NARROW[0]))
    same_answer(call(build_app(port_dir, device="cpu"), *first), answers["port"])
    with engines(port_dir, deadline_ms=50.0) as (jax_engine, port_app):
        for app in (jax_app, port_app):
            status, _, body = call(app, *first)
            assert status == 504 and "timed out" in body["error"]
        assert port_app.engine.stats()["shed_deadline"] == jax_engine.stats()["shed_deadline"] == 1


def both_faults(site, match, times=1, exc="device"):
    """The same fault rule in both packages, as one context manager."""
    kinds = {"device": (jax_faults.InjectedDeviceError, faults.InjectedDeviceError), "default": (None, None)}
    jax_exc, port_exc = kinds[exc]
    stack = contextlib.ExitStack()
    rules = (jax_faults.FaultRule(site, match=match, times=times, exc=jax_exc),
             faults.FaultRule(site, match=match, times=times, exc=port_exc))
    stack.enter_context(jax_faults.inject(rules[0]))
    stack.enter_context(faults.inject(rules[1]))
    return stack, rules


class Clock:
    """``time`` for the breaker modules: the real monotonic clock plus an
    offset the test moves past a cooldown."""

    def __init__(self):
        import time

        self.offset = 0.0
        self._monotonic = time.monotonic

    def monotonic(self):
        return self._monotonic() + self.offset


def test_isolated_failure_500_then_breaker_503(collections, jax_app, monkeypatch):
    """A member whose forward keeps failing answers 500 (isolated), then
    503 with ``Retry-After`` once its breaker opens; its neighbours 200."""
    jax_dir, port_dir = collections
    monkeypatch.setenv("GORDO_TPU_BREAKER_THRESHOLD", "1")
    monkeypatch.setenv("GORDO_TPU_BREAKER_COOLDOWN_S", "30")
    poison, innocent = (url(NARROW[1]), payload(NARROW[1], seed=30)), (url(NARROW[0]), payload(NARROW[0], seed=31))
    with engines(port_dir, max_size=1) as (jax_engine, port_app):
        stack, _ = both_faults("serve_device_program", f"*:f32:{NARROW[1]}", times=None)
        with stack:
            for app in (jax_app, port_app):
                status, _, body = call(app, *poison)
                assert status == 500 and body["error"] == "Device scoring failed for this model."
                status, headers, body = call(app, *poison)
                assert status == 503 and headers["Retry-After"] == "30" and "quarantined" in body["error"]
                assert call(app, *innocent)[0] == 200
        for stats in (port_app.engine.stats(), jax_engine.stats()):
            assert (stats["members_isolated"], stats["breaker_trips"], stats["breaker_rejects"]) == (1, 1, 1)
            assert stats["breaker"]["open"] == 1


def test_transient_fault_bisects_and_every_rider_scores(collections, jax_app):
    jax_dir, port_dir = collections
    requests = [(url(name), payload(name, seed=40 + i)) for i, name in enumerate(NARROW)]
    with engines(port_dir) as (jax_engine, port_app):
        reference = concurrent(port_app, requests)
        for app in (jax_app, port_app):
            stack, rules = both_faults("serve_device_program", f"*:f32:{NARROW[2]}")
            with stack:
                answers = concurrent(app, requests)
            if app is port_app:
                assert rules[1].fired == 1
                for alone, answer in zip(reference, answers):
                    same_answer(alone, answer)
            else:
                assert rules[0].fired == 1 and all(a[0] == 200 for a in answers)
        for stats in (port_app.engine.stats(), jax_engine.stats()):
            assert (stats["device_errors"], stats["batch_bisects"], stats["members_isolated"]) == (1, 1, 0)
    # the reference's, then the two halves' (the fault fires before the whole batch's launch)
    assert port_app.engine.stats()["launches"] == 3


def test_poison_member_fails_alone_and_recovers(collections, jax_app, monkeypatch):
    """A poisoned member fails alone in each coalesced batch while its
    riders answer; past the threshold it is quarantined (503); after the
    cooldown one request probes it, and a clean probe closes the breaker."""
    jax_dir, port_dir = collections
    monkeypatch.setenv("GORDO_TPU_BREAKER_THRESHOLD", "2")
    monkeypatch.setenv("GORDO_TPU_BREAKER_COOLDOWN_S", "30")
    clocks = Clock(), Clock()
    monkeypatch.setattr(jax_breaker, "time", clocks[0])
    monkeypatch.setattr(breaker, "time", clocks[1])
    requests = [(url(name), payload(name, seed=50 + i)) for i, name in enumerate(NARROW)]
    statuses = {}
    with engines(port_dir) as (jax_engine, port_app):
        stack, _ = both_faults("serve_device_program", f"*:f32:{NARROW[3]}", times=None)
        with stack:
            for side, app in (("jax", jax_app), ("port", port_app)):
                first = concurrent(app, requests)
                second = concurrent(app, requests)
                statuses[side] = [a[0] for a in first] + [a[0] for a in second] + [call(app, *requests[3])[0]]
        for clock in clocks:
            clock.offset += 31.0
        for app in (jax_app, port_app):  # the half-open probe rides a full batch
            assert [a[0] for a in concurrent(app, requests)] == [200] * 4
        for stats in (port_app.engine.stats(), jax_engine.stats()):
            assert (stats["members_isolated"], stats["breaker_trips"], stats["breaker"]["open"]) == (2, 1, 0)
    assert statuses["port"] == statuses["jax"] == [200, 200, 200, 500] * 2 + [503]


def test_nonfinite_output_is_the_members_fault(collections, jax_app):
    """NaN out of finite rows fails the member (500); NaN out of rows that
    hold a NaN is the client's (200, the same answer on both)."""
    jax_dir, port_dir = collections
    finite = (url(NARROW[2]), payload(NARROW[2], seed=60, nan=False))
    holed = (url(NARROW[2]), payload(NARROW[2], seed=61))
    with engines(port_dir, max_size=1) as (jax_engine, port_app):
        stack, _ = both_faults("serve_member_poison", f"*:f32:{NARROW[2]}", times=None)
        with stack:
            assert call(jax_app, *finite)[0] == call(port_app, *finite)[0] == 500
            jax_answer, port_answer = call(jax_app, *holed), call(port_app, *holed)
        assert port_answer[0] == jax_answer[0] == 200
        assert port_answer[2]["data"]["model-output"] == jax_answer[2]["data"]["model-output"]
        for stats in (port_app.engine.stats(), jax_engine.stats()):
            assert (stats["nonfinite_outputs"], stats["members_isolated"]) == (1, 1)


def test_out_of_memory_demotes_the_rung(collections, jax_app):
    """An out-of-memory of one member drops the row rung and serves it
    unbatched (200); of a coalesced batch, halves the member axis."""
    jax_dir, port_dir = collections
    alone = (url(NARROW[0]), payload(NARROW[0], seed=70))
    requests = [(url(name), payload(name, seed=71 + i)) for i, name in enumerate(NARROW)]
    with engines(port_dir, max_size=1) as (jax_engine, port_app):
        for app in (jax_app, port_app):
            stack, _ = both_faults("serve_device_program", f"*:f32:{NARROW[0]}", exc="default")
            with stack:
                assert call(app, *alone)[0] == 200
            assert call(app, *alone)[0] == 200  # rung 32 demoted: unbatched now
        same_answer(call(build_app(port_dir, device="cpu"), *alone), call(port_app, *alone))
        # fallbacks: the request after the demotion (and the port's same_answer call)
        for stats, fallbacks in ((port_app.engine.stats(), 2), (jax_engine.stats(), 1)):
            assert (stats["rung_demotions"], stats["oom_fallbacks"], stats["fallback"]) == (1, 1, fallbacks)
            assert stats["demoted_rungs"] == {"members": {}, "rows": {"FeedForwardSpec:f32": 0}}
    with engines(port_dir) as (jax_engine, port_app):
        for app in (jax_app, port_app):
            stack, _ = both_faults("serve_device_program", f"*:f32:{NARROW[1]}", exc="default")
            with stack:
                assert [a[0] for a in concurrent(app, requests)] == [200] * 4
        for stats in (port_app.engine.stats(), jax_engine.stats()):
            assert stats["demoted_rungs"] == {"members": {"FeedForwardSpec:f32": 2}, "rows": {}}
            assert (stats["batch_bisects"], stats["members_isolated"]) == (1, 0)


def test_scatter_fault_is_isolated_to_its_rider(collections, jax_app):
    jax_dir, port_dir = collections
    requests = [(url(name), payload(name, seed=80 + i)) for i, name in enumerate(NARROW)]
    with engines(port_dir) as (jax_engine, port_app):
        for app in (jax_app, port_app):
            stack, _ = both_faults("serve_scatter", f"*:f32:{NARROW[1]}")
            with stack:
                assert [a[0] for a in concurrent(app, requests)] == [200, 500, 200, 200]


@pytest.fixture
def disposable(collections, tmp_path):
    """Copies of both collections (REVISION and OTHER) a test may delete."""
    copies = []
    for served in collections:
        root = tmp_path / os.path.basename(os.path.dirname(served))
        for revision in (REVISION, OTHER):
            shutil.copytree(os.path.join(os.path.dirname(served), revision), root / revision)
        copies.append((str(root / REVISION), str(root / OTHER)))
    yield copies
    for live, doomed in copies[:1]:
        JAX_STORE.invalidate(live)
        JAX_STORE.invalidate(doomed)


def test_invalidate_mid_batch_keeps_queued_and_later_requests_sane(disposable):
    """Requests queued when their revision is invalidated and deleted still
    score against the fleet they were admitted with; later ones see a
    fresh, empty fleet and fall back."""
    (_, jax_doomed), (_, port_doomed) = disposable
    X = np.random.RandomState(0).rand(6, 20).astype(np.float32)
    with engines(port_doomed, max_size=8) as (jax_engine, port_app):
        port_fleet = port_app.store.fleet(port_doomed)
        jax_fleet = JAX_STORE.fleet(jax_doomed)
        sides = (
            (port_app.engine, lambda: port_fleet, port_fleet.model(NARROW[0]), port_fleet,
             lambda: port_app.store.invalidate(port_doomed), port_doomed),
            (jax_engine, lambda: jax_doomed, jax_fleet.model(NARROW[0]), jax_fleet,
             lambda: JAX_STORE.invalidate(jax_doomed), jax_doomed),
        )
        for engine, where, model, fleet, invalidate, doomed in sides:
            fleet.model(NARROW[0])
            reference = fleet.predict(NARROW[0], X) if engine is port_app.engine else np.asarray(model.predict(X))
            results = [None] * 4
            queued = depth_event(engine, 4)
            threads = [threading.Thread(target=lambda i=i: results.__setitem__(
                i, engine.batched_predict(where(), NARROW[0], model, X))) for i in range(4)]
            for thread in threads:
                thread.start()
            assert queued.wait(timeout=60)
            invalidate()
            shutil.rmtree(doomed)
            engine.shutdown(drain=True)
            for thread in threads:
                thread.join(timeout=60)
            for recon in results:
                np.testing.assert_allclose(recon, reference, rtol=RTOL, atol=ATOL)
        later = port_app.store.fleet(port_doomed)
        assert later is not port_fleet and later.loaded_specs() == {}
        assert port_app.engine.batched_predict(later, NARROW[0], port_fleet.model(NARROW[0]), X) is None


def test_delete_revision_mid_batch_never_500s(disposable, monkeypatch):
    """Requests pinned to a revision while DELETE removes it model by
    model: each answers 200, 404 or 410, and the served revision keeps
    answering 200."""
    (jax_live, _), (port_live, _) = disposable
    monkeypatch.setenv("MODEL_COLLECTION_DIR", jax_live)
    jax_app = jax_build_app(config={"EXPECTED_MODELS": []})
    requests = [(url(name), payload(name, seed=90 + i)) for i, name in enumerate(NARROW * 2)]
    with engines(port_live, max_size=8, max_delay_ms=150.0) as (jax_engine, port_app):
        for app in (jax_app, port_app):
            statuses = [None] * len(requests)

            def hit(i, app=app):
                statuses[i] = call(app, *requests[i], query={"revision": OTHER})[0]

            threads = [threading.Thread(target=hit, args=(i,)) for i in range(len(requests))]
            for thread in threads:
                thread.start()
            for name in NARROW + [WIDE]:
                response = Client(app).delete(f"/gordo/v0/{PROJECT}/{name}/revision/{OTHER}")
                assert response.status_code in (200, 404), response.get_data()
            for thread in threads:
                thread.join(timeout=60)
            assert all(code in (200, 404, 410) for code in statuses), statuses
            assert call(app, *requests[0])[0] == 200


def test_shutdown_drains_queued_requests(collections, jax_app):
    jax_dir, port_dir = collections
    requests = [(url(name), payload(name, seed=100 + i)) for i, name in enumerate(NARROW[:3])]
    with engines(port_dir, max_size=8) as (jax_engine, port_app):
        answers = {}
        for side, app, engine, stop in (("jax", jax_app, jax_engine, lambda: jax_engine.shutdown(drain=True)),
                                        ("port", port_app, port_app.engine, port_app.shutdown)):
            queued = depth_event(engine, 3)
            thread = threading.Thread(target=lambda app=app, side=side: answers.__setitem__(
                side, concurrent(app, requests)))
            thread.start()
            assert queued.wait(timeout=60)
            stop()
            thread.join(timeout=60)
            assert engine.stats()["batches"] == 1
        for name, jax_answer, port_answer in zip(NARROW, answers["jax"], answers["port"]):
            same_data(jax_answer, port_answer, error_scale(port_dir, name))
        # after the drain the app still answers, unbatched
        assert call(port_app, *requests[0])[0] == 200 and port_app.engine.stats()["fallback"] == 1


def test_batching_off_is_the_default(collections, monkeypatch):
    jax_dir, port_dir = collections
    assert not batching_enabled()
    app = build_app(port_dir, device="cpu")
    assert app.engine is None
    request = (url(NARROW[0]), payload(NARROW[0], seed=110))
    status, _, body = call(app, *request)
    expected = app.store.fleet().predict(NARROW[0], np.asarray(
        [[np.nan if body["data"]["model-input"][t][k] is None else body["data"]["model-input"][t][k]
          for t in TAGS20] for k in body["data"]["model-input"][TAGS20[0]]], np.float32))
    assert status == 200
    got = [[body["data"]["model-output"][t][k] for t in TAGS20] for k in body["data"]["model-output"][TAGS20[0]]]
    np.testing.assert_array_equal(np.asarray(got, np.float64), expected.astype(np.float64))
    monkeypatch.setenv("GORDO_TPU_BATCHING", "1")
    monkeypatch.setenv("GORDO_TPU_BATCH_MAX_SIZE", "3")
    app = build_app(port_dir, device="cpu")
    assert app.engine.config.max_size == 3 and app.engine.config.deadline_s == 2.0
    app.shutdown()
    # the learned performance model's byte budget builds the app, and caps the row rungs as JAX's engine does
    monkeypatch.setenv("GORDO_TPU_PERFMODEL_BATCH_CAP_BYTES", "1000000")
    app = build_app(port_dir, device="cpu")
    jax_engine = jax_serve.ServeEngine(jax_serve.ServeConfig(max_size=3, row_ladder=app.engine.config.row_ladder))
    try:
        fleet = app.store.fleet()
        fleet.warm()
        for name in (NARROW[0], WIDE):
            spec = fleet.loaded_specs()[name]
            jax_spec = JaxFeedForwardSpec(spec.n_features, spec.n_features_out, tuple(spec.dims),
                                          tuple(spec.activations))
            cap = app.engine._model_row_cap(spec, "f32")
            assert cap == jax_engine._model_row_cap(jax_spec, "f32")
            assert 0 < cap < app.engine.config.row_ladder[-1]
    finally:
        app.shutdown()
        jax_engine.shutdown()


def test_stream_plane_shares_the_engines_board(collections, jax_app, monkeypatch):
    """A member tripped by requests is quarantined on a stream of both
    servers: the plane quarantines through the engine's board."""
    from gordo_tpu.stream import reset_plane

    jax_dir, port_dir = collections
    monkeypatch.setenv("GORDO_TPU_BREAKER_THRESHOLD", "1")
    monkeypatch.setenv("GORDO_TPU_STREAM_WINDOW_ROWS", "8")
    reset_plane()
    try:
        with engines(port_dir, max_size=1) as (jax_engine, port_app):
            assert port_app.ensure_plane().breakers is port_app.engine.breakers
            assert jax_serve.stream_breaker_board() is jax_engine.breakers
            acks = []
            with both_faults("serve_device_program", f"*:f32:{NARROW[1]}", times=None)[0]:
                for app in (jax_app, port_app):
                    assert call(app, url(NARROW[1]), payload(NARROW[1], seed=120))[0] == 500
            for app in (jax_app, port_app):
                X = {name: _frame(TAGS20, 8, seed=121) for name in NARROW[:2]}
                status, _, ack = call(app, f"/gordo/v0/{PROJECT}/stream/s1/ingest", {"X": X})
                assert status == 200
                acks.append(ack)
            for ack in acks:
                assert list(ack["quarantined"]) == [NARROW[1]] and list(ack["scored"]) == [NARROW[0]]
    finally:
        reset_plane()
