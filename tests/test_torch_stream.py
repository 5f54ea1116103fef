"""The port's streaming plane against the JAX package's, piece by piece, on
the CPU: the same operations go to both and their answers must be equal.

- ``RowRing``/``EventRing``: sequence numbers, sheds, takes and replays;
- ``StreamSession``: cuts (snapped to the row ladder) and the subscribe
  output, byte for byte, and ``encode_sse``/``heartbeat_frame`` bytes;
- ``snap_rows`` over a grid of backlogs, windows and ladders;
- the breaker board's state sequence under an injected clock;
- the fault registry's rule parsing and firing;
- ``StreamPlane`` acks and events over a fake fleet (each flush scores
  mse 0.5), with sheds, a ``stream_ingest`` fault and a quarantine.

Everything here is exact: no scoring arithmetic differs between the two.
The scoring through real models is held against the JAX server in
``tests/test_torch_serving.py``.
"""

import json
import random

import numpy as np
import pandas as pd
import pytest

from gordo_tpu import serve as jax_serve
from gordo_tpu.planner.ladder import snap_rows as jax_snap_rows
from gordo_tpu.serve import breaker as jax_breaker
from gordo_tpu.server.fleet_store import STORE as JAX_STORE
from gordo_tpu.stream import events as jax_events
from gordo_tpu.stream import plane as jax_plane
from gordo_tpu.stream.ring import EventRing as JaxEventRing, RowRing as JaxRowRing
from gordo_tpu.stream.session import StreamSession as JaxStreamSession
from gordo_tpu.utils import faults as jax_faults
from gordo_tpu_torch.serve import breaker
from gordo_tpu_torch.serve.ladder import DEFAULT_ROW_LADDER, parse_ladder, snap_rows
from gordo_tpu_torch.server.wire import Frame
from gordo_tpu_torch.stream import events, plane
from gordo_tpu_torch.stream.ring import EventRing, RowRing
from gordo_tpu_torch.stream.session import StreamSession
from gordo_tpu_torch.utils import faults

# -- rings ---------------------------------------------------------------------


def _ring_ops(seed, capacity, n_ops=60):
    """A seeded mix of appends (of 0..2*capacity rows) and takes."""
    rng = random.Random(seed)
    ops, value = [], 0
    for _ in range(n_ops):
        if rng.random() < 0.6:
            rows = rng.randint(0, 2 * capacity)
            ops.append(("append", list(range(value, value + rows)), float(value)))
            value += rows
        else:
            ops.append(("take", rng.randint(0, capacity), None))
    return ops


def _run_ring(ring, ops, as_frame=False):
    out = []
    for op, arg, ts in ops:
        if op == "append":
            chunk = Frame(arg, ["v"], np.asarray(arg, float)[:, None]) if as_frame else arg
            out.append(ring.append(chunk, ingest_ts=ts))
        else:
            taken = ring.take(arg)
            if taken is not None:
                chunks, first, last, oldest_ts = taken
                rows = [r for c in chunks for r in (c.index if as_frame else c)]
                taken = (rows, first, last, oldest_ts)
            out.append(taken)
        out.append((ring.pending_rows, ring.shed_rows, ring.next_seq, ring.oldest_ts))
    return out


@pytest.mark.parametrize("seed,capacity", [(0, 8), (1, 5), (2, 64), (3, 1)])
def test_row_ring_matches_jax(seed, capacity):
    ops = _ring_ops(seed, capacity)
    expected = _run_ring(JaxRowRing(capacity), ops)
    assert _run_ring(RowRing(capacity), ops) == expected
    # the server's frames slice with numpy and give the same rows
    assert _run_ring(RowRing(capacity), ops, as_frame=True) == expected


@pytest.mark.parametrize("capacity", [1, 3, 10])
def test_event_ring_matches_jax(capacity):
    rng = random.Random(capacity)
    ours, theirs = EventRing(capacity), JaxEventRing(capacity)
    for i in range(40):
        assert ours.append(f"e{i}") == theirs.append(f"e{i}")
        cursor = rng.randint(0, i + 2)
        assert ours.since(cursor) == theirs.since(cursor)
        assert (ours.latest_seq, ours.oldest_seq, ours.dropped) == (
            theirs.latest_seq, theirs.oldest_seq, theirs.dropped)


# -- events ------------------------------------------------------------------------

PAYLOADS = [
    ("anomaly", {"machine": "m-1", "first_seq": 1, "last_seq": 64, "rows": 64, "windows": 1,
                 "mse_mean": 0.12345678901234, "mse_max": 1e-7, "revision": "1700000000000"}),
    ("anomaly", {"machine": "m-2", "mse_mean": None, "mse_max": None}),
    ("shed", {"scope": "ring", "machine": "m-1", "dropped": 3, "rows_shed_total": 9}),
    ("quarantined", {"machine": "m-3", "retry_after_s": 29.873, "trips": 2}),
    ("error", {"machine": "m-3", "first_seq": 65, "last_seq": 128, "error": "FaultInjected"}),
    ("recovered", {"machine": "m-3"}),
    ("end", {"reason": "ünïcode \"quoted\"\nline"}),
    ("drain", {}),
]


@pytest.mark.parametrize("seq", [None, 0, 17])
def test_encode_sse_bytes_match_jax(seq):
    for kind, data in PAYLOADS:
        ours = events.encode_sse(seq, events.StreamEvent(kind, data))
        assert ours == jax_events.encode_sse(seq, jax_events.StreamEvent(kind, data))
        assert events.StreamEvent(kind).terminal == jax_events.StreamEvent(kind).terminal
    for args in [(), (3, None), (None, 5), (4, 120)]:
        assert events.heartbeat_frame(*args) == jax_events.heartbeat_frame(*args)


# -- sessions ----------------------------------------------------------------------


def _drive_session(session, frame, event):
    """Rows in, cuts out (snapped to the ladder), events emitted, closed,
    then every subscriber view of it; frames are made by ``frame(values)``."""
    out = []
    value = 0
    for name, rows in [("m-1", 5), ("m-2", 3), ("m-1", 300), ("m-2", 2), ("m-3", 9), ("m-1", 70)]:
        first_seq, shed = session.append_rows(name, frame(list(range(value, value + rows))))
        value += rows
        out.append((name, first_seq, shed, session.pending_machines(4)))
        cut = session.cut_windows(4, skip=("m-3",), snap=lambda pending: snap_rows(pending, 4))
        out.append({n: (first, last, windows) for n, (_chunks, first, last, windows, _ts) in cut.items()})
    session.emit(event("anomaly", {"machine": "m-1", "rows": 4}))
    session.emit(event("quarantined", {"machine": "m-3", "retry_after_s": 1.0}))
    with jax_faults.inject(jax_faults.FaultRule("stream_emit", match="*:recovered")), \
            faults.inject(faults.FaultRule("stream_emit", match="*:recovered")):
        assert session.emit(event("recovered", {"machine": "m-3"})) is None
    session.emit(event("anomaly", {"machine": "m-2", "rows": 4}))
    session.close("end", reason="done")
    session.close("drain")  # the first close wins
    out.append(session.shed_delta())
    for cursor in (0, 2, 5, 99):
        out.append(list(session.subscribe(cursor=cursor, heartbeat_s=0.01, idle_timeout_s=0.02)))
    out.append(list(session.subscribe(cursor=0, heartbeat_s=0.01, max_events=2,
                                      prelude=[event("quarantined", {"machine": "m-3"})])))
    stats = session.stats()
    stats["lag"].pop("watermark_delay_max_ms")  # wall clock
    for machine in stats["machines"].values():
        machine.pop("watermark_delay_ms")
    out.append(stats)
    return out


def test_session_cut_and_subscribe_match_jax():
    ours = _drive_session(
        StreamSession("p", "s1", "/anchor", ring_rows=256, outbox_events=4),
        lambda values: Frame(values, ["v"], np.asarray(values, float)[:, None]),
        events.StreamEvent,
    )
    theirs = _drive_session(
        JaxStreamSession("p", "s1", "/anchor", ring_rows=256, outbox_events=4),
        lambda values: pd.DataFrame({"v": np.asarray(values, float)}),
        jax_events.StreamEvent,
    )
    assert ours == theirs


# -- the row ladder ----------------------------------------------------------------


@pytest.mark.parametrize("ladder", [None, (4, 16, 100), (64,)])
def test_snap_rows_matches_jax_on_a_grid(ladder):
    for window in (1, 3, 4, 5, 32, 64, 100):
        for pending in range(0, 1200, 7):
            assert snap_rows(pending, window, ladder) == jax_snap_rows(pending, window, ladder)
    assert snap_rows(1008, 64) == 512  # the chip smoke's first stream flush


def test_row_ladder_env_matches_jax(monkeypatch):
    from gordo_tpu.planner.ladder import row_ladder as jax_row_ladder

    from gordo_tpu_torch.serve.ladder import row_ladder

    assert row_ladder() == jax_row_ladder() == DEFAULT_ROW_LADDER
    for raw in ("100, 10,100", "not,a,ladder", "-5"):
        monkeypatch.setenv("GORDO_TPU_BATCH_ROW_LADDER", raw)
        assert row_ladder() == jax_row_ladder()
    assert parse_ladder("8,2") == (2, 8)


# -- breakers ----------------------------------------------------------------------


class _Clock:
    def __init__(self):
        self.now = 1000.0

    def monotonic(self):
        return self.now


class _Fleet:
    """A stand-in revision fleet: breaker keys hold its id, and a dead one
    takes its records with it."""


def _drive_board(board, clock):
    fleet, other = _Fleet(), _Fleet()
    seen, transitions = [], []
    board._on_transition = lambda member, old, new, info: transitions.append((member, old, new, info["trips"]))
    steps = [
        ("fail", "a"), ("fail", "a"), ("q", "a"), ("fail", "a"), ("q", "a"), ("q", "b"),
        ("tick", 4.0), ("q", "a"), ("tick", 2.0), ("q", "a"), ("fail", "a"), ("q", "a"),
        ("tick", 13.0), ("q", "a"), ("q", "a"), ("ok", "a"), ("q", "a"), ("fail", "b"), ("ok", "b"),
        ("fail", "b"), ("fail", "b"), ("fail", "b"), ("other", "a"), ("tick", 100.0), ("q", "b"),
        ("tick", 3.0), ("q", "b"), ("fail", "b"), ("drop", "other"),
    ]
    for op, arg in steps:
        if op == "tick":
            clock.now += arg
            continue
        if op == "drop":
            other = None
            seen.append(board.summary()["tracked"])
            continue
        if op == "fail":
            result = board.record_failure(fleet, "spec", arg, RuntimeError("boom"))
        elif op == "ok":
            result = board.record_success(fleet, "spec", arg)
        elif op == "other":
            result = board.record_failure(other, "spec", arg, RuntimeError("elsewhere"))
        else:
            result = board.quarantined(fleet, "spec", arg)
        seen.append((op, arg, result, board.summary(top_k=5)))
    return seen, transitions


def test_breaker_state_sequence_matches_jax(monkeypatch):
    clocks = _Clock(), _Clock()
    monkeypatch.setattr(breaker, "time", clocks[0])
    monkeypatch.setattr(jax_breaker, "time", clocks[1])
    config = dict(threshold=2, cooldown_s=5.0, backoff=2.0, max_cooldown_s=15.0, probe_ttl_s=3.0)
    ours = _drive_board(breaker.BreakerBoard(breaker.BreakerConfig(**config)), clocks[0])
    theirs = _drive_board(jax_breaker.BreakerBoard(jax_breaker.BreakerConfig(**config)), clocks[1])
    assert ours == theirs
    assert [new for _, _, new, _ in ours[1]][:2] == ["open", "half_open"]


def test_breaker_config_from_env_matches_jax(monkeypatch):
    for name, value in [("THRESHOLD", "4"), ("COOLDOWN_S", "2.5"), ("BACKOFF", "junk"), ("MAX_COOLDOWN_S", "9")]:
        monkeypatch.setenv(f"GORDO_TPU_BREAKER_{name}", value)
    ours, theirs = breaker.BreakerConfig.from_env(), jax_breaker.BreakerConfig.from_env()
    assert [getattr(ours, k) for k in ours.__slots__] == [getattr(theirs, k) for k in theirs.__slots__]


# -- faults ------------------------------------------------------------------------


def test_fault_rules_fire_like_jax(monkeypatch):
    spec = "stream_score:*bad:times=2:after=1;stream_ingest:s1*:exc=RuntimeError;stream_emit:*"
    def fields(rules):
        return [(r.site, r.match, r.times, r.after, r.exc and r.exc.__name__) for r in rules]

    assert fields(faults.parse_rules(spec)) == fields(jax_faults.parse_rules(spec))
    monkeypatch.setenv("GORDO_TPU_FAULTS", spec)
    calls = [("stream_score", "s1:bad"), ("stream_ingest", "s1:m"), ("stream_score", "s2:bad"),
             ("stream_emit", "s1:anomaly"), ("stream_score", "s1:bad"), ("stream_score", "s1:bad"),
             ("stream_score", "s1:good")]

    def fired(module):
        module.clear()
        out = []
        for site, key in calls:
            try:
                module.fault_point(site, key)
                out.append(None)
            except Exception as exc:  # noqa: BLE001 - the type is the answer
                out.append(type(exc).__name__)
        module.clear()
        return out

    assert fired(faults) == fired(jax_faults) == [None, "RuntimeError", "FaultInjected", "FaultInjected",
                                                  "FaultInjected", None, None]
    with pytest.raises(ValueError):
        faults.parse_rules("stream_score:*:bogus=1")


# -- the plane over a fake fleet ---------------------------------------------------


class FakeFleet:
    """``fleet_scores``' twin: mse 0.5 for every row, ``RuntimeError`` for
    the names in ``poison``."""

    def __init__(self):
        self.poison = set()

    def model(self, name):
        return object()

    def loaded_specs(self):
        return {}

    def fleet_scores(self, inputs):
        scores, errors = {}, {}
        for name, X in inputs.items():
            if name in self.poison:
                errors[name] = RuntimeError("poisoned")
            else:
                scores[name] = (np.zeros((len(X), 2)), np.full(len(X), 0.5, np.float32))
        return scores, errors


class FakeStore:
    collection_dir = "/models/1700000000000"

    def __init__(self):
        self._fleet = FakeFleet()

    def route(self, directory):
        return directory

    def fleet(self, directory=None):
        return self._fleet


@pytest.fixture
def jax_plane_state(monkeypatch):
    """The JAX plane over a fake store, with no engine and a fresh
    standalone breaker board (threshold 1)."""
    fleet = FakeFleet()
    monkeypatch.setattr(JAX_STORE, "route", lambda directory: directory)
    monkeypatch.setattr(JAX_STORE, "fleet", lambda directory: fleet)
    monkeypatch.setenv("GORDO_TPU_BREAKER_THRESHOLD", "1")
    monkeypatch.setenv("GORDO_TPU_BREAKER_COOLDOWN_S", "60")
    engine = jax_serve.get_engine()
    jax_serve.install_engine(None)
    jax_serve.reset_stream_breakers()
    yield fleet
    jax_serve.reset_stream_breakers()
    jax_serve.install_engine(engine)


def _drive_plane(plane_, session, fleet, frame, inject, rule):
    acks = []
    batches = [{"m-1": 5, "m-2": 3}, {"m-1": 3, "m-2": 1, "m-3": 4}, {"m-1": 30}, {"m-2": 8, "m-3": 4}]
    for i, batch in enumerate(batches):
        if i == 1:
            fleet.poison.add("m-3")  # fails, trips (threshold 1), then stays quarantined
        if i == 3:
            fleet.poison.clear()
        acks.append(plane_.ingest(session, {name: frame(rows) for name, rows in batch.items()}))
    with inject(rule("stream_ingest", match="s1:m-2", times=None)):
        acks.append(plane_.ingest(session, {"m-1": frame(4), "m-2": frame(4)},
                                  {"bad": {"error": "decode", "status": 400}}))
    frames = list(plane_.subscribe(session, cursor=0, max_events=100, idle_timeout_s=0.02))
    stats = plane_.stats()
    counters = stats["counters"], stats["sessions"]["p/s1"]["accounting"]
    for ack in acks:
        ack.pop("quarantined")  # the breaker's remaining cooldown: wall clock
    return acks, [f for f in frames if "quarantined" not in f], counters


def test_plane_acks_and_events_match_jax(jax_plane_state, monkeypatch):
    config = dict(ring_rows=16, window_rows=4, outbox_events=64, heartbeat_s=0.05, max_sessions=2)
    theirs_plane = jax_plane.StreamPlane(jax_plane.StreamConfig(**config))
    theirs = _drive_plane(
        theirs_plane, theirs_plane.session("p", "s1", "/models/1700000000000"), jax_plane_state,
        lambda rows: pd.DataFrame({"v": np.arange(rows, dtype=float)}), jax_faults.inject, jax_faults.FaultRule,
    )
    store = FakeStore()
    ours_plane = plane.StreamPlane(store, plane.StreamConfig(**config))
    ours = _drive_plane(
        ours_plane, ours_plane.session("p", "s1"), store.fleet(),
        lambda rows: Frame(list(range(rows)), ["v"], np.arange(rows, dtype=float)[:, None]),
        faults.inject, faults.FaultRule,
    )
    assert ours == theirs
    failed = [json.loads(f.split("data: ")[1])["machine"] for f in ours[1] if "event: error" in f]
    assert failed == ["m-3"]
    assert ours[2][1]["rows_pending"] >= 4 and ours[2][1]["rows_shed"] > 0 and ours[2][1]["gap"] == 0
    # admission, drain and the statuses' causes
    ours_plane.session("p", "s2")
    with pytest.raises(plane.PlaneSaturated) as full:
        ours_plane.session("p", "s3")
    assert not full.value.draining
    assert ours_plane.drain() == 2 and ours_plane.drain() == 0
    with pytest.raises(plane.PlaneSaturated) as draining:
        ours_plane.session("p", "s4")
    assert draining.value.draining


def test_stream_config_from_env_matches_jax(monkeypatch):
    for name, value in [("RING_ROWS", "100"), ("WINDOW_ROWS", "7"), ("OUTBOX_EVENTS", "x"),
                        ("SESSION_TTL_S", "0.5"), ("HEARTBEAT_S", "0.01"), ("MAX_SESSIONS", "3")]:
        monkeypatch.setenv(f"GORDO_TPU_STREAM_{name}", value)
    ours, theirs = plane.StreamConfig.from_env(), jax_plane.StreamConfig.from_env()
    assert [getattr(ours, k) for k in ours.__slots__] == [getattr(theirs, k) for k in theirs.__slots__]
    monkeypatch.setenv("GORDO_TPU_STREAM_ENABLED", "off")
    assert plane.stream_enabled() is jax_plane.stream_enabled() is False
