"""
The streaming plane's coordinator, a copy of ``gordo_tpu/stream/plane.py``:
the session registry, ingest, subscribe and drain.

The server app owns one :class:`StreamPlane`, created on the first
stream route (the JAX package installs a process-global one), beside its
store. The plane quarantines through the app's serving engine's breaker
board when the app has an engine, so a member tripped by requests is
quarantined on every stream and a stream's probe reopens the routes too
(the JAX plane's ``stream_breaker_board``); otherwise through a board of
its own. It owns its telemetry and starts no threads. Each ingest is a
``stream_ingest`` span of the serving trace (``telemetry/serving.py``),
which the flush that drains its rows links back to; each flush feeds the
app's health ledger, and the plane's own board reports its breaker
transitions there too. :func:`stream_plane_section` is the fleet-status
document's ``stream`` section.

Admission is bounded: at most ``GORDO_TPU_STREAM_MAX_SESSIONS`` live
sessions (beyond that :class:`PlaneSaturated`, the route's 429), and a
session idle past ``GORDO_TPU_STREAM_SESSION_TTL_S`` is closed on the
next registry access. :meth:`StreamPlane.drain` puts a terminal ``drain``
frame into every live session and refuses new ones.
"""

import logging
import threading
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

from ..serve.breaker import BreakerBoard
from ..telemetry import serving as serve_trace
from ..telemetry.aggregate import histogram_percentile
from ..utils.env import env_bool, env_float, env_int
from ..utils.faults import FaultInjected, fault_point
from .events import StreamEvent
from .scorer import WindowScorer
from .session import StreamSession
from .telemetry import StreamTelemetry

logger = logging.getLogger(__name__)

STREAM_ENV = "GORDO_TPU_STREAM_ENABLED"


def stream_enabled() -> bool:
    """The plane's master switch (default on)."""
    return env_bool(STREAM_ENV, True)


class PlaneSaturated(Exception):
    """Session admission refused: the session cap (429) or a draining
    plane (503), with a retry hint."""

    def __init__(self, limit: int, retry_after_s: float, draining: bool = False):
        super().__init__("stream plane is draining" if draining else f"stream session limit reached ({limit})")
        self.limit = limit
        self.retry_after_s = retry_after_s
        self.draining = draining


class StreamConfig:
    """Plane knobs, resolved once from the environment at creation."""

    __slots__ = (
        "ring_rows",
        "window_rows",
        "outbox_events",
        "session_ttl_s",
        "heartbeat_s",
        "max_sessions",
        "shed_retry_s",
    )

    def __init__(
        self,
        ring_rows: int = 8192,
        window_rows: int = 64,
        outbox_events: int = 1024,
        session_ttl_s: float = 3600.0,
        heartbeat_s: float = 15.0,
        max_sessions: int = 64,
        shed_retry_s: float = 1.0,
    ):
        self.ring_rows = max(1, int(ring_rows))
        self.window_rows = max(1, int(window_rows))
        self.outbox_events = max(1, int(outbox_events))
        self.session_ttl_s = max(1.0, float(session_ttl_s))
        self.heartbeat_s = max(0.05, float(heartbeat_s))
        self.max_sessions = max(1, int(max_sessions))
        self.shed_retry_s = max(0.0, float(shed_retry_s))

    @classmethod
    def from_env(cls) -> "StreamConfig":
        return cls(
            ring_rows=env_int("GORDO_TPU_STREAM_RING_ROWS", 8192),
            window_rows=env_int("GORDO_TPU_STREAM_WINDOW_ROWS", 64),
            outbox_events=env_int("GORDO_TPU_STREAM_OUTBOX_EVENTS", 1024),
            session_ttl_s=env_float("GORDO_TPU_STREAM_SESSION_TTL_S", 3600.0),
            heartbeat_s=env_float("GORDO_TPU_STREAM_HEARTBEAT_S", 15.0),
            max_sessions=env_int("GORDO_TPU_STREAM_MAX_SESSIONS", 64),
            shed_retry_s=env_float("GORDO_TPU_STREAM_SHED_RETRY_S", 1.0),
        )


class StreamPlane:
    """Session registry, scorer, breakers and drain for one server app.
    ``store`` is the app's ``FleetModelStore``; ``breakers`` the board to
    quarantine through (default: a board of its own, whose transitions go
    to the ledger); ``ledger`` a zero-argument callable answering the
    health ledger the flushes feed (None: no feed)."""

    def __init__(self, store: Any, config: Optional[StreamConfig] = None, breakers: Optional[BreakerBoard] = None,
                 ledger: Optional[Callable[[], Any]] = None):
        self.store = store
        self.config = config or StreamConfig.from_env()
        self.ledger = ledger
        self.breakers = breakers or BreakerBoard(on_transition=self._on_breaker_transition)
        self.telemetry = StreamTelemetry()
        self.scorer = WindowScorer(self.config.window_rows, store, self.breakers, self.telemetry, ledger=ledger)
        self._lock = threading.Lock()
        self._sessions: Dict[Tuple[str, str], StreamSession] = {}
        self._drained = False
        self.counters: Dict[str, int] = {
            "sessions_opened": 0,
            "sessions_expired": 0,
            "sessions_rejected": 0,
            "ingest_batches": 0,
            "ingest_errors": 0,
        }

    def _on_breaker_transition(self, member: str, old: str, new: str, info: dict) -> None:
        """The plane's own board's transitions into the ledger, as the
        engine's are (a tripped member reaches the fleet status either way)."""
        if self.ledger is None:
            return
        try:
            self.ledger().record_breaker_transition(member, new, info)
        except Exception:  # noqa: BLE001 - the ledger is advisory
            logger.debug("stream breaker ledger feed failed", exc_info=True)

    def attach_drift(self, monitor: Any) -> None:
        """Feed every flush's scores into a lifecycle ``DriftMonitor``
        (``observe_scores(frames, scores)``): ``LifecycleSupervisor.attach_stream``
        calls this, so this package never imports the lifecycle."""
        self.scorer.drift_monitor = monitor

    # -- session registry ----------------------------------------------------

    def _prune_locked(self, now: float) -> None:
        # closed sessions stay as tombstones until the TTL, so a late
        # ingest gets a 410 and a late reconnect still finds the terminal
        # frame; they stop counting against the cap when they close
        ttl = self.config.session_ttl_s
        for key, session in list(self._sessions.items()):
            if now - session.last_used <= ttl:
                continue
            if not session.closed:
                session.close("end", reason="session expired (idle)")
                self.counters["sessions_expired"] += 1
            if session.subscribers == 0:
                del self._sessions[key]

    def session(self, project: str, stream_id: str, create: bool = True) -> Optional[StreamSession]:
        """Look up, or admit, one stream session. Raises
        :class:`PlaneSaturated` when admission would pass the session cap
        or the plane is draining; None for a miss with ``create=False``."""
        key = (project, stream_id)
        now = time.monotonic()
        with self._lock:
            self._prune_locked(now)
            session = self._sessions.get(key)
            if session is not None or not create:
                return session
            if self._drained:
                raise PlaneSaturated(0, self.config.shed_retry_s, draining=True)
            live = sum(1 for s in self._sessions.values() if not s.closed)
            if live >= self.config.max_sessions:
                self.counters["sessions_rejected"] += 1
                raise PlaneSaturated(self.config.max_sessions, self.config.shed_retry_s)
            session = StreamSession(
                project,
                stream_id,
                self.store.collection_dir,
                ring_rows=self.config.ring_rows,
                outbox_events=self.config.outbox_events,
            )
            self._sessions[key] = session
            self.counters["sessions_opened"] += 1
            return session

    def close_session(self, project: str, stream_id: str, reason: str = "closed by client") -> bool:
        with self._lock:
            session = self._sessions.get((project, stream_id))
        if session is None:
            return False
        session.close("end", reason=reason)
        return True

    # -- ingest --------------------------------------------------------------

    def ingest(
        self,
        session: StreamSession,
        frames: Dict[str, Any],
        errors: Optional[Dict[str, Dict[str, Any]]] = None,
    ) -> Dict[str, Any]:
        """Land decoded per-machine frames, run the watermark flush, and
        return the ack: accepted and shed rows, per-machine errors (the
        route's decode errors and ``stream_ingest`` fault hits), the flush
        summary and the consumer cursor."""
        errors = dict(errors or {})
        accepted: Dict[str, int] = {}
        shed: Dict[str, int] = {}
        with serve_trace.serve_recorder().span("stream_ingest", stream=session.stream_id,
                                               machines=len(frames)) as ingest_span:
            for name, frame in frames.items():
                try:
                    fault_point("stream_ingest", f"{session.stream_id}:{name}")
                except FaultInjected as exc:
                    # one poisoned entry errors alone; the others still land
                    errors[name] = {"error": str(exc), "status": 500}
                    continue
                _first_seq, shed_rows = session.append_rows(name, frame)
                accepted[name] = int(len(frame))
                if shed_rows:
                    shed[name] = shed_rows
            ingest_span.set(rows=sum(accepted.values()), shed=sum(shed.values()), errors=len(errors))
            # the flush that drains these rows links back to this span
            if ingest_span.span_id:
                session.note_ingest_span(ingest_span.trace_id, ingest_span.span_id)
        self.telemetry.observe_ingest(sum(accepted.values()))
        flush = self.scorer.flush(session)
        with self._lock:
            self.counters["ingest_batches"] += 1
            self.counters["ingest_errors"] += len(errors)
        ack: Dict[str, Any] = {
            "stream": session.stream_id,
            "accepted": accepted,
            "shed": shed,
            "errors": errors,
            "cursor": session.latest_seq(),
            "scored": flush["scored"],
            "score_errors": flush["errors"],
            "quarantined": flush["quarantined"],
            "backpressure": bool(shed),
        }
        if shed:
            ack["retry_after_s"] = self.config.shed_retry_s
        return ack

    # -- subscribe -----------------------------------------------------------

    def _quarantine_prelude(self, session: StreamSession) -> List[StreamEvent]:
        """One ``quarantined`` notice per session machine whose breaker is
        open or half-open, for a (re)connecting consumer. Read from the
        board's summary, so subscribing admits no probe."""
        machines = session.machine_names()
        if not machines:
            return []
        notices = []
        for member in self.breakers.summary(top_k=len(machines))["members"]:
            name = member.get("member")
            if name in machines and member.get("state") != "closed":
                notices.append(
                    StreamEvent(
                        "quarantined",
                        {"machine": name, "retry_after_s": member.get("cooldown_s"), "trips": member.get("trips")},
                    )
                )
        return notices

    def subscribe(
        self,
        session: StreamSession,
        cursor: int = 0,
        max_events: Optional[int] = None,
        idle_timeout_s: Optional[float] = None,
    ) -> Iterator[str]:
        """SSE frames for one consumer: ``open``, the quarantine prelude,
        replay from ``cursor`` and the live tail."""
        return session.subscribe(
            cursor=cursor,
            heartbeat_s=self.config.heartbeat_s,
            max_events=max_events,
            idle_timeout_s=idle_timeout_s,
            prelude=self._quarantine_prelude(session),
        )

    # -- shutdown ------------------------------------------------------------

    def drain(self) -> int:
        """A terminal ``drain`` frame into every live session, and no new
        sessions; returns how many sessions it closed. Idempotent."""
        with self._lock:
            self._drained = True
            sessions = list(self._sessions.values())
        closed = 0
        for session in sessions:
            if not session.closed:
                session.close("drain", reason="server draining")
                closed += 1
        if closed:
            logger.info("stream plane drained %d live session(s)", closed)
        return closed

    # -- introspection -------------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            sessions = dict(self._sessions)
            counters = dict(self.counters)
            drained = self._drained
        return {
            "enabled": stream_enabled(),
            "draining": drained,
            "sessions": {
                f"{project}/{stream_id}": session.stats() for (project, stream_id), session in sorted(sessions.items())
            },
            "counters": counters,
            "telemetry": self.telemetry.snapshot(),
            "config": {
                "ring_rows": self.config.ring_rows,
                "window_rows": self.config.window_rows,
                "outbox_events": self.config.outbox_events,
                "max_sessions": self.config.max_sessions,
            },
        }


def stream_plane_section(plane: Optional[StreamPlane]) -> Optional[Dict[str, Any]]:
    """The fleet-status document's ``stream`` section of ``plane``: session
    counts, the summed row accounting, freshness (score lag, watermark
    delay) and the flush and lag percentiles; None without a plane. The
    JAX function reads the process's installed plane; the caller passes
    the app's."""
    if plane is None:
        return None
    stats = plane.stats()
    sessions = stats.get("sessions") or {}
    active = [s for s in sessions.values() if not s.get("closed")]
    accounting = {key: 0 for key in ("rows_in", "rows_scored", "rows_failed", "rows_pending", "rows_shed", "gap")}
    quarantined = 0
    score_lags: List[float] = []
    delays: List[float] = []
    for session in sessions.values():
        for key in accounting:
            accounting[key] += int((session.get("accounting") or {}).get(key, 0))
        lag = session.get("lag") or {}
        if lag.get("score_lag_max_ms") is not None:
            score_lags.append(float(lag["score_lag_max_ms"]))
        if lag.get("watermark_delay_max_ms") is not None:
            delays.append(float(lag["watermark_delay_max_ms"]))
        quarantined += sum(1 for machine in (session.get("machines") or {}).values() if machine.get("quarantined"))
    telemetry = stats.get("telemetry") or {}
    return {
        "enabled": stats.get("enabled"),
        "draining": stats.get("draining"),
        "sessions_active": len(active),
        "sessions_closed": len(sessions) - len(active),
        "subscribers": sum(int(s.get("subscribers", 0)) for s in sessions.values()),
        "quarantined_machines": quarantined,
        "accounting": accounting,
        "lag": {
            "score_lag_max_ms": max(score_lags) if score_lags else None,
            "watermark_delay_max_ms": max(delays) if delays else None,
            "lag_p95_ms": histogram_percentile(telemetry.get("lag_ms") or {}, 0.95),
            "flush_p95_ms": histogram_percentile(telemetry.get("flush_ms") or {}, 0.95),
        },
        "flushes": int(telemetry.get("flushes", 0)),
        "counters": stats.get("counters"),
    }
