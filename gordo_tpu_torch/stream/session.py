"""
Stream sessions, a copy of ``gordo_tpu/stream/session.py``: the
server-side half of one logical stream, which outlives any one HTTP
exchange.

Ingest POSTs land rows in the session's per-machine :class:`RowRing` s;
scored windows and control frames go to its :class:`EventRing` outbox;
any number of SSE subscriptions (a reconnect included) read the outbox
from a cursor. One lock per session guards all of it (``_wake``, a
Condition that also wakes subscribers), so the plane's locks form a
star: registry lock, then a session lock, never the reverse.

- **resume**: ``subscribe(cursor=N)`` replays retained events with
  ``seq > N``; if the outbox evicted past the cursor, a ``shed`` frame
  (scope ``outbox``) says how many events were missed.
- **backpressure**: both rings are bounded; ingest overflow sheds
  oldest-first with a ``shed`` (scope ``ring``) frame.
- **close**: :meth:`close` appends a terminal ``drain``/``end`` frame and
  wakes every subscriber; EOF without a terminal frame means the
  connection died.
"""

import threading
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple

from ..utils.faults import FaultInjected, fault_point
from .events import StreamEvent, encode_sse, heartbeat_frame
from .ring import EventRing, RowRing


class MachineChannel:
    """One machine's ring and counters inside a session
    (``rows_in == scored + failed + pending + shed`` is the zero-gap
    invariant)."""

    __slots__ = (
        "name",
        "ring",
        "rows_in",
        "rows_scored",
        "rows_failed",
        "windows_scored",
        "score_errors",
        "quarantine_notified",
        "last_score_lag_ms",
    )

    def __init__(self, name: str, ring_rows: int):
        self.name = name
        self.ring = RowRing(ring_rows)
        self.rows_in = 0
        self.rows_scored = 0
        self.rows_failed = 0
        self.windows_scored = 0
        self.score_errors = 0
        #: True between the ``quarantined`` frame and ``recovered``
        self.quarantine_notified = False
        #: ingest-to-scored lag of the latest flush
        self.last_score_lag_ms: Optional[float] = None

    def stats(self) -> Dict[str, Any]:
        oldest_ts = self.ring.oldest_ts
        return {
            "rows_in": self.rows_in,
            "rows_scored": self.rows_scored,
            "rows_failed": self.rows_failed,
            "rows_pending": self.ring.pending_rows,
            "rows_shed": self.ring.shed_rows,
            "windows_scored": self.windows_scored,
            "score_errors": self.score_errors,
            "quarantined": self.quarantine_notified,
            "last_score_lag_ms": self.last_score_lag_ms,
            "watermark_delay_ms": (
                None if oldest_ts is None else round(max(0.0, time.time() - oldest_ts) * 1000.0, 3)
            ),
        }


class StreamSession:
    """One stream id's rings, outbox and subscriber bookkeeping."""

    def __init__(self, project: str, stream_id: str, collection_dir: str, ring_rows: int, outbox_events: int):
        self.project = project
        self.stream_id = stream_id
        #: the served collection; the scorer routes it once per flush
        self.collection_dir = collection_dir
        self.ring_rows = ring_rows
        self._wake = threading.Condition()
        self.channels: Dict[str, MachineChannel] = {}
        self.outbox = EventRing(outbox_events)
        self.closed = False
        self.last_used = time.monotonic()
        self._subscribers = 0
        self.emit_dropped = 0
        #: emit-site drops not yet reported as a ``shed`` frame
        self._emit_shed_pending = 0
        #: ring-shed rows already reported by :meth:`shed_delta`
        self._shed_reported = 0
        #: (trace id, span id) of the ingests the next flush drains
        self._ingest_spans: List[Tuple[str, str]] = []

    # -- ingest side ---------------------------------------------------------

    def channel(self, name: str) -> MachineChannel:
        with self._wake:
            chan = self.channels.get(name)
            if chan is None:
                chan = self.channels[name] = MachineChannel(name, self.ring_rows)
            return chan

    def append_rows(self, name: str, frame: Any) -> Tuple[int, int]:
        """Land decoded rows for ``name``; returns ``(first_seq, shed)``
        and emits the ``shed`` frame when rows were shed."""
        with self._wake:
            chan = self.channels.get(name)
            if chan is None:
                chan = self.channels[name] = MachineChannel(name, self.ring_rows)
            first_seq, shed = chan.ring.append(frame)
            chan.rows_in += int(len(frame))
            self.last_used = time.monotonic()
        if shed:
            self.emit(
                StreamEvent(
                    "shed",
                    {"scope": "ring", "machine": name, "dropped": shed, "rows_shed_total": chan.ring.shed_rows},
                )
            )
        return first_seq, shed

    def shed_delta(self) -> int:
        """Ring-shed rows since the last call."""
        with self._wake:
            total = sum(chan.ring.shed_rows for chan in self.channels.values())
            delta = total - self._shed_reported
            self._shed_reported = total
            return max(0, delta)

    def note_ingest_span(self, trace_id: str, span_id: str) -> None:
        """An ingest span for the next flush to link back to (the oldest
        dropped past 64)."""
        with self._wake:
            self._ingest_spans.append((trace_id, span_id))
            if len(self._ingest_spans) > 64:
                del self._ingest_spans[:-64]

    def drain_ingest_spans(self) -> List[Tuple[str, str]]:
        """Take the ingest spans noted since the last flush."""
        with self._wake:
            spans, self._ingest_spans = self._ingest_spans, []
            return spans

    def latest_seq(self) -> int:
        """The cursor that catches everything emitted so far."""
        with self._wake:
            return self.outbox.latest_seq

    def machine_names(self) -> List[str]:
        with self._wake:
            return sorted(self.channels)

    def pending_machines(self, window_rows: int) -> List[str]:
        """Machines with at least one full window buffered, sorted."""
        with self._wake:
            return sorted(name for name, chan in self.channels.items() if chan.ring.pending_rows >= window_rows)

    def cut_windows(
        self,
        window_rows: int,
        skip: Sequence[str] = (),
        snap: Optional[Callable[[int], int]] = None,
    ) -> Dict[str, Tuple[List[Any], int, int, int, float]]:
        """Pop the full pending windows: ``{machine: (chunks, first_seq,
        last_seq, windows, oldest_ts)}``, a machine's windows as one
        contiguous span. Machines in ``skip`` (quarantined) keep their rows.
        ``snap`` (``pending_rows -> rows to cut``, whole windows) quantises
        a backlog onto the row ladder; the remainder rides the next flush."""
        out: Dict[str, Tuple[List[Any], int, int, int, float]] = {}
        with self._wake:
            for name, chan in self.channels.items():
                if name in skip:
                    continue
                pending = chan.ring.pending_rows
                if snap is not None:
                    take_rows = int(snap(pending))
                    take_rows -= take_rows % window_rows
                else:
                    take_rows = (pending // window_rows) * window_rows
                windows = take_rows // window_rows
                if windows <= 0:
                    continue
                taken = chan.ring.take(windows * window_rows)
                if taken is None:
                    continue
                chunks, first_seq, last_seq, oldest_ts = taken
                out[name] = (chunks, first_seq, last_seq, windows, oldest_ts)
        return out

    # -- emit side -----------------------------------------------------------

    def emit(self, event: StreamEvent) -> Optional[int]:
        """Append one event and wake subscribers. The ``stream_emit`` fault
        site can drop it (counted, reported by a later ``shed`` frame of
        scope ``emit``); an emit failure never reaches ingest or scoring."""
        try:
            fault_point("stream_emit", f"{self.stream_id}:{event.kind}")
        except FaultInjected:
            with self._wake:
                self.emit_dropped += 1
                self._emit_shed_pending += 1
            return None
        return self._append(event)

    def _append(self, event: StreamEvent) -> int:
        """The append without the fault site: terminal frames and shed
        notices use it, so a drill cannot suppress its own loss report."""
        with self._wake:
            if self._emit_shed_pending and event.kind != "shed":
                pending = self._emit_shed_pending
                self._emit_shed_pending = 0
                self.outbox.append(StreamEvent("shed", {"scope": "emit", "dropped": pending}))
            seq = self.outbox.append(event)
            self.last_used = time.monotonic()
            self._wake.notify_all()
            return seq

    def close(self, kind: str = "end", reason: str = "") -> None:
        """Terminal frame, closed flag, subscriber wakeup. The first close
        wins; later calls do nothing."""
        with self._wake:
            if self.closed:
                return
            self.closed = True
        self._append(StreamEvent(kind, {"reason": reason} if reason else {}))
        with self._wake:
            self._wake.notify_all()

    # -- subscribe side ------------------------------------------------------

    @property
    def subscribers(self) -> int:
        with self._wake:
            return self._subscribers

    def subscribe(
        self,
        cursor: int = 0,
        heartbeat_s: float = 15.0,
        max_events: Optional[int] = None,
        idle_timeout_s: Optional[float] = None,
        prelude: Sequence[StreamEvent] = (),
    ) -> Iterator[str]:
        """SSE frames from ``cursor`` until a terminal frame, or the
        optional ``max_events``/``idle_timeout_s`` bounds. First ``open``
        (no id), then ``prelude`` (no id), then replay and live tail.
        Waits are bounded by ``heartbeat_s``, and an idle wait yields a
        heartbeat comment."""
        with self._wake:
            self._subscribers += 1
            self.last_used = time.monotonic()
            latest = self.outbox.latest_seq
            closed = self.closed
        emitted = 0
        try:
            yield encode_sse(
                None,
                StreamEvent("open", {"stream": self.stream_id, "cursor": cursor, "latest_seq": latest, "closed": closed}),
            )
            for event in prelude:
                yield encode_sse(None, event)
            idle_since = time.monotonic()
            while True:
                with self._wake:
                    batch, missed = self.outbox.since(cursor)
                    if not batch and not self.closed:
                        self._wake.wait(timeout=heartbeat_s)
                        batch, missed = self.outbox.since(cursor)
                    session_closed = self.closed
                    pending_rows = sum(chan.ring.pending_rows for chan in self.channels.values())
                if missed:
                    yield encode_sse(None, StreamEvent("shed", {"scope": "outbox", "dropped": missed}))
                if not batch:
                    if session_closed:
                        return
                    if idle_timeout_s is not None and time.monotonic() - idle_since >= idle_timeout_s:
                        return
                    yield heartbeat_frame(cursor=cursor, pending_rows=pending_rows)
                    continue
                for seq, event in batch:
                    cursor = seq
                    yield encode_sse(seq, event)
                    emitted += 1
                    if event.terminal:
                        return
                    if max_events is not None and emitted >= max_events:
                        return
                idle_since = time.monotonic()
        finally:
            with self._wake:
                self._subscribers -= 1

    # -- introspection -------------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        with self._wake:
            machines = {name: chan.stats() for name, chan in self.channels.items()}
            lags = sorted(s["last_score_lag_ms"] for s in machines.values() if s["last_score_lag_ms"] is not None)
            delays = [s["watermark_delay_ms"] for s in machines.values() if s["watermark_delay_ms"] is not None]
            accounting = {
                key: sum(s[key] for s in machines.values())
                for key in ("rows_in", "rows_scored", "rows_failed", "rows_pending", "rows_shed")
            }
            # the zero-gap invariant, checked live: nonzero is a bug
            accounting["gap"] = accounting["rows_in"] - (
                accounting["rows_scored"] + accounting["rows_failed"]
                + accounting["rows_pending"] + accounting["rows_shed"]
            )
            return {
                "lag": {
                    "score_lag_p50_ms": lags[len(lags) // 2] if lags else None,
                    "score_lag_max_ms": lags[-1] if lags else None,
                    "watermark_delay_max_ms": max(delays) if delays else None,
                },
                "accounting": accounting,
                "stream": self.stream_id,
                "project": self.project,
                "closed": self.closed,
                "subscribers": self._subscribers,
                "latest_seq": self.outbox.latest_seq,
                "events_dropped_outbox": self.outbox.dropped,
                "events_dropped_emit": self.emit_dropped,
                "machines": machines,
            }
