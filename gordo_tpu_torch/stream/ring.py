"""
Bounded, sequence-numbered ring buffers, a copy of
``gordo_tpu/stream/ring.py``.

- :class:`RowRing`: one machine's ingest side. Rows land with 1-based
  row sequence numbers that never reset, wait for the watermark, and
  overflow sheds oldest-first with a count.
- :class:`EventRing`: a session's outbox. Events get 1-based sequence
  numbers; a reader replays ``since(cursor)`` and learns how many
  events were evicted past its cursor.

Neither ring locks: the owning session serialises access.

>>> ring = EventRing(capacity=2)
>>> ring.append("a"), ring.append("b"), ring.append("c")
(1, 2, 3)
>>> events, missed = ring.since(0)   # "a" was evicted: 1 missed
>>> [seq for seq, _ in events], missed
([2, 3], 1)
"""

import time
from collections import deque
from typing import Any, Deque, List, Optional, Tuple


class RowRing:
    """Bounded buffer of row chunks with per-row sequence numbers.

    A chunk is anything with ``len`` and row slicing by ``chunk[a:b]``:
    the server's decoded ``json_codec.Frame`` (numpy rows) or a list.
    Every chunk keeps the wall-clock instant it landed (``ingest_ts``),
    across partial sheds and takes, for the ingest-to-scored lag.
    """

    __slots__ = ("capacity", "_chunks", "_pending", "_next_seq", "shed_rows")

    def __init__(self, capacity: int):
        self.capacity = max(1, int(capacity))
        #: (first_seq, ingest_ts, chunk) in arrival order
        self._chunks: Deque[Tuple[int, float, Any]] = deque()
        self._pending = 0
        self._next_seq = 1
        self.shed_rows = 0

    @property
    def pending_rows(self) -> int:
        return self._pending

    @property
    def next_seq(self) -> int:
        """The sequence number the next appended row gets."""
        return self._next_seq

    @property
    def oldest_ts(self) -> Optional[float]:
        """Ingest wall-clock of the oldest buffered row (None if empty)."""
        return self._chunks[0][1] if self._chunks else None

    def append(self, chunk: Any, ingest_ts: Optional[float] = None) -> Tuple[int, int]:
        """Land ``chunk``; returns ``(first_seq, rows_shed)``. When the
        ring would exceed its capacity the oldest rows go first; a chunk
        taller than the ring keeps only its newest ``capacity`` rows."""
        rows = int(len(chunk))
        first_seq = self._next_seq
        if ingest_ts is None:
            ingest_ts = time.time()
        if rows == 0:
            return first_seq, 0
        shed = 0
        if rows >= self.capacity:
            shed += self._pending
            self._chunks.clear()
            self._pending = 0
            overflow = rows - self.capacity
            if overflow:
                shed += overflow
                chunk = chunk[overflow:]
            self._next_seq += rows
            self._chunks.append((self._next_seq - self.capacity, ingest_ts, chunk))
            self._pending = self.capacity
            self.shed_rows += shed
            return first_seq, shed
        self._next_seq += rows
        self._chunks.append((first_seq, ingest_ts, chunk))
        self._pending += rows
        while self._pending > self.capacity:
            over = self._pending - self.capacity
            oldest_seq, oldest_ts, oldest = self._chunks[0]
            if len(oldest) <= over:
                self._chunks.popleft()
                self._pending -= len(oldest)
                shed += len(oldest)
            else:
                self._chunks[0] = (oldest_seq + over, oldest_ts, oldest[over:])
                self._pending -= over
                shed += over
        self.shed_rows += shed
        return first_seq, shed

    def take(self, rows: int) -> Optional[Tuple[List[Any], int, int, float]]:
        """Pop the oldest ``rows`` rows, or None if fewer are pending:
        ``(chunks, first_seq, last_seq, oldest_ts)``, the chunks in order."""
        rows = int(rows)
        if rows <= 0 or self._pending < rows:
            return None
        first_seq = self._chunks[0][0]
        oldest_ts = self._chunks[0][1]
        out: List[Any] = []
        needed = rows
        while needed > 0:
            chunk_seq, chunk_ts, chunk = self._chunks.popleft()
            if len(chunk) <= needed:
                out.append(chunk)
                needed -= len(chunk)
                self._pending -= len(chunk)
            else:
                out.append(chunk[:needed])
                self._chunks.appendleft((chunk_seq + needed, chunk_ts, chunk[needed:]))
                self._pending -= needed
                needed = 0
        return out, first_seq, first_seq + rows - 1, oldest_ts


class EventRing:
    """Bounded event log with 1-based sequence numbers and cursor replay."""

    __slots__ = ("capacity", "_events", "_latest", "dropped")

    def __init__(self, capacity: int):
        self.capacity = max(1, int(capacity))
        #: (seq, event), seq contiguous within the deque
        self._events: Deque[Tuple[int, Any]] = deque()
        self._latest = 0
        self.dropped = 0

    @property
    def latest_seq(self) -> int:
        return self._latest

    @property
    def oldest_seq(self) -> int:
        """Sequence of the oldest retained event (0 when empty)."""
        return self._events[0][0] if self._events else 0

    def append(self, event: Any) -> int:
        self._latest += 1
        self._events.append((self._latest, event))
        while len(self._events) > self.capacity:
            self._events.popleft()
            self.dropped += 1
        return self._latest

    def since(self, cursor: int) -> Tuple[List[Tuple[int, Any]], int]:
        """Retained events with ``seq > cursor``, and how many such events
        were already evicted (the reader's gap)."""
        cursor = max(0, int(cursor))
        if cursor >= self._latest:
            return [], 0
        oldest = self.oldest_seq
        missed = max(0, oldest - cursor - 1) if self._events else self._latest - cursor
        return [entry for entry in self._events if entry[0] > cursor], missed
