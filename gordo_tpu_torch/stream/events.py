"""
The streaming plane's event vocabulary and its SSE encoding, a copy of
``gordo_tpu/stream/events.py``: the same bytes for the same event.

Every event a consumer sees has an ``id:`` (the session's outbox
sequence number, the reconnect cursor), an ``event:`` kind and a
one-line JSON ``data:`` payload. Kinds:

=========== ===========================================================
open        first frame of every subscription (cursor, latest seq)
anomaly     a scored window: machine, ``first_seq``/``last_seq`` row
            span, rows, windows, ``mse_mean``/``mse_max``, revision
shed        oldest-first drops: ``scope`` ``ring`` (ingest rows),
            ``outbox`` (events a consumer missed) or ``emit`` (events
            dropped at the emit fault site), with the count
quarantined a member's breaker is open; ``retry_after_s`` says when the
            next probe may run; the other machines keep scoring
recovered   a quarantined member scored cleanly again
error       one machine's window failed to score
drain       terminal: the server is shutting down
end         terminal: the stream was closed (client DELETE, idle TTL)
=========== ===========================================================

Idle subscriptions also get heartbeat comment frames
(``: keep-alive {"cursor": N, "pending": R}``), which carry no ``id:``.

>>> print(encode_sse(3, StreamEvent("anomaly", {"machine": "m-1", "rows": 4})), end="")
id: 3
event: anomaly
data: {"machine": "m-1", "rows": 4}
<BLANKLINE>
"""

import json
from typing import Any, Dict, Optional

SSE_CONTENT_TYPE = "text/event-stream"

#: kinds after which a subscription ends
TERMINAL_KINDS = ("drain", "end")


class StreamEvent:
    """One emitted frame: a ``kind`` from the table above and its JSON
    payload. The session's outbox assigns the sequence number."""

    __slots__ = ("kind", "data")

    def __init__(self, kind: str, data: Optional[Dict[str, Any]] = None):
        self.kind = kind
        self.data = data or {}

    @property
    def terminal(self) -> bool:
        return self.kind in TERMINAL_KINDS

    def __repr__(self) -> str:
        return f"StreamEvent({self.kind!r}, {self.data!r})"


def encode_sse(seq: Optional[int], event: StreamEvent) -> str:
    """One wire frame: ``id``/``event``/``data`` lines and a blank line.
    ``seq=None`` leaves out the ``id:`` line (subscription-local frames:
    ``open`` and replayed quarantine notices)."""
    payload = json.dumps(event.data, separators=(", ", ": "), default=str)
    head = f"id: {seq}\n" if seq is not None else ""
    return f"{head}event: {event.kind}\ndata: {payload}\n\n"


def heartbeat_frame(cursor: Optional[int] = None, pending_rows: Optional[int] = None) -> str:
    """An SSE comment frame that keeps an idle connection alive, with the
    subscriber's cursor and the rings' pending rows when known."""
    if cursor is None and pending_rows is None:
        return ": keep-alive\n\n"
    payload = json.dumps({"cursor": cursor, "pending": pending_rows}, separators=(", ", ": "))
    return f": keep-alive {payload}\n\n"
