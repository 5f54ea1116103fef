"""
W3C Trace Context for the serving path, a copy of
``gordo_tpu/telemetry/tracing.py``.

Every request has a trace identity: the server continues an incoming
``traceparent`` header (a gateway's trace flows through it) or starts a
fresh one, threads it through the request's stage spans and the serving
engine (batch spans link back to the request spans they coalesced),
echoes it on the response, and binds it to log lines.

>>> ctx = parse_traceparent("00-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-01")
>>> ctx.trace_id
'0af7651916cd43dd8448eb211c80319c'
>>> format_traceparent(ctx.trace_id, ctx.span_id)
'00-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-01'
>>> parse_traceparent("not-a-traceparent") is None
True
"""

import contextvars
import logging
import re
from typing import NamedTuple, Optional

from .recorder import rand_hex

TRACEPARENT_HEADER = "traceparent"

#: version "00": a 16-byte trace id, an 8-byte parent span id and flags,
#: lowercase hex; all-zero ids are invalid
_TRACEPARENT_RE = re.compile(r"^00-(?P<trace_id>[0-9a-f]{32})-(?P<span_id>[0-9a-f]{16})-(?P<flags>[0-9a-f]{2})$")


class TraceContext(NamedTuple):
    """A parsed ``traceparent``: the trace id, the caller's span id, and
    whether the caller sampled the trace (flags bit 0; a sampled upstream
    trace is always exported)."""

    trace_id: str
    span_id: str
    sampled: bool = True


def new_trace_id() -> str:
    """A fresh 16-byte (32 hex characters) trace id."""
    return rand_hex(32)


def new_span_id() -> str:
    """A fresh 8-byte (16 hex characters) span id."""
    return rand_hex(16)


def new_trace_context() -> TraceContext:
    """A fresh (trace id, span id) pair from one draw of randomness."""
    both = rand_hex(48)
    return TraceContext(both[:32], both[32:], True)


def parse_traceparent(header: Optional[str]) -> Optional[TraceContext]:
    """The context of a version-00 ``traceparent`` header, or None for
    anything malformed (the request then starts a fresh trace)."""
    if not header:
        return None
    match = _TRACEPARENT_RE.match(header.strip().lower())
    if match is None:
        return None
    trace_id, span_id = match.group("trace_id"), match.group("span_id")
    if trace_id == "0" * 32 or span_id == "0" * 16:
        return None
    return TraceContext(trace_id, span_id, bool(int(match.group("flags"), 16) & 0x01))


def format_traceparent(trace_id: str, span_id: str, sampled: bool = True) -> str:
    """The version-00 ``traceparent`` of this trace and span."""
    return f"00-{trace_id}-{span_id}-{'01' if sampled else '00'}"


# -- log correlation ---------------------------------------------------------

#: the trace id bound to the current context; threads a request starts do
#: not inherit it (the engine's dispatcher logs its own spans' ids)
_current_trace_id: "contextvars.ContextVar[str]" = contextvars.ContextVar("gordo_tpu_trace_id", default="")


def current_trace_id() -> str:
    """The trace id bound to this context ("" outside a request)."""
    return _current_trace_id.get()


def bind(trace_id: str):
    """Bind ``trace_id`` as the current trace; returns the token for
    :func:`unbind`."""
    return _current_trace_id.set(trace_id)


def unbind(token) -> None:
    _current_trace_id.reset(token)


class TraceIdFilter(logging.Filter):
    """A logging filter that puts the bound trace id on every record as
    ``record.trace_id`` ("-" outside a request), for formats that name
    ``%(trace_id)s``."""

    def filter(self, record: logging.LogRecord) -> bool:
        record.trace_id = current_trace_id() or "-"
        return True


_factory_installed = False


def install_trace_log_stamping() -> None:
    """Stamp the bound trace id into every log record made in a request,
    process-wide, once: a log-record factory (filters do not reach child
    loggers) that sets ``record.trace_id`` and appends ``trace_id=<id>``
    to the message (outside a request, ``-`` unless a factory it wraps
    stamped its own). ``build_app`` calls it; idempotent."""
    global _factory_installed
    if _factory_installed:
        return
    _factory_installed = True
    previous_factory = logging.getLogRecordFactory()

    def factory(*args, **kwargs):
        record = previous_factory(*args, **kwargs)
        trace_id = current_trace_id()
        if trace_id:
            record.trace_id = trace_id
            record.msg = f"{record.msg} trace_id={trace_id}"
        elif not hasattr(record, "trace_id"):
            # a factory beneath this one (another tracer in the process) may have stamped its own
            record.trace_id = "-"
        return record

    logging.setLogRecordFactory(factory)
