"""
The streaming scoring plane, a port of ``gordo_tpu/stream/``.

Rows stream in over repeated ingest POSTs and land in per-machine
bounded rings; each ingest cuts the full watermark windows and scores
them as one fused call per spec bucket (``RevisionFleet.fleet_scores``,
one K2 launch each); results flow out as server-sent events with
replayable cursors. Disconnects resume from a cursor, overflow sheds
oldest-first with counters, a failing member is quarantined by its
circuit breaker while the others keep scoring, and a drain ends every
stream with a terminal frame.

Master switch: ``GORDO_TPU_STREAM_ENABLED`` (default on).
"""

from .events import SSE_CONTENT_TYPE, TERMINAL_KINDS, StreamEvent, encode_sse, heartbeat_frame
from .plane import PlaneSaturated, StreamConfig, StreamPlane, stream_enabled, stream_plane_section
from .ring import EventRing, RowRing
from .scorer import WindowScorer
from .session import MachineChannel, StreamSession
from .telemetry import StreamTelemetry

__all__ = [
    "EventRing",
    "MachineChannel",
    "PlaneSaturated",
    "RowRing",
    "SSE_CONTENT_TYPE",
    "StreamConfig",
    "StreamEvent",
    "StreamPlane",
    "StreamSession",
    "StreamTelemetry",
    "TERMINAL_KINDS",
    "WindowScorer",
    "encode_sse",
    "heartbeat_frame",
    "stream_enabled",
    "stream_plane_section",
]
