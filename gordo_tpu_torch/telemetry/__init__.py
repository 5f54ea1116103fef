"""
What a fleet build writes about itself beside its machines
(``gordo_tpu/telemetry/``, the build side): the span trace
``build_trace.jsonl`` (``recorder.py``), the live status
``build_status.json`` (``progress.py``), the card's memory and the
programs' compile counters on ``device_utilization`` events
(``device.py``), and the fleet health ledger ``fleet_health.json``
(``fleet_health.py``). ``GORDO_TPU_TELEMETRY=0`` turns all of it off.
"""

from .device import (
    emit_device_utilization,
    memory_snapshot,
    note_program_execution,
    program_cache_counters,
    reset_program_counters,
    utilization_snapshot,
)
from .fleet_health import (
    FLEET_HEALTH_ENV,
    FLEET_HEALTH_FILE,
    FLEET_HEALTH_SHARD_DIR,
    HEALTH_SHARDS_ENV,
    NULL_LEDGER,
    FleetHealthLedger,
    health_enabled,
    health_score,
    ledger_for,
    load_health,
    machine_state,
    summarize,
)
from .progress import (
    BUILD_STATUS_FILE,
    BUILD_TRACE_FILE,
    HEARTBEAT_ENV,
    BuildProgress,
    eta_seconds,
    load_status,
    render_status,
)
from .recorder import (
    KEEP_ENV,
    MAX_BYTES_ENV,
    NULL_RECORDER,
    TELEMETRY_ENV,
    TRACE_DIR_ENV,
    NullRecorder,
    SpanRecorder,
    activate,
    enabled,
    get_recorder,
    program_span,
    reset_seen_programs,
    seen_program,
)

__all__ = [
    "BUILD_STATUS_FILE", "BUILD_TRACE_FILE", "FLEET_HEALTH_ENV", "FLEET_HEALTH_FILE",
    "FLEET_HEALTH_SHARD_DIR", "HEALTH_SHARDS_ENV", "HEARTBEAT_ENV", "KEEP_ENV", "MAX_BYTES_ENV", "NULL_LEDGER",
    "NULL_RECORDER", "TELEMETRY_ENV", "TRACE_DIR_ENV", "BuildProgress", "FleetHealthLedger", "NullRecorder",
    "SpanRecorder", "activate", "emit_device_utilization", "enabled", "eta_seconds",
    "get_recorder", "health_enabled", "health_score", "ledger_for", "load_health", "load_status", "machine_state",
    "memory_snapshot", "note_program_execution", "program_cache_counters", "program_span", "render_status",
    "reset_program_counters", "reset_seen_programs", "seen_program", "summarize", "utilization_snapshot",
]
