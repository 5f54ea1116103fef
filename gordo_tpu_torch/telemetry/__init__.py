"""
What the port records about itself (``gordo_tpu/telemetry/``):

- a fleet build: the span trace ``build_trace.jsonl`` (``recorder.py``),
  the live status ``build_status.json`` (``progress.py``), the card's
  memory and the programs' compile counters on ``device_utilization``
  events (``device.py``), and the fleet health ledger
  ``fleet_health.json`` (``fleet_health.py``);
- the server: W3C trace context (``tracing.py``), each request's stage
  times in ``Server-Timing``, the sampled requests' spans and the serving
  engine's and streaming plane's in ``serve_trace.jsonl``
  (``serving.py``), the host sampling profiler (``profiler.py``), the
  serving feeds of the health ledger, and the joined fleet-status
  document of ``fleet-status`` and ``/fleet-health``
  (``fleet_health.py``);
- what reads the traces back: the time-window rollups of every sink
  (``aggregate.py``), the SLO engine over them with its burn-rate alerts
  (``slo.py``, objectives in ``slos.toml``) and the trace analysis of the
  ``trace`` command (``trace_analysis.py``).

``GORDO_TPU_TELEMETRY=0`` turns all of it off but ``Server-Timing``.
"""

from .aggregate import ROLLUP_DIR, ROLLUP_STATE_FILE, RollupStore, summarize_rollup
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
    FLEET_STATUS_MAX_MACHINES,
    FLEET_STATUS_TOP_K,
    HEALTH_SHARDS_ENV,
    HEALTH_WINDOW_ROWS,
    NULL_LEDGER,
    FleetHealthLedger,
    NullLedger,
    breaker_tripped_machines,
    fleet_status_document,
    health_enabled,
    health_score,
    health_snapshot_paths,
    health_snapshot_units,
    ledger_for,
    ledger_summaries,
    live_serving_ledger,
    load_health,
    load_merged_health,
    machine_state,
    merge_health_documents,
    render_fleet_status,
    reset_ledgers,
    reset_serving_ledgers,
    serving_ledger,
    summarize,
)
from .profiler import SamplingProfiler, should_profile
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
    SpanHandle,
    SpanRecorder,
    activate,
    enabled,
    get_recorder,
    program_span,
    rand_hex,
    reset_seen_programs,
    is_worker_variant,
    seen_program,
)
from .serving import (
    SERVE_TRACE_FILE,
    TRACE_SAMPLE_RATE_ENV,
    export_request_trace,
    reset_serve_recorder,
    sample_trace,
    serve_recorder,
    serve_trace_path,
    trace_sample_rate,
)
from .slo import (
    SLO_CONFIG_FILE,
    SLO_STATE_FILE,
    SloConfig,
    SloSpec,
    evaluate_slos,
    firing_alerts,
    load_slo_config,
    render_slo_status,
)
from .tracing import (
    TRACEPARENT_HEADER,
    TraceContext,
    TraceIdFilter,
    current_trace_id,
    format_traceparent,
    install_trace_log_stamping,
    new_span_id,
    new_trace_context,
    new_trace_id,
    parse_traceparent,
)

__all__ = [
    "BUILD_STATUS_FILE", "BUILD_TRACE_FILE", "FLEET_HEALTH_ENV", "FLEET_HEALTH_FILE",
    "FLEET_HEALTH_SHARD_DIR", "ROLLUP_DIR", "ROLLUP_STATE_FILE", "RollupStore", "SLO_CONFIG_FILE", "SLO_STATE_FILE",
    "SloConfig", "SloSpec", "evaluate_slos", "firing_alerts", "load_slo_config", "render_slo_status",
    "summarize_rollup", "FLEET_STATUS_MAX_MACHINES", "FLEET_STATUS_TOP_K", "HEALTH_SHARDS_ENV",
    "HEALTH_WINDOW_ROWS", "HEARTBEAT_ENV", "KEEP_ENV", "MAX_BYTES_ENV", "NULL_LEDGER", "NULL_RECORDER",
    "SERVE_TRACE_FILE", "TELEMETRY_ENV", "TRACEPARENT_HEADER", "TRACE_DIR_ENV", "TRACE_SAMPLE_RATE_ENV",
    "BuildProgress", "FleetHealthLedger", "NullLedger", "NullRecorder", "SamplingProfiler",
    "SpanHandle", "SpanRecorder", "TraceContext", "TraceIdFilter", "activate",
    "breaker_tripped_machines", "current_trace_id", "emit_device_utilization", "enabled",
    "eta_seconds", "export_request_trace", "fleet_status_document", "format_traceparent", "get_recorder",
    "health_enabled", "health_score", "health_snapshot_paths", "health_snapshot_units", "install_trace_log_stamping",
    "is_worker_variant", "ledger_for", "ledger_summaries", "live_serving_ledger", "load_health", "load_merged_health", "load_status", "machine_state", "memory_snapshot",
    "merge_health_documents", "new_span_id", "new_trace_context", "new_trace_id", "note_program_execution",
    "parse_traceparent", "program_cache_counters", "program_span", "rand_hex", "render_fleet_status",
    "render_status", "reset_ledgers", "reset_program_counters", "reset_seen_programs", "reset_serve_recorder", "reset_serving_ledgers",
    "sample_trace",
    "seen_program", "serve_recorder", "serve_trace_path", "serving_ledger", "should_profile", "summarize", "trace_sample_rate",
    "utilization_snapshot",
]
