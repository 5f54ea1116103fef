"""
The serving trace, ``serve_trace.jsonl``: a copy of
``gordo_tpu/telemetry/serving.py``.

A server answers many requests at once, so no one recorder wraps "the
work". Each request has an in-memory recorder (``RequestContext.timing``)
with the request's trace id; when the response is finished, its stage
spans and one synthesized ``request`` span go into the process-shared
recorder this module owns (:func:`serve_recorder`) in one queue append.
The serving engine and the streaming plane record their spans into the
same recorder, the engine's batch spans linked to the request spans they
coalesced.

The sink is ``$GORDO_TPU_TELEMETRY_DIR/serve_trace.jsonl``, asynchronous,
rotated by size
(``GORDO_TPU_TELEMETRY_MAX_BYTES``). With telemetry off
(``GORDO_TPU_TELEMETRY=0``) or no telemetry directory, everything here
answers :data:`~gordo_tpu_torch.telemetry.recorder.NULL_RECORDER` and no
file is made. ``GORDO_TPU_TRACE_SAMPLE_RATE`` (default 0.05) is the share
of locally started requests exported; every request still gets a trace id
and its ``Server-Timing``.

The JAX module also drops its recorder in a process forked from a server
(``register_postfork_reset``) and names each worker's sink
``serve_trace-<pid>.jsonl``; the port's server does not fork workers,
so there is no such hook and one plain sink.
"""

import atexit
import os
import random
import threading
from typing import Any, Dict, Optional

from ..utils.env import env_float, env_str
from .recorder import NULL_RECORDER, TRACE_DIR_ENV, SpanRecorder, enabled, rand_hex

#: the serving trace beside ``build_trace.jsonl``: request, stage, batch
#: and stream spans
SERVE_TRACE_FILE = "serve_trace.jsonl"
TRACE_SAMPLE_RATE_ENV = "GORDO_TPU_TRACE_SAMPLE_RATE"
DEFAULT_TRACE_SAMPLE_RATE = 0.05

_lock = threading.Lock()
_recorder: Optional[SpanRecorder] = None
_atexit_registered = False
#: (raw environment value, parsed rate): parsed again only when the value changes
_rate_cache: tuple = (None, DEFAULT_TRACE_SAMPLE_RATE)


def trace_sample_rate() -> float:
    """``GORDO_TPU_TRACE_SAMPLE_RATE`` clamped to [0, 1]."""
    global _rate_cache
    raw = os.environ.get(TRACE_SAMPLE_RATE_ENV)
    cached_raw, cached_rate = _rate_cache
    if raw == cached_raw:
        return cached_rate
    rate = min(1.0, max(0.0, env_float(TRACE_SAMPLE_RATE_ENV, DEFAULT_TRACE_SAMPLE_RATE)))
    _rate_cache = (raw, rate)
    return rate


def sample_trace() -> bool:
    """The head-sampling coin flip of a locally started trace."""
    rate = trace_sample_rate()
    if rate >= 1.0:
        return True
    if rate <= 0.0:
        return False
    return random.random() < rate


def serve_trace_path() -> Optional[str]:
    """Where the serving trace goes, or None when telemetry is off or no
    ``GORDO_TPU_TELEMETRY_DIR`` is set (a server has no output directory
    of its own to default to)."""
    trace_dir = env_str(TRACE_DIR_ENV, None)
    if not enabled() or not trace_dir:
        return None
    return os.path.join(trace_dir, SERVE_TRACE_FILE)


def serve_recorder() -> Any:
    """The process-shared serving recorder (made on first use, one a sink
    path), or :data:`NULL_RECORDER` when tracing is off; callers test
    ``.enabled`` to build nothing at all. Lock-free once made."""
    global _recorder, _atexit_registered
    path = serve_trace_path()
    if path is None:
        return NULL_RECORDER
    recorder = _recorder
    if recorder is not None and recorder.sink_path == path:
        return recorder
    with _lock:
        if _recorder is None or _recorder.sink_path != path:
            try:
                os.makedirs(os.path.dirname(path), exist_ok=True)
            except OSError:
                return NULL_RECORDER
            if _recorder is not None:
                _recorder.close()
            _recorder = SpanRecorder(sink_path=path, service="gordo-tpu-serve", async_sink=True)
            if not _atexit_registered:
                # the writer is a daemon thread: without this the last
                # queued spans would die with the interpreter
                _atexit_registered = True
                atexit.register(_close_at_exit)
        return _recorder


def _close_at_exit() -> None:
    with _lock:
        recorder = _recorder
    if recorder is not None:
        try:
            recorder.close()
        except Exception:  # noqa: BLE001 - the interpreter is going down
            pass


def reset_serve_recorder() -> None:
    """Close and drop the shared recorder (tests, reconfiguration)."""
    global _recorder
    with _lock:
        if _recorder is not None:
            _recorder.close()
        _recorder = None


def export_request_trace(
    timing: SpanRecorder,
    *,
    span_id: str,
    parent_id: Optional[str],
    start: float,
    duration_s: float,
    attributes: Dict[str, Any],
    error: Optional[str] = None,
    profile: Optional[dict] = None,
) -> None:
    """One finished request into the serving trace: its stage spans (on
    ``timing``, already in the request's trace under ``span_id``), one
    ``request`` span of the given interval (``ERROR`` with ``error``), and
    a ``profile`` span of the sampling profiler's report when the request
    was profiled. The request thread copies one list and appends to the
    queue; the ``request`` and ``profile`` dicts are built on the writer
    thread. Does nothing when the serving sink is off."""
    sink = serve_recorder()
    if not sink.enabled:
        return
    stage_spans = timing.finished()

    def build() -> list:
        end = start + max(0.0, duration_s)
        request_span = timing._span_dict("request", span_id, parent_id, start, end, attributes, None, kind="server")
        if error:
            request_span["status"] = {"status_code": "ERROR", "description": error}
        spans = stage_spans
        if profile:
            spans = spans + [timing._span_dict("profile", rand_hex(16), span_id,
                                               end - profile.get("duration_ms", 0.0) / 1000.0, end, profile, None)]
        return spans + [request_span]

    sink.emit_deferred(build)
