"""
Streaming-plane routes under ``/gordo/v0/<project>/stream/...``, a port
of ``gordo_tpu/server/views/stream.py``: the HTTP side of
:mod:`gordo_tpu_torch.stream`. A stream is a server-side session fed by
repeated ingest POSTs and read as one long-lived SSE response.

- ``POST .../stream/<stream_id>/ingest``: the JSON body
  ``{"X": {<machine>: frame}}``, or an Arrow container of one stream a
  machine (``Content-Type: application/vnd.apache.arrow.stream``,
  ``wire.pack_streams``; role ``y`` columns are ignored); rows land in the
  session's rings, the watermark flush scores, and the JSON ack reports
  accepted, shed, scored and quarantined rows per machine and the
  consumer ``cursor``.
- ``GET .../stream/<stream_id>/events``: ``text/event-stream``; resume
  with ``?cursor=<seq>`` or the ``Last-Event-ID`` header;
  ``?max_events=`` and ``?idle_timeout_s=`` bound the response.
- ``GET .../stream/status``: every session's counters.
- ``DELETE .../stream/<stream_id>``: close with a terminal ``end`` frame.

Statuses: 503 streaming disabled or the plane draining, 429 the session
cap (both with ``Retry-After``), 410 ingest into a closed stream, 400 a
malformed body, 404 closing an unknown stream.
"""

import re
from typing import Any, Dict

from ...stream import SSE_CONTENT_TYPE, PlaneSaturated, stream_enabled
from .. import wire
from ..app import Response, ServerError
from ..wire import negotiate
from .base import arrow_container, arrow_frames, decode_machines

_STREAM_ID = re.compile(r"^[A-Za-z0-9][A-Za-z0-9._-]{0,127}$")


def _validate_stream_id(stream_id: str) -> None:
    if not _STREAM_ID.match(stream_id):
        raise ServerError("Invalid stream id: letters, digits, '.', '_', '-' (max 128 chars).", status=400)


def _require_plane(ctx):
    plane = ctx.app.ensure_plane()
    if plane is None:
        raise ServerError("Streaming is disabled (GORDO_TPU_STREAM_ENABLED=0)", status=503)
    return plane


def _open_session(ctx, plane, gordo_project: str, stream_id: str):
    """``(session, None)`` on admission, ``(None, response)`` when the
    plane refuses: 429 at the session cap, 503 while draining."""
    try:
        return plane.session(gordo_project, stream_id), None
    except PlaneSaturated as exc:
        response = ctx.json_response(
            {"error": str(exc), "retry_after_s": exc.retry_after_s}, status=503 if exc.draining else 429
        )
        response.headers["Retry-After"] = str(max(1, int(round(exc.retry_after_s))))
        return None, response


def _decode_stream_body(ctx, frames: Dict[str, wire.Frame], errors: Dict[str, Dict[str, Any]]) -> None:
    """Decode each machine's frame, aligned with its model's tags, from an
    Arrow container or a JSON body; a bad entry errors alone in the ack
    (``gordo_tpu/server/views/stream.py:100-146``)."""
    if negotiate.request_format(ctx.request) == negotiate.ARROW:
        streams, _ = arrow_container(ctx, "Stream ingest")
        decoded = decode_machines(ctx, streams, lambda _, payload, resolution: arrow_frames(
            payload, resolution, with_y=False)[0], errors)
    else:
        body = ctx.request.json()
        if not isinstance(body, dict) or not isinstance(body.get("X"), dict) or not body["X"]:
            raise ServerError('Stream ingest needs an Arrow container or a JSON body {"X": {<model-name>: frame}}')
        decoded = decode_machines(
            ctx, body["X"], lambda _, payload, resolution: wire.verify_frame(wire.decode_frame(payload),
                                                                             resolution.tag_names), errors)
    for name, (frame, _) in decoded.items():
        frames[name] = frame


def post_stream_ingest(ctx, gordo_project: str, stream_id: str) -> Response:
    """Land one batch of rows on a stream and run the watermark flush;
    answers the JSON ingest ack."""
    _validate_stream_id(stream_id)
    plane = _require_plane(ctx)
    session, rejected = _open_session(ctx, plane, gordo_project, stream_id)
    if rejected is not None:
        return rejected
    if session.closed:
        return ctx.json_response({"error": f"Stream '{stream_id}' is closed"}, status=410)
    frames: Dict[str, wire.Frame] = {}
    errors: Dict[str, Dict[str, Any]] = {}
    with ctx.stage("data_decode"):
        _decode_stream_body(ctx, frames, errors)
    with ctx.stage("inference"):  # the watermark flush: a K2 launch a spec bucket
        ack = plane.ingest(session, frames, errors)
    return ctx.json_response(ack, status=200 if (ack["accepted"] or not ack["errors"]) else 400)


def get_stream_events(ctx, gordo_project: str, stream_id: str) -> Response:
    """The SSE feed of one stream."""
    _validate_stream_id(stream_id)
    plane = _require_plane(ctx)
    session, rejected = _open_session(ctx, plane, gordo_project, stream_id)
    if rejected is not None:
        return rejected
    request = ctx.request

    def arg(name: str):
        values = request.args.get(name)
        return values[0] if values else None

    def int_arg(name: str, header: str = "") -> int:
        raw = arg(name) or (request.header(header) if header else None)
        try:
            return max(0, int(raw)) if raw else 0
        except (TypeError, ValueError):
            raise ServerError(f"'{name}' must be an integer", status=400)

    cursor = int_arg("cursor", "Last-Event-ID")
    max_events = int_arg("max_events") or None
    idle_raw = arg("idle_timeout_s")
    try:
        idle_timeout_s = float(idle_raw) if idle_raw else None
    except ValueError:
        raise ServerError("'idle_timeout_s' must be a number", status=400)
    body = plane.subscribe(session, cursor=cursor, max_events=max_events, idle_timeout_s=idle_timeout_s)
    # never cached, never buffered by a proxy
    return Response(body, 200, SSE_CONTENT_TYPE, {"Cache-Control": "no-cache", "X-Accel-Buffering": "no"})


def get_stream_status(ctx, gordo_project: str) -> Response:
    """Every session's counters."""
    plane = ctx.app.plane
    if plane is None:
        return ctx.json_response({"enabled": stream_enabled(), "sessions": {}})
    return ctx.json_response(plane.stats())


def delete_stream(ctx, gordo_project: str, stream_id: str) -> Response:
    """Close a stream with a terminal ``end`` frame."""
    _validate_stream_id(stream_id)
    plane = ctx.app.plane
    closed = bool(plane and plane.close_session(gordo_project, stream_id))
    return ctx.json_response({"stream": stream_id, "closed": closed}, status=200 if closed else 404)
