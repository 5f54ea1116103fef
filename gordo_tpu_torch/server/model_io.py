"""
Model invocation for the scoring routes, and their glue to the serving
engine: a copy of ``gordo_tpu/server/model_io.py``'s
``get_model_output``, ``batched_model_output`` and ``shed_response``.

The port's unbatched reconstruction is the store's single-member path
(one K1 gather launch with the model's ingest plan), so
:func:`get_model_output` goes through the request's fleet; a route stages
the rows on the device first (``RevisionFleet.stage_input``, its
``device_ingest`` stage: ``ingest.to_device`` of :func:`request_rows`,
the request's decoded columns when an Arrow or parquet decode kept them)
and launches in its ``inference`` stage. The engine's items carry the
same rows (:func:`batched_model_output`). The JAX
package's ``accepts_model_output`` is not ported: the port's anomaly
route always composes the frame from the reconstruction
(``wire.anomaly_table``), never through a detector's ``anomaly()``.
"""

from typing import Any, Optional

import numpy as np

from ..serve import MemberQuarantined, QueueFullError, ServeDeviceError


def request_rows(ctx, X: Any) -> Any:
    """What a route scores: the request's decoded X columns when the Arrow
    or parquet decode kept them (``ctx.ingest``, never stacked on the
    host), else the frame's ``values``."""
    return ctx.ingest if ctx.ingest is not None else X.values


def get_model_output(ctx, gordo_name: str, X: Any, staged: Any = None) -> np.ndarray:
    """The model's reconstruction of raw rows ``X`` (of ``staged``, when
    they are on the device already) through the request's revision fleet:
    one K1 gather launch, or the windowed forward for an LSTM, and the
    copy back. ``ValueError`` for rows the model cannot take,
    ``TypeError`` for a model that holds no autoencoder."""
    if staged is not None:
        return ctx.fleet().predict_staged(staged)
    return ctx.fleet().predict(gordo_name, X)


def batched_model_output(ctx, gordo_name: str, model: Any, X: Any) -> Optional[np.ndarray]:
    """The engine's reconstruction of one request, or None when the app
    has no engine or the request is not batchable (the caller then calls
    :func:`get_model_output`). The engine's refusals propagate; the route
    answers them with :func:`shed_response`."""
    engine = ctx.app.engine
    if engine is None:
        return None
    return engine.batched_predict(ctx.fleet(), gordo_name, model, X, timing=ctx.timing)


def shed_response(ctx, exc: Exception):
    """The response to an engine refusal:

    - 429 with ``Retry-After``: the batch queue is full;
    - 503 with ``Retry-After``: the member's circuit breaker is open (the
      header is the breaker's remaining cooldown);
    - 500: the device forward failed for this member after the engine
      isolated it (its riders answered 200); the text never echoes the
      device's error;
    - 504: the request missed its batching deadline.
    """
    if isinstance(exc, QueueFullError):
        response = ctx.json_response({"error": "Server overloaded: batch queue full, retry later."}, status=429)
        response.headers["Retry-After"] = str(max(1, int(round(exc.retry_after_s))))
        return response
    if isinstance(exc, MemberQuarantined):
        response = ctx.json_response(
            {"error": "Model is quarantined after repeated device failures; retry later."}, status=503
        )
        response.headers["Retry-After"] = str(max(1, int(round(exc.retry_after_s))))
        return response
    if isinstance(exc, ServeDeviceError):
        return ctx.json_response({"error": "Device scoring failed for this model."}, status=500)
    return ctx.json_response({"error": "Request timed out waiting for its batch."}, status=504)
