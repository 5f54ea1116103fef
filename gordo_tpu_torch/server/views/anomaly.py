"""
Anomaly route: ``POST /gordo/v0/<project>/<name>/anomaly/prediction``
(``gordo_tpu/server/views/anomaly.py``).

Body ``{"X": frame, "y": frame}``. The reconstruction runs on the device
through the compiled single-member path (one gather launch of the fleet
kernel, with the model's input scaling as its prologue); the threshold
and confidence math composes as numpy columns around it. ``y`` is
required (400); a model that is not a ``DiffBasedAnomalyDetector``
answers 422, as does one whose thresholds were never fitted.
"""

import logging
import timeit

from ...models.anomaly.diff import DiffBasedAnomalyDetector
from .. import wire
from ..app import Response, ServerError
from .base import extract_X_y

logger = logging.getLogger(__name__)


def _unprocessable(ctx, model) -> Response:
    return ctx.json_response(
        {"message": f"Model is not an AnomalyDetector, it is of type: {type(model)}"},
        status=422,
    )


def post_anomaly_prediction(ctx, gordo_project: str, gordo_name: str) -> Response:
    start = timeit.default_timer()
    try:
        resolution = ctx.resolve(gordo_name)
    except FileNotFoundError:
        raise ServerError(f"No such model found: '{gordo_name}'", status=404)
    X, y = extract_X_y(ctx.request, resolution)
    if y is None:
        raise ServerError("Cannot perform anomaly without 'y' to compare against.")
    model = resolution.model
    if not isinstance(model, DiffBasedAnomalyDetector):
        return _unprocessable(ctx, model)
    try:
        frequency = resolution.frequency
        output = ctx.store.fleet().predict(gordo_name, X.values)
        table = wire.anomaly_table(
            model,
            X,
            y,
            output,
            frequency=frequency,
            thresholds=resolution.feature_thresholds,
            aggregate=resolution.aggregate_threshold,
        )
    except AttributeError:
        return _unprocessable(ctx, model)
    except ValueError as err:
        logger.error("Failed to compute anomalies: %s", err)
        return ctx.json_response({"error": f"ValueError: {err}"}, status=400)
    extra = {"time-seconds": f"{timeit.default_timer() - start:.4f}", "revision": ctx.revision}
    return Response(wire.encode_response(table, extra))
