"""
Anomaly route: ``POST /gordo/v0/<project>/<name>/anomaly/prediction``
(``gordo_tpu/server/views/anomaly.py``).

Body ``{"X": frame, "y": frame}``. The reconstruction runs on the device
through the compiled single-member path (one gather launch of the fleet
kernel, with the model's input scaling as its prologue), or, with the
app's serving engine, coalesced with concurrent requests into one such
launch (its refusals: 429, 503, 500, 504); the threshold
and confidence math composes as numpy columns around it, with the
``smooth-*`` groups only under ``?all_columns``. ``y`` is required
(400); a model that is not a ``DiffBasedAnomalyDetector`` answers 422,
as does one whose thresholds were never fitted.

Its stages, as the JAX route's: ``model_resolve``, ``data_decode``,
``device_ingest`` (the rows' copy to the device; without an engine),
``inference`` (the launch and the copy back, or the engine's batch with
its ``queue_wait`` and ``batch_*`` shares), ``response_assemble`` (the
anomaly columns) and ``serialize``.
"""

import logging
import timeit

from ...models.anomaly.diff import DiffBasedAnomalyDetector
from ...serve import BatchShedError
from .. import model_io, utils, wire
from ..app import Response, ServerError
from ..wire import negotiate
from .base import encode_table_response, extract_X_y

logger = logging.getLogger(__name__)


def _unprocessable(ctx, model) -> Response:
    return ctx.json_response(
        {"message": f"Model is not an AnomalyDetector, it is of type: {type(model)}"},
        status=422,
    )


def post_anomaly_prediction(ctx, gordo_project: str, gordo_name: str) -> Response:
    start = timeit.default_timer()
    with ctx.stage("model_resolve"):
        resolution = utils.resolve_model(ctx, gordo_name)
    response_format = negotiate.response_format(ctx.request)  # before decoding and scoring
    with ctx.stage("data_decode"):
        X, y = extract_X_y(ctx.request, resolution, ctx)
    if y is None:
        raise ServerError("Cannot perform anomaly without 'y' to compare against.")
    model = resolution.model
    if not isinstance(model, DiffBasedAnomalyDetector):
        return _unprocessable(ctx, model)
    try:
        staged = None
        if ctx.app.engine is None:
            with ctx.stage("device_ingest"):
                staged = ctx.fleet().stage_input(gordo_name, model_io.request_rows(ctx, X))
        with ctx.stage("inference"):
            frequency = resolution.frequency
            output = None if staged is not None else model_io.batched_model_output(
                ctx, gordo_name, model, model_io.request_rows(ctx, X))
            if output is None:
                output = model_io.get_model_output(ctx, gordo_name, model_io.request_rows(ctx, X), staged)
        with ctx.stage("response_assemble"):
            table = wire.anomaly_table(
                model,
                X,
                y,
                output,
                frequency=frequency,
                thresholds=resolution.feature_thresholds,
                aggregate=resolution.aggregate_threshold,
                keep_smooth="all_columns" in ctx.request.args,
            )
    except BatchShedError as exc:
        return model_io.shed_response(ctx, exc)
    except AttributeError:
        return _unprocessable(ctx, model)
    except ValueError as err:
        logger.error("Failed to compute anomalies: %s", err)
        return ctx.json_response({"error": f"ValueError: {err}"}, status=400)
    return encode_table_response(ctx, response_format, table, {"time-seconds": f"{timeit.default_timer() - start:.4f}"})
