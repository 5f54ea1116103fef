"""
Base routes: the healthcheck and the fleet route
``POST /gordo/v0/<project>/prediction/fleet``
(``gordo_tpu/server/views/base.py``).

The fleet route scores many models in one request, body ``{"X": {name:
frame}, "y"?: {name: frame}, "full"?: bool}``: models sharing a spec are
scored by one kernel launch over their bucket. Each machine answers the
lean entry (``model-output`` and the per-row ``total-anomaly-unscaled``)
or, with ``?full``, a detector's whole anomaly frame. Per-machine
problems become entries of ``errors``, never the whole batch's failure.
"""

import logging
from typing import Any, Dict, Optional, Tuple

import numpy as np

from ...models.anomaly.diff import DiffBasedAnomalyDetector
from .. import wire
from ..app import Response, ServerError
from ..fleet_store import ModelResolution

logger = logging.getLogger(__name__)


def get_healthcheck(ctx) -> Response:
    return Response(b"", 200, "text/plain")


def extract_X_y(request, resolution: ModelResolution) -> Tuple[wire.Frame, Optional[wire.Frame]]:
    """``X`` (and ``y`` when sent) from a ``{"X": frame, "y": frame}`` body,
    aligned with the model's tags; 400 on anything unreadable."""
    body = request.json()
    if not isinstance(body, dict) or "X" not in body:
        raise ServerError('Cannot predict without "X"')
    try:
        X = wire.verify_frame(wire.decode_frame(body["X"]), resolution.tag_names)
        y = body.get("y")
        if y is not None:
            y = wire.verify_frame(wire.decode_frame(y), resolution.target_names)
    except wire.FrameError as exc:
        raise ServerError(str(exc), status=400)
    return X, y


def _score_error(name: str, exc: Exception) -> Dict[str, Any]:
    """A fleet scoring failure as the route's per-machine error entry."""
    if isinstance(exc, FileNotFoundError):
        return {"error": f"No such model found: '{name}'", "status": 404}
    if isinstance(exc, ValueError):
        return {"error": f"Scoring failed (ValueError: {exc})", "status": 400}
    if isinstance(exc, TypeError):
        return {"error": "Something unexpected happened; check your input data", "status": 400}
    return {"error": f"Scoring failed ({type(exc).__name__})", "status": 500}


def _full_entry(resolution: ModelResolution, X, y, recon) -> Tuple[Optional[str], Optional[dict]]:
    """One detector's whole anomaly frame as an encoded entry, or
    ``(None, None)`` for a model that is not a detector."""
    model = resolution.model
    if not isinstance(model, DiffBasedAnomalyDetector):
        return None, None
    try:
        frequency = resolution.frequency
    except ValueError:
        frequency = None
    try:
        table = wire.anomaly_table(model, X, y, recon, frequency=frequency)
    except AttributeError:
        return None, {"error": "Model has no thresholds (require_thresholds unmet)", "status": 422}
    except ValueError as exc:
        return None, {"error": f"ValueError: {exc}", "status": 400}
    return "".join(wire.encode_table(table)), None


def post_fleet_prediction(ctx, gordo_project: str) -> Response:
    body = ctx.request.json()
    if not isinstance(body, dict) or not isinstance(body.get("X"), dict) or not body["X"]:
        raise ServerError('Fleet prediction needs a JSON body {"X": {<model-name>: frame}}')
    full = "full" in ctx.request.args or bool(body.get("full"))
    y_payloads = body.get("y") if isinstance(body.get("y"), dict) else {}

    frames: Dict[str, wire.Frame] = {}
    y_frames: Dict[str, wire.Frame] = {}
    resolutions: Dict[str, ModelResolution] = {}
    errors: Dict[str, Dict[str, Any]] = {}
    for name, payload in body["X"].items():
        try:
            resolution = ctx.resolve(name)
            X = wire.verify_frame(wire.decode_frame(payload), resolution.tag_names)
            if name in y_payloads:
                y_frames[name] = wire.verify_frame(
                    wire.decode_frame(y_payloads[name]), resolution.target_names
                )
            frames[name], resolutions[name] = X, resolution
        except FileNotFoundError:
            errors[name] = {"error": f"No such model found: '{name}'", "status": 404}
        except ServerError as exc:
            errors[name] = {"error": str(exc), "status": exc.status}
        except (ValueError, TypeError, KeyError) as exc:
            errors[name] = {"error": f"Invalid frame payload: {exc}", "status": 400}
        except Exception:  # noqa: BLE001 - a broken artifact is this machine's problem
            logger.exception("fleet resolution failed for %s", name)
            errors[name] = {"error": "Model could not be loaded", "status": 500}

    entries: Dict[str, str] = {}
    if frames:
        scores, score_errors = ctx.store.fleet().fleet_scores(
            {name: frame.values for name, frame in frames.items()}
        )
        for name, exc in score_errors.items():
            errors[name] = _score_error(name, exc)
        for name, (recon, mse) in scores.items():
            X = frames[name]
            if full:
                entry, error = _full_entry(resolutions[name], X, y_frames.get(name, X), recon)
                if error is not None:
                    errors[name] = error
                    continue
                if entry is not None:
                    entries[name] = entry
                    continue
            keys = wire.index_wire_keys(X.index[len(X.index) - len(recon):])
            entries[name] = wire.encode_lean_entry(keys, recon, np.asarray(mse))
    body_bytes = wire.encode_fleet_response(entries, errors, ctx.revision)
    return Response(body_bytes, 200 if entries else 400)
