"""
Base routes (``gordo_tpu/server/views/base.py``): the healthcheck and
server version, per-model prediction, metadata, the model download,
revision deletion, the model, revision and expected-model lists, the
fleet route ``POST /gordo/v0/<project>/prediction/fleet``, the build's
status ``GET /gordo/v0/<project>/build-status``, the fleet-status
document and the SLO status.

``POST .../<name>/prediction`` scores one model's rows, body ``{"X":
frame}``, through one gather launch of K1 (with the model's input
scaling as its prologue) and answers ``start``/``end``/``model-input``/
``model-output``. A body of ``Content-Type:
application/vnd.apache.arrow.stream`` is an Arrow IPC stream of role-tagged
columns (``wire/arrow_codec.py``), and ``Accept`` of that type answers one
(``wire/negotiate.py``), the envelope as its ``gordo:meta``. A raw
``application/x-parquet`` body (``X``) or a ``multipart/form-data`` upload
of parquet files ``X`` and ``y`` is read with ``wire/parquet_codec.py``,
and ``?format=parquet`` (or an ``Accept`` preferring it) answers the
table as parquet. Each format is decoded and encoded inside the
``data_decode`` and ``serialize`` stages as JSON is. With the app's serving engine (``GORDO_TPU_BATCHING``)
concurrent requests coalesce into one launch; its refusals answer 429,
503, 500 or 504 (``server/model_io.py``), and what it cannot batch is
scored alone as without it.

The fleet route scores many models in one request, body ``{"X": {name:
frame}, "y"?: {name: frame}, "full"?: bool}`` or a ``GDTAF1`` container of
one Arrow stream a machine (``full`` and ``all_columns`` may ride its
trailer), answered in kind when asked: a container with
``{"errors", "revision"}`` as its trailer. Models sharing a spec are
scored by one kernel launch over their bucket. Each machine answers the
lean entry (``model-output`` and the per-row ``total-anomaly-unscaled``)
or, with ``?full``, a detector's whole anomaly frame (its ``smooth-*``
groups too with ``?all_columns``). Per-machine problems become entries
of ``errors``, never the whole batch's failure. Its stages: ``data_decode``,
``inference`` (the K2 launches and the copies back), ``response_assemble``
and ``serialize``; each scored machine's rows and residual mean go to the
health ledger.

``GET /gordo/v0/<project>/fleet-health`` is the joined fleet-status
document of the served directory (``telemetry/fleet_health.py``), with
the app's live ledger and its ``device``, ``programs``, ``serving`` and
``stream`` sections. ``GET /gordo/v0/<project>/slo`` is the SLO status
of the serving telemetry directory (``telemetry/slo.py``).
"""

import logging
import os
import timeit
from typing import Any, Dict, Optional, Tuple

import numpy as np

from ... import __version__, serializer
from ...models.anomaly.diff import DiffBasedAnomalyDetector
from ...serve import BatchShedError
from ...stream import stream_plane_section
from ...stream.scorer import CLIENT_ERRORS
from ...telemetry import fleet_status_document, load_status, utilization_snapshot
from ...telemetry import slo as slo_engine
from .. import model_io, multipart, utils, wire
from ..app import MODEL_COLLECTION_DIR_ENV_VAR, Response, ServerError
from ..fleet_store import ModelResolution
from ..wire import negotiate

logger = logging.getLogger(__name__)


def get_healthcheck(ctx) -> Response:
    """200, or 503 with the body ``draining`` once the app drains."""
    if ctx.app.draining:
        return Response(b"draining", 503, "text/plain")
    return Response(b"", 200, "text/plain")


def get_server_version(ctx) -> Response:
    return ctx.json_response({"version": __version__})


def arrow_frames(
    payload: bytes, resolution: ModelResolution, with_y: bool = True, ctx: Any = None
) -> Tuple[wire.Frame, Optional[wire.Frame]]:
    """``X`` (and ``y`` when the body has role ``y`` columns and ``with_y``)
    from one Arrow stream, aligned with the model's tags as
    ``frame_from_columns`` aligns them (``gordo_tpu/server/utils.py:255-345``);
    400 with JAX's message for a body that cannot be read or columns that
    do not fit. With a request ``ctx``, X's decoded columns are kept as
    ``ctx.ingest`` where they line up with X (``utils.stash_raw_columns``)."""
    try:
        x_columns, y_columns, index = wire.decode_frames(payload)
        X = wire.frame_from_columns(x_columns, index, resolution.tag_names)
        y = wire.frame_from_columns(y_columns, index, resolution.target_names) if y_columns and with_y else None
    except (wire.ArrowDecodeError, wire.FrameError) as exc:
        raise ServerError(str(exc), status=400)
    if ctx is not None:
        utils.stash_raw_columns(ctx, x_columns, None if index is None else index.values, X.columns)
    return X, y


def parquet_frames(X_bytes: bytes, y_bytes: Optional[bytes],
                   resolution: ModelResolution, ctx: Any = None) -> Tuple[wire.Frame, Optional[wire.Frame]]:
    """``X`` (and ``y``) from parquet files, aligned with the model's tags
    as a JSON frame is; 400 for a file that cannot be read or columns that
    do not fit. With a request ``ctx``, X's decoded columns are kept as
    in :func:`arrow_frames`."""
    try:
        X_file, x_columns = wire.parquet_columns(X_bytes)
        X = wire.verify_frame(X_file, resolution.tag_names)
        y = None
        if y_bytes is not None:
            y = wire.verify_frame(wire.dataframe_from_parquet_bytes(y_bytes), resolution.target_names)
    except (wire.ParquetDecodeError, wire.FrameError) as exc:
        raise ServerError(str(exc), status=400)
    if ctx is not None:
        utils.stash_raw_columns(ctx, x_columns, X.index, X.columns)
    return X, y


def extract_X_y(request, resolution: ModelResolution, ctx: Any = None) -> Tuple[wire.Frame, Optional[wire.Frame]]:
    """``X`` (and ``y`` when sent) from a ``{"X": frame, "y": frame}`` body,
    an Arrow stream, a raw parquet body (``X`` only) or a multipart form
    of parquet files ``X`` and ``y`` (``gordo_tpu/server/utils.py:344-398``),
    aligned with the model's tags; 400 on anything unreadable, 415 for an
    Arrow body with the Arrow codec off. With a request ``ctx``, an Arrow or
    parquet X's decoded columns are kept as ``ctx.ingest``."""
    body_format = negotiate.request_format(request)
    if body_format == negotiate.PARQUET:
        return parquet_frames(request.body, None, resolution, ctx)
    if body_format == negotiate.ARROW:
        return arrow_frames(request.body, resolution, ctx=ctx)
    if multipart.is_form(request.header("Content-Type")):
        try:
            files = multipart.form_files(request.body, request.header("Content-Type"))
        except multipart.MultipartError as exc:
            raise ServerError(str(exc))
        if "X" not in files:
            raise ServerError('Cannot predict without "X"')
        return parquet_frames(files["X"], files.get("y"), resolution, ctx)
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


def encode_table_response(ctx, response_format: str, table: wire.WireTable, extra: Optional[dict] = None) -> Response:
    """A scoring route's table as ``{"data": ..., **extra, "revision":
    ...}``, as an Arrow stream with that envelope as ``gordo:meta``, or as
    parquet: the table alone, as the JAX server writes its frame
    (``WireTable.to_frame()``), answered as the JAX server's file
    download. Its ``serialize`` stage ends with the request (the app
    closes it), so a wait for the GIL after a long encode is still the
    stage's."""
    serialize_start = timeit.default_timer()
    ctx.current_stage = "serialize"
    envelope = {**(extra or {}), "revision": ctx.revision}
    if response_format == negotiate.PARQUET:
        response = Response(wire.dataframe_into_parquet_bytes(table), content_type=wire.PARQUET_RESPONSE_CONTENT_TYPE)
    elif response_format == negotiate.ARROW:
        response = Response(wire.encode_arrow_table(table, envelope), content_type=wire.ARROW_CONTENT_TYPE)
    else:
        response = Response(wire.encode_response(table, envelope))
    ctx.deferred_stage = ("serialize", serialize_start)
    return response


def post_prediction(ctx, gordo_project: str, gordo_name: str) -> Response:
    """One model's reconstruction of ``X``: one K1 gather launch on the
    model's spec bucket. 400 for rows the model cannot take."""
    with ctx.stage("model_resolve"):
        resolution = utils.resolve_model(ctx, gordo_name)
    response_format = negotiate.response_format(ctx.request)  # before decoding and scoring
    with ctx.stage("data_decode"):
        X, _ = extract_X_y(ctx.request, resolution, ctx)
    try:
        staged = None
        if ctx.app.engine is None:
            with ctx.stage("device_ingest"):
                staged = ctx.fleet().stage_input(gordo_name, model_io.request_rows(ctx, X))
        with ctx.stage("inference"):
            output = None if staged is not None else model_io.batched_model_output(
                ctx, gordo_name, resolution.model, model_io.request_rows(ctx, X))
            if output is None:
                output = model_io.get_model_output(ctx, gordo_name, model_io.request_rows(ctx, X), staged)
    except BatchShedError as exc:
        return model_io.shed_response(ctx, exc)
    except ValueError as err:
        logger.error("Failed to predict: %s", err)
        return ctx.json_response({"error": f"ValueError: {err}"}, status=400)
    except TypeError:
        logger.exception("Failed to predict")
        return ctx.json_response({"error": "Something unexpected happened; check your input data"}, status=400)
    with ctx.stage("response_assemble"):
        table = wire.prediction_table(X, output, resolution.tag_names, resolution.target_names)
    return encode_table_response(ctx, response_format, table)


def get_metadata(ctx, gordo_project: str, gordo_name: str) -> Response:
    """The model's ``info.json`` with its metadata, the server's version
    and ``MODEL_COLLECTION_DIR``; also the per-model healthcheck."""
    info, model_metadata = utils.require_metadata(ctx, gordo_name)
    metadata = dict(info)
    metadata.update({
        "gordo-server-version": __version__,
        "metadata": model_metadata,
        "env": {MODEL_COLLECTION_DIR_ENV_VAR: os.environ.get(MODEL_COLLECTION_DIR_ENV_VAR)},
    })
    return ctx.json_response(metadata)


def get_download_model(ctx, gordo_project: str, gordo_name: str) -> Response:
    """The served model as :func:`~gordo_tpu_torch.serializer.dumps` bytes."""
    model = utils.resolve_model(ctx, gordo_name).model
    return Response(
        serializer.dumps(model),
        content_type="application/octet-stream",
        headers={"Content-Disposition": "attachment; filename=model.pickle"},
    )


def delete_model_revision(ctx, gordo_project: str, gordo_name: str, revision: str) -> Response:
    """Delete one model of a revision other than the served one: 422 for
    a malformed revision, 409 for the served one, 404 for a missing
    model."""
    utils.validate_gordo_name(gordo_name)
    if not utils.validate_revision(revision):
        return ctx.json_response({"error": "Revision should only contains numbers."}, status=422)
    if revision == ctx.current_revision:
        return ctx.json_response({"error": "Unable to delete current revision."}, status=409)
    utils.delete_revision(ctx.store, os.path.join(ctx.collection_dir, "..", revision), gordo_name)
    return ctx.json_response({"ok": True})


def get_model_list(ctx, gordo_project: str) -> Response:
    return ctx.json_response({"models": serializer.list_model_dirs(ctx.collection_dir)})


def get_revision_list(ctx, gordo_project: str) -> Response:
    """Every entry beside the revision, and the served one as latest."""
    try:
        available = os.listdir(os.path.join(ctx.collection_dir, ".."))
    except FileNotFoundError:
        logger.exception("Could not list the revisions beside %s", ctx.collection_dir)
        available = [ctx.current_revision]
    return ctx.json_response({"latest": ctx.current_revision, "available-revisions": available})


def get_expected_models(ctx, gordo_project: str) -> Response:
    return ctx.json_response({"expected-models": ctx.app.expected_models})


def get_build_status(ctx, gordo_project: str) -> Response:
    """The ``build_status.json`` a fleet build wrote beside the revision's
    machines, as it is (``base.py:678-692``); 404 when there is none."""
    doc = load_status(ctx.collection_dir)
    if doc is None:
        return ctx.json_response({"error": "No build status for this revision."}, status=404)
    return ctx.json_response(doc)


def get_fleet_health(ctx, gordo_project: str) -> Response:
    """The joined fleet-status document of the served directory
    (``base.py:712-769``): ``?machines=`` (``all``, ``none``, a state,
    ``unhealthy`` or a comma list of names), ``?limit=``, ``?offset=``.
    Its ``programs`` are the port's forward buckets
    (:meth:`~gordo_tpu_torch.server.fleet_store.FleetModelStore.program_cache_stats`)."""
    app = ctx.app
    directory = app.store.collection_dir
    args = ctx.request
    try:
        limit = int(args.arg("limit")) if args.arg("limit") is not None else None
    except (TypeError, ValueError):
        limit = None
    try:
        offset = int(args.arg("offset") or 0)
    except (TypeError, ValueError):
        offset = 0
    try:
        programs = app.store.program_cache_stats(app.engine)
    except Exception:  # noqa: BLE001 - cache stats are advisory
        programs = None
    serving = None
    try:
        if app.engine is not None:
            serving = app.engine.stats()
            serving["gates"] = app.store.fleet(app.store.route(directory)).precision_reports()
            serving["store"] = app.store.revision_stats()
    except Exception:  # noqa: BLE001 - engine stats are advisory
        pass
    try:
        stream = stream_plane_section(app.plane)
    except Exception:  # noqa: BLE001 - plane stats are advisory
        stream = None
    doc = fleet_status_document(directory, device=utilization_snapshot(app.device), programs=programs,
                                serving=serving, stream=stream, machines=args.arg("machines"), limit=limit,
                                offset=offset, ledger=app.live_ledger)
    return ctx.json_response(doc)


def get_slo_status(ctx, gordo_project: str) -> Response:
    """The SLO status of the serving telemetry directory
    (``GORDO_TPU_TELEMETRY_DIR``, else the served directory), what ``slo
    status --as-json`` prints (``base.py:771-830``): a directory without
    sinks is empty traffic, inside SLO. 404 when there is no directory,
    422 for a bad ``slos.toml`` (the operator's to fix), 503 when the
    directory cannot hold the rollups (a read-only volume). The cached
    status is served while it is younger than
    ``GORDO_TPU_SLO_SCRAPE_REFRESH``: a poller does not step the alerts."""
    directory = slo_engine.slo_directory(ctx.app.store.collection_dir)
    if not directory or not os.path.isdir(directory):
        return ctx.json_response({"error": "No telemetry directory to evaluate (set GORDO_TPU_TELEMETRY_DIR)."},
                                 status=404)
    try:
        config = slo_engine.load_slo_config(directory)
    except (OSError, ValueError) as exc:
        return ctx.json_response({"error": f"Bad SLO config: {exc}"}, status=422)
    try:
        doc = slo_engine.evaluate_cached(directory, config=config)
    except OSError as exc:
        return ctx.json_response({"error": f"SLO evaluation failed: {exc}"}, status=503)
    return ctx.json_response(doc)


def _record_fleet_health(ctx, frames: Dict[str, wire.Frame], scores, score_errors) -> None:
    """The fleet request into the app's health ledger
    (:meth:`~gordo_tpu_torch.telemetry.fleet_health.FleetHealthLedger.record_scored`).
    Advisory: a failure is logged and dropped."""
    try:
        ctx.app.health_ledger().record_scored({name: len(frame) for name, frame in frames.items()}, scores,
                                              score_errors, CLIENT_ERRORS)
    except Exception:  # noqa: BLE001 - health telemetry is advisory
        logger.debug("fleet health not recorded", exc_info=True)


def _full_entry(
    resolution: ModelResolution, X, y, recon, keep_smooth: bool
) -> Tuple[Optional[wire.WireTable], Optional[dict]]:
    """One detector's whole anomaly table, or ``(None, None)`` for a model
    that is not a detector."""
    model = resolution.model
    if not isinstance(model, DiffBasedAnomalyDetector):
        return None, None
    try:
        frequency = resolution.frequency
    except ValueError:
        frequency = None
    try:
        table = wire.anomaly_table(model, X, y, recon, frequency=frequency, keep_smooth=keep_smooth)
    except AttributeError:
        return None, {"error": "Model has no thresholds (require_thresholds unmet)", "status": 422}
    except ValueError as exc:
        return None, {"error": f"ValueError: {exc}", "status": 400}
    return table, None


def decode_machines(ctx, payloads: Dict[str, Any], decode, errors: Dict[str, Dict[str, Any]]) -> Dict[str, Any]:
    """``{name: (decode(name, payload, resolution), resolution)}`` for each machine of a fleet
    or stream body; a machine that cannot be resolved or decoded becomes
    its entry in ``errors`` (404, its ``ServerError``'s status, 400 for a
    bad payload, 500 for an artifact that does not load)."""
    decoded: Dict[str, Any] = {}
    for name, payload in payloads.items():
        try:
            resolution = ctx.resolve(name)
            decoded[name] = decode(name, payload, resolution), resolution
        except FileNotFoundError:
            errors[name] = {"error": f"No such model found: '{name}'", "status": 404}
        except ServerError as exc:
            errors[name] = {"error": str(exc), "status": exc.status}
        except (ValueError, TypeError, KeyError) as exc:
            errors[name] = {"error": f"Invalid frame payload: {exc}", "status": 400}
        except Exception:  # noqa: BLE001 - a broken artifact is this machine's problem
            logger.exception("resolution failed for %s", name)
            errors[name] = {"error": "Model could not be loaded", "status": 500}
    return decoded


def arrow_container(ctx, what: str) -> Tuple[Dict[str, bytes], Dict[str, Any]]:
    """The machines' Arrow streams and the trailer of a ``GDTAF1`` body;
    400 for a body that is no container or has no machine."""
    try:
        entries, extra = wire.unpack_streams(ctx.request.body)
    except wire.ArrowDecodeError as exc:
        raise ServerError(str(exc), status=400)
    if not entries:
        raise ServerError(f"{what} needs at least one machine entry")
    return entries, extra


def post_fleet_prediction(ctx, gordo_project: str) -> Response:
    response_format = negotiate.response_format(ctx.request)
    if response_format == negotiate.PARQUET:
        raise ServerError("The fleet route serves JSON or Arrow, not parquet", status=406)
    body_format = negotiate.request_format(ctx.request)
    frames: Dict[str, wire.Frame] = {}
    y_frames: Dict[str, wire.Frame] = {}
    resolutions: Dict[str, ModelResolution] = {}
    errors: Dict[str, Dict[str, Any]] = {}
    args = ctx.request.args
    with ctx.stage("data_decode"):  # the body's parse included
        if body_format == negotiate.ARROW:
            # a container of one stream a machine; full and all_columns may ride its trailer
            streams, extra = arrow_container(ctx, "Fleet prediction")
            full = "full" in args or bool(extra.get("full"))
            keep_smooth = "all_columns" in args or bool(extra.get("all_columns"))
            decoded = decode_machines(ctx, streams, lambda _, payload, resolution: arrow_frames(payload, resolution),
                                      errors)
        else:
            body = ctx.request.json()
            if not isinstance(body, dict) or not isinstance(body.get("X"), dict) or not body["X"]:
                raise ServerError('Fleet prediction needs a JSON body {"X": {<model-name>: frame}}')
            full = "full" in args or bool(body.get("full"))
            keep_smooth = "all_columns" in args
            y_payloads = body.get("y") if isinstance(body.get("y"), dict) else {}

            def decode_json(name, payload, resolution):
                X = wire.verify_frame(wire.decode_frame(payload), resolution.tag_names)
                if name not in y_payloads:
                    return X, None
                return X, wire.verify_frame(wire.decode_frame(y_payloads[name]), resolution.target_names)

            decoded = decode_machines(ctx, body["X"], decode_json, errors)
        for name, ((X, y), resolution) in decoded.items():
            frames[name], resolutions[name] = X, resolution
            if y is not None:
                y_frames[name] = y

    as_arrow = response_format == negotiate.ARROW
    entries: Dict[str, Any] = {}
    if frames:
        with ctx.stage("inference"):
            scores, score_errors = ctx.fleet().fleet_scores(
                {name: frame.values for name, frame in frames.items()}
            )
        _record_fleet_health(ctx, frames, scores, score_errors)
        for name, exc in score_errors.items():
            errors[name] = _score_error(name, exc)
        with ctx.stage("response_assemble"):
            for name, (recon, mse) in scores.items():
                X = frames[name]
                if full:
                    table, error = _full_entry(resolutions[name], X, y_frames.get(name, X), recon, keep_smooth)
                    if error is not None:
                        errors[name] = error
                        continue
                    if table is not None:
                        entries[name] = table if as_arrow else "".join(wire.encode_table(table))
                        continue
                index = X.index[len(X.index) - len(recon):]
                if as_arrow:
                    entries[name] = wire.lean_table(index, recon, np.asarray(mse), X.unit)
                else:
                    entries[name] = wire.encode_lean_entry(wire.index_wire_keys(index), recon, np.asarray(mse))
    status = 200 if entries else 400
    with ctx.stage("serialize"):
        if as_arrow:
            streams = {name: wire.encode_arrow_table(table) for name, table in entries.items()}
            body_bytes = wire.pack_streams(streams, {"errors": errors, "revision": ctx.revision})
            return Response(body_bytes, status, wire.ARROW_CONTENT_TYPE)
        body_bytes = wire.encode_fleet_response(entries, errors, ctx.revision)
    return Response(body_bytes, status)
