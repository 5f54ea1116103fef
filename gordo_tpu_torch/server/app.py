"""
The model server: a plain WSGI application, served with ``wsgiref``.

The routes of the JAX server's URL map (``gordo_tpu/server/app.py``),
with its JSON shapes, in its order, all 19 of them:

- ``GET /healthcheck`` and ``GET /server-version``;
- under ``/gordo/v0/<project>/``: ``POST <name>/prediction``,
  ``POST <name>/anomaly/prediction``, ``GET <name>/metadata`` and
  ``GET <name>/healthcheck`` (the same answer),
  ``GET <name>/download-model``, ``DELETE <name>/revision/<revision>``,
  ``POST prediction/fleet`` (lean, or ``?full``), ``GET models``,
  ``GET revisions`` and ``GET expected-models``;
- the streaming plane (``views/stream.py``): ``POST .../stream/<id>/ingest``,
  ``GET .../stream/<id>/events`` (server-sent events),
  ``GET .../stream/status`` and ``DELETE .../stream/<id>``;
- ``GET /gordo/v0/<project>/build-status``: the ``build_status.json`` a
  fleet build wrote beside the revision's machines, or 404;
- ``GET /gordo/v0/<project>/fleet-health``: the joined fleet-status
  document (``telemetry/fleet_health.py``), ``?machines=``, ``?limit=``
  and ``?offset=`` selecting its health records;
- ``GET /gordo/v0/<project>/slo``: the SLO engine's status of the serving
  telemetry directory (``telemetry/slo.py``), what ``slo status
  --as-json`` prints; 404 without a directory, 422 for a bad
  ``slos.toml``, 503 where the directory cannot hold the rollups.
  ``build_app`` marks that directory watched.

A request may pin a revision, a sibling directory of the served one,
with ``?revision=`` or a ``revision`` header. A request that pins none
goes where the store's lifecycle routing sends it
(``FleetModelStore.route``: a promoted revision, or the canary on its
traffic slice), decided once a request. Every JSON body of a
``/gordo/v0`` route, and its ``revision`` header, carries the revision
that answered. ``build_app`` first restores a promotion that the
lifecycle recorded beside the revisions (``lifecycle.restore_serving_state``),
before the engine's warmup, which warms the revision the store routes to. Errors map to statuses as there: 400 for a bad request or
frame or Arrow body (an ``ArrowDecodeError`` anywhere answers 400 with a
JSON error body), 404 for an unknown model, 406 and 415 for a format the
port does not serve (parquet; Arrow with ``GORDO_TPU_WIRE_ARROW=0``), 409
for deleting the served revision,
410 for a malformed or missing revision pin or ingest into a closed
stream, 422 for a malformed name or a model that is not an anomaly
detector, 429 and 503 (with ``Retry-After``) when the streaming plane
refuses a session. With the serving engine, the scoring routes also
answer 429 (queue full) and 503 (breaker open) with ``Retry-After``, 500
(the member's device forward failed alone) and 504 (batching deadline).

The app owns its store, its serving engine when ``GORDO_TPU_BATCHING`` is
on (``serve/engine.py``; its warmup runs in the background unless
``GORDO_TPU_SERVE_WARMUP=0``) and, from the first stream route on, its
:class:`~gordo_tpu_torch.stream.StreamPlane`, which quarantines through
the engine's breaker board when there is an engine.

What the server records about its traffic (``gordo_tpu/server/app.py``'s
``RequestContext`` and ``_finalize``): every request has a W3C trace
identity (an incoming ``traceparent`` continued, else a fresh one),
echoed in the ``traceparent`` header and bound to its log lines. Its
stages (``model_resolve``, ``data_decode``, ``device_ingest``,
``inference``, ``response_assemble``, ``serialize``, and the engine's
``queue_wait`` and ``batch_*``) are spans of an in-memory recorder, and
every response carries them as ``Server-Timing`` (ms each, then
``request_walltime_s`` in seconds). A sampled request
(``GORDO_TPU_TRACE_SAMPLE_RATE``, an upstream's sampled flag, or
``?profile=``) is exported to ``serve_trace.jsonl``
(``telemetry/serving.py``) with a ``request`` span, ``ERROR`` on a 5xx;
``/healthcheck`` and ``/server-version`` never are. ``?profile=1`` adds
the host sampling profiler's ``profile`` span; ``?profile=device``
records the request with ``torch.profiler`` under
``GORDO_TPU_PROFILE_DIR``. The scoring requests of a resolved model feed
the served directory's serving health ledger, one for the process
(``telemetry.serving_ledger``), which adopts the directory's last snapshot
on first use and which the app's engine and plane feed too (a 503 is not
an error there). With ``GORDO_TPU_TELEMETRY=0`` nothing is
written and ``Server-Timing`` stays. Under ``run-server``'s workers
(:func:`run_server`, ``server/prefork.py``) every process writes its own
``serve_trace-<pid>.jsonl`` and ``fleet_health-<pid>.json`` (worker
sinks), and a forked worker drops what it inherited of the process-wide
state (``utils/postfork.py``): the recorder, the ledgers, the live apps,
the launch counters, the loaded kernel libraries, the metric objects.

A drain (:func:`drain_and_stop`; SIGTERM or SIGINT under
:func:`run_server`) flips ``/healthcheck`` to 503, ends every stream with
its ``drain`` frame, scores everything the engine holds, stops the
accept loop and waits, within a bound, for the answers still being
written, as the JAX server drains (``gordo_tpu/server/app.py:699-760``).

With ``ENABLE_PROMETHEUS`` (any value but ``false``) ``build_app`` gives
the app the request RED metrics and stage histograms of
``prometheus/metrics.py`` (``PROJECT`` the project label), observed in
:meth:`GordoServerApp.__call__` after each dispatch, and its engine a
``ServeMetrics`` sink. With ``PROMETHEUS_MULTIPROC_DIR`` set they count
into the process's files of that directory, and the pre-fork master
answers scrapes of every worker's files on ``metrics_port`` (9090 by
default). The collectors read every live app (:func:`live_apps`). A
failing metric is logged and dropped.
"""

import contextlib
import json
import logging
import os
import re
import socketserver
import threading
import time
import timeit
import weakref
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional, Sequence, Tuple, Union
from urllib.parse import parse_qs
from wsgiref.simple_server import WSGIRequestHandler, WSGIServer, make_server

from .. import DeviceLike, resolve_device
from ..serve.engine import ServeConfig, ServeEngine, batching_enabled
from ..stream import StreamPlane, stream_enabled
from ..telemetry import SamplingProfiler, SpanRecorder, live_serving_ledger, serving_ledger, should_profile
from ..telemetry import serving as serve_trace
from ..telemetry import slo, tracing
from ..utils import yaml_lite
from ..utils.env import env_bool
from ..utils.postfork import register_postfork_reset
from .fleet_store import FleetModelStore, ModelResolution, RevisionFleet
from .prometheus.metrics import ServeMetrics, create_prometheus_metrics
from .utils import ServerError, check_metadata_file, validate_gordo_name, validate_revision
from .wire import ArrowDecodeError, dumps

logger = logging.getLogger(__name__)

PREFIX = "/gordo/v0"
MODEL_COLLECTION_DIR_ENV_VAR = "MODEL_COLLECTION_DIR"
EXPECTED_MODELS_ENV_VAR = "EXPECTED_MODELS"

_REASONS = {
    200: "OK",
    400: "Bad Request",
    404: "Not Found",
    405: "Method Not Allowed",
    406: "Not Acceptable",
    409: "Conflict",
    410: "Gone",
    415: "Unsupported Media Type",
    422: "Unprocessable Entity",
    429: "Too Many Requests",
    500: "Internal Server Error",
    503: "Service Unavailable",
    504: "Gateway Timeout",
}

#: what a model name in ``EXPECTED_MODELS`` may look like
_MODEL_NAME = re.compile(r"[A-Za-z0-9][A-Za-z0-9._-]*")


def parse_expected_models(raw: Optional[str]) -> List[str]:
    """The ``EXPECTED_MODELS`` list: ``[]`` when unset, else a YAML list of
    names (a flow list ``[a, b]``, a JSON list or a block list), read as
    ``yaml.safe_load`` reads it (``utils/yaml_lite.py``). Anything that
    is not a list of names raises, where the JAX app takes whatever the
    YAML reader gives.

    >>> parse_expected_models("[machine-1, machine-2]")
    ['machine-1', 'machine-2']
    """
    if raw is None:
        return []
    try:
        names = yaml_lite.safe_load(raw)
    except ValueError as exc:
        raise ValueError(f"{EXPECTED_MODELS_ENV_VAR}={raw!r} is not a list of model names: {exc}") from exc
    if not isinstance(names, list) or not all(isinstance(n, str) and _MODEL_NAME.fullmatch(n) for n in names):
        raise ValueError(f"{EXPECTED_MODELS_ENV_VAR}={raw!r} is not a list of model names")
    return names


class Request:
    """The parts of a WSGI request the routes read."""

    def __init__(self, environ: Dict[str, Any]):
        self.environ = environ
        self.method = environ.get("REQUEST_METHOD", "GET").upper()
        self.path = environ.get("PATH_INFO", "") or "/"
        self.args = parse_qs(environ.get("QUERY_STRING", ""), keep_blank_values=True)
        try:
            length = int(environ.get("CONTENT_LENGTH") or 0)
        except ValueError:
            length = 0
        self.body = environ["wsgi.input"].read(length) if length > 0 else b""

    def header(self, name: str) -> Optional[str]:
        """A request header, e.g. ``Last-Event-ID``, or None."""
        key = name.upper().replace("-", "_")
        if key in ("CONTENT_TYPE", "CONTENT_LENGTH"):
            return self.environ.get(key)
        return self.environ.get("HTTP_" + key)

    def arg(self, name: str) -> Optional[str]:
        """The first value of a query parameter, or None."""
        values = self.args.get(name)
        return values[0] if values else None

    def json(self) -> Any:
        """The JSON body, or None when there is none or it does not parse."""
        try:
            return json.loads(self.body) if self.body else None
        except ValueError:
            return None


class Response:
    """A response: ``body`` is bytes, or an iterator of str chunks sent as
    they come, without a ``Content-Length`` (server-sent events).
    ``stage_durations`` (seconds by stage) and ``endpoint`` are what the
    request's context recorded, for the Prometheus observer."""

    def __init__(
        self,
        body: Union[bytes, Iterator[str]],
        status: int = 200,
        content_type: str = "application/json",
        headers: Optional[Dict[str, str]] = None,
    ):
        self.body = body
        self.status = status
        self.content_type = content_type
        self.headers = dict(headers or {})
        self.stage_durations: Optional[Dict[str, float]] = None
        self.endpoint: Optional[str] = None


class RequestContext:
    """Per-request state handed to the views: the served revision, and
    the revision that answers once :meth:`resolve_revision` has run
    (``collection_dir``, ``revision``); the request's trace identity
    (``trace_id``, its own ``span_id``, the caller's span) and its stage
    recorder ``timing``."""

    def __init__(self, app: "GordoServerApp", request: Request):
        self.app = app
        self.request = request
        self.start_time = timeit.default_timer()
        self.start_wall = time.time()
        incoming = tracing.parse_traceparent(request.header(tracing.TRACEPARENT_HEADER))
        if incoming is not None:
            self.trace_id = incoming.trace_id
            self.remote_parent_id: Optional[str] = incoming.span_id
            # the upstream's sampling decision holds; None: decided in dispatch
            self.sampled: Optional[bool] = incoming.sampled
            self.span_id = tracing.new_span_id()
        else:
            fresh = tracing.new_trace_context()
            self.trace_id, self.span_id = fresh.trace_id, fresh.span_id
            self.remote_parent_id = None
            self.sampled = None
        # in memory only: the stages nest under the request's span
        self.timing = SpanRecorder(service="gordo-tpu-server", trace_id=self.trace_id)
        self.timing.default_parent_id = self.span_id
        self.current_stage: Optional[str] = None
        #: (name, start) of a stage that ends with the request (``serialize``):
        #: closed at the request's own end, so no wait after the encode is lost
        self.deferred_stage: Optional[Tuple[str, float]] = None
        self.profiler: Optional[SamplingProfiler] = None
        self.endpoint: Optional[str] = None
        self.gordo_name: Optional[str] = None
        #: the model a scoring route resolved (what the health ledger counts)
        self.model: Any = None
        #: the request's decoded X columns (``ingest.RawColumns``), kept by
        #: the Arrow and parquet decodes when they line up with ``X``
        self.ingest: Any = None
        self.store = app.store
        self.collection_dir = app.store.collection_dir
        self.current_revision = app.revision
        self.revision: Optional[str] = None
        self._fleet: Optional[RevisionFleet] = None

    @contextlib.contextmanager
    def stage(self, name: str):
        """One request stage as a span: in ``Server-Timing``, the exported
        trace and the profiler's stage axis (``current_stage``)."""
        previous = self.current_stage
        self.current_stage = name
        try:
            with self.timing.span(name) as handle:
                yield handle
        finally:
            self.current_stage = previous

    def resolve_revision(self) -> None:
        """Point the request at the revision it pins (``?revision=`` or
        the ``revision`` header), a sibling directory of the served one,
        or else at the revision the store routes the served one to (a
        promoted revision, or the canary on its slice; ``route`` runs once
        a request), which the response then names; 410 when the pin is
        malformed or names no directory."""
        revision = self.request.arg("revision") or self.request.header("revision")
        if not revision:
            routed = self.store.route(self.collection_dir)
            if routed != self.collection_dir:
                self.collection_dir = routed
                self.current_revision = os.path.basename(os.path.normpath(routed))
            self.revision = self.current_revision
            return
        # validated before it is adopted: it is echoed into a header
        if not validate_revision(revision):
            raise ServerError("Revision should only contains numbers.", status=410, key="error")
        self.revision = revision
        self.collection_dir = os.path.join(self.collection_dir, "..", revision)
        if not os.path.isdir(self.collection_dir):
            raise ServerError(f"Revision '{revision}' not found.", status=410, key="error")

    def fleet(self) -> RevisionFleet:
        """The fleet of the revision that answers this request, taken once
        a request: a revision invalidated meanwhile does not split the
        request across two fleets."""
        if self._fleet is None:
            self._fleet = self.store.fleet(self.collection_dir)
        return self._fleet

    def resolve(self, name: str) -> ModelResolution:
        """The model and metadata for ``name``: 422 for a malformed name,
        ``FileNotFoundError`` when there is no such model."""
        validate_gordo_name(name)
        check_metadata_file(self.collection_dir, name)
        return self.fleet().resolution(name)

    def json_response(self, payload: Dict[str, Any], status: int = 200) -> Response:
        if self.revision is not None:
            payload = {**payload, "revision": self.revision}
        with self.stage("serialize"):
            body = dumps(payload).encode()
        return Response(body, status)


def _routes() -> List[Tuple[str, "re.Pattern[str]", Callable[..., Response], str]]:
    """``(method, path pattern, view, endpoint)`` in the JAX server's URL
    map order, with its endpoint names (a request span's ``http.route``)."""
    from .views import anomaly, base, stream

    project = rf"^{PREFIX}/(?P<gordo_project>[^/]+)"
    model = rf"{project}/(?P<gordo_name>[^/]+)"
    return [
        ("GET", re.compile(r"^/healthcheck/?$"), base.get_healthcheck, "healthcheck"),
        ("GET", re.compile(r"^/server-version/?$"), base.get_server_version, "server-version"),
        ("POST", re.compile(rf"{model}/prediction/?$"), base.post_prediction, "prediction"),
        ("POST", re.compile(rf"{model}/anomaly/prediction/?$"), anomaly.post_anomaly_prediction,
         "anomaly-prediction"),
        ("GET", re.compile(rf"{model}/metadata/?$"), base.get_metadata, "metadata"),
        ("GET", re.compile(rf"{model}/healthcheck/?$"), base.get_metadata, "model-healthcheck"),
        ("GET", re.compile(rf"{model}/download-model/?$"), base.get_download_model, "download-model"),
        ("DELETE", re.compile(rf"{model}/revision/(?P<revision>[^/]+)/?$"), base.delete_model_revision,
         "delete-revision"),
        ("POST", re.compile(rf"{project}/prediction/fleet/?$"), base.post_fleet_prediction, "fleet-prediction"),
        ("POST", re.compile(rf"{project}/stream/(?P<stream_id>[^/]+)/ingest/?$"), stream.post_stream_ingest,
         "stream-ingest"),
        ("GET", re.compile(rf"{project}/stream/(?P<stream_id>[^/]+)/events/?$"), stream.get_stream_events,
         "stream-events"),
        ("GET", re.compile(rf"{project}/stream/status/?$"), stream.get_stream_status, "stream-status"),
        ("DELETE", re.compile(rf"{project}/stream/(?P<stream_id>[^/]+)/?$"), stream.delete_stream, "stream-close"),
        ("GET", re.compile(rf"{project}/build-status/?$"), base.get_build_status, "build-status"),
        ("GET", re.compile(rf"{project}/fleet-health/?$"), base.get_fleet_health, "fleet-health"),
        ("GET", re.compile(rf"{project}/slo/?$"), base.get_slo_status, "slo"),
        ("GET", re.compile(rf"{project}/models/?$"), base.get_model_list, "models"),
        ("GET", re.compile(rf"{project}/revisions/?$"), base.get_revision_list, "revisions"),
        ("GET", re.compile(rf"{project}/expected-models/?$"), base.get_expected_models, "expected-models"),
    ]


class GordoServerApp:
    """The WSGI application serving one model-collection (revision)
    directory, and the revisions beside it that requests pin, on one
    device. ``expected_models`` is what ``/expected-models`` lists; with a
    ``serve_config`` the app runs a serving engine of that configuration.
    ``project`` names the health ledger's project (default ``$PROJECT``).
    With ``prometheus_metrics`` (``build_app`` sets it under
    ``ENABLE_PROMETHEUS``) every request is observed after its dispatch."""

    #: endpoints whose requests are never exported (load balancers poll them)
    UNTRACED_ENDPOINTS = (None, "healthcheck", "server-version")
    #: endpoints whose outcomes feed the health ledger: scoring only
    HEALTH_ENDPOINTS = ("prediction", "anomaly-prediction")

    def __init__(
        self,
        collection_dir: str,
        device: DeviceLike = None,
        expected_models: Sequence[str] = (),
        serve_config: Optional[ServeConfig] = None,
        project: Optional[str] = None,
    ):
        self.device = resolve_device(device)
        self.store = FleetModelStore(collection_dir, self.device)
        self.revision = os.path.basename(os.path.normpath(collection_dir))
        self.expected_models = list(expected_models)
        self.project = project if project is not None else (os.environ.get("PROJECT") or "")
        self.routes = _routes()
        self.engine: Optional[ServeEngine] = None if serve_config is None else ServeEngine(
            self.store, serve_config, ledger=self.health_ledger)
        self.plane: Optional[StreamPlane] = None
        self._plane_lock = threading.Lock()
        self.prometheus_metrics: Any = None
        #: set by :meth:`begin_drain`: ``/healthcheck`` answers 503 from then on
        self._draining = threading.Event()
        _live_apps.add(self)

    def begin_drain(self) -> None:
        """Answer ``/healthcheck`` with 503 from now on, so that load
        balancers stop sending; every request already accepted, and any
        that still arrives, is answered."""
        self._draining.set()

    @property
    def draining(self) -> bool:
        return self._draining.is_set()

    def health_ledger(self) -> Any:
        """The serving health ledger of the served directory: one for the
        process, whichever app, engine or plane feeds it, made on first
        use (adopting the directory's last snapshot); the null ledger while
        health telemetry is off."""
        return serving_ledger(self.store.collection_dir, project=self.project)

    @property
    def live_ledger(self) -> Any:
        """The served directory's serving ledger if the process has made
        one, else None."""
        return live_serving_ledger(self.store.collection_dir)

    def ensure_plane(self) -> Optional[StreamPlane]:
        """The app's streaming plane, created on first use from the
        ``GORDO_TPU_STREAM_*`` environment; None when streaming is off."""
        if not stream_enabled():
            return None
        with self._plane_lock:
            if self.plane is None:
                self.plane = StreamPlane(self.store, breakers=None if self.engine is None else self.engine.breakers,
                                         ledger=self.health_ledger)
            return self.plane

    def start_warmup(self) -> Optional[threading.Thread]:
        """The engine's warmup of the served revision on a background
        thread (None without an engine): the first request then finds the
        kernel loaded and the parity gates decided."""
        engine = self.engine
        if engine is None:
            return None

        def warm():
            try:
                engine.warmup_collection(self.store.route(self.store.collection_dir))
            except Exception:  # noqa: BLE001 - a failed warmup leaves the first requests to pay for it
                logger.exception("serve warmup failed for %s", self.store.collection_dir)

        thread = threading.Thread(target=warm, name="gordo-serve-warmup", daemon=True)
        thread.start()
        return thread

    def shutdown(self) -> None:
        """Drain: every live stream gets its terminal ``drain`` frame, then
        the engine scores everything already queued and stops (later
        requests are scored unbatched); then the serving trace's queue is
        written and the health ledger's snapshot replaced (where the JAX
        server leaves it to its heartbeat)."""
        if self.plane is not None:
            self.plane.drain()
        if self.engine is not None:
            self.engine.shutdown(drain=True)
        serve_trace.serve_recorder().flush()
        ledger = self.live_ledger
        if ledger is not None:
            ledger.flush()

    def dispatch(self, request: Request) -> Response:
        ctx = RequestContext(self, request)
        token = tracing.bind(ctx.trace_id)
        try:
            try:
                response = self._dispatch(ctx, request)
            except ServerError as exc:
                response = ctx.json_response(exc.payload, status=exc.status)
            except ArrowDecodeError as exc:  # the views answer it; none reaches here unanswered
                response = ctx.json_response({"message": str(exc)}, status=400)
            except Exception:  # noqa: BLE001 - the server boundary answers 500
                logger.exception("Unhandled server error")
                response = ctx.json_response({"error": "Internal Server Error"}, status=500)
            return self._finalize(ctx, response)
        finally:
            tracing.unbind(token)

    def _dispatch(self, ctx: RequestContext, request: Request) -> Response:
        allowed = []
        for method, pattern, view, endpoint in self.routes:
            match = pattern.match(request.path)
            if match is None:
                continue
            if method != request.method:
                allowed.append(method)
                continue
            ctx.endpoint = endpoint
            args = match.groupdict()
            ctx.gordo_name = args.get("gordo_name")
            if endpoint in ("healthcheck", "server-version"):  # no revision, no sampling
                return view(ctx, **args)
            self._decide_sampling(ctx)
            ctx.resolve_revision()
            if request.arg("profile") == "device":
                from ..utils.profiling import maybe_trace

                with maybe_trace(f"request-{ctx.trace_id[:16]}"):
                    return view(ctx, **args)
            return view(ctx, **args)
        if allowed:
            return ctx.json_response({"error": "Method Not Allowed"}, status=405)
        return ctx.json_response({"error": "Not Found"}, status=404)

    def _decide_sampling(self, ctx: RequestContext) -> None:
        """Export sampling with the serving trace on: the upstream's
        decision, else the head-sampling coin; a profiled request (``?profile=``)
        is always exported."""
        if serve_trace.serve_recorder().enabled:
            if ctx.sampled is None:
                ctx.sampled = serve_trace.sample_trace()
            if should_profile(ctx.request.arg("profile")):
                ctx.sampled = True
                ctx.profiler = SamplingProfiler().start(stage_getter=lambda: ctx.current_stage)
        else:
            ctx.sampled = False
        # the engine links a batch to this request only when it is exported
        ctx.timing.sampled = ctx.sampled

    def _finalize(self, ctx: RequestContext, response: Response) -> Response:
        """The ``revision``, ``traceparent`` and ``Server-Timing`` headers
        (each stage in ms, then ``request_walltime_s`` in seconds); the
        health ledger; the export of a sampled request."""
        if ctx.revision is not None:
            response.headers.setdefault("revision", ctx.revision)
        response.headers[tracing.TRACEPARENT_HEADER] = tracing.format_traceparent(
            ctx.trace_id, ctx.span_id, sampled=bool(ctx.sampled))
        runtime_s = timeit.default_timer() - ctx.start_time
        if ctx.deferred_stage is not None:
            name, stage_start = ctx.deferred_stage
            ctx.deferred_stage = None
            ctx.timing.record(name, max(0.0, timeit.default_timer() - stage_start))
        durations = ctx.timing.durations()
        entries = [f"{name};dur={round(seconds * 1000.0, 2)}" for name, seconds in durations.items()]
        entries.append(f"request_walltime_s;dur={runtime_s}")
        response.headers["Server-Timing"] = ", ".join(entries)
        # the route's identity and its stages ride the response to the Prometheus observer
        response.stage_durations = durations
        response.endpoint = ctx.endpoint
        profile_report = None
        if ctx.profiler is not None:
            profile_report = ctx.profiler.stop()
            ctx.profiler = None
        self._record_health(ctx, response)
        if ctx.sampled and ctx.endpoint not in self.UNTRACED_ENDPOINTS:
            serve_trace.export_request_trace(
                ctx.timing,
                span_id=ctx.span_id,
                parent_id=ctx.remote_parent_id,
                start=ctx.start_wall,
                duration_s=runtime_s,
                attributes={
                    "http.method": ctx.request.method,
                    "http.route": ctx.endpoint,
                    "http.status_code": response.status,
                    "gordo_name": ctx.gordo_name or "",
                    "revision": ctx.revision or "",
                },
                error=f"HTTP {response.status}" if response.status >= 500 else None,
                profile=profile_report,
            )
        return response

    def _record_health(self, ctx: RequestContext, response: Response) -> None:
        """A scoring request of a resolved model into the health ledger: a
        5xx is the machine's error, a 503 (its breaker shedding) is not, a
        4xx is the client's. Advisory: a failure here is logged and dropped."""
        if ctx.endpoint not in self.HEALTH_ENDPOINTS or not ctx.gordo_name or ctx.model is None:
            return
        try:
            self.health_ledger().record_request(ctx.gordo_name,
                                                error=response.status >= 500 and response.status != 503)
        except Exception:  # noqa: BLE001 - health telemetry is advisory
            logger.debug("health ledger request not recorded", exc_info=True)

    def __call__(self, environ: Dict[str, Any], start_response) -> Iterable[bytes]:
        request = Request(environ)
        start = timeit.default_timer()
        response = self.dispatch(request)
        if self.prometheus_metrics is not None:
            try:
                self.prometheus_metrics.observe(request, response, timeit.default_timer() - start)
            except Exception:  # noqa: BLE001 - metrics are advisory, never the response
                logger.debug("request metrics not observed", exc_info=True)
        headers = [("Content-Type", response.content_type)]
        if isinstance(response.body, bytes):
            headers.append(("Content-Length", str(len(response.body))))
        headers += list(response.headers.items())
        reason = _REASONS.get(response.status, "")
        start_response(f"{response.status} {reason}".rstrip(), headers)
        if isinstance(response.body, bytes):
            return [response.body]
        return _encoded(response.body)


#: every app of the process, held weakly: the Prometheus collectors read their stores and planes
_live_apps: "weakref.WeakSet[GordoServerApp]" = weakref.WeakSet()


def _reset_after_fork() -> None:
    """A forked worker's collectors read its own apps, none of its parent's."""
    global _live_apps
    _live_apps = weakref.WeakSet()


register_postfork_reset(_reset_after_fork, name="server.app.live_apps")


def live_apps() -> List[GordoServerApp]:
    """The process's live apps."""
    return list(_live_apps)


def _encoded(chunks: Iterator[str]) -> Iterator[bytes]:
    """A streamed body as bytes, closing ``chunks`` when the server closes
    this iterator (a finished or dropped connection)."""
    try:
        for chunk in chunks:
            yield chunk.encode()
    finally:
        close = getattr(chunks, "close", None)
        if close is not None:
            close()


def serve_warmup_enabled() -> bool:
    """Whether an app with an engine warms up in the background at build
    (``GORDO_TPU_SERVE_WARMUP``, default on)."""
    return env_bool("GORDO_TPU_SERVE_WARMUP", True)


def enable_prometheus() -> bool:
    """``ENABLE_PROMETHEUS``: any value but ``false`` turns the metrics on."""
    return os.getenv("ENABLE_PROMETHEUS", "false") != "false"


def build_app(
    collection_dir: Optional[str] = None, device: DeviceLike = None, serve_config: Optional[ServeConfig] = None,
    prometheus_registry: Any = None,
) -> GordoServerApp:
    """The server application for ``collection_dir`` (default: the
    ``MODEL_COLLECTION_DIR`` environment variable), on ``device``
    (default ``cuda``; pass ``"cpu"`` to run on the CPU), listing the
    ``EXPECTED_MODELS`` environment variable's names
    (:func:`parse_expected_models`). With ``serve_config``, or with
    ``GORDO_TPU_BATCHING`` on (its configuration then read from the
    ``GORDO_TPU_BATCH_*`` environment), the app runs a serving engine and
    starts its warmup (:meth:`GordoServerApp.start_warmup`) unless
    ``GORDO_TPU_SERVE_WARMUP=0``. With ``ENABLE_PROMETHEUS`` the app
    observes its requests and its engine's batches on
    ``prometheus_registry`` (default the process's ``REGISTRY``, or, while
    ``PROMETHEUS_MULTIPROC_DIR`` is set, a registry of its own whose
    numbers go to the process's files of that directory), under the
    ``PROJECT`` label."""
    if collection_dir is None:
        collection_dir = os.environ[MODEL_COLLECTION_DIR_ENV_VAR]
    expected = parse_expected_models(os.environ.get(EXPECTED_MODELS_ENV_VAR))
    if serve_config is None and batching_enabled():
        serve_config = ServeConfig.from_env()
    app = GordoServerApp(collection_dir, device, expected, serve_config)
    if enable_prometheus():
        app.prometheus_metrics = create_prometheus_metrics(project=app.project, registry=prometheus_registry)
        if app.engine is not None:
            app.engine.metrics = ServeMetrics(project=app.project, registry=app.prometheus_metrics.registry)
    elif prometheus_registry is not None:
        logger.warning("Ignoring non empty prometheus_registry argument")
    # every log record made in a request carries its trace id from here on
    tracing.install_trace_log_stamping()
    # the SLO status of the serving telemetry directory is kept fresh at scrape time
    slo.watch(slo.slo_directory(app.store.collection_dir))
    # a promotion recorded before this process started serves again, before the warmup
    try:
        from ..lifecycle import restore_serving_state

        restore_serving_state(app.store)
    except Exception:  # noqa: BLE001 - a torn state file must not stop the server
        logger.exception("lifecycle serving-state restore failed")
    if app.engine is not None:
        logger.info(
            "micro-batching engine on: max_size=%d max_delay=%.1fms queue_depth=%d row_ladder=%s precision=%s",
            serve_config.max_size, serve_config.max_delay_s * 1000.0, serve_config.queue_depth,
            serve_config.row_ladder, serve_config.precision,
        )
        if serve_warmup_enabled():
            app.start_warmup()
    return app


class ThreadingWSGIServer(socketserver.ThreadingMixIn, WSGIServer):
    """``wsgiref``'s server with a thread per request. The request
    threads are daemons, so that a stuck connection cannot hold the
    process; the server keeps the live ones, and :meth:`join_requests`
    waits for them, within a bound, before the process goes. With
    ``max_threads`` (a pre-fork worker's ``--threads``) at most that many
    requests are answered at once: the accept loop waits for a free
    thread, and the connections behind it wait in the listening socket's
    backlog, where another worker may take them."""

    daemon_threads = True
    #: ``server_close`` does not join the request threads without a bound
    block_on_close = False

    def __init__(self, *args, max_threads: Optional[int] = None, **kwargs):
        self._live: set = set()
        self._live_lock = threading.Lock()
        self._slots = threading.BoundedSemaphore(max_threads) if max_threads else None
        self._stopping = False
        super().__init__(*args, **kwargs)

    def process_request(self, request, client_address):
        slot = False
        if self._slots is not None:
            # a stopping server answers the connection it accepted beyond the cap
            while not slot and not self._stopping:
                slot = self._slots.acquire(timeout=0.5)
        thread = threading.Thread(target=self._answer, args=(request, client_address, slot),
                                  name="gordo-request", daemon=True)
        with self._live_lock:
            self._live = {t for t in self._live if t.is_alive()}
            self._live.add(thread)
        thread.start()

    def _answer(self, request, client_address, slot: bool) -> None:
        try:
            self.process_request_thread(request, client_address)
        finally:
            if slot:
                self._slots.release()

    def shutdown(self) -> None:
        self._stopping = True
        super().shutdown()

    def join_requests(self, timeout: float) -> int:
        """Wait at most ``timeout`` seconds for the request threads still
        writing their answers; the number still alive after it."""
        deadline = time.monotonic() + timeout
        with self._live_lock:
            live = list(self._live)
        for thread in live:
            thread.join(max(0.0, deadline - time.monotonic()))
        return sum(thread.is_alive() for thread in live)


class _QuietHandler(WSGIRequestHandler):
    def log_message(self, format, *args):  # noqa: A002 - the base class's name
        logger.debug("%s - %s", self.address_string(), format % args)


def make_wsgi_server(app: Callable[..., Iterable[bytes]], host: str = "0.0.0.0", port: int = 5555) -> WSGIServer:
    """A threaded ``wsgiref`` server for the WSGI ``app`` (port 0 picks a free one)."""
    return make_server(host, port, app, server_class=ThreadingWSGIServer, handler_class=_QuietHandler)


def serve_socket(app: Callable[..., Iterable[bytes]], sock: Any, max_threads: Optional[int] = None) -> WSGIServer:
    """A threaded ``wsgiref`` server for ``app`` on ``sock``, a socket
    already bound and listening (a pre-fork worker's, shared with the
    other workers), answering at most ``max_threads`` requests at once."""
    import socket as socket_module

    host, port = sock.getsockname()[:2]
    server = ThreadingWSGIServer((host, port), _QuietHandler, bind_and_activate=False, max_threads=max_threads)
    server.socket.close()
    server.socket = sock
    server.server_address = sock.getsockname()
    server.server_name, server.server_port = socket_module.getfqdn(host), port
    server.setup_environ()
    server.set_app(app)
    return server


#: seconds a drain waits for the request threads still answering after the accept loop stopped
REQUEST_JOIN_TIMEOUT_S = 30.0


def drain_and_stop(app: GordoServerApp, server: Any = None, grace_s: float = 0.0,
                   join_timeout_s: float = REQUEST_JOIN_TIMEOUT_S) -> None:
    """Graceful shutdown, in the JAX server's order
    (``gordo_tpu/server/app.py:699-738``): the app starts draining
    (``/healthcheck`` answers 503); the stream plane sends every
    subscriber its ``drain`` frame; the engine scores every queued and
    in-flight batch (:meth:`GordoServerApp.shutdown`, which also writes
    the serving trace's queue), and what arrives after it scores
    unbatched; then the accept loop of ``server`` stops. The port then
    waits, at most ``join_timeout_s``, for the request threads still
    writing their answers (the server's threads are daemons, which the
    process's exit would kill mid-answer), and only then closes the
    serving trace's writer, so their spans reach the file too. With
    ``grace_s`` the accept loop keeps answering that long after the
    engine drained (a port option, 0 as in JAX): load balancers see the
    503 before the socket closes. The log's last line counts the K1 and
    K2 launches this process made (a pre-fork worker's own, from 0 at its
    fork), with its pid."""
    from ..ops.fleet_dense import fleet_anomaly_scores, fleet_feedforward

    started = time.monotonic()
    app.begin_drain()
    app.shutdown()
    if grace_s > 0:
        time.sleep(grace_s)
    left = 0
    if server is not None:
        server.shutdown()
        if hasattr(server, "join_requests"):
            left = server.join_requests(join_timeout_s)
    serve_trace.reset_serve_recorder()
    logger.info("drained in %.3f s (%d request thread(s) still answering); kernel launches: K1 %d, K2 %d (pid %d)",
                time.monotonic() - started, left, fleet_feedforward.launches, fleet_anomaly_scores.launches,
                os.getpid())


def install_graceful_shutdown(app: GordoServerApp, server: Any = None, grace_s: float = 0.0) -> Optional[Callable]:
    """SIGTERM and SIGINT start :func:`drain_and_stop` on a thread (a
    signal handler must return at once); the handler, or None off the
    main thread, where no handler can be installed (an embedded server
    manages its own life)."""
    import signal

    started = threading.Event()

    def handler(_signum, _frame):
        if started.is_set():  # a second signal while draining: the drain already runs
            return
        started.set()
        handler.thread = threading.Thread(target=drain_and_stop, args=(app, server, grace_s), name="gordo-drain",
                                          daemon=True)
        handler.thread.start()

    handler.thread = None
    try:
        signal.signal(signal.SIGTERM, handler)
        signal.signal(signal.SIGINT, handler)
    except ValueError:  # not the main thread
        return None
    return handler


def run_server(
    host: str = "0.0.0.0",
    port: int = 5555,
    collection_dir: Optional[str] = None,
    device: DeviceLike = None,
    metrics_port: int = 9090,
    drain_grace_s: float = 0.0,
    workers: int = 1,
    threads: int = 8,
    worker_class: str = "gthread",
    prometheus_config: bool = False,
) -> int:
    """Serve ``collection_dir`` (default: ``MODEL_COLLECTION_DIR``) until
    SIGTERM or SIGINT: the JAX command's gunicorn server
    (``gordo_tpu/server/app.py:800-895``) as the port's pre-fork master
    (``server/prefork.py``), which forks ``workers`` processes, each with
    its own app, device context and every model loaded up front, answering
    at most ``threads`` requests at once (``worker_class`` ``sync``: one).
    A signal drains every worker (``drain_grace_s`` the drain's grace);
    the exit code is 0 when every worker drained, and not 0 when a worker
    could not boot. With ``ENABLE_PROMETHEUS`` the master answers scrapes
    of every worker's metrics on ``metrics_port`` (0 picks a free one);
    ``prometheus_config`` marks a dead worker's live gauges dead
    (``--with-prometheus-config``)."""
    from .prefork import PreforkServer

    return PreforkServer(host, port, workers=workers, threads=threads, worker_class=worker_class,
                         collection_dir=collection_dir, device=device, metrics_port=metrics_port,
                         drain_grace_s=drain_grace_s, prometheus_config=prometheus_config).run()
