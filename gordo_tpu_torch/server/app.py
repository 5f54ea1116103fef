"""
The model server: a plain WSGI application, served with ``wsgiref``.

The routes of this slice, with the JAX server's JSON shapes
(``gordo_tpu/server/app.py``):

- ``GET /healthcheck``;
- ``POST /gordo/v0/<project>/<name>/anomaly/prediction``;
- ``POST /gordo/v0/<project>/prediction/fleet`` (lean, or ``?full``);
- the streaming plane (``views/stream.py``): ``POST .../stream/<id>/ingest``,
  ``GET .../stream/<id>/events`` (server-sent events),
  ``GET .../stream/status`` and ``DELETE .../stream/<id>``.

Every JSON body carries the served ``revision`` (the collection
directory's name), as the JAX server stamps it. Errors map to statuses
as there: 400 for a bad request or frame, 404 for an unknown model, 410
for ingest into a closed stream, 422 for a malformed name or a model
that is not an anomaly detector, 429 and 503 (with ``Retry-After``) when
the streaming plane refuses a session.

The app owns its store and, from the first stream route on, its
:class:`~gordo_tpu_torch.stream.StreamPlane`.
"""

import json
import logging
import os
import re
import socketserver
import threading
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional, Tuple, Union
from urllib.parse import parse_qs
from wsgiref.simple_server import WSGIRequestHandler, WSGIServer, make_server

from .. import DeviceLike, resolve_device
from ..stream import StreamPlane, stream_enabled
from .fleet_store import FleetModelStore, ModelResolution
from .wire import dumps

logger = logging.getLogger(__name__)

PREFIX = "/gordo/v0"
MODEL_COLLECTION_DIR_ENV_VAR = "MODEL_COLLECTION_DIR"

_NAME = re.compile(r"^[a-zA-Z\d-]+")
_REASONS = {
    200: "OK",
    400: "Bad Request",
    404: "Not Found",
    405: "Method Not Allowed",
    410: "Gone",
    422: "Unprocessable Entity",
    429: "Too Many Requests",
    500: "Internal Server Error",
    503: "Service Unavailable",
}


class ServerError(Exception):
    """An error answered as ``{key: message}`` with an HTTP status."""

    def __init__(self, message: str, status: int = 400, key: str = "message"):
        super().__init__(message)
        self.status = status
        self.payload = {key: message}


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
        return self.environ.get("HTTP_" + name.upper().replace("-", "_"))

    def json(self) -> Any:
        """The JSON body, or None when there is none or it does not parse."""
        try:
            return json.loads(self.body) if self.body else None
        except ValueError:
            return None


class Response:
    """A response: ``body`` is bytes, or an iterator of str chunks sent as
    they come, without a ``Content-Length`` (server-sent events)."""

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


class RequestContext:
    """Per-request state handed to the views."""

    def __init__(self, app: "GordoServerApp", request: Request):
        self.app = app
        self.request = request
        self.store = app.store
        self.collection_dir = app.store.collection_dir
        self.revision = app.revision

    def resolve(self, name: str) -> ModelResolution:
        """The model and metadata for ``name``: 422 for a malformed name,
        ``FileNotFoundError`` when there is no such model."""
        if not _NAME.match(name or ""):
            raise ServerError("gordo_name field has wrong format", status=422)
        model_dir = os.path.join(self.collection_dir, name)
        if not any(
            os.path.isfile(os.path.join(d, "metadata.json"))
            for d in (model_dir, self.collection_dir)
        ):
            raise FileNotFoundError("Unable to load metadata.json file")
        return self.store.fleet().resolution(name)

    def json_response(self, payload: Dict[str, Any], status: int = 200) -> Response:
        if self.revision is not None:
            payload = {**payload, "revision": self.revision}
        return Response(dumps(payload).encode(), status)


def _routes() -> List[Tuple[str, "re.Pattern[str]", Callable[..., Response]]]:
    from .views import anomaly, base, stream

    project = rf"^{PREFIX}/(?P<gordo_project>[^/]+)"
    return [
        ("GET", re.compile(r"^/healthcheck/?$"), base.get_healthcheck),
        ("POST", re.compile(rf"{project}/stream/(?P<stream_id>[^/]+)/ingest/?$"), stream.post_stream_ingest),
        ("GET", re.compile(rf"{project}/stream/(?P<stream_id>[^/]+)/events/?$"), stream.get_stream_events),
        ("GET", re.compile(rf"{project}/stream/status/?$"), stream.get_stream_status),
        ("DELETE", re.compile(rf"{project}/stream/(?P<stream_id>[^/]+)/?$"), stream.delete_stream),
        (
            "POST",
            re.compile(rf"^{PREFIX}/(?P<gordo_project>[^/]+)/prediction/fleet/?$"),
            base.post_fleet_prediction,
        ),
        (
            "POST",
            re.compile(
                rf"^{PREFIX}/(?P<gordo_project>[^/]+)/(?P<gordo_name>[^/]+)/anomaly/prediction/?$"
            ),
            anomaly.post_anomaly_prediction,
        ),
    ]


class GordoServerApp:
    """The WSGI application serving one model-collection (revision)
    directory on one device."""

    def __init__(self, collection_dir: str, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.store = FleetModelStore(collection_dir, self.device)
        self.revision = os.path.basename(os.path.normpath(collection_dir))
        self.routes = _routes()
        self.plane: Optional[StreamPlane] = None
        self._plane_lock = threading.Lock()

    def ensure_plane(self) -> Optional[StreamPlane]:
        """The app's streaming plane, created on first use from the
        ``GORDO_TPU_STREAM_*`` environment; None when streaming is off."""
        if not stream_enabled():
            return None
        with self._plane_lock:
            if self.plane is None:
                self.plane = StreamPlane(self.store)
            return self.plane

    def dispatch(self, request: Request) -> Response:
        ctx = RequestContext(self, request)
        allowed = []
        try:
            for method, pattern, view in self.routes:
                match = pattern.match(request.path)
                if match is None:
                    continue
                if method != request.method:
                    allowed.append(method)
                    continue
                return view(ctx, **match.groupdict())
            if allowed:
                return ctx.json_response({"error": "Method Not Allowed"}, status=405)
            return ctx.json_response({"error": "Not Found"}, status=404)
        except ServerError as exc:
            return ctx.json_response(exc.payload, status=exc.status)
        except Exception:  # noqa: BLE001 - the server boundary answers 500
            logger.exception("Unhandled server error")
            return ctx.json_response({"error": "Internal Server Error"}, status=500)

    def __call__(self, environ: Dict[str, Any], start_response) -> Iterable[bytes]:
        response = self.dispatch(Request(environ))
        headers = [("Content-Type", response.content_type)]
        if isinstance(response.body, bytes):
            headers.append(("Content-Length", str(len(response.body))))
        headers += list(response.headers.items())
        if self.revision is not None:
            headers.append(("revision", self.revision))
        reason = _REASONS.get(response.status, "")
        start_response(f"{response.status} {reason}".rstrip(), headers)
        if isinstance(response.body, bytes):
            return [response.body]
        return _encoded(response.body)


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


def build_app(collection_dir: Optional[str] = None, device: DeviceLike = None) -> GordoServerApp:
    """The server application for ``collection_dir`` (default: the
    ``MODEL_COLLECTION_DIR`` environment variable), on ``device``
    (default ``cuda``; pass ``"cpu"`` to run on the CPU)."""
    if collection_dir is None:
        collection_dir = os.environ[MODEL_COLLECTION_DIR_ENV_VAR]
    return GordoServerApp(collection_dir, device)


class ThreadingWSGIServer(socketserver.ThreadingMixIn, WSGIServer):
    """``wsgiref``'s server with a thread per request."""

    daemon_threads = True


class _QuietHandler(WSGIRequestHandler):
    def log_message(self, format, *args):  # noqa: A002 - the base class's name
        logger.debug("%s - %s", self.address_string(), format % args)


def make_wsgi_server(app: GordoServerApp, host: str = "0.0.0.0", port: int = 5555) -> WSGIServer:
    """A threaded ``wsgiref`` server for ``app`` (port 0 picks a free one)."""
    return make_server(host, port, app, server_class=ThreadingWSGIServer, handler_class=_QuietHandler)


def run_server(
    host: str = "0.0.0.0",
    port: int = 5555,
    collection_dir: Optional[str] = None,
    device: DeviceLike = None,
) -> None:
    """Serve ``collection_dir`` (default: ``MODEL_COLLECTION_DIR``) until
    interrupted, with every model loaded up front. On the way out every
    live stream gets its terminal ``drain`` frame."""
    app = build_app(collection_dir, device)
    loaded = app.store.fleet().warm()
    logger.info("serving %d models of %s on %s", len(loaded), app.store.collection_dir, app.device)
    with make_wsgi_server(app, host, port) as server:
        try:
            server.serve_forever()
        finally:
            if app.plane is not None:
                app.plane.drain()
