"""
A client of MLflow's REST API 2.0 over ``urllib``: what the JAX
reporter's ``MlflowClient`` sends a tracking server for one run (the
experiment looked up by name and created when missing, the run created
with its tags, ``log_batch``, the artifacts, ``set_terminated``), spoken
to ``<tracking URI>/api/2.0/mlflow/...`` without ``mlflow`` or
``requests``, neither of which the card's machine has.

The request bodies are MLflow's protobuf JSON: int64 fields as numbers,
a non-finite metric as ``"NaN"``, ``"Infinity"`` or ``"-Infinity"``
(never a bare ``NaN``). A run's ``metadata.json`` goes where the run's
``artifact_uri`` says: ``mlflow-artifacts:`` through the tracking
server's artifact proxy (``PUT .../api/2.0/mlflow-artifacts/artifacts/
<path>``, on the host the URI names, else the tracking server's);
``http(s)://`` by ``PUT <uri>/<file>``; ``file:`` or a bare path copied.
Every other scheme (``s3``, ``gs``, ``wasbs``, ``dbfs``, AzureML's own
artifact store, ...) raises :class:`MlflowLoggingError` naming it.

The environment is read as MLflow's client reads it:

- ``MLFLOW_TRACKING_USERNAME`` and ``MLFLOW_TRACKING_PASSWORD``: Basic
  auth; else ``MLFLOW_TRACKING_TOKEN``: a Bearer token (MLflow sends both
  through ``requests``, whose Basic auth overwrites the Bearer header);
- ``MLFLOW_TRACKING_INSECURE_TLS`` (no certificate check) or
  ``MLFLOW_TRACKING_SERVER_CERT_PATH`` (the CA bundle trusted instead of
  the system's), not both;
- ``MLFLOW_HTTP_REQUEST_TIMEOUT`` (seconds a request, default 120),
  ``MLFLOW_HTTP_REQUEST_MAX_RETRIES`` (default 7) and
  ``MLFLOW_HTTP_REQUEST_BACKOFF_FACTOR`` (default 2). The defaults are
  MLflow 2.x's (``mlflow/environment_variables.py``), written out here
  because the card's machine has no ``mlflow`` to read them from.

A 429, a 5xx, or a refused or reset connection is retried up to the
retry count, the n-th retry after ``factor * 2 ** (n - 1)`` seconds (the
first at once, at most 120 s), as urllib3's ``Retry`` that MLflow
configures spaces them, without its jitter or ``Retry-After``. Every
other failure raises :class:`MlflowLoggingError` naming the endpoint, the
HTTP status and the server's ``error_code`` and ``message``; a reporter's
exception exits a build with 90.
"""

import base64
import json
import math
import mimetypes
import os
import shutil
import ssl
import time
import urllib.error
import urllib.parse
import urllib.request
from typing import Callable, Optional

from ..utils.env import env_bool, env_float, env_int, env_str
from .base import ReporterException

DEFAULT_TIMEOUT_S = 120.0
DEFAULT_MAX_RETRIES = 7
DEFAULT_BACKOFF_FACTOR = 2.0
#: urllib3's ``Retry.DEFAULT_BACKOFF_MAX``
BACKOFF_MAX_S = 120.0
#: the path of the tracking server's artifact proxy under its URI
ARTIFACT_PROXY = "/api/2.0/mlflow-artifacts/artifacts"


class MlflowLoggingError(ReporterException):
    """A tracking request that failed: ``status`` and ``error_code`` as the
    server answered them, where it did."""

    def __init__(self, message, status: Optional[int] = None, error_code: Optional[str] = None):
        super().__init__(message)
        self.status, self.error_code = status, error_code


def env_authorization() -> Optional[str]:
    """The ``Authorization`` header MLflow's client sends, from the
    environment: Basic over a Bearer token; None without credentials."""
    user, password = env_str("MLFLOW_TRACKING_USERNAME", None), env_str("MLFLOW_TRACKING_PASSWORD", None)
    if user and password:
        return "Basic " + base64.b64encode(f"{user}:{password}".encode()).decode()
    token = env_str("MLFLOW_TRACKING_TOKEN", None)
    return f"Bearer {token}" if token else None


def tls_context() -> ssl.SSLContext:
    """The TLS context of ``MLFLOW_TRACKING_INSECURE_TLS`` and
    ``MLFLOW_TRACKING_SERVER_CERT_PATH``."""
    insecure = env_bool("MLFLOW_TRACKING_INSECURE_TLS", False)
    cafile = env_str("MLFLOW_TRACKING_SERVER_CERT_PATH", None)
    if insecure and cafile:
        raise MlflowLoggingError("MLFLOW_TRACKING_INSECURE_TLS and MLFLOW_TRACKING_SERVER_CERT_PATH cannot both be set")
    context = ssl.create_default_context(cafile=cafile)
    if insecure:
        context.check_hostname = False
        context.verify_mode = ssl.CERT_NONE
    return context


def _error_fields(body: bytes):
    """``(error_code, message)`` of an error answer: MLflow's
    ``error_code``/``message``, ARM's ``error.code``/``error.message`` or
    the login's ``error``/``error_description``; else its text."""
    try:
        doc = json.loads(body)
    except ValueError:
        return None, body[:500].decode(errors="replace")
    if not isinstance(doc, dict):
        return None, str(doc)[:500]
    if isinstance(doc.get("error"), dict):
        doc = doc["error"]
    code = doc.get("error_code") or doc.get("code") or doc.get("error")
    return code, doc.get("message") or doc.get("error_description") or ""


def http_request(method: str, url: str, data: Optional[bytes] = None, headers: Optional[dict] = None,
                 context: Optional[ssl.SSLContext] = None) -> bytes:
    """The body of a 2xx answer to one request, retried as the module says;
    any other outcome raises :class:`MlflowLoggingError`. ``context``
    defaults to :func:`tls_context`."""
    timeout = env_float("MLFLOW_HTTP_REQUEST_TIMEOUT", DEFAULT_TIMEOUT_S)
    max_retries = env_int("MLFLOW_HTTP_REQUEST_MAX_RETRIES", DEFAULT_MAX_RETRIES)
    backoff_factor = env_float("MLFLOW_HTTP_REQUEST_BACKOFF_FACTOR", DEFAULT_BACKOFF_FACTOR)
    context = context or tls_context()
    endpoint = f"{method} {url.split('?')[0]}"
    last = ""
    for attempt in range(max_retries + 1):
        if attempt > 1:
            time.sleep(min(BACKOFF_MAX_S, backoff_factor * 2 ** (attempt - 1)))
        request = urllib.request.Request(url, data=data, headers=headers or {}, method=method)
        try:
            with urllib.request.urlopen(request, timeout=timeout, context=context) as response:
                return response.read()
        except urllib.error.HTTPError as exc:
            body = exc.read()
            code, message = _error_fields(body)
            last = f"HTTP {exc.code} {code}: {message}"
            if exc.code == 429 or exc.code >= 500:
                continue
            raise MlflowLoggingError(f"{endpoint}: {last}", exc.code, code) from None
        except OSError as exc:  # URLError, a reset mid-answer, a timeout
            reason = getattr(exc, "reason", exc)
            last = f"{type(reason).__name__}: {reason}"
            if isinstance(reason, (ConnectionRefusedError, ConnectionResetError)):
                continue
            raise MlflowLoggingError(f"{endpoint}: {last}") from None
    raise MlflowLoggingError(f"{endpoint}: {last} ({max_retries + 1} attempts)")


def _json_number(value) -> object:
    """A metric value as protobuf JSON writes a double."""
    value = float(value)
    if math.isnan(value):
        return "NaN"
    if math.isinf(value):
        return "Infinity" if value > 0 else "-Infinity"
    return value


def _now_ms() -> int:
    return int(time.time() * 1000)


class RestTrackingClient:
    """The reporter's tracking calls against the MLflow server at
    ``tracking_uri`` (``http(s)://host[:port][/prefix]``).
    ``authorization`` gives each request's ``Authorization`` header
    (default: :func:`env_authorization`)."""

    def __init__(self, tracking_uri: str, authorization: Optional[Callable[[], Optional[str]]] = None):
        self.tracking_uri = tracking_uri.rstrip("/")
        self.authorization = authorization or env_authorization
        self.context = tls_context()
        self.artifact_uris = {}

    def _send(self, method: str, url: str, data: Optional[bytes], content_type: str) -> bytes:
        headers = {"Content-Type": content_type}
        authorization = self.authorization()
        if authorization:
            headers["Authorization"] = authorization
        return http_request(method, url, data, headers, self.context)

    def _call(self, method: str, endpoint: str, body: Optional[dict] = None, query: Optional[dict] = None) -> dict:
        url = f"{self.tracking_uri}/api/2.0/mlflow/{endpoint}"
        if query:
            url += "?" + urllib.parse.urlencode(query)
        data = None if body is None else json.dumps(body, allow_nan=False).encode()
        answer = self._send(method, url, data, "application/json")
        return json.loads(answer) if answer.strip() else {}

    def get_experiment_by_name(self, name: str) -> Optional[dict]:
        """The experiment named ``name``; None when the server has none."""
        try:
            return self._call("GET", "experiments/get-by-name", query={"experiment_name": name})["experiment"]
        except MlflowLoggingError as exc:
            if exc.error_code == "RESOURCE_DOES_NOT_EXIST":
                return None
            raise

    def create_experiment(self, name: str) -> str:
        return self._call("POST", "experiments/create", {"name": name})["experiment_id"]

    def create_run(self, experiment_id: str, tags: dict) -> str:
        """A new run's id; its ``artifact_uri`` is kept for
        :meth:`log_artifacts`."""
        run = self._call("POST", "runs/create", {
            "experiment_id": experiment_id, "user_id": "unknown", "start_time": _now_ms(),
            "tags": [{"key": k, "value": str(v)} for k, v in tags.items()]})["run"]
        run_id = run["info"]["run_id"]
        self.artifact_uris[run_id] = run["info"]["artifact_uri"]
        return run_id

    def log_batch(self, run_id: str, metrics=(), params=()) -> None:
        self._call("POST", "runs/log-batch", {
            "run_id": run_id,
            "metrics": [{"key": m.key, "value": _json_number(m.value), "timestamp": int(m.timestamp),
                         "step": int(m.step)} for m in metrics],
            "params": [{"key": p.key, "value": str(p.value)} for p in params],
            "tags": []})

    def log_artifacts(self, run_id: str, local_dir: str) -> None:
        """Every file under ``local_dir`` into the run's artifact store."""
        uri = self.artifact_uris[run_id]
        parts = urllib.parse.urlsplit(uri)
        if parts.scheme in ("", "file"):
            root = urllib.request.url2pathname(parts.path) if parts.scheme else uri
            shutil.copytree(local_dir, root, dirs_exist_ok=True)
            return
        if parts.scheme == "mlflow-artifacts":
            tracking = urllib.parse.urlsplit(self.tracking_uri)
            base = (f"{tracking.scheme}://{parts.netloc or tracking.netloc}{tracking.path}{ARTIFACT_PROXY}/"
                    f"{parts.path.strip('/')}")
        elif parts.scheme in ("http", "https"):
            base = uri.rstrip("/")
        else:
            raise MlflowLoggingError(f"the run's artifact store {uri!r}: the scheme {parts.scheme!r} is not "
                                     "written (mlflow-artifacts, http(s) and file are)")
        for directory, _, files in sorted(os.walk(local_dir)):
            for name in sorted(files):
                path = os.path.join(directory, name)
                relative = os.path.relpath(path, local_dir).replace(os.sep, "/")
                with open(path, "rb") as fh:
                    data = fh.read()
                self._send("PUT", f"{base}/{urllib.parse.quote(relative)}", data,
                           mimetypes.guess_type(name)[0] or "application/octet-stream")

    def set_terminated(self, run_id: str) -> None:
        self._call("POST", "runs/update", {"run_id": run_id, "run_uuid": run_id, "status": "FINISHED",
                                           "end_time": _now_ms()})
