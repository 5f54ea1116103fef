"""
The HTTP client of a deployed project (``gordo_tpu/client/client.py``),
over ``urllib`` where the JAX client uses ``requests``, with the port's
frames where it uses pandas.

For each target machine the client reads the machine's own dataset
config from the served metadata, fetches the rows of the window through
that dataset (``dataset/``; optionally another data provider), sends
them to the anomaly route in row batches (JSON, parquet multipart, or
Arrow IPC), joins the answers into one ``WireTable`` (rows sorted by
time) and hands it to a :class:`~.forwarders.PredictionForwarder`: the
replay step of a deploy. A failure, the data fetch's included, lands in
that machine's ``error_messages``; a 5xx or a transport error is tried
``n_retries`` times. :meth:`Client.fleet_anomaly_scores` scores every
machine through the fleet route instead, one request a batch of rows,
where the server launches K2 once a bucket.

A ``transport`` is ``transport(method, url, body, headers) ->
HttpResponse``: :class:`UrllibTransport` by default, :class:`WSGITransport`
to call a WSGI application in the same process (tests, the smoke's
reference app), as the JAX tests inject a session.
"""

import io
import json
import logging
import sys
import urllib.error
import urllib.parse
import urllib.request
import uuid
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Tuple

from .. import DeviceLike, serializer
from ..dataset import GordoBaseDataset
from ..machine import Machine
from ..server.wire import (
    PARQUET_CONTENT_TYPE,
    Frame,
    WireColumn,
    WireTable,
    dataframe_into_parquet_bytes,
    table_from_parquet_bytes,
)
from .forwarders import PredictionForwarder
from .io import NotFound, _handle_response
from .utils import (
    ARROW_CONTENT_TYPE,
    PredictionResult,
    concat_tables,
    dataframe_from_arrow_bytes,
    dataframe_into_arrow_bytes,
    frame_to_dict,
    table_from_dict,
)

logger = logging.getLogger(__name__)


class _Headers(dict):
    """Response headers, read case-insensitively."""

    def __init__(self, pairs):
        super().__init__((k.lower(), v) for k, v in pairs)

    def get(self, key, default=None):
        return super().get(key.lower(), default)


class HttpResponse:
    """A response: ``status_code``, ``headers``, ``content``, ``json()``, ``text``."""

    def __init__(self, status_code: int, headers, content: bytes):
        self.status_code = status_code
        self.headers = _Headers(headers)
        self.content = content

    def json(self) -> Any:
        return json.loads(self.content)

    @property
    def text(self) -> str:
        return self.content.decode(errors="replace")


Transport = Callable[[str, str, Optional[bytes], Dict[str, str]], HttpResponse]


class UrllibTransport:
    """Requests over ``urllib``; an HTTP error status is a response, a
    connection failure an ``IOError``."""

    def __init__(self, timeout: float = 300.0):
        self.timeout = timeout

    def __call__(self, method: str, url: str, body: Optional[bytes], headers: Dict[str, str]) -> HttpResponse:
        request = urllib.request.Request(url, data=body, headers=headers, method=method)
        try:
            with urllib.request.urlopen(request, timeout=self.timeout) as response:
                return HttpResponse(response.status, response.headers.items(), response.read())
        except urllib.error.HTTPError as exc:
            return HttpResponse(exc.code, exc.headers.items(), exc.read())
        except urllib.error.URLError as exc:
            raise IOError(f"{method} {url}: {exc.reason}") from exc


class WSGITransport:
    """Requests into a WSGI application in this process: the URL's path
    and query go to ``app``, its scheme and host are ignored."""

    def __init__(self, app: Callable[..., Any]):
        self.app = app

    def __call__(self, method: str, url: str, body: Optional[bytes], headers: Dict[str, str]) -> HttpResponse:
        parts = urllib.parse.urlsplit(url)
        body = body or b""
        environ = {
            "REQUEST_METHOD": method, "PATH_INFO": urllib.parse.unquote(parts.path), "QUERY_STRING": parts.query,
            "CONTENT_LENGTH": str(len(body)), "wsgi.input": io.BytesIO(body), "SERVER_NAME": "localhost",
            "SERVER_PORT": "80", "wsgi.url_scheme": "http", "wsgi.errors": sys.stderr,
        }
        for name, value in headers.items():
            key = name.upper().replace("-", "_")
            environ[key if key in ("CONTENT_TYPE", "CONTENT_LENGTH") else f"HTTP_{key}"] = value
        status: List[Any] = []

        def start_response(line, pairs, exc_info=None):
            status[:] = [int(line.split()[0]), pairs]

        chunks = self.app(environ, start_response)
        try:
            content = b"".join(chunks)
        finally:
            close = getattr(chunks, "close", None)
            if close is not None:
                close()
        return HttpResponse(status[0], status[1], content)


def _multipart(files: Dict[str, bytes]) -> Tuple[bytes, str]:
    """A ``multipart/form-data`` body of parquet files and its content type."""
    boundary = uuid.uuid4().hex
    parts = []
    for name, payload in files.items():
        parts.append(
            f'--{boundary}\r\nContent-Disposition: form-data; name="{name}"; filename="{name}.parquet"\r\n'
            f"Content-Type: {PARQUET_CONTENT_TYPE}\r\n\r\n".encode() + payload + b"\r\n")
    return b"".join(parts) + f"--{boundary}--\r\n".encode(), f"multipart/form-data; boundary={boundary}"


def _lean_table(entry: Dict[str, Any]) -> WireTable:
    """A lean fleet entry (``model-output`` columns by position and the
    per-row ``total-anomaly-unscaled``) as flat columns, as the JAX client
    frames it."""
    outputs = table_from_dict(entry["model-output"])
    mse = table_from_dict({"total-anomaly-unscaled": entry["total-anomaly-unscaled"]})
    columns = [WireColumn(c.group, "", c.values) for c in outputs.columns]
    columns.append(WireColumn("total-anomaly-unscaled", "", mse.columns[0].values))
    return WireTable(outputs.index, columns)


class Client:
    """
    The client of one deployed project.

    ``project`` is the ``/gordo/v0/<project>`` path element; ``host``,
    ``port`` and ``scheme`` say where the server is. ``revision`` pins
    every request to a revision. ``data_provider`` replaces the data
    provider of each machine's dataset config for the fetch.
    ``prediction_forwarder`` gets each machine's joined answer.
    ``batch_size`` is the most rows a request; ``parallelism`` the
    machines scored at once. ``use_arrow`` sends and reads Arrow IPC
    bodies (before ``use_parquet``: parquet multipart uploads and parquet
    answers); JSON otherwise. ``transport`` sends the requests (see the
    module's docstring); ``device`` is where :meth:`download_model` loads
    the models (``cuda`` unless the caller asks for the CPU).
    """

    def __init__(
        self,
        project: str,
        host: str = "localhost",
        port: int = 443,
        scheme: str = "https",
        revision: Optional[str] = None,
        metadata: Optional[dict] = None,
        data_provider: Optional[dict] = None,
        prediction_forwarder: Optional[PredictionForwarder] = None,
        batch_size: int = 100000,
        parallelism: int = 10,
        n_retries: int = 5,
        use_parquet: bool = False,
        use_arrow: bool = False,
        transport: Optional[Transport] = None,
        device: DeviceLike = None,
    ):
        self.project_name = project
        self.base_url = f"{scheme}://{host}:{port}/gordo/v0/{project}"
        self.revision = revision
        self.metadata = metadata if metadata is not None else {}
        self.data_provider = data_provider
        self.prediction_forwarder = prediction_forwarder
        self.batch_size = batch_size
        self.parallelism = parallelism
        self.n_retries = n_retries
        self.use_parquet = use_parquet
        self.use_arrow = use_arrow
        self.transport = transport if transport is not None else UrllibTransport()
        self.device = device

    # -- requests ------------------------------------------------------------------

    def _url(self, path: str, params: Optional[Dict[str, str]] = None) -> str:
        query = dict(params or {})
        if self.revision:
            query["revision"] = self.revision
        return f"{self.base_url}/{path}" + (f"?{urllib.parse.urlencode(query)}" if query else "")

    def _get(self, path: str) -> HttpResponse:
        return self.transport("GET", self._url(path), None, {})

    def _post(self, path: str, body: bytes, content_type: str, params: Optional[Dict[str, str]] = None,
              accept: Optional[str] = None) -> HttpResponse:
        headers = {"Content-Type": content_type}
        if accept:
            headers["Accept"] = accept
        return self.transport("POST", self._url(path, params), body, headers)

    # -- discovery -----------------------------------------------------------------

    def get_revisions(self) -> dict:
        """``{"latest": ..., "available-revisions": [...]}``."""
        return _handle_response(self._get("revisions"), "revisions")

    def get_machine_names(self) -> List[str]:
        """The models of the pinned (or served) revision."""
        return _handle_response(self._get("models"), "model list")["models"]

    def machine_metadata(self, name: str) -> dict:
        """One machine's served metadata document."""
        return _handle_response(self._get(f"{name}/metadata"), f"metadata for {name}")

    def get_metadata(self, targets: Optional[List[str]] = None) -> Dict[str, dict]:
        """``{machine name: machine dict}`` of every (or each listed) machine."""
        return {machine.name: machine.to_dict() for machine in self.get_available_machines(targets)}

    def get_available_machines(self, targets: Optional[List[str]] = None) -> List[Machine]:
        """The machines of the served metadata; ``NotFound`` when a target
        is not deployed."""
        names = self.get_machine_names()
        if targets:
            missing = set(targets) - set(names)
            if missing:
                raise NotFound(f"Machines not deployed: {sorted(missing)}")
            names = [n for n in names if n in set(targets)]
        return [Machine.from_dict(self.machine_metadata(name)["metadata"]) for name in names]

    def download_model(self, targets: Optional[List[str]] = None) -> Dict[str, Any]:
        """``{machine name: model}`` from ``/download-model`` (the
        serializer's pickle), each loaded on the client's ``device``."""
        names = targets if targets else self.get_machine_names()
        return {name: serializer.loads(_handle_response(self._get(f"{name}/download-model"), f"model {name}"),
                                       device=self.device)
                for name in names}

    # -- prediction ----------------------------------------------------------------

    def predict(self, start: Any, end: Any, targets: Optional[List[str]] = None) -> List[PredictionResult]:
        """Every (or each listed) machine's window ``[start, end)`` through
        the anomaly route, ``parallelism`` machines at once; one result a
        machine, forwarded when the client has a forwarder."""
        machines = self.get_available_machines(targets)
        with ThreadPoolExecutor(max_workers=max(1, self.parallelism)) as executor:
            results = list(executor.map(lambda m: self.predict_single_machine(m, start, end), machines))
        if self.prediction_forwarder is not None:
            for machine, result in zip(machines, results):
                if result.predictions is not None and len(result.predictions.index):
                    self.prediction_forwarder.forward_predictions(result.predictions, machine=machine,
                                                                  metadata=self.metadata)
        return results

    def fleet_anomaly_scores(self, start: Any, end: Any, targets: Optional[List[str]] = None,
                             full: bool = False) -> Dict[str, PredictionResult]:
        """Every (or each listed) machine's window through the fleet route,
        a request a batch of ``batch_size`` rows of every machine: lean
        entries (``model-output`` by position and the row's
        ``total-anomaly-unscaled``), or with ``full`` a detector's whole
        anomaly frame. A machine that failed on the server drops out of
        later batches; a batch whose request fails records the failure
        against its machines and keeps the batches already scored."""
        machines = self.get_available_machines(targets)
        results: Dict[str, PredictionResult] = {}

        def fetch(machine):
            try:
                X, _ = self._data_for_window(machine, start, end)
                return machine.name, X, None
            except Exception as exc:  # noqa: BLE001 - a machine's failure is its own
                msg = f"Failed to fetch data for {machine.name}: {exc}"
                logger.error(msg)
                return machine.name, None, msg

        inputs: Dict[str, Frame] = {}
        with ThreadPoolExecutor(max_workers=max(1, self.parallelism)) as executor:
            for name, X, error in executor.map(fetch, machines):
                if error is not None:
                    results[name] = PredictionResult(name=name, predictions=None, error_messages=[error])
                else:
                    inputs[name] = X
        if inputs:
            tables: Dict[str, List[WireTable]] = {}
            errors: Dict[str, List[str]] = {}
            max_rows = max(len(X) for X in inputs.values())
            for chunk_start in range(0, max_rows, self.batch_size):
                chunk = {name: frame_to_dict(X[chunk_start: chunk_start + self.batch_size])
                         for name, X in inputs.items() if name not in errors and len(X) > chunk_start}
                if not chunk:
                    continue
                try:
                    body = self._post_fleet_request(chunk, full=full)
                except Exception as exc:  # noqa: BLE001 - keep the batches already scored
                    msg = f"Fleet request for rows {chunk_start}-{chunk_start + self.batch_size} failed: {exc}"
                    logger.error(msg)
                    for name in chunk:
                        errors.setdefault(name, []).append(msg)
                    continue
                for name, entry in body.get("data", {}).items():
                    lean = not full or set(entry) <= {"model-output", "total-anomaly-unscaled"}
                    tables.setdefault(name, []).append(_lean_table(entry) if lean else table_from_dict(entry))
                for name, error in (body.get("errors") or {}).items():
                    errors.setdefault(name, []).append(str(error.get("error")))
            for name in inputs:
                found = tables.get(name)
                results[name] = PredictionResult(name=name, predictions=concat_tables(found) if found else None,
                                                 error_messages=errors.get(name, []))
        if self.prediction_forwarder is not None:
            for machine in machines:
                result = results.get(machine.name)
                if result is not None and result.predictions is not None and len(result.predictions.index):
                    self.prediction_forwarder.forward_predictions(result.predictions, machine=machine,
                                                                  metadata=self.metadata)
        return results

    def _post_fleet_request(self, payload: Dict[str, dict], full: bool = False) -> dict:
        """One fleet request, tried as the per-machine requests are; a 400
        whose body holds the machines' errors is an answer (every machine
        failed on the server), not an exception."""
        request_body: Dict[str, Any] = {"X": payload}
        if full:
            request_body["full"] = True
        body = json.dumps(request_body).encode()
        last_exc: Optional[Exception] = None
        for attempt in range(max(1, self.n_retries)):
            try:
                resp = self._post("prediction/fleet", body, "application/json")
                if resp.status_code == 400:
                    try:
                        answer = resp.json()
                    except ValueError:
                        answer = None
                    if isinstance(answer, dict) and answer.get("errors"):
                        return answer
                return _handle_response(resp, "fleet prediction")
            except IOError as exc:  # a 5xx or the transport: tried again
                last_exc = exc
                logger.warning("Fleet prediction attempt %d/%d failed: %s", attempt + 1, self.n_retries, exc)
        raise last_exc

    def predict_single_machine(self, machine: Machine, start: Any, end: Any) -> PredictionResult:
        """The machine's window through the anomaly route in batches of
        ``batch_size`` rows, the answers joined."""
        tables: List[WireTable] = []
        errors: List[str] = []
        try:
            X, y = self._data_for_window(machine, start, end)
        except Exception as exc:  # noqa: BLE001 - the data fetch's failure is the machine's
            msg = f"Failed to fetch data for {machine.name}: {exc}"
            logger.error(msg)
            return PredictionResult(name=machine.name, predictions=None, error_messages=[msg])
        for batch_start in range(0, len(X), self.batch_size):
            X_batch = X[batch_start: batch_start + self.batch_size]
            y_batch = y[batch_start: batch_start + self.batch_size] if y is not None else None
            try:
                tables.append(self._send_prediction_request(machine.name, X_batch, y_batch))
            except Exception as exc:  # noqa: BLE001 - a batch's failure is recorded
                msg = (f"Failed prediction rows {batch_start}-{batch_start + len(X_batch)} for "
                       f"{machine.name}: {exc}")
                logger.error(msg)
                errors.append(msg)
        return PredictionResult(name=machine.name, predictions=concat_tables(tables) if tables else None,
                                error_messages=errors)

    def _data_for_window(self, machine: Machine, start: Any, end: Any) -> Tuple[Frame, Frame]:
        """``(X, y)`` of the window: the machine's own dataset config
        pointed at it (and at ``data_provider`` when the client has one)."""
        dataset = machine.dataset
        config = dict(dataset.to_dict() if isinstance(dataset, GordoBaseDataset) else dataset)
        config["train_start_date"] = start
        config["train_end_date"] = end
        if self.data_provider is not None:
            config["data_provider"] = self.data_provider
        dataset = GordoBaseDataset.from_dict(config)
        X, y, index = dataset.get_data()
        x_names, y_names = dataset.column_names()
        return Frame(list(index), x_names, X), Frame(list(index), y_names, y)

    def _send_prediction_request(self, machine_name: str, X: Frame, y: Optional[Frame]) -> WireTable:
        path = f"{machine_name}/anomaly/prediction"
        last_exc: Optional[Exception] = None
        for attempt in range(max(1, self.n_retries)):
            try:
                if self.use_arrow:
                    resp = self._post(path, dataframe_into_arrow_bytes(X, y), ARROW_CONTENT_TYPE,
                                      accept=ARROW_CONTENT_TYPE)
                elif self.use_parquet:
                    files = {"X": dataframe_into_parquet_bytes(X)}
                    if y is not None:
                        files["y"] = dataframe_into_parquet_bytes(y)
                    body, content_type = _multipart(files)
                    resp = self._post(path, body, content_type, params={"format": "parquet"})
                else:
                    payload = {"X": frame_to_dict(X)}
                    if y is not None:
                        payload["y"] = frame_to_dict(y)
                    resp = self._post(path, json.dumps(payload).encode(), "application/json")
                answer = _handle_response(resp, f"prediction for {machine_name}")
                break
            except IOError as exc:  # a 5xx or the transport: tried again
                last_exc = exc
                logger.warning("Prediction attempt %d/%d for %s failed: %s", attempt + 1, self.n_retries,
                               machine_name, exc)
        else:
            raise last_exc
        if isinstance(answer, bytes):
            return dataframe_from_arrow_bytes(answer) if self.use_arrow else table_from_parquet_bytes(answer)
        return table_from_dict(answer["data"])

