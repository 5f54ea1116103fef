"""
Prediction forwarders (``gordo_tpu/client/forwarders.py``): the sinks a
client hands each machine's joined answer to, one call a machine.

- :func:`flatten_columns`: two-level ``(group, sub)`` columns as flat
  pipe-joined names (``model-input|tag-1``, ``total-anomaly-scaled``),
  the sinks' column format, which ``score`` writes too.
- :class:`ForwardPredictionsToDisk`: ``<destination>/<machine>.parquet``,
  a later call's rows appended (``server/wire/parquet_codec.py``).
- :class:`ForwardPredictionsIntoInflux`: the rows as InfluxDB 1.x line
  protocol, POSTed to ``/write`` over ``urllib`` (the JAX forwarder
  writes them through ``influxdb.DataFrameClient.write_points``, which
  the card's machine lacks): measurement ``predictions``, tag
  ``machine=<name>``, one field a column (a null skipped), the row's
  time in nanoseconds.
"""

import abc
import base64
import logging
import math
import os
import urllib.error
import urllib.parse
import urllib.request
from datetime import datetime, timezone
from typing import Any, List, Optional

import numpy as np

from ..dataset.influx import parse_uri
from ..dataset.series import datetime_ns
from ..server.wire import WireColumn, WireTable, dataframe_into_parquet_bytes, table_from_parquet_bytes
from .utils import concat_tables

logger = logging.getLogger(__name__)


class PredictionForwarder(abc.ABC):
    """One call a machine, with its joined answer."""

    @abc.abstractmethod
    def forward_predictions(self, predictions: WireTable, machine: Any = None, metadata: Optional[dict] = None) -> None:
        ...


def flat_name(group: str, sub: str) -> str:
    """A column's flat name: ``group|sub``, the trailing pipes stripped."""
    return f"{group}|{sub}".rstrip("|")


def flatten_columns(predictions: WireTable) -> WireTable:
    """The table with flat pipe-joined column names (each column's group;
    its sub empty). A table whose columns are flat already keeps them."""
    columns = [WireColumn(flat_name(c.group, c.sub), "", c.values) for c in predictions.columns]
    return WireTable(predictions.index, columns, predictions.unit)


def flat_parquet_bytes(predictions: WireTable) -> bytes:
    """The table as a parquet file of flat columns."""
    return dataframe_into_parquet_bytes(flatten_columns(predictions), flat=True)


class ForwardPredictionsToDisk(PredictionForwarder):
    """Each machine's rows into ``<destination>/<machine-name>.parquet``,
    appended to the rows already there."""

    def __init__(self, destination: str):
        self.destination = destination
        os.makedirs(destination, exist_ok=True)

    def forward_predictions(self, predictions: WireTable, machine: Any = None, metadata: Optional[dict] = None) -> None:
        name = machine.name if machine is not None else "predictions"
        path = os.path.join(self.destination, f"{name}.parquet")
        frame = flatten_columns(predictions)
        if os.path.exists(path):
            with open(path, "rb") as f:
                frame = concat_tables([table_from_parquet_bytes(f.read()), frame], sort=False)
        with open(path, "wb") as f:
            f.write(dataframe_into_parquet_bytes(frame, flat=True))
        logger.info("Forwarded %d rows for %s to %s", len(predictions.index), name, path)


def _escape_key(text: str) -> str:
    """A measurement, tag or field key of the line protocol: commas,
    equals signs and spaces escaped."""
    return text.replace("\\", "\\\\").replace(",", "\\,").replace("=", "\\=").replace(" ", "\\ ")


def _field_value(value: Any) -> Optional[str]:
    if value is None:
        return None
    if isinstance(value, (bool, np.bool_)):
        return "true" if value else "false"
    if isinstance(value, (int, np.integer)):
        return f"{int(value)}i"
    if isinstance(value, (float, np.floating)):
        return None if math.isnan(value) else repr(float(value))
    text = str(value).replace("\\", "\\\\").replace('"', '\\"')
    return f'"{text}"'


def _time_ns(value: Any) -> int:
    if isinstance(value, datetime):
        return datetime_ns(value if value.tzinfo is not None else value.replace(tzinfo=timezone.utc))
    return int(value)


def line_protocol(predictions: WireTable, measurement: str, tags: dict) -> List[str]:
    """One line a row of the flattened table: ``measurement,tags
    field=value,... time``, a row without a field left out."""
    table = flatten_columns(predictions)
    head = _escape_key(measurement) + "".join(f",{_escape_key(str(k))}={_escape_key(str(v))}"
                                              for k, v in sorted(tags.items()))
    keys = [_escape_key(c.group) for c in table.columns]
    cells = [np.asarray(c.values).tolist() for c in table.columns]
    lines = []
    for row, stamp in enumerate(table.index):
        fields = []
        for key, column in zip(keys, cells):
            value = _field_value(column[row])
            if value is not None:
                fields.append(f"{key}={value}")
        if fields:
            lines.append(f"{head} {','.join(fields)} {_time_ns(stamp)}")
    return lines


class ForwardPredictionsIntoInflux(PredictionForwarder):
    """Each machine's rows as InfluxDB measurements (see the module's
    docstring); ``destination_influx_uri`` is
    ``<user>:<password>@<host>:<port>/<db>``, ``destination_influx_api_key``
    goes in the ``Ocp-Apim-Subscription-Key`` header, and
    ``destination_influx_recreate`` drops and creates the database first.
    A write is tried ``n_retries`` times."""

    def __init__(self, destination_influx_uri: Optional[str] = None, destination_influx_api_key: Optional[str] = None,
                 destination_influx_recreate: bool = False, n_retries: int = 5, timeout: float = 30.0):
        if not destination_influx_uri:
            raise ValueError("destination_influx_uri is required (<username>:<password>@<host>:<port>/<db_name>)")
        self.destination_influx_uri = destination_influx_uri
        self.destination_influx_api_key = destination_influx_api_key
        self.destination_influx_recreate = destination_influx_recreate
        self.n_retries = n_retries
        self.timeout = timeout
        self.username, self.password, host, port, self.database = parse_uri(destination_influx_uri)
        self.base_url = f"http://{host}:{port}"
        if destination_influx_recreate:
            self._post("/query", {"q": f'DROP DATABASE "{self.database}"'}, b"")
            self._post("/query", {"q": f'CREATE DATABASE "{self.database}"'}, b"")

    def _post(self, path: str, params: dict, body: bytes) -> None:
        url = f"{self.base_url}{path}?{urllib.parse.urlencode(params)}"
        request = urllib.request.Request(url, data=body, method="POST")
        request.add_header("Content-Type", "text/plain; charset=utf-8")
        if self.username:
            token = base64.b64encode(f"{self.username}:{self.password}".encode()).decode()
            request.add_header("Authorization", f"Basic {token}")
        if self.destination_influx_api_key:
            request.add_header("Ocp-Apim-Subscription-Key", self.destination_influx_api_key)
        with urllib.request.urlopen(request, timeout=self.timeout) as response:
            response.read()

    def forward_predictions(self, predictions: WireTable, machine: Any = None, metadata: Optional[dict] = None) -> None:
        name = machine.name if machine is not None else "predictions"
        body = "\n".join(line_protocol(predictions, "predictions", {"machine": name})).encode()
        for attempt in range(self.n_retries):
            try:
                self._post("/write", {"db": self.database, "precision": "n"}, body)
                return
            except (OSError, urllib.error.URLError):
                if attempt == self.n_retries - 1:
                    raise
                logger.warning("Influx write retry %d for %s", attempt + 1, name)
