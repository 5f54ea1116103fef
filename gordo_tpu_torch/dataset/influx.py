"""
InfluxDB 1.x reads over HTTP in the standard library: the port's stand-in
for the ``influxdb.DataFrameClient`` that the JAX package's
``InfluxDataProvider`` queries (``gordo_tpu/dataset/data_provider.py``).

:class:`InfluxQueryClient` sends ``GET /query`` with ``db``, ``q`` and
``epoch=ns`` through ``urllib.request``, with HTTP basic auth when the
URI has a user and the API key in its header when one is set, and reads
InfluxDB's JSON: ``results[0].series[*]``, each ``name``, ``columns``
(``time`` first) and ``values``. ``query(q)`` answers ``{measurement:
(ns stamps, values)}`` with float64 values (JSON ``null`` is NaN) of the
query's one field; a measurement split into several series (a ``GROUP
BY``) is concatenated. A ``results[0].error``, an HTTP error or a host
that does not answer raises ``ValueError`` naming the measurement and the
status, never the password.
"""

import base64
import json
import re
import urllib.error
import urllib.parse
import urllib.request
from typing import Dict, Optional, Tuple

import numpy as np

#: seconds a query may take before it fails
TIMEOUT_S = 30.0
_FROM = re.compile(r'FROM "((?:[^"\\]|\\.)*)"')


def parse_uri(uri: str) -> Tuple[str, str, str, int, str]:
    """``(username, password, host, port, database)`` of
    ``<username>:<password>@<host>:<port>/<db_name>``, split as the JAX
    provider splits it (every ``/`` and ``@`` a ``:``; the last piece the
    database).

    >>> parse_uri("gordo:secret@influxdb:8086/sensordb")
    ('gordo', 'secret', 'influxdb', 8086, 'sensordb')
    """
    username, password, host, port, *_, db_name = uri.replace("/", ":").replace("@", ":").split(":")
    return username, password, host, int(port), db_name


class InfluxQueryClient:
    """Queries one InfluxDB 1.x database over HTTP (see the module's
    docstring)."""

    def __init__(self, host: str, port: int, database: str, username: str = "", password: str = "",
                 headers: Optional[Dict[str, str]] = None):
        self.base_url = f"http://{host}:{port}/query"
        self.database = database
        self.username = username
        self._password = password
        self.headers = dict(headers or {})

    @classmethod
    def from_uri(cls, uri: str, headers: Optional[Dict[str, str]] = None) -> "InfluxQueryClient":
        username, password, host, port, database = parse_uri(uri)
        return cls(host, port, database, username, password, headers)

    def _request(self, q: str) -> urllib.request.Request:
        params = urllib.parse.urlencode({"db": self.database, "q": q, "epoch": "ns"})
        request = urllib.request.Request(f"{self.base_url}?{params}", method="GET", headers=self.headers)
        if self.username or self._password:
            token = base64.b64encode(f"{self.username}:{self._password}".encode()).decode()
            request.add_header("Authorization", f"Basic {token}")
        return request

    def _fetch(self, q: str, measurement: str) -> dict:
        where = f"InfluxDB query of measurement {measurement!r} at {self.base_url}"
        try:
            with urllib.request.urlopen(self._request(q), timeout=TIMEOUT_S) as response:
                body = response.read()
        except urllib.error.HTTPError as exc:
            detail = exc.read()[:200].decode(errors="replace")
            raise ValueError(f"{where} failed: HTTP {exc.code} {detail}") from None
        except (urllib.error.URLError, OSError) as exc:
            reason = getattr(exc, "reason", exc)
            raise ValueError(f"{where} failed: no answer ({reason})") from None
        try:
            return json.loads(body)
        except ValueError:
            raise ValueError(f"{where} failed: the answer is not JSON") from None

    def query(self, q: str) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
        """``{measurement: (ns stamps, values)}`` for a ``SELECT`` of one
        field; ``{}`` when nothing matched."""
        named = _FROM.search(q)
        measurement = named.group(1) if named else "?"
        document = self._fetch(q, measurement)
        results = document.get("results") or [{}]
        first = results[0] if isinstance(results, list) and results else {}
        if "error" in first or "error" in document:
            error = first.get("error", document.get("error"))
            raise ValueError(f"InfluxDB query of measurement {measurement!r} failed: status error, {error}")
        out: Dict[str, Tuple[list, list]] = {}
        for series in first.get("series") or []:
            columns = series.get("columns") or []
            values = series.get("values") or []
            if len(columns) < 2 or columns[0] != "time":
                raise ValueError(f"InfluxDB series {series.get('name')!r} has columns {columns}; expected time first")
            stamps, readings = out.setdefault(series.get("name"), ([], []))
            stamps.extend(int(row[0]) for row in values)
            readings.extend(row[1] for row in values)
        return {
            name: (np.array(stamps, np.int64), np.array([np.nan if v is None else v for v in readings], np.float64))
            for name, (stamps, readings) in out.items()
        }
