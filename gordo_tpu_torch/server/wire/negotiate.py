"""
Content negotiation for the prediction, anomaly and fleet routes, with
the rules the JAX server follows when it has no pyarrow
(``gordo_tpu/server/wire/negotiate.py``): the port serves JSON only.

- Response: ``?format=parquet`` asks for parquet. Otherwise the
  ``Accept`` header's qualities decide among JSON (``*/*`` and
  ``application/*`` count as JSON, and JSON wins ties), Arrow and
  parquet. A header that admits only Arrow, or none of the three,
  answers 406. Parquet is chosen, and then refused: 415 on the per-model
  routes, when the response is encoded; 406 on the fleet route.
- Request: an Arrow body answers 415, a raw parquet body 415 on the
  per-model routes; anything else is read as JSON.
"""

import re
from typing import Tuple

from ..utils import ServerError

JSON_CONTENT_TYPE = "application/json"
ARROW_CONTENT_TYPE = "application/vnd.apache.arrow.stream"
PARQUET_CONTENT_TYPE = "application/x-parquet"

#: the response and request formats
JSON, PARQUET, LEGACY = "json", "parquet", "legacy"

#: the answer of a route asked for parquet, which needs pyarrow
PARQUET_UNAVAILABLE = "Parquet wire format unavailable (pyarrow not installed); use JSON"

_QUALITY = re.compile(r"-?\d+(\.\d+)?")


def _accept_items(header: str):
    """``(media type, quality)`` of each item of an ``Accept`` header, as
    werkzeug parses it: an invalid or out-of-range ``q`` drops the item,
    other parameters stay part of the type."""
    for item in header.split(","):
        media, _, rest = item.partition(";")
        media, params, quality = media.strip(), [], 1.0
        for param in filter(None, (p.strip() for p in rest.split(";"))):
            key, _, value = param.partition("=")
            if key.strip().lower() != "q":
                params.append(param)
                continue
            if _QUALITY.fullmatch(value.strip()) is None:
                break
            quality = float(value)
            if not 0.0 <= quality <= 1.0:
                break
        else:
            if media:
                yield "; ".join([media, *params]), quality


def accept_qualities(header: str) -> Tuple[float, float, float]:
    """``(json_q, arrow_q, parquet_q)`` of an ``Accept`` header.

    >>> accept_qualities("text/csv, application/*;q=0.5")
    (0.5, 0.0, 0.0)
    """
    json_q = arrow_q = parquet_q = 0.0
    for media, quality in _accept_items(header):
        media = media.lower()
        if media in (JSON_CONTENT_TYPE, "application/*", "*/*"):
            json_q = max(json_q, quality)
        elif media == ARROW_CONTENT_TYPE:
            arrow_q = max(arrow_q, quality)
        elif media == PARQUET_CONTENT_TYPE:
            parquet_q = max(parquet_q, quality)
    return json_q, arrow_q, parquet_q


def response_format(request) -> str:
    """``json`` or ``parquet``; 406 when the ``Accept`` header admits
    neither JSON nor parquet."""
    if request.arg("format") == "parquet":
        return PARQUET
    accept = request.header("Accept")
    if not accept:
        return JSON
    json_q, arrow_q, parquet_q = accept_qualities(accept)
    if arrow_q > 0 and json_q <= 0 and parquet_q <= 0:
        raise ServerError(
            "Arrow responses unavailable (pyarrow not installed); accept application/json instead",
            status=406,
        )
    if json_q <= 0 and parquet_q <= 0:
        raise ServerError(
            "Not acceptable: this route serves application/json, "
            f"{ARROW_CONTENT_TYPE} or {PARQUET_CONTENT_TYPE}",
            status=406,
        )
    return PARQUET if parquet_q > json_q else JSON


def request_format(request) -> str:
    """The body's format by its ``Content-Type``: ``parquet`` for a raw
    parquet body, else ``legacy`` (JSON); 415 for an Arrow body."""
    mimetype = (request.header("Content-Type") or "").partition(";")[0].strip().lower()
    if mimetype == ARROW_CONTENT_TYPE:
        raise ServerError("Arrow request bodies unsupported (pyarrow not installed); send application/json", status=415)
    return PARQUET if mimetype == PARQUET_CONTENT_TYPE else LEGACY
