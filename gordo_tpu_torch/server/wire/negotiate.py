"""
Content negotiation for the prediction, anomaly and fleet routes, the
rules of ``gordo_tpu/server/wire/negotiate.py`` (``:25-108``).

- Response: ``?format=parquet`` asks for parquet. Otherwise the
  ``Accept`` header's qualities decide among JSON (``*/*`` and
  ``application/*`` count as JSON), Arrow and parquet: the highest
  quality wins, JSON wins ties and Arrow beats parquet on theirs. A
  header that admits none of the three answers 406. Parquet is served
  on the per-model routes (``parquet_codec.py``); the fleet route
  answers it 406, as the JAX route does.
- Request: an Arrow body selects ``arrow``, a raw parquet body
  ``parquet`` (``X`` only); anything else is ``legacy``: a multipart
  form of parquet files (``server/multipart.py``) or JSON.
- With ``GORDO_TPU_WIRE_ARROW=0`` the port answers as a server without
  the Arrow codec: a header that admits only Arrow answers 406, one that
  admits JSON or parquet beside it forgets Arrow, and an Arrow body
  answers 415.
"""

import re
from typing import Tuple

from ..utils import ServerError
from .arrow_codec import ARROW_CONTENT_TYPE, arrow_enabled
from .parquet_codec import PARQUET_CONTENT_TYPE

JSON_CONTENT_TYPE = "application/json"

#: the response and request formats
JSON, ARROW, PARQUET, LEGACY = "json", "arrow", "parquet", "legacy"

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
    """``json``, ``arrow`` or ``parquet``; 406 when the ``Accept`` header
    admits none of them."""
    if request.arg("format") == "parquet":
        return PARQUET
    accept = request.header("Accept")
    if not accept:
        return JSON
    json_q, arrow_q, parquet_q = accept_qualities(accept)
    if arrow_q > 0 and not arrow_enabled():
        if json_q <= 0 and parquet_q <= 0:
            raise ServerError(
                "Arrow responses unavailable (pyarrow not installed); accept application/json instead",
                status=406,
            )
        arrow_q = 0.0
    if json_q <= 0 and arrow_q <= 0 and parquet_q <= 0:
        raise ServerError(
            "Not acceptable: this route serves application/json, "
            f"{ARROW_CONTENT_TYPE} or {PARQUET_CONTENT_TYPE}",
            status=406,
        )
    if arrow_q > json_q and arrow_q >= parquet_q:
        return ARROW
    return PARQUET if parquet_q > json_q else JSON


def request_format(request) -> str:
    """The body's format by its ``Content-Type``: ``arrow``, ``parquet`` for
    a raw parquet body, else ``legacy`` (a multipart form or JSON); 415
    for an Arrow body with the Arrow codec off."""
    mimetype = (request.header("Content-Type") or "").partition(";")[0].strip().lower()
    if mimetype == ARROW_CONTENT_TYPE:
        if not arrow_enabled():
            raise ServerError(
                "Arrow request bodies unsupported (pyarrow not installed); send application/json", status=415)
        return ARROW
    return PARQUET if mimetype == PARQUET_CONTENT_TYPE else LEGACY
