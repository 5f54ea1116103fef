"""
The client's reading of a response (``gordo_tpu/client/io.py``): a 2xx
answer is its JSON document or its bytes; a failure is the typed
exception of its status, so that a caller can tell bad input (422), a
bad request (another 4xx), an unknown model (404) and a deleted revision
(410) apart; any other status is an ``IOError``, which the client
retries.
"""

from typing import Any, Optional, Union


class HttpUnprocessableEntity(Exception):
    """HTTP 422: the server understood the request and refused its input
    (an anomaly request to a model that is not a detector)."""


class BadGordoRequest(Exception):
    """Any other 4xx."""


class NotFound(Exception):
    """HTTP 404: no such project, model or revision."""


class ResourceGone(Exception):
    """HTTP 410: the revision asked for is gone."""


def _handle_response(resp: Any, resource_name: Optional[str] = None) -> Union[dict, bytes]:
    """The decoded body of a 2xx ``resp`` (its JSON document when its
    content type says JSON, else its bytes), or the exception of its
    status. ``resp`` has ``status_code``, ``headers`` (``get``),
    ``content``, ``json()`` and ``text``."""
    if 200 <= resp.status_code <= 299:
        is_json = "application/json" in resp.headers.get("content-type", "")
        return resp.json() if is_json else resp.content
    context = f" ({resource_name})" if resource_name else ""
    content = getattr(resp, "text", "")[:150]
    msg = f"HTTP {resp.status_code}{context}: {content}"
    if resp.status_code == 422:
        raise HttpUnprocessableEntity(msg)
    if resp.status_code == 410:
        raise ResourceGone(msg)
    if resp.status_code == 404:
        raise NotFound(msg)
    if 400 <= resp.status_code <= 499:
        raise BadGordoRequest(msg)
    raise IOError(msg)
