"""
The ``/metrics`` WSGI app (``gordo_tpu/server/prometheus/server.py``),
which the server runs on a second ``wsgiref`` server of its own process
(``python -m gordo_tpu_torch.server --metrics-port``): ``/metrics`` and
``/`` answer the registry's exposition, any other path 404.
"""

from typing import Any, Callable, Dict, Iterable, Optional

from .metrics import register_program_cache_collector
from .registry import CONTENT_TYPE_LATEST, REGISTRY, CollectorRegistry, generate_latest


def build_metrics_app(registry: Optional[CollectorRegistry] = None) -> Callable[..., Iterable[bytes]]:
    """A WSGI app answering scrapes of ``registry`` (default ``REGISTRY``)."""
    if registry is None:
        registry = REGISTRY
    register_program_cache_collector(registry)

    def app(environ: Dict[str, Any], start_response) -> Iterable[bytes]:
        path = (environ.get("PATH_INFO") or "/").rstrip("/")
        if path in ("", "/metrics"):
            body, status, content_type = generate_latest(registry), "200 OK", CONTENT_TYPE_LATEST
        else:
            body, status, content_type = b"Not Found", "404 Not Found", "text/plain; charset=utf-8"
        start_response(status, [("Content-Type", content_type), ("Content-Length", str(len(body)))])
        return [body]

    return app
