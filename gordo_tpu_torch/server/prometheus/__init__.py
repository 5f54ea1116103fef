"""The server's Prometheus exposition, written without ``prometheus_client``."""

from .metrics import GordoServerPrometheusMetrics, create_prometheus_metrics

__all__ = ["GordoServerPrometheusMetrics", "create_prometheus_metrics"]
