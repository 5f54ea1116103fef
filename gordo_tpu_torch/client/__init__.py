"""The client of a deployed project (``gordo_tpu/client/``), over
``urllib`` with the port's frames, and the ``client`` command group."""

from .client import Client, HttpResponse, UrllibTransport, WSGITransport
from .forwarders import (
    ForwardPredictionsIntoInflux,
    ForwardPredictionsToDisk,
    PredictionForwarder,
    flatten_columns,
)
from .utils import PredictionResult

__all__ = [
    "Client",
    "ForwardPredictionsIntoInflux",
    "ForwardPredictionsToDisk",
    "HttpResponse",
    "PredictionForwarder",
    "PredictionResult",
    "UrllibTransport",
    "WSGITransport",
    "flatten_columns",
]
