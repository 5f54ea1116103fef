"""The build reporters (``gordo_tpu/reporters``): what a build runs on each
machine it dumped, from ``runtime.reporters``."""

from .base import BaseReporter, LogReporter, ReporterException, create_reporters
from .mlflow import MlflowLoggingError, MlFlowReporter
from .postgres import PostgresReporter, PostgresReporterException

__all__ = [
    "BaseReporter",
    "LogReporter",
    "ReporterException",
    "create_reporters",
    "MlFlowReporter",
    "MlflowLoggingError",
    "PostgresReporter",
    "PostgresReporterException",
]
