"""Machine configs and the build metadata a fleet build writes."""

from .machine import Machine
from .metadata import TrainingSummaryMetadata

__all__ = ["Machine", "TrainingSummaryMetadata"]
