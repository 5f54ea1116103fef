"""Machine configs, their loading, and the build metadata a fleet build writes."""

from .loader import load_globals_config, load_machine_config
from .machine import Machine
from .metadata import TrainingSummaryMetadata

__all__ = ["Machine", "TrainingSummaryMetadata", "load_globals_config", "load_machine_config"]
