"""
The dataset layer in numpy (``gordo_tpu/dataset/`` without pandas): data
providers yield per-tag series, datasets resample and join them into the
rows a build trains on.
"""

from .data_provider import (
    FileDataProvider,
    GordoBaseDataProvider,
    InfluxDataProvider,
    ListBackedDataProvider,
    RandomDataProvider,
)
from .datasets import ArrayDataset, GordoBaseDataset, RandomDataset, TimeSeriesDataset
from .exceptions import ConfigException, InsufficientDataError, NoSuitableDataProviderError
from .sensor_tag import SensorTag, SensorTagNormalizationError

__all__ = [
    "ArrayDataset", "ConfigException", "FileDataProvider", "GordoBaseDataProvider", "GordoBaseDataset",
    "InfluxDataProvider", "InsufficientDataError", "ListBackedDataProvider", "NoSuitableDataProviderError",
    "RandomDataProvider", "RandomDataset", "SensorTag", "SensorTagNormalizationError", "TimeSeriesDataset",
]
