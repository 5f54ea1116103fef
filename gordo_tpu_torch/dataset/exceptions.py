"""
The dataset layer's exceptions, a copy of ``gordo_tpu/dataset/exceptions.py``:
the build command maps each to its exit code (``cli/cli.py``).
"""


class ConfigException(ValueError):
    """Invalid dataset or machine configuration."""


class InsufficientDataError(ValueError):
    """The dataset resolved to fewer rows than required."""


class NoSuitableDataProviderError(ValueError):
    """No data provider can serve the requested tags."""
