"""Artifact dump/load with the JAX package's directory layout."""

from .serializer import (
    INFO_FILE,
    METADATA_FILE,
    MODEL_FILE,
    dump,
    list_model_dirs,
    load,
    load_metadata,
)

__all__ = [
    "INFO_FILE",
    "METADATA_FILE",
    "MODEL_FILE",
    "dump",
    "list_model_dirs",
    "load",
    "load_metadata",
]
