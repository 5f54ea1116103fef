"""Artifact dump/load with the JAX package's directory layout, and the
model-definition reader (``from_definition``)."""

from .from_definition import from_definition
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
    "from_definition",
    "list_model_dirs",
    "load",
    "load_metadata",
]
