"""Artifact dump/load with the JAX package's directory layout, and the
model-definition reader (``from_definition``)."""

from .from_definition import from_definition
from .serializer import (
    INFO_FILE,
    METADATA_FILE,
    MODEL_FILE,
    dump,
    dumps,
    is_builder_dropping,
    is_staging_dir,
    list_model_dirs,
    load,
    load_info,
    load_metadata,
    loads,
)

__all__ = [
    "INFO_FILE",
    "METADATA_FILE",
    "MODEL_FILE",
    "dump",
    "dumps",
    "from_definition",
    "is_builder_dropping",
    "is_staging_dir",
    "list_model_dirs",
    "load",
    "load_info",
    "load_metadata",
    "loads",
]
