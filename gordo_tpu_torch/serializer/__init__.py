"""Artifact dump/load with the JAX package's directory layout, and the
model-definition reader and writer (``from_definition``,
``into_definition``)."""

from .from_definition import from_definition
from .into_definition import into_definition
from .serializer import (
    BUILD_JOURNAL_EVENTS_FILE,
    BUILD_JOURNAL_FILE,
    INFO_FILE,
    METADATA_FILE,
    MODEL_FILE,
    dump,
    dump_atomic,
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
    "BUILD_JOURNAL_EVENTS_FILE",
    "BUILD_JOURNAL_FILE",
    "INFO_FILE",
    "METADATA_FILE",
    "MODEL_FILE",
    "dump",
    "dump_atomic",
    "dumps",
    "from_definition",
    "into_definition",
    "is_builder_dropping",
    "is_staging_dir",
    "list_model_dirs",
    "load",
    "load_info",
    "load_metadata",
    "loads",
]
