"""
Request helpers of the per-model routes, a port of the parts of
``gordo_tpu/server/utils.py`` that serve JSON: name and revision
validation, the ``metadata.json`` check a request repeats (a DELETE may
remove a revision under the store), revision deletion, and model and
metadata resolution; and :func:`stash_raw_columns`, which keeps an Arrow
or parquet request's decoded X columns for the device ingest.

Errors are :class:`ServerError`: a message answered as ``{key: message}``
with an HTTP status.
"""

import os
import re
import shutil
from typing import Any, Mapping, Optional, Sequence, Tuple

import numpy as np

from .. import serializer
from ..ingest import RawColumns

gordo_name_re = re.compile(r"^[a-zA-Z\d-]+")
revision_re = re.compile(r"\d+")


class ServerError(Exception):
    """An error answered as ``{key: message}`` with an HTTP status."""

    def __init__(self, message: str, status: int = 400, key: str = "message"):
        super().__init__(message)
        self.status = status
        self.payload = {key: message}


def validate_revision(revision: str) -> bool:
    """A revision is a directory name of digits and nothing else (it is
    echoed into a response header).

    >>> validate_revision("1602324482000"), validate_revision("12\\n")
    (True, False)
    """
    return revision_re.fullmatch(revision) is not None


def validate_gordo_name(gordo_name: str) -> None:
    """Model names start with letters, digits or dashes; 422 otherwise."""
    if gordo_name and not gordo_name_re.match(gordo_name):
        raise ServerError("gordo_name field has wrong format", status=422)


def check_metadata_file(directory: str, name: str) -> None:
    """``FileNotFoundError`` unless ``name``'s ``metadata.json`` lies
    beside the model or one directory up. Checked on every request: a
    DELETE removes revisions under the store's cache."""
    model_dir = os.path.join(directory, name)
    for candidate_dir in (model_dir, directory):
        if os.path.isfile(os.path.join(candidate_dir, serializer.METADATA_FILE)):
            return
    raise FileNotFoundError("Unable to load metadata.json file")


def delete_revision(store, directory: str, name: str) -> None:
    """Delete model ``name`` from the revision ``directory``, drop the
    revision from ``store``, and delete the directory itself once only
    builder droppings are left in it."""
    full_path = os.path.join(directory, name)
    if not os.path.isfile(os.path.join(full_path, serializer.METADATA_FILE)):
        raise ServerError("Not found", status=404)
    shutil.rmtree(full_path, ignore_errors=True)
    store.invalidate(directory)
    if os.path.exists(full_path):
        raise ServerError("Unable to delete this model revision folder", status=500)
    if all(serializer.is_builder_dropping(entry) for entry in os.listdir(directory)):
        shutil.rmtree(directory, ignore_errors=True)
        if os.path.exists(directory):
            raise ServerError("Unable to delete this revision folder", status=500)


def resolve_model(ctx, gordo_name: str):
    """The scoring routes' model resolution through the request's
    revision fleet (its model is then ``ctx.model``, which the health
    ledger counts): 422 for a malformed name, 404 when there is no such
    model."""
    try:
        resolution = ctx.resolve(gordo_name)
    except FileNotFoundError:
        raise ServerError(f"No such model found: '{gordo_name}'", status=404)
    ctx.model = resolution.model
    return resolution


def require_metadata(ctx, gordo_name: str) -> Tuple[dict, dict]:
    """``(info, metadata)`` of ``gordo_name`` in the request's revision,
    without loading the model: ``info`` is ``{}`` when there is none;
    422 for a malformed name, 404 when there is no metadata."""
    validate_gordo_name(gordo_name)
    model_dir = os.path.join(ctx.collection_dir, gordo_name)
    try:
        info = serializer.load_info(model_dir)
    except FileNotFoundError:
        info = {}
    try:
        check_metadata_file(ctx.collection_dir, gordo_name)
        return info, serializer.load_metadata(model_dir)
    except FileNotFoundError:
        raise ServerError(f"No metadata found for '{gordo_name}'", status=404)


def stash_raw_columns(ctx, x_columns: Mapping[str, np.ndarray], index: Optional[Sequence[Any]],
                      names: Sequence[str]) -> None:
    """Keep the decoded X columns beside the assembled frame as
    ``ctx.ingest`` (``gordo_tpu/server/utils.py:323-341``), so the device
    ingest gathers them straight into its staging buffer and the frame is
    never stacked on the host;
    only where they match the frame row for row and column for column: an
    index in order (the decode sorts rows otherwise), the frame's
    ``names`` keying into the wire columns (a positional rename does not),
    and every column 1-D. Otherwise nothing is kept, which is never
    wrong."""
    if index is not None and any(b < a for a, b in zip(index, index[1:])):
        return
    try:
        columns = [np.asarray(x_columns[name]) for name in names]
    except KeyError:
        return
    if columns and all(c.ndim == 1 for c in columns):
        ctx.ingest = RawColumns.from_columns(columns)
