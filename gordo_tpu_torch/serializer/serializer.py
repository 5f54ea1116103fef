"""
Disk serialization of served models, with the JAX package's artifact
layout (``gordo_tpu/serializer/serializer.py``): a model directory holds
``model.pkl`` (the pickled port objects, numpy params only, so it loads
on any device), ``metadata.json`` and ``info.json`` (with the model
file's checksum). A revision directory holds one such directory per
machine, beside whatever a builder or a serving process left there
(:func:`is_builder_dropping`). The pickle bytes (:func:`dumps` /
:func:`loads`) are the server's ``/download-model`` wire format: the
layout is the JAX package's, the pickled classes are the port's.
"""

import datetime
import hashlib
import json
import os
import pickle
import re
from os import path
from typing import Any, List, Optional

from .. import DeviceLike, resolve_device
from ..models.estimators import find_estimator

MODEL_FILE = "model.pkl"
METADATA_FILE = "metadata.json"
INFO_FILE = "info.json"

#: the marker of an atomic-write staging entry (``.<name>.tmp-*``)
TMP_DIR_MARKER = ".tmp-"
#: what the JAX builder (its journal and event overlay), its telemetry and
#: a serving process may write beside the machines of a revision (the
#: names of ``gordo_tpu/serializer/serializer.py:85-147`` and the
#: telemetry modules it imports them from); never models
_DROPPING_NAMES = frozenset((
    "build_state.json",
    ".build_state.json.events",
    "build_status.json",
    "build_trace.jsonl",
    "serve_trace.jsonl",
    "fleet_health.json",
    "fleet_health.d",
    "rollups",
    "slo_state.json",
    "slos.toml",
))
#: rotated generations of the two trace sinks (``build_trace.jsonl.1``)
_ROTATED = ("build_trace.jsonl.", "serve_trace.jsonl.")
#: per-worker sink variants, ``<stem>-<pid><ext>``, a rotation suffix allowed
_WORKER_SINKS = (("serve_trace-", ".jsonl"), ("fleet_health-", ".json"), ("fleet_health-", ".d"))


def _file_checksum(file_path: str) -> str:
    digest = hashlib.md5()
    with open(file_path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            digest.update(chunk)
    return digest.hexdigest()


def _json_default(obj: Any) -> str:
    """A datetime in ``metadata.json`` as ISO 8601, as the JAX package
    writes it; anything else as ``str``."""
    return obj.isoformat() if isinstance(obj, (datetime.date, datetime.datetime)) else str(obj)


def dump(obj: Any, dest_dir: str, metadata: Optional[dict] = None, info: Optional[dict] = None):
    """Write ``obj`` into ``dest_dir`` as ``model.pkl`` (+ ``metadata.json``
    when given; ``info.json`` always records the model checksum)."""
    os.makedirs(dest_dir, exist_ok=True)
    model_path = path.join(dest_dir, MODEL_FILE)
    with open(model_path, "wb") as f:
        pickle.dump(obj, f)
    if metadata is not None:
        with open(path.join(dest_dir, METADATA_FILE), "w") as f:
            json.dump(metadata, f, default=_json_default)
    full_info = {"checksum": _file_checksum(model_path)}
    if info:
        full_info.update(info)
    with open(path.join(dest_dir, INFO_FILE), "w") as f:
        json.dump(full_info, f, default=str)


def load(source_dir: str, device: DeviceLike = None) -> Any:
    """The model saved in ``source_dir`` by :func:`dump`, its autoencoder
    placed on ``device`` (``cuda`` unless the caller asks for the CPU).
    Unpickles: load only artifacts this program (or its builder) wrote."""
    device = resolve_device(device)
    with open(path.join(source_dir, MODEL_FILE), "rb") as f:
        return loads(f.read(), device)


def _load_json_file(source_dir: str, filename: str) -> dict:
    """A JSON artifact beside the model or one directory up."""
    for candidate_dir in (source_dir, path.dirname(path.normpath(source_dir))):
        candidate = path.join(candidate_dir, filename)
        if path.isfile(candidate):
            with open(candidate) as f:
                return json.load(f)
    raise FileNotFoundError(
        f"{filename} not found in {source_dir} or its parent directory"
    )


def load_metadata(source_dir: str) -> dict:
    return _load_json_file(source_dir, METADATA_FILE)


def load_info(source_dir: str) -> dict:
    """``info.json`` of a model directory (or its parent)."""
    return _load_json_file(source_dir, INFO_FILE)


def dumps(model: Any) -> bytes:
    """``model`` as pickle bytes, device-independent like ``model.pkl``."""
    return pickle.dumps(model)


def loads(bytes_object: bytes, device: DeviceLike = None) -> Any:
    """A model from :func:`dumps` bytes, its autoencoder placed on
    ``device`` (``cuda`` unless the caller asks for the CPU). Unpickles:
    load only bytes this program (or its server) wrote."""
    device = resolve_device(device)
    model = pickle.loads(bytes_object)
    estimator = find_estimator(model)
    if estimator is not None:
        estimator.to(device)
    return model


def is_staging_dir(name: str) -> bool:
    """True for atomic-write staging entries (``.<name>.tmp-*``), which
    may be half-written."""
    return name.startswith(".") and TMP_DIR_MARKER in name


def is_builder_dropping(name: str) -> bool:
    """True for a directory entry that is not a model but a builder's or a
    serving process's: the build journal and its event overlay, the
    telemetry files (rotated generations and per-worker variants
    included), the SLO engine's files and staging leftovers. A revision
    holding only these is empty."""
    root = re.sub(r"\.\d+$", "", name)
    return (
        name in _DROPPING_NAMES
        or name.startswith(_ROTATED)
        or any(root.startswith(stem) and root.endswith(ext) for stem, ext in _WORKER_SINKS)
        or is_staging_dir(name)
    )


def list_model_dirs(directory: str) -> List[str]:
    """Names of the model directories of a revision: directories only,
    dot-entries and builder droppings excluded. A missing directory has
    none."""
    try:
        entries = os.listdir(directory)
    except FileNotFoundError:
        return []
    return sorted(
        entry
        for entry in entries
        if not entry.startswith(".")
        and not is_builder_dropping(entry)
        and path.isdir(path.join(directory, entry))
    )
