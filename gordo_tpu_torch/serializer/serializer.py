"""
Disk serialization of served models, with the JAX package's artifact
layout (``gordo_tpu/serializer/serializer.py``): a model directory holds
``model.pkl`` (the pickled port objects, numpy params only, so it loads
on any device), ``metadata.json`` and ``info.json`` (with the model
file's checksum). A revision directory holds one such directory per
machine.
"""

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

#: directories a builder or a serving process may leave beside the
#: machines of a revision; never models
_DROPPING_DIRS = re.compile(r"^(rollups|fleet_health(-\d+)?\.d)$")


def _file_checksum(file_path: str) -> str:
    digest = hashlib.md5()
    with open(file_path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            digest.update(chunk)
    return digest.hexdigest()


def dump(obj: Any, dest_dir: str, metadata: Optional[dict] = None, info: Optional[dict] = None):
    """Write ``obj`` into ``dest_dir`` as ``model.pkl`` (+ ``metadata.json``
    when given; ``info.json`` always records the model checksum)."""
    os.makedirs(dest_dir, exist_ok=True)
    model_path = path.join(dest_dir, MODEL_FILE)
    with open(model_path, "wb") as f:
        pickle.dump(obj, f)
    if metadata is not None:
        with open(path.join(dest_dir, METADATA_FILE), "w") as f:
            json.dump(metadata, f, default=str)
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
        model = pickle.load(f)
    estimator = find_estimator(model)
    if estimator is not None:
        estimator.to(device)
    return model


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


def list_model_dirs(directory: str) -> List[str]:
    """Names of the model directories of a revision: directories only,
    dot-entries (staging dirs) and telemetry droppings excluded. A missing
    directory has none."""
    try:
        entries = os.listdir(directory)
    except FileNotFoundError:
        return []
    return sorted(
        entry
        for entry in entries
        if not entry.startswith(".")
        and not _DROPPING_DIRS.match(entry)
        and path.isdir(path.join(directory, entry))
    )
