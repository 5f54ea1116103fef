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

Builders write through :func:`dump_atomic`: the files land in a
``.<name>.tmp-*`` staging sibling, which is renamed into place, so a
crash leaves a complete artifact or none.
"""

import contextlib
import datetime
import hashlib
import json
import os
import pickle
import re
import shutil
import uuid
from os import path
from typing import Any, Callable, List, Optional

from .. import DeviceLike, resolve_device
from ..models.estimators import find_estimator
from ..utils.faults import fault_point

MODEL_FILE = "model.pkl"
METADATA_FILE = "metadata.json"
INFO_FILE = "info.json"

#: the marker of an atomic-write staging entry (``.<name>.tmp-*``)
TMP_DIR_MARKER = ".tmp-"
#: the fleet build's journal and its per-machine event overlay
#: (``parallel/journal.py``), the JAX package's names
BUILD_JOURNAL_FILE = "build_state.json"
BUILD_JOURNAL_EVENTS_FILE = ".build_state.json.events"
#: what the JAX builder (its journal and event overlay), its telemetry and
#: a serving process may write beside the machines of a revision (the
#: names of ``gordo_tpu/serializer/serializer.py:85-147`` and the
#: telemetry modules it imports them from); never models
_DROPPING_NAMES = frozenset((
    BUILD_JOURNAL_FILE,
    BUILD_JOURNAL_EVENTS_FILE,
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


def dump(
    obj: Any,
    dest_dir: str,
    metadata: Optional[dict] = None,
    info: Optional[dict] = None,
    pickled: Optional[bytes] = None,
):
    """Write ``obj`` into ``dest_dir`` as ``model.pkl`` (+ ``metadata.json``
    when given; ``info.json`` always records the model checksum).
    ``pickled``, when given, is written as ``model.pkl`` instead: the bytes
    of an artifact already on disk (pickling an unpickled model again
    memoizes its strings otherwise, and gives other bytes)."""
    os.makedirs(dest_dir, exist_ok=True)
    model_path = path.join(dest_dir, MODEL_FILE)
    with open(model_path, "wb") as f:
        if pickled is None:
            pickle.dump(obj, f)
        else:
            f.write(pickled)
    if metadata is not None:
        with open(path.join(dest_dir, METADATA_FILE), "w") as f:
            json.dump(metadata, f, default=_json_default)
    full_info = {"checksum": _file_checksum(model_path)}
    if info:
        full_info.update(info)
    with open(path.join(dest_dir, INFO_FILE), "w") as f:
        json.dump(full_info, f, default=str)


#: the files of an artifact: a destination holding only these (or nothing)
#: is an earlier artifact, and is replaced whole
_ARTIFACT_FILES = frozenset({MODEL_FILE, METADATA_FILE, INFO_FILE})


def dump_atomic(
    obj: Any,
    dest_dir: str,
    metadata: Optional[dict] = None,
    info: Optional[dict] = None,
    lock: Optional[Any] = None,
    on_landed: Optional[Callable[[], None]] = None,
    pickled: Optional[bytes] = None,
):
    """
    :func:`dump` that a crash cannot leave half done
    (``gordo_tpu/serializer/serializer.py::dump_atomic``): the files are
    written into a ``.<name>.tmp-*`` sibling, made with ``os.mkdir`` so
    it keeps the umask's mode, which ``os.replace`` then renames to
    ``dest_dir``. An earlier artifact there is removed just before the
    rename; a destination holding other files keeps them, and the three
    artifact files are moved in one by one. The ``dump_artifact`` fault
    site fires between the writes and the rename; whatever fails removes
    the staging directory. With a ``lock``, the rename and ``on_landed()``
    run under it, so threads that dump at once land their artifacts one
    at a time, each followed by its own ``on_landed``. ``pickled`` is
    :func:`dump`'s.
    """
    dest_dir = path.normpath(dest_dir)
    parent, name = path.dirname(dest_dir), path.basename(dest_dir)
    os.makedirs(parent or ".", exist_ok=True)
    while True:
        staging = path.join(parent or ".", f".{name}{TMP_DIR_MARKER}{os.getpid()}-{uuid.uuid4().hex[:8]}")
        try:
            os.mkdir(staging)
            break
        except FileExistsError:  # pragma: no cover - a 32-bit collision
            continue
    try:
        dump(obj, staging, metadata=metadata, info=info, pickled=pickled)
        fault_point("dump_artifact", name)
        with lock if lock is not None else contextlib.nullcontext():
            if path.isdir(dest_dir) and not set(os.listdir(dest_dir)) <= _ARTIFACT_FILES:
                for entry in os.listdir(staging):
                    os.replace(path.join(staging, entry), path.join(dest_dir, entry))
                os.rmdir(staging)
            else:
                if path.isdir(dest_dir):
                    # rename(2) does not replace a directory that holds files
                    shutil.rmtree(dest_dir)
                os.replace(staging, dest_dir)
            if on_landed is not None:
                on_landed()
    except BaseException:
        shutil.rmtree(staging, ignore_errors=True)
        raise


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
