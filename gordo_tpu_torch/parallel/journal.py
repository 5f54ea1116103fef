"""
The fleet build's journal, ``<output_dir>/build_state.json``
(``gordo_tpu/parallel/journal.py``): each machine's status
(``planned``, ``data_loaded``, ``cv_done``, ``built``, or ``failed``) and
its config hash. A phase's statuses are written together by
:meth:`BuildJournal.flush`, an atomic replace of the whole file; each
machine's ``built`` appends one line to the event overlay
``.build_state.json.events``, so the dump of N machines writes O(N)
bytes, and :meth:`BuildJournal.load` reads the overlay over the base,
skipping a torn last line. ``build-fleet --resume`` skips the machines
:meth:`BuildJournal.resumable` names: journaled ``built`` under the same
config hash, with an artifact whose ``model.pkl`` matches the checksum
in its ``info.json``.

The file names and the JSON layout are the JAX package's, so a journal
written by either package loads in the other. The server skips both
files (``serializer.is_builder_dropping``).
"""

import contextlib
import json
import logging
import os
import shutil
import threading
import time
from typing import Any, Dict, List, Optional

from .. import serializer
from ..serializer.serializer import (
    BUILD_JOURNAL_EVENTS_FILE,
    BUILD_JOURNAL_FILE,
    TMP_DIR_MARKER,
    _file_checksum,
    is_staging_dir,
)

logger = logging.getLogger(__name__)

JOURNAL_FILE = BUILD_JOURNAL_FILE
EVENTS_FILE = BUILD_JOURNAL_EVENTS_FILE

#: machine statuses in build order (``failed`` may follow any of them)
STATUSES = ("planned", "data_loaded", "cv_done", "built", "failed")


class BuildJournal:
    """Each machine's build status, persisted as it changes; safe to
    record from the dump's threads."""

    def __init__(self, output_dir: str):
        self.output_dir = output_dir
        self.path = os.path.join(output_dir, JOURNAL_FILE)
        self.events_path = os.path.join(output_dir, EVENTS_FILE)
        self._lock = threading.Lock()
        self._machines: Dict[str, Dict[str, Any]] = {}
        #: the bucket plan's identity (``plan_hash``, ``strategy``), kept
        #: for the JAX package's planner; the port's builds record none
        self._plan: Dict[str, Any] = {}

    @classmethod
    def load(cls, output_dir: str) -> "BuildJournal":
        """The journal in ``output_dir``, the overlay read over the base; a
        missing or unreadable one is empty (a resume then builds all)."""
        journal = cls(output_dir)
        try:
            with open(journal.path) as f:
                state = json.load(f)
            machines = state.get("machines", {})
            if isinstance(machines, dict):
                journal._machines = {name: dict(e) for name, e in machines.items() if isinstance(e, dict)}
            if isinstance(state.get("plan"), dict):
                journal._plan = dict(state["plan"])
        except FileNotFoundError:
            pass
        except (OSError, ValueError) as exc:
            logger.warning("Unreadable build journal %s (%r); starting fresh", journal.path, exc)
        try:
            with open(journal.events_path) as f:
                for line in f:
                    try:
                        event = json.loads(line)
                        name = event.pop("name")
                    except (ValueError, KeyError):
                        continue  # a torn line from a kill in mid-append
                    journal._machines.setdefault(name, {}).update(event)
        except FileNotFoundError:
            pass
        except OSError as exc:
            logger.warning("Unreadable journal events %s (%r); ignored", journal.events_path, exc)
        return journal

    def get(self, name: str) -> Optional[Dict[str, Any]]:
        with self._lock:
            entry = self._machines.get(name)
            return dict(entry) if entry else None

    def machines(self) -> Dict[str, Dict[str, Any]]:
        with self._lock:
            return {name: dict(e) for name, e in self._machines.items()}

    def record(
        self,
        name: str,
        status: str,
        config_hash: Optional[str] = None,
        error: Optional[str] = None,
        flush: bool = True,
    ) -> None:
        """Set a machine's status; ``flush`` makes it durable at once (one
        line appended to the overlay), else the next :meth:`flush` does."""
        if status not in STATUSES:
            raise ValueError(f"unknown journal status {status!r}")
        with self._lock:
            entry = self._machines.setdefault(name, {})
            entry["status"] = status
            if config_hash is not None:
                entry["config_hash"] = config_hash
            if error is not None:
                entry["error"] = error
            elif status != "failed":
                entry.pop("error", None)
            if flush:
                os.makedirs(self.output_dir, exist_ok=True)
                with open(self.events_path, "a") as f:
                    f.write(json.dumps({"name": name, **entry}, default=str) + "\n")

    def plan(self) -> Dict[str, Any]:
        with self._lock:
            return dict(self._plan)

    def set_plan(self, plan_hash: str, strategy: str, flush: bool = True) -> None:
        with self._lock:
            self._plan = {"plan_hash": str(plan_hash), "strategy": str(strategy)}
        if flush:
            self.flush()

    def flush(self) -> None:
        """Write the whole state by an atomic replace and fold the overlay
        into it: a crash leaves the previous journal and its overlay."""
        with self._lock:
            state: Dict[str, Any] = {"version": 1, "machines": self._machines}
            if self._plan:
                state["plan"] = self._plan
            payload = json.dumps(state, indent=1, sort_keys=True, default=str)
            os.makedirs(self.output_dir, exist_ok=True)
            # a staging name: a flush cut short leaves what the sweep removes
            tmp = os.path.join(self.output_dir, f".{JOURNAL_FILE}{TMP_DIR_MARKER}{os.getpid()}")
            with open(tmp, "w") as f:
                f.write(payload)
            os.replace(tmp, self.path)
            # after the replace: there is no moment at which neither file holds the events
            with contextlib.suppress(OSError):
                os.remove(self.events_path)

    def resumable(self, name: str, config_hash: str) -> bool:
        """True when a resume may skip ``name``: journaled ``built`` under
        ``config_hash``, its artifact complete on disk."""
        entry = self.get(name)
        return bool(
            entry
            and entry.get("status") == "built"
            and entry.get("config_hash") == config_hash
            and artifact_complete(os.path.join(self.output_dir, name))
        )


def resumable_names(output_dir: str, machines) -> List[str]:
    """The names of ``machines`` that ``build(output_dir, resume=True)``
    skips, read from the output directory alone."""
    from ..builder.build_model import ModelBuilder

    journal = BuildJournal.load(output_dir)
    return [m.name for m in machines if journal.resumable(m.name, ModelBuilder.calculate_cache_key(m))]


def artifact_complete(model_dir: str) -> bool:
    """All three artifact files present, and ``model.pkl``'s checksum the
    one ``info.json`` records."""
    files = (serializer.MODEL_FILE, serializer.METADATA_FILE, serializer.INFO_FILE)
    if not all(os.path.isfile(os.path.join(model_dir, f)) for f in files):
        return False
    try:
        info = serializer.load_info(model_dir)
        return info.get("checksum") == _file_checksum(os.path.join(model_dir, serializer.MODEL_FILE))
    except (OSError, ValueError):
        return False


#: a staging entry younger than this may be another live builder's dump
#: in progress (an output or register directory may be shared); a dump
#: takes seconds, so an hour marks an orphan
STAGING_ORPHAN_AGE_SECONDS = 3600.0


def clean_staging_dirs(output_dir: str, min_age_seconds: float = STAGING_ORPHAN_AGE_SECONDS) -> List[str]:
    """Remove the staging leftovers of killed builds (``.<name>.tmp-*``
    directories, ``.build_state.json.tmp-*`` files) older than
    ``min_age_seconds``; the names removed. Complete artifacts and the
    journal are never touched."""
    removed: List[str] = []
    try:
        entries = os.listdir(output_dir)
    except FileNotFoundError:
        return removed
    now = time.time()
    for entry in entries:
        if not is_staging_dir(entry):
            continue
        full = os.path.join(output_dir, entry)
        try:
            age = now - os.stat(full).st_mtime
        except OSError:
            continue  # its owner just renamed or removed it
        if age < min_age_seconds:
            logger.info("Sparing staging entry %s (%.0f s old: possibly a live builder's dump)", full, age)
            continue
        if os.path.isdir(full):
            shutil.rmtree(full, ignore_errors=True)
        else:
            with contextlib.suppress(OSError):
                os.remove(full)
        removed.append(entry)
    if removed:
        logger.info("Removed %d orphaned staging entries from %s", len(removed), output_dir)
    return removed
