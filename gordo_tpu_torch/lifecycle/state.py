"""
The lifecycle's crash-safe state, ``<models_root>/.lifecycle/state.json``,
a copy of ``gordo_tpu/lifecycle/state.py``.

The document records the phase machine (``idle``, ``canary_building``,
``canary_serving``, ``rolling_back``; ``promoted`` and ``rolled_back`` are
history events, and the machine rests in ``idle``), the revisions the
phases need (anchor, serving, canary), the stale set, the drift monitor's
snapshot and a bounded history. ``quarantine.json`` beside it is the
append-only record of every rolled-back canary: its revision, machines
and reasons. Both are written whole to a temporary file and renamed, so a
kill mid-write leaves the last complete document. The documents are the
JAX package's, key for key: either package reads the other's.
"""

import json
import logging
import os
import time
from typing import Any, Dict, List, Optional

logger = logging.getLogger(__name__)

#: the supervisor's directory under the models root (dotted: never a revision)
LIFECYCLE_DIR = ".lifecycle"
STATE_FILE = "state.json"
QUARANTINE_FILE = "quarantine.json"

PHASES = ("idle", "canary_building", "canary_serving", "rolling_back")

#: history entries kept
MAX_HISTORY = 50


class LifecycleState:
    """The persisted document and its accessors; one a models root."""

    def __init__(self, models_root: str):
        self.models_root = models_root
        self.directory = os.path.join(models_root, LIFECYCLE_DIR)
        self.path = os.path.join(self.directory, STATE_FILE)
        self.quarantine_path = os.path.join(self.directory, QUARANTINE_FILE)
        self.doc: Dict[str, Any] = {
            "version": 1,
            "phase": "idle",
            "anchor_revision": None,
            "serving_revision": None,
            "canary_revision": None,
            "stale": [],
            "drift": {},
            "history": [],
        }

    @classmethod
    def load(cls, models_root: str) -> "LifecycleState":
        """The persisted state; a missing or torn file gives a fresh idle one."""
        state = cls(models_root)
        try:
            with open(state.path) as f:
                doc = json.load(f)
            if isinstance(doc, dict) and doc.get("version") == 1:
                state.doc.update(doc)
                if state.doc.get("phase") not in PHASES:
                    logger.warning("unknown lifecycle phase %r; resetting to idle", state.doc.get("phase"))
                    state.doc["phase"] = "idle"
        except FileNotFoundError:
            pass
        except (OSError, ValueError) as exc:
            logger.warning("unreadable lifecycle state %s (%r); starting idle", state.path, exc)
        return state

    @property
    def phase(self) -> str:
        return str(self.doc.get("phase") or "idle")

    @property
    def anchor_revision(self) -> Optional[str]:
        return self.doc.get("anchor_revision")

    @property
    def serving_revision(self) -> Optional[str]:
        return self.doc.get("serving_revision")

    @property
    def canary_revision(self) -> Optional[str]:
        return self.doc.get("canary_revision")

    @property
    def stale(self) -> List[str]:
        return list(self.doc.get("stale") or [])

    def update(self, **fields: Any) -> None:
        """Merge ``fields`` and persist, with no history entry."""
        self.doc.update(fields)
        self.save()

    def transition(self, phase: str, event: Optional[str] = None, **fields: Any) -> None:
        """Move to ``phase`` and persist; ``event`` (default the phase)
        joins the history with the time and the two revisions."""
        if phase not in PHASES:
            raise ValueError(f"unknown lifecycle phase {phase!r}")
        self.doc.update(fields)
        self.doc["phase"] = phase
        history = list(self.doc.get("history") or [])
        history.append({
            "time": time.time(),
            "event": event or phase,
            "serving_revision": self.doc.get("serving_revision"),
            "canary_revision": self.doc.get("canary_revision"),
        })
        self.doc["history"] = history[-MAX_HISTORY:]
        self.save()

    def _write(self, name: str, payload: str) -> None:
        os.makedirs(self.directory, exist_ok=True)
        tmp = os.path.join(self.directory, f".{name}.tmp-{os.getpid()}")
        with open(tmp, "w") as f:
            f.write(payload)
        os.replace(tmp, os.path.join(self.directory, name))

    def save(self) -> None:
        self._write(STATE_FILE, json.dumps(self.doc, indent=1, sort_keys=True, default=str))

    def quarantine(self, record: Dict[str, Any]) -> None:
        """Append one rolled-back canary's record."""
        records = self.quarantined()
        records.append({"time": time.time(), **record})
        self._write(QUARANTINE_FILE, json.dumps(records, indent=1, sort_keys=True, default=str))

    def quarantined(self) -> List[Dict[str, Any]]:
        try:
            with open(self.quarantine_path) as f:
                records = json.load(f)
            return records if isinstance(records, list) else []
        except (OSError, ValueError):
            return []
