"""
The live progress of a fleet build, ``build_status.json``, a copy of
``gordo_tpu/telemetry/progress.py``.

The builder rewrites the document (an atomic replace) on every phase's
first entry, on machine completions and failures, and when it finishes:
state (``running``, ``complete``, ``failed``), the current phase, the
machine counts and each phase's seconds. ``python -m gordo_tpu_torch
build-status <dir>`` renders it (:func:`render_status`) and the server
answers it at ``/gordo/v0/<project>/build-status``. Writes past the
first of a phase are throttled by ``GORDO_TPU_TELEMETRY_HEARTBEAT``
(seconds, default 0.5; 0 writes every completion, so the document is
never behind the journal).
"""

import contextlib
import json
import logging
import os
import threading
import time
from typing import Any, Dict, List, Optional

from ..utils.env import env_float
from .recorder import _iso

logger = logging.getLogger(__name__)

HEARTBEAT_ENV = "GORDO_TPU_TELEMETRY_HEARTBEAT"
DEFAULT_HEARTBEAT_SECONDS = 0.5

#: the telemetry files a build writes beside its machines
BUILD_STATUS_FILE = "build_status.json"
BUILD_TRACE_FILE = "build_trace.jsonl"


class BuildProgress:
    """Phase and machine counters that heartbeat
    ``<output_dir>/build_status.json``; thread-safe (the dump threads
    report completions). Without an ``output_dir`` nothing is written."""

    #: floor, in seconds, on the writes of a phase entered again
    PHASE_REENTRY_INTERVAL = 0.2

    def __init__(
        self,
        output_dir: Optional[str],
        project: str = "",
        total: int = 0,
        phase_seconds: Optional[Dict[str, float]] = None,
        heartbeat_seconds: Optional[float] = None,
    ):
        self.path = os.path.join(output_dir, BUILD_STATUS_FILE) if output_dir is not None else None
        if output_dir is not None:
            try:
                os.makedirs(output_dir, exist_ok=True)
            except OSError:
                self.path = None
        self.project = project
        self.total = total
        self.completed = 0
        self.failed = 0
        self.resumed = 0
        self.cached = 0
        self.degraded = 0
        self.state = "running"
        self.started_at = time.time()
        #: the builder's live phase seconds, read at every write
        self.phase_seconds = phase_seconds if phase_seconds is not None else {}
        if heartbeat_seconds is None:
            heartbeat_seconds = env_float(HEARTBEAT_ENV, DEFAULT_HEARTBEAT_SECONDS)
        self.heartbeat_seconds = max(0.0, heartbeat_seconds)
        self._phase: Optional[str] = None
        self._phase_order: List[str] = []
        self._lock = threading.Lock()
        self._write_lock = threading.Lock()  # one write and rename at a time
        self._last_write = 0.0
        #: documents written (a reading of the heartbeat's cost)
        self.writes = 0

    def phase(self, name: str) -> None:
        """Enter a phase; its first entry forces a write, a re-entry (the
        CV loop cycles train, predict, score) rides the throttle."""
        with self._lock:
            changed = self._phase != name
            self._phase = name
            first_entry = name not in self._phase_order
            if first_entry:
                self._phase_order.append(name)
        if first_entry:
            self.write(force=True)
        elif changed:
            self.write(min_interval=self.PHASE_REENTRY_INTERVAL)

    def machine_completed(self, name: str = "") -> None:
        with self._lock:
            self.completed += 1
        self.write()

    def machine_failed(self, name: str = "") -> None:
        with self._lock:
            self.failed += 1
        self.write()

    def finish(self, state: str = "complete") -> None:
        with self._lock:
            self.state = state
            self._phase = None
        self.write(force=True)

    def document(self) -> Dict[str, Any]:
        with self._lock:
            now = time.time()
            return {
                "version": 1,
                "project": self.project,
                "state": self.state,
                "phase": self._phase,
                "started_at": _iso(self.started_at),
                "updated_at": _iso(now),
                "elapsed_sec": round(now - self.started_at, 3),
                "machines": {
                    "total": self.total,
                    "completed": self.completed,
                    "failed": self.failed,
                    "resumed": self.resumed,
                    "cached": self.cached,
                    "degraded": self.degraded,
                },
                "phases": {
                    name: {
                        "seconds": round(float(self.phase_seconds.get(name, 0.0)), 6),
                        "status": "running" if name == self._phase else "done",
                    }
                    for name in self._phase_order
                },
            }

    def write(self, force: bool = False, min_interval: Optional[float] = None) -> None:
        """Replace the status file atomically, unless the last write was
        under the heartbeat (or ``min_interval``) ago; a failed write is
        logged and the build goes on."""
        if self.path is None:
            return
        interval = self.heartbeat_seconds if min_interval is None else max(self.heartbeat_seconds, min_interval)
        now = time.time()
        with self._write_lock:
            with self._lock:
                if not force and now - self._last_write < interval:
                    return
                self._last_write = now
            doc = self.document()
            # a dotted staging name: an interrupted write leaves a file
            # every artifact listing skips
            tmp = os.path.join(os.path.dirname(self.path), f".{BUILD_STATUS_FILE}.tmp-{os.getpid()}")
            try:
                with open(tmp, "w") as f:
                    json.dump(doc, f, default=str)
                os.replace(tmp, self.path)
                self.writes += 1
            except OSError as exc:
                logger.debug("build_status heartbeat not written: %r", exc)
                with contextlib.suppress(OSError):
                    os.remove(tmp)


def load_status(output_dir: str) -> Optional[Dict[str, Any]]:
    """The build-status document of ``output_dir``, or None when there is
    none or it does not parse."""
    try:
        with open(os.path.join(output_dir, BUILD_STATUS_FILE)) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return None
    return doc if isinstance(doc, dict) else None


def eta_seconds(doc: Dict[str, Any]) -> Optional[float]:
    """Seconds left at the completed machines' rate; None until one has
    completed or once the build is not running.

    >>> eta_seconds({"state": "running", "elapsed_sec": 10.0, "machines": {"total": 4, "completed": 1}})
    30.0
    """
    machines = doc.get("machines") or {}
    completed = int(machines.get("completed") or 0)
    elapsed = float(doc.get("elapsed_sec") or 0.0)
    if doc.get("state") != "running" or completed <= 0 or elapsed <= 0:
        return None
    remaining = (int(machines.get("total") or 0) - completed - int(machines.get("resumed") or 0)
                 - int(machines.get("failed") or 0))
    if remaining <= 0:
        return 0.0
    return remaining * elapsed / completed


def render_status(doc: Dict[str, Any]) -> str:
    """The ``build-status`` command's text: header, progress bar and ETA,
    the phase table."""
    machines = doc.get("machines") or {}
    total = int(machines.get("total") or 0)
    completed = int(machines.get("completed") or 0)
    resumed = int(machines.get("resumed") or 0)
    failed = int(machines.get("failed") or 0)
    done = completed + resumed
    state = doc.get("state", "unknown")
    phase = doc.get("phase")
    lines = [
        f"Project:  {doc.get('project') or '-'}",
        f"State:    {state}" + (f" (phase: {phase})" if phase else ""),
        f"Started:  {doc.get('started_at', '-')}  (elapsed {doc.get('elapsed_sec', 0):.0f}s)",
        f"Machines: {done}/{total} done"
        + (f" ({resumed} resumed)" if resumed else "")
        + (f", {failed} failed" if failed else "")
        + (f", {machines.get('degraded')} degraded" if machines.get("degraded") else ""),
    ]
    if total:
        frac = min(1.0, (done + failed) / total)
        width = 30
        fill = int(round(frac * width))
        eta = eta_seconds(doc)
        eta_text = f"   ETA ~{eta:.0f}s" if eta is not None else ""
        lines.append(f"Progress: [{'#' * fill + '.' * (width - fill)}] {frac * 100:3.0f}%{eta_text}")
    phases = doc.get("phases") or {}
    if phases:
        lines.append("Phases:")
        name_width = max(len(name) for name in phases)
        lines.append(f"  {'phase'.ljust(name_width)}  {'seconds':>9}  status")
        for name, entry in phases.items():
            lines.append(f"  {name.ljust(name_width)}  {float(entry.get('seconds', 0.0)):9.2f}  "
                         f"{entry.get('status', '')}")
    return "\n".join(lines)
