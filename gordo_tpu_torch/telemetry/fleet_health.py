"""
The fleet health ledger and the joined fleet-status document, a copy of
``gordo_tpu/telemetry/fleet_health.py``.

One record a machine (``serving``, ``drift``, ``build``, ``quarantine``
and ``breaker`` sections, the JAX package's keys), each with its derived
health score and state, and a bounded summary of the fleet, persisted
beside the artifacts as ``fleet_health.json``, or, under worker sinks
(``telemetry.recorder.worker_sink_path``: the workers of ``run-server``'s
pre-fork master), as each worker's ``fleet_health-<pid>.json``, which the
readers merge. Its feeds:

- a fleet build: the ``build`` section (the final loss of each trained
  member, a landed artifact, a failure or a degradation with its error)
  and the plan's predicted-against-measured numbers (``plan_accuracy``);
- the server: :meth:`FleetHealthLedger.record_request` for each scoring
  request, :meth:`~FleetHealthLedger.record_scored` (each machine's rows,
  its rolling residual mean, halved past :data:`HEALTH_WINDOW_ROWS` rows,
  and its request) for each fleet request and stream flush, and
  :meth:`~FleetHealthLedger.record_breaker_transition` on each breaker
  transition;
- the lifecycle supervisor (``lifecycle/loop.py``, on the anchor
  directory's serving ledger): :meth:`~FleetHealthLedger.record_drift`
  for each drift verdict, :meth:`~FleetHealthLedger.record_quarantine`
  for a rolled-back canary's machines and
  :meth:`~FleetHealthLedger.record_promotion` for a promoted one's, and
  the rebuild's build records.

Past 512 machines (or with ``GORDO_TPU_HEALTH_SHARDS`` set) the snapshot
splits into ``fleet_health.d/shard-XXXofYYY.json`` plus a bounded
``summary.json``; a flush rewrites only the shards whose machines
changed. Writes that change no state ride the
``GORDO_TPU_HEALTH_HEARTBEAT`` throttle (2 s).

A builder owns its ledger (:func:`ledger_for` makes a new one and adopts
the directory's last snapshot). The server keeps one serving ledger a
directory for the whole process, as the JAX package does
(:func:`serving_ledger`): every app on the directory, its engine and its
stream plane feed that one, so no app overwrites another's snapshot or
adopts its counts. :func:`ledger_summaries` reads both kinds for the
Prometheus exposition: each directory's serving ledger, else its newest
build ledger, for the life of the process.

:func:`fleet_status_document` joins ``build_status.json``,
``fleet_plan.json``, the lifecycle's state files, the health view (the
live ledger merged with every other worker's snapshot, never with its
own), the SLO section (``telemetry/slo.py``: the budgets and alerts of
this process's last evaluation, else the persisted alerts) and the sections its caller
injects (``device``, ``programs``, ``serving``, ``stream``);
:func:`render_fleet_status` renders it for ``fleet-status``.
"""


import contextlib
import datetime
import heapq
import json
import logging
import os
import threading
import time
import zlib
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple, Union

import numpy as np

from ..utils.env import env_bool, env_float, env_int
from ..utils.postfork import register_postfork_reset
from .recorder import _iso, enabled, is_worker_variant, worker_sink_path

logger = logging.getLogger(__name__)

FLEET_HEALTH_FILE = "fleet_health.json"
FLEET_HEALTH_SHARD_DIR = "fleet_health.d"
FLEET_HEALTH_SUMMARY_FILE = "summary.json"
#: shard count: 0 (default) sizes it from the fleet, a positive value pins it
HEALTH_SHARDS_ENV = "GORDO_TPU_HEALTH_SHARDS"
_SHARD_TARGET_MACHINES = 512
_MAX_SHARDS = 64
#: a shard's cached summary is refreshed after this many seconds
_SUMMARY_MAX_AGE_S = 60.0
#: offenders kept in a shard's summary
_OFFENDER_CAP = 32
FLEET_HEALTH_ENV = "GORDO_TPU_FLEET_HEALTH"
HEALTH_HEARTBEAT_ENV = "GORDO_TPU_HEALTH_HEARTBEAT"
DEFAULT_HEALTH_HEARTBEAT = 2.0
#: rows after which a machine's rolling residual window halves (the JAX
#: default of ``GORDO_TPU_HEALTH_WINDOW``)
HEALTH_WINDOW_ROWS = 100_000
#: machines past which the fleet-status document stops inlining records,
#: also the largest ``?machines=`` page (the JAX default of
#: ``GORDO_TPU_FLEET_STATUS_MAX_MACHINES``)
FLEET_STATUS_MAX_MACHINES = 500
#: offender rows of the fleet-status document's health section (the JAX
#: default of ``GORDO_TPU_FLEET_STATUS_TOP_K``)
FLEET_STATUS_TOP_K = 10
#: the lifecycle's state files (``gordo_tpu/lifecycle/state.py``'s names)
_LIFECYCLE_DIR = ".lifecycle"
_LIFECYCLE_STATE_FILE = "state.json"
_LIFECYCLE_QUARANTINE_FILE = "quarantine.json"
#: upper edges of the health-score histogram
SCORE_BUCKETS = (0.25, 0.5, 0.75, 0.9, 1.0)
#: seconds after which a persisted breaker record no longer counts
BREAKER_STATE_MAX_AGE_S = 3600.0


def health_enabled() -> bool:
    """The ledger's switch: the telemetry switch and ``GORDO_TPU_FLEET_HEALTH``."""
    return enabled() and env_bool(FLEET_HEALTH_ENV, True)


def _new_machine() -> Dict[str, Any]:
    return {
        "serving": {"requests": 0, "errors": 0, "rows": 0, "residual_mean": None, "last_request_at": None},
        "drift": {"drifted": False, "reasons": [], "feature_shift_max": None, "residual_ratio": None,
                  "window_rows": 0, "evaluated_at": None},
        "build": {"revision": None, "final_loss": None, "degraded": False, "failed": False, "error": None,
                  "bisects": 0, "retries": 0, "built_at": None},
        "quarantine": {"active": False, "revision": None, "reasons": [], "since": None},
        "breaker": {"state": "closed", "trips": 0, "cooldown_s": None, "reason": None, "updated_at": None},
    }


def _live_breaker_state(machine: Dict[str, Any], max_age_s: float = BREAKER_STATE_MAX_AGE_S) -> Optional[str]:
    """The machine's breaker state when it is tripped and recent enough
    to trust, else None."""
    breaker = machine.get("breaker") or {}
    state = breaker.get("state")
    if state not in ("open", "half_open"):
        return None
    stamp = breaker.get("updated_at")
    if max_age_s and stamp:
        try:
            age = (datetime.datetime.now(datetime.timezone.utc)
                   - datetime.datetime.fromisoformat(str(stamp))).total_seconds()
        except ValueError:
            return state
        if age > max_age_s:
            return None
    return state


def health_score(machine: Dict[str, Any]) -> float:
    """A machine's health in [0, 1]: 1 less 0.5 in quarantine, 0.4 (0.2)
    with an open (half-open) breaker, 0.3 for a degraded or failed build,
    0.2 drifting, up to 0.3 for serving errors.

    >>> health_score(_new_machine()), health_score(dict(_new_machine(), build={"degraded": True}))
    (1.0, 0.7)
    """
    score = 1.0
    if machine["quarantine"]["active"]:
        score -= 0.5
    breaker_state = _live_breaker_state(machine)
    if breaker_state == "open":
        score -= 0.4
    elif breaker_state == "half_open":
        score -= 0.2
    if machine["build"].get("degraded") or machine["build"].get("failed"):
        score -= 0.3
    if machine["drift"]["drifted"]:
        score -= 0.2
    serving = machine["serving"]
    if serving["requests"]:
        score -= min(0.3, 3.0 * serving["errors"] / serving["requests"])
    return round(max(0.0, min(1.0, score)), 4)


def machine_state(machine: Dict[str, Any]) -> str:
    """``quarantined`` > ``degraded`` > ``drifting`` > ``healthy``."""
    if machine["quarantine"]["active"] or _live_breaker_state(machine) is not None:
        return "quarantined"
    if machine["build"].get("degraded") or machine["build"].get("failed"):
        return "degraded"
    if machine["drift"]["drifted"]:
        return "drifting"
    return "healthy"


def summarize(machines: Dict[str, Dict[str, Any]]) -> Dict[str, Any]:
    """State counts, request and error totals, and the score histogram."""
    counts = {"healthy": 0, "degraded": 0, "drifting": 0, "quarantined": 0}
    requests = errors = breaker_tripped = 0
    score_sum = 0.0
    bins = [0] * len(SCORE_BUCKETS)
    for machine in machines.values():
        counts[machine_state(machine)] += 1
        requests += machine["serving"]["requests"]
        errors += machine["serving"]["errors"]
        if _live_breaker_state(machine) is not None:
            breaker_tripped += 1
        score = health_score(machine)
        score_sum += score
        for i, edge in enumerate(SCORE_BUCKETS):
            if score <= edge:
                bins[i] += 1
                break
    return {
        "machines": len(machines),
        **counts,
        "requests": requests,
        "errors": errors,
        "error_rate": round(errors / requests, 6) if requests else 0.0,
        "breaker_tripped": breaker_tripped,
        "score_histogram": {"buckets": list(SCORE_BUCKETS), "counts": bins, "score_sum": round(score_sum, 4)},
    }


def _fold_summaries(summaries: Iterable[Dict[str, Any]]) -> Dict[str, Any]:
    """Shard summaries folded into the fleet's (every field a sum)."""
    folded = summarize({})
    bins = folded["score_histogram"]["counts"]
    score_sum = 0.0
    for summary in summaries:
        if not isinstance(summary, dict):
            continue
        for key in ("machines", "healthy", "degraded", "drifting", "quarantined", "requests", "errors",
                    "breaker_tripped"):
            folded[key] += int(summary.get(key) or 0)
        histogram = summary.get("score_histogram") or {}
        score_sum += float(histogram.get("score_sum") or 0.0)
        for i, count in enumerate(histogram.get("counts") or ()):
            if i < len(bins):
                bins[i] += int(count)
    folded["error_rate"] = round(folded["errors"] / folded["requests"], 6) if folded["requests"] else 0.0
    folded["score_histogram"]["score_sum"] = round(score_sum, 4)
    return folded


def _offender_reason(machine: Dict[str, Any], state: str) -> Optional[str]:
    if state == "quarantined":
        reasons = machine.get("quarantine", {}).get("reasons") or []
        if reasons:
            return str(reasons[0])
        breaker = machine.get("breaker") or {}
        return str(breaker["reason"]) if breaker.get("reason") else None
    if state == "degraded":
        error = machine.get("build", {}).get("error")
        return str(error) if error else None
    reasons = machine.get("drift", {}).get("reasons") or []
    return str(reasons[0]) if reasons else None


def _offenders(machines: Dict[str, Dict[str, Any]], cap: int) -> List[Dict[str, Any]]:
    """The ``cap`` unhealthiest machines: name, score, state, first reason."""
    entries = []
    for name, machine in machines.items():
        state = machine_state(machine)
        if state != "healthy":
            entries.append({"machine": name, "score": health_score(machine), "state": state,
                            "reason": _offender_reason(machine, state)})
    return heapq.nsmallest(cap, entries, key=lambda e: (e["score"], e["machine"]))


def _merge_offenders(pools: Iterable[List[Dict[str, Any]]], top_k: int) -> List[Dict[str, Any]]:
    merged = [e for pool in pools for e in pool if isinstance(e, dict)]
    return heapq.nsmallest(top_k, merged, key=lambda e: (e.get("score", 0.0), str(e.get("machine"))))


class NullLedger:
    """The ledger when health telemetry is off: records nothing."""

    enabled = False
    path = None

    def record_request(self, *args, **kwargs):
        pass

    def record_scores(self, *args, **kwargs):
        pass

    def record_scored(self, *args, **kwargs):
        pass

    def record_build(self, *args, **kwargs):
        pass

    def record_drift(self, *args, **kwargs):
        pass

    def record_quarantine(self, *args, **kwargs):
        pass

    def record_breaker(self, *args, **kwargs):
        pass

    def record_breaker_transition(self, *args, **kwargs):
        pass

    def record_promotion(self, *args, **kwargs):
        pass

    def add_listener(self, listener):
        pass

    def machine(self, name):
        return None

    def record_plan_accuracy(self, accuracy):
        pass

    def document(self):
        return None

    def bounded_document(self, top_k=10):
        return None

    def summary(self):
        return None

    def offenders(self, top_k=10):
        return []

    def machine_count(self):
        return 0

    def write(self, force=False):
        pass

    def flush(self):
        pass


NULL_LEDGER = NullLedger()


def _shard_dir_for(path: str) -> str:
    """``fleet_health.json`` -> ``fleet_health.d`` (``fleet_health-12.json``
    -> ``fleet_health-12.d``)."""
    return os.path.splitext(path)[0] + ".d"


def _shard_file_name(shard: int, count: int) -> str:
    # the layout's shard count is in the name: files of an older layout
    # are recognisable
    return f"shard-{shard:03d}of{count:03d}.json"


def _shard_files(shard_dir: str) -> List[str]:
    try:
        entries = sorted(os.listdir(shard_dir))
    except OSError:
        return []
    return [os.path.join(shard_dir, e) for e in entries if e.startswith("shard-") and e.endswith(".json")]


def _load_json(path: str) -> Optional[Any]:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def _with_health(machines: Dict[str, Dict[str, Any]]) -> Dict[str, Dict[str, Any]]:
    for machine in machines.values():
        machine["health"] = {"score": health_score(machine), "state": machine_state(machine)}
    return machines


class FleetHealthLedger:
    """The health records of one artifact directory. Thread-safe (the
    dump threads record concurrently); every snapshot is an atomic
    replace."""

    enabled = True

    def __init__(self, directory: Optional[str] = None, project: str = "", heartbeat_seconds: Optional[float] = None):
        self.directory = os.path.normpath(directory) if directory is not None else None
        # under worker sinks each process snapshots to its own fleet_health-<pid>.json
        self.path = worker_sink_path(os.path.join(self.directory, FLEET_HEALTH_FILE)) \
            if self.directory is not None else None
        #: the process that made the ledger: a forked worker makes its own (:func:`serving_ledger`)
        self._pid = os.getpid()
        self.shard_dir = _shard_dir_for(self.path) if self.path is not None else None
        self.project = project
        if heartbeat_seconds is None:
            heartbeat_seconds = env_float(HEALTH_HEARTBEAT_ENV, DEFAULT_HEALTH_HEARTBEAT) or DEFAULT_HEALTH_HEARTBEAT
        self.heartbeat_seconds = max(0.0, heartbeat_seconds)
        #: the running (sum, rows) behind each residual mean (not in the document)
        self._residuals: Dict[str, List[float]] = {}
        self._listeners: List[Callable[[dict], None]] = []
        self._machines: Dict[str, Dict[str, Any]] = {}
        self._plan_accuracy: Optional[Dict[str, Any]] = None
        self._lock = threading.Lock()
        self._write_lock = threading.Lock()
        self._last_write = 0.0
        # the shards: all under self._lock
        self._forced_shards = max(0, env_int(HEALTH_SHARDS_ENV, 0))
        self._shard_count = self._forced_shards or 1
        self._shard_members: Dict[int, set] = {}
        self._dirty: set = set()
        self._layout_changed = False
        self._summary_cache: Dict[int, Dict[str, Any]] = {}
        self._summary_stamp: Dict[int, float] = {}
        self._summary_dirty: set = set()

    # -- recording ----------------------------------------------------------

    def _shard_of(self, name: str) -> int:
        # crc32: the same shard in every process (str hashes are salted)
        return zlib.crc32(name.encode("utf-8")) % self._shard_count

    def _reshard_locked(self) -> None:
        """Grow the shard count to the next power of two of machines / 512."""
        needed = (len(self._machines) + _SHARD_TARGET_MACHINES - 1) // _SHARD_TARGET_MACHINES
        count = min(_MAX_SHARDS, max(1, 1 << max(0, needed - 1).bit_length()))
        if count <= self._shard_count:
            return
        self._shard_count = count
        self._shard_members = {}
        for name in self._machines:
            self._shard_members.setdefault(self._shard_of(name), set()).add(name)
        self._dirty.update(range(count))
        self._summary_cache.clear()
        self._summary_stamp.clear()
        self._summary_dirty.update(range(count))
        self._layout_changed = True

    def _machine(self, name: str) -> Dict[str, Any]:
        """The record of ``name``, made on first use; marks its shard dirty."""
        machine = self._machines.get(name)
        if machine is None:
            machine = self._machines[name] = _new_machine()
            if (not self._forced_shards and self._shard_count < _MAX_SHARDS
                    and len(self._machines) > self._shard_count * _SHARD_TARGET_MACHINES):
                self._reshard_locked()
            self._shard_members.setdefault(self._shard_of(name), set()).add(name)
        shard = self._shard_of(name)
        self._dirty.add(shard)
        self._summary_dirty.add(shard)
        return machine

    def machine_count(self) -> int:
        with self._lock:
            return len(self._machines)

    def record_request(self, machine: str, error: bool = False, count: int = 1) -> None:
        """``count`` served requests of ``machine``; ``error`` marks a
        server-side failure (a client's error is not the machine's)."""
        with self._lock:
            serving = self._machine(machine)["serving"]
            serving["requests"] += count
            if error:
                serving["errors"] += count
            serving["last_request_at"] = _iso(time.time())
        self.write()

    def record_scores(self, machine: str, rows: int, residual_mean: Optional[float] = None,
                      write: bool = True) -> None:
        """One scored window of ``rows`` rows at mean reconstruction error
        ``residual_mean``, folded into the rolling mean, which halves its
        weight past :data:`HEALTH_WINDOW_ROWS`. ``write=False``: the caller snapshots
        once for many machines."""
        if rows <= 0:
            return
        with self._lock:
            serving = self._machine(machine)["serving"]
            serving["rows"] += int(rows)
            if residual_mean is not None and residual_mean == residual_mean:
                total, seen = self._residuals.get(machine, (0.0, 0))
                if seen >= HEALTH_WINDOW_ROWS:
                    # halved before the new window folds in: recent rows outweigh history
                    total *= 0.5
                    seen = int(seen * 0.5)
                total += float(residual_mean) * rows
                seen += rows
                self._residuals[machine] = [total, seen]
                serving["residual_mean"] = round(total / seen, 8)
        if write:
            self.write()

    def record_scored(self, rows: Dict[str, int], scores: Dict[str, Tuple[Any, Any]],
                      errors: Dict[str, BaseException], client_errors: Tuple[type, ...]) -> None:
        """One scored batch (a fleet request, a stream flush): each scored
        machine's ``rows`` and the mean of its finite residuals (the second
        of its ``scores`` pair) and a request; each failed one's request,
        an error unless its cause is one of ``client_errors``; then one
        throttled snapshot."""
        for name, (_reconstruction, mse) in scores.items():
            residuals = np.asarray(mse, dtype=float).ravel()
            residuals = residuals[np.isfinite(residuals)]
            self.record_scores(name, rows.get(name, len(residuals)),
                               float(residuals.mean()) if len(residuals) else None, write=False)
            self.record_request(name)
        for name, exc in errors.items():
            self.record_request(name, error=not isinstance(exc, client_errors))
        self.write()

    def record_build(self, machine: str, **fields: Any) -> None:
        """Build provenance: any of ``revision``, ``final_loss``,
        ``degraded``, ``failed``, ``error``, ``bisects``, ``retries`` (None
        leaves a field). A clean build clears the last failure's error. A
        failure, degradation or error forces a snapshot."""
        with self._lock:
            build = self._machine(machine)["build"]
            for key, value in fields.items():
                if key in build and value is not None:
                    build[key] = value
            if not build["failed"] and not build["degraded"] and not fields.get("error"):
                build["error"] = None
            build["built_at"] = _iso(time.time())
        self.write(force=bool(fields.get("failed") or fields.get("degraded") or fields.get("error")))

    def record_drift(self, machine: str, drifted: bool, reasons: Any = (), stats: Optional[Dict[str, Any]] = None,
                     write: bool = True) -> None:
        """The machine's latest drift verdict (``feature_shift_max``,
        ``residual_ratio``, ``window_rows`` from ``stats``)."""
        stats = stats or {}
        with self._lock:
            drift = self._machine(machine)["drift"]
            drift["drifted"] = bool(drifted)
            drift["reasons"] = [str(r) for r in (reasons or [])]
            for key in ("feature_shift_max", "residual_ratio", "window_rows"):
                if key in stats:
                    drift[key] = stats[key]
            drift["evaluated_at"] = _iso(time.time())
        if write:
            self.write(force=True)

    def record_quarantine(self, machines: Any, revision: Optional[str] = None, reasons: Any = ()) -> None:
        """``machines`` quarantined (their canary was rolled back)."""
        now = _iso(time.time())
        with self._lock:
            for name in machines:
                quarantine = self._machine(str(name))["quarantine"]
                quarantine["active"] = True
                quarantine["revision"] = revision
                quarantine["reasons"] = [str(r) for r in (reasons or [])][:5]
                quarantine["since"] = now
        self.write(force=True)

    def record_breaker(self, machine: str, state: str, trips: Optional[int] = None,
                       cooldown_s: Optional[float] = None, reason: Optional[str] = None) -> None:
        """The member's serving breaker state, on each transition: ``open``
        nominates it for a rebuild (:func:`breaker_tripped_machines`),
        ``closed`` retires that."""
        now = _iso(time.time())
        with self._lock:
            record = self._machine(machine).setdefault("breaker", _new_machine()["breaker"])
            record["state"] = str(state)
            if trips is not None:
                record["trips"] = int(trips)
            record["cooldown_s"] = cooldown_s
            record["reason"] = str(reason)[:200] if reason else None
            record["updated_at"] = now
        self.write(force=True)

    def record_breaker_transition(self, machine: str, state: str, info: Dict[str, Any]) -> None:
        """:meth:`record_breaker` from a ``BreakerBoard`` transition's
        ``info`` (``trips``, ``cooldown_s``, ``last_error``)."""
        self.record_breaker(machine, state, trips=info.get("trips"), cooldown_s=info.get("cooldown_s"),
                            reason=info.get("last_error") or None)

    def record_promotion(self, revision: Optional[str], machines: Any = ()) -> None:
        """A promoted revision: ``machines`` leave quarantine, drift and
        breaker state, their build flags clear and their revision advances."""
        with self._lock:
            for name in machines:
                machine = self._machine(str(name))
                fresh = _new_machine()
                for section in ("quarantine", "drift", "breaker"):
                    machine[section] = fresh[section]
                build = machine["build"]
                build["degraded"] = build["failed"] = False
                build["error"] = None
                if revision is not None:
                    build["revision"] = revision
        self.write(force=True)

    def record_plan_accuracy(self, accuracy: Dict[str, Any]) -> None:
        """The build's plan, predicted against measured."""
        with self._lock:
            self._plan_accuracy = dict(accuracy)
        self.write(force=True)

    def add_listener(self, listener: Callable[[dict], None]) -> None:
        """``listener(summary)`` after every forced snapshot (advisory)."""
        with self._lock:
            self._listeners.append(listener)

    # -- the documents ----------------------------------------------------------

    def machine(self, name: str) -> Optional[Dict[str, Any]]:
        """A copy of one machine's record, with its derived health."""
        with self._lock:
            machine = self._machines.get(name)
            if machine is None:
                return None
            machine = json.loads(json.dumps(machine, default=str))
        machine["health"] = {"score": health_score(machine), "state": machine_state(machine)}
        return machine

    def document(self) -> Dict[str, Any]:
        with self._lock:
            payload = json.dumps(self._machines, default=str)
            plan_accuracy = dict(self._plan_accuracy) if self._plan_accuracy else None
        machines = _with_health(json.loads(payload))
        doc: Dict[str, Any] = {
            "version": 1,
            "project": self.project,
            "updated_at": _iso(time.time()),
            "machines": machines,
            "summary": summarize(machines),
        }
        if plan_accuracy is not None:
            doc["plan_accuracy"] = plan_accuracy
        return doc

    def _refresh_summaries_locked(self) -> None:
        now = time.time()
        for shard in range(self._shard_count):
            if (shard not in self._summary_dirty and shard in self._summary_cache
                    and now - self._summary_stamp.get(shard, 0.0) <= _SUMMARY_MAX_AGE_S):
                continue
            names = self._shard_members.get(shard) or ()
            machines = {name: self._machines[name] for name in names if name in self._machines}
            self._summary_cache[shard] = {"summary": summarize(machines),
                                          "offenders": _offenders(machines, _OFFENDER_CAP)}
            self._summary_stamp[shard] = now
        self._summary_dirty.clear()

    def summary(self) -> Dict[str, Any]:
        with self._lock:
            if self._shard_count > 1:
                self._refresh_summaries_locked()
                return _fold_summaries(e["summary"] for e in self._summary_cache.values())
            machines = dict(self._machines)
        return summarize(machines)

    def offenders(self, top_k: int = 10) -> List[Dict[str, Any]]:
        """The ``top_k`` unhealthiest machines."""
        with self._lock:
            if self._shard_count > 1:
                self._refresh_summaries_locked()
                return _merge_offenders([e["offenders"] for e in self._summary_cache.values()], top_k)
            machines = dict(self._machines)
        return _offenders(machines, top_k)

    def bounded_document(self, top_k: int = 10) -> Dict[str, Any]:
        """Summary, top-K offenders and the machine count, never the
        records themselves."""
        with self._lock:
            total = len(self._machines)
            plan_accuracy = dict(self._plan_accuracy) if self._plan_accuracy else None
            machines = None
            if self._shard_count > 1:
                self._refresh_summaries_locked()
                summary = _fold_summaries(e["summary"] for e in self._summary_cache.values())
                offenders = _merge_offenders([e["offenders"] for e in self._summary_cache.values()], top_k)
            else:
                machines = dict(self._machines)
        if machines is not None:
            summary, offenders = summarize(machines), _offenders(machines, top_k)
        doc: Dict[str, Any] = {"version": 1, "project": self.project, "updated_at": _iso(time.time()),
                               "machines_total": total, "summary": summary, "offenders": offenders}
        if plan_accuracy is not None:
            doc["plan_accuracy"] = plan_accuracy
        return doc

    # -- persistence --------------------------------------------------------------

    def write(self, force: bool = False) -> None:
        """Replace the snapshot (throttled unless ``force``): the whole
        ``fleet_health.json`` with one shard, else the dirty shards and
        ``summary.json``. A forced write hands the fleet summary to the
        listeners."""
        if self.path is None:
            return
        now = time.time()
        with self._write_lock:
            with self._lock:
                if not force and now - self._last_write < self.heartbeat_seconds:
                    return
                self._last_write = now
                sharded = self._shard_count > 1
                listeners = list(self._listeners)
            if sharded:
                summary = self._write_shards()
            else:
                doc = self.document()
                summary = doc["summary"]
                try:
                    os.makedirs(self.directory, exist_ok=True)
                    self._atomic_write(self.path, doc)
                except OSError as exc:
                    logger.debug("fleet_health snapshot not written: %r", exc)
                with self._lock:
                    self._dirty.clear()
                self._cleanup_shard_layout()
        if force and summary is not None:
            for listener in listeners:
                try:
                    listener(summary)
                except Exception:  # noqa: BLE001 - listeners are advisory
                    pass

    @staticmethod
    def _atomic_write(path: str, doc: Dict[str, Any]) -> None:
        tmp = os.path.join(os.path.dirname(path), f".{os.path.basename(path)}.tmp-{os.getpid()}")
        try:
            with open(tmp, "w") as f:
                json.dump(doc, f, default=str)
            os.replace(tmp, path)
        except OSError:
            with contextlib.suppress(OSError):
                os.remove(tmp)
            raise

    def _write_shards(self) -> Dict[str, Any]:
        """Write the dirty shards and ``summary.json``; the fleet summary."""
        with self._lock:
            count = self._shard_count
            dirty = sorted(self._dirty)
            self._dirty.clear()
            layout_changed, self._layout_changed = self._layout_changed, False
            payloads = {
                shard: json.dumps({name: self._machines[name] for name in sorted(self._shard_members.get(shard) or ())
                                   if name in self._machines}, default=str)
                for shard in dirty
            }
            plan_accuracy = dict(self._plan_accuracy) if self._plan_accuracy else None
            total = len(self._machines)
            self._refresh_summaries_locked()
            shard_summaries = {shard: e["summary"] for shard, e in self._summary_cache.items()}
            offender_pools = [e["offenders"] for e in self._summary_cache.values()]
        summary = _fold_summaries(shard_summaries.values())
        stamp = _iso(time.time())
        current = {_shard_file_name(k, count) for k in range(count)}
        try:
            os.makedirs(self.shard_dir, exist_ok=True)
            if layout_changed:  # another shard count: drop the old layout's files
                for entry in os.listdir(self.shard_dir):
                    if entry.startswith("shard-") and entry.endswith(".json") and entry not in current:
                        with contextlib.suppress(OSError):
                            os.remove(os.path.join(self.shard_dir, entry))
            for shard in dirty:
                self._atomic_write(os.path.join(self.shard_dir, _shard_file_name(shard, count)), {
                    "version": 1, "kind": "fleet-health-shard", "project": self.project, "updated_at": stamp,
                    "shard": shard, "shards": count, "machines": _with_health(json.loads(payloads[shard])),
                    "summary": shard_summaries.get(shard),
                })
            summary_doc: Dict[str, Any] = {
                "version": 1, "kind": "fleet-health-summary", "project": self.project, "updated_at": stamp,
                "shards": count, "machines_total": total, "summary": summary,
                "offenders": _merge_offenders(offender_pools, _OFFENDER_CAP),
            }
            if plan_accuracy is not None:
                summary_doc["plan_accuracy"] = plan_accuracy
            self._atomic_write(os.path.join(self.shard_dir, FLEET_HEALTH_SUMMARY_FILE), summary_doc)
            # the shards are now the snapshot: the single file goes
            if os.path.exists(self.path):
                with contextlib.suppress(OSError):
                    os.remove(self.path)
        except OSError as exc:
            logger.debug("fleet_health shard flush failed: %r", exc)
        return summary

    def _cleanup_shard_layout(self) -> None:
        """One shard: remove a shard directory an earlier, larger ledger left."""
        if self.shard_dir is None or not os.path.isdir(self.shard_dir):
            return
        with contextlib.suppress(OSError):
            for entry in os.listdir(self.shard_dir):
                with contextlib.suppress(OSError):
                    os.remove(os.path.join(self.shard_dir, entry))
            os.rmdir(self.shard_dir)

    def flush(self) -> None:
        self.write(force=True)

    def restore(self, doc: Dict[str, Any]) -> None:
        """Adopt a persisted snapshot's records (the section keys this
        ledger knows) and plan accuracy."""
        if not isinstance(doc, dict) or not isinstance(doc.get("machines"), dict):
            return
        template = _new_machine()
        with self._lock:
            for name, record in doc["machines"].items():
                machine = self._machine(str(name))
                for section in template:
                    incoming = record.get(section) if isinstance(record, dict) else None
                    if isinstance(incoming, dict):
                        for key in template[section]:
                            if key in incoming:
                                machine[section][key] = incoming[key]
            if isinstance(doc.get("plan_accuracy"), dict):
                self._plan_accuracy = dict(doc["plan_accuracy"])

    def _load_own_snapshot(self) -> Optional[Dict[str, Any]]:
        """This ledger's own persisted records (``fleet_health.json``,
        never a JAX worker's variant), whichever layout holds them:
        adopting another worker's would double its counts once readers
        merge the snapshots."""
        if self.shard_dir and os.path.isdir(self.shard_dir):
            doc = _load_shard_unit(self.shard_dir)
            if doc is not None:
                return doc
        doc = _load_json(self.path) if self.path else None
        return doc if isinstance(doc, dict) else None


#: directory -> the newest ledger :func:`ledger_for` made for it, kept for
#: the life of the process as the JAX package keeps its one ledger a directory
_made_ledgers: Dict[str, "FleetHealthLedger"] = {}
_made_lock = threading.Lock()


def ledger_for(directory: str, project: str = "") -> Any:
    """A ledger for ``directory`` that has adopted its last snapshot, or
    :data:`NULL_LEDGER` when health telemetry is off."""
    if not health_enabled():
        return NULL_LEDGER
    ledger = FleetHealthLedger(directory=directory, project=project)
    persisted = ledger._load_own_snapshot()
    if isinstance(persisted, dict):
        ledger.restore(persisted)
    with _made_lock:
        _made_ledgers[os.path.abspath(directory)] = ledger
    return ledger


_serving_ledgers: Dict[str, Any] = {}
_serving_lock = threading.Lock()


def _reset_after_fork() -> None:
    """Drop the inherited ledgers in a forked worker: each holds the
    parent's snapshot path, so workers writing through them would
    overwrite one file. The per-call pid check of :func:`serving_ledger`
    guards the same; the worker is single-threaded here and the inherited
    locks may be held, so they are rebound, not taken."""
    global _made_ledgers, _made_lock, _serving_ledgers, _serving_lock
    _made_lock, _serving_lock = threading.Lock(), threading.Lock()
    _made_ledgers, _serving_ledgers = {}, {}


register_postfork_reset(_reset_after_fork, name="telemetry.fleet_health.ledgers")


def serving_ledger(directory: str, project: str = "") -> Any:
    """The process's serving ledger for ``directory``, made on first use
    by :func:`ledger_for` (again in a forked process, whose snapshot path
    holds its own pid); :data:`NULL_LEDGER` while health telemetry is
    off. Lock-free once made."""
    if not health_enabled():
        return NULL_LEDGER
    key = os.path.abspath(directory)
    ledger = _serving_ledgers.get(key)
    if ledger is None or ledger._pid != os.getpid():
        with _serving_lock:
            ledger = _serving_ledgers.get(key)
            if ledger is None or ledger._pid != os.getpid():
                ledger = _serving_ledgers[key] = ledger_for(directory, project=project)
    return ledger


def live_serving_ledger(directory: str) -> Optional["FleetHealthLedger"]:
    """The serving ledger of ``directory`` if this process has made one."""
    return _serving_ledgers.get(os.path.abspath(directory))


def reset_serving_ledgers() -> None:
    """Forget every serving ledger (tests)."""
    with _serving_lock:
        _serving_ledgers.clear()


def ledger_summaries() -> Dict[str, Dict[str, Any]]:
    """Directory -> bounded summary of every ledger the process made, what
    the Prometheus fleet-health collector reads (``fleet_health.py:1210-1215``):
    a directory's serving ledger where there is one (it adopted the build's
    snapshot), else the newest build ledger. As in the JAX package, a
    directory stays until :func:`reset_ledgers`."""
    with _made_lock:
        ledgers = dict(_made_ledgers)
    with _serving_lock:
        ledgers.update(_serving_ledgers)
    return {path: ledger.summary() for path, ledger in ledgers.items()}


def reset_ledgers() -> None:
    """Forget every ledger, serving ones included (tests)."""
    with _made_lock:
        _made_ledgers.clear()
    reset_serving_ledgers()


def _load_shard_unit(shard_dir: str) -> Optional[Dict[str, Any]]:
    """A shard directory as one document (the newest flush wins a machine)."""
    docs = [d for d in map(_load_json, _shard_files(shard_dir)) if isinstance(d, dict)
            and isinstance(d.get("machines"), dict)]
    if not docs:
        return None
    docs.sort(key=lambda d: str(d.get("updated_at") or ""))
    machines: Dict[str, Any] = {}
    for doc in docs:
        machines.update(doc["machines"])
    merged: Dict[str, Any] = {"version": 1, "project": docs[-1].get("project", ""),
                              "updated_at": docs[-1].get("updated_at"), "machines": machines,
                              "summary": summarize(machines)}
    summary_doc = _load_json(os.path.join(shard_dir, FLEET_HEALTH_SUMMARY_FILE))
    if isinstance(summary_doc, dict) and isinstance(summary_doc.get("plan_accuracy"), dict):
        merged["plan_accuracy"] = summary_doc["plan_accuracy"]
    return merged


def load_health(directory: str) -> Optional[Dict[str, Any]]:
    """The health snapshot of ``directory`` (the shard layout when it has
    one, else ``fleet_health.json``), or None."""
    shard_dir = os.path.join(directory, FLEET_HEALTH_SHARD_DIR)
    if os.path.isdir(shard_dir):
        doc = _load_shard_unit(shard_dir)
        if doc is not None:
            return doc
    doc = _load_json(os.path.join(directory, FLEET_HEALTH_FILE))
    return doc if isinstance(doc, dict) else None


# -- the merged view of every worker's snapshot --------------------------------


def health_snapshot_paths(directory: str) -> List[str]:
    """Every single-file health snapshot in ``directory``: the shared
    ``fleet_health.json`` and the per-worker ``fleet_health-<pid>.json``,
    sorted (a sharded worker is in :func:`health_snapshot_units`)."""
    try:
        entries = os.listdir(directory)
    except OSError:
        return []
    return [os.path.join(directory, entry) for entry in sorted(entries)
            if entry == FLEET_HEALTH_FILE or is_worker_variant(entry, FLEET_HEALTH_FILE)]


def health_snapshot_units(directory: str) -> List[Dict[str, Any]]:
    """Every persisted snapshot in ``directory``, one unit a worker:
    ``{"stem", "kind": "file" | "shards", "paths", "dir"}``. A worker that
    left both layouts counts once, by its shard directory."""
    try:
        entries = os.listdir(directory)
    except OSError:
        return []
    files: Dict[str, str] = {}
    shard_dirs: Dict[str, str] = {}
    for entry in sorted(entries):
        path = os.path.join(directory, entry)
        if entry == FLEET_HEALTH_FILE or is_worker_variant(entry, FLEET_HEALTH_FILE):
            files[os.path.splitext(entry)[0]] = path
        elif (entry == FLEET_HEALTH_SHARD_DIR or is_worker_variant(entry, FLEET_HEALTH_SHARD_DIR)) \
                and os.path.isdir(path):
            shard_dirs[os.path.splitext(entry)[0]] = path
    units: List[Dict[str, Any]] = []
    for stem in sorted(set(files) | set(shard_dirs)):
        shard_dir = shard_dirs.get(stem)
        if shard_dir is not None:
            paths = _shard_files(shard_dir)
            if paths:
                units.append({"stem": stem, "kind": "shards", "paths": paths, "dir": shard_dir})
                continue
        if stem in files:
            units.append({"stem": stem, "kind": "file", "paths": [files[stem]], "dir": None})
    return units


def _load_unit_document(unit: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    if unit["kind"] == "shards":
        return _load_shard_unit(unit["dir"])
    doc = _load_json(unit["paths"][0])
    return doc if isinstance(doc, dict) else None


def _unit_summary(unit: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    """A worker's bounded summary without reading its machines:
    ``summary.json`` of a sharded worker, the document's own summary of a
    single-file one."""
    if unit["kind"] == "shards":
        doc = _load_json(os.path.join(unit["dir"], FLEET_HEALTH_SUMMARY_FILE))
        return doc if isinstance(doc, dict) and isinstance(doc.get("summary"), dict) else None
    doc = _load_json(unit["paths"][0])
    if isinstance(doc, dict) and isinstance(doc.get("summary"), dict):
        return {"summary": doc["summary"], "machines_total": len(doc.get("machines") or {}),
                "updated_at": doc.get("updated_at"), "plan_accuracy": doc.get("plan_accuracy")}
    return None


def _newest(records: List[Dict[str, Any]], stamp_key: str) -> Dict[str, Any]:
    """The record with the greatest ISO stamp at ``stamp_key`` (an
    unstamped one loses; a tie keeps the later one)."""
    best = records[0]
    best_stamp = str(best.get(stamp_key) or "")
    for record in records[1:]:
        stamp = str(record.get(stamp_key) or "")
        if stamp >= best_stamp:
            best, best_stamp = record, stamp
    return best


#: the stamp that picks the newest worker's copy of each state section
_SECTION_STAMPS = {"drift": "evaluated_at", "build": "built_at", "quarantine": "since", "breaker": "updated_at"}


def merge_health_documents(docs: List[Dict[str, Any]]) -> Optional[Dict[str, Any]]:
    """One document of many workers' snapshots: serving counts summed
    (each worker saw its own traffic), the residual mean weighted by rows,
    each state section the newest worker's, health and summary computed
    again over the merged records."""
    docs = [doc for doc in docs if isinstance(doc, dict) and isinstance(doc.get("machines"), dict)]
    if not docs:
        return None
    by_machine: Dict[str, List[Dict[str, Any]]] = {}
    for doc in docs:
        for name, record in doc["machines"].items():
            if isinstance(record, dict):
                by_machine.setdefault(str(name), []).append(record)
    merged_machines: Dict[str, Dict[str, Any]] = {}
    for name, records in by_machine.items():
        machine = _new_machine()
        serving = machine["serving"]
        weighted_residual, residual_rows = 0.0, 0
        for record in records:
            incoming = record.get("serving") or {}
            serving["requests"] += int(incoming.get("requests") or 0)
            serving["errors"] += int(incoming.get("errors") or 0)
            rows = int(incoming.get("rows") or 0)
            serving["rows"] += rows
            residual = incoming.get("residual_mean")
            if residual is not None and rows > 0:
                weighted_residual += float(residual) * rows
                residual_rows += rows
            stamp = incoming.get("last_request_at")
            if stamp and str(stamp) > str(serving["last_request_at"] or ""):
                serving["last_request_at"] = stamp
        if residual_rows:
            serving["residual_mean"] = round(weighted_residual / residual_rows, 8)
        for section, stamp_key in _SECTION_STAMPS.items():
            candidates = [record[section] for record in records if isinstance(record.get(section), dict)]
            if candidates:
                chosen = _newest(candidates, stamp_key)
                for key in machine[section]:
                    if key in chosen:
                        machine[section][key] = chosen[key]
        machine["health"] = {"score": health_score(machine), "state": machine_state(machine)}
        merged_machines[name] = machine
    newest_doc = _newest(docs, "updated_at")
    merged: Dict[str, Any] = {
        "version": 1,
        "project": newest_doc.get("project", ""),
        "updated_at": newest_doc.get("updated_at"),
        "workers_merged": len(docs),
        "machines": merged_machines,
        "summary": summarize(merged_machines),
    }
    accuracy = [doc["plan_accuracy"] for doc in docs if isinstance(doc.get("plan_accuracy"), dict)]
    if accuracy:
        merged["plan_accuracy"] = accuracy[-1]
    return merged


def load_merged_health(directory: str, live_documents: Optional[List[Dict[str, Any]]] = None,
                       exclude_paths: Optional[List[str]] = None) -> Optional[Dict[str, Any]]:
    """The merged view of every snapshot in ``directory`` and the live
    documents given, leaving out the workers of ``exclude_paths`` (a live
    ledger's own snapshot, whichever layout it last wrote)."""
    docs = list(live_documents or [])
    excluded = {os.path.splitext(os.path.basename(p))[0] for p in (exclude_paths or [])}
    for unit in health_snapshot_units(directory):
        if unit["stem"] in excluded:
            continue
        doc = _load_unit_document(unit)
        if isinstance(doc, dict):
            docs.append(doc)
    if len(docs) == 1 and "machines" in docs[0] and "summary" in docs[0]:
        return docs[0]
    return merge_health_documents(docs)


def breaker_tripped_machines(directory: str, max_age_s: float = 3600.0) -> Dict[str, Dict[str, Any]]:
    """The machines whose serving breaker is open or half-open, from the
    merged snapshots of ``directory`` (what the lifecycle nominates for a
    rebuild), records older than ``max_age_s`` left out. When every
    worker's summary counts no tripped breaker the machines are not read."""
    units = health_snapshot_units(directory) if 0 < max_age_s <= BREAKER_STATE_MAX_AGE_S else []
    if units:
        tripped_hint = 0
        for unit in units:
            count = ((_unit_summary(unit) or {}).get("summary") or {}).get("breaker_tripped")
            if count is None:
                tripped_hint = -1
                break
            tripped_hint += int(count)
        if tripped_hint == 0:
            return {}
    doc = load_merged_health(directory)
    if not isinstance(doc, dict):
        return {}
    return {str(name): dict((record or {}).get("breaker") or {})
            for name, record in (doc.get("machines") or {}).items()
            if _live_breaker_state(record or {}, max_age_s=max_age_s) is not None}


# -- the joined fleet-status document -------------------------------------------


def _machine_selection(machines: Union[None, str, Iterable[str]]) -> Tuple[Optional[str], Optional[List[str]]]:
    """The ``machines=`` selector as ``(kind, names)``: kind None (the
    size decides), ``none``, ``all``, a state (``healthy``, ``degraded``,
    ``drifting``, ``quarantined``, ``unhealthy``) or ``names``.

    >>> _machine_selection("all"), _machine_selection("a, b")
    (('all', None), ('names', ['a', 'b']))
    """
    if machines is None:
        return None, None
    if isinstance(machines, str):
        token = machines.strip()
        low = token.lower()
        if low in ("", "none", "summary"):
            return "none", None
        if low == "all":
            return "all", None
        if low in ("healthy", "degraded", "drifting", "quarantined", "unhealthy"):
            return low, None
        return "names", [t.strip() for t in token.split(",") if t.strip()]
    return "names", [str(name) for name in machines]


def _select_machines(machines: Dict[str, Dict[str, Any]], kind: Optional[str], names: Optional[List[str]],
                     offset: int, limit: int) -> Tuple[Dict[str, Dict[str, Any]], bool]:
    """A selection and its page of the merged records; ``(page, truncated)``."""
    if kind == "names":
        pool = [n for n in (names or []) if n in machines]
    elif kind == "unhealthy":
        pool = [n for n in sorted(machines) if (machines[n].get("health") or {}).get("state") != "healthy"]
    elif kind in ("healthy", "degraded", "drifting", "quarantined"):
        pool = [n for n in sorted(machines) if (machines[n].get("health") or {}).get("state") == kind]
    else:  # "all"
        pool = sorted(machines)
    page = pool[offset:offset + limit]
    return {name: machines[name] for name in page}, len(pool) > offset + len(page)


def _doc_offenders(machines: Dict[str, Dict[str, Any]], top_k: int) -> List[Dict[str, Any]]:
    """The top-K offenders of a merged document's records."""
    entries = []
    for name, record in machines.items():
        health = record.get("health") or {}
        state = health.get("state")
        if state in (None, "healthy"):
            continue
        entries.append({"machine": name, "score": health.get("score", 0.0), "state": state,
                        "reason": _offender_reason(record, state)})
    return heapq.nsmallest(top_k, entries, key=lambda e: (e["score"], e["machine"]))


def fleet_status_document(
    directory: str,
    device: Optional[Dict[str, Any]] = None,
    programs: Optional[Dict[str, Any]] = None,
    serving: Optional[Dict[str, Any]] = None,
    stream: Optional[Dict[str, Any]] = None,
    machines: Union[None, str, Iterable[str]] = None,
    limit: Optional[int] = None,
    offset: int = 0,
    ledger: Any = None,
) -> Dict[str, Any]:
    """
    The joined operator view of a build and serve directory:
    ``build`` (``build_status.json``), ``plan`` (``fleet_plan.json``'s
    strategy and totals with the measured plan accuracy), ``lifecycle``
    (``../.lifecycle/state.json`` and ``quarantine.json``), ``health``
    (``ledger``'s live records, when the caller holds one, merged with
    every other worker's snapshot), ``slo`` (``telemetry/slo.py``), and
    the sections the caller injects: ``device``, ``programs``, ``serving``
    and ``stream``. A section without data is None.

    The health section is bounded: records are inlined only while the
    fleet has at most :data:`FLEET_STATUS_MAX_MACHINES` (500), else
    the summary, the count and the top :data:`FLEET_STATUS_TOP_K`
    (10) offenders. ``machines`` selects (``all``, a state, ``unhealthy``,
    a comma list of names, ``none``) and ``limit``/``offset`` page, capped
    at the same number.
    """
    from .progress import load_status
    from .slo import slo_directory, slo_section

    directory = os.path.normpath(directory)
    root = os.path.dirname(directory)
    doc: Dict[str, Any] = {
        "version": 1,
        "directory": directory,
        "revision": os.path.basename(directory),
        "generated_at": _iso(time.time()),
    }
    doc["build"] = load_status(directory)
    plan = _load_json(os.path.join(directory, "fleet_plan.json"))

    kind, names = _machine_selection(machines)
    max_inline, top_k = FLEET_STATUS_MAX_MACHINES, FLEET_STATUS_TOP_K
    page_limit = max_inline if limit is None else max(0, min(int(limit), max_inline))
    page_offset = max(0, int(offset or 0))

    # the live ledger merged with every OTHER worker's snapshot: its own
    # is left out by stem, or a process would count itself twice
    if ledger is not None and not getattr(ledger, "enabled", False):
        ledger = None
    own_stems = set()
    if ledger is not None and ledger.path:
        own_stems.add(os.path.splitext(os.path.basename(ledger.path))[0])
    units = [unit for unit in health_snapshot_units(directory) if unit["stem"] not in own_stems]
    single_live = ledger is not None and not units

    bounded_doc: Optional[Dict[str, Any]] = None
    health_doc: Optional[Dict[str, Any]] = None
    if single_live and (kind == "none" or (kind is None and ledger.machine_count() > max_inline)):
        bounded_doc = ledger.bounded_document(top_k)
    elif kind in (None, "none") and ledger is None and len(units) == 1 and units[0]["kind"] == "shards":
        candidate = _unit_summary(units[0])
        if candidate is not None and (kind == "none" or int(candidate.get("machines_total") or 0) > max_inline):
            bounded_doc = candidate
    if bounded_doc is None:
        live_docs = [ledger.document()] if ledger is not None else []
        own_paths = [ledger.path] if ledger is not None and ledger.path else []
        health_doc = load_merged_health(directory, live_documents=live_docs, exclude_paths=own_paths)

    accuracy_source = bounded_doc if bounded_doc is not None else (health_doc or {})
    doc["plan"] = {"strategy": plan.get("strategy"), "totals": plan.get("totals"),
                   "accuracy": accuracy_source.get("plan_accuracy")} if isinstance(plan, dict) else None

    state = _load_json(os.path.join(root, _LIFECYCLE_DIR, _LIFECYCLE_STATE_FILE))
    quarantine = _load_json(os.path.join(root, _LIFECYCLE_DIR, _LIFECYCLE_QUARANTINE_FILE))
    if isinstance(state, dict):
        doc["lifecycle"] = {
            "phase": state.get("phase"),
            "serving_revision": state.get("serving_revision"),
            "canary_revision": state.get("canary_revision"),
            "stale": state.get("stale") or [],
            "quarantine_records": len(quarantine) if isinstance(quarantine, list) else 0,
            "history": (state.get("history") or [])[-5:],
        }
    else:
        doc["lifecycle"] = None

    if bounded_doc is not None:
        total = int(bounded_doc.get("machines_total") or 0)
        doc["health"] = {
            "summary": bounded_doc.get("summary"),
            "machines": None,
            "machines_total": total,
            "machines_truncated": total > 0,
            "top_offenders": (bounded_doc.get("offenders") or [])[:top_k],
            "updated_at": bounded_doc.get("updated_at"),
        }
    elif health_doc is not None:
        machines_all = health_doc.get("machines") or {}
        total = len(machines_all)
        section: Dict[str, Any] = {
            "summary": health_doc.get("summary"),
            "updated_at": health_doc.get("updated_at"),
            "machines_total": total,
            "top_offenders": _doc_offenders(machines_all, top_k),
        }
        if kind is None:
            section["machines"] = machines_all if total <= max_inline else None
            section["machines_truncated"] = total > max_inline
        elif kind == "none":
            section["machines"] = None
            section["machines_truncated"] = total > 0
        else:
            selected, truncated = _select_machines(machines_all, kind, names, page_offset, page_limit)
            section["machines"] = selected
            section["machines_offset"] = page_offset
            section["machines_truncated"] = truncated
        if health_doc.get("workers_merged"):
            section["workers_merged"] = health_doc["workers_merged"]
        doc["health"] = section
    else:
        doc["health"] = None
    doc["slo"] = slo_section(slo_directory(directory) or directory)
    doc["device"] = device
    doc["programs"] = programs
    doc["serving"] = serving
    doc["stream"] = stream
    return doc


def render_fleet_status(doc: Dict[str, Any]) -> str:
    """The joined document as the ``fleet-status`` command's text."""
    lines: List[str] = [f"Directory: {doc.get('directory', '-')}", f"Revision:  {doc.get('revision', '-')}"]
    build = doc.get("build")
    if build:
        machines = build.get("machines") or {}
        lines.append(
            f"Build:     {build.get('state', '?')}"
            + (f" (phase: {build.get('phase')})" if build.get("phase") else "")
            + f" — {machines.get('completed', 0)}/{machines.get('total', 0)} done, {machines.get('failed', 0)} failed"
        )
    else:
        lines.append("Build:     (no build_status.json)")
    plan = doc.get("plan")
    if plan and plan.get("totals"):
        totals = plan["totals"]
        accuracy = plan.get("accuracy") or {}
        lines.append(
            f"Plan:      {plan.get('strategy', '?')} — {totals.get('buckets', 0)} bucket(s), "
            f"{totals.get('compiles', 0)} predicted compile(s), "
            f"waste {100.0 * float(totals.get('padding_waste') or 0.0):.1f}%"
        )
        if accuracy:
            measured = accuracy.get("measured_member_waste")
            hbm = accuracy.get("measured_hbm_peak_bytes")
            lines.append(
                f"  actuals: {accuracy.get('actual_compiles', '?')} compile(s), fit {accuracy.get('actual_fit_s', '?')}s"
                + (f", member waste {100.0 * float(measured):.1f}%" if measured is not None else "")
                + (f", HBM peak {int(hbm) / (1 << 20):.1f} MiB" if hbm else "")
            )
    lifecycle = doc.get("lifecycle")
    if lifecycle:
        lines.append(
            f"Lifecycle: {lifecycle.get('phase', '?')} — serving {lifecycle.get('serving_revision') or '-'}"
            + (f", canary {lifecycle['canary_revision']}" if lifecycle.get("canary_revision") else "")
            + (f", {lifecycle.get('quarantine_records')} quarantine record(s)"
               if lifecycle.get("quarantine_records") else "")
        )
    health = doc.get("health")
    if health and health.get("summary"):
        summary = health["summary"]
        lines.append(
            f"Health:    {summary.get('machines', 0)} machine(s) — {summary.get('healthy', 0)} healthy, "
            f"{summary.get('drifting', 0)} drifting, {summary.get('degraded', 0)} degraded, "
            f"{summary.get('quarantined', 0)} quarantined"
            f" (error rate {100.0 * float(summary.get('error_rate') or 0.0):.2f}%)"
        )
        total = health.get("machines_total")
        shown = health.get("machines")
        if health.get("machines_truncated") and total:
            lines.append(f"  (per-machine records elided at {total} members — select with --machines/?machines=)")
        elif isinstance(shown, dict) and total and len(shown) < total:
            lines.append(f"  (showing {len(shown)} of {total} machine record(s))")
        offenders = health.get("top_offenders")
        if offenders is None:
            # a document without the offender rows: derived from its records
            offenders = heapq.nsmallest(10, [
                {"machine": name, "score": record["health"]["score"], "state": record["health"]["state"],
                 "reason": _offender_reason(record, record["health"]["state"])}
                for name, record in (shown or {}).items() if record.get("health", {}).get("state") != "healthy"
            ], key=lambda e: (e["score"], e["machine"]))
        for entry in offenders:
            lines.append(f"  {entry.get('machine')}: {entry.get('state')} (score {float(entry.get('score') or 0.0):.2f})"
                         + (f" — {entry['reason']}" if entry.get("reason") else ""))
    else:
        lines.append("Health:    (no fleet_health.json)")
    slo = doc.get("slo")
    if slo:
        verdict = "inside SLO" if slo.get("ok", True) else "BURNING"
        lines.append(f"SLO:       {verdict} — {slo.get('firing', 0)} firing, {slo.get('pending', 0)} pending alert(s)")
        for name, remaining in sorted((slo.get("budgets") or {}).items()):
            lines.append(f"  {name}: {100.0 * float(remaining):.1f}% budget remaining")
    device = doc.get("device")
    if device:
        memory = device.get("memory")
        if memory and memory.get("available"):
            lines.append(
                f"Device:    {memory.get('measured_devices', 0)} device(s) — "
                f"{memory.get('bytes_in_use', 0) / (1 << 20):.1f} MiB in use, "
                f"peak {memory.get('peak_bytes_in_use', 0) / (1 << 20):.1f} MiB"
                + (f" ({100.0 * memory['utilization']:.1f}% of limit)" if memory.get("utilization") is not None
                   else "")
            )
        else:
            lines.append("Device:    memory stats unavailable on this backend")
        for kind, counters in sorted((device.get("compile_cache") or {}).items()):
            rate = counters.get("hit_rate")
            lines.append(f"  {kind} programs: {counters.get('compiles', 0)} compile(s), "
                         f"{counters.get('cache_hits', 0)} cache hit(s)"
                         + (f" ({100.0 * rate:.1f}% hit rate)" if rate is not None else ""))
        persistent = device.get("persistent_cache")
        if persistent:
            lines.append(f"  persistent cache: {persistent.get('entries', 0)} entr"
                         f"{'y' if persistent.get('entries', 0) == 1 else 'ies'}, "
                         f"{persistent.get('bytes', 0) / (1 << 20):.1f} MiB ({persistent.get('path')})")
    programs = doc.get("programs")
    if programs:
        lines.append(f"Programs:  {programs.get('programs', 0)} cached jit entr"
                     f"{'y' if programs.get('programs', 0) == 1 else 'ies'}, "
                     f"{programs.get('signatures', 0)} compiled signature(s)")
        by_precision = programs.get("by_precision")
        if by_precision:
            lines.append("  by precision: " + ", ".join(f"{p}={n}" for p, n in sorted(by_precision.items())))
    serving = doc.get("serving")
    if serving:
        precision = serving.get("precision") or {}
        coalesced = precision.get("coalesced") or {}
        gates = [g for g in serving.get("gates", []) if isinstance(g, dict)]
        lines.append(
            f"Serving:   precision={precision.get('config', 'f32')}"
            + (" — coalesced " + ", ".join(f"{p}={n}" for p, n in sorted(coalesced.items())) if coalesced else "")
            + (f", {serving.get('precision_degraded', 0)} degraded req(s)" if serving.get("precision_degraded")
               else "")
        )
        for gate in gates:
            lines.append(f"  gate {gate.get('precision')}: {'PASS' if gate.get('passed') else 'FAIL — degraded to f32'}"
                         + (f" (agreement {gate.get('agreement_min'):.4f})" if gate.get("agreement_min") is not None
                            else ""))
        breaker = serving.get("breaker") or {}
        if breaker.get("open") or breaker.get("half_open") or breaker.get("trips"):
            lines.append(f"  breakers: {breaker.get('open', 0)} open, {breaker.get('half_open', 0)} half-open "
                         f"({breaker.get('trips', 0)} trip(s) total)")
            for member in breaker.get("members", [])[:5]:
                lines.append(f"    {member.get('member')}: {member.get('state')}"
                             + (f", cooldown {member.get('cooldown_s')}s" if member.get("cooldown_s") else ""))
    stream = doc.get("stream")
    if stream:
        accounting = stream.get("accounting") or {}
        lag = stream.get("lag") or {}
        lag_p95 = lag.get("lag_p95_ms")
        lines.append(f"Stream:    {stream.get('sessions_active', 0)} active session(s), "
                     f"{stream.get('subscribers', 0)} subscriber(s)" + (" — DRAINING" if stream.get("draining") else ""))
        lines.append(f"  rows: {accounting.get('rows_in', 0)} in, {accounting.get('rows_scored', 0)} scored, "
                     f"{accounting.get('rows_failed', 0)} failed, {accounting.get('rows_pending', 0)} pending, "
                     f"{accounting.get('rows_shed', 0)} shed (gap {accounting.get('gap', 0)})")
        lines.append(
            "  freshness: lag p95 " + (f"{lag_p95:g}ms" if lag_p95 is not None else "-")
            + (f", watermark delay {lag['watermark_delay_max_ms']:g}ms"
               if lag.get("watermark_delay_max_ms") is not None else "")
            + (f", {stream['quarantined_machines']} quarantined machine(s)" if stream.get("quarantined_machines")
               else "")
        )
    return "\n".join(lines)
