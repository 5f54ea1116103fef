"""
The fleet health ledger, the build side of
``gordo_tpu/telemetry/fleet_health.py`` (``:55-460``, ``:461-1157``,
``:1224-1268``).

One record a machine (``serving``, ``drift``, ``build``, ``quarantine``
and ``breaker`` sections, the JAX package's keys), each with its derived
health score and state, and a bounded summary of the fleet, persisted
beside the artifacts as ``fleet_health.json``. A fleet build feeds the
``build`` section: the final loss of each trained member, a landed
artifact, a failure or a degradation with its error, and the build's
predicted-against-measured plan numbers (``plan_accuracy``). Past 512
machines (or with ``GORDO_TPU_HEALTH_SHARDS`` set) the snapshot splits
into ``fleet_health.d/shard-XXXofYYY.json`` plus a bounded
``summary.json``; a flush rewrites only the shards whose machines
changed. Writes that change no state ride the
``GORDO_TPU_HEALTH_HEARTBEAT`` throttle (2 s).

The ledger belongs to the builder that made it (:func:`ledger_for` makes
a new one and adopts the directory's last snapshot), where the JAX
package keeps one ledger a directory for the whole process. Not ported
yet: the serving feeds (requests, scores, drift, quarantine, breaker,
promotion) and the joined fleet-status document (``ROADMAP.md`` item
11b); the record keeps their sections, so a document reads as the JAX
package's.
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
from typing import Any, Dict, Iterable, List, Optional

from ..utils.env import env_bool, env_float, env_int
from .recorder import _iso, enabled

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

    def record_build(self, *args, **kwargs):
        pass

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
        self.path = os.path.join(self.directory, FLEET_HEALTH_FILE) if self.directory is not None else None
        self.shard_dir = os.path.join(self.directory, FLEET_HEALTH_SHARD_DIR) if self.directory is not None else None
        self.project = project
        if heartbeat_seconds is None:
            heartbeat_seconds = env_float(HEALTH_HEARTBEAT_ENV, DEFAULT_HEALTH_HEARTBEAT) or DEFAULT_HEALTH_HEARTBEAT
        self.heartbeat_seconds = max(0.0, heartbeat_seconds)
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

    def record_plan_accuracy(self, accuracy: Dict[str, Any]) -> None:
        """The build's plan, predicted against measured."""
        with self._lock:
            self._plan_accuracy = dict(accuracy)
        self.write(force=True)

    # -- the documents ----------------------------------------------------------

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
        ``summary.json``."""
        if self.path is None:
            return
        now = time.time()
        with self._write_lock:
            with self._lock:
                if not force and now - self._last_write < self.heartbeat_seconds:
                    return
                self._last_write = now
                sharded = self._shard_count > 1
            if sharded:
                self._write_shards()
            else:
                doc = self.document()
                try:
                    os.makedirs(self.directory, exist_ok=True)
                    self._atomic_write(self.path, doc)
                except OSError as exc:
                    logger.debug("fleet_health snapshot not written: %r", exc)
                with self._lock:
                    self._dirty.clear()
                self._cleanup_shard_layout()

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

    def _write_shards(self) -> None:
        """Write the dirty shards and ``summary.json``."""
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
        """The directory's persisted records, whichever layout holds them."""
        return load_health(self.directory) if self.directory is not None else None


def ledger_for(directory: str, project: str = "") -> Any:
    """A ledger for ``directory`` that has adopted its last snapshot, or
    :data:`NULL_LEDGER` when health telemetry is off."""
    if not health_enabled():
        return NULL_LEDGER
    ledger = FleetHealthLedger(directory=directory, project=project)
    persisted = ledger._load_own_snapshot()
    if isinstance(persisted, dict):
        ledger.restore(persisted)
    return ledger


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
