"""
The rollups (``gordo_tpu/telemetry/aggregate.py``): every trace sink of a
directory folded into fixed time windows that the SLO engine evaluates
without reading the spans again.

- :func:`discover_sinks` finds the directory's sinks: ``serve_trace.jsonl``
  and ``build_trace.jsonl``, their ``-<pid>`` worker variants and the
  rotated generations (``.1``, ``.2``, ...) of each;
- :class:`RollupStore` reads only the new bytes of each file (an offset
  kept by a signature of the file's first line, so a rotation, which
  renames the bytes, resumes where they went), drops spans seen before by
  ``(trace_id, span_id)``, and folds each span into the window of its end
  time: ``rollups/<window start>.json`` with request and error counts,
  fixed-bucket latency histograms, stage and machine breakdowns, the
  streaming plane's row accounting and the build's programs, each written
  atomically, then ``rollups/manifest.json`` (window index and each sink's
  span-time window) and ``rollups/rollup_state.json`` (the offsets). A
  second pass over an unchanged corpus reads no byte;
- :func:`merge_rollups` adds rollups, so windows of many workers or hosts
  merge by count addition.

The files are the JAX package's, byte for byte on equal inputs, so
either package may aggregate a directory the other began. The window
length is ``GORDO_TPU_SLO_WINDOW_SECONDS`` (default 60); the windows kept
(:data:`ROLLUP_KEEP`), the age of a dead worker's sink before it is
deleted (:data:`SINK_GC_AGE_S`) are constants at the JAX defaults, and the
manifest is always written. Stdlib only.
"""

import hashlib
import json
import logging
import os
import re
import threading
import time
from datetime import datetime, timezone
from typing import Any, Dict, Iterator, List, Optional, Tuple

from ..utils.env import env_int
from .progress import BUILD_TRACE_FILE
from .recorder import is_worker_variant
from .serving import SERVE_TRACE_FILE

logger = logging.getLogger(__name__)

ROLLUP_DIR = "rollups"
#: each file's read offset by signature (inside ROLLUP_DIR)
ROLLUP_STATE_FILE = "rollup_state.json"
#: the window index and each sink's span-time window (inside ROLLUP_DIR)
ROLLUP_MANIFEST_FILE = "manifest.json"
WINDOW_SECONDS_ENV = "GORDO_TPU_SLO_WINDOW_SECONDS"
DEFAULT_WINDOW_SECONDS = 60
#: windows kept on disk, the oldest deleted past it: a 30-day SLO at 60 s
ROLLUP_KEEP = 50_000
#: seconds a dead worker's wholly read sink stays unwritten before it is deleted
SINK_GC_AGE_S = 24 * 3600.0

#: latency bucket upper edges (ms), fixed so histograms merge by adding
#: counts; the last counts slot is the overflow
LATENCY_BUCKETS_MS: Tuple[float, ...] = (
    1.0, 2.0, 5.0, 10.0, 20.0, 50.0, 100.0, 200.0, 350.0, 500.0,
    750.0, 1000.0, 1500.0, 2500.0, 5000.0, 10000.0, 30000.0, 60000.0,
)

#: span names that are never a request's stage
_NON_STAGE_NAMES = frozenset(("request", "profile", "serve_batch", "stream_ingest", "stream_score", "stream_emit"))
_STREAM_COUNTS = ("rows_in", "rows_scored", "rows_failed", "rows_shed", "flushes", "windows")


def window_seconds() -> int:
    return max(1, env_int(WINDOW_SECONDS_ENV, DEFAULT_WINDOW_SECONDS))


def sink_window_index(directory: str) -> Dict[str, Dict[str, Any]]:
    """Each sink file's span-time window from the manifest (basename ->
    ``{"min_ts", "max_ts", "complete"}``), ``{}`` without one: what lets
    ``trace --since`` skip rotated generations by their spans' times."""
    doc = read_json(os.path.join(directory, ROLLUP_DIR, ROLLUP_MANIFEST_FILE))
    sinks = doc.get("sinks") if isinstance(doc, dict) else None
    if not isinstance(sinks, dict):
        return {}
    return {str(name): entry for name, entry in sinks.items() if isinstance(entry, dict)}


def parse_span_time(value: Any) -> Optional[float]:
    """Epoch seconds of a span's ISO timestamp (UTC when it has no zone);
    None when it does not parse.

    >>> parse_span_time("1970-01-01T00:01:00+00:00"), parse_span_time("soon")
    (60.0, None)
    """
    if not isinstance(value, str) or not value:
        return None
    try:
        stamp = datetime.fromisoformat(value)
    except ValueError:
        return None
    if stamp.tzinfo is None:
        stamp = stamp.replace(tzinfo=timezone.utc)
    return stamp.timestamp()


# -- the mergeable histogram --------------------------------------------------


def new_histogram() -> Dict[str, Any]:
    return {"buckets_ms": list(LATENCY_BUCKETS_MS), "counts": [0] * (len(LATENCY_BUCKETS_MS) + 1), "count": 0,
            "sum_ms": 0.0}


def histogram_add(histogram: Dict[str, Any], value_ms: float) -> None:
    edges = histogram["buckets_ms"]
    slot = len(edges)
    for i, edge in enumerate(edges):
        if value_ms <= edge:
            slot = i
            break
    histogram["counts"][slot] += 1
    histogram["count"] += 1
    histogram["sum_ms"] = round(histogram["sum_ms"] + value_ms, 3)


def histogram_merge(into: Dict[str, Any], other: Dict[str, Any]) -> None:
    """``other`` into ``into``: counts added; a histogram of other edges
    is binned again at its buckets' midpoints."""
    if other.get("buckets_ms") == into["buckets_ms"]:
        for i, count in enumerate(other.get("counts", ())):
            if i < len(into["counts"]):
                into["counts"][i] += int(count)
    else:
        edges = other.get("buckets_ms") or []
        lower = 0.0
        for i, count in enumerate(other.get("counts", ())):
            if not count:
                continue
            upper = edges[i] if i < len(edges) else lower * 2 or 1.0
            midpoint = (lower + upper) / 2.0
            for _ in range(int(count)):
                histogram_add(into, midpoint)
            # the totals are added below
            into["count"] -= int(count)
            into["sum_ms"] = round(into["sum_ms"] - midpoint * count, 3)
            lower = upper
    into["count"] += int(other.get("count", 0))
    into["sum_ms"] = round(into["sum_ms"] + float(other.get("sum_ms", 0.0)), 3)


def histogram_percentile(histogram: Dict[str, Any], q: float) -> float:
    """A percentile (ms), interpolated inside its bucket; the overflow
    bucket answers its lower edge.

    >>> histogram_percentile({"count": 4, "buckets_ms": [1.0, 2.0], "counts": [0, 4, 0]}, 0.5)
    1.5
    """
    total = histogram.get("count", 0)
    if not total:
        return 0.0
    rank = q * total
    edges = histogram["buckets_ms"]
    cumulative = 0
    lower = 0.0
    for i, count in enumerate(histogram["counts"]):
        if not count:
            if i < len(edges):
                lower = edges[i]
            continue
        if cumulative + count >= rank:
            if i >= len(edges):
                return round(lower, 3)
            upper = edges[i]
            inside = max(0.0, min(1.0, (rank - cumulative) / count))
            return round(lower + (upper - lower) * inside, 3)
        cumulative += count
        if i < len(edges):
            lower = edges[i]
    return round(lower, 3)


# -- sink discovery -----------------------------------------------------------

_ROTATION_SUFFIX_RE = re.compile(r"\.(\d+)$")
_WORKER_PID_RE = re.compile(r"-(\d+)$")


def sink_bases(directory: str, base_name: str) -> List[str]:
    """Every base path of one logical sink in ``directory``: the shared
    name and each ``-<pid>`` worker variant, found through its rotated
    generations too (mid-rotation the live file may be missing)."""
    try:
        entries = os.listdir(directory)
    except OSError:
        return []
    bases = set()
    for entry in entries:
        root = _ROTATION_SUFFIX_RE.sub("", entry)
        if root == base_name or is_worker_variant(root, base_name):
            bases.add(os.path.join(directory, root))
    return sorted(bases)


def generation_files(base_path: str) -> List[str]:
    """The files of one sink, oldest first (``p.N`` ... ``p.1``, ``p``),
    from the directory listing: mid-rotation ``.1`` may be missing while
    older generations are not."""
    directory, name = os.path.split(base_path)
    try:
        entries = os.listdir(directory or ".")
    except OSError:
        entries = []
    prefix = name + "."
    generations = sorted(((int(e[len(prefix):]), e) for e in entries
                          if e.startswith(prefix) and e[len(prefix):].isdigit()), reverse=True)
    paths = [os.path.join(directory, entry) for _, entry in generations]
    if os.path.exists(base_path):
        paths.append(base_path)
    return paths


def discover_sinks(directory: str) -> List[Tuple[str, str]]:
    """``(kind, path)`` of every trace file in ``directory``: ``serve``
    for the request traces, ``build`` for the build traces."""
    return [(kind, path)
            for kind, base_name in (("serve", SERVE_TRACE_FILE), ("build", BUILD_TRACE_FILE))
            for base in sink_bases(directory, base_name)
            for path in generation_files(base)]


def _worker_pid(name: str, base_name: str) -> Optional[int]:
    if not is_worker_variant(name, base_name):
        return None
    match = _WORKER_PID_RE.search(os.path.splitext(name)[0])
    return int(match.group(1)) if match else None


def _pid_alive(pid: int) -> bool:
    """Signal 0; an unknown error counts as alive (deleting a live
    worker's sink is the one unsafe answer)."""
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except OSError:
        return True
    return True


def _signature_from_head(head: bytes) -> Optional[str]:
    """A file's identity from its first line (newline included, at most
    256 bytes): an appended file keeps it for life, a rotation carries it
    along. None while the first line is incomplete; ``empty`` for an
    empty file."""
    if not head:
        return "empty"
    newline = head.find(b"\n")
    if newline != -1:
        head = head[: newline + 1]
    elif len(head) < 256:
        return None
    return hashlib.sha1(head).hexdigest()[:20]


def file_signature(path: str) -> Optional[str]:
    """:func:`_signature_from_head` of ``path``; None when it is gone."""
    try:
        with open(path, "rb") as handle:
            head = handle.read(256)
    except OSError:
        return None
    return _signature_from_head(head)


def read_json(path: str) -> Optional[Any]:
    """The JSON document at ``path``; None when it is missing or torn."""
    try:
        with open(path) as handle:
            return json.load(handle)
    except (OSError, ValueError):
        return None


def write_json(path: str, doc: Any) -> None:
    """``doc`` to ``path`` through a staged file and ``os.replace``: a
    reader never sees half a rollup or a torn alert state."""
    tmp = os.path.join(os.path.dirname(path) or ".", f".{os.path.basename(path)}.tmp-{os.getpid()}")
    with open(tmp, "w") as handle:
        json.dump(doc, handle, sort_keys=True)
    os.replace(tmp, path)


def _rollup_files(directory: str) -> List[str]:
    """The window files of a rollup directory (``<start>.json``), sorted by name."""
    return sorted(e for e in os.listdir(directory) if e.endswith(".json") and e[: -len(".json")].isdigit())


# -- the fold -----------------------------------------------------------------


def _empty_stream_section() -> Dict[str, Any]:
    """The streaming plane's rows and flushes, its flush times and the
    rows-weighted ingest-to-score lag (what the stream SLOs read)."""
    return {**{key: 0 for key in _STREAM_COUNTS}, "flush_ms": new_histogram(), "lag_ms": new_histogram()}


def _empty_rollup(start: int, seconds: int) -> Dict[str, Any]:
    return {
        "version": 1,
        "window": {"start": start, "seconds": seconds,
                   "start_iso": datetime.fromtimestamp(start, timezone.utc).isoformat()},
        "requests": {"count": 0, "errors": 0, "by_class": {"2xx": 0, "3xx": 0, "4xx": 0, "5xx": 0}},
        "latency_ms": new_histogram(),
        "stages": {},
        "machines": {},
        "build": {"device_programs": 0, "compiles": 0, "phases": {}},
        "stream": _empty_stream_section(),
        "spans": 0,
    }


def merge_rollups(into: Dict[str, Any], other: Dict[str, Any]) -> Dict[str, Any]:
    """``other`` added into ``into`` (counts add, histograms merge);
    returns ``into``."""
    requests = into["requests"]
    other_requests = other.get("requests") or {}
    requests["count"] += int(other_requests.get("count", 0))
    requests["errors"] += int(other_requests.get("errors", 0))
    for klass, count in (other_requests.get("by_class") or {}).items():
        requests["by_class"][klass] = requests["by_class"].get(klass, 0) + int(count)
    if other.get("latency_ms"):
        histogram_merge(into["latency_ms"], other["latency_ms"])
    for stage, histogram in (other.get("stages") or {}).items():
        histogram_merge(into["stages"].setdefault(stage, new_histogram()), histogram)
    for machine, counts in (other.get("machines") or {}).items():
        mine = into["machines"].setdefault(machine, {"requests": 0, "errors": 0})
        mine["requests"] += int(counts.get("requests", 0))
        mine["errors"] += int(counts.get("errors", 0))
    build = into["build"]
    other_build = other.get("build") or {}
    build["device_programs"] += int(other_build.get("device_programs", 0))
    build["compiles"] += int(other_build.get("compiles", 0))
    for phase, count in (other_build.get("phases") or {}).items():
        build["phases"][phase] = build["phases"].get(phase, 0) + int(count)
    stream = into.setdefault("stream", _empty_stream_section())
    other_stream = other.get("stream")
    if other_stream:
        for key in _STREAM_COUNTS:
            stream[key] += int(other_stream.get(key, 0))
        for key in ("flush_ms", "lag_ms"):
            if other_stream.get(key):
                histogram_merge(stream[key], other_stream[key])
    into["spans"] = int(into.get("spans", 0)) + int(other.get("spans", 0))
    return into


def _fold_span(rollup: Dict[str, Any], kind: str, span: Dict[str, Any]) -> None:
    """One span into one window's rollup."""
    rollup["spans"] += 1
    name = span.get("name", "")
    duration_ms = float(span.get("duration_ms", 0.0) or 0.0)
    attributes = span.get("attributes") or {}
    if kind == "build":
        build = rollup["build"]
        if name == "device_program":
            build["device_programs"] += 1
            if attributes.get("compile"):
                build["compiles"] += 1
        elif name == "build_phase":
            phase = str(attributes.get("phase", "?"))
            build["phases"][phase] = build["phases"].get(phase, 0) + 1
        return
    if span.get("kind") == "event":
        return
    if name in ("stream_ingest", "stream_score"):
        _fold_stream_span(rollup, name, attributes, duration_ms)
    elif name == "request":
        requests = rollup["requests"]
        requests["count"] += 1
        try:
            status = int(attributes.get("http.status_code", 0))
        except (TypeError, ValueError):
            status = 0
        klass = f"{status // 100}xx" if 200 <= status < 600 else "2xx"
        requests["by_class"][klass] = requests["by_class"].get(klass, 0) + 1
        error = status >= 500
        requests["errors"] += error
        histogram_add(rollup["latency_ms"], duration_ms)
        machine = str(attributes.get("gordo_name") or "")
        if machine:
            record = rollup["machines"].setdefault(machine, {"requests": 0, "errors": 0})
            record["requests"] += 1
            record["errors"] += error
    elif name not in _NON_STAGE_NAMES and span.get("parent_id"):
        histogram_add(rollup["stages"].setdefault(name, new_histogram()), duration_ms)


def _fold_stream_span(rollup: Dict[str, Any], name: str, attributes: Dict[str, Any], duration_ms: float) -> None:
    """A ``stream_ingest`` adds its rows; a ``stream_score`` (one a flush)
    its scored, failed and shed rows, its duration and its ``lag_hist``
    (already in :data:`LATENCY_BUCKETS_MS`, so added slot by slot)."""
    stream = rollup.setdefault("stream", _empty_stream_section())
    if name == "stream_ingest":
        stream["rows_in"] += int(attributes.get("rows", 0) or 0)
        return
    stream["flushes"] += 1
    stream["windows"] += int(attributes.get("windows", 0) or 0)
    scored = attributes.get("rows_scored")
    if scored is None:  # a flush that ended early stamps no split
        scored = attributes.get("rows", 0)
    stream["rows_scored"] += int(scored or 0)
    stream["rows_failed"] += int(attributes.get("rows_failed", 0) or 0)
    stream["rows_shed"] += int(attributes.get("shed", 0) or 0)
    histogram_add(stream["flush_ms"], duration_ms)
    lag = stream["lag_ms"]
    counts = attributes.get("lag_hist")
    if isinstance(counts, (list, tuple)) and len(counts) == len(lag["counts"]):
        folded = 0
        for i, count in enumerate(counts):
            count = int(count or 0)
            lag["counts"][i] += count
            folded += count
        lag["count"] += folded
        lag["sum_ms"] += float(attributes.get("lag_sum_ms", 0.0) or 0.0)


class RollupStore:
    """The incremental reducer and the rollups of one directory.

    Thread-safe by instance (:func:`store_for` hands out one a directory);
    two processes aggregating one directory write atomically, but may
    both fold the same new spans (last writer wins by window)."""

    def __init__(self, directory: str):
        self.directory = os.path.normpath(directory)
        self.rollup_dir = os.path.join(self.directory, ROLLUP_DIR)
        self.state_path = os.path.join(self.rollup_dir, ROLLUP_STATE_FILE)
        self.manifest_path = os.path.join(self.rollup_dir, ROLLUP_MANIFEST_FILE)
        self.seconds = window_seconds()
        #: the manifest this store last wrote (readers of other processes load the file)
        self._manifest: Optional[Dict[str, Any]] = None
        self._lock = threading.Lock()
        #: bumped when a rollup file changes: the merge cache's key
        self._version = 0
        self._merged_cache: Dict[Tuple[Any, Any, int], Dict[str, Any]] = {}

    def window_start(self, ts: float) -> int:
        return int(ts // self.seconds) * self.seconds

    def rollup_path(self, start: int) -> str:
        return os.path.join(self.rollup_dir, f"{int(start)}.json")

    # -- aggregation --------------------------------------------------------

    def aggregate(self) -> Dict[str, Any]:
        """Fold every unread span of the directory's sinks into the window
        rollups; returns ``spans_read``, ``files_visited``,
        ``windows_updated``, ``rollups_pruned`` and ``worker_sinks_pruned``."""
        with self._lock:
            return self._aggregate_locked()

    def _aggregate_locked(self) -> Dict[str, Any]:
        os.makedirs(self.rollup_dir, exist_ok=True)
        state = read_json(self.state_path)
        previous: Dict[str, Dict[str, Any]] = dict(state.get("files") or {}) if isinstance(state, dict) else {}
        files: Dict[str, Dict[str, Any]] = {}
        seen_ids: set = set()
        windows: Dict[int, Dict[str, Any]] = {}
        spans_read = visited = 0
        for kind, path in discover_sinks(self.directory):
            result = self._read_file(kind, path, previous, files, seen_ids, windows)
            if result is None:
                continue
            visited += 1
            signature, read = result
            spans_read += read["spans"]
            files[signature] = {"offset": read["offset"], "path": path, "complete": bool(read["eof"])}
            for key in ("min_ts", "max_ts"):
                if read[key] is not None:
                    files[signature][key] = read[key]
        # a file not seen this pass (hidden by a rotation's rename) keeps its
        # offset for 8 passes: forgetting it would read its bytes twice
        for signature, entry in previous.items():
            if signature not in files:
                misses = int(entry.get("misses", 0)) + 1
                if misses <= 8:
                    files[signature] = {**entry, "misses": misses}
        # windows before offsets: a crash between the two folds the tail again
        # (at least once), where the other order would drop it
        persisted = self._persist_windows(windows)
        pruned = self._prune()
        sinks_pruned = self._prune_dead_worker_sinks(files)
        if persisted or pruned:
            self._version += 1
            self._merged_cache.clear()
        self._update_manifest(persisted, pruned, files)
        write_json(self.state_path, {"version": 1, "seconds": self.seconds, "files": files})
        return {"spans_read": spans_read, "files_visited": visited, "windows_updated": sorted(persisted),
                "rollups_pruned": len(pruned), "worker_sinks_pruned": sinks_pruned}

    def _prune_dead_worker_sinks(self, files: Dict[str, Dict[str, Any]]) -> int:
        """Delete the sinks of a dead worker once every byte is folded and
        nothing has written them for :data:`SINK_GC_AGE_S`; never this
        process's, never a health snapshot."""
        consumed_to = {entry["path"]: int(entry.get("offset", 0)) for entry in files.values() if entry.get("path")}
        now = time.time()
        removed = 0
        for base_name in (SERVE_TRACE_FILE, BUILD_TRACE_FILE):
            for base in sink_bases(self.directory, base_name):
                pid = _worker_pid(os.path.basename(base), base_name)
                if pid is None or pid == os.getpid() or _pid_alive(pid):
                    continue
                chain = generation_files(base)
                removable = True
                for path in chain:
                    try:
                        stat = os.stat(path)
                    except OSError:
                        continue
                    if stat.st_size > consumed_to.get(path, 0) or now - stat.st_mtime < SINK_GC_AGE_S:
                        removable = False
                        break
                if not removable:
                    continue
                for path in chain:
                    try:
                        os.remove(path)
                        removed += 1
                    except OSError:
                        pass
        return removed

    def _read_file(self, kind: str, path: str, previous: Dict[str, Dict[str, Any]],
                   files: Dict[str, Dict[str, Any]], seen_ids: set,
                   windows: Dict[int, Dict[str, Any]]) -> Optional[Tuple[str, Dict[str, Any]]]:
        """Open ``path`` once, take its signature from that descriptor (a
        rename cannot swap another file under the offset), resume at the
        signature's offset and fold each complete new line. ``(signature,
        {spans, offset, eof, min_ts, max_ts})``, or None when the file is
        gone or its first line is incomplete."""
        try:
            handle = open(path, "rb")
        except OSError:
            return None
        with handle:
            head = handle.read(256)
            if not head:
                return "empty", {"spans": 0, "offset": 0, "eof": True, "min_ts": None, "max_ts": None}
            signature = _signature_from_head(head)
            if signature is None:
                return None
            entry = previous.get(signature) or files.get(signature) or {}
            offset = int(entry.get("offset", 0))
            # the sink's span-time window, carried across passes
            min_ts, max_ts = entry.get("min_ts"), entry.get("max_ts")
            spans = 0
            position = offset
            eof = True
            try:
                size = os.fstat(handle.fileno()).st_size
                if size > offset:
                    handle.seek(offset)
                    # positions counted by hand: a tell() a line cost 40% of a pass
                    while True:
                        line = handle.readline()
                        if not line:
                            break
                        if not line.endswith(b"\n"):
                            # a torn tail being appended: read it again next pass
                            eof = False
                            break
                        position += len(line)
                        text = line.strip()
                        if not text:
                            continue
                        try:
                            span = json.loads(text.decode("utf-8", "replace"))
                        except ValueError:
                            continue
                        if not isinstance(span, dict) or "name" not in span:
                            continue
                        ts = parse_span_time(span.get("end_time"))
                        if ts is not None:  # duplicates count toward the sink's window
                            min_ts = ts if min_ts is None or ts < min_ts else min_ts
                            max_ts = ts if max_ts is None or ts > max_ts else max_ts
                        context = span.get("context") or {}
                        span_key = (context.get("trace_id", ""), context.get("span_id", ""))
                        if span_key != ("", ""):
                            if span_key in seen_ids:
                                continue
                            seen_ids.add(span_key)
                        if ts is None:
                            continue
                        start = self.window_start(ts)
                        rollup = windows.get(start)
                        if rollup is None:
                            rollup = windows[start] = _empty_rollup(start, self.seconds)
                        _fold_span(rollup, kind, span)
                        spans += 1
                else:
                    position = offset
            except OSError:
                position, eof = offset, False
            return signature, {"spans": spans, "offset": position, "eof": eof, "min_ts": min_ts, "max_ts": max_ts}

    def _persist_windows(self, windows: Dict[int, Dict[str, Any]]) -> Dict[int, Dict[str, Any]]:
        persisted: Dict[int, Dict[str, Any]] = {}
        for start, delta in windows.items():
            path = self.rollup_path(start)
            existing = read_json(path)
            doc = merge_rollups(existing, delta) if isinstance(existing, dict) and existing.get("window") else delta
            write_json(path, doc)
            persisted[start] = doc
        return persisted

    def _prune(self) -> List[int]:
        try:
            entries = _rollup_files(self.rollup_dir)
        except OSError:
            return []
        removed = []
        for entry in entries[:-ROLLUP_KEEP] if len(entries) > ROLLUP_KEEP else []:
            try:
                os.remove(os.path.join(self.rollup_dir, entry))
            except OSError:
                continue
            removed.append(int(entry[: -len(".json")]))
        return removed

    def _update_manifest(self, persisted: Dict[int, Dict[str, Any]], pruned: List[int],
                         files: Dict[str, Dict[str, Any]]) -> None:
        """This pass's windows into ``manifest.json`` (each window's file
        and request counts) with each sink's span-time window; rebuilt from
        the directory listing when missing or of another window length."""
        manifest = self._manifest if self._manifest is not None else read_json(self.manifest_path)
        if (isinstance(manifest, dict) and isinstance(manifest.get("windows"), dict)
                and int(manifest.get("seconds") or 0) == self.seconds):
            window_map = dict(manifest["windows"])
        else:
            try:
                window_map = {e[: -len(".json")]: {"file": e} for e in os.listdir(self.rollup_dir)
                              if e.endswith(".json") and e[: -len(".json")].isdigit()}
            except OSError:
                window_map = {}
        for start, doc in persisted.items():
            requests = doc.get("requests") or {}
            window_map[str(int(start))] = {"file": f"{int(start)}.json", "requests": int(requests.get("count") or 0),
                                           "errors": int(requests.get("errors") or 0)}
        for start in pruned:
            window_map.pop(str(int(start)), None)
        sinks = {os.path.basename(entry["path"]): {"min_ts": entry.get("min_ts"), "max_ts": entry.get("max_ts"),
                                                   "complete": bool(entry.get("complete"))}
                 for entry in files.values() if entry.get("path") and entry.get("max_ts") is not None}
        doc = {"version": 1, "seconds": self.seconds, "updated_at": time.time(), "windows": window_map,
               "sinks": sinks}
        try:
            write_json(self.manifest_path, doc)
        except OSError as exc:
            logger.debug("rollup manifest not written: %r", exc)
            return
        self._manifest = doc

    # -- reading back -------------------------------------------------------

    def _manifest_windows(self) -> Optional[List[int]]:
        """The manifest's window starts, sorted; None without a usable
        manifest (the reader then lists the directory)."""
        doc = self._manifest if self._manifest is not None else read_json(self.manifest_path)
        if (not isinstance(doc, dict) or not isinstance(doc.get("windows"), dict)
                or int(doc.get("seconds") or 0) != self.seconds):
            return None
        try:
            return sorted(int(start) for start in doc["windows"])
        except (TypeError, ValueError):
            return None

    def windows(self, since: Optional[float] = None, until: Optional[float] = None) -> Iterator[Dict[str, Any]]:
        """The rollups whose window overlaps [since, until], oldest first;
        only those files are opened."""
        starts = self._manifest_windows()
        if starts is None:
            try:
                starts = sorted(int(e[: -len(".json")]) for e in _rollup_files(self.rollup_dir))
            except OSError:
                return
        for start in starts:
            if since is not None and start + self.seconds <= since:
                continue
            if until is not None and start >= until:
                continue
            doc = read_json(self.rollup_path(start))
            if isinstance(doc, dict) and doc.get("window"):
                yield doc

    def merged(self, since: Optional[float] = None, until: Optional[float] = None) -> Dict[str, Any]:
        """One rollup of every window in [since, until], the SLO engine's
        unit; cached by the bounds on the window grid and the corpus
        version."""
        key = (self.window_start(since) if since is not None else None,
               self.window_start(until) if until is not None else None, self._version)
        cached = self._merged_cache.get(key)
        if cached is not None:
            return json.loads(json.dumps(cached))
        merged = _empty_rollup(int(since or 0), self.seconds)
        count = 0
        for rollup in self.windows(since=since, until=until):
            merge_rollups(merged, rollup)
            count += 1
        merged["window"]["merged_windows"] = count
        if since is not None:
            merged["window"]["since"] = int(since)
        if until is not None:
            merged["window"]["until"] = int(until)
        copied = json.loads(json.dumps(merged))
        with self._lock:  # against a fold's invalidation
            if len(self._merged_cache) > 64:
                self._merged_cache.clear()
            self._merged_cache[key] = copied
        return merged


_stores_lock = threading.Lock()
_stores: Dict[Tuple[str, int], RollupStore] = {}


def store_for(directory: str) -> RollupStore:
    """The one :class:`RollupStore` of a directory (and window length) in
    this process: its lock keeps two evaluations from folding the same
    spans twice."""
    key = (os.path.normpath(directory), window_seconds())
    with _stores_lock:
        store = _stores.get(key)
        if store is None:
            store = _stores[key] = RollupStore(key[0])
    return store


def summarize_rollup(rollup: Dict[str, Any]) -> Dict[str, Any]:
    """A (merged) rollup's headline: requests, errors, latency
    percentiles, each stage's p50 and p95, each machine's error rate, the
    stream's rows and lag."""
    requests = rollup.get("requests") or {}
    count = int(requests.get("count", 0))
    errors = int(requests.get("errors", 0))
    latency = rollup.get("latency_ms") or new_histogram()
    stream = rollup.get("stream") or _empty_stream_section()
    flush = stream.get("flush_ms") or new_histogram()
    lag = stream.get("lag_ms") or new_histogram()
    return {
        "requests": count,
        "errors": errors,
        "error_rate": round(errors / count, 6) if count else 0.0,
        "latency_p50_ms": histogram_percentile(latency, 0.50),
        "latency_p95_ms": histogram_percentile(latency, 0.95),
        "latency_p99_ms": histogram_percentile(latency, 0.99),
        "stages": {name: {"count": histogram.get("count", 0), "p50_ms": histogram_percentile(histogram, 0.50),
                          "p95_ms": histogram_percentile(histogram, 0.95)}
                   for name, histogram in sorted((rollup.get("stages") or {}).items())},
        "machines": {name: {**counts, "error_rate": round(counts.get("errors", 0) / counts["requests"], 6)
                            if counts.get("requests") else 0.0}
                     for name, counts in sorted((rollup.get("machines") or {}).items())},
        "build": rollup.get("build"),
        "stream": {**{key: int(stream.get(key, 0)) for key in _STREAM_COUNTS},
                   "flush_p50_ms": histogram_percentile(flush, 0.50),
                   "flush_p95_ms": histogram_percentile(flush, 0.95),
                   "lag_p50_ms": histogram_percentile(lag, 0.50),
                   "lag_p95_ms": histogram_percentile(lag, 0.95)},
        "spans": rollup.get("spans", 0),
    }
