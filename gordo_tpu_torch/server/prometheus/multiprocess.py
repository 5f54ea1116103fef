"""
The part of ``prometheus_client`` 0.25's multi-process mode that the
port's server uses, written out: how the workers of ``run-server``'s
pre-fork master (``server/prefork.py``) count into files that one scrape
of the master fans in, as ``PROMETHEUS_MULTIPROC_DIR`` does for the JAX
server's gunicorn workers.

- **The files.** One a process and kind in the directory:
  ``counter_<pid>.db``, ``histogram_<pid>.db``, ``gauge_<mode>_<pid>.db``.
  Each is an mmap'd dict of doubles in ``prometheus_client/mmap_dict.py``'s
  format: a 4-byte ``used`` count and 4 bytes of padding, then entries of
  a 4-byte length, the UTF-8 JSON key (``[metric, sample, labels, help]``,
  keys sorted) padded to 8 bytes, and value and timestamp as two doubles.
  An entry's bytes are written before ``used`` grows over them, so a
  reader never sees half an entry. Each process writes only its own
  files, under one lock of the process.
- **The values** (:class:`MmapedValue`): the registry's values while the
  directory is set (``registry.make_value``), read from and written to
  the file of the process that holds them. A forked process opens files
  of its own pid on its first write, so it counts from 0 and never writes
  into its parent's.
- **The fan-in** (:class:`MultiProcessCollector`): every file of the
  directory merged as ``prometheus_client.multiprocess`` merges them:
  counters and histograms summed over processes, a histogram's buckets
  made cumulative with its ``_count``; gauges by their mode (``max``,
  ``min``, ``sum``, ``mostrecent``, ``all`` with a ``pid`` label, and the
  ``live`` forms of each). No ``_created`` sample is kept.
- **Dead workers** (:func:`mark_process_dead`): a dead process's
  ``gauge_live*_<pid>.db`` files are removed; its counters and histograms
  stay counted, as counters must.
"""

import glob
import json
import mmap
import os
import struct
import threading
import time
from collections import defaultdict
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

from ...utils.postfork import register_postfork_reset
from .registry import CollectorRegistry, Metric, Sample, float_to_go_string

#: the directory's environment variable, in either spelling
MULTIPROC_ENV = ("PROMETHEUS_MULTIPROC_DIR", "prometheus_multiproc_dir")
#: a gauge's modes (``prometheus_client.Gauge._MULTIPROC_MODES``)
GAUGE_MODES = ("all", "liveall", "min", "livemin", "max", "livemax", "sum", "livesum", "mostrecent",
               "livemostrecent")
_LIVE_MODES = tuple(mode for mode in GAUGE_MODES if mode.startswith("live"))

_INITIAL_SIZE = 1 << 16
_INT = struct.Struct("i")
_TWO_DOUBLES = struct.Struct("dd")


def multiprocess_dir() -> Optional[str]:
    """The directory of the multi-process exposition, or None when neither
    spelling of ``PROMETHEUS_MULTIPROC_DIR`` is set."""
    for name in MULTIPROC_ENV:
        value = os.environ.get(name)
        if value:
            return value
    return None


def mmap_key(metric_name: str, name: str, labelnames: Sequence[str], labelvalues: Sequence[str],
             help_text: str) -> str:
    """An entry's key: ``prometheus_client.mmap_dict.mmap_key``."""
    return json.dumps([metric_name, name, dict(zip(labelnames, labelvalues)), help_text], sort_keys=True)


def _entries(data: Any, used: int) -> Iterator[Tuple[str, float, float, int]]:
    """``(key, value, timestamp, position of the value)`` of each entry
    below ``used``."""
    pos = 8
    while pos < used:
        length = _INT.unpack_from(data, pos)[0]
        if length + pos > used:
            raise RuntimeError("Read beyond file size detected, file is corrupted.")
        pos += 4
        key = bytes(data[pos:pos + length]).decode("utf-8")
        pos += length + (8 - (length + 4) % 8)
        value, timestamp = _TWO_DOUBLES.unpack_from(data, pos)
        yield key, value, timestamp, pos
        pos += 16


def read_file(path: str) -> List[Tuple[str, float, float]]:
    """Every ``(key, value, timestamp)`` of one file, read without a map
    (the reader of another process's file)."""
    with open(path, "rb") as f:
        data = f.read(mmap.PAGESIZE)
        used = _INT.unpack_from(data, 0)[0] if len(data) >= 4 else 0
        if used > len(data):
            data += f.read(used - len(data))
    return [(key, value, timestamp) for key, value, timestamp, _ in _entries(data, used)]


class MmapedDict:
    """The doubles of one process's file, mapped for writing. Not
    thread-safe: :class:`MmapedValue` holds the process's lock."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "a+b")
        capacity = os.fstat(self._f.fileno()).st_size
        if capacity == 0:
            self._f.truncate(_INITIAL_SIZE)
            capacity = _INITIAL_SIZE
        self._capacity = capacity
        self._m = mmap.mmap(self._f.fileno(), capacity, access=mmap.ACCESS_WRITE)
        self._positions: Dict[str, int] = {}
        self._used = _INT.unpack_from(self._m, 0)[0]
        if self._used == 0:
            self._used = 8
            self._m[0:4] = _INT.pack(self._used)
        else:
            for key, _, _, pos in _entries(self._m, self._used):
                self._positions[key] = pos

    def _init_value(self, key: str) -> None:
        encoded = key.encode("utf-8")
        padded = encoded + b" " * (8 - (len(encoded) + 4) % 8)
        entry = struct.pack(f"i{len(padded)}sdd", len(encoded), padded, 0.0, 0.0)
        while self._used + len(entry) > self._capacity:
            self._capacity *= 2
            self._f.truncate(self._capacity)
            self._m.close()
            self._m = mmap.mmap(self._f.fileno(), self._capacity, access=mmap.ACCESS_WRITE)
        self._m[self._used:self._used + len(entry)] = entry
        # the entry's bytes first, then the count that makes readers see them
        self._used += len(entry)
        self._m[0:4] = _INT.pack(self._used)
        self._positions[key] = self._used - 16

    def read_value(self, key: str) -> Tuple[float, float]:
        if key not in self._positions:
            self._init_value(key)
        return _TWO_DOUBLES.unpack_from(self._m, self._positions[key])

    def write_value(self, key: str, value: float, timestamp: float) -> None:
        if key not in self._positions:
            self._init_value(key)
        pos = self._positions[key]
        # one slice assignment: struct.pack_into would write zeros first
        self._m[pos:pos + 16] = _TWO_DOUBLES.pack(value, timestamp)

    def close(self) -> None:
        if self._f is not None:
            self._m.close()
            self._f.close()
            self._f = None


_lock = threading.Lock()
#: the files of the process that opened them: (pid, {(directory, file prefix): MmapedDict})
_files: Tuple[int, Dict[Tuple[str, str], MmapedDict]] = (-1, {})


def _file(prefix: str, directory: str) -> MmapedDict:
    """This process's file of ``prefix`` (``counter``, ``gauge_max``, ...)
    in ``directory``; the caller holds the lock."""
    global _files
    pid, files = _files
    if pid != os.getpid():
        # made in another process (a fork without the reset): never write into its files
        _files = pid, files = os.getpid(), {}
    found = files.get((directory, prefix))
    if found is None:
        found = files[(directory, prefix)] = MmapedDict(os.path.join(directory, f"{prefix}_{pid}.db"))
    return found


def _reset_after_fork() -> None:
    """A forked worker opens files of its own pid; the inherited maps are
    dropped, not closed, and the lock is rebound, never taken."""
    global _lock, _files
    _lock = threading.Lock()
    _files = (-1, {})


register_postfork_reset(_reset_after_fork, name="server.prometheus.multiprocess.files")


class MmapedValue:
    """One sample's number in this process's file of its kind: the
    registry's value while the directory is set."""

    __slots__ = ("_prefix", "_directory", "_key", "_most_recent")

    def __init__(self, typ: str, metric_name: str, name: str, labelnames: Sequence[str],
                 labelvalues: Sequence[str], help_text: str, multiprocess_mode: str = "",
                 directory: Optional[str] = None):
        self._directory = directory or multiprocess_dir()
        if not self._directory:
            raise ValueError("PROMETHEUS_MULTIPROC_DIR is not set")
        self._prefix = f"{typ}_{multiprocess_mode}" if typ == "gauge" else typ
        self._key = mmap_key(metric_name, name, labelnames, labelvalues, help_text)
        self._most_recent = multiprocess_mode in ("mostrecent", "livemostrecent")
        with _lock:
            _file(self._prefix, self._directory).read_value(self._key)

    def add(self, amount: float) -> None:
        with _lock:
            f = _file(self._prefix, self._directory)
            f.write_value(self._key, f.read_value(self._key)[0] + amount, 0.0)

    def set(self, value: float) -> None:
        with _lock:
            _file(self._prefix, self._directory).write_value(
                self._key, value, time.time() if self._most_recent else 0.0)

    def get(self) -> float:
        with _lock:
            return _file(self._prefix, self._directory).read_value(self._key)[0]


def _merge(paths: Sequence[str]) -> List[Metric]:
    """The files' metrics merged across processes:
    ``prometheus_client.multiprocess.MultiProcessCollector.merge`` with
    ``accumulate=True``."""
    metrics: Dict[str, Metric] = {}
    modes: Dict[str, str] = {}
    raw: Dict[str, list] = {}
    parsed: Dict[str, tuple] = {}
    for path in paths:
        parts = os.path.basename(path).split("_")
        typ = parts[0]
        try:
            values = read_file(path)
        except FileNotFoundError:
            if typ == "gauge" and parts[1].startswith("live"):
                continue  # removed by mark_process_dead between the glob and the read
            raise
        for key, value, timestamp in values:
            found = parsed.get(key)
            if found is None:
                metric_name, name, labels, help_text = json.loads(key)
                found = parsed[key] = (metric_name, name, tuple(sorted(labels.items())), help_text)
            metric_name, name, labels_key, help_text = found
            if metric_name not in metrics:
                metrics[metric_name] = Metric(metric_name, help_text, typ)
                raw[metric_name] = []
            if typ == "gauge":
                modes[metric_name] = parts[1]
                labels_key = labels_key + (("pid", parts[2][:-3]),)
            raw[metric_name].append((name, labels_key, value, timestamp))
    for metric_name, metric in metrics.items():
        mode = modes.get(metric_name, "")
        samples: Dict[tuple, Dict[tuple, float]] = defaultdict(dict)
        stamps: Dict[tuple, Dict[str, float]] = defaultdict(dict)
        buckets: Dict[tuple, Dict[float, float]] = defaultdict(lambda: defaultdict(float))
        for name, labels, value, timestamp in raw[metric_name]:
            if metric.type == "gauge":
                if mode not in ("all", "liveall"):
                    labels = tuple(label for label in labels if label[0] != "pid")
                bucket = samples[labels]
                if mode in ("min", "livemin"):
                    bucket[(name, labels)] = min(bucket.get((name, labels), value), value)
                elif mode in ("max", "livemax"):
                    bucket[(name, labels)] = max(bucket.get((name, labels), value), value)
                elif mode in ("sum", "livesum"):
                    bucket[(name, labels)] = bucket.get((name, labels), 0.0) + value
                elif mode in ("mostrecent", "livemostrecent"):
                    timestamp = float(timestamp or 0)
                    if stamps[labels].get(name, 0.0) < timestamp:
                        bucket[(name, labels)] = value
                        stamps[labels][name] = timestamp
                else:
                    bucket[(name, labels)] = value
            elif metric.type == "histogram":
                for label in labels:
                    if label[0] == "le":
                        without_le = tuple(other for other in labels if other[0] != "le")
                        buckets[without_le][float(label[1])] += value
                        break
                else:  # _sum
                    samples[labels][(name, labels)] = samples[labels].get((name, labels), 0.0) + value
            else:
                samples[labels][(name, labels)] = samples[labels].get((name, labels), 0.0) + value
        if metric.type == "histogram":
            for labels, values in buckets.items():
                acc = 0.0
                for bound, value in sorted(values.items()):
                    acc += value
                    samples[labels][(metric_name + "_bucket", labels + (("le", float_to_go_string(bound)),))] = acc
                samples[labels][(metric_name + "_count", labels)] = acc
        metric.samples = [Sample(name, dict(labels), value)
                          for by_labels in samples.values() for (name, labels), value in by_labels.items()]
    return list(metrics.values())


class MultiProcessCollector:
    """The fan-in of a directory's files (default: the
    ``PROMETHEUS_MULTIPROC_DIR``), registered on ``registry`` when one is
    given. Its files are read in name order."""

    def __init__(self, registry: Optional[CollectorRegistry] = None, path: Optional[str] = None):
        path = path or multiprocess_dir()
        if not path or not os.path.isdir(path):
            raise ValueError("env PROMETHEUS_MULTIPROC_DIR is not set or not a directory")
        self._path = path
        if registry is not None:
            registry.register(self)

    def collect(self) -> List[Metric]:
        return _merge(sorted(glob.glob(os.path.join(self._path, "*.db"))))


def mark_process_dead(pid: int, path: Optional[str] = None) -> List[str]:
    """Remove a dead process's ``live`` gauge files (its other files stay:
    what it counted stays counted); the paths removed."""
    path = path or multiprocess_dir()
    removed = []
    if not path:
        return removed
    for mode in _LIVE_MODES:
        for found in glob.glob(os.path.join(path, f"gauge_{mode}_{pid}.db")):
            try:
                os.remove(found)
                removed.append(found)
            except FileNotFoundError:
                pass
    return removed
