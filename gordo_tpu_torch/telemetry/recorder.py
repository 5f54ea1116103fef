"""
The span recorder, a copy of ``gordo_tpu/telemetry/recorder.py``.

A recorder records named spans (wall-clock intervals with attributes)
and point events, each a dict of the JAX package's keys (``name``,
``context``, ``parent_id``, ``kind``, ``start_time``, ``end_time``,
``duration_ms``, ``status``, ``attributes``, ``links`` when it has any,
``resource``), shaped like OpenTelemetry spans. A recorder with a sink
appends every finished span to a JSONL file; a sink past
``GORDO_TPU_TELEMETRY_MAX_BYTES`` (default 256 MiB; 0: never) rotates to
``<path>.1`` .. ``<path>.<keep>`` (``GORDO_TPU_TELEMETRY_KEEP``, default
3). A recorder without one keeps its spans in memory (:meth:`finished`,
:meth:`durations`).

Two users:

- a fleet build installs its recorder process-wide with :func:`activate`,
  so the trainer's device programs record without a recorder argument;
  :func:`get_recorder` answers :data:`NULL_RECORDER` outside a build. Its
  sink is synchronous: each span is on disk the moment it closes, so a
  killed build leaves the trace of what happened.
- the server (``telemetry/serving.py``): each request has an in-memory
  recorder that adopts the request's W3C trace id and parents its stage
  spans on the request's span (``default_parent_id``); the finished
  request goes into one process-shared recorder with an **asynchronous**
  sink, ``serve_trace.jsonl``: recording threads append to a bounded
  queue (20,000 entries, oldest shed first) and a writer thread writes it
  in batches, polling every 50 ms while spans flow and backing off to 1 s
  when idle (:meth:`SpanRecorder.emit_deferred` moves even the building
  of span dicts onto that thread). :meth:`SpanRecorder.flush` blocks until
  what was recorded is on disk; :meth:`SpanRecorder.close` stops the
  writer and loses nothing. Before each write the sink checks that its
  file is still the one at its path (another process may have rotated or
  removed it) and reopens it if not. Under ``run-server``'s workers
  (``server/prefork.py``) each process writes sinks of its own,
  ``<stem>-<pid><ext>`` (:func:`worker_sink_path`: on exactly when
  ``PROMETHEUS_MULTIPROC_DIR`` is set, unless ``GORDO_TPU_WORKER_SINKS``
  says otherwise), which every reader merges (:func:`is_worker_variant`).

Spans link to spans of other traces (:meth:`SpanHandle.link`): the
engine's batch span to the requests it coalesced, a stream flush to the
ingests it drained. :meth:`SpanRecorder.record` records an interval
timed on another thread's clock (a request's share of a batch).

Compile attribution (:func:`program_span`): the first call of a
``(program, key)`` in the process is ``compile=True``, every later one
``compile=False``, with JAX's key (spec, fit config, shapes), so the
counts of each kind equal the JAX build's on one config. On a card a
first call compiles nothing: the port's programs are eager PyTorch and a
kernel built once by ``ops/_build.py``. What a ``compile=True`` span pays
there is the first launch of its shapes: cuBLAS handles and workspaces,
the caching allocator's first blocks, and, in the first ``fleet_predict``
of a process, the loading of K1's library when an earlier call has not
loaded it.
"""


import collections
import contextlib
import datetime
import json
import os
import random
import threading
import time
from typing import Any, Callable, Dict, Hashable, List, Optional

from ..utils.env import env_bool, env_int
from ..utils.postfork import register_postfork_reset

TELEMETRY_ENV = "GORDO_TPU_TELEMETRY"
TRACE_DIR_ENV = "GORDO_TPU_TELEMETRY_DIR"
MAX_BYTES_ENV = "GORDO_TPU_TELEMETRY_MAX_BYTES"
KEEP_ENV = "GORDO_TPU_TELEMETRY_KEEP"
DEFAULT_MAX_BYTES = 256 * 1024 * 1024
DEFAULT_KEEP = 3
#: the asynchronous sink's queue bound, and the backlog that wakes the writer early
_QUEUE_MAX = 20000
_WAKE_BACKLOG = 2048


#: per-process sinks: when on, the sinks a process owns (``serve_trace.jsonl``,
#: ``fleet_health.json``) get a ``-<pid>`` suffix, so that the workers of a
#: pre-fork server do not overwrite one shared path; the readers merge every
#: variant. Default: on exactly when ``PROMETHEUS_MULTIPROC_DIR`` (either
#: spelling) is set, the multi-worker deployment's own signal.
WORKER_SINKS_ENV = "GORDO_TPU_WORKER_SINKS"


def worker_sinks_enabled() -> bool:
    """Whether this process's sinks carry its pid (``GORDO_TPU_WORKER_SINKS``,
    default: whether a multi-process metrics directory is set)."""
    multi_worker = bool(os.environ.get("PROMETHEUS_MULTIPROC_DIR") or os.environ.get("prometheus_multiproc_dir"))
    return env_bool(WORKER_SINKS_ENV, multi_worker)


def worker_sink_path(path: str) -> str:
    """``serve_trace.jsonl`` -> ``serve_trace-<pid>.jsonl`` when worker
    sinks are on (the suffix before the extension, so that rotated
    generations keep their ``.N`` tail)."""
    if not worker_sinks_enabled():
        return path
    stem, ext = os.path.splitext(path)
    return f"{stem}-{os.getpid()}{ext}"


def enabled() -> bool:
    """The telemetry master switch: on unless ``GORDO_TPU_TELEMETRY`` is
    falsy (``0``/``false``/``off``/``no``)."""
    return env_bool(TELEMETRY_ENV, True)


def is_worker_variant(name: str, base_name: str) -> bool:
    """True when ``name`` is a per-worker variant of ``base_name``
    (``serve_trace-<pid>.jsonl`` of ``serve_trace.jsonl``), a copy of
    ``gordo_tpu/telemetry/aggregate.py``'s.

    >>> is_worker_variant("fleet_health-12.json", "fleet_health.json"), is_worker_variant("fleet_health.json", "fleet_health.json")
    (True, False)
    """
    stem, ext = os.path.splitext(base_name)
    return name.startswith(stem + "-") and name.endswith(ext)


def _iso(ts: float) -> str:
    return datetime.datetime.fromtimestamp(ts, datetime.timezone.utc).isoformat()


#: span and trace ids: a PRNG seeded once from the OS (ids need only be unique)
_id_source = random.Random(int.from_bytes(os.urandom(16), "big"))


def _reseed_ids_after_fork() -> None:
    """A forked worker draws its span and trace ids from a source of its
    own: with the parent's state every worker would mint the same ids."""
    global _id_source
    _id_source = random.Random(int.from_bytes(os.urandom(16), "big"))


register_postfork_reset(_reseed_ids_after_fork, name="telemetry.recorder.ids")


def rand_hex(chars: int = 32) -> str:
    """``chars`` lowercase hex characters (32: a trace id, 16: a span id)."""
    return f"{_id_source.getrandbits(chars * 4):0{chars}x}"


class SpanHandle:
    """What a ``with recorder.span(...)`` block receives: attributes set
    mid-span, links to spans of other traces, and the span's own identity
    (empty on the null recorder), which a later span may link back to."""

    __slots__ = ("attributes", "links", "trace_id", "span_id")

    def __init__(self, attributes: Dict[str, Any], trace_id: str = "", span_id: str = ""):
        self.attributes = attributes
        self.links: List[dict] = []
        self.trace_id = trace_id
        self.span_id = span_id

    def set(self, **attributes) -> "SpanHandle":
        self.attributes.update(attributes)
        return self

    def link(self, trace_id: str, span_id: str, **attributes) -> "SpanHandle":
        """A link to a span of another trace (a span context and the
        link's attributes)."""
        self.links.append({"context": {"trace_id": trace_id, "span_id": span_id},
                           **({"attributes": attributes} if attributes else {})})
        return self


class NullRecorder:
    """The recorder that records nothing: the process default."""

    enabled = False
    trace_id = ""
    default_parent_id = None

    @contextlib.contextmanager
    def span(self, name: str, **attributes):
        yield SpanHandle({})

    def event(self, name: str, **attributes) -> None:
        pass

    def record(self, name: str, seconds: float, **attributes) -> None:
        pass

    def emit(self, span: dict) -> None:
        pass

    def flush(self) -> None:
        pass

    def add_listener(self, listener: Callable[[dict], None]) -> None:
        pass

    def finished(self, name: Optional[str] = None) -> List[dict]:
        return []

    def durations(self) -> Dict[str, float]:
        return {}

    def close(self) -> None:
        pass


NULL_RECORDER = NullRecorder()


class SpanRecorder:
    """
    Spans and events in a JSONL sink or, without one, in memory
    (:meth:`finished`). Thread-safe; nesting is tracked per thread, so a
    pool thread's spans are roots of their own (or children of
    ``default_parent_id``). ``trace_id`` joins an existing trace (a
    request's); ``async_sink`` writes the sink from a writer thread.
    """

    enabled = True

    def __init__(self, sink_path: Optional[str] = None, service: str = "gordo-tpu",
                 max_bytes: Optional[int] = None, keep: Optional[int] = None,
                 trace_id: Optional[str] = None, async_sink: bool = False):
        self.trace_id = trace_id or rand_hex(32)
        #: the parent of a span opened with no enclosing span on its thread:
        #: a request's recorder points it at the request's span
        self.default_parent_id: Optional[str] = None
        self.service = service
        self.sink_path = sink_path
        self.async_sink = bool(async_sink) and sink_path is not None
        if sink_path is not None:
            self.max_bytes = max_bytes if max_bytes is not None else max(0, env_int(MAX_BYTES_ENV, DEFAULT_MAX_BYTES))
            self.keep = keep if keep is not None else max(0, env_int(KEEP_ENV, DEFAULT_KEEP))
            self._queue: "collections.deque" = collections.deque(maxlen=_QUEUE_MAX)
            self._wakeup = threading.Event()
            self._write_lock = threading.Lock()
        else:
            self.max_bytes = max_bytes or 0
            self.keep = keep or 0
        self._writer: Optional[threading.Thread] = None
        self._closed = False
        self._sink = None
        self._lock = threading.Lock()
        # a sink-backed recorder keeps nothing in memory: the sink and the
        # listeners are what read its spans
        self.retain_spans = sink_path is None
        self._spans: List[dict] = []
        self._listeners: List[Callable[[dict], None]] = []
        self._local = threading.local()

    # -- recording ----------------------------------------------------------

    def _stack(self) -> List[str]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _parent(self) -> Optional[str]:
        stack = self._stack()
        return stack[-1] if stack else self.default_parent_id

    @contextlib.contextmanager
    def span(self, name: str, **attributes):
        """The enclosed block as one span; an exception marks it ``ERROR``
        (with its repr) and propagates."""
        span_id = rand_hex(16)
        handle = SpanHandle(dict(attributes), self.trace_id, span_id)
        parent_id = self._parent()
        stack = self._stack()
        stack.append(span_id)
        start = time.time()
        error: Optional[BaseException] = None
        try:
            yield handle
        except BaseException as exc:
            error = exc
            raise
        finally:
            stack.pop()
            self._record(self._span_dict(name, span_id, parent_id, start, time.time(), handle.attributes, error,
                                         links=handle.links or None))

    def event(self, name: str, **attributes) -> None:
        """A point in time (zero duration)."""
        now = time.time()
        self._record(self._span_dict(name, rand_hex(16), self._parent(), now, now, dict(attributes), None,
                                     kind="event"))

    def record(self, name: str, seconds: float, **attributes) -> None:
        """An interval timed elsewhere, ``seconds`` long and ending now:
        a request's share of a batch timed on the dispatcher's clock."""
        end = time.time()
        self._record(self._span_dict(name, rand_hex(16), self._parent(), end - max(0.0, seconds), end,
                                     dict(attributes), None))

    def emit(self, span: dict) -> None:
        """A span dict built elsewhere, recorded as it is."""
        self._record(span)

    def emit_deferred(self, build: Callable[[], List[dict]]) -> None:
        """``build()``'s span dicts, built on the writer thread of an
        asynchronous sink (the caller pays one queue append); built and
        recorded now otherwise."""
        if self.async_sink and self.sink_path is not None:
            self._enqueue(build)
            return
        for span in build():
            self._record(span)

    def _span_dict(self, name, span_id, parent_id, start, end, attributes, error, kind="internal",
                   links=None) -> dict:
        return {
            "name": name,
            "context": {"trace_id": self.trace_id, "span_id": span_id},
            "parent_id": parent_id,
            "kind": kind,
            "start_time": _iso(start),
            "end_time": _iso(end),
            "duration_ms": round((end - start) * 1000.0, 3),
            "status": {
                "status_code": "ERROR" if error is not None else "OK",
                **({"description": repr(error)} if error is not None else {}),
            },
            "attributes": attributes,
            **({"links": links} if links else {}),
            "resource": {"service.name": self.service},
        }

    def _enqueue(self, item: Any) -> None:
        # one deque append (atomic under the GIL): the lock-free hand-off
        # to the writer; a full deque sheds its oldest entry
        self._queue.append(item)
        if self._writer is None:
            self._ensure_writer()
        elif len(self._queue) >= _WAKE_BACKLOG:
            self._wakeup.set()

    def _record(self, span: dict) -> None:
        if self.async_sink and self.sink_path is not None:
            self._enqueue(span)
            if not self.retain_spans and not self._listeners:
                return
        with self._lock:
            if self.retain_spans:
                self._spans.append(span)
            if self.sink_path is not None and not self.async_sink:
                self._write_locked([span])
            listeners = list(self._listeners)
        for listener in listeners:
            try:
                listener(span)
            except Exception:  # noqa: BLE001 - listeners are advisory
                pass

    def _write_locked(self, spans: List[dict]) -> None:
        """Append ``spans`` to the sink (reopened if another process
        moved its file) and rotate it past ``max_bytes``; a sink that
        cannot be written is dropped (telemetry never fails its caller)."""
        try:
            self._ensure_sink_linked()
            if self._sink is None:
                self._sink = open(self.sink_path, "a")
            self._sink.write("".join(json.dumps(span, default=str) + "\n" for span in spans))
            self._sink.flush()
            if self.max_bytes and self._sink.tell() >= self.max_bytes:
                self._rotate_locked()
        except OSError:
            self.sink_path = None
            self._sink = None

    def _ensure_sink_linked(self) -> None:
        """Drop a handle whose file is no longer the one at the sink path
        (another process rotated or removed it): appending through it
        would hide every later span. Compared by inode and device, not by
        link count, which overlay file systems keep at 1."""
        if self._sink is None:
            return
        try:
            handle_stat = os.fstat(self._sink.fileno())
            try:
                path_stat = os.stat(self.sink_path)
            except OSError:
                orphaned = True
            else:
                orphaned = path_stat.st_ino != handle_stat.st_ino or path_stat.st_dev != handle_stat.st_dev
            if orphaned:
                self._sink.close()
                self._sink = None
        except OSError:
            self._sink = None

    def _rotate_locked(self) -> None:
        """``p`` -> ``p.1`` -> ... -> ``p.<keep>`` (older ones deleted); the
        next write opens a fresh ``p``."""
        self._sink.close()
        self._sink = None
        if self.keep < 1:
            os.remove(self.sink_path)
            return
        for generation in range(self.keep, 0, -1):
            src = self.sink_path if generation == 1 else f"{self.sink_path}.{generation - 1}"
            if os.path.exists(src):
                os.replace(src, f"{self.sink_path}.{generation}")

    # -- the asynchronous sink ------------------------------------------------

    def _ensure_writer(self) -> None:
        with self._lock:
            if self._writer is None and not self._closed:
                self._writer = threading.Thread(target=self._writer_loop, name="gordo-trace-writer", daemon=True)
                self._writer.start()

    def _writer_loop(self) -> None:
        # the writer polls (50 ms while spans flow, backing off to 1 s when
        # idle): a wake-up from each recording thread would be a syscall a span
        timeout = 0.05
        while True:
            self._wakeup.wait(timeout=timeout)
            self._wakeup.clear()
            if self._queue:
                timeout = 0.05
                self._drain()
            else:
                timeout = min(1.0, timeout * 2)
            if self._closed and not self._queue:
                return

    def _drain(self) -> None:
        """Write everything queued in one write: span dicts, and the spans
        of deferred builders (a builder that raises loses its own spans)."""
        with self._write_lock:
            batch: List[dict] = []
            while True:
                try:
                    item = self._queue.popleft()
                except IndexError:
                    break
                if callable(item):
                    try:
                        batch.extend(item())
                    except Exception:  # noqa: BLE001 - a broken builder loses its spans, never the writer
                        pass
                else:
                    batch.append(item)
            if batch and self.sink_path is not None:
                self._write_locked(batch)

    def flush(self) -> None:
        """Block until everything recorded so far is on disk (a
        synchronous sink always is)."""
        if self.async_sink:
            self._drain()

    # -- reading back ---------------------------------------------------------

    def add_listener(self, listener: Callable[[dict], None]) -> None:
        """``listener(span)`` for every span and event as it finishes."""
        with self._lock:
            self._listeners.append(listener)

    def finished(self, name: Optional[str] = None) -> List[dict]:
        """Retained spans (of ``name``), oldest first."""
        with self._lock:
            spans = list(self._spans)
        return spans if name is None else [s for s in spans if s["name"] == name]

    def durations(self) -> Dict[str, float]:
        """Seconds a span name (events left out), in first-seen order:
        what a response's ``Server-Timing`` lists."""
        totals: Dict[str, float] = {}
        for span in self.finished():
            if span["kind"] != "event":
                totals[span["name"]] = totals.get(span["name"], 0.0) + span["duration_ms"] / 1000.0
        return totals

    def close(self) -> None:
        """Close the sink; an asynchronous one stops its writer and writes
        what is left first."""
        if self.async_sink:
            self._closed = True
            self._wakeup.set()
            writer = self._writer
            if writer is not None:
                writer.join(timeout=2.0)
                with self._lock:
                    self._writer = None
            self._drain()
            with self._write_lock:
                if self._sink is not None:
                    with contextlib.suppress(OSError):
                        self._sink.close()
                    self._sink = None
            return
        with self._lock:
            if self._sink is not None:
                with contextlib.suppress(OSError):
                    self._sink.close()
                self._sink = None


# -- the process-wide recorder ------------------------------------------------

_active: Any = NULL_RECORDER
_active_lock = threading.Lock()


def get_recorder():
    """The active recorder (:data:`NULL_RECORDER` outside a traced build)."""
    return _active


@contextlib.contextmanager
def activate(recorder):
    """Install ``recorder`` process-wide for the enclosed block."""
    global _active
    with _active_lock:
        previous, _active = _active, recorder
    try:
        yield recorder
    finally:
        with _active_lock:
            _active = previous


# -- compile attribution --------------------------------------------------------

_seen_lock = threading.Lock()
_seen_programs: set = set()


def seen_program(key: Hashable) -> bool:
    """Register a program signature; True when this process saw it before."""
    with _seen_lock:
        if key in _seen_programs:
            return True
        _seen_programs.add(key)
        return False


def reset_seen_programs() -> None:
    """Forget every signature (tests)."""
    with _seen_lock:
        _seen_programs.clear()


def program_span(program: str, key: Hashable, **attributes):
    """A ``device_program`` span around one program call, ``compile=True``
    on the first call of ``(program, key)`` in the process. ``key`` is
    the JAX signature: spec, fit config and shapes."""
    from .device import note_program_execution

    compile_flag = not seen_program((program, key))
    note_program_execution(compile_flag, kind="build")
    return get_recorder().span("device_program", program=program, compile=compile_flag, **attributes)
