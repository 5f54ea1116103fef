"""
The span recorder of a fleet build, a copy of
``gordo_tpu/telemetry/recorder.py`` (``:1-675``, ``:677-720``).

A build records named spans (wall-clock intervals with attributes) and
point events, each a dict of the JAX package's keys (``name``,
``context``, ``parent_id``, ``kind``, ``start_time``, ``end_time``,
``duration_ms``, ``status``, ``attributes``, ``resource``), shaped like
OpenTelemetry spans. A recorder with a
sink appends every finished span to a JSONL file the moment it closes,
so a killed build leaves the trace of what happened. A sink past ``GORDO_TPU_TELEMETRY_MAX_BYTES`` (default 256 MiB; 0: never)
rotates to ``<path>.1`` .. ``<path>.<keep>`` (``GORDO_TPU_TELEMETRY_KEEP``,
default 3).

The build installs its recorder process-wide with :func:`activate`, so
the trainer's device programs record without a recorder argument;
:func:`get_recorder` answers :data:`NULL_RECORDER` outside a build, whose
spans record nothing.

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

Not ported: what only the serving recorder uses, with the serving path
(``ROADMAP.md`` item 11b): the asynchronous sink and its writer thread
(``:498-565``), the per-worker sink split of a multi-process server and
its check that another process did not rotate the file (``:60-90``),
a trace id or parent given from outside, and links to spans of other
traces.
"""

import contextlib
import datetime
import json
import os
import random
import threading
import time
from typing import Any, Callable, Dict, Hashable, List, Optional

from ..utils.env import env_bool, env_int

TELEMETRY_ENV = "GORDO_TPU_TELEMETRY"
TRACE_DIR_ENV = "GORDO_TPU_TELEMETRY_DIR"
MAX_BYTES_ENV = "GORDO_TPU_TELEMETRY_MAX_BYTES"
KEEP_ENV = "GORDO_TPU_TELEMETRY_KEEP"
DEFAULT_MAX_BYTES = 256 * 1024 * 1024
DEFAULT_KEEP = 3


def enabled() -> bool:
    """The telemetry master switch: on unless ``GORDO_TPU_TELEMETRY`` is
    falsy (``0``/``false``/``off``/``no``)."""
    return env_bool(TELEMETRY_ENV, True)


def _iso(ts: float) -> str:
    return datetime.datetime.fromtimestamp(ts, datetime.timezone.utc).isoformat()


#: span and trace ids: a PRNG seeded once from the OS (ids need only be unique)
_id_source = random.Random(int.from_bytes(os.urandom(16), "big"))


def rand_hex(chars: int = 32) -> str:
    """``chars`` lowercase hex characters (32: a trace id, 16: a span id)."""
    return f"{_id_source.getrandbits(chars * 4):0{chars}x}"


class SpanHandle:
    """What a ``with recorder.span(...)`` block receives: attributes set
    mid-span."""

    __slots__ = ("attributes",)

    def __init__(self, attributes: Dict[str, Any]):
        self.attributes = attributes

    def set(self, **attributes) -> "SpanHandle":
        self.attributes.update(attributes)
        return self


class NullRecorder:
    """The recorder that records nothing: the process default."""

    enabled = False

    @contextlib.contextmanager
    def span(self, name: str, **attributes):
        yield SpanHandle({})

    def event(self, name: str, **attributes) -> None:
        pass

    def add_listener(self, listener: Callable[[dict], None]) -> None:
        pass

    def finished(self, name: Optional[str] = None) -> List[dict]:
        return []

    def close(self) -> None:
        pass


NULL_RECORDER = NullRecorder()


class SpanRecorder:
    """
    Spans and events in a JSONL sink or, without one, in memory
    (:meth:`finished`). Thread-safe; nesting is tracked per thread, so a
    pool thread's spans are roots of their own.
    """

    enabled = True

    def __init__(self, sink_path: Optional[str] = None, service: str = "gordo-tpu",
                 max_bytes: Optional[int] = None, keep: Optional[int] = None):
        self.trace_id = rand_hex(32)
        self.service = service
        self.sink_path = sink_path
        if sink_path is not None:
            self.max_bytes = max_bytes if max_bytes is not None else max(0, env_int(MAX_BYTES_ENV, DEFAULT_MAX_BYTES))
            self.keep = keep if keep is not None else max(0, env_int(KEEP_ENV, DEFAULT_KEEP))
        else:
            self.max_bytes = max_bytes or 0
            self.keep = keep or 0
        self._sink = None
        self._lock = threading.Lock()
        # a sink-backed build recorder keeps nothing in memory: the sink
        # and the listeners are what read its spans
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
        return stack[-1] if stack else None

    @contextlib.contextmanager
    def span(self, name: str, **attributes):
        """The enclosed block as one span; an exception marks it ``ERROR``
        (with its repr) and propagates."""
        span_id = rand_hex(16)
        handle = SpanHandle(dict(attributes))
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
            self._record(self._span_dict(name, span_id, parent_id, start, time.time(), handle.attributes, error))

    def event(self, name: str, **attributes) -> None:
        """A point in time (zero duration)."""
        now = time.time()
        self._record(self._span_dict(name, rand_hex(16), self._parent(), now, now, dict(attributes), None,
                                     kind="event"))

    def _span_dict(self, name, span_id, parent_id, start, end, attributes, error, kind="internal") -> dict:
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
            "resource": {"service.name": self.service},
        }

    def _record(self, span: dict) -> None:
        with self._lock:
            if self.retain_spans:
                self._spans.append(span)
            if self.sink_path is not None:
                self._write_locked(span)
            listeners = list(self._listeners)
        for listener in listeners:
            try:
                listener(span)
            except Exception:  # noqa: BLE001 - listeners are advisory
                pass

    def _write_locked(self, span: dict) -> None:
        """Append ``span`` to the sink and rotate it past ``max_bytes``;
        a sink that cannot be written is dropped (telemetry never fails
        the build it describes)."""
        try:
            if self._sink is None:
                self._sink = open(self.sink_path, "a")
            self._sink.write(json.dumps(span, default=str) + "\n")
            self._sink.flush()
            if self.max_bytes and self._sink.tell() >= self.max_bytes:
                self._rotate_locked()
        except OSError:
            self.sink_path = None
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

    def close(self) -> None:
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
