"""
The sampling profiler of the serving host pipeline, a copy of
``gordo_tpu/telemetry/profiler.py``.

A request's host time is JSON decoding, frame alignment, scoring and
encoding; this profiler says which functions take it on a live server
without taxing every call as ``sys.setprofile`` would. A thread wakes
every :data:`INTERVAL_MS` (5 ms), reads the profiled request thread's
current frame with ``sys._current_frames()`` and charges one sample of
self time to the pair (request stage, top frame); the request thread runs
no extra instruction. ``?profile=1`` profiles that request. (The JAX
module also profiles a random share of requests,
``GORDO_TPU_PROFILE_SAMPLE_RATE``, default 0, at an interval of
``GORDO_TPU_PROFILE_INTERVAL_MS``; the port keeps their defaults as
constants.) The report, the top frames by self time, travels as the
attributes of a ``profile`` span in ``serve_trace.jsonl``.
``?profile=device`` is the other layer: a ``torch.profiler`` trace of the
request (``utils/profiling.py``).
"""

import sys
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

#: the sampling interval
INTERVAL_MS = 5.0
#: a profile's longest life: a hung request leaks no sampling thread
MAX_PROFILE_SECONDS = 120.0
#: frames kept in a report (it is a span attribute)
MAX_REPORT_FRAMES = 25


def should_profile(explicit: Optional[str]) -> bool:
    """Whether to profile this request: a truthy ``?profile=`` value.

    >>> should_profile("1"), should_profile("0"), should_profile(None)
    (True, False, False)
    """
    return explicit is not None and explicit.strip().lower() not in ("", "0", "false", "off", "no")


def _frame_label(frame) -> str:
    """``<dir>/<file>:<function>``, the path cut to its last two parts."""
    code = frame.f_code
    parts = code.co_filename.replace("\\", "/").rsplit("/", 2)
    filename = "/".join(parts[-2:]) if len(parts) > 1 else parts[-1]
    return f"{filename}:{code.co_name}"


class SamplingProfiler:
    """Samples one thread's stack until stopped, self time summed by
    ``(stage, function)``; ``stage_getter`` answers the request's current
    stage (``"-"`` outside any)."""

    def __init__(self):
        self.interval_s = INTERVAL_MS / 1000.0
        self.max_seconds = MAX_PROFILE_SECONDS
        self._counts: Dict[Tuple[str, str], int] = {}
        self._samples = 0
        self._missed = 0
        self._started_at = 0.0
        self._stopped_at = 0.0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self, thread_id: Optional[int] = None,
              stage_getter: Optional[Callable[[], Optional[str]]] = None) -> "SamplingProfiler":
        """Sample ``thread_id`` (default: the calling thread)."""
        target_id = thread_id if thread_id is not None else threading.get_ident()
        self._started_at = time.monotonic()
        self._thread = threading.Thread(target=self._sample_loop, args=(target_id, stage_getter or (lambda: None)),
                                        name="gordo-profile-sampler", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> Dict[str, Any]:
        """Stop sampling; the report."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
        self._stopped_at = time.monotonic()
        return self.report()

    def _sample_loop(self, target_id: int, stage_getter) -> None:
        deadline = self._started_at + self.max_seconds
        while not self._stop.wait(self.interval_s):
            if time.monotonic() > deadline:
                return
            frame = sys._current_frames().get(target_id)
            if frame is None:
                self._missed += 1
                continue
            try:
                stage = stage_getter() or "-"
            except Exception:  # noqa: BLE001 - a bad read mislabels one sample, never stops the profiler
                stage = "-"
            key = (str(stage), _frame_label(frame))
            self._counts[key] = self._counts.get(key, 0) + 1
            self._samples += 1
            del frame  # no live frame kept across sleeps

    def report(self, max_frames: int = MAX_REPORT_FRAMES) -> Dict[str, Any]:
        """The top ``max_frames`` frames by samples, each charged
        ``samples x interval`` ms of self time."""
        stopped = self._stopped_at or time.monotonic()
        per_sample_ms = self.interval_s * 1000.0
        ranked = sorted(self._counts.items(), key=lambda kv: kv[1], reverse=True)
        frames: List[Dict[str, Any]] = [
            {"stage": stage, "function": function, "samples": count, "self_ms": round(count * per_sample_ms, 3)}
            for (stage, function), count in ranked[:max_frames]
        ]
        return {
            "samples": self._samples,
            "missed": self._missed,
            "interval_ms": round(per_sample_ms, 3),
            "duration_ms": round(max(0.0, stopped - self._started_at) * 1000.0, 3),
            "truncated_frames": max(0, len(ranked) - max_frames),
            "frames": frames,
        }
