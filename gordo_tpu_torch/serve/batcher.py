"""
The cross-request micro-batcher, a copy of ``gordo_tpu/serve/batcher.py``:
request-lifecycle machinery only.

Concurrent single-model requests enqueue :class:`BatchItem`\\ s keyed by
an opaque batch key (the engine keys by ``(revision fleet, spec)`` — only
same-architecture requests can share a fused program). Dispatcher
thread(s) drain the queues under an adaptive flush policy and hand each
drained batch to the ``runner`` callable the owner supplied; results
travel back through per-request ``concurrent.futures.Future``\\ s.

Flush policy — a key's queue is ready when ANY of:

- **size**: it holds ``max_size`` items (a full program's worth);
- **deadline**: its oldest item has waited ``max_delay_s`` (bounds the
  latency cost of coalescing);
- **pressure**: total queued items across keys reached
  ``pressure_depth`` (under load there is no point waiting for more —
  the queue itself provides the coalescing).

Admission control — overload degrades instead of OOMing the host:

- a full queue (``queue_depth`` items pending) rejects new work with
  :class:`QueueFullError` (the server maps it to 429 + ``Retry-After``);
- each item carries an absolute deadline; items that expire before
  their batch runs get :class:`DeadlineExceeded` (504), and callers
  that stop waiting cancel their future so the runner skips the row.

This module is device-free (stdlib threading only), so the scheduling
is testable without a card.
"""

import logging
import threading
import time
from concurrent.futures import Future
from typing import Any, Callable, Dict, Hashable, List, Optional

logger = logging.getLogger(__name__)


class BatchShedError(Exception):
    """Base of the admission-control rejections."""


class QueueFullError(BatchShedError):
    """The batch queue is at capacity; retry after ``retry_after_s``."""

    def __init__(self, depth: int, retry_after_s: float):
        super().__init__(f"batch queue full ({depth} requests pending)")
        self.retry_after_s = retry_after_s


class DeadlineExceeded(BatchShedError):
    """The request's batching deadline passed before its batch ran."""


class BatcherStopped(BatchShedError):
    """Submit after shutdown began — callers fall back to unbatched."""


def clone_exception(exc: BaseException) -> BaseException:
    """A fresh exception instance carrying ``exc``'s type and message.

    Futures fan one batch failure out to N waiting request threads; each
    must get its OWN instance (``raise`` mutates the instance's
    ``__traceback__``, so one object re-raised from N handler threads is
    a data race). The original rides along as ``__cause__`` for the
    first-class server log; exception types whose constructor rejects a
    bare message degrade to ``RuntimeError``.
    """
    try:
        clone = type(exc)(*exc.args)
        if not isinstance(clone, type(exc)):  # an odd __new__ contract
            raise TypeError
    except Exception:  # noqa: BLE001 - ctor signature we can't satisfy
        clone = RuntimeError(f"batch runner failed: {exc!r}")
    clone.__cause__ = exc
    return clone


class BatchItem:
    """One enqueued request: the payload the runner scores, the future
    the waiting request thread holds, and the admission bookkeeping.
    ``trace`` optionally carries the submitting request's W3C trace
    context as ``(trace_id, span_id)`` so the fused batch span can link
    back to the request spans it coalesced."""

    __slots__ = (
        "name",
        "payload",
        "future",
        "enqueued_at",
        "deadline",
        "rows",
        "trace",
    )

    def __init__(
        self,
        name: str,
        payload: Any,
        rows: int = 1,
        deadline: Optional[float] = None,
        trace: Optional[tuple] = None,
    ):
        self.name = name
        self.payload = payload
        self.future: "Future[Any]" = Future()
        self.enqueued_at = time.monotonic()
        self.deadline = deadline
        self.rows = rows
        self.trace = trace


class MicroBatcher:
    """Keyed queues + dispatcher thread(s) draining them into ``runner``.

    ``runner(key, items)`` runs on a dispatcher thread and must resolve
    every item's future (the engine's stack→device→scatter). Items whose
    ``future.set_running_or_notify_cancel()`` returns False were
    abandoned by their request thread and are dropped before the runner
    sees them.
    """

    def __init__(
        self,
        runner: Callable[[Hashable, List[BatchItem]], None],
        *,
        max_size: int = 32,
        max_delay_s: float = 0.005,
        queue_depth: int = 512,
        pressure_depth: Optional[int] = None,
        dispatchers: int = 1,
        retry_after_s: float = 1.0,
        name: str = "serve",
        inline_flush: bool = False,
        on_shed: Optional[Callable[[str, int], None]] = None,
        on_depth: Optional[Callable[[int], None]] = None,
    ):
        if max_size < 1 or queue_depth < 1 or dispatchers < 1:
            raise ValueError("max_size, queue_depth and dispatchers must be >= 1")
        self.runner = runner
        self.max_size = max_size
        #: leader/follower mode: the submit that fills a batch to
        #: max_size runs it inline on the submitting thread (no
        #: dispatcher handoff on the saturated path — under load the
        #: wake-up latency of a parked dispatcher is the throughput
        #: ceiling); age/pressure flushes still drain via dispatchers
        self.inline_flush = inline_flush
        self.max_delay_s = max(0.0, max_delay_s)
        self.queue_depth = queue_depth
        self.pressure_depth = (
            pressure_depth
            if pressure_depth is not None
            else max(max_size, queue_depth // 2)
        )
        self.retry_after_s = retry_after_s
        self.name = name
        self._on_shed = on_shed
        self._on_depth = on_depth
        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)
        self._queues: Dict[Hashable, List[BatchItem]] = {}
        self._total = 0
        self._pressured = False
        self._stopping = False
        self._threads = [
            threading.Thread(
                target=self._dispatch_loop,
                name=f"gordo-{name}-dispatch-{i}",
                daemon=True,
            )
            for i in range(dispatchers)
        ]
        for thread in self._threads:
            thread.start()

    # -- submission ---------------------------------------------------------

    def submit(self, key: Hashable, item: BatchItem) -> "Future[Any]":
        """Enqueue ``item`` under ``key``; returns its future. Raises
        :class:`QueueFullError` at capacity and :class:`BatcherStopped`
        once shutdown began."""
        inline = None
        with self._work:
            if self._stopping:
                raise BatcherStopped("micro-batcher is shutting down")
            if self._total >= self.queue_depth:
                self._shed("queue_full")
                raise QueueFullError(self._total, self.retry_after_s)
            self._queues.setdefault(key, []).append(item)
            self._total += 1
            if self.inline_flush and len(self._queues[key]) >= self.max_size:
                # the popped batch may be ANOTHER (older) ready key —
                # notify regardless so nothing ready sits unclaimed
                inline = self._take_batch()
            depth = self._total
            if inline is None or self._total:
                self._work.notify()
        self._depth(depth)
        if inline is not None:
            self._run(*inline)
        return item.future

    def pending(self) -> int:
        with self._lock:
            return self._total

    # -- dispatch -----------------------------------------------------------

    def _ready_key(self, now: float) -> Optional[Hashable]:
        """The key to flush now, or None. Size- and age-ready keys win by
        oldest head; under pressure the largest queue flushes."""
        best = None
        best_age = -1.0
        # Draining counts as pressure: a stopping batcher flushes
        # everything now instead of letting items age to max_delay.
        # Pressure is sticky until the queues fully drain — one flush
        # drops _total below the threshold, but the items it left behind
        # were waiting under load and must not be stranded to max_delay.
        if self._total >= self.pressure_depth:
            self._pressured = True
        elif not self._total:
            self._pressured = False
        pressured = self._stopping or self._pressured
        for key, queue in self._queues.items():
            if not queue:
                continue
            age = now - queue[0].enqueued_at
            if len(queue) >= self.max_size or age >= self.max_delay_s:
                if age > best_age:
                    best, best_age = key, age
        if best is None and pressured:
            candidates = [k for k, q in self._queues.items() if q]
            if candidates:
                best = max(candidates, key=lambda k: len(self._queues[k]))
        return best

    def _next_wakeup(self, now: float) -> Optional[float]:
        deadlines = [
            queue[0].enqueued_at + self.max_delay_s
            for queue in self._queues.values()
            if queue
        ]
        if not deadlines:
            return None
        return max(0.0, min(deadlines) - now)

    def _take_batch(self) -> Optional[tuple]:
        """Pop the next flushable batch as ``(claimed_items, key)``
        (holding the lock); None when there is nothing ready."""
        now = time.monotonic()
        key = self._ready_key(now)
        if key is None:
            return None
        queue = self._queues[key]
        batch, remainder = queue[: self.max_size], queue[self.max_size:]
        if remainder:
            self._queues[key] = remainder
        else:
            del self._queues[key]
        self._total -= len(batch)
        return [self._claim(item) for item in batch], key

    def _claim(self, item: BatchItem) -> Optional[BatchItem]:
        """Claim one popped item for execution: expire past-deadline
        items, drop caller-cancelled ones."""
        if item.deadline is not None and time.monotonic() > item.deadline:
            self._shed("deadline")
            if not item.future.cancel():
                try:
                    item.future.set_exception(
                        DeadlineExceeded("batch deadline passed while queued")
                    )
                except Exception:  # noqa: BLE001 - already resolved: nothing to do
                    pass
            return None
        if not item.future.set_running_or_notify_cancel():
            self._shed("cancelled")
            return None
        return item

    def _dispatch_loop(self):
        while True:
            with self._work:
                taken = self._take_batch()
                while taken is None:
                    if self._stopping and not self._total:
                        return
                    timeout = self._next_wakeup(time.monotonic())
                    if self._stopping:
                        # draining: flush ages out immediately
                        timeout = 0.001
                    self._work.wait(timeout=timeout)
                    taken = self._take_batch()
                    if taken is None and self._stopping and not self._total:
                        return
                batch, key = taken
                depth = self._total
            self._depth(depth)
            self._run(batch, key)

    def _run(self, batch: List[Optional[BatchItem]], key: Hashable) -> None:
        """Run one popped batch (dispatcher thread or inline leader)."""
        live = [item for item in batch if item is not None]
        if not live:
            return
        try:
            self.runner(key, live)
        except BaseException as exc:  # noqa: BLE001 - a runner crash must
            # resolve every waiter (a hung client is worse than an error)
            logger.exception("batch runner failed for key %r", key)
            self._shed("runner_error")
            for item in live:
                try:
                    # each rider gets its OWN exception instance: one
                    # shared exception object (and its traceback) handed
                    # to N request-handler threads is mutated concurrently
                    # by every `raise` that re-renders it — a latent race
                    # and a cross-request information leak
                    item.future.set_exception(clone_exception(exc))
                except Exception:  # noqa: BLE001 - runner resolved some
                    pass

    # -- lifecycle ----------------------------------------------------------

    def shutdown(self, drain: bool = True, timeout: float = 30.0) -> None:
        """Stop accepting work; with ``drain`` the dispatcher(s) flush
        everything still queued before exiting, otherwise queued items
        get :class:`BatcherStopped`."""
        with self._work:
            self._stopping = True
            if not drain:
                for queue in self._queues.values():
                    for item in queue:
                        if not item.future.cancel():
                            try:
                                item.future.set_exception(
                                    BatcherStopped("batcher stopped")
                                )
                            except Exception:  # noqa: BLE001
                                pass
                self._queues.clear()
                self._total = 0
            self._work.notify_all()
        for thread in self._threads:
            thread.join(timeout=timeout)

    # -- hooks --------------------------------------------------------------

    def _shed(self, reason: str) -> None:
        if self._on_shed is not None:
            try:
                self._on_shed(reason, 1)
            except Exception:  # noqa: BLE001 - metrics are advisory
                pass

    def _depth(self, depth: int) -> None:
        if self._on_depth is not None:
            try:
                self._on_depth(depth)
            except Exception:  # noqa: BLE001 - metrics are advisory
                pass
