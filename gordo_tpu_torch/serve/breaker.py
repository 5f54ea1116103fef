"""
Per-member circuit breakers, a copy of ``gordo_tpu/serve/breaker.py``
(``BreakerConfig``, ``BreakerBoard``, ``MemberQuarantined``,
``ServeDeviceError``). The serving engine owns one board; the streaming
plane quarantines through the engine's board when the app has an engine,
else through its own.

The board keeps one record per ``(revision fleet, spec, member)``:

- **closed**: scoring flows; an isolated failure counts, a success resets
  the count. ``GORDO_TPU_BREAKER_THRESHOLD`` consecutive failures trip it.
- **open**: the member is not scored for ``cooldown`` seconds, which
  starts at ``GORDO_TPU_BREAKER_COOLDOWN_S`` and multiplies by
  ``GORDO_TPU_BREAKER_BACKOFF`` on every re-trip, capped at
  ``GORDO_TPU_BREAKER_MAX_COOLDOWN_S``.
- **half-open**: after the cooldown one caller is admitted as the probe;
  its success closes the breaker, its failure re-opens it. A probe that
  never reports expires after ``probe_ttl_s``.

The board also holds the engine's precision degrade set: the (fleet,
spec, precision) buckets whose reduced-precision forward failed while
serving, pinned to f32 whether or not the parity gate is on.

Keys hold the fleet's ``id``, and a fleet that dies takes its records
with it (``weakref.finalize``), so a new revision starts clean.
"""

import collections
import logging
import threading
import time
import weakref
from typing import Any, Callable, Dict, Optional, Tuple

from ..utils.env import env_float, env_int
from .batcher import BatchShedError

logger = logging.getLogger(__name__)

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"


class MemberQuarantined(BatchShedError):
    """The member's circuit breaker is open: answered as 503 with a
    ``Retry-After`` from the remaining cooldown."""

    def __init__(self, member: str, retry_after_s: float):
        super().__init__(
            f"model {member!r} is quarantined by its serving circuit "
            f"breaker; retry in {retry_after_s:.0f}s"
        )
        self.member = member
        self.retry_after_s = retry_after_s


class ServeDeviceError(BatchShedError):
    """The device forward failed for this member after the engine isolated
    it (its batch's other riders have their answers): answered as 500,
    with a generic text; the cause is chained for the server log."""

    def __init__(self, member: str, cause: Optional[BaseException] = None):
        super().__init__(f"device scoring failed for model {member!r} in isolation")
        self.member = member
        self.__cause__ = cause


class BreakerConfig:
    """Breaker knobs, resolved once per board from the environment."""

    __slots__ = ("threshold", "cooldown_s", "backoff", "max_cooldown_s", "probe_ttl_s")

    def __init__(
        self,
        threshold: int = 3,
        cooldown_s: float = 30.0,
        backoff: float = 2.0,
        max_cooldown_s: float = 600.0,
        probe_ttl_s: Optional[float] = None,
    ):
        self.threshold = max(1, int(threshold))
        self.cooldown_s = max(0.001, float(cooldown_s))
        self.backoff = max(1.0, float(backoff))
        self.max_cooldown_s = max(self.cooldown_s, float(max_cooldown_s))
        #: how long a half-open probe may stay unresolved before another
        #: caller may probe
        self.probe_ttl_s = float(probe_ttl_s) if probe_ttl_s is not None else max(5.0, self.cooldown_s)

    @classmethod
    def from_env(cls) -> "BreakerConfig":
        return cls(
            threshold=env_int("GORDO_TPU_BREAKER_THRESHOLD", 3),
            cooldown_s=env_float("GORDO_TPU_BREAKER_COOLDOWN_S", 30.0),
            backoff=env_float("GORDO_TPU_BREAKER_BACKOFF", 2.0),
            max_cooldown_s=env_float("GORDO_TPU_BREAKER_MAX_COOLDOWN_S", 600.0),
        )


class _MemberBreaker:
    """One member's record (mutated only under the board lock)."""

    __slots__ = ("name", "state", "failures", "trips", "opened_at", "cooldown_s", "probe_at", "last_error")

    def __init__(self, name: str):
        self.name = name
        self.state = CLOSED
        self.failures = 0  # consecutive failures
        self.trips = 0
        self.opened_at = 0.0  # monotonic
        self.cooldown_s = 0.0
        self.probe_at: Optional[float] = None
        self.last_error = ""

    def snapshot(self) -> Dict[str, Any]:
        return {
            "member": self.name,
            "state": self.state,
            "failures": self.failures,
            "trips": self.trips,
            "cooldown_s": round(self.cooldown_s, 3),
            "last_error": self.last_error,
        }


class BreakerBoard:
    """The breaker registry, keyed by (fleet, spec, member).

    ``on_transition(member, old_state, new_state, snapshot)`` fires,
    outside the lock, on every state change.
    """

    def __init__(
        self,
        config: Optional[BreakerConfig] = None,
        on_transition: Optional[Callable[[str, str, str, dict], None]] = None,
    ):
        self.config = config or BreakerConfig.from_env()
        self._on_transition = on_transition
        self._lock = threading.Lock()
        self._members: Dict[Tuple[int, Any, str], _MemberBreaker] = {}
        #: the non-closed subset of ``_members``: summaries cost what the
        #: unhealthy members cost, not the fleet's size
        self._unhealthy: Dict[Tuple[int, Any, str], _MemberBreaker] = {}
        self._live_trips = 0
        #: (fleet id, spec, precision) buckets degraded to f32 after device
        #: errors; read per request with one set probe
        self._degraded: set = set()
        #: fleet id -> finalizer that purges a dead fleet's records
        self._fleets: Dict[int, Any] = {}
        #: fleet ids whose finalizer fired, drained under the lock; the
        #: finalizer runs inside the GC, possibly while the lock is held, so
        #: it only appends here
        self._dead: "collections.deque" = collections.deque()

    def _track_fleet(self, fleet: Any) -> int:
        fid = id(fleet)
        if fid not in self._fleets:  # caller holds the lock
            self._fleets[fid] = weakref.finalize(fleet, self._dead.append, fid)
        return fid

    def _drain_dead_locked(self) -> None:
        while True:
            try:
                fid = self._dead.popleft()
            except IndexError:
                return
            self._fleets.pop(fid, None)
            for key in [k for k in self._members if k[0] == fid]:
                self._live_trips -= self._members.pop(key).trips
                self._unhealthy.pop(key, None)
            self._degraded = {k for k in self._degraded if k[0] != fid}

    def quarantined(self, fleet: Any, spec: Any, member: str) -> Optional[float]:
        """None when the member may be scored (closed, or admitted as the
        half-open probe); otherwise the seconds to retry after."""
        if self._dead:
            with self._lock:
                self._drain_dead_locked()
        key = (id(fleet), spec, member)
        breaker = self._members.get(key)  # lock-free: the common case
        if breaker is None or breaker.state == CLOSED:
            return None
        now = time.monotonic()
        transition = None
        with self._lock:
            self._drain_dead_locked()
            breaker = self._members.get(key)
            if breaker is None or breaker.state == CLOSED:
                return None
            if breaker.state == OPEN:
                remaining = breaker.opened_at + breaker.cooldown_s - now
                if remaining > 0:
                    return max(1.0, remaining)
                # the cooldown lapsed: this caller becomes the probe
                breaker.state = HALF_OPEN
                breaker.probe_at = now
                transition = (OPEN, HALF_OPEN, breaker.snapshot())
            elif breaker.state == HALF_OPEN:
                probe_at = breaker.probe_at
                if probe_at is not None and now - probe_at < self.config.probe_ttl_s:
                    return max(1.0, self.config.probe_ttl_s - (now - probe_at))
                breaker.probe_at = now  # the previous probe was lost
        if transition is not None:
            self._fire(member, *transition)
        return None

    def record_success(self, fleet: Any, spec: Any, member: str) -> None:
        """The member scored cleanly: reset its failure count and close a
        half-open breaker."""
        key = (id(fleet), spec, member)
        if self._members.get(key) is None:  # lock-free: the common case
            return
        transition = None
        with self._lock:
            self._drain_dead_locked()
            breaker = self._members.get(key)
            if breaker is None:
                return
            breaker.failures = 0
            if breaker.state == HALF_OPEN:
                breaker.state = CLOSED
                breaker.probe_at = None
                self._unhealthy.pop(key, None)
                transition = (HALF_OPEN, CLOSED, breaker.snapshot())
        if transition is not None:
            logger.info("breaker CLOSED for member %s after %d trip(s)", member, transition[2]["trips"])
            self._fire(member, *transition)

    def record_failure(self, fleet: Any, spec: Any, member: str, exc: BaseException) -> bool:
        """One failure of ``member``; True when it tripped the breaker
        (closed to open, or a failed half-open probe)."""
        now = time.monotonic()
        transition = None
        with self._lock:
            self._drain_dead_locked()
            key = (self._track_fleet(fleet), spec, member)
            breaker = self._members.get(key)
            if breaker is None:
                breaker = self._members[key] = _MemberBreaker(member)
            breaker.failures += 1
            breaker.last_error = repr(exc)[:200]
            tripped = breaker.state == HALF_OPEN or (
                breaker.state == CLOSED and breaker.failures >= self.config.threshold
            )
            if tripped:
                old = breaker.state
                breaker.state = OPEN
                breaker.trips += 1
                self._live_trips += 1
                self._unhealthy[key] = breaker
                breaker.opened_at = now
                breaker.probe_at = None
                breaker.cooldown_s = min(
                    self.config.max_cooldown_s,
                    self.config.cooldown_s * (self.config.backoff ** (breaker.trips - 1)),
                )
                transition = (old, OPEN, breaker.snapshot())
        if transition is not None:
            logger.warning(
                "breaker OPEN for member %s (trip %d, cooldown %.1fs): %s",
                member, transition[2]["trips"], transition[2]["cooldown_s"], transition[2]["last_error"],
            )
            self._fire(member, *transition)
        return transition is not None

    def degrade_bucket(self, fleet: Any, spec: Any, precision: str) -> bool:
        """Pin one (fleet, spec, precision) bucket to f32 after its
        reduced-precision forward failed; True when newly degraded."""
        with self._lock:
            self._drain_dead_locked()
            key = (self._track_fleet(fleet), spec, precision)
            if key in self._degraded:
                return False
            self._degraded.add(key)
        return True

    def degraded(self, fleet: Any, spec: Any, precision: str) -> bool:
        if self._dead:
            # a dead fleet's id may be reused by a new one: drain first, so
            # a stale key never pins a fresh revision's bucket to f32
            with self._lock:
                self._drain_dead_locked()
        return (id(fleet), spec, precision) in self._degraded  # lock-free

    def summary(self, top_k: int = 10) -> Dict[str, Any]:
        """Counts by state, total trips, and the ``top_k`` unhealthy
        members by trips."""
        with self._lock:
            self._drain_dead_locked()
            tracked = len(self._members)
            unhealthy = list(self._unhealthy.values())
            trips = self._live_trips
            degraded = len(self._degraded)
        counts = {OPEN: 0, HALF_OPEN: 0}
        for breaker in unhealthy:
            counts[breaker.state] += 1
        ranked = sorted(unhealthy, key=lambda b: (-b.trips, b.name))
        return {
            "tracked": tracked,
            "open": counts[OPEN],
            "half_open": counts[HALF_OPEN],
            "trips": trips,
            "degraded_buckets": degraded,
            "members": [b.snapshot() for b in ranked[: max(0, top_k)]],
        }

    def snapshot(self, detail_cap: int = 50) -> Dict[str, Any]:
        """:meth:`summary` with member detail capped at ``detail_cap``."""
        return self.summary(top_k=detail_cap)

    def _fire(self, member: str, old: str, new: str, info: dict) -> None:
        if self._on_transition is None:
            return
        try:
            self._on_transition(member, old, new, info)
        except Exception:  # noqa: BLE001 - transition hooks are advisory
            logger.debug("breaker transition hook failed", exc_info=True)
