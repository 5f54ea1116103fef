"""
Deterministic fault injection at the streaming plane's three sites, the
serving engine's three and the fleet build's four, a copy of ``gordo_tpu/utils/faults.py``
(``fault_point``, ``FaultRule``, ``inject``, the ``GORDO_TPU_FAULTS``
environment form, the ``kill`` option).

Production code calls :func:`fault_point` at a named site; it is a no-op
unless a matching :class:`FaultRule` is active. Rules are installed with
the :func:`inject` context manager or the environment variable. Sites:

- ``stream_ingest``: before a machine's decoded rows land in its ring
  (key ``<stream-id>:<machine>``); the machine errors alone in the ack.
- ``stream_score``: before a machine's cut window is handed to the
  scorer (same key); repeated firings open the machine's breaker.
- ``stream_emit``: before an event is appended to a session's outbox
  (key ``<stream-id>:<event-kind>``); the event is counted and dropped.
- ``serve_device_program``: before a coalesced batch's forward, once per
  rider (key ``<spec class>:<precision>:<member>``); its default
  exception is an :class:`InjectedDeviceError` whose message says
  ``RESOURCE_EXHAUSTED``, which the engine treats as an out-of-memory.
- ``serve_member_poison``: after a batch's forward, per rider (same
  key); the rider's output rows become NaN, as a poisoned member's would.
- ``serve_scatter``: before a rider's result is handed back (same key);
  that rider alone fails.
- ``device_program``: before a training bucket runs, once per member
  (key the member name); its default exception is an
  :class:`InjectedDeviceError`, which makes the trainer bisect the
  bucket as it does on a device failure.
- ``data_fetch``: before each attempt at a machine's
  ``dataset.get_data()`` in a fleet build (key the machine name).
- ``dump_artifact``: inside ``serializer.dump_atomic``, after the files
  are written into the ``.<name>.tmp-*`` staging directory and before
  the rename (key the artifact directory's name).
- the lifecycle's (``lifecycle/``): ``drift_eval`` as each machine's
  drift verdict is taken (key the machine name), ``canary_build`` before
  the stale members rebuild, ``promote_swap`` before the hot swap and
  ``rollback`` before a canary's rollback (key the canary revision).
- ``process_kill_after_n_machines``: after each machine's artifact
  landed and was journaled ``built`` (key the machine name); its default
  exception is ``SystemExit(137)``, which a build never records as one
  machine's failure.

Each rule counts the calls matching its (site, key glob) and fires on
calls ``after < i <= after + times``. A rule with ``kill`` ends the
process with ``os._exit(137)`` instead of raising: a real death for the
kill-and-resume drill.

>>> with inject(FaultRule("stream_score", match="s1:*", times=1)):
...     try:
...         fault_point("stream_score", "s1:m-1")
...     except FaultInjected:
...         print("fired")
...     fault_point("stream_score", "s1:m-1")  # times exhausted: passes
fired

Env form (``;``-separated rules, fields ``site[:key-glob][:opt...]``,
options ``times=N|inf``, ``after=N``, ``exc=Name``, ``kill``); the glob
cannot contain ``:``, but ``*`` matches across it::

    GORDO_TPU_FAULTS="stream_score:*machine-3:times=inf"
    GORDO_TPU_FAULTS="process_kill_after_n_machines:*:after=6:kill"
"""

import fnmatch
import logging
import os
import threading
from dataclasses import dataclass, field
from typing import Any, List, Optional, Tuple

logger = logging.getLogger(__name__)

ENV_VAR = "GORDO_TPU_FAULTS"

SITES = (
    "data_fetch",
    "device_program",
    "dump_artifact",
    "process_kill_after_n_machines",
    "drift_eval",
    "canary_build",
    "promote_swap",
    "rollback",
    "serve_device_program",
    "serve_member_poison",
    "serve_scatter",
    "stream_ingest",
    "stream_score",
    "stream_emit",
)


class FaultInjected(RuntimeError):
    """An injected fault (the default exception)."""


class InjectedDeviceError(FaultInjected):
    """An injected fault the fleet trainer treats as a device failure."""


#: exception names accepted by the env form's ``exc=`` option
_EXC_TYPES = {
    "FaultInjected": FaultInjected,
    "InjectedDeviceError": InjectedDeviceError,
    "RuntimeError": RuntimeError,
    "OSError": OSError,
    "MemoryError": MemoryError,
    "SystemExit": SystemExit,
    "KeyboardInterrupt": KeyboardInterrupt,
}


@dataclass
class FaultRule:
    """One deterministic failure: fire on matching calls
    ``after < i <= after + times`` of ``site`` whose key globs ``match``."""

    site: str
    match: str = "*"
    times: Optional[int] = 1  # None = every matching call past ``after``
    after: int = 0
    exc: Optional[Any] = None  # exception class/instance/factory(message)
    kill: bool = False  # os._exit(137) instead of raising
    seen: int = field(default=0, compare=False)
    fired: int = field(default=0, compare=False)

    def make_exc(self, key: str) -> BaseException:
        exc = self.exc
        if exc is not None:
            if isinstance(exc, BaseException):
                return exc
            return exc(f"injected fault at {self.site}:{key}")
        if self.site == "device_program":
            return InjectedDeviceError(f"injected device fault ({key})")
        if self.site == "serve_device_program":
            return InjectedDeviceError(f"RESOURCE_EXHAUSTED: injected device fault ({key})")
        if self.site == "process_kill_after_n_machines":
            return SystemExit(137)
        return FaultInjected(f"injected fault at {self.site}:{key}")


_lock = threading.Lock()
_installed: List[FaultRule] = []
#: (raw env string, parsed rules): parsed once per distinct value so the
#: rules' counters persist across fault_point calls
_env_cache: Tuple[Optional[str], List[FaultRule]] = (None, [])


def parse_rules(spec: str) -> List[FaultRule]:
    """Parse the ``GORDO_TPU_FAULTS`` string form.

    >>> [(r.match, r.times) for r in parse_rules("stream_score:*m-3:times=inf")]
    [('*m-3', None)]
    >>> [(r.match, r.after, r.kill) for r in parse_rules("process_kill_after_n_machines:*:after=6:kill")]
    [('*', 6, True)]
    """
    rules = []
    for entry in spec.split(";"):
        entry = entry.strip()
        if not entry:
            continue
        parts = entry.split(":")
        site = parts[0]
        if site not in SITES:
            raise ValueError(f"unknown fault site {site!r} (known: {SITES})")
        rule = FaultRule(site=site)
        opts = parts[1:]
        if opts and "=" not in opts[0] and opts[0] != "kill":
            rule.match = opts[0]
            opts = opts[1:]
        for opt in opts:
            if opt == "kill":
                rule.kill = True
            elif opt.startswith("times="):
                value = opt.split("=", 1)[1]
                rule.times = None if value in ("inf", "all") else int(value)
            elif opt.startswith("after="):
                rule.after = int(opt.split("=", 1)[1])
            elif opt.startswith("exc="):
                name = opt.split("=", 1)[1]
                if name not in _EXC_TYPES:
                    raise ValueError(f"unknown exc {name!r} (known: {sorted(_EXC_TYPES)})")
                rule.exc = _EXC_TYPES[name]
            else:
                raise ValueError(f"unknown fault option {opt!r}")
        rules.append(rule)
    return rules


def _env_rules() -> List[FaultRule]:
    global _env_cache
    raw = os.environ.get(ENV_VAR)
    if not raw:
        if _env_cache[0] is not None:
            _env_cache = (None, [])
        return []
    if raw != _env_cache[0]:
        _env_cache = (raw, parse_rules(raw))
    return _env_cache[1]


def install(*rules: FaultRule) -> None:
    """Activate rules for the rest of the process (tests prefer
    :func:`inject`, which scopes them)."""
    with _lock:
        _installed.extend(rules)


def clear() -> None:
    """Deactivate every installed rule and forget the env cache."""
    global _env_cache
    with _lock:
        _installed.clear()
        _env_cache = (None, [])


class inject:
    """Context manager scoping a set of :class:`FaultRule` s; nestable."""

    def __init__(self, *rules: FaultRule):
        self.rules = rules

    def __enter__(self) -> "inject":
        install(*self.rules)
        return self

    def __exit__(self, *_exc_info) -> None:
        with _lock:
            for rule in self.rules:
                # identity, not equality: the dataclass's __eq__ ignores the
                # counters, so list.remove could pop an equal outer rule
                for i, installed in enumerate(_installed):
                    if installed is rule:
                        del _installed[i]
                        break


def fault_point(site: str, key: str = "") -> None:
    """Fire any active rule matching ``(site, key)``; a no-op otherwise.
    Threads share the rules' counters under a lock, so ``after`` and
    ``times`` stay exact."""
    with _lock:
        rules = _installed + _env_rules()
        to_fire = None
        for rule in rules:
            if rule.site != site or not fnmatch.fnmatchcase(key, rule.match):
                continue
            rule.seen += 1
            i = rule.seen
            if i <= rule.after:
                continue
            if rule.times is not None and i > rule.after + rule.times:
                continue
            rule.fired += 1
            to_fire = rule
            break
    if to_fire is None:
        return
    logger.warning("Fault injection: firing %s at %s:%s (match %r, fired %d)",
                   "os._exit(137)" if to_fire.kill else "exception", site, key, to_fire.match, to_fire.fired)
    if to_fire.kill:
        os._exit(137)
    raise to_fire.make_exc(key)
