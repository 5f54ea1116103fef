"""
The post-fork reset registry, a copy of ``gordo_tpu/utils/postfork.py``:
one place for module-level state that must not survive ``os.fork()``
into a worker of ``run-server``'s pre-fork master (``server/prefork.py``).

A module registers a zero-argument reset at import::

    from ..utils.postfork import register_postfork_reset

    register_postfork_reset(_reset_after_fork, name="telemetry.serving.recorder")

The first registration installs one ``os.register_at_fork(after_in_child=...)``
hook that runs every reset, in registration order. Resets run in the
child only, must not raise (a failure is logged and swallowed: a broken
reset must not kill a fresh worker), and only drop references or rebind
locks, never acquire an inherited one: the lock may have been taken by a
thread that does not exist on this side of the fork.

What the port registers: the serving recorder (``telemetry/serving.py``)
and the health ledgers (``telemetry/fleet_health.py``), as JAX does; the
launch counters of K1 and K2 (``ops/fleet_dense.py``), so that a worker's
drain line counts its own launches; the loaded kernel libraries
(``ops/_build.py``); the live apps the collectors read
(``server/app.py``); the span-id source (``telemetry/recorder.py``); the
metric caches and the process registry (``server/prometheus/``) and the
multi-process value files (``server/prometheus/multiprocess.py``).

Standard library only, and a no-op where there is no ``fork``.
"""

import logging
import os
import threading
from typing import Callable, List, Optional, Tuple

logger = logging.getLogger(__name__)

_registry_lock = threading.Lock()
_resets: List[Tuple[str, Callable[[], None]]] = []
_hook_installed = False


def register_postfork_reset(reset: Callable[[], None], name: Optional[str] = None) -> None:
    """Run ``reset()`` in every child this process forks, after the fork.
    Registering a callable twice keeps one entry."""
    global _hook_installed
    with _registry_lock:
        if any(existing is reset for _, existing in _resets):
            return
        _resets.append((name or getattr(reset, "__qualname__", "reset"), reset))
        if not _hook_installed and hasattr(os, "register_at_fork"):
            os.register_at_fork(after_in_child=run_postfork_resets)
            _hook_installed = True


def run_postfork_resets() -> None:
    """Run every registered reset (the child's fork hook; tests call it
    to stand for a fork)."""
    global _registry_lock
    # the child is single-threaded here: the inherited lock may have been
    # taken in the parent by a thread that is gone, so it is rebound, not taken
    _registry_lock = threading.Lock()
    for name, reset in list(_resets):
        try:
            reset()
        except Exception:  # noqa: BLE001 - a broken reset must not kill the fresh worker
            logger.exception("post-fork reset %s failed", name)


def registered_resets() -> List[str]:
    """The registered reset names, in registration order."""
    with _registry_lock:
        return [name for name, _ in _resets]
