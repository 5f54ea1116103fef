"""
The fleet lifecycle, a copy of ``gordo_tpu/lifecycle/``: drift statistics
over scored rows (``drift.py``), a partial rebuild of only the stale
members (``parallel/fleet_build.py::rebuild_stale``, replaying the base
revision's plan), a hardlinked canary revision (``revision.py``) taking a
slice of the traffic, the promotion gates (``gates.py``), the crash-safe
state (``state.py``) and the supervisor that runs them
(``loop.py``). The routing lives in the app's store
(``server/fleet_store.py``: ``route``, ``swap``, ``set_canary``).
"""

from .drift import DriftConfig, DriftMonitor, DriftVerdict, MachineDrift
from .gates import GateConfig, GateReport, evaluate_canary
from .loop import LIFECYCLE_TRACE_FILE, CycleReport, LifecycleConfig, LifecycleSupervisor, restore_serving_state
from .revision import delete_revision_dir, list_revisions, next_revision, publish_canary, revision_complete
from .state import LIFECYCLE_DIR, QUARANTINE_FILE, STATE_FILE, LifecycleState

__all__ = [
    "CycleReport",
    "DriftConfig",
    "DriftMonitor",
    "DriftVerdict",
    "GateConfig",
    "GateReport",
    "LIFECYCLE_DIR",
    "LIFECYCLE_TRACE_FILE",
    "LifecycleConfig",
    "LifecycleState",
    "LifecycleSupervisor",
    "MachineDrift",
    "QUARANTINE_FILE",
    "STATE_FILE",
    "delete_revision_dir",
    "evaluate_canary",
    "list_revisions",
    "next_revision",
    "publish_canary",
    "restore_serving_state",
    "revision_complete",
]
