"""
The fleet-status document's ``slo`` section: the part of
``gordo_tpu/telemetry/slo.py`` (``:385-412``, ``:467-476``, ``:760-800``)
that reads the SLO engine's persisted ``slo_state.json`` as it is.

The JAX section has two branches: the status this process evaluated
last, or, when it has evaluated nothing, the persisted alerts alone.
The port has no SLO engine yet (the rollups, the objectives, ``/slo`` and
``slo status|check``: ``ROADMAP.md`` item 11b), so it never evaluates,
and only the persisted branch is here: a directory whose state a JAX
server left reads as the JAX section.
"""

import json
import os
from typing import Any, Dict, Optional

from ..utils.env import env_str
from .recorder import TRACE_DIR_ENV

SLO_STATE_FILE = "slo_state.json"


def slo_directory(anchor: Optional[str] = None) -> Optional[str]:
    """Where the serving telemetry and the SLO state live:
    ``GORDO_TPU_TELEMETRY_DIR`` when set, else ``anchor``."""
    return env_str(TRACE_DIR_ENV, None) or anchor


def _load_state(path: str) -> Dict[str, Any]:
    try:
        with open(path) as handle:
            doc = json.load(handle)
    except (OSError, ValueError):
        return {"version": 1, "alerts": {}}
    if not isinstance(doc, dict) or not isinstance(doc.get("alerts"), dict):
        return {"version": 1, "alerts": {}}
    return doc


def slo_section(directory: str) -> Optional[Dict[str, Any]]:
    """The alerts of ``directory``'s ``slo_state.json``, summarized
    (firing and pending counts, each alert, no budgets), or None when it
    holds no alert."""
    state = _load_state(os.path.join(os.path.normpath(directory), SLO_STATE_FILE))
    alerts = state.get("alerts") or {}
    if not alerts:
        return None
    firing = sum(1 for a in alerts.values() if a.get("state") == "firing")
    pending = sum(1 for a in alerts.values() if a.get("state") == "pending")
    return {
        "firing": firing,
        "pending": pending,
        "ok": firing == 0,
        "alerts": [{"id": alert_id, **record} for alert_id, record in sorted(alerts.items())],
        "budgets": None,
        "evaluated_at": state.get("updated_at"),
    }
