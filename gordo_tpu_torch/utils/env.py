"""
Environment-knob parsing: the typed readers the streaming plane, the
breakers and the serving engine use, a copy of ``gordo_tpu/utils/env.py``'s
``env_int``/``env_float``/``env_bool``/``env_str``.

Malformed values never raise: they log one warning per distinct
``(name, value)`` pair and fall back to the call-site default.

The build telemetry's knobs, with the JAX package's defaults
(``gordo_tpu/utils/env.py:248-320``), read where they act:
``GORDO_TPU_TELEMETRY`` (on), ``GORDO_TPU_TELEMETRY_DIR`` (the build's
output directory), ``GORDO_TPU_TELEMETRY_MAX_BYTES`` (256 MiB) and
``GORDO_TPU_TELEMETRY_KEEP`` (3) in ``telemetry/recorder.py``;
``GORDO_TPU_TELEMETRY_HEARTBEAT`` (0.5 s) in ``telemetry/progress.py``;
``GORDO_TPU_FLEET_HEALTH`` (on), ``GORDO_TPU_HEALTH_HEARTBEAT`` (2 s) and
``GORDO_TPU_HEALTH_SHARDS`` (0: from the fleet's size) in
``telemetry/fleet_health.py``.

The training knob ``GORDO_TPU_LSTM_SEGMENTED`` (0: off; N: N segments
an update of the segmented LSTM fit) is read in ``models/training.py``
(``segmented_config``).

The serving telemetry's (``gordo_tpu/utils/env.py:275-349``), likewise:
``GORDO_TPU_TRACE_SAMPLE_RATE`` (0.05) in ``telemetry/serving.py`` and
``GORDO_TPU_PROFILE_DIR`` (unset: no trace) in ``utils/profiling.py``.
The other serving settings of the JAX package are constants at their JAX
defaults, as nothing in the port needs another value:
``GORDO_TPU_PROFILE_SAMPLE_RATE`` (0) and ``_INTERVAL_MS`` (5) in
``telemetry/profiler.py``; ``GORDO_TPU_HEALTH_WINDOW`` (100,000 rows),
``GORDO_TPU_FLEET_STATUS_MAX_MACHINES`` (500) and ``_TOP_K`` (10) in
``telemetry/fleet_health.py``; ``GORDO_TPU_DEVICE_TELEMETRY`` (on: the
memory reading follows ``GORDO_TPU_TELEMETRY``). ``GORDO_TPU_WORKER_SINKS``
(``gordo_tpu/utils/env.py:349``; default: on exactly when
``PROMETHEUS_MULTIPROC_DIR`` is set, as under ``run-server``'s workers) is
read in ``telemetry/recorder.py``: when on, a process's serving trace and
health snapshot carry its pid.

>>> import os
>>> os.environ["GORDO_TPU_DOCTEST_KNOB"] = "not-a-number"
>>> env_int("GORDO_TPU_DOCTEST_KNOB", 7)
7
>>> del os.environ["GORDO_TPU_DOCTEST_KNOB"]
"""

import logging
import os
from typing import Optional

logger = logging.getLogger(__name__)

#: truthy / falsy spellings accepted by :func:`env_bool`
_TRUE_STRINGS = frozenset(("1", "true", "on", "yes"))
_FALSE_STRINGS = frozenset(("0", "false", "off", "no"))

#: (name, raw) pairs already warned about: a malformed knob warns once,
#: not once per read
_warned: set = set()


def _warn_once(name: str, raw: str, default) -> None:
    key = (name, raw)
    if key not in _warned:
        _warned.add(key)
        logger.warning("Invalid %s=%r; using %r", name, raw, default)


def env_int(name: str, default: int) -> int:
    """``int(os.environ[name])``, falling back to ``default``."""
    raw = os.environ.get(name)
    if raw:
        try:
            return int(raw)
        except ValueError:
            _warn_once(name, raw, default)
    return default


def env_float(name: str, default: Optional[float]) -> Optional[float]:
    """``float(os.environ[name])``, falling back to ``default``."""
    raw = os.environ.get(name)
    if raw:
        try:
            return float(raw)
        except ValueError:
            _warn_once(name, raw, default)
    return default


def env_bool(name: str, default: bool) -> bool:
    """``1/true/on/yes`` is True, ``0/false/off/no`` False; unset or empty
    is ``default``; anything else warns once and falls back."""
    raw = os.environ.get(name)
    if raw is None:
        return default
    value = raw.strip().lower()
    if not value:
        return default
    if value in _TRUE_STRINGS:
        return True
    if value in _FALSE_STRINGS:
        return False
    _warn_once(name, raw, default)
    return default


def env_str(name: str, default: Optional[str]) -> Optional[str]:
    """The raw value, unset or empty falling back to ``default``."""
    raw = os.environ.get(name)
    return raw if raw else default
