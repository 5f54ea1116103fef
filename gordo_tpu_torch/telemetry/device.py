"""
Device telemetry of a build: the card's memory and the programs' compile
counters, the part of ``gordo_tpu/telemetry/device.py`` a build uses
(``:1-127``, ``:168-257``).

- :func:`memory_snapshot` reads the caching allocator's counters,
  ``torch.cuda.memory_stats(device)`` (``allocated_bytes.all.current``
  and ``.peak``) and the card's total memory, where the JAX package reads
  ``Device.memory_stats()`` of every local device. It reads host-side
  counters and never waits on the card. A CPU build gives
  ``{"available": False}``, as the JAX package does on a backend without
  stats.
- :func:`note_program_execution` counts ``program_span``'s first calls
  (``compiles``) and later ones (``cache_hits``) per kind;
  :func:`program_cache_counters` reads them.
- :func:`emit_device_utilization` puts both on one ``device_utilization``
  event.

The JAX package's persistent compile cache (``:128-166``,
``GORDO_TPU_COMPILE_CACHE``) has no counterpart: the port compiles no
programs, and its one kernel's build products are cached by
``ops/_build.py`` under ``build/gordo_tpu_torch/``.
"""

import threading
from typing import Any, Dict, Optional

import torch

from .recorder import enabled

_MEMORY_KEYS = ("bytes_in_use", "peak_bytes_in_use", "bytes_limit")


_counter_lock = threading.Lock()
_program_counters: Dict[str, Dict[str, Any]] = {}


def note_program_execution(compiled: bool, kind: str = "build") -> None:
    """Count one program call: a first call of its signature
    (``compiled``) or a later one. (The JAX serving engine also counts
    by precision; the port's engine counts nothing here yet.)"""
    with _counter_lock:
        counters = _program_counters.setdefault(kind, {"compiles": 0, "cache_hits": 0})
        counters["compiles" if compiled else "cache_hits"] += 1


def program_cache_counters() -> Dict[str, Dict[str, Any]]:
    """The counters per kind, each with its ``hit_rate`` (None before any
    call)."""
    with _counter_lock:
        snapshot = {kind: dict(counters) for kind, counters in _program_counters.items()}
    for counters in snapshot.values():
        total = counters["compiles"] + counters["cache_hits"]
        counters["hit_rate"] = round(counters["cache_hits"] / total, 4) if total else None
    return snapshot


def reset_program_counters() -> None:
    """Zero the counters (tests)."""
    with _counter_lock:
        _program_counters.clear()


def memory_snapshot(device: Any = None) -> Optional[Dict[str, Any]]:
    """
    The card's memory: ``bytes_in_use`` (allocated now),
    ``peak_bytes_in_use`` (the allocator's peak since the process began
    or its last reset), ``bytes_limit`` (the card's memory), their
    ``max_*`` copies (one card: the same), ``utilization``. None when
    telemetry is off; ``available`` False for a CPU ``device`` or when the
    allocator has no stats.
    """
    if not enabled():
        return None
    device = torch.device("cuda" if device is None else device)
    doc: Dict[str, Any] = {"devices": 1, "measured_devices": 0, "available": False}
    if device.type != "cuda" or not torch.cuda.is_available():
        return doc
    try:
        stats = torch.cuda.memory_stats(device)
        limit = torch.cuda.get_device_properties(device).total_memory
    except Exception:  # noqa: BLE001 - telemetry degrades, never fails its caller
        return doc
    if not stats:
        return doc
    values = {
        "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
        "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
        "bytes_limit": int(limit),
    }
    doc.update(measured_devices=1, available=True)
    for key in _MEMORY_KEYS:
        doc[key] = values[key]
        doc[f"max_{key}"] = values[key]
    if values["bytes_limit"]:
        doc["utilization"] = round(values["bytes_in_use"] / values["bytes_limit"], 4)
    return doc


def utilization_snapshot(device: Any = None) -> Dict[str, Any]:
    """Memory and compile counters in one document."""
    doc: Dict[str, Any] = {"compile_cache": program_cache_counters()}
    memory = memory_snapshot(device)
    if memory is not None:
        doc["memory"] = memory
    return doc


def emit_device_utilization(recorder: Any, device: Any = None, **attributes: Any) -> Optional[dict]:
    """One ``device_utilization`` event on ``recorder`` (the memory
    snapshot as ``memory_*`` attributes and the build's compile
    counters); the snapshot, or None when telemetry is off."""
    memory = memory_snapshot(device)
    if memory is None:
        return None
    counters = program_cache_counters().get("build") or {}
    recorder.event(
        "device_utilization",
        **attributes,
        **{f"memory_{k}": v for k, v in memory.items()},
        compiles=counters.get("compiles", 0),
        cache_hits=counters.get("cache_hits", 0),
    )
    return memory
