"""
Device ingest, a port of ``gordo_tpu/ingest/__init__.py``: raw-column
transfer to the serving device (:mod:`.transfer`) and the two knobs of the
ingest path.

The other half of the JAX subsystem, the compiled preprocessing plans
(``gordo_tpu/ingest/plan.py``), stays where the port keeps it: each
served bucket's affine plans are stacked by ``server/fleet_store.py``
(``member_plan``, ``RevisionFleet.ingest_plan``) and applied as K1's
prologue.

- ``GORDO_TPU_INGEST_COMPILED`` (default on): off, every feedforward
  bucket takes the host transform a non-affine bucket takes (each
  member's own pipeline on the host, no prologue in K1).
- ``GORDO_TPU_INGEST_DLPACK`` (default on): off, requests are staged
  through the host rung while the compiled plans stay on. The dlpack rung
  engages only when the serving device is a card, as JAX's engages only
  on accelerator backends: on the CPU both rungs stage through host
  memory. ``to_device(..., dlpack=True)`` takes the rung on any device.

Both are read again on every request, so an operator can flip them live.
"""

from typing import Any

import torch

from ..utils.env import env_bool
from .transfer import RawColumns, ingest_stats, reset_ingest_stats, stage, staging_buffer, to_device

INGEST_COMPILED_ENV = "GORDO_TPU_INGEST_COMPILED"
INGEST_DLPACK_ENV = "GORDO_TPU_INGEST_DLPACK"

__all__ = [
    "INGEST_COMPILED_ENV", "INGEST_DLPACK_ENV", "RawColumns", "compiled_enabled", "dlpack_enabled",
    "ingest_stats", "reset_ingest_stats", "stage", "staging_buffer", "to_device",
]


def compiled_enabled() -> bool:
    """Whether serving applies the affine plans inside K1."""
    return env_bool(INGEST_COMPILED_ENV, True)


def dlpack_enabled(device: Any = "cuda") -> bool:
    """Whether requests served on ``device`` try the dlpack rung first:
    the knob is on and ``device`` is a card."""
    return env_bool(INGEST_DLPACK_ENV, True) and torch.device(device).type == "cuda"
