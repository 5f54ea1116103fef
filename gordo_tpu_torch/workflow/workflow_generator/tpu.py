"""
Slice geometry, a copy of ``gordo_tpu/workflow/workflow_generator/tpu.py``:
an accelerator type to (hosts, chips a host, topology).

A project config names its fleet by a TPU slice type
(``runtime.fleet.accelerator_type``). The port's workflow keeps that key
and reads it as a count of builder pods and cards a pod: the builder Job
runs ``hosts`` pods (``parallelism == completions == hosts``), each
claiming ``nvidia.com/gpu: chips_per_host``, and ``build-fleet`` runs one
rank a card across them (``JAX_PROCESS_COUNT`` pods). An unknown type
falls back to one host of 4 and logs a warning, as in the JAX package.
"""

import logging
from typing import NamedTuple

logger = logging.getLogger(__name__)


class SliceGeometry(NamedTuple):
    hosts: int
    chips_per_host: int
    topology: str


_GEOMETRIES = {
    # v5e (v5litepod): 8 chips/host up to one host; 4 chips/host multi-host
    "v5litepod-1": SliceGeometry(1, 1, "1x1"),
    "v5litepod-4": SliceGeometry(1, 4, "2x2"),
    "v5litepod-8": SliceGeometry(1, 8, "2x4"),
    "v5litepod-16": SliceGeometry(4, 4, "4x4"),
    "v5litepod-32": SliceGeometry(8, 4, "4x8"),
    "v5litepod-64": SliceGeometry(16, 4, "8x8"),
    "v5litepod-128": SliceGeometry(32, 4, "8x16"),
    "v5litepod-256": SliceGeometry(64, 4, "16x16"),
    # v4: 4 chips/host
    "v4-8": SliceGeometry(1, 4, "2x2x1"),
    "v4-16": SliceGeometry(2, 4, "2x2x2"),
    "v4-32": SliceGeometry(4, 4, "2x2x4"),
    "v4-64": SliceGeometry(8, 4, "2x4x4"),
    "v4-128": SliceGeometry(16, 4, "4x4x4"),
    # v5p: 4 chips/host
    "v5p-8": SliceGeometry(1, 4, "2x2x1"),
    "v5p-16": SliceGeometry(2, 4, "2x2x2"),
    "v5p-32": SliceGeometry(4, 4, "2x2x4"),
}

DEFAULT_GEOMETRY = SliceGeometry(1, 4, "2x2")

# GKE nodeSelector label value per accelerator family.
_GKE_ACCELERATOR_LABELS = {
    "v5litepod": "tpu-v5-lite-podslice",
    "v5p": "tpu-v5p-slice",
    "v4": "tpu-v4-podslice",
}

#: the GKE node label of the card the port's builder pods ask for
#: (``cloud.google.com/gke-accelerator``)
GKE_GPU_LABEL = "nvidia-h100-80gb"


def gke_accelerator_label(accelerator_type: str) -> str:
    """The ``cloud.google.com/gke-tpu-accelerator`` value for a type."""
    family = accelerator_type.rsplit("-", 1)[0]
    return _GKE_ACCELERATOR_LABELS.get(family, family)


def slice_geometry(accelerator_type: str) -> SliceGeometry:
    """Geometry for an accelerator type string (e.g. ``v5litepod-16``)."""
    geometry = _GEOMETRIES.get(accelerator_type)
    if geometry is None:
        logger.warning(
            "Unknown accelerator type %r; defaulting to %s",
            accelerator_type,
            DEFAULT_GEOMETRY,
        )
        return DEFAULT_GEOMETRY
    return geometry
