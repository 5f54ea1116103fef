"""
The serving plane's machinery: the row and member ladders, the per-member
circuit breakers (which the streaming plane also quarantines through),
and the cross-request micro-batching engine with its precision ladder
(``GORDO_TPU_BATCHING``, default off: the unbatched path is the default).
"""

from .batcher import (
    BatcherStopped,
    BatchItem,
    BatchShedError,
    DeadlineExceeded,
    MicroBatcher,
    QueueFullError,
    clone_exception,
)
from .breaker import BreakerBoard, BreakerConfig, MemberQuarantined, ServeDeviceError

__all__ = [
    "BatchItem",
    "BatchShedError",
    "BatcherStopped",
    "BreakerBoard",
    "BreakerConfig",
    "DeadlineExceeded",
    "MemberQuarantined",
    "MicroBatcher",
    "QueueFullError",
    "ServeDeviceError",
    "clone_exception",
]
