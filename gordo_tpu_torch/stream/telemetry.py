"""
The streaming plane's counters and its flush and lag histograms, a copy
of ``gordo_tpu/stream/telemetry.py``'s accumulator. Each plane owns one
(the JAX package keeps a process-global one); ``/stream/status`` reads
its snapshot, and the fleet-status document's ``stream`` section its
percentiles (``telemetry/aggregate.py``'s ``histogram_percentile``, whose
buckets, ``LATENCY_BUCKETS_MS``, these are). No per-machine detail here:
that is on the sessions. :func:`lag_bucket_counts` is the compact lag
distribution each ``stream_score`` span carries.
"""

import threading
from typing import Any, Dict, List, Optional, Sequence

from ..telemetry.aggregate import LATENCY_BUCKETS_MS


def lag_bucket_counts(lags_ms: Sequence[float], weights: Optional[Sequence[int]] = None) -> List[int]:
    """``lags_ms`` (weighted by rows when ``weights`` are given) in the
    fixed buckets, the last slot the overflow.

    >>> lag_bucket_counts([0.5, 3.0, 1e6], [2, 1, 1])[:3], lag_bucket_counts([1e6])[-1]
    ([2, 0, 1], 1)
    """
    counts = [0] * (len(LATENCY_BUCKETS_MS) + 1)
    for i, value in enumerate(lags_ms):
        slot = len(LATENCY_BUCKETS_MS)
        for j, edge in enumerate(LATENCY_BUCKETS_MS):
            if value <= edge:
                slot = j
                break
        counts[slot] += int(weights[i]) if weights is not None else 1
    return counts


class _Histogram:
    """Fixed-bucket histogram (count, sum and an overflow slot), guarded
    by the owning accumulator's lock."""

    __slots__ = ("edges", "counts", "count", "sum_value")

    def __init__(self, edges: Sequence[float]):
        self.edges = list(edges)
        self.counts = [0] * (len(self.edges) + 1)
        self.count = 0
        self.sum_value = 0.0

    def add(self, value: float, weight: int = 1) -> None:
        slot = len(self.edges)
        for i, edge in enumerate(self.edges):
            if value <= edge:
                slot = i
                break
        self.counts[slot] += weight
        self.count += weight
        self.sum_value += value * weight

    def snapshot(self) -> Dict[str, Any]:
        return {
            "buckets_ms": list(self.edges),
            "counts": list(self.counts),
            "count": self.count,
            "sum_ms": round(self.sum_value, 3),
        }


class StreamTelemetry:
    """Counters and histograms of one plane."""

    def __init__(self):
        self._lock = threading.Lock()
        self.rows_in = 0
        self.rows_scored = 0
        self.rows_failed = 0
        self.rows_shed = 0
        self.flushes = 0
        self.ingest_batches = 0
        self._flush_ms = _Histogram(LATENCY_BUCKETS_MS)
        self._lag_ms = _Histogram(LATENCY_BUCKETS_MS)

    def observe_ingest(self, rows: int) -> None:
        """One ingest batch of ``rows`` accepted rows."""
        with self._lock:
            self.rows_in += int(rows)
            self.ingest_batches += 1

    def observe_flush(
        self,
        duration_s: float,
        rows_scored: int,
        rows_failed: int,
        rows_shed: int,
        lags_ms: Sequence[float] = (),
        lag_weights: Optional[Sequence[int]] = None,
    ) -> None:
        """One watermark flush: its wall duration, the row accounting, and
        each scored machine's ingest-to-scored lag (weighted by its rows
        when weights are given)."""
        with self._lock:
            self.flushes += 1
            self.rows_scored += int(rows_scored)
            self.rows_failed += int(rows_failed)
            self.rows_shed += int(rows_shed)
            self._flush_ms.add(duration_s * 1000.0)
            for i, lag in enumerate(lags_ms):
                self._lag_ms.add(float(lag), int(lag_weights[i]) if lag_weights is not None else 1)

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "rows_in": self.rows_in,
                "rows_scored": self.rows_scored,
                "rows_failed": self.rows_failed,
                "rows_shed": self.rows_shed,
                "flushes": self.flushes,
                "ingest_batches": self.ingest_batches,
                "flush_ms": self._flush_ms.snapshot(),
                "lag_ms": self._lag_ms.snapshot(),
            }
