"""
Watermark-triggered window scoring, a copy of
``gordo_tpu/stream/scorer.py``'s ``WindowScorer.flush``.

Every ingest that brings a machine to the watermark (``window_rows``
buffered rows) flushes here: the full windows are cut from the rings and
scored as one fused call, ``RevisionFleet.fleet_scores``, which is one
K2 launch per spec bucket (the forward and each row's error, fused).
Each machine's result becomes an ``anomaly`` event with its exact
``(first_seq, last_seq)`` row span and the revision that scored it.

- The fleet is pinned once per flush, so every window of a flush scores
  against one revision.
- A member whose breaker is open is not cut: its rows stay buffered (and
  shed oldest-first under pressure), one ``quarantined`` frame says so,
  and the other machines keep scoring. After the cooldown the next flush
  admits it as the probe; success emits ``recovered``.
- A scoring failure (the ``stream_score`` fault site included) costs that
  machine's span: an ``error`` frame and failed rows; a server-side cause
  also marks the breaker. Client-data failures (``ValueError``,
  ``TypeError``, ``FileNotFoundError``) do not.

Left out, as telemetry and lifecycle work: the recorder spans and their
links, the cost model's predicted device time, and the health-ledger and
drift feeds.
"""

import logging
import os
import time
from typing import Any, Dict, Tuple

import numpy as np

from ..serve.breaker import BreakerBoard
from ..serve.ladder import snap_rows
from ..utils.faults import fault_point
from .events import StreamEvent
from .session import StreamSession
from .telemetry import StreamTelemetry

logger = logging.getLogger(__name__)

#: breaker spec key for a member whose spec could not be resolved (its
#: model did not load): it still gets a working breaker
FALLBACK_SPEC = "stream"

#: failures that are the client's data, not the member's health
CLIENT_ERRORS = (ValueError, TypeError, FileNotFoundError)


class WindowScorer:
    """Cut and score the watermark windows of one session's flush."""

    def __init__(self, window_rows: int, store: Any, board: BreakerBoard, telemetry: StreamTelemetry):
        self.window_rows = max(1, int(window_rows))
        self.store = store
        self.board = board
        self.telemetry = telemetry

    @staticmethod
    def _spec_for(fleet: Any, name: str) -> Any:
        try:
            fleet.model(name)  # loaded and bucketed
            spec = fleet.loaded_specs().get(name)
        except Exception:  # noqa: BLE001 - an unloadable member still gets a breaker key
            spec = None
        return spec if spec is not None else FALLBACK_SPEC

    def flush(self, session: StreamSession) -> Dict[str, Any]:
        """Score every full pending window of ``session``; returns the
        flush summary the ingest ack carries (``scored``, ``errors`` and
        ``quarantined`` machine maps, total ``rows`` scored)."""
        summary: Dict[str, Any] = {"scored": {}, "errors": {}, "quarantined": {}, "rows": 0}
        # pinned once: every window below scores against this revision
        routed = self.store.route(session.collection_dir)
        fleet = self.store.fleet()
        revision = os.path.basename(os.path.normpath(routed))
        board = self.board

        # the breaker gate comes before the cut: a quarantined member's
        # rows stay in its ring
        quarantined: Dict[str, float] = {}
        specs: Dict[str, Any] = {}
        for name in session.pending_machines(self.window_rows):
            spec = specs[name] = self._spec_for(fleet, name)
            retry_after = board.quarantined(fleet, spec, name)
            if retry_after is not None:
                quarantined[name] = retry_after
                chan = session.channel(name)
                if not chan.quarantine_notified:
                    chan.quarantine_notified = True
                    session.emit(StreamEvent("quarantined", {"machine": name, "retry_after_s": round(retry_after, 3)}))
        summary["quarantined"] = {name: round(retry, 3) for name, retry in quarantined.items()}

        flush_started = time.time()
        # a multi-window backlog snaps onto the row ladder; the remainder
        # stays buffered for the next flush
        cut = session.cut_windows(
            self.window_rows,
            skip=tuple(quarantined),
            snap=lambda pending: snap_rows(pending, self.window_rows),
        )
        if not cut:
            return summary

        inputs: Dict[str, np.ndarray] = {}
        spans: Dict[str, Tuple[int, int, int]] = {}
        injected: Dict[str, BaseException] = {}
        lags_ms: Dict[str, float] = {}
        for name, (chunks, first_seq, last_seq, windows, oldest_ts) in cut.items():
            spans[name] = (first_seq, last_seq, windows)
            # the span's ingest-to-scored lag, from its oldest row
            lags_ms[name] = round(max(0.0, flush_started - oldest_ts) * 1000.0, 3)
            try:
                fault_point("stream_score", f"{session.stream_id}:{name}")
                inputs[name] = np.concatenate([chunk.values for chunk in chunks])
            except Exception as exc:  # noqa: BLE001 - this member's failure alone
                injected[name] = exc

        shed_rows = session.shed_delta()
        scores, errors = fleet.fleet_scores(inputs) if inputs else ({}, {})
        errors.update(injected)

        for name, (_reconstruction, mse) in scores.items():
            first_seq, last_seq, windows = spans[name]
            rows = int(len(inputs[name]))
            residuals = np.asarray(mse, dtype=float).ravel()
            finite = residuals[np.isfinite(residuals)]
            chan = session.channel(name)
            chan.rows_scored += rows
            chan.windows_scored += windows
            chan.last_score_lag_ms = lags_ms.get(name)
            board.record_success(fleet, specs.get(name, FALLBACK_SPEC), name)
            if chan.quarantine_notified:
                chan.quarantine_notified = False
                session.emit(StreamEvent("recovered", {"machine": name}))
            session.emit(
                StreamEvent(
                    "anomaly",
                    {
                        "machine": name,
                        "first_seq": first_seq,
                        "last_seq": last_seq,
                        "rows": rows,
                        "windows": windows,
                        "mse_mean": float(finite.mean()) if len(finite) else None,
                        "mse_max": float(finite.max()) if len(finite) else None,
                        "revision": revision,
                    },
                )
            )
            summary["scored"][name] = rows
            summary["rows"] += rows

        failed_rows = 0
        for name, exc in errors.items():
            first_seq, last_seq, _windows = spans[name]
            rows = last_seq - first_seq + 1
            chan = session.channel(name)
            chan.score_errors += 1
            chan.rows_failed += rows
            failed_rows += rows
            if not isinstance(exc, CLIENT_ERRORS):
                board.record_failure(fleet, specs.get(name, FALLBACK_SPEC), name, exc)
            session.emit(
                StreamEvent(
                    "error",
                    {"machine": name, "first_seq": first_seq, "last_seq": last_seq, "error": type(exc).__name__},
                )
            )
            summary["errors"][name] = type(exc).__name__

        self.telemetry.observe_flush(
            max(0.0, time.time() - flush_started),
            rows_scored=summary["rows"],
            rows_failed=failed_rows,
            rows_shed=shed_rows,
            lags_ms=[lags_ms.get(n, 0.0) for n in scores],
            lag_weights=[summary["scored"][n] for n in scores],
        )
        return summary
