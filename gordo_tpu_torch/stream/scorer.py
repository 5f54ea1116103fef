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

Each flush is one ``stream_score`` span of the serving trace: rows,
windows and shed rows, each machine's ingest-to-scored lag (p50, max, a
rows-weighted histogram), the ``predicted_device_ms`` of its spec groups
(the cost model of the table ``GORDO_TPU_PERFMODEL_TABLE`` names, else
the analytic one; ``planner/costmodel.py``) beside the measured ``device_ms``
(the K2 launch and the copy back), and links to the ``stream_ingest``
spans it drained; then a ``stream_emit`` span times the events. The
flush feeds the app's health ledger (rows, residual mean and a request a
machine, one snapshot a flush) and, once a lifecycle supervisor attached
its drift monitor (``StreamPlane.attach_drift``), the monitor's
statistics (``observe_scores``, duck-typed: this package never imports
the lifecycle).
"""

import logging
import os
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from ..planner.costmodel import CostModel, load_table_safe
from ..serve.breaker import BreakerBoard
from ..serve.ladder import snap_rows
from ..telemetry import serving as serve_trace
from ..utils.env import env_str
from ..utils.faults import fault_point
from .events import StreamEvent
from .session import StreamSession
from .telemetry import StreamTelemetry, lag_bucket_counts

logger = logging.getLogger(__name__)

#: breaker spec key for a member whose spec could not be resolved (its
#: model did not load): it still gets a working breaker
FALLBACK_SPEC = "stream"

#: failures that are the client's data, not the member's health
CLIENT_ERRORS = (ValueError, TypeError, FileNotFoundError)


class WindowScorer:
    """Cut and score the watermark windows of one session's flush."""

    def __init__(self, window_rows: int, store: Any, board: BreakerBoard, telemetry: StreamTelemetry,
                 ledger: Optional[Callable[[], Any]] = None, drift_monitor: Optional[Any] = None):
        self.window_rows = max(1, int(window_rows))
        self.store = store
        self.board = board
        self.telemetry = telemetry
        #: a zero-argument callable answering the health ledger (None: no feed)
        self.ledger = ledger
        #: a lifecycle ``DriftMonitor`` the flushes feed (None: no feed)
        self.drift_monitor = drift_monitor
        #: (spec, members, rows) -> predicted device ms of one spec group
        self._step_predictions: Dict[Any, float] = {}

    @staticmethod
    def _spec_for(fleet: Any, name: str) -> Any:
        try:
            fleet.model(name)  # loaded and bucketed
            spec = fleet.loaded_specs().get(name)
        except Exception:  # noqa: BLE001 - an unloadable member still gets a breaker key
            spec = None
        return spec if spec is not None else FALLBACK_SPEC

    def _predicted_step_ms(self, spec: Any, members: int, rows: int) -> float:
        """The cost model's device ms of one f32 spec group at this shape,
        through the table ``GORDO_TPU_PERFMODEL_TABLE`` names (a bad one
        degrades to the analytic defaults), cached by shape; -1.0 when the
        estimate fails."""
        key = (spec, members, rows)
        cached = self._step_predictions.get(key)
        if cached is None:
            try:
                model = CostModel(load_table_safe(env_str("GORDO_TPU_PERFMODEL_TABLE", None)))
                cached = round(model.predict_serve_step_s(spec, members, rows, "f32") * 1000.0, 4)
            except Exception:  # noqa: BLE001 - a prediction is telemetry, never the flush's problem
                cached = -1.0
            if len(self._step_predictions) > 4096:
                self._step_predictions.clear()
            self._step_predictions[key] = cached
        return cached

    def _predicted_flush_ms(self, specs: Dict[str, Any], inputs: Dict[str, np.ndarray]) -> float:
        """The predicted device ms of the flush: one forward a spec group at
        its members and tallest rows, summed; -1.0 when no member's spec is
        known or a group's estimate failed."""
        groups: Dict[Any, List[int]] = {}
        for name, rows in inputs.items():
            spec = specs.get(name)
            if spec is not None and not isinstance(spec, str):
                groups.setdefault(spec, []).append(int(len(rows)))
        total = 0.0
        for spec, rows in groups.items():
            predicted = self._predicted_step_ms(spec, len(rows), max(rows))
            if predicted < 0.0:
                return -1.0
            total += predicted
        return round(total, 4) if groups else -1.0

    def flush(self, session: StreamSession) -> Dict[str, Any]:
        """Score every full pending window of ``session``; returns the
        flush summary the ingest ack carries (``scored``, ``errors`` and
        ``quarantined`` machine maps, total ``rows`` scored)."""
        summary: Dict[str, Any] = {"scored": {}, "errors": {}, "quarantined": {}, "rows": 0}
        # pinned once: every window below scores against this revision
        routed = self.store.route(session.collection_dir)
        fleet = self.store.fleet(routed)
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

        recorder = serve_trace.serve_recorder()
        shed_rows = session.shed_delta()
        attributes: Dict[str, Any] = {}
        if recorder.enabled:  # with telemetry off the flush builds no attribute
            lag_values = sorted(lags_ms.values())
            cut_names = list(spans)
            cut_weights = [spans[n][1] - spans[n][0] + 1 for n in cut_names]
            attributes = dict(
                stream=session.stream_id,
                machines=len(inputs),
                rows=sum(int(len(x)) for x in inputs.values()),
                windows=sum(spans[n][2] for n in cut_names),
                shed=shed_rows,
                revision=revision,
                lag_p50_ms=lag_values[len(lag_values) // 2] if lag_values else 0.0,
                lag_max_ms=lag_values[-1] if lag_values else 0.0,
                lag_hist=lag_bucket_counts([lags_ms[n] for n in cut_names], weights=cut_weights),
                lag_sum_ms=round(sum(lags_ms[n] * w for n, w in zip(cut_names, cut_weights)), 3),
                predicted_device_ms=self._predicted_flush_ms(specs, inputs),
            )
        with recorder.span("stream_score", **attributes) as score_span:
            for trace_id, ingest_span_id in session.drain_ingest_spans():
                score_span.link(trace_id, ingest_span_id)
            device_started = time.monotonic()
            # one K2 launch a spec bucket, the copy back inside: device_ms holds the launch
            scores, errors = fleet.fleet_scores(inputs) if inputs else ({}, {})
            if recorder.enabled:
                score_span.set(
                    device_ms=round((time.monotonic() - device_started) * 1000.0, 3),
                    rows_scored=sum(int(len(inputs[n])) for n in scores),
                    rows_failed=sum(spans[n][1] - spans[n][0] + 1 for n in set(errors) | set(injected)),
                )
        errors.update(injected)

        emit_started = time.monotonic()
        events_emitted = 0

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
                events_emitted += 1
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
            events_emitted += 1
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
            events_emitted += 1
            summary["errors"][name] = type(exc).__name__

        recorder.record("stream_emit", max(0.0, time.monotonic() - emit_started), stream=session.stream_id,
                        events=events_emitted, machines=len(scores) + len(errors))
        self.telemetry.observe_flush(
            max(0.0, time.time() - flush_started),
            rows_scored=summary["rows"],
            rows_failed=failed_rows,
            rows_shed=shed_rows,
            lags_ms=[lags_ms.get(n, 0.0) for n in scores],
            lag_weights=[summary["scored"][n] for n in scores],
        )
        self._feed_ledger(inputs, scores, errors)
        self._feed_drift(inputs, scores)
        return summary

    def _feed_ledger(self, frames: Dict[str, np.ndarray], scores: Dict[str, Tuple[Any, Any]],
                     errors: Dict[str, BaseException]) -> None:
        """The flush into the health ledger
        (:meth:`~gordo_tpu_torch.telemetry.fleet_health.FleetHealthLedger.record_scored`)."""
        if self.ledger is None:
            return
        try:
            self.ledger().record_scored({name: len(rows) for name, rows in frames.items()}, scores, errors,
                                        CLIENT_ERRORS)
        except Exception:  # noqa: BLE001 - health telemetry is advisory
            logger.debug("stream health not recorded", exc_info=True)

    def _feed_drift(self, frames: Dict[str, np.ndarray], scores: Dict[str, Tuple[Any, Any]]) -> None:
        monitor = self.drift_monitor
        if monitor is None or not frames:
            return
        try:
            monitor.observe_scores(frames, scores)
        except Exception:  # noqa: BLE001 - drift statistics are advisory
            logger.debug("stream drift feed failed", exc_info=True)
