"""
The serving engine, a copy of ``gordo_tpu/serve/engine.py``: concurrent
single-model requests coalesced into one fused forward a batch.

:class:`ServeEngine` owns a :class:`~gordo_tpu_torch.serve.batcher.MicroBatcher`
keyed by ``(revision fleet, spec, row rung, precision)``:

- **request thread** (:meth:`ServeEngine.batched_predict`): the breaker
  first (503), then the row rung and the precision (the parity gate), then
  the request's payload queued as it came: its decoded wire columns
  (``ingest.RawColumns``) or its matrix;
- **dispatcher** (``_run_batch``): the live riders' payloads staged by
  ``ingest.stage`` into one ``[members, rung, F]`` host buffer, pinned on
  a card (over the dlpack rung when their columns allow,
  ``gordo_tpu/serve/engine.py:747-806``), and copied to the device
  once, one K1 gather launch with the bucket's
  ``indices`` and ingest plan at f32 (the plain bf16/int8 forward at
  reduced precision), one copy back, and each rider's rows handed back
  through its future.

The port launches exactly the live members: a hand kernel has no compile
cache to bound, so the JAX engine's power-of-two member padding
(repeating ``indices[0]``) is left out; :meth:`stats` reports the padded
count the JAX engine would have launched. Every request queues its raw
rows, at every precision: the bucket's ingest plan (the pipeline's
affine scaling) runs on the device, in the launch at f32. A rider of a
host-transformed bucket (a member's pipeline is not affine) is
transformed on its request thread before it queues, and its batch runs
without the prologue (``gordo_tpu/serve/engine.py:340-370``): whether
rows are host-transformed is part of the batch key, so a batch never
mixes them with raw rows, and ``ingest_batches`` counts only batches run
with the prologue.

Failures are contained as there: a device error of a batch bisects it;
a member that fails alone degrades a reduced-precision bucket to f32 and
retries, else records a failure on its breaker and answers 500 while its
riders answer 200; an out-of-memory demotes the ladder rung it struck
(and frees the caching allocator's blocks); a non-finite output from
finite input is the member's failure. On a card, the errors bisected
are the synchronous ones (an out-of-memory, a refused launch, an
injected fault); a CUDA error the runtime reports as sticky (an illegal
address, a launch failure) leaves the context unusable, so its batch
answers 500 without a bisection and the log says so.

Requests the engine cannot batch (not feedforward, an empty or too tall
request, rows of the wrong width, a draining batcher) answer None from
:meth:`batched_predict`, and the caller scores them unbatched.

Each batch is a ``serve_batch`` span of the serving trace
(``telemetry/serving.py``) with ``stack``, ``device`` and ``scatter``
children, linked to the request span of every sampled rider; a request
that is not sampled is not linked (its span is not exported). Each rider
gets its share back (``queue_wait``, ``batch_stack``, ``batch_device``
with the copy back, ``batch_scatter``, and ``device_ingest``, the rows'
copy to the device, for a batch with the ingest prologue), which the
request records into its ``Server-Timing``. ``padded_members`` on the
spans is what the JAX engine would launch (the port launches
``coalesced``); ``predicted_device_ms`` is the engine's cost model's
(:meth:`ServeEngine._cost_model`) for the span's ``padded_members`` x
``padded_rows``, the features a learned model regresses on. Bisections, isolated
members, degraded buckets, demoted rungs and breaker transitions are
events; each breaker transition also goes to the app's health ledger
(``ledger``, a zero-argument callable; an engine without one feeds no
ledger).

``metrics`` is the engine's Prometheus sink
(``server/prometheus/metrics.py::ServeMetrics``, set by ``build_app`` under
``ENABLE_PROMETHEUS``; None: nothing observed), called where the JAX engine
calls it: each batch's size, coalesce ratio and padding waste (read
against ``padded_members``, as the batch span's), each shed by reason, the
queue depth, each breaker transition and the open members. A failing sink
is ignored.

The learned performance model's consumers (``gordo_tpu/serve/engine.py``,
each knob off by default, each falling back to the behaviour without the
model when the model cannot answer):

- ``GORDO_TPU_PERFMODEL_TABLE``: the ``cost_table.json`` the engine's
  one cost model is built from (:meth:`ServeEngine._cost_model`), for its
  batch spans' predictions and every consumer below;
- ``GORDO_TPU_PERFMODEL_BATCH_CAP_BYTES``: the tallest row rung whose
  predicted fused batch (the full member ladder) fits the budget; a taller
  request serves unbatched (:meth:`ServeEngine._model_row_cap`, merged
  with the out-of-memory cap as a min);
- ``GORDO_TPU_PERFMODEL_BREAKER`` (``_BREAKER_SAFETY``, default 0.8): an
  out-of-memory demotes to the largest lower rung predicted to fit under
  that share of the failed shape's bytes (:meth:`ServeEngine._hbm_aware_cap`;
  the event's ``model_informed``);
- ``GORDO_TPU_PERFMODEL_WARMUP``: warmup runs the specs predicted
  costliest first, ``repr`` breaking ties;
- ``GORDO_TPU_PERFMODEL_PRECISION``: a spec with no pinned precision
  serves at the rung the learned model nominates
  (``precision.model_preferred``), on the request path and in warmup.

None of them is consulted around a launch: a prediction that fails falls
back to the analytic ruler or to the fixed heuristic, never to the CPU.
"""

import logging
import re
import threading
import time
from concurrent.futures import CancelledError
from concurrent.futures import TimeoutError as FutureTimeoutError
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..ingest import RawColumns, compiled_enabled, dlpack_enabled, ingest_stats, stage, staging_buffer
from ..models.estimators import find_estimator
from ..models.spec import FeedForwardSpec
from ..planner.costmodel import CostModel, load_table_safe, spec_flops_per_sample
from ..telemetry.serving import serve_recorder
from ..utils.env import env_bool, env_float, env_int, env_str
from ..utils.faults import FaultInjected, fault_point
from . import ladder, precision
from .batcher import BatcherStopped, BatchItem, DeadlineExceeded, MicroBatcher
from .breaker import BreakerBoard, MemberQuarantined, ServeDeviceError

logger = logging.getLogger(__name__)

BATCHING_ENV = "GORDO_TPU_BATCHING"

#: the learned performance model's consumer knobs (``engine.py:62-68``)
PERFMODEL_TABLE_ENV = "GORDO_TPU_PERFMODEL_TABLE"
PERFMODEL_WARMUP_ENV = "GORDO_TPU_PERFMODEL_WARMUP"
PERFMODEL_CAP_ENV = "GORDO_TPU_PERFMODEL_BATCH_CAP_BYTES"
PERFMODEL_BREAKER_ENV = "GORDO_TPU_PERFMODEL_BREAKER"
PERFMODEL_BREAKER_SAFETY_ENV = "GORDO_TPU_PERFMODEL_BREAKER_SAFETY"

#: CUDA errors that the runtime reports as sticky: the context is lost,
#: and no retry on it can succeed
_STICKY_CUDA = re.compile(
    r"illegal memory access|illegal address|illegal instruction|misaligned address|unspecified launch failure"
    r"|device-side assert|launch timed out|hardware stack error|invalid program counter|uncorrectable ECC"
    r"|invalid address space",
    re.IGNORECASE,
)


def batching_enabled() -> bool:
    """The switch: batching is opt-in (``GORDO_TPU_BATCHING=1``)."""
    return env_bool(BATCHING_ENV, False)


def is_sticky_device_error(exc: BaseException) -> bool:
    """True for a CUDA error that leaves the context unusable.

    >>> is_sticky_device_error(RuntimeError("CUDA error: an illegal memory access was encountered"))
    True
    >>> is_sticky_device_error(torch.cuda.OutOfMemoryError("CUDA out of memory"))
    False
    """
    return isinstance(exc, RuntimeError) and not isinstance(exc, torch.cuda.OutOfMemoryError) and bool(
        _STICKY_CUDA.search(str(exc)))


def is_out_of_memory(exc: BaseException) -> bool:
    """The card's out-of-memory, or a failure that says
    ``RESOURCE_EXHAUSTED`` (the JAX package's word, which injected faults
    carry)."""
    return isinstance(exc, torch.cuda.OutOfMemoryError) or "RESOURCE_EXHAUSTED" in str(exc)


class ServeConfig:
    """Engine knobs, read once from the environment at creation; the same
    names and defaults as the JAX engine's."""

    __slots__ = (
        "max_size",
        "max_delay_s",
        "queue_depth",
        "deadline_s",
        "dispatchers",
        "row_ladder",
        "warmup_max_rows",
        "inline_flush",
        "precision",
        "finite_check",
    )

    def __init__(
        self,
        max_size: int = 32,
        max_delay_ms: float = 5.0,
        queue_depth: int = 512,
        deadline_ms: float = 2000.0,
        dispatchers: int = 1,
        row_ladder: Optional[Tuple[int, ...]] = None,
        warmup_max_rows: int = 512,
        inline_flush: bool = True,
        serve_precision: str = "",
        finite_check: bool = True,
    ):
        self.max_size = max(1, int(max_size))
        self.max_delay_s = max(0.0, float(max_delay_ms) / 1000.0)
        self.queue_depth = max(1, int(queue_depth))
        self.deadline_s = max(0.001, float(deadline_ms) / 1000.0)
        self.dispatchers = max(1, int(dispatchers))
        self.row_ladder = tuple(row_ladder) if row_ladder is not None else ladder.row_ladder()
        self.warmup_max_rows = int(warmup_max_rows)
        self.inline_flush = bool(inline_flush)
        #: scan each batch's output for non-finite rows: a member that gives
        #: them for finite input is poisoned and fails alone
        self.finite_check = bool(finite_check)
        #: the default serving precision ("" reads GORDO_TPU_SERVE_PRECISION);
        #: a spec's own precision field wins per request
        self.precision = precision.normalize(serve_precision) if serve_precision else precision.serve_precision()

    @classmethod
    def from_env(cls) -> "ServeConfig":
        return cls(
            max_size=env_int("GORDO_TPU_BATCH_MAX_SIZE", 32),
            max_delay_ms=env_float("GORDO_TPU_BATCH_MAX_DELAY_MS", 5.0),
            queue_depth=env_int("GORDO_TPU_BATCH_QUEUE_DEPTH", 512),
            deadline_ms=env_float("GORDO_TPU_BATCH_DEADLINE_MS", 2000.0),
            dispatchers=env_int("GORDO_TPU_BATCH_DISPATCHERS", 1),
            warmup_max_rows=env_int("GORDO_TPU_SERVE_WARMUP_ROWS", 512),
            inline_flush=env_bool("GORDO_TPU_BATCH_INLINE_FLUSH", True),
            serve_precision=env_str(precision.PRECISION_ENV, "") or "",
            finite_check=env_bool("GORDO_TPU_SERVE_FINITE_CHECK", True),
        )


class ServeEngine:
    """The micro-batching scheduler over one app's ``FleetModelStore``."""

    def __init__(self, store: Any, config: Optional[ServeConfig] = None,
                 ledger: Optional[Callable[[], Any]] = None):
        self.store = store
        self.config = config or ServeConfig.from_env()
        #: answers the health ledger the breaker transitions go to (None: no feed)
        self.ledger = ledger
        #: the Prometheus sink (``ServeMetrics``), duck-typed; None: no metrics
        self.metrics: Any = None
        self.member_ladder = ladder.member_ladder(self.config.max_size)
        #: gate-then-serve; a failed gate serves f32
        self.governor = precision.PrecisionGovernor()
        #: per-(fleet, spec, member) breakers and the precision degrade set
        self.breakers = BreakerBoard(on_transition=self._on_breaker_transition)
        self._lock = threading.Lock()
        #: (spec, route, members, padded members, rows, precision) of every
        #: forward run, for :meth:`program_shapes`
        self._programs: set = set()
        #: (spec, precision) -> member and row caps after an out-of-memory
        self._member_caps: Dict[Tuple, int] = {}
        self._row_caps: Dict[Tuple, int] = {}
        self._counters: Dict[str, int] = {
            "requests": 0,  # batched_predict calls that queued
            "fallback": 0,  # calls answered None
            "batches": 0,  # drained batches scored
            "launches": 0,  # fused forwards run (bisection runs several a batch)
            "coalesced": 0,  # requests scored in batches
            "padded_members": 0,  # members the JAX engine would have launched
            "shed_queue_full": 0,
            "shed_deadline": 0,
            "warmup_programs": 0,
            "precision_degraded": 0,  # requests served f32 instead
            "device_errors": 0,  # forwards that raised device errors
            "sticky_device_errors": 0,  # of them, CUDA errors that lose the context
            "batch_bisects": 0,
            "members_isolated": 0,  # failures pinned on one member
            "nonfinite_outputs": 0,
            "breaker_rejects": 0,  # requests answered 503
            "breaker_trips": 0,
            "rung_demotions": 0,  # ladder rungs dropped after an out-of-memory
            "oom_fallbacks": 0,  # single-member out-of-memory sent unbatched
            "ingest_batches": 0,  # batches run with the ingest prologue
        }
        self._precision_counters: Dict[str, int] = {}
        #: (spec, members, rows, precision) -> the cost model's device ms
        self._step_predictions: Dict[Tuple, float] = {}
        #: the engine's one cost model (:meth:`_cost_model`), built on first use
        self._cost_model_cache: Optional[CostModel] = None
        #: (spec, precision) -> the predicted-HBM row cap (None: uncapped)
        self._model_row_caps: Dict[Tuple, Optional[int]] = {}
        self._batcher = MicroBatcher(
            self._run_batch,
            max_size=self.config.max_size,
            max_delay_s=self.config.max_delay_s,
            queue_depth=self.config.queue_depth,
            dispatchers=self.config.dispatchers,
            inline_flush=self.config.inline_flush,
            retry_after_s=max(1.0, self.config.max_delay_s * 4),
            on_shed=self._on_shed,
            on_depth=self._on_depth,
        )

    @property
    def _recorder(self) -> Any:
        # the process-shared serving recorder, read at each use: the batch
        # spans land in the trace the request spans they link to go to
        return serve_recorder()

    # -- request path ---------------------------------------------------------

    def eligible_spec(self, fleet: Any, name: str) -> Optional[FeedForwardSpec]:
        """The spec this request batches under, or None: feedforward only
        (an LSTM's windowed forward stays unbatched)."""
        spec = fleet.loaded_specs().get(name)
        return spec if isinstance(spec, FeedForwardSpec) else None

    def batched_predict(self, fleet: Any, name: str, model: Any, X: Any, timing: Any = None) -> Optional[np.ndarray]:
        """One request's reconstruction rows by ``fleet`` (the request's
        revision) through the batcher, or None when the request is not
        batchable (the caller scores it itself). ``timing`` is the
        request's recorder: a sampled request's span is linked from its
        batch's span, and its share of the batch is recorded on it.
        ``X`` is a matrix or the request's decoded wire columns
        (``ingest.RawColumns``, ``gordo_tpu/serve/engine.py:255-263``): the
        item queues them as they are, and the dispatcher stages them.

        Raises :class:`~gordo_tpu_torch.serve.QueueFullError` (429) when
        admission refuses it, :class:`MemberQuarantined` (503) when its
        breaker is open, :class:`ServeDeviceError` (500) when its member
        failed alone, and :class:`DeadlineExceeded` (504) when its batch
        missed the deadline."""
        spec = self.eligible_spec(fleet, name)
        if spec is None or find_estimator(model) is None:
            self._count("fallback")
            return None
        # the breaker first: a quarantined member answers 503 before queueing
        retry_after = self.breakers.quarantined(fleet, spec, name)
        if retry_after is not None:
            self._count("breaker_rejects")
            raise MemberQuarantined(name, retry_after)
        if isinstance(X, RawColumns):
            raw, shape = X, (X.rows, X.width)
        else:
            X = np.asarray(X)
            raw, shape = None, X.shape
        rows = int(shape[0])
        padded_rows = ladder.pad_to(rows, self.config.row_ladder)
        if rows == 0 or padded_rows is None or len(shape) != 2 or shape[1] != spec.n_features:
            # too tall for the ladder, or rows the unbatched path refuses itself
            self._count("fallback")
            return None

        desired = self._desired_precision(spec, padded_rows)
        prec = desired
        if desired != precision.F32:
            if self.breakers.degraded(fleet, spec, desired):
                prec = precision.F32
            else:
                prec = self.governor.effective_precision(fleet, spec, desired, recorder=self._recorder)
            if prec != desired:
                self._count("precision_degraded")

        # a rung that ran out of memory serves unbatched from now on; the
        # predicted-HBM cap on the same axis merges with it as a min
        row_cap = self._row_caps.get((spec, prec))
        model_cap = self._model_row_cap(spec, prec)
        if model_cap is not None and (row_cap is None or model_cap < row_cap):
            row_cap = model_cap
        if row_cap is not None and padded_rows > row_cap:
            self._count("fallback")
            return None

        # a host-transformed bucket's rows go through the member's own
        # pipeline here, on the waiting request thread
        from ..server.fleet_store import host_transform

        host = fleet.host_transformed(spec)
        if host:
            payload = RawColumns.from_matrix(host_transform(model, raw.values() if raw is not None else X))
        else:
            payload = raw if raw is not None else RawColumns.from_matrix(X)
        # the request's trace context rides its item only when the serving
        # trace is on and the request is exported: a link to an unexported
        # span would dangle
        trace = None
        if self._recorder.enabled and timing is not None and getattr(timing, "trace_id", None) \
                and getattr(timing, "sampled", True):
            trace = (timing.trace_id, getattr(timing, "default_parent_id", None))
        item = BatchItem(name, payload, rows=rows, deadline=time.monotonic() + self.config.deadline_s, trace=trace)
        try:
            # precision is part of the key: an f32 and a bf16 request never
            # share a forward (a mixed hot-swap); so is the host transform
            future = self._batcher.submit((fleet, spec, padded_rows, prec, host), item)
        except BatcherStopped:
            self._count("fallback")
            return None
        self._count("requests")
        try:
            recon, meta = future.result(timeout=self.config.deadline_s)
        except FutureTimeoutError:
            future.cancel()
            self._count("shed_deadline")
            raise DeadlineExceeded(f"request missed the {self.config.deadline_s * 1000:.0f}ms batching deadline") \
                from None
        except CancelledError:
            raise DeadlineExceeded("request expired while queued") from None
        if timing is not None:
            for stage, seconds in meta.items():
                timing.record(stage, seconds)
        # None: the member's smallest forward ran out of memory; the caller
        # scores it unbatched
        return recon

    # -- batch execution (dispatcher thread) ----------------------------------

    def _fault_key(self, spec: Any, prec: str, name: str) -> str:
        """The fault sites' key of one rider: ``<spec>:<precision>:<member>``."""
        return f"{type(spec).__name__}:{prec}:{name}"

    def _run_batch(self, key: Tuple, items: List[BatchItem]) -> None:
        fleet, spec, padded_rows, prec, host = key
        recorder = self._recorder
        flush_start = time.monotonic()
        with recorder.span("serve_batch", spec=type(spec).__name__, n_features=spec.n_features, size=len(items),
                           precision=prec) as batch_span:
            with recorder.span("stack"):
                stack_start = time.monotonic()
                names, params, ingest = fleet.serving_bucket(spec, prec)
                if fleet.host_transformed(spec) != host:
                    # the bucket's membership changed its mode after these riders
                    # queued: they score unbatched, in the bucket's present mode
                    for item in items:
                        try:
                            item.future.set_result((None, {}))
                        except Exception:  # noqa: BLE001 - the waiter gave up
                            pass
                    return
                bucket_rows = {n: i for i, n in enumerate(names)}
                live: List[BatchItem] = []
                for item in items:
                    if item.name in bucket_rows:
                        live.append(item)
                        continue
                    try:  # not in the bucket it was queued for
                        item.future.set_exception(KeyError(f"{item.name} left the serving bucket"))
                    except Exception:  # noqa: BLE001 - already resolved
                        pass
                if not live:
                    return
                stack_s = time.monotonic() - stack_start
            members = len(live)
            padded_members = ladder.pad_to(members, self.member_ladder) or members
            results: List[Tuple[BatchItem, np.ndarray]] = []
            failures: List[Tuple[BatchItem, BaseException]] = []
            fallbacks: List[BatchItem] = []
            # the stacking and the copy to the device inside the scoring
            # ladder (bisection runs several forwards) are summed here
            timings = {"stack": 0.0, "device_ingest": 0.0}
            with recorder.span("device", padded_members=padded_members, padded_rows=padded_rows, precision=prec):
                device_start = time.monotonic()
                self._score_live(fleet, spec, prec, padded_rows, live, params, bucket_rows, ingest,
                                 results, failures, fallbacks, timings)
                device_s = time.monotonic() - device_start - timings["stack"] - timings["device_ingest"]
            stack_s += timings["stack"]
            ingest_s = timings["device_ingest"]
            with self._lock:
                self._counters["batches"] += 1
                self._counters["coalesced"] += members
                self._counters["padded_members"] += padded_members
                if ingest is not None:
                    self._counters["ingest_batches"] += 1
                self._precision_counters[prec] = self._precision_counters.get(prec, 0) + members
            scatter_start = time.monotonic()
            with recorder.span("scatter"):
                for item, rows in results:
                    # read per rider: batch_scatter is the loop's own cost so far
                    meta = {
                        "queue_wait": flush_start - item.enqueued_at,
                        "batch_stack": stack_s,
                        "batch_device": device_s,
                        "batch_scatter": time.monotonic() - scatter_start,
                    }
                    if ingest is not None:
                        meta["device_ingest"] = ingest_s
                    try:
                        fault_point("serve_scatter", self._fault_key(spec, prec, item.name))
                        item.future.set_result((rows[: item.rows], meta))
                    except FaultInjected as exc:
                        # one rider's hand-back failure is that rider's alone
                        try:
                            item.future.set_exception(ServeDeviceError(item.name, exc))
                        except Exception:  # noqa: BLE001 - the waiter gave up
                            pass
                    except Exception:  # noqa: BLE001 - the waiter gave up (504)
                        pass
                for item in fallbacks:
                    try:
                        item.future.set_result((None, {}))
                    except Exception:  # noqa: BLE001 - the waiter gave up
                        pass
                for item, exc in failures:
                    try:
                        item.future.set_exception(exc)
                    except Exception:  # noqa: BLE001 - the waiter gave up
                        pass
            waste = 1.0 - sum(item.rows for item in live) / float(padded_members * padded_rows)
            if recorder.enabled:
                batch_span.set(
                    coalesced=members,
                    flops_per_sample=spec_flops_per_sample(spec),
                    padded_members=padded_members,
                    padded_rows=padded_rows,
                    padding_waste=round(waste, 4),
                    queue_wait_max_ms=round(max(flush_start - item.enqueued_at for item in items) * 1000.0, 3),
                    precision=prec,
                    predicted_device_ms=self._predicted_step_ms(spec, padded_members, padded_rows, prec),
                    device_ms=round(device_s * 1000.0, 3),
                    ingest_ms=round(ingest_s * 1000.0, 3),
                    isolated_failures=len(failures),
                )
                for item in live:
                    if item.trace is not None:
                        trace_id, span_id = item.trace
                        batch_span.link(trace_id, span_id or "", name=item.name,
                                        queue_wait_ms=round((flush_start - item.enqueued_at) * 1000.0, 3))
        if self.metrics is not None:
            try:
                self.metrics.observe_batch(size=members, occupancy=members / float(padded_members),
                                           padding_waste=waste)
            except Exception:  # noqa: BLE001 - metrics are advisory
                pass

    # -- failure containment (the scoring ladder) -------------------------------

    def _score_live(self, fleet, spec, prec: str, padded_rows: int, live: List[BatchItem], params,
                    bucket_rows: Dict[str, int], ingest, results: List, failures: List, fallbacks: List,
                    timings: Dict[str, float]) -> None:
        """Score ``live``: a device error of the fused forward bisects the
        batch and scores each half; a one-member forward's failure is the
        member's own (:meth:`_member_failure`). A sticky CUDA error answers
        500 to the whole batch: the context it would retry on is lost.
        Host errors propagate (they would fail every half alike), and the
        batcher hands each rider its own copy."""
        from ..parallel.fleet import is_device_error

        cap = self._member_caps.get((spec, prec))
        if cap is not None and len(live) > cap:
            for start in range(0, len(live), cap):
                self._score_live(fleet, spec, prec, padded_rows, live[start:start + cap], params, bucket_rows,
                                 ingest, results, failures, fallbacks, timings)
            return
        try:
            recon = self._fused_live(fleet, spec, prec, padded_rows, live, params, bucket_rows, ingest, timings)
        except Exception as exc:
            if not is_device_error(exc):
                raise
            self._count("device_errors")
            if is_sticky_device_error(exc):
                self._count("sticky_device_errors")
                logger.error(
                    "CUDA reported a sticky error in a coalesced forward of %d member(s): the context is lost, "
                    "so the batch answers 500 without bisection and later device work will fail too: %r",
                    len(live), exc,
                )
                failures.extend((item, ServeDeviceError(item.name, exc)) for item in live)
                return
            self._note_resource_exhausted(fleet, spec, prec, len(live), padded_rows, exc)
            if len(live) > 1:
                self._count("batch_bisects")
                self._recorder.event("serve_bisect", members=len(live), precision=prec, error=repr(exc)[:200])
                logger.warning("fused serving forward failed for %d coalesced member(s) (%s); bisecting",
                               len(live), exc)
                mid = len(live) // 2
                for half in (live[:mid], live[mid:]):
                    self._score_live(fleet, spec, prec, padded_rows, half, params, bucket_rows, ingest,
                                     results, failures, fallbacks, timings)
            else:
                self._member_failure(fleet, spec, prec, padded_rows, live[0], exc, results, failures, fallbacks,
                                     timings)
            return
        for i, item in enumerate(live):
            rows = recon[i]
            try:
                fault_point("serve_member_poison", self._fault_key(spec, prec, item.name))
            except FaultInjected:
                rows = np.full_like(rows, np.nan)
            if self.config.finite_check and not np.isfinite(rows[: item.rows]).all():
                if np.isfinite(item.payload.host_matrix()[: item.rows]).all():
                    # finite input, non-finite output: the member is poisoned
                    self._count("nonfinite_outputs")
                    self._member_failure(
                        fleet, spec, prec, padded_rows, item,
                        FloatingPointError(f"non-finite output from member {item.name} ({prec}) for finite input"),
                        results, failures, fallbacks, timings,
                    )
                    continue
                # non-finite input rows are the client's; the unbatched
                # path would answer the same NaN
            results.append((item, rows))
            self.breakers.record_success(fleet, spec, item.name)

    def _fused_live(self, fleet, spec, prec: str, padded_rows: int, live: List[BatchItem], params,
                    bucket_rows: Dict[str, int], ingest, timings: Dict[str, float]) -> np.ndarray:
        """One fused forward over ``live``: every payload staged by
        ``ingest.stage`` into its slice of one ``[members, padded_rows, F]``
        host buffer (pinned on a card; over the dlpack rung when its columns
        allow and ``GORDO_TPU_INGEST_DLPACK`` is on), one copy to the device,
        one gather launch, one copy back
        (``gordo_tpu/serve/engine.py:747-806``); returns the
        ``[len(live), padded_rows, F_out]`` host rows. The staging
        (``stack``) and the copy's enqueueing (``device_ingest``) are added
        to ``timings``."""
        from ..server.fleet_store import fleet_forward_gather

        for item in live:
            fault_point("serve_device_program", self._fault_key(spec, prec, item.name))
        t0 = time.monotonic()
        use_dlpack = dlpack_enabled(fleet.device)
        buf = staging_buffer((len(live), padded_rows, spec.n_features), fleet.device)
        host = buf.numpy()
        for m, item in enumerate(live):
            stage(item.payload, host[m], dlpack=use_dlpack)
        t1 = time.monotonic()
        X = buf.to(fleet.device, non_blocking=True)
        timings["stack"] += t1 - t0
        timings["device_ingest"] += time.monotonic() - t1
        indices = [bucket_rows[item.name] for item in live]
        recon = fleet_forward_gather(spec, params, indices, X, ingest=ingest, precision=prec).cpu().numpy()
        members = len(live)
        shape = (spec, "k1" if prec == precision.F32 else "torch", members,
                 ladder.pad_to(members, self.member_ladder) or members, padded_rows, prec)
        with self._lock:
            self._counters["launches"] += 1
            self._programs.add(shape)
        return recon

    def _member_failure(self, fleet, spec, prec: str, padded_rows: int, item: BatchItem, exc: BaseException,
                        results: List, failures: List, fallbacks: List, timings: Dict[str, float]) -> None:
        """One member failed alone. In order: an out-of-memory hands the
        request back to the unbatched path (the rung was demoted; the member
        is not to blame); a reduced-precision bucket degrades to f32 and the
        member retries there; anything else is the member's own failure, on
        its breaker, answered with :class:`ServeDeviceError`."""
        if is_out_of_memory(exc):
            self._count("oom_fallbacks")
            fallbacks.append(item)
            return
        if prec != precision.F32:
            self._degrade_bucket(fleet, spec, prec, exc)
            self._count("precision_degraded")
            try:
                names32, params32, ingest32 = fleet.serving_bucket(spec)
            except Exception:  # noqa: BLE001 - no f32 bucket to retry on
                names32 = []
            if item.name in names32:
                rows32 = {n: i for i, n in enumerate(names32)}
                self._score_live(fleet, spec, precision.F32, padded_rows, [item], params32, rows32, ingest32,
                                 results, failures, fallbacks, timings)
                return
        self._count("members_isolated")
        logger.error("serving device forward failed for member %s in isolation: %r", item.name, exc)
        self._recorder.event("serve_member_isolated", member=item.name, precision=prec, error=repr(exc)[:200])
        self.breakers.record_failure(fleet, spec, item.name, exc)
        failures.append((item, ServeDeviceError(item.name, exc)))

    def _degrade_bucket(self, fleet, spec, prec: str, exc: BaseException) -> None:
        """Pin a failing reduced-precision bucket to f32: in the board's
        degrade set (which holds with the gate off) and as a failed gate
        verdict on the fleet."""
        if not self.breakers.degrade_bucket(fleet, spec, prec):
            return  # already degraded
        logger.warning("degrading (%s, %s) bucket to f32 after a device error: %r", type(spec).__name__, prec, exc)
        self._recorder.event("precision_degraded", collection_dir=getattr(fleet, "collection_dir", ""),
                             precision=prec, error=repr(exc)[:200])
        fleet.set_precision_state(spec, prec, {
            "precision": prec,
            "spec": type(spec).__name__,
            "passed": False,
            "detail": f"device errors while serving {prec}: {exc!r}"[:300],
        })

    def _note_resource_exhausted(self, fleet, spec, prec: str, members: int, padded_rows: int,
                                 exc: BaseException) -> None:
        """An out-of-memory demotes the rung it struck: the member axis while
        the batch can still split, the row axis once one member ran out, so
        the engine stops retrying a shape the card refused. On a card the
        caching allocator's free blocks go back first."""
        if not is_out_of_memory(exc):
            return
        if fleet.device.type == "cuda":
            torch.cuda.empty_cache()
        demoted = None
        padded = ladder.pad_to(members, self.member_ladder) or members
        # the predicted-HBM demotion (GORDO_TPU_PERFMODEL_BREAKER) may drop
        # several rungs at once; None defers to the fixed heuristic
        cap = self._hbm_aware_cap(spec, prec, padded, padded_rows, "members" if members > 1 else "rows")
        model_informed = cap is not None
        if cap is None:
            if members > 1:
                cap = max(1, padded // 2)
            else:
                lower = [r for r in self.config.row_ladder if r < padded_rows]
                cap = max(lower) if lower else 0
        with self._lock:
            if members > 1:
                current = self._member_caps.get((spec, prec))
                if current is None or cap < current:
                    self._member_caps[(spec, prec)] = cap
                    demoted = ("members", cap)
            else:
                current = self._row_caps.get((spec, prec))
                if current is None or cap < current:
                    self._row_caps[(spec, prec)] = cap
                    demoted = ("rows", cap)
        if demoted is not None:
            self._count("rung_demotions")
            logger.warning("out of memory at (%s members, %s rows, %s): capping the %s ladder for %s at %d",
                           members, padded_rows, prec, demoted[0], type(spec).__name__, demoted[1])
            self._recorder.event("serve_rung_demoted", spec=type(spec).__name__, precision=prec, axis=demoted[0],
                                 cap=demoted[1], model_informed=model_informed, error=repr(exc)[:200])

    def _on_breaker_transition(self, member: str, old: str, new: str, info: dict) -> None:
        """A breaker's transition: the trip counter, a ``serve_breaker``
        event, and the member's ``breaker`` section of the health ledger."""
        if new == "open":
            self._count("breaker_trips")
        self._recorder.event("serve_breaker", member=member, old_state=old, new_state=new, trips=info.get("trips"),
                             cooldown_s=info.get("cooldown_s"), error=info.get("last_error", ""))
        if self.ledger is not None:
            try:
                self.ledger().record_breaker_transition(member, new, info)
            except Exception:  # noqa: BLE001 - the ledger is advisory
                logger.debug("breaker ledger feed failed", exc_info=True)
        if self.metrics is not None:
            try:
                self.metrics.observe_breaker(new)
                self.metrics.set_breaker_open(self.breakers.snapshot(detail_cap=0)["open"])
            except Exception:  # noqa: BLE001 - metrics are advisory
                pass

    # -- the learned performance model's consumers -----------------------------

    def _desired_precision(self, spec: Any, rows: int) -> str:
        """The precision ``spec`` is asked to serve at, before the gate and
        the degrade set: its own or the configured one; with neither pinned,
        the learned model's nomination at the full member ladder and
        ``rows`` (``GORDO_TPU_PERFMODEL_PRECISION``), else f32."""
        desired = precision.resolve_precision(spec, self.config.precision)
        if desired == precision.F32 and not getattr(spec, "precision", ""):
            desired = precision.model_preferred(spec, self.member_ladder[-1], rows, self._cost_model()) or desired
        return desired

    def _cost_model(self) -> CostModel:
        """The engine's cost model, built once from the table
        ``GORDO_TPU_PERFMODEL_TABLE`` names (the analytic defaults without
        one; a corrupt or missing table degrades to them in
        ``load_table_safe``), so every consumer measures with one ruler."""
        model = self._cost_model_cache
        if model is None:
            with self._lock:
                if self._cost_model_cache is None:
                    self._cost_model_cache = CostModel(load_table_safe(env_str(PERFMODEL_TABLE_ENV, None)))
                model = self._cost_model_cache
        return model

    def _predicted_step_ms(self, spec: Any, members: int, rows: int, prec: str) -> float:
        """The cost model's device ms of one fused batch at this shape and
        precision, cached by shape; -1.0 when the estimate fails."""
        key = (spec, members, rows, prec)
        cached = self._step_predictions.get(key)
        if cached is None:
            try:
                cached = round(self._cost_model().predict_serve_step_s(spec, members, rows, prec) * 1000.0, 4)
            except Exception:  # noqa: BLE001 - a prediction is telemetry, never the batch's problem
                cached = -1.0
            with self._lock:
                if len(self._step_predictions) > 4096:
                    self._step_predictions.clear()
                self._step_predictions[key] = cached
        return cached

    def _model_row_cap(self, spec: Any, prec: str) -> Optional[int]:
        """The predicted-HBM row cap of ``(spec, prec)`` under
        ``GORDO_TPU_PERFMODEL_BATCH_CAP_BYTES``: the tallest row rung whose
        fused batch at the full member ladder is predicted within the budget
        (0: every request unbatched). None (uncapped) with the knob off or
        an estimate that fails."""
        cap_bytes = env_int(PERFMODEL_CAP_ENV, 0)
        if cap_bytes <= 0:
            return None
        key = (spec, prec)
        with self._lock:
            if key in self._model_row_caps:
                return self._model_row_caps[key]
        cap: Optional[int] = None
        try:
            model = self._cost_model()
            top_members = self.member_ladder[-1]
            fitting = [rung for rung in self.config.row_ladder
                       if model.predict_serve_hbm_bytes(spec, top_members, rung, prec) <= cap_bytes]
            cap = max(fitting) if fitting else 0
            if cap != self.config.row_ladder[-1]:
                logger.info("perfmodel batch cap: (%s, %s) rows capped at %d (predicted HBM budget %d bytes)",
                            type(spec).__name__, prec, cap, cap_bytes)
        except Exception:  # noqa: BLE001 - an unpredictable shape stays uncapped, not unbatched
            cap = None
        with self._lock:
            if len(self._model_row_caps) > 4096:
                self._model_row_caps.clear()
            self._model_row_caps[key] = cap
        return cap

    def _hbm_aware_cap(self, spec: Any, prec: str, padded_members: int, padded_rows: int,
                       axis: str) -> Optional[int]:
        """The out-of-memory demotion the predicted bytes inform
        (``GORDO_TPU_PERFMODEL_BREAKER``): the largest lower rung on
        ``axis`` (``members`` or ``rows``) predicted within
        ``GORDO_TPU_PERFMODEL_BREAKER_SAFETY`` (default 0.8) of the failed
        shape's bytes. None defers to the fixed heuristic."""
        if not env_bool(PERFMODEL_BREAKER_ENV, False):
            return None
        try:
            model = self._cost_model()
            safety = env_float(PERFMODEL_BREAKER_SAFETY_ENV, 0.8) or 0.8
            failed = model.predict_serve_hbm_bytes(spec, padded_members, padded_rows, prec)
            if failed <= 0:
                return None
            budget = failed * float(safety)
            if axis == "members":
                fitting = [v for v in self.member_ladder if v < padded_members
                           and model.predict_serve_hbm_bytes(spec, v, padded_rows, prec) <= budget]
            else:
                fitting = [r for r in self.config.row_ladder if r < padded_rows
                           and model.predict_serve_hbm_bytes(spec, padded_members, r, prec) <= budget]
            return max(fitting) if fitting else None
        except Exception:  # noqa: BLE001 - the fixed heuristic is the fallback
            return None

    def warmup_order(self, specs: Any, rows: int) -> List[Any]:
        """The order warmup runs ``specs`` in: by ``repr``, or under
        ``GORDO_TPU_PERFMODEL_WARMUP`` the costliest predicted step first
        (f32, the full member ladder, ``rows``), ``repr`` breaking ties."""
        order = sorted(specs, key=repr)
        if env_bool(PERFMODEL_WARMUP_ENV, False):
            try:
                model = self._cost_model()
                top_members = self.member_ladder[-1]
                order = sorted(specs, key=lambda s: (
                    -model.predict_serve_step_s(s, top_members, rows, precision.F32), repr(s)))
            except Exception:  # noqa: BLE001 - the order is advisory
                order = sorted(specs, key=repr)
        return order

    # -- warmup ---------------------------------------------------------------

    def warmup_collection(self, collection_dir: str) -> Dict[str, Any]:
        """Load a revision's models and run :meth:`warmup_fleet` on it."""
        fleet = self.store.fleet(collection_dir)
        fleet.warm()
        return self.warmup_fleet(fleet)

    def warmup_fleet(self, fleet: Any) -> Dict[str, Any]:
        """Before the first request: the parity gate of every reduced
        feedforward bucket, then one forward a bucket at its serving
        precision (one K1 launch a spec at f32 on a card, which also loads
        the kernel library, built with ``nvcc`` on first use), at the
        tallest rung within ``warmup_max_rows``, the specs in
        :meth:`warmup_order`. The result's ``order`` lists the specs run."""
        from ..server.fleet_store import fleet_forward_gather

        start = time.monotonic()
        warm_rows = max([r for r in self.config.row_ladder if r <= self.config.warmup_max_rows]
                        or [self.config.row_ladder[0]])
        specs = {spec for spec in fleet.loaded_specs().values() if isinstance(spec, FeedForwardSpec)}
        runs, order = 0, []
        for spec in self.warmup_order(specs, warm_rows):
            desired = self._desired_precision(spec, warm_rows)
            prec = self.governor.effective_precision(fleet, spec, desired, recorder=self._recorder) \
                if desired != precision.F32 else precision.F32
            try:
                names, params, ingest = fleet.serving_bucket(spec, prec)
            except KeyError:
                continue
            members = min(len(names), self.config.max_size)
            X = torch.zeros((members, warm_rows, spec.n_features), dtype=torch.float32, device=fleet.device)
            with self._recorder.span("warmup_program", padded_members=members, padded_rows=warm_rows, precision=prec):
                fleet_forward_gather(spec, params, list(range(members)), X, ingest=ingest, precision=prec).cpu()
            runs += 1
            order.append(spec)
        self._count("warmup_programs", runs)
        seconds = time.monotonic() - start
        logger.info("serve warmup: %d forward(s) over %d spec bucket(s) in %.2fs", runs, len(specs), seconds)
        return {"programs": runs, "specs": len(specs), "seconds": seconds, "order": order}

    # -- introspection and lifecycle -------------------------------------------

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            stats = dict(self._counters)
            stats["programs"] = len(self._programs)
            stats["precision"] = {"config": self.config.precision, "coalesced": dict(self._precision_counters)}
            demotions = {
                "members": {f"{type(s).__name__}:{p}": cap for (s, p), cap in self._member_caps.items()},
                "rows": {f"{type(s).__name__}:{p}": cap for (s, p), cap in self._row_caps.items()},
            }
        stats["pending"] = self._batcher.pending()
        stats["breaker"] = self.breakers.summary()
        stats["demoted_rungs"] = demotions
        device = getattr(self.store, "device", "cpu")
        stats["ingest"] = {"compiled": compiled_enabled(), "dlpack": dlpack_enabled(device), **ingest_stats()}
        return stats

    def program_shapes(self) -> List[Tuple]:
        """``(spec, route, members, padded members, rows, precision)`` of
        every forward shape run, ``route`` ``k1`` (f32) or ``torch``."""
        with self._lock:
            return sorted((repr(s), *rest) for (s, *rest) in self._programs)

    def shutdown(self, drain: bool = True) -> None:
        """Stop the dispatchers; with ``drain`` everything queued still
        scores first."""
        self._batcher.shutdown(drain=drain)

    def _count(self, key: str, by: int = 1) -> None:
        with self._lock:
            self._counters[key] = self._counters.get(key, 0) + by

    def _on_shed(self, reason: str, n: int) -> None:
        if reason == "queue_full":
            self._count("shed_queue_full", n)
        elif reason == "deadline":
            self._count("shed_deadline", n)
        elif reason == "runner_error":
            # the batcher's backstop: a host error of the runner
            self._count("shed_runner_error", n)
        if self.metrics is not None:
            try:
                self.metrics.observe_shed(reason, n)
            except Exception:  # noqa: BLE001 - metrics are advisory
                pass

    def _on_depth(self, depth: int) -> None:
        if self.metrics is not None:
            try:
                self.metrics.set_queue_depth(depth)
            except Exception:  # noqa: BLE001 - metrics are advisory
                pass
