"""
FleetBuilder: the dense fleet build of ``gordo_tpu/parallel/fleet_build.py``
(``_run_build``, ``:504-683``) in the port. Every machine of a project
is trained as stacked buckets and written out in the artifact layout the
port's server loads (``model.pkl``, ``metadata.json``, ``info.json``).

Per machine it follows the JAX builder:

- **plan** (``_plan_machine``, ``:889-922``): the definition becomes
  port objects;
- **data fetch** (``_load_all_data``, ``:1169-1245``): the machines'
  datasets fetch and resample their rows (``dataset/datasets.py``, on
  the host) in a pool of ``DATA_WORKERS`` threads (16), each timed into
  ``query_duration_sec``; a failed fetch is tried again
  ``GORDO_TPU_DATA_RETRIES`` times (default 2) after
  ``GORDO_TPU_DATA_BACKOFF`` seconds (0.5), doubling, within an optional
  ``GORDO_TPU_DATA_DEADLINE``; configuration errors, too few rows and
  what the port does not implement are not tried again. Each attempt
  passes the ``data_fetch`` fault site. A machine whose fetch fails is
  recorded in ``build_errors``;
- **stage** (``_stage_arrays``, ``:1247-1304``): the host pipeline steps
  (scalers, imputer, function transformers) are fitted on the machine's
  X in float64, ``y`` is aliased to ``X`` when
  they are equal, and the fit config and seed come from the estimator's
  kwargs. An LSTM machine keeps its series and its window targets
  (``ops.windows.window_targets``) instead, its model offset is
  ``lookback + lookahead - 1``, and it never shuffles between epochs;
- **cross-validation** (``:1308-1394``): fold models are members
  ``<machine>::fold<k>`` with seed ``seed + 1000 * (k + 1)`` and the
  fold's rows as train weights, appended fold-major, all folds of all
  machines of one fit config in one ``train`` call (chunked by
  ``GORDO_TPU_CV_CHUNK_BYTES``); each (spec, width) group of trained
  folds is scored by **one** forward, ``FleetTrainer.predict_bucket``
  (one K1 launch on a card, ``:1579-1636``), an LSTM spec group by one
  windowed forward of its folds' test windows
  (``predict_windowed_bucket``, ``:1638-1661``). An LSTM fold trains on
  the windows whose targets lie in its train rows and is scored on those
  whose targets lie in its test rows (``_window_train_weights``,
  ``_test_window_rows``, ``:1453-1485``): folds must be contiguous.
  Then per-tag and aggregate metric scores (after the evaluation's
  ``scoring_scaler``, any of the four scalers), and the
  ``DiffBasedAnomalyDetector`` thresholds: a fresh copy of the detector's
  own error scaler fitted on the fold's train targets
  (``sklearn_clone(detector.scaler)``, ``:1766``), each fold's errors
  handed to the detector's own
  threshold functions (``models/anomaly/diff.py``: the max over time of
  6-row rolling minimums, the last fold's kept; ``:1687-1860``). A
  ``DiffBasedKFCVAnomalyDetector`` is cross-validated with ``KFold(5,
  shuffle=True, random_state=0)``; its folds' errors are kept with their
  test rows and stitched back into row order by the detector;
- **final fit** of every machine (``:1864-1965``), then the detector's
  error scaler fitted on ``y``;
- **assemble and dump** (``:1969-2011``): ``metadata.json`` with the
  JAX artifact's keys (``model_offset``: 0, or an LSTM's offset;
  ``cross_validation.{scores, splits, cv_duration_sec}``, ``training``,
  ``model_meta``), the dataset's own ``get_metadata()`` and fetch time
  under ``build_metadata.dataset``, ``info.json`` with the model's
  checksum; each artifact written by ``serializer.dump_atomic`` in a pool
  of up to 8 threads, the artifacts landing one at a time.

Robustness, as ``_run_build`` (``:504-683``, ``:810-870``) has it:

- **journal**: with an ``output_dir``, staging leftovers of killed builds
  are swept (``parallel/journal.py::clean_staging_dirs``), and
  ``build_state.json`` records each machine ``planned`` (with its config
  hash, ``builder.ModelBuilder.calculate_cache_key``), ``data_loaded``,
  ``cv_done``, then ``built`` as its artifact lands (before the
  ``process_kill_after_n_machines`` fault site), or ``failed``;
- **resume**: ``resume=True`` skips the machines the journal names
  resumable (``self.resumed``) and builds the rest;
- **model-register cache**: with a ``model_register_dir``, a machine
  whose build is registered is loaded, not trained, and every machine
  built is registered (``builder/build_model.py``);
- **sequential fallback**: a machine the fleet cannot plan (an estimator
  that is not an autoencoder; a KFCV LSTM, whose scattered KFold folds
  have no window mapping; an estimator with host callbacks such as
  ``ReduceLROnPlateau``, which need the per-epoch host loop of one
  member: the JAX fleet build fails that machine at its stage,
  ``:1297-1301``, where the port builds it) and a machine whose device program fails alone
  in its bucket (``self.degraded``) are built by
  ``ModelBuilder(machine, device, random)``; a failure there is the
  machine's error.

What the build writes about itself (``:269-500``, ``:685-800``,
``:965-1166``; ``telemetry/``, ``planner/``), unless
``GORDO_TPU_TELEMETRY=0``:

- ``build_trace.jsonl`` (or under ``GORDO_TPU_TELEMETRY_DIR``): a
  ``fleet_build`` span, a ``build_phase`` span a phase entered, the
  trainer's ``device_program`` spans (``fleet_fit``, ``fleet_predict``:
  K1, ...), and the events ``fleet_plan``, ``machine_failed``,
  ``machine_degraded``, ``member_trained`` (a final fit's losses),
  ``machine_built`` (an artifact landed), ``device_utilization`` (the
  card's memory at the end of ``stage``, ``cv_train``, ``final_fit``,
  ``assemble`` and ``dump``, at most one a second but every
  ``final_fit``'s) and ``fleet_plan_accuracy``;
- ``build_status.json``: the live status (``telemetry/progress.py``),
  ``complete`` or ``failed`` at the end; a killed build leaves it
  ``running`` with the machines landed by then;
- ``fleet_health.json``: the ledger's build record of every machine
  (``telemetry/fleet_health.py``), fed by the events above; the ledger
  is the builder's, restored from the directory's last snapshot.

``fleet_plan.json``, the final-fit buckets planned by the build's
strategy (``naive`` or ``packed``, ``plan_strategy`` or
``GORDO_TPU_PLAN_STRATEGY``) and priced by the cost model over its table
(``cost_table``; ``planner/``), is written with telemetry off too, and
its hash and strategy are journaled (``_prepare_fleet_plan``,
``:1000-1090``). A plan handed in (``fleet_plan``, ``build-fleet
--plan-from``) is replayed instead: a fingerprint of other configs warns,
its strategy rides onto the trainer so that the CV fold members, which no
plan covers, pack live under it. :meth:`FleetBuilder.plan_only` plans
without training (the ``plan`` command). ``GORDO_TPU_PACKING=auto|<int>``
turns on the packed fit (``models/packing.py``) when no trainer is
handed in; a malformed value warns and leaves it off (``:197-212``).
The ``sequential`` phase, the port's own, is entered only when a machine
is built by ``ModelBuilder``.

The Prometheus build series (``server/prometheus/metrics.py``, on the
process's registry) are fed where the JAX build feeds them: each
``build_phase`` span, ``device_program`` first call and member's final
loss as it ends (telemetry on), the progress gauges as machines land or
fail, the plan's prediction beside ``fleet_plan.json`` and its actuals
beside ``fleet_plan_accuracy``, the robustness counters at the end. They
are advisory: a failure is logged and dropped.

:func:`rebuild_stale` is the lifecycle's partial rebuild
(``fleet_build.py:2026-2084``): only the stale machines build, journaled
and resumable in their own directory, replaying the base revision's
``fleet_plan.json`` (``FleetBuilder(fleet_plan=)``), so a stale member
keeps its planned pad targets under either strategy; members the plan
does not cover, or whose rows outgrew it, pack live. The multi-host
mirrors, where a rank other than 0 reads rank 0's resume and
model-register filters without writing, are the command line's
(``cli/cli.py::_mirror_filters``).
"""

import concurrent.futures
import contextlib
import datetime
import logging
import os
import threading
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import DeviceLike, __version__, planner, serializer, telemetry
from ..builder.build_model import ModelBuilder, split_metadata
from ..dataset.exceptions import ConfigException, InsufficientDataError
from ..machine import Machine, TrainingSummaryMetadata
from ..machine.metadata import drift_baseline
from ..models.anomaly.diff import DiffBasedAnomalyDetector, DiffBasedKFCVAnomalyDetector, fold_errors
from ..models.estimators import TorchAutoEncoder, TorchLSTMBaseEstimator
from ..models.metrics import metrics_from_list
from ..models.model_selection import KFold, TimeSeriesSplit, shuffle_indices
from ..models.nn import params_from_jax
from ..models.preprocessing import Pipeline, clone
from ..models.training import FitConfig, RandomSource, fit_config_from_kwargs, split_fit_kwargs
from ..ops.windows import model_offset, window_targets
from ..utils.env import env_float, env_int, env_str
from ..utils.faults import fault_point
from .fleet import FleetMember, FleetTrainer, WindowedFleetMember, is_device_error, stack_member_params
from .journal import BuildJournal, clean_staging_dirs

logger = logging.getLogger(__name__)

#: threads fetching the machines' rows (the JAX builder's default)
DATA_WORKERS = 16

PACKING_ENV = "GORDO_TPU_PACKING"


def packing_from_env() -> Any:
    """``GORDO_TPU_PACKING``: ``"auto"``, an int factor, or None (unset,
    or malformed, which warns)."""
    packing: Any = env_str(PACKING_ENV, None)
    if packing and packing != "auto":
        try:
            packing = int(packing)
        except ValueError:
            logger.warning("Invalid %s=%r (want an int or 'auto'); packing disabled", PACKING_ENV, packing)
            packing = None
    return packing


class FleetBuildError(RuntimeError):
    pass


@dataclass
class _Plan:
    """Everything needed to train and reassemble one machine."""

    machine: Machine
    model_obj: Any  # the unfitted object graph of the definition
    detector: Optional[DiffBasedAnomalyDetector]
    pipeline: Optional[Pipeline]
    estimator: TorchAutoEncoder
    X: np.ndarray = None  # the fetched rows, float64
    y: np.ndarray = None
    index: Optional[Sequence[Any]] = None  # the rows' datetimes
    query_duration: Optional[float] = None
    data_retries: int = 0
    X_arr: np.ndarray = None  # inputs after the host pipeline steps, float32
    y_arr: np.ndarray = None  # targets, float32 (X_arr itself when equal)
    offset: int = 0  # the model offset: rows the output is shorter than the input
    targets: Optional[np.ndarray] = None  # an LSTM's window targets (None: dense)
    n_windows: int = 0  # training samples: windows, or rows
    shuffle_perm: Optional[np.ndarray] = None  # the detector's sample shuffle
    spec: Any = None
    fit_config: FitConfig = None
    seed: int = 42
    cv_scores: Dict[str, Any] = field(default_factory=dict)
    cv_splits: Dict[str, Any] = field(default_factory=dict)
    cv_duration: float = 0.0
    train_duration: float = 0.0
    fleet_retries: int = 0
    bucket_bisects: int = 0
    training_summary: Optional[TrainingSummaryMetadata] = None
    scoring: Any = None  # (metrics, fitted scoring scaler), made once
    shuffled: Any = None  # (X, y) in the shuffle's order, made once

    @property
    def windowed(self) -> bool:
        return self.targets is not None


def _cv_chunk_bytes() -> int:
    """Staging budget of one CV ``train`` call (raw member bytes);
    ``GORDO_TPU_CV_CHUNK_BYTES`` overrides it."""
    return env_int("GORDO_TPU_CV_CHUNK_BYTES", 1 << 30)


def _member_nbytes(member) -> int:
    if isinstance(member, WindowedFleetMember):
        return member.series.nbytes + member.targets.nbytes
    return member.X.nbytes + (0 if member.y is member.X else member.y.nbytes)


def _chunk_by_bytes(members, items, budget: int):
    """Order-preserving chunks of (members, items) whose member bytes stay
    under ``budget`` (every chunk holds at least one member)."""
    chunks = []
    start, used = 0, 0
    for i, member in enumerate(members):
        size = _member_nbytes(member)
        if i > start and used + size > budget:
            chunks.append((members[start:i], items[start:i]))
            start, used = i, 0
        used += size
    if start < len(members):
        chunks.append((members[start:], items[start:]))
    return chunks


def _fold_member_name(machine_name: str, fold_idx: int) -> str:
    """A fold model's member name; ``::`` cannot occur in a machine name."""
    return f"{machine_name}::fold{fold_idx}"


#: windows an LSTM group's CV forward gathers at once
SCORING_BATCH = 256


def _window_train_weights(plan: _Plan, train_idx: np.ndarray) -> np.ndarray:
    """A fold's train rows as a train mask over the plan's samples: the
    rows themselves for a dense model; for an LSTM, the windows whose
    targets lie in the fold's rows ``[first, last]``, which must be
    contiguous (``_window_train_weights``, ``fleet_build.py:1453-1469``).

    >>> plan = _Plan(None, None, None, None, None, offset=2, targets=np.zeros(8), n_windows=8)
    >>> _window_train_weights(plan, np.arange(5)).tolist()
    [1.0, 1.0, 1.0, 0.0, 0.0, 0.0, 0.0, 0.0]
    """
    weights = np.zeros(plan.n_windows, np.float32)
    if plan.offset == 0:
        weights[train_idx[train_idx < plan.n_windows]] = 1.0
        return weights
    if len(train_idx) != int(train_idx[-1]) - int(train_idx[0]) + 1:
        raise FleetBuildError(
            f"{plan.machine.name}: non-contiguous CV folds are not supported for windowed "
            "(LSTM) models in fleet builds"
        )
    weights[: max(int(train_idx[-1]) + 1 - plan.offset, 0)] = 1.0
    return weights


def _test_window_rows(plan: _Plan, rows: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """A fold's test rows as ``(windows to forward, the rows they
    target)``: for an LSTM the windows of a contiguous ``[b, c)`` are
    ``[b, c - offset)``, targeting ``[b + offset, c)``
    (``_test_window_rows``, ``fleet_build.py:1471-1485``).

    >>> plan = _Plan(None, None, None, None, None, offset=2, targets=np.zeros(8), n_windows=8)
    >>> [a.tolist() for a in _test_window_rows(plan, np.arange(5, 10))]
    [[5, 6, 7], [7, 8, 9]]
    """
    if plan.offset == 0:
        rows = rows[rows < plan.n_windows]
        return rows, rows
    b, c = int(rows[0]), int(rows[-1]) + 1
    windows = np.arange(b, max(c - plan.offset, b))
    windows = windows[windows < plan.n_windows]
    return windows, windows + plan.offset


def _cv_mode(plan: _Plan) -> str:
    return plan.machine.evaluation.get("cv_mode", "full_build").lower()


def _cv_for(plan: _Plan):
    """The machine's CV splitter: ``KFold(5, shuffle=True,
    random_state=0)`` for a KFCV detector, else its evaluation's ``cv``
    definition, else ``TimeSeriesSplit(n_splits=3)``."""
    if isinstance(plan.detector, DiffBasedKFCVAnomalyDetector):
        return KFold(n_splits=5, shuffle=True, random_state=0)
    cv_def = plan.machine.evaluation.get("cv")
    return serializer.from_definition(cv_def, device="cpu") if cv_def else TimeSeriesSplit(n_splits=3)


def _retry_call(fn, attempts: int, backoff: float, deadline: Optional[float], no_retry, on_retry):
    """``fn()``, tried up to ``attempts`` times, sleeping ``backoff * 2**k``
    seconds (at most 30) between tries; ``no_retry`` exceptions, and a
    sleep that would cross ``deadline`` seconds, re-raise at once
    (``gordo_tpu/utils/retry.py::retry_call``)."""
    start = time.monotonic()
    attempt = 1
    while True:
        try:
            return fn()
        except no_retry:
            raise
        except Exception as exc:
            delay = min(backoff * 2.0 ** (attempt - 1), 30.0)
            if attempt >= attempts or (deadline is not None and time.monotonic() - start + delay > deadline):
                raise
            on_retry(attempt, exc)
            time.sleep(delay)
            attempt += 1


def _try_call(fn, *args) -> Optional[BaseException]:
    """``fn(*args)``'s exception, or None: a pool thread's failure kept for
    its machine. ``SystemExit`` and ``KeyboardInterrupt`` are not a
    machine's failure, and raise."""
    try:
        fn(*args)
        return None
    except (KeyboardInterrupt, SystemExit):
        raise
    except BaseException as exc:  # noqa: BLE001 - recorded per machine
        return exc


@contextlib.contextmanager
def _prometheus():
    """``server/prometheus/metrics.py``, whose build-series helpers the
    block calls; metrics are advisory: a failure is logged and dropped."""
    try:
        from ..server.prometheus import metrics

        yield metrics
    except Exception as exc:  # noqa: BLE001 - metrics are advisory
        logger.debug("Build metric not exported: %r", exc)


def _run_pool(fn, items, workers: int) -> List[Optional[BaseException]]:
    """:func:`_try_call` of ``fn`` on every item in a pool of ``workers``
    threads; on ``SystemExit`` or ``KeyboardInterrupt`` the queued items
    are cancelled before it propagates."""
    pool = concurrent.futures.ThreadPoolExecutor(max(1, workers))
    try:
        return list(pool.map(lambda item: _try_call(fn, item), items))
    except (KeyboardInterrupt, SystemExit):
        pool.shutdown(wait=True, cancel_futures=True)
        raise
    finally:
        pool.shutdown(wait=True)


class FleetBuilder:
    """
    Builds every machine of ``machines`` as stacked fleet buckets on
    ``device`` (``cuda`` unless the caller asks for the CPU), drawing each
    member's random numbers from ``random`` (default ``TorchRandom``),
    fetching rows in ``DATA_WORKERS`` threads. Without a ``trainer`` the
    builder makes one with ``GORDO_TPU_PACKING``'s packing;
    ``plan_strategy``, ``cost_table`` and ``fleet_plan`` (a plan to
    replay) go onto the trainer, which plans the buckets.

    ``build_errors`` maps a failed machine to its exception: one machine's
    failure spares the rest. ``degraded`` maps a machine rebuilt by the
    sequential builder after its device program failed alone to that
    failure; ``resumed`` names the machines a resume skipped.
    ``phase_seconds`` holds the host wall time of each phase: ``plan``,
    ``data_fetch``, ``stage``, ``bucket_plan``, ``cv_train``,
    ``cv_predict`` (the fold forwards through K1), ``cv_score``,
    ``cv_finalize``, ``final_fit``, ``assemble``, ``sequential`` (the
    fallback builds, when there are any), ``dump``.
    """

    def __init__(
        self,
        machines: Sequence[Machine],
        device: DeviceLike = None,
        random: Optional[RandomSource] = None,
        trainer: Optional[FleetTrainer] = None,
        fleet_plan: Optional[planner.FleetPlan] = None,
        health_ledger: Any = None,
        plan_strategy: Optional[str] = None,
        cost_table: Optional[planner.CostTable] = None,
    ):
        self.machines = list(machines)
        # a given trainer brings its device, random source and packing
        self.trainer = trainer if trainer is not None else FleetTrainer(device, random, packing=packing_from_env())
        self.device = self.trainer.device
        if plan_strategy is not None:
            self.trainer.plan_strategy = plan_strategy
        if fleet_plan is not None:
            self.trainer.fleet_plan = fleet_plan
        if cost_table is not None:
            self.trainer.cost_table = cost_table
        #: the plan handed in (or already on the trainer), replayed by every
        #: build of this builder, and the strategy the trainer came with
        self._external_plan = self.trainer.fleet_plan
        self._external_strategy = self.trainer.plan_strategy
        #: the ledger a build feeds (None: the output directory's own)
        self._health_ledger = health_ledger
        self.build_errors: Dict[str, BaseException] = {}
        self.degraded: Dict[str, BaseException] = {}
        self.resumed: List[str] = []
        self.phase_seconds: Dict[str, float] = defaultdict(float)
        self.robustness: Dict[str, int] = defaultdict(int)
        self._journal: Optional[BuildJournal] = None
        self._config_hashes: Dict[str, str] = {}
        #: cache hits' registered ``model.pkl`` bytes, dumped as they are
        self._cached_pickles: Dict[str, bytes] = {}
        #: the build's recorder, status and ledger (null outside a build)
        self.recorder: Any = telemetry.NULL_RECORDER
        self.progress: Optional[telemetry.BuildProgress] = None
        self._ledger: Any = telemetry.NULL_LEDGER
        #: the build's final-fit plan (``planner.FleetPlan``)
        self.fleet_plan: Optional[planner.FleetPlan] = None
        self._project = ""
        self._output_revision: Optional[str] = None
        self._current_phase = ""
        self._plan_actuals: Dict[str, float] = defaultdict(float)
        self._member_actuals: Dict[str, int] = defaultdict(int)
        self._device_peak_bytes = 0
        self._last_device_sample = 0.0

    #: phases that end with a ``device_utilization`` sample
    _DEVICE_SAMPLED_PHASES = frozenset({"stage", "cv_train", "final_fit", "assemble", "dump"})

    @contextlib.contextmanager
    def _phase(self, name: str):
        if self.progress is not None:
            self.progress.phase(name)
        start = time.perf_counter()
        previous, self._current_phase = self._current_phase, name
        try:
            with self.recorder.span("build_phase", phase=name, machines=len(self.machines)):
                yield
        finally:
            self._current_phase = previous
            self.phase_seconds[name] += time.perf_counter() - start
            self._sample_device(name)

    def _sample_device(self, phase: str) -> None:
        """A ``device_utilization`` event at the end of a device phase, at
        most one a second except after a final fit; the build's peak of
        allocated bytes is kept for the plan's accuracy."""
        if phase not in self._DEVICE_SAMPLED_PHASES:
            return
        now = time.time()
        if now - self._last_device_sample < 1.0 and phase != "final_fit":
            return
        self._last_device_sample = now
        try:
            snapshot = telemetry.emit_device_utilization(self.recorder, device=self.device, phase=phase)
        except Exception as exc:  # noqa: BLE001 - device telemetry is advisory
            logger.debug("device utilization not sampled: %r", exc)
            return
        if snapshot and snapshot.get("available"):
            self._device_peak_bytes = max(self._device_peak_bytes, int(snapshot.get("max_peak_bytes_in_use") or 0))

    def _fail(self, name: str, exc: BaseException) -> None:
        if self._journal is not None:
            self._journal.record(name, "failed", error=repr(exc))
        logger.error("Fleet build of machine %s failed: %r", name, exc)
        first_failure = name not in self.build_errors
        self.build_errors[name] = exc
        if first_failure:
            self.recorder.event("machine_failed", machine=name, error=repr(exc))
            if self.progress is not None:
                self.progress.machine_failed(name)
                self._update_progress_gauges()

    def _skipped(self, name: str) -> bool:
        """Out of the fleet path: failed, or left to the sequential builder."""
        return name in self.build_errors or name in self.degraded

    def _degrade(self, plan: _Plan, exc: BaseException) -> None:
        """Hand a machine whose device program failed alone to the
        sequential builder (``_degrade``, ``:366-385``)."""
        name = plan.machine.name
        logger.warning("Fleet degrade: %s falls back to the sequential builder after an isolated device "
                       "failure: %r", name, exc)
        self.robustness["sequential_degraded"] += 1
        self.degraded[name] = exc
        self.recorder.event("machine_degraded", machine=name, error=repr(exc))
        if self.progress is not None:
            self.progress.degraded = len(self.degraded)
            self.progress.write()

    def _device_failure(self, plan: _Plan, exc: BaseException) -> None:
        """A member's failure: a device error degrades its machine, any
        other fails it."""
        if is_device_error(exc):
            self._degrade(plan, exc)
        else:
            self._fail(plan.machine.name, exc)

    # -------------------------------------------------------------------- API

    def build(
        self,
        output_dir: Optional[str] = None,
        model_register_dir: Optional[str] = None,
        replace_cache: bool = False,
        resume: bool = False,
    ) -> List[Tuple[Any, Machine]]:
        """Train the whole fleet; ``(model, machine)`` for every machine
        that built, in input order, its metadata filled in. With an
        ``output_dir``, each is dumped to ``output_dir/<name>/`` and the
        build is journaled there; ``resume`` then skips what an earlier
        run journaled ``built`` with a complete artifact (those are not
        returned). With a ``model_register_dir``, registered builds are
        loaded instead of trained and new ones registered
        (``replace_cache`` forgets the keys first). Telemetry, unless
        ``GORDO_TPU_TELEMETRY=0``: the span trace, ``build_status.json``
        and the health ledger (the module's docstring)."""
        self.build_errors = {}
        self.degraded = {}
        self.resumed = []
        self.phase_seconds = defaultdict(float)
        self.robustness = defaultdict(int)
        self._journal = None
        self.fleet_plan = None
        self._plan_actuals = defaultdict(float)
        self._member_actuals = defaultdict(int)
        self._device_peak_bytes = 0
        self._project = self.machines[0].project_name if self.machines else ""
        self._output_revision = os.path.basename(os.path.normpath(output_dir)) if output_dir is not None else None
        if self._health_ledger is not None:
            self._ledger = self._health_ledger
        else:
            self._ledger = (telemetry.ledger_for(output_dir, project=self._project) if output_dir is not None
                            else telemetry.NULL_LEDGER)
        recorder: Any = telemetry.NULL_RECORDER
        self.progress = None
        if telemetry.enabled():
            trace_path = None
            if output_dir is not None:
                trace_dir = env_str(telemetry.TRACE_DIR_ENV, None) or output_dir
                try:
                    os.makedirs(trace_dir, exist_ok=True)
                    trace_path = os.path.join(trace_dir, telemetry.BUILD_TRACE_FILE)
                except OSError as exc:
                    logger.debug("No span trace sink: %r", exc)
            recorder = telemetry.SpanRecorder(sink_path=trace_path, service="gordo-tpu-fleet-build")
            recorder.add_listener(self._on_span)
            self.progress = telemetry.BuildProgress(output_dir, project=self._project, total=len(self.machines),
                                                    phase_seconds=self.phase_seconds)
            self._update_progress_gauges()
        self.recorder = recorder
        try:
            with telemetry.activate(recorder):
                with recorder.span("fleet_build", project=self._project, machines=len(self.machines)):
                    try:
                        results = self._run_build(output_dir, model_register_dir, replace_cache, resume)
                    finally:
                        # a shared trainer must not keep this build's strategy
                        self.trainer.fleet_plan = self._external_plan
                        self.trainer.plan_strategy = self._external_strategy
        except Exception:
            # SystemExit and KeyboardInterrupt pass: a killed build stays "running"
            if self.progress is not None:
                self.progress.finish("failed")
                self._update_progress_gauges()
            raise
        finally:
            recorder.close()
            self._ledger.flush()
        if self.progress is not None:
            self.progress.finish("complete")
            self._update_progress_gauges()
        return results

    def _run_build(self, output_dir, model_register_dir, replace_cache: bool, resume: bool):
        bisects_start = self.trainer.bucket_bisects
        counts_start = dict(self.trainer.bisect_counts)
        machines = self.machines
        if output_dir is not None:
            self._config_hashes = {m.name: ModelBuilder.calculate_cache_key(m) for m in machines}
            clean_staging_dirs(output_dir)
            self._journal = BuildJournal.load(output_dir) if resume else BuildJournal(output_dir)
            if resume:
                remaining = []
                for machine in machines:
                    if self._journal.resumable(machine.name, self._config_hashes[machine.name]):
                        self.resumed.append(machine.name)
                    else:
                        remaining.append(machine)
                machines = remaining
                logger.info("Resume: %d machines already built, %d to build", len(self.resumed), len(machines))
                if self.progress is not None:
                    self.progress.resumed = len(self.resumed)
                    self.progress.write(force=True)

        cached, self._cached_pickles = [], {}
        if model_register_dir:
            clean_staging_dirs(os.path.join(str(model_register_dir), "builds"))
            to_probe, machines = machines, []
            for machine in to_probe:
                registry = ModelBuilder(machine, self.device)
                hit = registry.load_cached(model_register_dir, replace_cache=replace_cache)
                if hit is None:
                    machines.append(machine)
                else:
                    cached.append(hit)
                    self._cached_pickles[machine.name] = registry.cached_model_bytes
            logger.info("Model register: %d hits, %d to build", len(cached), len(machines))
            if self.progress is not None:
                self.progress.cached = len(cached)
                self.progress.write(force=True)

        plans, fallbacks = self._plan_all(machines)
        if self._journal is not None:
            for machine in machines:
                self._journal.record(machine.name, "planned", config_hash=self._config_hashes[machine.name],
                                     flush=False)
            self._journal.flush()
        plans = self._load_all_data(plans)
        final_members = self._prepare_fleet_plan(plans, output_dir)

        cv_plans = [p for p in plans if _cv_mode(p) in ("full_build", "cross_val_only")]
        if cv_plans:
            self._run_cross_validation(cv_plans)
            if self._journal is not None:
                for plan in cv_plans:
                    if not self._skipped(plan.machine.name):
                        self._journal.record(plan.machine.name, "cv_done", flush=False)
                self._journal.flush()
        self._run_final_fit(self._final_fit_plans(plans), final_members)
        # bisections the trainer resolved inside a train call, by machine
        for member_name, count in self.trainer.bisect_counts.items():
            delta = count - counts_start.get(member_name, 0)
            for plan in plans:
                if delta > 0 and plan.machine.name == member_name.split("::", 1)[0]:
                    plan.bucket_bisects += delta
        self.robustness["bucket_bisects"] += self.trainer.bucket_bisects - bisects_start

        results = []
        with self._phase("assemble"):
            for plan in plans:
                if self._skipped(plan.machine.name):
                    continue
                try:
                    results.append(self._assemble(plan))
                except Exception as exc:
                    self._fail(plan.machine.name, exc)
        by_name = {m.name: m for m in machines}
        sequential = fallbacks + [by_name[name] for name in self.degraded]
        if sequential:
            with self._phase("sequential"):
                for machine in sequential:
                    logger.info("Sequential build of machine %s", machine.name)
                    try:
                        results.append(ModelBuilder(machine, self.device, self.trainer.random).build())
                    except Exception as exc:
                        self._fail(machine.name, exc)
        if model_register_dir:
            for model, machine in results:
                try:
                    ModelBuilder(machine, self.device).register(model, machine, model_register_dir)
                except Exception as exc:
                    self._fail(machine.name, exc)
        order = {m.name: i for i, m in enumerate(self.machines)}
        results = sorted(cached + results, key=lambda item: order[item[1].name])
        if output_dir is not None:
            with self._phase("dump"):
                results = self._dump_all(results, output_dir)
            self._journal.flush()  # one clean state file once the build is done
        if any(self.robustness.values()):
            with _prometheus() as prom:
                prom.record_fleet_build_robustness(self._project, dict(self.robustness))
        self._export_plan_accuracy()
        return [(model, machine) for model, machine in results if machine.name not in self.build_errors]

    # -------------------------------------------------------------- telemetry

    def _on_span(self, span: dict) -> None:
        """Every finished span and event: final-fit programs count toward
        the plan's measured numbers, and the machine events feed the
        health ledger."""
        name = span["name"]
        attrs = span.get("attributes") or {}
        seconds = float(span.get("duration_ms") or 0.0) / 1000.0
        if (name == "device_program" and self._current_phase == "final_fit"
                and str(attrs.get("program", "")).endswith("_fit")):
            self._plan_actuals["seconds"] += seconds
            if attrs.get("compile"):
                self._plan_actuals["compiles"] += 1
            if attrs.get("members") is not None and attrs.get("stacked_members"):
                self._member_actuals["live"] += int(attrs["members"])
                self._member_actuals["padded"] += int(attrs["stacked_members"])
        with _prometheus() as prom:
            if name == "build_phase":
                prom.record_fleet_build_phase(self._project, str(attrs.get("phase", "")), seconds)
            elif name == "device_program" and attrs.get("compile"):
                prom.record_fleet_compile(self._project, str(attrs.get("program", "")), str(attrs.get("shape", "")),
                                          seconds)
            elif name == "member_trained":
                loss = attrs.get("final_loss")
                if loss is not None and np.isfinite(loss):
                    prom.record_member_final_loss(self._project, float(loss))
        machine = attrs.get("machine")
        if not machine:
            return
        try:
            if name == "member_trained":
                loss = attrs.get("final_loss")
                self._ledger.record_build(str(machine), retries=attrs.get("retries"),
                                          final_loss=float(loss) if loss is not None and np.isfinite(loss) else None)
            elif name == "machine_built":
                # a machine degraded in this build keeps the flag its artifact carries
                self._ledger.record_build(str(machine), revision=self._output_revision, failed=False,
                                          degraded=False if str(machine) not in self.degraded else None)
            elif name == "machine_failed":
                self._ledger.record_build(str(machine), failed=True, error=attrs.get("error"))
            elif name == "machine_degraded":
                self._ledger.record_build(str(machine), degraded=True, error=attrs.get("error"))
        except Exception as exc:  # noqa: BLE001 - the ledger is advisory
            logger.debug("Health ledger not fed: %r", exc)

    def _update_progress_gauges(self) -> None:
        """The progress gauges from the live status (the dump's threads too)."""
        if self.progress is not None:
            with _prometheus() as prom:
                prom.set_fleet_build_progress(self._project, self.progress.total, self.progress.completed,
                                              self.progress.failed)

    def _final_fit_plans(self, plans: List[_Plan]) -> List[_Plan]:
        """The plans whose machines are still to final-fit."""
        return [p for p in plans if not self._skipped(p.machine.name) and _cv_mode(p) != "cross_val_only"]

    def _plan_all(self, machines: Sequence[Machine]) -> Tuple[List[_Plan], List[Machine]]:
        """The ``plan`` phase: each machine's plan, and the machines the
        fleet cannot train (the sequential builder's); a machine whose
        definition fails is failed."""
        with self._phase("plan"):
            plans, fallbacks = [], []
            for machine in machines:
                try:
                    plan = self._plan_machine(machine)
                except Exception as exc:
                    self._fail(machine.name, exc)
                    continue
                if plan is None:
                    fallbacks.append(machine)
                else:
                    plans.append(plan)
        return plans, fallbacks

    def _plan_strategy_name(self) -> str:
        return self.trainer.plan_strategy or planner.default_strategy()

    def _final_members(self, plans: List[_Plan]) -> Tuple[Dict[str, Any], List[_Plan]]:
        """The final fit's member of each plan still to final-fit, by
        machine name, and those plans (a machine whose member fails is
        failed)."""
        members: Dict[str, Any] = {}
        final_plans = []
        for plan in self._final_fit_plans(plans):
            try:
                members[plan.machine.name] = self._make_member(plan, None, seed=plan.seed, name=plan.machine.name)
            except Exception as exc:
                self._fail(plan.machine.name, exc)
                continue
            final_plans.append(plan)
        return members, final_plans

    def _fingerprint(self, final_plans: List[_Plan]) -> str:
        return planner.config_fingerprint(
            [self._config_hashes.get(p.machine.name) or ModelBuilder.calculate_cache_key(p.machine)
             for p in final_plans])

    def _compute_fleet_plan(self, members: Dict[str, Any], final_plans: List[_Plan],
                            strategy: str) -> planner.FleetPlan:
        """The final-fit buckets of ``final_plans`` under ``strategy`` and
        the trainer's cost model, as a ``FleetPlan``."""
        by_config: Dict[FitConfig, List[Any]] = {}
        for plan in final_plans:
            by_config.setdefault(plan.fit_config, []).append(members[plan.machine.name])
        cost_model = self.trainer.cost_model()
        return planner.build_plan_doc(
            [(config, planner.plan_train_buckets(group, config, strategy=strategy, cost_model=cost_model))
             for config, group in by_config.items()],
            strategy, self._fingerprint(final_plans), cost_model.table, cost_model.mesh_shape)

    def plan_only(self) -> planner.FleetPlan:
        """Plan without training (``plan_only``, ``:1091-1108``): machine
        plans, data fetch and stage, then the final-fit buckets: the
        ``FleetPlan`` that the ``plan`` command renders and ``build-fleet
        --plan-from`` replays. Machines for the sequential builder are
        not in it; failed machines are in ``build_errors``."""
        self.build_errors = {}
        plans, fallbacks = self._plan_all(self.machines)
        if fallbacks:
            logger.info("%d machine(s) use the sequential builder and are not fleet-planned: %s", len(fallbacks),
                        ", ".join(m.name for m in fallbacks[:5]))
        plans = self._load_all_data(plans)
        members, final_plans = self._final_members(plans)
        return self._compute_fleet_plan(members, final_plans, self._plan_strategy_name())

    def _prepare_fleet_plan(self, plans: List[_Plan], output_dir: Optional[str]) -> Dict[str, Any]:
        """The final fit's members and buckets, planned before training
        (``_prepare_fleet_plan``, ``:1000-1090``): a plan handed in is
        replayed (a fingerprint of other configs warns), else one is
        computed with the build's strategy; the strategy rides onto the
        trainer, so the CV fold members, which no plan covers, pack live
        under it. Then the ``fleet_plan`` event, ``fleet_plan.json``, the
        journal's plan hash and strategy, the plan gauges. Answers the
        members by machine name; the final fit trains these same members,
        which the trainer buckets as the plan did."""
        if not self._final_fit_plans(plans):
            return {}
        strategy = self._plan_strategy_name()
        with self._phase("bucket_plan"):
            members, final_plans = self._final_members(plans)
            if not final_plans:
                return members
            plan = self._external_plan
            if plan is not None:
                recorded, fingerprint = str(plan.doc.get("config_fingerprint", "")), self._fingerprint(final_plans)
                if recorded and recorded != fingerprint:
                    logger.warning("FleetPlan %s was computed for a different config set (fingerprint %s != %s); "
                                   "unknown members will be packed live", plan.plan_hash, recorded, fingerprint)
                strategy = plan.strategy or strategy
            else:
                plan = self._compute_fleet_plan(members, final_plans, strategy)
            self.fleet_plan = plan
            # only a plan handed in rides on the trainer: a fresh build plans the same members again
            self.trainer.plan_strategy = strategy
            totals = plan.totals
            self.recorder.event(
                "fleet_plan", plan_hash=plan.plan_hash, strategy=strategy,
                replayed=self._external_plan is not None,
                buckets=totals.get("buckets", 0), members=totals.get("members", 0),
                compiles=totals.get("compiles", 0), predicted_wall_s=totals.get("predicted_wall_s", 0.0),
                padding_waste=totals.get("padding_waste", 0.0),
            )
            if output_dir is not None:
                try:
                    plan.save(os.path.join(output_dir, planner.PLAN_FILE))
                except OSError as exc:
                    logger.warning("FleetPlan not persisted: %r", exc)
            if self._journal is not None:
                previous = self._journal.plan()
                if previous and previous.get("plan_hash") != plan.plan_hash:
                    logger.info("FleetPlan %s differs from the journaled %s: the remaining members are replanned",
                                plan.plan_hash, previous.get("plan_hash"))
                self._journal.set_plan(plan.plan_hash, strategy)
            with _prometheus() as prom:
                prom.set_fleet_plan_prediction(self._project, strategy, float(totals.get("predicted_wall_s", 0.0)),
                                               float(totals.get("padding_waste", 0.0)), int(totals.get("compiles", 0)))
        return members

    def _export_plan_accuracy(self) -> None:
        """The plan's predictions against what the final fit measured
        (``_export_plan_accuracy``, ``:1110-1166``): an event and the
        ledger's ``plan_accuracy``."""
        plan = self.fleet_plan
        if plan is None:
            return
        totals = plan.totals
        padded = int(self._member_actuals.get("padded", 0))
        accuracy = dict(
            plan_hash=plan.plan_hash,
            strategy=plan.strategy,
            # from each bucket's spec document (the JAX builder reads an
            # attribute its bucket documents lack, and records None)
            precisions=sorted({planner.dtype_precision(b["spec"].get("compute_dtype")) for b in plan.buckets}),
            predicted_compiles=totals.get("compiles", 0),
            actual_compiles=int(self._plan_actuals.get("compiles", 0)),
            predicted_wall_s=totals.get("predicted_wall_s", 0.0),
            actual_fit_s=round(float(self._plan_actuals.get("seconds", 0.0)), 3),
            predicted_padding_waste=totals.get("padding_waste", 0.0),
            measured_member_waste=round(1.0 - self._member_actuals["live"] / padded, 6) if padded else None,
            predicted_hbm_peak_bytes=totals.get("hbm_peak_bytes", 0),
            measured_hbm_peak_bytes=self._device_peak_bytes or None,
        )
        self.recorder.event("fleet_plan_accuracy", **accuracy)
        self._ledger.record_plan_accuracy(accuracy)
        with _prometheus() as prom:
            prom.set_fleet_plan_actuals(self._project, plan.strategy, accuracy["actual_fit_s"],
                                        accuracy["actual_compiles"])

    def _dump_all(self, results, output_dir: str):
        """Dump every artifact with ``serializer.dump_atomic`` in up to 8
        threads; the artifacts land one at a time, each journaled
        ``built`` before the ``process_kill_after_n_machines`` fault site,
        so a kill after N machines leaves exactly the N journaled."""
        landing = threading.Lock()

        def dump_one(item):
            model, machine = item

            def landed():
                self._journal.record(machine.name, "built", config_hash=self._config_hashes.get(machine.name))
                # the status counts the machine before the kill site, as the journal does
                self.recorder.event("machine_built", machine=machine.name)
                if self.progress is not None:
                    self.progress.machine_completed(machine.name)
                    self._update_progress_gauges()
                fault_point("process_kill_after_n_machines", machine.name)

            serializer.dump_atomic(model, os.path.join(output_dir, machine.name), metadata=machine.to_dict(),
                                   lock=landing, on_landed=landed, pickled=self._cached_pickles.get(machine.name))

        to_dump = [(model, machine) for model, machine in results if machine.name not in self.build_errors]
        outcomes = _run_pool(dump_one, to_dump, min(8, len(to_dump)))
        saved = []
        for (model, machine), exc in zip(to_dump, outcomes):
            if exc is not None:
                self._fail(machine.name, exc)
                continue
            saved.append((model, machine))
        return saved

    # --------------------------------------------------------------- planning

    def _load_all_data(self, plans: List[_Plan]) -> List[_Plan]:
        """Fetch every plan in ``DATA_WORKERS`` threads, then stage each; a
        machine that fails drops out and is recorded in ``build_errors``."""
        attempts = 1 + max(0, env_int("GORDO_TPU_DATA_RETRIES", 2))
        backoff = env_float("GORDO_TPU_DATA_BACKOFF", 0.5)
        deadline = env_float("GORDO_TPU_DATA_DEADLINE", None)

        def load(plan: _Plan) -> None:
            def fetch():
                fault_point("data_fetch", plan.machine.name)
                return plan.machine.dataset.get_data()

            def note_retry(attempt: int, exc: BaseException) -> None:
                plan.data_retries += 1  # one thread a plan: no race
                logger.warning("Data fetch retry %d for %s after %r", attempt, plan.machine.name, exc)

            start = time.perf_counter()
            plan.X, plan.y, plan.index = _retry_call(
                fetch, attempts, backoff, deadline,
                no_retry=(ConfigException, InsufficientDataError, NotImplementedError), on_retry=note_retry,
            )
            plan.query_duration = time.perf_counter() - start

        with self._phase("data_fetch"):
            outcomes = _run_pool(load, plans, min(DATA_WORKERS, len(plans)))
        self.robustness["data_fetch_retries"] += sum(p.data_retries for p in plans)
        staged = []
        with self._phase("stage"):
            for plan, exc in zip(plans, outcomes):
                if exc is not None:
                    self._fail(plan.machine.name, exc)
                    continue
                try:
                    self._stage_arrays(plan)
                except Exception as stage_exc:
                    self._fail(plan.machine.name, stage_exc)
                    continue
                staged.append(plan)
        if self._journal is not None:
            for plan in staged:
                self._journal.record(plan.machine.name, "data_loaded", flush=False)
            self._journal.flush()
        return staged

    def _plan_machine(self, machine: Machine) -> Optional[_Plan]:
        """The machine's plan, or None for a machine the fleet cannot train
        (``_plan_machine``, ``:889-922``): an estimator that is not an
        autoencoder, a KFCV LSTM, or an estimator with host callbacks."""
        model_obj = serializer.from_definition(machine.model, device=self.device)
        obj, detector, pipeline = model_obj, None, None
        if isinstance(obj, DiffBasedAnomalyDetector):
            detector, obj = obj, obj.base_estimator
        if isinstance(obj, Pipeline):
            pipeline, obj = obj, obj.estimator
        if not isinstance(obj, TorchAutoEncoder):
            return None
        if isinstance(obj, TorchLSTMBaseEstimator) and isinstance(detector, DiffBasedKFCVAnomalyDetector):
            return None
        if fit_config_from_kwargs(split_fit_kwargs(obj.kwargs)[0])[1]:
            return None  # host callbacks: one member's per-epoch host loop
        return _Plan(machine=machine, model_obj=model_obj, detector=detector, pipeline=pipeline, estimator=obj)

    @staticmethod
    def _stage_arrays(plan: _Plan) -> None:
        """Fit the host pipeline steps, window an LSTM's targets, resolve
        spec, fit config and seed."""
        X_arr = np.asarray(plan.X, np.float32)
        y_arr = np.asarray(plan.y, np.float32)
        if plan.pipeline is not None and plan.pipeline.transformers:
            transformed = np.asarray(plan.X, np.float64)
            for transformer in plan.pipeline.transformers:
                transformed = transformer.fit_transform(transformed)
            X_arr = np.asarray(transformed, np.float32)
        estimator = plan.estimator
        fit_kwargs, _ = split_fit_kwargs(estimator.kwargs)
        if isinstance(estimator, TorchLSTMBaseEstimator):
            # the series stays whole; windows are gathered on the device
            plan.offset = model_offset(estimator.lookback_window, estimator.lookahead)
            plan.targets = window_targets(y_arr, estimator.lookback_window, estimator.lookahead)
            plan.n_windows = len(plan.targets)
            fit_kwargs["shuffle"] = False
        else:
            # pure autoencoder builds train y == X: stage the block once
            if X_arr.shape == y_arr.shape and np.array_equal(X_arr, y_arr):
                y_arr = X_arr
            plan.n_windows = len(X_arr)
        plan.X_arr, plan.y_arr = X_arr, y_arr
        estimator.kwargs.update(n_features=X_arr.shape[1], n_features_out=y_arr.shape[1])
        if plan.detector is not None and plan.detector.shuffle:
            # the detector's fit trains on sklearn.utils.shuffle's sample
            # order (an LSTM's: its window order); scoring is chronological
            plan.shuffle_perm = shuffle_indices(plan.n_windows, random_state=0)
        plan.spec = estimator.build_spec(X_arr.shape[1], y_arr.shape[1])
        plan.fit_config, _ = fit_config_from_kwargs(fit_kwargs)  # no host callbacks: the plan refused them
        plan.seed = int(fit_kwargs.get("seed", 42))

    # --------------------------------------------------------------------- CV

    def _run_cross_validation(self, plans: List[_Plan]) -> None:
        """Every fold of every machine of one fit config trains in one
        ``train`` call; fold boundaries are train-weight masks."""
        start = time.perf_counter()
        fold_state: Dict[str, Dict[str, Any]] = {p.machine.name: {} for p in plans}
        per_plan_folds: Dict[str, List[Tuple[np.ndarray, np.ndarray]]] = {}
        max_folds = 0
        for plan in plans:
            try:
                splits = list(_cv_for(plan).split(plan.X_arr))
                plan.cv_splits = split_metadata(splits, plan.index)
            except Exception as exc:
                self._fail(plan.machine.name, exc)
                continue
            per_plan_folds[plan.machine.name] = splits
            max_folds = max(max_folds, len(splits))

        grouped: Dict[FitConfig, Tuple[List[FleetMember], List[Tuple[_Plan, int]]]] = {}
        for fold_idx in range(max_folds):  # fold-major: the last fold's thresholds win
            for plan in plans:
                if self._skipped(plan.machine.name) or fold_idx >= len(per_plan_folds[plan.machine.name]):
                    continue
                train_idx, _ = per_plan_folds[plan.machine.name][fold_idx]
                try:
                    member = self._make_member(
                        plan, _window_train_weights(plan, train_idx), seed=plan.seed + 1000 * (fold_idx + 1),
                        name=_fold_member_name(plan.machine.name, fold_idx),
                    )
                except Exception as exc:
                    self._fail(plan.machine.name, exc)
                    continue
                members, items = grouped.setdefault(plan.fit_config, ([], []))
                members.append(member)
                items.append((plan, fold_idx))
        for config, (members, items) in grouped.items():
            for chunk_members, chunk_items in _chunk_by_bytes(members, items, _cv_chunk_bytes()):
                self._train_and_score_folds(chunk_members, chunk_items, config, per_plan_folds, fold_state)

        with self._phase("cv_finalize"):
            for plan in plans:
                if self._skipped(plan.machine.name):
                    continue
                try:
                    self._finalize_cv(plan, fold_state[plan.machine.name])
                except Exception as exc:
                    self._fail(plan.machine.name, exc)
                    continue
                plan.cv_duration = time.perf_counter() - start

    @staticmethod
    def _make_member(plan: _Plan, train_weights: Optional[np.ndarray], seed: int, name: str):
        """A training member, in the detector's shuffled sample order if
        any; an LSTM's is its series, the shuffle its window order."""
        perm = plan.shuffle_perm
        if plan.windowed:
            if perm is not None and train_weights is not None:
                train_weights = train_weights[perm]
            return WindowedFleetMember(name=name, spec=plan.spec, series=plan.X_arr, targets=plan.targets,
                                       order=perm, train_weights=train_weights, seed=seed)
        if perm is None:
            X, y = plan.X_arr, plan.y_arr
        else:
            if plan.shuffled is None:
                X = plan.X_arr[perm]
                plan.shuffled = (X, X if plan.y_arr is plan.X_arr else plan.y_arr[perm])
            X, y = plan.shuffled
            if train_weights is not None:
                train_weights = train_weights[perm]
        return FleetMember(name=name, spec=plan.spec, X=X, y=y, train_weights=train_weights, seed=seed)

    def _train_and_score_folds(self, members, items, config, per_plan_folds, fold_state) -> None:
        """Train one chunk of fold members and score it. The trainer
        bisects device errors itself; a chunk whose ``train`` raises (a
        host error, such as one member's bad data) is halved and retried,
        down to one member, so one bad machine fails alone."""
        live = [i for i, (plan, _) in enumerate(items) if not self._skipped(plan.machine.name)]
        members, items = [members[i] for i in live], [items[i] for i in live]
        if not members:
            return
        try:
            with self._phase("cv_train"):
                results = self.trainer.train(members, config)
        except Exception as exc:
            if len(members) > 1:
                logger.warning("CV chunk of %d fold-members failed (%s); splitting", len(members), exc)
                self.robustness["bucket_bisects"] += 1
                for plan, _ in items:
                    plan.bucket_bisects += 1
                mid = len(members) // 2
                self._train_and_score_folds(members[:mid], items[:mid], config, per_plan_folds, fold_state)
                self._train_and_score_folds(members[mid:], items[mid:], config, per_plan_folds, fold_state)
                return
            self._device_failure(items[0][0], exc)
            return
        scorable_items, scorable_results = [], []
        for (plan, fold_idx), result in zip(items, results):
            if result.error is not None and not self._skipped(plan.machine.name):
                self._device_failure(plan, result.error)
        for (plan, fold_idx), result in zip(items, results):
            if result.error is not None or self._skipped(plan.machine.name):
                continue
            plan.fleet_retries += result.retries
            self.robustness["fleet_retries"] += result.retries
            scorable_items.append((plan, fold_idx))
            scorable_results.append(result)
        if not scorable_items:
            return
        try:
            self._score_folds(scorable_items, scorable_results, per_plan_folds, fold_state)
        except Exception as exc:
            for plan, _ in scorable_items:
                self._fail(plan.machine.name, exc)

    def _score_folds(self, items, results, per_plan_folds, fold_state) -> None:
        """Score trained fold models: one forward per (spec, width) group,
        every fold of every machine of the group at once (one K1 launch on
        a card; one windowed forward for an LSTM group), each fold on its
        test windows, against the rows they target."""
        by_name = {r.name: r for r in results}
        groups: Dict[Tuple, List[Tuple[_Plan, int]]] = {}
        for plan, fold_idx in items:
            groups.setdefault((plan.spec, plan.X_arr.shape[1:]), []).append((plan, fold_idx))
        for (spec, _), group in groups.items():
            stacked = stack_member_params(
                [by_name[_fold_member_name(p.machine.name, k)].params for p, k in group]
            )
            fold_rows = []  # per item: (train rows, test windows, the rows they target)
            for plan, fold_idx in group:
                train_rows, test_rows = per_plan_folds[plan.machine.name][fold_idx]
                fold_rows.append((train_rows, *_test_window_rows(plan, test_rows)))
            with self._phase("cv_predict"):
                n_max = max(len(windows) for _, windows, _ in fold_rows)
                width = group[0][0].X_arr.shape[1:]
                if group[0][0].windowed:
                    series = np.zeros((len(group), max(len(p.X_arr) for p, _ in group)) + width, np.float32)
                    order = np.zeros((len(group), n_max), np.int64)
                    for i, (plan, _) in enumerate(group):
                        series[i, : len(plan.X_arr)] = plan.X_arr
                        order[i, : len(fold_rows[i][1])] = fold_rows[i][1]
                    predictions = self.trainer.predict_windowed_bucket(
                        spec, stacked, series, order, batch_size=SCORING_BATCH)
                else:
                    X = np.zeros((len(group), n_max) + width, np.float32)
                    for i, (plan, _) in enumerate(group):
                        X[i, : len(fold_rows[i][1])] = plan.X_arr[fold_rows[i][1]]
                    predictions = self.trainer.predict_bucket(spec, stacked, X)
            with self._phase("cv_score"):
                for i, (plan, fold_idx) in enumerate(group):
                    train_rows, windows, test_rows = fold_rows[i]
                    y_true = plan.y_arr[test_rows]
                    y_pred = predictions[i, : len(windows)]
                    self._accumulate_metric_scores(plan, y_true, y_pred, fold_idx)
                    if plan.detector is not None:
                        self._accumulate_thresholds(
                            plan, y_true, y_pred, fold_idx, fold_state[plan.machine.name],
                            y_train=plan.y_arr[train_rows], test_rows=test_rows,
                        )

    @staticmethod
    def _scoring_setup(plan: _Plan):
        """The resolved metrics and the scoring scaler, fitted on the whole
        target frame (one fit serves every fold)."""
        if plan.scoring is None:
            evaluation = plan.machine.evaluation
            scaler_def = evaluation.get("scoring_scaler")
            scaler = None
            if scaler_def:
                scaler = serializer.from_definition(scaler_def, device="cpu").fit(plan.y_arr)
            plan.scoring = (metrics_from_list(evaluation.get("metrics")), scaler)
        return plan.scoring

    def _accumulate_metric_scores(self, plan: _Plan, y_true, y_pred, fold_idx: int) -> None:
        metrics, scaler = self._scoring_setup(plan)
        if scaler is not None:
            y_true, y_pred = scaler.transform(y_true), scaler.transform(y_pred)
        tags = plan.machine.target_tag_list
        fold_key = f"fold-{fold_idx + 1}"
        for metric in metrics:
            name = metric.__name__.replace("_", "-")
            per_tag = metric(y_true, y_pred)
            for i, tag in enumerate(tags):
                plan.cv_scores.setdefault(f"{name}-{tag.replace(' ', '-')}", {})[fold_key] = float(per_tag[i])
            plan.cv_scores.setdefault(name, {})[fold_key] = float(np.mean(per_tag))

    @staticmethod
    def _accumulate_thresholds(plan: _Plan, y_true, y_pred, fold_idx: int, state, y_train, test_rows) -> None:
        """One fold's errors, the fold model's error scaler fitted on the
        fold's train targets: its thresholds for a detector, its rows and
        errors for a KFCV detector (whose KFold test rows are scattered, so
        they are smoothed in row order once every fold is in)."""
        detector = plan.detector
        scaler = clone(detector.scaler).fit(y_train)
        scaled_mse, abs_err = fold_errors(scaler, y_true, y_pred)
        if isinstance(detector, DiffBasedKFCVAnomalyDetector):
            state.setdefault("kfcv_parts", []).append((np.asarray(test_rows), scaled_mse, abs_err))
        else:
            state.setdefault("folds", {})[fold_idx] = detector.fold_thresholds(scaled_mse, abs_err)

    @staticmethod
    def _finalize_cv(plan: _Plan, state: Dict[str, Any]) -> None:
        """Fold statistics rows of every score; the detector's thresholds
        from its folds (``models/anomaly/diff.py``)."""
        for folds in plan.cv_scores.values():
            values = np.array([v for k, v in folds.items() if k.startswith("fold-")])
            folds.update({
                "fold-mean": float(values.mean()),
                "fold-std": float(values.std()),
                "fold-max": float(values.max()),
                "fold-min": float(values.min()),
            })
        detector = plan.detector
        if isinstance(detector, DiffBasedKFCVAnomalyDetector) and "kfcv_parts" in state:
            detector.set_kfcv_thresholds(plan.y_arr, state["kfcv_parts"])
        elif detector is not None and "folds" in state:
            folds = state["folds"]
            detector.set_fold_thresholds([folds[k] for k in sorted(folds)], plan.machine.target_tag_list)

    # -------------------------------------------------------------- final fit

    def _run_final_fit(self, plans: List[_Plan], members: Dict[str, Any]) -> None:
        """Final-fit ``plans``' machines, each on its ``members`` entry,
        the member the fleet plan was computed from."""
        start = time.perf_counter()
        by_config: Dict[FitConfig, List[_Plan]] = {}
        for plan in plans:
            by_config.setdefault(plan.fit_config, []).append(plan)
        for config, group in by_config.items():
            self._train_final_group([members[p.machine.name] for p in group], group, config, start)

    def _train_final_group(self, members, plans, config, start) -> None:
        """Final-fit one config group. The trainer bisects device errors
        itself and returns a member that fails alone as its result's
        ``error``; what escapes ``train`` is a host error, and fails the
        group's machines."""
        try:
            with self._phase("final_fit"):
                results = self.trainer.train(members, config)
        except Exception as exc:
            # the trainer bisects device errors inside its buckets; a device
            # error here has no bucket to bisect, so it splits the group
            if is_device_error(exc) and len(members) > 1:
                self.robustness["bucket_bisects"] += 1
                for plan in plans:
                    plan.bucket_bisects += 1
                mid = len(members) // 2
                self._train_final_group(members[:mid], plans[:mid], config, start)
                self._train_final_group(members[mid:], plans[mid:], config, start)
            elif is_device_error(exc):
                self._degrade(plans[0], exc)
            else:
                for plan in plans:
                    self._fail(plan.machine.name, exc)
            return
        for plan, result in zip(plans, results):
            if result.error is not None:
                self._device_failure(plan, result.error)
                continue
            plan.fleet_retries += result.retries
            self.robustness["fleet_retries"] += result.retries
            estimator = plan.estimator
            estimator.spec_ = plan.spec
            estimator.params_ = params_from_jax(result.params, estimator.device)
            estimator._history = result.history
            plan.train_duration = time.perf_counter() - start
            plan.training_summary = TrainingSummaryMetadata.from_history(result.history)
            summary = plan.training_summary
            self.recorder.event("member_trained", machine=plan.machine.name, final_loss=summary.final_loss,
                                best_loss=summary.best_loss, epochs_run=summary.epochs_run,
                                early_stop_epoch=summary.early_stop_epoch, retries=result.retries)
            if plan.detector is not None:
                plan.detector.scaler.fit(plan.y)

    # --------------------------------------------------------------- assembly

    def _assemble(self, plan: _Plan) -> Tuple[Any, Machine]:
        machine = plan.machine.copy()
        model_obj = plan.model_obj
        meta_source = model_obj if plan.detector is not None else plan.estimator
        machine.metadata["build_metadata"] = {
            "model": {
                "model_offset": plan.offset,
                "model_creation_date": str(datetime.datetime.now(datetime.timezone.utc).astimezone()),
                "model_builder_version": __version__,
                "cross_validation": {
                    "scores": plan.cv_scores,
                    "cv_duration_sec": plan.cv_duration,
                    "splits": plan.cv_splits,
                },
                "model_training_duration_sec": plan.train_duration,
                "model_meta": meta_source.get_metadata(),
                "training": (plan.training_summary or TrainingSummaryMetadata()).to_dict(),
            },
            "dataset": {
                "query_duration_sec": plan.query_duration,
                "dataset_meta": plan.machine.dataset.get_metadata(),
            },
            "robustness": {
                "fleet_retries": plan.fleet_retries,
                "bucket_bisects": plan.bucket_bisects,
                "data_fetch_retries": plan.data_retries,
            },
            "drift_baseline": drift_baseline(plan.X, plan.machine.dataset.column_names()[0]),
        }
        return model_obj, machine


def fleet_build(
    machines: Sequence[Machine],
    output_dir: Optional[str] = None,
    device: DeviceLike = None,
    random: Optional[RandomSource] = None,
) -> List[Tuple[Any, Machine]]:
    """Build the whole fleet on ``device`` (``cuda`` unless the caller asks
    for the CPU); see :class:`FleetBuilder`."""
    return FleetBuilder(machines, device=device, random=random).build(output_dir=output_dir)


def rebuild_stale(
    machines: Sequence[Machine],
    stale_names: Sequence[str],
    output_dir: str,
    base_plan: Optional[planner.FleetPlan] = None,
    base_plan_path: Optional[str] = None,
    resume: bool = True,
    trainer: Optional[FleetTrainer] = None,
    health_ledger: Any = None,
    device: DeviceLike = None,
) -> FleetBuilder:
    """Build only ``stale_names`` of ``machines`` into ``output_dir``
    (journaled there; ``resume`` skips what is already rebuilt), replaying
    ``base_plan`` or the plan at ``base_plan_path`` (typically the base
    revision's ``fleet_plan.json``), on ``trainer``'s device and random
    source (default a ``FleetTrainer`` on ``device``, ``cuda`` unless the
    caller asks for the CPU). Build records go to ``health_ledger`` (the
    caller's anchor ledger) when given. Returns the builder, whose
    ``build_errors`` and ``resumed`` say what happened."""
    stale = set(stale_names)
    unknown = stale - {m.name for m in machines}
    if unknown:
        raise FleetBuildError(f"stale members not in the machine set: {sorted(unknown)}")
    if base_plan is None and base_plan_path and os.path.isfile(base_plan_path):
        try:
            base_plan = planner.FleetPlan.load(base_plan_path)
        except ValueError as exc:
            logger.warning("Base FleetPlan %s unusable (%s); stale members pack live", base_plan_path, exc)
    builder = FleetBuilder([m for m in machines if m.name in stale], device=device, trainer=trainer,
                           fleet_plan=base_plan, health_ledger=health_ledger)
    builder.build(output_dir=output_dir, resume=resume)
    return builder
